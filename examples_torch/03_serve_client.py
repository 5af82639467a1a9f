"""The HTTP daemon + programmatic client, in one process.

Production runs the daemon standalone (`python -m zerovox_tpu_torch.cli
--model m.gguf --serve`); here we start TTSServer on a thread and drive
every endpoint through TTSClient: health, one-shot synthesis (JSON and
raw-binary bodies), a bucket-packed /batch, a chunked /stream consumed at
its first chunk, and the metrics.  The daemon speaks the JAX package's
wire format, so either package's client talks to either daemon.
"""

import os
import time

from _common import setup, demo_utterance


def main(argv=None):
    args, cfg, params = setup(argv)
    from zerovox_tpu_torch.io.wav import write_wav
    from zerovox_tpu_torch.runtime.client import TTSClient, utterance
    from zerovox_tpu_torch.runtime.server import TTSServer

    chunk = 16 if args.device.type == "cpu" else 64
    server = TTSServer(params, cfg, port=0, warmup=True,
                       chunk_frames=chunk, overlap=chunk // 4, device=args.device)
    server.start()
    try:
        host, port = server.address
        c = TTSClient(host, port)
        print(f"daemon up at {host}:{port}: {c.health()}")

        src, pun, style = demo_utterance(cfg)
        ph, st, pu = src[0].tolist(), style[0].tolist(), pun[0].tolist()

        # one-shot (?trim=0 keeps the full padded buffer, as the reference
        # vocodes it, whatever mel_len the random weights predict)
        wav, sr = c.synthesize(ph, st, pu, trim=False)
        out = os.path.join(args.out_dir, "example03.wav")
        write_wav(out, wav, sr)
        print(f"/synthesize -> {len(wav)} samples -> {out}")

        # same request over the raw-binary body (application/octet-stream):
        # the latency fast path — identical audio, no JSON decode server-side
        wav_b, _ = c.synthesize(ph, st, pu, trim=False, binary=True)
        if not (wav_b.shape == wav.shape and (wav_b == wav).all()):
            raise RuntimeError("the binary body's answer differs from the JSON one")
        print(f"/synthesize (binary body) -> identical {len(wav_b)} samples")

        # batch: one packed device dispatch for N utterances
        utts = []
        for s in (1, 2):
            s2, p2, st2 = demo_utterance(cfg, seed=s)
            utts.append(utterance(s2[0].tolist(), st2[0].tolist(),
                                  p2[0].tolist()))
        wavs, mel_len, _ = c.batch(utts, trim=False)
        print(f"/batch     -> {len(wavs)} wavs, mel_len={mel_len}")

        # stream: chunks arrive as the daemon flushes them
        t0 = time.perf_counter()
        total, first = 0, None
        for chunk_pcm in c.stream(ph, st, pu):
            if first is None:
                first = (time.perf_counter() - t0) * 1e3
            total += len(chunk_pcm)
        print(f"/stream    -> first chunk {first:.1f} ms, {total} samples")

        print("metrics:", c.metrics()["endpoints"])
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
