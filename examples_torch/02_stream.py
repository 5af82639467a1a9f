"""Chunked streaming synthesis: first audio long before the utterance
finishes.

StreamingSynthesizer (models/streaming.py) runs the encoder+decoder front
once, then vocodes overlapping mel windows chunk by chunk, each window's
stages through the MRF kernel on the card; chunks are exact prefixes of
the one-shot waveform, so a player can start at the first chunk instead
of waiting for the full utterance.  warmup() runs every window geometry
once first (on a card: the kernel's build and cuDNN's choices), off the
timed path.
"""

import os
import time

from _common import setup, demo_utterance


def main(argv=None):
    args, cfg, params = setup(argv)
    import numpy as np
    from zerovox_tpu_torch.io.wav import StreamingWavWriter
    from zerovox_tpu_torch.models.streaming import StreamingSynthesizer

    chunk = 16 if args.device.type == "cpu" else 64
    s = StreamingSynthesizer(params, cfg, chunk_frames=chunk,
                             overlap=chunk // 4, device=args.device)
    s.warmup()                      # build and choose outside the timed loop

    src, pun, style = demo_utterance(cfg)
    out = os.path.join(args.out_dir, "example02.wav")
    t0 = time.perf_counter()
    with StreamingWavWriter(out, cfg.sampling_rate) as w:
        for i, piece in enumerate(s.stream(src, pun, style)):
            if i == 0:
                print(f"first chunk after "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            w.write(np.asarray(piece))
        n = w.samples_written
    print(f"wrote {out}: {n} samples in {i + 1} chunks "
          f"({n / cfg.sampling_rate:.2f}s audio, "
          f"total wall {(time.perf_counter() - t0) * 1e3:.1f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
