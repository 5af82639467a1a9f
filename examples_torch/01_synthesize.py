"""Library quickstart: one synthesis call -> WAV file.

The pipeline (FastSpeech2 encoder -> variance adaptor -> length regulator
-> StyleTTS decoder -> HiFi-GAN vocoder) runs eagerly on one device, its
intermediates staying there (models/pipeline.py); on the card each of the
vocoder's four MRF stages is one launch of the hand-written CUDA kernel.

The port has no jit_synthesize: nothing is traced or compiled per shape.
What the JAX program's compile did once is done here in two places: the
MRF kernel is built with nvcc at its first CUDA launch (into
build/zerovox_tpu_torch/, reused by later processes while the source is
unchanged), and load_model packs the vocoder's weights into the kernel's
layout once per model, so a request's launches move no weights.  The
first run below pays both; the warm run pays neither.

Run `--device cpu` for a seconds-long TINY demo, or on a machine with a
card (the default) at production geometry, with `--model checkpoint.gguf`
for real weights.
"""

import os
import time

from _common import setup, demo_utterance


def main(argv=None):
    args, cfg, params = setup(argv)
    from zerovox_tpu_torch.io.wav import write_wav
    from zerovox_tpu_torch.models.pipeline import load_model, synthesize

    src, pun, style = demo_utterance(cfg)

    t0 = time.perf_counter()
    model = load_model(params, cfg, args.device)     # weights packed once
    res = synthesize(model.params, cfg, src, pun, style, device=model.device,
                     packed=model.packed)
    res.wav.cpu()
    print(f"first run (kernel build at first use + weight packing): "
          f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    res = synthesize(model.params, cfg, src, pun, style, device=model.device,
                     packed=model.packed)
    wav = res.wav[0].cpu().numpy()
    print(f"warm run (incl. host fetch): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    mel_len = int(res.mel_len[0])
    n = mel_len * cfg.hop_size if mel_len else len(wav)
    out = os.path.join(args.out_dir, "example01.wav")
    write_wav(out, wav[:n] if n else wav, cfg.sampling_rate)
    print(f"wrote {out}: {n} samples "
          f"({n / cfg.sampling_rate:.2f}s @ {cfg.sampling_rate} Hz; "
          f"predicted mel_len={mel_len} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
