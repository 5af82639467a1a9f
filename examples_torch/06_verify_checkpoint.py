"""Verify a checkpoint against the reference C++ implementation.

`python -m zerovox_tpu_torch.cli --model m.gguf --verify` (or
`zerovox_tpu_torch.utils.verify.verify_checkpoint`) compiles the
reference's own FS2Encoder / StyleTTSDecoder / HiFiGAN classes (unmodified,
against the vendored ggml build), loads the SAME GGUF into both
implementations, and diffs all three eval() boundaries, the port's stages
running with f16 conv operands as ggml's do (on the card the MRF kernel's
f16-staged mode).  It is the shippable form of the numerics-parity gate,
usable on any user-supplied checkpoint (e.g. after training + export).

Needs the reference source tree (ZEROVOX_REF, default reference/ in the
checkout) and a C/C++ toolchain; when either is missing the report says so
instead of failing (the CLI then exits 2).
"""

import os

from _common import setup


def main(argv=None):
    args, cfg, params = setup(argv)
    from zerovox_tpu_torch.params import save_params
    from zerovox_tpu_torch.utils.verify import verify_checkpoint

    # any GGUF works — here, the demo weights written by the port's writer
    # (conv kernels stored f16 exactly like the reference exporter)
    path = os.path.join(args.out_dir, "example06.gguf")
    save_params(path, params, cfg)
    print(f"wrote {path}")

    report = verify_checkpoint(path, log=print, device=args.device)
    print(report.summary())
    if report.skipped_reason:
        print("(reference harness unavailable — install a toolchain and "
              "point ZEROVOX_REF at the reference checkout to run the diff)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
