"""How far each convolution of the training path lands from float64, on the card.

For every conv form that `training.loss_fn` differentiates through at the
production geometry (the vocoder's k=3 convs at dilations 1, 3, 5 and its
four transposed convs, at the lengths a 1500-frame mel gives them, B=1; its
input and output convs; the decoder's 1x1 convs; the encoder's k=9 FFN
conv), the forward, the input gradient (dgrad) and the weight gradient
(wgrad) in float32 against the same in float64, as max|d| / max|f64|, with
cuDNN and with PyTorch's own convolutions.  TF32 is off, as on the parity
path, so every float32 number should be a few float32 ulps (1e-7..1e-5)::

    python -m zerovox_tpu_torch.tools.conv_accuracy

About 20 s on an H100.  Needs a card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ZeroVoxConfig
from ..device import resolve_device
from ..params import vocoder_stage_channels


def distances(f, x_shape, w_shape, gen) -> dict:
    """{cudnn: [forward, dgrad, wgrad]} of f(x, w) in float32 against
    float64, max|d| / max|f64|, on random inputs and a random output
    gradient."""
    x = torch.randn(*x_shape, device="cuda", generator=gen)
    w = torch.randn(*w_shape, device="cuda", generator=gen) / np.sqrt(np.prod(w_shape[1:]))
    gy = None
    out = {}
    for cudnn in (True, False):
        torch.backends.cudnn.enabled = cudnn
        try:
            res = {}
            for dt in (torch.float32, torch.float64):
                xx, ww = x.to(dt).requires_grad_(), w.to(dt).requires_grad_()
                y = f(xx, ww)
                if gy is None:
                    gy = torch.randn(y.shape, device="cuda", generator=gen, dtype=torch.float64)
                res[dt] = (y,) + torch.autograd.grad(y, (xx, ww), gy.to(dt))
        finally:
            torch.backends.cudnn.enabled = True
        out[cudnn] = [((a.double() - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(res[torch.float32], res[torch.float64])]
    return out


def cases(cfg: ZeroVoxConfig):
    """(label, f(x, w) on channels-first x, x shape, w shape)."""
    L = cfg.max_seq_len
    out = []
    for i, ((ci, co), s, k) in enumerate(zip(vocoder_stage_channels(cfg), cfg.upsample_scales,
                                             cfg.upsample_kernel_sizes)):
        p, op = s // 2 + s % 2, s % 2
        out.append((f"transposed conv, stage {i}: {ci}->{co}, L {L}, stride {s}, k {k}",
                    lambda x, w, s=s, p=p, op=op: F.conv_transpose1d(
                        x, w, stride=s, padding=p, output_padding=op), (1, ci, L), (ci, co, k)))
        L *= s
        for d in sorted({d for ds in cfg.resblock_dilations for d in ds}):
            out.append((f"resblock conv, stage {i}: C {co}, L {L}, k 3, dilation {d}",
                        lambda x, w, d=d: F.conv1d(x, w, padding=d, dilation=d),
                        (1, co, L), (co, co, 3)))
    c, L = cfg.hifigan_channels, cfg.max_seq_len
    c_last = c // 2 ** len(cfg.upsample_scales)
    k = cfg.hifigan_kernel_size
    d, b, r = cfg.d_model, cfg.bottleneck_dim, cfg.residual_dim
    out += [
        (f"vocoder input conv: {cfg.num_mels}->{c}, L {L}, k {k}",
         lambda x, w: F.conv1d(x, w, padding=k // 2), (1, cfg.num_mels, L), (c, cfg.num_mels, k)),
        (f"vocoder output conv: {c_last}->1, L {cfg.wav_len}, k {k}",
         lambda x, w: F.conv1d(x, w, padding=k // 2), (1, c_last, cfg.wav_len), (1, c_last, k)),
        (f"decoder conv: {b + r}->{b}, L {L}, k 3",
         lambda x, w: F.conv1d(x, w, padding=1), (1, b + r, L), (b, b + r, 3)),
        (f"decoder 1x1 conv: {b + r}->{b}, L {L}",
         lambda x, w: F.conv1d(x, w), (1, b + r, L), (b, b + r, 1)),
        (f"encoder FFN conv: {d}->{cfg.conv_filter_size}, L {cfg.max_n_phonemes}, k 9",
         lambda x, w: F.conv1d(x, w, padding=4), (1, d, cfg.max_n_phonemes),
         (cfg.conv_filter_size, d, cfg.conv_kernel_size[0])),
    ]
    return out


def main(argv=None) -> int:
    resolve_device("cuda")               # TF32 off, as on the parity path
    cfg = ZeroVoxConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"{torch.cuda.get_device_name(0)}; float32 against float64, max|d| / max|f64| "
          f"(forward, dgrad, wgrad)", flush=True)
    for label, f, xs, ws in cases(cfg):
        d = distances(f, xs, ws, gen)
        print(f"  {label}: cuDNN {', '.join('%.1e' % v for v in d[True])}; "
              f"native {', '.join('%.1e' % v for v in d[False])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
