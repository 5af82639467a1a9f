"""Static-shape length regulator (exact integer logic).

Frame j belongs to the phoneme whose cumulative-duration interval contains
j, which reproduces the reference's repeat / truncate-at-max_seq_len /
zero-pad semantics, including a phoneme cut mid-repeat at the boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def durations_from_log(log_dur: torch.Tensor, max_seq_len: int) -> torch.Tensor:
    """max(0, floor(exp(log_dur) - 0.5)), clipped to max_seq_len before the
    cast so an exp overflow saturates instead of wrapping.  int32."""
    d = torch.floor(torch.exp(log_dur.to(torch.float32)) - 0.5)
    return torch.clamp(d, 0.0, float(max_seq_len)).to(torch.int32)


def length_regulate(features: torch.Tensor,
                    durations: torch.Tensor,
                    max_seq_len: int,
                    num_phonemes: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand phoneme features (B, P, C) by durations (B, P) to mel frames.

    num_phonemes: optional (B,) valid-phoneme counts; trailing phonemes get
    zero duration.  Returns (expanded (B, max_seq_len, C), mel_len (B,) int32).
    """
    B, P, C = features.shape
    dev = features.device
    durations = durations.to(torch.int64)
    if num_phonemes is not None:
        num_phonemes = torch.as_tensor(num_phonemes, device=dev).reshape(-1)
        num_phonemes = num_phonemes.expand(B)
        pidx = torch.arange(P, device=dev)[None, :]
        durations = torch.where(pidx < num_phonemes[:, None], durations, 0)

    ends = torch.cumsum(durations, dim=1)                   # exclusive end frame
    total = torch.clamp(ends[:, -1], max=max_seq_len)

    frame = torch.arange(max_seq_len, device=dev)
    # phoneme owning frame j = #{i : ends_i <= j}
    phon_idx = (ends[:, None, :] <= frame[None, :, None]).sum(dim=-1)
    phon_idx = torch.clamp(phon_idx, 0, P - 1)
    valid = frame[None, :] < total[:, None]

    expanded = torch.gather(features, 1, phon_idx[:, :, None].expand(B, max_seq_len, C))
    expanded = torch.where(valid[:, :, None], expanded,
                           torch.zeros((), dtype=features.dtype, device=dev))
    return expanded, total.to(torch.int32)
