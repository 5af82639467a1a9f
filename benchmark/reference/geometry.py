"""Sizes that the plain reference works out from a configuration, and that
the harness's weights and operation counts read from here, so that all
three follow one rule.  Plain Python: it imports nothing."""

from __future__ import annotations

from typing import List


def resblock_kernel_sizes(m: dict) -> List[int]:
    """The kernel size of each resblock of an MRF stage: HiFi-GAN's own
    `resblock_kernel_sizes` where the configuration gives it (it wins over
    the single size), else `resblock_kernel_size` for every resblock."""
    nrb = m["num_resblocks"]
    sizes = [int(k) for k in m.get("resblock_kernel_sizes", [m["resblock_kernel_size"]] * nrb)]
    if len(sizes) != nrb:
        raise ValueError(f"resblock_kernel_sizes {sizes} has {len(sizes)} entries, "
                         f"num_resblocks is {nrb}")
    if any(k % 2 == 0 for k in sizes):
        raise ValueError(f"resblock_kernel_sizes {sizes}: every size must be odd")
    return sizes
