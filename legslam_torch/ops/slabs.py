"""Watermark slab skip for the per-gaussian work of a capacity-padded store.

Counterpart of legslam_tpu/ops/slabs.py. The store keeps a fixed capacity
(e.g. 262144 slots holding 200k live gaussians) and the per-gaussian
segments of the mapping step (the render prologue, Adam, the densify
statistics) would otherwise run over every slot. Live slots are
allocated lowest-free-first (models/gaussians.py _allocate_slots), so
every live row sits below a watermark; the rows at or above it are invalid
with zero Adam moments and zero gradients. The segments can therefore run
on a row prefix that covers the watermark: exactly, by those invariants.

The JAX package switched over n_slabs static prefix lengths with
lax.switch (its prefix_map); here the prefix is a row count that each
segment takes as it is: the prologue kernel pair computes the prefix and
writes the rest inert (ops/cuda/prologue.py), Adam and the statistics
slice it (models/gaussians.py). The prefix is still quantised to whole
slabs (capacity / n_slabs rows each), so both packages run the same rows. Slicing needs the watermark on the host: `watermark` returns it
as a tensor on the store's device, and `prefix_rows` reads it (one
synchronisation) unless the caller passes a host integer it already knows,
as the mapper does from its own allocation bookkeeping.
"""
from __future__ import annotations

import torch


def watermark(valid: torch.Tensor) -> torch.Tensor:
    """Smallest prefix length covering every True row of `valid` [P]."""
    iota1 = torch.arange(1, valid.shape[0] + 1, dtype=torch.int32,
                         device=valid.device)
    return torch.where(valid, iota1, 0).max()


def prefix_rows(hi, P: int, n_slabs: int) -> int:
    """Rows of the whole-slab prefix covering `hi` (an int or a tensor,
    read on the host) out of P rows in n_slabs slabs: at least one slab."""
    if P % n_slabs:
        raise ValueError(f"capacity {P} is not a multiple of {n_slabs} slabs")
    slab = P // n_slabs
    k = min(max(-(-int(hi) // slab), 1), n_slabs)
    return slab * k
