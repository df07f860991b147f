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
lax.switch; here the prefix is a plain slice. The prefix is still quantised
to whole slabs (capacity / n_slabs rows each), so both packages run the
same rows. Slicing needs the watermark on the host: `watermark` returns it
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


def prefix_map(fn, tail_fn, args: dict, hi, n_slabs: int):
    """Apply rowwise `fn` over the whole-slab row prefix covering `hi`.

    args: a dict of tensors sharing a leading axis P (P % n_slabs == 0).
    fn(prefix_args) returns a tensor or a (nested) tuple of tensors of
    [m, ...] rows for the covering prefix m; tail_fn(tail_args) the same
    structure for the remaining [P - m, ...] rows (constants for pad-style
    outputs, or the sliced inputs themselves for update-in-place
    semantics). The outputs are concatenated back to [P, ...].

    Exactness contract: rows >= hi must be don't-care (the render path:
    masked and radius-0 downstream) or fixed points of fn (Adam and the
    statistics on zero-moment, zero-gradient rows).
    """
    P = next(iter(args.values())).shape[0]
    m = prefix_rows(hi, P, n_slabs)
    head = fn({k: v[:m] for k, v in args.items()})
    if m == P:
        return head
    return _cat(head, tail_fn({k: v[m:] for k, v in args.items()}))


def _cat(head, tail):
    """Row-concatenate matching (nested tuple / NamedTuple) outputs."""
    if isinstance(head, torch.Tensor):
        return torch.cat([head, tail])
    parts = [_cat(h, t) for h, t in zip(head, tail)]
    return type(head)(*parts) if hasattr(head, "_fields") else tuple(parts)
