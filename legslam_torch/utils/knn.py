"""Mean squared distance to the 3 nearest neighbors (simple-knn equivalent).

The reference initializes log-scales from distCUDA2 = mean of squared
distances to the 3 exact nearest neighbors (third_party/simple-knn/
simple_knn.cu:147-183). Here: chunked brute-force distance matrices, exact
in float32 (TF32 is off for the package, see legslam_torch/__init__.py).
"""
from __future__ import annotations

import torch


@torch.no_grad()
def mean_sq_dist_to_3nn(points: torch.Tensor,
                        valid: torch.Tensor | None = None,
                        chunk: int = 1024) -> torch.Tensor:
    """[N, 3] points -> [N] mean of squared distances to the 3 nearest
    others. `valid` masks padded entries out of the neighbour pool (their
    own result is arbitrary)."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    sq = torch.sum(points * points, dim=-1)
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    cols = torch.arange(n, device=points.device)
    for i0 in range(0, n, chunk):
        block = points[i0:i0 + chunk]
        # the |x|^2 + |y|^2 - 2xy expansion cancels O(10)-scale terms down
        # to ~1e-4-scale distances: it needs a full float32 product
        d2 = sq[i0:i0 + chunk, None] + sq[None, :] - 2.0 * (block @ points.T)
        d2 = torch.clamp_min(d2, 0.0)
        self_mask = cols[i0:i0 + chunk, None] == cols[None, :]
        d2 = torch.where(self_mask | ~valid[None, :], float("inf"), d2)
        top3 = torch.topk(d2, min(3, n), dim=-1, largest=False).values
        # missing neighbours count as 0 in the mean over 3
        out[i0:i0 + chunk] = torch.sum(
            torch.where(torch.isfinite(top3), top3, 0.0), dim=-1) / 3.0
    return out
