"""The multi-rank steps on a gloo group of two CPU processes against the
port's one-process steps (tests/torch_dist_worker.py holds the rank
worker; it imports no JAX).

* "views": 4 views, 2 a rank (shard_batch), the gradients and the densify
  increments all_reduced;
* "views_strips": the same batch rendered in 2 strips a view (in turn),
  views over the ranks (spatial_batched_train_step's view group);
* "strips": one view in 2 strips, a strip a rank, the gradients
  all_reduced;
* "store": the store capacity-sharded over the ranks, the one-view step
  rendered whole on each rank (each keeps its rows of its gradient);
* "strips_store": the store sharded and the strips split over the same
  ranks, the gradients reduce-scattered to the owners;
* "strips_of_views": the 4 views on each rank, each view's 2 strips split
  over a 1 x 2 grid of the ranks (spatial.make_groups);
* "mapper_views", "mapper_store": GaussianMapper with 2 views a tick or
  the store sharded, over the default group (the mapper sizes its group
  and, for the store, keeps one shard a rank and gathers it for surgery),
  5 frames with one densify, against the one-process mapper.

Tolerances: the ranks' stores (a sharded one gathered) equal each other
bit for bit; against the one-process step the loss rtol 1e-6, the store atol
1e-6 / rtol 1e-5, but for at most 1 element in 1000 of a tensor, each
within 2 learning-rate steps (the sums meet in another order, and Adam's
first step turns the sign of a gradient at rounding noise into a whole
step); visit counts exactly. Each test joins its ranks within 120 s, so a
hung rank fails the test and not the suite; the rendezvous is a file in
the test's tmp_path.
"""
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from legslam_torch.models import gaussians as G

from . import torch_dist_worker as worker

torch.set_num_threads(1)

JOIN_S = 120
WORLD = 2
# the largest learning rate of the step (opacity's) and the index of the
# statistics' visit counts in G.state_tensors
MAX_LR = 0.05
DENOM = 3 * len(G.GROUPS) + 1


def _spawn(tmp_path, case):
    ctx = mp.spawn(worker.run, args=(WORLD, str(tmp_path / "rdzv"),
                                     str(tmp_path), case),
                   nprocs=WORLD, join=False)
    import time
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"{case}: ranks did not finish in {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]


@pytest.mark.parametrize("case", ["views", "views_strips", "strips",
                                  "store", "strips_store", "strips_of_views",
                                  "mapper_views", "mapper_store"])
def test_ranks_match_one_process(tmp_path, case):
    ranks = _spawn(tmp_path, case)
    st, loss = worker.step(case)
    want = [x.numpy() for x in G.state_tensors(st)]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], loss.numpy(), rtol=1e-6,
                                   err_msg=f"rank {r} loss")
        for i, w in enumerate(want):
            g = got[f"t{i}"]
            if i == DENOM or w.dtype != np.float32:
                np.testing.assert_array_equal(g, w, err_msg=f"{r}:{i}")
                continue
            bad = ~np.isclose(g, w, atol=1e-6, rtol=1e-5)
            assert bad.mean() <= 1e-3, (r, i, bad.sum())
            assert np.all(np.abs(g - w)[bad] <= 2 * MAX_LR), (r, i)
    for i in range(len(want)):
        np.testing.assert_array_equal(ranks[0][f"t{i}"], ranks[1][f"t{i}"])
