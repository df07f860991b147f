"""The stereo cell's SGM numbers on a tiny CPU run: the sound program
passes them, and a program with a path of its aggregation dropped, with
its disparity one pixel off, or matching each keyframe's pair a second
time in the mapper, fails them. The faults are planted underneath a whole
run."""
from __future__ import annotations

import pytest

from conftest import run_tiny

CELL = "euroc.stereo"
SGM = ("sgm_mismatch", "sgm_gap", "sgm_count_gap")


def failing(res) -> list:
    return [k for k, v in res["checks"].items() if v["value"] > v["limit"]]


def _dropped_path(monkeypatch):
    from legslam_torch.ops import stereo
    real = stereo._aggregate_all

    def three_paths(cost, p1, p2):
        # the sum less the bottom-to-top path
        up = stereo._aggregate_dir(cost.movedim(0, 1), p1, p2, True)
        return real(cost, p1, p2) - up.movedim(0, 1)
    monkeypatch.setattr(stereo, "_aggregate_all", three_paths)


def _one_off(monkeypatch):
    from legslam_torch.ops import stereo
    real = stereo.disparity_from_aggregate

    def off(*a, **k):
        d = real(*a, **k)
        return d.where(d < 0, d + 1.0)
    monkeypatch.setattr(stereo, "disparity_from_aggregate", off)


def _second_sgm(monkeypatch):
    from legslam_torch.mapper.mapper import GaussianMapper
    real = GaussianMapper._stereo_inactive_geometry

    def matched_again(self, kf, packet):
        import dataclasses
        return real(self, kf, dataclasses.replace(packet, disparity=None))
    monkeypatch.setattr(GaussianMapper, "_stereo_inactive_geometry",
                        matched_again)


def test_sound_program_passes_the_sgm_numbers():
    res, _, _ = run_tiny(CELL)
    assert not failing(res)
    assert res["info"]["sgm_calls"] == res["info"]["keyframes"] > 0


@pytest.mark.parametrize("fault, fails", [
    (_dropped_path, {"sgm_mismatch", "sgm_gap"}),
    (_one_off, {"sgm_mismatch", "sgm_gap"}),
    (_second_sgm, {"sgm_count_gap"}),
])
def test_planted_fault_fails(monkeypatch, fault, fails):
    fault(monkeypatch)
    res, _, _ = run_tiny(CELL)
    assert fails <= set(failing(res)), res["checks"]


def test_a_tile_batch_without_pairs_adds_no_gradient():
    """One gaussian in the middle of a 256 x 64 view: most tile batches of
    the reference's step hold no pair. The reference raises on them; under
    batches_without_pairs it gives the gradients of the batches that hold
    the gaussian, as one batch of every tile does."""
    import math

    import numpy as np
    import torch

    from legs_bench import stereo_check
    from legs_bench.reference import mapping as ref
    w, h = 256, 64
    params = dict(
        xyz=torch.tensor([[0.0, 0.0, 2.0]]), f_dc=torch.full((1, 1, 3), 0.5),
        f_rest=torch.zeros(1, 15, 3), lang_feat=torch.ones(1, 4),
        opacity=torch.tensor([[1.0]]), scaling=torch.full((1, 3), -3.0),
        rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    valid = torch.ones(1, dtype=torch.bool)
    fov = 2.0 * math.atan(w / (2.0 * 128.0)), 2.0 * math.atan(h / 256.0)
    v = ref.view(np.eye(3), np.zeros(3), w, h, *fov, torch.device("cpu"))
    gt = dict(color=torch.rand(h, w, 3), depth=torch.ones(h, w),
              mask=torch.ones(h, w), lf=torch.rand(h, w, 4))
    cfg = dict(tile_w=16, tile_h=16, chunk=8, tile_batch=4)
    args = (params, valid, v, 0, gt)
    with pytest.raises(RuntimeError):
        ref.render_and_grad(*args, cfg, torch.bfloat16, 0.2)
    with stereo_check.batches_without_pairs():
        loss, _, grads = ref.render_and_grad(*args, cfg, torch.bfloat16,
                                             0.2)
    assert ref.composite_tiles.__name__ == "composite_tiles"
    whole = dict(cfg, tile_batch=w * h // 256)
    loss1, _, grads1 = ref.render_and_grad(*args, whole, torch.bfloat16,
                                           0.2)
    assert float(loss) == float(loss1)
    assert grads["xyz"].abs().sum() > 0
    for k in grads:
        torch.testing.assert_close(grads[k], grads1[k], rtol=1e-5,
                                   atol=1e-7)
