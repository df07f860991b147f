"""The host side of the SGM kernels' wrapper (legslam_torch/ops/cuda/
sgm.py) on the CPU; the kernels themselves are held to their plain twin on
a card in tests/test_torch_sgm_cuda.py.

* CPU tensors take the plain twin (sgm_aggregate, disparity_from_aggregate)
  and launch nothing, with `stereo.sgm` and its four child spans;
* one path's stored cost takes 8 bits while 24 + P2 fits them, 16 above;
  a lane holds D / 32 disparities rounded up to a power of two;
* more than 256 disparities, penalties the kernels cannot take, a pair of
  other shapes, too many pixels and a device with no kernel raise.
"""
import pytest
import torch

from legslam_torch.ops import stereo as S
from legslam_torch.ops.cuda import sgm as K
from legslam_torch.utils import runtime


def _pair(h=24, w=40, shift=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    tex = torch.rand(h, w + shift, generator=g)
    return tex[:, :w].contiguous(), tex[:, shift:].contiguous()


def test_cpu_takes_the_twin_with_its_spans():
    left, right = _pair()
    n0 = K.sgm.launches
    runtime.tracing(True)
    try:
        got = S.sgm_disparity(left, right, num_disp=16, min_disp=1,
                              keyframe=5)
    finally:
        runtime.tracing(False)
    spans = runtime.trace_export()
    assert K.sgm.launches == n0
    want = S.disparity_from_aggregate(S.sgm_aggregate(left, right, 16), 16,
                                      1)
    assert torch.equal(got, want)
    assert float((got > 0).float().mean()) > 0.5
    (top,) = [s for s in spans if s["name"] == "stereo.sgm"]
    assert top["attrs"] == dict(keyframe=5, width=40, height=24,
                                disparities=16, steps=39)
    children = [s["name"] for s in spans if s["parent"] == top["id"]]
    assert children == ["sgm.census", "sgm.cost", "sgm.aggregate",
                        "sgm.disparity"]


@pytest.mark.parametrize("p2,bits", [(0, 8), (120, 8), (231, 8), (232, 16),
                                     (400, 16), (65511, 16)])
def test_path_bits(p2, bits):
    assert K.path_bits(p2) == bits


def test_path_bits_beyond_16():
    with pytest.raises(ValueError, match="16 bits"):
        K.path_bits(65512)


@pytest.mark.parametrize("num_disp,k", [(1, 1), (16, 1), (32, 1), (33, 2),
                                        (64, 2), (100, 4), (128, 4),
                                        (129, 8), (256, 8)])
def test_lanes(num_disp, k):
    assert K.lanes(num_disp) == k


@pytest.mark.parametrize("kw,match", [
    (dict(num_disp=257), "disparities"),
    (dict(num_disp=0), "disparities"),
    (dict(p1=10.5), "integer"),
    (dict(p2=-1.0), "integer"),
    (dict(p2=70000.0), "16 bits"),
])
def test_arguments_the_kernels_do_not_take_raise(kw, match):
    left, right = _pair()
    with pytest.raises(ValueError, match=match):
        K.sgm(left, right, **kw)


def test_operands_the_kernels_do_not_take_raise():
    left, right = _pair()
    n0 = K.sgm.launches
    with pytest.raises(ValueError, match="equal"):
        K.sgm(left, right[:, 1:], 16)
    with pytest.raises(ValueError, match="equal"):
        K.sgm(left[None], right[None], 16)
    big = torch.empty(1 << 15, 1 << 15, device="meta")
    with pytest.raises(ValueError, match="32 bits"):
        K.sgm(big, big, 16)
    with pytest.raises(ValueError, match="no SGM kernel"):
        K.sgm(left, right, 16)
    # through sgm_disparity: a device that is neither the CPU nor CUDA
    meta = torch.empty(24, 40, device="meta")
    with pytest.raises(ValueError, match="no SGM kernel"):
        S.sgm_disparity(meta, meta, 16)
    assert K.sgm.launches == n0
