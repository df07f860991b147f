"""The SGM kernels (legslam_torch/csrc/sgm.cu) on a card, against their
plain twin on the same card, without JAX:

    python -m pytest --noconftest tests/test_torch_sgm_cuda.py -q

Marker `cuda`; every test skips without a card. The host side of the
wrapper (routes, storage width, operand checks) is tested on the CPU in
tests/test_torch_sgm_route.py.

ops/stereo.sgm_disparity takes the kernels for CUDA tensors; the twin is
sgm_aggregate and disparity_from_aggregate on the same tensors. The two
must be equal bit for bit (integer and subpixel disparities, the -1s
alike) at the stereo cell's shape (752x480, 128 disparities from 8), a
portrait pair, a width that is not a multiple of 32, 16 disparities from
1 and 64 disparities, a flat pair (every cost ties: the lowest disparity
wins), more disparities than columns, and a P2 whose path costs need 16
bits; each call launches at most 6 kernels.
"""
import numpy as np
import pytest
import torch

from legslam_torch.ops import stereo as S
from legslam_torch.ops.cuda import sgm as K

# (name, height, width, disparities, min disparity, shift, P1, P2)
CASES = [
    ("cell_752x480_d128", 480, 752, 128, 8, 40, 10.0, 120.0),
    ("portrait", 200, 120, 64, 8, 12, 10.0, 120.0),
    ("width_not_32", 90, 173, 48, 4, 9, 10.0, 120.0),
    ("d16_from_1", 64, 96, 16, 1, 5, 10.0, 120.0),
    ("d64", 96, 160, 64, 8, 20, 10.0, 120.0),
    ("d_above_width", 40, 48, 64, 2, 6, 10.0, 120.0),
    ("wide_paths_p2_400", 72, 128, 32, 2, 7, 30.0, 400.0),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(h, w, shift, seed=0):
    """A seeded textured grey pair (smooth noise with fine grain): the
    right view is the left seen `shift` columns further on, right(x) =
    left(x + shift), with noise."""
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.uniform(size=(1, 1, h // 6 + 2, w // 6 + 2)),
                           dtype=torch.float32)
    smooth = torch.nn.functional.interpolate(
        base, size=(h, w + shift), mode="bilinear",
        align_corners=False)[0, 0].numpy()
    tex = smooth + 0.1 * rng.uniform(size=smooth.shape)
    left = tex[:, :w].astype(np.float32)
    right = (tex[:, shift:] + rng.normal(scale=0.01, size=(h, w))).astype(
        np.float32)
    return torch.as_tensor(left), torch.as_tensor(right)


def _both(left, right, nd, min_disp, p1=10.0, p2=120.0):
    """(kernel route, plain twin) disparities on the card, and the kernel
    launches of the one call."""
    dev = _card()
    lc, rc = left.to(dev), right.to(dev)
    n0 = K.sgm.launches
    got = S.sgm_disparity(lc, rc, nd, min_disp, p1, p2)
    launches = K.sgm.launches - n0
    want = S.disparity_from_aggregate(S.sgm_aggregate(lc, rc, nd, p1, p2),
                                      nd, min_disp)
    torch.cuda.synchronize()
    return got.cpu(), want.cpu(), launches


def _equal_bits(got, want):
    assert got.dtype == want.dtype == torch.float32
    diff = (got.view(torch.int32) != want.view(torch.int32))
    assert not diff.any(), (
        f"{int(diff.sum())} of {diff.numel()} pixels differ; first "
        f"{got[diff][:5].tolist()} vs {want[diff][:5].tolist()}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_equals_twin(case):
    _, h, w, nd, min_disp, shift, p1, p2 = case
    left, right = _pair(h, w, shift)
    got, want, launches = _both(left, right, nd, min_disp, p1, p2)
    _equal_bits(got, want)
    assert launches <= 6
    valid = want > 0
    assert valid.float().mean() > 0.2 or nd > w
    if nd <= w:
        # the pair's shift is found where the match is valid
        assert abs(float(want[valid].median()) - shift) < 1.0


@pytest.mark.cuda
def test_flat_pair_ties_to_the_lowest_disparity():
    left = torch.full((48, 80), 0.5)
    got, want, _ = _both(left, left.clone(), 32, 1)
    _equal_bits(got, want)
    # census all zero: disparity 0 costs nothing anywhere, and ties with
    # every disparity a pixel can see, so the lowest wins everywhere
    agg = S.sgm_aggregate(left, left, 32)
    assert torch.equal(agg.argmin(-1), torch.zeros(48, 80, dtype=torch.long))


@pytest.mark.cuda
def test_launches_per_call_and_repeat():
    left, right = _pair(96, 160, 20, seed=3)
    dev = _card()
    lc, rc = left.to(dev), right.to(dev)
    n0 = K.sgm.launches
    first = S.sgm_disparity(lc, rc, 64, 8)
    second = S.sgm_disparity(lc, rc, 64, 8)
    # census, the four paths, the winner: three a call
    assert K.sgm.launches - n0 == 6
    _equal_bits(first.cpu(), second.cpu())


@pytest.mark.cuda
def test_kernel_on_a_strided_or_double_pair():
    """A non-contiguous or float64 grey image is taken as the twin takes
    it (converted to contiguous float32)."""
    left, right = _pair(64, 128, 10, seed=5)
    dev = _card()
    wide_l = torch.stack([left, left], -1).to(dev)[..., 0]
    got = S.sgm_disparity(wide_l, right.double().to(dev), 32, 2)
    want = S.disparity_from_aggregate(
        S.sgm_aggregate(left.to(dev), right.to(dev), 32), 32, 2)
    _equal_bits(got.cpu(), want.cpu())
