"""The lens-distorted camera path of legslam_torch against legslam_tpu's,
on the CPU: every case of tests/test_undistort.py run on both packages,
the mapper's ingestion of a distorted keyframe at every pyramid level,
and a short mapper run on distorted frames.

* undistort_rectify_map / remap_bilinear (host numpy in both): maps and
  remaps equal bit for bit;
* build_undistortion: the same valid mask bit for bit, None in the same
  cases;
* GaussianMapper._ingest_keyframe of the same distorted packet: gt_color
  and gt_depth equal at every level, the mask within 1e-6 (the sub-level
  masks are resized, cv2 on the JAX side and torch here);
* mapping_loss: garbage in the masked band leaves the port's loss
  unchanged to rtol 1e-6, and the loss equals JAX's to rtol 1e-5 (f32
  reductions in another order, as in tests/test_torch_losses.py).
The short mapper run on distorted frames is in
tests/test_torch_undistort_mapper.py (its JAX side compiles the Pallas
kernels in interpret mode, so it gets a worker of its own).
"""
import numpy as np
import pytest
import torch

from legslam_tpu.ops import losses as JL
from legslam_tpu.utils import undistort as JU
from legslam_torch.ops import losses as TL
from legslam_torch.utils import undistort as TU

from .torch_parity import np_, t_

torch.set_num_threads(1)

W, H = 160, 120
K = np.array([[120.0, 0, 79.5], [0, 120.0, 59.5], [0, 0, 1]], np.float64)
DIST = (0.25, -0.05, 0.001, -0.002)  # TUM-ish radial-tangential
INTR = dict(width=W, height=H, fx=K[0, 0], fy=K[1, 1], cx=K[0, 2],
            cy=K[1, 2], dist_coeffs=DIST)


def test_identity_when_undistorted():
    mx, my = TU.undistort_rectify_map(K, (0, 0, 0, 0), K, W, H)
    jx, jy = JU.undistort_rectify_map(K, (0, 0, 0, 0), K, W, H)
    np.testing.assert_array_equal(mx, jx)
    np.testing.assert_array_equal(my, jy)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    np.testing.assert_allclose(mx, u, atol=1e-4)
    np.testing.assert_allclose(my, v, atol=1e-4)
    img = np.random.default_rng(0).uniform(size=(H, W, 3)).astype(np.float32)
    out = TU.remap_bilinear(img, mx, my)
    np.testing.assert_array_equal(out, JU.remap_bilinear(img, jx, jy))
    np.testing.assert_allclose(out, img, atol=1e-5)


@pytest.mark.parametrize("dist", [DIST, DIST + (0.01,)])
def test_map_and_remap_match(dist):
    """Bit for bit against JAX (4 and 5 coefficients), and, as JAX's own
    case, within 1e-3 px / 1e-4 of OpenCV where cv2 is installed."""
    mx, my = TU.undistort_rectify_map(K, dist, K, W, H)
    jx, jy = JU.undistort_rectify_map(K, dist, K, W, H)
    np.testing.assert_array_equal(mx, jx)
    np.testing.assert_array_equal(my, jy)
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, size=(H, W)).astype(np.float32)
    ours = TU.remap_bilinear(img, mx, my)
    np.testing.assert_array_equal(ours, JU.remap_bilinear(img, jx, jy))
    np.testing.assert_array_equal(TU.remap_bilinear(depth, mx, my),
                                  JU.remap_bilinear(depth, jx, jy))
    try:
        import cv2
    except ImportError:
        return
    cm1, cm2 = cv2.initUndistortRectifyMap(
        K.astype(np.float32), np.asarray(dist, np.float32),
        np.eye(3, dtype=np.float32), K.astype(np.float32), (W, H),
        cv2.CV_32FC1)
    np.testing.assert_allclose(mx, cm1, atol=1e-3)
    np.testing.assert_allclose(my, cm2, atol=1e-3)
    ref = cv2.remap(img, cm1, cm2, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT)
    np.testing.assert_allclose(ours[2:-2, 2:-2], ref[2:-2, 2:-2], atol=1e-4)


def test_valid_mask_kills_border():
    und, und_j = TU.build_undistortion(INTR), JU.build_undistortion(INTR)
    assert und is not None and und_j is not None
    np.testing.assert_array_equal(und.valid_mask, und_j.valid_mask)
    np.testing.assert_array_equal(und.map_x, und_j.map_x)
    np.testing.assert_array_equal(und.map_y, und_j.map_y)
    # barrel distortion pulls corners outside the source image
    assert und.valid_mask[0, 0] < 0.5
    assert und.valid_mask[-1, -1] < 0.5
    assert und.valid_mask[H // 2, W // 2] == pytest.approx(1.0, abs=1e-5)
    # no distortion -> no machinery, on both sides
    for intr in (dict(width=W, height=H, fx=1, fy=1, cx=0, cy=0),
                 dict(width=W, height=H, fx=1, fy=1, cx=0, cy=0,
                      dist_coeffs=(0, 0, 0, 0))):
        assert TU.build_undistortion(intr) is None
        assert JU.build_undistortion(intr) is None


def _distorted_packet(module):
    """JAX's case: seeded color with garbage in the raw border."""
    rng = np.random.default_rng(2)
    color = rng.uniform(0.2, 0.8, size=(H, W, 3)).astype(np.float32)
    color[:3] = 7.0
    color[:, :3] = -7.0
    depth = np.full((H, W), 2.0, np.float32)
    depth[5:40, 10:70] = 3.5        # an edge the remap blends across
    return module.KeyframePacket(
        fid=0, timestamp=0.0, R=np.eye(3, dtype=np.float32),
        t=np.zeros(3, np.float32), color=color, depth=depth, lf_image=None)


def test_mapper_ingests_undistorted_keyframes(tmp_path):
    from legslam_torch.config import MapperParams
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.slam import interface as TI
    from legslam_tpu.config import MapperParams as JaxMP
    from legslam_tpu.mapper.mapper import GaussianMapper as JaxMapper
    from legslam_tpu.slam import interface as JI
    mp = dict(num_gaus_pyramid_sub_levels=2)
    mj = JaxMapper(JI.OperationQueue(), INTR, mp=JaxMP(**mp),
                   capacity=1 << 10, result_dir=str(tmp_path / "jax"))
    mt = GaussianMapper(TI.OperationQueue(), INTR, mp=MapperParams(**mp),
                        capacity=1 << 10, result_dir=str(tmp_path / "torch"),
                        device="cpu")
    mj._ingest_keyframe(_distorted_packet(JI))
    mt._ingest_keyframe(_distorted_packet(TI))
    kj, kt = mj.keyframes[0], mt.keyframes[0]
    assert len(kt.gt_color) == len(kj.gt_color) == 3
    for lvl in range(3):
        np.testing.assert_array_equal(np_(kt.gt_color[lvl]),
                                      np.asarray(kj.gt_color[lvl]))
        np.testing.assert_array_equal(np_(kt.gt_depth[lvl]),
                                      np.asarray(kj.gt_depth[lvl]))
        np.testing.assert_allclose(np_(kt.mask[lvl]),
                                   np.asarray(kj.mask[lvl]), rtol=0,
                                   atol=1e-6)
    # JAX's own checks, on the port's keyframe
    m = np_(kt.mask[-1])
    gt = np_(kt.gt_color[-1])
    assert m[0, 0] < 0.5 and m[H // 2, W // 2] > 0.99
    assert abs(gt[0, 0]).max() < 1.5  # garbage (7.0) never survives verbatim
    assert gt.shape == (H, W, 3)


def test_masked_loss_ignores_invalid_region():
    rng = np.random.default_rng(3)
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    depth_gt = rng.uniform(1, 3, size=(H, W)).astype(np.float32)
    mask = np.ones((H, W), np.float32)
    mask[:10] = 0.0
    gt = gt * mask[..., None]          # undistorted GT is zero where invalid
    depth_gt = depth_gt * mask

    render_a = rng.uniform(size=(H, W, 3)).astype(np.float32)
    render_b = render_a.copy()
    render_b[:10] = 123.0              # garbage only in the masked band
    depth_r = rng.uniform(1, 3, size=(H, W)).astype(np.float32)
    la, lb = (float(TL.mapping_loss(t_(r), t_(gt), None, None, t_(depth_r),
                                    t_(depth_gt), t_(mask), 0.2))
              for r in (render_a, render_b))
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    lj = float(JL.mapping_loss(render_a, gt, None, None, depth_r, depth_gt,
                               mask, 0.2))
    np.testing.assert_allclose(la, lj, rtol=1e-5)
