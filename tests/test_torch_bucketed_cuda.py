"""The compositing kernels on the bucketed layout, on a card (marker
`cuda`; they skip without one). The file imports no JAX, so on the card
machine it runs without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_bucketed_cuda.py -q

* each kernel with n_buckets 4 against its plain version on the pair
  arrays of a seeded scene, float32 and bfloat16 features, with and
  without language features, and on a scene whose opaque front layer
  terminates every pixel of its tiles in the first bucket (the stop
  between ranges). Tolerances: acc and t_final atol 2e-4 / rtol 1e-3
  (tests/test_torch_kernels.py's), dgeo and dfeats atol 2e-4 / rtol 2e-2;
* n_buckets 1 takes the flat path: a one-bucket BucketedBinning gives the
  kernels the flat binning's ranges, and their t_final, acc and kfin are
  the flat ones bit for bit;
* the bucketed render equals the flat render on the card (forward
  tolerances, atol 3e-5 / rtol 1e-3, LF 2e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

from legslam_torch.config import RasterizeConfig
from legslam_torch.models import gaussians as G
from legslam_torch.ops import binning as TB
from legslam_torch.ops.cuda import composite as CF
from legslam_torch.ops.cuda import composite_bwd as CB
from legslam_torch.ops.projection import preprocess
from legslam_torch.ops.rasterize import rasterize
from legslam_torch.utils.camera import CameraView
from legslam_torch.utils.sh import sh_to_color

W, H, CHUNK = 256, 96, 64
B, CAP = 4, 1 << 12


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(device, seed=0, blanket=False):
    rng = np.random.default_rng(seed)
    n, cap = 900, 1024
    pts = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 2.5
    k = 0
    if blanket:
        # two layers of a 12 x 5 grid of opaque gaussians (sigma 15 px, 15
        # px apart) in front of the first tile: every pixel of it ends
        # below T = 1e-4 within the nearest depth ranks, the first bucket
        gx, gy = np.meshgrid(np.linspace(-1.0, 0.1, 12),
                             np.linspace(-0.45, -0.1, 5))
        layer = np.stack([gx.ravel(), gy.ravel()], 1)
        k = 2 * len(layer)
        pts[:k, :2] = np.concatenate([layer, layer])
        pts[:k, 2] = np.repeat([1.0, 1.05], len(layer))
        pts[:k, :2] *= pts[:k, 2:]
    st = G.create_from_pcd(pts, rng.uniform(size=(n, 3)), cap,
                           lang_feat=rng.normal(size=(n, 64)), device=device)
    op = rng.uniform(0.5, 0.99, size=cap).astype(np.float32)
    if blanket:
        op[:k] = 0.99
        st.params.scaling[:k] = float(np.log(0.1))
        st.params.rotation[:k] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    st.params.opacity.copy_(torch.as_tensor(np.log(op / (1 - op))[:, None]))
    view = CameraView.create(np.eye(3), np.zeros(3), W, H, fx=150.0,
                             fy=150.0, device=device)
    return st, view


def _pairs(st, view, mm_dtype, n_buckets, with_lf=True):
    cfg = RasterizeConfig(chunk=CHUNK, max_pairs=1 << 14, backend="cuda",
                          mm_dtype=mm_dtype, n_buckets=n_buckets,
                          bucket_cap=CAP)
    opacity = st.opacities()
    pre = preprocess(st.params.xyz, st.scales(), st.rotations(), st.valid,
                     view.world_view, view.full_proj, W, H, view.focal_x,
                     view.focal_y, view.tan_fovx, view.tan_fovy)
    if n_buckets > 1:
        binning = TB.bin_gaussians_bucketed(pre, W, H, cfg, n_buckets, CAP,
                                            opacity=opacity)
        assert int(binning.overflow) == 0
    else:
        binning = TB.bin_gaussians(pre, W, H, cfg, opacity=opacity)
    lf = [st.params.lang_feat] if with_lf else []
    feats = torch.cat([sh_to_color(0, st.sh(), st.params.xyz,
                                   view.cam_center), *lf,
                       pre.depth[:, None]], dim=1)
    start, count, geo, pf = CF.prepare_pairs(
        binning, pre.mean2d, pre.conic, opacity, feats, cfg.max_pairs,
        mm_dtype, n_buckets)
    return (start, count, geo, pf, 128, 16, -(-W // 128), CHUNK, n_buckets)


def _close(a, b, atol, rtol, name):
    np.testing.assert_allclose(a.detach().cpu().numpy(),
                               b.detach().cpu().numpy(), atol=atol,
                               rtol=rtol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("blanket", [False, True])
@pytest.mark.parametrize("with_lf", [True, False])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_bucketed_kernels_match_plain(mm_dtype, with_lf, blanket):
    dev = _card()
    st, view = _scene(dev, blanket=blanket)
    fa = _pairs(st, view, mm_dtype, B, with_lf)
    n0 = (CF.composite_forward.launches, CB.composite_backward.launches)
    acc, tfin, kfin = CF.composite_forward(*fa)
    torch.cuda.synchronize()
    assert kfin is None
    acc_p, tfin_p, _ = CF.composite_forward_plain(*fa)
    _close(acc, acc_p, 2e-4, 1e-3, "acc")
    _close(tfin, tfin_p, 2e-4, 1e-3, "t_final")
    if blanket:
        # the first tile terminates in its first bucket: its later ranges
        # emptied, its outputs are the same
        cut = fa[1].clone()
        cut[1:B] = 0
        acc_c, tfin_c, _ = CF.composite_forward_plain(fa[0], cut, *fa[2:])
        assert torch.equal(acc_c[0], acc_p[0])
        assert torch.equal(tfin_c[0], tfin_p[0])
        assert int(fa[1][1:B].min()) > 0
    g = torch.Generator(device=dev).manual_seed(1)
    gout = torch.randn(acc.shape, generator=g, device=dev) / W
    gt = torch.randn(tfin.shape, generator=g, device=dev) / W
    ba = fa[:4] + (gout, gt, tfin_p, acc_p) + fa[4:]
    dgeo, dfe = CB.composite_backward(*ba)
    torch.cuda.synchronize()
    dgeo_p, dfe_p = CB.composite_backward_plain(*ba)
    _close(dgeo, dgeo_p, 2e-4, 2e-2, "dgeo")
    _close(dfe, dfe_p, 2e-4, 2e-2, "dfeats")
    assert (CF.composite_forward.launches,
            CB.composite_backward.launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_one_bucket_is_the_flat_path(mm_dtype):
    dev = _card()
    st, view = _scene(dev)
    flat = _pairs(st, view, mm_dtype, 1)
    opacity = st.opacities()
    pre = preprocess(st.params.xyz, st.scales(), st.rotations(), st.valid,
                     view.world_view, view.full_proj, W, H, view.focal_x,
                     view.focal_y, view.tan_fovx, view.tan_fovy)
    cfg = RasterizeConfig(chunk=CHUNK, backend="cuda", mm_dtype=mm_dtype)
    one = TB.bin_gaussians_bucketed(pre, W, H, cfg, 1, 1 << 14,
                                    opacity=opacity)
    start = one.tile_start.reshape(-1)
    count = one.tile_count.reshape(-1)
    assert torch.equal(start, flat[0]) and torch.equal(count, flat[1])
    n = flat[2].shape[0]
    args = (start, count) + flat[2:]
    a1, t1, k1 = CF.composite_forward(*args)
    a0, t0, k0 = CF.composite_forward(*flat[:8])
    torch.cuda.synchronize()
    assert n == int(one.num_rendered)
    assert torch.equal(t1, t0) and torch.equal(k1, k0)
    assert torch.equal(a1, a0)


@pytest.mark.cuda
def test_bucketed_render_matches_flat_on_card():
    dev = _card()
    st, view = _scene(dev)
    flat = RasterizeConfig(chunk=CHUNK, max_pairs=1 << 14, backend="cuda")
    args = (st.params.xyz, st.sh(), st.params.lang_feat, st.opacities(),
            st.scales(), st.params.rotation, st.valid, view,
            torch.zeros(3, device=dev), 3)
    outs = [rasterize(*args, cfg=c) for c in
            (flat, dataclasses.replace(flat, n_buckets=B, bucket_cap=CAP))]
    torch.cuda.synchronize()
    for name in ("color", "depth", "final_t"):
        _close(getattr(outs[1], name), getattr(outs[0], name), 3e-5, 1e-3,
               name)
    _close(outs[1].lang_feat, outs[0].lang_feat, 2e-4, 1e-3, "lf")
    assert int(outs[1].overflow_pairs) == 0
