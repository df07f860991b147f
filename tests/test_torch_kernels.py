"""The compositing and sort kernels' wrappers, without JAX, so this file
also runs on a machine with a card (the JAX conftest skipped):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

* anywhere: the wrappers run their plain versions for CPU tensors and
  count no launch; the build raises without nvcc; the sort wrappers
  take any length, plan their digit passes, and refuse what the kernel
  does not take;
* on a card (marker `cuda`, skipped without one): each compositing kernel
  against its plain version on the pair arrays of a small seeded scene,
  in float32 and bfloat16 features. Tolerances: acc and t_final atol 2e-4
  / rtol 1e-3 (the JAX suite's forward tolerance, LF channels' atol for
  all), kfin equal; dgeo and dfeats atol 2e-4 / rtol 2e-2 (its gradient
  tolerance), with cotangents sized like a mean loss's; and both on a
  scene of hand-placed pairs at the kernels' edges (_edge_pairs). The
  radix sort kernels against their plain versions bit for bit: keys with
  ties, all equal, 97% one value, INT32_MIN / INT32_MAX, key_bits < 32,
  all-invalid depths, lengths below, at and above one tile (2048
  elements below 2^19, 4096 below 2^21, then 8192) and not powers of
  two, and the argsort mode against torch.sort(stable).
"""
import numpy as np
import pytest
import torch

from legslam_torch.config import RasterizeConfig
from legslam_torch.models import gaussians as G
from legslam_torch.ops.cuda import composite as CF
from legslam_torch.ops.cuda import composite_bwd as CB
from legslam_torch.ops.cuda import sort as CS
from legslam_torch.ops.projection import preprocess
from legslam_torch.ops.rasterize import compute_binning
from legslam_torch.utils.camera import CameraView
from legslam_torch.utils.sh import sh_to_color

torch.set_num_threads(1)

W, H, CHUNK = 160, 96, 64


def _pair_args(device, mm_dtype, seed=0, with_lf=True):
    """(forward args, backward args) of a seeded 600-gaussian scene, with
    the 64 language-feature channels (72 padded) or without (8 padded)."""
    rng = np.random.default_rng(seed)
    n, cap = 600, 1024
    pts = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 2.5
    st = G.create_from_pcd(pts, rng.uniform(size=(n, 3)), cap,
                           lang_feat=rng.normal(size=(n, 64)), device=device)
    op = rng.uniform(0.5, 0.99, size=cap).astype(np.float32)
    st.params.opacity.copy_(torch.as_tensor(np.log(op / (1 - op))[:, None]))
    view = CameraView.create(np.eye(3), np.zeros(3), W, H, fx=120.0,
                             fy=120.0, device=device)
    cfg = RasterizeConfig(chunk=CHUNK, max_pairs=1 << 14, backend="cuda",
                          mm_dtype=mm_dtype)
    opacity = st.opacities()
    binning, _ = compute_binning(
        st.params.xyz, st.scales(), st.params.rotation, st.valid,
        view.world_view, view.full_proj, view.tan_fovx, view.tan_fovy, W, H,
        cfg, opacity=opacity)
    pre = preprocess(st.params.xyz, st.scales(), st.rotations(), st.valid,
                     view.world_view, view.full_proj, W, H, view.focal_x,
                     view.focal_y, view.tan_fovx, view.tan_fovy)
    lf = [st.params.lang_feat] if with_lf else []
    feats = torch.cat([sh_to_color(0, st.sh(), st.params.xyz,
                                   view.cam_center), *lf,
                       pre.depth[:, None]], dim=1)
    start, count, geo, pf = CF.prepare_pairs(
        binning, pre.mean2d, pre.conic, opacity, feats, cfg.max_pairs,
        mm_dtype)
    fa = (start, count, geo, pf, 128, 16, -(-W // 128), CHUNK)
    ntiles, npix = start.shape[0], 128 * 16
    g = torch.Generator(device=device).manual_seed(seed)
    gout = torch.randn(ntiles, npix, pf.shape[1], generator=g,
                       device=device) / W
    gt = torch.randn(ntiles, npix, generator=g, device=device) / W
    return fa, gout, gt


def _assert_close(a, b, atol, rtol, name):
    np.testing.assert_allclose(a.detach().cpu().numpy(),
                               b.detach().cpu().numpy(), atol=atol,
                               rtol=rtol, err_msg=name)


@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_wrappers_run_plain_versions_on_cpu(mm_dtype):
    fa, gout, gt = _pair_args("cpu", mm_dtype)
    launches = (CF.composite_forward.launches,
                CB.composite_backward.launches)
    acc, tfin, kfin = CF.composite_forward(*fa)
    acc_p, tfin_p, kfin_p = CF.composite_forward_plain(*fa)
    assert torch.equal(acc, acc_p) and torch.equal(tfin, tfin_p)
    assert torch.equal(kfin, kfin_p) and int(kfin.max()) > 0
    ba = fa[:4] + (gout, gt, tfin, acc) + fa[4:]
    dgeo, dfe = CB.composite_backward(*ba)
    dgeo_p, dfe_p = CB.composite_backward_plain(*ba)
    assert torch.equal(dgeo, dgeo_p) and torch.equal(dfe, dfe_p)
    assert dgeo.abs().max() > 0
    assert (CF.composite_forward.launches,
            CB.composite_backward.launches) == launches


def test_kernel_build_needs_nvcc(monkeypatch):
    """The kernels build only with the CUDA toolkit; without nvcc the
    build raises instead of falling back (legslam_torch/_build.py)."""
    import os
    import shutil

    from legslam_torch import _build
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["composite_fwd"])


@pytest.mark.cuda
@pytest.mark.parametrize("with_lf", [True, False])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(mm_dtype, with_lf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    fa, gout, gt = _pair_args("cuda", mm_dtype, with_lf=with_lf)
    assert fa[3].shape[1] == (72 if with_lf else 8)
    launches = CF.composite_forward.launches
    acc, tfin, kfin = CF.composite_forward(*fa)
    torch.cuda.synchronize()
    assert CF.composite_forward.launches == launches + 1
    acc_p, tfin_p, kfin_p = CF.composite_forward_plain(*fa)
    _assert_close(acc, acc_p, 2e-4, 1e-3, "acc")
    _assert_close(tfin, tfin_p, 2e-4, 1e-3, "t_final")
    assert torch.equal(kfin, kfin_p)
    ba = fa[:4] + (gout, gt, tfin_p, acc_p) + fa[4:]
    dgeo, dfe = CB.composite_backward(*ba)
    torch.cuda.synchronize()
    dgeo_p, dfe_p = CB.composite_backward_plain(*ba)
    _assert_close(dgeo, dgeo_p, 2e-4, 2e-2, "dgeo")
    _assert_close(dfe, dfe_p, 2e-4, 2e-2, "dfeats")


# --- the compositing kernels' edges ----------------------------------------

def _edge_pairs(device, mm_dtype, nch):
    """Backward arguments of hand-placed pairs on a 160x48 image (tiles
    16x128: 2 columns, the second ragged, x 128..255 past the image's
    160, and 3 rows), and the pair rows whose gradient must be exactly 0;
    the forward's arguments are ba[:4] + ba[8:]:
      tile 0: 87 pairs (the backward's 5 batches of 16 and a ragged 7,
        the forward's 2 of 32 and a ragged 23), among them one far
        outside the tile (composited by no pixel) and one 0.7 px wide on
        rows 0-1 (composited in the first block of 256 pixels only);
      tile 1: 40 pairs around the image's right edge;
      tiles 2 and 5: no pairs;
      tile 3: 20 pairs of opacity 0.93 as wide as the tile: every pixel
        terminates on the 4th pair, mid-batch, so pairs 3.. get nothing;
      tile 4: 16 pairs, one whole batch."""
    rng = np.random.default_rng(7)
    tile_w, tile_h, ntx = 128, 16, 2

    def pairs(n, x0, x1, y0, y1, sigma, op):
        s = rng.uniform(*sigma, size=n)
        rho = rng.uniform(-0.3, 0.3, size=n)
        geo = np.zeros((n, 8), np.float32)
        geo[:, 0] = rng.uniform(x0, x1, size=n)
        geo[:, 1] = rng.uniform(y0, y1, size=n)
        geo[:, 2] = 1.0 / s ** 2
        geo[:, 3] = rho / s ** 2
        geo[:, 4] = 1.0 / s ** 2
        geo[:, 5] = rng.uniform(*op, size=n)
        return geo

    t0 = pairs(87, -10, 138, -4, 20, (1.5, 20.0), (0.05, 0.6))
    t0[40, :6] = (-500.0, -500.0, 0.5, 0.0, 0.5, 0.9)   # no pixel
    t0[41, :6] = (37.0, 0.5, 2.0, 0.0, 2.0, 0.9)        # first block only
    t1 = pairs(40, 120, 170, -2, 18, (1.0, 12.0), (0.1, 0.8))
    t3 = pairs(20, 180, 200, 20, 28, (1.0, 1.0), (0.93, 0.93))
    t3[:, 2:5] = (1e-6, 0.0, 1e-6)
    t4 = pairs(16, 0, 128, 32, 48, (2.0, 8.0), (0.2, 0.7))
    geo = np.concatenate([t0, t1, t3, t4])
    counts = [87, 40, 0, 20, 16, 0]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    zero_rows = [40] + [87 + 40 + i for i in range(3, 20)]
    n = geo.shape[0]
    feats = rng.normal(size=(n, nch)).astype(np.float32)
    start = torch.as_tensor(starts.astype(np.int32), device=device)
    count = torch.as_tensor(np.asarray(counts, np.int32), device=device)
    geo_t = torch.as_tensor(geo, device=device)
    feats_t = torch.as_tensor(feats, device=device).to(
        torch.bfloat16 if mm_dtype == "bfloat16" else torch.float32)
    fa = (start, count, geo_t, feats_t, tile_w, tile_h, ntx, CHUNK)
    acc, tfin, _ = CF.composite_forward_plain(*fa)
    ntiles, npix = len(counts), tile_w * tile_h
    gout = torch.as_tensor(rng.normal(size=(ntiles, npix, nch)).astype(
        np.float32), device=device) / W
    gt = torch.as_tensor(rng.normal(size=(ntiles, npix)).astype(np.float32),
                         device=device) / W
    return fa[:4] + (gout, gt, tfin, acc) + fa[4:], zero_rows


@pytest.mark.parametrize("nch", [72, 8])
def test_edge_pairs_plain_gradients_on_cpu(nch):
    """The edge scene as the plain version sees it: exactly 0 on the pairs
    no pixel composites, a gradient on (nearly) all others."""
    ba, zero_rows = _edge_pairs("cpu", "float32", nch)
    dgeo, dfe = CB.composite_backward(*ba)
    live = torch.ones(dgeo.shape[0], dtype=torch.bool)
    live[zero_rows] = False
    assert torch.all(dgeo[~live] == 0) and torch.all(dfe[~live] == 0)
    assert float((dgeo[live].abs().amax(1) > 0).float().mean()) > 0.9
    assert float((dfe[live].abs().amax(1) > 0).float().mean()) > 0.9
    # the opaque tile ends dark: three pairs composited everywhere
    assert float(ba[6][3].max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [72, 8])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_backward_kernel_edges_on_card(mm_dtype, nch):
    """The backward kernel against its plain version on the edge scene
    (_edge_pairs) at the gradient tolerance, atol 2e-4 / rtol 2e-2, and
    exactly 0 where no pixel composites a pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ba, zero_rows = _edge_pairs("cuda", mm_dtype, nch)
    launches = CB.composite_backward.launches
    dgeo, dfe = CB.composite_backward(*ba)
    torch.cuda.synchronize()
    assert CB.composite_backward.launches == launches + 1
    dgeo_p, dfe_p = CB.composite_backward_plain(*ba)
    _assert_close(dgeo, dgeo_p, 2e-4, 2e-2, "dgeo")
    _assert_close(dfe, dfe_p, 2e-4, 2e-2, "dfeats")
    assert torch.all(dgeo[zero_rows] == 0) and torch.all(dfe[zero_rows] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [72, 8])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_forward_kernel_edges_on_card(mm_dtype, nch):
    """The forward kernel against its plain version on the edge scene
    (_edge_pairs): acc and t_final atol 2e-4 / rtol 1e-3, kfin equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ba, _ = _edge_pairs("cuda", mm_dtype, nch)
    fa = ba[:4] + ba[8:]
    launches = CF.composite_forward.launches
    acc, tfin, kfin = CF.composite_forward(*fa)
    torch.cuda.synchronize()
    assert CF.composite_forward.launches == launches + 1
    _assert_close(acc, ba[7], 2e-4, 1e-3, "acc")
    _assert_close(tfin, ba[6], 2e-4, 1e-3, "t_final")
    assert torch.equal(kfin, CF.composite_forward_plain(*fa)[2])
    # the empty tiles: background, nothing composited
    assert torch.all(acc[[2, 5]] == 0) and torch.all(tfin[[2, 5]] == 1)


# --- the sort kernels (bit-exact: a sort has one right answer) -----------

def _sort_inputs(n, seed, device):
    """Keys with many ties (drawn from n // 8 values, INT32_MAX sentinels
    among them) and values with ties of their own."""
    rng = np.random.default_rng(seed)
    m = max(n // 8, 1)
    keys = rng.integers(-(1 << 20), 1 << 20, size=m)[
        rng.integers(0, m, size=n)].astype(np.int32)
    keys[rng.uniform(size=n) < 0.1] = CS.INT32_MAX
    vals = rng.integers(0, 16, size=n).astype(np.int32)
    return (torch.as_tensor(keys, device=device),
            torch.as_tensor(vals, device=device))


def test_sort_wrappers_run_plain_versions_on_cpu():
    keys, vals = _sort_inputs(1 << 10, 0, "cpu")
    launches = (CS.sort_keys.launches, CS.sort_kv.launches)
    assert torch.equal(CS.sort_keys(keys), torch.sort(keys).values)
    ok, ov = CS.sort_kv(keys, vals)
    # lexicographic (key, value) order
    want = sorted(zip(keys.tolist(), vals.tolist()))
    assert list(zip(ok.tolist(), ov.tolist())) == want
    depth = torch.rand(300)
    order = CS.argsort_f32(depth, depth > 0.3)
    assert order.shape == (512,)
    nv = int((depth > 0.3).sum())
    assert torch.equal(depth[order[:nv].long()],
                       torch.sort(depth[depth > 0.3]).values)
    assert (CS.sort_keys.launches, CS.sort_kv.launches) == launches


@pytest.mark.parametrize("n", [1, 37, 3000])
def test_sort_wrappers_take_any_length_on_cpu(n):
    """No power-of-two length is needed, and key_bits < 32 is a promise
    about the keys that leaves the order as it is."""
    keys, vals = _sort_inputs(n, n, "cpu")
    small = keys & ((1 << 21) - 1)
    assert torch.equal(CS.sort_keys(small, key_bits=21),
                       torch.sort(small).values)
    ok, ov = CS.sort_kv(keys, vals)
    assert list(zip(ok.tolist(), ov.tolist())) == \
        sorted(zip(keys.tolist(), vals.tolist()))
    order = CS.argsort_order(keys & CS.INT32_MAX)
    assert torch.equal(order.long(),
                       torch.sort(keys & CS.INT32_MAX, stable=True).indices)


@pytest.mark.parametrize("key_bits,with_values,plan", [
    (27, False, (9, 3, 0)),    # the main path's pair keys
    (24, False, (8, 3, 0)),    # the mapper's at its first rung
    (31, False, (8, 4, 0)),    # argsort_f32
    (32, False, (8, 4, 0)),
    (32, True, (8, 4, 4)),     # sort_kv: the value's passes, then the key's
    (1, False, (8, 1, 0)),
])
def test_radix_plan(key_bits, with_values, plan):
    assert CS.radix_plan(key_bits, with_values) == plan
    assert CS.launches_per_call(key_bits, with_values) == \
        1 + plan[1] + plan[2]


@pytest.mark.parametrize("bad", ["ndim", "dtype", "stride", "values",
                                 "key_bits"])
def test_sort_wrappers_refuse_bad_input(bad):
    keys = torch.arange(16, dtype=torch.int32)
    vals = keys.clone()
    if bad == "key_bits":
        for key_bits in (0, 33):
            with pytest.raises(ValueError):
                CS.sort_keys(keys, key_bits=key_bits)
        return
    if bad == "ndim":
        keys, vals = keys.reshape(4, 4), vals.reshape(4, 4)
    elif bad == "dtype":
        keys = keys.long()
    elif bad == "stride":
        keys = torch.arange(32, dtype=torch.int32)[::2]
    else:
        vals = vals[:8]
    with pytest.raises((TypeError, ValueError)):
        CS.sort_kv(keys, vals)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 3000, 1 << 8, 1 << 12, 1 << 13,
                               1 << 16, (1 << 16) + 5, (1 << 19) + 7,
                               (1 << 21) + 3])
def test_sort_kernels_match_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    keys, vals = _sort_inputs(n, n, "cuda")
    launches = (CS.sort_keys.launches, CS.sort_kv.launches)
    out = CS.sort_keys(keys)
    ok, ov = CS.sort_kv(keys, vals)
    torch.cuda.synchronize()
    assert (CS.sort_keys.launches, CS.sort_kv.launches) == \
        (launches[0] + 1, launches[1] + 1)
    assert torch.equal(out, CS.sort_keys_plain(keys))
    pk, pv = CS.sort_kv_plain(keys, vals)
    assert torch.equal(ok, pk) and torch.equal(ov, pv)
    # with iota values the kv order is the stable order
    iota = torch.arange(n, dtype=torch.int32, device="cuda")
    _, order = CS.sort_kv(keys, iota)
    assert torch.equal(order.long(), torch.sort(keys, stable=True).indices)
    # and so is the argsort mode's (the key's passes only)
    bits = keys & CS.INT32_MAX
    assert torch.equal(CS.argsort_order(bits).long(),
                       torch.sort(bits, stable=True).indices)


def _edge_keys(case, n, rng):
    """(keys, key_bits) where an LSD radix sort can go wrong."""
    if case == "extremes":
        k = rng.integers(-2 ** 31, 2 ** 31, size=n)
        k[rng.uniform(size=n) < 0.05] = -2 ** 31
        k[rng.uniform(size=n) < 0.05] = 2 ** 31 - 1
        k[::97], k[1::97] = 0, -1
        return k, 32
    if case == "all_equal":
        return np.full(n, -12345), 32
    if case == "skew97":        # binning's buffer: ~97% one sentinel
        k = rng.integers(0, 430 << 18, size=n)
        k[rng.uniform(size=n) < 0.97] = 430 << 18
        return k, (430 << 18).bit_length()
    if case == "sentinel_runs":  # its layout: pairs first, then long runs
        k = np.full(n, 430 << 18)  # of the sentinel with a few pairs
        k[:n // 3] = rng.integers(0, 430 << 18, size=n // 3)
        few = rng.integers(n - 1000, n, size=3)    # whole tiles of one
        k[few] = rng.integers(0, 430 << 18, size=3)  # digit before them
        return k, (430 << 18).bit_length()
    bits = int(case.split("_")[-1])   # key_bits_<b>
    return rng.integers(0, 1 << bits, size=n), bits


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["extremes", "all_equal", "skew97",
                                  "sentinel_runs", "key_bits_5",
                                  "key_bits_13", "key_bits_17",
                                  "key_bits_24"])
def test_radix_sort_edge_cases_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(11)
    n = 3 * 4096 + 77               # six tiles and a ragged one
    k, key_bits = _edge_keys(case, n, rng)
    keys = torch.as_tensor(k.astype(np.int32), device="cuda")
    vals = torch.as_tensor(rng.integers(-3, 3, size=n).astype(np.int32),
                           device="cuda")
    out = CS.sort_keys(keys, key_bits=key_bits)
    ok, ov = CS.sort_kv(keys, vals)
    bits = keys & CS.INT32_MAX
    order = CS.argsort_order(bits)
    torch.cuda.synchronize()
    assert torch.equal(out, CS.sort_keys_plain(keys))
    pk, pv = CS.sort_kv_plain(keys, vals)
    assert torch.equal(ok, pk) and torch.equal(ov, pv)
    assert torch.equal(order.long(), torch.sort(bits, stable=True).indices)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "all_invalid", "distinct"])
def test_argsort_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(3)
    n = 5000
    depth = torch.rand(n, generator=g, device="cuda") * 8.0
    if case == "ties":
        depth = torch.round(depth * 4.0) / 4.0
    valid = torch.rand(n, generator=g, device="cuda") > (
        1.1 if case == "all_invalid" else 0.2)
    order = CS.argsort_f32(depth, valid)
    torch.cuda.synchronize()
    bits = CS.argsort_bits(depth, valid)
    iota = torch.arange(bits.shape[0], dtype=torch.int32, device="cuda")
    assert torch.equal(order, CS.sort_kv_plain(bits, iota)[1])
    key = torch.where(valid, depth, float("inf"))
    assert torch.equal(order[:n].long(), torch.argsort(key, stable=True))
