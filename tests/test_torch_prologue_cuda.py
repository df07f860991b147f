"""The prologue kernel pair (legslam_torch/csrc/prologue.cu) on a card,
against its plain twin on the same card, without JAX:

    python -m pytest --noconftest tests/test_torch_prologue_cuda.py -q

Marker `cuda`; every test skips without a card. The CPU half (the plain
twin against legslam_tpu and autograd) is tests/test_torch_prologue_fused.py.

* The kernels against the plain versions at 1200x680 on a 48k-gaussian
  store of 65536 rows, for SH degrees 0-3, a precomputed colour, LF on and
  off, stop_depth_grad both ways, a scale modifier and a slab prefix:
  radius, mask and depth bit for bit (binning sorts on depth); mean2d atol
  1e-4 / rtol 1e-5, conic and the features atol 1e-5 / rtol 1e-5
  (tests/test_torch_prologue.py's); every gradient atol 1e-5 x the plain
  version's largest of the input / rtol 1e-4: both evaluate the same
  float32 formulas, in other orders and with fused multiply-adds in the
  kernel, and the quaternion normalisations' backward, g r - r^3 (g . v) v,
  subtracts terms larger than its result, so at 48k rows a few elements
  lie ~7e-6 of the largest apart (the CPU file holds the plain version to
  JAX at 1e-6 on 300 rows).
* compute_binning and one train_step (bf16 pair features, a slab prefix)
  through the kernels against the same calls with the plain versions
  patched in: every binning field equal; the step's loss within 2e-4
  relative, its colour within 4.5e-3, each parameter group's gradient
  norm within 1.2e-2 of the plain one's, relative to the larger of its
  norm and the median group's (legs_bench/limits' step limits; the
  compositing backward adds with float atomics in no fixed order); and
  the launch counters: one forward a render and a fresh binning, one
  backward a step.
"""
import statistics

import numpy as np
import pytest
import torch

from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.mapper import train_step as TS
from legslam_torch.models import gaussians as G
from legslam_torch.ops.cuda import prologue as PR
from legslam_torch.ops.rasterize import compute_binning
from legslam_torch.utils.camera import CameraView

W, H = 1200, 680
CAP, N_LIVE, LF = 65536, 48000, 64

# (name, SH degree or None for colors_precomp, LF, stop_depth_grad,
#  scale_modifier, slab rows)
CASES = [
    ("deg0", 0, True, True, 1.0, None),
    ("deg1_depth_grad", 1, True, False, 1.0, None),
    ("deg2_no_lf", 2, False, True, 1.0, None),
    ("deg3", 3, True, True, 1.0, None),
    ("deg3_modifier_depth_grad", 3, True, False, 0.7, None),
    ("colors_precomp", None, True, False, 1.0, None),
    ("colors_precomp_no_lf", None, False, True, 1.3, None),
    ("deg3_slab_prefix", 3, True, True, 1.0, 49152),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _view(dev):
    a = np.deg2rad(8.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    return CameraView.create(R, np.asarray([0.1, -0.05, 0.3], np.float32),
                             W, H, fx=600.0, fy=600.0, device=dev)


def _scene(dev, seed):
    """Live rows (the first 64 behind the camera, row 64 a zero
    quaternion), zero padded rows after them, as the store keeps them."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(CAP, 3)) * [2.0, 1.2, 1.5] + [0, 0, 4.5]
    xyz[:64, 2] = rng.uniform(-2.0, -0.8, size=64)
    d = dict(xyz=xyz,
             scales=np.exp(rng.uniform(-4.5, -1.5, size=(CAP, 3))),
             quats=rng.normal(size=(CAP, 4)),
             sh=rng.normal(size=(CAP, 16, 3)) * 0.3,
             colors=rng.uniform(-0.2, 1.0, size=(CAP, 3)),
             lang_feat=rng.normal(size=(CAP, LF)),
             offset=np.zeros((CAP, 2)))
    d["sh"][:, 0] += 0.4
    d["quats"][64] = 0.0
    for v in d.values():
        v[N_LIVE:] = 0.0
    out = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
           for k, v in d.items()}
    out["valid"] = torch.arange(CAP, device=dev) < N_LIVE
    return out


def _close(a, b, atol, rtol, what):
    err = (a - b).abs()
    bad = err > atol + rtol * b.abs()
    assert not bad.any(), (f"{what}: {int(bad.sum())} elements off, max "
                           f"|err| {float(err.max()):.3g}")


def _call(fwd, bwd, s, view, case, g):
    """(forward outputs, gradients) of one case through the given
    forward and backward."""
    _, deg, lf, stop, smod, rows = case
    pview = PR.View(view.world_view, view.full_proj, view.cam_center, W, H,
                    view.focal_x, view.focal_y, view.tan_fovx,
                    view.tan_fovy, smod)
    rows = CAP if rows is None else rows
    sh = s["sh"] if deg is not None else None
    colors = s["colors"] if deg is None else None
    lang_feat = s["lang_feat"] if lf else None
    pre, feats = fwd(s["xyz"], s["scales"], s["quats"], s["valid"], pview,
                     rows, sh, colors, lang_feat, s["offset"], deg or 0)
    gfeats = g["feats"][:, :feats.shape[1]]
    grads = bwd(s["xyz"], s["scales"], s["quats"], sh, pview, rows,
                g["mean2d"], g["conic"], gfeats, deg or 0, stop, True)
    return (*pre, feats), grads


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernels_match_plain(case):
    dev = _card()
    seed = [c[0] for c in CASES].index(case[0])
    s = _scene(dev, seed)
    view = _view(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = dict(mean2d=torch.randn(CAP, 2, generator=gen, device=dev) * 0.1,
             conic=torch.randn(CAP, 3, generator=gen, device=dev) * 0.01,
             feats=torch.randn(CAP, 3 + LF + 1, generator=gen, device=dev))
    g["conic"][64] = 0.0      # the zero quaternion's 1e12-scaled gradient
    rows = case[5] or CAP
    for v in g.values():
        v[rows:] = 0.0
    launches = (PR.prologue_forward.launches, PR.prologue_backward.launches)
    out_k, grads_k = _call(PR.prologue_forward, PR.prologue_backward, s,
                           view, case, g)
    torch.cuda.synchronize()
    assert (PR.prologue_forward.launches - launches[0],
            PR.prologue_backward.launches - launches[1]) == (1, 1)
    out_p, grads_p = _call(PR.prologue_forward_plain,
                           PR.prologue_backward_plain, s, view, case, g)
    names = ("mean2d", "conic", "depth", "radius", "mask", "feats")
    for name, k, p in zip(names, out_k, out_p):
        if name in ("depth", "radius", "mask"):
            assert torch.equal(k, p), f"{name} differs"
        else:
            _close(k, p, 1e-4 if name == "mean2d" else 1e-5, 1e-5, name)
    mask = out_k[4]
    assert not mask[:64].any() and mask.sum() > N_LIVE // 2
    for name, k, p in zip(("xyz", "scales", "quats", "sh", "offset"),
                          grads_k, grads_p):
        if p is None:
            assert k is None, name
            continue
        assert torch.isfinite(k).all(), f"d {name} not finite"
        _close(k, p, 1e-5 * float(p.abs().max()), 1e-4, "d " + name)
        assert not k[rows:].any(), f"d {name} past the prefix"


def _store(dev, n=6000, cap=8192, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.9).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 2.5
    st = G.create_from_pcd(pts, rng.uniform(size=(n, 3)), cap,
                           lang_feat=rng.normal(size=(n, LF)), device=dev)
    q = rng.normal(size=(cap, 4)).astype(np.float32)
    st.params.rotation.copy_(torch.as_tensor(q))
    st.params.f_rest.copy_(torch.as_tensor(
        rng.normal(size=tuple(st.params.f_rest.shape)) * 0.1))
    op = rng.uniform(0.3, 0.95, size=cap)
    st.params.opacity.copy_(torch.as_tensor(np.log(op / (1 - op))[:, None]))
    return st


def _step(st, view, gt, cfg, grads: dict):
    """A fresh binning and one step of the store; returns (binning,
    aux, the gradients Adam got)."""
    binning = compute_binning(
        st.params.xyz, torch.exp(st.params.scaling), st.params.rotation,
        st.valid, view.world_view, view.full_proj, view.tan_fovx,
        view.tan_fovy, view.width, view.height, cfg,
        opacity=torch.sigmoid(st.params.opacity[:, 0]))
    _, aux = TS.train_step(
        st, view.world_view, view.full_proj, view.cam_center,
        view.tan_fovx, view.tan_fovy, *gt, 0.0, 1.0, width=view.width,
        height=view.height, active_sh_degree=3, opt=OptimizationParams(),
        cfg=cfg, binning=binning)
    return binning, aux, dict(grads)


@pytest.mark.cuda
def test_step_and_binning_through_kernels(monkeypatch):
    dev = _card()
    view = CameraView.create(np.eye(3), np.zeros(3), 320, 192, fx=160.0,
                             fy=160.0, device=dev)
    rng = np.random.default_rng(5)
    gt = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (
        rng.uniform(size=(192, 320, 3)), rng.normal(size=(192, 320, LF)),
        np.full((192, 320), 2.8), np.ones((192, 320)), [0.1, 0.2, 0.3])]
    cfg = RasterizeConfig(backend="cuda", mm_dtype="bfloat16", p_slabs=4,
                          max_pairs=1 << 18)
    grads = {}
    adam = G.adam_update

    def recording(state, g, *a, **k):
        grads.update({n: getattr(g, n).clone() for n in G.GROUPS})
        return adam(state, g, *a, **k)
    monkeypatch.setattr(G, "adam_update", recording)
    st0 = _store(dev)
    launches = (PR.prologue_forward.launches, PR.prologue_backward.launches)
    b_k, aux_k, g_k = _step(G.copy_state(st0), view, gt, cfg, grads)
    torch.cuda.synchronize()
    assert (PR.prologue_forward.launches - launches[0],
            PR.prologue_backward.launches - launches[1]) == (2, 1)
    monkeypatch.setattr(PR, "prologue_forward", PR.prologue_forward_plain)
    monkeypatch.setattr(PR, "prologue_backward", PR.prologue_backward_plain)
    b_p, aux_p, g_p = _step(G.copy_state(st0), view, gt, cfg, grads)

    for name, k, p in zip(b_k[0]._fields, b_k[0], b_p[0]):
        assert torch.equal(k, p), f"binning {name} differs"
    assert torch.equal(b_k[1], b_p[1])
    lk, lp = float(aux_k.loss), float(aux_p.loss)
    assert abs(lk - lp) <= 2e-4 * abs(lp), (lk, lp)
    assert float((aux_k.color - aux_p.color).abs().max()) <= 4.5e-3
    norms = {n: float(g_p[n].norm()) for n in G.GROUPS}
    median = statistics.median(norms.values())
    for n in G.GROUPS:
        if norms[n] < 1e-3 * median:
            continue
        gap = abs(float(g_k[n].norm()) - norms[n]) / max(norms[n], median)
        assert gap <= 1.2e-2, (n, gap)
