"""The loss kernels (legslam_torch/csrc/loss.cu) on a card, against the
plain version on the same card, without JAX:

    python -m pytest --noconftest tests/test_torch_loss_cuda.py -q

Marker `cuda`; every test skips without a card. The host side of the
wrapper (routes, operand checks, the argument block) and the kernels'
arithmetic in plain PyTorch are tested on the CPU in
tests/test_torch_loss_route.py.

ops/losses.mapping_loss takes the kernels for CUDA tensors; the plain
version is mapping_loss_plain (eager ops, autograd) on the same tensors.
The operands are made as the mapping step hands them over: the colour,
LF and depth from one [H, W, 3 + 64 + 1] image (strided channel views),
10% of the pixels empty (LF and depth 0), the LF target upsampled from a
37x37 grid (channel-planar), a mask with an invalid band. At every
pyramid shape of the three loop configurations (Replica 1200x680 and 3
sub-levels, ScanNet 648x484 and 2, EuRoC 752x480 and 2 with its all-zero
depth target), LF on and off, and below the 11-tap window: the loss within
1e-5 relative, and each gradient (colour, LF, depth) within 1e-5 x its
largest value; the loss the same bit for bit from run to run; three
launches a loss and its gradient. One train_step through the kernels
against one with the plain version patched in: the step limits of
legs_bench/limits and at most 4 loss launches.
"""
import statistics

import numpy as np
import pytest
import torch

from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.mapper import train_step as TS
from legslam_torch.models import gaussians as G
from legslam_torch.ops import losses as L
from legslam_torch.ops.cuda import loss as K
from legslam_torch.ops.rasterize import compute_binning
from legslam_torch.utils.camera import CameraView

LF = 64
LAM = 0.2

# (name, height, width, zero depth target)
SHAPES = [
    ("replica_1200x680", 680, 1200, False),
    ("replica_600x340", 340, 600, False),
    ("replica_300x170", 170, 300, False),
    ("replica_150x85", 85, 150, False),
    ("scannet_648x484", 484, 648, False),
    ("scannet_324x242", 242, 324, False),
    ("scannet_162x121", 121, 162, False),
    ("euroc_752x480", 480, 752, True),
    ("euroc_376x240", 240, 376, True),
    ("euroc_188x120", 120, 188, True),
    ("below_window_9x6", 6, 9, False),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(dev, h, w, zero_depth, lf, seed=0):
    """(img, t_final, the loss's seven operands after the colour)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.rand(h, w, 3 + LF + 1, device=dev, generator=g)
    img[..., 3:-1] = torch.randn(h, w, LF, device=dev, generator=g)
    empty = torch.rand(h, w, device=dev, generator=g) < 0.1
    img[empty] = 0.0
    t = torch.where(empty, 1.0, 0.1 * torch.rand(h, w, device=dev,
                                                 generator=g))
    gt_color = torch.rand(h, w, 3, device=dev, generator=g)
    gt_lf = TS.upsample_lf(torch.randn(37, 37, LF, device=dev, generator=g),
                           h, w) if lf else None
    gt_depth = torch.zeros(h, w, device=dev) if zero_depth else \
        3.0 * torch.rand(h, w, device=dev, generator=g)
    mask = torch.ones(h, w, device=dev)
    mask[:, : max(w // 16, 1)] = 0.0
    return img, t, (gt_color, gt_lf, gt_depth, mask)


def _loss_and_grad(fn, img, t, targets, lf):
    """fn's loss over the compositor's views of a leaf copy of img, and
    its gradient with respect to img."""
    leaf = img.detach().clone().requires_grad_(True)
    bg = torch.tensor([0.1, 0.2, 0.3], device=img.device)
    color = leaf[..., :3] + t[..., None] * bg
    gt_color, gt_lf, gt_depth, mask = targets
    loss = fn(color, gt_color, leaf[..., 3:-1] if lf else None, gt_lf,
              leaf[..., -1], gt_depth, mask, LAM)
    (grad,) = torch.autograd.grad(loss, [leaf])
    return loss.detach(), grad


@pytest.mark.cuda
@pytest.mark.parametrize("lf", [True, False], ids=["lf", "no_lf"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernels_match_plain(shape, lf):
    dev = _card()
    _, h, w, zero_depth = shape
    img, t, targets = _operands(dev, h, w, zero_depth, lf)
    n0 = K.mapping_loss_cuda.launches
    lk, gk = _loss_and_grad(L.mapping_loss, img, t, targets, lf)
    torch.cuda.synchronize()
    assert K.mapping_loss_cuda.launches - n0 == 3
    lp, gp = _loss_and_grad(L.mapping_loss_plain, img, t, targets, lf)
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp)), (lk, lp)
    parts = dict(colour=slice(0, 3), depth=slice(-1, None))
    if lf:
        parts["lf"] = slice(3, -1)
    for name, sl in parts.items():
        k, p = gk[..., sl], gp[..., sl]
        assert torch.isfinite(k).all(), name
        err = float((k - p).abs().max())
        assert err <= 1e-5 * float(p.abs().max()), (name, err)
    if not lf:
        assert not gk[..., 3:-1].any()
    if zero_depth:
        z = img[..., -1] * targets[3]
        assert not gk[..., -1][z == 0].any()     # sgn(0) is 0
    again, _ = _loss_and_grad(L.mapping_loss, img, t, targets, lf)
    assert torch.equal(again, lk)


@pytest.mark.cuda
def test_mask_hw1_and_contiguous_operands():
    dev = _card()
    img, t, (gc, glf, gd, m) = _operands(dev, 97, 131, False, True, seed=4)
    color = img[..., :3] + t[..., None]
    ops = (color, gc, img[..., 3:-1].contiguous(), glf.contiguous(),
           img[..., -1].contiguous(), gd)
    a = L.mapping_loss(*ops, m, LAM)
    b = L.mapping_loss(*ops, m[..., None], LAM)
    c = L.mapping_loss_plain(*ops, m, LAM)
    assert torch.equal(a, b)
    assert abs(float(a) - float(c)) <= 1e-5 * abs(float(c))


def _store(dev, n=6000, cap=8192, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.9).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 2.5
    st = G.create_from_pcd(pts, rng.uniform(size=(n, 3)), cap,
                           lang_feat=rng.normal(size=(n, LF)), device=dev)
    op = rng.uniform(0.3, 0.95, size=cap)
    st.params.opacity.copy_(torch.as_tensor(np.log(op / (1 - op))[:, None]))
    return st


@pytest.mark.cuda
def test_step_through_kernels(monkeypatch):
    dev = _card()
    view = CameraView.create(np.eye(3), np.zeros(3), 320, 192, fx=160.0,
                             fy=160.0, device=dev)
    rng = np.random.default_rng(5)
    gt = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (
        rng.uniform(size=(192, 320, 3)), rng.normal(size=(37, 37, LF)),
        np.full((192, 320), 2.8), np.ones((192, 320)), [0.1, 0.2, 0.3])]
    cfg = RasterizeConfig(backend="cuda", mm_dtype="bfloat16",
                          max_pairs=1 << 18)
    grads = {}
    adam = G.adam_update

    def recording(state, g, *a, **k):
        grads.update({n: getattr(g, n).clone() for n in G.GROUPS})
        return adam(state, g, *a, **k)
    monkeypatch.setattr(G, "adam_update", recording)

    def step():
        st = _store(dev)
        binning = compute_binning(
            st.params.xyz, torch.exp(st.params.scaling), st.params.rotation,
            st.valid, view.world_view, view.full_proj, view.tan_fovx,
            view.tan_fovy, view.width, view.height, cfg,
            opacity=torch.sigmoid(st.params.opacity[:, 0]))
        _, aux = TS.train_step(
            st, view.world_view, view.full_proj, view.cam_center,
            view.tan_fovx, view.tan_fovy, *gt, 0.0, 1.0, width=view.width,
            height=view.height, active_sh_degree=3,
            opt=OptimizationParams(), cfg=cfg, binning=binning)
        torch.cuda.synchronize()
        return aux, dict(grads)

    n0 = K.mapping_loss_cuda.launches
    aux_k, g_k = step()
    assert 0 < K.mapping_loss_cuda.launches - n0 <= 4
    monkeypatch.setattr(L, "mapping_loss", L.mapping_loss_plain)
    aux_p, g_p = step()
    lk, lp = float(aux_k.loss), float(aux_p.loss)
    assert abs(lk - lp) <= 2e-4 * abs(lp), (lk, lp)
    norms = {n: float(g_p[n].norm()) for n in G.GROUPS}
    median = statistics.median(norms.values())
    for n in G.GROUPS:
        if norms[n] < 1e-3 * median:
            continue
        gap = abs(float(g_k[n].norm()) - norms[n]) / max(norms[n], median)
        assert gap <= 1.2e-2, (n, gap)
