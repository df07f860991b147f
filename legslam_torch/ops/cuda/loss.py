"""The mapping step's training loss and its gradient in two kernel passes:
L1 and SSIM of the colour, the LF cosine and the depth L1.

Replaces no TPU kernel: the JAX package writes the loss as jnp code
(legslam_tpu/ops/losses.py), which XLA fuses with its gradient into a few
loops, while the port's plain version, ops/losses.mapping_loss_plain, ran
eagerly at ~57 forward and ~80 autograd launches a mapping iteration,
whose host time paced the step (PERF.md section 5). The kernels are CUDA
C++ for sm_90a (legslam_torch/csrc/loss.cu): the forward computes the four
terms in float32 with the plain version's window, constants and means,
keeps the SSIM map's and the cosine's derivatives for the backward, and
sums the blocks' partials in a fixed order (two launches); the backward
blurs the SSIM derivatives back and writes dL/dcolour, dL/dLF and
dL/ddepth (one launch). Bound: bytes, ~0.45 GB read forward at 1200x680
with 64 LF channels, the two LF images leading.

`mapping_loss_cuda` is reached only through ops/losses.mapping_loss, which
takes it for CUDA tensors and the plain version for CPU tensors; it raises
for other devices and for operands the kernels do not take
(`check_operands`). `mapping_loss_cuda.launches` counts its kernel
launches: two a forward, one a backward. `loss_grads_plain` is the
kernels' arithmetic in plain PyTorch (the same saved derivatives, the
blur written out), held against autograd of the plain version in the CPU
tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from legslam_torch.config import SSIM_C1, SSIM_C2, SSIM_SIGMA, SSIM_WINDOW

TILE_W, TILE_H = 32, 8        # csrc/loss.cu kTileW, kTileH
N_SUMS = 4                    # colour L1, SSIM, cosine, depth L1
LF_EPS = 1e-8                 # the cosine's norm clamp (losses.py)


class _View(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("rs", ctypes.c_longlong),
                ("ps", ctypes.c_longlong), ("cs", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """csrc/loss.cu's LossArgs, field for field."""
    _fields_ = [
        *((n, _View) for n in ("color", "gt_color", "lf", "gt_lf", "depth",
                               "gt_depth", "mask", "dcolor", "dlf",
                               "ddepth")),
        ("saved", ctypes.c_void_p), ("partials", ctypes.c_void_p),
        ("loss", ctypes.c_void_p), ("gout", ctypes.c_void_p),
        ("h", ctypes.c_int), ("w", ctypes.c_int), ("nlf", ctypes.c_int),
        ("blocks", ctypes.c_int),
        ("lam", ctypes.c_float), ("c1", ctypes.c_float),
        ("c2", ctypes.c_float), ("eps2", ctypes.c_float),
        ("taps", ctypes.c_float * SSIM_WINDOW)]


@functools.lru_cache(maxsize=1)
def _taps() -> tuple[float, ...]:
    """The window's 11 float32 taps, as ops/losses.py blurs with them."""
    from legslam_torch.ops.losses import _gaussian_window
    return tuple(float(x) for x in _gaussian_window(SSIM_WINDOW, SSIM_SIGMA))


def _view(x: torch.Tensor | None) -> _View:
    """An [H, W, C] or [H, W] (or [H, W, 1]) tensor as (pointer, row,
    pixel and channel strides in elements); None as a null view."""
    if x is None:
        return _View(None, 0, 0, 0)
    cs = x.stride(2) if x.dim() == 3 else 0
    return _View(x.data_ptr(), x.stride(0), x.stride(1), cs)


def check_operands(render_color, gt_color, render_lf, gt_lf, render_depth,
                   gt_depth, mask) -> int:
    """Raise for what the kernels do not take; return the LF channels, 0
    when the LF term is left out. They take float32 colours [H, W, 3],
    LF images [H, W, C] of one shape, depths [H, W] and a mask [H, W] or
    [H, W, 1], all on one device, with any row and pixel strides (the
    compositor's LF and depth are channel views of its [H, W, 3 + C + 1]
    image); a 3-D operand needs a unit stride on its channel axis or on
    its pixel axis (the upsampled LF target is channel-planar), since the
    kernels read a pixel's channels, or a channel's pixels, in one run.
    The kernels give no gradient to the targets or the mask."""
    if render_color.dim() != 3 or render_color.shape[-1] != 3:
        raise ValueError(f"render_color is {tuple(render_color.shape)}, "
                         "want [H, W, 3]")
    h, w = render_color.shape[:2]
    with_lf = render_lf is not None and gt_lf is not None
    nlf = render_lf.shape[-1] if with_lf else 0
    want = dict(render_color=(h, w, 3), gt_color=(h, w, 3),
                render_depth=(h, w), gt_depth=(h, w),
                mask=(h, w) if mask.dim() == 2 else (h, w, 1))
    if with_lf:
        want.update(render_lf=(h, w, nlf), gt_lf=(h, w, nlf))
    ops = dict(render_color=render_color, gt_color=gt_color,
               render_lf=render_lf, gt_lf=gt_lf, render_depth=render_depth,
               gt_depth=gt_depth, mask=mask)
    dev = render_color.device
    for name, shape in want.items():
        x = ops[name]
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} is {tuple(x.shape)}, want {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, render_color on {dev}")
        if x.dim() == 3 and x.shape[-1] > 1 and 1 not in x.stride()[1:]:
            raise ValueError(f"{name} has strides {x.stride()}: the kernels "
                             "want a unit stride on its channel or pixel "
                             "axis")
        if not name.startswith("render_") and x.requires_grad:
            raise ValueError(f"{name} requires grad: the kernels give no "
                             "gradient to the targets or the mask")
    return nlf


class _MappingLoss(torch.autograd.Function):
    """The loss, differentiable in the rendered colour, LF and depth."""

    @staticmethod
    def forward(ctx, color, lf, depth, gt_color, gt_lf, gt_depth, mask,
                lam: float):
        h, w = color.shape[:2]
        nlf = 0 if lf is None else lf.shape[-1]
        dev = color.device
        blocks = _blocks(h, w, nlf)
        saved = torch.empty((11 if nlf else 9, h, w), device=dev)
        partials = torch.empty((blocks, N_SUMS), device=dev)
        loss = torch.empty((), device=dev)
        a = _args(color, lf, depth, gt_color, gt_lf, gt_depth, mask, lam,
                  nlf, saved, blocks)
        a.partials, a.loss = partials.data_ptr(), loss.data_ptr()
        _launch("forward", a, dev, 2)
        ctx.save_for_backward(color, lf, depth, gt_color, gt_lf, gt_depth,
                              mask, saved)
        ctx.lam, ctx.nlf = lam, nlf
        return loss

    @staticmethod
    def backward(ctx, g):
        color, lf, depth, gt_color, gt_lf, gt_depth, mask, saved = \
            ctx.saved_tensors
        need = ctx.needs_input_grad
        h, w = color.shape[:2]
        dev = color.device
        dcolor = torch.empty((h, w, 3), device=dev) if need[0] else None
        dlf = torch.empty((h, w, ctx.nlf), device=dev) \
            if need[1] and ctx.nlf else None
        ddepth = torch.empty((h, w), device=dev) if need[2] else None
        if dcolor is None and dlf is None and ddepth is None:
            return (None,) * 8
        g = g.to(device=dev, dtype=torch.float32).contiguous()
        a = _args(color, lf, depth, gt_color, gt_lf, gt_depth, mask,
                  ctx.lam, ctx.nlf, saved, _blocks(h, w, ctx.nlf))
        a.dcolor, a.dlf, a.ddepth = _view(dcolor), _view(dlf), _view(ddepth)
        a.gout = g.data_ptr()
        _launch("backward", a, dev, 1)
        return dcolor, dlf, ddepth, None, None, None, None, None


def mapping_loss_cuda(render_color, gt_color, render_lf, gt_lf,
                      render_depth, gt_depth, mask,
                      lambda_dssim: float) -> torch.Tensor:
    """ops/losses.mapping_loss on CUDA tensors: the 0-dim loss, whose
    backward is the kernels'. `render_lf` or `gt_lf` None leaves the LF
    term out. Raises for another device and for operands the kernels do
    not take (check_operands)."""
    dev = render_color.device
    if dev.type != "cuda":
        raise ValueError(f"no loss kernel for device {dev}")
    nlf = check_operands(render_color, gt_color, render_lf, gt_lf,
                         render_depth, gt_depth, mask)
    lf, glf = (render_lf, gt_lf) if nlf else (None, None)
    return _MappingLoss.apply(render_color, lf, render_depth, gt_color, glf,
                              gt_depth, mask, float(lambda_dssim))


mapping_loss_cuda.launches = 0


def _blocks(h: int, w: int, nlf: int) -> int:
    """The kernels' grid: a block a tile and role, two roles a tile with
    LF (csrc/loss.cu tile_of)."""
    return -(-w // TILE_W) * -(-h // TILE_H) * (2 if nlf else 1)


def _args(color, lf, depth, gt_color, gt_lf, gt_depth, mask, lam, nlf,
          saved, blocks) -> _Args:
    h, w = color.shape[:2]
    return _Args(color=_view(color), gt_color=_view(gt_color),
                 lf=_view(lf), gt_lf=_view(gt_lf), depth=_view(depth),
                 gt_depth=_view(gt_depth), mask=_view(mask),
                 dcolor=_view(None), dlf=_view(None), ddepth=_view(None),
                 saved=saved.data_ptr(), h=h, w=w, nlf=nlf, blocks=blocks,
                 lam=lam, c1=SSIM_C1, c2=SSIM_C2, eps2=LF_EPS * LF_EPS,
                 taps=(ctypes.c_float * SSIM_WINDOW)(*_taps()))


def _launch(which: str, a: _Args, dev, n: int) -> None:
    err = _fn(which)(ctypes.byref(a),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"loss {which} launch failed: error {err}")
    mapping_loss_cuda.launches += n


def _fn(which: str):
    from legslam_torch import _build
    return _build.function("loss", f"legslam_loss_{which}",
                           [ctypes.c_void_p, ctypes.c_void_p])


# --- the kernels' arithmetic in plain PyTorch --------------------------------

def _blur(x: torch.Tensor) -> torch.Tensor:
    """The 11-tap window of sigma 1.5 along W, then H, zero padded, over
    the leading [H, W] of x [H, W, ...] (the kernels' order: rows, then
    columns)."""
    taps = _taps()
    r = SSIM_WINDOW // 2
    h, w = x.shape[:2]
    pad = [0, 0] * (x.dim() - 2)
    xp = F.pad(x, pad + [r, r])
    acc = torch.zeros_like(x)
    for k, t in enumerate(taps):
        acc = acc + t * xp[:, k:k + w]
    xp = F.pad(acc, pad + [0, 0, r, r])
    out = torch.zeros_like(x)
    for k, t in enumerate(taps):
        out = out + t * xp[k:k + h]
    return out


def loss_grads_plain(render_color, gt_color, render_lf, gt_lf,
                     render_depth, gt_depth, mask, lambda_dssim: float,
                     gout: float = 1.0):
    """The kernels' arithmetic written out: (loss, dL/dcolour, dL/dLF or
    None, dL/ddepth) times `gout`. The SSIM map's derivatives with respect
    to the blurred mean, E[x^2] and E[xy] are blurred back (the window is
    symmetric and zero padded, so the transpose is the same blur); abs's
    gradient is sgn (0 at 0); the cosine's norm clamp passes the gradient
    where its input is at or above eps^2; the mask multiplies the rendered
    side only."""
    m = mask if mask.dim() == 2 else mask[..., 0]
    h, w = m.shape
    n = h * w
    lam = float(lambda_dssim)
    x = render_color * m[..., None]
    y = gt_color
    mu1, mu2 = _blur(x), _blur(y)
    e11, e22, e12 = _blur(x * x), _blur(y * y), _blur(x * y)
    mu1mu2 = mu1 * mu2
    sig1, sig2 = e11 - mu1 * mu1, e22 - mu2 * mu2
    sig12 = e12 - mu1mu2
    a1, a2 = 2 * mu1mu2 + SSIM_C1, 2 * sig12 + SSIM_C2
    b1, b2 = mu1 * mu1 + mu2 * mu2 + SSIM_C1, sig1 + sig2 + SSIM_C2
    d = 1.0 / (b1 * b2)
    s = (a1 * a2) * d
    g11, g12 = -s / b2, 2 * a1 * d
    gmu = 2 * mu2 * a2 * d - 2 * mu1 * s / b1 - 2 * mu1 * g11 - mu2 * g12
    k_px = gout / n
    k_l1 = k_px * (1.0 - lam) / 3.0
    k_ssim = -k_px * lam / 3.0
    dx = k_ssim * (_blur(gmu) + 2 * x * _blur(g11) + y * _blur(g12)) + \
        k_l1 * torch.sign(x - y)
    dcolor = dx * m[..., None]
    loss = (1.0 - lam) * torch.abs(x - y).sum() / (3 * n) + \
        lam * (1.0 - s.sum() / (3 * n))
    dlf = None
    if render_lf is not None and gt_lf is not None:
        dot = torch.sum(render_lf * gt_lf, -1)
        q1 = torch.sum(render_lf * render_lf, -1) * (m * m)
        q2 = torch.sum(gt_lf * gt_lf, -1)
        eps2 = LF_EPS * LF_EPS
        nn1 = torch.sqrt(torch.clamp_min(q1, eps2))
        nn2 = torch.sqrt(torch.clamp_min(q2, eps2))
        p = nn1 * nn2
        dm = dot * m
        u = m / p
        v = torch.where(q1 >= eps2, (dm / (p * p)) * nn2 / nn1 * (m * m),
                        0.0)
        dlf = k_px * (u[..., None] * gt_lf - v[..., None] * render_lf)
        loss = loss + (dm / p).sum() / n
    z = render_depth * m - gt_depth
    loss = loss + torch.abs(z).sum() / n
    ddepth = k_px * torch.sign(z) * m
    return loss * gout, dcolor, dlf, ddepth
