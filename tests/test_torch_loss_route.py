"""The host side of the loss kernels' wrapper (legslam_torch/ops/cuda/
loss.py) on the CPU; the kernels themselves are held to the plain version
on a card in tests/test_torch_loss_cuda.py.

* CPU tensors take mapping_loss_plain, unchanged, and launch nothing;
  another device raises;
* the operand checks raise for a dtype, a rank or shape, a mask or an LF
  target of another shape, strides with no unit axis, and a target that
  requires grad; the compositor's strided views of one [H, W, 68] image
  and the channel-planar upsampled LF target are taken;
* the argument block matches csrc/loss.cu's LossArgs field for field, and
  the grid its tiles and roles;
* loss_grads_plain, the kernels' arithmetic written out (the blur by
  taps, the SSIM map's derivatives blurred back, the cosine's and the
  depth's terms), against autograd of mapping_loss_plain: an odd size, a
  size below the 11-tap window, a mask with zeros ([H, W] and [H, W, 1]),
  a zero LF render (the norm clamp), a zero depth target and empty pixels
  (sgn(0)), no LF, and the compositor's views.
"""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from legslam_torch.mapper.train_step import upsample_lf
from legslam_torch.ops import losses as L
from legslam_torch.ops.cuda import loss as K

LAM = 0.2
LF = 16


def _inputs(h, w, c=LF, seed=0, mask="zeros", zero_lf=False,
            zero_depth=False, lf=True, views=False):
    """(render_color, gt_color, render_lf, gt_lf, render_depth, gt_depth,
    mask). views: colour, LF and depth as the compositor hands them (the
    colour img[..., :3] + T bg, LF and depth channel views of one
    [H, W, 3 + C + 1] image); the LF target is upsampled from a 9x9 grid
    (channel-planar), as train_step passes it."""
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(h, w, 3 + c + 1, generator=g)
    img[..., 3:-1] = torch.randn(h, w, c, generator=g)
    empty = torch.rand(h, w, generator=g) < 0.1
    img[empty] = 0.0             # empty pixels render LF and depth 0
    if zero_lf:
        img[: h // 2, :, 3:-1] = 0.0
    t = torch.where(empty, 1.0, 0.1 * torch.rand(h, w, generator=g))
    bg = torch.tensor([0.1, 0.2, 0.3])
    color = img[..., :3] + t[..., None] * bg
    if views:
        rlf, rd = img[..., 3:-1], img[..., -1]
    else:
        rlf, rd = img[..., 3:-1].clone(), img[..., -1].clone()
    gt_color = torch.rand(h, w, 3, generator=g)
    gt_lf = upsample_lf(torch.randn(9, 9, c, generator=g), h, w)
    gt_depth = torch.zeros(h, w) if zero_depth else \
        torch.rand(h, w, generator=g) * 3.0
    m = torch.ones(h, w)
    if mask != "ones":
        m[torch.rand(h, w, generator=g) < 0.15] = 0.0
        m[:, : max(w // 8, 1)] = 0.0
    if mask == "hw1":
        m = m[..., None]
    if not lf:
        rlf = gt_lf = None
    return color, gt_color, rlf, gt_lf, rd, gt_depth, m


def test_cpu_takes_the_plain_version():
    ops = _inputs(24, 40)
    n0 = K.mapping_loss_cuda.launches
    got = L.mapping_loss(*ops, LAM)
    assert torch.equal(got, L.mapping_loss_plain(*ops, LAM))
    assert K.mapping_loss_cuda.launches == n0


def test_other_devices_raise():
    ops = [None if x is None else x.to("meta") for x in _inputs(8, 8)]
    with pytest.raises(ValueError, match="no loss kernel for device meta"):
        L.mapping_loss(*ops, LAM)
    with pytest.raises(ValueError, match="no loss kernel for device cpu"):
        K.mapping_loss_cuda(*_inputs(8, 8), LAM)


def _bad(which):
    """The operands with one of them changed to something the kernels do
    not take, and the error it raises."""
    c, gc, lf, glf, d, gd, m = _inputs(12, 20, views=True)
    if which == "dtype":
        c = c.double()
    elif which == "rank":
        d = d[..., None]
    elif which == "colour_channels":
        gc = torch.rand(12, 20, 4)
    elif which == "mask_shape":
        m = m[:-1]
    elif which == "mask_channels":
        m = m[..., None].expand(12, 20, 2)
    elif which == "lf_shape":
        glf = glf[..., :-1]
    elif which == "no_unit_stride":
        lf = torch.randn(12, 20, 2 * LF)[..., ::2]
    elif which == "target_requires_grad":
        gd = gd.clone().requires_grad_(True)
    return c, gc, lf, glf, d, gd, m


@pytest.mark.parametrize("which,err,match", [
    ("dtype", TypeError, "render_color must be float32"),
    ("rank", ValueError, r"render_depth is \(12, 20, 1\)"),
    ("colour_channels", ValueError, r"gt_color is \(12, 20, 4\)"),
    ("mask_shape", ValueError, r"mask is \(11, 20\)"),
    ("mask_channels", ValueError, r"mask is \(12, 20, 2\)"),
    ("lf_shape", ValueError, r"gt_lf is \(12, 20, 15\)"),
    ("no_unit_stride", ValueError, "unit stride"),
    ("target_requires_grad", ValueError, "gt_depth requires grad"),
])
def test_operand_checks_raise(which, err, match):
    with pytest.raises(err, match=match):
        K.check_operands(*_bad(which))


def test_operand_checks_take_strided_views():
    c, gc, lf, glf, d, gd, m = _inputs(12, 20, views=True)
    assert lf.stride() == (20 * (LF + 4), LF + 4, 1)
    assert d.stride() == (20 * (LF + 4), LF + 4)
    assert glf.stride()[1:] == (1, 12 * 20)        # channel-planar
    assert K.check_operands(c, gc, lf, glf, d, gd, m) == LF
    assert K.check_operands(c, gc, None, glf, d, gd, m[..., None]) == 0


def test_argument_block_matches_the_kernel_source():
    src = (Path(K.__file__).resolve().parents[2] / "csrc" / "loss.cu"
           ).read_text()
    body = re.search(r"struct LossArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*|\[\w*\]", "", body)    # comments, sizes
    names = [re.findall(r"\w+", d)[-1]
             for decl in body.split(";") for d in decl.split(",")
             if d.strip()]
    assert [("lam" if n == "lambda" else n) for n in names] == \
        [f[0] for f in K._Args._fields_]
    # 10 views of 32 bytes, 4 pointers, 4 ints, 4 floats and 11 taps,
    # padded to 8 bytes
    assert ctypes.sizeof(K._Args) == 432
    assert K._Args.saved.offset == 320 and K._Args.taps.offset == 384
    tiles = {n: int(v) for n, v in re.findall(
        r"constexpr int (kTileW|kTileH) = (\d+);", src)}
    assert (tiles["kTileW"], tiles["kTileH"]) == (K.TILE_W, K.TILE_H)
    # a block a tile and role: two roles a tile with LF
    assert K._blocks(680, 1200, 64) == 2 * K._blocks(680, 1200, 0) == \
        2 * 38 * 85


CASES = {
    "odd_17x23": dict(h=17, w=23),
    "below_window_5x7": dict(h=5, w=7),
    "below_window_3x2_no_lf": dict(h=3, w=2, lf=False),
    "mask_hw1": dict(h=40, w=64, mask="hw1"),
    "mask_ones": dict(h=21, w=34, mask="ones"),
    "zero_lf_render": dict(h=33, w=31, zero_lf=True),
    "zero_depth_target": dict(h=20, w=30, zero_depth=True),
    "no_lf": dict(h=20, w=30, lf=False),
    "compositor_views": dict(h=24, w=40, views=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_mirror_matches_autograd(case):
    color, gc, lf, glf, d, gd, m = _inputs(seed=3, **CASES[case])
    leaves = [None if x is None else x.detach().clone().requires_grad_(True)
              for x in (color, lf, d)]
    loss = L.mapping_loss_plain(leaves[0], gc, leaves[1], glf, leaves[2],
                                gd, m, LAM)
    want = torch.autograd.grad(2.5 * loss, [x for x in leaves
                                            if x is not None])
    got_loss, *got = K.loss_grads_plain(color, gc, lf, glf, d, gd, m, LAM,
                                        gout=2.5)
    loss = 2.5 * float(loss.detach())
    assert abs(float(got_loss) - loss) <= 2e-6 * abs(loss)
    got = [x for x in got if x is not None]
    assert len(got) == len(want)
    for name, a, b in zip(("colour", "lf", "depth") if lf is not None
                          else ("colour", "depth"), got, want):
        err = float((a - b).abs().max())
        assert err <= 2e-6 * float(b.abs().max()), (name, err)
    if CASES[case].get("zero_depth"):
        # sgn(0) is 0: empty or masked pixels over a zero target take none
        z = d * (m if m.dim() == 2 else m[..., 0]) - gd
        assert not got[-1][z == 0].any()
