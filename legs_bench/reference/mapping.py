"""Plain reference of the online mapper's keyframe ingest and its mapping
step, in plain torch and numpy.

Frozen copies, each with the port's source it was taken from:
  - the keyframe pyramid: legslam_torch/mapper/keyframe.py:21-34, 111-147
  - camera matrices: legslam_torch/utils/camera.py:24-69
  - projection, EWA covariance, conic, radius:
    legslam_torch/ops/projection.py:38-183
  - SH colour: legslam_torch/utils/sh.py:22-68, and the quaternion
    normalisation before it, utils/transforms.py:17-25
  - compositing: legslam_torch/ops/composite.py:26-75 (alpha, cumprod
    blend weights) and ops/rasterize.py:70-128 (tiles, chunks)
  - the loss: legslam_torch/ops/losses.py:24-156
  - the LF upsample: legslam_torch/mapper/train_step.py:157-169
  - Adam and the learning rates: legslam_torch/models/gaussians.py:203-251
    and mapper/train_step.py:38-55
Its own binning has no caps: every gaussian is composited in every tile
of its 3-sigma rectangle (getRect, rasterizer_impl.cu), depth-ordered.
The step composites over the pair list it is given, or over its own; the
gradient is taken by autograd, tile batch by tile batch, against the
loss's gradient on the image.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_TERMINATE = 1e-4
COV2D_LOWPASS = 0.3
VIEW_CLAMP = 1.3
PROJ_W_EPS = 1e-7
NEAR_CLIP = 0.2
RADIUS_EIG_GUARD = 0.1
Z_NEAR, Z_FAR = 0.01, 100.0
SSIM_WINDOW, SSIM_SIGMA = 11, 1.5
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
GROUPS = ("xyz", "f_dc", "f_rest", "lang_feat", "opacity", "scaling",
          "rotation")


# --- the keyframe pyramid ----------------------------------------------------

def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    x = torch.as_tensor(np.asarray(img, np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)[0]
    return (y[0] if np.ndim(img) == 2 else y.permute(1, 2, 0)).numpy()


def level_shapes(h: int, w: int, num_sub_levels: int) -> list:
    out = []
    for lvl in range(num_sub_levels + 1):
        if lvl < num_sub_levels:
            scale = 0.5 ** (num_sub_levels - lvl)
            out.append((max(int(h * scale), 1), max(int(w * scale), 1)))
        else:
            out.append((h, w))
    return out


def pyramid(color: np.ndarray, depth: np.ndarray, num_sub_levels: int):
    """[(colour [h, w, 3], depth [h, w])] per level, coarsest first, as
    the keyframe stores them: resized on the host, colour quantised to 8
    bits, depth to u16 millimetres."""
    h, w = color.shape[:2]
    out = []
    for lh, lw in level_shapes(h, w, num_sub_levels):
        if (lh, lw) == (h, w):
            c, d = color, depth
        else:
            c, d = resize_linear(color, lh, lw), resize_linear(depth, lh, lw)
        cu8 = np.clip(np.asarray(c, np.float32) * 255.0 + 0.5,
                      0, 255).astype(np.uint8)
        d = np.asarray(d, np.float32)
        if d.size and np.all(d >= 0) and np.all(d < 65.5):
            d = (d * 1000.0 + 0.5).astype(np.uint16).astype(np.float32) / \
                np.float32(1000.0)
        out.append((cu8.astype(np.float32) / np.float32(255.0), d))
    return out


# --- camera ------------------------------------------------------------------

def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def view(R: np.ndarray, t: np.ndarray, width: int, height: int,
         fovx: float, fovy: float, device) -> dict:
    rt = np.eye(4)
    rt[:3, :3], rt[:3, 3] = R, t
    w2v = np.linalg.inv(np.linalg.inv(rt)).astype(np.float32)
    tx, ty = math.tan(fovx / 2.0), math.tan(fovy / 2.0)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = Z_NEAR / (tx * Z_NEAR)
    proj[1, 1] = Z_NEAR / (ty * Z_NEAR)
    proj[3, 2] = 1.0
    proj[2, 2] = Z_FAR / (Z_FAR - Z_NEAR)
    proj[2, 3] = -(Z_FAR * Z_NEAR) / (Z_FAR - Z_NEAR)
    full = (proj @ w2v).astype(np.float32)
    center = np.linalg.inv(w2v)[:3, 3].astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)
    return dict(width=int(width), height=int(height), tan_fovx=tx,
                tan_fovy=ty, world_view=dev(w2v), full_proj=dev(full),
                cam_center=dev(center))


# --- projection and colour ---------------------------------------------------

def _cov3d(scales, quats):
    w, qx, qy, qz = quats.unbind(-1)
    inv_n = torch.rsqrt(torch.clamp_min(w * w + qx * qx + qy * qy + qz * qz,
                                        1e-24))
    w, qx, qy, qz = w * inv_n, qx * inv_n, qy * inv_n, qz * inv_n
    sx, sy, sz = scales.unbind(-1)
    r00, r01, r02 = 1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz), \
        2 * (qx * qz + w * qy)
    r10, r11, r12 = 2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz), \
        2 * (qy * qz - w * qx)
    r20, r21, r22 = 2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx), \
        1 - 2 * (qx * qx + qy * qy)
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    return (m00 * m00 + m01 * m01 + m02 * m02,
            m00 * m10 + m01 * m11 + m02 * m12,
            m00 * m20 + m01 * m21 + m02 * m22,
            m10 * m10 + m11 * m11 + m12 * m12,
            m10 * m20 + m11 * m21 + m12 * m22,
            m20 * m20 + m21 * m21 + m22 * m22)


def preprocess(xyz, scales, quats, valid, v: dict):
    """(mean2d [P, 2], conic [P, 3], view depth [P], radius [P], mask
    [P]) of forward.cu's preprocess."""
    width, height = v["width"], v["height"]
    fx = width / (2.0 * v["tan_fovx"])
    fy = height / (2.0 * v["tan_fovy"])
    wv, fp = v["world_view"], v["full_proj"]
    x, y, z = xyz.unbind(-1)
    view_z = wv[2, 0] * x + wv[2, 1] * y + wv[2, 2] * z + wv[2, 3]
    in_front = view_z > NEAR_CLIP
    xx, xy, xz, yy, yz, zz = _cov3d(scales, quats)
    tx = wv[0, 0] * x + wv[0, 1] * y + wv[0, 2] * z + wv[0, 3]
    ty = wv[1, 0] * x + wv[1, 1] * y + wv[1, 2] * z + wv[1, 3]
    tz = torch.where(in_front, view_z, 1.0)
    limx, limy = VIEW_CLAMP * v["tan_fovx"], VIEW_CLAMP * v["tan_fovy"]
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    j00, j02 = fx * inv_z, -fx * tx * inv_z * inv_z
    j11, j12 = fy * inv_z, -fy * ty * inv_z * inv_z
    t00 = j00 * wv[0, 0] + j02 * wv[2, 0]
    t01 = j00 * wv[0, 1] + j02 * wv[2, 1]
    t02 = j00 * wv[0, 2] + j02 * wv[2, 2]
    t10 = j11 * wv[1, 0] + j12 * wv[2, 0]
    t11 = j11 * wv[1, 1] + j12 * wv[2, 1]
    t12 = j11 * wv[1, 2] + j12 * wv[2, 2]
    v0a = xx * t00 + xy * t01 + xz * t02
    v1a = xy * t00 + yy * t01 + yz * t02
    v2a = xz * t00 + yz * t01 + zz * t02
    v0b = xx * t10 + xy * t11 + xz * t12
    v1b = xy * t10 + yy * t11 + yz * t12
    v2b = xz * t10 + yz * t11 + zz * t12
    c00 = t00 * v0a + t01 * v1a + t02 * v2a + COV2D_LOWPASS
    c01 = t10 * v0a + t11 * v1a + t12 * v2a
    c11 = t10 * v0b + t11 * v1b + t12 * v2b + COV2D_LOWPASS
    c00 = torch.where(in_front, c00, 1.0)
    c01 = torch.where(in_front, c01, 1.0)
    c11 = torch.where(in_front, c11, 1.0)
    det = c00 * c11 - c01 * c01
    det_valid = det != 0.0
    det_inv = 1.0 / torch.where(det_valid, det, 1.0)
    conic = torch.stack([c11 * det_inv, -c01 * det_inv, c00 * det_inv], -1)
    mid = 0.5 * (c00 + c11)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, RADIUS_EIG_GUARD))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(mid + disc, 0.0)))
    hx = fp[0, 0] * x + fp[0, 1] * y + fp[0, 2] * z + fp[0, 3]
    hy = fp[1, 0] * x + fp[1, 1] * y + fp[1, 2] * z + fp[1, 3]
    hw = fp[3, 0] * x + fp[3, 1] * y + fp[3, 2] * z + fp[3, 3]
    p_w = 1.0 / (hw + PROJ_W_EPS)
    pix = torch.stack([((hx * p_w + 1.0) * width - 1.0) * 0.5,
                       ((hy * p_w + 1.0) * height - 1.0) * 0.5], -1)
    pix = torch.where(in_front[:, None], pix, -1e6)
    mask = valid & in_front & det_valid & (radius_f > 0.0)
    radius = torch.where(mask, radius_f, 0.0).to(torch.int32)
    return pix, conic, view_z, radius, mask


def sh_to_color(deg: int, sh: torch.Tensor, means: torch.Tensor,
                campos: torch.Tensor) -> torch.Tensor:
    d = means - campos
    d = d * torch.rsqrt(torch.clamp_min(torch.sum(d * d, -1, keepdim=True),
                                        1e-24))
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    basis = [torch.full_like(x, SH_C0)]
    if deg > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                  SH_C2[4] * (xx - yy)]
    if deg > 2:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    rgb = sum(b * sh[:, k, :] for k, b in enumerate(basis)) + 0.5
    return torch.clamp_min(rgb, 0.0)


# --- compositing -------------------------------------------------------------

def tile_pairs(mean2d, radius, mask, depth, width, height, tile_w, tile_h):
    """Uncapped binning: (pair gaussian ids sorted by (tile, depth), tile
    starts, tile counts). A gaussian enters every tile of its clamped
    3-sigma rectangle; depth ties keep gaussian order."""
    P = mean2d.shape[0]
    ntx, nty = -(-width // tile_w), -(-height // tile_h)
    r = radius.float()
    px, py = mean2d[:, 0].detach(), mean2d[:, 1].detach()

    def cell(val, size, n):
        return torch.floor(val / size).clamp(0, n).long()
    x0, x1 = cell(px - r, tile_w, ntx), cell(px + r + tile_w - 1, tile_w, ntx)
    y0, y1 = cell(py - r, tile_h, nty), cell(py + r + tile_h - 1, tile_h, nty)
    sx, sy = x1 - x0, y1 - y0
    ok = mask & (sx * sy > 0)
    order = torch.argsort(torch.where(ok, depth.detach(), float("inf")),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(P, device=order.device)
    n = torch.where(ok, sx * sy, 0)
    gid = torch.repeat_interleave(torch.arange(P, device=order.device), n)
    first = torch.cumsum(n, 0) - n
    k = torch.arange(gid.shape[0], device=order.device) - first[gid]
    tile = (y0[gid] + k // sx[gid]) * ntx + x0[gid] + k % sx[gid]
    key = tile * P + rank[gid]
    srt = torch.argsort(key)
    gid, tile = gid[srt], tile[srt]
    count = torch.bincount(tile, minlength=ntx * nty)
    start = torch.cumsum(count, 0) - count
    return gid, start, count


def _masked_alpha(power, opacity, extra_mask):
    g = torch.exp(torch.clamp_max(power, 0.0))
    raw = opacity * g
    alpha = raw - torch.clamp_min(raw - ALPHA_MAX, 0.0).detach()
    keep = (power <= 0.0) & (alpha.detach() >= ALPHA_MIN) & extra_mask
    return torch.where(keep, alpha, 0.0)


def _blend(alpha, t_all_in):
    one_minus = 1.0 - alpha
    inclusive = torch.cumprod(one_minus, dim=-1) * t_all_in[..., None]
    exclusive = inclusive / torch.where(one_minus > 0, one_minus, 1.0)
    contrib = inclusive.detach() >= T_TERMINATE
    weights = torch.where(contrib, alpha * exclusive, 0.0)
    t_all_out = t_all_in * torch.prod(one_minus, dim=-1)
    t_fin = torch.prod(torch.where(contrib, one_minus, 1.0), dim=-1)
    return weights, t_all_out, t_fin


def composite_tiles(tiles, pairs, mean2d, conic, opacity, feats, width,
                    tile_w, tile_h, chunk):
    """[B, npix, C] composited features and [B, npix] final transmittance
    of a batch of tiles."""
    gid_all, start, count = pairs
    dev = mean2d.device
    ntx = -(-width // tile_w)
    xs = torch.arange(tile_w, dtype=torch.float32, device=dev)
    ys = torch.arange(tile_h, dtype=torch.float32, device=dev)
    koff = torch.arange(chunk, device=dev)
    B, npix, C = tiles.shape[0], tile_w * tile_h, feats.shape[-1]
    st, cnt = start[tiles], count[tiles]
    px = (tiles % ntx).float()[:, None] * tile_w + xs[None, :]
    py = (tiles // ntx).float()[:, None] * tile_h + ys[None, :]
    t_all = torch.ones(B, npix, device=dev)
    t_fin = torch.ones(B, npix, device=dev)
    acc = torch.zeros(B, npix, C, device=dev)
    n_pairs = max(gid_all.shape[0], 1)
    for k in range(-(-int(cnt.max()) // chunk) if B else 0):
        pos = k * chunk + koff[None, :]
        pvalid = pos < cnt[:, None]
        idx = torch.clamp(st[:, None] + pos, 0, n_pairs - 1)
        gid = gid_all[idx] if gid_all.numel() else torch.zeros_like(idx)
        # a handed-over list marks empty slots with the id P: never in a
        # tile's range, read as row P - 1 and masked
        gid = torch.clamp_max(gid, mean2d.shape[0] - 1)
        m2, con, op, f = mean2d[gid], conic[gid], opacity[gid], feats[gid]
        dx = m2[..., 0][:, None, None, :] - px[:, None, :, None]
        dy = m2[..., 1][:, None, None, :] - py[:, :, None, None]
        a = con[..., 0][:, None, None, :]
        b = con[..., 1][:, None, None, :]
        c = con[..., 2][:, None, None, :]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = _masked_alpha(power, op[:, None, None, :],
                              pvalid[:, None, None, :])
        w, t_all, t_delta = _blend(alpha.reshape(B, npix, chunk), t_all)
        acc = acc + torch.bmm(w, f)
        t_fin = t_fin * t_delta
    return acc, t_fin


def to_image(parts, width, height, tile_w, tile_h):
    ntx, nty = -(-width // tile_w), -(-height // tile_h)
    x = torch.cat(parts)
    shape = x.shape[2:]
    x = x.reshape((nty, ntx, tile_h, tile_w) + shape).transpose(1, 2)
    return x.reshape((nty * tile_h, ntx * tile_w) + shape)[:height, :width]


# --- loss --------------------------------------------------------------------

def _lf_cos(pred, gt, mask, eps=1e-8):
    dot = torch.sum(pred * gt, dim=-1) * mask
    nsq1 = torch.sum(pred * pred, dim=-1) * (mask * mask)
    nsq2 = torch.sum(gt * gt, dim=-1)
    n1 = torch.sqrt(torch.clamp_min(nsq1, eps * eps))
    n2 = torch.sqrt(torch.clamp_min(nsq2, eps * eps))
    return torch.mean(dot / (n1 * n2))


@functools.lru_cache(maxsize=16)
def _band(n: int, device: torch.device) -> torch.Tensor:
    xs = np.arange(SSIM_WINDOW) - SSIM_WINDOW // 2
    g = np.exp(-(xs ** 2) / (2.0 * SSIM_SIGMA * SSIM_SIGMA))
    win = (g / g.sum()).astype(np.float32)
    half = SSIM_WINDOW // 2
    m = np.zeros((n, n), np.float32)
    for k in range(SSIM_WINDOW):
        d = k - half
        idx = np.arange(max(0, -d), min(n, n - d))
        m[idx, idx + d] = win[k]
    return torch.as_tensor(m, device=device)


def _blur(img):
    h, w, c = img.shape
    x = (_band(h, img.device) @ img.reshape(h, w * c)).reshape(h, w, c)
    y = (_band(w, img.device) @ x.permute(1, 0, 2).reshape(w, h * c))
    return y.reshape(w, h, c).permute(1, 0, 2)


def ssim(img1, img2):
    c = img1.shape[-1]
    b = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                        dim=-1))
    mu1, mu2 = b[..., :c], b[..., c:2 * c]
    s1 = b[..., 2 * c:3 * c] - mu1 * mu1
    s2 = b[..., 3 * c:4 * c] - mu2 * mu2
    s12 = b[..., 4 * c:] - mu1 * mu2
    num = (2 * mu1 * mu2 + SSIM_C1) * (2 * s12 + SSIM_C2)
    den = (mu1 * mu1 + mu2 * mu2 + SSIM_C1) * (s1 + s2 + SSIM_C2)
    return torch.mean(num / den)


def mapping_loss(color, gt_color, lf, gt_lf, depth, gt_depth, mask,
                 lambda_dssim):
    m = mask[..., None]
    pc = color * m
    loss = (1.0 - lambda_dssim) * torch.mean(torch.abs(pc - gt_color)) + \
        lambda_dssim * (1.0 - ssim(pc, gt_color))
    if lf is not None:
        loss = loss + _lf_cos(lf, gt_lf, mask)
    return loss + torch.mean(torch.abs(depth * mask - gt_depth))


def upsample_lf(lf_small, height, width):
    x = lf_small.permute(2, 0, 1)[None]
    up = F.interpolate(x, size=(height, width), mode="bilinear",
                       align_corners=False, antialias=True)
    return up[0].permute(1, 2, 0)


# --- Adam --------------------------------------------------------------------

def expon_lr(step, lr_init, lr_final, lr_delay_mult, max_steps):
    step = torch.as_tensor(step, dtype=torch.float32)
    tt = torch.clamp(step / max_steps, 0.0, 1.0)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    log_lerp = torch.exp(
        torch.log(torch.tensor(lr_init, dtype=torch.float32)) * (1 - tt)
        + torch.log(torch.tensor(lr_final, dtype=torch.float32)) * tt)
    return torch.where(step >= 0, log_lerp, 0.0)


def learning_rates(opt: dict, extent: float, lr_step: float) -> dict:
    xyz = expon_lr(lr_step, opt["position_lr_init"] * extent,
                   opt["position_lr_final"] * extent,
                   opt["position_lr_delay_mult"],
                   opt["position_lr_max_steps"])
    return dict(xyz=xyz, f_dc=opt["feature_lr"],
                f_rest=opt["feature_lr"] / 20.0,
                lang_feat=opt["lang_feature_lr"], opacity=opt["opacity_lr"],
                scaling=opt["scaling_lr"], rotation=opt["rotation_lr"])


# --- the step ----------------------------------------------------------------

def given_pairs(pair_gid, tile_start, tile_count, max_pairs: int):
    """A pair list handed over as (gaussian ids in (tile, depth) order,
    tile starts, tile counts), its ranges cut at `max_pairs` as the
    compositing kernels cut them."""
    start = torch.clamp_max(tile_start.long(), max_pairs)
    end = torch.clamp_max(tile_start.long() + tile_count.long(), max_pairs)
    return pair_gid.long(), start, end - start


def render(params: dict, valid, v: dict, sh_degree: int, cfg: dict,
           feat_dtype: torch.dtype, pairs=None) -> torch.Tensor:
    """[H, W, 3 + LF + 1] composited colour, language features and depth,
    without gradients, over `pairs` or the reference's own binning."""
    tw, th, chunk, tb = cfg["tile_w"], cfg["tile_h"], cfg["chunk"], \
        cfg["tile_batch"]
    width, height = v["width"], v["height"]
    with torch.no_grad():
        stage, own = _stage(params, valid, v, sh_degree, feat_dtype,
                            width, height, tw, th)
        pairs = own if pairs is None else pairs
        ntiles = (-(-width // tw)) * (-(-height // th))
        out = [composite_tiles(torch.arange(t0, min(t0 + tb, ntiles),
                                            device=valid.device), pairs,
                               *stage, width, tw, th, chunk)[0]
               for t0 in range(0, ntiles, tb)]
    return to_image(out, width, height, tw, th)


def _stage(leaves, valid, v, sh_degree, feat_dtype, width, height, tw, th):
    """Per-gaussian screen geometry and features, and the reference's own
    pair list."""
    q = leaves["rotation"]
    q = q * torch.rsqrt(torch.clamp_min(torch.sum(q * q, -1, keepdim=True),
                                        1e-24))
    mean2d, conic, depth, radius, mask = preprocess(
        leaves["xyz"], torch.exp(leaves["scaling"]), q, valid, v)
    sh = torch.cat([leaves["f_dc"], leaves["f_rest"]], dim=1)
    rgb = sh_to_color(sh_degree, sh, leaves["xyz"], v["cam_center"])
    opacity = torch.sigmoid(leaves["opacity"][:, 0])
    feats = torch.cat([rgb, leaves["lang_feat"], depth.detach()[:, None]], -1)
    # the pair features are stored in feat_dtype; the rounding passes the
    # gradient straight through, as a dtype cast does under autograd
    feats = feats + (feats.to(feat_dtype).float() - feats).detach()
    pairs = tile_pairs(mean2d, radius, mask, depth, width, height, tw, th)
    return (mean2d, conic, opacity, feats), pairs


def render_and_grad(params: dict, valid, v: dict, sh_degree: int, gt: dict,
                    cfg: dict, feat_dtype: torch.dtype,
                    lambda_dssim: float, pairs=None):
    """(loss, colour [H, W, 3], {group: gradient}) of one mapping step's
    render and loss from the pre-step parameters, the gradients zeroed on
    invalid rows. `feat_dtype` is the storage type of the gathered pair
    features (the configuration's bfloat16; the control's lower type).
    `pairs` (given_pairs) is the pair list the step was handed; without it
    the reference bins the geometry itself."""
    tw, th, chunk, tb = cfg["tile_w"], cfg["tile_h"], cfg["chunk"], \
        cfg["tile_batch"]
    width, height = v["width"], v["height"]
    leaves = {k: t.detach().clone().requires_grad_(True)
              for k, t in params.items()}
    full, own = _stage(leaves, valid, v, sh_degree, feat_dtype, width,
                       height, tw, th)
    pairs = own if pairs is None else pairs
    stage = [t.detach().requires_grad_(True) for t in full]
    ntiles = (-(-width // tw)) * (-(-height // th))
    dev = valid.device
    batches = [torch.arange(t0, min(t0 + tb, ntiles), device=dev)
               for t0 in range(0, ntiles, tb)]
    with torch.no_grad():
        out = [composite_tiles(b, pairs, *stage, width, tw, th, chunk)
               for b in batches]
    img = to_image([o[0] for o in out], width, height, tw, th)
    img = img.detach().requires_grad_(True)
    lf = img[..., 3:-1]
    loss = mapping_loss(img[..., :3], gt["color"], lf, gt["lf"],
                        img[..., -1], gt["depth"], gt["mask"], lambda_dssim)
    (g_img,) = torch.autograd.grad(loss, [img])
    # the loss's image gradient, tile by tile, back through compositing
    ntx, nty = -(-width // tw), -(-height // th)
    g_pad = torch.zeros(nty * th, ntx * tw, g_img.shape[-1], device=dev)
    g_pad[:height, :width] = g_img
    g_tiles = g_pad.reshape(nty, th, ntx, tw, -1).transpose(1, 2).reshape(
        ntx * nty, th * tw, -1)
    for b in batches:
        acc, _ = composite_tiles(b, pairs, *stage, width, tw, th, chunk)
        acc.backward(g_tiles[b])
    grads_stage = [s.grad if s.grad is not None else torch.zeros_like(s)
                   for s in stage]
    torch.autograd.backward(list(full), grads_stage)
    grads = {}
    for k, leaf in leaves.items():
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        grads[k] = torch.where(valid.view((-1,) + (1,) * (g.ndim - 1)), g,
                               0.0)
    return loss.detach(), img[..., :3].detach(), grads


@torch.no_grad()
def adam(params: dict, m: dict, v: dict, step: int, grads: dict,
         lrs: dict) -> dict:
    """One Adam step of every group: the parameters after it."""
    t = torch.tensor(float(step + 1))
    bc1 = 1.0 - torch.pow(torch.tensor(ADAM_B1), t)
    bc2 = 1.0 - torch.pow(torch.tensor(ADAM_B2), t)
    out = {}
    for k in GROUPS:
        g = grads[k]
        m_k = ADAM_B1 * m[k] + (1.0 - ADAM_B1) * g
        v_k = ADAM_B2 * v[k] + (1.0 - ADAM_B2) * g * g
        denom = torch.sqrt(v_k / bc2.to(g.device)) + ADAM_EPS
        lr = torch.as_tensor(lrs[k], dtype=torch.float32, device=g.device)
        out[k] = params[k] - (lr / bc1.to(g.device)) * m_k / denom
    return out
