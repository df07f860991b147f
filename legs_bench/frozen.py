"""Frozen copies of the port's measurement arithmetic and probes.

The yardstick must not move when the program does, so nothing here is
imported from `chip_smoke.py` or from `legslam_torch`: each function is a
copy of the one named beside it, as it stood when the benchmark was
defined. A later change to the program leaves these alone.
"""
from __future__ import annotations

import math
import statistics
import subprocess

import torch
import torch.nn.functional as F

# chip_smoke.py:192-195: float32 CUDA-core peak and HBM rate of one H100
# SXM at its 700 W limit (NVIDIA data sheet, dense)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, the ceiling the
# whole frame's share is taken against (frame_mfu)
PEAK_BF16_OPS = 989e12

# chip_smoke.py:197-213: operations counted per (pair, pixel) for the bound
OPS_EVAL = 16
OPS_KEEP = 3

# legslam_torch/config.py:30-32 (forward.cu:344-357)
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_TERMINATE = 1e-4
# legslam_torch/ops/cuda/composite.py:24-26
GEO_X, GEO_Y, GEO_A, GEO_B, GEO_C, GEO_OP = range(6)
LOG_TERM = math.log(T_TERMINATE)


def ops_fwd_contrib(c: int) -> int:
    """chip_smoke.py:208-209."""
    return 2 * c + 3


def ops_bwd_contrib(c: int) -> int:
    """chip_smoke.py:212-213."""
    return 4 * c + 24


def card_line() -> str:
    """chip_smoke.py:216-221: the card's name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


class ClockSampler:
    """chip_smoke.py:224-263: samples the card's SM clock, power draw and
    temperature with nvidia-smi every 100 ms while the block runs. The
    sampling process is stopped and waited for on exit."""

    FIELDS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"

    def __enter__(self):
        self.rows = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.FIELDS}",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                self.rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        return False

    def summary(self) -> str:
        if not self.rows:
            return "clocks not measured"
        sm, mx, pw, temp = zip(*self.rows)
        return (f"SM clock median {statistics.median(sm):.0f} MHz (min "
                f"{min(sm):.0f}, max possible {max(mx):.0f}), power draw "
                f"median {statistics.median(pw):.1f} W, temperature max "
                f"{max(temp):.0f} C, {len(sm)} samples")


# --- legslam_torch/ops/cuda/composite.py:221-260 -----------------------------

def tile_pixels(tile_ids: torch.Tensor, tile_w: int, tile_h: int, ntx: int):
    """composite.py:221-227: global pixel coordinates [B, npix] (x, y)."""
    lin = torch.arange(tile_w * tile_h, device=tile_ids.device)
    px = (tile_ids % ntx)[:, None] * tile_w + lin % tile_w
    py = (tile_ids // ntx)[:, None] * tile_h + lin // tile_w
    return px.float(), py.float()


def chunk_alpha(geo: torch.Tensor, pos: torch.Tensor, in_range: torch.Tensor,
                px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """composite.py:230-245 (alpha only): [B, npix, chunk] alphas of one
    chunk of pairs, zero outside the range."""
    g = geo[torch.clamp(pos, 0, geo.shape[0] - 1)]
    gx, gy, ca, cb, cc = (g[..., i][:, None, :] for i in range(5))
    op = torch.where(in_range, g[..., GEO_OP], 0.0)[:, None, :]
    dx = gx - px[:, :, None]
    dy = gy - py[:, :, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    g_exp = torch.exp(torch.clamp_max(power, 0.0))
    alpha = torch.clamp_max(op * g_exp, ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(keep, alpha, 0.0)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """composite.py:248-249."""
    return F.pad(torch.cumsum(x, dim=-1)[..., :-1], (1, 0))


def tile_chunk_ranges(start, count, chunk: int):
    """composite.py:252-260."""
    s = start.long()
    e = s + count.long()
    base0 = torch.div(s, chunk, rounding_mode="floor") * chunk
    n_chunks = torch.div(e - base0 + chunk - 1, chunk, rounding_mode="floor")
    return s, e, base0, n_chunks


# --- chip_smoke.py:573-649 ---------------------------------------------------

@torch.no_grad()
def work_counts(start, count, geo, tile_w, tile_h, ntx, chunk, kfin,
                n_buckets=1):
    """chip_smoke.py:573-617: (pair-pixels evaluated, kept, contributing,
    pair rows read) over the chunks each tile processes, up to kfin, or
    with kfin None walking each tile's ranges until every pixel has
    terminated (what these inputs need)."""
    dev = geo.device
    n_eval = n_keep = n_contrib = rows = 0
    koff = torch.arange(chunk, device=dev)
    ntiles = start.shape[0] // n_buckets
    for t0 in range(0, ntiles, 16):
        tid = torch.arange(t0, min(t0 + 16, ntiles), device=dev)
        px, py = tile_pixels(tid, tile_w, tile_h, ntx)
        log_all = torch.zeros(len(tid), tile_w * tile_h, device=dev)
        alive = torch.ones(len(tid), dtype=torch.bool, device=dev)
        for b in range(n_buckets):
            rid = tid * n_buckets + b
            s, e, base0, n_chunks = tile_chunk_ranges(start[rid], count[rid],
                                                      chunk)
            kf = kfin[tid].long() if kfin is not None else n_chunks
            for k in range(int(kf.max())):
                running = (k < kf) & alive
                pos = base0[:, None] + k * chunk + koff
                in_range = (pos >= s[:, None]) & (pos < e[:, None]) & \
                    running[:, None]
                alpha = chunk_alpha(geo, pos, in_range, px, py)
                log1m = torch.log1p(-alpha)
                log_exc = log_all[..., None] + exclusive_cumsum(log1m)
                contrib = (log_exc + log1m >= LOG_TERM) & (alpha > 0)
                npair = int(in_range.sum())
                rows += npair
                n_eval += npair * tile_w * tile_h
                n_keep += int((alpha > 0).sum())
                n_contrib += int(contrib.sum())
                log_all = log_all + log1m.sum(-1)
                if kfin is None:
                    alive = alive & ~(running & (log_all.max(-1).values
                                                 < LOG_TERM))
    return n_eval, n_keep, n_contrib, rows


def bounds(fwd_args, kfin):
    """chip_smoke.py:620-649: least times (ms) of the forward and backward
    kernels on these inputs, the larger of bytes / HBM rate and f32 ops /
    CUDA-core peak, with the counts behind them."""
    start, count, geo, feats, tile_w, tile_h, ntx, chunk = fwd_args[:8]
    n_buckets = fwd_args[8] if len(fwd_args) > 8 else 1
    c = feats.shape[1]
    ntiles, npix = start.shape[0] // n_buckets, tile_w * tile_h
    n_eval, n_keep, n_contrib, rows = work_counts(
        start, count, geo, tile_w, tile_h, ntx, chunk, kfin, n_buckets)
    row_bytes = 32 + c * feats.element_size()
    pix_bytes = ntiles * npix * 4
    ranges = 8 * ntiles * n_buckets
    fwd_bytes = ranges + rows * row_bytes + pix_bytes * (c + 1) + \
        (4 * ntiles if kfin is not None else 0)
    bwd_bytes = ranges + rows * row_bytes + pix_bytes * (2 * c + 2) + \
        geo.shape[0] * (32 + 4 * c)
    base_ops = n_eval * OPS_EVAL + n_keep * OPS_KEEP
    fwd_ops = base_ops + n_contrib * ops_fwd_contrib(c)
    bwd_ops = base_ops + n_contrib * ops_bwd_contrib(c)
    out = {}
    for name, b, o in (("fwd", fwd_bytes, fwd_ops), ("bwd", bwd_bytes,
                                                     bwd_ops)):
        tb, to = b / PEAK_BYTES * 1e3, o / PEAK_F32_OPS * 1e3
        out[name] = dict(bound_ms=max(tb, to),
                         bound_by="bytes" if tb >= to else "operations",
                         bytes=b, ops=o)
    out["counts"] = dict(pair_pixels=n_eval, kept=n_keep,
                         contributing=n_contrib, pair_rows=rows)
    return out


def sort_bound(n: int, nbytes: int) -> dict:
    """chip_smoke.py:678-689: least time (ms) of a sort of n int32 keys
    moving `nbytes`."""
    ops = n * max(int(math.log2(n)), 1)
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                bytes=nbytes, ops=ops)


def encoder_flops(cfg, n_patches: int, k: int = 64) -> int:
    """chip_smoke.py:1070-1080: operations of one encoder forward (2 per
    multiply-add); `cfg` carries dim, mlp_ratio, num_registers,
    patch_size and depth."""
    d, hid = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
    n = n_patches + 1 + cfg.num_registers
    patch = 2 * n_patches * 3 * cfg.patch_size ** 2 * d
    block = 2 * n * d * 3 * d + 2 * (2 * n * n * d) + 2 * n * d * d + \
        2 * (2 * n * d * hid)
    return patch + cfg.depth * block + 2 * n_patches * d * k


def clip_text_flops(cfg, n_seq: int) -> int:
    """chip_smoke.py:1391-1397: operations of encode_text over n_seq
    sequences; `cfg` carries width, context, layers and proj_dim."""
    w, n = cfg.width, cfg.context
    layer = n * 2 * (3 * w * w + w * w + 8 * w * w) + 2 * 2 * n * n * w
    return n_seq * (cfg.layers * layer + 2 * w * cfg.proj_dim)
