"""How the stereo loop cell's `correct` is decided: the loop cells'
comparison (legs_bench/loop_check.py) on the stereo cell's inputs, with
store growth by the stereo rule and the keyframes' SGM against the plain
reference (legs_bench/reference/stereo.py).

  - encoder, binning, mapping step and densification: as loop_check, on
    the left frames the program was fed;
  - keyframe ingest (`ingest_mismatch`): the pyramid colour of a seeded
    sample of the window's keyframes, exact; their depth pyramid is the
    all-zero one a keyframe without a depth image gets (the stereo
    sequence's stored depth is zero), so it is compared too;
  - store growth (`growth_count_gap`, `growth_row_gap`): every keyframe
    operation of the window adds the rows the stereo rule gives from the
    keyframe's keypoints and the disparity the frontend put in its
    packet: its map points, and the depth cache's flushes of every
    keypoint with a valid disparity, replayed from the cache as the
    window found it; the rows of a seeded operation that flushed, and of
    a seeded one of all, lie where the reference's back-projection puts
    them;
  - SGM (`sgm_mismatch`, `sgm_gap`): the program's disparity of 2 seeded
    keyframes of the window against the reference's SGM of the same pair:
    pixels whose validity differs or whose disparities lie half a pixel
    or more apart (exact: none), and the largest |difference| where both
    are valid (the parabola's offset);
  - one SGM a keyframe (`sgm_count_gap`): |SGMs the window ran - its
    keyframes|, exact.

A stereo map leaves parts of a view without gaussians, so a tile batch of
the reference's step can hold no pair at all; the reference's step
(reference/mapping.py render_and_grad) back-propagates every batch and
raises on one whose composite has no graph. `batches_without_pairs` runs
the comparison with such a batch tied to the graph by an empty sum: it
adds 0 to the composite and no gradient, as a batch with no pair
contributes none.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from legs_bench import loop_check, scene
from legs_bench.reference import growth as ref_growth
from legs_bench.reference import mapping as ref_mapping
from legs_bench.reference import stereo as ref_stereo


@contextlib.contextmanager
def batches_without_pairs():
    """While the block runs, the reference's composite of a tile batch with
    no pair joins the graph of the batch's geometry (module docstring)."""
    real = ref_mapping.composite_tiles

    def composite(tiles, pairs, mean2d, *rest):
        acc, t_fin = real(tiles, pairs, mean2d, *rest)
        if mean2d.requires_grad and torch.is_grad_enabled() and \
                not acc.requires_grad:
            acc = acc + mean2d[:0].sum()
        return acc, t_fin
    ref_mapping.composite_tiles = composite
    try:
        yield
    finally:
        ref_mapping.composite_tiles = real


def decode_pair(seq, i: int, dev):
    """Loop frame i's left and right views on `dev`, as the EuRoC reader
    decodes them: float32 in [0, 1], grey in three channels."""
    left, _ = scene.decode(seq, i)
    right = np.repeat(seq.right[i][..., None], 3, -1).astype(np.float32) / \
        np.float32(255.0)
    return torch.as_tensor(left, device=dev), torch.as_tensor(right,
                                                              device=dev)


def sgm_numbers(samples: list, seq, mp, dev, **ref) -> dict:
    """`sgm_mismatch` and `sgm_gap` of the sampled (frame id, program
    disparity [H, W]) pairs; `ref` goes to the reference's disparity."""
    if not samples:
        return dict(sgm_mismatch=float("inf"), sgm_gap=float("inf"))
    mismatch, gap = 0, 0.0
    for fid, got in samples:
        left, right = decode_pair(seq, fid % len(seq), dev)
        want = ref_stereo.disparity(left, right, mp.stereo_num_disparity,
                                    mp.stereo_min_disparity, **ref)
        want = want.cpu().numpy()
        got = np.asarray(got)
        vg, vw = got > 0, want > 0
        both = vg & vw
        diff = np.abs(got - want)[both]
        mismatch += int((vg != vw).sum()) + int((diff >= 0.5).sum())
        if diff.size:
            gap = max(gap, float(diff.max()))
    return dict(sgm_mismatch=float(mismatch), sgm_gap=gap)


def _points(kept: dict, seq, intr: dict, dtype=np.float64):
    g, st = kept["growth"], kept["stereo"]
    memo = {}

    def points(fid):
        if fid not in memo:
            i = fid % len(seq)
            color, _ = scene.decode(seq, i)
            memo[fid] = ref_stereo.keypoint_points(
                g["keypoints"][fid], st["kp_disparity"][fid], color,
                seq.c2w[i], intr, st["baseline"], dtype)
        return memo[fid]
    return points


def growth_numbers(kept: dict, seq, intr: dict, mp) -> dict:
    """`growth_count_gap` and `growth_row_gap` of the window by the
    stereo rule (module docstring)."""
    g = kept["growth"]
    points = _points(kept, seq, intr)
    start = g["start"]
    # the pending batches are those of the last keyframes with inactive
    # geometry before the window
    pending, count_gap = [], 0
    for fid in reversed(start["keyframes"]):
        if len(pending) == len(start["pending"]):
            break
        if len(points(fid)["inactive"][0]):
            pending.insert(0, points(fid)["inactive"])
    count_gap += abs(len(pending) - len(start["pending"])) + sum(
        abs(len(p[0]) - n) for p, n in zip(pending, start["pending"]))
    cache = ref_growth.DepthCache(mp.depth_cache,
                                  mp.min_num_inactive_geo_densify, pending,
                                  start["since"])
    want = []
    for op in g["ops"]:
        batches = []
        for fid in op["fids"]:
            batches += cache.keyframe(points(fid))
        want.append(batches)
        count_gap += abs(op["added"] - sum(len(b[0]) for b in batches))
    row_gap = max([ref_growth.rows_gap(want[r["op"]], r["xyz"], r["f_dc"])
                   for r in g["rows"]], default=float("inf"))
    return dict(growth_count_gap=float(count_gap), growth_row_gap=row_gap)


def compare(kept: dict, seq, intr: dict, opt, mp, config: dict, enc_w,
            dev, limits: dict) -> dict:
    """{number: {"value", "limit"}} over everything the run kept."""
    # loop_check's growth numbers read a depth image, which a stereo
    # keyframe has not: they are replaced below
    with batches_without_pairs():
        out = loop_check.compare(
            dict(kept, growth=dict(kept["growth"], rows=[])), seq, intr,
            opt, mp, config, enc_w, dev, limits)
    st = kept["stereo"]
    nums = growth_numbers(kept, seq, intr, mp)
    nums.update(sgm_numbers(st["samples"], seq, mp, dev))
    nums["sgm_count_gap"] = float(abs(st["sgm_calls"] - st["keyframes"]))
    out.update({k: dict(value=v, limit=limits[k]) for k, v in nums.items()})
    return out


def control_numbers(kept: dict, seq, intr: dict, opt, mp, config: dict,
                    enc_w, dev) -> dict:
    """The numbers the control reads: the reference in the precision below
    the configuration's in the program's place (loop_check's control for
    the encoder and the step; the SGM's paths in bfloat16; the
    back-projection's positions in bfloat16)."""
    with batches_without_pairs():
        nums = loop_check.control_numbers(
            dict(kept, growth=dict(kept["growth"], rows=[])), seq, intr,
            opt, mp, config, enc_w, dev)
    st = kept["stereo"]
    low = []
    for fid, _ in st["samples"]:
        left, right = decode_pair(seq, fid % len(seq), dev)
        low.append((fid, ref_stereo.disparity(
            left, right, mp.stereo_num_disparity, mp.stereo_min_disparity,
            dtype=torch.bfloat16).cpu().numpy()))
    nums.update(sgm_numbers(low, seq, mp, dev))
    exact = _points(kept, seq, intr)
    gaps = []
    for r in kept["growth"]["rows"]:
        fids = kept["growth"]["ops"][r["op"]]["fids"]
        want = [exact(f)["map"] for f in fids]
        if not sum(len(w[0]) for w in want):
            continue
        xyz = torch.as_tensor(np.concatenate([w[0] for w in want])).to(
            torch.bfloat16).float()
        f_dc = (torch.as_tensor(np.concatenate([w[1] for w in want]))
                .double() - 0.5) / ref_growth.SH_C0
        gaps.append(ref_growth.rows_gap(want, xyz, f_dc))
    nums["growth_row_gap"] = max(gaps, default=float("inf"))
    return nums
