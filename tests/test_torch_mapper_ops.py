"""The visual tracker's loop closure against JAX's, and the port's
GaussianMapper operation surgery against legslam_tpu's, fed that
tracker's recorded operation stream, on the CPU.

The scene is a small RGB-D loop: one revolution at 5.6 deg a frame, 64
frames at 160x96 (the JAX suite's loop scene, tests/test_tracking.py:162,
runs 40 frames at 320x192), rendered once. Both trackers run on it with
a redundancy cull that drops keyframes; their streams must agree as in
tests/test_torch_tracking.py, and a loop closes through the SE(3) pose
graph.

Then both mappers replay the port's stream (no training between
operations): handle_operation for LOCAL_BA (keyframes, BA pose updates,
point ingest) and LOOP_CLOSE_BA (per-keyframe pose deltas moving the
anchored gaussians), cull_keyframes against the tracker's live set after
each frame, initialize_map once its conditions hold; then the loop
operation published again as a Sim(3) loop (operation scale 1.25,
per-keyframe scales in [0.9, 1.1], as the monocular essential graph
publishes), and a SCALE_REFINEMENT that the tracker itself builds
(_apply_global_scale(1.3), then its pose packets, as its monocular and
inertial paths publish one). After every operation both mappers hold
the same keyframes and poses, the same valid mask and creation
iterations exactly, and the same parameters within the mapper parity
tolerance of tests/test_torch_mapper.py (atol 2e-4 x the group's largest
value, rtol 2e-2).
"""
import dataclasses

import numpy as np
import pytest
import torch

from legslam_torch.slam.interface import MappingOperation, OpKind
from tests.test_torch_tracking import (assert_frontends_equal,
                                       assert_streams_equal, render,
                                       run_both)
from tests.torch_native_pin import jax_native_pin

torch.set_num_threads(1)

# pytest finds fixtures by name in the module that uses them
jax_native_pin = jax_native_pin

LOOP = dict(n_frames=64, width=160, height=96, n_gaussians=5000,
            revolutions=1.0, radius=1.0, clutter_ratio=0.0)
MP_KW = dict(min_num_initial_map_kfs=3, depth_cache=2,
             do_gaus_pyramid_training=False)


class LiveSet:
    """The mappers' source: the live keyframes the tracker reported after
    the frame being replayed."""

    def __init__(self):
        self.live = set()

    def live_keyframe_ids(self):
        return self.live

    def is_shutdown(self):
        return False


@pytest.fixture(scope="module")
def loop_run(jax_native_pin):
    from legslam_tpu.slam import tracking as JT
    from legslam_torch.slam import tracking as TT
    intr, frames = render(**LOOP)
    mp = pytest.MonkeyPatch()
    mp.setenv("LEGSLAM_NATIVE_TRACKING", "1")
    marks = []
    try:
        assert JT._use_native() and TT._use_native()
        out = run_both((JT, TT), intr, frames, marks=marks,
                       ransac_thresh=0.1, loop_min_gap=8,
                       cull_redundancy=0.6)
    finally:
        mp.undo()
    return intr, out, marks


def test_loop_closure_matches(loop_run):
    _, (fj, jops, ft, tops), _ = loop_run
    assert ft.n_loop_closures >= 1 and ft.lost_frames == 0
    assert "LOOP_CLOSE_BA" in [o.kind.name for o in tops]
    assert ft.num_keyframes < ft.n_keyframes_created     # culled
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)


def _replay(loop_run):
    """[(ops, live set)] a frame: the port's recorded stream, then the
    Sim(3) loop and the tracker's SCALE_REFINEMENT as one more frame."""
    _, (_, _, ft, tops), marks = loop_run
    out, start = [], 0
    for end, live in marks:
        out.append((tops[start:end], live))
        start = end
    rng = np.random.default_rng(0)
    loop = next(o for o in tops if o.kind == OpKind.LOOP_CLOSE_BA)
    sim3 = dataclasses.replace(loop, scale=1.25, keyframes=[
        dataclasses.replace(p, scale=float(rng.uniform(0.9, 1.1)))
        for p in loop.keyframes])
    ft._apply_global_scale(1.3)
    scale = MappingOperation(
        kind=OpKind.SCALE_REFINEMENT, scale=1.3,
        keyframes=[ft._pose_packet(f) for f in ft._kf_order])
    out.append(([sim3, scale], marks[-1][1]))
    return out


def _mappers(intr, tmp_path):
    from legslam_tpu.config import MapperParams as JaxMP
    from legslam_tpu.mapper.mapper import GaussianMapper as JaxMapper
    from legslam_torch.config import MapperParams
    from legslam_torch.mapper.mapper import GaussianMapper
    src = LiveSet()
    kw = dict(capacity=1 << 14, include_lang_feat=False, seed=0)
    mj = JaxMapper(src, intr, mp=JaxMP(**MP_KW),
                   result_dir=str(tmp_path / "jax"), **kw)
    mt = GaussianMapper(src, intr, mp=MapperParams(**MP_KW),
                        result_dir=str(tmp_path / "torch"), device="cpu",
                        **kw)
    return src, mj, mt


def _assert_same(mj, mt, where):
    from legslam_torch.models import gaussians as G
    from tests.torch_parity import jax_state_tree
    assert sorted(mt.keyframes) == sorted(mj.keyframes), where
    for fid, kj in mj.keyframes.items():
        kt = mt.keyframes[fid]
        np.testing.assert_array_equal(kt.R, kj.R, err_msg=where)
        np.testing.assert_array_equal(kt.t, kj.t, err_msg=where)
        assert kt.remaining_times_of_use == kj.remaining_times_of_use, where
    assert (mt.state is None) == (mj.state is None), where
    if mt.state is None:
        assert len(mt._pending_points) == len(mj._pending_points), where
        return
    tj, tt = jax_state_tree(mj.state), G.state_to_numpy(mt.state)
    np.testing.assert_array_equal(tt["valid"], tj["valid"], err_msg=where)
    np.testing.assert_array_equal(tt["exist_since"], tj["exist_since"],
                                  err_msg=where)
    for n in G.GROUPS:
        a, b = tt["params"][n], tj["params"][n]
        np.testing.assert_allclose(a, b, atol=2e-4 * np.abs(b).max(),
                                   rtol=2e-2, err_msg=f"{where} {n}")


def test_operation_surgery_matches_jax(loop_run, tmp_path):
    intr = loop_run[0]
    src, mj, mt = _mappers(intr, tmp_path)
    seen = {}
    for frame, (ops, live) in enumerate(_replay(loop_run)):
        for k, op in enumerate(ops):
            xyz0 = None if mt.state is None else mt.state.params.xyz.clone()
            mj.handle_operation(op)
            mt.handle_operation(op)
            kind = op.kind.name + (" (Sim(3))" if op.scale != 1.0 and
                                   op.kind == OpKind.LOOP_CLOSE_BA else "")
            seen[kind] = seen.get(kind, 0) + 1
            _assert_same(mj, mt, f"frame {frame} op {k} {kind}")
            if op.scale != 1.0:
                # a scale moves the gaussians (the recorded loop's pose
                # deltas may fall under the mapper's large_rot_th /
                # large_trans_th and move none)
                assert not torch.equal(mt.state.params.xyz, xyz0), kind
        src.live = live
        n = len(mt.keyframes)
        mj.cull_keyframes()
        mt.cull_keyframes()
        if len(mt.keyframes) < n:
            seen["cull"] = seen.get("cull", 0) + n - len(mt.keyframes)
            _assert_same(mj, mt, f"frame {frame} cull")
        if mt.state is None and mt.has_met_initial_conditions():
            assert mj.has_met_initial_conditions()
            mj.initialize_map()
            mt.initialize_map()
            _assert_same(mj, mt, f"frame {frame} initialize_map")
    for kind in ("LOCAL_BA", "LOOP_CLOSE_BA", "LOOP_CLOSE_BA (Sim(3))",
                 "SCALE_REFINEMENT", "cull"):
        assert seen.get(kind, 0) >= 1, (kind, seen)
    assert int(mt.state.num_valid()) > 1000
