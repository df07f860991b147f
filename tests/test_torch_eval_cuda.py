"""The evaluation and offline entry points on the card against the plain
compositor and the CPU, without JAX, so this file also runs on a machine
with a card (the JAX conftest skipped):

    python -m pytest --noconftest tests/test_torch_eval_cuda.py -q

Marker `cuda`: skipped without a card. On a 12-frame 160x96 Replica layout
of the synthetic room (chip_smoke.write_replica):
* eval_harness/replica_eval.run_scene with no cfg trains on the kernels,
  and each keyframe's render from the trained store on the kernels equals
  the "torch" compositor's at the forward tolerance (chip_smoke's
  renders_agree), with the harness's metrics from the two within 1e-3;
* apps/train_offline.main's first train_step, card against CPU on the
  same inputs, within chip_smoke's cross_step (the loss at the forward's
  rtol, the moments and statistics at step_ok's tolerances, the
  parameters wherever the gradient is above the gradient tolerance);
* its checkpoint loads on the CPU and on the card equal to the store it
  saved, bit for bit.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs

torch.set_num_threads(1)

ROOM = dict(n_frames=12, width=160, height=96, n_gaussians=3000, seed=0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def replica_layout(tmp_path_factory):
    """The room rendered on the CPU at the Replica reader's camera and
    written as a Replica layout; returns the scene directory."""
    saved = cs.EVAL_ROOM
    cs.EVAL_ROOM = ROOM
    try:
        frames, _, _ = cs.eval_room(torch.device("cpu"))
    finally:
        cs.EVAL_ROOM = saved
    return cs.write_replica(tmp_path_factory.mktemp("replica") / "room0",
                            frames)


def eval_renders(dev, scene, out_dir):
    """run_scene with no cfg on `dev` (a keyframe every 2nd frame, the map
    from 2 keyframes, 3 iterations a frame, capacity 2^14); returns the
    launches in the call, the mapper, and per keyframe (renders_agree,
    the kernels' metrics, the plain compositor's)."""
    from legslam_torch.config import MapperParams, OptimizationParams
    from legslam_torch.eval_harness import replica_eval as RE
    rec = cs.Recorder(RE).install()
    try:
        res, launches = cs.count_launches(dev, lambda: RE.run_scene(
            scene, str(out_dir), kf_stride=2, capacity=1 << 14,
            iterations_per_frame=3, device=dev,
            opt=OptimizationParams(densify_from_iter=10,
                                   densification_interval=10),
            mp=MapperParams(min_num_initial_map_kfs=2)))
    finally:
        rec.restore()
    mapper = rec.mappers[0]
    rows = []
    for _, kf in sorted(mapper.keyframes.items()):
        a, b = cs.kf_render(mapper, kf), cs.plain_render(mapper, kf)
        rows.append((cs.renders_agree(a, b), cs.kf_metrics(a, kf),
                     cs.kf_metrics(b, kf)))
    return res, launches, mapper, rows


@pytest.mark.cuda
def test_eval_renders_on_kernels_match_plain(replica_layout, tmp_path):
    dev = _card()
    res, launches, mapper, rows = eval_renders(dev, replica_layout, tmp_path)
    assert mapper.cfg.backend == "cuda" and mapper.cfg.mm_dtype == "float32"
    assert all(n > 0 for n in launches.values()), launches
    assert np.isfinite([res["psnr"], res["ssim"], res["depth_l1_cm"]]).all()
    assert len(rows) == 6
    for (ok, n_out, err, where), ma, mb in rows:
        assert ok, (n_out, err, where)
        for k in ma:
            assert ma[k] == pytest.approx(mb[k], rel=1e-3), k


def offline_first_step(dev, scene, out_dir):
    """apps/train_offline.main for 2 iterations on `dev` with a StepSpy on
    train_step and the checkpoint's store kept: (card step, CPU step on
    the same inputs, (checkpoint path, saved store))."""
    from legslam_torch.apps import train_offline
    from legslam_torch.mapper import checkpoint as CK
    from legslam_torch.mapper import train_step as TS
    from legslam_torch.models import gaussians as G
    spy, save, saved = cs.StepSpy(TS.train_step, dev), CK.save_checkpoint, []

    def kept(path, state, meta=None):
        saved.append((path, G.copy_state(state)))
        return save(path, state, meta)
    TS.train_step, CK.save_checkpoint = spy, kept
    try:
        train_offline.main(["--data", scene, "--out", str(out_dir),
                            "--iterations", "2", "--frame-stride", "2",
                            "--capacity", str(1 << 14), "--device",
                            dev.type])
    finally:
        TS.train_step, CK.save_checkpoint = spy.step, save
    seed, a, k, card_st, card_loss = spy.first
    cpu_st, cpu_aux = spy.step(cs.to_cpu(seed), *map(cs.to_cpu, a),
                               **{n: cs.to_cpu(v) for n, v in k.items()})
    return (card_st, card_loss), (cpu_st, float(cpu_aux.loss)), saved[-1]


@pytest.mark.cuda
def test_train_offline_step_card_matches_cpu(replica_layout, tmp_path):
    dev = _card()
    (card_st, l_card), (cpu_st, l_cpu), _ = offline_first_step(
        dev, replica_layout, tmp_path)
    assert card_st.valid.device.type == "cuda"
    ok, errs = cs.cross_step(cs.to_cpu(card_st), cpu_st, l_card, l_cpu)
    assert ok, errs


@pytest.mark.cuda
def test_checkpoint_round_trip(replica_layout, tmp_path):
    dev = _card()
    from legslam_torch.mapper.checkpoint import load_checkpoint
    from legslam_torch.models import gaussians as G
    _, _, (path, st) = offline_first_step(dev, replica_layout, tmp_path)
    for where in ("cpu", dev):
        got, meta = load_checkpoint(path, device=where)
        assert meta == {"iterations": 2}
        for x, y in zip(G.state_tensors(st), G.state_tensors(got)):
            assert y.device.type == torch.device(where).type
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
