"""The evaluation entry points' default compositor, on the CPU.

eval_harness/replica_eval.run_scene without a `cfg` trains and renders on
the "cuda" backend with float32 pair features (the kernels on a card,
their plain versions on CPU tensors); ScanNet's evaluate_scenes and the
server's /run_legs_slam reach it through run_scene. JAX's run_scene
without a cfg renders with its XLA reference compositor, so the two
packages' defaults are held against each other on tests/test_torch_app.py's
tiny Replica layout: the same keyframes, and the keyframe metrics within
the tolerances below.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_app import replica_scene  # noqa: F401 (fixture)

torch.set_num_threads(1)

# 6 frames, a keyframe every 2nd, 1 iteration a frame and the 4-iteration
# tail (densification interval 5) at capacity 4096, as
# tests/test_torch_replica_eval.py runs both harnesses
RUN = dict(kf_stride=2, capacity=4096, max_frames=6)
# measured on this fixture: psnr 6.4e-7 dB, ssim 5.0e-8, depth_l1_cm
# 4.1e-5 apart (the port's plain kernel versions against JAX's XLA
# reference); the gates leave 50-200x of that
PSNR_ATOL, SSIM_ATOL, DEPTH_ATOL = 1e-4, 1e-5, 2e-3


def _params(cfgmod):
    return dict(opt=cfgmod.OptimizationParams(densify_from_iter=1000,
                                              densification_interval=5),
                mp=cfgmod.MapperParams(min_num_initial_map_kfs=2,
                                       do_gaus_pyramid_training=False))


def _recording(module, seen, **mapper_kw):
    """module.GaussianMapper, recording in `seen` each instance and the
    cfg it was given (the mapper's own cfg follows its capacity ladder's
    pair budget); mapper_kw are added to its arguments."""
    class Recording(module.GaussianMapper):
        def __init__(self, *a, **k):
            super().__init__(*a, **k, **mapper_kw)
            self.given_cfg = k["cfg"]
            seen.append(self)
    return Recording


class _Built(Exception):
    """Raised once the harness has built its mapper."""


def _cfg_given(module, call, monkeypatch):
    """The cfg run_scene hands its GaussianMapper when `call` runs it."""
    given = []

    class Stop(module.GaussianMapper):
        def __init__(self, *a, **k):
            given.append(k["cfg"])
            raise _Built
    monkeypatch.setattr(module, "GaussianMapper", Stop)
    with pytest.raises(_Built):
        call()
    return given[0]


def test_run_scene_default_cfg_is_cuda(replica_scene, tmp_path,  # noqa: F811
                                       monkeypatch):
    """With no cfg the harness's mapper gets the "cuda" backend with
    float32 pair features and the rest of RasterizeConfig's defaults; a
    cfg the caller passes is handed on as it is."""
    from legslam_torch import config as C
    from legslam_torch.eval_harness import replica_eval as TE
    got = _cfg_given(TE, lambda: TE.run_scene(
        str(replica_scene), str(tmp_path), device="cpu"), monkeypatch)
    assert got == C.RasterizeConfig(backend="cuda", mm_dtype="float32")
    mine = C.RasterizeConfig(chunk=64, tile_batch=4)
    assert _cfg_given(TE, lambda: TE.run_scene(
        str(replica_scene), str(tmp_path), cfg=mine, device="cpu"),
        monkeypatch) is mine


def test_run_scene_default_matches_jax(replica_scene, tmp_path,  # noqa: F811
                                       monkeypatch):
    """run_scene(cfg=None) in both packages on the same layout: the same
    keyframes, frames and gaussian count, and psnr / ssim / depth_l1_cm
    within PSNR_ATOL / SSIM_ATOL / DEPTH_ATOL. No encoder (the LF path is
    held by tests/test_torch_replica_eval.py). Both mappers cap a tile at
    256 pairs on their reference compositors (the port's "cuda" backend
    has no cap): JAX's first XLA render takes 151 s at the default 2048
    and 16 s at 256, with the same metrics (no tile of this scene holds
    more; tools/eval_cpu_figures.py jax-render)."""
    from legslam_torch import config as TC
    from legslam_torch.eval_harness import replica_eval as TE
    from legslam_tpu import config as JC
    from legslam_tpu.eval_harness import replica_eval as JE
    out = {}
    for name, mod, cfgmod, extra in (("torch", TE, TC, dict(device="cpu")),
                                     ("jax", JE, JC, {})):
        seen = []
        monkeypatch.setattr(mod, "GaussianMapper",
                            _recording(mod, seen, max_per_tile=256))
        res = mod.run_scene(str(replica_scene), str(tmp_path / name),
                            **RUN, **_params(cfgmod), **extra)
        out[name] = (seen[0], res)
    (tm, tr), (jm, jr) = out["torch"], out["jax"]
    assert tm.cfg.backend == "cuda" and jm.cfg.backend == "xla"
    assert sorted(tm.keyframes) == sorted(jm.keyframes) == [0, 2, 4]
    assert tr["frames"] == jr["frames"] == 6
    assert tr["n_gaussians"] == jr["n_gaussians"] > 0
    assert tr["ate_rmse"] == pytest.approx(jr["ate_rmse"], abs=1e-7)
    assert tr["psnr"] == pytest.approx(jr["psnr"], abs=PSNR_ATOL)
    assert tr["ssim"] == pytest.approx(jr["ssim"], abs=SSIM_ATOL)
    assert tr["depth_l1_cm"] == pytest.approx(jr["depth_l1_cm"],
                                              abs=DEPTH_ATOL)
    assert np.isfinite([tr["psnr"], tr["ssim"], tr["depth_l1_cm"]]).all()


def test_run_legs_slam_trains_on_cuda_backend(replica_scene,  # noqa: F811
                                              tmp_path, monkeypatch):
    """/run_legs_slam's handler passes no cfg, so its mapper resolves to
    the "cuda" backend through run_scene; it completes on the CPU with
    finite metrics. The harness runs with a small store and a short tail
    (capacity 4096, densification interval 5) so the CPU takes seconds."""
    from legslam_torch import config as C
    from legslam_torch.eval_harness import replica_eval as TE
    from legslam_torch.serving import api
    seen, calls = [], []
    monkeypatch.setattr(TE, "GaussianMapper", _recording(TE, seen))
    run_scene = TE.run_scene

    def small(*a, **k):
        calls.append(k)
        return run_scene(*a, capacity=4096, **_params(C), **k)
    monkeypatch.setattr(TE, "run_scene", small)
    res = api.handle_run_legs_slam(api.ServiceState(device="cpu"), {
        "dataset_path": str(replica_scene),
        "output_path": str(tmp_path / "out"), "max_frames": 4})
    assert res["status"] == "completed", res
    assert "cfg" not in calls[0] and calls[0]["device"] == "cpu"
    assert seen[0].cfg.backend == "cuda"
    assert seen[0].cfg.mm_dtype == "float32"
    assert seen[0].device.type == "cpu"
    m = res["metrics"]
    assert m["frames"] == 4 and m["n_gaussians"] > 0
    assert np.isfinite([m["psnr"], m["ssim"], m["depth_l1_cm"]]).all()
