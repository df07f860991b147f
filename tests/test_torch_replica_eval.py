"""legslam_torch.eval_harness.replica_eval against the JAX package's
harness on the tiny Replica layout of tests/test_torch_app.py, with the
same small-config encoder in both. The JAX side's first keyframe render
runs its XLA compositor eagerly and compiles op by op (~80 s on one CPU
thread), so this file has one test and takes ~2 minutes."""
import json
import os

import numpy as np

from tests.test_torch_app import SMALL, _small_weights
import torch

from tests.test_torch_app import replica_scene  # noqa: F401 (fixture)

torch.set_num_threads(1)


def _recording_mapper(module, seen):
    """module.GaussianMapper, recording each instance in `seen`."""
    class Recording(module.GaussianMapper):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)
    return Recording


def test_replica_eval_matches_jax(replica_scene, tmp_path,  # noqa: F811
                                  monkeypatch):
    """evaluate_scenes / run_scene with the same small encoder in both
    packages on the tiny scene: the keyframes' LF grids agree at the
    encoder's tolerance (atol 2e-4 / rtol 1e-3, tests/test_torch_encoder.py)
    and the eval_result files have the same lines, keys and format."""
    import jax.numpy as jnp

    from legslam_torch import config as TCfg
    from legslam_torch.eval_harness import replica_eval as TE
    from legslam_torch.models import dinov2 as TD
    from legslam_torch.models import weights_io as TW
    from legslam_tpu import config as JCfg
    from legslam_tpu.eval_harness import replica_eval as JE
    from legslam_tpu.models import dinov2 as JD
    from legslam_tpu.models import pca as JPCA
    from legslam_tpu.models import weights_io as JW
    from legslam_tpu.models.encoder import LanguageFeaturesEncoder
    wdir = _small_weights(str(tmp_path / "weights"))
    tenc = TW.load_encoder(wdir, device="cpu", cfg=TD.DinoV2Config(**SMALL))
    jenc = LanguageFeaturesEncoder(
        JW.load_params(os.path.join(wdir, "dinov2.npz")),
        JPCA.load(os.path.join(wdir, "pca.npz")), JD.DinoV2Config(**SMALL),
        dtype=jnp.bfloat16)
    runs = {}
    for name, mod, cfgmod, enc, extra in (
            ("torch", TE, TCfg, tenc, dict(device="cpu")),
            ("jax", JE, JCfg, jenc, {})):
        seen = []
        monkeypatch.setattr(mod, "GaussianMapper",
                            _recording_mapper(mod, seen))
        out = tmp_path / name
        res = mod.evaluate_scenes(
            str(replica_scene.parent), str(out), scenes=(replica_scene.name,),
            exp_name="tiny", kf_stride=2, capacity=4096, max_frames=6,
            encoder=enc,
            opt=cfgmod.OptimizationParams(densify_from_iter=1000,
                                          densification_interval=5),
            mp=cfgmod.MapperParams(min_num_initial_map_kfs=2,
                                   do_gaus_pyramid_training=False),
            cfg=cfgmod.RasterizeConfig(max_span_x=3, max_span_y=8,
                                       chunk=64, tile_batch=4), **extra)
        runs[name] = (seen[0], res, (out / "eval_result_tiny.log")
                      .read_text().splitlines())
    (tm, tres, tlog), (jm, jres, jlog) = runs["torch"], runs["jax"]
    assert sorted(tm.keyframes) == sorted(jm.keyframes) == [0, 2, 4]
    for fid in tm.keyframes:
        np.testing.assert_allclose(tm.keyframes[fid].gt_lf.numpy(),
                                   np.asarray(jm.keyframes[fid].gt_lf),
                                   atol=2e-4, rtol=1e-3)
    assert len(tlog) == len(jlog) == 2
    for a, b in zip(tlog, jlog):
        ja, jb = json.loads(a), json.loads(b)
        assert list(ja) == list(jb)
        if "average" in ja:
            assert list(ja["average"]) == list(jb["average"])
        else:
            assert {k: type(v) for k, v in ja.items()} == \
                {k: type(v) for k, v in jb.items()}
            assert ja["scene"] == jb["scene"] and ja["frames"] == 6
            assert np.isfinite(ja["psnr"]) and ja["n_gaussians"] > 0
    assert [r["scene"] for r in tres] == [r["scene"] for r in jres]
