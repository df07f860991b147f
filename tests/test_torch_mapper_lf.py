"""legslam_torch's GaussianMapper against legslam_tpu's with language
features and pyramid training on.

tests/test_torch_mapper.py drives both packages' mappers with neither;
this file drives the same schedule (its OPT_KW, MP_KW, CFG_KW and app
loop) at 128x80 with a seeded 37x37x64 LF grid a keyframe and one pyramid
sub-level (64x40, two uses a keyframe), so the loss carries the LF term
and the keyframe levels alternate. The span cap starts at 5 tile rows,
which this scene never overflows: the escalations are that file's, and
each would cost JAX a recompile of both levels here. Both levels are at
least 37 px on each axis: the LF grid is then enlarged on both axes.
The two packages resize it alike there and where an axis shrinks, which
both antialias (test_lf_upsample_matches_where_an_axis_shrinks).

Stated tolerances: the losses before the first densify step within rtol
1e-5 (they agree to ~3e-7), and every loss within tests/test_torch_
mapper.py's rtol 1e-3 (after the densify, rounding grows through the LF
Adam steps to ~7e-4); the keyframe picks, cache invalidations and
densify counts equal, and no escalation on either side; the final valid mask and creation iterations exactly; the
parameters as in tests/test_torch_mapper.py, but for lang_feat, whose
elements are each held within 10 learning-rate steps of JAX's: ~2% of
them differ by more than the gradient tolerance, by at most ~2.5 steps,
as Adam moves an element by about one learning rate a step however
small its gradient, and rounding flips the sign of near-zero LF
gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.config import MapperParams as JaxMP
from legslam_tpu.config import OptimizationParams as JaxOpt
from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.mapper.mapper import GaussianMapper as JaxMapper
from legslam_tpu.slam.trajectory import TrajectoryFrontend as JaxFrontend
from legslam_torch.config import MapperParams, OptimizationParams
from legslam_torch.config import RasterizeConfig
from legslam_torch.data.synthetic import SyntheticDataset
from legslam_torch.mapper.mapper import GaussianMapper
from legslam_torch.mapper.train_step import upsample_lf
from legslam_torch.models import gaussians as G
from legslam_torch.slam.trajectory import TrajectoryFrontend

from .test_torch_mapper import CFG_KW, MP_KW, OPT_KW, SCENE, _drive
from .torch_parity import jax_state_tree, np_, t_

torch.set_num_threads(1)

H = 80
CFG_LF = dict(CFG_KW, max_span_y=5)
MP_LF = dict(MP_KW, do_gaus_pyramid_training=True,
             num_gaus_pyramid_sub_levels=1, gaus_pyramid_times_of_use=(2,))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ds = SyntheticDataset(**dict(SCENE, height=H), device="cpu")
    frames = [ds.read(i) for i in range(len(ds))]
    intr = ds.intrinsics
    rng = np.random.default_rng(0)
    lfs = [rng.normal(size=(37, 37, 64)).astype(np.float32)
           for _ in frames]
    kw = dict(capacity=1 << 12, max_per_tile=512, include_lang_feat=True,
              binning_refresh_interval=2, seed=0)
    fj = JaxFrontend(intr, kf_stride=1, max_corners=200)
    mj = JaxMapper(fj.queue, intr, opt=JaxOpt(**OPT_KW), mp=JaxMP(**MP_LF),
                   cfg=JaxCfg(**CFG_LF, backend="pallas",
                              pallas_interpret=True, pallas_sort=True),
                   result_dir=str(tmp_path_factory.mktemp("jax")), **kw)
    ft = TrajectoryFrontend(intr, kf_stride=1, max_corners=200)
    mt = GaussianMapper(ft.queue, intr, opt=OptimizationParams(**OPT_KW),
                        mp=MapperParams(**MP_LF),
                        cfg=RasterizeConfig(**CFG_LF, backend="cuda",
                                            cuda_sort=True),
                        result_dir=str(tmp_path_factory.mktemp("torch")),
                        device="cpu", **kw)
    return (_drive(mj, fj, frames, lfs), mj), (_drive(mt, ft, frames, lfs),
                                              mt)


def test_lf_pyramid_schedule_matches(runs):
    ((lj, pj, ij, dj), mj), ((lt, pt, it, dt), mt) = runs
    assert all(len(kf.views) == 2 and kf.gt_lf is not None
               for kf in mt.keyframes.values())
    assert min(kf.views[0].height for kf in mt.keyframes.values()) >= 37
    assert pt == pj and None not in pt
    assert it == ij
    assert mt.overflow_escalations == mj.overflow_escalations == []
    assert dt == dj and len(dt) == 1 and dt[0][2] > dt[0][1]
    n0 = dt[0][0]
    np.testing.assert_allclose(lt[:n0], lj[:n0], rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=1e-3)


def test_lf_pyramid_final_state_matches(runs):
    (_, mj), (_, mt) = runs
    tj, tt = jax_state_tree(mj.state), G.state_to_numpy(mt.state)
    np.testing.assert_array_equal(tt["valid"], tj["valid"])
    np.testing.assert_array_equal(tt["exist_since"], tj["exist_since"])
    opt = mt.opt
    lr = dict(xyz=opt.position_lr_init * mt.cameras_extent,
              f_dc=opt.feature_lr, f_rest=opt.feature_lr / 20,
              lang_feat=opt.lang_feature_lr, opacity=opt.opacity_lr,
              scaling=opt.scaling_lr, rotation=opt.rotation_lr)
    for n in G.GROUPS:
        a, b = tt["params"][n], tj["params"][n]
        bad = ~np.isclose(a, b, atol=2e-4 * np.abs(b).max(), rtol=2e-2)
        if n != "lang_feat":
            assert bad.mean() <= 5e-4, (n, bad.sum())
        assert np.all(np.abs(a - b)[bad] <= 10 * lr[n]), n
    assert np.abs(tt["params"]["lang_feat"]).max() > 0


@pytest.mark.parametrize("size", [(80, 128), (170, 300), (40, 64)])
def test_lf_upsample_matches_where_every_axis_grows(size):
    grid = np.random.default_rng(1).normal(size=(37, 37, 8)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(grid), (*size, 8), method="linear")
    np.testing.assert_allclose(np_(upsample_lf(t_(grid), *size)),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [(20, 64), (20, 20), (36, 200)])
def test_lf_upsample_matches_where_an_axis_shrinks(size):
    """jax.image.resize antialiases an axis it shrinks, and so does the
    port's F.interpolate(antialias=True)."""
    grid = np.random.default_rng(1).normal(size=(37, 37, 8)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(grid), (*size, 8), method="linear")
    np.testing.assert_allclose(np_(upsample_lf(t_(grid), *size)),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)
