"""legslam_torch.eval_harness.{find_objects,detect_objects} and the two
query apps against the JAX package: the scenes of
tests/test_find_objects_pixelspace.py, tests/test_detect_objects.py and
tests/test_eval_and_serving.py through both packages (the host numpy
functions give the same results), and the pixel-space search over a
small PLY scene rendered by each package: the port's "torch" compositor
and its "cuda" backend (on the CPU: the kernels' plain versions) against
JAX's "xla" reference, with each package's PAMR."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_torch.eval_harness import detect_objects as TD
from legslam_torch.eval_harness import find_objects as TF
from legslam_tpu.eval_harness import detect_objects as JD
from legslam_tpu.eval_harness import find_objects as JF
from tests.test_detect_objects import _cameras, _tiny_scene_dir, \
    _two_prompt_scene
from tests.test_find_objects_pixelspace import CX, CY, FX, FY, H, W, \
    _blob_heat

torch.set_num_threads(1)


def _same(a, b, atol=0.0):
    """Recursive equality of results (dataclasses, dicts, sequences,
    arrays), arrays within atol."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        for k in a.__dataclass_fields__:
            _same(getattr(a, k), getattr(b, k), atol)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k], atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, atol)
    elif a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=atol,
                                   rtol=0)


def _pixel_cases():
    heat = _blob_heat(20, 70, 40, 100)
    stack = np.stack([_blob_heat(30, 60, 30, 60), _blob_heat(20, 80, 30, 120),
                      np.zeros((H, W), np.float32)])
    depth = np.full((H, W), 2.0, np.float32)
    pts = np.array([[0.5, 0.0, 0.0]], np.float32)
    cos = np.stack([np.full((4, 4), -1.0), np.zeros((4, 4))])
    img = np.random.default_rng(0).uniform(size=(20, 25)).astype(np.float32)
    return {
        "find_bboxes": lambda m: m.find_bboxes(heat),
        "find_bboxes_small": lambda m: m.find_bboxes(
            _blob_heat(10, 25, 10, 25)),
        "box_filter": lambda m: m.box_filter(img, k=5),
        "select_best_frame": lambda m: m.select_best_frame(stack),
        "compute_3d_center": lambda m: m.compute_3d_center(
            _blob_heat(40, 60, 70, 100), depth, np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32), FX, FY, CX, CY),
        "viewpoints": lambda m: [m.is_valid_viewpoint(np.array(p), np.zeros(3),
                                                      pts)
                                 for p in ([2.0, 0, 0], [20.0, 0, 0],
                                           [0.55, 0, 0])],
        "fibonacci": lambda m: m.fibonacci_sphere_viewpoints(
            np.zeros(3), 2.0, n=16),
        "orbit": lambda m: m.orbit_trajectory(np.array([1.0, 0, 0]), 1.5,
                                              n=8),
        "global_inversion": lambda m: m.global_inverted_similarity(cos),
        "inverted_similarity": lambda m: m.inverted_similarity(
            np.random.default_rng(1).normal(size=(6, 7, 16)),
            np.random.default_rng(2).normal(size=(3, 16))),
    }


@pytest.mark.parametrize("name", list(_pixel_cases()))
def test_pixel_helpers_match_jax(name):
    case = _pixel_cases()[name]
    _same(case(TF), case(JF))


def _fake_render_fn(as_tensor):
    """tests/test_find_objects_pixelspace.py's scene: the object (LF =
    -text) only in the view of camera 1."""
    text = np.zeros(64, np.float32)
    text[0] = 1.0
    other = np.zeros(64, np.float32)
    other[1] = 1.0

    def render_fn(R, t, width, height, fx, fy):
        rgb = np.full((height, width, 3), 0.3, np.float32)
        lf = np.tile(other, (height, width, 1))
        depth = np.full((height, width), 4.0, np.float32)
        if int(t[0]) == 1:
            lf[30:70, 60:120] = -text
            depth[30:70, 60:120] = 2.0
            rgb[30:70, 60:120] = 0.9
        if as_tensor:
            return tuple(torch.as_tensor(a) for a in (rgb, lf, depth))
        return rgb, lf, depth
    cams = [dict(id=i, width=W, height=H, position=[float(-i), 0.0, 0.0],
                 rotation=np.eye(3).tolist(), fx=FX, fy=FY) for i in range(3)]
    return render_fn, cams, text


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pixel_space_search_matches_jax(as_tensor):
    """The search on the fake scene: frame 1, the same center, heats and
    viewpoints as JAX, whether the render function gives arrays or
    tensors."""
    render_t, cams, text = _fake_render_fn(as_tensor)
    render_j, _, _ = _fake_render_fn(False)
    kw = dict(scene_points=np.zeros((0, 3), np.float32), n_views=12,
              radius=1.5)
    got = TF.pixel_space_find_object(render_t, cams, text, **kw)
    want = JF.pixel_space_find_object(render_j, cams, text, **kw)
    assert got.best_frame == want.best_frame == 1
    _same(got, want, atol=1e-6)


def test_detect_objects_match_jax():
    """The two-prompt scene: the same labeled boxes, heats and counts."""
    render_fn, te, prompts = _two_prompt_scene()
    got = TD.detect_objects_in_frames(render_fn, _cameras(3), te, prompts)
    want = JD.detect_objects_in_frames(render_fn, _cameras(3), te, prompts)
    assert got.counts() == want.counts() == {"chair": 1, "table": 1}
    _same(got, want, atol=1e-6)
    bgr_t = TD.annotate_frame(got.images[0], got.frames[0], prompts)
    bgr_j = JD.annotate_frame(want.images[0], want.frames[0], prompts)
    np.testing.assert_array_equal(bgr_t, bgr_j)


def test_stream_rerun_graceful_without_sdk():
    render_fn, te, prompts = _two_prompt_scene()
    res = TD.detect_objects_in_frames(render_fn, _cameras(2), te, prompts)
    pres = TF.pixel_space_find_object(*_fake_render_fn(False))
    try:
        import rerun  # noqa: F401
        expected = True
    except ImportError:
        expected = False
    assert TD.stream_rerun_detections(res) is expected
    assert TF.stream_rerun(pres, scene_points=np.zeros((4, 3))) is expected


def test_find_objects_in_gaussians_matches_jax():
    """tests/test_eval_and_serving.py's two-cluster scene (DBSCAN through
    sklearn here; a single cluster where it is missing, in both): the same
    detections."""
    rng = np.random.default_rng(0)
    target = np.zeros(16, np.float32)
    target[0] = 1.0
    xyz = np.concatenate([
        rng.normal(scale=0.02, size=(50, 3)) + [1, 0, 0],
        rng.normal(scale=0.02, size=(40, 3)) + [-1, 0, 0],
        rng.normal(scale=2.0, size=(400, 3))]).astype(np.float32)
    lf = rng.normal(size=(490, 16)).astype(np.float32)
    lf[:90] = -target * 5
    kw = dict(sim_threshold=0.9, eps=0.3)
    got = TF.find_objects_in_gaussians(xyz, lf, target, **kw)
    want = JF.find_objects_in_gaussians(xyz, lf, target, **kw)
    assert len(got) >= 2
    _same(got, want)


def _jax_pamr(rgb, cos):
    from legslam_tpu.models.pamr import pamr
    return np.asarray(pamr(jnp.asarray(rgb), jnp.asarray(cos)[..., None])
                      )[..., 0]


@pytest.mark.parametrize("backend,pamr", [("torch", False), ("torch", True),
                                          ("cuda", True)])
def test_pixel_space_search_on_a_ply_scene(tmp_path, backend, pamr):
    """tests/test_detect_objects.py's on-disk map (a wall of 2,560
    gaussians, two LF patches) searched for prompt 0 by each package's
    apps' render function, with or without each package's PAMR: the
    port's compositor (`backend`) against JAX's "xla". The same best frame
    and mask, the center within 1e-4 m, heats within 1e-4 without PAMR
    (measured 2.4e-7: the renders agree to 4e-7) and 5e-4 with it
    (measured 1.45e-4 at 5 of 30,720 pixels: PAMR divides the neighbour
    differences by their spread, which on this flat wall is itself
    rounding noise, so renders 4e-7 apart weigh neighbours differently)."""
    from legslam_torch.apps.find_objects import build_render_fn, pamr_fn
    from legslam_torch.config import RasterizeConfig
    from legslam_tpu.apps.detect_objects import \
        build_render_fn as jax_build_render_fn
    scene = _tiny_scene_dir(tmp_path)
    text = np.zeros(64, np.float32)
    text[0] = 1.0
    render_t, cams, raw = build_render_fn(
        str(scene), "cpu", RasterizeConfig(backend=backend))
    render_j, cams_j, _ = jax_build_render_fn(str(scene))
    assert cams == cams_j
    kw = dict(scene_points=raw["xyz"], n_views=8, radius=1.0)
    got = TF.pixel_space_find_object(render_t, cams, text,
                                     pamr_fn=pamr_fn if pamr else None, **kw)
    want = JF.pixel_space_find_object(render_j, cams, text,
                                      pamr_fn=_jax_pamr if pamr else None,
                                      **kw)
    assert got.best_frame == want.best_frame >= 0
    np.testing.assert_allclose(got.heats, want.heats,
                               atol=5e-4 if pamr else 1e-4, rtol=0)
    assert got.center is not None
    np.testing.assert_allclose(got.center, want.center, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.best_mask, want.best_mask)
