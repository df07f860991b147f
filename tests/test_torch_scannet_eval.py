"""legslam_torch.eval_harness.scannet_eval against the JAX package: the
open-vocabulary segmentation scoring of tests/test_scannet_miou.py's
two-class scene and tests/test_eval_and_serving.py's fake mapper through
both packages, with the same inputs: the same confusion matrix bit for
bit and the same scores; evaluate_scenes' wiring and log; the label
mapping reader; the comparison video."""
import json

import numpy as np
import pytest
import torch

from legslam_torch.eval_harness import scannet_eval as TS
from legslam_tpu.eval_harness import scannet_eval as JS

torch.set_num_threads(1)

V1 = np.zeros(64, np.float32)
V1[0] = 1.0
V2 = np.zeros(64, np.float32)
V2[1] = 1.0
TEXT_EMBS = np.stack([V1, V2])


class _Out:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _View:
    def __init__(self, w, h):
        self.width, self.height = w, h


class _KF:
    def __init__(self, R, t, w, h, color):
        self.R, self.t, self.views = R, t, [_View(w, h)]
        self.gt_color = [color]


class ReplayMapper:
    """Keyframes whose renders are fixed arrays; `tensors` hands them out
    as tensors, as the port's mapper does."""

    def __init__(self, renders, tensors):
        self.renders, self.tensors = renders, tensors
        self.keyframes = {
            fid: _KF(np.eye(3, dtype=np.float32), np.full(3, fid, np.float32),
                     r["lang_feat"].shape[1], r["lang_feat"].shape[0],
                     self._cast(r["gt_color"]))
            for fid, r in renders.items()}

    def _cast(self, a):
        return torch.as_tensor(np.array(a)) if self.tensors else a

    def render_from_pose(self, R, t, w, h, include_lang_feat=True):
        r = self.renders[int(t[0])]
        return _Out(**{k: self._cast(v) for k, v in r.items()})


@pytest.fixture(scope="module")
def two_class_scene():
    """tests/test_scannet_miou.py's scene, cut to 6 frames: gaussians
    carry V1 or V2 by world x-sign; each frame's LF, final_t and color
    rendered once (JAX's rasterizer), with noise standing in for a
    trained map's error, and its GT labels."""
    import jax.numpy as jnp

    from legslam_tpu.config import RasterizeConfig
    from legslam_tpu.data.synthetic import SyntheticDataset
    from legslam_tpu.ops.rasterize import rasterize
    from legslam_tpu.utils.camera import CameraView
    from legslam_tpu.utils.sh import rgb_to_sh
    ds = SyntheticDataset(n_frames=6, width=128, height=64, n_gaussians=1500,
                          seed=5, clutter_ratio=0.0)
    lf_g = np.where((ds._xyz[:, 0] > 0.0)[:, None], V2[None], V1[None])
    sh = np.zeros((ds._xyz.shape[0], 16, 3), np.float32)
    sh[:, 0] = np.asarray(rgb_to_sh(ds._colors))
    cfg = RasterizeConfig(tile_h=16, tile_w=128, max_span_x=3, max_span_y=8,
                          chunk=64, tile_batch=4)
    intr = ds.intrinsics
    rng = np.random.default_rng(0)
    renders, labels = {}, {}
    for i in range(len(ds)):
        w2c = np.linalg.inv(ds._poses[i])
        view = CameraView.create(w2c[:3, :3], w2c[:3, 3], intr["width"],
                                 intr["height"], fx=intr["fx"], fy=intr["fy"])
        out = rasterize(ds._xyz, sh, lf_g.astype(np.float32), ds._opacity,
                        ds._scales, ds._quats,
                        np.ones(ds._xyz.shape[0], bool), view, jnp.zeros(3),
                        active_sh_degree=0, cfg=cfg, include_lang_feat=True,
                        max_per_tile=1024)
        lf = np.asarray(out.lang_feat)
        hit = 1.0 - np.asarray(out.final_t) > 0.5
        labels[i] = np.where(hit, np.where(lf @ V1 > lf @ V2, 1, 2),
                             0).astype(np.int32)
        # a trained map renders -v (the +cos loss anti-aligns), with error
        pred = -lf + rng.normal(scale=0.05, size=lf.shape).astype(np.float32)
        renders[i] = dict(lang_feat=pred, final_t=np.asarray(out.final_t),
                          color=np.asarray(out.color),
                          gt_color=np.asarray(out.color))
    return renders, labels


@pytest.mark.parametrize("min_alpha,reject", [(0.0, 0.7), (0.3, 0.55)])
def test_segmentation_scoring_matches_jax(two_class_scene, min_alpha,
                                          reject):
    renders, labels = two_class_scene
    kw = dict(frame_ids=sorted(renders), num_classes=3, every_nth=1,
              reject_threshold=reject, min_alpha=min_alpha)
    got = TS.evaluate_segmentation(ReplayMapper(renders, True), TEXT_EMBS,
                                   lambda fid: labels[fid], **kw)
    want = JS.evaluate_segmentation(ReplayMapper(renders, False), TEXT_EMBS,
                                    lambda fid: labels[fid], **kw)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert got["confusion"].sum() > 0
    for k in ("miou", "macc", "covered_frac"):
        assert got[k] == want[k]
    for k in ("per_class_iou", "per_class_acc"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["miou"] > 0.5


def test_fake_mapper_scoring_matches_jax():
    """tests/test_eval_and_serving.py's fake mapper: class 1 on the left,
    class 2 on the right, at 64x32, every frame scored."""
    text = np.eye(3, 64, dtype=np.float32)
    lf = np.zeros((32, 64, 64), np.float32)
    lf[:, :32] = -text[0] * 5
    lf[:, 32:] = -text[1] * 5
    renders = {f: dict(lang_feat=lf, final_t=np.zeros((32, 64), np.float32),
                       color=np.zeros((32, 64, 3), np.float32),
                       gt_color=np.zeros((32, 64, 3), np.float32))
               for f in (0, 1)}
    gt = np.zeros((32, 64), np.int64)
    gt[:, :32] = 1
    gt[:, 32:] = 2
    kw = dict(frame_ids=[0, 1], num_classes=4, every_nth=1)
    got = TS.evaluate_segmentation(ReplayMapper(renders, True), text,
                                   lambda fid: gt, **kw)
    want = JS.evaluate_segmentation(ReplayMapper(renders, False), text,
                                    lambda fid: gt, **kw)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert got["miou"] == want["miou"] > 0.95


def test_evaluate_scenes_threads_segmentation(tmp_path, monkeypatch,
                                              two_class_scene):
    """evaluate_scenes with text embeddings and a label loader: the same
    result dicts and log lines as JAX's (miou, macc, per-class IoU), the
    port's log named after its exp_name."""
    renders, labels = two_class_scene
    scene_root = tmp_path / "scenes"
    (scene_root / "scene0000_00").mkdir(parents=True)
    logs = {}
    for name, mod, tensors in (("torch", TS, True), ("jax", JS, False)):
        def fake_run_scene(scene_dir, out_dir, return_mapper=False,
                           **kwargs):
            r = dict(scene="scene0000_00", frames=6, fps=1.0, psnr=20.0,
                     ssim=0.8, depth_l1_cm=1.0, ate_rmse=0.0,
                     output=str(out_dir))
            if return_mapper:
                r["_mapper"] = ReplayMapper(renders, tensors)
            return r
        monkeypatch.setattr(mod, "run_scene", fake_run_scene)
        out = tmp_path / name
        res = mod.evaluate_scenes(
            str(scene_root), str(out), ["scene0000_00"], text_embs=TEXT_EMBS,
            label_loader_factory=lambda scene: (lambda fid: labels[fid]),
            every_nth=1, exp_name="tiny")
        assert len(res) == 1 and "_mapper" not in res[0]
        logs[name] = (res[0], (out / "eval_result_tiny.log").read_text())
    (tr, tlog), (jr, jlog) = logs["torch"], logs["jax"]
    assert {k: v for k, v in tr.items() if k != "output"} == \
        {k: v for k, v in jr.items() if k != "output"}
    assert [json.loads(x).get("average") for x in tlog.splitlines()] == \
        [json.loads(x).get("average") for x in jlog.splitlines()]
    assert "miou" in tlog


def test_load_label_mapping(tmp_path):
    tsv = tmp_path / "scannetv2-labels.combined.tsv"
    tsv.write_text("id\traw_category\tnyu40id\n1\twall\t1\n2\tchair\t5\n"
                   "3\tbad\tx\n4\n")
    assert TS.load_label_mapping(str(tsv)) == \
        JS.load_label_mapping(str(tsv)) == {1: 1, 2: 5}


def test_comparison_video(tmp_path, two_class_scene):
    """The 2x2 comparison artifact from the port's tensors."""
    renders, labels = two_class_scene
    path = TS.create_comparison_video(
        ReplayMapper(renders, True), TEXT_EMBS, lambda fid: labels[fid],
        sorted(renders), str(tmp_path / "vid"), reject_threshold=0.55)
    assert path is not None and (tmp_path / "vid" / "comparison.mp4") \
        .stat().st_size > 1000
