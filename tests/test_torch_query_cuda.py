"""The query stack on the card against the same code on the CPU, without
JAX, so this file also runs on a machine with a card (the JAX conftest
skipped):

    python -m pytest --noconftest tests/test_torch_query_cuda.py -q

Marker `cuda`: skipped without a card. Small configs, seeded weights:
* the text pipeline (CLIP text width 64, 2 layers, 7 templates, the
  Talk2DINO projection 32 -> 48, PCA 48 -> 8) and the image pipeline
  (CLIP vision at 32x32): atol 1e-4 on unit-norm embeddings (float32 on
  both devices, TF32 off; the card sums the products in another order);
* PAMR at its defaults on 48x80 with 2 masks: atol 1e-5;
* LPIPS(alex) at 64x64: rtol 1e-4;
* the pixel-space search over a small PLY scene (a wall of 2,560
  gaussians with an LF patch, two 160x96 cameras) on the "cuda" backend
  (the compositing and sort kernels) against the "torch" compositor on
  the card: the same best frame and mask, heats within 1e-3 and the
  center within 1e-3 m (the kernel and the plain compositor may flip a
  termination at rounding, ROADMAP.md section 3).
"""
import json
import os

import numpy as np
import pytest
import torch

from legslam_torch.models import clip_text as CT
from legslam_torch.models import clip_vision as CV
from legslam_torch.models import lpips as L
from legslam_torch.models import pca as PCA
from legslam_torch.models import talk2dino as T2D
from legslam_torch.models.pamr import pamr

torch.set_num_threads(1)

TEXT = CT.ClipTextConfig(vocab=99, context=16, width=64, layers=2, heads=2,
                         proj_dim=32)
VISION = CV.ClipVisionConfig(image_size=32, patch=16, width=64, layers=2,
                             heads=2, proj_dim=32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weights(dev):
    g = torch.Generator().manual_seed(0)
    text = CT.init_params(TEXT, g, device=dev)
    vision = CV.init_params(VISION, g, device=dev)
    proj = T2D.init_projection(g, clip_dim=32, dino_dim=48, device=dev)
    comps = torch.randn(8, 48, generator=g)
    pca = PCA.PCAParams(torch.zeros(48, device=dev), comps.to(dev))
    return text, vision, proj, pca


def _tokens():
    rng = np.random.default_rng(1)
    toks = np.zeros((3 * 7, 16), np.int32)
    for i in range(len(toks)):
        n = int(rng.integers(1, 14))
        toks[i, 0] = 97
        toks[i, 1:n + 1] = rng.integers(1, 97, size=n)
        toks[i, n + 1] = 98
    return toks.reshape(3, 7, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["text", "image"])
def test_query_pipelines_card_match_cpu(which):
    dev = _card()
    out = []
    for d in ("cpu", dev):
        text, vision, proj, pca = _weights(d)
        if which == "text":
            out.append(T2D.build_text_embedding(
                ["a", "b", "c"], text, proj, pca, tokens=_tokens(),
                clip_cfg=TEXT).cpu())
        else:
            rgb = np.random.default_rng(2).uniform(size=(40, 60, 3)) \
                .astype(np.float32)
            out.append(T2D.build_image_embedding(
                vision, proj, pca, rgb, vision_cfg=VISION).cpu())
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
def test_pamr_card_matches_cpu():
    dev = _card()
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.uniform(size=(48, 80, 3)).astype(np.float32))
    masks = torch.as_tensor(rng.uniform(size=(48, 80, 2)).astype(np.float32))
    want = pamr(img, masks)
    got = pamr(img.to(dev), masks.to(dev)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_lpips_card_matches_cpu():
    dev = _card()
    tree = L.init_params(np.random.default_rng(4))
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    want = L.lpips(L.params_from_numpy(tree, "cpu"), a, b)
    got = L.lpips(L.params_from_numpy(tree, dev), a, b).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4)


def write_wall_scene(path):
    """experiment/ply layout: a wall of near-opaque gaussians at z = 2
    filling two 160x96 cameras (fx 60), an LF patch anti-aligned with
    e_0 among e_2 features."""
    from legslam_torch.utils.ply import save_gaussian_ply
    w, h, fx, z = 160, 96, 60.0, 2.0
    px, py = np.meshgrid(np.linspace(0, w - 1, 64), np.linspace(0, h - 1, 40))
    xyz = np.stack([(px - w / 2 + 0.5) / fx * z, (py - h / 2 + 0.5) / fx * z,
                    np.full_like(px, z)], -1).reshape(-1, 3)
    n = xyz.shape[0]
    lf = np.zeros((n, 64), np.float32)
    lf[:, 2] = 1.0
    patch = ((px >= 20) & (px <= 70) & (py >= 25) & (py <= 75)).reshape(-1)
    lf[patch] = 0.0
    lf[patch, 0] = -1.0
    os.makedirs(os.path.join(path, "point_cloud"))
    save_gaussian_ply(
        os.path.join(path, "point_cloud", "point_cloud.ply"), xyz,
        np.full((n, 1, 3), 0.5, np.float32), np.zeros((n, 15, 3), np.float32),
        lf, np.full((n, 1), 4.0, np.float32),
        np.full((n, 3), np.log(0.06), np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)))
    cams = [dict(id=i, width=w, height=h, position=[0.02 * i, 0.0, 0.0],
                 rotation=np.eye(3).tolist(), fx=fx, fy=fx) for i in range(2)]
    with open(os.path.join(path, "cameras.json"), "w") as f:
        json.dump(cams, f)


@pytest.mark.cuda
def test_pixel_space_search_kernels_match_torch_compositor(tmp_path):
    from legslam_torch.apps.find_objects import build_render_fn, pamr_fn
    from legslam_torch.config import RasterizeConfig
    from legslam_torch.eval_harness.find_objects import \
        pixel_space_find_object
    from legslam_torch.ops.cuda import composite as cf
    dev = _card()
    write_wall_scene(str(tmp_path))
    text = np.zeros(64, np.float32)
    text[0] = 1.0
    res = {}
    for backend in ("cuda", "torch"):
        render_fn, cams, raw = build_render_fn(
            str(tmp_path), dev, RasterizeConfig(backend=backend))
        cf.composite_forward.launches = 0
        res[backend] = pixel_space_find_object(
            render_fn, cams, text, pamr_fn=pamr_fn, scene_points=raw["xyz"])
        if backend == "cuda":
            assert cf.composite_forward.launches == len(cams)
    got, want = res["cuda"], res["torch"]
    assert got.best_frame == want.best_frame >= 0
    np.testing.assert_array_equal(got.best_mask, want.best_mask)
    np.testing.assert_allclose(got.heats, want.heats, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.center, want.center, atol=1e-3, rtol=0)
