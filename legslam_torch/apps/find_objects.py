"""CLI: open-vocabulary object finding + orbit video.

Counterpart of legslam_tpu/apps/find_objects.py (eval/find_objects.py /
render_object.py / find_objects_gaussians.py): load a trained map PLY,
embed a query (a precomputed .npy, or an image through the CLIP vision
tower + Talk2DINO projection + PCA), find object instances, and write
heatmaps and orbit videos.

Two search modes:
  * gaussian-space (default): per-gaussian similarity -> DBSCAN clusters
    (eval/find_objects_gaussians.py).
  * --pixel-space: render every training camera from cameras.json,
    per-pixel similarity (+PAMR), best-frame selection, depth-weighted 3D
    center, heatmap overlays + an RGB/heatmap orbit video
    (eval/find_objects.py:229-434).

Renders go through the port's rasterizer with the "cuda" backend (the
hand-written compositing and sort kernels) and float32 pair features; the
JAX app renders with its XLA reference compositor. The cosine and PAMR run
on the render's device. `--query` needs the CLIP tokenizer, which the port
does not have (models/clip_text.tokenize raises): pass --text-emb or
--query-image. Heatmap JPEGs and videos need OpenCV (cv2).
`main(argv, device)` runs on "cuda" unless the caller passes "cpu".

  python -m legslam_torch.apps.find_objects --ply <point_cloud.ply> \
      --text-emb q.npy [--out ./output/objects] [--video]
  python -m legslam_torch.apps.find_objects --scene <experiment/ply> \
      --pixel-space --text-emb q.npy --video
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _cv2():
    """OpenCV, for the image and video artifacts."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "writing heatmap images and videos needs OpenCV (cv2), which "
            "is not installed; the search results above do not") from e
    return cv2


def _colormap_jet(heat: np.ndarray) -> np.ndarray:
    """uint8 BGR jet colormap of a [H, W] heat in [0, 1] (matches the
    reference's cv2.applyColorMap(COLORMAP_JET) video pane)."""
    cv2 = _cv2()
    h8 = np.uint8(np.clip(heat * 255, 0, 255))
    return cv2.applyColorMap(h8, cv2.COLORMAP_JET)


def load_map(ply_path: str, device: str | torch.device = "cuda"):
    """(GaussianState on `device` with capacity the next power of two
    >= max(256, n), the PLY's raw arrays)."""
    from legslam_torch.mapper.checkpoint import state_from_ply
    from legslam_torch.utils.ply import load_gaussian_ply
    raw = load_gaussian_ply(ply_path)
    n = raw["xyz"].shape[0]
    cap = max(256, 1 << int(np.ceil(np.log2(n))))
    return state_from_ply(ply_path, cap, device), raw


def make_renderer(st, cfg=None, max_per_tile: int = 2048):
    """render(R, t, width, height, fx, fy, include_lang_feat) -> the
    RasterizeOutput of the store `st` from a world->camera pose, on the
    store's device. `cfg` defaults to the "cuda" backend with float32 pair
    features; `max_per_tile` caps each tile's pairs on the "torch"
    compositor (rasterize's default)."""
    from legslam_torch.config import RasterizeConfig
    from legslam_torch.ops.rasterize import rasterize
    from legslam_torch.utils.camera import CameraView
    cfg = cfg or RasterizeConfig(backend="cuda")
    dev = st.params.xyz.device
    bg = torch.zeros(3, device=dev)

    @torch.no_grad()
    def render(R, t, width, height, fx, fy, include_lang_feat=True):
        view = CameraView.create(R, t, int(width), int(height), fx=fx, fy=fy,
                                 device=dev)
        return rasterize(
            st.params.xyz, st.sh(), st.params.lang_feat, st.opacities(),
            st.scales(), st.params.rotation, st.valid, view, bg, 3, cfg,
            include_lang_feat=include_lang_feat, max_per_tile=max_per_tile)
    return render


def build_render_fn(scene: str, device: str | torch.device = "cuda",
                    cfg=None, max_per_tile: int = 2048):
    """PLY -> render_fn loader of an experiment/ply dir (point_cloud +
    cameras.json): (render_fn, cameras, raw PLY arrays). render_fn(R, t,
    width, height, fx, fy) -> (rgb clipped to [0, 1], lf, depth) tensors on
    `device`, the contract of pixel_space_find_object; `cfg` and
    `max_per_tile` as in make_renderer."""
    with open(os.path.join(scene, "cameras.json")) as f:
        cameras = json.load(f)
    st, raw = load_map(os.path.join(scene, "point_cloud", "point_cloud.ply"),
                       device)
    render = make_renderer(st, cfg, max_per_tile)

    def render_fn(R, t, width, height, fx, fy):
        out = render(R, t, width, height, fx, fy)
        return out.color.clamp(0, 1), out.lang_feat, out.depth

    return render_fn, cameras, raw


def pamr_fn(rgb, cos):
    """PAMR at its defaults on one view's [H, W] cosine, on its device."""
    from legslam_torch.models.pamr import pamr
    return pamr(rgb, torch.as_tensor(cos)[..., None])[..., 0]


def run_pixel_space(args, text: np.ndarray, device) -> None:
    """The --pixel-space route (log_gaussian, eval/find_objects.py:229-434)."""
    from legslam_torch.eval_harness.find_objects import (
        find_bboxes, orbit_trajectory, pixel_space_find_object, to_host,
        view_cosine)

    render_fn, cameras, raw = build_render_fn(args.scene, device)
    pamr = None if args.no_pamr else pamr_fn
    res = pixel_space_find_object(
        render_fn, cameras, text, pamr_fn=pamr,
        scene_points=raw["xyz"], n_views=args.n_views, radius=args.radius)
    os.makedirs(args.out, exist_ok=True)
    if res.best_frame < 0:
        print("No object found above threshold.")
        return
    center = None if res.center is None else np.round(res.center, 3)
    print(f"best frame {res.best_frame}, center="
          f"{None if center is None else center.tolist()}, "
          f"{len(res.viewpoints)} valid viewpoints")

    cv2 = _cv2()
    # heatmap overlays for every training view (the rerun stream's panes
    # become on-disk artifacts here)
    for idx in range(res.heats.shape[0]):
        rgb8 = np.uint8(np.clip(res.images[idx] * 255, 0, 255))
        jet = _colormap_jet(res.heats[idx])
        overlay = cv2.addWeighted(
            cv2.cvtColor(rgb8, cv2.COLOR_RGB2BGR), 0.5, jet, 0.5, 0)
        cv2.imwrite(os.path.join(args.out, f"heat_{idx:04d}.jpg"), overlay)
    _, best_mask = find_bboxes(res.heats[res.best_frame])
    cv2.imwrite(os.path.join(args.out, "best_mask.png"),
                np.uint8(best_mask) * 255)

    if args.rerun:
        from legslam_torch.eval_harness.find_objects import stream_rerun
        if not stream_rerun(res, scene_points=raw["xyz"]):
            print("rerun SDK not available — skipped streaming "
                  "(artifacts on disk carry the same panes)")

    if args.video and res.center is not None:
        cam0 = cameras[0]
        w, h = int(cam0["width"]), int(cam0["height"])
        path = os.path.join(args.out, "object_pixelspace.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (w, 2 * h))
        te = text / max(np.linalg.norm(text), 1e-12)
        # stacked RGB + jet heatmap panes, 10 fps (find_objects.py:364-402)
        for R, t in orbit_trajectory(res.center, args.radius, args.n_views):
            rgb, lf, _ = render_fn(R, t, w, h, cam0["fx"], cam0["fy"])
            cos = view_cosine(lf, te)
            if pamr is not None:
                cos = pamr(rgb, cos)
            cos, rgb = to_host(cos), to_host(rgb)
            heat = 1.0 - (cos - cos.min()) / max(cos.max() - cos.min(),
                                                 1e-12)
            bgr = cv2.cvtColor(np.uint8(rgb * 255), cv2.COLOR_RGB2BGR)
            vw.write(np.vstack([bgr, _colormap_jet(heat)]))
        vw.release()
        print("wrote", path)


def query_embedding(args, device) -> np.ndarray:
    """The [64] query embedding of --text-emb, --query-image + --weights
    or --query + --weights (which raises: no tokenizer in the port)."""
    from legslam_torch.eval_harness.find_objects import to_host
    if args.text_emb:
        return np.load(args.text_emb).reshape(-1)
    if args.query_image and args.weights:
        from legslam_torch.data.datasets import _imread_color
        from legslam_torch.models.talk2dino import build_image_embedding
        from legslam_torch.models.weights_io import load_image_pipeline
        vision, proj, pca = load_image_pipeline(args.weights, device)
        return to_host(build_image_embedding(
            vision, proj, pca, _imread_color(args.query_image)))
    if args.query and args.weights:
        from legslam_torch.models.talk2dino import build_text_embedding
        from legslam_torch.models.weights_io import load_text_pipeline
        clip_params, proj, pca = load_text_pipeline(args.weights, device)
        return to_host(build_text_embedding(
            [args.query], clip_params, proj, pca))[0]
    raise SystemExit("provide --text-emb, --query-image + --weights, "
                     "or --query + --weights")


def main(argv=None, device: str | torch.device = "cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ply", default=None)
    ap.add_argument("--scene", default=None,
                    help="experiment/ply dir (point_cloud + cameras.json) "
                         "for --pixel-space")
    ap.add_argument("--pixel-space", action="store_true")
    ap.add_argument("--no-pamr", action="store_true")
    ap.add_argument("--query", default=None,
                    help="text query (needs the CLIP tokenizer, which the "
                         "port does not have: use --text-emb)")
    ap.add_argument("--query-image", default=None,
                    help="image-as-query: CLIP vision tower -> Talk2DINO "
                         "projection -> PCA, the same embedding space as "
                         "text (needs --weights with clip_vision.npz)")
    ap.add_argument("--weights", default=None,
                    help="converted weights dir (clip_text/talk2dino/pca)")
    ap.add_argument("--text-emb", default=None,
                    help=".npy with a precomputed [64] query embedding")
    ap.add_argument("--out", default="./output/objects")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--rerun", action="store_true",
                    help="stream panes to a rerun.io viewer when the SDK "
                    "is installed (eval/find_objects.py:404-434)")
    ap.add_argument("--n-views", type=int, default=60)
    ap.add_argument("--radius", type=float, default=1.5)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    args = ap.parse_args(argv)

    from legslam_torch.eval_harness.find_objects import (
        find_objects_in_gaussians, orbit_trajectory)
    from legslam_torch.utils.ply import load_gaussian_ply

    text = query_embedding(args, device)
    if args.pixel_space:
        if not args.scene:
            raise SystemExit("--pixel-space needs --scene <experiment/ply>")
        run_pixel_space(args, text, device)
        return
    if not args.ply:
        raise SystemExit("gaussian-space mode needs --ply")
    raw = load_gaussian_ply(args.ply)

    dets = find_objects_in_gaussians(raw["xyz"], raw["lang_feat"], text)
    print(f"{len(dets)} object instance(s) for query")
    os.makedirs(args.out, exist_ok=True)
    for i, d in enumerate(dets[:5]):
        print(f"  #{i}: center={np.round(d.center, 3).tolist()} "
              f"gaussians={d.n_gaussians} score={d.score:.3f}")

    if not args.video or not dets:
        return

    cv2 = _cv2()
    st, _ = load_map(args.ply, device)
    render = make_renderer(st)
    for i, det in enumerate(dets[:3]):
        path = os.path.join(args.out, f"object_{i}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (args.width, args.height))
        for R, t in orbit_trajectory(det.center, args.radius, args.n_views):
            out = render(R, t, args.width, args.height, 0.8 * args.width,
                         0.8 * args.width, include_lang_feat=False)
            img = (out.color.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
            vw.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        vw.release()
        print("wrote", path)


if __name__ == "__main__":
    main()
