"""Open-vocabulary object finding + orbit rendering.

Counterpart of legslam_tpu/eval_harness/find_objects.py: host numpy, a
copy of the JAX module's functions, with one addition: a render function
may return tensors (the port's renderer on the card), and the search then
takes each view's cosine and PAMR on their device and copies only the
[H, W] cosine, RGB and depth to the host (`view_cosine`, `to_host`).

Parity references:
  - pixel-space: render training cams, per-pixel cosine sim vs text,
    min-max inversion, box-filter + threshold masks (find_bboxes,
    eval/find_objects.py:198-227,302-310), best-frame selection,
    depth-weighted 3D center (compute_3d_center, :36-108),
    fibonacci-sphere viewpoints (:110-137).
  - gaussian-space: per-gaussian cosine sim, threshold 0.94, DBSCAN
    (eps=0.16, min_samples=5) cluster centers, orbit cameras
    (eval/render_object.py:85-120, eval/find_objects_gaussians.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from legslam_torch.utils import runtime

PIXEL_MASK_THRESHOLD = 0.5     # eval/find_objects.py:310
BOX_FILTER = 30                # 30x30 smoothing (find_bboxes)
GAUSSIAN_SIM_THRESHOLD = 0.94  # eval/render_object.py:55
DBSCAN_EPS = 0.16
DBSCAN_MIN_SAMPLES = 5


def inverted_similarity(lf: np.ndarray, text_emb: np.ndarray) -> np.ndarray:
    """1 - minmax(cos) per text row (the eval-side inversion; see
    SURVEY.md §3.3)."""
    lfn = lf / np.linalg.norm(lf, axis=-1, keepdims=True).clip(1e-12)
    te = text_emb / np.linalg.norm(text_emb, axis=-1, keepdims=True) \
        .clip(1e-12)
    sim = np.einsum("...c,nc->n...", lfn, te)
    flat = sim.reshape(sim.shape[0], -1)
    lo = flat.min(-1).reshape((-1,) + (1,) * (sim.ndim - 1))
    hi = flat.max(-1).reshape((-1,) + (1,) * (sim.ndim - 1))
    return 1.0 - (sim - lo) / np.maximum(hi - lo, 1e-12)


def box_filter(img: np.ndarray, k: int = BOX_FILTER) -> np.ndarray:
    """Mean filter via integral image (the reference uses a 30x30 box)."""
    pad = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    pad[1:, 1:] = np.cumsum(np.cumsum(img, 0), 1)
    h, w = img.shape
    r = k // 2
    ys = np.arange(h)
    xs = np.arange(w)
    y0 = np.clip(ys - r, 0, h)
    y1 = np.clip(ys + r + 1, 0, h)
    x0 = np.clip(xs - r, 0, w)
    x1 = np.clip(xs + r + 1, 0, w)
    area = (y1 - y0)[:, None] * (x1 - x0)[None, :]
    s = pad[y1][:, x1] - pad[y1][:, x0] - pad[y0][:, x1] + pad[y0][:, x0]
    return (s / area).astype(np.float32)


def find_masks(heat: np.ndarray,
               threshold: float = PIXEL_MASK_THRESHOLD) -> np.ndarray:
    """Smoothed-heatmap threshold mask (find_bboxes,
    eval/find_objects.py:198-227): the binary mask thresholds the mean of
    the 30x30 box-filtered heat and the raw heat (0.5 each), suppressing
    noise while keeping sharp boundaries."""
    return 0.5 * (box_filter(heat) + heat) > threshold


def find_bboxes(heat: np.ndarray,
                threshold: float = PIXEL_MASK_THRESHOLD,
                min_size: int = 20) -> tuple[list, np.ndarray]:
    """Connected-component bounding boxes of the smoothed-threshold mask
    (find_bboxes, eval/find_objects.py:198-227). Returns
    ([(x0, y0, x1, y1), ...], binary mask); boxes smaller than `min_size`
    on either side are dropped like the reference's 20-px filter."""
    mask = find_masks(heat, threshold)
    boxes = []
    try:
        import cv2
        n, comp = cv2.connectedComponents(mask.astype(np.uint8))
        label_ids = range(1, n)
    except ImportError:  # pragma: no cover
        from scipy import ndimage
        comp, n = ndimage.label(mask)
        label_ids = range(1, n + 1)
    for lbl in label_ids:
        ys, xs = np.nonzero(comp == lbl)
        if not len(ys):
            continue
        x0, x1 = int(xs.min()), int(xs.max()) + 1
        y0, y1 = int(ys.min()), int(ys.max()) + 1
        if (x1 - x0) > min_size and (y1 - y0) > min_size:
            boxes.append((x0, y0, x1, y1))
    return boxes, mask


def global_inverted_similarity(cos_stack: np.ndarray) -> np.ndarray:
    """1 - minmax(cos) normalized over the WHOLE frame stack
    (eval/find_objects.py:301-303 normalizes across all rendered views at
    once so per-frame heats are comparable for best-frame selection)."""
    lo, hi = cos_stack.min(), cos_stack.max()
    return 1.0 - (cos_stack - lo) / max(hi - lo, 1e-12)


def select_best_frame(heat_stack: np.ndarray,
                      threshold: float = PIXEL_MASK_THRESHOLD
                      ) -> tuple[int, Optional[np.ndarray]]:
    """Best-frame rule (eval/find_objects.py:306-344): per frame, sum the
    above-threshold pixel count inside each detected bbox; the frame with
    the largest total wins. Returns (best_idx or -1, best binary mask
    restricted to the winning frame's bboxes)."""
    best_idx, best_area, best_mask = -1, 0, None
    for idx in range(heat_stack.shape[0]):
        heat = heat_stack[idx]
        boxes, _ = find_bboxes(heat, threshold)
        if not boxes:
            continue
        hot = heat > threshold
        area = sum(int(hot[y0:y1, x0:x1].sum()) for x0, y0, x1, y1 in boxes)
        if area > best_area:
            best_area = area
            best_idx = idx
            m = np.zeros_like(hot)
            for x0, y0, x1, y1 in boxes:
                m[y0:y1, x0:x1] = hot[y0:y1, x0:x1]
            best_mask = m
    return best_idx, best_mask


def is_valid_viewpoint(position: np.ndarray, target: np.ndarray,
                       points: np.ndarray, min_distance: float = 0.1,
                       max_distance: float = 10.0) -> bool:
    """Viewpoint filter (eval/find_objects.py:172-196): not too far from
    the object, not inside scene geometry."""
    if np.linalg.norm(position - target) > max_distance:
        return False
    if len(points) and \
            np.linalg.norm(points - position, axis=1).min() < min_distance:
        return False
    return True


def compute_3d_center(heat: np.ndarray, depth: np.ndarray,
                      view_R: np.ndarray, view_t: np.ndarray,
                      fx: float, fy: float, cx: float, cy: float,
                      threshold: float = PIXEL_MASK_THRESHOLD,
                      mask: Optional[np.ndarray] = None
                      ) -> Optional[np.ndarray]:
    """Similarity-weighted back-projected center of the masked region
    (compute_3d_center, eval/find_objects.py:36-108). Deliberate fix vs
    the reference: it reads fx/fy/cx/cy out of the 4x4 *pose* matrix
    (find_objects.py:66-67), which yields rotation entries — we take real
    intrinsics. Pass `mask` (e.g. the best-frame bbox mask from
    select_best_frame) to override the default smoothed-threshold mask."""
    if mask is None:
        mask = find_masks(heat, threshold)
    mask = mask & (depth > 0)
    if not mask.any():
        return None
    ys, xs = np.nonzero(mask)
    w = heat[ys, xs]
    d = depth[ys, xs]
    cam = np.stack([(xs - cx) / fx * d, (ys - cy) / fy * d, d], -1)
    world = (cam - view_t) @ view_R
    return (world * w[:, None]).sum(0) / max(w.sum(), 1e-12)


def fibonacci_sphere_viewpoints(center: np.ndarray, radius: float,
                                n: int = 32) -> np.ndarray:
    """[n, 3] camera positions on a fibonacci sphere around the object
    (eval/find_objects.py:110-137)."""
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    # endpoint formulation (y: 1 -> -1 inclusive), matching
    # generate_sphere_points (eval/find_objects.py:125-134)
    y = 1.0 - 2.0 * i / max(n - 1, 1)
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    dirs = np.stack([r * np.cos(theta), y, r * np.sin(theta)], -1)
    return center[None] + radius * dirs


def orbit_trajectory(center: np.ndarray, radius: float,
                     n: int = 120, height: float = 0.0) -> list:
    """Azimuthal orbit poses looking at the center
    (eval/render_object.py:95-127; the reference samples 1000 azimuth
    steps). Returns list of (R, t) world->camera."""
    poses = []
    for k in range(n):
        a = 2 * np.pi * k / n
        eye = center + np.array([radius * np.cos(a), height,
                                 radius * np.sin(a)])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
        w2c = np.linalg.inv(c2w)
        poses.append((w2c[:3, :3].astype(np.float32),
                      w2c[:3, 3].astype(np.float32)))
    return poses


def to_host(x) -> np.ndarray:
    """numpy copy of a tensor (from any device), or the array itself."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def view_cosine(lf, te: np.ndarray) -> torch.Tensor:
    """Per-pixel cosine [H, W] of a rendered LF image [H, W, C] (array or
    tensor) with the unit text embedding te [C], on the LF's device."""
    lf = torch.as_tensor(lf)
    lfn = lf / torch.linalg.norm(lf, dim=-1, keepdim=True).clamp_min(1e-12)
    return lfn @ torch.as_tensor(te, device=lf.device)


@dataclasses.dataclass
class PixelSpaceResult:
    """Output of the pixel-space object search (eval/find_objects.py
    log_gaussian first pass, :259-347)."""
    best_frame: int                      # -1 when nothing found
    center: Optional[np.ndarray]         # [3] world, or None
    heats: np.ndarray                    # [N, H, W] globally inverted sims
    best_mask: Optional[np.ndarray]      # [H, W] bool bbox-restricted mask
    images: np.ndarray                   # [N, H, W, 3] rendered RGB
    depths: np.ndarray                   # [N, H, W]
    viewpoints: np.ndarray               # [K, 3] valid orbit cam positions


def pixel_space_find_object(render_fn, cameras: Sequence[dict],
                            text_emb: np.ndarray, pamr_fn=None,
                            scene_points: Optional[np.ndarray] = None,
                            threshold: float = PIXEL_MASK_THRESHOLD,
                            n_views: int = 8, radius: float = 2.0
                            ) -> PixelSpaceResult:
    """All-training-cams pixel-space search (eval/find_objects.py:259-357).

    render_fn(R, t, width, height, fx, fy) -> (rgb [H,W,3] f32,
    lf [H,W,64], depth [H,W]), numpy arrays or tensors (then pamr_fn gets
    the tensors); cameras are cameras.json entries (rotation =
    camera-to-world R, position = camera center). Per frame: per-pixel
    cosine similarity vs the text embedding, optional PAMR refinement with
    the rendered RGB, then a GLOBAL min-max inversion over the stack;
    best-frame selection by bbox-restricted high-intensity area; 3D center
    from the best frame's depth; fibonacci-sphere viewpoints filtered by
    is_valid_viewpoint.
    """
    te = np.asarray(text_emb, np.float32).reshape(-1)
    te = te / max(np.linalg.norm(te), 1e-12)
    sims, images, depths, poses = [], [], [], []
    for cam in cameras:
        c2w_R = np.asarray(cam["rotation"], np.float32)
        center = np.asarray(cam["position"], np.float32)
        R = c2w_R.T                       # world->camera
        t = -(R @ center)
        rgb, lf, depth = render_fn(R, t, cam["width"], cam["height"],
                                   cam["fx"], cam["fy"])
        cos = view_cosine(lf, te)
        if pamr_fn is not None:
            cos = pamr_fn(rgb, cos)
        sims.append(to_host(cos))
        images.append(to_host(rgb))
        depths.append(to_host(depth))
        poses.append((R, t, cam))
    sims = np.stack(sims)
    images = np.stack(images)
    depths = np.stack(depths)
    heats = global_inverted_similarity(sims)

    best_idx, best_mask = select_best_frame(heats, threshold)
    center3d = None
    viewpoints = np.zeros((0, 3), np.float32)
    if best_idx >= 0:
        R, t, cam = poses[best_idx]
        cx = cam.get("cx", cam["width"] / 2.0 - 0.5)
        cy = cam.get("cy", cam["height"] / 2.0 - 0.5)
        center3d = compute_3d_center(
            heats[best_idx], depths[best_idx], R, t, cam["fx"], cam["fy"],
            cx, cy, threshold, mask=best_mask)
        if center3d is not None:
            pts = scene_points if scene_points is not None else \
                np.zeros((0, 3), np.float32)
            cand = fibonacci_sphere_viewpoints(center3d, radius, n_views)
            viewpoints = np.asarray(
                [p for p in cand if is_valid_viewpoint(p, center3d, pts)],
                np.float32).reshape(-1, 3)
    return PixelSpaceResult(best_frame=best_idx, center=center3d,
                            heats=heats, best_mask=best_mask,
                            images=images, depths=depths,
                            viewpoints=viewpoints)


@dataclasses.dataclass
class ObjectDetection:
    center: np.ndarray
    n_gaussians: int
    score: float


def find_objects_in_gaussians(xyz: np.ndarray, lang_feat: np.ndarray,
                              text_emb: np.ndarray,
                              sim_threshold: float = GAUSSIAN_SIM_THRESHOLD,
                              eps: float = DBSCAN_EPS,
                              min_samples: int = DBSCAN_MIN_SAMPLES
                              ) -> list[ObjectDetection]:
    """Gaussian-space object finding (eval/find_objects_gaussians.py):
    inverted per-gaussian similarity > threshold -> DBSCAN clusters ->
    centers."""
    with runtime.span("search.similarity"):
        heat = inverted_similarity(lang_feat, text_emb[None])[0]
        sel = heat > sim_threshold
        if sel.sum() < min_samples:
            return []
        pts = xyz[sel]
        scores = heat[sel]
    with runtime.span("search.cluster"):
        try:
            from sklearn.cluster import DBSCAN
            labels = DBSCAN(eps=eps,
                            min_samples=min_samples).fit(pts).labels_
        except ImportError:  # pragma: no cover
            labels = np.zeros(len(pts), np.int64)
        out = []
        for lbl in sorted(set(labels) - {-1}):
            m = labels == lbl
            out.append(ObjectDetection(
                center=pts[m].mean(0), n_gaussians=int(m.sum()),
                score=float(scores[m].mean())))
    out.sort(key=lambda d: -d.n_gaussians)
    return out


def stream_rerun(res: "PixelSpaceResult", app_id: str = "legslam_torch",
                 scene_points: Optional[np.ndarray] = None,
                 threshold: float = 0.5) -> bool:
    """Stream the pixel-space search panes to a rerun.io viewer
    (eval/find_objects.py:404-434: camera/image + camera/lf_dist +
    camera/binary_mask + camera/best_semantic_mask per view, plus the
    sparse scene points). Returns False (no-op) when the `rerun` SDK is
    not importable — the offline image ships without it; the on-disk
    heat_*.jpg artifacts carry the same content."""
    try:
        import rerun as rr  # type: ignore
    except ImportError:
        return False
    rr.init(app_id, spawn=True)
    if scene_points is not None:
        rr.log("world/points", rr.Points3D(scene_points))
    if res.center is not None:
        rr.log("world/object_center", rr.Points3D(res.center[None]))
    best_mask = res.best_mask
    for idx in range(res.heats.shape[0]):
        rr.set_time_sequence("view", idx)
        rr.log("camera/image",
               rr.Image(np.uint8(np.clip(res.images[idx] * 255, 0, 255)),
                        color_model="RGB"))
        rr.log("camera/lf_dist",
               rr.DepthImage(res.heats[idx], depth_range=(0, 1)))
        _, binary_mask = find_bboxes(res.heats[idx], threshold=threshold)
        rr.log("camera/binary_mask",
               rr.DepthImage(binary_mask.astype(np.float32),
                             depth_range=(0, 1)))
        if best_mask is not None:
            rr.log("camera/best_semantic_mask",
                   rr.DepthImage(best_mask.astype(np.float32),
                                 depth_range=(0, 1)))
    return True
