"""Multi-prompt labeled object detection over training frames.

Counterpart of legslam_tpu/eval_harness/detect_objects.py (host numpy, a
copy; a render function may return tensors, as in
eval_harness/find_objects.pixel_space_find_object). Parity reference:
eval/detect_objects.py — render every training camera from cameras.json, per-pixel cosine similarity of the rendered language
features vs each prompt embedding (optionally PAMR-refined with the
rendered RGB, detect_objects.py:107-112), a GLOBAL min-max inversion over
the whole frame stack (detect_objects.py:122-123), then per-frame bbox
extraction on the smoothed-threshold mask at threshold 0.8
(detect_objects.py:131 find_bboxes) and an annotated RGB + heat video /
rerun stream. The reference drives one prompt per run; this core takes a
LIST of prompts and labels each box with its prompt.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from legslam_torch.eval_harness.find_objects import (
    to_host, view_cosine, find_bboxes, global_inverted_similarity)

DETECT_THRESHOLD = 0.8  # eval/detect_objects.py:131


@dataclasses.dataclass
class FrameDetections:
    """Per-frame labeled detections."""
    frame: int
    # prompt index -> list of (x0, y0, x1, y1) boxes
    boxes: dict[int, list[tuple[int, int, int, int]]]


@dataclasses.dataclass
class DetectionResult:
    prompts: list[str]
    images: np.ndarray        # [N, H, W, 3] rendered RGB (f32, 0..1)
    heats: np.ndarray         # [Q, N, H, W] per-prompt inverted heats
    frames: list[FrameDetections]

    def counts(self) -> dict[str, int]:
        """Total detections per prompt over all frames."""
        out = {p: 0 for p in self.prompts}
        for fd in self.frames:
            for qi, boxes in fd.boxes.items():
                out[self.prompts[qi]] += len(boxes)
        return out


def detect_objects_in_frames(
        render_fn: Callable, cameras: Sequence[dict],
        text_embs: np.ndarray, prompts: Sequence[str],
        pamr_fn: Optional[Callable] = None,
        threshold: float = DETECT_THRESHOLD,
        min_size: int = 20) -> DetectionResult:
    """Render each camera once, score all prompts against it, and extract
    labeled boxes per frame.

    render_fn(R, t, width, height, fx, fy) -> (rgb [H,W,3], lf [H,W,64],
    depth [H,W]), arrays or tensors; cameras are cameras.json entries
    (rotation = camera-to-world R, position = camera center) — the same
    contract as pixel_space_find_object. text_embs is [Q, 64], one row
    per prompt.
    """
    te = np.asarray(text_embs, np.float32)
    te = te / np.linalg.norm(te, axis=-1, keepdims=True).clip(1e-12)
    sims, images = [], []
    for cam in cameras:
        c2w_R = np.asarray(cam["rotation"], np.float32)
        center = np.asarray(cam["position"], np.float32)
        R = c2w_R.T
        t = -(R @ center)
        rgb, lf, _depth = render_fn(R, t, cam["width"], cam["height"],
                                    cam["fx"], cam["fy"])
        cos = [view_cosine(lf, q) for q in te]
        if pamr_fn is not None:
            cos = [pamr_fn(rgb, c) for c in cos]
        sims.append(np.stack([to_host(c) for c in cos]))
        images.append(to_host(rgb))
    sims = np.stack(sims, axis=1)          # [Q, N, H, W]
    images = np.stack(images)
    # global min-max inversion PER PROMPT over its whole stack, so a
    # frame's heat is comparable across the trajectory
    # (detect_objects.py:122-123)
    heats = np.stack([global_inverted_similarity(sims[q])
                      for q in range(sims.shape[0])])

    frames = []
    for idx in range(images.shape[0]):
        boxes: dict[int, list] = {}
        for q in range(heats.shape[0]):
            bb, _ = find_bboxes(heats[q, idx], threshold=threshold,
                                min_size=min_size)
            if bb:
                boxes[q] = bb
        frames.append(FrameDetections(frame=idx, boxes=boxes))
    return DetectionResult(prompts=list(prompts), images=images,
                           heats=heats, frames=frames)


# distinct BGR colors per prompt for the annotated panes (cycled)
_LABEL_COLORS = [(0, 0, 255), (0, 200, 0), (255, 128, 0), (0, 215, 255),
                 (255, 0, 255), (255, 255, 0), (128, 0, 255), (0, 128, 255)]


def annotate_frame(rgb: np.ndarray, fd: FrameDetections,
                   prompts: Sequence[str]) -> np.ndarray:
    """uint8 BGR frame with labeled boxes drawn per prompt (the
    reference draws plain red rectangles, detect_objects.py:133-135;
    labels are the multi-prompt extension)."""
    import cv2
    bgr = cv2.cvtColor(np.uint8(np.clip(rgb * 255, 0, 255)),
                       cv2.COLOR_RGB2BGR).copy()
    for qi, boxes in sorted(fd.boxes.items()):
        color = _LABEL_COLORS[qi % len(_LABEL_COLORS)]
        for (x0, y0, x1, y1) in boxes:
            cv2.rectangle(bgr, (x0, y0), (x1, y1), color, 2)
            cv2.putText(bgr, prompts[qi], (x0, max(y0 - 4, 12)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                        cv2.LINE_AA)
    return bgr


def stream_rerun_detections(res: DetectionResult,
                            app_id: str = "legslam_torch_detect",
                            scene_points: Optional[np.ndarray] = None
                            ) -> bool:
    """Stream annotated frames + per-prompt heat panes to a rerun viewer
    (the reference's blueprint: camera/image + camera/lf_dist +
    camera/binary_mask, detect_objects.py:143-186). Labeled boxes go out
    as rr.Boxes2D per prompt. No-op (returns False) without the SDK."""
    try:
        import rerun as rr  # type: ignore
    except ImportError:
        return False
    rr.init(app_id, spawn=True)
    if scene_points is not None:
        rr.log("world/points", rr.Points3D(scene_points))
    for fd in res.frames:
        idx = fd.frame
        rr.set_time_sequence("frame", idx)
        rr.log("camera/image",
               rr.Image(np.uint8(np.clip(res.images[idx] * 255, 0, 255)),
                        color_model="RGB"))
        for q, prompt in enumerate(res.prompts):
            rr.log(f"camera/lf_dist/{q}",
                   rr.DepthImage(res.heats[q, idx], depth_range=(0, 1)))
        mins, sizes, labels = [], [], []
        for qi, boxes in sorted(fd.boxes.items()):
            for (x0, y0, x1, y1) in boxes:
                mins.append([x0, y0])
                sizes.append([x1 - x0, y1 - y0])
                labels.append(res.prompts[qi])
        if mins:
            rr.log("camera/image/detections",
                   rr.Boxes2D(mins=mins, sizes=sizes, labels=labels))
    return True
