"""ScanNet evaluation harness (eval/scannet_test.py equivalent).

Counterpart of legslam_tpu/eval_harness/scannet_eval.py: host numpy over
the port's mapper, whose renders are tensors on its device (copied to the
host per keyframe, `to_host`). Adds open-vocabulary semantic segmentation
scoring on top of the Replica photometric harness: per-frame rendered
language features -> per-pixel argmax over class text embeddings with the (1-cos)/2 >= 0.7 rejection rule
(eval/scannet_test.py:295-310), confusion matrix -> mIoU/mAcc
(eval/metric_utils.py:96-197), every-Nth-frame subsampling (:273).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from legslam_torch.eval_harness import metrics
from legslam_torch.eval_harness.find_objects import to_host
from legslam_torch.eval_harness.replica_eval import run_scene


def load_label_mapping(tsv_path: str, target_col: str = "nyu40id") -> dict:
    """scannetv2-labels TSV id mapping (tools layout)."""
    mapping = {}
    with open(tsv_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        id_i = header.index("id")
        tgt_i = header.index(target_col)
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= max(id_i, tgt_i):
                continue
            try:
                mapping[int(parts[id_i])] = int(parts[tgt_i])
            except ValueError:
                continue
    return mapping


def evaluate_segmentation(mapper, text_embs: np.ndarray,
                          gt_label_loader, frame_ids: Sequence[int],
                          num_classes: int,
                          every_nth: int = 10,
                          reject_threshold: float = 0.7,
                          min_alpha: float = 0.0) -> dict:
    """Score open-vocab segmentation over keyframes.

    gt_label_loader: callable fid -> [H, W] int labels (0 = unannotated).
    text_embs: [num_classes-1, 64] compressed class embeddings (class ids
    are 1-based; 0 is the reject class).
    min_alpha: when > 0, GT pixels where the map renders accumulated alpha
    below this are marked unannotated (0) and excluded, scoring only pixels
    the map geometrically covers. Default 0 matches the reference's
    all-labeled-pixels rule (eval/scannet_test.py:295-310); the gate exists
    for short synthetic runs where geometry coverage is still partial.
    Returns `covered_frac` = kept fraction of originally-labeled pixels.
    """
    conf = np.zeros((num_classes, num_classes), np.int64)
    labeled = covered = 0
    for k, fid in enumerate(sorted(frame_ids)):
        if k % every_nth:
            continue
        kf = mapper.keyframes.get(fid)
        if kf is None:
            continue
        out = mapper.render_from_pose(
            kf.R, kf.t, kf.views[-1].width, kf.views[-1].height,
            include_lang_feat=True)
        lf = to_host(out.lang_feat)
        pred = metrics.segment_prediction(lf, text_embs, reject_threshold)
        gt = gt_label_loader(fid)
        if gt.shape != pred.shape:
            try:
                import cv2
                gt = cv2.resize(gt.astype(np.int32),
                                (pred.shape[1], pred.shape[0]),
                                interpolation=cv2.INTER_NEAREST)
            except ImportError:  # pragma: no cover
                continue
        labeled += int((gt > 0).sum())
        if min_alpha > 0.0:
            alpha = 1.0 - to_host(out.final_t)
            gt = np.where(alpha >= min_alpha, gt, 0)
        covered += int((gt > 0).sum())
        conf += metrics.confusion_matrix(pred, gt, num_classes)
    scores = metrics.miou_from_confusion(conf, ignore=(0,))
    scores["confusion"] = conf
    scores["covered_frac"] = covered / max(labeled, 1)
    return scores


def evaluate_scenes(data_root: str, out_root: str, scenes: Sequence[str],
                    text_embs: Optional[np.ndarray] = None,
                    label_loader_factory=None, exp_name: str = "legslam_torch",
                    every_nth: int = 10, reject_threshold: float = 0.7,
                    **kwargs) -> list[dict]:
    """Train+score each scene; when `text_embs` ([num_classes-1, 64]
    compressed class embeddings) and `label_loader_factory`
    (scene_name -> (fid -> [H, W] int labels)) are given, the trained
    map's rendered language features are scored for open-vocab mIoU/mAcc
    like eval/scannet_test.py:227-396. Each result dict then carries
    {psnr, ssim, depth_l1_cm, miou, macc, ...}."""
    results = []
    do_seg = text_embs is not None and label_loader_factory is not None
    for scene in scenes:
        scene_dir = os.path.join(data_root, scene)
        if not os.path.isdir(scene_dir):
            continue
        out_dir = os.path.join(out_root, scene)
        r = run_scene(scene_dir, out_dir, return_mapper=do_seg, **kwargs)
        if do_seg:
            mapper = r.pop("_mapper")
            seg = evaluate_segmentation(
                mapper, np.asarray(text_embs),
                label_loader_factory(scene),
                frame_ids=sorted(mapper.keyframes),
                num_classes=len(text_embs) + 1,
                every_nth=every_nth, reject_threshold=reject_threshold)
            r["miou"] = seg["miou"]
            r["macc"] = seg["macc"]
            r["per_class_iou"] = [float(x) for x in seg["per_class_iou"]]
        results.append(r)
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, f"eval_result_{exp_name}.log"),
              "w") as f:
        for r in results:
            f.write(json.dumps({k: v for k, v in r.items()
                                if not isinstance(v, np.ndarray)}) + "\n")
        if results and do_seg:
            f.write(json.dumps(dict(average=dict(
                miou=float(np.mean([r["miou"] for r in results])),
                macc=float(np.mean([r["macc"] for r in results])))))
                + "\n")
    return results


def _label_palette(num_classes: int) -> np.ndarray:
    """[num_classes, 3] uint8 palette; class 0 (reject/unlabeled) black.
    Deterministic golden-angle hues (role of metric_utils.py's color table;
    values intentionally our own)."""
    cols = np.zeros((num_classes, 3), np.uint8)
    for c in range(1, num_classes):
        h = (c * 0.61803398875) % 1.0
        i = int(h * 6.0)
        f = h * 6.0 - i
        v, p, q, t = 255, 64, int(255 - 191 * f), int(64 + 191 * f)
        rgb = [(v, t, p), (q, v, p), (p, v, t),
               (p, q, v), (t, p, v), (v, p, q)][i % 6]
        cols[c] = rgb
    return cols


def create_comparison_video(mapper, text_embs: np.ndarray, gt_label_loader,
                            frame_ids, out_path: str,
                            reject_threshold: float = 0.7,
                            fps: int = 10) -> Optional[str]:
    """2x2 comparison video per keyframe: [pred color | gt color] over
    [pred labelmap | gt labelmap] (eval/scannet_test.py:397-470's
    comparison grid as a single artifact). Returns the mp4 path, or None
    when cv2/video IO is unavailable."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return None
    os.makedirs(out_path, exist_ok=True)
    palette = _label_palette(len(text_embs) + 1)
    vw = None
    video_path = os.path.join(out_path, "comparison.mp4")
    for fid in sorted(frame_ids):
        kf = mapper.keyframes.get(fid)
        if kf is None:
            continue
        out = mapper.render_from_pose(
            kf.R, kf.t, kf.views[-1].width, kf.views[-1].height,
            include_lang_feat=True)
        pred_rgb = np.uint8(np.clip(to_host(out.color), 0, 1) * 255)
        gt_rgb = np.uint8(np.clip(to_host(kf.gt_color[-1]), 0, 1) * 255)
        pred_lab = metrics.segment_prediction(
            to_host(out.lang_feat), text_embs, reject_threshold)
        gt = gt_label_loader(fid)
        if gt.shape != pred_lab.shape:
            gt = cv2.resize(gt.astype(np.int32),
                            (pred_lab.shape[1], pred_lab.shape[0]),
                            interpolation=cv2.INTER_NEAREST)
        top = np.hstack([pred_rgb, gt_rgb])
        bot = np.hstack([palette[np.clip(pred_lab, 0, len(palette) - 1)],
                         palette[np.clip(gt, 0, len(palette) - 1)]])
        frame = cv2.cvtColor(np.vstack([top, bot]), cv2.COLOR_RGB2BGR)
        if vw is None:
            vw = cv2.VideoWriter(video_path,
                                 cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (frame.shape[1], frame.shape[0]))
        vw.write(frame)
    if vw is None:
        return None
    vw.release()
    return video_path
