"""Evaluation metrics: ATE (umeyama), depth-L1, segmentation confusion/mIoU.

A numpy copy of legslam_tpu/eval_harness/metrics.py. Parity references:
  - ATE-RMSE/mean via umeyama alignment: eval/replica_test.py:29-46
  - depth L1 in cm (scale 6553.5 handled by the dataset): :160-181
  - confusion matrix -> per-class IoU / accuracy: eval/metric_utils.py:96-197
  - label sets SCANNET20 / COCOMAP: eval/metric_utils.py:9-51
  - PSNR/SSIM come from ops/losses.py (same math as loss_utils.h)
  - LPIPS(alex) through models/lpips.py: eval/replica_test.py:131-158
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

SCANNET20 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture")

COCOMAP = (
    "bed", "windowpane", "cabinet", "person", "door", "table", "curtain",
    "chair", "car", "painting", "sofa", "shelf", "mirror", "armchair",
    "seat", "fence", "desk", "wardrobe", "lamp", "bathtub", "railing",
    "cushion", "box", "column", "signboard", "chest of drawers", "counter",
    "sink", "fireplace", "refrigerator", "stairs", "case", "pool table",
    "pillow", "screen door", "bookcase", "coffee table", "toilet", "flower",
    "book", "bench", "countertop", "stove", "palm", "kitchen island",
    "computer", "swivel chair", "boat", "arcade machine", "bus", "towel",
    "light", "truck", "chandelier", "awning", "streetlight", "booth",
    "television receiver", "airplane", "apparel", "pole", "bannister",
    "ottoman", "bottle", "van", "ship", "fountain", "washer", "plaything",
    "stool", "barrel", "basket", "bag", "minibike", "oven", "ball", "food",
    "step", "trade name", "microwave", "pot", "animal", "bicycle", "dishwasher",
    "screen", "sculpture", "hood", "sconce", "vase", "traffic light", "tray",
    "ashcan", "fan", "plate", "monitor", "bulletin board", "radiator",
    "glass", "clock", "flag")


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Least-squares similarity aligning src -> dst ([N,3] each).
    Returns (R, t, s)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_traj: np.ndarray, gt_traj: np.ndarray,
             with_scale: bool = True) -> dict:
    """Absolute trajectory error after umeyama alignment (translations
    [N,3]); returns rmse/mean in the GT units (eval/replica_test.py:29-46)."""
    R, t, s = umeyama_alignment(est_traj, gt_traj, with_scale)
    aligned = (s * (R @ est_traj.T)).T + t
    err = np.linalg.norm(aligned - gt_traj, axis=-1)
    return dict(rmse=float(np.sqrt((err ** 2).mean())),
                mean=float(err.mean()), scale=s)


def depth_l1_cm(pred: np.ndarray, gt: np.ndarray,
                max_depth: float = 1e6) -> float:
    """Mean |pred-gt| in cm over valid GT pixels
    (eval/replica_test.py:160-181)."""
    valid = (gt > 0) & (gt < max_depth)
    if not valid.any():
        return 0.0
    return float(np.abs(pred[valid] - gt[valid]).mean() * 100.0)


def confusion_matrix(pred: np.ndarray, gt: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """[C, C] counts with rows = gt, cols = pred; label 0 treated as a real
    class (the reject/background class), labels >= num_classes ignored
    (eval/metric_utils.py:96-197)."""
    valid = (gt >= 0) & (gt < num_classes) & (pred >= 0) & \
        (pred < num_classes)
    idx = gt[valid].astype(np.int64) * num_classes + \
        pred[valid].astype(np.int64)
    return np.bincount(idx, minlength=num_classes ** 2).reshape(
        num_classes, num_classes)


def miou_from_confusion(conf: np.ndarray,
                        ignore: Sequence[int] = ()) -> dict:
    """conf[gt, pred]. Predictions falling on ignored (unannotated) GT
    classes are excluded from the false-positive count, exactly like the
    reference's `confusion[:, 1:]` column drop (metric_utils.py:107) —
    the model is not penalized for predicting something on unlabeled
    pixels."""
    inter = np.diag(conf).astype(np.float64)
    conf_labeled = conf.astype(np.float64).copy()
    for i in ignore:
        conf_labeled[i, :] = 0.0
    union = conf_labeled.sum(0) + conf.sum(1) - inter
    seen = conf.sum(1) > 0
    for i in ignore:
        seen[i] = False
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    acc = np.where(conf.sum(1) > 0, inter / np.maximum(conf.sum(1), 1), 0.0)
    for i in ignore:
        iou[i] = 0.0  # its union is meaningless after the row drop
    return dict(
        miou=float(iou[seen].mean()) if seen.any() else 0.0,
        macc=float(acc[seen].mean()) if seen.any() else 0.0,
        per_class_iou=iou, per_class_acc=acc)


def segment_prediction(lf_image: np.ndarray, text_embs: np.ndarray,
                       reject_threshold: float = 0.7) -> np.ndarray:
    """Open-vocab segmentation rule (eval/scannet_test.py:295-310):
    score = (1 - cos)/2 per class; argmax; scores below the threshold
    become class 0 (reject). Returns [H, W] int labels where class ids are
    1-based over text_embs rows."""
    lf = lf_image / np.linalg.norm(lf_image, axis=-1, keepdims=True) \
        .clip(1e-12)
    te = text_embs / np.linalg.norm(text_embs, axis=-1, keepdims=True) \
        .clip(1e-12)
    cos = np.einsum("hwc,nc->hwn", lf, te)
    score = (1.0 - cos) / 2.0
    best = score.argmax(-1)
    best_score = score.max(-1)
    labels = best + 1
    labels[best_score < reject_threshold] = 0
    return labels


def lpips_alex(img1: np.ndarray, img2: np.ndarray,
               weights_path: Optional[str] = None,
               device: str = "cuda") -> float:
    """LPIPS(alex) like eval/replica_test.py:131-158, on `device`.

    Pass `weights_path` = an lpips_alex.npz produced by
    tools/convert_weights.py --lpips-alex (AlexNet-LPIPS, models/lpips.py).
    The JAX module falls back to the `lpips` torch package without one;
    the port does not import it, so it raises with the same guidance (the
    offline image ships no pretrained weights)."""
    if not weights_path:
        raise RuntimeError(
            "LPIPS needs converted weights (tools/convert_weights.py "
            "--lpips-alex -> pass weights_path); legslam_torch does not use "
            "the `lpips` package.")
    from legslam_torch.models import lpips as L
    params = L.load_params(weights_path, device)
    return float(L.lpips(params, np.asarray(img1, np.float32),
                         np.asarray(img2, np.float32)))
