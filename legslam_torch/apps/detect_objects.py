"""CLI: multi-prompt labeled object detection over training frames.

Counterpart of legslam_tpu/apps/detect_objects.py (eval/detect_objects.py,
but a LIST of prompts per invocation): per-prompt embeddings, per-frame
labeled bboxes, an annotated RGB + heat video (stacked panes at 10 fps
like the reference's VideoWriter, detect_objects.py:96-141), a
detections.json artifact, and an optional rerun stream
(detect_objects.py:143-186). Renders use apps/find_objects.build_render_fn
(the "cuda" backend, float32 pair features); `--prompts` with `--weights`
needs the CLIP tokenizer, which the port does not have (pass
--text-embs). `main(argv, device)` runs on "cuda" unless the caller
passes "cpu".

  python -m legslam_torch.apps.detect_objects --scene <experiment/ply> \
      --text-embs q.npy --prompts "a chair" "a table" \
      [--out ./output/detect] [--video] [--rerun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from legslam_torch.apps.find_objects import _cv2, build_render_fn, pamr_fn


def main(argv=None, device: str | torch.device = "cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", required=True,
                    help="experiment/ply dir (point_cloud + cameras.json)")
    ap.add_argument("--prompts", nargs="+", default=None,
                    help="text prompts (needs --weights)")
    ap.add_argument("--weights", default=None,
                    help="converted weights dir (clip_text/talk2dino/pca)")
    ap.add_argument("--text-embs", default=None,
                    help=".npy with precomputed [Q, 64] prompt embeddings "
                         "(rows align with --prompts labels, or p0..pN)")
    ap.add_argument("--threshold", type=float, default=0.8,
                    help="heat threshold (detect_objects.py:131)")
    ap.add_argument("--no-pamr", action="store_true")
    ap.add_argument("--out", default="./output/detect")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--rerun", action="store_true")
    args = ap.parse_args(argv)

    from legslam_torch.eval_harness.detect_objects import (
        annotate_frame, detect_objects_in_frames, stream_rerun_detections)
    from legslam_torch.eval_harness.find_objects import to_host

    if args.text_embs:
        text = np.load(args.text_embs).reshape(-1, 64)
        prompts = args.prompts or [f"p{i}" for i in range(text.shape[0])]
        if len(prompts) != text.shape[0]:
            raise SystemExit("--prompts count must match --text-embs rows")
    elif args.prompts and args.weights:
        from legslam_torch.models.talk2dino import build_text_embedding
        from legslam_torch.models.weights_io import load_text_pipeline
        clip_params, proj, pca = load_text_pipeline(args.weights, device)
        prompts = args.prompts
        text = to_host(build_text_embedding(
            prompts, clip_params, proj, pca))
    else:
        raise SystemExit("provide --text-embs or --prompts + --weights")

    render_fn, cameras, raw = build_render_fn(args.scene, device)
    res = detect_objects_in_frames(
        render_fn, cameras, text, prompts,
        pamr_fn=None if args.no_pamr else pamr_fn, threshold=args.threshold)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "detections.json"), "w") as f:
        json.dump({
            "prompts": prompts,
            "counts": res.counts(),
            "frames": [dataclasses.asdict(fd) for fd in res.frames],
        }, f, indent=1, default=int)
    print(json.dumps(res.counts()))

    if args.video:
        cv2 = _cv2()
        cam0 = cameras[0]
        w, h = int(cam0["width"]), int(cam0["height"])
        path = os.path.join(args.out, "detections.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (w, 2 * h))
        # stacked annotated-RGB + jet pane of the max heat across prompts
        # (the reference stacks RGB over the single prompt's heat,
        # detect_objects.py:136-141)
        for fd in res.frames:
            bgr = annotate_frame(res.images[fd.frame], fd, prompts)
            heat = res.heats[:, fd.frame].max(axis=0)
            jet = cv2.applyColorMap(np.uint8(np.clip(heat * 255, 0, 255)),
                                    cv2.COLORMAP_JET)
            vw.write(np.vstack([bgr, jet]))
        vw.release()
        print("wrote", path)

    if args.rerun:
        if not stream_rerun_detections(res, scene_points=raw["xyz"]):
            print("rerun SDK not available — skipped streaming "
                  "(detections.json + video carry the same content)")


if __name__ == "__main__":
    main()
