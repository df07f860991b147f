"""Tiny CPU versions of the benchmark's cells for its tests: the same
drivers, references and comparisons, at a 128 x 72 camera, a 2-keyframe
initial map and a one-block encoder, on the port's plain PyTorch
versions of its kernels."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from legs_bench import harness  # noqa: E402


def tiny(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    c = spec["config"]
    if "camera" in c:
        w, h = 128, 72
        c["camera"].update({"Camera.width": w, "Camera.height": h,
                            "Camera1.fx": 64.0, "Camera1.fy": 64.0,
                            "Camera1.cx": (w - 1) / 2,
                            "Camera1.cy": (h - 1) / 2})
        c["mapper"]["Mapper.min_num_initial_map_kfs"] = 2
        # a depth-cache flush and a densification in every tiny window
        c["mapper"].update({"Mapper.depth_cache": 2,
                            "Optimization.densify_from_iter": 2,
                            "Optimization.densification_interval": 2})
        c["app"].update(kf_stride=2, capacity=1 << 15)
    if "encoder" in c:
        c["encoder"].update(dim=64, depth=1, heads=2, image_size=28,
                            patch_size=14)
    if "text" in c:
        c["text"].update(width=64, layers=1, heads=2, proj_dim=64)
    t = spec["traffic"]
    if t["driver"] == "find_objects":
        t.update(n_cloud=4000, n_object=60, trace_seconds=0.2,
                 trace_min_requests=3)
    if t["driver"] == "rgbd_stream":
        t.update(loop_frames=12, setup_frames=6, warm_frames=1,
                 trace_seconds=0.1,
                 trace_min_frames=3, launch_stride=2,
                 iters_per_frame=min(t["iters_per_frame"], 2))
    return spec


def run_tiny(cell: str, seed: int = 2 ** 31 + 977, seconds: float = 1.0,
             trace: int = 0, control: bool = False, spec=None,
             device=torch.device("cpu")):
    """(result of the driver, the report's last line as a dict)."""
    import json
    from legs_bench import run
    bench = harness.load_bench(ROOT)
    spec = spec or tiny(harness.cell_spec(ROOT, bench, cell))
    args = SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                           trace=trace)
    res = run.execute(args, spec, device, run.limits_of(cell), time.time(),
                      control=control)
    return res, args, bench


def last_line(capsys, args, bench, res) -> dict:
    import json
    from legs_bench import run
    dev = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    run.report(args, bench, res, dev)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.fixture
def card():
    """The card, for the tests that need one; they skip without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
