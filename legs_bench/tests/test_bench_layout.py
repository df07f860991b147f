"""The benchmark is driven by data: a configuration, a cell and a
per-layer metric are added as new files and entries only. The harness
loads neither JAX nor the JAX package, and its reference loads no part
of the program. Its frozen arithmetic equals chip_smoke.py's."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import torch

from conftest import ROOT


def test_new_config_cell_and_metric_are_files_only(tmp_path):
    shutil.copytree(ROOT / "legs_bench", tmp_path / "legs_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / "legs_bench"
    cfg = json.loads((base / "configs" / "replica_office0.json").read_text())
    cfg["name"] = "replica_room9"
    (base / "configs" / "replica_room9.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "stream.json").read_text())
    traffic["iters_per_frame"] = 3
    (base / "traffic" / "iters3.json").write_text(json.dumps(traffic))
    (base / "limits" / "room9.iters3.json").write_text(
        (base / "limits" / "replica.map15.json").read_text())
    (base / "metrics" / "frames_counted.py").write_text(textwrap.dedent('''
        def read(data):
            return data.get("frames")
        '''))
    bench["configs"].append(dict(name="replica_room9", source="x",
                                 file="legs_bench/configs/replica_room9.json",
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="room9.iters3",
                                   config="replica_room9",
                                   traffic="iters3", chips=1, why="x"))
    bench["per_layer"].append(dict(name="frames_counted", unit="frames",
                                   better="higher", source="program_counter",
                                   layer="app loop", moves="frames_per_s",
                                   workloads=["room9.iters3"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(tmp_path)!r})
        from pathlib import Path
        from legs_bench import harness
        root = Path({str(tmp_path)!r})
        bench = harness.load_bench(root)
        spec = harness.cell_spec(root, bench, "room9.iters3")
        assert spec["config"]["name"] == "replica_room9"
        assert spec["traffic"]["iters_per_frame"] == 3
        names = [m["name"] for m in
                 harness.metrics_for(bench, "room9.iters3", "per_layer")]
        assert "frames_counted" in names
        assert "frames_counted" not in [m["name"] for m in
            harness.metrics_for(bench, "replica.map15", "per_layer")]
        out = harness.read_per_layer(
            [m for m in bench["per_layer"] if m["name"] == "frames_counted"],
            dict(frames=7))
        assert out == dict(frames_counted=dict(value=7.0, unit="frames"))
        import legs_bench.run as run
        assert run.limits_of("room9.iters3")
        print("ok")
        ''')
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


def _loaded_after(code: str) -> set:
    probe = code + textwrap.dedent('''
        import sys
        print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
        ''')
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    tops = _loaded_after(textwrap.dedent('''
        import sys
        sys.path.insert(0, "legs_bench/tests")
        from conftest import run_tiny
        from legs_bench import harness
        run_tiny("replica.map15", trace=1)
        assert not harness.loaded_forbidden()
        '''))
    assert not tops & {"jax", "jaxlib", "flax", "legslam_tpu"}
    assert "legslam_torch" in tops


def test_reference_loads_no_program_and_no_jax():
    tops = _loaded_after(textwrap.dedent('''
        import legs_bench.reference.encoder
        import legs_bench.reference.mapping
        import legs_bench.frozen, legs_bench.scene, legs_bench.weights
        '''))
    assert not tops & {"jax", "jaxlib", "flax", "legslam_tpu",
                       "legslam_torch"}


def test_frozen_bounds_equal_chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from legs_bench import frozen
    st, view, gt = chip_smoke.make_scene(torch.device("cpu"), 256, 128,
                                         1500, 1 << 12, seed=3)
    cfg = chip_smoke.make_cfg(1 << 15, "bfloat16")
    from legslam_torch.mapper.train_step import train_step

    def step():
        train_step(st, view.world_view, view.full_proj, view.cam_center,
                   view.tan_fovx, view.tan_fovy, gt["gt_color"],
                   gt["gt_lang_feat"], gt["gt_depth"], gt["mask"], gt["bg"],
                   1.0, 1.0, width=256, height=128, active_sh_degree=0,
                   opt=chip_smoke_opt(), cfg=cfg, emit_kfin=True)
    fwd_args, _ = chip_smoke.capture_kernel_inputs(step)
    from legslam_torch.ops.cuda.composite import composite_forward
    kfin = composite_forward(*fwd_args)[2]
    for k in (kfin, None):
        a = frozen.bounds(fwd_args, k)
        b = chip_smoke.bounds(fwd_args, k)
        assert a == b
        assert a["counts"]["pair_pixels"] > 0
    assert frozen.sort_bound(1 << 20, 8 << 20) == \
        chip_smoke.sort_bound(1 << 20, 8 << 20)
    from legslam_torch.models.dinov2 import DinoV2Config
    from legslam_torch.models.clip_text import ClipTextConfig
    assert frozen.encoder_flops(DinoV2Config(), 1369) == \
        chip_smoke.encoder_flops(DinoV2Config(), 1369)
    assert frozen.clip_text_flops(ClipTextConfig(), 7) == \
        chip_smoke.clip_text_flops(ClipTextConfig(), 7)
    assert np.isclose(frozen.PEAK_F32_OPS, chip_smoke.PEAK_F32_OPS)


def chip_smoke_opt():
    from legslam_torch.config import OptimizationParams
    return OptimizationParams()
