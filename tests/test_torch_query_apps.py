"""legslam_torch.apps.{find_objects,detect_objects} against the JAX
package's CLIs on the CPU, on the on-disk map of
tests/test_detect_objects.py: the same detections.json and printed
detections, the pixel-space route with PAMR writing its heatmaps, and
--query refusing for want of a tokenizer."""
import json

import numpy as np
import pytest
import torch

from tests.test_detect_objects import _tiny_scene_dir

torch.set_num_threads(1)


def test_detect_objects_cli(tmp_path):
    """The port's CLI on the on-disk map with precomputed embeddings, on
    the CPU: the same detections.json as the JAX CLI, and the video."""
    from legslam_torch.apps import detect_objects as tapp
    from legslam_tpu.apps import detect_objects as japp
    scene = _tiny_scene_dir(tmp_path)
    embs = np.zeros((2, 64), np.float32)
    embs[0, 0] = 1.0
    embs[1, 1] = 1.0
    emb_path = tmp_path / "q.npy"
    np.save(emb_path, embs)
    args = ["--scene", str(scene), "--text-embs", str(emb_path),
            "--prompts", "chair", "table", "--threshold", "0.6",
            "--no-pamr"]
    tapp.main(args + ["--out", str(tmp_path / "t"), "--video"],
              device="cpu")
    japp.main(args + ["--out", str(tmp_path / "j")])
    got = json.loads((tmp_path / "t" / "detections.json").read_text())
    want = json.loads((tmp_path / "j" / "detections.json").read_text())
    assert got == want
    assert got["counts"]["chair"] >= 1 and got["counts"]["table"] >= 1
    assert (tmp_path / "t" / "detections.mp4").exists()


def test_find_objects_cli(tmp_path, capsys):
    """The port's find_objects CLI on the CPU: gaussian space over the PLY
    (the JAX CLI's printed detections), and --pixel-space with PAMR
    writing its heatmaps; --query raises for want of a tokenizer."""
    from legslam_torch.apps import find_objects as tapp
    from legslam_tpu.apps import find_objects as japp
    scene = _tiny_scene_dir(tmp_path)
    ply = str(scene / "point_cloud" / "point_cloud.ply")
    emb = np.zeros(64, np.float32)
    emb[0] = 1.0
    np.save(tmp_path / "q.npy", emb)
    base = ["--text-emb", str(tmp_path / "q.npy")]
    tapp.main(base + ["--ply", ply, "--out", str(tmp_path / "t")],
              device="cpu")
    t_out = capsys.readouterr().out
    japp.main(base + ["--ply", ply, "--out", str(tmp_path / "j")])
    assert t_out == capsys.readouterr().out
    assert "object instance(s)" in t_out
    tapp.main(base + ["--scene", str(scene), "--pixel-space", "--out",
                      str(tmp_path / "px"), "--n-views", "4"], device="cpu")
    assert "best frame" in capsys.readouterr().out
    assert (tmp_path / "px" / "heat_0000.jpg").exists()
    from tests.test_torch_talk2dino import write_jax_weights_dir
    wdir = str(tmp_path / "weights")
    write_jax_weights_dir(wdir)
    with pytest.raises(RuntimeError, match="token ids"):
        tapp.main(["--ply", ply, "--query", "a chair", "--weights", wdir],
                  device="cpu")
