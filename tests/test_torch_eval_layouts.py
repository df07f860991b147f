"""chip_smoke.py phase 12's dataset layouts, on the CPU at 128x64: the
Replica layout of [eval] (write_replica of eval_room's frames) and the
ScanNet layout of [miou] (miou_scene), read back through both packages'
data/datasets.open_dataset: the same reader, length, intrinsics, and each
frame's color, depth and pose bit for bit; and the read-back frames are
the written ones (the camera the frames were rendered at, the poses
exactly, the depths to the PNG's step, the colors to JPEG's error)."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from legslam_torch.data import datasets as TD
from legslam_tpu.data import datasets as JD

torch.set_num_threads(1)

W, H = 128, 64
# mean |err| of a frame's quality-95 JPEG: at most 0.0092 on the Replica
# room's frames and 0.0055 on the ScanNet scene's (tools/eval_cpu_figures.py
# jpeg)
JPEG_MEAN_ERR = 0.02


def _same_reads(path, n):
    """Both packages' readers of `path`; their frames equal bit for bit."""
    t, j = TD.open_dataset(path), JD.open_dataset(path)
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j) == n
    assert t.intrinsics == j.intrinsics
    for i in range(n):
        a, b = t.read(i), j.read(i)
        assert a.index == b.index == i
        for name in ("color", "depth", "c2w"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    return t


def _written(ds, frames, scale):
    for i, f in enumerate(frames):
        r = ds.read(i)
        assert np.array_equal(r.c2w, f.c2w)
        d = np.clip(f.depth, 0, 65535 / scale)
        assert np.abs(r.depth - d).max() <= 0.5 / scale + 1e-6
        assert np.abs(r.color - f.color).mean() <= JPEG_MEAN_ERR


def test_replica_layout_reads_back(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "EVAL_ROOM", dict(
        n_frames=4, width=W, height=H, n_gaussians=600, seed=0))
    frames, intr, _ = cs.eval_room(torch.device("cpu"))
    scene = cs.write_replica(tmp_path / "replica" / cs.EVAL_SCENE, frames)
    ds = _same_reads(scene, 4)
    assert isinstance(ds, TD.ReplicaDataset)
    assert ds.intrinsics == pytest.approx(intr, rel=1e-12)
    _written(ds, frames, TD.REPLICA_DEPTH_SCALE)


def test_scannet_layout_reads_back(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "MIOU_ROOM", dict(
        n_frames=4, width=W, height=H, n_gaussians=600, seed=5,
        clutter_ratio=0.0))
    from legslam_torch.data.synthetic import SyntheticDataset
    scene, lfs, labels = cs.miou_scene(torch.device("cpu"),
                                       tmp_path / "scannet")
    ds = _same_reads(scene, 4)
    assert isinstance(ds, TD.ScanNetDataset)
    src = SyntheticDataset(**cs.MIOU_ROOM, device="cpu")
    # K goes through a float64 text file and float32
    assert ds.intrinsics == pytest.approx(src.intrinsics, rel=1e-7)
    _written(ds, [src.read(i) for i in range(4)], TD.SCANNET_DEPTH_SCALE)
    for i in range(4):
        assert lfs[i].shape == (37, 37, 64)
        assert labels[i].shape == (H, W)
        assert set(np.unique(labels[i])) <= {0, 1, 2}
    # both classes are in view
    assert {1, 2} <= set(np.unique(np.stack(list(labels.values()))))
