"""RGB-D dataset readers: Replica, ScanNet, TUM (+ synthetic for tests).

A copy of legslam_tpu/data/datasets.py. The image decoders are cv2, else
PIL, imported as there; where neither is installed the module still
imports, and reading an image file raises.

Input contracts mirror the reference loaders (SURVEY.md §3.6):
  * Replica (examples/replica_rgbd.cpp:223-235): <scene>/results/frame*.jpg
    + depth*.png, lexicographically sorted pairs; GT trajectory
    <scene>/traj.txt with one row-major 4x4 camera-to-world per line
    (eval/replica_test.py:197); depth factor 6553.5 (office0.yaml:37).
  * ScanNet (examples/replica_rgbd.cpp:237-257): <scene>/color/N.jpg +
    <scene>/depth/N.png numerically sorted; poses from
    tools/scannet_sens_reader.py layout (pose/N.txt camera-to-world,
    intrinsic/intrinsic_color.txt); depth factor 1000.
  * TUM RGB-D: rgb.txt/depth.txt timestamp association (classic protocol,
    matching ORB-SLAM3's examples); depth factor 5000.

Readers are plain Python (host-side IO); a prefetch thread pool overlaps
decode with device compute (the reference's per-frame cv::imread loop is
examples/replica_rgbd.cpp:153-160).
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False
    try:
        from PIL import Image
    except ImportError:
        Image = None


def _no_decoder():
    if Image is None:
        raise RuntimeError("reading image files needs cv2 or PIL")


REPLICA_DEPTH_SCALE = 6553.5   # cfg/ORB_SLAM3/RGB-D/Replica/office0.yaml:37
SCANNET_DEPTH_SCALE = 1000.0
TUM_DEPTH_SCALE = 5000.0

# Replica camera (cfg/ORB_SLAM3/RGB-D/Replica/office0.yaml:11-30)
REPLICA_INTRINSICS = dict(width=1200, height=680, fx=600.0, fy=600.0,
                          cx=599.5, cy=339.5)


@dataclasses.dataclass
class RGBDFrame:
    index: int
    timestamp: float
    color: np.ndarray            # [H, W, 3] float32 RGB in [0,1]
    depth: np.ndarray            # [H, W] float32 meters (0 = invalid)
    c2w: Optional[np.ndarray]    # [4, 4] camera-to-world GT pose or None
    color_path: str = ""
    # rectified right image for stereo sequences (EuRoC cam1)
    color_right: Optional[np.ndarray] = None


def _imread_color(path: str) -> np.ndarray:
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    else:  # pragma: no cover
        _no_decoder()
        img = np.asarray(Image.open(path).convert("RGB"))
    return img.astype(np.float32) / 255.0


def _imread_depth(path: str, scale: float) -> np.ndarray:
    if _HAS_CV2:
        d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    else:  # pragma: no cover
        _no_decoder()
        d = np.asarray(Image.open(path))
    return d.astype(np.float32) / scale


class BaseDataset:
    """Iterable RGB-D sequence with optional background prefetch."""

    depth_scale: float = 1.0
    intrinsics: dict

    def __len__(self) -> int:
        return len(self._color_paths)

    def _pose(self, i: int) -> Optional[np.ndarray]:
        return None if self._poses is None else self._poses[i]

    def read(self, i: int) -> RGBDFrame:
        return RGBDFrame(
            index=i, timestamp=float(i),
            color=_imread_color(self._color_paths[i]),
            depth=_imread_depth(self._depth_paths[i], self.depth_scale),
            c2w=self._pose(i), color_path=self._color_paths[i])

    def __iter__(self) -> Iterator[RGBDFrame]:
        return self.iter_prefetched()

    def iter_prefetched(self, workers: int = 4,
                        lookahead: int = 8) -> Iterator[RGBDFrame]:
        """Decode frames in a thread pool, `lookahead` frames ahead."""
        n = len(self)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = {}
            for i in range(min(lookahead, n)):
                futures[i] = pool.submit(self.read, i)
            for i in range(n):
                frame = futures.pop(i).result()
                j = i + lookahead
                if j < n:
                    futures[j] = pool.submit(self.read, j)
                yield frame


class ReplicaDataset(BaseDataset):
    depth_scale = REPLICA_DEPTH_SCALE

    def __init__(self, scene_dir: str):
        res = os.path.join(scene_dir, "results")
        self._color_paths = sorted(glob.glob(os.path.join(res, "frame*.jpg")))
        self._depth_paths = sorted(glob.glob(os.path.join(res, "depth*.png")))
        if len(self._color_paths) != len(self._depth_paths):
            raise ValueError("mismatched frame/depth counts in " + res)
        traj = os.path.join(scene_dir, "traj.txt")
        self._poses = None
        if os.path.exists(traj):
            rows = np.loadtxt(traj).reshape(-1, 4, 4).astype(np.float32)
            self._poses = list(rows)
        # scale the nominal Replica intrinsics to the actual image size
        # (the reference resizes frames to the settings resolution instead,
        # examples/replica_rgbd.cpp:158-160)
        self.intrinsics = dict(REPLICA_INTRINSICS)
        sample = _imread_color(self._color_paths[0])
        h, w = sample.shape[:2]
        if (w, h) != (self.intrinsics["width"], self.intrinsics["height"]):
            sx = w / self.intrinsics["width"]
            sy = h / self.intrinsics["height"]
            self.intrinsics = dict(
                width=w, height=h,
                fx=self.intrinsics["fx"] * sx,
                fy=self.intrinsics["fy"] * sy,
                cx=(self.intrinsics["cx"] + 0.5) * sx - 0.5,
                cy=(self.intrinsics["cy"] + 0.5) * sy - 0.5)


def _numeric_sort(paths):
    def key(p):
        m = re.search(r"(\d+)\.\w+$", os.path.basename(p))
        return int(m.group(1)) if m else 0
    return sorted(paths, key=key)


class ScanNetDataset(BaseDataset):
    depth_scale = SCANNET_DEPTH_SCALE

    def __init__(self, scene_dir: str):
        self._color_paths = _numeric_sort(
            glob.glob(os.path.join(scene_dir, "color", "*.jpg")))
        self._depth_paths = _numeric_sort(
            glob.glob(os.path.join(scene_dir, "depth", "*.png")))
        pose_files = _numeric_sort(
            glob.glob(os.path.join(scene_dir, "pose", "*.txt")))
        self._poses = None
        if pose_files:
            self._poses = [np.loadtxt(p).astype(np.float32)
                           for p in pose_files]
        intr = os.path.join(scene_dir, "intrinsic", "intrinsic_color.txt")
        if os.path.exists(intr):
            K = np.loadtxt(intr).astype(np.float32)
            # probe first image for the true resolution
            sample = _imread_color(self._color_paths[0])
            self.intrinsics = dict(
                width=sample.shape[1], height=sample.shape[0],
                fx=float(K[0, 0]), fy=float(K[1, 1]),
                cx=float(K[0, 2]), cy=float(K[1, 2]))
        else:
            sample = _imread_color(self._color_paths[0])
            self.intrinsics = dict(width=sample.shape[1],
                                   height=sample.shape[0],
                                   fx=577.0, fy=577.0,
                                   cx=sample.shape[1] / 2 - 0.5,
                                   cy=sample.shape[0] / 2 - 0.5)


class TUMDataset(BaseDataset):
    depth_scale = TUM_DEPTH_SCALE

    def __init__(self, scene_dir: str, max_dt: float = 0.02):
        def read_list(name):
            out = []
            with open(os.path.join(scene_dir, name)) as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    ts, path = line.strip().split()[:2]
                    out.append((float(ts), os.path.join(scene_dir, path)))
            return out

        rgb = read_list("rgb.txt")
        depth = read_list("depth.txt")
        self._color_paths, self._depth_paths, self._stamps = [], [], []
        j = 0
        for ts, cpath in rgb:
            while j + 1 < len(depth) and \
                    abs(depth[j + 1][0] - ts) < abs(depth[j][0] - ts):
                j += 1
            if abs(depth[j][0] - ts) <= max_dt:
                self._color_paths.append(cpath)
                self._depth_paths.append(depth[j][1])
                self._stamps.append(ts)
        self._poses = None
        sample = _imread_color(self._color_paths[0])
        self.intrinsics = dict(width=sample.shape[1], height=sample.shape[0],
                               fx=525.0, fy=525.0, cx=319.5, cy=239.5)

    def read(self, i: int) -> RGBDFrame:
        frame = super().read(i)
        return dataclasses.replace(frame, timestamp=self._stamps[i])


class EuRoCStereoDataset(BaseDataset):
    """EuRoC MAV ASL layout (mav0/cam0, mav0/cam1, ground truth in
    state_groundtruth_estimate0). The reference consumes EuRoC through
    ORB-SLAM3's stereo examples and writes SaveTrajectoryEuRoC
    (ORB-SLAM3/include/System.h:123); frames here carry the rectified-ish
    cam1 image as color_right for the stereo frontend / SGM densify
    branch. depth is None — stereo depth comes from census+SGM."""

    depth_scale = 1.0

    def __init__(self, seq_dir: str, max_dt_ns: int = 10_000_000):
        mav = os.path.join(seq_dir, "mav0")
        cam0 = self._read_cam_csv(os.path.join(mav, "cam0"))
        cam1 = self._read_cam_csv(os.path.join(mav, "cam1"))
        # pair cam0/cam1 by nearest timestamp
        self._color_paths, self._right_paths, self._stamps = [], [], []
        ts1 = np.asarray([t for t, _ in cam1], np.int64)
        for t, p in cam0:
            j = int(np.argmin(np.abs(ts1 - t)))
            if abs(int(ts1[j]) - t) <= max_dt_ns:
                self._color_paths.append(p)
                self._right_paths.append(cam1[j][1])
                self._stamps.append(t * 1e-9)
        self._depth_paths = [None] * len(self._color_paths)

        y0 = _parse_asl_yaml(os.path.join(mav, "cam0", "sensor.yaml"))
        y1 = _parse_asl_yaml(os.path.join(mav, "cam1", "sensor.yaml"))
        fu, fv, cu, cv_ = y0.get("intrinsics", [458.654, 457.296,
                                                367.215, 248.375])[:4]
        res = y0.get("resolution", [752, 480])
        self.intrinsics = dict(width=int(res[0]), height=int(res[1]),
                               fx=float(fu), fy=float(fv),
                               cx=float(cu), cy=float(cv_))
        self.distortion = np.asarray(
            y0.get("distortion_coefficients", [0, 0, 0, 0]), np.float32)
        T0 = np.asarray(y0.get("T_BS", np.eye(4).ravel().tolist()),
                        np.float32).reshape(4, 4)
        T1 = np.asarray(y1.get("T_BS", np.eye(4).ravel().tolist()),
                        np.float32).reshape(4, 4)
        self.T_body_cam0 = T0
        # stereo baseline = cam0->cam1 translation norm (~0.11 m on EuRoC)
        self.baseline = float(np.linalg.norm(
            (np.linalg.inv(T1) @ T0)[:3, 3]))

        # GT body poses -> cam0 c2w at frame timestamps (nearest neighbor)
        self._poses = None
        gt_csv = os.path.join(mav, "state_groundtruth_estimate0",
                              "data.csv")
        if os.path.exists(gt_csv):
            rows = np.genfromtxt(gt_csv, delimiter=",", comments="#")
            if rows.ndim == 1:
                rows = rows[None]
            gt_ts = rows[:, 0].astype(np.int64)
            poses = []
            for t in self._stamps:
                j = int(np.argmin(np.abs(gt_ts - int(t * 1e9))))
                p = rows[j, 1:4]
                qw, qx, qy, qz = rows[j, 4:8]
                R = _quat_to_rot(qw, qx, qy, qz)
                T_WB = np.eye(4, dtype=np.float32)
                T_WB[:3, :3], T_WB[:3, 3] = R, p
                poses.append((T_WB @ self.T_body_cam0).astype(np.float32))
            self._poses = poses

        # imu0 stream (t_ns, wx, wy, wz, ax, ay, az), rotated into the
        # cam0 frame so the frontend's body==camera convention holds
        # (slam/imu.py; lever-arm accel terms ~cm-scale are neglected —
        # the reference instead carries the full T_bc through its factors,
        # ORB-SLAM3/src/ImuTypes.cc)
        self._imu = None
        imu_csv = os.path.join(mav, "imu0", "data.csv")
        if os.path.exists(imu_csv):
            rows = np.genfromtxt(imu_csv, delimiter=",", comments="#")
            if rows.ndim == 1:
                rows = rows[None]
            R_cb = np.linalg.inv(self.T_body_cam0)[:3, :3]
            imu = np.empty((rows.shape[0], 7))
            imu[:, 0] = rows[:, 0] * 1e-9
            imu[:, 1:4] = rows[:, 1:4] @ R_cb.T
            imu[:, 4:7] = rows[:, 4:7] @ R_cb.T
            self._imu = imu

    def imu_between(self, i: int) -> Optional[np.ndarray]:
        """[K, 7] IMU rows (t s, gyro rad/s, accel m/s^2, cam0 frame)
        covering (t_{i-1}, t_i] — the `imu` argument TrackingFrontend
        expects for frame i. None for frame 0 or when imu0 is absent."""
        if self._imu is None or i <= 0:
            return None
        t0, t1 = self._stamps[i - 1], self._stamps[i]
        ts = self._imu[:, 0]
        lo = int(np.searchsorted(ts, t0, side="left"))
        hi = int(np.searchsorted(ts, t1, side="right"))
        lo = max(lo - 1, 0)            # one sample before t0 anchors ZOH
        if hi - lo < 2:
            return None
        return self._imu[lo:hi]

    @staticmethod
    def _read_cam_csv(cam_dir: str):
        out = []
        csv = os.path.join(cam_dir, "data.csv")
        with open(csv) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                ts, name = line.strip().split(",")[:2]
                out.append((int(ts),
                            os.path.join(cam_dir, "data", name.strip())))
        return out

    def read(self, i: int) -> RGBDFrame:
        return RGBDFrame(
            index=i, timestamp=self._stamps[i],
            color=_imread_color(self._color_paths[i]),
            depth=None, c2w=self._pose(i),
            color_path=self._color_paths[i],
            color_right=_imread_color(self._right_paths[i]))


def _quat_to_rot(w, x, y, z):
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _parse_asl_yaml(path: str) -> dict:
    """Minimal parser for EuRoC sensor.yaml: scalar lists ([a, b, ...])
    and the T_BS rows/cols/data block. No external yaml dependency."""
    out = {}
    if not os.path.exists(path):
        return out
    text = open(path).read()
    for key in ("intrinsics", "distortion_coefficients", "resolution"):
        m = re.search(rf"^{key}:\s*\[([^\]]*)\]", text, re.M)
        if m:
            out[key] = [float(v) for v in m.group(1).split(",")]
    m = re.search(r"T_BS:.*?data:\s*\[([^\]]*)\]", text, re.S)
    if m:
        out["T_BS"] = [float(v) for v in
                       m.group(1).replace(chr(10), " ").split(",")]
    return out


def open_dataset(path: str) -> BaseDataset:
    """Sniff the dataset type from the directory layout, like the reference
    sniffs from the path string (examples/replica_rgbd.cpp:76-79)."""
    if os.path.isdir(os.path.join(path, "results")):
        return ReplicaDataset(path)
    if os.path.isdir(os.path.join(path, "color")):
        return ScanNetDataset(path)
    if os.path.exists(os.path.join(path, "rgb.txt")):
        return TUMDataset(path)
    if os.path.isdir(os.path.join(path, "mav0")):
        return EuRoCStereoDataset(path)
    raise ValueError(f"unrecognized dataset layout at {path}")
