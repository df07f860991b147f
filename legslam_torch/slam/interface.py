"""SLAM <-> mapper bridge contract (a copy of legslam_tpu/slam/interface.py).

Equivalent of the reference's Atlas MappingOperation queue
(ORB-SLAM3/include/Atlas.h:52-170, 283-311) and the keyframe snapshotting
the mapper performs (src/gaussian_mapper.cpp:361-452). The reference shares
memory between ORB-SLAM3 threads and the mapper under mutexes; here the
frontend (whatever produces poses: the trajectory player today, a native
tracker later) *publishes* immutable snapshots into a queue the mapper
drains — no shared mutable state, which also keeps the device-side mapper
free to run ahead asynchronously.
"""
from __future__ import annotations

import dataclasses
import enum
import queue
import threading
from typing import Optional, Protocol, Sequence

import numpy as np
import torch


class OpKind(enum.IntEnum):
    """Atlas.h:55-59 operation types."""
    LOCAL_BA = 1
    LOOP_CLOSE_BA = 2
    SCALE_REFINEMENT = 3


@dataclasses.dataclass
class KeyframePacket:
    """One keyframe snapshot crossing the bridge (the payload the mapper
    builds a GaussianKeyframe from; gaussian_mapper.cpp:368-452)."""
    fid: int
    timestamp: float
    R: np.ndarray                 # [3,3] world->camera
    t: np.ndarray                 # [3]
    color: np.ndarray             # [H,W,3] float32 RGB
    depth: Optional[np.ndarray]   # [H,W] float32 meters
    # [37,37,64] language features: host array, or the encoder's tensor,
    # which stays on its device
    lf_image: Optional[np.ndarray | torch.Tensor]
    # rectified right image for STEREO sensors (KeyFrame::imgAuxiliary in
    # stereo mode feeds the SGM densify branch, gaussian_mapper.cpp:1302)
    color_right: Optional[np.ndarray] = None
    # [H,W] float32 SGM disparity of (color, color_right) on the device
    # where the frontend computed it (-1 where invalid), so the mapper's
    # stereo branch does not match the same pair again; None when the
    # frontend ran no SGM for this keyframe
    disparity: Optional[torch.Tensor] = None
    # undistorted keypoint pixels + camera-local 3D points (z=-1 when no
    # map point) — KeyFrame::GetKeypointInfo contract (KeyFrame.h:264)
    kp_pixels: Optional[np.ndarray] = None    # [N,2]
    kp_points_local: Optional[np.ndarray] = None  # [N,3]
    is_loop_kf: bool = False
    # per-KF Sim(3) scale from the monocular essential graph (1.0 for
    # rgbd/stereo loops and all non-loop packets): the mapper scales the
    # gaussians anchored to this keyframe by it during loop surgery
    scale: float = 1.0


@dataclasses.dataclass
class MappingOperation:
    """Bridge op (Atlas.h:52-170): adjusted keyframes + optimized points
    after a BA / loop closure / scale refinement."""
    kind: OpKind
    keyframes: Sequence[KeyframePacket]
    # sparse colored map points (MapPoint color mod, MapPoint.h:117-118)
    points_xyz: Optional[np.ndarray] = None    # [M,3]
    points_color: Optional[np.ndarray] = None  # [M,3] in [0,1]
    scale: float = 1.0


class PoseSource(Protocol):
    """What the mapper needs from any SLAM frontend."""

    def pop_operation(self) -> Optional[MappingOperation]: ...
    def has_operation(self) -> bool: ...
    def live_keyframe_ids(self) -> set[int]: ...
    def is_shutdown(self) -> bool: ...


class OperationQueue:
    """Thread-safe op queue (Atlas::pushMappingOperation contract)."""

    def __init__(self):
        self._q: queue.Queue[MappingOperation] = queue.Queue()
        self._live_kfs: set[int] = set()
        self._lock = threading.Lock()
        self._shutdown = threading.Event()

    def push(self, op: MappingOperation) -> None:
        with self._lock:
            for kf in op.keyframes:
                self._live_kfs.add(kf.fid)
        self._q.put(op)

    def pop_operation(self) -> Optional[MappingOperation]:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def has_operation(self) -> bool:
        return not self._q.empty()

    def remove_keyframe(self, fid: int) -> None:
        with self._lock:
            self._live_kfs.discard(fid)

    def live_keyframe_ids(self) -> set[int]:
        with self._lock:
            return set(self._live_kfs)

    def shutdown(self) -> None:
        self._shutdown.set()

    def is_shutdown(self) -> bool:
        return self._shutdown.is_set()
