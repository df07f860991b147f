"""Online Gaussian mapper: the orchestration layer (GaussianMapper).

Counterpart of legslam_tpu/mapper/mapper.py. It follows the reference's
3-phase lifecycle (src/gaussian_mapper.cpp:361-554):

  Phase 1  initial mapping: wait for >= min_num_initial_map_kfs keyframes,
           snapshot sparse colored points, create the store
           (createFromPcd), compute the nerf++ camera extent, first
           training iteration.
  Phase 2  incremental: drain MappingOperations (new keyframes, BA pose
           updates, loop-closure surgery, scale refinement) and run one
           training iteration per tick (trainForOneIteration, :624-798).
  Phase 3  tail optimization after SLAM shutdown, then artifact dump.

The device work is the mapping step (mapper/train_step.py), the cached
binning with its termination-aware trims (ops/binning.py; the cache's
policy is mapper/binning_cache.py) and the episodic store surgery
(models/gaussians.py); the Python here is scheduling. The
state, keyframe tensors and random draws live on `device` ("cuda" unless
the caller asks for the CPU).

Beside the one-keyframe step, a tick can be a batch of n_views keyframes
(parallel/sharded.py), one view rendered in spatial_strips tile-row
strips (parallel/spatial.py), or both; shard_store splits the store's
rows (parallel/capacity.py). Without a torch.distributed group of more
than one rank they run on the mapper's device: the views and the strips in
turn, and the store whole. With one (the default group, or `group`), the
views, the strips or the store rows split over the largest rank count
that divides them, as the JAX mapper sizes its mesh.

Keyframes without a depth image (stereo and monocular packets) train as
the JAX mapper trains them: build_keyframe gives them an all-zero depth
pyramid, and the step's L1(depth) term (ops/losses.mapping_loss) is taken
against it, as against any depth target. No depth target is made from
the stereo disparity.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import time
import warnings
from typing import Optional

import numpy as np
import torch

from legslam_torch.config import (
    MapperParams,
    OptimizationParams,
    RasterizeConfig,
)
from legslam_torch.mapper.binning_cache import BinningCache
from legslam_torch.mapper.keyframe import MapKeyframe, build_keyframe
from legslam_torch.mapper.train_step import train_step
from legslam_torch.models import gaussians as G
from legslam_torch.ops import losses
from legslam_torch.ops.rasterize import compute_binning, rasterize
from legslam_torch.slam.interface import MappingOperation, OpKind
from legslam_torch.utils import ply, runtime
from legslam_torch.utils.camera import CameraView
from legslam_torch.utils.undistort import build_undistortion

# Point ingest pads each batch to a power-of-two bucket (point_valid masks
# the tail all the way through the 3-NN scale init, so real rows get the
# params of an unpadded call). The JAX package needed the buckets to bound
# its compilations; the port keeps them so both packages' 3-NN init sees
# the same padded batch.
_INGEST_MIN_BUCKET = 1024

def _largest_divisor(n: int, *sizes: int) -> int:
    """The largest count <= n that divides every one of `sizes`."""
    while n > 1 and any(size % n for size in sizes):
        n -= 1
    return max(n, 1)


def _ingest_bucket(n: int, capacity: int) -> int:
    b = max(_INGEST_MIN_BUCKET, 1 << max(n - 1, 1).bit_length())
    return max(_INGEST_MIN_BUCKET, min(b, capacity))


def nerfpp_norm(cam_centers: np.ndarray) -> tuple[np.ndarray, float]:
    """Scene translate/radius: 1.1 x max distance from the camera-center
    centroid (gaussian_scene.cpp getNerfppNorm)."""
    center = cam_centers.mean(axis=0)
    dists = np.linalg.norm(cam_centers - center, axis=-1)
    radius = float(dists.max() * 1.1) if len(dists) else 1.0
    return -center, max(radius, 1e-6)


def rotation_angle_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) * 0.5
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


class GaussianMapper:
    """The online mapper over the keyframe operations `source` yields.

    `cfg` defaults to RasterizeConfig(), whose backend is the "torch"
    reference compositor (as the JAX package's default is its XLA
    reference): a caller on a card passes a cfg with backend="cuda" to
    train and render through the compositing and sort kernels, as the
    app, the harnesses (eval_harness/replica_eval.run_scene) and
    chip_smoke.py do.
    """

    def __init__(self, source, intrinsics: dict,
                 opt: Optional[OptimizationParams] = None,
                 mp: Optional[MapperParams] = None,
                 cfg: Optional[RasterizeConfig] = None,
                 capacity: int = 1 << 18,
                 result_dir: str = "./output",
                 max_per_tile: int = 2048,
                 seed: int = 0,
                 include_lang_feat: bool = True,
                 binning_refresh_interval: int = 1,
                 sensor_type: str = "rgbd",
                 n_views: int = 1,
                 spatial_strips: int = 1,
                 shard_store: bool = False,
                 device: str | torch.device = "cuda",
                 group=None):
        if sensor_type not in ("rgbd", "monocular", "stereo"):
            raise ValueError(f"unsupported sensor type {sensor_type!r}")
        if n_views < 1:
            raise ValueError(f"n_views must be >= 1, got {n_views}")
        if spatial_strips < 1:
            raise ValueError(
                f"spatial_strips must be >= 1, got {spatial_strips}")
        # multi-view batched ticks, tile-row strips and the capacity-
        # sharded store (see the module docstring); n_views=1 keeps the
        # reference's one-keyframe-per-iteration semantics
        self.n_views = n_views
        self.spatial_strips = spatial_strips
        self.shard_store = shard_store
        self._setup_groups(group, capacity)
        self._replicated = None   # the valid tensor last broadcast
        self._wm = (None, 0)      # (valid tensor, its watermark)
        self.source = source
        self.intr = intrinsics
        self.opt = opt or OptimizationParams()
        self.mp = mp or MapperParams()
        self.cfg = cfg or RasterizeConfig()
        self.device = torch.device(device)
        self.capacity = capacity          # ladder MAX (current = state)
        # Geometric capacity ladder: the reference grows its parameter
        # tensors as the map densifies; the store starts at a small rung
        # and re-pads x4 (grow_capacity) at 60% occupancy, so an early
        # online store (~1-10k points) does not pay full-capacity
        # P-bound step costs and full max_pairs sort buffers. One-view,
        # whole-store path only (the others keep `capacity`).
        self.capacity_ladder = n_views == 1 and spatial_strips == 1 and \
            not shard_store
        self._approx_valid = 0
        self._base_max_pairs = self.cfg.max_pairs
        self._pairs_floor = 0   # overflow-escalated max_pairs floor
        # (iteration, [changes]) log of overflow-ladder escalations
        self.overflow_escalations: list[tuple[int, list[str]]] = []
        self.result_dir = result_dir
        self.max_per_tile = max_per_tile
        self.include_lang_feat = include_lang_feat
        self.sensor_type = sensor_type

        # the store (see the `state` property: a sharded store keeps this
        # rank's rows in _state and their gathered whole in _full)
        self.state = None
        self.keyframes: dict[int, MapKeyframe] = {}
        self.iteration = 0
        self.active_sh_degree = 0
        self.cameras_extent = 1.0
        self.scene_translate = np.zeros(3, np.float32)
        self.bg = torch.zeros(3, device=self.device)
        # the split noise of densify_and_prune (jax.random.key(seed) in
        # the JAX package; the two give different draws)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._rng = random.Random(seed)
        self._kf_cycle: list[int] = []
        self._pending_points: list[tuple[np.ndarray, np.ndarray]] = []
        self._depth_cache: list = []
        self._kfs_since_densify_flush = 0
        self.ema_loss = 0.0
        # undistortion maps + valid mask from intrinsics dist_coeffs
        # (camera.h:68-100; None for the pure-pinhole case). Incoming
        # keyframe RGB/depth are remapped and the mask gates the loss
        # (gaussian_mapper.cpp:399-432, 711-721).
        self.undistortion = build_undistortion(intrinsics)
        self.big_points_on = False
        self.loss_sync_interval = 10
        self._last_aux = None
        # the per-(kf, level) tile-binning cache and its trims
        self.binning_cache = BinningCache(binning_refresh_interval)

    def _setup_groups(self, group, capacity: int) -> None:
        """The device-count logic of legslam_tpu/mapper/mapper.py:250-281
        over ranks: the views, else the strips, else the store rows split
        over the largest rank count that divides them (a views x strips
        grid when the default group has a rank for every pair). `group`,
        when given, is that group as it is. No group, or one rank: the
        one-device path."""
        from legslam_torch.parallel import sharded, spatial
        self._group = self._view_group = self._strip_group = None
        self._shard_group = None
        nv, ns = self.n_views, self.spatial_strips
        if group is None:
            import torch.distributed as dist
            if not (dist.is_available() and dist.is_initialized()):
                return
            world = dist.get_world_size()
            if nv > 1 and ns > 1 and world >= nv * ns:
                self._view_group, self._strip_group = spatial.make_groups(
                    nv, ns)
                return
            if nv > 1:
                group = sharded.make_group(_largest_divisor(world, nv))
            elif ns > 1:
                group = sharded.make_group(_largest_divisor(
                    world, ns, *([capacity] if self.shard_store else [])))
            elif self.shard_store:
                group = sharded.make_group(_largest_divisor(world, capacity))
        if sharded.group_size(group) <= 1:
            return
        if nv > 1:
            self._view_group = group
            return
        self._group = group
        if self.shard_store:
            self._shard_group = group

    @property
    def state(self) -> Optional[G.GaussianState]:
        """The whole store. A capacity-sharded one is gathered from the
        ranks' shards (every rank must read it in the same order), and
        the gathered store is kept until the next step or assignment."""
        if self._shard_group is None or self._state is None:
            return self._state
        if self._full is None:
            from legslam_torch.parallel import capacity
            self._full = capacity.gather_state(self._state,
                                               self._shard_group)
        return self._full

    @state.setter
    def state(self, value: Optional[G.GaussianState]) -> None:
        self._full = None
        if self._shard_group is not None and value is not None:
            from legslam_torch.parallel import capacity
            value = capacity.shard_state(value, self._shard_group)
        self._state = value

    def _watermark(self) -> Optional[int]:
        """The store's live watermark for cfg.p_slabs, read on the host
        once per store surgery: only surgery changes `valid` (it returns
        a new store), so the mapper keys the reading on the valid tensor.
        None without slabs or for a sharded store."""
        if not self.cfg.p_slabs or self._shard_group is not None:
            return None
        valid = self._state.valid
        if self._wm[0] is not valid:
            from legslam_torch.ops.slabs import watermark
            self._wm = (valid, int(watermark(valid)))
        return self._wm[1]

    def _replicate(self, *groups) -> None:
        """Make the ranks' stores equal (their groups' rank 0's, in turn)
        after a surgery, before a step over `groups` (the counterpart of
        replicate_state)."""
        from legslam_torch.parallel import sharded
        if self._replicated is not self._state.valid:
            for group in groups:
                sharded.replicate_state(self._state, group)
            self._replicated = self._state.valid

    # ------------------------------------------------------------------
    # Bridge ingestion (combineMappingOperations, gaussian_mapper.cpp:829)
    # ------------------------------------------------------------------
    @runtime.spanned("ingest.keyframe")
    def _ingest_keyframe(self, packet) -> None:
        mp = self.mp
        if packet.fid in self.keyframes:
            kf = self.keyframes[packet.fid]
            kf.set_pose(packet.R, packet.t, self.intr["fx"], self.intr["fy"])
            kf.remaining_times_of_use += mp.local_BA_increased_times_of_use
            return
        mask_full = None
        if self.undistortion is not None:
            und = self.undistortion
            packet = dataclasses.replace(
                packet, color=und.undistort_image(packet.color),
                depth=None if packet.depth is None
                else und.undistort_image(packet.depth))
            mask_full = und.valid_mask
        kf = build_keyframe(
            packet, self.intr, mp.num_gaus_pyramid_sub_levels
            if mp.do_gaus_pyramid_training else 0,
            mp.gaus_pyramid_times_of_use,
            mp.new_keyframe_times_of_use, self.iteration,
            mask_full=mask_full, device=self.device)
        self.keyframes[packet.fid] = kf
        if mp.do_inactive_geo_densify:
            self._cache_inactive_geometry(kf, packet)

    def _cache_inactive_geometry(self, kf: MapKeyframe, packet=None) -> None:
        """Sensor-specific inactive-geometry densification
        (increasePcdByKeyframeInactiveGeoDensify,
        gaussian_mapper.cpp:1253-1492): keypoints without map points get
        their depth from the sensor (RGBD reads the depth image, MONOCULAR
        borrows the nearest keypoint's depth within max_pixel_dist,
        STEREO runs SGM on the rectified pair) and are cached; every
        `depth_cache` keyframes the batch goes into the model."""
        if kf.kp_pixels is None:
            return
        if self.sensor_type == "monocular":
            world, cols, z = self._mono_inactive_geometry(kf)
        elif self.sensor_type == "stereo":
            world, cols, z = self._stereo_inactive_geometry(kf, packet)
        else:
            world, cols, z = self._rgbd_inactive_geometry(kf, packet)
        kf.done_inactive_geo_densify = True
        if world is None or not len(world):
            return
        self._depth_cache.append((world.astype(np.float32),
                                  cols.astype(np.float32),
                                  self._ingest_smax(z)))
        self._kfs_since_densify_flush += 1
        if self._kfs_since_densify_flush >= self.mp.depth_cache:
            self._flush_depth_cache()

    def _rgbd_inactive_geometry(self, kf: MapKeyframe, packet=None):
        if kf.gt_depth is None:
            return None, None, None
        # the packet still holds the host copies: reading those avoids a
        # device-to-host copy of the full-resolution level
        if packet is not None and packet.depth is not None:
            depth = np.asarray(packet.depth, np.float32)
            color = np.asarray(packet.color, np.float32)
        else:
            depth = kf.gt_depth[-1].cpu().numpy()
            color = kf.gt_color[-1].cpu().numpy()
        h, w = depth.shape
        kp = kf.kp_pixels
        has_mp = kf.kp_points_local is not None and \
            (kf.kp_points_local[:, 2] > 0)
        xi = np.clip(kp[:, 0].astype(int), 0, w - 1)
        yi = np.clip(kp[:, 1].astype(int), 0, h - 1)
        d = depth[yi, xi]
        ok = (~has_mp) & (d > self.mp.rgbd_min_depth) & \
            (d < self.mp.rgbd_max_depth)
        if not ok.any():
            return None, None, None
        fx, fy = self.intr["fx"], self.intr["fy"]
        cx, cy = self.intr["cx"], self.intr["cy"]
        # scale intrinsics to the stored full-res level
        sx = w / self.intr["width"]
        sy = h / self.intr["height"]
        cam = np.stack([(kp[ok, 0] - cx * sx) / (fx * sx) * d[ok],
                        (kp[ok, 1] - cy * sy) / (fy * sy) * d[ok],
                        d[ok]], -1)
        world = (cam - kf.t) @ kf.R
        cols = color[yi[ok], xi[ok]]
        return world, cols, d[ok]

    def _mono_inactive_geometry(self, kf: MapKeyframe):
        """Monocular depth-borrow branch (gaussian_mapper.cpp:1262-1300),
        on the mapper's device."""
        from legslam_torch.ops.stereo import mono_borrow_depth
        if kf.kp_points_local is None:
            return None, None, None
        local = np.asarray(kf.kp_points_local)
        has3d = local[:, 2] > 0
        if not has3d.any() or has3d.all():
            return None, None, None
        pts, ok = mono_borrow_depth(
            self._tensor(kf.kp_pixels), self._tensor(local[:, 2]),
            torch.as_tensor(has3d, device=self.device),
            self.mp.mono_max_pixel_dist, self.intr["fx"], self.intr["fy"],
            self.intr["cx"], self.intr["cy"])
        pts, ok = pts.cpu().numpy(), ok.cpu().numpy()
        if not ok.any():
            return None, None, None
        world = (pts[ok] - kf.t) @ kf.R
        color = kf.gt_color[-1].cpu().numpy()
        h, w = color.shape[:2]
        xi = np.clip(kf.kp_pixels[ok, 0].astype(int), 0, w - 1)
        yi = np.clip(kf.kp_pixels[ok, 1].astype(int), 0, h - 1)
        return world, color[yi, xi], pts[ok, 2]

    @runtime.spanned("ingest.stereo")
    def _stereo_inactive_geometry(self, kf: MapKeyframe, packet):
        """Stereo SGM branch (gaussian_mapper.cpp:1302-1405), on the
        mapper's device: every keypoint with a valid disparity, from the
        disparity the frontend put in the packet (one SGM a keyframe), or
        from an SGM of the packet's rectified pair run here when it
        carries none."""
        if packet is None:
            return None, None, None
        disp = getattr(packet, "disparity", None)
        if disp is None and getattr(packet, "color_right", None) is None:
            return None, None, None
        from legslam_torch.ops.stereo import stereo_inactive_geo_densify
        baseline = self.intr.get("stereo_baseline", 0.0)
        if baseline <= 0:
            return None, None, None
        pts, cols, ok = stereo_inactive_geo_densify(
            self._tensor(packet.color),
            None if disp is not None else self._tensor(packet.color_right),
            self._tensor(kf.kp_pixels), self.intr["fx"], self.intr["fy"],
            self.intr["cx"], self.intr["cy"], baseline,
            num_disp=self.mp.stereo_num_disparity,
            min_disp=self.mp.stereo_min_disparity,
            disparity=None if disp is None else disp.to(self.device))
        pts, cols, ok = pts.cpu().numpy(), cols.cpu().numpy(), \
            ok.cpu().numpy()
        if not ok.any():
            return None, None, None
        world = (pts[ok] - kf.t) @ kf.R
        return world, cols[ok], pts[ok, 2]

    @runtime.spanned("ingest.points")
    def _increase_points(self, pts: np.ndarray, cols: np.ndarray,
                         smax: np.ndarray | None = None) -> None:
        """Ingest new points padded to a power-of-two bucket, the tail
        masked. `smax` is the per-point log-scale cap
        (ingest_scale_clamp_px); +inf = no cap."""
        n = pts.shape[0]
        if self.capacity_ladder:
            # grow BEFORE allocating so points are never dropped at a
            # rung that the ladder would have grown past anyway
            while (self.state.capacity < self.capacity and
                   self._approx_valid + n > 0.6 * self.state.capacity):
                self.state = G.grow_capacity(
                    self.state, min(self.state.capacity * 4, self.capacity))
                self._ladder_cfg(self.state.capacity)
                self._invalidate_binning()
        m = _ingest_bucket(n, self.state.capacity)
        k = min(n, m)
        packed = np.zeros((m, 8), np.float32)
        packed[:, 7] = np.inf
        packed[:k, 0:3] = pts[:k]
        packed[:k, 3:6] = cols[:k]
        packed[:k, 6] = 1.0
        if smax is not None:
            packed[:k, 7] = smax[:k]
        if n > m:  # beyond capacity: count the tail as overflow-dropped
            self.state.overflow_dropped += n - m
        # one host-to-device copy: xyz | rgb | valid | smax
        pk = torch.as_tensor(packed, device=self.device)
        self.state = G.increase_pcd(
            self.state, pk[:, 0:3], pk[:, 3:6], self.iteration,
            point_valid=pk[:, 6] > 0.5, max_log_scale=pk[:, 7])
        self._approx_valid = min(self._approx_valid + k,
                                 self.state.capacity)
        # pure point-add leaves cached binnings valid but stale (existing
        # slots are untouched): they miss the new points until a refresh
        if self.binning_cache.refresh_interval <= 1:
            self._invalidate_binning()

    def _ingest_smax(self, z: np.ndarray | None) -> np.ndarray | None:
        """Per-point log-scale cap from camera depth: screen radius
        3*scale*f/z <= ingest_scale_clamp_px (the prune-big size_th bound
        applied at creation; gaussian_mapper.cpp:737-755)."""
        px = self.mp.ingest_scale_clamp_px
        if z is None or px <= 0:
            return None
        zc = np.maximum(np.asarray(z, np.float32), 1e-3)
        return np.log((px / 3.0) * zc / self.intr["fx"]).astype(np.float32)

    @runtime.spanned("ingest.flush")
    def _flush_depth_cache(self) -> None:
        if not self._depth_cache or self.state is None:
            self._kfs_since_densify_flush = 0
            return
        pts = np.concatenate([p for p, _, _ in self._depth_cache])
        cols = np.concatenate([c for _, c, _ in self._depth_cache])
        smax = np.concatenate([np.full((len(p),), np.inf, np.float32)
                               if m is None else m
                               for p, _, m in self._depth_cache])
        self._depth_cache.clear()
        self._kfs_since_densify_flush = 0
        if pts.shape[0] >= self.mp.min_num_inactive_geo_densify:
            self._increase_points(pts, cols, smax)

    def handle_operation(self, op: MappingOperation) -> None:
        if op.kind == OpKind.LOCAL_BA:
            for packet in op.keyframes:
                self._ingest_keyframe(packet)
            if op.points_xyz is not None and len(op.points_xyz) >= \
                    self.mp.min_num_inactive_geo_densify:
                if self.state is not None:
                    pts_w = np.asarray(op.points_xyz, np.float32)
                    z = None
                    if op.keyframes:
                        pk = op.keyframes[-1]
                        z = pts_w @ pk.R[2] + pk.t[2]  # depth in newest KF
                    self._increase_points(
                        pts_w, np.asarray(op.points_color, np.float32),
                        self._ingest_smax(z))
                else:
                    self._pending_points.append(
                        (op.points_xyz, op.points_color))
            elif op.points_xyz is not None and self.state is None:
                self._pending_points.append(
                    (op.points_xyz, op.points_color))
        elif op.kind == OpKind.LOOP_CLOSE_BA:
            self._handle_loop_closure(op)
        elif op.kind == OpKind.SCALE_REFINEMENT:
            self._handle_scale_refinement(op)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _handle_loop_closure(self, op: MappingOperation) -> None:
        """Per-KF pose-delta check -> masked point surgery
        (gaussian_mapper.cpp:878-979)."""
        if self.state is None:
            for packet in op.keyframes:
                self._ingest_keyframe(packet)
            return
        not_transformed = torch.ones(self.state.capacity, dtype=torch.bool,
                                     device=self.device)
        for packet in op.keyframes:
            old = self.keyframes.get(packet.fid)
            if old is None:
                self._ingest_keyframe(packet)
                continue
            old_w2c = np.eye(4, dtype=np.float32)
            old_w2c[:3, :3], old_w2c[:3, 3] = old.R, old.t
            new_w2c = np.eye(4, dtype=np.float32)
            new_w2c[:3, :3], new_w2c[:3, 3] = packet.R, packet.t
            diff = np.linalg.inv(new_w2c) @ old_w2c  # old-cam -> new-cam
            # per-KF Sim(3) scale on top of the op-level scale; the
            # surgery applies x' = s*R_diff x + diff_t, so the Sim(3)-exact
            # translation is s * R_wc_new @ t_cw_old + t_wc_new
            eff_scale = float(op.scale) * float(
                getattr(packet, "scale", 1.0) or 1.0)
            diff_t = eff_scale * (packet.R.T @ old.t) - \
                packet.R.T @ packet.t
            big_rot = rotation_angle_deg(diff[:3, :3]) > self.mp.large_rot_th
            big_trans = np.linalg.norm(diff[:3, 3]) > self.mp.large_trans_th
            big_scale = abs(eff_scale - 1.0) > 0.01
            if big_rot or big_trans or big_scale:
                self.state, not_transformed, _ = G.transform_visible_points(
                    self.state, not_transformed, self._tensor(diff[:3, :3]),
                    self._tensor(diff_t), self._tensor(old_w2c),
                    old.creation_iter, self.mp.stable_num_iter_existence,
                    eff_scale)
            old.set_pose(packet.R, packet.t, self.intr["fx"],
                         self.intr["fy"])
            old.remaining_times_of_use += \
                self.mp.loop_closure_increased_times_of_use
        self._invalidate_binning()

    def _handle_scale_refinement(self, op: MappingOperation) -> None:
        """applyScaledTransformation over the whole map with the op's full
        similarity (gaussian_mapper.cpp:982-1016): the rigid part is the
        world-frame delta of the first already-known keyframe's corrected
        pose; pure-scale refinements have the identity delta."""
        diff_R, diff_t = np.eye(3, dtype=np.float32), \
            np.zeros(3, dtype=np.float32)
        for packet in op.keyframes:
            old = self.keyframes.get(packet.fid)
            if old is not None:
                old_w2c = np.eye(4, dtype=np.float32)
                old_w2c[:3, :3], old_w2c[:3, 3] = old.R, old.t
                new_w2c = np.eye(4, dtype=np.float32)
                new_w2c[:3, :3], new_w2c[:3, 3] = packet.R, packet.t
                diff = np.linalg.inv(new_w2c) @ old_w2c
                diff_R, diff_t = diff[:3, :3], diff[:3, 3]
                break
        if self.state is not None:
            self.state = G.apply_scaled_transformation(
                self.state, op.scale, self._tensor(diff_R),
                self._tensor(diff_t))
        self._invalidate_binning()
        for packet in op.keyframes:
            self._ingest_keyframe(packet)

    # ------------------------------------------------------------------
    # Phases (run, gaussian_mapper.cpp:361-554)
    # ------------------------------------------------------------------
    def has_met_initial_conditions(self) -> bool:
        return (len(self.keyframes) >= self.mp.min_num_initial_map_kfs or
                (self.source.is_shutdown() and len(self.keyframes) > 0))

    @runtime.spanned("map.init")
    def initialize_map(self) -> None:
        pts = [p for p, _ in self._pending_points]
        cols = [c for _, c in self._pending_points]
        self._pending_points.clear()
        if pts:
            xyz = np.concatenate(pts)
            rgb = np.concatenate(cols)
        else:
            xyz = np.zeros((0, 3), np.float32)
            rgb = np.zeros((0, 3), np.float32)
        n = min(xyz.shape[0], self.capacity)
        cap0 = self.capacity
        if self.capacity_ladder:
            need = 1 << max(n * 2 - 1, 1).bit_length()
            cap0 = min(self.capacity, max(1 << 15, need))
        self.state = G.create_from_pcd(xyz[:n], rgb[:n], cap0,
                                       device=self.device)
        self._approx_valid = n
        if self.capacity_ladder:
            self._ladder_cfg(cap0)
        centers = [-(kf.R.T @ kf.t) for kf in self.keyframes.values()]
        self.scene_translate, self.cameras_extent = nerfpp_norm(
            np.asarray(centers, np.float32))

    @runtime.spanned("drain")
    def drain_operations(self, limit: int = 32) -> None:
        for _ in range(limit):
            op = self.source.pop_operation()
            if op is None:
                break
            self.handle_operation(op)
        if self.mp.cull_keyframes:
            self.cull_keyframes()

    def cull_keyframes(self) -> None:
        """Drop mapper keyframes the SLAM frontend no longer tracks
        (gaussian_mapper.cpp:1235-1251)."""
        getter = getattr(self.source, "live_keyframe_ids", None)
        if getter is None:
            return
        live = getter()
        if not live:
            return
        for fid in [f for f in self.keyframes if f not in live]:
            del self.keyframes[fid]

    def _pick_keyframe(self) -> Optional[MapKeyframe]:
        """Shuffled times-of-use scheduler
        (useOneRandomSlidingWindowKeyframe, gaussian_mapper.cpp:1158-1204).
        random.Random(seed), as in the JAX package, so both pick the same
        keyframes."""
        if not self.keyframes:
            return None
        self._kf_cycle = [f for f in self._kf_cycle if f in self.keyframes]
        if not self._kf_cycle:
            usable = [f for f, kf in self.keyframes.items()
                      if kf.remaining_times_of_use > 0]
            if not usable:
                for kf in self.keyframes.values():
                    kf.remaining_times_of_use += 1
                usable = list(self.keyframes)
            self._rng.shuffle(usable)
            self._kf_cycle = usable
        fid = self._kf_cycle.pop()
        kf = self.keyframes[fid]
        kf.remaining_times_of_use = max(kf.remaining_times_of_use - 1, 0)
        kf.record["used"] = kf.record.get("used", 0) + 1
        return kf

    def _invalidate_binning(self) -> None:
        self.binning_cache.invalidate()

    @property
    def fresh_binnings(self) -> int:
        """Binnings computed afresh (cache fills)."""
        return self.binning_cache.fills

    def binning_for(self, view: CameraView, cfg: RasterizeConfig):
        """(Binning, overflow) of the current state from `view` under
        `cfg`, as the binning cache computes it."""
        st = self.state
        return compute_binning(
            st.params.xyz, torch.exp(st.params.scaling), st.params.rotation,
            st.valid, view.world_view, view.full_proj, view.tan_fovx,
            view.tan_fovy, view.width, view.height, cfg,
            max_per_tile=self.max_per_tile,
            opacity=torch.sigmoid(st.params.opacity[:, 0]))

    def _fill_binning(self, view):
        with runtime.span("map.binning"):
            return self.binning_for(view, self.cfg)

    def _fill_binning_spatial(self, view, layout, crop_ys):
        """The per-strip binnings of this rank's strips."""
        from legslam_torch.parallel import spatial
        mine = [crop_ys[i]
                for i in spatial.local_strips(len(crop_ys), self._group)]
        st = self.state
        with runtime.span("map.binning"):
            return spatial.spatial_compute_binning(
                st.params.xyz, torch.exp(st.params.scaling),
                st.params.rotation, st.valid, view.world_view,
                view.full_proj, view.tan_fovx, view.tan_fovy, mine,
                width=view.width, height=view.height,
                h_local=layout.h_local, cfg=self.cfg,
                max_per_tile=self.max_per_tile,
                opacity=torch.sigmoid(st.params.opacity[:, 0]),
                watermark_hint=self._watermark())

    def _spatial_step(self, kf, lvl: int, view, gt_lf, include_lf: bool,
                      lr_step: int):
        """The one-view step rendered in tile-row strips
        (parallel/spatial.py; train_step's semantics), the strips split
        over the mapper's group, and the store over it too with
        shard_store."""
        from legslam_torch.parallel import spatial
        layout = spatial.spatial_layout(view.height, self.cfg.tile_h,
                                        self.spatial_strips)

        # the padded targets are a function of (kf, level) alone
        def compute_gt():
            if include_lf:
                lf = spatial.pad_rows(gt_lf, layout.h_padded)
            else:
                lf = torch.zeros(layout.h_padded, view.width, 1,
                                 device=self.device)
            pads = [spatial.pad_rows(a, layout.h_padded) for a in
                    (kf.gt_color[lvl], kf.gt_depth[lvl], kf.mask[lvl])]
            return spatial.strip_offsets(layout), lf, pads

        cys, lf, pads = self.binning_cache.keep((kf.fid, lvl, "spatial_gt"),
                                                compute_gt)
        binning, _ = self.binning_cache.get(
            (kf.fid, lvl, "spatial"),
            lambda: self._fill_binning_spatial(view, layout, cys))
        if self._shard_group is None:
            self._replicate(self._group)
        self._full = None
        return spatial.spatial_train_step(
            self._state, view.world_view, view.full_proj, view.cam_center,
            view.tan_fovx, view.tan_fovy, pads[0], lf, pads[1], pads[2],
            self.bg, float(lr_step), float(self.cameras_extent), cys,
            width=view.width, height=view.height, h_local=layout.h_local,
            active_sh_degree=self.active_sh_degree, opt=self.opt,
            cfg=self.cfg, include_lang_feat=include_lf,
            max_per_tile=self.max_per_tile, binning=binning,
            group=self._group, shard_store=self._shard_group is not None,
            watermark_hint=self._watermark())

    def train_iteration(self) -> Optional[float]:
        """One trainForOneIteration (gaussian_mapper.cpp:624-798): a tick
        of n_views keyframes, else one keyframe's step (whole or in
        strips); a "map_iter" span on every path. Then the periodic loss
        fetch, the overflow response (one view), densification and the
        capacity ladder (the one-view, whole-store path)."""
        if self.state is None:
            return None
        with runtime.span("map_iter") as sp:
            kfs = []
            for _ in range(self.n_views):
                kf = self._pick_keyframe()
                if kf is None:
                    break
                kfs.append(kf)
            if not kfs:
                return None
            self.iteration += 1
            opt = self.opt
            # SH degree ramp (+1 / sh_degree_interval, gm.cpp:663)
            if self.iteration % opt.sh_degree_interval == 0 and \
                    self.active_sh_degree < opt.sh_degree:
                self.active_sh_degree += 1
            if self.n_views > 1:
                aux = self._train_views(kfs)
            else:
                aux = self._train_one(kfs[0], sp)
            # fetch the loss only periodically: each fetch waits for the
            # card
            self._last_aux = aux
            loss = None
            if self.iteration % self.loss_sync_interval == 0:
                with runtime.span("map.loss_sync"):
                    loss, dropped, rendered, nvalid = aux.sync3.tolist()
                self._approx_valid = int(nvalid)
                self.ema_loss = 0.6 * loss + 0.4 * self.ema_loss \
                    if self.iteration > 1 else loss
                # overflow guardrail: the reference never drops pairs
                # (rasterize_points.cu:29-35 resizes its buffers to
                # num_rendered); when a static cap clips > 0.1% the
                # mapper escalates that cap to its next rung, and only
                # warns once nothing is left to escalate
                dropped = int(dropped)
                rendered = max(int(rendered), 1)
                if self.n_views == 1 and dropped > 0 and \
                        dropped / rendered > 1e-3:
                    self._respond_to_overflow(dropped, rendered)
            self._post_step_densify()
            self._maybe_grow_capacity()
            return loss

    def _train_one(self, kf: MapKeyframe, sp):
        """One keyframe's step, whole or in strips; returns its StepAux."""
        lvl = min(kf.pick_pyramid_level(), len(kf.views) - 1)
        sp.set(iteration=self.iteration, keyframe=kf.fid, level=lvl)
        view = kf.views[lvl]
        include_lf = self.include_lang_feat and kf.gt_lf is not None
        # the raw LF grid; train_step upsamples it to the level
        gt_lf = kf.gt_lf if include_lf else None
        # position LR step = per-KF use count clamped (gm.cpp:671-684)
        lr_step = min(kf.record.get("used", 1),
                      self.mp.position_lr_max_steps_slam)

        if self.spatial_strips > 1:
            if include_lf:  # the strips crop rows: full-resolution LF
                from legslam_torch.mapper.train_step import upsample_lf
                gt_lf = upsample_lf(gt_lf, view.height, view.width)
            self._state, aux = self._spatial_step(kf, lvl, view, gt_lf,
                                                  include_lf, lr_step)
            return aux

        cfg = self.cfg
        key = (kf.fid, lvl)
        binning, emit = self.binning_cache.get(
            key, lambda: self._fill_binning(view), cfg)
        # a sharded store steps on this rank's rows (self._state)
        self._full = None
        self._state, aux = train_step(
            self._state, view.world_view, view.full_proj, view.cam_center,
            view.tan_fovx, view.tan_fovy, kf.gt_color[lvl], gt_lf,
            kf.gt_depth[lvl], kf.mask[lvl], self.bg, float(lr_step),
            float(self.cameras_extent), width=view.width, height=view.height,
            active_sh_degree=self.active_sh_degree, opt=self.opt, cfg=cfg,
            include_lang_feat=include_lf, max_per_tile=self.max_per_tile,
            binning=binning, emit_kfin=emit, gather_group=self._shard_group,
            watermark_hint=self._watermark())
        if emit and aux.kfin is not None:
            self.binning_cache.trimmed(key, binning, aux.kfin, cfg)
        return aux

    def _respond_to_overflow(self, dropped: int, rendered: int) -> None:
        """Adaptive response to pair overflow (the reference never drops
        pairs, rasterize_points.cu:29-35; the static-shape equivalent is a
        cap ladder that escalates on demand).

        `rendered` is the pair count before truncation, so the max_pairs
        share of the drop is trunc = rendered - max_pairs and the rest was
        clipped by the static tile-span cap. max_pairs escalates to ~2x
        the observed footprint (pow2, bounded by the configured budget);
        the span cap doubles its y rows first (tile_h=16 makes span_y the
        binding axis for close-up footprints), then x, until the span
        covers the whole tile grid. Only when nothing is left to escalate
        does the warning fire. One-view, one-render path only (the
        batched and strip paths keep their caps, as in JAX)."""
        escalatable = self.n_views == 1 and self.spatial_strips == 1
        kernels = self.cfg.backend == "cuda"
        # the bucketed layout has no max_pairs truncation (its drop is the
        # per-bucket caps')
        flat = kernels and self.cfg.n_buckets == 1
        trunc = max(0, rendered - self.cfg.max_pairs) if flat else 0
        span_drop = dropped - trunc
        changed = []
        if escalatable and trunc > 0:
            want = 1 << max(int(np.ceil(np.log2(max(2 * rendered, 2)))),
                            16)
            floor = min(want, self._base_max_pairs)
            if floor > self._pairs_floor:
                self._pairs_floor = floor
                if floor > self.cfg.max_pairs:
                    self.cfg = dataclasses.replace(self.cfg, max_pairs=floor)
                    changed.append(f"max_pairs->{floor}")
        if escalatable and span_drop / rendered > 1e-3:
            msx, msy = self.cfg.max_span_x, self.cfg.max_span_y
            nty = -(-int(self.intr["height"]) // self.cfg.tile_h)
            ntx = -(-int(self.intr["width"]) // self.cfg.tile_w)
            if msy < nty:
                self.cfg = dataclasses.replace(self.cfg,
                                               max_span_y=min(2 * msy, nty))
                changed.append(f"max_span_y->{self.cfg.max_span_y}")
            elif msx < ntx:
                self.cfg = dataclasses.replace(self.cfg,
                                               max_span_x=min(2 * msx, ntx))
                changed.append(f"max_span_x->{self.cfg.max_span_x}")
            elif not kernels and self.max_per_tile < (1 << 16):
                # span already covers the grid: on the "torch" backend the
                # remaining clip is the per-tile cap
                self.max_per_tile = min(2 * self.max_per_tile, 1 << 16)
                changed.append(f"max_per_tile->{self.max_per_tile}")
        if changed:
            # cached binnings carry buffers shaped by the OLD caps
            self._invalidate_binning()
            self.overflow_escalations.append((self.iteration, changed))
            logging.info(
                "pair overflow (%d of %d at iter %d): escalated %s",
                dropped, rendered, self.iteration, ", ".join(changed))
        else:
            warnings.warn(
                f"rasterizer pair overflow: {dropped} of {rendered} "
                f"pairs dropped at iter {self.iteration} and no cap "
                "rung left to escalate — raise max_pairs/max_span/"
                "max_per_tile explicitly", RuntimeWarning)

    def _maybe_grow_capacity(self) -> None:
        if self.state is None or not self.capacity_ladder:
            return
        cap = self.state.capacity
        if cap >= self.capacity or self._approx_valid <= 0.6 * cap:
            return
        new_cap = min(cap * 4, self.capacity)
        with runtime.span("map.grow", capacity=new_cap):
            self.state = G.grow_capacity(self.state, new_cap)
        self._ladder_cfg(new_cap)
        self._invalidate_binning()

    def _ladder_cfg(self, cap: int) -> None:
        """Scale the pair budget with the rung: a 1k-point early store
        under the full max_pairs would sort a 1M-row buffer per binning
        refresh for ~10k real pairs. 8 pairs a gaussian is ~3x the
        converged footprint; overflow still escalates."""
        mp = min(self._base_max_pairs,
                 max(1 << 16, 8 * cap, self._pairs_floor))
        if mp != self.cfg.max_pairs:
            self.cfg = dataclasses.replace(self.cfg, max_pairs=mp)

    def _post_step_densify(self) -> None:
        """Densification schedule (gaussian_mapper.cpp:737-760)."""
        opt = self.opt
        if self.iteration < opt.densify_until_iter:
            if opt.prune_big_point_after_iter and \
                    self.iteration > opt.prune_big_point_after_iter:
                self.big_points_on = True
            if self.iteration > opt.densify_from_iter and \
                    self.iteration % opt.densification_interval == 0:
                with runtime.span("map.densify"):
                    self.state = G.densify_and_prune(
                        self.state, self.generator,
                        opt.densify_grad_threshold, opt.densify_min_opacity,
                        float(self.cameras_extent),
                        opt.max_screen_size if self.big_points_on else None,
                        opt.percent_dense)
                self._invalidate_binning()
            if opt.opacity_reset_interval > 0 and \
                    self.iteration % opt.opacity_reset_interval == 0:
                self.state = G.reset_opacity(self.state)
                self._invalidate_binning()

    def _train_views(self, kfs: list):
        """One tick of the keyframes `kfs` (n_views or fewer) through
        parallel/sharded.batched_train_step (its strip form with
        spatial_strips > 1): the per-view masked loss and per-view densify
        statistics of the gaussian_mapper.cpp:624-798 loop, one Adam
        update on the mean-of-views gradient. A short batch is padded by
        reusing its keyframes; the first keyframe's pyramid pick sets the
        one level of the tick. Returns the StepAux."""
        from legslam_torch.mapper.train_step import upsample_lf
        from legslam_torch.parallel import sharded, spatial
        n0 = len(kfs)
        while len(kfs) < self.n_views:     # pad short batches by reuse
            kfs.append(kfs[len(kfs) % n0])
        opt = self.opt
        lvl = min(kfs[0].pick_pyramid_level(),
                  min(len(kf.views) - 1 for kf in kfs))
        views = [kf.views[lvl] for kf in kfs]
        include_lf = self.include_lang_feat and \
            all(kf.gt_lf is not None for kf in kfs)
        h, w = views[0].height, views[0].width
        if include_lf:
            gt_lf = torch.stack([upsample_lf(kf.gt_lf, h, w) for kf in kfs])
        else:
            gt_lf = torch.zeros(len(kfs), h, w, 1, device=self.device)
        batch = sharded.make_view_batch(
            views, torch.stack([kf.gt_color[lvl] for kf in kfs]), gt_lf,
            torch.stack([kf.gt_depth[lvl] for kf in kfs]),
            torch.stack([kf.mask[lvl] for kf in kfs]))
        lr_step = min(max(kf.record.get("used", 1) for kf in kfs),
                      self.mp.position_lr_max_steps_slam)
        batch = sharded.shard_batch(batch, self._view_group)
        self._replicate(self._view_group, self._strip_group)
        if self.spatial_strips > 1:
            layout = spatial.spatial_layout(h, self.cfg.tile_h,
                                            self.spatial_strips)
            batch = batch._replace(**{
                k: torch.stack([spatial.pad_rows(x, layout.h_padded)
                                for x in getattr(batch, k)])
                for k in ("gt_color", "gt_lang_feat", "gt_depth", "mask")})
            self._state, aux = spatial.spatial_batched_train_step(
                self._state, batch, self.bg, float(lr_step),
                float(self.cameras_extent), spatial.strip_offsets(layout),
                width=w, height=h, h_local=layout.h_local,
                active_sh_degree=self.active_sh_degree, opt=opt,
                cfg=self.cfg, include_lang_feat=include_lf,
                max_per_tile=self.max_per_tile,
                view_group=self._view_group, strip_group=self._strip_group)
        else:
            self._state, aux = sharded.batched_train_step(
                self._state, batch, self.bg, float(lr_step),
                float(self.cameras_extent), width=w, height=h,
                active_sh_degree=self.active_sh_degree, opt=opt,
                cfg=self.cfg, include_lang_feat=include_lf,
                max_per_tile=self.max_per_tile, group=self._view_group)
        return aux

    def run(self, max_iterations: Optional[int] = None,
            tail_iterations: Optional[int] = None) -> None:
        """Blocking 3-phase lifecycle."""
        opt = self.opt
        # Phase 1: initial mapping
        while not self.has_met_initial_conditions():
            self.drain_operations()
            if self.source.is_shutdown() and not self.source.has_operation():
                break
            time.sleep(0.001)
        self.drain_operations(limit=10_000)
        self.initialize_map()
        self.train_iteration()

        # Phase 2: incremental
        limit = max_iterations or opt.iterations
        while self.iteration < limit:
            if self.source.is_shutdown() and not self.source.has_operation():
                break
            self.drain_operations()
            self.train_iteration()

        # Phase 3: tail (0.8 * densify_interval extra, gm.cpp:538-546)
        tail = tail_iterations if tail_iterations is not None else \
            int(0.8 * opt.densification_interval)
        for _ in range(tail):
            if self.iteration >= limit:
                break
            self.train_iteration()

    # ------------------------------------------------------------------
    # Rendering / persistence (renderFromPose :1543, savePly :1679)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_from_pose(self, R: np.ndarray, t: np.ndarray, width: int,
                         height: int, fx: Optional[float] = None,
                         fy: Optional[float] = None,
                         include_lang_feat: bool = False):
        fx = fx if fx is not None else self.intr["fx"]
        fy = fy if fy is not None else self.intr["fy"]
        view = CameraView.create(R, t, width, height, fx=fx, fy=fy,
                                 device=self.device)
        st = self.state
        return rasterize(
            st.params.xyz, st.sh(), st.params.lang_feat, st.opacities(),
            st.scales(), st.params.rotation, st.valid, view, self.bg,
            self.active_sh_degree, self.cfg,
            include_lang_feat=include_lang_feat,
            max_per_tile=self.max_per_tile)

    def save(self, subdir: str = "experiment") -> str:
        """Write the reference's run-output layout (SURVEY.md §3.6):
        <out>/<subdir>/ply/point_cloud/point_cloud.ply, input.ply,
        cameras.json, cfg_args."""
        base = os.path.join(self.result_dir, subdir, "ply")
        os.makedirs(os.path.join(base, "point_cloud"), exist_ok=True)
        st = self.state
        valid = st.valid.cpu().numpy()

        def host(x):
            return x.detach().cpu().numpy()[valid]
        p = st.params
        ply.save_gaussian_ply(
            os.path.join(base, "point_cloud", "point_cloud.ply"),
            host(p.xyz), host(p.f_dc), host(p.f_rest), host(p.lang_feat),
            host(p.opacity), host(p.scaling), host(p.rotation))
        ply.save_point_ply(os.path.join(base, "input.ply"), host(p.xyz))
        cams = []
        for fid, kf in sorted(self.keyframes.items()):
            v = kf.views[-1]
            center = -(kf.R.T @ kf.t)
            cams.append(dict(
                id=int(fid), img_name=f"{fid:06d}", width=v.width,
                height=v.height, position=[float(x) for x in center],
                rotation=[[float(x) for x in row] for row in kf.R.T],
                fx=float(v.focal_x), fy=float(v.focal_y)))
        with open(os.path.join(base, "cameras.json"), "w") as f:
            json.dump(cams, f)
        with open(os.path.join(base, "cfg_args"), "w") as f:
            f.write(f"Namespace(data_device='{self.device.type}', "
                    "eval=False, images='images', "
                    f"model_path='{base}', resolution=-1, "
                    "sh_degree=3, white_background=False)\n")
        return base

    def record_keyframe_metrics(self, subdir: str = "experiment") -> dict:
        """renderAndRecordAllKeyframes equivalent: per-KF PSNR/DSSIM/render
        time artifacts (gaussian_mapper.cpp:1592-1677)."""
        out_dir = os.path.join(self.result_dir, subdir)
        os.makedirs(out_dir, exist_ok=True)
        psnrs, dssims, times = [], [], []
        for fid, kf in sorted(self.keyframes.items()):
            t0 = time.perf_counter()
            out = self.render_from_pose(
                kf.R, kf.t, kf.views[-1].width, kf.views[-1].height)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = (time.perf_counter() - t0) * 1e3
            gt = kf.gt_color[-1]
            psnrs.append(float(losses.psnr_gaussian_splatting(out.color, gt)))
            dssims.append(float(1.0 - losses.ssim(out.color, gt)))
            times.append(dt)
        for name, vals in (("psnr_gaussian_splatting.txt", psnrs),
                           ("dssim.txt", dssims),
                           ("render_time.txt", times)):
            with open(os.path.join(out_dir, name), "w") as f:
                f.writelines(f"{v}\n" for v in vals)
        return dict(psnr=float(np.mean(psnrs)) if psnrs else 0.0,
                    dssim=float(np.mean(dssims)) if dssims else 0.0,
                    render_ms=float(np.mean(times)) if times else 0.0)
