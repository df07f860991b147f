"""Synthetic RGB-D sequence for tests, demos and the chip smoke run.

Counterpart of legslam_tpu/data/synthetic.py: a procedural "room" of
colored gaussians, GT color/depth rendered from a circular camera path by
the port's reference ("torch") compositor under torch.no_grad(), served
through the BaseDataset interface. The scene and poses are the JAX
module's, draw for draw, from the same seed. Frames are rendered on
first read and kept in memory; `preload` renders them all at once, backed
by an npz cache in a directory the caller names.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from legslam_torch.config import RasterizeConfig
from legslam_torch.data.datasets import BaseDataset, RGBDFrame
from legslam_torch.ops.rasterize import rasterize
from legslam_torch.utils.camera import CameraView
from legslam_torch.utils.sh import rgb_to_sh


def _look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """camera-to-world with +z forward (OpenCV convention)."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


class SyntheticDataset(BaseDataset):
    depth_scale = 1.0

    def __init__(self, n_frames: int = 40, width: int = 320,
                 height: int = 192, n_gaussians: int = 6000, seed: int = 0,
                 radius: float = 2.0, revolutions: float = 0.5,
                 clutter_ratio: float = 0.5,
                 device: str | torch.device = "cuda"):
        rng = np.random.default_rng(seed)
        self.intrinsics = dict(width=width, height=height,
                               fx=0.8 * width, fy=0.8 * width,
                               cx=width / 2 - 0.5, cy=height / 2 - 0.5)
        # a box room: gaussians on the walls of a [-4,4]^3 cube + clutter.
        # clutter_ratio=0 gives a surface-only scene (coherent depth); the
        # default half-clutter fog stresses the renderer instead.
        n_wall = n_gaussians - int(n_gaussians * clutter_ratio)
        walls = rng.uniform(-4, 4, size=(n_wall, 3)).astype(np.float32)
        axis = rng.integers(0, 3, n_wall)
        sign = rng.choice([-4.0, 4.0], n_wall)
        walls[np.arange(n_wall), axis] = sign
        clutter = rng.uniform(-3, 3, size=(n_gaussians - n_wall, 3)) \
            .astype(np.float32)
        self._xyz = np.concatenate([walls, clutter])
        self._colors = rng.uniform(0.1, 0.9, size=(n_gaussians, 3)) \
            .astype(np.float32)
        self._lf = rng.normal(size=(n_gaussians, 64)).astype(np.float32)
        self._lf /= np.linalg.norm(self._lf, axis=-1, keepdims=True)
        self._scales = np.full((n_gaussians, 3), 0.12, np.float32)
        self._opacity = np.full((n_gaussians,), 0.9, np.float32)
        self._quats = np.tile(np.array([1, 0, 0, 0], np.float32),
                              (n_gaussians, 1))

        self._poses = []
        for i in range(n_frames):
            a = 2 * np.pi * i / max(n_frames, 1) * revolutions
            eye = (radius * np.cos(a), 0.3 * np.sin(2 * a),
                   radius * np.sin(a))
            self._poses.append(_look_at(eye, (0.0, 0.0, 0.0)))
        self._n = n_frames
        self.device = torch.device(device)
        self._cfg = RasterizeConfig(max_span_x=4, max_span_y=8, chunk=128,
                                    tile_batch=8)
        self._cache: dict[int, RGBDFrame] = {}

    def __len__(self) -> int:
        return self._n

    def gaussian_world(self):
        """Ground-truth gaussian field (for renderer-level tests)."""
        return dict(xyz=self._xyz, colors=self._colors, lf=self._lf,
                    scales=self._scales, opacity=self._opacity,
                    quats=self._quats)

    def cache_key(self) -> str:
        """Digest of everything a frame depends on (scene + poses + cfg +
        the device type, whose rounding the frames carry), for the
        on-disk preload cache."""
        h = hashlib.sha1()
        for a in (self._xyz, self._colors, self._scales, self._opacity,
                  np.asarray(self._poses, np.float32)):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(json.dumps(
            [self.intrinsics, repr(self._cfg), self.device.type, 1],
            sort_keys=True).encode())
        return h.hexdigest()[:16]

    def preload(self, cache_dir: str | None = None) -> None:
        """Render ALL frames into the in-memory cache. With `cache_dir`,
        they are also backed by an npz there, so a later process with the
        same scene reads the file instead of rendering."""
        if len(self._cache) == self._n:
            return
        if cache_dir is None:
            for i in range(self._n):
                self.read(i)
            return
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"gt_{self.cache_key()}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                color, depth = z["color"], z["depth"]
            for i in range(self._n):
                self._cache[i] = RGBDFrame(
                    index=i, timestamp=float(i), color=color[i],
                    depth=depth[i], c2w=self._poses[i])
            return
        frames = [self.read(i) for i in range(self._n)]
        tmp = path[:-4] + f".tmp{os.getpid()}.npz"
        np.savez(tmp, color=np.stack([f.color for f in frames]),
                 depth=np.stack([f.depth for f in frames]))
        os.replace(tmp, path)

    @torch.no_grad()
    def read(self, i: int) -> RGBDFrame:
        if i in self._cache:
            return self._cache[i]
        intr = self.intrinsics
        c2w = self._poses[i]
        w2c = np.linalg.inv(c2w)
        dev = self.device
        view = CameraView.create(
            w2c[:3, :3], w2c[:3, 3], intr["width"], intr["height"],
            fx=intr["fx"], fy=intr["fy"], device=dev)

        def t(a):
            return torch.as_tensor(a, device=dev)
        n = self._xyz.shape[0]
        sh = torch.zeros(n, 16, 3, device=dev)
        sh[:, 0] = rgb_to_sh(t(self._colors))
        out = rasterize(
            t(self._xyz), sh, t(self._lf), t(self._opacity), t(self._scales),
            t(self._quats), torch.ones(n, dtype=torch.bool, device=dev),
            view, torch.zeros(3, device=dev), active_sh_degree=0,
            cfg=self._cfg, max_per_tile=1024)
        # sensor-like surface depth: the raw composite is alpha-weighted
        # (sums w_i * d_i with leftover transmittance unassigned), which
        # underestimates depth on soft/background pixels; normalize by the
        # hit probability and invalidate near-misses like a real RGB-D
        # sensor reports holes
        hit = 1.0 - out.final_t.cpu().numpy()
        depth = np.where(hit > 0.5, out.depth.cpu().numpy() / np.maximum(
            hit, 1e-6), 0.0).astype(np.float32)
        frame = RGBDFrame(
            index=i, timestamp=float(i),
            color=np.clip(out.color.cpu().numpy(), 0.0, 1.0),
            depth=depth, c2w=c2w)
        self._cache[i] = frame
        return frame
