"""The benchmark's inputs for the online loop: a procedural office room
seen along a handheld camera path, made from the seed on the device.

The room is a 6 x 5 x 3 m box with a dozen boxes as furniture along its
walls. Every surface carries seeded value-noise texture, so corners, the
encoder and the photometric loss see structure. Frames are ray-cast in
closed form in plain torch and kept on the host in the form a dataset
stores them: uint8 colour and uint16 depth quantised by the camera's
depth factor (Replica 6553.5 a metre, ScanNet 1000). Every seed gives a
room of the same size, the same number of boxes and a path of the same
length and speed; the seed moves the boxes, the textures and the wobble
of the path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ROOM = (6.0, 5.0, 3.0)
N_BOXES = 12
# the middle of the camera's ring
PATH_CENTER = (3.0, 2.5, 1.4)
NOISE_TABLE = 256
OCTAVES = ((2.0, 0.3), (5.0, 0.25), (13.0, 0.2), (31.0, 0.15), (73.0, 0.1))
# metres a frame along the path (Replica's sequences move ~1-2 cm a frame)
STEP_M = 0.012


@dataclass
class Room:
    lo: torch.Tensor        # [B, 3] box corners (B = N_BOXES)
    hi: torch.Tensor
    base: torch.Tensor      # [1 + 6 + B, 3] base colours: walls, boxes
    table: torch.Tensor     # [T, T] value-noise lattice


def make_room(seed: int, device) -> Room:
    """A dozen boxes against the walls, seeded sizes, places and colours."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (1,), generator=g,
                                           dtype=torch.float64)
    lo, hi = [], []
    for b in range(N_BOXES):
        w, d, h = (float(u(a, b)[0]) for a, b in ((0.4, 1.2), (0.3, 0.6),
                                                  (0.4, 1.8)))
        wall = b % 4
        gap = float(u(0.05, 0.25)[0])
        if wall in (0, 1):      # along the walls x = 0 and x = 6
            y0 = float(u(0.2, ROOM[1] - 0.2 - w)[0])
            x0 = gap if wall == 0 else ROOM[0] - gap - d
            lo.append((x0, y0, 0.0))
            hi.append((x0 + d, y0 + w, h))
        else:                   # along the walls y = 0 and y = 5
            x0 = float(u(0.2, ROOM[0] - 0.2 - w)[0])
            y0 = gap if wall == 2 else ROOM[1] - gap - d
            lo.append((x0, y0, 0.0))
            hi.append((x0 + w, y0 + d, h))
    hue = u(0.0, 1.0, 7 + N_BOXES)
    sat = u(0.15, 0.7, 7 + N_BOXES)
    val = u(0.45, 0.95, 7 + N_BOXES)
    base = torch.stack([_hsv(h, s, v) for h, s, v in zip(hue, sat, val)])
    table = torch.rand(NOISE_TABLE, NOISE_TABLE, generator=g)
    return Room(lo=torch.tensor(lo, dtype=torch.float32, device=device),
                hi=torch.tensor(hi, dtype=torch.float32, device=device),
                base=base.float().to(device), table=table.to(device))


def _hsv(h, s, v) -> torch.Tensor:
    k = torch.tensor([5.0, 3.0, 1.0], dtype=torch.float64)
    k = (k + h * 6.0) % 6.0
    return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)


def camera_path(seed: int, n_frames: int) -> np.ndarray:
    """[n, 4, 4] camera-to-world poses (OpenCV axes: x right, y down, z
    forward) of one closed loop: a ring around the room's middle walked at
    STEP_M a frame, looking outwards, with a seeded handheld wobble whose
    periods divide the loop, so the path closes."""
    rng = np.random.default_rng(seed)
    radius = STEP_M * n_frames / (2.0 * math.pi)
    ph = rng.uniform(0.0, 2.0 * math.pi, size=8)
    cx, cy, cz = PATH_CENTER
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        th = 2.0 * math.pi * i / n_frames
        pos = np.array([
            cx + radius * math.cos(th) + 0.03 * math.sin(2 * th + ph[0]),
            cy + radius * math.sin(th) + 0.03 * math.sin(3 * th + ph[1]),
            cz + 0.05 * math.sin(2 * th + ph[2])])
        yaw = th + 0.2 * math.sin(3 * th + ph[3]) + ph[7]
        pitch = math.radians(-8.0 + 4.0 * math.sin(2 * th + ph[4]))
        roll = math.radians(1.5 * math.sin(5 * th + ph[5]))
        fwd = np.array([math.cos(pitch) * math.cos(yaw),
                        math.cos(pitch) * math.sin(yaw), math.sin(pitch)])
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c, s = math.cos(roll), math.sin(roll)
        right, down = c * right + s * down, -s * right + c * down
        poses[i, :3, 0], poses[i, :3, 1], poses[i, :3, 2] = right, down, fwd
        poses[i, :3, 3] = pos
        poses[i, 3, 3] = 1.0
    return poses


def _noise(table: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           surf: torch.Tensor) -> torch.Tensor:
    """Value noise in [0, 1]: octaves of a smoothstep-interpolated lattice,
    each surface reading the table at its own offset."""
    t = table.shape[0]
    out = torch.zeros_like(u)
    for freq, amp in OCTAVES:
        x = u * freq + 37.0 * surf
        y = v * freq + 91.0 * surf
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        fx, fy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
        ix, iy = x0.long() % t, y0.long() % t
        jx, jy = (ix + 1) % t, (iy + 1) % t
        a = table[iy, ix] * (1 - fx) + table[iy, jx] * fx
        b = table[jy, ix] * (1 - fx) + table[jy, jx] * fx
        out = out + amp * (a * (1 - fy) + b * fy)
    return out


@torch.no_grad()
def cast(room: Room, c2w: np.ndarray, width: int, height: int, fx: float,
         fy: float, cx: float, cy: float):
    """Ray-cast one view: (rgb [H, W, 3] float in [0, 1], depth [H, W]
    camera z in metres), on the room's device."""
    dev = room.lo.device
    pose = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(torch.arange(height, device=dev,
                                         dtype=torch.float32),
                            torch.arange(width, device=dev,
                                         dtype=torch.float32), indexing="ij")
    d_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                         torch.ones_like(xs)], -1)
    d = d_cam @ pose[:3, :3].T                       # [H, W, 3], z_cam = 1
    o = pose[:3, 3]
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    # the room from inside: the nearest wall is the least exit distance
    room_hi = torch.tensor(ROOM, device=dev)
    t_wall = torch.maximum(-o * inv, (room_hi - o) * inv)    # [H, W, 3]
    t_best, axis = t_wall.min(-1)
    surf = 1 + 2 * axis + (d.gather(-1, axis[..., None])[..., 0] > 0).long()
    # the boxes by the slab method
    t1 = (room.lo[:, None, None, :] - o) * inv       # [B, H, W, 3]
    t2 = (room.hi[:, None, None, :] - o) * inv
    t_near, near_axis = torch.minimum(t1, t2).max(-1)
    t_far = torch.maximum(t1, t2).min(-1).values
    hit = (t_near <= t_far) & (t_near > 1e-4)
    t_box = torch.where(hit, t_near, torch.full_like(t_near, float("inf")))
    t_b, b = t_box.min(0)
    use_box = t_b < t_best
    t_best = torch.where(use_box, t_b, t_best)
    axis = torch.where(use_box, near_axis.gather(0, b[None])[0], axis)
    surf = torch.where(use_box, 7 + b, surf)
    p = o + t_best[..., None] * d
    # texture coordinates: the two coordinates across the hit face
    ua = torch.where(axis == 0, p[..., 1], p[..., 0])
    va = torch.where(axis == 2, p[..., 1], p[..., 2])
    n = _noise(room.table, ua, va, surf.float())
    n2 = _noise(room.table, va + 11.0, ua + 5.0, surf.float())
    base = room.base[surf]
    rgb = base * (0.35 + 0.65 * n[..., None]) + \
        0.12 * (n2[..., None] - 0.5) * torch.tensor([1.0, -0.5, 0.3],
                                                    device=dev)
    return rgb.clamp(0.0, 1.0), t_best


@dataclass
class Sequence:
    """One loop of frames in the datasets' stored form, on the host."""
    color: np.ndarray       # [N, H, W, 3] uint8
    depth: np.ndarray       # [N, H, W] uint16
    c2w: np.ndarray         # [N, 4, 4] float64
    depth_factor: float
    fps: float

    def __len__(self) -> int:
        return self.c2w.shape[0]


def make_sequence(seed: int, n_frames: int, intr: dict, device,
                  fps: float = 30.0) -> Sequence:
    """Ray-cast one loop of the path and store it as uint8 colour and
    uint16 depth quantised by intr["depth_scale"]."""
    room = make_room(seed, device)
    poses = camera_path(seed, n_frames)
    w, h = int(intr["width"]), int(intr["height"])
    factor = float(intr["depth_scale"])
    color = np.empty((n_frames, h, w, 3), np.uint8)
    depth = np.empty((n_frames, h, w), np.uint16)
    for i in range(n_frames):
        rgb, z = cast(room, poses[i], w, h, intr["fx"], intr["fy"],
                      intr["cx"], intr["cy"])
        color[i] = (rgb * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
        depth[i] = torch.clamp(z * factor + 0.5, 0, 65535).to(
            torch.int32).cpu().numpy().astype(np.uint16)
    return Sequence(color=color, depth=depth, c2w=poses,
                    depth_factor=factor, fps=fps)


def decode(seq: Sequence, i: int):
    """Loop frame i as the port's dataset readers give it: (colour float32
    in [0, 1], depth float32 metres)."""
    color = seq.color[i].astype(np.float32) / np.float32(255.0)
    depth = seq.depth[i].astype(np.float32) / np.float32(seq.depth_factor)
    return color, depth
