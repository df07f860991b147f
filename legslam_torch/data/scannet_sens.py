"""ScanNet .sens extractor (C29: tools/scannet_sens_reader.py equivalent).

A numpy copy of legslam_tpu/data/scannet_sens.py. Parses the binary .sens
container (version 4) and writes the color/depth/pose/intrinsic directory
layout the ScanNetDataset reader consumes:
  color/N.jpg, depth/N.png (16-bit), pose/N.txt, intrinsic/intrinsic_*.txt
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import BinaryIO, Iterator, Optional

import numpy as np

COMPRESSION_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                     2: "occi_ushort"}


class SensReader:
    def __init__(self, path: str):
        self.path = path
        self._f: Optional[BinaryIO] = None

    def __enter__(self):
        f = open(self.path, "rb")
        self._f = f
        version = struct.unpack("I", f.read(4))[0]
        if version != 4:
            raise ValueError(f"unsupported .sens version {version}")
        strlen = struct.unpack("Q", f.read(8))[0]
        self.sensor_name = f.read(strlen).decode("ascii", "replace")
        self.intrinsic_color = np.frombuffer(
            f.read(16 * 4), np.float32).reshape(4, 4)
        self.extrinsic_color = np.frombuffer(
            f.read(16 * 4), np.float32).reshape(4, 4)
        self.intrinsic_depth = np.frombuffer(
            f.read(16 * 4), np.float32).reshape(4, 4)
        self.extrinsic_depth = np.frombuffer(
            f.read(16 * 4), np.float32).reshape(4, 4)
        self.color_compression = COMPRESSION_COLOR[
            struct.unpack("i", f.read(4))[0]]
        self.depth_compression = COMPRESSION_DEPTH[
            struct.unpack("i", f.read(4))[0]]
        self.color_width, self.color_height = struct.unpack("II", f.read(8))
        self.depth_width, self.depth_height = struct.unpack("II", f.read(8))
        self.depth_shift = struct.unpack("f", f.read(4))[0]
        self.num_frames = struct.unpack("Q", f.read(8))[0]
        return self

    def __exit__(self, *a):
        if self._f:
            self._f.close()

    def frames(self) -> Iterator[dict]:
        f = self._f
        for i in range(self.num_frames):
            pose = np.frombuffer(f.read(16 * 4), np.float32).reshape(4, 4)
            ts_color, ts_depth = struct.unpack("QQ", f.read(16))
            n_color, n_depth = struct.unpack("QQ", f.read(16))
            color_bytes = f.read(n_color)
            depth_bytes = f.read(n_depth)
            yield dict(index=i, pose=pose, ts_color=ts_color,
                       ts_depth=ts_depth, color_bytes=color_bytes,
                       depth_bytes=depth_bytes)

    def decode_depth(self, depth_bytes: bytes) -> np.ndarray:
        if self.depth_compression == "zlib_ushort":
            raw = zlib.decompress(depth_bytes)
        elif self.depth_compression == "raw_ushort":
            raw = depth_bytes
        else:
            raise ValueError(self.depth_compression)
        return np.frombuffer(raw, np.uint16).reshape(
            self.depth_height, self.depth_width)


def extract(sens_path: str, out_dir: str, every_nth: int = 1,
            max_frames: Optional[int] = None) -> int:
    """Write the color/depth/pose/intrinsic layout; returns frames written."""
    import cv2

    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    n_written = 0
    with SensReader(sens_path) as r:
        np.savetxt(os.path.join(out_dir, "intrinsic",
                                "intrinsic_color.txt"), r.intrinsic_color)
        np.savetxt(os.path.join(out_dir, "intrinsic",
                                "intrinsic_depth.txt"), r.intrinsic_depth)
        np.savetxt(os.path.join(out_dir, "intrinsic",
                                "extrinsic_color.txt"), r.extrinsic_color)
        np.savetxt(os.path.join(out_dir, "intrinsic",
                                "extrinsic_depth.txt"), r.extrinsic_depth)
        for fr in r.frames():
            i = fr["index"]
            if i % every_nth:
                continue
            if fr["color_bytes"]:
                with open(os.path.join(out_dir, "color", f"{i}.jpg"),
                          "wb") as f:
                    f.write(fr["color_bytes"])
            depth = r.decode_depth(fr["depth_bytes"])
            cv2.imwrite(os.path.join(out_dir, "depth", f"{i}.png"), depth)
            np.savetxt(os.path.join(out_dir, "pose", f"{i}.txt"),
                       fr["pose"])
            n_written += 1
            if max_frames and n_written >= max_frames:
                break
    return n_written


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("sens")
    ap.add_argument("out")
    ap.add_argument("--every-nth", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=None)
    a = ap.parse_args()
    print(extract(a.sens, a.out, a.every_nth, a.max_frames), "frames")
