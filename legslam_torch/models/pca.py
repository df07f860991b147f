"""PCA 768->64 compressor: apply, fit, and ONNX weight extraction.

Counterpart of legslam_tpu/models/pca.py. The reference ships the fitted
PCA as a second ONNX model (`pca_text_emb64_*.onnx`, input_feat [1369,768]
-> compressed_feat [1369,64]; src/compressor_models.cpp:32-98). Here it is
one matmul after the DINOv2 forward: y = (x - mean) @ components^T.

`fit_pca` fits a compressor from a feature corpus (streaming float32
moments, then the eigendecomposition of the covariance), the reference's
offline step. `from_onnx` reads the reference's artifact with its own
dependency-free protobuf wire reader: the port does not import `onnx`.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch


class PCAParams(NamedTuple):
    mean: torch.Tensor        # [D]
    components: torch.Tensor  # [K, D] rows = principal axes


def apply_pca(params: PCAParams, feats: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., K]."""
    return (feats - params.mean) @ params.components.T


def fit_pca(feature_batches: Iterable[np.ndarray], k: int = 64,
            device: str | torch.device = "cuda") -> PCAParams:
    """Streaming exact PCA: accumulate float32 sum / outer-product moments
    over batches of [N, D] features on `device`, then eigh of the
    covariance."""
    total = outer = None
    count = 0
    for batch in feature_batches:
        b = torch.as_tensor(np.asarray(batch), dtype=torch.float32,
                            device=device)
        if total is None:
            total = torch.zeros(b.shape[1], device=device)
            outer = torch.zeros(b.shape[1], b.shape[1], device=device)
        total = total + b.sum(0)
        outer = outer + b.T @ b
        count += b.shape[0]
    mean = total / count
    cov = outer / count - torch.outer(mean, mean)
    _, v = torch.linalg.eigh(cov)              # ascending eigenvalues
    comps = v.flip(-1)[:, :k].T.contiguous()   # top-k rows
    return PCAParams(mean=mean, components=comps)


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _proto_fields(buf: bytes):
    """Yield (field_no, wire_type, payload) over a protobuf message.
    payload is bytes for length-delimited fields, int for varints."""
    i = 0
    while i < len(buf):
        tag, i = _varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:                       # varint
            val, i = _varint(buf, i)
            yield field, wt, val
        elif wt == 2:                     # length-delimited
            ln, i = _varint(buf, i)
            yield field, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:                     # fixed32
            yield field, wt, buf[i:i + 4]
            i += 4
        elif wt == 1:                     # fixed64
            yield field, wt, buf[i:i + 8]
            i += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wt}")


def _read_onnx_initializers(path: str) -> dict:
    """Read GraphProto.initializer tensors straight from the protobuf wire
    format. Supports FLOAT(1)/DOUBLE(11) initializers with raw_data,
    packed float_data, or packed double_data."""
    with open(path, "rb") as f:
        data = f.read()
    inits: dict = {}
    for field, wt, val in _proto_fields(data):
        if field != 7 or wt != 2:         # ModelProto.graph
            continue
        for gf, gwt, gval in _proto_fields(val):
            if gf != 5 or gwt != 2:       # GraphProto.initializer
                continue
            dims, dtype, name = [], 1, ""
            raw = floats = None
            for tf, twt, tval in _proto_fields(gval):
                if tf == 1:               # dims (repeated int64)
                    if twt == 0:
                        dims.append(tval)
                    else:                 # packed
                        j = 0
                        while j < len(tval):
                            v, j = _varint(tval, j)
                            dims.append(v)
                elif tf == 2:             # data_type
                    dtype = tval
                elif tf == 8:             # name
                    name = tval.decode("utf-8", "replace")
                elif tf == 9:             # raw_data
                    raw = tval
                elif tf == 4 and twt == 2:  # packed float_data
                    floats = np.frombuffer(tval, "<f4")
                elif tf == 10 and twt == 2:  # packed double_data
                    floats = np.frombuffer(tval, "<f8")
            np_dtype = {1: "<f4", 11: "<f8"}.get(dtype)
            if np_dtype is None:
                continue
            arr = np.frombuffer(raw, np_dtype) if raw is not None \
                else np.asarray(floats if floats is not None else [],
                                np_dtype)
            inits[name] = arr.reshape(dims)
    return inits


def _params(mean, components, device) -> PCAParams:
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return PCAParams(mean=t(mean), components=t(components))


def from_onnx(path: str, device: str | torch.device = "cuda") -> PCAParams:
    """Extract (mean, components) from the reference's PCA ONNX file.

    The exported graph is Sub(input, mean) -> MatMul(weights); the two
    initializers are found by shape, whatever their names."""
    inits = _read_onnx_initializers(path)
    mean = None
    comp = None
    for arr in inits.values():
        a = np.asarray(arr)
        if a.ndim == 1 or (a.ndim == 2 and 1 in a.shape):
            mean = a.reshape(-1)
        elif a.ndim == 2:
            comp = a
    if mean is None or comp is None:
        raise ValueError(f"could not locate PCA tensors in {path}: "
                         f"{ {k: v.shape for k, v in inits.items()} }")
    if comp.shape[0] > comp.shape[1]:
        comp = comp.T  # ensure [K, D]
    return _params(mean, comp, device)


def save(path: str, params: PCAParams) -> None:
    np.savez(path, mean=params.mean.detach().cpu().numpy(),
             components=params.components.detach().cpu().numpy())


def load(path: str, device: str | torch.device = "cuda") -> PCAParams:
    z = np.load(path)
    return _params(z["mean"], z["components"], device)
