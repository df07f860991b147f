"""LPIPS(alex): the third Replica metric.

Counterpart of legslam_tpu/models/lpips.py. The reference scores LPIPS
with the `lpips` package's AlexNet variant (eval/replica_test.py:131-158:
lpips.LPIPS(net='alex') on [-1, 1] CHW tensors). This is the same
computation in plain tensor code:

  scale input by the LPIPS shift/scale layer -> AlexNet features at
  relu1..relu5 -> unit-normalize channels -> squared difference ->
  learned 1x1 "lin" weights -> spatial mean -> sum over layers.

Weight files are the JAX module's flat .npz (conv{i}/w HWIO, conv{i}/b,
lin{i}/w; tools/convert_weights.py --lpips-alex writes one). The port
convolves NCHW with OIHW kernels: `params_from_numpy` transposes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# LPIPS input scaling layer constants (lpips/lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision AlexNet feature trunk: (out_ch, kernel, stride, padding),
# with 3x3/2 max-pools after relu1 and relu2 (taps are pre-pool)
ALEX_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)


def init_params(rng: np.random.Generator | None = None) -> dict:
    """Random-weight parameters as numpy arrays in the JAX module's layout
    (the same draws from the same generator): conv{i}/{w,b} (HWIO),
    lin{i}/w ([C])."""
    rng = rng or np.random.default_rng(0)
    params = {}
    cin = 3
    for i, (cout, k, _, _) in enumerate(ALEX_CONVS):
        params[f"conv{i}/w"] = rng.normal(
            0, 1.0 / np.sqrt(k * k * cin), size=(k, k, cin, cout)
        ).astype(np.float32)
        params[f"conv{i}/b"] = np.zeros(cout, np.float32)
        params[f"lin{i}/w"] = rng.uniform(
            0, 1, size=(cout,)).astype(np.float32)
        cin = cout
    return params


def params_from_numpy(tree: dict, device: str | torch.device = "cuda"
                      ) -> dict:
    """The port's parameters from the JAX layout's arrays: float32 tensors
    on `device`, the conv kernels transposed HWIO -> OIHW."""
    out = {}
    for k, v in tree.items():
        a = np.asarray(v, np.float32)
        if k.endswith("/w") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def alex_features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """relu1..relu5 taps of the AlexNet trunk for [N, 3, H, W] input."""
    feats = []
    for i, (_, _, s, p) in enumerate(ALEX_CONVS):
        x = F.relu(F.conv2d(x, params[f"conv{i}/w"], params[f"conv{i}/b"],
                            stride=s, padding=p))
        feats.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, 3, 2)
    return feats


def _unit_normalize(f, eps=1e-10):
    n = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (n + eps)


def lpips(params: dict, img1, img2) -> torch.Tensor:
    """LPIPS distance for [H, W, 3] (or [N, H, W, 3]) float images in
    [0, 1], arrays or tensors, on the parameters' device. Returns []
    (or [N])."""
    dev = params["conv0/w"].device
    img1 = torch.as_tensor(img1, dtype=torch.float32, device=dev)
    img2 = torch.as_tensor(img2, dtype=torch.float32, device=dev)
    squeeze = img1.ndim == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    shift = torch.tensor(_SHIFT, device=dev)
    scale = torch.tensor(_SCALE, device=dev)
    # the reference feeds [-1, 1]
    x1 = (((img1 * 2.0 - 1.0) - shift) / scale).permute(0, 3, 1, 2)
    x2 = (((img2 * 2.0 - 1.0) - shift) / scale).permute(0, 3, 1, 2)
    total = 0.0
    for i, (f1, f2) in enumerate(zip(alex_features(params, x1),
                                     alex_features(params, x2))):
        d = (_unit_normalize(f1) - _unit_normalize(f2)) ** 2
        w = params[f"lin{i}/w"]
        total = total + torch.sum(d * w[None, :, None, None],
                                  dim=1).mean(dim=(1, 2))
    return total[0] if squeeze else total


def load_params(npz_path: str, device: str | torch.device = "cuda") -> dict:
    with np.load(npz_path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, device)
