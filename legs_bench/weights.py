"""The encoder's weights, made by the benchmark from the seed on the device.

DINOv2 ViT-B/14-reg and a PCA 768 -> 64 in the port's parameter layout
(dense kernels [in, out], the patch kernel HWIO, blocks as a list), drawn
with a torch.Generator on the device in a few large calls and rounded to
bfloat16 values, the type the configuration serves them in. The same
tensors go to the port and to the plain reference.
"""
from __future__ import annotations

import torch


def make_encoder(seed: int, device, cfg: dict) -> tuple[dict, tuple]:
    """(DINOv2 parameter tree, (pca mean [768], components [64, 768]))."""
    g = torch.Generator(device=device).manual_seed(seed)
    d, depth = cfg["dim"], cfg["depth"]
    hid = int(d * cfg["mlp_ratio"])
    grid = cfg["image_size"] // cfg["patch_size"]
    p = cfg["patch_size"]

    def randn(*shape, std=0.02):
        return torch.randn(*shape, generator=g, device=device) * std

    # one draw per kind of tensor, for every block at once
    qkv = randn(depth, d, 3 * d)
    proj = randn(depth, d, d)
    fc1 = randn(depth, d, hid)
    fc2 = randn(depth, hid, d)
    biases = randn(depth, 3 * d + d + hid + d, std=0.01)
    norms = 1.0 + randn(depth, 4, d, std=0.05)
    # LayerScale of a trained DINOv2 is O(0.1): the blocks must count
    ls = 0.1 + randn(depth, 2, d, std=0.02)
    blocks = []
    for i in range(depth):
        b = biases[i]
        blocks.append(dict(
            norm1=dict(scale=norms[i, 0], bias=norms[i, 1] - 1.0),
            qkv=dict(kernel=qkv[i], bias=b[:3 * d]),
            proj=dict(kernel=proj[i], bias=b[3 * d:4 * d]),
            ls1=ls[i, 0],
            norm2=dict(scale=norms[i, 2], bias=norms[i, 3] - 1.0),
            fc1=dict(kernel=fc1[i], bias=b[4 * d:4 * d + hid]),
            fc2=dict(kernel=fc2[i], bias=b[4 * d + hid:]),
            ls2=ls[i, 1]))
    params = dict(
        patch_embed=dict(kernel=randn(p, p, 3, d, std=0.05),
                         bias=randn(d, std=0.01)),
        cls_token=randn(1, 1, d),
        register_tokens=randn(1, cfg["num_registers"], d),
        pos_embed=randn(1, grid * grid + 1, d),
        blocks=blocks,
        norm=dict(scale=1.0 + randn(d, std=0.05), bias=randn(d, std=0.01)))
    params = tree_map(params,
                      lambda t: t.to(torch.bfloat16).float().contiguous())
    q, _ = torch.linalg.qr(torch.randn(d, cfg["pca_dim"], generator=g,
                                       device=device))
    pca = (randn(d, std=0.01), q.T.contiguous())
    return params, pca


def tree_map(tree, fn):
    """`fn` over the leaves of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(v, fn) for v in tree]
    return fn(tree)
