"""legslam_torch.models.dinov2's weight converters and parameter layout
against the JAX package's, on the CPU: a random `transformers`
Dinov2WithRegistersModel state dict (HF names) and a seeded dict with the
torch-hub checkpoint's names convert to the same parameters bit for bit,
and the HF model's own output matches the port's forward at atol 2e-4 /
rtol 1e-3 (tests/test_dinov2.py's tolerance). The port itself does not
import transformers; only this test does."""
import jax
import numpy as np
import torch

from legslam_torch.models import dinov2 as TD
from legslam_tpu.models import dinov2 as JD

torch.set_num_threads(1)

SMALL = dict(image_size=56, patch_size=14, dim=64, depth=2, heads=2,
             num_registers=4, pos_grid=4)


def _assert_same_tree(port, jax_tree):
    flat_p = jax.tree_util.tree_leaves_with_path(
        TD.tree_map(lambda t: t.numpy(), port))
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jax_tree))
    assert [p for p, _ in flat_p] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_p, flat_j):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b.astype(np.float32),
                                      err_msg=str(path))


def test_convert_hf_matches_jax_and_hf():
    from transformers import (Dinov2WithRegistersConfig,
                              Dinov2WithRegistersModel)
    torch.manual_seed(0)
    model = Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=256, image_size=56, patch_size=14,
        num_register_tokens=4, layerscale_value=0.1,
        hidden_act="gelu")).eval()
    sd = model.state_dict()
    port = TD.convert_hf(sd, TD.DinoV2Config(**SMALL), device="cpu")
    ref = JD.convert_hf({k: v.numpy() for k, v in sd.items()},
                        JD.DinoV2Config(**SMALL))
    _assert_same_tree(port, ref)
    img = np.random.default_rng(5).uniform(-1, 1, size=(2, 56, 56, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        want = model(torch.as_tensor(img.transpose(0, 3, 1, 2))) \
            .last_hidden_state[:, 1 + 4:].numpy()
        got = TD.forward(port, torch.as_tensor(img),
                         TD.DinoV2Config(**SMALL)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_convert_torch_hub_matches_jax():
    """A seeded state dict with the hub checkpoint's names and shapes."""
    rng = np.random.default_rng(6)
    cfg = dict(SMALL)
    d, hid, p = 64, 256, 14

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)
    sd = {"patch_embed.proj.weight": r(d, 3, p, p),
          "patch_embed.proj.bias": r(d), "cls_token": r(1, 1, d),
          "register_tokens": r(1, 4, d), "pos_embed": r(1, 17, d),
          "norm.weight": r(d), "norm.bias": r(d)}
    for i in range(2):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": r(d), b + "norm1.bias": r(d),
                   b + "attn.qkv.weight": r(3 * d, d),
                   b + "attn.qkv.bias": r(3 * d),
                   b + "attn.proj.weight": r(d, d),
                   b + "attn.proj.bias": r(d), b + "ls1.gamma": r(d),
                   b + "norm2.weight": r(d), b + "norm2.bias": r(d),
                   b + "mlp.fc1.weight": r(hid, d), b + "mlp.fc1.bias": r(hid),
                   b + "mlp.fc2.weight": r(d, hid), b + "mlp.fc2.bias": r(d),
                   b + "ls2.gamma": r(d)})
    ref = JD.convert_torch_hub(sd, JD.DinoV2Config(**cfg))
    port = TD.convert_torch_hub({k: torch.as_tensor(v) for k, v in
                                 sd.items()}, TD.DinoV2Config(**cfg),
                                device="cpu")
    _assert_same_tree(port, ref)


def test_init_params_layout_matches_jax():
    """init_params draws the JAX module's tree: the same paths and shapes,
    so either package's parameters drive the other's forward."""
    cfg = dict(SMALL, depth=3)
    port = TD.init_params(TD.DinoV2Config(**cfg),
                          torch.Generator().manual_seed(0), device="cpu")
    ref = JD.init_params(JD.DinoV2Config(**cfg), jax.random.key(0))
    flat_p = jax.tree_util.tree_leaves_with_path(
        TD.tree_map(lambda t: t.numpy(), port))
    flat_j = jax.tree_util.tree_leaves_with_path(ref)
    assert [(p, a.shape) for p, a in flat_p] == \
        [(p, a.shape) for p, a in flat_j]
    again = TD.init_params(TD.DinoV2Config(**cfg),
                           torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["pos_embed"], port["pos_embed"])
