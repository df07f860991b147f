"""The language-feature encoder on the card against the same encoder on
the CPU, without JAX, so this file also runs on a machine with a card
(the JAX conftest skipped):

    python -m pytest --noconftest tests/test_torch_encoder_cuda.py -q

Marker `cuda`: skipped without a card. The small DINOv2 config (56x56
input, 4x4 grid, width 64, a 64 -> 64 PCA), seeded weights, a 90x120 frame
(float and uint8) and a batch of two. Tolerances of the LF grids:
* float32: atol 2e-4 / rtol 1e-3, the DINOv2 forward's float32 tolerance
  (the card sums the products in another order; the package turns TF32
  off, so both are full float32);
* bfloat16 (the default: bf16 weights, float32 arithmetic): atol 2e-3 /
  rtol 1e-2 and every token's cosine above 0.9999. The patch convolution's
  output is rounded to bf16 on both devices, and a sum that lands within
  rounding of a bf16 boundary may round to neighbouring values (one bf16
  step is 2^-8 relative) on the two devices.
"""
import numpy as np
import pytest
import torch

from legslam_torch.models import dinov2 as D
from legslam_torch.models import pca as PCA
from legslam_torch.models.encoder import LanguageFeaturesEncoder

torch.set_num_threads(1)

SMALL = dict(image_size=56, patch_size=14, dim=64, depth=2, heads=2,
             num_registers=4, pos_grid=4)


def _encoders(dtype):
    g = torch.Generator().manual_seed(7)
    dino = D.init_params(D.DinoV2Config(**SMALL), g, device="cpu")
    # LayerScale of 1e-5 leaves the blocks near the identity: perturb
    dino = D.tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=g),
                      dino)
    q, _ = np.linalg.qr(np.random.default_rng(7).normal(size=(64, 64)))
    pca = PCA.PCAParams(torch.zeros(64), torch.as_tensor(q, dtype=torch.float32))
    return [LanguageFeaturesEncoder(dino, pca, D.DinoV2Config(**SMALL),
                                    dtype=dtype, device=dev)
            for dev in ("cpu", "cuda")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["float", "uint8", "batch"])
def test_encoder_card_matches_cpu(dtype, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu, card = _encoders(getattr(torch, dtype))
    rng = np.random.default_rng(8)
    if case == "uint8":
        rgb = rng.integers(0, 256, size=(90, 120, 3)).astype(np.uint8)
    else:
        shape = (2, 90, 120, 3) if case == "batch" else (90, 120, 3)
        rgb = rng.uniform(size=shape).astype(np.float32)
    fn = "encode_batch" if case == "batch" else "create_language_features"
    want = getattr(cpu, fn)(rgb)
    got = getattr(card, fn)(rgb)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert got.shape == want.shape
    got = got.cpu()
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
    else:
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-2)
        cos = torch.nn.functional.cosine_similarity(
            got.reshape(-1, 64), want.reshape(-1, 64), dim=-1)
        assert float(cos.min()) > 0.9999


def test_encoder_defaults_to_the_card():
    """No silent move to the CPU: without `device` the encoder lives on
    the card, and where there is none, building it fails."""
    g = torch.Generator().manual_seed(7)
    dino = D.init_params(D.DinoV2Config(**SMALL), g, device="cpu")
    pca = PCA.PCAParams(torch.zeros(64), torch.eye(64))
    if torch.cuda.is_available():
        enc = LanguageFeaturesEncoder(dino, pca, D.DinoV2Config(**SMALL))
        assert enc.device.type == "cuda"
        out = enc.create_language_features(np.zeros((30, 40, 3), np.float32))
        assert out.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            LanguageFeaturesEncoder(dino, pca, D.DinoV2Config(**SMALL))
