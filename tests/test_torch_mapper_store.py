"""legslam_torch's GaussianMapper with shard_store vs legslam_tpu's, at
128x64: JAX shards the store over conftest's 8 virtual CPU devices, the
port (no process group) keeps it whole. The run and the tolerances are
tests/test_torch_mapper_parallel.py's."""
import torch

from .test_torch_mapper_parallel import check_ticks, frames  # noqa: F401

torch.set_num_threads(1)


def test_mapper_store_ticks_match_jax(frames, tmp_path):  # noqa: F811
    check_ticks(frames, tmp_path, dict(shard_store=True))
