"""The component inventory of tests/test_component_inventory.py (SURVEY.md
§2, C1..C31) mapped onto legslam_torch: one case per component, each
checking that the port's module has the public surface the JAX one has.

The mapping renames legslam_tpu to legslam_torch and ops.pallas.* to
ops.cuda.* (the hand-written kernels' wrappers). The names that exist
only in JAX are listed in JAX_ONLY, each with what stands in for it in
the port and why; everything else must carry the same name.
"""
import importlib

import pytest

from tests.test_component_inventory import INVENTORY

# (JAX module, JAX name) -> (the port's name, why the name differs)
JAX_ONLY = {
    ("legslam_tpu.ops.pallas.composite", "composite_tiles_pallas"): (
        "composite_forward",
        "the pallas_call wrapper; the port launches csrc/composite_fwd.cu"),
    ("legslam_tpu.ops.pallas.composite", "_forward_kernel"): (
        "composite_forward_plain",
        "the Pallas kernel body; the port's kernel is CUDA C++ in "
        "csrc/composite_fwd.cu, beside this plain PyTorch version"),
    ("legslam_tpu.ops.pallas.composite_bwd", "composite_backward_pallas"): (
        "composite_backward",
        "the pallas_call wrapper; the port launches csrc/composite_bwd.cu"),
    ("legslam_tpu.ops.pallas.composite_bwd", "make_composite_vjp"): (
        "CompositeTiles",
        "a jax.custom_vjp factory; the port's is a torch.autograd.Function"),
    ("legslam_tpu.parallel.sharded", "make_mesh"): (
        "make_group",
        "a JAX device mesh; the port splits over torch.distributed groups"),
    ("legslam_tpu.parallel.spatial", "make_mesh2d"): (
        "make_groups",
        "a 2-D JAX device mesh; the port builds views x strips "
        "torch.distributed groups"),
}


def port_module(module: str) -> str:
    return module.replace("legslam_tpu.", "legslam_torch.", 1).replace(
        ".ops.pallas.", ".ops.cuda.")


@pytest.mark.parametrize("name", sorted(INVENTORY))
def test_component(name):
    module, attrs = INVENTORY[name]
    mod = importlib.import_module(port_module(module))
    for attr in attrs:
        ported, _ = JAX_ONLY.get((module, attr), (attr, None))
        assert hasattr(mod, ported), \
            f"{name}: {mod.__name__}.{ported} missing (JAX: {module}.{attr})"


def test_jax_only_names_are_in_the_inventory_and_not_in_the_port():
    """Each JAX-only name is one the inventory asks for, and the port
    really lacks it (else it should carry the JAX name)."""
    listed = {(m, a) for m, attrs in INVENTORY.values() for a in attrs}
    for (module, attr), (_, reason) in JAX_ONLY.items():
        assert (module, attr) in listed, (module, attr)
        assert reason
        mod = importlib.import_module(port_module(module))
        assert not hasattr(mod, attr), (module, attr)
