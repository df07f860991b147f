"""Helpers of the legslam_torch parity tests: numpy bridges between the JAX
package and the port, and seeded scenes both sides consume."""
import numpy as np
import torch

from legslam_torch.models.gaussians import GROUPS, STATS


def np_(x):
    """numpy copy of a JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(x, dtype=None):
    """CPU torch tensor from a numpy / JAX array."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def jax_state_tree(st) -> dict:
    """A JAX GaussianState as the nested numpy layout of
    legslam_tpu/mapper/checkpoint.py (the input of state_from_numpy)."""
    def params(p):
        return {n: np.asarray(getattr(p, n)) for n in GROUPS}
    return dict(
        params=params(st.params), adam_m=params(st.adam_m),
        adam_v=params(st.adam_v), valid=np.asarray(st.valid),
        exist_since=np.asarray(st.exist_since),
        adam_step=np.asarray(st.adam_step),
        stats={n: np.asarray(getattr(st.stats, n)) for n in STATS},
        overflow_dropped=np.asarray(st.overflow_dropped))


def torch_view(jview):
    """The port's CameraView of a JAX CameraView, on the CPU."""
    from legslam_torch.utils.camera import CameraView
    return CameraView(width=jview.width, height=jview.height,
                      fovx=jview.fovx, fovy=jview.fovy,
                      world_view=t_(jview.world_view),
                      full_proj=t_(jview.full_proj),
                      cam_center=t_(jview.cam_center))


def assert_close(a, b, atol, rtol, err_msg=""):
    np.testing.assert_allclose(np_(a), np_(b), atol=atol, rtol=rtol,
                               err_msg=err_msg)
