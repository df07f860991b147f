"""legslam_torch: the PyTorch/CUDA port of legslam_tpu for NVIDIA Hopper.

The module layout mirrors legslam_tpu so each module's counterpart is easy
to find. Plain tensor code is PyTorch; the forward and backward
compositing kernels and the radix sort kernels of binning are
hand-written CUDA C++ for sm_90a (legslam_torch/csrc), built on first use
by legslam_torch._build. Public entry points default to device="cuda".
"""
import torch

# Full float32 for every matmul and convolution. The 3-NN scale init
# (utils/knn.py) relies on the |x|^2 + |y|^2 - 2xy expansion cancelling to
# ~1e-4-scale nearest-neighbour distances from O(10)-scale terms; TF32
# keeps ~3 decimal digits and wipes that out, exactly as the TPU's default
# bf16 matmul passes did. SSIM's banded blur and the reference compositor's
# blend products are float32 products too.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
