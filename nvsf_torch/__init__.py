"""nvsf_torch — the PyTorch + CUDA port of nvsf_tpu for NVIDIA Hopper GPUs.

Mirrors nvsf_tpu's layout (ops/, models/, render/, data/, lib/, train/);
each module names its nvsf_tpu counterpart. Imports torch and never JAX.
From nvsf_tpu it reuses only the JAX-free modules: config.py (exposed as
nvsf_torch.config), lib/convert.py, lib/pose.py and lib/pointcloud.py.

The TPU's Pallas kernels on the training step's path are hand-written CUDA
kernels for sm_90a in csrc/, built with nvcc at first use
(ops/kernels.py). On CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
