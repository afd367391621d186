"""hdl_graph_slam_tpu_torch: the PyTorch/CUDA port of hdl_graph_slam_tpu.

Same module layout and names as the JAX package, which stays in the
repository as the reference this port is tested against. The port never
imports jax or hdl_graph_slam_tpu; modules it needs from there are copied.

Entry points (the offline CLI ``python -m hdl_graph_slam_tpu_torch.run``,
pipeline.SlamPipeline, backend.HdlGraphSlam, frontend.OdometryWindow,
frontend.DeviceOdometry, frontend.Prefilter) run on ``cuda`` unless given
``device="cpu"`` (``--device cpu``); without a GPU they raise instead of
quietly running on the CPU. Kernels written by hand
for Hopper live in ``csrc/`` and are built at first use (kernels/).
"""

__version__ = "0.1.0"

# Precision policy. Nearest-neighbour selection precision is a correctness
# surface: in the JAX package a bf16 covariance-kNN selection matmul took
# golden-course odometry ATE from 0.085 m to 3.96 m. TF32 keeps 10 mantissa
# bits, close to the bf16 that failed, so every float32 product here stays
# true fp32, and pose products (hundreds composed per window) with them.
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
del _torch
