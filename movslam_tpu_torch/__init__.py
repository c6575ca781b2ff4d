"""movslam_tpu_torch — the PyTorch + CUDA port of movslam_tpu.

The JAX package `movslam_tpu` is the reference this port is held against;
module names mirror it one to one (`ops/propagate.py` here ports
`movslam_tpu/ops/propagate.py`). Plain tensor code is eager PyTorch; the one
Pallas TPU kernel of the reference (`ops/pallas_kernels.py::score_blocks`)
is a hand-written CUDA kernel here (`csrc/score_blocks.cu`, bound in
`ops/kernels.py`).

Every device choice is explicit: `System(..., device="cuda")` runs on the
card or raises; nothing falls back to the CPU on its own.
"""
import torch

# The reference pins Precision.HIGHEST on its matmuls; TF32 would keep only
# ~3 decimal digits in the DLT, Schur and LK products.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
