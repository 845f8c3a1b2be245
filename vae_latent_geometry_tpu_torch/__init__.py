"""vae-latent-geometry, PyTorch/CUDA port.

A second implementation of the ``vae_latent_geometry_tpu`` geodesic
pipeline for NVIDIA Hopper GPUs.  The JAX package is the reference this one
is held against; this package imports nothing of it (nor of JAX).  Plain
tensor code is PyTorch; the fused expected-energy kernels are hand-written
CUDA C++ (``ops/csrc``) built with ``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(CLI: ``--device cpu``); without a GPU they raise instead of falling back.
"""

__version__ = "0.1.0"

import torch as _torch

# Numerics guard — NOT optional.  Every geodesic quantity is built from
# differences of adjacent t-samples along a smooth curve, whose magnitude
# (~5e-4 |x| at T=2000) is below TF32's input rounding (~2^-11): TF32
# matmuls turn the discrete energy into rounding noise (docs/NUMERICS.md).
# Reduced-precision rungs are built explicitly from bf16 hi/lo splits
# (ops/energy_fused.py), never by lowering the global matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from vae_latent_geometry_tpu_torch.config import (  # noqa: E402,F401
    EnergyConfig,
    GeodesicConfig,
    InitConfig,
    ModelConfig,
    TrainConfig,
)
from vae_latent_geometry_tpu_torch.device import resolve_device  # noqa: E402,F401
