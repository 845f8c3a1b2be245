"""Timing, tracing, NaN guard and logging helpers of the PyTorch port.

The JAX package's third helper, ``utils/compile_cache.py`` (XLA's
persistent compilation cache), has no counterpart here: the port's
kernels are built once per source and kept under hashed names by
``ops/_build.py``.
"""

from vae_latent_geometry_tpu_torch.utils.logging import get_logger  # noqa: F401
from vae_latent_geometry_tpu_torch.utils.profiling import (  # noqa: F401
    Timer,
    nan_guard,
    sync,
    time_fn,
    trace_annotation,
)
