"""The yardstick: the work a step needs, counted from the shapes, and the
chip's peaks.

A decode is counted once per (point, decoder) whatever precision rung or
emulation the program runs it at (a rung that runs a layer two or three
times does not do more of the model's work), and bytes count each input
read once and each output written once.  Peaks are the published dense
rates of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the peak a precision rung of the energy kernels is held to: the reduced
# rungs run on the bf16 tensor cores, float32 on the CUDA cores
RUNG_PEAK = {"float32": PEAK_FLOPS["float32"], "f32x3": PEAK_FLOPS["bfloat16"],
             "f32x2": PEAK_FLOPS["bfloat16"],
             "bfloat16": PEAK_FLOPS["bfloat16"]}


def mlp_flops(dims) -> int:
    """Multiply-adds x 2 of one forward pass of an MLP on one row."""
    return sum(2 * i * o for i, o in zip(dims[:-1], dims[1:]))


def mlp_params(dims) -> int:
    return sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))


def drawn_decoders(M: int, S: int) -> float:
    """Expected distinct decoders a point needs under the Monte-Carlo
    estimator: each point is the right end of S draws and the left end of S
    more, M (1 - (1 - 1/M)^(2S))."""
    return M * (1.0 - (1.0 - 1.0 / M) ** (2 * S))


def decoders_per_point(mode: str, M: int, S: int) -> float:
    """Decoders a trajectory step decodes per curve point in an energy mode:
    every member for the expected energy, member 0 for the one-decoder
    modes, the drawn ones for the Monte-Carlo estimator."""
    if mode.startswith("single"):
        return 1.0
    if mode.startswith("mc"):
        return drawn_decoders(M, S)
    return float(M)


def energy_grad_work(dims, T: int, B: int, n_dec: float, D: int):
    """(FLOP, bytes) of one energy gradient to the curve: per (point,
    decoder) a forward pass and the chain back to the point (the same
    multiply-adds, transposed); reads the curve and the weights, writes
    dgamma."""
    flops = T * B * n_dec * 2 * mlp_flops(dims)
    n_bytes = 4 * (2 * T * B * D + n_dec * mlp_params(dims) + B)
    return flops, n_bytes


def energy_value_work(dims, T: int, B: int, n_dec: float, D: int):
    """(FLOP, bytes) of one energy evaluation: a forward pass per (point,
    decoder)."""
    flops = T * B * n_dec * mlp_flops(dims)
    n_bytes = 4 * (T * B * D + n_dec * mlp_params(dims) + B)
    return flops, n_bytes


def bound_seconds(flops: float, n_bytes: float, peak: float) -> float:
    """The least time the chip needs: operations or bytes, whichever bounds."""
    return max(flops / peak, n_bytes / PEAK_BYTES)
