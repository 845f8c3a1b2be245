"""Small seeded inputs of the PyTorch-port parity tests that must also be
importable in spawned worker processes: numpy and torch only, no JAX.

The decoders are narrow (2 -> 16 -> 16 -> 10 by default) because the CPU
runs the kernels' plain versions."""

import numpy as np
import torch

# one intra-op thread: under pytest-xdist, and in spawned ranks, torch's
# thread pool oversubscribes the CPU otherwise
torch.set_num_threads(1)


def small_decoders_np(M, seed=0, D=2, H=16, X=10):
    """[(w (M, in, out), b (M, out)), ...] float32, three layers."""
    rng = np.random.default_rng(seed)
    dims = [(D, H), (H, H), (H, X)]
    return [((rng.normal(size=(M, i, o)) / np.sqrt(i)).astype(np.float32),
             (0.1 * rng.normal(size=(M, o))).astype(np.float32))
            for i, o in dims]


def torch_decoders(layers_np, lo=None, hi=None):
    return {"layers": [{"w": torch.from_numpy(w[lo:hi].copy()),
                        "b": torch.from_numpy(b[lo:hi].copy())}
                       for w, b in layers_np]}


def smooth_curves(T, B, seed=0, D=2):
    """(T, B, D) float32 smooth curves between random endpoints."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, T)[:, None, None]
    a, b, ph = (rng.normal(size=(1, B, D)) for _ in range(3))
    return ((1 - t) * a + t * b + 0.3 * np.sin(3.0 * t + ph)).astype(np.float32)
