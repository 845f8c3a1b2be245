"""The benchmark's inputs, made from ``--seed`` on the device: weights in the
reference's ``nn.Linear`` init, class representatives and their pairs,
and initial spline parameters.

One seed gives the same inputs on the same device type.  Every tensor is
drawn by a generator on the device, a few large calls per kind of leaf;
nothing is read from disk.  Layers are (w (in, out), b (out,)) pairs with
a leading member axis, the layout the port and the reference both take.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from geobench.reference import M64, fold_seed, nullspace_basis

# sub-streams of a run's seed (3 is not drawn from)
WEIGHTS, ENDPOINTS, OMEGA, _, SAMPLE, CHUNKS = range(6)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(fold_seed(int(seed) & M64, stream))
    return g


def linear_stack(g, dims, members: int, device):
    """An MLP's layers for ``members`` members in nn.Linear's init, w and b
    ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)): one draw per layer for all
    members."""
    layers = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        bound = fan_in ** -0.5
        w = torch.rand((members, fan_in, fan_out), generator=g, device=device)
        b = torch.rand((members, fan_out), generator=g, device=device)
        w, b = (2 * w - 1) * bound, (2 * b - 1) * bound
        layers.append((w, b))
    return layers


def decoder_dims(cfg: dict) -> list:
    out = cfg["input_dim"] * (2 if cfg["heteroscedastic"] else 1)
    return [cfg["latent_dim"], *cfg["decoder_hidden"], out]


def decoders(cfg: dict, seed: int, device):
    """The configuration's decoder ensemble (M members, each drawn)."""
    g = generator(seed, WEIGHTS, device)
    return linear_stack(g, decoder_dims(cfg), cfg["num_decoders"], device)


def geodesic_problem(cfg: dict, traffic: dict, seed: int, device):
    """(pairs, a, b, omega0, basis) as host arrays over every pair of the
    traffic's class representatives, in the order of
    ``itertools.combinations``: representatives ~ N(0, I) in the latent
    space (the prior), omega0 = init_scale N(0, 1) on the nullspace basis."""
    n = traffic["classes"]
    D = cfg["latent_dim"]
    reps = torch.randn((n, D), generator=generator(seed, ENDPOINTS, device),
                       device=device)
    pairs = np.asarray(list(combinations(range(n), 2)))
    n_poly = traffic["n_poly"]
    K = n_poly + 1
    omega0 = traffic["init_scale"] * torch.randn(
        (len(pairs), K, D), generator=generator(seed, OMEGA, device),
        device=device)
    reps = reps.cpu().numpy()
    return (pairs, reps[pairs[:, 0]], reps[pairs[:, 1]], omega0.cpu().numpy(),
            nullspace_basis(n_poly).astype(np.float32))
