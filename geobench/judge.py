"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (``reference.py``) at the timed sizes.

Geodesic cells (every answer is one pair's curve and length):

- ``final_gap``: every pair the window completed; the reported length
  against the reference's float64 length of the program's own final curve
  (the final re-evaluation: the energy kernels at float32, or the arc
  length), as a share of that length or of the median one.
- ``grad_gap``: every pair the window completed; the gradient of the loss
  to the spline parameters that the optimizer received on its first step
  (spline evaluation, the energy op and its kernel) against the
  reference's at the same start, its decodes in the arithmetic of the rung
  the configuration states for the trajectory and every sum exact; the
  norm of their difference as a share of the reference's norm or of the
  median one, whichever is larger.  (Held to float64 instead, the f32x2
  rung and the bfloat16 one below it read alike: both chain the gradient
  back in bfloat16.)
- ``traj_gap``: a sample of the completed pairs drawn from the seed; the
  reference runs each pair's whole optimization again in float64 from the
  same start (its own grid, design matrix, energy, Monte-Carlo draws and
  Adam) and the program's final curve is held to it: the gap of the two
  curves' float64 lengths.  ``omega_gap``, the distance of the two final
  parameters as a share of how far the reference moved them, is reported
  beside it: a pair may wander along a direction its length does not see.

A cell's limits file names the numbers it compares.
"""

from __future__ import annotations

import numpy as np
import torch

from geobench import inputs, reference


def _t(x, dev, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), device=dev).to(dtype)


def _gap(got, want) -> float:
    """The widest gap of the lengths ``got`` from ``want``, each measured
    against its reference length or the median one, whichever is larger: a
    pair whose endpoints nearly meet has a length near 0, and float32 sums
    of its point differences carry the rounding of the decoded values, not
    of its length."""
    return float(np.max(np.abs(got - want)
                        / np.maximum(want, np.median(want))))


def step_seeds(chunk_seed: int, steps: int) -> list:
    """The per-step seeds of a chunk whose generator was seeded with
    ``chunk_seed``: the chunk's stream (its first pair at offset 0 of its
    call), its first phase, then each step."""
    phase = reference.fold_seed(reference.fold_seed(chunk_seed, 0), 1)
    return [reference.fold_seed(phase, i) for i in range(steps)]


def _mc_step_draws(seeds, pos, T: int, S: int, M: int, block: int = 50):
    """``draws(i)``: step i's draws of the splines whose per-step seeds are
    the columns of ``seeds`` (steps, P), at launch positions ``pos`` (P,);
    made ``block`` steps at a time."""
    cache = {}

    def draws(i):
        j = i // block
        if j not in cache:
            cache.clear()
            cache[j] = reference.mc_draws(seeds[j * block:(j + 1) * block],
                                          pos, T, S, M)
        d1, d2 = cache[j]
        return d1[i % block], d2[i % block]
    return draws


def optimize_numbers(layers, final_kind: str, traj_energy: str, chunks,
                     problem, T: int, steps: int, lr: float, n_sample: int,
                     seed: int, dev, mc_samples: int = 2,
                     rung: str = None, block: int = 25) -> dict:
    """``chunks``: dicts with the pairs ``idx`` (B,), the gradient ``grad``
    (B, K, D) the program's optimizer received on its first step, the
    program's final ``omega`` (B, K, D) and ``lengths`` (B,), and the chunk
    generator's ``seed``; ``problem``: (a, b, omega0, basis) over all
    pairs; ``rung``: the trajectory's reduced rung, or None.  The reference
    works in blocks of ``block`` splines."""
    a, b, omega0, basis = problem
    idx = np.concatenate([c["idx"] for c in chunks])
    om = np.concatenate([c["omega"] for c in chunks])
    got = np.concatenate([c["lengths"] for c in chunks]).astype(np.float64)
    want = reference.final_lengths(
        layers, _t(om, dev), _t(a[idx], dev), _t(b[idx], dev), basis, T,
        final_kind, "float64").cpu().numpy()
    out = {"final_gap": _gap(got, want)}

    M = layers[0][0].shape[0]
    B = len(chunks[0]["idx"])
    diff, norm = [], []
    for c in chunks:
        first = (torch.tensor([step_seeds(c["seed"], 1)] * B,
                              dtype=torch.int64, device=dev).t()
                 if traj_energy == "mc" else None)
        for s in range(0, B, block):
            sl = slice(s, s + block)
            p = c["idx"][sl]
            loss = reference.Loss(layers, _t(a[p], dev), _t(b[p], dev),
                                  basis, T, traj_energy, rung=rung)
            draws = None
            if first is not None:
                draws = reference.mc_draws(
                    first[:, sl], torch.arange(B, device=dev)[sl], T,
                    mc_samples, M)
                draws = (draws[0][0], draws[1][0])
            ref = loss.grad(_t(omega0[p], dev), draws).flatten(1)
            diff.append(torch.linalg.norm(_t(c["grad"][sl], dev).flatten(1)
                                          - ref, dim=1))
            norm.append(torch.linalg.norm(ref, dim=1))
    diff, norm = torch.cat(diff), torch.cat(norm)
    out["grad_gap"] = float((diff / torch.clamp(norm, min=norm.median()))
                            .max())

    # the sample: slots of completed pairs, drawn from the seed
    rng = np.random.default_rng(reference.fold_seed(seed, inputs.SAMPLE))
    slots = np.sort(rng.choice(len(idx), min(n_sample, len(idx)),
                               replace=False))
    draws = None
    if traj_energy == "mc":
        seeds = torch.tensor(
            [step_seeds(chunks[s // B]["seed"], steps) for s in slots],
            dtype=torch.int64, device=dev).t().contiguous()   # (steps, P)
        draws = _mc_step_draws(seeds, torch.as_tensor(slots % B, device=dev),
                               T, mc_samples, M)

    p_idx = idx[slots]
    start = _t(omega0[p_idx], dev)
    ref_om = reference.optimize(layers, start, _t(a[p_idx], dev),
                                _t(b[p_idx], dev), basis, T, steps, lr,
                                traj_energy, draws)
    ref_len = reference.final_lengths(
        layers, ref_om, _t(a[p_idx], dev), _t(b[p_idx], dev), basis, T,
        final_kind, "float64").cpu().numpy()
    out["traj_gap"] = _gap(want[slots], ref_len)
    moved = torch.linalg.norm((ref_om - start).flatten(1), dim=1)
    dist = torch.linalg.norm((_t(om[slots], dev) - ref_om).flatten(1), dim=1)
    out["omega_gap"] = float((dist / moved).max())
    return out
