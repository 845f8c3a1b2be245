"""Cells of kind ``optimize``: geodesics between class representatives,
driven through the port's pipeline entry
``pipeline.optimize_stage.optimize_spline_batch``, one whole chunk of
``batch_size`` pairs a call, back to back, as the CLI's ``optimize`` runs
them.

The traffic mix names the recipe (``geodesic``: ``GeodesicConfig`` fields),
the pairs (every pair of ``classes`` representatives, chunks taken in
order and wrapping round, so every chunk is full), the warm-up, the check
and the control.  The window starts a chunk only while ``--seconds`` have
not elapsed and ends at that chunk's end; pairs/s counts every pair the
window completed over the window's whole time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from geobench import harness, inputs, judge, profiling, reference, work

SINGLE = ("single", "single_fused", "single_fused_bf16")


def _energy_kinds(gcfg):
    """(trajectory energy, final length) of the reference for a recipe."""
    mode = gcfg.energy.mode
    if mode in SINGLE:
        return "single", "arc"
    final = (gcfg.final_energy_mode or mode)
    if final.startswith("mc"):
        raise ValueError("a Monte-Carlo final energy is a draw, not an "
                         "answer to hold to a reference")
    return ("mc" if mode.startswith("mc") else "expected"), "expected"


def _rung(gcfg):
    """The reduced rung of the trajectory's energy kernels, or None."""
    if gcfg.energy.mode.endswith("_fused_bf16"):
        return "bfloat16"
    if gcfg.energy.mode.endswith("_fused"):
        rung = gcfg.energy.kernel_precision
        return None if rung == "float32" else rung
    return None


def _program_params(model: dict, layers, single: bool):
    from vae_latent_geometry_tpu_torch.models.evae import EVAEParams
    from vae_latent_geometry_tpu_torch.models.vae import VAEParams

    if single:
        return VAEParams(encoder=None, decoder={
            "layers": [{"w": w[0], "b": b[0]} for w, b in layers]})
    return EVAEParams(encoder=None, decoders={
        "layers": [{"w": w, "b": b} for w, b in layers]})


@contextlib.contextmanager
def first_gradients():
    """The gradient the port's optimizer receives on the first step of each
    call, kept as it passes (a copy; the step is the program's own)."""
    from vae_latent_geometry_tpu_torch.optim import geodesic

    step, seen = geodesic.Adam.step, []

    def observed(self, params, grad, state):
        if isinstance(params, torch.Tensor) and state["count"] == 0:
            seen.append(grad.detach().clone())
        return step(self, params, grad, state)

    geodesic.Adam.step = observed
    try:
        yield seen
    finally:
        geodesic.Adam.step = step


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        producer: str = "program") -> dict:
    """One run; returns the pieces of the result line (see run.py).
    ``producer`` "control": each stage one precision below what the
    configuration states: the program with the traffic's
    ``control.traffic`` switched on (its own bfloat16 rung for the
    trajectory), and the lengths it reports replaced by the reference's at
    ``control.final`` (TF32 for the float32 final pass, which the program
    has no lower path for)."""
    from vae_latent_geometry_tpu_torch.config import GeodesicConfig, from_dict
    from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
    from vae_latent_geometry_tpu_torch.ops import energy_fused
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch,
    )

    model, traffic = cell.config, cell.traffic
    ctrl = traffic["control"]
    # the rung the configuration states is what the gradient is held to
    stated = _rung(from_dict(GeodesicConfig, traffic["geodesic"]))
    if producer == "control":
        traffic = harness.merged(traffic, ctrl["traffic"])
    gcfg = from_dict(GeodesicConfig, traffic["geodesic"])
    traj_energy, final_kind = _energy_kinds(gcfg)
    single = traj_energy == "single"
    layers = inputs.decoders(model, seed, dev)
    ref_layers = (reference.mean_head(layers, model["input_dim"])
                  if model["heteroscedastic"] else layers)
    params = _program_params(model, layers, single)
    pairs, a, b, omega0, basis = inputs.geodesic_problem(model, traffic,
                                                         seed, dev)
    P, B, T = len(a), gcfg.batch_size, gcfg.energy.num_t
    n_poly = traffic["n_poly"]
    labels = [["", ""]] * B

    def chunk(k):
        idx = (k * B + np.arange(B)) % P
        return idx, SplineBatchArtifact(
            a=a[idx], b=b[idx], omega_init=omega0[idx], basis=basis,
            n_poly=n_poly, pair_indices=pairs[idx],
            valid=np.ones(B, bool), pair_labels=labels, representatives=[])

    def chunk_seed(k):
        return reference.fold_seed(reference.fold_seed(seed, inputs.CHUNKS),
                                   k)

    def produce(k, cfg, grads):
        idx, art = chunk(k)
        s = chunk_seed(k)
        out = optimize_spline_batch(
            params, art, None, cfg, dev, checkpoint_path=None,
            log_every_chunk=False, generator=torch.Generator().manual_seed(s))
        grad = grads[0].cpu().numpy()
        grads.clear()
        lengths = out.geodesic_length
        if producer == "control":
            lengths = reference.final_lengths(
                ref_layers, torch.as_tensor(out.omega_optimized, device=dev),
                *(torch.as_tensor(x[idx], device=dev) for x in (a, b)), basis,
                T, final_kind, ctrl["final"]).cpu().numpy()
        return {"idx": idx, "seed": s, "grad": grad,
                "omega": out.omega_optimized, "lengths": lengths}

    with first_gradients() as grads:
        # warm-up: every shape of the window, a few steps of one chunk
        produce(-1, dataclasses.replace(gcfg, steps=traffic["warmup_steps"]),
                grads)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start

        launches0 = sum(energy_fused.LAUNCHES.values())
        chunks, traced = [], None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k = len(chunks)
            if trace and traced is None:
                box = []
                traced = profiling.capture(
                    lambda: (box.append(produce(k, gcfg, grads)),
                             gcfg.steps)[1])
                chunks.append(box[0])
            else:
                chunks.append(produce(k, gcfg, grads))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    launches = sum(energy_fused.LAUNCHES.values()) - launches0
    memory = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
              else 0)
    traced = profiling.reduce(traced) if traced is not None else None

    n_pairs = len(chunks) * B
    failed = int(sum((~np.isfinite(c["lengths"])).sum() for c in chunks))
    numbers = judge.optimize_numbers(
        ref_layers, final_kind, traj_energy, chunks, (a, b, omega0, basis),
        T, gcfg.steps, gcfg.lr, traffic["check"]["sample_pairs"], seed, dev,
        gcfg.energy.mc_samples, stated)

    # the yardstick of this recipe: per trajectory step and per final pass
    dims = [model["latent_dim"], *model["decoder_hidden"],
            model["input_dim"]]
    M = 1 if single else model["num_decoders"]
    n_dec = work.decoders_per_point(gcfg.energy.mode, M,
                                    gcfg.energy.mc_samples)
    D = model["latent_dim"]
    grad = work.energy_grad_work(dims, T, B, n_dec, D)
    final = work.energy_value_work(dims, T, B, M, D)
    rung = _rung(gcfg) or "float32"
    ctx = {"kind": "optimize", "trace": traced, "rung": rung,
           "grad_work": grad, "final_work": final, "steps": gcfg.steps,
           "energy_launches": launches,
           "window_steps": len(chunks) * gcfg.steps}
    return {"setup_s": setup_s, "window_s": window_s,
            "e2e": {"pairs_per_s": n_pairs / window_s},
            "attempted": n_pairs, "failed": failed, "memory": memory,
            "numbers": numbers, "ctx": ctx, "trace": traced}
