"""Cells of kind ``optimize_scvi``: the ``optimize`` kind's geodesics
(``optimize.py``: every pair of the traffic's class representatives, whole
chunks through ``pipeline.optimize_stage.optimize_spline_batch``, back to
back) on an ensemble of scVI's decoders (``reference_scvi.py``), with the
expected ensemble energy.

The configuration gives scVI's sizes (``latent_dim``, ``decoder_hidden``
[H], ``input_dim`` G, ``num_decoders``, ``batchnorm_eps``,
``library_size``).  Weights are ``nn.Linear``'s init; the BatchNorm's
running statistics and affine parameters are drawn too (running var in
[0.5, 2], mean ~ N(0, 0.1^2), gamma ~ 1 + U(-0.1, 0.1), beta ~ U(-0.1,
0.1)), so the normalisation is not the identity.  A port without scVI's
decoder family is refused before anything is built: nothing here decodes
with a linear head.

``correct`` is decided as in ``judge.py``: ``final_gap`` (every completed
pair's length against the float64 length of the program's own final curve),
``grad_gap`` (the first-step gradient against the reference in the
arithmetic of the rung the configuration states) and ``traj_gap`` (the
traffic's ``check.sample_pairs`` pairs optimized again in float64).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from geobench import (harness, inputs, judge, optimize, profiling, reference,
                      work)
from geobench import reference_scvi as ref

# the sub-stream of a run's seed for the BatchNorm's statistics (inputs.py
# uses 0-5)
NORMS = 6


def require_port():
    """Raise unless the port carries scVI's decoder family: its config's
    head and K2's softmax route."""
    from vae_latent_geometry_tpu_torch.config import ModelConfig
    from vae_latent_geometry_tpu_torch.ops import energy_fused

    if (not hasattr(ModelConfig(), "decoder_head")
            or "softmax" not in getattr(energy_fused, "K2_ROUTES", {})):
        raise RuntimeError(
            "this port has no decoder with scVI's softmax head "
            "(ModelConfig.decoder_head, K2's softmax route): the cell "
            "cannot run it, and a linear head would be another model")


def decoders(cfg: dict, seed: int, device) -> dict:
    """The configuration's ensemble as ``reference_scvi`` takes it."""
    dims = [cfg["latent_dim"], *cfg["decoder_hidden"], cfg["input_dim"]]
    if len(dims) != 3:
        raise ValueError(f"scVI's decoder has one hidden layer, got {dims}")
    M, H = cfg["num_decoders"], dims[1]
    layers = inputs.linear_stack(inputs.generator(seed, inputs.WEIGHTS,
                                                  device), dims, M, device)
    g = inputs.generator(seed, NORMS, device)
    u = torch.rand((3, M, H), generator=g, device=device)
    mean = 0.1 * torch.randn((M, H), generator=g, device=device)
    norm = {"mean": mean, "var": 0.5 + 1.5 * u[0],
            "scale": 1.0 + 0.2 * (u[1] - 0.5), "bias": 0.2 * (u[2] - 0.5)}
    return {"layers": layers, "norm": norm,
            "eps": float(cfg["batchnorm_eps"]),
            "library": float(cfg["library_size"])}


def program_params(dec: dict):
    """The same ensemble as the port's decoder tree."""
    from vae_latent_geometry_tpu_torch.models.evae import EVAEParams

    M = dec["layers"][0][0].shape[0]
    dev = dec["layers"][0][0].device
    norm = {**dec["norm"], "eps": torch.full((M,), dec["eps"], device=dev)}
    return EVAEParams(encoder=None, decoders={
        "layers": [{"w": w, "b": b} for w, b in dec["layers"]],
        "norms": [norm],
        "softmax": {"library": torch.full((M,), dec["library"],
                                          device=dev)}})


def numbers(dec, chunks, problem, T: int, steps: int, lr: float,
            n_sample: int, seed: int, dev, rung, block: int) -> dict:
    """``judge.optimize_numbers``' comparisons through scVI's decoder, the
    reference in blocks of ``block`` splines."""
    a, b, omega0, basis = problem
    t = judge._t
    idx = np.concatenate([c["idx"] for c in chunks])
    om = np.concatenate([c["omega"] for c in chunks])
    got = np.concatenate([c["lengths"] for c in chunks]).astype(np.float64)
    want = ref.final_lengths(dec, t(om, dev), t(a[idx], dev),
                             t(b[idx], dev), basis, T, "float64",
                             block=block).cpu().numpy()
    out = {"final_gap": judge._gap(got, want)}

    diff, norm = [], []
    for c in chunks:
        for s in range(0, len(c["idx"]), block):
            p = c["idx"][s:s + block]
            loss = ref.Loss(dec, t(a[p], dev), t(b[p], dev), basis, T, rung)
            r = loss.grad(t(omega0[p], dev)).flatten(1)
            diff.append(torch.linalg.norm(
                t(c["grad"][s:s + block], dev).flatten(1) - r, dim=1))
            norm.append(torch.linalg.norm(r, dim=1))
    diff, norm = torch.cat(diff), torch.cat(norm)
    out["grad_gap"] = float((diff / torch.clamp(norm, min=norm.median()))
                            .max())

    rng = np.random.default_rng(reference.fold_seed(seed, inputs.SAMPLE))
    slots = np.sort(rng.choice(len(idx), min(n_sample, len(idx)),
                               replace=False))
    p_idx = idx[slots]
    start = t(omega0[p_idx], dev)
    ref_om = ref.optimize(dec, start, t(a[p_idx], dev), t(b[p_idx], dev),
                          basis, T, steps, lr)
    ref_len = ref.final_lengths(dec, ref_om, t(a[p_idx], dev),
                                t(b[p_idx], dev), basis, T, "float64",
                                block=block).cpu().numpy()
    out["traj_gap"] = judge._gap(want[slots], ref_len)
    moved = torch.linalg.norm((ref_om - start).flatten(1), dim=1)
    dist = torch.linalg.norm((t(om[slots], dev) - ref_om).flatten(1), dim=1)
    out["omega_gap"] = float((dist / moved).max())
    return out


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        producer: str = "program") -> dict:
    """One run; returns the pieces of the result line (see run.py).
    ``producer`` "control": the program at the traffic's ``control.traffic``
    (its own bfloat16 rung for the trajectory), the lengths it reports
    replaced by the reference's at ``control.final`` (TF32)."""
    require_port()
    from vae_latent_geometry_tpu_torch.config import GeodesicConfig, from_dict
    from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
    from vae_latent_geometry_tpu_torch.ops import energy_fused
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch,
    )

    model, traffic = cell.config, cell.traffic
    ctrl = traffic["control"]
    stated = optimize._rung(from_dict(GeodesicConfig, traffic["geodesic"]))
    if producer == "control":
        traffic = harness.merged(traffic, ctrl["traffic"])
    gcfg = from_dict(GeodesicConfig, traffic["geodesic"])
    if optimize._energy_kinds(gcfg) != ("expected", "expected"):
        raise ValueError("scVI's cells take the expected ensemble energy, "
                         f"not {gcfg.energy.mode!r}")
    dec = decoders(model, seed, dev)
    params = program_params(dec)
    pairs, a, b, omega0, basis = inputs.geodesic_problem(model, traffic,
                                                         seed, dev)
    P, B, T = len(a), gcfg.batch_size, gcfg.energy.num_t
    check = traffic["check"]
    labels = [["", ""]] * B

    def produce(k, cfg, grads):
        idx = (k * B + np.arange(B)) % P
        art = SplineBatchArtifact(
            a=a[idx], b=b[idx], omega_init=omega0[idx], basis=basis,
            n_poly=traffic["n_poly"], pair_indices=pairs[idx],
            valid=np.ones(B, bool), pair_labels=labels, representatives=[])
        s = reference.fold_seed(reference.fold_seed(seed, inputs.CHUNKS), k)
        out = optimize_spline_batch(
            params, art, None, cfg, dev, checkpoint_path=None,
            log_every_chunk=False, generator=torch.Generator().manual_seed(s))
        grad = grads[0].cpu().numpy()
        grads.clear()
        lengths = out.geodesic_length
        if producer == "control":
            lengths = ref.final_lengths(
                dec, torch.as_tensor(out.omega_optimized, device=dev),
                *(torch.as_tensor(x[idx], device=dev) for x in (a, b)), basis,
                T, ctrl["final"], block=check["block"]).cpu().numpy()
        return {"idx": idx, "seed": s, "grad": grad,
                "omega": out.omega_optimized, "lengths": lengths}

    with optimize.first_gradients() as grads:
        produce(-1, dataclasses.replace(gcfg, steps=traffic["warmup_steps"]),
                grads)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start

        launches0 = sum(energy_fused.LAUNCHES.values())
        passes0 = energy_fused.SOFTMAX_PASSES["energy_bwd"]
        routes0 = dict(energy_fused.K2_ROUTES)
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
    passes = energy_fused.SOFTMAX_PASSES["energy_bwd"] - passes0
    k2_routes = {r: n - routes0[r]
                 for r, n in energy_fused.K2_ROUTES.items()}
    memory = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
              else 0)
    traced = profiling.reduce(traced) if traced is not None else None

    n_pairs = len(chunks) * B
    failed = int(sum((~np.isfinite(c["lengths"])).sum() for c in chunks))
    nums = numbers(dec, chunks, (a, b, omega0, basis), T, gcfg.steps,
                   gcfg.lr, check["sample_pairs"], seed, dev, stated,
                   check["block"])
    # every K2 launch of the window took the softmax route
    nums["k2_other_routes"] = float(sum(
        n for r, n in k2_routes.items() if r != "softmax"))

    dims = [model["latent_dim"], *model["decoder_hidden"],
            model["input_dim"]]
    M, D = model["num_decoders"], model["latent_dim"]
    ctx = {"kind": "optimize", "trace": traced,
           "rung": optimize._rung(gcfg) or "float32",
           "grad_work": work.energy_grad_work(dims, T, B, M, D),
           "final_work": work.energy_value_work(dims, T, B, M, D),
           "steps": gcfg.steps, "energy_launches": launches,
           "window_steps": len(chunks) * gcfg.steps,
           "softmax_passes": passes}
    return {"setup_s": setup_s, "window_s": window_s,
            "e2e": {"pairs_per_s": n_pairs / window_s},
            "attempted": n_pairs, "failed": failed, "memory": memory,
            "numbers": nums, "ctx": ctx, "trace": traced}
