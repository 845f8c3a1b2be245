#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits nonzero:

1. build   — compile the CUDA kernels from ``vae_latent_geometry_tpu_torch/
             ops/csrc`` with nvcc (sm_90a); card name, power limit, versions.
2. kernels — at full width (seed-42 10-decoder EVAE, the 190 seed-42 init
             curves padded to B=200, T=2000): each kernel against its plain
             PyTorch version on the same inputs, every precision rung, M=10
             and M=1; CUDA-event times of kernel and plain version.
3. main    — ``optimize_spline_batch`` (expected_fused, f32x2, 1000 Adam
             steps at lr 1e-3 constant, T=2000) then ``distance_matrix``;
             launch counts of both kernels during that run; lengths against
             the JAX package run on the CPU with the same recipe
             (``tools/jax_reference_lengths.py``) and, loosely, against its
             committed TPU result on the same init blob; then the same run
             through the unfused plain-PyTorch ``expected`` mode (float32)
             as the end-to-end yardstick.
4. rung    — pairs 0, 42, 65, 164 through the same recipe at float32
             against the JAX package on the CPU at float32.
5. the ``kernels`` summary line, the card line, and the result line.

Imports nothing of JAX or of the JAX package.  Needs one CUDA GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "experiment", "model_seed42.npz")
INIT = os.path.join(ROOT, "experiment", "splines_init_model_seed42",
                    "spline_batch_init_entropy_20.npz")
JAX_OPT = os.path.join(ROOT, "experiment", "splines_opt_model_seed42",
                       "spline_batch_opt_entropy_20.npz")
JAX_CPU = os.path.join(ROOT, "tools", "jax_reference_lengths_seed42.json")
JAX_CPU_F32 = os.path.join(ROOT, "tools",
                           "jax_reference_lengths_seed42_float32.json")
STEPS = 1000                # the reference recipe's, as in both JAX_CPU files
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")   # nvcc log, lengths

# H100 SXM published peaks (dense): fp32 on CUDA cores, bf16 tensor cores,
# HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# Tolerances, kernel vs plain version on the same inputs.
# Energies: the JAX suite's rtol 1e-5 (tests/test_energy_pallas.py:36),
# except at the bfloat16 rung with M=1: there every decoded point carries
# ~2e-3 input rounding, a one-ulp fp32 difference from another summation
# order flips a bf16 rounding, and on smooth single-decoder curves at
# T=2000 that noise dominates the segment differences (measured 1.2e-3 on
# the card; at M=10 the ensemble variance term dominates: 4.8e-6).
# dgamma: errors relative to max|dgamma|, judged on the median and the 99th
# percentile, plus the share of elements above 1e-3.  A decoder unit whose
# pre-activation sits within fp32 rounding of zero takes its ReLU branch in
# one summation order and not the other, and moves dgamma at that point by
# up to a few percent; such points exist even at float32 (the kernels
# phase prints their share).
E_RTOL = 1e-5
E_RTOL_BF16_M1 = 5e-3
DG_MED = 1e-4
DG_P99 = 1e-3
DG_OVER = 1e-3            # element error level counted ...
DG_OVER_SHARE = {"float32": 1e-4, "f32x3": 1e-2, "f32x2": 1e-2,
                 "bfloat16": 1e-2}  # ... and the share allowed above it
# Main path lengths, per-pair relative difference.
# (a) vs the JAX package run on the CPU with the same recipe
#     (tools/jax_reference_lengths_seed42.json): median 1e-4 as proposed for
#     the slice; the max is 1e-2, not 1e-3, because after 1000 Adam steps a
#     few sensitive pairs amplify fp32 summation-order differences of the
#     f32x2 rung: pair 65 ends 2.8e-3 from the JAX CPU run on the H100,
#     while at float32 it agrees to a few 1e-6 (phase rung, LEN_MAX_F32)
#     and the JAX package's own TPU artifact lands 3e-3 on the other side.
# (b) vs the JAX package's committed TPU artifact: just above how far the
#     JAX package itself on the CPU, same recipe, lands from that artifact
#     (median 1.2e-3, max 4.2% at pair 164).
LEN_MED = 1e-4
LEN_MAX = 1e-2
LEN_MAX_F32 = 1e-4
TPU_LEN_MED = 2e-3
TPU_LEN_MAX = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()                                    # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def decode_flops(D, H, X, passes):
    """FLOP of one decoder on one point, tail layers at ``passes``."""
    return 2 * D * H + passes * (2 * H * H + 2 * H * X)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
    from vae_latent_geometry_tpu_torch.geometry.spline import (
        design_matrix, eval_spline_design, t_grid)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import _build
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.optim.geodesic import optimize_splines
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import distance_matrix
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")
    card = card_line()

    # 1. build --------------------------------------------------------------
    build_s = _build.build_all()
    with open(os.path.join(OUT_DIR, "nvcc_build.log"), "w") as f:
        f.write("\n".join(_build.BUILD_LOG.values()))
    ptxas = [l.strip() for log in _build.BUILD_LOG.values()
             for l in log.splitlines() if "registers" in l or "spill" in l]
    emit({"phase": "build", "seconds": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})

    # 2. kernels vs plain versions at full width ----------------------------
    params = load_npz(MODEL, dev)
    art = load_spline_batch(INIT)
    B, T = 200, 2000
    idx = np.concatenate([np.arange(len(art)),
                          np.full(B - len(art), len(art) - 1)])
    t = t_grid(T, dev)
    phi = design_matrix(t, art.basis, art.n_poly)
    gamma = eval_spline_design(
        torch.as_tensor(art.omega_init[idx], device=dev),
        torch.as_tensor(art.a[idx], device=dev),
        torch.as_tensor(art.b[idx], device=dev), phi, t).contiguous()
    ws_all, bs_all = ef.stack_weights(params.decoders)
    D = gamma.shape[2]
    H = ws_all[1].shape[1]
    X = ws_all[2].shape[2]
    ct = torch.ones(B, dtype=torch.float32, device=dev)
    errors, times = {}, {}
    for M in (ws_all[0].shape[0], 1):
        ws = [w[:M].contiguous() for w in ws_all]
        bs = [b[:M].contiguous() for b in bs_all]
        wmb = ef.uniform_weights(M, B, dev)
        for prec in ef.PRECISIONS:
            e_k = ef.energy_fwd(ws, bs, gamma, wmb, prec)
            e_p = ef.energy_fwd_plain(ws, bs, gamma, wmb, prec)
            g_k = ef.energy_bwd(ws, bs, gamma, wmb, ct, prec)
            g_p = ef.energy_bwd_plain(ws, bs, gamma, wmb, ct, prec)
            torch.cuda.synchronize()
            e_rel = float(((e_k - e_p).abs() / e_p.abs()).max())
            g_err = ((g_k - g_p).abs() / g_p.abs().max()).flatten()
            rec = {"phase": "kernels", "M": M, "precision": prec,
                   "energy_max_rel": e_rel,
                   "energy_max_abs": float((e_k - e_p).abs().max()),
                   "dgamma_max_abs": float((g_k - g_p).abs().max()),
                   "dgamma_rel_max": float(g_err.max()),
                   "dgamma_rel_median": float(g_err.median()),
                   "dgamma_rel_p99": float(torch.quantile(
                       g_err[::7].double(), 0.99)),
                   "dgamma_share_over_1e-3": float(
                       (g_err > DG_OVER).double().mean()),
                   "finite": bool(torch.isfinite(e_k).all()
                                  and torch.isfinite(g_k).all())}
            if M > 1 and prec in ("float32", "f32x2"):
                reps = 5
                rec["fwd_ms"] = time_ms(
                    lambda: ef.energy_fwd(ws, bs, gamma, wmb, prec), reps)
                rec["fwd_plain_ms"] = time_ms(
                    lambda: ef.energy_fwd_plain(ws, bs, gamma, wmb,
                                                prec), 3)
                rec["bwd_ms"] = time_ms(
                    lambda: ef.energy_bwd(ws, bs, gamma, wmb, ct, prec), reps)
                rec["bwd_plain_ms"] = time_ms(
                    lambda: ef.energy_bwd_plain(ws, bs, gamma, wmb, ct,
                                                prec), 3)
                times[prec] = rec
            emit(rec)
            errors[(M, prec)] = rec

    # 3. main path ----------------------------------------------------------
    cfg = GeodesicConfig(
        steps=STEPS, lr=1e-3, lr_schedule="constant", batch_size=B,
        energy=EnergyConfig(num_t=T, mode="expected_fused",
                            kernel_precision="f32x2"))
    data = load_tasic().x
    torch.cuda.synchronize()
    ef.reset_launch_counts()
    t0 = time.perf_counter()
    out = optimize_spline_batch(params, art, data=data, cfg=cfg, device=dev,
                                log_every_chunk=False)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    mat, labels = distance_matrix(out)
    launches = dict(ef.LAUNCHES)
    ref = load_spline_batch(JAX_OPT)
    same_init = bool(np.array_equal(ref.omega_init, art.omega_init))
    lengths = np.asarray(out.geodesic_length, np.float64)
    rel_tpu = np.abs(lengths / np.asarray(ref.geodesic_length, np.float64) - 1)
    with open(JAX_CPU) as f:
        cpu_ref = json.load(f)
    sel = np.asarray(cpu_ref["pairs"])
    rel = np.abs(lengths[sel] / np.asarray(cpu_ref["lengths"]) - 1)
    main_rec = {"phase": "main", "pairs": len(art), "steps": STEPS,
                "optimize_s": opt_s, "steps_per_s": STEPS / opt_s,
                "launches": launches, "init_identical": same_init,
                "lengths_finite": bool(np.isfinite(lengths).all()),
                "matrix_shape": list(mat.shape),
                "vs_jax_cpu_pairs": int(len(sel)),
                "len_rel_median": float(np.median(rel)),
                "len_rel_p99": float(np.quantile(rel, 0.99)),
                "len_rel_max": float(rel.max()),
                "len_rel_argmax_pair": int(sel[np.argmax(rel)]),
                "tpu_len_rel_median": float(np.median(rel_tpu)),
                "tpu_len_rel_max": float(rel_tpu.max()),
                "len_mean": float(lengths.mean()),
                "len_mean_jax_tpu": float(np.mean(ref.geodesic_length))}
    emit(main_rec)

    # 3b. the same run through the unfused plain-PyTorch mode ("expected",
    # float32 decode of all decoders, autograd): the end-to-end yardstick
    plain_cfg = dataclasses.replace(cfg, energy=dataclasses.replace(
        cfg.energy, mode="expected"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = optimize_spline_batch(params, art, cfg=plain_cfg, device=dev,
                                  log_every_chunk=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rel_plain = np.abs(lengths / np.asarray(plain.geodesic_length) - 1)
    emit({"phase": "plain_path", "mode": "expected", "optimize_s": plain_s,
          "steps_per_s": STEPS / plain_s,
          "vs_main_len_rel_median": float(np.median(rel_plain)),
          "vs_main_len_rel_max": float(rel_plain.max())})
    np.savez(os.path.join(OUT_DIR, "main_lengths.npz"), port=lengths,
             jax=np.asarray(ref.geodesic_length))

    # 3c. the float32 rung on a few pairs (the sensitive 65 and 164 among
    # them), padded to B, against the JAX package on the CPU at float32
    with open(JAX_CPU_F32) as f:
        f32_ref = json.load(f)
    sel32 = np.asarray(f32_ref["pairs"])
    pad32 = np.concatenate([sel32, np.full(B - len(sel32), sel32[-1])])
    f32_cfg = dataclasses.replace(cfg, energy=dataclasses.replace(
        cfg.energy, kernel_precision="float32"))
    r32 = optimize_splines(params.decoders, art.omega_init[pad32],
                           art.a[pad32], art.b[pad32], art.basis, f32_cfg,
                           device=dev)
    len32 = r32.lengths.double().cpu().numpy()[:len(sel32)]
    rel32 = np.abs(len32 / np.asarray(f32_ref["lengths"]) - 1)
    emit({"phase": "rung", "precision": "float32", "pairs": sel32.tolist(),
          "lengths": len32.tolist(), "len_rel": rel32.tolist(),
          "len_rel_max": float(rel32.max())})

    # 5. kernels line -------------------------------------------------------
    P = T * B
    M = ws_all[0].shape[0]
    in_bytes = 4 * (gamma.numel() + sum(w.numel() for w in ws_all)
                    + sum(b.numel() for b in bs_all) + M * B)
    k1_flops = P * M * decode_flops(D, H, X, 1)
    k2_flops = P * M * (decode_flops(D, H, X, 2) + 2 * H * X + 2 * H * H
                        + 2 * H * D)
    k1_bound = max(k1_flops / PEAK_FP32, (in_bytes + 4 * B) / PEAK_BYTES)
    k2_bound = max(k2_flops / PEAK_BF16,
                   (in_bytes + 4 * B + 4 * gamma.numel()) / PEAK_BYTES)
    kernels = [
        {"name": "energy_fwd (K1, float32 final re-evaluation)",
         "route": "cuda",
         "source": "vae_latent_geometry_tpu_torch/ops/csrc/energy_expected.cu",
         "replaces": "vae_latent_geometry_tpu/ops/energy_pallas.py:254",
         "launches": launches["energy_fwd"],
         "max_abs_err": errors[(M, "float32")]["energy_max_abs"],
         "ms": times["float32"]["fwd_ms"],
         "plain_ms": times["float32"]["fwd_plain_ms"],
         "bound_ms": 1e3 * k1_bound, "bound_by": "operations",
         "library_ms": None},
        {"name": "energy_bwd (K2, f32x2 trajectory steps)",
         "route": "cuda",
         "source": "vae_latent_geometry_tpu_torch/ops/csrc/energy_expected.cu",
         "replaces": "vae_latent_geometry_tpu/ops/energy_pallas.py:325",
         "launches": launches["energy_bwd"],
         "max_abs_err": errors[(M, "f32x2")]["dgamma_max_abs"],
         "ms": times["f32x2"]["bwd_ms"],
         "plain_ms": times["f32x2"]["bwd_plain_ms"],
         "bound_ms": 1e3 * k2_bound, "bound_by": "operations",
         "library_ms": None},
    ]

    # checks ----------------------------------------------------------------
    for (m, prec), r in errors.items():
        if not r["finite"]:
            fail(f"non-finite kernel output at M={m} {prec}")
        e_tol = E_RTOL_BF16_M1 if (prec, m) == ("bfloat16", 1) else E_RTOL
        if r["energy_max_rel"] > e_tol:
            fail(f"K1 energy rel err {r['energy_max_rel']:.3g} > {e_tol} "
                 f"at M={m} {prec}")
        if r["dgamma_share_over_1e-3"] > DG_OVER_SHARE[prec]:
            fail(f"K2 dgamma: {r['dgamma_share_over_1e-3']:.3g} of elements "
                 f"off by > {DG_OVER} at M={m} {prec}")
        if r["dgamma_rel_median"] > DG_MED or r["dgamma_rel_p99"] > DG_P99:
            fail(f"K2 dgamma median/p99 err {r['dgamma_rel_median']:.3g}/"
                 f"{r['dgamma_rel_p99']:.3g} at M={m} {prec}")
    n_chunks = -(-len(art) // B)
    if launches["energy_bwd"] < STEPS * n_chunks:
        fail(f"K2 launched {launches['energy_bwd']} times in "
             f"{STEPS * n_chunks} steps")
    if launches["energy_fwd"] < 1:
        fail("K1 was not launched on the main path")
    if not (same_init and main_rec["lengths_finite"]
            and mat.shape == (len(labels), len(labels))
            and np.isfinite(mat).all()):
        fail("main path output malformed")
    if (main_rec["len_rel_median"] > LEN_MED
            or main_rec["len_rel_max"] > LEN_MAX):
        fail(f"lengths vs the JAX package on the CPU: median "
             f"{main_rec['len_rel_median']:.3g}, max "
             f"{main_rec['len_rel_max']:.3g}")
    if (main_rec["tpu_len_rel_median"] > TPU_LEN_MED
            or main_rec["tpu_len_rel_max"] > TPU_LEN_MAX):
        fail(f"lengths vs the JAX TPU artifact: median "
             f"{main_rec['tpu_len_rel_median']:.3g}, max "
             f"{main_rec['tpu_len_rel_max']:.3g}")
    if not (np.isfinite(len32).all() and rel32.max() <= LEN_MAX_F32):
        fail(f"float32 lengths vs the JAX package on the CPU: "
             f"max {rel32.max():.3g}")

    emit({"kernels": kernels})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
