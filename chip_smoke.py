#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits nonzero:

1. build   — compile the CUDA kernels from ``vae_latent_geometry_tpu_torch/
             ops/csrc`` with nvcc (sm_90a); card name, power limit, versions.
2. kernels — at full width (seed-42 10-decoder EVAE, the 190 seed-42 init
             curves padded to B=200, T=2000, S=2 MC samples): each kernel
             against its plain PyTorch version on the same inputs, every
             precision rung, M=10 and M=1, and once with mixed per-spline
             decoder counts; CUDA-event times of kernel and plain version.
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
5. mc_stats — the mean of the in-kernel-draw MC energy (K7) over 64 seeds
             against the expected energy (K1, float32), per spline, as
             z-scores, for 16 groups of 64 seeds: consecutive raw seeds, the
             optimizer's own seed stream (``fold_seed``), and K5 on
             ``torch.randint`` planes as the yardstick; a histogram of the
             drawn decoder indices.
6. mc_main — ``optimize_spline_batch`` at ``mc_fused`` (f32x2, draws made
             in the kernels, 1000 steps, final energies by
             ``expected_fused``): launch counts, steps/s, lengths against
             phase ``main``; mc_repeat — the same seed again with the final
             energies by the MC kernel itself: bit-identical curves.
7. mc_ext  — 200 steps with the draws shipped as index planes (K5/K6), and
             200 steps of the unfused plain-PyTorch ``mc`` mode as the
             end-to-end yardstick; mc_scan — 20 steps of the chunked unfused
             mode (no kernel) after a 2-step warm-up; mc_coarse_bf16 — a cut turbo plan with its
             coarse phase at ``mc_fused_bf16`` (the CLI's ``--coarse-bf16``).
8. the ``kernels`` summary line, the card line, and the result line.

The kernels phase also holds the four MC kernels (K5-K8) against their plain
versions, and K7/K8 against K5/K6 on the planes of ``philox_draws``.

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
# The MC energies at the bfloat16 rung with M=10: a sampled endpoint is ONE
# decoder's output, so the bf16 rounding flips that the expected energy
# averages over ten decoders (4.8e-6 there) show about sqrt(10) larger
# (measured 9.5e-6 on given planes, 1.2e-5 on the in-kernel draws).
E_RTOL_MC_BF16 = 5e-5
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
# MC path.  (c) The mean of K7 over MC_SEEDS seeds against K1's float32
# expected energy, z = (mean - expected) / (std / sqrt(n)) per spline and
# group of seeds, MC_GROUPS x 200 = 3200 scores per seed stream.  Unbiased,
# independent draws give Student-t scores (63 degrees): mean 0 +- 0.018,
# spread 1.016 +- 0.013, so |mean| <= 0.1, spread within 1.02 +- 0.08 and
# |z| <= 5 (about one run in a hundred would exceed that by chance; the
# seeds are fixed).  A correlation between seeds would widen the spread, a
# bias would move the mean.  Held alike for consecutive raw seeds, for the
# seeds the optimizer uses (fold_seed of a phase seed and the step) and for
# K5 on ``torch.randint`` planes, the yardstick.  The drawn indices'
# chi-square over the 10 decoders (9 degrees of freedom) stays below its
# 99.9th percentile.  (d) Lengths of the
# MC-optimized curves, measured by the same float32 expected energy as phase
# main's: MC_LEN_MED is the slice's proposed median (measured 2.4e-3); the
# max is about twice the measured 4.6% (pair 188): single pairs settle
# elsewhere under gradient noise, as they do between precision rungs (3.3%
# between f32x2 and float32, phase plain_path), and another seed moves
# other pairs (PERF.md, Findings).
MC_SAMPLES = 2
MC_SEEDS = 64
MC_GROUPS = 16
MC_Z_MAX = 5.0
MC_Z_MEAN = 0.1
MC_Z_SPREAD = (0.94, 1.10)
MC_CHI2_MAX = 27.9
MC_LEN_MED = 1e-2
MC_LEN_MAX = 1e-1
MC_EXT_STEPS = 200
MC_SCAN_STEPS = 20
MC_COARSE_PLAN = ((100, 256, "cosine", 3e-3), (20, 2000, "constant", 1e-3))


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


def dgamma_stats(g_k, g_p, prefix=""):
    """Errors of a kernel's dgamma relative to max|dgamma| of the plain
    version's."""
    import torch

    err = ((g_k - g_p).abs() / g_p.abs().max()).flatten()
    return {prefix + "dgamma_max_abs": float((g_k - g_p).abs().max()),
            prefix + "dgamma_rel_max": float(err.max()),
            prefix + "dgamma_rel_median": float(err.median()),
            prefix + "dgamma_rel_p99": float(torch.quantile(
                err[::7].double(), 0.99)),
            prefix + "dgamma_share_over_1e-3": float(
                (err > DG_OVER).double().mean())}


def decode_flops(D, H, X, passes):
    """FLOP of one decoder on one point, tail layers at ``passes``."""
    return 2 * D * H + passes * (2 * H * H + 2 * H * X)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from vae_latent_geometry_tpu_torch.cli import coarse_bf16_plan
    from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
    from vae_latent_geometry_tpu_torch.geometry.spline import (
        design_matrix, eval_spline_design, t_grid)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import _build
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc
    from vae_latent_geometry_tpu_torch.optim.geodesic import (
        fold_seed, optimize_splines)
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
    mc_ct = torch.linspace(0.5, 2.0, B, device=dev)
    mc_seed = (1 << 40) + 42

    def mc_inputs(M, num_active):
        """Index planes, per-spline counts and the planes K7/K8 draw."""
        gen = torch.Generator(device=dev).manual_seed(7)
        d1, d2 = mc.sample_decoder_indices(gen, T, B, M, MC_SAMPLES,
                                           num_active)
        kmax = (torch.full((B,), float(M), device=dev) if num_active is None
                else num_active.float())
        p1, p2 = (d.contiguous() for d in mc.philox_draws(
            mc_seed, MC_SAMPLES, T, B, kmax))
        return d1, d2, kmax, p1, p2

    def mc_check(ws, bs, M, prec, num_active):
        """K5/K6 against their plain versions on given planes; K7/K8 against
        K5/K6 on the planes of ``philox_draws`` (exact: the proof that
        forward and backward make the same draws) and so against the plain
        versions on those planes."""
        d1, d2, kmax, p1, p2 = mc_inputs(M, num_active)
        e5 = mc.energy_mc_fwd(ws, bs, gamma, d1, d2, prec)
        e5_p = mc.energy_mc_fwd_plain(ws, bs, gamma, d1, d2, prec)
        g6 = mc.energy_mc_bwd(ws, bs, gamma, d1, d2, mc_ct, prec)
        g6_p = mc.energy_mc_bwd_plain(ws, bs, gamma, d1, d2, mc_ct, prec)
        e7 = mc.energy_mc_fwd_rng(ws, bs, gamma, mc_seed, kmax, MC_SAMPLES,
                                  prec)
        g8 = mc.energy_mc_bwd_rng(ws, bs, gamma, mc_seed, kmax, MC_SAMPLES,
                                  mc_ct, prec)
        e7_p = mc.energy_mc_fwd_plain(ws, bs, gamma, p1, p2, prec)
        g8_p = mc.energy_mc_bwd_plain(ws, bs, gamma, p1, p2, mc_ct, prec)
        torch.cuda.synchronize()
        return {
            "mc_energy_max_rel": float(((e5 - e5_p).abs() / e5_p.abs()).max()),
            "mc_energy_max_abs": float((e5 - e5_p).abs().max()),
            **dgamma_stats(g6, g6_p, "mc_"),
            "mc_rng_energy_max_rel": float(
                ((e7 - e7_p).abs() / e7_p.abs()).max()),
            "mc_rng_energy_max_abs": float((e7 - e7_p).abs().max()),
            **dgamma_stats(g8, g8_p, "mc_rng_"),
            "k7_equals_k5_on_philox_planes": bool(torch.equal(
                e7, mc.energy_mc_fwd(ws, bs, gamma, p1, p2, prec))),
            "k8_equals_k6_on_philox_planes": bool(torch.equal(
                g8, mc.energy_mc_bwd(ws, bs, gamma, p1, p2, mc_ct, prec))),
            "mc_draws_in_range": bool((p1 < kmax[None, None]).all()
                                      and (p2 < kmax[None, None]).all()
                                      and p1.min() >= 0 and p2.min() >= 0),
            "mc_finite": bool(torch.isfinite(e5).all()
                              and torch.isfinite(g6).all()
                              and torch.isfinite(e7).all()
                              and torch.isfinite(g8).all())}

    def decodes_needed(d1, d2, M):
        """(point, decoder) pairs that the sampled energy on these planes
        uses: decoder m at point t where d1[s, t] or d2[s, t-1] names it."""
        need = torch.zeros((T, B, M), dtype=torch.bool, device=dev)
        for s in range(d1.shape[0]):
            need[:-1].scatter_(2, d1[s].long()[..., None], True)
            need[1:].scatter_(2, d2[s].long()[..., None], True)
        return int(need.sum())

    def mc_times(ws, bs, M, prec):
        d1, d2, kmax, p1, p2 = mc_inputs(M, None)
        S = MC_SAMPLES
        return {
            "mc_decodes_needed": decodes_needed(d1, d2, M),
            "mc_rng_decodes_needed": decodes_needed(p1, p2, M),
            "mc_fwd_ms": time_ms(lambda: mc.energy_mc_fwd(
                ws, bs, gamma, d1, d2, prec), 5),
            "mc_fwd_plain_ms": time_ms(lambda: mc.energy_mc_fwd_plain(
                ws, bs, gamma, d1, d2, prec), 3),
            "mc_bwd_ms": time_ms(lambda: mc.energy_mc_bwd(
                ws, bs, gamma, d1, d2, mc_ct, prec), 5),
            "mc_bwd_plain_ms": time_ms(lambda: mc.energy_mc_bwd_plain(
                ws, bs, gamma, d1, d2, mc_ct, prec), 3),
            "mc_rng_fwd_ms": time_ms(lambda: mc.energy_mc_fwd_rng(
                ws, bs, gamma, mc_seed, kmax, S, prec), 5),
            "mc_rng_fwd_plain_ms": time_ms(lambda: mc.energy_mc_fwd_rng_plain(
                ws, bs, gamma, mc_seed, kmax, S, prec), 3),
            "mc_rng_bwd_ms": time_ms(lambda: mc.energy_mc_bwd_rng(
                ws, bs, gamma, mc_seed, kmax, S, mc_ct, prec), 5),
            "mc_rng_bwd_plain_ms": time_ms(lambda: mc.energy_mc_bwd_rng_plain(
                ws, bs, gamma, mc_seed, kmax, S, mc_ct, prec), 3)}

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
            rec = {"phase": "kernels", "M": M, "precision": prec,
                   "energy_max_rel": float(
                       ((e_k - e_p).abs() / e_p.abs()).max()),
                   "energy_max_abs": float((e_k - e_p).abs().max()),
                   **dgamma_stats(g_k, g_p),
                   "finite": bool(torch.isfinite(e_k).all()
                                  and torch.isfinite(g_k).all())}
            rec.update(mc_check(ws, bs, M, prec, None))
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
                rec.update(mc_times(ws, bs, M, prec))
                times[prec] = rec
            emit(rec)
            errors[(M, prec)] = rec
    # the MC kernels once more with mixed per-spline decoder counts
    num_active = torch.as_tensor(
        np.random.default_rng(3).integers(1, 11, size=B), device=dev)
    rec = {"phase": "kernels", "M": ws_all[0].shape[0], "precision": "f32x2",
           "num_active": "mixed",
           **mc_check(ws_all, bs_all, ws_all[0].shape[0], "f32x2",
                      num_active)}
    emit(rec)
    errors[("mixed", "f32x2")] = rec

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

    # 5. mc_stats: K7's mean over seeds against K1's expected energy --------
    M = ws_all[0].shape[0]
    kmax = torch.full((B,), float(M), device=dev)
    e_exp = ef.energy_fwd(ws_all, bs_all, gamma, ef.uniform_weights(M, B, dev),
                          "float32").double()
    n_draws = MC_GROUPS * MC_SEEDS

    def z_scores(energies):
        """(n_draws, B) sampled energies -> z per (group of seeds, spline)."""
        d = energies.double().reshape(MC_GROUPS, MC_SEEDS, B)
        return (d.mean(1) - e_exp) / (d.std(1) / MC_SEEDS ** 0.5), d

    def k7(seed):
        return mc.energy_mc_fwd_rng(ws_all, bs_all, gamma, seed, kmax,
                                    MC_SAMPLES, "float32")

    # consecutive raw seeds; the optimizer's stream (group = phase, seed =
    # step, as optimize_splines folds them); planes from torch.randint
    phase_seeds = [fold_seed(0, 1 + g) for g in range(MC_GROUPS)]
    gen = torch.Generator(device=dev).manual_seed(0)
    streams = {
        "": torch.stack([k7(seed) for seed in range(n_draws)]),
        "folded_": torch.stack([k7(fold_seed(ps, step)) for ps in phase_seeds
                                for step in range(MC_SEEDS)]),
        "planes_": torch.stack([mc.energy_mc_fwd(
            ws_all, bs_all, gamma,
            *mc.sample_decoder_indices(gen, T, B, M, MC_SAMPLES), "float32")
            for _ in range(n_draws)])}
    d1, d2 = mc.philox_draws(0, MC_SAMPLES, T, B, kmax)
    hist = torch.bincount(torch.cat([d1, d2]).flatten().long(),
                          minlength=M).double()
    chi2 = float(((hist - hist.mean()) ** 2 / hist.mean()).sum())
    stats_rec = {"phase": "mc_stats", "seeds": MC_SEEDS, "groups": MC_GROUPS,
                 "mc_samples": MC_SAMPLES,
                 "index_histogram": [int(v) for v in hist.tolist()],
                 "index_chi2": chi2}
    for pre, energies in streams.items():
        z, d = z_scores(energies)
        stats_rec.update({
            pre + "z_max_abs": float(z.abs().max()),
            pre + "z_mean": float(z.mean()), pre + "z_std": float(z.std()),
            pre + "z_std_first_group": float(z[0].std()),
            pre + "mean_rel_err_max": float(
                (d.mean((0, 1)) / e_exp - 1).abs().max()),
            pre + "draw_rel_std_median": float(
                (d.std(1) / e_exp).median())})
    emit(stats_rec)

    # 6. MC main path: draws made in the kernels ----------------------------
    def mc_run(energy, steps, final_mode, seed=0):
        """``optimize_spline_batch`` in an MC mode with the launch counts of
        that run alone."""
        mcfg = dataclasses.replace(
            cfg, steps=steps, final_energy_mode=final_mode, energy=energy)
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        res = optimize_spline_batch(
            params, art, cfg=mcfg, device=dev, log_every_chunk=False,
            generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return res, secs, dict(ef.LAUNCHES)

    mc_energy = dataclasses.replace(cfg.energy, mode="mc_fused",
                                    mc_samples=MC_SAMPLES,
                                    mc_inkernel_rng=True)
    mc_out, mc_s, mc_launches = mc_run(mc_energy, STEPS, "expected_fused")
    mc_len = np.asarray(mc_out.geodesic_length, np.float64)
    rel_mc = np.abs(mc_len / lengths - 1)
    mc_rec = {"phase": "mc_main", "mode": "mc_fused", "precision": "f32x2",
              "mc_inkernel_rng": True, "steps": STEPS, "optimize_s": mc_s,
              "steps_per_s": STEPS / mc_s, "launches": mc_launches,
              "lengths_finite": bool(np.isfinite(mc_len).all()),
              "vs_main_len_rel_median": float(np.median(rel_mc)),
              "vs_main_len_rel_p99": float(np.quantile(rel_mc, 0.99)),
              "vs_main_len_rel_max": float(rel_mc.max()),
              "vs_main_len_rel_argmax_pair": int(np.argmax(rel_mc)),
              "len_mean": float(mc_len.mean()),
              "len_mean_main": float(lengths.mean())}
    emit(mc_rec)
    # the same seed again; the final energies now come from the MC kernel
    # itself (K7, float32, one more draw), so they carry draw noise
    rep_out, rep_s, rep_launches = mc_run(mc_energy, STEPS, None)
    rep_len = np.asarray(rep_out.geodesic_length, np.float64)
    rep_rec = {"phase": "mc_repeat", "optimize_s": rep_s,
               "steps_per_s": STEPS / rep_s, "launches": rep_launches,
               "omega_bit_identical": bool(np.array_equal(
                   rep_out.omega_optimized, mc_out.omega_optimized)),
               "moved_from_init": bool(not np.array_equal(
                   mc_out.omega_optimized, art.omega_init)),
               "mc_len_vs_expected_len_rel_median": float(
                   np.median(np.abs(rep_len / mc_len - 1))),
               "mc_len_vs_expected_len_rel_max": float(
                   np.abs(rep_len / mc_len - 1).max())}
    emit(rep_rec)

    # 7. the draws shipped as index planes (K5/K6), and the unfused mode ----
    ext_out, ext_s, ext_launches = mc_run(
        dataclasses.replace(mc_energy, mc_inkernel_rng=False), MC_EXT_STEPS,
        None)
    ext_len = np.asarray(ext_out.geodesic_length, np.float64)
    plain_mc_out, plain_mc_s, plain_mc_launches = mc_run(
        dataclasses.replace(mc_energy, mode="mc"), MC_EXT_STEPS, None)
    ext_rec = {"phase": "mc_ext", "steps": MC_EXT_STEPS, "optimize_s": ext_s,
               "steps_per_s": MC_EXT_STEPS / ext_s, "launches": ext_launches,
               "lengths_finite": bool(np.isfinite(ext_len).all()),
               "plain_mc_optimize_s": plain_mc_s,
               "plain_mc_steps_per_s": MC_EXT_STEPS / plain_mc_s,
               "plain_mc_launches": plain_mc_launches,
               "vs_plain_mc_len_rel_median": float(np.median(np.abs(
                   ext_len / np.asarray(plain_mc_out.geodesic_length) - 1)))}
    emit(ext_rec)
    # the chunked unfused mode: no kernel at all, final energies its own.
    # Its first call in a process spends seconds on first-use set-up of the
    # chunk-sized library kernels, so two steps run before the timed ones.
    scan_energy = dataclasses.replace(mc_energy, mode="mc_scan")
    mc_run(scan_energy, 2, None)
    scan_out, scan_s, scan_launches = mc_run(scan_energy, MC_SCAN_STEPS, None)
    scan_len = np.asarray(scan_out.geodesic_length, np.float64)
    scan_rec = {"phase": "mc_scan", "steps": MC_SCAN_STEPS,
                "optimize_s": scan_s, "steps_per_s": MC_SCAN_STEPS / scan_s,
                "launches": scan_launches,
                "lengths_finite": bool(np.isfinite(scan_len).all()),
                "moved_from_init": bool(not np.array_equal(
                    scan_out.omega_optimized, art.omega_init)),
                "len_mean": float(scan_len.mean())}
    emit(scan_rec)
    # a cut turbo plan with its coarse phase at mc_fused_bf16, as the CLI's
    # --turbo --coarse-bf16 builds it; final energies by expected_fused
    coarse_plan = coarse_bf16_plan("mc_fused", MC_COARSE_PLAN)
    coarse_steps = sum(ph[0] for ph in coarse_plan)
    coarse_cfg = dataclasses.replace(
        cfg, phase_plan=coarse_plan, final_energy_mode="expected_fused",
        energy=mc_energy)
    torch.cuda.synchronize()
    ef.reset_launch_counts()
    t0 = time.perf_counter()
    coarse_out = optimize_spline_batch(
        params, art, cfg=coarse_cfg, device=dev, log_every_chunk=False,
        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    coarse_s = time.perf_counter() - t0
    coarse_launches = dict(ef.LAUNCHES)
    coarse_len = np.asarray(coarse_out.geodesic_length, np.float64)
    init_len = np.sqrt(e_exp.cpu().numpy()[:len(art)])
    coarse_rec = {"phase": "mc_coarse_bf16",
                  "plan": [list(ph) for ph in coarse_plan],
                  "optimize_s": coarse_s, "launches": coarse_launches,
                  "lengths_finite": bool(np.isfinite(coarse_len).all()),
                  "len_mean": float(coarse_len.mean()),
                  "len_mean_init": float(init_len.mean()),
                  "share_shorter_than_init": float(
                      (coarse_len < init_len).mean())}
    emit(coarse_rec)

    # 8. kernels line -------------------------------------------------------
    P = T * B
    in_bytes = 4 * (gamma.numel() + sum(w.numel() for w in ws_all)
                    + sum(b.numel() for b in bs_all) + M * B)
    k1_flops = P * M * decode_flops(D, H, X, 1)
    k2_flops = P * M * (decode_flops(D, H, X, 2) + 2 * H * X + 2 * H * H
                        + 2 * H * D)
    k1_bound = max(k1_flops / PEAK_FP32, (in_bytes + 4 * B) / PEAK_BYTES)
    k2_bound = max(k2_flops / PEAK_BF16,
                   (in_bytes + 4 * B + 4 * gamma.numel()) / PEAK_BYTES)
    # MC kernels: a point needs only the decoders drawn there (at most 2S
    # of M), counted from the planes this run timed; one decode each
    # (K5/K7), decode + chain as K2 (K6/K8).  Bytes: the inputs and the
    # output once, the index planes (K5/K6) or the counts (K7/K8) among
    # them; the backward's difference planes are an intermediate of this
    # implementation and are not counted.
    plane_bytes = 2 * MC_SAMPLES * (T - 1) * B * 4
    mc_in = in_bytes - 4 * M * B
    k2_per_decode = k2_flops / (P * M)
    n_pl = times["float32"]["mc_decodes_needed"]
    n_rng = times["float32"]["mc_rng_decodes_needed"]
    mc_bounds = {
        "k5": (n_pl * decode_flops(D, H, X, 1) / PEAK_FP32,
               (mc_in + plane_bytes + 4 * B) / PEAK_BYTES),
        "k7": (n_rng * decode_flops(D, H, X, 1) / PEAK_FP32,
               (mc_in + 4 * B + 4 * B) / PEAK_BYTES),
        "k6": (n_pl * k2_per_decode / PEAK_BF16,
               (mc_in + plane_bytes + 4 * B + 4 * gamma.numel())
               / PEAK_BYTES),
        "k8": (n_rng * k2_per_decode / PEAK_BF16,
               (mc_in + 8 * B + 4 * gamma.numel()) / PEAK_BYTES)}

    def mc_kernel(name, line, launches_, err_key, ms_key, prec, bound):
        return {"name": name, "route": "cuda",
                "source": "vae_latent_geometry_tpu_torch/ops/csrc/energy_mc.cu",
                "replaces":
                    f"vae_latent_geometry_tpu/ops/energy_mc_pallas.py:{line}",
                "launches": launches_,
                "max_abs_err": errors[(M, prec)][err_key],
                "ms": times[prec][ms_key + "_ms"],
                "plain_ms": times[prec][ms_key + "_plain_ms"],
                "bound_ms": 1e3 * max(bound),
                "bound_by": "operations" if bound[0] >= bound[1] else "bytes",
                "library_ms": None}

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
        mc_kernel("energy_mc_fwd (K5, float32 final evaluation, planes)", 473,
                  ext_launches["energy_mc_fwd"], "mc_energy_max_abs",
                  "mc_fwd", "float32", mc_bounds["k5"]),
        mc_kernel("energy_mc_bwd (K6, f32x2 trajectory steps, planes)", 548,
                  ext_launches["energy_mc_bwd"], "mc_dgamma_max_abs",
                  "mc_bwd", "f32x2", mc_bounds["k6"]),
        mc_kernel("energy_mc_fwd_rng (K7, float32 final evaluation, "
                  "in-kernel draws)", 166,
                  rep_launches["energy_mc_fwd_rng"], "mc_rng_energy_max_abs",
                  "mc_rng_fwd", "float32", mc_bounds["k7"]),
        mc_kernel("energy_mc_bwd_rng (K8, f32x2 trajectory steps, in-kernel "
                  "draws)", 235, mc_launches["energy_mc_bwd_rng"],
                  "mc_rng_dgamma_max_abs", "mc_rng_bwd", "f32x2",
                  mc_bounds["k8"]),
    ]

    # checks ----------------------------------------------------------------
    for (m, prec), r in errors.items():
        for pre, names in (("mc_", "K5/K6"), ("mc_rng_", "K7/K8")):
            e_tol = (E_RTOL if prec != "bfloat16" else
                     E_RTOL_BF16_M1 if m == 1 else E_RTOL_MC_BF16)
            if not r["mc_finite"] or not r["mc_draws_in_range"]:
                fail(f"MC kernels: non-finite output or draw out of range "
                     f"at M={m} {prec}")
            if r[pre + "energy_max_rel"] > e_tol:
                fail(f"{names} energy rel err "
                     f"{r[pre + 'energy_max_rel']:.3g} > {e_tol} at M={m} "
                     f"{prec}")
            if (r[pre + "dgamma_share_over_1e-3"] > DG_OVER_SHARE[prec]
                    or r[pre + "dgamma_rel_median"] > DG_MED
                    or r[pre + "dgamma_rel_p99"] > DG_P99):
                fail(f"{names} dgamma median/p99/share "
                     f"{r[pre + 'dgamma_rel_median']:.3g}/"
                     f"{r[pre + 'dgamma_rel_p99']:.3g}/"
                     f"{r[pre + 'dgamma_share_over_1e-3']:.3g} at M={m} "
                     f"{prec}")
        if not (r["k7_equals_k5_on_philox_planes"]
                and r["k8_equals_k6_on_philox_planes"]):
            fail(f"K7/K8 do not equal K5/K6 on the philox planes at M={m} "
                 f"{prec}")
        if "finite" not in r:        # the mixed-count case holds K5-K8 only
            continue
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

    for pre in ("", "folded_", "planes_"):
        z_max, z_mean, z_std = (stats_rec[pre + k] for k in
                                ("z_max_abs", "z_mean", "z_std"))
        if (z_max > MC_Z_MAX or abs(z_mean) > MC_Z_MEAN
                or not MC_Z_SPREAD[0] <= z_std <= MC_Z_SPREAD[1]):
            fail(f"mc_stats ({pre or 'raw_'}seeds): max |z| {z_max:.3g}, "
                 f"mean {z_mean:.3g}, spread {z_std:.3g}")
    if stats_rec["index_chi2"] > MC_CHI2_MAX:
        fail(f"mc_stats: index chi-square {stats_rec['index_chi2']:.3g}")
    want = {"mc_main": (mc_launches, {"energy_mc_bwd_rng": STEPS * n_chunks,
                                      "energy_fwd": n_chunks}),
            "mc_repeat": (rep_launches,
                          {"energy_mc_bwd_rng": STEPS * n_chunks,
                           "energy_mc_fwd_rng": n_chunks}),
            "mc_ext": (ext_launches,
                       {"energy_mc_bwd": MC_EXT_STEPS * n_chunks,
                        "energy_mc_fwd": n_chunks}),
            "plain mc": (plain_mc_launches, {}),
            "mc_scan": (scan_launches, {}),
            "mc_coarse_bf16": (coarse_launches,
                               {"energy_mc_bwd_rng": coarse_steps * n_chunks,
                                "energy_fwd": n_chunks})}
    for phase, (got, expected) in want.items():
        for name, count in got.items():
            if count != expected.get(name, 0):
                fail(f"{phase}: {name} launched {count} times, expected "
                     f"{expected.get(name, 0)}")
    if not (mc_rec["lengths_finite"] and ext_rec["lengths_finite"]
            and np.isfinite(rep_len).all() and rep_rec["moved_from_init"]
            and scan_rec["lengths_finite"] and scan_rec["moved_from_init"]
            and coarse_rec["lengths_finite"]):
        fail("MC path output malformed")
    if coarse_rec["len_mean"] >= coarse_rec["len_mean_init"]:
        fail(f"coarse-bf16 plan: mean length {coarse_rec['len_mean']:.6g} "
             f"not below the init curves' "
             f"{coarse_rec['len_mean_init']:.6g}")
    if not rep_rec["omega_bit_identical"]:
        fail("the same seed did not reproduce the MC-optimized curves bit "
             "for bit")
    if (mc_rec["vs_main_len_rel_median"] > MC_LEN_MED
            or mc_rec["vs_main_len_rel_max"] > MC_LEN_MAX):
        fail(f"MC-optimized lengths vs phase main: median "
             f"{mc_rec['vs_main_len_rel_median']:.3g}, max "
             f"{mc_rec['vs_main_len_rel_max']:.3g}")
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on its path")

    emit({"kernels": kernels})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
