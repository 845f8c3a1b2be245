#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits nonzero:

1. build   — compile the CUDA kernels from ``vae_latent_geometry_tpu_torch/
             ops/csrc`` with nvcc (sm_90a); card name, power limit, versions;
             the tensor-core instructions (HMMA) in K1's, K2's, K3/K4's,
             K5-K8's and K9/K10's SASS: present in the production shape's
             mma kernels at the reduced rungs, absent at float32 and in the
             generic decode's kernels; none, no stack and no spill in the
             float32 forward kernels on decode_f32.cuh (``k1_fwd_fma``,
             ``mc_fwd_fma``); no stack and no spill in the reduced-rung
             forward kernels on tiles_mma.cuh (``k1_tiles_mma``,
             ``mc_tiles_mma``).
2. kernels — at full width (seed-42 10-decoder EVAE, the 190 seed-42 init
             curves padded to B=200, T=2000, S=2 MC samples): each kernel
             against its plain PyTorch version on the same inputs, every
             precision rung, M=10 and M=1, and once with mixed per-spline
             decoder counts, and K5-K8 at S=12 (every rung); a
             second call of K1, K2 and K5-K8 bitwise equal to the first;
             CUDA-event times of kernel and plain version, K1 and K5/K7 at
             every rung (early stop's every step at the reduced rungs).
             The stats kernels (K3/K4) on local shards of 10, 5 and 1
             decoders with random smooth cotangents, every rung, each call
             repeated bitwise, and
             ``energy_expected_sharded`` on one shard of all ten against
             K1's energies and K2's gradient.
3. main    — ``optimize_spline_batch`` (expected_fused, f32x2, 1000 Adam
             steps at lr 1e-3 constant, T=2000) then ``distance_matrix``;
             launch counts of both kernels during that run; lengths against
             the JAX package run on the CPU with the same recipe
             (``tools/jax_reference_lengths.py``) and, loosely, against its
             committed TPU result on the same init blob; then the same run
             through the unfused plain-PyTorch ``expected`` mode (float32,
             200 steps) as the end-to-end yardstick; profile — device time
             by kernel (torch.profiler): the launches of K2, K6 and K8,
             and 50 steps of the main path, of the MC main path and of the
             decoder-sharded path with the device's busy share (and K3's
             and K4's ms per launch and share there).
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
             phase ``main``; mc_repeat — 200 steps twice with one seed and
             the final energies by the MC kernel itself: bit-identical
             curves.
7. mc_ext  — 200 steps with the draws shipped as index planes (K5/K6), and
             200 steps of the unfused plain-PyTorch ``mc`` mode as the
             end-to-end yardstick (``mc_main_over_mc_plain``); mc_scan — 20
             steps of the chunked unfused
             mode (no kernel) after a 2-step warm-up; mc_coarse_bf16 — a cut turbo plan with its
             coarse phase at ``mc_fused_bf16`` (the CLI's ``--coarse-bf16``).
8. init    — ``run_distance_pipeline`` from data to matrix on the seeded
             surrogate (23,822 x 50, 20 classes, 190 pairs, entropy init on
             a 200 x 200 grid, 200 ``expected_fused`` steps): representatives
             and pairs exactly, endpoints, validity and fitted omega against
             the JAX package run on the CPU (``tools/jax_reference_init.py``),
             the share of pairs whose Dijkstra path differs, stage timings.
9. ep      — the decoder-sharded path on a 1 x 1 mesh (``ep_axis`` set, all
             ten decoders local): 1000 steps through K3/K4, launch counts,
             lengths against the JAX package on the CPU under ``main``'s
             limits.
10. ep2    — two processes on the one card, mesh dp=1 x ep=2 over gloo (5
             decoders each), 50 float32 steps at full width, against one
             process's 50 ``expected_fused`` steps; both ranks' curves
             bit-identical.
11. jvp    — the seed-42 init blob through one-phase plans of
             ``jvp_ensemble`` at T=128 and ``expected_rescaled`` at T=64
             (200 steps, ``target_num_t`` 2000), final energies by K1 at
             float32 and T=2000: steps/s, launch counts, lengths against the
             JAX package on the CPU (``tools/jax_reference_jvp.py``).
12. cov    — ``cov_analysis`` on the seeded surrogate (5 classes, 10 pairs
             x decoder counts 1..10, 300 steps at T=2000, f32x3), the one
             committed model as two seeds: at ``mc_fused`` (steps/s, K8
             launches, the estimator's own CoV) and at ``expected_fused``
             (bit-identical seeds, CoV 0, lengths against
             ``tools/jax_reference_cov.py``).
13. single_bf16 — the seed-42 init blob through 200 steps of
             ``single_fused_bf16`` (decoder 0: K2 at M=1 and the bfloat16
             rung) and of ``single_fused`` at f32x2: steps/s, launches, the
             lengths' difference.
14. shapes — decoders of other depths and widths than the production
             model's (``SHAPES``, seeded: 2-16-10, 2-64-64-50, 2-256-128-128,
             2-96-160-48-100 and the width cap's edge 2-512-512-50), on the
             generic decode (``csrc/decode_any.cuh``): every kernel K1-K10
             (K9/K10 at the 3-layer shapes) at every rung against its plain
             version under its limits above, each call repeated bitwise, ms
             and bound at the kernel's summary rung; on S3 and S4 the
             kernels of their optimizer runs, at those runs' rungs and M, on
             the init curves at the production chunk (T=2000, B=200), with
             ms and bound; the fused modes at T=32, B=4 against the JAX
             package's kernels (``tools/jax_reference_shapes.py``); 100
             steps at the production chunk (f32x2) on S3 and S4 of
             ``expected_fused``, ``mc_fused``, ``single_fused`` and the
             decoder-sharded path, beside the unfused ``expected`` mode.
14c. training and the optimizer's checkpoints, on the seeded surrogate at
             full width:
             train — ``train_evae`` (ModelConfig defaults, batch 64):
             TRAIN_EPOCHS epochs against TRAIN_EPOCHS_CUT epochs resumed to
             TRAIN_EPOCHS, bit for bit; the loss falls; the first steps'
             losses against the port on the CPU with the same draws;
             steps/s, epochs/s, the device's busy share over PROFILE_STEPS
             steps (torch.profiler);
             train_multiseed — seeds 12 and 123 in one program against
             their serial runs; train_single — the legacy VAE with warm-up,
             step lr and best-val;
             train_cov — the two multiseed models written by the port's
             writer, reloaded, each through ``run_distance_pipeline`` (10
             classes, 45 pairs, expected_fused f32x2); the two matrices'
             cross-seed CoV and ``cov_analysis`` (counts 1..10): finite and
             not all zero;
             resume — the seed-42 init blob in chunks of 50, interrupted
             after two chunks: the resumed artifact equals the uninterrupted
             one bit for bit, a foreign stamp is ignored (every chunk
             recomputed), launches counted;
             early_stop — the production chunk at f32x2, budget 1000, at
             expected_fused (K1/K2 launches, one each per step; the
             restored omega re-evaluated at the trajectory rung equals the
             tracked best energy bit for bit) and at mc_fused with
             in-kernel draws (K7/K8 launches, one each per step; the same
             seed twice bit for bit; lengths within MC_LEN_MED / MC_LEN_MAX
             of phase main's): steps run, steps/s, lengths against phase
             main;
             backstop — the cut turbo plan against the fixed recipe at
             BACKSTOP_STEPS steps, at expected_fused and mc_fused: the merge
             never above either arm, each arm's wins.
14d. golden — CLI ``golden`` on the seeded reference-shaped tree of
             ``tools/golden_tree.py`` (133 classes, 23,822 latents, a legacy
             VAE at the reference's widths, a stand-in golden matrix) at the
             golden recipe: all 8,778 pairs,
             ``single_fused`` f32x3, 500 steps, T=2000, batch 500 (K2 at M=1
             every step, K1 once a chunk, exact counts); a second call
             resumes with no launch and the same matrix bit for bit; the
             first 200 pairs against the JAX package on the CPU
             (``tools/jax_reference_golden.py``: lengths under ``main``'s
             limits, pairs whose init path differs left out, at most 5%;
             ``matrix_stats`` within 1e-3); the cross-seed scale bar finite;
             stage seconds (``utils.Timer``), steps/s, K2's ms at M=1, f32x3,
             B=500, its dgamma held to the float64 function (K2_M1_FLOAT64);
             plot — CLI ``plot`` of every kind and ``eval --mode matrix`` on
             the main path's artifact: a PNG each where matplotlib is
             installed, else every kind refused by name and the heatmap
             warned about; ``pullback_metrics`` along a 300-point path and
             ``kde_density`` on a 200 x 200 grid on the card against the CPU
             (1e-5); ``trace_annotation``'s range in a profiler trace.
15. the ``kernels`` summary line (each kernel with its records on those
    shapes), the card line, and the result line.

At the reduced rungs every kernel of the production shape runs on the
tensor cores (``csrc/decode_mma.cuh``; K1/K9 and K5/K7 over the tiles of
``csrc/tiles_mma.cuh``): the kernels phase also holds K2 on random
decoders at X = 7 and 64 with a ragged tile, and every K2 call there is
repeated and must be bitwise equal.
The kernels phase also holds the four MC kernels (K5-K8) against their plain
versions, and K7/K8 against K5/K6 on the planes of ``philox_draws``; phase
``transposed`` holds K9/K10 (``ops/csrc/energy_transposed.cu``) against
their plain versions at every rung, M=10 and M=1, and against K1/K2 (K10,
an FMA kernel, against the tensor-core K2 at f32x3 and f32x2), runs
the JAX bench's numerics gate (smooth curves against a float64 host truth)
through the plain expected energy, K1 and K9, times K9+K10 against K1+K2,
and drives ``energy_expected_fused_t`` forward and backward with the launch
counts set to 0.

Imports nothing of JAX or of the JAX package.  Needs one CUDA GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
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
MC_SAMPLES_WIDE = 12      # K5-K8 in the kernels phase: two sweeps of draws
MC_SEEDS = 64
MC_GROUPS = 16
MC_Z_MAX = 5.0
MC_Z_MEAN = 0.1
MC_Z_SPREAD = (0.94, 1.10)
MC_CHI2_MAX = 27.9
MC_LEN_MED = 1e-2
MC_LEN_MAX = 1e-1
MC_EXT_STEPS = 200
MC_REPEAT_STEPS = 200
PLAIN_STEPS = 200
MC_SCAN_STEPS = 20
MC_COARSE_PLAN = ((100, 256, "cosine", 3e-3), (20, 2000, "constant", 1e-3))


# Stats kernels (K3/K4) vs their plain versions.  x0 and yb: max error
# relative to the decoder outputs' scale max|x0| (yb is a deviation of a few
# units that carries the rounding of outputs of ~60, so its own max is no
# yardstick); sq: relative to its own max.  Measured on the card at M_loc =
# 10: 5e-7 / 1.2e-6 at float32, 9e-6 / 2.8e-5 at f32x3 and f32x2 (a one-ulp
# fp32 difference flips the bf16 rounding of a lo part), 2.0e-3 / 4.5e-3 at
# bfloat16 (~2e-3 input rounding on every decoded output, and sq doubles a
# deviation's relative error); the limits leave a factor of five or more
# for the smaller shards.  dgamma is judged as K2's.  The sharded energy on one
# shard of all ten decoders is another decomposition of K1's sum: rtol 1e-5.
STATS_X_RTOL = {"float32": 3e-6, "f32x3": 5e-5, "f32x2": 5e-5,
                "bfloat16": 1e-2}
STATS_SQ_RTOL = {"float32": 2e-5, "f32x3": 5e-4, "f32x2": 5e-4,
                 "bfloat16": 5e-2}
# Init stages vs the JAX package on the CPU (tools/jax_reference_init.py).
# Endpoints are grid nodes: the grids differ by float32 rounding of the
# encoder (a few 1e-7), another node would be a grid spacing (~3e-2) off.
# omega solves 5 x 5 float32 normal equations of condition ~5e2: each
# package lies ~2e-4 from the float64 solution on paths they share.  Entropy
# edge weights differ in their last bits, so a near-tie may break the other
# way: at most INIT_PATH_SHARE of the paths may differ, and those pairs are
# held only to valid curves.  Init-curve lengths (float32 expected energy,
# T=2000) on shared paths: rtol 1e-4.
INIT_LABELS = 20
INIT_STEPS = 200
INIT_AB_ATOL = 1e-4
INIT_OMEGA_ATOL = 5e-4
INIT_PATH_SHARE = 0.05
INIT_LEN_RTOL = 1e-4
JAX_INIT = os.path.join(ROOT, "tools", "jax_reference_init_seed42")
# Two ranks against one process.  Energies at the JAX suite's tolerance for
# its mesh against its single device (tests/test_sharding.py:155-159).  That
# suite's omega tolerance (rtol 1e-3, atol 1e-5) holds for its 25 steps on
# narrow decoders, not here: Adam's normalised update moves an element by
# ~lr per step whatever its gradient's size, so where a gradient element is
# near zero a rounding-level difference between the two summation orders
# shows as a different step.  After 50 steps at lr 1e-3 (a curve moves at
# most 5e-2) omega differed by at most 3.1e-4 on the card while the energies
# agreed to 2.8e-6; the limit is 2e-3, and the share of elements inside the
# suite's tolerance is printed.
EP2_STEPS = 50
EP2_E_RTOL = 1e-4
EP2_OMEGA_RTOL, EP2_OMEGA_ATOL = 1e-3, 1e-5
EP2_OMEGA_MAX = 2e-3
EP2_JOIN_S = 420.0
# Transposed kernels (K9/K10) against their plain versions: the limits of
# K1/K2 (E_RTOL, E_RTOL_BF16_M1, DG_*).  Against K1/K2 on the same inputs
# (the same function in another layout): energies within E_RTOL at float32
# and f32x2, dgamma under K2's own median / p99 limits.  The numerics gate
# of the JAX package's bench (bench.py:104-168): median relative error of
# the energy on smooth curves (seed 7, T=2000, B=16) against a float64 host
# truth, each path <= 1e-3 (bench.py:519-520); a NaN fails.
GATE_SEED, GATE_T, GATE_B, GATE_MEDREL = 7, 2000, 16, 1e-3
# JVP modes: the seed-42 init blob through one-phase plans, final energies
# by K1 at float32 and T=2000; lengths against the JAX package on the CPU
# (tools/jax_reference_jvp.py) under main's limits.
JAX_JVP = os.path.join(ROOT, "tools", "jax_reference_jvp_seed42.json")
# CoV analysis on the seeded surrogate: 5 classes (10 pairs) x counts 1..10
# = 100 splines, 300 steps at T=2000 and f32x3; at mc_fused (the recipe of
# experiment/cov_blob_anchor.json) and at expected_fused, the latter's
# lengths against the JAX package on the CPU (tools/jax_reference_cov.py)
# under main's limits.  Both "seeds" are the one committed model.
JAX_COV = os.path.join(ROOT, "tools", "jax_reference_cov_seed42.json")
COV_LABELS = 5
# The single-decoder bfloat16 mode: the seed-42 init blob through
# SINGLE_STEPS steps of single_fused_bf16 (K2 at M=1 and the bfloat16 rung)
# and of single_fused at f32x2, same recipe; the lengths' difference is
# reported, not limited (no reading before this phase's first run).
SINGLE_STEPS = 200
# K2 on small random decoders at the output widths the tensor-core kernel
# pads (layer 3's N to 8, the chain's K to 16), T*B not a multiple of the
# 128-point tile: under K2's own dgamma limits.
K2_SMALL = {"T": 67, "B": 13, "D": 2, "M": 3, "X": (7, 64)}
# torch.profiler window: K2 at f32x2 split by launch, and this many steps of
# the main path (the first chunk, final K1 evaluation included) for the
# device's busy share.
PROFILE_K2_CALLS = 3
PROFILE_STEPS = 50
# Phase shapes: decoders of other depths and widths than the production
# model's, seeded (a copy of tools/jax_reference_shapes.py's seed code; the
# CPU tests check that the copies agree): every kernel against its plain
# version at every rung at SHAPES_T x SHAPES_B (seeded random points) under
# its own limits above, each call repeated bitwise; on the optimized shapes
# (SHAPES_OPT) the same at the production chunk on the init curves, for the
# kernels, rungs and M of their optimizer runs; the fused modes at T = 32,
# B = 4 against the JAX package (tools/jax_reference_shapes_seed42.json)
# under the CPU tests' limits (tests/test_torch_shapes.py); SHAPES_STEPS
# optimizer steps of the fused modes at the production chunk on S3 and S4
# beside the unfused mode.
SHAPES = {"S1": ((2, 16, 10), 3),
          "S2": ((2, 64, 64, 50), 10),
          "S3": ((2, 256, 128, 128), 10),
          "S4": ((2, 96, 160, 48, 100), 10),
          "S5": ((2, 512, 512, 50), 4)}
SHAPES_T, SHAPES_B = 400, 100
SHAPES_STEPS = 100
SHAPES_OPT = ("S3", "S4")
# (kernel, rung, M = all decoders or 1) that the optimizer runs of SHAPES_OPT
# launch: K2 every step and K1 at the end of expected_fused (M) and
# single_fused (1), K8 / K7 of mc_fused, K3 / K4 of the sharded path (K3
# also for its float32 final energies).
SHAPES_OPT_CALLS = (("K1", "float32", "M"), ("K2", "f32x2", "M"),
                    ("K1", "float32", 1), ("K2", "f32x2", 1),
                    ("K3", "f32x2", "M"), ("K3", "float32", "M"),
                    ("K4", "f32x2", "M"), ("K7", "float32", "M"),
                    ("K8", "f32x2", "M"))
# K2 at M=1 (single_fused) at a reduced rung on the smooth production-chunk
# curves: dgamma is a second difference of the decode, and the rung keeps 16
# bits of each activation, so a 1-ulp difference upstream (another
# summation order) flips the low half's rounding; the kernel and its plain
# version then differ by more than K2's limits while each is as far from
# the function as the other (S4, f32x2, H100: 1.7e-3 apart at p99, each
# 7.9e-3 from the float64 function; tools/k2_rounding.py).  There the
# kernel is held to the float64 function: each dgamma statistic within this
# factor of the plain version's (the kernel's read within 0.5% of it at S3,
# S4 and the production shape).
K2_M1_FLOAT64 = 1.1
JAX_SHAPES = os.path.join(ROOT, "tools", "jax_reference_shapes_seed42.json")


def shape_layers(name, seed=42):
    """[(w (M, in, out), b (M, out)), ...] float32 of decoder ``name``: He
    scaled, each member its base plus 0.3 of its scale in noise."""
    dims, M = SHAPES[name]
    rng = np.random.default_rng([seed, int(name[1:])])
    out = []
    for i, o in zip(dims[:-1], dims[1:]):
        scale = np.sqrt(2.0 / i)
        w = scale * (rng.normal(size=(1, i, o))
                     + 0.3 * rng.normal(size=(M, i, o)))
        b = 0.1 * rng.normal(size=(1, o)) + 0.05 * rng.normal(size=(M, o))
        out.append((w.astype(np.float32), b.astype(np.float32)))
    return out


def shape_curves(T, B, seed=42, D=2):
    """(T, B, D) float32 smooth curves between random endpoints."""
    rng = np.random.default_rng([seed, T, B])
    t = np.linspace(0.0, 1.0, T)[:, None, None]
    a, b = 1.5 * rng.normal(size=(2, 1, B, D))
    ph = rng.uniform(0, 2 * np.pi, size=(1, B, D))
    return ((1 - t) * a + t * b + 0.3 * np.sin(3.0 * t + ph)).astype(
        np.float32)


def cotangent(B):
    return np.linspace(0.5, 2.0, B).astype(np.float32)


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


def sass_hmma(lib_path, prefix):
    """Tensor-core instructions (HMMA) in the SASS of each kernel template
    ``<prefix>...<R>`` of the built library, by ``cuobjdump -sass``:
    {"k2_onepass_mma<R>": n, ...}, R the rung (0 float32, 1 f32x3, 2 f32x2,
    3 bfloat16).  cuobjdump ships with every CUDA toolkit that nvcc comes
    from: without it, or when it cannot read the library, the run fails."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        fail("cuobjdump not found: the kernels' SASS cannot be checked for "
             "HMMA")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        # the kernel's name follows its length's digits (the anonymous
        # namespace's name before it holds the source's, e.g. "energy_mc")
        m = re.search(rf"Function : \S*?\d({prefix}[A-Za-z_]+?)ILi(\d)E",
                      line)
        if m:
            fn = f"{m.group(1)}<{m.group(2)}>"
            counts[fn] = 0
        elif "Function :" in line:
            fn = None
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


def check_hmma(hmma, mma_kernels, fma_kernels, any_kernels):
    """The reduced rungs (1-3) of the production shape's ``mma_kernels``
    run on the tensor cores; their float32 rung runs ``fma_kernels``, with
    no HMMA (TF32 is barred); the generic decode's ``any_kernels`` have none
    at any rung.  Fails on a kernel missing from the SASS."""
    for rung in (0, 1, 2, 3):
        for name in (mma_kernels if rung else fma_kernels):
            key = f"{name}<{rung}>"
            if key not in hmma or (hmma[key] > 0) != (rung > 0):
                fail(f"SASS of {key}: {hmma.get(key)} HMMA instructions")
        for name in any_kernels:
            if hmma.get(f"{name}<{rung}>") != 0:
                fail(f"SASS of {name}<{rung}>: "
                     f"{hmma.get(f'{name}<{rung}>')} HMMA instructions")


# the float32 forward-energy kernels on decode_f32.cuh: (source, kernel)
FWD_FMA = (("energy_expected", "k1_fwd_fma"), ("energy_mc", "mc_fwd_fma"))
# the reduced-rung forward-energy kernels on tiles_mma.cuh: (source, kernel)
FWD_MMA = (("energy_expected", "k1_tiles_mma"), ("energy_mc", "mc_tiles_mma"))
# K9's and K10's tensor-core kernels (energy_transposed.cu; K9's is K1's)
T_MMA = ("k1_tiles_mma", "k10_mma")


def ptxas_of(log, kernel):
    """Registers, stack and spill bytes that ``nvcc -Xptxas -v`` reported
    for the instantiation of ``kernel`` in a build log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line.strip())
        if m:
            fn = m.group(1)
            continue
        if fn is None or f"{len(kernel)}{kernel}I" not in fn:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out["stack_bytes"] = int(m.group(1))
            out["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
    return out


def decode_flops(D, H, X, passes):
    """FLOP of one decoder on one point, tail layers at ``passes``."""
    return 2 * D * H + passes * (2 * H * H + 2 * H * X)


def smooth_cotangents(T, B, X, dev, seed):
    """Random smooth (dx0, dyb, dsq): low-order Fourier series in t with
    random coefficients per spline and feature."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.linspace(0.0, 1.0, T, device=dev)[:, None, None]

    def series(width):
        out = torch.zeros((T, B, width), device=dev)
        for k in range(4):
            c = torch.randn((2, 1, B, width), generator=gen, device=dev)
            out = out + c[0] * torch.cos(k * np.pi * t) \
                + c[1] * torch.sin((k + 1) * np.pi * t)
        return out.contiguous()

    return series(X), series(X), series(1)[..., 0].contiguous()


def stats_phase(ef, ws_all, bs_all, gamma, dev):
    """K3/K4 against their plain versions on local shards, every call
    repeated bitwise; returns (records by (M_loc, rung), times: the kernels'
    ms at every rung, the plain versions' at float32 and f32x2)."""
    import torch

    T, B, _ = gamma.shape
    M, X = ws_all[0].shape[0], ws_all[2].shape[2]
    dx0, dyb, dsq = smooth_cotangents(T, B, X, dev, seed=11)
    num_active = torch.as_tensor(
        np.random.default_rng(3).integers(1, M + 1, size=B), device=dev)
    cases = [(M, 0, None), (M // 2, 1, None), (1, 3, None),
             (M // 2, 1, num_active)]
    recs, times = {}, {}
    for m_loc, shard, na in cases:
        lo = shard * m_loc
        ws = [w[lo:lo + m_loc].contiguous() for w in ws_all]
        bs = [b[lo:lo + m_loc].contiguous() for b in bs_all]
        wmb = (ef.uniform_weights_local(M, m_loc, B, dev) if na is None
               else ef.active_weights_local(na, M, m_loc, B, shard,
                                            dev)).contiguous()
        for prec in (ef.PRECISIONS if na is None else ("f32x2",)):
            out = ef.stats_fwd(ws, bs, gamma, wmb, prec)
            ref = ef.stats_fwd_plain(ws, bs, gamma, wmb, prec)
            g_k = ef.stats_bwd(ws, bs, gamma, wmb, dx0, dyb, dsq, prec)
            g_p = ef.stats_bwd_plain(ws, bs, gamma, wmb, dx0, dyb, dsq, prec)
            again = (ef.stats_fwd(ws, bs, gamma, wmb, prec),
                     ef.stats_bwd(ws, bs, gamma, wmb, dx0, dyb, dsq, prec))
            torch.cuda.synchronize()
            rec = {"phase": "kernels", "kernel": "stats", "M_loc": m_loc,
                   "shard": shard, "precision": prec,
                   "weights": "uniform" if na is None else "active, mixed",
                   **dgamma_stats(g_k, g_p, "stats_"),
                   "stats_finite": bool(
                       all(torch.isfinite(o).all() for o in out)
                       and torch.isfinite(g_k).all()),
                   "repeat_bitwise": bool(
                       all(torch.equal(a, b) for a, b in zip(out, again[0]))
                       and torch.equal(g_k, again[1]))}
            x_scale = float(ref[0].abs().max())
            for name, o, r in zip(("x0", "yb", "sq"), out, ref):
                scale = max(float(r.abs().max()), 1e-30) if name == "sq" \
                    else x_scale
                rec[f"{name}_max_abs"] = float((o - r).abs().max())
                rec[f"{name}_max_rel"] = rec[f"{name}_max_abs"] / scale
            if m_loc == 1 and (float(out[1].abs().max()) != 0.0
                               or float(out[2].abs().max()) != 0.0):
                fail("K3 on a one-decoder shard wrote nonzero moments")
            if na is None and m_loc > 1:
                rec["stats_fwd_ms"] = time_ms(
                    lambda: ef.stats_fwd(ws, bs, gamma, wmb, prec), 5)
                rec["stats_bwd_ms"] = time_ms(
                    lambda: ef.stats_bwd(ws, bs, gamma, wmb, dx0, dyb, dsq,
                                         prec), 5)
                if prec in ("float32", "f32x2"):
                    rec["stats_fwd_plain_ms"] = time_ms(
                        lambda: ef.stats_fwd_plain(ws, bs, gamma, wmb, prec),
                        3)
                    rec["stats_bwd_plain_ms"] = time_ms(
                        lambda: ef.stats_bwd_plain(ws, bs, gamma, wmb, dx0,
                                                   dyb, dsq, prec), 3)
                times[(m_loc, prec)] = rec
            emit(rec)
            key = (m_loc, prec, "uniform" if na is None else "mixed")
            recs[key] = rec
            if not rec["stats_finite"]:
                fail(f"K3/K4 non-finite output at {key}")
            if not rec["repeat_bitwise"]:
                fail(f"K3/K4: a second call differs from the first at {key}")
            for name in ("x0", "yb", "sq"):
                tol = (STATS_SQ_RTOL if name == "sq" else STATS_X_RTOL)[prec]
                if rec[f"{name}_max_rel"] > tol:
                    fail(f"K3 {name} rel err {rec[f'{name}_max_rel']:.3g} > "
                         f"{tol} at {key}")
            if (rec["stats_dgamma_share_over_1e-3"] > DG_OVER_SHARE[prec]
                    or rec["stats_dgamma_rel_median"] > DG_MED
                    or rec["stats_dgamma_rel_p99"] > DG_P99):
                fail(f"K4 dgamma median/p99/share "
                     f"{rec['stats_dgamma_rel_median']:.3g}/"
                     f"{rec['stats_dgamma_rel_p99']:.3g}/"
                     f"{rec['stats_dgamma_share_over_1e-3']:.3g} at {key}")
    return recs, times


def sharded_vs_fused(ef, decoders, gamma, dev):
    """``energy_expected_sharded`` on one shard of all decoders against K1's
    energies and K2's gradient, float32 and f32x2."""
    import torch

    B = gamma.shape[1]
    M = decoders["layers"][0]["w"].shape[0]
    ct = torch.linspace(0.5, 2.0, B, device=dev)
    for prec in ("float32", "f32x2"):
        g1 = gamma.clone().requires_grad_(True)
        e_sh = ef.energy_expected_sharded(
            decoders, g1, ef.uniform_weights_local(M, M, B, dev), None, prec)
        (d_sh,) = torch.autograd.grad((ct * e_sh).sum(), g1)
        g2 = gamma.clone().requires_grad_(True)
        e_fu = ef.energy_expected_fused(decoders, g2, None, prec)
        (d_fu,) = torch.autograd.grad((ct * e_fu).sum(), g2)
        torch.cuda.synchronize()
        rec = {"phase": "kernels", "kernel": "sharded_vs_fused",
               "precision": prec,
               "energy_max_rel": float(((e_sh - e_fu).abs()
                                        / e_fu.abs()).max().detach()),
               **dgamma_stats(d_sh, d_fu)}
        emit(rec)
        if rec["energy_max_rel"] > E_RTOL:
            fail(f"sharded energy on one shard vs K1: rel err "
                 f"{rec['energy_max_rel']:.3g} at {prec}")
        if (rec["dgamma_rel_median"] > DG_MED or rec["dgamma_rel_p99"] > DG_P99
                or rec["dgamma_share_over_1e-3"] > DG_OVER_SHARE[prec]):
            fail(f"sharded gradient vs K2: median/p99 "
                 f"{rec['dgamma_rel_median']:.3g}/{rec['dgamma_rel_p99']:.3g} "
                 f"at {prec}")


def port_init_paths(latents, pairs, decoders, init_cfg):
    """The Dijkstra paths of the port's init stage, by the calls
    ``initialize_splines`` makes (entropy-weighted with ``decoders``,
    Euclidean without): (padded node lists, lengths)."""
    from vae_latent_geometry_tpu_torch.graph.grid import (
        create_latent_grid, entropy_weights, grid_knn_graph,
        reweight_graph_by_entropy)
    from vae_latent_geometry_tpu_torch.graph.shortest_path import (
        dijkstra_multi, extract_paths)
    from vae_latent_geometry_tpu_torch.pipeline.init_splines import (
        _nearest_grid_nodes)

    grid, shape = create_latent_grid(latents, init_cfg.grid_points_per_axis,
                                     init_cfg.grid_margin)
    graph = grid_knn_graph(grid, shape, k=init_cfg.knn)
    if decoders is not None:    # entropy init; the Euclidean graph else
        graph = reweight_graph_by_entropy(graph,
                                          entropy_weights(decoders, grid))
    p = np.asarray(pairs, np.int64)
    start = _nearest_grid_nodes(grid, shape, latents[p[:, 0]])
    end = _nearest_grid_nodes(grid, shape, latents[p[:, 1]])
    uniq, rows = np.unique(start, return_inverse=True)
    _, pred = dijkstra_multi(graph, uniq)
    return extract_paths(pred, rows.astype(np.int32), uniq.astype(np.int32),
                         end, max_len=init_cfg.max_path_len)


def init_phase(params, cfg, dev, ef):
    """Data to matrix through ``run_distance_pipeline`` on the seeded
    surrogate, against the JAX package's init stage on the CPU."""
    import torch

    from vae_latent_geometry_tpu_torch.config import InitConfig
    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
    from vae_latent_geometry_tpu_torch.geometry.spline import (
        design_matrix, eval_spline_design, t_grid)
    from vae_latent_geometry_tpu_torch.models.evae import encode
    from vae_latent_geometry_tpu_torch.pipeline.full_run import (
        run_distance_pipeline)

    data = load_tasic()
    if not data.synthetic:
        fail("init phase: a data directory was found; the reference is "
             "defined on the seeded surrogate")
    ref = np.load(JAX_INIT + ".npz")
    with open(JAX_INIT + ".json") as f:
        ref_meta = json.load(f)
    init_cfg = InitConfig(use_entropy=True)
    geo_cfg = dataclasses.replace(cfg, steps=INIT_STEPS)
    torch.cuda.synchronize()
    ef.reset_launch_counts()
    res = run_distance_pipeline(
        params, data.x, data.labels, max_labels=INIT_LABELS,
        init_cfg=init_cfg, geo_cfg=geo_cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    launches = dict(ef.LAUNCHES)
    art, mat = res.artifact, res.matrix

    with torch.no_grad():
        latents = encode(params, torch.as_tensor(
            data.x, device=dev))[0].cpu().numpy()
    paths, path_len = port_init_paths(latents, art.pair_indices,
                                      params.decoders, init_cfg)
    L = ref["paths"].shape[1]
    same_path = (path_len == ref["path_len"]) & np.all(
        paths[:, :L] == ref["paths"], axis=1)
    d_omega = np.abs(art.omega_init - ref["omega_init"]).max(axis=(1, 2))
    # float32 expected-energy lengths of the init curves (K1), all pairs
    B = cfg.batch_size
    idx = np.concatenate([np.arange(len(art)),
                          np.full(B - len(art), len(art) - 1)])
    t = t_grid(cfg.energy.num_t, dev)
    gamma = eval_spline_design(
        torch.as_tensor(art.omega_init[idx], device=dev),
        torch.as_tensor(art.a[idx], device=dev),
        torch.as_tensor(art.b[idx], device=dev),
        design_matrix(t, art.basis, art.n_poly), t).contiguous()
    init_len = torch.sqrt(ef.energy_expected_fused(
        params.decoders, gamma)).double().cpu().numpy()[:len(art)]
    rel_len = np.abs(init_len / ref["init_lengths"] - 1)
    opt_len = np.asarray(art.geodesic_length, np.float64)
    rec = {"phase": "init", "rows": int(len(data.x)), "pairs": len(art),
           "graph_backend": res.graph_backend,
           "jax_graph_backend": ref_meta["graph_backend"],
           "timings_s": res.timings, "launches": launches,
           "representatives_equal": bool(
               art.representatives == ref_meta["representatives"]),
           "pairs_equal": bool(np.array_equal(art.pair_indices,
                                              ref["pair_indices"])),
           "valid_equal": bool(np.array_equal(art.valid, ref["valid"])),
           "n_valid": int(art.valid.sum()),
           "a_max_abs": float(np.abs(art.a - ref["a"]).max()),
           "b_max_abs": float(np.abs(art.b - ref["b"]).max()),
           "paths_differ_share": float(1.0 - same_path.mean()),
           "paths_differ_pairs": np.nonzero(~same_path)[0].tolist(),
           "omega_max_abs_same_path": float(d_omega[same_path].max()),
           "omega_max_abs_all": float(d_omega.max()),
           "init_len_rel_max_same_path": float(rel_len[same_path].max()),
           "init_len_rel_max_all": float(rel_len.max()),
           "matrix_shape": list(mat.shape),
           "matrix_finite": bool(np.isfinite(mat).all()),
           "matrix_symmetric": bool(np.array_equal(mat, mat.T)),
           "len_mean_init": float(init_len.mean()),
           "len_mean_optimized": float(opt_len.mean()),
           "steps": INIT_STEPS,
           "steps_per_s": INIT_STEPS / res.timings["optimize"]}
    emit(rec)
    if not (rec["representatives_equal"] and rec["pairs_equal"]):
        fail("init: representatives or pairs differ from the JAX package's")
    if not rec["valid_equal"]:
        fail("init: validity mask differs from the JAX package's")
    if max(rec["a_max_abs"], rec["b_max_abs"]) > INIT_AB_ATOL:
        fail(f"init: endpoints off by {rec['a_max_abs']:.3g} / "
             f"{rec['b_max_abs']:.3g}")
    if rec["paths_differ_share"] > INIT_PATH_SHARE:
        fail(f"init: {rec['paths_differ_share']:.3g} of the Dijkstra paths "
             "differ")
    if rec["omega_max_abs_same_path"] > INIT_OMEGA_ATOL:
        fail(f"init: omega off by {rec['omega_max_abs_same_path']:.3g} on "
             "shared paths")
    if rec["init_len_rel_max_same_path"] > INIT_LEN_RTOL:
        fail(f"init: init-curve lengths off by "
             f"{rec['init_len_rel_max_same_path']:.3g} on shared paths")
    if not (mat.shape == (INIT_LABELS, INIT_LABELS) and rec["matrix_finite"]
            and rec["matrix_symmetric"] and np.isfinite(opt_len).all()
            and np.isfinite(art.omega_init).all()):
        fail("init: pipeline output malformed")
    if rec["len_mean_optimized"] >= rec["len_mean_init"]:
        fail("init: optimization did not shorten the init curves")
    want = {"energy_bwd": INIT_STEPS, "energy_fwd": 1}
    for name, count in launches.items():
        if count != want.get(name, 0):
            fail(f"init: {name} launched {count} times, expected "
                 f"{want.get(name, 0)}")
    return rec


def ep_phase(params, art, cfg, dev, ef, cpu_ref):
    """The decoder-sharded path with all ten decoders local (1 x 1 mesh):
    K3 forward and K4 backward every step."""
    import torch

    from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import distance_matrix
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    ep_cfg = dataclasses.replace(cfg, energy=dataclasses.replace(
        cfg.energy, ep_axis="ep"))
    torch.cuda.synchronize()
    ef.reset_launch_counts()
    t0 = time.perf_counter()
    out = optimize_spline_batch(params, art, cfg=ep_cfg, device=dev,
                                log_every_chunk=False, mesh=make_mesh(1, 1))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ef.LAUNCHES)
    mat, labels = distance_matrix(out)
    lengths = np.asarray(out.geodesic_length, np.float64)
    sel = np.asarray(cpu_ref["pairs"])
    rel = np.abs(lengths[sel] / np.asarray(cpu_ref["lengths"]) - 1)
    rec = {"phase": "ep", "mesh": {"dp": 1, "ep": 1}, "M_loc": 10,
           "steps": cfg.steps, "optimize_s": secs,
           "steps_per_s": cfg.steps / secs, "launches": launches,
           "lengths_finite": bool(np.isfinite(lengths).all()),
           "matrix_shape": list(mat.shape),
           "len_rel_median": float(np.median(rel)),
           "len_rel_p99": float(np.quantile(rel, 0.99)),
           "len_rel_max": float(rel.max()),
           "len_rel_argmax_pair": int(sel[np.argmax(rel)]),
           "len_mean": float(lengths.mean())}
    emit(rec)
    n_chunks = -(-len(art) // cfg.batch_size)
    want = {"stats_fwd": (cfg.steps + 1) * n_chunks,
            "stats_bwd": cfg.steps * n_chunks}
    for name, count in launches.items():
        if count != want.get(name, 0):
            fail(f"ep: {name} launched {count} times, expected "
                 f"{want.get(name, 0)}")
    if not (rec["lengths_finite"] and mat.shape == (len(labels), len(labels))
            and np.isfinite(mat).all()):
        fail("ep path output malformed")
    if rec["len_rel_median"] > LEN_MED or rec["len_rel_max"] > LEN_MAX:
        fail(f"ep lengths vs the JAX package on the CPU: median "
             f"{rec['len_rel_median']:.3g}, max {rec['len_rel_max']:.3g}")
    return rec, lengths


def _ep2_rank(rank, world, store, out_dir, device, num_t):
    """One rank of phase ep2 (its own process): mesh dp=1 x ep=world over
    gloo on the one card, the chunk through ``optimize_spline_batch``."""
    import torch

    sys.path.insert(0, ROOT)
    from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh
    from vae_latent_geometry_tpu_torch.parallel.multihost import (
        init_multihost, shutdown_multihost)
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    init_multihost(f"file://{store}", world, rank, backend="gloo")
    try:
        dev = torch.device(device)
        mesh = make_mesh(1, world)
        cfg = GeodesicConfig(
            steps=EP2_STEPS, lr=1e-3, lr_schedule="constant", batch_size=200,
            energy=EnergyConfig(num_t=num_t, mode="expected_fused",
                                kernel_precision="float32"))
        t0 = time.perf_counter()
        out = optimize_spline_batch(load_npz(MODEL, dev),
                                    load_spline_batch(INIT), cfg=cfg,
                                    device=dev, log_every_chunk=False,
                                    mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        np.savez(os.path.join(out_dir, f"ep2_rank{rank}.npz"),
                 omega=out.omega_optimized, lengths=out.geodesic_length,
                 seconds=time.perf_counter() - t0,
                 stats_fwd=ef.LAUNCHES["stats_fwd"],
                 stats_bwd=ef.LAUNCHES["stats_bwd"],
                 other=sum(v for k, v in ef.LAUNCHES.items()
                           if not k.startswith("stats")))
    finally:
        shutdown_multihost()


def ep2_phase(params, art, cfg, dev):
    """Two ranks on the one card (gloo; NCCL takes one rank per device), 5
    decoders each, against one process on all ten."""
    import torch
    import torch.multiprocessing as mp

    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    one_cfg = dataclasses.replace(cfg, steps=EP2_STEPS, energy=dataclasses.replace(
        cfg.energy, kernel_precision="float32"))
    one = optimize_spline_batch(params, art, cfg=one_cfg, device=dev,
                                log_every_chunk=False)
    torch.cuda.synchronize()
    store = os.path.join(OUT_DIR, f"ep2_store_{os.getpid()}")
    for name in [store] + [os.path.join(OUT_DIR, f"ep2_rank{r}.npz")
                           for r in range(2)]:
        if os.path.exists(name):
            os.remove(name)
    t0 = time.perf_counter()
    ctx = mp.spawn(_ep2_rank,
                   args=(2, store, OUT_DIR, str(dev), cfg.energy.num_t),
                   nprocs=2, join=False)
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > EP2_JOIN_S:
                fail(f"ep2: the two ranks did not finish in {EP2_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
        if os.path.exists(store):
            os.remove(store)
    wall = time.perf_counter() - t0
    ranks = [np.load(os.path.join(OUT_DIR, f"ep2_rank{r}.npz"))
             for r in range(2)]
    e_one = np.asarray(one.geodesic_length, np.float64) ** 2
    e_two = np.asarray(ranks[0]["lengths"], np.float64) ** 2
    d_omega = np.abs(ranks[0]["omega"] - one.omega_optimized)
    rec = {"phase": "ep2", "mesh": {"dp": 1, "ep": 2}, "backend": "gloo",
           "M_loc": 5, "steps": EP2_STEPS, "precision": "float32",
           "wall_s": wall,
           "rank_optimize_s": [float(r["seconds"]) for r in ranks],
           "rank_steps_per_s": [EP2_STEPS / float(r["seconds"])
                                for r in ranks],
           "launches": [{"stats_fwd": int(r["stats_fwd"]),
                         "stats_bwd": int(r["stats_bwd"]),
                         "other": int(r["other"])} for r in ranks],
           "ranks_bit_identical": bool(
               np.array_equal(ranks[0]["omega"], ranks[1]["omega"])
               and np.array_equal(ranks[0]["lengths"], ranks[1]["lengths"])),
           "energy_rel_max": float(np.abs(e_two / e_one - 1).max()),
           "omega_max_abs": float(d_omega.max()),
           "omega_share_within_rtol_atol": float(np.mean(
               d_omega <= EP2_OMEGA_ATOL
               + EP2_OMEGA_RTOL * np.abs(one.omega_optimized))),
           "moved_from_init": bool(not np.array_equal(ranks[0]["omega"],
                                                      art.omega_init))}
    emit(rec)
    n_chunks = -(-len(art) // cfg.batch_size)
    for r in rec["launches"]:
        if r != {"stats_fwd": (EP2_STEPS + 1) * n_chunks,
                 "stats_bwd": EP2_STEPS * n_chunks, "other": 0}:
            fail(f"ep2: launches {rec['launches']}")
    if not rec["ranks_bit_identical"]:
        fail("ep2: the two ranks' curves differ")
    if (rec["energy_rel_max"] > EP2_E_RTOL
            or rec["omega_max_abs"] > EP2_OMEGA_MAX):
        fail(f"ep2 vs one process: energies {rec['energy_rel_max']:.3g}, "
             f"omega {rec['omega_max_abs']:.3g}")
    if not rec["moved_from_init"]:
        fail("ep2: the curves did not move")
    return rec


def numerics_gate(decoders, dev):
    """The bench's numerics gate (bench.py:104-168): median relative error
    of the plain expected energy, K1 and K9 (through the public op) at
    float32 on smooth curves against a float64 host truth."""
    import torch

    from vae_latent_geometry_tpu_torch.geometry import energy as energy_lib
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    rng = np.random.default_rng(GATE_SEED)
    t = np.linspace(0, 1, GATE_T)[:, None, None]
    a = rng.normal(size=(1, GATE_B, 2))
    b = rng.normal(size=(1, GATE_B, 2))
    g64 = (1 - t) * a + t * b + 0.3 * np.sin(np.pi * t * 3) * rng.normal(
        size=(1, GATE_B, 2))
    ws = [l["w"].double().cpu().numpy() for l in decoders["layers"]]
    bs = [l["b"].double().cpu().numpy() for l in decoders["layers"]]
    xs = []
    for m in range(ws[0].shape[0]):
        h = g64.reshape(-1, 2)
        for i in range(len(ws)):
            h = h @ ws[i][m] + bs[i][m]
            if i < len(ws) - 1:
                h = np.maximum(h, 0)
        xs.append(h.reshape(GATE_T, GATE_B, -1))
    xs = np.stack(xs)
    xbar = xs.mean(0)
    sq = (xs ** 2).sum(-1).mean(0)
    truth = (sq[1:] + sq[:-1] - 2 * (xbar[1:] * xbar[:-1]).sum(-1)).sum(0)
    g = torch.as_tensor(g64, dtype=torch.float32, device=dev)

    def medrel(e):
        e = e.double().cpu().numpy()
        return float(np.median(np.abs(e - truth) / np.abs(truth)))

    with torch.no_grad():
        return {"plain_expected": medrel(energy_lib.energy_expected(decoders,
                                                                    g)),
                "k1_fused_expected": medrel(ef.energy_expected_fused(
                    decoders, g, None, "float32")),
                "k9_fused_expected_t": medrel(eft.energy_expected_fused_t(
                    decoders, g, "float32"))}


def float64_function(plain, ws, bs, *tensors):
    """``plain(ws, bs, *tensors, "float32")``, a plain version at its float32
    rung, in float64 with its weight shipping (a cast to float32) skipped:
    the function itself, against which a rung's rounding is judged."""
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    d = torch.float64
    ship = ef.ship_weights, mc.ship_weights
    ef.ship_weights = mc.ship_weights = lambda w, _: w
    try:
        return plain([w.to(d) for w in ws], [b.to(d) for b in bs],
                     *[t.to(d) if t.is_floating_point() else t
                       for t in tensors], "float32")
    finally:
        ef.ship_weights, mc.ship_weights = ship


def transposed_phase(params, ws_all, bs_all, gamma, dev):
    """K9/K10 against their plain versions (M=10 and M=1, every rung) and
    against K1/K2; the numerics gate; CUDA-event times.  The op's own path
    (forward and gradient through ``energy_expected_fused_t`` at f32x2, and
    the gate) runs with the launch counts set to 0.  Returns (records,
    times, launches)."""
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    T, B, _ = gamma.shape
    ct = torch.ones(B, dtype=torch.float32, device=dev)
    recs, times = {}, {}
    for M in (ws_all[0].shape[0], 1):
        ws = [w[:M].contiguous() for w in ws_all]
        bs = [b[:M].contiguous() for b in bs_all]
        wmb = ef.uniform_weights(M, B, dev)
        for prec in ef.PRECISIONS:
            e = eft.energy_t_fwd(ws, bs, gamma, prec)
            e_p = eft.energy_t_fwd_plain(ws, bs, gamma, prec)
            d = eft.energy_t_bwd(ws, bs, gamma, ct, prec)
            d_p = eft.energy_t_bwd_plain(ws, bs, gamma, ct, prec)
            torch.cuda.synchronize()
            rec = {"phase": "transposed", "M": M, "precision": prec,
                   "energy_max_rel": float(((e - e_p).abs() / e_p.abs()).max()),
                   "energy_max_abs": float((e - e_p).abs().max()),
                   **dgamma_stats(d, d_p),
                   "finite": bool(torch.isfinite(e).all()
                                  and torch.isfinite(d).all())}
            if M == 1 and prec in ("f32x3", "f32x2"):
                # printed beside the limit: without the variance term the
                # energy is a sum of squared adjacent-sample differences,
                # which shows a decode's rounding ~2000 times larger
                truth = float64_function(ef.energy_fwd_plain, ws, bs, gamma,
                                         wmb)
                for key, x in (("vs_float64", e), ("plain_vs_float64", e_p)):
                    rel = (x.double() - truth).abs() / truth.abs()
                    rec[key + "_max_rel"] = float(rel.max())
                    rec[key + "_median_rel"] = float(rel.median())
            if M > 1 and prec in ("float32", "f32x3", "f32x2"):
                # K9/K10 against K1/K2, the same functions: since K9/K10 run
                # the tensor-core decode of decode_mma.cuh at the reduced
                # rungs (and K9 K1's own kernel at float32) this is no longer
                # an independent implementation; the plain versions above
                # remain the independent check
                e1 = ef.energy_fwd(ws, bs, gamma, wmb, prec)
                d2 = ef.energy_bwd(ws, bs, gamma, wmb, ct, prec)
                rec["vs_k1_energy_max_rel"] = float(
                    ((e - e1).abs() / e1.abs()).max())
                rec.update(dgamma_stats(d, d2, "vs_k2_"))
                if prec != "float32":   # K2's one-pass body: bit for bit
                    rec["vs_k2_bitwise"] = bool(torch.equal(d, d2))
            if M > 1:
                tr = {"k9_ms": time_ms(lambda: eft.energy_t_fwd(
                          ws, bs, gamma, prec), 3),
                      "k10_ms": time_ms(lambda: eft.energy_t_bwd(
                          ws, bs, gamma, ct, prec), 3),
                      "k1_ms": time_ms(lambda: ef.energy_fwd(
                          ws, bs, gamma, wmb, prec), 3),
                      "k2_ms": time_ms(lambda: ef.energy_bwd(
                          ws, bs, gamma, wmb, ct, prec), 3)}
                tr["k9_k10_ms"] = tr["k9_ms"] + tr["k10_ms"]
                tr["k1_k2_ms"] = tr["k1_ms"] + tr["k2_ms"]
                if prec in ("float32", "f32x2"):
                    tr["k9_plain_ms"] = time_ms(lambda: eft.energy_t_fwd_plain(
                        ws, bs, gamma, prec), 2)
                    tr["k10_plain_ms"] = time_ms(
                        lambda: eft.energy_t_bwd_plain(ws, bs, gamma, ct,
                                                       prec), 2)
                rec.update(tr)
                times[prec] = rec
            emit(rec)
            recs[(M, prec)] = rec
    # the op's own path, as a caller runs it: the gate, then forward and
    # gradient at the production shape
    torch.cuda.synchronize()
    ef.reset_launch_counts()
    gate = numerics_gate(params.decoders, dev)
    g = gamma.clone().requires_grad_(True)
    e = eft.energy_expected_fused_t(params.decoders, g, "f32x2")
    e.sum().backward()
    torch.cuda.synchronize()
    launches = dict(ef.LAUNCHES)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    path = {"phase": "transposed_path", "gate_medrel": gate,
            "op_energy_finite": bool(torch.isfinite(e).all()),
            "op_grad_finite": bool(torch.isfinite(g.grad).all()),
            # (K9 on this decoder takes tiles, not spans) the tensor-core
            # K10 at f32x2: tiles that add 31 rows, one halo row
            "spans_bwd": eft.pick_spans(T, B, n_sm, 1, eft.SPAN_ROWS - 1),
            "launches": launches}
    emit(path)
    return recs, times, path


def jvp_phase(params, art, cfg, dev):
    """The JVP and rescaled modes through ``optimize_spline_batch``: each
    plan of tools/jax_reference_jvp.py on the whole init blob, final
    energies by K1 at float32, T=2000; launch counts, steps/s, lengths of
    the reference's pairs against it."""
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    with open(JAX_JVP) as f:
        ref = json.load(f)
    sel = np.asarray(ref["pairs"])
    recs = []
    for name, entry in ref["plans"].items():
        plan = tuple(entry["plan"])
        jcfg = dataclasses.replace(
            cfg, steps=plan[0], phase_plan=(plan,),
            energy=dataclasses.replace(cfg.energy, mode="expected_fused",
                                       target_num_t=ref["target_num_t"]))
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        out = optimize_spline_batch(params, art, cfg=jcfg, device=dev,
                                    log_every_chunk=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lengths = np.asarray(out.geodesic_length, np.float64)
        rel = np.abs(lengths[sel] / np.asarray(entry["lengths"]) - 1)
        rec = {"phase": "jvp", "name": name, "plan": list(plan),
               "target_num_t": ref["target_num_t"], "optimize_s": secs,
               "steps_per_s": plan[0] / secs, "launches": dict(ef.LAUNCHES),
               "lengths_finite": bool(np.isfinite(lengths).all()),
               "moved_from_init": bool(not np.array_equal(
                   out.omega_optimized, art.omega_init)),
               "vs_jax_cpu_pairs": int(len(sel)),
               "len_rel_median": float(np.median(rel)),
               "len_rel_max": float(rel.max()),
               "len_rel_argmax_pair": int(sel[np.argmax(rel)]),
               "len_mean": float(lengths.mean())}
        emit(rec)
        recs.append(rec)
    return recs


def cov_phase(params, dev):
    """``cov_analysis`` on the seeded surrogate, the committed model as both
    seeds: at mc_fused (steps/s, K8 launches, the estimator's own CoV) and
    at expected_fused (lengths against tools/jax_reference_cov.py, the two
    seeds bit-identical, every CoV 0)."""
    import torch

    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
    from vae_latent_geometry_tpu_torch.models.evae import encode
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import cov_analysis
    from vae_latent_geometry_tpu_torch.pipeline.select_pairs import (
        make_pairs, select_representatives)

    with open(JAX_COV) as f:
        ref = json.load(f)
    data = load_tasic()
    with torch.no_grad():
        latents = encode(params, torch.as_tensor(
            data.x, device=dev))[0].cpu().numpy()
    pairs = [tuple(p) for p in make_pairs(
        select_representatives(latents, data.labels, COV_LABELS))]
    ref_pairs = [tuple(p) for p in ref["pairs"]]
    steps = ref["recipe"]["steps"]
    recs = {}
    for mode in ("mc_fused", "expected_fused"):
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        res = cov_analysis([params, params], [42, 42], data.x, ref_pairs,
                           decoder_counts=tuple(range(1, 11)), steps=steps,
                           num_t=ref["recipe"]["num_t"], mode=mode,
                           kernel_precision=ref["recipe"]["kernel_precision"],
                           device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = {"phase": "cov", "mode": mode,
               "precision": ref["recipe"]["kernel_precision"],
               "splines": len(ref_pairs) * len(res.decoder_counts),
               "steps": steps, "seeds": 2, "optimize_s": secs,
               "steps_per_s": 2 * steps / secs, "launches": dict(ef.LAUNCHES),
               "pairs_equal_jax": pairs == ref_pairs,
               "lengths_finite": bool(np.isfinite(res.lengths).all()),
               "seeds_bit_identical": bool(np.array_equal(res.lengths[0],
                                                          res.lengths[1])),
               "avg_cov_geodesic": res.avg_cov_geodesic,
               "avg_cov_euclidean": res.avg_cov_euclidean}
        if mode == "expected_fused":
            rel = np.abs(res.lengths[0] / np.asarray(ref["lengths"]) - 1)
            rec.update({"len_rel_median": float(np.median(rel)),
                        "len_rel_max": float(rel.max()),
                        "len_rel_argmax": [int(i) for i in np.unravel_index(
                            np.argmax(rel), rel.shape)]})
        emit(rec)
        recs[mode] = rec
    return recs


def k2_small_shapes(ef, dev):
    """K2 against its plain version on random decoders at X = 7 and 64,
    every reduced rung (the tensor-core kernels), and a second call bitwise
    equal to the first."""
    import torch

    rng = np.random.default_rng(17)
    T, B, D, M = (K2_SMALL[k] for k in ("T", "B", "D", "M"))

    def on_dev(x):
        return torch.as_tensor(x.astype(np.float32), device=dev)

    recs = []
    for X in K2_SMALL["X"]:
        ws = [on_dev(rng.normal(size=(M, D, 128)) / np.sqrt(D)),
              on_dev(rng.normal(size=(M, 128, 128)) * np.sqrt(2 / 128)),
              on_dev(rng.normal(size=(M, 128, X)) * np.sqrt(2 / 128))]
        bs = [on_dev(rng.normal(size=(M, n)) * 0.1) for n in (128, 128, X)]
        g = on_dev(rng.normal(size=(T, B, D)) * 2)
        wmb = ef.active_weights(torch.as_tensor(rng.integers(1, M + 1, B)),
                                M, B, dev)
        ct = on_dev(rng.uniform(0.5, 2, B))
        for prec in ("f32x3", "f32x2", "bfloat16"):
            d = ef.energy_bwd(ws, bs, g, wmb, ct, prec)
            d_p = ef.energy_bwd_plain(ws, bs, g, wmb, ct, prec)
            again = ef.energy_bwd(ws, bs, g, wmb, ct, prec)
            torch.cuda.synchronize()
            rec = {"phase": "kernels", "kernel": "k2_small", "T": T, "B": B,
                   "D": D, "M": M, "X": X, "precision": prec,
                   **dgamma_stats(d, d_p),
                   "repeat_bitwise": bool(torch.equal(d, again)),
                   "finite": bool(torch.isfinite(d).all())}
            emit(rec)
            recs.append(rec)
            if not (rec["finite"] and rec["repeat_bitwise"]):
                fail(f"K2 at X={X} {prec}: non-finite or not repeatable")
            if (rec["dgamma_rel_median"] > DG_MED
                    or rec["dgamma_rel_p99"] > DG_P99
                    or rec["dgamma_share_over_1e-3"] > DG_OVER_SHARE[prec]):
                fail(f"K2 at X={X} {prec}: dgamma median/p99/share "
                     f"{rec['dgamma_rel_median']:.3g}/"
                     f"{rec['dgamma_rel_p99']:.3g}/"
                     f"{rec['dgamma_share_over_1e-3']:.3g}")
    return recs


def device_kernel_times(prof):
    """({kernel name: device microseconds}, microseconds from the first
    kernel's start to the last one's end) of a torch.profiler trace."""
    import torch

    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by = {}
    for e in evs:
        by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs)) if evs else 0.0
    return by, span


def launch_times(fn, calls):
    """{kernel: device ms per call} of ``calls`` calls of ``fn`` after one
    warm-up, by torch.profiler (names without the anonymous namespace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by, _ = device_kernel_times(prof)
    return {k.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0]: v / calls / 1e3 for k, v in by.items()}


def step_profile(params, art, cfg, dev, tag, mesh=None):
    """PROFILE_STEPS steps of ``optimize_splines`` at ``cfg`` (the first
    chunk, final evaluation included; ``mesh`` for the decoder-sharded path)
    under torch.profiler: the device's busy share between its first and last
    kernel and the kernels that take the most of it (keys prefixed with
    ``tag``), and {kernel: device us}.  ({}, {}) for a trace without device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_latent_geometry_tpu_torch.optim.geodesic import optimize_splines

    B = cfg.batch_size
    idx = np.concatenate([np.arange(len(art)),
                          np.full(B - len(art), len(art) - 1)])[:B]
    pcfg = dataclasses.replace(cfg, steps=PROFILE_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        optimize_splines(params.decoders, art.omega_init[idx], art.a[idx],
                         art.b[idx], art.basis, pcfg, device=dev,
                         generator=torch.Generator().manual_seed(0),
                         mesh=mesh)
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    steps, span = device_kernel_times(prof)
    if not steps:
        return {}, {}
    busy = sum(steps.values())
    top = sorted(steps.items(), key=lambda kv: -kv[1])[:6]
    return {tag + "steps": PROFILE_STEPS, tag + "wall_ms": wall_us / 1e3,
            tag + "device_span_ms": span / 1e3,
            tag + "device_busy_share_of_span": busy / span,
            tag + "device_idle_share_of_span": 1.0 - busy / span,
            tag + "kernels_ms": {k[:80]: v / 1e3 for k, v in top},
            tag + "n_kernel_launches": sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)}, steps


def profile_phase(ef, mc, params, art, cfg, dev, ws, bs, gamma, wmb, ct):
    """Device time by kernel from torch.profiler: K2 at f32x2 split into its
    two launches (the planes, the one-pass kernel), K6 and K8 at f32x2
    split into theirs, and PROFILE_STEPS steps of the main path, of the MC
    main path and of the decoder-sharded path on a 1 x 1 mesh (the device's
    busy share between its first and last kernel; for the sharded path K3's
    and K4's ms per launch and share of the span).  A trace without device
    events is reported as not measured."""
    import torch

    from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh

    k2 = launch_times(lambda: ef.energy_bwd(ws, bs, gamma, wmb, ct, "f32x2"),
                      PROFILE_K2_CALLS)
    T, B = gamma.shape[:2]
    M = ws[0].shape[0]
    d1, d2 = mc.sample_decoder_indices(
        torch.Generator(device=dev).manual_seed(7), T, B, M, MC_SAMPLES)
    kmax = torch.full((B,), float(M), device=dev)
    mc_ct = torch.linspace(0.5, 2.0, B, device=dev)
    k6 = launch_times(lambda: mc.energy_mc_bwd(ws, bs, gamma, d1, d2, mc_ct,
                                               "f32x2"), PROFILE_K2_CALLS)
    k8 = launch_times(lambda: mc.energy_mc_bwd_rng(
        ws, bs, gamma, (1 << 40) + 42, kmax, MC_SAMPLES, mc_ct, "f32x2"),
        PROFILE_K2_CALLS)
    main, by = step_profile(params, art, cfg, dev, "")
    mc_cfg = dataclasses.replace(cfg, energy=dataclasses.replace(
        cfg.energy, mode="mc_fused", mc_samples=MC_SAMPLES,
        mc_inkernel_rng=True))
    mc_main, mc_by = step_profile(params, art, mc_cfg, dev, "mc_main_")
    ep_cfg = dataclasses.replace(cfg, energy=dataclasses.replace(
        cfg.energy, ep_axis="ep"))
    ep, ep_by = step_profile(params, art, ep_cfg, dev, "ep_",
                             mesh=make_mesh(1, 1))
    rec = {"phase": "profile",
           "measured": bool(k2 and k6 and k8 and main and mc_main and ep)}
    if rec["measured"]:
        def of(times, key):
            return sum(v for k, v in times.items() if key in k)

        rec.update({
            "k2_f32x2_ms_per_call": sum(k2.values()),
            "k2_onepass_mma_ms": of(k2, "k2_onepass_mma"),
            "k2_prep_planes_ms": of(k2, "k2_prep_planes"),
            "mc_bwd_ms_by_launch": k6, "mc_rng_bwd_ms_by_launch": k8,
            "mc_select_mma_ms": of(k8, "mc_select_mma"),
            "mc_chain_mma_ms": of(k8, "mc_chain_mma"),
            **main,
            "k2_share_of_span": of(by, "k2_") / 1e3
            / main["device_span_ms"],
            **mc_main,
            "mc_main_k8_share_of_span": (of(mc_by, "mc_select_mma")
                                         + of(mc_by, "mc_chain_mma")) / 1e3
            / mc_main["mc_main_device_span_ms"],
            **ep})
        # each step launches the tensor-core K3 and K4 once (f32x2); the
        # final energies K3 at float32 (k3_stats) once more
        for name, key in (("k3", "k3_stats"), ("k4", "k4_stats_chain")):
            rec[f"ep_{name}_mma_ms_per_launch"] = of(
                ep_by, key + "_mma") / 1e3 / PROFILE_STEPS
            rec[f"ep_{name}_share_of_span"] = of(ep_by, key) / 1e3 \
                / ep["ep_device_span_ms"]
    emit(rec)
    return rec


def single_bf16_phase(params, art, cfg, dev, ef):
    """``single_fused_bf16`` through ``optimize_spline_batch`` (decoder 0,
    K2 at M=1 and bfloat16 every step), and the same recipe at
    ``single_fused`` f32x2: steps/s, launches, the lengths' difference."""
    import torch

    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    runs = {}
    for mode in ("single_fused_bf16", "single_fused"):
        scfg = dataclasses.replace(cfg, steps=SINGLE_STEPS,
                                   energy=dataclasses.replace(cfg.energy,
                                                              mode=mode))
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        out = optimize_spline_batch(params, art, cfg=scfg, device=dev,
                                    log_every_chunk=False)
        torch.cuda.synchronize()
        runs[mode] = (out, time.perf_counter() - t0, dict(ef.LAUNCHES))
    (bf, bf_s, bf_l), (f2, f2_s, f2_l) = runs.values()
    len_bf = np.asarray(bf.geodesic_length, np.float64)
    rel = np.abs(len_bf / np.asarray(f2.geodesic_length, np.float64) - 1)
    rec = {"phase": "single_bf16", "mode": "single_fused_bf16",
           "steps": SINGLE_STEPS, "optimize_s": bf_s,
           "steps_per_s": SINGLE_STEPS / bf_s, "launches": bf_l,
           "f32x2_optimize_s": f2_s, "f32x2_steps_per_s": SINGLE_STEPS / f2_s,
           "f32x2_launches": f2_l,
           "lengths_finite": bool(np.isfinite(len_bf).all()),
           "moved_from_init": bool(not np.array_equal(bf.omega_optimized,
                                                      art.omega_init)),
           "vs_f32x2_len_rel_median": float(np.median(rel)),
           "vs_f32x2_len_rel_max": float(rel.max()),
           "vs_f32x2_len_rel_argmax_pair": int(np.argmax(rel)),
           "len_mean": float(len_bf.mean())}
    emit(rec)
    n_chunks = -(-len(art) // cfg.batch_size)
    if not (rec["lengths_finite"] and rec["moved_from_init"]
            and np.isfinite(bf.omega_optimized).all()):
        fail("single_bf16: non-finite output or the curves did not move")
    for name, launches in (("single_fused_bf16", bf_l),
                           ("single_fused", f2_l)):
        if launches["energy_bwd"] < SINGLE_STEPS * n_chunks:
            fail(f"single_bf16: K2 launched {launches['energy_bwd']} times in "
                 f"{SINGLE_STEPS * n_chunks} steps of {name}")
    return rec


def width_flops(widths, passes):
    """FLOP of one decoder D -> ... -> X on one point: the first layer in
    fp32 once, the others at ``passes`` (decode_flops for a width list)."""
    return 2 * widths[0] * widths[1] + passes * sum(
        2 * i * o for i, o in zip(widths[1:-1], widths[2:]))


RUNG_PASSES = {"float32": 1, "f32x3": 3, "f32x2": 2, "bfloat16": 1}


def rung_bound(widths, n_decodes, prec, backward, n_bytes):
    """(operations s, bytes s): n_decodes decodes at the rung's passes
    (float32 on the FP32 peak, the reduced rungs on the bf16 tensor-core
    peak), plus one single-pass chain each for a backward kernel."""
    flops = n_decodes * (width_flops(widths, RUNG_PASSES[prec])
                         + (width_flops(widths, 1) if backward else 0))
    peak = PEAK_FP32 if prec == "float32" else PEAK_BF16
    return flops / peak, n_bytes / PEAK_BYTES


def shape_kernel_check(kind, got, again, ref, prec):
    """(ok, fields): a kernel's output on another decoder shape against its
    plain version under the kernel's limits above, the repeat bitwise and
    finite."""
    import torch

    gots = got if isinstance(got, tuple) else (got,)
    agains = again if isinstance(again, tuple) else (again,)
    f = {"repeat_bitwise": all(torch.equal(a, b)
                               for a, b in zip(gots, agains))}
    if kind == "stats":
        x_scale = float(ref[0].abs().max())
        errs = [float((got[0] - ref[0]).abs().max()) / x_scale,
                float((got[1] - ref[1]).abs().max()) / x_scale,
                float((got[2] - ref[2]).abs().max()) / max(
                    float(ref[2].abs().max()), 1e-30)]
        f["x0_yb_sq_rel"] = errs
        f["max_abs_err"] = float((got[1] - ref[1]).abs().max())
        ok = (max(errs[:2]) <= STATS_X_RTOL[prec]
              and errs[2] <= STATS_SQ_RTOL[prec])
    elif kind == "dgamma":
        f["dgamma"] = dgamma_stats(got, ref)
        f["max_abs_err"] = f["dgamma"]["dgamma_max_abs"]
        ok = (f["dgamma"]["dgamma_rel_median"] <= DG_MED
              and f["dgamma"]["dgamma_rel_p99"] <= DG_P99
              and f["dgamma"]["dgamma_share_over_1e-3"]
              <= DG_OVER_SHARE[prec])
    else:
        f["energy_max_rel"] = float(((got - ref).abs() / ref.abs()).max())
        f["max_abs_err"] = float((got - ref).abs().max())
        tol = (E_RTOL_MC_BF16 if kind == "mc_energy" and prec == "bfloat16"
               else E_RTOL)
        ok = f["energy_max_rel"] <= tol
    finite = all(bool(torch.isfinite(x).all()) for x in gots)
    return ok and finite and f["repeat_bitwise"], f


def timed_call(fn):
    """(fn(), ms of that one call by CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def shape_kernel_table(ef, mc, eft, name, M, g, dev, with_t):
    """({kernel: (kind, call, plain call, decodes, backward, bytes, summary
    rung)}, {"K2": K2's function in float64}) of decoder ``name`` (its first
    M members) on the points g (T, B, 2); K9/K10 when ``with_t``."""
    import torch

    T, B = g.shape[:2]
    P = T * B
    layers = shape_layers(name)
    ws = [torch.as_tensor(w[:M], device=dev) for w, _ in layers]
    bs = [torch.as_tensor(b[:M], device=dev) for _, b in layers]
    dims = SHAPES[name][0]
    X = dims[-1]
    ct = torch.as_tensor(cotangent(B), device=dev)
    rng = np.random.default_rng(int(name[1:]))
    counts = torch.as_tensor(rng.integers(1, M + 1, B), device=dev)
    wmb = ef.active_weights(counts, M, B, dev).contiguous()
    d1, d2 = mc.sample_decoder_indices(
        torch.Generator(device=dev).manual_seed(7), T, B, M, MC_SAMPLES,
        counts)
    kmax = counts.float()
    seed = (1 << 40) + int(name[1:])
    p1, p2 = mc.philox_draws(seed, MC_SAMPLES, T, B, kmax)
    cts = smooth_cotangents(T, B, X, dev, 11)
    mc_ct = torch.linspace(0.5, 2.0, B, device=dev)
    need = {}
    for tag, (a, b) in (("planes", (d1, d2)), ("rng", (p1, p2))):
        n = torch.zeros((T, B, M), dtype=torch.bool, device=dev)
        for s in range(MC_SAMPLES):
            n[:-1].scatter_(2, a[s].long()[..., None], True)
            n[1:].scatter_(2, b[s].long()[..., None], True)
        need[tag] = int(n.sum())
    w_bytes = 4 * (sum(w.numel() for w in ws) + sum(b.numel() for b in bs))
    g_bytes = 4 * g.numel()
    plane_bytes = 2 * MC_SAMPLES * (T - 1) * B * 4
    stat_bytes = 4 * (2 * P * X + P)
    kernels = {
        "K1": ("energy", lambda p: ef.energy_fwd(ws, bs, g, wmb, p),
               lambda p: ef.energy_fwd_plain(ws, bs, g, wmb, p),
               P * M, False, w_bytes + g_bytes + 4 * M * B + 4 * B,
               "float32"),
        "K2": ("dgamma", lambda p: ef.energy_bwd(ws, bs, g, wmb, ct, p),
               lambda p: ef.energy_bwd_plain(ws, bs, g, wmb, ct, p),
               P * M, True, w_bytes + 2 * g_bytes + 4 * M * B + 4 * B,
               "f32x2"),
        "K3": ("stats", lambda p: ef.stats_fwd(ws, bs, g, wmb, p),
               lambda p: ef.stats_fwd_plain(ws, bs, g, wmb, p),
               P * M, False, w_bytes + g_bytes + 4 * M * B + stat_bytes,
               "f32x2"),
        "K4": ("dgamma", lambda p: ef.stats_bwd(ws, bs, g, wmb, *cts, p),
               lambda p: ef.stats_bwd_plain(ws, bs, g, wmb, *cts, p),
               P * M, True,
               w_bytes + 2 * g_bytes + 4 * M * B + stat_bytes, "f32x2"),
        "K5": ("mc_energy",
               lambda p: mc.energy_mc_fwd(ws, bs, g, d1, d2, p),
               lambda p: mc.energy_mc_fwd_plain(ws, bs, g, d1, d2, p),
               need["planes"], False,
               w_bytes + g_bytes + plane_bytes + 4 * B, "float32"),
        "K6": ("dgamma",
               lambda p: mc.energy_mc_bwd(ws, bs, g, d1, d2, mc_ct, p),
               lambda p: mc.energy_mc_bwd_plain(ws, bs, g, d1, d2, mc_ct, p),
               need["planes"], True,
               w_bytes + 2 * g_bytes + plane_bytes + 4 * B, "f32x2"),
        "K7": ("mc_energy",
               lambda p: mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax,
                                              MC_SAMPLES, p),
               lambda p: mc.energy_mc_fwd_rng_plain(
                   ws, bs, g, seed, kmax, MC_SAMPLES, p),
               need["rng"], False, w_bytes + g_bytes + 8 * B, "float32"),
        "K8": ("dgamma",
               lambda p: mc.energy_mc_bwd_rng(ws, bs, g, seed, kmax,
                                              MC_SAMPLES, mc_ct, p),
               lambda p: mc.energy_mc_bwd_rng_plain(
                   ws, bs, g, seed, kmax, MC_SAMPLES, mc_ct, p),
               need["rng"], True, w_bytes + 2 * g_bytes + 8 * B, "f32x2")}

    def k2_float64():
        """The float32 plain version in float64 (its weight shipping, a
        cast to float32, bypassed): K2's function without rounding."""
        d = torch.float64
        ship, ef.ship_weights = ef.ship_weights, lambda w, _: w
        try:
            return ef.energy_bwd_plain(
                [w.to(d) for w in ws], [b.to(d) for b in bs], g.to(d),
                wmb.to(d), ct.to(d), "float32")
        finally:
            ef.ship_weights = ship

    if with_t:
        kernels["K9"] = (
            "energy", lambda p: eft.energy_t_fwd(ws, bs, g, p),
            lambda p: eft.energy_t_fwd_plain(ws, bs, g, p),
            P * M, False, w_bytes + g_bytes + 4 * B, "float32")
        kernels["K10"] = (
            "dgamma", lambda p: eft.energy_t_bwd(ws, bs, g, ct, p),
            lambda p: eft.energy_t_bwd_plain(ws, bs, g, ct, p),
            P * M, True, w_bytes + 2 * g_bytes + 4 * B, "f32x2")
    return kernels, {"K2": k2_float64}


def run_shape_kernel(rec, kname, entry, rungs, timed_rung, dims,
                     truth=None):
    """Each rung of ``rungs``: the kernel twice (bitwise) against its plain
    version; at ``timed_rung`` (run last) ms per call, the plain call's ms
    and the bound.  With ``truth`` (the function in float64; a dgamma
    kernel) the kernel is held instead to be no farther from it than its
    plain version is (K2_M1_FLOAT64).  Fails on the first disagreement."""
    kind, fn, fn_p, n_dec, bwd, n_bytes, _ = entry
    order = [p for p in rungs if p != timed_rung] + [timed_rung]
    for prec in order:
        got, again = fn(prec), fn(prec)
        if prec == timed_rung:
            ref, rec["plain_ms"] = timed_call(lambda: fn_p(prec))
        else:
            ref = fn_p(prec)
        ok, f = shape_kernel_check(kind, got, again, ref, prec)
        if truth is not None:
            t = truth()
            f["vs_float64"] = dgamma_stats(got.double(), t)
            f["plain_vs_float64"] = dgamma_stats(ref.double(), t)
            ok = f["repeat_bitwise"] and all(
                f["vs_float64"][k] <= K2_M1_FLOAT64 * f["plain_vs_float64"][k]
                for k in f["vs_float64"])
            del t
        for k, v in f.items():
            rec.setdefault(k, {})[prec] = v
        if not ok:
            emit(rec)
            fail(f"shapes: {kname} at {rec['shape']} {prec} (T={rec['T']}, "
                 f"B={rec['B']}, M={rec['M']}) disagrees with its plain "
                 "version or is not repeated bitwise")
    del got, again, ref
    rec["rung"] = timed_rung
    rec["ms"] = time_ms(lambda: fn(timed_rung), 2)
    bound = rung_bound(list(dims), n_dec, timed_rung, bwd, n_bytes)
    rec["bound_ms"] = 1e3 * max(bound)
    rec["bound_by"] = "operations" if bound[0] >= bound[1] else "bytes"


def shapes_kernels(ef, mc, eft, dev):
    """Phase shapes (a): K1-K10 (K9/K10 at the 3-layer shapes) at S1-S5 and
    every rung against their plain versions, each call repeated bitwise;
    at each kernel's summary rung ms per call, the bound and the plain
    version's ms.  Returns {kernel: {shape: record}}."""
    import torch

    T, B = SHAPES_T, SHAPES_B
    # seeded random points, not smooth curves: on smooth curves at T = 400
    # a decoder output's bf16 rounding is the size of the adjacent-sample
    # differences, so at the bfloat16 rung either summation order's
    # rounding flips would hide the kernels' own arithmetic (the reason of
    # E_RTOL_BF16_M1: K1 at S1 read 8.1e-4 against its plain version on
    # smooth curves on an H100)
    g = torch.as_tensor((1.5 * np.random.default_rng(SHAPES_T).normal(
        size=(T, B, 2))).astype(np.float32), device=dev)
    out = {}
    for name, (dims, M) in SHAPES.items():
        table, _ = shape_kernel_table(ef, mc, eft, name, M, g, dev,
                                      len(dims) == 4)
        for kname, entry in table.items():
            rec = {"phase": "shapes", "part": "kernels", "kernel": kname,
                   "shape": name, "dims": list(dims), "M": M, "T": T, "B": B}
            run_shape_kernel(rec, kname, entry, ef.PRECISIONS, entry[-1],
                             dims)
            emit(rec)
            out.setdefault(kname, {})[name] = rec
    return out


def shapes_kernels_chunk(ef, mc, eft, dev, gamma):
    """Phase shapes (a), the optimized shapes: on SHAPES_OPT, every (kernel,
    rung, M) of SHAPES_OPT_CALLS on the init curves at the production chunk
    (``gamma``, T=2000, B=200), the inputs of their optimizer runs but for
    the per-spline decoder counts, against the plain versions under the
    same limits (K2 at M=1 at a reduced rung: K2_M1_FLOAT64), bitwise
    repeats, ms, plain ms and bound.  Returns {kernel: {shape: record of
    its M=all call at its optimizer rung}}."""
    T, B = gamma.shape[:2]
    out = {}
    for name in SHAPES_OPT:
        dims, M_all = SHAPES[name]
        tables = {}
        for kname, prec, m in SHAPES_OPT_CALLS:
            M = M_all if m == "M" else m
            if M not in tables:
                tables[M] = shape_kernel_table(ef, mc, eft, name, M, gamma,
                                               dev, False)
            rec = {"phase": "shapes", "part": "kernels_chunk",
                   "kernel": kname, "shape": name, "dims": list(dims),
                   "M": M, "T": T, "B": B}
            table, truths = tables[M]
            run_shape_kernel(rec, kname, table[kname], (prec,), prec, dims,
                             truths[kname] if (kname, M) == ("K2", 1)
                             and prec != "float32" else None)
            emit(rec)
            if m == "M" and (name not in out.get(kname, {})
                             or prec != "float32"):
                out.setdefault(kname, {})[name] = rec
    return out


def shapes_vs_jax(ef, mc, dev):
    """Phase shapes (b): the fused modes on S1-S4 at T = 32, B = 4 on the
    card against the JAX package's kernels (tools/jax_reference_shapes.py),
    under the CPU tests' limits."""
    import torch

    with open(JAX_SHAPES) as f:
        ref = json.load(f)
    T, B, S = ref["T"], ref["B"], ref["mc_samples"]
    ct = torch.as_tensor(cotangent(B), device=dev)
    zeros = torch.zeros((S, T - 1, B), dtype=torch.int32, device=dev)
    worst = {}
    for name, sref in ref["shapes"].items():
        layers = shape_layers(name, ref["seed"])
        dec = {"layers": [{"w": torch.as_tensor(w, device=dev),
                           "b": torch.as_tensor(b, device=dev)}
                          for w, b in layers]}
        single = {"layers": [{"w": l["w"][:1], "b": l["b"][:1]}
                             for l in dec["layers"]]}
        for key, r in sref["modes"].items():
            mode, prec = key.split("/")
            g = torch.as_tensor(shape_curves(T, B, ref["seed"]),
                                device=dev).requires_grad_(True)
            if mode.startswith("expected"):
                e = ef.energy_expected_fused(dec, g, None, prec)
            elif mode.startswith("single"):
                e = ef.energy_expected_fused(single, g, None, prec)
            else:
                e = mc.energy_mc_fused(dec, g, zeros, zeros, prec)
            (d,) = torch.autograd.grad((ct * e).sum(), g)
            e_j = np.asarray(r["energy"])
            d_j = np.asarray(r["dgamma"]).reshape(T, B, -1)
            e_t = e.detach().double().cpu().numpy()
            d_t = d.double().cpu().numpy()
            e_rel = float(np.max(np.abs(e_t - e_j) / np.abs(e_j)))
            scale = np.abs(d_j).max()
            err = np.abs(d_t - d_j) / scale
            if prec == "bfloat16":
                ok = e_rel <= 1e-4 and err.max() <= 2e-3
            elif prec == "f32x3":
                ok = (e_rel <= 1e-5 and np.median(err) <= 1e-4
                      and np.quantile(err, 0.99) <= 1e-3)
            else:
                ok = e_rel <= 1e-5 and bool(np.all(
                    np.abs(d_t - d_j) <= 1e-4 * np.abs(d_j) + 1e-4 * scale))
            rec = {"shape": name, "mode": mode, "precision": prec,
                   "energy_max_rel": e_rel,
                   "dgamma_rel_median": float(np.median(err)),
                   "dgamma_rel_p99": float(np.quantile(err, 0.99)),
                   "dgamma_rel_max": float(err.max())}
            worst[f"{name}/{key}"] = rec
            if not ok:
                emit({"phase": "shapes", "part": "vs_jax", **rec})
                fail(f"shapes: {mode} at {prec} on {name} against the JAX "
                     "package")
    emit({"phase": "shapes", "part": "vs_jax", "cases": len(worst),
          "energy_max_rel": max(r["energy_max_rel"] for r in worst.values()),
          "dgamma_rel_max": max(r["dgamma_rel_max"] for r in worst.values())})
    return worst


def shapes_optimize(params, art, cfg, dev, ef):
    """Phase shapes (c): SHAPES_STEPS steps at the production chunk (f32x2)
    on S3 and S4 through expected_fused, mc_fused, single_fused and the
    decoder-sharded path (one rank: K3/K4), beside the unfused ``expected``
    mode; steps/s and launch counts."""
    import torch

    from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    n_chunks = -(-len(art) // cfg.batch_size)
    steps = SHAPES_STEPS
    # final energies at float32 in each run's own mode: K1, K7 (in-kernel
    # draws), K1 at M=1, K3, and the unfused mode's plain decode
    want = {"expected_fused": {"energy_bwd": steps, "energy_fwd": 1},
            "mc_fused": {"energy_mc_bwd_rng": steps, "energy_mc_fwd_rng": 1},
            "single_fused": {"energy_bwd": steps, "energy_fwd": 1},
            "ep": {"stats_fwd": steps + 1, "stats_bwd": steps},
            "expected": {}}
    recs = {}
    for name in ("S3", "S4"):
        dec = {"layers": [{"w": torch.as_tensor(w, device=dev),
                           "b": torch.as_tensor(b, device=dev)}
                          for w, b in shape_layers(name)]}
        sp = dataclasses.replace(params, decoders=dec)
        rec = {"phase": "shapes", "part": "optimize", "shape": name,
               "dims": list(SHAPES[name][0]), "M": SHAPES[name][1],
               "steps": steps, "precision": "f32x2", "steps_per_s": {},
               "launches": {}}
        for run in want:
            mode = "expected_fused" if run == "ep" else run
            rcfg = dataclasses.replace(cfg, steps=steps, energy=dataclasses.replace(
                cfg.energy, mode=mode, ep_axis="ep" if run == "ep" else None,
                mc_samples=MC_SAMPLES, mc_inkernel_rng=True))
            torch.cuda.synchronize()
            ef.reset_launch_counts()
            t0 = time.perf_counter()
            out = optimize_spline_batch(
                sp, art, cfg=rcfg, device=dev, log_every_chunk=False,
                generator=torch.Generator().manual_seed(0),
                mesh=make_mesh(1, 1) if run == "ep" else None)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rec["steps_per_s"][run] = steps / secs
            launches = dict(ef.LAUNCHES)
            rec["launches"][run] = {k: v for k, v in launches.items() if v}
            lengths = np.asarray(out.geodesic_length, np.float64)
            if not (np.isfinite(lengths).all() and not np.array_equal(
                    out.omega_optimized, art.omega_init)):
                fail(f"shapes: {run} on {name}: non-finite lengths or the "
                     "curves did not move")
            for k, v in launches.items():
                if v != want[run].get(k, 0) * n_chunks:
                    fail(f"shapes: {run} on {name}: {k} launched {v} times, "
                         f"expected {want[run].get(k, 0) * n_chunks}")
        emit(rec)
        recs[name] = rec
    return recs


# Phase big: the shapes past the kernels' former cap.  (a) Every kernel on
# decoder BIG_DIMS (D = 5, a 1024-unit layer, 7 layers, X = 200 in two
# column slices; K1-K8: the transposed op takes 3 layers) and on the 3-layer
# BIG_WIDE (K1-K10), M = BIG_M seeded members, BIG_T x BIG_B seeded random
# points, at every rung against its plain version under the shapes phase's
# limits, each call repeated bitwise.  Two exceptions, each printed beside
# its readings:
# - bfloat16 energies in BIG_BF16_E: the two summation orders' bf16 rounding
#   flips compound over seven layers or a 1024-unit product, and these read
#   past the shapes phase's limits from their plain versions (H100, this
#   phase: K1 7.47e-5 on BIG_DIMS and 1.13e-5 on BIG_WIDE against 1e-5, K7
#   6.23e-5 on BIG_DIMS against 5e-5).  They are held to BIG_BF16_E_RTOL of
#   their plain versions (twice the largest reading) and to the function in
#   float64 as K2 at M = 1 is: their largest and median relative errors
#   from it within K2_M1_FLOAT64 of the plain version's.
# - K2/K4/K6 at a reduced rung on BIG_DIMS: a launch takes at most MAX_X
#   output columns, and the chain rounds each slice's cotangents to bf16
#   apart, so the kernels' dgamma is the slices' sum, 1-3e-3 of the largest
#   element from the whole-X chain's (the plain versions on the CPU), past
#   DG_MED and DG_P99.  They are held to the sum over the slices of the plain
#   version under the shapes phase's limits, and to the float32 dgamma: their
#   median and 99th-percentile errors from it within SLICED_CHAIN of the
#   whole-X chain's (the plain slices' sum read 0.72-1.04 of it on the CPU).
# (b) The whole 133-class matrix as one chunk, T = 2000, B = WHOLE_B (past
# the 32-bit index at 128-unit layers: two launches a call): every kernel
# K1-K10 on the committed model at float32 and f32x2 against its plain
# version on splines WHOLE_TAKE, and WHOLE_STEPS steps of expected_fused and
# mc_fused on the init blob tiled to WHOLE_B pairs, the four splines'
# lengths against the plain modes' run on those four (main's limits; mc's
# for mc_fused, whose draws differ from the plain mode's).
BIG_DIMS = (5, 1024, 24, 24, 24, 24, 24, 200)
BIG_WIDE = (2, 1024, 64, 50)
BIG_M, BIG_T, BIG_B = 3, 64, 13
BIG_BF16_E = {("big", "K1"), ("big", "K7"), ("wide", "K1")}
BIG_BF16_E_RTOL = 1.5e-4
SLICED_CHAIN = 1.25
WHOLE_B = 8778
WHOLE_TAKE = (0, 4000, 8388, 8777)
WHOLE_STEPS = 5


def big_decoders(dims, dev):
    """BIG_M seeded members of a decoder of widths ``dims`` (as
    tests/test_torch_isolation.py builds them)."""
    import torch

    rng = np.random.default_rng(7)
    layers = [((rng.normal(size=(BIG_M, i, o)) / np.sqrt(i)).astype(np.float32),
               (0.1 * rng.normal(size=(BIG_M, o))).astype(np.float32))
              for i, o in zip(dims[:-1], dims[1:])]
    return ([torch.as_tensor(w, device=dev) for w, _ in layers],
            [torch.as_tensor(b, device=dev) for _, b in layers])


def big_kernel_table(ef, mc, eft, ws, bs, g, wmb, ct, cts, planes, kmax,
                     with_t, take=None):
    """{kernel: (kind, kernel(prec), plain(prec, ws, bs, c0, c1) on the
    splines ``take`` (the decoder and the cotangents' output columns c0..c1
    default to the whole), the energies' function in float64 or None)};
    the kernel outputs are cut to ``take``."""
    import torch

    idx = slice(None) if take is None else torch.as_tensor(take,
                                                            device=g.device)

    def on(x):
        if isinstance(x, tuple):
            return tuple(on(o) for o in x)
        return x[idx] if x.dim() == 1 else x[:, idx].contiguous()

    T, B = g.shape[:2]
    X = ws[-1].shape[-1]
    seed = (1 << 40) + 3
    d1, d2 = planes
    r1, r2 = mc.philox_draws(seed, d1.shape[0], T, B, kmax)
    gc, wc, cc = on(g), on(wmb), on(ct)
    ctc = [on(c) for c in cts]
    p1, p2, q1, q2 = (x[:, :, idx].contiguous() for x in (d1, d2, r1, r2))
    S = d1.shape[0]
    uc = ef.uniform_weights(ws[0].shape[0], gc.shape[1], g.device)

    def cols(x, c0, c1):
        return x[..., c0:c1].contiguous()

    table = {
        "K1": ("energy", lambda p: on(ef.energy_fwd(ws, bs, g, wmb, p)),
               lambda p, w=ws, b=bs, c0=0, c1=X: ef.energy_fwd_plain(
                   w, b, gc, wc, p),
               lambda: float64_function(ef.energy_fwd_plain, ws, bs, gc, wc)),
        "K2": ("dgamma", lambda p: on(ef.energy_bwd(ws, bs, g, wmb, ct, p)),
               lambda p, w=ws, b=bs, c0=0, c1=X: ef.energy_bwd_plain(
                   w, b, gc, wc, cc, p), None),
        "K3": ("stats", lambda p: on(ef.stats_fwd(ws, bs, g, wmb, p)),
               lambda p, w=ws, b=bs, c0=0, c1=X: ef.stats_fwd_plain(
                   w, b, gc, wc, p), None),
        "K4": ("dgamma", lambda p: on(ef.stats_bwd(ws, bs, g, wmb, *cts, p)),
               lambda p, w=ws, b=bs, c0=0, c1=X: ef.stats_bwd_plain(
                   w, b, gc, wc, cols(ctc[0], c0, c1), cols(ctc[1], c0, c1),
                   ctc[2], p), None),
        "K5": ("mc_energy", lambda p: on(mc.energy_mc_fwd(ws, bs, g, d1, d2,
                                                          p)),
               lambda p, w=ws, b=bs, c0=0, c1=X: mc.energy_mc_fwd_plain(
                   w, b, gc, p1, p2, p),
               lambda: float64_function(mc.energy_mc_fwd_plain, ws, bs, gc,
                                        p1, p2)),
        "K6": ("dgamma", lambda p: on(mc.energy_mc_bwd(ws, bs, g, d1, d2, ct,
                                                       p)),
               lambda p, w=ws, b=bs, c0=0, c1=X: mc.energy_mc_bwd_plain(
                   w, b, gc, p1, p2, cc, p), None),
        "K7": ("mc_energy", lambda p: on(mc.energy_mc_fwd_rng(
                   ws, bs, g, seed, kmax, S, p)),
               lambda p, w=ws, b=bs, c0=0, c1=X: mc.energy_mc_fwd_plain(
                   w, b, gc, q1, q2, p),
               lambda: float64_function(mc.energy_mc_fwd_plain, ws, bs, gc,
                                        q1, q2)),
        "K8": ("dgamma", lambda p: on(mc.energy_mc_bwd_rng(
                   ws, bs, g, seed, kmax, S, ct, p)),
               lambda p, w=ws, b=bs, c0=0, c1=X: mc.energy_mc_bwd_plain(
                   w, b, gc, q1, q2, cc, p), None)}
    if with_t:
        table["K9"] = ("energy", lambda p: on(eft.energy_t_fwd(ws, bs, g, p)),
                       lambda p, w=ws, b=bs, c0=0, c1=X:
                       eft.energy_t_fwd_plain(w, b, gc, p),
                       lambda: float64_function(ef.energy_fwd_plain, ws, bs,
                                                gc, uc))
        table["K10"] = ("dgamma", lambda p: on(eft.energy_t_bwd(ws, bs, g, ct,
                                                                p)),
                        lambda p, w=ws, b=bs, c0=0, c1=X:
                        eft.energy_t_bwd_plain(w, b, gc, cc, p), None)
    return table


def big_kernels(ef, rec, table, ws, bs, rungs, launches):
    """Each kernel of ``table`` at each rung: twice (bitwise) against its
    plain version (shape_kernel_check), in ``launches`` launches a call (X
    slices times spline ranges; None: not counted), with the two exceptions
    above (BIG_BF16_E, SLICED_CHAIN).  Fails on the first disagreement."""
    import torch

    sliced = len(ef.x_slices(ws, bs)) > 1
    for kname, (kind, fn, fn_p, truth) in table.items():
        for prec in rungs:
            ef.reset_launch_counts()
            got = fn(prec)
            n_launched = sum(ef.LAUNCHES.values())
            again = fn(prec)
            if kind == "dgamma" and sliced and prec != "float32":
                ref = ef.sum_slices(ws, bs, lambda w, b, c0, c1: fn_p(
                    prec, w, b, c0, c1))
            else:
                ref = fn_p(prec)
            ok, f = shape_kernel_check(kind, got, again, ref, prec)
            if truth is not None and prec == "bfloat16":
                t = truth()
                for key, x in (("vs_float64", got), ("plain_vs_float64", ref)):
                    rel = (x.double() - t).abs() / t.abs()
                    f[key + "_max_rel"] = float(rel.max())
                    f[key + "_median_rel"] = float(rel.median())
                if (rec["case"], kname) in BIG_BF16_E:
                    ok = (f["repeat_bitwise"]
                          and bool(torch.isfinite(got).all())
                          and f["energy_max_rel"] <= BIG_BF16_E_RTOL
                          and all(f[f"vs_float64_{k}_rel"] <= K2_M1_FLOAT64
                                  * f[f"plain_vs_float64_{k}_rel"]
                                  for k in ("max", "median")))
            if kind == "dgamma" and sliced and prec != "float32":
                f32, whole = fn_p("float32"), fn_p(prec)
                f["vs_whole_chain"] = dgamma_stats(got, whole)   # a reading
                f["vs_float32"] = dgamma_stats(got, f32)
                f["whole_chain_vs_float32"] = dgamma_stats(whole, f32)
                ok = ok and all(
                    f["vs_float32"][f"dgamma_rel_{k}"] <= SLICED_CHAIN
                    * f["whole_chain_vs_float32"][f"dgamma_rel_{k}"]
                    for k in ("median", "p99"))
            f["launches_per_call"] = n_launched
            rec.setdefault(kname, {})[prec] = f
            if launches is not None and n_launched != launches:
                emit(rec)
                fail(f"big: {kname} at {rec['case']} {prec}: {n_launched} "
                     f"launches a call, expected {launches}")
            if not ok:
                emit(rec)
                fail(f"big: {kname} at {rec['case']} {prec} disagrees with "
                     "its plain version or is not repeated bitwise")


def big_phase(params, art, cfg, dev, ef, mc, eft):
    """Phase big (a) and (b): records of the kernels and of the optimizer
    runs; fails on a disagreement."""
    import torch

    from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    out = []
    on_card = dev.type == "cuda"   # (the CPU runs the plain versions)
    # (a) other shapes, every rung
    rng = np.random.default_rng(2)

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    for case, dims in (("big", BIG_DIMS), ("wide", BIG_WIDE)):
        ws, bs = big_decoders(dims, dev)
        T, B, M, X = BIG_T, BIG_B, BIG_M, dims[-1]
        g = rnd(T, B, dims[0])
        ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                             device=dev)
        counts = torch.as_tensor(rng.integers(1, M + 1, B))
        wmb = ef.active_weights(counts, M, B, dev).contiguous()
        cts = [rnd(T, B, X), rnd(T, B, X), rnd(T, B)]
        planes = mc.sample_decoder_indices(
            torch.Generator(device=dev).manual_seed(5), T, B, M, MC_SAMPLES,
            counts.to(dev))
        kmax = torch.full((B,), float(M), device=dev)
        rec = {"phase": "big", "case": case, "dims": list(dims), "M": M,
               "T": T, "B": B}
        table = big_kernel_table(ef, mc, eft, ws, bs, g, wmb, ct, cts, planes,
                                 kmax, len(dims) == 4)
        big_kernels(ef, rec, table, ws, bs, ef.PRECISIONS,
                    len(ef.x_slices(ws, bs)) if on_card else None)
        emit(rec)
        out.append(rec)
    # (b) the whole matrix as one chunk: kernels
    ws, bs = ef.stack_weights(params.decoders)
    M, T, B = ws[0].shape[0], cfg.energy.num_t, WHOLE_B
    X = ws[-1].shape[-1]
    reps = np.arange(B) % len(art)
    tiled = SplineBatchArtifact(**{
        **{f.name: getattr(art, f.name)
           for f in dataclasses.fields(SplineBatchArtifact)},
        "a": art.a[reps], "b": art.b[reps],
        "omega_init": art.omega_init[reps],
        "pair_indices": art.pair_indices[reps], "valid": art.valid[reps],
        "pair_labels": [art.pair_labels[i] for i in reps]})
    from vae_latent_geometry_tpu_torch.geometry.spline import (
        design_matrix, eval_spline_design, t_grid)

    t = t_grid(T, dev)
    phi = design_matrix(t, art.basis, art.n_poly)
    g = eval_spline_design(
        torch.as_tensor(tiled.omega_init, device=dev),
        torch.as_tensor(tiled.a, device=dev),
        torch.as_tensor(tiled.b, device=dev), phi, t).contiguous()
    ct = torch.linspace(0.5, 2.0, B, device=dev)
    wmb = ef.uniform_weights(M, B, dev)
    cts = list(smooth_cotangents(T, B, X, dev, seed=11))
    planes = mc.sample_decoder_indices(
        torch.Generator(device=dev).manual_seed(5), T, B, M, MC_SAMPLES, None)
    kmax = torch.full((B,), float(M), device=dev)
    rec = {"phase": "big", "case": "whole", "T": T, "B": B, "M": M,
           "splines": list(WHOLE_TAKE),
           "spline_ranges": ef.spline_ranges(T, B, [2, 128, 128, X])}
    table = big_kernel_table(ef, mc, eft, ws, bs, g, wmb, ct, cts, planes,
                             kmax, True, WHOLE_TAKE)
    big_kernels(ef, rec, table, ws, bs, ("float32", "f32x2"),
                len(rec["spline_ranges"]) if on_card else None)
    emit(rec)
    out.append(rec)
    del table, cts, planes, g
    torch.cuda.empty_cache()
    # (b) the whole matrix as one chunk: the optimizer, fused and plain
    take = np.asarray(WHOLE_TAKE)
    few = SplineBatchArtifact(**{
        **{f.name: getattr(tiled, f.name)
           for f in dataclasses.fields(SplineBatchArtifact)},
        "a": tiled.a[take], "b": tiled.b[take],
        "omega_init": tiled.omega_init[take],
        "pair_indices": tiled.pair_indices[take], "valid": tiled.valid[take],
        "pair_labels": [tiled.pair_labels[i] for i in take]})
    rec = {"phase": "big", "case": "whole_optimize", "T": T, "B": B,
           "steps": WHOLE_STEPS, "steps_per_s": {}, "launches": {},
           "len_rel_max": {}}
    for fused, plain, limit in (("expected_fused", "expected", LEN_MAX),
                                ("mc_fused", "mc", MC_LEN_MAX)):
        lengths = {}
        for mode, batch, n in ((fused, tiled, B), (plain, few, len(take))):
            rcfg = dataclasses.replace(
                cfg, steps=WHOLE_STEPS, batch_size=n,
                energy=dataclasses.replace(cfg.energy, mode=mode,
                                           mc_samples=MC_SAMPLES))
            torch.cuda.synchronize()
            ef.reset_launch_counts()
            t0 = time.perf_counter()
            res = optimize_spline_batch(
                params, batch, cfg=rcfg, device=dev, log_every_chunk=False,
                generator=torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            if mode == fused:
                rec["steps_per_s"][mode] = WHOLE_STEPS / (
                    time.perf_counter() - t0)
                rec["launches"][mode] = {k: v for k, v in ef.LAUNCHES.items()
                                         if v}
            lengths[mode] = np.asarray(res.geodesic_length, np.float64)
        n = len(ef.spline_ranges(T, B, [2, 128, 128, X]))
        want = ({"energy_bwd": n * WHOLE_STEPS, "energy_fwd": n}
                if fused == "expected_fused" else
                {"energy_mc_bwd_rng": n * WHOLE_STEPS, "energy_mc_fwd_rng": n})
        if on_card and rec["launches"][fused] != want:
            emit(rec)
            fail(f"big: {fused} at B={B} launched {rec['launches'][fused]}, "
                 f"expected {want}")
        mine = lengths[fused][take]
        rel = np.abs(mine / lengths[plain] - 1)
        rec["len_rel_max"][fused] = float(rel.max())
        if not (np.isfinite(lengths[fused]).all() and rel.max() <= limit):
            emit(rec)
            fail(f"big: {fused} at B={B}: lengths of splines {WHOLE_TAKE} "
                 f"{rel.max():.3g} from the {plain} mode's (limit {limit})")
        del lengths
        torch.cuda.empty_cache()
    emit(rec)
    out.append(rec)
    return out


# Training and the optimizer's checkpoints (the seeded surrogate, 23,822 x
# 50; ModelConfig's full widths: encoder 50-256-128-4, ten decoders
# 2-128-128-50).  ``train``: TRAIN_EPOCHS epochs of the EVAE at batch 64
# uninterrupted, against TRAIN_EPOCHS_CUT epochs then a resume to
# TRAIN_EPOCHS: losses and parameters bit for bit; the first TRAIN_CPU_STEPS
# per-batch losses against the port on the CPU with the same draws
# (TRAIN_CPU_RTOL: the card's products round in another order).
TRAIN_EPOCHS = 4
TRAIN_EPOCHS_CUT = 2
TRAIN_CPU_STEPS = 20
TRAIN_CPU_RTOL = 1e-4
TRAIN_SEEDS = (12, 123)
MULTI_EPOCHS = 2
# Multiseed against serial runs: bit for bit on the CPU, not on the card:
# cuBLAS multiplies a batch of one through its plain gemm and a batch of two
# or more through other kernels (tools/bmm_batch_probe.py), and
# the rounding difference grows along the trajectory (5.66e-5 of the loss
# after 2 epochs on seed 12, measured on the H100).
MULTI_LOSS_RTOL = 1e-4
SINGLE_EPOCHS = 3
# ``train_cov``: the two multiseed models, written and reloaded, each
# through run_distance_pipeline (COV_TRAIN_LABELS classes, 45 pairs,
# COV_TRAIN_STEPS steps of expected_fused at f32x2), then the cross-seed CoV
# of the two matrices and cov_analysis on model 12's pairs.
COV_TRAIN_LABELS = 10
COV_TRAIN_STEPS = 100
# ``resume``: the seed-42 init blob (190 pairs) in chunks of RESUME_CHUNK,
# RESUME_STEPS steps of the main path's mode, interrupted after two chunks.
RESUME_CHUNK = 50
RESUME_STEPS = 100
# ``backstop``: the cut turbo plan of mc_coarse_bf16 against the fixed
# recipe at BACKSTOP_STEPS steps.
BACKSTOP_STEPS = 200


def _same_trees(a, b) -> bool:
    from vae_latent_geometry_tpu_torch.io.checkpoint import tree_leaves

    return all(bool((x == y).all()) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))


def _max_tree_diff(a, b) -> float:
    from vae_latent_geometry_tpu_torch.io.checkpoint import tree_leaves

    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _first_steps(dev, data, n_steps):
    """The first ``n_steps`` per-batch losses of ``train_evae`` at the
    default config on ``dev`` (the same draws on every device)."""
    import torch

    from vae_latent_geometry_tpu_torch.config import ModelConfig, TrainConfig
    from vae_latent_geometry_tpu_torch.models import evae
    from vae_latent_geometry_tpu_torch.pipeline import train as tr

    cfg, mcfg = TrainConfig(), ModelConfig()
    params = tr._init(lambda g, d: evae.evae_init(g, mcfg, d), [cfg.seed],
                      dev)
    train_x, val_x = tr._splits(data, [cfg.seed], cfg, dev)
    run = tr._Run(params, cfg.lr, track_best=False, batched=False)
    d = tr.epoch_draws([cfg.seed], 0, train_x.shape[1], val_x.shape[1],
                       cfg.batch_size, mcfg.latent_dim, mcfg.num_decoders)
    bs, out = cfg.batch_size, []
    for i in range(n_steps):
        step = tr.EpochDraws(perm=d.perm[:, i * bs:(i + 1) * bs],
                             eps=d.eps[:, i:i + 1], idx=d.idx[:, i:i + 1],
                             val_eps=d.val_eps[:, :1],
                             val_idx=d.val_idx[:, :1])
        tl, _ = tr.train_epoch(tr._evae_loss(mcfg), run.params, run.opt,
                               run.opt_state, train_x, val_x, step, 1.0)
        out.append(float(tl[0]))
    return np.asarray(out)


def train_phases(dev):
    """Phases train, train_multiseed, train_single: the port's trainers at
    full width on the card.  Returns (records, {seed: model params})."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_latent_geometry_tpu_torch.config import ModelConfig, TrainConfig
    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
    from vae_latent_geometry_tpu_torch.models import evae
    from vae_latent_geometry_tpu_torch.models.vae import LEGACY_CONFIG
    from vae_latent_geometry_tpu_torch.pipeline import train as tr

    data = load_tasic()
    if not data.synthetic:
        fail("train phases: a data directory was found; they are defined on "
             "the seeded surrogate")
    x = data.x
    mcfg = ModelConfig()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    recs = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # train: uninterrupted, against cut + resumed
    cfg = TrainConfig(epochs=TRAIN_EPOCHS)
    full, secs = timed(lambda: tr.train_evae(x, cfg, mcfg, log_every=0,
                                             block_epochs=1, device=dev))
    state = os.path.join(tmp, "train_state.npz")
    tr.train_evae(x, dataclasses.replace(cfg, epochs=TRAIN_EPOCHS_CUT), mcfg,
                  log_every=0, block_epochs=1, checkpoint_path=state,
                  device=dev)
    resumed = tr.train_evae(x, cfg, mcfg, log_every=0, block_epochs=1,
                            checkpoint_path=state, device=dev)
    n_train = len(x) - int(cfg.val_ratio * len(x))
    spe = n_train // cfg.batch_size
    card_first = _first_steps(dev, x, TRAIN_CPU_STEPS)
    cpu_first = _first_steps(torch.device("cpu"), x, TRAIN_CPU_STEPS)
    rel = np.abs(card_first / cpu_first - 1)
    # the device's busy share over PROFILE_STEPS steps of an epoch
    params = tr._init(lambda g, d: evae.evae_init(g, mcfg, d), [cfg.seed],
                      dev)
    train_x, val_x = tr._splits(x, [cfg.seed], cfg, dev)
    run = tr._Run(params, cfg.lr, track_best=False, batched=False)
    d = tr.epoch_draws([cfg.seed], 0, n_train, val_x.shape[1],
                       cfg.batch_size, mcfg.latent_dim, mcfg.num_decoders)
    d = tr.EpochDraws(perm=d.perm, eps=d.eps[:, :PROFILE_STEPS],
                      idx=d.idx[:, :PROFILE_STEPS], val_eps=d.val_eps[:, :1],
                      val_idx=d.val_idx[:, :1])
    loss_fn = tr._evae_loss(mcfg)
    tr.train_epoch(loss_fn, run.params, run.opt, run.opt_state, train_x,
                   val_x, d, 1.0)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.train_epoch(loss_fn, run.params, run.opt, run.opt_state, train_x,
                       val_x, d, 1.0)
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    by, span = device_kernel_times(prof)
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    rec = {"phase": "train", "model": "EVAE 50-256-128-4, 10 x 2-128-128-50",
           "rows": len(x), "batch_size": cfg.batch_size,
           "steps_per_epoch": spe, "epochs": TRAIN_EPOCHS,
           "train_s": secs, "steps_per_s": TRAIN_EPOCHS * spe / secs,
           "epochs_per_s": TRAIN_EPOCHS / secs,
           "train_losses": full.train_losses.tolist(),
           "val_losses": full.val_losses.tolist(),
           "loss_falls": bool(full.train_losses[-1] < full.train_losses[0]),
           "finite": bool(np.isfinite(full.train_losses).all()
                          and np.isfinite(full.val_losses).all()),
           "resume_losses_bitwise": bool(
               np.array_equal(resumed.train_losses, full.train_losses)
               and np.array_equal(resumed.val_losses, full.val_losses)),
           "resume_params_bitwise": _same_trees(resumed.params, full.params),
           "resume_params_max_abs": _max_tree_diff(resumed.params,
                                                   full.params),
           "first_steps_vs_cpu_rel_max": float(rel.max()),
           "first_steps_card": card_first.tolist(),
           "profile_steps": PROFILE_STEPS,
           "profile_wall_ms_per_step": 1e3 * prof_wall / PROFILE_STEPS,
           "device_busy_ms_per_step": busy / 1e3 / PROFILE_STEPS,
           "device_busy_share_of_span": busy / span if span else None,
           "n_kernel_launches_per_step": sum(
               1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
           / PROFILE_STEPS,
           "kernels_ms": {k[:80]: v / 1e3 for k, v in top}}
    emit(rec)
    recs["train"] = rec

    # train_multiseed: two seeds in one program against their serial runs
    mcfg_s = dataclasses.replace(cfg, epochs=MULTI_EPOCHS)
    multi, msecs = timed(lambda: tr.train_evae_multiseed(
        x, TRAIN_SEEDS, mcfg_s, mcfg, log_every=0, device=dev))
    serial, ssecs = timed(lambda: {s: tr.train_evae(
        x, dataclasses.replace(mcfg_s, seed=s), mcfg, log_every=0,
        device=dev) for s in TRAIN_SEEDS})
    diff = {s: float(np.abs(multi[s].train_losses / serial[s].train_losses
                            - 1).max()) for s in TRAIN_SEEDS}
    rec = {"phase": "train_multiseed", "seeds": list(TRAIN_SEEDS),
           "epochs": MULTI_EPOCHS, "multiseed_s": msecs, "serial_s": ssecs,
           "steps_per_s_per_seed": MULTI_EPOCHS * spe * len(TRAIN_SEEDS)
           / msecs,
           "serial_steps_per_s": MULTI_EPOCHS * spe * len(TRAIN_SEEDS)
           / ssecs,
           "losses_bitwise": {s: bool(
               np.array_equal(multi[s].train_losses, serial[s].train_losses)
               and np.array_equal(multi[s].val_losses, serial[s].val_losses))
               for s in TRAIN_SEEDS},
           "params_bitwise": {s: _same_trees(multi[s].params,
                                             serial[s].params)
                              for s in TRAIN_SEEDS},
           "train_loss_rel_max": diff,
           "params_max_abs": {s: _max_tree_diff(multi[s].params,
                                                serial[s].params)
                              for s in TRAIN_SEEDS},
           "train_losses": {s: multi[s].train_losses.tolist()
                            for s in TRAIN_SEEDS},
           "seeds_differ": bool(not np.allclose(
               multi[TRAIN_SEEDS[0]].train_losses,
               multi[TRAIN_SEEDS[1]].train_losses))}
    emit(rec)
    recs["train_multiseed"] = rec

    # train_single: the legacy VAE with warm-up, step lr and best-val
    scfg = TrainConfig(epochs=SINGLE_EPOCHS, seed=12, beta_warmup_epochs=30,
                       lr_step_size=200, lr_gamma=0.5)
    single, ssecs = timed(lambda: tr.train_single_vae(
        x, scfg, LEGACY_CONFIG, log_every=0, device=dev))
    rec = {"phase": "train_single", "epochs": SINGLE_EPOCHS, "train_s": ssecs,
           "steps_per_s": SINGLE_EPOCHS * spe / ssecs,
           "train_losses": single.train_losses.tolist(),
           "val_losses": single.val_losses.tolist(),
           "best_val_loss": single.best_val_loss,
           "best_is_min": bool(single.best_val_loss
                               == np.float32(single.val_losses.min())),
           "finite": bool(np.isfinite(single.train_losses).all())}
    emit(rec)
    recs["train_single"] = rec
    shutil.rmtree(tmp, ignore_errors=True)

    r = recs["train"]
    if not (r["finite"] and r["loss_falls"]):
        fail(f"train: losses {r['train_losses']} not finite or not falling")
    if not (r["resume_losses_bitwise"] and r["resume_params_bitwise"]):
        fail(f"train: the resumed run differs from the uninterrupted one "
             f"(params max abs {r['resume_params_max_abs']:.3g})")
    if not r["first_steps_vs_cpu_rel_max"] <= TRAIN_CPU_RTOL:
        fail(f"train: first steps vs the CPU "
             f"{r['first_steps_vs_cpu_rel_max']:.3g} > {TRAIN_CPU_RTOL}")
    r = recs["train_multiseed"]
    if not (r["seeds_differ"] and all(
            v <= MULTI_LOSS_RTOL for v in r["train_loss_rel_max"].values())):
        fail(f"train_multiseed: seeds equal or far from their serial runs "
             f"{r['train_loss_rel_max']}")
    r = recs["train_single"]
    if not (r["finite"] and r["best_is_min"]
            and r["train_losses"][-1] < r["train_losses"][0]):
        fail("train_single: losses not finite or not falling, or the best "
             "val loss is not the curve's minimum")
    return recs, {s: multi[s].params for s in TRAIN_SEEDS}


def train_cov_phase(models, dev, ef):
    """The trained models written with the port's writer and reloaded, each
    through ``run_distance_pipeline``; the two matrices' cross-seed CoV and
    ``cov_analysis`` on the first model's pairs."""
    import tempfile

    import torch

    from vae_latent_geometry_tpu_torch.config import (
        EnergyConfig, GeodesicConfig, ModelConfig, to_dict)
    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
    from vae_latent_geometry_tpu_torch.io.checkpoint import save_pytree
    from vae_latent_geometry_tpu_torch.models import evae
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import (
        compute_cov, cov_analysis)
    from vae_latent_geometry_tpu_torch.pipeline.full_run import (
        run_distance_pipeline)

    data = load_tasic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cov_")
    loaded = {}
    for s, p in models.items():
        path = os.path.join(tmp, f"model_seed{s}.npz")
        save_pytree(p, path, extra_meta={
            "seed": s, "model_config": to_dict(ModelConfig())})
        loaded[s] = evae.load_npz(path, dev)
    same = all(_same_trees(loaded[s], models[s]) for s in models)
    geo = GeodesicConfig(steps=COV_TRAIN_STEPS, batch_size=45,
                         energy=EnergyConfig(mode="expected_fused",
                                             kernel_precision="f32x2"))
    runs = {}
    torch.cuda.synchronize()
    ef.reset_launch_counts()
    t0 = time.perf_counter()
    for s, p in loaded.items():
        runs[s] = run_distance_pipeline(p, data.x, data.labels,
                                        max_labels=COV_TRAIN_LABELS,
                                        geo_cfg=geo, verbose=False,
                                        device=dev)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = dict(ef.LAUNCHES)
    s0, s1 = models
    mats = np.stack([runs[s].matrix for s in models])
    off = ~np.eye(mats.shape[1], dtype=bool)
    cov = compute_cov(mats[:, off], axis=0)
    pairs = [tuple(r) for r in runs[s0].artifact.pair_indices]
    res = cov_analysis([loaded[s] for s in models], list(models), data.x,
                       pairs, decoder_counts=tuple(range(1, 11)),
                       steps=COV_TRAIN_STEPS, num_t=2000,
                       mode="expected_fused", kernel_precision="f32x2",
                       device=dev)
    rec = {"phase": "train_cov", "seeds": list(models),
           "reloaded_equal": same, "pairs": len(pairs),
           "labels_equal": runs[s0].labels == runs[s1].labels,
           "pipeline_s": pipe_s, "launches": launches,
           "matrices_finite": bool(np.isfinite(mats).all()),
           "matrix_cov_mean": float(cov.mean()),
           "matrix_cov_max": float(cov.max()),
           "cov_analysis_geodesic": res.avg_cov_geodesic,
           "cov_analysis_euclidean": res.avg_cov_euclidean,
           "cov_analysis_finite": bool(np.isfinite(res.lengths).all())}
    emit(rec)
    shutil.rmtree(tmp, ignore_errors=True)
    n_valid = sum(int(runs[s].artifact.valid.sum()) for s in models)
    if not (same and rec["labels_equal"] and rec["matrices_finite"]
            and np.isfinite(cov).all() and rec["cov_analysis_finite"]):
        fail("train_cov: reload, labels or values malformed")
    if not (cov.max() > 0 and max(res.avg_cov_geodesic.values()) > 0):
        fail("train_cov: every CoV is zero: the two models are one model")
    if launches.get("energy_bwd", 0) != COV_TRAIN_STEPS * len(models) \
            or n_valid == 0:
        fail(f"train_cov: launches {launches}")
    return rec


def resume_phase(params, art, cfg, dev, ef):
    """The optimize stage interrupted after two chunks resumes to the
    uninterrupted artifact bit for bit; a foreign stamp is ignored (the run
    recomputes every chunk)."""
    import tempfile

    import torch

    from vae_latent_geometry_tpu_torch.io.artifacts import (
        load_spline_batch, save_spline_batch)
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    path = os.path.join(tmp, "opt.npz")
    rcfg = dataclasses.replace(cfg, steps=RESUME_STEPS,
                               batch_size=RESUME_CHUNK)

    def run(ckpt):
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        out = optimize_spline_batch(params, art, cfg=rcfg, device=dev,
                                    checkpoint_path=ckpt,
                                    log_every_chunk=False)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(ef.LAUNCHES)

    full, full_s, full_l = run(path)
    written = load_spline_batch(path)
    cut = 2 * RESUME_CHUNK
    omega = np.array(written.omega_optimized)
    omega[cut:] = art.omega_init[cut:]
    glen = np.array(written.geodesic_length)
    glen[cut:] = np.nan
    save_spline_batch(dataclasses.replace(
        written, omega_optimized=omega, geodesic_length=glen), path)
    resumed, res_s, res_l = run(path)
    file_bitwise = bool(np.array_equal(
        load_spline_batch(path).geodesic_length, full.geodesic_length))
    foreign = dict(written.metadata, steps=RESUME_STEPS + 1)
    save_spline_batch(dataclasses.replace(
        written, omega_optimized=omega, geodesic_length=glen,
        metadata=foreign), path)
    redo, redo_s, redo_l = run(path)
    n_chunks = -(-len(art) // RESUME_CHUNK)
    rec = {"phase": "resume", "pairs": len(art), "chunk": RESUME_CHUNK,
           "chunks": n_chunks, "steps": RESUME_STEPS,
           "full_s": full_s, "resumed_s": res_s, "foreign_s": redo_s,
           "launches_full": full_l, "launches_resumed": res_l,
           "launches_foreign": redo_l,
           "resumed_bitwise": bool(
               np.array_equal(resumed.omega_optimized, full.omega_optimized)
               and np.array_equal(resumed.geodesic_length,
                                  full.geodesic_length,
                                  equal_nan=True)),
           "resumed_file_bitwise": file_bitwise,
           "foreign_recomputed_bitwise": bool(np.array_equal(
               redo.omega_optimized, full.omega_optimized))}
    emit(rec)
    shutil.rmtree(tmp, ignore_errors=True)
    if not (rec["resumed_bitwise"] and rec["resumed_file_bitwise"]
            and rec["foreign_recomputed_bitwise"]):
        fail("resume: the resumed or recomputed artifact differs from the "
             "uninterrupted one")
    want = {"full": n_chunks, "resumed": n_chunks - 2, "foreign": n_chunks}
    for tag, got in (("full", full_l), ("resumed", res_l),
                     ("foreign", redo_l)):
        if (got["energy_bwd"] != RESUME_STEPS * want[tag]
                or got["energy_fwd"] != want[tag]):
            fail(f"resume: {tag} run launched {got}, expected "
                 f"{want[tag]} chunks")
    return rec


def early_stop_phase(params, art, cfg, dev, ef, main_lengths):
    """Early stopping at the production chunk (B=200, T=2000, f32x2,
    budget STEPS), both arms evaluating the energy at the trajectory rung
    on every step: ``expected_fused`` (K1 and K2 a step; the restored omega
    re-evaluated at that rung gives the tracked best energy bit for bit)
    and ``mc_fused`` with in-kernel draws (K7 and K8 a step, final energies
    by ``expected_fused``; the same seed twice gives the same omega and
    steps run bit for bit; the re-evaluation of the restored omega draws
    with another seed, so the bitwise energy check is the expected arm's
    only).  Steps run, launches, steps/s, lengths against phase main.
    Returns {arm: record}."""
    import torch

    from vae_latent_geometry_tpu_torch.optim.geodesic import (
        _traj_cfg, make_loss_fn, optimize_spline_early_stopping)

    B = cfg.batch_size
    idx = np.concatenate([np.arange(len(art)),
                          np.full(B - len(art), len(art) - 1)])
    ecfg = dataclasses.replace(cfg, early_stop=True)
    mc_ecfg = dataclasses.replace(
        ecfg, final_energy_mode="expected_fused",
        energy=dataclasses.replace(cfg.energy, mode="mc_fused",
                                   mc_samples=MC_SAMPLES,
                                   mc_inkernel_rng=True))

    def run(run_cfg):
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        res = optimize_spline_early_stopping(
            params.decoders, art.omega_init[idx], art.a[idx], art.b[idx],
            art.basis, run_cfg, device=dev,
            generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(ef.LAUNCHES)

    recs = {}
    for arm, run_cfg in (("expected_fused", ecfg), ("mc_fused", mc_ecfg)):
        res, secs, launches = run(run_cfg)
        lengths = res.lengths.double().cpu().numpy()[:len(art)]
        rel = np.abs(lengths / main_lengths - 1)
        rec = {"phase": "early_stop", "mode": arm,
               "precision": "f32x2", "B": B, "T": cfg.energy.num_t,
               "budget": run_cfg.steps, "patience": run_cfg.patience,
               "delta": run_cfg.delta, "steps_run": res.steps_run,
               "optimize_s": secs, "steps_per_s": res.steps_run / secs,
               "launches": launches,
               "lengths_finite": bool(np.isfinite(lengths).all()),
               "vs_main_len_rel_median": float(np.median(rel)),
               "vs_main_len_rel_max": float(rel.max())}
        if arm == "expected_fused":
            with torch.no_grad():
                _, e_again = make_loss_fn(params.decoders, art.basis,
                                          _traj_cfg(run_cfg), dev)(
                    res.omega, torch.as_tensor(art.a[idx], device=dev),
                    torch.as_tensor(art.b[idx], device=dev))
            rec["restored_energy_bitwise"] = bool(torch.equal(
                e_again, res.traj_energy))
            # K1 at the start, every step and at float32 at the end
            want = {"energy_fwd": res.steps_run + 2,
                    "energy_bwd": res.steps_run}
        else:
            again, _, _ = run(run_cfg)
            rec["repeat_bitwise"] = bool(
                again.steps_run == res.steps_run
                and torch.equal(again.omega, res.omega)
                and torch.equal(again.traj_energy, res.traj_energy))
            # K7 at the start and every step, K8 every step, K1 at float32
            # at the end
            want = {"energy_mc_fwd_rng": res.steps_run + 1,
                    "energy_mc_bwd_rng": res.steps_run, "energy_fwd": 1}
        emit(rec)
        if not rec["lengths_finite"]:
            fail(f"early_stop {arm}: lengths not finite")
        if not rec.get("restored_energy_bitwise", True):
            fail("early_stop: the restored omega does not give the tracked "
                 "best energy")
        if not rec.get("repeat_bitwise", True):
            fail("early_stop mc_fused: the same seed did not repeat the run "
                 "bit for bit")
        if arm == "mc_fused" and (
                rec["vs_main_len_rel_median"] > MC_LEN_MED
                or rec["vs_main_len_rel_max"] > MC_LEN_MAX):
            fail(f"early_stop mc_fused: lengths vs phase main: median "
                 f"{rec['vs_main_len_rel_median']:.3g}, max "
                 f"{rec['vs_main_len_rel_max']:.3g}")
        for name, count in launches.items():
            if count != want.get(name, 0):
                fail(f"early_stop {arm}: {name} launched {count} times, "
                     f"expected {want.get(name, 0)}")
        recs[arm] = rec
    return recs


def backstop_phase(params, art, cfg, dev, ef):
    """The cut turbo plan against the fixed recipe at BACKSTOP_STEPS steps,
    merged per pair, at expected_fused and at mc_fused: the merge is never
    above either arm; each arm's wins."""
    import tempfile

    import torch

    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch_backstop)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_backstop_")
    recs = {}
    for mode in ("expected_fused", "mc_fused"):
        fixed = dataclasses.replace(
            cfg, steps=BACKSTOP_STEPS, energy=dataclasses.replace(
                cfg.energy, mode=mode))
        plan = dataclasses.replace(fixed, phase_plan=MC_COARSE_PLAN)
        path = os.path.join(tmp, f"{mode}.npz")
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        merged = optimize_spline_batch_backstop(
            params, art, cfg=plan, backstop_cfg=fixed, device=dev,
            checkpoint_path=path, log_every_chunk=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        arms = {a: load_spline_batch(os.path.join(tmp, f"{mode}.{a}.npz"))
                for a in ("primary", "backstop")}
        l1 = np.asarray(arms["primary"].geodesic_length, np.float64)
        l2 = np.asarray(arms["backstop"].geodesic_length, np.float64)
        lm = np.asarray(merged.geodesic_length, np.float64)
        rec = {"phase": "backstop", "mode": mode, "pairs": len(art),
               "plan": [list(p) for p in MC_COARSE_PLAN],
               "fixed_steps": BACKSTOP_STEPS, "seconds": secs,
               "launches": dict(ef.LAUNCHES),
               "final_energy_mode": json.loads(
                   merged.metadata["recipe"])["final_energy_mode"],
               "plan_wins": int((l1 < l2).sum()),
               "fixed_wins": int((l2 < l1).sum()),
               "ties": int((l1 == l2).sum()),
               "backstop_selected": merged.metadata["backstop_selected"],
               "never_worse": bool((lm <= l1).all() and (lm <= l2).all()),
               "finite": bool(np.isfinite(lm).all()),
               "len_mean": {"merged": float(lm.mean()),
                            "plan": float(l1.mean()),
                            "fixed": float(l2.mean())}}
        emit(rec)
        recs[mode] = rec
        if not (rec["never_worse"] and rec["finite"]):
            fail(f"backstop {mode}: the merge is above an arm on some pair")
        if rec["final_energy_mode"] != (None if mode == "expected_fused"
                                        else "expected_fused"):
            fail(f"backstop {mode}: final energies by "
                 f"{rec['final_energy_mode']}")
    shutil.rmtree(tmp, ignore_errors=True)
    return recs


# Phase golden: the reference's single-decoder reproduction on the
# reference-shaped tree of tools/golden_tree.py, through the CLI, at the
# golden recipe (single_fused, f32x3, 500 steps, T=2000, batch 500, all
# 8,778 pairs).
GOLDEN_SEED = 12
GOLDEN_STEPS = 500
GOLDEN_BATCH = 500
GOLDEN_T = 2000
JAX_GOLDEN = os.path.join(ROOT, "tools", "jax_reference_golden_seed12.json")
GOLDEN_PATH_SHARE = 0.05    # pairs whose Dijkstra path differs, left out
GOLDEN_STATS_RTOL = 1e-3    # matrix_stats on the tool's pairs vs the tool's
# Phase plot: the device functions of the figures, card against the CPU
PLOT_PATH_POINTS = 300
PLOT_GRID = 200
PLOT_RTOL = 1e-5
PLOT_KINDS = ("density", "uncertainty", "latents", "splines", "illustration")


def run_cli(argv):
    """The port's CLI in this process: (exit code, standard output)."""
    import contextlib
    import io

    from vae_latent_geometry_tpu_torch import cli

    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(argv)
        except SystemExit as ex:    # sys.exit(n), or a refusal's message
            code = ex.code if isinstance(ex.code, int) else int(
                ex.code is not None)
            if isinstance(ex.code, str):
                print(ex.code)
    return code, buf.getvalue()


def golden_phase(dev, ef):
    """CLI ``golden`` twice on the seeded reference-shaped tree: launches,
    the resume, lengths and statistics against the JAX package on the
    CPU, the cross-seed scale bar, and K2's time at M=1, f32x3, B=500."""
    import torch

    from tools.golden_tree import write_tree
    from vae_latent_geometry_tpu_torch.config import InitConfig
    from vae_latent_geometry_tpu_torch.geometry.spline import (
        design_matrix, eval_spline_design, t_grid)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.torch_import import (
        load_single_vae_mean_decoder)
    from vae_latent_geometry_tpu_torch.pipeline import golden as G
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import (
        distance_matrix)

    tmp = os.path.join(OUT_DIR, "golden")
    shutil.rmtree(tmp, ignore_errors=True)
    root = write_tree(os.path.join(tmp, "reference"))
    out_dir = os.path.join(tmp, "out")
    argv = ["golden", "--seed", str(GOLDEN_SEED), "--reference-root", root,
            "--output", out_dir, "--steps", str(GOLDEN_STEPS), "--num-t",
            str(GOLDEN_T), "--batch-size", str(GOLDEN_BATCH),
            "--energy-mode", "single_fused"]
    runs = []
    for _ in range(2):          # the second call resumes from the first's
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        code, text = run_cli(argv)
        wall = time.perf_counter() - t0
        if code != 0:
            fail(f"golden: the CLI exited {code}: {text[-2000:]}")
        report = json.loads(text[text.index("{"):])
        with open(os.path.join(
                out_dir, f"golden133_seed{GOLDEN_SEED}_matrix.json")) as f:
            mat = np.asarray(json.load(f)["distance_matrix"], np.float64)
        runs.append((report, dict(ef.LAUNCHES), mat, wall))
    (rep, launches, mat, wall), (rep2, launches2, mat2, wall2) = runs
    art = load_spline_batch(os.path.join(out_dir, G.checkpoint_name(
        GOLDEN_SEED, GOLDEN_STEPS, GOLDEN_T, GOLDEN_BATCH, "single_fused")))
    n_pairs = len(art)
    n_chunks = -(-n_pairs // GOLDEN_BATCH)
    lengths = np.asarray(art.geodesic_length, np.float64)

    # the first pairs against the JAX package on the CPU (same tree)
    with open(JAX_GOLDEN) as f:
        ref = json.load(f)
    P = ref["pairs"]
    latents = G.reference_latents(GOLDEN_SEED, root)
    paths, path_len = port_init_paths(latents, art.pair_indices[:P], None,
                                      InitConfig())
    same_path = np.array([
        int(n) == int(m) and paths[i, :n].tolist() == ref["paths"][i]
        for i, (n, m) in enumerate(zip(path_len, ref["path_len"]))])
    jax_len = np.asarray(ref["lengths"], np.float64)
    rel = np.abs(lengths[:P] / jax_len - 1)[same_path]

    def stats_on(values, keep):
        """matrix_stats of the first P pairs (``keep`` of them) against
        the stand-in golden, by the port's functions."""
        sub = dataclasses.replace(
            art, a=art.a[:P][keep], b=art.b[:P][keep],
            omega_init=art.omega_init[:P][keep],
            pair_indices=art.pair_indices[:P][keep],
            valid=art.valid[:P][keep],
            pair_labels=[l for l, k in zip(art.pair_labels[:P], keep) if k],
            omega_optimized=None, geodesic_length=values[keep],
            euclidean_distance=None)
        m, labels = distance_matrix(sub)
        return G.compare_to_golden(m, labels, GOLDEN_SEED, root)["vs_golden"]

    ours_stats = stats_on(lengths[:P], same_path)
    # the tool's own report, or both sides on the pairs whose paths agree
    ref_stats = (ref["report"]["vs_golden"] if same_path.all()
                 else stats_on(jax_len, same_path))
    stats_rel = {k: abs(ours_stats[k] / ref_stats[k] - 1)
                 for k in ours_stats if k not in ("n_common", "n_total")}

    # K2 at M=1, f32x3, B=500: the first chunk's init curves
    dec = load_single_vae_mean_decoder(
        os.path.join(root, "src", "artifacts",
                     f"vae_best_seed{GOLDEN_SEED}.pth"), dev)
    ws, bs = ef.stack_weights({"layers": [
        {k: v[None] for k, v in l.items()} for l in dec["layers"]]})
    t = t_grid(GOLDEN_T, dev)
    B = GOLDEN_BATCH
    gamma = eval_spline_design(
        torch.as_tensor(art.omega_init[:B], device=dev),
        torch.as_tensor(art.a[:B], device=dev),
        torch.as_tensor(art.b[:B], device=dev),
        design_matrix(t, art.basis, art.n_poly), t).contiguous()
    wmb = ef.uniform_weights(1, B, dev)
    ct = torch.ones(B, dtype=torch.float32, device=dev)
    g_k = ef.energy_bwd(ws, bs, gamma, wmb, ct, "f32x3")
    g_p = ef.energy_bwd_plain(ws, bs, gamma, wmb, ct, "f32x3")
    k2_ms = time_ms(lambda: ef.energy_bwd(ws, bs, gamma, wmb, ct, "f32x3"),
                    20)
    k2_plain_ms = time_ms(lambda: ef.energy_bwd_plain(ws, bs, gamma, wmb, ct,
                                                      "f32x3"), 3)
    # K2 at M=1 and a reduced rung is held to the float64 function, as in
    # phase shapes (K2_M1_FLOAT64): no farther from it than its plain version
    truth = float64_function(ef.energy_bwd_plain, ws, bs, gamma, wmb, ct)
    k2_f64 = dgamma_stats(g_k.double(), truth)
    plain_f64 = dgamma_stats(g_p.double(), truth)
    del truth
    D, H, X = gamma.shape[2], ws[1].shape[1], ws[2].shape[2]
    n_bytes = 4 * (2 * gamma.numel() + sum(w.numel() for w in ws)
                   + sum(b.numel() for b in bs) + 2 * B)
    k2_bound = rung_bound([D, H, H, X], GOLDEN_T * B, "f32x3", True,
                          n_bytes)
    cross = rep.get("golden_cross_seed_scale")
    opt_s = rep["seconds"]["optimize"]
    rec = {"phase": "golden", "pairs": n_pairs,
           "chunks": n_chunks,
           "steps": GOLDEN_STEPS, "num_t": GOLDEN_T, "batch": GOLDEN_BATCH,
           "mode": "single_fused", "kernel_precision": "f32x3",
           "seconds_by_stage": rep["seconds"], "cli_wall_s": wall,
           "steps_per_s": GOLDEN_STEPS * n_chunks / opt_s,
           "launches": launches,
           "resume_launches": launches2, "resume_wall_s": wall2,
           "resume_matrix_bitwise": bool(np.array_equal(mat, mat2,
                                                        equal_nan=True)),
           "lengths_finite": bool(np.isfinite(lengths[art.valid]).all()),
           "n_valid": int(art.valid.sum()),
           "matrix_shape": list(mat.shape),
           "vs_jax_cpu_pairs": P,
           "paths_differ": int((~same_path).sum()),
           "len_rel_median": float(np.median(rel)),
           "len_rel_max": float(rel.max()),
           "stats": ours_stats, "stats_jax": ref_stats,
           "stats_rel_max": max(stats_rel.values()),
           "vs_golden_standin": rep["vs_golden"],
           "cross_seed_scale": cross,
           "k2_M1_f32x3_B500_ms": k2_ms,
           "k2_M1_f32x3_B500_plain_ms": k2_plain_ms,
           "k2_M1_f32x3_B500_bound_ms": 1e3 * max(k2_bound),
           "k2_M1_f32x3_B500_bound_by":
               "operations" if k2_bound[0] >= k2_bound[1] else "bytes",
           "k2_M1_f32x3_B500_max_abs_err": float((g_k - g_p).abs().max()),
           "k2_M1_f32x3_B500_vs_plain": dgamma_stats(g_k, g_p),
           "k2_M1_f32x3_B500_vs_float64": k2_f64,
           "k2_M1_f32x3_B500_plain_vs_float64": plain_f64,
           "k2_M1_f32x3_B500_within_float64_rule": all(
               k2_f64[k] <= K2_M1_FLOAT64 * plain_f64[k] for k in k2_f64),
           "card": card_line()}
    emit(rec)
    want = {"energy_bwd": GOLDEN_STEPS * n_chunks, "energy_fwd": n_chunks}
    for name, count in launches.items():
        if count != want.get(name, 0):
            fail(f"golden: {name} launched {count} times, expected "
                 f"{want.get(name, 0)}")
    if any(launches2.values()):
        fail(f"golden: the resumed call launched kernels: {launches2}")
    if not rec["resume_matrix_bitwise"]:
        fail("golden: the resumed call's matrix differs from the first's")
    if not (rec["lengths_finite"] and mat.shape == (133, 133)):
        fail("golden: output malformed")
    if (~same_path).mean() > GOLDEN_PATH_SHARE:
        fail(f"golden: {int((~same_path).sum())} of {P} init paths differ "
             "from the JAX package's")
    if rec["len_rel_median"] > LEN_MED or rec["len_rel_max"] > LEN_MAX:
        fail(f"golden: lengths vs the JAX package on the CPU: median "
             f"{rec['len_rel_median']:.3g}, max {rec['len_rel_max']:.3g}")
    if (ours_stats["n_common"] != ref_stats["n_common"]
            or rec["stats_rel_max"] > GOLDEN_STATS_RTOL):
        fail(f"golden: matrix_stats vs the JAX package's: "
             f"{ours_stats} vs {ref_stats}")
    if cross is None or not all(np.isfinite(v) for v in cross.values()):
        fail(f"golden: cross-seed scale bar {cross}")
    if not rec["k2_M1_f32x3_B500_within_float64_rule"]:
        fail(f"golden: K2 at M=1 f32x3 B=500 farther from the float64 "
             f"function than K2_M1_FLOAT64 x its plain version's: "
             f"{rec['k2_M1_f32x3_B500_vs_float64']} vs "
             f"{rec['k2_M1_f32x3_B500_plain_vs_float64']}")
    return rec


def plot_phase(params, out_art, dev, cfg):
    """CLI ``plot`` (every kind) and ``eval --mode matrix`` on the seed-42
    model, the surrogate data and the main path's optimized artifact; the
    figures' device functions (``pullback_metrics`` along a path,
    ``kde_density`` on a grid) against the port on the CPU; the name of
    ``trace_annotation`` in a torch.profiler trace of one optimizer step."""
    import torch

    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
    from vae_latent_geometry_tpu_torch.io.artifacts import save_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import (
        decoder_member, encode)
    from vae_latent_geometry_tpu_torch.optim.geodesic import optimize_splines
    from vae_latent_geometry_tpu_torch.pipeline.select_pairs import save_pairs
    from vae_latent_geometry_tpu_torch.utils import trace_annotation
    from vae_latent_geometry_tpu_torch.utils.profiling import recording
    from vae_latent_geometry_tpu_torch.viz import plotting

    pdir = os.path.join(OUT_DIR, "plots")
    shutil.rmtree(pdir, ignore_errors=True)
    os.makedirs(pdir)
    splines = os.path.join(pdir, "main_opt.npz")
    save_spline_batch(out_art, splines)
    pairfile = os.path.join(pdir, "pairs.json")
    save_pairs(out_art.representatives, pairfile)
    have_mpl = plotting.matplotlib_available()
    figures, refusals = {}, {}
    for kind in PLOT_KINDS:
        png = os.path.join(pdir, f"{kind}.png")
        code, text = run_cli(["plot", kind, "--model", MODEL, "--splines",
                              splines, "--pairfile", pairfile, "--output",
                              png])
        figures[kind] = os.path.getsize(png) if os.path.exists(png) else 0
        if code != 0:
            refusals[kind] = text.strip().splitlines()[-1]
    mjson = os.path.join(pdir, "matrix.json")
    code, text = run_cli(["eval", "--mode", "matrix", "--splines", splines,
                          "--output", mjson])
    heatmap = mjson[:-5] + ".png"
    figures["eval_matrix_heatmap"] = (os.path.getsize(heatmap)
                                      if os.path.exists(heatmap) else 0)

    # device functions against the port on the CPU
    data = load_tasic()
    with torch.no_grad():
        latents = encode(params, torch.as_tensor(
            data.x, device=dev))[0].cpu().numpy()
    path = plotting._spline_points(out_art.omega_optimized[0], out_art.a[0],
                                   out_art.b[0], out_art.basis,
                                   out_art.n_poly, n=PLOT_PATH_POINTS)
    dec = decoder_member(params.decoders, 0)
    dec_cpu = {"layers": [{k: v.cpu() for k, v in l.items()}
                          for l in dec["layers"]]}
    G_gpu = plotting.pullback_metrics(dec, path)
    G_cpu = plotting.pullback_metrics(dec_cpu, path)
    scale = np.abs(G_cpu).max(axis=(1, 2), keepdims=True)
    g_rel = float((np.abs(G_gpu - G_cpu) / scale).max())
    xlim, ylim = plotting._square_limits(latents)
    xi, yi = np.mgrid[xlim[0]:xlim[1]:PLOT_GRID * 1j,
                      ylim[0]:ylim[1]:PLOT_GRID * 1j]
    grid = np.stack([xi.ravel(), yi.ravel()], axis=-1).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_gpu = plotting.kde_density(latents, grid, device=dev)
    kde_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    k_cpu = plotting.kde_density(latents, grid, device="cpu")
    kde_cpu_s = time.perf_counter() - t0
    pos = k_cpu > 0
    k_rel = float((np.abs(k_gpu - k_cpu)[pos] / k_cpu[pos]).max())

    # trace_annotation's range in a profiler trace of one optimizer step,
    # with the span recorder on
    name = "vlg.optimizer_step"
    one = dataclasses.replace(cfg, steps=1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with recording(), trace_annotation(name):
            optimize_splines(params.decoders, out_art.omega_init[:8],
                             out_art.a[:8], out_art.b[:8], out_art.basis,
                             one, device=dev)
        torch.cuda.synchronize()
    traced = any(e.key == name for e in prof.key_averages())
    rec = {"phase": "plot", "matplotlib": have_mpl, "figure_bytes": figures,
           "refusals": refusals, "eval_exit": code,
           "pullback_points": PLOT_PATH_POINTS, "pullback_rel_max": g_rel,
           "pullback_psd": bool((np.linalg.eigvalsh(G_gpu) > -1e-5).all()),
           "kde_grid": PLOT_GRID ** 2, "kde_latents": int(len(latents)),
           "kde_rel_max": k_rel, "kde_zero_points": int((~pos).sum()),
           "kde_card_s": kde_s, "kde_cpu_s": kde_cpu_s,
           "trace_annotation_in_trace": traced}
    emit(rec)
    if code != 0:
        fail(f"plot: eval --mode matrix exited {code}")
    if have_mpl:
        empty = [k for k, n in figures.items() if n == 0]
        if empty or refusals:
            fail(f"plot: no figure for {empty}; refusals {refusals}")
    elif not (len(refusals) == len(PLOT_KINDS) and all(
            "matplotlib" in r for r in refusals.values())):
        fail(f"plot: without matplotlib every kind must refuse by name: "
             f"{refusals}")
    if g_rel > PLOT_RTOL or k_rel > PLOT_RTOL or not rec["pullback_psd"]:
        fail(f"plot: card vs CPU: pullback {g_rel:.3g}, kde {k_rel:.3g}")
    if not traced:
        fail(f"plot: '{name}' not in the profiler trace")
    return rec


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
    t_build = time.perf_counter()
    build_by_source = _build.build_all()
    build_s = time.perf_counter() - t_build
    with open(os.path.join(OUT_DIR, "nvcc_build.log"), "w") as f:
        f.write("\n".join(_build.BUILD_LOG.values()))
    ptxas = [l.strip() for log in _build.BUILD_LOG.values()
             for l in log.splitlines() if "registers" in l or "spill" in l]
    hmma = sass_hmma(_build._target("energy_expected"), "k2_")
    k1_hmma = sass_hmma(_build._target("energy_expected"), "k1_")
    mc_hmma = sass_hmma(_build._target("energy_mc"), "mc_")
    stats_hmma = sass_hmma(_build._target("energy_stats"), "k[34]_")
    t_hmma = sass_hmma(_build._target("energy_transposed"), "k(?:1|9|10)_")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    emit({"phase": "build", "seconds": build_s,
          "seconds_by_source": build_by_source, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "ptxas": ptxas, "k2_sass_hmma": hmma,
          "k1_sass_hmma": k1_hmma, "mc_sass_hmma": mc_hmma,
          "stats_sass_hmma": stats_hmma, "transposed_sass_hmma": t_hmma,
          "fwd_fma_ptxas": {k: ptxas_of(_build.BUILD_LOG[src], k)
                            for src, k in FWD_FMA},
          "fwd_mma_ptxas": {k: ptxas_of(_build.BUILD_LOG[src], k)
                            for src, k in FWD_MMA},
          "transposed_mma_ptxas": {k: ptxas_of(_build.BUILD_LOG[
              "energy_transposed"], k) for k in T_MMA},
          "k2_onepass_ptxas": ptxas_of(_build.BUILD_LOG["energy_expected"],
                                       "k2_onepass_mma")})
    # K1's, K2's, K3/K4's and K5-K8's reduced rungs run on the tensor cores
    # in the mma kernels of the production shape, their float32 rung does
    # not (TF32 is barred: k1_fwd_fma, mc_fwd_fma, and mc_segments, the
    # float32 K6/K8's first pass), nor does the generic decode at any rung
    check_hmma(hmma, ("k2_onepass_mma",), ("k2_xbar", "k2_chain"),
               ("k2_xbar_any", "k2_chain_any"))
    check_hmma(k1_hmma, ("k1_tiles_mma",), ("k1_fwd_fma",),
               ("k1_energy_tiles_any",))
    check_hmma(mc_hmma, ("mc_select_mma", "mc_chain_mma", "mc_tiles_mma"),
               ("mc_chain", "mc_segments", "mc_fwd_fma"),
               ("mc_segments_any", "mc_chain_any"))
    check_hmma(stats_hmma, ("k3_stats_mma", "k4_stats_chain_mma"),
               ("k3_stats", "k4_stats_chain"),
               ("k3_stats_any", "k4_stats_chain_any"))
    # K9/K10: the tensor-core kernels at the reduced rungs, K1's float32
    # kernel (K9) and k10_dgamma<0> at float32, the generic decode's none
    check_hmma(t_hmma, T_MMA, ("k1_fwd_fma", "k10_dgamma"),
               ("k9_energy_spans_any", "k10_dgamma_any"))
    for src, k in (*(("energy_transposed", k) for k in T_MMA),
                   ("energy_expected", "k2_onepass_mma")):
        r = ptxas_of(_build.BUILD_LOG[src], k)
        if r.get("spill_bytes") != 0 or r.get("stack_bytes") != 0:
            fail(f"ptxas of {k}: {r}")
    # the float32 forward energies (K1, K5/K7) on decode_f32.cuh: FMAs only,
    # no stack, no spill; their reduced-rung kernels on tiles_mma.cuh: no
    # stack, no spill
    for key, n in (("k1_fwd_fma<0>", k1_hmma.get("k1_fwd_fma<0>")),
                   ("mc_fwd_fma<0>", mc_hmma.get("mc_fwd_fma<0>"))):
        if n != 0:
            fail(f"SASS of {key}: {n} HMMA instructions")
    for src, k in FWD_FMA + FWD_MMA:
        r = ptxas_of(_build.BUILD_LOG[src], k)
        if r.get("spill_bytes") != 0 or r.get("stack_bytes") != 0:
            fail(f"ptxas of {k}: {r}")

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

    def mc_inputs(M, num_active, S=MC_SAMPLES):
        """Index planes, per-spline counts and the planes K7/K8 draw."""
        gen = torch.Generator(device=dev).manual_seed(7)
        d1, d2 = mc.sample_decoder_indices(gen, T, B, M, S, num_active)
        kmax = (torch.full((B,), float(M), device=dev) if num_active is None
                else num_active.float())
        p1, p2 = (d.contiguous() for d in mc.philox_draws(
            mc_seed, S, T, B, kmax))
        return d1, d2, kmax, p1, p2

    def mc_check(ws, bs, M, prec, num_active, S=MC_SAMPLES):
        """K5/K6 against their plain versions on given planes; K7/K8 against
        K5/K6 on the planes of ``philox_draws`` (exact: the proof that
        forward and backward make the same draws) and so against the plain
        versions on those planes; a second K6 and K8 call bitwise equal to
        the first."""
        d1, d2, kmax, p1, p2 = mc_inputs(M, num_active, S)
        e5 = mc.energy_mc_fwd(ws, bs, gamma, d1, d2, prec)
        e5_p = mc.energy_mc_fwd_plain(ws, bs, gamma, d1, d2, prec)
        g6 = mc.energy_mc_bwd(ws, bs, gamma, d1, d2, mc_ct, prec)
        g6_p = mc.energy_mc_bwd_plain(ws, bs, gamma, d1, d2, mc_ct, prec)
        e7 = mc.energy_mc_fwd_rng(ws, bs, gamma, mc_seed, kmax, S, prec)
        g8 = mc.energy_mc_bwd_rng(ws, bs, gamma, mc_seed, kmax, S, mc_ct,
                                  prec)
        e7_p = mc.energy_mc_fwd_plain(ws, bs, gamma, p1, p2, prec)
        g8_p = mc.energy_mc_bwd_plain(ws, bs, gamma, p1, p2, mc_ct, prec)
        torch.cuda.synchronize()
        return {
            "mc_samples": S,
            "k5_repeat_bitwise": bool(torch.equal(e5, mc.energy_mc_fwd(
                ws, bs, gamma, d1, d2, prec))),
            "k7_repeat_bitwise": bool(torch.equal(e7, mc.energy_mc_fwd_rng(
                ws, bs, gamma, mc_seed, kmax, S, prec))),
            "k6_repeat_bitwise": bool(torch.equal(g6, mc.energy_mc_bwd(
                ws, bs, gamma, d1, d2, mc_ct, prec))),
            "k8_repeat_bitwise": bool(torch.equal(g8, mc.energy_mc_bwd_rng(
                ws, bs, gamma, mc_seed, kmax, S, mc_ct, prec))),
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
                                  and torch.isfinite(g_k).all()),
                   "k1_repeat_bitwise": bool(torch.equal(
                       e_k, ef.energy_fwd(ws, bs, gamma, wmb, prec))),
                   "k2_repeat_bitwise": bool(torch.equal(
                       g_k, ef.energy_bwd(ws, bs, gamma, wmb, ct, prec)))}
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
            else:
                rec["bwd_ms"] = time_ms(
                    lambda: ef.energy_bwd(ws, bs, gamma, wmb, ct, prec), 5)
                if M > 1:   # K1 and K5/K7 (early stop's every step), K6/K8
                    rec["fwd_ms"] = time_ms(
                        lambda: ef.energy_fwd(ws, bs, gamma, wmb, prec), 5)
                    d1, d2, kmax, _, _ = mc_inputs(M, None)
                    rec["mc_fwd_ms"] = time_ms(lambda: mc.energy_mc_fwd(
                        ws, bs, gamma, d1, d2, prec), 5)
                    rec["mc_rng_fwd_ms"] = time_ms(
                        lambda: mc.energy_mc_fwd_rng(
                            ws, bs, gamma, mc_seed, kmax, MC_SAMPLES, prec),
                        5)
                    rec["mc_bwd_ms"] = time_ms(lambda: mc.energy_mc_bwd(
                        ws, bs, gamma, d1, d2, mc_ct, prec), 5)
                    rec["mc_rng_bwd_ms"] = time_ms(
                        lambda: mc.energy_mc_bwd_rng(
                            ws, bs, gamma, mc_seed, kmax, MC_SAMPLES, mc_ct,
                            prec), 5)
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
    # K5-K8 at more samples than one sweep of staged draws (the backward
    # kernels once refused S > 8; the tensor-core forward holds 4 samples a
    # sweep): every rung; ms of K5/K7 and, at float32 and f32x2, of K6/K8
    for prec in ef.PRECISIONS:
        rec = {"phase": "kernels", "M": ws_all[0].shape[0], "precision": prec,
               **mc_check(ws_all, bs_all, ws_all[0].shape[0], prec, None,
                          MC_SAMPLES_WIDE)}
        d1, d2, kmax, _, _ = mc_inputs(ws_all[0].shape[0], None,
                                       MC_SAMPLES_WIDE)
        rec["mc_fwd_ms"] = time_ms(lambda: mc.energy_mc_fwd(
            ws_all, bs_all, gamma, d1, d2, prec), 2)
        rec["mc_rng_fwd_ms"] = time_ms(lambda: mc.energy_mc_fwd_rng(
            ws_all, bs_all, gamma, mc_seed, kmax, MC_SAMPLES_WIDE, prec), 2)
        if prec in ("float32", "f32x2"):
            rec["mc_bwd_ms"] = time_ms(lambda: mc.energy_mc_bwd(
                ws_all, bs_all, gamma, d1, d2, mc_ct, prec), 2)
            rec["mc_rng_bwd_ms"] = time_ms(lambda: mc.energy_mc_bwd_rng(
                ws_all, bs_all, gamma, mc_seed, kmax, MC_SAMPLES_WIDE, mc_ct,
                prec), 2)
        del d1, d2
        emit(rec)
        errors[(f"S{MC_SAMPLES_WIDE}", prec)] = rec
    # K2's tensor-core kernels at the padded output widths, ragged tile
    k2_small_shapes(ef, dev)
    # the stats kernels (K3/K4) on local shards, and the sharded energy on
    # one shard of all ten decoders against K1/K2
    stats_recs, stats_times = stats_phase(ef, ws_all, bs_all, gamma, dev)
    sharded_vs_fused(ef, params.decoders, gamma, dev)
    # the transposed kernels (K9/K10) and their op's own path
    t_recs, t_times, t_path = transposed_phase(params, ws_all, bs_all, gamma,
                                               dev)

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
    plain_cfg = dataclasses.replace(
        cfg, steps=PLAIN_STEPS,
        energy=dataclasses.replace(cfg.energy, mode="expected"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = optimize_spline_batch(params, art, cfg=plain_cfg, device=dev,
                                  log_every_chunk=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_len = np.asarray(plain.geodesic_length, np.float64)
    plain_rec = {"phase": "plain_path", "mode": "expected",
                 "steps": PLAIN_STEPS, "optimize_s": plain_s,
                 "steps_per_s": PLAIN_STEPS / plain_s,
                 "main_steps_per_s": main_rec["steps_per_s"],
                 "main_over_plain": main_rec["steps_per_s"]
                 / (PLAIN_STEPS / plain_s),
                 "lengths_finite": bool(np.isfinite(plain_len).all()),
                 "len_mean": float(plain_len.mean())}
    emit(plain_rec)
    np.savez(os.path.join(OUT_DIR, "main_lengths.npz"), port=lengths,
             jax=np.asarray(ref.geodesic_length))
    # where the time of K2 and of a main-path step goes on the device
    prof_rec = profile_phase(ef, mc, params, art, cfg, dev, ws_all, bs_all,
                             gamma, ef.uniform_weights(ws_all[0].shape[0], B,
                                                       dev), ct)

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
    # one seed twice, a shorter run; the final energies now come from the MC
    # kernel itself (K7, float32, one more draw)
    first_out, _, _ = mc_run(mc_energy, MC_REPEAT_STEPS, None)
    rep_out, rep_s, rep_launches = mc_run(mc_energy, MC_REPEAT_STEPS, None)
    rep_len = np.asarray(rep_out.geodesic_length, np.float64)
    rep_rec = {"phase": "mc_repeat", "steps": MC_REPEAT_STEPS,
               "optimize_s": rep_s,
               "steps_per_s": MC_REPEAT_STEPS / rep_s,
               "launches": rep_launches,
               "omega_bit_identical": bool(
                   np.array_equal(rep_out.omega_optimized,
                                  first_out.omega_optimized)
                   and np.array_equal(rep_out.geodesic_length,
                                      first_out.geodesic_length)),
               "moved_from_init": bool(not np.array_equal(
                   rep_out.omega_optimized, art.omega_init))}
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
               "mc_main_over_mc_plain": mc_rec["steps_per_s"]
               / (MC_EXT_STEPS / plain_mc_s),
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

    # 8-10. data to matrix; the decoder-sharded path on one rank and on two
    init_rec = init_phase(params, cfg, dev, ef)
    ep_rec, ep_lengths = ep_phase(params, art, cfg, dev, ef, cpu_ref)
    ep_vs_main = np.abs(ep_lengths / lengths - 1)
    emit({"phase": "ep_vs_main", "len_rel_median": float(np.median(ep_vs_main)),
          "len_rel_max": float(ep_vs_main.max())})
    ep2_rec = ep2_phase(params, art, cfg, dev)

    # 11-13. the JVP and rescaled modes; the CoV analysis; the
    # single-decoder bfloat16 mode
    jvp_recs = jvp_phase(params, art, cfg, dev)
    cov_recs = cov_phase(params, dev)
    single_rec = single_bf16_phase(params, art, cfg, dev, ef)

    # 14. decoders of other depths and widths: every kernel on the generic
    # decode, the fused modes against the JAX package, the optimizer
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    shape_kernels = shapes_kernels(ef, mc, eft, dev)
    shape_chunk = shapes_kernels_chunk(ef, mc, eft, dev, gamma)
    shapes_vs_jax(ef, mc, dev)
    shape_runs = shapes_optimize(params, art, cfg, dev, ef)
    # 14b. the shapes past the former cap: X > 128, D > 4, any width and
    # depth, a batch past the 32-bit index
    big_recs = big_phase(params, art, cfg, dev, ef, mc, eft)
    # 14c. training at full width, then the optimizer's checkpoint, resume,
    # early stop and backstop on the main path's recipe
    trained = train_phases(dev)[1]
    train_cov_phase(trained, dev, ef)
    resume_phase(params, art, cfg, dev, ef)
    es_rec = early_stop_phase(params, art, cfg, dev, ef, lengths)
    backstop_phase(params, art, cfg, dev, ef)
    # 14d. the golden single-decoder reproduction through the CLI; the
    # figures and their device functions
    golden_rec = golden_phase(dev, ef)
    plot_phase(params, out, dev, cfg)

    # 15. kernels line ------------------------------------------------------
    P = T * B
    in_bytes = 4 * (gamma.numel() + sum(w.numel() for w in ws_all)
                    + sum(b.numel() for b in bs_all) + M * B)
    k1_flops = P * M * decode_flops(D, H, X, 1)
    k2_bounds = rung_bound([D, H, H, X], P * M, "f32x2", True,
                           in_bytes + 4 * B + 4 * gamma.numel())
    k2_flops = k2_bounds[0] * PEAK_BF16
    k1_bound = max(k1_flops / PEAK_FP32, (in_bytes + 4 * B) / PEAK_BYTES)
    k2_bound = max(k2_bounds)
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

    # Stats kernels at the production shard (all ten decoders local): K3
    # decodes as K1 (two-pass at f32x2, on bf16 operands) and writes x0, yb,
    # sq; K4 does K2's work per decoder and reads dx0, dyb, dsq.
    stat_bytes = 4 * (2 * P * X + P)
    k3_bound = (P * M * decode_flops(D, H, X, 2) / PEAK_BF16,
                (in_bytes + stat_bytes) / PEAK_BYTES)
    k3_bound_f32 = (k1_flops / PEAK_FP32, (in_bytes + stat_bytes) / PEAK_BYTES)
    k4_bound = (k2_flops / PEAK_BF16,
                (in_bytes + stat_bytes + 4 * gamma.numel()) / PEAK_BYTES)

    # Transposed kernels: K1's and K2's function and FLOP (uniform weights:
    # no weight plane among the inputs); K10 reads the cotangents and
    # writes dgamma.
    t_in = in_bytes - 4 * M * B
    k9_bound = (k1_flops / PEAK_FP32, (t_in + 4 * B) / PEAK_BYTES)
    k10_bound = (k2_flops / PEAK_BF16,
                 (t_in + 4 * B + 4 * gamma.numel()) / PEAK_BYTES)

    def bound_by(bound):
        return "operations" if bound[0] >= bound[1] else "bytes"

    def stats_kernel(name, line, count, err_key, ms_key, bound):
        r = stats_times[(M, "f32x2")]
        return {"name": name, "route": "cuda",
                "source":
                    "vae_latent_geometry_tpu_torch/ops/csrc/energy_stats.cu",
                "replaces":
                    f"vae_latent_geometry_tpu/ops/energy_pallas.py:{line}",
                "launches": count, "max_abs_err": r[err_key],
                "ms": r[ms_key + "_ms"], "plain_ms": r[ms_key + "_plain_ms"],
                "bound_ms": 1e3 * max(bound),
                "bound_by": "operations" if bound[0] >= bound[1] else "bytes",
                "library_ms": None}

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

    def stats_extra(key):
        """K3's or K4's design and its times at every rung, M_loc = 10 and
        5, and per launch in the profiled ``ep`` steps."""
        out = {"design": "mma.sync bf16 (reduced rungs): "
                         + ("k3_stats_mma" if key == "stats_fwd"
                            else "k4_stats_chain_mma") + "; FMA at float32"}
        for m_loc in (M, M // 2):
            for prec in ef.PRECISIONS:
                if (m_loc, prec) != (M, "f32x2"):
                    out[f"ms_M_loc{m_loc}_{prec}"] = \
                        stats_times[(m_loc, prec)][key + "_ms"]
        k = "k3" if key == "stats_fwd" else "k4"
        out["ms_per_launch_ep_profile"] = prof_rec.get(
            f"ep_{k}_mma_ms_per_launch")
        return out

    def mc_bwd_extra(key):
        """K6's or K8's design, its times at the other rungs and at
        MC_SAMPLES_WIDE samples, and its pass split (phase profile)."""
        wide = f"S{MC_SAMPLES_WIDE}"
        return {"design": "mma.sync bf16 (reduced rungs): mc_select_mma "
                          "(endpoint planes) + mc_chain_mma; FMA at float32",
                "ms_f32x3": errors[(M, "f32x3")][key + "_ms"],
                "ms_bfloat16": errors[(M, "bfloat16")][key + "_ms"],
                "ms_float32": times["float32"][key + "_ms"],
                f"ms_{wide}_f32x2": errors[(wide, "f32x2")][key + "_ms"],
                f"ms_{wide}_float32": errors[(wide, "float32")][key + "_ms"],
                "ms_by_launch_f32x2": prof_rec.get(key + "_ms_by_launch")}

    def mc_fwd_extra(key):
        """K5's or K7's design, its times at the reduced rungs and at
        MC_SAMPLES_WIDE samples at every rung, its bound at f32x2 and its
        launches on the early-stop arm at mc_fused."""
        wide = f"S{MC_SAMPLES_WIDE}"
        n = n_pl if key == "mc_fwd" else n_rng
        return {"design": "mc_fwd_fma (decode_f32.cuh, float32): selective "
                          "decode of the drawn decoders; mc_tiles_mma "
                          "(mma.sync bf16, decode_mma<R, true>) at the "
                          "reduced rungs: K1's tiles, every drawn decoder "
                          "decoded once a sweep of samples, the differences "
                          "in shared memory",
                "ms_f32x2": times["f32x2"][key + "_ms"],
                **{f"ms_{p}": errors[(M, p)][key + "_ms"]
                   for p in ("f32x3", "bfloat16")},
                **{f"ms_{wide}_{p}": errors[(wide, p)][key + "_ms"]
                   for p in ef.PRECISIONS},
                "bound_ms_f32x2": 1e3 * n * decode_flops(D, H, X, 2)
                / PEAK_BF16,
                "launches_early_stop": es_rec["mc_fused"]["launches"].get(
                    "energy_mc_fwd" if key == "mc_fwd"
                    else "energy_mc_fwd_rng", 0)}

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
         "library_ms": None,
         "design": "k1_fwd_fma (decode_f32.cuh, float32): cp.async-staged "
                   "weights, 128-row tiles of one spline; k1_tiles_mma "
                   "(tiles_mma.cuh, mma.sync bf16, decode_mma<R, true>) at "
                   "the reduced rungs (early stop's every step): tiles of "
                   "32 rows x 4 splines, one row of overlap",
         "ms_f32x2": times["f32x2"]["fwd_ms"],
         **{f"ms_{p}": errors[(M, p)]["fwd_ms"]
            for p in ("f32x3", "bfloat16")},
         "bound_ms_reduced_rungs": 1e3 * k3_bound[0],
         "launches_early_stop": es_rec["expected_fused"]["launches"][
             "energy_fwd"],
         "launches_early_stop_mc": es_rec["mc_fused"]["launches"].get(
             "energy_fwd", 0),
         "launches_golden": golden_rec["launches"]["energy_fwd"]},
        {"name": "energy_bwd (K2, f32x2 trajectory steps)",
         "route": "cuda",
         "source": "vae_latent_geometry_tpu_torch/ops/csrc/energy_expected.cu",
         "replaces": "vae_latent_geometry_tpu/ops/energy_pallas.py:325",
         "launches": launches["energy_bwd"],
         "max_abs_err": errors[(M, "f32x2")]["dgamma_max_abs"],
         "ms": times["f32x2"]["bwd_ms"],
         "plain_ms": times["f32x2"]["bwd_plain_ms"],
         "bound_ms": 1e3 * k2_bound, "bound_by": "operations",
         "library_ms": None,
         "design": "k2_prep_planes + k2_onepass_mma (reduced rungs: the "
                   "one-pass body of onepass_mma.cuh, K10's, mma.sync bf16, "
                   "each point decoded once per decoder); k2_xbar + "
                   "k2_chain (FMA) at float32",
         "ms_f32x3": errors[(M, "f32x3")]["bwd_ms"],
         "ms_bfloat16": errors[(M, "bfloat16")]["bwd_ms"],
         "ms_float32": times["float32"]["bwd_ms"],
         "ms_M1_bfloat16": errors[(1, "bfloat16")]["bwd_ms"],
         "launches_single_bf16": single_rec["launches"]["energy_bwd"],
         "launches_early_stop": es_rec["expected_fused"]["launches"][
             "energy_bwd"],
         "launches_golden": golden_rec["launches"]["energy_bwd"],
         **{f"{k}_M1_f32x3_B500": golden_rec[f"k2_M1_f32x3_B500_{k}"]
            for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}},
        {**stats_kernel("stats_fwd (K3, f32x2 trajectory steps, M_loc=10)",
                        472, ep_rec["launches"]["stats_fwd"], "yb_max_abs",
                        "stats_fwd", k3_bound),
         **stats_extra("stats_fwd"),
         "bound_ms_float32": 1e3 * max(k3_bound_f32),
         "bound_ms_M_loc5": 1e3 * max(k3_bound[0] / 2, k3_bound[1])},
        {**stats_kernel("stats_bwd (K4, f32x2 trajectory steps, M_loc=10)",
                        502, ep_rec["launches"]["stats_bwd"],
                        "stats_dgamma_max_abs", "stats_bwd", k4_bound),
         **stats_extra("stats_bwd"),
         "bound_ms_M_loc5": 1e3 * max(k4_bound[0] / 2, k4_bound[1])},
        {"name": "energy_t_fwd (K9, transposed layout, float32)",
         "route": "cuda",
         "source":
             "vae_latent_geometry_tpu_torch/ops/csrc/energy_transposed.cu",
         "replaces":
             "vae_latent_geometry_tpu/ops/_research/energy_pallas_t.py:119",
         "launches": t_path["launches"]["energy_t_fwd"],
         "max_abs_err": t_recs[(M, "float32")]["energy_max_abs"],
         "ms": t_times["float32"]["k9_ms"],
         "plain_ms": t_times["float32"]["k9_plain_ms"],
         "bound_ms": 1e3 * max(k9_bound), "bound_by": bound_by(k9_bound),
         "library_ms": None,
         "design": "K1's kernels on the uniform weight plane: k1_fwd_fma "
                   "(decode_f32.cuh) at float32, k1_tiles_mma (mma.sync "
                   "bf16, tiles of 32 rows x 4 splines, one row of overlap) "
                   "at the reduced rungs",
         **{f"ms_{p}": t_times[p]["k9_ms"]
            for p in ("f32x3", "f32x2", "bfloat16")},
         "k1_ms_same_call": t_times["float32"]["k1_ms"]},
        {"name": "energy_t_bwd (K10, transposed layout, f32x2, one decode)",
         "route": "cuda",
         "source":
             "vae_latent_geometry_tpu_torch/ops/csrc/energy_transposed.cu",
         "replaces":
             "vae_latent_geometry_tpu/ops/_research/energy_pallas_t.py:193",
         "launches": t_path["launches"]["energy_t_bwd"],
         "max_abs_err": t_recs[(M, "f32x2")]["dgamma_max_abs"],
         "ms": t_times["f32x2"]["k10_ms"],
         "plain_ms": t_times["f32x2"]["k10_plain_ms"],
         "bound_ms": 1e3 * max(k10_bound), "bound_by": bound_by(k10_bound),
         "library_ms": None,
         "design": "k10_mma (K2's one-pass body, onepass_mma.cuh, on the "
                   "uniform plane; mma.sync bf16): one staging per tile and "
                   "decoder serves the chain of tile k-1 and the decode of "
                   "tile k; outputs and masks in the block's scratch, "
                   "prefetched by cp.async; k10_dgamma<0> (FMA) at float32",
         **{f"ms_{p}": t_times[p]["k10_ms"]
            for p in ("float32", "f32x3", "bfloat16")},
         "k2_ms_same_call": t_times["f32x2"]["k2_ms"]},
        {**mc_kernel("energy_mc_fwd (K5, float32 final evaluation, planes)",
                     473, ext_launches["energy_mc_fwd"], "mc_energy_max_abs",
                     "mc_fwd", "float32", mc_bounds["k5"]),
         **mc_fwd_extra("mc_fwd")},
        {**mc_kernel("energy_mc_bwd (K6, f32x2 trajectory steps, planes)",
                     548, ext_launches["energy_mc_bwd"], "mc_dgamma_max_abs",
                     "mc_bwd", "f32x2", mc_bounds["k6"]),
         **mc_bwd_extra("mc_bwd")},
        {**mc_kernel("energy_mc_fwd_rng (K7, float32 final evaluation, "
                     "in-kernel draws)", 166,
                     rep_launches["energy_mc_fwd_rng"],
                     "mc_rng_energy_max_abs", "mc_rng_fwd", "float32",
                     mc_bounds["k7"]),
         **mc_fwd_extra("mc_rng_fwd")},
        {**mc_kernel("energy_mc_bwd_rng (K8, f32x2 trajectory steps, "
                     "in-kernel draws)", 235, mc_launches["energy_mc_bwd_rng"],
                     "mc_rng_dgamma_max_abs", "mc_rng_bwd", "f32x2",
                     mc_bounds["k8"]),
         **mc_bwd_extra("mc_rng_bwd"),
         "launches_early_stop": es_rec["mc_fused"]["launches"][
             "energy_mc_bwd_rng"]},
    ]

    # each kernel's records on the other decoder shapes (on the optimized
    # shapes those at the production chunk, where their runs launch it), and
    # its launches on their optimizer runs
    counter = {"K1": "energy_fwd", "K2": "energy_bwd", "K3": "stats_fwd",
               "K4": "stats_bwd", "K9": "energy_t_fwd", "K10": "energy_t_bwd",
               "K5": "energy_mc_fwd", "K6": "energy_mc_bwd",
               "K7": "energy_mc_fwd_rng", "K8": "energy_mc_bwd_rng"}
    keep = ("dims", "M", "T", "B", "rung", "ms", "bound_ms", "bound_by",
            "plain_ms", "max_abs_err")
    for k, tag in zip(kernels, counter):
        recs = {**shape_kernels[tag], **shape_chunk.get(tag, {})}
        k["shapes"] = {name: {f: r[f] for f in keep}
                       for name, r in recs.items()}
        k["launches_shapes"] = {
            name: sum(run.get(counter[tag], 0)
                      for run in r["launches"].values())
            for name, r in shape_runs.items()}

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
        if not (r["k5_repeat_bitwise"] and r["k6_repeat_bitwise"]
                and r["k7_repeat_bitwise"] and r["k8_repeat_bitwise"]):
            fail(f"K5-K8: a second call on the same input differs at M={m} "
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
        if not (r["k1_repeat_bitwise"] and r["k2_repeat_bitwise"]):
            fail(f"K1/K2: a second call on the same input differs at M={m} "
                 f"{prec}")
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
                          {"energy_mc_bwd_rng": MC_REPEAT_STEPS * n_chunks,
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
    for (m, prec), r in t_recs.items():
        e_tol = E_RTOL_BF16_M1 if (prec, m) == ("bfloat16", 1) else E_RTOL
        if not r["finite"] or not r["energy_max_rel"] <= e_tol:
            fail(f"K9 energy rel err {r['energy_max_rel']:.3g} > {e_tol} (or "
                 f"non-finite) at M={m} {prec}")
        if (not r["dgamma_share_over_1e-3"] <= DG_OVER_SHARE[prec]
                or not r["dgamma_rel_median"] <= DG_MED
                or not r["dgamma_rel_p99"] <= DG_P99):
            fail(f"K10 dgamma median/p99/share {r['dgamma_rel_median']:.3g}/"
                 f"{r['dgamma_rel_p99']:.3g}/"
                 f"{r['dgamma_share_over_1e-3']:.3g} at M={m} {prec}")
        if "vs_k1_energy_max_rel" in r and (
                not r["vs_k1_energy_max_rel"] <= E_RTOL
                or not r["vs_k2_dgamma_rel_median"] <= DG_MED
                or not r["vs_k2_dgamma_rel_p99"] <= DG_P99):
            fail(f"K9/K10 vs K1/K2 at {prec}: energy "
                 f"{r['vs_k1_energy_max_rel']:.3g}, dgamma median/p99 "
                 f"{r['vs_k2_dgamma_rel_median']:.3g}/"
                 f"{r['vs_k2_dgamma_rel_p99']:.3g}")
        if r.get("vs_k2_bitwise") is False:
            fail(f"K10 and K2 on the uniform plane differ at {prec}: one "
                 "body, the same arithmetic")
    for path, v in t_path["gate_medrel"].items():
        if not v <= GATE_MEDREL:
            fail(f"numerics gate: {path} median rel err {v} > {GATE_MEDREL}")
    if not (t_path["op_energy_finite"] and t_path["op_grad_finite"]):
        fail("energy_expected_fused_t: non-finite energy or gradient")
    for name, count in t_path["launches"].items():
        want_t = {"energy_t_fwd": 2, "energy_t_bwd": 1, "energy_fwd": 1}
        if count != want_t.get(name, 0):
            fail(f"transposed path: {name} launched {count} times, expected "
                 f"{want_t.get(name, 0)}")
    for r in jvp_recs:
        if r["launches"] != {**{k: 0 for k in r["launches"]},
                             "energy_fwd": n_chunks}:
            fail(f"jvp {r['name']}: launches {r['launches']}, expected only "
                 f"{n_chunks} of K1 (the final float32 energies)")
        if not (r["lengths_finite"] and r["moved_from_init"]):
            fail(f"jvp {r['name']}: output malformed")
        if not (r["len_rel_median"] <= LEN_MED and r["len_rel_max"] <= LEN_MAX):
            fail(f"jvp {r['name']}: lengths vs the JAX package on the CPU: "
                 f"median {r['len_rel_median']:.3g}, max "
                 f"{r['len_rel_max']:.3g}")
    cov_steps = cov_recs["mc_fused"]["steps"]
    want_cov = {"mc_fused": {"energy_mc_bwd_rng": 2 * cov_steps,
                             "energy_mc_fwd_rng": 2},
                "expected_fused": {"energy_bwd": 2 * cov_steps,
                                   "energy_fwd": 2}}
    for mode, r in cov_recs.items():
        for name, count in r["launches"].items():
            if count != want_cov[mode].get(name, 0):
                fail(f"cov {mode}: {name} launched {count} times, expected "
                     f"{want_cov[mode].get(name, 0)}")
        if not (r["lengths_finite"] and r["pairs_equal_jax"]):
            fail(f"cov {mode}: non-finite lengths or other pairs than the "
                 "JAX package's")
    r = cov_recs["expected_fused"]
    if not (r["seeds_bit_identical"]
            and all(v == 0.0 for v in r["avg_cov_geodesic"].values())):
        fail("cov expected_fused: one model twice did not give bit-identical "
             "lengths and CoV 0")
    if not (r["len_rel_median"] <= LEN_MED and r["len_rel_max"] <= LEN_MAX):
        fail(f"cov expected_fused: lengths vs the JAX package on the CPU: "
             f"median {r['len_rel_median']:.3g}, max {r['len_rel_max']:.3g}")
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
