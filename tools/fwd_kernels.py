#!/usr/bin/env python3
"""One-off measurements of one checkout's float32 forward-energy kernels
(K1, K5, K7) on the card.

    python3 tools/fwd_kernels.py --tree <checkout> --times [--out FILE]
    python3 tools/fwd_kernels.py --tree <checkout> --split [--out FILE]
    python3 tools/fwd_kernels.py --tree <checkout> --hashes FILE
    python3 tools/fwd_kernels.py --tree <checkout> --steps
    python3 tools/fwd_kernels.py --tree <checkout> --rungs [--out FILE]
    python3 tools/fwd_kernels.py --tree <checkout> --early-stop [--out FILE]
    python3 tools/fwd_kernels.py --compare FILE_A FILE_B

``--times``: ms per call by CUDA events (as ``chip_smoke.py`` times the
kernels) on the production chunk (the committed model, the seed-42 init
curves padded to B=200, T=2000) at float32: K1 with uniform weights, K5 on
``torch.randint`` planes and K7 (in-kernel draws) at S = 1, 2 and 12, each
with the (point, decoder) pairs its draws need.

``--split``: where K1's cycles go, by phase, in the float32 kernel that
``k1_fwd_fma`` replaced (``tools/k1_phases.cu``, built against
``<checkout>``'s headers; thread 0 of every block stamps ``clock64()``
after each barrier): load, staging, layer 1, layer-2
product, its epilogue, layer 3, statistics, segments.

``--hashes``: SHA-256 of the kernel outputs that the float32 forward
redesign must leave bit for bit as they were (K1 at the reduced rungs on
the production chunk and at every rung on the generic decode, decoder S2
of ``chip_smoke.SHAPES``; K2 at every rung on both; K5/K7 at the reduced
rungs on the production chunk and every rung on S2, S = 1, 2, 3, 12), and
the float32 K1/K5/K7 energies themselves.  ``--compare`` prints which
hashed entries of two such files differ and the largest relative
difference between their float32 energies: run ``--hashes`` on a parent
checkout and on this one, each in a process of its own, on one card.

``--steps``: steps/s of ``chip_smoke.py``'s phases ``main``
(``expected_fused``, f32x2), ``mc_main`` (``mc_fused``, in-kernel draws)
and ``ep`` (the decoder-sharded path on a 1 x 1 mesh), 1000 steps each on
the committed model and the seed-42 init blob, as the script runs them;
their per-step kernels are not the forward ones, so a change to K1/K5/K7
should leave them where they were.  Run the parent and this checkout in
processes of their own, interleaved (parent, change, change, parent).

``--rungs``: ms per call by CUDA events of the same kernels at the
reduced rungs (f32x3, f32x2, bfloat16) on the production chunk: K1 at M =
10 and M = 1 (uniform weights), K5 on ``torch.randint`` planes and K7 at S
= 2 and 12.

``--early-stop``: ``optimize_spline_early_stopping`` on the production
chunk (budget 1000 steps, f32x2) at ``expected_fused`` and at ``mc_fused``
(in-kernel draws, S = 2, final energies by ``expected_fused``): steps run,
steps/s, launches by kernel.  Both modes evaluate the energy at the
trajectory rung on every step: K1 or K7 each step.

Loads ``<checkout>/chip_smoke.py`` and that checkout's package; needs one
CUDA GPU and, for ``--split``, nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

from mc_kernels import digest, load_tree, production_inputs

RUNGS = ("float32", "f32x3", "f32x2", "bfloat16")
SAMPLES = (1, 2, 12)
HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("load", "stage", "layer1", "layer2", "epilogue2", "layer3",
          "stats", "segments")


def decodes_needed(d1, d2, M):
    """(point, decoder) pairs that the sampled energy on these planes uses."""
    import torch

    S, T1, B = d1.shape
    need = torch.zeros((T1 + 1, B, M), dtype=torch.bool, device=d1.device)
    for s in range(S):
        need[:-1].scatter_(2, d1[s].long()[..., None], True)
        need[1:].scatter_(2, d2[s].long()[..., None], True)
    return int(need.sum())


def times(smoke, dev):
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    ws, bs, gamma = production_inputs(smoke, dev)
    T, B = gamma.shape[:2]
    M = ws[0].shape[0]
    wmb = ef.uniform_weights(M, B, dev)
    kmax = torch.full((B,), float(M), device=dev)
    seed = (1 << 40) + 42
    out = [{"kernel": "K1", "ms": smoke.time_ms(
        lambda: ef.energy_fwd(ws, bs, gamma, wmb, "float32"), 10)}]
    for S in SAMPLES:
        d1, d2 = mc.sample_decoder_indices(
            torch.Generator(device=dev).manual_seed(7), T, B, M, S)
        p1, p2 = mc.philox_draws(seed, S, T, B, kmax)
        out.append({"kernel": "K5", "S": S,
                    "decodes_needed": decodes_needed(d1, d2, M),
                    "ms": smoke.time_ms(lambda: mc.energy_mc_fwd(
                        ws, bs, gamma, d1, d2, "float32"), 10)})
        out.append({"kernel": "K7", "S": S,
                    "decodes_needed": decodes_needed(p1, p2, M),
                    "ms": smoke.time_ms(lambda: mc.energy_mc_fwd_rng(
                        ws, bs, gamma, seed, kmax, S, "float32"), 10)})
    for rec in out:
        print(json.dumps(rec), flush=True)
    return out


def rung_times(smoke, dev):
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    ws_all, bs_all, gamma = production_inputs(smoke, dev)
    T, B = gamma.shape[:2]
    seed = (1 << 40) + 42
    out = []
    for prec in RUNGS[1:]:
        for M in (ws_all[0].shape[0], 1):
            ws = [w[:M].contiguous() for w in ws_all]
            bs = [b[:M].contiguous() for b in bs_all]
            wmb = ef.uniform_weights(M, B, dev)
            out.append({"kernel": "K1", "precision": prec, "M": M,
                        "ms": smoke.time_ms(lambda: ef.energy_fwd(
                            ws, bs, gamma, wmb, prec), 10)})
        M = ws_all[0].shape[0]
        kmax = torch.full((B,), float(M), device=dev)
        for S in (2, 12):
            d1, d2 = mc.sample_decoder_indices(
                torch.Generator(device=dev).manual_seed(7), T, B, M, S)
            reps = 10 if S == 2 else 3
            out.append({"kernel": "K5", "precision": prec, "S": S,
                        "ms": smoke.time_ms(lambda: mc.energy_mc_fwd(
                            ws_all, bs_all, gamma, d1, d2, prec), reps)})
            out.append({"kernel": "K7", "precision": prec, "S": S,
                        "ms": smoke.time_ms(lambda: mc.energy_mc_fwd_rng(
                            ws_all, bs_all, gamma, seed, kmax, S, prec),
                            reps)})
    for rec in out:
        print(json.dumps(rec), flush=True)
    return out


def early_stop(smoke, dev):
    import dataclasses
    import time

    import torch

    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.optim.geodesic import (
        optimize_spline_early_stopping)

    params = load_npz(smoke.MODEL, dev)
    art = load_spline_batch(smoke.INIT)
    B = 200
    idx = np.concatenate([np.arange(len(art)),
                          np.full(B - len(art), len(art) - 1)])
    cfg = GeodesicConfig(
        steps=smoke.STEPS, lr=1e-3, lr_schedule="constant", batch_size=B,
        early_stop=True,
        energy=EnergyConfig(num_t=2000, mode="expected_fused",
                            kernel_precision="f32x2"))
    mc_cfg = dataclasses.replace(
        cfg, final_energy_mode="expected_fused",
        energy=dataclasses.replace(cfg.energy, mode="mc_fused",
                                   mc_samples=smoke.MC_SAMPLES,
                                   mc_inkernel_rng=True))
    out = []
    for name, run_cfg in (("expected_fused", cfg), ("mc_fused", mc_cfg)):
        torch.cuda.synchronize()
        ef.reset_launch_counts()
        t0 = time.perf_counter()
        res = optimize_spline_early_stopping(
            params.decoders, art.omega_init[idx], art.a[idx], art.b[idx],
            art.basis, run_cfg, device=dev,
            generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = {"early_stop": name, "steps_run": res.steps_run,
               "optimize_s": secs, "steps_per_s": res.steps_run / secs,
               "launches": {k: v for k, v in ef.LAUNCHES.items() if v}}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def split(smoke, tree, dev):
    """Build tools/k1_phases.cu against the checkout's headers and read the
    stamped K1's cycles by phase on the production chunk."""
    import torch

    from vae_latent_geometry_tpu_torch.ops import _build
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    lib_path = os.path.join(tree, "vae_latent_geometry_tpu_torch", "ops",
                            "build", "libk1_phases.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    csrc = os.path.join(tree, "vae_latent_geometry_tpu_torch", "ops", "csrc")
    log = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v", "-I", csrc, "-o", lib_path,
         os.path.join(HERE, "k1_phases.cu")],
        capture_output=True, text=True)
    if log.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(lib_path)
    P = ctypes.c_void_p
    lib.k1_phases.argtypes = [P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int] + [P] * 10
    ws, bs, gamma = production_inputs(smoke, dev)
    T, B, D = gamma.shape
    M, X = ws[0].shape[0], ws[2].shape[2]
    wmb = ef.uniform_weights(M, B, dev)
    partial = torch.empty((T, B), device=dev)
    cyc = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)

    def run():
        err = lib.k1_phases(gamma.data_ptr(), T, B, D, M, X,
                            *(t.data_ptr() for pair in zip(ws, bs)
                              for t in pair),
                            wmb.data_ptr(), partial.data_ptr(),
                            cyc.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"k1_phases launch failed: {err}")

    ms = smoke.time_ms(run, 5)
    cyc.zero_()
    run()
    torch.cuda.synchronize()
    c = cyc.cpu().numpy().astype(np.float64)
    rec = {"kernel": "K1 float32, stamped", "ms": ms,
           "ms_unstamped": smoke.time_ms(
               lambda: ef.energy_fwd(ws, bs, gamma, wmb, "float32"), 5),
           "share": {p: float(v / c.sum()) for p, v in zip(PHASES, c)},
           "ptxas": [l.strip() for l in (log.stdout + log.stderr).splitlines()
                     if "registers" in l or "spill" in l]}
    print(json.dumps(rec), flush=True)
    return rec


def hashes(smoke, dev):
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    out = {}
    ws, bs, gamma = production_inputs(smoke, dev)
    rng = np.random.default_rng(400)
    g_any = torch.as_tensor((1.5 * rng.normal(size=(400, 100, 2))).astype(
        np.float32), device=dev)
    layers = smoke.shape_layers("S2")
    ws_any = [torch.as_tensor(w, device=dev) for w, _ in layers]
    bs_any = [torch.as_tensor(b, device=dev) for _, b in layers]
    seed = (1 << 40) + 42
    for tag, (w, b, g) in {"production": (ws, bs, gamma),
                           "S2": (ws_any, bs_any, g_any)}.items():
        T, B = g.shape[:2]
        M = w[0].shape[0]
        counts = np.random.default_rng(3).integers(1, M + 1, size=B)
        wmb = ef.active_weights(torch.as_tensor(counts, device=dev), M, B,
                                dev).contiguous()
        kmax = torch.as_tensor(counts, device=dev).float()
        ct = torch.linspace(0.5, 2.0, B, device=dev)
        for prec in RUNGS:
            key = f"{tag}/{prec}"
            e1 = ef.energy_fwd(w, b, g, wmb, prec)
            if tag == "production" and prec == "float32":
                out[f"value/{key}/K1"] = e1.double().cpu().tolist()
            else:
                out[f"{key}/K1"] = digest(e1)
            out[f"{key}/K2"] = digest(ef.energy_bwd(w, b, g, wmb, ct, prec))
            for S in (1, 2, 3, 12):
                d1, d2 = mc.sample_decoder_indices(
                    torch.Generator(device=dev).manual_seed(7), T, B, M, S,
                    kmax.long())
                e5 = mc.energy_mc_fwd(w, b, g, d1, d2, prec)
                e7 = mc.energy_mc_fwd_rng(w, b, g, seed, kmax, S, prec)
                if tag == "production" and prec == "float32":
                    out[f"value/{key}/S{S}/K5"] = e5.double().cpu().tolist()
                    out[f"value/{key}/S{S}/K7"] = e7.double().cpu().tolist()
                else:
                    out[f"{key}/S{S}/K5"] = digest(e5)
                    out[f"{key}/S{S}/K7"] = digest(e7)
    return out


def steps(smoke, dev):
    import dataclasses
    import time

    import torch

    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import _build
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    _build.build_all()
    params = load_npz(smoke.MODEL, dev)
    art = load_spline_batch(smoke.INIT)
    cfg = GeodesicConfig(
        steps=smoke.STEPS, lr=1e-3, lr_schedule="constant", batch_size=200,
        energy=EnergyConfig(num_t=2000, mode="expected_fused",
                            kernel_precision="f32x2"))
    mc_cfg = dataclasses.replace(
        cfg, final_energy_mode="expected_fused",
        energy=dataclasses.replace(cfg.energy, mode="mc_fused",
                                   mc_samples=smoke.MC_SAMPLES,
                                   mc_inkernel_rng=True))
    out = {}
    for name, run_cfg in (("main", cfg), ("mc_main", mc_cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_spline_batch(params, art, cfg=run_cfg, device=dev,
                              log_every_chunk=False,
                              generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        out[name] = run_cfg.steps / (time.perf_counter() - t0)
    with open(smoke.JAX_CPU) as f:
        cpu_ref = json.load(f)
    out["ep"] = smoke.ep_phase(params, art, cfg, dev, ef,
                               cpu_ref)[0]["steps_per_s"]
    rec = {"steps_per_s": out}
    print(json.dumps(rec), flush=True)
    return rec


def compare(a, b):
    keys = a.keys() & b.keys()
    differ = sorted(k for k in keys if not k.startswith("value/")
                    and a[k] != b[k])
    rel = {}
    for k in sorted(k for k in keys if k.startswith("value/")):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        rel[k[len("value/"):]] = float(np.max(np.abs(x - y) / np.abs(x)))
    print(json.dumps({"compared": len(keys) - len(rel),
                      "only_in_one": sorted(a.keys() ^ b.keys()),
                      "differ": differ, "float32_max_rel": rel}))
    return 1 if differ or a.keys() != b.keys() else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--rungs", action="store_true")
    ap.add_argument("--early-stop", action="store_true")
    ap.add_argument("--hashes")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.compare:
        return compare(*(json.load(open(p)) for p in args.compare))
    tree = os.path.abspath(args.tree)
    smoke = load_tree(tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fwd_kernels: no CUDA device available")
    dev = torch.device("cuda")
    print(json.dumps({"tree": args.tree, "card": smoke.card_line()}),
          flush=True)
    recs = {}
    if args.split:
        recs["split"] = split(smoke, tree, dev)
    if args.times:
        recs["times"] = times(smoke, dev)
    if args.rungs:
        recs["rungs"] = rung_times(smoke, dev)
    if args.early_stop:
        recs["early_stop"] = early_stop(smoke, dev)
    if args.steps:
        recs["steps"] = steps(smoke, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    if args.hashes:
        with open(args.hashes, "w") as f:
            json.dump(hashes(smoke, dev), f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
