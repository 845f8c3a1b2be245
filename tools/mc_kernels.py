#!/usr/bin/env python3
"""One-off measurements of one checkout's MC kernels (K5-K8) on the card.

    python3 tools/mc_kernels.py --tree <checkout> --times [--out FILE]
    python3 tools/mc_kernels.py --tree <checkout> --hashes FILE
    python3 tools/mc_kernels.py --compare FILE_A FILE_B

``--times``: device time by kernel (torch.profiler) of K6 (index planes)
and K8 (in-kernel draws) on the production chunk (the committed model, the
seed-42 init curves padded to B=200, T=2000) at every rung and S in
``--samples``: each launch's ms and share of a call (``mc_segments``
against ``mc_chain`` at float32; at the reduced rungs ``mc_select_planes``
against ``mc_chain_onepass`` up to the one-decode route's cap, the
two-pass ``mc_select_mma`` against ``mc_chain_mma`` above it), and the
route the call took.

``--hashes``: SHA-256 of the outputs of K5-K8 on seeded inputs, written to
FILE: on the production chunk K5-K8 at every rung, and every rung of K5-K8
on the generic decode (decoder S2 of ``chip_smoke.SHAPES``, T=400, B=100),
at S = 1, 2, 3 and 8 (K6/K8 at the reduced rungs: the one-decode route up
to 3, the two-pass kernels at 8).  ``--compare`` prints which entries of
two such files differ: run ``--hashes`` on a parent checkout and on this
one, each in a process of its own, on one card.

Loads ``<checkout>/chip_smoke.py`` and that checkout's package; needs one
CUDA GPU.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np

RUNGS = ("float32", "f32x3", "f32x2", "bfloat16")


def load_tree(tree):
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_tree", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def production_inputs(smoke, dev):
    import torch

    from vae_latent_geometry_tpu_torch.geometry.spline import (
        design_matrix, eval_spline_design, t_grid)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    params = load_npz(smoke.MODEL, dev)
    art = load_spline_batch(smoke.INIT)
    B, T = 200, 2000
    idx = np.concatenate([np.arange(len(art)),
                          np.full(B - len(art), len(art) - 1)])
    t = t_grid(T, dev)
    phi = design_matrix(t, art.basis, art.n_poly)
    gamma = eval_spline_design(
        torch.as_tensor(art.omega_init[idx], device=dev),
        torch.as_tensor(art.a[idx], device=dev),
        torch.as_tensor(art.b[idx], device=dev), phi, t).contiguous()
    ws, bs = ef.stack_weights(params.decoders)
    return ws, bs, gamma


def times(smoke, dev, samples):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    ws, bs, gamma = production_inputs(smoke, dev)
    T, B = gamma.shape[:2]
    M = ws[0].shape[0]
    ct = torch.linspace(0.5, 2.0, B, device=dev)
    kmax = torch.full((B,), float(M), device=dev)
    seed = (1 << 40) + 42
    out = []
    for S in samples:
        d1, d2 = mc.sample_decoder_indices(
            torch.Generator(device=dev).manual_seed(7), T, B, M, S)
        for prec in RUNGS:
            calls = {
                "K6": lambda: mc.energy_mc_bwd(ws, bs, gamma, d1, d2, ct,
                                               prec),
                "K8": lambda: mc.energy_mc_bwd_rng(ws, bs, gamma, seed, kmax,
                                                   S, ct, prec)}
            for name, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                by = {}
                for e in prof.events():
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        key = e.name.replace("(anonymous namespace)::", "")
                        key = key.replace("void ", "").split("(")[0][:60]
                        by[key] = by.get(key, 0.0) + e.time_range.elapsed_us()
                total = sum(by.values())
                widths = [ws[0].shape[1]] + [w.shape[-1] for w in ws]
                rec = {"kernel": name, "S": S, "precision": prec,
                       "route": (mc.k8_route(prec, widths, S)
                                 if hasattr(mc, "k8_route") else None),
                       "ms_by_launch": {k: v / 3e3 for k, v in by.items()},
                       "share_by_launch": {k: v / total
                                           for k, v in by.items()},
                       "ms_per_call": total / 3e3}
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def digest(x):
    return hashlib.sha256(x.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def hashes(smoke, dev):
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    out = {}
    ws, bs, gamma = production_inputs(smoke, dev)
    rng = np.random.default_rng(400)
    g_any = torch.as_tensor((1.5 * rng.normal(size=(400, 100, 2))).astype(
        np.float32), device=dev)
    layers = smoke.shape_layers("S2")
    ws_any = [torch.as_tensor(w, device=dev) for w, _ in layers]
    bs_any = [torch.as_tensor(b, device=dev) for _, b in layers]
    for tag, (w, b, g) in {"production": (ws, bs, gamma),
                           "S2": (ws_any, bs_any, g_any)}.items():
        T, B = g.shape[:2]
        M = w[0].shape[0]
        ct = torch.linspace(0.5, 2.0, B, device=dev)
        kmax = torch.as_tensor(np.random.default_rng(3).integers(
            1, M + 1, size=B), device=dev).float()
        seed = (1 << 40) + 42
        for S in (1, 2, 3, 8):
            d1, d2 = mc.sample_decoder_indices(
                torch.Generator(device=dev).manual_seed(7), T, B, M, S,
                kmax.long())
            for prec in RUNGS:
                key = f"{tag}/S{S}/{prec}"
                out[key + "/K5"] = digest(mc.energy_mc_fwd(w, b, g, d1, d2,
                                                           prec))
                out[key + "/K7"] = digest(mc.energy_mc_fwd_rng(
                    w, b, g, seed, kmax, S, prec))
                out[key + "/K6"] = digest(mc.energy_mc_bwd(w, b, g, d1, d2, ct,
                                                          prec))
                out[key + "/K8"] = digest(mc.energy_mc_bwd_rng(
                    w, b, g, seed, kmax, S, ct, prec))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--samples", default="2")
    ap.add_argument("--hashes")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        differ = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
        print(json.dumps({"compared": len(a.keys() & b.keys()),
                          "only_in_one": sorted(a.keys() ^ b.keys()),
                          "differ": differ}))
        return 1 if differ or a.keys() != b.keys() else 0
    smoke = load_tree(os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mc_kernels: no CUDA device available")
    dev = torch.device("cuda")
    print(json.dumps({"tree": args.tree, "card": smoke.card_line()}),
          flush=True)
    if args.times:
        recs = times(smoke, dev, [int(s) for s in args.samples.split(",")])
        if args.out:
            with open(args.out, "w") as f:
                json.dump(recs, f, indent=1)
    if args.hashes:
        with open(args.hashes, "w") as f:
            json.dump(hashes(smoke, dev), f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
