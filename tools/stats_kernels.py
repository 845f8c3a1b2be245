#!/usr/bin/env python3
"""One-off measurements of one checkout's stats kernels (K3/K4) on the card.

    python3 tools/stats_kernels.py --tree <checkout> --times [--out FILE]
    python3 tools/stats_kernels.py --tree <checkout> --hashes FILE
    python3 tools/stats_kernels.py --compare FILE_A FILE_B

``--times``: device time by kernel (torch.profiler) of K3 and K4 on the
production chunk (the committed model, the seed-42 init curves padded to
B=200, T=2000) at every rung, on local shards of 10 and 5 decoders: ms per
launch of each kernel the call launches, and ms per call by CUDA events
(as ``chip_smoke.py`` times the kernels).

``--hashes``: SHA-256 of the outputs of K3 (x0, yb, sq) and K4 (dgamma) on
seeded inputs, written to FILE: on the production chunk at float32 (the
kernels that keep their CUDA-core code), and at every rung on the generic
decode (decoder S2 of ``chip_smoke.SHAPES``, T=400, B=100), for shards of
M_loc = 10, 5 and 1 decoders with mixed per-spline decoder counts.
``--compare`` prints which entries of two such files differ: run
``--hashes`` on a parent checkout and on this one, each in a process of its
own, on one card.

Loads ``<checkout>/chip_smoke.py`` and that checkout's package; needs one
CUDA GPU.
"""

import argparse
import json
import os
import sys

import numpy as np

from mc_kernels import digest, load_tree, production_inputs

RUNGS = ("float32", "f32x3", "f32x2", "bfloat16")
M_LOCS = (10, 5, 1)


def shard(ef, ws, bs, m_loc, B, dev, mixed):
    """The first ``m_loc`` decoders and their local weight rows: uniform,
    or of seeded mixed per-spline decoder counts."""
    import torch

    M = ws[0].shape[0]
    w = [x[:m_loc].contiguous() for x in ws]
    b = [x[:m_loc].contiguous() for x in bs]
    if mixed:
        na = torch.as_tensor(np.random.default_rng(3).integers(
            1, M + 1, size=B), device=dev)
        wmb = ef.active_weights_local(na, M, m_loc, B, 0, dev)
    else:
        wmb = ef.uniform_weights_local(M, m_loc, B, dev)
    return w, b, wmb.contiguous()


def times(smoke, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    ws_all, bs_all, gamma = production_inputs(smoke, dev)
    T, B = gamma.shape[:2]
    X = ws_all[-1].shape[-1]
    dx0, dyb, dsq = smoke.smooth_cotangents(T, B, X, dev, seed=11)
    out = []
    for m_loc in (10, 5):
        ws, bs, wmb = shard(ef, ws_all, bs_all, m_loc, B, dev, mixed=False)
        for prec in RUNGS:
            calls = {
                "K3": lambda: ef.stats_fwd(ws, bs, gamma, wmb, prec),
                "K4": lambda: ef.stats_bwd(ws, bs, gamma, wmb, dx0, dyb, dsq,
                                           prec)}
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
                rec = {"kernel": name, "M_loc": m_loc, "precision": prec,
                       "ms_by_launch": {k: v / 3e3 for k, v in by.items()},
                       "ms_per_call": sum(by.values()) / 3e3,
                       "ms_per_call_events": smoke.time_ms(fn, 5)}
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def hashes(smoke, dev):
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    out = {}
    ws, bs, gamma = production_inputs(smoke, dev)
    rng = np.random.default_rng(400)
    g_any = torch.as_tensor((1.5 * rng.normal(size=(400, 100, 2))).astype(
        np.float32), device=dev)
    layers = smoke.shape_layers("S2")
    ws_any = [torch.as_tensor(w, device=dev) for w, _ in layers]
    bs_any = [torch.as_tensor(b, device=dev) for _, b in layers]
    for tag, (w_all, b_all, g, rungs) in {
            "production": (ws, bs, gamma, ("float32",)),
            "S2": (ws_any, bs_any, g_any, RUNGS)}.items():
        T, B = g.shape[:2]
        X = w_all[-1].shape[-1]
        cts = smoke.smooth_cotangents(T, B, X, dev, seed=11)
        for m_loc in M_LOCS:
            w, b, wmb = shard(ef, w_all, b_all, m_loc, B, dev, mixed=True)
            for prec in rungs:
                key = f"{tag}/M{m_loc}/{prec}"
                for name, o in zip(("x0", "yb", "sq"),
                                   ef.stats_fwd(w, b, g, wmb, prec)):
                    out[f"{key}/K3/{name}"] = digest(o)
                out[f"{key}/K4"] = digest(ef.stats_bwd(w, b, g, wmb, *cts,
                                                       prec))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--times", action="store_true")
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
        raise SystemExit("stats_kernels: no CUDA device available")
    dev = torch.device("cuda")
    print(json.dumps({"tree": args.tree, "card": smoke.card_line()}),
          flush=True)
    if args.times:
        recs = times(smoke, dev)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(recs, f, indent=1)
    if args.hashes:
        with open(args.hashes, "w") as f:
            json.dump(hashes(smoke, dev), f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
