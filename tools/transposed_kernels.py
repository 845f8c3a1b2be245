#!/usr/bin/env python3
"""One-off measurements of one checkout's transposed-layout kernels (K9 and
K10) on the card.

    python3 tools/transposed_kernels.py --tree <checkout> --times [--out FILE]
    python3 tools/transposed_kernels.py --tree <checkout> --hashes FILE
    python3 tools/transposed_kernels.py --compare FILE_A FILE_B

``--times``: device time by kernel (torch.profiler) of K9 and K10 on the
production chunk (the committed model, the seed-42 init curves padded to
B=200, T=2000, ``chip_smoke.cotangent``) at every rung: ms per launch of
each kernel the call launches, and ms per call by CUDA events (as
``chip_smoke.py`` times the kernels).

``--hashes``: SHA-256 of K9's energies and K10's dgamma on the production
chunk at every rung and on the generic decode (decoder S2 of
``chip_smoke.SHAPES``, T=400, B=100) at every rung, written to FILE.
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


def times(smoke, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    ws, bs, gamma = production_inputs(smoke, dev)
    B = gamma.shape[1]
    ct = torch.as_tensor(smoke.cotangent(B), device=dev)
    out = []
    for prec in RUNGS:
        calls = {"K9": lambda: eft.energy_t_fwd(ws, bs, gamma, prec),
                 "K10": lambda: eft.energy_t_bwd(ws, bs, gamma, ct, prec)}
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
            rec = {"kernel": name, "precision": prec,
                   "ms_by_launch": {k: v / 3e3 for k, v in by.items()},
                   "ms_per_call": sum(by.values()) / 3e3,
                   "ms_per_call_events": smoke.time_ms(fn, 5)}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


def hashes(smoke, dev):
    import torch

    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

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
        ct = torch.as_tensor(smoke.cotangent(g.shape[1]), device=dev)
        for prec in RUNGS:
            out[f"{tag}/{prec}/K9"] = digest(eft.energy_t_fwd(w, b, g, prec))
            out[f"{tag}/{prec}/K10"] = digest(eft.energy_t_bwd(w, b, g, ct,
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
        raise SystemExit("transposed_kernels: no CUDA device available")
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
