#!/usr/bin/env python3
"""One-off measurements of one checkout's K2 (the expected energy's
gradient, ``energy_fused.energy_bwd``) and K10 on the card.

    python3 tools/k2_kernels.py --tree <checkout> --times [--out FILE]
    python3 tools/k2_kernels.py --tree <checkout> --hashes FILE
    python3 tools/k2_kernels.py --compare FILE_A FILE_B

``--times``: device time by kernel (torch.profiler, 5 calls after a warm-up)
and ms per call by CUDA events (``chip_smoke.time_ms``, 10 calls) of K2 on
the production chunk (the committed model, the seed-42 init curves padded
to B=200, T=2000, ``chip_smoke.cotangent``) at every rung, of K2 at M=1,
f32x3, B=500 (golden's shape: decoder 0, the curves repeated), and of K10
at f32x2 on the production chunk.

``--hashes``: SHA-256 of K2's dgamma on the production chunk at every rung,
at M=1, and on the generic decode (decoder S2 of ``chip_smoke.SHAPES``,
T=400, B=100), written to FILE.  ``--compare`` prints which entries of two
such files differ: run ``--hashes`` on a parent checkout and on this one,
each in a process of its own, on one card.

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


def _cases(smoke, dev):
    """(name, fn) of every call --times measures."""
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    ws, bs, gamma = production_inputs(smoke, dev)
    B = gamma.shape[1]
    ct = torch.as_tensor(smoke.cotangent(B), device=dev)
    wmb = ef.uniform_weights(ws[0].shape[0], B, dev)
    cases = [(f"K2 {p}", lambda p=p: ef.energy_bwd(ws, bs, gamma, wmb, ct, p))
             for p in RUNGS]
    ws1 = [w[:1].contiguous() for w in ws]
    bs1 = [b[:1].contiguous() for b in bs]
    g500 = gamma[:, np.arange(500) % B].contiguous()
    ct500 = torch.as_tensor(smoke.cotangent(500), device=dev)
    w500 = ef.uniform_weights(1, 500, dev)
    cases.append(("K2 M=1 f32x3 B=500", lambda: ef.energy_bwd(
        ws1, bs1, g500, w500, ct500, "f32x3")))
    cases.append(("K10 f32x2", lambda: eft.energy_t_bwd(
        ws, bs, gamma, ct, "f32x2")))
    return cases


def times(smoke, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = []
    for name, fn in _cases(smoke, dev):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = e.name.replace("(anonymous namespace)::", "")
                key = key.replace("void ", "").split("(")[0][:60]
                by[key] = by.get(key, 0.0) + e.time_range.elapsed_us()
        rec = {"call": name,
               "ms_by_launch": {k: v / 5e3 for k, v in by.items()},
               "ms_per_call": sum(by.values()) / 5e3,
               "ms_per_call_events": smoke.time_ms(fn, 10)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def hashes(smoke, dev):
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    ws, bs, gamma = production_inputs(smoke, dev)
    rng = np.random.default_rng(400)
    g_any = torch.as_tensor((1.5 * rng.normal(size=(400, 100, 2))).astype(
        np.float32), device=dev)
    layers = smoke.shape_layers("S2")
    ws_any = [torch.as_tensor(w, device=dev) for w, _ in layers]
    bs_any = [torch.as_tensor(b, device=dev) for _, b in layers]
    out = {}
    for tag, (w, b, g) in {
            "production": (ws, bs, gamma),
            "production_M1": ([x[:1].contiguous() for x in ws],
                              [x[:1].contiguous() for x in bs], gamma),
            "S2": (ws_any, bs_any, g_any)}.items():
        B, M = g.shape[1], w[0].shape[0]
        ct = torch.as_tensor(smoke.cotangent(B), device=dev)
        wmb = ef.uniform_weights(M, B, dev)
        for prec in RUNGS:
            out[f"{tag} {prec}"] = digest(ef.energy_bwd(w, b, g, wmb, ct,
                                                        prec))
    torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--hashes")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(f)) for f in args.compare)
        for k in sorted(set(a) | set(b)):
            print(f"{k}: {'same' if a.get(k) == b.get(k) else 'DIFFERS'}")
        return 0
    tree = os.path.abspath(args.tree)
    smoke = load_tree(tree)
    import torch

    dev = torch.device("cuda")
    if args.times:
        rec = {"tree": tree, "card": smoke.card_line(),
               "times": times(smoke, dev)}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f, indent=1)
    if args.hashes:
        with open(args.hashes, "w") as f:
            json.dump(hashes(smoke, dev), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
