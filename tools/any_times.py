#!/usr/bin/env python3
"""One-off: the generic decode's kernels of one checkout on the card.

    python3 tools/any_times.py --tree <checkout>            # ms per call
    python3 tools/any_times.py --spills LOG_A.json LOG_B.json

Without ``--spills``: ms per call (``chip_smoke.time_ms``) of every kernel
of ``<checkout>/chip_smoke.shape_kernel_table`` on decoders S2 and S5 (T=400,
B=100, seeded points), each at its summary rung, as one JSON line; run a
parent checkout and this one each in a process of its own, interleaved
(parent, change, change, parent).  With ``--spills``: the kernels whose
ptxas report shows a stack frame or spill, in each of two build logs
(``json.dump(_build.BUILD_LOG)`` of a fresh build of each tree).  Needs
one CUDA GPU for the times.
"""

import argparse
import importlib.util
import json
import os
import re
import sys


def spills(path):
    logs = json.load(open(path))
    bad = []
    for log in logs.values():
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}\d+", "", m.group(1))[:30]
            elif fn and "spill stores" in line and not line.strip().startswith("0 bytes stack"):
                bad.append(f"{fn}: {line.strip()}")
    return bad


def times(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_tree", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    dev = torch.device("cuda")
    g = torch.as_tensor((1.5 * np.random.default_rng(400).normal(
        size=(400, 100, 2))).astype(np.float32), device=dev)
    out = {"tree": tree, "card": cs.card_line()}
    for name in ("S2", "S5"):
        dims, M = cs.SHAPES[name]
        table, _ = cs.shape_kernel_table(ef, mc, eft, name, M, g, dev,
                                         len(dims) == 4)
        for k, e in table.items():
            out[f"{name}/{k}/{e[-1]}"] = round(cs.time_ms(
                lambda: e[1](e[-1]), 3), 3)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--spills", nargs=2)
    args = ap.parse_args()
    if args.spills:
        for path in args.spills:
            bad = spills(path)
            print(json.dumps({"log": path, "with_stack_or_spill": len(bad),
                              "kernels": bad}))
        return 0
    print(json.dumps(times(args.tree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
