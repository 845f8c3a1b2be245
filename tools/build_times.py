#!/usr/bin/env python3
"""Where the kernels' build time goes: each source's nvcc, by phase.

    python3 tools/build_times.py [--extra "<nvcc flags>"] [--out FILE]

Compiles every kernel source of ``ops/csrc`` as ``ops/_build.py`` does (its
flags, one nvcc per source, all started together) into a temporary
directory, with ``--time`` so that nvcc writes the seconds of each of its
phases (cicc: the front end and NVVM optimizer; ptxas: PTX to SASS), plus
``--extra`` flags to try.  Prints one JSON object: the wall seconds of each
source and of the whole build, and each source's phase seconds.  Needs the
CUDA toolkit (run it on the card's machine).
"""

import argparse
import csv
import json
import os
import shlex
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vae_latent_geometry_tpu_torch.ops import _build  # noqa: E402


def _number(text):
    try:
        float(text)
    except ValueError:
        return False
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--extra", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    extra = shlex.split(args.extra)
    res = {"flags": _build.NVCC_FLAGS + extra, "wall_s": {}, "phases_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {}
        for name in _build.SIGNATURES:
            times = os.path.join(tmp, f"{name}.csv")
            procs[name] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "--time", times,
                 "-o", os.path.join(tmp, f"lib{name}.so"),
                 str(_build.CSRC / f"{name}.cu")],
                stdout=subprocess.DEVNULL,
                stderr=open(times + ".log", "w")), times)
        while len(res["wall_s"]) < len(procs):
            for name, (proc, _) in procs.items():
                if name not in res["wall_s"] and proc.poll() is not None:
                    res["wall_s"][name] = time.perf_counter() - t0
            time.sleep(0.1)
        res["build_s"] = time.perf_counter() - t0
        for name, (proc, times) in procs.items():
            if proc.returncode:
                with open(times + ".log") as f:
                    raise SystemExit(f"nvcc failed for {name}:\n{f.read()}")
            phases = {}
            with open(times) as f:
                rows = [[c.strip() for c in r] for r in csv.reader(f)]
            for row in rows[1:]:
                nums = [float(c) for c in row if _number(c)]
                if len(row) > 1 and nums:
                    scale = 1e-3 if "ms" in row else 1.0
                    phases[row[1]] = phases.get(row[1], 0.0) + nums[-1] * scale
            res["phases_s"][name] = phases
            res.setdefault("header", rows[0] if rows else [])
    text = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
