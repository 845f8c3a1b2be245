"""Readings that the correctness limits are set from, in one process on the
card:

    python3 geobench/calibrate.py --workload <cell> --seeds 1-12 \
        [--control-seeds 101-103] [--faults frozen,half_batch,altered] \
        [--fault-seeds 201-203] [--seconds 0] [--out FILE]

For every seed the cell runs as the benchmark runs it (the window of
``--seconds``, at least one whole chunk) and the numbers its
comparison computes are recorded: the program's seeds give each number's
lower reading (their largest), the control's seeds (each stage one
precision down: the program's own lower rung as the traffic's
``control.traffic`` switches it on, the final lengths by the reference at
``control.final``) its upper one (their smallest), and each planted fault
(``faults.py``) what it reads.  Prints
one JSON object; ``--out`` writes it too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seed_list(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.001)
    p.add_argument("--control-seconds", type=float, default=0.001)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from geobench import run

    run.cache_dirs()
    import torch

    from geobench import faults

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    runs = []

    def one(seed, producer="program", fault=None):
        t = time.perf_counter()
        seconds = (args.control_seconds if producer == "control"
                   else args.seconds)
        with (faults.planted(fault) if fault
              else contextlib.nullcontext()):
            out = run.run_cell(args.workload, seed, seconds, False, dev,
                               producer, t_start=t)
        rec = {"seed": seed, "producer": producer, "fault": fault,
               "numbers": out["numbers"], "correct": out["result"]["correct"],
               "metrics": out["result"]["metrics"],
               "seconds": time.perf_counter() - t}
        runs.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)

    for s in seed_list(args.seeds):
        one(s)
    for s in seed_list(args.control_seeds):
        one(s, "control")
    for f in filter(None, args.faults.split(",")):
        for s in seed_list(args.fault_seeds):
            one(s, fault=f)

    def reading(sel, fn):
        vals = {}
        for r in runs:
            if sel(r):
                for k, v in r["numbers"].items():
                    vals.setdefault(k, []).append(v)
        return {k: fn(v) for k, v in vals.items()}

    summary = {
        "workload": args.workload, "device": str(dev),
        "card": run.power_limit() if dev.type == "cuda" else "cpu",
        "lower": reading(lambda r: r["producer"] == "program"
                         and not r["fault"], max),
        "upper_control": reading(lambda r: r["producer"] == "control", min),
        "faults": {f: reading(lambda r, f=f: r["fault"] == f, min)
                   for f in filter(None, args.faults.split(","))},
        "runs": runs}
    text = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
