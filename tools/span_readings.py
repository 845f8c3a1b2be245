"""The port's spans read in one run of a benchmark cell, on the card.

    python3 tools/span_readings.py --workload evae10.expected --seed 11 \
        --seconds 20 --trace 1 --record 1 [--tree DIR] [--out FILE]
    python3 tools/span_readings.py --workload evae10.mc --seed 21 \
        --seconds 20 --cost 6 [--out FILE]

One run: ``geobench/run.py``'s run of the cell (``run_cell``) with the span
recorder on from before its set-up (``--record 1``), and, under
``--trace 1``, the raw profiler trace of the chunk ``geobench`` profiles
kept as well.  It prints one JSON object: the cell's result line, and

- ``setup_kernels_s``: seconds in ``ops.library`` spans before the window
  (the first window chunk's ``pipeline.optimize`` starts it);
  ``setup_first_call_s``: the warm-up's ``pipeline.optimize`` less the
  ``ops.library`` spans inside it;
- over the window's chunks other than the profiled one: ``step_ms.opt``
  (median device ms between consecutive ``opt.step`` end events),
  ``step_ms.p99.opt``, ``host_lead_steps.opt`` (median ``lead``),
  ``chunk_edge_ms.opt`` (median chunk wall less its steps' device time),
  and each chunk's wall against edge + steps x step;
- ``op_spans`` against the launch counters (the whole run), and the
  profiled chunk's synchronize calls and idle seconds by innermost span.

``--cost N``: in one process, a warm-up run and then 2N windows at
``--trace 0``, the recorder off and on in turns (off, on, on, off, ...):
each window's pairs/s.  ``--tree DIR``: run the checkout in ``DIR`` (its
``geobench`` and port); a port without the recorder runs with none.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

T_START = time.perf_counter()
REPO = Path(__file__).resolve().parent.parent
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def _median(values):
    return statistics.median(values) if values else None


def span_readings(vp, kept, trace: bool) -> dict:
    """The readings of one run's spans (module docstring)."""
    opts = vp.named(kept, "pipeline.optimize")
    if len(opts) < 2:
        return {}
    warm, window = opts[0], opts[1:]
    start = window[0].start_ns
    libs = vp.named(kept, "ops.library")
    out = {"setup_kernels_s": sum(s.seconds for s in libs
                                  if s.end_ns <= start),
           "setup_first_call_s": warm.seconds - sum(
               s.seconds for s in vp.within(libs, warm))}
    ids = {w.id for w in window}
    chunks = [c for c in vp.named(kept, "pipeline.chunk") if c.parent in ids]
    measured = chunks[1:] if trace else chunks
    inside = [s for c in measured for s in [c, *vp.within(kept, c)]]
    steps = vp.step_ms(inside)
    leads = vp.host_leads(inside)
    edges = vp.chunk_edges_ms(inside)
    out.update({
        "chunks": len(chunks), "chunks_read": len(measured),
        "step_ms.opt": _median(steps),
        "step_ms.p99.opt": (float(np.quantile(steps, 0.99)) if steps
                            else None),
        "step_ms.min_max": [min(steps), max(steps)] if steps else None,
        "steps_read": len(steps),
        "host_lead_steps.opt": _median(leads),
        "host_lead_quartiles": (statistics.quantiles(leads, n=4)
                                if len(leads) > 1 else None),
        "chunk_edge_ms.opt": _median(edges), "chunk_edges_ms": edges})
    if steps:
        step = _median(steps)
        out["chunk_wall_vs_edge_plus_steps"] = [
            [c.seconds * 1e3, e + len(vp.within(
                vp.named(inside, "opt.step"), c)) * step]
            for c, e in zip(measured, edges)]
    # the window's own spans by name, their host seconds
    names = Counter()
    host = Counter()
    for s in kept:
        if s.start_ns >= start:
            names[s.name] += 1
            host[s.name] += s.seconds
    out["window_span_counts"] = dict(names)
    out["window_span_host_s"] = dict(host)
    return out


def profiled_chunk(gp, vp, raw, kept) -> dict:
    """Synchronize calls and idle seconds (by innermost span) of the chunk
    ``geobench`` profiled."""
    prof = raw[0]
    dev, host = gp._events(prof)
    merged = gp._union([(s, e) for _, s, e in dev])
    holes = [(e0, s1) for (_, e0), (s1, _) in zip(merged[:-1], merged[1:])]
    syncs = Counter(name for name, _, _ in host if name in SYNC_CALLS)
    out = {"syncs": dict(syncs), "idle_s": sum(b - a for a, b in holes)
           * 1e-9}
    if vp is not None and kept:
        idle = vp.by_innermost(kept, holes)
        total = sum(idle.values())
        out["idle_spans"] = [[k, v] for k, v in idle.items()]
        out["idle_named_share"] = (1.0 - idle.get(vp.OUTSIDE, 0.0)
                                   / total) if total else None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    p.add_argument("--cost", type=int, default=0)
    p.add_argument("--tree", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cpu: a rehearsal of the tool at --overrides' size")
    p.add_argument("--overrides", default=None,
                   help="JSON: keys of the traffic mix replaced")
    args = p.parse_args(argv)
    root = Path(args.tree).resolve() if args.tree else REPO
    sys.path.insert(0, str(root))
    from geobench import run as grun

    grun.cache_dirs()
    import torch

    from geobench import profiling as gp
    from vae_latent_geometry_tpu_torch.ops import energy_fused
    from vae_latent_geometry_tpu_torch.utils import profiling

    torch.set_num_threads(grun.THREADS)
    vp = profiling if hasattr(profiling, "recording") else None
    raws = []
    capture = gp.capture
    gp.capture = lambda fn: raws.append(capture(fn)) or raws[-1]
    dev = torch.device(args.device, 0) if args.device == "cuda" else (
        torch.device(args.device))
    over = json.loads(args.overrides) if args.overrides else None

    def recorder(on):
        return vp.recording() if on and vp else contextlib.nullcontext()

    rec = {"workload": args.workload, "tree": str(root),
           "card": grun.power_limit(), "recorder": vp is not None}
    if args.cost:
        runs = []
        order = [False] + [i % 4 in (1, 2) for i in range(2 * args.cost)]
        for i, on in enumerate(order):
            with recorder(on):
                out = grun.run_cell(args.workload, args.seed + i,
                                    args.seconds, False, dev,
                                    overrides=over,
                                    t_start=time.perf_counter())
            if vp:
                vp.spans()
            r = out["result"]
            runs.append({"recorder": on, "warm_up": i == 0,
                         "correct": r["correct"],
                         "pairs_per_s": r["metrics"]["pairs_per_s"]["value"],
                         "window_s": out["window_s"]})
            print(json.dumps(runs[-1]), flush=True)
        for on in (False, True):
            v = [x["pairs_per_s"] for x in runs[1:] if x["recorder"] == on]
            rec["on" if on else "off"] = {"pairs_per_s": v,
                                          "median": statistics.median(v)}
        rec["runs"] = runs
    else:
        with recorder(args.record):
            out = grun.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), dev, overrides=over,
                                t_start=T_START)
        kept = vp.spans() if vp else []
        r = out["result"]
        rec.update({"seed": args.seed, "correct": r["correct"],
                    "metrics": r["metrics"], "setup_s": out["setup_s"],
                    "window_s": out["window_s"],
                    "attempted": r["attempted"]})
        if kept:
            rec.update(span_readings(vp, kept, bool(args.trace)))
            rec["op_spans"] = sum(1 for s in kept
                                  if s.name.startswith("op."))
            rec["launches"] = sum(energy_fused.LAUNCHES.values())
            rec["setup_parts_s"] = (rec["setup_kernels_s"]
                                    + rec["setup_first_call_s"])
        if raws:
            rec["profiled"] = profiled_chunk(gp, vp, raws[0], kept)
            rec["breakdown"] = r.get("breakdown")
    text = json.dumps(rec)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
