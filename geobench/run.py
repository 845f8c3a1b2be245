"""Run one benchmark cell of the port and print its result line.

    python3 geobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run sets up (inputs and weights from the
seed on the device, the port's kernels built on first use into the
checkout, a warm-up at the cell's shapes), measures for ``--seconds``,
checks what the window produced against the plain reference, and prints
one JSON object as the last line of standard output.  With ``--trace 0``
its metrics are the cell's end-to-end ones, with ``--trace 1`` its
per-layer ones, read from a profiler trace of a steady part of the window.
It exits non-zero and prints no result without a CUDA device, without the
port beside it, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
THREADS = 2


def cache_dirs() -> None:
    """Every cache of the program and its libraries at a fixed path inside
    the checkout (the port builds its kernels into its own ``ops/build``);
    set before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "geobench" / sub)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             producer: str = "program", overrides=None,
             t_start: float = None, root: Path = ROOT,
             bench: dict = None) -> dict:
    """One run of a cell on ``device``: the result line as a dict (its
    ``checks`` last), and the numbers compared, without the chip check.
    ``root``: the checkout whose BENCHMARK.json (or ``bench``) and geobench
    files name the cell."""
    import torch

    from geobench import harness, profiling

    c = harness.cell(name, root, bench, overrides)
    t0 = T_START if t_start is None else t_start
    out = harness.driver(c)(c, seed, seconds, trace, device, t0, producer)

    checks = harness.Checks()
    for k, limit in c.limits.items():
        checks.add(k, out["numbers"][k], limit)
    if trace:
        metrics = harness.per_layer_values(c, out["ctx"])
    else:
        e2e = {**out["e2e"], "setup_s": out["setup_s"]}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c.end_to_end}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": c.chips, "memory_peak_bytes": int(out["memory"])}
    result = {"correct": checks.correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev_info}
    if trace and out["trace"] is not None:
        dev_info["busy_s"] = out["trace"].busy_s
        dev_info["window_s"] = out["trace"].window_s
        result["breakdown"] = profiling.breakdown(out["trace"])
    result["checks"] = checks.as_dict()
    return {"result": result, "numbers": out["numbers"],
            "check_lines": checks.lines(), "trace": out["trace"],
            "setup_s": out["setup_s"], "window_s": out["window_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from geobench import harness

    # load from one process with few threads: the host's share of a step
    # is a single dispatching thread
    torch.set_num_threads(THREADS)
    c = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"geobench: {args.workload} needs {c.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    # outside a checkout (the port not beside the benchmark) this raises
    import vae_latent_geometry_tpu_torch  # noqa: F401

    dev = torch.device("cuda", 0)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   dev)
    found = harness.forbidden_modules()
    if found:
        print(f"geobench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result = out["result"]
    result["device"]["card"] = power_limit()
    info = {k: v for k, v in out["numbers"].items()
            if k not in result["checks"]}
    print(f"geobench: setup {out['setup_s']:.3f} s, window "
          f"{out['window_s']:.3f} s; other readings {json.dumps(info)}",
          file=sys.stderr)
    if out["trace"] is not None:
        print(f"geobench: trace {out['trace'].n_device_ops} device ops, "
              f"reduced in {out['trace'].reduce_s:.2f} s",
              file=sys.stderr)
    for line in out["check_lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
