"""What a run reads by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its correctness limits
(``limits/<cell>.json``), the module that runs its traffic's kind
(``<kind>.py``) and the per-layer metric readers (``metrics/<metric>.py``);
and what it prints.

Nothing here knows a cell, a configuration, a mix or a metric by name: a
later change adds one as new files and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "vae_latent_geometry_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def merged(base: dict, changes: dict) -> dict:
    """``base`` with the keys of ``changes`` replaced, nested dicts merged
    key by key."""
    out = dict(base)
    for k, v in changes.items():
        out[k] = (merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list            # the end-to-end metrics this cell reports
    per_layer: list             # the per-layer metrics this cell reports
    metrics_dir: Path = HERE / "metrics"
    kind: str = ""

    def __post_init__(self):
        self.kind = self.traffic["kind"]


def _reported_in(metric: dict, cell: str, reported_e2e=None) -> bool:
    """A metric with ``workloads`` is reported in those cells; one without
    in every cell (a per-layer one: every cell that reports what it
    moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if reported_e2e is not None:
        return metric["moves"] in reported_e2e
    return True


def cell(name: str, root: Path = ROOT, bench: Optional[dict] = None,
         overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its files; ``overrides`` replace keys of the
    traffic mix, nested ones key by key (tests run a cell at a size the CPU
    can hold)."""
    bench = bench or spec(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])
    here = root / HERE.name
    traffic = merged(load_json(here / "traffic" / f"{entry['traffic']}.json"),
                     overrides or {})
    limits = load_json(here / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reported_in(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reported_in(m, name, names)]
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                chips=entry["chips"], end_to_end=e2e, per_layer=layer,
                metrics_dir=here / "metrics")


def _module(path: Path):
    """The module of the file ``path``, loaded once."""
    name = f"geobench_file_{abs(hash(str(path)))}"
    mod = sys.modules.get(name)
    if mod is None:
        spec_ = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec_)
        sys.modules[name] = mod
        spec_.loader.exec_module(mod)
    return mod


def driver(c: Cell):
    """``<kind>.py``'s ``run``, beside ``metrics/``: the module that runs
    cells whose traffic mix has that ``kind``."""
    return _module(c.metrics_dir.parent / f"{c.kind}.py").run


def metric_reader(name: str, metrics_dir: Path = HERE / "metrics"):
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value, or None
    where the run gave it nothing to read."""
    return _module(metrics_dir / f"{name}.py").read


def per_layer_values(c: Cell, ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in c.per_layer:
        v = metric_reader(m["name"], c.metrics_dir)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Top-level module names in this process that the port may not load,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class Checks:
    """Each number compared, with its limit: ``correct`` when every one is
    finite and at or below its limit."""
    values: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, value: float, limit: float) -> None:
        self.values[name] = float(value)
        self.limits[name] = float(limit)

    @property
    def correct(self) -> bool:
        return bool(self.values) and all(
            math.isfinite(v) and v <= self.limits[k]
            for k, v in self.values.items())

    def as_dict(self) -> dict:
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in self.values.items()}

    def lines(self) -> list:
        return [f"check {k} {v!r} limit {self.limits[k]!r}"
                for k, v in self.values.items()]
