"""The shape of a run's result line and its refusals."""

import json
import time

import pytest
import torch

from geobench import run
from geobench import harness

TINY = {
    "evae10.expected": {"classes": 5, "warmup_steps": 1,
                        "check": {"sample_pairs": 2},
                        "geodesic": {"steps": 3, "lr": 0.01, "batch_size": 3,
                                     "energy": {"num_t": 32,
                                                "mode": "expected_fused",
                                                "kernel_precision": "f32x2"}}},
}


def _check_shape(res, cell, trace):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool)
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    assert res["failed"] == 0
    c = harness.cell(cell)
    want = c.per_layer if trace else c.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name]
        assert isinstance(m["value"], float)
    if not trace:
        assert set(res["metrics"]) == set(units)
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in res["device"]
    for k, v in res["checks"].items():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(res))


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    out = run.run_cell(cell, 2**31 + 11, 0.01, trace, torch.device("cpu"),
                       overrides=TINY[cell], t_start=time.perf_counter())
    _check_shape(out["result"], cell, trace)
    assert out["check_lines"] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in out["result"]["checks"].items()]
    if trace:
        assert out["result"]["device"]["window_s"] > 0
        assert set(out["result"]["breakdown"]) == {"device_ops",
                                                   "idle_gaps"}


def test_no_result_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "evae10.expected", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.cell("no.such.cell")


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    assert harness.forbidden_modules() == [] or "jax" not in sys.modules
    monkeypatch.setitem(sys.modules, "vae_latent_geometry_tpu_torchx",
                        types.ModuleType("x"))
    assert "vae_latent_geometry_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vae_latent_geometry_tpu.ops",
                        types.ModuleType("y"))
    assert "vae_latent_geometry_tpu" in harness.forbidden_modules()


@pytest.mark.gpu
def test_run_on_the_card(cuda):
    import subprocess
    import sys

    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"),
                        "--workload", "evae10.expected", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    _check_shape(res, "evae10.expected", False)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
