"""The kind ``optimize_scvi`` (cell ``scvi10.expected``) at a size the CPU
can hold: a sound run reads ``correct``, a run with half of each chunk's
energies dropped (``faults.py`` ``half_batch``) reads incorrect, its
per-layer metrics read the port's counters, and a port without scVI's
decoder family is refused before anything is built."""

import time

import pytest
import torch

from geobench import faults, harness, run

SMALL = {"classes": 5, "warmup_steps": 1,
         "check": {"sample_pairs": 2, "block": 2},
         "geodesic": {"steps": 4, "lr": 0.01, "batch_size": 3,
                      "energy": {"num_t": 32}}}
CELL = "scvi10.expected"


def _run(trace=False, seed=2**31 + 5):
    return run.run_cell(CELL, seed, 0.01, trace, torch.device("cpu"),
                        overrides=SMALL, t_start=time.perf_counter())


def test_sound_run_is_correct():
    out = _run()
    res = out["result"]
    assert res["correct"] is True, out["numbers"]
    assert list(res["checks"]) == ["final_gap", "grad_gap", "traj_gap",
                                   "k2_other_routes"]
    assert set(res["metrics"]) == {"pairs_per_s", "setup_s"}
    assert res["attempted"] == 3 and res["failed"] == 0


def test_half_batch_reads_incorrect():
    with faults.planted("half_batch"):
        out = _run()
    assert out["result"]["correct"] is False, out["numbers"]


def test_the_cell_reports_its_per_layer_metrics():
    """The softmax metrics read the window's passes (none on the CPU, where
    the plain versions count nothing): None, never 0; the readers of a
    traced chip run find their inputs in ``ctx``."""
    c = harness.cell(CELL)
    names = [m["name"] for m in c.per_layer]
    assert {"k2_softmax_roofline", "softmax_passes_per_step",
            "device_idle.opt", "step_mfu.opt"} <= set(names)
    passes = harness.metric_reader("softmax_passes_per_step")
    assert passes({"kind": "optimize", "softmax_passes": 0,
                   "window_steps": 1000}) is None
    assert passes({"kind": "optimize", "softmax_passes": 4000,
                   "window_steps": 1000}) == 4.0
    roof = harness.metric_reader("k2_softmax_roofline")
    assert roof({"kind": "optimize", "trace": None}) is None
    out = _run(trace=True)
    assert "softmax_passes_per_step" not in out["result"]["metrics"]


def test_a_port_without_the_head_is_refused_at_once(monkeypatch):
    """The parent of the port had no softmax route: the kind raises before
    it draws or decodes anything, and never runs a linear head."""
    from vae_latent_geometry_tpu_torch.ops import energy_fused

    monkeypatch.setattr(energy_fused, "K2_ROUTES",
                        {"one_decode": 0, "fma": 0, "any": 0})
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="softmax head"):
        _run()
    assert time.perf_counter() - t < 5
