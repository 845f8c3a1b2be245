"""A configuration, a traffic mix, a per-layer metric and a cell are found
by name alone: a later change adds files and entries and edits none."""

import json
import shutil
import time

import torch

from geobench import harness

TINY = {"classes": 5, "warmup_steps": 1, "check": {"sample_pairs": 2}}


def _checkout(tmp_path):
    """A copy of the benchmark's files in a fresh checkout root."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / harness.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _add_cell(root):
    """New files only, and new entries in BENCHMARK.json."""
    here = root / harness.HERE.name
    cfg = json.loads((here / "configs" / "evae10.json").read_text())
    cfg.update(name="evae4", num_decoders=4, reduced=["num_decoders"])
    (here / "configs" / "evae4.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "expected.json").read_text())
    traffic.update(TINY, geodesic={
        "steps": 3, "lr": 0.01, "batch_size": 3,
        "energy": {"num_t": 32, "mode": "expected_fused",
                   "kernel_precision": "float32"}})
    (here / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (here / "limits" / "evae4.tiny.json").write_text(json.dumps(
        {"final_gap": 1e-4, "traj_gap": 1e-3}))
    (here / "metrics" / "chunk_pairs.py").write_text(
        "def read(ctx):\n"
        "    if ctx.get('kind') != 'optimize':\n"
        "        return None\n"
        "    return float(ctx['window_steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "evae4", "source": "https://example.org",
                             "file": "geobench/configs/evae4.json",
                             "reduced": ["num_decoders"], "why": "test"})
    bench["workloads"].append({"name": "evae4.tiny", "config": "evae4",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append("evae4.tiny")
    bench["per_layer"].append({"name": "chunk_pairs", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "optimizer", "moves": "pairs_per_s",
                               "workloads": ["evae4.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found_by_name(tmp_path):
    root = _checkout(tmp_path)
    _add_cell(root)
    c = harness.cell("evae4.tiny", root)
    assert c.config["num_decoders"] == 4
    assert c.traffic["geodesic"]["batch_size"] == 3
    assert c.limits == {"final_gap": 1e-4, "traj_gap": 1e-3}
    assert [m["name"] for m in c.end_to_end] == ["pairs_per_s", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["chunk_pairs"]
    assert harness.per_layer_values(c, {"kind": "optimize",
                                         "window_steps": 6}) == {
        "chunk_pairs": {"value": 6.0, "unit": "steps"}}
    # the cells already there are untouched
    assert harness.cell("evae10.expected", root).config["num_decoders"] == 10


def test_a_new_cell_runs_end_to_end(tmp_path):
    from geobench import run

    root = _checkout(tmp_path)
    _add_cell(root)
    out = run.run_cell("evae4.tiny", 3, 0.01, False, torch.device("cpu"),
                       t_start=time.perf_counter(), root=root)
    res = out["result"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {"pairs_per_s", "setup_s"}
    assert list(res["checks"]) == ["final_gap", "traj_gap"]
    traced = run.run_cell("evae4.tiny", 3, 0.01, True, torch.device("cpu"),
                          t_start=time.perf_counter(), root=root)
    assert traced["result"]["metrics"]["chunk_pairs"]["value"] == 3.0


KIND = """\
def run(cell, seed, seconds, trace, dev, t_start, producer="program"):
    n = cell.traffic["answers"]
    return {"setup_s": 0.5, "window_s": 1.0, "e2e": {"pairs_per_s": n},
            "attempted": n, "failed": 0, "memory": 0,
            "numbers": {"answer_gap": 0.0}, "ctx": {"kind": "echo"},
            "trace": None}
"""


def test_a_new_kind_is_found_by_name(tmp_path):
    """A traffic mix of a kind no cell has yet runs through its own
    ``<kind>.py``: one new file, no edit to the harness."""
    from geobench import run

    root = _checkout(tmp_path)
    here = root / harness.HERE.name
    (here / "echo.py").write_text(KIND)
    (here / "traffic" / "echo.json").write_text(json.dumps(
        {"kind": "echo", "answers": 7}))
    (here / "limits" / "evae10.echo.json").write_text(json.dumps(
        {"answer_gap": 0.0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "evae10.echo", "config": "evae10",
                               "traffic": "echo", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append("evae10.echo")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run.run_cell("evae10.echo", 3, 0.01, False, torch.device("cpu"),
                       t_start=time.perf_counter(), root=root)
    res = out["result"]
    assert res["correct"] is True and res["attempted"] == 7
    assert res["metrics"]["pairs_per_s"]["value"] == 7.0
