"""The port's spans (``utils.profiling.trace_annotation``): what the
recorder keeps off and on, its clock against ``torch.profiler``'s, the spans
of the geodesic path, the readings made from them, the Chrome trace the CLI
writes, and the kernel build's wait for its compilers.

No JAX here: the test marked ``gpu`` (the device times, on the card) runs
with ``python -m pytest --noconftest tests/test_torch_tracing.py -m gpu``."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_small_inputs  # noqa: F401  (one torch thread)
from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
from vae_latent_geometry_tpu_torch.models.evae import load_npz
from vae_latent_geometry_tpu_torch.ops import _build
from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
    optimize_spline_batch,
)
from vae_latent_geometry_tpu_torch.utils import profiling
from vae_latent_geometry_tpu_torch.utils.profiling import (
    Span,
    recording,
    trace_annotation,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "experiment", "model_seed42.npz")
INIT = os.path.join(REPO, "experiment", "splines_init_model_seed42",
                    "spline_batch_init_entropy_20.npz")


@pytest.fixture(autouse=True)
def _empty_recorder():
    """Each test starts and ends with nothing kept."""
    profiling.spans()
    yield
    profiling.spans()


def _first(art, n):
    return dataclasses.replace(
        art, a=art.a[:n], b=art.b[:n], omega_init=art.omega_init[:n],
        pair_indices=art.pair_indices[:n], valid=art.valid[:n],
        pair_labels=art.pair_labels[:n])


def _span(name, start, end, parent=None, id_=None, device=None, **args):
    s = Span(name, args)
    s.start_ns, s.end_ns, s.parent, s.id, s.tid = start, end, parent, id_, 1
    s.device = device
    return s


def test_off_span_keeps_nothing_and_costs_a_flag_check():
    a = trace_annotation("opt.step", step=3)
    assert a is trace_annotation("opt.loss")      # one shared object
    with a:
        pass
    n = 100_000
    t0 = time.perf_counter()
    for i in range(n):
        with trace_annotation("opt.step", step=i):
            pass
    per_span = (time.perf_counter() - t0) / n
    assert per_span < 2e-6, f"{per_span * 1e6:.2f} us a span"
    assert profiling.spans() == []


def test_on_span_keeps_names_nesting_and_parents():
    with recording():
        with trace_annotation("pipeline.chunk", chunk=0, pairs=5) as c:
            with trace_annotation("opt.step", step=0) as s0:
                with trace_annotation("opt.loss"):
                    pass
            with trace_annotation("opt.step", step=1):
                pass
        with trace_annotation("opt.final"):
            pass
    assert trace_annotation("opt.step") is trace_annotation("opt.loss")
    kept = profiling.spans()
    assert [s.name for s in kept] == ["opt.loss", "opt.step", "opt.step",
                                      "pipeline.chunk", "opt.final"]
    loss, step0, step1, chunk, final = kept
    assert chunk is c and step0 is s0
    assert chunk.parent is None and final.parent is None
    assert step0.parent == chunk.id and step1.parent == chunk.id
    assert loss.parent == step0.id
    assert len({s.id for s in kept}) == 5
    assert chunk.args == {"chunk": 0, "pairs": 5}
    assert step0.args == {"step": 0} and step1.args == {"step": 1}
    assert chunk.start_ns <= step0.start_ns <= loss.start_ns
    assert loss.end_ns <= step0.end_ns <= step1.start_ns <= chunk.end_ns
    assert final.start_ns >= chunk.end_ns
    assert all(s.device is None and "lead" not in s.args for s in kept)
    assert profiling.spans() == []                 # read once


def test_timed_span_keeps_its_clock_with_the_recorder_off():
    with trace_annotation("run.encode", timed=True) as span:
        time.sleep(0.01)
    assert 0.01 <= span.seconds < 1.0
    assert profiling.spans() == []
    with recording(), trace_annotation("run.encode", timed=True) as span:
        time.sleep(0.01)
    assert 0.01 <= span.seconds < 1.0
    assert profiling.spans() == [span]


def test_record_interval_nests_under_the_open_span():
    profiling.record_interval("ops.build", 1, 2, source="x")   # off: dropped
    with recording():
        with trace_annotation("ops.library", source="energy_mc") as lib:
            profiling.record_interval("ops.build", 10, 20, source="energy_mc")
    build, outer = profiling.spans()
    assert outer is lib
    assert (build.name, build.start_ns, build.end_ns) == ("ops.build", 10, 20)
    assert build.parent == lib.id and build.args == {"source": "energy_mc"}


def test_span_start_lies_on_the_profiler_clock():
    """A span's start on ``time.time_ns()`` and its ``record_function``
    range's start in the kineto trace are within 1 ms of each other."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording():
            with trace_annotation("vlg.clock_probe") as span:
                torch.ones(8) @ torch.ones(8)
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "vlg.clock_probe"]
    assert len(starts) == 1
    assert abs(starts[0] - span.start_ns) < 1_000_000, (
        starts[0] - span.start_ns)


def test_optimize_spline_batch_spans_on_cpu():
    """Chunk -> phase -> steps (loss, backward, adam) and the final pass,
    read-back after it, under one ``pipeline.optimize``; 5 pairs in chunks
    of 3 (the second one padded)."""
    art = _first(load_spline_batch(INIT), 5)
    cfg = GeodesicConfig(steps=3, batch_size=3, energy=EnergyConfig(
        num_t=16, mode="expected_fused", kernel_precision="f32x2"))
    params = load_npz(MODEL, "cpu")
    with recording():
        out = optimize_spline_batch(params, art, cfg=cfg, device="cpu",
                                    log_every_chunk=False)
    assert np.isfinite(out.geodesic_length).all()
    kept = profiling.spans()
    by_id = {s.id: s for s in kept}

    def kids(span, name):
        return sorted((s for s in kept if s.parent == span.id
                       and s.name == name), key=lambda s: s.start_ns)

    (top,) = profiling.named(kept, "pipeline.optimize")
    assert top.parent is None
    chunks = kids(top, "pipeline.chunk")
    assert [c.args for c in chunks] == [{"chunk": 0, "pairs": 3},
                                        {"chunk": 1, "pairs": 2}]
    for c in chunks:
        (phase,) = kids(c, "opt.phase")
        assert phase.args == {"phase": 0, "steps": 3}
        steps = kids(phase, "opt.step")
        assert [s.args for s in steps] == [{"step": i} for i in range(3)]
        for s in steps:
            for part in ("opt.loss", "opt.backward", "opt.adam"):
                assert len(kids(s, part)) == 1, part
        (final,) = kids(c, "opt.final")
        (readback,) = kids(c, "pipeline.readback")
        assert phase.end_ns <= final.start_ns <= readback.start_ns
        assert c.start_ns <= phase.start_ns and readback.end_ns <= c.end_ns
    # the CPU runs the plain versions: no kernel, no op span, no device time
    assert not [s for s in kept if s.name.startswith(("op.", "ops."))]
    assert all(s.device is None for s in kept)
    assert all(s.parent is None or s.parent in by_id for s in kept)
    assert len(kept) == 1 + 2 * (1 + 1 + 3 * 4 + 1 + 1)


def test_readings_of_synthetic_spans():
    """step, host-lead and chunk-edge readings, and idle gaps put down to
    the innermost span, on spans with known answers."""
    ms = 1_000_000
    chunk = _span("pipeline.chunk", 0, 100 * ms, id_=1, chunk=0, pairs=2)
    phase = _span("opt.phase", 5 * ms, 80 * ms, parent=1, id_=2, phase=0,
                  steps=3)
    # the device ends a step every 30 ms: 3 steps are 90 ms of the chunk
    steps = [_span("opt.step", (10 + 20 * i) * ms, (20 + 20 * i) * ms,
                   parent=2, id_=3 + i, device=(1, 30.0 * (i + 1)),
                   step=i, lead=lead)
             for i, lead in enumerate((0, 4, 7))]
    readback = _span("pipeline.readback", 85 * ms, 99 * ms, parent=1, id_=6)
    other = _span("pipeline.chunk", 200 * ms, 300 * ms, id_=7, chunk=1,
                  pairs=2)   # no device times: left out of the edges
    kept = [*steps, phase, readback, chunk, other]
    assert profiling.step_ms(kept) == [30.0, 30.0]
    assert profiling.host_leads(kept) == [0, 4, 7]
    assert profiling.chunk_edges_ms(kept) == [pytest.approx(10.0)]
    assert profiling.named(kept, "opt.step") == steps
    assert profiling.within(kept, phase) == steps
    # two reads are never compared: a step's pace is within one read
    again = [_span("opt.step", 0, 1, device=(2, 7.0), lead=1),
             _span("opt.step", 2, 3, device=(3, 2.0), lead=1)]
    assert profiling.step_ms(again) == []
    gaps = [(12 * ms, 14 * ms),       # in step 0
            (21 * ms, 29 * ms),       # between steps: the phase
            (90 * ms, 92 * ms),       # the read-back
            (150 * ms, 151 * ms)]     # between the chunks
    idle = profiling.by_innermost(kept, gaps)
    assert idle == {"opt.phase": pytest.approx(8e-3),
                    "opt.step": pytest.approx(2e-3),
                    "pipeline.readback": pytest.approx(2e-3),
                    "outside any span": pytest.approx(1e-3)}
    assert list(idle)[0] == "opt.phase"           # largest first


def test_chrome_trace_holds_every_span(tmp_path):
    with recording():
        with trace_annotation("pipeline.chunk", chunk=2, pairs=7):
            with trace_annotation("opt.final"):
                pass
    kept = profiling.spans()
    path = tmp_path / "spans.json"
    profiling.write_chrome_trace(str(path), kept)
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["opt.final", "pipeline.chunk"]
    for e, s in zip(events, kept):
        assert e["ph"] == "X" and e["cat"] == s.name.split(".")[0]
        assert e["ts"] == pytest.approx(s.start_ns / 1e3)
        assert e["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3)
        assert e["args"]["id"] == s.id and e["args"]["parent"] == s.parent
    assert events[1]["args"]["chunk"] == 2
    assert events[0]["args"]["parent"] == events[1]["args"]["id"]


def test_cli_optimize_writes_its_spans(tmp_path):
    from vae_latent_geometry_tpu_torch.io.artifacts import save_spline_batch

    init = tmp_path / "init.npz"
    save_spline_batch(_first(load_spline_batch(INIT), 3), str(init))
    spans = tmp_path / "spans.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([
        sys.executable, "-m", "vae_latent_geometry_tpu_torch", "optimize",
        "--device", "cpu", "--model", MODEL, "--splines", str(init),
        "--steps", "2", "--num-t", "16", "--no-euclidean", "--energy-mode",
        "expected_fused", "--output", str(tmp_path / "opt.npz"), "--spans",
        str(spans)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"[spans] {spans}" in r.stdout
    names = [e["name"] for e in json.loads(spans.read_text())["traceEvents"]]
    assert names.count("pipeline.optimize") == 1
    assert names.count("pipeline.chunk") == 1
    assert names.count("opt.step") == 2 and names.count("opt.final") == 1


class _FakeNvcc:
    """``subprocess.Popen`` of ``nvcc``: finishes after ``polls`` polls and
    then writes its ``-o`` file."""

    started = []

    def __init__(self, cmd, stdout=None, stderr=None, text=None):
        self.out = cmd[cmd.index("-o") + 1]
        self.polls, self.returncode = 3, None
        stdout.write("ptxas info: 0 bytes stack frame\n")
        _FakeNvcc.started.append(self)

    def poll(self):
        if self.returncode is None:
            self.polls -= 1
            if self.polls == 0:
                with open(self.out, "wb") as f:
                    f.write(b"so")
                self.returncode = 0
        return self.returncode


def test_build_waits_for_its_own_compilers(tmp_path, monkeypatch):
    """A second build of a source in one process waits for its compiler
    (a name left from an earlier build once let it read a running
    compiler's ``returncode`` None as a failure); each compiler is an
    ``ops.build`` span."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "a")
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_build.time, "sleep", lambda s: None)
    _FakeNvcc.started = []
    with recording():
        first = _build.build_all(["energy_mc", "energy_stats"])
        assert set(first) == {"energy_mc", "energy_stats"}
        assert _build.build_all(["energy_mc"]) == {}     # built: nothing
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
        again = _build.build_all(["energy_mc"])
    assert list(again) == ["energy_mc"]
    assert len(_FakeNvcc.started) == 3
    assert all(p.returncode == 0 for p in _FakeNvcc.started)
    assert _build._target("energy_mc").exists()
    assert "ptxas info" in _build.BUILD_LOG["energy_mc"]
    builds = profiling.named(profiling.spans(), "ops.build")
    assert sorted(s.args["source"] for s in builds) == [
        "energy_mc", "energy_mc", "energy_stats"]
    assert all(s.end_ns >= s.start_ns for s in builds)


def test_library_load_is_one_span(monkeypatch):
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", lambda names: {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    with recording():
        lib = _build.library("energy_mc")
        assert _build.library("energy_mc") is lib     # loaded: no span
    (span,) = profiling.spans()
    assert span.name == "ops.library" and span.args == {"source": "energy_mc"}


@pytest.mark.gpu
def test_device_times_and_host_lead_on_gpu():
    """On the card: every step's events are read at the chunk's read-back,
    the steps' pace is positive, the host lead is counted, and the op
    spans match the launch counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.ops import energy_fused

    dev = torch.device("cuda")
    art = _first(load_spline_batch(INIT), 16)
    cfg = GeodesicConfig(steps=40, batch_size=8, energy=EnergyConfig(
        num_t=256, mode="expected_fused", kernel_precision="f32x2"))
    params = load_npz(MODEL, dev)
    optimize_spline_batch(params, art, cfg=cfg, device=dev,
                          log_every_chunk=False)      # build and warm up
    launches0 = sum(energy_fused.LAUNCHES.values())
    with recording():
        out = optimize_spline_batch(params, art, cfg=cfg, device=dev,
                                    log_every_chunk=False)
    launches = sum(energy_fused.LAUNCHES.values()) - launches0
    assert np.isfinite(out.geodesic_length).all()
    kept = profiling.spans()
    steps = profiling.named(kept, "opt.step")
    assert len(steps) == 80
    assert all(s.device is not None for s in steps)
    assert not [s for s in kept if s.device is not None
                and s.name != "opt.step"]
    paces = profiling.step_ms(kept)
    assert len(paces) == 78 and min(paces) > 0      # 39 a chunk
    leads = profiling.host_leads(kept)
    assert len(leads) == 80 and min(leads) >= 0
    edges = profiling.chunk_edges_ms(kept)
    assert len(edges) == 2 and min(edges) > 0
    ops = [s for s in kept if s.name.startswith("op.")]
    assert len(ops) == launches == 2 * (40 + 1)
    assert not [s for s in kept if s.name == "ops.library"]
