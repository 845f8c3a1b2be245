"""Timing and tracing helpers (``vae_latent_geometry_tpu.utils.profiling``).

- ``sync``: wait for the CUDA work behind every tensor of a tree (CUDA
  launches return before the work is done).
- ``Timer`` / ``time_fn``: host-clock timing with a synchronize before
  each clock read.
- ``trace_annotation``: the port's one span API (below).
- ``nan_guard``: fail on the first NaN inside a scope: every forward
  result is checked as it is produced, and autograd's anomaly mode checks
  every backward result.

Spans.  ``with trace_annotation("opt.step", device=dev, step=i): ...``
marks one piece of work at a layer boundary.  The recorder is off by
default, and then a span costs one flag check: no profiler range, no NVTX
range, no CUDA event, nothing kept.  Inside ``with recording(): ...`` each
span keeps its name, its start and end on ``time.time_ns()`` (the epoch
clock of ``torch.profiler``'s kineto events, so spans and a profiler trace
line up), its parent's id, its thread and a few args; it also opens
a ``record_function`` range (and an NVTX range with CUDA), so it shows in
profiler traces.  ``spans()`` hands the kept spans over and forgets them.

A span given a CUDA ``device`` records a CUDA event at its end on that
device's current stream (events come from a pool and are reused; one
event, since a timed event costs the device a few microseconds: the time
between two spans' end events is the device's time for the second).  Their
times are read by :func:`read_device_times`, which the program calls right
after a synchronize it makes anyway (the chunk's read-back in
``pipeline/optimize_stage.py``): the recorder never waits for the device
itself.  Such a span also counts, at its start, how many earlier spans of
its name have an end event the device has not reached yet
(``event.query()``, which does not block): its ``lead`` arg, how far the
host runs ahead of the device in that span's units.

Spans nest on one stack shared by all threads: the autograd engine runs a
CUDA backward on a thread of its own while the calling thread waits, and
its spans belong under the caller's.

``timed=True`` gives a span a clock whether or not the recorder is on:
``with trace_annotation("run.optimize", timed=True) as s: ...; s.seconds``.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch

from vae_latent_geometry_tpu_torch.io.checkpoint import tree_leaves


def sync(tree: Any = None) -> None:
    """Synchronize every CUDA device holding a tensor of ``tree`` (all
    tensors of a tree of tensors, dicts, lists and dataclasses), or the
    current device when ``tree`` is None."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    devices = {leaf.device for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    """``with Timer("energy step") as t: ...; t.elapsed`` (seconds).  The
    clock is read after synchronizing the current CUDA device."""

    def __init__(self, label: str = "", verbose: bool = False):
        self.label = label
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync()
        self.elapsed = time.perf_counter() - self.t0
        if self.verbose:
            print(f"[timer] {self.label}: {self.elapsed * 1e3:.2f} ms")
        return False


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1, **kw):
    """Seconds per call of ``fn(*args, **kw)``, after ``warmup`` calls,
    the clock read after synchronizing the devices of the last output."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    sync(out)
    return (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

_ON = False     # the recorder's switch: the one check an off span makes
OUTSIDE = "outside any span"


class Span:
    """One span: ``name``, ``start_ns`` / ``end_ns`` on ``time.time_ns()``,
    ``id``, ``parent`` (the id of the span open around it, or None),
    ``tid`` (its thread), ``args`` (integers, or a short string such as a
    source's name) and, for a span with a CUDA
    device once :func:`read_device_times` read its end event, ``device``:
    (read, end_ms), the event's time in ms after the first event of that
    read (times of one read compare with each other only)."""

    __slots__ = ("id", "parent", "name", "start_ns", "end_ns", "args",
                 "tid", "device", "_dev", "_rf")

    def __init__(self, name: str, args: dict, dev=None):
        self.name, self.args, self._dev = name, args, dev
        self.start_ns = self.end_ns = 0
        self.device = self._rf = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        _REC.open(self)
        return self

    def __exit__(self, *exc):
        _REC.close(self)
        return False


class _Off:
    """What a span is while the recorder is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Clock:
    """A ``timed`` span while the recorder is off: its clock only."""

    __slots__ = ("start_ns", "end_ns")

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        return False

    seconds = Span.seconds


_OFF = _Off()


class _Recorder:
    """The kept spans, the open ones, and the CUDA events waiting to be
    read.  One per process (:data:`_REC`)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.done: List[Span] = []
        self.stack: List[Span] = []
        self.next_id = 1
        self.pending: List[Tuple[Span, Any]] = []   # (span, end event)
        self.pool: list = []
        self.unreached: Dict[str, deque] = {}   # name -> end events
        self.reads = 0
        self.nvtx = False       # set when recording starts

    def _event(self, dev):
        ev = self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def open(self, span: Span):
        with self.lock:
            span.id, self.next_id = self.next_id, self.next_id + 1
            span.parent = self.stack[-1].id if self.stack else None
            self.stack.append(span)
        span.tid = threading.get_ident()
        dev = span._dev
        if dev is not None and dev.type == "cuda":
            q = self.unreached.setdefault(span.name, deque())
            while q and q[0].query():
                q.popleft()
            span.args["lead"] = len(q)
        span.start_ns = time.time_ns()
        if self.nvtx:
            torch.cuda.nvtx.range_push(span.name)
        span._rf = torch.autograd.profiler.record_function(span.name)
        span._rf.__enter__()

    def close(self, span: Span):
        dev = span._dev
        if dev is not None and dev.type == "cuda":
            end = self._event(dev)
            self.unreached[span.name].append(end)
            self.pending.append((span, end))
        span._rf.__exit__(None, None, None)
        span._rf = None
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        span.end_ns = time.time_ns()
        with self.lock:
            self.stack.remove(span)
            self.done.append(span)

    def add(self, name: str, start_ns: int, end_ns: int, args: dict):
        span = Span(name, args)
        span.start_ns, span.end_ns = start_ns, end_ns
        span.tid = threading.get_ident()
        with self.lock:
            span.id, self.next_id = self.next_id, self.next_id + 1
            span.parent = self.stack[-1].id if self.stack else None
            self.done.append(span)

    def read_device_times(self) -> None:
        if not self.pending[-1][1].query():
            return
        self.reads += 1
        ref = self.pending[0][1]
        for span, ev in self.pending:
            span.device = (self.reads, ref.elapsed_time(ev))
            self.pool.append(ev)
        self.pending = []
        self.unreached.clear()


_REC = _Recorder()


def trace_annotation(name: str, device=None, timed: bool = False, **args):
    """A span named ``name`` (module docstring): a context manager.  While
    the recorder is off it does nothing (``timed``: it reads the clock),
    while it is on it keeps the span with its ``args``.
    ``device``: a ``torch.device``; a CUDA one gives the span an end event
    and a ``lead``."""
    if not _ON:
        return _Clock() if timed else _OFF
    return Span(name, args, device)


def record_interval(name: str, start_ns: int, end_ns: int, **args) -> None:
    """Keep a span whose times were read elsewhere (work that ran beside
    the caller, such as a compiler process), under the open span; nothing
    while the recorder is off."""
    if _ON:
        _REC.add(name, start_ns, end_ns, args)


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the scope (back to what it was after)."""
    global _ON
    was, _ON = _ON, True
    _REC.nvtx = torch.cuda.is_available()
    try:
        yield
    finally:
        _ON = was


def read_device_times() -> None:
    """Give the device spans their ``device`` times and reuse their end
    events.  Call it after a synchronize: it never waits, and leaves
    everything for a later call while the last event is not reached."""
    if _REC.pending:
        _REC.read_device_times()


def spans() -> List[Span]:
    """The kept spans in the order they ended, forgotten here.  Device
    spans not read yet get their times at the next
    :func:`read_device_times`."""
    with _REC.lock:
        out, _REC.done = _REC.done, []
    return out


def write_chrome_trace(path: str, kept: Iterable[Span]) -> None:
    """``kept`` as Chrome trace-event JSON (``ph: "X"``, ``ts``/``dur`` in
    microseconds on the epoch clock, as ``torch.profiler``'s export), for
    Perfetto or ``chrome://tracing`` beside a profiler trace."""
    pid = os.getpid()
    events = []
    for s in kept:
        args = dict(s.args, id=s.id, parent=s.parent)
        if s.device is not None:
            args["read"], args["device_end_ms"] = s.device
        events.append({"name": s.name, "cat": s.name.split(".")[0],
                       "ph": "X", "ts": s.start_ns / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
                       "tid": s.tid, "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


# ---------------------------------------------------------------------------
# readings of kept spans
# ---------------------------------------------------------------------------

def named(kept: Iterable[Span], name: str) -> List[Span]:
    """The spans called ``name``, in the order they started."""
    return sorted((s for s in kept if s.name == name),
                  key=lambda s: s.start_ns)


def _ends(steps: Iterable[Span]) -> Dict[int, List[float]]:
    """The end times (ms) of the spans that have them, by read."""
    ends: Dict[int, List[float]] = {}
    for s in steps:
        if s.device is not None:
            ends.setdefault(s.device[0], []).append(s.device[1])
    return ends


def step_ms(kept: Iterable[Span]) -> List[float]:
    """Device ms between the end events of consecutive ``opt.step`` spans
    of one read: the pace at which the device finishes steps."""
    return [b - a for e in _ends(named(kept, "opt.step")).values()
            for a, b in zip(e, e[1:])]


def host_leads(kept: Iterable[Span]) -> List[int]:
    """The ``lead`` of each ``opt.step`` span: 0 where the device had
    finished every earlier step when the host began it (the device waited
    on the host), n where it had n still to finish."""
    return [s.args["lead"] for s in named(kept, "opt.step")
            if "lead" in s.args]


def chunk_edges_ms(kept: Iterable[Span]) -> List[float]:
    """For each ``pipeline.chunk``: its wall ms less its steps' device ms
    (n steps at the pace between their first and last end events, the
    ``opt.step`` spans of the ``opt.phase`` spans inside it): what a chunk
    spends outside its steps (input staging, the final pass, the
    read-back).  Chunks with fewer than two read steps are left out."""
    kept = list(kept)
    chunk_of = {s.id: s.parent for s in kept if s.name == "opt.phase"}
    steps: Dict[int, List[Span]] = {}
    for s in named(kept, "opt.step"):
        if s.parent in chunk_of:
            steps.setdefault(chunk_of[s.parent], []).append(s)
    out = []
    for c in named(kept, "pipeline.chunk"):
        reads = list(_ends(steps.get(c.id, [])).values())
        if reads and all(len(e) > 1 for e in reads):
            out.append((c.end_ns - c.start_ns) * 1e-6 - sum(
                (e[-1] - e[0]) * len(e) / (len(e) - 1) for e in reads))
    return out


def within(kept: Iterable[Span], outer: Span) -> List[Span]:
    """The spans that lie inside ``outer``'s time on the clock."""
    return [s for s in kept if s is not outer
            and outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns]


def by_innermost(kept: Iterable[Span],
                 intervals: Iterable[Tuple[int, int]]) -> Dict[str, float]:
    """Seconds of the [start_ns, end_ns) ``intervals`` (on the same clock,
    such as the device's idle gaps in a profiler trace) by the innermost
    span (the one that started last) running at each interval's
    midpoint, :data:`OUTSIDE` for the rest; largest first."""
    order = sorted(kept, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in order]
    out: Dict[str, float] = {}
    for a, b in intervals:
        mid = (a + b) // 2
        name = OUTSIDE
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if order[i].end_ns > mid:
                name = order[i].name
                break
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for x in out:
            yield from _tensors(x)


class _NaNCheck(torch.overrides.TorchFunctionMode):
    """Raises on the first floating-point result holding a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in _tensors(out):
            if x.is_floating_point() and bool(torch.isnan(x).any()):
                raise FloatingPointError(
                    f"NaN produced by {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def nan_guard(enabled: bool = True):
    """Fail fast on the first NaN inside the scope: a ``FloatingPointError``
    from the operation that produced it (forward), or autograd's
    ``RuntimeError`` from the backward function that returned it (anomaly
    mode with ``check_nan``).  Each check reads the result back to the
    host, so the scope runs synchronously; use it to find a NaN, not in a
    timed run."""
    if not enabled:
        yield
        return
    with torch.autograd.set_detect_anomaly(True, check_nan=True), _NaNCheck():
        yield
