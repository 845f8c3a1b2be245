"""Timing and tracing helpers (``vae_latent_geometry_tpu.utils.profiling``).

- ``sync``: wait for the CUDA work behind every tensor of a tree (CUDA
  launches return before the work is done).
- ``Timer`` / ``time_fn``: host-clock timing with a synchronize before
  each clock read.
- ``trace_annotation``: a named range in ``torch.profiler`` traces
  (``record_function``), and an NVTX range when CUDA is present.
- ``nan_guard``: fail on the first NaN inside a scope: every forward
  result is checked as it is produced, and autograd's anomaly mode checks
  every backward result.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

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


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range: ``torch.profiler.record_function`` (shown in
    profiler traces on the host and the device) and, with CUDA, an NVTX
    range for system profilers."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
