"""The port's timing, tracing, NaN-guard and logging helpers
(``vae_latent_geometry_tpu_torch.utils``)."""

import logging
import time

import pytest
import torch

import tests.torch_parity_inputs  # noqa: F401  (one torch thread)
from vae_latent_geometry_tpu_torch.utils import (
    Timer,
    get_logger,
    nan_guard,
    sync,
    time_fn,
    trace_annotation,
)
from vae_latent_geometry_tpu_torch.utils.profiling import recording, spans


def test_timer_measures_the_scope(capsys):
    with Timer("nap", verbose=True) as t:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed < 1.0
    assert "[timer] nap:" in capsys.readouterr().out


def test_time_fn_returns_seconds_per_call():
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.005)
        return x * 2

    s = time_fn(fn, torch.ones(3), iters=4, warmup=2)
    assert len(calls) == 6 and 0.005 <= s < 0.5
    sync()                  # no CUDA tensor: nothing to wait for
    sync([torch.ones(1), {"a": torch.zeros(2)}])


def test_nan_guard_raises_on_a_forward_nan():
    x = torch.zeros(3)
    with pytest.raises(FloatingPointError, match="div"):
        with nan_guard():
            _ = x / x
    with nan_guard(enabled=False):
        assert torch.isnan(x / x).all()
    with nan_guard():       # finite work passes through unchanged
        assert float((torch.ones(2) * 3).sum()) == 6.0


def test_nan_guard_raises_on_a_backward_nan():
    x = torch.zeros(2, requires_grad=True)
    y = (torch.sqrt(x) * 0).sum()       # finite forward, NaN gradient
    assert torch.isfinite(y)
    with pytest.raises(RuntimeError, match="nan"):
        with nan_guard():
            (torch.sqrt(x) * 0).sum().backward()


def test_trace_annotation_names_a_profiler_range():
    """With the span recorder on, a span is a named profiler range (off,
    it is nothing at all: tests/test_torch_tracing.py)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with recording(), trace_annotation("vlg.test_range"):
            torch.ones(4) @ torch.ones(4)
    assert any(e.key == "vlg.test_range" for e in prof.key_averages())
    assert [s.name for s in spans()] == ["vlg.test_range"]


def test_get_logger_is_configured_once():
    a = get_logger("vlg.test")
    b = get_logger("vlg.test")
    assert a is b and len(a.handlers) == 1
    assert a.level == logging.INFO and not a.propagate
