"""Faults planted in the program under test, to show that the comparison
catches them (``tests/test_geobench_faults.py`` on the CPU, ``calibrate.py
--fault`` on the card).  Each patches the port where the fault would sit
and restores it on exit.

- ``frozen``: the optimizer step returns its state unchanged.
- ``half_batch``: half of the batch is left out (the second half of a
  chunk's splines contributes no energy).
- ``altered``: one answer altered where it is produced (the first pair of
  every chunk reports a length 1% long).

The exchange between chips has no fault to plant: every cell takes one
chip.
"""

from __future__ import annotations

import contextlib

FAULTS = ("frozen", "half_batch", "altered")


@contextlib.contextmanager
def planted(fault: str):
    import torch

    from vae_latent_geometry_tpu_torch.optim import geodesic
    from vae_latent_geometry_tpu_torch.pipeline import optimize_stage

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "frozen":
        def frozen(self, params, grad, state):
            state["count"] += 1
        patch(geodesic.Adam, "step", frozen)
    elif fault == "half_batch":
        energy_fn = geodesic._energy_fn

        def half(mode, decoders, gamma, *args, **kw):
            e = energy_fn(mode, decoders, gamma, *args, **kw)
            keep = torch.ones_like(e)
            keep[e.shape[0] // 2:] = 0
            return e * keep
        patch(geodesic, "_energy_fn", half)
    else:
        batch = optimize_stage.optimize_spline_batch

        def altered(*args, **kw):
            out = batch(*args, **kw)
            out.geodesic_length[0] *= 1.01
            return out
        patch(optimize_stage, "optimize_spline_batch", altered)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
