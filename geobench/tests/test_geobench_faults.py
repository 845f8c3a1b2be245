"""A run with the timed path broken underneath reads ``correct`` false: the
harness's look for a chip is skipped, the rest of a run is driven on the
CPU at a size a test can hold, with each fault of ``faults.py`` planted in
the port.  (Every cell takes one chip: there is no exchange between chips
to leave out.)"""

import time

import pytest
import torch

from geobench import faults, run

SMALL = {"classes": 4, "warmup_steps": 1, "check": {"sample_pairs": 3},
         "geodesic": {"steps": 40, "lr": 0.05, "batch_size": 4,
                      "energy": {"num_t": 64}}}
CELLS = ("evae10.expected", "evae10.mc")


def _run(cell, seed=2**31 + 21):
    return run.run_cell(cell, seed, 0.01, False, torch.device("cpu"),
                        overrides=SMALL, t_start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["result"]["correct"] is True, out["numbers"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_incorrect(cell, fault):
    with faults.planted(fault):
        out = _run(cell)
    assert out["result"]["correct"] is False, (fault, out["numbers"])
