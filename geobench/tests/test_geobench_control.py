"""The control reads ``correct`` false against each cell's limits: the
program with its own bfloat16 rung switched on for the trajectory, and
its lengths replaced by the reference's at TF32 (one precision below the
float32 final pass); on the CPU at the cells' quadrature and widths with a
few pairs and steps (``calibrate.py --control-seeds`` runs it on the card
at the cells' own sizes)."""

import time

import pytest
import torch

from geobench import run

SMALL = {"classes": 3, "warmup_steps": 1, "check": {"sample_pairs": 2},
         "geodesic": {"steps": 8, "batch_size": 3}}
CELLS = ("evae10.expected", "evae10.mc")


def _assert_control_fails(out):
    checks = out["result"]["checks"]
    assert out["result"]["correct"] is False, out["numbers"]
    # each stage's lower precision shows in its own number
    for k in ("grad_gap", "final_gap"):
        assert checks[k]["value"] > checks[k]["limit"], (k, checks)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_incorrect(cell):
    out = run.run_cell(cell, 2**31 + 33, 0.01, False, torch.device("cpu"),
                       producer="control", overrides=SMALL,
                       t_start=time.perf_counter())
    _assert_control_fails(out)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cuda, cell):
    out = run.run_cell(cell, 2**31 + 35, 0.01, False, cuda,
                       producer="control", t_start=time.perf_counter())
    _assert_control_fails(out)
