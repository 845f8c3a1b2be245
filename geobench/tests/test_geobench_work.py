"""The yardstick's counts: each decode once whatever the rung, the drawn
decoders of the Monte-Carlo estimator."""

import pytest

from geobench import work

DEC = [2, 128, 128, 50]


def test_decoder_forward_flops():
    assert work.mlp_flops(DEC) == 2 * (2 * 128 + 128 * 128 + 128 * 50)


@pytest.mark.parametrize("rung", ["float32", "f32x3", "f32x2", "bfloat16"])
def test_each_decode_counted_once_whatever_the_rung(rung):
    flops, _ = work.energy_grad_work(DEC, 2000, 200, 10, 2)
    assert flops == pytest.approx(3.6864e11)
    # the bound changes only through the rung's peak
    bound = work.bound_seconds(flops, 0, work.RUNG_PEAK[rung])
    assert bound == pytest.approx(flops / work.RUNG_PEAK[rung])
    assert work.RUNG_PEAK["f32x2"] == work.RUNG_PEAK["bfloat16"] == 989e12


def test_k2_bound_at_the_production_chunk():
    flops, n_bytes = work.energy_grad_work(DEC, 2000, 200, 10, 2)
    assert work.bound_seconds(flops, n_bytes, 989e12) == pytest.approx(
        3.727e-4, rel=1e-3)
    assert n_bytes / work.PEAK_BYTES < 1e-5          # bound by operations


def test_drawn_decoders_at_two_samples():
    assert work.drawn_decoders(10, 2) == pytest.approx(3.439)
    assert work.decoders_per_point("mc_fused", 10, 2) == pytest.approx(3.439)
    assert work.decoders_per_point("expected_fused", 10, 2) == 10
    assert work.decoders_per_point("single_fused", 10, 2) == 1
    flops, _ = work.energy_grad_work(DEC, 2000, 200, 3.439, 2)
    assert flops == pytest.approx(1.268e11, rel=1e-3)
