"""K8 decodes once: the Monte-Carlo energy's gradient (K6 on index planes,
K8 on in-kernel draws) at the reduced rungs runs the one-pass body it
shares with K2 and K10 (``ops/csrc/onepass_mma.cuh``) up to a cap on the
samples, the two-pass pair above it.

CPU: the route choice and its counter (``energy_mc_fused.k8_route``,
``K8_ROUTES``), the cap against the kernel's shared memory, the launch
branches in the sources, and a plain model of the tiles, the slots of the
difference planes and the buffers they are read from at ragged shapes.
Card (marker ``gpu``; ``python -m pytest --noconftest
tests/test_torch_k8_onepass.py -m gpu``): K6 and K8 against their plain
versions at every reduced rung and S up to the cap, bitwise repeats, K8 =
K6 on the planes of ``philox_draws``, the one-decode route bit for bit
equal to the two-pass kernels, and the cap the library reports.  No JAX
here.
"""

import os
import re

import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vae_latent_geometry_tpu_torch", "ops", "csrc")
NS, KR = ef.SPAN_SPLINES, ef.SPAN_ROWS - 1
TP = NS * ef.SPAN_ROWS


def _code(name):
    """A source without its // comments."""
    return re.sub(r"//[^\n]*", "", open(os.path.join(CSRC, name)).read())


def _body(source, head):
    """The braced block that follows the first ``head`` in ``source``."""
    start = source.index(head)
    depth, i = 0, source.index("{", start)
    for j in range(i, len(source)):
        depth += {"{": 1, "}": -1}.get(source[j], 0)
        if depth == 0:
            return source[i:j + 1]
    raise AssertionError(f"{head}: unbalanced braces")


# ------------------------------------------------------------------ CPU ---

@pytest.mark.parametrize("precision,widths,S,route", [
    ("f32x2", (2, 128, 128, 50), 1, "one_decode"),
    ("f32x2", (2, 128, 128, 50), 2, "one_decode"),
    ("f32x2", (2, 128, 128, 50), 3, "one_decode"),
    ("f32x2", (2, 128, 128, 50), 4, "two_pass"),
    ("f32x3", (4, 128, 128, 64), 3, "one_decode"),
    ("f32x3", (4, 128, 128, 64), 12, "two_pass"),
    ("bfloat16", (1, 128, 128, 7), 22, "one_decode"),
    ("bfloat16", (1, 128, 128, 7), 23, "two_pass"),
    ("float32", (2, 128, 128, 50), 2, "fma"),
    ("float32", (2, 128, 128, 50), 12, "fma"),
    ("f32x2", (5, 128, 128, 50), 2, "any"),        # D past the fixed kernels'
    ("f32x2", (2, 128, 128, 65), 2, "any"),        # X past them
    ("bfloat16", (2, 256, 128, 50), 1, "any"),     # another hidden width
    ("f32x3", (2, 128, 50), 2, "any"),             # two layers
])
def test_k8_route_follows_rung_samples_and_widths(precision, widths, S,
                                                  route):
    assert mc.k8_route(precision, widths, S) == route


def test_k8_route_refuses_an_unknown_rung():
    with pytest.raises(ValueError, match="unknown kernel precision"):
        mc.k8_route("float16", (2, 128, 128, 50), 2)


def _constants(*names):
    """The ``constexpr int`` values of the decode headers."""
    code = "".join(_code(f) for f in ("decode_common.cuh", "decode_f32.cuh",
                                      "decode_mma.cuh"))
    out = {}
    for n in names:
        m = re.search(rf"constexpr int {n} = ([^;]+);", code)
        out[n] = eval(m.group(1), {}, dict(out))
    return out


def test_onepass_cap_fills_the_shared_memory():
    """The cap is the most samples whose draws and difference planes fit
    beside McOnePassSmem (MmaSmem, the masks, the per-point scale, the
    round) in a block's shared memory: 3 at the production X = 50 and at X
    = 64, more at narrower outputs; the fields are the source's."""
    c = _constants("H", "XMAX", "DMAX", "TP", "NT", "SMEM_MAX")
    H, XMAX, DMAX, TP_, NT = (c[k] for k in ("H", "XMAX", "DMAX", "TP", "NT"))
    sw2, sw3 = H + 8, XMAX + 8
    mma = 2 * 2 * H * sw2 + 2 * 2 * H * sw3 + 4 * (DMAX * H + 2 * TP_ * DMAX
                                                   + 2 * H + XMAX)
    fixed = mma + 16 * NT + 4 * TP_ + 4 * 5
    fixed = -(-fixed // 16) * 16
    assert fixed == mc._ONEPASS_FIXED and c["SMEM_MAX"] == mc._SMEM_MAX
    code = _code("energy_mc.cu")
    assert re.search(r"struct McOnePassSmem : MmaSmem \{\s*uint4 mpre\[NT\];"
                     r"\s*float cct\[TP\];\s*OnePassRound rd;\s*\};", code)
    for X in range(1, XMAX + 1):
        sd = 16 * ((X + 7) // 16) + 8
        assert sd >= 8 * -(-X // 8) and sd % 32 in (8, 24)
        per = 4 * TP_ * (2 + sd)
        cap = mc.mc_onepass_cap(X)
        assert fixed + cap * per <= mc._SMEM_MAX < fixed + (cap + 1) * per
    assert mc.mc_onepass_cap(50) == mc.mc_onepass_cap(64) == 3


def test_k8_route_counter_stays_out_of_the_launch_count():
    """Callers sum LAUNCHES' values as the op's launches: the route counter
    is a dict of its own, reset with it and with K1's and K2's, and the
    plain CPU version counts in neither."""
    assert set(mc.K8_ROUTES) == {"one_decode", "two_pass", "fma", "any"}
    assert not set(mc.K8_ROUTES) & set(ef.LAUNCHES)
    mc.K8_ROUTES["one_decode"] += 3
    mc.K8_ROUTES["two_pass"] += 1
    ef.K2_ROUTES["one_decode"] += 1
    ef.reset_launch_counts()
    assert not any(mc.K8_ROUTES.values()) and not any(ef.K2_ROUTES.values())
    rng = np.random.default_rng(0)
    ws = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
          for s in ((2, 2, 128), (2, 128, 128), (2, 128, 7))]
    bs = [torch.zeros(2, n) for n in (128, 128, 7)]
    g = torch.as_tensor(rng.normal(size=(5, 3, 2)).astype(np.float32))
    mc.energy_mc_bwd_rng(ws, bs, g, 7, torch.full((3,), 2.0), 2,
                         torch.ones(3), "f32x2")
    assert not any(mc.K8_ROUTES.values()) and not any(ef.LAUNCHES.values())


def test_reduced_rungs_launch_the_one_pass_body():
    """K6/K8's one-decode route launches mc_select_planes (prep_planes) and
    mc_chain_onepass (onepass_body over McCot); every kernel of K8 keeps
    mc_select or mc_chain in its name (the names K8's device time reads
    by), and K2's kernel runs the body over ExpectedCot."""
    code = _code("energy_mc.cu")
    launch = _body(code, "cudaError_t launch_bwd_onepass(")
    assert "launch_prep(mc_select_planes," in launch
    assert "mc_chain_onepass<R><<<" in launch
    assert "S > mc_onepass_cap(X)" in launch
    assert "prep_planes(W2, W3, M, X, planes);" in _body(
        code, " mc_select_planes(")
    kernel = _body(code, "\nmc_chain_onepass(")
    assert "const McCot cot{" in kernel and "onepass_body<R>(" in kernel
    entry = _body(code, "int vlg_mc_bwd(")
    assert "launch_bwd_onepass<R>(" in entry and "launch_bwd_mma<R>(" in entry
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", code)
    for name in names:
        assert "mc_select" in name or "mc_chain" in name or name.startswith(
            ("mc_segments", "mc_fwd", "mc_tiles", "mc_sum")), name
    assert "ExpectedCot{wmb}" in _body(_code("energy_expected.cu"),
                                       "\nk2_onepass_mma(")


def _items(T, B, span, G):
    """(b0, t_s, t_e, n_tiles, t_a) of each item the blocks take."""
    groups = -(-B // NS)
    for item in range(G * groups):
        b0, g = (item % groups) * NS, item // groups
        t_s, t_e = g * span, min(T, g * span + span)
        t_a = max(t_s - 1, 0)
        yield b0, t_s, t_e, (-(-(t_e - t_a) // KR) if t_s < T else 0), t_a


@pytest.mark.parametrize("T", [2, 31, 32, 33, 2000])
@pytest.mark.parametrize("B,n_sm", [(1, 132), (3, 132), (5, 2), (13, 132),
                                    (200, 132)])
def test_tiles_own_every_point_and_segment_once(T, B, n_sm):
    """A model of begin_chain's slots and the chain's reads: every (t, b)
    is owned once; an owned point reads the segment before it at slot row
    r and the one after at row r + 1, each staged (a draw, not -1) exactly
    where the segment exists; a staged slot's left end is the point before
    its right end, in tile k-1 or, at row -1, in tile k-2 of the same
    span (the other scratch buffer, not yet overwritten); and every
    segment is owned once, by its left end's tile."""
    span, G = ef.pick_spans(T, B, n_sm, 1, KR)
    points, segments = {}, {}
    for b0, t_s, t_e, n_tiles, t_a in _items(T, B, span, G):
        for kk in range(n_tiles):          # tile kk = k - 1 of round k
            t1 = t_a + kk * KR

            def staged(i):
                t, b = t1 - 1 + i // NS, b0 + i % NS
                ok = 0 <= t < T - 1 and b < B and (i >= NS or kk > 0)
                return (t, b) if ok else None

            for pp in range(TP):
                row, t, b = pp // NS, t1 + pp // NS, b0 + pp % NS
                if not (row < KR and t_s <= t < t_e and t < T and b < B):
                    continue
                assert (t, b) not in points, (t, b)
                points[(t, b)] = kk
                before = staged(pp)
                assert before == ((t - 1, b) if t > 0 else None)
                if before and pp < NS:     # row -1: tile kk-1's row 30
                    assert kk > 0
                after = staged(pp + NS)
                assert after == ((t, b) if t < T - 1 else None)
                if after:
                    assert (t, b) not in segments
                    segments[(t, b)] = kk
    assert set(points) == {(t, b) for t in range(T) for b in range(B)}
    assert set(segments) == {(t, b) for t in range(T - 1) for b in range(B)}


# ------------------------------------------------------------------ GPU ---

def _decoders(M, D, X, seed):
    rng = np.random.default_rng(seed)
    dims = (D, 128, 128, X)
    ws = [torch.as_tensor((rng.normal(size=(M, i, o)) / np.sqrt(i)).astype(
        np.float32), device="cuda") for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.as_tensor((0.1 * rng.normal(size=(M, o))).astype(np.float32),
                          device="cuda") for o in dims[1:]]
    return ws, bs


# (T, B, M, D, X): the ragged shapes the tile (32 rows, 31 owned, 4
# splines) and the spans meet, every D the fixed kernels take
SHAPES = [(2, 1, 1, 1, 7), (31, 3, 10, 2, 50), (33, 200, 3, 4, 50),
          (67, 13, 10, 2, 50), (32, 5, 1, 2, 64), (2000, 5, 10, 4, 64),
          (2000, 200, 10, 2, 50)]


def _samples(X):
    return sorted({1, 2, 3, mc.mc_onepass_cap(X)})


def _two_pass(monkeypatch, fn):
    """fn() on the two-pass kernels: the cap set to 0 for the call."""
    with monkeypatch.context() as m:
        m.setattr(mc, "mc_onepass_cap", lambda X: 0)
        return fn()


def _assert_close(d, d_p):
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert bool(torch.isfinite(d).all())
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,M,D,X", SHAPES)
@pytest.mark.parametrize("precision", ["f32x3", "f32x2", "bfloat16"])
def test_k8_one_decode_on_gpu(precision, T, B, M, D, X, monkeypatch):
    """K6 and K8 on the one-decode route at S = 1, 2, 3 and the cap against
    their plain versions under the isolation test's limits (median and p99
    of |error| / max |dgamma|), every launch counted on the route, a second
    call bit for bit equal to the first, K8 = K6 on the planes of
    ``philox_draws``, and both bit for bit equal to the two-pass kernels
    (mc_select_mma + mc_chain_mma) on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    ws, bs = _decoders(M, D, X, 11 + T + B + M + D + X)
    rng = np.random.default_rng(T * B + M)
    g = torch.as_tensor(rng.normal(size=(T, B, D)).astype(np.float32) * 2,
                        device="cuda")
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    kmax = torch.as_tensor(rng.integers(1, M + 1, B), device="cuda").float()
    for S in _samples(X):
        seed = (1 << 40) + 17 * S + T
        d1, d2 = mc.sample_decoder_indices(
            torch.Generator(device="cuda").manual_seed(S), T, B, M, S,
            kmax.long())
        ef.reset_launch_counts()
        k6 = mc.energy_mc_bwd(ws, bs, g, d1, d2, ct, precision)
        k8 = mc.energy_mc_bwd_rng(ws, bs, g, seed, kmax, S, ct, precision)
        torch.cuda.synchronize()
        assert mc.K8_ROUTES == {"one_decode": 2, "two_pass": 0, "fma": 0,
                                "any": 0}, S
        assert ef.LAUNCHES["energy_mc_bwd"] == ef.LAUNCHES[
            "energy_mc_bwd_rng"] == 1
        _assert_close(k6, mc.energy_mc_bwd_plain(ws, bs, g, d1, d2, ct,
                                                 precision))
        p1, p2 = (d.contiguous() for d in mc.philox_draws(seed, S, T, B,
                                                          kmax))
        _assert_close(k8, mc.energy_mc_bwd_plain(ws, bs, g, p1, p2, ct,
                                                 precision))
        assert torch.equal(k6, mc.energy_mc_bwd(ws, bs, g, d1, d2, ct,
                                                precision))
        assert torch.equal(k8, mc.energy_mc_bwd_rng(ws, bs, g, seed, kmax,
                                                    S, ct, precision))
        assert torch.equal(k8, mc.energy_mc_bwd(ws, bs, g, p1, p2, ct,
                                                precision))
        ef.reset_launch_counts()
        two6 = _two_pass(monkeypatch, lambda: mc.energy_mc_bwd(
            ws, bs, g, d1, d2, ct, precision))
        two8 = _two_pass(monkeypatch, lambda: mc.energy_mc_bwd_rng(
            ws, bs, g, seed, kmax, S, ct, precision))
        assert mc.K8_ROUTES["two_pass"] == 2
        for one, two in ((k6, two6), (k8, two8)):
            assert torch.equal(one, two), (
                S, float((one - two).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32x3", "f32x2", "bfloat16"])
def test_k8_above_the_cap_takes_two_passes_on_gpu(precision):
    """One sample past the cap (and S = 12) the wrapper launches the
    two-pass kernels, against the plain version; the library's cap is the
    wrapper's at every output width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.ops._build import library

    lib = library("energy_mc")
    assert [lib.vlg_mc_onepass_cap(X) for X in range(1, 65)] == [
        mc.mc_onepass_cap(X) for X in range(1, 65)]
    T, B, M, D, X = 67, 13, 10, 2, 50
    ws, bs = _decoders(M, D, X, 5)
    rng = np.random.default_rng(1)
    g = torch.as_tensor(rng.normal(size=(T, B, D)).astype(np.float32) * 2,
                        device="cuda")
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    kmax = torch.full((B,), float(M), device="cuda")
    for S in (mc.mc_onepass_cap(X) + 1, 12):
        ef.reset_launch_counts()
        k8 = mc.energy_mc_bwd_rng(ws, bs, g, (1 << 40) + S, kmax, S, ct,
                                  precision)
        assert mc.K8_ROUTES == {"one_decode": 0, "two_pass": 1, "fma": 0,
                                "any": 0}
        _assert_close(k8, mc.energy_mc_bwd_rng_plain(
            ws, bs, g, (1 << 40) + S, kmax, S, ct, precision))
