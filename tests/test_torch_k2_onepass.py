"""K2 decodes once: the expected energy's gradient at the reduced rungs runs
the one-pass body it shares with K6/K8 (``ops/csrc/onepass_mma.cuh``).

CPU: the route choice and its counter (``energy_fused.k2_route``,
``K2_ROUTES``), the launch branches in the sources, the transposed op's
entry points on K1 and K2, and a plain model of the tiles and spans the
kernel walks at the ragged shapes.  Card (marker
``gpu``; ``python -m pytest --noconftest tests/test_torch_k2_onepass.py -m
gpu``): the kernel against its plain version at those shapes and weight
planes, bitwise repeats, and K10 bit for bit equal to it on the uniform
plane where their arithmetic is the same.  No JAX here.
"""

import os
import re

import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vae_latent_geometry_tpu_torch", "ops", "csrc")
KR = ef.SPAN_ROWS - 1          # rows a tile owns


def _code(name):
    """A source without its // comments."""
    return re.sub(r"//[^\n]*", "", open(os.path.join(CSRC, name)).read())


# ------------------------------------------------------------------ CPU ---

@pytest.mark.parametrize("precision,widths,route", [
    ("f32x2", (2, 128, 128, 50), "one_decode"),
    ("f32x3", (4, 128, 128, 64), "one_decode"),
    ("bfloat16", (1, 128, 128, 7), "one_decode"),
    ("float32", (2, 128, 128, 50), "fma"),
    ("f32x2", (5, 128, 128, 50), "any"),        # D past the fixed kernels'
    ("f32x2", (2, 128, 128, 65), "any"),        # X past them
    ("bfloat16", (2, 256, 128, 50), "any"),     # another hidden width
    ("f32x3", (2, 128, 50), "any"),             # two layers
    ("float32", (2, 128, 128, 128, 50), "any"),  # four layers
])
def test_k2_route_follows_rung_and_widths(precision, widths, route):
    assert ef.k2_route(precision, widths) == route


def test_k2_route_refuses_an_unknown_rung():
    with pytest.raises(ValueError, match="unknown kernel precision"):
        ef.k2_route("float16", (2, 128, 128, 50))


def test_route_counter_stays_out_of_the_launch_count():
    """Callers sum LAUNCHES' values as the op's launches: the route counter
    is a dict of its own, reset with it, and the plain CPU version counts in
    neither."""
    assert set(ef.K2_ROUTES) == {"one_decode", "fma", "any", "softmax"}
    assert not set(ef.K2_ROUTES) & set(ef.LAUNCHES)
    ef.K2_ROUTES["one_decode"] += 3
    ef.reset_launch_counts()
    assert not any(ef.K2_ROUTES.values()) and not any(ef.LAUNCHES.values())
    rng = np.random.default_rng(0)
    ws = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
          for s in ((2, 2, 128), (2, 128, 128), (2, 128, 7))]
    bs = [torch.zeros(2, n) for n in (128, 128, 7)]
    g = torch.as_tensor(rng.normal(size=(5, 3, 2)).astype(np.float32))
    ef.energy_bwd(ws, bs, g, ef.uniform_weights(2, 3), torch.ones(3), "f32x2")
    assert not any(ef.K2_ROUTES.values()) and not any(ef.LAUNCHES.values())


def _body(source, head):
    """The braced block that follows the first ``head`` in ``source``."""
    start = source.index(head)
    depth, i = 0, source.index("{", start)
    for j in range(i, len(source)):
        depth += {"{": 1, "}": -1}.get(source[j], 0)
        if depth == 0:
            return source[i:j + 1]
    raise AssertionError(f"{head}: unbalanced braces")


@pytest.mark.parametrize("src,prep,kernel", [
    ("energy_expected.cu", "k2_prep_planes", "k2_onepass_mma")])
def test_reduced_rungs_launch_the_one_pass_body(src, prep, kernel):
    """K2's reduced rungs launch their own names over the one body and
    plane preparation of onepass_mma.cuh (K2's device time reads by the
    prefix k2_); K2's two-pass tensor-core kernels are gone."""
    code = _code(src)
    launch = _body(code, "cudaError_t launch_bwd(")
    assert f"launch_onepass<R>({prep}, {kernel}<R>," in launch
    assert "prep_planes(W2, W3, M, X, planes);" in _body(code, f" {prep}(")
    assert "onepass_body<R>(" in _body(code, f"\n{kernel}(")
    for name in os.listdir(CSRC):
        other = _code(name)
        for gone in ("k2_xbar_mma", "k2_chain_mma", "TMmaSmem", "SmemMma"):
            assert gone not in other, (name, gone)
    # the float32 K2 keeps its two FMA passes, launched by that branch only
    assert code.count("k2_xbar<R><<<") == 1


@pytest.mark.parametrize("entry,call", [
    ("energy_t_fwd", "energy_fwd(ws, bs, gamma, uniform_weights(M, B, "
                     "gamma.device),"),
    ("energy_t_bwd", "energy_bwd(ws, bs, gamma, uniform_weights(M, B, "
                     "gamma.device), ct,")])
def test_transposed_op_runs_k1_and_k2(entry, call):
    """The transposed op's K9 and K10 are K1 and K2 on the uniform weight
    plane: each entry point checks the op's shape rule and calls
    energy_fused's wrapper, K10 with float32 W1 for the dgamma product; no
    CUDA source defines a kernel of its own any more."""
    path = os.path.join(os.path.dirname(CSRC), "_research",
                        "energy_fused_t.py")
    src = open(path).read()
    body = src[src.index(f"def {entry}("):]
    body = body[:body.index("\n\n\n")]
    flat = " ".join(body.split())
    assert "_check_fits(ws, gamma)" in flat
    assert call in flat, flat
    if entry == "energy_t_bwd":
        assert "w1=ws[0].float().contiguous())" in flat
    assert "library(" not in src and "LAUNCHES" not in src
    for name in os.listdir(CSRC):
        assert not re.search(r"\bk(?:9|10)_\w", _code(name)), name


def _owned(T, B, span, G):
    """Each (t, b) the one-pass kernel writes, with the tile that owns it
    and that tile's first row, walking the items and tiles as the body does
    (K1's tiles: 32 rows from t0, 31 owned; one extra row before a span)."""
    groups = -(-B // ef.SPAN_SPLINES)
    out = {}
    for item in range(G * groups):
        b0, g = (item % groups) * ef.SPAN_SPLINES, item // groups
        t_s, t_e = g * span, min(T, g * span + span)
        t_a = max(t_s - 1, 0)
        n_tiles = -(-(t_e - t_a) // KR) if t_s < T else 0
        for k in range(n_tiles):
            t0 = t_a + k * KR
            for p in range(ef.SPAN_ROWS * ef.SPAN_SPLINES):
                row, t, b = p // 4, t0 + p // 4, b0 + p % 4
                if row < KR and t_s <= t < t_e and t < T and b < B:
                    assert (t, b) not in out, (t, b)
                    out[(t, b)] = (k, t0, t_a)
    return out


@pytest.mark.parametrize("T", [1, 2, 31, 32, 33, 62, 2000])
@pytest.mark.parametrize("B,n_sm", [(1, 132), (3, 132), (5, 2), (200, 132),
                                    (500, 132)])
def test_tiles_own_every_point_once(T, B, n_sm):
    """The spans of pick_spans and the tiles of 31 owned rows write every
    (t, b) exactly once; a tile's left neighbour of its first owned row is
    the previous tile's row 30 (the carry) or the span's extra row, and its
    right neighbour of row 30 is its own row 31."""
    span, G = ef.pick_spans(T, B, n_sm, 1, KR)
    out = _owned(T, B, span, G)
    assert set(out) == {(t, b) for t in range(T) for b in range(B)}
    for (t, b), (k, t0, t_a) in out.items():
        assert t0 <= t < t0 + KR       # t + 1 among the tile's 32 rows
        if t == t0 and t > 0:          # t - 1: tile k-1's row 30, carried
            assert k > 0
        elif t > 0:                    # t - 1: the tile's own (or halo) row
            assert t0 <= t - 1 and (k > 0 or t0 == t_a)


# ------------------------------------------------------------------ GPU ---

def _decoders(M, D, X, seed):
    rng = np.random.default_rng(seed)
    dims = (D, 128, 128, X)
    ws = [torch.as_tensor((rng.normal(size=(M, i, o)) / np.sqrt(i)).astype(
        np.float32), device="cuda") for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.as_tensor((0.1 * rng.normal(size=(M, o))).astype(np.float32),
                          device="cuda") for o in dims[1:]]
    return ws, bs


def _plane(kind, M, B, rng):
    if kind == "uniform":
        return ef.uniform_weights(M, B, "cuda")
    if kind == "active":
        return ef.active_weights(torch.as_tensor(rng.integers(1, M + 1, B)),
                                 M, B, "cuda")
    w = rng.exponential(size=(M, B)).astype(np.float32)   # a random simplex
    return torch.as_tensor(w / w.sum(0, keepdims=True), device="cuda")


# (T, B, M, D, X): the ragged shapes the tile (32 rows, 31 owned, 4
# splines) and the spans meet, every D the fixed kernels take
SHAPES = [(2, 1, 1, 1, 7), (31, 3, 10, 2, 50), (32, 5, 10, 3, 64),
          (33, 200, 1, 4, 50), (2000, 5, 10, 4, 7), (2000, 200, 10, 2, 50),
          (2000, 500, 1, 2, 64), (33, 500, 10, 1, 64), (31, 1, 10, 4, 50),
          (32, 3, 1, 2, 7), (2000, 200, 10, 1, 64), (32, 200, 10, 2, 50)]


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["active", "simplex", "uniform"])
@pytest.mark.parametrize("T,B,M,D,X", SHAPES)
@pytest.mark.parametrize("precision", ["f32x3", "f32x2", "bfloat16"])
def test_k2_one_decode_on_gpu(precision, T, B, M, D, X, weights):
    """K2's one-pass kernel against its plain version under K2's limits
    (median and p99 of |error| / max |dgamma|), every call once more bit
    for bit, every launch counted as the one-decode route; on the uniform
    plane at f32x3 and f32x2 within K10's shapes (D <= 2, T in 8-aligned
    chunks) K10 gives the same dgamma bit for bit, the same body and
    arithmetic (at bfloat16 they differ by design: K10's dgamma product
    takes float32 W1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    ws, bs = _decoders(M, D, X, 11 + T + B + M + D + X)
    rng = np.random.default_rng(T * B + M)
    g = torch.as_tensor(rng.normal(size=(T, B, D)).astype(np.float32) * 2,
                        device="cuda")
    wmb = _plane(weights, M, B, rng)
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    ef.reset_launch_counts()
    d = ef.energy_bwd(ws, bs, g, wmb, ct, precision)
    torch.cuda.synchronize()
    assert ef.K2_ROUTES == {"one_decode": 1, "fma": 0, "any": 0,
                            "softmax": 0}
    assert ef.LAUNCHES["energy_bwd"] == 1
    d_p = ef.energy_bwd_plain(ws, bs, g, wmb, ct, precision)
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3
    assert torch.equal(d, ef.energy_bwd(ws, bs, g, wmb, ct, precision))
    if weights == "uniform" and precision != "bfloat16" and D <= 2 \
            and T % 8 == 0:
        from vae_latent_geometry_tpu_torch.ops._research import (
            energy_fused_t as eft)

        assert torch.equal(d, eft.energy_t_bwd(ws, bs, g, ct, precision))
