"""K2 of the softmax route at the reduced rungs on warpgroup MMA
(``ops/csrc/energy_softmax.cu``: ``k2s_rows_wg``, ``k2s_chain_wg``), and
the kernels that stay on their earlier bodies: K1 (``k1s_rows``) at every
rung and K2 at float32 (``k2s_rows<0>``, ``k2s_chain<0>``).

On the CPU: which body each rung's launch names in its span, and the
source's dispatch.  Marked ``gpu`` (skipped without a card): K2 against
its plain version at f32x3, f32x2 and bfloat16 on scvi10's shape, at B=16
and on a ragged shape (N a multiple of neither 64 nor 128, G not of 64,
H < 128, D < 10), a repeat bit for bit, and the outputs of the kernels that
keep their bodies against hashes of the earlier kernels' outputs, read on
an H100 80GB HBM3 (``python -m pytest --noconftest
tests/test_torch_softmax_wgmma.py -m gpu``).
"""

import hashlib
import os
import re
import sys

import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
from vae_latent_geometry_tpu_torch.ops import energy_softmax as es
from vae_latent_geometry_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "vae_latent_geometry_tpu_torch", "ops", "csrc",
                      "energy_softmax.cu")
REDUCED = ("f32x3", "f32x2", "bfloat16")
# (T, B, M, D, H, G): scvi10's cell, twice its batch, and a ragged shape
SHAPES = {"cell": (2000, 8, 10, 10, 128, 2000),
          "b16": (2000, 16, 10, 10, 128, 2000),
          "ragged": (37, 3, 3, 7, 96, 1000)}
# sha256 (first 16 hex digits) of the outputs of k1s_rows (K1's energies,
# every rung) and of k2s_rows<0> + k2s_chain<0> (K2's dgamma at float32)
# before K2's reduced rungs moved to warpgroup MMA, on chip_smoke's
# softmax_inputs(..., seed=7); H100 80GB HBM3, CUDA 12.8, torch 2.11.
EARLIER = {
    ("k1", "small", "float32"): "04f22dfed894dc35",
    ("k1", "small", "f32x3"): "c52253674a720253",
    ("k1", "small", "f32x2"): "f7ee3b5a5ed8e010",
    ("k1", "small", "bfloat16"): "a7d3fd1e7152049a",
    ("k2", "small", "float32"): "123105c4bc0b64f9",
    ("k1", "ragged", "float32"): "8897df6774d0c22f",
    ("k1", "ragged", "f32x3"): "1d1ceae3a7f722cd",
    ("k1", "ragged", "f32x2"): "d497e3cb4a4be9a2",
    ("k1", "ragged", "bfloat16"): "34aeab7c65bd11a0",
    ("k2", "ragged", "float32"): "f712aad398d0caad",
    ("k1", "cell", "float32"): "317e5b42b60966e7",
    ("k1", "cell", "f32x3"): "1da62bc71b9a04e8",
    ("k1", "cell", "f32x2"): "2db7f46716b819c5",
    ("k1", "cell", "bfloat16"): "0628b8ec8754d0ef",
    ("k2", "cell", "float32"): "24b5feab2a873ea8",
}
EARLIER_SHAPES = {"small": (33, 5, 3, 10, 16, 300),
                  "ragged": (65, 3, 10, 10, 128, 2000),
                  "cell": (2000, 8, 10, 10, 128, 2000)}


def _inputs(shape, dev, seed=7):
    sys.path.insert(0, REPO)
    from chip_smoke import softmax_inputs

    return softmax_inputs(*shape, seed=seed, dev=dev)


# ------------------------------------------------------------------ CPU

class _Lib:
    """Stands in for the built library: records each entry point's rung."""

    def __init__(self):
        self.calls = []

    def vlg_softmax_rows(self, rung, stats, *args):
        self.calls.append(("rows", rung, stats))
        return 0

    def vlg_softmax_chain(self, rung, *args):
        self.calls.append(("chain", rung))
        return 0


class _Passes:
    """Stands in for the Triton passes: launches that do nothing."""

    def __getattr__(self, name):
        class _Kernel:
            def __getitem__(self, grid):
                return lambda *a, **k: None

        return _Kernel()


@pytest.mark.parametrize("precision", ["float32", *REDUCED])
def test_spans_name_each_launchs_body(monkeypatch, precision):
    """``op.softmax.rows`` and ``op.softmax.chain`` carry ``body``: K2's
    at the reduced rungs is ``wgmma``, at float32 ``fma``; K1's row pass
    keeps mma.sync at the reduced rungs."""
    from vae_latent_geometry_tpu_torch.ops import _build

    lib = _Lib()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(ef, "_stream", lambda dev: 0)
    monkeypatch.setattr(es, "_passes", lambda: _Passes())
    rng = np.random.default_rng(0)
    M, D, H, G, T, B = 2, 3, 8, 40, 5, 2
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    ws, bs = [f(M, D, H), f(M, H, G)], [f(M, H), f(M, G)]
    args = (ws, bs, torch.ones(M), f(T, B, D), torch.full((M, B), 0.5))
    with profiling.recording():
        es.energy_fwd(*args, precision)
        es.energy_bwd(*args, torch.ones(B), precision)
        kept = profiling.spans()
    rows = profiling.named(kept, "op.softmax.rows")
    chain = profiling.named(kept, "op.softmax.chain")
    k2 = "fma" if precision == "float32" else "wgmma"
    k1 = "fma" if precision == "float32" else "mma_sync"
    assert [s.args["body"] for s in rows] == [k1, k2]
    assert [s.args["body"] for s in chain] == [k2]
    rung = es._RUNG[precision]
    assert lib.calls == [("rows", rung, 1), ("rows", rung, 0), ("chain", rung)]


def test_source_dispatches_k2s_reduced_rungs_to_warpgroup_mma():
    """The C entry points send K2 at the reduced rungs to the wgmma
    kernels and keep K1 at every rung and K2 at float32 on their bodies;
    every kernel name starts with the prefix ``k2_softmax_roofline``
    reads (``k2s_``) or K1's (``k1s_``)."""
    src = open(SOURCE).read()
    kernels = set(re.findall(r"__global__ void __launch_bounds__\(NT, 1\) "
                             r"(\w+)\(", src))
    assert kernels == {"k1s_rows", "k2s_rows", "k2s_chain", "k2s_rows_wg",
                       "k2s_chain_wg"}
    rows = src[src.index("int vlg_softmax_rows("):]
    rows = rows[:rows.index("\n}\n")]
    assert "kernel = k1s_rows<R>;" in rows
    assert re.search(r"if constexpr \(R == F32\) \{\s*bytes = smem_bytes<R, "
                     r"false>\(\);\s*kernel = k2s_rows<R>;\s*\} else \{\s*"
                     r"bytes = wg_smem_bytes<R, false>\(\);\s*kernel = "
                     r"k2s_rows_wg<R>;", rows)
    chain = src[src.index("int vlg_softmax_chain("):]
    chain = chain[:chain.index("\n}\n")]
    assert "auto kernel = k2s_chain<F32>;" in chain
    assert re.search(r"if constexpr \(R != F32\) \{\s*bytes = wg_smem_bytes<R, "
                     r"true>\(\);\s*kernel = k2s_chain_wg<R>;", chain)
    # a tile waits for its own products, then issues the next tile's k16
    # step by k16 step between its exponentials
    for name in ("rows_wg_tile", "chain_wg_tile"):
        body = src[src.index(f"void {name}("):]
        body = body[:body.index("\n}\n")]
        wait, pin = body.index("wg_wait<0>();"), body.index("wg_pin(u);")
        issue = body.index("wg_logits_k<R>(un, s.ah, s.al, st1, j);")
        exps = min(i for i in (body.find("lse_col(u, j"), body.find("__expf"))
                   if i >= 0)
        assert wait < pin < issue < exps


@pytest.mark.parametrize("precision", REDUCED)
def test_tiled_planes_follow_the_kernels_layout(precision):
    """K2's W2 planes at a reduced rung, tiled: element (k, g) of column
    tile c of decoder m at (k / 8) 512 + (g / 8) 64 + (k % 8) 8 + g % 8 of
    the tile's block (``energy_softmax.cu``'s core-matrix layout), made
    once for a set of planes; lo is its own plane at f32x3 only."""
    rng = np.random.default_rng(3)
    M, D, H, G = 2, 3, 40, 300
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    planes = es.prepared([f(M, D, H), f(M, H, G)], [f(M, H), f(M, G)],
                         precision)
    hi, lo, Gp = planes[2], planes[3], planes[5]
    t_hi, t_lo = es.tiled(planes, precision)
    assert es.tiled(planes, precision)[0] is t_hi
    assert t_hi.is_contiguous() and t_hi.numel() == hi.numel()
    flat = t_hi.reshape(M, Gp // 64, -1)
    for m, k, g in [(0, 0, 0), (1, 127, 383), (1, 37, 200), (0, 8, 65)]:
        c, gl = divmod(g, 64)
        at = (k // 8) * 512 + (gl // 8) * 64 + (k % 8) * 8 + gl % 8
        assert flat[m, c, at] == hi[m, k, g]
    assert torch.equal(t_lo, t_hi) != (precision == "f32x3")
    if precision == "f32x3":
        assert torch.equal(t_lo.reshape(M, Gp // 64, -1)[1, 5, 123],
                           lo[1, (123 // 512) * 8 + (123 % 64) // 8,
                              5 * 64 + ((123 % 512) // 64) * 8 + 123 % 8])


def test_launch_bodies_cover_every_rung():
    assert set(es.BODIES) == {"k1s", "k2s"}
    for bodies in es.BODIES.values():
        assert len(bodies) == len(es._RUNG) and bodies[0] == "fma"


# ------------------------------------------------------------------ card

def _hash(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("precision", REDUCED)
def test_k2_wgmma_matches_plain_on_gpu(precision, shape):
    """K2 at the reduced rungs against its plain version under K2's limits
    (``test_torch_scvi.py``: median and p99 of |error| / max |dgamma|
    below 1e-4 and 1e-3), a repeat bit for bit, every launch counted on the
    softmax route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    ws, bs, lib, g, wmb, ct = _inputs(SHAPES[shape], "cuda")
    ef.reset_launch_counts()
    d = ef.energy_bwd(ws, bs, g, wmb, ct, precision, lib)
    assert torch.equal(d, ef.energy_bwd(ws, bs, g, wmb, ct, precision, lib))
    assert ef.K2_ROUTES["softmax"] == 2
    assert ef.SOFTMAX_PASSES["energy_bwd"] == 8
    d_p = ef.energy_bwd_plain(ws, bs, g, wmb, ct, precision, lib)
    assert torch.isfinite(d).all()
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(EARLIER))
def test_kept_kernels_bit_for_bit_the_earlier_ones_on_gpu(key):
    """K1 at every rung and K2 at float32 give the outputs the kernels
    gave before K2's reduced rungs moved (hashes read on an H100 80GB
    HBM3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_name() != "NVIDIA H100 80GB HBM3":
        pytest.skip("the hashes were read on an H100 80GB HBM3")
    op, shape, precision = key
    ws, bs, lib, g, wmb, ct = _inputs(EARLIER_SHAPES[shape], "cuda")
    out = (ef.energy_fwd(ws, bs, g, wmb, precision, lib) if op == "k1"
           else ef.energy_bwd(ws, bs, g, wmb, ct, precision, lib))
    assert _hash(out) == EARLIER[key]
