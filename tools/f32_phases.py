#!/usr/bin/env python3
"""One-off: where the float32 forward kernels' cycles go (k1_fwd_fma for K1,
mc_fwd_fma for K5/K7), by phase of ``ops/csrc/decode_f32.cuh``'s chunk.

    python3 tools/f32_phases.py [--samples 2] [--out FILE]

Copies ``vae_latent_geometry_tpu_torch/ops/csrc`` into
``vae_latent_geometry_tpu_torch/ops/build/f32_phases/`` with thread 0 of
every block reading ``clock64()`` after each barrier of
``f32_decode_chunk`` and after the MC kernel's scatter barrier, builds
those copies, runs K1 and K5 once on the
production chunk (the committed model, the seed-42 init curves padded
to B=200, T=2000; K5 on ``torch.randint`` planes at S = ``--samples``) and
prints each phase's share of the block cycles and the kernels' ms by CUDA
events (stamped, and the package's own build unstamped).  Phases, each
ending at its barrier:

  stats_L1  after the previous chunk: (K1) the W3 copies' issue and the
            statistics, (K5) the +x_{d2} updates of the differences; then
            layer 1 (before the first chunk: the tile's set-up)
  G2a       the first half of the layer-2 product (and the wait for W2's
            second half)
  G2b       its second half
  E2        the layer-2 epilogue (and the wait for W3)
  G3        layer 3 (and the wait for the next chunk's small weights)
  scatterA  (K5) the W3 copies' issue, then the -x_{d1} updates of the
            differences
  tile      the tile's end (segments or the sum of squares)

Needs one CUDA GPU and nvcc.
"""

import argparse
import json
import os
import re
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

PHASES = ("tile", "stats_L1", "G2a", "G2b", "E2", "G3", "scatterA")
STAMP = r"""
__device__ unsigned long long f32_cyc[8];
__shared__ long long f32_t0;
__device__ __forceinline__ void f32_mark(int ph) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    atomicAdd(&f32_cyc[ph], (unsigned long long)(now - f32_t0));
    f32_t0 = now;
  }
}
"""


def patch(src_dir, dst_dir):
    """The csrc copy with the stamps."""
    if os.path.exists(dst_dir):
        shutil.rmtree(dst_dir)
    shutil.copytree(src_dir, dst_dir)
    hdr = os.path.join(dst_dir, "decode_f32.cuh")
    s = open(hdr).read()
    s = s.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    # the SMEM_MAX budget leaves room for the stamp's shared word
    s = s.replace("SMEM_MAX = 232448", "SMEM_MAX = 232448 - 64")
    body = s.index("__device__ __forceinline__ void f32_decode_chunk(")
    head, tail = s[:body], s[body:]
    n = [0]

    def mark(m):
        n[0] += 1
        return f"__syncthreads();\n  f32_mark({n[0]});"
    tail = re.sub(r"__syncthreads\(\);", mark, tail)
    assert n[0] == 5, n[0]
    s = head + tail + ('\nextern "C" int f32_phase_cycles(unsigned long long* out, int reset) {\n'
                       '  if (reset) { unsigned long long z[8] = {}; '
                       'return cudaMemcpyToSymbol(f32_cyc, z, sizeof(z)); }\n'
                       '  return cudaMemcpyFromSymbol(out, f32_cyc, 8 * sizeof(unsigned long long));\n}\n')
    open(hdr, "w").write(s)
    for name, kernel in (("energy_expected.cu", "k1_fwd_fma"),
                         ("energy_mc.cu", "mc_fwd_fma")):
        path = os.path.join(dst_dir, name)
        s = open(path).read()
        i = s.index(f"\n{kernel}(")
        j = s.index("{", i) + 1
        s = s[:j] + "\n  if (threadIdx.x == 0) f32_t0 = clock64();" + s[j:]
        # the end of the block, and (K5) the scatter's barrier
        k = s.index("\n}\n", j)
        s = s[:k] + "\n  __syncthreads();\n  f32_mark(0);" + s[k:]
        if kernel == "mc_fwd_fma":
            a = s.index("// ... then +x_m(t+1)", j)
            b = s.rindex("__syncthreads();", j, a)
            s = s[:b] + "__syncthreads();\n      f32_mark(6);" + s[
                b + len("__syncthreads();"):]
        open(path, "w").write(s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    import ctypes

    import numpy as np
    import torch

    from mc_kernels import load_tree, production_inputs
    from vae_latent_geometry_tpu_torch.ops import _build
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    if not torch.cuda.is_available():
        raise SystemExit("f32_phases: no CUDA device available")
    smoke = load_tree(REPO)
    dev = torch.device("cuda")
    ws, bs, gamma = production_inputs(smoke, dev)
    T, B = gamma.shape[:2]
    M = ws[0].shape[0]
    wmb = ef.uniform_weights(M, B, dev)
    S = args.samples
    d1, d2 = mc.sample_decoder_indices(
        torch.Generator(device=dev).manual_seed(7), T, B, M, S)
    calls = {"K1": lambda: ef.energy_fwd(ws, bs, gamma, wmb, "float32"),
             "K5": lambda: mc.energy_mc_fwd(ws, bs, gamma, d1, d2,
                                            "float32")}
    plain_ms = {k: smoke.time_ms(f, 5) for k, f in calls.items()}
    stamped = os.path.join(os.path.dirname(_build.BUILD_DIR), "build",
                           "f32_phases")
    patch(str(_build.CSRC), os.path.join(stamped, "csrc"))
    _build.CSRC = type(_build.CSRC)(os.path.join(stamped, "csrc"))
    _build.BUILD_DIR = type(_build.BUILD_DIR)(os.path.join(stamped, "lib"))
    _build._LIBS.clear()
    _build.build_all(["energy_expected", "energy_mc"])
    out = {"card": smoke.card_line(), "S": S}
    for (k, fn), lib_name in zip(calls.items(),
                                 ("energy_expected", "energy_mc")):
        lib = _build.library(lib_name)
        lib.f32_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        ms = smoke.time_ms(fn, 5)
        torch.cuda.synchronize()
        cyc = (ctypes.c_ulonglong * 8)()
        _build.check(lib.f32_phase_cycles(cyc, 1), "reset")
        fn()
        torch.cuda.synchronize()
        _build.check(lib.f32_phase_cycles(cyc, 0), "read")
        c = np.array(list(cyc)[:len(PHASES)], dtype=np.float64)
        out[k] = {"ms_stamped": ms, "ms": plain_ms[k],
                  "share": {p: float(v / c.sum()) for p, v in zip(PHASES, c)}}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
