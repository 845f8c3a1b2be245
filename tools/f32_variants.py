#!/usr/bin/env python3
"""One-off: K1's and K5's float32 kernels (``ops/csrc/decode_f32.cuh``) timed
with one piece of their work changed or left out, to see what each piece
costs.  Most variants compute wrong energies: they are for timing only.

    python3 tools/f32_variants.py [--variants a,b,...] [--out FILE]

Each variant is a copy of ``vae_latent_geometry_tpu_torch/ops/csrc`` with a
few textual replacements, built into ``vae_latent_geometry_tpu_torch/ops/
build/f32_variants/<name>/`` and timed by CUDA events on the production
chunk (the committed model, the seed-42 init curves padded to B=200,
T=2000; K5 on ``torch.randint`` planes at S=2), in the order given, then
the first variant again.  Needs one CUDA GPU and nvcc.
"""

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

H = "decode_f32.cuh"
VARIANTS = {
    "base": [],
    # W3 of the first decoder only: no per-decoder copies of W3
    "no_w3_copy": [(H, "if (next >= 0) f32_issue_w3(s, fw.W3p, next);", "")],
    # layer 1 skipped (act keeps what it held)
    "no_layer1": [(H, "if (c >= n_c) break;", "break;")],
    # layer 3's product skipped
    "no_gemm3": [(H, "    f32_gemm3(s, p3, n3, x);", "")],
    # the products' k loops unrolled 4 or 16 times instead of 8
    "unroll4": [(H, "#pragma unroll 8\n  for (int k = K0;", "#pragma unroll 4\n  for (int k = K0;"),
                (H, "#pragma unroll 8\n  for (int k = 0; k < H;",
                 "#pragma unroll 4\n  for (int k = 0; k < H;")],
    "unroll16": [(H, "#pragma unroll 8\n  for (int k = K0;",
                  "#pragma unroll 16\n  for (int k = K0;"),
                 (H, "#pragma unroll 8\n  for (int k = 0; k < H;",
                  "#pragma unroll 16\n  for (int k = 0; k < H;")],
    # K5/K7's tiles sized for 48 or 64 expected rows per decoder list
    "rows48": [("energy_mc.cu", "(int)(56.0 / p)", "(int)(48.0 / p)")],
    "rows64": [("energy_mc.cu", "(int)(56.0 / p)", "(int)(64.0 / p)")],
    # the layer-2 product skipped (the epilogue stores relu(b2))
    "no_gemm2": [(H, "if (live) f32_gemm2<NP, 0>(s, p2, n2, acc);", ""),
                 (H, "if (live) f32_gemm2<NP, H / 2>(s, p2, n2, acc);", "")],
}


def make(name, src, dst):
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(dst, fname)
        s = open(path).read()
        assert old in s, (name, old)
        open(path, "w").write(s.replace(old, new))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    from mc_kernels import load_tree, production_inputs
    from vae_latent_geometry_tpu_torch.ops import _build
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    if not torch.cuda.is_available():
        raise SystemExit("f32_variants: no CUDA device available")
    smoke = load_tree(REPO)
    dev = torch.device("cuda")
    ws, bs, gamma = production_inputs(smoke, dev)
    T, B = gamma.shape[:2]
    M = ws[0].shape[0]
    wmb = ef.uniform_weights(M, B, dev)
    d1, d2 = mc.sample_decoder_indices(
        torch.Generator(device=dev).manual_seed(7), T, B, M, 2)
    src = str(_build.CSRC)
    root = os.path.join(str(_build.BUILD_DIR), "f32_variants")
    names = args.variants.split(",")
    out = {"card": smoke.card_line(), "ms": []}
    for name in names + names[:1]:
        dst = os.path.join(root, name)
        make(name, src, os.path.join(dst, "csrc"))
        _build.CSRC = type(_build.CSRC)(os.path.join(dst, "csrc"))
        _build.BUILD_DIR = type(_build.BUILD_DIR)(os.path.join(dst, "lib"))
        _build._LIBS.clear()
        _build.build_all(["energy_expected", "energy_mc"])
        rec = {"variant": name,
               "K1": smoke.time_ms(lambda: ef.energy_fwd(
                   ws, bs, gamma, wmb, "float32"), 10),
               "K5": smoke.time_ms(lambda: mc.energy_mc_fwd(
                   ws, bs, gamma, d1, d2, "float32"), 10)}
        print(json.dumps(rec), flush=True)
        out["ms"].append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
