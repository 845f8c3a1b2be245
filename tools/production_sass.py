#!/usr/bin/env python3
"""Compare the production kernels' SASS of this tree with another tree's.

    python3 tools/production_sass.py --base <checkout> [--out FILE]

Builds the kernels of both trees where they are not built yet (each tree
with its own ``ops/_build.py``, in a process of its own), disassembles the
libraries with ``cuobjdump -sass`` and sorts every kernel of the production
decoder (all but the generic decode's ``*_any`` kernels) into: the same
SASS; the same instructions in another order (equal counts of each opcode
with its modifiers); or other instructions, with the opcode counts that
differ.  Prints one JSON object (also written to ``--out``).  Needs the CUDA
toolkit: run it on the card's machine, e.g. with the parent commit unpacked
by ``git archive`` into a git-ignored directory as ``--base``.
"""

import argparse
import collections
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The anonymous namespace's name in a mangled symbol carries hashes of the
# translation unit (its path among them); they are cut before comparing.
_ANON_NS = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")

_BUILD = ("import json; from vae_latent_geometry_tpu_torch.ops import _build; "
          "_build.build_all(); print(json.dumps([str(_build._target(n)) "
          "for n in _build.SIGNATURES]))")


def built_libraries(tree):
    """Paths of ``tree``'s kernel libraries, built by its own package."""
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, "-c", _BUILD], cwd=tree, env=env,
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"building {tree}'s kernels failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def production_kernels(lib_paths):
    """{mangled name: (SHA-256 of the SASS, Counter of opcodes)} of every
    kernel but the generic decode's."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = {}
    for path in lib_paths:
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        fn, body = None, []
        for line in sass.splitlines() + ["Function : <end>"]:
            line = _ANON_NS.sub(r"_ZN_GLOBAL__N_\1", line.strip())
            m = re.search(r"Function : (\S+)", line)
            if m:
                if fn and "_any" not in fn:
                    ops = collections.Counter(
                        i.group(1) for i in map(_INSN.search, body) if i)
                    out[fn] = (hashlib.sha256(
                        "\n".join(body).encode()).hexdigest(), ops)
                fn, body = m.group(1), []
            elif fn:
                body.append(line)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="checkout whose kernels are compared against")
    ap.add_argument("--out")
    args = ap.parse_args()
    base = production_kernels(built_libraries(os.path.abspath(args.base)))
    this = production_kernels(built_libraries(ROOT))
    res = {"same": [], "reordered": [], "changed": {},
           "only_base": sorted(base.keys() - this.keys()),
           "only_this": sorted(this.keys() - base.keys())}
    for name in sorted(base.keys() & this.keys()):
        (h0, ops0), (h1, ops1) = base[name], this[name]
        if h0 == h1:
            res["same"].append(name)
        elif ops0 == ops1:
            res["reordered"].append(name)
        else:
            res["changed"][name] = {op: [ops0[op], ops1[op]]
                                    for op in sorted(ops0.keys() | ops1.keys())
                                    if ops0[op] != ops1[op]}
    nvcc = subprocess.run(["nvcc" if shutil.which("nvcc") else os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "--version"], capture_output=True, text=True).stdout
    res["nvcc"] = nvcc.strip().splitlines()[-1]
    res["counts"] = {k: len(res[k]) for k in ("same", "reordered", "changed",
                                              "only_base", "only_this")}
    text = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
