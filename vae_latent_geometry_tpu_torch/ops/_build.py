"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on first use, into the package's ``build/``
directory (git-ignored); the library is loaded with ``ctypes``.  The file
name carries a hash of the source, of every header under ``csrc/`` that it
includes, and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

from vae_latent_geometry_tpu_torch.utils.profiling import (
    record_interval,
    trace_annotation,
)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# --split-compile=0: cicc and ptxas work on parts of a source (ptxas on its
# kernels) in parallel threads, one per core; the four sources build in
# about a quarter of the time (tools/build_times.py).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C signatures of the entry points, per source.  A decoder is passed as L,
# widths[0..L] and the per-layer weight and bias pointer arrays.
_DEC = [_I, _P, _P, _P]
SIGNATURES = {
    "energy_expected": {
        "vlg_energy_fwd_tiles": [_I],
        "vlg_f32_scratch_words": [_I, _I, _I, _P],
        "vlg_energy_fwd": [_I, _P, _I, _I, _I, *_DEC, _P, _P, _P, _P, _I, _P],
        "vlg_energy_bwd": [_I, _P, _I, _I, _I, _I, _I, *_DEC, _P, _P, _P, _P,
                           _P, _I, _P],
        "vlg_k2_block_words": [_I, _I],
        "vlg_k2_plane_words": [_I],
        "vlg_mma_selftest": [_I, _P, _P, _P, _I, _P],
    },
    "energy_mc": {
        "vlg_mc_fwd_tiles": [_I, _I, _I, _I, _I, _P],
        "vlg_f32_scratch_words": [_I, _I, _I, _P],
        "vlg_mc_fwd": [_I, _P, _I, _I, _I, _I, *_DEC, _P, _P, _P, _U, _U, _I,
                       _P, _P, _P, _I, _P],
        "vlg_mc_bwd": [_I, _P, _I, _I, _I, _I, *_DEC, _P, _P, _P, _U, _U, _I,
                       _P, _P, _P, _P, _I, _P],
        "vlg_mc_bwd_planes": [_I, _I, _I, _I, _P],
    },
    "energy_transposed": {
        "vlg_t_scratch_words": [_I, _I, _I],
        "vlg_t_chunk_rows": [_I, _I, _P, _I],
        "vlg_t_fwd_rows": [_I, _I, _I, _I, _P],
        "vlg_f32_scratch_words": [_I, _I, _I, _P],
        "vlg_energy_t_fwd": [_I, _P, _I, _I, _I, _I, _I, _I, *_DEC, _P, _P,
                             _P, _P, _P],
        "vlg_t_plane_words": [_I],
        "vlg_energy_t_bwd": [_I, _P, _I, _I, _I, _I, _I, _I, *_DEC, _P, _P,
                             _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "energy_stats": {
        "vlg_stats_fwd": [_I, _P, _I, _I, _I, *_DEC, _P, _P, _P, _P, _P, _I,
                          _P],
        "vlg_stats_bwd": [_I, _P, _I, _I, _I, *_DEC, _P, _P, _P, _P, _P, _P,
                          _I, _P],
    },
}
# exported by every library (csrc/decode_any.cuh)
COMMON = {"vlg_any_scratch_words": [_I, _P, _I], "vlg_any_head_words": [_I]}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # nvcc output (register / spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on first use and need the CUDA toolkit")


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file under ``csrc/`` that it includes
    with ``#include "..."``, directly or through another such header."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for inc in re.findall(r'^\s*#\s*include\s*"([^"]+)"', path.read_text(),
                              re.MULTILINE):
            todo.append((path.parent / inc).resolve())
    return files


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together, and wait for each of them.  Returns the wall seconds of each
    compiler this call ran, by source (an ``ops.build`` span each while the
    recorder is on); raises with the compiler's output when a build
    fails."""
    names = list(SIGNATURES) if names is None else names
    t0 = time.time_ns()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        log = open(tmp.with_suffix(".log"), "w+")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT, text=True), tmp, out, log)
    seconds: Dict[str, float] = {}
    running = dict(procs)
    while running:
        for name, (proc, *_) in list(running.items()):
            if proc.poll() is not None:
                t1 = time.time_ns()
                seconds[name] = (t1 - t0) * 1e-9
                record_interval("ops.build", t0, t1, source=name)
                del running[name]
        if running:
            time.sleep(0.1)
    for name, (proc, tmp, out, log) in procs.items():
        log.seek(0)
        BUILD_LOG[name] = log.read()
        log.close()
        os.remove(log.name)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{BUILD_LOG[name]}")
        os.replace(tmp, out)
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if missing; the
    first call is an ``ops.library`` span)."""
    lib = _LIBS.get(name)
    if lib is None:
        with trace_annotation("ops.library", source=name):
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in {**SIGNATURES[name], **COMMON}.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {err}")
