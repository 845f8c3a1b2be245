"""Shortest paths: native C++ multi-source Dijkstra with a scipy route.

Sources are deduplicated and solved once each (OpenMP over sources in the
native library, one vectorized scipy call otherwise), and paths for all
pairs are extracted from the shared predecessor arrays into padded matrices
ready for the batched least-squares spline fit.

The native library is the repository's ``native/graph.cpp``.  The port loads
``native/libvlg_graph.so`` where it exists, else a copy it builds from the
source with ``g++`` into this package's ``build/`` directory (git-ignored)
on first use; without source or compiler the scipy route runs.
:func:`backend` says which.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
_LIB_NAME = "libvlg_graph.so"


def _build_native() -> Optional[Path]:
    """Compile ``native/graph.cpp`` into the build directory; None when the
    source or the compiler is missing."""
    src = _NATIVE_DIR / "graph.cpp"
    cxx = shutil.which("g++") or shutil.which("c++")
    if not src.exists() or cxx is None:
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / _LIB_NAME
    subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-fopenmp", "-shared",
                    "-o", str(out), str(src)], check=True,
                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return out


@lru_cache(maxsize=1)
def _load_native() -> Optional[ctypes.CDLL]:
    path = next((p for p in (_NATIVE_DIR / _LIB_NAME, _BUILD_DIR / _LIB_NAME)
                 if p.exists()), None) or _build_native()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i32, i64, f32 = (np.ctypeslib.ndpointer(t)
                     for t in (np.int32, np.int64, np.float32))
    lib.vlg_grid_knn_graph.restype = ctypes.c_int64
    lib.vlg_grid_knn_graph.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, i64, i32, f32]
    lib.vlg_dijkstra_multi.restype = None
    lib.vlg_dijkstra_multi.argtypes = [
        ctypes.c_int64, i64, i32, f32, i32, ctypes.c_int64, f32, i32]
    lib.vlg_extract_paths.restype = None
    lib.vlg_extract_paths.argtypes = [
        ctypes.c_int64, i32, i32, i32, i32, ctypes.c_int64, ctypes.c_int32,
        i32, i32]
    return lib


def native_available() -> bool:
    return _load_native() is not None


def backend() -> str:
    """'native' when the C++ library carries the graph stages, else
    'scipy'."""
    return "native" if native_available() else "scipy"


def grid_knn_native(nx: int, ny: int, dx: float, dy: float, k: int):
    lib = _load_native()
    n = nx * ny
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(n * k, np.int32)
    dists = np.empty(n * k, np.float32)
    lib.vlg_grid_knn_graph(nx, ny, dx, dy, k, indptr, indices, dists)
    return indptr, indices, dists


def dijkstra_multi(graph: sp.csr_matrix, sources: np.ndarray,
                   use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Distances and predecessors from each source.

    Returns (dist (m, n) float32, pred (m, n) int32) with pred = -1 for
    unreachable nodes and for the source itself.
    """
    sources = np.asarray(sources, np.int32)
    graph = graph.tocsr().astype(np.float32)
    n = graph.shape[0]
    lib = _load_native() if use_native else None
    if lib is not None:
        m = len(sources)
        dist = np.empty((m, n), np.float32)
        pred = np.empty((m, n), np.int32)
        lib.vlg_dijkstra_multi(
            n, graph.indptr.astype(np.int64), graph.indices.astype(np.int32),
            graph.data, sources, m, dist, pred,
        )
        return dist, pred
    from scipy.sparse.csgraph import dijkstra as sp_dijkstra

    dist, pred = sp_dijkstra(graph, indices=sources, return_predecessors=True)
    pred = np.where(pred == -9999, -1, pred).astype(np.int32)
    return dist.astype(np.float32), pred


def extract_paths(pred: np.ndarray, source_rows: np.ndarray,
                  sources: np.ndarray, targets: np.ndarray,
                  max_len: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Padded node-index paths for each (source_row, target) pair.

    pred: (m, n) predecessor matrix from :func:`dijkstra_multi`
    source_rows: (P,) row into pred per pair;  targets: (P,) target node ids
    Returns (paths (P, max_len) int32 padded with -1, lengths (P,) int32 with
    0 marking unreachable/skipped pairs — reference skip semantics at
    ``src/init_splines_ensemble.py:164-170``).
    """
    pred = np.ascontiguousarray(pred, np.int32)
    source_rows = np.asarray(source_rows, np.int32)
    sources = np.asarray(sources, np.int32)
    targets = np.asarray(targets, np.int32)
    P = len(targets)
    lib = _load_native()
    if lib is not None:
        paths = np.empty((P, max_len), np.int32)
        lengths = np.empty(P, np.int32)
        lib.vlg_extract_paths(pred.shape[1], pred, sources, source_rows,
                              targets, P, max_len, paths, lengths)
        return paths, lengths

    paths = np.full((P, max_len), -1, np.int32)
    lengths = np.zeros(P, np.int32)
    for p in range(P):
        row, src, node = source_rows[p], sources[source_rows[p]], targets[p]
        rev = []
        ok = True
        while node != src:
            if node < 0 or len(rev) >= max_len:
                ok = False
                break
            rev.append(node)
            node = pred[row, node]
        if not ok or len(rev) + 1 > max_len:
            continue
        rev.append(src)
        L = len(rev)
        paths[p, :L] = rev[::-1]
        lengths[p] = L
    return paths, lengths
