"""The C++ cell-list neighbour search, loaded with ctypes; counterpart of
``gcnn_keras_tpu/native/__init__.py``.

The source is the repository's ``native/neighborlist.cpp``, which both
packages load. It replaces the dense O(n^2) distance matrix of
``graph/preprocess.py`` for large molecules and cells (``set_range`` and
``set_range_periodic`` take it from 256 and 192 atoms under
``backend="auto"``), the host work that MD re-neighbouring and dataset
preprocessing repeat.

Loading order:
1. the ``GCNN_TPU_NATIVE_LIB`` environment variable (an explicit path),
2. a prebuilt ``_libneighborlist.so`` next to this module,
3. a build with ``g++`` (``-O3 -fopenmp``, else ``-O3``) into the port's
   ``_build/`` directory (listed in ``.gitignore``), named by a hash of the
   source; the build writes a temporary file and renames it into place, so
   that processes building at once never load half a library,
4. otherwise ``available()`` is False and callers take the numpy path.
Nothing is built or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parents[2] / "native" / "neighborlist.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_longlong_p = ctypes.POINTER(ctypes.c_longlong)


def library_path() -> Path:
    """Where a build of the current source goes: named by its hash, so an
    edited source is built again."""
    try:
        tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    except OSError:
        tag = "prebuilt"
    return BUILD_DIR / f"_libneighborlist_{tag}.so"


def _candidate_paths():
    env = os.environ.get("GCNN_TPU_NATIVE_LIB")
    if env:
        yield Path(env)
    yield Path(__file__).resolve().parent / "_libneighborlist.so"
    yield library_path()


def _compile() -> Optional[Path]:
    if not SRC.exists():
        return None
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    res = None
    try:
        for flags in (["-O3", "-fopenmp"], ["-O3"]):  # OpenMP optional
            cmd = ["g++", *flags, "-shared", "-fPIC", str(SRC), "-o", str(tmp)]
            try:
                res = subprocess.run(cmd, capture_output=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                return None
            if res.returncode == 0:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
                return out
    finally:
        tmp.unlink(missing_ok=True)
    logger.warning("native build failed: %s", res.stderr.decode()[:500])
    return None


def _try(path: Path) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(path))
        # a stale prebuilt library that lacks the newer symbols is rejected
        lib.neighbor_list_cell
        lib.neighbor_list_periodic
        return lib
    except (OSError, AttributeError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for path in _candidate_paths():
        if path.exists():
            _LIB = _try(path)
            if _LIB is not None:
                break
    if _LIB is None:
        built = _compile()
        if built:
            _LIB = _try(built)
    if _LIB is not None:
        _LIB.neighbor_list_cell.restype = ctypes.c_longlong
        _LIB.neighbor_list_cell.argtypes = [
            _c_double_p, ctypes.c_longlong, ctypes.c_double, ctypes.c_longlong,
            _c_longlong_p, _c_double_p]
        _LIB.neighbor_list_periodic.restype = ctypes.c_longlong
        _LIB.neighbor_list_periodic.argtypes = [
            _c_double_p, ctypes.c_longlong, _c_double_p, _c_longlong_p,
            ctypes.c_longlong, ctypes.c_double, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, _c_longlong_p, _c_longlong_p, _c_double_p]
        _LIB.neighbor_list_has_openmp.restype = ctypes.c_int
        _LIB.neighbor_list_has_openmp.argtypes = []
        logger.info("native neighbour list loaded (openmp=%d)", _LIB.neighbor_list_has_openmp())
    return _LIB


def available() -> bool:
    return _load() is not None


def has_openmp() -> bool:
    """Whether the loaded library was built with OpenMP (False without one)."""
    lib = _load()
    return bool(lib is not None and lib.neighbor_list_has_openmp())


def neighbor_list(xyz: np.ndarray, cutoff: float,
                  max_neighbors: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Cell-list neighbour search: ``(pairs (M,2) int64 [recv, send], dist
    (M,) float64)`` sorted by (recv, send), senders closer than ``cutoff``
    and at most the ``max_neighbors`` closest a receiver; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    n = xyz.shape[0]
    k = int(min(max_neighbors, max(n - 1, 1)))
    pairs = np.empty((n * k, 2), dtype=np.int64)
    dist = np.empty(n * k, dtype=np.float64)
    m = lib.neighbor_list_cell(
        xyz.ctypes.data_as(_c_double_p), n, float(cutoff), k,
        pairs.ctypes.data_as(_c_longlong_p), dist.ctypes.data_as(_c_double_p))
    if m < 0:
        return None
    return pairs[:m], dist[:m]


def neighbor_list_periodic(
        xyz: np.ndarray, lattice: np.ndarray, cutoff: float,
        max_neighbors: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Periodic cell-list neighbour search over the lattice's images.

    The image range along each lattice direction is the cutoff over its
    plane spacing, as the numpy path's. Returns ``(pairs (M,2) int64 [recv,
    send], images (M,3) int64 of the sender, dist (M,) float64)`` sorted by
    (recv, send, image), senders within ``cutoff`` (inclusive, as the numpy
    path), or None without the library.
    """
    lib = _load()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    lat = np.asarray(lattice, dtype=np.float64)
    n = xyz.shape[0]
    recip = np.linalg.inv(lat).T
    spacing = 1.0 / np.maximum(np.linalg.norm(recip, axis=1), 1e-12)
    n_img = np.maximum(np.ceil(cutoff / spacing).astype(int), 1)
    rng = [np.arange(-k, k + 1) for k in n_img]
    images = np.ascontiguousarray(
        np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3), dtype=np.int64)
    shifts = np.ascontiguousarray(images @ lat, dtype=np.float64)
    central = int(np.nonzero(np.all(images == 0, axis=1))[0][0])

    k = int(max_neighbors) if max_neighbors is not None else 0
    # a receiver's cap, or a density guess that the library corrects: it
    # returns minus the size it needs when the buffers are too small
    cap = n * k if k > 0 else max(n * 64, 1024)
    for _ in range(2):
        pairs = np.empty((cap, 2), dtype=np.int64)
        img_out = np.empty((cap, 3), dtype=np.int64)
        dist = np.empty(cap, dtype=np.float64)
        m = lib.neighbor_list_periodic(
            xyz.ctypes.data_as(_c_double_p), n, shifts.ctypes.data_as(_c_double_p),
            images.ctypes.data_as(_c_longlong_p), images.shape[0], float(cutoff), k,
            central, cap, pairs.ctypes.data_as(_c_longlong_p),
            img_out.ctypes.data_as(_c_longlong_p), dist.ctypes.data_as(_c_double_p))
        if m >= 0:
            return pairs[:m], img_out[:m], dist[:m]
        cap = -m
    return None
