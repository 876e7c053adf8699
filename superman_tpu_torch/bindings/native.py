"""ctypes bindings to the native CPU engine (native/perman_cpu.cpp).

Port of ``superman_tpu/bindings/native.py``, over the port's own copy of
the engine, built by native/build.py.  Parity: the libConnect.so surface
(reference interface_connector.c:61-231 + superPython.py):
`read_calculate_return`, `matlab_calculate_return_int`,
`matlab_calculate_return_double`, `connect`, plus direct entry points for
each engine (dense/sparse/skipper exact, their __float128 "quad" walks,
the Z_p walks of the exact engine, Rasmussen, the scaling estimator).

The library is loaded with ctypes' default RTLD_LOCAL, so its symbols
stay apart from any other library of the same names in the process (the
JAX package's copy, in the tests), and every call releases the GIL.
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np

from ..core.matrix import DenseMatrix, require_finite
from ..core.result import Result


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    from ..native.build import build
    lib = ctypes.CDLL(build())
    D = ctypes.c_double
    I = ctypes.c_int
    LL = ctypes.c_longlong
    U = ctypes.c_ulonglong
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    ip64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    up64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    sigs = {
        "sup_perman_dense": (D, [dp, I, I, I]),
        "sup_perman_sparse": (D, [dp, I, I, I]),
        "sup_perman_skipper": (D, [dp, I, I, I]),
        "sup_perman_dense_chunks": (D, [dp, I, ip64, LL, I, I]),
        "sup_rasmussen": (D, [dp, I, LL, I, U, ctypes.POINTER(D)]),
        "sup_approx_scaling": (D, [dp, I, LL, I, I, I, U,
                                   ctypes.POINTER(D)]),
        "sup_perman_mod": (U, [up64, I, U]),
        "sup_perman_mod_batch": (None, [up64, I, up64, I, I, up64]),
        "sup_perman_mod_pruned": (U, [up64, I, U, ip64, LL, I, I]),
        "sup_perman_glynn_mod_chunked": (U, [up64, I, U, I, I]),
        "sup_cpu_ifma": (I, []),
        "read_calculate_return": (D, [ctypes.c_char_p, I, I, I, I, I]),
        "connect": (None, []),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def native_available() -> bool:
    """True when the engine builds and loads on this host."""
    try:
        load()
        return True
    except Exception:
        return False


def perman_dense_chunks(a_scaled: np.ndarray, chunk_ids: np.ndarray,
                        r: int, threads: int) -> float:
    """Raw partial sum over aligned Gray chunks (the hybrid scheduler's
    CPU side).

    a_scaled must be the SAME row-scaled matrix the card's walk runs on;
    the returned value carries no final sign factor (see perman_cpu.cpp).
    """
    lib = load()
    a = np.ascontiguousarray(a_scaled, dtype=np.float64)
    ids = np.ascontiguousarray(chunk_ids, dtype=np.int64)
    return float(lib.sup_perman_dense_chunks(
        a, a.shape[0], ids, len(ids), int(r), int(threads)))


def perman_mod_batch(mats: np.ndarray, primes: np.ndarray,
                     threads: int = 0) -> np.ndarray:
    """per(mats[i]) mod primes[i] for pre-reduced uint64 matrices of shape
    (np, n, n), mats[i] already reduced into [0, primes[i])."""
    lib = load()
    mats = np.ascontiguousarray(mats, dtype=np.uint64)
    ps = np.ascontiguousarray(primes, dtype=np.uint64)
    out = np.empty(len(ps), dtype=np.uint64)
    lib.sup_perman_mod_batch(mats, mats.shape[-1], ps, len(ps),
                             int(threads), out)
    return out


def cpu_ifma() -> bool:
    """True when the host runs the AVX-512 IFMA 8-lane Z_p walk (52-bit
    Montgomery lanes); the CRT backend then picks primes below 2^50 so
    the pruned walk dispatches onto it."""
    try:
        return bool(load().sup_cpu_ifma())
    except Exception:
        return False


def perman_mod_pruned(am: np.ndarray, p: int, ids: np.ndarray, r: int,
                      threads: int = 0) -> int:
    """per(am) mod p over the live chunks `ids` at chunk length 2^r; am
    pre-reduced into [0, p), odd p < 2^62."""
    lib = load()
    am = np.ascontiguousarray(am, dtype=np.uint64)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if not 1 <= int(r) <= 62:
        raise ValueError(f"r={r} must lie in [1, 62]")
    return int(lib.sup_perman_mod_pruned(am, am.shape[0], p, ids,
                                         len(ids), int(r), int(threads)))


def perman_glynn_mod(am: np.ndarray, p: int, r: int = None,
                     threads: int = 0) -> int:
    """per(am) mod p by the Glynn polarization walk, the second,
    algorithmically independent exact engine.  am pre-reduced into
    [0, p); r is the chunk log-length (default: ~8k chunks)."""
    lib = load()
    am = np.ascontiguousarray(am, dtype=np.uint64)
    n = am.shape[0]
    if r is None:
        r = max(1, n - 1 - 13)
    return int(lib.sup_perman_glynn_mod_chunked(am, n, p, int(r),
                                                int(threads)))


def read_calculate_return(filename: str, algorithm: int, nt: int = 16,
                          x: int = 100000, y: int = 4, z: int = 5) -> float:
    """Reference superPython entry point (superPython.py:21-29).  The
    file is read here first and refused, as `permanent` refuses it, if an
    entry is NaN or infinite."""
    from ..io.triplet import read_triplet
    require_finite(read_triplet(filename).mat, filename)
    return float(load().read_calculate_return(
        filename.encode(), algorithm, nt, x, y, z))


def perman_native(dense: DenseMatrix, flags) -> Result:
    """Route a flags-configured run to the native CPU engine.

    scale_intervals=-1 (auto) resolves as the device estimators resolve
    it (ops/approx._si) before it reaches sup_approx_scaling: the JAX
    binding passes -1 through, and the native estimator then rescales at
    every step."""
    from ..ops.approx import _si
    lib = load()
    a = np.ascontiguousarray(dense.mat, dtype=np.float64)
    n = dense.nov
    nt = int(flags.threads)
    t0 = time.perf_counter()
    zeros = ctypes.c_double(0.0)
    if flags.approximation:
        algo = str(flags.perman_algo)
        if algo in ("rasmussen", "1", "3"):
            p = lib.sup_rasmussen(a, n, int(flags.number_of_times), nt,
                                  int(flags.seed) + 12345,
                                  ctypes.byref(zeros))
            name = "cpu_rasmussen"
        else:
            p = lib.sup_approx_scaling(a, n, int(flags.number_of_times),
                                       _si(flags), int(flags.scale_times),
                                       nt, int(flags.seed) + 12345,
                                       ctypes.byref(zeros))
            name = "cpu_approx_scaling"
        iters = int(flags.number_of_times)
    elif flags.sparse:
        cq = 1 if flags.resolved_calc() == "quad" else 0
        if flags.preprocessing == 2 or str(flags.perman_algo) in (
                "2", "3", "skipper"):
            p = lib.sup_perman_skipper(a, n, nt, cq)
            name = "cpu_skipper"
        else:
            p = lib.sup_perman_sparse(a, n, nt, cq)
            name = "cpu_sparyser"
        if cq:
            name += "_quad"
        iters = 1 << (n - 1)
    else:
        cq = 1 if flags.resolved_calc() == "quad" else 0
        p = lib.sup_perman_dense(a, n, nt, cq)
        name = "cpu_ryser_quad" if cq else "cpu_ryser"
        iters = 1 << (n - 1)
    dt = time.perf_counter() - t0
    return Result(float(p), dt, algo_name=name, zeros=int(zeros.value),
                  iterations=iters,
                  meta={"threads": nt, "iters_per_sec": iters / max(dt, 1e-9),
                        "engine": "native"})
