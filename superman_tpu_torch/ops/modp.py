"""Z_p modular Ryser walk and the CRT driver of the exact engine.

Port of the host side and driver of ``superman_tpu/ops/modp.py``.  The
exact engine (ops/exact.py) reduces a bigint core matrix mod each of a
few primes, walks the Nijenhuis-Wilf Gray sum in Z_p on the card
(ops/modp_cuda.py, csrc/modp_walk.cu), and rebuilds the integer by
Chinese remaindering, checked against one held-out prime.

The TPU walked primes p <= 2039 as lazy f32 residues; the card walks
31-bit primes in Montgomery form, so the pool descends from 2^31 - 1 and
a permanent needs about 2.8 times fewer walks per CRT bit.  The walk
plans with the card planner (ops/gray.make_plan) as the df64 walk does;
the TPU's launch caps, lane rounding and watchdog limits have no
counterpart here.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time

import numpy as np
import torch

from ..utils import trace
from . import gray, modp_cuda

#: the CRT prime pool descends from here (the kernel takes odd p < 2^31)
PRIME_CEIL = (1 << 31) - 1

#: the Z_p kernel's rate in G Gray steps per second for one prime, the
#: planner's t_iter (core_plan -> plan_sparse).  Measured at n=32 on the
#: dense plan (2^17 chunks of 2^14 steps, one 31-bit prime): 46.1-47.7 ms,
#: 45-47 G steps/s (NVIDIA H100 80GB HBM3, 700.00 W)
K3_GITERS = 45.0
#: the plain Z_p walk's rate on the CPU in G Gray steps per second, what
#: calc="auto" prices the exact rung at on device="cpu".  Measured by
#: tools/kernel_time.py --tier modp --device cpu --n 24 (2^23 steps, one
#: prime, 8 torch threads, median of 3): 0.0032 on the x86_64 host of an
#: NVIDIA H100 80GB HBM3 machine, 0.0042 on another x86_64 host; some
#: 14,000 times below K3
PLAIN_GITERS = 0.003


# --------------------------------------------------------- host packing

def reduce_core_mod(core, p: int) -> np.ndarray:
    """Residue matrix of a bigint core mod p, as (n, n) int64 ndarray."""
    return np.asarray([[int(v) % p for v in row] for row in core],
                      dtype=np.int64)


def pack_mod(am: np.ndarray, p: int, n_pad: int):
    """Host pack of a residue matrix: (x0, cols) int64 tensors in [0, p).

    x0:   (n_pad,) walk init x0 = a[:,n-1] - rowsum/2 in Z_p (inv2 =
          (p+1)/2), pad rows 1 (multiplicative identity);
    cols: (n-1, n_pad) residue columns, column k in row k, pad 0.
    """
    n = am.shape[0]
    inv2 = (p + 1) // 2
    rs = am.sum(axis=1) % p
    x0 = np.ones(n_pad, dtype=np.int64)
    x0[:n] = (am[:, n - 1] + (p - rs) * inv2) % p
    cols = np.zeros((n - 1, n_pad), dtype=np.int64)
    cols[:, :n] = am[:, : n - 1].T
    return torch.from_numpy(x0), torch.from_numpy(cols)


def pack_glynn_mod(am: np.ndarray, p: int, n_pad: int):
    """Host pack for the GLYNN identity on the unchanged walk kernel.

    The walk computes x += s*c with s = +1 when the gray bit flips to 1.
    Glynn's recursion over delta vectors (delta_0 = +1 fixed, bit k set
    meaning delta_{k+1} = -1) is y_j -= 2 a_{k+1,j} at a 0->1 flip --
    i.e. the SAME step applied to init y0 = all-(+1) column sums and
    columns carrying the NEGATED doubled rows c_k = (-2 a_{k+1,:}) mod p.
    Only this packing and the final 2^(1-n) scale differ.
    """
    n = am.shape[0]
    y0 = np.ones(n_pad, dtype=np.int64)
    y0[:n] = am.sum(axis=0) % p
    cols = np.zeros((n - 1, n_pad), dtype=np.int64)
    cols[:, :n] = (p - (2 * am[1:, :]) % p) % p      # (n-1, n) in [0, p)
    return torch.from_numpy(y0), torch.from_numpy(cols)


# ------------------------------------------------------------ the walks

def _walk_sum(x0, cols, p: int, device: torch.device, n: int, ids=None,
              r=None) -> int:
    """Sum over the walked chunks of the kernel's residues, mod p.  The
    host sums in int64, exact because chunks * p < 2^63; span
    `exact_walk`."""
    from .ryser import _sm_count
    with trace.timer("exact_walk"):
        sms = _sm_count(device)
        if r is None:
            r = gray.make_plan(n, sms=sms).r
        if ids is None:
            ids_t = torch.arange(1 << max(0, n - 1 - r), dtype=torch.int64,
                                 device=device)
        else:
            ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64),
                                    device=device)
            # a pruned plan may leave fewer chunks than the card has
            # thread slots: split them into aligned sub-chunks
            ids_t, r = gray.split_chunks(ids_t, r,
                                         sms * gray.RESIDENT_CHUNKS_PER_SM)
        if ids_t.numel() >= 1 << 32:
            raise ValueError(f"{ids_t.numel()} chunks: the int64 residue "
                             f"sum needs fewer than 2^32")
        res = modp_cuda.mod_partials(ids_t, x0.to(device), cols.to(device),
                                     p, n=n, r=int(r))
        return int(res.sum()) % p


def perman_core_mod(core, p: int, device: torch.device, ids=None,
                    r=None) -> int:
    """per(core) mod p for a bigint core matrix, walked on `device`.

    ids/r: optional pruned live-chunk plan (ids in [0, 2^(n-1-r))); the
    dense walk covers the full index space at the card planner's r.
    Matches ops/exact.py's _perman_mod_host in Z_p.
    """
    modp_cuda.check_modulus(p)
    n = len(core)
    if n == 0:
        return 1 % p
    if n == 1:
        return int(core[0][0]) % p
    if ids is not None and len(ids) == 0:
        return 0          # every chunk carries a zero row: per == 0
    with trace.timer("exact_pack"):
        am = reduce_core_mod(core, p)
        x0, cols = pack_mod(am, p, gray.pad_n(n))
    acc = _walk_sum(x0, cols, p, device, n, ids, r)
    acc = (2 * acc) % p
    if not (n & 1):
        acc = (-acc) % p
    return acc


def perman_core_glynn_mod(core, p: int, device: torch.device) -> int:
    """per(core) mod p via the GLYNN identity on the same kernel.

    Glynn has no zero-structure pruning (y_j vanishes only by
    cancellation), so the walk is always dense; it serves as a second
    algorithm to check an NW-CRT integer at one fresh prime.
    """
    modp_cuda.check_modulus(p)
    n = len(core)
    if n == 0:
        return 1 % p
    if n == 1:
        return int(core[0][0]) % p
    with trace.timer("exact_pack"):
        am = reduce_core_mod(core, p)
        y0, cols = pack_glynn_mod(am, p, gray.pad_n(n))
    acc = _walk_sum(y0, cols, p, device, n)
    return acc * pow((p + 1) // 2, n - 1, p) % p


# ------------------------------------------------------------- planning

def _doubled_object(core) -> np.ndarray:
    """(n, n) object ndarray of 2*entry -- doubled so the half-integer
    walk values x = a[:,n-1] - rowsum/2 become exact bigints."""
    n = len(core)
    a2 = np.empty((n, n), dtype=object)
    for i, row in enumerate(core):
        for j, v in enumerate(row):
            a2[i, j] = 2 * int(v)
    return a2


def _live_exact(a2: np.ndarray, r: int):
    """Exact-bigint twin of pruning._live_for: live chunk ids at chunk
    length 2**r, with every x_z(base) == 0 test in integer arithmetic.

    pruning.py's f64 zero test is exact for half-integer walks whose
    sums fit the 53-bit mantissa; d2-folded or dyadic-lifted cores can
    exceed that, where a rounded zero test would silently drop NONZERO
    terms -- fatal for an exact engine.  Scoring may approximate; THIS
    mask may not.
    """
    from .pruning import _PAT_SUPPORT_CAP, const_rows, inverse_gray
    n = a2.shape[0]
    m = n - 1 - r
    if m < 1:
        return None
    support = np.vectorize(bool)(a2)
    cr = const_rows(support, r)
    if len(cr) == 0:
        return None
    dead = None
    for z in cr:
        cols = np.nonzero(support[z, : n - 1])[0]
        if len(cols) > _PAT_SUPPORT_CAP:
            continue     # 2^support bigint pattern: skip = under-prune
        x0_2 = a2[z, n - 1] - sum(a2[z]) // 2       # doubled x0, exact
        pat = [x0_2]
        for j in cols:
            v = a2[z, j]
            pat = pat + [pv + v for pv in pat]
        zpat = np.array([pv == 0 for pv in pat], dtype=bool)
        if not zpat.any():
            continue
        if dead is None:
            dead = np.zeros((2,) * m, dtype=bool)
        bits = cols - r
        shape = [1] * m
        for j in bits:
            shape[m - 1 - j] = 2
        dead |= zpat.reshape(shape)
    if dead is None:
        return None
    g_live = np.nonzero(~dead.ravel())[0].astype(np.uint64)
    ids = inverse_gray(g_live, m).astype(np.int64)
    ids.sort()
    return ids


def _score_float(core) -> np.ndarray:
    """Magnitude-clipped f64 image of a bigint core -- for ORDERING and
    cost scoring only (zero pattern preserved; values approximate)."""
    def f(v):
        try:
            x = float(v)
        except OverflowError:
            x = math.inf if v > 0 else -math.inf
        if not np.isfinite(x):
            x = math.copysign(1e300, x)
        return x
    return np.asarray([[f(v) for v in row] for row in core],
                      dtype=np.float64)


def core_fingerprint(core) -> str:
    """Content hash of a bigint core: keys the plan cache and stamps CRT
    checkpoint rows (a stale checkpoint from ANOTHER matrix would pass
    the held-out verifier -- its residues are self-consistent -- so the
    rows must be bound to the exact core they were walked for)."""
    h = hashlib.sha256()
    h.update(str(len(core)).encode())
    for row in core:
        for v in row:
            h.update(b"," + str(int(v)).encode())
        h.update(b";")
    return h.hexdigest()[:16]


#: (fingerprint, giters) -> core_plan result; planning a big core costs
#: seconds of host bigint work, and a repeated run of the same core
#: plans once
_PLAN_CACHE: dict = {}


def core_plan(core, *, giters: float = None, stats: dict = None):
    """Pruned live-chunk plan for a bigint core.

    Plan CHOICE (column order, r) comes from the planner's cost model on
    a float image, priced at the kernel's rate `giters`; the live-id
    mask is then recomputed in exact bigint arithmetic (_live_exact).
    Returns (col_perm, ids, r, live_frac) or None (use the dense index
    space).  Results are cached by core fingerprint; on a miss `stats`,
    a dict, gets the planner's search counts (pruning.plan_sparse).
    """
    from .pruning import plan_sparse
    if giters is None:
        giters = K3_GITERS
    key = (core_fingerprint(core), giters)
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key]
    sp = plan_sparse(_score_float(core), giters=giters, allow_factor=False,
                     stats=stats)
    out = None
    if sp is not None:
        a2 = _doubled_object(core)[:, sp.col_perm]
        ids = _live_exact(a2, sp.r)
        if ids is not None:
            n = len(core)
            live_frac = len(ids) / (1 << (n - 1 - sp.r))
            out = (sp.col_perm, ids, sp.r, live_frac)
    if len(_PLAN_CACHE) >= 16:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = out
    return out


def card_cost_estimate(core, bound_bits: float,
                       device: torch.device) -> float:
    """Rough seconds of the walks of the full CRT run of this core on
    `device`: (31-bit primes for bound_bits, plus the verifier) times the
    live steps of the plan the run would walk, at the Z_p kernel's
    measured rate on a card (K3_GITERS) and the plain version's on the CPU
    (PLAIN_GITERS).  Computes (and caches) the real pruned plan."""
    n = len(core)
    nprimes = max(1, math.ceil(bound_bits / math.log2(PRIME_CEIL))) + 1
    pl_ = core_plan(core)
    live = (1 << max(0, n - 1)) if pl_ is None else (len(pl_[1]) << pl_[2])
    giters = K3_GITERS if device.type == "cuda" else PLAIN_GITERS
    return nprimes * live / (giters * 1e9)


# ------------------------------------------------------------ the driver

def crt_perman_core(core, device: torch.device, *, log=None,
                    checkpoint_path=None, backend: str = "device",
                    threads: int = 0):
    """EXACT ``per(core)`` of a bigint core, CRT over Z_p walks.

    Residues come from `perman_core_mod` at 31-bit primes descending
    from PRIME_CEIL; the live-chunk plan is computed ONCE in exact
    bigint arithmetic and shared by every prime, and a held-out
    verification prime certifies the reconstruction end to end -- a
    kernel or CRT bug cannot return silently.  Returns ``(per, meta)``.

    backend="native" runs the same plan, CRT, verifier and checkpoint
    with the native CPU engine's Montgomery walks
    (bindings.native.perman_mod_pruned, `threads` threads) at primes
    below 2^61, or below 2^50 on a host with AVX-512 IFMA, where every
    walk runs on its 8-lane path (bindings.native.cpu_ifma), as the JAX
    package's backend="native" does.

    checkpoint_path: optional JSONL of ``{"p": .., "res": .., "fp": ..}``
    rows -- per-prime residues survive a crash mid-run, and a restarted
    run recomputes only the missing primes.  Every row is stamped with
    the core's fingerprint and rows for a DIFFERENT core are ignored on
    load: a stale checkpoint would otherwise pass the held-out verifier
    (its residues are mutually consistent with the OLD core) and return
    the wrong matrix's permanent as certified-exact.
    """
    from .exact import _PRIME_CEIL, _is_prime_u64, _log2_bound
    t0 = time.perf_counter()
    with trace.timer("exact_plan"):
        n = len(core)
        fp = core_fingerprint(core)
        bits = _log2_bound(core) + 3
        if backend == "native":
            from ..bindings.native import cpu_ifma
            engine = "native_mod_crt"
            ceil_p = ((1 << 50) - 1) if cpu_ifma() else _PRIME_CEIL
        elif backend == "device":
            engine = "cuda_mod" if device.type == "cuda" else "plain_mod"
            ceil_p = PRIME_CEIL
        else:
            raise ValueError(f"unknown backend {backend!r}")
        need_primes, cov, c = [], 0.0, ceil_p
        while cov < bits or not need_primes:
            while not _is_prime_u64(c):
                c -= 2
            need_primes.append(c)
            cov += math.log2(c)
            c -= 2
        while not _is_prime_u64(c):
            c -= 2
        verifier = c
        known = {}
        if checkpoint_path and os.path.exists(checkpoint_path):
            stale = 0
            with open(checkpoint_path) as f:
                for line in f:
                    row = json.loads(line)
                    if row.get("fp") == fp:
                        known[int(row["p"])] = int(row["res"])
                    else:
                        stale += 1
            if stale and log:
                log(f"{engine}: ignoring {stale} checkpoint rows from a "
                    f"different core (fingerprint mismatch)")
        search = {}
        plan = core_plan(core, stats=search)
        if plan is not None:
            col_perm, ids, r, live_frac = plan
            work = [[core[i][j] for j in col_perm] for i in range(n)]
        else:
            work, ids, r, live_frac = core, None, None, 1.0
    if backend == "native":
        from ..bindings.native import perman_mod_batch, perman_mod_pruned

        def residue(p):
            am = np.asarray([[int(v) % p for v in row] for row in work],
                            dtype=np.uint64)
            if ids is not None:
                return perman_mod_pruned(am, p, ids, r, threads)
            if n >= 10:
                # the dense index space as 64 chunks: the chunked walk
                # runs on the IFMA lanes and over the host's threads, the
                # one-shot batch walk does neither
                return perman_mod_pruned(am, p, np.arange(64, dtype=np.int64),
                                         n - 1 - 6, threads)
            return int(perman_mod_batch(am[None], np.asarray([p], np.uint64),
                                        threads)[0])
    else:
        def residue(p):
            return perman_core_mod(work, p, device, ids=ids, r=r)
    residues = []
    for i, p in enumerate(need_primes + [verifier]):
        if p in known:
            residues.append(known[p])
            continue
        residues.append(residue(p))
        if checkpoint_path:
            with open(checkpoint_path, "a") as f:
                f.write(json.dumps({"p": p, "res": residues[-1],
                                    "fp": fp}) + "\n")
        if log:
            log(f"{engine}: prime {i + 1}/{len(need_primes) + 1} "
                f"(p={p}) done at {time.perf_counter() - t0:.1f}s")
    with trace.timer("exact_crt"):
        X, P = 0, 1
        for rr, p in zip(residues[:-1], need_primes):
            t = (rr - X) * pow(P, -1, p) % p
            X += P * t
            P *= p
        if X > P // 2:
            X -= P
        if X % verifier != residues[-1]:
            raise AssertionError(
                f"{engine} CRT verification prime mismatch -- modular walk "
                f"or reconstruction is broken")
        meta = {"engine": engine, "nprimes": len(need_primes),
                "bound_bits": round(bits, 1), "live_frac": live_frac,
                "r": r, "wall_s": time.perf_counter() - t0}
        if search:
            meta["plan_search"] = search
    return X, meta
