"""Exact-permanent engine: planning, dispatch, reduction (dense and
sparse, tiers df64, f32, f32k, tf96 and f64; quad on the host), and the
amplitude walk that prices those tiers for calc="auto".

Port of ``superman_tpu/ops/ryser.py``.  The host side (row scales,
sparse plan, pack, underflow retry, sign and 2^E) is the reference's; the
walk is the CUDA kernel of ops/ryser_cuda.py, or its plain version when
the device is the CPU, on one device or dealt over a mesh
(parallel/sharding.py), through the hybrid scheduler with the native CPU
engine beside the card (parallel/scheduler.py), and split over several
processes (parallel/multihost.py).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.matrix import DenseMatrix
from ..core.result import Result
from ..utils import trace
from . import gray
from .scaled_walk import (empty_line, exact_f32, line_exponents,
                          retry_scaled)


def _exact_storage(dense: DenseMatrix) -> bool:
    """True when matrix values and the half-integer x walk are exact in f32
    (the int suites): f32 updates are then error-free.

    Decided on the VALUES, not the declared storage class: a float64
    matrix holding small integers walks identically to an "int"-typed one.
    The port's df64 walk keeps x in float64 and its f32 tiers round the
    pack to float32 either way, so for them the flag is only reported in
    Result.meta.  The tf96 tier reads it: its double-double products are
    worth their cost only on x updates that are exact, so calc="tf96" on
    other storage falls back to df64 with a warning."""
    a = np.asarray(dense.mat)
    if a.dtype == np.longdouble:
        return False                  # -v storage keeps long-double bits
    return bool(exact_f32(a, declared_int=dense.type == "int"))


def _row_scales(a: np.ndarray) -> np.ndarray:
    """Integer exponents s_j so that scaling row j by 2**-s_j bounds every
    |x_j| by ~1 along the whole walk (|x_j| <= |a[j,n-1]| + abs-rowsum/2).

    Power-of-two scaling is EXACT in binary floating point, so the walk
    keeps its exactness guarantees while every intermediate tree product
    stays <= 1 in magnitude — overflow becomes impossible.
    The permanent is recovered as result * 2**sum(s).  On a (B, n, n)
    stack, the (B, n) exponents of every matrix.
    """
    ab = np.abs(np.asarray(a, dtype=np.float64))
    return line_exponents(ab[..., -1] + ab.sum(axis=-1) / 2)


#: the probe's runs by path: "masks" where the draws came from the block of
#: words, "plain" where the block ran short and the plain loop ran.  Tests
#: read it to show which path ran
ESTIMATE_PATHS: collections.Counter = collections.Counter()

#: words drawn beyond one a (trial, row) draw, for Lemire's rejections
#: (each below c / 2^32 a draw); the plain loop runs if they run out
_ESTIMATE_SLACK = 16


def _log2_perm_estimate_plain(a: np.ndarray, trials: int = 6,
                              seed: int = 12345):
    """The probe as the reference writes it: a numpy mask, a scalar draw
    and two scalar log2s a row.  _log2_perm_estimate's fallback, and the
    oracle its tests hold it to."""
    ab = np.abs(np.asarray(a, dtype=np.float64))
    n = ab.shape[0]
    rng = np.random.default_rng(seed)
    # process rows sparsest-first: fewer dead ends, lower variance
    order = np.argsort((ab > 0).sum(axis=1), kind="stable")
    ests = []
    for _ in range(trials):
        used = np.zeros(n, dtype=bool)
        lg = 0.0
        for i in order:
            nz = np.nonzero((ab[i] > 0) & ~used)[0]
            if len(nz) == 0:
                lg = None
                break
            j = nz[rng.integers(len(nz))]
            lg += np.log2(len(nz)) + np.log2(ab[i, j])
            used[j] = True
        if lg is not None:
            ests.append(lg)
    return float(np.median(ests)) if ests else None


def _log2_perm_estimate(a: np.ndarray, trials: int = 6,
                        seed: int = 12345):
    """Crude host-side log2 |permanent| magnitude probe (Rasmussen's
    estimator in log space over |A|, reference algo.h:171 repurposed):
    a few n^2 greedy passes, median of the per-trial log estimates.

    Only used to CENTER the power-of-two row scaling so the scaled Gray
    total lands near 2^-12 on the first attempt: without it, matrices
    whose permanent is far below the row-scale bound need 1-2 full
    underflow-retry relaunches — each a complete engine pass.  A wrong
    estimate costs only a retry.  Returns None when every trial dies
    (permanent likely 0).

    The same float, bit for bit, as _log2_perm_estimate_plain: rows are
    int bit masks, log2 comes from tables made once by np.log2 itself,
    and the draws apply numpy's own bounded rule for integers(c) (one
    32-bit word w, Lemire's: w * c, redrawn while its low half is below
    (2^32 - c) % c, the pick its high half; no word where c == 1) to one
    block of words drawn from the same generator, the same word stream.
    Where the block runs short the plain loop runs instead.
    """
    ab = np.abs(np.asarray(a, dtype=np.float64))
    n = ab.shape[0]
    support = ab > 0
    # process rows sparsest-first: fewer dead ends, lower variance
    order = np.argsort(support.sum(axis=1), kind="stable").tolist()
    packed = np.packbits(support, axis=1, bitorder="little")
    masks = [int.from_bytes(row.tobytes(), "little") for row in packed]
    with np.errstate(divide="ignore"):
        log2_a = np.log2(ab).tolist()
    log2_count = [0.0, *np.log2(np.arange(1, n + 1)).tolist()]
    words = np.random.default_rng(seed).integers(
        0, 2 ** 32, size=trials * n + _ESTIMATE_SLACK,
        dtype=np.uint32).tolist()
    w = 0
    ests = []
    for _ in range(trials):
        used = 0
        lg = 0.0
        for i in order:
            avail = masks[i] & ~used
            c = avail.bit_count()
            if c == 0:
                lg = None
                break
            k = 0
            if c > 1:
                threshold = (2 ** 32 - c) % c
                while True:
                    if w == len(words):
                        ESTIMATE_PATHS["plain"] += 1
                        return _log2_perm_estimate_plain(a, trials, seed)
                    m = words[w] * c
                    w += 1
                    if (m & 0xFFFFFFFF) >= threshold:
                        break
                k = m >> 32
            # avail's k-th set bit, lowest first: np.nonzero's k-th index
            for _ in range(k):
                avail &= avail - 1
            j = (avail & -avail).bit_length() - 1
            lg += log2_count[c] + log2_a[i][j]
            used |= 1 << j
        if lg is not None:
            ests.append(lg)
    ESTIMATE_PATHS["masks"] += 1
    return float(np.median(ests)) if ests else None


def _center_scales(a: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Shift the per-row scales so the first attempt's scaled total is
    near 2^-12 instead of underflow-retrying its way there.  The shift
    is capped at 2^60 total term growth (the retry loop's non-finite
    fallback still guards mis-estimates)."""
    est = _log2_perm_estimate(a)
    if est is None or not np.isfinite(est):
        return scales
    n = a.shape[0]
    delta = min(60, max(0, int(scales.sum()) - (int(est) + 12)))
    if delta <= 0:
        return scales
    scales = scales.copy()
    per_row, rem = divmod(delta, n)
    scales -= per_row
    if rem:
        scales[:rem] -= 1
    return scales


#: K1's rate per tier in G Gray steps per second, what the sparse planner
#: prices a step at: 2^31 steps of the n=32 full plan in 14.4 ms (df64),
#: 8.1 (f32), 8.8 (f32k) and 34.3 (tf96), kernel alone by CUDA events
#: (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, PERF.md).  The grouped
#: walk runs faster (10.3, 5.2, 5.7 and 24.8 ms); these figures stay until
#: a measured change of the plans they choose (PERF.md section 7)
K1_GITERS = {"df64": 148.0, "f32": 265.0, "f32k": 244.0, "tf96": 62.6}


def amp_cond_walk_log2(a: np.ndarray, device: torch.device) -> tuple:
    """EXACT log2 of (amp, cond): the Ryser cancellation amplitude
    sum_m |prod_i x_i(m)| and its WITHIN-LINE conditioned companion
    sum_m sum_i S_i * prod_{j!=i} |x_j(m)| over the full 2^(n-1) walk
    (S_i = row i's x-amplitude bound, the per-row error carrier scale).

    Every fixed-precision walk tier's ACCUMULATION error is
    ~amp * 2^-mantissa; its x-UPDATE error (absent only on exact-f32
    integer storage) is ~cond * 2^-mantissa_x: a line passing near zero
    mid-walk divides its carried error by |x_i|, which the plain
    amplitude cannot see.  The sampled probe
    (drivers/runner._amp_probe_log2) additionally underestimates
    heavy-tailed term distributions by 50+ bits; this walk runs the
    conditioned variant of the walk kernel's amp tier
    (ops/ryser_cuda.ryser_amp, cond=True) over every chunk.

    Returns (log2 amp, log2 cond); (-inf, -inf) for a structurally zero
    walk, (+inf, +inf) when the measurement could not be stabilized
    (callers treat as worst case).  Per-line condition saturates at
    2^45 on the kernel path (ryser_cuda.AMP_EPS) and 2^50 on the host
    path, both far past any float tier's escape hatch (a bound >= 2^-3
    relative already reads "no correct digits").
    """
    return _amp_walk_log2(a, device, cond=True)


def amp_walk_log2(a: np.ndarray, device: torch.device) -> float:
    """log2 of the exact Ryser amplitude alone (see amp_cond_walk_log2):
    the amplitude-only variant of the amp tier, which skips the
    conditioned term."""
    return _amp_walk_log2(a, device, cond=False)[0]


def _amp_walk_log2(a: np.ndarray, device: torch.device, cond: bool) -> tuple:
    """(log2 amp, log2 cond) as amp_cond_walk_log2 gives them; without
    cond, (log2 amp, None)."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n == 0 or not np.all(np.any(a != 0, axis=1)):
        # empty row: every x_i(m) = 0
        return float("-inf"), float("-inf") if cond else None
    if n < 19:
        # host-exact: the full index space is tiny; same math as the
        # sampled probe but exhaustive (and in log space, no overflow)
        x0 = a[:, -1] - a.sum(axis=1) / 2.0
        cols = a[:, : n - 1]
        S = np.abs(x0) + np.abs(cols).sum(axis=1)    # row amplitude
        m = np.arange(1 << (n - 1), dtype=np.uint64)
        g = m ^ (m >> np.uint64(1))
        bits = ((g[:, None] >> np.arange(n - 1, dtype=np.uint64))
                & np.uint64(1)).astype(np.float64)
        x = x0[None, :] + bits @ cols.T
        ax = np.abs(x)
        with np.errstate(divide="ignore"):
            logt = np.where(np.all(ax != 0, axis=1),
                            np.log2(ax).sum(axis=1), -np.inf)

        def _lse2(v):
            fin = v[np.isfinite(v)]
            if fin.size == 0:
                return float("-inf")
            mx = float(fin.max())
            return mx + float(np.log2(np.exp2(fin - mx).sum()))

        if not cond:
            return _lse2(logt), None
        axc = np.maximum(ax, S[None, :] * 2.0 ** -50)
        logc = (np.log2(axc).sum(axis=1)
                + np.log2((S[None, :] / axc).sum(axis=1)))
        return _lse2(logt), _lse2(logc)
    from ..parallel.sharding import compute_amp
    plan = gray.make_plan(n, sms=_sm_count(device))
    ids_blocks = np.arange(plan.num_chunks, dtype=np.int64)[None, :]
    # The kernel's conditioned accumulator assumes every scaled row has
    # amplitude ~1 (its effective S_i is 2^scale_i), so any centering or
    # retry shift must be UNIFORM across rows: a per-row adjustment would
    # silently shrink the S_i weights.  The uniform offset c is added
    # back to the cond recovery below.
    s_raw = _row_scales(a)
    cs = _center_scales(a, s_raw)
    c0 = int(np.ceil(np.mean(s_raw - cs)))   # uniform centering amount
    shift = 0
    for _ in range(4):
        c = c0 + shift
        scales = s_raw - c
        a_s = np.ldexp(a, -scales[:, None])
        x0, cols = gray.pack_matrix(a_s, plan.n_pad)
        partials = compute_amp(ids_blocks, x0, cols, plan, device, cond)
        total = float(partials[0].sum(dtype=np.float64))
        cw = float(partials[1].sum(dtype=np.float64)) if cond else 0.0
        if np.isfinite(total) and total > 0.0 and np.isfinite(cw):
            # row scaling is exact powers of two; the amplitude recovers
            # by 2^sum(scales), the conditioned total by an extra 2^c
            # (each row's true amplitude weight is 2^s_raw_i = 2^c times
            # the kernel's unit assumption)
            ssum = int(scales.sum())
            return (float(np.log2(total) + ssum),
                    float(np.log2(cw) + ssum + c) if cond else None)
        if total == 0.0:
            shift += max(1, 64 // n)    # underflow: grow the terms
        else:
            shift -= max(1, 64 // n)    # overflow: shrink the terms
    return float("inf"), float("inf") if cond else None


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return gray.DEFAULT_SMS


def ryser_exact(dense: DenseMatrix, flags, device: torch.device,
                chunk_ids: Optional[np.ndarray] = None, mesh=None) -> Result:
    """Exact permanent of `dense` on `device`, calc "df64", "f32",
    "f32k", "tf96" or "f64"; calc "quad" walks on the host in long
    double whatever the device (single-threaded, practical up to
    n ~ 24).

    chunk_ids: optional pruned live-chunk list at the dense plan's chunk
    length (pruned chunks contribute exactly zero, so no correction term
    exists).  Without it the engine prunes by itself under flags.sparse,
    and on clearly sparse matrices (n >= 28, density < 0.30) unless
    flags.skip_pruning is False.

    mesh: a parallel.mesh.Mesh to deal the walk's blocks over (the result
    is bitwise the single-device one; meta["mesh_cards"] gives each
    entry's block rows and walk ms, and the deal's spans stand in for
    `walk`: parallel/sharding.py), or None.  flags.hybrid or
    flags.checkpoint_path route the walk through the hybrid scheduler
    (the CPU worker joins under flags.cpu); the tf96 tier and factored
    rows fall back there, as in the reference.
    """
    a = np.asarray(dense.mat)
    calc = flags.resolved_calc()
    if calc not in ("df64", "f32", "f32k", "tf96", "f64", "quad"):
        raise ValueError(f"ryser_exact has no {calc!r} tier")
    t0 = time.perf_counter()
    res = _host_route(a, calc, device, t0)
    if res is not None:
        return res
    kp = _kernel_plan(dense, a, calc, flags, device, chunk_ids, mesh, t0)
    if isinstance(kp, Result):
        return kp

    from ..parallel.multihost import combine_host_totals, host_slice
    from ..parallel.sharding import (compute_total, mesh_cards, total_words,
                                     walk_span)
    n, plan, nprocs = a.shape[0], kp.plan, kp.procs[1]
    # the deal's spans and per-entry counters stand in for `walk` where one
    # process deals the walk itself; the scheduler's device worker and
    # several processes keep `walk`
    cards = mesh_cards(mesh) if not kp.scheduler and nprocs == 1 else None
    hybrid = []                 # the hybrid scheduler's stats, once it ran

    def walk(a_s):
        factors, a_pack = None, a_s
        with trace.timer("pack"):
            if kp.factor_rows is not None:
                # factored constant rows: the kernel walks only
                # alive_rows and weights each chunk by the product of the
                # factored rows, which it rebuilds from this small pack;
                # both packs come from the matrix as this attempt scales it
                factors = gray.pack_matrix(a_s[kp.factor_rows],
                                           len(kp.factor_rows))
                a_pack = a_s[kp.alive_rows]
            elif kp.reduced:
                factors = (np.empty(0), np.empty((n - 1, 0)))
            x0, cols = gray.pack_matrix(a_pack, plan.n_pad)
        with walk_span(cards):
            if kp.scheduler:
                from ..parallel.scheduler import compute_partials_hybrid
                total, stats = compute_partials_hybrid(
                    a_s, host_slice(kp.ids_blocks, *kp.procs), x0,
                    cols, plan, device, tier=kp.calc, mesh=mesh,
                    threads=flags.threads, cpu_helper=flags.cpu,
                    checkpoint_path=flags.checkpoint_path)
                hybrid[:] = [stats]
            else:
                # a float; np.longdouble for tf96, kept until the last
                # rounding
                total = compute_total(
                    x0, cols, plan, device, tier=kp.calc,
                    sparse=None if factors is None else (kp.chunk_ids,
                                                         *factors),
                    sms=kp.sms, mesh=mesh, host=kp.procs, cards=cards)
            if nprocs > 1:
                # one (hi, lo) pair a process; also keeps the underflow
                # retry's decision below the same in every process
                total = combine_host_totals(total)
        return total

    with trace.timer("scales"):
        a64 = kp.a.astype(np.float64)
        scales = _center_scales(kp.a, _row_scales(kp.a))
    total, E = retry_scaled(a64, scales, -1, walk)
    # ldexp multiplies by 2**E exactly; out-of-range RESULTS become the
    # honest double inf/0 rather than raising
    with np.errstate(over="ignore"):
        acc = np.longdouble(total) if kp.calc == "tf96" else np.float64(total)
        p = float((4 * (n & 1) - 2) * np.ldexp(acc, E)) + 0.0
    dt = time.perf_counter() - t0
    iters = kp.live << plan.r
    meta = {"calc": kp.calc, "chunks": kp.live, "r": plan.r,
            "lanes": plan.lanes, "scale_log2": E,
            "iters_per_sec": iters / dt, "device": str(device),
            "exact_storage": kp.exact_storage,
            "mesh": None if mesh is None else len(mesh)}
    if cards is not None:
        # each entry's block rows and walk ms over the attempts
        meta["mesh_cards"] = cards
    if nprocs > 1:
        meta["processes"] = nprocs
    if not kp.scheduler:
        # the (hi, lo) pairs the host summed an attempt
        meta["walk_words"] = total_words(plan, kp.calc, kp.live if
                                         kp.reduced else None, kp.sms,
                                         kp.procs)
    if kp.reduced:
        # the walked list: each live chunk cut into 2^split_log2 pieces
        meta["split_log2"] = gray.split_shift(
            kp.live, plan.r, kp.sms * gray.SPLIT_CHUNKS_PER_SM)
    if kp.sparse_meta is not None:
        meta["sparse"] = kp.sparse_meta
    if kp.search is not None:
        meta["sparse_search"] = kp.search
    name = kp.name
    if hybrid:
        stats, = hybrid
        name = name.replace("ryser_", "ryser_hybrid_", 1)
        meta["hybrid"] = {
            "units": stats.units_total,
            "device": stats.units_device,
            "cpu": stats.units_cpu,
            "resumed": stats.units_resumed,
            "retries": stats.retries,
            "handoffs": stats.handoffs}
    return Result(p, dt, algo_name=name, iterations=iters, meta=meta)


def _host_route(a: np.ndarray, calc: str, device: torch.device,
                t0: float) -> Optional[Result]:
    """ryser_exact's routes that walk no kernel: orders 1-2, the host
    long-double walk (quad, and tf96 below n=19) and the lane walk (f64,
    and any tier below n=19); None where the kernel path walks."""
    n = a.shape[0]
    if n <= 2:
        from .ryser_walk import brute_scaled
        return Result(brute_scaled(a), time.perf_counter() - t0,
                      algo_name="ryser_exact", iterations=1)

    if calc == "quad" or (calc == "tf96" and n < 19):
        # quad: the host long-double walk, as the JAX package serves it
        # without its native library (single-threaded host work,
        # practical up to n ~ 24).  Small-n tf96 lands here too: the walk
        # meets the tier's contract, the float64 walk below would quietly
        # degrade it.  The rows are scaled as the lane walks scale them
        # (the reference walks them as given, ryser.py:257-266: NaN where
        # a product overflows, -0.0 where all underflow), and 2^E is
        # applied to the long-double total before it is rounded
        from .oracle import perman64
        from .ryser_walk import times_pow2, walk_scales
        s = walk_scales(a)
        total = perman64(np.ldexp(a, -s[:, None]), dtype=np.longdouble)
        return Result(float(times_pow2(total, int(s.sum()))),
                      time.perf_counter() - t0,
                      algo_name=f"ryser_{calc}_host",
                      iterations=1 << (n - 1), meta={"calc": calc})

    if calc == "f64" or n < 19:
        from .ryser_walk import ryser_walk
        # the small-n route walks float32 for calc="f32" only
        p, walk = ryser_walk(
            a, device, torch.float32 if calc == "f32" else torch.float64)
        return Result(p, time.perf_counter() - t0,
                      algo_name=f"ryser_walk_{calc}",
                      iterations=1 << (n - 1),
                      meta={"calc": calc, "device": str(device),
                            "lane_walk": walk})
    return None


@dataclasses.dataclass
class _KernelPlan:
    """What ryser_exact's kernel path walks: the matrix `a` (its columns
    in the sparse planner's order), the tier, the plan, the list of live
    chunk ids (None: every chunk), the factored and alive rows (None: no
    row factored), and which walk runs (the hybrid scheduler's, the
    reduced walk of a pruned list, or the dense walk)."""
    a: np.ndarray
    calc: str
    name: str                       # the Result's algo_name
    exact_storage: bool
    plan: gray.RyserPlan
    chunk_ids: Optional[np.ndarray]
    live: int                       # the chunks walked
    factor_rows: Optional[np.ndarray]
    alive_rows: Optional[np.ndarray]
    scheduler: bool
    sms: int
    procs: tuple                    # (this process's index, processes)
    ids_blocks: Optional[np.ndarray]    # the scheduler's (B, L) ids
    sparse_meta: Optional[dict]
    search: Optional[dict]          # the planner's counts, where it ran

    @property
    def reduced(self) -> bool:
        return self.chunk_ids is not None and not self.scheduler


def _kernel_plan(dense: DenseMatrix, a: np.ndarray, calc: str, flags,
                 device: torch.device, chunk_ids: Optional[np.ndarray],
                 mesh, t0: float):
    """The kernel path's checks and plan, up to the row scales, in two
    spans on either side of the sparse planner's: a _KernelPlan, or the
    Result of a matrix whose permanent is 0 on its face (an empty row or
    column, every chunk pruned)."""
    n = a.shape[0]
    with trace.timer("engine_plan"):
        exact_storage = _exact_storage(dense)
        # the hybrid scheduler (and a checkpoint journal, which routes
        # through it even without the CPU worker) journals float64 unit
        # sums of the unweighted walk: no tf96, no factored rows
        scheduler = bool(flags.hybrid or flags.checkpoint_path)
        if calc == "tf96" and (not exact_storage or scheduler):
            # tf96 needs x updates that are exact in f32 (the int suites)
            # and the long-double reduction
            import warnings
            warnings.warn("tf96 requires exact-f32 storage and the "
                          "non-hybrid path; falling back to df64")
            calc = "df64"

        # the kernel on a card, its plain version on the CPU
        name = (f"ryser_{'cuda' if device.type == 'cuda' else 'plain'}"
                f"_{calc}")
        # trivial zero: an empty row or column makes the permanent 0 and
        # also breaks the row-scaling heuristic, so dispose of it here
        if empty_line(a):
            return Result(0.0, time.perf_counter() - t0, algo_name=name,
                          iterations=0, meta={"reason": "empty row/col"})

        from ..parallel.mesh import process_info
        from ..parallel.sharding import pad_ids
        sms = _sm_count(device)
        # several processes: each walks its interleaved share of the
        # blocks and the totals are combined (parallel/multihost.py)
        proc_index, nprocs = process_info()
        # auto-sparse: on clearly sparse inputs the pruned engine engages
        # even without flags.sparse (the planner declines when
        # unprofitable, and its candidate evaluation costs tens of
        # milliseconds of host time, only worth it from n = 28).
        # skip_pruning=False forces the pure dense walk.
        density = np.count_nonzero(a) / max(1, a.size)
        auto_sparse = n >= 28 and density < 0.30
    sp = search = None
    if chunk_ids is None and (flags.sparse or auto_sparse) \
            and flags.skip_pruning:
        from .pruning import plan_sparse
        search = {}
        with trace.timer("sparse_plan"):
            sp = plan_sparse(a, chunk_log2=flags.chunk_log2,
                             giters=K1_GITERS[calc],
                             allow_factor=not scheduler, stats=search)
    plan = factor_rows = alive_rows = sparse_meta = ids_blocks = None
    with trace.timer("engine_plan"):
        if sp is not None:
            a = np.ascontiguousarray(a[:, sp.col_perm])
            chunk_ids = sp.ids
            if len(sp.factor_rows):
                factor_rows, alive_rows = sp.factor_rows, sp.alive_rows
            n_pad = (gray.pad_n(len(sp.alive_rows))
                     if factor_rows is not None else gray.pad_n(n))
            nchunks = 1 << (n - 1 - sp.r)
            plan = gray.RyserPlan(n=n, n_pad=n_pad, r=sp.r,
                                  lanes=min(flags.lanes or 1024, 512 if
                                            calc in ("df64", "tf96")
                                            else 1024, nchunks),
                                  num_chunks=nchunks)
            sparse_meta = {"dead_frac": round(sp.dead_frac, 4),
                           "factored_rows": len(sp.factor_rows),
                           "r": sp.r}
        if plan is None:
            plan = gray.make_plan(n, flags.lanes, flags.chunk_log2,
                                  sms=sms,
                                  grid_multip=int(flags.grid_multip),
                                  min_blocks=32 if scheduler else 1)
        # a pruned list goes through the weighted, block-reduced walk,
        # which masks its own sentinels; the dense walk makes its ids on
        # the card; the scheduler keeps per-chunk partials of real ids,
        # on the pruned list too
        if chunk_ids is not None:
            chunk_ids = np.asarray(chunk_ids, dtype=np.int64)
            live = len(chunk_ids)
            if live == 0:
                meta = {"reason": "all chunks pruned"}
                if search is not None:
                    meta["sparse_search"] = search
                return Result(0.0, time.perf_counter() - t0,
                              algo_name=name, iterations=0, meta=meta)
        else:
            live = plan.num_chunks
        if scheduler:
            ids_blocks = pad_ids(chunk_ids if chunk_ids is not None
                                 else np.arange(live, dtype=np.int64),
                                 plan.lanes)
        trace.log(f"plan: n={n} n_pad={plan.n_pad} r={plan.r} "
                  f"lanes={plan.lanes} chunks={live}/{plan.num_chunks} "
                  f"calc={calc} device={device} "
                  f"shards={1 if mesh is None else len(mesh)} "
                  f"processes={nprocs}", level=2)
    return _KernelPlan(a, calc, name, exact_storage, plan, chunk_ids, live,
                       factor_rows, alive_rows, scheduler, sms,
                       (proc_index, nprocs), ids_blocks, sparse_meta, search)

