"""The port's sparse engine against the JAX package: the planner's copied
numpy code, the chunk weights, the weighted per-chunk partials of the
factored walk, its block reduction, and permanent(sparse=True) as a whole.

Inputs come from seeded numpy generators.  The port runs on the CPU
(device="cpu", the kernels' plain versions), the JAX package as its own
tests run it (Pallas in interpret mode).  Both packages walk ONE plan:
the reference's SparsePlan and packs are handed to the port through
pruning.plan_from_jax and gray.from_jax_pack.
"""

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu.core.matrix import DenseMatrix as JDense
from superman_tpu.ops import gray as jgray
from superman_tpu.ops import pruning as jpruning
from superman_tpu.ops.oracle import perman_brute
from superman_tpu.ops.ryser import colst_pack
from superman_tpu.parallel import sharding as jsharding
from superman_tpu.prep import orderings as jorderings
from superman_tpu_torch.core.flags import Flags
from superman_tpu_torch.core.matrix import DenseMatrix
from superman_tpu_torch.ops import (exact, gray, modp, pruning, ryser,
                                    ryser_cuda, tf96)
from superman_tpu_torch.parallel import sharding
from superman_tpu_torch.prep import orderings
from superman_tpu_torch.tools.corpus import suite_matrix

#: reference tier switches of compute_partials
TIER_KW = {"df64": dict(df=True), "f32k": dict(df=False, kahan=True),
           "tf96": dict(df=False, tf=True), "f32": dict(df=False)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores and slows the walks tenfold
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def sparse_matrix(n, density, seed, vmax=4):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density) * rng.integers(1, vmax + 1, (n, n))
    np.fill_diagonal(a, rng.integers(1, vmax, n))
    return a


def binary_matrix(n, density, seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.int64)
    np.fill_diagonal(a, 1)
    return a


def t64(v):
    return torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float64)


# ------------------------------------------------- the copied numpy code

@pytest.mark.parametrize("n,density,seed,r", [
    (20, 0.25, 0, 12), (21, 0.25, 1, 13), (22, 0.2, 2, 14), (23, 0.25, 3, 15),
    (20, 0.5, 4, 10), (24, 0.15, 5, 9)])
def test_live_chunks_equal_reference(n, density, seed, r):
    """live_chunks is copied numpy: the same ids (or None) as the
    reference's, with r given, with chunk_log2 in the flags and by its
    short-chunk default."""
    a = sparse_matrix(n, density, seed)
    a = a[:, jpruning.plan_sparse(a, chunk_log2=r, df=True).col_perm] \
        if jpruning.plan_sparse(a, chunk_log2=r, df=True) else a
    for kw_port, kw_ref in (
            (dict(r=r), dict(r=r)),
            (dict(flags=Flags(chunk_log2=r)),
             dict(flags=sp.Flags(chunk_log2=r))),
            (dict(flags=Flags()), dict(flags=sp.Flags()))):
        got = pruning.live_chunks(DenseMatrix(a, "int"), **kw_port)
        want = jpruning.live_chunks(JDense(a, "int"), **kw_ref)
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_live_chunks_small_order_is_none():
    a = sparse_matrix(18, 0.2, 0)
    assert pruning.live_chunks(DenseMatrix(a, "int"), r=8) is None
    assert jpruning.live_chunks(JDense(a, "int"), r=8) is None


@pytest.mark.parametrize("dtype", [np.float64, np.longdouble])
@pytest.mark.parametrize("n,density,seed,r", [(20, 0.2, 11, 9),
                                              (22, 0.2, 12, 10),
                                              (24, 0.15, 13, 8)])
def test_chunk_factors_equal_reference(n, density, seed, r, dtype):
    """chunk_factors is copied numpy: bit-for-bit the reference's in
    float64 and in long double, with sentinel ids weighted 0."""
    a = sparse_matrix(n, density, seed).astype(np.float64)
    a = np.ldexp(a, -ryser._row_scales(a)[:, None])
    cr = pruning.const_rows(a, r)
    assert len(cr)
    ids = np.concatenate([np.arange(1 << (n - 1 - r)), [-1, -1]])
    got = pruning.chunk_factors(a, cr, ids, r, dtype=dtype)
    want = jpruning.chunk_factors(a, cr, ids, r, dtype=dtype)
    assert got.dtype == want.dtype == np.dtype(dtype)
    assert np.array_equal(got, want)
    assert got[-1] == 0 and got[-2] == 0 and np.any(got != 0)


@pytest.mark.parametrize("n,density,seed,chunk_log2", [
    (20, 0.2, 0, 6), (22, 0.2, 1, 8), (24, 0.2, 0, 9), (24, 0.15, 1, 6)])
def test_plan_sparse_equal_reference(n, density, seed, chunk_log2):
    """With the chunk length given, the planner's choice does not depend
    on the rates it is priced at: both packages make the same plan, and
    plan_from_jax carries the reference's over field by field."""
    a = sparse_matrix(n, density, seed)
    want = jpruning.plan_sparse(a, chunk_log2=chunk_log2, df=True)
    got = pruning.plan_sparse(a, giters=ryser.K1_GITERS["df64"],
                              chunk_log2=chunk_log2)
    carried = pruning.plan_from_jax(want)
    for plan in (got, carried):
        assert isinstance(plan, pruning.SparsePlan)
        assert plan.r == want.r and plan.dead_frac == want.dead_frac
        assert plan.est_live == want.est_live
        for key in ("col_perm", "ids", "alive_rows", "factor_rows"):
            assert np.array_equal(getattr(plan, key), getattr(want, key)), key


# --------------------------------------------------- the planner's search

def search_matrix(kind):
    """The int suite's n=36 d=0.15 matrices (as permbench draws them), the
    float images of n=30 d=0.50 cores (what calc="exact" plans on),
    quarter-integer, half-thirds and arbitrary float matrices."""
    rng = np.random.default_rng(21)
    if kind.startswith("suite36"):
        return suite_matrix(7, 36, "0.15", int(kind[-1])).astype(np.float64)
    if kind.startswith("core30"):
        m = suite_matrix(7, 30, "0.50", int(kind[-1])).astype(np.float64)
        return modp._score_float(exact._fold_lines(
            exact.dyadic_int_matrix(m)[0])[0])
    quarters = (rng.integers(-8, 9, (28, 28))
                * (rng.random((28, 28)) < 0.25)) / 4.0
    if kind == "dyadic":
        return quarters
    if kind == "thirds":       # every other row off the dyadic grid
        quarters[::2] /= 3.0
        return quarters
    if kind == "float":
        return rng.standard_normal((28, 28)) * (rng.random((28, 28)) < 0.25)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,giters,chunk_log2,allow_factor", [
    ("suite36_0", 10.0, None, True), ("suite36_0", 10.0, None, False),
    ("suite36_1", 10.0, 16, True), ("suite36_1", 10.0, 16, False),
    ("core30_1", 1.0, None, True), ("core30_0", 1.0, 10, True),
    ("dyadic", 1.0, None, True), ("dyadic", 1.0, 8, True),
    ("thirds", 1.0, None, True), ("thirds", 1.0, 8, True),
    ("float", 1.0, None, True), ("float", 1.0, 8, True)])
def test_plan_sparse_matches_jax_planner(kind, giters, chunk_log2,
                                         allow_factor, monkeypatch):
    """At the reference's per-chunk and per-mask-entry costs the port's
    search (each matrix's rows once, bit-mask greedy, memoized row
    patterns) makes the reference's plan bitwise: order, r, live ids, row
    split, dead fraction and live estimate."""
    monkeypatch.setattr(pruning, "C_CHUNK_S", 80e-9)
    monkeypatch.setattr(pruning, "C_MASK_S", 5e-8)
    a = search_matrix(kind)
    want = jpruning.plan_sparse(a, giters=giters, chunk_log2=chunk_log2,
                                allow_factor=allow_factor)
    got = pruning.plan_sparse(a, giters=giters, chunk_log2=chunk_log2,
                              allow_factor=allow_factor)
    assert (got is None) == (want is None)
    if kind != "float":
        assert got is not None
    if got is not None:
        assert got.r == want.r
        for f in ("col_perm", "ids", "alive_rows", "factor_rows"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.dead_frac == want.dead_frac
        assert got.est_live == want.est_live


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("r", [10, 14, 20])
def test_prune_order_matches_jax_at_n36(r, seed):
    """The orderings of the suite's n=36 matrices, each r alone and from
    one prune_rows for every r, are the reference's bitwise."""
    a = search_matrix(f"suite36_{seed}")
    want = jorderings.prune_order(a, r)
    rows = orderings.prune_rows(a)
    for got in (orderings.prune_order(a, r),
                orderings.prune_order(a, r, rows=rows)):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind", ["suite36_0", "core30_0", "dyadic",
                                  "thirds", "float", "pm1", "huge"])
def test_row_zero_fracs_match_jax(kind):
    """Each row's share of zeros, counted by meet in the middle where the
    sums are exact and from the whole pattern elsewhere, is the
    reference's bitwise: rows of +-1 reach zero often, rows past 2^52 and
    off the half-integer grid take the pattern."""
    if kind == "pm1":
        rng = np.random.default_rng(3)
        a = rng.choice([-1.0, 1.0], (20, 20)) * (rng.random((20, 20)) < 0.8)
        a[:, -1] = rng.integers(0, 3, 20)
    elif kind == "huge":
        a = search_matrix("core30_0") * 2.0 ** 51
    else:
        a = search_matrix(kind)
    got = orderings.prune_rows(a).zero_frac
    want = [jorderings._row_zero_frac(a, z) for z in range(a.shape[0])]
    assert got == want
    if kind in ("pm1", "core30_0"):
        assert max(got) > 0


@pytest.mark.parametrize("kind", ["int", "half", "pm1", "thirds", "normal",
                                  "huge"])
def test_zero_frac_is_the_patterns_mean(kind):
    """zero_frac, by whichever way it counts (a Python list up to 8
    values, meet in the middle where the sums are exact, the numpy pattern
    elsewhere), is the mean of zeros of the whole pattern, bitwise, at
    every length from 0 to 16."""
    rng = np.random.default_rng(len(kind))
    hits = 0
    for k in range(17):
        for _ in range(3):
            if kind in ("int", "half", "thirds", "huge"):
                vals = rng.integers(-4, 5, k).astype(np.float64)
                vals[vals == 0] = 1.0
                scale = {"int": 1.0, "half": 0.5, "thirds": 1 / 3,
                         "huge": 2.0 ** 50}[kind]
                vals *= scale
                x0 = -float(vals[: k // 2].sum()) + (scale if k % 3 else 0)
            elif kind == "pm1":
                vals = rng.choice([-1.0, 1.0], k)
                x0 = float(rng.integers(-2, 3))
            else:
                vals = rng.standard_normal(k)
                x0 = -float(vals[: k // 2].sum())
            want = float((orderings._subset_sums(x0, vals) == 0.0).mean())
            got = orderings.zero_frac(x0, vals)
            assert got == want, (k, x0, vals)
            hits += got > 0
    assert hits > 0


@pytest.mark.parametrize("chunk_log2,candidates", [(None, 18), (16, 3)])
def test_search_counts(chunk_log2, candidates):
    """stats counts the (r, ordering) pairs scored and the constant-row
    lookups, counted here from the reference's orderings: each either
    built a pattern or found it, and a suite matrix reuses some."""
    a = search_matrix("suite36_0")
    n = a.shape[0]
    stats = {}
    pruning.plan_sparse(a, giters=ryser.K1_GITERS["df64"],
                        chunk_log2=chunk_log2, stats=stats)
    assert stats["candidates"] == candidates
    lookups = 0
    for r in ([10, 12, 14, 16, 18, 20] if chunk_log2 is None
              else [chunk_log2]):
        for perm in jorderings.prune_order(a, r):
            ap = a[:, perm]
            lookups += sum(np.count_nonzero(ap[z, : n - 1]) <= 16
                           for z in jpruning.const_rows(ap, r))
    assert stats["patterns_built"] + stats["patterns_reused"] == lookups
    assert stats["patterns_built"] >= 1 and stats["patterns_reused"] > 0


@pytest.mark.parametrize("n,density,chunk_log2,candidates", [
    (20, 0.15, None, 3), (22, 0.15, 8, 3), (24, 0.5, None, 6)])
def test_sparse_search_in_result_meta(n, density, chunk_log2, candidates):
    """permanent(sparse=True) reports the planner's counts whenever the
    planner ran, a declined plan too (r 7 alone below n=24, 7 and 8 at
    24); a call that plans nothing has none."""
    a = suite_matrix(3, n, str(density), 0)
    res = spt.permanent(a, sparse=True, chunk_log2=chunk_log2,
                        device="cpu")
    search = res.meta["sparse_search"]
    assert search["candidates"] == candidates
    assert search["patterns_built"] >= 1
    assert set(search) == {"candidates", "patterns_built",
                           "patterns_reused"}
    assert "sparse_search" not in spt.permanent(a[:19, :19],
                                                device="cpu").meta


# ------------------------------------------------------ the chunk weights

def reference_plan(a, chunk_log2, tier="df64"):
    """The reference's plan of `a` and what both packages walk on it: the
    permuted, row-scaled matrix, the reference's packs, and the port's
    made from them."""
    plan = jpruning.plan_sparse(a, chunk_log2=chunk_log2,
                                df=tier in ("df64", "tf96"))
    assert plan is not None
    ap = np.ascontiguousarray(a[:, plan.col_perm]).astype(np.float64)
    a_s = np.ldexp(ap, -ryser._row_scales(ap)[:, None])
    nf = len(plan.factor_rows)
    nf_pad = max(8, -(-nf // 8) * 8)
    n_pad = jgray.pad_n(len(plan.alive_rows)) if nf else jgray.pad_n(len(a))
    rows = a_s[plan.alive_rows] if nf else a_s
    jpack = jgray.pack_matrix(rows, n_pad)
    jfpack = jgray.pack_matrix(a_s[plan.factor_rows], nf_pad)
    return dict(plan=plan, a_s=a_s, n_pad=n_pad, nf=nf, nf_pad=nf_pad,
                rows=rows, jpack=jpack, jfpack=jfpack,
                pack=gray.from_jax_pack(*jpack),
                fpack=gray.from_jax_pack(*jfpack, rows=nf))


@pytest.mark.parametrize("n,density,seed,chunk_log2", [
    (20, 0.2, 0, 6), (22, 0.2, 0, 8), (24, 0.2, 0, 9), (21, 0.25, 0, 6)])
def test_factor_weights_equal_reference(n, density, seed, chunk_log2):
    """factor_weights against the reference's device weights and against
    chunk_factors, on an integer matrix scaled by powers of two: every x
    and every product of the factored rows is exact in all three, so the
    weights are equal exactly, and a sentinel's is 0.  The port's factor
    pack read from the reference's pair pack equals its own."""
    ctx = reference_plan(sparse_matrix(n, density, seed), chunk_log2)
    plan, nf = ctx["plan"], ctx["nf"]
    assert nf >= 2
    own = gray.pack_matrix(ctx["a_s"][plan.factor_rows], nf)
    for got, want in zip(ctx["fpack"], own):
        assert np.array_equal(got, want)
    ids = np.concatenate([plan.ids[:500], [-1], plan.ids[-500:]])
    whi, wlo = gray.factor_weights(torch.as_tensor(ids),
                                   *map(t64, ctx["fpack"]), n, plan.r)
    got = whi.numpy().astype(np.longdouble) + wlo.numpy()
    host = pruning.chunk_factors(ctx["a_s"], plan.factor_rows, ids, plan.r,
                                 dtype=np.longdouble)
    assert np.array_equal(got, host)
    jhi, jlo = jgray.factor_weights(
        ids.astype(np.int32)[None, :], *ctx["jfpack"], n=n,
        nf_pad=ctx["nf_pad"], r=plan.r)
    ref = np.asarray(jhi, np.float64)[0] + np.asarray(jlo, np.float64)[0]
    assert np.array_equal(whi.numpy() + wlo.numpy(), ref)
    assert got[500] == 0 and np.all(got[:500] != 0)


def test_factor_weights_without_rows_is_one():
    ids = torch.tensor([0, 3, -1, 7])
    whi, wlo = gray.factor_weights(ids, torch.zeros(0, dtype=torch.float64),
                                   torch.zeros((19, 0), dtype=torch.float64),
                                   20, 6)
    assert whi.tolist() == [1.0, 1.0, 0.0, 1.0] and not wlo.any()


# ------------------------------- weighted per-chunk partials, one plan

def reference_partials(ctx, ids_blocks, tier):
    """superman_tpu.parallel.sharding.compute_partials on the reference's
    own plan and packs, per lane, host-weighted (interpret mode)."""
    plan, a_s = ctx["plan"], ctx["a_s"]
    n = a_s.shape[0]
    cth, ctl = colst_pack(ctx["rows"], ctx["n_pad"])
    rplan = jgray.RyserPlan(n=n, n_pad=ctx["n_pad"], r=plan.r,
                            lanes=ids_blocks.shape[1],
                            num_chunks=1 << (n - 1 - plan.r))
    factors = None
    if ctx["nf"]:
        def host_fn(blk):
            return jpruning.chunk_factors(
                a_s, plan.factor_rows, blk, plan.r,
                dtype=np.longdouble if tier == "tf96" else np.float64)
        factors = (*ctx["jfpack"], ctx["nf_pad"], host_fn)
    return jsharding.compute_partials(
        ids_blocks.astype(np.int32), *ctx["jpack"], cth, ctl, rplan,
        exact_storage=True, interpret=True, factors=factors,
        **TIER_KW[tier])


def port_partials(ctx, ids, tier, n):
    out = ryser_cuda.ryser_weighted_ref(
        torch.as_tensor(ids), *map(t64, ctx["pack"]),
        *map(t64, ctx["fpack"]), n=n, r=ctx["plan"].r, tier=tier).numpy()
    return out


@pytest.mark.parametrize("tier", ["df64", "f32k", "tf96"])
@pytest.mark.parametrize("n,density,seed,chunk_log2", [(20, 0.2, 0, 6),
                                                       (22, 0.2, 0, 8)])
def test_weighted_partials_bitwise_on_exact_products(n, density, seed,
                                                     chunk_log2, tier):
    """A 0/1 matrix, scaled by powers of two: every product of the walk
    and of the weights is a small dyadic number, exact in float32, so the
    port's weighted per-chunk partials (hi + lo) equal the reference's
    bit for bit in every tier, chunk by chunk, on the reference's plan
    with a sentinel block padded in."""
    a = binary_matrix(n, density, seed)
    ctx = reference_plan(a, chunk_log2, tier)
    assert ctx["nf"] >= 1 and ctx["n_pad"] < n
    ids = jsharding.pad_ids(ctx["plan"].ids[:1000], 128, 1)
    want = reference_partials(ctx, ids, tier)
    got = port_partials(ctx, ids.reshape(-1).astype(np.int64), tier, n)
    got = (got[:, 0].astype(want.dtype) + got[:, 1]).reshape(ids.shape)
    assert np.any(want != 0)
    assert np.array_equal(got, want)
    assert not got[ids < 0].any()


@pytest.mark.parametrize("tier,tol", [("df64", 2.0 ** -45),
                                      ("f32k", 2.0 ** -18),
                                      ("tf96", 2.0 ** -45)])
@pytest.mark.parametrize("n,density,seed,chunk_log2", [(20, 0.2, 1, 6),
                                                       (21, 0.25, 0, 6)])
def test_weighted_partials_match_reference(n, density, seed, chunk_log2, tier,
                                           tol):
    """Entries 1-4: the products round.  df64 and tf96 partials lie within
    2^-45 of the largest partial of the reference's (its df64 products
    err by ~2^-44 a term, the port's by 2^-53); f32k within 2^-18 (both
    round every product to float32, in different fold orders at n_pad
    16 vs the reference's 8-row groups)."""
    a = sparse_matrix(n, density, seed)
    ctx = reference_plan(a, chunk_log2, tier)
    assert ctx["nf"] >= 1
    ids = jsharding.pad_ids(ctx["plan"].ids[:1000], 128, 1)
    want = reference_partials(ctx, ids, tier).astype(np.float64)
    got = port_partials(ctx, ids.reshape(-1).astype(np.int64), tier, n)
    got = (got[:, 0] + got[:, 1]).reshape(ids.shape)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= tol * scale
    assert not got[ids < 0].any()


def test_sentinels_masked_where_n_pad_equals_n():
    """n=24 walked whole (no row factored), so n_pad == n and no zero
    padding row kills a sentinel lane by itself: the port zeroes it
    before the block reduction.  Per chunk and in total the port agrees
    with the reference, which masks its lanes on the host."""
    n, tier = 24, "df64"
    a = sparse_matrix(n, 0.2, 1)
    ctx = reference_plan(a, 9, tier)
    assert ctx["nf"] == 0 and ctx["n_pad"] == n
    ids = ctx["plan"].ids[:300]
    blocks = jsharding.pad_ids(ids, 128, 1)             # 84 sentinels
    want = reference_partials(ctx, blocks, tier)
    flat = blocks.reshape(-1).astype(np.int64)
    got = port_partials(ctx, flat, tier, n)
    got = (got[:, 0] + got[:, 1]).reshape(blocks.shape)
    assert np.abs(got - want).max() <= 2.0 ** -45 * np.abs(want).max()
    assert not got[blocks < 0].any()
    # an unmasked sentinel would not be zero here: the plain walk of id 0
    # stands in for what a masked-out lane holds
    raw = ryser_cuda.ryser_partials_ref(
        torch.tensor([0]), *map(t64, ctx["pack"]), n=n, r=9).numpy()
    assert raw[0, 0] != 0
    red = ryser_cuda.ryser_reduced(
        torch.as_tensor(ids), *map(t64, ctx["pack"]),
        *map(t64, ctx["fpack"]), n=n, r=9, tier=tier).numpy()
    assert red.shape == (3, 2)
    assert red.sum() == pytest.approx(want.sum(), rel=1e-12)


@pytest.mark.parametrize("tier", ["df64", "f32", "f32k", "tf96"])
def test_block_reduction_matches_float_sum(tier):
    """ryser_reduced (padded to blocks of 128, halving order, the
    double-double sum) against a plain float64 sum of the per-chunk
    route: equal to that sum's own rounding (128 terms, 1e-13), block by
    block; the words of tf96 summed wide agree to 1e-18 relative."""
    n = 20
    ctx = reference_plan(sparse_matrix(n, 0.2, 0), 6, tier)
    ids = torch.as_tensor(ctx["plan"].ids[:900])
    args = [*map(t64, ctx["pack"]), *map(t64, ctx["fpack"])]
    chunks = ryser_cuda.ryser_weighted_ref(ids, *args, n=n, r=6,
                                           tier=tier).numpy()
    red = ryser_cuda.ryser_reduced(ids, *args, n=n, r=6, tier=tier).numpy()
    assert red.shape == (8, 2) and red.dtype == np.float64
    per_block = np.zeros(8 * 128)
    per_block[:900] = chunks.sum(axis=1)
    per_block = per_block.reshape(8, 128).sum(axis=1)
    assert np.abs(red.sum(axis=1) - per_block).max() <= \
        1e-13 * np.abs(per_block).max()
    wide = tf96.sum_words(chunks[None])[0]
    assert abs(tf96.sum_words(red[None])[0] - wide) <= 1e-18 * abs(wide)


# --------------------------------------------------------- the whole path

@pytest.mark.parametrize("calc,rel", [("df64", 1e-10), ("tf96", 1e-11),
                                      ("f32k", 1e-4)])
@pytest.mark.parametrize("seed,chunk_log2", [(5, 8), (9, 6)])
def test_sparse_permanent_matches_jax(seed, chunk_log2, calc, rel):
    """permanent(a, sparse=True) on the reference's test matrices
    (tests/test_sparse_prune.py) against sp.permanent and the exact brute
    force, with the same plan reported in meta."""
    a = sparse_matrix(20, 0.18, seed)
    want = perman_brute(a)
    ref = sp.permanent(a, calc=calc, sparse=True, chunk_log2=chunk_log2,
                       lanes=256)
    got = spt.permanent(a, calc=calc, sparse=True, chunk_log2=chunk_log2,
                        lanes=256, device="cpu")
    assert got.algo_name == f"sparyser_plain_{calc}"
    assert ref.algo_name == f"sparyser_pallas_{calc}"
    assert got.permanent == pytest.approx(float(want), rel=rel)
    assert got.permanent == pytest.approx(ref.permanent, rel=rel)
    assert got.meta["sparse"] == ref.meta["sparse"]
    assert got.meta["sparse"]["factored_rows"] >= 1
    for key in ("calc", "chunks", "r", "lanes", "scale_log2"):
        assert got.meta[key] == ref.meta[key], key
    assert got.iterations == ref.iterations
    assert "sparse_pending" not in got.meta
    dense = spt.permanent(a, calc=calc, sparse=False, chunk_log2=chunk_log2,
                          device="cpu")
    assert "sparse" not in dense.meta
    assert got.permanent == pytest.approx(dense.permanent, rel=rel)


@pytest.mark.parametrize("overrides", [{"perman_algo": "14"},
                                       {"perman_algo": "skipper"},
                                       {"sparse": True, "preprocessing": 2},
                                       {"sparse": True, "preprocessing": 1}])
def test_skipper_ids_and_preprocessing_match_jax(overrides):
    """A SkipPer id without sparse=True turns the sparse path on, and
    sparse=True applies the preprocessing order first, as in the
    reference: same algo family, plan and value."""
    a = sparse_matrix(20, 0.18, 7)
    ref = sp.permanent(a, chunk_log2=7, **overrides)
    got = spt.permanent(a, chunk_log2=7, device="cpu", **overrides)
    assert ref.algo_name == "sparyser_pallas_df64"
    assert got.algo_name == "sparyser_plain_df64"
    assert got.meta.get("sparse") == ref.meta.get("sparse")
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)
    assert got.permanent == pytest.approx(float(perman_brute(a)), rel=1e-10)


def test_glynn_runs_on_the_preprocessed_matrix():
    """Glynn under sparse=True gets the matrix in the preprocessing order,
    as in the reference."""
    a = sparse_matrix(20, 0.18, 3)
    ref = sp.permanent(a, perman_algo="glynn", sparse=True, preprocessing=2,
                       chunk_log2=6)
    got = spt.permanent(a, perman_algo="glynn", sparse=True, preprocessing=2,
                        chunk_log2=6, device="cpu")
    assert got.algo_name == "glynn_plain_df64"
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)
    assert got.permanent == pytest.approx(float(perman_brute(a)), rel=1e-10)


def test_real_valued_sparse_matches_jax():
    """A real-valued sparse matrix (integer rows times real factors, so
    constant rows still vanish at some chunk bases and the planner
    prunes): the factored rows' x and the weights round in float64; both
    packages stay within 1e-10 of each other and of the float64 brute
    force."""
    rng = np.random.default_rng(3)
    a = sparse_matrix(20, 0.18, 3) * rng.uniform(0.5, 2.0, (20, 1))
    ref = sp.permanent(a, sparse=True, chunk_log2=8)
    got = spt.permanent(a, sparse=True, chunk_log2=8, device="cpu")
    assert got.meta["sparse"] == ref.meta["sparse"]
    assert got.meta["exact_storage"] is False
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)
    assert got.permanent == pytest.approx(perman_brute(a), rel=1e-10)


def test_row_scaled_sparse_matches_jax_scale():
    """Rows scaled by 2^-30..2^30: the retry loop re-packs alive and
    factored rows from the matrix as each attempt scales it, and both
    packages end on the same scale_log2 and value."""
    rng = np.random.default_rng(8)
    a = sparse_matrix(20, 0.18, 8).astype(np.float64)
    a = np.ldexp(a, rng.integers(-30, 31, 20)[:, None])
    ref = sp.permanent(a, sparse=True, chunk_log2=8)
    got = spt.permanent(a, sparse=True, chunk_log2=8, device="cpu")
    assert got.meta["sparse"] == ref.meta["sparse"]
    assert got.meta["scale_log2"] == ref.meta["scale_log2"]
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)


def test_all_chunks_pruned_is_zero():
    """A matrix whose permanent vanishes through a constant row that is
    zero at every chunk base: the plan has no live chunk, the engine
    returns 0 without walking, as the reference does."""
    n = 20
    a = sparse_matrix(n, 0.3, 2)
    a[5, :] = 0
    a[5, n - 1] = 2          # x0 = 2 - 2/2 - 1 = 0 with one more entry of 2
    a[5, n - 2] = 0
    a[5, n - 3] = 2          # x = (2 - 2) + 2 * bit: zero when the bit is 0
    a[6, :] = 0
    a[6, n - 1] = 2
    a[6, n - 3] = -2         # x = (2 - 0) ... paired so one of the two is 0
    ref = sp.permanent(a, sparse=True, chunk_log2=6)
    got = spt.permanent(a, sparse=True, chunk_log2=6, device="cpu")
    assert ref.permanent == got.permanent == 0.0
    assert got.meta.get("reason") == ref.meta.get("reason")


def test_subchunk_split_gives_the_same_total():
    """Each live chunk cut into aligned sub-chunks (what the engine does
    when a pruned plan has fewer chunks than the card has thread slots):
    the same Gray indices, the same weights, the same total to rounding;
    the ids are those of modp's split, which shares the code."""
    n, tier = 20, "df64"
    ctx = reference_plan(sparse_matrix(n, 0.2, 0), 6, tier)
    ids = torch.as_tensor(ctx["plan"].ids)
    args = [*map(t64, ctx["pack"]), *map(t64, ctx["fpack"])]
    whole = ryser_cuda.ryser_reduced(ids, *args, n=n, r=6, tier=tier).sum()
    assert gray.split_shift(len(ids), 6, len(ids)) == 0
    assert gray.split_shift(0, 6, 100) == 0
    for want_chunks in (len(ids) + 1, 4 * len(ids), 1 << 30):
        sub, r = gray.split_chunks(ids, 6, want_chunks)
        shift = 6 - r
        assert shift == gray.split_shift(len(ids), 6, want_chunks) >= 1
        assert r >= 1 and sub.numel() == len(ids) << shift
        assert torch.equal(sub >> shift, ids.repeat_interleave(1 << shift))
        total = ryser_cuda.ryser_reduced(sub, *args, n=n, r=r, tier=tier).sum()
        assert float(total) == pytest.approx(float(whole), rel=1e-13)


def test_compute_total_with_factors_splits_to_fill_the_card():
    """sharding.compute_total(factors=) is the engine's route: its total
    equals the unsplit reduced walk's, whatever number of SMs it fills."""
    n, tier = 20, "tf96"
    ctx = reference_plan(sparse_matrix(n, 0.2, 0), 6, tier)
    plan = gray.RyserPlan(n=n, n_pad=ctx["n_pad"], r=6, lanes=256,
                          num_chunks=1 << (n - 7))
    args = [*map(t64, ctx["pack"]), *map(t64, ctx["fpack"])]
    whole = tf96.sum_words(ryser_cuda.ryser_reduced(
        torch.as_tensor(ctx["plan"].ids), *args, n=n, r=6,
        tier=tier).numpy())
    for sms in (1, 16):
        total = sharding.compute_total(
            *ctx["pack"], plan, torch.device("cpu"), tier=tier,
            sparse=(ctx["plan"].ids, *ctx["fpack"]), sms=sms)
        assert isinstance(total, np.longdouble)
        assert abs(total - whole) <= 1e-17 * abs(whole)


def test_chunk_ids_argument_walks_a_pruned_list():
    """ryser_exact(chunk_ids=): a caller's own live list at the dense
    plan's chunk length (here live_chunks') gives the permanent."""
    a = sparse_matrix(20, 0.18, 5)
    ap = a[:, pruning.plan_sparse(a, giters=148.0, chunk_log2=8).col_perm]
    dm = DenseMatrix(ap, "int")
    ids = pruning.live_chunks(dm, r=8)
    assert ids is not None and 0 < len(ids) < 1 << 11
    res = ryser.ryser_exact(dm, Flags(chunk_log2=8), torch.device("cpu"),
                            chunk_ids=ids)
    assert res.meta["chunks"] == len(ids) and "sparse" not in res.meta
    assert res.permanent == pytest.approx(float(perman_brute(a)), rel=1e-10)


def test_reduced_wrapper_refuses_bad_packs():
    n = 20
    ctx = reference_plan(sparse_matrix(n, 0.2, 0), 6)
    ids = torch.as_tensor(ctx["plan"].ids[:10])
    x0, cols, fx0, fcols = [*map(t64, ctx["pack"]), *map(t64, ctx["fpack"])]
    with pytest.raises(ValueError, match="fcols"):
        ryser_cuda.ryser_reduced(ids, x0, cols, fx0, fcols[:-1], n=n, r=6)
    with pytest.raises(TypeError, match="fx0"):
        ryser_cuda.ryser_reduced(ids, x0, cols, fx0.float(), fcols, n=n, r=6)
    big = torch.ones(24, dtype=torch.float64)
    with pytest.raises(ValueError, match="more than n"):
        ryser_cuda.ryser_reduced(ids, big, torch.zeros((n - 1, 24),
                                                       dtype=torch.float64),
                                 fx0, fcols, n=n, r=6)
    with pytest.raises(ValueError, match="unknown tier"):
        ryser_cuda.ryser_reduced(ids, x0, cols, fx0, fcols, n=n, r=6,
                                 tier="amp")
