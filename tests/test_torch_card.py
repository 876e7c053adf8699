"""The CUDA kernels on a card, against their plain PyTorch versions.

Imports neither jax nor the test helpers, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_card.py

Without a card the tests skip.
"""

import numpy as np
import pytest
import torch

from superman_tpu_torch.csrc.build import launches
from superman_tpu_torch.ops import (batch, gray, modp, modp_cuda, pruning,
                                    ryser, ryser_cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["df64", "f32", "f32k", "tf96"])
@pytest.mark.parametrize("n,r", [(12, 3), (24, 5), (40, 2)])
def test_kernel_matches_plain_on_card(n, r, tier):
    """Integer matrix, row-scaled as the engine scales it: the kernel
    and the plain version take the same IEEE steps in every tier, so the
    partials must agree bitwise; sentinel ids give 0 and the launch is
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n)
    a = (rng.random((n, n)) < 0.5) * rng.integers(1, 5, (n, n))
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    dev = torch.device("cuda", 0)
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, gray.pad_n(n)))
    nchunks = 1 << (n - 1 - r)
    ids = torch.cat([torch.arange(min(nchunks, 4096)), torch.full((5,), -1),
                     torch.arange(nchunks - min(nchunks, 512), nchunks)]
                    ).to(dev)
    before = launches("walk", "blocks")
    got = ryser_cuda.ryser_partials(ids, x0, cols, n=n, r=r, tier=tier)
    torch.cuda.synchronize()
    assert launches("walk", "blocks") == before + 1
    want = ryser_cuda.ryser_partials_ref(ids, x0, cols, n=n, r=r, tier=tier)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert torch.equal(got[ids < 0], torch.zeros(5, 2, dtype=got.dtype,
                                                 device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["df64", "f32", "f32k", "tf96"])
@pytest.mark.parametrize("n,count,r", [(13, 5, 2), (16, 3, 5), (24, 7, 9),
                                       (32, 2, 14)])
def test_batch_kernel_matches_plain_on_card(n, count, r, tier):
    """A stack of integer and real-valued matrices: the batch kernel and
    its plain version walk the same body and reduce each block in the
    same order, so the per-block pairs must agree bitwise; one launch is
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(100 * n + count)
    stack = np.stack([
        ((rng.random((n, n)) < 0.5) * rng.integers(1, 5, (n, n))
         ).astype(np.float64) if i % 2 == 0 else
        (rng.random((n, n)) < 0.6) * rng.random((n, n)) * 5.0
        for i in range(count)])
    dev = torch.device("cuda", 0)
    x0p, colsT, _, _ = batch.pack_stack(stack)
    x0s, colss = torch.as_tensor(x0p).to(dev), torch.as_tensor(colsT).to(dev)
    before = launches("batch")
    got = ryser_cuda.batch_partials(x0s, colss, n=n, r=r, tier=tier)
    torch.cuda.synchronize()
    assert launches("batch") == before + 1
    want = ryser_cuda.batch_partials_ref(x0s, colss, n=n, r=r, tier=tier)
    assert tuple(got.shape) == (count, (1 << (n - 1 - r)) // 128, 2)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_permanent_batch_on_card_matches_cpu():
    """The entry point on a card against the same call on the CPU: the
    same plan is not given (the card plans for its SMs), so df64 values
    agree to 1e-12 and not bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import superman_tpu_torch as spt
    rng = np.random.default_rng(5)
    mats = [(rng.random((n, n)) < 0.6) * rng.integers(1, 4, (n, n))
            for n in (9, 14, 14, 9, 15)]
    got = spt.permanent_batch(mats)
    want = spt.permanent_batch(mats, device="cpu")
    for g, w, m in zip(got, want, mats):
        kernel = m.shape[0] >= 13
        assert g.algo_name == ("ryser_cuda_batch_df64" if kernel
                               else "ryser_walk_batch")
        assert w.algo_name == ("ryser_plain_batch_df64" if kernel
                               else "ryser_walk_batch")
        assert abs(g.permanent - w.permanent) <= 1e-12 * abs(w.permanent)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ryser", "glynn"])
@pytest.mark.parametrize("calc,rel", [("tf96", 1e-15), ("df64", 1e-11),
                                      ("f32k", 1e-3), ("f32", 5e-2)])
def test_tiers_and_glynn_on_card(algo, calc, rel):
    """permanent() at n=22 on the card, Ryser and Glynn in every tier of
    K1, against the exact integer (the port's calc="exact"): tf96 within
    1e-15 (the rounding of the final double), df64 1e-11, f32k 1e-3,
    f32 5e-2; each run launches K1 and names the kernel route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import superman_tpu_torch as spt
    rng = np.random.default_rng(22)
    a = (rng.random((22, 22)) < 0.5) * rng.integers(1, 5, (22, 22))
    want = spt.permanent(a, calc="exact").meta["exact_fraction"]
    before = launches("walk", "blocks")
    overrides = {"perman_algo": "glynn"} if algo == "glynn" else {}
    got = spt.permanent(a, calc=calc, **overrides)
    assert launches("walk", "blocks") > before
    assert got.algo_name == f"{algo}_cuda_{calc}"
    assert abs(got.permanent - want) <= rel * abs(want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,calc", [(12, "df64"), (18, "f32"), (22, "f64")])
def test_glynn_float64_route_on_card(n, calc):
    """Glynn's float64 route (below n=19, and under calc="f64") walks on
    the card: the lane walk of ops/glynn.py, glynn_walk_<calc>, within
    1e-12 of the host walk perman_glynn, and inf where a double cannot
    hold the permanent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import superman_tpu_torch as spt
    from superman_tpu_torch.ops.oracle import perman_glynn
    a = np.random.default_rng(n).integers(1, 5, (n, n)).astype(np.float64)
    got = spt.permanent(a, perman_algo="glynn", calc=calc)
    assert got.algo_name == f"glynn_walk_{calc}"
    assert got.meta["device"] == "cuda:0"
    assert abs(got.permanent - perman_glynn(a)) <= 1e-12 * perman_glynn(a)
    big = spt.permanent(a * 1e25, perman_algo="glynn", calc=calc)
    assert big.permanent == float("inf")


@pytest.mark.cuda
def test_tf96_batch_on_card_matches_exact():
    """permanent_batch(calc="tf96") on a card: integer matrices from
    n=13 go through K2's tf96 tier and land within 1e-15 of the exact
    integers (the rounding of the final double), a
    real-valued one walks as df64 with the warning, n=9 runs one by one
    on the host route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import superman_tpu_torch as spt
    rng = np.random.default_rng(6)
    mats = [(rng.random((n, n)) < 0.6) * rng.integers(1, 4, (n, n))
            for n in (14, 9, 14, 20)]
    mats.insert(2, rng.random((14, 14)))
    before = launches("batch")
    with pytest.warns(UserWarning, match="tf96 requires"):
        got = spt.permanent_batch(mats, calc="tf96")
    assert launches("batch") == before + 3
    assert [g.algo_name for g in got] == [
        "ryser_cuda_batch_tf96", "ryser_tf96_host", "ryser_cuda_batch_df64",
        "ryser_cuda_batch_tf96", "ryser_cuda_batch_tf96"]
    for g, m in zip(got, mats):
        if m.dtype.kind == "f":
            continue
        want = spt.permanent(m, calc="exact").meta["exact_fraction"]
        assert abs(g.permanent - want) <= 1e-15 * abs(want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,p", [(12, 3, 2039), (24, 5, (1 << 31) - 1),
                                   (40, 2, 1009)])
def test_modp_kernel_matches_plain_on_card(n, r, p):
    """The Z_p kernel writes canonical residues, so it must equal the
    plain version exactly on every chunk; sentinels give 0 and the launch
    is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n)
    core = ((rng.random((n, n)) < 0.6) * rng.integers(1, 1 << 20, (n, n))
            ).tolist()
    dev = torch.device("cuda", 0)
    x0, cols = (t.to(dev) for t in modp.pack_mod(
        modp.reduce_core_mod(core, p), p, gray.pad_n(n)))
    nchunks = 1 << (n - 1 - r)
    ids = torch.cat([torch.arange(min(nchunks, 4096)), torch.full((5,), -1),
                     torch.arange(nchunks - min(nchunks, 512), nchunks)]
                    ).to(dev)
    before = launches("modp")
    got = modp_cuda.mod_partials(ids, x0, cols, p, n=n, r=r)
    torch.cuda.synchronize()
    assert launches("modp") == before + 1
    want = modp_cuda.mod_partials_ref(ids, x0, cols, p, n=n, r=r)
    assert torch.equal(got, want)
    assert bool(((got >= 0) & (got < p)).all())
    assert torch.equal(got[ids < 0], torch.zeros(5, dtype=torch.int64,
                                                 device=dev))


@pytest.mark.cuda
def test_pruned_walk_matches_dense_walk_on_card():
    """A pruned live-chunk plan, split to fill the card, gives the dense
    walk's residue: the same kernel over two chunkings of one sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, p = 24, (1 << 31) - 1
    rng = np.random.default_rng(24)
    core = ((rng.random((n, n)) < 0.25) * rng.integers(1, 9, (n, n))).tolist()
    col_perm, ids, r, live_frac = modp.core_plan(core, giters=0.001)
    assert 0 < live_frac < 1
    work = [[row[j] for j in col_perm] for row in core]
    dev = torch.device("cuda", 0)
    assert modp.perman_core_mod(work, p, dev, ids=ids, r=r) == \
        modp.perman_core_mod(core, p, dev)


def _sparse_matrix(n, density, seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density) * rng.integers(1, 5, (n, n))
    np.fill_diagonal(a, rng.integers(1, 4, n))
    return a


def _factored_packs(a, sp, dev):
    """The alive rows' and the factored rows' packs of the plan's matrix,
    row-scaled as the engine scales it, on `dev`."""
    a = np.ascontiguousarray(a[:, sp.col_perm]).astype(np.float64)
    a_s = np.ldexp(a, -ryser._row_scales(a)[:, None])
    packs = (gray.pack_matrix(a_s[sp.alive_rows],
                              gray.pad_n(len(sp.alive_rows)))
             + gray.pack_matrix(a_s[sp.factor_rows], len(sp.factor_rows)))
    return [torch.as_tensor(v).to(dev).contiguous() for v in packs]


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["df64", "f32", "f32k", "tf96"])
@pytest.mark.parametrize("n,density,seed,chunk_log2,factor", [
    (20, 0.2, 0, 6, True), (24, 0.2, 0, 9, True), (24, 0.2, 1, 9, True),
    (24, 0.15, 0, 6, False), (36, 0.15, 36, 18, True)])
def test_reduced_kernel_matches_plain_on_card(n, density, seed, chunk_log2,
                                              factor, tier):
    """The weighted, block-reduced walk on a pruned plan (factored rows or
    none; n_pad == n with sentinels in the (24, 0.2, 1) case, n_pad < n in
    the others): kernel and plain version walk, weight and reduce in one
    order, so the block pairs must agree bitwise; the count is the
    tier's.  The n=36 case walks the first 640 live ids after the split
    the engine would make, with a ragged tail of sentinels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _sparse_matrix(n, density, seed)
    sp = pruning.plan_sparse(a, giters=ryser.K1_GITERS[tier],
                             chunk_log2=chunk_log2, allow_factor=factor)
    assert sp is not None and (len(sp.factor_rows) > 0) == (
        factor and (n, seed) != (24, 1))
    dev = torch.device("cuda", 0)
    x0, cols, fx0, fcols = _factored_packs(a, sp, dev)
    ids, r = torch.as_tensor(sp.ids).to(dev), sp.r
    if n == 36:
        ids, r = gray.split_chunks(ids[:5], r, 640)
    ids = torch.cat([ids[:300], ids.new_full((3,), -1), ids[300:]])
    before = launches("reduced", tier=tier)
    got = ryser_cuda.ryser_reduced(ids, x0, cols, fx0, fcols, n=n, r=r,
                                   tier=tier)
    torch.cuda.synchronize()
    assert launches("reduced", tier=tier) == before + 1
    want = ryser_cuda.ryser_reduced_ref(ids, x0, cols, fx0, fcols, n=n, r=r,
                                        tier=tier)
    assert tuple(got.shape) == (-(-ids.shape[0] // 128), 2)
    assert got.dtype == want.dtype == torch.float64
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("kind", ["int", "real"])
@pytest.mark.parametrize("n,r", [(12, 3), (20, 5), (24, 5), (40, 2)])
def test_amp_kernel_matches_plain_on_card(n, r, kind, cond):
    """The amp tier, both variants: kernel and plain version take the
    same IEEE steps (the conditioned term's (P, C) fold multiplies and
    adds in one order in both), so the two or four words of every chunk
    agree bitwise; sentinels give 0; one launch is counted, as a
    conditioned one where it is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n)
    a = (rng.random((n, n)) < 0.5) * (rng.integers(1, 5, (n, n))
                                      if kind == "int"
                                      else rng.uniform(-2, 2, (n, n)))
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    dev = torch.device("cuda", 0)
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, gray.pad_n(n)))
    nchunks = 1 << (n - 1 - r)
    ids = torch.cat([torch.arange(min(nchunks, 4096)), torch.full((5,), -1),
                     torch.arange(nchunks - min(nchunks, 512), nchunks)]
                    ).to(dev)
    before = (launches("amp", "amp_cond"), launches("amp_cond"))
    got = ryser_cuda.ryser_amp(ids, x0, cols, n=n, r=r, cond=cond)
    torch.cuda.synchronize()
    assert (launches("amp", "amp_cond"), launches("amp_cond")) == (
        before[0] + 1, before[1] + cond)
    want = ryser_cuda.ryser_amp_ref(ids, x0, cols, n=n, r=r, cond=cond)
    words = 4 if cond else 2
    assert tuple(got.shape) == (ids.numel(), words)
    assert torch.equal(got, want)
    assert torch.equal(got[ids < 0], torch.zeros(5, words,
                                                 dtype=torch.float64,
                                                 device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 31, 37, 52])
def test_tf96_entry_points_match_the_plain_tree_on_card(n):
    """The three tf96 entry points on one integer matrix at an n_pad whose
    product tree has odd levels (24: 12, 6, 3, 2; 32; 40: 20, 10, 5, 3, 2;
    56: 28, 14, 7, 4, 2), each bitwise equal to the plain version of the
    un-normalised tree: K1 with sentinels, K2 on the matrix twice,
    the reduced walk unweighted and weighted by two factored rows, over a
    ragged list with sentinels (K2 at n=20 only: its plain version walks
    every step of every matrix)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(96 + n)
    a = (rng.random((n, n)) < 0.5) * rng.integers(1, 5, (n, n))
    np.fill_diagonal(a, 1)
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    dev = torch.device("cuda", 0)
    n_pad = gray.pad_n(n)
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, n_pad))
    r = 3
    nchunks = 1 << (n - 1 - r)
    ids = torch.cat([torch.arange(300), torch.full((7,), -1),
                     torch.arange(nchunks - 200, nchunks)]).to(dev)
    got = ryser_cuda.ryser_partials(ids, x0, cols, n=n, r=r, tier="tf96")
    assert torch.equal(got, ryser_cuda.ryser_partials_ref(
        ids, x0, cols, n=n, r=r, tier="tf96"))
    if n <= 24:                     # the plain batch walks every step
        stack = torch.stack([x0, x0]), torch.stack([cols, cols])
        got = ryser_cuda.batch_partials(*stack, n=n, r=6, tier="tf96")
        assert torch.equal(got, ryser_cuda.batch_partials_ref(
            *stack, n=n, r=6, tier="tf96"))
    alive = list(range(2, n))
    packs = [torch.as_tensor(v, device=dev).contiguous() for v in
             gray.pack_matrix(a_s[alive], gray.pad_n(len(alive)))
             + gray.pack_matrix(a_s[:2], 2)]
    empty = (torch.zeros(0, dtype=torch.float64, device=dev),
             torch.zeros((n - 1, 0), dtype=torch.float64, device=dev))
    for pack in ([x0, cols, *empty], packs):
        got = ryser_cuda.ryser_reduced(ids, *pack, n=n, r=r, tier="tf96")
        assert torch.equal(got, ryser_cuda.ryser_reduced_ref(
            ids, *pack, n=n, r=r, tier="tf96"))


@pytest.mark.cuda
@pytest.mark.parametrize("calc,rel", [("tf96", 1e-15), ("df64", 1e-11),
                                      ("f32k", 1e-3), ("f32", 5e-2)])
def test_sparse_permanent_on_card_matches_exact(calc, rel):
    """permanent(sparse=True) at n=26 on the card in every tier: the
    pruned, factored walk through the reduced kernel, against the exact
    integer and against the unpruned walk of the same tier.  The chunk
    length is given: left to itself the planner declines at this order,
    where the dense walk costs less than the mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import superman_tpu_torch as spt
    a = _sparse_matrix(26, 0.2, 26)
    want = spt.permanent(a, calc="exact").meta["exact_fraction"]
    assert want != 0
    before = launches("reduced", tier=calc)
    got = spt.permanent(a, calc=calc, sparse=True, chunk_log2=10)
    assert launches("reduced", tier=calc) > before
    assert got.algo_name == f"sparyser_cuda_{calc}"
    assert got.meta["sparse"]["dead_frac"] > 0
    assert abs(got.permanent - want) <= rel * abs(want)
    dense = spt.permanent(a, calc=calc, skip_pruning=False)
    assert "sparse" not in dense.meta
    assert abs(got.permanent - dense.permanent) <= 2 * rel * abs(want)


@pytest.mark.cuda
def test_auto_ladder_on_card():
    """calc="auto" on the card at n=22: probe_only on a benign matrix;
    with an impossible target the ladder runs the amp kernel and ends on
    the exact rung, or with no exact budget on tf96 flagged
    low_confidence."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import superman_tpu_torch as spt
    rng = np.random.default_rng(22)
    a = (rng.random((22, 22)) < 0.5) * rng.integers(1, 5, (22, 22))
    want = spt.permanent(a, calc="exact").meta["exact_fraction"]
    res = spt.permanent(a, calc="auto")
    assert res.meta["auto"]["probe_only"] is True
    assert abs(res.permanent - want) <= 1e-11 * abs(want)
    before = (launches("amp", "amp_cond"), launches("amp_cond"))
    res = spt.permanent(a, calc="auto", auto_target=1e-30)
    # an integer matrix: the amplitude-only variant
    assert (launches("amp", "amp_cond"), launches("amp_cond")) == (
        before[0] + 1, before[1])
    assert res.meta["auto"]["escalated"] == "exact"
    assert res.meta["exact_fraction"] == want
    res = spt.permanent(a, calc="auto", auto_target=1e-30,
                        auto_exact_budget_s=0.0)
    assert res.meta["auto"]["escalated"] == "tf96"
    assert res.meta["auto"]["low_confidence"] is True
    assert abs(res.permanent - want) <= 1e-15 * abs(want)


# ---- the walk loop's edges (csrc/walk.cuh walk_chunk): chunks of r < G
# steps walk one step at a time; at r = G the one group holds the mid
# step; from r = G + 1 the mid step is the step that starts a group.  The
# double tiers walk in groups up to N_PAD 40 and one step at a time from
# 48 (grouped_walk)
G = ryser_cuda.GROUP_LOG2
EDGE_R = sorted({1, 2, G, G + 1, G + 2})
EDGE_TIERS = ["df64", "f32", "f32k", "tf96"]


def _edge_pack(n, n_pad, rows=None, seed=0):
    """An integer matrix of order n (density 0.5, entries 1-4) row-scaled
    as the engine scales it, packed for N_PAD n_pad: rows [0, rows) if
    given (the alive rows of a factored walk), and the rest apart."""
    rng = np.random.default_rng(1000 * n + seed)
    a = (rng.random((n, n)) < 0.5) * rng.integers(1, 5, (n, n))
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    if rows is None:
        return gray.pack_matrix(a_s, n_pad)
    return (gray.pack_matrix(a_s[:rows], n_pad)
            + gray.pack_matrix(a_s[rows:], n - rows))


def _edge_ids(n, r, dev):
    """The first and last 200 chunk ids, 3 sentinels and 100 seeded ones
    between, both parities."""
    nchunks = 1 << (n - 1 - r)
    rng = np.random.default_rng(n + r)
    mid = rng.integers(0, nchunks, 100) if nchunks > 400 else []
    return torch.as_tensor(np.concatenate([
        np.arange(min(nchunks, 200)), [-1, -1, -1], mid,
        np.arange(max(0, nchunks - 200), nchunks)]).astype(np.int64)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", EDGE_TIERS)
@pytest.mark.parametrize("r", EDGE_R)
@pytest.mark.parametrize("n", [8, 32, 40, 48, 60])
def test_walk_loop_edges_match_plain_on_card(n, r, tier):
    """K1 at N_PAD 8, 32, 40, 48 and 64 where the grouped loop starts,
    holds the mid step and does not run: bit for bit the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    x0, cols = (torch.as_tensor(v).to(dev)
                for v in _edge_pack(n, gray.pad_n(n)))
    ids = _edge_ids(n, r, dev)
    before = launches("walk", "blocks")
    got = ryser_cuda.ryser_partials(ids, x0, cols, n=n, r=r, tier=tier)
    torch.cuda.synchronize()
    assert launches("walk", "blocks") == before + 1
    want = ryser_cuda.ryser_partials_ref(ids, x0, cols, n=n, r=r, tier=tier)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", EDGE_TIERS)
@pytest.mark.parametrize("r", EDGE_R)
@pytest.mark.parametrize("n,alive", [(8, 6), (32, 28), (44, 40), (52, 48),
                                     (60, 58)])
def test_reduced_loop_edges_match_plain_on_card(n, alive, r, tier):
    """The reduced entry at N_PAD 8, 32, 40, 48 and 64 (the alive rows'
    pack) with factored rows, at the loop's edges: bit for bit the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    x0, cols, fx0, fcols = (torch.as_tensor(v).to(dev).contiguous()
                            for v in _edge_pack(n, gray.pad_n(alive), alive))
    ids = _edge_ids(n, r, dev)
    before = launches("reduced", tier=tier)
    got = ryser_cuda.ryser_reduced(ids, x0, cols, fx0, fcols, n=n, r=r,
                                   tier=tier)
    torch.cuda.synchronize()
    assert launches("reduced", tier=tier) == before + 1
    want = ryser_cuda.ryser_reduced_ref(ids, x0, cols, fx0, fcols, n=n, r=r,
                                        tier=tier)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", EDGE_TIERS)
@pytest.mark.parametrize("r", EDGE_R)
@pytest.mark.parametrize("n", [13, 25])
def test_batch_loop_edges_match_plain_on_card(n, r, tier):
    """K2 at N_PAD 16 and 32 (its orders are 13-32) at the loop's edges,
    two matrices: bit for bit the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    packs = [_edge_pack(n, gray.pad_n(n), seed=b) for b in range(2)]
    x0s = torch.as_tensor(np.stack([p[0] for p in packs])).to(dev)
    colss = torch.as_tensor(np.stack([p[1] for p in packs])).to(dev)
    before = launches("batch")
    got = ryser_cuda.batch_partials(x0s, colss, n=n, r=r, tier=tier)
    torch.cuda.synchronize()
    assert launches("batch") == before + 1
    want = ryser_cuda.batch_partials_ref(x0s, colss, n=n, r=r, tier=tier)
    assert torch.equal(got, want)


def _suite_matrix(n, density, seed):
    """An integer matrix as the int/ suite draws it: entries 1-4 at the
    density, a full diagonal of 1-4."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density) * rng.integers(1, 5, (n, n))
    np.fill_diagonal(a, rng.integers(1, 5, n))
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["df64", "f32", "f32k"])
@pytest.mark.parametrize("lanes", [1024, 1000])
def test_dense_block_kernel_matches_plain_on_card(lanes, tier):
    """The block-reduced dense entry at n=32 (chunks of 2^8 steps, so the
    plain version is quick) on the first, second, a middle and the last
    block rows (with 1000 lanes the last row runs past the plan's chunks
    and every row ends in a part block), and a row -1 whose ids are all
    sentinels: the kernel derives the ids the
    plain version is given, walks, widens and sums each block in one
    order, so the pairs agree bitwise; one launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, r = 32, 8
    nchunks = 1 << (n - 1 - r)
    last = -(-nchunks // lanes) - 1
    a = _suite_matrix(n, 0.5, 32)
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    dev = torch.device("cuda", 0)
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, n))
    rows = torch.tensor([0, 1, last // 2, last, -1], device=dev)
    before = launches("blocks", tier=tier)
    got = ryser_cuda.ryser_blocks(rows, x0, cols, n=n, r=r, lanes=lanes,
                                  num_chunks=nchunks, tier=tier)
    torch.cuda.synchronize()
    assert launches("blocks", tier=tier) == before + 1
    want = ryser_cuda.ryser_blocks_ref(rows, x0, cols, n=n, r=r, lanes=lanes,
                                       num_chunks=nchunks, tier=tier)
    per_row = -(-lanes // 128)
    assert tuple(got.shape) == (5 * per_row, 2)
    assert got.dtype == want.dtype == torch.float64
    assert torch.equal(got, want)
    assert not got[-per_row:].any()


@pytest.mark.cuda
def test_dense_block_route_engages_on_dense_totals_only():
    """permanent() at n=32 d=0.50 launches the block-reduced entry once a
    call and sums num_chunks / 128 = 1024 pairs; an n=36 d=0.15 call (the
    sparse engine), a permanent_batch call and a calc="exact" call launch
    it never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import superman_tpu_torch as spt
    a32 = _suite_matrix(32, 0.5, 1)
    spt.permanent(a32)                                   # warm-up
    for _ in range(2):
        before = launches("blocks", tier="df64")
        res = spt.permanent(a32)
        assert launches("blocks", tier="df64") == before + 1
        assert res.meta["walk_words"] == 1024 and "sparse" not in res.meta
    before = launches("blocks")
    reduced = launches("reduced", tier="df64")
    res = spt.permanent(_suite_matrix(36, 0.15, 36))
    assert "sparse" in res.meta
    assert launches("reduced", tier="df64") > reduced
    spt.permanent_batch([_suite_matrix(24, 0.5, s) for s in range(8)])
    spt.permanent(_suite_matrix(24, 0.5, 24), calc="exact")
    assert launches("blocks") == before


@pytest.mark.cuda
def test_profiler_names_the_dense_block_kernel():
    """A torch.profiler trace of an n=32 permanent() names its kernel
    ryser_walk_kernel, as the benchmark's K1 roofline reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import superman_tpu_torch as spt
    from torch.profiler import ProfilerActivity, profile
    a32 = _suite_matrix(32, 0.5, 2)
    spt.permanent(a32)                                   # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spt.permanent(a32)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    walks = [k for k in names if "ryser_walk_kernel<" in k]
    assert walks, names
    assert not any("ryser_reduced_kernel" in k for k in names)


def _cards(k):
    """The visible cards, or a skip where there are fewer than k."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < k:
        pytest.skip(f"needs {k} CUDA cards, found {count}")
    return count


@pytest.mark.cuda
def test_mesh_over_every_card_is_bitwise_one_card():
    """permanent(perman_algo="multi", gpu_num=k) over every visible card
    at n=30 d=0.50 keeps the one-card plan and block order, so its value
    is the one-card value to the last bit; every card's block rows and
    walk time are counted, and the caller's current device, the first
    card or the last, is left as it was."""
    k = _cards(2)
    import superman_tpu_torch as spt
    a = _suite_matrix(30, 0.5, 30)
    one = spt.permanent(a)
    for cur in (0, k - 1):
        with torch.cuda.device(cur):
            res = spt.permanent(a, perman_algo="multi", gpu_num=k)
            assert torch.cuda.current_device() == cur
        assert res.permanent == one.permanent
        assert res.meta["mesh"] == k
        cards = res.meta["mesh_cards"]
        assert len(cards) == k
        assert sum(c["rows"] for c in cards) == \
            -(-res.meta["chunks"] // res.meta["lanes"])
        assert all(c["walk_ms"] > 0 for c in cards)


#: a call on `device` through each C entry point: the block-reduced K1
#: (dense df64), K1 per chunk (tf96), the reduced K1 (the sparse gate),
#: K2 (the batch) and K3 (calc="exact")
ENTRY_CALLS = {
    "ryser_walk_blocks": lambda spt, d: spt.permanent(
        _suite_matrix(30, 0.5, 3), device=d).permanent,
    "ryser_walk_tf96": lambda spt, d: spt.permanent(
        _suite_matrix(30, 0.5, 3), calc="tf96", device=d).permanent,
    "ryser_walk_reduced": lambda spt, d: spt.permanent(
        _suite_matrix(36, 0.15, 36), device=d).permanent,
    "ryser_batch": lambda spt, d: [r.permanent for r in spt.permanent_batch(
        [_suite_matrix(24, 0.5, s) for s in range(4)], device=d)],
    "modp_walk": lambda spt, d: spt.permanent(
        _suite_matrix(24, 0.5, 3), calc="exact", device=d).permanent,
}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(ENTRY_CALLS))
def test_a_launch_on_another_card_leaves_the_current_device(entry):
    """Each C entry point makes its card current for the launch and gives
    the caller's device back (csrc/device_guard.cuh): a call on the last
    card from the first leaves the first current, with the first card's
    value."""
    k = _cards(2)
    import superman_tpu_torch as spt
    call = ENTRY_CALLS[entry]
    with torch.cuda.device(0):
        want = call(spt, "cuda:0")
        got = call(spt, f"cuda:{k - 1}")
        assert torch.cuda.current_device() == 0
    assert got == want
