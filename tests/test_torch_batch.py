"""The port's serving batch against the JAX package's.

Seeded numpy stacks go through both packages: the JAX side runs its
serving-batch Pallas kernel in interpret mode on the CPU, the port runs
its batch kernel's plain PyTorch version (device="cpu").  The CUDA kernel
itself is tested on a card by tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu.ops.batch import permanent_batch_pallas
from superman_tpu.ops.oracle import perman64
from superman_tpu_torch.ops import batch, gray, ryser_cuda
from tests.conftest import random_float_matrix, random_int_matrix

TIERS = ("df64", "f32", "f32k")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores and slows the walks tenfold
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mixed_stack(rng, n, count):
    """Integer, real-valued and sparse matrices in turn, one with an empty
    row: the content the reference's own batch test builds."""
    mats = []
    for i in range(count):
        if i % 3 == 0:
            m = (rng.random((n, n)) < 0.4) * rng.integers(1, 5, (n, n))
        elif i % 3 == 1:
            m = rng.random((n, n)) * (rng.random((n, n)) < 0.6)
        else:
            m = (rng.random((n, n)) < 0.25) * rng.integers(1, 3, (n, n))
        mats.append(m.astype(np.float64))
    mats[-1][3, :] = 0.0
    return np.stack(mats)


def _exact_f32_stack(rng, n, count):
    """0/1 matrices on which every product and every partial sum is exact
    in float32: two ones in every row (x is -1, 0 or 1) but two rows with
    four (x in -2..2), so each term is 0 or +-2^j, j <= 2, and every sum
    of 2^(n-1) of them has fewer than 24 bits.  The tiers, the packages
    and any order of summation then give the same bits."""
    mats = []
    for _ in range(count):
        p = rng.permutation(n)
        m = np.zeros((n, n))
        for shift in (0, 1):
            m[np.arange(n), np.roll(p, shift)] = 1.0
        for row in (2, 9):
            free = np.flatnonzero(m[row] == 0)
            m[row, rng.choice(free, 2, replace=False)] = 1.0
        mats.append(m)
    return np.stack(mats)


@pytest.mark.parametrize("calc,n,count,rel", [
    ("df64", 14, 5, 1e-9), ("f32k", 14, 4, 1e-3), ("f32", 13, 3, 1e-2),
    ("df64", 16, 3, 1e-9)])
def test_batch_kernel_matches_jax(calc, n, count, rel):
    """permanent_batch_kernel on the CPU against permanent_batch_pallas in
    interpret mode, mixed content and one empty row.  df64: rel 1e-9 (the
    reference's f32 pairs carry ~2^-44 a term); f32k: rel 1e-3, the
    reference's own limit for its batch; f32: rel 1e-2."""
    stack = _mixed_stack(np.random.default_rng(100 * n + count), n, count)
    want = permanent_batch_pallas(stack, calc=calc)
    got, _ = batch.permanent_batch_kernel(stack, calc, device="cpu")
    assert got.shape == want.shape == (count,)
    assert got[-1] == want[-1] == 0.0
    for g, w, m in zip(got[:-1], want[:-1], stack):
        assert w == pytest.approx(perman64(m), rel=rel)
        assert g == pytest.approx(w, rel=rel)
        assert g == pytest.approx(perman64(m), rel=rel)


def test_batch_kernel_integer_stack_rounds_exactly():
    """An integer stack: the df64 values round to the reference's and to
    the exact permanents."""
    rng = np.random.default_rng(15)
    stack = np.stack([random_int_matrix(rng, 15, 0.5, vmax=3)
                      for _ in range(3)]).astype(np.float64)
    want = permanent_batch_pallas(stack, calc="df64")
    got, meta = batch.permanent_batch_kernel(stack, "df64", device="cpu",
                                             chunk_log2=5)
    assert meta["r"] == 5 and meta["exact_storage"] and meta["redo"] == 0
    exact = [round(perman64(m, dtype=np.longdouble)) for m in stack]
    assert [round(v) for v in got] == [round(v) for v in want] == exact
    assert all(e != 0 for e in exact)


@pytest.mark.parametrize("calc", TIERS)
def test_batch_kernel_bitwise_on_exact_f32_stack(calc):
    """0/1 stacks of n=16 where every product is exact in float32: the
    port equals the reference bit for bit in every tier, whatever the
    order of the two reductions, and both equal the permanent."""
    stack = _exact_f32_stack(np.random.default_rng(16), 16, 3)
    want = permanent_batch_pallas(stack, calc=calc)
    got, _ = batch.permanent_batch_kernel(stack, calc, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, [perman64(m) for m in stack])
    assert (got > 0).all()


def test_permanent_batch_matches_jax_on_mixed_list():
    """The entry point on orders 8, 8, 10, 12, 14, 14: values (rel 1e-9),
    the order of the results, the counterparts of the algorithm names and
    the iteration counts."""
    rng = np.random.default_rng(8)
    mats = [random_float_matrix(rng, n, 0.7) if i % 2 else
            random_int_matrix(rng, n, 0.6, vmax=3)
            for i, n in enumerate((8, 8, 10, 12, 14, 14))]
    want = sp.permanent_batch(mats)
    got = spt.permanent_batch(mats, device="cpu")
    names = {"ryser_xla_batch": "ryser_walk_batch",
             "ryser_pallas_batch_df64": "ryser_plain_batch_df64"}
    assert len(got) == len(want) == len(mats)
    for g, w, m in zip(got, want, mats):
        assert g.permanent == pytest.approx(w.permanent, rel=1e-9)
        assert g.permanent == pytest.approx(perman64(m), rel=1e-9)
        assert g.algo_name == names[w.algo_name]
        assert g.iterations == w.iterations == 1 << (m.shape[0] - 1)
    assert [g.algo_name for g in got] == ["ryser_walk_batch"] * 4 + \
        ["ryser_plain_batch_df64"] * 2
    assert got[4].meta["batch"] == 2 and not got[4].meta["exact_storage"]


@pytest.mark.parametrize("calc", ["f32", "f32k"])
def test_permanent_batch_calc_override_stays_batched(calc):
    """calc alone keeps the grouping, in both packages; small orders walk
    float64 whatever the tier."""
    rng = np.random.default_rng(9)
    mats = [random_float_matrix(rng, n, 0.6) for n in (14, 9, 14, 9)]
    want = sp.permanent_batch(mats, calc=calc)
    got = spt.permanent_batch(mats, device="cpu", calc=calc)
    rel = 1e-3 if calc == "f32k" else 1e-2
    for g, w, m in zip(got, want, mats):
        kernel = m.shape[0] >= 13
        assert w.algo_name == (f"ryser_pallas_batch_{calc}" if kernel
                               else "ryser_xla_batch")
        assert g.algo_name == (f"ryser_plain_batch_{calc}" if kernel
                               else "ryser_walk_batch")
        assert g.permanent == pytest.approx(w.permanent,
                                            rel=rel if kernel else 1e-12)


def test_permanent_batch_falls_back_with_a_warning(capsys):
    """Any override besides calc runs one by one through permanent(), and
    says so on stderr."""
    rng = np.random.default_rng(10)
    mats = [random_int_matrix(rng, 14, 0.5), random_int_matrix(rng, 14, 0.5)]
    got = spt.permanent_batch(mats, device="cpu", lanes=256)
    err = capsys.readouterr().err
    assert "falling back to one-by-one runs" in err and "lanes" in err
    want = sp.permanent_batch(mats, lanes=256)
    capsys.readouterr()                    # the reference warns as well
    for g, w in zip(got, want):
        assert g.algo_name == "ryser_walk_df64"
        assert w.algo_name == "ryser_xla_df64"
        assert g.permanent == w.permanent
    spt.permanent_batch(mats, device="cpu")
    assert capsys.readouterr().err == ""


def test_permanent_batch_redo_matches_jax():
    """A +-1 matrix of n=16: every row scales by 2^4 (|x| <= 9), so the
    scaled total is per / 2^64 with |per| ~ sqrt(16!) ~ 2^22, below the
    2^-40 underflow line.  Both packages re-run it through their
    single-matrix engine (the float64 walk at this order): rel 1e-10."""
    rng = np.random.default_rng(11)
    signs = np.where(rng.random((16, 16)) < 0.5, -1.0, 1.0)
    assert 0 < abs(perman64(signs)) < 2.0 ** 24
    mats = [signs, random_float_matrix(rng, 16, 0.7)]
    want = sp.permanent_batch(mats)
    got = spt.permanent_batch(mats, device="cpu")
    assert got[0].meta["redo"] == 1
    assert got[0].permanent == spt.permanent(signs, device="cpu").permanent
    for g, w, m in zip(got, want, mats):
        assert g.algo_name == "ryser_plain_batch_df64"
        assert g.permanent == pytest.approx(w.permanent, rel=1e-10)
        assert g.permanent == pytest.approx(perman64(m), rel=1e-10)


def test_permanent_batch_rejects(monkeypatch):
    a = random_int_matrix(np.random.default_rng(12), 14, 0.5)
    with pytest.raises(ValueError, match="matrix 1 is not square"):
        spt.permanent_batch([a, np.ones((3, 4))], device="cpu")
    for calc in ("amp", "quad"):
        with pytest.raises(ValueError, match="unsupported calc"):
            batch.permanent_batch_kernel(np.stack([a, a]), calc, device="cpu")
    # a tf96 stack must be exact in f32, matrix by matrix
    with pytest.raises(ValueError, match="exact-f32 storage"):
        batch.permanent_batch_kernel(np.stack([a, a + 0.5]), "tf96",
                                     device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spt.permanent_batch([a, a])
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.permanent_batch_kernel(np.stack([a, a]))


def _packed(stack, dtype=torch.float64):
    x0p, colsT, _, _ = batch.pack_stack(stack)
    return torch.as_tensor(x0p), torch.as_tensor(colsT)


@pytest.mark.parametrize("tier", TIERS)
def test_batch_body_is_the_chunk_body(tier):
    """Before its block reduction the batch's plain version equals the
    chunk kernel's plain version of each matrix at the same r, chunk for
    chunk and bit for bit: one body, two launchers."""
    n, r = 14, 4
    stack = _mixed_stack(np.random.default_rng(14), n, 3)
    x0s, colss = _packed(stack)
    hi, lo = ryser_cuda.batch_chunk_partials_ref(x0s, colss, n=n, r=r,
                                                 tier=tier)
    ids = torch.arange(1 << (n - 1 - r))
    for b in range(len(stack)):
        one = ryser_cuda.ryser_partials_ref(ids, x0s[b], colss[b], n=n, r=r,
                                            tier=tier)
        assert torch.equal(hi[b], one[:, 0]) and torch.equal(lo[b], one[:, 1])
    assert hi.dtype == (torch.float64 if tier == "df64" else torch.float32)


@pytest.mark.parametrize("tier,bound", [("df64", 2.0 ** -100),
                                        ("f32k", 2.0 ** -40),
                                        ("f32", 2.0 ** -21)])
def test_block_reduction_matches_float64_sum(tier, bound):
    """The block reduction (128 pairs -> 1, fixed halving order) against
    the exact sum of the same pairs, relative to the sum of magnitudes:
    df64 keeps a double-double (2^-100), f32k a compensated float32 pair
    (2^-40), f32 rounds at each of its 7 levels (7 * 2^-24 < 2^-21)."""
    from fractions import Fraction
    n, r = 13, 3
    stack = _mixed_stack(np.random.default_rng(13), n, 3)[:2]
    x0s, colss = _packed(stack)
    hi, lo = ryser_cuda.batch_chunk_partials_ref(x0s, colss, n=n, r=r,
                                                 tier=tier)
    out = ryser_cuda.batch_partials(x0s, colss, n=n, r=r, tier=tier)
    blocks = (1 << (n - 1 - r)) // ryser_cuda.BLOCK
    assert tuple(out.shape) == (2, blocks, 2) and out.dtype == hi.dtype
    assert torch.equal(out, ryser_cuda.block_reduce_ref(hi, lo, tier))
    hi, lo = hi.reshape(2, blocks, -1).numpy(), lo.reshape(2, blocks, -1).numpy()
    for b in range(2):
        for k in range(blocks):
            parts = [Fraction(float(v)) for v in hi[b, k]] + \
                [Fraction(float(v)) for v in lo[b, k]]
            got = Fraction(float(out[b, k, 0])) + Fraction(float(out[b, k, 1]))
            mag = sum(abs(p) for p in parts)
            assert mag > 0
            assert abs(got - sum(parts)) <= mag * Fraction(bound)


@pytest.mark.parametrize("n,batch_size,chunk_log2,want", [
    (24, 256, None, 14), (32, 16, None, 18), (13, 4096, None, 5),
    (13, 1, None, 1), (20, 8, 30, 12), (16, 3, 6, 6), (16, 3, 0, 1)])
def test_batch_plan(n, batch_size, chunk_log2, want):
    """r is the largest that gives 132 SMs 512 threads each over the whole
    batch, at least one full block a matrix (r <= n-8) and r >= 1; a
    given chunk_log2 is clamped the same way."""
    assert gray.batch_plan(n, batch_size, chunk_log2) == want


@pytest.mark.parametrize("bad,exc", [
    ({"x0s": torch.ones(2, 16, dtype=torch.float32)}, TypeError),
    ({"colss": torch.zeros(2, 12, 16, dtype=torch.float64)}, ValueError),
    ({"x0s": torch.ones(2, 40, dtype=torch.float64),
      "colss": torch.zeros(2, 13, 40, dtype=torch.float64)}, ValueError),
    ({"r": 7}, ValueError), ({"r": 0}, ValueError),
    ({"tier": "amp"}, ValueError),
    # one launch takes at most 65535 matrices (the grid's second dimension)
    ({"x0s": torch.ones(65536, 16, dtype=torch.float64)}, ValueError),
    ({"x0s": torch.ones(0, 16, dtype=torch.float64)}, ValueError),
])
def test_batch_wrapper_rejects_bad_inputs(bad, exc):
    args = {"x0s": torch.ones(2, 16, dtype=torch.float64),
            "colss": torch.zeros(2, 13, 16, dtype=torch.float64), "r": 3,
            "tier": "df64"}
    args.update(bad)
    with pytest.raises(exc):
        ryser_cuda.batch_partials(args["x0s"], args["colss"], n=14,
                                  r=args["r"], tier=args["tier"])


@pytest.mark.parametrize("n", [3, 7, 12])
def test_batch_same_n_matches_jax(n):
    """The small-order batched float64 walk against the reference's
    vmapped XLA walk: rel 1e-12 (same lanes and steps, only the product
    order inside torch.prod / jnp.prod differs)."""
    from superman_tpu.ops.batch import permanent_batch_same_n as jax_same_n
    rng = np.random.default_rng(n)
    stack = np.stack([random_float_matrix(rng, n, 0.8) for _ in range(3)])
    got = batch.permanent_batch_same_n(stack, torch.device("cpu"))
    want = jax_same_n(stack)
    assert got.shape == want.shape == (3,)
    assert np.allclose(got, want, rtol=1e-12, atol=0)
