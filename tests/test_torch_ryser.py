"""The port's walk against the JAX package's, module by module.

Inputs come from seeded numpy generators and go through both packages:
the JAX side runs its Pallas kernel in interpret mode on the CPU, the
port runs its kernel's plain PyTorch version (a CPU tensor).  The CUDA
kernel itself is tested on a card by tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superman_tpu.ops import gray as jgray
from superman_tpu.ops import ryser as jryser
from superman_tpu.ops.oracle import perman_brute
from superman_tpu.ops.ryser_pallas import ryser_partials as jax_partials
import superman_tpu_torch as spt
from superman_tpu_torch.ops import gray, ryser, ryser_cuda
from superman_tpu_torch.ops.scaled_walk import empty_line
from superman_tpu_torch.parallel import mesh as pmesh
from superman_tpu_torch.parallel import sharding
from tests.conftest import random_float_matrix, random_int_matrix


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores and slows the walks tenfold
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_walk(a, n_pad, ids, r, exact_storage):
    """Per-chunk partials hi + lo of the JAX df64 tier (interpret mode),
    as superman_tpu.parallel.sharding.compute_partials runs it."""
    x0_pair, cols_pair = jgray.pack_matrix(a, n_pad)
    cth, ctl = jryser.colst_pack(a, n_pad)
    n = a.shape[0]
    xhi, xlo, smid = jgray.chunk_init(
        jnp.asarray(ids.astype(np.int32)), x0_pair, cols_pair, n=n,
        n_pad=n_pad, r=r, df=not exact_storage)
    out = np.asarray(jax_partials(xhi, xlo, smid, cth, ctl, r=r, df=True,
                                  exact_storage=exact_storage,
                                  interpret=True), dtype=np.float64)
    return (out[:, 0] + out[:, 1]).reshape(-1), x0_pair, cols_pair


def _port_walk(ids, x0, cols, n, r):
    out = ryser_cuda.ryser_partials(
        torch.as_tensor(ids.reshape(-1), dtype=torch.int64),
        torch.as_tensor(x0), torch.as_tensor(cols), n=n, r=r).numpy()
    return out[:, 0] + out[:, 1]


def _both_walks_f32(a, ids, r, tier):
    """(JAX, port) per-chunk (hi, lo) float32 words of an f32 tier on the
    same pack and plan: the JAX kernel in interpret mode walks the hi
    words of its pairs, the port's plain version the pack rounded to
    float32, which is the same numbers."""
    n, n_pad = a.shape[0], gray.pad_n(a.shape[0])
    x0_pair, cols_pair = jgray.pack_matrix(a, n_pad)
    cth, ctl = jryser.colst_pack(a, n_pad)
    xhi, xlo, smid = jgray.chunk_init(
        jnp.asarray(ids.astype(np.int32)), x0_pair, cols_pair, n=n,
        n_pad=n_pad, r=r, df=False)
    out = np.asarray(jax_partials(xhi, xlo, smid, cth, ctl, r=r, df=False,
                                  exact_storage=True, kahan=tier == "f32k",
                                  interpret=True))
    want = np.stack([out[:, 0].reshape(-1), out[:, 1].reshape(-1)], axis=1)
    x0, cols = gray.from_jax_pack(x0_pair, cols_pair)
    got = ryser_cuda.ryser_partials(
        torch.as_tensor(ids.reshape(-1), dtype=torch.int64),
        torch.as_tensor(x0), torch.as_tensor(cols), n=n, r=r,
        tier=tier).numpy()
    assert got.dtype == want.dtype == np.float32
    return want, got


def _exact_product_matrix(rng, n):
    """0/1, one 1 in every row (a permutation) and two more in up to 14
    rows: x is +-1/2 or +-3/2 and never 0, so every product is
    +-3^j / 2^n with 3^j < 2^24 -- exact in float32, and never 0."""
    a = np.zeros((n, n))
    a[np.arange(n), rng.permutation(n)] = 1.0
    for row in rng.permutation(n)[:14]:
        free = np.flatnonzero(a[row] == 0)
        a[row, rng.choice(free, 2, replace=False)] = 1.0
    return a


def _chunk_ids(n, r):
    nchunks = 1 << (n - 1 - r)
    return np.concatenate([np.arange(min(nchunks // 2, 128)),
                           np.arange(nchunks - 128, nchunks)]).reshape(2, -1)


@pytest.mark.parametrize("tier", ["f32", "f32k"])
@pytest.mark.parametrize("n,r", [(14, 4), (26, 5)])
def test_f32_partials_bitwise_vs_jax(n, r, tier):
    """0/1 matrices whose products are exact in float32, row-scaled, at
    n_pad 16 and 32: the sums round, in the same order in both packages,
    so both words of every chunk match the reference bit for bit."""
    a = _exact_product_matrix(np.random.default_rng(n), n)
    a_s = np.ldexp(a, -ryser._row_scales(a)[:, None])
    want, got = _both_walks_f32(a_s, _chunk_ids(n, r), r, tier)
    assert np.array_equal(got, want)
    assert np.count_nonzero(got[:, 0]) > len(got) // 2


@pytest.mark.parametrize("tier", ["f32", "f32k"])
@pytest.mark.parametrize("n,r,min_same", [(14, 4, 0.9), (26, 5, 0.0)])
def test_f32_partials_same_steps_as_jax(n, r, min_same, tier):
    """Random 0/1 matrices at n_pad 16 and 32, where the port folds the
    product in the reference's order.  Where a product is inexact the
    reference's CPU backend may fuse a term's last multiply into the
    accumulator's add (one rounding where the port and the card's kernel
    make two), so chunks can differ in their last bits: at n=14, where
    most products are still exact, at least 9 in 10 match in both words;
    at any order all lie within 2^-20 of the largest partial."""
    a = (np.random.default_rng(n).random((n, n)) < 0.5).astype(np.float64)
    a_s = np.ldexp(a, -ryser._row_scales(a)[:, None])
    want, got = _both_walks_f32(a_s, _chunk_ids(n, r), r, tier)
    assert (got == want).all(axis=1).mean() >= min_same
    want = want.astype(np.float64).sum(axis=1)
    got = got.astype(np.float64).sum(axis=1)
    assert np.abs(got - want).max() <= 2.0 ** -20 * np.abs(want).max()


@pytest.mark.parametrize("tier", ["f32", "f32k"])
@pytest.mark.parametrize("kind,n,r", [("int", 21, 6), ("real", 20, 5)])
def test_f32_partials_match_jax_other_orders(kind, n, r, tier):
    """n_pad = 24: the reference folds 8-row groups first, the port the
    upper half onto the lower, so each product differs in its last bits
    (21 roundings of 2^-24); over 2^r terms the partials agree within
    1e-5 of the largest one."""
    rng = np.random.default_rng(300 + n)
    a = (random_int_matrix(rng, n, 0.5, vmax=3) if kind == "int"
         else random_float_matrix(rng, n, 0.5))
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    want, got = _both_walks_f32(a_s, _chunk_ids(n, r), r, tier)
    want = want.astype(np.float64).sum(axis=1)
    got = got.astype(np.float64).sum(axis=1)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("tier", ["f32", "f32k"])
def test_f32_sentinels_and_dtype(tier):
    """ids < 0 give an exact (0, 0) in the f32 tiers too."""
    a = random_int_matrix(np.random.default_rng(7), 12, 0.6)
    x0, cols = (torch.as_tensor(v) for v in gray.pack_matrix(
        a, gray.pad_n(12)))
    ids = torch.tensor([0, -1, 3, -1])
    out = ryser_cuda.ryser_partials(ids, x0, cols, n=12, r=3, tier=tier)
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 2)
    assert torch.equal(out[ids < 0], torch.zeros(2, 2))
    assert (out[ids >= 0, 0] != 0).all()


def test_f32k_accumulator_is_compensated():
    """hi + lo of an f32k chunk is the sum of its float32 terms to ~2^-40
    of their magnitude; the f32 tier's plain sum is only good to ~2^-20."""
    from fractions import Fraction
    n, r = 10, 8
    a = random_float_matrix(np.random.default_rng(3), n, 0.8)
    x0, cols = (torch.as_tensor(v) for v in gray.pack_matrix(
        a, gray.pad_n(n)))
    ids = torch.tensor([0, 1])
    x, sign_mid = gray.chunk_init(ids, x0.float(), cols.float(), n, r)
    terms = [ryser_cuda.tree_prod(x)]
    for m in range(1, 1 << r):
        k = (m & -m).bit_length() - 1
        s = (sign_mid[:, None] if k == r - 1
             else (-1.0 if (m >> (k + 1)) & 1 else 1.0))
        x = x + s * cols.float()[k]
        t = ryser_cuda.tree_prod(x)
        terms.append(-t if m & 1 else t)
    for tier, bound in (("f32k", 2.0 ** -40), ("f32", 2.0 ** -16)):
        out = ryser_cuda.ryser_partials(ids, x0, cols, n=n, r=r, tier=tier)
        for c in range(2):
            exact = sum(Fraction(float(t[c])) for t in terms)
            mag = sum(abs(Fraction(float(t[c]))) for t in terms)
            got = Fraction(float(out[c, 0])) + Fraction(float(out[c, 1]))
            assert abs(got - exact) <= mag * Fraction(bound)


@pytest.mark.parametrize("n,r,vmax", [(10, 4, 1), (21, 6, 3)])
def test_chunk_init_matches_jax(n, r, vmax):
    """x of every chunk equals the JAX df64 init's hi + lo exactly on
    integer matrices; sentinel ids give x = 0 in both."""
    a = random_int_matrix(np.random.default_rng(100 + n), n, 0.5, vmax)
    n_pad = gray.pad_n(n)
    nchunks = 1 << (n - 1 - r)
    ids = np.concatenate([np.arange(min(nchunks, 96)),
                          np.arange(nchunks - 30, nchunks), [-1, -1]])
    x0_pair, cols_pair = jgray.pack_matrix(a, n_pad)
    xhi, xlo, smid = jgray.chunk_init(
        jnp.asarray(ids.astype(np.int32)[None]), x0_pair, cols_pair, n=n,
        n_pad=n_pad, r=r, df=True)
    want_x = (np.asarray(xhi, np.float64) + np.asarray(xlo, np.float64))[0].T
    x0, cols = gray.from_jax_pack(x0_pair, cols_pair)
    x, sign_mid = gray.chunk_init(torch.as_tensor(ids), torch.as_tensor(x0),
                                  torch.as_tensor(cols), n, r)
    assert np.array_equal(x.numpy(), want_x)
    assert np.array_equal(sign_mid.numpy(), np.asarray(smid)[0, 0])


def test_partials_bitwise_vs_jax_n10():
    """0/1 matrix, unscaled, n=10, r=4: every x is k/2 with |k| <= 10,
    so every term is a multiple of 2^-10 and every chunk's partial has
    fewer than 46 significant bits — exact in both packages.  The
    partials must then match bitwise, and sum to perman_brute."""
    n, r = 10, 4
    a = (np.random.default_rng(10).random((n, n)) < 0.5).astype(np.int64)
    rowsum = int(a.sum(axis=1).max())
    # |prod_j 2 x_j| <= rowsum^n per term, 2^r terms per chunk
    assert rowsum ** n * (1 << r) < 2 ** 46
    n_pad = gray.pad_n(n)
    ids = np.arange(1 << (n - 1 - r)).reshape(2, -1)
    want, x0_pair, cols_pair = _jax_walk(a, n_pad, ids, r,
                                         exact_storage=True)
    x0, cols = gray.from_jax_pack(x0_pair, cols_pair)
    got = _port_walk(ids, x0, cols, n, r)
    assert np.array_equal(got, want)
    assert (4 * (n & 1) - 2) * got.sum() == perman_brute(a) != 0


@pytest.mark.parametrize("kind,n,r", [("int", 21, 6), ("int", 20, 5),
                                      ("real", 20, 5)])
def test_partials_match_jax_large(kind, n, r):
    """n=20-21, row-scaled as the engine scales: integer vmax=3 (JAX
    exact_storage path) and real-valued (JAX full-pair path).  The JAX
    tier carries each term to ~2^-44 in f32 pairs, the port to ~2^-50 in
    float64, so the partials agree within 1e-11 of the largest one."""
    rng = np.random.default_rng(200 + n)
    a = (random_int_matrix(rng, n, 0.5, vmax=3) if kind == "int"
         else random_float_matrix(rng, n, 0.5))
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    nchunks = 1 << (n - 1 - r)
    ids = np.concatenate([np.arange(256),
                          np.arange(nchunks - 256, nchunks)]).reshape(2, -1)
    want, x0_pair, cols_pair = _jax_walk(a_s, gray.pad_n(n), ids, r,
                                         exact_storage=(kind == "int"))
    x0, cols = gray.from_jax_pack(x0_pair, cols_pair)
    got = _port_walk(ids, x0, cols, n, r)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-11 * scale


def test_sentinel_ids_give_zero():
    """ids < 0 give an exact (0, 0) and leave the live chunks as they
    are without sentinels."""
    a = random_int_matrix(np.random.default_rng(7), 12, 0.6)
    n, r = 12, 3
    x0, cols = (torch.as_tensor(v) for v in gray.pack_matrix(
        a, gray.pad_n(n)))
    live = torch.arange(1 << (n - 1 - r))
    mixed = torch.cat([live[:5], torch.full((7,), -1), live[5:]])
    out_live = ryser_cuda.ryser_partials(live, x0, cols, n=n, r=r)
    out = ryser_cuda.ryser_partials(mixed, x0, cols, n=n, r=r)
    assert torch.equal(out[5:12], torch.zeros(7, 2, dtype=torch.float64))
    assert torch.equal(torch.cat([out[:5], out[12:]]), out_live)


def test_accumulator_is_double_double():
    """Each chunk's (hi, lo) is the exact sum of its float64 terms to
    ~2^-100 of their magnitude, far past a plain float64 sum (~2^-53).
    The terms are rebuilt step by step in numpy with the same IEEE
    operations and summed exactly as fractions."""
    from fractions import Fraction
    n, r = 10, 8
    a = random_float_matrix(np.random.default_rng(3), n, 0.8)
    x0, cols = gray.pack_matrix(a, gray.pad_n(n))
    ids = np.array([0, 1], dtype=np.int64)
    out = ryser_cuda.ryser_partials(torch.as_tensor(ids), torch.as_tensor(x0),
                                    torch.as_tensor(cols), n=n, r=r).numpy()
    x, sign_mid = (t.numpy() for t in gray.chunk_init(
        torch.as_tensor(ids), torch.as_tensor(x0), torch.as_tensor(cols),
        n, r))
    def prod(v):
        return ryser_cuda.tree_prod(torch.as_tensor(v)).numpy()

    terms = [prod(x)]
    for m in range(1, 1 << r):
        k = (m & -m).bit_length() - 1
        s = (sign_mid[:, None] if k == r - 1
             else (-1.0 if (m >> (k + 1)) & 1 else 1.0))
        x = x + s * cols[k]
        terms.append(-prod(x) if m & 1 else prod(x))
    for c in range(len(ids)):
        exact = sum(Fraction(float(t[c])) for t in terms)
        got = Fraction(float(out[c, 0])) + Fraction(float(out[c, 1]))
        mag = sum(abs(Fraction(float(t[c]))) for t in terms)
        assert abs(got - exact) <= mag * Fraction(1, 2 ** 100)
        assert out[c, 1] != 0.0          # the low word carries bits


@pytest.mark.parametrize("bad,exc", [
    ({"ids": torch.arange(4, dtype=torch.int32)}, TypeError),
    ({"x0": torch.ones(16, dtype=torch.float32)}, TypeError),
    ({"cols": torch.zeros(9, 32, dtype=torch.float64)}, ValueError),
    ({"r": 9}, ValueError),
    ({"tier": "amp"}, ValueError),
    ({"x0": torch.ones(72, dtype=torch.float64),
      "cols": torch.zeros(9, 72, dtype=torch.float64)}, ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, exc):
    args = {"ids": torch.arange(4), "x0": torch.ones(16, dtype=torch.float64),
            "cols": torch.zeros(9, 16, dtype=torch.float64), "r": 3}
    args.update(bad)
    with pytest.raises(exc):
        ryser_cuda.ryser_partials(args["ids"], args["x0"], args["cols"],
                                  n=10, r=args["r"],
                                  tier=args.get("tier", "df64"))


@pytest.mark.parametrize("n,lanes,chunk_log2", [
    (21, 256, 6), (20, 1024, 5), (24, 512, 30), (19, 64, 1), (32, 1024, 14)])
def test_make_plan_matches_jax_when_given(n, lanes, chunk_log2):
    assert gray.make_plan(n, lanes, chunk_log2).__dict__ == \
        jgray.make_plan(n, lanes, chunk_log2, df=True).__dict__


def test_default_plan_fills_the_card():
    """No chunk_log2: the smallest power-of-two chunk count that gives
    132 SMs 512 threads each (2^17 at n=32), never below r=1."""
    plan = gray.make_plan(32)
    assert (plan.r, plan.num_chunks, plan.n_pad) == (14, 1 << 17, 32)
    assert gray.make_plan(32, sms=66).num_chunks == 1 << 16
    assert gray.make_plan(19).r == 1


def _jax_empty_line(a) -> bool:
    """The JAX package's inline test of one matrix for an empty row or
    column (ryser.py, glynn.py)."""
    return bool((np.count_nonzero(a, axis=1) == 0).any()
                or (np.count_nonzero(a, axis=0) == 0).any())


@pytest.mark.parametrize("kind", ["int", "real", "sparse", "empty_row",
                                  "empty_col", "stack"])
def test_host_helpers_match_jax(kind):
    """Row scales, centring, pack, the exact-storage decision and the
    empty-line test equal the reference's outputs.  On a (B, n, n) stack,
    pack_stack's input, the row scales equal the reference's matrix by
    matrix and the empty-line test its batch's inline test."""
    rng = np.random.default_rng({"int": 1, "real": 2, "sparse": 3,
                                 "empty_row": 4, "empty_col": 5,
                                 "stack": 6}[kind])
    if kind == "stack":
        stack = np.stack([random_int_matrix(rng, 22, 0.5),
                          random_float_matrix(rng, 22, 0.5),
                          random_int_matrix(rng, 22, 0.3),
                          random_int_matrix(rng, 22, 0.5),
                          random_int_matrix(rng, 22, 0.5)])
        stack[3, 5] = 0
        stack[4, :, 7] = 0
        assert np.array_equal(ryser._row_scales(stack),
                              np.stack([jryser._row_scales(m)
                                        for m in stack]))
        # superman_tpu/ops/batch.py's test of a stack
        zero = (((stack != 0).sum(axis=2) == 0).any(axis=1)
                | ((stack != 0).sum(axis=1) == 0).any(axis=1))
        assert list(empty_line(stack)) == list(zero) == \
            [_jax_empty_line(m) for m in stack] == [False] * 3 + [True] * 2
        return
    a = {"int": lambda: random_int_matrix(rng, 22, 0.5),
         "real": lambda: random_float_matrix(rng, 22, 0.5),
         "sparse": lambda: random_int_matrix(rng, 30, 0.15),
         "empty_row": lambda: random_int_matrix(rng, 22, 0.5),
         "empty_col": lambda: random_int_matrix(rng, 22, 0.5)}[kind]()
    if kind == "empty_row":
        a[3] = 0
    elif kind == "empty_col":
        a[:, 3] = 0
    assert bool(empty_line(a)) == _jax_empty_line(a) == kind.startswith(
        "empty")
    from superman_tpu.core.matrix import DenseMatrix as JDense
    from superman_tpu_torch.core.matrix import DenseMatrix
    tname = "int" if kind != "real" else "double"
    s = ryser._row_scales(a)
    assert np.array_equal(s, jryser._row_scales(a))
    assert np.array_equal(ryser._center_scales(a, s),
                          jryser._center_scales(a, s))
    assert ryser._log2_perm_estimate(a) == jryser._log2_perm_estimate(a)
    assert ryser._exact_storage(DenseMatrix(a, tname)) == \
        jryser._exact_storage(JDense(a, tname))
    a_s = np.ldexp(a.astype(np.float64), -s[:, None])
    n_pad = gray.pad_n(a.shape[0])
    x0, cols = gray.pack_matrix(a_s, n_pad)
    jx0, jcols = gray.from_jax_pack(*jgray.pack_matrix(a_s, n_pad))
    if kind == "real":
        # the JAX pack keeps ~48 bits in its f32 pair
        assert np.allclose(x0, jx0, rtol=2.0 ** -46, atol=0)
        assert np.allclose(cols, jcols, rtol=2.0 ** -46, atol=0)
    else:
        assert np.array_equal(x0, jx0) and np.array_equal(cols, jcols)


# ---- the row-scale probe: bit masks and one block of words

PROBE_SUITE = [(n, d) for n in (20, 24, 30, 32, 36, 38, 40)
               for d in (0.10, 0.15, 0.50, 0.90)]
PROBE_OTHER = ["float22", "float32", "one_live", "some_die", "all_die",
               "runner", "compress", "keywords"]


def _probe_matrices(case):
    """(matrix, keywords) pairs of one case of the probe test."""
    from permbench.gen import suite_matrix
    if isinstance(case, tuple):
        n, d = case
        return [(suite_matrix(np.random.default_rng([n, int(d * 100), s]),
                              n, d), {}) for s in range(3)]
    rng = np.random.default_rng(PROBE_OTHER.index(case))

    def signed(n):
        a = random_float_matrix(rng, n, 0.5)
        return a * rng.choice([-1.0, 1.0], size=a.shape)

    def dense_rest(n):
        a = random_int_matrix(rng, n, 0.9)
        np.fill_diagonal(a, 1)
        return a

    if case in ("float22", "float32"):
        return [(signed(int(case[-2:])), {}) for _ in range(3)]
    if case == "one_live":
        # the sparsest rows have one live column: integers(1) takes no word
        a = dense_rest(24)
        for r in range(4):
            a[r] = 0
            a[r, 2 * r + 1] = 3
        return [(a, {})]
    if case == "some_die":
        # rows 0-2 on a 3-cycle of columns 0-2: a trial dies where row 0
        # takes column 0 and row 1 column 2
        a = dense_rest(24)
        a[:3] = 0
        a[:, :3] = 0
        a[0, [0, 1]] = [1, 2]
        a[1, [1, 2]] = [3, 1]
        a[2, [0, 2]] = [2, 4]
        first = [ryser._log2_perm_estimate_plain(a, trials=1, seed=s)
                 for s in range(16)]
        assert None in first and any(f is not None for f in first)
        return [(a, {}), *((a, {"trials": 1, "seed": s}) for s in range(4))]
    if case == "all_die":
        # rows 12-23 share the 11 columns 13-23: every trial dies
        a = dense_rest(24)
        a[12:, :13] = 0
        return [(a, {})]
    if case == "runner":
        # the runner's magnitude check after compression passes |A|
        return [(np.abs(signed(30)), {})]
    if case == "compress":
        # the compression route passes the matrix it compresses:
        # rows and columns scaled over many orders of magnitude
        a = random_int_matrix(rng, 32, 0.5).astype(np.float64)
        np.fill_diagonal(a, 2.0)
        return [(a * np.exp2(rng.integers(-40, 40, 32))[:, None]
                 * np.exp2(rng.integers(-40, 40, 32))[None, :], {})]
    a = random_int_matrix(rng, 32, 0.5)
    np.fill_diagonal(a, 1)
    return [(a, kw) for kw in ({"trials": 6, "seed": 12345},
                               {"trials": 1, "seed": 0},
                               {"trials": 9, "seed": 2 ** 31 + 17},
                               {"trials": 6, "seed": 2 ** 40 + 3})]


@pytest.mark.parametrize("case", PROBE_SUITE + PROBE_OTHER, ids=str)
def test_log2_perm_estimate_is_the_plain_loop_and_jax(case):
    """The probe on bit masks and one block of words returns the same
    float (None for None) as the plain loop kept beside it and as the
    reference's, and the centred scales equal the reference's."""
    for a, kw in _probe_matrices(case):
        est = ryser._log2_perm_estimate(a, **kw)
        plain = ryser._log2_perm_estimate_plain(a, **kw)
        ref = jryser._log2_perm_estimate(a, **kw)
        assert (est is None) == (plain is None) == (ref is None)
        assert est is None or est == plain == ref
        if case == "all_die":
            assert est is None
        s = ryser._row_scales(a)
        assert np.array_equal(ryser._center_scales(a, s),
                              jryser._center_scales(a, s))


def test_log2_perm_estimate_falls_back_when_the_words_run_short(
        monkeypatch):
    """A block too short for the draws runs the plain loop: the same
    estimate, counted under "plain"; a normal call counts under
    "masks"."""
    a = random_int_matrix(np.random.default_rng(11), 24, 0.5)
    np.fill_diagonal(a, 1)
    want = ryser._log2_perm_estimate_plain(a)
    before = dict(ryser.ESTIMATE_PATHS)
    assert ryser._log2_perm_estimate(a) == want
    assert ryser.ESTIMATE_PATHS["masks"] == before.get("masks", 0) + 1
    assert ryser.ESTIMATE_PATHS["plain"] == before.get("plain", 0)
    monkeypatch.setattr(ryser, "_ESTIMATE_SLACK", 5 - 6 * 24)
    assert ryser._log2_perm_estimate(a) == want
    assert ryser.ESTIMATE_PATHS["plain"] == before.get("plain", 0) + 1
    assert ryser.ESTIMATE_PATHS["masks"] == before.get("masks", 0) + 1


# ---- the dense walk's total, summed block by block (ryser_blocks)

#: (n, chunk_log2): the card's plan at n=19 (2^17 chunks of 2 steps) and
#: n=24 (2^17 of 2^6), and 64 chunks of 2^12 steps: fewer than a block
DENSE_CASES = [(19, None), (24, None), (19, 12)]
BLOCK_TIERS = ["df64", "f32", "f32k"]
CPU = torch.device("cpu")


def _dense_walk(n, chunk_log2=None, lanes=1024):
    """(plan, x0, cols) of a seeded integer matrix, row-scaled as the
    engine scales it, on the plan the engine makes on the CPU."""
    a = random_int_matrix(np.random.default_rng(n), n, 0.5)
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    plan = gray.make_plan(n, lanes, chunk_log2)
    return (plan,) + gray.pack_matrix(a_s, plan.n_pad)


def _every_row(plan):
    return torch.arange(-(-plan.num_chunks // plan.lanes))


@pytest.mark.parametrize("tier", BLOCK_TIERS)
@pytest.mark.parametrize("n,chunk_log2", DENSE_CASES)
def test_dense_blocks_are_the_chunk_walk_summed_by_block(n, chunk_log2,
                                                         tier):
    """ryser_blocks over every block row is ryser_reduced_ref with no
    factored row on the ids the kernel derives, bit for bit.  Those ids
    are the dense layout (pad_ids of every chunk id), each row padded to
    whole blocks of 128; and each block is the per-chunk walk
    (ryser_partials), widened to a double-double, summed in the kernel's
    halving order."""
    plan, x0, cols = _dense_walk(n, chunk_log2)
    rows = _every_row(plan)
    x0_t, cols_t = torch.as_tensor(x0), torch.as_tensor(cols)
    got = ryser_cuda.ryser_blocks(rows, x0_t, cols_t, n=n, r=plan.r,
                                  lanes=plan.lanes,
                                  num_chunks=plan.num_chunks, tier=tier)
    ids = ryser_cuda.block_ids(rows, plan.lanes, plan.num_chunks)
    want = ryser_cuda.ryser_reduced_ref(ids, x0_t, cols_t, x0_t.new_empty(0),
                                        x0_t.new_empty((n - 1, 0)), n=n,
                                        r=plan.r, tier=tier)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    per_row = -(-plan.lanes // 128)
    assert got.shape == (len(rows) * per_row, 2)
    layout = np.full((len(rows), per_row * 128), -1, dtype=np.int64)
    layout[:, :plan.lanes] = sharding.pad_ids(np.arange(plan.num_chunks),
                                              plan.lanes)
    assert np.array_equal(ids.numpy(), layout.reshape(-1))
    part = ryser_cuda.ryser_partials(ids, x0_t, cols_t, n=n, r=plan.r,
                                     tier=tier)
    hi, lo = part[:, 0].double(), part[:, 1].double()
    if tier != "df64":
        hi, lo = hi + lo, torch.zeros_like(hi)
    assert torch.equal(got, ryser_cuda.block_reduce_ref(hi[None], lo[None],
                                                        "df64")[0])


@pytest.mark.parametrize("tier", BLOCK_TIERS)
@pytest.mark.parametrize("n,chunk_log2", DENSE_CASES)
def test_dense_total_is_the_sum_of_the_chunks(n, chunk_log2, tier):
    """compute_total's dense route (the blocks summed on the card, their
    pairs on the host) against the float64 sum of compute_partials: within
    1e-13 in every tier, which add the same float64 chunk values in
    another order."""
    plan, x0, cols = _dense_walk(n, chunk_log2)
    total = sharding.compute_total(x0, cols, plan, CPU, tier)
    ids = sharding.pad_ids(np.arange(plan.num_chunks), plan.lanes)
    want = sharding.compute_partials(ids, x0, cols, plan, CPU, tier).sum()
    assert isinstance(total, float)
    assert abs(total - want) <= 1e-13 * abs(want)


@pytest.mark.parametrize("tier", BLOCK_TIERS)
@pytest.mark.parametrize("k", [2, 3, 4])
def test_dense_blocks_are_bitwise_over_a_mesh_and_processes(k, tier):
    """The block pairs over a mesh of k CPU entries, and the k processes'
    shares (host_slice) put back in row order, are the single device's
    bit for bit; so is the mesh's total.  200 lanes: two blocks a row, the
    second part sentinel, and a last row past the plan's chunks."""
    plan, x0, cols = _dense_walk(19, 6, lanes=200)
    one = sharding._block_words(x0, cols, plan, CPU, tier)
    mesh = pmesh.make_mesh(devices=["cpu"] * k)
    assert np.array_equal(sharding._block_words(x0, cols, plan, CPU, tier,
                                                mesh), one)
    rows = one.reshape(-1, 2, 2)
    dealt = np.empty_like(rows)
    for p in range(k):
        share = sharding._block_words(x0, cols, plan, CPU, tier,
                                      host=(p, k))
        assert len(share) == sharding.total_words(plan, tier, host=(p, k))
        dealt[p::k] = share.reshape(-1, 2, 2)
    assert np.array_equal(dealt, rows)
    assert sharding.compute_total(x0, cols, plan, CPU, tier,
                                  mesh=mesh) == \
        sharding.compute_total(x0, cols, plan, CPU, tier)


@pytest.mark.parametrize("n,chunk_log2,tier", [
    (19, None, "df64"), (24, None, "f32"), (19, 12, "f32k"),
    (19, None, "tf96")])
def test_walk_words_counts_the_pairs_the_host_sums(n, chunk_log2, tier):
    """permanent()'s meta["walk_words"]: one pair a block of 128 chunks
    (num_chunks / 128; one block below 128 chunks), and in tf96, which
    keeps its per-chunk words, one a chunk slot."""
    a = random_int_matrix(np.random.default_rng(n), n, 0.5)
    res = spt.permanent(a, device="cpu", calc=tier, chunk_log2=chunk_log2)
    plan = gray.make_plan(n, 1024, chunk_log2)
    assert res.meta["chunks"] == plan.num_chunks
    want = (-(-plan.num_chunks // 1024) * plan.lanes if tier == "tf96"
            else -(-plan.num_chunks // 128))
    assert res.meta["walk_words"] == want
    if chunk_log2 is None and tier != "tf96":
        assert want == plan.num_chunks // 128 == 1024


def test_dense_total_makes_its_own_ids():
    """The dense route takes no id list (the ids are made on the card); a
    block row list that is not int64, and tf96, are refused; a row outside
    the plan gives sentinels only, so its blocks are zero."""
    plan, x0, cols = _dense_walk(19, 6)
    outside = ryser_cuda.ryser_blocks(
        torch.tensor([-1, 4]), torch.as_tensor(x0), torch.as_tensor(cols),
        n=19, r=6, lanes=plan.lanes, num_chunks=plan.num_chunks)
    assert outside.shape == (16, 2) and not outside.any()
    ids = sharding.pad_ids(np.arange(plan.num_chunks), plan.lanes)
    with pytest.raises(TypeError, match="ids"):
        sharding.compute_total(x0, cols, plan, CPU, ids=ids)
    with pytest.raises(TypeError, match="int64"):
        ryser_cuda.ryser_blocks(torch.arange(2, dtype=torch.int32),
                                torch.as_tensor(x0), torch.as_tensor(cols),
                                n=19, r=6, lanes=plan.lanes,
                                num_chunks=plan.num_chunks)
    with pytest.raises(ValueError, match="tier"):
        ryser_cuda.ryser_blocks(_every_row(plan), torch.as_tensor(x0),
                                torch.as_tensor(cols), n=19, r=6,
                                lanes=plan.lanes,
                                num_chunks=plan.num_chunks, tier="tf96")
