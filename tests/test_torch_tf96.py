"""The port's tf96 tier against the JAX package's and against exact
arithmetic.

The JAX tier is an f32 triple (~72 bits), the port's a double-double
(~104 bits), so the two cannot agree word for word: both are held to
exact rational values (python Fractions, exact integers), each within
its own contract, on the same seeded inputs.  The JAX side runs its
Pallas kernel in interpret mode on the CPU, the port its kernels' plain
PyTorch versions (CPU tensors).
"""

import math
import warnings
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu.ops import gray as jgray
from superman_tpu.ops import ryser as jryser
from superman_tpu.ops.oracle import perman_brute
from superman_tpu.ops.ryser_pallas import ryser_partials as jax_partials
from superman_tpu.ops.tf96 import tree_prod_tf96
from superman_tpu_torch.ops import batch, gray, ryser, ryser_cuda, tf96
from superman_tpu_torch.ops.oracle import perman64
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


def _frac(v) -> Fraction:
    return Fraction(float(v))


def test_two_prod_is_the_fma_error():
    """The Dekker/Veltkamp TwoProd is exact: p + e == a * b as rationals,
    which is what fma(a, b, -p) returns on the card."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal(64) * 2.0 ** rng.integers(-30, 30, 64))
    b = torch.as_tensor(rng.standard_normal(64) * 2.0 ** rng.integers(-30, 30, 64))
    p, e = tf96.two_prod(a, b)
    for i in range(64):
        assert _frac(p[i]) + _frac(e[i]) == _frac(a[i]) * _frac(b[i])
        assert abs(float(e[i])) <= abs(float(p[i])) * 2.0 ** -53


@pytest.mark.parametrize("s", [8, 16, 24, 32, 40])
def test_tree_prod_against_exact_fractions(s):
    """Full-mantissa exact-f32 inputs, the product tree against the exact
    Fraction product: the port's double-double within 2^-98 relative, the
    JAX tree_prod_tf96 on the same inputs within 2^-66 (its own contract,
    tests/test_tf96.py)."""
    rng = np.random.default_rng(s)
    m = rng.integers(2 ** 23, 2 ** 24, size=(s, 6)).astype(np.float64)
    x = (m * rng.choice([-1.0, 1.0], size=(s, 6)) * 2.0 ** -23
         ).astype(np.float32)
    hi, lo = tf96.tree_prod_dd(torch.as_tensor(x.T.astype(np.float64)))
    jw = [np.asarray(w, np.float64).ravel()
          for w in tree_prod_tf96(jnp.asarray(x))]
    for lane in range(6):
        exact = Fraction(1)
        for i in range(s):
            exact *= _frac(x[i, lane])
        got = _frac(hi[lane]) + _frac(lo[lane])
        assert abs((got - exact) / exact) < Fraction(1, 2 ** 98)
        jgot = sum(_frac(w[lane]) for w in jw)
        assert abs((jgot - exact) / exact) < Fraction(1, 2 ** 66)


@pytest.mark.parametrize("s", [8, 24, 40, 56, 64])
def test_unnormalised_tree_against_exact_fractions(s):
    """The tree as it now multiplies, un-normalised from its second level
    on and normalised once at the root, on full-mantissa doubles (not
    only exact-f32 ones) against the exact Fraction product: within 2^-99
    relative (at most 6 levels of multiplies above the exact TwoProds,
    each within 2^-102 of its operands' product), and the root's pair is
    normalised, |lo| <= ulp(hi) / 2."""
    rng = np.random.default_rng(100 + s)
    x = rng.uniform(0.5, 1.0, (64, s)) * rng.choice([-1.0, 1.0], (64, s))
    hi, lo = tf96.tree_prod_dd(torch.as_tensor(x))
    for lane in range(64):
        exact = Fraction(1)
        for v in x[lane]:
            exact *= _frac(v)
        got = _frac(hi[lane]) + _frac(lo[lane])
        assert abs((got - exact) / exact) <= Fraction(1, 2 ** 99)
        assert abs(float(lo[lane])) <= math.ulp(float(hi[lane])) / 2
    # the same levels normalised after every multiply differ only below
    # the tolerance: the renormalisation buys no accuracy
    p, e = tf96.two_prod(torch.as_tensor(x[:, : s // 2]),
                         torch.as_tensor(x[:, s // 2:]))
    while p.shape[-1] > 1:
        k = p.shape[-1]
        ns, h = (k + 1) // 2, k // 2
        ph, pl = tf96.dd_mul(p[:, :h], e[:, :h], p[:, ns:k], e[:, ns:k])
        p = torch.cat([ph, p[:, h:ns]], dim=-1)
        e = torch.cat([pl, e[:, h:ns]], dim=-1)
    for lane in range(64):
        diff = (_frac(hi[lane]) + _frac(lo[lane])
                - _frac(p[lane, 0]) - _frac(e[lane, 0]))
        assert abs(diff) <= abs(_frac(hi[lane])) * Fraction(1, 2 ** 98)


def test_dd_mul_is_the_unnormalised_product_renormalised():
    """dd_mul is dd_mul_unnorm and a FastTwoSum, bit for bit; the
    un-normalised product keeps hi and the unrounded low word."""
    rng = np.random.default_rng(2)
    ah, bh = (torch.as_tensor(rng.standard_normal(100)) for _ in range(2))
    al = ah * 2.0 ** -55 * torch.as_tensor(rng.uniform(-1, 1, 100))
    bl = bh * 2.0 ** -55 * torch.as_tensor(rng.uniform(-1, 1, 100))
    uh, ul = tf96.dd_mul_unnorm(ah, al, bh, bl)
    mh, ml = tf96.dd_mul(ah, al, bh, bl)
    qh, ql = tf96.quick_two_sum(uh, ul)
    assert torch.equal(mh, qh) and torch.equal(ml, ql)
    assert torch.equal(uh, ah * bh)


def test_dd_add_and_mul_error():
    """dd_add and dd_mul on random double-doubles against Fractions:
    within 2^-102 of the larger operand (add) and of the product (mul)."""
    rng = np.random.default_rng(1)
    def pair():
        hi = rng.standard_normal(200)
        lo = hi * 2.0 ** -54 * rng.uniform(-1, 1, 200)
        hi, lo = (torch.as_tensor(v) for v in (hi, lo))
        return tf96.quick_two_sum(hi, lo)
    (ah, al), (bh, bl) = pair(), pair()
    sh, sl = tf96.dd_add(ah, al, bh, bl)
    ph, pl = tf96.dd_mul(ah, al, bh, bl)
    for i in range(200):
        a, b = _frac(ah[i]) + _frac(al[i]), _frac(bh[i]) + _frac(bl[i])
        assert abs(_frac(sh[i]) + _frac(sl[i]) - (a + b)) <= \
            max(abs(a), abs(b)) * Fraction(1, 2 ** 102)
        assert abs(_frac(ph[i]) + _frac(pl[i]) - a * b) <= \
            abs(a * b) * Fraction(1, 2 ** 102)


def _exact_chunk(a_s, chunk, r):
    """(sum, sum of magnitudes) of the 2^r signed Ryser terms of one
    aligned chunk of the scaled integer matrix a_s, as Fractions."""
    n = a_s.shape[0]
    af = [[_frac(v) for v in row] for row in a_s]
    x0 = [af[j][n - 1] - sum(af[j]) / 2 for j in range(n)]
    total, mag = Fraction(0), Fraction(0)
    for m in range(1 << r):
        i = (chunk << r) + m
        g = i ^ (i >> 1)
        term = Fraction(1 if i % 2 == 0 else -1)
        for j in range(n):
            term *= x0[j] + sum(af[j][k] for k in range(n - 1) if (g >> k) & 1)
        total += term
        mag += abs(term)
    return total, mag


@pytest.mark.parametrize("n,r", [(14, 4), (20, 6)])
def test_chunk_partials_against_exact_chunk_sums(n, r):
    """Per-chunk partials of an integer matrix, row-scaled as the engine
    scales it, against the exact rational sum of the chunk's terms: the
    port's plain tf96 walk within 2^-95 of the chunk's sum of |terms|, the
    JAX kernel (interpret mode, tf=True, the same chunk ids and r) within
    2^-64."""
    a = random_int_matrix(np.random.default_rng(n), n, 0.5, vmax=3)
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    n_pad = gray.pad_n(n)
    nchunks = 1 << (n - 1 - r)
    ids = np.array([0, 1, 2, 5, nchunks // 2, nchunks - 2, nchunks - 1, 3])
    x0_pair, cols_pair = jgray.pack_matrix(a_s, n_pad)
    cth, ctl = jryser.colst_pack(a_s, n_pad)
    xhi, xlo, smid = jgray.chunk_init(
        jnp.asarray(ids.astype(np.int32)[None]), x0_pair, cols_pair, n=n,
        n_pad=n_pad, r=r, df=False)
    jout = np.asarray(jax_partials(xhi, xlo, smid, cth, ctl, r=r, df=False,
                                   exact_storage=True, tf=True,
                                   interpret=True), dtype=np.float64)[0]
    x0, cols = gray.from_jax_pack(x0_pair, cols_pair)
    out = ryser_cuda.ryser_partials_ref(
        torch.as_tensor(ids), torch.as_tensor(x0), torch.as_tensor(cols),
        n=n, r=r, tier="tf96").numpy()
    assert out.dtype == np.float64 and out.shape == (len(ids), 2)
    for c, chunk in enumerate(ids):
        exact, mag = _exact_chunk(a_s, int(chunk), r)
        assert mag > 0
        got = _frac(out[c, 0]) + _frac(out[c, 1])
        assert abs(got - exact) <= mag * Fraction(1, 2 ** 95)
        jgot = sum(_frac(jout[w, c]) for w in range(3))
        assert abs(jgot - exact) <= mag * Fraction(1, 2 ** 64)


def test_tf96_sentinels_and_wrapper():
    """ids < 0 give an exact (0, 0); a CPU tensor runs the plain version
    through the wrapper; the pair carries bits below a double."""
    a = random_int_matrix(np.random.default_rng(7), 12, 0.6)
    x0, cols = (torch.as_tensor(v) for v in gray.pack_matrix(
        a, gray.pad_n(12)))
    ids = torch.tensor([0, -1, 3, -1])
    out = ryser_cuda.ryser_partials(ids, x0, cols, n=12, r=3, tier="tf96")
    assert out.dtype == torch.float64 and tuple(out.shape) == (4, 2)
    assert torch.equal(out[ids < 0], torch.zeros(2, 2, dtype=torch.float64))
    assert torch.equal(out, ryser_cuda.ryser_partials_ref(
        ids, x0, cols, n=12, r=3, tier="tf96"))
    df = ryser_cuda.ryser_partials(ids, x0, cols, n=12, r=3, tier="df64")
    assert torch.equal(out.sum(dim=1), df.sum(dim=1))   # small ints: exact


def test_sum_words_keeps_cancelling_partials():
    """Partials that cancel to 1e-9 of their magnitudes: the host sum of
    their words against the exact sum of the same words, within 2^-100
    of the magnitudes (pairs added as double-doubles), which a sum of the
    words in long double (~2^-64 of them) does not reach."""
    rng = np.random.default_rng(11)
    hi = rng.standard_normal(5001) * 2.0 ** rng.integers(-8, 8, 5001)
    hi[-1] = -math.fsum(hi[:-1]) + 1e-9 * np.abs(hi).sum()
    lo = hi * 2.0 ** -54 * rng.uniform(-1, 1, 5001)
    words = np.stack([hi, lo], axis=-1)
    exact = sum(_frac(v) for v in words.ravel())
    mag = sum(abs(_frac(v)) for v in words.ravel())
    got = tf96.sum_words(words)
    assert got.dtype == np.longdouble and got.shape == ()
    # the last pair is joined in long double, which rounds once
    err = abs(Fraction(*got.as_integer_ratio()) - exact)
    assert err <= mag * Fraction(1, 2 ** 100) + abs(exact) * Fraction(
        1, 2 ** 52)
    ld = words.astype(np.longdouble).sum()
    assert abs(Fraction(*ld.as_integer_ratio()) - exact) > err


def test_sum_words_long_double_and_exact(monkeypatch):
    """The host reduction keeps what a double drops: 1 + 2^-60 twice, in
    long double where that is wider, and by exact summation where it is
    not (the branch forced here)."""
    words = np.array([[[1.0, 2.0 ** -60], [1.0, 2.0 ** -60]],
                      [[3.0, 0.0], [-3.0, 2.0 ** -70]]])
    want = [Fraction(2) + Fraction(1, 2 ** 59), Fraction(1, 2 ** 70)]
    if tf96.LONGDOUBLE_WIDE:
        got = tf96.sum_words(words)
        assert got.dtype == np.longdouble and got.shape == (2,)
        assert got[0] - np.longdouble(2) == np.longdouble(2.0 ** -59)
        assert float(got[1]) == 2.0 ** -70
    monkeypatch.setattr(tf96, "LONGDOUBLE_WIDE", False)
    got = tf96.sum_words(words)
    assert got.dtype == np.longdouble and got.shape == (2,)
    assert [float(g) for g in got] == [float(w) for w in want]


def _tf96_case(kind):
    rng = np.random.default_rng({"sparse": 31, "ones": 32, "pm1": 33,
                                 "host": 34, "real": 35}[kind])
    if kind == "sparse":
        a = random_int_matrix(rng, 20, 0.18, vmax=3)
        np.fill_diagonal(a, rng.integers(1, 4, 20))
        return a, perman_brute(a)
    if kind == "ones":
        return np.ones((20, 20), dtype=np.int64), math.factorial(20)
    if kind == "pm1":
        a = rng.choice([-1, 1], (20, 20)).astype(np.int64)
        # terms are ~2^23, so the long-double oracle is far within 1/2
        want = round(perman64(a, dtype=np.longdouble))
        assert want % 2 == 0 and abs(want) > 10 ** 6
        return a, want
    if kind == "host":
        a = random_int_matrix(rng, 12, 0.6, vmax=9)
        np.fill_diagonal(a, rng.integers(1, 10, 12))
        return a, perman_brute(a)
    a = rng.random((20, 20))
    return a, perman64(a, dtype=np.longdouble)


@pytest.mark.parametrize("kind", ["sparse", "ones", "pm1", "host", "real"])
def test_permanent_tf96_matches_jax_and_exact(kind):
    """permanent(calc="tf96") in both packages on the matrices of
    tests/test_tf96.py: a sparse integer n=20, all-ones n=20 (df64's worst
    case), +-1 n=20, n=12 (the host long-double route) and a real-valued
    n=20 (the fallback to df64, with its warning).  Each lies within 1e-14
    of the exact integer and of the other (the fallback: 1e-10, df64's
    contract), and the names end alike."""
    a, want = _tf96_case(kind)
    kw = {} if kind == "host" else {"chunk_log2": 6, "lanes": 256}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = sp.permanent(a, calc="tf96", skip_pruning=False, **kw)
        got = spt.permanent(a, calc="tf96", skip_pruning=False,
                            device="cpu", **kw)
    fell = [w for w in caught if "tf96 requires exact-f32 storage"
            in str(w.message)]
    rel = 1e-10 if kind == "real" else 1e-14
    assert got.permanent == pytest.approx(float(want), rel=rel)
    assert ref.permanent == pytest.approx(float(want), rel=rel)
    assert got.permanent == pytest.approx(ref.permanent, rel=rel)
    if kind == "host":
        assert got.algo_name == ref.algo_name == "ryser_tf96_host"
    elif kind == "real":
        assert len(fell) == 2            # one warning from each package
        assert ref.algo_name == "ryser_pallas_df64"
        assert got.algo_name == "ryser_plain_df64"
        assert got.meta["calc"] == ref.meta["calc"] == "df64"
    else:
        assert not fell
        assert ref.algo_name == "ryser_pallas_tf96"
        assert got.algo_name == "ryser_plain_tf96"
        for key in ("calc", "chunks", "r", "lanes", "scale_log2"):
            assert got.meta[key] == ref.meta[key], key
        assert got.meta["exact_storage"] is True


def test_tf96_holds_the_exact_integer_where_partials_cancel():
    """chip_smoke.py's cancelling case at n=20 (chunks of 2^6 steps):
    pairs of equal columns among the chunk-level ones, +-2^12 on one row
    at each, so per(a) = per(base) while the chunk partials stand ~1e7
    above it.  The engine returns the exact integer within 1e-15, where a
    long-double sum of the walk's words would not (tf96.sum_words)."""
    from chip_smoke import cancelling_matrix
    n, r = 20, 6
    a, base = cancelling_matrix(20, n, r)
    want = _exact_int(a)
    assert want == _exact_int(base) != 0
    a_s = np.ldexp(a.astype(np.float64),
                   -ryser._center_scales(a, ryser._row_scales(a))[:, None])
    x0, cols = (torch.as_tensor(v) for v in gray.pack_matrix(a_s, 24))
    words = ryser_cuda.ryser_partials(torch.arange(1 << (n - 1 - r)), x0,
                                      cols, n=n, r=r, tier="tf96").numpy()
    total = sum(_frac(v) for v in words.ravel())
    assert abs(sum(abs(_frac(h) + _frac(l)) for h, l in words)) >= \
        10 ** 6 * abs(total)
    got = spt.permanent(a, calc="tf96", chunk_log2=r, device="cpu")
    assert got.algo_name == "ryser_plain_tf96" and got.meta["r"] == r
    assert abs(_frac(got.permanent) - want) <= abs(want) * Fraction(
        1, 10 ** 15)


def test_tf96_beats_df64_on_all_ones():
    """per(J_20) = 20!: the port's df64 tier is off by ~1e-14 or more,
    its tf96 tier returns the exact value (20! < 2^62 rounds to one
    double)."""
    ones = np.ones((20, 20), dtype=np.int64)
    want = float(math.factorial(20))
    tf = spt.permanent(ones, calc="tf96", chunk_log2=6, device="cpu")
    df = spt.permanent(ones, calc="df64", chunk_log2=6, device="cpu")
    assert tf.permanent == want
    assert abs(df.permanent - want) >= abs(tf.permanent - want)


def test_compute_partials_tf96_is_long_double():
    """The sharding layer returns tf96 partials as long double and sums
    the words into the total the engine scales back."""
    n, r = 12, 3
    a = random_int_matrix(np.random.default_rng(12), n, 0.6)
    plan = gray.make_plan(n, 64, r)
    ids = sharding.pad_ids(np.arange(plan.num_chunks), plan.lanes)
    x0, cols = gray.pack_matrix(a, plan.n_pad)
    cpu = torch.device("cpu")
    part = sharding.compute_partials(ids, x0, cols, plan, cpu, tier="tf96")
    total = sharding.compute_total(x0, cols, plan, cpu, tier="tf96")
    assert part.dtype == np.longdouble and part.shape == ids.shape
    assert isinstance(total, np.longdouble)
    assert (4 * (n & 1) - 2) * total == perman_brute(a)
    assert part.sum() == total
    assert isinstance(sharding.compute_total(x0, cols, plan, cpu), float)


def _exact_int(m) -> int:
    """The exact integer permanent by the port's modular CRT engine (a
    brute-force enumeration is out of reach for dense n >= 13)."""
    return spt.permanent(np.asarray(m, dtype=np.int64), calc="exact",
                         device="cpu").meta["exact_fraction"]


def _mixed_list():
    """Orders 8-16: integers at 8, 13, 14, 14, 16 and one real-valued 14."""
    rng = np.random.default_rng(96)
    mats = [random_int_matrix(rng, n, 0.6, vmax=3) for n in (8, 13, 14, 14, 16)]
    mats.insert(3, rng.random((14, 14)))
    return mats


def test_permanent_batch_tf96_matches_jax_on_mixed_list():
    """permanent_batch(calc="tf96") in both packages on a mixed list.  The
    integer matrices agree within 1e-14 with each other and the exact
    permanents; n=8 runs one by one on the host route in both; from n=13
    the names are counterparts.

    The real-valued matrix is where the packages differ on purpose.  The
    reference decides exact storage for the whole stack and then walks the
    real-valued matrix's x rounded to f32 (superman_tpu/ops/batch.py:
    101-157; ryser_exact falls back to df64 there, ops/ryser.py:285-291),
    so its value is off by ~1e-6 without a warning.  The port sends that
    one matrix through df64, with the warning, and is right to 1e-10."""
    mats = _mixed_list()
    want = sp.permanent_batch(mats, calc="tf96")
    with pytest.warns(UserWarning, match="tf96 requires exact-f32 storage"):
        got = spt.permanent_batch(mats, calc="tf96", device="cpu")
    names = {"ryser_tf96_host": "ryser_tf96_host",
             "ryser_pallas_batch_tf96": "ryser_plain_batch_tf96"}
    for i, (g, w, m) in enumerate(zip(got, want, mats)):
        assert g.iterations == w.iterations == 1 << (m.shape[0] - 1)
        if i == 3:
            oracle = perman64(m, dtype=np.longdouble)
            assert g.algo_name == "ryser_plain_batch_df64"
            assert g.permanent == pytest.approx(oracle, rel=1e-10)
            # the reference defect, named: tf96 batch on inexact storage
            assert w.algo_name == "ryser_pallas_batch_tf96"
            assert abs(w.permanent - oracle) > 1e-9 * abs(oracle)
            continue
        exact = _exact_int(m)
        assert g.algo_name == names[w.algo_name]
        assert g.permanent == pytest.approx(float(exact), rel=1e-14)
        assert w.permanent == pytest.approx(float(exact), rel=1e-14)
    assert got[2].meta["batch"] == 2 and got[2].meta["calc"] == "tf96"
    assert got[3].meta["batch"] == 1 and got[3].meta["calc"] == "df64"


def test_batch_kernel_tf96_refuses_inexact_storage():
    """permanent_batch_kernel itself raises on a tf96 stack with a
    real-valued matrix, and takes the integer stack."""
    rng = np.random.default_rng(14)
    ints = np.stack([random_int_matrix(rng, 14, 0.6, vmax=3)
                     for _ in range(2)]).astype(np.float64)
    vals, meta = batch.permanent_batch_kernel(ints, "tf96", device="cpu")
    assert meta["calc"] == "tf96" and meta["exact_storage"]
    assert [float(v) for v in vals] == [float(_exact_int(m)) for m in ints]
    bad = ints.copy()
    bad[1] += 0.25
    assert list(batch.exact_storage_mask(bad)) == [True, False]
    with pytest.raises(ValueError, match="exact-f32 storage"):
        batch.permanent_batch_kernel(bad, "tf96", device="cpu")


def test_batch_body_is_the_chunk_body_tf96():
    """In the tf96 tier too the batch's plain version before its block
    reduction equals the chunk kernel's plain version of each matrix at
    the same r, bit for bit."""
    n, r = 14, 4
    rng = np.random.default_rng(15)
    stack = np.stack([random_int_matrix(rng, n, 0.6, vmax=3)
                      for _ in range(3)]).astype(np.float64)
    x0p, colsT, _, _ = batch.pack_stack(stack)
    x0s, colss = torch.as_tensor(x0p), torch.as_tensor(colsT)
    hi, lo = ryser_cuda.batch_chunk_partials_ref(x0s, colss, n=n, r=r,
                                                 tier="tf96")
    ids = torch.arange(1 << (n - 1 - r))
    for b in range(len(stack)):
        one = ryser_cuda.ryser_partials_ref(ids, x0s[b], colss[b], n=n, r=r,
                                            tier="tf96")
        assert torch.equal(hi[b], one[:, 0]) and torch.equal(lo[b], one[:, 1])
    assert hi.dtype == lo.dtype == torch.float64


def test_block_reduction_tf96_keeps_a_double_double():
    """K2's block reduction in the tf96 tier (128 pairs -> 1, fixed
    halving order) against the exact sum of the same words: within 2^-100
    of their magnitudes."""
    n, r = 13, 3
    rng = np.random.default_rng(13)
    stack = np.stack([random_int_matrix(rng, n, 0.7, vmax=3)
                      for _ in range(2)]).astype(np.float64)
    x0p, colsT, _, _ = batch.pack_stack(stack)
    x0s, colss = torch.as_tensor(x0p), torch.as_tensor(colsT)
    hi, lo = ryser_cuda.batch_chunk_partials_ref(x0s, colss, n=n, r=r,
                                                 tier="tf96")
    out = ryser_cuda.batch_partials(x0s, colss, n=n, r=r, tier="tf96")
    blocks = (1 << (n - 1 - r)) // ryser_cuda.BLOCK
    assert tuple(out.shape) == (2, blocks, 2) and out.dtype == torch.float64
    assert torch.equal(out, ryser_cuda.block_reduce_ref(hi, lo, "tf96"))
    hi, lo = hi.reshape(2, blocks, -1).numpy(), lo.reshape(2, blocks, -1).numpy()
    for b in range(2):
        for k in range(blocks):
            parts = [_frac(v) for v in hi[b, k]] + [_frac(v) for v in lo[b, k]]
            got = _frac(out[b, k, 0]) + _frac(out[b, k, 1])
            mag = sum(abs(p) for p in parts)
            assert mag > 0
            assert abs(got - sum(parts)) <= mag * Fraction(1, 2 ** 100)


def test_cli_reaches_tf96_and_glynn(tmp_path):
    """python -m superman_tpu_torch --calc tf96, and -p glynn, on the CPU
    print the Result line with the engines' names and the exact value."""
    import os
    import subprocess
    import sys
    from superman_tpu.core.matrix import DenseMatrix
    from superman_tpu.io.triplet import write_triplet
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a = random_int_matrix(np.random.default_rng(19), 19, 0.2, vmax=2)
    np.fill_diagonal(a, 1)
    path = tmp_path / "m19.txt"
    write_triplet(str(path), DenseMatrix(a, "int"))
    want = perman_brute(a)
    for extra, name in ((["-p4"], "ryser_plain_tf96"),
                        (["-p", "glynn"], "glynn_plain_tf96")):
        proc = subprocess.run(
            [sys.executable, "-m", "superman_tpu_torch", "-f", str(path),
             "--calc", "tf96", "--device", "cpu", *extra], cwd=repo,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        line = proc.stdout.strip().splitlines()[-1]
        assert line.startswith(f"Result || {name} | ")
        assert float(line.split("|")[-1].split(" in ")[0]) == want
