"""The port's calc="auto" ladder against the JAX package: the sampled
probes, the amp tier of the walk (its plain version), the exhaustive
amplitude walk, the exact rung's price, and the ladder's decisions.

Inputs come from seeded numpy generators.  The port runs on the CPU
(device="cpu", the kernels' plain versions), the JAX package as its own
tests run it (Pallas in interpret mode).
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu.drivers import runner as jrunner
from superman_tpu.ops import gray as jgray
from superman_tpu.ops import ryser as jryser
from superman_tpu.ops.oracle import perman64, perman_brute
from superman_tpu.parallel import sharding as jsharding
from superman_tpu_torch.csrc.build import launches
from superman_tpu_torch.drivers import runner
from superman_tpu_torch.ops import exact, gray, modp, ryser, ryser_cuda
from tests.conftest import random_float_matrix, random_int_matrix

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores and slows the walks tenfold
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def landmine(seed, n=20):
    """tests/test_exact_dense.py _within_line_landmine: a dyadic real
    matrix whose rows cross zero mid-walk."""
    lrng = np.random.default_rng(seed)
    q = 1.0 / 256.0
    a = np.round(lrng.uniform(-2, 2, (n, n)) / q) * q
    a[np.abs(a) < 4 * q] = 4 * q
    for i in range(0, n, 3):
        c = float(1 << int(lrng.integers(8, 14)))
        j = int(lrng.integers(0, n - 2))
        a[i, :] = np.round(lrng.uniform(-1, 1, n) / q) * q
        a[i, j], a[i, j + 1] = c, -c + q * float(lrng.integers(1, 5))
    return a


def zero_factor_matrix():
    """tests/test_exact_dense.py test_auto_failed_probe_runs_companion:
    16 rows [.., 1, -1, ..] make every probe sample hit a zero factor."""
    lrng = np.random.default_rng(5)
    n = 20
    a = np.zeros((n, n))
    for i in range(16):
        j = int(lrng.integers(0, n - 2))
        a[i, j], a[i, j + 1] = 1.0, -1.0
    a[16:, :] = lrng.integers(1, 9, (4, n)) * 1e8
    return a


def magnitude_spread():
    """tests/test_degenerate.py test_auto_escalates_on_magnitude_spread:
    the fuzz-found n=10 matrix of entries +-9e5."""
    rng = np.random.default_rng(0)
    for _ in range(3063):
        m = rng.integers(1, 10, (10, 10)).astype(np.float64)
        m *= 10.0 ** rng.integers(0, 6, (10, 10))
        m *= np.where(rng.random((10, 10)) < 0.5, -1.0, 1.0)
    return m


def amp_brute_log2(a, eps=None):
    """Exhaustive (log2 amp, log2 cond) of the walk in float64; with eps
    the conditioned term as the kernel defines it on a row-scaled matrix:
    prod max(|x|, eps) * sum 1 / max(|x|, eps)."""
    a = np.asarray(a, np.float64)
    n = a.shape[0]
    x0 = a[:, -1] - a.sum(axis=1) / 2.0
    m = np.arange(1 << (n - 1), dtype=np.uint64)
    g = m ^ (m >> np.uint64(1))
    bits = ((g[:, None] >> np.arange(n - 1, dtype=np.uint64))
            & np.uint64(1)).astype(np.float64)
    ax = np.abs(x0[None, :] + bits @ a[:, : n - 1].T)
    amp = np.prod(ax, axis=1).sum()
    if eps is None:
        return math.log2(amp)
    axc = np.maximum(ax, eps)
    return math.log2(amp), math.log2(
        (np.prod(axc, axis=1) * (1.0 / axc).sum(axis=1)).sum())


def cond_brute_log2(a):
    """The host formula of the conditioned amplitude, exhaustive:
    log2 sum_m sum_i S_i * prod_{j != i} max(|x_j(m)|, S_j * 2^-50), as
    amp_cond_walk_log2 computes it below n = 19."""
    a = np.asarray(a, np.float64)
    n = a.shape[0]
    x0 = a[:, -1] - a.sum(axis=1) / 2.0
    cols = a[:, : n - 1]
    S = np.abs(x0) + np.abs(cols).sum(axis=1)
    m = np.arange(1 << (n - 1), dtype=np.uint64)
    g = m ^ (m >> np.uint64(1))
    bits = ((g[:, None] >> np.arange(n - 1, dtype=np.uint64))
            & np.uint64(1)).astype(np.float64)
    axc = np.maximum(np.abs(x0[None, :] + bits @ cols.T),
                     S[None, :] * 2.0 ** -50)
    logc = np.log2(axc).sum(axis=1) + np.log2((S[None, :] / axc).sum(axis=1))
    mx = float(logc.max())
    return mx + float(np.log2(np.exp2(logc - mx).sum()))


MATRICES = {
    "int20": lambda: random_int_matrix(np.random.default_rng(20), 20, 0.5,
                                       vmax=2),
    "real20": lambda: random_float_matrix(np.random.default_rng(21), 20, 0.6),
    "landmine": lambda: landmine(901),
    "zero_factor": zero_factor_matrix,
    "spread10": magnitude_spread,
    "ones12": lambda: np.ones((12, 12)),
}


# ------------------------------------------------------ the sampled probes

@pytest.mark.parametrize("kw", [{}, {"samples": 4096, "seed": 5}])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_probes_equal_reference(name, kw):
    """_amp_probe_log2 and _cond_probe_log2 are copied numpy: the same
    float (or -inf) as the reference's."""
    a = MATRICES[name]()
    for fn in ("_amp_probe_log2", "_cond_probe_log2"):
        got = getattr(runner, fn)(a, **kw)
        want = getattr(jrunner, fn)(a, **kw)
        assert got == want or (np.isnan(got) and np.isnan(want)), fn
    if name == "zero_factor" and not kw:
        assert runner._amp_probe_log2(a) == -np.inf


# ---------------------------------------------- the amp tier, plain version

def scaled_pack(a, n_pad):
    a_s = np.ldexp(np.asarray(a, np.float64),
                   -ryser._row_scales(a)[:, None])
    return a_s, [torch.as_tensor(v) for v in gray.pack_matrix(a_s, n_pad)]


@pytest.mark.parametrize("n,r,kind", [(10, 3, "real"), (12, 4, "int"),
                                      (13, 2, "real")])
def test_amp_plain_sums_to_the_exhaustive_formula(n, r, kind):
    """ryser_amp over every chunk adds up to the exhaustive float64 sums
    of |prod x| and of prod(max(|x|, eps)) * sum_{i<n} 1/max(|x|, eps):
    the padding rows (n_pad 16) multiply as ones and are left out of the
    reciprocal sum.  Sentinels give 0 and the words are (hi, lo) pairs."""
    rng = np.random.default_rng(n)
    a = (random_int_matrix(rng, n, 0.7) if kind == "int"
         else random_float_matrix(rng, n, 0.8) - 1.0)
    a_s, (x0, cols) = scaled_pack(a, gray.pad_n(n))
    ids = torch.cat([torch.arange(1 << (n - 1 - r)), torch.tensor([-1, -1])])
    out = ryser_cuda.ryser_amp(ids, x0, cols, n=n, r=r)
    assert tuple(out.shape) == (ids.numel(), 4) and out.dtype == torch.float64
    assert not out[-2:].any()
    out = out.numpy()
    want_amp, want_cond = amp_brute_log2(a_s, eps=ryser_cuda.AMP_EPS)
    assert math.log2(out[:, :2].sum()) == pytest.approx(want_amp, abs=1e-12)
    assert math.log2(out[:, 2:].sum()) == pytest.approx(want_cond, abs=1e-12)
    assert np.all(np.abs(out[:, 1]) <= 2.0 ** -50 * out[:, 0].max())


def test_amp_plain_clamps_a_line_at_zero():
    """A row whose x is exactly 0 at some steps: the amplitude term
    vanishes there, the conditioned term keeps the product of the other
    rows (the clamp at eps = 2^-45 cancels against its reciprocal)."""
    n, r = 8, 2
    a = random_int_matrix(np.random.default_rng(3), n, 1.0, vmax=3)
    a[2, :] = 0
    a[2, n - 1], a[2, 0] = 2, 2              # x = 0 + 2 * bit_0
    a_s, (x0, cols) = scaled_pack(a, 8)
    ids = torch.arange(1 << (n - 1 - r))
    out = ryser_cuda.ryser_amp(ids, x0, cols, n=n, r=r).numpy()
    want_amp, want_cond = amp_brute_log2(a_s, eps=ryser_cuda.AMP_EPS)
    assert math.log2(out[:, :2].sum()) == pytest.approx(want_amp, abs=1e-12)
    assert math.log2(out[:, 2:].sum()) == pytest.approx(want_cond, abs=1e-12)
    # half the steps have x_2 = 0: their term is the others' product
    assert want_cond > want_amp + 1.0


@pytest.mark.parametrize("kind", ["int", "real"])
def test_amp_plain_matches_reference_kernel_per_chunk(kind):
    """ryser_amp's plain version against the reference's amp walk
    (compute_partials(amp=True), interpret mode) on one pack, chunk by
    chunk at n=20: the amplitude within 1e-5 (the reference multiplies in
    float32), the conditioned term between the reference's over
    n_pad / n = 1.2 and the reference's (it counts the 4 identity padding
    rows in its reciprocal sum, the port leaves them out)."""
    n, r, lanes = 20, 6, 256
    rng = np.random.default_rng(7)
    a = (random_int_matrix(rng, n, 0.5, vmax=3) if kind == "int"
         else random_float_matrix(rng, n, 0.6) - 0.5)
    a_s = np.ldexp(np.asarray(a, np.float64), -ryser._row_scales(a)[:, None])
    jpack = jgray.pack_matrix(a_s, 24)
    cth, ctl = jryser.colst_pack(a_s, 24)
    plan = jgray.RyserPlan(n=n, n_pad=24, r=r, lanes=lanes,
                           num_chunks=1 << (n - 1 - r))
    ids = jsharding.pad_ids(np.arange(500, dtype=np.int64), lanes, 1)
    want = jsharding.compute_partials(
        ids.astype(np.int32), *jpack, cth, ctl, plan, df=False,
        exact_storage=False, mesh=None, kahan=True, interpret=True, amp=True)
    x0, cols = (torch.as_tensor(v) for v in gray.from_jax_pack(*jpack))
    out = ryser_cuda.ryser_amp(
        torch.as_tensor(ids.reshape(-1).astype(np.int64)), x0, cols, n=n,
        r=r).numpy()
    amp = (out[:, 0] + out[:, 1]).reshape(ids.shape)
    cond = (out[:, 2] + out[:, 3]).reshape(ids.shape)
    live = ids >= 0
    assert not amp[~live].any() and not cond[~live].any()
    assert np.any(amp[live] > 0)
    assert np.all(np.abs(amp - want[0])[live] <= 1e-5 * want[0][live])
    ratio = cond[live] / want[1][live]
    assert ratio.max() <= 1.0 + 1e-5 and ratio.min() >= 20.0 / 24.0 - 1e-5


def line_at_zero_matrix():
    """test_amp_plain_clamps_a_line_at_zero's matrix: row 2 is 0 + 2 * bit_0,
    so its x is exactly 0 at half of the steps."""
    a = random_int_matrix(np.random.default_rng(3), 8, 1.0, vmax=3)
    a[2, :] = 0
    a[2, 7], a[2, 0] = 2, 2
    return a


@pytest.mark.parametrize("case", ["real10", "real13", "real20", "zero_line",
                                  "padding"])
def test_cond_fold_against_exact_fractions(case):
    """The conditioned term's (P, C) fold, on the walk states x of a
    chunk (padding rows x = 1 where n_pad > n), against
    sum_{i<n} prod_{j != i} max(|x_j|, eps) in exact Fractions: within
    1e-13 relative (every operation adds positive values, a product of
    n_pad factors rounds some 2 log2(n_pad) times by 2^-53)."""
    if case == "zero_line":
        a = line_at_zero_matrix()
    elif case == "padding":            # n = 9 in n_pad = 16: 7 padding rows
        a = random_float_matrix(np.random.default_rng(9), 9, 0.8) - 0.5
    else:
        n = int(case[4:])
        a = random_float_matrix(np.random.default_rng(n), n, 0.7) - 0.4
    n = a.shape[0]
    n_pad = gray.pad_n(n)
    _, (x0, cols) = scaled_pack(a, n_pad)
    r = 2
    ids = torch.arange(min(64, 1 << (n - 1 - r)))
    x, sign_mid = gray.chunk_init(ids, x0, cols, n, r)
    xs = [x] + [xm for _, xm in ryser_cuda._walk_steps(x, sign_mid, cols, r)]
    clamped = 0
    for x in xs:
        got = ryser_cuda.cond_fold(x, n)
        for k in range(x.shape[0]):
            pc = [max(abs(Fraction(float(v))), Fraction(ryser_cuda.AMP_EPS))
                  for v in x[k].tolist()]
            clamped += sum(v == 0 for v in x[k, :n].tolist())
            prod_all = math.prod(pc)
            want = sum(prod_all / pc[i] for i in range(n))
            assert abs(Fraction(float(got[k])) - want) <= want * Fraction(
                1, 10 ** 13)
    if case == "zero_line":
        assert clamped > 0


@pytest.mark.parametrize("kind", ["int", "real"])
def test_amp_only_plain_walk_equals_cond_amplitude(kind):
    """The amplitude-only variant's plain walk writes two words a chunk,
    bit for bit the first two of the conditioned variant's four."""
    n, r = 14, 4
    rng = np.random.default_rng(14)
    a = (random_int_matrix(rng, n, 0.6) if kind == "int"
         else random_float_matrix(rng, n, 0.8) - 0.5)
    _, (x0, cols) = scaled_pack(a, gray.pad_n(n))
    ids = torch.cat([torch.arange(1 << (n - 1 - r)), torch.tensor([-1])])
    amp = ryser_cuda.ryser_amp(ids, x0, cols, n=n, r=r, cond=False)
    both = ryser_cuda.ryser_amp(ids, x0, cols, n=n, r=r)
    assert tuple(amp.shape) == (ids.numel(), 2)
    assert tuple(both.shape) == (ids.numel(), 4)
    assert torch.equal(amp, both[:, :2])
    assert not amp[-1].any()


def test_amp_walk_log2_takes_the_amplitude_only_route(monkeypatch):
    """amp_walk_log2 walks the amplitude alone (cond=False on every call
    of the plain version) and amp_cond_walk_log2 the conditioned variant;
    both give the same log2 amp at n=20 (the kernel route)."""
    calls = []
    real = ryser_cuda.ryser_amp_ref

    def counting(*args, cond=True, **kw):
        calls.append(cond)
        return real(*args, cond=cond, **kw)

    monkeypatch.setattr(ryser_cuda, "ryser_amp_ref", counting)
    a = random_float_matrix(np.random.default_rng(20), 20, 0.6)
    amp = ryser.amp_walk_log2(a, CPU)
    assert calls and not any(calls)
    calls.clear()
    both = ryser.amp_cond_walk_log2(a, CPU)
    assert calls and all(calls)
    assert amp == both[0]


# ------------------------------------------- the exhaustive amplitude walk

@pytest.mark.parametrize("n", [9, 14])
def test_amp_cond_walk_host_route_equals_reference(n):
    a = random_float_matrix(np.random.default_rng(n), n, 0.7)
    got = ryser.amp_cond_walk_log2(a, CPU)
    want = jryser.amp_cond_walk_log2(a)
    assert got == pytest.approx(want, abs=1e-9)
    assert ryser.amp_walk_log2(a, CPU) == got[0]
    assert got[0] == pytest.approx(amp_brute_log2(a), abs=1e-9)


def test_amp_walk_structural_zero_and_empty():
    a = np.ones((6, 6))
    a[2, :] = 0.0
    assert ryser.amp_cond_walk_log2(a, CPU) == (-np.inf, -np.inf)
    assert ryser.amp_walk_log2(np.zeros((0, 0)), CPU) == -np.inf
    big = np.ones((20, 20))
    big[7, :] = 0.0
    assert ryser.amp_walk_log2(big, CPU) == jryser.amp_walk_log2(big) \
        == -np.inf


@pytest.mark.parametrize("kind", ["real", "landmine"])
def test_amp_cond_walk_kernel_route_tracks_reference(kind):
    """n=20 takes the kernel route in both packages (the port's amp tier
    in its plain version, the reference's in interpret mode): log2 amp
    within 1e-4 of the reference and of the exhaustive float64 sum.  log2
    cond is at most the reference's and at most half a bit below it: the
    reference counts its 4 identity padding rows in the reciprocal sum
    (log2(24/20) = 0.26 where every |x| is 1, a little more where the
    uniform centering lifts |x| above 1), the port leaves them out.  Both
    lie inside the reference's band around the exhaustive host formula
    (S_i-weighted where the kernels weight by the rows' power-of-two
    scales: -1 / +2 bits)."""
    a = (random_float_matrix(np.random.default_rng(20), 20, 0.6)
         if kind == "real" else landmine(902))
    before = launches("amp", "amp_cond")
    amp, cond = ryser.amp_cond_walk_log2(a, CPU)
    assert launches("amp", "amp_cond") == before   # counts launches only
    jamp, jcond = jryser.amp_cond_walk_log2(a)
    assert amp == pytest.approx(jamp, abs=1e-4)
    assert amp == pytest.approx(amp_brute_log2(a), abs=1e-4)
    assert jcond - 0.5 <= cond <= jcond + 1e-3
    want = cond_brute_log2(a)
    assert want - 1.0 <= cond <= want + 2.0
    assert cond > amp + math.log2(20) - 0.1


def test_amp_walk_recovers_from_underflow(monkeypatch):
    """The 4-attempt shift loop: a first attempt whose scaled total is 0
    grows the terms uniformly and the recovered log2 stays the same."""
    from superman_tpu_torch.parallel import sharding
    a = random_float_matrix(np.random.default_rng(20), 20, 0.6)
    want = ryser.amp_cond_walk_log2(a, CPU)
    real = sharding.compute_amp
    calls = []

    def first_underflows(*args):
        calls.append(1)
        out = real(*args)
        return out * 0.0 if len(calls) == 1 else out

    monkeypatch.setattr(sharding, "compute_amp", first_underflows)
    got = ryser.amp_cond_walk_log2(a, CPU)
    assert len(calls) == 2
    assert got == pytest.approx(want, abs=1e-9)
    monkeypatch.setattr(sharding, "compute_amp",
                        lambda *args: real(*args) * 0.0)
    assert ryser.amp_cond_walk_log2(a, CPU) == (np.inf, np.inf)


# --------------------------------------------------- the exact rung's price

CUDA = torch.device("cuda")   # priced only: no card is needed


def test_exact_cost_estimate_prices_the_card():
    """(seconds, primes, core order) on a card: 31-bit primes plus the
    verifier, the plan's live steps at the Z_p kernel's rate, a fixed
    cost; a budget below the fixed cost skips the plan; a structural zero
    is free."""
    a = random_int_matrix(np.random.default_rng(20), 20, 0.5, vmax=2)
    secs, npr, core_n = exact.exact_cost_estimate(a, CUDA)
    core, mult = exact._fold_lines(exact.dyadic_int_matrix(a)[0])
    assert mult != 0 and core_n == len(core)
    bits = exact._log2_bound(core) + 3
    assert npr == max(1, math.ceil(bits / math.log2(modp.PRIME_CEIL))) + 1
    walks = modp.card_cost_estimate(core, bits, CUDA)
    assert 0 < walks <= npr * 2.0 ** (core_n - 1) / (modp.K3_GITERS * 1e9)
    assert secs == pytest.approx(exact._EXACT_FIXED_S + exact._PLAN_S_N32
                                 * 2.0 ** (core_n - 32) + walks)
    skipped, npr0, n0 = exact.exact_cost_estimate(a, CUDA, budget_s=0.0)
    assert (npr0, n0) == (npr, core_n) and 0 < skipped < secs
    z = a.copy()
    z[3, :] = 0
    assert exact.exact_cost_estimate(z, CUDA) == (0.0, 0, 0)


@pytest.mark.parametrize("n", [20, 24])
def test_exact_cost_estimate_prices_the_cpu(n):
    """On device="cpu" the walks are priced at the plain Z_p walk's rate:
    the same core costs at least 50 times what it costs on a card."""
    a = random_int_matrix(np.random.default_rng(n), n, 0.5, vmax=2)
    cpu, npr, core_n = exact.exact_cost_estimate(a, CPU)
    card, npr_c, core_c = exact.exact_cost_estimate(a, CUDA)
    assert (npr, core_n) == (npr_c, core_c) == (npr, n)
    assert cpu >= 50 * card
    core, _ = exact._fold_lines(exact.dyadic_int_matrix(a)[0])
    bits = exact._log2_bound(core) + 3
    assert modp.card_cost_estimate(core, bits, CPU) == pytest.approx(
        modp.card_cost_estimate(core, bits, CUDA)
        * modp.K3_GITERS / modp.PLAIN_GITERS)


def test_auto_on_the_cpu_prices_the_exact_rung_there():
    """calc="auto" on device="cpu" with a budget between the card's price
    of the exact rung and the CPU's: the rung does not fit, so the ladder
    stops at tf96, flagged, with the CPU's price of the truth."""
    a = MATRICES["int20"]()
    cpu = exact.exact_cost_estimate(a, CPU)[0]
    card = exact.exact_cost_estimate(a, CUDA)[0]
    budget = math.sqrt(cpu * card)
    assert card < budget < cpu
    got = spt.permanent(a, calc="auto", device="cpu", chunk_log2=6,
                        lanes=256, auto_target=1e-30,
                        auto_exact_budget_s=budget)
    am = got.meta["auto"]
    assert am["escalated"] == "tf96" and am["low_confidence"] is True
    assert am["exact_feasible_s"] == round(cpu, 1)
    assert got.algo_name == "ryser_plain_tf96"
    assert got.permanent == pytest.approx(perman64(a), rel=1e-12)


# ------------------------------------------------- the ladder's decisions

def both(a, **kw):
    """(port, reference) results of calc="auto" on one matrix."""
    got = spt.permanent(a, calc="auto", device="cpu", **kw)
    ref = sp.permanent(a, calc="auto", **kw)
    return got, ref


def same_decision(got, ref):
    """The ladder took the same rung and reports the same flags."""
    g, w = got.meta["auto"], ref.meta["auto"]
    assert sorted(g) == sorted(w)
    for key in ("escalated", "ladder", "low_confidence", "probe_only"):
        assert g.get(key) == w.get(key), key
    for key in ("amp_walk_l2", "cond_walk_l2"):
        if key in w:
            assert g[key] == pytest.approx(w[key], abs=0.45), key


def test_auto_benign_matrix_is_probe_only():
    a = MATRICES["int20"]()
    got, ref = both(a, chunk_log2=6, lanes=256)
    same_decision(got, ref)
    assert got.meta["auto"] == ref.meta["auto"]      # the probe is copied
    assert got.meta["auto"]["probe_only"] is True
    assert got.algo_name == "ryser_plain_df64"
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-9)
    assert got.permanent == pytest.approx(perman64(a), rel=1e-9)


def test_auto_impossible_target_climbs_to_exact():
    a = MATRICES["int20"]()
    got, ref = both(a, chunk_log2=6, lanes=256, auto_target=1e-30)
    same_decision(got, ref)
    assert got.meta["auto"]["escalated"] == "exact"
    assert got.algo_name == ref.algo_name == "exact_crt"
    assert got.meta["exact_fraction"] == ref.meta["exact_fraction"]
    assert got.permanent == ref.permanent
    assert got.permanent == pytest.approx(perman64(a), rel=1e-12)


def test_auto_without_exact_budget_stops_at_flagged_tf96():
    a = MATRICES["int20"]()
    got, ref = both(a, chunk_log2=6, lanes=256, auto_target=1e-30,
                    auto_exact_budget_s=0.0)
    same_decision(got, ref)
    assert got.meta["auto"]["escalated"] == "tf96"
    assert got.meta["auto"]["low_confidence"] is True
    assert got.algo_name == "ryser_plain_tf96"
    assert "amp_walk_l2" in got.meta["auto"]
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-9)
    want = exact.perman_exact_fraction(a, CPU)[0]
    assert got.permanent == pytest.approx(float(want), rel=1e-15)


def test_auto_probe_saturates_past_f64_exponent(monkeypatch):
    """Amplitudes past 2^1023 saturate to inf and escalate in both
    packages, and do not raise OverflowError."""
    for mod, rmod in ((runner, ryser), (jrunner, jryser)):
        monkeypatch.setattr(mod, "_amp_probe_log2",
                            lambda a, samples=256, seed=0xA3: 3000.0)
        monkeypatch.setattr(rmod, "amp_walk_log2", lambda a, *_: 3000.0)
    a = random_int_matrix(np.random.default_rng(10), 10, 0.9, vmax=5)
    got, ref = both(a)
    same_decision(got, ref)
    assert got.meta["auto"]["escalated"] in ("tf96", "exact")
    assert got.permanent == pytest.approx(float(perman_brute(a)), rel=1e-12)


def test_auto_failed_probe_runs_companion():
    a = zero_factor_matrix()
    got, ref = both(a, chunk_log2=6, lanes=256)
    same_decision(got, ref)
    assert got.meta["auto"].get("probe_only") is not True
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-9, abs=1e-300)


def test_auto_escalates_on_magnitude_spread():
    a = magnitude_spread()
    got, ref = both(a)
    same_decision(got, ref)
    assert got.meta["auto"]["escalated"] == "tf96"
    assert got.algo_name == "ryser_tf96_host"
    want = perman_brute(a.astype(np.int64))
    assert got.permanent == pytest.approx(float(want), rel=1e-8)
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-9)


@pytest.mark.parametrize("seed", [901, 902, 903, 1234])
def test_auto_honest_on_within_line_cancellation(seed):
    """The landmine family with no exact budget: the ladder never claims
    a tf96 rung on real storage, flags what it cannot promise, and
    4 x err_est covers the true error against the exact rational, in the
    port as in the reference; both take the same rung."""
    a = landmine(seed)
    truth = exact._float_of_fraction(exact.perman_exact_fraction(a, CPU)[0])
    got, ref = both(a, auto_exact_budget_s=0.0, chunk_log2=6, lanes=256)
    same_decision(got, ref)
    am = got.meta["auto"]
    assert am["escalated"] is None
    rel = abs(got.permanent - truth) / max(abs(got.permanent), 1e-300)
    if rel > 1e-9:
        assert am.get("low_confidence"), (rel, am)
    if am.get("low_confidence"):
        assert am["ladder"] == "df64_max"
        assert 4.0 * float(am["err_est"]) >= rel, (rel, am)
        assert "cond_walk_l2" in am and "exact_feasible_s" not in am


def test_auto_real_matrix_escalates_to_exact_within_budget():
    a = landmine(77)
    truth = exact._float_of_fraction(exact.perman_exact_fraction(a, CPU)[0])
    got, ref = both(a, auto_exact_budget_s=1e9, chunk_log2=6, lanes=256)
    same_decision(got, ref)
    if got.meta["auto"]["escalated"] == "exact":
        assert got.permanent == pytest.approx(truth, rel=1e-12)
        assert got.permanent == ref.permanent
    else:
        rel = abs(got.permanent - truth) / max(abs(got.permanent), 1e-300)
        assert rel <= max(4.0 * float(got.meta["auto"]["err_est"]), 1e-9)


def test_auto_under_sparse_and_glynn_flags():
    """calc="auto" comes before the Glynn and sparse dispatch, as in the
    reference: perman_algo="glynn" with calc="auto" runs the ladder, and
    sparse=True hands it the preprocessed matrix."""
    a = MATRICES["int20"]()
    got = spt.permanent(a, calc="auto", perman_algo="glynn", chunk_log2=6,
                        device="cpu")
    assert got.meta["auto"]["probe_only"] is True
    got = spt.permanent(a, calc="auto", sparse=True, preprocessing=2,
                        chunk_log2=6, device="cpu")
    assert "auto" in got.meta
    assert got.permanent == pytest.approx(perman64(a), rel=1e-9)
