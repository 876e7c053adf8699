"""The port's Monte-Carlo estimators against exact values and against the
JAX package's host arithmetic, on the CPU.

The random streams differ (torch's generator against jax.random), so
the estimates are held statistically: within 4 stderr of the exact
permanent (perman_brute at n <= 10) or of the Kasteleyn closed form on
grid graphs, at fixed seeds.  What is deterministic is held exactly: the
host's accumulation and stderr on the same trial values (both packages'
trial functions replaced by the same arrays), _pop_stats, the trial
budget, the zero-atom probe's choice, the selector's meta.
"""

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu.ops.approx as japprox
import superman_tpu_torch as spt
import superman_tpu_torch.ops.approx as approx
from superman_tpu.ops.oracle import perman_brute
from superman_tpu_torch.prep.gridgraph import kasteleyn_log2

SIGMAS = 4.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _binary(seed, n=10, density=0.6):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.int64)
    np.fill_diagonal(a, 1)
    return a


def _weighted(seed, n=10):
    rng = np.random.default_rng(seed)
    a = ((rng.random((n, n)) < 0.6) * rng.integers(1, 4, (n, n))
         ).astype(np.float64)
    np.fill_diagonal(a, 1.0)
    return a


def _signed(seed, n=8):
    rng = np.random.default_rng(seed)
    a = rng.integers(-2, 3, (n, n)).astype(np.float64)
    a[np.all(a == 0, axis=1), 0] = 1.0
    return a


CASES = {
    "rasmussen": (_binary, {"perman_algo": "rasmussen",
                            "number_of_times": 40000}),
    "scaling": (_weighted, {"perman_algo": "scaling",
                            "number_of_times": 20000, "scale_intervals": 4}),
    "gurvits_rademacher": (_signed, {"perman_algo": "gurvits",
                                     "gurvits_dist": "rademacher",
                                     "number_of_times": 100000}),
    "gurvits_gaussian": (_signed, {"perman_algo": "gurvits",
                                   "gurvits_dist": "gaussian",
                                   "number_of_times": 100000}),
    "smc": (_weighted, {"perman_algo": "scaling", "smc": 1,
                        "number_of_times": 8192, "scale_intervals": 2}),
}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_estimate_within_four_stderr_of_exact(case, seed):
    make, flags = CASES[case]
    a = make(seed)
    want = float(perman_brute(a))
    got = spt.permanent(a, approximation=True, seed=seed, device="cpu",
                        **flags)
    se = got.meta["stderr"]
    assert np.isfinite(se) and se > 0
    assert abs(got.permanent - want) <= SIGMAS * se, (got.permanent, want,
                                                      se)
    name = {"smc": "approx_scaling_smc", "rasmussen": "approx_rasmussen",
            "scaling": "approx_scaling"}.get(case, "approx_gurvits")
    assert got.algo_name == name


@pytest.mark.parametrize("algo,m,n", [("rasmussen", 4, 4),
                                      ("scaling", 4, 4), ("scaling", 6, 6),
                                      ("scaling", 4, 8)])
def test_per_trial_estimators_on_grids(algo, m, n):
    got = spt.grid_permanent(m, n, approximation=True, perman_algo=algo,
                             number_of_times=20000, seed=3, device="cpu")
    want = 2.0 ** kasteleyn_log2(m, n)
    se = got.meta["stderr"]
    assert se > 0 and abs(got.permanent - want) <= SIGMAS * se


@pytest.mark.parametrize("m,n,si", [(6, 6, 2), (8, 8, 4), (8, 8, -1)])
def test_smc_on_grids_against_kasteleyn(m, n, si):
    """The flagship's invocation shape at CI scale: the log2 estimate
    within 4 sigma (stderr_rel / ln 2) of the closed form."""
    got = spt.grid_permanent(m, n, approximation=True, perman_algo="scaling",
                             smc=1, scale_intervals=si,
                             number_of_times=4000, seed=21, device="cpu")
    sig_l2 = float(got.meta["stderr_rel"]) / np.log(2.0)
    assert sig_l2 > 0
    assert abs(got.meta["log2_estimate"] - kasteleyn_log2(m, n)) \
        <= SIGMAS * sig_l2
    assert got.meta["populations"] == 8
    assert got.meta["trials"] == got.iterations == 8 * 500


def test_pop_stats_equal_to_jax():
    rng = np.random.default_rng(7)
    for lz in (rng.normal(500.0, 2.0, 8), rng.normal(-3.0, 0.1, 16),
               np.array([10.0, -1e30, 9.5, 11.0]),
               np.array([-np.inf, -np.inf])):
        assert approx._pop_stats(lz) == japprox._pop_stats(lz)


def _fake_trials(n_trials, seed):
    """(log2 values, dead) of `n_trials` made-up trials, some dead, with
    magnitudes beyond the float64 range."""
    rng = np.random.default_rng(seed)
    logs = rng.normal(1100.0, 3.0, n_trials).astype(np.float32)
    dead = rng.random(n_trials) < 0.2
    return logs, dead


@pytest.mark.parametrize("algo", ["rasmussen", "scaling"])
def test_host_accumulation_equal_to_jax(monkeypatch, algo):
    """The same trial values through both drivers' host arithmetic (log2
    accumulation, the estimate, the stderr): equal results."""
    logs, dead = _fake_trials(3000, 11)
    monkeypatch.setattr(
        japprox, "_run_batch",
        lambda keys, a, nz, **kw: (logs[:len(keys)], dead[:len(keys)]))
    monkeypatch.setattr(
        approx, "_run_batch",
        lambda algo_, mats, B, gen, **kw: (torch.as_tensor(logs[:B]),
                                           torch.as_tensor(dead[:B])))
    a = _binary(1)
    kw = dict(approximation=True, perman_algo=algo, number_of_times=3000,
              seed=1)
    ref = sp.permanent(a, **kw)
    got = spt.permanent(a, device="cpu", **kw)
    assert got.permanent == ref.permanent and np.isinf(got.permanent)
    assert got.meta["stderr"] == ref.meta["stderr"]
    assert got.zeros == ref.zeros and got.iterations == ref.iterations
    assert set(got.meta) - {"spans"} == set(ref.meta) - {"spans"}


def test_gurvits_host_accumulation_equal_to_jax(monkeypatch):
    rng = np.random.default_rng(12)
    logm = rng.normal(3.0, 2.0, 4000)
    sgn = rng.choice([-1.0, 0.0, 1.0], 4000, p=[0.45, 0.1, 0.45])
    monkeypatch.setattr(
        japprox, "_run_batch",
        lambda keys, a, nz, **kw: (logm[:len(keys)].astype(np.float32),
                                   sgn[:len(keys)].astype(np.float32)))
    monkeypatch.setattr(
        approx, "_gurvits_trial",
        lambda a, x: (torch.as_tensor(logm[:x.shape[0]].astype(np.float32)
                                      .astype(np.float64)),
                      torch.as_tensor(sgn[:x.shape[0]])))
    a = _signed(4)
    kw = dict(approximation=True, perman_algo="gurvits",
              number_of_times=4000, seed=2)
    ref = sp.permanent(a, **kw)
    got = spt.permanent(a, device="cpu", **kw)
    assert got.permanent == ref.permanent
    for k in ("stderr", "stderr_rel", "log2_estimate", "sign", "scale_log2",
              "dist", "trials"):
        assert got.meta[k] == ref.meta[k], k
    assert got.zeros == ref.zeros


def test_smc_host_arithmetic_equal_to_jax(monkeypatch):
    n, B = 12, 512

    def population(p):
        r = np.random.default_rng(100 + p)
        lm = np.zeros(n, np.float32)
        lm[7::8] = r.normal(2.0, 0.5, len(lm[7::8]))
        if p == 3:
            lm[7] = -1e30                      # an extinct population
        return (lm, r.normal(0.0, 1.0, B).astype(np.float32),
                r.random(B) < 0.3)

    cache = {}

    def fake(p):
        if p not in cache:
            cache[p] = population(p)
        return cache[p]

    jcount, count = iter(range(100)), iter(range(100))
    monkeypatch.setattr(japprox, "_smc_population",
                        lambda *a, **kw: fake(next(jcount)))
    monkeypatch.setattr(
        approx, "_smc_population",
        lambda *a, **kw: tuple(torch.as_tensor(v) for v in fake(next(count))))
    a = _weighted(5, n)
    kw = dict(approximation=True, perman_algo="scaling", smc=1,
              number_of_times=8 * B, seed=3, scale_intervals=4)
    ref = sp.permanent(a, **kw)
    got = spt.permanent(a, device="cpu", **kw)
    assert got.permanent == ref.permanent
    for k in ("stderr", "stderr_rel", "log2_estimate", "pop_log2",
              "trials", "populations", "scale_intervals"):
        assert got.meta[k] == ref.meta[k], k
    assert got.zeros == ref.zeros


@pytest.mark.parametrize("algo,trials,batches", [
    ("rasmussen", 20000, [16384, 3616]), ("scaling", 17000, [16384, 616]),
    ("gurvits", 10000, [8192, 1808])])
def test_trial_budget_is_exact(monkeypatch, algo, trials, batches):
    seen = []
    if algo == "gurvits":
        real = approx._gurvits_trial
        monkeypatch.setattr(approx, "_gurvits_trial",
                            lambda a, x: seen.append(x.shape[0])
                            or real(a, x))
    else:
        real = approx._run_batch
        monkeypatch.setattr(approx, "_run_batch",
                            lambda *args, **kw: seen.append(args[2])
                            or real(*args, **kw))
    a = _signed(6, 5) if algo == "gurvits" else _binary(6, 5)
    got = spt.permanent(a, approximation=True, perman_algo=algo,
                        number_of_times=trials, seed=1, device="cpu")
    assert seen == batches
    assert got.meta["trials"] == got.iterations == trials


@pytest.mark.parametrize("flags", [
    {"perman_algo": "rasmussen"}, {"perman_algo": "scaling"},
    {"perman_algo": "scaling", "smc": 1}, {"perman_algo": "gurvits"}])
def test_structural_zero_gives_zero(flags):
    a = np.ones((8, 8))
    a[3] = 0.0
    got = spt.permanent(a, approximation=True, number_of_times=600, seed=1,
                        device="cpu", **flags)
    assert got.permanent == 0.0
    if flags["perman_algo"] == "gurvits":
        assert got.meta["zero_row"] is True
    else:
        assert got.zeros == got.meta["trials"]


def test_selector_meta_has_the_shape_of_jax():
    kw = dict(approximation=True, perman_algo="scaling", smc=1,
              number_of_times=2048, seed=5)
    ref = sp.grid_permanent(4, 4, **kw)
    got = spt.grid_permanent(4, 4, device="cpu", **kw)
    sel, jsel = got.meta["si_auto"], ref.meta["si_auto"]
    assert set(sel) == set(jsel) == {"candidates", "picked", "rule"}
    assert sel["rule"] == jsel["rule"] == "argmax_full_run_log2"
    assert set(sel["candidates"]) == set(jsel["candidates"]) == {"2", "4"}
    for c in ("2", "4"):
        assert set(sel["candidates"][c]) == set(jsel["candidates"][c])
    assert sel["picked"] == got.meta["scale_intervals"]
    assert set(got.meta) - {"spans"} == set(ref.meta) - {"spans"}
    assert got.meta["log2_estimate"] == pytest.approx(np.log2(36), abs=0.2)


def test_gurvits_clamp_defect_not_copied():
    """Differs from the reference on purpose (superman_tpu/ops/approx.py:
    137): it clamps a nonzero |(Ax)_i| at 1e-37 and keeps the sign, so a
    trial whose row lands below that is inflated.  On [[2^-125]]
    every trial is exactly 2^-125 (|X| = |a| x^2 = |a|): the port returns
    log2 = -125, the reference log2(1e-37) = -122.9."""
    import jax
    import jax.numpy as jnp
    a = np.array([[2.0 ** -125]])
    jl, js = japprox._gurvits_trial(jax.random.PRNGKey(0),
                                    jnp.asarray(a, jnp.float32), 1)
    assert float(jl) == pytest.approx(np.log2(1e-37), abs=1e-5)
    x = torch.tensor([[1.0], [-1.0]])
    logm, sgn = approx._gurvits_trial(torch.as_tensor(a, dtype=torch.float32),
                                      x)
    assert logm.tolist() == [-125.0, -125.0]
    assert sgn.tolist() == [1.0, 1.0]
    # an exact zero is the only zero trial
    logm, sgn = approx._gurvits_trial(torch.tensor([[1.0, -1.0]]).repeat(2, 1),
                                      torch.tensor([[1.0, 1.0],
                                                    [1.0, -1.0]]))
    assert sgn.tolist() == [0.0, -1.0]


@pytest.mark.parametrize("kind", ["circulant", "dense"])
def test_gurvits_distribution_choice_equal_to_jax(kind):
    """The auto probe draws the same numpy signs in both packages, so it
    picks the same distribution: Gaussian on the circulant I - P, whose
    rows cancel to exactly 0 for half the sign vectors."""
    n = 6
    if kind == "circulant":
        a = np.eye(n)
        a[np.arange(n), (np.arange(n) + 1) % n] = -1.0
    else:
        a = np.random.default_rng(9).uniform(-1.0, 1.0, (n, n))
    kw = dict(approximation=True, perman_algo="gurvits",
              number_of_times=200, seed=2)
    ref = sp.permanent(a, **kw)
    got = spt.permanent(a, device="cpu", **kw)
    assert got.meta["dist"] == ref.meta["dist"] == (
        "gaussian" if kind == "circulant" else "rademacher")


def test_rademacher_zero_atom_is_reported():
    """Open in the reference too: forced Rademacher on a circulant of n=20
    samples only the zero atom; the result says so instead of 0 +- 0."""
    n = 20
    a = np.eye(n)
    a[np.arange(n), (np.arange(n) + 1) % n] = -1.0
    got = spt.permanent(a, approximation=True, perman_algo="gurvits",
                        gurvits_dist="rademacher", number_of_times=4096,
                        seed=2, device="cpu")
    assert got.permanent == 0.0 and got.zeros == 4096
    assert got.meta["zero_atom"] is True
    assert got.meta["stderr_rel"] == float("inf")


def test_uniform_choice_rule():
    w = torch.tensor([[0.0, 1.0, 0.0, 3.0], [2.0, 2.0, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 5.0, 0.0]])
    u = torch.tensor([0.25, 0.5, 0.3, 0.999999])
    idx, pj, total = approx._uniform_choice(w, u)
    # the first index whose cumulative weight exceeds u * total
    assert idx.tolist() == [3, 1, 3, 2]
    assert pj.tolist() == [0.75, 0.5, 0.0, 1.0]
    assert total.tolist() == [4.0, 4.0, 0.0, 5.0]


def test_float32_products_stay_full_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with approx._full_fp32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("flags,item", [
    ({"hybrid": True}, 12), ({"perman_algo": "3"}, 12),
    ({"mesh_shape": (2,)}, 11)])
def test_unported_estimator_paths_raise(flags, item):
    """The lifted estimator paths run (the name is kept from when they
    raised).  The estimator paths that ROADMAP item 11 or 12 refused until they
    were ported now run: the hybrid flag (with the CPU trial worker under
    cpu=True), the Rasmussen hybrid-chunks id "3" (a mesh of gpu_num
    entries and the hybrid flag) and a mesh of 2 "cpu" entries; each
    within 4 stderr of the exact permanent, with exactly the trials asked
    for, and the mesh run deterministic for its seed."""
    a = _binary(1)
    want = float(perman_brute(a))
    for cpu in (False, True):
        got = spt.permanent(a, approximation=True, device="cpu",
                            number_of_times=100000, threads=2, cpu=cpu,
                            seed=item, **flags)
        assert got.meta["trials"] == got.iterations == 100000
        assert abs(got.permanent - want) <= SIGMAS * got.meta["stderr"]
        hybrid = cpu and (flags.get("hybrid") or flags.get("perman_algo"))
        assert got.algo_name.endswith("_hybrid") == bool(hybrid)
        assert (got.meta["cpu_trials"] > 0) == bool(hybrid)
    if not hybrid:
        again = spt.permanent(a, approximation=True, device="cpu",
                              number_of_times=100000, seed=item, **flags)
        assert again.permanent == got.permanent
