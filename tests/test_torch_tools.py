"""The port's tools against the JAX package's, on the same seeded inputs.

Each tool of superman_tpu_torch/tools runs on device="cpu" (the kernels'
plain versions) beside its superman_tpu/tools counterpart (Pallas in
interpret mode) on matrices that tools/corpus.py writes under tmp_path:
the fuzzer's trials draw for draw, the accuracy sweep's records, the
suite checks' rows within 1e-10, the sparse layout on one plan, and the
modp ledger that chip_smoke.py's K3 bound counts.  Every tool's default
device is the card, which raises without CUDA.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import superman_tpu
import superman_tpu.ops.oracle as jax_oracle
import superman_tpu_torch as spt
from superman_tpu.tools import accuracy as jax_accuracy
from superman_tpu.tools import fuzz as jax_fuzz
from superman_tpu.tools import scaling_measure as jax_scaling
from superman_tpu.tools import sparse_report as jax_sparse_report
from superman_tpu.tools import suite_check as jax_suite_check
from superman_tpu_torch.ops import pruning
from superman_tpu_torch.tools import (accuracy, corpus, exact_known, fuzz,
                                      modp_rate, real_suite,
                                      scaling_measure, smc_flagship,
                                      sparse_report, suite_check)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda s: None)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    # a tool that writes to the working directory by default writes here
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def suite16(tmp_path_factory):
    """The seeded int suite at n=16: a dense file and three sparse."""
    root = str(tmp_path_factory.mktemp("suite16"))
    return corpus.write_int_suite(root, 0, ns=(16,),
                                  densities=("0.10", "0.15", "0.20", "0.50"))


class _Res:
    def __init__(self, v):
        self.permanent = v


@pytest.mark.parametrize("seed", [0, 123])
def test_fuzz_trials_are_the_reference_draws(seed, monkeypatch):
    """The port's trials are the JAX fuzzer's, draw for draw: the same
    matrices, tiers and flags (the JAX run listed through a stand-in
    permanent that records its calls and walks nothing)."""
    calls = []

    def record(a, calc=None, **kw):
        calls.append((np.array(a), calc, kw))
        return _Res(1.0)

    monkeypatch.setattr(superman_tpu, "permanent", record)
    monkeypatch.setattr(jax_oracle, "perman64", lambda a: 1.0)
    assert jax_fuzz.run(trials=40, seed=seed, **QUIET) == 0
    ours = list(fuzz.draw_trials(40, seed))
    assert len(ours) == len(calls) == 40
    for t, (a, calc, kw) in zip(ours, calls):
        assert t.a.dtype == a.dtype
        np.testing.assert_array_equal(t.a, a)
        assert (t.calc, t.kw) == (calc, kw)
    assert fuzz.EPS == jax_fuzz.EPS


def test_fuzz_runs_clean_on_the_cpu():
    assert fuzz.run(trials=5, seed=123, device="cpu", **QUIET) == 0


def test_fuzz_holds_a_trial_to_the_tier_that_ran():
    """Trial 65 of seed 1 (found on the card): calc="tf96" with Glynn on a
    real matrix at 1e-6 with no perfect matching.  Its storage is not
    exact in float32, so both packages walk it in df64, with a warning;
    the walk's noise (~1e-152 where the permanent is 0) is inside df64's
    floor and outside tf96's, which the JAX tool applies."""
    t = list(fuzz.draw_trials(66, 1))[65]
    assert (t.n, t.calc, t.kw, t.mag) == (22, "tf96",
                                          {"perman_algo": "glynn"}, 1e-6)
    with pytest.warns(UserWarning, match="falling back to df64"):
        res = spt.permanent(t.a, device="cpu", calc=t.calc, **t.kw)
    assert fuzz.ran_tier(t.calc, res.algo_name) == "df64"
    want = float(jax_oracle.perman64(t.a))
    assert fuzz.agrees(t, res.permanent, "df64", want)
    assert not fuzz.agrees(t, res.permanent, "tf96", want)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Both packages' full accuracy sweeps of one seeded n=14 file."""
    root = str(tmp_path_factory.mktemp("acc"))
    path, = corpus.write_int_suite(root, 0, ns=(14,), densities=("0.50",))
    ours, bad = accuracy.run_sweep([path], device="cpu", **QUIET)
    theirs, jbad = jax_accuracy.run_sweep([path], **QUIET)
    return ours, bad, theirs, jbad


@pytest.mark.parametrize("config", [c[0] for c in jax_accuracy.SWEEP])
def test_accuracy_records_match_the_reference(config, sweeps):
    """Config by config: the same SWEEP entry, the same verdict, and the
    value within the config's tolerance of the JAX package's (the
    estimators, tolerance None, are recorded, not compared)."""
    ours, bad, theirs, jbad = sweeps
    assert not bad and not jbad
    assert [r["config"] for r in ours] == [r["config"] for r in theirs]
    spec = dict((c[0], c) for c in accuracy.SWEEP)[config]
    assert spec == dict((c[0], c) for c in jax_accuracy.SWEEP)[config]
    assert accuracy.QUICK == jax_accuracy.QUICK
    mine = next(r for r in ours if r["config"] == config)
    ref = next(r for r in theirs if r["config"] == config)
    assert mine.get("agrees") == ref.get("agrees")
    tol = spec[2]
    if tol is not None:
        assert mine["permanent"] == pytest.approx(ref["permanent"], rel=tol)


def test_suite_check_rows_match_the_reference(suite16):
    """df64 against the native double engine on the n=16 suite: each row
    within 1e-10 of the JAX tool's, and the worst difference too."""
    rows, worst = suite_check.check(suite16, device="cpu", **QUIET)
    jrows, jworst = jax_suite_check.check(suite16, **QUIET)
    assert [r["file"] for r in rows] == [r["file"] for r in jrows]
    for r, j in zip(rows, jrows):
        assert r["card"] == pytest.approx(j["tpu"], rel=1e-10)
        assert r["native_double"] == pytest.approx(j["native_double"],
                                                   rel=1e-10)
        assert r["rel_diff"] <= 1e-10 and r["device"] == "cpu"
    assert worst <= 1e-10 and jworst <= 1e-10


def test_sparse_report_rows_match_the_reference(suite16, tmp_path):
    """The pruned walk against the native engine on the n=16 suite, each
    row within 1e-10 of the JAX tool's; the native values read from a
    suite_check output are the ones computed fresh."""
    sparse = suite16[:3]
    out = str(tmp_path / "check.jsonl")
    suite_check.check(sparse, out=out, device="cpu", **QUIET)
    rows, worst = sparse_report.run(sparse, device="cpu", **QUIET)
    read, _ = sparse_report.run(sparse, device="cpu", native_from=out,
                                **QUIET)
    # repo_root: the JAX tool reads native values from SUITE_REPORT*.jsonl
    # there, keyed by file names the seeded suite shares
    jrows, jworst = jax_sparse_report.run(sparse, repo_root=str(tmp_path),
                                          **QUIET)
    assert [r["file"] for r in rows] == [r["file"] for r in jrows]
    for r, q, j in zip(rows, read, jrows):
        assert r["sparse"] == pytest.approx(j["sparse"], rel=1e-10)
        assert r["native_double"] == pytest.approx(j["native_double"],
                                                   rel=1e-10)
        assert q["native_double"] == r["native_double"]
    assert worst <= 1e-10 and jworst <= 1e-10


@pytest.mark.parametrize("shards", [8, 64])
def test_sparse_layout_beats_the_reference_on_one_plan(shards):
    """The JAX tool's n=36 d=0.10 layout table against the port's on the
    same plan (the JAX planner's, walked by both): the same live chunks,
    and a useful fraction at least the JAX table's (the port splits and
    deals block rows round-robin, where the JAX tool pads contiguous
    shards)."""
    jmeta, jrows = jax_scaling.quantization_table(36, 0.10)
    from superman_tpu.ops.pruning import plan_sparse as jax_plan
    rng = np.random.default_rng(0)
    a = ((rng.random((36, 36)) < 0.10) * rng.integers(1, 9, (36, 36))
         ).astype(np.float64)
    np.fill_diagonal(a, rng.integers(1, 9, 36))
    plan = pruning.plan_from_jax(jax_plan(a, chunk_log2=None, df=True,
                                          allow_factor=True))
    meta, rows = scaling_measure.quantization_table(36, 0.10, plan=plan)
    assert meta["live_chunks"] == jmeta["live_chunks"]
    mine = next(r for r in rows if r["shards"] == shards)
    ref = next(r for r in jrows if r["shards"] == shards)
    assert mine["useful_frac"] >= ref["useful_frac"]
    assert mine["live_lane_max"] - mine["live_lane_min"] <= 128


def test_modp_ledger_is_chip_smokes_k3_count():
    """modp_rate counts a Z_p step as chip_smoke.py's K3 bound does:
    2n + 6(n-1) + 2 int32 operations, and chip_smoke takes it from
    there."""
    led = modp_rate.ledger_ops_per_step(32)
    assert led["total"] == 2 * 32 + 6 * 31 + 2 == 252
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert re.search(r"ledger_ops_per_step\(32\)\[\"total\"\]", src)


def test_modp_rate_runs_on_the_cpu(capsys):
    assert modp_rate.main(["--n", "14", "--reps", "1", "--device",
                           "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["int32_peak_share"] is None
    assert out["ledger_int32_ops_per_step"]["total"] == 2 * 14 + 6 * 13 + 2
    assert out["value"] > 0


def test_scaling_measure_runs_on_the_cpu(tmp_path):
    out = str(tmp_path / "scaling.json")
    assert scaling_measure.main(["--n", "20", "21", "--reps", "1",
                                 "--out", out, "--device", "cpu"]) == 0
    with open(out) as f:
        d = json.load(f)
    assert set(d["cases"]) == {"n20", "n21"}
    assert {r["shards"] for r in d["sparse_layout"]["shards"]} \
        <= {1, 8, 64}
    assert {"chips_8", "chips_64"} <= set(d["efficiency_bound"])


def test_smc_flagship_on_a_small_grid():
    """The flagship's function on the 6 x 6 grid (n=18): z against the
    Kasteleyn count within the tool's limit."""
    row = smc_flagship.flagship(grid=6, trials=4000, seed=11, device="cpu",
                                warmup=False)
    assert row["algo_name"] == "approx_scaling_smc"
    assert row["n"] == 18 and abs(row["z"]) <= smc_flagship.Z_LIMIT


TOOLS = {
    "fuzz": (fuzz.main, ["--trials", "1"]),
    "accuracy": (accuracy.main, ["--n", "12"]),
    "suite_check": (suite_check.main, ["--n", "12"]),
    "sparse_report": (sparse_report.main, ["--n", "12"]),
    "modp_rate": (modp_rate.main, ["--n", "12"]),
    "smc_flagship": (smc_flagship.main, ["--grid", "4"]),
    "scaling_measure": (scaling_measure.main, ["--n", "12"]),
    "exact_known": (exact_known.main, ["--small"]),
    "real_suite": (real_suite.main, ["--small", "--quick"]),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_default_device_is_the_card(tool, monkeypatch, tmp_path):
    """Without --device a tool runs on cuda:0, and raises where CUDA is
    absent instead of falling back to the CPU."""
    main, argv = TOOLS[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv + ["--out", str(tmp_path / "out")]
             if tool not in ("fuzz", "modp_rate") else argv)
