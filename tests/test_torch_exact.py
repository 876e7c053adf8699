"""The port's calc="exact" engine against the JAX package's.

Seeded numpy matrices go through ``superman_tpu_torch.permanent(a,
calc="exact", device="cpu")`` (the Z_p kernel's plain version) and the
JAX package's exact engine (its pure-Python Z_p walk, engine="host",
and its Pallas Z_p kernel in interpret mode).  Both return an exact
Fraction, so every comparison is exact.
"""

import os
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu.ops import exact as jexact
from superman_tpu_torch.ops import exact, modp
from superman_tpu_torch.tools.corpus import suite_matrix
from tests.conftest import random_int_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores and slows the walks tenfold
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _matrix(kind):
    rng = np.random.default_rng(5)
    if kind.startswith("int"):
        n = int(kind[3:])
        return random_int_matrix(np.random.default_rng(n), n, 0.6)
    if kind == "dyadic":          # real entries with up to 2^-7 fractions
        a = rng.integers(-300, 300, (9, 9)) / 128.0
        return a * (rng.random((9, 9)) < 0.8)
    if kind == "zero":            # structurally zero: an empty column
        a = random_int_matrix(rng, 8, 0.7)
        a[:, 3] = 0
        return a
    if kind == "folded":          # a permutation-like matrix folds away
        a = np.zeros((7, 7))
        a[np.arange(7), np.roll(np.arange(7), 2)] = np.arange(1, 8) * 1.5
        return a
    if kind == "float":           # arbitrary doubles are dyadic too
        return rng.random((8, 8)) * (rng.random((8, 8)) < 0.7)
    raise ValueError(kind)


KINDS = ["int8", "int11", "int12", "dyadic", "zero", "folded", "float"]


@pytest.mark.parametrize("kind", KINDS)
def test_host_steps_match_jax(kind):
    """dyadic_int_matrix, _fold_lines and _log2_bound are copied code."""
    a = _matrix(kind)
    m, k = exact.dyadic_int_matrix(a)
    assert (m, k) == jexact.dyadic_int_matrix(a)
    core, mult = exact._fold_lines([row[:] for row in m])
    assert (core, mult) == jexact._fold_lines([row[:] for row in m])
    if core:
        assert exact._log2_bound(core) == jexact._log2_bound(core)


@pytest.mark.parametrize("kind", KINDS)
def test_permanent_exact_matches_jax(kind):
    """permanent(a, calc="exact") on the CPU gives exactly the JAX
    package's Fraction, and the same meta."""
    a = _matrix(kind)
    want, jmeta = jexact.perman_exact_fraction(a, engine="host")
    res = spt.permanent(a, calc="exact", device="cpu")
    assert res.meta["exact_fraction"] == want
    assert isinstance(res.meta["exact_fraction"], Fraction)
    assert res.algo_name == "exact_crt"
    assert res.permanent == float(want)
    meta = res.meta["exact"]
    assert meta["core_n"] == jmeta["core_n"]
    assert meta["k"] == jmeta["k"]
    assert meta["log2"] == (jexact.log2_abs_fraction(want) if want
                            else -np.inf)
    if kind == "zero":
        assert want == 0
    elif kind == "folded":
        assert meta["engine"] == jmeta["engine"] == "fold_only"
        assert meta["nprimes"] == 0
    else:
        assert meta["engine"] == "plain_mod"
        assert meta["nprimes"] >= 1


def test_permanent_exact_matches_jax_result():
    """The whole Result against sp.permanent(calc="exact"): value,
    algorithm name, Fraction and the "exact" dict but for the engine
    and prime count, which differ by design (31-bit card primes)."""
    a = _matrix("int11")
    want = sp.permanent(a, calc="exact")
    got = spt.permanent(a, calc="exact", device="cpu")
    assert got.permanent == want.permanent
    assert got.algo_name == want.algo_name
    assert got.meta["exact_fraction"] == want.meta["exact_fraction"]
    for key in ("log2", "core_n", "k"):
        assert got.meta["exact"][key] == want.meta["exact"][key], key


def test_exact_meta_reports_the_plan_search(monkeypatch):
    """On a miss of the plan cache calc="exact" reports the planner's
    counts as meta["exact"]["plan_search"] (a core of n=20: r 7 alone,
    3 candidates; below n=19 the planner searches nothing); a hit plans
    nothing and reports none."""
    monkeypatch.setattr(modp, "_PLAN_CACHE", {})
    res = spt.permanent(suite_matrix(1, 20, "0.50", 0), calc="exact",
                        device="cpu")
    search = res.meta["exact"]["plan_search"]
    assert search["candidates"] == 3 and search["patterns_built"] >= 1
    a = _matrix("int12")
    first = spt.permanent(a, calc="exact", device="cpu")
    assert first.meta["exact"]["plan_search"] == {
        "candidates": 0, "patterns_built": 0, "patterns_reused": 0}
    again = spt.permanent(a, calc="exact", device="cpu")
    assert "plan_search" not in again.meta["exact"]
    assert again.permanent == first.permanent


def test_device_engine_matches_jax_tpu_engine():
    """The port's Z_p walk and the JAX package's Z_p kernel (interpret
    mode) through their CRT drivers: the same Fraction."""
    a = random_int_matrix(np.random.default_rng(13), 10, 0.7)
    want, jmeta = jexact.perman_exact_fraction(a, engine="tpu")
    got, meta = exact.perman_exact_fraction(a, CPU)
    assert got == want
    assert jmeta["engine"] == "tpu_mod" and meta["engine"] == "plain_mod"
    assert meta["bound_bits"] == jmeta["bound_bits"]


def test_engine_selection():
    a = _matrix("int12")
    want, _ = jexact.perman_exact_fraction(a, engine="host")
    got, meta = exact.perman_exact_fraction(a, CPU, engine="host")
    assert got == want and meta["engine"] == "host_mod"
    assert exact.perman_exact_fraction(a, CPU, engine="device")[0] == want
    got, meta = exact.perman_exact_fraction(a, CPU, engine="native",
                                            threads=2)
    assert got == want and meta["engine"] == "native_mod"
    with pytest.raises(ValueError, match="unknown exact engine"):
        exact.perman_exact_fraction(a, CPU, engine="tpu")
    big = random_int_matrix(np.random.default_rng(17), 17, 0.9)
    with pytest.raises(ValueError, match="n <= 16"):
        exact.perman_exact_fraction(big, CPU, engine="host")


@pytest.mark.parametrize("flags", [
    {"sparse": True}, {"compression": True}, {"scaling_threshold": 1.0},
    {"checkpoint_path": "journal"}])
def test_exact_routes_before_the_guards(flags):
    """As in the JAX package, calc="exact" runs before the sparse,
    compression, scaling and checkpoint guards (it folds exactly itself)."""
    a = _matrix("int8")
    want, _ = jexact.perman_exact_fraction(a, engine="host")
    res = spt.permanent(a, calc="exact", device="cpu", **flags)
    assert res.meta["exact_fraction"] == want


def test_exact_with_approximation_still_raises():
    """calc="exact" with approximation=True runs the estimator (the name
    is kept from when that pair raised).  approximation=True wins over calc="exact", as in the JAX package:
    the estimator runs (not the exact engine), with hybrid=True too, where
    the estimators' hybrid CPU trial worker (cpu=True) takes its trials
    from the same budget."""
    res = spt.permanent(_matrix("int8"), calc="exact", approximation=True,
                        number_of_times=1000, device="cpu")
    assert res.algo_name == "approx_scaling"
    assert "exact_fraction" not in res.meta
    want = float(exact.perman_exact_fraction(_matrix("int8"), CPU)[0])
    for cpu in (False, True):
        hyb = spt.permanent(_matrix("int8"), calc="exact",
                            approximation=True, hybrid=True, cpu=cpu,
                            number_of_times=60000, threads=2, device="cpu")
        assert hyb.algo_name == "approx_scaling" + ("_hybrid" if cpu else "")
        assert "exact_fraction" not in hyb.meta
        assert hyb.meta["trials"] == 60000
        assert abs(hyb.permanent - want) <= 4 * hyb.meta["stderr"]


def test_exact_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spt.permanent(_matrix("int8"), calc="exact")


def test_cli_exact_prints_value(tmp_path):
    """python -m superman_tpu_torch -f <triplet> --calc exact --device cpu
    reaches the exact engine and prints the JAX package's value."""
    a = _matrix("int11")
    path = tmp_path / "m11.txt"
    from superman_tpu.core.matrix import DenseMatrix
    from superman_tpu.io.triplet import write_triplet
    write_triplet(str(path), DenseMatrix(a, "int"))
    want = sp.permanent(str(path), calc="exact").permanent
    proc = subprocess.run(
        [sys.executable, "-m", "superman_tpu_torch", "-f", str(path),
         "--calc", "exact", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("Result || exact_crt | ")
    got = float(line.split("|")[-1].split(" in ")[0])
    assert got == want
