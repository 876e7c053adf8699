"""SUPERMAN_DEBUG_NANS in the port (superman_tpu_torch/utils/debug.py)
against the reference's switch (superman_tpu/__init__.py:35-39, which
turns on jax_debug_nans at import).

The port reads the variable at every call, so these tests set it with
monkeypatch; the reference reads it at import, so it runs in a
subprocess.  The port runs on the CPU (device="cpu", the kernels' plain
versions, which the switch checks as it checks the kernels' outputs).

A NaN entry given to permanent() is a ValueError before any walk
(test_torch_nonfinite.py), so a NaN is injected here below the API: in
the packed x0 given to each walk, or in the estimators' device matrices.
"""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import superman_tpu_torch as spt
from superman_tpu_torch.ops import approx, batch, gray
from superman_tpu_torch.ops.oracle import gray_init_lanes, perman64
from superman_tpu_torch.ops.ryser_walk import ryser_walk, walk_lanes
from superman_tpu_torch.parallel import sharding
from superman_tpu_torch.utils import debug
from tests.conftest import random_int_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TIERS = ("df64", "f32", "f32k", "tf96")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _sparse20():
    """A seeded sparse n=20 integer matrix with a full diagonal, on which
    sparse=True plans a pruned, factored walk."""
    rng = np.random.default_rng(5)
    a = (rng.random((20, 20)) < 0.18) * rng.integers(1, 4, (20, 20))
    np.fill_diagonal(a, 1)
    return a


def _int(n, seed):
    return random_int_matrix(np.random.default_rng(seed), n, 0.5, vmax=3)


def _signed(n, seed):
    return np.random.default_rng(seed).integers(-2, 3, (n, n))


def _binary(n, seed):
    return (np.random.default_rng(seed).random((n, n)) < 0.5).astype(
        np.int64) + np.eye(n, dtype=np.int64)


# Every path the switch checks on clean input.  From n=19 the dense tiers
# walk chunks (K1's plain version, through parallel/sharding.py); below
# it they take the float64 walk (walk_lanes), so the chunked cases are
# n=20 at a small r, the sparse one too (the pruned walk plans only from
# n=19).  The estimators at a fixed seed.
CHUNKED = dict(chunk_log2=6, lanes=256)
CLEAN = {
    **{tier: (lambda: _int(20, 20), dict(calc=tier, **CHUNKED))
       for tier in TIERS},
    "f64": (lambda: _int(16, 16), dict(calc="f64")),
    "walk_n16_df64": (lambda: _int(16, 16), dict(calc="df64")),
    "glynn": (lambda: _int(20, 20), dict(perman_algo="glynn", **CHUNKED)),
    "sparse": (_sparse20, dict(sparse=True, chunk_log2=8, lanes=256)),
    "auto_probe": (lambda: _int(20, 20), dict(calc="auto", **CHUNKED)),
    "rasmussen": (lambda: _binary(16, 1),
                  dict(approximation=True, perman_algo="rasmussen",
                       number_of_times=4096, seed=7)),
    "gurvits": (lambda: _signed(12, 2),
                dict(approximation=True, perman_algo="gurvits",
                     number_of_times=4096, seed=7)),
    "scaling": (lambda: _binary(16, 3),
                dict(approximation=True, perman_algo="scaling",
                     number_of_times=4096, seed=7)),
    "smc": (lambda: _binary(16, 4),
            dict(approximation=True, perman_algo="scaling", smc=1,
                 number_of_times=2048, seed=7)),
    "batch": (lambda: [_int(14, s) for s in range(4)], {}),
    "batch_small_orders": (lambda: [_int(10, s) for s in range(3)], {}),
}


def _run(case):
    make, kw = CLEAN[case]
    a = make()
    if case.startswith("batch"):
        return [r.permanent for r in spt.permanent_batch(a, device="cpu")]
    res = spt.permanent(a, device="cpu", **kw)
    if case == "auto_probe":
        assert res.meta["auto"]["probe_only"] is True
    return [res.permanent]


@pytest.mark.parametrize("case", sorted(CLEAN))
def test_switch_on_clean_input_is_bitwise_unchanged(case, monkeypatch):
    """Each path gives the same bits with the switch on as with it off,
    and with it on it went through at least one check."""
    monkeypatch.delenv(debug.ENV, raising=False)
    off = _run(case)
    checks = []
    real = debug.debug_nans
    monkeypatch.setattr(debug, "debug_nans",
                        lambda: checks.append(1) or real())
    monkeypatch.setenv(debug.ENV, "1")
    on = _run(case)
    assert [v.hex() for v in on] == [v.hex() for v in off]
    assert np.isfinite(on).all()
    assert checks, "the path reached no check"


# ----------------------------------------------------- NaN below the API

def _pack(n, n_pad=None):
    """The packed walk of a seeded n x n integer matrix, scaled by 1/4,
    with its x0[0] made NaN: (x0, cols) float64."""
    a = _int(n, n) / 4.0
    x0, cols = gray.pack_matrix(a, n_pad or gray.pad_n(n))
    x0 = x0.copy()
    x0[0] = np.nan
    return x0, cols


def _k1(tier):
    plan = gray.make_plan(14, 256, 5)
    x0, cols = _pack(14)
    ids = sharding.pad_ids(np.arange(plan.num_chunks), plan.lanes)
    return lambda: sharding.compute_partials(ids, x0, cols, plan, CPU, tier)


def _blocks(tier):
    plan = gray.make_plan(14, 256, 5)
    x0, cols = _pack(14)
    return lambda: sharding.compute_total(x0, cols, plan, CPU, tier)


def _reduced(tier):
    # 12 alive rows and 2 factored ones of an order-14 walk
    n, nf = 14, 2
    a = _int(n, n) / 4.0
    x0, cols = gray.pack_matrix(a[nf:], gray.pad_n(n - nf))
    fx0, fcols = gray.pack_matrix(a[:nf], nf)
    x0 = x0.copy()
    x0[0] = np.nan
    plan = gray.RyserPlan(n=n, n_pad=len(x0), r=5, lanes=256,
                          num_chunks=1 << (n - 1 - 5))
    ids = np.arange(0, plan.num_chunks, 3, dtype=np.int64)
    return lambda: sharding.compute_total(x0, cols, plan, CPU, tier,
                                          sparse=(ids, fx0, fcols), sms=2)


def _amp(cond):
    plan = gray.make_plan(14, 256, 5)
    x0, cols = _pack(14)
    ids = sharding.pad_ids(np.arange(plan.num_chunks), plan.lanes)
    return lambda: sharding.compute_amp(ids, x0, cols, plan, CPU, cond)


def _batch(tier):
    stack = np.stack([_int(14, s) for s in range(3)]).astype(np.float64)
    x0p, colsT, _, _ = batch.pack_stack(stack)
    x0p[1, 2] = np.nan
    return lambda: batch.walk_stack(x0p, colsT, n=14, r=5, calc=tier,
                                    device=CPU)


def _lanes(dtype):
    a = _int(12, 12).astype(np.float64)
    a[4, 7] = np.nan
    r = 4
    X, sign_mid = gray_init_lanes(a, np.arange(1 << (11 - r)), r,
                                  dtype=np.float64)
    cols = torch.as_tensor(np.ascontiguousarray(a[:, :11].T)).to(dtype)
    return lambda: walk_lanes(torch.as_tensor(X).to(dtype),
                              torch.as_tensor(sign_mid).to(dtype), cols, r)


def _nan_matrices(n=10, seed=0):
    """(a, a^T, support, support^T) of a seeded 0/1 matrix whose row 3 is
    NaN: every trial meets it when it matches row 3."""
    a = _binary(n, seed).astype(np.float64)
    a[3] = np.nan
    return approx._device_matrices(a, CPU)


def _gen():
    g = torch.Generator(device=CPU)
    g.manual_seed(3)
    return g


def _rasmussen():
    # Rasmussen walks the support, which holds a 1 where a holds a NaN:
    # the NaN goes into the support itself
    nz = approx._device_matrices(_binary(10, 0), CPU)[2].clone()
    nz[3] = float("nan")
    return lambda: approx._rasmussen_trial(nz, 64, _gen())


def _gurvits():
    at = _nan_matrices()[0]
    x = torch.randn(64, at.shape[0], generator=_gen())
    return lambda: approx._gurvits_trial(at, x)


def _scaling():
    mats = _nan_matrices()
    return lambda: approx._scaling_trial(*mats, 64, _gen(), 2, 3)


def _smc():
    mats = _nan_matrices(n=18)
    ones = torch.ones(18)
    return lambda: approx._smc_population(*mats, ones, ones, _gen(),
                                          scale_intervals=2, scale_times=3,
                                          B=64)


# (what the message names, the call, the outputs it hands back)
INJECTED = {
    **{f"k1_{t}": (f"ryser_walk_{t}", lambda t=t: _k1(t)) for t in TIERS},
    **{f"blocks_{t}": (f"ryser_walk_blocks ({t})", lambda t=t: _blocks(t))
       for t in TIERS if t != "tf96"},
    **{f"reduced_{t}": (f"ryser_walk_reduced ({t})",
                        lambda t=t: _reduced(t)) for t in TIERS},
    "amp": ("ryser_walk_amp", lambda: _amp(False)),
    "amp_cond": ("ryser_walk_amp_cond", lambda: _amp(True)),
    **{f"batch_{t}": (f"ryser_batch ({t})", lambda t=t: _batch(t))
       for t in TIERS},
    "walk_lanes_f64": ("walk_lanes (float64)",
                       lambda: _lanes(torch.float64)),
    "walk_lanes_f32": ("walk_lanes (float32)",
                       lambda: _lanes(torch.float32)),
    "rasmussen": ("_rasmussen_trial", _rasmussen),
    "gurvits": ("_gurvits_trial", _gurvits),
    "scaling": ("_scaling_trial", _scaling),
    "smc": ("_smc_population", _smc),
}


def _has_nan(out) -> bool:
    if isinstance(out, tuple):
        return any(_has_nan(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    return bool(np.isnan(np.asarray(out, dtype=np.float64)).any())


@pytest.mark.parametrize("entry", sorted(INJECTED))
def test_injected_nan_raises_under_the_switch(entry, monkeypatch):
    """A NaN in a walk's x0 (or an estimator's matrix) comes out as NaN
    with the switch off, as today, and raises FloatingPointError naming
    the kernel (and tier) with it on."""
    name, make = INJECTED[entry]
    call = make()
    monkeypatch.delenv(debug.ENV, raising=False)
    assert _has_nan(call())
    monkeypatch.setenv(debug.ENV, "1")
    with pytest.raises(FloatingPointError,
                       match=r"invalid value \(nan\) in the output of "
                             + re.escape(name) + "$"):
        call()


def test_switch_reads_the_environment_at_call_time(monkeypatch):
    """Set, the check raises; unset again in the same process, the same
    call returns NaN: nothing is latched at import or at first use."""
    call = _lanes(torch.float64)
    monkeypatch.setenv(debug.ENV, "1")
    with pytest.raises(FloatingPointError):
        call()
    monkeypatch.setenv(debug.ENV, "")
    assert _has_nan(call())


def test_an_inf_output_passes_as_in_jax_debug_nans(monkeypatch):
    """jax_debug_nans looks for NaN only (Inf is jax_debug_infs, which the
    reference never sets); so does the port."""
    monkeypatch.setenv(debug.ENV, "1")
    debug.check_nan("x", np.array([np.inf, -np.inf, 1.0]))
    debug.check_nan("x", torch.tensor([float("inf")]))
    with pytest.raises(FloatingPointError, match="output of x$"):
        debug.check_nan("x", torch.tensor([1.0, float("nan")]))


# ------------------------------------------------------- the reference

REFERENCE = """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import superman_tpu as sp
a = np.ones((16, 16))
a[3, 5] = np.nan
try:
    print("value", sp.permanent(a).permanent)
except FloatingPointError as e:
    print("FloatingPointError", e)
b = np.load({clean!r})
print("clean", sp.permanent(b, calc="df64").permanent.hex())
"""


def _clean16():
    """A seeded 0/1 n=16 matrix of density 0.3.  Each |x_j| of the walk is
    at most half row j's sum, so every term is a multiple of 2^-16 of at
    most prod_j rowsum_j units, and the 2^15 of them a lane walks, or the
    host adds, stay below 2^53 units: both packages' float64 walks are
    exact and must agree bit for bit."""
    b = (np.random.default_rng(16).random((16, 16)) < 0.3).astype(np.int64)
    assert math.prod(int(s) for s in b.sum(axis=1)) << 15 < 1 << 53
    return b


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference under SUPERMAN_DEBUG_NANS=1, in a process of its own
    (it reads the variable at import): its lines by first word."""
    path = str(tmp_path_factory.mktemp("ref") / "clean16.npy")
    np.save(path, _clean16())
    env = dict(os.environ, SUPERMAN_DEBUG_NANS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c",
                           REFERENCE.format(clean=path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return {line.split()[0]: line for line in proc.stdout.splitlines()}


def test_both_packages_raise_on_the_same_nan_walk(reference_run,
                                                  monkeypatch):
    """The n=16 all-ones matrix with one NaN: the reference raises in its
    walk; the port, given the matrix at its walk (ryser_walk, which packs
    it and walks walk_lanes), raises too.  Through permanent() the port
    refuses the entry first, with a ValueError: the one deliberate
    difference."""
    assert "FloatingPointError" in reference_run, reference_run
    a = np.ones((16, 16))
    a[3, 5] = np.nan
    monkeypatch.setenv(debug.ENV, "1")
    with pytest.raises(FloatingPointError, match="walk_lanes"):
        ryser_walk(a, CPU)
    with pytest.raises(ValueError, match=r"entry \(3, 5\) is nan"):
        spt.permanent(a, device="cpu")


def test_both_packages_agree_bitwise_on_a_clean_walk(reference_run,
                                                     monkeypatch):
    """Both packages with the switch on give the same df64 value on a
    clean seeded n=16 matrix, bit for bit, and it is the exact one."""
    b = _clean16()
    monkeypatch.setenv(debug.ENV, "1")
    got = spt.permanent(b, calc="df64", device="cpu").permanent
    assert reference_run["clean"].split()[1] == got.hex()
    assert got == perman64(b)
