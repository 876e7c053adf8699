"""The port's transform drivers against the JAX package's: compression,
Sinkhorn scaling, Dulmage-Mendelsohn pruning, the auto-scaled
imbalanced case, and the sanity net that certifies a pipeline's value
with the exact CRT engine.

Both packages run permanent() with the same flags on the same seeded
matrix of n <= 18 (the port on the CPU, its plain versions; the JAX
package on its host walk).  Values agree to rtol 1e-10, the engine names
agree under the port's naming (the JAX package's `xla` host walk is the
port's `walk`), and the driver's meta keys are the same.
"""

import warnings

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu_torch.drivers import runner
from tests.conftest import random_int_matrix

#: the driver-level meta keys both packages must agree on
DRIVER_KEYS = ("compression_bailout", "exact_certified_rel", "scaled",
               "compression_suspect")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_name(ref_name: str) -> str:
    """The JAX package's engine name as the port spells it."""
    return ref_name.replace("_xla_", "_walk_").replace("_pallas_", "_plain_")


def _both(a, **flags):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sp.permanent(a, **flags)
        got = spt.permanent(a, device="cpu", **flags)
    return ref, got


def _assert_same(ref, got, rtol=1e-10):
    assert got.permanent == pytest.approx(ref.permanent, rel=rtol, abs=0)
    assert got.algo_name == _port_name(ref.algo_name)
    assert ({k for k in DRIVER_KEYS if k in got.meta}
            == {k for k in DRIVER_KEYS if k in ref.meta})


def _matrix(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "sparse14":                     # folds by d1/d2 first
        a = random_int_matrix(rng, 14, 0.3, vmax=3)
        np.fill_diagonal(a, 1)
    elif kind == "dense12":
        a = random_int_matrix(rng, 12, 0.5, vmax=3)
        np.fill_diagonal(a, 1)
    elif kind == "real13":
        a = (rng.random((13, 13)) < 0.4) * rng.uniform(0.1, 4.0, (13, 13))
        np.fill_diagonal(a, 1.5)
    elif kind == "imbalanced16":
        # d2 merges make such a matrix cancellation-bound in double: the
        # compression driver applies Sinkhorn by itself
        a = (rng.random((16, 16)) < 0.2) * rng.random((16, 16)) * 1e-8
        np.fill_diagonal(a, rng.random(16) * 1e-8)
    return a


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", ["sparse14", "dense12", "real13"])
@pytest.mark.parametrize("flags", [
    {"compression": True}, {"scaling_threshold": 1.0},
    {"scaling_threshold": 2.5, "compression": True},
    {"dm_prune": True}, {"dm_prune": True, "sparse": True}])
def test_drivers_match_jax(flags, kind, seed):
    a = _matrix(kind, seed)
    ref, got = _both(a, **flags)
    _assert_same(ref, got)
    if "scaling_threshold" in flags:
        assert got.meta["scaled"] is True


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_imbalanced_core_is_auto_scaled(seed):
    a = _matrix("imbalanced16", seed)
    ref, got = _both(a, calc="df64", compression=True)
    _assert_same(ref, got)
    exact = spt.permanent(a, calc="exact", device="cpu")
    assert got.permanent == pytest.approx(float(exact.meta["exact_fraction"]),
                                          rel=1e-7)


@pytest.mark.parametrize("calc", ["f32", "f32k"])
def test_f32_tiers_are_not_certified(calc):
    """The f32 tiers would always miss a df64-class band: neither package
    replaces the requested tier with the exact value."""
    a = _matrix("sparse14", 5)
    ref, got = _both(a, compression=True, calc=calc)
    assert "exact_certified_rel" not in got.meta
    assert got.algo_name == _port_name(ref.algo_name)
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-3)


def test_auto_under_compression_keeps_bound_scope():
    """A calc="auto" err_est covers the folded core's walk only: both
    packages label it so, with the fold count."""
    a = _matrix("sparse14", 7)
    ref, got = _both(a, compression=True, calc="auto")
    _assert_same(ref, got)
    assert got.meta["auto"]["bound_scope"] == "folded_core_walk_only"
    assert got.meta["auto"]["folds"] == ref.meta["auto"]["folds"] > 0


def test_structural_zeros():
    b = np.zeros((6, 6), dtype=np.int64)
    b[:, 0] = 1
    b[0, :] = 1
    ref, got = _both(b, dm_prune=True)
    assert got.permanent == ref.permanent == 0.0
    assert got.algo_name == ref.algo_name == "dm_structural_zero"
    # two rows that can only take one column: folding leaves an empty line
    c = random_int_matrix(np.random.default_rng(9), 8, 0.6)
    np.fill_diagonal(c, 1)
    c[1] = 0
    c[2] = 0
    c[1, 4] = c[2, 4] = 3
    ref, got = _both(c, compression=True)
    assert got.permanent == ref.permanent == 0.0
    assert got.algo_name == ref.algo_name == "rank_deficient_zero"


def test_certification_is_cached(monkeypatch):
    a = _matrix("sparse14", 11)
    monkeypatch.setattr(runner, "_CERT_CACHE", {})
    first = spt.permanent(a, compression=True, device="cpu")
    assert len(runner._CERT_CACHE) == 1
    again = spt.permanent(a, compression=True, device="cpu")
    assert again.permanent == first.permanent
    assert again.meta["exact_certified_rel"] == \
        first.meta["exact_certified_rel"]


def test_core_above_16_certifies_in_the_port_not_in_jax(monkeypatch):
    """Differs from the reference on purpose.  The JAX package certifies a
    core of n > 16 only with its native library
    (superman_tpu/drivers/runner.py:116); the port walks every core on
    its device (K3 on a card, its plain version here), so the price alone
    gates the certification.  Shown with the JAX package's native library
    switched off: the same n=18 matrix, no certification there, a
    certified value here."""
    import superman_tpu.bindings.native as jnative
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    a = random_int_matrix(np.random.default_rng(18), 18, 0.6)
    np.fill_diagonal(a, 1)
    ref, got = _both(a, compression=True)
    assert "exact_certified_rel" not in ref.meta
    assert got.meta["exact_certified_rel"] <= 1e-10
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)
    exact = spt.permanent(a, calc="exact", device="cpu")
    assert got.permanent == pytest.approx(float(exact.meta["exact_fraction"]),
                                          rel=1e-12)


def test_broken_pipeline_is_replaced_by_the_exact_value(monkeypatch):
    """Where the pipeline lost the value, the certification returns the
    exact one and says what it replaced (forced here by a walk that
    returns noise)."""
    from superman_tpu_torch.core.result import Result

    def noisy_run_algo(dense, flags, device):
        return Result(1.2345, 0.0, algo_name="ryser_walk_df64")

    a = _matrix("sparse14", 13)
    monkeypatch.setattr(runner, "_CERT_CACHE", {})
    monkeypatch.setattr(runner, "run_algo", noisy_run_algo)
    got = spt.permanent(a, compression=True, device="cpu")
    exact = spt.permanent(a, calc="exact", device="cpu")
    assert got.meta["compression_bailout"] == "exact_crt"
    assert got.algo_name == "exact_crt"
    assert got.meta["replaced"] == {"value": 1.2345,
                                    "algo": "ryser_walk_df64"}
    assert got.meta["exact_fraction"] == exact.meta["exact_fraction"]


def test_certified_value_off_by_more_than_1e9_is_replaced(monkeypatch):
    """Differs from the reference on purpose: the JAX package keeps a
    certified pipeline value up to 1e-6 off the exact one
    (superman_tpu/drivers/runner.py:133); the port replaces it from
    CERT_REL_TOL = 1e-9 on, the double-class limit.  d34 splits can leave
    cores much worse conditioned than their matrix: on the card the
    sparse n=40 matrix of chip_smoke.py came out 5.6e-7 off under
    compression.  Shown here with both packages' engines returning the
    exact value times (1 + 1e-7)."""
    import superman_tpu.drivers.runner as jrunner
    from superman_tpu.core.result import Result as JResult
    from superman_tpu_torch.core.result import Result

    a = _matrix("sparse14", 17)
    want = float(spt.permanent(a, calc="exact",
                               device="cpu").meta["exact_fraction"])
    off = want * (1 + 1e-7)
    monkeypatch.setattr(jrunner, "_CERT_CACHE", {})
    monkeypatch.setattr(runner, "_CERT_CACHE", {})
    monkeypatch.setattr(jrunner, "run_algo",
                        lambda dense, flags: JResult(off, 0.0, "ryser_xla_df64"))
    monkeypatch.setattr(runner, "run_algo",
                        lambda dense, flags, device: Result(
                            off, 0.0, "ryser_walk_df64"))
    ref, got = _both(a, compression=True)
    assert ref.permanent == off
    assert ref.meta["exact_certified_rel"] == pytest.approx(1e-7, rel=1e-2)
    assert got.permanent == want
    assert got.meta["compression_bailout"] == "exact_crt"
    assert got.meta["replaced"]["value"] == off
