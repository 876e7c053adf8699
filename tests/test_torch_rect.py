"""Rectangular permanents in the port against the JAX package:
per_rect(A) = per([A; ones(n-m, n)]) / (n-m)! (api._pad_rect), on the
CPU."""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu.api as japi
import superman_tpu_torch as spt
import superman_tpu_torch.api as api
from superman_tpu_torch.core.flags import Flags


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def per_rect_brute(a):
    m, n = a.shape
    if m > n:
        a = a.T
        m, n = n, m
    tot = 0
    for cols in itertools.permutations(range(n), m):
        p = 1
        for i, j in enumerate(cols):
            p *= a[i, j]
        tot += p
    return tot


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(5, 8), (8, 5), (3, 7)])
def test_rect_matches_jax(shape, seed):
    a = np.random.default_rng(seed).uniform(-1.0, 3.0, shape)
    ref = sp.permanent(a, rectangular=True)
    got = spt.permanent(a, rectangular=True, device="cpu")
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-12)
    assert got.permanent == pytest.approx(per_rect_brute(a), rel=1e-12)
    m, n = sorted(shape)
    assert got.meta["rect_shape"] == ref.meta["rect_shape"] == [m, n]
    assert got.meta["pad_rows"] == ref.meta["pad_rows"] == n - m


def test_rect_transpose_convention():
    a = np.random.default_rng(3).uniform(0.0, 2.0, (5, 8))
    assert spt.permanent(a, rectangular=True, device="cpu").permanent == \
        spt.permanent(a.T, rectangular=True, device="cpu").permanent


@pytest.mark.parametrize("calc", ["df64", "tf96", "exact"])
def test_rect_int_storage_exact(calc):
    """Integer input keeps int storage through the ones padding, so the
    exact-f32 tiers stay reachable and the integer comes back exactly."""
    a = np.random.default_rng(4).integers(0, 4, (5, 8))
    got = spt.permanent(a, rectangular=True, calc=calc, device="cpu")
    assert got.permanent == float(per_rect_brute(a))
    assert got.permanent == sp.permanent(a, rectangular=True,
                                         calc=calc).permanent


def test_reused_flags_give_the_square_matrix_its_own_permanent():
    """Differs from the reference on purpose (superman_tpu/api.py:45): its
    _pad_rect stores the shape on the Flags, so the same Flags reused for
    a square matrix would divide that permanent by (n-m)!.  The port hands
    the shape back instead."""
    rng = np.random.default_rng(5)
    rect = rng.integers(0, 3, (5, 8))
    square = rng.integers(0, 3, (8, 8))
    want = float(per_rect_brute(square))
    # the reference's defect: the stale shape stays on its Flags
    jflags = japi.Flags(rectangular=True)
    japi._as_dense(rect, jflags)
    japi._as_dense(square, jflags)
    assert jflags._rect == (5, 8)
    # the port: one Flags for both, each call its own shape
    flags = Flags(rectangular=True)
    _, shape_r = api._as_dense(rect, flags)
    _, shape_s = api._as_dense(square, flags)
    assert shape_r == (5, 8) and shape_s is None
    assert not hasattr(flags, "_rect")
    kw = dataclasses.asdict(flags)
    first = spt.permanent(rect, device="cpu", **kw)
    assert first.permanent == float(per_rect_brute(rect))
    again = spt.permanent(square, device="cpu", **kw)
    assert again.permanent == want
    assert "rect_shape" not in again.meta


def test_rect_rejected_without_flag():
    with pytest.raises(ValueError, match="square"):
        spt.permanent(np.ones((3, 5)), device="cpu")


@pytest.mark.parametrize("algo,trials", [("scaling", 40000),
                                         ("gurvits", 200000)])
def test_rect_estimators(algo, trials):
    """The padding identity is algebraic, so the estimators run on the
    padded matrix too; value and stderr are divided by (n-m)!."""
    rng = np.random.default_rng(6)
    a = (rng.uniform(0.2, 2.0, (4, 7)) if algo == "scaling"
         else rng.integers(-2, 3, (4, 6)).astype(np.float64))
    want = per_rect_brute(a)
    got = spt.permanent(a, rectangular=True, approximation=True,
                        perman_algo=algo, number_of_times=trials, seed=4,
                        device="cpu")
    se = got.meta["stderr"]
    assert np.isfinite(se) and se > 0
    assert abs(got.permanent - want) <= 4 * se


def test_rect_mtx_reader(tmp_path):
    p = tmp_path / "r.mtx"
    p.write_text("%%MatrixMarket matrix coordinate integer general\n"
                 "2 4 5\n1 1 2\n1 3 1\n2 2 1\n2 4 3\n1 4 1\n")
    a = np.array([[2, 0, 1, 1], [0, 1, 0, 3]])
    got = spt.permanent(str(p), rectangular=True, device="cpu")
    assert got.permanent == float(per_rect_brute(a))
    with pytest.raises(ValueError, match="square"):
        spt.permanent(str(p), device="cpu")


def test_unpad_in_log_space_past_170_factorial():
    res = spt.Result(1e300, 0.0, meta={"log2_estimate": 996.6, "stderr": 1e299})
    out = api._unpad_rect_result(res, (10, 200))
    fact_l2 = math.lgamma(191) / math.log(2.0)
    assert out.meta["log2_estimate"] == pytest.approx(996.6 - fact_l2)
    assert out.permanent == pytest.approx(
        2.0 ** (math.log2(1e300) - fact_l2), rel=1e-12)
    assert out.meta["pad_rows"] == 190
