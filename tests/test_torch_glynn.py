"""The port's Glynn engine against the JAX package's and against the
port's own Ryser engine.

Inputs come from seeded numpy generators; the JAX side runs its Pallas
kernel in interpret mode on the CPU, the port its kernel's plain PyTorch
version (device="cpu").  Glynn shares the walk kernel with Ryser and
none of its host code, so agreement of the two formulas is the check
that neither has.
"""

import warnings

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu.ops import glynn as jglynn
from superman_tpu.ops.oracle import perman_brute
from superman_tpu_torch.core.flags import Flags
from superman_tpu_torch.core.matrix import DenseMatrix
from superman_tpu_torch.ops import glynn, gray, ryser_cuda
from superman_tpu_torch.ops.oracle import perman64, perman_glynn
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


def _matrix(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return random_int_matrix(rng, n, 0.5, vmax=3)
    if kind == "sparse":
        a = random_int_matrix(rng, n, 0.2, vmax=2)
        np.fill_diagonal(a, 1)
        return a
    return random_float_matrix(rng, n, 0.6)


@pytest.mark.parametrize("kind,n", [("int", 20), ("real", 22), ("sparse", 30)])
def test_col_scales_and_pack_match_jax(kind, n):
    """_col_scales equals the reference's; _pack_glynn equals the
    reference's f32 pairs joined (gray.from_jax_pack), exactly on integer
    matrices and to the pair's ~2^-46 on real-valued ones."""
    a = _matrix(kind, n, n)
    s = glynn._col_scales(a)
    assert np.array_equal(s, jglynn._col_scales(a))
    a_s = np.ldexp(a.astype(np.float64), -s[None, :])
    n_pad = gray.pad_n(n)
    x0, cols = glynn._pack_glynn(a_s, n_pad)
    jx0, jcols = gray.from_jax_pack(*jglynn._pack_glynn(a_s, n_pad))
    assert x0.shape == jx0.shape == (n_pad,)
    assert cols.shape == jcols.shape == (n - 1, n_pad)
    if kind == "real":
        assert np.allclose(x0, jx0, rtol=2.0 ** -46, atol=0)
        assert np.allclose(cols, jcols, rtol=2.0 ** -46, atol=0)
    else:
        assert np.array_equal(x0, jx0) and np.array_equal(cols, jcols)
    assert np.all(x0[n:] == 1.0) and np.all(cols[:, n:] == 0.0)
    assert np.abs(x0[:n]).max() <= 1.0


def test_glynn_pack_walks_to_the_permanent():
    """The Glynn pack through the walk's plain version, all chunks: the
    scaled total times 2^(E+1-n) is the permanent (n=12, integers, every
    value exact, so equality)."""
    n, r = 12, 4
    a = _matrix("int", n, 12)
    s = glynn._col_scales(a)
    a_s = np.ldexp(a.astype(np.float64), -s[None, :])
    x0, cols = (torch.as_tensor(v) for v in glynn._pack_glynn(
        a_s, gray.pad_n(n)))
    ids = torch.arange(1 << (n - 1 - r))
    out = ryser_cuda.ryser_partials(ids, x0, cols, n=n, r=r, tier="tf96")
    total = float(out.sum())
    assert np.ldexp(total, int(s.sum()) + 1 - n) == perman_brute(a) != 0


#: Glynn against the reference's Glynn and the port's Ryser, per tier
TIER_TOL = {"df64": 1e-10, "tf96": 1e-13, "f32k": 1e-3, "f32": 5e-2}


@pytest.mark.parametrize("calc", ["df64", "tf96", "f32k", "f32"])
def test_glynn_exact_matches_jax_and_ryser(calc):
    """glynn_exact on the CPU in every tier, n=20 on the reference's plan:
    against the JAX glynn_exact, the port's Ryser engine and the exact
    permanent, within the tier's limit (df64 1e-10, tf96 1e-13, f32k 1e-3,
    f32 5e-2); the names are counterparts and the meta agrees."""
    a = _matrix("sparse", 20, 20)
    want = perman_brute(a)
    tol = TIER_TOL[calc]
    kw = {"calc": calc, "chunk_log2": 6, "lanes": 128}
    ref = sp.permanent(a, perman_algo="glynn", **kw)
    got = spt.permanent(a, perman_algo="glynn", device="cpu", **kw)
    ry = spt.permanent(a, device="cpu", skip_pruning=False, **kw)
    assert ref.algo_name == f"glynn_pallas_{calc}"
    assert got.algo_name == f"glynn_plain_{calc}"
    assert ry.algo_name == f"ryser_plain_{calc}"
    assert got.permanent == pytest.approx(ref.permanent, rel=tol)
    assert got.permanent == pytest.approx(ry.permanent, rel=tol)
    assert got.permanent == pytest.approx(float(want), rel=tol)
    assert got.meta["calc"] == ref.meta["calc"] == calc
    assert got.meta["scale_log2"] == ref.meta["scale_log2"]
    assert got.iterations == ref.iterations == 1 << 19


def test_glynn_real_valued_df64_matches_jax():
    """A real-valued n=20 matrix under df64: 1e-10 to the reference and
    to the long-double oracle."""
    a = _matrix("real", 20, 7)
    ref = sp.permanent(a, perman_algo="glynn", calc="df64", chunk_log2=6,
                       lanes=128)
    got = spt.permanent(a, perman_algo="glynn", calc="df64", chunk_log2=6,
                        lanes=128, device="cpu")
    assert got.meta["exact_storage"] is False
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)
    assert got.permanent == pytest.approx(
        float(perman64(a, dtype=np.longdouble)), rel=1e-10)


def test_glynn_tf96_falls_back_for_floats():
    """tf96 on storage that is not exact in f32 walks df64 and warns, in
    both packages."""
    a = _matrix("real", 20, 8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = sp.permanent(a, perman_algo="glynn", calc="tf96",
                           chunk_log2=6, lanes=128)
        got = spt.permanent(a, perman_algo="glynn", calc="tf96",
                            chunk_log2=6, lanes=128, device="cpu")
    assert sum("tf96 requires exact-f32 storage" in str(w.message)
               for w in caught) == 2
    assert ref.algo_name == "glynn_pallas_df64"
    assert got.algo_name == "glynn_plain_df64"
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)


def test_glynn_column_sums_decide_exact_storage():
    """Integer values whose column abs-sums reach 2^22 are not exact
    storage for Glynn (x is a column sum), though their rows are small."""
    a = np.ones((20, 20))
    a[:, 0] = 2.0 ** 18
    flags = Flags(calc="tf96", perman_algo="glynn", chunk_log2=6)
    with pytest.warns(UserWarning, match="tf96 requires exact-f32"):
        res = glynn.glynn_exact(DenseMatrix(a, "double"), flags, CPU)
    assert res.algo_name == "glynn_plain_df64"
    assert res.meta["exact_storage"] is False
    # 20 * 2^18 * 19! placements of the heavy column's entry
    assert res.permanent == pytest.approx(
        20 * 2.0 ** 18 * float(np.prod(np.arange(1, 20, dtype=np.float64))),
        rel=1e-10)


@pytest.mark.parametrize("calc", ["df64", "tf96", "f64"])
def test_glynn_host_route(calc):
    """n=12 takes the host walk (long double under tf96) in both
    packages, and calc="f64" takes it at any order: the value is the exact
    permanent and the name glynn_host."""
    n = 20 if calc == "f64" else 12
    a = _matrix("sparse" if n == 20 else "int", n, 3)
    want = perman_brute(a)
    ref = sp.permanent(a, perman_algo="glynn", calc=calc)
    got = spt.permanent(a, perman_algo="glynn", calc=calc, device="cpu")
    assert got.algo_name == ref.algo_name == "glynn_host"
    assert got.permanent == ref.permanent
    # float64 sums of ~2^19 integer terms of up to ~2^60 at n=20
    assert got.permanent == pytest.approx(
        float(want), rel=1e-9 if calc == "f64" else 1e-14)
    assert got.iterations == ref.iterations == 1 << (n - 1)
    dt = np.longdouble if calc == "tf96" else np.float64
    assert got.permanent == float(perman_glynn(a, dtype=dt))


def test_glynn_empty_row_early_out():
    """An empty row or column returns 0 without a walk, as the reference
    does."""
    a = _matrix("int", 20, 4)
    a[:, 5] = 0
    ref = sp.permanent(a, perman_algo="glynn", calc="df64")
    got = spt.permanent(a, perman_algo="glynn", calc="df64", device="cpu")
    assert got.permanent == ref.permanent == 0.0
    assert got.iterations == ref.iterations == 0
    assert got.meta["reason"] == ref.meta["reason"] == "empty row/col"
    assert got.algo_name == "glynn_plain_df64"


def test_glynn_underflow_retry_matches_jax():
    """A near-permutation matrix: the scaled total lands far below 2^-40
    on the first attempt, so the column scales shift and the walk reruns;
    both packages end on the same scale and value."""
    rng = np.random.default_rng(5)
    n = 20
    a = np.eye(n)[rng.permutation(n)] + 1e-9 * random_float_matrix(rng, n, 0.2)
    ref = sp.permanent(a, perman_algo="glynn", calc="df64", chunk_log2=5,
                       lanes=256)
    got = spt.permanent(a, perman_algo="glynn", calc="df64", chunk_log2=5,
                        lanes=256, device="cpu")
    assert got.meta["scale_log2"] == ref.meta["scale_log2"]
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-9)
    assert got.permanent == pytest.approx(perman64(a), rel=1e-9)


def test_glynn_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spt.permanent(_matrix("int", 20, 1), perman_algo="glynn")
