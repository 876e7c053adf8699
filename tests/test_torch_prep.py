"""The port's pure-numpy transforms against the JAX package's: Sinkhorn
scaling, the d1/d2/d34 compressions, Dulmage-Mendelsohn pruning and the
grid graphs.  Each is a copy, so the same seeded matrix must give the
same arrays bit for bit (np.array_equal)."""

import warnings

import numpy as np
import pytest

from superman_tpu.core.matrix import DenseMatrix as JDense
from superman_tpu.prep import compression as JC
from superman_tpu.prep import dulmage_mendelsohn as JDM
from superman_tpu.prep import gridgraph as JG
from superman_tpu.prep import scaling as JS
from superman_tpu_torch.core.matrix import DenseMatrix
from superman_tpu_torch.prep import compression as C
from superman_tpu_torch.prep import dulmage_mendelsohn as DM
from superman_tpu_torch.prep import gridgraph as G
from superman_tpu_torch.prep import scaling as S
from tests.conftest import random_float_matrix, random_int_matrix


def _scaling_inputs(seed):
    """A nonnegative integer matrix, a real one with magnitudes spread
    over 2^-8..2^8, and a signed one (Sinkhorn may oscillate there and
    keep its best iterate)."""
    rng = np.random.default_rng(seed)
    a = random_int_matrix(rng, 9, 0.6).astype(np.float64)
    np.fill_diagonal(a, 1)
    b = np.exp2(rng.integers(-8, 8, (10, 10)).astype(np.float64))
    c = rng.uniform(-1, 1, (8, 8))
    return [a, b, c]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("threshold", [1.0, 3.5])
def test_scalesk_bitwise(seed, which, threshold):
    a = _scaling_inputs(seed)[which]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JS.scalesk(a, threshold)
        got = S.scalesk(a, threshold)
    assert np.array_equal(got.r_v, want.r_v)
    assert np.array_equal(got.c_v, want.c_v)
    assert got.log2_product() == want.log2_product()
    assert got.sign_product() == want.sign_product()
    scaled = S.scale_matrix(DenseMatrix(a, "double"), got)
    assert scaled.type == "double"
    assert np.array_equal(scaled.mat,
                          JS.scale_matrix(JDense(a, "double"), want).mat)
    for p in (1.0, -3.25e12, 7.5e-200):
        assert S.unscale_permanent(p, got) == JS.unscale_permanent(p, want)


def _low_degree(seed, n=12):
    rng = np.random.default_rng(seed)
    a = random_int_matrix(rng, n, 0.25, vmax=3)
    a[0] = 0
    a[0, 3] = 2                                # a degree-1 row
    a[:, 0] = 0
    a[2, 0], a[5, 0] = 1, 3                    # a degree-2 column
    return a


@pytest.mark.parametrize("seed", range(4))
def test_d1_d2_compress_bitwise(seed):
    a = _low_degree(seed)
    for f, jf in ((C.d1compress, JC.d1compress),
                  (C.d2compress, JC.d2compress)):
        got, want = f(a), jf(a)
        assert (got is None) == (want is None)
        if want is not None:
            assert np.array_equal(got, want) and got.dtype == want.dtype
    # a real-valued matrix folds through the same merges
    b = _low_degree(seed).astype(np.float64) * np.random.default_rng(
        seed).random((12, 12))
    one = C.d1compress(b)
    assert np.array_equal(one, JC.d1compress(b))
    assert np.array_equal(C.d2compress(one), JC.d2compress(one))
    assert C.min_degree(a) == JC.min_degree(a)
    assert C.has_empty_line(a) == JC.has_empty_line(a)
    assert np.array_equal(C.row_degrees(a), JC.row_degrees(a))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("deg", [3, 4])
def test_d34_compress_bitwise(seed, deg):
    rng = np.random.default_rng(100 + seed)
    a = random_int_matrix(rng, 10, 0.45, vmax=2)
    a[seed % 10] = 0
    a[seed % 10, :deg] = 1 + np.arange(deg)    # a degree-deg row
    got, want = C.d34compress(a, deg), JC.d34compress(a, deg)
    assert (got is None) == (want is None)
    if want is not None:
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # and on the transposed matrix: the column case
    got, want = C.d34compress(a.T.copy(), deg), JC.d34compress(a.T.copy(),
                                                               deg)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_d34_on_a_dense_three_by_three():
    a = np.arange(1, 10).reshape(3, 3)
    assert C.d34compress(a, 3) is None and JC.d34compress(a, 3) is None


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("density", [0.2, 0.35])
def test_dm_prune_bitwise(seed, density):
    rng = np.random.default_rng(seed)
    a = (rng.random((14, 14)) < density).astype(np.int64)
    np.fill_diagonal(a, 1)
    assert np.array_equal(DM.max_bipartite_matching(a),
                          JDM.max_bipartite_matching(a))
    got, want = DM.dm_prune(a), JDM.dm_prune(a)
    assert np.array_equal(got, want)
    adj = [list(np.nonzero(a[i])[0]) for i in range(14)]
    assert np.array_equal(DM._tarjan_scc(14, adj), JDM._tarjan_scc(14, adj))


def test_dm_prune_structural_zero():
    a = np.zeros((6, 6), dtype=np.int64)
    a[:, 0] = 1
    a[0, :] = 1
    assert DM.dm_prune(a) is None and JDM.dm_prune(a) is None
    b = random_float_matrix(np.random.default_rng(4), 12, 0.3)
    np.fill_diagonal(b, 1.0)
    assert np.array_equal(DM.dm_prune(b), JDM.dm_prune(b))


@pytest.mark.parametrize("m,n", [(2, 2), (2, 3), (4, 4), (3, 6), (6, 6),
                                 (8, 8), (5, 12), (36, 36)])
def test_grid_graph_bitwise(m, n):
    got, want = G.grid_graph_matrix(m, n), JG.grid_graph_matrix(m, n)
    assert np.array_equal(got.mat, want.mat) and got.type == want.type
    assert G.kasteleyn_log2(m, n) == JG.kasteleyn_log2(m, n)


def test_grid_graph_odd_by_odd():
    with pytest.raises(ValueError, match="even"):
        G.grid_graph_matrix(3, 5)
    assert G.kasteleyn_log2(3, 3) == float("-inf")
    assert G.KNOWN_COUNTS == JG.KNOWN_COUNTS
    for (m, n), count in G.KNOWN_COUNTS.items():
        assert 2.0 ** G.kasteleyn_log2(m, n) == pytest.approx(count,
                                                              rel=1e-12)
