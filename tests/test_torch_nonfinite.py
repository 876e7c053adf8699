"""A NaN, +Inf or -Inf entry is refused up front, with one ValueError that
names the entry, by every entry point of the port.

This differs from the reference on purpose.  The reference's row scales
take log2 of a NaN row bound and cast it to INT64_MIN
(superman_tpu/ops/ryser.py:60, also ops/glynn.py:53 and ops/batch.py:109):
an all-ones matrix with one NaN gives `nan` at n=18 and, from n=19, an
`OverflowError: Python integer ... out of bounds for int32`;
permanent_batch raises that error already at n=14; an Inf entry gives
`nan`.  The port checks the matrix once it is built
(api._as_dense, core.matrix.require_finite) and permanent_batch checks
every matrix before any walk.
"""

import re

import numpy as np
import pytest

import superman_tpu_torch as spt
from superman_tpu.ops.ryser import _row_scales as jax_row_scales
from superman_tpu_torch import api, cli
from superman_tpu_torch.bindings.native import read_calculate_return
from superman_tpu_torch.core.matrix import DenseMatrix, matrix2compressed
from superman_tpu_torch.ops import batch

KINDS = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}
CALCS = ("df64", "f32", "f32k", "tf96", "f64", "exact", "quad", "auto")
ALGOS = {
    "glynn": dict(perman_algo="glynn"),
    "sparse": dict(sparse=True),
    "skipper": dict(perman_algo="14"),
    "compression": dict(compression=True),
    "scaling": dict(scaling_threshold=1.0),
    "dm_prune": dict(dm_prune=True),
    "approximation": dict(approximation=True),
    "gurvits": dict(approximation=True, perman_algo="gurvits"),
    "rectangular": dict(rectangular=True),
    "binary_graph": dict(binary_graph=True),
    "cpu_engine": dict(cpu=True),
    "hybrid": dict(hybrid=True, cpu=True),
}
FLAGS = {**{f"calc={c}": dict(calc=c) for c in CALCS}, **ALGOS}


def _bad(n, kind, rows=None):
    """An all-ones matrix (rows x n) with entry (rows // 2, 3) set to the
    kind's value."""
    a = np.ones((rows or n, n))
    a[(rows or n) // 2, 3] = KINDS[kind]
    return a


def _message(i, j, kind):
    return rf"entry \({i}, {j}\) is {re.escape(str(KINDS[kind]))}; NaN and " \
           r"infinite entries are rejected"


@pytest.mark.parametrize("n", [14, 18, 19])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_nonfinite_entry_is_one_value_error(flags, kind, n):
    """Every calc and algo at n=14, 18 and 19 (where the reference gives
    nan, nan and OverflowError): one ValueError naming the entry."""
    rows = n - 3 if flags == "rectangular" else n
    with pytest.raises(ValueError, match=_message(rows // 2, 3, kind)):
        spt.permanent(_bad(n, kind, rows), device="cpu", **FLAGS[flags])


def test_reference_row_scales_turn_nan_into_int64_min():
    """The defect the port does not copy, at its source."""
    s = jax_row_scales(_bad(19, "nan"))
    assert s[9] == np.iinfo(np.int64).min
    assert (s[np.arange(19) != 9] < 10).all()


@pytest.mark.parametrize("wrap", ["DenseMatrix", "SparseMatrix", "list"])
def test_every_input_form_is_checked(wrap):
    a = _bad(14, "nan")
    m = {"DenseMatrix": lambda: DenseMatrix(a, "double"),
         "SparseMatrix": lambda: matrix2compressed(DenseMatrix(a, "double")),
         "list": lambda: a.tolist()}[wrap]()
    with pytest.raises(ValueError, match=_message(7, 3, "nan")):
        spt.permanent(m, device="cpu")


def test_float32_and_long_double_storage_are_checked():
    for dtype in (np.float32, np.longdouble):
        with pytest.raises(ValueError, match=_message(7, 3, "-inf")):
            spt.permanent(_bad(14, "-inf").astype(dtype), device="cpu")


@pytest.mark.parametrize("fmt", ["triplet", "mtx"])
def test_file_with_a_nan_value(tmp_path, fmt):
    """A triplet or MatrixMarket file whose value reads as `nan`: refused
    by permanent(), the CLI and, for the triplet, the C binding's
    read_calculate_return (before the native engine is built or read)."""
    n = 14
    path = tmp_path / f"m.{fmt}"
    vals = [(i, j, "nan" if (i, j) == (5, 9) else "1")
            for i in range(n) for j in range(n)]
    if fmt == "triplet":
        lines = [f"{n} {len(vals)} double"]
        lines += [f"{i} {j} {v}" for i, j, v in vals]
    else:
        lines = ["%%MatrixMarket matrix coordinate real general",
                 f"{n} {n} {len(vals)}"]
        lines += [f"{i + 1} {j + 1} {v}" for i, j, v in vals]
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match=_message(5, 9, "nan")):
        spt.permanent(str(path), device="cpu")
    with pytest.raises(ValueError, match=_message(5, 9, "nan")):
        cli.main(["-f", str(path), "--device", "cpu"])
    if fmt == "triplet":
        with pytest.raises(ValueError, match=_message(5, 9, "nan")):
            read_calculate_return(str(path), 5, 2)


@pytest.mark.parametrize("calc", ["df64", "tf96", "quad"])
def test_batch_fails_before_any_walk(calc, monkeypatch):
    """One bad matrix among good ones (batched orders 14 and 10, and one by
    one under calc="quad"): the whole call fails with a ValueError naming
    the matrix's index and the entry, and nothing was walked."""
    def walked(*args, **kwargs):
        raise AssertionError("a walk ran")

    monkeypatch.setattr(batch, "permanent_batch_kernel", walked)
    monkeypatch.setattr(batch, "permanent_batch_same_n", walked)
    monkeypatch.setattr(api, "permanent", walked)
    good = np.ones((14, 14))
    mats = [good, np.ones((10, 10)), good, _bad(14, "+inf")]
    with pytest.raises(ValueError,
                       match=r"^matrix 3: " + _message(7, 3, "+inf")):
        spt.permanent_batch(mats, device="cpu", calc=calc)


def test_batch_still_refuses_a_non_square_matrix_first():
    with pytest.raises(ValueError, match="matrix 1 is not square"):
        spt.permanent_batch([np.ones((3, 3)), np.ones((3, 4)),
                             _bad(14, "nan")], device="cpu")
