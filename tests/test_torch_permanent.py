"""The port's whole slice against the JAX package: permanent(), its
small-n route, what it refuses, its imports and its CLI.

Inputs come from seeded numpy generators; the port runs on the CPU
(device="cpu", the kernels' plain versions), the JAX package as its own
tests run it (Pallas in interpret mode).
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu.ops.oracle import perman64, perman_brute
from superman_tpu.ops.ryser_xla import ryser_xla
from tests.conftest import random_float_matrix, random_int_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores and slows the walks tenfold
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("kind", ["int", "real"])
def test_slice_matches_jax_n21(kind):
    """The reference's Pallas path at n=21 (as test_exact_dense.py drives
    it) and the port's chunked walk on the same plan.  Both lie within
    1e-10 of perman64 (the df64 tier's contract); they agree with each
    other to 1e-11, the JAX tier's own per-term error (~2^-44) summed."""
    rng = np.random.default_rng(21)
    a = (random_int_matrix(rng, 21, 0.5, vmax=2) if kind == "int"
         else random_float_matrix(rng, 21, 0.5))
    want = perman64(a)
    ref = sp.permanent(a, calc="df64", chunk_log2=6, lanes=256)
    got = spt.permanent(a, calc="df64", chunk_log2=6, lanes=256,
                        device="cpu")
    assert "pallas" in ref.algo_name
    assert got.algo_name == "ryser_plain_df64"
    assert got.permanent == pytest.approx(want, rel=1e-10)
    assert ref.permanent == pytest.approx(want, rel=1e-10)
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-11)
    for key in ("calc", "chunks", "r", "lanes", "scale_log2"):
        assert got.meta[key] == ref.meta[key], key
    assert got.iterations == ref.iterations == 1 << 20


def test_default_plan_on_cpu_matches_oracle():
    """No chunk_log2: the plan the card would get (2^17 chunks at most)."""
    a = random_int_matrix(np.random.default_rng(19), 19, 0.5)
    got = spt.permanent(a, device="cpu")
    assert got.meta["calc"] == "df64" and got.meta["r"] == 1
    assert got.permanent == pytest.approx(perman64(a), rel=1e-12)


def test_underflow_retry_matches_jax():
    """A permanent far below its row-scale bound (a near-permutation
    matrix with tiny off-diagonal mass) exercises the scale and retry
    logic; both packages land on the same scale_log2 and value."""
    rng = np.random.default_rng(5)
    n = 20
    a = np.eye(n)[rng.permutation(n)] + 1e-9 * random_float_matrix(rng, n, 0.2)
    ref = sp.permanent(a, calc="df64", chunk_log2=5, lanes=256)
    got = spt.permanent(a, calc="df64", chunk_log2=5, lanes=256,
                        device="cpu")
    assert got.meta["scale_log2"] == ref.meta["scale_log2"]
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)
    assert got.permanent == pytest.approx(perman64(a), rel=1e-10)


@pytest.mark.parametrize("n,density,seed", [(3, 0.8, 3), (8, 0.6, 8),
                                            (12, 0.45, 12), (16, 0.3, 16)])
def test_small_n_rounds_to_brute(n, density, seed):
    a = random_int_matrix(np.random.default_rng(seed), n, density, vmax=2)
    got = spt.permanent(a, device="cpu")
    want = perman_brute(a)
    assert want != 0
    assert round(got.permanent) == want


@pytest.mark.parametrize("n,calc", [(12, "df64"), (18, "df64"), (20, "f64")])
def test_walk_route_matches_ryser_xla(n, calc):
    """n < 19 (and calc="f64" at any n) take the float64 walk, as the
    reference takes ryser_xla: rel 1e-12 (same lanes and steps, only the
    product order inside torch.prod / jnp.prod differs)."""
    a = random_float_matrix(np.random.default_rng(n), n, 0.6)
    got = spt.permanent(a, calc=calc, device="cpu")
    assert got.algo_name == f"ryser_walk_{calc}"
    assert got.permanent == pytest.approx(ryser_xla(a), rel=1e-12)


@pytest.mark.parametrize("calc,n,rel", [("f32", 19, 1e-3), ("f32k", 20, 1e-4),
                                        ("f32", 20, 1e-3), ("f32k", 19, 1e-4)])
def test_f32_tiers_match_jax(calc, n, rel):
    """permanent(calc="f32"/"f32k") on the reference's plan (chunk_log2
    given) at n=19-20, where n_pad is 24 and the two packages fold the
    product in different orders: they agree to 1e-3 (f32) and 1e-4
    (f32k), and each lies within the tier's own account of itself (f32
    1e-2, f32k 1e-3) of the float64 oracle."""
    a = random_int_matrix(np.random.default_rng(n), n, 0.5, vmax=3)
    ref = sp.permanent(a, calc=calc, chunk_log2=6, lanes=256)
    got = spt.permanent(a, calc=calc, chunk_log2=6, lanes=256, device="cpu")
    assert ref.algo_name == f"ryser_pallas_{calc}"
    assert got.algo_name == f"ryser_plain_{calc}"
    assert got.permanent == pytest.approx(ref.permanent, rel=rel)
    assert got.permanent == pytest.approx(perman64(a), rel=10 * rel)
    for key in ("calc", "chunks", "r", "lanes", "scale_log2"):
        assert got.meta[key] == ref.meta[key], key
    assert got.meta["exact_storage"] is True


@pytest.mark.parametrize("calc,rel", [("f32", 1e-4), ("f32k", 1e-12)])
def test_f32_tiers_small_n_route_matches_jax(calc, rel):
    """n=12 takes the walk route in both packages: float32 for
    calc="f32" (rel 1e-4: the products round in another order), float64
    for f32k (rel 1e-12, as df64)."""
    a = random_float_matrix(np.random.default_rng(12), 12, 0.6)
    ref = sp.permanent(a, calc=calc)
    got = spt.permanent(a, calc=calc, device="cpu")
    assert ref.algo_name == f"ryser_xla_{calc}"
    assert got.algo_name == f"ryser_walk_{calc}"
    assert got.permanent == pytest.approx(ref.permanent, rel=rel)
    assert got.permanent == pytest.approx(ryser_xla(a), rel=max(rel, 1e-12))


def test_empty_row_is_zero():
    a = random_int_matrix(np.random.default_rng(4), 20, 0.6)
    a[3] = 0
    res = spt.permanent(a, device="cpu")
    assert res.permanent == 0.0 and res.meta["reason"] == "empty row/col"


def test_auto_sparse_gate_engages(monkeypatch):
    """Where the reference engages its pruned walk by itself (n >= 28,
    density < 0.30) so does the port, wherever its planner finds the
    pruned walk cheaper at the card's rates (at n=30 it does; at n=28 the
    dense walk takes under a millisecond and it declines): the planner
    runs, the engine hands
    the live ids and the factor pack to the reduced walk and reports the
    plan in meta["sparse"]; a dense matrix and skip_pruning=False keep the
    dense walk.  The walk is stubbed: 2^26 steps are too many for the
    plain version on the CPU, and only the engine's decision is under
    test."""
    from superman_tpu_torch.ops import pruning, ryser
    from superman_tpu_torch.parallel import sharding
    seen = []

    def half(x0, cols, plan, device, tier="df64", *, sparse=None, sms=0,
             mesh=None, host=(0, 1), cards=None):
        seen.append((sparse, x0, plan))
        return 0.5

    monkeypatch.setattr(sharding, "compute_total", half)
    n = 30
    rng = np.random.default_rng(n)
    sparse = (rng.random((n, n)) < 0.15) * rng.integers(1, 5, (n, n))
    np.fill_diagonal(sparse, rng.integers(1, 4, n))
    dense = random_int_matrix(np.random.default_rng(29), n, 0.5)
    res = spt.permanent(sparse, device="cpu")
    sp_plan = pruning.plan_sparse(sparse, giters=ryser.K1_GITERS["df64"])
    assert sp_plan is not None and len(sp_plan.factor_rows) >= 1
    assert res.meta["sparse"] == {
        "dead_frac": round(sp_plan.dead_frac, 4),
        "factored_rows": len(sp_plan.factor_rows), "r": sp_plan.r}
    assert res.algo_name == "ryser_plain_df64"
    assert "sparse_pending" not in res.meta
    (ids, fx0, fcols), x0, plan = seen[-1]
    assert np.array_equal(ids, sp_plan.ids)
    assert x0.shape == (plan.n_pad,) and plan.n_pad == 24
    assert fx0.shape == (len(sp_plan.factor_rows),)
    assert fcols.shape == (n - 1, len(sp_plan.factor_rows))
    assert res.iterations == len(sp_plan.ids) << sp_plan.r
    for a, kw in ((dense, {}), (sparse, {"skip_pruning": False})):
        res = spt.permanent(a, device="cpu", **kw)
        assert "sparse" not in res.meta and seen[-1][0] is None
        assert res.iterations == 1 << (n - 1)


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = random_int_matrix(np.random.default_rng(1), 20, 0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        spt.permanent(a)
    with pytest.raises(RuntimeError, match="CUDA"):
        spt.permanent(a, device="cuda")


@pytest.mark.parametrize("flags", [
    {"approximation": True, "hybrid": True},
    {"calc": "exact", "approximation": True, "mesh_shape": (2,)},
    {"calc": "quad", "cpu": True, "gpu": False},
    {"perman_algo": "glynn", "calc": "quad", "cpu": True, "gpu": False},
    {"calc": "tf96", "hybrid": True},
    {"perman_algo": "5"}, {"mesh_shape": (2,)}, {"hybrid": True},
    {"checkpoint_path": "journal"}, {"compression": True, "hybrid": True},
    {"scaling_threshold": 1.0, "mesh_shape": (2,)},
    {"cpu": True, "gpu": False},
    {"dm_prune": True, "cpu": True, "gpu": False},
    {"rectangular": True, "checkpoint_path": "journal"},
])
def test_unported_features_raise(flags, tmp_path):
    """The lifted features match the JAX package (the name is kept from
    when these flags raised).  What ROADMAP items 11 and 12 refused by name until they were
    ported (several devices, the hybrid scheduler and its journal, the
    native CPU engine, the estimators' hybrid and sharded batches), also
    under the drivers, the estimators and rectangular input: each set of
    flags now runs on device="cpu" and agrees with sp.permanent on the
    same flags, the exact engines within 1e-10 (the card's df64 walk
    against the JAX package's f32-pair walk) or, where both take the
    native engine, 1e-12; the estimators within 4 combined stderr."""
    a = random_int_matrix(np.random.default_rng(2), 20, 0.5)
    kw = dict(flags)
    if "checkpoint_path" in kw:
        kw["checkpoint_path"] = str(tmp_path / "port.jsonl")
    jkw = dict(kw, checkpoint_path=str(tmp_path / "jax.jsonl")) \
        if "checkpoint_path" in kw else dict(kw)
    if flags.get("approximation"):
        kw["number_of_times"] = jkw["number_of_times"] = 20000
    else:
        kw["chunk_log2"] = jkw["chunk_log2"] = 6
    with warnings.catch_warnings():
        # calc="tf96" under the scheduler falls back to df64, with a
        # warning, in both packages
        warnings.simplefilter("ignore")
        got = spt.permanent(a, device="cpu", threads=2, **kw)
        want = sp.permanent(a, threads=2, **jkw)
    if flags.get("approximation"):
        sig = np.hypot(got.meta["stderr"], want.meta["stderr"])
        assert abs(got.permanent - want.permanent) <= 4 * sig
        assert got.meta["trials"] == want.meta["trials"] == 20000
        return
    native = flags.get("cpu") and not flags.get("gpu", True)
    assert got.permanent == pytest.approx(want.permanent,
                                          rel=1e-12 if native else 1e-10)
    if native:
        assert got.algo_name == want.algo_name
        assert got.algo_name.startswith("cpu_")
    if flags.get("hybrid") or flags.get("checkpoint_path"):
        assert "hybrid" in got.algo_name and got.meta["hybrid"]["units"] >= 1
    if "mesh_shape" in flags or flags.get("perman_algo") == "5":
        assert got.meta["mesh"] == 2


@pytest.mark.parametrize("algo", ["ryser", "glynn"])
@pytest.mark.parametrize("kind,n", [("int", 8), ("int", 12), ("real", 12),
                                    ("int", 20)])
def test_quad_is_the_host_long_double_walk(algo, kind, n):
    """calc="quad" routes to the native engine (the name is kept from
    when quad was the host long-double walk, which now runs only on
    long-double storage: see the test after next).  calc="quad" runs the native engine's parallel __float128 walk, as
    the JAX package routes it (whatever perman_algo, the algorithm name is
    the native route's "cpu_ryser_quad"): the exact integer at n <= 12
    (perman_brute), and within 1e-15 of sp.permanent(calc="quad")."""
    rng = np.random.default_rng(100 + n)
    a = (rng.integers(0, 5, (n, n)) if kind == "int"
         else rng.uniform(-1, 1, (n, n)))
    kw = {"perman_algo": "glynn"} if algo == "glynn" else {}
    got = spt.permanent(a, calc="quad", device="cpu", threads=2, **kw)
    ref = sp.permanent(a, calc="quad", threads=2, **kw)
    assert got.algo_name == ref.algo_name == "cpu_ryser_quad"
    assert got.iterations == 1 << (n - 1)
    if kind == "int" and n <= 12:
        assert got.permanent == float(perman_brute(a))
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-15)


def test_quad_under_sparse_flags_names_sparyser():
    """sparse=True hands the native quad walk the preprocessed matrix and
    names the result as the JAX package does: the SkipPer walk under
    preprocessing=2."""
    a = random_int_matrix(np.random.default_rng(11), 11, 0.4)
    np.fill_diagonal(a, 1)
    got = spt.permanent(a, calc="quad", sparse=True, preprocessing=2,
                        device="cpu", threads=2)
    ref = sp.permanent(a, calc="quad", sparse=True, preprocessing=2,
                       threads=2)
    assert got.algo_name == ref.algo_name == "cpu_skipper_quad"
    assert got.permanent == float(perman_brute(a))
    got = spt.permanent(a, calc="quad", sparse=True, device="cpu",
                        threads=2)
    assert got.algo_name == "cpu_sparyser_quad"
    assert got.permanent == float(perman_brute(a))


def test_quad_on_long_double_storage_walks_on_the_host():
    """Long-double storage that is not exact in float64 stays off the
    native engine (its ABI takes float64): the host long-double walk
    keeps the storage bits, as in the JAX package."""
    rng = np.random.default_rng(12)
    a = rng.uniform(-1, 1, (12, 12)).astype(np.longdouble) / 3
    assert not np.all(a.astype(np.float64).astype(np.longdouble) == a)
    got = spt.permanent(a, calc="quad", device="cpu")
    assert got.algo_name == "ryser_quad_host"
    assert got.permanent == float(perman64(a, dtype=np.longdouble))


@pytest.mark.parametrize("flags,algo", [
    ({"sparse": True}, "sparyser_plain_df64"),
    ({"calc": "auto"}, "ryser_plain_df64"),
    ({"perman_algo": "14"}, "sparyser_plain_df64"),
    ({"perman_algo": "glynn", "calc": "auto"}, "ryser_plain_df64"),
    ({"perman_algo": "glynn", "sparse": True}, "glynn_plain_df64"),
])
def test_sparse_and_auto_flags_run(flags, algo):
    """The flags of the sparse engine and of the ladder reach their
    engines (they raised NotImplementedError before these were ported)."""
    a = random_int_matrix(np.random.default_rng(2), 20, 0.5)
    res = spt.permanent(a, device="cpu", chunk_log2=6, **flags)
    assert res.algo_name == algo
    assert res.permanent == pytest.approx(perman64(a), rel=1e-10)
    assert ("auto" in res.meta) == (flags.get("calc") == "auto")


def test_bad_input_raises():
    with pytest.raises(ValueError, match="square"):
        spt.permanent(np.ones((3, 4)), device="cpu")
    with pytest.raises(TypeError, match="unknown flags"):
        spt.permanent(np.ones((3, 3)), device="cpu", no_such_flag=1)


def test_import_pulls_in_no_jax():
    """Every module of the port imports without jax or superman_tpu."""
    code = ("import importlib, pkgutil, sys, superman_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'superman_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_prints_reference_value(tmp_path):
    """python -m superman_tpu_torch -f <triplet> -p4 --device cpu prints
    the reference's Result line with the JAX package's value."""
    a = random_int_matrix(np.random.default_rng(11), 11, 0.5)
    path = tmp_path / "m11.txt"
    from superman_tpu.io.triplet import write_triplet
    from superman_tpu.core.matrix import DenseMatrix
    write_triplet(str(path), DenseMatrix(a, "int"))
    want = sp.permanent(str(path), perman_algo="4").permanent
    proc = subprocess.run(
        [sys.executable, "-m", "superman_tpu_torch", "-f", str(path), "-p4",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("Result || ryser_walk_df64 | ")
    got = float(line.split("|")[-1].split(" in ")[0])
    assert got == want == perman_brute(a)


@pytest.mark.parametrize("fmt", ["triplet", "mtx"])
def test_readers_match_jax(tmp_path, fmt):
    """The copied readers give the JAX package's matrix and storage class."""
    from superman_tpu.io.matrixmarket import read_any as jread_any
    path = tmp_path / f"m.{fmt}"
    if fmt == "triplet":
        path.write_text("3 4 int\n0 0 2\n1 2 5\n2 1 -1\n2 2 3\n")
    else:
        path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                        "% comment\n3 3 3\n1 1 1.5\n3 1 -2.25\n2 2 4\n")
    got, want = spt.read_any(str(path)), jread_any(str(path))
    assert got.type == want.type
    assert got.mat.dtype == want.mat.dtype
    assert np.array_equal(got.mat, want.mat)


@pytest.mark.parametrize("n", [5, 9])
def test_oracle_copy_matches_jax(n):
    """perman64, perman_brute and gray_init_lanes are copied numpy code:
    the copies give the reference's bits."""
    from superman_tpu.ops import oracle as joracle
    from superman_tpu_torch.ops import oracle
    a = random_float_matrix(np.random.default_rng(n), n, 0.7)
    assert oracle.perman64(a) == joracle.perman64(a)
    assert oracle.perman_brute(a) == joracle.perman_brute(a)
    ids = np.arange(1 << (n - 3))
    for got, want in zip(oracle.gray_init_lanes(a, ids, 2),
                         joracle.gray_init_lanes(a, ids, 2)):
        assert np.array_equal(got, want)
