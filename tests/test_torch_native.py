"""The port's native CPU engine against the JAX package's copy.

Both packages build the same C++ source (superman_tpu_torch/native/
perman_cpu.cpp is a copy of superman_tpu/native/perman_cpu.cpp) into
libraries of their own; ctypes loads each with RTLD_LOCAL, so one process
holds both apart.  Seeded numpy matrices go through both, with the thread
count given (2): float walks agree within 1e-12, Z_p residues and exact
integers exactly.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu.bindings.native as jnative
import superman_tpu_torch as spt
from superman_tpu.ops import exact as jexact
from superman_tpu.ops.oracle import perman_brute
from superman_tpu_torch.bindings import native
from superman_tpu_torch.ops import exact, modp
from tests.conftest import random_int_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
THREADS = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _sparse(n, seed, d=0.3):
    rng = np.random.default_rng(seed)
    a = random_int_matrix(rng, n, d, vmax=3)
    np.fill_diagonal(a, rng.integers(1, 4, n))
    return np.ascontiguousarray(a.astype(np.float64))


@pytest.mark.parametrize("quad", [0, 1])
@pytest.mark.parametrize("entry", ["sup_perman_dense", "sup_perman_sparse",
                                   "sup_perman_skipper"])
def test_exact_walks_match_the_reference_engine(entry, quad):
    """Dense, sparse and skipper walks, double and __float128, at n=18 and
    n=20: the port's library and the JAX package's within 1e-12, and the
    exact integer at n=12."""
    lib, jlib = native.load(), jnative.load()
    for n, seed in ((12, 1), (18, 2), (20, 3)):
        a = _sparse(n, seed)
        got = getattr(lib, entry)(a, n, THREADS, quad)
        want = getattr(jlib, entry)(a, n, THREADS, quad)
        assert got == pytest.approx(want, rel=1e-12, abs=0)
        if n == 12:
            assert got == float(perman_brute(a.astype(np.int64)))


def _residue_matrix(n, seed, p):
    core = random_int_matrix(np.random.default_rng(seed), n, 0.6, vmax=9)
    return np.ascontiguousarray(core % p, dtype=np.uint64)


@pytest.mark.parametrize("walk", ["mod", "mod_batch", "mod_pruned",
                                  "glynn_mod"])
def test_mod_walks_equal_the_reference_engine(walk):
    """The Z_p walks give the JAX package's residues exactly, at a 61-bit
    and a 31-bit prime, and agree with the card's Z_p walk (its plain
    version) at the 31-bit one."""
    n = 14
    for p in (exact.primes_desc(1)[0], modp.PRIME_CEIL):
        am = _residue_matrix(n, 7, p)
        if walk == "mod":
            got = native.load().sup_perman_mod(am, n, p)
            want = jnative.load().sup_perman_mod(am, n, p)
        elif walk == "mod_batch":
            mats = np.stack([am, _residue_matrix(n, 8, p)])
            ps = np.asarray([p, p], np.uint64)
            got = native.perman_mod_batch(mats, ps, THREADS).tolist()
            want = jnative.perman_mod_batch(mats, ps, THREADS).tolist()
        elif walk == "mod_pruned":
            ids = np.arange(0, 1 << (n - 1 - 5), 3, dtype=np.int64)
            got = native.perman_mod_pruned(am, p, ids, 5, THREADS)
            want = jnative.perman_mod_pruned(am, p, ids, 5, THREADS)
        else:
            got = native.perman_glynn_mod(am, p, threads=THREADS)
            want = jnative.perman_glynn_mod(am, p, threads=THREADS)
        assert got == want
        if walk == "mod" and p == modp.PRIME_CEIL:
            core = [[int(v) for v in row] for row in am]
            assert got == modp.perman_core_mod(core, p, CPU)


def test_cpu_ifma_matches_the_reference_engine():
    assert native.cpu_ifma() == jnative.cpu_ifma()


@pytest.mark.parametrize("algo", [4, 5, 6, 7, 8])
def test_read_calculate_return_on_a_triplet_file(tmp_path, algo):
    """The libConnect facade reads a written triplet file and returns the
    JAX package's value and the exact integer, by algorithm id; the
    superpython front end prints it."""
    from superman_tpu_torch.bindings import superpython
    from superman_tpu_torch.core.matrix import DenseMatrix
    from superman_tpu_torch.io.triplet import write_triplet
    a = random_int_matrix(np.random.default_rng(algo), 10, 0.5, vmax=2)
    np.fill_diagonal(a, 1)
    path = str(tmp_path / "m.txt")
    write_triplet(path, DenseMatrix(a, "int"))
    got = native.read_calculate_return(path, algo, nt=THREADS)
    assert got == jnative.read_calculate_return(path, algo, nt=THREADS)
    assert got == pytest.approx(float(perman_brute(a)), rel=1e-12)
    proc = subprocess.run(
        [sys.executable, "-m", "superman_tpu_torch.bindings.superpython",
         "-f", path, "-a", str(algo), "-t", str(THREADS)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"Permanent: {got:.16e}"
    assert superpython.main(["-f", path, "-a", str(algo), "-t", "1"]) == 0


@pytest.mark.parametrize("flags,name", [
    ({"cpu": True, "gpu": False}, "cpu_ryser"),
    ({"cpu": True, "gpu": False, "sparse": True}, "cpu_sparyser"),
    ({"cpu": True, "gpu": False, "sparse": True, "preprocessing": 2},
     "cpu_skipper"),
    ({"calc": "quad"}, "cpu_ryser_quad"),
    ({"calc": "quad", "sparse": True}, "cpu_sparyser_quad"),
    ({"calc": "quad", "sparse": True, "preprocessing": 2},
     "cpu_skipper_quad"),
    ({"calc": "quad", "perman_algo": "glynn"}, "cpu_ryser_quad"),
])
def test_cpu_and_quad_route_to_the_native_engine(flags, name):
    """cpu=True and calc="quad" go to the native engine, as in the JAX
    package: the same algorithm names and values within 1e-12."""
    a = _sparse(16, 11, 0.35)
    got = spt.permanent(a, device="cpu", threads=THREADS, **flags)
    want = sp.permanent(a, threads=THREADS, **flags)
    assert got.algo_name == want.algo_name == name
    assert got.permanent == pytest.approx(want.permanent, rel=1e-12)
    assert got.meta["engine"] == "native"


def _native_estimate(binding, flags_cls, matrix_cls, a, **kw):
    flags = flags_cls(approximation=True, number_of_times=20000,
                      threads=THREADS, seed=3, **kw)
    return binding.perman_native(matrix_cls(a, "int"), flags)


@pytest.mark.parametrize("algo,name", [("rasmussen", "cpu_rasmussen"),
                                       ("scaling", "cpu_approx_scaling")])
def test_native_estimators_match_the_reference_engine(algo, name):
    """perman_native's estimators: the same seeded engine gives the JAX
    package's estimate bit for bit (scale_intervals given)."""
    from superman_tpu.core.flags import Flags as JFlags
    from superman_tpu.core.matrix import DenseMatrix as JDense
    from superman_tpu_torch.core.matrix import DenseMatrix
    a = _sparse(16, 11, 0.35)
    if algo == "rasmussen":
        a = (a != 0).astype(np.float64)
    got = _native_estimate(native, spt.Flags, DenseMatrix, a,
                           perman_algo=algo, scale_intervals=4)
    want = _native_estimate(jnative, JFlags, JDense, a, perman_algo=algo,
                            scale_intervals=4)
    assert got.algo_name == want.algo_name == name
    assert got.permanent == want.permanent and got.zeros == want.zeros


def test_scale_intervals_auto_is_resolved_before_the_native_estimator():
    """The JAX binding's defect (superman_tpu/bindings/native.py:173):
    scale_intervals=-1 reaches sup_approx_scaling unresolved, and the
    native estimator then rescales at every step, so its value is not the
    one of the resolved default 4.  The port resolves -1 first: its value
    IS the resolved one, bit for bit the JAX package's at 4."""
    from superman_tpu.core.flags import Flags as JFlags
    from superman_tpu.core.matrix import DenseMatrix as JDense
    from superman_tpu_torch.core.matrix import DenseMatrix
    a = _sparse(16, 12, 0.4)
    port_auto, port_4 = (_native_estimate(
        native, spt.Flags, DenseMatrix, a, perman_algo="scaling",
        scale_intervals=si) for si in (-1, 4))
    ref_auto, ref_4 = (_native_estimate(
        jnative, JFlags, JDense, a, perman_algo="scaling",
        scale_intervals=si) for si in (-1, 4))
    assert port_auto.permanent == port_4.permanent == ref_4.permanent
    assert ref_auto.permanent != ref_4.permanent       # the defect


@pytest.mark.parametrize("n,d", [(12, 0.5), (17, 0.6)])
def test_engine_native_gives_the_exact_integer(n, d):
    """perman_exact_fraction(engine="native") returns the JAX package's
    exact Fraction (its native engine) and names the engine; cpu=True
    under calc="exact" takes it too; the checkpointed CRT pipeline
    (crt_perman_core backend="native") gives the device walk's integer."""
    a = random_int_matrix(np.random.default_rng(n), n, d, vmax=3)
    want, jmeta = jexact.perman_exact_fraction(a, engine="native",
                                               threads=THREADS)
    got, meta = exact.perman_exact_fraction(a, CPU, engine="native",
                                            threads=THREADS)
    assert got == want
    assert meta["engine"] == jmeta["engine"] == "native_mod"
    res = spt.permanent(a, calc="exact", cpu=True, gpu=False,
                        threads=THREADS, device="cpu")
    assert res.meta["exact_fraction"] == want
    assert res.meta["exact"]["engine"] == "native_mod"
    core = [[int(v) for v in row] for row in a]
    per, cmeta = modp.crt_perman_core(core, CPU, backend="native",
                                      threads=THREADS)
    assert per == want and cmeta["engine"] == "native_mod_crt"


def test_native_cost_estimate_is_the_reference_native_branch():
    """exact_cost_estimate(engine="native") prices the native engine as
    the JAX package's native branch does."""
    a = random_int_matrix(np.random.default_rng(19), 19, 0.5, vmax=3)
    secs, npr, core_n = exact.exact_cost_estimate(a, CPU, engine="native")
    jsecs, jnpr, jcore_n = jexact.exact_cost_estimate(a)
    assert (secs, npr, core_n) == (jsecs, jnpr, jcore_n)


def test_cpu_true_certifies_compression_with_the_native_engine(
        monkeypatch):
    """Under cpu=True (without gpu) the compression pipeline's exact
    certification is priced and run on the native engine, as
    perman_exact runs calc="exact" there; without it, on the device's Z_p
    walk.  The value agrees with the JAX package's on the same flags."""
    rng = np.random.default_rng(3)
    a = (rng.random((14, 14)) < 0.3) * rng.integers(1, 4, (14, 14))
    np.fill_diagonal(a, 1)
    seen = []
    real_cost, real_frac = (exact.exact_cost_estimate,
                            exact.perman_exact_fraction)

    def cost(*args, **kw):
        seen.append(("cost", kw.get("engine")))
        return real_cost(*args, **kw)

    def frac(*args, **kw):
        seen.append(("frac", kw.get("engine")))
        return real_frac(*args, **kw)

    from superman_tpu_torch.drivers import runner
    monkeypatch.setattr(exact, "exact_cost_estimate", cost)
    monkeypatch.setattr(exact, "perman_exact_fraction", frac)
    monkeypatch.setattr(runner, "_CERT_CACHE", {})     # walk, not recall
    want = float(perman_brute(a))
    for kw, engine in (({"cpu": True, "gpu": False}, "native"), ({}, None)):
        seen.clear()
        got = spt.permanent(a, compression=True, device="cpu",
                            threads=THREADS, **kw)
        assert seen == [("cost", engine), ("frac", engine)], kw
        assert got.meta["exact_certified_rel"] <= 1e-12
        assert got.permanent == pytest.approx(want, rel=1e-12)
    ref = sp.permanent(a, compression=True, cpu=True, gpu=False,
                       threads=THREADS)
    assert ref.permanent == pytest.approx(want, rel=1e-12)


def test_new_modules_import_no_jax_and_build_from_the_port():
    """The modules of this slice import neither jax nor superman_tpu, and
    the native build compiles the port's own source into build/."""
    code = (
        "import importlib, sys\n"
        "for m in ('bindings.native', 'bindings.superpython', "
        "'native.build', 'parallel.mesh', 'parallel.sharding', "
        "'parallel.scheduler', 'parallel.multihost', 'ops.approx', "
        "'ops.exact', 'ops.modp', 'ops.ryser', 'ops.glynn', "
        "'drivers.runner', 'cli'):\n"
        "    importlib.import_module('superman_tpu_torch.' + m)\n"
        "from superman_tpu_torch.bindings import native\n"
        "lib = native.load()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'superman_tpu')]\n"
        "print(lib._name)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = proc.stdout.strip().splitlines()[-1]
    assert lib.startswith(os.path.join(REPO, "build", "superman_tpu_torch",
                                       "native"))
    from superman_tpu_torch.native import build
    assert str(build.SRC).startswith(os.path.join(REPO,
                                                  "superman_tpu_torch"))


def test_rasmussen_engine_matches_the_reference_engine():
    """sup_rasmussen of both libraries on one seed: the same estimate."""
    a = (_sparse(14, 13, 0.5) != 0).astype(np.float64)
    z1, z2 = ctypes.c_double(), ctypes.c_double()
    got = native.load().sup_rasmussen(a, 14, 30000, THREADS, 42,
                                      ctypes.byref(z1))
    want = jnative.load().sup_rasmussen(a, 14, 30000, THREADS, 42,
                                        ctypes.byref(z2))
    assert got == want and z1.value == z2.value
