"""The port's Z_p walk and CRT driver against the JAX package's.

Inputs come from seeded numpy generators and go through both packages:
the JAX side runs its Pallas Z_p kernel in interpret mode on the CPU (as
tests/test_modp.py runs it), the port runs its kernel's plain PyTorch
version (a CPU tensor).  Every comparison is between exact integers or
residues, so there is no tolerance.  The CUDA kernel itself is tested on
a card by tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superman_tpu.ops import exact as jexact
from superman_tpu.ops import modp as jmodp
from superman_tpu.ops import pruning as jpruning
from superman_tpu.parallel.sharding import pad_ids
from superman_tpu.prep import orderings as jorderings
from superman_tpu_torch.ops import exact, gray, modp, modp_cuda, pruning
from superman_tpu_torch.prep import orderings

CPU = torch.device("cpu")
P31 = (1 << 31) - 1
P31_NEXT = 2147483629          # the largest prime below 2^31 - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores and slows the walks tenfold
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _int_core(rng, n, density=1.0, hi=50):
    m = rng.integers(1, hi, size=(n, n))
    if density < 1.0:
        m = m * (rng.random((n, n)) < density)
    return [[int(v) for v in row] for row in m]


def _float_image(rng, n, density):
    return (rng.integers(1, 9, (n, n)) * (rng.random((n, n)) < density)
            ).astype(np.float64)


# ------------------------------------------------------------ host helpers

def test_prime_helpers_match_jax():
    for c in list(range(0, 400)) + list(range(P31 - 200, P31 + 3)):
        assert exact._is_prime_u64(c) == jexact._is_prime_u64(c), c
    assert exact.primes_desc(4) == jexact.primes_desc(4)
    assert exact.primes_desc(6, 2039) == jexact.primes_desc(6, 2039)
    assert exact.primes_desc(2, modp.PRIME_CEIL) == [P31, P31_NEXT]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprint_and_live_exact_match_jax(seed):
    rng = np.random.default_rng(seed)
    core = _int_core(rng, 14, density=0.3, hi=9)
    assert modp.core_fingerprint(core) == jmodp.core_fingerprint(core)
    a2 = modp._doubled_object(core)
    assert np.array_equal(a2, jmodp._doubled_object(core))
    assert np.array_equal(modp._score_float(core), jmodp._score_float(core))
    for r in (1, 4, 6, 9):
        got, want = modp._live_exact(a2, r), jmodp._live_exact(a2, r)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got, want)


@pytest.fixture
def jax_costs(monkeypatch):
    """Price chunks and mask entries as superman_tpu.ops.pruning.
    plan_sparse does (its own constants; the port's are the card's)."""
    monkeypatch.setattr(pruning, "C_CHUNK_S", 80e-9)
    monkeypatch.setattr(pruning, "C_MASK_S", 5e-8)


@pytest.mark.parametrize("n,r", [(20, 7), (26, 10), (30, 14)])
def test_prune_order_and_dead_masks_match_jax(n, r):
    a = _float_image(np.random.default_rng(n), n, 0.25)
    got, want = orderings.prune_order(a, r), jorderings.prune_order(a, r)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
        ap = a[:, g]
        assert np.array_equal(pruning.const_rows(ap, r),
                              jpruning.const_rows(ap, r))
        lg, lw = pruning._live_for(ap, r), jpruning._live_for(ap, r)
        assert (lg is None) == (lw is None)
        if lg is not None:
            assert np.array_equal(lg, lw)


@pytest.mark.parametrize("n,giters,chunk_log2", [
    (24, 0.01, None), (28, 10.0, None), (30, 10.0, None), (22, 1.0, 8)])
def test_plan_sparse_matches_jax(n, giters, chunk_log2, jax_costs):
    """The same rate and the same per-chunk and per-mask-entry costs (the
    reference's own; the port's defaults are the card's) give the same
    plan in both packages."""
    a = _float_image(np.random.default_rng(100 + n), n, 0.25)
    got = pruning.plan_sparse(a, giters=giters, chunk_log2=chunk_log2)
    want = jpruning.plan_sparse(a, giters=giters, chunk_log2=chunk_log2)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.r == want.r
        for f in ("col_perm", "ids", "alive_rows", "factor_rows"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.dead_frac == want.dead_frac
        assert got.est_live == want.est_live


@pytest.mark.parametrize("seed", [0, 1])
def test_core_plan_matches_jax(seed, jax_costs):
    """At the JAX package's rate (10 G steps/s) and costs the port's
    planner makes the JAX package's plan: order, r, live ids, live fraction."""
    core = _int_core(np.random.default_rng(seed), 30, density=0.25, hi=9)
    want = jmodp.core_plan(core)
    got = modp.core_plan(core, giters=jmodp.MOD_GITERS / 1e9)
    assert want is not None and got is not None
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2:] == want[2:]


# ------------------------------------------------- per-chunk residues (K3)

def _jax_lane_residues(am, p, n, r, ids, L=64):
    """Per-chunk residues of the JAX Z_p kernel (interpret mode), with
    allow_multi=False: row 0 of each lane, reduced mod p."""
    n_pad = gray.pad_n(n)
    x0v, cols, colst = jmodp.pack_mod(am, p, n_pad)
    blocks = pad_ids(ids.astype(np.int32), L, 1, block_multiple=1)
    idsj = jnp.asarray(blocks, jnp.int32)
    x, aux = jmodp.chunk_init_mod(idsj, jnp.asarray(x0v), jnp.asarray(cols),
                                  jnp.float32(p), jmodp._invp_down(p),
                                  n=n, n_pad=n_pad, r=jnp.int32(r))
    alive = (idsj >= 0).astype(jnp.float32)
    out = jmodp._mod_partials_jit(jnp.asarray([r], jnp.int32), x, aux,
                                  jnp.asarray(colst), alive, use_u16=False,
                                  u=4, interpret=True, allow_multi=False)
    lanes = np.asarray(out[:, 0, :], dtype=np.float64).reshape(-1)
    return np.round(lanes).astype(np.int64)[: len(ids)] % p, x0v, cols


@pytest.mark.parametrize("p", [251, 1009, 2039])
@pytest.mark.parametrize("n,r", [(11, 4), (13, 3)])
def test_chunk_residues_match_jax_kernel(p, n, r):
    """The sharpest test: every chunk's residue of the plain version
    equals the JAX kernel's lane (mod p); the packs agree too."""
    core = _int_core(np.random.default_rng(7 * n + p), n, density=0.8)
    am = jmodp.reduce_core_mod(core, p)
    assert np.array_equal(modp.reduce_core_mod(core, p), am)
    nchunks = 1 << (n - 1 - r)
    ids = np.concatenate([np.arange(nchunks), [-1, -1, -1]]).astype(np.int64)
    want, x0v, cols_j = _jax_lane_residues(am, p, n, r, ids)
    x0, cols = modp.pack_mod(am, p, gray.pad_n(n))
    assert np.array_equal(x0.numpy(), x0v.astype(np.int64))
    assert np.array_equal(cols.numpy(), cols_j.astype(np.int64))
    got = modp_cuda.mod_partials(torch.as_tensor(ids), x0, cols, p, n=n, r=r)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert (got[-3:] == 0).all()
    # the chunk sums give the permanent, as perman_core_mod reduces them
    acc = 2 * int(got.sum()) % p
    assert (-acc % p if n % 2 == 0 else acc) == exact._perman_mod_host(
        core, p)


def test_glynn_pack_matches_jax():
    core = _int_core(np.random.default_rng(3), 9, density=0.7)
    for p in (251, P31):
        am = modp.reduce_core_mod(core, p)
        y0, cols = modp.pack_glynn_mod(am, p, 16)
        if p <= jmodp.PRIME_CEIL:
            y0v, cols_j, _ = jmodp.pack_glynn_mod(am, p, 16)
            assert np.array_equal(y0.numpy(), y0v.astype(np.int64))
            assert np.array_equal(cols.numpy(), cols_j.astype(np.int64))
        assert ((cols >= 0) & (cols < p)).all()


# ------------------------------------------------------ per-prime residues

@pytest.mark.parametrize("n", [2, 3, 5, 8, 13])
def test_perman_core_mod_matches_jax(n):
    core = _int_core(np.random.default_rng(n), n, density=0.7)
    for p in (jmodp.PRIME_CEIL, 251):
        want = jmodp.perman_core_mod(core, p, interpret=True)
        assert modp.perman_core_mod(core, p, CPU) == want
        assert modp.perman_core_glynn_mod(core, p, CPU) == \
            jmodp.perman_core_glynn_mod(core, p, interpret=True) == want


def test_pruned_perman_core_mod_matches_jax():
    """ids and r from _live_exact: the port splits the live chunks to fill
    the card and must still give the JAX package's residue."""
    tested = 0
    for seed in range(4):
        core = _int_core(np.random.default_rng(seed), 12, density=0.3, hi=30)
        a2 = modp._doubled_object(core)
        for r in (4, 6):
            ids = modp._live_exact(a2, r)
            if ids is None:
                continue
            for p in (jmodp.PRIME_CEIL, 1009):
                want = jmodp.perman_core_mod(core, p, ids=ids, r=r,
                                             interpret=True)
                assert modp.perman_core_mod(core, p, CPU, ids=ids,
                                            r=r) == want
                tested += 1
    assert tested >= 4


@pytest.mark.parametrize("p", [P31, P31_NEXT])
def test_perman_core_mod_31bit_matches_host_walk(p):
    """31-bit primes, past the JAX kernel's p <= 2039: the JAX package's
    pure-Python walk is the reference, and Glynn agrees with it."""
    for n in (3, 9, 14):
        core = _int_core(np.random.default_rng(n + p % 7), n, density=0.7,
                         hi=1 << 20)
        want = jexact._perman_mod_host(core, p)
        assert exact._perman_mod_host(core, p) == want
        assert modp.perman_core_mod(core, p, CPU) == want
        assert modp.perman_core_glynn_mod(core, p, CPU) == want


def test_sentinels_give_zero_at_n_multiple_of_8():
    """Counterpart of tests/test_modp.py's sentinel regression: at
    n % 8 == 0 there is no all-zero pad row, so a sentinel chunk that
    walked would add the same wrong residue at every prime, invisible to
    the held-out verifier.  Sentinels must give exactly 0."""
    n, p = 16, P31
    core = _int_core(np.random.default_rng(16), n)
    ref = exact._perman_mod_host(core, p)
    ids = np.arange(1 << 11, dtype=np.int64)
    holed = np.insert(ids, [0, 700, 2048], -1)
    assert modp.perman_core_mod(core, p, CPU, ids=holed, r=4) == ref
    x0, cols = modp.pack_mod(modp.reduce_core_mod(core, p), p, n)
    got = modp_cuda.mod_partials(torch.as_tensor(holed), x0, cols, p, n=n,
                                 r=4)
    assert (got[torch.as_tensor(holed) < 0] == 0).all()
    core2 = _int_core(np.random.default_rng(18), n, density=0.35, hi=20)
    ids2 = modp._live_exact(modp._doubled_object(core2), 4)
    assert ids2 is not None and len(ids2)
    want = jexact._perman_bigint_dfs(core2) % p
    assert modp.perman_core_mod(core2, p, CPU, ids=np.append(ids2, -1),
                                r=4) == want


# -------------------------------------------------------------- CRT driver

@pytest.mark.parametrize("case", ["seed40_sparse12", "dense10"])
def test_crt_matches_jax(case):
    if case == "seed40_sparse12":
        core = _int_core(np.random.default_rng(40), 12, density=0.3, hi=9)
    else:
        core = _int_core(np.random.default_rng(10), 10, hi=30)
    want, jmeta = jmodp.crt_perman_core(core, interpret=True)
    got, meta = modp.crt_perman_core(core, CPU)
    assert got == want == jexact._perman_bigint_dfs(core)
    assert meta["engine"] == "plain_mod"
    # 31-bit primes: fewer walks for the same bound
    assert meta["bound_bits"] == jmeta["bound_bits"]
    assert 1 <= meta["nprimes"] < jmeta["nprimes"]


@pytest.mark.parametrize("seed", [1, 2])
def test_crt_pruned_plan_matches_dfs(seed, monkeypatch):
    """A slow rate makes the planner prune an n=20 core (the JAX side
    would need n ~ 30, past what interpret mode can walk): the pruned,
    split CRT run must give the DFS integer."""
    monkeypatch.setattr(modp, "K3_GITERS", 0.001)
    rng = np.random.default_rng(seed)
    n = 20
    m = rng.integers(1, 9, (n, n)) * (rng.random((n, n)) < 0.2)
    core = [[int(v) for v in row] for row in m]
    plan = modp.core_plan(core)
    assert plan is not None and 0 < plan[3] < 1
    per, meta = modp.crt_perman_core(core, CPU)
    assert meta["live_frac"] == plan[3] and meta["r"] == plan[2]
    assert per == exact._perman_bigint_dfs(core) != 0


def test_crt_checkpoint_resume(tmp_path):
    """A restarted CRT run recomputes only the missing primes."""
    core = _int_core(np.random.default_rng(9), 9, density=0.8, hi=25)
    want = jexact._perman_bigint_dfs(core)
    ck = str(tmp_path / "res.jsonl")
    logs = []
    per1, meta1 = modp.crt_perman_core(core, CPU, checkpoint_path=ck,
                                       log=logs.append)
    assert per1 == want
    assert len(logs) == meta1["nprimes"] + 1
    logs2 = []
    assert modp.crt_perman_core(core, CPU, checkpoint_path=ck,
                                log=logs2.append)[0] == want
    assert logs2 == []            # nothing recomputed
    lines = open(ck).read().splitlines()
    with open(ck, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")
    logs3 = []
    assert modp.crt_perman_core(core, CPU, checkpoint_path=ck,
                                log=logs3.append)[0] == want
    assert len(logs3) == 1


def test_checkpoint_rejects_other_cores_rows(tmp_path):
    """Rows stamped with another core's fingerprint are ignored: they
    would pass the held-out verifier and certify the wrong permanent."""
    ck = str(tmp_path / "res.jsonl")
    rng = np.random.default_rng(8)
    m1 = _int_core(rng, 8, density=0.8, hi=25)
    m2 = _int_core(rng, 8, density=0.8, hi=25)
    assert m1 != m2
    assert modp.crt_perman_core(m1, CPU, checkpoint_path=ck)[0] == \
        jexact._perman_bigint_dfs(m1)
    logs = []
    per2, _ = modp.crt_perman_core(m2, CPU, checkpoint_path=ck,
                                   log=logs.append)
    assert per2 == jexact._perman_bigint_dfs(m2)
    assert any("fingerprint mismatch" in s for s in logs)


# ----------------------------------------------------------- the wrapper

def _good_args(n=9, p=251):
    x0, cols = modp.pack_mod(modp.reduce_core_mod(
        _int_core(np.random.default_rng(0), n), p), p, 16)
    return torch.arange(8), x0, cols


@pytest.mark.parametrize("bad", [
    "p_even", "p_too_big", "p_too_small", "ids_int32", "x0_float",
    "cols_shape", "x0_shape", "residue_range", "r_too_big", "ids_2d"])
def test_wrapper_rejects_bad_inputs(bad):
    ids, x0, cols = _good_args()
    p, n, r = 251, 9, 3
    if bad == "p_even":
        p = 252
    elif bad == "p_too_big":
        p = P31 + 2           # 2^31 + 1: odd, but past the kernel's range
    elif bad == "p_too_small":
        p = 1
    elif bad == "ids_int32":
        ids = ids.to(torch.int32)
    elif bad == "x0_float":
        x0 = x0.to(torch.float64)
    elif bad == "cols_shape":
        cols = cols[:-1].contiguous()
    elif bad == "x0_shape":
        x0 = x0[:12].contiguous()
    elif bad == "residue_range":
        cols = cols.clone()
        cols[0, 0] = p
    elif bad == "r_too_big":
        r = n
    elif bad == "ids_2d":
        ids = ids.reshape(2, 4)
    with pytest.raises((ValueError, TypeError)):
        modp_cuda.mod_partials(ids, x0, cols, p, n=n, r=r)
    if bad.startswith("p_"):
        with pytest.raises(ValueError, match="odd"):
            modp.perman_core_mod([[1, 2], [3, 4]], p, CPU)


def test_montgomery_constants():
    for p in (3, 251, 2039, P31_NEXT, P31):
        pinv, r2 = modp_cuda.montgomery_constants(p)
        assert (p * pinv) % (1 << 32) == (1 << 32) - 1
        assert r2 == pow(2, 64, p)
