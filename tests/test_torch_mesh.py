"""The port's multi-device and multi-process layer: meshes of "cpu"
entries (the kernels' plain versions) against one device, against the
JAX package's sharded walk on its 8 forced CPU devices, the round-robin
deal, and two real gloo processes.

The contract (superman_tpu_torch/parallel/sharding.py): over any mesh the
result is bitwise the single-device one, in every tier, dense and sparse.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import superman_tpu_torch as spt
from superman_tpu_torch.core.flags import Flags
from superman_tpu_torch.ops import gray, ryser_cuda
from superman_tpu_torch.parallel import mesh as pmesh
from superman_tpu_torch.parallel import multihost, sharding
from tests.conftest import random_int_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _dense(n=20, seed=20):
    return random_int_matrix(np.random.default_rng(seed), n, 0.5, vmax=2)


def _sparse(n=22, seed=1, d=0.15):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < d) * rng.integers(1, 4, (n, n))
    np.fill_diagonal(a, rng.integers(1, 3, n))
    return a


KINDS = {
    "dense": lambda: (_dense(), {"chunk_log2": 6, "lanes": 128}),
    # the sparse engine's pruned, factored walk through the reduced entry
    "sparse": lambda: (_sparse(), {"sparse": True, "chunk_log2": 8}),
    "glynn": lambda: (_dense(), {"chunk_log2": 6, "lanes": 128,
                                 "perman_algo": "glynn"}),
}


@pytest.mark.parametrize("tier", ["df64", "tf96"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("k", [2, 3, 4])
def test_mesh_is_bitwise_the_single_device(k, kind, tier):
    """mesh_shape=(k,) on device="cpu" deals the blocks over k entries;
    the permanent is the single device's to the last bit."""
    a, kw = KINDS[kind]()
    single = spt.permanent(a, device="cpu", calc=tier, **kw)
    multi = spt.permanent(a, device="cpu", calc=tier, mesh_shape=(k,), **kw)
    assert multi.permanent == single.permanent
    assert multi.meta["mesh"] == k and single.meta["mesh"] is None
    if kind == "sparse":
        assert "sparse" in multi.meta and multi.meta["sparse"][
            "factored_rows"] >= 1


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_mesh_matches_the_jax_sharded_walk(kind):
    """The JAX package's sharded compute_partials on its 8 forced CPU
    devices (Pallas in interpret mode) and the port over 8 "cpu" entries:
    within 1e-12 on integer matrices."""
    import superman_tpu as sp
    if kind == "dense":
        a, kw = _dense(), {"chunk_log2": 6, "lanes": 128}
    else:
        a, kw = _sparse(20, 5, 0.18), {"sparse": True, "chunk_log2": 8,
                                       "lanes": 128}
    want = sp.permanent(a, calc="df64", mesh_shape=(8,), **kw)
    got = spt.permanent(a, device="cpu", calc="df64", mesh_shape=(8,), **kw)
    assert want.meta["mesh"] == got.meta["mesh"] == 8
    assert got.permanent == pytest.approx(want.permanent, rel=1e-12)


def _split_layout(live, r, want):
    """The reduced walk's whole split, padded layout as (blocks, 128)
    ids, row by row (sharding.split_rows over every row)."""
    shift = gray.split_shift(len(live), r, want)
    nblocks = -(-(len(live) << shift) // 128)
    ids = sharding.split_rows(torch.as_tensor(live), shift,
                              torch.arange(nblocks))
    return ids.reshape(nblocks, 128).numpy(), r - shift


@pytest.mark.parametrize("k", [2, 3, 4, 7])
def test_round_robin_balance(k):
    """The deal gives every entry its share of block rows: the live chunks
    of any two entries differ by at most one block, dense (rows of L ids)
    and reduced (blocks of 128 split chunks)."""
    rng = np.random.default_rng(k)
    live = np.sort(rng.choice(1 << 14, 3000, replace=False))
    blocks, r = _split_layout(live, 6, 2000)
    assert r == 6 and blocks.shape[1] == 128
    dense = sharding.pad_ids(live, 100)
    for layout in (blocks, dense):
        seen = []

        def launch(dev, rows):
            seen.append(int((rows >= 0).sum()))
            return torch.as_tensor(rows)

        mesh = pmesh.make_mesh(devices=["cpu"] * k)
        out = sharding._deal(layout, mesh, CPU, launch)
        assert np.array_equal(out, layout)        # back in single order
        assert sum(seen) == len(live)
        assert max(seen) - min(seen) <= layout.shape[1]


@pytest.mark.parametrize("r,want", [(8, 1000), (6, 2000), (5, 40000)])
def test_split_is_decided_before_the_deal(r, want):
    """A short pruned list is split into sub-chunks once, for the whole
    list, and padded to whole blocks: any row of the split layout, made on
    its own, holds what gray.split_chunks and the reduced walk's padding
    give that row on one device."""
    live = np.arange(0, 600, 3, dtype=np.int64)
    blocks, r_w = _split_layout(live, r, want)
    split, r_one = gray.split_chunks(torch.as_tensor(live), r, want)
    assert r_w == r_one and (r_w < r) == (len(live) < want)
    padded = ryser_cuda._pad_to_block(split).reshape(-1, 128).numpy()
    assert np.array_equal(blocks, padded)
    shift = r - r_w
    for row in (0, len(blocks) - 1, len(blocks) // 2):
        alone = sharding.split_rows(torch.as_tensor(live), shift,
                                    torch.tensor([row]))
        assert np.array_equal(alone.numpy(), padded[row])


def test_host_slice_partitions_the_blocks():
    """host_slice deals block rows round-robin: every row lands in exactly
    one process's slice."""
    blocks = sharding.pad_ids(np.arange(1000), 64)
    for count in (1, 2, 3, 5):
        parts = [multihost.host_slice(blocks, p, count)
                 for p in range(count)]
        rows = np.concatenate(parts)
        assert len(rows) == len(blocks)
        assert sorted(map(tuple, rows)) == sorted(map(tuple, blocks))
    assert multihost.combine_host_totals(3.25) == 3.25
    ld = np.longdouble(1) + np.longdouble(2.0) ** -60
    assert multihost.combine_host_totals(ld) == ld


def test_mesh_for_flags():
    """mesh_shape or a multi-device id asks for a mesh of
    min(want, available) entries: k "cpu" entries on the CPU, the visible
    cards on a card (one card: no mesh)."""
    cpu = torch.device("cpu")
    assert pmesh.mesh_for_flags(Flags(), cpu) is None
    assert len(pmesh.mesh_for_flags(Flags(mesh_shape=(3,)), cpu)) == 3
    assert pmesh.mesh_for_flags(Flags(mesh_shape=(1,)), cpu) is None
    m = pmesh.mesh_for_flags(Flags(perman_algo="5"), cpu)
    assert len(m) == Flags().gpu_num and m.streams == [None, None]
    assert len(pmesh.mesh_for_flags(Flags(perman_algo="5", gpu_num=4),
                                    cpu)) == 4
    assert pmesh.mesh_for_flags(Flags(perman_algo="5", gpu_num=0),
                                cpu) is None
    mesh = pmesh.make_mesh(2, devices=["cpu"] * 3)
    assert list(mesh) == [cpu, cpu]
    with pytest.raises(RuntimeError, match="only 3"):
        pmesh.make_mesh(4, devices=["cpu"] * 3)


def test_mesh_for_flags_on_one_card(monkeypatch):
    """On one card, mesh_shape=(4,) runs on one device, as the JAX package
    does with fewer chips than it asks for."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pmesh.mesh_for_flags(Flags(mesh_shape=(4,)),
                                torch.device("cuda", 0)) is None


def test_init_distributed_is_a_noop_alone(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    pmesh.init_distributed()
    assert pmesh.process_info() == (0, 1)


_SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from superman_tpu_torch.parallel.mesh import init_distributed, process_info
init_distributed()
import superman_tpu_torch as spt
from tests.test_torch_mesh import _multihost_inputs
a, sa = _multihost_inputs()
r = spt.permanent(a, calc="df64", chunk_log2=6, lanes=256, device="cpu")
s = spt.permanent(sa, sparse=True, chunk_log2=8, device="cpu")
t = spt.permanent(a, calc="tf96", chunk_log2=6, lanes=256, device="cpu",
                  mesh_shape=(2,))
print("RESULT", repr(r.permanent), repr(s.permanent), repr(t.permanent),
      process_info()[1], int("sparse" in s.meta))
"""


def _multihost_inputs():
    rng = np.random.default_rng(77)
    a = random_int_matrix(rng, 21, 0.5, vmax=2)
    np.fill_diagonal(a, 1)
    return a, _sparse(22, 3, 0.12)


def test_two_real_processes_bitwise():
    """Two processes joined over gloo (WORLD_SIZE=2, torchrun's variables)
    each walk their interleaved blocks: both print the same values bit for
    bit, dense, sparse (the reduced entry) and tf96 over a mesh of 2, and
    within 1e-12 of one process (the blocks are regrouped)."""
    code = _SCRIPT.format(repo=REPO)
    # a fixed port can collide with another run: bind, then release one
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=dict(env, RANK=str(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert line, out + err[-500:]
        outs.append(line[0].split())
    assert outs[0] == outs[1]                     # bitwise across hosts
    assert outs[0][4] == "2" and outs[0][5] == "1"
    a, sa = _multihost_inputs()
    single = [spt.permanent(a, calc="df64", chunk_log2=6, lanes=256,
                            device="cpu"),
              spt.permanent(sa, sparse=True, chunk_log2=8, device="cpu"),
              spt.permanent(a, calc="tf96", chunk_log2=6, lanes=256,
                            device="cpu")]
    for got, one in zip(outs[0][1:4], single):
        assert float(got) == pytest.approx(one.permanent, rel=1e-12)
