"""The CUDA kernels on a card, against their plain PyTorch versions.

Imports neither jax nor the test helpers, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_card.py

Without a card the tests skip.
"""

import numpy as np
import pytest
import torch

from superman_tpu_torch.ops import gray, modp, modp_cuda, ryser, ryser_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(12, 3), (24, 5), (40, 2)])
def test_kernel_matches_plain_on_card(n, r):
    """Integer matrix, row-scaled as the engine scales it: the kernel
    and the plain version take the same IEEE steps, so the partials must
    agree bitwise; sentinel ids give 0 and the launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n)
    a = (rng.random((n, n)) < 0.5) * rng.integers(1, 5, (n, n))
    a_s = np.ldexp(a.astype(np.float64), -ryser._row_scales(a)[:, None])
    dev = torch.device("cuda", 0)
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, gray.pad_n(n)))
    nchunks = 1 << (n - 1 - r)
    ids = torch.cat([torch.arange(min(nchunks, 4096)), torch.full((5,), -1),
                     torch.arange(nchunks - min(nchunks, 512), nchunks)]
                    ).to(dev)
    before = ryser_cuda.LAUNCHES
    got = ryser_cuda.ryser_partials(ids, x0, cols, n=n, r=r)
    torch.cuda.synchronize()
    assert ryser_cuda.LAUNCHES == before + 1
    want = ryser_cuda.ryser_partials_ref(ids, x0, cols, n=n, r=r)
    assert torch.equal(got, want)
    assert torch.equal(got[ids < 0], torch.zeros(5, 2, dtype=torch.float64,
                                                 device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,p", [(12, 3, 2039), (24, 5, (1 << 31) - 1),
                                   (40, 2, 1009)])
def test_modp_kernel_matches_plain_on_card(n, r, p):
    """The Z_p kernel writes canonical residues, so it must equal the
    plain version exactly on every chunk; sentinels give 0 and the launch
    is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n)
    core = ((rng.random((n, n)) < 0.6) * rng.integers(1, 1 << 20, (n, n))
            ).tolist()
    dev = torch.device("cuda", 0)
    x0, cols = (t.to(dev) for t in modp.pack_mod(
        modp.reduce_core_mod(core, p), p, gray.pad_n(n)))
    nchunks = 1 << (n - 1 - r)
    ids = torch.cat([torch.arange(min(nchunks, 4096)), torch.full((5,), -1),
                     torch.arange(nchunks - min(nchunks, 512), nchunks)]
                    ).to(dev)
    before = modp_cuda.LAUNCHES
    got = modp_cuda.mod_partials(ids, x0, cols, p, n=n, r=r)
    torch.cuda.synchronize()
    assert modp_cuda.LAUNCHES == before + 1
    want = modp_cuda.mod_partials_ref(ids, x0, cols, p, n=n, r=r)
    assert torch.equal(got, want)
    assert bool(((got >= 0) & (got < p)).all())
    assert torch.equal(got[ids < 0], torch.zeros(5, dtype=torch.int64,
                                                 device=dev))


@pytest.mark.cuda
def test_pruned_walk_matches_dense_walk_on_card():
    """A pruned live-chunk plan, split to fill the card, gives the dense
    walk's residue: the same kernel over two chunkings of one sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, p = 24, (1 << 31) - 1
    rng = np.random.default_rng(24)
    core = ((rng.random((n, n)) < 0.25) * rng.integers(1, 9, (n, n))).tolist()
    col_perm, ids, r, live_frac = modp.core_plan(core, giters=0.001)
    assert 0 < live_frac < 1
    work = [[row[j] for j in col_perm] for row in core]
    dev = torch.device("cuda", 0)
    assert modp.perman_core_mod(work, p, dev, ids=ids, r=r) == \
        modp.perman_core_mod(core, p, dev)
