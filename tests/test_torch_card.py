"""The CUDA kernel on a card, against its plain PyTorch version.

Imports neither jax nor the test helpers, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_card.py

Without a card the test skips.
"""

import numpy as np
import pytest
import torch

from superman_tpu_torch.ops import gray, ryser, ryser_cuda


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
