"""The walk kernels' grouped step rule (ops/ryser_cuda.step_rule, the rule
of csrc/walk.cuh walk_chunk) against the plain one: step m adds column
ctz(m), with the x-sign of bit ctz(m)+1 of m, or the chunk parity at the
mid step.  The in-group constants are also held against the JAX package's
table of its unrolled walk (superman_tpu/ops/ryser_pallas.py
_static_table), which groups the steps the same way.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from superman_tpu.ops.ryser_pallas import _static_table
from superman_tpu_torch.ops import gray, ryser_cuda

WALK_CUH = (Path(ryser_cuda.__file__).resolve().parents[1] / "csrc"
            / "walk.cuh")


def _ctz_rule(r):
    """(k, s) arrays of the plain rule for m = 1 .. 2^r - 1 (s = 0 at the
    mid step)."""
    m = np.arange(1, 1 << r, dtype=np.int64)
    k = np.zeros_like(m)
    while True:
        even = ((m >> k) & 1) == 0
        if not even.any():
            break
        k += even
    s = 1 - 2 * ((m >> (k + 1)) & 1)
    return m, k, np.where(k == r - 1, 0, s)


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("r", range(1, 19))
def test_grouped_rule_is_the_ctz_rule(r, g):
    """Every step of a chunk of 2^r: the grouped rule gives m in order,
    the column ctz(m) and its sign, the parity at the mid step only."""
    got = np.array(list(ryser_cuda.step_rule(r, g)),
                   dtype=np.int64).reshape(-1, 3)
    m, k, s = _ctz_rule(r)
    assert np.array_equal(got[:, 0], m)
    assert np.array_equal(got[:, 1], k)
    assert np.array_equal(got[:, 2], s)
    assert (got[:, 2] == 0).sum() == 1


@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_in_group_constants_match_the_jax_table(g):
    """The steps inside a group (0 < i < 2^g) have the JAX unrolled
    walk's constants: column ctz(i), its sign, and at k = g-1 the group's
    parity bit (marked 0 in the JAX table), which the grouped rule reads
    as the sign of bit 0 of the group index."""
    r = g + 3
    steps = list(ryser_cuda.step_rule(r, g))
    table = _static_table(g)
    for j in range(1 << (r - g)):
        inner = [(m - (j << g), k, s) for m, k, s in steps
                 if m >> g == j and m & ((1 << g) - 1)]
        top = 1 - 2 * (j & 1)
        assert inner == [(i, k, top if s == 0 else s) for i, k, s in table]


def test_plain_steps_repeat_the_ctz_walk():
    """ryser_cuda._walk_steps (the plain versions' walk) gives every x
    bit for bit as adding +-column ctz(m) step by step does, at an r
    where the mid step ends the first half of the groups."""
    rng = np.random.default_rng(3)
    n, r = 12, 6
    a = rng.random((n, n)) * 4 - 2
    x0, cols = (torch.as_tensor(v) for v in gray.pack_matrix(a, 16))
    ids = torch.tensor([0, 1, 5, 6, 7])
    x, sign_mid = gray.chunk_init(ids, x0, cols, n, r)
    want = x
    _, k, s = _ctz_rule(r)
    for (m, got), km, sm in zip(ryser_cuda._walk_steps(x, sign_mid, cols, r),
                                k.tolist(), s.tolist()):
        sign = sign_mid[:, None] if sm == 0 else float(sm)
        want = want + sign * cols[km, None, :]
        assert torch.equal(got, want), m


def test_group_size_is_the_kernels():
    """The plain rule groups steps as the kernel does."""
    src = WALK_CUH.read_text()
    got = re.search(r"constexpr int kGroupLog2 = (\d+);", src)
    assert got and int(got.group(1)) == ryser_cuda.GROUP_LOG2
