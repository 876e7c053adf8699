"""Gray-code range decomposition and x-vector initialization.

Port of ``superman_tpu/ops/gray.py``.  The Ryser index space
i in [0, 2^(n-1)) is cut into aligned chunks of 2**r indices, chunk ids
0..2^(n-1-r)-1.  Inside an aligned chunk the flipped column at inner step
m is k = ctz(m) for every chunk alike, and the only chunk-dependent sign
is that of the single mid step m = 2**(r-1), which equals the chunk-index
parity.  The CUDA kernels walk one chunk per thread; this module keeps the
decomposition, the chunk ids and the parity rule of the reference, so
per-chunk partials of the two packages compare one to one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .df64 import join_f64
from .tf96 import dd_mul

#: streaming multiprocessors of an H100 SXM; the planner's default when it
#: is not handed a card (the CPU runs plan exactly as that card would)
DEFAULT_SMS = 132
#: chunks (threads) to plan per SM.  512 gives 2^17 chunks at n=32 on 132
#: SMs, and the per-chunk output stays 2 MB.  At n_pad=32 the grouped walk
#: takes 252 registers in df64 and tf96 (2 blocks of 128 threads reside on
#: an SM) and ~125 in f32 (4); 2^17 chunks run within 2% of the best of
#: 2^17..2^20 (df64 10.42 ms against 10.22 at 2^20; f32 and tf96 within
#: 2% too), and fewer chunks leave SMs idle (df64 +6% at 2^15, +12% at
#: 2^14) (tools/kernel_time.py --r; NVIDIA H100 80GB HBM3, 700.00 W)
RESIDENT_CHUNKS_PER_SM = 512
#: chunks per SM that a pruned list is split up to before the reduced
#: kernel walks it.  A pruned list has any length, so its last wave of
#: blocks (an SM holds 2 of df64 at n_pad=32) is seldom full, and with few
#: waves that costs much: a sparse plan of chip_smoke.py's n=36 matrix
#: (r=18, 21,528 live chunks, 5.64e9 live steps: the plan its f32 tiers
#: walk; under df64 and tf96 the planner picks r=16, 65,098 live chunks,
#: 4.27e9 live steps) walked under df64 in 40.2 ms as 86,112 chunks (652
#: an SM), 35.1 as 172,224, 32.6 as 344,448, 31.4 as 688,896 (5,219 an SM)
#: and no faster beyond (tools/chunk_cost.py, on the walk loop before its
#: steps were grouped; NVIDIA H100 80GB HBM3, 700.00 W)
SPLIT_CHUNKS_PER_SM = 4096


@dataclasses.dataclass(frozen=True)
class RyserPlan:
    n: int           # matrix order
    n_pad: int       # padded x length (multiple of 8)
    r: int           # log2 chunk length
    lanes: int       # chunk ids per id block (padding granularity)
    num_chunks: int  # total chunks = 2^(n-1-r)


def pad_n(n: int) -> int:
    """Smallest multiple of 8 >= max(n, 8): the kernel's row count."""
    return max(8, -(-n // 8) * 8)


def make_plan(n: int, lanes: int = 1024, chunk_log2=None, *,
              sms: int = DEFAULT_SMS, grid_multip: int = 1,
              min_blocks: int = 1) -> RyserPlan:
    """Chunk-decomposition planner for the one-thread-per-chunk kernel.

    With chunk_log2 given, r and lanes follow the reference planner
    exactly (``superman_tpu.ops.gray.make_plan``), so both packages can
    walk the same plan.  Otherwise r is chosen so that the chunk count is
    the smallest power of two that gives every SM RESIDENT_CHUNKS_PER_SM
    threads (times grid_multip, the reference's -e over-decomposition):
    at n=32 on 132 SMs that is 2^17 chunks of 2^14 steps.  Every chunk
    costs the same, so more chunks only shorten the last wave.
    min_blocks: without chunk_log2, r is lowered further (down to 1) until
    there are at least this many blocks of `lanes` ids; the hybrid
    scheduler's unit queue asks for 32.
    """
    total = n - 1
    if chunk_log2 is None:
        want = max(1, sms * RESIDENT_CHUNKS_PER_SM * max(1, grid_multip),
                   min_blocks * lanes)
        r = total - (want - 1).bit_length()
    else:
        r = chunk_log2
    r = max(1, min(r, n - 2)) if n > 2 else 1
    num_chunks = 1 << max(0, total - r)
    lanes = min(lanes, num_chunks)
    return RyserPlan(n=n, n_pad=pad_n(n), r=r, lanes=lanes,
                     num_chunks=num_chunks)


def batch_plan(n: int, batch: int, chunk_log2=None, *,
               sms: int = DEFAULT_SMS) -> int:
    """log2 chunk length r for the serving-batch kernel walking `batch`
    matrices of order n, each cut into 2^(n-1-r) chunks in blocks of 128.

    r is the largest value that still gives every SM
    RESIDENT_CHUNKS_PER_SM threads over the whole batch, clamped so that
    a matrix has at least one full block (r <= n - 8) and r >= 1: 256
    matrices of n=24 get 512 chunks of 2^14 steps each, 16 of n=32 get
    8192 chunks of 2^18.  With chunk_log2 given, r is that, clamped the
    same way."""
    if n < 9:
        raise ValueError(f"the batch kernel needs n >= 9, got {n}")
    if chunk_log2 is None:
        want = -(-sms * RESIDENT_CHUNKS_PER_SM // max(1, batch))
        r = (n - 1) - (want - 1).bit_length()
    else:
        r = chunk_log2
    return max(1, min(r, n - 8))


def chunk_gray_bits(chunk_ids: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Gray-code bits of base = chunk_id * 2^r as a (..., n-1) 0/1 int64
    tensor: bit b = gray(chunk)>>(b-r) for b >= r, chunk&1 for b == r-1,
    else 0."""
    l = chunk_ids.to(torch.int64)
    gray_l = l ^ (l >> 1)
    b = torch.arange(n - 1, dtype=torch.int64, device=l.device)
    hi = (gray_l[..., None] >> (b - r).clamp(min=0)) & 1
    hi = torch.where(b >= r, hi, 0)
    mid = torch.where(b == r - 1, l[..., None] & 1, 0)
    return hi | mid


def x0_f64(a: np.ndarray) -> np.ndarray:
    """Nijenhuis–Wilf initial x vector (host, float64):
    x0[j] = a[j, n-1] - rowsum(j)/2  (reference algo.h:1044-1049)."""
    a = np.asarray(a, dtype=np.float64)
    return a[:, -1] - a.sum(axis=1) / 2


def chunk_init(chunk_ids: torch.Tensor, x0: torch.Tensor, cols: torch.Tensor,
               n: int, r: int):
    """x-vectors and mid-step signs of chunks, in the dtype of x0
    (float64, or float32 for the f32 tiers).

    chunk_ids: (C,) int64 (sentinel ids < 0 give x = 0, a dead chunk).
    x0:        (n_pad,), padding rows 1; or (B, n_pad), one per matrix
               of a stack that walks the same chunk ids.
    cols:      (n-1, n_pad), column k of the matrix in row k; or
               (B, n-1, n_pad).
    Returns (x, sign_mid): x (C, n_pad) or (B, C, n_pad), sign_mid (C,).

    The columns are added in order k = 0..n-2, as the kernel's prologue
    adds them (csrc/walk.cuh), so both give the same bits, and a stack
    gives each matrix the bits it gets alone.
    """
    dead = chunk_ids < 0
    ids = torch.where(dead, 0, chunk_ids)
    bits = chunk_gray_bits(ids, n, r).to(x0.dtype)          # (C, n-1)
    x = x0[..., None, :].expand(*x0.shape[:-1], ids.shape[0], x0.shape[-1])
    for k in range(n - 1):
        x = x + bits[:, k:k + 1] * cols[..., k, None, :]
    sign_mid = (1 - 2 * (ids & 1)).to(x0.dtype)
    x = torch.where(dead[:, None], 0.0, x)
    return x, sign_mid


def factor_weights(chunk_ids: torch.Tensor, fx0: torch.Tensor,
                   fcols: torch.Tensor, n: int, r: int):
    """Per-chunk weights of a factored walk: the product over the factored
    rows of their x at the chunk's base.  The plain version of the
    kernel's chunk_weight (csrc/walk.cuh) and the counterpart of
    ``superman_tpu.ops.gray.factor_weights``.

    chunk_ids: (C,) int64; a sentinel id < 0 gets weight 0.
    fx0:       (nf,) float64, the factored rows' x0 (pack_matrix of those
               rows with n_pad = nf: no padding rows).
    fcols:     (n-1, nf) float64, their columns.
    Returns (hi, lo), each (C,) float64: the weight as a double-double,
    the first row's x, then a dd_mul by each further row's (x, 0), the
    kernel's order.  A factored row is constant inside a chunk (it has no
    entry in the columns below r), so the x that chunk_init builds for
    the base is its x at every step.  With no factored row the weight is
    1."""
    x, _ = chunk_init(chunk_ids, fx0, fcols, n, r)           # (C, nf)
    zero = torch.zeros(chunk_ids.shape, dtype=fx0.dtype, device=fx0.device)
    if fx0.shape[0] == 0:
        hi, lo = zero + 1.0, zero
    else:
        hi, lo = x[:, 0], zero
        for z in range(1, fx0.shape[0]):
            hi, lo = dd_mul(hi, lo, x[:, z], zero)
    dead = chunk_ids < 0
    return torch.where(dead, 0.0, hi), torch.where(dead, 0.0, lo)


def split_shift(count: int, r: int, want: int) -> int:
    """log2 of the pieces each of `count` chunks of 2^r steps is cut into
    so that there are at least `want` of them: the least such shift, at
    most r - 1, and 0 for an empty or already sufficient list."""
    if not 0 < count < want:
        return 0
    return min(int(r) - 1, (-(-want // count) - 1).bit_length())


def split_chunks(ids: torch.Tensor, r: int, want: int):
    """Split each chunk of 2^r steps into 2^shift aligned chunks of
    2^(r - shift) (shift from split_shift), which cover the same Gray
    indices, so that a pruned list of fewer than `want` live chunks still
    fills the card's thread slots.  A row that is constant inside a chunk
    at r is constant at every smaller r, so pruning and factoring stay
    valid.  ids: (C,) int64 without sentinels.  Returns (ids, r)."""
    shift = split_shift(ids.numel(), r, want)
    if shift:
        sub = torch.arange(1 << shift, dtype=torch.int64, device=ids.device)
        ids = ((ids[:, None] << shift) | sub).reshape(-1)
    return ids, int(r) - shift


def pack_matrix(a: np.ndarray, n_pad: int):
    """Host-side packing: (x0, cols) float64 with padding rows that are
    multiplicative identities (x0 pad = 1, column pad = 0).
    x0 is (n_pad,), cols is (n-1, n_pad).  a may be a (rows, n) row subset
    of an order-n matrix: the factored walk packs its alive rows and its
    factored rows apart."""
    a = np.asarray(a, dtype=np.float64)
    rows, n = a.shape
    x0 = np.ones(n_pad, dtype=np.float64)
    x0[:rows] = x0_f64(a)
    cols = np.zeros((n - 1, n_pad), dtype=np.float64)
    cols[:, :rows] = a[:, : n - 1].T
    return x0, cols


def from_jax_pack(x0_pair, cols_pair, rows=None):
    """The JAX package's f32-pair pack as this package's float64 pack:
    hi + lo, exact.  It takes the Ryser pack (``superman_tpu.ops.gray.
    pack_matrix``) and the Glynn pack (``superman_tpu.ops.glynn.
    _pack_glynn``), which share one layout: x0_pair (2, n_pad) and
    cols_pair (2, n-1, n_pad) become x0 (n_pad,) and cols (n-1, n_pad),
    what gray.pack_matrix and glynn._pack_glynn make here.
    rows: keep the first `rows` rows only.  The reference pads its factor
    pack (fx0_pair, fcols_pair) to a multiple of 8 with identity rows;
    the port's factor pack has none, so the sparse walk's factor pack is
    read with rows=len(factor_rows).
    A permanent engine has no weights; this is the one input format the
    two packages must agree on, so both walk identical inputs."""
    x0_pair = np.asarray(x0_pair)
    cols_pair = np.asarray(cols_pair)
    x0 = join_f64(x0_pair[0], x0_pair[1])
    cols = join_f64(cols_pair[0], cols_pair[1])
    if rows is not None:
        x0, cols = x0[:rows], np.ascontiguousarray(cols[:, :rows])
    return x0, cols
