"""Ryser walk, tiers df64, f32, f32k, tf96 and amp: the CUDA kernels'
wrappers and their plain versions.

The counterpart of ``superman_tpu/ops/ryser_pallas.py``, whose two
``pl.pallas_call`` sites it replaces:

* ``ryser_partials`` (``_partials_jit``, bodies ``_walk_scalar`` and
  ``_walk_u16``) is ``csrc/ryser_walk.cu``: one thread walks one aligned
  chunk of 2^r Gray steps of ONE matrix and writes that chunk's signed
  partial sum as a (hi, lo) pair.  ``ryser_blocks`` is the same kernel
  summing its blocks of 128 chunks on the card (``_merge_out8``), for the
  dense walk's total, with the chunk ids made on the card from block
  rows.  Two more entry points of that source complete the site:
  ``ryser_reduced`` (``_partials_jit`` with
  ``weighted``/``reduce``: ``_weight_out8``, ``_merge_out8``), the sparse
  engine's walk of the alive rows over a pruned id list, each chunk
  weighted by its factored rows and each block of 128 chunks reduced to
  one pair; and ``ryser_amp`` (``amp=True``: ``_amp_terms``), the
  unsigned amplitude sum that prices the float tiers for ``calc="auto"``,
  and, as a second variant, the conditioned-amplitude sum beside it.
* ``batch_partials`` (``_ryser_kernel_batch`` and the ``_merge_out8`` lane
  reduction after it) is ``csrc/ryser_batch.cu``: a stack of B matrices of
  one order, each walked whole by its own blocks of 128 chunks, every
  block reduced to one (hi, lo) pair in a fixed order.

Both kernels run one walk body (``csrc/walk.cuh``).  In the df64 tier x
and every product are native float64 on the card (the TPU carried them as
f32 pairs) and the accumulator is a compensated double-double; in f32 and
f32k x, the column table and the products are float32, with a plain and a
TwoSum accumulator; in tf96 x is float64 holding values exact in float32
and every product and the accumulator are double-doubles (ops/tf96.py;
the TPU carried them as f32 triples).  The plain versions below compute
the same functions with the same operation order, so on a card kernel and
plain version agree to the last bit on any input where nvcc keeps IEEE
order (no fast-math; the only multiply nvcc may fuse into an add, s * col
with s = +-1, is exact; the tf96 products are written with intrinsics it
does not fuse).

The wrappers return the outputs unchecked.  Under SUPERMAN_DEBUG_NANS
(utils/debug.py) they are checked for NaN where they reach the host:
K1's words, the block and reduced entries' and the amp walk's in
parallel/sharding.py, K2's in ops/batch.py ``walk_stack``.
"""

from __future__ import annotations

import torch

from ..csrc.build import call, on_card
from . import gray
from .df64 import df_add_f64, quick_two_sum, two_sum
from .tf96 import dd_mul, tree_prod_dd

#: the amp walk's within-line clamp (csrc/walk.cuh kAmpEps)
AMP_EPS = 2.0 ** -45

#: the chunk kernel is instantiated for n_pad = 8, 16, ..., MAX_N_PAD
MAX_N_PAD = 64
#: the batch kernel is instantiated for these n_pad (orders 9..32)
BATCH_N_PADS = (16, 24, 32)
#: threads of a block: the batch kernel reduces this many chunks to a pair
BLOCK = 128
#: log2 of the steps of one group of the walk kernels' loop
#: (csrc/walk.cuh kGroupLog2; step_rule)
GROUP_LOG2 = 3
#: most matrices of one batch launch (the grid's second dimension)
MAX_BATCH = 65535

#: tier -> (working dtype, csrc/walk.cuh's Tier number)
TIERS = {"df64": (torch.float64, 0), "f32": (torch.float32, 1),
         "f32k": (torch.float32, 2), "tf96": (torch.float64, 3)}
#: the tiers of the block-reduced dense walk (ryser_blocks)
BLOCK_TIERS = ("df64", "f32", "f32k")
#: walk.cuh's Tier numbers of the amp walk, without and with the
#: conditioned term
AMP_TIERS = (4, 5)


def _tier(tier: str) -> tuple:
    """(working dtype, Tier number) of `tier`, one of TIERS."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r} (one of {sorted(TIERS)})")
    return TIERS[tier]


def _check(ids, x0, cols, n: int, r: int, factors=None) -> None:
    """Raise on what the chunk kernels do not take.  factors: the
    (fx0, fcols) pack of a factored walk, whose x0 and cols hold the alive
    rows only, so n may exceed n_pad there."""
    named = [("ids", ids, torch.int64), ("x0", x0, torch.float64),
             ("cols", cols, torch.float64)]
    if factors is not None:
        named += [("fx0", factors[0], torch.float64),
                  ("fcols", factors[1], torch.float64)]
    for name, t, dt in named:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
    if ids.dim() != 1 or x0.dim() != 1:
        raise ValueError("ids and x0 must be 1-D")
    n_pad = x0.shape[0]
    if n_pad % 8 or not 8 <= n_pad <= MAX_N_PAD:
        raise ValueError(f"n_pad={n_pad} must be a multiple of 8 in "
                         f"[8, {MAX_N_PAD}]")
    if factors is None:
        if not 3 <= n <= n_pad:
            raise ValueError(f"n={n} must lie in [3, n_pad={n_pad}]")
    else:
        fx0, fcols = factors
        nf = fx0.shape[0] if fx0.dim() == 1 else -1
        if not 3 <= n <= MAX_N_PAD:
            raise ValueError(f"n={n} must lie in [3, {MAX_N_PAD}]")
        if nf < 0 or nf >= n or tuple(fcols.shape) != (n - 1, nf):
            raise ValueError(f"fx0 must be (nf,) with nf < n and fcols "
                             f"({n - 1}, nf), got {tuple(fx0.shape)} and "
                             f"{tuple(fcols.shape)}")
        if n_pad + nf > n + 7:
            raise ValueError(f"n_pad={n_pad} alive and {nf} factored rows "
                             f"are more than n={n} has")
    if tuple(cols.shape) != (n - 1, n_pad):
        raise ValueError(f"cols must be ({n - 1}, {n_pad}), got "
                         f"{tuple(cols.shape)}")
    if not 1 <= r <= n - 2:
        raise ValueError(f"r={r} must lie in [1, n-2={n - 2}]")


def ryser_partials(ids: torch.Tensor, x0: torch.Tensor, cols: torch.Tensor,
                   *, n: int, r: int, tier: str = "df64") -> torch.Tensor:
    """Per-chunk signed partial sums of the Gray walk.

    ids:  (C,) int64 chunk ids in [0, 2^(n-1-r)); ids < 0 are sentinels
          whose partial is 0.
    x0:   (n_pad,) float64 initial x, padding rows 1 (gray.pack_matrix).
    cols: (n-1, n_pad) float64 matrix columns, padding 0.
    tier: "df64", "f32", "f32k" or "tf96".  The f32 tiers round x0 and
          cols to float32 (the hi word of the reference's f32 pair) and
          walk those.  tf96 is as exact as its products only where every
          x update is: on values exact in float32 (the engines see to it).
    Returns (C, 2), float64 for df64 and tf96 and float32 otherwise: hi
    and lo of each chunk's partial sum (lo is 0 in the f32 tier; in tf96
    the pair is a double-double, to be summed wider than float64).

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs the plain version.
    """
    _check(ids, x0, cols, n, r)
    dtype, tier_no = _tier(tier)
    if not on_card(ids):
        return ryser_partials_ref(ids, x0, cols, n=n, r=r, tier=tier)
    out = torch.empty((ids.shape[0], 2), dtype=dtype, device=ids.device)
    if ids.shape[0]:
        call("ryser_walk", ids, ids.shape[0], x0.to(dtype), cols.to(dtype),
             n, x0.shape[0], r, tier_no, out, device=ids.device,
             count=("walk", tier))
    return out


def _tree_fold(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce the last dim with `op` in the kernel's order: fold the upper
    half onto the lower (p[i] = op(p[i], p[i + ceil(s/2)])) until one is
    left."""
    s = x.shape[-1]
    while s > 1:
        ns, h = (s + 1) // 2, s // 2
        p = op(x[..., :h], x[..., ns:s])
        x = p if h == ns else torch.cat([p, x[..., h:ns]], dim=-1)
        s = ns
    return x[..., 0]


def tree_prod(x: torch.Tensor) -> torch.Tensor:
    """Product over the last dim in the kernel's fold order."""
    return _tree_fold(x, torch.mul)


def acc_add(hi, lo, t, tier: str):
    """(hi, lo) += t with the tier's accumulator (csrc/walk.cuh acc_add;
    a tf96 term is a (hi, lo) pair and goes through acc_merge)."""
    if tier == "tf96":
        return acc_merge(hi, lo, t[0], t[1], tier)
    if tier == "f32":
        return hi + t, lo
    if tier == "f32k":
        s, e = two_sum(hi, t)
        return s, lo + e
    return df_add_f64(hi, lo, t)


def acc_merge(hi, lo, bhi, blo, tier: str):
    """(hi, lo) += (bhi, blo) with the tier's compensated add, as the
    batch kernel's block reduction merges two partial sums.  For df64 and
    tf96 it is the double-double sum (tf96.dd_add); tf96 adds every term
    with it too."""
    if tier == "f32":
        return hi + bhi, lo
    s, e = two_sum(hi, bhi)
    if tier == "f32k":
        return s, lo + blo + e
    return quick_two_sum(s, e + (lo + blo))


def _term(x, negate, tier: str):
    """The signed Ryser term +-prod(x) over the last dim in the tier's
    product: a tensor, or for tf96 a (hi, lo) pair of them."""
    if tier == "tf96":
        thi, tlo = tree_prod_dd(x)
        return (-thi, -tlo) if negate else (thi, tlo)
    t = tree_prod(x)
    return -t if negate else t


def _ctz(i: int) -> int:
    return (i & -i).bit_length() - 1


def step_rule(r: int, g: int = GROUP_LOG2):
    """The walk kernel's step rule (csrc/walk.cuh walk_chunk): yields
    (m, k, s) for m = 1 .. 2^r - 1, the column k = ctz(m) that step m adds
    and its x-sign s, +1 or -1, or 0 at the mid step, whose sign is the
    chunk parity.

    The steps go in aligned groups of 2^g.  Step m0 + i of the group at
    m0 = j * 2^g (0 < i < 2^g) takes k = ctz(i) and, but at k = g - 1,
    the sign of bit k+1 of i: constants of the kernel's unrolled group.
    At k = g - 1 the sign is that of bit 0 of j (at r == g, where the one
    group holds the mid step, the parity).  Only step m0 itself (j > 0)
    takes k = g + ctz(j), with the sign of bit ctz(j)+1 of j, or the
    parity where k = r - 1.  Below r = g the kernel steps one by one:
    k = ctz(m), the sign of bit k+1 of m, the parity at k = r - 1; so do
    the double tiers from N_PAD 48 (walk.cuh grouped_walk), on the same
    steps."""
    if r < g:
        for m in range(1, 1 << r):
            k = _ctz(m)
            yield m, k, 0 if k == r - 1 else 1 - 2 * ((m >> (k + 1)) & 1)
        return
    for j in range(1 << (r - g)):
        m0 = j << g
        if j:
            kj = _ctz(j)
            yield m0, kj + g, (0 if kj + g == r - 1
                               else 1 - 2 * ((j >> (kj + 1)) & 1))
        top = 0 if r == g else 1 - 2 * (j & 1)
        for i in range(1, 1 << g):
            k = _ctz(i)
            yield m0 + i, k, (top if k == g - 1
                              else 1 - 2 * ((i >> (k + 1)) & 1))


def _walk_steps(x, sign_mid, cols, r: int):
    """The kernel's steps: yields (m, x) for m = 1 .. 2^r - 1, x after
    adding +-column k by step_rule.  x (..., C, n_pad) and sign_mid (C,)
    from gray.chunk_init, cols (..., n-1, n_pad) with one table per
    leading index of x."""
    for m, k, s in step_rule(r):
        x = x + (sign_mid[:, None] if s == 0 else float(s)) \
            * cols[..., k, None, :]
        yield m, x


def _walk_ref(x, sign_mid, cols, r: int, tier: str):
    """The walk body of the plain versions: one Python step per Gray index
    m, the kernel's step rule and accumulator.  Returns (hi, lo), each
    (..., C)."""
    if tier == "tf96":
        hi, lo = _term(x, False, tier)
    else:
        hi = _term(x, False, tier)
        lo = torch.zeros_like(hi)
    for m, x in _walk_steps(x, sign_mid, cols, r):
        hi, lo = acc_add(hi, lo, _term(x, m & 1, tier), tier)
    return hi, lo


def ryser_partials_ref(ids: torch.Tensor, x0: torch.Tensor,
                       cols: torch.Tensor, *, n: int, r: int,
                       tier: str = "df64") -> torch.Tensor:
    """Plain PyTorch version of the chunk kernel: vectorised over chunks,
    the tier's dtype, fold order and accumulator."""
    dtype = _tier(tier)[0]
    x0, cols = x0.to(dtype), cols.to(dtype)
    x, sign_mid = gray.chunk_init(ids, x0, cols, n, r)
    hi, lo = _walk_ref(x, sign_mid, cols, r, tier)
    out = torch.stack([hi, lo], dim=1)
    return torch.where((ids < 0)[:, None], 0.0, out)


def _pad_to_block(ids: torch.Tensor) -> torch.Tensor:
    """ids padded with -1 sentinels to a multiple of BLOCK."""
    pad = -ids.shape[0] % BLOCK
    if not pad:
        return ids
    return torch.cat([ids, ids.new_full((pad,), -1)])


def ryser_reduced(ids: torch.Tensor, x0: torch.Tensor, cols: torch.Tensor,
                  fx0: torch.Tensor, fcols: torch.Tensor, *, n: int, r: int,
                  tier: str = "df64") -> torch.Tensor:
    """Weighted, block-reduced partial sums of a factored Gray walk: the
    sparse engine's walk.

    ids:   (C,) int64 live chunk ids; ids < 0 are sentinels and count 0.
           The list is padded here with sentinels to a multiple of 128.
    x0:    (n_pad,) float64 and cols (n-1, n_pad): the pack of the ALIVE
           rows of an order-n matrix (gray.pack_matrix of those rows), so
           n_pad may be below n and a step multiplies fewer rows.
    fx0:   (nf,) float64 and fcols (n-1, nf): the pack of the factored
           rows, without padding; nf = 0 walks unweighted.
    Each chunk's partial (in `tier`, as ryser_partials) is widened to a
    double-double, multiplied by the chunk's weight
    (gray.factor_weights), and each block of 128 chunks is added up in
    the batch kernel's halving order with the double-double sum.
    Returns (ceil(C / 128), 2) float64: the blocks' (hi, lo) pairs; the
    walk's total is the float64 sum of hi + lo (tf96: tf96.sum_words).

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs the plain version.
    """
    _check(ids, x0, cols, n, r, factors=(fx0, fcols))
    dtype, tier_no = _tier(tier)
    ids = _pad_to_block(ids)
    if not on_card(ids):
        return ryser_reduced_ref(ids, x0, cols, fx0, fcols, n=n, r=r,
                                 tier=tier)
    out = torch.empty((ids.shape[0] // BLOCK, 2), dtype=torch.float64,
                      device=ids.device)
    if ids.shape[0]:
        call("ryser_walk_reduced", ids, ids.shape[0], x0.to(dtype),
             cols.to(dtype), fx0, fcols, fx0.shape[0], n, x0.shape[0], r,
             tier_no, out, device=ids.device, count=("reduced", tier))
    return out


def block_ids(rows: torch.Tensor, lanes: int, num_chunks: int
              ) -> torch.Tensor:
    """The chunk ids ryser_blocks walks for block rows `rows`: row q holds
    ids q * lanes .. q * lanes + lanes - 1, padded with -1 to whole blocks
    of BLOCK lanes, and an id outside [0, num_chunks) is -1 too.  rows:
    1-D int64.  Returns (len(rows) * ceil(lanes / BLOCK) * BLOCK,) int64 on
    the device of rows, row by row."""
    lane = torch.arange(-(-lanes // BLOCK) * BLOCK, device=rows.device)
    ids = rows[:, None] * lanes + lane
    live = (lane < lanes) & (ids >= 0) & (ids < num_chunks)
    return torch.where(live, ids, -1).reshape(-1)


def ryser_blocks(rows: torch.Tensor, x0: torch.Tensor, cols: torch.Tensor,
                 *, n: int, r: int, lanes: int, num_chunks: int,
                 tier: str = "df64") -> torch.Tensor:
    """Block-reduced partial sums of the dense Gray walk: the dense
    engine's total, with neither the chunk ids nor the per-chunk partials
    crossing between host and card.

    rows:  (R,) int64 block rows of the plan's (B, lanes) layout
           (sharding.pad_ids of every chunk id); the kernel derives each
           chunk id from its row and lane (block_ids).
    x0, cols: as in ryser_partials.
    tier:  "df64", "f32" or "f32k" (tf96 keeps its per-chunk words).
    Each chunk's partial, walked as ryser_partials walks it, is widened to
    a double-double and each block of 128 lanes is added up in the batch
    kernel's halving order with the double-double sum: ryser_reduced,
    unweighted, on the ids of block_ids.
    Returns (R * ceil(lanes / 128), 2) float64, row by row: the blocks'
    (hi, lo) pairs; the walk's total is the float64 sum of hi + lo.

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs the plain version.
    """
    _check(rows, x0, cols, n, r)
    if tier not in BLOCK_TIERS:
        raise ValueError(f"ryser_blocks has no tier {tier!r} (one of "
                         f"{sorted(BLOCK_TIERS)})")
    if lanes < 1:
        raise ValueError(f"lanes={lanes} must be at least 1")
    if not on_card(rows):
        return ryser_blocks_ref(rows, x0, cols, n=n, r=r, lanes=lanes,
                                num_chunks=num_chunks, tier=tier)
    dtype, tier_no = TIERS[tier]
    out = torch.empty((rows.shape[0] * -(-lanes // BLOCK), 2),
                      dtype=torch.float64, device=rows.device)
    if rows.shape[0]:
        call("ryser_walk_blocks", rows, rows.shape[0], num_chunks, lanes,
             x0.to(dtype), cols.to(dtype), n, x0.shape[0], r, tier_no, out,
             device=rows.device, count=("blocks", tier))
    return out


def ryser_blocks_ref(rows: torch.Tensor, x0: torch.Tensor,
                     cols: torch.Tensor, *, n: int, r: int, lanes: int,
                     num_chunks: int, tier: str = "df64") -> torch.Tensor:
    """Plain PyTorch version of ryser_blocks: ryser_reduced_ref with no
    factored row on the ids the kernel derives."""
    return ryser_reduced_ref(block_ids(rows, lanes, num_chunks), x0, cols,
                             x0.new_empty(0), x0.new_empty((n - 1, 0)),
                             n=n, r=r, tier=tier)


def ryser_weighted_ref(ids: torch.Tensor, x0: torch.Tensor,
                       cols: torch.Tensor, fx0: torch.Tensor,
                       fcols: torch.Tensor, *, n: int, r: int,
                       tier: str = "df64") -> torch.Tensor:
    """The factored walk before its block reduction: (C, 2) float64, each
    chunk's weighted partial as a double-double, 0 for a sentinel.  Plain
    PyTorch, the kernel's operations in its order: the tier's walk, the
    f32 tiers' pair widened to one double (hi + lo), then a dd_mul by the
    chunk's weight unless there is no factored row."""
    dtype = _tier(tier)[0]
    x0_t, cols_t = x0.to(dtype), cols.to(dtype)
    x, sign_mid = gray.chunk_init(ids, x0_t, cols_t, n, r)
    hi, lo = _walk_ref(x, sign_mid, cols_t, r, tier)
    if dtype == torch.float32:
        hi = hi.double() + lo.double()
        lo = torch.zeros_like(hi)
    if fx0.shape[0]:
        hi, lo = dd_mul(hi, lo, *gray.factor_weights(ids, fx0, fcols, n, r))
    out = torch.stack([hi, lo], dim=1)
    return torch.where((ids < 0)[:, None], 0.0, out)


def ryser_reduced_ref(ids: torch.Tensor, x0: torch.Tensor,
                      cols: torch.Tensor, fx0: torch.Tensor,
                      fcols: torch.Tensor, *, n: int, r: int,
                      tier: str = "df64") -> torch.Tensor:
    """Plain PyTorch version of the reduced kernel: ryser_weighted_ref on
    the padded id list, then each block of 128 in the kernel's halving
    order with the double-double sum."""
    out = ryser_weighted_ref(_pad_to_block(ids), x0, cols, fx0, fcols, n=n,
                             r=r, tier=tier)
    return block_reduce_ref(out[None, :, 0], out[None, :, 1], "df64")[0]


def ryser_amp(ids: torch.Tensor, x0: torch.Tensor, cols: torch.Tensor, *,
              n: int, r: int, cond: bool = True) -> torch.Tensor:
    """Per-chunk amplitude sums of the Gray walk, the amp tier: every term
    without its sign.

    ids, x0, cols as in ryser_partials; x walks in float64.
    Returns (C, 2) float64, [amp hi, amp lo], where amp = sum over the
    chunk's steps of prod_i |x_i|; with cond, (C, 4): [amp hi, amp lo,
    cond hi, cond lo], where cond = sum of sum_{i < n} prod_{j != i}
    max(|x_j|, eps), eps = AMP_EPS.  hi is a TwoSum-compensated sum and
    lo its compensation, so a chunk's value is hi + lo.  Sentinels give 0.

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs the plain version.
    """
    _check(ids, x0, cols, n, r)
    if not on_card(ids):
        return ryser_amp_ref(ids, x0, cols, n=n, r=r, cond=cond)
    out = torch.empty((ids.shape[0], 4 if cond else 2), dtype=torch.float64,
                      device=ids.device)
    if ids.shape[0]:
        call("ryser_walk", ids, ids.shape[0], x0, cols, n, x0.shape[0], r,
             AMP_TIERS[cond], out, device=ids.device,
             count=("amp_cond" if cond else "amp", None))
    return out


def cond_fold(x: torch.Tensor, n: int) -> torch.Tensor:
    """sum_{i < n} prod_{j != i} max(|x_j|, AMP_EPS) over the last dim
    (csrc/walk.cuh cond_fold): a fold of (P, C) pairs in tree_prod's
    order, leaves (pc_i, 1) for the n real rows and (pc_i, 0) for the
    padding, pairs combined as (P1 P2, C1 P2 + C2 P1).  The last dim must
    be even."""
    pc = x.abs().clamp(min=AMP_EPS)
    s = pc.shape[-1]
    if s % 2:
        raise ValueError(f"the last dim must be even, got {s}")
    real = (torch.arange(s, device=x.device) < n).to(pc.dtype)
    s //= 2
    p = pc[..., :s] * pc[..., s:]
    c = real[:s] * pc[..., s:] + real[s:] * pc[..., :s]
    while s > 1:
        ns, h = (s + 1) // 2, s // 2
        p1, p2, c1, c2 = p[..., :h], p[..., ns:s], c[..., :h], c[..., ns:s]
        pn, cn = p1 * p2, c1 * p2 + c2 * p1
        if h != ns:                     # odd level: the middle one waits
            pn = torch.cat([pn, p[..., h:ns]], dim=-1)
            cn = torch.cat([cn, c[..., h:ns]], dim=-1)
        p, c, s = pn, cn, ns
    return c[..., 0]


def amp_terms(x: torch.Tensor, n: int, cond: bool = True) -> list:
    """One step's terms (csrc/walk.cuh amp_terms): [prod |x|] in
    tree_prod's order, and with cond the conditioned term cond_fold."""
    amp = tree_prod(x.abs())
    return [amp, cond_fold(x, n)] if cond else [amp]


def ryser_amp_ref(ids: torch.Tensor, x0: torch.Tensor, cols: torch.Tensor,
                  *, n: int, r: int, cond: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the amp kernel: the walk's steps, each
    step's terms added into TwoSum accumulators (hi the sum, lo the
    running compensation)."""
    x, sign_mid = gray.chunk_init(ids, x0, cols, n, r)
    acc = [(t, torch.zeros_like(t)) for t in amp_terms(x, n, cond)]
    for _, x in _walk_steps(x, sign_mid, cols, r):
        for k, t in enumerate(amp_terms(x, n, cond)):
            hi, e = two_sum(acc[k][0], t)
            acc[k] = (hi, acc[k][1] + e)
    out = torch.stack([w for pair in acc for w in pair], dim=1)
    return torch.where((ids < 0)[:, None], 0.0, out)


def _check_batch(x0s, colss, n: int, r: int) -> None:
    for name, t in (("x0s", x0s), ("colss", colss)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be torch.float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if colss.device != x0s.device:
        raise ValueError(f"colss is on {colss.device}, x0s on {x0s.device}")
    if x0s.dim() != 2:
        raise ValueError("x0s must be (B, n_pad)")
    batch, n_pad = x0s.shape
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a launch takes 1..{MAX_BATCH} matrices, got "
                         f"{batch}")
    if n_pad not in BATCH_N_PADS:
        raise ValueError(f"n_pad={n_pad} must be one of {BATCH_N_PADS}")
    if not n_pad - 8 < n <= n_pad or n < 9:
        raise ValueError(f"n={n} does not pad to n_pad={n_pad}")
    if tuple(colss.shape) != (batch, n - 1, n_pad):
        raise ValueError(f"colss must be ({batch}, {n - 1}, {n_pad}), got "
                         f"{tuple(colss.shape)}")
    if not 1 <= r <= n - 8:
        raise ValueError(f"r={r} must lie in [1, n-8={n - 8}]: a matrix "
                         f"needs at least one full block of {BLOCK} chunks")


def batch_partials(x0s: torch.Tensor, colss: torch.Tensor, *, n: int, r: int,
                   tier: str = "df64") -> torch.Tensor:
    """Per-block partial sums of the whole Gray walk of each matrix of a
    stack.

    x0s:   (B, n_pad) float64, one gray.pack_matrix x0 per matrix.
    colss: (B, n-1, n_pad) float64, one column table per matrix.
    Matrix b has 2^(n-1-r) chunks of 2^r steps, in blocks of 128.
    Returns (B, 2^(n-1-r) / 128, 2), float64 for df64 and tf96 and
    float32 otherwise: hi and lo of each block's sum, reduced in the
    kernel's fixed halving order.  Matrix b's scaled total is the float64
    sum of hi + lo over its blocks (tf96: of all the words, summed wider,
    tf96.sum_words).

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs the plain version.
    """
    _check_batch(x0s, colss, n, r)
    dtype, tier_no = _tier(tier)
    if not on_card(x0s):
        return batch_partials_ref(x0s, colss, n=n, r=r, tier=tier)
    batch, n_pad = x0s.shape
    out = torch.empty((batch, (1 << (n - 1 - r)) // BLOCK, 2), dtype=dtype,
                      device=x0s.device)
    call("ryser_batch", x0s.to(dtype), colss.to(dtype), batch, n, n_pad, r,
         tier_no, out, device=x0s.device, count=("batch", tier))
    return out


def batch_chunk_partials_ref(x0s: torch.Tensor, colss: torch.Tensor, *,
                             n: int, r: int, tier: str = "df64"):
    """The batch walk before its block reduction: (hi, lo), each
    (B, 2^(n-1-r)), equal bit for bit to ryser_partials_ref of matrix b
    on all its chunk ids at the same r."""
    dtype = _tier(tier)[0]
    x0s, colss = x0s.to(dtype), colss.to(dtype)
    ids = torch.arange(1 << (n - 1 - r), dtype=torch.int64,
                       device=x0s.device)
    x, sign_mid = gray.chunk_init(ids, x0s, colss, n, r)
    return _walk_ref(x, sign_mid, colss, r, tier)


def block_reduce_ref(hi: torch.Tensor, lo: torch.Tensor, tier: str):
    """(B, C) per-chunk pairs -> (B, C / 128, 2) per-block pairs in the
    batch kernel's order: thread t takes thread t + 64, then t + 32, ..."""
    batch = hi.shape[0]
    hi = hi.reshape(batch, -1, BLOCK)
    lo = lo.reshape(batch, -1, BLOCK)
    s = BLOCK // 2
    while s >= 1:
        hi, lo = acc_merge(hi[..., :s], lo[..., :s], hi[..., s:2 * s],
                           lo[..., s:2 * s], tier)
        s //= 2
    return torch.stack([hi[..., 0], lo[..., 0]], dim=-1)


def batch_partials_ref(x0s: torch.Tensor, colss: torch.Tensor, *, n: int,
                       r: int, tier: str = "df64") -> torch.Tensor:
    """Plain PyTorch version of the batch kernel: vectorised over
    matrices and chunks, one Python step per Gray index, then the block
    reduction in the kernel's order."""
    hi, lo = batch_chunk_partials_ref(x0s, colss, n=n, r=r, tier=tier)
    return block_reduce_ref(hi, lo, tier)
