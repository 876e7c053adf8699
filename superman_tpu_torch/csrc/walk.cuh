// The Gray-code Ryser walk of one aligned chunk, for Hopper (sm_90a):
// the body shared by the chunk kernel (ryser_walk.cu) and the serving-batch
// kernel (ryser_batch.cu).
//
// Replaces the walk bodies of superman_tpu/ops/ryser_pallas.py
// (_walk_scalar / _walk_u16) for the tiers df64, f32, f32k, tf96 (the
// arithmetic of superman_tpu/ops/tf96.py with them) and amp (_amp_terms),
// folds in their XLA prologue (superman_tpu/ops/gray.py chunk_init), and
// carries the epilogues: the sparse walk's per-chunk weight (gray.py
// factor_weights, ryser_pallas.py _weight_out8) and the block sum of the
// block-reduced walks (_merge_out8).
//
// What it computes: the Nijenhuis-Wilf Gray-code Ryser sum is cut into
// aligned chunks of 2^r steps.  A thread walks chunk l: it builds x from
// the chunk's Gray bits, then at step m = 1 .. 2^r-1 adds +-column
// k = ctz(m) to x and accumulates (-1)^m * prod(x) into a (hi, lo) pair.
//
// Tiers (the template parameter TIER):
//   kDf64  x and the products IEEE double; the accumulator a compensated
//          double-double (TwoSum, then a renormalising FastTwoSum);
//   kF32   x, the column table and the products float; acc += +-t;
//   kF32k  as kF32 with a TwoSum accumulator: hi, e = two_sum(hi, +-t),
//          lo += e; word 0 is the sum, word 1 the compensation;
//   kTf96  x and the column table IEEE double, holding values that are
//          exact in float32, so every x update is one exact add; each
//          product a double-double (two doubles, ~104 bits): the first
//          level of the tree is an exact TwoProd by FMA, the rest
//          double-double multiplies that skip the renormalisation, which
//          is done once at the root; the accumulator a double-double sum
//          (acc_merge).  The TPU carried this tier as float32 triples (~72
//          bits); the card has native double and FMA, so two doubles do
//          better with less.
//   kAmp   the diagnostic walk of calc="auto" (walk_chunk_amp): signs are
//          dropped and the amplitude |prod x| is summed in a TwoSum
//          accumulator, x and the products IEEE double;
//   kAmpCond  kAmp plus a second sum, the conditioned term
//          sum_{i<n} prod_{j != i} max(|x_j|, eps), folded without a
//          division (cond_fold).
//
// What bounds it on this card, read from the step loop's SASS at N_PAD = 32
// (tools/sass_count.py): the float tiers by issue slots -- a warp-step
// issues 64 (f32) or 70 (f32k) FP32 instructions and ~5 others, and an SM
// partition, with 32 FP32 lanes, issues one instruction a clock; df64 and
// tf96 by the FP64 pipe -- 73 (tf96: 168) FP64 instructions a step, each
// two clocks of a partition's 16 FP64 lanes, with the ~6 (12) others
// issuing between them.  There is no device-memory traffic inside the loop.
// The design keeps it so: x lives in registers (N_PAD is a template
// parameter, so every row loop unrolls); the column table sits in shared
// memory, where all threads of a warp read the same column -- a broadcast,
// with no bank conflicts -- in 16-byte words; and the steps go in groups
// whose columns, signs and table offsets are constants (walk_chunk), so a
// step issues almost nothing but its arithmetic.
//
// Build without fast-math and with nvcc's default -ftz=false, so denormal
// float products round as the plain version's do.  nvcc contracts a
// multiply and an add into an FMA by default (-fmad=true), which the plain
// PyTorch versions cannot repeat, so no rounding may depend on it.  In the
// df64, f32 and f32k tiers it cannot: the sums are add-only; the tree's
// multiplies are intrinsics (mul_rn), because where a term's sign is a
// constant, as in the grouped steps, nvcc would otherwise fuse the tree's
// last multiply into the accumulator's first add; and the one product it
// may contract, s * col with s = +-1, is exact.  The tf96 tier does mix
// multiplies and adds (dd_mul), so every operation of two_prod and dd_mul
// is an intrinsic (__dmul_rn, __dadd_rn, __fma_rn), which the compiler
// never fuses or splits: the only FMA is the one that TwoProd asks for,
// and its result is exact.  The amp tier and the chunk weight are written
// with the same intrinsics wherever a multiply feeds an add.

#pragma once

#include <cuda_runtime.h>

namespace walk {

constexpr int kThreads = 128;

enum Tier { kDf64 = 0, kF32 = 1, kF32k = 2, kTf96 = 3, kAmp = 4,
            kAmpCond = 5 };

template <int TIER> struct Real { using type = float; };
template <> struct Real<kDf64> { using type = double; };
template <> struct Real<kTf96> { using type = double; };
template <> struct Real<kAmp> { using type = double; };
template <> struct Real<kAmpCond> { using type = double; };

// a * b rounded, never contracted into an add that follows.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// p[0] = product of p[0..S): fold the upper half onto the lower half,
// p[i] *= p[i + ceil(S/2)], until one element is left.  The plain version
// (ops/ryser_cuda.py tree_prod) multiplies in the same order.
template <int S, int N, typename T>
__device__ __forceinline__ void fold_prod(T (&p)[N]) {
  if constexpr (S > 1) {
    constexpr int NS = (S + 1) / 2;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) p[i] = mul_rn(p[i], p[i + NS]);
    fold_prod<NS, N, T>(p);
  }
}

template <int N_PAD, typename T>
__device__ __forceinline__ T tree_prod(const T (&x)[N_PAD]) {
  T p[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) p[i] = x[i];
  fold_prod<N_PAD, N_PAD, T>(p);
  return p[0];
}

// A double-double: the value hi + lo, |lo| <= ulp(hi) / 2.
struct dd {
  double hi, lo;
};

// a * b = p + e exactly: the FMA returns the product's rounding error,
// which is a double unless it underflows (|p| > 2^-960 is enough; the
// engines scale so that |x| <~ 1).  The plain version (ops/tf96.py
// two_prod) gets the same e from a Veltkamp split and Dekker's sum.
__device__ __forceinline__ dd two_prod(double a, double b) {
  const double p = __dmul_rn(a, b);
  return {p, __fma_rn(a, b, -p)};
}

// Dekker's FastTwoSum, |a| >= |b|: a + b = hi + lo exactly, |lo| <=
// ulp(hi) / 2.
__device__ __forceinline__ dd fast_two_sum(double a, double b) {
  const double hi = __dadd_rn(a, b);
  return {hi, __dsub_rn(b, __dsub_rn(hi, a))};
}

// a * b for double-doubles, left un-normalised: the exact product of the
// high words (hi, its error), the two cross terms rounded and added to
// the error, a.lo * b.lo dropped.  Relative error a few 2^-106 whether or
// not a and b are normalised: the next TwoProd takes the high words
// exactly, and the cross terms carry a low word of a few ulp(hi) as well
// as one of half an ulp.  ops/tf96.py dd_mul_unnorm repeats it.
__device__ __forceinline__ dd dd_mul_unnorm(dd a, dd b) {
  const dd p = two_prod(a.hi, b.hi);
  const double cross =
      __dadd_rn(__dmul_rn(a.hi, b.lo), __dmul_rn(a.lo, b.hi));
  return {p.hi, __dadd_rn(p.lo, cross)};
}

// a * b for double-doubles, normalised: dd_mul_unnorm, then a FastTwoSum.
// ops/tf96.py dd_mul repeats it operation by operation.
__device__ __forceinline__ dd dd_mul(dd a, dd b) {
  const dd p = dd_mul_unnorm(a, b);
  return fast_two_sum(p.hi, p.lo);
}

// p[0] = product of p[0..S) in fold_prod's order, on double-doubles,
// un-normalised.
template <int S, int N>
__device__ __forceinline__ void fold_prod_dd(dd (&p)[N]) {
  if constexpr (S > 1) {
    constexpr int NS = (S + 1) / 2;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) p[i] = dd_mul_unnorm(p[i], p[i + NS]);
    fold_prod_dd<NS, N>(p);
  }
}

// The tf96 tier's product of x[0..N_PAD): fold_prod's order, the first
// level (x[i] * x[i + N_PAD/2], plain doubles) exact by TwoProd, the rest
// un-normalised (6 operations a multiply where a normalised one takes 9),
// and one FastTwoSum at the root, so the accumulator sees a normalised
// pair.
template <int N_PAD>
__device__ __forceinline__ dd tree_prod_dd(const double (&x)[N_PAD]) {
  static_assert(N_PAD % 2 == 0, "the first fold pairs all of x");
  constexpr int H = N_PAD / 2;
  dd p[H];
#pragma unroll
  for (int i = 0; i < H; ++i) p[i] = two_prod(x[i], x[i + H]);
  fold_prod_dd<H, H>(p);
  return fast_two_sum(p[0].hi, p[0].lo);
}

// Knuth TwoSum: a + b = s + e exactly.
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T z = s - a;
  e = (a - (s - z)) + (b - z);
}

// (hi, lo) += t with the tier's accumulator.  kDf64 is the reference's
// df_add with a zero low word on t.
template <int TIER, typename T>
__device__ __forceinline__ void acc_add(T& hi, T& lo, T t) {
  if constexpr (TIER == kF32) {
    hi += t;
  } else if constexpr (TIER == kF32k) {
    T s, e;
    two_sum(hi, t, s, e);
    hi = s;
    lo += e;
  } else {
    T s, e;
    two_sum(hi, t, s, e);
    e += lo;
    hi = s + e;
    lo = e - (hi - s);
  }
}

// (hi, lo) += (bhi, blo): two partial sums merged with the tier's
// compensated add, the counterpart of the reference's _merge_out8.  For
// kDf64 and kTf96 it is a double-double sum (TwoSum of the high words, the
// low words folded in, a FastTwoSum), absolute error ~2^-105 of the larger
// operand; kTf96 also adds every term with it (the reference's tf_add).
template <int TIER, typename T>
__device__ __forceinline__ void acc_merge(T& hi, T& lo, T bhi, T blo) {
  if constexpr (TIER == kF32) {
    hi += bhi;
  } else if constexpr (TIER == kF32k) {
    T s, e;
    two_sum(hi, bhi, s, e);
    hi = s;
    lo = lo + blo + e;
  } else {
    T s, e;
    two_sum(hi, bhi, s, e);
    e += lo + blo;
    hi = s + e;
    lo = e - (hi - s);
  }
}

// Bit b of gray(l * 2^r), the Gray code of chunk l's base index, with
// gl = l ^ (l >> 1): bit b >= r is gl >> (b - r), bit r-1 is l & 1, the
// lower bits are 0.
__device__ __forceinline__ unsigned long long base_gray_bit(
    unsigned long long ul, unsigned long long gl, int b, int r) {
  return b >= r ? (gl >> (b - r)) & 1ull : (b == r - 1 ? ul & 1ull : 0ull);
}

// The prologue (gray.chunk_init): x = x0 + the columns whose bit is set in
// gray(l * 2^r), added in column order.
template <int N_PAD, typename T>
__device__ __forceinline__ void chunk_x(unsigned long long ul,
                                        const T* __restrict__ x0,
                                        const T* col_s, int ncol, int r,
                                        T (&x)[N_PAD]) {
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) x[i] = x0[i];
  const unsigned long long gl = ul ^ (ul >> 1);
  for (int b = 0; b < ncol; ++b) {
    if (base_gray_bit(ul, gl, b, r)) {
      const T* ck = col_s + b * N_PAD;
#pragma unroll
      for (int i = 0; i < N_PAD; ++i) x[i] += ck[i];
    }
  }
}

// Step m of a chunk: x += s * column k, k = ctz(m).  The x-sign s is +1 iff
// bit k+1 of m is 0; at the mid step (k == r-1) it is the chunk parity
// smid instead.
template <int N_PAD, typename T>
__device__ __forceinline__ void step_x(unsigned long long m, int r, T smid,
                                       const T* col_s, T (&x)[N_PAD]) {
  const int k = __ffsll((long long)m) - 1;
  T s = ((m >> (k + 1)) & 1ull) ? T(-1) : T(1);
  if (k == r - 1) s = smid;
  const T* ck = col_s + k * N_PAD;
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) x[i] += s * ck[i];
}

// ---- the grouped walk of walk_chunk
//
// A chunk's steps m = 1 .. 2^r-1 are walked in aligned groups of 2^G,
// G = kGroupLog2.  Step m0 + i of the group at m0 = j * 2^G, 0 < i < 2^G,
// has k = ctz(m0 + i) = ctz(i), a constant; its x-sign, bit k+1 of m, is
// bit k+1 of i, a constant too, except at k = G-1, where it is bit 0 of j
// (one runtime sign a group; at r == G, where the one group holds the mid
// step, the chunk parity smid); its term sign (-1)^m is (-1)^i.  Only the
// step m0 itself (j > 0) takes ctz(j) + G at run time, with the mid-step
// rule.  So a loop trip issues 2^G steps of arithmetic, 2^G - 1 of them
// with no index logic, and reads each column of the table in 16-byte words
// at a constant offset.  Chunks of r < G steps, and the walks where
// grouped_walk says so, keep the step-by-step loop; both walk the same
// steps in the same order.  ops/ryser_cuda.py step_rule states the
// grouped rule for the plain versions.
constexpr int kGroupLog2 = 3;

__host__ __device__ constexpr int ctz_const(int i) {
  return (i & 1) ? 0 : 1 + ctz_const(i >> 1);
}

// x += s * col[0 .. N_PAD): the column read as float4 or double2 (the table
// is 16-byte aligned and a column is N_PAD * sizeof(T) bytes, N_PAD a
// multiple of 8).  With s a constant +-1 this is one add a row; s * c is
// exact either way, so nothing rounds otherwise than in step_x.
template <int N_PAD, typename T>
__device__ __forceinline__ void add_col(const T* col, T s, T (&x)[N_PAD]) {
  if constexpr (sizeof(T) == 4) {
    const float4* c = reinterpret_cast<const float4*>(col);
#pragma unroll
    for (int q = 0; q < N_PAD / 4; ++q) {
      const float4 v = c[q];
      x[4 * q] += s * v.x;
      x[4 * q + 1] += s * v.y;
      x[4 * q + 2] += s * v.z;
      x[4 * q + 3] += s * v.w;
    }
  } else {
    const double2* c = reinterpret_cast<const double2*>(col);
#pragma unroll
    for (int q = 0; q < N_PAD / 2; ++q) {
      const double2 v = c[q];
      x[2 * q] += s * v.x;
      x[2 * q + 1] += s * v.y;
    }
  }
}

// (hi, lo) += +-prod(x), minus where neg: the tier's product and
// accumulator.
template <int N_PAD, int TIER, typename T>
__device__ __forceinline__ void add_term(const T (&x)[N_PAD], bool neg,
                                         T& hi, T& lo) {
  if constexpr (TIER == kTf96) {
    const dd t = tree_prod_dd<N_PAD>(x);
    if (neg)
      acc_merge<TIER, T>(hi, lo, -t.hi, -t.lo);
    else
      acc_merge<TIER, T>(hi, lo, t.hi, t.lo);
  } else {
    const T t = tree_prod<N_PAD, T>(x);
    acc_add<TIER, T>(hi, lo, neg ? -t : t);
  }
}

// Whether walk_chunk walks in groups.  The 8-step body holds x and the
// group's state in registers; grouped, the double tiers spill from N_PAD 40
// (ptxas: 120 bytes a thread in df64 at 40, ~2.5 KB at 64), yet up to 40
// they are still faster grouped, and from 48 the spills cost more than the grouping
// saves (the reduced entry's df64 walk 42% slower at 48, 2.4-3.5x at 56
// and 64 on an NVIDIA H100 80GB HBM3 at 700 W), so there they step one at
// a time.  The float tiers do not spill up to N_PAD 64 and stay grouped.
// PERF.md has the A-B.
template <int N_PAD, int TIER>
__host__ __device__ constexpr bool grouped_walk() {
  return sizeof(typename Real<TIER>::type) == 4 || N_PAD <= 40;
}

// Whether the group's constant columns 0 .. G-1 may stay in registers for
// the whole chunk: the compiler then hoists their loads out of the loop, and
// a trip reads the table once, for the step m0.  That is faster in the
// float tiers and in df64 up to N_PAD = 32; past that a double walk's
// hoisted columns spill, and tf96's product needs the registers, so there
// each trip reads the columns again, once each (an offset the compiler
// cannot see is 0 keeps the loads in their trip).  PERF.md has the A-B.
template <int N_PAD, int TIER>
__host__ __device__ constexpr bool hoist_cols() {
  return TIER != kTf96 && N_PAD * sizeof(typename Real<TIER>::type) <= 256;
}

__device__ __forceinline__ int opaque(int z) {
  asm volatile("" : "+r"(z));
  return z;
}

// Steps m0 + I .. m0 + 2^G - 1 of a group: column ctz(I), its sign and the
// term's sign constants, s_top the x-sign at k = G-1.
template <int G, int I, int N_PAD, int TIER, typename T>
__device__ __forceinline__ void group_steps(const T* col_s, T s_top,
                                            T (&x)[N_PAD], T& hi, T& lo) {
  if constexpr (I < (1 << G)) {
    constexpr int K = ctz_const(I);
    const T s = K == G - 1 ? s_top : ((I >> (K + 1)) & 1 ? T(-1) : T(1));
    add_col<N_PAD, T>(col_s + K * N_PAD, s, x);
    add_term<N_PAD, TIER, T>(x, I & 1, hi, lo);
    group_steps<G, I + 1, N_PAD, TIER, T>(col_s, s_top, x, hi, lo);
  }
}

// Walk chunk l of 2^r steps.  x0 points at N_PAD values (padding rows 1),
// col_s at the (n-1, N_PAD) column table in shared memory (padding 0),
// 16-byte aligned.  Only the column count n-1 is read from n, so a
// factored walk hands in the pack of fewer than n rows.
template <int N_PAD, int TIER>
__device__ __forceinline__ void walk_chunk(
    unsigned long long ul, const typename Real<TIER>::type* __restrict__ x0,
    const typename Real<TIER>::type* col_s, int n, int r,
    typename Real<TIER>::type& hi, typename Real<TIER>::type& lo) {
  using T = typename Real<TIER>::type;
  constexpr int G = kGroupLog2;
  T x[N_PAD];
  chunk_x<N_PAD, T>(ul, x0, col_s, n - 1, r, x);
  const T smid = (ul & 1ull) ? T(-1) : T(1);

  // m = 0: base index even, sign +1
  if constexpr (TIER == kTf96) {
    const dd t = tree_prod_dd<N_PAD>(x);
    hi = t.hi;
    lo = t.lo;
  } else {
    hi = tree_prod<N_PAD, T>(x);
    lo = T(0);
  }
  if (!grouped_walk<N_PAD, TIER>() || r < G) {
    const unsigned long long steps = 1ull << r;
    for (unsigned long long m = 1; m < steps; ++m) {
      step_x<N_PAD, T>(m, r, smid, col_s, x);
      add_term<N_PAD, TIER, T>(x, m & 1ull, hi, lo);   // sign (-1)^m
    }
    return;
  }
  if constexpr (grouped_walk<N_PAD, TIER>()) {
    // group 0: steps 1 .. 2^G - 1
    group_steps<G, 1, N_PAD, TIER, T>(col_s, r == G ? smid : T(1), x, hi,
                                      lo);
    const unsigned long long groups = 1ull << (r - G);
#pragma unroll 1
    for (unsigned long long j = 1; j < groups; ++j) {
      // step m = j * 2^G: k = G + ctz(j), x-sign bit k+1 of m = bit
      // ctz(j)+1 of j (or smid at the mid step), term sign +1
      const int kj = __ffsll((long long)j) - 1;
      T s = ((j >> (kj + 1)) & 1ull) ? T(-1) : T(1);
      if (kj + G == r - 1) s = smid;
      add_col<N_PAD, T>(col_s + (kj + G) * N_PAD, s, x);
      add_term<N_PAD, TIER, T>(x, false, hi, lo);
      const T* cs = hoist_cols<N_PAD, TIER>() ? col_s : col_s + opaque(0);
      group_steps<G, 1, N_PAD, TIER, T>(cs, (j & 1ull) ? T(-1) : T(1), x,
                                        hi, lo);
    }
  }
}

// ---- the amp tier

// Within-line clamp of the conditioned term: |x| below 2^-45 (at the unit
// row scale the engines give every row) reads as 2^-45, so a line's
// condition saturates at 2^45.  The reference's figure; it walked x as a
// float32 pair to resolve crossings this far, a double resolves further.
constexpr double kAmpEps = 0x1p-45;

// The two folds below evaluate fold_prod's tree depth first: node I of
// level K (level 0 the leaves, level K has fold_size(N, K) nodes) is the
// product of nodes I and I + fold_size(N, K) of level K-1, or node I
// itself where level K-1 has an odd middle one.  Every node takes the
// operations it takes in fold_prod, so the result is the same, but at most
// one partial product a level is live at once: the walk keeps x (N_PAD
// doubles) in registers besides.  Every multiply is an intrinsic, since
// the results feed adds that nvcc could otherwise contract a multiply
// into.
__host__ __device__ constexpr int fold_size(int s, int k) {
  return k == 0 ? s : fold_size((s + 1) / 2, k - 1);
}

__host__ __device__ constexpr int fold_depth(int s) {
  return s <= 1 ? 0 : 1 + fold_depth((s + 1) / 2);
}

// prod |x[0..N)| in fold_prod's order.
template <int N, int K, int I>
__device__ __forceinline__ double abs_prod(const double (&x)[N]) {
  if constexpr (K == 0) {
    return fabs(x[I]);
  } else if constexpr (I < fold_size(N, K - 1) / 2) {
    return __dmul_rn(abs_prod<N, K - 1, I>(x),
                     abs_prod<N, K - 1, I + fold_size(N, K)>(x));
  } else {
    return abs_prod<N, K - 1, I>(x);
  }
}

// The conditioned term: sum_{i<n} prod_{j != i} pc_j with pc_j =
// max(|x_j|, eps), as one fold of (P, C) pairs in fold_prod's order.  A
// leaf is (pc_i, 1) for a row i < n and (pc_i, 0) = (1, 0) for a padding
// row (x = 1); two pairs combine as (P1 P2, C1 P2 + C2 P1), so a node's P
// is the product of its leaves' pc and its C the sum over its real leaves
// of the product of the others.  No division, no reciprocal.  At level 1
// both children are leaves, whose C of 0 or 1 makes C1 P2 a choice
// between 0 and P2.
template <int N, int K, int I>
__device__ __forceinline__ void cond_fold(const double (&x)[N], int n,
                                          double& P, double& C) {
  constexpr int S = fold_size(N, K);
  if constexpr (K == 1) {
    constexpr int J = I + S;       // N is even: every level-1 node pairs
    const double a = fmax(fabs(x[I]), kAmpEps), b = fmax(fabs(x[J]), kAmpEps);
    P = __dmul_rn(a, b);
    C = __dadd_rn(I < n ? b : 0.0, J < n ? a : 0.0);
  } else if constexpr (I < fold_size(N, K - 1) / 2) {
    double P1, C1, P2, C2;
    cond_fold<N, K - 1, I>(x, n, P1, C1);
    cond_fold<N, K - 1, I + S>(x, n, P2, C2);
    P = __dmul_rn(P1, P2);
    C = __dadd_rn(__dmul_rn(C1, P2), __dmul_rn(C2, P1));
  } else {
    cond_fold<N, K - 1, I>(x, n, P, C);
  }
}

// One step's terms: w-slot 0 gets amp = prod |x_i|; with COND, slot 2 gets
// cond = sum_{i < n} prod_{j != i} of the clamped |x_j|: the weight of
// the walk's within-line rounding error (a line at zero still contributes
// the product of the others).  The padding rows multiply as identities
// and are left out of the sum: the kernel knows n, so it computes the host
// formula (ops/ryser.py amp_cond_walk_log2) and not the reference kernel's
// overcount of n_pad - n.  The products run in double: the rows are
// scaled to |x| <~ 1, and a product of 32-64 such values, some clamped to
// 2^-45, falls below float32's 2^-149 long before it leaves double's
// range.
template <int N_PAD, bool COND>
__device__ __forceinline__ void amp_terms(const double (&x)[N_PAD], int n,
                                          double& amp, double& cond) {
  static_assert(N_PAD % 2 == 0, "the first fold pairs all of x");
  constexpr int D = fold_depth(N_PAD);
  amp = abs_prod<N_PAD, D, 0>(x);
  if constexpr (COND) {
    double P;
    cond_fold<N_PAD, D, 0>(x, n, P, cond);
  }
}

// The amp walk of chunk l: the steps of walk_chunk, each step's terms
// added without their sign into TwoSum accumulators (hi the sum, lo the
// running compensation, as in kF32k).  w = [amp hi, amp lo] and with
// COND [.., cond hi, cond lo].
template <int N_PAD, bool COND>
__device__ __forceinline__ void walk_chunk_amp(
    unsigned long long ul, const double* __restrict__ x0, const double* col_s,
    int n, int r, double (&w)[COND ? 4 : 2]) {
  double x[N_PAD];
  chunk_x<N_PAD, double>(ul, x0, col_s, n - 1, r, x);
  const double smid = (ul & 1ull) ? -1.0 : 1.0;
  double c0 = 0.0;
  amp_terms<N_PAD, COND>(x, n, w[0], c0);
  w[1] = 0.0;
  if constexpr (COND) {
    w[2] = c0;
    w[3] = 0.0;
  }
  const unsigned long long steps = 1ull << r;
  for (unsigned long long m = 1; m < steps; ++m) {
    step_x<N_PAD, double>(m, r, smid, col_s, x);
    double a, c = 0.0, s, e;
    amp_terms<N_PAD, COND>(x, n, a, c);
    two_sum(w[0], a, s, e);
    w[0] = s;
    w[1] += e;
    if constexpr (COND) {
      two_sum(w[2], c, s, e);
      w[2] = s;
      w[3] += e;
    }
  }
}

// ---- the sparse walk's epilogue

// The weight of chunk l in a factored walk: the product over the nf
// factored rows z of x_z at the chunk's base, x_z = fx0[z] + the entries
// fcol_s[b * nf + z] of the columns b whose bit is set in gray(l * 2^r),
// added in column order (gray.factor_weights).  A factored row is constant
// inside a chunk, so its x at the base is its x at every step.  nf is a
// runtime count: the rows are looped over, not held in registers.  The
// weight is a double-double: the first row's x, then a dd_mul by each
// further row's (x, 0); on integer matrices every x is exact, and the
// chain errs by a few 2^-106 a row (the reference chained float32-pair
// products, ~2^-48).
__device__ __forceinline__ dd chunk_weight(unsigned long long ul,
                                           const double* fx0_s,
                                           const double* fcol_s, int nf,
                                           int ncol, int r) {
  const unsigned long long gl = ul ^ (ul >> 1);
  dd w = {1.0, 0.0};
  for (int z = 0; z < nf; ++z) {
    double xz = fx0_s[z];
    for (int b = 0; b < ncol; ++b)
      if (base_gray_bit(ul, gl, b, r)) xz = __dadd_rn(xz, fcol_s[b * nf + z]);
    w = z == 0 ? dd{xz, 0.0} : dd_mul(w, dd{xz, 0.0});
  }
  return w;
}

// ---- the block-reduced walks' epilogue

// A chunk's partial (hi, lo) in the tier's type as one double-double: the
// f32 tiers' pair widened to one double (hi + lo, lo 0), the double tiers'
// pair as it is.  The reduced walks sum their blocks in double-double
// whatever the tier.
template <int TIER, typename T>
__device__ __forceinline__ dd widen(T hi, T lo) {
  if constexpr (TIER == kF32 || TIER == kF32k)
    return {__dadd_rn((double)hi, (double)lo), 0.0};
  else
    return {hi, lo};
}

// The block's threads' (hi, lo) added with acc_merge<TIER> in a fixed
// halving order: thread t takes thread t + 64, then t + 32, ...; thread 0
// holds the block's sum on return.  red_hi and red_lo are kThreads words
// of shared memory each.  Every thread of the block must call it.  No
// floating-point atomics, so the sum does not depend on how the grid was
// scheduled; ops/ryser_cuda.py block_reduce_ref repeats the order.
template <int TIER, typename T>
__device__ __forceinline__ void block_sum(T& hi, T& lo, T* red_hi,
                                          T* red_lo) {
  const int t = threadIdx.x;
  red_hi[t] = hi;
  red_lo[t] = lo;
  __syncthreads();
  for (int s = kThreads / 2; s >= 1; s >>= 1) {
    if (t < s) {
      acc_merge<TIER, T>(hi, lo, red_hi[t + s], red_lo[t + s]);
      red_hi[t] = hi;
      red_lo[t] = lo;
    }
    __syncthreads();
  }
}

// The block's dynamic shared memory as an array of T.
template <typename T>
__device__ __forceinline__ T* shared_as() {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  return reinterpret_cast<T*>(walk_smem);
}

}  // namespace walk
