// The Gray-code Ryser walk of one aligned chunk, for Hopper (sm_90a):
// the body shared by the chunk kernel (ryser_walk.cu) and the serving-batch
// kernel (ryser_batch.cu).
//
// Replaces the walk bodies of superman_tpu/ops/ryser_pallas.py
// (_walk_scalar / _walk_u16) for the tiers df64, f32 and f32k, and folds in
// their XLA prologue (superman_tpu/ops/gray.py chunk_init).
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
//          lo += e; word 0 is the sum, word 1 the compensation.
//
// What bounds it on this card: arithmetic of the tier's type, about n
// multiplies for the product plus n adds for the x update per step, and no
// device-memory traffic inside the loop.  The design keeps it there: x
// lives in registers (N_PAD is a template parameter, so every row loop
// unrolls), and the column table sits in shared memory, where all threads
// of a warp read the same column k at the same step -- a broadcast, with
// no bank conflicts.
//
// Build without fast-math and with nvcc's default -ftz=false: the sums are
// add-only, so FMA contraction cannot break them; the one contractible
// product, s * col with s = +-1, is exact; the tree is multiply-only; and
// denormal float products must round as the plain version's do.

#pragma once

#include <cuda_runtime.h>

namespace walk {

constexpr int kThreads = 128;

enum Tier { kDf64 = 0, kF32 = 1, kF32k = 2 };

template <int TIER> struct Real { using type = float; };
template <> struct Real<kDf64> { using type = double; };

// p[0] = product of p[0..S): fold the upper half onto the lower half,
// p[i] *= p[i + ceil(S/2)], until one element is left.  The plain version
// (ops/ryser_cuda.py tree_prod) multiplies in the same order.
template <int S, int N, typename T>
__device__ __forceinline__ void fold_prod(T (&p)[N]) {
  if constexpr (S > 1) {
    constexpr int NS = (S + 1) / 2;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) p[i] *= p[i + NS];
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
// compensated add, the counterpart of the reference's _merge_out8.
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

// Walk chunk l of 2^r steps.  x0 points at N_PAD values (padding rows 1),
// col_s at the (n-1, N_PAD) column table in shared memory (padding 0).
template <int N_PAD, int TIER>
__device__ __forceinline__ void walk_chunk(
    unsigned long long ul, const typename Real<TIER>::type* __restrict__ x0,
    const typename Real<TIER>::type* col_s, int n, int r,
    typename Real<TIER>::type& hi, typename Real<TIER>::type& lo) {
  using T = typename Real<TIER>::type;
  const int ncol = n - 1;

  // prologue (gray.chunk_init): x = x0 + the columns whose bit is set in
  // gray(l * 2^r), added in column order; bit b >= r is gray(l) >> (b - r),
  // bit r-1 is l & 1
  T x[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) x[i] = x0[i];
  const unsigned long long gl = ul ^ (ul >> 1);
  for (int b = 0; b < ncol; ++b) {
    const unsigned long long bit =
        b >= r ? (gl >> (b - r)) & 1ull : (b == r - 1 ? ul & 1ull : 0ull);
    if (bit) {
      const T* ck = col_s + b * N_PAD;
#pragma unroll
      for (int i = 0; i < N_PAD; ++i) x[i] += ck[i];
    }
  }
  const T smid = (ul & 1ull) ? T(-1) : T(1);

  hi = tree_prod<N_PAD, T>(x);  // m = 0: base index even, sign +1
  lo = T(0);
  const unsigned long long steps = 1ull << r;
  for (unsigned long long m = 1; m < steps; ++m) {
    const int k = __ffsll((long long)m) - 1;
    // x-sign +1 iff bit k+1 of m is 0; at the mid step (k == r-1) it is
    // the chunk parity instead
    T s = ((m >> (k + 1)) & 1ull) ? T(-1) : T(1);
    if (k == r - 1) s = smid;
    const T* ck = col_s + k * N_PAD;
#pragma unroll
    for (int i = 0; i < N_PAD; ++i) x[i] += s * ck[i];
    const T t = tree_prod<N_PAD, T>(x);
    acc_add<TIER, T>(hi, lo, (m & 1ull) ? -t : t);  // term sign (-1)^m
  }
}

// The block's dynamic shared memory as an array of T.
template <typename T>
__device__ __forceinline__ T* shared_as() {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  return reinterpret_cast<T*>(walk_smem);
}

}  // namespace walk
