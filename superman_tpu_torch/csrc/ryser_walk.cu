// Ryser walk over a list of chunk ids, for Hopper (sm_90a): tiers df64,
// f32, f32k, tf96 and amp, and the weighted, block-reduced walk of the
// sparse engine.
//
// Replaces the TPU Pallas walk in superman_tpu/ops/ryser_pallas.py
// (_ryser_kernel, _ryser_kernel_u16 and _ryser_kernel_u16_multi behind the
// pallas_call of _partials_jit) for calc="df64", "f32", "f32k" and "tf96",
// its amp mode (_amp_terms), and the XLA code that followed the call on the
// sparse path (_weight_out8, _merge_out8, gray.py factor_weights).
//
// What it computes: one thread walks one aligned chunk of 2^r Gray steps
// (walk.cuh, which also says what bounds the walk on this card and what
// the design does about it).  ryser_walk_kernel has two outputs.  Per
// chunk (ryser_walk: the per-chunk partials, the tf96 tier, the
// hybrid scheduler's units), each thread writes its chunk's partial sum as
// a (hi, lo) pair of the tier's type, and chunk ids < 0 are sentinels that
// write 0.  Block-reduced (ryser_walk_blocks: the dense walk's total in
// df64, f32 and f32k), the host hands in only the block rows it walks: each
// thread derives its chunk id from its row and lane, widens its pair to a
// double-double, and the block of 128 adds its pairs in a fixed halving
// order (walk.cuh block_sum), so one double (hi, lo) pair a block comes
// back; threads past the plan's chunks enter the sum as exact zeros.  The
// host then adds hi + lo per block and sums the blocks in float64 (tf96:
// all chunk words in long double).  The TPU's f32-pair and f32-triple
// emulation, 16-step unroll, lane vectorisation and multi-block programs
// have no counterpart here.
//
// ryser_amp_kernel is the same launch over walk_chunk_amp and writes two
// words a chunk (the amplitude), or four (with the conditioned term).
// ryser_reduced_kernel walks a pruned list of live chunks of a factored
// matrix: the pack holds the alive rows only (N_PAD is their
// count rounded up to 8, so a step multiplies fewer rows than the matrix
// has), each thread multiplies its chunk's partial by the chunk's weight,
// the product of the factored rows, which it computes from its id, and the
// block of 128 adds its pairs as ryser_walk_blocks does: no floating-point
// atomics, one (hi, lo) pair a block.  Sentinel threads do not walk and
// enter the reduction as exact zeros.  After the walk every tier is a
// double-double: the f32 tiers widen their partial to double before the
// weight, and the block sum is the double-double acc_merge.  What bounds
// all three is the walk (walk.cuh says how, tier by tier); weight and
// reduction are a few hundred operations a chunk.

#include "device_guard.cuh"
#include "walk.cuh"

namespace {

using walk::kThreads;

// What ryser_walk_kernel writes: the tier's (hi, lo) a chunk, or with
// REDUCE one double (hi, lo) a block.
template <int TIER, bool REDUCE>
struct WalkOut {
  using type = typename walk::Real<TIER>::type;
};
template <int TIER>
struct WalkOut<TIER, true> {
  using type = double;
};

// Without REDUCE, ids holds num_chunks chunk ids and out gets one pair a
// chunk.  With REDUCE, ids holds block rows of `lanes` chunk ids each,
// chunk id row * lanes + lane: block b walks lanes (b % bpr) * kThreads +
// t, bpr = ceil(lanes / kThreads), of row ids[b / bpr], a lane past
// `lanes` or an id outside [0, num_chunks) a sentinel, and out gets the
// block's double-double sum.
template <int N_PAD, int TIER, bool REDUCE>
__global__ void __launch_bounds__(kThreads)
ryser_walk_kernel(const long long* __restrict__ ids, long long num_chunks,
                  const typename walk::Real<TIER>::type* __restrict__ x0,
                  const typename walk::Real<TIER>::type* __restrict__ cols,
                  int n, int r, int lanes,
                  typename WalkOut<TIER, REDUCE>::type* __restrict__ out) {
  using T = typename walk::Real<TIER>::type;
  // [(n-1) * N_PAD] column table, column k at k*N_PAD; with REDUCE then
  // kThreads hi words and kThreads lo words of double
  T* col_s = walk::shared_as<T>();
  for (int i = threadIdx.x; i < (n - 1) * N_PAD; i += blockDim.x)
    col_s[i] = cols[i];
  __syncthreads();

  if constexpr (REDUCE) {
    double* red_hi = reinterpret_cast<double*>(col_s + (n - 1) * N_PAD);
    double* red_lo = red_hi + kThreads;
    const unsigned bpr = (lanes + kThreads - 1) / kThreads;
    const int lane = (int)(blockIdx.x % bpr) * kThreads + threadIdx.x;
    const long long l = ids[blockIdx.x / bpr] * lanes + lane;
    walk::dd p = {0.0, 0.0};
    if (lane < lanes && l >= 0 && l < num_chunks) {
      T hi, lo;
      walk::walk_chunk<N_PAD, TIER>((unsigned long long)l, x0, col_s, n, r,
                                    hi, lo);
      p = walk::widen<TIER>(hi, lo);
    }
    walk::block_sum<walk::kDf64, double>(p.hi, p.lo, red_hi, red_lo);
    if (threadIdx.x == 0) {
      out[2 * (size_t)blockIdx.x] = p.hi;
      out[2 * (size_t)blockIdx.x + 1] = p.lo;
    }
  } else {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= num_chunks) return;
    const long long l = ids[c];
    if (l < 0) {
      out[2 * c] = T(0);
      out[2 * c + 1] = T(0);
      return;
    }
    T hi, lo;
    walk::walk_chunk<N_PAD, TIER>((unsigned long long)l, x0, col_s, n, r, hi,
                                  lo);
    out[2 * c] = hi;
    out[2 * c + 1] = lo;
  }
}

// TIER is kAmp (2 words a chunk: amp hi, lo) or kAmpCond (4: amp hi, lo,
// cond hi, lo).
template <int N_PAD, int TIER>
__global__ void __launch_bounds__(kThreads)
ryser_amp_kernel(const long long* __restrict__ ids, long long num_chunks,
                 const double* __restrict__ x0,
                 const double* __restrict__ cols, int n, int r,
                 double* __restrict__ out) {
  constexpr bool COND = TIER == walk::kAmpCond;
  constexpr int W = COND ? 4 : 2;
  double* col_s = walk::shared_as<double>();
  for (int i = threadIdx.x; i < (n - 1) * N_PAD; i += blockDim.x)
    col_s[i] = cols[i];
  __syncthreads();

  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_chunks) return;
  const long long l = ids[c];
  double w[W] = {};
  if (l >= 0)
    walk::walk_chunk_amp<N_PAD, COND>((unsigned long long)l, x0, col_s, n, r,
                                      w);
#pragma unroll
  for (int i = 0; i < W; ++i) out[W * c + i] = w[i];
}

// num_chunks is a multiple of kThreads (the wrapper pads with sentinels).
// x0 is (N_PAD,) and cols (n-1, N_PAD) of the alive rows, fx0 (nf,) and
// fcols (n-1, nf) of the factored rows; out is (num_chunks / kThreads, 2).
template <int N_PAD, int TIER>
__global__ void __launch_bounds__(kThreads)
ryser_reduced_kernel(const long long* __restrict__ ids,
                     const typename walk::Real<TIER>::type* __restrict__ x0,
                     const typename walk::Real<TIER>::type* __restrict__ cols,
                     const double* __restrict__ fx0,
                     const double* __restrict__ fcols, int nf, int n, int r,
                     double* __restrict__ out) {
  using T = typename walk::Real<TIER>::type;
  // [(n-1) * N_PAD] column table of T, then in double the factored rows'
  // (n-1, nf) table and nf initial values, kThreads hi words, kThreads lo
  T* col_s = walk::shared_as<T>();
  double* fcol_s = reinterpret_cast<double*>(col_s + (n - 1) * N_PAD);
  double* fx0_s = fcol_s + (n - 1) * nf;
  double* red_hi = fx0_s + nf;
  double* red_lo = red_hi + kThreads;
  const int t = threadIdx.x;
  for (int i = t; i < (n - 1) * N_PAD; i += blockDim.x) col_s[i] = cols[i];
  for (int i = t; i < (n - 1) * nf; i += blockDim.x) fcol_s[i] = fcols[i];
  for (int i = t; i < nf; i += blockDim.x) fx0_s[i] = fx0[i];
  __syncthreads();

  const long long l = ids[(long long)blockIdx.x * blockDim.x + t];
  walk::dd p = {0.0, 0.0};
  if (l >= 0) {
    const unsigned long long ul = (unsigned long long)l;
    T hi, lo;
    walk::walk_chunk<N_PAD, TIER>(ul, x0, col_s, n, r, hi, lo);
    p = walk::widen<TIER>(hi, lo);
    if (nf > 0)
      p = walk::dd_mul(p, walk::chunk_weight(ul, fx0_s, fcol_s, nf, n - 1,
                                             r));
  }
  walk::block_sum<walk::kDf64, double>(p.hi, p.lo, red_hi, red_lo);
  if (t == 0) {
    out[2 * (size_t)blockIdx.x] = p.hi;
    out[2 * (size_t)blockIdx.x + 1] = p.lo;
  }
}

template <int N_PAD, int TIER>
cudaError_t launch(const long long* ids, long long num_chunks, const void* x0,
                   const void* cols, int n, int r, void* out,
                   cudaStream_t stream) {
  using T = typename walk::Real<TIER>::type;
  const long long blocks = (num_chunks + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(n - 1) * N_PAD * sizeof(T);
  if constexpr (TIER == walk::kAmp || TIER == walk::kAmpCond)
    ryser_amp_kernel<N_PAD, TIER><<<(unsigned)blocks, kThreads, smem, stream>>>(
        ids, num_chunks, (const T*)x0, (const T*)cols, n, r, (T*)out);
  else
    ryser_walk_kernel<N_PAD, TIER, false><<<(unsigned)blocks, kThreads, smem,
                                            stream>>>(
        ids, num_chunks, (const T*)x0, (const T*)cols, n, r, 0, (T*)out);
  return cudaGetLastError();
}

template <int N_PAD, int TIER>
cudaError_t launch_blocks(const long long* rows, long long num_rows,
                          long long num_chunks, int lanes, const void* x0,
                          const void* cols, int n, int r, double* out,
                          cudaStream_t stream) {
  using T = typename walk::Real<TIER>::type;
  const long long blocks = num_rows * ((lanes + kThreads - 1) / kThreads);
  const size_t smem =
      (size_t)(n - 1) * N_PAD * sizeof(T) + 2 * kThreads * sizeof(double);
  ryser_walk_kernel<N_PAD, TIER, true><<<(unsigned)blocks, kThreads, smem,
                                         stream>>>(
      rows, num_chunks, (const T*)x0, (const T*)cols, n, r, lanes, out);
  return cudaGetLastError();
}

// Shared memory a block of the reduced kernel takes; the launch is refused
// above the 48 KB a kernel gets without opting in (n <= 64 stays below).
template <typename T>
size_t reduced_smem(int n, int n_pad, int nf) {
  return (size_t)(n - 1) * n_pad * sizeof(T) +
         ((size_t)(n - 1) * nf + nf + 2 * kThreads) * sizeof(double);
}

template <int N_PAD, int TIER>
cudaError_t launch_reduced(const long long* ids, long long num_chunks,
                           const void* x0, const void* cols,
                           const double* fx0, const double* fcols, int nf,
                           int n, int r, double* out, cudaStream_t stream) {
  using T = typename walk::Real<TIER>::type;
  ryser_reduced_kernel<N_PAD, TIER>
      <<<(unsigned)(num_chunks / kThreads), kThreads,
         reduced_smem<T>(n, N_PAD, nf), stream>>>(
          ids, (const T*)x0, (const T*)cols, fx0, fcols, nf, n, r, out);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes (csrc/build.py SIGNATURES, launched by
// build.call).  Each launches on `stream` of `device`, allocates nothing,
// does not synchronise, leaves the caller's current device as it was
// (device_guard.cuh), and returns cudaGetLastError() of the launch (0 on
// success).
//
// The walk of a list of chunk ids.  tier is walk.cuh's Tier: 0 (df64), 1
// (f32), 2 (f32k), 3 (tf96), 4 (amp) or 5 (amp with the conditioned
// term); x0 (n_pad,) and cols (n-1, n_pad), double for tiers 0, 3, 4 and 5
// and float for 1 and 2; out (num_chunks, 2) of the same type, (hi, lo) a
// chunk, or for tier 5 (num_chunks, 4) double.
extern "C" int ryser_walk(const long long* ids, long long num_chunks,
                          const void* x0, const void* cols, int n, int n_pad,
                          int r, int tier, void* out, int device,
                          void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (n < 3 || n > n_pad || r < 1 || r > n - 2 || tier < 0 || tier > 5 ||
      num_chunks < 0 || (num_chunks + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (num_chunks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define WALK_CASE(NP, TIER)                                                  \
  case NP * 8 + TIER:                                                        \
    return (int)launch<NP, TIER>(ids, num_chunks, x0, cols, n, r, out, s);
#define WALK_TIERS(NP)        \
  WALK_CASE(NP, walk::kDf64)  \
  WALK_CASE(NP, walk::kF32)   \
  WALK_CASE(NP, walk::kF32k)  \
  WALK_CASE(NP, walk::kTf96)  \
  WALK_CASE(NP, walk::kAmp)   \
  WALK_CASE(NP, walk::kAmpCond)
  switch (n_pad * 8 + tier) {
    WALK_TIERS(8)
    WALK_TIERS(16)
    WALK_TIERS(24)
    WALK_TIERS(32)
    WALK_TIERS(40)
    WALK_TIERS(48)
    WALK_TIERS(56)
    WALK_TIERS(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WALK_TIERS
#undef WALK_CASE
}

// The dense walk's total, block by block.  tier is 0 (df64), 1 (f32) or 2
// (f32k); x0 (n_pad,) and cols (n-1, n_pad) as for ryser_walk,
// double for tier 0 and float for 1 and 2; rows (num_rows,) the block rows
// walked, row q holding chunk ids q * lanes .. q * lanes + lanes - 1, ids
// outside [0, num_chunks) sentinels; out (num_rows * ceil(lanes / 128), 2)
// double, row by row: each block of 128 lanes' double-double sum.  Launch
// rules as above.
extern "C" int ryser_walk_blocks(const long long* rows, long long num_rows,
                                 long long num_chunks, int lanes,
                                 const void* x0, const void* cols, int n,
                                 int n_pad, int r, int tier, double* out,
                                 int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (n < 3 || n > n_pad || r < 1 || r > n - 2 || tier < 0 || tier > 2 ||
      num_rows < 0 || num_chunks < 0 || lanes < 1 ||
      num_rows * ((lanes + kThreads - 1) / kThreads) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (num_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define BLOCKS_CASE(NP, TIER)                                                 \
  case NP * 4 + TIER:                                                         \
    return (int)launch_blocks<NP, TIER>(rows, num_rows, num_chunks, lanes,    \
                                        x0, cols, n, r, out, s);
#define BLOCKS_TIERS(NP)        \
  BLOCKS_CASE(NP, walk::kDf64)  \
  BLOCKS_CASE(NP, walk::kF32)   \
  BLOCKS_CASE(NP, walk::kF32k)
  switch (n_pad * 4 + tier) {
    BLOCKS_TIERS(8)
    BLOCKS_TIERS(16)
    BLOCKS_TIERS(24)
    BLOCKS_TIERS(32)
    BLOCKS_TIERS(40)
    BLOCKS_TIERS(48)
    BLOCKS_TIERS(56)
    BLOCKS_TIERS(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BLOCKS_TIERS
#undef BLOCKS_CASE
}

// The weighted, block-reduced walk.  tier is 0 (df64), 1 (f32), 2 (f32k) or
// 3 (tf96); x0 (n_pad,) and cols (n-1, n_pad) are the alive rows' pack,
// double for tiers 0 and 3 and float for 1 and 2, n_pad may be below n;
// fx0 (nf,) and fcols (n-1, nf) the factored rows' pack, double, nf >= 0
// (0: no weight); num_chunks a multiple of 128; out (num_chunks / 128, 2)
// double.  Launch rules as above.
extern "C" int ryser_walk_reduced(const long long* ids, long long num_chunks,
                                  const void* x0, const void* cols,
                                  const double* fx0, const double* fcols,
                                  int nf, int n, int n_pad, int r, int tier,
                                  double* out, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (n < 3 || n > 64 || nf < 0 || nf >= n || r < 1 || r > n - 2 ||
      tier < 0 || tier > 3 || num_chunks < 0 || num_chunks % kThreads ||
      num_chunks / kThreads > 0x7fffffffLL ||
      reduced_smem<double>(n, n_pad, nf) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (num_chunks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define REDUCED_CASE(NP, TIER)                                              \
  case NP * 4 + TIER:                                                       \
    return (int)launch_reduced<NP, TIER>(ids, num_chunks, x0, cols, fx0,    \
                                         fcols, nf, n, r, out, s);
#define REDUCED_TIERS(NP)         \
  REDUCED_CASE(NP, walk::kDf64)   \
  REDUCED_CASE(NP, walk::kF32)    \
  REDUCED_CASE(NP, walk::kF32k)   \
  REDUCED_CASE(NP, walk::kTf96)
  switch (n_pad * 4 + tier) {
    REDUCED_TIERS(8)
    REDUCED_TIERS(16)
    REDUCED_TIERS(24)
    REDUCED_TIERS(32)
    REDUCED_TIERS(40)
    REDUCED_TIERS(48)
    REDUCED_TIERS(56)
    REDUCED_TIERS(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REDUCED_TIERS
#undef REDUCED_CASE
}
