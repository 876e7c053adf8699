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
// the design does about it) and writes that chunk's partial sum as a
// (hi, lo) pair of the tier's type; the host adds hi + lo per chunk and
// sums the chunks in float64 (tf96: all words in long double).  Chunk ids
// < 0 are sentinels and write 0.  The TPU's f32-pair and f32-triple
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
// block of 128 adds its pairs in the batch kernel's fixed halving order:
// no floating-point atomics, one (hi, lo) pair a block.  Sentinel threads
// do not walk and enter the reduction as exact zeros.  After the walk every
// tier is a double-double: the f32 tiers widen their partial to double
// before the weight, and the block sum is the double-double acc_merge.
// What bounds both is the walk (walk.cuh says how, tier by tier); weight
// and reduction are a few hundred operations a chunk.

#include "walk.cuh"

namespace {

using walk::kThreads;

template <int N_PAD, int TIER>
__global__ void __launch_bounds__(kThreads)
ryser_walk_kernel(const long long* __restrict__ ids, long long num_chunks,
                  const typename walk::Real<TIER>::type* __restrict__ x0,
                  const typename walk::Real<TIER>::type* __restrict__ cols,
                  int n, int r,
                  typename walk::Real<TIER>::type* __restrict__ out) {
  using T = typename walk::Real<TIER>::type;
  T* col_s = walk::shared_as<T>();  // [(n-1) * N_PAD], column k at k*N_PAD
  for (int i = threadIdx.x; i < (n - 1) * N_PAD; i += blockDim.x)
    col_s[i] = cols[i];
  __syncthreads();

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
  double hi = 0.0, lo = 0.0;
  if (l >= 0) {
    const unsigned long long ul = (unsigned long long)l;
    T phi, plo;
    walk::walk_chunk<N_PAD, TIER>(ul, x0, col_s, n, r, phi, plo);
    if constexpr (TIER == walk::kF32 || TIER == walk::kF32k) {
      hi = __dadd_rn((double)phi, (double)plo);
    } else {
      hi = phi;
      lo = plo;
    }
    if (nf > 0) {
      const walk::dd p = walk::dd_mul(
          walk::dd{hi, lo},
          walk::chunk_weight(ul, fx0_s, fcol_s, nf, n - 1, r));
      hi = p.hi;
      lo = p.lo;
    }
  }

  red_hi[t] = hi;
  red_lo[t] = lo;
  __syncthreads();
  for (int s = kThreads / 2; s >= 1; s >>= 1) {
    if (t < s) {
      walk::acc_merge<walk::kDf64, double>(hi, lo, red_hi[t + s],
                                           red_lo[t + s]);
      red_hi[t] = hi;
      red_lo[t] = lo;
    }
    __syncthreads();
  }
  if (t == 0) {
    out[2 * (size_t)blockIdx.x] = hi;
    out[2 * (size_t)blockIdx.x + 1] = lo;
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
    ryser_walk_kernel<N_PAD, TIER><<<(unsigned)blocks, kThreads, smem,
                                     stream>>>(
        ids, num_chunks, (const T*)x0, (const T*)cols, n, r, (T*)out);
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

// Launches on `stream` of `device`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch (0 on success).
template <int TIER>
int run(const long long* ids, long long num_chunks, const void* x0,
        const void* cols, int n, int n_pad, int r, void* out, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 3 || n > n_pad || r < 1 || r > n - 2 || num_chunks < 0 ||
      (num_chunks + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (num_chunks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define WALK_CASE(NP) \
  case NP:            \
    return (int)launch<NP, TIER>(ids, num_chunks, x0, cols, n, r, out, s);
  switch (n_pad) {
    WALK_CASE(8)
    WALK_CASE(16)
    WALK_CASE(24)
    WALK_CASE(32)
    WALK_CASE(40)
    WALK_CASE(48)
    WALK_CASE(56)
    WALK_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WALK_CASE
}

}  // namespace

// C entry points, bound with ctypes (ops/ryser_cuda.py): x0 is (n_pad,),
// cols (n-1, n_pad), out (num_chunks, 2), all double for df64 and tf96
// and float for f32 and f32k.
extern "C" int ryser_walk_df64(const long long* ids, long long num_chunks,
                               const double* x0, const double* cols, int n,
                               int n_pad, int r, double* out, int device,
                               void* stream) {
  return run<walk::kDf64>(ids, num_chunks, x0, cols, n, n_pad, r, out, device,
                          stream);
}

extern "C" int ryser_walk_f32(const long long* ids, long long num_chunks,
                              const float* x0, const float* cols, int n,
                              int n_pad, int r, float* out, int device,
                              void* stream) {
  return run<walk::kF32>(ids, num_chunks, x0, cols, n, n_pad, r, out, device,
                         stream);
}

extern "C" int ryser_walk_f32k(const long long* ids, long long num_chunks,
                               const float* x0, const float* cols, int n,
                               int n_pad, int r, float* out, int device,
                               void* stream) {
  return run<walk::kF32k>(ids, num_chunks, x0, cols, n, n_pad, r, out, device,
                          stream);
}

extern "C" int ryser_walk_tf96(const long long* ids, long long num_chunks,
                               const double* x0, const double* cols, int n,
                               int n_pad, int r, double* out, int device,
                               void* stream) {
  return run<walk::kTf96>(ids, num_chunks, x0, cols, n, n_pad, r, out, device,
                          stream);
}

// The amp walk: x0 and cols double, out (num_chunks, 2) double; with the
// conditioned term (_cond) out (num_chunks, 4).
extern "C" int ryser_walk_amp(const long long* ids, long long num_chunks,
                              const double* x0, const double* cols, int n,
                              int n_pad, int r, double* out, int device,
                              void* stream) {
  return run<walk::kAmp>(ids, num_chunks, x0, cols, n, n_pad, r, out, device,
                         stream);
}

extern "C" int ryser_walk_amp_cond(const long long* ids, long long num_chunks,
                                   const double* x0, const double* cols,
                                   int n, int n_pad, int r, double* out,
                                   int device, void* stream) {
  return run<walk::kAmpCond>(ids, num_chunks, x0, cols, n, n_pad, r, out,
                             device, stream);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
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
