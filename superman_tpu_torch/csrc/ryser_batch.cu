// Serving-batch Ryser walk for Hopper (sm_90a): a stack of B matrices of
// one order n, each walked whole, tiers df64, f32, f32k and tf96.
//
// Replaces the TPU Pallas kernel _ryser_kernel_batch behind the pallas_call
// of batch_partials in superman_tpu/ops/ryser_pallas.py, and the lane
// reduction (_merge_out8) that followed it in XLA.
//
// What it computes: the grid is (chunk blocks, matrices).  blockIdx.y is
// the matrix, blockIdx.x a block of 128 chunks of that matrix, so a block
// never spans two matrices: it loads its own matrix's (n-1, N_PAD) column
// table into shared memory and every read in the loop is a warp broadcast.
// Thread t walks the aligned chunk c = blockIdx.x * 128 + t of 2^r steps
// with the shared body (walk.cuh); a matrix has 2^(n-1-r) chunks, a
// multiple of 128, and no sentinels.  Then the block adds its threads'
// (hi, lo) pairs in shared memory with the tier's compensated add, in a
// fixed halving order (thread t takes thread t + 64, then t + 32, ...), and
// thread 0 writes one pair to out[b, blockIdx.x].  There are no
// floating-point atomics: a matrix's result does not depend on how the
// grid was scheduled, and the plain version (ops/ryser_cuda.py
// batch_partials_ref) repeats the order bit for bit.  The host adds
// hi + lo per block and sums a matrix's few blocks in float64 (tf96: all
// their words in long double).
//
// What bounds it on this card: the walk, as walk.cuh says tier by tier;
// the table load and the reduction are a few hundred operations against
// 2^r steps of ~2n each.  A small batch of a small order cannot fill 132
// SMs whatever the plan; that is the traffic's nature.  The TPU program's
// 16 matrices per program, its lanes and its transposed column tables
// have no counterpart here.

#include "device_guard.cuh"
#include "walk.cuh"

namespace {

using walk::kThreads;

template <int N_PAD, int TIER>
__global__ void __launch_bounds__(kThreads)
ryser_batch_kernel(const typename walk::Real<TIER>::type* __restrict__ x0s,
                   const typename walk::Real<TIER>::type* __restrict__ colss,
                   int n, int r,
                   typename walk::Real<TIER>::type* __restrict__ out) {
  using T = typename walk::Real<TIER>::type;
  // [(n-1) * N_PAD] column table, then kThreads hi words and kThreads lo
  T* col_s = walk::shared_as<T>();
  T* red_hi = col_s + (n - 1) * N_PAD;
  T* red_lo = red_hi + kThreads;
  const int b = blockIdx.y;
  const T* cols = colss + (size_t)b * (n - 1) * N_PAD;
  for (int i = threadIdx.x; i < (n - 1) * N_PAD; i += blockDim.x)
    col_s[i] = cols[i];
  __syncthreads();

  const unsigned long long c =
      (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  T hi, lo;
  walk::walk_chunk<N_PAD, TIER>(c, x0s + (size_t)b * N_PAD, col_s, n, r, hi,
                                lo);

  walk::block_sum<TIER, T>(hi, lo, red_hi, red_lo);
  if (threadIdx.x == 0) {
    T* o = out + 2 * ((size_t)b * gridDim.x + blockIdx.x);
    o[0] = hi;
    o[1] = lo;
  }
}

template <int N_PAD, int TIER>
cudaError_t launch(const void* x0s, const void* colss, int batch, int n, int r,
                   void* out, cudaStream_t stream) {
  using T = typename walk::Real<TIER>::type;
  const dim3 grid((unsigned)((1ull << (n - 1 - r)) / kThreads),
                  (unsigned)batch);
  const size_t smem = ((size_t)(n - 1) * N_PAD + 2 * kThreads) * sizeof(T);
  ryser_batch_kernel<N_PAD, TIER><<<grid, kThreads, smem, stream>>>(
      (const T*)x0s, (const T*)colss, n, r, (T*)out);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (ops/ryser_cuda.py).  x0s is
// (batch, n_pad), colss (batch, n-1, n_pad), out
// (batch, 2^(n-1-r) / 128, 2): double for tiers 0 (df64) and 3 (tf96),
// float for tiers 1 (f32) and 2 (f32k).  Launches on `stream` of `device`,
// allocates nothing, does not synchronise, leaves the caller's current
// device as it was (device_guard.cuh), and returns cudaGetLastError() of
// the launch (0 on success).
extern "C" int ryser_batch(const void* x0s, const void* colss, int batch,
                           int n, int n_pad, int r, int tier, void* out,
                           int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  // a matrix needs at least one full block of chunks: r <= n - 8
  if (n < 9 || n > n_pad || r < 1 || r > n - 8 || batch < 0 ||
      batch > 65535 || (1ull << (n - 1 - r)) / kThreads > 0x7fffffffull)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define BATCH_CASE(NP, TIER) \
  case NP * 4 + TIER:        \
    return (int)launch<NP, TIER>(x0s, colss, batch, n, r, out, s);
#define BATCH_TIERS(NP)       \
  BATCH_CASE(NP, walk::kDf64) \
  BATCH_CASE(NP, walk::kF32)  \
  BATCH_CASE(NP, walk::kF32k) \
  BATCH_CASE(NP, walk::kTf96)
  if (tier < 0 || tier > 3) return (int)cudaErrorInvalidValue;
  switch (n_pad * 4 + tier) {
    BATCH_TIERS(16)
    BATCH_TIERS(24)
    BATCH_TIERS(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BATCH_TIERS
#undef BATCH_CASE
}
