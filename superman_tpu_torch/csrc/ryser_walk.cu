// Ryser walk over a list of chunk ids, for Hopper (sm_90a): tiers df64,
// f32, f32k and tf96.
//
// Replaces the TPU Pallas walk in superman_tpu/ops/ryser_pallas.py
// (_ryser_kernel, _ryser_kernel_u16 and _ryser_kernel_u16_multi behind the
// pallas_call of _partials_jit) for calc="df64", "f32", "f32k" and "tf96".
//
// What it computes: one thread walks one aligned chunk of 2^r Gray steps
// (walk.cuh, which also says what bounds the walk on this card and what
// the design does about it) and writes that chunk's partial sum as a
// (hi, lo) pair of the tier's type; the host adds hi + lo per chunk and
// sums the chunks in float64 (tf96: all words in long double).  Chunk ids
// < 0 are sentinels and write 0.  The TPU's f32-pair and f32-triple
// emulation, 16-step unroll, lane vectorisation and multi-block programs
// have no counterpart here.

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

template <int N_PAD, int TIER>
cudaError_t launch(const long long* ids, long long num_chunks, const void* x0,
                   const void* cols, int n, int r, void* out,
                   cudaStream_t stream) {
  using T = typename walk::Real<TIER>::type;
  const long long blocks = (num_chunks + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(n - 1) * N_PAD * sizeof(T);
  ryser_walk_kernel<N_PAD, TIER><<<(unsigned)blocks, kThreads, smem, stream>>>(
      ids, num_chunks, (const T*)x0, (const T*)cols, n, r, (T*)out);
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
