// Ryser walk, df64 tier, for Hopper (sm_90a).
//
// Replaces the TPU Pallas walk in superman_tpu/ops/ryser_pallas.py
// (_walk_scalar / _walk_u16 behind the pallas_call of _partials_jit) for
// calc="df64", and folds in its XLA prologue (superman_tpu/ops/gray.py
// chunk_init).
//
// What it computes: the Nijenhuis-Wilf Gray-code Ryser sum is cut into
// aligned chunks of 2^r steps.  One thread walks one chunk: it builds x
// from the chunk's Gray bits, then at step m = 1 .. 2^r-1 adds +-column
// k = ctz(m) to x and accumulates (-1)^m * prod(x).  It writes the chunk's
// partial sum as a (hi, lo) double pair; the host adds hi + lo per chunk
// and sums the chunks in float64.  Chunk ids < 0 are sentinels and write 0.
//
// What bounds it on this card: FP64 arithmetic, about n multiplies for the
// product plus n adds for the x update per step, and no device-memory
// traffic inside the loop.  The design keeps it there: x lives in
// registers (N_PAD is a template parameter, so every row loop unrolls),
// and the column table sits in shared memory, where all threads of a warp
// read the same column k at the same step -- a broadcast, with no bank
// conflicts.  The TPU's f32-pair emulation, 16-step unroll, lane
// vectorisation and multi-block programs have no counterpart here.
//
// Arithmetic: x and the products are IEEE double; the accumulator is a
// compensated double-double (TwoSum, then a renormalising FastTwoSum).
// Build without fast-math: the sums are add-only, so nvcc's default FMA
// contraction cannot break them, and the one contractible product,
// s * col with s = +-1, is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// p[0] = product of p[0..S): fold the upper half onto the lower half,
// p[i] *= p[i + ceil(S/2)], until one element is left.  The plain version
// (ops/ryser_cuda.py tree_prod) multiplies in the same order.
template <int S, int N>
__device__ __forceinline__ void fold_prod(double (&p)[N]) {
  if constexpr (S > 1) {
    constexpr int NS = (S + 1) / 2;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) p[i] *= p[i + NS];
    fold_prod<NS, N>(p);
  }
}

template <int N_PAD>
__device__ __forceinline__ double tree_prod(const double (&x)[N_PAD]) {
  double p[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) p[i] = x[i];
  fold_prod<N_PAD, N_PAD>(p);
  return p[0];
}

// (hi, lo) += t, as the reference's df_add with a zero low word on t.
__device__ __forceinline__ void df_add(double& hi, double& lo, double t) {
  const double s = hi + t;
  const double z = s - hi;
  double e = (hi - (s - z)) + (t - z);
  e += lo;
  hi = s + e;
  lo = e - (hi - s);
}

template <int N_PAD>
__global__ void __launch_bounds__(kThreads)
ryser_walk_kernel(const long long* __restrict__ ids, long long num_chunks,
                  const double* __restrict__ x0,
                  const double* __restrict__ cols, int n, int r,
                  double* __restrict__ out) {
  extern __shared__ double col_s[];  // [(n-1) * N_PAD], column k at k*N_PAD
  const int ncol = n - 1;
  for (int i = threadIdx.x; i < ncol * N_PAD; i += blockDim.x)
    col_s[i] = cols[i];
  __syncthreads();

  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_chunks) return;
  const long long l = ids[c];
  if (l < 0) {
    out[2 * c] = 0.0;
    out[2 * c + 1] = 0.0;
    return;
  }

  // prologue (gray.chunk_init): x = x0 + the columns whose bit is set in
  // gray(l * 2^r); bit b >= r is gray(l) >> (b - r), bit r-1 is l & 1
  double x[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) x[i] = x0[i];
  const unsigned long long ul = (unsigned long long)l;
  const unsigned long long gl = ul ^ (ul >> 1);
  for (int b = 0; b < ncol; ++b) {
    const unsigned long long bit =
        b >= r ? (gl >> (b - r)) & 1ull : (b == r - 1 ? ul & 1ull : 0ull);
    if (bit) {
      const double* ck = col_s + b * N_PAD;
#pragma unroll
      for (int i = 0; i < N_PAD; ++i) x[i] += ck[i];
    }
  }
  const double smid = (ul & 1ull) ? -1.0 : 1.0;

  double hi = tree_prod<N_PAD>(x);  // m = 0: base index even, sign +1
  double lo = 0.0;
  const unsigned long long steps = 1ull << r;
  for (unsigned long long m = 1; m < steps; ++m) {
    const int k = __ffsll((long long)m) - 1;
    // x-sign +1 iff bit k+1 of m is 0; at the mid step (k == r-1) it is
    // the chunk parity instead
    double s = ((m >> (k + 1)) & 1ull) ? -1.0 : 1.0;
    if (k == r - 1) s = smid;
    const double* ck = col_s + k * N_PAD;
#pragma unroll
    for (int i = 0; i < N_PAD; ++i) x[i] += s * ck[i];
    const double t = tree_prod<N_PAD>(x);
    df_add(hi, lo, (m & 1ull) ? -t : t);  // term sign (-1)^m
  }
  out[2 * c] = hi;
  out[2 * c + 1] = lo;
}

template <int N_PAD>
cudaError_t launch(const long long* ids, long long num_chunks,
                   const double* x0, const double* cols, int n, int r,
                   double* out, cudaStream_t stream) {
  const long long blocks = (num_chunks + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(n - 1) * N_PAD * sizeof(double);
  ryser_walk_kernel<N_PAD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      ids, num_chunks, x0, cols, n, r, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (ops/ryser_cuda.py).  Launches on
// `stream` of `device`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int ryser_walk_df64(const long long* ids, long long num_chunks,
                               const double* x0, const double* cols, int n,
                               int n_pad, int r, double* out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 3 || n > n_pad || r < 1 || r > n - 2 || num_chunks < 0 ||
      (num_chunks + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (num_chunks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_pad) {
    case 8: return (int)launch<8>(ids, num_chunks, x0, cols, n, r, out, s);
    case 16: return (int)launch<16>(ids, num_chunks, x0, cols, n, r, out, s);
    case 24: return (int)launch<24>(ids, num_chunks, x0, cols, n, r, out, s);
    case 32: return (int)launch<32>(ids, num_chunks, x0, cols, n, r, out, s);
    case 40: return (int)launch<40>(ids, num_chunks, x0, cols, n, r, out, s);
    case 48: return (int)launch<48>(ids, num_chunks, x0, cols, n, r, out, s);
    case 56: return (int)launch<56>(ids, num_chunks, x0, cols, n, r, out, s);
    case 64: return (int)launch<64>(ids, num_chunks, x0, cols, n, r, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
