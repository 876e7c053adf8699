// Ryser walk in Z_p, for Hopper (sm_90a).
//
// Replaces the TPU Pallas walk in superman_tpu/ops/modp.py (_mod_kernel*,
// bodies _walk_mod_scalar / _walk_mod_u16 behind the pallas_call of
// _mod_partials_jit), and folds in its XLA prologue (chunk_init_mod).
//
// What it computes: the Nijenhuis-Wilf Gray-code Ryser sum in Z_p, cut
// into aligned chunks of 2^r steps.  One thread walks one chunk: it builds
// x from the chunk's Gray bits, then at step m = 1 .. 2^r-1 adds +-column
// k = ctz(m) to x and accumulates (-1)^m * prod(x), all mod p.  It writes
// the chunk's sum as a canonical residue in [0, p); the host adds the
// residues in int64 and reduces once.  Chunk ids < 0 are sentinels and
// write 0.
//
// Arithmetic: odd p < 2^31, residues as uint32 in Montgomery form
// (R = 2^32).  A product is a 32x32->64 multiply and a REDC with one
// conditional subtract; the x update is x + c or x + (p - c) with one
// conditional subtract; the accumulator stays in [0, p).  p, -p^-1 mod
// 2^32 and R^2 mod p are arguments, so N_PAD is the only compile key.
// The TPU walked p <= 2039 as lazy f32 residues because its vector unit
// has no integer multiplier; the card's does, so one 31-bit prime here
// carries about 2.8 times the CRT bits of one of those.
//
// What bounds it on this card: 32-bit integer multiply-adds, about
// 3 IMADs and 4 other integer instructions per Montgomery product and
// N_PAD - 1 products per step, with no device-memory traffic inside the
// loop.  As in ryser_walk.cu, x lives in registers (N_PAD is a template
// parameter, so every row loop unrolls) and the column table sits in
// shared memory, where all threads of a warp read the same column k at
// the same step -- a broadcast.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;

// a * b / 2^32 mod p, for a * b < 2^32 * p; the result is in [0, p).
// t + m * p < 2^33 * p < 2^64 because p < 2^31, and its low word is 0.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pinv) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * pinv;
  const uint32_t u = (uint32_t)((t + (uint64_t)m * p) >> 32);
  return u >= p ? u - p : u;
}

// q[0] = product of q[0..S) in Montgomery form: fold the upper half onto
// the lower half until one element is left (in Z_p the order is free).
template <int S, int N>
__device__ __forceinline__ void fold_prod(uint32_t (&q)[N], uint32_t p,
                                          uint32_t pinv) {
  if constexpr (S > 1) {
    constexpr int NS = (S + 1) / 2;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) q[i] = mont_mul(q[i], q[i + NS], p, pinv);
    fold_prod<NS, N>(q, p, pinv);
  }
}

template <int N_PAD>
__device__ __forceinline__ uint32_t tree_prod(const uint32_t (&x)[N_PAD],
                                              uint32_t p, uint32_t pinv) {
  uint32_t q[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) q[i] = x[i];
  fold_prod<N_PAD, N_PAD>(q, p, pinv);
  return q[0];
}

template <int N_PAD>
__global__ void __launch_bounds__(kThreads)
modp_walk_kernel(const long long* __restrict__ ids, long long num_chunks,
                 const long long* __restrict__ x0,
                 const long long* __restrict__ cols, int n, int r,
                 uint32_t p, uint32_t pinv, uint32_t r2,
                 long long* __restrict__ out) {
  // [(n-1) * N_PAD] Montgomery residues, column k at k*N_PAD
  extern __shared__ uint32_t col_s[];
  const int ncol = n - 1;
  for (int i = threadIdx.x; i < ncol * N_PAD; i += blockDim.x)
    col_s[i] = mont_mul((uint32_t)cols[i], r2, p, pinv);
  __syncthreads();

  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_chunks) return;
  const long long l = ids[c];
  if (l < 0) {
    out[c] = 0;
    return;
  }

  // prologue (modp.chunk_init_mod): x = x0 + the columns whose bit is set
  // in gray(l * 2^r), summed in 64 bits and reduced once; bit b >= r is
  // gray(l) >> (b - r), bit r-1 is l & 1
  uint64_t s[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) s[i] = mont_mul((uint32_t)x0[i], r2, p, pinv);
  const uint64_t ul = (uint64_t)l;
  const uint64_t gl = ul ^ (ul >> 1);
  for (int b = 0; b < ncol; ++b) {
    const uint64_t bit =
        b >= r ? (gl >> (b - r)) & 1ull : (b == r - 1 ? ul & 1ull : 0ull);
    if (bit) {
      const uint32_t* ck = col_s + b * N_PAD;
#pragma unroll
      for (int i = 0; i < N_PAD; ++i) s[i] += ck[i];
    }
  }
  uint32_t x[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) x[i] = (uint32_t)(s[i] % p);
  const bool odd = (ul & 1ull) != 0;

  uint32_t acc = tree_prod<N_PAD>(x, p, pinv);  // m = 0: sign +1
  const uint64_t steps = 1ull << r;
  for (uint64_t m = 1; m < steps; ++m) {
    const int k = __ffsll((long long)m) - 1;
    // subtract the column iff bit k+1 of m is set; at the mid step
    // (k == r-1) the chunk parity decides instead
    bool neg = ((m >> (k + 1)) & 1ull) != 0;
    if (k == r - 1) neg = odd;
    const uint32_t* ck = col_s + k * N_PAD;
#pragma unroll
    for (int i = 0; i < N_PAD; ++i) {
      const uint32_t cv = ck[i];
      const uint32_t v = x[i] + (neg ? p - cv : cv);
      x[i] = v >= p ? v - p : v;
    }
    const uint32_t t = tree_prod<N_PAD>(x, p, pinv);
    const uint32_t v = acc + ((m & 1ull) ? p - t : t);  // sign (-1)^m
    acc = v >= p ? v - p : v;
  }
  out[c] = (long long)mont_mul(acc, 1u, p, pinv);  // out of Montgomery form
}

template <int N_PAD>
cudaError_t launch(const long long* ids, long long num_chunks,
                   const long long* x0, const long long* cols, int n, int r,
                   uint32_t p, uint32_t pinv, uint32_t r2, long long* out,
                   cudaStream_t stream) {
  const long long blocks = (num_chunks + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(n - 1) * N_PAD * sizeof(uint32_t);
  modp_walk_kernel<N_PAD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      ids, num_chunks, x0, cols, n, r, p, pinv, r2, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (ops/modp_cuda.py).  Launches on
// `stream` of `device`, allocates nothing, does not synchronise, leaves
// the caller's current device as it was (device_guard.cuh), and returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int modp_walk(const long long* ids, long long num_chunks,
                         const long long* x0, const long long* cols, int n,
                         int n_pad, int r, unsigned p, unsigned pinv,
                         unsigned r2, long long* out, int device,
                         void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (n < 2 || n > n_pad || r < 1 || r > n - 1 || num_chunks < 0 ||
      (num_chunks + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (p < 3 || p >= (1u << 31) || (p & 1u) == 0 || p * pinv != 0xffffffffu ||
      r2 >= p)
    return (int)cudaErrorInvalidValue;
  if (num_chunks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_pad) {
    case 8: return (int)launch<8>(ids, num_chunks, x0, cols, n, r, p, pinv, r2, out, s);
    case 16: return (int)launch<16>(ids, num_chunks, x0, cols, n, r, p, pinv, r2, out, s);
    case 24: return (int)launch<24>(ids, num_chunks, x0, cols, n, r, p, pinv, r2, out, s);
    case 32: return (int)launch<32>(ids, num_chunks, x0, cols, n, r, p, pinv, r2, out, s);
    case 40: return (int)launch<40>(ids, num_chunks, x0, cols, n, r, p, pinv, r2, out, s);
    case 48: return (int)launch<48>(ids, num_chunks, x0, cols, n, r, p, pinv, r2, out, s);
    case 56: return (int)launch<56>(ids, num_chunks, x0, cols, n, r, p, pinv, r2, out, s);
    case 64: return (int)launch<64>(ids, num_chunks, x0, cols, n, r, p, pinv, r2, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
