/* superman_native.h — C surface of the superman_tpu_torch native engine
 * (a copy of superman_tpu/bindings/superman_native.h; only this comment
 * and the build command below differ).
 *
 * Parity: the reference's matlab_calculate_return.h:1-24 (libConnect.so
 * facade), extended with the direct per-engine entry points.  Implemented
 * in native/perman_cpu.cpp; build with `python -m superman_tpu_torch.native.build`.
 */
#ifndef SUPERMAN_NATIVE_H
#define SUPERMAN_NATIVE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* direct engines: a is a row-major n*n double array.
 * calc_quad: 0 = double walk + long-double accumulate, 1 = __float128
 * walk (reference -q).  tests/test_tools.py compiles the engine with
 * this header included, so any signature drift fails CI. */
double sup_perman_dense(const double* a, int n, int threads, int calc_quad);
double sup_perman_sparse(const double* a, int n, int threads, int calc_quad);
double sup_perman_skipper(const double* a, int n, int threads, int calc_quad);
double sup_perman_dense_chunks(const double* a, int n,
                               const long long* chunk_ids, long long count,
                               int r, int threads);
double sup_rasmussen(const double* a, int n, long long trials, int threads,
                     unsigned long long seed, double* zeros_out);
double sup_approx_scaling(const double* a, int n, long long trials,
                          int scale_intervals, int scale_times, int threads,
                          unsigned long long seed, double* zeros_out);

/* exact modular engine (ops/exact.py CRT driver): per(a) mod p for an
 * integer matrix pre-reduced into [0, p); odd p < 2^62.  The batch form
 * runs one (matrix, prime) pair per OpenMP task. */
uint64_t sup_perman_mod(const uint64_t* a, int n, uint64_t p);
void sup_perman_mod_batch(const uint64_t* mats, int n, const uint64_t* ps,
                          int np, int threads, uint64_t* out);

/* libConnect-parity facade (reference interface_connector.c:61-231) */
double read_calculate_return(char* filename, int algorithm, int nt, int x,
                             int y, int z);
double matlab_calculate_return_int(const int* mat, int algorithm, int nt,
                                   int x, int y, int z, int nov, int nnz);
double matlab_calculate_return_double(const double* mat, int algorithm,
                                      int nt, int x, int y, int z, int nov,
                                      int nnz);
void connect(void);

#ifdef __cplusplus
}
#endif

#endif /* SUPERMAN_NATIVE_H */
