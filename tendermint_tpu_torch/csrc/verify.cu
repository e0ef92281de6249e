// The per-signature ZIP-215 kernels (one ladder per signature) for sm_90a.
//
// Counterpart: tendermint_tpu/ops/pallas_verify.py; plain PyTorch
// versions: tendermint_tpu_torch/ops/verify.py (k1_decompress_plain,
// k1_decompress_cached_plain, k2_table_plain, k3_ladder_plain), which
// these kernels match limb for limb. Global arrays keep the JAX layout,
// (rows, n) with the signature last (fe25519.cuh).
//
// What bounds them. The work is 32-bit multiply-adds of the limb
// convolutions: 400 per field multiply, 210 per squaring. Counted from the
// formulas (chip_smoke.py counts them by running the plain versions), per
// signature:
//   K1  123,100: 2 decompressions (A and R) of 255 squarings + 20
//       multiplies, most of it pow22523
//   K1 cached  61,550: the R decompression; A comes from the epoch table
//   K2  50,880: 2 doubles, 2 triples, 9 cross sums and 16 Niels
//       conversions for the table [s2]B + [k2](-A)
//   K3  938,400: 127 iterations of 2 doubles and 1 Niels add, then 6
//       doubles and the cross-multiplied test
// against 132 SMs x 64 INT32 lanes per clock at the SM clock nvidia-smi
// reports (1,980 MHz on an H100 80GB HBM3 at 700 W). At 10,240 signatures
// that is 0.075, 0.038 (cached), 0.031 and 0.58 ms. The bytes each
// kernel moves (22, 94 and 105 MB) take 0.007 to 0.03 ms at 3.35 TB/s, so
// all four are bound by operations.
//
// What the design does about it: the signatures are the parallelism. K1
// runs a thread per (signature, point), so A and R decompress in two
// threads; K2 and K3 run a thread per signature: at 10,240 signatures, 80
// blocks of 128, one warp per scheduler on 80 of the 132 SMs. The ladder
// is sequential within a signature, as in the RLC K3, but there is one
// ladder per signature instead of one per 4, so four times the threads do
// about half the work each (PERF.md has the times of both paths).
//
// Shared design: as csrc/rlc.cu; point functions are __noinline__ and
// come from fe25519.cuh. Table select is a direct indexed load of entry
// s2 + 4 k2 (pallas_verify's 16-way masked select was a Mosaic
// constraint); verification handles public data, so nothing here is
// constant time.

#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace edw {

// K1 — replaces pallas_verify._k1_decompress_kernel (pallas_verify.py:239).
// Thread (i, p), p = blockIdx.y: p = 0 unpacks the digits of s and
// decompresses A (point 0 of coords); p = 1 the digits of k and R (point
// 1). Bound: operations (the decompressions); A and R of a signature are
// independent, so they run in two threads.
__global__ void __launch_bounds__(VTHREADS)
k1_decompress_kernel(const uint8_t* __restrict__ a_t,
                     const uint8_t* __restrict__ r_t,
                     const uint8_t* __restrict__ s_t,
                     const uint8_t* __restrict__ k_t,
                     int32_t* __restrict__ coords, int32_t* __restrict__ ok,
                     int32_t* __restrict__ sdig, int32_t* __restrict__ kdig,
                     int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (i >= n) return;
  store_digits(p == 0 ? sdig : kdig, 0, (p == 0 ? s_t : k_t) + i, n, i, n);
  const uint8_t* src = p == 0 ? a_t : r_t;
  int32_t e[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) e[b] = src[(size_t)b * n + i];
  pt P;
  const bool okp = decompress(P, e);
  ok[(size_t)p * n + i] = okp ? 1 : 0;
  store_point(coords, p, P, i, n);
}

// K1 for a warm epoch — replaces pallas_verify._k1_decompress_kernel_cached
// (pallas_verify.py:263). The epoch table (rlc.cu epoch_coords_kernel)
// holds every validator's decompressed A in (4 * 32, vp) and its flag in
// (1, vp); idx[i] names signature i's column (padding signatures name
// column vp - 1, the identity). Thread (i, p): p = 0 unpacks the digits
// of s from the row-major s_rows (n, 32) and copies A and its flag from
// the table; p = 1 unpacks the digits of k and decompresses R from
// r_rows (n, 32). So the JAX pipeline's device gather (4 * 32, n) and its
// r/s/k transposes do not exist. Bound: operations (the R
// decompressions); the copy is a few hundred bytes a thread.
__global__ void __launch_bounds__(VTHREADS)
k1_decompress_cached_kernel(const int32_t* __restrict__ ctbl,
                            const int32_t* __restrict__ oktbl,
                            const int32_t* __restrict__ idx,
                            const uint8_t* __restrict__ r_rows,
                            const uint8_t* __restrict__ s_rows,
                            const uint8_t* __restrict__ k_rows,
                            int32_t* __restrict__ coords, int32_t* __restrict__ ok,
                            int32_t* __restrict__ sdig, int32_t* __restrict__ kdig,
                            int n, int vp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (i >= n) return;
  store_digits(p == 0 ? sdig : kdig, 0, (p == 0 ? s_rows : k_rows) + (size_t)i * 32, 1,
               i, n);
  if (p == 0) {
    const int col = idx[i];
#pragma unroll 1
    for (int c = 0; c < 4; ++c)
      store_fe(coords, c * 32, load_fe(ctbl, c * 32, col, vp), i, n);
    ok[i] = oktbl[col];
    return;
  }
  const uint8_t* src = r_rows + (size_t)i * 32;
  int32_t e[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) e[b] = src[b];
  pt P;
  const bool okp = decompress(P, e);
  ok[(size_t)n + i] = okp ? 1 : 0;
  store_point(coords, 1, P, i, n);
}

// K2 — replaces pallas_verify._k2_table_kernel (pallas_verify.py:286).
// One thread per signature builds the 16-entry table: entry s2 + 4 k2
// (s2, k2 in 0..3) = [s2]B + [k2](-A), stored in Niels form at rows
// (e * 4 + c) * 32. 2B and 3B are computed per thread by the same
// formulas as the JAX body, so every entry matches it limb for limb.
// Bound: operations (13 point additions and doublings, 16 conversions).
__global__ void __launch_bounds__(VTHREADS)
k2_table_kernel(const int32_t* __restrict__ coords, int32_t* __restrict__ tbl,
                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  pt brow[4], acol[4];  // [O, B, 2B, 3B] and [O, -A, -2A, -3A]
  brow[0] = identity_point();
  acol[0] = identity_point();
  brow[1] = base_point();
  acol[1] = point_neg(load_point(coords, 0, i, n));
  point_double(brow[2], brow[1], true);
  point_double(acol[2], acol[1], true);
  point_add(brow[3], brow[2], brow[1]);
  point_add(acol[3], acol[2], acol[1]);
#pragma unroll 1
  for (int e = 0; e < 16; ++e) {
    const int s2 = e & 3, k2 = e >> 2;
    pt ent;
    if (k2 == 0)
      ent = brow[s2];
    else if (s2 == 0)
      ent = acol[k2];
    else
      point_add(ent, brow[s2], acol[k2]);
    to_niels(ent, ent);
    store_point(tbl, e, ent, i, n);
  }
}

// K3 — replaces pallas_verify._k3_ladder_kernel (pallas_verify.py:329).
// One thread per signature runs the 127-iteration joint ladder
// (fe25519.cuh ladder). Then [8]acc == [8]R by six T-free doubles and a
// projective cross-multiplication, ANDed with the two decompression flags
// and the host s < L flag. Bound: operations (the ladder), sequential
// within a signature.
__global__ void __launch_bounds__(VTHREADS)
k3_ladder_kernel(const int32_t* __restrict__ tbl, const int32_t* __restrict__ sdig,
                 const int32_t* __restrict__ kdig,
                 const int32_t* __restrict__ coords, const int32_t* __restrict__ ok,
                 const int32_t* __restrict__ sok, int32_t* __restrict__ out,
                 int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  pt acc;
  ladder(acc, tbl, sdig, kdig, i, n);
  pt r8 = load_point(coords, 1, i, n);  // R
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    point_double(acc, acc, false);
    point_double(r8, r8, false);
  }
  const bool valid = ok[i] != 0 && ok[(size_t)n + i] != 0 && sok[i] != 0 &&
                     is_zero(sub(mul(acc.x, r8.z), mul(r8.x, acc.z))) &&
                     is_zero(sub(mul(acc.y, r8.z), mul(r8.y, acc.z)));
  out[i] = valid ? 1 : 0;
}

}  // namespace edw

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. The grid is ceil(n / VTHREADS) blocks
// with the tail masked in the kernel (fe25519.cuh sig_grid).

using edw::sig_grid;

extern "C" int tm_k1_decompress(const void* a_t, const void* r_t, const void* s_t,
                                const void* k_t, void* coords, void* ok,
                                void* sdig, void* kdig, int n, void* stream) {
  edw::k1_decompress_kernel<<<sig_grid(n, 2), edw::VTHREADS, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)a_t, (const uint8_t*)r_t, (const uint8_t*)s_t,
      (const uint8_t*)k_t, (int32_t*)coords, (int32_t*)ok, (int32_t*)sdig,
      (int32_t*)kdig, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_k1_decompress_cached(const void* ctbl, const void* oktbl,
                                       const void* idx, const void* r_rows,
                                       const void* s_rows, const void* k_rows,
                                       void* coords, void* ok, void* sdig, void* kdig,
                                       int n, int vp, void* stream) {
  edw::k1_decompress_cached_kernel<<<sig_grid(n, 2), edw::VTHREADS, 0,
                                    (cudaStream_t)stream>>>(
      (const int32_t*)ctbl, (const int32_t*)oktbl, (const int32_t*)idx,
      (const uint8_t*)r_rows, (const uint8_t*)s_rows, (const uint8_t*)k_rows,
      (int32_t*)coords, (int32_t*)ok, (int32_t*)sdig, (int32_t*)kdig, n, vp);
  return (int)cudaGetLastError();
}

extern "C" int tm_k2_table(const void* coords, void* tbl, int n, void* stream) {
  edw::k2_table_kernel<<<sig_grid(n, 1), edw::VTHREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)coords, (int32_t*)tbl, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_k3_ladder(const void* tbl, const void* sdig, const void* kdig,
                            const void* coords, const void* ok, const void* sok,
                            void* out, int n, void* stream) {
  edw::k3_ladder_kernel<<<sig_grid(n, 1), edw::VTHREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, (const int32_t*)sdig, (const int32_t*)kdig,
      (const int32_t*)coords, (const int32_t*)ok, (const int32_t*)sok,
      (int32_t*)out, n);
  return (int)cudaGetLastError();
}
