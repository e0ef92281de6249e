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
// threads; K2 runs a thread per signature. K3's ladder is sequential
// within a signature, so a quad of four threads shares it, as in the RLC
// K3 (fe25519.cuh quad functions): thread q holds coordinate q of the
// accumulator, computes product q of each round of a double or an add,
// and loads only the table coordinate it multiplies. At 10,240 signatures
// that is 40,960 threads in 640 blocks of 64 (16 signatures a block).
// __launch_bounds__(64, 5) caps the registers at 204; ptxas then uses 168,
// six blocks fit an SM, and all 640 blocks are resident at once (4 or 5 an
// SM, 8 to 10 warps). Uncapped, ptxas took 205 registers, only 4 blocks
// fit, and the 112 blocks of a second wave made it 2.30 ms against 2.19
// (tools/torch_ladder_ab.py, PERF.md). ptxas: 168 registers, 0 bytes of
// stack frame, no spills, no local loads or stores in its SASS (the
// one-thread K3 it replaces: 128 registers and a 960-byte stack frame).
// What bounds K3 now is inferred from a batch sweep, not measured (ncu
// could not read the card's counters where it was timed): from 10,240
// signatures up its time grows in step with the batch, which fits a card
// whose schedulers are all busy issuing integer instructions (PERF.md has
// its time beside the bound).
//
// Shared design: as csrc/rlc.cu; K1 and K2 call the __noinline__ point
// functions of fe25519.cuh, K3 its inline quad functions. Table select is
// a direct indexed load of entry s2 + 4 k2 (pallas_verify's 16-way masked
// select was a Mosaic constraint); verification handles public data, so
// nothing here is constant time.

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

// K3 runs a quad of threads per signature, K3_THREADS / 4 signatures a
// block, with registers capped for K3_MIN_BLOCKS blocks an SM (the header
// note says why).
constexpr int K3_THREADS = 64;
constexpr int K3_MIN_BLOCKS = 5;

// K3 — replaces pallas_verify._k3_ladder_kernel (pallas_verify.py:329).
// A quad of four threads runs one signature's 127-iteration joint ladder
// (fe25519.cuh quad functions): per iteration a double that skips T, a
// double that makes it, and a Niels add of entry s2 + 4 k2 that skips T.
// Each thread loads only the table coordinate it multiplies, before the
// iteration's doubles, so the load is in flight while they run. Then
// [8]acc == [8]R, ANDed with the two decompression flags and the host
// s < L flag, in quad thread 0.
__global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS)
k3_ladder_kernel(const int32_t* __restrict__ tbl, const int32_t* __restrict__ sdig,
                 const int32_t* __restrict__ kdig,
                 const int32_t* __restrict__ coords, const int32_t* __restrict__ ok,
                 const int32_t* __restrict__ sok, int32_t* __restrict__ out,
                 int n) {
  const int q = threadIdx.x & 3;
  const int quad = blockIdx.x * (K3_THREADS / 4) + (threadIdx.x >> 2);
  const int i = quad < n ? quad : n - 1;  // a quad past the end runs masked
  const int c = niels_coord(q);
  fe acc = quad_identity(q);
#pragma unroll 1
  for (int it = 0; it < 127; ++it) {
    const int pos = 126 - it;
    const int j = (pos & 3) * 32 + (pos >> 2);
    const int e = sdig[(size_t)j * n + i] + 4 * kdig[(size_t)j * n + i];
    const fe ent = load_fe(tbl, (e * 4 + c) * 32, i, n);
#pragma unroll 1
    for (int d = 0; d < 2; ++d) acc = quad_double(acc, q, d == 1);
    acc = quad_add_niels(acc, ent, q, false);
  }
  const fe r = load_fe(coords, (4 + q) * 32, i, n);  // R
  const bool eq8 = quad_cofactor_eq(acc, r, q);
  if (q != 0 || quad >= n) return;
  out[i] = (ok[i] != 0 && ok[(size_t)n + i] != 0 && sok[i] != 0 && eq8) ? 1 : 0;
}

}  // namespace edw

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. The grid is ceil(n / VTHREADS) blocks
// with the tail masked in the kernel (fe25519.cuh sig_grid); K3's is
// ceil(4 n / K3_THREADS), a quad a signature, with the tail masked per quad.

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
  const dim3 grid((4 * n + edw::K3_THREADS - 1) / edw::K3_THREADS);
  edw::k3_ladder_kernel<<<grid, edw::K3_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, (const int32_t*)sdig, (const int32_t*)kdig,
      (const int32_t*)coords, (const int32_t*)ok, (const int32_t*)sok,
      (int32_t*)out, n);
  return (int)cudaGetLastError();
}
