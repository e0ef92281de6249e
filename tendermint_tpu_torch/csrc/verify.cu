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
// threads. The warm K1 has only R to decompress, and one decompression
// per thread left the card mostly idle (320 warps on 528 schedulers at
// 10,240 signatures, each walking pow22523's chain of 255 squarings
// alone, 0.23 ms): it runs a quad of four threads per signature on the
// limb-split field product of fe25519.cuh, in which thread q forms limbs
// 5q .. 5q + 4 of each product (55 products a squaring, 100 a multiply),
// so 1,280 warps share the chains: 0.17 ms. Its registers are capped for
// one wave, as K3's below (168, no spill; uncapped it took 196 and ran in
// two waves, 0.20 ms), and the values sqrt_ratio needs after pow22523 are
// formed again after it, so that only the chain's own values are live
// across it. Its time grows with the batch from 5,120 signatures (0.12,
// 0.17, 0.28 ms at 5,120, 10,240 and 20,480), so the card's schedulers,
// not one chain's latency (0.09 ms at 2,560), bound it (inferred; no
// profiler reads the card), and no one part of a product holds most of
// it: without the gathers, the carries' exchange or the pair's exchange
// it ran 6%, 3% and 11% faster (tools/torch_ladder_ab.py, PERF.md). A
// pair of threads a signature, and gathers through shared memory,
// measured no faster. K2 runs a quad per signature on the quad point
// functions, as rlc.cu's K2. K3's ladder is sequential
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
// Shared design: as csrc/rlc.cu; the cold K1 calls the __noinline__
// decompress of fe25519.cuh, the warm K1 its inline split functions, K2
// and K3 its inline quad functions. Table select is a direct indexed load
// of entry s2 + 4 k2 (pallas_verify's 16-way masked select was a Mosaic
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

// The warm K1 runs a quad of threads per signature, K1C_THREADS / 4
// signatures a block, with registers capped for K1C_MIN_BLOCKS blocks an
// SM (the header note says why).
constexpr int K1C_THREADS = 64;
constexpr int K1C_MIN_BLOCKS = 5;

// K1 for a warm epoch — replaces pallas_verify._k1_decompress_kernel_cached
// (pallas_verify.py:263). The epoch table (rlc.cu epoch_coords_kernel)
// holds every validator's decompressed A in (4 * 32, vp) and its flag in
// (1, vp); idx[i] names signature i's column (padding signatures name
// column vp - 1, the identity). A quad per signature: thread q copies
// coordinate q of A from the table, unpacks the digits of bytes 8q .. 8q
// + 7 of s and of k (row-major s_rows and k_rows, (n, 32)), and the quad
// decompresses R from r_rows (n, 32) together on the limb-split field
// product (fe25519.cuh), thread q storing coordinate q of it; quad thread
// 0 writes both flags. So the JAX pipeline's device gather (4 * 32, n)
// and its r/s/k transposes do not exist. A quad past the end runs on a
// clamped signature with its stores masked. Bound: operations (the R
// decompressions); the copy is a few hundred bytes a thread.
__global__ void __launch_bounds__(K1C_THREADS, K1C_MIN_BLOCKS)
k1_decompress_cached_kernel(const int32_t* __restrict__ ctbl,
                            const int32_t* __restrict__ oktbl,
                            const int32_t* __restrict__ idx,
                            const uint8_t* __restrict__ r_rows,
                            const uint8_t* __restrict__ s_rows,
                            const uint8_t* __restrict__ k_rows,
                            int32_t* __restrict__ coords, int32_t* __restrict__ ok,
                            int32_t* __restrict__ sdig, int32_t* __restrict__ kdig,
                            int n, int vp) {
  const int q = threadIdx.x & 3;
  const int quad = blockIdx.x * (K1C_THREADS / 4) + (threadIdx.x >> 2);
  const bool live = quad < n;
  const int i = live ? quad : n - 1;
  const int col = idx[i];
  if (live) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int by = 8 * q + b;
      const int32_t sb = s_rows[(size_t)i * 32 + by], kb = k_rows[(size_t)i * 32 + by];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        sdig[(size_t)(d * 32 + by) * n + i] = (sb >> (2 * d)) & 3;
        kdig[(size_t)(d * 32 + by) * n + i] = (kb >> (2 * d)) & 3;
      }
    }
    store_fe(coords, q * 32, load_fe(ctbl, q * 32, col, vp), i, n);
  }
  fe x, y, t;
  const bool okr = split_decompress(x, y, t, r_rows + (size_t)i * 32, q);
  if (!live) return;
  store_fe(coords, (4 + q) * 32, pick(q == 0, x, pick(q == 1, y, pick(q == 2, fe_one(), t))), i,
           n);
  if (q == 0) {
    ok[i] = oktbl[col];
    ok[(size_t)n + i] = okr ? 1 : 0;
  }
}

// K2 runs a quad of threads per signature, K2_THREADS / 4 signatures a
// block, with registers capped for K2_MIN_BLOCKS blocks an SM (rlc.cu's K2
// settled the same shape by a sweep; ptxas: 168 registers, 0 bytes of
// stack, where the one-thread K2 it replaces had a 2,880-byte frame).
constexpr int K2_THREADS = 64;
constexpr int K2_MIN_BLOCKS = 5;

// Coordinate c of -A, point 0 of coords.
__device__ __forceinline__ fe neg_a_coord(const int32_t* __restrict__ coords, int c, int i,
                                          int n) {
  const fe v = load_fe(coords, c * 32, i, n);
  return (c == 0 || c == 3) ? neg(v) : v;
}

// K2 — replaces pallas_verify._k2_table_kernel (pallas_verify.py:286).
// A quad of four threads per signature builds the 16-entry table: entry
// s2 + 4 k2 (s2, k2 in 0..3) = [s2]B + [k2](-A), stored in Niels form at
// rows (e * 4 + c) * 32; thread q holds coordinate q of every point
// (fe25519.cuh quad functions) and stores coordinate q of every entry.
// As rlc.cu's K2 with the row P = B and the column Q = -A: the rows O, B,
// 2B, 3B stay in named registers (2B and 3B by the same double and add as
// the plain version, so every limb matches it), k2 walks outermost, and
// the column [k2](-A) is made as it is reached, -A loaded again for 3(-A)
// = 2(-A) + (-A). Bound: operations (13 point additions and doublings,
// 16 conversions per signature).
__global__ void __launch_bounds__(K2_THREADS, K2_MIN_BLOCKS)
k2_table_kernel(const int32_t* __restrict__ coords, int32_t* __restrict__ tbl, int n) {
  const int q = threadIdx.x & 3;
  const int quad = blockIdx.x * (K2_THREADS / 4) + (threadIdx.x >> 2);
  const int i = quad < n ? quad : n - 1;  // a quad past the end runs masked
  const pt b = base_point();
  const fe o = quad_identity(q);
  const fe p1 = pick(q == 0, b.x, pick(q == 1, b.y, pick(q == 2, b.z, b.t)));
  const fe p2 = quad_double(p1, q, true);
  const fe p3 = quad_add(p2, p1, q);
  fe col = o;  // [k2](-A)
#pragma unroll 1
  for (int k2 = 0; k2 < 4; ++k2) {
    if (k2 == 1)
      col = neg_a_coord(coords, q, i, n);
    else if (k2 == 2)
      col = quad_double(col, q, true);
    else if (k2 == 3)
      col = quad_add(col, neg_a_coord(coords, q, i, n), q);
#pragma unroll 1
    for (int s2 = 0; s2 < 4; ++s2) {
      const fe row = pick(s2 == 1, p1, pick(s2 == 2, p2, pick(s2 == 3, p3, o)));
      const fe ent = k2 == 0 ? row : s2 == 0 ? col : quad_add(row, col, q);
      const fe nl = quad_to_niels(ent, q);
      if (quad < n) store_fe(tbl, ((s2 + 4 * k2) * 4 + q) * 32, nl, i, n);
    }
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
// cudaGetLastError() of its launch. The cold K1's grid is ceil(n /
// VTHREADS) blocks, a thread per (signature, point), with the tail masked
// in the kernel (fe25519.cuh sig_grid); the warm K1's is ceil(4 n /
// K1C_THREADS), K2's ceil(4 n / K2_THREADS) and K3's ceil(4 n /
// K3_THREADS), a quad of threads a signature, with the tail masked per
// quad.

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
  const dim3 grid((4 * n + edw::K1C_THREADS - 1) / edw::K1C_THREADS);
  edw::k1_decompress_cached_kernel<<<grid, edw::K1C_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ctbl, (const int32_t*)oktbl, (const int32_t*)idx,
      (const uint8_t*)r_rows, (const uint8_t*)s_rows, (const uint8_t*)k_rows,
      (int32_t*)coords, (int32_t*)ok, (int32_t*)sdig, (int32_t*)kdig, n, vp);
  return (int)cudaGetLastError();
}

extern "C" int tm_k2_table(const void* coords, void* tbl, int n, void* stream) {
  const dim3 grid((4 * n + edw::K2_THREADS - 1) / edw::K2_THREADS);
  edw::k2_table_kernel<<<grid, edw::K2_THREADS, 0, (cudaStream_t)stream>>>(
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
