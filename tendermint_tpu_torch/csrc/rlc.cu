// The RLC fast-accept kernels (M = 4 signatures per lane) and the epoch
// table build, for sm_90a.
//
// Counterpart: tendermint_tpu/ops/pallas_rlc.py and the device half of
// ops/epoch_cache.py; plain PyTorch versions: tendermint_tpu_torch/ops/
// rlc.py (k1_rlc_plain, k1_rlc_cached_plain, k2_rlc_plain, k3_rlc_plain)
// and ops/epoch_cache.py (epoch_coords_plain), which these kernels match
// limb for limb. Global arrays keep the JAX layout (fe25519.cuh).
//
// What bounds them. The work is 32-bit multiply-adds of the limb
// convolutions: 400 per field multiply, 210 per squaring. Counted from the
// formulas (chip_smoke.py counts them by running the plain versions), per
// lane, or per row for the table:
//   K1         492,400: 8 decompressions of 255 squarings + 20 multiplies,
//              most of it pow22523
//   K1 cached  246,200: the 4 R decompressions; the 4 A come from the table
//   K2         203,520: 4 tables of 2 doubles, 2 triples, 9 cross sums and
//              16 Niels conversions
//   K3         1,956,000: 127 iterations of 2 doubles and 3 or 4 Niels
//              adds, then 6 doubles and the cross-multiplied test
//   table      one point a row on the wide field (below): 15,941 wide
//              products and 3,104 32-bit multiplies (61,550
//              multiply-adds on the 13-bit formulas)
// against 132 SMs x 64 INT32 lanes per clock at the SM clock nvidia-smi
// reports (1,980 MHz on an H100 80GB HBM3 at 700 W). At 2,560 lanes (10,240
// signatures) that is 0.075, 0.038, 0.031 and 0.30 ms. The bytes each
// moves (22, 30, 94, 105 and 9 MB) take 0.003 to 0.03 ms at 3.35 TB/s, so
// all are bound by operations. K1 and the table run on the wide field of
// fe25519.cuh instead: a point is 15,941 32 x 32 -> 64 products and 3,104
// 32-bit multiplies, 8 a lane for K1 and one a row for the table, 0.050
// ms at 2,560 lanes and 0.040 ms at 16,384 rows with a wide product at the
// 27.11 an SM issues a clock (chip_smoke.py wide_multiplies,
// tools/torch_imad_rate.py).
//
// What the design does about it: the lanes are the parallelism. K1 runs a
// thread per (lane, point), so its independent work spreads over 8 times
// the threads, 640 warps at 2,560 lanes; its decompression runs inline
// (no call, no stack frame) with pow22523's chain and sqrt_ratio's
// products on the wide field, 176 instructions a squaring against about
// 450 on the 13-bit limbs: 0.13 ms against 0.22 for the 13-bit
// decompression out of line, 168 registers (tools/torch_ladder_ab.py,
// PERF.md). One warp alone on a scheduler takes 0.10 ms, the time up to
// 1,280 lanes, so the 112 schedulers that hold two of the 640 warps set
// it. The table runs the same inline decompress_wide, a thread per row,
// once per validator set: 16,384 rows are 512 warps on the card's 528
// schedulers, each alone on its scheduler, so it takes the lone chain's
// 0.10 ms (0.099 against 0.156 for the 13-bit decompression out of line,
// in blocks of 64 or 128 alike; H100 80GB HBM3, 700 W,
// tools/torch_ladder_ab.py, PERF.md).
// The warm K1 has only the M R decompressions to do, and one
// decompression a thread left the card mostly idle (320 warps on 528
// schedulers at 2,560 lanes, each walking pow22523's chain alone, 0.23
// ms): it runs a quad of four threads per (lane, slot) on the limb-split
// field product of fe25519.cuh, as verify.cu's warm K1 does, so that at
// 2,560 lanes 40,960 threads in blocks of 64 share the chains, with
// __launch_bounds__(64, 5) holding it to 168 registers for one wave: 0.16
// ms against its bound of 0.038, 164 registers, 0 bytes of stack
// (tools/torch_ladder_ab.py, PERF.md). From 2,560 lanes up its time grows
// almost in step with the batch (0.091, 0.114, 0.164, 0.293 and 0.599 ms
// at 640 to 10,240 lanes), as the per-signature warm K1's does, so the
// split's own instructions on full schedulers hold it (inferred; no
// profiler reads the card's counters).
// K2 runs a quad of four threads per (lane, table) on the quad point
// functions: at 2,560 lanes 40,960 threads in 640 blocks of 64, with
// __launch_bounds__(64, 5) holding it to 168 registers, so that 10 warps
// fit an SM and the grid is one wave; uncapped it took 230 registers, 8
// warps an SM, and 0.21 ms against 0.14 (tools/torch_ladder_ab.py,
// PERF.md). Its points stay in registers: points passed to out-of-line
// functions, and point arrays indexed at run time, live in a stack frame
// (2,880 bytes in a one-thread K2, which took 0.50 ms). K3's ladder is
// sequential within a lane, so a quad of four threads shares it
// (fe25519.cuh quad functions): each point operation is two rounds of
// four independent field products, and thread q of the quad holds
// coordinate q of the accumulator, computes product q of each round (each
// product once, in one thread) and loads only the table coordinate it
// multiplies; the quad exchanges the 20-limb products by warp shuffles
// and every thread forms E, F, G, H from them.
// At 2,560 lanes that is 10,240 threads in 320 blocks of 32 (8 lanes a
// block), 2 or 3 warps on each of the 132 SMs; blocks of 64 took 2.04 ms
// against 1.76 ms for blocks of 32 (tools/torch_ladder_ab.py, PERF.md).
// ptxas: 168 registers, 0 bytes of stack frame, no spills, no local loads
// or stores in its SASS (the one-thread K3 it replaces: 128 registers and
// a 640-byte stack frame, through which its out-of-line point functions
// passed the accumulator and each table entry). What bounds K3 now is
// inferred from a batch sweep, not measured (ncu could not read the
// card's counters where it was timed): its time stays flat from 640 to
// 2,560 lanes and doubles at 5,120, which fits each of its 320 warps
// issuing alone on one of the 528 schedulers, with the other 208 empty
// (PERF.md has its time beside the bound).
//
// Shared design: full unrolling of the limb loops inside a field multiply
// keeps its 20 + 20 + 39 values in registers. K1 and the table run the
// inline decompress_wide; the warm K1's split functions and the quad
// functions of K2 and K3 are inline, with their loops kept rolled so that
// K3's body holds one double and one add, and K2's one add and one
// conversion.

#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace edw {

constexpr int M = 4;
constexpr int N_SCAL = 2 * M;
constexpr int N_FULL_TABLES = M / 2 + 1;
constexpr int THREADS = 128;
// K2 runs a quad of threads per (lane, table), K2_THREADS / 4 lanes a
// block, with registers capped for K2_MIN_BLOCKS blocks an SM.
constexpr int K2_THREADS = 64;
constexpr int K2_MIN_BLOCKS = 5;
// K3 runs a quad of threads per lane, K3_THREADS / 4 lanes a block (the
// header note says why).
constexpr int K3_THREADS = 32;

// Entry e of table t: coordinate c at rows ((t * 16 + e) * 4 + c) * 32.
__device__ __forceinline__ int tbl_row(int t, int e, int c) {
  return ((t * 16 + e) * 4 + c) * 32;
}

// K1 — replaces pallas_rlc._k1_rlc_kernel (pallas_rlc.py:110).
// Thread (lane, p), p = blockIdx.y in 0..2M-1, unpacks the base-4 digits
// of scalar p and decompresses point p (A_0..A_{M-1}, then R_0..R_{M-1}).
// Digit t of a scalar is (byte[t >> 2] >> 2 (t & 3)) & 3, stored at row
// (t & 3) * 32 + (t >> 2) of its 128 (pallas_verify's shift-grouped
// order). The decompression runs inline on the wide field (fe25519.cuh
// decompress_wide), so the kernel has no call and no stack frame. Bound:
// operations (the decompression's pow22523); eight independent
// decompressions per lane are spread over eight threads.
__global__ void __launch_bounds__(THREADS)
k1_rlc_kernel(const uint8_t* __restrict__ a_t, const uint8_t* __restrict__ r_t,
              const uint8_t* __restrict__ scal_t, int32_t* __restrict__ coords,
              int32_t* __restrict__ ok, int32_t* __restrict__ dig, int g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (lane >= g) return;
  store_digits(dig, p * 128, scal_t + (size_t)p * 32 * g + lane, g, lane, g);
  const uint8_t* src = (p < M ? a_t + (size_t)p * 32 * g : r_t + (size_t)(p - M) * 32 * g) + lane;
  pt P;
  const bool okp = decompress_wide(P, src, g);
  ok[(size_t)p * g + lane] = okp ? 1 : 0;
  store_point(coords, p, P, lane, g);
}

// The warm K1 runs a quad of threads per (lane, slot), K1C_THREADS / 4
// lanes a block, with registers capped for K1C_MIN_BLOCKS blocks an SM (the
// header note says why).
constexpr int K1C_THREADS = 64;
constexpr int K1C_MIN_BLOCKS = 5;

// K1 for a warm epoch — replaces pallas_rlc._k1_rlc_kernel_cached
// (pallas_rlc.py:139). The epoch table (epoch_coords below) holds every
// validator's decompressed A; idx (signature-major, i = lane * M + slot)
// names each signature's column, and padding signatures name column
// vp - 1, the identity. A quad per (lane, slot j), j = blockIdx.y, with
// adjacent quads on adjacent lanes: thread q copies coordinate q of A_j
// from table column idx[lane * M + j], unpacks the digits of bytes 8q ..
// 8q + 7 of scalars j and M + j from the row-major scal_rows (g, 2M, 32),
// and the quad decompresses R_j from the row-major r_rows (g * M, 32)
// together on the limb-split field product (fe25519.cuh), thread q storing
// coordinate q of it; quad thread 0 writes both flags. So the gathered
// (M * 4 * 32, g) array of the JAX pipeline is never built, and the
// slot-major transposes are the kernel's own reads. A quad past the end
// runs on a clamped lane with its stores masked. Bound: operations (the M
// R decompressions); the copy is a few hundred bytes a thread.
__global__ void __launch_bounds__(K1C_THREADS, K1C_MIN_BLOCKS)
k1_rlc_cached_kernel(const int32_t* __restrict__ ctbl,
                     const int32_t* __restrict__ oktbl,
                     const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ r_rows,
                     const uint8_t* __restrict__ scal_rows,
                     int32_t* __restrict__ coords, int32_t* __restrict__ ok,
                     int32_t* __restrict__ dig, int g, int vp) {
  const int q = threadIdx.x & 3;
  const int quad = blockIdx.x * (K1C_THREADS / 4) + (threadIdx.x >> 2);
  const int j = blockIdx.y;
  const bool live = quad < g;
  const int lane = live ? quad : g - 1;
  const size_t sig = (size_t)lane * M + j;
  const int col = idx[sig];
  if (live) {
    const uint8_t* sj = scal_rows + ((size_t)lane * N_SCAL + j) * 32;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int by = 8 * q + b;
      const int32_t lo = sj[by], hi = sj[M * 32 + by];  // scalars j and M + j
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        dig[(size_t)(j * 128 + d * 32 + by) * g + lane] = (lo >> (2 * d)) & 3;
        dig[(size_t)((M + j) * 128 + d * 32 + by) * g + lane] = (hi >> (2 * d)) & 3;
      }
    }
    store_fe(coords, (j * 4 + q) * 32, load_fe(ctbl, q * 32, col, vp), lane, g);
  }
  fe x, y, t;
  const bool okr = split_decompress(x, y, t, r_rows + sig * 32, q);
  if (!live) return;
  store_fe(coords, ((M + j) * 4 + q) * 32,
           pick(q == 0, x, pick(q == 1, y, pick(q == 2, fe_one(), t))), lane, g);
  if (q == 0) {
    ok[(size_t)j * g + lane] = oktbl[col];
    ok[(size_t)(M + j) * g + lane] = okr ? 1 : 0;
  }
}

// The epoch table — the build that replaces epoch_cache._coords_fn
// (epoch_cache.py:292-309, XLA code rather than a Pallas kernel). One
// thread per table row decompresses the row's key, read with stride vp
// from pub_t (32, vp), and writes its coordinates to coords (4 * 32, vp)
// and its flag to ok (1, vp). Padding rows hold the identity encoding.
// The decompression runs inline on the wide field (fe25519.cuh
// decompress_wide), as K1's does, so the kernel has no call and no stack
// frame. Bound: operations (one decompression a row); built once per
// validator set and device.
__global__ void __launch_bounds__(THREADS)
epoch_coords_kernel(const uint8_t* __restrict__ pub_t, int32_t* __restrict__ coords,
                    int32_t* __restrict__ ok, int vp) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= vp) return;
  pt P;
  const bool okp = decompress_wide(P, pub_t + row, vp);
  ok[row] = okp ? 1 : 0;
  store_point(coords, 0, P, row, vp);
}

// Coordinate c of the point of scalar s: B for S (s = 0), -A_{s-1} for u
// (1 <= s <= M), -R_{s-M} for z (s > M).
__device__ __forceinline__ fe coord_of(const int32_t* __restrict__ coords, int s,
                                       int c, int lane, int g) {
  if (s == 0) {
    const pt b = base_point();
    return pick(c == 0, b.x, pick(c == 1, b.y, pick(c == 2, b.z, b.t)));
  }
  const fe v = load_fe(coords, ((s <= M ? s - 1 : s) * 4 + c) * 32, lane, g);
  return (c == 0 || c == 3) ? neg(v) : v;
}

// K2 — replaces pallas_rlc._k2_rlc_kernel (pallas_rlc.py:177).
// A quad of four threads per (lane, t), t = blockIdx.y in 0..M-1, builds
// table t: entry lo + 4 hi = [lo]P_t + [hi]Q_t (lo, hi in 0..3) for the
// points of scalars (2t, 2t+1), stored in Niels form; thread q holds
// coordinate q of every point and stores coordinate q of every entry.
// The rows O, P, 2P, 3P stay in named registers; hi walks outermost,
// with the column [hi]Q made as it is reached (2Q by a double, 3Q = 2Q +
// Q with Q loaded again rather than held, which keeps the kernel at the
// 168 registers of its cap with no spills), so no point array is indexed
// at run time. Bound: operations (13 point additions and doublings, 16
// conversions per table).
__global__ void __launch_bounds__(K2_THREADS, K2_MIN_BLOCKS)
k2_rlc_kernel(const int32_t* __restrict__ coords, int32_t* __restrict__ tbl,
              int g) {
  const int q = threadIdx.x & 3;
  const int quad = blockIdx.x * (K2_THREADS / 4) + (threadIdx.x >> 2);
  const int lane = quad < g ? quad : g - 1;  // a quad past the end runs masked
  const int t = blockIdx.y;
  const fe o = quad_identity(q);
  const fe p1 = coord_of(coords, 2 * t, q, lane, g);
  const fe p2 = quad_double(p1, q, true);
  const fe p3 = quad_add(p2, p1, q);
  fe col = o;  // [hi]Q
#pragma unroll 1
  for (int hi = 0; hi < 4; ++hi) {
    if (hi == 1)
      col = coord_of(coords, 2 * t + 1, q, lane, g);
    else if (hi == 2)
      col = quad_double(col, q, true);
    else if (hi == 3)
      col = quad_add(col, coord_of(coords, 2 * t + 1, q, lane, g), q);
#pragma unroll 1
    for (int lo = 0; lo < 4; ++lo) {
      const fe row = pick(lo == 1, p1, pick(lo == 2, p2, pick(lo == 3, p3, o)));
      const fe ent = hi == 0 ? row : lo == 0 ? col : quad_add(row, col, q);
      const fe nl = quad_to_niels(ent, q);
      if (quad < g) store_fe(tbl, tbl_row(t, lo + 4 * hi, q), nl, lane, g);
    }
  }
}

// This thread's coordinate of entry dig(2t) + 4 dig(2t+1) of table t at
// digit row j: a direct indexed load (pallas_rlc's 16-way masked select
// was a Mosaic constraint).
__device__ __forceinline__ fe rlc_entry(const int32_t* __restrict__ tbl,
                                        const int32_t* __restrict__ dig, int t, int j,
                                        int c, int lane, int g) {
  const int e = dig[(size_t)(2 * t * 128 + j) * g + lane] +
                4 * dig[(size_t)((2 * t + 1) * 128 + j) * g + lane];
  return load_fe(tbl, tbl_row(t, e, c), lane, g);
}

// K3 — replaces pallas_rlc._k3_rlc_kernel (pallas_rlc.py:251).
// A quad of four threads runs one lane's 127-iteration joint ladder over
// the M tables (fe25519.cuh quad functions), digit positions 126 down to
// 0: per iteration 2 doubles (the first skips T), then one Niels add per
// table, of which only the last skips T (the next iteration's doubles
// never read it). Positions 126..64 (63 iterations) skip the tables whose
// two scalars are both z's: z < 2^128, so their digits there are zero and
// pallas_rlc skips them too (the accumulator's limbs, not only its value,
// must match). Each thread loads only the table coordinate it multiplies,
// one add ahead of its use. Then [8]acc == [8]R_0, ANDed with the 2M
// decompression flags and the M host s < L flags, in quad thread 0.
__global__ void __launch_bounds__(K3_THREADS)
k3_rlc_kernel(const int32_t* __restrict__ tbl, const int32_t* __restrict__ dig,
              const int32_t* __restrict__ coords, const int32_t* __restrict__ ok,
              const int32_t* __restrict__ sok, int32_t* __restrict__ out,
              int g) {
  const int q = threadIdx.x & 3;
  const int quad = blockIdx.x * (K3_THREADS / 4) + (threadIdx.x >> 2);
  const int lane = quad < g ? quad : g - 1;  // a quad past the end runs masked
  const int c = niels_coord(q);
  fe acc = quad_identity(q);
#pragma unroll 1
  for (int i = 0; i < 127; ++i) {
    const int pos = 126 - i;
    const int j = (pos & 3) * 32 + (pos >> 2);
    const int nt = i < 63 ? N_FULL_TABLES : M;
    fe ent = rlc_entry(tbl, dig, 0, j, c, lane, g);
#pragma unroll 1
    for (int d = 0; d < 2; ++d) acc = quad_double(acc, q, d == 1);
#pragma unroll 1
    for (int t = 0; t < nt; ++t) {
      const fe next = t + 1 < nt ? rlc_entry(tbl, dig, t + 1, j, c, lane, g) : ent;
      acc = quad_add_niels(acc, ent, q, t + 1 < nt);
      ent = next;
    }
  }
  const fe r = load_fe(coords, (M * 4 + q) * 32, lane, g);  // R_0
  bool valid = quad_cofactor_eq(acc, r, q);
  if (q != 0 || quad >= g) return;
#pragma unroll
  for (int p = 0; p < 2 * M; ++p) valid = valid && ok[(size_t)p * g + lane] != 0;
#pragma unroll
  for (int k = 0; k < M; ++k) valid = valid && sok[(size_t)k * g + lane] != 0;
  out[lane] = valid ? 1 : 0;
}

}  // namespace edw

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. The grid is ceil(g / THREADS) blocks
// with the tail masked in the kernel; the warm K1's, K2's and K3's are
// ceil(4 g / K1C_THREADS), ceil(4 g / K2_THREADS) and ceil(4 g /
// K3_THREADS), a quad a lane (the warm K1's times M slots, K2's times M
// tables), with the tail masked per quad.

static dim3 lane_grid(int g, int y) {
  return dim3((g + edw::THREADS - 1) / edw::THREADS, y);
}

extern "C" int tm_k1_rlc(const void* a_t, const void* r_t, const void* scal_t,
                         void* coords, void* ok, void* dig, int g,
                         void* stream) {
  edw::k1_rlc_kernel<<<lane_grid(g, edw::N_SCAL), edw::THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)a_t, (const uint8_t*)r_t, (const uint8_t*)scal_t,
      (int32_t*)coords, (int32_t*)ok, (int32_t*)dig, g);
  return (int)cudaGetLastError();
}

extern "C" int tm_k1_rlc_cached(const void* ctbl, const void* oktbl,
                                const void* idx, const void* r_rows,
                                const void* scal_rows, void* coords, void* ok,
                                void* dig, int g, int vp, void* stream) {
  const dim3 grid((4 * g + edw::K1C_THREADS - 1) / edw::K1C_THREADS, edw::M);
  edw::k1_rlc_cached_kernel<<<grid, edw::K1C_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ctbl, (const int32_t*)oktbl, (const int32_t*)idx,
      (const uint8_t*)r_rows, (const uint8_t*)scal_rows, (int32_t*)coords,
      (int32_t*)ok, (int32_t*)dig, g, vp);
  return (int)cudaGetLastError();
}

extern "C" int tm_epoch_coords(const void* pub_t, void* coords, void* ok, int vp,
                               void* stream) {
  edw::epoch_coords_kernel<<<lane_grid(vp, 1), edw::THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)pub_t, (int32_t*)coords, (int32_t*)ok, vp);
  return (int)cudaGetLastError();
}

extern "C" int tm_k2_rlc(const void* coords, void* tbl, int g, void* stream) {
  const dim3 grid((4 * g + edw::K2_THREADS - 1) / edw::K2_THREADS, edw::M);
  edw::k2_rlc_kernel<<<grid, edw::K2_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)coords, (int32_t*)tbl, g);
  return (int)cudaGetLastError();
}

extern "C" int tm_k3_rlc(const void* tbl, const void* dig, const void* coords,
                         const void* ok, const void* sok, void* out, int g,
                         void* stream) {
  const dim3 grid((4 * g + edw::K3_THREADS - 1) / edw::K3_THREADS);
  edw::k3_rlc_kernel<<<grid, edw::K3_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, (const int32_t*)dig, (const int32_t*)coords,
      (const int32_t*)ok, (const int32_t*)sok, (int32_t*)out, g);
  return (int)cudaGetLastError();
}

extern "C" const char* tm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
