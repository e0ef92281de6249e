// The op-graph per-signature ZIP-215 check, one launch a batch, for
// sm_90a.
//
// Counterpart: tendermint_tpu/ops/ed25519_verify.py verify_kernel (:152)
// with its device-hash variant (:307), and verify_kernel_cached (:273)
// with its variant (:290); the device-hash variants are the composition
// sha512_challenge (csrc/sha512.cu) -> these kernels. Plain PyTorch
// versions: tendermint_tpu_torch/ops/ed25519_verify.py og_verify_plain
// and og_verify_cached_plain, whose verdicts these kernels match.
//
//   accept iff A and R decompress (ZIP-215: non-canonical y and "negative
//   zero" accepted), s < L (the host's flag), and
//   [8]([s]B + [k](-A) - R) is the identity
//
// Inputs are raw 32-byte rows, (n, 32) uint8 each: A (or, for the cached
// kernel, each signature's column of the set's epoch table, as
// csrc/verify.cu's warm K1 reads it), R, s and k, with s_ok (n,) int32;
// the output is one int32 verdict a signature.
//
// Design. The TPU ran this check as one XLA computation; the port's
// per-signature path (csrc/verify.cu) splits it into K1, K2 and K3 only
// because Mosaic could not compile it whole (pallas_verify.py:388), and
// its K2 writes the 16-entry table, 8 KiB a signature, to global memory
// for K3 to read back. Here one launch does it all, and the table stays
// on the chip, in shared memory. A quad of four adjacent threads runs one
// signature, thread q holding coordinate q of every point, on the wide
// field (fe25519.cuh's wide quad functions: 10 unsigned limbs of 25.5
// bits, a multiply 100 and a squaring 55 32 x 32 -> 64 products and one
// pass of carries; its header states the limb bounds). The verdict is the
// only output, so no limb has to equal a plain version's: the kernel
// forms the plain version's field values modulo p, and tests them through
// canonical limbs. Threads 0 and 2 of the quad decompress A and threads 1
// and 3 R, at once and on the wide field (wide_decompress, one thread a
// point, as the cold K1s; og_verify_cached decompresses R in all four);
// one exchange of 10 words gives every thread coordinate q of -A and -R.
// The quad builds the table [s2]B + [k2](-A) as K2 does, runs the 127
// iterations of two doubles and a Niels add, adds -R, doubles three
// times and tests for the identity (X = 0, Y = Z) in quad thread 0, which
// ANDs the two decompression flags and s_ok. Each thread keeps in shared
// memory only the Niels coordinate it multiplies in the ladder's adds
// (niels_coord(q), taken from its quad by a shuffle as each entry is
// made, folded into M), at its own column: 16 entries x 10 words, 640
// bytes a thread and 40,960 a block of 64. No thread reads another's
// column, so the table needs no barrier, and the reads of a warp fall on
// distinct banks. ptxas: 168 registers, no stack, 0 bytes spilled, for
// both kernels; the shared table allows 5 blocks an SM (10 warps), the
// registers 6, so OG_MIN_BLOCKS is 5. The 13-bit design it replaces
// (split_decompress twice in a row, the ladder on 20 signed 13-bit limbs,
// 400 multiply-adds a multiply, 20 shuffles an element) took 2.487 and
// 2.411 ms at 10,240 signatures and spilled 784 / 624 bytes; this one
// takes 1.04 ms for each (H100 80GB HBM3, 700 W; PERF.md §6).
//
// What bounds it: the SM's multiply pipe, which it keeps at about half
// its rate (13.2 of 27.11 IMAD.WIDE a clock an SM) with the 2.4 warps a
// scheduler that 10,240 signatures give. A signature forms 351,476 32 x
// 32 -> 64 products (chip_smoke.og_kernel_products: per thread 259
// doubles, 127 Niels adds, 12 adds, 16 to-Niels and one decompression)
// where the bound counts the plain version's 1,960 multiplies and 1,546
// squarings at the cheaper formulation, 700,595 multiply-add slots (0.43
// ms at 10,240 signatures; og_verify_cached 660,385, 0.40 ms); the 13-bit
// count of the same formulas,
// 1,108,660 a signature for og_verify and 1,047,110 for og_verify_cached
// (one decompression fewer), stays checked by chip_smoke.py against
// PRODUCTS_PER_UNIT. A double runs 637 instructions a warp, 157 of them
// IMAD.WIDE, 50 SHFL and 50 SEL; a Niels add 738. At 10,240 signatures
// the launch is 640 blocks in one wave (4.85 of the 5 an SM), and the
// time grows with the batch (A/B tool, --sweep): 0.53, 0.73, 1.04, 1.90
// and 3.62 ms at 2,560, 5,120, 10,240, 20,480 and 40,960 signatures, so
// the card is full at 10,240: 8 signatures a block (32 threads, 10
// blocks an SM) measured the same, and two parallel passes of carries in
// place of wide_carry's chain 4% slower. (A pair of quads a signature,
// one on [s]B and one on [k](-A), would halve no chain: each keeps the
// 254 doubles.) The bytes (1.4 MB at 10,240 signatures) take under 0.001
// ms at 3.35 TB/s. Verification handles public data: nothing here is
// constant time.

#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace edw {

constexpr int OG_THREADS = 64;  // 16 signatures a block
constexpr int OG_MIN_BLOCKS = 5;
constexpr int OG_ROWS = 16 * NWL;  // table rows: entry e, limb l at e * NWL + l

// The joint ladder and the final test, shared by both kernels. The quad's
// thread q holds coordinate q of -A (neg_a) and of -R (neg_r), in M; tbl is
// the block's table, tid this thread's column; s and k are the signature's
// 32-byte scalars. Returns [8]([s]B + [k](-A) - R) == O in quad thread 0
// (false in the others).
__device__ __forceinline__ bool og_check(const fw& neg_a, const fw& neg_r,
                                         const uint8_t* __restrict__ s,
                                         const uint8_t* __restrict__ k,
                                         uint32_t (*tbl)[OG_THREADS], int tid, int q) {
  // the table: rows O, B, 2B, 3B, column [k2](-A), each entry's Niels
  // coordinate niels_coord(q) folded into M
  const fw o = wquad_identity(q);
  const fw p1 = fw_base(q);
  const fw p2 = wquad_double(p1, q, true);
  const fw p3 = wquad_add(p2, p1, q);
  const int nc = niels_coord(q);
  fw col = o;
#pragma unroll 1
  for (int k2 = 0; k2 < 4; ++k2) {
    if (k2 == 1)
      col = neg_a;
    else if (k2 == 2)
      col = wquad_double(col, q, true);
    else if (k2 == 3)
      col = wquad_add(col, neg_a, q);
#pragma unroll 1
    for (int s2 = 0; s2 < 4; ++s2) {
      const fw row = wpick(s2 == 1, p1, wpick(s2 == 2, p2, wpick(s2 == 3, p3, o)));
      const fw ent = k2 == 0 ? row : s2 == 0 ? col : wquad_add(row, col, q);
      const fw mine = wide_fold(wquad_slot(wquad_to_niels(ent, q), nc));
      const int e = s2 + 4 * k2;
#pragma unroll
      for (int l = 0; l < NWL; ++l) tbl[e * NWL + l][tid] = mine.v[l];
    }
  }
  // 127 iterations, digit positions 126 down to 0: two doubles and a
  // Niels add of entry s2 + 4 k2, digit t = bits 2t, 2t + 1 of the scalar
  fw acc = o;
#pragma unroll 1
  for (int it = 0; it < 127; ++it) {
    const int pos = 126 - it;
    const int sh = 2 * (pos & 3);
    const int e = ((s[pos >> 2] >> sh) & 3) + 4 * ((k[pos >> 2] >> sh) & 3);
    fw ent;
#pragma unroll
    for (int l = 0; l < NWL; ++l) ent.v[l] = tbl[e * NWL + l][tid];
#pragma unroll 1
    for (int d = 0; d < 2; ++d) acc = wquad_double(acc, q, d == 1);
    acc = wquad_add_niels(acc, ent, q, it == 126);  // the last add makes T
  }
  return wquad_cofactor_identity(wquad_add(acc, neg_r, q), q);
}

// Coordinate q of -P for P = (x, y, 1, t) in M: thread 0 negates x, 3 t.
__device__ __forceinline__ fw neg_coord(const fw& v, int q) {
  return (q == 0 || q == 3) ? wide_fold(wide_sub<2>(fw_zero(), v)) : v;
}

// og_verify — replaces ed25519_verify.verify_kernel (ed25519_verify.py
// :152). A quad a signature, OG_THREADS / 4 signatures a block; a quad
// past the end runs on a clamped signature with its store masked. Threads
// 0 and 2 of the quad decompress A, threads 1 and 3 R, all at once; one
// exchange of 10 words between thread pairs (0, 1) and (2, 3) then gives
// thread 0 R's x, thread 1 A's y and thread 3 A's t, so that each holds
// coordinate q of both points. Bound: operations.
__global__ void __launch_bounds__(OG_THREADS, OG_MIN_BLOCKS)
og_verify_kernel(const uint8_t* __restrict__ a_rows, const uint8_t* __restrict__ r_rows,
                 const uint8_t* __restrict__ s_rows, const uint8_t* __restrict__ k_rows,
                 const int32_t* __restrict__ s_ok, int32_t* __restrict__ out, int n) {
  __shared__ uint32_t tbl[OG_ROWS][OG_THREADS];
  const int tid = threadIdx.x;
  const int q = tid & 3;
  const int quad = blockIdx.x * (OG_THREADS / 4) + (tid >> 2);
  const int i = quad < n ? quad : n - 1;
  fw x, y, t;
  const bool ok = wide_decompress(x, y, t, ((q & 1) ? r_rows : a_rows) + (size_t)i * 32);
  const bool ok_other = __shfl_xor_sync(QUAD_ALL, ok ? 1 : 0, 1, 4) != 0;
  // thread 0 sends A's y, 1 R's x, 2 A's t (3 sends t, unused)
  const fw got = wquad_partner(q == 0 ? y : q == 1 ? x : t);
  const fw own = q == 0 ? x : q == 1 ? y : t;
  const fw one = fw_one();
  const fw a = q == 0 ? own : q == 2 ? one : got;
  const fw r = q == 0 ? got : q == 2 ? one : own;
  const bool eq = og_check(neg_coord(a, q), neg_coord(r, q), s_rows + (size_t)i * 32,
                           k_rows + (size_t)i * 32, tbl, tid, q);
  if (q != 0 || quad >= n) return;
  out[i] = (ok && ok_other && s_ok[i] != 0 && eq) ? 1 : 0;
}

// og_verify_cached — replaces ed25519_verify.verify_kernel_cached
// (ed25519_verify.py:273). As og_verify, but A is column idx[i] of the
// set's epoch table (ops/epoch_cache.py coords_tables: (4 * 32, vp)
// decompressed coordinates and (1, vp) flags, the rows csrc/verify.cu's
// warm K1 reads; padding signatures name column vp - 1, the identity),
// thread q reading coordinate q into the wide field (wide_in), so only R
// decompresses, in every thread of the quad. The reference gathers the
// keys' undecompressed limbs and decompresses A in the kernel; both tables
// decode the same key rows, so the verdicts agree.
__global__ void __launch_bounds__(OG_THREADS, OG_MIN_BLOCKS)
og_verify_cached_kernel(const int32_t* __restrict__ ctbl, const int32_t* __restrict__ oktbl,
                        const int32_t* __restrict__ idx, const uint8_t* __restrict__ r_rows,
                        const uint8_t* __restrict__ s_rows, const uint8_t* __restrict__ k_rows,
                        const int32_t* __restrict__ s_ok, int32_t* __restrict__ out, int n,
                        int vp) {
  __shared__ uint32_t tbl[OG_ROWS][OG_THREADS];
  const int tid = threadIdx.x;
  const int q = tid & 3;
  const int quad = blockIdx.x * (OG_THREADS / 4) + (tid >> 2);
  const int i = quad < n ? quad : n - 1;
  const int col = idx[i];
  const fw a = wide_in(load_fe(ctbl, q * 32, col, vp));
  fw x, y, t;
  const bool ok_r = wide_decompress(x, y, t, r_rows + (size_t)i * 32);
  const fw r = q == 0 ? x : q == 1 ? y : q == 2 ? fw_one() : t;
  const bool eq = og_check(neg_coord(a, q), neg_coord(r, q), s_rows + (size_t)i * 32,
                           k_rows + (size_t)i * 32, tbl, tid, q);
  if (q != 0 || quad >= n) return;
  out[i] = (oktbl[col] != 0 && ok_r && s_ok[i] != 0 && eq) ? 1 : 0;
}

}  // namespace edw

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. Grid: ceil(4 n / OG_THREADS) blocks, a
// quad of threads a signature, the tail masked per quad.

extern "C" int tm_og_verify(const void* a_rows, const void* r_rows, const void* s_rows,
                            const void* k_rows, const void* s_ok, void* out, int n,
                            void* stream) {
  const dim3 grid((4 * n + edw::OG_THREADS - 1) / edw::OG_THREADS);
  edw::og_verify_kernel<<<grid, edw::OG_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a_rows, (const uint8_t*)r_rows, (const uint8_t*)s_rows,
      (const uint8_t*)k_rows, (const int32_t*)s_ok, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_og_verify_cached(const void* ctbl, const void* oktbl, const void* idx,
                                   const void* r_rows, const void* s_rows, const void* k_rows,
                                   const void* s_ok, void* out, int n, int vp, void* stream) {
  const dim3 grid((4 * n + edw::OG_THREADS - 1) / edw::OG_THREADS);
  edw::og_verify_cached_kernel<<<grid, edw::OG_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ctbl, (const int32_t*)oktbl, (const int32_t*)idx, (const uint8_t*)r_rows,
      (const uint8_t*)s_rows, (const uint8_t*)k_rows, (const int32_t*)s_ok, (int32_t*)out, n,
      vp);
  return (int)cudaGetLastError();
}
