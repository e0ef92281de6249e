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
// signature, as K3 does (fe25519.cuh quad functions): the quad decompresses
// A and R together on the limb-split field product (split_decompress, as
// the warm K1), builds the table [s2]B + [k2](-A) as K2 does, thread q
// holding coordinate q of every point, runs the 127 iterations of two
// doubles and a Niels add, adds -R, doubles three times and tests for the
// identity (X = 0, Y = Z) in quad thread 0, which ANDs the two
// decompression flags and s_ok. Each thread keeps in shared memory only
// the Niels coordinate it multiplies in the ladder's adds (niels_coord(q),
// taken from its quad by a shuffle as each entry is made), at its own
// column: 16 entries x 20 limbs, as int16 (a carry pass leaves every limb
// in (-1216, 2^13 + 1216], fe25519.cuh), 640 bytes a thread and 40,960 a block of 64. No thread
// reads another's column, so the table needs no barrier, and the reads of
// a warp fall on distinct banks or on one word. The registers are capped
// for OG_MIN_BLOCKS blocks an SM, which the shared memory also allows (5 x
// 40 KiB of the SM's 228 KiB).
//
// What bounds it: the 32-bit multiply-adds of the limb convolutions (400
// a field multiply, 210 a squaring), counted from the plain versions'
// formulas by chip_smoke.py: per signature 1,108,660 for og_verify (two
// decompressions 123,100, the table 50,880, the ladder and the final
// test 934,680) and 1,047,110 for og_verify_cached (one decompression).
// The quad's decompression forms y^2 and d y^2 twice (split_sqrt_ratio),
// a multiply and a squaring more than counted. chip_smoke.py's bound
// counts the decompressions on the cold K1s' wide field instead
// (OG_POINTS_PER_UNIT), the cheaper formulation the port has; the bytes
// (1.4 MB at 10,240 signatures) take under 0.001 ms at 3.35 TB/s.
// Verification handles public data: nothing here is constant time.

#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace edw {

constexpr int OG_THREADS = 64;  // 16 signatures a block
constexpr int OG_MIN_BLOCKS = 5;
constexpr int OG_ROWS = 16 * NL;  // table rows: entry e, limb l at e * NL + l

// Coordinate q of the extended point (x, y, 1, t).
__device__ __forceinline__ fe coord_q(const fe& x, const fe& y, const fe& t, int q) {
  return pick(q == 0, x, pick(q == 1, y, pick(q == 2, fe_one(), t)));
}

// The joint ladder and the final test, shared by both kernels. The quad's
// thread q holds coordinate q of -A (neg_a) and of -R (neg_r); tbl is the
// block's table, tid this thread's column; s and k are the signature's
// 32-byte scalars. Returns [8]([s]B + [k](-A) - R) == O in quad thread 0
// (false in the others).
__device__ __forceinline__ bool og_check(const fe& neg_a, const fe& neg_r,
                                         const uint8_t* __restrict__ s,
                                         const uint8_t* __restrict__ k,
                                         int16_t (*tbl)[OG_THREADS], int tid, int q) {
  // the table, as csrc/verify.cu's K2: rows O, B, 2B, 3B, column [k2](-A)
  const pt b = base_point();
  const fe o = quad_identity(q);
  const fe p1 = pick(q == 0, b.x, pick(q == 1, b.y, pick(q == 2, b.z, b.t)));
  const fe p2 = quad_double(p1, q, true);
  const fe p3 = quad_add(p2, p1, q);
  const int nc = niels_coord(q);
  fe col = o;
#pragma unroll 1
  for (int k2 = 0; k2 < 4; ++k2) {
    if (k2 == 1)
      col = neg_a;
    else if (k2 == 2)
      col = quad_double(col, q, true);
    else if (k2 == 3)
      col = quad_add(col, neg_a, q);
#pragma unroll 1
    for (int s2 = 0; s2 < 4; ++s2) {
      const fe row = pick(s2 == 1, p1, pick(s2 == 2, p2, pick(s2 == 3, p3, o)));
      const fe ent = k2 == 0 ? row : s2 == 0 ? col : quad_add(row, col, q);
      const fe mine = quad_slot(quad_to_niels(ent, q), nc);
      const int e = s2 + 4 * k2;
#pragma unroll
      for (int l = 0; l < NL; ++l) tbl[e * NL + l][tid] = (int16_t)mine.v[l];
    }
  }
  // 127 iterations, digit positions 126 down to 0: two doubles and a
  // Niels add of entry s2 + 4 k2, digit t = bits 2t, 2t + 1 of the scalar
  fe acc = o;
#pragma unroll 1
  for (int it = 0; it < 127; ++it) {
    const int pos = 126 - it;
    const int sh = 2 * (pos & 3);
    const int e = ((s[pos >> 2] >> sh) & 3) + 4 * ((k[pos >> 2] >> sh) & 3);
    fe ent;
#pragma unroll
    for (int l = 0; l < NL; ++l) ent.v[l] = tbl[e * NL + l][tid];
#pragma unroll 1
    for (int d = 0; d < 2; ++d) acc = quad_double(acc, q, d == 1);
    acc = quad_add_niels(acc, ent, q, it == 126);  // the last add makes T
  }
  acc = quad_add(acc, neg_r, q);
#pragma unroll 1
  for (int d = 0; d < 3; ++d) acc = quad_double(acc, q, false);
  const fe x = quad_slot(acc, 0), y = quad_slot(acc, 1), z = quad_slot(acc, 2);
  if (q != 0) return false;
  return is_zero(x) && is_zero(sub(y, z));
}

// og_verify — replaces ed25519_verify.verify_kernel (ed25519_verify.py
// :152). A quad a signature, OG_THREADS / 4 signatures a block; a quad
// past the end runs on a clamped signature with its store masked. Bound:
// operations.
__global__ void __launch_bounds__(OG_THREADS, OG_MIN_BLOCKS)
og_verify_kernel(const uint8_t* __restrict__ a_rows, const uint8_t* __restrict__ r_rows,
                 const uint8_t* __restrict__ s_rows, const uint8_t* __restrict__ k_rows,
                 const int32_t* __restrict__ s_ok, int32_t* __restrict__ out, int n) {
  __shared__ int16_t tbl[OG_ROWS][OG_THREADS];
  const int tid = threadIdx.x;
  const int q = tid & 3;
  const int quad = blockIdx.x * (OG_THREADS / 4) + (tid >> 2);
  const int i = quad < n ? quad : n - 1;
  fe x, y, t;
  const bool ok_a = split_decompress(x, y, t, a_rows + (size_t)i * 32, q);
  const fe neg_a = (q == 0 || q == 3) ? neg(coord_q(x, y, t, q)) : coord_q(x, y, t, q);
  const bool ok_r = split_decompress(x, y, t, r_rows + (size_t)i * 32, q);
  const fe neg_r = (q == 0 || q == 3) ? neg(coord_q(x, y, t, q)) : coord_q(x, y, t, q);
  const bool eq = og_check(neg_a, neg_r, s_rows + (size_t)i * 32, k_rows + (size_t)i * 32, tbl,
                           tid, q);
  if (q != 0 || quad >= n) return;
  out[i] = (ok_a && ok_r && s_ok[i] != 0 && eq) ? 1 : 0;
}

// og_verify_cached — replaces ed25519_verify.verify_kernel_cached
// (ed25519_verify.py:273). As og_verify, but A is column idx[i] of the
// set's epoch table (ops/epoch_cache.py coords_tables: (4 * 32, vp)
// decompressed coordinates and (1, vp) flags, the rows csrc/verify.cu's
// warm K1 reads; padding signatures name column vp - 1, the identity), so
// only R decompresses. The reference gathers the keys' undecompressed
// limbs and decompresses A in the kernel; both tables decode the same key
// rows, so the verdicts agree.
__global__ void __launch_bounds__(OG_THREADS, OG_MIN_BLOCKS)
og_verify_cached_kernel(const int32_t* __restrict__ ctbl, const int32_t* __restrict__ oktbl,
                        const int32_t* __restrict__ idx, const uint8_t* __restrict__ r_rows,
                        const uint8_t* __restrict__ s_rows, const uint8_t* __restrict__ k_rows,
                        const int32_t* __restrict__ s_ok, int32_t* __restrict__ out, int n,
                        int vp) {
  __shared__ int16_t tbl[OG_ROWS][OG_THREADS];
  const int tid = threadIdx.x;
  const int q = tid & 3;
  const int quad = blockIdx.x * (OG_THREADS / 4) + (tid >> 2);
  const int i = quad < n ? quad : n - 1;
  const int col = idx[i];
  const fe a = load_fe(ctbl, q * 32, col, vp);
  const fe neg_a = (q == 0 || q == 3) ? neg(a) : a;
  fe x, y, t;
  const bool ok_r = split_decompress(x, y, t, r_rows + (size_t)i * 32, q);
  const fe neg_r = (q == 0 || q == 3) ? neg(coord_q(x, y, t, q)) : coord_q(x, y, t, q);
  const bool eq = og_check(neg_a, neg_r, s_rows + (size_t)i * 32, k_rows + (size_t)i * 32, tbl,
                           tid, q);
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
