// The secp256k1 ECDSA kernels (one Strauss+GLV ladder a signature) for sm_90a.
//
// Counterpart: tendermint_tpu/ops/secp_verify.py verify_kernel (:139) and
// verify_kernel_cached (:205), XLA on the TPU; plain PyTorch versions:
// tendermint_tpu_torch/ops/secp_verify.py (verify_plain,
// verify_cached_plain), whose canonical final coordinates and verdicts
// these kernels equal word for word. Arrays, row-major with the signature
// first: qx, qy, r1, r2 (n, 8) 32-bit words, little-endian, canonical;
// scalars (n, 4, 5) words of the four GLV magnitudes; signs (n, 4);
// ok_host (n,) bool; verdicts (n,) bool; the cached kernel's table qx_tbl,
// qy_tbl (v, 8), q_ok_tbl (v,) bool and val_idx (n,). Where xyz is not
// null, the ladder's final (X, Y, Z), canonical, goes to it, (n, 3, 8).
//
// What a signature computes (ops/secp_verify.py): the bases G, phi(G), Q,
// phi(Q) with their signs, the 16-entry table of their subset sums (11
// complete additions), 130 iterations of a complete doubling and the
// complete addition of entry b1 + 2 b2 + 4 b3 + 8 b4 (RCB16 Algorithms 9
// and 7, b3 = 21), then X = r Z or X = (r + n) Z, Z != 0. Field products
// a signature: 130 x (8 + 12) in the ladder, 11 x 12 in the table, the
// beta multiply and the two candidates' products, 2,735, of which 260 are
// squarings (the doublings' Y^2 and Z^2) and 2,475 multiplies. Besides,
// 943 small-constant multiplies: 412 by 21 (130 x 1 + 141 x 2) and 531
// by 2, 3 and 8, which are shifts and additions.
//
// What bounds it: the 32 x 32 -> 64 multiply-adds. A multiply forms 64
// (the schoolbook rows) and folds the high half with 8 more (977 times
// each high word), 72; a squaring 28 cross products, 8 squares and the 8
// of the fold, 44; a multiply by 21 forms 8. That is 2,475 x 72 + 260 x
// 44 + 412 x 8 = 192,936 a signature (the CPU stand-in counts them:
// tests/test_torch_secp.py), 1.98 G at 10,240 signatures, against 27.11
// IMAD.WIDE.U32 an SM issues a clock (tools/torch_imad_rate.py) x 132 SMs
// x 1,980 MHz: 0.279 ms. The bytes (about 1.5 MB at 10,240 signatures)
// take 0.0005 ms at 3.35 TB/s, so it is bound by operations.
//
// What the design does about it: the signatures are the parallelism, one
// thread each, 10,240 threads in 80 blocks of 128, a masked tail; nothing
// is shared between threads. An element is 8 words of 32 bits; a product
// is the 64 schoolbook multiply-adds with 64-bit accumulation (one
// mad.wide.u32 each), its high half folded through 2^256 = 2^32 + 977
// (mod p), and values stay below 2^256 between operations ("weak"),
// canonical only at the end. The table (16 points of 96 bytes) lives in
// the thread's local memory and one entry is loaded an iteration. This is
// the simple design: one thread walks 130 dependent doublings and
// additions alone, and 10,240 threads fill 320 warps of the card's 528
// schedulers once.
//
// Verification handles public data, so nothing here is constant time.

#include <cuda_runtime.h>

#include <cstdint>

namespace secp {

// c + a b for 32-bit a and b and a 64-bit c: one IMAD.WIDE.U32 (as
// fe25519.cuh's WIDE_MAD). The CPU stand-in defines WIDE_MAD in plain C++
// and counts it.
#ifndef WIDE_MAD
__device__ __forceinline__ uint64_t wide_mad_ptx(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}
#define WIDE_MAD(a, b, c) wide_mad_ptx(a, b, c)
#endif

constexpr int NW = 8;
constexpr int SCALAR_WORDS = 5;
constexpr int SCALAR_BITS = 130;
constexpr int THREADS = 128;
constexpr uint32_t FOLD = 977;  // 2^256 = 2^32 + 977 (mod p)

struct fp {
  uint32_t v[NW];
};

struct pt {
  fp x, y, z;
};

__device__ __forceinline__ fp fp_word(uint32_t w) {
  fp r;
  r.v[0] = w;
  for (int i = 1; i < NW; ++i) r.v[i] = 0;
  return r;
}

// r += k (2^32 + 977) for k below 2^33; returns the carry out of 2^256.
__device__ __forceinline__ uint32_t add_fold(fp& r, uint64_t k) {
  uint64_t c = (uint64_t)r.v[0] + FOLD * k;
  r.v[0] = (uint32_t)c;
  c = (c >> 32) + r.v[1] + k;
  r.v[1] = (uint32_t)c;
  c >>= 32;
  for (int i = 2; i < NW; ++i) {
    c += r.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// A value k 2^256 + r (k below 2^33) folded below 2^256: the first fold
// carries out only where r + k (2^32 + 977) reaches 2^256, and then r is
// below 2^34 and the second cannot.
__device__ __forceinline__ void fold_top(fp& r, uint64_t k) {
  add_fold(r, add_fold(r, k));
}

// r -= k (2^32 + 977) for k in {0, 1}; returns the borrow.
__device__ __forceinline__ uint32_t sub_fold(fp& r, uint32_t k) {
  uint64_t d = (uint64_t)r.v[0] - FOLD * k;
  r.v[0] = (uint32_t)d;
  d = (uint64_t)r.v[1] - k - (d >> 63);
  r.v[1] = (uint32_t)d;
  for (int i = 2; i < NW; ++i) {
    d = (uint64_t)r.v[i] - (d >> 63);
    r.v[i] = (uint32_t)d;
  }
  return (uint32_t)(d >> 63);
}

// Values below 2^256 in and out.
__device__ __forceinline__ fp fp_add(const fp& a, const fp& b) {
  fp r;
  uint64_t c = 0;
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fold_top(r, c);
  return r;
}

// a - b + 2^256 where a < b, then minus 2^256 - p = 2^32 + 977, twice if
// that borrows (a - b + 2p is positive).
__device__ __forceinline__ fp fp_sub(const fp& a, const fp& b) {
  fp r;
  uint64_t d = 0;
  for (int i = 0; i < NW; ++i) {
    d = (uint64_t)a.v[i] - b.v[i] - (d >> 63);
    r.v[i] = (uint32_t)d;
  }
  sub_fold(r, sub_fold(r, (uint32_t)(d >> 63)));
  return r;
}

// a k for a 32-bit k (the curve's 21).
__device__ __forceinline__ fp fp_mul_small(const fp& a, uint32_t k) {
  fp r;
  uint64_t c = 0;
  for (int i = 0; i < NW; ++i) {
    c = WIDE_MAD(a.v[i], k, c >> 32);
    r.v[i] = (uint32_t)c;
  }
  fold_top(r, c >> 32);
  return r;
}

// a 2^s for s in 1..31: a shift, the bits shifted out of 2^256 folded back.
__device__ __forceinline__ fp fp_shl(const fp& a, int s) {
  fp r;
  for (int i = NW - 1; i > 0; --i) r.v[i] = (a.v[i] << s) | (a.v[i - 1] >> (32 - s));
  r.v[0] = a.v[0] << s;
  fold_top(r, a.v[NW - 1] >> (32 - s));
  return r;
}

__device__ __forceinline__ fp fp_mul3(const fp& a) { return fp_add(fp_shl(a, 1), a); }

// t = L + H 2^256 = L + 977 H + 2^32 H (mod p), t a 512-bit value in 16
// words: word j gains 977 H_j (8 multiply-adds) and H_{j-1}; the carry
// out joins H_7 and folds again.
__device__ __forceinline__ fp fp_fold512(const uint32_t* t) {
  fp r;
  uint64_t c = 0;
  for (int j = 0; j < NW; ++j) {
    c = WIDE_MAD(t[NW + j], FOLD, (uint64_t)t[j] + (j ? t[NW + j - 1] : 0u) + (c >> 32));
    r.v[j] = (uint32_t)c;
  }
  fold_top(r, (c >> 32) + t[2 * NW - 1]);
  return r;
}

// The 512-bit schoolbook product (64 multiply-adds, each row's carry into
// the next word), folded.
__device__ __forceinline__ fp fp_mul(const fp& a, const fp& b) {
  uint32_t t[2 * NW];
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < NW; ++j) {
      c = WIDE_MAD(a.v[i], b.v[j], (uint64_t)t[i + j] + (c >> 32));
      t[i + j] = (uint32_t)c;
    }
    t[i + NW] = (uint32_t)(c >> 32);
  }
  return fp_fold512(t);
}

// a^2: the 28 cross products a_i a_j (i < j) as schoolbook rows (their sum
// is below 2^511), doubled by a shift, plus the 8 squares a_i^2, folded.
__device__ __forceinline__ fp fp_sq(const fp& a) {
  uint32_t t[2 * NW];
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
  for (int i = 0; i < NW - 1; ++i) {
    uint64_t c = 0;
    for (int j = i + 1; j < NW; ++j) {
      c = WIDE_MAD(a.v[i], a.v[j], (uint64_t)t[i + j] + (c >> 32));
      t[i + j] = (uint32_t)c;
    }
    t[i + NW] = (uint32_t)(c >> 32);
  }
  for (int i = 2 * NW - 1; i > 0; --i) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
  for (int i = 0; i < NW; ++i) {
    c = WIDE_MAD(a.v[i], a.v[i], (uint64_t)t[2 * i] + (c >> 32));
    t[2 * i] = (uint32_t)c;
    c = (c >> 32) + t[2 * i + 1];
    t[2 * i + 1] = (uint32_t)c;
  }
  return fp_fold512(t);
}

// The canonical value of a value below 2^256: a - p where a >= p, which
// is where a + 2^32 + 977 carries out of 2^256 (2^256 < 2p).
__device__ __forceinline__ fp fp_canon(const fp& a) {
  fp t = a;
  const uint32_t over = add_fold(t, 1);
  return over ? t : a;
}

__device__ __forceinline__ bool fp_is_zero(const fp& a) {
  const fp c = fp_canon(a);
  uint32_t acc = 0;
  for (int i = 0; i < NW; ++i) acc |= c.v[i];
  return acc == 0;
}

__device__ __forceinline__ fp fp_load(const int32_t* p) {
  fp r;
  for (int i = 0; i < NW; ++i) r.v[i] = (uint32_t)p[i];
  return r;
}

__device__ __forceinline__ void fp_store(int32_t* p, const fp& a) {
  for (int i = 0; i < NW; ++i) p[i] = (int32_t)a.v[i];
}

// Complete projective addition, a = 0 (RCB16 Algorithm 7, b3 = 21), the
// plain point_add's operations in its order.
__device__ __forceinline__ pt point_add(const pt& p, const pt& q) {
  const fp t0 = fp_mul(p.x, q.x);
  const fp t1 = fp_mul(p.y, q.y);
  const fp t2 = fp_mul(p.z, q.z);
  const fp t3 = fp_sub(fp_mul(fp_add(p.x, p.y), fp_add(q.x, q.y)), fp_add(t0, t1));
  const fp t4 = fp_sub(fp_mul(fp_add(p.y, p.z), fp_add(q.y, q.z)), fp_add(t1, t2));
  const fp t5 = fp_sub(fp_mul(fp_add(p.x, p.z), fp_add(q.x, q.z)), fp_add(t0, t2));
  const fp t0_3 = fp_mul3(t0);
  const fp t2_b = fp_mul_small(t2, 21);
  const fp zs = fp_add(t1, t2_b);
  const fp t1m = fp_sub(t1, t2_b);
  const fp t5_b = fp_mul_small(t5, 21);
  pt r;
  r.x = fp_sub(fp_mul(t3, t1m), fp_mul(t4, t5_b));
  r.y = fp_add(fp_mul(t1m, zs), fp_mul(t5_b, t0_3));
  r.z = fp_add(fp_mul(zs, t4), fp_mul(t0_3, t3));
  return r;
}

// Complete projective doubling, a = 0 (RCB16 Algorithm 9).
__device__ __forceinline__ pt point_double(const pt& p) {
  const fp t0 = fp_sq(p.y);
  const fp y8 = fp_shl(t0, 3);
  const fp t2 = fp_mul_small(fp_sq(p.z), 21);
  pt r;
  fp x3 = fp_mul(t2, y8);
  fp y3 = fp_add(t0, t2);
  r.z = fp_mul(fp_mul(p.y, p.z), y8);
  const fp t0m = fp_sub(t0, fp_mul3(t2));
  r.y = fp_add(x3, fp_mul(t0m, y3));
  r.x = fp_shl(fp_mul(t0m, fp_mul(p.x, p.y)), 1);
  return r;
}

__device__ __constant__ uint32_t GX[NW] = {0x16F81798u, 0x59F2815Bu, 0x2DCE28D9u, 0x029BFCDBu,
                                           0xCE870B07u, 0x55A06295u, 0xF9DCBBACu, 0x79BE667Eu};
__device__ __constant__ uint32_t GY[NW] = {0xFB10D4B8u, 0x9C47D08Fu, 0xA6855419u, 0xFD17B448u,
                                           0x0E1108A8u, 0x5DA4FBFCu, 0x26A3C465u, 0x483ADA77u};
// beta Gx mod p, the x of phi(G)
__device__ __constant__ uint32_t PHI_GX[NW] = {0x00B88FCBu, 0xA7BBA044u, 0x7F15E98Du,
                                               0x87284406u, 0x96902325u, 0xAB0102B6u,
                                               0x9DA01887u, 0xBCACE2E9u};
__device__ __constant__ uint32_t BETA[NW] = {0x719501EEu, 0xC1396C28u, 0x12F58995u, 0x9CF04975u,
                                             0xAC3434E9u, 0x6E64479Eu, 0x657C0710u, 0x7AE96A2Bu};

__device__ __forceinline__ fp fp_const(const uint32_t* c) {
  fp r;
  for (int i = 0; i < NW; ++i) r.v[i] = c[i];
  return r;
}

// One signature, Q given: the table, the ladder, the test. Returns the
// verdict before the host flags; writes the canonical final point to xyz
// where it is not null.
__device__ __forceinline__ bool verify_one(const fp& qx, const fp& qy, const int32_t* scal,
                                           const int32_t* sgn, const fp& r1, const fp& r2,
                                           int32_t* xyz) {
  const fp one = fp_word(1), zero = fp_word(0);
  const fp gy = fp_const(GY), qy_neg = fp_sub(zero, qy), gy_neg = fp_sub(zero, gy);
  pt b1, b2, b3, b4;
  b1.x = fp_const(GX);
  b1.y = sgn[0] ? gy_neg : gy;
  b2.x = fp_const(PHI_GX);
  b2.y = sgn[1] ? gy_neg : gy;
  b3.x = qx;
  b3.y = sgn[2] ? qy_neg : qy;
  b4.x = fp_mul(qx, fp_const(BETA));
  b4.y = sgn[3] ? qy_neg : qy;
  b1.z = b2.z = b3.z = b4.z = one;

  pt tbl[16];
  tbl[0].x = zero;
  tbl[0].y = one;
  tbl[0].z = zero;
  tbl[1] = b1;
  tbl[2] = b2;
  tbl[3] = point_add(b1, b2);
  tbl[4] = b3;
  tbl[5] = point_add(b3, b1);
  tbl[6] = point_add(b3, b2);
  tbl[7] = point_add(tbl[3], b3);
  tbl[8] = b4;
  for (int e = 1; e < 8; ++e) tbl[8 + e] = point_add(tbl[e], b4);

  uint32_t k[4][SCALAR_WORDS];
  for (int s = 0; s < 4; ++s)
    for (int w = 0; w < SCALAR_WORDS; ++w) k[s][w] = (uint32_t)scal[s * SCALAR_WORDS + w];

  pt acc = tbl[0];
  for (int b = SCALAR_BITS - 1; b >= 0; --b) {
    const int w = b >> 5, sh = b & 31;
    const int d = ((k[0][w] >> sh) & 1) | (((k[1][w] >> sh) & 1) << 1) |
                  (((k[2][w] >> sh) & 1) << 2) | (((k[3][w] >> sh) & 1) << 3);
    acc = point_add(point_double(acc), tbl[d]);
  }

  // both candidates always (the work does not depend on the data)
  const bool nz = !fp_is_zero(acc.z);
  const bool eq1 = fp_is_zero(fp_sub(acc.x, fp_mul(r1, acc.z)));
  const bool eq2 = fp_is_zero(fp_sub(acc.x, fp_mul(r2, acc.z)));
  const bool ok_x = eq1 | eq2;
  if (xyz) {
    fp_store(xyz, fp_canon(acc.x));
    fp_store(xyz + NW, fp_canon(acc.y));
    fp_store(xyz + 2 * NW, fp_canon(acc.z));
  }
  return nz && ok_x;
}

__global__ void __launch_bounds__(THREADS)
    secp_verify_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                       const int32_t* __restrict__ scalars, const int32_t* __restrict__ signs,
                       const int32_t* __restrict__ r1, const int32_t* __restrict__ r2,
                       const bool* __restrict__ ok_host, bool* __restrict__ out,
                       int32_t* __restrict__ xyz, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const bool ok = verify_one(fp_load(qx + i * NW), fp_load(qy + i * NW),
                             scalars + i * 4 * SCALAR_WORDS, signs + i * 4,
                             fp_load(r1 + i * NW), fp_load(r2 + i * NW),
                             xyz ? xyz + i * 3 * NW : nullptr);
  out[i] = ok && ok_host[i];
}

// As secp_verify_kernel, Q from row val_idx[i] of the set's table; an
// index outside [0, v) reads row v - 1 and rejects.
__global__ void __launch_bounds__(THREADS)
    secp_verify_cached_kernel(const int32_t* __restrict__ qx_tbl,
                              const int32_t* __restrict__ qy_tbl,
                              const bool* __restrict__ q_ok_tbl,
                              const int32_t* __restrict__ val_idx,
                              const int32_t* __restrict__ scalars,
                              const int32_t* __restrict__ signs, const int32_t* __restrict__ r1,
                              const int32_t* __restrict__ r2, const bool* __restrict__ ok_host,
                              bool* __restrict__ out, int32_t* __restrict__ xyz, int n, int v) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  int row = val_idx[i];
  const bool in_table = row >= 0 && row < v;
  if (!in_table) row = v - 1;
  const bool ok = verify_one(fp_load(qx_tbl + row * NW), fp_load(qy_tbl + row * NW),
                             scalars + i * 4 * SCALAR_WORDS, signs + i * 4,
                             fp_load(r1 + i * NW), fp_load(r2 + i * NW),
                             xyz ? xyz + i * 3 * NW : nullptr);
  out[i] = ok && in_table && ok_host[i] && q_ok_tbl[row];
}

}  // namespace secp

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. The grid is ceil(n / THREADS) blocks, a
// thread a signature, the tail masked in the kernel. xyz may be null.

extern "C" int tm_secp_verify(const void* qx, const void* qy, const void* scalars,
                              const void* signs, const void* r1, const void* r2,
                              const void* ok_host, void* out, void* xyz, int n, void* stream) {
  const dim3 grid((n + secp::THREADS - 1) / secp::THREADS);
  secp::secp_verify_kernel<<<grid, secp::THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qx, (const int32_t*)qy, (const int32_t*)scalars, (const int32_t*)signs,
      (const int32_t*)r1, (const int32_t*)r2, (const bool*)ok_host, (bool*)out, (int32_t*)xyz,
      n);
  return (int)cudaGetLastError();
}

extern "C" int tm_secp_verify_cached(const void* qx_tbl, const void* qy_tbl, const void* q_ok_tbl,
                                     const void* val_idx, const void* scalars, const void* signs,
                                     const void* r1, const void* r2, const void* ok_host,
                                     void* out, void* xyz, int n, int v, void* stream) {
  const dim3 grid((n + secp::THREADS - 1) / secp::THREADS);
  secp::secp_verify_cached_kernel<<<grid, secp::THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qx_tbl, (const int32_t*)qy_tbl, (const bool*)q_ok_tbl,
      (const int32_t*)val_idx, (const int32_t*)scalars, (const int32_t*)signs,
      (const int32_t*)r1, (const int32_t*)r2, (const bool*)ok_host, (bool*)out, (int32_t*)xyz,
      n, v);
  return (int)cudaGetLastError();
}
