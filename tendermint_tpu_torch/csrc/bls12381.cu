// The BLS12-381 aggregated-commit kernels (pairing lane) for sm_90a.
//
// Counterpart: tendermint_tpu/ops/bls_verify.py verify_kernel (:247) and
// finalexp_kernel (:300), XLA on the TPU; plain PyTorch versions:
// tendermint_tpu_torch/ops/bls_verify.py (miller_plain, finalexp_plain),
// whose canonical outputs these kernels equal word for word (the apk sum
// runs in the same order in both). The XLA layout (36 limbs of 11 bits,
// flat-tower einsums over 0/1 summation matrices) is a TPU workaround and
// is not carried over; the function is the same.
//
//   bls_miller_kernel    launch A: a block a commit. The block's THREADS
//                        threads stride over the Vp committee rows, each
//                        summing its rows from the identity with the
//                        complete RCB addition (a = 0, b3 = 12; a masked-out
//                        row enters as the identity, no branch); a halving
//                        tree in shared memory sums the threads. Threads 0
//                        and 1 then run the commit's two Miller chains, at
//                        the projective apk and at (g1.x, -g1.y, 1): 63
//                        steps of f <- f^2, f <- f l_dbl, f <- f l_add, a line
//                        (XI Y, c Z w^3, -lam X w^5) in the sparse w-slots
//                        0, 3, 5 (a skipped add's (0, 0) coefficients stay
//                        in); each f conjugated; thread 0 forms f_j = f_0 f_1.
//   bls_finalexp_kernel  rows of Fp12 raised to (p^12 - 1) / r, MSB first,
//                        squaring on each of the 4,314 bits and multiplying
//                        on each of the 2,124 one bits; `fused` first
//                        multiplies the rows into one element (launch A's
//                        fused residue, one chain), else a block a row
//                        (launch B).
//
// Arrays (words are 32-bit, little-endian, canonical): gx, gy (vp, 12);
// masks (k, vp) bool; coeffs (k, 2, 63, 2, 2, 2, 12) [pair, step, dbl/add,
// lam/c, Fp2 component, word]; apk (k, 3, 12); f (k, 6, 2, 12); residues
// (rows, 6, 2, 12) [w-coefficient, u-component, word].
//
// Field: Fp on 12 words of 32 bits in Montgomery form (R = 2^384), the CIOS
// product with one mad.wide.u32 (WIDE_MAD) a word product, 288 a product;
// values stay in [0, p) between operations. Fp2 = Fp[u]/(u^2 + 1)
// (Karatsuba: 3 products; a square 2), Fp12 the reference's flat tower
// Fp2[w]/(w^6 - XI), XI = 1 + u: coefficient i of an Fp12 is the w^i one,
// one to one with the plain version's (6, 2, 36) tensor. A product is 36
// Fp2 products (108 Fp products), a square 21 (57), a product by a line
// 18 (54); the XI fold is additions. Inputs are converted to Montgomery
// form on load (one product by R^2 mod p); every output is converted back
// (one product by 1), so the host reads canonical integers. The line
// coefficients stay canonical: the point's X and Z are taken to X R^2 and
// Z R^2 once a chain, so the Montgomery product of a canonical c and Z R^2
// is c Z in Montgomery form. b3 = 12 and XI are additions, and the
// identity's 1 and the pad row are in Montgomery form inside the kernel.
//
// Operations (Fp products, 288 multiply-adds each): a commit of bls_miller
// takes 14 a table row (two conversions, one addition), 127 additions of
// 12 in the tree, 2 x (63 x (57 + 2 x (4 + 54))) = 21,798 in the chains,
// and 129 more (6 for the chains' points, 108 for f_j, 15 for the
// outputs' conversions): 14 vp + 23,451. A row of bls_finalexp takes
// 4,314 x 57 + 2,124 x 108 + 24 = 475,314, and a fused launch 120 more for
// each row past the first (chip_smoke.py bls_fp_products; the CPU stand-in
// of tests/test_torch_bls.py counts them). The smoke's bound counts what
// the function needs instead (bls_bound_products: the signers' additions,
// one multi-Miller loop, a structured final exponentiation of 7,851).
//
// What bounds it: the 32 x 32 -> 64 multiply-adds, but not the card's
// rate for them: a final exponentiation is one chain of 6,438 dependent
// Fp12 products (136.9 M multiply-adds) that one thread walks alone, so its
// time is one thread's issue rate and latency. At K = 16 launch A's
// chains are 32 threads in 16 blocks. The bound (the multiply-adds at the
// card's rate) is microseconds; the kernel takes what one warp can issue.
// The redesign (a warp a chain, the 36 Fp2 products spread over its lanes;
// a structured final exponentiation) is later work.
//
// Design: the simple one. An Fp12 is 144 words, so a chain's values live in
// the thread's local memory. The Fp2 products, the point addition and the
// Fp12 operations are functions (not inlined), which keeps the code small;
// the Fp product is inlined into them.
//
// Verification handles public data, so nothing here is constant time.

#include <cuda_runtime.h>

#include <cstdint>

namespace bls {

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

constexpr int NW = 12;
constexpr int N_ATE = 63;
constexpr int THREADS = 128;  // bls_miller's block (ops/bls_verify.py THREADS)
constexpr int LINE_WORDS = 2 * 2 * NW;  // (lam, c), each an Fp2
constexpr int PAIR_WORDS = N_ATE * 2 * LINE_WORDS;
constexpr int F12_WORDS = 6 * 2 * NW;
constexpr int FE_BITS = 4314;  // the bits of (p^12 - 1) / r
constexpr uint32_t P_INV = 0xfffcfffd;  // -p^-1 mod 2^32

__constant__ uint32_t P_W[NW] = {
    0xffffaaab, 0xb9feffff, 0xb153ffff, 0x1eabfffe, 0xf6b0f624, 0x6730d2a0,
    0xf38512bf, 0x64774b84, 0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
__constant__ uint32_t R2_W[NW] = {  // R^2 mod p
    0x1c341746, 0xf4df1f34, 0x09d104f1, 0x0a76e6a6, 0x4c95b6d5, 0x8de5476c,
    0x939d83c0, 0x67eb88a9, 0xb519952d, 0x9a793e85, 0x92cae3aa, 0x11988fe5};
__constant__ uint32_t ONE_W[NW] = {  // R mod p: 1 in Montgomery form
    0x0002fffd, 0x76090000, 0xc40c0002, 0xebf4000b, 0x53c758ba, 0x5f489857,
    0x70525745, 0x77ce5853, 0xa256ec6d, 0x5c071a97, 0xfa80e493, 0x15f65ec3};
__constant__ uint32_t G1X_W[NW] = {  // g1.x, canonical
    0xdb22c6bb, 0xfb3af00a, 0xf97a1aef, 0x6c55e83f, 0x171bac58, 0xa14e3a3f,
    0x9774b905, 0xc3688c4f, 0x4fa9ac0f, 0x2695638c, 0x3197d794, 0x17f1d3a7};
__constant__ uint32_t NEG_G1Y_W[NW] = {  // p - g1.y, canonical
    0xb939c2ca, 0xad54dcd6, 0x0ecb751b, 0x4e6f38ba, 0xcaac4236, 0x6655b9d5,
    0x1db507c9, 0x67816aef, 0xcf2e21f2, 0xaa7d76c8, 0x55d545a8, 0x114d1d68};
// (p^12 - 1) / r, word i holding bits 32 i .. 32 i + 31
__constant__ uint32_t FE_EXP[(FE_BITS + 31) / 32] = {
    0x5df57510, 0xc0bcb9b5, 0xe68bfb24, 0x25f98630, 0xfbd5f489, 0x4406fbc8,
    0xd12191a0, 0x8e2f8491, 0x0a6f8069, 0x3e9d7165, 0x1d4cab80, 0x226c2f01,
    0x17489119, 0x67f67c47, 0xd88592d7, 0xaf3f881b, 0xeed2161d, 0x1a67e49e,
    0x69aeb218, 0xe5b78c78, 0x043f7bbc, 0xf6539314, 0xf2701aae, 0x73f62537,
    0xe9622d2a, 0xaff1c910, 0x92caa9d4, 0x62833134, 0xbea83d19, 0x2e2f3ec2,
    0xb02faa73, 0xa4c7e79f, 0xd7961be1, 0x6c49637f, 0xe8817745, 0x08e88adc,
    0x36399917, 0x35de3f7a, 0x31759c36, 0x9c1d9f7c, 0x4ea820b0, 0xfa9e13c2,
    0xa403577d, 0x3fc56947, 0xfc5cceb7, 0xa4c1b6dc, 0x7066bca6, 0x1bbd8136,
    0x0bc62775, 0x0418a3ef, 0xa9f9e010, 0x49bf9b71, 0x7db60b17, 0x51129109,
    0xe5308f1c, 0x498345c6, 0x9dadd7c2, 0x6d8823b1, 0xd556952c, 0x92004ced,
    0xc03ef195, 0x4c6bec3e, 0x044ce6ad, 0x0a1fad20, 0xcd15948d, 0xc55d3109,
    0x2c3f0bd0, 0x334f46c0, 0x34c05739, 0x3b5a62eb, 0x1d1676a5, 0x72453841,
    0xd0463434, 0x127a1b5a, 0xc85b0129, 0x61a474c5, 0x86ef965e, 0x8dfc8e28,
    0x459f1243, 0x96532fef, 0xcdc10412, 0x40ee7169, 0xb74bb22a, 0x9c40a68e,
    0xf4684d0b, 0x25118790, 0xc8d4c01f, 0x596bc293, 0x27611212, 0x1064837f,
    0xbf24dde4, 0x077ffb10, 0xcd2b01f3, 0xc49f570b, 0x4c374693, 0x1a0c5bf2,
    0x9bc73ab6, 0x350da535, 0xe4d7acdd, 0xd2670d93, 0x6e1ab656, 0xd39099b8,
    0x978e2b0d, 0x19328148, 0x386b0e88, 0xb113f414, 0x630d9aa4, 0x07a0dce2,
    0x93753318, 0xa927e7bb, 0xad49466f, 0xe347aa68, 0x106feaf4, 0x1c0ad0d6,
    0xff3a0f0f, 0xc872ee83, 0xa660835c, 0x074e43b9, 0xe9cfee9a, 0xc0aadff5,
    0xc7deada9, 0x30698e8c, 0xab353f2c, 0xd1073776, 0xbadc3a43, 0x17848517,
    0x3f8d14a9, 0x7363baa1, 0x7d4507d0, 0xd4977b3f, 0x89ee0193, 0x496a1c0a,
    0xe1bda9c0, 0xdcc825b7, 0x02ee1db5};

struct fp {
  uint32_t v[NW];
};

struct fp2 {
  fp c0, c1;
};

struct fp12 {
  fp2 c[6];
};

struct pt {
  fp x, y, z;
};

// ---- Fp ----------------------------------------------------------------------

__device__ __forceinline__ fp fp_const(const uint32_t* w) {
  fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = w[i];
  return r;
}

__device__ __forceinline__ fp fp_zero() {
  fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ fp fp_load(const int32_t* w) {
  fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = (uint32_t)w[i];
  return r;
}

__device__ __forceinline__ void fp_store(int32_t* w, const fp& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = (int32_t)a.v[i];
}

// a where sel, else b
__device__ __forceinline__ fp fp_select(bool sel, const fp& a, const fp& b) {
  const uint32_t m = 0u - (uint32_t)sel;
  fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = (a.v[i] & m) | (b.v[i] & ~m);
  return r;
}

// a - p where that does not borrow, else a: a below 2p in, below p out
__device__ __forceinline__ fp fp_reduce_once(const fp& a) {
  fp r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t d = (uint64_t)a.v[i] - P_W[i] - borrow;
    r.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return fp_select(borrow != 0, a, r);
}

__device__ __forceinline__ fp fp_add(const fp& a, const fp& b) {
  fp r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return fp_reduce_once(r);  // a + b < 2p < 2^382: no carry out
}

__device__ __forceinline__ fp fp_sub(const fp& a, const fp& b) {
  fp r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t d = (uint64_t)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  const uint32_t m = 0u - borrow;  // a < b: add p back
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)r.v[i] + (P_W[i] & m);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

__device__ __forceinline__ fp fp_neg(const fp& a) { return fp_sub(fp_zero(), a); }

// The Montgomery product a b R^-1 mod p (CIOS). With a, b < p the running
// value stays below 2p, which fits 12 words, and the 13th word holds the
// row's carry until the shift; one conditional subtraction ends below p.
__device__ __forceinline__ fp fp_mul(const fp& a, const fp& b) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int j = 0; j <= NW; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c = WIDE_MAD(a.v[j], b.v[i], (uint64_t)t[j] + (c >> 32));
      t[j] = (uint32_t)c;
    }
    uint64_t top = (uint64_t)t[NW] + (c >> 32);
    const uint32_t m = t[0] * P_INV;
    c = WIDE_MAD(m, P_W[0], (uint64_t)t[0]);
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c = WIDE_MAD(m, P_W[j], (uint64_t)t[j] + (c >> 32));
      t[j - 1] = (uint32_t)c;
    }
    top += c >> 32;
    t[NW - 1] = (uint32_t)top;
    t[NW] = (uint32_t)(top >> 32);
  }
  fp r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = t[j];
  return fp_reduce_once(r);
}

// The same product, not inlined, for the scattered conversions.
__device__ __noinline__ fp fp_mul_call(const fp& a, const fp& b) { return fp_mul(a, b); }

__device__ __forceinline__ fp to_mont(const fp& a) { return fp_mul_call(a, fp_const(R2_W)); }

__device__ __forceinline__ fp from_mont(const fp& a) {
  fp one = fp_zero();
  one.v[0] = 1;
  return fp_mul_call(a, one);
}

// ---- Fp2 ---------------------------------------------------------------------

__device__ __forceinline__ fp2 fp2_zero() { return fp2{fp_zero(), fp_zero()}; }

__device__ __forceinline__ fp2 fp2_add(const fp2& a, const fp2& b) {
  return fp2{fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}

__device__ __forceinline__ fp2 fp2_sub(const fp2& a, const fp2& b) {
  return fp2{fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}

// XI (c0 + c1 u) = (c0 - c1) + (c0 + c1) u
__device__ __forceinline__ fp2 fp2_mul_xi(const fp2& a) {
  return fp2{fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)};
}

__device__ __noinline__ fp2 fp2_mul(const fp2& a, const fp2& b) {
  const fp t0 = fp_mul(a.c0, b.c0);
  const fp t1 = fp_mul(a.c1, b.c1);
  const fp t2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return fp2{fp_sub(t0, t1), fp_sub(t2, fp_add(t0, t1))};
}

__device__ __noinline__ fp2 fp2_sqr(const fp2& a) {
  const fp t = fp_mul(a.c0, a.c1);
  return fp2{fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1)), fp_add(t, t)};
}

// ---- Fp12 = Fp2[w]/(w^6 - XI), flat ----------------------------------------------

__device__ __forceinline__ void fp12_one(fp12& r) {
  r.c[0].c0 = fp_const(ONE_W);
  r.c[0].c1 = fp_zero();
#pragma unroll 1
  for (int i = 1; i < 6; ++i) r.c[i] = fp2_zero();
}

// r = a b (r must not alias a or b): coefficient k sums a_i b_(k-i) and XI
// times a_i b_(k+6-i).
__device__ __noinline__ void fp12_mul(fp12& r, const fp12& a, const fp12& b) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    fp2 lo = fp2_zero();
    fp2 hi = fp2_zero();
#pragma unroll 1
    for (int i = 0; i <= k; ++i) lo = fp2_add(lo, fp2_mul(a.c[i], b.c[k - i]));
#pragma unroll 1
    for (int i = k + 1; i < 6; ++i) hi = fp2_add(hi, fp2_mul(a.c[i], b.c[k + 6 - i]));
    r.c[k] = fp2_add(lo, fp2_mul_xi(hi));
  }
}

// r = a^2 (r must not alias a): 15 cross products doubled, 6 squares.
__device__ __noinline__ void fp12_sqr(fp12& r, const fp12& a) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    fp2 lo = fp2_zero();
#pragma unroll 1
    for (int i = 0; 2 * i < k; ++i) lo = fp2_add(lo, fp2_mul(a.c[i], a.c[k - i]));
    lo = fp2_add(lo, lo);
    if ((k & 1) == 0) lo = fp2_add(lo, fp2_sqr(a.c[k / 2]));
    const int e = k + 6;
    fp2 hi = fp2_zero();
#pragma unroll 1
    for (int i = e - 5; 2 * i < e; ++i) hi = fp2_add(hi, fp2_mul(a.c[i], a.c[e - i]));
    hi = fp2_add(hi, hi);
    if ((e & 1) == 0 && e / 2 <= 5) hi = fp2_add(hi, fp2_sqr(a.c[e / 2]));
    r.c[k] = fp2_add(lo, fp2_mul_xi(hi));
  }
}

// r = a l for a line l with w-slots 0, 3, 5 only (r must not alias a).
__device__ __noinline__ void fp12_mul_line(fp12& r, const fp12& a, const fp2 (&l)[3]) {
  const int slot[3] = {0, 3, 5};
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    fp2 lo = fp2_zero();
    fp2 hi = fp2_zero();
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (slot[s] <= k) lo = fp2_add(lo, fp2_mul(a.c[k - slot[s]], l[s]));
      else hi = fp2_add(hi, fp2_mul(a.c[k + 6 - slot[s]], l[s]));
    }
    r.c[k] = fp2_add(lo, fp2_mul_xi(hi));
  }
}

// f^(p^6): the odd w-coefficients negated
__device__ __forceinline__ void fp12_conj(fp12& f) {
#pragma unroll 1
  for (int i = 1; i < 6; i += 2) f.c[i] = fp2{fp_neg(f.c[i].c0), fp_neg(f.c[i].c1)};
}

__device__ __forceinline__ void fp12_load_mont(fp12& r, const int32_t* w) {
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
    r.c[i].c0 = to_mont(fp_load(w + (2 * i) * NW));
    r.c[i].c1 = to_mont(fp_load(w + (2 * i + 1) * NW));
  }
}

__device__ __forceinline__ void fp12_store_canon(int32_t* w, const fp12& a) {
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
    fp_store(w + (2 * i) * NW, from_mont(a.c[i].c0));
    fp_store(w + (2 * i + 1) * NW, from_mont(a.c[i].c1));
  }
}

// ---- G1 ----------------------------------------------------------------------

__device__ __forceinline__ pt pt_identity() {
  return pt{fp_zero(), fp_const(ONE_W), fp_zero()};
}

// Complete projective addition, a = 0 (RCB16 Algorithm 7, b3 = 12): 12
// products, valid for all inputs, the identity among them.
__device__ __noinline__ pt point_add(const pt& p, const pt& q) {
  const fp t0 = fp_mul(p.x, q.x);
  const fp t1 = fp_mul(p.y, q.y);
  const fp t2 = fp_mul(p.z, q.z);
  const fp t3 = fp_sub(fp_mul(fp_add(p.x, p.y), fp_add(q.x, q.y)), fp_add(t0, t1));
  const fp t4 = fp_sub(fp_mul(fp_add(p.y, p.z), fp_add(q.y, q.z)), fp_add(t1, t2));
  const fp t5 = fp_sub(fp_mul(fp_add(p.x, p.z), fp_add(q.x, q.z)), fp_add(t0, t2));
  const fp t0_3 = fp_add(fp_add(t0, t0), t0);
  const fp t2_4 = fp_add(fp_add(t2, t2), fp_add(t2, t2));
  const fp t2_b = fp_add(fp_add(t2_4, t2_4), t2_4);  // 12 Z1 Z2
  const fp zs = fp_add(t1, t2_b);
  const fp t1m = fp_sub(t1, t2_b);
  const fp t5_4 = fp_add(fp_add(t5, t5), fp_add(t5, t5));
  const fp t5_b = fp_add(fp_add(t5_4, t5_4), t5_4);  // 12 (X1 Z2 + X2 Z1)
  pt r;
  r.x = fp_sub(fp_mul(t3, t1m), fp_mul(t4, t5_b));
  r.y = fp_add(fp_mul(t1m, zs), fp_mul(t5_b, t0_3));
  r.z = fp_add(fp_mul(zs, t4), fp_mul(t0_3, t3));
  return r;
}

// ---- the Miller loop ------------------------------------------------------------

// The line of canonical coefficients lw (lam: 2 x 12 words, then c) at the
// point whose X R^2, Montgomery Y and Z R^2 are xw, y, zw: (XI Y, c Z,
// -lam X) in Montgomery form.
__device__ __forceinline__ void line_eval(fp2 (&l)[3], const int32_t* lw, const fp& xw,
                                          const fp& y, const fp& zw) {
  l[0] = fp2{y, y};
  l[1] = fp2{fp_mul_call(fp_load(lw + 2 * NW), zw), fp_mul_call(fp_load(lw + 3 * NW), zw)};
  l[2] = fp2{fp_neg(fp_mul_call(fp_load(lw), xw)), fp_neg(fp_mul_call(fp_load(lw + NW), xw))};
}

// `steps` steps of the Miller loop over one pair's coefficients `co` at the
// projective point (x, y, z) in Montgomery form, conjugated at the end.
__device__ __noinline__ void miller_chain(fp12& f, const int32_t* co, const fp& x, const fp& y,
                                          const fp& z, int steps) {
  const fp xw = fp_mul_call(x, fp_const(R2_W));
  const fp zw = fp_mul_call(z, fp_const(R2_W));
  fp12 t;
  fp2 l[3];
  fp12_one(f);
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    fp12_sqr(t, f);
    line_eval(l, co + (2 * step) * LINE_WORDS, xw, y, zw);
    fp12_mul_line(f, t, l);
    line_eval(l, co + (2 * step + 1) * LINE_WORDS, xw, y, zw);
    fp12_mul_line(t, f, l);
    f = t;
  }
  fp12_conj(f);
}

__global__ void __launch_bounds__(THREADS)
    bls_miller_kernel(const int32_t* __restrict__ gx, const int32_t* __restrict__ gy,
                      const bool* __restrict__ masks, const int32_t* __restrict__ coeffs,
                      int32_t* __restrict__ apk, int32_t* __restrict__ f_out, int k, int vp) {
  __shared__ pt part[THREADS];
  __shared__ fp12 fs[2];
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  if (j >= k) return;
  const bool* m = masks + (size_t)j * vp;
  const fp one = fp_const(ONE_W);
  pt acc = pt_identity();
#pragma unroll 1
  for (int r = tid; r < vp; r += THREADS) {
    const bool sel = m[r];
    const fp x = to_mont(fp_load(gx + (size_t)r * NW));
    const fp y = to_mont(fp_load(gy + (size_t)r * NW));
    const pt q{fp_select(sel, x, fp_zero()), fp_select(sel, y, one), fp_select(sel, one, fp_zero())};
    acc = point_add(acc, q);
  }
  part[tid] = acc;
  __syncthreads();
#pragma unroll 1
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) part[tid] = point_add(part[tid], part[tid + s]);
    __syncthreads();
  }
  if (tid < 2) {
    fp x, y, z;
    if (tid == 0) {
      x = part[0].x;
      y = part[0].y;
      z = part[0].z;
    } else {
      x = to_mont(fp_const(G1X_W));
      y = to_mont(fp_const(NEG_G1Y_W));
      z = one;
    }
    fp12 f;
    miller_chain(f, coeffs + ((size_t)j * 2 + tid) * PAIR_WORDS, x, y, z, N_ATE);
    fs[tid] = f;
  }
  __syncthreads();
  if (tid == 0) {
    fp12 fj;
    fp12_mul(fj, fs[0], fs[1]);
    fp12_store_canon(f_out + (size_t)j * F12_WORDS, fj);
    int32_t* a = apk + (size_t)j * 3 * NW;
    fp_store(a, from_mont(part[0].x));
    fp_store(a + NW, from_mont(part[0].y));
    fp_store(a + 2 * NW, from_mont(part[0].z));
  }
}

// ---- the final exponentiation ---------------------------------------------------

// base^((p^12 - 1) / r), MSB first
__device__ __noinline__ void final_exp(fp12& acc, const fp12& base) {
  fp12 t;
  fp12_one(acc);
#pragma unroll 1
  for (int i = FE_BITS - 1; i >= 0; --i) {
    fp12_sqr(t, acc);
    if ((FE_EXP[i >> 5] >> (i & 31)) & 1u) {
      fp12_mul(acc, t, base);
    } else {
      acc = t;
    }
  }
}

__global__ void __launch_bounds__(1)
    bls_finalexp_kernel(const int32_t* __restrict__ f, int32_t* __restrict__ out, int rows,
                        int fused) {
  const int row = blockIdx.x;
  if (threadIdx.x != 0 || row >= (fused ? 1 : rows)) return;
  fp12 base;
  if (fused) {
    fp12 x, t;
    fp12_load_mont(base, f);
#pragma unroll 1
    for (int j = 1; j < rows; ++j) {
      fp12_load_mont(x, f + (size_t)j * F12_WORDS);
      fp12_mul(t, base, x);
      base = t;
    }
  } else {
    fp12_load_mont(base, f + (size_t)row * F12_WORDS);
  }
  fp12 acc;
  final_exp(acc, base);
  fp12_store_canon(out + (size_t)row * F12_WORDS, acc);
}

}  // namespace bls

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch.

extern "C" int tm_bls_miller(const void* gx, const void* gy, const void* masks,
                             const void* coeffs, void* apk, void* f, int k, int vp,
                             void* stream) {
  bls::bls_miller_kernel<<<k, bls::THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)gx, (const int32_t*)gy, (const bool*)masks, (const int32_t*)coeffs,
      (int32_t*)apk, (int32_t*)f, k, vp);
  return (int)cudaGetLastError();
}

extern "C" int tm_bls_finalexp(const void* f, void* out, int rows, int fused, void* stream) {
  bls::bls_finalexp_kernel<<<fused ? 1 : rows, 1, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (int32_t*)out, rows, fused);
  return (int)cudaGetLastError();
}
