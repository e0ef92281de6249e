// The BLS12-381 aggregated-commit kernels (pairing lane) for sm_90a.
//
// Counterpart: tendermint_tpu/ops/bls_verify.py verify_kernel (:247) and
// finalexp_kernel (:300), XLA on the TPU; plain PyTorch versions:
// tendermint_tpu_torch/ops/bls_verify.py (verify_plain, finalexp_plain),
// whose canonical outputs these kernels equal word for word (the apk sum
// runs in the same order in both, and every other value is an exact
// element of Fp12, whatever the order of its operations). The XLA layout
// (36 limbs of 11 bits, flat-tower einsums over 0/1 summation matrices) is
// a TPU workaround and is not carried over; the function is the same.
//
//   bls_miller_kernel    launch A: a block of THREADS threads a commit. The
//                        threads stride over the Vp committee rows, each
//                        summing its rows from the identity with the
//                        complete RCB addition (a = 0, b3 = 12; a masked-out
//                        row enters as the identity, no branch); a halving
//                        tree in shared memory sums the threads. Then one
//                        multi-Miller loop over the commit's two pairs, at
//                        the projective apk and at (g1.x, -g1.y, 1): 63
//                        steps of f <- f^2 l0_dbl l0_add l1_dbl l1_add, a
//                        line (XI Y, c Z w^3, -lam X w^5) in the sparse
//                        w-slots 0, 3, 5 (a skipped add's (0, 0)
//                        coefficients stay in), and f_j = conj(f). That is
//                        conj(f_0) conj(f_1) exactly: Fp12 arithmetic is
//                        exact and conjugation a ring automorphism.
//   bls_finalexp_kernel  rows of Fp12 raised to (p^12 - 1) / r exactly, a
//                        warp a chain: `fused` first multiplies the rows
//                        into one element (launch A's fused residue, one
//                        block), else a block of one warp a row (launch B,
//                        all rows at once).
//
// The final exponentiation. Easy part: m = f^((p^6 - 1)(p^2 + 1)) =
// (conj(f) / f)^(p^2 + 1). The inverse goes down the tower: f conj(f) is
// the norm to Fp6 = Fp2[w^2] (odd slots zero), its inverse by the Fp6 and
// Fp2 norms takes one Fp inversion, by the binary extended Euclidean
// algorithm on one thread (0 maps to 0, so f = 0 gives 0, as
// square-and-multiply does; every nonzero f is invertible). Then conj(f) /
// f = conj(f)^2 (f conj(f))^-1.
// Hard part: with the BLS parameter x = -0xd201000000010000,
//
//   (p^4 - p^2 + 1) / r = ((x - 1)^2 / 3) (x + p) (x^2 + p^2 - 1) + 1
//
// holds in the integers (tests/test_torch_bls.py checks it), so the chain
// a = m^((1 - x)/3) ((1 - x)/3 = E3), b = a^|x| a, c = conj(b^|x|) b^p,
// e = (c^|x|)^|x| c^(p^2) conj(c), e m gives the exact value, the one
// square-and-multiply over the 4,314 bits of (p^12 - 1) / r gives; m is in
// the cyclotomic subgroup, where conj is the inverse. (The hard part of
// Fuentes-Castaneda, Knapp and Rodriguez-Henriquez, as arkworks and
// zkcrypto run it, gives a fixed power of this value: the same verdict, not
// these words.) The five exponentiations square with Granger-Scott's
// cyclotomic square (9 Fp2 squares on Fp12 = Fp4^3, Fp4 = Fp2[w^3]) and the
// Frobenius maps multiply slot i by XI^(i (p - 1)/6) (p) or XI^(i (p^2 -
// 1)/6) (p^2, in Fp), constants in Montgomery form.
//
// Arrays (words are 32-bit, little-endian, canonical): gx, gy (vp, 12);
// masks (k, vp) bool; coeffs (k, 2, 63, 2, 2, 2, 12) [pair, step, dbl/add,
// lam/c, Fp2 component, word]; apk (k, 3, 12); f (k, 6, 2, 12); residues
// (rows, 6, 2, 12) [w-coefficient, u-component, word].
//
// Field: Fp on 12 words of 32 bits in Montgomery form (R = 2^384), the
// product with one mad.wide.u32 (WIDE_MAD) a word product, 288 a product;
// values stay in [0, p) between operations. Fp2 = Fp[u]/(u^2 + 1), Fp12 the
// reference's flat tower Fp2[w]/(w^6 - XI), XI = 1 + u: value c[2 i + s] of
// an fp12 is the u^s part of the w^i coefficient, one to one with the plain
// version's (6, 2, 36) tensor. Inputs are converted to Montgomery form on
// load (one product by R^2 mod p), outputs back (one product by 1). The line
// coefficients stay canonical: the point's X and Z are taken to X R^2 and
// Z R^2 once, so the Montgomery product of a canonical c and Z R^2 is c Z
// in Montgomery form.
//
// Layout: a team of T threads (the Miller block, T = THREADS; a warp, T =
// 32) holds its Fp12 values in shared memory (576 bytes each) and shares out
// each operation's Fp products, a whole 12-word product to a thread, with a
// barrier (__syncthreads, __syncwarp) between a stage of products and the
// stage of additions that combines them. A product a b over the w-slots of
// a and b: each slot pair (i, j) is one Karatsuba Fp2 product, 3 Fp
// products (a full Fp12 product 36 pairs, 108), the combine sums slot (i +
// j) mod 6, folding w^6 = XI. A combine adds on 13 words without reducing,
// masking the terms a thread does not take, so every thread of a warp runs
// the same additions, and reduces once (a combine that branched on its
// thread's slot would run each branch in turn). A cyclotomic square is 18
// products (Granger-Scott), a line by a line 27, f^2 by two lines' product
// (slots 0, 2, 3, 4, 5) 90. A Miller step: f^2 (108) beside the four
// lines' slots 3 and 5 (16); f^2 combined beside the two pairs'
// line-by-line products (54); those combined; f^2 L_0 (90); f^2 L_0 L_1
// (90): four stages of products, three of additions, 358 products.
//
// Operations (Fp products, 288 multiply-adds each; chip_smoke.py
// bls_fp_products, the CPU stand-in of tests/test_torch_bls.py counts them):
// a commit of bls_miller takes 14 a table row (two conversions, one
// addition), 127 additions of 12 in the tree, 6 for the points, 63 x 358 =
// 22,554 in the loop and 15 for the outputs: 14 vp + 24,099. A row of
// bls_finalexp: the easy part 2 x 108 + the norm's inverse (37, and 1
// for the Fp inversion, whose Euclidean steps are additions and halvings)
// + 54 + 10 + 108; the hard part 314 cyclotomic squares (18), 52 Fp12
// products and the p and p^2 maps (20, 10); 24 conversions: 11,748; a
// fused launch 120 more for each row past the first. The smoke's bound
// counts the cheapest published formulas instead (bls_bound_products: the
// signers' mixed additions, a multi-Miller loop with sparse line products,
// the Fuentes-Castaneda-Knapp-Rodriguez-Henriquez hard part, 7,851 a final
// exponentiation, a few percent under this exact chain's count on those
// formulas).
//
// What bounds it: the chains' dependent depth, not the card's multiply rate.
// A stage is as long as one thread's products in it (a product's carries
// run in dependent chains; tools/torch_bls_cycles.py times each part on
// the card); a final exponentiation is some 740 stages in a row (a
// cyclotomic square two, an Fp12 product on a warp four of products and one
// of additions) and the one thread's norm inverse and Euclidean inversion,
// a Miller loop 441 stages after the apk sum's 28 + 7 x 12 products of one
// thread. K = 16 commits fill 16 of the 132 SMs,
// and a warp a chain uses one of an SM's four schedulers. Later work: more
// than one warp a chain (a product spread over lanes, the Fp12 product by
// Karatsuba over Fp4 or Fp6, 54 products in two stages), the Miller loop's
// line products a step ahead of f, or more commits a window to fill the
// SMs.
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
constexpr int WARP = 32;      // bls_finalexp's block: a warp a chain
constexpr int LINE_WORDS = 2 * 2 * NW;  // (lam, c), each an Fp2
constexpr int PAIR_WORDS = N_ATE * 2 * LINE_WORDS;
constexpr int F12_WORDS = 6 * 2 * NW;
constexpr uint32_t P_INV = 0xfffcfffd;  // -p^-1 mod 2^32
constexpr uint64_t X_ABS = 0xd201000000010000ull;  // |x|, top bit 63
constexpr uint64_t E3 = 0x460055555555aaabull;     // (1 - x) / 3, top bit 62

__constant__ uint32_t P_W[NW] = {
    0xffffaaab, 0xb9feffff, 0xb153ffff, 0x1eabfffe, 0xf6b0f624, 0x6730d2a0,
    0xf38512bf, 0x64774b84, 0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
__constant__ uint32_t R2_W[NW] = {  // R^2 mod p
    0x1c341746, 0xf4df1f34, 0x09d104f1, 0x0a76e6a6, 0x4c95b6d5, 0x8de5476c,
    0x939d83c0, 0x67eb88a9, 0xb519952d, 0x9a793e85, 0x92cae3aa, 0x11988fe5};
__constant__ uint32_t R3_W[NW] = {  // R^3 mod p
    0xd94ca1e0, 0xed48ac6b, 0x03a7adf8, 0x315f831e, 0x615e29dd, 0x9a53352a,
    0x921e1761, 0x34c04e5e, 0x65724728, 0x2512d435, 0x91755d4d, 0x0aa63460};
__constant__ uint32_t ONE_W[NW] = {  // R mod p: 1 in Montgomery form
    0x0002fffd, 0x76090000, 0xc40c0002, 0xebf4000b, 0x53c758ba, 0x5f489857,
    0x70525745, 0x77ce5853, 0xa256ec6d, 0x5c071a97, 0xfa80e493, 0x15f65ec3};
__constant__ uint32_t G1X_W[NW] = {  // g1.x, canonical
    0xdb22c6bb, 0xfb3af00a, 0xf97a1aef, 0x6c55e83f, 0x171bac58, 0xa14e3a3f,
    0x9774b905, 0xc3688c4f, 0x4fa9ac0f, 0x2695638c, 0x3197d794, 0x17f1d3a7};
__constant__ uint32_t NEG_G1Y_W[NW] = {  // p - g1.y, canonical
    0xb939c2ca, 0xad54dcd6, 0x0ecb751b, 0x4e6f38ba, 0xcaac4236, 0x6655b9d5,
    0x1db507c9, 0x67816aef, 0xcf2e21f2, 0xaa7d76c8, 0x55d545a8, 0x114d1d68};
// 2^s p for s = 0..5, 13 words (the combines' reduction)
__constant__ uint32_t PK_W[6][NW + 1] = {
    {0xffffaaab, 0xb9feffff, 0xb153ffff, 0x1eabfffe, 0xf6b0f624, 0x6730d2a0, 0xf38512bf,
     0x64774b84, 0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea, 0x00000000},
    {0xffff5556, 0x73fdffff, 0x62a7ffff, 0x3d57fffd, 0xed61ec48, 0xce61a541, 0xe70a257e,
     0xc8ee9709, 0x869759ae, 0x96374f6c, 0x72ffcd34, 0x340223d4, 0x00000000},
    {0xfffeaaac, 0xe7fbffff, 0xc54ffffe, 0x7aaffffa, 0xdac3d890, 0x9cc34a83, 0xce144afd,
     0x91dd2e13, 0x0d2eb35d, 0x2c6e9ed9, 0xe5ff9a69, 0x680447a8, 0x00000000},
    {0xfffd5558, 0xcff7ffff, 0x8a9ffffd, 0xf55ffff5, 0xb587b120, 0x39869507, 0x9c2895fb,
     0x23ba5c27, 0x1a5d66bb, 0x58dd3db2, 0xcbff34d2, 0xd0088f51, 0x00000000},
    {0xfffaaab0, 0x9fefffff, 0x153ffffb, 0xeabfffeb, 0x6b0f6241, 0x730d2a0f, 0x38512bf6,
     0x4774b84f, 0x34bacd76, 0xb1ba7b64, 0x97fe69a4, 0xa0111ea3, 0x00000001},
    {0xfff55560, 0x3fdfffff, 0x2a7ffff7, 0xd57fffd6, 0xd61ec483, 0xe61a541e, 0x70a257ec,
     0x8ee9709e, 0x69759aec, 0x6374f6c8, 0x2ffcd349, 0x40223d47, 0x00000003}};
// The cyclotomic square's combine: slot i's u^s part is 3 v -+ 2 c, v the
// sum over its part's six products m (X0^2: (y0 + y1)(y0 - y1), y0 y1;
// X1^2; (X0 + X1)^2) with weights, by row: even slots' u^0 (1, 0, 1, -2, 0,
// 0) and u^1 (0, 2, 1, 2, 0, 0); slots 3 and 5's (-1, 0, -1, 0, 1, 0) and
// (0, -2, 0, -2, 0, 2); slot 1's, times XI, (-1, 2, -1, 2, 1, -2) and (-1,
// -2, -1, -2, 1, 2). Each row as the products added (5 places) and taken
// away (6 places), -1 for none.
__constant__ int8_t CYCLO_TERMS[6][11] = {
    {0, 2, -1, -1, -1, 3, 3, -1, -1, -1, -1}, {1, 1, 2, 3, 3, -1, -1, -1, -1, -1, -1},
    {4, -1, -1, -1, -1, 0, 2, -1, -1, -1, -1}, {5, 5, -1, -1, -1, 1, 1, 3, 3, -1, -1},
    {1, 1, 3, 3, 4, 0, 2, 5, 5, -1, -1},       {4, 5, 5, -1, -1, 0, 1, 1, 2, 3, 3}};
// XI^(i (p - 1)/6) for i = 1..5, (u^0, u^1) parts, Montgomery form
__constant__ uint32_t FROB1_W[5][2][NW] = {
    {{0xb319d465, 0x07089552, 0xb50a8313, 0xc6695f92, 0xd117228f, 0x97e83ccc,
      0xb2dc29ee, 0xa35baeca, 0x5daace4d, 0x1ce393ea, 0xb0fb66eb, 0x08f2220f},
     {0x4ce5d646, 0xb2f66aad, 0xfc497cec, 0x5842a06b, 0x2599d394, 0xcf4895d4,
      0x40a8e8d0, 0xc11b9cba, 0xe5a0de89, 0x2e3813cb, 0x88847faf, 0x110eefda}},
    {{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0x8671f071, 0xcd03c9e4, 0x1fcda5d2, 0x5dab2246, 0xd3851b95, 0x587042af,
      0x01bacb9e, 0x8eb60ebe, 0x83d050d2, 0x03f97d6e, 0x54638741, 0x18f02065}},
    {{0x5aa30fda, 0x7bcfa7a2, 0x2a927e7c, 0xdc17dec1, 0x6b4ebef1, 0x2f088dd8,
      0xda74d4a7, 0xd1ca2087, 0x96cebc1d, 0x2da25966, 0xbbfd87d2, 0x0e2b7eed},
     {0x5aa30fda, 0x7bcfa7a2, 0x2a927e7c, 0xdc17dec1, 0x6b4ebef1, 0x2f088dd8,
      0xda74d4a7, 0xd1ca2087, 0x96cebc1d, 0x2da25966, 0xbbfd87d2, 0x0e2b7eed}},
    {{0x867545c3, 0x890dc9e4, 0x3285a5d5, 0x2af32253, 0x309b7e2c, 0x50880866,
      0x7e881024, 0xa20d1b8c, 0xe2db9068, 0x14e4f04f, 0x1564853a, 0x14e56d3f},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
    {{0x0dbce43f, 0x82d83cf5, 0xdf9d018f, 0xa2813e53, 0x3c65e181, 0xc6f0caa5,
      0x8d50fe95, 0x7525cf52, 0xf4798a6b, 0x4a85ed50, 0x6cf8eebd, 0x171da0fd},
     {0xf242c66c, 0x3726c30a, 0xd1b6fe70, 0x7c2ac1aa, 0xba4b14a2, 0xa04007fb,
      0x66341429, 0xef517c32, 0x4ed2226b, 0x0095ba65, 0xcc86f7dd, 0x02e370ec}}};
// XI^(i (p^2 - 1)/6) for i = 1..5 (in Fp), Montgomery form
__constant__ uint32_t FROB2_W[5][NW] = {
    {0x798dba3a, 0xecfb361b, 0x91865a2c, 0xc100ddb8, 0x232bda8e, 0x0ec08ff1,
     0xf1ca4721, 0xd5c13cc6, 0xbf7b5c04, 0x47222a47, 0xe51c5f59, 0x0110f184},
    {0x798a64e8, 0x30f1361b, 0x7ece5a2a, 0xf3b8ddab, 0xc61577f7, 0x16a8ca3a,
     0x74fd029b, 0xc26a2ff8, 0x60701c6e, 0x3636b766, 0x241b6160, 0x051ba4ab},
    {0xfffcaaae, 0x43f5ffff, 0xed47fffd, 0x32b7fff2, 0xa2e99d69, 0x07e83a49,
     0x8332bb7a, 0xeca8f331, 0xa0f4c069, 0xef148d1e, 0x3eff0206, 0x040ab326},
    {0x8671f071, 0xcd03c9e4, 0x1fcda5d2, 0x5dab2246, 0xd3851b95, 0x587042af,
     0x01bacb9e, 0x8eb60ebe, 0x83d050d2, 0x03f97d6e, 0x54638741, 0x18f02065},
    {0x867545c3, 0x890dc9e4, 0x3285a5d5, 0x2af32253, 0x309b7e2c, 0x50880866,
     0x7e881024, 0xa20d1b8c, 0xe2db9068, 0x14e4f04f, 0x1564853a, 0x14e56d3f}};

struct alignas(16) fp {
  uint32_t v[NW];
};

struct fp2 {
  fp c0, c1;
};

// c[2 i + s]: the u^s part of the w^i coefficient
struct fp12 {
  fp c[12];
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

// The Montgomery product a b R^-1 mod p, operands scanned separately: a b
// in full (24 words), then the 12 reduction rows. Row i + 1 of each half
// needs row i's words from j + 1 on, so the rows overlap, where interleaved
// rows (CIOS) wait for each other's carries. With a, b < p the result is
// below 2p; one conditional subtraction ends below p.
//
// Every Fp product of the kernels goes through this function, not inlined:
// one copy of the product's code keeps a chain's loop in the instruction
// cache (the kernels run one warp to a scheduler, which has no other warp
// to hide a fetch behind).
__device__ __noinline__ fp fp_mul(const fp& a, const fp& b) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c = WIDE_MAD(a.v[j], b.v[i], (uint64_t)t[i + j] + (c >> 32));
      t[i + j] = (uint32_t)c;
    }
    t[i + NW] = (uint32_t)(c >> 32);
  }
  uint32_t carry = 0;  // into word i + NW
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * P_INV;
    uint64_t c = WIDE_MAD(m, P_W[0], (uint64_t)t[i]);
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c = WIDE_MAD(m, P_W[j], (uint64_t)t[i + j] + (c >> 32));
      t[i + j] = (uint32_t)c;
    }
    const uint64_t s = (uint64_t)t[i + NW] + (c >> 32) + carry;
    t[i + NW] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  fp r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = t[NW + j];
  return fp_reduce_once(r);
}

__device__ __forceinline__ fp to_mont(const fp& a) { return fp_mul(a, fp_const(R2_W)); }

__device__ __forceinline__ fp from_mont(const fp& a) {
  fp one = fp_zero();
  one.v[0] = 1;
  return fp_mul(a, one);
}

__device__ __forceinline__ bool fp_is(const fp& a, uint32_t w0) {
  uint32_t d = a.v[0] ^ w0;
#pragma unroll
  for (int i = 1; i < NW; ++i) d |= a.v[i];
  return d == 0;
}

// a >> 1 (plain integers), the top word taking `hi`
__device__ __forceinline__ fp fp_half(const fp& a, uint32_t hi) {
  fp r;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) r.v[i] = (a.v[i] >> 1) | (a.v[i + 1] << 31);
  r.v[NW - 1] = (a.v[NW - 1] >> 1) | (hi << 31);
  return r;
}

// a / 2 mod p: a + p (no carry out of 382 bits) when a is odd, halved
__device__ __forceinline__ fp fp_div2(const fp& a) {
  const uint32_t m = 0u - (a.v[0] & 1u);
  fp r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.v[i] + (P_W[i] & m);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return fp_half(r, (uint32_t)c);
}

// a - b (plain integers), and whether that borrowed
__device__ __forceinline__ fp fp_minus(const fp& a, const fp& b, bool& borrowed) {
  fp r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t d = (uint64_t)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  borrowed = borrow != 0;
  return r;
}

// A plain integer of 13 words: the combines add values below p without
// reducing (a sum of under 32 of them fits), the same additions on every
// thread, the terms a thread does not take masked to 0, and reduce once.
struct wide {
  uint32_t v[NW + 1];
};

__device__ __forceinline__ wide wide_zero() {
  wide r;
#pragma unroll
  for (int i = 0; i <= NW; ++i) r.v[i] = 0;
  return r;
}

// a += b and a -= b on 13 words (sub_wide returns the borrow as a mask):
// on the card one carry chain each (add.cc / addc.cc, sub.cc / subc.cc,
// one instruction a word); the CPU stand-in compiles the plain loops.
__device__ __forceinline__ void add_wide(uint32_t* a, const uint32_t* b) {
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %0, %13;\n\t"
      "addc.cc.u32 %1, %1, %14;\n\t"
      "addc.cc.u32 %2, %2, %15;\n\t"
      "addc.cc.u32 %3, %3, %16;\n\t"
      "addc.cc.u32 %4, %4, %17;\n\t"
      "addc.cc.u32 %5, %5, %18;\n\t"
      "addc.cc.u32 %6, %6, %19;\n\t"
      "addc.cc.u32 %7, %7, %20;\n\t"
      "addc.cc.u32 %8, %8, %21;\n\t"
      "addc.cc.u32 %9, %9, %22;\n\t"
      "addc.cc.u32 %10, %10, %23;\n\t"
      "addc.cc.u32 %11, %11, %24;\n\t"
      "addc.u32 %12, %12, %25;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]),
        "+r"(a[7]), "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]),
        "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]), "r"(b[12]));
#else
  uint64_t c = 0;
  for (int i = 0; i <= NW; ++i) {
    c += (uint64_t)a[i] + b[i];
    a[i] = (uint32_t)c;
    c >>= 32;
  }
#endif
}

__device__ __forceinline__ uint32_t sub_wide(uint32_t* a, const uint32_t* b) {
#ifdef __CUDA_ARCH__
  uint32_t borrow;
  const uint32_t zero = 0;
  asm("sub.cc.u32 %0, %0, %14;\n\t"
      "subc.cc.u32 %1, %1, %15;\n\t"
      "subc.cc.u32 %2, %2, %16;\n\t"
      "subc.cc.u32 %3, %3, %17;\n\t"
      "subc.cc.u32 %4, %4, %18;\n\t"
      "subc.cc.u32 %5, %5, %19;\n\t"
      "subc.cc.u32 %6, %6, %20;\n\t"
      "subc.cc.u32 %7, %7, %21;\n\t"
      "subc.cc.u32 %8, %8, %22;\n\t"
      "subc.cc.u32 %9, %9, %23;\n\t"
      "subc.cc.u32 %10, %10, %24;\n\t"
      "subc.cc.u32 %11, %11, %25;\n\t"
      "subc.cc.u32 %12, %12, %26;\n\t"
      "subc.u32 %13, %27, %27;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]),
        "+r"(a[7]), "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12]),
        "=r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]),
        "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]), "r"(b[12]), "r"(zero));
  return borrow;
#else
  uint32_t borrow = 0;
  for (int i = 0; i <= NW; ++i) {
    const uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    a[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return 0u - borrow;
#endif
}

// a += x where take
__device__ __forceinline__ void wide_add(wide& a, const fp& x, bool take) {
  const uint32_t m = 0u - (uint32_t)take;
  uint32_t b[NW + 1];
#pragma unroll
  for (int i = 0; i < NW; ++i) b[i] = x.v[i] & m;
  b[NW] = 0;
  add_wide(a.v, b);
}

// (pos - neg) mod p for pos, neg below 32 p: pos + 32 p - neg lies in (0,
// 64 p), and 32 p, 16 p, ..., p come off where they fit.
__device__ __forceinline__ fp wide_reduce(const wide& pos, const wide& neg) {
  wide v = pos;
  add_wide(v.v, PK_W[5]);
  sub_wide(v.v, neg.v);
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    wide d = v;
    const uint32_t m = sub_wide(d.v, PK_W[k]);  // borrowed: keep v
#pragma unroll
    for (int i = 0; i <= NW; ++i) v.v[i] = (v.v[i] & m) | (d.v[i] & ~m);
  }
  fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[i] = v.v[i];
  return r;
}

// a^-1 for a in Montgomery form (a R -> a^-1 R), and 0 for 0, on one
// thread: the binary extended Euclidean algorithm on the word a (a x1 = u
// and a x2 = v mod p throughout, x1 and x2 in [0, p)) gives (a R)^-1 =
// a^-1 R^-1, and one product by R^3 mod p the Montgomery form. Some 760
// halvings and subtractions of 12 words, against 380 squares for a^(p - 2).
__device__ __noinline__ fp fp_inv(const fp& a) {
  fp u = a, v = fp_const(P_W), x1 = fp_zero(), x2 = fp_zero();
  x1.v[0] = 1;
#pragma unroll 1
  while (!fp_is(u, 0) && !fp_is(u, 1) && !fp_is(v, 1)) {
#pragma unroll 1
    while ((u.v[0] & 1u) == 0) {
      u = fp_half(u, 0);
      x1 = fp_div2(x1);
    }
#pragma unroll 1
    while ((v.v[0] & 1u) == 0) {
      v = fp_half(v, 0);
      x2 = fp_div2(x2);
    }
    bool less;
    const fp d = fp_minus(u, v, less);
    if (!less) {
      u = d;
      x1 = fp_sub(x1, x2);
    } else {
      v = fp_minus(v, u, less);
      x2 = fp_sub(x2, x1);
    }
  }
  return fp_mul(fp_is(u, 0) ? u : fp_is(u, 1) ? x1 : x2, fp_const(R3_W));
}

// ---- Fp2, on one thread (the norm's inverse) --------------------------------

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

// d <- d^-1 for d = f conj(f) in Fp6 = Fp2[g]/(g^3 - XI), g = w^2: its
// slots 0, 2, 4 are d0, d1, d2 (the odd slots are zero and stay so). With
// t0 = d0^2 - XI d1 d2, t1 = XI d2^2 - d0 d1, t2 = d1^2 - d0 d2 and the norm
// N = d0 t0 + XI (d2 t1 + d1 t2) in Fp2, d^-1 = (t0, t1, t2) / N, and 1/N =
// conj(N) / (N0^2 + N1^2): 37 products and one inversion, 0 for d = 0.
__device__ __noinline__ void norm_inverse(fp12& d) {
  const fp2 d0{d.c[0], d.c[1]}, d1{d.c[4], d.c[5]}, d2{d.c[8], d.c[9]};
  const fp2 t0 = fp2_sub(fp2_sqr(d0), fp2_mul_xi(fp2_mul(d1, d2)));
  const fp2 t1 = fp2_sub(fp2_mul_xi(fp2_sqr(d2)), fp2_mul(d0, d1));
  const fp2 t2 = fp2_sub(fp2_sqr(d1), fp2_mul(d0, d2));
  const fp2 n = fp2_add(fp2_mul(d0, t0), fp2_mul_xi(fp2_add(fp2_mul(d2, t1), fp2_mul(d1, t2))));
  const fp ni = fp_inv(fp_add(fp_mul(n.c0, n.c0), fp_mul(n.c1, n.c1)));
  const fp2 nv{fp_mul(n.c0, ni), fp_neg(fp_mul(n.c1, ni))};
  const fp2 r0 = fp2_mul(t0, nv), r1 = fp2_mul(t1, nv), r2 = fp2_mul(t2, nv);
  d.c[0] = r0.c0;
  d.c[1] = r0.c1;
  d.c[4] = r1.c0;
  d.c[5] = r1.c1;
  d.c[8] = r2.c0;
  d.c[9] = r2.c1;
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

// ---- Fp12 over a team of T threads ----------------------------------------------

template <int T>
__device__ __forceinline__ void team_sync() {
  if constexpr (T == WARP) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The w-slot sets of a product's operands: all six; a line's 0, 3, 5; the
// product of two lines, all but 1; an Fp6 element's 0, 2, 4.
constexpr int ALL = 0, LINE = 1, TWO_LINES = 2, EVEN = 3;

template <int S>
constexpr int n_slots = S == ALL ? 6 : S == TWO_LINES ? 5 : 3;

template <int S>
__device__ __forceinline__ int slot_of(int x) {
  if constexpr (S == ALL) return x;
  if constexpr (S == LINE) return x == 0 ? 0 : 2 * x + 1;
  if constexpr (S == TWO_LINES) return x == 0 ? 0 : x + 1;
  return 2 * x;
}

// x's place in the set S for the slot x, -1 where S lacks it
template <int S>
__device__ __forceinline__ int index_of(int x) {
  if constexpr (S == ALL) return x;
  if constexpr (S == LINE) return x == 0 ? 0 : x == 3 ? 1 : x == 5 ? 2 : -1;
  if constexpr (S == TWO_LINES) return x == 1 ? -1 : x == 0 ? 0 : x - 1;
  return (x & 1) ? -1 : x >> 1;
}

// The operands of Fp product q of a b: slot pair q / 3 (a's slot varying
// fastest), the Karatsuba part q % 3: a0 b0, a1 b1, (a0 + a1)(b0 + b1).
template <int SA, int SB>
__device__ __forceinline__ void pair_operands(fp& x, fp& y, const fp12& a, const fp12& b, int q) {
  const int pr = q / 3, part = q - 3 * pr;
  const int i = slot_of<SA>(pr % n_slots<SA>), j = slot_of<SB>(pr / n_slots<SA>);
  if (part < 2) {
    x = a.c[2 * i + part];
    y = b.c[2 * j + part];
  } else {
    x = fp_add(a.c[2 * i], a.c[2 * i + 1]);
    y = fp_add(b.c[2 * j], b.c[2 * j + 1]);
  }
}

// Value o (slot k = o / 2, u-part o % 2) of a b from the products of
// pair_operands: a pair (i, j) gives (t0 - t1) + (t2 - t0 - t1) u at slot
// i + j, and below 6 it adds as it is; at i + j = k + 6, times XI: (2 t0 -
// t2) + (t2 - 2 t1) u. Each of a's slots i meets the one slot j = k - i mod
// 6 of b, if b has it: every thread makes the same additions.
template <int SA, int SB>
__device__ __forceinline__ fp pair_combine(const fp* prod, int o) {
  const int k = o >> 1;
  const bool im = o & 1;
  wide pos = wide_zero(), neg = wide_zero();
#pragma unroll
  for (int x = 0; x < n_slots<SA>; ++x) {
    const int i = slot_of<SA>(x);
    const int y = index_of<SB>(k >= i ? k - i : k - i + 6);
    const bool hit = y >= 0, hi = i > k;
    const fp* t = prod + 3 * (x + n_slots<SA> * (hit ? y : 0));
    wide_add(pos, t[im ? 2 : 0], hit);
    wide_add(pos, t[0], hit && hi && !im);
    wide_add(neg, t[im ? (hi ? 1 : 0) : (hi ? 2 : 1)], hit);
    wide_add(neg, t[1], hit && im);
  }
  return wide_reduce(pos, neg);
}

// out = a b (out may be a or b): a stage of products, a stage of additions.
template <int T, int SA, int SB>
__device__ void team_mul(fp12& out, const fp12& a, const fp12& b, fp* prod, int t) {
#pragma unroll 1
  for (int q = t; q < 3 * n_slots<SA> * n_slots<SB>; q += T) {
    fp x, y;
    pair_operands<SA, SB>(x, y, a, b, q);
    prod[q] = fp_mul(x, y);
  }
  team_sync<T>();
  for (int o = t; o < 12; o += T) out.c[o] = pair_combine<SA, SB>(prod, o);
  team_sync<T>();
}

template <int T>
__device__ void team_copy(fp12& out, const fp12& in, int t) {
  for (int o = t; o < 12; o += T) out.c[o] = in.c[o];
  team_sync<T>();
}

// out = in^(p^6): the odd slots negated (out may be in)
template <int T>
__device__ void team_conj(fp12& out, const fp12& in, int t) {
  for (int o = t; o < 12; o += T) out.c[o] = (o & 2) ? fp_neg(in.c[o]) : in.c[o];
  team_sync<T>();
}

// out = in^(p^2): slot i times XI^(i (p^2 - 1)/6), in Fp (out may be in)
template <int T>
__device__ void team_frob2(fp12& out, const fp12& in, int t) {
#pragma unroll 1
  for (int o = t; o < 12; o += T)
    out.c[o] = o < 2 ? in.c[o] : fp_mul(in.c[o], fp_const(FROB2_W[(o >> 1) - 1]));
  team_sync<T>();
}

// out = in^p (out != in): slot i conjugated over Fp, times XI^(i (p - 1)/6)
// = (g0, g1): products a0 g0, a1 g1, a0 g1, a1 g0 of a = conj(slot i).
template <int T>
__device__ void team_frob1(fp12& out, const fp12& in, fp* prod, int t) {
#pragma unroll 1
  for (int q = t; q < 20; q += T) {
    const int i = 1 + (q >> 2), r = q & 3;
    const fp a = (r == 0 || r == 2) ? in.c[2 * i] : fp_neg(in.c[2 * i + 1]);
    prod[q] = fp_mul(a, fp_const(FROB1_W[i - 1][(r == 1 || r == 2) ? 1 : 0]));
  }
  team_sync<T>();
  for (int o = t; o < 12; o += T) {
    if (o < 2) {
      out.c[o] = o ? fp_neg(in.c[o]) : in.c[o];
    } else {
      const fp* p = prod + 4 * ((o >> 1) - 1);
      out.c[o] = (o & 1) ? fp_add(p[2], p[3]) : fp_sub(p[0], p[1]);
    }
  }
  team_sync<T>();
}

// f <- f^2 for f in the cyclotomic subgroup (Granger-Scott): Fp12 = Fp4[w]/
// (w^3 - v), Fp4 = Fp2[v]/(v^2 - XI), v = w^3, f = A + B w + C w^2 with A =
// (slots 0, 3), B = (1, 4), C = (2, 5). Each X of A, B, C squares as
// (X0^2 + XI X1^2) + ((X0 + X1)^2 - X0^2 - X1^2) v: 3 Fp2 squares, 2 Fp
// products each (y0 + y1)(y0 - y1), y0 y1. Then A' = 3 A^2 - 2 conj(A), B' =
// 3 v C^2 + 2 conj(B), C' = 3 B^2 - 2 conj(C), conj(X) = X0 - X1 v: slot i
// reads the part (2 i) mod 3, and each slot's own old value.
template <int T>
__device__ void team_cyclo_sqr(fp12& f, fp* prod, int t) {
#pragma unroll 1
  for (int q = t; q < 18; q += T) {
    const int part = q / 6, sq = (q >> 1) % 3;  // sq: X0, X1, X0 + X1
    const fp* x0 = &f.c[2 * part];
    const fp* x1 = &f.c[2 * part + 6];
    fp y0, y1;
    if (sq == 0) {
      y0 = x0[0];
      y1 = x0[1];
    } else if (sq == 1) {
      y0 = x1[0];
      y1 = x1[1];
    } else {
      y0 = fp_add(x0[0], x1[0]);
      y1 = fp_add(x0[1], x1[1]);
    }
    fp x, y;
    if (q & 1) {
      x = y0;
      y = y1;
    } else {
      x = fp_add(y0, y1);
      y = fp_sub(y0, y1);
    }
    prod[q] = fp_mul(x, y);
  }
  team_sync<T>();
  for (int o = t; o < 12; o += T) {
    const int i = o >> 1;
    const fp* p = prod + 6 * ((2 * i) % 3);
    const int8_t* w = CYCLO_TERMS[((i & 1) == 0 ? 0 : i == 1 ? 4 : 2) + (o & 1)];
    wide pos = wide_zero(), neg = wide_zero();
#pragma unroll
    for (int u = 0; u < 11; ++u) wide_add(u < 5 ? pos : neg, p[w[u] < 0 ? 0 : w[u]], w[u] >= 0);
    const fp v = wide_reduce(pos, neg);
    const fp c = f.c[o];
    pos = wide_zero();
    neg = wide_zero();
    wide_add(pos, v, true);
    wide_add(pos, v, true);
    wide_add(pos, v, true);
    wide_add(pos, c, i & 1);
    wide_add(pos, c, i & 1);
    wide_add(neg, c, !(i & 1));
    wide_add(neg, c, !(i & 1));
    f.c[o] = wide_reduce(pos, neg);
  }
  team_sync<T>();
}

// r = x^e for x in the cyclotomic subgroup, e's bits below its top bit
// `top` (r != x)
template <int T>
__device__ void team_cyclo_pow(fp12& r, const fp12& x, uint64_t e, int top, fp* prod, int t) {
  team_copy<T>(r, x, t);
#pragma unroll 1
  for (int b = top - 1; b >= 0; --b) {
    team_cyclo_sqr<T>(r, prod, t);
    if ((e >> b) & 1) team_mul<T, ALL, ALL>(r, r, x, prod, t);
  }
}

// f <- f^((p^12 - 1) / r), exactly (the header's chain); v: 6 values of
// scratch, prod: 108 products
template <int T>
__device__ void final_exp(fp12& f, fp12* v, fp* prod, int t) {
  fp12 &c = v[0], &m = v[1], &a = v[2], &b = v[3], &x = v[4], &y = v[5];
  // the easy part: m = (conj(f) / f)^(p^2 + 1)
  team_conj<T>(c, f, t);
  team_mul<T, ALL, ALL>(x, f, c, prod, t);  // the norm to Fp6: odd slots zero
  team_mul<T, ALL, ALL>(c, c, c, prod, t);
  if (t == 0) norm_inverse(x);
  team_sync<T>();
  team_mul<T, ALL, EVEN>(m, c, x, prod, t);  // conj(f)^2 / (f conj(f))
  team_frob2<T>(x, m, t);
  team_mul<T, ALL, ALL>(m, x, m, prod, t);
  // the hard part: m^((p^4 - p^2 + 1) / r)
  team_cyclo_pow<T>(a, m, E3, 62, prod, t);  // a = m^((1 - x)/3)
  team_cyclo_pow<T>(b, a, X_ABS, 63, prod, t);
  team_mul<T, ALL, ALL>(b, b, a, prod, t);  // b = a^(1 - x)
  team_cyclo_pow<T>(x, b, X_ABS, 63, prod, t);
  team_conj<T>(x, x, t);  // b^x
  team_frob1<T>(y, b, prod, t);
  team_mul<T, ALL, ALL>(c, x, y, prod, t);  // c = b^(x + p)
  team_cyclo_pow<T>(x, c, X_ABS, 63, prod, t);
  team_cyclo_pow<T>(y, x, X_ABS, 63, prod, t);  // c^(x^2)
  team_frob2<T>(x, c, t);
  team_mul<T, ALL, ALL>(y, y, x, prod, t);
  team_conj<T>(x, c, t);
  team_mul<T, ALL, ALL>(y, y, x, prod, t);  // e = c^(x^2 + p^2 - 1)
  team_mul<T, ALL, ALL>(f, y, m, prod, t);
}

// out = the canonical words w (6, 2, 12) in Montgomery form
template <int T>
__device__ void team_load(fp12& out, const int32_t* w, int t) {
  for (int o = t; o < 12; o += T) out.c[o] = to_mont(fp_load(w + o * NW));
  team_sync<T>();
}

// ---- the Miller loop ------------------------------------------------------------

struct miller_smem {
  fp12 f2, line[4], ll[2];  // f^2; l0_dbl, l0_add, l1_dbl, l1_add; l0_dbl l0_add, l1_dbl l1_add
  fp prod[108], prodl[54];
};

// The operands of value q of the four lines' slots 3 and 5 at `step`: line
// q / 4 (pair line / 2, dbl or add line % 2), the u-parts of c Z (q % 4 <
// 2) and of lam X (line_store negates it), the coefficients canonical
// against X R^2 and Z R^2.
__device__ __forceinline__ void line_operands(fp& x, fp& y, const int32_t* const co[2], int step,
                                              const fp* xw, const fp* zw, int q) {
  const int l = q >> 2, r = q & 3, pair = l >> 1;
  const int32_t* lw = co[pair] + (2 * step + (l & 1)) * LINE_WORDS;
  x = fp_load(lw + ((r + 2) & 3) * NW);
  y = r < 2 ? zw[pair] : xw[pair];
}

__device__ __forceinline__ void line_store(fp12* line, int q, const fp& m) {
  const int r = q & 3;
  line[q >> 2].c[r < 2 ? 6 + r : 8 + r] = r < 2 ? m : fp_neg(m);
}

// f <- the multi-Miller loop's value over `steps` steps of both pairs, f
// <- f^2 l0_dbl l0_add l1_dbl l1_add, not conjugated; pair p's point is X R^2,
// Y, Z R^2 = xw[p], y[p], zw[p] (Montgomery form), its coefficients co[p].
// A stage gives each warp one kind of work, so no warp runs two products
// one after the other.
template <int T>
__device__ void miller_loop(fp12& f, const int32_t* const co[2], const fp* xw, const fp* y,
                            const fp* zw, int steps, miller_smem& s, int t) {
  static_assert(T >= 108 + 16 && T - 12 >= 54, "a stage is one product a thread");
  for (int o = t; o < 12; o += T) f.c[o] = o == 0 ? fp_const(ONE_W) : fp_zero();
  for (int o = t; o < 48; o += T) {  // a line's slot 0 is XI Y = (Y, Y); 1, 2 and 4 are zero
    const int l = o / 12, w = o % 12, slot = w >> 1;
    if (slot == 0) s.line[l].c[w] = y[l >> 1];
    else if (slot != 3 && slot != 5) s.line[l].c[w] = fp_zero();
  }
  team_sync<T>();
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    // f^2's 108 products beside the four lines' 16
    if (t < 108 + 16) {
      fp x, y2;
      if (t < 108) pair_operands<ALL, ALL>(x, y2, f, f, t);
      else line_operands(x, y2, co, step, xw, zw, t - 108);
      const fp m = fp_mul(x, y2);
      if (t < 108) s.prod[t] = m;
      else line_store(s.line, t - 108, m);
    }
    team_sync<T>();
    // the pairs' line-by-line products beside f^2 combined (the last 12 threads)
    if (t < 54) {
      fp x, y2;
      const int pair = t / 27;
      pair_operands<LINE, LINE>(x, y2, s.line[2 * pair], s.line[2 * pair + 1], t % 27);
      s.prodl[t] = fp_mul(x, y2);
    } else if (t >= T - 12) {
      s.f2.c[t - (T - 12)] = pair_combine<ALL, ALL>(s.prod, t - (T - 12));
    }
    team_sync<T>();
    if (t < 24) s.ll[t / 12].c[t % 12] = pair_combine<LINE, LINE>(s.prodl + 27 * (t / 12), t % 12);
    team_sync<T>();
    team_mul<T, ALL, TWO_LINES>(f, s.f2, s.ll[0], s.prod, t);
    team_mul<T, ALL, TWO_LINES>(f, f, s.ll[1], s.prod, t);
  }
}

__global__ void __launch_bounds__(THREADS)
    bls_miller_kernel(const int32_t* __restrict__ gx, const int32_t* __restrict__ gy,
                      const bool* __restrict__ masks, const int32_t* __restrict__ coeffs,
                      int32_t* __restrict__ apk, int32_t* __restrict__ f_out, int k, int vp) {
  __shared__ pt part[THREADS];
  __shared__ fp12 f;
  __shared__ fp xw[2], y[2], zw[2];
  __shared__ miller_smem s;
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
    const fp yr = to_mont(fp_load(gy + (size_t)r * NW));
    const pt q{fp_select(sel, x, fp_zero()), fp_select(sel, yr, one),
               fp_select(sel, one, fp_zero())};
    acc = point_add(acc, q);
  }
  part[tid] = acc;
  __syncthreads();
#pragma unroll 1
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) part[tid] = point_add(part[tid], part[tid + h]);
    __syncthreads();
  }
  // the pairs' points: the apk, and -g1 = (g1.x, -g1.y, 1)
  if (tid == 0) xw[0] = fp_mul(part[0].x, fp_const(R2_W));
  if (tid == 1) zw[0] = fp_mul(part[0].z, fp_const(R2_W));
  if (tid == 2) xw[1] = fp_mul(to_mont(fp_const(G1X_W)), fp_const(R2_W));
  if (tid == 3) y[1] = to_mont(fp_const(NEG_G1Y_W));
  if (tid == 4) zw[1] = fp_mul(one, fp_const(R2_W));
  if (tid == 5) y[0] = part[0].y;
  __syncthreads();
  const int32_t* const co[2] = {coeffs + (size_t)j * 2 * PAIR_WORDS,
                                coeffs + ((size_t)j * 2 + 1) * PAIR_WORDS};
  miller_loop<THREADS>(f, co, xw, y, zw, N_ATE, s, tid);
  // f_j = conj(f) and the projective apk, canonical
  if (tid < 12) {
    fp_store(f_out + (size_t)j * F12_WORDS + tid * NW,
             from_mont((tid & 2) ? fp_neg(f.c[tid]) : f.c[tid]));
  } else if (tid < 15) {
    const pt& a = part[0];
    fp_store(apk + ((size_t)j * 3 + tid - 12) * NW,
             from_mont(tid == 12 ? a.x : tid == 13 ? a.y : a.z));
  }
}

// ---- the final exponentiation ---------------------------------------------------

__global__ void __launch_bounds__(WARP)
    bls_finalexp_kernel(const int32_t* __restrict__ f, int32_t* __restrict__ out, int rows,
                        int fused) {
  __shared__ fp12 acc, row, v[6];
  __shared__ fp prod[108];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  if (r >= (fused ? 1 : rows)) return;
  team_load<WARP>(acc, f + (size_t)r * F12_WORDS, t);
  if (fused) {
#pragma unroll 1
    for (int i = 1; i < rows; ++i) {
      team_load<WARP>(row, f + (size_t)i * F12_WORDS, t);
      team_mul<WARP, ALL, ALL>(acc, acc, row, prod, t);
    }
  }
  final_exp<WARP>(acc, v, prod, t);
  for (int o = t; o < 12; o += WARP)
    fp_store(out + (size_t)r * F12_WORDS + o * NW, from_mont(acc.c[o]));
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
  bls::bls_finalexp_kernel<<<fused ? 1 : rows, bls::WARP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (int32_t*)out, rows, fused);
  return (int)cudaGetLastError();
}
