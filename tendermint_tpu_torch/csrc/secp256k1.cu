// The secp256k1 ECDSA kernels (one Strauss+GLV ladder a signature, on a
// quad of threads) for sm_90a.
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
// each high word), 72; a squaring at least 28 cross products, 8 squares
// and the 8 of the fold, 44; a multiply by 21 forms 8. That is 2,475 x
// 72 + 260 x 44 + 412 x 8 = 192,936 a signature, 1.98 G at 10,240 signatures,
// against 27.11 IMAD.WIDE.U32 an SM issues a clock
// (tools/torch_imad_rate.py) x 132 SMs x 1,980 MHz: 0.279 ms. The bytes
// (about 1.5 MB at 10,240 signatures) take 0.0005 ms at 3.35 TB/s, so it
// is bound by operations.
//
// What the design does about it. A signature's 130 iterations are one
// dependent chain, but each doubling and addition comes in two rounds of
// independent products (4 and 4, 6 and 6). So a quad of four adjacent
// threads runs a signature, each thread forming its share of every round
// with the same fp_mul on operands it picks by its place in the quad (its
// role): a doubling one product a thread a round, an addition two a
// thread a round, of which roles 1 and 2's second goes unused (the warp
// runs a product for all four roles or for none; quad_double, quad_add).
// The quad passes elements by __shfl_sync of width 4, 8 words each, only
// to the threads that need them: an iteration takes 10 such exchanges,
// and a thread forms 6 products where one thread formed 20. The
// squarings run as multiplies (a squaring in two roles and a multiply in
// the other two would run the warp through both; the kernel has no
// squaring function), and roles 0 and 3 both
// form the addition's 21 t2: the kernel forms 3,299 multiplies and 553
// multiplies by 21 a signature, 241,952 32 x 32 -> 64 products (the CPU
// stand-in of tests/test_torch_secp.py counts them, SECP_KERNEL_WIDE)
// against the bound's 192,936. The
// sums, differences and folds run as PTX carry chains, one instruction a
// word, and a fold's second pass touches the words it can change; they
// were a third of the iteration's instructions. At 10,240 signatures the
// launch is 40,960 threads in 640 blocks of 64 (16 signatures), all 132
// SMs busy. The 16-entry table (1,536 bytes a signature) lives in shared
// memory, 26,624 bytes a block with its padding, laid out so that the
// data-dependent entry each of a warp's eight signatures reads an
// iteration falls on banks of its own for each coordinate (tbl_load); the
// quad builds it (its 11 additions run as the ladder's do) and a
// __syncwarp orders each entry's stores before its reads. A quad past the
// end of the batch runs on a clamped signature with its stores masked, so
// every thread reaches every shuffle. Values stay below 2^256 between
// operations ("weak"), canonical only at the end; an element is 8 words
// of 32 bits, a product the 64 schoolbook multiply-adds with 64-bit
// accumulation (one mad.wide.u32 each), its high half folded through
// 2^256 = 2^32 + 977 (mod p).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/torch_ladder_ab.py,
// parent, change, change, parent; PERF.md §6): secp_verify 1.186 and
// 1.189 ms, secp_verify_cached 1.183 and 1.192 at 10,240 signatures,
// against 1.554 / 1.557 and 1.542 / 1.545 for the one-thread design (255
// registers, 1,680 / 1,728-byte stacks, 120 / 208 bytes spilled): 23.5%
// of the bound; 0.61, 0.82, 1.18, 1.85 and 3.54 ms at 2,560, 5,120,
// 10,240, 20,480 and 40,960 signatures. ptxas: 118 and 125 registers, no
// stack, 0 bytes spilled. An iteration runs 2,734 instructions a warp of
// eight signatures (452 IMAD.WIDE, 1,523 IADD3 and IADD3.X, 250 SEL, 80
// SHFL; the tool's `loop`), the one-thread design 7,688 for 32: the quad
// forms 6 products where one thread formed 20, but runs the sums and
// choices of all four roles. A pair of threads a signature (3 + 3
// products a round, 8 exchanges, 32-thread blocks) took 1.46 / 1.63 ms
// with the same field code.
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
constexpr int THREADS = 64;  // 16 signatures a block, a quad each
// the table's 26,624 bytes allow 8 blocks an SM, and so do the registers
constexpr int MIN_BLOCKS = 8;
constexpr unsigned QUAD_ALL = 0xffffffffu;
constexpr uint32_t FOLD = 977;  // 2^256 = 2^32 + 977 (mod p)

struct fp {
  uint32_t v[NW];
};

__device__ __forceinline__ fp fp_word(uint32_t w) {
  fp r;
  r.v[0] = w;
  for (int i = 1; i < NW; ++i) r.v[i] = 0;
  return r;
}

// r += k (2^32 + 977) for k below 2^33; returns the carry out of 2^256.
// On the card these sums are PTX carry chains (add.cc / addc, sub.cc /
// subc), one instruction a word; the CPU stand-in runs the same sums in
// 64-bit C++.
__device__ __forceinline__ uint32_t add_fold(fp& r, uint64_t k) {
#ifdef __CUDA_ARCH__
  const uint32_t kl = (uint32_t)k, kh = (uint32_t)(k >> 32);
  uint32_t c;
  asm("{\n\t.reg .u32 lo, hi, w1, w2;\n\t"
      "mul.lo.u32 lo, %9, 977;\n\t"
      "mul.hi.u32 hi, %9, 977;\n\t"
      "mad.lo.u32 hi, %10, 977, hi;\n\t"
      "add.cc.u32 w1, hi, %9;\n\t"
      "addc.u32 w2, %10, 0;\n\t"
      "add.cc.u32 %0, %0, lo;\n\t"
      "addc.cc.u32 %1, %1, w1;\n\t"
      "addc.cc.u32 %2, %2, w2;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, 0, 0;\n\t}"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
        "+r"(r.v[6]), "+r"(r.v[7]), "=r"(c)
      : "r"(kl), "r"(kh));
  return c;
#else
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
#endif
}

// r += k (2^32 + 977) for k in {0, 1}, r below 2^66 where k is 1: words
// 0 to 2 alone change.
__device__ __forceinline__ void add_fold_low(fp& r, uint32_t k) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u32 lo;\n\t"
      "mul.lo.u32 lo, %3, 977;\n\t"
      "add.cc.u32 %0, %0, lo;\n\t"
      "addc.cc.u32 %1, %1, %3;\n\t"
      "addc.u32 %2, %2, 0;\n\t}"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2])
      : "r"(k));
#else
  uint64_t c = (uint64_t)r.v[0] + FOLD * k;
  r.v[0] = (uint32_t)c;
  c = (c >> 32) + r.v[1] + k;
  r.v[1] = (uint32_t)c;
  r.v[2] += (uint32_t)(c >> 32);
#endif
}

// A value k 2^256 + r (k below 2^33) folded below 2^256: the first fold
// carries out only where r + k (2^32 + 977) reaches 2^256, and then r is
// below 2^66, so the second changes three words and cannot carry out.
__device__ __forceinline__ void fold_top(fp& r, uint64_t k) {
  add_fold_low(r, add_fold(r, k));
}

// r -= k (2^32 + 977) for k in {0, 1}; returns the borrow.
__device__ __forceinline__ uint32_t sub_fold(fp& r, uint32_t k) {
#ifdef __CUDA_ARCH__
  uint32_t b;
  asm("{\n\t.reg .u32 lo;\n\t"
      "mul.lo.u32 lo, %9, 977;\n\t"
      "sub.cc.u32 %0, %0, lo;\n\t"
      "subc.cc.u32 %1, %1, %9;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 %8, 0, 0;\n\t}"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
        "+r"(r.v[6]), "+r"(r.v[7]), "=r"(b)
      : "r"(k));
  return b & 1;
#else
  uint64_t d = (uint64_t)r.v[0] - FOLD * k;
  r.v[0] = (uint32_t)d;
  d = (uint64_t)r.v[1] - k - (d >> 63);
  r.v[1] = (uint32_t)d;
  for (int i = 2; i < NW; ++i) {
    d = (uint64_t)r.v[i] - (d >> 63);
    r.v[i] = (uint32_t)d;
  }
  return (uint32_t)(d >> 63);
#endif
}

// Values below 2^256 in and out.
__device__ __forceinline__ fp fp_add(const fp& a, const fp& b) {
  fp r;
#ifdef __CUDA_ARCH__
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]),
        "=r"(r.v[6]), "=r"(r.v[7]), "=r"(c)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
#else
  uint64_t c = 0;
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
#endif
  fold_top(r, c);
  return r;
}

// r -= k (2^32 + 977) for k in {0, 1}, r at least 2^256 - 2^32 - 977
// where k is 1: words 0 and 1 alone change.
__device__ __forceinline__ void sub_fold_low(fp& r, uint32_t k) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u32 lo;\n\t"
      "mul.lo.u32 lo, %2, 977;\n\t"
      "sub.cc.u32 %0, %0, lo;\n\t"
      "subc.u32 %1, %1, %2;\n\t}"
      : "+r"(r.v[0]), "+r"(r.v[1])
      : "r"(k));
#else
  const uint64_t d = (uint64_t)r.v[0] - FOLD * k;
  r.v[0] = (uint32_t)d;
  r.v[1] = r.v[1] - k - (uint32_t)(d >> 63);
#endif
}

// a - b + 2^256 where a < b, then minus 2^256 - p = 2^32 + 977, twice if
// that borrows (a - b + 2p is positive); the first fold borrows only where
// r is below 2^32 + 977, and then r is at least 2^256 - 2^32 - 977.
__device__ __forceinline__ fp fp_sub(const fp& a, const fp& b) {
  fp r;
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]),
        "=r"(r.v[6]), "=r"(r.v[7]), "=r"(d)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  const uint32_t borrow = d & 1;
#else
  uint64_t d = 0;
  for (int i = 0; i < NW; ++i) {
    d = (uint64_t)a.v[i] - b.v[i] - (d >> 63);
    r.v[i] = (uint32_t)d;
  }
  const uint32_t borrow = (uint32_t)(d >> 63);
#endif
  sub_fold_low(r, sub_fold(r, borrow));
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

// ---- a quad of threads a signature ------------------------------------------
//
// Thread q of the quad (its role) forms its share of each round's products
// with the same fp_mul as the others, on operands it picks by q (a branch
// by q would run the warp through every role in turn), and the quad swaps
// elements by __shfl_sync of width 4, 8 words each. Every thread reaches
// every shuffle: nothing below branches around one; only the multiplies
// by 21 that some roles need sit in branches. An addition's rounds have 2,
// 1, 1 and 2 products, and roles 1 and 2 form a second one too, unused: a
// product the warp runs for two roles costs it the same as for four, and
// outside a branch a thread's two products interleave.

// a where c, else b, word by word (a choice between two named elements
// by a condition would take their addresses, and put them in local memory)
__device__ __forceinline__ fp pick(bool c, const fp& a, const fp& b) {
  fp r;
  for (int i = 0; i < NW; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// Role q's element of the four.
__device__ __forceinline__ fp pick4(int q, const fp& a0, const fp& a1, const fp& a2,
                                    const fp& a3) {
  fp r;
  for (int i = 0; i < NW; ++i)
    r.v[i] = q == 0 ? a0.v[i] : q == 1 ? a1.v[i] : q == 2 ? a2.v[i] : a3.v[i];
  return r;
}

// Element a of lane src of this thread's quad.
__device__ __forceinline__ fp fp_shfl(const fp& a, int src) {
  fp r;
  for (int i = 0; i < NW; ++i) r.v[i] = (uint32_t)__shfl_sync(QUAD_ALL, (int)a.v[i], src, 4);
  return r;
}

// The complete doubling, a = 0 (RCB16 Algorithm 9), on a quad. In: the
// operands of each role's first product, role 0 (Z, Z), 1 (X, Y), 2 (Y, Z),
// 3 (Y, Y). Round 1 forms t2 = 21 Z^2, XY, YZ and t0 = Y^2; two exchanges
// give roles 0 to 2 t0 and roles 0, 1 and 3 t2; round 2 forms role 0 t2 8 t0,
// 1 X3 = 2 t0m XY, 2 Z3 = YZ 8 t0 and 3 t0m (t0 + t2), t0m = t0 - 3 t2,
// where Y3 is the sum of roles 0 and 3's. Returns each role's product.
__device__ __forceinline__ fp quad_double(const fp& a0, const fp& a1, int q) {
  fp w = fp_mul(a0, a1);
  if (q == 0) w = fp_mul_small(w, 21);
  const fp g1 = fp_shfl(w, q == 3 ? 0 : 3);
  const fp t2 = fp_shfl(w, q == 2 ? 2 : 0);
  const fp t0 = pick(q == 3, w, g1);
  const fp t0m = fp_sub(t0, fp_mul3(t2));
  const fp z = fp_mul(pick(q & 1, t0m, w),
                      pick(q & 1, pick(q == 1, w, fp_add(t0, t2)), fp_shl(t0, 3)));
  return pick(q == 1, fp_shl(z, 1), z);
}

// The doubling's products to the addition's first operands: two exchanges
// give role 0 (X, Y), 1 Z, 2 (X, Z) and 3 (Y, Z) in p and r.
__device__ __forceinline__ void quad_add_in(const fp& z, int q, fp& p, fp& r) {
  const fp y = fp_add(z, fp_shfl(z, q ^ 3));
  const fp gb = fp_shfl(z, (q & 1) + 1);
  p = pick(q == 3, y, gb);
  r = pick(q == 0, y, pick(q == 2, z, gb));
}

// The complete addition, a = 0 (RCB16 Algorithm 7, b3 = 21), on a quad:
// (p, r) and (ep, er) hold coordinates of the two points as quad_add_in
// lays them out. Round 1: role 0 t0 = X1 X2 and m3 = (X1 + Y1)(X2 + Y2),
// 1 t2 = Z1 Z2, 2 m5 = (X1 + Z1)(X2 + Z2), 3 t1 = Y1 Y2 and m4 = (Y1 +
// Z1)(Y2 + Z2) (k1 and k2). Three exchanges give role 0 t1 and t2,
// 2 t0 and t2, 3 t2, and 1 t4 = m4 - (t1 + t2) from role 3 and t5_b = 21
// (m5 - (t0 + t2)) from role 2 (roles 0 and 3 form t2_b = 21 t2 each).
// Round 2: role 0 A = t3 t1m and F = t0_3 t3, 1 B = t4 t5_b,
// 2 D = t5_b t0_3, 3 C = t1m zs and E = zs t4, where X3 = A - B, Y3 = C + D
// and Z3 = E + F; t3 = m3 - (t0 + t1), t1m = t1 - t2_b, zs = t1 + t2_b,
// t0_3 = 3 t0.
__device__ __forceinline__ void quad_add(const fp& p, const fp& r, const fp& ep, const fp& er,
                                         int q, fp& o1, fp& o2) {
  const fp s = fp_add(p, r), es = fp_add(ep, er);
  const fp k1 = fp_mul(pick(q == 2, s, p), pick(q == 2, es, ep));
  const fp k2 = fp_mul(s, es);
  const fp h1 = fp_shfl(k1, q == 0 ? 3 : q == 2 ? 0 : q == 3 ? 1 : q);
  const fp mm = fp_sub(k2, fp_add(k1, h1));  // role 0 t3, 3 t4
  const fp h2 = fp_shfl(pick(q == 3, mm, k1), (q & 1) ? 3 : 1);
  fp s21 = k1;
  if (q != 1) s21 = fp_mul_small(pick4(q, h2, k1, fp_sub(k1, fp_add(h1, h2)), h1), 21);
  const fp h3 = fp_shfl(s21, q == 1 ? 2 : q);
  const fp t1m = fp_sub(pick(q == 0, h1, k1), s21);
  const fp t0_3 = fp_mul3(pick(q == 0, k1, h1));
  const fp zs = fp_add(k1, s21);
  o1 = fp_mul(pick4(q, mm, h2, s21, t1m), pick4(q, t1m, h3, t0_3, zs));
  o2 = fp_mul(pick(q == 0, t0_3, zs), mm);
}

// The addition's products to coordinates: roles 0 and 1 swap A and B
// (X3 in both), 2 and 3 D and C (Y3 in both); then role 0 takes E (Z3 = E
// + F) and role 1 Y3. Returns X3 in roles 0 and 1, Y3 in 2 and 3; z gets Z3
// in role 0 and y Y3 in role 1.
__device__ __forceinline__ fp quad_add_out(const fp& o1, const fp& o2, int q, fp& y, fp& z) {
  const fp g = fp_shfl(o1, q ^ 1);
  const fp xy = pick(q < 2, fp_sub(pick(q == 1, g, o1), pick(q == 1, o1, g)), fp_add(o1, g));
  y = fp_shfl(pick(q == 3, o2, xy), q == 0 ? 3 : q == 1 ? 2 : q);
  z = fp_add(o2, y);
  return xy;
}

// The table of a block: entry e, coordinate c, word w of the block's
// signature s at e * E_STRIDE + c * C_STRIDE + w * SIGS + s. A warp's
// eight signatures read coordinate c of their entries at banks s + 8 c +
// 16 w (mod 32): distinct for every signature and coordinate, whatever the
// entries; the threads of a quad that read the same coordinate read one
// address.
constexpr int SIGS = THREADS / 4;
constexpr int C_STRIDE = NW * SIGS + 8;
constexpr int E_STRIDE = 3 * C_STRIDE + 8;
constexpr int TBL_WORDS = 16 * E_STRIDE;

__device__ __forceinline__ fp tbl_load(const uint32_t* tbl, int e, int c, int s) {
  const uint32_t* at = tbl + e * E_STRIDE + c * C_STRIDE + s;
  fp r;
  for (int w = 0; w < NW; ++w) r.v[w] = at[w * SIGS];
  return r;
}

__device__ __forceinline__ void tbl_store(uint32_t* tbl, int e, int c, int s, const fp& a) {
  uint32_t* at = tbl + e * E_STRIDE + c * C_STRIDE + s;
  for (int w = 0; w < NW; ++w) at[w * SIGS] = a.v[w];
}

// One signature on a quad, Q given: the table, the ladder, the test. The
// table (16 points) is the block's shared table at the signature's slot
// s; the quad's four threads each build and read part of it. Returns the
// verdict before the host flags in role 0 (false in the others); where xyz
// is not null and store is set, the canonical final point goes to it
// (roles 0 and 1 write it).
__device__ __forceinline__ bool verify_quad(const fp& qx, const fp& qy, const int32_t* scal,
                                            const int32_t* sgn, const fp& r1, const fp& r2,
                                            int32_t* xyz, bool store, uint32_t* tbl, int s,
                                            int q) {
  const fp one = fp_word(1), zero = fp_word(0);
  const fp gy = fp_const(GY), qy_neg = fp_sub(zero, qy), gy_neg = fp_sub(zero, gy);
  // the bases G, phi(G), Q, phi(Q) with their signs: entries 1, 2, 4, 8
  // (role 3 forms beta qx); entry 0 is the identity (0, 1, 0)
  if (q == 0) {
    tbl_store(tbl, 0, 0, s, zero);
    tbl_store(tbl, 0, 1, s, one);
    tbl_store(tbl, 0, 2, s, zero);
    tbl_store(tbl, 1, 0, s, fp_const(GX));
    tbl_store(tbl, 1, 1, s, pick(sgn[0], gy_neg, gy));
    tbl_store(tbl, 2, 0, s, fp_const(PHI_GX));
    tbl_store(tbl, 2, 1, s, pick(sgn[1], gy_neg, gy));
    tbl_store(tbl, 4, 0, s, qx);
    tbl_store(tbl, 4, 1, s, pick(sgn[2], qy_neg, qy));
    tbl_store(tbl, 8, 1, s, pick(sgn[3], qy_neg, qy));
    for (int e = 1; e <= 8; e <<= 1) tbl_store(tbl, e, 2, s, one);
  }
  if (q == 3) tbl_store(tbl, 8, 0, s, fp_mul(qx, fp_const(BETA)));
  __syncwarp();
  // the coordinates each role reads of a point of the table (quad_add_in)
  const int cp = q == 1 ? 2 : q == 3 ? 1 : 0;
  const int cr = q == 0 ? 1 : 2;
  // the 11 subset sums, in the plain table's order: 3 = 1 + 2, 5 = 4 + 1,
  // 6 = 4 + 2, 7 = 3 + 4, then 8 + e = e + 8 for e = 1..7
#pragma unroll 1
  for (int k = 0; k < 11; ++k) {
    const int dst = k == 0 ? 3 : k < 4 ? k + 4 : k + 5;
    const int e1 = k == 0 ? 1 : k == 3 ? 3 : k < 3 ? 4 : k - 3;
    const int e2 = k >= 3 ? (k == 3 ? 4 : 8) : k == 1 ? 1 : 2;
    fp o1, o2, y, z;
    quad_add(tbl_load(tbl, e1, cp, s), tbl_load(tbl, e1, cr, s), tbl_load(tbl, e2, cp, s),
             tbl_load(tbl, e2, cr, s), q, o1, o2);
    const fp xy = quad_add_out(o1, o2, q, y, z);
    if (q == 1) tbl_store(tbl, dst, 0, s, xy);
    if (q == 2) tbl_store(tbl, dst, 1, s, xy);
    if (q == 0) tbl_store(tbl, dst, 2, s, z);
    __syncwarp();
  }

  // the ladder from the identity; a0, a1 as quad_double takes them
  fp a0 = pick(q >= 2, one, zero);
  fp a1 = pick(q & 1, one, zero);
  fp x, z;
  uint32_t kw[4];
#pragma unroll 1
  for (int b = SCALAR_BITS - 1; b >= 0; --b) {
    // digit b: bit b of each of the four scalars (word b / 32, read from
    // the scalars' rows: a word array indexed by b would live in local
    // memory)
    const int w = b >> 5, sh = b & 31;
    if (b == SCALAR_BITS - 1 || sh == 31)
      for (int j = 0; j < 4; ++j) kw[j] = (uint32_t)scal[j * SCALAR_WORDS + w];
    int d = 0;
    for (int j = 0; j < 4; ++j) d |= ((kw[j] >> sh) & 1) << j;
    fp p, r, o1, o2, y;
    quad_add_in(quad_double(a0, a1, q), q, p, r);
    quad_add(p, r, tbl_load(tbl, d, cp, s), tbl_load(tbl, d, cr, s), q, o1, o2);
    x = quad_add_out(o1, o2, q, y, z);
    // role 2 takes Z3 from role 0
    const fp g = fp_shfl(z, q == 2 ? 0 : q);
    a0 = pick(q == 0, z, x);
    a1 = pick4(q, z, y, g, x);
  }

  // role 0 holds X and Z, role 1 Y; both candidates always (the work does
  // not depend on the data)
  bool ok = false;
  if (q == 0) {
    const bool nz = !fp_is_zero(z);
    const bool eq1 = fp_is_zero(fp_sub(x, fp_mul(r1, z)));
    const bool eq2 = fp_is_zero(fp_sub(x, fp_mul(r2, z)));
    ok = nz && (eq1 | eq2);
  }
  if (xyz && store && q < 2) {
    fp_store(xyz + q * NW, fp_canon(pick(q == 0, x, a1)));
    if (q == 0) fp_store(xyz + 2 * NW, fp_canon(z));
  }
  return ok;
}

// secp_verify — replaces secp_verify.verify_kernel (secp_verify.py :139).
// A quad a signature, SIGS signatures a block; a quad past the end runs on
// a clamped signature with its stores masked. Bound: operations.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    secp_verify_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                       const int32_t* __restrict__ scalars, const int32_t* __restrict__ signs,
                       const int32_t* __restrict__ r1, const int32_t* __restrict__ r2,
                       const bool* __restrict__ ok_host, bool* __restrict__ out,
                       int32_t* __restrict__ xyz, int n) {
  __shared__ uint32_t tbl[TBL_WORDS];
  const int q = threadIdx.x & 3, s = threadIdx.x >> 2;
  const int quad = blockIdx.x * SIGS + s;
  const bool live = quad < n;
  const int i = live ? quad : n - 1;
  const bool ok = verify_quad(fp_load(qx + i * NW), fp_load(qy + i * NW),
                              scalars + i * 4 * SCALAR_WORDS, signs + i * 4, fp_load(r1 + i * NW),
                              fp_load(r2 + i * NW), xyz ? xyz + i * 3 * NW : nullptr, live, tbl,
                              s, q);
  if (q == 0 && live) out[i] = ok && ok_host[i];
}

// As secp_verify_kernel, Q from row val_idx[i] of the set's table; an
// index outside [0, v) reads row v - 1 and rejects. All four threads of a
// quad read the same row.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    secp_verify_cached_kernel(const int32_t* __restrict__ qx_tbl,
                              const int32_t* __restrict__ qy_tbl,
                              const bool* __restrict__ q_ok_tbl,
                              const int32_t* __restrict__ val_idx,
                              const int32_t* __restrict__ scalars,
                              const int32_t* __restrict__ signs, const int32_t* __restrict__ r1,
                              const int32_t* __restrict__ r2, const bool* __restrict__ ok_host,
                              bool* __restrict__ out, int32_t* __restrict__ xyz, int n, int v) {
  __shared__ uint32_t tbl[TBL_WORDS];
  const int q = threadIdx.x & 3, s = threadIdx.x >> 2;
  const int quad = blockIdx.x * SIGS + s;
  const bool live = quad < n;
  const int i = live ? quad : n - 1;
  int row = val_idx[i];
  const bool in_table = row >= 0 && row < v;
  if (!in_table) row = v - 1;
  const bool ok = verify_quad(fp_load(qx_tbl + row * NW), fp_load(qy_tbl + row * NW),
                              scalars + i * 4 * SCALAR_WORDS, signs + i * 4, fp_load(r1 + i * NW),
                              fp_load(r2 + i * NW), xyz ? xyz + i * 3 * NW : nullptr, live, tbl,
                              s, q);
  if (q == 0 && live) out[i] = ok && in_table && ok_host[i] && q_ok_tbl[row];
}

}  // namespace secp


// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. The grid is ceil(4 n / THREADS) blocks, a
// quad of threads a signature, the tail masked per quad. xyz may be null.

extern "C" int tm_secp_verify(const void* qx, const void* qy, const void* scalars,
                              const void* signs, const void* r1, const void* r2,
                              const void* ok_host, void* out, void* xyz, int n, void* stream) {
  const dim3 grid((4 * n + secp::THREADS - 1) / secp::THREADS);
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
  const dim3 grid((4 * n + secp::THREADS - 1) / secp::THREADS);
  secp::secp_verify_cached_kernel<<<grid, secp::THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qx_tbl, (const int32_t*)qy_tbl, (const bool*)q_ok_tbl,
      (const int32_t*)val_idx, (const int32_t*)scalars, (const int32_t*)signs,
      (const int32_t*)r1, (const int32_t*)r2, (const bool*)ok_host, (bool*)out, (int32_t*)xyz,
      n, v);
  return (int)cudaGetLastError();
}
