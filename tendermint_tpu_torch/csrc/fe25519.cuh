// GF(2^255 - 19) field and edwards25519 point functions for the kernels.
//
// Mirrors tendermint_tpu_torch/ops/fe.py and ops/point.py (themselves
// mirrors of tendermint_tpu/ops/fe_t.py and pallas_verify.py:90-220) one
// formula at a time: a field element is 20 signed 13-bit limbs in int32,
// and every operation below performs the same integer steps as its plain
// PyTorch counterpart, so kernels and plain versions agree limb for limb,
// not only modulo p.
//
// All products and sums stay below 2^31 by fe_t's bound analysis
// (fe_t.py:60-66, :103-108): one carry pass after add/sub/neg keeps limbs
// in (-1216, 2^13 + 1216], and 20 products of such limbs fit int32, so
// 32-bit IMAD suffices.
//
// nvcc compiles `>>` on a negative int as an arithmetic (sign-extending)
// shift, which the carries rely on, as fe_t's jnp `>>` and torch's do.
//
// Verification handles public data only, so nothing here is constant
// time: branches and table loads may depend on the data. The out-of-line
// (__noinline__) functions are static: each source that includes this
// header compiles its own copy, and the objects link without clashes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace edw {

// The per-signature kernels (verify.cu, sr25519.cu) run VTHREADS threads
// a block and ceil(n / VTHREADS) blocks of signatures, times y threads a
// signature, with the tail masked in the kernel.
constexpr int VTHREADS = 128;

inline dim3 sig_grid(int n, int y) { return dim3((n + VTHREADS - 1) / VTHREADS, y); }

constexpr int NL = 20;
constexpr int RADIX = 13;
constexpr int32_t MASK = (1 << RADIX) - 1;
constexpr int32_t TOP_WRAP = 608;  // 2^260 mod p = 2^5 * 19

struct fe {
  int32_t v[NL];
};

// Extended (X, Y, Z, T) point, or a Niels table entry (Y+X, Y-X, Z, 2dT).
struct pt {
  fe x, y, z, t;
};

// ---- constants (canonical limbs) ------------------------------------------

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

__device__ __forceinline__ fe fe_p() {
  return fe{{8173, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191,
             8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 255}};
}

__device__ __forceinline__ fe fe_8p() {
  return fe{{8040, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191,
             8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 2047}};
}

__device__ __forceinline__ fe fe_d() {
  return fe{{6307, 6859, 4740, 5787, 5982, 3157, 1287, 2472, 4106, 3,
             6694, 3827, 1943, 928, 3635, 8142, 2927, 1905, 219, 164}};
}

__device__ __forceinline__ fe fe_d2() {
  return fe{{4441, 5527, 1289, 3383, 3773, 6315, 2574, 4944, 20, 7,
             5196, 7655, 3886, 1856, 7270, 8092, 5855, 3810, 438, 72}};
}

__device__ __forceinline__ fe fe_sqrt_m1() {
  return fe{{176, 4213, 2514, 7222, 3150, 4668, 5311, 213, 792, 6522,
             5609, 7159, 2451, 1664, 3245, 7137, 4033, 1026, 201, 87}};
}

__device__ __forceinline__ pt base_point() {
  return pt{fe{{5402, 6446, 6179, 3162, 3221, 5081, 5270, 3090, 3271, 841,
                5911, 7085, 799, 4721, 6914, 2687, 3438, 5790, 6733, 66}},
            fe{{1624, 4915, 6553, 3276, 1638, 4915, 6553, 3276, 1638, 4915,
                6553, 3276, 1638, 4915, 6553, 3276, 1638, 4915, 6553, 204}},
            fe_one(),
            fe{{7587, 3518, 3305, 7445, 5853, 2426, 7493, 4110, 4255, 2311,
                6367, 2391, 2278, 5415, 5531, 3788, 6027, 6270, 471, 207}}};
}

// ---- field (fe.py) ----------------------------------------------------------

// One parallel carry pass; limb 19's carry wraps to limb 0 times 608.
__device__ __forceinline__ fe carry_pass(const fe& x) {
  fe o;
  o.v[0] = (x.v[0] & MASK) + (x.v[NL - 1] >> RADIX) * TOP_WRAP;
#pragma unroll
  for (int i = 1; i < NL; ++i) o.v[i] = (x.v[i] & MASK) + (x.v[i - 1] >> RADIX);
  return o;
}

__device__ __forceinline__ fe carry(const fe& x) {
  return carry_pass(carry_pass(carry_pass(x)));
}

__device__ __forceinline__ fe add(const fe& a, const fe& b) {
  fe s;
#pragma unroll
  for (int i = 0; i < NL; ++i) s.v[i] = a.v[i] + b.v[i];
  return carry_pass(s);
}

__device__ __forceinline__ fe sub(const fe& a, const fe& b) {
  fe s;
#pragma unroll
  for (int i = 0; i < NL; ++i) s.v[i] = a.v[i] - b.v[i];
  return carry_pass(s);
}

__device__ __forceinline__ fe neg(const fe& a) {
  fe s;
#pragma unroll
  for (int i = 0; i < NL; ++i) s.v[i] = -a.v[i];
  return carry_pass(s);
}

// 39 convolution coefficients -> carried 20-limb element.
__device__ __forceinline__ fe wrap_fold(const int32_t (&c)[2 * NL - 1]) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int32_t v = c[i];
    if (i < NL - 1) v += TOP_WRAP * (c[NL + i] & MASK);
    if (i >= 1) v += TOP_WRAP * (c[NL - 1 + i] >> RADIX);
    r.v[i] = v;
  }
  return carry(r);
}

__device__ __forceinline__ fe mul(const fe& a, const fe& b) {
  int32_t c[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += a.v[i] * b.v[j];
  }
  return wrap_fold(c);
}

// Squaring by convolution symmetry (fe_t.sq): 210 products instead of
// 400, the same 39 coefficients.
__device__ __forceinline__ fe sq(const fe& a) {
  int32_t c[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c[2 * i] += a.v[i] * a.v[i];
    const int32_t d = a.v[i] + a.v[i];
#pragma unroll
    for (int j = i + 1; j < NL; ++j) c[i + j] += d * a.v[j];
  }
  return wrap_fold(c);
}

__device__ __forceinline__ fe sqn(fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = sq(a);
  return a;
}

// z^(2^252 - 3), ref10 addition chain.
static __device__ __noinline__ fe pow22523(const fe z) {
  const fe x2 = sq(z);
  const fe x9 = mul(z, sqn(x2, 2));
  const fe x11 = mul(x2, x9);
  const fe x31 = mul(x9, sq(x11));
  const fe xa = mul(sqn(x31, 5), x31);
  const fe xb = mul(sqn(xa, 10), xa);
  const fe xc = mul(sqn(xb, 20), xb);
  const fe xd = mul(sqn(xc, 10), xa);
  const fe xe = mul(sqn(xd, 50), xd);
  const fe xf = mul(sqn(xe, 100), xe);
  const fe xg = mul(sqn(xf, 50), xd);
  return mul(sqn(xg, 2), z);
}

// Fold bits >= 2^255 (2^255 = 19 mod p).
__device__ __forceinline__ fe fold255(const fe& x) {
  fe b = x;
  b.v[0] = x.v[0] + 19 * (x.v[NL - 1] >> 8);
  b.v[NL - 1] = x.v[NL - 1] & 0xFF;
  return carry(b);
}

// x - p if x >= p, by a sequential borrow over the limbs.
__device__ __forceinline__ fe cond_sub_p(const fe& x) {
  const fe p = fe_p();
  fe t;
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t s = (x.v[i] - p.v[i]) + c;
    c = s >> RADIX;
    t.v[i] = s & MASK;
  }
  return c < 0 ? x : t;
}

// canon_body is the canonical reduction; canon is its out-of-line copy,
// which the one-thread decompressions call.
__device__ __forceinline__ fe canon_body(const fe x0) {
  fe x = carry(x0);
  const fe p8 = fe_8p();
#pragma unroll
  for (int i = 0; i < NL; ++i) x.v[i] += p8.v[i];
  x = carry(x);
  x = fold255(x);
  x = fold255(x);
  x = cond_sub_p(x);
  return cond_sub_p(x);
}

static __device__ __noinline__ fe canon(const fe x0) { return canon_body(x0); }

// c (canonical limbs) == 0.
__device__ __forceinline__ bool all_zero(const fe& c) {
  bool z = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) z = z && (c.v[i] == 0);
  return z;
}

__device__ __forceinline__ bool is_zero(const fe& x) { return all_zero(canon(x)); }

__device__ __forceinline__ bool eq(const fe& a, const fe& b) {
  fe d;
#pragma unroll
  for (int i = 0; i < NL; ++i) d.v[i] = a.v[i] - b.v[i];
  return is_zero(d);
}

// ---- global layout ------------------------------------------------------------
// Global arrays are (rows, g) with the batch column last: thread j works
// on column j, so neighbouring threads touch neighbouring addresses.
// Coordinates sit in 32-row slots (limbs 0..19; rows 20..31 written 0).

__device__ __forceinline__ void store_fe(int32_t* __restrict__ base, int row,
                                         const fe& x, int col, int g) {
#pragma unroll
  for (int l = 0; l < NL; ++l) base[(size_t)(row + l) * g + col] = x.v[l];
#pragma unroll
  for (int l = NL; l < 32; ++l) base[(size_t)(row + l) * g + col] = 0;
}

__device__ __forceinline__ fe load_fe(const int32_t* __restrict__ base,
                                      int row, int col, int g) {
  fe x;
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = base[(size_t)(row + l) * g + col];
  return x;
}

__device__ __forceinline__ void store_point(int32_t* __restrict__ coords,
                                            int p, const pt& P, int col, int g) {
  store_fe(coords, (p * 4 + 0) * 32, P.x, col, g);
  store_fe(coords, (p * 4 + 1) * 32, P.y, col, g);
  store_fe(coords, (p * 4 + 2) * 32, P.z, col, g);
  store_fe(coords, (p * 4 + 3) * 32, P.t, col, g);
}

// Base-4 digits of one scalar's 32 bytes (read with byte stride `bstride`
// from `src`): digit t = (byte[t >> 2] >> 2 (t & 3)) & 3 at row
// (t & 3) * 32 + (t >> 2) of the 128 rows from `row0` (pallas_verify's
// shift-grouped order).
__device__ __forceinline__ void store_digits(int32_t* __restrict__ dig, int row0,
                                             const uint8_t* __restrict__ src,
                                             size_t bstride, int col, int g) {
#pragma unroll 4
  for (int b = 0; b < 32; ++b) {
    const int32_t byte = src[(size_t)b * bstride];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      dig[(size_t)(row0 + s * 32 + b) * g + col] = (byte >> (2 * s)) & 3;
  }
}

// 32 little-endian bytes -> limbs of the low 255 bits (pallas_verify
// _unpack_limbs); the sign bit is e[31] >> 7.
__device__ __forceinline__ fe unpack_limbs(const int32_t (&e)[32]) {
  fe y;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int lo_bit = RADIX * i;
    const int byte0 = lo_bit >> 3, shift = lo_bit & 7;
    int32_t v = byte0 == 31 ? (e[31] & 0x7F) : e[byte0];
    if (byte0 + 1 < 32) v += (byte0 + 1 == 31 ? (e[31] & 0x7F) : e[byte0 + 1]) << 8;
    if (byte0 + 2 < 32 && shift + RADIX > 16)
      v += (byte0 + 2 == 31 ? (e[31] & 0x7F) : e[byte0 + 2]) << 16;
    y.v[i] = (v >> shift) & MASK;
  }
  return y;
}

// sqrt_ratio(u, v) (point.sqrt_ratio): r with v r^2 = u, multiplied by
// sqrt(-1) unless v r^2 = u already; true when v r^2 = u or -u (ZIP-215
// accepts check == -u as the RFC 8032 sqrt(-1) branch).
static __device__ __noinline__ bool sqrt_ratio(fe& r_out, const fe u, const fe v) {
  const fe v3 = mul(sq(v), v);
  const fe v7 = mul(sq(v3), v);
  fe r = mul(mul(u, v3), pow22523(mul(u, v7)));
  const fe check = mul(v, sq(r));
  const bool ok_pos = eq(check, u);
  const bool ok_neg = is_zero(add(check, u));
  if (!ok_pos) r = mul(r, fe_sqrt_m1());
  r_out = r;
  return ok_pos || ok_neg;
}

// ZIP-215 decompression (pallas_verify.decompress): y is carried but not
// reduced, so a non-canonical y is accepted; the sign flip uses the
// canonical x.
static __device__ __noinline__ bool decompress(pt& o, const int32_t (&e)[32]) {
  const fe one = fe_one();
  const fe y = carry(unpack_limbs(e));
  const int32_t sign = e[31] >> 7;
  const fe yy = sq(y);
  const fe u = sub(yy, one);
  const fe v = add(mul(fe_d(), yy), one);
  fe r;
  const bool ok = sqrt_ratio(r, u, v);
  fe x = canon(r);
  if ((x.v[0] & 1) != sign) x = neg(x);
  o.x = x;
  o.y = y;
  o.z = one;
  o.t = mul(x, y);
  return ok;
}

// ristretto255 DECODE (pallas_sr25519._ristretto_decode, point.
// ristretto_decode) of the low 255 bits of e; the host has checked the
// encoding canonical (s < p) and even, and passes that as ok_host. The
// parities of x and t are taken from canonical limbs. 1 + s^2 = 0 gives
// sqrt_ratio(1, 0), which is not square, and y = 0: both reject.
static __device__ __noinline__ bool ristretto_decode(pt& o, const int32_t (&e)[32],
                                                     bool ok_host) {
  const fe one = fe_one();
  const fe s = carry(unpack_limbs(e));
  const fe ss = sq(s);
  const fe u1 = sub(one, ss);  // 1 - s^2
  const fe u2 = add(one, ss);  // 1 + s^2
  const fe u2_sqr = sq(u2);
  const fe v = sub(neg(mul(fe_d(), sq(u1))), u2_sqr);  // -(d u1^2) - u2^2
  fe invsq;
  const bool was_square = sqrt_ratio(invsq, one, mul(v, u2_sqr));
  const fe den_x = mul(invsq, u2);
  const fe den_y = mul(mul(invsq, den_x), v);
  fe x = canon(mul(add(s, s), den_x));
  if (x.v[0] & 1) x = neg(x);  // |x|
  const fe y = mul(u1, den_y);
  const fe t = mul(x, y);
  const bool t_odd = (canon(t).v[0] & 1) != 0;
  const bool y_zero = is_zero(y);
  o.x = x;
  o.y = y;
  o.z = one;
  o.t = t;
  return was_square && !t_odd && !y_zero && ok_host;
}

// ---- the quad point functions: four threads share one point ----------------
// A quad is four adjacent threads of a warp (lanes 4k .. 4k+3); thread q
// of the quad holds coordinate q of a shared extended point (X, Y, Z, T),
// 20 limbs in registers. Every point operation is two rounds of four
// independent field products; in each round thread q computes product q
// with the unchanged mul/sq above, the quad exchanges the four 20-limb
// results by __shfl_sync within the quad, and every thread forms E, F, G,
// H from them by the same add/sub/neg/carry steps as point.py's
// point_double, point_add or point_add_niels. So each product is computed
// once, by one thread of the quad, and every limb of the point equals the
// plain version's. The ladder kernels (K3, K3r) and rlc.cu's K2 run on
// these. All threads of a warp execute every shuffle:
// the kernels keep a quad past the end of the batch running on a clamped
// column and mask only its store.

constexpr unsigned QUAD_ALL = 0xffffffffu;

// Product `s` of the quad (the value of `v` in quad thread s), to every
// thread of the quad.
__device__ __forceinline__ fe quad_slot(const fe& v, int s) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = __shfl_sync(QUAD_ALL, v.v[l], s, 4);
  return r;
}

__device__ __forceinline__ fe pick(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = c ? a.v[l] : b.v[l];
  return r;
}

// Coordinate q of the identity (0, 1, 1, 0).
__device__ __forceinline__ fe quad_identity(int q) {
  return (q == 1 || q == 2) ? fe_one() : fe_zero();
}

// The Niels coordinate thread q multiplies in an add: (Y-X) * q.y in
// thread 0, (Y+X) * q.x in 1, Z * q.z in 2, T * q.t in 3.
__device__ __forceinline__ int niels_coord(int q) { return q < 2 ? q ^ 1 : q; }

// Round 2 of a double or an add: X = EF in thread 0, Y = GH in 1, Z = FG
// in 2, T = EH in 3 (zero where need_t is false, as point_double does).
__device__ __forceinline__ fe quad_round2(const fe& e, const fe& f, const fe& g,
                                          const fe& h, int q, bool need_t) {
  const fe l = pick(q == 1, g, pick(q == 2, f, e));
  const fe r = pick(q == 0, f, pick(q == 2, g, h));
  const fe p = mul(l, r);
  return (q == 3 && !need_t) ? fe_zero() : p;
}

// point_double on the quad's point: round 1 is X^2, Y^2, Z^2, (X+Y)^2.
__device__ __forceinline__ fe quad_double(const fe& c, int q, bool need_t) {
  const fe x = quad_slot(c, 0), y = quad_slot(c, 1);
  const fe s = sq(pick(q == 3, add(x, y), c));
  const fe a = quad_slot(s, 0), b = quad_slot(s, 1);
  const fe zz = quad_slot(s, 2), d = quad_slot(s, 3);
  const fe cc = add(zz, zz);
  const fe e = sub(sub(d, a), b);
  const fe g = sub(b, a);
  const fe f = sub(g, cc);
  const fe h = neg(add(a, b));
  return quad_round2(e, f, g, h, q, need_t);
}

// X in threads 0 and 1 swapped with Y (the value of `v` in quad thread
// q ^ 1).
__device__ __forceinline__ fe quad_partner(const fe& v) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = __shfl_xor_sync(QUAD_ALL, v.v[l], 1, 4);
  return r;
}

// point_add_niels on the quad's point and a Niels entry of which this
// thread holds coordinate niels_coord(q): round 1 is (Y-X) q.y, (Y+X) q.x,
// Z q.z, T q.t.
__device__ __forceinline__ fe quad_add_niels(const fe& c, const fe& ent, int q,
                                             bool need_t) {
  const fe o = quad_partner(c);
  const fe y = pick(q & 1, c, o), x = pick(q & 1, o, c);
  const fe p = mul(pick(q == 0, sub(y, x), pick(q == 1, add(y, x), c)), ent);
  const fe a = quad_slot(p, 0), b = quad_slot(p, 1);
  const fe zz = quad_slot(p, 2), t = quad_slot(p, 3);
  const fe d = add(zz, zz);
  const fe e = sub(b, a), f = sub(d, t), g = add(d, t), h = add(b, a);
  return quad_round2(e, f, g, h, q, need_t);
}

// point_add on the quad's points c and d (this thread holds coordinate q
// of each): round 1 is (Y-X)(Y'-X'), (Y+X)(Y'+X'), Z Z' and (T 2d) T',
// the last as mul(mul(T, 2d), T') in thread 3, point_add's order.
__device__ __forceinline__ fe quad_add(const fe& c, const fe& d, int q) {
  const fe oc = quad_partner(c), od = quad_partner(d);
  const fe y = pick(q & 1, c, oc), x = pick(q & 1, oc, c);
  const fe y2 = pick(q & 1, d, od), x2 = pick(q & 1, od, d);
  const fe l = pick(q == 0, sub(y, x), pick(q == 1, add(y, x), c));
  const fe r = pick(q == 0, sub(y2, x2), pick(q == 1, add(y2, x2), d));
  const fe p = mul(q == 3 ? mul(l, fe_d2()) : l, r);
  const fe a = quad_slot(p, 0), b = quad_slot(p, 1);
  const fe zz = quad_slot(p, 2), t = quad_slot(p, 3);
  const fe dd = add(zz, zz);
  const fe e = sub(b, a), f = sub(dd, t), g = add(dd, t), h = add(b, a);
  return quad_round2(e, f, g, h, q, true);
}

// to_niels on the quad's point: thread 0 forms Y+X, 1 Y-X, 2 keeps Z and
// 3 forms T 2d, so thread q holds Niels coordinate q.
__device__ __forceinline__ fe quad_to_niels(const fe& c, int q) {
  const fe o = quad_partner(c);
  const fe y = pick(q & 1, c, o), x = pick(q & 1, o, c);
  if (q == 3) return mul(c, fe_d2());
  return pick(q == 0, add(y, x), pick(q == 1, sub(y, x), c));
}

// [8]acc == [8]R by T-free doubles and a projective cross-multiplication,
// each thread holding coordinate q of acc and of R; the answer is that of
// quad thread 0 (the cross-multiplication runs there).
__device__ __forceinline__ bool quad_cofactor_eq(fe acc, fe r, int q) {
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    acc = quad_double(acc, q, false);
    r = quad_double(r, q, false);
  }
  const fe ax = quad_slot(acc, 0), ay = quad_slot(acc, 1), az = quad_slot(acc, 2);
  const fe rx = quad_slot(r, 0), ry = quad_slot(r, 1), rz = quad_slot(r, 2);
  if (q != 0) return false;
  return is_zero(sub(mul(ax, rz), mul(rx, az))) && is_zero(sub(mul(ay, rz), mul(ry, az)));
}

// The coordinate of R (z = 1) that thread q multiplies in the ristretto
// test: y in threads 0 and 2, x in 1 and 3.
__device__ __forceinline__ int ristretto_coord(int q) { return (q & 1) ^ 1; }

// acc == R in the ristretto group (sr25519.k3r_ladder_plain): X yR == Y xR
// or Y yR == X xR, with no [8] doubles. Thread q holds coordinate q of acc
// and coordinate ristretto_coord(q) of R and forms one cross product, X yR,
// Y xR, Y yR or X xR; the answer is that of quad thread 0.
__device__ __forceinline__ bool quad_ristretto_eq(const fe& acc, const fe& r, int q) {
  const fe x = quad_slot(acc, 0), y = quad_slot(acc, 1);
  const fe p = mul(pick(q == 0 || q == 3, x, y), r);
  const fe p0 = quad_slot(p, 0), p1 = quad_slot(p, 1);
  const fe p2 = quad_slot(p, 2), p3 = quad_slot(p, 3);
  if (q != 0) return false;
  return is_zero(sub(p0, p1)) || is_zero(sub(p2, p3));
}

// ---- the limb-split field product: a quad shares one product ----------------
// A decompression is one field element's exponentiation, so the quad
// point functions above, which split a point's coordinates, cannot share
// it; these split the work of each field product instead. The quad holds
// one element, thread q rotated by 5q limbs (r.v[m] = limb (m + 5q) mod
// 20), so thread 0 holds it in order (split_u hands that to the quad).
//
// A multiply a b: thread q forms limbs 5q .. 5q + 4. Limb i = 5q + j takes
// convolution columns i (products a_k b_{i-k}, k <= i) and 20 + i (k > i),
// 20 products together, so 100 products a thread. a_k comes from thread 0
// by a shuffle as it is needed; b_{(i-k) mod 20} is the thread's own
// b.r[(j - k) mod 20], an index fixed at compile time; and k = 5t + s <= i
// iff t < q or t == q and s <= j, so one running sum over k in order, read
// at (t = q, s = j), gives column i, and the rest column 20 + i.
//
// A squaring takes each symmetric product once, as sq does: 55 products a
// thread, not 100. Thread q's product r_m1 r_m2 is a_{m1+5q} a_{m2+5q}
// and lands in limb m1 + m2 + 10q: threads 0 and 2 form limbs 0..9,
// threads 1 and 3 limbs 10..19, and the pair (q, q ^ 2) sees the same
// products shifted by 10 limbs. So each thread takes one pair {m1, m2} of
// every orbit {P, P + 10} (sq_rep), doubled where its own two limbs
// differ and the orbit holds two pairs (sq_coeff), and sorts it by
// whether the limbs it multiplies sum to i or 20 + i for its q (sq_mask,
// one of at most three classes a limb); the pair adds their sums with one
// exchange of five limbs' two columns, and thread q keeps limbs 5b .. 5b
// + 4, b = q with its two bits swapped. (With one rotation a thread, the
// symmetric products of four threads cannot each keep five adjacent
// limbs: r_m1 r_m2 always lands 10q limbs on, an even shift.)
//
// Then wrap_fold and the three carry passes run on the thread's five
// limbs; the limbs they take from below (column 20 + (first limb) - 1,
// and the three limbs below before the carries, from which the three
// carry-ins follow) come from the thread below in one round of four
// shuffles (the thread with limb 0 takes limb 19's carries times 608),
// and the quad gathers the result rotated by 20 shuffles. Every product
// and sum is the int32 one that mul and sq form, and int32 sums do not
// depend on their order, so every limb equals the one-thread result.
// carry, canon, add, sub and the other one-thread functions run on the
// element in order in all four threads with no shuffle. All threads of a
// warp execute every shuffle, so a product is never taken under a branch
// that differs between quads: the callers form both sides and pick.

constexpr int QB = NL / 4;  // limbs a thread keeps

// u (in order, the same in every thread of the quad) rotated by 5q limbs
// (one-thread selects).
__device__ __forceinline__ fe split_rot(const fe& u, int q) {
  fe r;
#pragma unroll
  for (int m = 0; m < NL; ++m) {
    int32_t v = u.v[m];
#pragma unroll
    for (int t = 1; t < 4; ++t) v = q == t ? u.v[(m + QB * t) % NL] : v;
    r.v[m] = v;
  }
  return r;
}

// The quad's element in order, to every thread (thread 0's r).
__device__ __forceinline__ fe split_u(const fe& r) {
  fe u;
#pragma unroll
  for (int l = 0; l < NL; ++l) u.v[l] = __shfl_sync(QUAD_ALL, r.v[l], 0, 4);
  return u;
}

// The thread of the quad that keeps limbs 5b .. 5b + 4 of a product (sym:
// a squaring's, b's two bits swapped; the map is its own inverse, so it
// also gives a thread's b).
__device__ __forceinline__ int split_keeper(int b, bool sym) {
  return sym ? ((b & 1) << 1) | (b >> 1) : b;
}

// Columns i (lo) and 20 + i (hi) of this thread's five limbs -> the
// product, rotated, in every thread of the quad: wrap_fold, carry, gather.
__device__ __forceinline__ fe split_finish(const int32_t (&lo)[QB], const int32_t (&hi)[QB],
                                           int q, bool sym) {
  const int b = split_keeper(q, sym);
  const int below = split_keeper((b + 3) & 3, sym);
  // column 19 + i is column 20 + (i - 1), from below for the first limb
  // (limb 0 receives column 39, which is 0)
  int32_t x[QB];
#pragma unroll
  for (int j = 1; j < QB; ++j)
    x[j] = lo[j] + TOP_WRAP * (hi[j] & MASK) + TOP_WRAP * (hi[j - 1] >> RADIX);
  const int32_t fold_in = __shfl_sync(QUAD_ALL, hi[QB - 1] >> RADIX, below, 4);
  const int32_t xm3 = __shfl_sync(QUAD_ALL, x[QB - 3], below, 4);
  const int32_t xm2 = __shfl_sync(QUAD_ALL, x[QB - 2], below, 4);
  const int32_t xm1 = __shfl_sync(QUAD_ALL, x[QB - 1], below, 4);
  x[0] = lo[0] + TOP_WRAP * (hi[0] & MASK) + TOP_WRAP * fold_in;
  // carry(): three carry_pass. The two limbs below after the first pass,
  // and the limb below after the second, as the thread below forms them,
  // give the carry-ins of the second and third.
  const int32_t p1m1 = (xm1 & MASK) + (xm2 >> RADIX);
  const int32_t p1m2 = (xm2 & MASK) + (xm3 >> RADIX);
  const int32_t p2m1 = (p1m1 & MASK) + (p1m2 >> RADIX);
  const int32_t wrap = b == 0 ? TOP_WRAP : 1;
  const int32_t c_in[3] = {xm1 >> RADIX, p1m1 >> RADIX, p2m1 >> RADIX};
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    int32_t o[QB];
    o[0] = (x[0] & MASK) + c_in[pass] * wrap;
#pragma unroll
    for (int j = 1; j < QB; ++j) o[j] = (x[j] & MASK) + (x[j - 1] >> RADIX);
#pragma unroll
    for (int j = 0; j < QB; ++j) x[j] = o[j];
  }
  fe r;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int j = 0; j < QB; ++j)
      r.v[QB * t + j] = __shfl_sync(QUAD_ALL, x[j], split_keeper((q + t) & 3, sym), 4);
  }
  return r;
}

// a * b (mul), rotated; only thread 0's a is read, so a may also be an
// element in order in every thread.
__device__ __forceinline__ fe split_mul(const fe& a, const fe& br, int q) {
  int32_t run[QB], lo[QB], hi[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) run[j] = lo[j] = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int s = 0; s < QB; ++s) {
      const int k = QB * t + s;
      const int32_t ak = __shfl_sync(QUAD_ALL, a.v[k], 0, 4);
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        run[j] += ak * br.v[(j - k + NL) % NL];
        if (s == j) lo[j] = t == q ? run[j] : lo[j];  // column i
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QB; ++j) hi[j] = run[j] - lo[j];  // column 20 + i (0 for i = 19)
  return split_finish(lo, hi, q, false);
}

// A squaring's product r_m1 r_{(j - m1) mod 20} for limb 10 (q & 1) + j:
// whether this thread takes it (sq_rep), its factor (sq_coeff) and the
// threads q for which it falls in column i rather than 20 + i (sq_mask,
// bit q).
__device__ constexpr int sq_m2(int j, int m1) { return (j - m1 + 2 * NL) % NL; }

__device__ constexpr bool sq_rep(int j, int m1) {
  const int m2 = sq_m2(j, m1);
  const int a = (m1 + 10) % NL, b = (m2 + 10) % NL;
  const int p0 = a < b ? a : b, p1 = a < b ? b : a;
  return m1 <= m2 && (m1 < p0 || (m1 == p0 && m2 <= p1));
}

__device__ constexpr int sq_coeff(int j, int m1) {
  const int m2 = sq_m2(j, m1);
  const int a = (m1 + 10) % NL, b = (m2 + 10) % NL;
  return (m1 == m2 || (a < b ? a : b) == m1) ? 1 : 2;
}

__device__ constexpr int sq_mask(int j, int m1) {
  const int m2 = sq_m2(j, m1);
  int mask = 0;
  for (int q = 0; q < 4; ++q) {
    if ((m1 + 5 * q) % NL + (m2 + 5 * q) % NL == 10 * (q & 1) + j) mask |= 1 << q;
  }
  return mask;
}

// sq: the same coefficients as mul(a, a), by symmetric products (header
// note).
__device__ __forceinline__ fe split_sq(const fe& ar, int q) {
  fe d;
#pragma unroll
  for (int m = 0; m < NL; ++m) d.v[m] = ar.v[m] + ar.v[m];
  int32_t lo[2 * QB], hi[2 * QB];
#pragma unroll
  for (int j = 0; j < 2 * QB; ++j) {
    int32_t acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = 0;
#pragma unroll
    for (int m1 = 0; m1 < NL; ++m1) {
      if (!sq_rep(j, m1)) continue;
      const int m2 = sq_m2(j, m1);
      acc[sq_mask(j, m1)] += ar.v[m1] * (sq_coeff(j, m1) == 2 ? d.v[m2] : ar.v[m2]);
    }
    int32_t l = 0, all = acc[0];
#pragma unroll
    for (int c = 1; c < 16; ++c) {
      all += acc[c];
      l += ((c >> q) & 1) ? acc[c] : 0;
    }
    lo[j] = l;
    hi[j] = all - l;
  }
  // the pair (q, q ^ 2) adds its halves; thread q keeps limbs 5g .. 5g + 4
  // of its ten, g = q >> 1
  const bool g = (q >> 1) != 0;
  int32_t lo5[QB], hi5[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    lo5[j] = (g ? lo[QB + j] : lo[j]) + __shfl_xor_sync(QUAD_ALL, g ? lo[j] : lo[QB + j], 2, 4);
    hi5[j] = (g ? hi[QB + j] : hi[j]) + __shfl_xor_sync(QUAD_ALL, g ? hi[j] : hi[QB + j], 2, 4);
  }
  return split_finish(lo5, hi5, q, true);
}

__device__ __forceinline__ fe split_sqn(fe a, int n, int q) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = split_sq(a, q);
  return a;
}

// pow22523's chain on the quad.
__device__ __forceinline__ fe split_pow22523(const fe& z, int q) {
  const fe x2 = split_sq(z, q);
  const fe x9 = split_mul(split_sqn(x2, 2, q), z, q);
  const fe x11 = split_mul(x9, x2, q);
  const fe x31 = split_mul(split_sq(x11, q), x9, q);
  const fe xa = split_mul(split_sqn(x31, 5, q), x31, q);
  const fe xb = split_mul(split_sqn(xa, 10, q), xa, q);
  const fe xc = split_mul(split_sqn(xb, 20, q), xb, q);
  const fe xd = split_mul(split_sqn(xc, 10, q), xa, q);
  const fe xe = split_mul(split_sqn(xd, 50, q), xd, q);
  const fe xf = split_mul(split_sqn(xe, 100, q), xe, q);
  const fe xg = split_mul(split_sqn(xf, 50, q), xd, q);
  return split_mul(split_sqn(xg, 2, q), z, q);
}

// y = carry(unpack_limbs(e)) of the 32 bytes at src, and the sign bit.
__device__ __forceinline__ fe load_y(const uint8_t* __restrict__ src, int32_t& sign) {
  int32_t e[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) e[b] = src[b];
  sign = e[31] >> 7;
  return carry(unpack_limbs(e));
}

// decompress (ZIP-215) of the 32 bytes at src on the quad: X, Y, T in
// order in every thread (Z = 1), the same limbs as the one-thread
// decompress, whose sqrt_ratio(u, v) it inlines. So that only pow22523's
// own values are live across its chain, the values sqrt_ratio needs after
// the chain (u, v, u v^3, y) are formed again from the bytes after it:
// five products more. The sqrt(-1) product is formed unconditionally and
// picked.
__device__ __forceinline__ bool split_decompress(fe& x_out, fe& y_out, fe& t_out,
                                                 const uint8_t* __restrict__ src, int q) {
  int32_t sign;
  fe w;
  {  // (u v^7)^((p - 5) / 8) with u = y^2 - 1, v = d y^2 + 1
    const fe yy = split_sq(split_rot(load_y(src, sign), q), q);
    const fe u = sub(split_u(yy), fe_one());
    const fe v = split_rot(add(split_u(split_mul(fe_d(), yy, q)), fe_one()), q);
    const fe v3 = split_mul(split_sq(v, q), v, q);
    const fe v7 = split_mul(split_sq(v3, q), v, q);
    w = split_pow22523(split_mul(u, v7, q), q);
  }
  const fe y = load_y(src, sign);
  const fe yr = split_rot(y, q);
  const fe yy = split_sq(yr, q);
  const fe u = sub(split_u(yy), fe_one());
  const fe v = split_rot(add(split_u(split_mul(fe_d(), yy, q)), fe_one()), q);
  const fe v3 = split_mul(split_sq(v, q), v, q);
  const fe r = split_mul(split_mul(u, v3, q), w, q);
  const fe check = split_u(split_mul(v, split_sq(r, q), q));
  fe d;  // eq(check, u)
#pragma unroll
  for (int i = 0; i < NL; ++i) d.v[i] = check.v[i] - u.v[i];
  const bool ok_pos = all_zero(canon_body(d));
  const bool ok_neg = all_zero(canon_body(add(check, u)));
  const fe ri = split_mul(fe_sqrt_m1(), r, q);
  const fe xc = canon_body(split_u(pick(ok_pos, r, ri)));
  const fe x = pick((xc.v[0] & 1) != sign, neg(xc), xc);
  x_out = x;
  y_out = y;
  t_out = split_u(split_mul(x, yr, q));
  return ok_pos || ok_neg;
}

}  // namespace edw
