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

__device__ __forceinline__ pt identity_point() {
  return pt{fe_zero(), fe_one(), fe_one(), fe_zero()};
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

static __device__ __noinline__ fe canon(const fe x0) {
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

__device__ __forceinline__ bool is_zero(const fe& x) {
  const fe c = canon(x);
  bool z = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) z = z && (c.v[i] == 0);
  return z;
}

__device__ __forceinline__ bool eq(const fe& a, const fe& b) {
  fe d;
#pragma unroll
  for (int i = 0; i < NL; ++i) d.v[i] = a.v[i] - b.v[i];
  return is_zero(d);
}

// ---- points (point.py) ------------------------------------------------------
// Each writes its result only after reading every input, so `o` may alias
// an input.

static __device__ __noinline__ void point_add(pt& o, const pt& p, const pt& q) {
  const fe a = mul(sub(p.y, p.x), sub(q.y, q.x));
  const fe b = mul(add(p.y, p.x), add(q.y, q.x));
  const fe c = mul(mul(p.t, fe_d2()), q.t);
  const fe zz = mul(p.z, q.z);
  const fe d = add(zz, zz);
  const fe e = sub(b, a), f = sub(d, c), g = add(d, c), h = add(b, a);
  o.x = mul(e, f);
  o.y = mul(g, h);
  o.z = mul(f, g);
  o.t = mul(e, h);
}

// Doubling never reads T; need_t = false skips producing it.
static __device__ __noinline__ void point_double(pt& o, const pt& p, bool need_t) {
  const fe a = sq(p.x);
  const fe b = sq(p.y);
  const fe zz = sq(p.z);
  const fe c = add(zz, zz);
  const fe e = sub(sub(sq(add(p.x, p.y)), a), b);
  const fe g = sub(b, a);
  const fe f = sub(g, c);
  const fe h = neg(add(a, b));
  o.x = mul(e, f);
  o.y = mul(g, h);
  o.z = mul(f, g);
  o.t = need_t ? mul(e, h) : fe_zero();
}

__device__ __forceinline__ pt point_neg(const pt& p) {
  return pt{neg(p.x), p.y, p.z, neg(p.t)};
}

static __device__ __noinline__ void to_niels(pt& o, const pt& p) {
  const fe yplusx = add(p.y, p.x);
  const fe yminusx = sub(p.y, p.x);
  const fe t2d = mul(p.t, fe_d2());
  o.x = yplusx;
  o.y = yminusx;
  o.z = p.z;
  o.t = t2d;
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

// Point p of a coords array: coordinate c at rows (p * 4 + c) * 32.
__device__ __forceinline__ pt load_point(const int32_t* __restrict__ coords,
                                         int p, int col, int g) {
  return pt{load_fe(coords, (p * 4 + 0) * 32, col, g),
            load_fe(coords, (p * 4 + 1) * 32, col, g),
            load_fe(coords, (p * 4 + 2) * 32, col, g),
            load_fe(coords, (p * 4 + 3) * 32, col, g)};
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

}  // namespace edw
