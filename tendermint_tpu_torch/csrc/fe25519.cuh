// GF(2^255 - 19) field and edwards25519 point functions for the kernels.
//
// Mirrors tendermint_tpu_torch/ops/fe.py and ops/point.py (themselves
// mirrors of tendermint_tpu/ops/fe_t.py and pallas_verify.py:90-220) one
// formula at a time: a field element is 20 signed 13-bit limbs in int32,
// and every operation below performs the same integer steps as its plain
// PyTorch counterpart, so kernels and plain versions agree limb for limb,
// not only modulo p. The wide field at the end (10 limbs of 25.5 bits, for
// the chains of the one-thread decompressions and for the whole op-graph
// check, whose only output is a verdict) is the exception: it keeps only
// the value, and comes back to canonical limbs before anything the plain
// version's limbs depend on.
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

// z^(2^252 - 3), ref10 addition chain, inline (sqrt_ratio_body).
__device__ __forceinline__ fe pow22523_body(const fe z) {
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
// which is_zero calls (the ladders' final tests, quad_cofactor_eq and
// quad_ristretto_eq).
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
// accepts check == -u as the RFC 8032 sqrt(-1) branch). It runs
// pow22523's chain and the canonical reductions inline (ristretto_decode).
__device__ __forceinline__ bool sqrt_ratio_body(fe& r_out, const fe u, const fe v) {
  const fe v3 = mul(sq(v), v);
  const fe v7 = mul(sq(v3), v);
  const fe uv7 = mul(u, v7);
  fe r = mul(mul(u, v3), pow22523_body(uv7));
  const fe check = mul(v, sq(r));
  fe d;  // check - u, then check + u
#pragma unroll
  for (int i = 0; i < NL; ++i) d.v[i] = check.v[i] - u.v[i];
  const bool ok_pos = all_zero(canon_body(d));
  d = add(check, u);
  const bool ok_neg = all_zero(canon_body(d));
  if (!ok_pos) r = mul(r, fe_sqrt_m1());
  r_out = r;
  return ok_pos || ok_neg;
}

// ristretto255 DECODE (pallas_sr25519._ristretto_decode, point.
// ristretto_decode) of the low 255 bits of e; the host has checked the
// encoding canonical (s < p) and even, and passes that as ok_host. The
// parities of x and t are taken from canonical limbs. 1 + s^2 = 0 gives
// sqrt_ratio(1, 0), which is not square, and y = 0: both reject. It runs
// inline, pow22523's chain and the canonical reductions too, so that no
// call passes an 80-byte value through a stack frame in its caller (K1r).
__device__ __forceinline__ bool ristretto_decode(pt& o, const int32_t (&e)[32], bool ok_host) {
  const fe one = fe_one();
  const fe s = carry(unpack_limbs(e));
  const fe ss = sq(s);
  const fe u1 = sub(one, ss);  // 1 - s^2
  const fe u2 = add(one, ss);  // 1 + s^2
  const fe u2_sqr = sq(u2);
  const fe v = sub(neg(mul(fe_d(), sq(u1))), u2_sqr);  // -(d u1^2) - u2^2
  fe invsq;
  const bool was_square = sqrt_ratio_body(invsq, one, mul(v, u2_sqr));
  const fe den_x = mul(invsq, u2);
  const fe den_y = mul(mul(invsq, den_x), v);
  fe x = canon_body(mul(add(s, s), den_x));
  if (x.v[0] & 1) x = neg(x);  // |x|
  const fe y = mul(u1, den_y);
  const fe t = mul(x, y);
  const bool t_odd = (canon_body(t).v[0] & 1) != 0;
  const bool y_zero = all_zero(canon_body(y));
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
// carry, canon_body, add, sub and the other one-thread functions run on the
// element in order in all four threads with no shuffle. All threads of a
// warp execute every shuffle, so a product is never taken under a branch
// that differs between quads: the callers form both sides and pick.
//
// The warm K1s (verify.cu, rlc.cu) decompress on these, a quad a point:
// 10,240 decompressions in 0.16 ms against a bound of 0.038, where one
// thread a decompression took 0.23 (H100 80GB HBM3, 700 W; PERF.md). The
// split pays where the decompressions alone leave schedulers empty: at
// 20,480 ristretto decodes (sr25519.cu's K1r) a quad a decode took 0.28
// ms, and the same split on a pair of threads (10 limbs a thread) 0.27,
// against 0.24 for one thread a decode with the chain inline.

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

// y = carry(unpack_limbs(e)) of the 32 bytes src[0], src[stride], ...,
// src[31 stride], and the sign bit.
__device__ __forceinline__ fe load_y(const uint8_t* __restrict__ src, size_t stride,
                                     int32_t& sign) {
  int32_t e[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) e[b] = src[b * stride];
  sign = e[31] >> 7;
  return carry(unpack_limbs(e));
}

// sqrt_ratio(u, v) on the quad: r, in order in every thread, with v r^2
// = u, multiplied by sqrt(-1) unless v r^2 = u already; true when v r^2 =
// u or -u; the same limbs as the one-thread sqrt_ratio_body. uv(u, vr)
// forms u in order and v rotated; it runs twice, before pow22523's chain
// and after it, so that only the chain's own values are live across the
// chain (the caller's uv forms again, after the chain, what the caller
// needs then: a few products more). The sqrt(-1) product is formed
// unconditionally and picked.
template <class UV>
__device__ __forceinline__ bool split_sqrt_ratio(fe& r_out, const UV& uv, int q) {
  fe w;
  {  // (u v^7)^((p - 5) / 8)
    fe u, v;
    uv(u, v);
    const fe v3 = split_mul(split_sq(v, q), v, q);
    const fe v7 = split_mul(split_sq(v3, q), v, q);
    w = split_pow22523(split_mul(u, v7, q), q);
  }
  fe u, v;
  uv(u, v);
  const fe v3 = split_mul(split_sq(v, q), v, q);
  const fe r = split_mul(split_mul(u, v3, q), w, q);
  const fe check = split_u(split_mul(v, split_sq(r, q), q));
  fe d;  // check - u
#pragma unroll
  for (int i = 0; i < NL; ++i) d.v[i] = check.v[i] - u.v[i];
  const bool ok_pos = all_zero(canon_body(d));
  const bool ok_neg = all_zero(canon_body(add(check, u)));
  const fe ri = split_mul(fe_sqrt_m1(), r, q);
  r_out = split_u(pick(ok_pos, r, ri));
  return ok_pos || ok_neg;
}

// The decompression's u = y^2 - 1 and v = d y^2 + 1 (rotated) for
// split_sqrt_ratio, from the 32 bytes at src; y, its rotation and the
// sign bit land in the caller's y, yr and sign.
struct split_decompress_uv {
  const uint8_t* __restrict__ src;
  int q;
  fe& y;
  fe& yr;
  int32_t& sign;
  __device__ __forceinline__ void operator()(fe& u, fe& v) const {
    y = load_y(src, 1, sign);
    yr = split_rot(y, q);
    const fe yy = split_sq(yr, q);
    u = sub(split_u(yy), fe_one());
    v = split_rot(add(split_u(split_mul(fe_d(), yy, q)), fe_one()), q);
  }
};

// decompress (ZIP-215) of the 32 bytes at src on the quad: X, Y, T in
// order in every thread (Z = 1), the same limbs as the one-thread
// decompress_wide.
__device__ __forceinline__ bool split_decompress(fe& x_out, fe& y_out, fe& t_out,
                                                 const uint8_t* __restrict__ src, int q) {
  int32_t sign;
  fe y, yr, r;
  const bool ok = split_sqrt_ratio(r, split_decompress_uv{src, q, y, yr, sign}, q);
  const fe xc = canon_body(r);
  const fe x = pick((xc.v[0] & 1) != sign, neg(xc), xc);
  x_out = x;
  y_out = y;
  t_out = split_u(split_mul(x, yr, q));
  return ok;
}

// ---- the wide field: the card's 32 x 32 -> 64 multiply --------------------
// The 13-bit signed limbs above are the TPU's shape: its vector unit has
// no 32 x 32 -> 64 multiply, so fe_t keeps every product and sum inside
// int32, and a squaring costs 210 multiply-adds, a wrap of 38 more and
// three carry passes over 20 limbs. This card multiplies 32 x 32 -> 64 in
// one instruction (IMAD.WIDE.U32), so here an element is 10 unsigned limbs
// of 26 and 25 bits at bits 25.5 i rounded up (ref10's layout): each
// product is one multiply-add into one of 10 64-bit column sums, with
// 2^255 = 19 (mod p) and the factor 2 where two odd limbs meet taken into
// the operands, so a multiply is 100 products, a squaring 55, then one
// pass of carries. The column sums do not depend on each other, so one
// thread's products issue back to back. Between operations these limbs
// are not fe.py's, so only what depends on the value alone runs here:
// pow22523's chain and sqrt_ratio's products around it (decompress_wide),
// and the op-graph check (the wide quad functions below); wide_in goes in
// from the canonical limbs and wide_out comes out to them.
// A radix-2^32 element (8 words, 36 products a squaring, each product's
// carry running into the next) took 0.14 ms where this one takes 0.13 in
// the cold K1s (H100 80GB HBM3, 700 W; PERF.md). Plain C++ on 32- and
// 64-bit integers but for WIDE_MAD, so the host compiler builds the same
// source for the CPU stand-in.

// c + a b for 32-bit a and b and a 64-bit c: one IMAD.WIDE.U32. Written
// in plain C++ ((uint64_t)a * b + c), nvcc keeps the limbs as 64-bit
// values across the squaring loop, with a zero high word it does not know
// to be zero, and forms each product as a 64 x 64 one (an IMAD.WIDE.U32
// and two IMADs for the high words, 284 instructions a squaring against
// 176); on 32-bit registers, mad.wide.u32 is the one instruction. The
// CPU stand-in defines WIDE_MAD in plain C++.
#ifndef WIDE_MAD
__device__ __forceinline__ uint64_t wide_mad_ptx(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}
#define WIDE_MAD(a, b, c) wide_mad_ptx(a, b, c)
#endif

constexpr int NWL = 10;

struct fw {
  uint32_t v[NWL];
};

// Width and lowest bit of limb i: 26, 25, 26, ... bits at 0, 26, 51, 77, ...
__device__ constexpr int wide_bits(int i) { return i & 1 ? 25 : 26; }
__device__ constexpr int wide_at(int i) { return 25 * i + (i + 1) / 2; }

// ref10's carry order: two chains from limbs 0 and 4 interleaved, then
// limb 9's carry wrapped to limb 0 times 19 and limb 0 once more.
__device__ constexpr int wide_carry_limb(int s) {
  return s == 11 ? 0 : s == 10 ? 9 : s == 9 ? 8 : s == 8 ? 4 : (s & 1) ? 4 + s / 2 : s / 2;
}

// 10 column sums (each below 2^61) -> limbs. The carries are not rounded,
// so every limb stays non-negative and every product an unsigned one.
// Limb i ends below 2^bits, but limbs 1 and 5 below 2^25 + 2^15 (they
// take the carries of the second passes over limbs 0 and 4), so 19 times
// a limb fits 32 bits and the next product's column sums stay below 2^61.
__device__ __forceinline__ fw wide_carry(uint64_t (&h)[NWL]) {
#pragma unroll
  for (int s = 0; s < 12; ++s) {
    const int i = wide_carry_limb(s), b = wide_bits(i);
    const uint64_t c = h[i] >> b;
    h[i] &= ((uint64_t)1 << b) - 1;
    if (i == NWL - 1)
      h[0] += 19 * c;
    else
      h[i + 1] += c;
  }
  fw r;
#pragma unroll
  for (int i = 0; i < NWL; ++i) r.v[i] = (uint32_t)h[i];
  return r;
}

// Column (i + j) mod 10 takes f_i g_j, times 19 where i + j >= 10 (folded
// into g) and times 2 where i and j are odd (folded into f).
__device__ __forceinline__ fw wide_mul(const fw& f, const fw& g) {
  uint32_t f2[NWL], g19[NWL];
#pragma unroll
  for (int i = 0; i < NWL; ++i) {
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    g19[i] = 19 * g.v[i];
  }
  uint64_t h[NWL];
#pragma unroll
  for (int k = 0; k < NWL; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NWL; ++i) {
#pragma unroll
    for (int j = 0; j < NWL; ++j)
      h[(i + j) % NWL] = WIDE_MAD((j & 1) ? f2[i] : f.v[i], i + j >= NWL ? g19[j] : g.v[j],
                                  h[(i + j) % NWL]);
  }
  return wide_carry(h);
}

// Each pair i <= j once: times 2 where i < j and where both are odd
// (folded into f_i), times 19 where i + j >= 10 (folded into f_j).
__device__ __forceinline__ fw wide_sq(const fw& f) {
  uint32_t f2[NWL], f4[NWL], f19[NWL];
#pragma unroll
  for (int i = 0; i < NWL; ++i) {
    f2[i] = 2 * f.v[i];
    f4[i] = 4 * f.v[i];
    f19[i] = 19 * f.v[i];
  }
  uint64_t h[NWL];
#pragma unroll
  for (int k = 0; k < NWL; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NWL; ++i) {
#pragma unroll
    for (int j = i; j < NWL; ++j) {
      const int m = (i < j ? 2 : 1) * ((i & j & 1) ? 2 : 1);
      const uint32_t a = m == 1 ? f.v[i] : m == 2 ? f2[i] : f4[i];
      h[(i + j) % NWL] = WIDE_MAD(a, i + j >= NWL ? f19[j] : f.v[j], h[(i + j) % NWL]);
    }
  }
  return wide_carry(h);
}

__device__ __forceinline__ fw wide_sqn(fw a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = wide_sq(a);
  return a;
}

// z^(2^252 - 3), pow22523's chain on the wide field.
__device__ __forceinline__ fw wide_pow22523(const fw z) {
  const fw x2 = wide_sq(z);
  const fw x9 = wide_mul(z, wide_sqn(x2, 2));
  const fw x11 = wide_mul(x2, x9);
  const fw x31 = wide_mul(x9, wide_sq(x11));
  const fw xa = wide_mul(wide_sqn(x31, 5), x31);
  const fw xb = wide_mul(wide_sqn(xa, 10), xa);
  const fw xc = wide_mul(wide_sqn(xb, 20), xb);
  const fw xd = wide_mul(wide_sqn(xc, 10), xa);
  const fw xe = wide_mul(wide_sqn(xd, 50), xd);
  const fw xf = wide_mul(wide_sqn(xe, 100), xe);
  const fw xg = wide_mul(wide_sqn(xf, 50), xd);
  return wide_mul(wide_sqn(xg, 2), z);
}

// Any carried element -> the wide field: its canonical limbs (below p,
// each in [0, 2^13)) regrouped into limbs of 26 and 25 bits.
__device__ __forceinline__ fw wide_in(const fe& x) {
  const fe c = canon_body(x);
  fw r;
#pragma unroll
  for (int k = 0; k < NWL; ++k) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int sh = RADIX * i - wide_at(k);  // where limb i's bit 0 lands in limb k
      if (sh > -RADIX && sh < wide_bits(k))
        v |= sh >= 0 ? (uint32_t)c.v[i] << sh : (uint32_t)c.v[i] >> -sh;
    }
    r.v[k] = v & ((1u << wide_bits(k)) - 1);
  }
  return r;
}

// The wide field -> canonical limbs, by ref10's reduction. With limbs as
// wide_carry or wide_in leave them the value V is below 2^255 + 2^144 <
// 2p, so its quotient by p is 0 or 1. q0 = round(19 h_9 / 2^25) is at
// most 19, and 19 when V >= p (then h_9 = 2^25 - 1), so q = floor((V +
// q0) / 2^255), formed by a pass of carries from q0 up through the limbs,
// is that quotient; V - q p carried out leaves every limb in [0, 2^bits).
// Then the 255 bits are cut into 20 limbs of 13.
__device__ __forceinline__ fe wide_out(const fw& f) {
  uint32_t h[NWL];
#pragma unroll
  for (int i = 0; i < NWL; ++i) h[i] = f.v[i];
  uint32_t q = (19 * h[NWL - 1] + (1u << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < NWL; ++i) q = (h[i] + q) >> wide_bits(i);
  h[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < NWL - 1; ++i) {
    h[i + 1] += h[i] >> wide_bits(i);
    h[i] &= (1u << wide_bits(i)) - 1;
  }
  h[NWL - 1] &= (1u << 25) - 1;
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < NWL; ++k) {
      const int sh = wide_at(k) - RADIX * l;  // where limb k's bit 0 lands in limb l
      if (sh > -wide_bits(k) && sh < RADIX) v |= sh >= 0 ? h[k] << sh : h[k] >> -sh;
    }
    r.v[l] = (int32_t)(v & MASK);
  }
  return r;
}

// ZIP-215 decompression (pallas_verify.decompress, point.decompress) of
// the encoding src[0], src[stride], ..., src[31 stride], inline: y is
// carried but not reduced, so a non-canonical y is accepted, and the sign
// flip uses the canonical x. sqrt_ratio's products and pow22523's chain
// run on the wide field: u = y^2 - 1 and v = d y^2 + 1 are formed on the
// 13-bit functions, as point.decompress forms them, and go in; v^3, v^7,
// u v^7, the chain, r = u v^3 (u v^7)^((p - 5) / 8) and the check v r^2
// run wide; r, the check and u come back as canonical limbs for the two
// canonical tests, the sqrt(-1) branch, x = canon(r), the sign flip and
// t = x y on the 13-bit functions, with y read again from the bytes. Every
// step after the chain depends only on the values of r, the check and u,
// so X, Y, Z and T are the plain version's limbs. Only u and v live
// across the chain. The one-thread decompressions (the cold K1s and the
// epoch table) run it; split_decompress is the quad's.
__device__ __forceinline__ bool decompress_wide(pt& o, const uint8_t* __restrict__ src,
                                                size_t stride) {
  fw u, v;
  {
    int32_t sign;
    const fe yy = sq(load_y(src, stride, sign));
    u = wide_in(sub(yy, fe_one()));
    v = wide_in(add(mul(fe_d(), yy), fe_one()));
  }
  const fw v3 = wide_mul(wide_sq(v), v);
  const fw w = wide_pow22523(wide_mul(u, wide_mul(wide_sq(v3), v)));
  const fw r = wide_mul(wide_mul(u, v3), w);
  const fe uc = wide_out(u), cc = wide_out(wide_mul(v, wide_sq(r)));
  fe d;  // check - u
#pragma unroll
  for (int i = 0; i < NL; ++i) d.v[i] = cc.v[i] - uc.v[i];
  const bool ok_pos = all_zero(canon_body(d));
  const bool ok_neg = all_zero(canon_body(add(cc, uc)));
  fe x = wide_out(r);
  if (!ok_pos) x = mul(x, fe_sqrt_m1());
  x = canon_body(x);
  int32_t sign;
  const fe y = load_y(src, stride, sign);
  if ((x.v[0] & 1) != sign) x = neg(x);
  o.x = x;
  o.y = y;
  o.z = fe_one();
  o.t = mul(x, y);
  return ok_pos || ok_neg;
}

// ---- the wide quad point functions: a quad shares one point, wide ----------
// The quad point functions above, on the wide field, for the op-graph check
// (ed25519_verify.cu), whose only output is a verdict: no limb of its points
// has to equal a plain version's, only their values modulo p. Each function
// forms the same field values as its ops/point.py counterpart (point_double,
// point_add_niels, point_add, to_niels; decompress) on 10 unsigned limbs.
// Thread q of the quad holds coordinate q of the point as an fw; a round is
// four independent products, one a thread, by wide_mul or wide_sq (100 or 55
// 32 x 32 -> 64 products and one pass of carries, against 400 or 210
// multiply-adds, a wrap and three passes over 20 limbs), and a shuffle of an
// element is 10 words. Round 1 of a double has thread 0 square X, 1 X + Y
// (X from thread 0), 2 Z and 3 Y (from thread 1): one shuffle of 10 words
// where two would bring X and Y to one thread. As above, every thread of a
// warp executes every shuffle: the callers pick, they do not branch.
//
// Limb bounds. A limb is unsigned, so a - b is formed as a + k p - b with
// every limb of k p at least b's (2p: 2^27 - 38, 2^26 - 2, 2^27 - 2, ...;
// 4p: twice that), and nothing is carried after an add or a subtract but
// where stated. wide_mul(f, g) doubles f's odd limbs and multiplies g's by
// 19: f may reach 2^31, g only 2^27.75. The numbers (each checked by
// test_wide_quad_limb_bounds in tests/test_torch_quad.py, which runs these
// formulas on limb maxima, exactly, and held by the functions on inputs at
// these ends):
//  - M, the coordinates a function takes and returns, and the table's
//    entries: limb 0 at most 2^26 + 56, limb 1 2^25 + 950, limb 5 2^25 +
//    590, the others 2^26 + 2 (even) or 2^25 + 2 (odd). wide_carry leaves a
//    product there, wide_fold (one parallel pass of carries) the sums and
//    differences below, and wide_in and wide_from_bytes leave limbs within
//    their widths.
//  - In a double, E = D + 4p - (A + B), F = B + 4p - (A + 2 Z^2) and H =
//    4p - (A + B) (subtrahends up to 3 M, under 4p) reach 5 * 2^26 - 5
//    (2^28.32); G = B + 2p - A. In a Niels add, E = B + 2p - A, F = 2 Z Z'
//    + 2p - C, G = 2 Z Z' + C and H = B + A reach 2^28.
//  - Round 2 multiplies l (E, G, F, E in threads 0..3) as f by r (F, H, G,
//    H) as g after wide_fold: r is back in M. Round 1 of a Niels add
//    multiplies Y + 2p - X or Y + X (up to 2^27.58) by the entry; of a
//    double squares X + Y, 2 M (19 (2^27 + 112) < 2^32).
//  - Every column sum stays below 2^61.29 (a double's round 2), against
//    the 2^61 wide_carry's note assumes: its carries into a column then
//    stay below 2^37, far from 2^64, and limbs 1 and 5 take at most 950
//    and 590 over 2^25 (the M above).
//  - wide_out takes what wide_carry or wide_fold leaves: below 2^230 +
//    2^207 under limb 9, so a value of at least p has limb 9 at 2^25 - 1
//    or more and q0 = 19, and a value below p has q0 at most 19, as its
//    argument needs.

// Wide limbs of 2p and 4p (the subtractions), 1, d, 2d, sqrt(-1) and the
// base point's x, y and t (canonical).
__device__ __forceinline__ fw fw_2p() {
  return fw{{134217690, 67108862, 134217726, 67108862, 134217726, 67108862, 134217726,
             67108862, 134217726, 67108862}};
}

__device__ __forceinline__ fw fw_4p() {
  return fw{{268435380, 134217724, 268435452, 134217724, 268435452, 134217724, 268435452,
             134217724, 268435452, 134217724}};
}

__device__ __forceinline__ fw fw_zero() {
  fw r;
#pragma unroll
  for (int i = 0; i < NWL; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ fw fw_one() {
  fw r = fw_zero();
  r.v[0] = 1;
  return r;
}

__device__ __forceinline__ fw fw_d() {
  return fw{{56195235, 13857412, 51736253, 6949390, 114729, 24766616, 60832955, 30306712,
             48412415, 21499315}};
}

__device__ __forceinline__ fw fw_d2() {
  return fw{{45281625, 27714825, 36363642, 13898781, 229458, 15978800, 54557047, 27058993,
             29715967, 9444199}};
}

__device__ __forceinline__ fw fw_sqrt_m1() {
  return fw{{34513072, 25610706, 9377949, 3500415, 12389472, 33281959, 41962654, 31548777,
             326685, 11406482}};
}

// Coordinate q of the base point (x, y, 1, x y).
__device__ __forceinline__ fw fw_base(int q) {
  const fw x{{52811034, 25909283, 16144682, 17082669, 27570973, 30858332, 40966398, 8378388,
              20764389, 8758491}};
  const fw y{{40265304, 26843545, 13421772, 20132659, 26843545, 6710886, 53687091, 13421772,
              40265318, 26843545}};
  const fw t{{28827043, 27438313, 39759291, 244362, 8635006, 11264893, 19351346, 13413597,
              16611511, 27139452}};
  fw r;
#pragma unroll
  for (int i = 0; i < NWL; ++i)
    r.v[i] = q == 0 ? x.v[i] : q == 1 ? y.v[i] : q == 2 ? (i == 0 ? 1u : 0u) : t.v[i];
  return r;
}

__device__ __forceinline__ fw wide_add(const fw& a, const fw& b) {
  fw r;
#pragma unroll
  for (int i = 0; i < NWL; ++i) r.v[i] = a.v[i] + b.v[i];
  return r;
}

// a - b as a + K p - b (K = 2 or 4); every limb of K p must be at least b's.
template <int K>
__device__ __forceinline__ fw wide_sub(const fw& a, const fw& b) {
  const fw kp = K == 2 ? fw_2p() : fw_4p();
  fw r;
#pragma unroll
  for (int i = 0; i < NWL; ++i) r.v[i] = a.v[i] + kp.v[i] - b.v[i];
  return r;
}

// One parallel pass of carries: limb i keeps its low bits and takes limb i -
// 1's carry, limb 0 19 times limb 9's; the value is the same modulo p.
__device__ __forceinline__ fw wide_fold(const fw& x) {
  fw r;
  r.v[0] = (x.v[0] & ((1u << 26) - 1)) + 19 * (x.v[NWL - 1] >> 25);
#pragma unroll
  for (int i = 1; i < NWL; ++i)
    r.v[i] = (x.v[i] & ((1u << wide_bits(i)) - 1)) + (x.v[i - 1] >> wide_bits(i - 1));
  return r;
}

__device__ __forceinline__ fw wpick(bool c, const fw& a, const fw& b) {
  fw r;
#pragma unroll
  for (int i = 0; i < NWL; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// The value of v in quad thread s (s may differ between threads).
__device__ __forceinline__ fw wquad_slot(const fw& v, int s) {
  fw r;
#pragma unroll
  for (int i = 0; i < NWL; ++i) r.v[i] = __shfl_sync(QUAD_ALL, v.v[i], s, 4);
  return r;
}

// The value of v in quad thread q ^ 1.
__device__ __forceinline__ fw wquad_partner(const fw& v) {
  fw r;
#pragma unroll
  for (int i = 0; i < NWL; ++i) r.v[i] = __shfl_xor_sync(QUAD_ALL, v.v[i], 1, 4);
  return r;
}

// Coordinate q of the identity (0, 1, 1, 0).
__device__ __forceinline__ fw wquad_identity(int q) {
  return (q == 1 || q == 2) ? fw_one() : fw_zero();
}

// Round 2 of a double or a Niels add: X = EF in thread 0, Y = GH in 1, Z =
// FG in 2, T = EH in 3 (zero where need_t is false, as point_double does);
// the right factor folded back into M.
__device__ __forceinline__ fw wquad_round2(const fw& e, const fw& f, const fw& g, const fw& h,
                                           int q, bool need_t) {
  const fw l = wpick(q == 1, g, wpick(q == 2, f, e));
  const fw r = wide_fold(wpick(q == 0, f, wpick(q == 2, g, h)));
  const fw p = wide_mul(l, r);
  return (q == 3 && !need_t) ? fw_zero() : p;
}

// point_double on the quad's point: round 1 is X^2 (thread 0), (X + Y)^2
// (1), Z^2 (2) and Y^2 (3).
__device__ __forceinline__ fw wquad_double(const fw& c, int q, bool need_t) {
  const fw o = wquad_slot(c, q == 1 ? 0 : q == 3 ? 1 : q);
  const fw s = wide_sq(q == 1 ? wide_add(c, o) : q == 3 ? o : c);
  const fw a = wquad_slot(s, 0), d = wquad_slot(s, 1);
  const fw zz = wquad_slot(s, 2), b = wquad_slot(s, 3);
  const fw ab = wide_add(a, b);
  const fw e = wide_sub<4>(d, ab);                     // (X + Y)^2 - A - B
  const fw g = wide_sub<2>(b, a);                      // B - A
  const fw f = wide_sub<4>(b, wide_add(a, wide_add(zz, zz)));  // B - A - 2 Z^2
  const fw h = wide_sub<4>(fw_zero(), ab);             // -(A + B)
  return wquad_round2(e, f, g, h, q, need_t);
}

// point_add_niels on the quad's point and a Niels entry (in M) of which this
// thread holds coordinate niels_coord(q): round 1 is (Y - X) (y - x)', (Y +
// X) (y + x)', Z z' and T (2d t)'.
__device__ __forceinline__ fw wquad_add_niels(const fw& c, const fw& ent, int q, bool need_t) {
  const fw o = wquad_partner(c);
  const fw y = wpick(q & 1, c, o), x = wpick(q & 1, o, c);
  const fw p = wide_mul(q == 0 ? wide_sub<2>(y, x) : q == 1 ? wide_add(y, x) : c, ent);
  const fw a = wquad_slot(p, 0), b = wquad_slot(p, 1);
  const fw zz = wquad_slot(p, 2), t = wquad_slot(p, 3);
  const fw dd = wide_add(zz, zz);
  return wquad_round2(wide_sub<2>(b, a), wide_sub<2>(dd, t), wide_add(dd, t), wide_add(b, a), q,
                      need_t);
}

// to_niels on the quad's point: thread 0 forms Y + X, 1 Y - X, 2 keeps Z and
// 3 forms T 2d, so thread q holds Niels coordinate q (not folded).
__device__ __forceinline__ fw wquad_to_niels(const fw& c, int q) {
  const fw o = wquad_partner(c);
  const fw y = wpick(q & 1, c, o), x = wpick(q & 1, o, c);
  const fw t2d = wide_mul(c, fw_d2());
  return q == 0 ? wide_add(y, x) : q == 1 ? wide_sub<2>(y, x) : q == 2 ? c : t2d;
}

// point_add on the quad's points c and d: a Niels add of d's Niels form,
// each thread taking coordinate niels_coord(q) of it, folded.
__device__ __forceinline__ fw wquad_add(const fw& c, const fw& d, int q) {
  const fw ent = wide_fold(wquad_slot(wquad_to_niels(d, q), niels_coord(q)));
  return wquad_add_niels(c, ent, q, true);
}

// Canonical limbs of a and b equal (both as wide_carry or wide_fold leave
// them).
__device__ __forceinline__ bool wide_eq(const fw& a, const fw& b) {
  const fe x = wide_out(a), y = wide_out(b);
  bool eq = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) eq = eq && x.v[i] == y.v[i];
  return eq;
}

// [8]acc is the identity (X = 0, Y = Z) by three T-free doubles; the answer
// is that of quad thread 0.
__device__ __forceinline__ bool wquad_cofactor_identity(fw acc, int q) {
#pragma unroll 1
  for (int k = 0; k < 3; ++k) acc = wquad_double(acc, q, false);
  const fw x = wquad_slot(acc, 0), y = wquad_slot(acc, 1), z = wquad_slot(acc, 2);
  if (q != 0) return false;
  return wide_eq(x, fw_zero()) && wide_eq(y, z);
}

// The low 255 bits of the 32 bytes at src as wide limbs (each within its
// width: y is not reduced, so a non-canonical y is accepted), and bit 255.
__device__ __forceinline__ fw wide_from_bytes(const uint8_t* __restrict__ src, uint32_t& sign) {
  uint32_t e[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) e[b] = src[b];
  sign = e[31] >> 7;
  e[31] &= 0x7F;
  fw r;
#pragma unroll
  for (int k = 0; k < NWL; ++k) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int sh = 8 * b - wide_at(k);  // where byte b's bit 0 lands in limb k
      if (sh > -8 && sh < wide_bits(k)) v |= sh >= 0 ? e[b] << sh : e[b] >> -sh;
    }
    r.v[k] = v & ((1u << wide_bits(k)) - 1);
  }
  return r;
}

// ZIP-215 decompression (point.decompress) of the 32 bytes at src, all on
// the wide field, on one thread: x, y and t = x y in M (z = 1). u = y^2 - 1
// is folded so that wide_out takes it; v = d y^2 + 1; sqrt_ratio's products
// and the chain as decompress_wide's; check = u and check = -u, and the
// parity of x, on canonical limbs (wide_out).
__device__ __forceinline__ bool wide_decompress(fw& x_out, fw& y_out, fw& t_out,
                                                const uint8_t* __restrict__ src) {
  uint32_t sign;
  const fw y = wide_from_bytes(src, sign);
  const fw yy = wide_sq(y);
  const fw u = wide_fold(wide_sub<2>(yy, fw_one()));
  const fw v = wide_add(wide_mul(fw_d(), yy), fw_one());
  const fw v3 = wide_mul(wide_sq(v), v);
  const fw w = wide_pow22523(wide_mul(u, wide_mul(wide_sq(v3), v)));
  const fw r = wide_mul(wide_mul(u, v3), w);
  const fw check = wide_mul(v, wide_sq(r));
  const bool ok_pos = wide_eq(check, u);
  const bool ok_neg = wide_eq(wide_fold(wide_add(check, u)), fw_zero());
  const fw xr = wpick(ok_pos, r, wide_mul(r, fw_sqrt_m1()));
  const bool flip = (wide_out(xr).v[0] & 1) != (int32_t)sign;
  const fw x = wpick(flip, wide_fold(wide_sub<2>(fw_zero(), xr)), xr);
  x_out = x;
  y_out = y;
  t_out = wide_mul(x, y);
  return ok_pos || ok_neg;
}

}  // namespace edw
