"""Batched BLS12-381 aggregated-commit verification: the pairing lane.

Counterpart: tendermint_tpu/ops/bls_verify.py (verify_kernel :247 and
finalexp_kernel :300, XLA on the TPU), whose kernels csrc/bls12381.cu
replaces with two hand-written CUDA kernels (bls_miller, bls_finalexp).
A row is one aggregated commit: a G2 signature and a signer bitmap over
one committee. With Fiat-Shamir weights z_j the K pairing checks

    e(apk_j, H(m_j)) == e(g1, sigma_j)

fuse into prod_j e(apk_j, z_j H_j) e(-g1, z_j sigma_j) == 1: 2K Miller
loops and ONE final exponentiation. The host applies the weights on the
G2 side (z_j H_j and z_j sigma_j are scalar multiplications in
crypto/bls12381) and prepares each G2 point's line coefficients for the
uniform 63-step [double, add] schedule (bls12381.g2_prepare), so the
device does no G2 arithmetic.

    bls_miller    (launch A) a block a commit: the aggregate key as the
                  masked sum of the committee's G1 table (complete RCB
                  additions, a = 0, b3 = 12; a masked-out row adds the
                  identity), the two Miller chains at the projective apk
                  and at -g1, each conjugated, and f_j = f_0 f_1
    bls_finalexp  f^((p^12 - 1) / r) by square and multiply over the
                  exponent's 4,314 bits, MSB first: `fused` multiplies
                  the K rows' f_j into one element first (launch A's
                  fused residue); else each row on its own (launch B)

The G1 point enters the lines projectively: a line XI yP + c w^3 - lam
xP w^5 at (X/Z, Y/Z) is (1/Z)(XI Y + c Z w^3 - lam X w^5), and the
factor dies under the final exponentiation, as does any Fp factor of
f_j. So the apk sum's order may differ from the reference's halving
tree (verify_kernel :264-280): the projective apk and the raw f_j then
differ from the reference's by a factor in Fp, while the affine apk,
whether it is the identity, finalexp(f_j), the fused residue and the
verdicts are the same. The kernel and its plain version sum in the same
order (verify_plain emulates the kernel's THREADS threads: each sums
the rows t, t + THREADS, ... from the identity, then a halving tree over
the threads), so every output of the two is equal word for word.

Arrays (words are 32-bit, little-endian, canonical: value in [0, p)):
gx, gy (Vp, 12) int32, the committee's affine G1 keys (the epoch
table; row Vp - 1 the padding row, g1); masks (K, Vp) bool; coeffs
(K, 2, 63, 2, 2, 2, 12) int32, [pair, step, dbl/add, lam/c, Fp2
component, word], pair 0 the (apk, z H) lines and pair 1 the (-g1,
z sigma) ones; apk (K, 3, 12) the projective aggregate key; f (K, 6, 2,
12) the Miller products; residues (rows, 6, 2, 12). An Fp12 element is
the flat tower Fp2[w]/(w^6 - XI), XI = 1 + u, coefficient (i, j) the
u^j part of w^i, as the reference's (6, 2, 36) limb tensors.

Verdict protocol (run_verify, the reference's): launch A; the host
reads apk's Z and the fused residue back and reduces them. All lanes
accepted by the host, every apk not the identity and the fused residue
1: every commit is accepted, one launch A. Otherwise launch B
exponentiates each f_j alone, finalexp(f_j) = check_j^(z_j) in the
order-r group, which is 1 iff commit j's check holds: the blame is
exact. verdict_codes folds it all into an int32 code row.

A wrapper runs the plain version (verify_plain, finalexp_plain: PyTorch
over ops/fe_bls.py) for CPU tensors and launches its kernel for CUDA
tensors, counting launches in kernels.LAUNCHES. The host prep never
raises: a malformed, identity or non-subgroup signature, or a commit
touching a bad committee key, keeps the pad commit's numbers with ok
False and its reason (types/validation.py words the blame).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch
from torch.profiler import record_function

from ..crypto import bls12381 as bls
from . import fe_bls as fe
from . import kernels

P = bls.P
N_ATE = bls.N_ATE
B3 = 12  # 3 b for y^2 = x^3 + 4
NL = fe.NLIMBS
NW = fe.NWORDS
THREADS = 128  # bls_miller's block: the threads that stride the committee

FE_BITS = np.array([int(b) for b in bin(bls.FINAL_EXP)[2:]], dtype=np.int64)
assert len(FE_BITS) == 4314 and int(FE_BITS.sum()) == 2124

# the kernels' buckets (backend.BLS_BUCKETS): commits a launch
BUCKETS = (4, 16)


def bucket_for(n: int) -> int:
    """The bucket of n commits (backend._bls_bucket_for); above the last,
    the caller splits."""
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


# -- plain versions: G1 -----------------------------------------------------------


def point_add(p, q):
    """Complete projective addition on y^2 = x^3 + 4, a = 0 (RCB16
    Algorithm 7, b3 = 12): valid for every input, the identity (0, 1, 0)
    among them, so masked-out rows need no branch."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = fe.mul(x1, x2)
    t1 = fe.mul(y1, y2)
    t2 = fe.mul(z1, z2)
    t3 = fe.sub(fe.mul(fe.add(x1, y1), fe.add(x2, y2)), fe.add(t0, t1))
    t4 = fe.sub(fe.mul(fe.add(y1, z1), fe.add(y2, z2)), fe.add(t1, t2))
    t5 = fe.sub(fe.mul(fe.add(x1, z1), fe.add(x2, z2)), fe.add(t0, t2))
    t0_3 = fe.mul_small(t0, 3)
    t2_b = fe.mul_small(t2, B3)
    zs = fe.add(t1, t2_b)
    t1m = fe.sub(t1, t2_b)
    t5_b = fe.mul_small(t5, B3)
    x3 = fe.sub(fe.mul(t3, t1m), fe.mul(t4, t5_b))
    y3 = fe.add(fe.mul(t1m, zs), fe.mul(t5_b, t0_3))
    z3 = fe.add(fe.mul(zs, t4), fe.mul(t0_3, t3))
    return (x3, y3, z3)


def apk_sum(gx, gy, masks):
    """The masked sum of the table in the kernel's order: thread t of
    THREADS sums rows t, t + THREADS, ... (< Vp) from the identity, a
    masked-out row as the identity; then thread t adds thread t + s for
    s = THREADS/2, ..., 1. gx, gy (Vp, 36) limbs, masks (K, Vp) bool ->
    (X, Y, Z), each (K, 36)."""
    k, vp = masks.shape
    dev = masks.device
    one = fe.const(1, dev)
    zero = torch.zeros_like(one)
    acc = (zero.expand(k, THREADS, NL), one.expand(k, THREADS, NL),
           zero.expand(k, THREADS, NL))
    for c0 in range(0, vp, THREADS):
        rows = torch.arange(c0, c0 + THREADS, device=dev)
        valid = rows < vp
        r = rows.clamp(max=vp - 1)
        m = (masks[:, r] & valid).unsqueeze(-1)
        q = (torch.where(m, gx[r], zero), torch.where(m, gy[r], one),
             torch.where(m, one, zero))
        s = point_add(acc, q)
        acc = tuple(torch.where(valid.unsqueeze(-1), a, b) for a, b in zip(s, acc))
    s = THREADS // 2
    while s >= 1:
        acc = point_add(tuple(c[:, :s] for c in acc), tuple(c[:, s : 2 * s] for c in acc))
        s //= 2
    return tuple(c[:, 0] for c in acc)


# -- plain versions: Fp12, the flat tower -----------------------------------------


def _product_map(slots) -> np.ndarray:
    """The linear map from the Fp products a_(i,s) b_(j,t) (a's w-slot i
    of 6 and u-component s, b's w-slot slots[j] and component t) to the
    product's coefficient (k, component): the Fp2 combine (a0 b0 - a1 b1,
    a0 b1 + a1 b0) and the XI fold of w^(k+6) = XI w^k (XI (h0 + h1 u)
    = (h0 - h1) + (h0 + h1) u). Shape (6 * len(slots) * 4, 12): rows
    (j, t, i, s), columns (k, component); entries in {-1, 0, 1}."""
    m = np.zeros((len(slots), 2, 6, 2, 6, 2))
    for i in range(6):
        for jj, j in enumerate(slots):
            for s_ in range(2):
                for t in range(2):
                    comp = 0 if s_ == t else 1
                    sign = -1 if s_ == t == 1 else 1
                    e = i + j
                    if e < 6:
                        m[jj, t, i, s_, e, comp] += sign
                    elif comp == 0:
                        m[jj, t, i, s_, e - 6, 0] += sign
                        m[jj, t, i, s_, e - 6, 1] += sign
                    else:
                        m[jj, t, i, s_, e - 6, 0] -= sign
                        m[jj, t, i, s_, e - 6, 1] += sign
    return m.reshape(len(slots) * 2 * 6 * 2, 12)


_MAP_FULL = _product_map(range(6))
_MAP_SPARSE = _product_map((0, 3, 5))


def _f12_product(a, b, pmap: np.ndarray, name: str):
    """a (..., 6, 2, 36) times b (..., B, 2, 36), b's slots as pmap says:
    every Fp convolution in one float64 matrix product of b's Toeplitz
    matrices and a's limbs, the Fp2 combine and the XI fold in a second,
    then one reduction (fe_bls.reduce_wide, three passes: a coefficient
    sums at most 24 convolutions, each below 7.6e8 in magnitude). All
    terms and partial sums are integers below 2^53, so both products are
    exact. The value equals the reference's f12_mul, whose limbs reduce
    each Fp product before the sums."""
    nb = b.shape[-3]
    batch = torch.broadcast_shapes(a.shape[:-3], b.shape[:-3])
    a = a.expand(*batch, 6, 2, NL)
    b = b.expand(*batch, nb, 2, NL)
    tb = fe.toeplitz(b).reshape(*batch, nb * 2 * (2 * NL - 1), NL)  # rows (j, t, k)
    amat = a.to(torch.float64).flip(-1).reshape(*batch, 12, NL).transpose(-1, -2)
    c = (tb @ amat).reshape(*batch, nb * 2, 2 * NL - 1, 12)  # (..., (j, t), k, (i, s))
    c = c.movedim(-2, -3).reshape(*batch, 2 * NL - 1, nb * 2 * 12)  # (..., k, (j, t, i, s))
    out = c @ fe._on(name, pmap, c.device, torch.float64)  # (..., 71, (k, comp))
    out = out.to(torch.int64).transpose(-1, -2).reshape(*batch, 6, 2, 2 * NL - 1)
    return fe.reduce_wide(out, passes=3)


def f12_mul(a, b):
    """Fp12 product: (..., 6, 2, 36) x (..., 6, 2, 36) -> reduced."""
    return _f12_product(a, b, _MAP_FULL, "MAP_FULL")


def f12_mul_sparse(a, l3):
    """a times a sparse line given by its w-slots (0, 3, 5), l3
    (..., 3, 2, 36)."""
    return _f12_product(a, l3, _MAP_SPARSE, "MAP_SPARSE")


def f12_conj(f):
    """f^(p^6): w -> -w, the odd w-coefficients negated."""
    sign = torch.tensor([1, -1, 1, -1, 1, -1], dtype=f.dtype, device=f.device)
    return f * sign[:, None, None]


def f12_one(shape, device) -> torch.Tensor:
    one = torch.zeros((*shape, 6, 2, NL), dtype=torch.int64, device=device)
    one[..., 0, 0, :] = fe.const(1, device)
    return one


def _line_slots(lam, c, xl, yl, zl):
    """The line's w-slots (0, 3, 5) at the projective G1 point: lam, c
    (..., 2, 36), xl, yl, zl (..., 36) -> (..., 3, 2, 36) = (XI Y, c Z,
    -lam X), XI Y = (Y, Y)."""
    lhs = torch.cat([c, lam], dim=-2)  # (..., 4, 36)
    rhs = torch.stack([zl, zl, xl, xl], dim=-2)
    prod = fe.mul(lhs, rhs)
    slot0 = torch.stack([yl, yl], dim=-2)
    slot3 = prod[..., 0:2, :]
    slot5 = -prod[..., 2:4, :]
    return torch.stack([slot0, slot3, slot5], dim=-3)


def miller(coeffs, xl, yl, zl):
    """The Miller loop over prepared line coefficients: coeffs (...,
    N_ATE, 2, 2, 2, 36) [step, dbl/add, lam/c, Fp2, limb], the projective
    G1 point xl, yl, zl (..., 36). Returns the conjugated Miller value
    (the BLS parameter is negative), (..., 6, 2, 36)."""
    f = f12_one(xl.shape[:-1], xl.device)
    for step in range(N_ATE):
        f = f12_mul(f, f)
        for s in range(2):  # the doubling's line, then the addition's
            lam = coeffs[..., step, s, 0, :, :]
            c = coeffs[..., step, s, 1, :, :]
            f = f12_mul_sparse(f, _line_slots(lam, c, xl, yl, zl))
    return f12_conj(f)


def final_exp(f):
    """f^((p^12 - 1) / r), batched over leading dims: square on every
    exponent bit, MSB first, and multiply by f on each one bit (the
    reference's select-multiply by one computes the same value)."""
    acc = f12_one(f.shape[:-3], f.device)
    for bit in FE_BITS.tolist():
        acc = f12_mul(acc, acc)
        if bit:
            acc = f12_mul(acc, f)
    return acc


GX_L = fe.limbs_from_int(bls.GX)
NEG_GY_L = fe.limbs_from_int(P - bls.GY)


def verify_plain(gx, gy, masks, coeffs):
    """bls_miller's function (see the module docstring), the plain version
    of launch A's first kernel (with finalexp_plain's fused form, the
    reference's verify_kernel): (apk (K, 3, 12), f (K, 6, 2, 12)) int32
    canonical words."""
    dev = masks.device
    k = masks.shape[0]
    x, y, z = apk_sum(fe.from_words(gx), fe.from_words(gy), masks)
    g1 = (torch.from_numpy(GX_L).to(dev).expand(k, NL),
          torch.from_numpy(NEG_GY_L).to(dev).expand(k, NL),
          fe.const(1, dev).expand(k, NL))
    xl, yl, zl = (torch.stack([a, b], dim=1) for a, b in zip((x, y, z), g1))  # (K, 2, 36)
    f_pairs = miller(fe.from_words(coeffs), xl, yl, zl)  # (K, 2, 6, 2, 36)
    f = f12_mul(f_pairs[:, 0], f_pairs[:, 1])
    return torch.stack([fe.to_words(c) for c in (x, y, z)], dim=1), fe.to_words(f)


def finalexp_plain(f, fused: bool = False):
    """bls_finalexp's function: f (rows, 6, 2, 12) words -> each row's
    final exponentiation (rows, 6, 2, 12), or with `fused` that of the
    rows' product, (1, 6, 2, 12)."""
    x = fe.from_words(f)
    if fused:
        acc = x[0]
        for j in range(1, x.shape[0]):
            acc = f12_mul(acc, x[j])
        x = acc[None]
    return fe.to_words(final_exp(x))


# -- kernel wrappers ----------------------------------------------------------------


def bls_miller(gx, gy, masks, coeffs):
    """Launch A's Miller kernel (csrc/bls12381.cu bls_miller_kernel,
    replacing bls_verify.verify_kernel's apk sum and Miller loops); see
    verify_plain."""
    dev = kernels.device_of(masks)
    k, vp = masks.shape
    if vp < 1 or k < 1:
        raise ValueError("a BLS batch has at least one commit and one table row")
    kernels.check_tensor("gx", gx, (vp, NW), torch.int32, dev)
    kernels.check_tensor("gy", gy, (vp, NW), torch.int32, dev)
    kernels.check_tensor("masks", masks, (k, vp), torch.bool, dev)
    kernels.check_tensor("coeffs", coeffs, (k, 2, N_ATE, 2, 2, 2, NW), torch.int32, dev)
    if dev.type == "cpu":
        return verify_plain(gx, gy, masks, coeffs)
    apk = torch.empty((k, 3, NW), dtype=torch.int32, device=dev)
    f = torch.empty((k, 6, 2, NW), dtype=torch.int32, device=dev)
    kernels.launch("bls_miller", gx, gy, masks, coeffs, apk, f, k, vp)
    return apk, f


def bls_finalexp(f, fused: bool = False):
    """The final exponentiation kernel (csrc/bls12381.cu
    bls_finalexp_kernel, replacing bls_verify.finalexp_kernel and the
    fused exponentiation inside verify_kernel); see finalexp_plain."""
    dev = kernels.device_of(f)
    rows = f.shape[0]
    if rows < 1:
        raise ValueError("a final exponentiation has at least one row")
    kernels.check_tensor("f", f, (rows, 6, 2, NW), torch.int32, dev)
    if dev.type == "cpu":
        return finalexp_plain(f, fused)
    out = torch.empty((1 if fused else rows, 6, 2, NW), dtype=torch.int32, device=dev)
    kernels.launch("bls_finalexp", f, out, rows, int(fused))
    return out


def launch_a(gx, gy, masks, coeffs):
    """Launch A: bls_miller, then bls_finalexp fused over its f ->
    (apk, f, fused (6, 2, 12))."""
    apk, f = bls_miller(gx, gy, masks, coeffs)
    return apk, f, bls_finalexp(f, fused=True)[0]


# -- host prep ----------------------------------------------------------------------


def table_columns_g1(pubs):
    """A committee's 48-byte keys -> its table: gx, gy (V+1, 12) int32
    words. A bad key (malformed, the identity, not in the subgroup)
    carries g1 (bad_rows names it; no kernel reads a flag); row V is the
    padding row, g1. The reference also returns an ok column."""
    xs, ys = [], []
    for pub in pubs:
        pt, reason = bls.pubkey_status(bytes(pub))
        ok = reason is None
        xs.append(pt[0] if ok else bls.GX)
        ys.append(pt[1] if ok else bls.GY)
    xs.append(bls.GX)
    ys.append(bls.GY)
    return fe.words_from_ints(xs), fe.words_from_ints(ys)


def _coeff_rows(q2) -> np.ndarray:
    """g2_prepare of a (z-scaled) G2 point in the kernels' layout (N_ATE,
    2, 2, 2, 12) words."""
    flat = []
    for (lam_d, c_d), (lam_a, c_a) in bls.g2_prepare(q2):
        for pair in (lam_d, c_d, lam_a, c_a):
            flat.extend(pair)
    return fe.words_from_ints(flat).reshape(N_ATE, 2, 2, 2, NW)


PAD_MSG = b"tm-tpu/bls-pad-commit"


@functools.lru_cache(maxsize=None)
def _pad_numerics():
    """The pad commit: sk = 1, so its key is g1 (the table's padding
    row), sigma = H(PAD_MSG), z = 1; e(g1, H) == e(g1, H), so its
    residue is 1 and it never makes a batchmate fail."""
    h = _coeff_rows(bls.hash_to_g2(PAD_MSG))
    return h, h


@functools.lru_cache(maxsize=4096)
def _prepared_pair(sig: bytes, msg: bytes, z: int):
    """(z H(msg), z sigma) line coefficients of one commit, memoized (a
    retried commit skips the G2 scalar multiplications)."""
    s, _ = bls.signature_status(sig)
    zh = bls.g2_mul(z, bls.hash_to_g2(msg))
    zs = bls.g2_mul(z % bls.R, s)
    return _coeff_rows(zh), _coeff_rows(zs)


def rlc_weights(items) -> list:
    """The Fiat-Shamir weights: each z_j (128 bits, odd) binds the whole
    batch (every bitmap, message and signature), so no signer can steer
    a cancellation across the fused product."""
    ctx = hashlib.sha256()
    for bits, msg, sig in items:
        ctx.update(hashlib.sha256(
            np.asarray(bits, dtype=np.uint8).tobytes()
            + b"\x00" + bytes(msg) + b"\x00" + bytes(sig)
        ).digest())
    digest = ctx.digest()
    return [
        int.from_bytes(hashlib.sha256(digest + j.to_bytes(4, "big")).digest()[:16], "big") | 1
        for j in range(len(items))
    ]


def prepare_commits(items, size: int, vp: int, bad_rows=()):
    """The host prep of (signer bits (n_vals,) bool, msg, sig96) commits:
    `size` rows (rows past the items are pad commits), masks over `vp`
    table rows (the last the padding row), and bad_rows the committee
    rows whose key is unusable (a commit touching one keeps the pad
    numbers with the lowest such index as its reason).

    Returns (masks (size, vp) bool, coeffs (size, 2, N_ATE, 2, 2, 2, 12)
    int32, ok (size,) bool, reasons [str or None]); never raises."""
    masks = np.zeros((size, vp), dtype=bool)
    masks[:, vp - 1] = True  # a pad commit selects the padding row alone
    coeffs = np.empty((size, 2, N_ATE, 2, 2, 2, NW), dtype=np.int32)
    pad_a, pad_b = _pad_numerics()
    coeffs[:, 0] = pad_a
    coeffs[:, 1] = pad_b
    ok = np.ones(size, dtype=bool)
    reasons: list = [None] * size
    bad_rows = set(bad_rows)
    zs = rlc_weights(items)
    for i, (bits, msg, sig) in enumerate(items):
        bits = np.asarray(bits, dtype=bool)
        _, reason = bls.signature_status(bytes(sig))
        if reason is not None:
            ok[i] = False
            reasons[i] = f"sig:{reason}"
            continue
        hit = sorted(bad_rows.intersection(np.flatnonzero(bits).tolist()))
        if hit:
            ok[i] = False
            reasons[i] = f"pub:{hit[0]}"
            continue
        coeffs[i, 0], coeffs[i, 1] = _prepared_pair(bytes(sig), bytes(msg), zs[i])
        masks[i, : len(bits)] = bits
        masks[i, vp - 1] = False
    return masks, coeffs, ok, reasons


_ONE12_W = np.zeros((6, 2, NW), dtype=np.int32)
_ONE12_W[0, 0, 0] = 1


def residue_is_one(words) -> bool:
    """A canonical (6, 2, 12) residue read back: is it 1 in Fp12?"""
    return bool(np.array_equal(np.asarray(words), _ONE12_W))


def run_verify(tables, masks, coeffs, ok_host):
    """The two-launch verdict protocol over prepared arrays on one device
    (tables (gx, gy) and masks, coeffs as tensors there). Returns
    (verdicts, crypto_failed, apk_nz), (K,) bool each over the prepared
    rows: crypto_failed the lanes whose pairing check itself failed,
    apk_nz False where the masked sum is the identity."""
    gx, gy = tables
    with record_function("bls.launch_a"):
        apk, f, fused = launch_a(gx, gy, masks, coeffs)
    with record_function("bls.reduce"):  # waits for launch A
        host = torch.cat([apk[:, 2].reshape(-1), fused.reshape(-1)]).cpu().numpy()
    k = masks.shape[0]
    apk_nz = host[: k * NW].reshape(k, NW).any(axis=1)
    lane_ok = np.asarray(ok_host, dtype=bool) & apk_nz
    if bool(lane_ok.all()) and residue_is_one(host[k * NW :].reshape(6, 2, NW)):
        return lane_ok.copy(), np.zeros(k, dtype=bool), apk_nz
    # the rare path: each commit's Miller product exponentiated alone
    with record_function("bls.launch_b"):
        res = bls_finalexp(f).cpu().numpy()
    pair_ok = np.array([residue_is_one(res[j]) for j in range(k)])
    return lane_ok & pair_ok, lane_ok & ~pair_ok, apk_nz


# -- verdict codes --------------------------------------------------------------------
#
# The dispatcher's row for this lane is int32 codes, not booleans: the
# conclude of types/validation.prepare_aggregated_commit is made before
# prep runs, so everything its blame needs rides the row.

CODE_VALID = 1
CODE_PAIRING = 2  # the pairing check failed (a wrong aggregate signature)
CODE_APK_IDENTITY = 3  # the masked key sum is the identity
CODE_SIG = {"malformed": 4, "identity": 5, "subgroup": 6}
CODE_PUB_BASE = 16  # CODE_PUB_BASE + i: validator i's key is unusable

SIG_CODE_WORDS = {v: w for w, v in CODE_SIG.items()}


def verdict_codes(verdicts, crypto_failed, apk_nz, reasons) -> np.ndarray:
    """run_verify's outputs and prepare_commits' reasons -> the int32
    code row. A host rejection wins over the residues: it never reached
    a real pairing."""
    k = len(verdicts)
    codes = np.empty(k, dtype=np.int32)
    for j in range(k):
        r = reasons[j] if j < len(reasons) else None
        if r is not None:
            if r.startswith("sig:"):
                codes[j] = CODE_SIG[r[4:]]
            else:
                codes[j] = CODE_PUB_BASE + int(r[4:])
        elif not apk_nz[j]:
            codes[j] = CODE_APK_IDENTITY
        elif verdicts[j]:
            codes[j] = CODE_VALID
        else:
            codes[j] = CODE_PAIRING
    return codes


# -- the batch path -------------------------------------------------------------------


class BlsBatch:
    """One prepared batch of at most BUCKETS[-1] aggregated commits: the
    host arrays to copy (`args`: masks, coeffs), its bucket, the epoch
    entry of its committee (None: `tables`, the host-built table), and
    the host's lane flags and reasons. Its launch runs the whole
    protocol and gives the code row on the host; `codes` tells the
    dispatcher's resolver to keep that row as int32."""

    __slots__ = ("entries", "bucket", "ep", "args", "ok", "reasons", "tables")
    codes = True

    def __init__(self, entries, bucket: int, ep, args: tuple, ok, reasons, tables):
        self.entries = entries
        self.bucket = bucket
        self.ep = ep
        self.args = args
        self.ok = ok
        self.reasons = reasons
        self.tables = tables

    def launch(self, dev_args) -> torch.Tensor:
        return launch_batch(self, dev_args)

    def conclude(self, row: np.ndarray) -> np.ndarray:
        return conclude_batch(self, row)


def bad_rows(pub48: np.ndarray) -> list:
    """Committee rows whose key is unusable (pubkey_status is memoized per
    key, so after an epoch's first sight this is a dict walk)."""
    return [i for i in range(pub48.shape[0])
            if bls.pubkey_status(pub48[i].tobytes())[1] is not None]


def prepare_batch(block, ep=None) -> BlsBatch:
    """The host stage for an AggBlock (touches no CUDA): the weights, the
    G2 scalar multiplications and line coefficients (prepare_commits),
    over the epoch entry's vp rows, or, without one, a table built here
    from the block's pub48 snapshot. Pad rows (is_pad) are trailing and
    prepare as pad commits."""
    k = len(block)
    if k > BUCKETS[-1]:
        raise ValueError(f"a BLS batch holds at most {BUCKETS[-1]} commits")
    live = int(np.count_nonzero(~block.is_pad))
    if block.is_pad[:live].any():
        raise ValueError("AggBlock pad rows must be trailing")
    bucket = bucket_for(k)
    with record_function("bls.prep"):
        tables = None
        if ep is None:
            tables = table_columns_g1([r.tobytes() for r in block.pub48])
            vp = block.pub48.shape[0] + 1
        else:
            vp = ep.vp
        items = [(block.bits[i], block.msg(i), block.sig[i].tobytes()) for i in range(live)]
        masks, coeffs, ok, reasons = prepare_commits(items, bucket, vp,
                                                     bad_rows=bad_rows(block.pub48))
    return BlsBatch(block, bucket, ep, (masks, coeffs), ok, reasons, tables)


def launch_batch(batch: BlsBatch, dev_args) -> torch.Tensor:
    """The device stage: masks and coeffs on one device -> the (bucket,)
    int32 code row as a host tensor, after launch A, the host reduce and
    launch B where it is needed. A warm committee's table is uploaded
    once per device (EpochEntry.bls_tables); a cold one is copied now."""
    masks, coeffs = dev_args
    dev = masks.device
    with record_function("bls.tables"):
        if batch.ep is not None:
            tables = batch.ep.bls_tables(dev)
        else:
            tables = tuple(torch.from_numpy(t).to(dev) for t in batch.tables)
    verdicts, cfail, apk_nz = run_verify(tables, masks, coeffs, batch.ok)
    return torch.from_numpy(verdict_codes(verdicts, cfail, apk_nz, batch.reasons))


def conclude_batch(batch: BlsBatch, row: np.ndarray) -> np.ndarray:
    """The code row read back -> (n,) int32 codes, padding cut."""
    return np.asarray(row, dtype=np.int32)[: len(batch.entries)].copy()
