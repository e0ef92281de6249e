"""Per-lane RLC fast-accept verification — M signatures per kernel lane.

Counterpart: tendermint_tpu/ops/pallas_rlc.py. Lane g covers signatures
j = 0..M-1 with coefficients c_0 = 1, c_j = z_j (random 128-bit, fresh
from os.urandom for every batch):

    acc = [S]B - sum_j [u_j]A_j - sum_{j>=1} [z_j]R_j
    accept iff [8]acc == [8]R_0          (cofactored, ZIP-215)

    S = (s_0 + sum z_j s_j) mod L,  u_0 = k_0,  u_j = (z_j k_j) mod L

Valid lanes always accept; a lane with a bad signature rejects except
with probability <= 2^-125, and its M signatures are then re-verified on
the host for blame (expand_lanes). Three kernels run per batch, each
with a CUDA version (csrc/rlc.cu) and a plain PyTorch version here:

  K1  k1_rlc  digits of the 2M lane scalars; ZIP-215 decompression of
              A_0..A_{M-1}, R_0..R_{M-1}
      k1_rlc_cached  the same for a warm validator set: A_j comes from
              the epoch table (ops/epoch_cache.py), only R decompresses
  K2  k2_rlc  M joint 16-entry Straus tables in Niels form
  K3  k3_rlc  the 127-iteration shared-doubles ladder and the final
              [8]acc == [8]R_0 test, ANDed with the 2M decompression
              flags and the M host s < L flags

Global arrays keep the JAX layout: (rows, g) with the lane last, uint8
bytes in, int32 limbs, flags and digits out; coordinates sit in 32-row
slots (limbs 0..19, rows 20..31 zero). A wrapper runs the plain version
for CPU tensors and launches its kernel for CUDA tensors; it counts its
launches in kernels.LAUNCHES. A batch runs in three stages, plain
functions the synchronous verify_batch_rlc and the asynchronous
dispatcher (ops/pipeline.py) share: prepare_batch (host only),
launch_batch (device tensors in, the device lane verdicts out, on the
current stream) and conclude_batch (the host lane verdicts to
per-signature verdicts). Their work is marked by torch.profiler
record_function spans: rlc.prep, rlc.gather on a warm epoch,
rlc.kernels, rlc.expand; the synchronous path adds rlc.h2d and rlc.d2h.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.profiler import record_function

from ..crypto import _edwards
from . import epoch_cache, fe, host, kernels, point

NL = fe.NLIMBS

M = 4  # signatures per lane
N_SCAL = 2 * M  # scalar q: 0 -> S, 1..M -> u_{q-1}, M+1..2M-1 -> z_{q-M}
# Table t pairs scalars (2t, 2t+1); tables whose two scalars are both z's
# have no digits above bit 128 and are skipped in the ladder's top half.
N_FULL_TABLES = M // 2 + 1

BLOCK_LANES = 128  # lanes per plan_bucket block (pallas_rlc.BLOCK_LANES)
MAX_SIGS = 81920  # signatures per device batch
RLC_BUCKETS = (512, 2048, 10240, 20480, 40960, 81920)

COORD_ROWS = 2 * M * 4 * 32
TBL_ROWS = M * 16 * 4 * 32
DIG_ROWS = N_SCAL * 128

_point_rows = point.slot_rows


def _tbl_rows(t: int, e: int, c: int) -> slice:
    base = ((t * 16 + e) * 4 + c) * 32
    return slice(base, base + NL)


# -- plain versions -----------------------------------------------------------


def _k1_outputs(scal_t):
    """Zeroed K1 outputs with the digits of the 2M lane scalars filled in
    from the slot-major scalar bytes (N_SCAL*32, g)."""
    g = scal_t.shape[-1]
    kw = dict(dtype=torch.int32, device=scal_t.device)
    coords = torch.zeros((COORD_ROWS, g), **kw)
    ok = torch.zeros((2 * M, g), **kw)
    dig = torch.zeros((DIG_ROWS, g), **kw)
    for q in range(N_SCAL):
        enc = scal_t[q * 32 : (q + 1) * 32].to(torch.int32)
        dig[q * 128 : (q + 1) * 128] = point.unpack_digits2_grouped(enc)
    return coords, ok, dig


def _decompress_points(coords, ok, srcs, first: int) -> None:
    """Decompress the (32, g) encodings `srcs` into points first,
    first+1, ... of coords and ok, in one decompression folded along the
    lane axis."""
    g = coords.shape[-1]
    ys, signs = zip(*(point.unpack_limbs(e.to(torch.int32)) for e in srcs))
    ok_all, pts = point.decompress(torch.cat(ys, dim=1), torch.cat(signs, dim=1))
    for i in range(len(srcs)):
        p = first + i
        ok[p : p + 1] = ok_all[:, i * g : (i + 1) * g].to(torch.int32)
        for c in range(4):
            coords[_point_rows(p, c)] = pts[c][:, i * g : (i + 1) * g]


def k1_rlc_plain(a_t, r_t, scal_t):
    """(M*32, g) A bytes, (M*32, g) R bytes, (N_SCAL*32, g) scalar bytes
    (uint8) -> coords (COORD_ROWS, g), ok (2M, g), dig (DIG_ROWS, g) int32.
    Points A_0..A_{M-1} then R_0..R_{M-1}; digits scalar-major."""
    coords, ok, dig = _k1_outputs(scal_t)
    srcs = [t[j * 32 : (j + 1) * 32] for t in (a_t, r_t) for j in range(M)]
    _decompress_points(coords, ok, srcs, 0)
    return coords, ok, dig


def k1_rlc_cached_plain(ctbl, oktbl, idx, r_rows, scal_rows):
    """K1 for a warm epoch. ctbl (4*32, vp), oktbl (1, vp) int32: the
    epoch table (ops/epoch_cache.py); idx (g*M,) int32 table columns,
    signature-major (i = lane*M + slot); r_rows (g*M, 32) and scal_rows
    (g, N_SCAL, 32) uint8, row-major -> k1_rlc_plain's outputs. A_j
    comes from column idx[lane*M + j]; only the M R points decompress."""
    g = scal_rows.shape[0]
    coords, ok, dig = _k1_outputs(scal_rows.permute(1, 2, 0).reshape(N_SCAL * 32, g))
    cols = idx.to(torch.int64).view(g, M).T  # (M, g)
    for p in range(M):
        ok[p] = oktbl[0, cols[p]]
        for c in range(4):
            coords[_point_rows(p, c)] = ctbl[c * 32 : c * 32 + NL][:, cols[p]]
    r_t = r_rows.view(g, M, 32).permute(1, 2, 0)  # (M, 32, g)
    _decompress_points(coords, ok, list(r_t), M)
    return coords, ok, dig


def k2_rlc_plain(coords):
    """coords (COORD_ROWS, g) -> tbl (TBL_ROWS, g) int32. Table t holds
    [lo]P_t + [hi]Q_t at entry lo + 4 hi (digits lo, hi in 0..3), where
    (P_t, Q_t) are the points of scalars (2t, 2t+1): B for S, -A_j for
    u_j, -R_j for z_j."""
    g = coords.shape[-1]
    pts = [
        point.point_neg(tuple(coords[_point_rows(p, c)] for c in range(4)))
        for p in range(2 * M)
    ]
    zero = torch.zeros((NL, g), dtype=torch.int32, device=coords.device)
    one = fe.from_int(1, coords) + zero
    base = tuple(fe.from_int(_edwards.BASE[c], coords) + zero for c in range(4))
    ident = (zero, one, one, zero)

    def point_of(q):
        return base if q == 0 else pts[q - 1] if q <= M else pts[q]

    P = [point_of(2 * t) for t in range(M)]
    Q = [point_of(2 * t + 1) for t in range(M)]
    pair = point.cat_points(P + Q)
    dbl = point.point_double(pair)
    tri = point.point_add(dbl, pair)
    tbl = torch.zeros((TBL_ROWS, g), dtype=torch.int32, device=coords.device)
    for t in range(M):
        rows = [ident, P[t], point.slice_point(dbl, t, g), point.slice_point(tri, t, g)]
        cols = [ident, Q[t], point.slice_point(dbl, M + t, g), point.slice_point(tri, M + t, g)]
        crosses = point.point_add(
            point.cat_points([rows[lo] for hi in (1, 2, 3) for lo in (1, 2, 3)]),
            point.cat_points([cols[hi] for hi in (1, 2, 3) for lo in (1, 2, 3)]),
        )
        entries = []
        for hi in range(4):
            for lo in range(4):
                if hi == 0:
                    entries.append(rows[lo])
                elif lo == 0:
                    entries.append(cols[hi])
                else:
                    entries.append(point.slice_point(crosses, (hi - 1) * 3 + (lo - 1), g))
        niels = point.to_niels(point.cat_points(entries))
        for e in range(16):
            ent = point.slice_point(niels, e, g)
            for c in range(4):
                tbl[_tbl_rows(t, e, c)] = ent[c]
    return tbl


def k3_rlc_plain(tbl, dig, coords, ok, sok):
    """tbl (TBL_ROWS, g), dig (DIG_ROWS, g), coords (COORD_ROWS, g),
    ok (2M, g), sok (M, g) -> (1, g) int32 lane verdicts."""
    g = sok.shape[-1]
    dev = sok.device
    zero = torch.zeros((NL, g), dtype=torch.int32, device=dev)
    one = fe.from_int(1, sok) + zero
    acc = (zero, one, one, zero)
    limb = torch.arange(NL, device=dev)[:, None]

    def select(t, idx):
        # direct indexed load of entry idx (per lane) of table t
        return tuple(
            tbl.gather(0, (((t * 16 + idx[None, :]) * 4 + c) * 32) + limb)
            for c in range(4)
        )

    for i in range(127):
        # digit positions 126..64 (i < 63): the all-z tables are skipped
        n_tables = N_FULL_TABLES if i < 63 else M
        j = point.digit_row(126 - i)
        acc = point.point_double(point.point_double(acc, need_t=False))
        for t in range(n_tables):
            idx = dig[2 * t * 128 + j] + 4 * dig[(2 * t + 1) * 128 + j]
            # only the last add before the next iteration's doubles skips T
            acc = point.point_add_niels(acc, select(t, idx),
                                        need_t=t + 1 < n_tables)

    # [8]acc == [8]R_0 by doubles-only projective cross-multiplication
    acc8 = acc
    r8 = tuple(coords[_point_rows(M, c)] for c in range(4))
    for _ in range(3):
        acc8 = point.point_double(acc8, need_t=False)
        r8 = point.point_double(r8, need_t=False)
    eq_x = fe.is_zero(fe.sub(fe.mul(acc8[0], r8[2]), fe.mul(r8[0], acc8[2])))
    eq_y = fe.is_zero(fe.sub(fe.mul(acc8[1], r8[2]), fe.mul(r8[1], acc8[2])))
    valid = eq_x & eq_y & (ok != 0).all(dim=0, keepdim=True)
    valid = valid & (sok != 0).all(dim=0, keepdim=True)
    return valid.to(torch.int32)


# -- kernel wrappers ----------------------------------------------------------


def check_lanes(g: int) -> None:
    """Reject a lane count plan_bucket would not give: a multiple of
    BLOCK_LANES, or a power of two below it. The CUDA grid is
    ceil(g / threads) with the tail masked, but a g from elsewhere means
    a caller sized its batch without plan_bucket."""
    bad = g < 1 or (g % BLOCK_LANES if g >= BLOCK_LANES else g & (g - 1))
    if bad:
        raise ValueError(
            f"lane count {g} is not one plan_bucket gives "
            "(size buckets via plan_bucket)"
        )


def k1_rlc(a_t, r_t, scal_t):
    """K1 (replaces pallas_rlc._k1_rlc_kernel); see k1_rlc_plain."""
    dev = kernels.device_of(a_t)
    g = a_t.shape[-1]
    check_lanes(g)
    kernels.check_tensor("a_t", a_t, (M * 32, g), torch.uint8, dev)
    kernels.check_tensor("r_t", r_t, (M * 32, g), torch.uint8, dev)
    kernels.check_tensor("scal_t", scal_t, (N_SCAL * 32, g), torch.uint8, dev)
    if dev.type == "cpu":
        return k1_rlc_plain(a_t, r_t, scal_t)
    coords = torch.empty((COORD_ROWS, g), dtype=torch.int32, device=dev)
    ok = torch.empty((2 * M, g), dtype=torch.int32, device=dev)
    dig = torch.empty((DIG_ROWS, g), dtype=torch.int32, device=dev)
    kernels.launch("k1_rlc", a_t, r_t, scal_t, coords, ok, dig, g)
    return coords, ok, dig


def k1_rlc_cached(ctbl, oktbl, idx, r_rows, scal_rows):
    """K1 for a warm epoch (replaces pallas_rlc._k1_rlc_kernel_cached);
    see k1_rlc_cached_plain."""
    dev = kernels.device_of(idx)
    g = scal_rows.shape[0]
    check_lanes(g)
    vp = ctbl.shape[-1]
    kernels.check_tensor("ctbl", ctbl, (epoch_cache.TABLE_ROWS, vp), torch.int32, dev)
    kernels.check_tensor("oktbl", oktbl, (1, vp), torch.int32, dev)
    kernels.check_tensor("idx", idx, (g * M,), torch.int32, dev)
    kernels.check_tensor("r_rows", r_rows, (g * M, 32), torch.uint8, dev)
    kernels.check_tensor("scal_rows", scal_rows, (g, N_SCAL, 32), torch.uint8, dev)
    if dev.type == "cpu":
        return k1_rlc_cached_plain(ctbl, oktbl, idx, r_rows, scal_rows)
    coords = torch.empty((COORD_ROWS, g), dtype=torch.int32, device=dev)
    ok = torch.empty((2 * M, g), dtype=torch.int32, device=dev)
    dig = torch.empty((DIG_ROWS, g), dtype=torch.int32, device=dev)
    kernels.launch("k1_rlc_cached", ctbl, oktbl, idx, r_rows, scal_rows,
                   coords, ok, dig, g, vp)
    return coords, ok, dig


def k2_rlc(coords):
    """K2 (replaces pallas_rlc._k2_rlc_kernel); see k2_rlc_plain."""
    dev = kernels.device_of(coords)
    g = coords.shape[-1]
    check_lanes(g)
    kernels.check_tensor("coords", coords, (COORD_ROWS, g), torch.int32, dev)
    if dev.type == "cpu":
        return k2_rlc_plain(coords)
    tbl = torch.empty((TBL_ROWS, g), dtype=torch.int32, device=dev)
    kernels.launch("k2_rlc", coords, tbl, g)
    return tbl


def k3_rlc(tbl, dig, coords, ok, sok):
    """K3 (replaces pallas_rlc._k3_rlc_kernel); see k3_rlc_plain."""
    dev = kernels.device_of(sok)
    g = sok.shape[-1]
    check_lanes(g)
    kernels.check_tensor("tbl", tbl, (TBL_ROWS, g), torch.int32, dev)
    kernels.check_tensor("dig", dig, (DIG_ROWS, g), torch.int32, dev)
    kernels.check_tensor("coords", coords, (COORD_ROWS, g), torch.int32, dev)
    kernels.check_tensor("ok", ok, (2 * M, g), torch.int32, dev)
    kernels.check_tensor("sok", sok, (M, g), torch.int32, dev)
    if dev.type == "cpu":
        return k3_rlc_plain(tbl, dig, coords, ok, sok)
    out = torch.empty((1, g), dtype=torch.int32, device=dev)
    kernels.launch("k3_rlc", tbl, dig, coords, ok, sok, out, g)
    return out


# -- bucketing and host prep --------------------------------------------------


def plan_bucket(n: int) -> tuple:
    """(bucket_sigs, g_lanes) covering n signatures: buckets quantize to
    RLC_BUCKETS, with power-of-two lane counts up to BLOCK_LANES; every
    lane count is one check_lanes accepts."""
    lanes = max((n + M - 1) // M, 1)
    if lanes <= BLOCK_LANES:
        g = 1 << (lanes - 1).bit_length()
        return g * M, g
    for b in RLC_BUCKETS:
        if n <= b:
            return b, b // M
    return RLC_BUCKETS[-1], RLC_BUCKETS[-1] // M


def _rlc_scalars_py(s_enc: bytes, k_enc: bytes, z_enc: bytes, m: int) -> bytes:
    """Lane scalars S (g x 32 B) then U (g*m x 32 B), little-endian: the
    oracle of host.ed25519_rlc_prep's scalars."""
    L = _edwards.L
    n = len(s_enc) // 32
    S = bytearray()
    U = bytearray()
    for lane in range(n // m):
        b = lane * m
        s0 = int.from_bytes(s_enc[32 * b : 32 * b + 32], "little") % L
        U += k_enc[32 * b : 32 * b + 32]
        for j in range(1, m):
            i = b + j
            z = int.from_bytes(z_enc[32 * i : 32 * i + 32], "little")
            s = int.from_bytes(s_enc[32 * i : 32 * i + 32], "little")
            k = int.from_bytes(k_enc[32 * i : 32 * i + 32], "little")
            s0 = (s0 + z * s) % L
            U += ((z * k) % L).to_bytes(32, "little")
        S += s0.to_bytes(32, "little")
    return bytes(S) + bytes(U)


def _gen_z(n: int) -> np.ndarray:
    """(n, 32) uint8 coefficients: 128 random bits from os.urandom, top
    16 bytes zero. There is no seed: predictable coefficients would let
    an attacker pick them and void the 2^-125 bound."""
    z = np.zeros((n, 32), dtype=np.uint8)
    z[:, :16] = np.frombuffer(os.urandom(16 * n), dtype=np.uint8).reshape(n, 16)
    return z


def _rlc_host_scalars(entries, live: int, g_live: int, z: np.ndarray):
    """Pack the live rows; the challenges k = SHA-512(R||A||M) mod L, the
    s < L flags and the lane scalars in one call of the host library
    (host.ed25519_rlc_prep). Returns (pub (live, 32), r_enc (live, 32),
    scal (g_live, N_SCAL, 32), s_ok (live,) bool)."""
    from .backend import _pack_rows

    pub, r_enc, _s_enc = _pack_rows(entries, live)
    buf, offs = entries.msgs_contiguous()
    _k, S, U, s_ok = host.ed25519_rlc_prep(
        np.ascontiguousarray(entries.pub), np.ascontiguousarray(entries.sig), buf,
        np.ascontiguousarray(offs, dtype=np.int64), z, M, live)
    scal = np.zeros((g_live, N_SCAL, 32), dtype=np.uint8)
    scal[:, 0] = S
    scal[:, 1 : M + 1] = U.reshape(g_live, M, 32)
    scal[:, M + 1 :] = z.reshape(g_live, M, 32)[:, 1:]
    return pub, r_enc, scal, s_ok


def _lanes_and_z(entries, bucket: int, z):
    """(g, g_live, live, z[:live]) of a batch padded to `bucket`; z is
    drawn here unless a test passes it."""
    n = len(entries)
    if bucket % M or n > bucket:
        raise ValueError(f"bucket {bucket} must be a multiple of M={M} and >= {n}")
    g = bucket // M
    g_live = min((n + M - 1) // M, g)
    live = g_live * M
    if z is None:
        return g, g_live, live, _gen_z(live)
    if z.dtype != np.uint8 or z.shape != (bucket, 32):
        raise ValueError(f"z must be ({bucket}, 32) uint8")
    if z[:, 16:].any():
        # the ladder skips z digits above bit 128
        raise ValueError("z coefficients must be below 2^128")
    return g, g_live, live, z[:live]


def prepare_rlc(entries, bucket: int, z: np.ndarray = None):
    """EntryBlock -> (a_t (M*32, g) u8, r_t (M*32, g) u8, scal_t
    (N_SCAL*32, g) u8, sok_t (M, g) int32), padded to `bucket`
    signatures (g = bucket // M lanes). Padding lanes: A = R = the
    identity encoding (byte 0 = 1), zero scalars, s_ok = 1.

    z: (bucket, 32) uint8 coefficients for tests only; the verify path
    never passes it and draws fresh ones from os.urandom."""
    g, g_live, live, z = _lanes_and_z(entries, bucket, z)
    pub, r_enc, scal, s_ok = _rlc_host_scalars(entries, live, g_live, z)

    def slotmajor(arr):  # (live, 32) -> (M*32, g_live)
        return arr.reshape(g_live, M, 32).transpose(1, 2, 0).reshape(M * 32, g_live)

    a_t = np.zeros((M * 32, g), dtype=np.uint8)
    r_t = np.zeros((M * 32, g), dtype=np.uint8)
    scal_t = np.zeros((N_SCAL * 32, g), dtype=np.uint8)
    sok_t = np.ones((M, g), dtype=np.int32)
    a_t[np.arange(M) * 32, g_live:] = 1
    r_t[np.arange(M) * 32, g_live:] = 1
    if g_live:
        a_t[:, :g_live] = slotmajor(pub)
        r_t[:, :g_live] = slotmajor(r_enc)
        scal_t[:, :g_live] = scal.transpose(1, 2, 0).reshape(N_SCAL * 32, g_live)
        sok_t[:, :g_live] = s_ok.reshape(g_live, M).T
    return a_t, r_t, scal_t, sok_t


def prepare_rlc_cached(entries, bucket: int, ep, z: np.ndarray = None):
    """Warm-epoch prep (pallas_rlc.prepare_rlc_cached): the host scalar
    stage of prepare_rlc, but the committee ships as table columns
    (entries.val_idx) and every per-signature array ships row-major;
    k1_rlc_cached reads them in place. Padding signatures take column
    vp - 1 (the identity), padding lanes the identity R, zero scalars
    and s_ok = 1.

    Returns (idx (bucket,) int32, r_rows (bucket, 32) uint8, scal_rows
    (g, N_SCAL, 32) uint8, sok_rows (g, M) int32)."""
    g, g_live, live, z = _lanes_and_z(entries, bucket, z)
    idx = epoch_cache.table_columns(entries, bucket, ep)
    _pub, r_enc, scal, s_ok = _rlc_host_scalars(entries, live, g_live, z)
    r_rows = np.zeros((bucket, 32), dtype=np.uint8)
    r_rows[:live] = r_enc
    r_rows[live:, 0] = 1
    scal_rows = np.zeros((g, N_SCAL, 32), dtype=np.uint8)
    scal_rows[:g_live] = scal
    sok_rows = np.ones((g, M), dtype=np.int32)
    sok_rows[:g_live] = s_ok.reshape(g_live, M)
    return idx, r_rows, scal_rows, sok_rows


def expand_lanes(lane_valid: np.ndarray, entries) -> np.ndarray:
    """Lane verdicts -> per-signature verdicts. A valid lane accepts its
    M signatures; a rejected lane's live signatures are re-verified one
    by one on the host (the reference's blame asymmetry,
    types/validation.go:242-248)."""
    from ..crypto import ed25519 as _ed25519

    n = len(entries)
    per_sig = np.repeat(lane_valid, M)[:n].copy()
    for lane in np.nonzero(~lane_valid)[0]:
        for i in range(lane * M, min((lane + 1) * M, n)):
            per_sig[i] = _ed25519.verify_zip215(*entries.entry(i))
    return per_sig


class RlcBatch:
    """One prepared RLC batch of at most MAX_SIGS signatures: the host
    arrays to copy to the device (`args`, in launch order), its bucket,
    and the epoch entry of a warm set (None when cold)."""

    __slots__ = ("entries", "bucket", "ep", "args")

    def __init__(self, entries, bucket: int, ep, args: tuple):
        self.entries = entries
        self.bucket = bucket
        self.ep = ep
        self.args = args

    def launch(self, dev_args) -> torch.Tensor:
        return launch_batch(self, dev_args)

    def conclude(self, row: np.ndarray) -> np.ndarray:
        return conclude_batch(self, row)


def prepare_batch(entries) -> RlcBatch:
    """The host stage (numpy and the host library only; touches no
    CUDA): a block of a warm epoch (ops/epoch_cache.lookup finds its
    table) gets prepare_rlc_cached's arrays, any other block, or an
    evicted epoch, prepare_rlc's."""
    if len(entries) > MAX_SIGS:
        raise ValueError(f"an RLC batch holds at most {MAX_SIGS} signatures")
    ep = epoch_cache.lookup(entries)
    bucket, _ = plan_bucket(len(entries))
    with record_function("rlc.prep"):
        if ep is None:
            args = prepare_rlc(entries, bucket)
        else:
            idx, r_rows, scal_rows, sok_rows = prepare_rlc_cached(entries, bucket, ep)
            args = (idx, r_rows, scal_rows, np.ascontiguousarray(sok_rows.T))
    return RlcBatch(entries, bucket, ep, args)


def launch_batch(batch: RlcBatch, dev_args) -> torch.Tensor:
    """The device stage: batch.args as tensors on one device -> the (1, g)
    int32 lane verdicts there, launched on the current stream. A warm
    batch builds its epoch's table on first use on that device."""
    if batch.ep is not None:
        with record_function("rlc.gather"):  # builds the table once
            tables = batch.ep.coords_tables(dev_args[0].device)
    with record_function("rlc.kernels"):
        if batch.ep is None:
            coords, ok, dig = k1_rlc(*dev_args[:3])
        else:
            coords, ok, dig = k1_rlc_cached(*tables, *dev_args[:3])
        tbl = k2_rlc(coords)
        return k3_rlc(tbl, dig, coords, ok, dev_args[3])


def conclude_batch(batch: RlcBatch, row: np.ndarray) -> np.ndarray:
    """The verdict stage: the (1, g) lane verdicts read back to the host
    -> (n,) bool per-signature verdicts (expand_lanes)."""
    with record_function("rlc.expand"):
        return expand_lanes(np.asarray(row)[0].astype(bool), batch.entries)


def verify_batch_rlc(entries, *, device) -> np.ndarray:
    """EntryBlock of any size -> (n,) bool per-signature ZIP-215 verdicts,
    synchronously, in chunks of at most MAX_SIGS signatures, the kernels
    on `device`: prepare_batch, the copy, launch_batch, the readback,
    conclude_batch (the stages ops/pipeline.py runs on its threads)."""
    out = []
    for i in range(0, len(entries), MAX_SIGS):
        batch = prepare_batch(entries[i : i + MAX_SIGS])
        with record_function("rlc.h2d"):
            dev_args = [torch.from_numpy(a).to(device) for a in batch.args]
        lanes = launch_batch(batch, dev_args)
        with record_function("rlc.d2h"):  # waits for the kernels
            row = lanes.cpu().numpy()
        out.append(conclude_batch(batch, row))
    return np.concatenate(out) if out else np.zeros((0,), dtype=bool)
