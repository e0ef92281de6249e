"""Batched secp256k1 ECDSA verification: one Strauss+GLV ladder a signature.

Counterpart: tendermint_tpu/ops/secp_verify.py (verify_kernel :139,
verify_kernel_cached :205, XLA on the TPU), whose kernels csrc/
secp256k1.cu replaces with two hand-written CUDA kernels (secp_verify,
secp_verify_cached). Each signature's point equation

    R' = (e/s) G + (r/s) Q,   accept iff x(R') = r (mod n)

is checked on its own, with the verdicts of
crypto.secp256k1.PubKey.verify_signature (the lower-S and range checks
on the host, as the reference's). The host splits u1 = e/s and u2 = r/s
by the GLV endomorphism (ops/sc_secp.py), so the ladder is a joint
4-scalar Strauss ladder of 130 iterations, each a doubling and an
addition of one entry of a 16-entry table of subset sums of
{+-G, +-phi(G), +-Q, +-phi(Q)} (entry b1 + 2 b2 + 4 b3 + 8 b4).
Points are projective on the complete Renes-Costello-Batina formulas
(a = 0, b3 = 21: point_add, point_double), so the identity, equal and
opposite points need no branch and a row of zero scalars walks to the
identity. The test is projective: X = r Z or X = (r + n) Z (the second
candidate covers x(R') >= n; the host gives r again where r + n >= p),
Z != 0, ANDed with the host's flags.

    secp_verify         Q from the batch's own rows (qx, qy)
    secp_verify_cached  Q from the validator set's decompressed table
                        (ops/epoch_cache.py EpochEntry.secp_tables),
                        gathered at each signature's val_idx; the row's
                        verdict is ANDed with the table's flag

Arrays (B signatures; words are 32-bit, little-endian, canonical):
qx, qy, r1, r2 (B, 8) int32; scalars (B, 4, 5) int32, the magnitudes of
(u1_a, u1_b, u2_a, u2_b) for the bases (G, phi G, Q, phi Q); signs
(B, 4) int32, 1 negates that base; ok_host (B,) bool; verdicts (B,)
bool. The cached kernel's tables: qx_tbl, qy_tbl (V, 8) int32, q_ok_tbl
(V,) bool, val_idx (B,) int32 (an index outside the table rejects its
row). Asked for, both also give the ladder's final (X, Y, Z), canonical,
(B, 3, 8) int32: the card check compares them word for word.

Padding rows (u1 = 1, u2 = 0, Q = G, candidate Gx) verify; rows the host
rejects keep the padding numbers with ok_host False.

A wrapper runs the plain version (verify_plain, verify_cached_plain:
PyTorch over ops/fe_secp.py) for CPU tensors and launches its kernel
for CUDA tensors, counting launches in kernels.LAUNCHES. A batch runs in
three stages the synchronous verify_batch_secp and the dispatcher
(ops/pipeline.py) share: prepare_batch (host only: SHA-256, the batched
inversion, the GLV split, decompression or table rows; span secp.prep),
launch_batch (secp.gather, secp.kernels) and conclude_batch. There is
no blame pass: verdicts are per signature.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch
from torch.profiler import record_function

from ..crypto import _weierstrass as wst
from . import fe_secp as fe
from . import kernels
from . import sc_secp as sc

N = sc.N
N_HALF = sc.N_HALF
P = fe.P
NW = fe.NWORDS
SCALAR_BITS = sc.SCALAR_BITS
SCALAR_WORDS = sc.SCALAR_WORDS
B3 = 21  # 3 b for y^2 = x^3 + 7

PHI_GX = sc.BETA * wst.GX % P
# phi acts as [lambda]: phi(G) = (beta Gx, Gy) = lambda G
assert wst.scalar_mult(sc.LAMBDA, wst.G) == (PHI_GX, wst.GY)

# the batch sizes a secp256k1 batch pads to (backend.SECP_BUCKETS): the
# ladder's time is linear in the rows, padding included, so a small
# commit gets a small bucket
BUCKETS = (16, 128, 1024, 10240)


def bucket_for(n: int) -> int:
    """The bucket of a batch of n (the reference's
    backend._secp_bucket_for); a batch above the last bucket is split by
    the caller."""
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


# -- plain versions -----------------------------------------------------------


def point_add(p, q):
    """Complete projective addition, a = 0 (RCB16 Algorithm 7, b3 = 21):
    12 multiplies and 3 small-constant ones, valid for all inputs."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = fe.mul(x1, x2)
    t1 = fe.mul(y1, y2)
    t2 = fe.mul(z1, z2)
    t3 = fe.sub(fe.mul(fe.add(x1, y1), fe.add(x2, y2)), fe.add(t0, t1))
    t4 = fe.sub(fe.mul(fe.add(y1, z1), fe.add(y2, z2)), fe.add(t1, t2))
    t5 = fe.sub(fe.mul(fe.add(x1, z1), fe.add(x2, z2)), fe.add(t0, t2))
    t0_3 = fe.mul_small(t0, 3)  # 3 X1 X2
    t2_b = fe.mul_small(t2, B3)  # 3b Z1 Z2
    zs = fe.add(t1, t2_b)  # Y1 Y2 + 3b Z1 Z2
    t1m = fe.sub(t1, t2_b)  # Y1 Y2 - 3b Z1 Z2
    t5_b = fe.mul_small(t5, B3)  # 3b (X1 Z2 + X2 Z1)
    x3 = fe.sub(fe.mul(t3, t1m), fe.mul(t4, t5_b))
    y3 = fe.add(fe.mul(t1m, zs), fe.mul(t5_b, t0_3))
    z3 = fe.add(fe.mul(zs, t4), fe.mul(t0_3, t3))
    return x3, y3, z3


def point_double(p):
    """Complete projective doubling, a = 0 (RCB16 Algorithm 9): 2
    squarings and 6 multiplies."""
    x, y, z = p
    t0 = fe.sq(y)
    y8 = fe.mul_small(t0, 8)  # 8 Y^2
    t2 = fe.mul_small(fe.sq(z), B3)  # 3b Z^2
    x3 = fe.mul(t2, y8)  # 24b Y^2 Z^2
    y3 = fe.add(t0, t2)  # Y^2 + 3b Z^2
    z3 = fe.mul(fe.mul(y, z), y8)  # 8 Y^3 Z
    t0m = fe.sub(t0, fe.mul_small(t2, 3))  # Y^2 - 9b Z^2
    y3 = fe.add(x3, fe.mul(t0m, y3))
    x3 = fe.mul_small(fe.mul(t0m, fe.mul(x, y)), 2)
    return x3, y3, z3


def scalar_digits(scalars: torch.Tensor) -> torch.Tensor:
    """(B, 4, 5) int32 scalar words -> (B, 130) int64 joint table
    indices, bit b of the four scalars at column b: b1 + 2 b2 + 4 b3 +
    8 b4."""
    shifts = torch.arange(32, device=scalars.device)
    words = scalars.to(torch.int64) & 0xFFFFFFFF
    bits = ((words.unsqueeze(-1) >> shifts) & 1).reshape(scalars.shape[0], 4, 32 * SCALAR_WORDS)
    bits = bits[..., :SCALAR_BITS]
    return bits[:, 0] + 2 * bits[:, 1] + 4 * bits[:, 2] + 8 * bits[:, 3]


def table_plain(qx, qy, signs):
    """The 16-entry subset-sum table of each row: (X, Y, Z), each (B, 16,
    16) limbs; entry b1 + 2 b2 + 4 b3 + 8 b4 is the sum of the bases
    whose bit is set, the bases' signs applied."""
    b = qx.shape[0]
    dev = qx.device
    one = fe.const(1, dev).expand(b, fe.NLIMBS)
    zero = torch.zeros_like(one)
    gy = fe.const(wst.GY, dev).expand(b, fe.NLIMBS)
    neg = signs.to(torch.bool).unsqueeze(-1)

    def pick(col, y):
        return torch.where(neg[:, col], fe.neg(y), y)

    b1 = (fe.const(wst.GX, dev).expand(b, fe.NLIMBS), pick(0, gy), one)
    b2 = (fe.const(PHI_GX, dev).expand(b, fe.NLIMBS), pick(1, gy), one)
    b3 = (qx, pick(2, qy), one)
    b4 = (fe.mul(qx, fe.const(sc.BETA, dev)), pick(3, qy), one)
    t3 = point_add(b1, b2)
    t5 = point_add(b3, b1)
    t6 = point_add(b3, b2)
    t7 = point_add(t3, b3)
    low = [(zero, one, zero), b1, b2, t3, b3, t5, t6, t7]
    entries = low + [b4] + [point_add(e, b4) for e in low[1:]]
    return tuple(torch.stack([e[c] for e in entries], dim=1) for c in range(3))


def ladder_plain(qx, qy, scalars, signs):
    """The joint ladder over table_plain: 130 iterations, bit 129 down to
    0, of a doubling and the addition of entry digit. Returns the
    accumulator (X, Y, Z), reduced limbs."""
    table = table_plain(qx, qy, signs)
    digits = scalar_digits(scalars)
    b = qx.shape[0]
    one = fe.const(1, qx.device).expand(b, fe.NLIMBS)
    acc = (torch.zeros_like(one), one, torch.zeros_like(one))
    for i in range(SCALAR_BITS - 1, -1, -1):
        idx = digits[:, i].reshape(b, 1, 1).expand(b, 1, fe.NLIMBS)
        ent = tuple(t.gather(1, idx).squeeze(1) for t in table)
        acc = point_add(point_double(acc), ent)
    return acc


def verify_plain(qx, qy, scalars, signs, r1, r2, ok_host, want_xyz: bool = False):
    """The uncached kernel's function (see the module docstring): (B,)
    bool verdicts, and with want_xyz the canonical final (X, Y, Z) as
    (B, 3, 8) int32 words."""
    x, y, z = ladder_plain(fe.from_words(qx), fe.from_words(qy), scalars, signs)
    nz = ~fe.is_zero(z)
    ok_x = (fe.is_zero(fe.sub(x, fe.mul(fe.from_words(r1), z)))
            | fe.is_zero(fe.sub(x, fe.mul(fe.from_words(r2), z))))
    out = ok_host & nz & ok_x
    if not want_xyz:
        return out
    return out, torch.stack([fe.to_words(fe.canon(c)) for c in (x, y, z)], dim=1)


def verify_cached_plain(qx_tbl, qy_tbl, q_ok_tbl, val_idx, scalars, signs, r1, r2, ok_host,
                        want_xyz: bool = False):
    """verify_plain with Q gathered from the set's table at val_idx and the
    verdict ANDed with the table's flag; an index outside the table
    gathers the last row and rejects."""
    v = qx_tbl.shape[0]
    idx = val_idx.to(torch.int64)
    bad = (idx < 0) | (idx >= v)
    idx = torch.where(bad, v - 1, idx)
    ok = ok_host & q_ok_tbl[idx] & ~bad
    return verify_plain(qx_tbl[idx], qy_tbl[idx], scalars, signs, r1, r2, ok, want_xyz)


# -- kernel wrappers ----------------------------------------------------------


def _check_rows(dev, b, scalars, signs, r1, r2, ok_host) -> None:
    kernels.check_tensor("scalars", scalars, (b, 4, SCALAR_WORDS), torch.int32, dev)
    kernels.check_tensor("signs", signs, (b, 4), torch.int32, dev)
    kernels.check_tensor("r1", r1, (b, NW), torch.int32, dev)
    kernels.check_tensor("r2", r2, (b, NW), torch.int32, dev)
    kernels.check_tensor("ok_host", ok_host, (b,), torch.bool, dev)


def secp_verify(qx, qy, scalars, signs, r1, r2, ok_host, want_xyz: bool = False):
    """The uncached kernel (csrc/secp256k1.cu secp_verify_kernel,
    replacing secp_verify.verify_kernel); see verify_plain."""
    dev = kernels.device_of(qx)
    b = qx.shape[0]
    kernels.check_tensor("qx", qx, (b, NW), torch.int32, dev)
    kernels.check_tensor("qy", qy, (b, NW), torch.int32, dev)
    _check_rows(dev, b, scalars, signs, r1, r2, ok_host)
    if dev.type == "cpu":
        return verify_plain(qx, qy, scalars, signs, r1, r2, ok_host, want_xyz)
    out = torch.empty((b,), dtype=torch.bool, device=dev)
    xyz = torch.empty((b, 3, NW), dtype=torch.int32, device=dev) if want_xyz else None
    kernels.launch("secp_verify", qx, qy, scalars, signs, r1, r2, ok_host, out, xyz, b)
    return (out, xyz) if want_xyz else out


def secp_verify_cached(qx_tbl, qy_tbl, q_ok_tbl, val_idx, scalars, signs, r1, r2, ok_host,
                       want_xyz: bool = False):
    """The cached kernel (csrc/secp256k1.cu secp_verify_cached_kernel,
    replacing secp_verify.verify_kernel_cached); see
    verify_cached_plain."""
    dev = kernels.device_of(val_idx)
    b = val_idx.shape[0]
    v = qx_tbl.shape[0]
    if v < 1:
        raise ValueError("a secp256k1 table has at least one row")
    kernels.check_tensor("qx_tbl", qx_tbl, (v, NW), torch.int32, dev)
    kernels.check_tensor("qy_tbl", qy_tbl, (v, NW), torch.int32, dev)
    kernels.check_tensor("q_ok_tbl", q_ok_tbl, (v,), torch.bool, dev)
    kernels.check_tensor("val_idx", val_idx, (b,), torch.int32, dev)
    _check_rows(dev, b, scalars, signs, r1, r2, ok_host)
    if dev.type == "cpu":
        return verify_cached_plain(qx_tbl, qy_tbl, q_ok_tbl, val_idx, scalars, signs, r1, r2,
                                   ok_host, want_xyz)
    out = torch.empty((b,), dtype=torch.bool, device=dev)
    xyz = torch.empty((b, 3, NW), dtype=torch.int32, device=dev) if want_xyz else None
    kernels.launch("secp_verify_cached", qx_tbl, qy_tbl, q_ok_tbl, val_idx, scalars, signs,
                   r1, r2, ok_host, out, xyz, b, v)
    return (out, xyz) if want_xyz else out


# -- host prep -----------------------------------------------------------------


@functools.lru_cache(maxsize=65536)
def _decompress_memo(pub: bytes):
    return wst.decompress(pub)


def field_to_limbs(vals) -> np.ndarray:
    """Ints below 2^256 -> (len(vals), 8) int32 rows of 32-bit words,
    least significant first (the kernels' field rows)."""
    if not len(vals):
        return np.zeros((0, NW), dtype=np.int32)
    buf = b"".join(int(v).to_bytes(4 * NW, "little") for v in vals)
    return np.frombuffer(buf, dtype="<i4").reshape(len(vals), NW).copy()


_GX_W = field_to_limbs([wst.GX])[0]
_GY_W = field_to_limbs([wst.GY])[0]


def table_columns(pubs):
    """A set's 33-byte keys -> its table: (qx, qy (V+1, 8) int32, q_ok
    (V+1,) bool). A key that does not decompress gets G and q_ok False;
    row V is the padding row, (G, True)."""
    xs, ys, oks = [], [], []
    for pub in pubs:
        pt = _decompress_memo(bytes(pub)) if len(pub) == 33 else None
        xs.append(wst.GX if pt is None else pt[0])
        ys.append(wst.GY if pt is None else pt[1])
        oks.append(pt is not None)
    xs.append(wst.GX)
    ys.append(wst.GY)
    oks.append(True)
    return field_to_limbs(xs), field_to_limbs(ys), np.array(oks, dtype=bool)


# A padding row verifies: u1 = 1, u2 = 0, Q = G, candidate Gx, so the
# ladder gives R' = G and the test holds.
_PAD_SCALARS = np.zeros((4, SCALAR_WORDS), dtype=np.int32)
_PAD_SCALARS[0, 0] = 1


def _empty_rows(size: int):
    qx = np.broadcast_to(_GX_W, (size, NW)).copy()
    qy = np.broadcast_to(_GY_W, (size, NW)).copy()
    scalars = np.broadcast_to(_PAD_SCALARS, (size, 4, SCALAR_WORDS)).copy()
    signs = np.zeros((size, 4), dtype=np.int32)
    r1 = qx.copy()
    r2 = qx.copy()
    ok = np.ones(size, dtype=bool)
    return qx, qy, scalars, signs, r1, r2, ok


def _scalar_rows(items, size: int, decompress: bool):
    """The per-signature host work both preps share: length, range and
    lower-S checks, SHA-256, one batched inversion of s, the GLV split of
    u1 and u2, and (decompress) the key. Returns _empty_rows(size) with
    the accepted rows filled in, and the decompressed keys by row."""
    qx, qy, scalars, signs, r1, r2, ok = _empty_rows(size)
    pend, svals, keys = [], [], {}
    for i, (pub, msg, sig) in enumerate(items):
        ok[i] = False
        if len(sig) != 64:
            continue
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if r <= 0 or s <= 0 or r >= N or s > N_HALF:
            continue
        if decompress:
            q = _decompress_memo(bytes(pub)) if len(pub) == 33 else None
            if q is None:
                continue
            keys[i] = q
        e = int.from_bytes(hashlib.sha256(bytes(msg)).digest(), "big")
        pend.append((i, r, e))
        svals.append(s)
    winv = sc.inv_mod_n_many(svals)
    sc_rows, r1_i, r2_i, rows = [], [], [], []
    for (i, r, e), w in zip(pend, winv):
        m1, s1, m2, s2 = sc.glv_decompose(e * w % N)
        m3, s3, m4, s4 = sc.glv_decompose(r * w % N)
        signs[i] = (s1, s2, s3, s4)
        sc_rows.extend((m1, m2, m3, m4))
        r1_i.append(r)
        r2_i.append(r + N if r + N < P else r)
        rows.append(i)
        ok[i] = True
    if rows:
        idx = np.asarray(rows)
        scalars[idx] = sc.scalars_to_limbs(sc_rows).reshape(len(rows), 4, SCALAR_WORDS)
        r1[idx] = field_to_limbs(r1_i)
        r2[idx] = field_to_limbs(r2_i)
        if decompress:
            qx[idx] = field_to_limbs([keys[i][0] for i in rows])
            qy[idx] = field_to_limbs([keys[i][1] for i in rows])
    return (qx, qy, scalars, signs, r1, r2, ok)


def prepare_rows(items, size: int = None):
    """(pub33, msg, sig64) items -> the uncached kernel's arrays (qx, qy,
    scalars, signs, r1, r2, ok_host) of `size` rows (default len(items)):
    rows past the items pad; a row the host rejects (signature length,
    r or s out of range, not lower-S, a key that does not decompress)
    keeps the padding numbers with ok_host False."""
    n = len(items)
    size = n if size is None else size
    if n > size:
        raise ValueError(f"{n} signatures do not fit {size} rows")
    return _scalar_rows(items, size, True)


def prepare_rows_cached(items, val_idx, size: int, pad_idx: int, n_vals: int = None):
    """The cached kernel's per-batch arrays (val_idx (size,) int32,
    scalars, signs, r1, r2, ok_host): no decompression, the keys come
    from the set's table at each row's val_idx; rows past the items
    gather pad_idx, the table's padding row. A key that did not
    decompress is rejected by the table's flag. val_idx outside
    [0, n_vals) is refused (default n_vals: pad_idx)."""
    n = len(items)
    if n > size:
        raise ValueError(f"{n} signatures do not fit {size} rows")
    idx_col = np.full(size, pad_idx, dtype=np.int32)
    if n:
        vidx = np.asarray(val_idx, dtype=np.int64)[:n]
        limit = pad_idx if n_vals is None else n_vals
        if int(vidx.min()) < 0 or int(vidx.max()) >= limit:
            raise ValueError(f"val_idx outside the set's {limit} validators")
        idx_col[:n] = vidx
    _, _, scalars, signs, r1, r2, ok = _scalar_rows(items, size, False)
    return idx_col, scalars, signs, r1, r2, ok


# -- the batch path ------------------------------------------------------------


class SecpBatch:
    """One prepared secp256k1 batch of at most BUCKETS[-1] signatures: the
    host arrays to copy (`args`, in launch order), its bucket, and the
    epoch entry of a warm set (None when cold)."""

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


def prepare_batch(entries, ep=None, bucket: int = None) -> SecpBatch:
    """The host stage for an EntryBlock of scheme secp256k1 (touches no
    CUDA): with the set's epoch entry `ep`
    (its block carries val_idx), prepare_rows_cached's arrays; without,
    prepare_rows'. Rows pad to `bucket` (default bucket_for(n); the mesh
    dispatcher gives its superbatch's, which may exceed BUCKETS[-1])."""
    n = len(entries)
    if bucket is None:
        if n > BUCKETS[-1]:
            raise ValueError(f"a secp256k1 batch holds at most {BUCKETS[-1]} signatures")
        bucket = bucket_for(n)
    elif n > bucket:
        raise ValueError(f"bucket {bucket} is below the batch's {n} signatures")
    with record_function("secp.prep"):
        items = list(entries.iter_entries())
        if ep is None:
            args = prepare_rows(items, bucket)
        else:
            args = prepare_rows_cached(items, entries.val_idx, bucket, ep.vp - 1, ep.n_vals)
    return SecpBatch(entries, bucket, ep, args)


def launch_batch(batch: SecpBatch, dev_args) -> torch.Tensor:
    """The device stage: batch.args as tensors on one device -> the
    (bucket,) bool verdicts there, launched on the current stream. A warm
    batch uploads its set's table on first use on that device."""
    if batch.ep is None:
        with record_function("secp.kernels"):
            return secp_verify(*dev_args)
    with record_function("secp.gather"):
        tables = batch.ep.secp_tables(dev_args[0].device)
    with record_function("secp.kernels"):
        return secp_verify_cached(*tables, *dev_args)


def conclude_batch(batch: SecpBatch, row: np.ndarray) -> np.ndarray:
    """The (bucket,) verdicts read back -> (n,) bool, padding cut."""
    return np.asarray(row)[: len(batch.entries)].astype(bool)
