"""sr25519 (schnorrkel over ristretto255) verification on the device.

Counterpart: tendermint_tpu/ops/pallas_sr25519.py (prepare_sr25519,
verify_sr25519_compact and its kernels) and the device branch of
ops/mixed._verify_sr25519_batch (mixed.py:157-214). Schnorr
verification

    accept iff A and R decode (ristretto255), s < L and the schnorrkel
    v1 marker bit is set (host flags), and R == [s]B - [k]A

with k the merlin signing-transcript challenge mod L from the host
(csrc/merlin.cpp through ops/host.py). It shares the per-signature
ladder of ops/verify.py; what differs is point decoding (ristretto255
DECODE, not ZIP-215 decompression) and the final test (exact ristretto
equality against R, not the cofactored test). Three kernels run per
batch, each with a CUDA version and a plain PyTorch version:

  K1r  k1r_decode  digits of s and k; ristretto decode of A and R, in
                   K1's output layout (csrc/sr25519.cu)
  K2   verify.k2_table, unchanged (csrc/verify.cu)
  K3r  k3r_ladder  the ladder, then X yR == Y xR or Y yR == X xR, ANDed
                   with the two decode flags and the host flag
                   (csrc/sr25519.cu)

Padding signatures are all-zero encodings (the ristretto identity) with
s = k = 0, and verify. verify_batch_sr25519 marks its stages (prep, h2d,
kernels, d2h) as torch.profiler record_function spans ("sr.*").
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..crypto import sr25519 as _sr25519
from ..crypto._edwards import P
from . import fe, host, kernels, point, verify

COORD_ROWS = verify.COORD_ROWS
DIG_ROWS = verify.DIG_ROWS
TBL_ROWS = verify.TBL_ROWS

_P_BE = np.frombuffer(P.to_bytes(32, "big"), dtype=np.uint8)
_rows = point.slot_rows


# -- plain versions -----------------------------------------------------------


def k1r_decode_plain(a_t, r_t, s_t, k_t, aok_t, rok_t):
    """(32, n) uint8 A, R, s, k bytes and (1, n) int32 host flags of A and
    R -> verify.k1_plain's outputs, A and R by the ristretto decode."""
    ok_host = torch.cat([aok_t, rok_t], dim=1)
    # the sign bit is set only in encodings >= p, which ok_host rejects
    return verify.k1_plain(a_t, r_t, s_t, k_t,
                           lambda y, _sign: point.ristretto_decode(y, ok_host))


def k3r_ladder_plain(tbl, sdig, kdig, coords, ok, sok):
    """tbl (TBL_ROWS, n), sdig, kdig (128, n), coords (COORD_ROWS, n),
    ok (2, n), sok (1, n) -> (1, n) int32 verdicts: the ladder
    acc = [s]B + [k](-A), then acc == R in the ristretto group. R decodes
    with z = 1, so the projective cross-multiplications need no zR."""
    acc = verify.ladder_plain(tbl, sdig, kdig)
    eq = ristretto_eq(acc, coords[_rows(1, 0)], coords[_rows(1, 1)])
    valid = (ok[0:1] != 0) & (ok[1:2] != 0) & (sok[0:1] != 0) & eq
    return valid.to(torch.int32)


def ristretto_eq(acc, rx, ry):
    """acc == R in the ristretto group, for R = (rx, ry) with z = 1:
    X yR == Y xR or Y yR == X xR (bool, like fe.is_zero)."""
    eq1 = fe.is_zero(fe.sub(fe.mul(acc[0], ry), fe.mul(acc[1], rx)))
    eq2 = fe.is_zero(fe.sub(fe.mul(acc[1], ry), fe.mul(acc[0], rx)))
    return eq1 | eq2


# -- kernel wrappers ----------------------------------------------------------


def k1r_decode(a_t, r_t, s_t, k_t, aok_t, rok_t):
    """K1r (replaces pallas_sr25519._k1r_decode_kernel); see
    k1r_decode_plain."""
    dev = kernels.device_of(a_t)
    n = a_t.shape[-1]
    for name, t in (("a_t", a_t), ("r_t", r_t), ("s_t", s_t), ("k_t", k_t)):
        kernels.check_tensor(name, t, (32, n), torch.uint8, dev)
    kernels.check_tensor("aok_t", aok_t, (1, n), torch.int32, dev)
    kernels.check_tensor("rok_t", rok_t, (1, n), torch.int32, dev)
    if dev.type == "cpu":
        return k1r_decode_plain(a_t, r_t, s_t, k_t, aok_t, rok_t)
    coords = torch.empty((COORD_ROWS, n), dtype=torch.int32, device=dev)
    ok = torch.empty((2, n), dtype=torch.int32, device=dev)
    sdig = torch.empty((DIG_ROWS, n), dtype=torch.int32, device=dev)
    kdig = torch.empty((DIG_ROWS, n), dtype=torch.int32, device=dev)
    kernels.launch("k1r_decode", a_t, r_t, s_t, k_t, aok_t, rok_t, coords, ok, sdig, kdig, n)
    return coords, ok, sdig, kdig


def k3r_ladder(tbl, sdig, kdig, coords, ok, sok):
    """K3r (replaces pallas_sr25519._k3r_ladder_kernel); see
    k3r_ladder_plain."""
    dev = kernels.device_of(sok)
    n = sok.shape[-1]
    kernels.check_tensor("tbl", tbl, (TBL_ROWS, n), torch.int32, dev)
    kernels.check_tensor("sdig", sdig, (DIG_ROWS, n), torch.int32, dev)
    kernels.check_tensor("kdig", kdig, (DIG_ROWS, n), torch.int32, dev)
    kernels.check_tensor("coords", coords, (COORD_ROWS, n), torch.int32, dev)
    kernels.check_tensor("ok", ok, (2, n), torch.int32, dev)
    kernels.check_tensor("sok", sok, (1, n), torch.int32, dev)
    if dev.type == "cpu":
        return k3r_ladder_plain(tbl, sdig, kdig, coords, ok, sok)
    out = torch.empty((1, n), dtype=torch.int32, device=dev)
    kernels.launch("k3r_ladder", tbl, sdig, kdig, coords, ok, sok, out, n)
    return out


# -- host prep and the batch path ---------------------------------------------


def _canonical_even(enc: np.ndarray, n: int, bucket: int) -> np.ndarray:
    """(bucket, 32) little-endian encodings -> (bucket,) ristretto
    admission flags: value < p and even (ristretto rejects a negative s).
    Padding rows (the all-zero identity) pass."""
    ok = np.ones((bucket,), dtype=bool)
    if n:
        be = enc[:n, ::-1]
        diff = be != _P_BE
        first = diff.argmax(axis=1)
        below_p = diff.any(axis=1) & (be[np.arange(n), first] < _P_BE[first])
        ok[:n] = below_p & ((enc[:n, 0] & 1) == 0)
    return ok


def prepare_sr25519(entries, bucket: int):
    """EntryBlock -> (a_t, r_t, s_t, k_t (32, bucket) uint8, aok_t, rok_t,
    sok_t (1, bucket) int32), batch-minor (pallas_sr25519.prepare_sr25519).
    Host work: the v1 marker bit (set, then cleared before s < L), the
    canonical-and-even flags of A and R, and the merlin challenges
    (csrc/merlin.cpp) reduced mod L (csrc/host_prep.cpp). Padding
    signatures are all-zero encodings, the ristretto identity (not the
    edwards 0x01), with every flag 1, and verify."""
    from .backend import _s_below_l

    n = len(entries)
    if n > bucket:
        raise ValueError(f"bucket {bucket} is below the batch's {n} signatures")
    sig = np.array(entries.sig, dtype=np.uint8)
    marker_ok = np.ones((bucket,), dtype=bool)
    marker_ok[:n] = (sig[:, 63] & 0x80) != 0  # a missing marker rejects, not raises
    sig[:, 63] &= 0x7F
    pub = np.zeros((bucket, 32), dtype=np.uint8)
    r_enc = np.zeros((bucket, 32), dtype=np.uint8)
    s_enc = np.zeros((bucket, 32), dtype=np.uint8)
    pub[:n] = entries.pub
    r_enc[:n] = sig[:, :32]
    s_enc[:n] = sig[:, 32:]
    s_ok = _s_below_l(s_enc, n, bucket) & marker_ok
    k_enc = np.zeros((bucket, 32), dtype=np.uint8)
    if n:
        k_enc[:n] = host.mod_l_many(host.sr25519_challenges(
            _sr25519.SIGNING_CTX, pub[:n], r_enc[:n], entries.msgs, entries.offsets))

    def flags(ok):
        return np.ascontiguousarray(ok.astype(np.int32)[None, :])

    return (
        np.ascontiguousarray(pub.T),
        np.ascontiguousarray(r_enc.T),
        np.ascontiguousarray(s_enc.T),
        np.ascontiguousarray(k_enc.T),
        flags(_canonical_even(pub, n, bucket)),
        flags(_canonical_even(r_enc, n, bucket)),
        flags(s_ok),
    )


def verify_sr25519_compact(a_t, r_t, s_t, k_t, aok_t, rok_t, sok_t) -> torch.Tensor:
    """K1r, K2, K3r over prepare_sr25519's arrays as tensors on one device;
    returns the (1, n) int32 verdicts there. n is a multiple of
    verify.BLOCK."""
    verify.check_block(a_t.shape[-1])
    coords, ok, sdig, kdig = k1r_decode(a_t, r_t, s_t, k_t, aok_t, rok_t)
    tbl = verify.k2_table(coords)
    return k3r_ladder(tbl, sdig, kdig, coords, ok, sok_t)


def verify_batch_sr25519(entries, *, device) -> np.ndarray:
    """EntryBlock of any size -> (n,) bool schnorrkel verdicts, in chunks
    of at most verify.BUCKETS[-1] signatures, K1r, K2, K3r on `device`."""
    out = []
    for i in range(0, len(entries), verify.BUCKETS[-1]):
        chunk = entries[i : i + verify.BUCKETS[-1]]
        with record_function("sr.prep"):
            args = prepare_sr25519(chunk, verify.bucket_for(len(chunk)))
        with record_function("sr.h2d"):
            tensors = [torch.from_numpy(a).to(device) for a in args]
        with record_function("sr.kernels"):
            res = verify_sr25519_compact(*tensors)
        with record_function("sr.d2h"):  # waits for the kernels
            out.append(res.cpu().numpy()[0, : len(chunk)].astype(bool))
    return np.concatenate(out) if out else np.zeros((0,), dtype=bool)
