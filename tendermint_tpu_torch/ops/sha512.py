"""Batched SHA-512 of R || A || M and the challenge k = SHA-512(R || A ||
M) mod L on the card.

Counterpart: tendermint_tpu/ops/sha512.py (pad_messages, _buf_to_words,
pad_ram_block, _pad_row, pad_ram_rows, digest_to_bytes, sha512_blocks
:174 with _compress_block :109), and with ops/sc.py the reference's
device-hash prologue (ed25519_verify.py:290-330: sha512_blocks, then
sc.digest_to_le_bits, mod_l_from_bits and limbs_to_bits).

The host lays each message into fixed NBLOCK SHA-512 blocks (padding,
the 0x80 terminator and the 128-bit length already in place) as
big-endian 64-bit words split into their high and low 32 bits, with a
block count per message; the padding functions here give arrays byte
for byte equal to the reference's. A padding row carries the identity
pattern R = A = b"\\x01" + 31 zeros and an empty message.

The kernel, sha512_challenge (csrc/sha512.cu), hashes one message a
thread through its n_blocks[i] blocks and reduces the 64-byte digest,
read as a little-endian integer, mod L: (B, 32) uint8 rows of k, the
layout of the host challenges (ops/host.ed25519_challenges_buf), so
both hash routes feed the same verify kernels (ops/ed25519_verify.py).
Its plain version is sha512_blocks_plain then ops/sc.py. The wrapper
runs the plain version for CPU tensors and launches the kernel for CUDA
tensors. The word arrays are uint32 in the padding functions, as the
reference's, and cross to the device as int32 of the same bits
(as_int32): PyTorch's uint32 supports few operations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import commit_prep, kernels, sc
from .commit_prep import ram_nblock

_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
_M32 = 0xFFFFFFFF

# the message's layout on the op-graph path: R || A || M of up to
# RAM_MAX_LEN bytes in NBLOCK blocks
MAX_LEN = commit_prep.RAM_MAX_LEN
NBLOCK = ram_nblock(MAX_LEN)

_PAD_PAIR = b"\x01" + bytes(31) + b"\x01" + bytes(31)


# -- host padding (numpy) -------------------------------------------------------


def _buf_to_words(buf: np.ndarray, bsz: int, nblock: int) -> tuple:
    """(bsz, nblock * 128) uint8 -> big-endian (hi, lo) uint32 words."""
    words = np.ascontiguousarray(buf).view(">u4").reshape(bsz, nblock, 16, 2)
    return words[..., 0].astype(np.uint32), words[..., 1].astype(np.uint32)


def _close(buf: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Terminator and bit length after each row's lens[i] bytes; returns
    the blocks each row uses."""
    rng = np.arange(buf.shape[0])
    blocks = (lens + 17 + 127) // 128
    buf[rng, lens] = 0x80
    bitlen = lens * 8
    base = blocks * 128 - 8
    for j in range(8):
        buf[rng, base + j] = (bitlen >> (8 * (7 - j))) & 0xFF
    return blocks


def pad_messages(msgs, max_len: int) -> tuple:
    """bytes messages -> ((B, nblock, 16) uint32 hi, lo, (B,) int32 block
    counts), nblock = ram_nblock(max_len). A message longer than max_len
    raises ValueError."""
    nblock = ram_nblock(max_len)
    bsz = len(msgs)
    buf = np.zeros((bsz, nblock * 128), dtype=np.uint8)
    lens = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=bsz)
    if bsz and lens.max(initial=0) > max_len:
        raise ValueError(f"message too long: {int(lens.max())} > {max_len}")
    counts = np.zeros((bsz,), dtype=np.int32)
    if bsz:
        offs = np.zeros(bsz + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        commit_prep.scatter_rows_by_length(buf, 0, np.frombuffer(b"".join(msgs), np.uint8),
                                           offs, lens)
        counts = _close(buf, lens).astype(np.int32)
    return _buf_to_words(buf, bsz, nblock) + (counts,)


def pad_ram_block(block, bucket: int, max_len: int) -> tuple:
    """An EntryBlock's R || A || M laid out columnar, padded to `bucket`
    rows: ((bucket, nblock, 16) uint32 hi, lo, (bucket,) int32 counts).
    Padding rows carry the identity pattern. A row longer than max_len
    raises ValueError."""
    nblock = ram_nblock(max_len)
    n = len(block)
    if n > bucket:
        raise ValueError(f"bucket {bucket} is below the batch's {n} signatures")
    lens = np.full(bucket, 64, dtype=np.int64)
    buf = np.zeros((bucket, nblock * 128), dtype=np.uint8)
    if n:
        mbuf, offs = block.msgs_contiguous()
        offs = np.asarray(offs)
        mlens = np.diff(offs)
        lens[:n] = 64 + mlens
        if lens.max() > max_len:
            raise ValueError(f"message too long: {int(lens.max())} > {max_len}")
        buf[:n, :32] = block.sig[:, :32]
        buf[:n, 32:64] = block.pub
        if int(mlens.sum()):
            flat = np.frombuffer(mbuf, dtype=np.uint8, count=int(mlens.sum()))
            commit_prep.scatter_rows_by_length(buf, 64, flat, offs, mlens)
    buf[n:, 0] = 1
    buf[n:, 32] = 1
    blocks = _close(buf, lens)
    return _buf_to_words(buf, bucket, nblock) + (blocks.astype(np.int32),)


_PAD_ROW_CACHE: dict = {}


def _pad_row(max_len: int) -> tuple:
    """The padding row's (1, nblock, 16) words and count, from
    pad_ram_block on an empty block, cached per layout."""
    row = _PAD_ROW_CACHE.get(max_len)
    if row is None:
        from .entry_block import EntryBlock

        row = _PAD_ROW_CACHE[max_len] = pad_ram_block(EntryBlock.from_entries([]), 1, max_len)
    return row


def pad_ram_rows(block, bucket: int, max_len: int) -> Optional[tuple]:
    """pad_ram_block's arrays from the block's RAM columns (built by the
    fused commit prep): its rows copied, the padding rows filled. None
    when the block has no RAM columns of this layout (the caller then
    takes pad_ram_block)."""
    nblock = ram_nblock(max_len)
    n = len(block)
    if block.ram_hi is None or block.ram_hi.shape[1] != nblock * 16:
        return None
    if n > bucket:
        raise ValueError(f"bucket {bucket} is below the batch's {n} signatures")
    hi = np.empty((bucket, nblock, 16), dtype=np.uint32)
    lo = np.empty((bucket, nblock, 16), dtype=np.uint32)
    counts = np.empty((bucket,), dtype=np.int32)
    hi.reshape(bucket, nblock * 16)[:n] = block.ram_hi
    lo.reshape(bucket, nblock * 16)[:n] = block.ram_lo
    counts[:n] = block.ram_counts
    if bucket > n:
        pad_hi, pad_lo, pad_counts = _pad_row(max_len)
        hi[n:] = pad_hi[0]
        lo[n:] = pad_lo[0]
        counts[n:] = pad_counts[0]
    return hi, lo, counts


def ram_words(block, bucket: int) -> tuple:
    """The op-graph path's hash input for an EntryBlock: pad_ram_rows
    where the fused prep built RAM columns, else pad_ram_block, at
    MAX_LEN."""
    ram = pad_ram_rows(block, bucket, MAX_LEN)
    return ram if ram is not None else pad_ram_block(block, bucket, MAX_LEN)


def as_int32(words: np.ndarray) -> np.ndarray:
    """uint32 words as int32 of the same bits (the kernel's input dtype)."""
    return np.ascontiguousarray(words).view(np.int32)


def digest_to_bytes(digest) -> np.ndarray:
    """(B, 8, 2) digest words -> (B, 64) uint8 big-endian digests."""
    d = np.asarray(digest).astype(np.uint64) & np.uint64(_M32)
    be = (d[:, :, 0] << np.uint64(32)) | d[:, :, 1]
    return be.astype(">u8").view(np.uint8).reshape(d.shape[0], 64).copy()


# -- plain version (torch) ------------------------------------------------------


def _add(a, b):
    """(hi, lo) + (hi, lo) mod 2^64, halves in int64 in [0, 2^32)."""
    lo = a[1] + b[1]
    return ((a[0] + b[0] + (lo >> 32)) & _M32, lo & _M32)


def _ror(x, n: int):
    h, l = x
    if n >= 32:
        h, l, n = l, h, n - 32
    if n == 0:
        return h, l
    return (((h >> n) | (l << (32 - n))) & _M32, ((l >> n) | (h << (32 - n))) & _M32)


def _shr(x, n: int):
    h, l = x
    return h >> n, ((l >> n) | (h << (32 - n))) & _M32


def _xor3(a, b, c):
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _compress(state: list, w: list) -> list:
    """One SHA-512 compression of state (8 (hi, lo) pairs) by the block
    w (16 (hi, lo) pairs)."""
    a, b, c, d, e, f, g, h = state
    w = list(w)
    for t in range(80):
        if t >= 16:
            s0 = _xor3(_ror(w[t - 15], 1), _ror(w[t - 15], 8), _shr(w[t - 15], 7))
            s1 = _xor3(_ror(w[t - 2], 19), _ror(w[t - 2], 61), _shr(w[t - 2], 6))
            w.append(_add(_add(_add(w[t - 16], s0), w[t - 7]), s1))
        s1 = _xor3(_ror(e, 14), _ror(e, 18), _ror(e, 41))
        ch = ((e[0] & f[0]) ^ (~e[0] & _M32 & g[0]), (e[1] & f[1]) ^ (~e[1] & _M32 & g[1]))
        k = (_K[t] >> 32, _K[t] & _M32)
        t1 = _add(_add(_add(_add(h, s1), ch), k), w[t])
        s0 = _xor3(_ror(a, 28), _ror(a, 34), _ror(a, 39))
        maj = tuple((a[i] & b[i]) ^ (a[i] & c[i]) ^ (b[i] & c[i]) for i in (0, 1))
        t2 = _add(s0, maj)
        a, b, c, d, e, f, g, h = _add(t1, t2), a, b, c, _add(d, t1), e, f, g
    return [_add(s, v) for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_blocks_plain(blocks_hi: torch.Tensor, blocks_lo: torch.Tensor,
                        n_blocks: torch.Tensor) -> torch.Tensor:
    """(B, NBLOCK, 16) word halves (int32 or uint32 bits), (B,) block
    counts -> (B, 8, 2) int64 digest words in [0, 2^32): the state after
    each message's first n_blocks[i] blocks."""
    hi = blocks_hi.to(torch.int64) & _M32
    lo = blocks_lo.to(torch.int64) & _M32
    bsz, nblock = hi.shape[0], hi.shape[1]
    dev = hi.device
    state = [(torch.full((bsz,), v >> 32, dtype=torch.int64, device=dev),
              torch.full((bsz,), v & _M32, dtype=torch.int64, device=dev)) for v in _IV]
    nb = n_blocks.to(torch.int64)
    for blk in range(nblock):
        new = _compress(state, [(hi[:, blk, j], lo[:, blk, j]) for j in range(16)])
        live = nb > blk
        state = [(torch.where(live, n[0], s[0]), torch.where(live, n[1], s[1]))
                 for n, s in zip(new, state)]
    return torch.stack([torch.stack(s, dim=-1) for s in state], dim=1)


def sha512_challenge_plain(blocks_hi, blocks_lo, n_blocks) -> torch.Tensor:
    """(B, 32) uint8 rows of k = SHA-512 mod L, little-endian: the
    reference's sha512_blocks, digest_to_le_bits, mod_l_from_bits and
    limbs_to_bits, packed into bytes."""
    digest = sha512_blocks_plain(blocks_hi, blocks_lo, n_blocks)
    k = sc.mod_l_from_bits(sc.digest_to_le_bits(digest))
    return sc.bits_to_rows(sc.limbs_to_bits(k, sc.SCALAR_BITS))


# -- kernel wrapper ---------------------------------------------------------------


def sha512_challenge(blocks_hi: torch.Tensor, blocks_lo: torch.Tensor,
                     n_blocks: torch.Tensor) -> torch.Tensor:
    """k = SHA-512(R || A || M) mod L of each padded message (replaces
    sha512.sha512_blocks :174 with sc.digest_to_le_bits, mod_l_from_bits
    and limbs_to_bits): blocks_hi, blocks_lo (B, nblock, 16) int32 word
    bits, n_blocks (B,) int32 in [1, nblock] -> (B, 32) uint8 k rows.
    See sha512_challenge_plain."""
    dev = kernels.device_of(n_blocks)
    bsz = n_blocks.shape[0]
    nblock = blocks_hi.shape[1] if blocks_hi.dim() == 3 else 0
    kernels.check_tensor("blocks_hi", blocks_hi, (bsz, nblock, 16), torch.int32, dev)
    kernels.check_tensor("blocks_lo", blocks_lo, (bsz, nblock, 16), torch.int32, dev)
    kernels.check_tensor("n_blocks", n_blocks, (bsz,), torch.int32, dev)
    if dev.type == "cpu":
        return sha512_challenge_plain(blocks_hi, blocks_lo, n_blocks)
    out = torch.empty((bsz, 32), dtype=torch.uint8, device=dev)
    if bsz:
        kernels.launch("sha512_challenge", blocks_hi, blocks_lo, n_blocks, out, bsz, nblock)
    return out
