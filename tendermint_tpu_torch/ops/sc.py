"""Scalars mod L = 2^252 + 27742317777372353535851937790883648493 —
plain PyTorch.

Counterpart: tendermint_tpu/ops/sc.py (digest_to_le_bits :65,
mod_l_from_bits :38, limbs_to_bits :57). The SHA-512 digest of
R || A || M, read as a little-endian 512-bit integer (RFC 8032), reduced
mod L to the challenge k by the reference's bitwise Horner (acc = 2 acc +
bit, then a conditional subtract of L), 512 steps over the port's 13-bit
limbs (ops/fe.py), batch last. Together with ops/sha512.sha512_blocks_plain
this is the plain version of the sha512_challenge kernel
(csrc/sha512.cu), which reduces by another exact method: both give k
exactly, so they agree byte for byte.
"""

from __future__ import annotations

import torch

from ..crypto._edwards import L
from . import fe

SCALAR_BITS = 253  # k, s < L < 2^253


def digest_to_le_bits(digest: torch.Tensor) -> torch.Tensor:
    """(B, 8, 2) digest words (the high and low 32 bits of each big-endian
    64-bit word, any integer dtype holding them as unsigned) -> (512, B)
    int32 bits of the little-endian integer, bit i of weight 2^i."""
    d = digest.to(torch.int64) & 0xFFFFFFFF
    parts = [(d[..., half] >> shift) & 0xFF for half in (0, 1) for shift in (24, 16, 8, 0)]
    # parts[p][:, w] is byte 8 w + p of the digest
    byts = torch.stack(parts, dim=-1).reshape(d.shape[0], 64)
    bits = (byts[..., None] >> torch.arange(8, device=d.device)) & 1  # (B, 64, 8)
    return bits.reshape(d.shape[0], 512).T.to(torch.int32).contiguous()


def mod_l_from_bits(bits_t: torch.Tensor) -> torch.Tensor:
    """(nbits, B) int32 bits, bit i of weight 2^i -> (20, B) canonical
    limbs of their integer mod L."""
    nbits, bsz = bits_t.shape
    acc = torch.zeros((fe.NLIMBS, bsz), dtype=torch.int32, device=bits_t.device)
    l_col = fe.const(L, acc)
    for i in range(nbits):
        doubled = acc + acc
        doubled[0] += bits_t[nbits - 1 - i]
        # acc < L, so 2 acc + 1 < 2^254: the carries never wrap
        acc = fe._cond_sub(fe.carry(doubled), l_col)
    return acc


def limbs_to_bits(limbs: torch.Tensor, nbits: int) -> torch.Tensor:
    """(20, B) canonical limbs -> (nbits, B) int32 bits, least first."""
    shifts = torch.arange(fe.RADIX, device=limbs.device, dtype=torch.int32)
    bits = (limbs[:, None, :] >> shifts[None, :, None]) & 1  # (20, 13, B)
    return bits.reshape(fe.NLIMBS * fe.RADIX, -1)[:nbits].contiguous()


def bits_to_rows(bits_t: torch.Tensor) -> torch.Tensor:
    """(nbits <= 256, B) bits, least first -> (B, 32) uint8 little-endian
    rows (the layout of the host challenges and the kernels' k rows)."""
    nbits, bsz = bits_t.shape
    full = torch.zeros((256, bsz), dtype=torch.int32, device=bits_t.device)
    full[:nbits] = bits_t
    weights = (1 << torch.arange(8, device=bits_t.device, dtype=torch.int32))[None, :, None]
    byts = (full.reshape(32, 8, bsz) * weights).sum(dim=1)
    return byts.T.to(torch.uint8).contiguous()
