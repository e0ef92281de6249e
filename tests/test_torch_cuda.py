"""The CUDA kernels of the port against their plain PyTorch versions, on
the card. These tests need an NVIDIA card and nvcc (marker `cuda`); where
torch sees no CUDA device they skip, decided inside the `cuda` fixture.
Run them on the card with `python -m pytest tests/test_torch_cuda.py`.

Tolerance: none. Coordinates are compared after canonicalisation (and
are expected equal limb for limb), flags, digits and verdicts exactly.
"""

import hashlib

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import _edwards
from tendermint_tpu_torch.crypto import ed25519
from tendermint_tpu_torch.ops import fe, rlc
from tendermint_tpu_torch.ops.entry_block import EntryBlock

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("torch sees no CUDA device")
    return torch.device("cuda", 0)


def _entries(n: int) -> list:
    out = []
    for i in range(n):
        sk = ed25519.gen_priv_key(hashlib.sha256(b"cuda %d" % i).digest())
        msg = b"cuda-test-%d" % i
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    # a tampered signature, a small-order key, s >= L
    pk, msg, sig = out[5]
    out[5] = (pk, msg, sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:])
    s = 12345
    r = _edwards.compress(_edwards.scalar_mult(s, _edwards.BASE))
    out[9] = (bytes(32), b"small order", r + s.to_bytes(32, "little"))
    out[13] = (out[13][0], out[13][1], out[13][2][:32] + (_edwards.L + 1).to_bytes(32, "little"))
    return out


@pytest.fixture(scope="module")
def inputs(cuda):
    """64 lanes: 240 signatures and 4 padding lanes, on the card."""
    args = rlc.prepare_rlc(EntryBlock.from_entries(_entries(240)), 256)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in args]


def _canon_slots(x):
    slots, g = x.shape[0] // 32, x.shape[1]
    limbs = x.view(slots, 32, g)[:, : fe.NLIMBS].permute(1, 0, 2).reshape(fe.NLIMBS, -1)
    return fe.canon(limbs)


def test_k1_matches_plain(inputs):
    a_t, r_t, scal_t, _ = inputs
    want = rlc.k1_rlc_plain(a_t, r_t, scal_t)
    got = rlc.k1_rlc(a_t, r_t, scal_t)
    torch.cuda.synchronize()
    assert torch.equal(_canon_slots(got[0]), _canon_slots(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_k2_and_k3_match_plain(inputs):
    a_t, r_t, scal_t, sok = inputs
    coords, ok, dig = rlc.k1_rlc_plain(a_t, r_t, scal_t)
    tbl_p = rlc.k2_rlc_plain(coords)
    tbl_k = rlc.k2_rlc(coords)
    torch.cuda.synchronize()
    assert torch.equal(_canon_slots(tbl_k), _canon_slots(tbl_p))
    out_p = rlc.k3_rlc_plain(tbl_p, dig, coords, ok, sok)
    out_k = rlc.k3_rlc(tbl_p, dig, coords, ok, sok)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    lanes = out_k.cpu().numpy()[0].astype(bool)
    assert lanes.tolist() == [i not in (1, 3) for i in range(64)]  # tampered, s >= L


def test_verify_batch_launches_each_kernel_once(cuda):
    block = EntryBlock.from_entries(_entries(100))
    rlc.reset_launches()
    got = rlc.verify_batch_rlc(block, device=cuda)
    assert rlc.LAUNCHES == {"k1_rlc": 1, "k2_rlc": 1, "k3_rlc": 1}
    assert got.tolist() == [_edwards.verify_zip215(*e) for e in block.iter_entries()]


def test_cuda_wrappers_reject_mixed_devices(inputs):
    a_t, r_t, scal_t, _ = inputs
    with pytest.raises(ValueError, match="expected"):
        rlc.k1_rlc(a_t, r_t.cpu(), scal_t)
