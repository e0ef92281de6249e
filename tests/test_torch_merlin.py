"""The port's sr25519 host side against the JAX package's: the C merlin
transcript (tendermint_tpu_torch/csrc/merlin.cpp through ops/host.py),
the pure-Python transcript, ristretto255 and schnorrkel
(tendermint_tpu_torch/crypto/_merlin.py, _ristretto.py, sr25519.py).

- The C challenges are byte-equal to the port's _merlin.py and to the
  JAX package's, over empty messages, messages longer than the STROBE
  rate, a block slice whose messages start past offset 0, and n = 0.
- The pure-Python transcripts and Keccak-f[1600] are byte-equal.
- Keys, encodings, decodings and signatures cross both ways: a key
  derived from the same seed is the same, each package's signature
  verifies under the other's verify.
- The host library checks its inputs, and is built from the port's own
  source into build/host/.

Tolerance: none; every compared value is bytes or a flag.
"""

import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tendermint_tpu.crypto import _merlin as jmerlin  # noqa: E402
from tendermint_tpu.crypto import _ristretto as jristretto  # noqa: E402
from tendermint_tpu.crypto import sr25519 as jsr  # noqa: E402
from tendermint_tpu_torch.crypto import _merlin, _ristretto  # noqa: E402
from tendermint_tpu_torch.crypto import sr25519 as psr  # noqa: E402
from tendermint_tpu_torch.ops import host  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402


def _challenge(mod, pub: bytes, r: bytes, msg: bytes) -> bytes:
    t = mod._signing_transcript(msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub)
    t.append_message(b"sign:R", r)
    return t.challenge_bytes(b"sign:c", 64)


def _block(lengths, seed: int) -> EntryBlock:
    rng = np.random.default_rng(seed)
    return EntryBlock.from_entries([(rng.bytes(32), rng.bytes(int(n)), rng.bytes(64))
                                    for n in lengths])


@pytest.mark.parametrize("lengths, window", [
    ([0, 1, 165, 166, 167, 400, 1000, 37], slice(None)),
    ([12, 0, 300, 5, 170, 9], slice(2, 5)),  # offsets rebased, a memoryview of msgs
    ([3, 4], slice(1, 1)),
])
def test_challenges_equal_both_python_transcripts(lengths, window):
    block = _block(lengths, len(lengths))[window]
    got = host.sr25519_challenges(psr.SIGNING_CTX, block.pub, block.sig[:, :32],
                                  block.msgs, block.offsets)
    assert got.shape == (len(block), 64) and got.dtype == np.uint8
    for i, (pub, msg, sig) in enumerate(block.iter_entries()):
        assert got[i].tobytes() == _challenge(psr, pub, sig[:32], msg)
        assert got[i].tobytes() == _challenge(jsr, pub, sig[:32], msg)


def test_transcripts_and_keccak_equal_jax():
    state = bytearray(np.random.default_rng(1).bytes(200))
    want = bytearray(state)
    _merlin.keccak_f1600(state)
    jmerlin.keccak_f1600(want)
    assert state == want
    p, j = _merlin.Transcript(b"test"), jmerlin.Transcript(b"test")
    for t in (p, j):
        t.append_message(b"a", b"x" * 300)
        t.append_u64(b"n", 7)
    assert p.challenge_bytes(b"c", 100) == j.challenge_bytes(b"c", 100)
    assert p.clone().challenge_bytes(b"d", 32) == j.clone().challenge_bytes(b"d", 32)


def test_keys_signatures_and_encodings_cross_both_ways():
    rng = np.random.default_rng(2)
    for i in range(2):
        seed = rng.bytes(32)
        pk, jk = psr.gen_priv_key(seed), jsr.gen_priv_key(seed)
        pub = pk.pub_key().bytes()
        assert pub == jk.pub_key().bytes()
        msg = b"cross %d" % i
        assert jsr.verify(pub, msg, pk.sign(msg))
        assert psr.verify(pub, msg, jk.sign(msg))
        assert not psr.verify(pub, msg + b"!", jk.sign(msg))
        pt = _ristretto.decode(pub)
        assert pt == jristretto.decode(pub) and _ristretto.encode(pt) == pub
    for enc in (bytes(32), (1).to_bytes(32, "little"), rng.bytes(32)):
        assert _ristretto.decode(enc) == jristretto.decode(enc)


def test_host_library_checks_its_inputs_and_is_the_ports_own():
    block = _block([4, 5], 3)
    with pytest.raises(ValueError, match="uint8"):
        host.sr25519_challenges(b"", block.pub[:1], block.sig[:, :32], block.msgs,
                                block.offsets)
    for offs in ([0, 4, 100], [0, 6, 4], [-1, 4, 9]):
        with pytest.raises(ValueError, match="offsets"):
            host.sr25519_challenges(b"", block.pub, block.sig[:, :32], block.msgs,
                                    np.array(offs, dtype=np.int64))
    lib = host.build()
    assert lib.parent == host.BUILD_DIR and lib.name.startswith("libtm_host-")
    assert host.CSRC.parent.name == "tendermint_tpu_torch"
