"""Columnar signature batch and columnar commit signatures.

Counterpart: tendermint_tpu/ops/entry_block.py (EntryBlock, CommitBlock).
One batch of
ed25519 signatures as contiguous columns, built once and passed by
reference from commit selection to the kernel prep:

    pub     (n, 32) uint8   public keys, one row per signature
    sig     (n, 64) uint8   signatures (R || s)
    msgs    bytes           all sign-bytes concatenated
    offsets (n+1,) int64    msgs[offsets[i]:offsets[i+1]] is message i

and, for a commit's block, the epoch metadata of ops/epoch_cache.py:

    val_idx   (n,) int32    each signature's row in its validator set
    epoch_key bytes         the set's hash(), set when the set is warm

Every row of a block shares one signature scheme (`scheme`, "ed25519"
unless said; ops/pipeline.py prepares a block by its scheme). A
secp256k1 key is 33 bytes: the block keeps its SEC1 prefix byte in
`pub_aux` (n,) uint8 and X in `pub`, so every block's pub column is
(n, 32); pub_bytes(i) joins them again.

Slicing keeps all of these; concat keeps the epoch metadata only when
every block has rows and all share one key (rows of different sets
index different tables), and refuses blocks of different schemes.

A CommitBlock holds a commit's signatures as columns, filled once at
wire decode (types/block.py); ops/commit_prep.py turns it into an
EntryBlock.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

Entry = Tuple[bytes, bytes, bytes]


class EntryBlock:
    __slots__ = ("pub", "sig", "msgs", "offsets", "val_idx", "epoch_key", "scheme",
                 "pub_aux")

    def __init__(self, pub: np.ndarray, sig: np.ndarray, msgs,
                 offsets: np.ndarray, val_idx: np.ndarray = None,
                 epoch_key: bytes = None, scheme: str = "ed25519",
                 pub_aux: np.ndarray = None):
        n = pub.shape[0]
        if (
            pub.dtype != np.uint8 or sig.dtype != np.uint8
            or pub.shape != (n, 32) or sig.shape != (n, 64)
        ):
            raise ValueError("pub must be (n, 32) and sig (n, 64) uint8")
        if offsets.shape != (n + 1,):
            raise ValueError("offsets must be (n+1,)")
        # message lengths are offsets[i+1] - offsets[i]
        if n and bool((np.diff(offsets) < 0).any()):
            raise ValueError("offsets must be non-decreasing")
        if int(offsets[-1]) > len(msgs) or int(offsets[0]) < 0:
            raise ValueError("offsets run outside the message buffer")
        if val_idx is not None and val_idx.shape != (n,):
            raise ValueError("val_idx must be (n,)")
        if (pub_aux is None) != (scheme != "secp256k1"):
            raise ValueError("a secp256k1 block, and only one, carries pub_aux")
        if pub_aux is not None and (pub_aux.dtype != np.uint8 or pub_aux.shape != (n,)):
            raise ValueError("pub_aux must be (n,) uint8")
        self.pub = pub
        self.sig = sig
        self.msgs = msgs
        self.offsets = offsets
        self.val_idx = val_idx
        self.epoch_key = epoch_key
        self.scheme = scheme
        self.pub_aux = pub_aux

    @classmethod
    def from_entries(cls, entries: Sequence[Entry], scheme: str = "ed25519") -> "EntryBlock":
        """(pub, msg, sig64) triples -> columns; pub is 32 bytes, or 33
        (SEC1 compressed) for scheme "secp256k1"."""
        n = len(entries)
        klen = 33 if scheme == "secp256k1" else 32
        if any(len(pk) != klen or len(s) != 64 for pk, _, s in entries):
            raise ValueError(f"entries must be (pub{klen}, msg, sig64) triples")
        raw = np.frombuffer(b"".join(pk for pk, _, _ in entries),
                            dtype=np.uint8).reshape(n, klen)
        pub_aux = None
        if klen == 33:
            pub_aux = np.ascontiguousarray(raw[:, 0])
            raw = np.ascontiguousarray(raw[:, 1:])
        sig = np.frombuffer(b"".join(s for _, _, s in entries),
                            dtype=np.uint8).reshape(n, 64)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(m) for _, m, _ in entries], out=offsets[1:])
        return cls(raw, sig, b"".join(m for _, m, _ in entries), offsets,
                   scheme=scheme, pub_aux=pub_aux)

    def __len__(self) -> int:
        return self.pub.shape[0]

    def msg(self, i: int) -> bytes:
        o = self.offsets
        return bytes(memoryview(self.msgs)[int(o[i]) : int(o[i + 1])])

    def pub_bytes(self, i: int) -> bytes:
        """Row i's key as the scheme writes it (the prefix byte joined
        again for secp256k1)."""
        if self.pub_aux is not None:
            return bytes([int(self.pub_aux[i])]) + self.pub[i].tobytes()
        return self.pub[i].tobytes()

    def entry(self, i: int) -> Entry:
        """ONE (pub, msg, sig) tuple — the blame path's per-lane re-verify."""
        return self.pub_bytes(i), self.msg(i), self.sig[i].tobytes()

    def iter_entries(self) -> Iterator[Entry]:
        for i in range(len(self)):
            yield self.entry(i)

    def msgs_contiguous(self) -> tuple:
        """(buffer, offsets) with the buffer cut to exactly the message
        window and the offsets rebased to start at 0: the form the host
        library's columnar calls take (ops/host.py)."""
        base = int(self.offsets[0])
        end = int(self.offsets[-1])
        buf = self.msgs
        if base != 0 or end != len(buf):
            buf = memoryview(buf)[base:end]
        return buf, self.offsets if base == 0 else self.offsets - base

    def messages(self) -> list:
        """Every message as bytes (the challenge oracle's input)."""
        buf = bytes(self.msgs)
        o = self.offsets.tolist()
        return [buf[o[i] : o[i + 1]] for i in range(len(self))]

    def __getitem__(self, key: slice) -> "EntryBlock":
        """Contiguous sub-block: numpy views + a rebased offset window."""
        if not isinstance(key, slice):
            raise TypeError("EntryBlock indexing takes a slice")
        start, stop, step = key.indices(len(self))
        if step != 1:
            raise ValueError("EntryBlock slices must be contiguous")
        o = self.offsets
        base = int(o[start])
        return EntryBlock(
            self.pub[start:stop],
            self.sig[start:stop],
            memoryview(self.msgs)[base : int(o[stop])],
            o[start : stop + 1] - base,
            val_idx=None if self.val_idx is None else self.val_idx[start:stop],
            epoch_key=self.epoch_key,
            scheme=self.scheme,
            pub_aux=None if self.pub_aux is None else self.pub_aux[start:stop],
        )

    @staticmethod
    def concat(blocks: Sequence["EntryBlock"]) -> "EntryBlock":
        """One np.concatenate per column + one msgs join; a single
        non-empty block passes through by identity. Blocks of different
        schemes raise: their rows would meet the wrong kernel."""
        if len({b.scheme for b in blocks}) > 1:
            raise ValueError("cannot concat EntryBlocks of different schemes")
        scheme = blocks[0].scheme if blocks else "ed25519"
        blocks = [b for b in blocks if len(b)]
        if len(blocks) == 1:
            return blocks[0]
        if not blocks:
            return EntryBlock.from_entries([], scheme=scheme)
        msgs = []
        offsets = [np.zeros(1, dtype=np.int64)]
        base = 0
        for b in blocks:
            lo, hi = int(b.offsets[0]), int(b.offsets[-1])
            msgs.append(bytes(memoryview(b.msgs)[lo:hi]))
            offsets.append(b.offsets[1:] - lo + base)
            base += hi - lo
        key = blocks[0].epoch_key
        same_epoch = key is not None and all(
            b.epoch_key == key and b.val_idx is not None for b in blocks
        )
        return EntryBlock(
            np.concatenate([b.pub for b in blocks]),
            np.concatenate([b.sig for b in blocks]),
            b"".join(msgs),
            np.concatenate(offsets),
            val_idx=np.concatenate([b.val_idx for b in blocks]) if same_epoch else None,
            epoch_key=key if same_epoch else None,
            scheme=scheme,
            pub_aux=(np.concatenate([b.pub_aux for b in blocks])
                     if scheme == "secp256k1" else None),
        )


class CommitBlock:
    """Columnar commit-signature representation — populated ONCE at wire
    decode (types/block.py Commit.decode) so the verify hot path never
    walks per-signature CommitSig objects. The CommitSig objects the
    `commit.signatures` API exposes are LAZY VIEWS over these columns
    (types/block.py CommitSigs), not the source of truth:

        flags      (n,)    uint8   BlockIDFlag per signature
        val_idx    (n,)    int32   validator index (signature order)
        sig        (n, 64) uint8   signatures; absent lanes all-zero
        ts_seconds (n,)    int64   vote timestamp seconds
        ts_nanos   (n,)    int32   vote timestamp nanos
        addr       (n, 20) uint8   validator addresses; absent lanes zero

    Construction invariant (enforced where types/block.py builds one):
    every lane matches the canonical CommitSig shape — absent lanes have
    no address/signature and the Go zero timestamp, non-absent lanes
    carry a 20-byte address and exactly 64 signature bytes, and flags are
    one of {ABSENT, COMMIT, NIL}. A commit violating that decodes to
    plain CommitSig objects instead (no CommitBlock), so the object path
    keeps raising exactly the errors it always raised."""

    __slots__ = ("flags", "val_idx", "sig", "ts_seconds", "ts_nanos", "addr")

    def __init__(self, flags: np.ndarray, val_idx: np.ndarray, sig: np.ndarray,
                 ts_seconds: np.ndarray, ts_nanos: np.ndarray, addr: np.ndarray):
        n = flags.shape[0]
        if (
            sig.shape != (n, 64) or addr.shape != (n, 20)
            or val_idx.shape != (n,) or ts_seconds.shape != (n,)
            or ts_nanos.shape != (n,)
        ):
            raise ValueError("CommitBlock column shapes disagree")
        self.flags = flags
        self.val_idx = val_idx
        self.sig = sig
        self.ts_seconds = ts_seconds
        self.ts_nanos = ts_nanos
        self.addr = addr

    @property
    def n(self) -> int:
        return self.flags.shape[0]

    def __len__(self) -> int:
        return self.flags.shape[0]
