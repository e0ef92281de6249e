"""JSON <-> core types: the /commit and /validators JSON shapes.

Counterpart: tendermint_tpu/wire/json_types.py (libs/json and the RPC
client's decoding): RFC 3339 times with nanoseconds, upper-case hex
hashes, base64 keys and signatures. The batched light service's
request_from_json and request_to_json (light/service.py) use it.
Validators are ed25519 only, as in the reference.
"""

from __future__ import annotations

import base64
import calendar
import datetime
import re

from ..crypto import ed25519
from ..types.block import (
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
    SignedHeader,
    Version,
)
from ..types.validator_set import Validator, ValidatorSet
from .canonical import Timestamp

_TIME_RE = re.compile(r"^(\d{4})-(\d{2})-(\d{2})T(\d{2}):(\d{2}):(\d{2})(?:\.(\d+))?Z$")


def parse_time(s: str) -> Timestamp:
    m = _TIME_RE.match(s)
    if not m:
        raise ValueError(f"bad RFC3339 time {s!r}")
    y, mo, d, h, mi, sec = (int(m.group(i)) for i in range(1, 7))
    frac = (m.group(7) or "").ljust(9, "0")
    secs = calendar.timegm((y, mo, d, h, mi, sec, 0, 0, 0))
    return Timestamp(seconds=secs, nanos=int(frac) if frac else 0)


def _hex(v) -> bytes:
    return bytes.fromhex(v) if v else b""


def parse_block_id(d) -> BlockID:
    if d is None:
        return BlockID()
    parts = d.get("parts") or d.get("part_set_header")
    psh = (PartSetHeader(total=int(parts["total"]), hash=_hex(parts["hash"]))
           if parts else PartSetHeader())
    return BlockID(hash=_hex(d["hash"]), part_set_header=psh)


def parse_header(d) -> Header:
    return Header(
        version=Version(block=int(d["version"]["block"]), app=int(d["version"].get("app", 0))),
        chain_id=d["chain_id"],
        height=int(d["height"]),
        time=parse_time(d["time"]),
        last_block_id=parse_block_id(d.get("last_block_id")),
        last_commit_hash=_hex(d.get("last_commit_hash")),
        data_hash=_hex(d.get("data_hash")),
        validators_hash=_hex(d["validators_hash"]),
        next_validators_hash=_hex(d["next_validators_hash"]),
        consensus_hash=_hex(d["consensus_hash"]),
        app_hash=_hex(d.get("app_hash")),
        last_results_hash=_hex(d.get("last_results_hash")),
        evidence_hash=_hex(d.get("evidence_hash")),
        proposer_address=_hex(d["proposer_address"]),
    )


def parse_commit(d) -> Commit:
    sigs = [
        CommitSig(
            block_id_flag=int(s["block_id_flag"]),
            validator_address=_hex(s.get("validator_address")),
            timestamp=parse_time(s["timestamp"]) if s.get("timestamp") else Timestamp.zero(),
            signature=base64.b64decode(s["signature"]) if s.get("signature") else b"",
        )
        for s in d["signatures"]
    ]
    return Commit(height=int(d["height"]), round=int(d["round"]),
                  block_id=parse_block_id(d["block_id"]), signatures=sigs)


def parse_signed_header(d) -> SignedHeader:
    return SignedHeader(header=parse_header(d["header"]), commit=parse_commit(d["commit"]))


def parse_validator(v) -> Validator:
    pk = v["pub_key"]
    if pk.get("type") not in (None, "tendermint/PubKeyEd25519"):
        raise ValueError(f"unsupported pubkey type {pk.get('type')!r}")
    val = Validator.new(ed25519.PubKey(base64.b64decode(pk["value"])), int(v["voting_power"]))
    if v.get("proposer_priority") is not None:
        val.proposer_priority = int(v["proposer_priority"])
    if v.get("address") and val.address != _hex(v["address"]):
        raise ValueError("validator address does not match its pubkey")
    return val


def parse_validator_set(d) -> ValidatorSet:
    """Order-preserving (the hash commits to the given order)."""
    vs = ValidatorSet(validators=[parse_validator(v) for v in d["validators"]])
    vs._update_total_voting_power()
    return vs


def time_to_json(ts: Timestamp) -> str:
    """RFC 3339, trailing zeros of the nanoseconds cut (genesis.py's
    _time_to_rfc3339)."""
    dt = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc) + datetime.timedelta(
        seconds=ts.seconds)
    s = dt.strftime("%Y-%m-%dT%H:%M:%S")
    if ts.nanos:
        s += f".{ts.nanos:09d}".rstrip("0")
    return s + "Z"


def _hexs(b: bytes) -> str:
    return b.hex().upper()


def block_id_to_json(bid: BlockID) -> dict:
    return {"hash": _hexs(bid.hash),
            "parts": {"total": bid.part_set_header.total,
                      "hash": _hexs(bid.part_set_header.hash)}}


def header_to_json(h: Header) -> dict:
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": time_to_json(h.time),
        "last_block_id": block_id_to_json(h.last_block_id),
        "last_commit_hash": _hexs(h.last_commit_hash),
        "data_hash": _hexs(h.data_hash),
        "validators_hash": _hexs(h.validators_hash),
        "next_validators_hash": _hexs(h.next_validators_hash),
        "consensus_hash": _hexs(h.consensus_hash),
        "app_hash": _hexs(h.app_hash),
        "last_results_hash": _hexs(h.last_results_hash),
        "evidence_hash": _hexs(h.evidence_hash),
        "proposer_address": _hexs(h.proposer_address),
    }


def commit_to_json(c: Commit) -> dict:
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": block_id_to_json(c.block_id),
        "signatures": [
            {
                "block_id_flag": cs.block_id_flag,
                "validator_address": _hexs(cs.validator_address),
                "timestamp": time_to_json(cs.timestamp),
                "signature": base64.b64encode(cs.signature).decode() if cs.signature else None,
            }
            for cs in c.signatures
        ],
    }


def signed_header_to_json(sh: SignedHeader) -> dict:
    return {"header": header_to_json(sh.header), "commit": commit_to_json(sh.commit)}


def validator_set_to_json(vs: ValidatorSet) -> dict:
    # parse_validator takes ed25519 only: a foreign key is refused here
    for v in vs.validators:
        if v.pub_key.type() != "ed25519":
            raise ValueError(f"validator pubkey type {v.pub_key.type()!r} has no JSON "
                             "wire form here (ed25519 only)")
    return {
        "validators": [
            {
                "address": _hexs(v.address),
                "pub_key": {"type": "tendermint/PubKeyEd25519",
                            "value": base64.b64encode(v.pub_key.bytes()).decode()},
                "voting_power": str(v.voting_power),
                "proposer_priority": str(v.proposer_priority),
            }
            for v in vs.validators
        ]
    }
