"""Light blocks and the provider interface.

Counterpart: tendermint_tpu/light/provider.py (LightBlock,
ErrLightBlockNotFound, Provider; light/provider in the reference). The
RPC and node-backed providers wait for the port's RPC client and node
stores.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

from ..types.block import SignedHeader
from ..types.validator_set import ValidatorSet


@dataclass
class LightBlock:
    """types.LightBlock: a SignedHeader and its validator set."""

    signed_header: SignedHeader
    validators: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.header.height

    def hash(self) -> bytes:
        return self.signed_header.header.hash()


class ErrLightBlockNotFound(KeyError):
    pass


class Provider(abc.ABC):
    @abc.abstractmethod
    def light_block(self, height: int) -> LightBlock:
        """The light block at height (0: the latest). Raises
        ErrLightBlockNotFound when it has none."""

    def report_evidence(self, ev) -> None:  # noqa: B027 — optional hook
        pass
