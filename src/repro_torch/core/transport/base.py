"""Wire-true geometry transport: the ``Codec`` protocol and wire messages
(counterpart of ``repro/core/transport/base.py``).

A codec turns a tree (a client's delta or Theta upload) into a
``WireMsg`` — the structures that would cross the network — and back.
``wire_bytes`` derives communication accounting from those structures
alone (shape x itemsize of every payload tensor, host-side integer math),
so byte counts are measurements of what the codec ships.

The reference encodes one client at a time under ``vmap``; here codecs
encode the cohort-stacked tree in one call, every payload keeping the
leading (S,) client axis.  For the leaf-wise dense codec that is the same
message.  ``accumulate`` reduces a stacked message straight into the
weighted sum sum_i w_i decode(msg_i).

Only the dense codec is ported; lowrank, sketch, qblock, chains and error
feedback follow with their kernels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class UnknownCodecError(ValueError):
    """Codec spec names no registered codec."""


@dataclasses.dataclass(frozen=True)
class LeafMsg:
    """One leaf's wire representation: payload tensors + envelope."""
    kind: str          # "dense"
    shape: tuple       # encoded leaf shape (decode target)
    dtype: Any         # encoded leaf dtype (decode target)
    parts: dict        # name -> payload tensor (what actually ships)


@dataclasses.dataclass(frozen=True)
class WireMsg:
    """One upload: the source tree with a ``LeafMsg`` at every leaf."""
    codec: str
    leaves: Any


def wire_bytes(msg: WireMsg) -> int:
    """Bytes on the wire for ``msg``, summed from its payload tensors."""
    total = 0
    for leaf in tree_leaves(msg.leaves):
        for part in leaf.parts.values():
            total += math.prod(part.shape) * part.element_size()
    return int(total)


def dense_leaf(leaf) -> LeafMsg:
    """Passthrough envelope: the leaf itself is the payload."""
    return LeafMsg("dense", tuple(leaf.shape), leaf.dtype, {"x": leaf})


class Codec:
    """encode(tree) -> WireMsg; decode(WireMsg) -> tree.

    Subclasses implement the per-leaf pair.  ``lossless`` declares bitwise
    round-trips.  ``accumulate`` is the fused server-side entry point over
    a cohort-stacked message; the base version decodes leaf-wise and
    contracts the weights against the client axis.
    """
    name: str = "codec"
    lossless: bool = False

    def encode_leaf(self, leaf) -> LeafMsg:
        raise NotImplementedError

    def decode_leaf(self, msg: LeafMsg):
        raise NotImplementedError

    def encode(self, tree) -> WireMsg:
        return WireMsg(self.name, tree_map(self.encode_leaf, tree))

    def decode(self, msg: WireMsg):
        return tree_map(self.decode_leaf, msg.leaves)

    def accumulate_leaf(self, msgs: LeafMsg, weights):
        """sum_i w_i * decode(msg_i) for one stacked leaf, in f32."""
        return torch.tensordot(weights.to(torch.float32),
                               self.decode_leaf(msgs).to(torch.float32),
                               dims=([0], [0]))

    def accumulate(self, msgs: WireMsg, weights):
        """The tree of sum_i w_i * decode(msg_i); weights: (B,)."""
        return tree_map(lambda m: self.accumulate_leaf(m, weights),
                        msgs.leaves)


# --------------------------------------------------------------- registry

_FACTORIES: dict[str, Callable[[], Codec]] = {}


def register_codec(name: str):
    """Class/factory decorator: ``factory() -> Codec``."""
    def deco(factory):
        _FACTORIES[name] = factory
        return factory
    return deco


def registered_codecs() -> tuple:
    return tuple(sorted(_FACTORIES))


def validate_codec_spec(spec) -> None:
    """Raises UnknownCodecError for specs naming no ported codec."""
    if isinstance(spec, Codec):
        return
    if str(spec) not in _FACTORIES:
        raise UnknownCodecError(
            f"unknown or unported upload codec {spec!r} (want one of "
            f"{registered_codecs()})")


def resolve_codec(spec) -> Codec:
    """Codec instances pass through; names resolve against the registry."""
    validate_codec_spec(spec)
    return spec if isinstance(spec, Codec) else _FACTORIES[str(spec)]()


# --------------------------------------------------------------- transport

@dataclasses.dataclass(frozen=True)
class Transport:
    """The resolved wire policy of one experiment: one codec per channel
    (``delta`` every client's parameter update, ``theta`` the
    preconditioner upload of aligned algorithms)."""
    delta: Codec
    theta: Codec

    def round_bytes(self, params, theta=None) -> int:
        """Per-client upload bytes for one round, measured from the wire
        messages the codecs build for one client's trees."""
        total = wire_bytes(self.delta.encode(params))
        if theta is not None:
            total += wire_bytes(self.theta.encode(theta))
        return total
