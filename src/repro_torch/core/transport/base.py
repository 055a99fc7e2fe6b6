"""Wire-true geometry transport: the ``Codec`` protocol and wire messages
(counterpart of ``repro/core/transport/base.py``).

A codec turns a tree (a client's delta or Theta upload) into a
``WireMsg`` — the structures that would cross the network — and back.
``wire_bytes`` derives communication accounting from those structures
alone (shape x itemsize of every payload tensor, host-side integer math),
so byte counts are measurements of what the codec ships.

The reference encodes one client at a time under ``vmap``; here codecs
encode the cohort-stacked tree in one call, every payload keeping the
leading (S,) client axis, and never mix data across clients (qblock cuts
each client's row into blocks of its own).  ``accumulate`` reduces a
stacked message straight into the weighted sum sum_i w_i decode(msg_i);
``sq_norms`` gives each client's squared norm, the wire-native half of
the drift decomposition.

Ported: the dense codec and qblock (``TransportConfig.block``), and
error feedback for lossy delta codecs (``Transport.error_feedback``).
Lowrank, sketch, chains and the bf16 wire follow.
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
    kind: str          # "dense" | "qblock"
    shape: tuple       # encoded (stacked) leaf shape (decode target)
    dtype: Any         # encoded leaf dtype (decode target)
    parts: dict        # name -> payload tensor (what actually ships)
    extra: Any = None  # codec framing (qblock's block size)


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
    round-trips (error feedback is skipped for lossless codecs).
    ``accumulate`` and ``sq_norms`` are the fused server-side entry points
    over a cohort-stacked message; the base versions decode leaf-wise and
    reduce over the client axis, and wire-native codecs override them.
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

    def sq_norms_leaf(self, msgs: LeafMsg):
        """(B,) squared Frobenius norm of each client's decoded leaf."""
        dec = self.decode_leaf(msgs)
        x = dec.to(torch.float32).reshape(dec.shape[0], -1)
        return torch.sum(x * x, dim=-1)

    def sq_norms(self, msgs: WireMsg):
        """(B,) per-client squared norm over all leaves — the wire-native
        half of the drift decomposition
        drift = mean_i ||Theta_i||^2 - ||mean_i Theta_i||^2."""
        total = None
        for m in tree_leaves(msgs.leaves):
            sq = self.sq_norms_leaf(m)
            total = sq if total is None else total + sq
        return total


# --------------------------------------------------------------- registry

_FACTORIES: dict[str, Callable[["TransportConfig"], Codec]] = {}


def register_codec(name: str):
    """Class/factory decorator: ``factory(cfg: TransportConfig) -> Codec``."""
    def deco(factory):
        _FACTORIES[name] = factory
        return factory
    return deco


def registered_codecs() -> tuple:
    return tuple(sorted(_FACTORIES))


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Knobs shared by codec factories (one config, every codec)."""
    block: int = 128         # qblock elements per scale


def validate_codec_spec(spec) -> None:
    """Raises UnknownCodecError for specs naming no ported codec."""
    if isinstance(spec, Codec):
        return
    if str(spec) not in _FACTORIES:
        raise UnknownCodecError(
            f"unknown or unported upload codec {spec!r} (want one of "
            f"{registered_codecs()})")


def resolve_codec(spec, cfg: TransportConfig | None = None) -> Codec:
    """Codec instances pass through; names resolve against the registry,
    built with ``cfg`` (default ``TransportConfig()``)."""
    validate_codec_spec(spec)
    if isinstance(spec, Codec):
        return spec
    return _FACTORIES[str(spec)](cfg or TransportConfig())


# --------------------------------------------------------------- transport

@dataclasses.dataclass(frozen=True)
class Transport:
    """The resolved wire policy of one experiment: one codec per channel.

    delta  — every client's parameter update (always uploaded);
    theta  — the preconditioner upload of aligned algorithms;
    error_feedback — carry the residual of the lossy *delta* codec as
      per-client state and add it back before the next encode (EF-SGD);
      a no-op for lossless codecs.
    """
    delta: Codec
    theta: Codec
    error_feedback: bool = True

    @property
    def feedback_active(self) -> bool:
        return self.error_feedback and not self.delta.lossless

    def round_bytes(self, params, theta=None) -> int:
        """Per-client upload bytes for one round, measured from the wire
        messages the codecs build for one client's trees (encoded as a
        cohort of one: codecs take client-stacked trees)."""
        def one(tree):
            return tree_map(lambda x: x[None], tree)

        total = wire_bytes(self.delta.encode(one(params)))
        if theta is not None:
            total += wire_bytes(self.theta.encode(one(theta)))
        return total
