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
each client's row into blocks of its own; the low-rank codecs factor each
client's matrices).  ``accumulate`` reduces a stacked message straight
into the weighted sum sum_i w_i decode(msg_i), optionally folded into a
running ``carry``; ``sq_norms`` gives each client's squared norm, the
wire-native half of the drift decomposition.

Codecs: ``dense``, ``lowrank_svd`` (and ``svd``, the legacy ``*_light``
token), ``power_sketch``, ``qblock`` and ``"a+b"`` chains of them
(``chain.py``); ``wire_dtype="bf16"`` halves the floating payloads of the
dense and low-rank codecs.  Error feedback for lossy delta codecs is in
``error_feedback.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class UnknownCodecError(ValueError):
    """Codec spec names no registered codec."""


# wire dtypes: "f32" ships floating payloads in their native dtype (the
# lossless wire format); "bf16" halves every floating payload on the wire
# (dense leaves, low-rank/sketch factors — qblock is already int8 + f32
# scales and is unaffected).  Decode casts back to the envelope's dtype.
WIRE_DTYPES = {"f32": None, "bf16": torch.bfloat16}


def validate_wire_dtype(name: str) -> str:
    if name not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire_dtype {name!r} (want one of "
            f"{tuple(sorted(WIRE_DTYPES))})")
    return name


def wire_cast(leaf, wire_dtype: str):
    """Cast a floating payload to the wire dtype ("f32" ships native)."""
    dt = WIRE_DTYPES[wire_dtype]
    if dt is None or not leaf.dtype.is_floating_point:
        return leaf
    return leaf.to(dt)


@dataclasses.dataclass(frozen=True)
class LeafMsg:
    """One leaf's wire representation: payload tensors + envelope."""
    kind: str          # "dense" | "lowrank" | "sketch" | "qblock"
    shape: tuple       # encoded (stacked) leaf shape (decode target)
    dtype: Any         # encoded leaf dtype (decode target)
    parts: dict        # name -> payload tensor (what actually ships)
    extra: Any = None  # codec framing (qblock's block size)


@dataclasses.dataclass(frozen=True)
class WireMsg:
    """One upload: the source tree with a ``LeafMsg`` at every leaf.

    ``envelopes`` is a chain's framing (``chain.py``): for each inner
    stage, its ``LeafMsg`` tree with the payloads taken out — metadata,
    like the reference's static treedef, so ``wire_bytes`` skips it."""
    codec: str
    leaves: Any
    envelopes: tuple = ()


def wire_bytes(msg: WireMsg) -> int:
    """Bytes on the wire for ``msg``, summed from its payload tensors."""
    total = 0
    for leaf in tree_leaves(msg.leaves):
        for part in leaf.parts.values():
            total += math.prod(part.shape) * part.element_size()
    return int(total)


def _join_leaf(*msgs: LeafMsg) -> LeafMsg:
    parts = (None if msgs[0].parts is None else
             {k: torch.cat([m.parts[k] for m in msgs])
              for k in msgs[0].parts})
    rows = sum(m.shape[0] for m in msgs)
    return dataclasses.replace(msgs[0], shape=(rows, *msgs[0].shape[1:]),
                               parts=parts)


def concat_clients(uploads):
    """Client-stacked uploads of one channel joined along the client axis:
    ``WireMsg``s of one codec (payloads, their stacked shapes and a
    chain's envelopes alike) or dense stacked trees; None stays None.
    The async runtime's buffer stacks one-client messages this way."""
    first = uploads[0]
    if first is None:
        return None
    if isinstance(first, WireMsg):
        leaves = tree_map(_join_leaf, first.leaves,
                          *[m.leaves for m in uploads[1:]])
        envelopes = tuple(
            tree_map(_join_leaf, *frames)
            for frames in zip(*[m.envelopes for m in uploads]))
        return WireMsg(first.codec, leaves, envelopes)
    return tree_map(lambda *xs: torch.cat(xs), *uploads)


def dense_leaf(leaf, wire_dtype: str = "f32") -> LeafMsg:
    """Passthrough envelope: the leaf itself is the payload (cast to the
    wire dtype on the way out; the envelope keeps the decode target)."""
    return LeafMsg("dense", tuple(leaf.shape), leaf.dtype,
                   {"x": wire_cast(leaf, wire_dtype)})


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
        if msg.kind == "dense":
            return msg.parts["x"].to(msg.dtype)
        raise NotImplementedError(
            f"{type(self).__name__} cannot decode kind {msg.kind!r}")

    def encode(self, tree) -> WireMsg:
        return WireMsg(self.name, tree_map(self.encode_leaf, tree))

    def decode(self, msg: WireMsg):
        return tree_map(self.decode_leaf, msg.leaves)

    def roundtrip(self, tree):
        """What the server reconstructs from these clients' uploads."""
        return self.decode(self.encode(tree))

    def accumulate_leaf(self, msgs: LeafMsg, weights, carry=None):
        """sum_i w_i * decode(msg_i) for one stacked leaf, in f32.

        ``carry`` is a running partial sum from earlier chunks of the same
        cohort; ``carry=None`` is the exact one-shot expression, with no
        zeros added."""
        out = torch.tensordot(weights.to(torch.float32),
                              self.decode_leaf(msgs).to(torch.float32),
                              dims=([0], [0]))
        return out if carry is None else carry + out

    def accumulate(self, msgs: WireMsg, weights, carry=None):
        """The tree of sum_i w_i * decode(msg_i); weights: (B,).  ``carry``
        (a tree like the decode target) folds this chunk into running
        partial sums; None is the one-shot flush."""
        if carry is None:
            return tree_map(lambda m: self.accumulate_leaf(m, weights),
                            msgs.leaves)
        return tree_map(
            lambda m, c: self.accumulate_leaf(m, weights, carry=c),
            msgs.leaves, carry)

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
    """Knobs shared by codec factories (one config, every codec).
    ``wire_dtype`` caps the dtype of floating payloads ("f32" ships
    native; "bf16" halves dense payloads and low-rank factors)."""
    rank: int = 8            # low-rank codecs (FedConfig.svd_rank)
    block: int = 128         # qblock elements per scale
    sketch_iters: int = 2    # power_sketch subspace iterations
    wire_dtype: str = "f32"  # floating payload dtype on the wire

    def __post_init__(self):
        validate_wire_dtype(self.wire_dtype)


def _parse_spec(spec) -> list:
    """'a+b' -> validated registry names; raises UnknownCodecError."""
    names = [p.strip() for p in str(spec).split("+")]
    for name in names:
        if name not in _FACTORIES:
            raise UnknownCodecError(
                f"unknown upload codec {name!r} (want one of "
                f"{registered_codecs()}, or a '+'-chain of them)")
    return names


def resolve_codec(spec, cfg: TransportConfig | None = None) -> Codec:
    """Codec instances pass through; strings resolve against the registry,
    built with ``cfg`` (default ``TransportConfig()``).  ``"a+b"``
    composes a chain (a's payloads re-encoded by b, e.g.
    ``"lowrank_svd+qblock"`` quantizes the SVD factors)."""
    if isinstance(spec, Codec):
        return spec
    cfg = cfg or TransportConfig()
    stages = [_FACTORIES[name](cfg) for name in _parse_spec(spec)]
    if len(stages) == 1:
        return stages[0]
    from repro_torch.core.transport.chain import Chain
    return Chain(tuple(stages))


def validate_codec_spec(spec) -> None:
    """Raises UnknownCodecError for unresolvable specs (cheap, no build)."""
    if not isinstance(spec, Codec):
        _parse_spec(spec)


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
        cohort of one: codecs take client-stacked trees).  The encode is
        real work on the trees' device: for the low-rank codecs it takes
        one client's SVDs or sketches."""
        def one(tree):
            return tree_map(lambda x: x[None], tree)

        total = wire_bytes(self.delta.encode(one(params)))
        if theta is not None:
            total += wire_bytes(self.theta.encode(one(theta)))
        return total
