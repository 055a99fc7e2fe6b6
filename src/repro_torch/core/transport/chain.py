"""Chain codec: compose codecs by re-encoding wire payloads (counterpart
of ``repro/core/transport/chain.py``).

``Chain((a, b))`` feeds the payload tensors of ``a``'s message through
``b`` — ``lowrank_svd+qblock`` ships int8-quantized SVD factors (and the
dense passthrough leaves, quantized too).  In the reference a
``WireMsg`` is a pytree whose leaves are the payloads, so the next stage
encodes it as it is; here a message's leaves are ``LeafMsg`` envelopes,
which the tree helpers do not descend into.  So each stage encodes the
payload tree (every envelope replaced by its ``parts`` dict), and the
chain's message keeps the inner stages' envelopes, payloads taken out,
in ``WireMsg.envelopes``: metadata, as the reference's static treedef
is, so ``wire_bytes`` of the chain's message counts exactly what the
last stage ships.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.transport.base import Codec, WireMsg
from repro_torch.utils.tree import tree_map


def _payloads(leaves):
    """A message's payload tree: each envelope replaced by its parts."""
    return tree_map(lambda m: m.parts, leaves)


def _frame(leaves):
    """A message's envelopes with the payloads taken out."""
    return tree_map(lambda m: dataclasses.replace(m, parts=None), leaves)


def _reframe(frame, payloads):
    """The envelopes of ``frame`` around ``payloads`` (a payload tree)."""
    return tree_map(lambda m, parts: dataclasses.replace(m, parts=parts),
                    frame, payloads)


class Chain(Codec):
    def __init__(self, stages):
        self.stages = tuple(stages)   # applied left to right on encode
        if len(self.stages) < 2:
            raise ValueError("Chain wants at least two codecs")

    @property
    def name(self) -> str:  # type: ignore[override]
        return "+".join(c.name for c in self.stages)

    @property
    def lossless(self) -> bool:  # type: ignore[override]
        return all(c.lossless for c in self.stages)

    def encode(self, tree) -> WireMsg:
        msg = self.stages[0].encode(tree)
        frames = []
        for codec in self.stages[1:]:
            frames.append(_frame(msg.leaves))
            msg = codec.encode(_payloads(msg.leaves))
        return WireMsg(self.name, msg.leaves, envelopes=tuple(frames))

    def _peel(self, msgs: WireMsg) -> WireMsg:
        """Decode the outer stages of a (cohort-stacked) message, leaving
        the first stage's message — its fused reduction does the heavy
        lifting.  The outer payloads (e.g. quantized SVD factors) are
        small beside the dense tree, so decoding them is cheap."""
        leaves = msgs.leaves
        for codec, frame in zip(reversed(self.stages[1:]),
                                reversed(msgs.envelopes)):
            leaves = _reframe(frame, codec.decode(WireMsg(codec.name,
                                                          leaves)))
        return WireMsg(self.stages[0].name, leaves)

    def decode(self, msg: WireMsg):
        return self.stages[0].decode(self._peel(msg))

    def accumulate(self, msgs: WireMsg, weights, carry=None):
        return self.stages[0].accumulate(self._peel(msgs), weights,
                                         carry=carry)

    def sq_norms(self, msgs: WireMsg):
        return self.stages[0].sq_norms(self._peel(msgs))
