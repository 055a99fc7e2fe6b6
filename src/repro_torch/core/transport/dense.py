"""Dense codec: the identity wire format (counterpart of
``repro/core/transport/dense.py`` at its default f32 wire dtype).  Every
leaf ships as-is; ``decode(encode(x))`` is ``x`` and ``wire_bytes`` equals
the tree's byte size."""
from __future__ import annotations

from repro_torch.core.transport.base import (
    Codec, LeafMsg, dense_leaf, register_codec,
)


class Dense(Codec):
    name = "dense"
    lossless = True

    def encode_leaf(self, leaf) -> LeafMsg:
        return dense_leaf(leaf)

    def decode_leaf(self, msg: LeafMsg):
        return msg.parts["x"]


register_codec("dense")(lambda cfg: Dense())
