"""Dense codec: the identity wire format (counterpart of
``repro/core/transport/dense.py``).

With the default ``wire_dtype="f32"`` every leaf ships as-is;
``decode(encode(x))`` is ``x`` and ``wire_bytes`` equals the tree's byte
size.  ``wire_dtype="bf16"`` halves every floating payload on the wire
(decode casts back to the original dtype); the codec is then lossy, so
error feedback turns on for delta uploads like any other lossy codec.
"""
from __future__ import annotations

from repro_torch.core.transport.base import (
    Codec, LeafMsg, TransportConfig, dense_leaf, register_codec,
    validate_wire_dtype,
)


class Dense(Codec):
    name = "dense"

    def __init__(self, wire_dtype: str = "f32"):
        self.wire_dtype = validate_wire_dtype(wire_dtype)

    @property
    def lossless(self) -> bool:  # type: ignore[override]
        return self.wire_dtype == "f32"

    def encode_leaf(self, leaf) -> LeafMsg:
        return dense_leaf(leaf, self.wire_dtype)


@register_codec("dense")
def _make_dense(cfg: TransportConfig) -> Dense:
    return Dense(wire_dtype=cfg.wire_dtype)
