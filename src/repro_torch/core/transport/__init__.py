"""Geometry transport (counterpart of ``repro/core/transport``): the wire
message envelopes, the Codec protocol, ``wire_bytes`` accounting, the codec
registry and ``Transport``.  Only the dense codec is ported so far."""
from repro_torch.core.transport.base import (  # noqa: F401
    Codec, LeafMsg, Transport, UnknownCodecError, WireMsg, dense_leaf,
    register_codec, registered_codecs, resolve_codec, validate_codec_spec,
    wire_bytes,
)
from repro_torch.core.transport.dense import Dense  # noqa: F401
