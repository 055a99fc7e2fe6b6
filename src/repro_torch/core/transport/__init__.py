"""Geometry transport (counterpart of ``repro/core/transport``): the wire
message envelopes, the Codec protocol, ``wire_bytes`` accounting, the codec
registry and ``Transport``.  Ported: the dense and qblock codecs and error
feedback."""
from repro_torch.core.transport.base import (  # noqa: F401
    Codec, LeafMsg, Transport, TransportConfig, UnknownCodecError, WireMsg,
    dense_leaf, register_codec, registered_codecs, resolve_codec,
    validate_codec_spec, wire_bytes,
)
from repro_torch.core.transport.dense import Dense  # noqa: F401
from repro_torch.core.transport.error_feedback import (  # noqa: F401
    ef_init, ef_scatter, ef_view, encode_with_feedback,
)
from repro_torch.core.transport.qblock import QBlock  # noqa: F401
