"""Geometry transport (counterpart of ``repro/core/transport``): wire-true
codecs for federated uploads.

  base.py            WireMsg / LeafMsg envelopes, the Codec protocol,
                     wire_bytes accounting, the codec registry, Transport
  dense.py           identity wire format (bf16 with wire_dtype="bf16")
  lowrank.py         lowrank_svd (factored U·s·Vᵀ) and power_sketch
  qblock.py          blockwise int8 quantization (kernels/qblock)
  chain.py           codec composition ("lowrank_svd+qblock")
  error_feedback.py  residual state for lossy delta codecs
"""
from repro_torch.core.transport.base import (
    Codec, LeafMsg, Transport, TransportConfig, UnknownCodecError,
    WIRE_DTYPES, WireMsg, concat_clients, dense_leaf, register_codec,
    registered_codecs, resolve_codec, validate_codec_spec,
    validate_wire_dtype, wire_bytes, wire_cast,
)
from repro_torch.core.transport.dense import Dense
from repro_torch.core.transport.lowrank import LowRankSVD, PowerSketch
from repro_torch.core.transport.qblock import QBlock
from repro_torch.core.transport.chain import Chain
from repro_torch.core.transport.error_feedback import (
    ef_init, ef_scatter, ef_view, encode_with_feedback,
)

__all__ = [
    "Chain", "Codec", "Dense", "LeafMsg", "LowRankSVD", "PowerSketch",
    "QBlock", "Transport", "TransportConfig", "UnknownCodecError",
    "WIRE_DTYPES", "WireMsg", "concat_clients", "dense_leaf", "ef_init",
    "ef_scatter", "ef_view", "encode_with_feedback", "register_codec",
    "registered_codecs", "resolve_codec", "validate_codec_spec",
    "validate_wire_dtype", "wire_bytes", "wire_cast",
]
