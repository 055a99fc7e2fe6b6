"""qblock codec: blockwise int8 quantization with per-block f32 scales
(counterpart of ``repro/core/transport/qblock.py``).

Every client's leaf is flattened and quantized in blocks of ``block``
elements — n int8 values + ceil(n/block) f32 scales on the wire per leaf
per client, a ~4x shrink for f32 trees with per-element error bounded by
scale/2.  The codec sees the cohort-stacked leaf as ``(S, n)`` and the
``quantize`` kernel (``kernels/qblock``) cuts each client's row into
blocks of its own, so the message is exactly the reference's ``vmap`` of
one client's encode; ``encode`` quantizes every leaf of the tree in one
grouped launch (``encode_leaf`` one leaf).  Server-side the codec never
decodes a stacked cohort: ``accumulate`` runs the fused
dequantize-accumulate kernel (``kernels/fused_agg``) straight into the
weighted sums, one grouped launch for every leaf of the tree
(``accumulate_leaf`` for one), and
``sq_norms_leaf`` takes s^2 * sum(q^2) per block in plain PyTorch, as the
reference computes it in ``jnp``.  ``decode_leaf`` (the error-feedback
residual, a chain's outer stage, tests) is plain PyTorch, as the
reference's ``dequantize`` is.  Non-f32 leaves (a chain's bf16 factors)
are quantized as f32, as the reference's ``ref.py`` casts them, and decode
to their own dtype.  The wire format is already int8 + f32 scales, so
``wire_dtype`` does not apply.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.transport.base import (
    Codec, LeafMsg, TransportConfig, WireMsg, register_codec,
)
from repro_torch.kernels.fused_agg.kernel import (
    dequant_accumulate, dequant_accumulate_group,
)
from repro_torch.kernels.qblock.kernel import (
    dequantize, quantize, quantize_group,
)
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_unflatten,
)


def _rows(leaf):
    """A stacked leaf as the kernel's (clients, n) f32 rows."""
    return leaf.reshape(leaf.shape[0], -1).to(torch.float32)


class QBlock(Codec):
    name = "qblock"
    lossless = False

    def __init__(self, block: int = 128):
        self.block = block

    def _msg(self, leaf, q, scale) -> LeafMsg:
        # the block size rides in the envelope, so a decoder configured
        # differently still frames the blocks correctly
        return LeafMsg("qblock", tuple(leaf.shape), leaf.dtype,
                       {"q": q, "scale": scale}, extra=self.block)

    def encode_leaf(self, leaf) -> LeafMsg:
        return self._msg(leaf, *quantize(_rows(leaf), block=self.block))

    def encode(self, tree) -> WireMsg:
        """Every leaf of the stacked tree: one grouped kernel call."""
        flat = tree_leaves(tree)
        coded = quantize_group([_rows(x) for x in flat], block=self.block)
        return WireMsg(self.name, tree_unflatten(tree, [
            self._msg(x, q, s) for x, (q, s) in zip(flat, coded)]))

    def decode_leaf(self, msg: LeafMsg):
        x = dequantize(msg.parts["q"], msg.parts["scale"], msg.extra)
        return x.reshape(msg.shape).to(msg.dtype)

    def accumulate_leaf(self, msgs: LeafMsg, weights, carry=None):
        out = dequant_accumulate(msgs.parts["q"], msgs.parts["scale"],
                                 weights, block=msgs.extra)
        out = out.reshape(msgs.shape[1:])
        return out if carry is None else carry + out

    def accumulate(self, msgs, weights, carry=None):
        """The tree of sum_i w_i * decode(msg_i): one grouped kernel call.
        A message frames every leaf with the one block it was encoded
        with.  ``carry`` is added after the flush (``carry + out``, as the
        reference folds it)."""
        flat = [m for _, m in tree_flatten_with_path(msgs.leaves)]
        blocks = {m.extra for m in flat}
        if len(blocks) > 1:
            raise ValueError(f"a qblock message frames its leaves with one "
                             f"block, got {sorted(blocks)}")
        outs = dequant_accumulate_group(
            [m.parts["q"] for m in flat], [m.parts["scale"] for m in flat],
            weights, block=blocks.pop() if blocks else self.block)
        outs = [out.reshape(m.shape[1:]) for m, out in zip(flat, outs)]
        if carry is not None:
            outs = [c + out for c, out in zip(tree_leaves(carry), outs)]
        return tree_unflatten(msgs.leaves, outs)

    def sq_norms_leaf(self, msgs: LeafMsg):
        # ||q * s||^2 per block = s^2 * sum(q^2): the scales come out of
        # the inner sum, so the pass stays on the int8 buffer
        q, scale, block = msgs.parts["q"], msgs.parts["scale"], msgs.extra
        b, n = q.shape
        nb = scale.shape[1]
        qf = F.pad(q, (0, nb * block - n)).reshape(b, nb, block).to(
            torch.float32)
        per_block = torch.einsum("bnk,bnk->bn", qf, qf)
        return torch.einsum("bn,bn->b", per_block,
                            scale.to(torch.float32) ** 2)


@register_codec("qblock")
def _make_qblock(cfg: TransportConfig) -> QBlock:
    return QBlock(block=cfg.block)
