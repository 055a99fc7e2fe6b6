"""Shared pieces of the plain reference: flat parameter trees, matrix
products at float32 or TF32, Adam, and which leaves are hidden matrices.

Parameters are flat dicts ``{"blocks.0.wqkv": tensor, ...}``: a nested
tree of dicts and lists flattened in its own order, keys joined by ".".
"""
from __future__ import annotations

import torch

# the leaves that take Adam in SOAP and Muon (FedPAC's repository rule: by
# name, and matrices with a side under 8)
NON_MATRIX_TOKENS = ("embed", "tok", "head", "norm", "bias", "scale",
                     "conv", "a_log", "lam", "cls", "pos", "dt_bias")


def flatten(tree, prefix: str = ""):
    """[(key, tensor)] of a tree of dicts, lists and tuples, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, sub in items:
        out.extend(flatten(sub, f"{prefix}.{k}" if prefix else str(k)))
    return out


def make_weights(layout, seed: int, device):
    """The benchmark's weights for ``layout`` ([(key path, shape, init)],
    ``init`` a standard deviation or "zeros"/"ones"), as the nested tree
    the key paths spell (an int key is a list index), float32 on
    ``device``.  Every normal draw comes from one ``randn`` call of a
    generator on ``device`` seeded with ``seed``: the same seed and device
    give the same weights."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(_numel(shape) for _, shape, init in layout
                if not isinstance(init, str))
    flat = torch.randn(total, generator=gen, device=device)
    root: dict = {}
    off = 0
    for path, shape, init in layout:
        if init == "zeros":
            leaf = torch.zeros(shape, device=device)
        elif init == "ones":
            leaf = torch.ones(shape, device=device)
        else:
            n = _numel(shape)
            leaf = flat[off:off + n].view(shape) * init
            off += n
        _put(root, path, leaf)
    return root


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _put(root, path, leaf):
    node = root
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = leaf


def is_hidden_matrix(key: str, shape) -> bool:
    """A hidden weight matrix (SOAP's and Muon's domain), by its
    per-client shape; 3-D leaves are stacks of matrices."""
    if len(shape) < 2 or shape[-1] < 8 or shape[-2] < 8:
        return False
    low = key.lower()
    return not any(tok in low for tok in NON_MATRIX_TOKENS)


def tf32(x):
    """``x`` rounded to TF32 (10 explicit mantissa bits, round to nearest
    even), as float32: what a tensor core reads of an operand."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Operand(torch.autograd.Function):
    """An operand rounded to TF32; its gradient passes through."""

    @staticmethod
    def forward(x):
        return tf32(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


class _TF32Cotangent(torch.autograd.Function):
    """The identity; the gradient it passes back is rounded to TF32, so a
    product's backward products read TF32 operands too."""

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return tf32(g)


class Precision:
    """Matrix products at float32 (``lowp=False``) or, forward and
    backward, on TF32-rounded operands with float32 accumulation
    (``lowp=True``: the control)."""

    def __init__(self, lowp: bool = False):
        self.lowp = bool(lowp)

    def mm(self, a, b):
        if not self.lowp:
            return torch.matmul(a, b)
        return _TF32Cotangent.apply(torch.matmul(_TF32Operand.apply(a),
                                                 _TF32Operand.apply(b)))


def adam(g, m, v, *, b1: float, b2: float, eps: float, step: int):
    """Bias-corrected Adam at local step ``step`` (t = step + 1): the
    normalised direction and the new moments."""
    t = step + 1.0
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    n = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
    return n, m, v
