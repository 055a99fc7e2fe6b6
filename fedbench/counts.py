"""The yardstick's arithmetic: the card's published peaks, the model FLOPs
of a client's local step, and the work of the port's hand-written kernels
at a round's shapes (each operand read once, each output written once).

The kernel counts are frozen copies of ``chip_smoke.py``'s
``gemm_forms``/``time_soap_step`` (``matmul_fused``: SOAP's six products
a matrix leaf a step) and ``ns_flops`` (``newton_schulz``: the function's
work, the symmetric A and B on or above the diagonal), so that the
benchmark's bound does not move with the program.
"""
from __future__ import annotations

from fedbench.reference import lm, vit
from fedbench.reference.common import is_hidden_matrix

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
FP32_FLOPS = 67e12           # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

LAYOUTS = {"vit": vit.weight_layout, "lm": lm.weight_layout}


def _prod(xs):
    n = 1
    for x in xs:
        n *= x
    return n


def matrix_leaves(cfg):
    """(stack, m, n) of every hidden matrix leaf (per client)."""
    out = []
    for path, shape, _ in LAYOUTS[cfg["family"]](cfg):
        key = ".".join(str(k) for k in path)
        if is_hidden_matrix(key, shape):
            out.append((_prod(shape[:-2]), shape[-2], shape[-1]))
    return out


def model_flops(cfg, rows: int) -> int:
    """FLOPs of one client's local step on ``rows`` rows: the forward and
    the backward's matrix products (both gradients of every product whose
    two operands need one; the weight gradient alone where the input is
    data).  Attention's products are counted over the whole square of
    positions, as the model computes them."""
    fam = cfg["family"]
    if fam == "vit":
        d, ff = cfg["hidden_size"], cfg["intermediate_size"]
        p, c = cfg["patch_size"], cfg["num_channels"]
        t = vit.tokens_per_row(cfg)
        embed = 2 * rows * (t - 1) * p * p * c * d
        layer = 2 * rows * t * (3 * d * d + d * d + 2 * d * ff) \
            + 4 * rows * t * t * d
        head = 2 * rows * d * cfg["num_labels"]
        fwd = embed + cfg["num_hidden_layers"] * layer + head
        return 3 * fwd - embed       # no gradient for the images
    if fam == "lm":
        d = cfg["hidden_size"]
        hd = d // cfg["num_attention_heads"]
        q, kv = cfg["num_attention_heads"] * hd, \
            cfg["num_key_value_heads"] * hd
        ff, s = cfg["intermediate_size"], cfg["data"]["seq_len"]
        tok = rows * s
        layer = 2 * tok * (d * q + 2 * d * kv + q * d + 3 * d * ff) \
            + 4 * rows * cfg["num_attention_heads"] * s * s * hd
        head = 2 * tok * d * cfg["vocab_size"]
        return 3 * (cfg["num_hidden_layers"] * layer + head)
    raise ValueError(f"no FLOP count for family {fam!r}")


def round_model_flops(cfg, traffic) -> int:
    """Model FLOPs of one round: every cohort client's K local steps."""
    return (cohort(traffic) * traffic["local_steps"]
            * model_flops(cfg, traffic["batch_size"]))


def cohort(traffic) -> int:
    return max(1, int(round(traffic["n_clients"] * traffic["participation"])))


def soap_products(s, m, n):
    """``gemm_forms`` of one leaf: (s, rows, inner, cols, has_aux, input
    elements read once) of its six products, float32 each."""
    return [(s, m, n, m, True, m * n + m * m),          # L = G G^T (+ L)
            (s, n, m, n, True, m * n + n * n),          # R = G^T G (+ R)
            (s, m, m, n, False, m * m + m * n),         # Q_L^T G
            (s, m, n, n, False, m * n + n * n),         # G Q_R
            (s, m, m, n, False, m * m + m * n),         # Q_L N
            (s, m, n, n, False, m * n + n * n)]         # N Q_R^T


def matmul_fused_work(cfg, traffic):
    """(FLOPs, bytes) of one round's ``matmul_fused`` launches: K local
    steps of SOAP's products over every matrix leaf of the cohort."""
    s_c = cohort(traffic)
    flops = bytes_ = 0
    for stack, m, n in matrix_leaves(cfg):
        for s, rows, k, cols, aux, ins in soap_products(s_c * stack, m, n):
            flops += 2 * s * rows * cols * k + (3 if aux else 1) * s * rows \
                * cols
            bytes_ += 4 * s * (ins + rows * cols)
    steps = traffic["local_steps"]
    return flops * steps, bytes_ * steps


def ns_function_flops(s, m, n, steps=5):
    """``ns_flops``' "function" count for ``s`` matrices of m x n: the
    wide orientation, A and B on or above the diagonal."""
    m, n = sorted((m, n))
    tri = m * (m + 1) // 2
    return steps * s * (2 * tri * n + tri * (2 * m + 3)
                        + 2 * m * m * n + 2 * m * n)


def newton_schulz_work(cfg, traffic):
    """(FLOPs, bytes) of one round's ``newton_schulz`` launches: K Muon
    steps over every matrix leaf of the cohort, each input read and each
    output written once."""
    s_c = cohort(traffic)
    flops = bytes_ = 0
    for stack, m, n in matrix_leaves(cfg):
        flops += ns_function_flops(s_c * stack, m, n)
        bytes_ += 8 * s_c * stack * m * n
    steps = traffic["local_steps"]
    return flops * steps, bytes_ * steps


def bound_seconds(flops, bytes_) -> float:
    """The least time the card could take: the larger of the operations
    at the FP32 peak and the bytes at the HBM rate."""
    return max(flops / FP32_FLOPS, bytes_ / HBM_BYTES_PER_S)
