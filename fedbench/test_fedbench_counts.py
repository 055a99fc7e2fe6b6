"""The yardstick's arithmetic: ``round_mfu``'s model FLOPs against
``torch.utils.flop_counter`` on the program's own models at toy sizes, and
the kernels' work against sums made by hand."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench import HERE, counts, toy
from fedbench.reference.common import flatten, make_weights


def _config(name):
    real, sizes, data = toy.CONFIGS[name]
    with open(os.path.join(HERE, "configs", real + ".json")) as f:
        cfg = json.load(f)
    cfg.update(sizes, name=name, data=dict(cfg["data"], **data))
    return cfg


def _program_loss(cfg, rows):
    """The program's loss of ``rows`` rows on the benchmark's weights."""
    from repro_torch.models import model as M
    from repro_torch.models.vision import classification_loss, vit_apply

    from fedbench.families import lm
    from fedbench.reference import lm as lm_ref
    from fedbench.reference import vit as vit_ref
    gen = torch.Generator().manual_seed(0)
    if cfg["family"] == "vit":
        p = make_weights(vit_ref.weight_layout(cfg), 0, "cpu")
        s = cfg["image_size"]
        x = torch.randn((rows, s, s, cfg["num_channels"]), generator=gen)
        y = torch.randint(0, cfg["num_labels"], (rows,), generator=gen)
        meta = {"patch": cfg["patch_size"],
                "heads": cfg["num_attention_heads"]}
        return p, lambda: classification_loss(vit_apply(p, meta, x), y)
    p = make_weights(lm_ref.weight_layout(cfg), 0, "cpu")
    s = cfg["data"]["seq_len"]
    tok = torch.randint(0, cfg["vocab_size"], (rows, s + 1), generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    mcfg = lm.model_config(cfg)
    return p, lambda: M.loss_fn(p, batch, mcfg)


@pytest.mark.parametrize("name", ["vit_toy", "lm_toy"])
def test_model_flops_match_flop_counter(name):
    cfg, rows = _config(name), 3
    params, loss = _program_loss(cfg, rows)
    leaves = [v.requires_grad_(True) for _, v in flatten(params)]
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(loss(), leaves)
    assert counts.model_flops(cfg, rows) == fc.get_total_flops()


def test_round_model_flops_of_the_cells():
    with open(os.path.join(HERE, "configs", "vit_tiny.json")) as f:
        vit = json.load(f)
    tr = {"n_clients": 100, "participation": 0.2, "local_steps": 10,
          "batch_size": 32}
    # 20 clients x 10 steps x 32 images: 64 patches and the class token
    assert counts.round_model_flops(vit, tr) == 20 * 10 * \
        counts.model_flops(vit, 32)
    assert 1.3e13 < counts.round_model_flops(vit, tr) < 1.5e13


def test_matrix_leaves_of_the_cells():
    with open(os.path.join(HERE, "configs", "vit_tiny.json")) as f:
        vit = json.load(f)
    with open(os.path.join(HERE, "configs", "smollm_360m.json")) as f:
        smol = json.load(f)
    assert sorted(set(counts.matrix_leaves(vit))) == [
        (1, 192, 192), (1, 192, 576), (1, 192, 768), (1, 768, 192)]
    assert len(counts.matrix_leaves(vit)) == 48
    assert sorted(counts.matrix_leaves(smol)) == sorted(
        [(32, 960, 960)] * 2 + [(32, 960, 320)] * 2
        + [(32, 960, 2560)] * 2 + [(32, 2560, 960)])


def test_matmul_fused_work_by_hand():
    cfg = {"family": "vit"}
    tr = {"n_clients": 4, "participation": 0.5, "local_steps": 3}
    m, n, s = 5, 7, 2
    original = counts.matrix_leaves
    counts.matrix_leaves = lambda c: [(1, m, n)]
    try:
        flops, bytes_ = counts.matmul_fused_work(cfg, tr)
    finally:
        counts.matrix_leaves = original
    # L, R: G G^T (+ L), G^T G (+ R); four rotations of m x n outputs
    want_f = s * (2 * m * m * n + 3 * m * m + 2 * n * n * m + 3 * n * n
                  + 2 * (2 * m * n * m + m * n) + 2 * (2 * m * n * n + m * n))
    want_b = 4 * s * ((m * n + 2 * m * m) + (m * n + 2 * n * n)
                      + 2 * (m * m + 2 * m * n) + 2 * (n * n + 2 * m * n))
    assert (flops, bytes_) == (3 * want_f, 3 * want_b)


def test_newton_schulz_flops_by_hand():
    # 5 steps of A = X X^T (upper triangle), B = c A A + b A (upper
    # triangle, two operations an entry), X' = B X + a X
    m, n, s = 3, 4, 2
    tri = m * (m + 1) // 2
    step = 2 * tri * n + tri * (2 * m + 3) + 2 * m * m * n + 2 * m * n
    assert counts.ns_function_flops(s, n, m) == 5 * s * step
    assert counts.bound_seconds(67e12, 0) == 1.0
    assert counts.bound_seconds(0, 3.35e12) == 1.0
