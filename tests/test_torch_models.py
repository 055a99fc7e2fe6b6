"""The port's vision models (``repro_torch.models.vision``) against
``repro.models.vision``: logits and ``torch.func.grad`` of the loss against
``jax.grad``, with the JAX-initialised params carried across
(``repro_torch.convert``) and the same numpy inputs on both sides.

Tolerances: logits and loss 2e-5 absolute, gradients 1e-5 + 1e-4 relative
per element — f32 convolutions, normalisations and softmaxes summed in
other orders by XLA and by PyTorch's CPU kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import vision as jv
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import vision as tv
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

LOGIT_TOL = 2e-5


@pytest.fixture(scope="module")
def jax_cnn():
    return jax.jit(lambda k: jv.init_cnn(k, n_classes=8, width=8, blocks=2))(
        jax.random.key(3))


@pytest.fixture(scope="module")
def jax_vit():
    kw = dict(image_size=16, patch=4, d_model=32, layers=2, heads=2,
              n_classes=8)
    meta = jv.init_vit(jax.random.key(4), **dict(kw, layers=0))[1]
    return jax.jit(lambda k: jv.init_vit(k, **kw)[0])(jax.random.key(4)), meta


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(want, got, rtol=1e-4, atol=1e-5):
    w_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    g_leaves = tree_flatten_with_path(got)
    assert len(w_leaves) == len(g_leaves)
    for (wp, w), (gp, g) in zip(w_leaves, g_leaves):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert np.asarray(w).shape == g.shape, (wp, gp)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=str(gp))


def _batch(n, image_size, n_classes, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, image_size, image_size, 3)).astype(np.float32)
    y = r.integers(0, n_classes, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("image_size", [12, 7])
def test_cnn_logits_and_grads_match_jax(jax_cnn, image_size):
    jp = jax_cnn
    x, y = _batch(6, image_size, 8, image_size)

    def jloss(p):
        return jv.classification_loss(jv.cnn_apply(p, jnp.asarray(x)),
                                      jnp.asarray(y))

    tp = params_from_numpy(_np_tree(jp), "cpu")

    def tloss(p):
        return tv.classification_loss(tv.cnn_apply(p, torch.from_numpy(x)),
                                      torch.from_numpy(y))

    want_logits = np.asarray(
        jax.jit(lambda p: jv.cnn_apply(p, jnp.asarray(x)))(jp))
    got_logits = tv.cnn_apply(tp, torch.from_numpy(x)).detach().numpy()
    assert np.abs(want_logits - got_logits).max() < LOGIT_TOL
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jp)
    assert abs(float(want_loss) - float(tloss(tp))) < LOGIT_TOL
    _assert_tree_close(want_grads, torch.func.grad(tloss)(tp))


def test_vit_logits_and_grads_match_jax(jax_vit):
    jp, meta = jax_vit
    x, y = _batch(5, 16, 8, 11)

    def jloss(p):
        return jv.classification_loss(
            jv.vit_apply(p, meta, jnp.asarray(x)), jnp.asarray(y))

    tp = params_from_numpy(_np_tree(jp), "cpu")

    def tloss(p):
        return tv.classification_loss(
            tv.vit_apply(p, meta, torch.from_numpy(x)), torch.from_numpy(y))

    want_logits = np.asarray(
        jax.jit(lambda p: jv.vit_apply(p, meta, jnp.asarray(x)))(jp))
    got_logits = tv.vit_apply(tp, meta, torch.from_numpy(x)).detach().numpy()
    assert np.abs(want_logits - got_logits).max() < LOGIT_TOL
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jp)
    assert abs(float(want_loss) - float(tloss(tp))) < LOGIT_TOL
    _assert_tree_close(want_grads, torch.func.grad(tloss)(tp))


@pytest.mark.parametrize("size,k,stride", [(12, 3, 2), (12, 3, 1), (7, 3, 2),
                                           (12, 1, 2), (9, 3, 2)])
def test_conv_same_padding_matches_jax(size, k, stride):
    """JAX "SAME" pads (0, 1) for a 3x3 stride-2 conv on 12x12: the last
    output row of an all-ones conv covers 2 input rows (one padded), its
    first column 3 input columns and its last column 2."""
    r = np.random.default_rng(size * 10 + k + stride)
    x = r.standard_normal((2, size, size, 2)).astype(np.float32)
    w = r.standard_normal((k, k, 2, 4)).astype(np.float32)
    want = np.asarray(jv._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tv._conv(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    assert want.shape == got.shape
    assert np.abs(want - got).max() < 1e-5
    if (size, k, stride) == (12, 3, 2):
        ones = tv._conv(torch.ones(1, 12, 12, 2), torch.ones(3, 3, 2, 1), 2)
        assert float(ones[0, -1, 0, 0]) == 2 * 3 * 2   # 2 rows x 3 cols
        assert float(ones[0, -1, -1, 0]) == 2 * 2 * 2  # 2 rows x 2 cols


def test_group_norm_and_layer_norm_match_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 5, 24)).astype(np.float32) * 3 + 1
    scale = r.standard_normal(24).astype(np.float32)
    bias = r.standard_normal(24).astype(np.float32)
    want = np.asarray(jv._group_norm(*(jnp.asarray(a) for a in
                                       (x, scale, bias))))
    got = tv._group_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    assert np.abs(want - got.numpy()).max() < 1e-5
    want = np.asarray(jv._ln(*(jnp.asarray(a) for a in (x, scale, bias))))
    got = tv._ln(*(torch.from_numpy(a) for a in (x, scale, bias)))
    assert np.abs(want - got.numpy()).max() < 1e-5


def test_port_init_has_reference_structure_and_scales(jax_cnn, jax_vit):
    """Port init draws other random bits but the same tree, shapes and
    per-leaf scales (parity comes from carrying weights across)."""
    gen = torch.Generator().manual_seed(0)
    for jp, tp in [
        (jax_cnn, tv.init_cnn(gen, n_classes=8, width=8, blocks=2,
                              device="cpu")),
        (jax_vit[0], tv.init_vit(gen, image_size=16, patch=4, d_model=32,
                                 layers=2, heads=2, n_classes=8,
                                 device="cpu")[0]),
    ]:
        w = jax.tree_util.tree_flatten_with_path(jp)[0]
        g = tree_flatten_with_path(tp)
        assert [p for p, _ in g] == [
            tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in w]
        for (_, a), (_, b) in zip(w, g):
            assert tuple(a.shape) == tuple(b.shape)
            if a.size > 64:
                assert np.isclose(float(jnp.std(a)), float(b.std()),
                                  rtol=0.2, atol=1e-6)


def test_params_round_trip_through_numpy(jax_cnn):
    jp = jax_cnn
    back = params_to_numpy(params_from_numpy(_np_tree(jp), "cpu"))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(back)):
        assert np.array_equal(np.asarray(a), b)


def test_accuracy_and_loss_match_jax():
    r = np.random.default_rng(5)
    logits = r.standard_normal((50, 7)).astype(np.float32)
    labels = r.integers(0, 7, 50).astype(np.int32)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    # the mean of 0/1 floats, summed in another order
    assert abs(float(jv.accuracy(jl, jy)) - float(tv.accuracy(tl, ty))) < 1e-6
    assert abs(float(jv.classification_loss(jl, jy))
               - float(tv.classification_loss(tl, ty))) < 1e-6
