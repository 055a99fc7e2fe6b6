"""The port's checkpoints against the JAX package's on-disk format: a
server state written by either package loads in the other with equal
params, g_G, Theta (None leaves included) and meta, the flattened key
strings agree, bf16 leaves round-trip as raw bits without ``ml_dtypes``,
``CheckpointManager`` keeps the last N steps, and the tracer's identity
continues across a restore.  The trees are the CNN's params and the
Thetas of SOAP, Sophia, AdamW, Muon and SGD, filled from a seeded numpy
generator.

Tolerance: exact (bitwise) everywhere.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.checkpoint import store as jax_store
from repro.core import init_server as jax_init_server
from repro.core import zero_theta as jax_zero_theta
from repro.core.engine import make_controller as jax_controller
from repro.models.vision import init_cnn as jax_init_cnn
from repro_torch import optim
from repro_torch.checkpoint import (
    CheckpointManager, latest_step, load_meta, load_pytree,
    load_server_state, save_pytree, save_server_state,
)
from repro_torch.checkpoint import store
from repro_torch.convert import params_from_numpy
from repro_torch.core import ServerState, init_server
from repro_torch.core.algorithms import zero_theta
from repro_torch.core.engine import make_controller
from repro_torch.obs import MemorySink, Tracer
from repro_torch.utils.tree import tree_leaves, tree_map


def _filled(tree, seed):
    """``tree`` (either package's) with every array leaf replaced by
    seeded normals of its shape, as numpy f32."""
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: r.standard_normal(np.shape(x)).astype(np.float32), tree)


def _jax_server(opt_name, beta, seed):
    params = jax_init_cnn(jax.random.key(0), n_classes=4, width=8, blocks=1)
    opt = jax_optim.make(opt_name)
    theta = _filled(jax_zero_theta(opt, params), seed)
    server = jax_init_server(_filled(params, seed + 1), opt,
                             geom=jax_controller(beta))
    return dataclasses.replace(server, theta=theta, g_global=_filled(
        server.g_global, seed + 2), round=7, theta_version=6)


def _port_template(jax_server, opt_name, beta):
    """A fresh port server of the same structures (zeros)."""
    params = params_from_numpy(jax.tree.map(np.zeros_like,
                                            jax_server.params), "cpu")
    server = init_server(params, geom=make_controller(beta, device="cpu"))
    return dataclasses.replace(server, theta=zero_theta(
        optim.make(opt_name), params))


def _assert_same(jax_tree, port_tree):
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    got = tree_leaves(port_tree)
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        assert torch.equal(g, torch.from_numpy(np.asarray(w))), path


CASES = [("soap", 0.5), ("sophia", "auto"), ("adamw", 0.3), ("muon", 0.5),
         ("sgd", 0.9)]


@pytest.mark.parametrize("opt_name, beta", CASES)
def test_flattened_keys_match_reference(opt_name, beta):
    jserver = _jax_server(opt_name, beta, 0)
    tserver = _port_template(jserver, opt_name, beta)
    for jt, tt in ((jserver.params, tserver.params),
                   (jserver.theta, tserver.theta)):
        assert list(store._flatten(tt)) == list(jax_store._flatten(jt))
    if opt_name == "soap":   # 1-D leaves carry no L/R: None entries
        assert any(v is None for v in store._flatten(tserver.theta).values())


@pytest.mark.parametrize("opt_name, beta", CASES)
def test_reference_checkpoint_loads_in_the_port(tmp_path, opt_name, beta):
    jserver = _jax_server(opt_name, beta, 1)
    jax_store.save_server_state(jserver, str(tmp_path), jserver.round,
                                telemetry={"run_id": "r", "seq": 4})
    tmpl = _port_template(jserver, opt_name, beta)
    got = load_server_state(tmpl, str(tmp_path))
    _assert_same(jserver.params, got.params)
    _assert_same(jserver.g_global, got.g_global)
    _assert_same(jserver.theta, got.theta)
    assert (got.round, got.theta_version) == (7, 6)
    assert float(got.geom.beta) == float(jserver.geom.beta)
    assert got.geom.adaptive == jserver.geom.adaptive
    assert got.geom.beta.device == tmpl.params["stem"].device
    assert load_meta(str(tmp_path)) == jax_store.load_meta(str(tmp_path))


@pytest.mark.parametrize("opt_name, beta", CASES)
def test_port_checkpoint_loads_in_the_reference(tmp_path, opt_name, beta):
    jserver = _jax_server(opt_name, beta, 2)
    tserver = _port_template(jserver, opt_name, beta)
    tserver = dataclasses.replace(
        tserver, params=params_from_numpy(jserver.params, "cpu"),
        g_global=params_from_numpy(jserver.g_global, "cpu"),
        theta=params_from_numpy(jserver.theta, "cpu"), round=7,
        theta_version=6, geom=dataclasses.replace(
            tserver.geom, beta=torch.tensor(0.25),
            drift_ema=torch.tensor(1.5)))
    save_server_state(tserver, str(tmp_path), 7,
                      telemetry=Tracer(run_id="abc").state())
    jtmpl = dataclasses.replace(jserver, params=jax.tree.map(
        jnp.zeros_like, jserver.params), theta=jax.tree.map(
        jnp.zeros_like, jserver.theta))
    got = jax_store.load_server_state(jtmpl, str(tmp_path))
    for want, out in ((tserver.params, got.params),
                      (tserver.g_global, got.g_global),
                      (tserver.theta, got.theta)):
        _assert_same(out, want)
    assert (got.round, got.theta_version) == (7, 6)
    assert float(got.geom.beta) == 0.25 and float(got.geom.drift_ema) == 1.5
    assert jax_store.load_meta(str(tmp_path))["telemetry"]["run_id"] == "abc"


def test_bf16_leaves_roundtrip_across_packages(tmp_path):
    r = np.random.default_rng(3)
    x = r.standard_normal((3, 5)).astype(np.float32)
    tree = {"w": torch.from_numpy(x).to(torch.bfloat16),
            "b": [None, torch.from_numpy(x[0])]}
    save_pytree(tree, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "port.npz") as z:
        assert z["w"].dtype == np.uint16
        assert json.loads(bytes(z["__meta__"]).decode())["dtypes"] == {
            "w": "bfloat16"}
    jtree = {"w": jnp.asarray(x, jnp.bfloat16), "b": [None, jnp.asarray(
        x[0])]}
    got = jax_store.load_pytree(jtree, str(tmp_path / "port.npz"))
    assert got["w"].dtype == jnp.bfloat16 and got["b"][0] is None
    np.testing.assert_array_equal(np.asarray(got["w"]).view(np.uint16),
                                  tree["w"].view(torch.int16).numpy()
                                  .view(np.uint16))
    jax_store.save_pytree(jtree, str(tmp_path / "ref.npz"))
    back = load_pytree(tree, str(tmp_path / "ref.npz"))
    assert back["w"].dtype == torch.bfloat16 and back["b"][0] is None
    assert torch.equal(back["w"].view(torch.int16),
                       torch.from_numpy(np.asarray(jtree["w"]).view(
                           np.int16)))
    assert torch.equal(back["b"][1], tree["b"][1])
    with pytest.raises(ValueError, match="shape"):
        load_pytree({"w": torch.zeros(2, 2), "b": [None, torch.zeros(5)]},
                    str(tmp_path / "ref.npz"))


def test_manager_keeps_the_last_n_and_continues_the_trace(tmp_path):
    params = {"w": torch.zeros(4, 4)}
    server = init_server(params, geom=make_controller(0.5, device="cpu"))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    sink = MemorySink()
    tracer = Tracer(sinks=(sink,))
    for r in range(1, 5):
        with tracer.span("update", round=r):
            pass
        tracer.round_event(r, {"loss": 1.0 / r})
        server = dataclasses.replace(
            server, params=tree_map(lambda p: p + 1, server.params), round=r)
        mgr.save(server, telemetry=tracer.state())
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    assert latest_step(str(tmp_path)) == 4
    restored = mgr.restore(init_server(params, geom=None))
    assert restored.round == 4 and float(restored.params["w"][0, 0]) == 4.0
    assert restored.theta is None and restored.geom is not None
    meta = mgr.restore_meta()
    resumed = Tracer.from_state(meta["telemetry"], sinks=(MemorySink(),))
    assert (resumed.run_id, resumed.seq, resumed.rounds, resumed.spans) == (
        tracer.run_id, tracer.seq, 4, 4)
    resumed.round_event(5, {"loss": 0.2})
    assert resumed.sinks[0].events[0]["seq"] == tracer.seq
    with pytest.raises(FileNotFoundError):
        latest_step(str(tmp_path / "step_00000003"))
    assert isinstance(restored, ServerState)
