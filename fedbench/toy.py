"""Toy cells for the benchmark's CPU tests: the real configurations cut to
a few widths and layers, written with their traffic and limits into a
directory that a ``Catalog`` reads beside the real one.

The toy limits were set from the toy's own CPU readings, by the rule the
real cells follow (program against reference, the TF32 control and the
planted faults of ``faults.py``): Muon's program read at most 2e-5 on every
number (seeds 1, 2, 3 and 2**33 + 7), its control at least 1.7e-4 on
``theta.r1``, 3.5e-4 on ``grad.r1`` and 1.5e-3 on ``change.r3``.  SOAP's
program, over 23 seeds (1-20, 2**31 + 11, 2**33 + 7, 3e9 + 1), read at most
1.4e-5 on ``loss.r1``, 1.7e-2 on ``grad.r1``, 4.0e-3 on ``theta.r1`` and
1.3e-2 on ``change.r3``; its control at least 5.3e-2 on ``grad.r1``; half
of each batch at least 3.1e-4 on ``loss.r1``, one client left out 0.29 on
``theta.r1``, a state left unchanged 1 on ``change.r3`` (seeds 1, 2, 3,
2**33 + 7).
"""
from __future__ import annotations

import json
import os

from fedbench import HERE

CONFIGS = {
    "vit_toy": ("vit_tiny", dict(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=32, image_size=8, num_labels=5),
        dict(n_train=600, n_eval=64)),
    "lm_toy": ("smollm_360m", dict(
        hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=64),
        dict(n_docs=64, tokens_per_doc=200, n_topics=8, seq_len=16,
             n_eval_docs=4, eval_batch=4)),
}
TRAFFIC = dict(n_clients=6, participation=0.5, local_steps=3, batch_size=8,
               beta=0.5, server_lr=1.0, executor="vmap", chunk_size=8,
               wire_dtype="f32", opt_kwargs={})
ALGORITHMS = {"soap_toy": ("fedpac_soap", 0.003), "muon_toy": ("fedpac_muon",
                                                                 0.03)}
LIMITS = {
    "muon_toy": {"grad.r1": 3e-5, "theta.r1": 1e-5, "change.r3": 3e-4},
    "soap_toy": {"loss.r1": 1e-4, "grad.r1": 3e-2, "theta.r1": 4e-2,
                 "change.r3": 5e-2},
}


def write(root) -> list:
    """Write every toy configuration, traffic and cell under ``root``;
    returns the manifest's workload entries."""
    for sub in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def dump(sub, name, obj):
        with open(os.path.join(root, sub, name + ".json"), "w") as f:
            json.dump(obj, f)

    for name, (real, sizes, data) in CONFIGS.items():
        with open(os.path.join(HERE, "configs", real + ".json")) as f:
            cfg = json.load(f)
        cfg.update(sizes, name=name, data=dict(cfg["data"], **data))
        dump("configs", name, cfg)
    wls = []
    for tname, (alg, lr) in ALGORITHMS.items():
        dump("traffic", tname, dict(TRAFFIC, algorithm=alg, lr=lr))
        for cname in CONFIGS:
            wl = {"name": f"{cname}.{tname}", "config": cname,
                  "traffic": tname, "chips": 1}
            dump("cells", wl["name"],
                 {"limits": LIMITS[tname]})
            wls.append(wl)
    return wls


def manifest(workloads) -> dict:
    return {"workloads": workloads,
            "end_to_end": [{"name": n, "unit": u} for n, u in (
                ("round_s", "s"), ("peak_mem_GiB", "GiB"),
                ("setup_s", "s"))],
            "per_layer": []}
