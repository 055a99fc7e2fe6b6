"""Quickstart for the PyTorch/H100 port: Local SOAP against FedPAC_SOAP,
and FedPAC_Sophia on the int8 (qblock) wire.

Federated CIFAR-like classification on non-IID clients (the registered
``cifar_like_cnn`` scenario: Dirichlet(0.1) label skew, 10 clients), run
through ``repro_torch`` — SOAP's rotated Adam step, Sophia's clipped
diagonal step and the int8 wire's quantize / dequantize-accumulate on the
hand-written Hopper kernels.  Runs on the GPU by default:

  python examples/torch_quickstart.py               # CUDA (raises without)
  QUICKSTART_DEVICE=cpu python examples/torch_quickstart.py   # plain path

QUICKSTART_ROUNDS / QUICKSTART_SAMPLES shrink the run.
QUICKSTART_TRACE=path.jsonl appends the structured trace of every arm
(phase spans and per-round telemetry: drift, beta, staleness histogram,
per-client geometry distances — see ``repro_torch.obs``), in the
reference quickstart's format.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import dataclasses  # noqa: E402

from repro_torch.api import (  # noqa: E402
    build_experiment, materialize, resolve_scenario,
)

ROUNDS = int(os.environ.get("QUICKSTART_ROUNDS", "15"))
N = int(os.environ.get("QUICKSTART_SAMPLES", "3000"))
DEVICE = os.environ.get("QUICKSTART_DEVICE", "cuda")
TRACE = os.environ.get("QUICKSTART_TRACE")

spec = resolve_scenario("cifar_like_cnn")
scenario = materialize(
    dataclasses.replace(spec, source_kwargs=dict(spec.source_kwargs, n=N)),
    device=DEVICE)

ARMS = [
    ("local_soap", "local_soap", {}),
    ("fedpac_soap", "fedpac_soap", {}),
    # the repo's vision Sophia lr; int8 uploads with error feedback
    ("fedpac_sophia+qblock", "fedpac_sophia",
     dict(lr=2e-2, delta_codec="qblock", theta_codec="qblock")),
]

for label, algo, kw in ARMS:
    exp = build_experiment(algo, scenario=scenario, participation=0.5,
                           rounds=ROUNDS, local_steps=5, beta=0.5,
                           device=DEVICE, **kw)
    if TRACE:
        from repro_torch.obs import JsonlSink, attach
        attach(exp, JsonlSink(TRACE, append=True))
    hist = exp.run()
    print(f"{label:20s} acc={hist[-1]['test_acc']:.3f} "
          f"loss={hist[-1]['loss']:.3f} drift={hist[-1]['drift']:.2e} "
          f"comm={exp.comm_bytes_per_round() / 1e6:.2f} MB/round "
          f"(label_tv={exp.scenario.partition_stats['label_tv']:.2f})")
