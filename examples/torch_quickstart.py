"""Quickstart for the PyTorch/H100 port: Local SOAP against FedPAC_SOAP.

Federated CIFAR-like classification on non-IID clients (the registered
``cifar_like_cnn`` scenario: Dirichlet(0.1) label skew, 10 clients), run
through ``repro_torch`` — SOAP's rotated Adam step on the hand-written
Hopper kernels.  Runs on the GPU by default:

  python examples/torch_quickstart.py               # CUDA (raises without)
  QUICKSTART_DEVICE=cpu python examples/torch_quickstart.py   # plain path

QUICKSTART_ROUNDS / QUICKSTART_SAMPLES shrink the run.
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

spec = resolve_scenario("cifar_like_cnn")
scenario = materialize(
    dataclasses.replace(spec, source_kwargs=dict(spec.source_kwargs, n=N)),
    device=DEVICE)

for algo in ["local_soap", "fedpac_soap"]:
    exp = build_experiment(algo, scenario=scenario, participation=0.5,
                           rounds=ROUNDS, local_steps=5, beta=0.5,
                           device=DEVICE)
    hist = exp.run()
    print(f"{algo:14s} acc={hist[-1]['test_acc']:.3f} "
          f"loss={hist[-1]['loss']:.3f} drift={hist[-1]['drift']:.2e} "
          f"comm={exp.comm_bytes_per_round() / 1e6:.2f} MB/round "
          f"(label_tv={exp.scenario.partition_stats['label_tv']:.2f})")
