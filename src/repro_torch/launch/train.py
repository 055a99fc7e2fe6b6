"""Single-process training entry point (counterpart of
``repro/launch/train.py``): FedPAC/FedSOA federated pre-training of a
(reduced or paper-scale) transformer LM on synthetic non-IID LM data,
through ``fed.FederatedExperiment`` on ``--device`` (default ``cuda``;
raises without a card, never falls back to the CPU).  Weights come from
``--seed``, drawn by a generator on that device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \\
      --reduced --algorithm fedpac_soap --rounds 20 --device cpu

``main`` returns 0 and prints the reference's ``final:`` line; a caller
that passes a list as ``history`` gets the round records in it.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data import make_lm_corpus
from repro_torch.data.synth import lm_batches
from repro_torch.fed import FedConfig, FederatedExperiment
from repro_torch.models import model as M
from repro_torch.utils.hw import resolve_device


def main(argv=None, history=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--algorithm", default="fedpac_soap")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--participation", type=float, default=0.5)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--hetero", type=float, default=0.8)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append a structured JSONL round trace (spans, "
                         "metrics, telemetry) to PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch)
           if args.reduced else configs.get_config(args.arch))
    cfg = cfg.replace(dtype="float32")
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    n_par = M.num_params(cfg)
    print(f"arch={cfg.name} params={n_par/1e6:.1f}M "
          f"algorithm={args.algorithm} device={dev}")

    streams = make_lm_corpus(args.clients, 200_000, vocab=cfg.vocab_size,
                             hetero=args.hetero, seed=args.seed)
    eval_stream = np.concatenate([s[:20_000] for s in streams])
    ex, ey = lm_batches(eval_stream, seq_len=args.seq, batch=16, steps=1,
                        seed=123)
    eval_batch = {"tokens": torch.from_numpy(ex[0]).to(dev),
                  "labels": torch.from_numpy(ey[0]).to(dev)}

    def loss_fn(p, batch):
        return M.loss_fn(p, batch, cfg)

    def eval_fn(p):
        with torch.no_grad():
            return {"eval_loss": M.loss_fn(p, eval_batch, cfg)}

    def batch_fn(cid, rng):
        s = streams[cid]
        starts = rng.integers(0, len(s) - args.seq - 1, args.batch)
        idx = starts[:, None] + np.arange(args.seq + 1)
        w = s[idx]
        return {"tokens": w[:, :-1], "labels": w[:, 1:]}

    fed = FedConfig(algorithm=args.algorithm, n_clients=args.clients,
                    participation=args.participation, rounds=args.rounds,
                    local_steps=args.local_steps, lr=args.lr, beta=args.beta,
                    seed=args.seed, device=str(dev))
    exp = FederatedExperiment(fed, params, loss_fn, batch_fn, eval_fn)
    mgr = None
    if args.checkpoint_dir:
        from repro_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.checkpoint_dir)
    if args.trace:
        from repro_torch.obs import JsonlSink, Tracer
        sink = JsonlSink(args.trace, append=True)
        state = None
        if mgr:
            # resume the persisted trace identity (same run_id, continued
            # seq numbering) so restored runs append to the same trace
            try:
                state = mgr.restore_meta().get("telemetry")
            except FileNotFoundError:
                pass
        exp.tracer = Tracer.from_state(state, sinks=(sink,))
    hist = []
    for r in range(fed.rounds):
        rec = exp.run_round()
        hist.append(rec)
        exp.log_round(rec, r)
        if mgr and (r + 1) % args.checkpoint_every == 0:
            mgr.save(exp.server, telemetry=exp.tracer.state())
    if args.trace:
        sink.close()
    print(f"final: train_loss={hist[-1]['loss']:.4f} "
          f"eval_loss={hist[-1]['eval_loss']:.4f} "
          f"comm={exp.comm_bytes_per_round()/1e6:.1f}MB/round")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)
    if history is not None:
        history.extend(hist)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
