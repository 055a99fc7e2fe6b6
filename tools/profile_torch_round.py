"""Profile one round of the PyTorch port on the GPU.

    python3 tools/profile_torch_round.py [--algorithm NAME] [--qblock]
                                         [--eig-method qr|ns]
                                         [--runtime sync|async]
                                         [--population serial|pipelined]
                                         [--scenario vit-tiny|llama-60m]
                                         [--out DIR]

Runs a ViT-Tiny path of ``chip_smoke.py`` (10 clients at participation
0.5, K=10; ``fedpac_soap`` by default, Sophia at lr 2e-2 and
``hessian_freq=10`` as ``chip_smoke.py`` runs it, a ``*_light`` variant
at Table 6's rank 4; ``--qblock`` puts both uploads on the int8 wire with
error feedback; ``--runtime async`` runs the buffered-async runtime as
``chip_smoke.py`` does, 5 buffered of 10 in flight, where a round is one
flush and the dispatches it waits for, and also prints the flush's
dispatches; ``--population`` runs ``chip_smoke.py``'s population path
instead — ``fedpac_sophia`` on the qblock wire with error feedback, a
cohort of 16 from 10^6 ids, K=5, 24 state slots — as the serial round or
as the 4-chunk pipeline, and also prints the traced round's
``pipeline_bubble`` and state spills; ``--scenario llama-60m`` runs
``chip_smoke.py``'s full-width LLaMA-60M path instead of ViT-Tiny —
``lm_zipf`` at vocab 32000, seq 256, batch 16, 8 clients at participation
0.25, K=5, with the algorithm's own defaults), warms up one round, then
traces one round with
``torch.profiler`` (CPU and CUDA activities) and a ``MemorySink``
attached (so the round's spans wait for the card, as a traced round's
do: an async flush's dispatches then run one after another) and prints: the round's wall time, the summed device time of all
CUDA kernels and the device-busy share (the union of the device
operations' intervals over the window, not the sum of their times), for
each program span its host ms and the card's idle ms while it was the
innermost span open (both from the spans' ``t0_ns``/``t1_ns`` stamps,
on the profiler's clock), the round's counters, device time grouped by
kind of work (with the largest kernels of each group, so the grouping
can be checked), and the top operators by device time and by host time.  The full tables go to
``<out>/profile_round.txt`` (default ``build/profile/``, gitignored).
Needs a CUDA device; imports nothing of JAX.
"""
import argparse
import collections
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# device-time groups, matched in order against kernel/operator names
GROUPS = [
    ("matmul_fused kernel", ("matmul_fused",)),
    ("newton_schulz kernel", ("newton_schulz",)),
    ("adam_moments kernel", ("adam_moments",)),
    ("sophia_update kernel", ("sophia_update",)),
    ("quantize kernel", ("qblock_quantize",)),
    ("dequant_accumulate kernel", ("dequant_accumulate",)),
    # the low-rank codecs' SVD (cuSOLVER's bidiagonalisation and Jacobi
    # kernels), ahead of the QR group's shared Householder patterns
    ("SVD (cuSOLVER gesvd/gesvdj)",
     ("gesvd", "svd", "jacobi", "gebrd", "bdsqr", "orgbr")),
    # cuSOLVER's and MAGMA's own kernel names; a bare "qr" would also
    # match "sqrt"
    ("QR refresh (cuSOLVER geqrf/orgqr)",
     ("geqr", "orgqr", "ungqr", "larf", "householder", "cusolver",
      "magma")),
    ("GEMM (cuBLAS: model, refresh product)", ("gemm", "sgemm", "cutlass",
                                               "xmma", "gemv")),
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit")),
    ("elementwise / reduction", ("elementwise", "reduce", "vectorized",
                                 "unrolled", "softmax", "norm", "index",
                                 "cat", "copy", "fill")),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algorithm", default="fedpac_soap")
    ap.add_argument("--qblock", action="store_true",
                    help="qblock codec on both uploads, error feedback on")
    ap.add_argument("--eig-method", choices=("qr", "ns"), default=None,
                    help="SOAP's eigenbasis refresh (default: SOAP's, qr)")
    ap.add_argument("--runtime", choices=("sync", "async"), default="sync")
    ap.add_argument("--population", choices=("serial", "pipelined"),
                    default=None,
                    help="chip_smoke.py's ViT-Tiny population path")
    ap.add_argument("--scenario", choices=("vit-tiny", "llama-60m"),
                    default="vit-tiny")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_round: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import (
        ASYNC_SEED, LIGHT_RANK, LM_FL, POP_SIZE, POP_VIT, QBLOCK, SOPHIA_LR,
        async_config, card_line, llama60m_spec, pop_scenario, vit_tiny_spec,
    )
    from fedbench import devtrace, spanidle
    from repro_torch.api import build_experiment, materialize, resolve
    from repro_torch.obs import MemorySink, attach
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    spec = vit_tiny_spec()
    kw = dict(QBLOCK) if args.qblock else {}
    if resolve(args.algorithm).optimizer == "sophia":
        kw.update(lr=SOPHIA_LR, hessian_freq=10)
    if args.algorithm.endswith("_light"):
        kw.update(svd_rank=LIGHT_RANK)
    if args.runtime == "async":
        kw.update(seed=ASYNC_SEED, async_cfg=async_config())
    opt_kwargs = ({} if args.eig_method is None
                  else {"eig_method": args.eig_method})
    if args.scenario == "llama-60m":
        kw = dict(QBLOCK) if args.qblock else {}
        scn = materialize(llama60m_spec(), seed=0, device="cuda")
        exp = build_experiment(args.algorithm, scenario=scn, rounds=3,
                               opt_kwargs=opt_kwargs, **LM_FL, **kw)
    elif args.population is not None:
        import tempfile
        args.algorithm = "fedpac_sophia"
        scn = pop_scenario(spec, POP_SIZE, "cuda")
        os.makedirs(args.out, exist_ok=True)
        kw = dict(POP_VIT, pipeline=args.population == "pipelined",
                  spill_dir=tempfile.mkdtemp(prefix="spill_", dir=args.out))
        exp = build_experiment(args.algorithm, scenario=scn, **kw)
    else:
        scn = materialize(spec, seed=0, n_clients=spec.n_clients,
                          device="cuda")
        exp = build_experiment(args.algorithm, scenario=scn,
                               participation=0.5, rounds=3,
                               opt_kwargs=opt_kwargs, **kw)
    print(f"{args.algorithm} {args.runtime} {kw} {opt_kwargs}")
    exp.run_round()                      # warm-up: compiles, allocator
    t0 = time.perf_counter()
    exp.run_round()
    plain_wall = time.perf_counter() - t0
    sched = getattr(exp, "scheduler", None)    # the async runtime's
    d0 = sched._seq if sched is not None else 0
    sink = MemorySink()
    attach(exp, sink)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        exp.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        window = (time.time_ns() - t0_ns) * 1e-9
    attach(exp)

    events = prof.key_averages()
    dev_attr = ("self_device_time_total" if hasattr(events[0],
                                                    "self_device_time_total")
                else "self_cuda_time_total")
    kernel_us = collections.Counter()
    for e in events:
        us = getattr(e, dev_attr)
        if us > 0 and getattr(e, "device_type", None) is not None \
                and str(e.device_type).endswith("CUDA"):
            kernel_us[e.key] += us
    total_ms = sum(kernel_us.values()) / 1e3
    # the profiler stamps device operations on the epoch clock the spans'
    # t0_ns/t1_ns read, so both go on the window's seconds directly
    ops = [devtrace.Op(n, (s - t0_ns) * 1e-9, d * 1e-9)
           for n, s, d in devtrace.device_ops(prof)]
    busy = devtrace.busy_seconds(ops, 0.0, window)
    print(f"round {exp.server.round}: wall {wall:.3f} s traced, "
          f"{plain_wall:.3f} s untraced; CUDA kernel time {total_ms:.1f} ms; "
          f"device busy {100 * busy / window:.1f}% of the traced window "
          "(the union of the device operations' intervals)")
    spans = [(e["phase"], (e["t0_ns"] - t0_ns) * 1e-9,
              (e["t1_ns"] - e["t0_ns"]) * 1e-9)
             for e in sink.events if e["event"] == "span"]
    host = collections.Counter()
    for name, _, dur in spans:
        host[name] += dur
    idle = spanidle.idle_by_span(ops, spans, 0.0, window)
    print("  span                host ms   card idle ms (innermost span)")
    for name in sorted(set(host) | set(idle), key=lambda n: -host.get(n, 0)):
        print(f"  {name:18s} {1e3 * host.get(name, 0.0):9.1f} "
              f"{1e3 * idle.get(name, 0.0):12.1f}")
    counts = sink.rounds()[-1].get("counters", {})
    print("  counters " + ", ".join(f"{k} {v}" for k, v in counts.items()
                                    if v))
    if sched is not None:
        print(f"  the traced flush waited for {sched._seq - d0} "
              f"dispatches (one client each)")
    if args.population is not None:
        rec = exp.history[-1]
        print(f"  population {args.population}: pipeline_bubble "
              f"{rec.get('pipeline_bubble', 'n/a (serial)')}, stage wait "
              f"{rec.get('pipeline_stage_wait_s', 'n/a')} s, restore wait "
              f"{rec.get('pipeline_restore_wait_s', 'n/a')} s, state peak "
              f"{rec['state_peak']}, {rec['state_spills']} spills so far")
    grouped = collections.Counter()
    members = collections.defaultdict(list)
    for name, us in kernel_us.most_common():
        low = name.lower()
        label = next((lb for lb, pats in GROUPS
                      if any(p in low for p in pats)), "other")
        grouped[label] += us
        members[label].append((name, us))
    for label, us in grouped.most_common():
        print(f"  {label:42s} {us / 1e3:9.2f} ms "
              f"({100 * us / 1e3 / max(total_ms, 1e-9):5.1f}%)")
        for name, k_us in members[label][:6]:   # what each group holds
            print(f"      {k_us / 1e3:9.2f} ms  {name[:90]}")
    by_dev = events.table(sort_by=dev_attr, row_limit=25)
    by_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    print(by_dev)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "profile_round.txt")
    with open(path, "w") as f:
        f.write(by_dev + "\n\n" + by_cpu + "\n")
    print(f"tables written to {os.path.relpath(path, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
