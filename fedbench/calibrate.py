"""Readings that the limits of a cell are set from, many seeds in one
process (the program's imports and kernels are loaded once).

    python3 fedbench/calibrate.py --workload smollm_360m.fedpac_muon \
        --seeds 11 12 13 14 15 16 --control 3 --out chiprun_out/c.jsonl
    python3 fedbench/calibrate.py --workload smollm_360m.fedpac_muon \
        --seeds 21 22 23 --plant half_batch --out chiprun_out/p.jsonl

For each seed: the program's checked rounds against the reference's (the
lower reading of each number), and on the first ``--control`` seeds also
the control (the reference with TF32 products) and the planted faults
(``reference.fedround.FAULTS``) against the reference (the upper
readings), and the reference against itself fed in blocks of half the rows
(how far summation order alone moves a number).  With ``--plant F`` the
program runs with fault F of ``faults.PLANTS`` planted underneath, and the
reference reads F too where it has it.  Each reading is judged with the
cell's limits (``correct``, and each number beside its limit), as a run
judges the program.  Each line also carries the per-leaf norms that the
numbers are taken from (``leaves``; the program's line the reference's,
``ref_leaves``, too), which show the leaf that sets a worst-leaf gap.  One
JSON line a reading.  Not part of a benchmark run.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="seeds (the first ones) that also read the control "
                         "and the faults")
    ap.add_argument("--plant", default=None,
                    help="a fault of faults.PLANTS, planted in the program")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build",
                                                  "triton_cache")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch

    from fedbench import checks, harness, spec
    from fedbench.faults import PLANTS
    from fedbench.reference.fedround import FAULTS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cat = spec.Catalog()
    wl = spec.workload(spec.load_manifest(), args.workload)
    cfg, traffic = cat.config(wl["config"]), cat.traffic(wl["traffic"])
    cell = cat.cell(wl["name"])
    plant = PLANTS[args.plant]() if args.plant else None
    with open(args.out, "a") as out:
        def leaves(reading):
            return {k: reading[k] for k in ("grad", "theta", "change")}

        def emit(kind, values, **rec):
            ok, chk = checks.judge(values, cell["limits"])
            rec = dict(workload=wl["name"], seed=seed, kind=kind,
                       correct=ok, checks=chk, values=values, **rec)
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps(rec), flush=True)

        for i, seed in enumerate(args.seeds):
            run = harness.Run(wl, cfg, traffic, cell, seed=seed, seconds=0,
                              trace=False, device=args.device, plant=plant)
            t0 = time.perf_counter()
            run.setup()
            t_prog = time.perf_counter() - t0
            run.free_program()
            t0 = time.perf_counter()
            ref = run.reference()
            t_ref = time.perf_counter() - t0
            emit(f"program_{args.plant}" if plant else "program",
                 checks.values(run.prog, ref),
                 setup_rounds_s=run.setup_rounds, reference_s=t_ref,
                 program_s=t_prog, loss=run.prog["loss"],
                 ref_loss=ref["loss"], leaves=leaves(run.prog),
                 ref_leaves=leaves(ref))
            kinds = []
            if plant is not None and args.plant in FAULTS:
                kinds.append((args.plant, {"fault": args.plant}))
            if i < args.control:
                kinds += [("control", {"lowp": True})] + [
                    (f, {"fault": f}) for f in FAULTS if f != args.plant]
                kinds.append(("reference_half_blocks", {"micro_scale": 0.5}))
            for kind, kw in kinds:
                other = run.reference(**kw)
                emit(kind, checks.values(other, ref), leaves=leaves(other))
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
