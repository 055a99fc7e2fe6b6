"""Run one cell of the benchmark once and print its result line.

    python3 fedbench/run.py --workload vit_tiny.fedpac_soap.c20 --seed 7 \
        --seconds 50 --trace 0

From the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted`` (rounds in the window), ``failed`` (rounds whose loss is not
finite), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown`` and
``trace_share`` (the trace's busy time over the CUDA events' time around
the traced round, beside its least), and last ``checks``: each number compared with the reference beside its limit
(also the last lines of standard error).  Exits 2 without a result when
there is no CUDA device or fewer than the cell asks for, and 3 when a
module of JAX or of the JAX package is loaded.

Every cache stays in the checkout: the port's nvcc builds in
``build/repro_torch_kernels/`` (the program's own fixed place), Triton's
in ``build/triton_cache/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment():
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build",
                                                  "triton_cache")
    os.environ["USE_FLAX"] = "0"
    # the SmolLM-360M SOAP round runs within a few GiB of the card's memory:
    # on the caching allocator's fixed segments it runs out in round 2; the
    # cells' bounds were measured with this setting
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from fedbench import harness, spec

    manifest = spec.load_manifest()
    wl = spec.workload(manifest, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"fedbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.execute(manifest, wl, spec.Catalog(), seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"fedbench: loaded {found}; the benchmark runs the PyTorch "
              "port without JAX", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
