"""Measure matmul_fused's tile shapes on the grouped ViT-Tiny SOAP step.

    python3 tools/tune_matmul_tiles.py

Builds ``kernels/csrc/matmul_fused.cu`` three times, with 128x64 (the
default), 128x128 and 64x128 output tiles (``-DMF_BM``/``-DMF_BN``, one
nvcc each, started together), prints each build's ``ptxas -v`` report and
resident blocks, holds each against the plain version on one step's
products (bound 2(k+2)u sum|a||b|), then times the products of one local
SOAP step at ViT-Tiny, S=5, as SOAP groups them (5 launches):

  * per phase, by CUDA events around 20 launches from prebuilt tables
    (so no host work but the launch is in the time), beside cuBLAS's
    ``bmm``/``baddbmm`` loop over the same products;
  * the whole step through ``matmul_fused_group`` (tables built on the
    host each call), by events and by ``torch.profiler`` device time.

Each tile shape is timed in turns (a, b, c, c, b, a); the best turn is
kept.  Prints the card's name and power limit and, last, a JSON line.
Needs a CUDA device; imports nothing of JAX.
"""
import concurrent.futures
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TILES = ((128, 64), (128, 128), (64, 128))
PHASES = ("EMAs", "Q_L^T G", "G Q_R", "Q_L N", "N Q_R^T")


def main():
    if not torch.cuda.is_available():
        print("tune_matmul_tiles: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import (
        S_VIT, VIT_LEAVES, VIT_TINY, card_line, device_ms, gemm_error,
        gemm_forms, leaf_inputs, step_groups, timed,
    )
    from repro_torch.kernels import build
    from repro_torch.kernels.grouped import arena_layout
    from repro_torch.kernels.ns_ortho import kernel as mf

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    defines = [(f"MF_BM={bm}", f"MF_BN={bn}") for bm, bn in TILES]
    with concurrent.futures.ThreadPoolExecutor(len(defines)) as pool:
        logs = list(pool.map(lambda d: build.build(mf.SOURCE, d)[1], defines))
    libs = {}
    for (bm, bn), d, log in zip(TILES, defines, logs):
        name = f"{bm}x{bn}"
        libs[name] = mf.kernel_library(d)
        print(f"{name}: {libs[name].config[4]} threads, "
              f"{libs[name].resident_blocks()} resident blocks")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = [leaf_inputs(m, n, S_VIT, dev, gen)
              for _ in range(VIT_TINY["layers"]) for m, n in VIT_LEAVES]
    groups = step_groups([f for x in leaves for f in gemm_forms(x)])
    for name, lib in libs.items():
        worst = 0.0
        for group in groups:
            got = mf.matmul_fused_group(group, library=lib)
            for p, g, w in zip(group, got, mf.matmul_fused_group_plain(group)):
                worst = max(worst, gemm_error(g, *p, w)[1])
        if worst > 1.0:
            raise AssertionError(f"{name}: err/bound {worst:.3f}")
        print(f"{name}: max err/bound {worst:.3f}", flush=True)

    def prebuilt(group, lib):
        """Launch ``group`` from tables built once (outputs reused)."""
        shapes = tuple((*p[0].shape[:-1], p[1].shape[-1]) for p in group)
        offsets, _, total, _ = arena_layout(shapes)
        arena = torch.empty(total, device=dev)
        rows = [mf.problem_row(*p, arena.data_ptr() + 4 * int(o))
                for p, o in zip(group, offsets[0])]
        tables = mf.group_tables(rows, lib.tile)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run():
            for table, _ in tables:
                if lib.launch(table.ctypes.data, stream) != 0:
                    raise RuntimeError("matmul_fused launch failed")
        run.keep = (arena, tables)
        return run

    def cublas(group):
        def run():
            for a, b, aux, alpha, beta in group:
                if aux is None:
                    torch.bmm(a, b)
                else:
                    torch.baddbmm(aux, a, b, beta=beta, alpha=alpha)
        return run

    def step(lib):
        def run():
            for group in groups:
                mf.matmul_fused_group(group, library=lib)
        return run

    best = {}
    for name in ["cuBLAS", *libs, *reversed(libs), "cuBLAS"]:
        if name == "cuBLAS":
            phases = [timed(cublas(g), reps=20) for g in groups]
            x = dict(phases=phases)
        else:
            lib = libs[name]
            phases = [timed(prebuilt(g, lib), reps=20) for g in groups]
            x = dict(phases=phases, step_ms=timed(step(lib)),
                     step_device_ms=device_ms(step(lib)))
        x["phase_sum"] = sum(phases)
        if name not in best or x["phase_sum"] < best[name]["phase_sum"]:
            best[name] = x
    for name, x in best.items():
        per = ", ".join(f"{p} {t:.3f}" for p, t in zip(PHASES, x["phases"]))
        line = f"{name}: per phase ms {per}; sum {x['phase_sum']:.3f}"
        if "step_ms" in x:
            line += (f"; grouped step {x['step_ms']:.3f} ms (events), "
                     f"{x['step_device_ms']:.3f} ms device")
        print(line)
    print(json.dumps({"tiles": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
