"""Dry-run of the production meshes (counterpart of
``repro/launch/dryrun.py``): build every (arch x input shape x mesh)
step on DTensors over a fake process group of 256 (pod) or 512
(multipod) ranks, run it once on fake tensors, and read the roofline
terms from what ran.

The reference lowers and compiles each step with XLA against 512 forced
host devices.  Here nothing is compiled and no memory is allocated:
params, optimizer states, caches and inputs are DTensors whose local
shards are fake tensors (``launch.specs``), and the step "lowers" by
running once under ``FakeTensorMode`` on rank 0 of a fake process group
(``fake_process_group``), inside ``LoweringMode``: a ``CommDebugMode``
that also adds up, on that rank, the bytes of every collective's result
(per op kind), the bytes every other op reads and writes, and its FLOPs
by ``FlopCounterMode``'s formulas, to which it adds the QR's, which
``FlopCounterMode`` has none for (``qr_flops``).  Its
``implicit_replication`` treats the plain tensors the model makes
(positions, masks) and the optimizer's ``init`` makes (SOAP's factors) as
replicated.

The train step runs at ``step=0``: the step that holds SOAP's eigenbasis
refresh (its power-iteration product and QR, the QR on the replicated
product: ``sharding.ops.qr_q``) and Sophia's curvature refresh,
as the reference's traced step holds both branches of its ``lax.cond``;
``step=1`` would count none of either.  The ``fed_round`` step is
``make_fed_round_step(..., client_loop=True)``: the clients in a Python
loop with plain autograd, since ``torch.func`` (the cohort's ``vmap``)
takes no DTensors.  Against the reference's program, which ``vmap``s one
client's ``lax.scan`` over the cohort, the loop runs each op once a
client on a client's tensors (the same FLOPs and unfused bytes, and the
same collective bytes in C times as many collectives of 1/C the size);
each client's microbatches keep the batch's sharding over the batch axes
(``steps._client_microbatch``: no collective moves a row, where XLA's
propagation decides how the (C, K, micro) split lies); and the optimizer
state a client makes in the round is replicated where its ``init`` makes
plain tensors (SOAP's factors), where XLA may shard it.

``analyze`` fills the reference's record.  Its FLOPs and bytes are the
whole program's, each op counted once: the step runs once more on plain
fake tensors of the arguments' global shapes (``Lowering.run_whole``),
so work that every rank of the sharded run repeats (a head dim gathered,
replicated optimizer math) is not multiplied by the ranks.  Bytes are
every op's reads and writes, unfused, as the reference's unoptimized
HLO counts them.  ``rank_flops`` adds what rank 0 of the sharded run
executes, replicated work included.  The roofline terms use the H100's
datasheet constants (``launch.mesh``), not a measurement.  What XLA
reports and a fake run cannot (temp and peak memory, the fused-HLO byte
estimate, the compile time) is ``None``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun.jsonl

The fake process group is global to the process: ``main`` (or a caller
that owns the process) opens it with ``fake_process_group`` and closes
it when done.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import sys
import time
from typing import Any, Optional

import torch

from repro_torch import configs, optim
from repro_torch.launch import specs as S
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (
    HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, make_production_mesh,
)
from repro_torch.models import model as M
from repro_torch.sharding.partitioning import (
    SERVE_FSDP_RULES, SERVE_RULES, TRAIN_RULES,
)
from repro_torch.utils.tree import tree_leaves, tree_map

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
                "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8}
_SHAPE_RE = re.compile(r"(bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64|pred)"
                       r"\[([0-9,]*)\]")
# torch.distributed's functional collectives, by the reference's op kinds
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def collective_bytes_from_hlo(hlo: str):
    """Sum result sizes of collective ops in XLA HLO text (the
    reference's parser, kept for its records); returns (total_bytes,
    per_op)."""
    per_op = {k: 0 for k in COLLECTIVE_OPS}
    for line in hlo.splitlines():
        stripped = line.strip()
        for op in COLLECTIVE_OPS:
            # match e.g. `%ag = bf16[...] all-gather(...)` incl. -start forms
            if f" {op}(" in stripped or f" {op}-start(" in stripped:
                if "=" not in stripped:
                    continue
                rhs = stripped.split("=", 1)[1]
                # result type(s): shapes before the op token
                head = rhs.split(op, 1)[0]
                nbytes = 0
                for dt, dims in _SHAPE_RE.findall(head):
                    n = 1
                    if dims:
                        for d in dims.split(","):
                            n *= int(d)
                    nbytes += n * _DTYPE_BYTES[dt]
                per_op[op] += nbytes
                break
    return sum(per_op.values()), per_op


def _tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _local_bytes(tree) -> int:
    """Bytes of one rank's shards of a tree of DTensors (plain tensors
    whole)."""
    return sum(getattr(x, "_local_tensor", x).numel() * x.element_size()
               for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def qr_flops(a_shape, *args, out_shape=None, **kwargs) -> int:
    """Householder QR FLOPs of a (..., m, n) operand, a ``FlopCounterMode``
    formula: 2 l s^2 - 2 s^3 / 3 a matrix (s the short side, l the long),
    4 n^3 / 3 for an n x n one, times the batch.  Forming Q is not
    counted, as LAPACK's count for ``geqrf`` leaves it out."""
    *batch, m, n = a_shape
    short, long_ = min(m, n), max(m, n)
    count = 1
    for b in batch:
        count *= b
    return count * (6 * long_ * short * short - 2 * short ** 3) // 3


def _lowering_mode_class():
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    class LoweringMode(CommDebugMode):
        """``CommDebugMode`` that also counts, over the ops one rank runs
        on its local shards: each collective's result bytes by op kind,
        the bytes every other (non-view) op reads and writes, and FLOPs
        by ``FlopCounterMode``'s formulas."""

        def __init__(self):
            super().__init__()
            self.collective = {k: 0 for k in COLLECTIVE_OPS}
            self.op_bytes = 0
            self.flops = FlopCounterMode(
                display=False,
                custom_mapping={torch.ops.aten.linalg_qr: qr_flops})

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or not isinstance(
                    func, torch._ops.OpOverload):
                return out
            kind = _COLLECTIVE_KIND.get(func._opname)
            if kind is not None:
                self.collective[kind] += _tensor_bytes(out)
            elif not func.is_view and func.namespace == "aten":
                self.op_bytes += _tensor_bytes(args) + _tensor_bytes(out)
                self.flops._count_flops(func._overloadpacket, out, args,
                                        kwargs or {})
            return out

    return LoweringMode


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0): collectives do no communication and return tensors of
    the right shapes.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def model_flops(cfg, shape: S.InputShape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) useful-FLOPs yardstick."""
    n_total = M.num_params(cfg)
    n_active = n_total
    if cfg.moe is not None:
        m = cfg.moe
        # routed expert params not in the top-k are inactive per token
        expert_params = 3 * cfg.d_model * m.d_ff_expert
        routed_layers = cfg.num_layers - m.first_dense_layers
        n_active -= routed_layers * (m.num_experts - m.top_k) * expert_params
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else
                                   (shape.seq_len if shape.kind == "prefill"
                                    else 1))
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n_active * tokens


@dataclasses.dataclass
class Lowering:
    """A step and its DTensor arguments, built under ``fake_mode``.
    ``warmup`` is an optional (step, args) of the same ops at a smaller
    size (the fed round at one client)."""
    step_fn: Any
    args: tuple
    fake_mode: Any
    mesh: Any
    warmup: Optional[tuple] = None

    def run(self):
        """Runs the step on the fake shards; returns (outputs, the
        ``LoweringMode`` that watched it).  The counted run comes second:
        a first run fills DTensor's sharding propagation cache, whose
        shape inference runs each new op once more at its global shape,
        through the same modes.  That first run is the step itself, or
        ``warmup``: a fed round's clients repeat one client's ops, so a
        one-client round fills the cache for all of them."""
        from torch.distributed.tensor.experimental import (
            implicit_replication,
        )
        first = self.warmup or (self.step_fn, self.args)
        for fn, args in (first, (self.step_fn, self.args)):
            mode = _lowering_mode_class()()
            with self.fake_mode, mode, implicit_replication():
                out = fn(*args)
        return out, mode

    def run_whole(self):
        """Runs the step once on plain fake tensors of the arguments'
        global shapes, as one device would run the whole program, and
        returns the ``LoweringMode`` that counted it: each op once."""
        from torch.distributed.tensor import DTensor
        with self.fake_mode:
            args = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype)
                            if isinstance(x, DTensor) else x, self.args)
        mode = _lowering_mode_class()()
        with self.fake_mode, mode:
            self.step_fn(*args)
        return mode


def build_lowering(arch: str, shape_name: str, mesh, *, opt_name: str = "muon",
                   step_kind=None, seq_shard: bool = False, beta: float = 0.5,
                   fed_clients: int = 8, fed_local_steps: int = 2,
                   cfg=None, shape_override=None, serve_fsdp: bool = False,
                   gg_dtype=torch.float32, state_dtype=None):
    """(cfg, shape, ``Lowering``) of one combination: the reference's opt
    defaults (Muon; SOAP with ``state_dtype`` bf16).  The train step runs
    at ``step=0``, the step that holds the refreshes; ``fed_round`` is the
    client loop over ``fed_clients`` x ``fed_local_steps`` microbatches,
    from ``theta = opt.get_precond(opt.init(params))``, at seed 0."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or configs.get_config(arch)
    shape = shape_override or S.INPUT_SHAPES[shape_name]
    kind = step_kind or shape.kind
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    warmup = None

    with fake_mode:
        if kind in ("train", "fed_round"):
            rules = TRAIN_RULES
            lr = optim.DEFAULT_LR.get(opt_name, 1e-2)
            opt_kw = {}
            if opt_name == "soap":
                opt_kw["state_dtype"] = state_dtype or torch.bfloat16
            elif opt_name == "muon" and state_dtype is not None:
                opt_kw["state_dtype"] = state_dtype
            opt = optim.make(opt_name, **opt_kw)
            params = S.param_specs(cfg, mesh, rules)
            batch = S.token_inputs(cfg, shape, mesh, rules=rules,
                                   with_labels=True)
            gg = S.like_tree_specs(tree_map(
                lambda p: torch.empty(tuple(p.shape), dtype=gg_dtype,
                                      device="meta"), params), mesh)
            batch_axes = tuple(a for a in ("pod", "data")
                               if a in mesh.mesh_dim_names)
            if kind == "train":
                opt_state = S.opt_state_specs(opt, params, mesh)
                step_fn = ST.make_train_step(cfg, opt, lr=lr, beta=beta,
                                             seq_shard=seq_shard,
                                             batch_axes=batch_axes)
                args = (params, opt_state, gg, batch, 0)
            else:
                theta = S.precond_specs(opt, params, mesh)

                def fed_step(clients):
                    return ST.make_fed_round_step(
                        cfg, opt, lr=lr, beta=beta, clients=clients,
                        local_steps=fed_local_steps, seq_shard=seq_shard,
                        batch_axes=batch_axes, client_loop=True)
                step_fn = fed_step(fed_clients)
                args = (params, theta, gg, batch, 0)
                one = dataclasses.replace(
                    shape, global_batch=shape.global_batch // fed_clients)
                warmup = (fed_step(1), (params, theta, gg, S.token_inputs(
                    cfg, one, mesh, rules=rules, with_labels=True), 0))
        elif kind == "prefill":
            rules = SERVE_FSDP_RULES if serve_fsdp else SERVE_RULES
            params = S.param_specs(cfg, mesh, rules)
            batch = S.token_inputs(cfg, shape, mesh, rules=rules,
                                   with_labels=False)
            step_fn = ST.make_prefill_step(cfg, shape.seq_len)
            args = (params, batch)
        elif kind == "decode":
            rules = SERVE_FSDP_RULES if serve_fsdp else SERVE_RULES
            params = S.param_specs(cfg, mesh, rules)
            ring = shape.name == "long_500k"
            caches = S.cache_specs(cfg, shape, mesh, rules, ring=ring)
            tok_shape = ((shape.global_batch, 1, cfg.num_codebooks)
                         if cfg.num_codebooks > 1 else (shape.global_batch, 1))
            tokens = S._sds(tok_shape, torch.int32, mesh,
                            S.resolve_spec(tok_shape, ("batch", "seq") +
                                           (("codebook",)
                                            if cfg.num_codebooks > 1
                                            else ()), mesh, rules))
            step_fn = ST.make_decode_step(cfg, shape.seq_len - 1)
            args = (params, tokens, caches)
        else:
            raise ValueError(kind)
    return cfg, shape, Lowering(step_fn, args, fake_mode, mesh, warmup)


def analyze(arch, shape_name, mesh_name, lowered: Lowering, cfg, shape):
    """Runs ``lowered`` and fills the reference's record."""
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    n_chips = lowered.mesh.size()
    t0 = time.time()
    out, mode = lowered.run()
    rec["run_s"] = round(time.time() - t0, 1)
    rec["compile_s"] = None          # eager PyTorch: nothing is compiled
    rec["bytes_per_device"] = {
        "argument": _local_bytes(lowered.args),
        "output": _local_bytes(out),
        # XLA's buffer assignment gives these; a fake run frees nothing
        # and reuses nothing, so it has no temp or peak to report
        "temp": None,
        "peak": None,
    }
    whole = lowered.run_whole()
    flops = float(whole.flops.get_total_flops())
    bytes_accessed = float(whole.op_bytes)
    # no fused-HLO estimate: every op's bytes are counted unfused
    rec["hlo_bytes_opt_est"] = None
    rec["hlo_flops"] = flops
    rec["hlo_bytes"] = bytes_accessed
    rec["rank_flops"] = float(mode.flops.get_total_flops())
    per_op = dict(mode.collective)
    cbytes = sum(per_op.values())
    rec["collective_bytes"] = cbytes
    rec["collective_per_op"] = per_op
    # Roofline terms (seconds), the reference's formulas on the card's
    # datasheet constants (launch.mesh): flops and bytes are whole-program
    # totals, collective bytes rank 0's.
    rec["t_compute"] = flops / (n_chips * PEAK_FLOPS_BF16)
    rec["t_memory"] = bytes_accessed / (n_chips * HBM_BW)
    rec["t_collective"] = cbytes / (n_chips * NVLINK_BW)
    dom = max(("compute", "memory", "collective"),
              key=lambda k: rec[f"t_{k}"])
    rec["dominant"] = dom
    mf = model_flops(cfg, shape)
    rec["model_flops_total"] = mf
    rec["model_flops_per_chip"] = mf / n_chips
    rec["useful_flop_ratio"] = mf / flops if flops else None
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--step", default=None,
                    choices=[None, "train", "fed_round", "prefill", "decode"])
    ap.add_argument("--opt", default="muon")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--serve-fsdp", action="store_true")
    ap.add_argument("--gg-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--state-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--lower-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    pairs = []
    archs = configs.ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(S.INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        cfg = configs.get_config(a)
        for sh in shapes:
            if sh == "long_500k" and not cfg.supports_long_decode:
                print(f"SKIP {a} x long_500k (full attention; see DESIGN.md)")
                continue
            pairs.append((a, sh))

    out_f = open(args.out, "a") if args.out else None
    failures = 0
    try:
        for mesh_name in meshes:
            multi = mesh_name == "multipod"
            with fake_process_group(512 if multi else 256):
                mesh = make_production_mesh(multi_pod=multi)
                for a, sh in pairs:
                    failures += _one(a, sh, mesh_name, mesh, args, out_f)
    finally:
        if out_f:
            out_f.close()
    return 1 if failures else 0


def _one(a, sh, mesh_name, mesh, args, out_f) -> int:
    """One combination: prints OK/LOWER-OK or FAIL; returns the
    failures (0 or 1)."""
    tag = f"{a} x {sh} x {mesh_name}"
    try:
        t0 = time.time()
        cfg, shape, lowered = build_lowering(
            a, sh, mesh, opt_name=args.opt, step_kind=args.step,
            seq_shard=args.seq_shard, serve_fsdp=args.serve_fsdp,
            gg_dtype=getattr(torch, args.gg_dtype),
            state_dtype=(getattr(torch, args.state_dtype)
                         if args.state_dtype else None))
        lower_s = time.time() - t0
        if args.lower_only:
            print(f"LOWER-OK {tag} ({lower_s:.0f}s)")
            return 0
        rec = analyze(a, sh, mesh_name, lowered, cfg, shape)
        rec["opt"] = args.opt
        rec["step"] = args.step or shape.kind
        rec["seq_shard"] = args.seq_shard
        rec["serve_fsdp"] = args.serve_fsdp
        rec["gg_dtype"] = args.gg_dtype
        rec["state_dtype"] = args.state_dtype
        rec["lower_s"] = round(lower_s, 1)
        print(f"OK {tag}: dominant={rec['dominant']} "
              f"t_comp={rec['t_compute']:.3e}s "
              f"t_mem={rec['t_memory']:.3e}s "
              f"t_coll={rec['t_collective']:.3e}s "
              f"coll={rec['collective_bytes']} B "
              f"run={rec['run_s']}s")
        if out_f:
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
        return 0
    except Exception as e:  # noqa: BLE001 - report and continue
        print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:300]}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
