"""Smoke test of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's Hopper kernels from this checkout's sources (one
``nvcc`` per CUDA source, all started together, and Triton's), holds each
against its plain PyTorch version on the card at the main path's shapes
(and times kernel, plain version, a PyTorch library yardstick where one
exists, and the card's bound; the grouped kernels also one leaf or
product a launch), then drives the port's paths through
``repro_torch.api.build_experiment``, each with the launch counters set
to 0 just before it and read just after:

  * SOAP: ``local_soap`` and ``fedpac_soap`` at ViT-Tiny width, and
    ``fedpac_soap`` on the registered ``cifar_like_cnn``;
  * Sophia: ``local_sophia``, ``fedpac_sophia`` and ``fedpac_sophia`` with
    the qblock int8 wire on both channels and error feedback, at ViT-Tiny
    width, and that last one on ``cifar_like_cnn``;
  * Muon: ``local_muon`` and ``fedpac_muon`` at ViT-Tiny width (default lr
    3e-2), ``fedpac_soap`` with the Newton–Schulz refresh
    (``eig_method="ns"``) at ViT-Tiny width, and ``fedpac_muon`` on
    ``cifar_like_cnn``;
  * the SGD baselines ``fedavg`` and ``fedcm`` on ``cifar_like_cnn``, whose
    round metrics must all live on the card;
  * the low-rank wire: ``fedpac_soap_light`` (rank-4 SVD Theta upload,
    Table 6's rank) and ``fedpac_muon_light`` with the qblock delta, the
    ``lowrank_svd+qblock`` Theta chain on the bf16 wire and error
    feedback (bf16 factors into the CUDA ``quantize``), at ViT-Tiny
    width; ``scaffold``, ``fedpm_soap`` and ``fedpac_soap`` with the
    ``power_sketch`` Theta upload on ``cifar_like_cnn``, whose round
    metrics must all live on the card.

Then the buffered-asynchronous runtime (``fed.async_runtime``, 10
clients, 5 buffered of 10 in flight, the async quickstart's latency
model, 3 flushes), one client a dispatch: ``fedpac_soap`` at ViT-Tiny
width (K=10; its server saved after flush 2 with ``CheckpointManager``,
restored bitwise into a fresh CUDA template, and its trace continued from
the saved tracer identity), ``fedpac_sophia`` on the qblock wire with
error feedback and ``max_staleness=1`` (discarded arrivals restored into
their residual rows), and ``fedpac_soap`` on ``cifar_like_cnn`` against
the CPU path (simulated fields exact, metrics and telemetry at SOAP's CNN
tolerances).  Each async path checks its trace (schema, contiguous
numbering, one ``client_dropped`` event per dropped or discarded
arrival, the buffer in each staleness histogram, finite telemetry) and
its launches: 5 ``matmul_fused`` a SOAP step of each trained dispatch;
for Sophia one ``sophia_update`` a step and 2 ``quantize`` a dispatch,
and 3 ``dequant_accumulate`` a flush.  The async flush of one-client
qblock messages with unit weights is held bitwise against the sync
``aggregate_wire``, and ``obs.profile_kernels`` prints its "ref" and
"kernel" rows for the five triads at 256x256 and 768x768 and holds each
kernel output against the plain one.

Then the LM path and the continuous-traffic runtime: the published
LLaMA-60M (``configs/llama_60m.py``, unreduced, registered through
``scenarios.lm.register_lm_model``) on ``lm_zipf`` at vocab 32000, seq
256, batch 16, 8 clients at participation 0.25, K=5 — ``fedpac_soap`` 3
rounds (5 ``matmul_fused`` and 11 ``adam_moments`` a step, the untrained
loss at its expectation, the loss falling), ``fedpac_sophia`` and
``fedpac_muon`` 2 rounds (1 ``sophia_update``; 15 ``matmul_fused`` and
4 ``adam_moments`` a step) — with the three kernels also held against
their plain versions at its shapes and ``matmul_fused``/``adam_moments``
timed over one SOAP step; the tiny ``lm_zipf`` against the CPU path; and
``examples/traffic_quickstart.py``'s stream (diurnal arrivals, churn,
anytime eval, a hot-swap to fedavg halfway) on ViT-Tiny ``fedpac_soap``,
checkpointed after flush 2 and restored into a freshly built experiment
that must continue to the same history, and on the CNN against the CPU
path (the same event stream, metrics at SOAP's CNN tolerances).

Right after the build, two phases run each in a fresh process of this
script (``--phase``), young enough for ``torch.profiler`` to keep every
kernel of a trace: the serving path, the unreduced SmolLM-360M
(``configs/smollm_360m.py``, 361,821,120 parameters, f32) served through
``launch.serve.main`` (batch 8, prompt 256, 32 greedy tokens), its decode
held against a full forward over the prompt and the generated tokens, its
prefill and decode timed with CUDA events and one decode step traced
(device-busy share); and ``matmul_fused``/``adam_moments`` held against
their plain versions and timed over one SOAP step at SmolLM-360M's
shapes (the kernels line's ``*@smollm-360m`` rows).  Four more fresh
processes serve the rest of the model zoo the same way, f32 at full
width: Falcon-Mamba-7B (7,272,665,088 parameters) and RecurrentGemma-2B
(2,894,574,080) unreduced through ``launch.serve.main``, and
Mixtral-8x22B and DeepSeek-V2-236B cut to 2 layers (5,410,781,184 and
5,193,528,320: the full tables do not fit one card) through the same
prefill/decode loop; with a MoE the routing of the decode path and of
the full forward is recorded and its flips counted.  Last come the four
tables of the MoE, MLA, Mamba and RG-LRU layers ``reduced()`` (prefill
and 4 decode steps) and the ring-cache long decodes of Mixtral,
Falcon-Mamba and RecurrentGemma (window 8, 20 steps) against the CPU
port, ``fedpac_soap`` 2 rounds on reduced Mixtral and Falcon-Mamba on
``lm_zipf`` against the CPU path (5 ``matmul_fused`` and 13
``adam_moments`` a step); then the six dense tables ``reduced()``
(prefill and 4 decode steps) and a windowed SmolLM decoded 20 steps into
ring caches, each against the CPU port on the same weights; then
``fedpac_soap`` on the unreduced SmolLM-360M on ``lm_zipf`` at vocab
49,152 for two rounds (5 ``matmul_fused`` and 11 ``adam_moments`` a
step, the untrained loss at its expectation, the loss falling).

Last, the launch layer: ``launch.steps.make_train_step`` on the
unreduced SmolLM-360M in its bf16 table dtype (batch 8, seq 256; Muon,
SOAP at ``state_dtype`` bf16 and Sophia, 3 steps each, their launches a
step asserted; ``remat`` against none: the same loss, and at most half
the memory for the loss and gradients; the reduced table against the
CPU port), ``make_fed_round_step`` on the
unreduced LLaMA-60M (8 clients x 2 steps, dense and with the qblock
delta: one ``quantize`` launch; the reduced table against the CPU port),
``launch.train.main`` on LLaMA-60M for 3 rounds (trace validated,
checkpoint restored), and, each in a fresh process, ``launch.dryrun`` at
full width on the 256-rank fake pod mesh (SmolLM-360M x ``train_4k``,
Mixtral-8x22B x ``decode_32k``: host work on fake tensors, no kernel)
and the CNN ``fedpac_soap`` round through the ``shard_map`` executor over
a one-rank NCCL ``DeviceMesh``, bitwise against ``mesh=None``.  On one
rank the executor takes the whole cohort itself, as with ``mesh=None``:
that phase checks that a ``DeviceMesh`` is accepted on the card, not
the per-rank slicing and all-gather, which only a run of two or more
ranks reaches (``tests/test_torch_mesh.py``, over gloo on the CPU).

Each path fails if one of its kernels was never launched, and unless
SOAP's step is 5 ``matmul_fused`` launches (plus 15 a Newton–Schulz
refresh), Muon's step 15 (three grouped products a Newton–Schulz step),
Sophia's step one ``sophia_update`` launch and a qblock round 2
``quantize`` launches (the delta and theta encodes) and 3
``dequant_accumulate`` launches (the delta flush and theta's two; 1 with
the ``lowrank_svd+qblock`` Theta chain, whose flush peels to the
low-rank merged GEMM).  On the paths added with the low-rank wire the
round's ``upload_bytes`` must equal ``comm_bytes_per_round()``.  The
CNN runs are repeated on the CPU (plain versions) from the same weights
(and, for Sophia, the same Hutchinson probes), and the histories must
agree.  The Newton–Schulz composition is checked product by product
against ``matmul_fused``'s plain version and as a whole against its own.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero on any failure,
on a host without CUDA, and outside a checkout of the repository.
Imports nothing of JAX.
"""
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
S_VIT = 5                   # 10 clients x participation 0.5
ROUNDS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM FP32 (non-tensor-core), published
VIT_TINY = dict(patch=4, d_model=192, layers=12, heads=3)   # DeiT-Ti
VIT_LEAVES = [(192, 576), (192, 192), (192, 768), (768, 192)]  # one block
CNN_LEAVES = [(27, 8), (8, 16), (16, 32)]   # stem, block0/skip, block1/skip
U = 2.0 ** -24
# CNN GPU-vs-CPU agreement, as tests/test_torch_round.py holds the port
# to the JAX package (eps=1e-3 damps the first refresh's roundoff)
CNN_EPS = 1e-3
CNN_TOL = {"loss": 5e-3, "test_loss": 2e-2, "test_acc": 6 / 768}
CNN_REL_TOL = {"drift": 0.05, "norm_drift": 0.05}
# Sophia paths: the repo's vision Sophia lr (benchmarks/common.py) and the
# qblock wire with error feedback.  CNN GPU-vs-CPU agreement: ten times
# the tolerances tests/test_torch_sophia.py holds the port to against the
# JAX package (cuDNN and CPU convolutions sum in other orders, and a
# roundoff-level change of a delta can move its int8 code by one quantum)
SOPHIA_LR = 2e-2
QBLOCK = dict(delta_codec="qblock", theta_codec="qblock",
              error_feedback=True)
SOPHIA_TOL = {"loss": 1e-3, "test_loss": 1e-3, "test_acc": 2 / 768}
SOPHIA_REL_TOL = {"drift": 1e-2, "norm_drift": 1e-2}
# Muon, fedavg and fedcm on the CNN, GPU vs CPU: the same ten-fold margin
# over the tolerances tests/test_torch_{muon,baselines}.py hold the port
# to against the JAX package
FIRST_ORDER_TOL, FIRST_ORDER_REL_TOL = SOPHIA_TOL, SOPHIA_REL_TOL
# fedpm_soap on the CNN runs SOAP's "ns" refresh: with the QR refresh its
# GPU-vs-CPU gap sits at SOAP's tolerances (1.09x in loss at seed 0), and
# a planted 1% fault in adam_moments lands barely above it; with "ns" the
# gap is 0.03x and the fault 1.1-1.4x (tools/gpu_cpu_gap.py, PERF.md §6)
FEDPM_OPT = {"eps": CNN_EPS, "eig_method": "ns"}
# the low-rank wire: Table 6's rank; the Muon path's codecs (on the CNN's
# Muon momentum, in the chain's quantize check, rank 4 compresses the two
# skip matrices and passes the 3 x 8 stem through dense).  SOAP's CNN
# factors (8 to 32 wide, square) take rank 8, where the 8 x 8 ones pass
# through dense and the rest compress
LIGHT_RANK = 4
CNN_SOAP_RANK = 8
MUON_LIGHT = dict(delta_codec="qblock", theta_codec="lowrank_svd+qblock",
                  wire_dtype="bf16", error_feedback=True, svd_rank=LIGHT_RANK)
# Newton–Schulz output vs its plain version: f32 against f64 of the same
# composition differs by <= 8.4e-7 at the ViT-Tiny shapes (CPU), entries
# are <= 0.3; the quintic map can grow a roundoff by up to 3.4445 a step
NS_TOL = 1e-4
CUDA_SOURCES = ("matmul_fused.cu", "sophia_update.cu", "qblock.cu",
                "fused_agg.cu")
# the buffered-async runtime: examples/async_quickstart.py's latency model
# with 5 of 10 in-flight clients buffered a flush; the runtime's seed 5
# makes dropouts happen in 3 flushes (and, with max_staleness=1,
# discards), checked on the CPU event stream, which no device changes
ASYNC_FLUSHES = 3
ASYNC_SEED = 5
ASYNC_KW = dict(buffer_size=5, concurrency=10, staleness_mode="poly",
                staleness_alpha=0.5)
ASYNC_LATENCY = dict(heterogeneity=1.5, jitter=0.5, dropout=0.05)
ASYNC_SOAP_K = 10
# the Sophia and CNN async paths take K=5: the flush's count of launches
# and the CPU reference's time are what they check, not K
ASYNC_K = 5
# the async CNN's telemetry against the CPU path: drift-like fields at
# SOAP's 5% (CNN_REL_TOL), the update/correction cosine at 0.05 of its
# unit range, the controller's fields to f32 roundoff
TELEMETRY_REL = {"drift": 0.05, "norm_drift": 0.05,
                 "client_geom_dist": 0.05}
TELEMETRY_ABS = {"update_corr_cos": 0.05, "beta": 1e-6, "beta_next": 1e-6,
                 "drift_ema": 1e-6, "freshness": 1e-6}
PROFILE_SHAPES = ((256, 256), (768, 768))
# the population layer (fed.population, fed.pipeline): a 10^6-id
# stream_dirichlet population, as benchmarks/pipeline_bench.py draws it,
# and the state budget at 1.5x the cohort, as it sets it
POP_SIZE = 1_000_000
POP_PARTITION = dict(kind="stream_dirichlet", alpha=0.3,
                     samples_per_client=32)
# ViT-Tiny fedpac_sophia on the qblock wire with error feedback: 4 chunks
# of 4 clients; the EF residual is 21.5 MB a client, so about 0.5 GB stays
# resident and rounds 2-3 spill
POP_VIT = dict(population_size=POP_SIZE, cohort_size=16, pipeline_chunk=4,
               pipeline_workers=4, state_budget=24, local_steps=5,
               rounds=3, lr=SOPHIA_LR, hessian_freq=10, **QBLOCK)
# the restore path: 16 of 32 ids a round over 20 slots, so re-draws both
# spill and restore
POP_RESTORE = dict(population_size=32, cohort_size=16, state_budget=20,
                   local_steps=2, rounds=3, lr=SOPHIA_LR, hessian_freq=10,
                   **QBLOCK)
# the reference benchmark's SCAFFOLD cell (benchmarks/pipeline_bench.py)
POP_CNN = dict(population_size=POP_SIZE, cohort_size=64, state_budget=96,
               local_steps=2, rounds=3)
POP_CNN_SOURCE = dict(model="cnn", n=600, image_size=8, n_classes=4,
                      batch=8)
POP_CNN_CHUNK = 16
ASYNC_POP = 10_000
# 4 residual slots (the cohort_size that population mode wants the budget
# to cover) for the 10 clients in flight: dispatches spill and restore
ASYNC_POP_BUDGET = 4
# the pipelined ViT-Tiny round against the serial one: the same clients,
# batches and probe seeds; the chunks' vmap over 4 clients instead of 16
# may pick other GEMM algorithms on the card, a roundoff-level change of a
# delta can move an int8 code by one quantum, and the fold sums in chunk
# order.  The drift is the decomposition mean||T_i||^2 - ||mean T_i||^2 on
# both sides (the Theta wire is lossy), so a chunked sum changes it by
# roundoff of the two terms: Sophia's GPU-vs-CPU limits hold it
POP_TOL, POP_REL_TOL = SOPHIA_TOL, SOPHIA_REL_TOL
# the metrics every round of a vision path must keep finite
FINITE = ("loss", "test_loss", "drift", "norm_drift")
# the LM paths: the published LLaMA-60M (configs/llama_60m.py, unreduced:
# 8 layers, d_model 512, 8 heads, d_ff 1376, vocab 32000, tied, f32) on
# lm_zipf at benchmarks/table3_llm.py's document length, seq 256, batch
# 16, 8 clients at participation 0.25 (S=2), K=5
LM_SOURCE = dict(vocab=32000, tokens_per_doc=1900, seq_len=256, batch=16)
LM_FL = dict(n_clients=8, participation=0.25, local_steps=5)
LM_S = 2
LM_LAYERS = 8
LM_LEAVES = ([(512, 512)] * 4 + [(512, 1376)] * 2 + [(1376, 512)])
LM_FINITE = ("loss", "eval_loss", "token_acc", "drift", "norm_drift")
# the tiny lm_zipf (2 layers, d_model 64, vocab 256) GPU vs CPU: the CNN
# paths' margins over tests/test_torch_lm.py's tolerances, the eval loss
# and token accuracy in place of test_loss and test_acc
LM_SOAP_TOL = {"loss": CNN_TOL["loss"], "eval_loss": CNN_TOL["test_loss"],
               "token_acc": CNN_TOL["test_acc"]}
LM_SOPHIA_TOL = {"loss": SOPHIA_TOL["loss"],
                 "eval_loss": SOPHIA_TOL["test_loss"],
                 "token_acc": SOPHIA_TOL["test_acc"]}
# the continuous-traffic runtime: examples/traffic_quickstart.py's stream
# (a diurnal trace of ~6 arrivals a simulated second, churn, anytime eval
# every simulated second, a hot-swap to fedavg halfway), 3 buffered of 4
# in flight, K=5; 5 simulated seconds make 4 flushes at seed 0, with
# client_left and algo_swap discards (the CPU event stream, which no
# device changes)
TRAFFIC_BUDGET = 5.0
TRAFFIC_TRACE = dict(trace="diurnal",
                     trace_kwargs={"base": 6.0, "amplitude": 0.8,
                                   "period": 4.0},
                     eval_every=1.0, swap_to="fedavg",
                     swap_at=TRAFFIC_BUDGET / 2)
TRAFFIC_CHURN = dict(join_rate=0.5, leave_rate=0.5, initial_active=8)
TRAFFIC_ACFG = dict(buffer_size=3, concurrency=4)
TRAFFIC_K = 5
# serving: the unreduced SmolLM-360M (configs/smollm_360m.py, f32 as
# the serving driver sets it) through launch.serve.main, greedy
SERVE = dict(batch=8, prompt=256, gen=32)
# decode against a full forward over prompt + the first 31 generated
# tokens, at full width: f32 end to end, but the prompt's forward and the
# decode steps run GEMMs of other shapes (M = 8 rows against 2,296), which
# cuBLAS sums in other orders; ~1e-6 relative a GEMM through 32 residual
# layers stays far below 1e-3 on logits of standard deviation 0.6
# (0.02 sqrt 960).  The reference's own bound at reduced widths is 2e-4.
SERVE_DECODE_TOL = 1e-3
# the six dense tables reduced, f32, prefill of 8 then 4 decode steps, GPU
# vs the CPU port on the same weights: five times the CPU tests' 2e-5
# against the reference, for two devices' sum orders
DENSE_TABLES = ("starcoder2-3b", "smollm-360m", "chatglm3-6b",
                "qwen1.5-110b", "qwen2-vl-7b", "musicgen-medium")
TABLE_TOL = 1e-4
RING = dict(block_pattern=("swa",), window=8)
RING_STEPS = 20
# training the unreduced SmolLM-360M: lm_zipf at its 49,152 vocab, seq
# 256, batch 16, LM_FL (S=2, K=5); 32 layers of 7 stacked matrix leaves.
# Two rounds: the second is the first with a Theta reference and g_G
# carried over
SMOL_SOURCE = dict(LM_SOURCE, vocab=49152)
SMOL_ROUNDS = 2
SMOL_LAYERS = 32
SMOL_LEAVES = ([(960, 960), (960, 320), (960, 320), (960, 960)]
               + [(960, 2560)] * 2 + [(2560, 960)])
# the rest of the model zoo served at full width (f32, TF32 off), batch 8,
# prompt 256, 32 greedy tokens, each in a fresh process: Falcon-Mamba-7B
# and RecurrentGemma-2B unreduced through launch.serve.main; Mixtral-8x22B
# and DeepSeek-V2-236B at full width cut to 2 layers (the full 141 B and
# 236 B parameters do not fit one card; DeepSeek's 2 are its dense layer
# 0 and one MoE layer of 160 experts and 2 shared), served by the same
# prefill/decode_step loop.  Parameters by the reference's count.
ZOO_SERVE = (("falcon-mamba-7b", None, 7_272_665_088),
             ("recurrentgemma-2b", None, 2_894_574_080),
             ("mixtral-8x22b", 2, 5_410_781_184),
             ("deepseek-v2-236b", 2, 5_193_528_320))
# decode against the full forward: SmolLM's 1e-3 (logits of standard
# deviation ~1 here: untied heads of fan-in scale, RecurrentGemma's tied
# 0.02 sqrt 2560); the scans of Falcon-Mamba's forward over 287 tokens
# run in chunks of 41 where its prefill ran 2 of 128, another association
# of f32 sums of the same terms, ~1e-6 relative
# a routing flip: a position whose top-k experts differ between the
# decode path (prefill, then the steps) and the full forward in any MoE
# layer, where the k-th and (k+1)-th router probabilities lie within
# roundoff.  Expected < 0.1 a table (router logits of standard deviation
# ~1.5, top-k gaps ~0.1 wide, ~1e-6 apart), allowed 2 a table; the logits
# bound is held on every position of a sequence before its first flip (a
# flip at one position reaches later ones through attention)
ZOO_FLIP_BOUND = 2
# the four tables reduced (RecurrentGemma at 3 layers, so that its
# local_attn layer is in), prefill 8 + 4 decode steps, and the ring-cache
# long decodes of the reference's test_ring_cache_long_decode (window 8,
# 20 steps), GPU vs the CPU port at TABLE_TOL, flips counted as above
ZOO_TABLES = {"mixtral-8x22b": {}, "deepseek-v2-236b": {},
              "falcon-mamba-7b": {}, "recurrentgemma-2b": {"layers": 3}}
ZOO_RING = ("mixtral-8x22b", "falcon-mamba-7b", "recurrentgemma-2b")
# fedpac_soap on lm_zipf (vocab 256, seq 32, batch 8, 8 clients, K=5, the
# tiny lm_zipf check's settings and tolerances) with reduced Mixtral
# (d_model 256, 2 layers, 4 experts top-2) and reduced Falcon-Mamba (d_model
# 256, 2 layers), 2 rounds, GPU vs the CPU path.  adam_moments launches a
# step = the leaves (one a leaf, rotated or fallback): Mixtral 13 (7
# matrices: wq wk wv wo and the (2, 4, 256, 256) expert stacks, read as
# (2048, 256) conv-style matrices; 6 fallback: tok, head, two norms, the
# 4-wide router, the final norm); Falcon-Mamba 13 (4 matrices: in_proj,
# x_proj, dt_proj, out_proj; 9 fallback: tok, head, pre_norm, conv_w,
# conv_b, dt_bias, A_log, D, the final norm)
ZOO_TRAIN = {"mixtral-8x22b": 13, "falcon-mamba-7b": 13}
ZOO_ROUNDS = 2
# the launch layer (launch.steps, launch.train, launch.dryrun, the
# multi-rank executors).  make_train_step on the unreduced SmolLM-360M in
# its table dtype (bf16) at batch 8, seq 256, 3 steps an optimizer (step 0
# refreshes SOAP's basis and Sophia's curvature); the launches a step:
# SOAP 5 grouped matmul_fused and one adam_moments a leaf (7 rotated
# matrices, 4 fallback), Muon 15 matmul_fused (5 Newton-Schulz steps of 3
# grouped products) and one adam_moments a fallback leaf, Sophia one
# sophia_update
TRAIN_STEP = dict(batch=8, seq=256, steps=3)
TRAIN_STEP_OPTS = {"muon": {}, "soap": {"state_dtype": "bfloat16"},
                   "sophia": {}}
TRAIN_STEP_LAUNCHES = {"muon": {"matmul_fused": 15, "adam_moments": 4},
                       "soap": {"matmul_fused": 5, "adam_moments": 11},
                       "sophia": {"sophia_update": 1}}
# the reduced table GPU vs the CPU port, f32: the matrix leaves within
# five times the CPU parity test's 2e-5 + 1e-4 relative
# (tests/test_torch_launch.py) for two devices' sum orders, as TABLE_TOL
# is five times the tables' 2e-5.  The Adam-fallback leaves (embeddings,
# norms) are held through the loss of the updated params: at step 0
# Adam's g / (|g| + 1e-8) turns a roundoff-level change of a gradient
# entry near 1e-8 into an O(1) change of its step (the reference's eps;
# seen at 2.3e-4 on a param), which moves the loss by far less than
# STEP_LOSS_TOL, the Sophia paths' GPU-vs-CPU loss tolerance
STEP_ATOL, STEP_RTOL = 1e-4, 5e-4
STEP_LOSS_TOL = 1e-3
# make_fed_round_step on the unreduced LLaMA-60M (f32): 8 clients x 2
# local steps x 2 sequences of 256 tokens, fedpac_soap; the cohort steps
# together, so a round is 2 steps of 5 matmul_fused and 11 adam_moments;
# the qblock delta wire adds one grouped quantize launch (its roundtrip's
# encode).  Against the CPU port on the reduced table with SPD-warm-started
# Theta: STEP_ATOL/STEP_RTOL on the dense wire; on qblock a delta element
# may land one int8 level apart, ~1e-4 of a param here, so 1e-3
FED_ROUND = dict(clients=8, local_steps=2, micro=2, seq=256)
FED_QBLOCK_ATOL = 1e-3
# launch.train.main on the unreduced LLaMA-60M with fedpac_soap, its
# defaults otherwise (8 clients at participation 0.5, K=5, batch 8, seq 64)
TRAIN_ROUNDS = 3
# the dry-run at full width on the 256-rank fake pod mesh
DRYRUN_CELLS = (("smollm-360m", "train_4k"), ("mixtral-8x22b", "decode_32k"))


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def timed(fn, reps=5, rounds=3):
    """Median over ``rounds`` of the mean ms of ``reps`` calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return sorted(samples)[len(samples) // 2]


def device_ms(fn, traces=3, floor_ms=0.0):
    """Summed device time (ms) of the CUDA kernels one call of ``fn``
    runs, from a ``torch.profiler`` trace: the work's cost on the card
    without the host's launch cost, which ``timed`` includes.  A trace
    that comes back without the device's activity, or below ``floor_ms``
    (the card's bound for the work, which only a trace that lost kernels
    can show), is taken again, up to ``traces`` times, and then the run
    fails.  The profiler drops kernels as out of its window more and more
    as a process ages (``fresh_phase``)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        attr = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
        us = sum(getattr(e, attr) for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if us > 0 and us / 1e3 >= floor_ms:
            return us / 1e3
        log(f"torch.profiler recorded {us / 1e3:.3f} ms of device time (the "
            f"work's bound {floor_ms:.3f} ms); tracing again")
    raise AssertionError(f"torch.profiler recorded no device time at or "
                         f"above the work's bound ({floor_ms:.3f} ms) in "
                         f"{traces} traces")


def fresh_phase(name):
    """Runs phase ``name`` of ``PHASES`` in a new process of this script
    (on the same card, the kernels' builds reused) and returns its
    result.  ``torch.profiler`` keeps every kernel of a trace only in a
    young process: tens of seconds after a process's first trace, its
    traces start to drop kernels as out of their window, the first of a
    trace first.  So the phases whose numbers must come from whole traces
    run fresh."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--phase", name, path], check=True)
        with open(path) as f:
            out = json.load(f)
    log(f"{name} (a fresh process): {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ build

def build_kernels(dev):
    """Every CUDA source built by its own nvcc, all started together, then
    the Triton kernel compiled by a first launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_agg import kernel as fused_agg
    from repro_torch.kernels.qblock import kernel as qblock
    from repro_torch.kernels.soap_rotate.kernel import adam_moments
    from repro_torch.kernels.sophia_update import kernel as sophia

    def one(source):
        t0 = time.perf_counter()
        path, compiler_log = build.build(source)
        return path, compiler_log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        built = list(pool.map(one, CUDA_SOURCES))
    log(f"built {len(built)} CUDA sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for path, compiler_log, secs in built:
        log(f"  {os.path.relpath(path, HERE)} with nvcc in {secs:.2f} s")
        for line in compiler_log.splitlines():
            if "ptxas" in line or "spill" in line:   # registers, smem, spills
                log("    " + line.strip())
    from repro_torch.kernels.ns_ortho.kernel import kernel_library
    lib = kernel_library()
    bm, bn, bk, stages, threads, max_p, _, table, smem = lib.config
    log(f"matmul_fused: {bm}x{bn} tiles, BK {bk}, {stages}-stage cp.async "
        f"ring ({smem} B dynamic shared memory), {threads} threads, "
        f"{lib.resident_blocks()} persistent blocks on the card, "
        f"<= {max_p} problems per launch ({table} B table)")
    lib = sophia.kernel_library()
    threads, chunk, max_l, _, table = lib.config
    log(f"sophia_update: {lib.resident_blocks()} persistent blocks of "
        f"{threads} threads, {chunk}-element chunks, <= {max_l} leaves per "
        f"launch ({table} B table)")
    lib = qblock.kernel_library()
    threads, slice_, max_l, _, table = lib.config
    log(f"quantize: {lib.resident_blocks()} persistent blocks of {threads} "
        f"threads ({slice_}-element slices of a quant block), <= "
        f"{max_l} leaves per launch ({table} B table)")
    lib = fused_agg.kernel_library()
    threads, elems, max_l, _, table = lib.config
    log(f"dequant_accumulate: {lib.resident_blocks()} persistent blocks of "
        f"{threads} threads, {elems} outputs a thread, <= {max_l} leaves "
        f"per launch ({table} B table)")
    t0 = time.perf_counter()
    x = torch.ones(8, device=dev)
    adam_moments(x, x, x)
    torch.cuda.synchronize()
    log(f"compiled adam_moments with Triton in "
        f"{time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------ kernel checks

def leaf_inputs(m, n, s, dev, gen, orthogonal=True):
    """One stacked matrix leaf's SOAP operands.  ``orthogonal=False``
    makes the Q factors scaled Gaussians: the products' work and error
    bounds do not depend on it, and QRs of large stacks take seconds."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    g = randn(s, m, n)
    if orthogonal:
        ql, _ = torch.linalg.qr(randn(s, m, m))
        qr, _ = torch.linalg.qr(randn(s, n, n))
    else:
        ql, qr = randn(s, m, m) / math.sqrt(m), randn(s, n, n) / math.sqrt(n)
    lf = torch.bmm(g, g.transpose(1, 2)) / n
    rf = torch.bmm(g.transpose(1, 2), g) / m
    return dict(g=g, ql=ql, qr=qr, L=lf, R=rf, M=randn(s, m, n),
                V=torch.rand((s, m, n), generator=gen, device=dev))


def gemm_forms(x, b2=0.95):
    """The six products one SOAP step makes per matrix leaf:
    (name, lhs, rhs, aux, alpha, beta)."""
    g, gt = x["g"], x["g"].transpose(1, 2)
    return [
        ("L_ema", g, gt, x["L"], 1 - b2, b2),
        ("R_ema", gt, g, x["R"], 1 - b2, b2),
        ("QlT_G", x["ql"].transpose(1, 2), g, None, 1.0, 0.0),
        ("G_Qr", g, x["qr"], None, 1.0, 0.0),
        ("Ql_N", x["ql"], x["M"], None, 1.0, 0.0),
        ("N_QrT", x["M"], x["qr"].transpose(1, 2), None, 1.0, 0.0),
    ]


def step_groups(forms):
    """The products of ``gemm_forms`` over many leaves as SOAP's step
    groups them: the L/R EMAs in one group, then one group per rotation
    (5 groups of (lhs, rhs, aux, alpha, beta))."""
    phases = {"L_ema": 0, "R_ema": 0, "QlT_G": 1, "G_Qr": 2, "Ql_N": 3,
              "N_QrT": 4}
    groups = [[] for _ in range(5)]
    for name, *problem in forms:
        groups[phases[name]].append(tuple(problem))
    return groups


def gemm_error(got, a, b, aux, alpha, beta, want):
    """(max |err|, max err / bound) for the bound 2 (k+2) u (|alpha|
    |A||B| + |beta| |aux|): two f32 sums in different orders."""
    mag = abs(alpha) * torch.matmul(a.abs(), b.abs())
    if aux is not None:
        mag = mag + abs(beta) * aux.abs()
    bound = 2 * (a.shape[-1] + 2) * U * mag + 1e-30
    err = (got - want).abs()
    return float(err.max()), float((err / bound).max())


def check_matmul_fused(leaves):
    """Kernel vs plain on every form, one product per launch and as one
    grouped launch over every form of every leaf; elementwise bound 2 (k+2)
    u (|alpha| |A||B| + |beta| |aux|)."""
    from repro_torch.kernels.ns_ortho.kernel import (
        matmul_fused, matmul_fused_group, matmul_fused_group_plain,
    )
    worst_err, worst_ratio = 0.0, 0.0
    forms = []
    for (m, n, s), x in leaves:
        for name, a, b, aux, alpha, beta in gemm_forms(x):
            forms.append((f"{name} at (S={s}, m={m}, n={n})",
                          (a, b, aux, alpha, beta)))
    problems = [p for _, p in forms]
    before = matmul_fused.launches
    grouped = matmul_fused_group(problems)
    if matmul_fused.launches != before + 1:
        raise AssertionError(f"one group of {len(problems)} problems took "
                             f"{matmul_fused.launches - before} launches")
    for (what, p), got_g, want in zip(forms, grouped,
                                      matmul_fused_group_plain(problems)):
        got = matmul_fused(*p[:3], alpha=p[3], beta=p[4])
        for form, out in (("single", got), ("grouped", got_g)):
            err, ratio = gemm_error(out, *p, want)
            worst_err, worst_ratio = max(worst_err, err), max(worst_ratio,
                                                              ratio)
            if ratio > 1.0:
                raise AssertionError(
                    f"matmul_fused ({form}) {what} exceeds its bound: max "
                    f"err {err:.3e}, err/bound {ratio:.3f}")
    log(f"matmul_fused vs plain, single and one grouped launch of "
        f"{len(problems)} products: max |err| {worst_err:.3e}, max "
        f"err/bound {worst_ratio:.3f} (bound 2(k+2)u sum|a||b|)")
    return worst_err


def check_adam_moments(leaves):
    """Kernel vs plain: m', v' within 1e-6 max(1, |x|) (one FMA apart), n
    within 1e-5 max(1, |n|) (a division and a square root, each rounded
    or approximated differently)."""
    from repro_torch.kernels.soap_rotate.kernel import (
        adam_moments, adam_moments_plain,
    )
    worst = 0.0
    for (m, n, s), x in leaves:
        for step in (None, 0, 7):
            got = adam_moments(x["g"], x["M"], x["V"], step=step)
            want = adam_moments_plain(x["g"], x["M"], x["V"], step=step)
            for name, gv, wv, rel in zip(("n", "m", "v"), got, want,
                                         (1e-5, 1e-6, 1e-6)):
                err = (gv - wv).abs()
                worst = max(worst, float(err.max()))
                if bool((err > rel * wv.abs().clamp(min=1.0)).any()):
                    raise AssertionError(
                        f"adam_moments {name} at (S={s}, m={m}, n={n}, "
                        f"step={step}): max err {float(err.max()):.3e}")
    log(f"adam_moments vs plain: max |err| {worst:.3e} (bounds 1e-5 rel on "
        "n, 1e-6 rel on m', v')")
    return worst


def check_soap_rotated_update(leaves):
    """The composition, two-sided and one-sided, against the same
    composition of plain versions; directions within 1e-4 max(1, |d|)."""
    from repro_torch.kernels.soap_rotate.ops import (
        soap_rotated_update, soap_rotated_update_plain,
    )
    worst = 0.0
    for (m, n, s), x in leaves:
        for ql, qr in ((x["ql"], x["qr"]), (None, x["qr"]), (x["ql"], None)):
            got = soap_rotated_update(x["g"], ql, qr, x["M"], x["V"], step=3)
            want = soap_rotated_update_plain(x["g"], ql, qr, x["M"], x["V"],
                                             step=3)
            for gv, wv in zip(got, want):
                err = (gv - wv).abs()
                worst = max(worst, float(err.max()))
                if bool((err > 1e-4 * wv.abs().clamp(min=1.0)).any()):
                    raise AssertionError(
                        f"soap_rotated_update at (S={s}, m={m}, n={n}): "
                        f"max err {float(err.max()):.3e}")
    log(f"soap_rotated_update vs plain composition: max |err| {worst:.3e} "
        "(bound 1e-4 rel), two- and one-sided")


def model_leaf_shapes():
    """(ViT-Tiny leaf shapes, CNN leaf shapes): the per-client shapes of
    every leaf the Sophia paths update and encode."""
    from repro_torch.models.vision import init_cnn, init_vit
    from repro_torch.utils.tree import tree_leaves
    gen = torch.Generator().manual_seed(0)
    vit, _ = init_vit(gen, image_size=32, n_classes=100, device="cpu",
                      **VIT_TINY)
    cnn = init_cnn(gen, n_classes=8, width=8, blocks=2, device="cpu")
    return ([tuple(p.shape) for p in tree_leaves(vit)],
            [tuple(p.shape) for p in tree_leaves(cnn)])


def sophia_inputs(shape, dev, gen):
    """g, m normal; h with h = 0 on a third of the entries (the clip
    saturates on the sign of m') and small h on others."""
    g = torch.randn(shape, generator=gen, device=dev)
    m = torch.randn(shape, generator=gen, device=dev)
    h = torch.rand(shape, generator=gen, device=dev) * 50
    h.view(-1)[::3] = 0.0
    h.view(-1)[1::7] = 1e-3
    return g, m, h


def with_nonfinite(leaves):
    """Puts NaN and +-inf into h and g of the first leaves: h = NaN, +inf,
    -inf and g = NaN, +inf, -inf beside h = 0."""
    nonfinite = torch.tensor([float("nan"), float("inf"), -float("inf")])
    for g, _, h in leaves[:4]:
        h.view(-1)[:3] = nonfinite
        g.view(-1)[3:6] = nonfinite
        h.view(-1)[3:6] = 0.0
    return leaves


def bits_differ(got, want):
    """Elements where got and want differ bitwise, NaN matching NaN."""
    nan = torch.isnan(want)
    same = torch.where(nan, torch.isnan(got),
                       got.view(torch.int32) == want.view(torch.int32))
    return int((~same).sum())


def check_sophia_update(stacked_shapes, dev, gen):
    """Kernel vs plain on every leaf, in one grouped launch and one leaf a
    launch: d and m' bitwise equal (the kernel rounds as the plain version
    does), NaN and +-inf in h and g included."""
    from repro_torch.kernels.sophia_update.kernel import (
        sophia_update, sophia_update_group, sophia_update_plain,
    )
    leaves = with_nonfinite([sophia_inputs(shape, dev, gen)
                             for shape in stacked_shapes])
    before = sophia_update.launches
    ds, mos = sophia_update_group(*zip(*leaves))
    if sophia_update.launches != before + 1:
        raise AssertionError(f"one group of {len(leaves)} leaves took "
                             f"{sophia_update.launches - before} launches")
    saturated = nan = 0
    for (g, m, h), d, mo in zip(leaves, ds, mos):
        want = sophia_update_plain(g, m, h)
        saturated += int((want[0].abs() == 0.05).sum())
        nan += int(torch.isnan(want[0]).sum())
        single = sophia_update(g, m, h)
        for form, got in (("grouped", (d, mo)), ("single", single)):
            for name, gv, wv in zip(("d", "m"), got, want):
                bad = bits_differ(gv, wv)
                if bad:
                    raise AssertionError(
                        f"sophia_update ({form}) {name} at {tuple(g.shape)}: "
                        f"{bad} values differ from the plain version")
    log(f"sophia_update vs plain on {len(leaves)} leaves, grouped (one "
        f"launch) and one leaf a launch: d and m' bitwise equal; "
        f"{saturated} clipped entries, {nan} NaN (NaN/inf in h and g)")
    return 0.0


def tied_rows(rows, n, dev, gen, block=128):
    """(rows, n) with exact k + 0.5 ties in the first block (scale 1/8),
    an all-zero second block where n allows, and a ragged tail whenever
    n % block != 0."""
    x = torch.randn((rows, n), generator=gen, device=dev) * 3
    b0 = min(block, n)
    k = torch.randint(-126, 126, (rows, b0), generator=gen, device=dev)
    x[:, :b0] = (k + 0.5) * 0.125
    x[:, 0] = 127 * 0.125
    if n > 2 * block:
        x[:, block:2 * block] = 0.0
    return x


def quantize_agrees(label, xs):
    """Kernel vs plain on the (rows, n) f32 leaves ``xs``, in one grouped
    launch and one leaf a launch: q and scale bitwise equal (the codes of
    a block whose scale is NaN or inf, a NaN cast to int8, are not
    compared).  Returns the number of such blocks."""
    from repro_torch.kernels.qblock.kernel import (
        quantize, quantize_group, quantize_plain,
    )
    before = quantize.launches
    grouped = quantize_group(xs)
    if quantize.launches != before + 1:
        raise AssertionError(f"{label}: one group of {len(xs)} leaves took "
                             f"{quantize.launches - before} launches")
    special = 0
    for x, got_g in zip(xs, grouped):
        wq, ws = quantize_plain(x)
        ok = torch.isfinite(ws)
        special += int((~ok).sum())
        ok_q = ok.repeat_interleave(128, dim=1)[:, :x.shape[1]]
        for form, (q, s) in (("grouped", got_g), ("single", quantize(x))):
            bad = int((q[ok_q] != wq[ok_q]).sum()) + bits_differ(s, ws)
            if bad:
                raise AssertionError(
                    f"{label}: quantize ({form}) at {tuple(x.shape)}: {bad} "
                    "values differ from the plain version")
    return special


def check_quantize(stacked_shapes, dev, gen):
    """Kernel vs plain on every leaf (rows = clients), in one grouped
    launch and one leaf a launch: q and scale bitwise equal.  The first
    leaves hold NaN and +-inf, whose blocks must get the plain version's
    NaN or inf scale."""
    xs = [tied_rows(shape[0], math.prod(shape[1:]), dev, gen)
          for shape in stacked_shapes]
    nonfinite = torch.tensor([float("nan"), float("inf"), -float("inf")])
    for x in xs[:4]:
        x.view(-1)[-3:] = nonfinite
    ragged = sum(x.shape[1] % 128 != 0 for x in xs)
    special = quantize_agrees("model leaves", xs)
    log(f"quantize vs plain on {len(xs)} leaves, grouped (one launch) and "
        f"one leaf a launch: q and scale bitwise equal ({ragged} leaves "
        f"with a ragged tail, ties and zero blocks in each; {special} "
        "blocks with NaN or inf, scales equal)")
    return 0.0


def check_chain_quantize(dev, gen):
    """``quantize`` on what the ``lowrank_svd+qblock`` Theta chain of
    ``fedpac_muon_light`` hands it: Muon's momentum (normals) at
    ViT-Tiny (S=5; 48 matrices, all low-rank at rank 4) and on the CNN
    (S=2; its stem conv, 3 x 8 matrices, passes through dense), encoded
    by the chain's first stage (rank 4, bf16 wire), its bf16 payloads cast
    to f32 as ``QBlock`` casts them.  Kernel vs plain bitwise, grouped and
    one leaf a launch, then the chain's ``QBlock`` stage (one launch)
    against the plain version of the same rows."""
    from repro_torch.core.algorithms import resolve, zero_theta
    from repro_torch.core.transport import TransportConfig, resolve_codec
    from repro_torch.core.transport.chain import _payloads
    from repro_torch.core.transport.qblock import _rows
    from repro_torch.kernels.qblock.kernel import quantize, quantize_plain
    from repro_torch.models.vision import init_cnn, init_vit
    from repro_torch.utils.tree import tree_leaves, tree_map
    pgen = torch.Generator().manual_seed(0)
    vit, _ = init_vit(pgen, image_size=32, n_classes=100, device=dev,
                      **VIT_TINY)
    cnn = init_cnn(pgen, n_classes=8, width=8, blocks=2, device=dev)
    opt = resolve("fedpac_muon_light").make_optimizer()
    chain = resolve_codec(MUON_LIGHT["theta_codec"], TransportConfig(
        rank=LIGHT_RANK, wire_dtype=MUON_LIGHT["wire_dtype"]))
    kinds, n_rows = collections.Counter(), 0
    for label, params, s in (("ViT-Tiny", vit, S_VIT), ("CNN", cnn, 2)):
        theta = tree_map(
            lambda t: torch.randn((s, *t.shape), generator=gen, device=dev),
            zero_theta(opt, params))
        inner = chain.stages[0].encode(theta)
        kinds.update(m.kind for m in tree_leaves(inner.leaves))
        payloads = _payloads(inner.leaves)
        flat = tree_leaves(payloads)
        if {x.dtype for x in flat} != {torch.bfloat16}:
            raise AssertionError(f"{label} chain payloads: dtypes "
                                 f"{ {x.dtype for x in flat} }, want bf16")
        rows = [_rows(x) for x in flat]
        n_rows += len(rows)
        quantize_agrees(f"{label} chain payloads", rows)
        before = quantize.launches
        msg = chain.stages[1].encode(payloads)
        if quantize.launches != before + 1:
            raise AssertionError(f"{label}: the chain's qblock stage took "
                                 f"{quantize.launches - before} launches")
        for x, m in zip(rows, tree_leaves(msg.leaves)):
            wq, ws = quantize_plain(x)
            bad = int((m.parts["q"] != wq).sum()) + bits_differ(
                m.parts["scale"], ws)
            if bad:
                raise AssertionError(
                    f"{label} chain qblock stage at {tuple(x.shape)}: {bad} "
                    "values differ from the plain version")
    if set(kinds) != {"lowrank", "dense"}:
        raise AssertionError(f"chain leaf kinds {dict(kinds)}, want "
                             "lowrank and dense")
    log(f"quantize on the lowrank_svd+qblock chain's payloads (Muon "
        f"momentum at ViT-Tiny and the CNN, rank {LIGHT_RANK}, bf16 wire: "
        f"{kinds['lowrank']} low-rank and {kinds['dense']} dense leaves, "
        f"{n_rows} bf16 payloads as f32 rows): grouped, one leaf a launch "
        "and the chain's qblock stage bitwise equal to the plain version")


def check_dequant_accumulate(stacked_shapes, dev, gen):
    """Kernel vs plain on every leaf, in one grouped launch and one leaf a
    launch: within 4 B u sum_i |w_i s_i q_i|."""
    from repro_torch.kernels.fused_agg.kernel import (
        dequant_accumulate, dequant_accumulate_group,
        dequant_accumulate_plain,
    )
    from repro_torch.kernels.qblock.kernel import quantize
    worst, worst_ratio = 0.0, 0.0
    by_clients = {}
    for shape in stacked_shapes:
        b, n = shape[0], math.prod(shape[1:])
        by_clients.setdefault(b, []).append(
            quantize(torch.randn((b, n), generator=gen, device=dev)))
    for b, coded in by_clients.items():
        w = torch.rand(b, generator=gen, device=dev) + 0.2
        before = dequant_accumulate.launches
        grouped = dequant_accumulate_group(*zip(*coded), w)
        if dequant_accumulate.launches != before + 1:
            raise AssertionError(
                f"one group of {len(coded)} leaves took "
                f"{dequant_accumulate.launches - before} launches")
        for (q, s), got_g in zip(coded, grouped):
            n = q.shape[1]
            want = dequant_accumulate_plain(q, s, w)
            mag = ((w[:, None] * s).repeat_interleave(128, dim=1)[:, :n]
                   .abs() * q.float().abs()).sum(0)
            for form, got in (("grouped", got_g),
                              ("single", dequant_accumulate(q, s, w))):
                err = (got - want).abs()
                ratio = float((err / (4 * b * U * mag + 1e-30)).max())
                worst = max(worst, float(err.max()))
                worst_ratio = max(worst_ratio, ratio)
                if ratio > 1.0:
                    raise AssertionError(
                        f"dequant_accumulate ({form}) at (B={b}, n={n}): max "
                        f"err {float(err.max()):.3e}, err/bound {ratio:.3f}")
    log(f"dequant_accumulate vs plain on {len(stacked_shapes)} leaves, "
        f"grouped ({len(by_clients)} launches, one per cohort size) and one "
        f"leaf a launch: max |err| {worst:.3e}, max err/bound "
        f"{worst_ratio:.3f} (bound 4Bu sum|w s q|)")
    return worst


def vit_matrix_leaves(dev, gen):
    """Muon's 48 ViT-Tiny matrix leaves at S=5 (momentum-like normals)."""
    return [torch.randn((S_VIT, m, n), generator=gen, device=dev)
            for _ in range(VIT_TINY["layers"]) for m, n in VIT_LEAVES]


def check_newton_schulz(mats):
    """The composition on Muon's ViT-Tiny step: 15 ``matmul_fused``
    launches, each of its products (captured with the kernel's own inputs)
    within 2(k+2)u sum|a||b| of the plain ``matmul_fused``, and the output
    within ``NS_TOL`` of ``newton_schulz_group_plain``."""
    from repro_torch.kernels.ns_ortho import ops as ns_ops
    from repro_torch.kernels.ns_ortho.kernel import (
        matmul_fused, matmul_fused_group_plain,
    )
    captured = []
    real = ns_ops.matmul_fused_group

    def spy(problems):
        outs = real(problems)
        captured.append((problems, outs))
        return outs

    before = matmul_fused.launches
    ns_ops.matmul_fused_group = spy
    try:
        got = ns_ops.newton_schulz_group(mats)
    finally:
        ns_ops.matmul_fused_group = real
    made = matmul_fused.launches - before
    if made != 15 or len(captured) != 15:
        raise AssertionError(f"newton_schulz on {len(mats)} matrices: "
                             f"{made} launches in {len(captured)} group "
                             "calls, want 15")
    worst_ratio = 0.0
    for problems, outs in captured:
        for p, out, want in zip(problems, outs,
                                matmul_fused_group_plain(problems)):
            err, ratio = gemm_error(out, *p, want)
            worst_ratio = max(worst_ratio, ratio)
            if ratio > 1.0:
                raise AssertionError(
                    f"newton_schulz product {tuple(p[0].shape)} @ "
                    f"{tuple(p[1].shape)} exceeds its bound: max err "
                    f"{err:.3e}, err/bound {ratio:.3f}")
    worst = 0.0
    for g, x, want in zip(mats, got, ns_ops.newton_schulz_group_plain(mats)):
        if x.shape != g.shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"newton_schulz output {tuple(x.shape)} for "
                                 f"{tuple(g.shape)}: wrong shape or "
                                 "non-finite")
        worst = max(worst, float((x - want).abs().max()))
    if worst > NS_TOL:
        raise AssertionError(f"newton_schulz vs plain: max |err| "
                             f"{worst:.3e} > {NS_TOL}")
    log(f"newton_schulz on {len(mats)} ViT-Tiny matrices (S={S_VIT}): 15 "
        f"launches; each of {sum(len(p) for p, _ in captured)} products "
        f"within its bound (max err/bound {worst_ratio:.3f}, bound "
        f"2(k+2)u sum|a||b|); output vs plain max |err| {worst:.3e} "
        f"(tol {NS_TOL})")
    return worst


def check_profile_kernels(dev):
    """``obs.profile_kernels`` on the card at ``PROFILE_SHAPES``: a "ref"
    (plain) and a "kernel" row for each of the five triads, printed as one
    line; then each triad's kernel output against its plain output on the
    same inputs, within the bound its own check above holds it to
    (soap_rotate 1e-4 max(1, |x|); quantize and sophia_update bitwise;
    Newton–Schulz ``NS_TOL``; dequant_accumulate 4Bu sum|w s q|)."""
    from repro_torch.obs import profile_kernels
    from repro_torch.obs.profiling import IMPLS, KERNELS, kernel_cases
    recs = profile_kernels(shapes=PROFILE_SHAPES, device="cuda")
    got = {(r["kernel"], r["impl"], tuple(r["shape"])) for r in recs}
    want = {(k, i, tuple(s)) for k in KERNELS for i in IMPLS
            for s in PROFILE_SHAPES}
    if got != want or any(r["backend"] != "cuda" or r["interpret"]
                          for r in recs):
        raise AssertionError(f"profile_kernels rows {sorted(got)}")
    log(json.dumps({"profile_kernels": recs}))
    for shape in PROFILE_SHAPES:
        for name, fns, args, _, _ in kernel_cases(shape, device=dev):
            ref, ker = fns["ref"](*args), fns["kernel"](*args)
            if name == "soap_rotate":
                bad = sum(int(((k - r).abs() > 1e-4 * r.abs().clamp(
                    min=1.0)).sum()) for k, r in zip(ker, ref))
            elif name == "qblock":
                bad = int((ker[0] != ref[0]).sum()) + bits_differ(ker[1],
                                                                  ref[1])
            elif name == "sophia_update":
                bad = sum(bits_differ(k, r) for k, r in zip(ker, ref))
            elif name == "ns_ortho":
                bad = int(((ker - ref).abs() > NS_TOL).sum())
            else:
                q, scale, w = args
                mag = ((w[:, None] * scale).repeat_interleave(128, dim=1)
                       .abs() * q.float().abs()).sum(0)
                bad = int(((ker - ref).abs()
                           > 4 * q.shape[0] * U * mag + 1e-30).sum())
            if bad:
                raise AssertionError(f"profile_kernels {name} at {shape}: "
                                     f"{bad} kernel values outside the "
                                     "bound of the plain version")
    log(f"profile_kernels at {list(PROFILE_SHAPES)}: every kernel row's "
        "output within its bound of the ref row's")


# ----------------------------------------------------------------- timing

def time_kernels(dev, gen):
    """One local SOAP step's worth of each kernel's work on ViT-Tiny at
    S=5 (12 blocks x 4 matrix leaves, refresh excluded): ``time_soap_step``
    over its 48 matrix leaves."""
    leaves = [leaf_inputs(m, n, S_VIT, dev, gen)
              for _ in range(VIT_TINY["layers"]) for m, n in VIT_LEAVES]
    return time_soap_step(f"one local step of ViT-Tiny (S={S_VIT})", leaves,
                          leaves)


def time_soap_step(what, leaves, adam_leaves, reps=5):
    """One local SOAP step's kernel work, refresh excluded: the six
    products of each matrix leaf of ``leaves`` and ``adam_moments`` over
    ``adam_leaves``, timed for the kernel, the plain version and a
    PyTorch library call, beside the card's bound for the same work.
    ``ms`` (CUDA events around the loop of launches) includes the host's
    launch rate; ``device_ms`` and its plain and library counterparts are
    the device time alone.  ``matmul_fused`` is timed as SOAP's step runs
    it (5 grouped launches: ``ms``, ``device_ms``) and one product per
    launch (``single_ms``, ``single_device_ms``); its library time is
    cuBLAS's ``bmm``/``baddbmm``, one call per product.  ``reps`` calls
    a timing (``timed``)."""
    from repro_torch.kernels.ns_ortho.kernel import (
        matmul_fused, matmul_fused_group, matmul_fused_plain,
    )
    from repro_torch.kernels.soap_rotate.kernel import (
        adam_moments, adam_moments_plain,
    )
    forms = [f for x in leaves for f in gemm_forms(x)]

    def gemm(fn):
        def run():
            for _, a, b, aux, alpha, beta in forms:
                fn(a, b, aux, alpha=alpha, beta=beta)
        return run

    def library(a, b, aux, alpha, beta):
        if aux is None:
            return torch.bmm(a, b)
        return torch.baddbmm(aux, a, b, beta=beta, alpha=alpha)

    flops = bytes_ = 0
    for _, a, b, aux, alpha, beta in forms:
        s, m, k = a.shape
        n = b.shape[-1]
        flops += 2 * s * m * n * k + (3 if aux is not None else 1) * s * m * n
        ins = {a.data_ptr(): a.numel(), b.data_ptr(): b.numel()}
        if aux is not None:
            ins[aux.data_ptr()] = aux.numel()
        bytes_ += 4 * (sum(ins.values()) + s * m * n)
    gemm_bound = max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    gemm_by = "bytes" if bytes_ / HBM_BYTES_PER_S > flops / FP32_FLOPS \
        else "operations"

    def adam(fn):
        def run():
            for x in adam_leaves:
                fn(x["g"], x["M"], x["V"], step=3)
        return run

    elems = sum(x["g"].numel() for x in adam_leaves)
    adam_bytes, adam_flops = 24 * elems, 12 * elems
    adam_bound = max(adam_bytes / HBM_BYTES_PER_S,
                     adam_flops / FP32_FLOPS) * 1e3

    groups = step_groups(forms)

    def grouped():
        for group in groups:
            matmul_fused_group(group)

    out = {}
    t, d = {}, {}
    for key, fn in (("g", grouped), ("k", gemm(matmul_fused)),
                    ("p", gemm(matmul_fused_plain)), ("l", gemm(library))):
        t[key], d[key] = timed(fn, reps), device_ms(fn, floor_ms=gemm_bound)
    out["matmul_fused"] = dict(
        ms=t["g"], plain_ms=t["p"], library_ms=t["l"], bound_ms=gemm_bound,
        bound_by=gemm_by, device_ms=d["g"], plain_device_ms=d["p"],
        library_device_ms=d["l"], single_ms=t["k"], single_device_ms=d["k"])
    log(f"matmul_fused, {what} ("
        f"{len(forms)} products, {flops / 1e9:.1f} GFLOP, "
        f"{bytes_ / 1e6:.1f} MB): grouped ({len(groups)} launches) "
        f"{t['g']:.3f} ms, single ({len(forms)} launches) {t['k']:.3f} ms, "
        f"plain {t['p']:.3f} ms, torch.bmm/baddbmm {t['l']:.3f} ms; device "
        f"time {d['g']:.3f} / {d['k']:.3f} / {d['p']:.3f} / {d['l']:.3f} "
        f"ms; bound {gemm_bound:.3f} ms ({gemm_by})")
    t, d = {}, {}
    for key, fn in (("k", adam(adam_moments)),
                    ("p", adam(adam_moments_plain))):
        t[key], d[key] = timed(fn, reps), device_ms(fn, floor_ms=adam_bound)
    out["adam_moments"] = dict(
        ms=t["k"], plain_ms=t["p"], library_ms=None, bound_ms=adam_bound,
        bound_by="bytes", device_ms=d["k"], plain_device_ms=d["p"],
        library_device_ms=None)
    log(f"adam_moments, {what} ("
        f"{len(adam_leaves)} launches, {elems / 1e6:.2f} M elements, "
        f"{adam_bytes / 1e6:.1f} MB): kernel {t['k']:.3f} ms, plain "
        f"{t['p']:.3f} ms; device time {d['k']:.3f} / {d['p']:.3f} ms; "
        f"bound {adam_bound:.3f} ms (bytes)")
    return out


def time_sophia_and_wire_kernels(vit_shapes, dev, gen):
    """The Sophia and qblock kernels' work on ViT-Tiny at S=5 (all 127
    leaves): ``sophia_update`` for one local step, ``quantize`` and
    ``dequant_accumulate`` for one upload channel of one round.  Timed
    as ``time_kernels`` times the SOAP kernels: each as the path runs it
    (one grouped launch: ``ms``, ``device_ms``) and one leaf a launch
    (127 launches: ``single_ms``, ``single_device_ms``).  No single
    PyTorch call computes any of the three functions, so there is no
    library time."""
    from repro_torch.kernels.fused_agg.kernel import (
        dequant_accumulate, dequant_accumulate_group,
        dequant_accumulate_plain,
    )
    from repro_torch.kernels.qblock.kernel import (
        n_blocks, quantize, quantize_group, quantize_plain,
    )
    from repro_torch.kernels.sophia_update.kernel import (
        sophia_update, sophia_update_group, sophia_update_plain,
    )
    shapes = [(S_VIT, *shp) for shp in vit_shapes]
    soph = [sophia_inputs(shp, dev, gen) for shp in shapes]
    soph_cols = tuple(zip(*soph))
    rows = [torch.randn((S_VIT, math.prod(shp)), generator=gen, device=dev)
            * 1e-3 for shp in vit_shapes]
    coded = [quantize(x) for x in rows]
    coded_cols = tuple(zip(*coded))
    w = torch.ones(S_VIT, device=dev)
    elems = sum(x.numel() for x in rows)
    scales = sum(S_VIT * n_blocks(x.shape[1], 128) for x in rows)
    n_out = elems // S_VIT
    work = {
        "sophia_update": dict(
            fns=[lambda: sophia_update_group(*soph_cols),
                 lambda: [sophia_update_plain(*x) for x in soph],
                 lambda: [sophia_update(*x) for x in soph]],
            bytes=20 * elems, flops=6 * elems,
            what=f"one local step, {len(soph)} leaves, "
                 f"{elems / 1e6:.2f} M elements"),
        "quantize": dict(
            fns=[lambda: quantize_group(rows),
                 lambda: [quantize_plain(x) for x in rows],
                 lambda: [quantize(x) for x in rows]],
            bytes=4 * elems + elems + 4 * scales, flops=5 * elems,
            what=f"one channel of one round, {len(rows)} leaves, "
                 f"{elems / 1e6:.2f} M elements"),
        "dequant_accumulate": dict(
            fns=[lambda: dequant_accumulate_group(*coded_cols, w),
                 lambda: [dequant_accumulate_plain(q, s, w)
                          for q, s in coded],
                 lambda: [dequant_accumulate(q, s, w) for q, s in coded]],
            bytes=elems + 4 * scales + 4 * S_VIT + 4 * n_out,
            flops=2 * elems + scales,
            what=f"one channel of one round, {len(coded)} leaves, "
                 f"{elems / 1e6:.2f} M int8 values from {S_VIT} clients"),
    }
    out = {}
    for name, x in work.items():
        t = [timed(fn) for fn in x["fns"]]
        d = [device_ms(fn) for fn in x["fns"]]
        by_bytes = x["bytes"] / HBM_BYTES_PER_S
        by_ops = x["flops"] / FP32_FLOPS
        bound = max(by_bytes, by_ops) * 1e3
        by = "bytes" if by_bytes >= by_ops else "operations"
        out[name] = dict(
            ms=t[0], plain_ms=t[1], library_ms=None, bound_ms=bound,
            bound_by=by, device_ms=d[0], plain_device_ms=d[1],
            library_device_ms=None)
        single = ""
        if len(t) > 2:
            out[name].update(single_ms=t[2], single_device_ms=d[2])
            single = (f", one leaf a launch {t[2]:.3f} ms ({d[2]:.3f} ms "
                      "device)")
        log(f"{name}, {x['what']} ({x['bytes'] / 1e6:.1f} MB): kernel "
            f"{t[0]:.3f} ms, plain {t[1]:.3f} ms; device time {d[0]:.3f} / "
            f"{d[1]:.3f} ms; bound {bound:.3f} ms ({by}){single}")
    return out


def time_newton_schulz(mats):
    """One ViT-Tiny Muon step's orthogonalisation at S=5 (48 matrices, 5
    steps): the composition as Muon runs it (15 grouped launches), its
    plain version, and cuBLAS through ``torch.bmm``/``baddbmm`` (one call
    a product, 720 calls), beside the card's bound for the same work
    (each input read and each output written once; the products'
    operations at the FP32 rate)."""
    from repro_torch.kernels.ns_ortho.ops import (
        NS_COEFFS, newton_schulz_group, newton_schulz_group_plain,
    )
    a, b, c = NS_COEFFS

    def library():
        for g in mats:
            x = g.transpose(1, 2) if g.shape[1] > g.shape[2] else g
            x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
                     + 1e-7)
            for _ in range(5):
                aa = torch.bmm(x, x.transpose(1, 2))
                bb = torch.baddbmm(aa, aa, aa, beta=b, alpha=c)
                x = torch.baddbmm(x, bb, x, beta=a)

    flops = 0
    for g in mats:
        s, m, n = g.shape
        m, n = min(m, n), max(m, n)
        # X X^T (no epilogue), then c A A + b A (a multiply and an FMA
        # an element), then B X + a X (one FMA an element)
        flops += 5 * (2 * s * m * m * n
                      + 2 * s * m * m * m + 3 * s * m * m
                      + 2 * s * m * m * n + 2 * s * m * n)
    bytes_ = 8 * sum(g.numel() for g in mats)
    bound = max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    by = "bytes" if bytes_ / HBM_BYTES_PER_S > flops / FP32_FLOPS \
        else "operations"
    fns = {"k": lambda: newton_schulz_group(mats),
           "p": lambda: newton_schulz_group_plain(mats), "l": library}
    t = {k: timed(fn) for k, fn in fns.items()}
    d = {k: device_ms(fn) for k, fn in fns.items()}
    log(f"newton_schulz, one Muon step of ViT-Tiny (S={S_VIT}, {len(mats)} "
        f"matrices, 5 steps, {flops / 1e9:.1f} GFLOP): grouped (15 launches) "
        f"{t['k']:.3f} ms, plain {t['p']:.3f} ms, torch.bmm/baddbmm (720 "
        f"calls) {t['l']:.3f} ms; device time {d['k']:.3f} / {d['p']:.3f} / "
        f"{d['l']:.3f} ms; bound {bound:.3f} ms ({by})")
    return {"newton_schulz": dict(
        ms=t["k"], plain_ms=t["p"], library_ms=t["l"], bound_ms=bound,
        bound_by=by, device_ms=d["k"], plain_device_ms=d["p"],
        library_device_ms=d["l"])}


# -------------------------------------------------------------- main path

def vit_tiny_spec():
    from repro_torch.api import resolve_scenario
    base = resolve_scenario("cifar_like_vit")
    return dataclasses.replace(
        base, name="cifar_like_vit_tiny",
        source_kwargs=dict(base.source_kwargs, image_size=32, n_classes=100),
        model_kwargs=VIT_TINY)


def kernel_wrappers():
    from repro_torch.kernels.fused_agg.kernel import dequant_accumulate
    from repro_torch.kernels.ns_ortho.kernel import matmul_fused
    from repro_torch.kernels.qblock.kernel import quantize
    from repro_torch.kernels.soap_rotate.kernel import adam_moments
    from repro_torch.kernels.sophia_update.kernel import sophia_update
    return {"adam_moments": adam_moments, "matmul_fused": matmul_fused,
            "sophia_update": sophia_update, "quantize": quantize,
            "dequant_accumulate": dequant_accumulate}


def run_experiment(label, exp, expect=(), finite=FINITE):
    """Drive ``exp`` for its rounds with every launch counter set to 0
    just before and read just after; fails if a kernel of ``expect`` was
    never launched or a metric of ``finite`` is not finite.  Returns
    (history, launches)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    for _ in range(exp.fed.rounds):
        t0 = time.perf_counter()
        rec = exp.run_round()   # ends in host reads of the metrics
        dt = time.perf_counter() - t0
        log(f"{label} round {rec['round']}: {dt:.2f} s "
            + json.dumps({k: rec[k] for k in sorted(rec)}))
        for k in finite:
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{label}: non-finite {k} {rec[k]}")
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"{label}: launches " + json.dumps(launches))
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was never launched")
    return exp.history, launches


def metrics_on_card(exp):
    """Wraps ``exp``'s round so that it fails unless every tensor metric of
    the round (drift and norm_drift included) lives on the card."""
    inner = exp.round_fn

    def round_fn(*args):
        out = inner(*args)
        off = {k: str(v.device) for k, v in out[2].items()
               if isinstance(v, torch.Tensor) and v.device.type != "cuda"}
        missing = {"drift", "norm_drift", "loss", "beta"} - {
            k for k, v in out[2].items() if isinstance(v, torch.Tensor)}
        if off or missing:
            raise AssertionError(f"round metrics off the card: {off}, not "
                                 f"tensors: {sorted(missing)}")
        return out

    exp.round_fn = round_fn
    return exp


def compare_histories(label, want, got, tol, rel_tol,
                      what="GPU history agrees with the CPU plain path"):
    for r, (w, g) in enumerate(zip(want, got)):
        for k, t in tol.items():
            if abs(w[k] - g[k]) > t:
                raise AssertionError(f"{label} GPU vs CPU round {r + 1} {k}: "
                                     f"{g[k]} vs {w[k]} (tol {t})")
        for k, t in rel_tol.items():
            if abs(w[k] - g[k]) > t * abs(w[k]):
                raise AssertionError(f"{label} GPU vs CPU round {r + 1} {k}: "
                                     f"{g[k]} vs {w[k]} (rel tol {t})")
    log(f"{label}: {what}")


def with_host_probes(exp):
    """Rebuild ``exp``'s round with Hutchinson probes drawn on the host
    from the round's seed and step, then moved to the run's device, so a
    GPU run and a CPU run of the same seed use the same probes (a CUDA
    and a CPU generator give different bits)."""
    from repro_torch.core.algorithms import build_round_fn
    from repro_torch.core.client import rademacher_like
    from repro_torch.utils.tree import tree_map
    s = max(1, int(round(exp.fed.n_clients * exp.fed.participation)))
    like = tree_map(lambda p: torch.empty((s, *p.shape)), exp.server.params)

    def probe_fn(seed, k):
        gen = torch.Generator().manual_seed(seed * 1000 + k)
        return tree_map(lambda u: u.to(exp.device), rademacher_like(like,
                                                                    gen))

    exp.round_fn = build_round_fn(
        exp.spec, exp.loss_fn, exp.opt, lr=exp.lr,
        local_steps=exp.fed.local_steps,
        beta=exp.spec.resolve_beta(exp.fed.beta),
        hessian_freq=exp.fed.hessian_freq, server_lr=exp.fed.server_lr,
        transport=exp.transport, executor=exp.fed.executor_config(),
        n_clients=exp.fed.n_clients, probe_fn=probe_fn)
    return exp


def check_qblock_bytes(label, exp, hist, shapes):
    """The wire carries n int8 + ceil(n/128) f32 scales per leaf on each
    of the two channels (Theta = {h} has the params' shapes)."""
    want = 2 * sum(math.prod(s) + 4 * -(-math.prod(s) // 128)
                   for s in shapes)
    got = {hist[-1]["upload_bytes"], exp.comm_bytes_per_round()}
    if got != {want}:
        raise AssertionError(f"{label}: upload bytes {got}, want {want}")
    log(f"{label}: {want} upload bytes per client per round (int8 + "
        "scales on both channels)")


def check_wire_bytes(label, exp, hist):
    """The round's measured upload bytes equal the transport's count for
    one client (``comm_bytes_per_round`` encodes one client's trees: for
    the low-rank codecs, real SVDs or sketches, timed here)."""
    t0 = time.perf_counter()
    want = exp.comm_bytes_per_round()
    secs = time.perf_counter() - t0
    got = {r["upload_bytes"] for r in hist}
    if got != {want}:
        raise AssertionError(f"{label}: upload bytes {got}, want {want}")
    log(f"{label}: {want} upload bytes per client per round "
        f"(comm_bytes_per_round in {secs:.3f} s)")
    return want


def check_leaf_kinds(label, exp):
    """The Theta channel's first (low-rank) stage compresses some leaves
    of one client's Theta and passes others through dense."""
    from repro_torch.core.transport.chain import Chain
    from repro_torch.utils.tree import tree_leaves, tree_map
    codec = exp.transport.theta
    if isinstance(codec, Chain):
        codec = codec.stages[0]
    msg = codec.encode(tree_map(lambda x: x[None], exp.server.theta))
    kinds = collections.Counter(m.kind for m in tree_leaves(msg.leaves))
    if len(kinds) != 2 or "dense" not in kinds:
        raise AssertionError(f"{label}: Theta leaf kinds {dict(kinds)}, "
                             "want a low-rank kind and dense")
    log(f"{label}: Theta leaves " + json.dumps(dict(kinds)))


def main_paths(vit_shapes, cnn_shapes):
    """Drives every path; returns each kernel's launches summed over the
    paths that ran it (each counted from 0)."""
    from repro_torch.api import build_experiment, materialize
    from repro_torch.convert import params_from_numpy, params_to_numpy

    spec = vit_tiny_spec()
    vit = materialize(spec, seed=0, n_clients=spec.n_clients, device="cuda")
    cnn = materialize("cifar_like_cnn", seed=0, device="cuda")
    cpu_params = params_from_numpy(params_to_numpy(cnn.params), "cpu")
    cnn_cpu = dataclasses.replace(
        materialize("cifar_like_cnn", seed=0, device="cpu"),
        params=cpu_params)
    soap_k = ("matmul_fused", "adam_moments")
    wire_k = ("sophia_update", "quantize", "dequant_accumulate")
    total = dict.fromkeys(kernel_wrappers(), 0)
    # newton_schulz launches no kernel of its own: its row carries the
    # matmul_fused launches of the Muon paths, where every matmul_fused
    # launch is a Newton-Schulz product
    total["newton_schulz"] = 0

    def drive(label, exp, expect, mf_step=5, ns_step=0, ns_refresh=0,
              dq_round=3):
        hist, launches = run_experiment(label, exp, expect)
        for name, n in launches.items():
            total[name] += n
        if ns_step and not mf_step:
            total["newton_schulz"] += launches["matmul_fused"]
        # SOAP's step is 5 grouped launches (the EMAs, 4 rotations), and a
        # Newton–Schulz refresh (once a round at K = precond_freq = 10) 15
        # more; Muon's step 15 (3 grouped products a Newton–Schulz step);
        # Sophia's step one; a qblock round of an aligned algorithm
        # encodes twice (delta, theta; a chain's qblock stage encodes its
        # whole payload tree in one launch) and flushes 3 times (delta,
        # theta twice; a lowrank_svd+qblock theta peels to the low-rank
        # GEMM, so only the delta's)
        steps = exp.fed.local_steps * exp.fed.rounds
        ns = ns_step * steps + ns_refresh * exp.fed.rounds
        for name, want, what in (
                ("matmul_fused", mf_step * steps + ns,
                 f"{mf_step + ns_step} per local step + {ns_refresh} per "
                 "refresh"),
                ("sophia_update", steps, "1 per local step"),
                ("quantize", 2 * exp.fed.rounds, "2 per round"),
                ("dequant_accumulate", dq_round * exp.fed.rounds,
                 f"{dq_round} per round")):
            if name in expect and launches[name] != want:
                raise AssertionError(f"{label}: {launches[name]} {name} "
                                     f"launches, want {want} ({what})")
        return hist

    # SOAP
    vit_soap = {}
    for algo in ("local_soap", "fedpac_soap"):
        vit_soap[algo] = drive(f"vit_tiny {algo}", build_experiment(
            algo, scenario=vit, participation=0.5, rounds=ROUNDS), soap_k)
    cnn_gpu = drive("cifar_like_cnn fedpac_soap", build_experiment(
        "fedpac_soap", scenario=cnn, rounds=ROUNDS,
        opt_kwargs={"eps": CNN_EPS}), soap_k)
    ref, _ = run_experiment(
        "cifar_like_cnn fedpac_soap (cpu reference)", build_experiment(
            "fedpac_soap", scenario=cnn_cpu, rounds=ROUNDS, device="cpu",
            opt_kwargs={"eps": CNN_EPS}))
    compare_histories("cifar_like_cnn fedpac_soap", ref, cnn_gpu, CNN_TOL,
                      CNN_REL_TOL)

    # Sophia, dense and on the qblock wire with error feedback
    sophia_kw = dict(participation=0.5, rounds=ROUNDS, lr=SOPHIA_LR,
                     hessian_freq=10)
    for algo in ("local_sophia", "fedpac_sophia"):
        drive(f"vit_tiny {algo}", build_experiment(
            algo, scenario=vit, **sophia_kw), ("sophia_update",))
    label = "vit_tiny fedpac_sophia qblock+ef"
    exp = build_experiment("fedpac_sophia", scenario=vit, **sophia_kw,
                           **QBLOCK)
    hist = drive(label, exp, wire_k)
    check_qblock_bytes(label, exp, hist, vit_shapes)

    label = "cifar_like_cnn fedpac_sophia qblock+ef"
    cnn_kw = dict(rounds=ROUNDS, lr=SOPHIA_LR, hessian_freq=10, **QBLOCK)
    exp = with_host_probes(build_experiment("fedpac_sophia", scenario=cnn,
                                            **cnn_kw))
    cnn_gpu = drive(label, exp, wire_k)
    check_qblock_bytes(label, exp, cnn_gpu, cnn_shapes)
    ref, _ = run_experiment(f"{label} (cpu reference)", with_host_probes(
        build_experiment("fedpac_sophia", scenario=cnn_cpu, device="cpu",
                         **cnn_kw)))
    compare_histories(label, ref, cnn_gpu, SOPHIA_TOL, SOPHIA_REL_TOL)

    # Muon on the grouped Newton-Schulz composition, and SOAP's NS refresh
    muon_k = ("matmul_fused", "adam_moments")
    for algo in ("local_muon", "fedpac_muon"):
        exp = build_experiment(algo, scenario=vit, participation=0.5,
                               rounds=ROUNDS)
        if exp.lr != 3e-2:
            raise AssertionError(f"{algo}: lr {exp.lr}, want Muon's 3e-2")
        drive(f"vit_tiny {algo}", exp, muon_k, mf_step=0, ns_step=15)
    drive("vit_tiny fedpac_soap eig_method=ns", build_experiment(
        "fedpac_soap", scenario=vit, participation=0.5, rounds=ROUNDS,
        opt_kwargs={"eig_method": "ns"}), muon_k, ns_refresh=15)

    # the CNN against the CPU path: Muon (its stem conv flattens tall, so
    # it is orthogonalised as its transpose), then the SGD baselines
    for algo, expect, counts in (
            ("fedpac_muon", muon_k, dict(mf_step=0, ns_step=15)),
            ("fedavg", (), {}), ("fedcm", (), {})):
        label = f"cifar_like_cnn {algo}"
        cnn_gpu = drive(label, metrics_on_card(build_experiment(
            algo, scenario=cnn, rounds=ROUNDS)), expect, **counts)
        ref, _ = run_experiment(f"{label} (cpu reference)", build_experiment(
            algo, scenario=cnn_cpu, rounds=ROUNDS, device="cpu"))
        compare_histories(label, ref, cnn_gpu, FIRST_ORDER_TOL,
                          FIRST_ORDER_REL_TOL)

    # the low-rank wire at ViT-Tiny: SOAP with the rank-4 SVD Theta
    # upload, and Muon with the qblock delta, the lowrank_svd+qblock Theta
    # chain on the bf16 wire and error feedback
    light_rounds = 2
    label = "vit_tiny fedpac_soap_light"
    exp = build_experiment("fedpac_soap_light", scenario=vit,
                           participation=0.5, rounds=light_rounds,
                           svd_rank=LIGHT_RANK)
    light = check_wire_bytes(label, exp, drive(label, exp, soap_k))
    dense = vit_soap["fedpac_soap"][-1]["upload_bytes"]
    log(f"Table 6 ratio at ViT-Tiny (round lines): fedpac_soap_light / "
        f"fedpac_soap upload bytes per client = {light} / {dense} = "
        f"{light / dense:.4f}")
    label = "vit_tiny fedpac_muon_light qblock+lowrank_svd+qblock bf16 ef"
    exp = build_experiment("fedpac_muon_light", scenario=vit,
                           participation=0.5, rounds=light_rounds,
                           **MUON_LIGHT)
    check_wire_bytes(label, exp, drive(
        label, exp, muon_k + ("quantize", "dequant_accumulate"), mf_step=0,
        ns_step=15, dq_round=1))

    # SCAFFOLD, FedPM and the low-rank Theta uploads on the CNN, against
    # the CPU path
    for algo, kw, expect, counts, tol in (
            ("scaffold", {}, (), {}, (FIRST_ORDER_TOL, FIRST_ORDER_REL_TOL)),
            ("fedpm_soap", dict(opt_kwargs=FEDPM_OPT), soap_k,
             dict(ns_refresh=15), (CNN_TOL, CNN_REL_TOL)),
            ("fedpac_soap", dict(theta_codec="power_sketch",
                                 svd_rank=CNN_SOAP_RANK,
                                 opt_kwargs={"eps": CNN_EPS}), soap_k, {},
             (CNN_TOL, CNN_REL_TOL)),
            ("fedpac_soap_light", dict(svd_rank=CNN_SOAP_RANK,
                                       opt_kwargs={"eps": CNN_EPS}),
             soap_k, {}, (CNN_TOL, CNN_REL_TOL))):
        label = " ".join(["cifar_like_cnn", algo] + [
            f"{k}={v}" for k, v in {**kw, **kw.get("opt_kwargs", {})}.items()
            if k in ("theta_codec", "eig_method")])
        exp = metrics_on_card(build_experiment(algo, scenario=cnn,
                                               rounds=ROUNDS, **kw))
        cnn_gpu = drive(label, exp, expect, **counts)
        if "svd_rank" in kw:
            check_leaf_kinds(label, exp)
        check_wire_bytes(label, exp, cnn_gpu)
        ref, _ = run_experiment(f"{label} (cpu reference)", build_experiment(
            algo, scenario=cnn_cpu, rounds=ROUNDS, device="cpu", **kw))
        compare_histories(label, ref, cnn_gpu, *tol)
    return total


def async_config(**kw):
    from repro_torch.api import AsyncConfig, LatencyModel
    return AsyncConfig(latency=LatencyModel(**ASYNC_LATENCY), **ASYNC_KW,
                       **kw)


def run_async(label, exp, expect=(), after_flush=None):
    """Drive ``exp``'s flushes with the launch counters set to 0 just
    before and read just after, and a ``MemorySink`` attached: every event
    must pass ``validate_event`` with contiguous numbering, the
    ``client_dropped`` events must number ``total_dropped +
    total_discarded``, the scheduler's dispatches must split into trained
    ones (one ``local_update`` span each) and dropped ones, each flush's
    staleness histogram must hold the buffer and its telemetry be finite,
    and ``upload_bytes`` must equal ``comm_bytes_per_round()``.
    ``after_flush(exp, sink, flush)`` runs after each flush.  Returns
    (history, launches, trained dispatches, sink)."""
    from repro_torch.obs import MemorySink, attach, validate_event
    sink = MemorySink()
    attach(exp, sink)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    secs, dispatches = [], []
    for flush in range(1, exp.fed.rounds + 1):
        d0 = exp.scheduler._seq
        t0 = time.perf_counter()
        rec = exp.run_round()   # ends in host reads of the metrics
        secs.append(time.perf_counter() - t0)
        dispatches.append(exp.scheduler._seq - d0)
        log(f"{label} flush {flush}: {secs[-1]:.2f} s, {dispatches[-1]} "
            "dispatches " + json.dumps({k: rec[k] for k in sorted(rec)}))
        for k in ("loss", "test_loss", "drift", "norm_drift"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{label}: non-finite {k} {rec[k]}")
        if after_flush is not None:
            after_flush(exp, sink, flush)
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"{label}: launches " + json.dumps(launches))
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was never launched")
    for ev in sink.events:
        validate_event(ev)
    if [e["seq"] for e in sink.events] != list(range(len(sink.events))):
        raise AssertionError(f"{label}: trace numbering is not contiguous")
    drops = sum(e["event"] == "client_dropped" for e in sink.events)
    if drops != exp.total_dropped + exp.total_discarded:
        raise AssertionError(f"{label}: {drops} client_dropped events, "
                             f"{exp.total_dropped} dropped + "
                             f"{exp.total_discarded} discarded")
    trained = sum(e.get("phase") == "local_update" for e in sink.events)
    in_flight_dropped = sum(ev.dropped for ev in exp.scheduler._heap)
    if exp.scheduler._seq != trained + exp.total_dropped + in_flight_dropped:
        raise AssertionError(f"{label}: {exp.scheduler._seq} dispatches, "
                             f"{trained} trained")
    for e in sink.rounds():
        tele = e["telemetry"]
        if sum(tele["staleness_hist"]) != exp.acfg.buffer_size:
            raise AssertionError(f"{label}: staleness histogram "
                                 f"{tele['staleness_hist']}")
        vals = [v for v in tele.values() if not isinstance(v, list)]
        vals += tele["client_geom_dist"]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{label}: non-finite telemetry {tele}")
    check_wire_bytes(label, exp, exp.history)
    log(f"{label}: {sum(secs) / len(secs):.2f} s and "
        f"{sum(dispatches) / len(dispatches):.1f} dispatches a flush "
        f"({trained} trained, {exp.total_dropped} dropped, "
        f"{exp.total_discarded} discarded over {len(secs)} flushes; the "
        f"first flush fills {exp.scheduler.concurrency} slots)")
    return exp.history, launches, trained, sink


def checkpoint_and_resume(exp, sink):
    """Saves ``exp``'s server and tracer identity with
    ``CheckpointManager``, restores the server into a fresh CUDA template
    (every tensor bitwise equal) and continues the trace from the saved
    identity into ``sink``."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import init_server
    from repro_torch.core.algorithms import zero_theta
    from repro_torch.core.engine import make_controller
    from repro_torch.obs import Tracer
    from repro_torch.utils.tree import tree_leaves, tree_map
    zeros = tree_map(torch.zeros_like, exp.server.params)
    tmpl = dataclasses.replace(
        init_server(zeros, geom=make_controller(0.0, device="cuda")),
        theta=zero_theta(exp.opt, zeros))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        mgr = CheckpointManager(d, keep=1)
        mgr.save(exp.server, telemetry=exp.tracer.state())
        restored = mgr.restore(tmpl)
        meta = mgr.restore_meta()
        secs = time.perf_counter() - t0
    n = bad = 0
    for name in ("params", "theta", "g_global"):
        for a, b in zip(tree_leaves(getattr(exp.server, name)),
                        tree_leaves(getattr(restored, name))):
            n += 1
            bad += int(b.device.type != "cuda" or a.shape != b.shape
                       or bits_differ(b, a) > 0)
    same_geom = all(torch.equal(getattr(restored.geom, f),
                                getattr(exp.server.geom, f))
                    for f in ("beta", "drift_ema"))
    if bad or not same_geom or (restored.round, restored.theta_version) != (
            exp.server.round, exp.server.theta_version):
        raise AssertionError(f"checkpoint: {bad} of {n} tensors differ "
                             "after the restore")
    tracer = Tracer.from_state(meta["telemetry"], sinks=(sink,))
    if (tracer.run_id, tracer.seq) != (exp.tracer.run_id, exp.tracer.seq):
        raise AssertionError("checkpoint: the tracer's identity changed")
    exp.tracer = tracer      # the next flush continues the numbering
    log(f"checkpoint after flush {exp.server.round}: {n} tensors saved and "
        f"restored bitwise into a CUDA template in {secs:.2f} s; trace "
        f"resumes at seq {tracer.seq}")


def check_zero_staleness(vit_shapes, dev, gen):
    """The async flush with w_i = 1 on one-client qblock messages joined
    along the client axis, against the sync ``aggregate_wire`` on the
    cohort's own encode: params, Theta and g_G bitwise equal."""
    from repro_torch.core import transport as T
    from repro_torch.core.engine import (
        AggregationConfig, aggregate_wire, make_controller,
    )
    from repro_torch.fed.async_runtime import make_async_aggregate_fn
    from repro_torch.utils.tree import tree_leaves, tree_map

    def tree(lead, scale=1.0):
        return {str(i): torch.randn((*lead, *shape), generator=gen,
                                    device=dev) * scale
                for i, shape in enumerate(vit_shapes)}

    params, g = tree(()), tree(())
    theta = tree_map(torch.abs, tree(()))
    deltas = tree((S_VIT,), 1e-2)
    thetas = tree_map(torch.abs, tree((S_VIT,)))
    tr = T.Transport(delta=T.QBlock(), theta=T.QBlock())
    cfg = AggregationConfig(lr=SOPHIA_LR, local_steps=10)
    ones = torch.ones(S_VIT, device=dev)
    want = aggregate_wire(params, theta, g, tr.delta.encode(deltas), ones,
                          cfg, tr, tmsgs=tr.theta.encode(thetas))

    def joined(codec, x):
        return T.concat_clients([codec.encode(tree_map(
            lambda t: t[i:i + 1], x)) for i in range(S_VIT)])

    flush = make_async_aggregate_fn(lr=SOPHIA_LR, local_steps=10,
                                    transport=tr, telemetry=True)
    got = flush(params, theta, g, make_controller(0.5, device=dev),
                joined(tr.delta, deltas), joined(tr.theta, thetas), ones,
                torch.zeros(S_VIT, dtype=torch.int32, device=dev))
    bad = sum(bits_differ(b, a) for i in range(3)
              for a, b in zip(tree_leaves(want[i]), tree_leaves(got[i])))
    if bad:
        raise AssertionError(f"zero-staleness flush vs sync aggregate_wire: "
                             f"{bad} values differ")
    log(f"zero staleness: the async flush of {S_VIT} one-client qblock "
        f"messages (w = 1) equals the sync aggregate_wire bitwise on "
        f"{len(vit_shapes)} ViT-Tiny leaves (params, Theta, g_G)")


def async_paths(total):
    """The buffered-async runtime: ViT-Tiny ``fedpac_soap`` (with a
    checkpoint after flush 2) and ``fedpac_sophia`` on the qblock wire
    with error feedback and ``max_staleness=1``, then CNN ``fedpac_soap``
    against the CPU path.  Adds each kernel's launches to ``total``."""
    from repro_torch.api import build_experiment, materialize
    from repro_torch.convert import params_from_numpy, params_to_numpy

    spec = vit_tiny_spec()
    vit = materialize(spec, seed=0, n_clients=spec.n_clients, device="cuda")
    k = ASYNC_SOAP_K
    label = "vit_tiny async fedpac_soap"
    exp = build_experiment(
        "fedpac_soap", scenario=vit, rounds=ASYNC_FLUSHES, local_steps=k,
        seed=ASYNC_SEED, async_cfg=async_config())
    _, launches, trained, _ = run_async(
        label, exp, ("matmul_fused", "adam_moments"),
        after_flush=lambda e, sink, f: (checkpoint_and_resume(e, sink)
                                        if f == 2 else None))
    # SOAP's step is 5 grouped launches over the one client's leaves
    if launches["matmul_fused"] != 5 * k * trained:
        raise AssertionError(f"{label}: {launches['matmul_fused']} "
                             f"matmul_fused launches, want 5 x {k} x "
                             f"{trained} trained dispatches")
    for name, n in launches.items():
        total[name] += n
    del exp

    label = "vit_tiny async fedpac_sophia qblock+ef max_staleness=1"
    k = ASYNC_K
    exp = build_experiment(
        "fedpac_sophia", scenario=vit, rounds=ASYNC_FLUSHES, local_steps=k,
        seed=ASYNC_SEED, lr=SOPHIA_LR, hessian_freq=10, **QBLOCK,
        async_cfg=async_config(max_staleness=1))
    _, launches, trained, _ = run_async(
        label, exp, ("sophia_update", "quantize", "dequant_accumulate"))
    if not exp.total_discarded:
        raise AssertionError(f"{label}: no arrival was discarded")
    # a dispatch: one sophia_update a local step, one quantize for the
    # delta and one for Theta (the EF residual decodes in plain PyTorch);
    # a flush: one dequant_accumulate for the delta and two for Theta (the
    # telemetry's Theta decode and a discard's restore are plain PyTorch)
    for name, want in (("sophia_update", k * trained),
                       ("quantize", 2 * trained),
                       ("dequant_accumulate", 3 * ASYNC_FLUSHES)):
        if launches[name] != want:
            raise AssertionError(f"{label}: {launches[name]} {name} "
                                 f"launches, want {want}")
    for name, n in launches.items():
        total[name] += n
    del exp, vit

    label = "cifar_like_cnn async fedpac_soap"
    cnn = materialize("cifar_like_cnn", seed=0, device="cuda")
    cnn_cpu = dataclasses.replace(
        materialize("cifar_like_cnn", seed=0, device="cpu"),
        params=params_from_numpy(params_to_numpy(cnn.params), "cpu"))
    kw = dict(rounds=ASYNC_FLUSHES, local_steps=ASYNC_K, seed=ASYNC_SEED,
              opt_kwargs={"eps": CNN_EPS}, async_cfg=async_config())
    exp = build_experiment("fedpac_soap", scenario=cnn, **kw)
    inner = exp._flush_fn

    def flush_on_card(*args):
        out = inner(*args)
        off = {k: str(v.device) for k, v in out[4].items()
               if isinstance(v, torch.Tensor) and v.device.type != "cuda"}
        if off:
            raise AssertionError(f"{label}: flush metrics off the card {off}")
        return out

    exp._flush_fn = flush_on_card
    gpu, launches, trained, sink = run_async(label, exp,
                                             ("matmul_fused",))
    if launches["matmul_fused"] != 5 * exp.fed.local_steps * trained:
        raise AssertionError(f"{label}: {launches['matmul_fused']} "
                             "matmul_fused launches")
    for name, n in launches.items():
        total[name] += n
    ref, _, _, ref_sink = run_async(f"{label} (cpu reference)",
                                    build_experiment(
                                        "fedpac_soap", scenario=cnn_cpu,
                                        device="cpu", **kw))
    for r, (w, g) in enumerate(zip(ref, gpu)):
        for key in ("sim_time", "staleness", "max_staleness", "dropped",
                    "discarded"):
            if w[key] != g[key]:
                raise AssertionError(f"{label} GPU vs CPU flush {r + 1} "
                                     f"{key}: {g[key]} vs {w[key]}")
    compare_histories(label, ref, gpu, CNN_TOL, CNN_REL_TOL)
    for r, (w, g) in enumerate(zip(ref_sink.rounds(), sink.rounds())):
        wt, gt = w["telemetry"], g["telemetry"]
        if gt["staleness_hist"] != wt["staleness_hist"]:
            raise AssertionError(f"{label} flush {r + 1}: staleness hist")
        for key, t in TELEMETRY_REL.items():
            for a, b in zip(*(([x[key]] if key != "client_geom_dist" else
                               x[key]) for x in (wt, gt))):
                if abs(a - b) > t * abs(a):
                    raise AssertionError(f"{label} GPU vs CPU flush {r + 1} "
                                         f"telemetry {key}: {b} vs {a}")
        for key, t in TELEMETRY_ABS.items():
            if abs(wt[key] - gt[key]) > t:
                raise AssertionError(f"{label} GPU vs CPU flush {r + 1} "
                                     f"telemetry {key}: {gt[key]} vs "
                                     f"{wt[key]}")
    log(f"{label}: simulated fields equal and telemetry within its "
        "tolerances of the CPU path")


# ------------------------------------------------------- population paths

def pop_scenario(spec, n_ids, device):
    from repro_torch.api import PartitionSpec, materialize
    return materialize(
        dataclasses.replace(spec, partition=PartitionSpec(**POP_PARTITION),
                            name=f"{spec.name}_pop"),
        seed=0, n_clients=n_ids, device=device)


def check_dequant_carry(vit_shapes, dev, gen):
    """``dequant_accumulate_group`` with a carry on ViT-Tiny's 127 leaves
    from a chunk of 4 clients at w < 1, one carry holding a NaN: one
    launch, bitwise equal to its plain version (``carry + sum``); timed
    with the carry, without it and as the carry-then-add it replaces."""
    from repro_torch.kernels.fused_agg.kernel import (
        dequant_accumulate, dequant_accumulate_group,
        dequant_accumulate_group_plain,
    )
    from repro_torch.kernels.qblock.kernel import quantize
    s = POP_VIT["pipeline_chunk"]
    coded = [quantize(torch.randn((s, math.prod(shape)), generator=gen,
                                  device=dev) * 1e-3)
             for shape in vit_shapes]
    qs, ss = (list(x) for x in zip(*coded))
    w = torch.rand(s, generator=gen, device=dev) * 0.8 + 0.1
    carry = [torch.randn(q.shape[1], generator=gen, device=dev) * 1e-2
             for q in qs]
    carry[0][5] = float("nan")
    before = (dequant_accumulate.launches, dequant_accumulate.carry_launches)
    got = dequant_accumulate_group(qs, ss, w, carry=carry)
    torch.cuda.synchronize()
    after = (dequant_accumulate.launches, dequant_accumulate.carry_launches)
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        raise AssertionError(f"dequant_accumulate with a carry over "
                             f"{len(qs)} leaves: {after[0] - before[0]} "
                             "launches, want 1 carrying")
    want = dequant_accumulate_group_plain(qs, ss, w, carry=carry)
    bad = sum(bits_differ(g, x) for g, x in zip(got, want))
    plain = dequant_accumulate_group(qs, ss, w)
    bad += sum(bits_differ(g, c + p) for g, c, p in zip(got, carry, plain))
    bad += sum(bits_differ(p, x) for p, x in zip(
        plain, dequant_accumulate_group_plain(qs, ss, w)))
    if bad or not bool(torch.isnan(got[0][5])):
        raise AssertionError(f"dequant_accumulate carry: {bad} values "
                             "differ from the plain version")
    n = sum(q.numel() for q in qs)
    out = {}
    for key, fn in (
            ("carry", lambda: dequant_accumulate_group(qs, ss, w,
                                                       carry=carry)),
            ("no_carry", lambda: dequant_accumulate_group(qs, ss, w)),
            ("carry_then_add", lambda: [c + o for c, o in zip(
                carry, dequant_accumulate_group(qs, ss, w))])):
        out[f"{key}_ms"] = timed(fn)
        out[f"{key}_device_ms"] = device_ms(fn)
    log(f"dequant_accumulate with a carry ({len(qs)} ViT-Tiny leaves, "
        f"S={s}, {n / 1e6:.2f} M int8 values, w < 1, NaN in a carry): one "
        f"launch, bitwise equal to the plain carry + sum; "
        f"{out['carry_ms']:.3f} ms ({out['carry_device_ms']:.3f} ms device)"
        f" with the carry, {out['no_carry_ms']:.3f} ms "
        f"({out['no_carry_device_ms']:.3f}) without, "
        f"{out['carry_then_add_ms']:.3f} ms "
        f"({out['carry_then_add_device_ms']:.3f}) as launch-then-add "
        f"({len(qs)} adds)")
    return out


def pipeline_checks(label, exp):
    """Wraps ``exp``'s pipeline so that it fails if a chunk's body makes
    the host wait for the card (sync debug mode "error" around it), or if
    a round's metrics are not all tensors on the card."""
    pipe = exp.pipeline
    chunk, finish = pipe._chunk, pipe._finish

    def strict_chunk(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return chunk(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def on_card(*args):
        out = finish(*args)
        off = {k: str(getattr(v, "device", "host"))
               for k, v in out[4].items()
               if not (isinstance(v, torch.Tensor)
                       and v.device.type == "cuda")}
        if off:
            raise AssertionError(f"{label}: round metrics off the card "
                                 f"{off}")
        return out

    pipe._chunk, pipe._finish = strict_chunk, on_card
    return exp


def same_runs(label, a, b, keys=("loss", "drift", "norm_drift",
                                 "upload_bytes")):
    """Histories equal on ``keys`` and server params and Theta bitwise."""
    from repro_torch.utils.tree import tree_leaves
    (ea, ha), (eb, hb) = a, b
    for r, (x, y) in enumerate(zip(ha, hb)):
        for k in keys:
            if x[k] != y[k]:
                raise AssertionError(f"{label} round {r + 1} {k}: "
                                     f"{y[k]} vs {x[k]}")
    bad = sum(bits_differ(q, p) for name in ("params", "theta")
              for p, q in zip(tree_leaves(getattr(ea.server, name)),
                              tree_leaves(getattr(eb.server, name))))
    if bad:
        raise AssertionError(f"{label}: {bad} server values differ")
    log(f"{label}: bitwise equal ({', '.join(keys)}, params, Theta)")


def population_paths(total, vit_shapes):
    """The population layer on the card: the ViT-Tiny pipelined round at
    10^6 ids against its serial and single-chunk forms, the ViT-Tiny
    restore path (sparse vs dense store, serial and pipelined), the
    reference benchmark's CNN SCAFFOLD cell against the CPU path and the
    chunked/sharded executors against vmap, and the CNN async runtime in
    population mode.  Adds each kernel's launches to ``total``."""
    import tempfile

    from repro_torch.api import build_experiment, resolve_scenario
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.kernels.fused_agg.kernel import dequant_accumulate
    from repro_torch.scenarios import cifar_like
    wire_k = ("sophia_update", "quantize", "dequant_accumulate")
    spill = tempfile.TemporaryDirectory()

    def spill_dir(name):
        return os.path.join(spill.name, name)

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    # ViT-Tiny, pipelined, full width
    vit = pop_scenario(vit_tiny_spec(), POP_SIZE, "cuda")
    runs = {}
    for name, kw in (("pipelined", dict(pipeline=True)),
                     ("serial", {}),
                     ("single-chunk", dict(
                         pipeline=True,
                         pipeline_chunk=POP_VIT["cohort_size"]))):
        label = f"vit_tiny population fedpac_sophia qblock+ef {name}"
        exp = build_experiment("fedpac_sophia", scenario=vit,
                               **{**POP_VIT, **kw},
                               spill_dir=spill_dir(name))
        if exp.pipeline is not None:
            pipeline_checks(label, exp)
        else:
            metrics_on_card(exp)
        dequant_accumulate.carry_launches = 0
        hist, launches = run_experiment(label, exp, wire_k)
        carried = dequant_accumulate.carry_launches
        add(launches)
        check_wire_bytes(label, exp, hist)
        if hist[-1]["state_peak"] > POP_VIT["state_budget"] or \
                not hist[-1]["state_spills"]:
            raise AssertionError(f"{label}: state_peak "
                                 f"{hist[-1]['state_peak']}, spills "
                                 f"{hist[-1]['state_spills']}")
        chunks = (POP_VIT["cohort_size"] // exp.pipeline.chunk
                  if exp.pipeline is not None else 1)
        rounds, k = POP_VIT["rounds"], POP_VIT["local_steps"]
        # a chunk: one sophia_update a local step; the delta and Theta
        # encodes; the delta flush and Theta's two, every chunk after the
        # first folding the running sums in the same launch
        for kname, want, got in (
                ("sophia_update", k * chunks * rounds,
                 launches["sophia_update"]),
                ("quantize", 2 * chunks * rounds, launches["quantize"]),
                ("dequant_accumulate", 3 * chunks * rounds,
                 launches["dequant_accumulate"]),
                ("dequant_accumulate with a carry",
                 3 * (chunks - 1) * rounds, carried)):
            if got != want:
                raise AssertionError(f"{label}: {got} {kname} launches, "
                                     f"want {want} ({chunks} chunks)")
        bubble = [r.get("pipeline_bubble") for r in hist]
        log(f"{label}: {chunks} chunks a round, {launches['sophia_update']}"
            f" sophia_update, {launches['quantize']} quantize, "
            f"{launches['dequant_accumulate']} dequant_accumulate "
            f"({carried} with a carry); pipeline_bubble {bubble}; state "
            f"peak {hist[-1]['state_peak']}, {hist[-1]['state_spills']} "
            "spills")
        runs[name] = (exp, hist)
    compare_histories("vit_tiny population pipelined vs serial",
                      runs["serial"][1], runs["pipelined"][1], POP_TOL,
                      POP_REL_TOL, what="within Sophia's limits " + json.dumps(
                          {k: max(abs(w[k] - g[k]) for w, g in zip(
                              runs["serial"][1], runs["pipelined"][1]))
                           for k in ("loss", "drift", "norm_drift")}))
    same_runs("vit_tiny population single-chunk pipelined vs serial",
              runs["serial"], runs["single-chunk"])
    del runs, exp, vit

    # ViT-Tiny restore path: sparse vs dense store, serial and pipelined
    vit = pop_scenario(vit_tiny_spec(), POP_RESTORE["population_size"],
                       "cuda")
    for mode, kw in (("serial", {}),
                     ("pipelined", dict(pipeline=True, pipeline_chunk=4))):
        pair = []
        for store, budget in (("sparse", POP_RESTORE["state_budget"]),
                              ("dense", POP_RESTORE["population_size"])):
            label = f"vit_tiny restore path {mode} {store} store"
            exp = build_experiment(
                "fedpac_sophia", scenario=vit,
                **{**POP_RESTORE, **kw, "state_budget": budget},
                spill_dir=spill_dir(f"restore_{mode}_{store}"))
            hist, launches = run_experiment(label, exp, wire_k)
            add(launches)
            pair.append((exp, hist))
        if not pair[0][1][-1]["state_restores"] or \
                pair[1][1][-1]["state_spills"]:
            raise AssertionError(f"vit_tiny restore path {mode}: "
                                 f"{pair[0][1][-1]['state_restores']} "
                                 "restores on the sparse store")
        log(f"vit_tiny restore path {mode}: sparse store "
            f"{pair[0][1][-1]['state_spills']} spills, "
            f"{pair[0][1][-1]['state_restores']} restores")
        same_runs(f"vit_tiny restore path {mode}: sparse vs dense store",
                  *pair)
    del pair, exp, vit

    # the reference benchmark's CNN SCAFFOLD cell, pipelined, against the
    # CPU path; the chunked and sharded executors against vmap
    cnn_spec = cifar_like(**POP_CNN_SOURCE, name="pipe_pop")
    cnn = pop_scenario(cnn_spec, POP_SIZE, "cuda")
    cnn_cpu = dataclasses.replace(
        pop_scenario(cnn_spec, POP_SIZE, "cpu"),
        params=params_from_numpy(params_to_numpy(cnn.params), "cpu"))
    label = "pipe_pop cnn population scaffold pipelined"
    kw = dict(POP_CNN, pipeline=True, pipeline_chunk=POP_CNN_CHUNK)
    exp = pipeline_checks(label, build_experiment(
        "scaffold", scenario=cnn, **kw, spill_dir=spill_dir("cnn")))
    gpu, launches = run_experiment(label, exp)
    add(launches)
    if gpu[-1]["state_peak"] > POP_CNN["state_budget"] or \
            not gpu[-1]["state_spills"]:
        raise AssertionError(f"{label}: state_peak {gpu[-1]['state_peak']}"
                             f", spills {gpu[-1]['state_spills']}")
    check_wire_bytes(label, exp, gpu)
    ref, _ = run_experiment(f"{label} (cpu reference)", build_experiment(
        "scaffold", scenario=cnn_cpu, device="cpu", **kw,
        spill_dir=spill_dir("cnn_cpu")))
    compare_histories(label, ref, gpu, FIRST_ORDER_TOL, FIRST_ORDER_REL_TOL)
    execs = {}
    for backend in ("vmap", "chunked", "sharded"):
        label = f"pipe_pop cnn population scaffold serial {backend}"
        exp = metrics_on_card(build_experiment(
            "scaffold", scenario=cnn, **POP_CNN, executor=backend,
            chunk_size=POP_CNN_CHUNK, spill_dir=spill_dir(backend)))
        execs[backend], launches = run_experiment(label, exp)
        add(launches)
    for backend in ("chunked", "sharded"):
        # the backends differ in the batch of each cuDNN call: held at
        # the GPU-vs-CPU tolerances
        compare_histories(f"pipe_pop scaffold {backend} vs vmap",
                          execs["vmap"], execs[backend], FIRST_ORDER_TOL,
                          FIRST_ORDER_REL_TOL, what="within the first-order "
                          "limits, max |loss gap| " + str(max(
                              abs(w["loss"] - g["loss"]) for w, g in zip(
                                  execs["vmap"], execs[backend]))))
    del exp, cnn, cnn_cpu

    # the async runtime in population mode: the EF residuals in the
    # sparse store (4 slots for 10 clients in flight) against the dense
    # one, bitwise; the scheduler's ids are global
    acnn = pop_scenario(resolve_scenario("cifar_like_cnn"), ASYNC_POP,
                        "cuda")
    pair = []
    for store, budget in (("sparse", ASYNC_POP_BUDGET),
                          ("dense", ASYNC_POP)):
        label = f"cifar_like_cnn async population fedpac_soap {store} store"
        exp = build_experiment(
            "fedpac_soap", scenario=acnn, rounds=ASYNC_FLUSHES,
            local_steps=ASYNC_K, seed=ASYNC_SEED,
            opt_kwargs={"eps": CNN_EPS}, delta_codec="qblock",
            population_size=ASYNC_POP, cohort_size=ASYNC_POP_BUDGET,
            state_budget=budget, spill_dir=spill_dir(f"async_{store}"),
            async_cfg=async_config())
        hist, launches, trained, _ = run_async(
            label, exp, ("matmul_fused", "adam_moments", "quantize",
                         "dequant_accumulate"))
        for kname, want in (("matmul_fused", 5 * ASYNC_K * trained),
                            ("quantize", trained),
                            ("dequant_accumulate", ASYNC_FLUSHES)):
            if launches[kname] != want:
                raise AssertionError(f"{label}: {launches[kname]} {kname} "
                                     f"launches, want {want}")
        add(launches)
        ids = list(exp.scheduler._dispatch_counts)
        dense_ids = resolve_scenario("cifar_like_cnn").n_clients
        if not all(0 <= c < ASYNC_POP for c in ids) or \
                max(ids) < dense_ids:
            raise AssertionError(f"{label}: dispatched ids {sorted(ids)}")
        pair.append((exp, hist))
    if not pair[0][1][-1]["state_spills"]:
        raise AssertionError("async population: the sparse store never "
                             "spilled")
    log(f"cifar_like_cnn async population: {len(ids)} global ids up to "
        f"{max(ids)} dispatched; sparse store "
        f"{pair[0][1][-1]['state_spills']} spills, "
        f"{pair[0][1][-1]['state_restores']} restores")
    same_runs("cifar_like_cnn async population: sparse vs dense store",
              *pair, keys=("loss", "drift", "staleness", "sim_time",
                           "upload_bytes"))
    spill.cleanup()


# ------------------------------------------------------------- LM paths

def llama60m_spec():
    """``lm_zipf`` on the published LLaMA-60M: a backbone registered
    through the public hook ``register_lm_model`` (the catalog's factory
    reduces the config, capping the heads at 4 and d_ff at 2 d_model)."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.scenarios.catalog import lm_zipf
    from repro_torch.scenarios.lm import register_lm_model

    def llama_60m(seed, *, vocab, device):
        cfg = configs.get_config("llama-60m")
        if cfg.vocab_size != vocab:
            raise ValueError(f"vocab {vocab} != {cfg.vocab_size}")
        gen = torch.Generator().manual_seed(seed)
        return M.init_params(cfg, gen, device=device), cfg

    register_lm_model("llama_60m", llama_60m)
    return dataclasses.replace(
        lm_zipf(**LM_SOURCE, name="lm_zipf_llama60m"), model="llama_60m",
        model_kwargs={})


def lm_leaves(leaves, layers, vocab, d, dev, gen, orthogonal=True):
    """An LM's 7 stacked matrix leaves ``leaves`` at S=``LM_S`` as SOAP's
    step sees them, (S x layers, m, n), and the step's 4 Adam-fallback
    leaves (the tied vocab x d embedding, the two stacked norms, the final
    norm) as g/M/V triples."""
    mats = [((m, n, LM_S * layers),
             leaf_inputs(m, n, LM_S * layers, dev, gen, orthogonal))
            for m, n in leaves]

    def triple(*shape):
        return ((shape[-2] if len(shape) > 2 else 1, shape[-1], LM_S),
                dict(g=torch.randn((LM_S, *shape), generator=gen,
                                   device=dev),
                     M=torch.randn((LM_S, *shape), generator=gen,
                                   device=dev),
                     V=torch.rand((LM_S, *shape), generator=gen,
                                  device=dev)))

    fallback = [triple(vocab, d), triple(layers, d), triple(layers, d),
                triple(d)]
    return mats, fallback


def lm_kernel_checks(dev, gen):
    """The three kernels of the LM paths held against their plain
    versions at LLaMA-60M's shapes (stacked (S, 8, m, n) leaves, factors
    up to 1376 wide, the 16.4 M-element fallback leaf), then
    ``matmul_fused`` and ``adam_moments`` timed over one SOAP step.
    Returns (max |err| by kernel, timings)."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_leaves
    mats, fallback = lm_leaves(LM_LEAVES, LM_LAYERS, 32000, 512, dev, gen)
    errs = {"matmul_fused": check_matmul_fused(mats),
            "adam_moments": check_adam_moments(mats + fallback)}
    shapes = [(LM_S, *p.shape) for p in tree_leaves(
        M.param_shapes(configs.get_config("llama-60m")))]
    errs["sophia_update"] = check_sophia_update(shapes, dev, gen)
    timings = time_soap_step(
        f"one local step of LLaMA-60M (S={LM_S}, 7 stacked matrix leaves)",
        [x for _, x in mats], [x for _, x in mats + fallback])
    return errs, timings


def lm_paths(total):
    """LLaMA-60M ``fedpac_soap`` (3 rounds), ``fedpac_sophia`` and
    ``fedpac_muon`` (2 rounds each) at full width, then the tiny
    ``lm_zipf`` GPU vs the CPU path (``fedpac_soap`` at eps=1e-3 and
    ``fedpac_sophia`` with host-drawn probes, 3 rounds).  Adds each
    kernel's launches to ``total``; returns the LM paths' own."""
    from repro_torch.api import build_experiment, materialize
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import model as M
    from repro_torch.optim.api import matrix_mask
    from repro_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    scn = materialize(llama60m_spec(), seed=0, device="cuda")
    cfg = scn.meta["model_cfg"]
    mask = tree_leaves(matrix_mask(scn.params))
    n_mat, n_fallback = sum(mask), len(mask) - sum(mask)
    log(f"LLaMA-60M: {M.num_params(cfg)} parameters, {len(mask)} leaves "
        f"({n_mat} stacked matrices, {n_fallback} Adam fallback); lm_zipf "
        f"at vocab {cfg.vocab_size}, seq {LM_SOURCE['seq_len']}, batch "
        f"{LM_SOURCE['batch']}, materialized in "
        f"{time.perf_counter() - t0:.2f} s")
    if (n_mat, n_fallback) != (7, 4):
        raise AssertionError(f"LLaMA-60M: {n_mat} matrix and {n_fallback} "
                             "fallback leaves, want 7 and 4")
    # the untrained model's loss: its logits h . e are N(0, s2) with s2 =
    # 0.02^2 d_model (unit-RMS hidden states against the tied N(0, 0.02^2)
    # embedding), so the expected cross-entropy is ln V + s2 / 2.  (A
    # round's loss is the mean over its K steps, already lower.)
    loss0 = float(scn.eval_fn(scn.params)["eval_loss"])
    want0 = math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2
    if abs(loss0 - want0) > 0.05:
        raise AssertionError(f"LLaMA-60M: initial eval loss {loss0}, want "
                             f"ln V + s2/2 = {want0}")
    lm = collections.Counter()

    def drive(label, algo, rounds, expect, per_step, **kw):
        exp = metrics_on_card(build_experiment(
            algo, scenario=scn, rounds=rounds, **LM_FL, **kw))
        hist, launches = run_experiment(label, exp, expect, LM_FINITE)
        steps = exp.fed.local_steps * rounds
        for name, per in per_step.items():
            if launches[name] != per * steps:
                raise AssertionError(f"{label}: {launches[name]} {name} "
                                     f"launches, want {per} x {steps} steps")
        lm.update(launches)
        return hist

    # SOAP's step: 5 grouped matmul_fused over the 7 stacked leaves (the
    # QR refresh launches none), one adam_moments a leaf
    hist = drive("llama-60m fedpac_soap", "fedpac_soap", 3,
                 ("matmul_fused", "adam_moments"),
                 {"matmul_fused": 5, "adam_moments": n_mat + n_fallback})
    if not loss0 > hist[0]["loss"] > hist[-1]["loss"]:
        raise AssertionError("llama-60m fedpac_soap: the loss did not fall "
                             f"({loss0} -> {hist[0]['loss']} -> "
                             f"{hist[-1]['loss']})")
    log(f"llama-60m fedpac_soap: loss {loss0:.4f} at init (ln V + s2/2 = "
        f"{want0:.4f}), {hist[0]['loss']:.4f} in round 1, "
        f"{hist[-1]['loss']:.4f} in round 3")
    # Sophia: one grouped sophia_update a step, the curvature from
    # Hutchinson's jvp of grad through attention at step 0
    drive("llama-60m fedpac_sophia", "fedpac_sophia", 2,
          ("sophia_update",), {"sophia_update": 1})
    # Muon: 15 matmul_fused a step (w_down's 1376 x 512 stack as
    # transposed views), the fallback leaves through adam_moments
    drive("llama-60m fedpac_muon", "fedpac_muon", 2,
          ("matmul_fused", "adam_moments"),
          {"matmul_fused": 15, "adam_moments": n_fallback})
    del scn

    tiny = materialize("lm_zipf", seed=0, device="cuda")
    tiny_cpu = dataclasses.replace(
        materialize("lm_zipf", seed=0, device="cpu"),
        params=params_from_numpy(params_to_numpy(tiny.params), "cpu"))
    for algo, kw, per_step, tol, rel in (
            ("fedpac_soap", dict(opt_kwargs={"eps": CNN_EPS}),
             {"matmul_fused": 5}, LM_SOAP_TOL, CNN_REL_TOL),
            ("fedpac_sophia", dict(lr=SOPHIA_LR), {"sophia_update": 1},
             LM_SOPHIA_TOL, SOPHIA_REL_TOL)):
        label = f"lm_zipf {algo}"
        kw = dict(kw, rounds=ROUNDS, local_steps=5)
        # Sophia's probes drawn on the host, the same bits on both sides
        probes = with_host_probes if "sophia_update" in per_step else (
            lambda e: e)
        exp = metrics_on_card(probes(build_experiment(
            algo, scenario=tiny, **kw)))
        gpu, launches = run_experiment(label, exp, tuple(per_step),
                                       LM_FINITE)
        for name, per in per_step.items():
            if launches[name] != per * 5 * ROUNDS:
                raise AssertionError(f"{label}: {launches[name]} {name}")
        lm.update(launches)
        ref, _ = run_experiment(f"{label} (cpu reference)", probes(
            build_experiment(algo, scenario=tiny_cpu, device="cpu", **kw)),
            finite=LM_FINITE)
        compare_histories(label, ref, gpu, tol, rel)
    for name, n in lm.items():
        total[name] += n
    return lm


# -------------------------------------------------------- traffic paths

def soap_spec_at(eps):
    """``fedpac_soap`` whose SOAP runs at ``eps``, set through the spec:
    a hot-swap hands the run's ``opt_kwargs`` to the new algorithm, and
    fedavg's SGD takes no ``eps``."""
    from repro_torch.api import resolve
    base = resolve("fedpac_soap")

    @dataclasses.dataclass(frozen=True)
    class AtEps(type(base)):
        def make_optimizer(self, **kw):
            return super().make_optimizer(**{"eps": eps, **kw})

    return AtEps(**{f.name: getattr(base, f.name)
                    for f in dataclasses.fields(base)})


def traffic_experiment(algo, scenario, **kw):
    from repro_torch.api import (
        AsyncConfig, ChurnConfig, TrafficConfig, build_experiment,
    )
    return build_experiment(
        algo, scenario=scenario, rounds=1, local_steps=TRAFFIC_K, seed=0,
        async_cfg=AsyncConfig(**TRAFFIC_ACFG),
        traffic=TrafficConfig(churn=ChurnConfig(**TRAFFIC_CHURN),
                              **TRAFFIC_TRACE), **kw)


def skeleton(events):
    """What two runs of one stream must repeat exactly: event types,
    phases, rounds, clients, versions, reasons, in-flight flags, sim
    times, algorithms (run_id, seq, dur_s and float metrics excluded)."""
    keys = ("event", "phase", "round", "client_id", "reason", "version",
            "in_flight", "sim_time", "algorithm")
    return [tuple(e.get(k) for k in keys) for e in events]


def run_traffic(label, exp, params, ckpt_dir=None):
    """Replays the stream to ``TRAFFIC_BUDGET`` with the launch counters
    set to 0 just before and read just after, a ``MemorySink`` attached,
    and (with ``ckpt_dir``) a mid-stream checkpoint after flush 2.
    Checks the trace (schema, contiguous numbering, one
    ``client_dropped`` event per dropped or discarded arrival, both
    ``client_left`` and ``algo_swap`` discards, the swap to fedavg) and
    on the card the launches: 5 ``matmul_fused`` a SOAP step and one
    ``adam_moments`` a leaf a step of every dispatch trained before the
    swap.  Returns
    (launches, sink, seq after the checkpoint)."""
    from repro_torch.obs import MemorySink, attach, validate_event
    from repro_torch.utils.tree import tree_leaves
    sink = MemorySink()
    attach(exp, sink)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    seq0 = None
    t0 = time.perf_counter()
    if ckpt_dir is not None:
        exp.run_stream(max_flushes=2)
        exp.save_checkpoint(ckpt_dir)
        seq0 = exp.tracer.seq
    summary = exp.run_stream(sim_budget=TRAFFIC_BUDGET)
    secs = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    for rec in exp.history:
        log(f"{label} flush {rec['round']}: " + json.dumps(
            {k: rec[k] for k in sorted(rec)}))
        for k in ("loss", "drift", "norm_drift"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{label}: non-finite {k} {rec[k]}")
    for rec in exp.eval_history:
        if not all(math.isfinite(v) for v in rec.values()):
            raise AssertionError(f"{label}: non-finite eval {rec}")
    log(f"{label}: {json.dumps(summary)}; launches {json.dumps(launches)}")
    for ev in sink.events:
        validate_event(ev)
    if [e["seq"] for e in sink.events] != list(range(len(sink.events))):
        raise AssertionError(f"{label}: trace numbering is not contiguous")
    reasons = collections.Counter(e["reason"] for e in sink.events
                                  if e["event"] == "client_dropped")
    if sum(reasons.values()) != exp.total_dropped + exp.total_discarded \
            or not reasons["client_left"] or not reasons["algo_swap"]:
        raise AssertionError(f"{label}: drops {dict(reasons)}, "
                             f"{exp.total_dropped} dropped + "
                             f"{exp.total_discarded} discarded")
    swap = [i for i, e in enumerate(sink.events)
            if e["event"] == "run_start" and e.get("swapped")]
    if len(swap) != 1 or exp.spec.name != "fedavg" or \
            len(exp.history) != 4:
        raise AssertionError(f"{label}: {len(swap)} swaps, now "
                             f"{exp.spec.name}, {len(exp.history)} flushes")
    soap = sum(e.get("phase") == "local_update"
               for e in sink.events[:swap[0]])
    steps = TRAFFIC_K * soap
    counted = exp.device.type == "cuda"   # the CPU path launches none
    for name, want in (("matmul_fused", 5 * steps),
                       ("adam_moments", len(tree_leaves(params)) * steps)):
        if counted and launches[name] != want:
            raise AssertionError(f"{label}: {launches[name]} {name} "
                                 f"launches, want {want} ({soap} SOAP "
                                 "dispatches)")
    log(f"{label}: {len(exp.history)} flushes in {secs:.2f} s "
        f"({secs / len(exp.history):.2f} s a flush), {soap} SOAP dispatches "
        f"before the swap, drops {dict(reasons)}")
    return launches, sink, seq0


def traffic_paths(total):
    """The continuous-traffic runtime: the quickstart's stream on ViT-Tiny
    ``fedpac_soap`` (a checkpoint after flush 2, restored into a freshly
    built experiment that continues to the same history, eval history and
    trace), then the same stream on the CNN against the CPU path (event
    stream equal, metrics within SOAP's CNN tolerances).  Adds each
    kernel's launches to ``total``."""
    import tempfile

    from repro_torch.api import materialize
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.obs import MemorySink, attach

    spec = vit_tiny_spec()
    vit = materialize(spec, seed=0, n_clients=spec.n_clients, device="cuda")
    label = "vit_tiny traffic fedpac_soap"
    with tempfile.TemporaryDirectory() as ckpt:
        exp = traffic_experiment("fedpac_soap", vit)
        launches, sink, seq0 = run_traffic(label, exp, vit.params, ckpt)
        for name, n in launches.items():
            total[name] += n
        t0 = time.perf_counter()
        again = traffic_experiment("fedpac_soap", vit)
        again_sink = MemorySink()
        attach(again, again_sink)
        again.load_checkpoint(ckpt)
        again.run_stream(sim_budget=TRAFFIC_BUDGET)
        secs = time.perf_counter() - t0
    tail = [e for e in sink.events if e["seq"] >= seq0]
    if (again.history, again.eval_history, skeleton(again_sink.events)) != \
            (exp.history, exp.eval_history, skeleton(tail)):
        raise AssertionError(f"{label}: the restored stream diverged")
    log(f"{label}: checkpoint after flush 2 restored into a fresh "
        f"experiment continued to the same history, eval history and "
        f"{len(tail)} trace events ({secs:.2f} s)")
    del exp, again, vit

    label = "cifar_like_cnn traffic fedpac_soap"
    cnn = materialize("cifar_like_cnn", seed=0, device="cuda")
    cnn_cpu = dataclasses.replace(
        materialize("cifar_like_cnn", seed=0, device="cpu"),
        params=params_from_numpy(params_to_numpy(cnn.params), "cpu"))
    algo = soap_spec_at(CNN_EPS)
    gpu = traffic_experiment(algo, cnn)
    launches, sink, _ = run_traffic(label, gpu, cnn.params)
    for name, n in launches.items():
        total[name] += n
    ref = traffic_experiment(algo, cnn_cpu, device="cpu")
    _, ref_sink, _ = run_traffic(f"{label} (cpu reference)", ref,
                                 cnn_cpu.params)
    if skeleton(sink.events) != skeleton(ref_sink.events):
        raise AssertionError(f"{label}: the event stream differs from the "
                             "CPU path's")
    compare_histories(label, ref.history, gpu.history,
                      {"loss": CNN_TOL["loss"]}, CNN_REL_TOL)
    compare_histories(label, ref.eval_history, gpu.eval_history,
                      {k: CNN_TOL[k] for k in ("test_loss", "test_acc")}, {},
                      what="GPU anytime eval agrees with the CPU plain path")
    log(f"{label}: event stream ({len(sink.events)} events) equal to the "
        "CPU path's")


# ---------------------------------------------------------- serving paths

def decode_trace(params, cfg, prompt, max_len):
    """One decode step of ``cfg`` under ``torch.profiler`` (after a
    prefill, timed by CUDA events, and one warm step): its host wall
    time, the device's busy time
    (the union of its kernels', copies' and sets' intervals), the number
    of kernels and the gaps between them on the device's timeline.  A
    trace that holds fewer kernels than the step launched (the profiler
    drops kernels as out of its window later in a long process) is taken
    again, and after 3 the run fails."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    p = prompt.shape[1]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits, caches = M.prefill(params, {"tokens": prompt}, cfg, max_len)
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(end)
    tok = torch.argmax(logits, dim=-1)[:, None]
    logits, caches = M.decode_step(params, tok, caches, p, cfg)
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            M.decode_step(params, tok, caches, p + 1, cfg)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "decode_step.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy",
                                           "gpu_memset"))
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in e.get("name", ""))
        if spans and kernels >= launches:
            break
        log(f"torch.profiler kept {kernels} kernels of the step's "
            f"{launches} launches; tracing again")
    else:
        raise AssertionError("torch.profiler lost kernels in 3 traces of a "
                             "decode step")
    busy, gaps, end = 0.0, [], spans[0][0]
    for a, b in spans:
        if a > end:
            gaps.append(a - end)
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = end - spans[0][0]
    return dict(prefill_ms=prefill_ms, wall_ms=wall_us / 1e3,
                busy_ms=busy / 1e3,
                busy_share=busy / wall_us, device_window_ms=window / 1e3,
                busy_share_of_window=busy / window, device_ops=len(spans),
                kernel_launches=launches,
                largest_gap_ms=max(gaps, default=0.0) / 1e3,
                gaps_ms=sum(gaps) / 1e3)


@contextlib.contextmanager
def routing():
    """Records the top-k experts (sorted) of every MoE layer's call while
    the block runs, as a list of (B, S, k) host tensors in call order
    (the router recomputed on the layer's input: a host read a call, so
    never inside a timed run)."""
    from repro_torch.models import moe
    inner = moe.moe_forward
    calls = []

    def spy(p, x, cfg):
        _, _, topi = moe._route(p, x.reshape(-1, x.shape[-1]), cfg)
        calls.append(torch.sort(topi, dim=-1).values.reshape(
            *x.shape[:2], -1).cpu())
        return inner(p, x, cfg)

    moe.moe_forward = spy
    try:
        yield calls
    finally:
        moe.moe_forward = inner


def routing_path(calls, n_moe):
    """Each MoE layer's experts over the positions of a run whose forwards
    (a prefill and decode steps, or one full forward) each made ``n_moe``
    calls: a list of (B, S, k), one a layer."""
    return [torch.cat(calls[layer::n_moe], dim=1) for layer in range(n_moe)]


def flips(path_a, path_b):
    """(B, S) bool: the positions whose experts differ in any MoE layer
    between two runs' routing paths."""
    return torch.stack([(a != b).any(dim=-1) for a, b in
                        zip(path_a, path_b)]).any(dim=0)


def before_first_flip(flipped):
    """(B, S) bool: the positions of each sequence before its first
    flip."""
    return torch.cumsum(flipped.to(torch.int64), dim=1) == 0


def serve_loop(arch, layers):
    """``launch.serve.main``'s prefill and greedy decode for ``arch`` at
    full width cut to ``layers`` layers (serve.py takes no depth, as the
    reference's does not), on weights and a prompt from a card generator;
    the same dict as ``main``."""
    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = configs.get_config(arch).replace(num_layers=layers,
                                           dtype="float32")
    b, p, g = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=gen,
                           device="cuda")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        marks[0].record()
        logits, caches = M.prefill(params, {"tokens": prompt}, cfg, p + g)
        marks[1].record()
        toks = torch.argmax(logits, dim=-1)[:, None]
        generated, step_logits = [toks], [logits]
        marks[2].record()
        for i in range(g - 1):
            logits, caches = M.decode_step(params, toks, caches, p + i, cfg)
            toks = torch.argmax(logits, dim=-1)[:, None]
            generated.append(toks)
            step_logits.append(logits)
        marks[3].record()
    marks[3].synchronize()
    decode_ms = marks[2].elapsed_time(marks[3])
    return dict(tokens=torch.cat(generated, dim=1), logits=step_logits,
                prefill_ms=marks[0].elapsed_time(marks[1]),
                decode_ms=decode_ms, decode_ms_per_token=decode_ms / (g - 1),
                tokens_per_s=b * (g - 1) / (decode_ms / 1e3), cfg=cfg,
                params=params, prompt=prompt)


def serve_table(arch, n_params, layers=None):
    """``arch`` served on the card (batch 8, prompt 256, 32 tokens,
    greedy): unreduced through ``launch.serve.main``, or at full width
    cut to ``layers`` layers through ``serve_loop``.  Decode held against
    a full forward over the prompt and the generated tokens (with a MoE,
    the routing of both paths recorded and its flips counted), the CUDA-
    event timings, the peak memory, and one decode step traced.  Serving
    launches none of the port's kernels (the reference's attention,
    scans and expert products are XLA, not Pallas)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.transformer import layer_groups
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if layers is None:
        out = serve.main(["--arch", arch, "--batch", str(SERVE["batch"]),
                          "--prompt-len", str(SERVE["prompt"]), "--gen",
                          str(SERVE["gen"]), "--device", "cuda"])
    else:
        out = serve_loop(arch, layers)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg, params, prompt = out["cfg"], out["params"], out["prompt"]
    launched = {n: w.launches for n, w in wrappers.items() if w.launches}
    if launched:
        raise AssertionError(f"serving launched port kernels: {launched}")
    if M.num_params(cfg) != n_params or cfg.dtype != "float32":
        raise AssertionError(f"served {cfg.name} at {M.num_params(cfg)} "
                             f"parameters in {cfg.dtype}, want {n_params}")
    b, p, g = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    if tuple(out["tokens"].shape) != (b, g):
        raise AssertionError(f"generated {tuple(out['tokens'].shape)}")
    seq = torch.cat([prompt, out["tokens"][:, :-1]], dim=1)
    n_moe = sum(n for _, n, (_, is_moe) in layer_groups(cfg) if is_moe)
    with torch.inference_mode():
        step = torch.stack(out["logits"], dim=1)
        with routing() as fwd_calls:
            full = M.forward(params, {"tokens": seq}, cfg)[0][:, p - 1:]
        n_flips, kept = 0, torch.ones((b, g), dtype=torch.bool)
        if n_moe:
            # the decode path again, teacher-forced on its own tokens,
            # with the routing recorded (the timed run recorded nothing)
            with routing() as dec_calls:
                lg, caches = M.prefill(params, {"tokens": prompt}, cfg,
                                       p + g)
                again = [lg]
                for i in range(g - 1):
                    lg, caches = M.decode_step(
                        params, out["tokens"][:, i:i + 1], caches, p + i,
                        cfg)
                    again.append(lg)
            if not torch.equal(torch.stack(again, dim=1), step):
                raise AssertionError(f"{arch}: the replayed decode differs "
                                     "from the served one")
            flipped = flips(routing_path(dec_calls, n_moe),
                            routing_path(fwd_calls, n_moe))
            n_flips = int(flipped.sum())
            kept = before_first_flip(flipped)[:, p - 1:]
        diff = (full - step).abs().amax(dim=-1).cpu()
        err = float(diff[kept].max())
        greedy = torch.equal(torch.argmax(step, dim=-1), out["tokens"])
        finite = bool(torch.isfinite(step).all())
    if not (finite and greedy and err <= SERVE_DECODE_TOL
            and n_flips <= ZOO_FLIP_BOUND):
        raise AssertionError(
            f"{arch} serve: decode vs forward max |err| {err:.3e} (bound "
            f"{SERVE_DECODE_TOL}), {n_flips} routing flips (bound "
            f"{ZOO_FLIP_BOUND}), finite {finite}, greedy {greedy}")
    what = ("unreduced" if layers is None else f"full width, cut to "
            f"{layers} of {configs.get_config(arch).num_layers} layers")
    moe_note = (f"; {n_flips} routing flips of {b * (p + g - 1)} positions "
                f"x {n_moe} MoE layers, logits held at "
                f"{int(kept.sum())} of {b * g}") if n_moe else ""
    log(f"{arch} serve ({what}, {M.num_params(cfg)} parameters, f32, batch "
        f"{b}, prompt {p}, {g} tokens): decode vs full forward over "
        f"{p + g - 1} tokens at the {g} generated positions: max |err| "
        f"{err:.3e} (bound {SERVE_DECODE_TOL}){moe_note}; prefill "
        f"{out['prefill_ms']:.3f} ms, decode "
        f"{out['decode_ms_per_token']:.3f} ms a token, "
        f"{out['tokens_per_s']:.1f} tokens/s (CUDA events); peak memory "
        f"{peak / 2**30:.3f} GiB; served in {wall:.2f} s")
    with torch.inference_mode():
        tr = decode_trace(params, cfg, prompt, p + g)
    log(f"{arch} prefill again, warm: {tr['prefill_ms']:.3f} ms (CUDA "
        "events)")
    log(f"{arch} decode step traced: wall {tr['wall_ms']:.3f} ms, "
        f"device busy {tr['busy_ms']:.3f} ms ({100 * tr['busy_share']:.1f}% "
        f"of the wall; {100 * tr['busy_share_of_window']:.1f}% of the "
        f"{tr['device_window_ms']:.3f} ms from its first device op to its "
        f"last), {tr['device_ops']} device ops from "
        f"{tr['kernel_launches']} kernel launches, gaps between them "
        f"{tr['gaps_ms']:.3f} ms in all, the largest {tr['largest_gap_ms']:.3f}"
        " ms")
    return dict(prefill_ms=out["prefill_ms"],
                decode_ms_per_token=out["decode_ms_per_token"],
                tokens_per_s=out["tokens_per_s"], peak_bytes=peak,
                max_abs_err=err, routing_flips=n_flips, trace=tr)


def serve_smollm():
    """The unreduced SmolLM-360M served through ``launch.serve.main``."""
    return serve_table("smollm-360m", 361_821_120)


def tables_on_card():
    """The six dense tables, each ``reduced()`` in f32, and a windowed
    SmolLM (window 8) decoded past its window into ring caches: prefill
    and decode steps on the card against the CPU port on the same weights
    and tokens, at ``TABLE_TOL``."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import model as M

    def both(cfg, seed):
        cpu = M.init_params(cfg, torch.Generator().manual_seed(seed))
        return cpu, params_from_numpy(params_to_numpy(cpu), "cuda")

    def tokens(cfg, seed, s):
        shape = (2, s, cfg.num_codebooks) if cfg.num_codebooks > 1 \
            else (2, s)
        t = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
        return torch.from_numpy(t.astype(np.int64))

    worst = {}
    with torch.inference_mode():
        for i, arch in enumerate(DENSE_TABLES):
            cfg = configs.get_reduced(arch).replace(dtype="float32")
            cpu, gpu = both(cfg, i)
            toks = tokens(cfg, i, 12)
            errs = []
            lc, cc = M.prefill(cpu, {"tokens": toks[:, :8]}, cfg, 12)
            lg, cg = M.prefill(gpu, {"tokens": toks[:, :8].cuda()}, cfg, 12)
            errs.append(float((lg.cpu() - lc).abs().max()))
            for t in range(8, 12):
                lc, cc = M.decode_step(cpu, toks[:, t:t + 1], cc, t, cfg)
                lg, cg = M.decode_step(gpu, toks[:, t:t + 1].cuda(), cg, t,
                                       cfg)
                errs.append(float((lg.cpu() - lc).abs().max()))
            worst[arch] = max(errs)
        cfg = configs.get_reduced("smollm-360m").replace(dtype="float32",
                                                         **RING)
        cpu, gpu = both(cfg, 99)
        toks = tokens(cfg, 99, RING_STEPS)
        cc = M.init_caches(cfg, 2, 64, ring=True)
        cg = M.init_caches(cfg, 2, 64, ring=True, device="cuda")
        errs = []
        for t in range(RING_STEPS):
            lc, cc = M.decode_step(cpu, toks[:, t:t + 1], cc, t, cfg)
            lg, cg = M.decode_step(gpu, toks[:, t:t + 1].cuda(), cg, t, cfg)
            errs.append(float((lg.cpu() - lc).abs().max()))
            if not torch.equal(cg[0]["pos"].cpu(), cc[0]["pos"]):
                raise AssertionError(f"ring decode step {t}: cache "
                                     "positions differ from the CPU's")
        worst[f"smollm-360m swa window 8 ring, {RING_STEPS} steps"] = \
            max(errs)
        if tuple(cg[0]["k"].shape[2:3]) != (RING["window"],):
            raise AssertionError(f"ring buffer {tuple(cg[0]['k'].shape)}")
    bad = {k: v for k, v in worst.items() if not v <= TABLE_TOL}
    if bad:
        raise AssertionError(f"reduced tables GPU vs CPU beyond "
                             f"{TABLE_TOL}: {bad}")
    log("reduced tables, prefill of 8 and 4 decode steps, GPU vs the CPU "
        f"port (bound {TABLE_TOL}): max |err| "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def zoo_tables_on_card():
    """The four tables of the MoE, MLA, Mamba and RG-LRU layers
    ``reduced()`` in f32 (RecurrentGemma at 3 layers, its local_attn
    layer included): prefill of 8 and 4 decode steps, then the ring-cache
    long decodes of Mixtral, Falcon-Mamba and RecurrentGemma (window 8,
    20 steps from index 0), on the card against the CPU port on the same
    weights and tokens at ``TABLE_TOL``.  The routing of every MoE layer
    is recorded on both devices and its flips counted (at most
    ``ZOO_FLIP_BOUND`` a run, the logits held before a sequence's first
    flip); a ring's cache positions must be equal."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import model as M
    from repro_torch.models.transformer import layer_groups

    def run(params, cfg, toks, dev, ring):
        """(logits (B, positions, V) on the host, routing calls, caches):
        from index 0 into ring caches, or a prefill of 8 then 4 steps."""
        toks = toks.to(dev)
        with routing() as calls:
            if ring:
                caches = M.init_caches(cfg, 2, 64, ring=True, device=dev)
                out, first = [], 0
            else:
                lg, caches = M.prefill(params, {"tokens": toks[:, :8]}, cfg,
                                       12)
                out, first = [lg], 8
            for t in range(first, toks.shape[1]):
                lg, caches = M.decode_step(params, toks[:, t:t + 1], caches,
                                           t, cfg)
                out.append(lg)
        return torch.stack(out, dim=1).cpu(), calls, caches

    worst, flipped_total = {}, {}
    runs = ([(arch, False) for arch in ZOO_TABLES]
            + [(arch, True) for arch in ZOO_RING])
    with torch.inference_mode():
        for i, (arch, ring) in enumerate(runs):
            cfg = configs.get_reduced(arch, **ZOO_TABLES[arch]).replace(
                dtype="float32")
            if ring and cfg.window:
                cfg = cfg.replace(window=8)
            cpu = M.init_params(cfg, torch.Generator().manual_seed(40 + i))
            gpu = params_from_numpy(params_to_numpy(cpu), "cuda")
            steps = RING_STEPS if ring else 12
            toks = torch.from_numpy(np.random.default_rng(40 + i).integers(
                0, cfg.vocab_size, (2, steps)).astype(np.int64))
            lc, calls_c, cc = run(cpu, cfg, toks, "cpu", ring)
            lg, calls_g, cg = run(gpu, cfg, toks, "cuda", ring)
            n_moe = sum(n for _, n, (_, m) in layer_groups(cfg) if m)
            kept = torch.ones(lc.shape[:2], dtype=torch.bool)
            label = arch + (" ring" if ring else "") + (
                f", window {cfg.window}" if ring and cfg.window else "")
            if n_moe:
                flipped = flips(routing_path(calls_c, n_moe),
                                routing_path(calls_g, n_moe))
                flipped_total[label] = int(flipped.sum())
                kept = before_first_flip(flipped)[:, steps - lc.shape[1]:]
            worst[label] = float((lg - lc).abs().amax(dim=-1)[kept].max())
            for gc_, cc_ in zip(cg, cc):
                if "pos" in cc_ and not torch.equal(gc_["pos"].cpu(),
                                                    cc_["pos"]):
                    raise AssertionError(f"{label}: cache positions differ "
                                         "from the CPU's")
    bad = {k: v for k, v in worst.items() if not v <= TABLE_TOL}
    bad.update({k: f"{v} flips" for k, v in flipped_total.items()
                if v > ZOO_FLIP_BOUND})
    if bad:
        raise AssertionError(f"reduced zoo tables GPU vs CPU beyond "
                             f"{TABLE_TOL} or {ZOO_FLIP_BOUND} flips: {bad}")
    log("reduced MoE/MLA/Mamba/RG-LRU tables (prefill of 8 and 4 decode "
        f"steps; ring decodes of {RING_STEPS} steps), GPU vs the CPU port "
        f"(bound {TABLE_TOL}): max |err| "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()})
        + "; routing flips " + json.dumps(flipped_total))
    return worst


def zoo_spec(arch):
    """``lm_zipf`` (the tiny check's corpus, vocab 256) on ``arch``
    ``reduced()`` at that vocab in f32, registered through
    ``register_lm_model`` as ``llama60m_spec`` does."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.scenarios.catalog import lm_zipf
    from repro_torch.scenarios.lm import register_lm_model
    name = "reduced_" + arch.replace("-", "_")

    def reduced_table(seed, *, vocab, device):
        cfg = configs.get_reduced(arch, vocab=vocab).replace(dtype="float32")
        gen = torch.Generator().manual_seed(seed)
        return M.init_params(cfg, gen, device=device), cfg

    register_lm_model(name, reduced_table)
    return dataclasses.replace(lm_zipf(name=f"lm_zipf_{name}"), model=name,
                               model_kwargs={})


def zoo_training(total):
    """``fedpac_soap`` (eps 1e-3, K=5) for ``ZOO_ROUNDS`` rounds on
    reduced Mixtral (the MoE's segment products under the client path's
    vmap and grad) and reduced Falcon-Mamba (the log-depth scans), on the
    card against the CPU path at the tiny ``lm_zipf`` check's tolerances:
    5 ``matmul_fused`` and ``ZOO_TRAIN[arch]`` ``adam_moments`` launches a
    step.  Adds the launches to ``total`` and returns them."""
    from repro_torch.api import build_experiment, materialize
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.utils.tree import tree_leaves
    zoo = collections.Counter()
    for arch, n_leaves in ZOO_TRAIN.items():
        spec = zoo_spec(arch)
        gpu = materialize(spec, seed=0, device="cuda")
        cpu = dataclasses.replace(
            materialize(spec, seed=0, device="cpu"),
            params=params_from_numpy(params_to_numpy(gpu.params), "cpu"))
        if len(tree_leaves(gpu.params)) != n_leaves:
            raise AssertionError(f"reduced {arch}: "
                                 f"{len(tree_leaves(gpu.params))} leaves, "
                                 f"want {n_leaves}")
        label = f"lm_zipf reduced {arch} fedpac_soap"
        kw = dict(rounds=ZOO_ROUNDS, local_steps=5,
                  opt_kwargs={"eps": CNN_EPS})
        exp = metrics_on_card(build_experiment("fedpac_soap", scenario=gpu,
                                               **kw))
        hist, launches = run_experiment(label, exp,
                                        ("matmul_fused", "adam_moments"),
                                        LM_FINITE)
        steps = exp.fed.local_steps * ZOO_ROUNDS
        for name, per in (("matmul_fused", 5), ("adam_moments", n_leaves)):
            if launches[name] != per * steps:
                raise AssertionError(f"{label}: {launches[name]} {name} "
                                     f"launches, want {per} x {steps} steps")
        zoo.update(launches)
        ref, _ = run_experiment(f"{label} (cpu reference)", build_experiment(
            "fedpac_soap", scenario=cpu, device="cpu", **kw),
            finite=LM_FINITE)
        compare_histories(label, ref, hist, LM_SOAP_TOL, CNN_REL_TOL)
    for name, n in zoo.items():
        total[name] += n
    return zoo


# ------------------------------------------------------- the launch layer

def reset_launches():
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def read_launches(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def spd_theta(opt, params, seed):
    """A full-rank SPD L/R for every matrix leaf of ``params`` (host
    draws), so that a first QR refresh is well posed on both devices."""
    from repro_torch.utils.tree import tree_map
    gen = torch.Generator().manual_seed(seed)

    def spd(x):
        n = x.shape[-1]
        a = torch.randn(x.shape, generator=gen)
        return a @ a.transpose(-1, -2) / n + 0.5 * torch.eye(n)
    return tree_map(spd, opt.get_precond(opt.init(tree_map(
        lambda p: p.cpu(), params))))


def step_agrees(label, cfg, batch, want, got, atol, rtol):
    """The card's updated params ``got`` against the CPU port's ``want``:
    the matrix leaves elementwise, and every leaf through the loss on
    ``batch`` (both evaluated on the CPU) within ``STEP_LOSS_TOL``."""
    from repro_torch.models import model as M
    from repro_torch.optim.api import matrix_mask
    from repro_torch.utils.tree import tree_map
    got = tree_map(lambda x: x.cpu(), got)
    trees_close(label, want, got, atol, rtol, mask=matrix_mask(want))
    with torch.no_grad():
        lw, lg = (float(M.loss_fn(p, batch, cfg)) for p in (want, got))
    if abs(lg - lw) > STEP_LOSS_TOL:
        raise AssertionError(f"{label}: loss after the step {lg} vs {lw}")
    log(f"{label}: loss after the step {lg:.6f} vs {lw:.6f} on the CPU")


def trees_close(label, want, got, atol, rtol, mask=None):
    from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves
    worst = 0.0
    keep = tree_leaves(mask) if mask is not None else None
    for i, ((path, w), (_, g)) in enumerate(zip(
            tree_flatten_with_path(want), tree_flatten_with_path(got))):
        if keep is not None and not keep[i]:
            continue
        w, g = w.float().cpu(), g.float().cpu()
        excess = ((g - w).abs() - rtol * w.abs()).max().item()
        worst = max(worst, excess)
        if excess > atol:
            raise AssertionError(f"{label}: {path} off by {excess} beyond "
                                 f"{rtol} relative (atol {atol})")
    log(f"{label}: GPU agrees with the CPU port (worst excess over "
        f"{rtol} relative {worst:.3e} <= {atol})")


def train_step_smollm(total):
    """``launch.steps.make_train_step`` on the unreduced SmolLM-360M in
    bf16: Muon, SOAP (``state_dtype`` bf16) and Sophia, 3 steps each, with
    their launches a step asserted; ``remat=True`` against ``remat=False``
    (the same loss, at most half the loss-and-gradient memory); then the
    reduced table on the card
    against the CPU port.  Adds the launches to ``total``."""
    from repro_torch import configs, optim
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
    cfg = configs.get_config("smollm-360m")
    if (cfg.dtype, M.num_params(cfg)) != ("bfloat16", 361_821_120):
        raise AssertionError("SmolLM-360M: want bf16 and 361,821,120 "
                             "parameters")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    b, s = TRAIN_STEP["batch"], TRAIN_STEP["seq"]
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                        device="cuda")
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    gg = tree_map(lambda p: 1e-3 * torch.randn(
        p.shape, generator=gen, device="cuda"), params)
    found = collections.Counter()
    for name, kw in TRAIN_STEP_OPTS.items():
        opt = optim.make(name, **kw)
        fn = ST.make_train_step(cfg, opt, lr=optim.DEFAULT_LR[name])
        state, p = opt.init(params), params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_launches()
        ms = []
        for step in range(TRAIN_STEP["steps"]):
            t0 = time.perf_counter()
            p, state, loss = fn(p, state, gg, batch, step)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(float(loss)):
                raise AssertionError(f"train_step {name}: loss {loss}")
        launches = read_launches(wrappers)
        label = f"train_step smollm-360m {name}"
        for k, per in TRAIN_STEP_LAUNCHES[name].items():
            if launches[k] != per * TRAIN_STEP["steps"]:
                raise AssertionError(f"{label}: {launches[k]} {k} launches, "
                                     f"want {per} a step")
        if any(x.dtype != torch.bfloat16 for x in tree_leaves(p)):
            raise AssertionError(f"{label}: params left bf16")
        # (a norm scale at 1.0 may not move: its step is below half a
        # bf16 ulp there)
        if all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(params))):
            raise AssertionError(f"{label}: params did not move")
        found.update(launches)
        if name == "muon":   # the newton_schulz row's launches
            total["newton_schulz"] += launches["matmul_fused"]
        log(f"{label}: step ms (host clock to a sync) "
            + ", ".join(f"{x:.1f}" for x in ms) + f"; loss {float(loss):.4f}"
            f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            "launches " + json.dumps(launches))
        del state, p
    # remat: the same loss; the memory that the loss and gradients (the
    # optimizer's own peak does not depend on remat) and a whole step
    # take above what is resident before them, so that buffers left by
    # earlier phases do not enter the comparison.  Each measurement's
    # outputs are dropped before the next one starts.
    opt = optim.make("soap", state_dtype="bfloat16")
    out = {}
    wrappers = reset_launches()
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]

    def above_resident(fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = float(fn())
        torch.cuda.synchronize()
        return loss, torch.cuda.max_memory_allocated() - base

    for remat in (False, True):
        def loss_and_grads():
            loss = ST.make_loss_fn(cfg, remat=remat)(
                tree_unflatten(params, leaves), batch)
            torch.autograd.grad(loss, leaves)
            return loss.detach()

        def step():
            fn = ST.make_train_step(cfg, opt, lr=optim.DEFAULT_LR["soap"],
                                    remat=remat)
            return fn(params, opt.init(params), gg, batch, 1)[2]

        out[remat] = above_resident(loss_and_grads) + above_resident(step)
    found.update(read_launches(wrappers))
    (l0, g0, s0, p0), (l1, g1, s1, p1) = out[False], out[True]
    if abs(l1 - l0) > 1e-6 * abs(l0) or abs(s1 - s0) > 1e-6 * abs(s0):
        raise AssertionError(f"remat: loss {l1}, {s1} vs {l0}, {s0}")
    log(f"train_step smollm-360m remat: loss {l1:.6f} = {l0:.6f}; loss "
        f"and gradients {g1 / 2**30:.3f} GiB above resident with remat, "
        f"{g0 / 2**30:.3f} GiB without; a SOAP step {p1 / 2**30:.3f} and "
        f"{p0 / 2**30:.3f} GiB")
    # 32 layers' saved activations against their inputs alone: remat must
    # save at least half of the no-remat loss-and-gradient memory
    if not g1 <= 0.5 * g0:
        raise AssertionError(f"remat saves too little: {g1} bytes above "
                             f"resident with remat, {g0} without")
    del leaves
    del params, gg
    # the reduced table, f32: the card against the CPU port
    rcfg = configs.get_reduced("smollm-360m").replace(dtype="float32")
    cpu_p = M.init_params(rcfg, torch.Generator().manual_seed(1))
    tok = torch.randint(0, rcfg.vocab_size, (4, 33),
                        generator=torch.Generator().manual_seed(2))
    rb = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    rgg = tree_map(lambda x: 0.01 * torch.randn(
        x.shape, generator=torch.Generator().manual_seed(3)), cpu_p)
    wrappers = reset_launches()
    for name, step in (("muon", 0), ("soap", 0), ("sophia", 1)):
        kw = {"eps": CNN_EPS} if name == "soap" else {}
        opt = optim.make(name, **kw)
        res = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.to(dev), cpu_p)
            st = opt.init(p)
            if name == "soap":
                st = opt.set_precond(st, tree_map(
                    lambda x: x.to(dev), spd_theta(opt, cpu_p, 4)))
            elif name == "sophia":
                # a curvature away from 0: at h = 0 every step sits at the
                # clip, whose sign a roundoff-level m flips
                st = dict(st, h=tree_map(lambda h: h + 0.5, st["h"]))
            fn = ST.make_train_step(rcfg, opt, lr=1e-2)
            res[dev] = fn(p, st, tree_map(lambda x: x.to(dev), rgg),
                          {k: v.to(dev) for k, v in rb.items()}, step)
        if abs(float(res["cuda"][2]) - float(res["cpu"][2])) > TABLE_TOL:
            raise AssertionError(f"reduced {name}: loss {res['cuda'][2]} vs "
                                 f"{res['cpu'][2]}")
        step_agrees(f"train_step reduced smollm-360m {name}", rcfg, rb,
                    res["cpu"][0], res["cuda"][0], STEP_ATOL, STEP_RTOL)
    found.update(read_launches(wrappers))
    for k, n in found.items():
        total[k] += n
    return found


def fed_round_llama60m(total):
    """``launch.steps.make_fed_round_step`` on the unreduced LLaMA-60M with
    ``fedpac_soap``, once on the dense wire and once with the qblock delta
    transport (``quantize`` asserted), then the reduced table on the card
    against the CPU port.  Adds the launches to ``total``."""
    from repro_torch import configs, optim
    from repro_torch.core import transport as T
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_leaves, tree_map
    c, k = FED_ROUND["clients"], FED_ROUND["local_steps"]
    rows, s = c * k * FED_ROUND["micro"], FED_ROUND["seq"]

    def qblock():
        return T.Transport(T.resolve_codec("qblock"), T.Dense(),
                           error_feedback=False)

    def inputs(cfg, dev, gen):
        p = M.init_params(cfg, gen, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (rows, s + 1), generator=gen,
                            device=gen.device).to(dev)
        gg = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), p)
        return p, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}, gg

    found = collections.Counter()
    cfg = configs.get_config("llama-60m")
    p, batch, gg = inputs(cfg, "cuda",
                          torch.Generator(device="cuda").manual_seed(0))
    for wire in ("dense", "qblock"):
        opt = optim.make("soap")
        fn = ST.make_fed_round_step(
            cfg, opt, lr=optim.DEFAULT_LR["soap"], clients=c,
            local_steps=k, algorithm="fedpac_soap",
            transport=qblock() if wire == "qblock" else None)
        theta = opt.get_precond(opt.init(p))
        wrappers = reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_p, new_th, new_g, loss = fn(p, theta, gg, batch, 0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = read_launches(wrappers)
        label = f"fed_round llama-60m fedpac_soap {wire}"
        want = {"matmul_fused": 5 * k, "adam_moments": 11 * k,
                "quantize": 1 if wire == "qblock" else 0}
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{label}: {launches[name]} {name} "
                                     f"launches, want {n}")
        if not math.isfinite(float(loss)) or not all(
                torch.isfinite(x).all() for x in tree_leaves(new_p)):
            raise AssertionError(f"{label}: non-finite")
        log(f"{label}: {sec:.2f} s (host clock to a sync, first call), "
            f"loss {float(loss):.4f}, launches " + json.dumps(launches))
        found.update(launches)
    del p, batch, gg
    rcfg = configs.get_reduced("llama-60m")
    cpu_p, cpu_b, cpu_g = inputs(rcfg, "cpu", torch.Generator().manual_seed(5))
    wrappers = reset_launches()
    for wire in ("dense", "qblock"):
        opt = optim.make("soap", eps=CNN_EPS)
        theta = spd_theta(opt, cpu_p, 6)
        res = {}
        for dev in ("cpu", "cuda"):
            fn = ST.make_fed_round_step(
                rcfg, opt, lr=1e-2, clients=c, local_steps=k,
                algorithm="fedpac_soap",
                transport=qblock() if wire == "qblock" else None)
            res[dev] = fn(*(tree_map(lambda x: x.to(dev), t) for t in
                            (cpu_p, theta, cpu_g, cpu_b)))
        label = f"fed_round reduced llama-60m {wire}"
        if abs(float(res["cuda"][3]) - float(res["cpu"][3])) > TABLE_TOL:
            raise AssertionError(f"{label}: loss {res['cuda'][3]} vs "
                                 f"{res['cpu'][3]}")
        atol = STEP_ATOL if wire == "dense" else FED_QBLOCK_ATOL
        step_agrees(label, rcfg, {k: v[:4] for k, v in cpu_b.items()},
                    res["cpu"][0], res["cuda"][0], atol, STEP_RTOL)
    found.update(read_launches(wrappers))
    for name, n in found.items():
        total[name] += n
    return found


def train_llama60m(total):
    """``launch.train.main`` on the unreduced LLaMA-60M with
    ``fedpac_soap`` for ``TRAIN_ROUNDS`` rounds, traced and checkpointed
    every round: s/round, the trace validated, the last checkpoint
    restored into a template.  Adds the launches to ``total``."""
    import tempfile
    from repro_torch import configs, optim
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.core.server import init_server
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.obs import validate_jsonl
    from repro_torch.utils.tree import tree_leaves
    with tempfile.TemporaryDirectory() as tmp:
        trace, ck = os.path.join(tmp, "t.jsonl"), os.path.join(tmp, "ck")
        hist = []
        wrappers = reset_launches()
        t0 = time.perf_counter()
        rc = train.main(["--arch", "llama-60m", "--algorithm", "fedpac_soap",
                         "--rounds", str(TRAIN_ROUNDS), "--trace", trace,
                         "--checkpoint-dir", ck, "--checkpoint-every", "1",
                         "--device", "cuda"], history=hist)
        sec = time.perf_counter() - t0
        launches = read_launches(wrappers)
        label = "train llama-60m fedpac_soap"
        steps = 5 * TRAIN_ROUNDS
        if rc != 0 or len(hist) != TRAIN_ROUNDS:
            raise AssertionError(f"{label}: rc {rc}, {len(hist)} rounds")
        for name, per in (("matmul_fused", 5), ("adam_moments", 11)):
            if launches[name] != per * steps:
                raise AssertionError(f"{label}: {launches[name]} {name} "
                                     f"launches, want {per} x {steps} steps")
        events = validate_jsonl(trace)
        cfg = configs.get_config("llama-60m")
        tmpl_p = M.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(9), device="cuda")
        opt = optim.make("soap")
        template = dataclasses.replace(
            init_server(tmpl_p), theta=opt.get_precond(opt.init(tmpl_p)))
        server = CheckpointManager(ck).restore(template)
        if latest_step(ck) != TRAIN_ROUNDS or server.round != TRAIN_ROUNDS \
                or not all(torch.isfinite(x).all()
                           for x in tree_leaves(server.params)):
            raise AssertionError(f"{label}: checkpoint at round "
                                 f"{server.round}, want {TRAIN_ROUNDS}")
        log(f"{label}: {sec / TRAIN_ROUNDS:.2f} s/round (host clock, "
            f"{TRAIN_ROUNDS} rounds incl. the first's warm-up), loss "
            f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, eval "
            f"{hist[-1]['eval_loss']:.4f}; the trace validates ({events} "
            f"events); round {server.round} restored; launches "
            + json.dumps(launches))
    for name, n in launches.items():
        total[name] += n
    return launches


def dryrun_pod(dev):
    """``launch.dryrun`` at full width on the 256-rank fake pod mesh (on
    the host: fake tensors, no kernel runs): each record printed, the
    train step's collective bytes > 0, and every record's FLOPs > 0 and
    at most what its ranks execute together."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    recs = []
    with dryrun.fake_process_group(256):
        mesh = make_production_mesh()
        for arch, shape in DRYRUN_CELLS:
            t0 = time.perf_counter()
            cfg, sh, low = dryrun.build_lowering(arch, shape, mesh)
            rec = dryrun.analyze(arch, shape, "pod", low, cfg, sh)
            rec["lower_s"] = round(time.perf_counter() - t0, 1)
            log(f"dryrun {arch} x {shape} x pod: " + json.dumps(rec))
            # the whole program's FLOPs, each op once, against what the
            # 256 ranks execute together (replicated work on each)
            if not rec["rank_flops"] * mesh.size() >= rec["hlo_flops"] > 0:
                raise AssertionError(
                    f"dryrun {arch}: {rec['hlo_flops']} FLOPs, "
                    f"{rec['rank_flops']} on rank 0")
            recs.append(rec)
    if not recs[0]["collective_bytes"] > 0:
        raise AssertionError("dryrun: the train step moved no collective "
                             "bytes")
    return {"records": recs, "launches": {}}


def mesh_executor(dev):
    """The CNN ``fedpac_soap`` round (2 rounds) through the ``shard_map``
    executor over a one-rank NCCL ``DeviceMesh``, bitwise against the
    same experiment with ``mesh=None``.  One rank runs the whole cohort
    as ``mesh=None`` does (``executors._client_group``), so this checks
    that a ``DeviceMesh`` is taken on the card; the per-rank slice and the
    all-gather need two ranks.  Returns its launches."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.api import build_experiment
    from repro_torch.core.algorithms import build_round_fn
    from repro_torch.core.engine import ExecutorConfig
    from repro_torch.utils.tree import tree_leaves
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        runs = {}
        wrappers = reset_launches()
        for name, m in (("none", None), ("mesh", mesh)):
            exp = build_experiment("fedpac_soap", scenario="cifar_like_cnn",
                                   rounds=2, executor="shard_map",
                                   device="cuda")
            fed = exp.fed
            exp.round_fn = build_round_fn(
                exp.spec, exp.loss_fn, exp.opt, lr=exp.lr,
                local_steps=fed.local_steps,
                beta=exp.spec.resolve_beta(fed.beta),
                hessian_freq=fed.hessian_freq, server_lr=fed.server_lr,
                transport=exp.transport,
                executor=ExecutorConfig("shard_map", mesh=m),
                n_clients=fed.n_clients, telemetry=True)
            hist = exp.run()
            runs[name] = (hist, tree_leaves(exp.server.params))
        launches = read_launches(wrappers)
        (h0, p0), (h1, p1) = runs["none"], runs["mesh"]
        if [r["loss"] for r in h0] != [r["loss"] for r in h1] or not all(
                torch.equal(a, b) for a, b in zip(p0, p1)):
            raise AssertionError("mesh executor: the one-rank NCCL mesh's "
                                 "round differs from mesh=None")
        log("mesh executor: the CNN fedpac_soap rounds over a one-rank NCCL "
            "DeviceMesh equal mesh=None bitwise; losses "
            + json.dumps([r["loss"] for r in h1]) + "; launches "
            + json.dumps(launches))
    finally:
        dist.destroy_process_group()
    return {"launches": launches}


def launch_paths(total):
    """The launch layer's phases; adds their launches to ``total``."""
    t0 = time.perf_counter()
    train_step_smollm(total)
    gc.collect()
    torch.cuda.empty_cache()
    fed_round_llama60m(total)
    train_llama60m(total)
    for name in ("dryrun", "mesh executor"):
        out = fresh_phase(name)
        for k, n in out["launches"].items():
            total[k] += n
    log(f"launch layer: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------- SmolLM training

def smollm_spec():
    """``lm_zipf`` at SmolLM's vocab on the unreduced SmolLM-360M (f32),
    registered through ``register_lm_model`` as ``llama60m_spec`` does."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.scenarios.catalog import lm_zipf
    from repro_torch.scenarios.lm import register_lm_model

    def smollm_360m(seed, *, vocab, device):
        cfg = configs.get_config("smollm-360m").replace(dtype="float32")
        if cfg.vocab_size != vocab:
            raise ValueError(f"vocab {vocab} != {cfg.vocab_size}")
        gen = torch.Generator().manual_seed(seed)
        return M.init_params(cfg, gen, device=device), cfg

    register_lm_model("smollm_360m", smollm_360m)
    return dataclasses.replace(
        lm_zipf(**SMOL_SOURCE, name="lm_zipf_smollm360m"),
        model="smollm_360m", model_kwargs={})


@contextlib.contextmanager
def omega_draws(exp):
    """Times telemetry's host draws of its JL Omega (the misses of
    ``obs.telemetry._omega``'s cache) while the block runs, by host clock
    (the draw is host work), and yields {round: [draws, floats, s]}."""
    from repro_torch.obs import telemetry
    inner = telemetry._omega
    drawn = collections.defaultdict(lambda: [0, 0, 0.0])

    def draw(index, width, rank):
        misses = inner.cache_info().misses
        t0 = time.perf_counter()
        omega = inner(index, width, rank)
        if inner.cache_info().misses > misses:
            d = drawn[len(exp.history) + 1]
            d[0], d[1] = d[0] + 1, d[1] + omega.numel()
            d[2] += time.perf_counter() - t0
        return omega

    telemetry._omega = draw
    try:
        yield drawn
    finally:
        telemetry._omega = inner


def smollm_training(total):
    """``fedpac_soap`` on the unreduced SmolLM-360M for ``SMOL_ROUNDS``
    rounds: the untrained eval loss at ln V + 0.02^2 d / 2, the loss
    falling, 5 ``matmul_fused`` and 11 ``adam_moments`` launches a step;
    telemetry's Omega draws timed by round.  Adds the launches to
    ``total`` and returns them."""
    from repro_torch.api import build_experiment, materialize
    from repro_torch.models import model as M
    from repro_torch.optim.api import matrix_mask
    from repro_torch.utils.tree import tree_leaves
    t0 = time.perf_counter()
    scn = materialize(smollm_spec(), seed=0, device="cuda")
    cfg = scn.meta["model_cfg"]
    mask = tree_leaves(matrix_mask(scn.params))
    n_mat, n_fallback = sum(mask), len(mask) - sum(mask)
    log(f"SmolLM-360M: {M.num_params(cfg)} parameters, {len(mask)} leaves "
        f"({n_mat} stacked matrices, {n_fallback} Adam fallback); lm_zipf "
        f"at vocab {cfg.vocab_size}, seq {SMOL_SOURCE['seq_len']}, batch "
        f"{SMOL_SOURCE['batch']}, materialized in "
        f"{time.perf_counter() - t0:.2f} s")
    if (M.num_params(cfg), n_mat, n_fallback) != (361_821_120, 7, 4):
        raise AssertionError("SmolLM-360M: want 361,821,120 parameters, 7 "
                             "matrix and 4 fallback leaves")
    loss0 = float(scn.eval_fn(scn.params)["eval_loss"])
    want0 = math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2
    if abs(loss0 - want0) > 0.05:
        raise AssertionError(f"SmolLM-360M: initial eval loss {loss0}, want "
                             f"ln V + s2/2 = {want0}")
    label = "smollm-360m fedpac_soap"
    # one client's gradient at a time (the chunked executor, chunk 1): the
    # vmapped gradient of both clients' 16 x 256 tokens through 32 f32
    # layers does not fit in 80 GB beside SOAP's state; the optimizer
    # still steps the two clients' stacked leaves together
    torch.cuda.reset_peak_memory_stats()
    exp = metrics_on_card(build_experiment(
        "fedpac_soap", scenario=scn, rounds=SMOL_ROUNDS, executor="chunked",
        chunk_size=1, **LM_FL))
    t_rounds = time.perf_counter()
    with omega_draws(exp) as drawn:
        hist, launches = run_experiment(label, exp,
                                        ("matmul_fused", "adam_moments"),
                                        LM_FINITE)
    t_rounds = time.perf_counter() - t_rounds
    for r, (n, floats, sec) in sorted(drawn.items()):
        log(f"{label}: telemetry drew {n} JL Omegas in round {r} "
            f"({floats * 4 / 2**30:.3f} GiB on the host) in {sec:.2f} s "
            "(host clock)")
    if set(drawn) != {1}:
        raise AssertionError(f"{label}: telemetry drew its Omega in rounds "
                             f"{sorted(drawn)}, want round 1 only")
    steps = exp.fed.local_steps * SMOL_ROUNDS
    for name, per in (("matmul_fused", 5),
                      ("adam_moments", n_mat + n_fallback)):
        if launches[name] != per * steps:
            raise AssertionError(f"{label}: {launches[name]} {name} "
                                 f"launches, want {per} x {steps} steps")
    # the round's loss (the mean over its K steps) and the eval loss after
    # it both below the untrained model's
    if not loss0 > max(hist[-1]["loss"], hist[-1]["eval_loss"]):
        raise AssertionError(f"{label}: the loss did not fall ({loss0} -> "
                             f"{hist[-1]['loss']}, eval "
                             f"{hist[-1]['eval_loss']})")
    log(f"{label}: loss {loss0:.4f} at init (ln V + s2/2 = {want0:.4f}), "
        f"{hist[-1]['loss']:.4f} over round {SMOL_ROUNDS}'s steps, eval "
        f"{hist[-1]['eval_loss']:.4f} after it; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, n in launches.items():
        total[name] += n
    del scn, exp
    refresh = time_smollm_refresh() / 1e3
    t_round = (t_rounds - sum(d[2] for d in drawn.values())) / SMOL_ROUNDS
    log(f"{label}: SOAP's QR refresh at these shapes (one a round, at step "
        f"0) {refresh:.2f} s by CUDA events, {100 * refresh / t_round:.1f}% "
        f"of a round's {t_round:.2f} s (the mean of {SMOL_ROUNDS}, "
        "telemetry's Omega draws taken out)")
    return launches


def time_smollm_refresh():
    """SOAP's eigenbasis refresh as a SmolLM-360M round makes it at its
    step 0 (``optim.soap._eig_refresh`` with QR): every side of the 7
    stacked matrix leaves at S=2, 64 factors a side (3 of 2,560^2, 9 of
    960^2, 2 of 320^2), on Gaussian factors (one Q a size, read by every
    side of that size).  Returns its ms by CUDA events."""
    from repro_torch.optim.soap import _eig_refresh
    gen = torch.Generator(device="cuda").manual_seed(1)
    s = LM_S * SMOL_LAYERS
    sides = [k for m, n in SMOL_LEAVES for k in (m, n)]
    qs = {k: torch.randn((s, k, k), generator=gen, device="cuda")
          / math.sqrt(k) for k in set(sides)}
    pairs = [(torch.randn((s, k, k), generator=gen, device="cuda")
              / math.sqrt(k), qs[k]) for k in sides]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _eig_refresh(pairs, "qr")
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def smollm_kernel_checks(dev, gen):
    """``matmul_fused`` (one leaf's six products a grouped launch, 7
    launches) and ``adam_moments`` held against their plain versions at
    SmolLM-360M's shapes, then timed over one SOAP step.  Returns (max
    |err| by kernel, timings)."""
    # scaled Gaussian Q factors: 192 QRs of 2,560^2 would take seconds
    mats, fallback = lm_leaves(SMOL_LEAVES, SMOL_LAYERS, 49152, 960, dev,
                               gen, orthogonal=False)
    errs = {"matmul_fused": max(check_matmul_fused([x]) for x in mats),
            "adam_moments": check_adam_moments(mats + fallback)}
    timings = time_soap_step(
        f"one local step of SmolLM-360M (S={LM_S}, 7 stacked matrix leaves "
        f"of {LM_S * SMOL_LAYERS})", [x for _, x in mats],
        [x for _, x in mats + fallback], reps=1)
    return errs, timings


def smollm_kernel_rows(dev):
    errs, timings = smollm_kernel_checks(
        dev, torch.Generator(device=dev).manual_seed(0))
    return dict(errs=errs, timings=timings)


# the phases run by fresh_phase: each traces the card
PHASES = {"serve": lambda dev: serve_smollm(),
          "smollm_kernel_rows": smollm_kernel_rows,
          "dryrun": dryrun_pod, "mesh executor": mesh_executor,
          **{f"serve {arch}": (lambda dev, a=arch, n=layers, c=count:
                               serve_table(a, c, n))
             for arch, layers, count in ZOO_SERVE}}


def start():
    """The card's settings for every phase: TF32 off, the port on the
    path.  Returns the device, or None without a card."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return None
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def run_phase(name, path):
    """``--phase NAME PATH``: phase ``name`` of ``PHASES`` alone, its
    result written to ``path`` as JSON (``fresh_phase``)."""
    dev = start()
    if dev is None:
        return 1
    build_kernels(dev)
    with open(path, "w") as f:
        json.dump(PHASES[name](dev), f)
    return 0


def main():
    dev = start()
    if dev is None:
        return 1
    t_start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    build_kernels(dev)
    # the phases timed by whole traces, each in a young process of its own
    fresh_phase("serve")
    for arch, _, _ in ZOO_SERVE:
        fresh_phase(f"serve {arch}")
    smol_rows = fresh_phase("smollm_kernel_rows")
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = ([((m, n, S_VIT), leaf_inputs(m, n, S_VIT, dev, gen))
               for m, n in VIT_LEAVES]
              + [((m, n, 2), leaf_inputs(m, n, 2, dev, gen))
                 for m, n in CNN_LEAVES])
    errs = {"matmul_fused": check_matmul_fused(leaves),
            "adam_moments": check_adam_moments(leaves)}
    check_soap_rotated_update(leaves)
    del leaves
    vit_shapes, cnn_shapes = model_leaf_shapes()
    stacked = ([(S_VIT, *s) for s in vit_shapes]
               + [(2, *s) for s in cnn_shapes])
    errs["sophia_update"] = check_sophia_update(stacked, dev, gen)
    errs["quantize"] = check_quantize(stacked, dev, gen)
    check_chain_quantize(dev, gen)
    errs["dequant_accumulate"] = check_dequant_accumulate(stacked, dev, gen)
    carry_times = check_dequant_carry(vit_shapes, dev, gen)
    mats = vit_matrix_leaves(dev, gen)
    errs["newton_schulz"] = check_newton_schulz(mats)
    check_profile_kernels(dev)
    check_zero_staleness(vit_shapes, dev, gen)
    timings = time_kernels(dev, gen)
    timings.update(time_sophia_and_wire_kernels(vit_shapes, dev, gen))
    timings.update(time_newton_schulz(mats))
    timings["dequant_accumulate"].update(carry_times)
    del mats
    lm_errs, lm_timings = lm_kernel_checks(dev, gen)
    launches = main_paths(vit_shapes, cnn_shapes)
    async_paths(launches)
    population_paths(launches, vit_shapes)
    t_lm = time.perf_counter()
    lm_launches = lm_paths(launches)
    traffic_paths(launches)
    log(f"LM and traffic paths: {time.perf_counter() - t_lm:.1f} s")
    t_zoo = time.perf_counter()
    zoo_tables_on_card()
    zoo_training(launches)
    log(f"reduced MoE/MLA/Mamba/RG-LRU tables and training: "
        f"{time.perf_counter() - t_zoo:.1f} s")
    t_smol = time.perf_counter()
    tables_on_card()
    gc.collect()
    torch.cuda.empty_cache()
    smol_launches = smollm_training(launches)
    smol_errs, smol_timings = smol_rows["errs"], smol_rows["timings"]
    log(f"SmolLM-360M reduced tables and training: "
        f"{time.perf_counter() - t_smol:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    launch_paths(launches)

    meta = {
        "adam_moments": dict(
            route="triton",
            source="src/repro_torch/kernels/soap_rotate/kernel.py",
            replaces="src/repro/kernels/soap_rotate/kernel.py:34"),
        "matmul_fused": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/matmul_fused.cu",
            replaces="src/repro/kernels/ns_ortho/kernel.py:61"),
        "sophia_update": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/sophia_update.cu",
            replaces="src/repro/kernels/sophia_update/kernel.py:31"),
        "quantize": dict(
            route="cuda", source="src/repro_torch/kernels/csrc/qblock.cu",
            replaces="src/repro/kernels/qblock/kernel.py:33"),
        "dequant_accumulate": dict(
            route="cuda", source="src/repro_torch/kernels/csrc/fused_agg.cu",
            replaces="src/repro/kernels/fused_agg/kernel.py:39"),
        # a composition of grouped matmul_fused launches (CUDA C++) with
        # no launch of its own: its launches are matmul_fused's in the
        # Muon paths, also counted in the matmul_fused row
        "newton_schulz": dict(
            route="cuda", source="src/repro_torch/kernels/ns_ortho/ops.py",
            replaces="src/repro/kernels/ns_ortho/ops.py:31",
            launches_of="matmul_fused"),
    }
    kernels = [dict(name=name, **meta[name], launches=launches[name],
                    max_abs_err=errs[name], **timings[name])
               for name in meta]
    # the first times at transformer shapes: one LLaMA-60M SOAP step,
    # launched on the LM paths
    kernels += [dict(name=f"{name}@llama-60m", **meta[name],
                     launches=lm_launches[name], max_abs_err=lm_errs[name],
                     **lm_timings[name])
                for name in ("matmul_fused", "adam_moments")]
    # one SmolLM-360M SOAP step, launched on its training path
    kernels += [dict(name=f"{name}@smollm-360m", **meta[name],
                     launches=smol_launches[name],
                     max_abs_err=smol_errs[name], **smol_timings[name])
                for name in ("matmul_fused", "adam_moments")]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase"]:
        sys.exit(run_phase(*sys.argv[2:4]))
    sys.exit(main())
