"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py [--seed 0]

Builds every CUDA kernel from ``src/repro_torch`` (one ``nvcc`` per source,
all at once) and drives the port's paths at full width (bf16, random
weights from ``--seed``):

* serving qwen1.5-0.5b: ``SlotServer`` and ``generate`` with 8
  heterogeneous adapters through ``lowrank_linear_batched``;
* serving rwkv6-1.6b: the same, with the adapters on its eight target
  projections through ``lowrank_linear_batched`` and the WKV recurrence
  through ``rwkv6_scan``;
* training qwen1.5-0.5b: two FedGaLore rounds through
  ``FedEngine.run_round`` (4 clients, 2 local steps, batch 4 x 128, rank
  8) — round 0 through
  ``galore_precond_step`` and ``jacobi_eigh``, round 1 through
  ``lowrank_linear`` and ``jacobi_eigh``; at the same width and traffic
  one round of each LoRA / dense baseline (no kernel) and two rounds of
  the eager ``fedgalore`` oracle (``fused_round=False``: dense clients
  through ``galore_precond_step`` with the update projected back, round
  1's 𝒮 through ``jacobi_eigh``);
* population and robustness: five guarded FedGaLore rounds of a
  ``PopulationRunner`` over a 32-client population (drops, stragglers
  merging stale, sign-flip / scale / NaN uploads quarantined,
  trimmed-mean 𝒜 and 𝒮, the store spilling), kill and resume from a
  snapshot, and the honest guarded round bitwise the plain one;
* sampled decoding: ``categorical`` on the card against the CPU, and a
  sampled ``generate`` / ``SlotServer`` run twice from one seed;
* serving starcoder2-7b (32 layers, d 4608, 36 q heads on 4 kv heads of
  128, sliding window 4096): the same serving run with 8 adapters on its
  six target projections, and one long-context prefill of 8192 tokens on
  the base weights, where the window acts, run twice: over an 8200-slot
  cache and over a ring of the 4096-token window (greedy tokens equal);
* serving granite-moe-1b-a400m (24 layers, d 1024, 16 q heads on 8 kv
  heads of 64, 32 experts top-8 per layer): the serving run with 8
  adapters on its four attention projections (experts and routers
  frozen), the MoE's routing compared between the kernel and plain runs;
* serving mistral-nemo-12b (40 layers, d 5120, 32 q heads on 8 kv heads
  of 128, so the heads span 4096 of the 5120 model columns): 8 requests
  of 128 tokens, 16 new tokens each, 8 adapters on seven projections;
* serving deepseek-v2-236b (MLA: 128 heads, q_lora 1536, kv_lora 512,
  q.k heads of 128 + 64, v heads of 128; MoE of 160 experts top 6 plus 2
  shared; vocab 102400) and jamba-1.5-large-398b (d 8192, Mamba with
  d_inner 16384 and d_state 16, 64 q heads on 8 kv heads of 128 at
  offset 3 of its interleave, MoE of 16 experts top 2 on every other
  layer) at their published widths with the depth cut to 4 layers
  (``CUT_LAYERS``): 8 requests of 128 tokens, 16 new tokens each, 8
  adapters on the projections ``serving_target_fn`` selects; their
  parity gated on free routing (deepseek at the largest of 8
  embedding-ulp controls, jamba on its share of flipped expert choices)
  and, as for every MoE model, with each MoE layer's routing pinned to
  the plain run's; one MLA layer's absorbed decode step and one Mamba
  layer's plain scan timed;
* the paper's NLU example, ``examples/federated_finetune_100m_torch.py``,
  for three FedGaLore rounds of paper-roberta-like (12 layers, d 768,
  sinusoidal positions; 4 clients, 4 local steps, batch 4 x 64, rank 8):
  round 0 through ``galore_precond_step`` and ``jacobi_eigh``, rounds 1
  and 2 through ``lowrank_linear`` and ``jacobi_eigh``, its evaluation
  forwards through ``flash_attention``;
* two FedGaLore rounds of paper-vit-like (12 layers, d 768) on the patch
  task: 196 stub patch embeddings, then 4 text tokens, 4 clients, 2 local
  steps, batch 4, the evaluation after each round through
  ``flash_attention``;
* training rwkv6-1.6b (24 layers, d 2048, d_ff 7168, vocab 65536) at the
  qwen rounds' traffic: two FedGaLore rounds (round 0 through
  ``galore_precond_step`` and ``jacobi_eigh``, round 1 through
  ``lowrank_linear`` and ``jacobi_eigh``) and one FedIT round, every
  forward's WKV recurrence through ``rwkv6_scan`` in its checkpoint mode
  and every backward's through ``rwkv6_scan_bwd``.

Every dense prefill's attention goes through ``flash_attention`` (qwen,
starcoder2, granite, mistral-nemo, jamba's attention layer), as do the
training paths' evaluation forwards (no autograd graph); decode's
through the plain masked attention over the KV cache; MLA's, at prefill
and decode, through plain PyTorch.

Each kernel is held against its plain PyTorch version at every shape its
path launches (a ``ShapeLog`` fails the run on an unchecked shape) and,
for the kernels with routes, at the edges of each route (the low-rank
applies' ``tc_gemm``, ``tc_decode``, ``fp32``; flash_attention's ``tc``
and ``simt``); the launch counters show each path went through its
kernels, and the route counters that every low-rank and flash launch on
a path took a tensor-core route; each path is
compared end to end against a run with every kernel's plain version
(``ops.plain_kernels``), beside controls that must read above each
bound (a planted fault for serving: each row's adapter id rolled by one;
a round's update dropped for training), and each kernel is timed against
its bound.
Every phase prints JSON lines; any failure raises and the script exits
non-zero without the closing ``{"ok": true, ...}`` line. Needs one CUDA
card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, FP32 (non-tensor)
# rate, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

B, G, R = 8, 8, 16                     # decode batch, adapters, rank
PROMPT, NEW = 128, 32
SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024)]   # (m, n) of the path
# one qwen1.5-0.5b layer: wq wk wv wo @ (1024,1024), w_gate w_up @
# (1024,2816), w_down @ (2816,1024)
LAYER_MIX = {(1024, 1024): 4, (1024, 2816): 2, (2816, 1024): 1}
PARITY_BOUND = 5e-2     # max |logit diff| / max |logit|, bf16 end to end
# (random-weight mistral-nemo-12b amplifies one bf16 ulp on 1 % of its
# embeddings to 8.4e-2 of its logit scale on an NVIDIA H100 80GB HBM3 at
# 700 W, above this bound, and each of its kernels alone, the others on
# their plain versions, reads 6.0e-2 and 6.2e-2 there
# (scripts/parity_decompose.py): its parity is gated at that control
# instead, phase_parity's floor_gate. Every adapted parity run also
# plants a fault, each row's adapter id rolled by one, that must read
# above the gate: 0.68-1.15 of the logit scale on that card.)
# The cut deepseek-v2-236b and jamba-1.5-large-398b amplify rounding
# further through flipped expert choices: over seeds 0-3 their free
# controls read 0.08-0.21 and 0.06-0.73, so one control is no floor
# (deepseek's kernel read 0.197 against one control's 0.1967 at seed 1).
# Their free runs take the largest of MOE_CONTROLS controls: deepseek's
# logits are gated at it (the kernel read 0.44-0.99 of it), jamba's
# expert flips are (its controls reach the rolled adapters' 0.72-0.92,
# and at seed 2 the kernel read 1.01 of the largest); readings from
# scripts/moe_parity_floor.py on an NVIDIA H100 80GB HBM3 at 700 W.
MOE_CONTROLS = 8
# Kernel launches per forward, stated before the run: qwen1.5-0.5b adapts
# 7 projections per layer; rwkv6-1.6b adapts 8 (time-mix wr wk wv wg wo,
# channel-mix wk wv wr) and runs the WKV recurrence once per layer.
QWEN_PER_FORWARD = {"lowrank_linear_batched": 7 * 24}
RWKV_PER_FORWARD = {"lowrank_linear_batched": 8 * 24, "rwkv6_scan": 24}
# Launches per prefill forward on top of those (none per decode forward):
# a dense model's prefill runs flash_attention once per layer; decode
# attends over its KV cache with the plain masked attention.
QWEN_PER_PREFILL = {"flash_attention": 24}
FULL_LAYERS = {"qwen1.5-0.5b": 24, "rwkv6-1.6b": 24, "starcoder2-7b": 32,
               "granite-moe-1b-a400m": 24, "mistral-nemo-12b": 40,
               "paper-roberta-like": 12, "paper-vit-like": 12,
               "deepseek-v2-236b": 60, "jamba-1.5-large-398b": 72}
# deepseek-v2-236b (236 B params, ~440 GiB in bf16) and
# jamba-1.5-large-398b (398 B, ~740 GiB) exceed one card: they serve at
# their published widths with their depth cut to these layer counts
# (16.94 B and 23.02 B params by ArchConfig.param_count). jamba keeps
# layers 0-3 of its interleave: Mamba at 0-2, attention at offset 3, MoE
# on 1 and 3. Every other field is the registered config's, which the
# CPU tests hold to the JAX package's field for field.
CUT_LAYERS = {"deepseek-v2-236b": 4, "jamba-1.5-large-398b": 4}


# granite-moe-1b-a400m: (m, n) of its four adapted projections per layer
# (wq wo (1024, 1024), wk wv (1024, 512)); 16 q heads on 8 kv heads of 64.
# Its MoE FFNs (experts, routers) are frozen and launch no kernel.
GRANITE_SHAPES = [(1024, 1024), (1024, 512)]
GRANITE_PER_FORWARD = {"lowrank_linear_batched": 4 * 24}
GRANITE_PER_PREFILL = {"flash_attention": 24}
# mistral-nemo-12b: (m, n) of its seven adapted projections per layer (wq
# (5120, 4096), wk wv (5120, 1024), wo (4096, 5120), w_gate w_up (5120,
# 14336), w_down (14336, 5120)); 32 q heads on 8 kv heads of 128. Its
# serving run: 8 requests of 128 tokens, 16 new tokens each.
NEMO_SHAPES = [(5120, 4096), (5120, 1024), (4096, 5120), (5120, 14336),
               (14336, 5120)]
NEMO_PER_FORWARD = {"lowrank_linear_batched": 7 * 40}
NEMO_PER_PREFILL = {"flash_attention": 40}
NEMO_REQUESTS, NEMO_NEW = 8, 16

# deepseek-v2-236b: (m, n) of its four adapted projections per layer
# (q_a (5120, 1536), q_b (1536, 128 x 192), kv_a (5120, 512 + 64), wo
# (128 x 128, 5120)); kv_b is read plain (absorbed at decode), experts,
# shared experts and routers are frozen. MLA attends in plain PyTorch
# (q.k heads of 192, v heads of 128: no flash_attention). Its serving
# run: 8 requests of 128 tokens, 16 new tokens each.
DS_SHAPES = [(5120, 1536), (1536, 24576), (5120, 576), (16384, 5120)]
DS_PER_FORWARD = {"lowrank_linear_batched": 4 * 4}
# jamba-1.5-large-398b, layers 0-3: Mamba in_proj (8192, 32768) and
# out_proj (16384, 8192) on layers 0-2 (2-D x at decode), attention wq wo
# (8192, 8192), wk wv (8192, 1024) on layer 3 (64 q heads on 8 kv heads
# of 128, no positions; flash_attention at prefill), the GLU's w_gate
# w_up (8192, 24576) and w_down (24576, 8192) on layers 0 and 2; the
# MoE of layers 1 and 3 is frozen. Same traffic as deepseek's run.
JAMBA_SHAPES = [(8192, 32768), (16384, 8192), (8192, 8192), (8192, 1024),
                (8192, 24576), (24576, 8192)]
JAMBA_TWO_D = [(8192, 32768), (16384, 8192)]
JAMBA_PER_FORWARD = {"lowrank_linear_batched": 2 * 3 + 4 + 3 * 2}
JAMBA_PER_PREFILL = {"flash_attention": 1}
JAMBA_H, JAMBA_KV, JAMBA_D = 64, 8, 128
CUT_REQUESTS, CUT_NEW = 8, 16

# starcoder2-7b: (m, n) of its six adapted projections per layer (wq wo
# (4608, 4608), wk wv (4608, 512), w_up (4608, 18432), w_down (18432,
# 4608)); 36 q heads on 4 kv heads of 128; sliding window 4096.
SC_SHAPES = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608)]
SC_H, SC_KV, SC_D, SC_WINDOW = 36, 4, 128, 4096
SC_PER_FORWARD = {"lowrank_linear_batched": 6 * 32}
SC_PER_PREFILL = {"flash_attention": 32}
# The long-context prefill: one prompt of 8192 tokens (twice the window),
# base weights, 8 new tokens.
LONG_PROMPT, LONG_NEW = 8192, 8
# flash_attention against its plain version, set before the first run:
# fp32 within 1e-5 of the output scale (the two sum the D products and
# the keys in other orders); bf16 within one bf16 ulp of the output scale
# (the fp32 result is rounded once).
FLASH_TOL = 1e-5

# rwkv6-1.6b: (m, n) of its adapted projections and their count per layer
# (time-mix 5 x (2048, 2048), channel-mix wr (2048, 2048), wk (2048, 7168),
# wv (7168, 2048)); 32 heads of 64.
RWKV_SHAPES = [(2048, 2048), (2048, 7168), (7168, 2048)]
RWKV_H, RWKV_D = 32, 64
# rwkv6_scan against its plain version, set before the first run: the final
# state and fp32 y within 1e-5 of their scale; bf16 y within one bf16 ulp of
# the output scale (the fp32 result is rounded once, and a last-place
# difference can cross a rounding boundary). The two share one arithmetic
# order, and every case must also agree bit for bit (gated): the order is
# load-bearing, since rwkv6 serving parity sits near its bound and a kernel
# that fused multiply-adds read 6.84e-2 against 5e-2. The build fails on
# any FFMA in the kernel's SASS.
SCAN_TOL = 1e-5

# The training path: two FedGaLore rounds at full width.
CLIENTS, LOCAL_STEPS, TRAIN_B, TRAIN_L, TRAIN_R = 4, 2, 4, 128, 8
TRAIN_LR = 3e-3
# Bounds set before the chip runs that test them (PERF.md): kernels vs
# plain versions, two rounds, bf16 weights. A loss near log(151936) ~ 12
# moves by ~1e-3 of itself when logits move by a bf16 ulp. The leaves are
# compared by what the two rounds changed, D = leaf - init: the Frobenius
# norm of D_kernel - D_plain over that of D_plain, all target leaves
# together. Dropping either round's update moves it by the norm of that
# round's share of D (predicted 0.5-0.85); the run also computes both
# such controls and fails unless each exceeds the bound.
TRAIN_LOSS_BOUND = 5e-2      # max |Δ per-step loss|
TRAIN_DELTA_BOUND = 0.3      # |D_kernel - D_plain|_F / |D_plain|_F
# Launches the two rounds must show (stated before the first run):
# round 0 runs the fused preconditioner once per shape bucket (3) per
# client per local step and 𝒮 once per 𝒮 bucket (3); round 1 runs the
# lift-free apply 7 x 24 = 168 times per forward, 8 forwards, and 𝒮 again.
EXPECTED_LAUNCHES = {
    0: {"galore_precond_step": 3 * CLIENTS * LOCAL_STEPS, "jacobi_eigh": 3,
        "lowrank_linear": 0},
    1: {"galore_precond_step": 0, "jacobi_eigh": 3,
        "lowrank_linear": 168 * CLIENTS * LOCAL_STEPS},
}
# Round 0's GaLore launches by route (stated before the first run): the
# buckets (4, 24, 1024, 1024) and (1, 24, 2816, 1024) project on the
# right, (2, 24, 1024, 2816) on the left, every row 16-byte aligned; the
# clip leaves the gradients in fp32, which loads into registers.
EXPECTED_GALORE_ROUTES = {"right": 2 * CLIENTS * LOCAL_STEPS,
                          "left": CLIENTS * LOCAL_STEPS}
# The train_methods phase, at phase_train's traffic: the six LoRA and
# dense methods for one round each (lora_scale 2.0), then two rounds of
# fedgalore as the eager oracle (fused_round=False). Launches stated
# before the first run: the six methods launch no kernel (the merged
# LoRA weights and the model's products are plain torch). The eager
# rounds' clients train dense leaves, so every step runs the lifted
# preconditioner (galore_precond_step, mode PRECOND_U) once per shape
# bucket, and jacobi_eigh runs only where 𝒮 takes the factored route:
# never in the adaptive round 0 (each client's ṽ lifted with its own
# basis, dense AJIVE), once per target leaf in round 1 (the shared-basis
# factored AJIVE, leaf by leaf as the reference's eager 𝒮 runs it: 7
# leaves, each a (24, 4, 8, 8) Gram stack on the warp route).
LORA_METHODS = ("fedavg_full", "fedit", "ffa_lora", "lora_fair", "flora",
                "fr_lora")
LORA_SCALE = 2.0
EAGER_LAUNCHES = {
    0: {"galore_precond_step": 3 * CLIENTS * LOCAL_STEPS, "jacobi_eigh": 0},
    1: {"galore_precond_step": 3 * CLIENTS * LOCAL_STEPS, "jacobi_eigh": 7},
}


# The population phase (stated before its first run): phase_train's
# traffic (C = 4 slots, T = 2, batch 4 x 128, rank 8) drawn from a
# 32-client population, FedConfig(quarantine=True,
# robust_agg="trimmed_mean"), PopulationRunner(shard_size=4,
# max_resident_shards=2): 8 shards, 2 resident, so the store spills. The
# plans of rounds 0-4 are pure in (config, round) and hold 6 drops, 3
# stragglers due at rounds 2, 3 and 4, and a sign flip in round 1, a
# scale in round 3, a NaN shard in round 4. Every slot trains, so the
# launches per round are phase_train's (round 0, then round 1's for
# rounds 1-4); the guard and the stale merge launch no kernel.
# jacobi_eigh solves masked score Grams (a client of zero weight:
# dropped, straggling or quarantined) in rounds 0, 2, 3 and 4.
POP_CONFIG = dict(population=32, dropout_rate=0.25, straggler_rate=0.25,
                  max_staleness=2, staleness_decay=0.5, seed=3,
                  corrupt_rate=0.25)
POP_ROUNDS, POP_SHARD, POP_RESIDENT, POP_SNAPSHOT_AFTER = 5, 4, 2, 3
POP_FAULTS = {"dropped": 6, "straggling": 3, "due": [2, 3, 4],
              "corrupt": {1: "sign_flip", 3: "scale", 4: "nan"}}
POP_LAUNCHES = {r: EXPECTED_LAUNCHES[min(r, 1)] for r in range(POP_ROUNDS)}
POP_MASKED_ROUNDS = (0, 2, 3, 4)
# The population rounds' own bound on D, set between the sound reading
# (0.123) and the smaller control (0.285) of the runs in PERF.md: losing
# round 0's update moves D less over five rounds than over two. The run
# fails unless both of its controls exceed it. Its loss control: round 1's first-step
# losses at the initial weights, i.e. with round 0's update lost.
POP_DELTA_BOUND = 0.2

# The paper's own backbones in training (stated before their first run):
# paper-roberta-like through examples/federated_finetune_100m_torch.py's
# main(["--rounds", "3"]) (C = 4, T = 4, batch 4 x 64, rank 8, lr 1e-4,
# fedgalore), and paper-vit-like for two fedgalore rounds on the patch
# task (196 patch embeddings + 4 text tokens, C = 4, T = 2, batch 4,
# rank 8, lr 3e-3), each with an evaluation forward under no_grad. Their
# six adapted projections a layer are wq wk wv wo (768, 768), w_up (768,
# 3072) and w_down (3072, 768): round 0 runs the preconditioner on the
# three shape buckets (4, 12, 768, 768) and (1, 12, 768, 3072) (left) and
# (1, 12, 3072, 768) per client and local step, and 𝒮 on three buckets
# (Grams (4, 12, 4, 8, 8) and twice (12, 4, 8, 8)); later rounds read the
# 6 x 12 = 72 projections of each forward lift-free.
NLU_LAYERS = 12
NLU_SHAPES = {(768, 768): 4, (768, 3072): 1, (3072, 768): 1}
NLU_ROUNDS, NLU_CLIENTS, NLU_STEPS, NLU_B, NLU_L = 3, 4, 4, 4, 64
NLU_EVAL = 128                  # the example's evaluation batch
VIT_ROUNDS, VIT_STEPS, VIT_B, VIT_PATCHES, VIT_TEXT = 2, 2, 4, 196, 4
VIT_L = VIT_PATCHES + VIT_TEXT
VIT_EXAMPLES, VIT_CLASSES, VIT_EVAL = 256, 8, 32


def nlu_launches(steps):
    """Per round launches of a paper-backbone FedGaLore round with C =
    NLU_CLIENTS clients of ``steps`` local steps."""
    forwards = NLU_CLIENTS * steps
    return {0: {"galore_precond_step": 3 * forwards, "jacobi_eigh": 3,
                "lowrank_linear": 0},
            1: {"galore_precond_step": 0, "jacobi_eigh": 3,
                "lowrank_linear": 6 * NLU_LAYERS * forwards}}


# Evaluation forwards (flash_attention, once a layer): the example
# evaluates after rounds 0 and 2, each a forward and a loss_fn; the vit
# phase after each round, a loss_fn.
NLU_FLASH = 2 * 2 * NLU_LAYERS
VIT_FLASH = VIT_ROUNDS * NLU_LAYERS
# D's bound for the three roberta rounds, set between the sound reading
# and its controls as POP_DELTA_BOUND: dropping one of three rounds'
# updates moves D by about a third of it or more. The vit rounds are held
# to TRAIN_DELTA_BOUND, as phase_train's two.
NLU_DELTA_BOUND = 0.2

# RWKV6 training (stated before its first run): rwkv6-1.6b at full width
# through phase_train's traffic (C = 4, T = 2, batch 4 x 128, rank 8), two
# fedgalore rounds, then one fedit round, at lr RWKV_LR. Its eight adapted
# projections a layer are the time-mix wr wk wv wg wo and channel-mix wr
# (2048, 2048), channel-mix wk (2048, 7168) and wv (7168, 2048): round 0
# runs the preconditioner on the buckets (6, 24, 2048, 2048), (1, 24,
# 7168, 2048) (right) and (1, 24, 2048, 7168) (left) per client and local
# step and 𝒮 on three buckets (Grams (6, 24, 4, 8, 8) and twice (24, 4, 8,
# 8)); round 1 reads the 8 x 24 = 192 projections of each forward
# lift-free. Every forward runs the WKV recurrence 24 times in the
# checkpoint mode and every backward 24 times through rwkv6_scan_bwd; the
# fedit round's LoRA nodes are plain products, so it launches the scan
# pair alone.
# Its lr, 3e-4, and its gates come from card runs of this configuration
# (NVIDIA H100 80GB HBM3, 700 W; scripts/rwkv_train_floor.py): the
# random-weight rwkv6-1.6b amplifies rounding so far that at
# phase_train's 3e-3 one local step moves a loss by up to 10.7 nats and
# the embedding-ulp control reads 1.92 on the losses; at 1e-4 the loss
# control (round 0's update lost, 0.104) sits under the rounding floor
# (0.137). At 3e-4 the losses are gated at max(TRAIN_LOSS_BOUND, the
# embedding-ulp control), the loss control must read above that, round
# 0's first local step must repeat the plain run bit for bit, and the
# fedit round (no kernel but the bit-identical scan pair) must too. D,
# the rounds' change of the leaves, sits at this model's rounding floor
# (scripts/rwkv_train_floor.py, seeds 0-2): after both rounds a sound run
# (0.35-0.46), ulp noise at the kernels' outputs (0.34-0.41) and a run
# without its last round (0.39-0.49) read alike; round 1 alone, from one
# start, reads 0.84-0.93 and under ulp noise 0.91-0.95, against 1.0 lost;
# round 0 alone reads 0.19-0.34 against the plain run, 0.12-0.18 under
# ulp noise. So only round 0's D is gated, and against a second
# reference: the plain run with the GaLore preconditioner in float64 (the
# fp32 plain version is the less exact, ROADMAP Queue 3 w). The kernel
# run must lie within max(TRAIN_DELTA_BOUND, the fp32 plain run's own D
# against it) of it, and round 0 lost above that. Round 1's 𝒮 is run
# again with the plain versions on the kernel run's own client states
# and held to RWKV_SYNC_TOL, the ṽ tolerance of the CPU tests (ROADMAP
# Queue 3 e), or 𝒮's own rounding floor where that reads higher (the
# plain 𝒮 on the states moved one ulp); round 0's stale ṽ must read
# above it.
RWKV_LR = 3e-4
RWKV_SYNC_TOL = 3e-4
RWKV_TRAIN_SHAPES = {(2048, 2048): 6, (2048, 7168): 1, (7168, 2048): 1}
RWKV_BUCKETS = [((6, 24), 2048, 2048), ((1, 24), 2048, 7168),
                ((1, 24), 7168, 2048)]
_FWD = CLIENTS * LOCAL_STEPS          # local forwards (and backwards) a round
RWKV_TRAIN_LAUNCHES = {
    0: {"galore_precond_step": 3 * _FWD, "jacobi_eigh": 3,
        "lowrank_linear": 0, "rwkv6_scan": 24 * _FWD,
        "rwkv6_scan_bwd": 24 * _FWD},
    1: {"galore_precond_step": 0, "jacobi_eigh": 3,
        "lowrank_linear": 8 * 24 * _FWD, "rwkv6_scan": 24 * _FWD,
        "rwkv6_scan_bwd": 24 * _FWD},
}
RWKV_FEDIT_LAUNCHES = {"rwkv6_scan": 24 * _FWD, "rwkv6_scan_bwd": 24 * _FWD}
# rwkv6_scan_bwd against its plain version, set before the first run: bit
# for bit (gated), since ref.rwkv6_scan_bwd_ref is written in the kernel's
# order. Each case also reports its relative reading per output beside
# SCAN_TOL (fp32 outputs) or one bf16 ulp of the scale (bf16 outputs); the
# planted faults (dw taken against S_t instead of S_{t-1}; the u term
# dropped) must read above those.


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ----------------------------------------------------------------- build --

_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_USE = re.compile(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")


def ptxas_summary(log: str):
    """Per entry function: registers, static shared memory, spills."""
    out, cur = [], None
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            name = m.group(1)
            short = re.search(r"(fp32_shrink_kernel|fp32_gemm_kernel|"
                              r"reduce_kernel|tc_gemm_kernel|"
                              r"tc_decode_kernel|right_kernel|"
                              r"left_kernel|wkv6_kernel|wkv6_bwd_kernel|"
                              r"simt_kernel|"
                              r"tc_kernel|jacobi_warp_kernel|"
                              r"jacobi_pair_kernel)"
                              r"I(.*?)EEv", name)
            plain = re.search(r"(jacobi_block_kernel|tc_shrink_kernel|"
                              r"tc_sum_kernel)", name)
            cur = {"function": (short.group(1) + "<" + short.group(2) + ">")
                   if short else plain.group(1) if plain else name}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_USE.search(line.strip())
        if m:
            cur.update(registers=int(m.group(1)),
                       smem=int(m.group(2) or 0))
    return out


# ------------------------------------------------------------ kernel data --

def make_case(gen, m, n, t, dtype, ids, two_d=False, dev="cuda", r=R):
    side = "right" if m >= n else "left"
    bdim = n if side == "right" else m
    b = len(ids)
    x = torch.randn((b, m) if two_d else (b, t, m), generator=gen,
                    device=dev).to(dtype)
    w = (torch.randn(m, n, generator=gen, device=dev) / m ** 0.5).to(dtype)
    bases = torch.randn(G, bdim, r, generator=gen, device=dev) / bdim ** 0.5
    rts = 0.02 * torch.randn(*((G, m, r) if side == "right" else (G, r, n)),
                             generator=gen, device=dev)
    scales = 1.0 + 0.1 * torch.randn(G, generator=gen, device=dev)
    return dict(x=x, w=w, bases=bases, rts=rts, scales=scales,
                ids=torch.as_tensor(ids, dtype=torch.int32, device=dev),
                side=side)


def case_key(x, w):
    """(B, t, m, n, x dims, dtype) of one kernel call."""
    return (x.shape[0], x.shape[1] if x.ndim == 3 else 1, *w.shape, x.ndim,
            str(x.dtype).split(".")[1])


def bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def bound(case):
    """(ms, 'bytes'|'operations'): each input read once (tables: only the
    adapters this batch selects), the output written once; the base GEMM at
    its operands' peak, the rank-r shrink/expand on fp32 tables at FP32."""
    x, w, ids = case["x"], case["w"], case["ids"]
    m, n = w.shape
    rows = x.numel() // m
    used = len(set(ids.tolist()))
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + used * (case["bases"][0].numel() + case["rts"][0].numel()
                        + 1) * 4 + ids.numel() * 4
              + rows * n * torch.result_type(x, w).itemsize)
    peak = PEAK_BF16 if x.dtype == w.dtype == torch.bfloat16 else PEAK_FP32
    ops_s = 2.0 * rows * m * n / peak + 2.0 * rows * R * (m + n) / PEAK_FP32
    bytes_s = nbytes / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


def time_ms(fn, sets, warmup=5, iters=40):
    """Mean ms per call with CUDA events; ``sets`` rotate so the working
    set exceeds the 50 MB L2, as in a real forward where each layer's
    weights arrive cold."""
    for i in range(warmup):
        fn(sets[i % len(sets)])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for i in range(iters):
        fn(sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, sets, calls=20, replays=5):
    """Mean device ms per call with the host out of the way: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in sets[:3]:
            fn(c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------- phases --

def sass_count(name: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the built library's SASS."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.build(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return len(re.findall(r"\b" + opcode + r"\b", sass))


def phase_build():
    """One nvcc per source, all started together. The SASS of rwkv6_scan
    and rwkv6_scan_bwd must hold no fused multiply-add (their order is the
    plain versions'); the
    GaLore kernel's rank-8 instantiations (both sides, fp32 and bf16 g)
    must not spill."""
    from repro_torch.kernels import _build
    for name, seconds in _build.build_all().items():
        row = {"phase": "build", "kernel": name, "seconds": seconds,
               "ptxas": ptxas_summary(_build.PTXAS_LOG.get(name, ""))}
        if name in ("rwkv6_scan", "rwkv6_scan_bwd"):
            row["ffma"] = sass_count(name, "FFMA")
        emit(row)
        check(row.get("ffma", 0) == 0,
              f"{name}: {row.get('ffma')} FFMA in the SASS")
        if name == "galore_adamw":      # the rank-8 kernels the path runs
            path = [f for f in row["ptxas"] if "<Li8E" in f["function"]]
            check(len(path) == 4 and all(
                f.get("spill_stores") == 0 == f.get("spill_loads")
                for f in path), f"galore_adamw: the rank-8 kernels spill "
                f"or are missing: {path}")


# Route edges of the low-rank applies, (B, t, m, n): rows 1, 16, 17 (the
# two decode widths), TC_MIN_ROWS - 1, TC_MIN_ROWS and + 1 (decode / GEMM),
# 65 one-row sequences (a GEMM tile over more sequences than its shared E
# tiles), t = 100 tiles spanning two sequences, 1,024 rows; n = 520 (not a
# multiple of the 128-column tile), m = 1,032 (not a multiple of the
# 64-wide K tile: decode's last K chunk is 8 values), m = 4,104 with a
# split GEMM whose last chunk is short. Every one is bf16; the misaligned
# x view and fp32 cases take the fp32 route.
ROUTE_EDGES = [(1, 1, 1024, 1024), (16, 1, 4608, 512), (17, 1, 1024, 2816),
               (1, 63, 2816, 1024), (1, 64, 1024, 1024), (1, 65, 1032, 520),
               (65, 1, 1024, 1024), (8, 100, 1032, 520), (8, 1, 1032, 520),
               (2, 100, 4104, 136), (8, 128, 2816, 1024)]
# Ranks and widths the paths do not send, on both tensor-core routes,
# (B, t, m, n, r): r = 3 (no 16-byte rank loads), 24 (two rank passes of
# the shrink, the epilogue's general loop), 64 (the largest the tc routes
# take); n = 24 and m = 64, narrower than one TMA box.
RANK_EDGES = [(8, 1, 1024, 1024, 3), (1, 128, 1024, 1024, 3),
              (8, 1, 1024, 1024, 24), (1, 128, 1024, 1024, 24),
              (1, 100, 2048, 512, 64), (8, 1, 512, 2048, 64),
              (8, 1, 2048, 24, R), (1, 128, 2048, 24, R),
              (1, 64, 64, 1024, R), (8, 1, 64, 1024, R)]


def _route_taken(fn, before):
    """The route whose counter moved since ``before`` (one launch)."""
    moved = [k for k, v in fn.routes.items() if v != before[k]]
    check(len(moved) == 1, f"one launch moved routes {moved}")
    return moved[0]


def _want_route(rows, dtype, aligned=True):
    from repro_torch.kernels import lowrank_linear as ll
    if dtype != torch.bfloat16 or not aligned:
        return "fp32"
    return "tc_gemm" if rows >= ll.TC_MIN_ROWS else "tc_decode"


def _misaligned(x):
    """The same values as a contiguous view whose data starts 2 bytes past
    a 16-byte boundary (x's storage offset by one bf16 element)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    check(view.is_contiguous() and view.data_ptr() % 16 == 2,
          "misaligned view is not what the route check needs")
    return view


def phase_kernel_checks(gen, shapes, edges=False, two_d=()):
    """The kernel against the plain version at a serving path's (m, n)
    ``shapes`` (square, wide, tall): decode (B, 1) of SlotServer and
    generate, prefill (B, PROMPT) of generate and (1, PROMPT) of
    SlotServer's per-request admission, ragged tails, fp32 and 2-D x (at
    the last shape and at each of ``two_d``, the shapes a decode reads
    with 2-D x);
    with ``edges``, the routes' edges (ROUTE_EDGES), ranks and widths the
    paths do not send (RANK_EDGES) and a misaligned x view. Each check
    states its route and fails on another. Returns the worst error and
    the keys checked."""
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels.ref import lowrank_linear_batched_ref
    ids = [0, 3, 3, 7, 1, 0, 5, 2]          # duplicates, not every adapter
    cases = [(b, m, n, t, torch.bfloat16, False, False, R)
             for (m, n) in shapes
             for b, t in ((B, 1), (B, 100), (B, PROMPT), (1, PROMPT),
                          (1, 100))]
    cases += [(B, *shapes[-2], 100, torch.float32, False, False, R)]
    cases += [(B, m, n, 1, torch.bfloat16, True, False, R)       # 2-D x
              for m, n in dict.fromkeys([shapes[-1], *two_d])]
    if edges:
        cases += [(b, m, n, t, torch.bfloat16, False, False, R)
                  for b, t, m, n in ROUTE_EDGES]
        cases += [(b, m, n, t, torch.bfloat16, False, False, r)
                  for b, t, m, n, r in RANK_EDGES]
        cases += [(B, *shapes[0], 1, torch.bfloat16, False, True, R),
                  (1, *shapes[0], PROMPT, torch.bfloat16, False, True, R),
                  (B, 1032, 520, 1, torch.float32, False, False, R)]
    worst, checked = 0.0, set()
    fn = ll.lowrank_linear_batched
    for b, m, n, t, dtype, two_d, misalign, r in cases:
        c = make_case(gen, m, n, t, dtype, ids[-b:] if b <= len(ids) else
                      [ids[i % len(ids)] for i in range(b)], two_d, r=r)
        if misalign:
            c["x"] = _misaligned(c["x"])
        args = (c["x"], c["w"], c["bases"], c["rts"], c["scales"], c["ids"])
        before = dict(fn.routes)
        y = fn(*args, side=c["side"])
        torch.cuda.synchronize()
        took = _route_taken(fn, before)
        want = lowrank_linear_batched_ref(*args, side=c["side"])
        check(y.dtype == want.dtype and y.shape == want.shape,
              f"kernel output {y.dtype}{tuple(y.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        err = (y.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2 * bf16_ulp(scale)
        emit({"phase": "kernel_check", "B": b, "m": m, "n": n, "t": t,
              "r": r, "x_dims": c["x"].ndim,
              "dtype": str(dtype).split(".")[1],
              "side": c["side"], "misaligned_x": misalign, "route": took,
              "max_abs_err": err, "out_scale": scale, "tol": tol})
        check(took == _want_route(b * t, dtype, not misalign),
              f"B={b} t={t} m={m} n={n} {dtype} took route {took}")
        check(err <= tol, f"kernel disagrees with plain at B={b} m={m} n={n} "
                          f"t={t} r={r} {dtype} ({took}): {err} > {tol}")
        worst = max(worst, err)
        checked.add(case_key(c["x"], c["w"]))
    return worst, checked


class ShapeLog:
    """Records the shape key of every call ``kernels.ops`` makes to the
    wrappers named in ``logged`` ({ops module attribute: {function: key
    function}}). Only ``ops``' module references are swapped for proxies,
    so the wrappers and their launch counters stay as they are."""

    def __init__(self, logged):
        self.logged = logged

    def __enter__(self):
        from types import SimpleNamespace
        from repro_torch.kernels import ops
        self.ops, self.orig, self.seen = ops, {}, {}
        for attr, fns in self.logged.items():
            mod = getattr(ops, attr)
            self.orig[attr] = mod
            proxy = SimpleNamespace(**{k: getattr(mod, k) for k in dir(mod)
                                       if not k.startswith("__")})
            for fname, key in fns.items():
                self.seen[fname] = set()

                def logged(*args, _f=getattr(mod, fname), _k=key,
                           _s=self.seen[fname], **kw):
                    _s.add(_k(*args, **kw))
                    return _f(*args, **kw)

                setattr(proxy, fname, logged)
            setattr(ops, attr, proxy)
        return self

    def __exit__(self, *exc):
        for attr, mod in self.orig.items():
            setattr(self.ops, attr, mod)
        return False


def _batched_key(x, w, *args, **kw):
    return case_key(x, w)


def _scan_key(r, k, v, w, u, s0=None, *, chunk=128, checkpoints=False):
    """(B, L, H, D, r/k/v dtype, w dtype, s0 given, chunk, checkpoint mode)
    of one call."""
    return (*r.shape, str(r.dtype).split(".")[1], str(w.dtype).split(".")[1],
            s0 is not None, chunk, checkpoints)


def _scan_bwd_key(r, k, v, w, u, ckpt, dy, ds_final=None):
    """(B, L, H, D, r/k/v dtype, w dtype, ds_final given) of one backward
    call."""
    return (*r.shape, str(r.dtype).split(".")[1], str(w.dtype).split(".")[1],
            ds_final is not None)


def _flash_key(q, k, v, *, causal=True, window=0, scale=None):
    """(q shape, k shape, dtype, causal, window, q contiguous) of one
    call."""
    return (tuple(q.shape), tuple(k.shape), str(q.dtype).split(".")[1],
            bool(causal), int(window), q.is_contiguous())


SERVE_LOG = {"_ll": {"lowrank_linear_batched": _batched_key},
             "_rwkv": {"rwkv6_scan": _scan_key},
             "_flash": {"flash_attention": _flash_key}}


def _full_config(arch):
    """The registered full-width bf16 config, its depth cut to
    CUT_LAYERS[arch] where the whole model exceeds one card."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    check(cfg.param_dtype == torch.bfloat16 and
          cfg.n_layers == FULL_LAYERS[arch],
          f"{arch} config is not the full-width bf16 one")
    if arch not in CUT_LAYERS:
        return cfg
    return dataclasses.replace(cfg, n_layers=CUT_LAYERS[arch])


def _adapted_per_forward(served) -> int:
    """``lowrank_linear_batched`` launches one forward makes: one per
    layer of every target leaf ``serving_target_fn`` wrapped (a stacked
    (nb, m, n) leaf is nb layers)."""
    from repro_torch.models import layers
    from repro_torch.utils import tree
    is_leaf = lambda x: isinstance(x, layers.MultiAdapterDelta)  # noqa: E731
    return sum(int(x.w.shape[0]) for x in
               tree.tree_leaves(served, is_leaf=is_leaf) if is_leaf(x))


def _check_launches(arch, launches, expected):
    for name, count in launches.items():
        check(count == expected.get(name, 0),
              f"{arch}: {name} launched {count} times, expected "
              f"{expected.get(name, 0)}: a layer bypassed its kernel or ran "
              "one it does not use")


# The routes off the tensor cores: the low-rank applies' fp32 and
# flash_attention's simt. No ported path may take them.
SLOW_ROUTES = ("fp32", "simt")


def _check_tc_routes(path, launches, routes):
    """Every launch on a path of a kernel with routes went through one of
    its routes, and for the low-rank applies and flash_attention a
    tensor-core one (tc_gemm or tc_decode, tc), none through SLOW_ROUTES.
    jacobi_eigh's routes (warp, block) are both fast; phase_train holds
    the path's launches to warp."""
    for name, by_route in routes.items():
        check(sum(by_route.get(k, 0) for k in SLOW_ROUTES) == 0 and
              sum(by_route.values()) == launches[name],
              f"{path}: {name} routes {by_route} for {launches[name]} "
              "launches: a path call left the tensor-core routes")


def _check_shapes(arch, seen, checked):
    for name, keys in seen.items():
        check(keys <= checked.get(name, set()), f"{arch}: the main path "
              f"launched {name} at shapes the kernel checks did not cover: "
              f"{sorted(keys - checked.get(name, set()))}")


def phase_serve(seed, card, checked, arch, per_forward, phase,
                ragged=None, per_prefill=None, requests=2 * B, new=NEW):
    """A serving path at full width: SlotServer serves ``requests``
    requests of ``new`` tokens (every other prompt cut to ``ragged``
    tokens when given), then generate runs once on B prompts; every
    adapted projection goes through ``lowrank_linear_batched``,
    for RWKV every layer's recurrence through ``rwkv6_scan``, and for a
    dense model every prefill layer's attention through
    ``flash_attention``. ``per_forward`` states each kernel's launches per
    forward, ``per_prefill`` those per prefill forward on top; ``checked``
    holds each kernel's checked shape keys."""
    from repro_torch.launch import adapters as adapters_lib
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib

    per_prefill = per_prefill or {}
    cfg = _full_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=seed, device="cuda")
    served = adapters_lib.demo_wrap(params, cfg, G, rank=R, seed=seed + 2)
    del params
    derived = {"lowrank_linear_batched": _adapted_per_forward(served),
               "flash_attention": sum(mix == "attn"
                                      for mix, _ in cfg.layer_kinds())}
    check(derived["lowrank_linear_batched"]
          == per_forward.get("lowrank_linear_batched", 0) and
          derived["flash_attention"]
          == per_prefill.get("flash_attention", 0),
          f"{arch}: stated launches per forward {per_forward} / per prefill "
          f"{per_prefill} are not the served model's {derived}")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()      # the serving run's own peak
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(0, cfg.vocab_size, (max(requests, B), PROMPT),
                           dtype=np.int32)
    reqs = [serve.Request(rid=i,
                          prompt=prompts[i][:ragged if i % 2 else None],
                          max_new=new, adapter=i % G) for i in range(requests)]
    # warm-up (CUDA context, library handles), outside the counted run
    serve.SlotServer(served, cfg, slots=B, cache_len=PROMPT + new).run(
        [serve.Request(rid=0, prompt=prompts[0], max_new=2)])

    _zero_counts()
    with ShapeLog(SERVE_LOG) as log:
        srv = serve.SlotServer(served, cfg, slots=B, cache_len=PROMPT + new,
                               segment=8)
        out = srv.run(reqs)
        gen_out = serve.generate(served, cfg, prompts[:B], new, PROMPT + new,
                                 adapters=np.arange(B) % G)
        torch.cuda.synchronize()
    launches = _launch_counts()
    routes = _route_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_shapes(arch, log.seen, checked)
    _check_tc_routes(arch, launches, routes)

    s = out["stats"]
    prefills = s["admitted"] + 1                    # SlotServer, generate
    forwards = prefills + s["segments"] * srv.segment + (new - 1)
    _check_launches(arch, launches, {
        name: per_forward.get(name, 0) * forwards
        + per_prefill.get(name, 0) * prefills
        for name in set(per_forward) | set(per_prefill)})
    check(s["admitted"] == requests and not srv.active.any(),
          "SlotServer did not serve every request")
    for i in range(requests):
        toks = out["outputs"][i]
        check(len(toks) == new and all(0 <= v < cfg.vocab_size
                                       for v in toks),
              f"request {i}: {len(toks)} tokens, out of range or short")
    check(tuple(gen_out.shape) == (B, PROMPT + new) and
          bool(((gen_out >= 0) & (gen_out < cfg.vocab_size)).all()),
          "generate output has the wrong shape or range")
    emit({"phase": phase, "arch": cfg.name, "card": card,
          "n_layers": cfg.n_layers, "cut_from": FULL_LAYERS[arch]
          if arch in CUT_LAYERS else None,
          "params_b": cfg.param_count() / 1e9,
          "phase_s": time.perf_counter() - t0,
          "requests": requests, "slots": B, "prompt": PROMPT,
          "ragged_prompt": ragged, "max_new": new, "adapters": G, "rank": R,
          "setup_s": setup_s, "prefill_tok_s": s["prefill_tok_s"],
          "decode_tok_s": s["decode_tok_s"], "segments": s["segments"],
          "forwards": forwards, "prefill_forwards": prefills,
          "launches": launches, "launches_per_forward": per_forward,
          "launches_per_prefill": per_prefill, "routes": routes,
          "peak_gib": peak,
          "setup_peak_gib": setup_peak,
          "resident_gib": torch.cuda.memory_allocated() / 2 ** 30,
          "kernel_shapes": {k: sorted(v) for k, v in log.seen.items()}})
    return cfg, served, launches, routes


class RouteLog:
    """Records the experts every MoE layer picks (``moe.route``'s (N, k)
    top indices) while active, in call order. With ``pin`` (another run's
    picks, the same calls) each layer routes its tokens to the pinned
    experts instead, gated by its own router probabilities renormalised
    over them; ``picks`` still records its own choices."""

    def __init__(self, pin=None):
        self.pin = pin

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.picks = moe, moe.route, []

        def logged(router_w, x, k):
            gates, idx, aux = self.orig(router_w, x, k)
            if self.pin is not None:
                want = self.pin[len(self.picks)]
                check(want.shape == idx.shape, "a pinned run routed another "
                      "number of tokens than the run it is pinned to")
                probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
                vals = torch.gather(probs, 1, want)
                gates = vals / (torch.sum(vals, dim=-1, keepdim=True) + 1e-9)
            self.picks.append(idx)
            return gates, (idx if self.pin is None else want), aux

        moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig
        return False


def routing_flip_share(picks, other) -> float:
    """The share of (token, slot) expert choices in ``picks`` that
    ``other`` (the same calls, another run) does not make: the experts a
    token gains, over all tokens and slots of all layers; an order swap
    within a token's top k is no flip."""
    check(len(picks) == len(other) and all(a.shape == b.shape for a, b in
                                           zip(picks, other)),
          "the two runs routed different numbers or shapes of tokens")
    gained = total = 0
    for a, b in zip(picks, other):
        n_exp = int(max(a.max(), b.max())) + 1
        oa = torch.nn.functional.one_hot(a, n_exp).sum(1)
        ob = torch.nn.functional.one_hot(b, n_exp).sum(1)
        gained += int((oa - ob).clamp(min=0).sum())
        total += a.numel()
    return gained / max(total, 1)


def _bump_embed(emb, seed):
    """The embedding table with 1 % of its entries (drawn from ``seed``)
    one bf16 ulp up: the rounding-floor control of the parity checks."""
    noise = torch.Generator(device="cuda")
    noise.manual_seed(seed)
    moved = torch.rand(emb.shape, generator=noise, device="cuda") < 0.01
    return torch.where(
        moved, torch.nextafter(emb, torch.full_like(emb, float("inf"))), emb)


def parity_readings(cfg, served, seed, batch=B, prompt=PROMPT,
                    adapters=True, bumps=1):
    """The logits of one prefill of ``batch`` x ``prompt`` tokens + 4
    decode steps (5, batch, vocab), the same tokens fed to every run (each
    row its own adapter, or the base weights): ``got`` through the
    kernels, ``want`` through their plain versions, ``controls`` the plain
    path with 1 % of the embedding table one bf16 ulp up, one run for each
    of ``bumps`` draws of the moved entries (the model's own amplification
    of rounding), and with adapters ``fault``, the kernel path with each
    row's adapter id rolled by one (as a wrong gather in
    ``lowrank_linear_batched`` would apply). Every run routes freely; each
    run's expert choices are kept under ``routes``. For an MoE model,
    ``pinned`` holds the kernel run, the first control and the fault again
    with every token routed to the experts the plain run chose
    (``RouteLog(pin=...)``), so they read the arithmetic alone. Also the
    kernel and plain runs' peak memory."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    rng = np.random.default_rng(seed + 3)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt), dtype=np.int32),
                              device="cuda")
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, batch),
                                        dtype=np.int32), device="cuda")
    ids = (torch.arange(batch, dtype=torch.int32, device="cuda") % G
           if adapters else None)

    @torch.inference_mode()
    def run(params=served, ids=ids, plain=False, pin=None):
        st = model_lib.init_decode_state(cfg, batch, prompt + 4,
                                         device="cuda")
        outs = []
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(ops.plain_kernels())
            routes = stack.enter_context(RouteLog(pin))
            stack.enter_context(layers.adapter_ids(ids))
            logits, st = model_lib.prefill(params, cfg, prompts, st)
            outs.append(logits)
            for i in range(4):
                logits, st = model_lib.decode_step(params, cfg, feed[i], st)
                outs.append(logits)
        return torch.stack(outs), routes.picks

    def bumped(j):
        return dict(served, embed={"w": _bump_embed(served["embed"]["w"],
                                                    seed + 5 + j)})

    torch.cuda.reset_peak_memory_stats()
    got, got_routes = run()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    want, want_routes = run(plain=True)
    plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    controls, control_routes = zip(*(run(bumped(j), plain=True)
                                     for j in range(bumps)))
    fault, fault_routes = (run(ids=(ids + 1) % G) if adapters
                           else (None, None))
    pinned = None
    if want_routes:
        pinned = {"got": run(pin=want_routes)[0],
                  "control": run(bumped(0), plain=True, pin=want_routes)[0],
                  "fault": (run(ids=(ids + 1) % G, pin=want_routes)[0]
                            if adapters else None)}
    torch.cuda.synchronize()
    return {"got": got, "want": want, "controls": list(controls),
            "fault": fault, "pinned": pinned, "peak_gib": peak,
            "plain_peak_gib": plain_peak,
            "routes": {"got": got_routes, "want": want_routes,
                       "controls": list(control_routes),
                       "fault": fault_routes}}


def _logit_rel(a, b, scale):
    return None if a is None else (a - b).abs().max().item() / scale


def phase_parity(cfg, served, seed, phase="parity", batch=B, prompt=PROMPT,
                 adapters=True, floor_gate=False, controls=1,
                 gate_flips=False):
    """Kernel vs plain version on the card over ``parity_readings``' one
    prefill and 4 decode steps, gated at PARITY_BOUND of the logit scale.
    The control (the plain path with 1 % of the embedding table one bf16
    ulp up, the largest reading over ``controls`` draws of the moved
    entries) reads the model's own amplification of rounding, the floor
    under any kernel that rounds in another order; it is reported, and
    with ``floor_gate`` (a model whose control reads above PARITY_BOUND:
    no implementation that rounds in another order could meet the bound)
    the gate is that control instead. With adapters, the planted fault
    (rolled adapter ids) must read above the gate, so the gate can fail a
    wrong kernel. An MoE model is gated twice, each gate with its own
    control and fault: the free runs as above, and the runs pinned to the
    plain run's experts at PARITY_BOUND, where no flipped expert choice
    moves a token's logits and the reading is the kernels' arithmetic.
    The share of expert choices that differ from the plain run's is
    reported for the kernel run, the controls and the fault. With
    ``gate_flips`` (a model whose free logits no gate can hold: its
    controls reach the planted fault's reading) the free runs are gated
    on that share instead, the kernel run's at most the largest
    control's and the fault's above it, and the free logit reading is
    reported beside them."""
    t0 = time.perf_counter()
    r = parity_readings(cfg, served, seed, batch, prompt, adapters,
                        bumps=controls)
    got, want = r["got"], r["want"]
    check(bool(torch.isfinite(got).all()), "kernel-path logits not finite")
    scale = want.abs().max().item()
    rel = _logit_rel(got, want, scale)
    floors = [_logit_rel(c, want, scale) for c in r["controls"]]
    floor = max(floors)
    gate = max(PARITY_BOUND, floor) if floor_gate else PARITY_BOUND
    fault_rel = _logit_rel(r["fault"], want, scale)
    control = r["controls"][floors.index(floor)]
    row = {"phase": phase, "arch": cfg.name, "card": card_line(),
           "forwards": "prefill + 4 decode", "batch": batch,
           "prompt": prompt, "adapters": G if adapters else 0,
           "logit_scale": scale, "max_abs_diff_rel": rel,
           "per_forward_rel": [(g - w).abs().max().item() / scale
                               for g, w in zip(got, want)],
           "greedy_agreement":
               (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
           "bound": PARITY_BOUND, "gate": None if gate_flips else gate,
           "peak_gib": r["peak_gib"], "plain_peak_gib": r["plain_peak_gib"],
           "control_embed_ulp_rel": floor, "controls_embed_ulp_rel": floors,
           "control_greedy_agreement":
               (control.argmax(-1) == want.argmax(-1)).float().mean().item(),
           "fault_adapter_ids_rolled_rel": fault_rel}
    routes, pinned = r["routes"], r["pinned"]
    flips = control_flips = fault_flips = None
    if pinned is not None:
        flips = routing_flip_share(routes["got"], routes["want"])
        control_flips = max(routing_flip_share(c, routes["want"])
                            for c in routes["controls"])
        fault_flips = (routing_flip_share(routes["fault"], routes["want"])
                       if adapters else None)
        row.update(
            moe_routes=len(routes["want"]), routing_flip_share=flips,
            control_routing_flip_share=control_flips,
            fault_routing_flip_share=fault_flips,
            flip_gate=control_flips if gate_flips else None,
            pinned_max_abs_diff_rel=_logit_rel(pinned["got"], want, scale),
            pinned_control_embed_ulp_rel=_logit_rel(pinned["control"],
                                                    want, scale),
            pinned_fault_adapter_ids_rolled_rel=_logit_rel(
                pinned["fault"], want, scale),
            pinned_gate=PARITY_BOUND)
    row["phase_s"] = time.perf_counter() - t0
    emit(row)
    if gate_flips:
        check(pinned is not None, f"{cfg.name}: gate_flips needs MoE layers")
        check(flips <= control_flips,
              f"{cfg.name}: the kernel run flips {flips} of the expert "
              f"choices > its controls' {control_flips}")
        check(fault_flips is None or fault_flips > control_flips,
              f"{cfg.name}: rolled adapter ids flip {fault_flips} of the "
              f"expert choices <= the controls' {control_flips}: the gate "
              f"cannot see a wrong adapter")
    else:
        check(rel <= gate, f"{cfg.name}: end-to-end logits differ by {rel} "
                           f"of the logit scale > {gate}")
        check(fault_rel is None or fault_rel > gate,
              f"{cfg.name}: rolled adapter ids read {fault_rel} <= the gate "
              f"{gate}: the parity check cannot see a wrong adapter")
    if pinned is not None:
        check(row["pinned_max_abs_diff_rel"] <= PARITY_BOUND,
              f"{cfg.name}: with the plain run's experts the logits differ "
              f"by {row['pinned_max_abs_diff_rel']} of the logit scale > "
              f"{PARITY_BOUND}")
        check(fault_rel is None or
              row["pinned_fault_adapter_ids_rolled_rel"] > PARITY_BOUND,
              f"{cfg.name}: with the plain run's experts rolled adapter ids "
              f"read {row['pinned_fault_adapter_ids_rolled_rel']} <= "
              f"{PARITY_BOUND}")


# ------------------------------------- Mamba scan and MLA decode times --

def mamba_scan_bound(b, l, di, ds):
    """(ms, 'bytes'|'operations') of one Mamba layer's scan: x (bf16) and
    Δ (fp32) (B, L, di), B and C (fp32) (B, L, ds), A (di, ds) and h0
    (fp32) read once, y (B, L, di) and the final h written once (fp32); 7
    fp32 operations per (b, t, d, s) (Δ·A, its exp, the decay times h,
    (Δx)·B, the sum, the readout's multiply and add) and 1 per (b, t, d)
    (Δ·x), the exp counted as one."""
    nbytes = (b * l * di * (2 + 4) + 2 * b * l * ds * 4 + di * ds * 4
              + b * di * ds * 4 + b * l * di * 4 + b * di * ds * 4)
    return _bound(nbytes, [(7.0 * b * l * di * ds + b * l * di, PEAK_FP32)])


def phase_mamba_scan_times(gen, card):
    """One jamba-1.5-large-398b Mamba layer's selective scan
    (``models/mamba.py::_scan``, plain PyTorch: no kernel of the port runs
    it) at d_inner 16384, d_state 16, at SlotServer's admission prefill
    (1, PROMPT) and at decode (B, 1), eager and from a CUDA graph, against
    its bound."""
    from repro_torch.models import mamba as mamba_lib
    di, ds = 2 * 8192, 16
    a = -torch.arange(1, ds + 1, dtype=torch.float32,
                      device="cuda").expand(di, ds)
    rows = []
    for label, b, l in (("admission prefill", 1, PROMPT), ("decode", B, 1)):
        def case():
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device="cuda")
            return dict(xc=rnd(b, l, di).to(torch.bfloat16),
                        delta=torch.nn.functional.softplus(rnd(b, l, di)),
                        bmat=rnd(b, l, ds), cmat=rnd(b, l, ds),
                        h=0.1 * rnd(b, di, ds))
        sets = [case() for _ in range(4)]
        b_ms, b_by = mamba_scan_bound(b, l, di, ds)
        row = {"phase": "mamba_scan_times", "card": card, "shape": label,
               "B": b, "L": l, "d_inner": di, "d_state": ds,
               "bound_ms": b_ms, "bound_by": b_by,
               "note": "plain PyTorch: the scan has no kernel"}
        _timed(row, {"ms": lambda c: mamba_lib._scan(
            c["xc"], c["delta"], c["bmat"], c["cmat"], a, c["h"])}, sets)
        row["bound_share"] = b_ms / row["ms"]
        row["device_bound_share"] = b_ms / row["device_ms"]
        emit(row)
        rows.append(row)
        del sets
    return rows


def _leaf_bytes(leaf, used):
    """Bytes of one param leaf read once; a served leaf's tables only for
    the ``used`` adapters."""
    from repro_torch.models import layers
    if isinstance(leaf, layers.MultiAdapterDelta):
        per = (leaf.bases[0].numel() + leaf.rts[0].numel() + 1) * 4
        return leaf.w.numel() * leaf.w.element_size() + used * per
    return leaf.numel() * leaf.element_size()


def phase_mla_decode_times(cfg, served, gen, card, cache_len=PROMPT + NEW):
    """One deepseek-v2-236b MLA layer's absorbed decode step
    (``attention.mla_decode``: q_a, q_b, kv_a and wo through
    ``lowrank_linear_batched`` with B rows of 8 adapters, the attention in
    the compressed space in plain PyTorch) over a cache holding PROMPT
    positions of ``cache_len`` slots, eager and from a CUDA graph, and the
    same step with the kernels' plain versions, against its bound."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    lp = model_lib._block(served["blocks"][0], 0)["attn"]
    kw = model_lib._mla_kwargs(cfg)
    h, kvl, rope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    ids = torch.arange(B, dtype=torch.int32, device="cuda") % G

    def case():
        cache = attn_lib.mla_cache_init(B, cache_len, kvl, rope,
                                        device="cuda")
        cache.ckv.copy_(torch.randn(cache.ckv.shape, generator=gen,
                                    device="cuda"))
        cache.kpe.copy_(torch.randn(cache.kpe.shape, generator=gen,
                                    device="cuda"))
        cache.pos[:, :PROMPT] = torch.arange(PROMPT, dtype=torch.int32,
                                             device="cuda")
        return dict(x=torch.randn(B, 1, cfg.d_model, generator=gen,
                                  device="cuda").to(torch.bfloat16),
                    cache=cache,
                    t=torch.tensor(PROMPT, dtype=torch.int32, device="cuda"))
    sets = [case() for _ in range(4)]

    def step(c):
        with layers.adapter_ids(ids):
            return attn_lib.mla_decode(lp, c["x"], c["cache"], c["t"], **kw)

    def plain(c):
        with ops.plain_kernels():
            return step(c)

    nbytes = (sum(_leaf_bytes(v, G) for v in lp.values())
              + 2 * B * cfg.d_model * 2
              + B * cache_len * ((kvl + rope) * 2 + 4))
    weights = [(v.w if isinstance(v, layers.MultiAdapterDelta) else v)
               for k, v in lp.items() if k != "kv_b" and v.ndim == 2]
    mm = sum(2.0 * B * w.shape[0] * w.shape[1] for w in weights)
    lora = sum(2.0 * B * R * sum(v.w.shape) for v in lp.values()
               if isinstance(v, layers.MultiAdapterDelta))
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    attn = 2.0 * B * h * (nope * kvl + cache_len * (2 * kvl + rope)
                          + kvl * vd)
    b_ms, b_by = _bound(nbytes, [(mm, PEAK_BF16), (lora + attn, PEAK_FP32)])
    row = {"phase": "mla_decode_times", "card": card, "arch": cfg.name,
           "B": B, "cache_slots": cache_len, "filled": PROMPT,
           "adapters": G, "rank": R, "bound_ms": b_ms, "bound_by": b_by,
           "library": "no single call"}
    _timed(row, {"ms": step, "plain_ms": plain}, sets)
    row["bound_share"] = b_ms / row["ms"]
    row["device_bound_share"] = b_ms / row["device_ms"]
    emit(row)
    del sets
    return row


def _scan_case(gen, b, l, dtype=torch.bfloat16, w_dtype=torch.float32,
               s0=True, h=RWKV_H, d=RWKV_D):
    """WKV inputs on the card: r, k, v ~ N(0, 0.5²), w = exp(-exp(N(-2,
    1.5²))) (decays from ~0.4 to ~0.999, as the model's), u ~ N(0, 0.3²),
    s0 ~ N(0, 0.5²) or None."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    r, k, v = (0.5 * rnd(b, l, h, d) for _ in range(3))
    w = torch.exp(-torch.exp(-2.0 + 1.5 * rnd(b, l, h, d)))
    return dict(r=r.to(dtype), k=k.to(dtype), v=v.to(dtype),
                w=w.to(w_dtype), u=0.3 * rnd(h, d),
                s0=0.5 * rnd(b, h, d, d) if s0 else None)


def scan_bound(c, extra_bytes=0):
    """(ms, 'bytes'|'operations') of one rwkv6_scan call: r, k, v, w and
    s0 read once, y and s_final written once (and ``extra_bytes``, the
    checkpoint mode's states); 4 D² fp32 operations per step per (b, h) —
    y_j = Σ_i r_i S_ij + v_j Σ_i r_i u_i k_i and S_ij ← w_i S_ij + k_i v_j,
    one multiply-add each."""
    r = c["r"]
    b, l, h, d = r.shape
    nbytes = (4 * r.numel() * r.element_size()        # r, k, v in; y out
              + c["w"].numel() * c["w"].element_size()
              + c["u"].numel() * 4
              + (2 if c["s0"] is not None else 1) * b * h * d * d * 4
              + extra_bytes)
    return _bound(nbytes, [(4.0 * b * l * h * d * d, PEAK_FP32)])


def _scan_module():
    """The kernel module (the package attribute of its name is ops'
    dispatching function)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.rwkv6_scan")


def phase_rwkv_kernel_checks(gen):
    """``rwkv6_scan`` against its plain version at every shape the RWKV
    serving path launches — SlotServer's admission prefill (1, 128) and
    (1, 100), generate's prefill (8, 128), decode (8, 1); bf16 r/k/v, fp32
    w, s0 given, chunk 128 — and the training forward (4, 128), plus fp32
    r/k/v, bf16 w, no s0, D = 40,
    several chunks with a ragged tail and a small chunk, and the plan's
    edges: D = 17 and 33 (not a multiple of a lane's rows, rows copied
    element by element), L = 0 (S_final = s0), L = 129 with chunk 64 (the
    second slot refilled), (8, 300) (16 rows a lane over several chunks),
    and (2, 300) with fp32 r/k/v and fp32 or bf16 w (two slots cut short
    to fit in shared memory). Each case runs in both modes, and must agree
    within the tolerance and bit for bit; the checkpoint mode's states
    must also be the plain version's (``every`` = CKPT_EVERY) bit for bit.
    Returns the worst error and the keys checked."""
    from repro_torch.kernels import ref
    scan_mod = _scan_module()
    scan_kernel = scan_mod.rwkv6_scan
    path = [dict(b=1, l=PROMPT), dict(b=1, l=100), dict(b=B, l=PROMPT),
            dict(b=B, l=1), dict(b=TRAIN_B, l=TRAIN_L)]
    extra = [dict(b=2, l=PROMPT, dtype=torch.float32),
             dict(b=2, l=37, w_dtype=torch.bfloat16),
             dict(b=2, l=1, s0=False),
             dict(b=2, l=50, d=40),
             dict(b=1, l=300),
             dict(b=2, l=100, chunk=16)]
    edges = [dict(b=2, l=50, d=17), dict(b=2, l=50, d=33),
             dict(b=2, l=0), dict(b=2, l=129, chunk=64),
             dict(b=B, l=300),
             dict(b=2, l=300, dtype=torch.float32),
             dict(b=2, l=300, dtype=torch.float32, w_dtype=torch.bfloat16)]
    worst, checked = 0.0, set()
    for spec in path + extra + edges:
        spec = dict(spec)
        chunk = spec.pop("chunk", 128)
        c = _scan_case(gen, **spec)
        args = (c["r"], c["k"], c["v"], c["w"], c["u"], c["s0"])
        y, s_fin = scan_kernel(*args, chunk=chunk)
        y_c, s_c, ck = scan_kernel(*args, chunk=chunk, checkpoints=True)
        torch.cuda.synchronize()
        y_p, s_p, ck_p = ref.rwkv6_scan_ref(*args,
                                            every=scan_mod.CKPT_EVERY)
        check(y.dtype == y_p.dtype and y.shape == y_p.shape and
              s_fin.dtype == s_p.dtype == torch.float32,
              f"rwkv6_scan output {y.dtype}{tuple(y.shape)} vs plain "
              f"{y_p.dtype}{tuple(y_p.shape)}")
        if y.numel() == 0:
            check(torch.equal(s_fin, c["s0"]), "rwkv6_scan with L = 0 does "
                  "not return s0 as the final state")
        y_scale = y_p.float().abs().max().item() if y.numel() else 0.0
        s_scale = s_p.abs().max().item()
        err_y = ((y.float() - y_p.float()).abs().max().item()
                 if y.numel() else 0.0)
        err_s = (s_fin - s_p).abs().max().item()
        tol_y = (SCAN_TOL * y_scale if y.dtype == torch.float32
                 else bf16_ulp(y_scale))
        tol_s = SCAN_TOL * s_scale
        bit = torch.equal(y, y_p) and torch.equal(s_fin, s_p)
        ckpt_bit = (torch.equal(y_c, y_p) and torch.equal(s_c, s_p)
                    and torch.equal(ck, ck_p))
        b_, l_, h_, d_ = c["r"].shape
        plan = scan_mod.plan(b_, l_, h_, d_, chunk,
                             scan_mod._sm_count(c["r"].device),
                             c["r"].element_size(), c["w"].element_size())
        emit({"phase": "rwkv_kernel_check", "kernel": "rwkv6_scan",
              "r": list(c["r"].shape), "dtype": str(y.dtype).split(".")[1],
              "w_dtype": str(c["w"].dtype).split(".")[1],
              "s0": c["s0"] is not None, "chunk": chunk,
              "plan": plan._asdict(), "bit_identical": bit,
              "checkpoint_mode_bit_identical": ckpt_bit,
              "checkpoints": list(ck.shape),
              "max_abs_err_y": err_y, "y_scale": y_scale, "tol_y": tol_y,
              "max_abs_err_s": err_s, "s_scale": s_scale, "tol_s": tol_s})
        check(err_y <= tol_y and err_s <= tol_s,
              f"rwkv6_scan disagrees at r {tuple(c['r'].shape)} "
              f"{y.dtype}: y {err_y} > {tol_y} or s {err_s} > {tol_s}")
        check(bit, f"rwkv6_scan is not bit-identical to its plain version "
                   f"at r {tuple(c['r'].shape)} {y.dtype}, chunk {chunk}")
        check(ckpt_bit, f"rwkv6_scan's checkpoint mode is not bit-identical "
              f"to its plain version at r {tuple(c['r'].shape)} {y.dtype}, "
              f"chunk {chunk}")
        worst = max(worst, err_y, err_s)
        checked.add(_scan_key(*args, chunk=chunk))
        checked.add(_scan_key(*args, chunk=chunk, checkpoints=True))
    return worst, checked


def phase_rwkv_times(gen, card):
    """``rwkv6_scan`` and its plain version at the serving path's prefill
    and decode shapes, eager and from a CUDA graph, against the bound."""
    from repro_torch.kernels import ref
    scan_mod = _scan_module()
    scan_kernel = scan_mod.rwkv6_scan
    rows = []
    for label, b, l in (("admission prefill", 1, PROMPT),
                        ("ragged admission prefill", 1, 100),
                        ("generate prefill", B, PROMPT), ("decode", B, 1)):
        sets = [_scan_case(gen, b, l) for _ in range(4)]
        b_ms, b_by = scan_bound(sets[0])
        plan = scan_mod.plan(b, l, RWKV_H, RWKV_D, 128,
                             scan_mod._sm_count(sets[0]["r"].device),
                             sets[0]["r"].element_size(),
                             sets[0]["w"].element_size())
        row = {"phase": "rwkv_times", "kernel": "rwkv6_scan", "card": card,
               "shape": label, "B": b, "L": l, "H": RWKV_H, "D": RWKV_D,
               "rows": plan.rows, "group": plan.group,
               "blocks": plan.blocks, "bound_ms": b_ms, "bound_by": b_by,
               "library": "no single call"}

        def args(c):
            return (c["r"], c["k"], c["v"], c["w"], c["u"], c["s0"])

        rows.append(_timed(row, {
            "ms": lambda c: scan_kernel(*args(c)),
            "plain_ms": lambda c: ref.rwkv6_scan_ref(*args(c)),
            "library_ms": None}, sets))
        row["bound_share"] = b_ms / row["ms"]
        row["device_bound_share"] = b_ms / row["device_ms"]
        emit(row)
        del sets
    return rows


def _bwd_case(gen, b, l, dtype=torch.bfloat16, w_dtype=torch.float32,
              s0=True, ds=False, h=RWKV_H, d=RWKV_D):
    """A forward case of ``_scan_case`` with the backward's cotangents: dy
    ~ N(0, 1) in r's dtype and ds_final ~ N(0, 1) fp32 or None."""
    c = _scan_case(gen, b, l, dtype, w_dtype, s0, h, d)
    c["dy"] = torch.randn(b, l, h, d, generator=gen, device="cuda").to(dtype)
    c["ds"] = (torch.randn(b, h, d, d, generator=gen, device="cuda")
               if ds else None)
    return c


def _bwd_planted(c, fault):
    """The plain backward with a planted fault: ``no_u`` drops the bonus u
    (from dkv and dr); ``dw_after`` takes dw_t against S_t, the state after
    step t, instead of S_{t-1}."""
    from repro_torch.kernels import ref
    args = (c["r"], c["k"], c["v"], c["w"])
    if fault == "no_u":
        return ref.rwkv6_scan_bwd_ref(*args, torch.zeros_like(c["u"]),
                                      c["s0"], c["dy"], c["ds"])
    out = list(ref.rwkv6_scan_bwd_ref(*args, c["u"], c["s0"], c["dy"],
                                      c["ds"]))
    r, k, v, w = (x.float() for x in args)
    b, l, h, d = r.shape
    s = (torch.zeros((b, h, d, d), device="cuda") if c["s0"] is None
         else c["s0"].float())
    after = []
    for t in range(l):
        s = w[:, t, ..., None] * s + k[:, t, ..., None] * v[:, t, :, None, :]
        after.append(s)
    g = (torch.zeros_like(s) if c["ds"] is None else c["ds"].float())
    dw = [None] * l
    for t in reversed(range(l)):
        dw[t] = (g * after[t]).sum(-1)
        g = w[:, t, ..., None] * g + \
            r[:, t, ..., None] * c["dy"][:, t].float()[..., None, :]
    out[3] = torch.stack(dw, dim=1).to(c["w"].dtype)
    return tuple(out)


_BWD_OUTS = ("dr", "dk", "dv", "dw", "du", "ds0")


def _bwd_readings(got, want):
    """Per output: (max |got - want| / max |want|, its tolerance: SCAN_TOL
    for fp32, one bf16 ulp of the scale, relative, for bf16)."""
    out = {}
    for name, a, b in zip(_BWD_OUTS, got, want):
        scale = b.float().abs().max().item() if b.numel() else 0.0
        err = (a.float() - b.float()).abs().max().item() if b.numel() else 0.0
        tol = (SCAN_TOL if b.dtype == torch.float32
               else bf16_ulp(max(scale, 1e-30)) / max(scale, 1e-30))
        out[name] = (err / max(scale, 1e-30), tol)
    return out


def phase_rwkv_bwd_kernel_checks(gen):
    """``rwkv6_scan_bwd`` against ``ref.rwkv6_scan_bwd_ref`` on the card,
    its checkpoints from the forward's checkpoint mode: at the training
    path's shape (4, 128) (bf16 r/k/v, fp32 w, s0 given, no ds_final) and
    at the edges — L = 1, L = 13 and 67 (not a multiple of CKPT_EVERY),
    300 (the forward's slots cut in the checkpoint mode), L = 129 with
    chunk 64, L = 0, D = 17 and 40, fp32 r/k/v, bf16 w, s0 None, ds_final
    given, 8 rows (the forward's 16 rows a lane); and the edges of the
    kernel's pipeline — (8, 300), two waves of blocks; L = 9, a last chunk
    of one step; D = 17 (fp32, L = 9) and 40 (8 rows, L = 23), whole warps
    of rows past D. Gated bit for bit, each
    output's relative reading reported beside its tolerance. Then two
    planted faults at the training shape must read above those
    tolerances. Returns the worst absolute error and the keys checked."""
    from repro_torch.kernels import ref
    scan_mod = _scan_module()
    fwd, bwd = scan_mod.rwkv6_scan, scan_mod.rwkv6_scan_bwd
    cases = [dict(b=TRAIN_B, l=TRAIN_L),
             dict(b=2, l=1), dict(b=2, l=13, ds=True), dict(b=2, l=67),
             dict(b=1, l=300, ds=True), dict(b=2, l=129, chunk=64),
             dict(b=2, l=0, ds=True), dict(b=2, l=50, d=17),
             dict(b=2, l=37, d=40, s0=False, ds=True),
             dict(b=2, l=67, dtype=torch.float32),
             dict(b=2, l=67, w_dtype=torch.bfloat16),
             dict(b=2, l=300, dtype=torch.float32, w_dtype=torch.bfloat16),
             dict(b=2, l=20, s0=False), dict(b=B, l=40, ds=True),
             dict(b=TRAIN_B, l=TRAIN_L, w_dtype=torch.bfloat16),
             dict(b=8, l=300), dict(b=2, l=9, ds=True),
             dict(b=2, l=9, d=17, s0=False, dtype=torch.float32),
             dict(b=8, l=23, d=40, w_dtype=torch.bfloat16, ds=True)]
    worst, checked, path_case = 0.0, set(), None
    for spec in cases:
        spec = dict(spec)
        chunk = spec.pop("chunk", 128)
        c = _bwd_case(gen, **spec)
        a = (c["r"], c["k"], c["v"], c["w"], c["u"])
        _, _, ck = fwd(*a, c["s0"], chunk=chunk, checkpoints=True)
        got = bwd(*a, ck, c["dy"], c["ds"])
        torch.cuda.synchronize()
        want = ref.rwkv6_scan_bwd_ref(*a, c["s0"], c["dy"], c["ds"])
        bits = [torch.equal(x, y) for x, y in zip(got, want)]
        shapes = all(x.dtype == y.dtype and x.shape == y.shape
                     for x, y in zip(got, want))
        readings = _bwd_readings(got, want)
        err = max(((x.float() - y.float()).abs().max().item()
                   if y.numel() else 0.0) for x, y in zip(got, want))
        emit({"phase": "rwkv_bwd_kernel_check", "kernel": "rwkv6_scan_bwd",
              "r": list(c["r"].shape), "dtype": str(c["r"].dtype)[6:],
              "w_dtype": str(c["w"].dtype)[6:], "s0": c["s0"] is not None,
              "ds_final": c["ds"] is not None, "chunk": chunk,
              "checkpoints": list(ck.shape),
              "bit_identical": dict(zip(_BWD_OUTS, bits)),
              "rel_and_tol": readings, "max_abs_err": err})
        check(shapes and all(bits), f"rwkv6_scan_bwd is not bit-identical to "
              f"its plain version at r {tuple(c['r'].shape)} "
              f"{c['r'].dtype} w {c['w'].dtype}: {readings}")
        worst = max(worst, err)
        checked.add(_scan_bwd_key(*a, ck, c["dy"], c["ds"]))
        if path_case is None:
            path_case = (c, got)
    c, got = path_case
    faults = {f: max(e / tol for e, tol in _bwd_readings(
        got, _bwd_planted(c, f)).values()) for f in ("dw_after", "no_u")}
    emit({"phase": "rwkv_bwd_kernel_check", "kernel": "rwkv6_scan_bwd",
          "planted_faults_over_tol": faults,
          "at": list(c["r"].shape)})
    check(min(faults.values()) > 1.0, f"a planted fault in the plain "
          f"backward reads {faults} of its tolerance, not above it: the "
          "check cannot see it")
    return worst, checked


def phase_rwkv_bwd_times(gen, card):
    """The training layer's WKV calls at (4, 128, 32, 64) — the forward in
    both modes and the backward — eager and from a CUDA graph, against
    their bounds and the plain versions (the plain backward timed over
    fewer calls: one takes ~0.15 s)."""
    from repro_torch.kernels import ref
    scan_mod = _scan_module()
    sets = [_bwd_case(gen, TRAIN_B, TRAIN_L) for _ in range(2)]
    for c in sets:
        c["ck"] = scan_mod.rwkv6_scan(c["r"], c["k"], c["v"], c["w"],
                                      c["u"], c["s0"], checkpoints=True)[2]
    c0 = sets[0]
    ck_bytes = c0["ck"].numel() * 4
    b, l, h, d = c0["r"].shape
    rows = []

    def fwd_args(c):
        return (c["r"], c["k"], c["v"], c["w"], c["u"], c["s0"])

    def bwd_args(c):
        return (c["r"], c["k"], c["v"], c["w"], c["u"])

    for mode, ckpt in (("serving", False), ("checkpoint", True)):
        fwd_ms, fwd_by = scan_bound(c0, ck_bytes if ckpt else 0)
        row = {"phase": "rwkv_bwd_times", "kernel": "rwkv6_scan",
               "card": card, "shape": f"training forward, {mode} mode",
               "B": b, "L": l, "H": h, "D": d,
               "checkpoint_bytes": ck_bytes if ckpt else 0,
               "bound_ms": fwd_ms, "bound_by": fwd_by,
               "library": "no single call"}
        _timed(row, {
            "ms": lambda c, _k=ckpt: scan_mod.rwkv6_scan(
                *fwd_args(c), checkpoints=_k),
            "plain_ms": lambda c, _k=ckpt: ref.rwkv6_scan_ref(
                *fwd_args(c), every=scan_mod.CKPT_EVERY if _k else 0),
            "library_ms": None}, sets)
        rows.append(row)
        emit(row)
    b_ms, b_by = rwkv_bwd_bound(c0)
    row = {"phase": "rwkv_bwd_times", "kernel": "rwkv6_scan_bwd",
           "card": card, "shape": "training backward", "B": b, "L": l,
           "H": h, "D": d, "bound_ms": b_ms, "bound_by": b_by,
           "no_fma_ceiling_ms": rwkv_bwd_no_fma_ms(c0),
           "plan": scan_mod.bwd_plan(b, l, h)._asdict(),
           "checkpoint_bytes": ck_bytes,
           "checkpoint_read_ms": ck_bytes / PEAK_BYTES * 1e3,
           "library": "no single call",
           "library_ms": None, "device_library_ms": None}
    kern = lambda c: scan_mod.rwkv6_scan_bwd(   # noqa: E731
        *bwd_args(c), c["ck"], c["dy"], c["ds"])
    plain = lambda c: ref.rwkv6_scan_bwd_ref(   # noqa: E731
        *bwd_args(c), c["s0"], c["dy"], c["ds"])
    row["ms"] = time_ms(kern, sets)
    row["device_ms"] = graph_ms(kern, sets)
    row["plain_ms"] = time_ms(plain, sets, warmup=1, iters=3)
    row["device_plain_ms"] = graph_ms(plain, sets, calls=2, replays=2)
    row["bound_share"] = b_ms / row["ms"]
    row["device_bound_share"] = b_ms / row["device_ms"]
    row["device_no_fma_share"] = row["no_fma_ceiling_ms"] / row["device_ms"]
    rows.append(row)
    emit(row)
    del sets
    return rows


def rwkv_bwd_bound(c):
    """(ms, 'bytes'|'operations') of the function rwkv6_scan_bwd computes:
    r, k, v, dy, w, u and ds_final read once, dr, dk, dv, dw, du and ds0
    written once; 16 D² fp32 operations per step per (b, h) — the
    recomputed step S ← w S + k v (a multiply and a multiply-add), then A =
    r dy, dkv = G + u A, the four summed products (dr, dk, dv, dw) and G ←
    w G + A, a multiply-add counted as two. The checkpoints the kernel
    also reads are its design's own and stay out (phase_rwkv_bwd_times
    reports them beside it)."""
    r = c["r"]
    b, l, h, d = r.shape
    nbytes = (7 * r.numel() * r.element_size()   # r k v dy in; dr dk dv out
              + 2 * c["w"].numel() * c["w"].element_size()
              + 2 * c["u"].numel() * 4
              + (2 if c["ds"] is not None else 1) * b * h * d * d * 4)
    return _bound(nbytes, [(16.0 * b * l * h * d * d, PEAK_FP32)])


def rwkv_bwd_no_fma_ms(c):
    """The least ms of rwkv_bwd_bound's operations when each multiply
    and each add issues on its own, as the plain version's order needs (no
    fused multiply-adds): half the fp32 rate."""
    b, l, h, d = c["r"].shape
    return 16.0 * b * l * h * d * d / (PEAK_FP32 / 2) * 1e3


def phase_times(gen, card, shapes=SHAPES, arch="qwen1.5-0.5b"):
    """Kernel, plain version and torch.matmul of the base product alone at
    decode (B=8, t=1) and prefill (B=8, t=128) for each projection shape
    of ``arch``."""
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels.ref import lowrank_linear_batched_ref
    ids = list(range(B))
    rows = []
    for m, n in shapes:
        for label, t in (("decode", 1), ("prefill", PROMPT)):
            per = 2 * (m * n + B * t * (m + n)) + G * R * (m + n) * 4
            sets = [make_case(gen, m, n, t, torch.bfloat16, ids)
                    for _ in range(max(2, -(-150_000_000 // per)))]

            def kern(c):
                return ll.lowrank_linear_batched(
                    c["x"], c["w"], c["bases"], c["rts"], c["scales"],
                    c["ids"], side=c["side"])

            def plain(c):
                return lowrank_linear_batched_ref(
                    c["x"], c["w"], c["bases"], c["rts"], c["scales"],
                    c["ids"], side=c["side"])

            def library(c):
                return torch.matmul(c["x"], c["w"])

            b_ms, b_by = bound(sets[0])
            before = dict(ll.lowrank_linear_batched.routes)
            kern(sets[0])
            row = {"phase": "times", "card": card, "arch": arch, "m": m,
                   "n": n, "shape": label, "B": B, "t": t,
                   "route": _route_taken(ll.lowrank_linear_batched, before),
                   "library": "torch.matmul(x, W), base product only",
                   "bound_ms": b_ms, "bound_by": b_by}
            for key, fn in (("ms", kern), ("plain_ms", plain),
                            ("library_ms", library)):
                row[key] = time_ms(fn, sets)
                row["device_" + key] = graph_ms(fn, sets)
            row["bound_share"] = b_ms / row["ms"]
            row["device_bound_share"] = b_ms / row["device_ms"]
            emit(row)
            rows.append(row)
            del sets
    return rows


# ------------------------------------------------- flash attention --

def _flash_case(gen, b, lq, h, hkv, d, lk=None, dtype=torch.bfloat16,
                strided=False, misaligned=False):
    """q (b, lq, h, d), k and v (b, lk, hkv, d) ~ N(0, 1) on the card (the
    scores then ~ N(0, 1) after the 1/sqrt(D) scale); ``strided`` takes q
    as every other head of a wider tensor, a non-contiguous layout;
    ``misaligned`` q as a view 2 bytes past a 16-byte boundary."""
    lk = lq if lk is None else lk

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q = rnd(b, lq, 2 * h, d)[:, :, ::2] if strided else rnd(b, lq, h, d)
    if misaligned:
        q = _misaligned(q)
    return dict(q=q, k=rnd(b, lk, hkv, d), v=rnd(b, lk, hkv, d))


def flash_pairs(lq, lk, causal=True, window=0):
    """(query, key) pairs one head attends, counted exactly: query i at
    position lk - lq + i sees keys max(0, p - window + 1) .. p."""
    if not causal:
        return lq * lk
    pos = np.arange(lq, dtype=np.int64) + (lk - lq)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return int(np.clip(pos - lo + 1, 0, None).sum())


def flash_bound(c, causal=True, window=0):
    """(ms, 'bytes'|'operations') of one flash_attention call: q, k, v read
    once and o written once; 4 D operations per attended pair and q head
    (QK and PV, a multiply-add each) at the inputs' tensor-core peak."""
    q, k = c["q"], c["k"]
    b, lq, h, d = q.shape
    esz = q.element_size()
    nbytes = esz * (2 * q.numel() + 2 * k.numel())
    ops = 4.0 * b * h * d * flash_pairs(lq, k.shape[1], causal, window)
    return _bound(nbytes, [(ops, PEAK_BF16 if q.dtype == torch.bfloat16
                            else PEAK_FP32)])


# (label, B, Lq, Lk, H, Hkv, D, window) of every call the paths make
FLASH_PATH = [
    ("qwen admission prefill", 1, PROMPT, PROMPT, 16, 16, 64, 0),
    ("qwen generate prefill", B, PROMPT, PROMPT, 16, 16, 64, 0),
    ("starcoder2 admission prefill", 1, PROMPT, PROMPT, SC_H, SC_KV, SC_D,
     SC_WINDOW),
    ("starcoder2 ragged admission prefill", 1, 100, 100, SC_H, SC_KV, SC_D,
     SC_WINDOW),
    ("starcoder2 generate prefill", B, PROMPT, PROMPT, SC_H, SC_KV, SC_D,
     SC_WINDOW),
    ("starcoder2 long prefill", 1, LONG_PROMPT, LONG_PROMPT, SC_H, SC_KV,
     SC_D, SC_WINDOW),
    ("granite admission prefill", 1, PROMPT, PROMPT, 16, 8, 64, 0),
    ("granite generate prefill", B, PROMPT, PROMPT, 16, 8, 64, 0),
    ("mistral-nemo admission prefill", 1, PROMPT, PROMPT, 32, 8, 128, 0),
    ("mistral-nemo generate prefill", B, PROMPT, PROMPT, 32, 8, 128, 0),
    ("jamba admission prefill", 1, PROMPT, PROMPT, JAMBA_H, JAMBA_KV,
     JAMBA_D, 0),
    ("jamba generate prefill", B, PROMPT, PROMPT, JAMBA_H, JAMBA_KV,
     JAMBA_D, 0),
    ("roberta evaluation forward", 128, 64, 64, 12, 12, 64, 0),
    ("vit evaluation forward", 32, 200, 200, 12, 12, 64, 0),
]


def _flash_module():
    """The kernel module (the package attribute of its name is ops'
    dispatching function)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.flash_attention")


def phase_flash_kernel_checks(gen):
    """``flash_attention`` against its plain version at every shape the
    dense prefill paths launch, plus the edges: Lq < Lk (suffix-aligned),
    Lq > Lk (queries that see no key), windows inside a key tile, fp32 at
    both head sizes, ``causal=False``, a strided q; for the tc route Lk
    not a multiple of its 128-key tile, Lq of 1, 63, 64 and 65, windows of
    1, 127 and 129, D 64 and 128 on both query tiles (64 and 128 rows);
    fp32 and a misaligned q view on the simt route. Each case states its
    route and fails on another. Returns the worst error and the keys
    checked."""
    from repro_torch.kernels import ref
    fa = _flash_module()
    fk = fa.flash_attention
    cases = [dict(b=b, lq=lq, lk=lk, h=h, hkv=hkv, d=d, window=w)
             for _, b, lq, lk, h, hkv, d, w in FLASH_PATH]
    cases += [dict(b=2, lq=100, lk=300, h=SC_H, hkv=SC_KV, d=128, window=128),
              dict(b=2, lq=150, lk=70, h=8, hkv=2, d=64, window=0),
              dict(b=1, lq=150, lk=70, h=SC_H, hkv=SC_KV, d=128, window=40),
              dict(b=2, lq=200, lk=200, h=SC_H, hkv=SC_KV, d=128, window=20),
              dict(b=2, lq=130, lk=130, h=SC_H, hkv=SC_KV, d=128, window=64,
                   dtype=torch.float32),
              dict(b=2, lq=77, lk=77, h=16, hkv=16, d=64,
                   dtype=torch.float32),
              dict(b=2, lq=90, lk=200, h=SC_H, hkv=SC_KV, d=128,
                   causal=False),
              dict(b=2, lq=128, lk=128, h=SC_H, hkv=SC_KV, d=128,
                   window=4096, strided=True),
              # tc edges
              dict(b=1, lq=1, lk=300, h=8, hkv=2, d=128),
              dict(b=1, lq=63, lk=63, h=8, hkv=2, d=64),
              dict(b=1, lq=64, lk=200, h=8, hkv=2, d=128, window=64),
              dict(b=1, lq=65, lk=65, h=8, hkv=2, d=128, window=1),
              dict(b=2, lq=300, lk=300, h=8, hkv=2, d=128, window=127),
              dict(b=2, lq=300, lk=300, h=8, hkv=2, d=64, window=129),
              dict(b=4, lq=300, lk=300, h=16, hkv=16, d=64, window=129),
              dict(b=1, lq=1000, lk=1000, h=SC_H, hkv=SC_KV, d=128,
                   window=300),
              dict(b=1, lq=1000, lk=1100, h=SC_H, hkv=SC_KV, d=128,
                   window=129),
              dict(b=2, lq=128, lk=128, h=SC_H, hkv=SC_KV, d=128,
                   window=4096, misaligned=True)]
    worst, checked = 0.0, set()
    for spec in cases:
        spec = dict(spec)
        causal = spec.pop("causal", True)
        window = spec.pop("window", 0)
        c = _flash_case(gen, **spec)
        args = (c["q"], c["k"], c["v"])
        stated = ("simt" if spec.get("dtype", torch.bfloat16) != torch.bfloat16
                  or spec.get("misaligned") else "tc")
        before = dict(fk.routes)
        o = fk(*args, causal=causal, window=window)
        torch.cuda.synchronize()
        took = _route_taken(fk, before)
        want = ref.flash_attention_ref(*args, causal=causal, window=window)
        check(o.dtype == want.dtype and o.shape == want.shape,
              f"flash_attention output {o.dtype}{tuple(o.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        err = (o.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = (FLASH_TOL * scale if o.dtype == torch.float32
               else bf16_ulp(scale))
        p = fa.plan(took, c["q"].shape[0], c["q"].shape[1], c["q"].shape[2],
                    fa._sm_count(c["q"].device))
        emit({"phase": "flash_kernel_check", "kernel": "flash_attention",
              "q": list(c["q"].shape), "k": list(c["k"].shape),
              "dtype": str(o.dtype).split(".")[1], "causal": causal,
              "window": window, "q_contiguous": c["q"].is_contiguous(),
              "misaligned_q": bool(spec.get("misaligned")), "route": took,
              "bq": p.bq, "max_abs_err": err, "out_scale": scale,
              "tol": tol})
        check(took == stated, f"flash_attention took route {took} at q "
              f"{tuple(c['q'].shape)} {o.dtype}, stated {stated}")
        check(bool(torch.isfinite(o).all()) and err <= tol,
              f"flash_attention disagrees at q {tuple(c['q'].shape)} k "
              f"{tuple(c['k'].shape)} {o.dtype} causal={causal} "
              f"window={window} ({took}): {err} > {tol}")
        worst = max(worst, err)
        checked.add(_flash_key(*args, causal=causal, window=window))
        del c, args, o, want
    return worst, checked


def phase_long_prefill(seed, card, checked):
    """starcoder2-7b on its base weights: ``generate`` with one prompt of
    LONG_PROMPT tokens (twice the window), ``cache_len`` LONG_PROMPT + 8
    and LONG_NEW new tokens, counted; then the same with ``cache_len`` the
    4096-slot window, the ring layout the reference prescribes for a
    sliding-window arch, counted on its own: its greedy tokens must be
    those of the full cache. Then the prefill and decode of both layouts
    timed on their own (fenced host clock), and the ring's logit gap to
    the full cache reported."""
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    arch = "starcoder2-7b"
    cfg = _full_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()      # the run's own peak
    rng = np.random.default_rng(seed + 7)
    prompt = rng.integers(0, cfg.vocab_size, (1, LONG_PROMPT),
                          dtype=np.int32)
    cache, ring = LONG_PROMPT + 8, cfg.sliding_window
    outs, counts = {}, {}
    for slots in (cache, ring):
        _zero_counts()
        with ShapeLog(SERVE_LOG) as log:
            outs[slots] = serve.generate(params, cfg, prompt, LONG_NEW,
                                         slots)
            torch.cuda.synchronize()
        counts[slots] = (_launch_counts(), _route_counts())
        _check_shapes(arch, log.seen, checked)
        _check_launches(arch, counts[slots][0],
                        {"flash_attention": cfg.n_layers})
        _check_tc_routes(f"{arch} long prefill, {slots} slots",
                         *counts[slots])
    out = outs[cache]
    launches, routes = counts[cache]
    check(tuple(out.shape) == (1, LONG_PROMPT + LONG_NEW) and
          bool((out[0, :LONG_PROMPT].cpu() == torch.from_numpy(prompt[0]))
               .all()) and
          bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "long-prefill generate output has the wrong shape, prompt or range")
    check(torch.equal(outs[ring], out), f"the {ring}-slot ring cache gives "
          f"other greedy tokens than the {cache}-slot cache: "
          f"{outs[ring][0, LONG_PROMPT:].tolist()} vs "
          f"{out[0, LONG_PROMPT:].tolist()}")

    @torch.inference_mode()
    def timed(slots):
        toks = torch.as_tensor(prompt, device="cuda")
        feed = out[:, LONG_PROMPT:].to(torch.int32)   # the same tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = model_lib.init_decode_state(cfg, 1, slots, device="cuda")
        logits, st = model_lib.prefill(params, cfg, toks, st)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        seen = [logits.float()]
        for i in range(LONG_NEW - 1):
            logits, st = model_lib.decode_step(params, cfg, feed[:, i], st)
            seen.append(logits.float())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(bool(torch.isfinite(logits).all()), "long-prefill logits "
              "not finite")
        return t1 - t0, t2 - t1, torch.stack(seen)

    pf, dc, full_logits = timed(cache)
    ring_pf, ring_dc, ring_logits = timed(ring)
    gap = ((ring_logits - full_logits).abs().max()
           / full_logits.abs().max()).item()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "long_prefill_starcoder", "arch": arch, "card": card,
          "prompt": LONG_PROMPT, "window": cfg.sliding_window,
          "cache_len": cache, "new_tokens": LONG_NEW, "adapters": 0,
          "prefill_s": pf, "prefill_tok_s": LONG_PROMPT / pf,
          "decode_s": dc, "decode_tok_s": (LONG_NEW - 1) / dc,
          "ring_cache_len": ring, "ring_prefill_s": ring_pf,
          "ring_decode_tok_s": (LONG_NEW - 1) / ring_dc,
          "ring_logit_gap_rel": gap,
          "launches": launches, "routes": routes,
          "ring_launches": counts[ring][0], "ring_routes": counts[ring][1],
          "peak_gib": peak, "setup_peak_gib": setup_peak,
          "resident_gib": torch.cuda.memory_allocated() / 2 ** 30,
          "kernel_shapes": {k: sorted(v) for k, v in log.seen.items()}})
    return cfg, params, launches, routes


def phase_flash_times(gen, card):
    """``flash_attention``, its plain version and the yardstick
    ``scaled_dot_product_attention`` (timed only, never called by the
    port) at every path shape, eager and from a CUDA graph, against the
    bound. The yardstick takes (B, H, L, D) views, ``is_causal`` and
    ``enable_gqa``; where the window cuts (L > window) a boolean mask in
    place of ``is_causal``."""
    from repro_torch.kernels import ref
    fa = _flash_module()
    fk = fa.flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for label, b, lq, lk, h, hkv, d, window in FLASH_PATH:
        per = 2 * (2 * b * lq * h * d + 2 * b * lk * hkv * d)
        sets = [_flash_case(gen, b, lq, h, hkv, d, lk)
                for _ in range(max(2, -(-150_000_000 // per)))]
        mask = None
        if window and lq > window:
            pos = torch.arange(lq, device="cuda")
            diff = pos[:, None] - pos[None, :]
            mask = (diff >= 0) & (diff < window)
        b_ms, b_by = flash_bound(sets[0], True, window)
        c0 = sets[0]
        which = fa.route(c0["q"], c0["k"], c0["v"], True, window)
        row = {"phase": "flash_times", "kernel": "flash_attention",
               "card": card, "shape": label, "route": which,
               "bq": fa.plan(which, b, lq, h, fa._sm_count(c0["q"].device)).bq,
               "q": [b, lq, h, d],
               "k": [b, lk, hkv, d], "window": window,
               "pairs_per_head": flash_pairs(lq, lk, True, window),
               "bound_ms": b_ms, "bound_by": b_by,
               "library": "torch.nn.functional.scaled_dot_product_attention"
                          "(enable_gqa=True, " + ("boolean window mask)"
                                                  if mask is not None
                                                  else "is_causal=True)")}

        def lib(c, mask=mask):
            q, k, v = (c[n].transpose(1, 2) for n in ("q", "k", "v"))
            if mask is None:
                return sdpa(q, k, v, is_causal=True, enable_gqa=True)
            return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)

        long_ = lq * lk > 1 << 24
        _timed(row, {
            "ms": lambda c, w=window: fk(c["q"], c["k"], c["v"], causal=True,
                                         window=w),
            "plain_ms": lambda c, w=window: ref.flash_attention_ref(
                c["q"], c["k"], c["v"], causal=True, window=w),
            "library_ms": lib}, sets,
            **(dict(warmup=1, iters=3, calls=2, replays=2) if long_ else {}))
        row["bound_share"] = b_ms / row["ms"]
        row["device_bound_share"] = b_ms / row["device_ms"]
        emit(row)
        rows.append(row)
        del sets, mask
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------ training path --

TRAIN_SHAPES = {(1024, 1024): 4, (1024, 2816): 2, (2816, 1024): 1}   # per layer


def _lowrank_key(x, w, basis, rt, scale, **kw):
    return (tuple(x.shape), tuple(w.shape), str(x.dtype), str(w.dtype))


def _precond_key(g, basis, m, v, count, **kw):
    """(g, basis shapes, project_back, g's dtype, the route plan() gives)
    of one galore_precond_step call as ``ops`` receives it."""
    from repro_torch.kernels import galore_adamw as ga
    pb = bool(kw.get("project_back", True))
    side = kw.get("side") or ga.infer_side(g.shape, basis.shape, m.shape)
    mm, nn = g.shape[-2:]
    route = ga.plan(side, mm, nn, basis.shape[-1], g.dtype,
                    ga.PRECOND_U if pb else ga.PRECOND_UT,
                    batch=g.numel() // (mm * nn),
                    aligned=g.data_ptr() % 16 == 0).route
    return (tuple(g.shape), tuple(basis.shape), pb,
            str(g.dtype).split(".")[1], route)


def _eigh_key(a, **kw):
    return tuple(a.shape)


TRAIN_LOG = {"_ll": {"lowrank_linear": _lowrank_key},
             "_galore": {"galore_precond_step": _precond_key},
             "_eigh": {"jacobi_eigh": _eigh_key}}


def _rel(got, want):
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-30))


def _lowrank_case(gen, shape_x, m, n, dtype):
    side = "right" if m >= n else "left"
    x = torch.randn(shape_x + (m,), generator=gen, device="cuda").to(dtype)
    w = (0.02 * torch.randn(m, n, generator=gen, device="cuda")).to(dtype)
    dim = n if side == "right" else m
    basis = torch.linalg.qr(torch.randn(dim, TRAIN_R, generator=gen,
                                        device="cuda"))[0].contiguous()
    rt = 0.01 * torch.randn(*((m, TRAIN_R) if side == "right"
                              else (TRAIN_R, n)), generator=gen,
                            device="cuda")
    scale = torch.tensor(0.999, device="cuda")
    return dict(x=x, w=w, basis=basis, rt=rt, scale=scale, side=side)


def _precond_case(gen, lead, mm, nn, r=TRAIN_R, dtype=torch.float32):
    """A GaLore step's operands, g in ``dtype`` (bf16 values drawn once)."""
    side = "right" if mm >= nn else "left"
    dim = nn if side == "right" else mm
    g = (1e-3 * torch.randn(lead + (mm, nn), generator=gen,
                            device="cuda")).to(dtype)
    basis = torch.linalg.qr(torch.randn(lead + (dim, r), generator=gen,
                                        device="cuda"))[0].contiguous()
    msh = lead + ((mm, r) if side == "right" else (r, nn))
    m = 1e-3 * torch.randn(msh, generator=gen, device="cuda")
    v = 1e-6 * torch.rand(msh, generator=gen, device="cuda")
    return dict(g=g, basis=basis, m=m, v=v, side=side)


def _galore_check_run(ga, ref, c, g, w, mode, c1, c2):
    """One GaLore kernel launch on case ``c`` with ``g`` (and ``w`` in
    mode ADAMW): (outputs, route taken, plain version's outputs)."""
    fn = ga.galore_adamw_step if mode == ga.ADAMW else ga.galore_precond_step
    before = dict(fn.routes)
    if mode == ga.ADAMW:
        got = fn(w, g, c["basis"], c["m"], c["v"], 3, side=c["side"],
                 lr=1e-3, weight_decay=0.01)
        want = ref.galore_adamw_ref(w, g, c["basis"], c["m"], c["v"],
                                    c1=c1, c2=c2, side=c["side"], lr=1e-3,
                                    weight_decay=0.01)
    else:
        pb = mode == ga.PRECOND_U
        got = fn(g, c["basis"], c["m"], c["v"], 3, side=c["side"],
                 project_back=pb)
        want = ref.galore_precond_ref(g, c["basis"], c["m"], c["v"], c1=c1,
                                      c2=c2, side=c["side"],
                                      project_back=pb)
    torch.cuda.synchronize()
    return got, _route_taken(fn, before), want


def _spd_case(gen, lead, n):
    x = torch.randn(lead + (n, n + 3), generator=gen, device="cuda")
    return (x @ x.mT).contiguous()


# The GaLore checks run over GALORE_SEEDS draws (seeds base .. base + 4);
# each mode and route reports its worst reading over all of them.
GALORE_SEEDS = 5


def galore_kernel_checks(seed, out):
    """The GaLore kernel against its plain version (see below) over
    GALORE_SEEDS draws; adds each kernel's worst absolute error and the
    launch keys checked to ``out`` ({name: [err, keys]}) and emits the
    worst reading of each mode and route."""
    from repro_torch.kernels import galore_adamw as ga
    from repro_torch.kernels import ref
    # The GaLore kernel, every mode: precond with ũ out (mode 0, the
    # factored round's path: round 0's buckets (leaves, 24 layers, M, N))
    # and lifted (mode 1, the dense-client round's path at the same
    # buckets), adamw (mode 2, fp32 and bf16 w). Each case runs with an
    # fp32 g, a bf16 g, and that bf16 g's values in fp32: ũ or u, m' and
    # v' within 1e-5 of the plain version's scale (ũ or u within 1e-5 plus
    # the plain version's own distance from the float64 answer where it
    # reads above 1e-5: over rwkv6's 2048-wide buckets the plain version's
    # fp32 projection lies up to 1.70e-5 from exact and the kernel's
    # 3.03e-6, on an NVIDIA H100 80GB HBM3 at 700 W), the adamw w within
    # 1e-5 (fp32) or a bf16 ulp of its scale, and the bf16 run equal to
    # its fp32 copy bit for bit (gated: the conversion is exact and the
    # order the same). Beside the path: small
    # and odd shapes on the scalar-load form (N % 8 != 0 with bf16, N % 4
    # != 0 with fp32, both sides), M = 1, N = 1, and ranks 1, 16 and 64.
    # Each launch takes plan()'s route.
    # rwkv6-1.6b's buckets run in round 0's mode only (no eager round of
    # it runs on the card).
    path = [((4, 24), 1024, 1024), ((2, 24), 1024, 2816),
            ((1, 24), 2816, 1024)] + [
        ((k, NLU_LAYERS), mm, nn) for (mm, nn), k in NLU_SHAPES.items()]
    cases = [(lead, mm, nn, TRAIN_R, mode) for mode in (ga.PRECOND_UT,
                                                        ga.PRECOND_U)
             for lead, mm, nn in path] + \
            [(lead, mm, nn, TRAIN_R, ga.PRECOND_UT)
             for lead, mm, nn in RWKV_BUCKETS] + \
            [((1, 2), 1024, 2816, TRAIN_R, ga.PRECOND_U),
             ((3,), 37, 20, TRAIN_R, ga.PRECOND_U),
             ((3,), 37, 20, TRAIN_R, ga.PRECOND_UT),
             ((2,), 20, 37, TRAIN_R, ga.PRECOND_U),
             ((2,), 20, 37, TRAIN_R, ga.PRECOND_UT),
             ((3,), 45, 38, TRAIN_R, ga.PRECOND_U),
             ((2,), 24, 44, TRAIN_R, ga.PRECOND_U),
             ((1,), 64, 1, 1, ga.PRECOND_U),
             ((1,), 1, 64, 1, ga.PRECOND_U),
             ((3,), 37, 20, 1, ga.PRECOND_U),
             ((2,), 20, 37, 1, ga.PRECOND_UT),
             ((2,), 300, 200, 16, ga.PRECOND_U),
             ((2,), 200, 300, 16, ga.PRECOND_U),
             ((2,), 200, 96, 64, ga.PRECOND_U),
             ((2,), 96, 200, 64, ga.PRECOND_UT),
             ((24,), 2816, 1024, TRAIN_R, ga.ADAMW),
             ((24,), 1024, 2816, TRAIN_R, ga.ADAMW),
             ((3,), 37, 20, TRAIN_R, ga.ADAMW),
             ((2,), 20, 37, TRAIN_R, ga.ADAMW),
             ((3,), 45, 38, 16, ga.ADAMW)]
    c1, c2 = ga.bias_corrections(3, 0.9, 0.999)
    worst, failed = {}, []
    for k in range(GALORE_SEEDS):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + k)
        for lead, mm, nn, r, mode in cases:
            _galore_case_checks(ga, ref, gen, lead, mm, nn, r, mode, c1,
                                c2, out, worst, failed, show=k == 0)
    for (kernel, mode, route), w in sorted(worst.items()):
        emit({"phase": "train_kernel_check", "kernel": kernel,
              "mode": mode, "route": route, "seeds": GALORE_SEEDS,
              "worst_over_seeds": w, "tol_rel": 1e-5})
    check(not failed, f"the GaLore kernel disagrees with its plain version "
          f"in {len(failed)} checks: {failed[:4]}")


def _precond_ref_f64(g, basis, m, v, *, c1, c2, side, b1=0.9, b2=0.999,
                     eps=1e-8, project_back=True):
    """``ref.galore_precond_ref`` in float64: (u or ũ, m', v'), the exact
    answers both fp32 versions round."""
    from repro_torch.kernels import ref
    gd, bd = g.double(), basis.double()
    right = side == "right"
    m, v, ut = ref._adam_dir(gd @ bd if right else bd.mT @ gd, m.double(),
                             v.double(), b1=b1, b2=b2, eps=eps, c1=c1, c2=c2)
    if project_back:
        ut = ut @ bd.mT if right else bd @ ut
    return ut, m, v


def _precond_f64(g, c, mode, c1, c2):
    """The preconditioner's ũ (mode PRECOND_UT) or u of case ``c`` on
    ``g`` in float64."""
    from repro_torch.kernels import galore_adamw as ga
    return _precond_ref_f64(g, c["basis"], c["m"], c["v"], c1=c1, c2=c2,
                            side=c["side"],
                            project_back=mode == ga.PRECOND_U)[0]


@contextlib.contextmanager
def _exact_precond():
    """Every kernel's plain version, the GaLore preconditioner's computed
    in float64 and rounded once to fp32."""
    from repro_torch.kernels import ops
    orig = ops.galore_precond_ref

    def rounded(*args, **kw):
        return tuple(x.float() for x in _precond_ref_f64(*args, **kw))

    ops.galore_precond_ref = rounded
    try:
        with ops.plain_kernels():
            yield
    finally:
        ops.galore_precond_ref = orig


def _galore_case_checks(ga, ref, gen, lead, mm, nn, r, mode, c1, c2, out,
                        worst, failed, show):
    """One case of galore_kernel_checks with an fp32 g, a bf16 g and the
    bf16 g's values in fp32."""
    c32 = _precond_case(gen, lead, mm, nn, r)
    g16 = c32["g"].to(torch.bfloat16)
    kernel = ("galore_adamw_step" if mode == ga.ADAMW
              else "galore_precond_step")
    w_dtypes = ((torch.bfloat16, torch.float32) if mode == ga.ADAMW
                else (None,))
    for wdt in w_dtypes:
        w = None if wdt is None else (0.02 * torch.randn(
            lead + (mm, nn), generator=gen, device="cuda")).to(wdt)
        outs = {}
        for name, g in (("float32", c32["g"]), ("bfloat16", g16),
                        ("bfloat16_as_float32", g16.float())):
            got, route, want = _galore_check_run(ga, ref, c32, g, w, mode,
                                                 c1, c2)
            errs = [_rel(a, b) for a, b in zip(got, want)]
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            row = {"phase": "train_kernel_check", "kernel": kernel,
                   "g": list(g.shape), "g_dtype": name, "r": r,
                   "mode": mode, "side": c32["side"], "route": route,
                   "max_abs_err": err, "rel_err_u_m_v": errs,
                   "tol_rel": 1e-5}
            ok = max(errs[1:]) <= 1e-5
            reading = {"rel_w" if mode == ga.ADAMW else "rel_u": errs[0],
                       "rel_m": errs[1], "rel_v": errs[2]}
            if mode == ga.ADAMW:
                wscale = want[0].float().abs().max().item()
                tol_w = 1e-5 * wscale if wdt == torch.float32 else \
                    bf16_ulp(wscale)
                ok = ok and (got[0].float() - want[0].float()).abs() \
                    .max().item() <= tol_w
                row.update(w_dtype=str(wdt).split(".")[1], tol_w=tol_w)
            else:
                u_err = errs[0]
                if u_err > 1e-5:
                    # Past 1e-5 from the plain version, the kernel is held
                    # to 1e-5 of the exact ũ (or u) instead: where the
                    # plain version's fp32 projection is the less exact.
                    exact = _precond_f64(g, c32, mode, c1, c2)
                    reading["plain_vs_f64"] = _rel(want[0], exact)
                    reading["kernel_vs_f64"] = u_err = _rel(got[0], exact)
                    del exact
                row.update(reading, gate_u=1e-5)
                reading["gated_u_over_gate"] = u_err / 1e-5
                ok = ok and u_err <= 1e-5
            planned = ga.plan(c32["side"], mm, nn, r, g.dtype, mode,
                              batch=int(np.prod(lead)),
                              w_dtype=wdt or torch.float32).route
            outs[name] = got
            if name == "bfloat16_as_float32":
                row["bf16_equal_to_fp32_copy"] = all(
                    torch.equal(a, b) for a, b in zip(outs["bfloat16"], got))
                ok = ok and row["bf16_equal_to_fp32_copy"]
            if show:
                emit(row)
            check(route == planned, f"{kernel} at {tuple(g.shape)} {name} "
                  f"took route {route}, plan() says {planned}")
            key = (kernel, mode, route)
            acc = worst.setdefault(key, {})
            for k, val in reading.items():
                acc[k] = max(acc.get(k, 0.0), val)
            if not ok:
                failed.append({"g": list(g.shape), "g_dtype": name, "r": r,
                               "mode": mode, **reading})
            out[kernel][0] = max(out[kernel][0], err)
            if mode != ga.ADAMW and name != "bfloat16_as_float32":
                out[kernel][1].add(_precond_key(
                    g, c32["basis"], c32["m"], None, None,
                    project_back=mode == ga.PRECOND_U))


def phase_train_kernel_checks(gen, seed):
    """Each training kernel against its plain version at every shape the
    two rounds launch, plus masked tails, odd M, both sides, every GaLore
    mode with fp32 and bf16 g (galore_kernel_checks), n = 1..64 and
    exact-zero off-diagonals with a mask for the eigensolver. Returns per
    kernel the worst absolute error and the keys checked."""
    from repro_torch.kernels import batched_eigh as be
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels import ops, ref
    out = {k: [0.0, set()] for k in ("lowrank_linear", "galore_precond_step",
                                     "galore_adamw_step", "jacobi_eigh")}

    # lowrank_linear: the round-1 forward (B, L) = (4, 128), bf16; ragged
    # row tails and fp32 beside it; then the routes' edges (rows 1, 8, 16,
    # 17, TC_MIN_ROWS - 1, TC_MIN_ROWS, + 1, 100, 128, 1,024; n = 520, m =
    # 1,032; a split GEMM with a short last K chunk) and a misaligned x.
    lows = [((m, n), lead, dtype, False) for (m, n) in TRAIN_SHAPES
            for lead, dtype in (((TRAIN_B, TRAIN_L), torch.bfloat16),
                                ((TRAIN_B, 100), torch.bfloat16),
                                ((3, 37), torch.float32))]
    lows += [((1032, 520), lead, torch.bfloat16, False)
             for lead in ((1, 1), (2, 4), (1, 16), (1, 17), (1, 63), (1, 64),
                          (1, 65), (1, 100), (1, 128), (8, 128))]
    lows += [((m, n), lead, torch.bfloat16, False) for (m, n) in NLU_SHAPES
             for lead in ((NLU_B, NLU_L), (VIT_B, VIT_L))]
    lows += [((m, n), (TRAIN_B, TRAIN_L), torch.bfloat16, False)
             for (m, n) in RWKV_TRAIN_SHAPES]
    lows += [((4104, 136), (2, 100), torch.bfloat16, False),
             ((1024, 2816), (TRAIN_B, TRAIN_L), torch.bfloat16, True),
             ((1024, 1024), (2, 4), torch.bfloat16, True)]
    fn = ll.lowrank_linear
    for (m, n), lead, dtype, misalign in lows:
        c = _lowrank_case(gen, lead, m, n, dtype)
        if misalign:
            c["x"] = _misaligned(c["x"])
        before = dict(fn.routes)
        y = fn(c["x"], c["w"], c["basis"], c["rt"], c["scale"],
               side=c["side"])
        torch.cuda.synchronize()
        took = _route_taken(fn, before)
        want = ref.lowrank_linear_ref(c["x"], c["w"], c["basis"],
                                      c["rt"], c["scale"], side=c["side"])
        err = (y.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = 1e-5 * scale if dtype == torch.float32 else \
            2 * bf16_ulp(scale)
        emit({"phase": "train_kernel_check", "kernel": "lowrank_linear",
              "x": list(c["x"].shape), "m": m, "n": n,
              "dtype": str(dtype).split(".")[1], "side": c["side"],
              "misaligned_x": misalign, "route": took,
              "max_abs_err": err, "out_scale": scale, "tol": tol})
        check(took == _want_route(int(np.prod(lead)), dtype, not misalign),
              f"lowrank_linear x {tuple(c['x'].shape)} w ({m}, {n}) "
              f"{dtype} took route {took}")
        check(y.dtype == want.dtype and err <= tol,
              f"lowrank_linear disagrees at x {tuple(c['x'].shape)} "
              f"w ({m}, {n}) {dtype} ({took}): {err} > {tol}")
        out["lowrank_linear"][0] = max(out["lowrank_linear"][0], err)
        out["lowrank_linear"][1].add(_lowrank_key(c["x"], c["w"], None,
                                                  None, None))

    galore_kernel_checks(seed, out)

    # jacobi_eigh: 𝒮's Phase-1 Grams (bucket leaves, 24, 4 clients, 8, 8)
    # and (24, 4, 8, 8) for the singleton bucket; n = 1..64 in batches of
    # 7 (a partial block on the warp route); the route threshold +- 1 at
    # batch 1 and at 21 (a whole block and a partial one); n = 7, 8 at the
    # pair layout's last batch and one past it (the column layout); rank
    # 16; a 64-client cohort (4, 24, 64, 8, 8) = 6,144 matrices; a
    # diagonal input (exact-zero off-diagonals) through the masked ops
    # path. Each case takes the route plan() names.
    wmax, pmax = be.WARP_MAX_N, be.PAIR_MAX_BATCH
    shapes = [(4, 24, CLIENTS), (24, CLIENTS), (2, 24, CLIENTS),
              (4, NLU_LAYERS, CLIENTS), (NLU_LAYERS, CLIENTS),
              (6, 24, CLIENTS)]
    cases = [(lead, TRAIN_R) for lead in shapes] + \
        [((7,), n) for n in range(1, 65)] + \
        [(lead, n) for n in (wmax - 1, wmax, wmax + 1)
         for lead in ((1,), (21,))] + \
        [((b,), n) for n in (7, 8) for b in (pmax, pmax + 1)] + \
        [((4, 24, CLIENTS), 16), ((4, 24, 64), TRAIN_R)]
    shown = {(ld, TRAIN_R) for ld in shapes} | {((4, 24, CLIENTS), 16),
                                                 ((4, 24, 64), TRAIN_R)}
    for lead, n in cases:
        a = _spd_case(gen, lead, n)
        before = dict(be.jacobi_eigh.routes)
        lam, vec = be.jacobi_eigh(a)
        torch.cuda.synchronize()
        took = _route_taken(be.jacobi_eigh, before)
        lam_p, vec_p = ref.jacobi_eigh_ref(a)
        scale = lam_p.abs().max().item()
        err_l = (lam - lam_p).abs().max().item()
        recon = (vec * lam[..., None, :]) @ vec.mT
        err_r = (recon - a).abs().max().item() / max(scale, 1e-30)
        orth = (vec.mT @ vec - torch.eye(n, device="cuda")).abs().max().item()
        tol = 1e-5 * max(n, 8)
        planned = be.plan(n, a.numel() // (n * n))
        if (lead, n) in shown or n in (1, 7, 8, 17, 64) or \
                n in (wmax - 1, wmax, wmax + 1):
            emit({"phase": "train_kernel_check", "kernel": "jacobi_eigh",
                  "a": list(a.shape), "route": took,
                  "layout": planned.layout, "max_abs_err": err_l,
                  "rel_err_lam": err_l / max(scale, 1e-30),
                  "rel_recon": err_r, "orth": orth, "tol": tol})
        check(took == planned.route,
              f"jacobi_eigh at {tuple(a.shape)} took route {took}")
        check(err_l <= tol * scale and err_r <= tol and orth <= tol,
              f"jacobi_eigh disagrees at {tuple(a.shape)} ({took}): lam "
              f"{err_l} recon {err_r} orth {orth}")
        out["jacobi_eigh"][0] = max(out["jacobi_eigh"][0], err_l)
        out["jacobi_eigh"][1].add(tuple(a.shape))
    diag = torch.diag_embed(torch.tensor([[3.0, 1.0, 2.0, 0.5]] * 3,
                                         device="cuda"))
    diag[1, 0, 0] = float("nan")                 # masked payload
    mask = torch.tensor([True, False, True], device="cuda")
    lam, vec = ops.batched_small_eigh(diag, mask=mask)
    torch.cuda.synchronize()
    with ops.plain_kernels():
        lam_p, vec_p = ops.batched_small_eigh(diag, mask=mask)
    check(torch.equal(lam, lam_p) and torch.equal(vec, vec_p)
          and bool((lam[1] == 0).all()) and bool(torch.isfinite(vec).all()),
          "jacobi_eigh: exact-zero off-diagonals or the mask misbehave")
    emit({"phase": "train_kernel_check", "kernel": "jacobi_eigh",
          "case": "diagonal input, one masked slice", "exact": True})
    return out


def _train_setup(seed, method="fedgalore", arch="qwen1.5-0.5b",
                 bump_embed=False, lr=TRAIN_LR, **fed_kw):
    """Full-width ``arch`` (bf16, random weights from ``seed``; with
    ``bump_embed`` 1 % of the embedding table one bf16 ulp up), the engine
    of ``method`` (FedConfig fields ``fed_kw`` on top) and its batcher."""
    from repro_torch.core.fed import FedConfig, FedEngine
    from repro_torch.data import FederatedBatcher, seq_classification
    from repro_torch.launch.steps import galore_target_fn
    from repro_torch.models import model as model_lib
    cfg = _full_config(arch)
    params = model_lib.init_params(cfg, seed=seed, device="cuda")
    if bump_embed:
        params["embed"]["w"] = _bump_embed(params["embed"]["w"], seed + 5)
    task = seq_classification(n_examples=256, n_classes=4, seq_len=TRAIN_L,
                              vocab=cfg.vocab_size, seed=seed)
    batcher = FederatedBatcher(task, n_clients=CLIENTS,
                               batch_size=TRAIN_B, alpha=0.5, seed=seed)
    engine = FedEngine(
        FedConfig(method=method, rank=TRAIN_R, lr=lr,
                  local_steps=LOCAL_STEPS, seed=seed, lora_scale=LORA_SCALE,
                  **fed_kw),
        loss_fn=lambda p, b: model_lib.loss_fn(p, cfg, b), params=params,
        target_fn=galore_target_fn(cfg))
    return cfg, engine, batcher


def _counted():
    """Every kernel wrapper of the port, by name."""
    from repro_torch.kernels import batched_eigh as be
    from repro_torch.kernels import galore_adamw as ga
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
    return {"flash_attention": flash_attention,
            "lowrank_linear": ll.lowrank_linear,
            "galore_precond_step": ga.galore_precond_step,
            "galore_adamw_step": ga.galore_adamw_step,
            "jacobi_eigh": be.jacobi_eigh,
            "lowrank_linear_batched": ll.lowrank_linear_batched,
            "rwkv6_scan": rwkv6_scan, "rwkv6_scan_bwd": rwkv6_scan_bwd}


def _launch_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def _route_counts():
    """Launches by route of the kernels with routes (the low-rank applies,
    flash_attention, jacobi_eigh)."""
    return {name: dict(fn.routes) for name, fn in _counted().items()
            if hasattr(fn, "routes")}


def _zero_counts():
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)


def _run_train(seed, plain: bool, **fed_kw):
    """Two FedGaLore rounds (FedConfig fields ``fed_kw`` on top); returns
    per-round losses, times, 𝒮's seconds and launch counts, the global
    target leaves at the start, after round 0 and at the end (``snaps``),
    and the shapes each kernel saw."""
    cfg, engine, batcher = _train_setup(seed, **fed_kw)
    sync_s = _time_method(engine, "_sync_states_eager",
                          _time_method(engine, "_sync_states"))
    with _plain_or_kernels(plain), RoundLog() as rl, \
            ShapeLog(TRAIN_LOG) as log:
        for _ in range(2):
            engine.run_round(batcher.round_batches(LOCAL_STEPS))
            rl.rounds[-1]["sync_s"] = sum(sync_s)
            sync_s.clear()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    snaps = dict(zip(("init", "round0", "final"), rl.snaps))
    return cfg, engine, rl.rounds, snaps, log.seen, peak


def phase_train(seed, card, checked):
    """The training path at full width: two rounds of fedgalore through
    FedEngine.run_round, every kernel of the path counted per round."""
    torch.cuda.reset_peak_memory_stats()
    cfg, engine, rounds, snaps, seen, peak = _run_train(seed, plain=False)
    for name, keys in seen.items():
        check(keys <= checked[name][1], f"the training path launched {name} "
              f"at shapes the checks did not cover: "
              f"{sorted(keys - checked[name][1])}")
    for r in rounds:
        losses = r["losses"]
        check(tuple(losses.shape) == (CLIENTS, LOCAL_STEPS)
              and bool(torch.isfinite(losses).all()),
              f"round {r['round']}: losses {losses}")
        for name, want in EXPECTED_LAUNCHES[r["round"]].items():
            check(r["launches"][name] == want,
                  f"round {r['round']}: {name} launched "
                  f"{r['launches'][name]} times, expected {want}")
        _check_tc_routes(f"train round {r['round']}", r["launches"],
                         r["routes"])
        if r["round"] == 0:
            got = {k: v for k, v in r["routes"]["galore_precond_step"]
                   .items() if v}
            check(got == EXPECTED_GALORE_ROUTES,
                  f"round 0: galore_precond_step routes {got}, expected "
                  f"{EXPECTED_GALORE_ROUTES}")
            planned = {key[-1] for key in seen["galore_precond_step"]}
            check({key[2] for key in seen["galore_precond_step"]}
                  == {False}, "the training path ran the preconditioner "
                  "with the update projected back")
            check(planned == set(EXPECTED_GALORE_ROUTES),
                  f"round 0: plan() gives routes {planned} for the "
                  "launched GaLore buckets")
        check(r["routes"]["jacobi_eigh"]["warp"]
              == r["launches"]["jacobi_eigh"],
              f"round {r['round']}: jacobi_eigh routes "
              f"{r['routes']['jacobi_eigh']}: an 𝒮 bucket left the warp "
              "route")
        check(r["launches"]["galore_adamw_step"] == 0
              and r["launches"]["lowrank_linear_batched"] == 0
              and r["launches"]["rwkv6_scan"] == 0
              and r["launches"]["rwkv6_scan_bwd"] == 0
              and r["launches"]["flash_attention"] == 0,
              "the training path launched a kernel it does not run")
        emit({"phase": "train", "arch": cfg.name, "card": card,
              "round": r["round"], "clients": CLIENTS,
              "local_steps": LOCAL_STEPS, "batch": TRAIN_B, "seq": TRAIN_L,
              "rank": TRAIN_R, "round_s": r["seconds"],
              "tokens_per_s": CLIENTS * LOCAL_STEPS * TRAIN_B * TRAIN_L
              / r["seconds"], "launches": r["launches"],
              "routes": r["routes"], "losses": r["losses"].tolist()})
    check(all(bool(torch.isfinite(x.float()).all())
              for x in snaps["final"]),
          "non-finite global leaves after two rounds")
    emit({"phase": "train", "kernel_shapes": {k: sorted(v)
                                              for k, v in seen.items()},
          "peak_gib": peak})
    launches = {name: sum(r["launches"][name] for r in rounds)
                for name in ("lowrank_linear", "galore_precond_step",
                             "galore_adamw_step", "jacobi_eigh")}
    del engine
    torch.cuda.empty_cache()
    return rounds, snaps, launches


def _time_method(engine, name, seconds=None):
    """Wrap ``engine.<name>`` to append each call's seconds (fenced by
    synchronize) to ``seconds`` (a new list by default), returned. The
    wrapper holds the engine weakly, so ``del engine`` still frees it."""
    seconds = [] if seconds is None else seconds
    inner, ref = getattr(type(engine), name), weakref.ref(engine)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(ref(), *args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(engine, name, timed)
    return seconds


def _eager_routes():
    """galore_precond_step's launches by route in one eager round, from
    plan() for the three buckets in mode PRECOND_U with the fp32 g the
    clip hands it (stated before the run)."""
    from repro_torch.kernels import galore_adamw as ga
    routes = {}
    for (mm, nn), leaves in TRAIN_SHAPES.items():
        side = "right" if mm >= nn else "left"
        route = ga.plan(side, mm, nn, TRAIN_R, torch.float32, ga.PRECOND_U,
                        batch=leaves * 24).route
        routes[route] = routes.get(route, 0) + CLIENTS * LOCAL_STEPS
    return routes


def svd_stack_check(seed, card, batch=16):
    """The card's stacked SVD (``projector._svd_card``, several matrices in
    flight on side streams) against ``torch.linalg.svd`` of each matrix
    alone, bit for bit, on stacks of the eager 𝒮's Phase-1 views (rank 8)
    and full-rank matrices at the path's widths, each timed both ways."""
    from repro_torch.core import projector as proj
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for (mm, nn), rank in itertools.product(((1024, 1024), (1024, 2816)),
                                            (TRAIN_R, None)):
        if rank is None:
            x = torch.randn((batch, mm, nn), generator=gen, device="cuda")
        else:
            v = torch.rand((batch, mm, rank), generator=gen, device="cuda")
            b, _ = torch.linalg.qr(torch.randn((batch, nn, rank),
                                               generator=gen, device="cuda"))
            x = v @ b.mT
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = [torch.linalg.svd(m, full_matrices=False) for m in x]
        torch.cuda.synchronize()
        alone_s = time.perf_counter() - t0
        stacked_s = {}
        default = proj.SVD_STREAMS
        try:
            for streams in (4, 16, default):
                proj.SVD_STREAMS = streams
                t0 = time.perf_counter()
                got = proj._svd_card(x)
                torch.cuda.synchronize()
                stacked_s[streams] = time.perf_counter() - t0
        finally:
            proj.SVD_STREAMS = default
        equal = all(torch.equal(got[j][i], alone[i][j])
                    for i in range(batch) for j in range(3))
        emit({"phase": "svd_stack_check", "card": card,
              "stack": [batch, mm, nn], "rank": rank or min(mm, nn),
              "streams": default, "alone_s": alone_s,
              "stacked_s_by_streams": stacked_s, "bitwise_equal": equal})
        check(equal, f"the stacked SVD of ({batch}, {mm}, {nn}) differs "
              "from torch.linalg.svd of each matrix alone")


def _second_round(engine, batcher, card):
    """A dense-client method's second round: the first one's stacked
    client copies must not stay held into it (no population runner asked
    for them), so its peak is the first round's."""
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    batches = batcher.round_batches(LOCAL_STEPS)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = engine.run_round(batches)["local_loss"].cpu()
    torch.cuda.synchronize()
    row = {"phase": "train_methods", "method": engine.cfg.method,
           "round": 1, "card": card, "round_s": time.perf_counter() - t0,
           "held_after_round0_gib": held,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": sum(_launch_counts().values()),
           "losses": losses.tolist()}
    emit(row)
    check(bool(torch.isfinite(losses).all()) and row["launches"] == 0,
          f"{engine.cfg.method} round 1: {row}")


def phase_train_methods(seed, card, checked):
    """The LoRA and dense methods and the eager oracle round at full
    width (see LORA_METHODS / EAGER_LAUNCHES). Returns the eager rounds'
    records as phase_train's."""
    from repro_torch.utils import tree
    for method in LORA_METHODS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        _, engine, batcher = _train_setup(seed, method)
        agg_s = _time_method(engine, "_aggregate_pure")
        batches = batcher.round_batches(LOCAL_STEPS)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        metrics = engine.run_round(batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        losses = metrics["local_loss"].cpu()
        leaves = tree.tree_leaves(engine.global_trainable) + \
            tree.tree_leaves(engine.frozen)
        row = {"phase": "train_methods", "method": method, "card": card,
               "clients": CLIENTS, "local_steps": LOCAL_STEPS,
               "batch": TRAIN_B, "seq": TRAIN_L, "rank": TRAIN_R,
               "lora_scale": LORA_SCALE, "round_s": seconds,
               "aggregate_s": sum(agg_s), "resident_gib": resident,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": launches, "losses": losses.tolist()}
        emit(row)
        check(tuple(losses.shape) == (CLIENTS, LOCAL_STEPS)
              and bool(torch.isfinite(losses).all()),
              f"{method}: losses {losses}")
        check(all(bool(torch.isfinite(x.float()).all()) for x in leaves),
              f"{method}: non-finite global leaves after a round")
        check(sum(launches.values()) == 0,
              f"{method} launched kernels it does not run: {launches}")
        del leaves
        if method == "fedavg_full":
            _second_round(engine, batcher, card)
        del engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, engine, rounds, snaps, seen, peak = _run_train(
        seed, plain=False, fused_round=False)
    del engine
    want_routes = _eager_routes()
    for name, keys in seen.items():
        check(keys <= checked[name][1], f"the eager round launched {name} "
              f"at shapes the checks did not cover: "
              f"{sorted(keys - checked[name][1])}")
    check({key[2] for key in seen["galore_precond_step"]} == {True},
          "the eager round ran the preconditioner without the lift")
    for r in rounds:
        check(tuple(r["losses"].shape) == (CLIENTS, LOCAL_STEPS)
              and bool(torch.isfinite(r["losses"]).all()),
              f"eager round {r['round']}: losses {r['losses']}")
        want = {name: EAGER_LAUNCHES[r["round"]].get(name, 0)
                for name in r["launches"]}
        check(r["launches"] == want, f"eager round {r['round']}: launches "
              f"{r['launches']}, expected {want}")
        got = {k: v for k, v in r["routes"]["galore_precond_step"].items()
               if v}
        check(got == want_routes, f"eager round {r['round']}: "
              f"galore_precond_step routes {got}, expected {want_routes}")
        check(r["routes"]["jacobi_eigh"]["warp"]
              == r["launches"]["jacobi_eigh"],
              f"eager round {r['round']}: jacobi_eigh routes "
              f"{r['routes']['jacobi_eigh']}")
        emit({"phase": "train_methods", "method": "fedgalore",
              "fused_round": False, "card": card, "round": r["round"],
              "clients": CLIENTS, "local_steps": LOCAL_STEPS,
              "batch": TRAIN_B, "seq": TRAIN_L, "rank": TRAIN_R,
              "round_s": r["seconds"], "sync_s": r["sync_s"],
              "launches": r["launches"], "routes": r["routes"],
              "losses": r["losses"].tolist()})
    emit({"phase": "train_methods", "method": "fedgalore",
          "fused_round": False, "peak_gib": peak,
          "kernel_shapes": {k: sorted(v) for k, v in seen.items()}})
    phase_train_parity(seed, rounds, snaps, phase="train_methods_parity",
                       fused_round=False)
    return rounds


def phase_sampling(cfg, served, seed, card):
    """Sampled decoding on JAX's key chain: ``categorical`` on fixed
    (8, vocab) fp32 logits gives the same tokens on the card as on the
    CPU (the threefry arithmetic in int64 on CUDA), and a short sampled
    ``generate`` and ``SlotServer`` decode at temperature 0.8 give valid
    ids, the same twice from one seed."""
    from repro_torch.launch import serve
    from repro_torch.utils import prng
    rng = np.random.default_rng(seed + 7)
    logits = torch.from_numpy(
        (3.0 * rng.standard_normal((8, cfg.vocab_size))).astype(np.float32))
    key = prng.fold_in(prng.PRNGKey(seed), 11)
    cpu = prng.categorical(key, logits)
    card_tok = prng.categorical(key.cuda(), logits.cuda()).cpu()
    noise_gap = (prng.gumbel(key.cuda(), logits.shape).cpu()
                 - prng.gumbel(key, logits.shape)).abs().max().item()
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    n_new = 8

    def sampled():
        gen = serve.generate(served, cfg, prompts, n_new, PROMPT + n_new,
                             temperature=0.8, seed=seed,
                             adapters=np.arange(B) % G)
        srv = serve.SlotServer(served, cfg, slots=B // 2,
                               cache_len=PROMPT + n_new, segment=4,
                               temperature=0.8, seed=seed)
        out = srv.run([serve.Request(rid=i, prompt=prompts[i], max_new=n_new,
                                     adapter=i % G) for i in range(B)])
        return gen[:, PROMPT:].cpu(), out["outputs"]

    t0 = time.perf_counter()
    (gen_a, slot_a), (gen_b, slot_b) = sampled(), sampled()
    torch.cuda.synchronize()
    greedy = serve.generate(served, cfg, prompts, n_new, PROMPT + n_new,
                            adapters=np.arange(B) % G)[:, PROMPT:].cpu()
    ids = [v for row in slot_a.values() for v in row] + gen_a.flatten() \
        .tolist()
    emit({"phase": "sampling", "arch": cfg.name, "card": card,
          "categorical_cpu": cpu.tolist(), "categorical_card":
          card_tok.tolist(), "gumbel_card_vs_cpu_max_abs": noise_gap,
          "temperature": 0.8, "new_tokens": n_new,
          "generate_tokens": gen_a.tolist(),
          "slot_outputs": {str(k): v for k, v in slot_a.items()},
          "differs_from_greedy": not torch.equal(gen_a, greedy),
          "seconds": time.perf_counter() - t0})
    check(torch.equal(cpu, card_tok), f"categorical on the card {card_tok} "
          f"is not the CPU's {cpu}")
    check(all(0 <= v < cfg.vocab_size for v in ids) and len(ids) == 2 * B
          * n_new, "sampled decoding gave invalid or missing token ids")
    check(torch.equal(gen_a, gen_b) and slot_a == slot_b,
          "two sampled runs from one seed gave different tokens")


def _change_rel(got, want, init):
    """How far the change ``got - init`` is from ``want - init``: the
    Frobenius norm of the difference over that of ``want - init``, and
    the same with max |.| in place of the norm, over all leaves."""
    num = den = 0.0
    max_num = max_den = 0.0
    for g, w, i in zip(got, want, init):
        d = g.float() - w.float()
        dw = w.float() - i.float()
        num += float(torch.sum(d * d))
        den += float(torch.sum(dw * dw))
        max_num = max(max_num, float(d.abs().max()))
        max_den = max(max_den, float(dw.abs().max()))
    return (num / max(den, 1e-30)) ** 0.5, max_num / max(max_den, 1e-30)


def phase_train_parity(seed, rounds, snaps, phase="train_parity", **fed_kw):
    """The same two rounds with every kernel's plain version, compared per
    step loss and by the change of the global leaves from their start.
    Two controls show the leaves' bound fails where a round's update is
    lost: the kernel run's leaves after round 0 (round 1's update
    dropped), and its end leaves less round 0's change (round 0's update
    dropped)."""
    _, engine, plain_rounds, plain, _, _ = _run_train(seed, plain=True,
                                                      **fed_kw)
    for r in plain_rounds:
        check(sum(r["launches"].values()) == 0,
              f"plain run launched kernels: {r['launches']}")
    check(all(torch.equal(a, b) for a, b in zip(snaps["init"],
                                                 plain["init"])),
          "the kernel and plain runs did not start from the same weights")
    loss_diff = max((a["losses"] - b["losses"]).abs().max().item()
                    for a, b in zip(rounds, plain_rounds))
    init, want = plain["init"], plain["final"]
    delta_rel, delta_max_rel = _change_rel(snaps["final"], want, init)
    no_round0 = [f.float() - (r0.float() - i.float()) for f, r0, i in
                 zip(snaps["final"], snaps["round0"], init)]
    controls = {"round1_dropped": _change_rel(snaps["round0"], want,
                                              init)[0],
                "round0_dropped": _change_rel(no_round0, want, init)[0]}
    emit({"phase": phase, "rounds": 2,
          "max_abs_loss_diff": loss_diff, "loss_bound": TRAIN_LOSS_BOUND,
          "delta_rel_fro": delta_rel, "delta_bound": TRAIN_DELTA_BOUND,
          "delta_rel_max": delta_max_rel, "controls": controls,
          "plain_round_s": [r["seconds"] for r in plain_rounds]})
    check(loss_diff <= TRAIN_LOSS_BOUND, f"train losses differ by "
          f"{loss_diff} > {TRAIN_LOSS_BOUND}")
    check(delta_rel <= TRAIN_DELTA_BOUND, f"the rounds' change of the "
          f"global leaves differs by {delta_rel} of its norm > "
          f"{TRAIN_DELTA_BOUND}")
    check(min(controls.values()) > TRAIN_DELTA_BOUND,
          f"a control with a round's update dropped reads {controls}, not "
          f"above the bound {TRAIN_DELTA_BOUND}: the check cannot see it")
    del engine
    torch.cuda.empty_cache()
    return controls


def phase_population_honest(seed, card, rounds, snaps):
    """phase_train's two rounds again with quarantine on and no attack: an
    honest cohort through the guard must give phase_train's leaves and
    losses bit for bit. Where it does not, two unguarded runs show
    whether the card repeats the round at all."""
    _, engine, g_rounds, g_snaps, _, _ = _run_train(seed, plain=False,
                                                    quarantine=True)
    quarantined = int(engine.quarantined.sum())
    del engine

    def same(a_rounds, a_snaps):
        return (all(torch.equal(x["losses"], y["losses"])
                    for x, y in zip(a_rounds, rounds))
                and all(torch.equal(x, y) for k in ("round0", "final")
                        for x, y in zip(a_snaps[k], snaps[k])))

    row = {"phase": "population_honest", "card": card, "rounds": 2,
           "guarded_equals_plain": same(g_rounds, g_snaps),
           "quarantined_last_round": quarantined}
    del g_snaps
    if not row["guarded_equals_plain"]:
        _, engine, u_rounds, u_snaps, _, _ = _run_train(seed, plain=False)
        del engine
        row["unguarded_repeats"] = same(u_rounds, u_snaps)
        del u_snaps
    torch.cuda.empty_cache()
    emit(row)
    check(row["guarded_equals_plain"] or not row["unguarded_repeats"],
          "an honest guarded round differs from the plain one while the "
          "plain one repeats bit for bit: the guard changed the round")
    return row


def _pop_plans():
    """The five rounds' plans, checked against POP_FAULTS before any run."""
    from repro_torch.core import population as pop
    pcfg = pop.ParticipationConfig(**POP_CONFIG)
    plans = [pop.sample_cohort(pcfg, CLIENTS, r) for r in range(POP_ROUNDS)]
    due = sorted(p.round_idx + int(d) for p in plans for d in p.delays
                 if d > 0)
    corrupt = {p.round_idx: pcfg.corrupt_modes[int(c) - 1]
               for p in plans for c in p.corrupt if c}
    got = {"dropped": int(sum((p.delays < 0).sum() for p in plans)),
           "straggling": int(sum((p.delays > 0).sum() for p in plans)),
           "due": due, "corrupt": corrupt}
    check(got == POP_FAULTS, f"population plans hold {got}, stated "
          f"{POP_FAULTS}")
    return pcfg, plans


def _pop_eigh_check(gen):
    """jacobi_eigh on the path's masked score Grams: one bucket's (4, 24,
    C, 8, 8) stack with two clients masked out, against its plain version
    through ``ops.batched_small_eigh``."""
    from repro_torch.kernels import ops
    a = _spd_case(gen, (4, 24, CLIENTS), TRAIN_R)
    mask = torch.tensor([True, False, True, False], device="cuda").expand(
        4, 24, CLIENTS)
    lam, vec = ops.batched_small_eigh(a, mask=mask)
    torch.cuda.synchronize()
    with ops.plain_kernels():
        lam_p, vec_p = ops.batched_small_eigh(a, mask=mask)
    scale = lam_p.abs().max().item()
    err = (lam - lam_p).abs().max().item()
    recon = ((vec * lam[..., None, :]) @ vec.mT - (vec_p * lam_p[
        ..., None, :]) @ vec_p.mT).abs().max().item() / max(scale, 1e-30)
    tol = 1e-5 * TRAIN_R
    emit({"phase": "population_kernel_check", "kernel": "jacobi_eigh",
          "a": list(a.shape), "masked_clients": [1, 3],
          "max_abs_err": err, "rel_recon": recon, "tol": tol})
    check(err <= tol * scale and recon <= tol
          and bool((lam[:, :, 1] == 0).all()),
          f"masked jacobi_eigh disagrees: lam {err} recon {recon}")
    return err


def _first_step_losses(engine, leaves, batches):
    """Each client's loss on its first local batch at the global leaves
    ``leaves`` (every kernel's plain version)."""
    from repro_torch.kernels import ops
    from repro_torch.utils import tree
    treedef = tree.tree_flatten(engine.global_trainable)[1]
    engine.global_trainable = treedef.unflatten(list(leaves))
    clients = tree.tree_leaves(batches)[0].shape[0]
    with ops.plain_kernels():
        return torch.tensor([engine.evaluate(tree.tree_map(
            lambda x: x[c, 0], batches)) for c in range(clients)])


def _run_population(seed, pcfg, batches_for, store_dir, plain=False,
                    snapshot_dir=None, resume_dir=None):
    """POP_ROUNDS rounds of a PopulationRunner at full width (kernels, or
    every kernel's plain version). With ``snapshot_dir`` it snapshots
    after round POP_SNAPSHOT_AFTER; a fresh engine and runner over a copy
    of the store (``resume_dir``) restore it and run the last round too.
    Returns per-round rows, the global leaves (init, after round 0, before
    the last round, final), the kernels' shapes, the resume row, the peak
    GiB and round 1's first-step losses at the leaves after round 0 and
    at the initial ones (the loss control)."""
    from repro_torch.core.population import PopulationRunner, sample_cohort
    from repro_torch.kernels import ops
    from repro_torch.utils import tree
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, engine, _ = _train_setup(seed, quarantine=True,
                                robust_agg="trimmed_mean")
    runner = PopulationRunner(engine, batches_for, cohort=CLIENTS, pcfg=pcfg,
                              store_dir=store_dir, shard_size=POP_SHARD,
                              max_resident_shards=POP_RESIDENT,
                              snapshot_dir=snapshot_dir)
    guard_s = _time_method(engine, "_apply_guard")
    _time_method(engine, "_aggregate_factored", guard_s)
    _time_method(engine, "_sync_states", guard_s)
    merge_s = _time_method(runner, "_merge_due")

    def snap():
        return [x.detach().clone()
                for x in tree.tree_leaves(engine.global_trainable)]

    def one_round(r):
        torch.cuda.synchronize()
        _zero_counts()
        guard_s.clear()
        merge_s.clear()
        t0 = time.perf_counter()
        if plain:
            with ops.plain_kernels():
                rec = runner.run_round()
        else:
            rec = runner.run_round()
        torch.cuda.synchronize()
        hist = runner.history[-1]
        return {"round": r, "round_s": time.perf_counter() - t0,
                "guard_s": sum(guard_s), "merge_s": sum(merge_s),
                "launches": _launch_counts(), "routes": _route_counts(),
                **{k: hist[k] for k in ("participants", "dropped",
                                        "straggling", "buffered",
                                        "corrupted", "stale_merged",
                                        "stale_evicted")},
                "quarantined": [int(i) for i in
                                np.nonzero(rec["quarantined"])[0]],
                "masked": bool(rec["plan"].mask.sum() < CLIENTS
                               or rec["quarantined"].any()),
                "mean_final_loss": hist["mean_final_loss"],
                "moment_divergence": hist["moment_divergence"],
                "stale_weight_err": hist["stale_weight_err"],
                "losses": rec["local_loss"].cpu(),
                "spills": runner.store.spills, "loads": runner.store.loads,
                "resident_mib": runner.store.resident_bytes() / 2 ** 20}

    snaps = {"init": snap()}
    rows, resume = [], None
    with ShapeLog(TRAIN_LOG) as log:
        for r in range(POP_ROUNDS):
            if r == POP_SNAPSHOT_AFTER + 1 and snapshot_dir is not None:
                snaps["before_last"] = snap()
                resume = _snapshot_and_restore(seed, runner, pcfg,
                                               batches_for, store_dir,
                                               resume_dir, snapshot_dir)
            rows.append(one_round(r))
            if r == 0:
                snaps["round0"] = snap()
    snaps["final"] = snap()
    if resume is not None:
        # the resumed runner ran the last round before this one did
        want = rows[-1]
        for k, rtol in (("mean_final_loss", 1e-6),
                        ("moment_divergence", 1e-5)):
            resume[k + "_rel"] = abs(resume[k] - want[k]) / max(
                abs(want[k]), 1e-30)
            check(resume[k + "_rel"] <= rtol, f"resumed run: {k} "
                  f"{resume[k]} against {want[k]} (rtol {rtol})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batches1 = batches_for(sample_cohort(pcfg, CLIENTS, 1).clients, 1)
    first = {k: _first_step_losses(engine, snaps[k], batches1)
             for k in ("round0", "init")}
    del runner, engine
    torch.cuda.empty_cache()
    return rows, snaps, log.seen, resume, peak, first


def _snapshot_and_restore(seed, runner, pcfg, batches_for, store_dir,
                          resume_dir, snapshot_dir):
    """Snapshot ``runner`` (timed, with its bytes), copy its store as a
    killed run leaves it on disk, restore a fresh engine and runner from
    them and run the next round there. Returns that round's record."""
    from repro_torch.core.population import PopulationRunner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = runner.snapshot()
    snap_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(snapshot_dir, f))
                 for f in os.listdir(snapshot_dir)
                 if f.startswith("fed_%08d" % step))
    shutil.copytree(store_dir, resume_dir)
    _, engine, _ = _train_setup(seed, quarantine=True,
                                robust_agg="trimmed_mean")
    fresh = PopulationRunner(engine, batches_for, cohort=CLIENTS, pcfg=pcfg,
                             store_dir=resume_dir, shard_size=POP_SHARD,
                             max_resident_shards=POP_RESIDENT,
                             snapshot_dir=snapshot_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(fresh.restore() == step, "restore found another snapshot")
    restore_s = time.perf_counter() - t0
    fresh.run_round()
    hist = fresh.history[-1]
    out = {"step": step, "snapshot_s": snap_s, "snapshot_bytes": nbytes,
           "restore_s": restore_s,
           "mean_final_loss": hist["mean_final_loss"],
           "moment_divergence": hist["moment_divergence"]}
    del fresh, engine
    torch.cuda.empty_cache()
    return out


def phase_population(seed, card, checked, gen, train_controls):
    """Population and robustness at full width (POP_* above): the kernel
    run with its snapshot, kill and resume, then the plain run; records
    held to each other, launches per round to POP_LAUNCHES."""
    from repro_torch.data import FederatedBatcher, seq_classification
    from repro_torch.configs import get_config
    pcfg, plans = _pop_plans()
    eigh_err = _pop_eigh_check(gen)
    cfg = get_config("qwen1.5-0.5b")
    task = seq_classification(n_examples=256, n_classes=4, seq_len=TRAIN_L,
                              vocab=cfg.vocab_size, seed=seed)
    batcher = FederatedBatcher(task, n_clients=POP_CONFIG["population"],
                               batch_size=TRAIN_B, alpha=0.5, seed=seed)
    drawn = {}

    def batches_for(ids, r):
        # drawn once per round, in round order, and shared by every run
        if r not in drawn:
            drawn[r] = batcher.round_batches(LOCAL_STEPS,
                                             clients=[int(i) for i in ids])
        return drawn[r]

    with tempfile.TemporaryDirectory(prefix="population_") as tmp:
        rows, snaps, seen, resume, peak, _ = _run_population(
            seed, pcfg, batches_for, os.path.join(tmp, "store"),
            snapshot_dir=os.path.join(tmp, "snapshots"),
            resume_dir=os.path.join(tmp, "store_resume"))
        plain_rows, plain, _, _, _, first = _run_population(
            seed, pcfg, batches_for, os.path.join(tmp, "store_plain"),
            plain=True)
    for name, keys in seen.items():
        check(keys <= checked[name][1], f"the population path launched "
              f"{name} at shapes the checks did not cover: "
              f"{sorted(keys - checked[name][1])}")
    ints = ("participants", "dropped", "straggling", "buffered", "corrupted",
            "stale_merged", "stale_evicted", "quarantined", "masked")
    for r, (a, b) in enumerate(zip(rows, plain_rows)):
        check({k: a[k] for k in ints} == {k: b[k] for k in ints},
              f"population round {r}: records differ: "
              f"{ {k: (a[k], b[k]) for k in ints if a[k] != b[k]} }")
        check(sum(b["launches"].values()) == 0,
              f"plain population run launched kernels: {b['launches']}")
        want = {name: POP_LAUNCHES[r].get(name, 0) for name in a["launches"]}
        check(a["launches"] == want, f"population round {r}: launches "
              f"{a['launches']}, expected {want}")
        check(a["masked"] == (r in POP_MASKED_ROUNDS),
              f"population round {r}: masked {a['masked']}")
        check(tuple(a["losses"].shape) == (CLIENTS, LOCAL_STEPS)
              and bool(torch.isfinite(a["losses"]).all()),
              f"population round {r}: losses {a['losses']}")
        emit({"phase": "population", "card": card,
              **{k: v for k, v in a.items() if k != "losses"},
              "losses": a["losses"].tolist(),
              "plain_round_s": b["round_s"]})
    plans_bad = {p.round_idx: [int(i) for i in np.nonzero(p.corrupt)[0]]
                 for p in plans}
    for r, mode in POP_FAULTS["corrupt"].items():
        if mode in ("nan", "scale"):
            check(rows[r]["quarantined"] == plans_bad[r]
                  and plain_rows[r]["quarantined"] == plans_bad[r],
                  f"round {r}: the {mode} client {plans_bad[r]} was not "
                  f"quarantined ({rows[r]['quarantined']}, plain "
                  f"{plain_rows[r]['quarantined']})")
    check(all(bool(torch.isfinite(x.float()).all()) for x in snaps["final"]),
          "non-finite global leaves after the population rounds")
    loss_diff = max((a["losses"] - b["losses"]).abs().max().item()
                    for a, b in zip(rows, plain_rows))
    init, want = plain["init"], plain["final"]
    check(all(torch.equal(a, b) for a, b in zip(snaps["init"], init)),
          "the population runs did not start from the same weights")
    delta_rel, delta_max_rel = _change_rel(snaps["final"], want, init)
    no_round0 = [f.float() - (r0.float() - i.float()) for f, r0, i in
                 zip(snaps["final"], snaps["round0"], init)]
    controls = {"last_round_dropped": _change_rel(snaps["before_last"], want,
                                                  init)[0],
                "round0_dropped": _change_rel(no_round0, want, init)[0]}
    # round 1's first local losses against the plain run's: at the leaves
    # after round 0 (the merged forward's rounding) and at the initial ones
    plain1 = plain_rows[1]["losses"][:, 0]
    loss_controls = {k: (first[k] - plain1).abs().max().item()
                     for k in ("round0", "init")}
    launches = {name: sum(r["launches"][name] for r in rows)
                for name in ("lowrank_linear", "galore_precond_step",
                             "jacobi_eigh")}
    launches["jacobi_eigh_masked"] = sum(
        r["launches"]["jacobi_eigh"] for r in rows if r["masked"])
    row = {"phase": "population_parity", "card": card,
           "rounds": POP_ROUNDS, "max_abs_loss_diff": loss_diff,
           "loss_bound": TRAIN_LOSS_BOUND,
           "loss_controls": {"sound": loss_controls["round0"],
                             "round0_dropped": loss_controls["init"]},
           "delta_rel_fro": delta_rel,
           "delta_rel_max": delta_max_rel, "delta_bound": POP_DELTA_BOUND,
           "controls": controls, "train_parity_controls": train_controls,
           "resume": resume, "peak_gib": peak, "launches": launches,
           "masked_eigh_max_abs_err": eigh_err,
           "kernel_shapes": {k: sorted(v) for k, v in seen.items()}}
    emit(row)
    check(loss_diff <= TRAIN_LOSS_BOUND, f"population losses differ by "
          f"{loss_diff} > {TRAIN_LOSS_BOUND}")
    check(delta_rel <= POP_DELTA_BOUND, f"the population rounds' change "
          f"of the global leaves differs by {delta_rel} > "
          f"{POP_DELTA_BOUND}")
    check(min(controls.values()) > POP_DELTA_BOUND,
          f"a control with a round's update dropped reads {controls}, not "
          f"above the bound {POP_DELTA_BOUND}: the check cannot see it")
    check(loss_controls["init"] > TRAIN_LOSS_BOUND,
          f"round 1's losses with round 0's update lost differ by "
          f"{loss_controls['init']}, not above the loss bound "
          f"{TRAIN_LOSS_BOUND}: the check cannot see it")
    del snaps, plain
    torch.cuda.empty_cache()
    return rows, launches


class RoundLog:
    """Records every ``FedEngine.run_round`` while active, whoever built
    the engine (an example's ``main`` too): the round's seconds, its
    per-step local losses and batches, the launches and routes of each
    kernel in the call (counts set to 0 just before it and read just
    after), and the global target leaves before the first round and after
    each.
    ``launches`` / ``routes`` total the whole run from entry: the rounds'
    counts and those read between and after them (evaluations)."""

    def __enter__(self):
        from repro_torch.core.fed import FedEngine
        from repro_torch.utils import tree
        self.cls, self.orig = FedEngine, FedEngine.run_round
        self.rounds, self.snaps, self.batches = [], [], []
        self.launches = dict.fromkeys(_counted(), 0)
        self.routes = {k: dict.fromkeys(v, 0)
                       for k, v in _route_counts().items()}
        _zero_counts()
        log = self

        def snap(engine):
            return [x.detach().clone()
                    for x in tree.tree_leaves(engine.global_trainable)]

        def run_round(engine, *args, **kw):
            if not log.snaps:
                log.snaps.append(snap(engine))
            log.batches.append(args[0] if args else kw["client_batches"])
            torch.cuda.synchronize()
            log._bank()                 # launches since the last reading
            t0 = time.perf_counter()
            metrics = log.orig(engine, *args, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches, routes = log._bank()
            log.rounds.append({
                "round": len(log.rounds), "seconds": seconds,
                "launches": launches, "routes": routes,
                "losses": metrics["local_loss"].cpu()})
            log.snaps.append(snap(engine))
            return metrics

        FedEngine.run_round = run_round
        return self

    def _bank(self):
        """Adds the counts since the last zeroing to the totals, sets them
        to 0 and returns them."""
        launches, routes = _launch_counts(), _route_counts()
        _zero_counts()
        for k, n in launches.items():
            self.launches[k] += n
        for k, by in routes.items():
            for r, n in by.items():
                self.routes[k][r] = self.routes[k].get(r, 0) + n
        return launches, routes

    def __exit__(self, *exc):
        self.cls.run_round = self.orig
        torch.cuda.synchronize()
        self._bank()
        return False


BACKBONE_LOG = {**TRAIN_LOG, "_flash": {"flash_attention": _flash_key}}


def _check_backbone_path(phase, rl, seen, checked, per_round, steps,
                         launches, routes, flash):
    """A paper backbone's FedGaLore rounds went through their kernels:
    every launched shape checked, each round's launches as ``per_round``
    states (round 0, then every later round), round 0's preconditioner on
    the right for the square and tall buckets and on the left for the
    wide one, 𝒮's eigensolves on the warp route, ``flash`` launches in
    the evaluation forwards and no kernel the path does not run."""
    for name, keys in seen.items():
        check(keys <= checked[name], f"{phase}: the path launched {name} "
              f"at shapes the checks did not cover: "
              f"{sorted(keys - checked[name])}")
    for r in rl.rounds:
        check(tuple(r["losses"].shape) == (NLU_CLIENTS, steps)
              and bool(torch.isfinite(r["losses"]).all()),
              f"{phase} round {r['round']}: losses {r['losses']}")
        for name, want in per_round[min(r["round"], 1)].items():
            check(r["launches"][name] == want,
                  f"{phase} round {r['round']}: {name} launched "
                  f"{r['launches'][name]} times, expected {want}")
        if r["round"] == 0:
            got = {k: v for k, v in r["routes"]["galore_precond_step"]
                   .items() if v}
            want = {"right": 2 * NLU_CLIENTS * steps,
                    "left": NLU_CLIENTS * steps}
            check(got == want, f"{phase} round 0: galore_precond_step "
                  f"routes {got}, expected {want}")
        check(r["routes"]["jacobi_eigh"]["warp"]
              == r["launches"]["jacobi_eigh"],
              f"{phase} round {r['round']}: an 𝒮 bucket left the warp "
              "route")
    for name in launches:
        in_rounds = sum(r["launches"][name] for r in rl.rounds)
        want = flash if name == "flash_attention" else in_rounds
        if name in ("galore_adamw_step", "lowrank_linear_batched",
                    "rwkv6_scan", "rwkv6_scan_bwd"):
            want = 0
        check(launches[name] == want, f"{phase}: {name} launched "
              f"{launches[name]} times, expected {want}")
    _check_tc_routes(phase, launches, routes)


def _backbone_parity(phase, rl, plain_rl, bound, first):
    """Kernel rounds against the same rounds with every kernel's plain
    version: per-step losses, and the change D = leaf - init of the global
    target leaves over all rounds, with two controls that drop a round's
    update (the last round's, round 0's) and must read above ``bound``.
    The loss control: round 1's first-step losses at the initial leaves
    (``first["init"]``: round 0's update lost) against the plain run's
    must read above TRAIN_LOSS_BOUND; ``first["round0"]``, at the kernel
    run's leaves after round 0, is its sound reading."""
    for r in plain_rl.rounds:
        check(sum(r["launches"].values()) == 0,
              f"{phase}: the plain run launched kernels: {r['launches']}")
    init = plain_rl.snaps[0]
    check(all(torch.equal(a, b) for a, b in zip(rl.snaps[0], init)),
          f"{phase}: the kernel and plain runs did not start from the same "
          "weights")
    loss_diff = max((a["losses"] - b["losses"]).abs().max().item()
                    for a, b in zip(rl.rounds, plain_rl.rounds))
    final, want = rl.snaps[-1], plain_rl.snaps[-1]
    delta_rel, delta_max_rel = _change_rel(final, want, init)
    no_round0 = [f.float() - (r0.float() - i.float()) for f, r0, i in
                 zip(final, rl.snaps[1], init)]
    controls = {"last_round_dropped": _change_rel(rl.snaps[-2], want,
                                                  init)[0],
                "round0_dropped": _change_rel(no_round0, want, init)[0]}
    plain1 = plain_rl.rounds[1]["losses"][:, 0]
    loss_controls = {k: (first[k] - plain1).abs().max().item()
                     for k in ("round0", "init")}
    emit({"phase": phase + "_parity", "rounds": len(rl.rounds),
          "max_abs_loss_diff": loss_diff, "loss_bound": TRAIN_LOSS_BOUND,
          "loss_controls": {"sound": loss_controls["round0"],
                            "round0_dropped": loss_controls["init"]},
          "delta_rel_fro": delta_rel, "delta_bound": bound,
          "delta_rel_max": delta_max_rel, "controls": controls,
          "plain_round_s": [r["seconds"] for r in plain_rl.rounds]})
    check(loss_diff <= TRAIN_LOSS_BOUND, f"{phase}: losses differ by "
          f"{loss_diff} > {TRAIN_LOSS_BOUND}")
    check(delta_rel <= bound, f"{phase}: the rounds' change of the global "
          f"leaves differs by {delta_rel} of its norm > {bound}")
    check(min(controls.values()) > bound, f"{phase}: a control with a "
          f"round's update dropped reads {controls}, not above the bound "
          f"{bound}: the check cannot see it")
    check(loss_controls["init"] > TRAIN_LOSS_BOUND, f"{phase}: round 1's "
          f"losses with round 0's update lost differ by "
          f"{loss_controls['init']}, not above the loss bound "
          f"{TRAIN_LOSS_BOUND}: the check cannot see it")


def _load_example(name):
    """A module of ``examples/`` (not a package) by its file name."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain_or_kernels(plain):
    from repro_torch.kernels import ops
    return ops.plain_kernels() if plain else contextlib.nullcontext()


def _first_step_controls(engine, rl):
    """Round 1's first-step losses at the leaves after round 0 and at the
    initial ones (``_backbone_parity``'s loss control)."""
    return {k: _first_step_losses(engine, rl.snaps[i], rl.batches[1])
            for k, i in (("round0", 1), ("init", 0))}


def _run_nlu(plain):
    """The paper's NLU example, ``main(["--rounds", "3"])``, logged, and
    the kernel run's loss control (None for the plain run)."""
    example = _load_example("federated_finetune_100m_torch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _plain_or_kernels(plain), RoundLog() as rl, \
            ShapeLog(BACKBONE_LOG) as sl:
        rows, engine = example.main(["--rounds", str(NLU_ROUNDS)])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    first = None if plain else _first_step_controls(engine, rl)
    del engine
    return rows, rl, sl.seen, seconds, first


def phase_train_roberta(card, checked):
    """paper-roberta-like through the example's entry point: three
    FedGaLore rounds and two evaluations, counted, then again with the
    plain versions for parity. The example seeds its weights and data
    with 0 whatever ``--seed``."""
    from repro_torch.configs import get_config
    cfg = get_config("paper-roberta-like")
    check(cfg.param_dtype == torch.bfloat16
          and cfg.n_layers == FULL_LAYERS[cfg.name]
          and cfg.pos_emb == "sinusoidal",
          "paper-roberta-like is not the full-width bf16 sinusoidal config")
    torch.cuda.reset_peak_memory_stats()
    rows, rl, seen, seconds, first = _run_nlu(plain=False)
    launches, routes = rl.launches, rl.routes
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_backbone_path("train_roberta", rl, seen, checked,
                         nlu_launches(NLU_STEPS), NLU_STEPS, launches,
                         routes, NLU_FLASH)
    check(len(rows) == 2 and all(np.isfinite(r["val_loss"]) for r in rows),
          f"train_roberta: evaluation rows {rows}")
    for r in rl.rounds:
        emit({"phase": "train_roberta", "arch": cfg.name, "card": card,
              "round": r["round"], "clients": NLU_CLIENTS,
              "local_steps": NLU_STEPS, "batch": NLU_B, "seq": NLU_L,
              "rank": TRAIN_R, "round_s": r["seconds"],
              "tokens_per_s": NLU_CLIENTS * NLU_STEPS * NLU_B * NLU_L
              / r["seconds"], "launches": r["launches"],
              "routes": r["routes"], "losses": r["losses"].tolist()})
    emit({"phase": "train_roberta", "arch": cfg.name, "card": card,
          "params": cfg.param_count(), "eval_rows": rows,
          "main_s": seconds, "launches": launches, "routes": routes,
          "peak_gib": peak,
          "kernel_shapes": {k: sorted(v) for k, v in seen.items()}})
    plain_rl = _run_nlu(plain=True)[1]
    _backbone_parity("train_roberta", rl, plain_rl, NLU_DELTA_BOUND, first)
    del rl, plain_rl
    torch.cuda.empty_cache()
    return launches, routes


def _run_vit(seed, plain):
    """Two FedGaLore rounds of paper-vit-like on the patch task, each
    followed by ``FedEngine.evaluate`` (no autograd graph), logged, and
    the kernel run's loss control (None for the plain run)."""
    from repro_torch.core.fed import FedConfig, FedEngine
    from repro_torch.data import FederatedBatcher, patch_classification
    from repro_torch.launch.steps import galore_target_fn
    from repro_torch.models import model as model_lib
    cfg = _full_config("paper-vit-like")
    params = model_lib.init_params(cfg, seed=seed, device="cuda")
    task = patch_classification(VIT_EXAMPLES, VIT_CLASSES, VIT_PATCHES,
                                cfg.d_model, cfg.vocab_size, seed=seed,
                                text_len=VIT_TEXT)
    batcher = FederatedBatcher(task, NLU_CLIENTS, VIT_B, alpha=0.5,
                               seed=seed)
    engine = FedEngine(
        FedConfig(method="fedgalore", rank=TRAIN_R, lr=TRAIN_LR,
                  local_steps=VIT_STEPS, seed=seed),
        loss_fn=lambda p, b: model_lib.loss_fn(p, cfg, b), params=params,
        target_fn=galore_target_fn(cfg))
    ev = batcher.eval_batch(VIT_EVAL)
    evals = []
    with _plain_or_kernels(plain), RoundLog() as rl, \
            ShapeLog(BACKBONE_LOG) as sl:
        for _ in range(VIT_ROUNDS):
            engine.run_round(batcher.round_batches(VIT_STEPS))
            evals.append(engine.evaluate(ev))
        torch.cuda.synchronize()
    first = None if plain else _first_step_controls(engine, rl)
    del engine, params
    return cfg, rl, sl.seen, evals, first


def phase_train_vit(seed, card, checked):
    """paper-vit-like: two FedGaLore rounds whose batches carry the 196
    patch embeddings, counted, then again with the plain versions."""
    torch.cuda.reset_peak_memory_stats()
    cfg, rl, seen, evals, first = _run_vit(seed, plain=False)
    launches, routes = rl.launches, rl.routes
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_backbone_path("train_vit", rl, seen, checked,
                         nlu_launches(VIT_STEPS), VIT_STEPS, launches,
                         routes, VIT_FLASH)
    check(all(np.isfinite(e) for e in evals), f"train_vit: evaluation "
          f"losses {evals}")
    for r in rl.rounds:
        emit({"phase": "train_vit", "arch": cfg.name, "card": card,
              "round": r["round"], "clients": NLU_CLIENTS,
              "local_steps": VIT_STEPS, "batch": VIT_B,
              "seq": f"{VIT_PATCHES} patches + {VIT_TEXT} tokens",
              "rank": TRAIN_R, "round_s": r["seconds"],
              "tokens_per_s": NLU_CLIENTS * VIT_STEPS * VIT_B * VIT_L
              / r["seconds"], "launches": r["launches"],
              "routes": r["routes"], "losses": r["losses"].tolist()})
    _, plain_rl, _, plain_evals, _ = _run_vit(seed, plain=True)
    emit({"phase": "train_vit", "arch": cfg.name, "card": card,
          "params": cfg.param_count(), "eval_losses": evals,
          "plain_eval_losses": plain_evals, "launches": launches,
          "routes": routes, "peak_gib": peak,
          "kernel_shapes": {k: sorted(v) for k, v in seen.items()}})
    _backbone_parity("train_vit", rl, plain_rl, TRAIN_DELTA_BOUND, first)
    del rl, plain_rl
    torch.cuda.empty_cache()
    return launches, routes


RWKV_LOG = {**TRAIN_LOG, "_rwkv": {"rwkv6_scan": _scan_key,
                                   "rwkv6_scan_bwd": _scan_bwd_key}}


def _run_rwkv(seed, lr=RWKV_LR, method="fedgalore", modes=("kernel",) * 2,
              bump_embed=False):
    """Rounds of ``method`` on full-width rwkv6-1.6b at phase_train's
    traffic and lr ``lr``, logged, one a ``modes`` entry: "kernel",
    "plain" (every kernel's plain version) or a function that gives the
    context to run that round in. Returns the config, the RoundLog (its
    ``synced`` 𝒮's output after each round), the shapes seen and the
    engine."""
    cfg, engine, batcher = _train_setup(seed, method, arch="rwkv6-1.6b",
                                        bump_embed=bump_embed, lr=lr)
    synced = []
    with RoundLog() as rl, ShapeLog(RWKV_LOG) as sl:
        for mode in modes:
            with (mode() if callable(mode)
                  else _plain_or_kernels(mode == "plain")):
                engine.run_round(batcher.round_batches(LOCAL_STEPS))
            synced.append(engine.synced_v)
        torch.cuda.synchronize()
    rl.synced = synced
    return cfg, rl, sl.seen, engine


def _rwkv_rounds(*args, **kw):
    """The RoundLog of ``_run_rwkv(*args, **kw)``, its engine freed."""
    rl = _run_rwkv(*args, **kw)[1]
    torch.cuda.empty_cache()
    return rl


def _check_rwkv_path(phase, rl, seen, checked, per_round):
    """The rwkv rounds went through their kernels: every launched shape
    checked, each round's launches as ``per_round`` states (by round,
    the last entry for later rounds; every other kernel 0), round 0's
    GaLore buckets on their routes, 𝒮 on the warp route, the low-rank
    applies on the tensor cores."""
    for name, keys in seen.items():
        check(keys <= checked.get(name, set()), f"{phase}: the path "
              f"launched {name} at shapes the checks did not cover: "
              f"{sorted(keys - checked.get(name, set()))}")
    for r in rl.rounds:
        check(tuple(r["losses"].shape) == (CLIENTS, LOCAL_STEPS)
              and bool(torch.isfinite(r["losses"]).all()),
              f"{phase} round {r['round']}: losses {r['losses']}")
        want = per_round[min(r["round"], len(per_round) - 1)]
        _check_launches(f"{phase} round {r['round']}", r["launches"], want)
        _check_tc_routes(f"{phase} round {r['round']}", r["launches"],
                         r["routes"])
        if want.get("galore_precond_step"):
            got = {k: v for k, v in r["routes"]["galore_precond_step"]
                   .items() if v}
            check(got == EXPECTED_GALORE_ROUTES, f"{phase} round "
                  f"{r['round']}: galore_precond_step routes {got}, "
                  f"expected {EXPECTED_GALORE_ROUTES}")
        check(r["routes"]["jacobi_eigh"]["warp"]
              == r["launches"]["jacobi_eigh"],
              f"{phase} round {r['round']}: an 𝒮 bucket left the warp "
              "route")


def _emit_rounds(phase, cfg, card, rl, peak):
    for r in rl.rounds:
        emit({"phase": phase, "arch": cfg.name, "card": card,
              "round": r["round"], "clients": CLIENTS,
              "local_steps": LOCAL_STEPS, "batch": TRAIN_B, "seq": TRAIN_L,
              "rank": TRAIN_R, "round_s": r["seconds"],
              "tokens_per_s": CLIENTS * LOCAL_STEPS * TRAIN_B * TRAIN_L
              / r["seconds"], "launches": r["launches"],
              "routes": r["routes"], "losses": r["losses"].tolist(),
              "peak_gib": peak})


def _loss_diff(a, b):
    return max((x["losses"] - y["losses"]).abs().max().item()
               for x, y in zip(a.rounds, b.rounds))


def _tree_rel(got, want):
    """‖got − want‖_F / ‖want‖_F over all leaves of two trees."""
    from repro_torch.utils import tree
    num = den = 0.0
    for g, w in zip(tree.tree_leaves(got), tree.tree_leaves(want)):
        num += float(torch.sum((g.float() - w.float()) ** 2))
        den += float(torch.sum(w.float() ** 2))
    return (num / max(den, 1e-30)) ** 0.5


def _ulp_moved(t, gen):
    """``t`` with each entry one unit in the last place up or down, at
    random from ``gen``."""
    up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
    return torch.nextafter(t, torch.where(up, float("inf"),
                                          float("-inf")).to(t.dtype))


def _sync_again(engine, seed=None):
    """The engine's last 𝒮 run again with every kernel's plain version on
    the same client states (the round's moments, kept by the engine) or,
    given ``seed``, on them with each floating entry one ulp up or down
    at random: 𝒮's own rounding floor."""
    from repro_torch.kernels import ops
    from repro_torch.utils import tree
    opt = engine._client_opt
    if seed is not None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        opt = tree.tree_map(
            lambda x: _ulp_moved(x, gen) if torch.is_tensor(x)
            and x.is_floating_point() else x, opt)
    with ops.plain_kernels():
        return engine._sync_states(opt,
                                   engine._normalize_weights(None, CLIENTS),
                                   engine.round_idx - 1)


def rwkv_parity_readings(seed, lr=RWKV_LR):
    """The two fedgalore rounds of rwkv6-1.6b at ``lr`` through the
    kernels, with every plain version and with 1 % of the embedding table
    one bf16 ulp up; round 0 once more with the plain versions and the
    GaLore preconditioner in float64 (``_exact_precond``). Returns the
    kernel run (config, RoundLog, shapes seen), the plain run's RoundLog
    and the readings: per-step loss differences and D (the rounds' change
    of the target leaves, relative to the plain run's) of the kernel run
    and of the embedding-ulp control; D of round 0 alone against the
    plain run and against the float64 one ("_vs_f64", beside the plain
    run's own distance from it); round 1's 𝒮 run again with the plain
    versions on the kernel run's own client states ("sync_round1"),
    beside 𝒮's rounding floor on them and the stale ṽ of round 0
    ("sync_round1_lost"); the dropped-round controls on D; the loss
    control (round 1's first step at the leaves after round 0, "round0",
    and at the initial ones, "init"); whether round 0's first step
    repeats bit for bit; and the kernel run's peak memory."""
    torch.cuda.reset_peak_memory_stats()
    cfg, rl, seen, engine = _run_rwkv(seed, lr)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first = _first_step_controls(engine, rl)
    sync_plain = _sync_again(engine)
    sync_floor = _tree_rel(_sync_again(engine, seed + 11), sync_plain)
    del engine
    torch.cuda.empty_cache()
    plain = _rwkv_rounds(seed, lr, modes=("plain",) * 2)
    ulp = _rwkv_rounds(seed, lr, bump_embed=True)
    exact = _rwkv_rounds(seed, lr, modes=(_exact_precond,))
    init, want = plain.snaps[0], plain.snaps[-1]
    start = rl.snaps[1]

    def delta(run, ref=plain):
        return _change_rel(run.snaps[-1], ref.snaps[-1], init)[0]

    no_round0 = [f.float() - (r0.float() - i.float())
                 for f, r0, i in zip(rl.snaps[-1], start, init)]
    plain1 = plain.rounds[1]["losses"][:, 0]
    readings = {
        "lr": lr,
        "first_step_bit_identical": torch.equal(
            rl.rounds[0]["losses"][:, 0], plain.rounds[0]["losses"][:, 0]),
        "loss": _loss_diff(rl, plain), "delta": delta(rl),
        "delta_round0": _change_rel(start, plain.snaps[1], init)[0],
        "delta_round0_vs_f64": _change_rel(start, exact.snaps[1], init)[0],
        "sync_round1": _tree_rel(rl.synced[1], sync_plain),
        "sync_round1_floor": sync_floor,
        "loss_controls": {k: (first[k] - plain1).abs().max().item()
                          for k in ("round0", "init")},
        "controls": {
            "embed_ulp": {"loss": _loss_diff(ulp, rl),
                          "delta": delta(ulp, rl),
                          "delta_round0": _change_rel(
                              ulp.snaps[1], start, init)[0]},
            "last_round_dropped": _change_rel(rl.snaps[-2], want, init)[0],
            "round0_dropped": _change_rel(no_round0, want, init)[0],
            "round0_lost": _change_rel(init, plain.snaps[1], init)[0],
            "plain_vs_f64_round0": _change_rel(plain.snaps[1],
                                               exact.snaps[1], init)[0],
            "sync_round1_lost": _tree_rel(rl.synced[0], sync_plain)},
        "largest_step_drop": max(
            (r["losses"][:, 0] - r["losses"][:, -1]).max().item()
            for r in rl.rounds),
        "plain_round_s": [r["seconds"] for r in plain.rounds],
        "f64_round_s": exact.rounds[0]["seconds"],
        "kernel_peak_gib": peak}
    return cfg, rl, seen, plain, readings


def phase_train_rwkv(seed, card, checked):
    """rwkv6-1.6b in training at full width: two fedgalore rounds and one
    fedit round through FedEngine.run_round, counted per round, each
    against the same rounds with every kernel's plain version.

    Gated (RWKV_LR and the gates stated at the top): fedgalore round 0's
    first local step losses bit for bit the plain run's (the forward
    through rwkv6_scan and dense weights); every per-step loss within the
    loss gate, max(TRAIN_LOSS_BOUND, the embedding-ulp control's loss
    reading), and the loss control (round 1's first-step losses with
    round 0's update lost) above it; D of round 0 against the run
    with a float64 preconditioner within max(TRAIN_DELTA_BOUND, the fp32
    plain run's own D against it), round 0 lost above it; round 1's 𝒮 within max(RWKV_SYNC_TOL, 𝒮's own rounding
    floor) of the plain 𝒮 on the same client states, the stale ṽ above
    it; the fedit round, whose only kernels are the scan pair, bit for
    bit the plain run's losses and leaves. D against the plain run (of
    round 0, of both rounds) is reported beside its controls, not gated:
    at this model's rounding floor it reads near a lost round (PERF.md,
    ``scripts/rwkv_train_floor.py``, which also reads round 1 alone).
    Returns the kernel runs' launches and routes."""
    cfg, rl, seen, plain, got = rwkv_parity_readings(seed)
    peak = got["kernel_peak_gib"]
    _check_rwkv_path("train_rwkv", rl, seen, checked,
                     [RWKV_TRAIN_LAUNCHES[0], RWKV_TRAIN_LAUNCHES[1]])
    _emit_rounds("train_rwkv", cfg, card, rl, peak)
    check(all(bool(torch.isfinite(x.float()).all()) for x in rl.snaps[-1]),
          "train_rwkv: non-finite global leaves after two rounds")
    emit({"phase": "train_rwkv", "arch": cfg.name, "card": card,
          "params": cfg.param_count(), "lr": RWKV_LR, "peak_gib": peak,
          "kernel_shapes": {k: sorted(v) for k, v in seen.items()}})
    for r in plain.rounds:
        check(sum(r["launches"].values()) == 0,
              f"train_rwkv: the plain run launched kernels: {r['launches']}")
    check(all(torch.equal(a, b) for a, b in zip(rl.snaps[0], plain.snaps[0])),
          "train_rwkv: the kernel and plain runs did not start from the same "
          "weights")
    loss_gate = max(TRAIN_LOSS_BOUND, got["controls"]["embed_ulp"]["loss"])
    ctl = got["controls"]
    emit({"phase": "train_rwkv_parity", "rounds": 2, **got,
          "loss_bound": TRAIN_LOSS_BOUND, "loss_gate": loss_gate,
          "delta_bound": TRAIN_DELTA_BOUND, "sync_tol": RWKV_SYNC_TOL,
          "delta_round0_gate": max(TRAIN_DELTA_BOUND,
                                   got["controls"]["plain_vs_f64_round0"]),
          "sync_gate": max(RWKV_SYNC_TOL, got["sync_round1_floor"]),
          "gated": ["first_step_bit_identical", "loss",
                    "delta_round0_vs_f64", "sync_round1"]})
    check(got["first_step_bit_identical"], "train_rwkv: round 0's first-step "
          "losses differ from the plain run's")
    check(got["loss"] <= loss_gate, f"train_rwkv: losses differ by "
          f"{got['loss']} > {loss_gate}")
    check(got["loss_controls"]["init"] > loss_gate, f"train_rwkv: round 1's "
          f"losses with round 0's update lost differ by "
          f"{got['loss_controls']['init']}, not above the loss gate "
          f"{loss_gate}: the check cannot see it")
    d_gate = max(TRAIN_DELTA_BOUND, ctl["plain_vs_f64_round0"])
    check(got["delta_round0_vs_f64"] <= d_gate, f"train_rwkv: round 0's "
          f"change of the leaves is {got['delta_round0_vs_f64']} from the "
          f"float64 run's > {d_gate}")
    check(ctl["round0_lost"] > d_gate, f"train_rwkv: round 0 lost reads "
          f"{ctl['round0_lost']}, not above {d_gate}")
    sync_gate = max(RWKV_SYNC_TOL, got["sync_round1_floor"])
    check(got["sync_round1"] <= sync_gate, f"train_rwkv: round 1's 𝒮 is "
          f"{got['sync_round1']} from its plain version > {sync_gate}")
    check(ctl["sync_round1_lost"] > sync_gate, f"train_rwkv: the stale ṽ "
          f"reads {ctl['sync_round1_lost']}, not above {sync_gate}")
    launches, routes = rl.launches, rl.routes
    del rl, plain
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    cfg, frl, fseen, engine = _run_rwkv(seed, method="fedit",
                                        modes=("kernel",))
    del engine
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_rwkv_path("train_rwkv_fedit", frl, fseen, checked,
                     [RWKV_FEDIT_LAUNCHES])
    _emit_rounds("train_rwkv_fedit", cfg, card, frl, peak)
    fplain = _rwkv_rounds(seed, method="fedit", modes=("plain",))
    same = (torch.equal(frl.rounds[0]["losses"], fplain.rounds[0]["losses"])
            and all(torch.equal(a, b)
                    for a, b in zip(frl.snaps[-1], fplain.snaps[-1])))
    emit({"phase": "train_rwkv_fedit_parity", "bit_identical": same,
          "max_abs_loss_diff": _loss_diff(frl, fplain),
          "delta_rel_fro": _change_rel(frl.snaps[-1], fplain.snaps[-1],
                                       fplain.snaps[0])[0],
          "plain_round_s": [r["seconds"] for r in fplain.rounds]})
    check(same, "train_rwkv_fedit: the round through the scan pair is not "
          "bit for bit the plain run's")
    for k in launches:
        launches[k] += frl.launches[k]
        for rt, n in frl.routes.get(k, {}).items():
            routes[k][rt] = routes[k].get(rt, 0) + n
    del frl, fplain
    torch.cuda.empty_cache()
    return launches, routes


def _bound(nbytes, flops_by_peak):
    bytes_s = nbytes / PEAK_BYTES
    ops_s = sum(f / p for f, p in flops_by_peak)
    return (max(bytes_s, ops_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


MARK = "spin_kernel"         # torch.cuda._sleep's kernel


def profiled_ms(fn, sets, calls=5, counter=None):
    """The device time of the CUDA kernels one call of ``fn`` launches,
    summed (copies, memsets and markers left out), by ``torch.profiler``.
    One session holds two warm-up calls, then ``calls`` calls, each after
    a marker kernel (``torch.cuda._sleep``), and one marker more; the
    kernels between two markers, in device order, are one call's. Returns
    ``ms`` (the median over the calls that showed a kernel, None if none
    did), ``kernels`` seen per call, ``launches`` per call as the wrapper
    ``counter`` counted them (None without one) and ``markers`` seen
    (``calls`` + 1 when the trace lost none)."""
    from torch.profiler import ProfilerActivity, profile
    launches = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in sets[:2]:
            fn(c)
        for i in range(calls):
            torch.cuda._sleep(1000)
            before = counter.launches if counter is not None else 0
            fn(sets[i % len(sets)])
            launches.append(None if counter is None
                            else counter.launches - before)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))),
                     key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(kernels) if MARK in e.name]
    per_call = [kernels[i + 1:j] for i, j in zip(marks, marks[1:])]
    times = [sum(e.time_range.elapsed_us() for e in ks) / 1e3
             for ks in per_call if ks]
    return {"ms": float(np.median(times)) if times else None,
            "kernels": [len(ks) for ks in per_call],
            "launches": launches if counter is not None else None,
            "markers": len(marks)}


def _timed(row, fns, sets, no_graph=(), warmup=5, iters=40, calls=20,
           replays=5):
    """Eager ms of each function; device ms from a CUDA graph except for
    the keys in ``no_graph`` (calls that synchronise with the host cannot
    be captured), which get None."""
    for key, fn in fns.items():
        if fn is None:
            row[key] = row["device_" + key] = None
            continue
        row[key] = time_ms(fn, sets, warmup, iters)
        row["device_" + key] = None if key in no_graph else \
            graph_ms(fn, sets, calls, replays)
    return row


def galore_times(gen, card):
    """The GaLore kernel, its plain version and one local step's update,
    timed (rows as phase_train_times')."""
    from repro_torch.kernels import galore_adamw as ga
    from repro_torch.kernels import ref
    rows = []
    c1, c2 = ga.bias_corrections(3, 0.9, 0.999)
    # galore_precond_step at the path's three buckets in both modes:
    # PRECOND_UT (round 0 of the factored round) and PRECOND_U (the
    # dense-client round's step, the eager oracle), fp32 g (the path: the
    # clip leaves the gradients in fp32) and bf16 g (an unclipped step).
    # Bound: g read in its own type, the basis, m and v read, m' and v'
    # written, and ũ (PRECOND_UT) or u, fp32 M x N (PRECOND_U), written;
    # operations: the projection, and the lift in PRECOND_U.
    for mode, (lead, mm, nn), dtype in itertools.product(
            (ga.PRECOND_UT, ga.PRECOND_U),
            (((4, 24), 1024, 1024), ((2, 24), 1024, 2816),
             ((1, 24), 2816, 1024)), (torch.float32, torch.bfloat16)):
        back = mode == ga.PRECOND_U
        sets = [_precond_case(gen, lead, mm, nn, dtype=dtype)
                for _ in range(2)]
        c = sets[0]
        blocks = int(np.prod(lead))
        nbytes = (c["g"].numel() * c["g"].element_size()
                  + 4 * (c["basis"].numel() + (4 if back else 5)
                         * c["m"].numel())
                  + (4 * c["g"].numel() if back else 0))
        b_ms, b_by = _bound(nbytes, [((4.0 if back else 2.0) * blocks * mm
                                      * nn * TRAIN_R, PEAK_FP32)])
        p = ga.plan(c["side"], mm, nn, TRAIN_R, dtype, mode, batch=blocks)
        row = {"phase": "train_times", "kernel": "galore_precond_step",
               "card": card, "g": list(c["g"].shape),
               "g_dtype": str(dtype).split(".")[1],
               "on_path": dtype == torch.float32,
               "path": "dense-client round" if back else "round 0",
               "project_back": back, "route": p.route, "grid": list(p.grid),
               "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
               "library": "no single call"}
        _timed(row, {
            "ms": lambda c, back=back: ga.galore_precond_step(
                c["g"], c["basis"], c["m"], c["v"], 3, side=c["side"],
                project_back=back),
            "plain_ms": lambda c, back=back: ref.galore_precond_ref(
                c["g"], c["basis"], c["m"], c["v"], c1=c1, c2=c2,
                side=c["side"], project_back=back),
            "library_ms": None}, sets)
        row["device_gb_s"] = nbytes / row["device_ms"] / 1e6
        row["of_bound"] = b_ms / row["device_ms"]
        rows.append(row)
        emit(row)
        del sets
    for dtype in (torch.float32, torch.bfloat16):
        sets = [_precond_case(gen, (24,), 2816, 1024, dtype=dtype)
                for _ in range(2)]
        for c in sets:
            c["w"] = (0.02 * torch.randn(c["g"].shape, generator=gen,
                                         device="cuda")).to(torch.bfloat16)
        c = sets[0]
        nbytes = (c["g"].numel() * c["g"].element_size()
                  + 4 * (c["basis"].numel() + 4 * c["m"].numel())
                  + 2 * 2 * c["w"].numel())
        b_ms, b_by = _bound(nbytes,
                            [(4.0 * c["g"].numel() * TRAIN_R, PEAK_FP32)])
        row = {"phase": "train_times", "kernel": "galore_adamw_step",
               "card": card, "w": list(c["w"].shape), "w_dtype": "bfloat16",
               "g_dtype": str(dtype).split(".")[1],
               "on_path": dtype == torch.float32,
               "route": ga.plan("right", 2816, 1024, TRAIN_R, dtype,
                                ga.ADAMW, batch=24,
                                w_dtype=torch.bfloat16).route,
               "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
               "library": "no single call"}
        _timed(row, {
            "ms": lambda c: ga.galore_adamw_step(
                c["w"], c["g"], c["basis"], c["m"], c["v"], 3,
                side=c["side"]),
            "plain_ms": lambda c: ref.galore_adamw_ref(
                c["w"], c["g"], c["basis"], c["m"], c["v"], c1=c1, c2=c2,
                side=c["side"]),
            "library_ms": None}, sets)
        row["device_gb_s"] = nbytes / row["device_ms"] / 1e6
        row["of_bound"] = b_ms / row["device_ms"]
        rows.append(row)
        emit(row)
        del sets
    for row in galore_update_rows(gen, card):
        emit(row)
    return rows


def phase_train_times(gen, card):
    """Each training kernel, its plain version and the library call at the
    path's shapes; the bound from each call's bytes and operations."""
    from repro_torch.kernels import batched_eigh as be
    from repro_torch.kernels import galore_adamw as ga
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels import ref
    rows = []
    c1, c2 = ga.bias_corrections(3, 0.9, 0.999)
    for (m, n), per_layer in TRAIN_SHAPES.items():
        per = 2 * (m * n + TRAIN_B * TRAIN_L * (m + n))
        sets = [_lowrank_case(gen, (TRAIN_B, TRAIN_L), m, n, torch.bfloat16)
                for _ in range(max(2, -(-150_000_000 // per)))]
        c = sets[0]
        rows_ = TRAIN_B * TRAIN_L
        b_ms, b_by = _bound(
            2 * (c["x"].numel() + c["w"].numel() + rows_ * n)
            + 4 * (c["basis"].numel() + c["rt"].numel()),
            [(2.0 * rows_ * m * n, PEAK_BF16),
             (2.0 * rows_ * TRAIN_R * (m + n), PEAK_FP32)])
        before = dict(ll.lowrank_linear.routes)
        ll.lowrank_linear(c["x"], c["w"], c["basis"], c["rt"], c["scale"],
                          side=c["side"])
        row = {"phase": "train_times", "kernel": "lowrank_linear",
               "card": card, "x": [TRAIN_B, TRAIN_L, m], "w": [m, n],
               "route": _route_taken(ll.lowrank_linear, before),
               "per_layer": per_layer, "bound_ms": b_ms, "bound_by": b_by,
               "library": "torch.matmul(x, W), base product only"}
        rows.append(_timed(row, {
            "ms": lambda c: ll.lowrank_linear(c["x"], c["w"], c["basis"],
                                              c["rt"], c["scale"],
                                              side=c["side"]),
            "plain_ms": lambda c: ref.lowrank_linear_ref(
                c["x"], c["w"], c["basis"], c["rt"], c["scale"],
                side=c["side"]),
            "library_ms": lambda c: torch.matmul(c["x"], c["w"])}, sets))
        emit(rows[-1])
        del sets
    rows += galore_times(gen, card)
    # jacobi_eigh: the three 𝒮 buckets of the path, then two shapes
    # recorded beside them (rank 16; a 64-client cohort, 6,144 matrices)
    eigh_cases = [((4, 24, CLIENTS), TRAIN_R, True),
                  ((24, CLIENTS), TRAIN_R, True),
                  ((2, 24, CLIENTS), TRAIN_R, True),
                  ((4, 24, CLIENTS), 16, False),
                  ((4, 24, 64), TRAIN_R, False)]
    for lead, n, on_path in eigh_cases:
        sets = [_spd_case(gen, lead, n) for _ in range(2)]
        batch = int(np.prod(lead))
        m_ = n + (n & 1)
        steps = 12 * (m_ - 1)
        pairs = m_ // 2
        flops = batch * steps * (3 * 6 * n * pairs + 3 * n * n)
        b_ms, b_by = _bound(4 * batch * (2 * n * n + n),
                            [(flops, PEAK_FP32)])
        row = {"phase": "train_times", "kernel": "jacobi_eigh",
               "card": card, "a": list(lead) + [n, n], "on_path": on_path,
               "route": be.plan(n, batch).route,
               "layout": be.plan(n, batch).layout, "bound_ms": b_ms,
               "bound_by": b_by, "library": "torch.linalg.eigh"}
        rows.append(_timed(row, {
            "ms": lambda a: be.jacobi_eigh(a),
            "plain_ms": lambda a: ref.jacobi_eigh_ref(a),
            "library_ms": lambda a: torch.linalg.eigh(a)}, sets,
            no_graph=("library_ms",)))       # eigh checks its info on host
        # eigh cannot be captured in a graph: its device time is the time
        # of its CUDA kernels from the profiler, held against the kernel's
        # own time measured the same way (profiled_ms)
        lib = profiled_ms(torch.linalg.eigh, sets)
        own = profiled_ms(be.jacobi_eigh, sets, counter=be.jacobi_eigh)
        row.update(device_library_ms=lib["ms"], profiled_ms=own["ms"],
                   library_kernels=lib["kernels"],
                   library_markers=lib["markers"],
                   profiled_kernels=own["kernels"],
                   profiled_launches=own["launches"],
                   profiled_markers=own["markers"],
                   device_library_from=(
                       "torch.profiler: the CUDA kernels of one call "
                       "summed, median of 5 calls in one session split by "
                       "marker kernels, as profiled_ms for jacobi_eigh"))
        if own["kernels"] != own["launches"]:
            row["profiled_note"] = (
                f"the profiler saw {own['kernels']} kernels where the "
                f"wrapper launched {own['launches']}")
        if row["profiled_ms"] and row["device_ms"]:
            row["profiled_over_graph"] = row["profiled_ms"] / row["device_ms"]
        emit(rows[-1])
        del sets
    path = [r for r in rows if r["kernel"] == "jacobi_eigh" and r["on_path"]]
    emit({"phase": "train_times", "kernel": "jacobi_eigh", "card": card,
          "acceptance": {
              "graph_le_40us": all(r["device_ms"] <= 0.040 for r in path),
              "below_eigh": all(r["profiled_ms"] is not None
                                and r["device_library_ms"] is not None
                                and r["profiled_ms"]
                                < r["device_library_ms"] for r in path),
              "profiled_within_10pct_of_graph": all(
                  abs(r.get("profiled_over_graph", 9.0) - 1) <= 0.1
                  for r in path),
              "seen_on_all": all(r["profiled_kernels"]
                                 == r["profiled_launches"] for r in path),
              "one_s_graph_ms": sum(r["device_ms"] for r in path)}})
    return rows


# One round-0 local step's GaLore update at full width: the seven target
# leaves of qwen1.5-0.5b's 24 layers in their three buckets, rank 8, a step
# that does not refresh the basis.
GALORE_LEAVES = {"wq": (24, 1024, 1024), "wk": (24, 1024, 1024),
                 "wv": (24, 1024, 1024), "wo": (24, 1024, 1024),
                 "w_gate": (24, 1024, 2816), "w_up": (24, 1024, 2816),
                 "w_down": (24, 2816, 1024)}


def galore_update_rows(gen, card, iters=20):
    """Eager ms (CUDA events around back-to-back calls) of one local
    step's GaLore update through ``core.galore``: the bucket stacks, any
    cast and the three kernel launches, ``galore_transform_update`` with
    ``project_back=False`` on fp32 gradients (as the clip leaves them on
    the path) and on bf16 gradients (an unclipped step); and the whole
    optimizer step of the path, ``factored_adamw_step`` with clip_norm 1
    on bf16 gradients. It calls only ``core.galore``'s public functions,
    so it also times an earlier tree of the port."""
    from repro_torch.core import galore as gal
    cfg = gal.GaloreConfig(rank=TRAIN_R, refresh_every=10 ** 9)
    params = {k: (0.02 * torch.randn(v, generator=gen, device="cuda"))
              .to(torch.bfloat16) for k, v in GALORE_LEAVES.items()}
    state = gal.galore_init(cfg, params, target_fn=lambda path, p: True)
    state = state._replace(count=1)            # no refresh at this step
    grads = {k: (1e-3 * torch.randn(v.shape, generator=gen, device="cuda"))
             .to(torch.bfloat16) for k, v in params.items()}
    grads32 = {k: v.float() for k, v in grads.items()}
    deltas = gal.zero_client_deltas(state)
    scale = torch.ones((), device="cuda")
    fns = {
        "transform_update_fp32_grads": lambda: gal.galore_transform_update(
            cfg, grads32, state, project_back=False),
        "transform_update_bf16_grads": lambda: gal.galore_transform_update(
            cfg, grads, state, project_back=False),
        "factored_adamw_step_clipped_bf16_grads":
            lambda: gal.factored_adamw_step(
                cfg, grads, state, deltas, scale, lr=TRAIN_LR,
                weight_decay=0.01, clip_norm=1.0),
    }
    rows = []
    for name, fn in fns.items():
        ms = time_ms(lambda _: fn(), [None], warmup=5, iters=iters)
        rows.append({"phase": "train_times", "kernel": "galore_update",
                     "case": name, "card": card, "ms": ms,
                     "leaves": {k: list(v) for k, v in
                                GALORE_LEAVES.items()}})
    return rows


def _sum_rows(rows, kernel, weight=lambda r: 1):
    picked = [r for r in rows
              if r["kernel"] == kernel and r.get("on_path", True)]
    out = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                "device_plain_ms", "device_library_ms", "profiled_ms"):
        vals = [r.get(key) for r in picked]
        out[key] = (None if any(v is None for v in vals)
                    else sum(weight(r) * v for r, v in zip(picked, vals)))
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                      for r in picked) else "operations")
    return out



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    # every dense prefill's attention: qwen and starcoder2
    flash_err, flash_checked = phase_flash_kernel_checks(gen)

    # serving path, qwen1.5-0.5b
    max_err, checked = phase_kernel_checks(gen, SHAPES, edges=True)
    cfg, served, launches, routes = phase_serve(
        args.seed, card, {"lowrank_linear_batched": checked,
                          "flash_attention": flash_checked},
        "qwen1.5-0.5b", QWEN_PER_FORWARD, "serve",
        per_prefill=QWEN_PER_PREFILL)
    phase_parity(cfg, served, args.seed)
    phase_sampling(cfg, served, args.seed, card)
    del served
    torch.cuda.empty_cache()

    # serving path, rwkv6-1.6b (one model on the card at a time)
    rwkv_ll_err, rwkv_ll_checked = phase_kernel_checks(gen, RWKV_SHAPES)
    scan_err, scan_checked = phase_rwkv_kernel_checks(gen)
    cfg, served, rwkv_launches, rwkv_routes = phase_serve(
        args.seed, card, {"lowrank_linear_batched": rwkv_ll_checked,
                          "rwkv6_scan": scan_checked},
        "rwkv6-1.6b", RWKV_PER_FORWARD, "serve_rwkv", ragged=100)
    phase_parity(cfg, served, args.seed, phase="parity_rwkv")
    del served
    torch.cuda.empty_cache()

    # training path
    train_checked = phase_train_kernel_checks(gen, args.seed)
    rounds, snaps, train_launches = phase_train(args.seed, card,
                                                train_checked)
    train_controls = phase_train_parity(args.seed, rounds, snaps)
    phase_population_honest(args.seed, card, rounds, snaps)
    del snaps
    torch.cuda.empty_cache()
    svd_stack_check(args.seed, card)
    eager_rounds = phase_train_methods(args.seed, card, train_checked)
    torch.cuda.empty_cache()
    pop_rounds, pop_launches = phase_population(args.seed, card,
                                                train_checked, gen,
                                                train_controls)
    torch.cuda.empty_cache()

    # serving path, starcoder2-7b: 8 adapters, then one long prefill on the
    # base weights, each against the plain versions
    sc_ll_err, sc_ll_checked = phase_kernel_checks(gen, SC_SHAPES)
    cfg, served, sc_launches, sc_routes = phase_serve(
        args.seed, card, {"lowrank_linear_batched": sc_ll_checked,
                          "flash_attention": flash_checked},
        "starcoder2-7b", SC_PER_FORWARD, "serve_starcoder", ragged=100,
        per_prefill=SC_PER_PREFILL)
    phase_parity(cfg, served, args.seed, phase="parity_starcoder")
    del served
    torch.cuda.empty_cache()
    cfg, params, long_launches, long_routes = phase_long_prefill(
        args.seed, card, {"flash_attention": flash_checked})
    phase_parity(cfg, params, args.seed, phase="parity_starcoder",
                 batch=1, prompt=LONG_PROMPT, adapters=False)
    del params
    torch.cuda.empty_cache()

    # serving path, granite-moe-1b-a400m (MoE) and mistral-nemo-12b
    gr_err, gr_checked = phase_kernel_checks(gen, GRANITE_SHAPES)
    cfg, served, gr_launches, gr_routes = phase_serve(
        args.seed, card, {"lowrank_linear_batched": gr_checked,
                          "flash_attention": flash_checked},
        "granite-moe-1b-a400m", GRANITE_PER_FORWARD, "serve_granite",
        per_prefill=GRANITE_PER_PREFILL)
    phase_parity(cfg, served, args.seed, phase="parity_granite")
    del served
    torch.cuda.empty_cache()
    nemo_err, nemo_checked = phase_kernel_checks(gen, NEMO_SHAPES)
    cfg, served, nemo_launches, nemo_routes = phase_serve(
        args.seed, card, {"lowrank_linear_batched": nemo_checked,
                          "flash_attention": flash_checked},
        "mistral-nemo-12b", NEMO_PER_FORWARD, "serve_nemo",
        per_prefill=NEMO_PER_PREFILL, requests=NEMO_REQUESTS, new=NEMO_NEW)
    phase_parity(cfg, served, args.seed, phase="parity_nemo",
                 floor_gate=True)
    del served
    torch.cuda.empty_cache()

    # serving paths at their published widths with the depth cut
    # (CUT_LAYERS): deepseek-v2-236b (MLA + MoE) and jamba-1.5-large-398b
    # (the Mamba / attention hybrid)
    ds_err, ds_checked = phase_kernel_checks(gen, DS_SHAPES)
    cfg, served, ds_launches, ds_routes = phase_serve(
        args.seed, card, {"lowrank_linear_batched": ds_checked},
        "deepseek-v2-236b", DS_PER_FORWARD, "serve_deepseek",
        requests=CUT_REQUESTS, new=CUT_NEW)
    phase_parity(cfg, served, args.seed, phase="parity_deepseek",
                 floor_gate=True, controls=MOE_CONTROLS)
    phase_mla_decode_times(cfg, served, gen, card)
    del served
    torch.cuda.empty_cache()
    jb_err, jb_checked = phase_kernel_checks(gen, JAMBA_SHAPES,
                                             two_d=JAMBA_TWO_D)
    cfg, served, jb_launches, jb_routes = phase_serve(
        args.seed, card, {"lowrank_linear_batched": jb_checked,
                          "flash_attention": flash_checked},
        "jamba-1.5-large-398b", JAMBA_PER_FORWARD, "serve_jamba",
        per_prefill=JAMBA_PER_PREFILL, requests=CUT_REQUESTS, new=CUT_NEW)
    phase_parity(cfg, served, args.seed, phase="parity_jamba",
                 controls=MOE_CONTROLS, gate_flips=True)
    del served
    torch.cuda.empty_cache()
    phase_mamba_scan_times(gen, card)

    # training path, the paper's roberta and vit backbones
    backbone_checked = {name: train_checked[name][1] for name in
                        ("lowrank_linear", "galore_precond_step",
                         "jacobi_eigh")}
    backbone_checked["flash_attention"] = flash_checked
    nlu_launches_, nlu_routes = phase_train_roberta(card, backbone_checked)
    vit_launches, vit_routes = phase_train_vit(args.seed, card,
                                               backbone_checked)
    # training path, rwkv6-1.6b: the WKV backward, then the rounds
    bwd_err, bwd_checked = phase_rwkv_bwd_kernel_checks(gen)
    rwkv_checked = {name: train_checked[name][1] for name in
                    ("lowrank_linear", "galore_precond_step", "jacobi_eigh")}
    rwkv_checked.update(rwkv6_scan=scan_checked, rwkv6_scan_bwd=bwd_checked)
    rwkv_train = phase_train_rwkv(args.seed, card, rwkv_checked)
    backbone = {"train_roberta": (nlu_launches_, nlu_routes),
                "train_vit": (vit_launches, vit_routes),
                "train_rwkv": rwkv_train}

    rows = phase_times(gen, card)
    phase_times(gen, card, RWKV_SHAPES, "rwkv6-1.6b")
    phase_times(gen, card, SC_SHAPES, "starcoder2-7b")
    train_rows = phase_train_times(gen, card)
    scan_rows = phase_rwkv_times(gen, card)
    bwd_rows = phase_rwkv_bwd_times(gen, card)
    flash_rows = phase_flash_times(gen, card)

    decode = [r for r in rows if r["shape"] == "decode"]
    per_layer = {k: sum(LAYER_MIX[(r["m"], r["n"])] * r[k] for r in decode)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "device_ms", "device_plain_ms",
                           "device_library_ms")}
    timing = ("ms: CUDA events over back-to-back eager calls (host overhead "
              "included); device_ms: the same calls replayed from a CUDA "
              "graph")
    kernels = [{
        "name": "lowrank_linear_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lowrank_linear_batched.cu",
        "replaces": "src/repro/kernels/lowrank_linear.py:140",
        "launches": (launches["lowrank_linear_batched"]
                     + rwkv_launches["lowrank_linear_batched"]
                     + sc_launches["lowrank_linear_batched"]
                     + gr_launches["lowrank_linear_batched"]
                     + nemo_launches["lowrank_linear_batched"]
                     + ds_launches["lowrank_linear_batched"]
                     + jb_launches["lowrank_linear_batched"]),
        "launches_by_path": {
            "serve": launches["lowrank_linear_batched"],
            "serve_rwkv": rwkv_launches["lowrank_linear_batched"],
            "serve_starcoder": sc_launches["lowrank_linear_batched"],
            "serve_granite": gr_launches["lowrank_linear_batched"],
            "serve_nemo": nemo_launches["lowrank_linear_batched"],
            "serve_deepseek": ds_launches["lowrank_linear_batched"],
            "serve_jamba": jb_launches["lowrank_linear_batched"]},
        "launches_by_route": {
            k: sum(rt["lowrank_linear_batched"][k]
                   for rt in (routes, rwkv_routes, sc_routes, gr_routes,
                              nemo_routes, ds_routes, jb_routes))
            for k in routes["lowrank_linear_batched"]},
        "max_abs_err": max(max_err, rwkv_ll_err, sc_ll_err, gr_err,
                           nemo_err, ds_err, jb_err),
        "ms": per_layer["ms"], "plain_ms": per_layer["plain_ms"],
        "bound_ms": per_layer["bound_ms"], "bound_by": "bytes"
        if all(r["bound_by"] == "bytes" for r in decode) else "operations",
        "library_ms": per_layer["library_ms"],
        "device_ms": per_layer["device_ms"],
        "device_plain_ms": per_layer["device_plain_ms"],
        "device_library_ms": per_layer["device_library_ms"],
        "at": "one qwen1.5-0.5b layer of one decode step: 4x(1024x1024) + "
              "2x(1024x2816) + 1x(2816x1024), B=8, t=1, G=8, r=16, bf16; "
              + timing + "; library_ms is torch.matmul of the base "
              "products alone",
        "card": card}]
    train_entries = [
        ("lowrank_linear", "src/repro_torch/kernels/csrc/lowrank_linear.cu",
         "src/repro/kernels/lowrank_linear.py:82",
         lambda r: r["per_layer"],
         "one qwen1.5-0.5b layer of one lift-free training forward: "
         "4x(1024x1024) + 2x(1024x2816) + 1x(2816x1024), x (4, 128, m) "
         "bf16, r=8; library_ms is torch.matmul of the base products "
         "alone"),
        ("galore_precond_step", "src/repro_torch/kernels/csrc/galore_adamw.cu",
         "src/repro/kernels/galore_adamw.py:189", lambda r: 1,
         "one client's local step in each mode the path launches: round "
         "0's (PRECOND_UT, project_back=False) plus the dense-client "
         "round's (PRECOND_U, project_back=True), each the three shape "
         "buckets (4,24,1024,1024) + (2,24,1024,2816) + (1,24,2816,1024), "
         "g fp32 as the clip leaves it on the path (bf16 rows in "
         "train_times), r=8; by_mode splits launches and times by mode; "
         "no single library call computes it"),
        ("galore_adamw_step", "src/repro_torch/kernels/csrc/galore_adamw.cu",
         "src/repro/kernels/galore_adamw.py:145", lambda r: 1,
         "not on the path (tests only in the reference): w (24,2816,1024) "
         "bf16, g fp32, r=8; no single library call computes it"),
        ("jacobi_eigh", "src/repro_torch/kernels/csrc/batched_eigh.cu",
         "src/repro/kernels/batched_eigh.py:133", lambda r: 1,
         "one 𝒮 of the round: Phase-1 Grams (4,24,4,8,8) + (24,4,8,8) + "
         "(2,24,4,8,8); library_ms is torch.linalg.eigh on the same "
         "stacks, its device_library_ms the profiler's sum of its CUDA "
         "kernels (it cannot be graph-captured), beside profiled_ms, "
         "jacobi_eigh's own time measured the same way"),
    ]
    for name, source, replaces, weight, at in train_entries:
        agg = _sum_rows(train_rows, name, weight)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": train_checked[name][0], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": agg["bound_by"], "library_ms": agg["library_ms"],
            "device_ms": agg["device_ms"],
            "device_plain_ms": agg["device_plain_ms"],
            "device_library_ms": agg["device_library_ms"],
            "at": at + "; " + timing, "card": card})
        if name == "jacobi_eigh":
            kernels[-1]["device_library_from"] = "torch.profiler"
            kernels[-1]["profiled_ms"] = agg["profiled_ms"]
        if name in ("lowrank_linear", "jacobi_eigh", "galore_precond_step"):
            kernels[-1]["launches_by_route"] = {
                k: sum(r["routes"][name][k]
                       for r in rounds + eager_rounds + pop_rounds)
                + sum(rt[name][k] for _, rt in backbone.values())
                for k in rounds[0]["routes"][name]}
            eager = sum(r["launches"][name] for r in eager_rounds)
            kernels[-1]["launches"] += eager + pop_launches[name] + sum(
                ln[name] for ln, _ in backbone.values())
            kernels[-1]["launches_by_path"] = {
                "train": train_launches[name], "train_methods": eager,
                "population": pop_launches[name],
                **{path: ln[name] for path, (ln, _) in backbone.items()}}
        if name == "jacobi_eigh":
            kernels[-1]["launches_by_path"]["population_masked"] = \
                pop_launches["jacobi_eigh_masked"]
        if name == "galore_precond_step":
            # phases train and population launch PRECOND_UT only (their
            # factored round 0), the eager rounds PRECOND_U only (all
            # checked against the shape logs)
            kernels[-1]["by_mode"] = {
                mode: {"launches": n, **_sum_rows(
                    [r for r in train_rows
                     if r.get("project_back") == back], name)}
                for mode, back, n in (
                    ("PRECOND_UT", False,
                     train_launches[name] + pop_launches[name]
                     + sum(ln[name] for ln, _ in backbone.values())),
                    ("PRECOND_U", True, eager))}
    admit = next(r for r in scan_rows if r["shape"] == "admission prefill")
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "device_ms", "device_plain_ms", "device_library_ms")
    kernels.append({
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:54",
        "launches": (rwkv_launches["rwkv6_scan"]
                     + rwkv_train[0]["rwkv6_scan"]),
        "launches_by_path": {"serve_rwkv": rwkv_launches["rwkv6_scan"],
                             "train_rwkv": rwkv_train[0]["rwkv6_scan"]},
        "max_abs_err": scan_err, **{k: admit[k] for k in timed},
        "checkpoint_mode": {k: bwd_rows[1][k] for k in timed
                            + ("checkpoint_bytes",)},
        "at": "one rwkv6-1.6b layer of one SlotServer admission prefill: "
              "r, k, v (1, 128, 32, 64) bf16, w fp32, s0 fp32; " + timing
              + "; checkpoint_mode: the training forward (4, 128, 32, 64) "
              "writing its states every 8 steps; no single library call "
              "computes it",
        "card": card})
    kernels.append({
        "name": "rwkv6_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        "replaces": "none: XLA's derivative of the lax.scan at "
                    "src/repro/models/rwkv.py:136 (no pallas_call)",
        "launches": rwkv_train[0]["rwkv6_scan_bwd"],
        "max_abs_err": bwd_err, **{k: bwd_rows[2][k] for k in timed},
        "at": "one rwkv6-1.6b layer of one training backward: r, k, v, dy "
              "(4, 128, 32, 64) bf16, w fp32, its checkpoints every 8 "
              "steps; " + timing + "; no single library call computes it",
        "card": card})
    long_row = next(r for r in flash_rows
                    if r["shape"] == "starcoder2 long prefill")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": (launches["flash_attention"]
                     + sc_launches["flash_attention"]
                     + long_launches["flash_attention"]
                     + gr_launches["flash_attention"]
                     + nemo_launches["flash_attention"]
                     + jb_launches["flash_attention"]
                     + sum(ln["flash_attention"]
                           for ln, _ in backbone.values())),
        "launches_by_path": {
            "serve": launches["flash_attention"],
            "serve_starcoder": sc_launches["flash_attention"],
            "long_prefill_starcoder": long_launches["flash_attention"],
            "serve_granite": gr_launches["flash_attention"],
            "serve_nemo": nemo_launches["flash_attention"],
            "serve_jamba": jb_launches["flash_attention"],
            **{path: ln["flash_attention"]
               for path, (ln, _) in backbone.items()}},
        "launches_by_route": {
            k: sum(rt["flash_attention"][k]
                   for rt in (routes, sc_routes, long_routes, gr_routes,
                              nemo_routes, jb_routes)
                   + tuple(rt for _, rt in backbone.values()))
            for k in long_routes["flash_attention"]},
        "max_abs_err": flash_err,
        **{k: long_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "device_ms",
                                    "device_plain_ms", "device_library_ms")},
        "at": "one starcoder2-7b layer of the long prefill: q (1, 8192, 36, "
              "128), k, v (1, 8192, 4, 128) bf16, causal, window 4096; "
              + timing + "; library_ms is scaled_dot_product_attention "
              "with enable_gqa and a boolean window mask",
        "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
