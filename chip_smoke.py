#!/usr/bin/env python3
"""Drive the port's main path on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA GPU (Hopper,
sm_90a) and the CUDA toolkit. It imports ``repro_torch`` from ``src/`` and
nothing of JAX or of the JAX package ``repro``. Phases:

1. build every kernel of the paths from ``src/repro_torch/kernels/csrc``
   with ``nvcc``, one compiler per source, all started together (into
   ``src/repro_torch/kernels/_build/``), and check in the SASS that B2's
   bf16 instantiations run on the tensor cores (HGMMA) and B3's and B4's
   bf16 kernels do (HMMA), while B2's, B3's and B4's f32 kernels and B1's
   f32 SGEMM use neither (IEEE f32 on the CUDA cores);
2. hold each kernel against its plain version on the card, in f32 and bf16,
   at the reference's test shapes and at the main paths' shapes: B1
   block_gemm (each of its four layout instantiations at ragged M, N and
   K too, every batched case bit for bit against its tasks alone), B2
   flash_attention (with yi-6b's prefill head layout and the model's own
   strided prefill call, ragged L, D 64 and 48, the chain task, grok-1's
   GQA 6; per (batch, q head) too; no operand copied; a chain task's
   result independent of its batch), B3 ssd_scan (with mamba2-1.3b's
   layer at prefill, in its own strided layout, and chunks of 256 and 512
   at d_state 128; per (batch, head) too; no element-wise copies of the
   model's layout; a head's result independent of its batch) and B4
   decode_attention (with yi-6b's decode layer over a 32 768-position
   cache, and ranges of several tiles that end one short of and one past
   a tile and a ring stage, grok-1's group 6; no bf16 call of the model's
   layout on the CUDA-core kernel); each kernel's registers, spills and
   resident blocks per SM;
3. Cholesky, N = 16384 (32 x 32 blocks of 512, 2 x 2 shards, f32) through
   ``cholesky_executor(..., matmul=task_matmul)``: residual, agreement with
   the same executor on plain bodies, kernel launches, wall time; then the
   same matrix on the host TaskTorrent runtime (``Graph.run_host`` on
   ``inproc``: 4 ranks x 2 worker threads, block stores on the card, B1 on
   each syrk/gemm task, ``torch.linalg`` on potrf/trsm, active messages
   carrying blocks as on-device copies): residual, agreement with the
   compiled factor, exactly one B1 launch per syrk/gemm task, no tensor
   pickled; wall time, tasks/s, AMs and bytes per rank pair, the device's
   idle share under the profiler, and the runtime's own cost per task
   (bodies that return their first operand); and a Cholesky of 8 x 8
   blocks of 512 under message loss, duplication and a rank killed mid-run,
   bit for bit the fault-free run on the card; then the resident
   multi-tenant scheduler (``repro_torch.sched`` through
   ``launch.scheduler.run_stream``, 4 resident ``inproc`` ranks x 2
   threads, stores on the card): 4 clients x 8 submissions (Task-Bench
   stencil/fft/tree 16 x 12 and Cholesky N = 8192, blocks of 512; 5 440 B1
   launches), each bit for bit its one-shot ``run_host``, Cholesky
   residuals, no tensor pickled, nothing live after the drain, one
   profiled run; 10 stencil submissions chained through one namespace,
   bit for bit 10 sequential one-shots, and again with a rank killed
   mid-stream; the service's own cost a task;
4. staged GEMM 2D, N = 8192 (8 x 8 blocks of 1024, 2 x 2 shards) against
   ``torch.matmul`` of the assembled matrices;
5. the attention-chain PTG, seq 4096, dim 128, depth 16, 2 shards, f32,
   through ``auto_executor`` with ``task_attention`` bodies, against the
   same program on ``mha_ref`` bodies; B2 launches = executor attn calls;
   one profiled run; the unrolled, dense-scan and union-cover lowerings
   bit for bit; then the same three programs with one process per shard
   (``phase_ranks``, ``repro_torch.dist.ranks``; the processes share the
   card and exchange through the device transport, the ranks' mailboxes
   of device memory mapped by CUDA IPC, then once more through gloo over
   pinned host buffers, every block bit for bit the device run's):
   cholesky-16k-r4 (4 ranks, the union-cover plan once and the unrolled
   lowering after a warm-up, each rank's L blocks against the one-device
   run of the same lowering and the residual), gemm2d-8k-r4 (4 ranks, C
   bit for bit) and attn-chain-4k-r2 (2 ranks, every block bit for bit),
   each rank's B1/B2 launches = its body calls of that type, the bytes it
   sends each peer = the lowering's tables, their sum = ``comm_stats``;
   wall time between barriers on the slowest rank beside the one-device
   time, and per rank its exchange and body ms;
6. mamba2-1.3b serving at full width (48 layers, d_model 2048, f32 weights
   from a seeded generator, bf16 compute): ``make_prefill_step`` on 4
   prompts of 2048 tokens (48 B3 launches) against the same step with the
   plain SSD (no B3 call on its element-wise copies); 16 greedy
   ``make_serve_step`` tokens from a fresh cache; and prefill logits of a
   256-token prompt against 256 ``decode_step``s;
7. yi-6b serving at full width (32 layers, d_model 4096, GQA 32 over 4 KV
   heads of 128, f32 weights from a seeded generator, bf16 compute):
   prefill of 4 prompts of 2048 tokens (32 B2 launches, no operand
   copied) against the same step with the plain attention; 16 greedy
   tokens at batch 8 from a fresh cache, and 16 at batch 8 over a 32
   768-position cache filled to 32 752
   (32 B4 launches a step); gates in f32 compute (prefill kernel vs plain,
   prefill(256) vs 256 decode steps, one long-cache decode step with B4 vs
   ``decode_ref``); then the hybrid, encdec and vlm families:
   zamba2-1.2b at full width and depth (38 Mamba-2 layers, the shared
   attention block after every 6 with its 4 096-token window): prefill of
   2 x 8 192 tokens (6 windowed B2 and 38 B3 launches), 16 greedy tokens
   at batch 8 from a seeded cache at position 12 288, past the ring's
   wrap (6 B4 launches a step); seamless-m4t-large-v2 at full width and
   depth: encoder over 4 x 2 048 seeded frame embeddings and a decoder
   prompt of 4 x 512 tokens (72 B2 launches, the cross-attention
   non-causal with Lq != Lk), 16 greedy tokens at batch 4 on from the
   prefill's own self and cross caches (48 B4 launches a step);
   llava-next-34b at full width cut to 16 of its 60 layers: prefill of 4 x
   2 048 seeded embeddings (16 B2 launches), 16 greedy tokens at batch 8
   over a 4 096-position cache (16 B4 launches a step); each with f32
   gates (prefill with B2 against the plain attention, one decode step
   with B4 against ``decode_ref``), a profiled decode step, and no
   operand copied; then the moe family, bf16 weights (the configs'
   ``param_dtype``): grok-1-314b at full width cut to 8 of its 64 layers
   (48 q heads over 8 KV heads of 128, GQA 6; 8 experts of d_ff 32 768,
   top-2): prefill of 4 x 2 048 seeded tokens (8 B2 launches), 16 greedy
   tokens at batch 8 over a 4 096-position cache (8 B4 launches a step),
   f32 gates of B2 and B4 against the plain versions; deepseek-v3-671b at
   full width with its 3 dense layers and 2 of its 58 MoE layers (MLA, 256
   experts top-8 and one shared): prefill of 4 x 2 048 (MLA through
   ``chunked_attention``: 0 B2 launches), 16 greedy tokens at batch 8 over
   a 4 096-position latent cache (0 B4 launches), an f32 gate of the
   latent cache (prefill over P + 1 tokens against prefill over P and one
   absorbed decode step) and, with the model freed, ``moe_ffn`` against
   ``moe_ref`` on one MoE layer in f32 (kept masks equal); for both the
   MoE's kept share of routed slots in prefill and decode, profiled
   prefill and decode step, and the peak device memory; then training
   (``phase_train``, on a freed card): ``lm_loss`` and every gradient
   leaf of each family's reduced config on the card against the CPU (f32,
   no kernel launched); starcoder2-3b at full width cut to 2 layers: remat
   none against full, an ``AsyncCheckpointer`` resume bit for bit;
   starcoder2-3b-train at full width and depth (f32 params, AdamW, bf16
   compute, remat full, 4 x 2 048 tokens of ``SyntheticLM(learnable=True)``
   a step): 2 warm-up and 8 timed steps with no B1-B4 launch, loss and |g|
   finite, the loss falling; ms a step, tok/s, model TFLOP/s and its share
   of the bf16 peak, peak memory, one profiled step's idle share and its
   device time by projections, f32 attention einsums, the optimizer and
   casts; a ``no_grad`` prefill of the trained model (30 B2 launches); the
   plain attention's forward and backward at the layer's shapes against
   SDPA; and ``python -m repro_torch.launch.train --reduced --elastic``
   with a fake host killed, on the card; then the pipeline
   (``phase_pipeline``, starcoder2-3b-pipe2): the same model's dense stack
   at full width and depth in 2 stages x 4 microbatches on a logical
   ("pipe",) mesh of the card, through ``pipeline_apply`` under no_grad (5
   wavefronts, 8 stage calls, 120 B2 launches, bit for bit the sequential
   stack microbatch by microbatch, each B2 call of a second run held to
   ``mha_ref`` on its own operands), and ``make_pipeline_train_step`` on
   the same parameters and batches as the sequential step (first loss
   within 1e-3 of its, 1 warm-up and 4 timed steps, since this trajectory
   first falls below its start at the fifth step; no kernel launched, the
   loss falling, one profiled step) beside it; the reduced pipelined
   gradients card vs CPU; the reduced grok-1-314b's and
   deepseek-v3-671b's ``moe_ffn`` under a logical (data 2, model 2) mesh
   in 2 dispatch rows, card vs CPU (kept masks equal); and the dry run's
   argument bytes of the train cell on one card against the step's
   measured peak; then the same mesh's pipe and data axes as rank
   processes that share the card (``phase_pipeline_ranks``,
   ``make_pipeline_mesh(..., group=)``, the device transport):
   starcoder2-3b-pipe2-r2, full width and depth on 2 stage
   ranks that each draw the whole model from seed 0 and keep their
   stage: the forward under no_grad bit for bit the logical one, 60 B2
   launches per rank each held to ``mha_ref`` on its operands; 1 warm-up
   and 3 timed steps, step 0's loss bit for bit the logical step's, the
   rest and |g| within 1e-5, no kernel launched, 50 331 648 activation
   bytes a step each way; ms a step on the slowest rank, each rank's
   peak, hand-off and busy ms; starcoder2-3b-d8-pipe2-dp2-r4, 8 of 30
   layers in f32 compute on a (2, 2, 1) world, global batch 8 x 2 048:
   losses and |g| within 1e-5 of the one-process logical step on the same
   cut, each stage's f32 gradient bytes all-reduced with its data peer;
   and on a 2-layer cut a checkpoint from the ranks, its small leaves
   byte for byte the one-process save's, each rank's own rows read back
   bit for bit, and a resume bit for bit; then the model axis as rank
   processes that share the card (``phase_tensor_ranks``,
   ``make_dev_mesh(n, model=, group=)``, ``dist.tensor_parallel``):
   yi-6b-d16-tp2-r2 (yi-6b at full width, 16 of 32 layers since the
   d_model-sharded cells came, on a (1, 2) mesh of 2 ranks),
   starcoder2-3b-d10-tp4-r4 (10 of 30 layers on (1, 4),
   ``kv_head_pad`` 2: each rank holds the whole KV head its query heads
   read), grok-1-314b-d4-tp4-r4
   (4 of 64 layers on (1, 4), 8 until the moe train cells came: 2 of the 8
   experts, 12 q heads over 2 KV heads a rank),
   deepseek-v3-671b-d5-tp4-r4 (3 dense + 2 MoE layers on (1, 4): 64 of
   256 experts, 32 MLA heads a rank, the latent cache whole)
   grok-1-314b-d2-dp2-tp2-r4 (2 layers on (2, 2): a data axis of
   ranks, held to the one-process run under a logical (2, 2) mesh),
   mamba2-1.3b-d6-tp4-r4, zamba2-1.2b-d14-tp4-r4,
   seamless-m4t-large-v2-d6-tp2-r2 and seamless-m4t-large-v2-tp4-r4 (full
   depth; the embedding and the head split on d_model), bf16
   compute, each rank drawing only its shard of the seed-0 weights:
   prefill of a 2 048-token row a data rank with n_layers B2 launches per
   rank (none with MLA), 8 serve steps (16 until the moe train cells
   came) at batch 8 over a seeded cache
   (32 768 and 4 096 positions) with n_layers B4 launches a step per rank
   (none with MLA), every B2 and B4 call of a further prefill and step
   held to its plain version on its own operands, the bytes each rank
   sends each peer by kind against their formula, every rank's gathered
   logits equal, the prefill within 2e-2 and each step within the larger
   of 2e-2 and twice the one-process step's own B4-vs-plain gap of the
   one-process run (with MLA: the prefill too, and the gap between its
   attention and SDPA's), teacher forced (the tokens and the bf16 MoE
   dispatch the one-process run's; how often the ranks' own dispatch
   would differ is printed), and in f32 compute a prefill and a step
   within 1e-4 (deepseek's on its dense layers); for the moe cells one
   MoE layer in f32 on the ranks fed the one-process input to it, its
   dispatch bit for bit and its output within 1e-4; per rank ms a step,
   tok/s, all-reduce and gather ms and bytes, busy ms and peak memory;
   then training with that model axis on rank processes that share the
   card (``phase_train_ranks``, ``make_train_step(cfg, mesh=)`` on
   ``make_dev_mesh(n, model, group=)``; the collectives' backward is
   Megatron's f and g): starcoder2-3b-d10-train-tp4-r4 (full width, 10 of
   30 layers since the moe cells came, f32 params and AdamW, bf16 compute,
   remat full, 1 x 2 048 tokens on a (1, 4) mesh: a whole KV head shared
   with one other rank) and starcoder2-3b-d4-train-dp2-tp2-r4
   (4 of 30 layers in f32 on (2, 2), 2 x 2 048), and the moe family with
   the configs' bf16 parameters and Adafactor: grok-1-314b-d2-train-tp4-r4
   (2 of 64 MoE layers at full width, bf16 compute, 2 experts and 2 KV
   heads a rank) and deepseek-v3-671b-d3-train-tp4-r4 (its 3 dense layers,
   MLA with 32 heads a rank, f32 compute), and in f32
   zamba2-1.2b-d13-train-tp4-r4 (13 of 38 layers, two shared sites) and
   seamless-m4t-large-v2-d6-train-tp4-r4 (6 + 6 of 24 + 24 layers, the
   embedding and head split on d_model), each from seed 0 against the
   one-process step on the same weights and batch (1 warm-up and 1 timed
   step): no B1-B4 launch, the loss falling, the first
   step's loss and |g| within 1e-2 and 5e-2 (bf16) or every step's within
   1e-5 and 1e-4 (f32; with Mamba-2 layers the first step's) and the
   first step's gradients and update held to the one-process step's boxes
   (with Mamba-2 layers at 4 times one process's own f32 sum-order gap), the bytes each rank sends each peer by
   kind against their formula, the ranks that hold one box (KV heads,
   norms, the router, MLA's down-projections) bit for bit; grok's MoE
   slots routed otherwise than on one process counted; ms a step and
   tok/s beside one process, per rank all-reduce and gather ms, busy ms
   and peak memory; then elastic training on rank processes through the
   launcher (``phase_elastic_ranks``, ``launch.train --ranks --elastic``):
   starcoder2-3b-d2-train-dp2-tp2-r4-elastic (2 of 30 layers at full
   width, f32, AdamW, 4 ranks as 2 fake hosts on (2, 2), host 1 silent
   from step 2): its lines exactly, the survivors' world of 2 ranks on
   (1, 2) restored from step 2, its step 3 against the lost world's
   within 1e-5 (loss) and 1e-4 (|g|), no B1-B4 launch; each world's
   spawn, the restore, the first resumed step, the time to recover and
   the checkpoints' size and seconds;
8. time each kernel, its plain version and one PyTorch library call at the
   main paths' shapes (CUDA events), beside the least time the card could
   take (its bound);
9. print the kernels ported, the card, a JSON line of per-kernel numbers
   (``train_launches`` and ``pipeline_train_launches``: each kernel's
   launches in the sequential and the pipelined train steps, 0;
   ``ranks_launches``: each rank's launches in the ranked cells and the
   ranked pipelined forward; ``pipeline_ranks_train_launches``: each
   rank's in the ranked train steps, 0; ``tensor_ranks_launches``: each
   rank's B2 launches a prefill and B4 launches in 8 steps of the ranked
   tensor-parallel cells, the moe cells' included;
   ``tensor_ranks_train_launches``: each rank's in the timed steps of the
   ranked tensor-parallel train cells, 0;
   ``elastic_ranks_train_launches``: each rank's in each world's step
   loop of the elastic cell, 0)
   and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.block_gemm import (block_gemm,  # noqa: E402
                                            block_gemm_ref, task_matmul)
from repro_torch.kernels.block_gemm.block_gemm import (  # noqa: E402
    kernel_info as gemm_kernel_info)
from repro_torch.kernels.block_gemm.ops import matmul  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_ref, kernel_info as decode_kernel_info)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, mha_ref, task_attention)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    kernel_info as attention_kernel_info)
from repro_torch.kernels.ssd_scan import (ssd_chunked_ref,  # noqa: E402
                                          ssd_ref, ssd_scan)
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: E402
    kernel_info as ssd_kernel_info, plan as ssd_plan)
from repro_torch.core import FaultPlan, payload_stats  # noqa: E402
from repro_torch.dist.ctx import launch_mesh  # noqa: E402
from repro_torch.dist.pipeline import (pipeline_apply,  # noqa: E402
                                       schedule_depth, split_microbatches)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_dev_mesh,  # noqa: E402
                                    make_pipeline_mesh)
from repro_torch.dist.sharding import kv_head_pad  # noqa: E402
from repro_torch.dist.tensor_parallel import (  # noqa: E402
    box_holders, column_holders, init_shard_cache, init_shard_params,
    row_product, shard_boxes, shard_cache, shard_tree, vocab_sharded)
from repro_torch.linalg.cholesky import (assemble_lower,  # noqa: E402
                                         cholesky_bodies, cholesky_executor,
                                         cholesky_graph, cholesky_program,
                                         cholesky_rank, make_spd_blocks)
from repro_torch.linalg.host_exec import run_host_ptg  # noqa: E402
from repro_torch.linalg.gemm import (assemble, gemm_2d_program,  # noqa: E402
                                     gemm_executor, gemm_rank, make_blocks)
from repro_torch.models import mamba2, moe  # noqa: E402
from repro_torch.models.layers import (apply_rope, dense_init,  # noqa: E402
                                       rms_norm, rope_freqs, take_box)
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.attention_chain import (chain_blocks,  # noqa: E402
                                         chain_bodies, chain_graph,
                                         chain_rank)
from repro_torch.dist.ranks import (MAILBOX_BYTES, owned_blocks,  # noqa: E402,E501
                                    run_jobs, spawn_ranks)
from repro_torch.serve.decode import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as optimizer_mod  # noqa: E402
from repro_torch.train import train_step as train_step_mod  # noqa: E402
from repro_torch.train.data import SyntheticLM  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    adafactor_init, adamw_init, make_optimizer, ranked_adafactor_update)
from repro_torch.train.train_step import (  # noqa: E402
    adafactor_shards, init_train_state, loss_and_grads, make_pipeline_loss,
    make_pipeline_train_step, make_train_step, pipeline_rows, pipeline_shard,
    replica_columns, replica_leaves, value_and_grads)
from repro_torch.train.tree import (leaf_paths, leaves as tree_leaves,  # noqa: E402,E501
                                    tree_map, unflatten)

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W): f32 on the
# CUDA cores, bf16 on the tensor cores, and device memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel against plain version, as max|got - want| / max(1, max|want|).
# f32: the reference's own 2e-5 (tests/test_kernels.py); the two differ
# only in the order of f32 sums, ~2^-24 * sqrt(K) relative, 1e-6 at K=1024.
# bf16: 2e-2, the reference's; both sum in f32 and round once to bf16, so
# they differ by at most one bf16 rounding (2^-8 relative).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The attention chain, kernel bodies against mha_ref bodies over all 16
# tasks, same measure. Task l attends over its own input (q = k = v), so
# each task maps the previous task's rounding difference through a sharp
# softmax (self-logits ~|x|^2 / sqrt(D)); on the card each task adds ~3e-7
# and the chain grows it by ~1.4x per task (9.6e-5 after 16). 1e-3 holds
# that with a 10x margin; each task alone is held to TOL (per-task check).
CHAIN_TOL = 1e-3
# B3 against ssd_chunked_ref, same measure. f32: the reference's 2e-4 (the
# two take exp of cumulative sums and sum the chunk products in other
# orders). bf16: both read the same bf16 operands and round y once; the
# kernel also rounds its tensor-core operands (the scores, x ⊙ dt ⊙
# exp(cum_Q − cum), the states entering each chunk) to bf16: 2e-2, the
# reference's.
TOL_SSD = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# B3 is also held per (batch, head), normalised by that head's own
# max|plain| over its [L, P]. Measured on the CPU by
# scripts/torch_ssd_rounding.py at mamba2-1.3b's layer (Q 128 and 256): the
# kernel's arithmetic (ssd_bf16_operands_ref) moves a head by up to 5.7e-7
# of its size in f32 (sums in another order; 1e-4, as B4's, is ~175x that)
# and 7.3e-3 in bf16 (about one bf16 rounding of y near the head's max;
# 2e-2 is the reference's bf16 tolerance).
SSD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# Cholesky N=16384: ||L L^T - A||_F / ||A||_F. A = m m^T / n + 2 I has
# eigenvalues in about [2, 6], so f32 Cholesky's backward error is a few
# u * sqrt(n) = 6e-8 * 128 = 8e-6 at most in practice; 2e-5 leaves room for
# the sums of 32 panels without hiding a wrong block (which gives ~1).
CHOL_RESID_TOL = 2e-5
# max|L_kernel - L_plain|: both are f32 factorizations that differ only in
# the order of the trailing-update sums; with cond(A) <= 3 and |L| <= ~2.5
# the forward difference stays near u * sqrt(n) * cond ~ 3e-5; 1e-3 is a
# ceiling that still catches any wrong block (differences of order 1).
CHOL_PLAIN_TOL = 1e-3
# GEMM N=8192 against torch.matmul, as max|diff| / max|ref|: two f32 sums of
# 8192 products in different orders differ by ~u * sqrt(K) = 5e-6 relative
# to the largest entry; 1e-4 is that with a 20x margin.
GEMM_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, with no floor."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over the leading axes of max|got - want| / max|want| within
    the last axis: each row is held to its own size, with no floor."""
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gemm_bound_ms(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Least time for C = A @ B on the card: each input read once, C written
    once, against the f32 FMA rate of the CUDA cores."""
    T, M, K = a.shape
    N = b.shape[-1]
    nbytes = a.element_size() * T * (M * K + K * N + M * N)
    return bound(nbytes, 2.0 * T * M * N * K, torch.float32)


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple:
    """Least time on the card: the bytes moved (each input read once, each
    output written once) over the memory rate, or the operations over the
    peak rate for the operands' type, whichever is larger."""
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def attention_work(q, k, causal=True, window=0) -> tuple:
    """B2's (bytes, FLOPs): q, k, v read and o written once; 4·D FLOPs (q·k
    and p·v) per (query, key) pair the mask keeps, as this call's shapes
    give: query i sits at lk - lq + i and keeps the keys up to it (causal)
    and after it minus ``window`` (a window)."""
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    pairs = 0
    for i in range(lq):
        pos = lk - lq + i
        hi = min(lk, pos + 1) if causal else lk
        lo = max(0, pos - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return (q.element_size() * (2 * q.numel() + 2 * k.numel()),
            4.0 * d * pairs * b * hq)


def ssd_work(x, b, q_chunk) -> tuple:
    """B3's (bytes, FLOPs): x, dt, B, C read and y written once; per chunk
    of qv rows, the causal half of C Bᵀ once per (batch, group) (qv(qv+1)/2
    pairs x N x 2), and per (batch, head) the causal half of its product
    with dt·x (qv(qv+1)/2 x P x 2) plus C h and Bᵀ (dt·x) (4 qv N P), as
    this call's shapes give."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    per_group = per_head = 0.0
    for t0 in range(0, l, q_chunk):
        qv = min(q_chunk, l - t0)
        per_group += qv * (qv + 1) * n
        per_head += qv * (qv + 1) * p + 4.0 * qv * n * p
    return (x.element_size() * (2 * x.numel() + bsz * l * h
                                + 2 * bsz * l * g * n),
            per_group * bsz * g + per_head * bsz * h)


def leaves(tree):
    """The tensors of a nested dict."""
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else (v,))


def reset_launches() -> None:
    """Zero every kernel's launch counter, B2's count of operands copied
    for TMA, B3's count of calls with element-wise copies and B4's count of
    bf16 calls on its CUDA-core kernel, just before a main-path run."""
    for kernel in (block_gemm, flash_attention, ssd_scan, decode_attention):
        kernel.launches = 0
    flash_attention.copies = 0
    ssd_scan.narrow = 0
    decode_attention.narrow = 0


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phases

def sass_counts(name: str, opcodes) -> dict:
    """{kernel function: {opcode: count}} of ``csrc/<name>.cu``'s built
    library, from ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op in opcodes:
                counts[fn][op] += f" {op}." in line or f" {op} " in line
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build("block_gemm", "flash_attention", "ssd_scan",
                         "decode_attention", "mailbox")
    log(f"[build] nvcc {built or 'nothing to build'}; "
        f"{time.perf_counter() - t0:.2f} s in all")
    # B2's bf16 path must run on the tensor cores (wgmma is HGMMA in SASS)
    # and its f32 path on the CUDA cores (no HGMMA, no HMMA: no TF32)
    counts = sass_counts("flash_attention", ("HGMMA", "HMMA"))
    bf16 = {f: c for f, c in counts.items() if "4bf169fa_kernel" in f}
    f32 = {f: c for f, c in counts.items()
           if "partial_kernel" in f or "merge_kernel" in f}
    log(f"[build] flash_attention SASS: bf16 kernels "
        f"{[c['HGMMA'] for c in bf16.values()]} HGMMA; f32 kernels "
        f"{[c['HGMMA'] + c['HMMA'] for c in f32.values()]} HGMMA+HMMA")
    check(len(bf16) == 2 and all(c["HGMMA"] > 0 for c in bf16.values()),
          f"flash_attention bf16 instantiations without HGMMA: {bf16}")
    check(len(f32) >= 5 and not any(c["HGMMA"] or c["HMMA"]
                                    for c in f32.values()),
          f"flash_attention f32 kernels on the tensor cores: {f32}")
    # B4's bf16 ring kernel runs Q·Kᵀ and P·V on mma.sync (HMMA); its f32
    # partials and merge kernels stay on the CUDA cores
    counts = sass_counts("decode_attention", ("HGMMA", "HMMA"))
    ring = {f: c for f, c in counts.items() if "decode_partial_ring" in f}
    f32 = {f: c for f, c in counts.items()
           if "decode_partialIf" in f or "decode_combineIf" in f}
    log(f"[build] decode_attention SASS: bf16 ring kernels "
        f"{[c['HMMA'] for c in ring.values()]} HMMA; f32 kernels "
        f"{[c['HGMMA'] + c['HMMA'] for c in f32.values()]} HGMMA+HMMA")
    check(len(ring) == 2 and all(c["HMMA"] > 0 for c in ring.values()),
          f"decode_attention bf16 ring kernels without HMMA: {ring}")
    check(len(f32) >= 7 and not any(c["HGMMA"] or c["HMMA"]
                                    for c in f32.values()),
          f"decode_attention f32 kernels on the tensor cores: {f32}")
    # B1's f32 SGEMM (all four layouts) stays IEEE f32 on the CUDA cores
    counts = sass_counts("block_gemm", ("HGMMA", "HMMA", "FFMA"))
    f32 = {f: c for f, c in counts.items() if "sgemm_ring" in f}
    log(f"[build] block_gemm SASS: f32 kernels "
        f"{[c['HGMMA'] + c['HMMA'] for c in f32.values()]} HGMMA+HMMA, "
        f"{[c['FFMA'] for c in f32.values()]} FFMA")
    check(len(f32) == 4 and all(c["FFMA"] > 0 and not c["HGMMA"]
                                and not c["HMMA"] for c in f32.values()),
          f"block_gemm f32 kernels on the tensor cores: {f32}")
    # B3's bf16 products (C Bᵀ, the chunk states, C H and the scores times
    # x) run on mma.sync (HMMA); its f32 kernels stay on the CUDA cores
    counts = sass_counts("ssd_scan", ("HGMMA", "HMMA", "FFMA"))
    bf16 = {f: c for f, c in counts.items()
            if "nv_bfloat16" in f and "ssd_cumsum" not in f}
    f32 = {f: c for f, c in counts.items() if "nv_bfloat16" not in f}
    log(f"[build] ssd_scan SASS: bf16 kernels "
        f"{[c['HMMA'] for c in bf16.values()]} HMMA; f32 kernels "
        f"{[c['HGMMA'] + c['HMMA'] for c in f32.values()]} HGMMA+HMMA, "
        f"{[c['FFMA'] for c in f32.values()]} FFMA")
    check(len(bf16) == 3 and all(c["HMMA"] > 0 for c in bf16.values()),
          f"ssd_scan bf16 kernels without HMMA: {bf16}")
    check(len(f32) == 4 and not any(c["HGMMA"] or c["HMMA"]
                                    for c in f32.values()),
          f"ssd_scan f32 kernels on the tensor cores: {f32}")
    for dtype in (torch.float32, torch.bfloat16):
        for name, info in ssd_kernel_info(dtype, 0).items():
            log(f"[build] ssd_scan {str(dtype)[6:]} {name}: "
                f"{info.registers} registers, {info.spill_bytes} spill "
                f"bytes per thread, {info.blocks_per_sm} resident blocks "
                f"per SM, {info.smem_bytes} B shared (CUDA runtime)")
            check(info.spill_bytes == 0 and info.blocks_per_sm >= 1,
                  f"ssd_scan {dtype} {name}: {info}")


def gemm_operands(gen, dev, dtype, T, M, K, N, a_k=True, b_n=True):
    """A [T, M, K] k- (else m-) contiguous, B [T, K, N] n- (else k-)
    contiguous (B = X.mT, a strided view as in the Cholesky bodies): one
    of B1's four f32 instantiations."""
    a = (torch.randn((T, M, K), generator=gen, device=dev) if a_k else
         torch.randn((T, K, M), generator=gen, device=dev).mT).to(dtype)
    b = (torch.randn((T, K, N), generator=gen, device=dev) if b_n else
         torch.randn((T, N, K), generator=gen, device=dev).mT).to(dtype)
    return a, b


def phase_kernel_vs_plain(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for m, n, k in ((64, 64, 64), (128, 64, 96), (32, 128, 64),
                    (256, 256, 128)):                 # tests/test_kernels.py
        cases.append((f"{m}x{k}@{k}x{n}", 1, m, k, n, False))
    for bs in (4, 8, 16):                             # executor body form
        cases.append((f"[5,{bs},{bs}]@.mT", 5, bs, bs, bs, True))
    cases += [("[120,512,512]@.mT", 120, 512, 512, 512, True),
              ("[480,512,512]@.mT", 480, 512, 512, 512, True),
              ("[16,1024,1024]", 16, 1024, 1024, 1024, False),
              ("[64,1024,1024]", 64, 1024, 1024, 1024, False)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, T, m, k, n, tr in cases:
            a, b = gemm_operands(gen, dev, dtype, T, m, k, n, b_n=not tr)
            got, want = block_gemm(a, b), block_gemm_ref(a, b)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype,
                  f"block_gemm {name} {dtype}: shape/dtype")
            err = rel_err(got, want)
            log(f"[kernel] block_gemm {name:<20} {str(dtype)[6:]:<9} "
                f"max err {err:.3e} (tol {TOL[dtype]:.0e})")
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"block_gemm {name} {dtype}: err {err} > {TOL[dtype]}")
            if T > 1:   # a task's result does not depend on its batch
                part = block_gemm(a[:3], b[:3])
                check(torch.equal(part, got[:3]),
                      f"block_gemm {name} {dtype}: batch-dependent result")
    # each layout instantiation at ragged M, N and K (K not a multiple of
    # the K step), every task of the batch bit for bit as launched alone
    for dtype in (torch.float32, torch.bfloat16):
        for a_k in (True, False):
            for b_n in (True, False):
                for T, m, k, n in ((3, 130, 70, 129), (4, 131, 37, 67),
                                   (2, 257, 300, 129)):
                    a, b = gemm_operands(gen, dev, dtype, T, m, k, n, a_k,
                                         b_n)
                    got, want = block_gemm(a, b), block_gemm_ref(a, b)
                    err = rel_err(got, want)
                    alone = all(torch.equal(block_gemm(a[i:i + 1],
                                                       b[i:i + 1])[0], got[i])
                                for i in range(T))
                    name = (f"[{T},{m},{k},{n}] A {'k' if a_k else 'm'}-"
                            f"contiguous B {'n' if b_n else 'k'}-contiguous")
                    log(f"[kernel] block_gemm {name:<42} {str(dtype)[6:]:<9}"
                        f" max err {err:.3e} (tol {TOL[dtype]:.0e}); tasks "
                        f"as alone: {alone}")
                    check(math.isfinite(err) and err <= TOL[dtype],
                          f"block_gemm {name} {dtype}: err {err}")
                    check(alone, f"block_gemm {name} {dtype}: "
                                 "batch-dependent result")
    log("[kernel] tolerance: max|kernel - plain| / max(1, max|plain|); "
        "f32 2e-5 is the reference's (sums differ only in order, "
        "~2^-24 sqrt(K)); bf16 2e-2 is the reference's (one bf16 rounding "
        "of an f32 sum, 2^-8)")
    for a_k, b_n, path in ((True, False, "Cholesky's l @ l.mT"),
                           (True, True, "the GEMM update"),
                           (False, True, "A m-contiguous"),
                           (False, False, "A m-, B k-contiguous")):
        info = gemm_kernel_info(a_k, b_n, dev.index or 0)
        log(f"[kernel] block_gemm f32, {path}: {info.blocks_per_sm} "
            f"resident blocks per SM, {info.registers} registers and "
            f"{info.spill_bytes} spill bytes per thread, {info.smem_bytes} B "
            f"shared, BK {info.bk} x {info.stages} stages (CUDA runtime)")


def head_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over (batch, q head) of max|got - want| / max|want| within
    that head's [L, D]: each head held to its own size, with no floor."""
    return row_err(got.flatten(2), want.flatten(2))


def attention_operands(gen, dev, dtype, b, hq, hkv, lq, lk, d, model=False):
    """q [b, hq, lq, d], k and v [b, hkv, lk, d]; with ``model`` laid out
    as the dense model hands them to B2 (``transformer.py``: [B, S, H, D]
    projections viewed as [B, H, S, D], v never made contiguous)."""
    def make(h, l):
        if model:
            return torch.randn((b, l, h, d), generator=gen,
                               device=dev).to(dtype).transpose(1, 2)
        return torch.randn((b, h, l, d), generator=gen, device=dev).to(dtype)
    return make(hq, lq), make(hkv, lk), make(hkv, lk)


def phase_attention_vs_plain(dev) -> None:
    """B2 against ``mha_ref`` at the reference's test shapes
    (``tests/test_kernels.py:50-77`` and the task form of ``:96-109``), at
    yi-6b's head layout (Hq 32, Hkv 4, D 128) at B 1, L 4096 and in the
    model's own layout at prefill (B 4, L 2048, strided views), at ragged
    L, at D 64 and 48, and at the attention chain's task [1, 1, 4096,
    128]; with a sliding window (zamba2's shared block, windows 1, 64 and
    4 096 over 8 192 keys, ragged L), non-causal with Lq != Lk (seamless's
    cross-attention, and Lq > Lk), at llava's GQA 7 and at grok-1's GQA 6
    (its prefill call in the model's layout, ragged, full) and at
    starcoder2-3b's GQA 12 (its pipelined microbatch's call in the model's
    layout, [1, 24|2, 2048, 128]); whole tensor and
    per (batch, q head). None needs a copy for TMA. Then the chain task's
    batch independence, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    yi = get_config("yi-6b")
    hq, hkv, hd = yi.n_heads, yi.n_kv_heads, yi.head_dim
    cases = [(f"[{b},{h}|{g},{lq}|{lk},{d}]", (b, h, g, lq, lk, d), False)
             for b, h, g, lq, lk, d in ((1, 4, 4, 128, 128, 64),
                                        (2, 8, 2, 128, 128, 64),
                                        (1, 4, 1, 64, 256, 32),
                                        (1, 2, 2, 256, 256, 128),
                                        (1, 2, 2, 512, 512, 64),
                                        (3, 1, 1, 32, 32, 16),
                                        (1, 2, 2, 1000, 1000, 128),
                                        (1, 2, 2, 1000, 3000, 128),
                                        (2, 8, 2, 777, 777, 64),
                                        (2, 8, 2, 300, 300, 48),
                                        (1, 1, 1, 4096, 4096, 128))]
    cases += [(f"yi-6b [1,{hq}|{hkv},4096,{hd}]", (1, hq, hkv, 4096, 4096, hd),
               False),
              (f"yi-6b model layout [4,{hq}|{hkv},2048,{hd}]",
               (4, hq, hkv, 2048, 2048, hd), True)]
    flash_attention.copies = 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, model in cases:
            q, k, v = attention_operands(gen, dev, dtype, *shape, model=model)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = mha_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == dtype,
                      f"flash_attention {name}: shape/dtype")
                err, head = rel_err(got, want), head_err(got, want)
                log(f"[kernel] flash_attention {name:<38} "
                    f"{'causal' if causal else 'full':<6} "
                    f"{str(dtype)[6:]:<9} max err {err:.3e}, per head "
                    f"{head:.3e} (tol {TOL[dtype]:.0e})")
                check(math.isfinite(err) and err <= TOL[dtype],
                      f"flash_attention {name} {dtype}: err {err}")
                check(math.isfinite(head) and head <= TOL[dtype],
                      f"flash_attention {name} {dtype}: per-head err {head}")
                del got, want
            del q, k, v
    zamba, seam, llava = (get_config(a) for a in (
        "zamba2-1.2b", "seamless-m4t-large-v2", "llava-next-34b"))
    zh, zd, w = zamba.n_heads, zamba.head_dim, zamba.sliding_window
    sh, sd = seam.n_heads, seam.head_dim
    lh, lg, ld = llava.n_heads, llava.n_kv_heads, llava.head_dim
    grok = get_config("grok-1-314b")
    gh, gg, gd = grok.n_heads, grok.n_kv_heads, grok.head_dim
    sc2 = get_config("starcoder2-3b")
    ch, cg, cd = sc2.n_heads, sc2.n_kv_heads, sc2.head_dim
    # (name, shape, model layout, causal, window): zamba2's shared block
    # (window 4 096 over 8 192 keys, head dim 64, group 1) with windows of
    # 1, one tile and the model's, ragged L, GQA 7 with Lq < Lk; seamless's
    # encoder, decoder and cross-attention (non-causal Lq < Lk), Lq > Lk;
    # llava's GQA 7 prefill; grok-1's GQA 6 prefill, ragged and full;
    # starcoder2-3b's GQA 12 microbatch of the pipelined forward
    more = [(f"zamba2 window {win} [1,2|2,8192,{zd}]",
             (1, 2, 2, 8192, 8192, zd), False, True, win)
            for win in (1, 64, w)]
    more += [(f"zamba2 model layout window {w} [1,{zh}|{zh},8192,{zd}]",
              (1, zh, zh, 8192, 8192, zd), True, True, w),
             ("ragged window 777 [1,4|4,3000,64]", (1, 4, 4, 3000, 3000, 64),
              False, True, 777),
             ("window 300 [2,14|2,1000|1500,128]",
              (2, 14, 2, 1000, 1500, 128), False, True, 300),
             (f"seamless encoder [4,{sh}|{sh},2048,{sd}] full",
              (4, sh, sh, 2048, 2048, sd), True, False, 0),
             (f"seamless cross [4,{sh}|{sh},512|2048,{sd}] full",
              (4, sh, sh, 512, 2048, sd), True, False, 0),
             ("Lq > Lk [1,4|4,2048|512,64] full", (1, 4, 4, 2048, 512, 64),
              False, False, 0),
             (f"llava model layout [2,{lh}|{lg},2048,{ld}]",
              (2, lh, lg, 2048, 2048, ld), True, True, 0),
             (f"grok model layout [2,{gh}|{gg},2048,{gd}]",
              (2, gh, gg, 2048, 2048, gd), True, True, 0),
             ("GQA 6 ragged [1,12|2,1000,128]", (1, 12, 2, 1000, 1000, 128),
              False, True, 0),
             ("GQA 6 full Lq < Lk [1,12|2,700|1500,128]",
              (1, 12, 2, 700, 1500, 128), True, False, 0),
             (f"starcoder2 model layout [1,{ch}|{cg},2048,{cd}]",
              (1, ch, cg, 2048, 2048, cd), True, True, 0)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, model, causal, win in more:
            q, k, v = attention_operands(gen, dev, dtype, *shape, model=model)
            got = flash_attention(q, k, v, causal=causal, window=win)
            want = mha_ref(q, k, v, causal=causal, window=win)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype,
                  f"flash_attention {name}: shape/dtype")
            err, head = rel_err(got, want), head_err(got, want)
            log(f"[kernel] flash_attention {name:<46} {str(dtype)[6:]:<9} "
                f"max err {err:.3e}, per head {head:.3e} (tol "
                f"{TOL[dtype]:.0e})")
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"flash_attention {name} {dtype}: err {err}")
            check(math.isfinite(head) and head <= TOL[dtype],
                  f"flash_attention {name} {dtype}: per-head err {head}")
            del q, k, v, got, want
    log(f"[kernel] flash_attention operands copied for TMA: "
        f"{flash_attention.copies}")
    check(flash_attention.copies == 0, "flash_attention copied operands")
    log("[kernel] flash_attention tolerance: as block_gemm's (the "
        "reference's 2e-5 / 2e-2; f32 sums, the online softmax's rescaling "
        "and the split ranges' merge in another order; bf16: P rounded to "
        "bf16 before P·V and one bf16 rounding of an f32 result), on the "
        "whole tensor and per (batch, q head) against the head's own "
        "max|plain| (scripts/torch_attention_rounding.py)")
    x = torch.randn((3, 4096, 128), generator=gen, device=dev)
    for causal in (True, False):
        batched = task_attention(x, x, x, causal=causal)
        alone = [task_attention(x[t:t + 1], x[t:t + 1], x[t:t + 1],
                                causal=causal) for t in range(3)]
        check(torch.equal(batched, torch.cat(alone)),
              "task_attention: a task's result depends on its batch")
    log("[kernel] task_attention [3,4096,128] f32: each task bit for bit "
        "as alone (causal and full)")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            info = attention_kernel_info(dtype, d, dev.index or 0)
            log(f"[kernel] flash_attention {str(dtype)[6:]} D<={d}: "
                f"{info.blocks_per_sm} resident blocks per SM, "
                f"{info.registers} registers and {info.spill_bytes} spill "
                f"bytes per thread, {info.smem_bytes} B shared, tiles "
                f"{info.bq} queries x {info.bk} keys (CUDA runtime)")


def ssd_operands(gen, dev, dtype, b, l, h, g, p, n, model=False):
    """x, dt, A, B, C, D as ``tests/test_kernels.py`` makes them; with
    ``model``, x, B and C are views of one [b, l, h·p + 2·g·n] projection,
    as ``mamba2_forward`` hands them to B3."""
    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)
    if model:
        proj = (randn(b, l, h * p + 2 * g * n) * 0.5).to(dtype)
        proj[..., :h * p] *= 2.0
        x, bm, cm = proj.split([h * p, g * n, g * n], dim=-1)
        x, bm, cm = (x.unflatten(-1, (h, p)), bm.unflatten(-1, (g, n)),
                     cm.unflatten(-1, (g, n)))
    else:
        x = randn(b, l, h, p).to(dtype)
        bm = (randn(b, l, g, n) * 0.5).to(dtype)
        cm = (randn(b, l, g, n) * 0.5).to(dtype)
    return (x, (F.softplus(randn(b, l, h)) * 0.1).to(dtype),
            -torch.exp(randn(h) * 0.5), bm, cm,
            torch.full((h,), 0.5, device=dev))


def ssd_head_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over (batch, head) of max|got - want| / max|want| within
    that head's [L, P]."""
    return row_err(got.transpose(1, 2).flatten(2),
                   want.transpose(1, 2).flatten(2))


def phase_ssd_vs_plain(dev) -> None:
    """B3 against ``ssd_chunked_ref`` at the reference's test shapes
    (``tests/test_kernels.py:145-181``, the carry test at Q = 32 and 128
    included), at chunks of 256 and 512 with d_state 128 (fault C1), at
    mamba2-1.3b's layer at prefill in its own strided layout (no element-
    wise copies), at zamba2-1.2b's layer (d_state 64, 2 x 8 192 tokens,
    the model's layout), whole tensor and per (batch, head); then a head's
    result independent of its batch, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(4)
    m = get_config("mamba2-1.3b")
    nh = m.ssm.n_heads(m.d_model)
    layer = (4, 2048, nh, m.ssm.n_groups, m.ssm.head_dim, m.ssm.d_state)
    z = get_config("zamba2-1.2b")
    zamba = (2, 8192, z.ssm.n_heads(z.d_model), z.ssm.n_groups,
             z.ssm.head_dim, z.ssm.d_state)
    cases = [((1, 128, 2, 1, 32, 16), 64, False),
             ((2, 256, 4, 2, 64, 32), 128, False),
             ((1, 64, 8, 8, 16, 16), 32, False),
             ((1, 256, 2, 1, 16, 8), 32, False),
             ((1, 256, 2, 1, 16, 8), 128, False),
             ((2, 1024, 4, 1, 64, 128), 256, False),    # C1
             ((1, 1024, 4, 2, 64, 128), 512, False),    # C1
             ((1, 1000, 4, 1, 64, 128), 256, False),    # C1, ragged
             (layer, 128, True), (layer, 256, True),
             (zamba, 128, True)]                        # d_state 64
    for dtype in (torch.float32, torch.bfloat16):
        for shape, q, model in cases:
            ops = ssd_operands(gen, dev, dtype, *shape, model=model)
            ssd_scan.narrow = 0
            got = ssd_scan(*ops, q_chunk=q)
            torch.cuda.synchronize()
            narrow = ssd_scan.narrow
            want = (ssd_chunked_ref(*ops, q_chunk=q) if shape[1] % q == 0
                    else ssd_ref(*ops))
            b, l, h, g, p, n = shape
            name = (f"x[{b},{l},{h},{p}] b/c[..,{g},{n}] Q{q}"
                    + (" model layout" if model else ""))
            check(got.shape == want.shape and got.dtype == dtype,
                  f"ssd_scan {name}: shape/dtype")
            err, head = rel_err(got, want), ssd_head_err(got, want)
            log(f"[kernel] ssd_scan {name:<48} {str(dtype)[6:]:<9} max err "
                f"{err:.3e} (tol {TOL_SSD[dtype]:.0e}), per head {head:.3e} "
                f"(tol {SSD_ROW_TOL[dtype]:.0e}); "
                f"{ssd_plan(b, l, h, g, p, n, q, got.element_size()).kernels}"
                f" kernels")
            check(math.isfinite(err) and err <= TOL_SSD[dtype],
                  f"ssd_scan {name} {dtype}: err {err}")
            check(math.isfinite(head) and head <= SSD_ROW_TOL[dtype],
                  f"ssd_scan {name} {dtype}: per-head err {head}")
            if model:
                check(narrow == 0, f"ssd_scan {name}: element-wise copies")
            del ops, got, want
    log("[kernel] ssd_scan tolerance: max|kernel - plain| / max(1, "
        "max|plain|); f32 2e-4 is the reference's (exp of cumulative sums, "
        "chunk products in another order); bf16 2e-2, the reference's (the "
        "scores, x·dt·exp(cum_Q - cum) and the chunk states rounded to bf16 "
        "as tensor-core operands, y once); per (batch, head) against the "
        "head's own max|plain|, 1e-4 / 2e-2 (scripts/torch_ssd_rounding.py)")
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bm, cm, d = ssd_operands(gen, dev, dtype, 3, 512, 4, 2, 64,
                                           128)
        batched = ssd_scan(x, dt, a, bm, cm, d)
        alone = [ssd_scan(x[i:i + 1], dt[i:i + 1], a, bm[i:i + 1],
                          cm[i:i + 1], d) for i in range(3)]
        check(torch.equal(batched, torch.cat(alone)),
              f"ssd_scan {dtype}: a head's result depends on its batch")
    log("[kernel] ssd_scan x[3,512,4,64] f32 and bf16: each batch row bit "
        "for bit as alone")


def decode_operands(gen, dev, dtype, b, hq, hkv, s, d):
    return (torch.randn((b, hq, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype))


# yi-6b's decode layer over the long cache: batch 8 (decode_32k's 128 cut
# for one card), 32 q heads over 4 KV heads of 128, 32 768 positions, and
# ragged lengths from full to one.
DECODE_CELL = (8, 32, 4, 32768, 128)
DECODE_CELL_LEN = (32768, 32751, 17000, 1, 4096, 65, 64, 30000)
# B4 is also held to a tolerance per (batch, q head) row, normalised by that
# row's own max|plain|: a row over 32k positions averages values of either
# sign to ~0.02, a row of kv_len 1 is v[0] (~3), so one scale for the whole
# output would let a long row be wrong by more than its size. Measured on
# the CPU by scripts/torch_decode_rounding.py at this layer: split-cache f32
# partials merged as B4 merges them differ from decode_ref by up to 7.4e-6
# of a row in f32 (1e-4 is ~14x that) and 3.3e-3 in bf16 (one bf16
# rounding of the result; 2e-2 is the reference's bf16 tolerance).
DECODE_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def phase_decode_vs_plain(dev) -> None:
    """B4 against ``decode_ref`` at the reference's test shapes
    (``tests/test_kernels.py:114-140``, its ragged lengths included), a
    ragged S, a cache with replicated KV heads (``kv_head_pad`` 2),
    yi-6b's decode layer over a 32 768-position cache, zamba2's ring
    (group 1, D 64; also past the wrap, against the keys in position
    order), seamless's self and cross caches, llava's group 7 and grok-1's
    group 6, f32 and bf16."""
    gen = torch.Generator(device=dev).manual_seed(12)
    cases = [((2, 8, 2, 256, 64), None), ((1, 4, 4, 512, 128), None),
             ((4, 16, 1, 128, 64), None), ((3, 4, 2, 256, 64), (256, 100, 17)),
             ((2, 8, 2, 200, 64), (200, 77)),
             ((2, 8, 4, 333, 128), (333, 45)),      # 2 KV heads, pad 2
             # ranges of 1024 positions (8 tiles of 128, four turns of the
             # ring); ends one short of and one past a tile and a turn
             ((8, 32, 4, 4096, 128), (63, 65, 127, 129, 255, 257, 1151,
                                      1281)),
             (DECODE_CELL, DECODE_CELL_LEN),
             # zamba2's ring (group 1, D 64; every slot live), seamless's
             # self and cross caches (group 1), llava's group 7
             ((8, 32, 32, 4096, 64), None),
             ((4, 16, 16, 2048, 64), None),
             ((4, 16, 16, 528, 64), (513, 513, 520, 528)),
             ((8, 56, 8, 4096, 128), (4096, 4080, 1, 2049, 3000, 64, 65,
                                      4095)),
             # grok-1's decode layer, group 6
             ((8, 48, 8, 4096, 128), (4096, 4095, 1, 2047, 129, 3333, 64,
                                      4000)),
             ((3, 12, 2, 1000, 128), (1000, 999, 17))]
    decode_attention.narrow = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (b, hq, hkv, s, d), lens in cases:
            q, k, v = decode_operands(gen, dev, dtype, b, hq, hkv, s, d)
            if hkv == 4 and hq == 8:                 # replicated heads
                k, v = (t[:, ::2].repeat_interleave(2, dim=1) for t in (k, v))
            kv_len = (None if lens is None else
                      torch.tensor(lens, dtype=torch.int32, device=dev))
            got = decode_attention(q, k, v, kv_len)
            want = decode_ref(q, k, v, kv_len)
            torch.cuda.synchronize()
            name = f"q[{b},{hq},{d}] kv[{b},{hkv},{s},{d}]" + (
                "" if lens is None else f" kv_len{list(lens)[:4]}")
            check(got.shape == want.shape and got.dtype == dtype,
                  f"decode_attention {name}: shape/dtype")
            err, row = rel_err(got, want), row_err(got, want)
            log(f"[kernel] decode_attention {name:<58} {str(dtype)[6:]:<9} "
                f"max err {err:.3e} (tol {TOL[dtype]:.0e}), per row "
                f"{row:.3e} (tol {DECODE_ROW_TOL[dtype]:.0e})")
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"decode_attention {name} {dtype}: err {err}")
            check(math.isfinite(row) and row <= DECODE_ROW_TOL[dtype],
                  f"decode_attention {name} {dtype}: per-row err {row}")
            del q, k, v, got, want
    # a wrapped ring: zamba2's 4 096 slots at position 3·4096 + 1234 hold
    # the window's keys out of order (slot = position % 4096); B4 reads the
    # slots in their order and must give the attention over the keys in
    # position order
    b, h, s, d = 8, 32, 4096, 64
    pos = 3 * s + 1234
    order = torch.arange(pos - s + 1, pos + 1, device=dev) % s
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = decode_operands(gen, dev, dtype, b, h, h, s, d)
        got = decode_attention(q, k, v)
        want = decode_ref(q, k[:, :, order], v[:, :, order])
        err, row = rel_err(got, want), row_err(got, want)
        log(f"[kernel] decode_attention ring past the wrap q[{b},{h},{d}] "
            f"kv[{b},{h},{s},{d}] {str(dtype)[6:]:<9} max err {err:.3e}, "
            f"per row {row:.3e} (against the keys in position order)")
        check(err <= TOL[dtype] and row <= DECODE_ROW_TOL[dtype],
              f"decode_attention ring order {dtype}: {err}, {row}")
        del q, k, v, got, want
    log(f"[kernel] decode_attention bf16 calls on the CUDA-core kernel: "
        f"{decode_attention.narrow}")
    check(decode_attention.narrow == 0,
          "decode_attention: a bf16 case of these layouts left the ring")
    log("[kernel] decode_attention tolerance: as block_gemm's (the "
        "reference's 2e-5 / 2e-2; f32 sums and the partials' merge in "
        "another order; bf16: P rounded to bf16 before P·V and one bf16 "
        "rounding of an f32 result); per (batch, q head) row, max|kernel - "
        "plain| / max|plain| of the row, 1e-4 / 2e-2 "
        "(scripts/torch_decode_rounding.py)")
    for dtype in (torch.float32, torch.bfloat16):
        info = decode_kernel_info(dtype, 128, True, dev.index or 0)
        log(f"[kernel] decode_attention partials kernel, {str(dtype)[6:]} "
            f"D<=128 16-byte loads: {info.blocks_per_sm} resident blocks per "
            f"SM, {info.registers} registers and {info.spill_bytes} spill "
            f"bytes per thread, {info.smem_bytes} B shared, {info.ts}-"
            f"position tiles x {info.stages} (CUDA runtime)")


def phase_cholesky(dev, nb=32, pr=2, pc=2, b=512) -> dict:
    t0 = time.perf_counter()
    prog = cholesky_program(nb, pr, pc, b)
    plan = prog.plan_lowering()
    log(f"[cholesky] N={nb * b} nb={nb} b={b} grid {pr}x{pc}: "
        f"{prog.schedule.n_wavefronts} wavefronts, n_slots {prog.n_slots}, "
        f"plan {plan['mode']}; host build "
        f"{time.perf_counter() - t0:.2f} s")
    blocks, a = make_spd_blocks(nb, b, seed=0, device=dev)
    packed = prog.pack(blocks, device=dev)
    del blocks
    run = cholesky_executor(prog, matmul=task_matmul, device=dev)
    plain = cholesky_executor(prog, device=dev)
    check(run.mode == "segmented_scan", f"executor mode {run.mode}")

    run(packed)                                   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    run.calls.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(packed)
    end.record()
    end.synchronize()
    launches = block_gemm.launches
    batches = run.calls["syrk"] + run.calls["gemm"]
    wall = start.elapsed_time(end)
    log(f"[cholesky] kernel bodies: {wall:.1f} ms; block_gemm launches "
        f"{launches}, executor syrk+gemm batch calls {batches}; body calls "
        f"{dict(run.calls)}, largest batch {dict(run.max_batch)}")
    check(launches > 0 and launches == batches,
          f"block_gemm launches {launches} != syrk+gemm calls {batches}")

    L = assemble_lower(prog.unpack(out), nb, b)
    del out
    check(bool(torch.isfinite(L).all()), "Cholesky: non-finite L")
    resid = float(torch.linalg.vector_norm(torch.matmul(L, L.mT) - a)
                  / torch.linalg.vector_norm(a))
    log(f"[cholesky] ||L L^T - A||_F / ||A||_F = {resid:.3e} "
        f"(limit {CHOL_RESID_TOL:.0e})")
    check(resid <= CHOL_RESID_TOL, f"Cholesky residual {resid}")

    plain_ms = cuda_ms(lambda: plain(packed), 1)
    L_plain = assemble_lower(prog.unpack(plain(packed)), nb, b)
    diff = float((L - L_plain).abs().max())
    log(f"[cholesky] plain bodies: {plain_ms:.1f} ms; max|L_kernel - "
        f"L_plain| = {diff:.3e} (limit {CHOL_PLAIN_TOL:.0e})")
    check(diff <= CHOL_PLAIN_TOL, f"Cholesky kernel vs plain {diff}")
    del L_plain

    # The auto policy keeps the JAX package's plan (union-cover scan, tables
    # padded to each type's largest batch); the unrolled lowering of the same
    # program runs only the real tasks. B1 is bitwise batch-independent;
    # the library's potrf/trsm may not be, hence a tolerance.
    unrolled = cholesky_executor(prog, matmul=task_matmul, device=dev,
                                 unroll_cap=prog.schedule.n_wavefronts)
    unrolled_ms = cuda_ms(lambda: unrolled(packed), 1)
    L_unrolled = assemble_lower(prog.unpack(unrolled(packed)), nb, b)
    diff = float((L - L_unrolled).abs().max())
    log(f"[cholesky] unrolled lowering, kernel bodies: {unrolled_ms:.1f} ms; "
        f"max|L_scan - L_unrolled| = {diff:.3e} (limit {CHOL_PLAIN_TOL:.0e})")
    check(diff <= CHOL_PLAIN_TOL, f"Cholesky scan vs unrolled {diff}")
    return {"launches": launches, "max_batch": run.max_batch["gemm"],
            "L": L, "L_unrolled": L_unrolled, "ms": wall,
            "unrolled_ms": unrolled_ms}


# The host runtime's factor against the compiled executor's, per L block as
# max|host - compiled| / max(1, max|compiled|): the same B1 on every syrk
# and gemm, one task per launch against whole wavefronts (B1 is bitwise
# batch-independent), but potrf/trsm through the library one block at a
# time against batched calls, which may round differently; a difference
# of a few f32 ulps of |L| <= ~2.5 carried through 32 panels stays near
# u * sqrt(n) ~ 8e-6, while a wrong block gives ~1. The reference's 2e-5.
HOST_TOL = 2e-5


def block_err(got: torch.Tensor, want: torch.Tensor, b: int) -> float:
    """Largest over the b x b blocks of max|got - want| / max(1, max|want|)
    within the block."""
    nb = want.shape[0] // b
    diff = (got - want).abs().view(nb, b, nb, b).amax((1, 3))
    size = want.abs().view(nb, b, nb, b).amax((1, 3)).clamp(min=1.0)
    return float((diff / size).max())


def run_host(spec, blocks, bodies, dev, **kw):
    """``run_host_ptg`` on ``inproc`` with 2 worker threads a rank; returns
    (blocks, wall ms on the host clock, which includes its final
    synchronise)."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = run_host_ptg(spec, blocks, bodies, n_threads=2, timeout=600.0,
                       transport="inproc", device=dev, **kw)
    return out, 1e3 * (time.perf_counter() - t1)


def phase_host_runtime(dev, L_compiled, nb=32, pr=2, pc=2, b=512,
                       nb_faults=8) -> dict:
    """The paper's example program on the host TaskTorrent runtime: the
    Cholesky of ``phase_cholesky`` through ``Graph.run_host``'s lowering,
    4 ranks x 2 worker threads on ``inproc``, block stores on the card."""
    # B1 is built and loaded (phase_build, phase_kernel_vs_plain) before any
    # rank starts: no worker thread builds. Held here at the host's shape,
    # one unbatched [b, b] x [b, b]^T block per launch.
    check(_build.library_path("block_gemm").exists(), "B1 not built")
    gen = torch.Generator(device=dev).manual_seed(3)
    a1 = torch.randn((b, b), generator=gen, device=dev)
    b1 = torch.randn((b, b), generator=gen, device=dev).mT
    err = rel_err(matmul(a1, b1), block_gemm_ref(a1, b1))
    log(f"[host] block_gemm [{b},{b}]@[{b},{b}].mT unbatched: max err "
        f"{err:.3e} (tol {TOL[torch.float32]:.0e})")
    check(err <= TOL[torch.float32], f"block_gemm host task shape: {err}")

    t0 = time.perf_counter()
    graph = cholesky_graph(nb, pr, pc, b)
    spec = graph.to_block_spec()
    counts = {t: 0 for t in ("potrf", "trsm", "syrk", "gemm")}
    for k in (k for v in spec.views for k in v.tasks):
        counts[spec.ptg.type_of(k)] += 1
    n_tasks = sum(counts.values())
    log(f"[host] cholesky-16k-host: N={nb * b} nb={nb} b={b}, {pr * pc} "
        f"ranks x 2 threads on inproc; {n_tasks} tasks {counts}; graph "
        f"derivation {time.perf_counter() - t0:.2f} s")
    blocks, a = make_spd_blocks(nb, b, seed=0, device=dev)
    bodies = cholesky_bodies(matmul=matmul)

    _, warm_ms = run_host(spec, blocks, bodies, dev)
    reset_launches()
    payload_stats.reset()
    out, wall_ms = run_host(spec, blocks, bodies, dev)
    launches = block_gemm.launches
    want = counts["syrk"] + counts["gemm"]
    pairs = dict(sorted(payload_stats.pairs.items()))
    log(f"[host] wall {wall_ms:.1f} ms (warm-up {warm_ms:.1f}), "
        f"{1e3 * n_tasks / wall_ms:.0f} tasks/s; block_gemm launches "
        f"{launches} (syrk + gemm tasks {want}); tensors copied on the card "
        f"{payload_stats.copied}, pickled {payload_stats.pickled}")
    log("[host] AMs and tensor bytes per rank pair (src->dst): " + ", ".join(
        f"{s}->{d} {n} {nbytes / 2 ** 20:.0f} MiB"
        for (s, d), (n, nbytes) in pairs.items()))
    check(launches == want,
          f"host runtime: block_gemm launches {launches} != {want}")
    check(payload_stats.pickled == 0 and payload_stats.copied > 0,
          f"host runtime: {payload_stats.pickled} tensors pickled, "
          f"{payload_stats.copied} copied on the card")
    check(all(t.is_cuda for t in out.values()),
          "host runtime: a result block left the card")

    L = assemble_lower(out, nb, b)
    del out
    check(bool(torch.isfinite(L).all()), "host Cholesky: non-finite L")
    resid = float(torch.linalg.vector_norm(torch.matmul(L, L.mT) - a)
                  / torch.linalg.vector_norm(a))
    err = block_err(L, L_compiled, b)
    same = bool(torch.equal(L, L_compiled))
    log(f"[host] ||L L^T - A||_F / ||A||_F = {resid:.3e} (limit "
        f"{CHOL_RESID_TOL:.0e}); against the compiled executor's factor: "
        f"{err:.3e} per L block (limit {HOST_TOL:.0e}), bit for bit: {same}")
    check(resid <= CHOL_RESID_TOL, f"host Cholesky residual {resid}")
    check(err <= HOST_TOL, f"host Cholesky vs compiled {err}")
    del L, a

    busy, busy_ms, prof_ms = profile(
        "cholesky-16k-host", lambda: run_host(spec, blocks, bodies, dev),
        detail=True)
    identity = {t: (lambda *ops: ops[0]) for t in counts}
    _, id_ms = run_host(spec, blocks, identity, dev)
    _, id_ms2 = run_host(spec, blocks, identity, dev)
    id_ms = min(id_ms, id_ms2)
    log(f"[host] runtime alone (bodies return their first operand): "
        f"{id_ms:.1f} ms, {1e3 * id_ms / n_tasks:.1f} us a task")
    del blocks

    # faults on the card: loss, duplication and rank 3 killed at its 2nd
    # user AM, as tests/test_fault_tolerance.py drives the CPU run
    g8 = cholesky_graph(nb_faults, pr, pc, b)
    spec8 = g8.to_block_spec()
    blocks8, _ = make_spd_blocks(nb_faults, b, seed=1, device=dev)
    ref, ref_ms = run_host(spec8, blocks8, bodies, dev)
    total = sum(v.stats.get("derived_edges", 0) for v in g8.local_views())
    plan = FaultPlan(seed=5, drop=0.10, duplicate=0.10, kill={3: 2})
    (got, report), fault_ms = run_host(spec8, blocks8, bodies, dev,
                                       faults=plan,
                                       rederive=g8.derive_local,
                                       total_edges=total)
    same8 = got.keys() == ref.keys() and all(
        torch.equal(got[k], ref[k]) for k in ref)
    log(f"[host] faults nb={nb_faults} b={b}: fault-free {ref_ms:.1f} ms, "
        f"faulted {fault_ms:.1f} ms, bit for bit: {same8}; RecoveryReport "
        f"{report.to_dict()}")
    check(same8, "host Cholesky under faults differs from the fault-free run")
    check(report.deaths == [3] and report.reexecuted_tasks > 0,
          f"host Cholesky under faults: {report.to_dict()}")
    del ref, got, blocks8

    reps = 50
    kernel = cuda_ms(lambda: matmul(a1, b1), reps)
    plain = cuda_ms(lambda: block_gemm_ref(a1, b1), reps)
    library = cuda_ms(lambda: torch.matmul(a1, b1), reps)
    kernel2 = cuda_ms(lambda: matmul(a1, b1), reps)
    bnd, _ = gemm_bound_ms(a1[None], b1[None])
    log(f"[time] block_gemm host task [{b},{b}]x[{b},{b}].mT: kernel "
        f"{kernel:.4f} / {kernel2:.4f} ms, plain {plain:.4f} ms, "
        f"torch.matmul {library:.4f} ms, bound {bnd:.4f} ms")
    return {"launches": launches, "wall_ms": wall_ms,
            "ms": min(kernel, kernel2), "plain_ms": plain,
            "library_ms": library, "bound_ms": bnd, "busy": busy,
            "busy_ms": busy_ms, "id_us": 1e3 * id_ms / n_tasks}


def chained_stream(svc, g, blocks, bodies, m: int) -> list:
    """One client streams ``m`` submissions of ``g`` chained through one
    namespace: the first seeds ``blocks``, each later one reads what the
    one before it wrote. Returns the results in order."""
    c = svc.client("chain")
    futs = [c.submit(g, blocks if j == 0 else {}, bodies) for j in range(m)]
    return [f.result(svc.timeout) for f in futs]


def chained_one_shots(g, blocks, bodies, m: int, dev) -> list:
    """The oracle of :func:`chained_stream`: ``m`` sequential one-shot
    ``run_host`` calls, each seeded with everything the earlier ones
    wrote (``chained_refs`` of ``tests/test_scheduler.py``)."""
    refs, store = [], dict(blocks)
    for _ in range(m):
        out = g.run_host(store, bodies, n_threads=2, timeout=600.0,
                         device=dev)
        refs.append(out)
        store.update(out)
    return refs


def same_blocks(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) for k in want)


def phase_scheduler(dev, nb=16, b=512, width=16, depth=12, n_shards=4,
                    n_clients=4, n_subs=8, n_chain=10, ov_width=8,
                    ov_depth=6, ov_subs=6) -> dict:
    """The resident multi-tenant scheduler on the card
    (``repro_torch.sched`` through ``launch.scheduler.run_stream``):
    ``n_shards`` resident ``inproc`` ranks x 2 worker threads, block stores
    on the card, Cholesky syrk/gemm tasks on B1.

    - sched-mixed-4x8: ``n_clients`` clients (weights 1..4) x ``n_subs``
      submissions in fresh namespaces: Task-Bench stencil/fft/tree
      (``width`` x ``depth``, b x b f32 blocks) and, at j = 3 and 7, a
      Cholesky of ``nb`` x ``nb`` blocks of b (on ``n_shards`` x 1);
    - sched-chained-10: ``n_chain`` stencil submissions chained through
      one namespace; sched-chained-10-kill: the same under a rank killed
      mid-stream (``benchmarks/scheduler_stream.py``'s plan);
    - overhead: ``n_clients`` x ``ov_subs`` stencil submissions of
      ``ov_width`` x ``ov_depth`` whose bodies return their first operand:
      the service's own cost a task (``sched_overhead_us``)."""
    from repro_torch.launch.scheduler import (one_shot_refs, run_stream,
                                              stream_inputs)
    from repro_torch.sched import SchedulerService
    from repro_torch.taskbench import (taskbench_blocks, taskbench_bodies,
                                       taskbench_graph)

    check(_build.library_path("block_gemm").exists(), "B1 not built")
    where = card()
    torch.cuda.reset_peak_memory_stats()
    sizes = dict(width=width, depth=depth, nb=nb, b=b, tb_b=b)
    counts = {"potrf": nb, "trsm": nb * (nb - 1) // 2,
              "syrk": nb * (nb - 1) // 2,
              "gemm": nb * (nb - 1) * (nb - 2) // 6}
    kinds = ["cholesky" if j % 4 == 3 else
             ("stencil", "fft", "tree")[j % 4] for j in range(n_subs)]
    n_chol = n_clients * kinds.count("cholesky")
    n_tasks = n_clients * sum(sum(counts.values()) if k == "cholesky"
                              else width * depth for k in kinds)
    want_b1 = n_chol * (counts["syrk"] + counts["gemm"])
    log(f"[sched] sched-mixed-{n_clients}x{n_subs}: {n_shards} resident "
        f"inproc ranks x 2 threads, stores on the card; Task-Bench "
        f"{width}x{depth} at b {b}, Cholesky nb {nb} b {b} (N {nb * b}) "
        f"{counts}; {n_tasks} tasks, {n_clients * n_subs} submissions, "
        f"{want_b1} B1 launches expected [{where}]")

    def mixed(inputs):
        """One mixed stream in a fresh service: (svc, results, wall ms of
        the first submit to the last result, after a synchronise)."""
        with SchedulerService(n_shards, n_threads=2, timeout=600.0,
                              device=dev) as svc:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = run_stream(svc, n_clients, n_subs, inputs=inputs,
                             **sizes)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1)
        return svc, res, ms

    inputs = stream_inputs(dev, **sizes)
    reset_launches()
    payload_stats.reset()
    svc, results, wall_ms = mixed(inputs)
    launches = block_gemm.launches
    pickled, copied = payload_stats.pickled, payload_stats.copied
    stats = svc.stats()
    log(f"[sched] mixed: wall {wall_ms:.1f} ms, "
        f"{1e3 * n_tasks / wall_ms:.0f} tasks/s, "
        f"{1e3 * n_clients * n_subs / wall_ms:.2f} submissions/s; "
        f"block_gemm launches {launches} (expected {want_b1}); tensors "
        f"copied on the card {copied}, pickled {pickled}; live_frac "
        f"{stats['live_frac']:.4f} (blocks_hwm {stats['blocks_hwm']} / "
        f"blocks_total {stats['blocks_total']}) [{where}]")
    check(launches == want_b1,
          f"scheduler: block_gemm launches {launches} != {want_b1}")
    check(pickled == 0 and copied > 0,
          f"scheduler: {pickled} tensors pickled, {copied} copied")
    check(all(r["tasks_live"] == 0 for r in stats["ranks"]),
          f"scheduler: tasks live after the drain {stats['ranks']}")
    check(all(stats["clients"][f"client{i}"]["completed"] == n_subs
              for i in range(n_clients)),
          f"scheduler: completed {stats['clients']}")
    check(stats["live_frac"] < 1.0, f"live_frac {stats['live_frac']}")
    check(all(v.is_cuda for rows in results.values() for _, out in rows
              for v in out.values()), "scheduler: a result left the card")

    refs = one_shot_refs(svc, set(kinds), inputs=inputs, **sizes)
    # stream_inputs' matrix: drawn on the card (numpy's on the CPU)
    _, a = make_spd_blocks(nb, b, seed=7,
                           device=dev if dev.type == "cuda" else None)
    a = torch.as_tensor(a, device=dev)
    worst = 0.0
    for name, rows in sorted(results.items()):
        for kind, out in rows:
            check(all(torch.equal(v, refs[kind][blk])
                      for blk, v in out.items()),
                  f"scheduler: {name} {kind} differs from its one-shot")
            if kind == "cholesky":
                L = assemble_lower(out, nb, b)
                worst = max(worst, float(
                    torch.linalg.vector_norm(torch.matmul(L, L.mT) - a)
                    / torch.linalg.vector_norm(a)))
                del L
    log(f"[sched] every submission bit for bit its one-shot run_host on "
        f"the card; worst Cholesky ||L L^T - A||_F / ||A||_F {worst:.3e} "
        f"(limit {CHOL_RESID_TOL:.0e})")
    check(worst <= CHOL_RESID_TOL, f"scheduler Cholesky residual {worst}")
    del results, refs, a, svc
    busy, busy_ms, prof_ms = profile(f"sched-mixed-{n_clients}x{n_subs}",
                                     lambda: mixed(inputs), detail=True)
    del inputs
    torch.cuda.empty_cache()

    # sched-chained-10, fault-free and with rank 1 killed at its 30th AM
    g_chain, _ = taskbench_graph("stencil", width, depth, n_shards, b,
                                 seed=11)
    blocks = {k: torch.as_tensor(v, device=dev) for k, v in
              taskbench_blocks(width, depth, b, seed=11).items()}
    bodies = taskbench_bodies()
    refs = chained_one_shots(g_chain, blocks, bodies, n_chain, dev)
    chain = {}
    for label, plan in (("chained", None),
                        ("chained-kill", FaultPlan(
                            seed=11, kill={1: 30}, lease=0.4,
                            heartbeat_every=0.02))):
        with SchedulerService(n_shards, timeout=600.0, faults=plan,
                              device=dev) as svc:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs = chained_stream(svc, g_chain, blocks, bodies, n_chain)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1)
        st = svc.stats()
        chain[label] = {"ms": ms, "outs": outs, "svc": svc,
                        "live_frac": st["live_frac"]}
        log(f"[sched] sched-{label}-{n_chain}: wall {ms:.1f} ms, "
            f"{1e3 * n_chain * width * depth / ms:.0f} tasks/s, "
            f"{1e3 * n_chain / ms:.2f} submissions/s, live_frac "
            f"{st['live_frac']:.4f} (blocks_hwm {st['blocks_hwm']} / "
            f"blocks_total {st['blocks_total']}) [{where}]")
    check(all(same_blocks(o, r)
              for o, r in zip(chain["chained"]["outs"], refs)),
          "sched-chained: differs from the sequential one-shots")
    killed = chain["chained-kill"]
    check(all(same_blocks(o, r) for o, r in zip(killed["outs"],
                                                chain["chained"]["outs"])),
          "sched-chained-kill: differs from the fault-free stream")
    rep = killed["svc"].recovery_report
    recover_ms = killed["svc"].capacity()["sched_recover_ms"]
    replay_frac = rep.bus_replayed / max(killed["svc"].bus.posted, 1)
    log(f"[sched] kill: bit for bit the fault-free stream; "
        f"sched_recover_ms {recover_ms}, replay_frac {replay_frac:.4f}; "
        f"RecoveryReport {rep.to_dict()} [{where}]")
    check(rep.deaths == [1], f"sched-chained-kill deaths {rep.deaths}")
    del chain, killed, refs, blocks

    # the service's own cost: bodies that return their first operand
    go, _ = taskbench_graph("stencil", ov_width, ov_depth, n_shards, b,
                            seed=11)
    ob = {k: torch.as_tensor(v, device=dev) for k, v in
          taskbench_blocks(ov_width, ov_depth, b, seed=11).items()}
    ident = {t: (lambda *ops: ops[0]) for t in bodies}
    ov_tasks = n_clients * ov_subs * ov_width * ov_depth
    with SchedulerService(n_shards, timeout=600.0, device=dev) as svc:
        clients = [svc.client(f"c{i}", weight=float(i + 1))
                   for i in range(n_clients)]
        t1 = time.perf_counter()
        futs = [c.submit(go, ob, ident, namespace=f"{c.name}/{j}")
                for c in clients for j in range(ov_subs)]
        for f in futs:
            f.result(svc.timeout)
        torch.cuda.synchronize()
        ov_ms = 1e3 * (time.perf_counter() - t1)
    overhead_us = 1e3 * ov_ms / ov_tasks
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the services' rank runtimes hold the namespaces' durable versions and
    # sit in reference cycles: free them before the model phases
    del svc, clients, futs, ob
    gc.collect()
    log(f"[sched] overhead: {n_clients} x {ov_subs} stencil "
        f"{ov_width}x{ov_depth} submissions, identity bodies: {ov_ms:.1f} "
        f"ms, sched_overhead_us {overhead_us:.1f}, "
        f"{1e3 * n_clients * ov_subs / ov_ms:.2f} submissions/s; phase "
        f"peak device memory {peak:.2f} GiB [{where}]")
    return {"launches": launches, "wall_ms": wall_ms, "busy": busy,
            "busy_ms": busy_ms, "overhead_us": overhead_us}


def phase_gemm(dev, nb=8, pr=2, pc=2, b=1024) -> dict:
    n = nb * b
    prog = gemm_2d_program(nb, pr, pc, b, staged=True)
    blocks = make_blocks(None, nb, b, seed=1, device=dev)
    A, B = assemble(blocks, "A", nb, b), assemble(blocks, "B", nb, b)
    packed = prog.pack(blocks, device=dev)
    del blocks
    run = gemm_executor(prog, matmul=task_matmul, device=dev)
    run(packed)                                   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    run.calls.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(packed)
    end.record()
    end.synchronize()
    launches = block_gemm.launches
    wall = start.elapsed_time(end)
    log(f"[gemm] N={n} staged, {prog.schedule.n_wavefronts} wavefronts, "
        f"mode {run.mode}: {wall:.1f} ms; block_gemm "
        f"launches {launches}, executor gemm batch calls "
        f"{run.calls['gemm']}, largest batch {run.max_batch['gemm']}")
    check(launches > 0 and launches == run.calls["gemm"],
          f"GEMM: launches {launches} != gemm calls {run.calls['gemm']}")
    C = assemble(prog.unpack(out), "C", nb, b)
    ref = torch.matmul(A, B)
    check(bool(torch.isfinite(C).all()), "GEMM: non-finite C")
    err = float((C - ref).abs().max() / ref.abs().max())
    log(f"[gemm] max|C - A@B| / max|A@B| = {err:.3e} (limit {GEMM_TOL:.0e})")
    check(err <= GEMM_TOL, f"GEMM error {err}")
    return {"launches": launches, "max_batch": run.max_batch["gemm"],
            "C": C, "ms": wall}


def phase_attention_chain(dev, depth=16, seq=4096, dim=128, n_sh=2) -> dict:
    t0 = time.perf_counter()
    prog = chain_graph(depth, seq, dim, n_sh).to_program()
    packed = prog.pack(chain_blocks(depth, seq, dim, seed=7, device=dev),
                       device=dev)
    run = prog.auto_executor(chain_bodies(), device=dev)
    plain = prog.auto_executor(chain_bodies(kernel=False), device=dev)
    log(f"[chain] seq {seq} dim {dim} depth {depth} over {n_sh} shards: "
        f"{prog.schedule.n_wavefronts} wavefronts, mode {run.mode}; host "
        f"build {time.perf_counter() - t0:.2f} s")
    run(packed)                                   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    run.calls.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(packed)
    end.record()
    end.synchronize()
    launches = flash_attention.launches
    wall = start.elapsed_time(end)
    log(f"[chain] task_attention bodies: {wall:.2f} ms; "
        f"flash_attention launches {launches}, executor attn calls "
        f"{run.calls['attn']}, largest batch {run.max_batch['attn']} "
        f"(the store's shards ride in one batch)")
    check(launches > 0 and launches == run.calls["attn"],
          f"chain: launches {launches} != attn calls {run.calls['attn']}")
    busy = profile("attention chain", lambda: run(packed))
    check(bool(torch.isfinite(out).all()), "chain: non-finite blocks")
    # Each task against mha_ref on the same input: the kernel's own error.
    x = prog.unpack(out)

    def task_err(l):
        prev = x[("x", l - 1)][None, None]
        return rel_err(x[("x", l)], mha_ref(prev, prev, prev)[0, 0])

    step_err = max(task_err(l) for l in range(1, depth + 1))
    plain_ms = cuda_ms(lambda: plain(packed), 1)
    ref = plain(packed)
    err = max(rel_err(out[s, slot], ref[s, slot])
              for s, slot in prog.slot_of.values())
    log(f"[chain] mha_ref bodies: {plain_ms:.2f} ms; per task, kernel vs "
        f"mha_ref on its input: max err {step_err:.3e} (tol "
        f"{TOL[torch.float32]:.0e}); whole chain vs the mha_ref-bodied run: "
        f"max err {err:.3e} (tol {CHAIN_TOL:.0e})")
    check(step_err <= TOL[torch.float32], f"chain task vs mha_ref: {step_err}")
    check(err <= CHAIN_TOL, f"chain vs mha_ref bodies: {err}")
    check(flash_attention.copies == 0, "chain: operands copied")
    # every lowering of the program gives the same blocks, bit for bit
    bodies = chain_bodies()
    for name, kw in (("unrolled", dict(scan=False)),
                     ("dense scan", dict(scan=True)),
                     ("union cover", dict(scan=True, cover="union"))):
        other = prog.executor(bodies, device=dev, **kw)(packed)
        check(all(torch.equal(other[s, slot], out[s, slot])
                  for s, slot in prog.slot_of.values()),
              f"chain: the {name} lowering differs from {run.mode}")
    log(f"[chain] unrolled, dense-scan and union-cover lowerings: bit for "
        f"bit as {run.mode}")
    return {"launches": launches, "seq": seq, "dim": dim, "busy": busy,
            "x": x, "ms": wall}


# The ranked cells whose paths launch each kernel (phase_ranks).
RANK_CELLS = {"block_gemm": ("cholesky-16k-r4", "gemm2d-8k-r4"),
              "flash_attention": ("attn-chain-4k-r2",
                                  "starcoder2-3b-pipe2-r2 forward")}
# Ranked against one-device, per L block as ``block_err`` measures (the
# host runtime's measure, HOST_TOL): the same B1 on every syrk and gemm
# (bitwise batch-independent), but each rank's batched potrf and trsm
# library calls take a quarter of the one-device batch and may round
# differently.
RANK_CHOL_TOL = HOST_TOL


# what a transport's exchange ms count: the device transport times the
# exchange's own work on the rank's stream, gloo the host's issue and wait
EXCHANGE_CLOCK = {"device": "CUDA events on the rank's stream",
                  "gloo": "host clock after the stream drained"}


def transport_of(runs) -> str:
    """``runs``' transport as a phrase: its name and mailbox size."""
    name = runs[0]["transport"]
    if name == "device":
        return (f"device transport (mailboxes of "
                f"{runs[0]['mailbox_bytes'] / 2 ** 20:.0f} MiB a rank)")
    return "gloo over pinned host buffers"


def check_transport(tag: str, runs, want: str = "device") -> None:
    """Every rank of a cell ran on transport ``want``; on the device
    transport nothing was staged through the host and every mailbox is
    MAILBOX_BYTES."""
    staged = [r["staged_bytes"] for r in runs]
    log(f"[transport] {tag}: {transport_of(runs)}; bytes staged through "
        f"the host per rank {staged}")
    check(all(r["transport"] == want for r in runs),
          f"{tag}: transports {[r['transport'] for r in runs]}, not {want}")
    if want == "device":
        check(not any(staged) and all(r["mailbox_bytes"] == MAILBOX_BYTES
                                      for r in runs),
              f"{tag}: staged {staged} on the device transport")


def rank_blocks(prog, results, run: int, dev) -> dict:
    """{block: tensor on ``dev``} of the owned blocks the ranks returned
    from their ``run``-th run."""
    return {blk: t.to(dev) for blk, t in owned_blocks(
        prog, [res[run] for res in results]).items()}


def rank_report(tag, prog, results, run: int, one_ms: float, wire: dict,
                kernel: str, types, transport: str = "device") -> dict:
    """Print one ranked run (wall time on the slowest rank beside the
    one-device time; per rank exchange and body ms, the kernel's launches
    against the rank's body calls of ``types``, bytes sent per peer) and
    check its counts: launches = calls on every rank, bytes per peer =
    the lowering's tables, their sum = ``wire`` (``comm_stats``). Returns
    each rank's launches."""
    runs = [res[run] for res in results]
    bb = wire["block_bytes"]
    wall = max(r["wall_ms"] for r in runs)
    log(f"[ranks] {tag} {runs[0]['name']} ({runs[0]['mode']}) on "
        f"{len(runs)} processes, {transport_of(runs)}: {wall:.1f} ms (host "
        f"clock between barriers, slowest rank); one device: "
        f"{one_ms:.1f} ms; {card()}")
    check_transport(tag, runs, transport)
    launches = []
    for r in runs:
        calls = sum(r["calls"].get(t, 0) for t in types)
        n = r["launches"][kernel]
        launches.append(n)
        log(f"[ranks]   rank {r['rank']}: exchange {r['exchange_ms']:.1f} "
            f"ms ({r['exchange_ms'] / r['wall_ms']:.1%} of its wall; "
            f"{r['stage_ms']:.1f} ms of it copying to pinned memory; "
            f"{EXCHANGE_CLOCK[r['transport']]}), "
            f"bodies {r['body_ms']:.1f} ms, {kernel} launches {n} = "
            f"{'+'.join(types)} calls {calls}; bytes sent per peer "
            f"{r['sent_bytes']} ({r['sent_msgs']} messages), staged "
            f"{r['staged_bytes']}")
        check(n > 0 and n == calls, f"{tag}: rank {r['rank']} {kernel} "
              f"launches {n} != {'+'.join(types)} calls {calls}")
        check(r["sent_bytes"] == [m * bb for m in r["wire_blocks"]],
              f"{tag}: rank {r['rank']} sent {r['sent_bytes']}, its "
              f"tables ship {r['wire_blocks']} blocks")
    sent = sum(sum(r["sent_bytes"]) for r in runs)
    own = sum(r["sent_bytes"][r["rank"]] for r in runs)
    log(f"[ranks]   wire: {sent} bytes sent = comm_stats "
        f"{wire['total_wire_bytes']} ({wire['real_bytes']} real, "
        f"efficiency {wire['wire_efficiency']:.3f}); {own} of them from "
        f"ranks to themselves (a dense exchange's own row, which "
        f"comm_stats counts as wire; it is copied within the process)")
    check(sent == wire["total_wire_bytes"],
          f"{tag}: {sent} bytes sent != comm_stats "
          f"{wire['total_wire_bytes']}")
    return launches


def phase_ranks(dev, chol: dict, gemm: dict, chain: dict, nb=32, b=512,
                gemm_nb=8, gemm_b=1024, depth=16, seq=4096, dim=128) -> dict:
    """The block executor with one process per shard (``dist.ranks``):
    cholesky-16k-r4 and gemm2d-8k-r4 in one world of 4 rank processes,
    attn-chain-4k-r2 in one of 2, all on the one card, exchanging through
    the device transport (the ranks' mailboxes), then the same worlds
    again on gloo over pinned host buffers. Each run is held against the
    one-device phase's result of the same program: Cholesky's L blocks
    within RANK_CHOL_TOL of the same lowering's (and its residual), GEMM's
    C and the chain's blocks bit for bit; and every block the device
    transport's ranks returned bit for bit the gloo run's (the exchanges
    are copies). Returns each cell's per-rank kernel launches on the
    device transport (Cholesky's in its unrolled run)."""
    t0 = time.perf_counter()
    chol_prog = cholesky_program(nb, 2, 2, b)
    gemm_prog = gemm_2d_program(gemm_nb, 2, 2, gemm_b, staged=True)
    chain_prog = chain_graph(depth, seq, dim, 2).to_program()
    chol_runs = [{"name": "union cover", "auto": True},
                 {"name": "unrolled", "scan": False, "comm": "auto",
                  "overlap": True, "warmup": 1}]
    once = [{"name": "auto", "auto": True, "warmup": 1}]
    got = {}
    for transport in ("device", "gloo"):
        t1 = time.perf_counter()
        world4 = spawn_ranks(run_jobs, 4, [
            (cholesky_rank, (nb, 2, 2, b, chol_runs),
             {"kernel": True, "on_device": True, "keep": ("L",)}),
            (gemm_rank, (gemm_nb, gemm_b, once),
             {"staged": True, "seed": 1, "kernel": True, "on_device": True,
              "keep": ("C",)})], device=dev, timeout=600,
            transport=transport)
        world2 = spawn_ranks(chain_rank, 2, depth, seq, dim, once,
                             device=dev, timeout=300, keep=("x",),
                             transport=transport)
        log(f"[ranks] two worlds on the {transport} transport spawned and "
            f"run: {time.perf_counter() - t1:.1f} s")
        got[transport] = {"cholesky-16k-r4": [res[0] for res in world4],
                          "gemm2d-8k-r4": [res[1] for res in world4],
                          "attn-chain-4k-r2": world2}
        del world4, world2

    launches, walls = {}, {}
    _, a = make_spd_blocks(nb, b, seed=0, device=dev)
    wires = (chol_prog.comm_stats(comm="auto", segmented=True,
                                  cover="union"),
             chol_prog.comm_stats(comm="auto"))
    for transport, res in got.items():
        chol_res = res["cholesky-16k-r4"]
        for run, (want, one_ms, wire) in enumerate(
                ((chol["L"], chol["ms"], wires[0]),
                 (chol["L_unrolled"], chol["unrolled_ms"], wires[1]))):
            n = rank_report("cholesky-16k-r4", chol_prog, chol_res, run,
                            one_ms, wire, "block_gemm", ("syrk", "gemm"),
                            transport)
            if transport == "device":
                launches["cholesky-16k-r4"] = n
            L = assemble_lower(rank_blocks(chol_prog, chol_res, run, dev), nb,
                               b)
            err = block_err(L, want, b)
            resid = float(torch.linalg.vector_norm(torch.matmul(L, L.mT) - a)
                          / torch.linalg.vector_norm(a))
            log(f"[ranks]   L against the one-device "
                f"{chol_res[0][run]['name']} run, per block: {err:.3e} (tol "
                f"{RANK_CHOL_TOL:.0e}); ||L L^T - A||_F / ||A||_F = "
                f"{resid:.3e} (limit {CHOL_RESID_TOL:.0e})")
            check(err <= RANK_CHOL_TOL,
                  f"ranked Cholesky vs one device: {err}")
            check(resid <= CHOL_RESID_TOL, f"ranked Cholesky residual {resid}")
            del L

        gemm_res = res["gemm2d-8k-r4"]
        n = rank_report("gemm2d-8k-r4", gemm_prog, gemm_res, 0, gemm["ms"],
                        gemm_prog.comm_stats(comm="auto"), "block_gemm",
                        ("gemm",), transport)
        if transport == "device":
            launches["gemm2d-8k-r4"] = n
        C = assemble(rank_blocks(gemm_prog, gemm_res, 0, dev), "C", gemm_nb,
                     gemm_b)
        check(torch.equal(C, gemm["C"]), "ranked GEMM differs from one device")
        log("[ranks]   C bit for bit the one-device run's")
        del C

        world2 = res["attn-chain-4k-r2"]
        n = rank_report("attn-chain-4k-r2", chain_prog, world2, 0,
                        chain["ms"], chain_prog.comm_stats(comm="auto"),
                        "flash_attention", ("attn",), transport)
        if transport == "device":
            launches["attn-chain-4k-r2"] = n
        blocks = rank_blocks(chain_prog, world2, 0, dev)
        check(set(blocks) == {("x", l) for l in range(depth + 1)},
              "ranked chain: blocks missing")
        check(all(torch.equal(blocks[blk], chain["x"][blk])
                  for blk in blocks), "ranked chain differs from one device")
        log("[ranks]   every block bit for bit the one-device run's")
    del a

    # the device transport against gloo: the same blocks, bit for bit; per
    # cell and run the wall, the largest exchange share, bytes per peer
    for cell, dev_res in got["device"].items():
        for run in range(len(dev_res[0])):
            mine = [r[run] for r in dev_res]
            theirs = [r[run] for r in got["gloo"][cell]]
            same = all(torch.equal(x["row"], y["row"])
                       for x, y in zip(mine, theirs))
            line = {t: (max(r["wall_ms"] for r in rs),
                        max(r["exchange_ms"] / r["wall_ms"] for r in rs))
                    for t, rs in (("device", mine), ("gloo", theirs))}
            log(f"[ranks] {cell} {mine[0]['name']}: device transport "
                f"{line['device'][0]:.1f} ms (exchange up to "
                f"{line['device'][1]:.1%} of a rank's wall), gloo "
                f"{line['gloo'][0]:.1f} ms ({line['gloo'][1]:.1%}); bytes "
                f"per peer from rank 0 {mine[0]['sent_bytes']}, staged "
                f"{[r['staged_bytes'] for r in mine]} (gloo "
                f"{[r['staged_bytes'] for r in theirs]}); mailbox "
                f"{mine[0]['mailbox_bytes'] / 2 ** 20:.0f} MiB a rank; every "
                f"block bit for bit the gloo run's: {same} [{card()}]")
            check(same, f"{cell} {mine[0]['name']}: the device transport's "
                  "blocks differ from gloo's")
            walls[f"{cell} {mine[0]['name']}"] = {
                t: {"wall_ms": w, "exchange_share": x}
                for t, (w, x) in line.items()}
    log(f"[ranks] phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "walls": walls}


@contextlib.contextmanager
def plain_ssd():
    """The model's SSD through its plain version (the chunked algorithm),
    for the comparison with the kernel."""
    kernel = mamba2.ssd
    mamba2.ssd = ssd_chunked_ref
    try:
        yield
    finally:
        mamba2.ssd = kernel


# The mamba2 model checks, as max|diff| / max|reference logits|. The
# random-weight 48-layer model amplifies a rounding difference in one layer
# roughly a thousandfold by the logits: on the CPU, 48 layers of d_model
# 256 with the plain versions only (``scripts/torch_mamba2_rounding.py``),
# the chunked SSD against the token recurrence (the same f32 function, sums
# in other orders) differ by 1.6e-4 in f32 and by 0.42 (argmax agreement
# 0.00 over 2 sequences) in bf16, and prefill against decode by 1.7e-4 in
# f32 and 0.33 in bf16. So the bf16 serving run is
# compared and reported, and the gates run the same weights with compute
# dtype f32, where the kernel's f32 path must agree to MODEL_TOL: 30x the
# CPU amplification, while a wrong layer gives differences of order 1.
MODEL_TOL = 5e-3


def compare(got, want):
    """(max|got - want| / max|want|, argmax agreement) of two logits."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max() / want.abs().max()),
            float((got.argmax(-1) == want.argmax(-1)).float().mean()))


def prefill_vs_decode(cfg, params, prompt, dev, dtype=torch.bfloat16):
    """Logits of prefill over ``prompt`` against those after feeding it
    token by token through ``decode_step`` (a ``dtype`` cache)."""
    want = make_prefill_step(cfg)(params, {"tokens": prompt})
    cache = tfm.init_cache(cfg, prompt.shape[0], prompt.shape[1], dtype=dtype,
                           device=dev)
    for t in range(prompt.shape[1]):
        logits, cache = tfm.decode_step(cfg, params, prompt[:, t], cache)
    return compare(logits, want)


def profile(label: str, fn, detail: bool = False):
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    (top 8) and the device's busy share of the wall time (kernels run on one
    stream, so their times add). Returns the busy share (NaN when the
    profiler recorded no device time), or with ``detail`` (busy share,
    device busy ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile as trace
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        log(f"[profile] {label}: the profiler recorded no device time; "
            "device busy share not measured")
        nan = float("nan")
        return (nan, nan, wall_us / 1e3) if detail else nan
    log(f"[profile] {label} under the profiler: wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of "
        f"wall, idle share {1 - busy_us / wall_us:.3f}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.self_device_time_total / busy_us:6.3f}  x{e.count:<5} "
            f"{e.key[:90]}")
    if detail:
        return busy_us / wall_us, busy_us / 1e3, wall_us / 1e3
    return busy_us / wall_us


def serve_tokens(cfg, params, tok, cache, n: int):
    """``n`` greedy serve steps: (tokens [B, n], last logits, cache,
    seconds on the host clock, ending in a synchronise)."""
    serve = make_serve_step(cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for _ in range(n):
        tok, logits, cache = serve(params, tok, cache)
        out.append(tok)
    sample = torch.stack(out, 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    check(sample.shape == (tok.shape[0], n) and bool(
        ((sample >= 0) & (sample < cfg.vocab_size)).all())
        and bool(torch.isfinite(logits).all()), "serve: bad tokens")
    return sample, logits, cache, seconds


def phase_mamba2(dev, batch=4, prompt=2048, tokens=16, check_len=256) -> dict:
    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    log(f"[mamba2] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
        f" d_state {cfg.ssm.d_state}, vocab {cfg.vocab_size}; {n_par / 1e9:.3f}"
        f" B params, {4 * n_par / 1e9:.2f} GB f32, compute "
        f"{cfg.compute_dtype}; init {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :256]})     # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        logits = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        launches, narrow = ssd_scan.launches, ssd_scan.narrow
        log(f"[mamba2] prefill {batch} x {prompt} tokens: {1e3 * prefill_s:.1f}"
            f" ms, {batch * prompt / prefill_s:.0f} tok/s; ssd_scan launches "
            f"{launches}, with element-wise copies {narrow}")
        check(launches == cfg.n_layers,
              f"prefill: ssd_scan launches {launches} != {cfg.n_layers}")
        check(narrow == 0, f"prefill: {narrow} ssd_scan calls copied x, B "
                           "or C element by element")
        profile("prefill", lambda: step(params, {"tokens": toks}))
        check(tuple(logits.shape) == (batch, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} not finite/shaped")
        with plain_ssd():
            t1 = time.perf_counter()
            want = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
        err, agree = compare(logits, want)
        log(f"[mamba2] plain SSD prefill {1e3 * plain_s:.1f} ms; bf16 logits "
            f"kernel vs plain: {err:.3e}, argmax agreement {agree:.2f} "
            f"(reported; gated in f32 below)")
        del logits, want

        serve = make_serve_step(cfg)
        cache = tfm.init_cache(cfg, batch, prompt, device=dev)
        tok = torch.ones((batch,), dtype=torch.int64, device=dev)
        tok, _, cache = serve(params, tok, cache)    # warm-up, as the launcher
        sample, _, cache, serve_s = serve_tokens(cfg, params, tok, cache,
                                                 tokens)
        log(f"[mamba2] serve: {tokens} greedy tokens x batch {batch}: "
            f"{batch * tokens / serve_s:.1f} tok/s ({1e3 * serve_s / tokens:.2f}"
            f" ms per step; the decode step runs no kernel of the port); "
            f"sample {sample[0].tolist()}")
        del cache
        err, agree = prefill_vs_decode(cfg, params, toks[:, :check_len], dev)
        log(f"[mamba2] bf16 prefill({check_len}) vs {check_len} decode_steps:"
            f" {err:.3e}, argmax agreement {agree:.2f} (reported)")

        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        step32 = make_prefill_step(f32)
        reset_launches()
        logits = step32(params, {"tokens": toks})
        torch.cuda.synchronize()
        check(ssd_scan.launches == cfg.n_layers and ssd_scan.narrow == 0,
              "f32 prefill: launches, or element-wise copies")
        with plain_ssd():
            want = step32(params, {"tokens": toks})
        err, agree = compare(logits, want)
        log(f"[mamba2] f32 prefill {batch} x {prompt}, kernel vs plain SSD: "
            f"{err:.3e} (tol {MODEL_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= MODEL_TOL, f"f32 prefill kernel vs plain: {err}")
        del logits, want
        err, agree = prefill_vs_decode(f32, params, toks[:, :check_len], dev)
        log(f"[mamba2] f32 prefill({check_len}) vs {check_len} decode_steps: "
            f"{err:.3e} (tol {MODEL_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= MODEL_TOL, f"f32 prefill vs decode: {err}")
    del params
    return {"launches": launches, "prefill_ms": 1e3 * prefill_s,
            "serve_tok_s": batch * tokens / serve_s,
            "shape": [batch, prompt, cfg.ssm.n_heads(cfg.d_model),
                      cfg.ssm.head_dim, cfg.ssm.n_groups, cfg.ssm.d_state]}


@contextlib.contextmanager
def plain_attention():
    """The model's attention through the plain versions (``chunked_attention``
    for prefill, ``decode_ref`` for decode), for the comparison with B2 and
    B4."""
    kernels = tfm.prefill_attention, tfm.decode_attention_host
    tfm.prefill_attention, tfm.decode_attention_host = (chunked_attention,
                                                        decode_ref)
    try:
        yield
    finally:
        tfm.prefill_attention, tfm.decode_attention_host = kernels


def mla_decode_sdpa(cfg, p, x, cache, pos: int):
    """MLA's decode step as its prefill attends, a second correct
    implementation of the absorbed decode (``transformer._mla_decode``,
    f32 einsums over the latents) for the comparison: the latents written
    at ``pos`` alike, then keys and values expanded from the latent cache
    through ``wkv_b`` in the compute dtype and
    ``scaled_dot_product_attention`` over the positions <= ``pos``."""
    m = cfg.mla
    b = x.shape[0]
    h = tfm._mla_heads(cfg, p)
    ckv_cache, krope_cache = cache
    slot = min(pos, ckv_cache.shape[1] - 1)
    q_lat = rms_norm(x @ p["wq_a"], p["q_ln"], cfg.norm_eps)
    q = (q_lat @ p["wq_b"]).reshape(b, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    ckv_t, krope_t = (x @ p["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_dim],
                                            dim=-1)
    ckv_cache[:, slot] = rms_norm(ckv_t, p["kv_ln"], cfg.norm_eps)
    cos, sin = rope_freqs(torch.full((1,), pos, device=x.device),
                          m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope[:, :, None], cos, sin)[:, :, 0]
    krope_cache[:, slot] = apply_rope(krope_t[:, None, None], cos,
                                      sin)[:, 0, 0]
    n = slot + 1
    kvb = (ckv_cache[:, :n] @ p["wkv_b"]).reshape(
        b, n, h, m.qk_nope_dim + m.v_head_dim).transpose(1, 2)
    k_nope, v = kvb.split([m.qk_nope_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, krope_cache[:, None, :n].expand(
        b, h, n, m.qk_rope_dim)], -1)
    o = F.scaled_dot_product_attention(
        torch.cat([q_nope, q_rope], -1)[:, :, None], k, v)
    return (row_product(o[:, :, 0].reshape(b, h * m.v_head_dim), p["wo"]),
            (ckv_cache, krope_cache))


@contextlib.contextmanager
def plain_mla():
    """MLA's attention through a second correct implementation, for the
    comparison with the model's (no kernel of the port takes MLA):
    ``scaled_dot_product_attention`` in the prefill in place of
    ``chunked_attention``, ``mla_decode_sdpa`` in a decode step."""
    chunked, decode = tfm.chunked_attention, tfm._mla_decode
    tfm.chunked_attention = lambda q, k, v, causal=True: \
        F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    tfm._mla_decode = mla_decode_sdpa
    try:
        yield
    finally:
        tfm.chunked_attention, tfm._mla_decode = chunked, decode


# The yi-6b model checks, as max|diff| / max|reference logits|. The
# random-weight dense model hardly amplifies roundings: on the CPU, 32 layers
# of d_model 256 with yi-6b's GQA group of 8 and the plain versions only
# (``scripts/torch_dense_rounding.py``), attention in chunks against one
# block differs by 1.3e-6 in f32, prefill against decode by 1.1e-6 and a
# split-cache decode step against ``decode_ref`` by 9.9e-7; in bf16 by
# 1.6e-2 and 1.5e-2. The gates run f32 compute and hold the kernels' path
# to DENSE_TOL: ~80x the CPU gaps, room for full width's sums over 16x more
# terms (~4x the rounding), while a wrong layer gives differences of order
# 1. The bf16 comparisons are reported. The hybrid, encdec and vlm gates
# hold their f32 logits to the same (B3 runs on both sides of zamba2's,
# so only B2 or B4 differs; its 38 Mamba-2 layers carry the shared
# block's f32 rounding to the logits: 1.7e-5 measured at 5 120 tokens).
DENSE_TOL = 1e-4


def fill_cache(cache, upto: int, seed: int):
    """Seeded normal values in every segment's cache at positions [0,
    upto) (K and V [L, B, H, S, hd], or MLA's ckv and k_rope [L, B, S, *]):
    the cache after ``upto`` decoded tokens."""
    tensors = [t for seg in cache.layers.values() for t in seg]
    gen = torch.Generator(device=tensors[0].device).manual_seed(seed)
    for t in tensors:
        for i in range(t.shape[0]):
            t[i].narrow(t.dim() - 3, 0, upto).normal_(generator=gen)
    return cache._replace(pos=upto)


def step_vs_plain(cfg, params, make_cache, tok, b4: int):
    """(max|diff| / max|plain|, argmax agreement) of one decode step from
    ``make_cache()`` with B4 (``b4`` launches) against ``decode_ref``; the
    cache is made anew for each (a step writes it)."""
    out = []
    for plain in (False, True):
        cache = make_cache()
        reset_launches()
        with plain_attention() if plain else contextlib.nullcontext():
            logits, _ = tfm.decode_step(cfg, params, tok, cache)
        torch.cuda.synchronize()
        check(decode_attention.launches == (0 if plain else b4),
              f"{cfg.name} step vs plain: decode_attention launches "
              f"{decode_attention.launches}")
        out.append(logits)
        del cache
        torch.cuda.empty_cache()
    return compare(*out)


def long_step_vs_plain(cfg, params, batch: int, s: int, dev, seed=15):
    """One decode step at position s - 16 over a cache of s positions
    filled with seeded values, with B4 against ``decode_ref``."""
    dtype = tfm.dtype_of(cfg.compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                        device=dev)
    return step_vs_plain(cfg, params, lambda: fill_cache(tfm.init_cache(
        cfg, batch, s, dtype=dtype, device=dev), s - 16, seed), tok,
        cfg.n_layers)


def phase_dense(dev, batch=4, prompt=2048, serve_batch=8, tokens=16,
                long_seq=32768, check_len=256, gate_batch=2) -> dict:
    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    log(f"[dense] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} q heads over {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_par / 1e9:.3f} B params, {4 * n_par / 1e9:.2f} GB f32, compute "
        f"{cfg.compute_dtype}; init {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :256]})     # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        logits = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        b2 = flash_attention.launches
        log(f"[dense] prefill {batch} x {prompt} tokens: {1e3 * prefill_s:.1f}"
            f" ms, {batch * prompt / prefill_s:.0f} tok/s; flash_attention "
            f"launches {b2}")
        check(b2 == cfg.n_layers,
              f"prefill: flash_attention launches {b2} != {cfg.n_layers}")
        log(f"[dense] flash_attention operands copied for TMA: "
            f"{flash_attention.copies}")
        check(flash_attention.copies == 0, "prefill: operands copied")
        check(tuple(logits.shape) == (batch, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} not finite/shaped")
        prefill_busy = profile("yi-6b prefill",
                               lambda: step(params, {"tokens": toks}))
        with plain_attention():
            t1 = time.perf_counter()
            want = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
        err, agree = compare(logits, want)
        log(f"[dense] plain-attention prefill {1e3 * plain_s:.1f} ms; bf16 "
            f"logits kernel vs plain: {err:.3e}, argmax agreement "
            f"{agree:.2f} (reported; gated in f32 below)")
        del logits, want
        torch.cuda.empty_cache()

        # from a fresh cache, as the launcher does (its max_seq 512)
        cache = tfm.init_cache(cfg, serve_batch, 512, device=dev)
        tok = torch.ones((serve_batch,), dtype=torch.int64, device=dev)
        tok, _, cache = serve(params, tok, cache)    # warm-up
        reset_launches()
        sample, _, cache, fresh_s = serve_tokens(cfg, params, tok, cache,
                                                 tokens)
        b4 = decode_attention.launches
        log(f"[dense] serve from a fresh cache: {tokens} greedy tokens x batch "
            f"{serve_batch}: {serve_batch * tokens / fresh_s:.1f} tok/s "
            f"({1e3 * fresh_s / tokens:.2f} ms per step); decode_attention "
            f"launches {b4}; sample {sample[0].tolist()}")
        check(b4 == cfg.n_layers * tokens,
              f"fresh serve: decode_attention launches {b4}")
        check(decode_attention.narrow == 0,
              f"fresh serve: {decode_attention.narrow} bf16 B4 calls on the "
              "CUDA-core kernel")
        del cache

        # over a long cache: filled to long_seq - tokens - 2, one warm-up
        # and one profiled step, then ``tokens`` timed steps to long_seq
        cache = fill_cache(tfm.init_cache(cfg, serve_batch, long_seq,
                                          device=dev),
                           long_seq - tokens - 2, seed=14)
        long_ms, _, decode_busy = serve_phase(cfg, params, sample[:, -1],
                                              cache, tokens, "dense",
                                              cfg.n_layers)
        del cache
        torch.cuda.empty_cache()
        err, agree = long_step_vs_plain(cfg, params, serve_batch, long_seq,
                                        dev)
        log(f"[dense] bf16 decode step at position {long_seq - 16} of "
            f"{long_seq}, batch {serve_batch}, B4 vs decode_ref: {err:.3e}, "
            f"argmax agreement {agree:.2f} (reported)")
        err, agree = prefill_vs_decode(cfg, params, toks[:, :check_len], dev)
        log(f"[dense] bf16 prefill({check_len}) vs {check_len} decode_steps: "
            f"{err:.3e}, argmax agreement {agree:.2f} (reported)")

        prefill_gate(cfg, params, {"tokens": toks}, "dense", cfg.n_layers)
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        torch.cuda.empty_cache()
        err, agree = prefill_vs_decode(f32, params, toks[:, :check_len], dev,
                                       dtype=torch.float32)
        log(f"[dense] f32 prefill({check_len}) vs {check_len} decode_steps: "
            f"{err:.3e} (tol {DENSE_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= DENSE_TOL, f"f32 prefill vs decode: {err}")
        err, agree = long_step_vs_plain(f32, params, gate_batch, long_seq,
                                        dev)
        log(f"[dense] f32 decode step at position {long_seq - 16} of "
            f"{long_seq}, batch {gate_batch}, B4 vs decode_ref: {err:.3e} "
            f"(tol {DENSE_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= DENSE_TOL, f"f32 long-cache step B4 vs plain: {err}")
    del params
    return {"b2_launches": b2, "b4_per_step": cfg.n_layers,
            "prefill_ms": 1e3 * prefill_s, "prefill_busy": prefill_busy,
            "decode_busy": decode_busy, "long_ms": long_ms}


def model_params(cfg, dev, tag: str):
    """Seeded parameters of ``cfg`` on the card, in its ``param_dtype``,
    logged with their size."""
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    heads = (f"MLA over {cfg.n_heads} heads" if cfg.attention == "mla" else
             f"{cfg.n_heads} q heads over {cfg.n_kv_heads} KV heads of "
             f"{cfg.head_dim}")
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers"
        + (f" (+ {cfg.encoder_layers} encoder)" if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}, {heads}, vocab {cfg.vocab_size}; "
        f"{n_par / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB "
        f"{cfg.param_dtype}, compute {cfg.compute_dtype}; init "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def timed_prefill(step, params, batch, tag: str, b2: int, b3: int = 0):
    """One synchronised prefill after ``reset_launches``: (last logits,
    seconds); checks the B2 and B3 launch counts and that no operand was
    copied for TMA nor by B3 element by element."""
    reset_launches()
    t1 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    got = (flash_attention.launches, ssd_scan.launches)
    log(f"[{tag}] flash_attention launches {got[0]}, ssd_scan launches "
        f"{got[1]}; operands copied for TMA {flash_attention.copies}, "
        f"ssd_scan element-wise copies {ssd_scan.narrow}")
    check(got == (b2, b3), f"{tag}: B2, B3 launches {got} != {(b2, b3)}")
    check(flash_attention.copies == 0 and ssd_scan.narrow == 0,
          f"{tag}: operands copied")
    check(bool(torch.isfinite(logits).all()), f"{tag}: logits not finite")
    return logits, seconds


def prefill_gate(cfg, params, batch, tag: str, b2: int, b3: int = 0):
    """f32 prefill logits with B2 against the plain attention."""
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    step = make_prefill_step(f32)
    logits, _ = timed_prefill(step, params, batch, f"{tag} f32", b2, b3)
    with plain_attention():
        want = step(params, batch)
    err, agree = compare(logits, want)
    shape = "x".join(str(n) for n in next(iter(batch.values())).shape[:2])
    log(f"[{tag}] f32 prefill {shape}, B2 vs plain attention: {err:.3e} "
        f"(tol {DENSE_TOL:.0e}), argmax agreement {agree:.2f} [{card()}]")
    check(err <= DENSE_TOL, f"{tag}: f32 prefill kernel vs plain: {err}")


def step_gate(cfg, make_cache, tok, params, tag: str, b4: int):
    """One f32 decode step from ``make_cache()`` with B4 against
    ``decode_ref``, gated."""
    err, agree = step_vs_plain(cfg, params, make_cache, tok, b4)
    log(f"[{tag}] f32 decode step, batch {tok.shape[0]}, B4 vs decode_ref: "
        f"{err:.3e} (tol {DENSE_TOL:.0e}), argmax agreement {agree:.2f} "
        f"[{card()}]")
    check(err <= DENSE_TOL, f"{tag}: f32 decode step B4 vs plain: {err}")


def serve_phase(cfg, params, tok, cache, tokens: int, tag: str, b4: int):
    """One warm-up and one profiled serve step, then ``tokens`` timed greedy
    steps: B4 ``b4`` times a step, no bf16 call on its CUDA-core kernel.
    Returns (ms a step, tok/s, busy share of the profiled step)."""
    serve = make_serve_step(cfg)
    tok, _, cache = serve(params, tok, cache)              # warm-up
    last = {}
    busy = profile(f"{cfg.name} decode step at position {cache.pos}",
                   lambda: last.update(out=serve(params, tok, cache)))
    tok, _, cache = last.pop("out")
    reset_launches()
    sample, _, cache, seconds = serve_tokens(cfg, params, tok, cache, tokens)
    launches = decode_attention.launches
    batch = tok.shape[0]
    log(f"[{tag}] serve at positions {cache.pos - tokens}..{cache.pos - 1}: "
        f"{tokens} greedy tokens x batch {batch}: "
        f"{1e3 * seconds / tokens:.2f} ms per step, "
        f"{batch * tokens / seconds:.1f} tok/s; decode_attention launches "
        f"{launches} ({launches // tokens} a step), on its CUDA-core kernel "
        f"{decode_attention.narrow}; sample {sample[0].tolist()} [{card()}]")
    check(launches == b4 * tokens and decode_attention.narrow == 0,
          f"{tag}: decode_attention launches {launches}, narrow "
          f"{decode_attention.narrow}")
    return 1e3 * seconds / tokens, batch * tokens / seconds, busy


def fill_hybrid(cache, pos: int, seed: int):
    """Seeded values in every shared site's ring (all its slots: the
    window's keys after ``pos`` tokens) and in the Mamba-2 states."""
    gen = torch.Generator(device=cache.layers["ssm"].conv.device)
    gen.manual_seed(seed)
    for t in (*cache.layers["shared_kv"], *cache.layers["ssm"]):
        t.normal_(generator=gen)
    cache.layers["ssm"].ssm.mul_(0.1)
    return cache._replace(pos=pos)


def phase_hybrid(dev, batch=2, prompt=8192, serve_batch=8, tokens=16,
                 serve_pos=12288, gate_len=5120, gate_batch=2) -> dict:
    """zamba2-1.2b at full width and depth (38 Mamba-2 layers, the shared
    attention block after every 6 with its 4 096-token window). The f32
    gate's prompt of ``gate_len`` tokens is past the window and a multiple
    of the plain path's 1 024-key chunk (``chunked_attention`` takes no
    other length above one chunk)."""
    cfg = get_config("zamba2-1.2b")
    sites = len(tfm._hybrid_segments(cfg)) - 1
    params = model_params(cfg, dev, "hybrid")
    gen = torch.Generator(device=dev).manual_seed(21)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :512]})         # warm-up
        logits, prefill_s = timed_prefill(step, params, {"tokens": toks},
                                          "hybrid prefill", sites,
                                          cfg.n_layers)
        log(f"[hybrid] prefill {batch} x {prompt} tokens (window "
            f"{cfg.sliding_window} binds): {1e3 * prefill_s:.1f} ms, "
            f"{batch * prompt / prefill_s:.0f} tok/s [{card()}]")
        prefill_busy = profile("zamba2-1.2b prefill",
                               lambda: step(params, {"tokens": toks}))
        with plain_attention():
            want = step(params, {"tokens": toks})
        err, agree = compare(logits, want)
        log(f"[hybrid] bf16 logits B2 vs plain attention: {err:.3e}, argmax "
            f"agreement {agree:.2f} (reported; gated in f32 below)")
        del logits, want
        torch.cuda.empty_cache()

        cache = fill_hybrid(tfm.init_cache(cfg, serve_batch, 4 * 4096,
                                           device=dev), serve_pos, seed=22)
        ring = cache.layers["shared_kv"][0].shape[3]
        check(ring == cfg.sliding_window, f"hybrid ring of {ring} slots")
        tok = torch.randint(0, cfg.vocab_size, (serve_batch,), generator=gen,
                            device=dev)
        ms, tok_s, decode_busy = serve_phase(cfg, params, tok, cache, tokens,
                                             "hybrid", sites)
        del cache
        torch.cuda.empty_cache()

        prefill_gate(cfg, params, {"tokens": toks[:1, :gate_len]}, "hybrid",
                     sites, cfg.n_layers)
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        step_gate(f32, lambda: fill_hybrid(tfm.init_cache(
            f32, gate_batch, 4 * 4096, dtype=torch.float32, device=dev),
            serve_pos + 7, seed=23), tok[:gate_batch], params, "hybrid",
            sites)
    del params
    return {"b2_launches": sites, "b3_launches": cfg.n_layers,
            "b4_per_step": sites, "prefill_ms": 1e3 * prefill_s,
            "prefill_tok_s": batch * prompt / prefill_s,
            "prefill_busy": prefill_busy, "decode_ms": ms,
            "decode_tok_s": tok_s, "decode_busy": decode_busy}


def phase_encdec(dev, batch=4, frames=2048, prompt=512, tokens=16,
                 gate_frames=2048, gate_prompt=128, gate_batch=2) -> dict:
    """seamless-m4t-large-v2 at full width and depth (24 encoder layers
    over seeded frame embeddings, 24 decoder layers with cross-attention),
    decoding on from its own prefill: the prompt's self caches and the
    encoder's cross caches that the forward collected."""
    cfg = get_config("seamless-m4t-large-v2")
    b2 = cfg.encoder_layers + 2 * cfg.n_layers
    b4 = 2 * cfg.n_layers
    params = model_params(cfg, dev, "encdec")
    gen = torch.Generator(device=dev).manual_seed(31)
    enc = torch.randn((batch, frames, cfg.d_model), generator=gen,
                      device=dev)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :64], "enc_embeds": enc[:, :256]})
        logits, prefill_s = timed_prefill(
            step, params, {"tokens": toks, "enc_embeds": enc},
            "encdec prefill", b2)
        log(f"[encdec] prefill: encoder {batch} x {frames} frames, decoder "
            f"{batch} x {prompt} tokens: {1e3 * prefill_s:.1f} ms, "
            f"{batch * (frames + prompt) / prefill_s:.0f} positions/s "
            f"[{card()}]")
        with plain_attention():
            want = step(params, {"tokens": toks, "enc_embeds": enc})
        err, agree = compare(logits, want)
        log(f"[encdec] bf16 logits B2 vs plain attention: {err:.3e}, argmax "
            f"agreement {agree:.2f} (reported; gated in f32 below)")
        del logits, want
        reset_launches()
        all_logits, caches = tfm.forward(cfg, params, tokens=toks,
                                         enc_embeds=enc, collect_cache=True)
        check(flash_attention.launches == b2, "encdec forward: launches")
        tok = all_logits[:, -1].float().argmax(-1)
        del all_logits
        (k, v), cross = caches["cross"]
        cache = tfm.init_cache(cfg, batch, prompt + tokens + 2,
                               enc_out=cross, device=dev)
        for mine, got in zip(cache.layers["cross_self"], (k, v)):
            mine[:, :, :, :prompt].copy_(got)
        del k, v, caches
        torch.cuda.empty_cache()
        ms, tok_s, decode_busy = serve_phase(
            cfg, params, tok, cache._replace(pos=prompt), tokens, "encdec",
            b4)
        del cache, cross
        torch.cuda.empty_cache()

        prefill_gate(cfg, params, {"tokens": toks[:1, :gate_prompt],
                                   "enc_embeds": enc[:1, :gate_frames]},
                     "encdec", b2)
        f32 = dataclasses.replace(cfg, compute_dtype="float32")

        def gate_cache():
            g = torch.Generator(device=dev).manual_seed(32)
            shape = (cfg.n_layers, gate_batch, cfg.n_kv_heads, gate_frames,
                     cfg.head_dim)
            out = tuple(torch.randn(shape, generator=g, device=dev)
                        for _ in range(2))
            c = tfm.init_cache(f32, gate_batch, prompt, dtype=torch.float32,
                               enc_out=out, device=dev)
            for t in c.layers["cross_self"]:
                t[:, :, :, :prompt - 16].normal_(generator=g)
            return c._replace(pos=prompt - 16)
        step_gate(f32, gate_cache, tok[:gate_batch], params, "encdec", b4)
    del params, enc
    return {"b2_launches": b2, "b4_per_step": b4,
            "prefill_ms": 1e3 * prefill_s, "decode_ms": ms,
            "decode_tok_s": tok_s, "decode_busy": decode_busy}


def phase_vlm(dev, layers=16, batch=4, prompt=2048, serve_batch=8,
              tokens=16, seq=4096, gate_batch=2) -> dict:
    """llava-next-34b at full width, cut to ``layers`` of its 60 layers for
    one card's memory (f32 weights: 2.23 GB a layer, 3.67 GB embedding and
    head), prefilled from seeded patch embeddings (the stub frontend)."""
    cfg = dataclasses.replace(get_config("llava-next-34b"), n_layers=layers)
    params = model_params(cfg, dev, "vlm")
    gen = torch.Generator(device=dev).manual_seed(41)
    emb = torch.randn((batch, prompt, cfg.d_model), generator=gen,
                      device=dev) * cfg.d_model ** -0.5
    step = make_prefill_step(cfg)
    with torch.inference_mode():
        step(params, {"embeds": emb[:, :256]})           # warm-up
        logits, prefill_s = timed_prefill(step, params, {"embeds": emb},
                                          "vlm prefill", layers)
        log(f"[vlm] prefill {batch} x {prompt} embeddings: "
            f"{1e3 * prefill_s:.1f} ms, {batch * prompt / prefill_s:.0f} "
            f"tok/s [{card()}]")
        with plain_attention():
            want = step(params, {"embeds": emb})
        err, agree = compare(logits, want)
        log(f"[vlm] bf16 logits B2 vs plain attention: {err:.3e}, argmax "
            f"agreement {agree:.2f} (reported; gated in f32 below)")
        del logits, want
        torch.cuda.empty_cache()
        cache = fill_cache(tfm.init_cache(cfg, serve_batch, seq, device=dev),
                           seq - tokens - 2, seed=42)
        tok = torch.randint(0, cfg.vocab_size, (serve_batch,), generator=gen,
                            device=dev)
        ms, tok_s, decode_busy = serve_phase(cfg, params, tok, cache, tokens,
                                             "vlm", layers)
        del cache
        torch.cuda.empty_cache()
        prefill_gate(cfg, params, {"embeds": emb[:1]}, "vlm", layers)
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        step_gate(f32, lambda: fill_cache(tfm.init_cache(
            f32, gate_batch, seq, dtype=torch.float32, device=dev),
            seq - 16, seed=43), tok[:gate_batch], params, "vlm", layers)
    del params, emb
    return {"b2_launches": layers, "b4_per_step": layers,
            "prefill_ms": 1e3 * prefill_s, "decode_ms": ms,
            "decode_tok_s": tok_s, "decode_busy": decode_busy}


# ------------------------------------------------------------ the moe family

PEAK_SO_FAR = [0]


def reset_peak() -> None:
    """Start a phase's own window of peak device memory; the run's peak
    (``run_peak``) keeps the windows before it."""
    PEAK_SO_FAR[0] = run_peak()
    torch.cuda.reset_peak_memory_stats()


def run_peak() -> int:
    return max(PEAK_SO_FAR[0], torch.cuda.max_memory_allocated())


def kept_share(fn, tag: str) -> float:
    """Runs ``fn`` with each ``moe_ffn`` call of the model preceded by
    ``moe.route`` on its tokens (the call's own dispatch, computed once
    more; untimed): logs and returns the share of routed slots that fit
    their expert's capacity."""
    counts = []
    ffn = tfm.moe_ffn

    def recording(x, p, cfg_moe, *args):
        r = moe.route(x.reshape(-1, x.shape[-1]), p, cfg_moe)
        counts.append((r.keep.sum(), r.keep.numel(), r.capacity))
        return ffn(x, p, cfg_moe, *args)

    tfm.moe_ffn = recording
    try:
        fn()
    finally:
        tfm.moe_ffn = ffn
    kept = sum(int(k) for k, _, _ in counts)
    routed = sum(n for _, n, _ in counts)
    log(f"[{tag}] MoE kept {kept} of {routed} routed slots "
        f"({kept / routed:.4f}) over {len(counts)} moe_ffn calls, capacity "
        f"{sorted({c for *_, c in counts})} per expert [{card()}]")
    return kept / routed


def phase_moe_grok(dev, layers=8, batch=4, prompt=2048, serve_batch=8,
                   tokens=16, seq=4096, gate_len=1024, gate_batch=2) -> dict:
    """grok-1-314b at full width (d_model 6 144, 48 q heads over 8 KV heads
    of 128: GQA group 6; 8 experts of d_ff 32 768, top-2, softmax router,
    GELU; vocab 131 072), cut to ``layers`` of its 64 layers for one card's
    memory: bf16 weights (the config's ``param_dtype``), 6.62 GB a layer
    and 3.22 GB of embedding and head, and an f32 gate casts one layer
    (13.2 GB) at a time. Prefill of ``batch`` x ``prompt`` seeded tokens
    (B2 once a layer), ``tokens`` greedy tokens at ``serve_batch`` over a
    ``seq``-position cache (B4 once a layer a step); f32 gates of B2 and
    B4 against the plain versions (a ``gate_len`` prompt: the plain
    attention's chunk divides it)."""
    cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=layers)
    reset_peak()
    params = model_params(cfg, dev, "moe-grok")
    gen = torch.Generator(device=dev).manual_seed(51)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    run = lambda: step(params, {"tokens": toks})            # noqa: E731
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :256]})             # warm-up
        logits, prefill_s = timed_prefill(step, params, {"tokens": toks},
                                          "moe-grok prefill", layers)
        log(f"[moe-grok] prefill {batch} x {prompt} tokens: "
            f"{1e3 * prefill_s:.1f} ms, {batch * prompt / prefill_s:.0f} "
            f"tok/s, capacity {moe.capacity(batch * prompt, cfg.moe)} per "
            f"expert [{card()}]")
        prefill_busy = profile(f"{cfg.name}-d{layers} prefill", run)
        prefill_kept = kept_share(run, "moe-grok prefill")
        with plain_attention():
            want = run()
        err, agree = compare(logits, want)
        log(f"[moe-grok] bf16 logits B2 vs plain attention: {err:.3e}, "
            f"argmax agreement {agree:.2f} (reported; gated in f32 below)")
        del logits, want
        torch.cuda.empty_cache()
        cache = fill_cache(tfm.init_cache(cfg, serve_batch, seq, device=dev),
                           seq - tokens - 2, seed=52)
        tok = torch.randint(0, cfg.vocab_size, (serve_batch,), generator=gen,
                            device=dev)
        ms, tok_s, decode_busy = serve_phase(cfg, params, tok, cache, tokens,
                                             "moe-grok", layers)
        fill_cache(cache, seq - tokens - 2, seed=52)
        decode_kept = kept_share(lambda: serve_tokens(
            cfg, params, tok, cache, tokens), "moe-grok decode")
        del cache
        torch.cuda.empty_cache()
        prefill_gate(cfg, params, {"tokens": toks[:1, :gate_len]},
                     "moe-grok", layers)
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        step_gate(f32, lambda: fill_cache(tfm.init_cache(
            f32, gate_batch, seq, dtype=torch.float32, device=dev),
            seq - 16, seed=53), tok[:gate_batch], params, "moe-grok", layers)
    peak = torch.cuda.max_memory_allocated()
    log(f"[moe-grok] peak device memory {peak / 2 ** 30:.2f} GiB "
        f"({peak / 1e9:.2f} GB) [{card()}]")
    del params
    return {"b2_launches": layers, "b4_per_step": layers,
            "prefill_ms": 1e3 * prefill_s,
            "prefill_tok_s": batch * prompt / prefill_s,
            "prefill_busy": prefill_busy, "decode_ms": ms,
            "decode_tok_s": tok_s, "decode_busy": decode_busy,
            "prefill_kept": prefill_kept, "decode_kept": decode_kept,
            "peak_gb": peak / 1e9}


def first_layers(tree, n: int):
    """The first ``n`` layers of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def mla_gate(cfg, params, dev, batch: int, length: int, seed=63) -> float:
    """MLA's latent cache and absorbed decode against its prefill, on the
    config's leading dense layers in f32: the last logits of a prefill over
    ``length`` + 1 seeded tokens against those of one ``decode_step`` over
    the (ckv, k_rope) that a forward over the first ``length`` collected.
    ``length`` + 1 fits one chunk of the plain attention."""
    f32 = dataclasses.replace(cfg, n_layers=cfg.moe.first_dense_layers,
                              compute_dtype="float32")
    prefix = dict(params, moe=first_layers(params["moe"], 0))
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, length + 1),
                         generator=gen, device=dev)
    want = make_prefill_step(f32)(prefix, {"tokens": toks})
    _, caches = tfm.forward(f32, prefix, tokens=toks[:, :length],
                            collect_cache=True)
    cache = tfm.init_cache(f32, batch, length + 1, dtype=torch.float32,
                           device=dev)
    for mine, got in zip(cache.layers["dense"], caches["dense"]):
        mine[:, :, :length].copy_(got)
    del caches
    logits, _ = tfm.decode_step(f32, prefix, toks[:, length],
                                cache._replace(pos=length))
    err, agree = compare(logits, want)
    log(f"[moe-deepseek] MLA f32, {f32.n_layers} dense layers, batch "
        f"{batch}: prefill over {length + 1} tokens vs prefill over {length} "
        f"and one absorbed decode step over the latent cache: {err:.3e} (tol "
        f"{DENSE_TOL:.0e}), argmax agreement {agree:.2f} [{card()}]")
    check(err <= DENSE_TOL, f"MLA prefill vs latent-cache decode: {err}")
    return err


def moe_gate(cfg, dev, batch: int, length: int, seed=64) -> tuple:
    """One MoE layer of ``cfg`` at full width with seeded f32 weights (the
    port's init rule; a seeded router bias): ``moe_ffn`` against
    ``moe_ref`` on ``batch`` x ``length`` seeded tokens in f32 at the
    config's capacity factor, outputs within DENSE_TOL of max|plain| and
    kept masks equal, with slots dropped. Returns (error, kept share)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {n: (torch.randn(shape, generator=gen, device=dev) * 0.1
             if len(shape) == 1 else
             dense_init(gen, shape, 0, torch.float32, dev))
         for n, shape in moe.moe_params_shapes(cfg.moe, cfg.d_model,
                                               cfg.ffn).items()}
    n_bytes = sum(t.numel() * t.element_size() for t in p.values())
    x = torch.randn((batch, length, cfg.d_model), generator=gen, device=dev)
    got = moe.moe_ffn(x, p, cfg.moe, cfg.ffn, torch.float32)
    want, keep = moe.moe_ref(x, p, cfg.moe, cfg.ffn, torch.float32)
    same = torch.equal(keep, moe.route(x.reshape(-1, cfg.d_model), p,
                                       cfg.moe).keep)
    err = float((got - want).abs().max() / want.abs().max())
    share = float(keep.float().mean())
    log(f"[moe-deepseek] moe_ffn vs moe_ref, one MoE layer in f32 "
        f"({n_bytes / 1e9:.2f} GB), {batch} x {length} tokens, capacity "
        f"{moe.capacity(batch * length, cfg.moe)}: {err:.3e} (tol "
        f"{DENSE_TOL:.0e}); kept masks equal: {same}; kept {share:.4f} of "
        f"routed slots [{card()}]")
    check(err <= DENSE_TOL and same and share < 1.0,
          f"moe_ffn vs moe_ref: err {err}, masks equal {same}, kept {share}")
    return err, share


def time_mla_attention(cfg, dev, batch: int, length: int) -> dict:
    """MLA's prefill attention at ``cfg``'s heads (q and k of nope + rope,
    v of v_head_dim; bf16, causal) as the model runs it, through
    ``chunked_attention`` (f32 on the CUDA cores, no kernel of the port
    takes it), beside ``scaled_dot_product_attention`` on the same inputs
    and the bound of the work at the bf16 rate: the cost a B2 variant for
    MLA would take on (ROADMAP queue B)."""
    m = cfg.mla
    gen = torch.Generator(device=dev).manual_seed(65)
    dk, dv = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    q, k = (torch.randn((batch, cfg.n_heads, length, dk), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    v = torch.randn((batch, cfg.n_heads, length, dv), generator=gen,
                    device=dev).to(torch.bfloat16)
    got = chunked_attention(q, k, v, causal=True)
    want = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    err = rel_err(got, want)
    plain = cuda_ms(lambda: chunked_attention(q, k, v, causal=True), 3)
    library = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 5)
    pairs = batch * cfg.n_heads * length * (length + 1) / 2
    nbytes = q.element_size() * (2 * q.numel() + 2 * v.numel())
    bnd, bound_by = bound(nbytes, 2.0 * (dk + dv) * pairs, torch.bfloat16)
    log(f"[time] MLA prefill attention q/k[{batch},{cfg.n_heads},{length},"
        f"{dk}] v[..,{dv}] bf16 causal: chunked_attention {plain:.3f} ms a "
        f"layer, sdpa {library:.3f} ms, bound {bnd:.3f} ms ({bound_by}); "
        f"chunked vs sdpa {err:.3e} [{card()}]")
    check(err <= TOL[torch.bfloat16], f"MLA chunked_attention vs sdpa {err}")
    return {"plain_ms": plain, "library_ms": library, "bound_ms": bnd}


def phase_moe_deepseek(dev, moe_layers=2, batch=4, prompt=2048,
                       serve_batch=8, tokens=16, seq=4096, mla_batch=2,
                       mla_len=1023, moe_batch=2, moe_len=512) -> dict:
    """deepseek-v3-671b at full width (d_model 7 168; MLA over 128 heads:
    q_lora 1 536, kv_lora 512, nope 128, rope 64, v 128; 256 routed experts
    of d_ff 2 048 top-8 and one shared, sigmoid router; vocab 129 280),
    keeping its 3 leading dense layers and ``moe_layers`` of its 58 MoE
    layers for one card's memory: bf16 weights, 1.17 GB a dense layer,
    23.0 GB a MoE layer, 3.71 GB embedding and head. As in the reference,
    MLA runs without B2 or B4: prefill through ``chunked_attention``,
    decode absorbed over the latent cache. Prefill ``batch`` x ``prompt``,
    ``tokens`` greedy tokens at ``serve_batch`` over a ``seq``-position
    latent cache; then the MLA gate on the dense prefix and, with the model
    freed, the MoE gate on one f32 layer."""
    base = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(
        base, n_layers=base.moe.first_dense_layers + moe_layers)
    reset_peak()
    params = model_params(cfg, dev, "moe-deepseek")
    gen = torch.Generator(device=dev).manual_seed(61)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    run = lambda: step(params, {"tokens": toks})            # noqa: E731
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :256]})             # warm-up
        logits, prefill_s = timed_prefill(step, params, {"tokens": toks},
                                          "moe-deepseek prefill", 0)
        del logits
        log(f"[moe-deepseek] prefill {batch} x {prompt} tokens: "
            f"{1e3 * prefill_s:.1f} ms, {batch * prompt / prefill_s:.0f} "
            f"tok/s, capacity {moe.capacity(batch * prompt, cfg.moe)} per "
            f"expert [{card()}]")
        prefill_busy = profile(f"{cfg.name}-d{cfg.n_layers} prefill", run)
        prefill_kept = kept_share(run, "moe-deepseek prefill")
        torch.cuda.empty_cache()
        mla = time_mla_attention(cfg, dev, batch, prompt)
        torch.cuda.empty_cache()
        cache = fill_cache(tfm.init_cache(cfg, serve_batch, seq, device=dev),
                           seq - tokens - 2, seed=62)
        tok = torch.randint(0, cfg.vocab_size, (serve_batch,), generator=gen,
                            device=dev)
        ms, tok_s, decode_busy = serve_phase(cfg, params, tok, cache, tokens,
                                             "moe-deepseek", 0)
        fill_cache(cache, seq - tokens - 2, seed=62)
        decode_kept = kept_share(lambda: serve_tokens(
            cfg, params, tok, cache, tokens), "moe-deepseek decode")
        del cache
        torch.cuda.empty_cache()
        mla_err = mla_gate(cfg, params, dev, mla_batch, mla_len)
        peak = torch.cuda.max_memory_allocated()
        del params
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak()
        moe_err, gate_kept = moe_gate(cfg, dev, moe_batch, moe_len)
    log(f"[moe-deepseek] peak device memory with the model "
        f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB); of the MoE gate "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card()}]")
    torch.cuda.empty_cache()
    return {"b2_launches": 0, "b4_per_step": 0,
            "prefill_ms": 1e3 * prefill_s,
            "prefill_tok_s": batch * prompt / prefill_s,
            "prefill_busy": prefill_busy, "decode_ms": ms,
            "decode_tok_s": tok_s, "decode_busy": decode_busy,
            "prefill_kept": prefill_kept, "decode_kept": decode_kept,
            "mla_err": mla_err, "moe_err": moe_err, "gate_kept": gate_kept,
            "peak_gb": peak / 1e9, "mla_attention": mla}


# ------------------------------------------------------------------ training

TRAIN_ARCHS = ("starcoder2-3b", "yi-6b", "llava-next-34b", "grok-1-314b",
               "deepseek-v3-671b", "mamba2-1.3b", "zamba2-1.2b",
               "seamless-m4t-large-v2")
# Card against CPU, reduced configs in f32 (compute and parameters): the
# loss to 1e-5 relative, each gradient leaf to 1e-4 of its max|g| — the
# tolerances of tests/test_torch_train.py against the JAX package (the
# same f32 function with sums in other orders over two layers of
# backward; a wrong term moves a leaf by its own size).
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# Remat none against full on the card (starcoder2-3b, 2 layers, bf16
# compute): the recomputation repeats the same kernels on the same inputs,
# so the gradients should agree bit for bit; gated at 1e-6 of each leaf's
# max|g| (bf16 rounding of one product is 4e-3), the exact equality
# reported.
REMAT_TOL = 1e-6


def worst_leaf(got, want) -> tuple:
    """(max over leaves of max|got - want| / max|want|, that leaf)."""
    worst = (0.0, "")
    for (name, g), (_, w) in zip(leaf_paths(got), leaf_paths(want)):
        err = float((g.float().cpu() - w.float().cpu()).abs().max()
                    / max(float(w.abs().max()), 1e-30))
        worst = max(worst, (err, name))
    return worst


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                tree_leaves(b)))


def launches_now() -> dict:
    return {k.__name__: k.launches for k in (block_gemm, flash_attention,
                                             ssd_scan, decode_attention)}


def train_batch(cfg, step: int, seq: int, batch: int, device, seed=3,
                learnable=False, mask=True):
    """``SyntheticLM``'s batch ``step`` for ``cfg``'s family on ``device``
    (every fifth label of the first row masked, unless not ``mask``)."""
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                     embed_dim=cfg.d_model if cfg.embed_inputs else None,
                     encdec=cfg.family == "encdec", learnable=learnable)
    b = ds.batch_at(step)
    if mask:
        b["labels"] = b["labels"].copy()      # a view of the tokens' array
        b["labels"][0, ::5] = -1
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the block, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def train_grad_gate(dev) -> dict:
    """``lm_loss`` and every gradient leaf of each family's reduced config
    (f32; zamba2's window 16), on the card against the CPU from the same
    weights and batch (2 x 64 tokens, the multi-chunk attention under
    ``REPRO_ATTN_CHUNK=16``), with no kernel launched on the card."""
    rows = {}
    with env(REPRO_ATTN_CHUNK="16"):
        for arch in TRAIN_ARCHS:
            kw = {"sliding_window": 16} if arch == "zamba2-1.2b" else {}
            cfg = reduced(get_config(arch), compute_dtype="float32",
                          param_dtype="float32", **kw)
            params = tfm.init_params(cfg, seed=0, device="cpu")
            batch = train_batch(cfg, 0, 64, 2, "cpu")
            want_loss, want = loss_and_grads(cfg, params, batch)
            reset_launches()
            loss, got = loss_and_grads(
                cfg, tree_map(lambda t: t.to(dev), params),
                {k: v.to(dev) for k, v in batch.items()})
            launched = sum(launches_now().values())
            loss_err = abs(float(loss) - float(want_loss)) / abs(
                float(want_loss))
            grad_err, leaf = worst_leaf(got, want)
            log(f"[train] {arch} reduced, f32, card vs CPU: loss "
                f"{float(loss):.6f} (rel {loss_err:.2e}, tol "
                f"{TRAIN_LOSS_TOL:.0e}), worst gradient leaf {leaf} "
                f"{grad_err:.2e} (tol {TRAIN_GRAD_TOL:.0e}), kernel "
                f"launches {launched}")
            check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
                  and launched == 0,
                  f"train gate {arch}: loss {loss_err}, grads {grad_err} "
                  f"at {leaf}, launches {launched}")
            rows[arch] = {"loss_err": loss_err, "grad_err": grad_err}
    return rows


def remat_gate(cfg, dev, batch) -> dict:
    """``cfg`` (cut in depth), bf16 compute: loss and gradients with remat
    none and full, and each one's peak memory."""
    params = tfm.init_params(cfg, seed=0, device=dev)
    out = {}
    for policy in ("none", "full"):
        with env(REPRO_REMAT=policy):
            reset_peak()
            loss, grads = loss_and_grads(cfg, params, batch)
            torch.cuda.synchronize()
            out[policy] = (loss, grads, torch.cuda.max_memory_allocated())
    (l0, g0, peak0), (l1, g1, peak1) = out["none"], out["full"]
    err, leaf = worst_leaf(g1, g0)
    bits = same_bits(g0, g1) and torch.equal(l0, l1)
    log(f"[train] {cfg.name}-d{cfg.n_layers} remat none vs full: loss "
        f"{float(l0):.6f} vs {float(l1):.6f}, worst gradient leaf {leaf} "
        f"{err:.2e} (tol {REMAT_TOL:.0e}), bit for bit: {bits}; peak "
        f"{peak0 / 1e9:.2f} GB (none) vs {peak1 / 1e9:.2f} GB (full) "
        f"[{card()}]")
    check(torch.isfinite(l0) and float((l0 - l1).abs()) <= REMAT_TOL
          * float(l0.abs()) and err <= REMAT_TOL,
          f"remat none vs full: loss {float(l0)} {float(l1)}, grads {err}")
    del out, g0, g1
    return {"bitwise": bits, "err": err, "peak_none_gb": peak0 / 1e9,
            "peak_full_gb": peak1 / 1e9, "params": params}


def resume_gate(cfg, params, dev, batch_at) -> dict:
    """Two steps, an ``AsyncCheckpointer`` save, two more steps (in place,
    while it writes); then restore and replay the two: parameters and
    optimizer state bit for bit. In a temporary directory, removed."""
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=3e-4)
    for s in range(2):
        step(params, opt, batch_at(s))
    with tempfile.TemporaryDirectory() as d:
        saver = ckpt.AsyncCheckpointer(d)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        saver.save(2, {"params": params, "opt": opt})
        snap_s = time.perf_counter() - t1
        for s in (2, 3):
            step(params, opt, batch_at(s))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        saver.wait()
        wait_s = time.perf_counter() - t1
        root = os.path.join(d, "step_00000002")
        nbytes = sum(os.path.getsize(os.path.join(dirpath, f))
                     for dirpath, _, files in os.walk(root) for f in files)
        like = tfm.abstract_params(cfg)
        t1 = time.perf_counter()
        state = ckpt.restore(d, 2, {"params": like, "opt": adamw_init(like)},
                             device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
    p2, o2 = state["params"], state["opt"]
    for s in (2, 3):
        step(p2, o2, batch_at(s))
    bits = same_bits(params, p2) and same_bits(opt, o2)
    log(f"[train] {cfg.name}-d{cfg.n_layers} AsyncCheckpointer: "
        f"{nbytes / 1e9:.3f} GB written; save returned after "
        f"{snap_s:.3f} s (host snapshot), the write finished "
        f"{wait_s:.3f} s after two more steps, restore {restore_s:.3f} s; "
        f"resume bit for bit: {bits}")
    check(bits, "checkpoint resume is not bit for bit")
    return {"bytes": nbytes, "save_s": snap_s, "wait_s": wait_s,
            "restore_s": restore_s}


def split_profile(label: str, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device's busy and
    idle share, and its device time split by the op that launched the
    kernels: ``aten::mm`` (the projections and the head, forward and
    backward), ``aten::bmm`` (the f32 attention's einsums), the optimizer
    (the ``train_step.update`` range) and ``aten::_to_copy`` (dtype casts).
    The step's own ranges are not kernels and are left out of the busy
    time."""
    from torch.profiler import ProfilerActivity, profile as trace
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    events = prof.key_averages()
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda_type
               and e.self_device_time_total > 0
               and not e.key.startswith("train_step.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log(f"[profile] {label}: the profiler recorded no device time; "
            "busy share and split not measured")
        return {"wall_ms": wall_ms}

    def op_ms(key, own=True):
        got = [e for e in events if e.key == key
               and e.device_type != cuda_type]
        return sum((e.self_device_time_total if own else
                    e.device_time_total) for e in got) / 1e3

    split = {"projections (aten::mm)": op_ms("aten::mm"),
             "attention einsums (aten::bmm, f32)": op_ms("aten::bmm"),
             "optimizer update": op_ms("train_step.update", own=False),
             "casts (aten::_to_copy)": op_ms("aten::_to_copy", own=False)}
    split["other"] = busy_ms - sum(split.values())
    log(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for name, ms in split.items():
        log(f"[profile]   {ms:9.2f} ms {ms / busy_ms:6.3f}  {name}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.self_device_time_total / 1e3 / busy_ms:6.3f}  x{e.count:<5} "
            f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle": 1 - busy_ms / wall_ms, "split_ms": split}


def train_launcher(dev_type: str) -> dict:
    """``python -m repro_torch.launch.train`` on the reduced starcoder2-3b
    (8 steps, checkpoints every 3) with 2 fake hosts and host 1 killed at
    step 5, in a temporary directory: the failure, restore and ``done``
    lines. (That its final parameters equal a run without the kill, bit
    for bit, tests/test_torch_train.py holds on the CPU.)"""
    environ = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "starcoder2-3b", "--reduced", "--steps", "8", "--device",
             dev_type, "--elastic", "--fake-hosts", "2", "--kill-host",
             "1@5", "--lease", "2", "--ckpt-every", "3", "--global-batch",
             "4", "--seq", "16", "--ckpt-dir", d],
            capture_output=True, text=True, timeout=600, env=environ,
            cwd=ROOT)
        seconds = time.perf_counter() - t1
    check(proc.returncode == 0, f"train launcher exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    out = proc.stdout
    check("host failure: survivors [0]" in out
          and "elastic restore from step 6" in out
          and out.rstrip().endswith("done"),
          f"train launcher: elastic lines missing:\n{out}")
    lines = [ln for ln in out.splitlines() if ln.startswith(
        ("host failure", "elastic restore", "done"))]
    log(f"[train] launcher --elastic --kill-host 1@5 on {dev_type}: "
        f"{' | '.join(lines)}; {seconds:.1f} s")
    return {"seconds": seconds}


def attention_train_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of the plain attention's einsums in one train step under remat
    full: q·kᵀ and p·v over every (query, key) pair of every chunk (the
    plain version masks but does not skip), 4·D a pair, in the forward,
    the block's recompute and the chunk's recompute, and twice that in
    the backward: 5 forwards' worth."""
    return 5 * 4.0 * cfg.head_dim * seq * seq * batch * cfg.n_heads \
        * cfg.n_layers


def time_train_attention(cfg, dev, batch: int, seq: int) -> dict:
    """The plain attention as a train step runs it at ``cfg``'s layer (q
    [B, Hq, S, D], k, v [B, Hkv, S, D], bf16, causal): forward and
    backward through ``chunked_attention`` under grad (its chunks
    checkpointed, so the backward recomputes each chunk) and one more
    forward (the block's recompute under remat full), by CUDA events;
    beside ``scaled_dot_product_attention`` doing the same (k and v
    repeated to the q heads) and the least time of the plain version's
    f32 work at the f32 rate."""
    gen = torch.Generator(device=dev).manual_seed(71)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((batch, hq, seq, d), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    k, v = (torch.randn((batch, hkv, seq, d), generator=gen, device=dev)
            .to(torch.bfloat16).requires_grad_() for _ in range(2))
    go = torch.randn((batch, hq, seq, d), generator=gen, device=dev).to(
        torch.bfloat16)
    group = hq // hkv

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(group, dim=1),
            v.repeat_interleave(group, dim=1), is_causal=True)

    def train_pass(attn):
        def run():
            q.grad = k.grad = v.grad = None
            attn(q, k, v).backward(go)
            with torch.no_grad():
                attn(q, k, v)
        return run

    def plain(q, k, v):
        return chunked_attention(q, k, v, causal=True)

    with torch.no_grad():
        err = rel_err(plain(q, k, v), sdpa(q, k, v))
    plain_ms = cuda_ms(train_pass(plain), 2)
    library_ms = cuda_ms(train_pass(sdpa), 5)
    flops = attention_train_flops(dataclasses.replace(cfg, n_layers=1),
                                  batch, seq)
    bnd, _ = bound(0.0, flops, torch.float32)
    log(f"[time] train attention q[{batch},{hq},{seq},{d}] kv[..,{hkv},..] "
        f"bf16 causal, forward + backward + the block's recompute: "
        f"chunked_attention {plain_ms:.2f} ms a layer ({cfg.n_layers} "
        f"layers: {cfg.n_layers * plain_ms:.1f} ms a step), sdpa "
        f"{library_ms:.2f} ms; f32 einsums {flops / 1e12:.2f} TFLOP a "
        f"layer, bound {bnd:.2f} ms at the f32 rate; plain vs sdpa forward "
        f"{err:.3e} [{card()}]")
    check(err <= TOL[torch.bfloat16], f"train attention plain vs sdpa {err}")
    return {"plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bnd, "step_ms": cfg.n_layers * plain_ms}


def phase_train(dev, batch=4, seq=2048, warmup=2, steps=4, lr=3e-4,
                cut_layers=2) -> dict:
    """Training on the card: the reduced card-vs-CPU gradient gates of every
    family; starcoder2-3b at full width cut to ``cut_layers`` layers (remat
    none vs full, an ``AsyncCheckpointer`` resume); then starcoder2-3b-
    train at full width and depth (30 layers, d_model 3 072, 24 q heads
    over 2 KV heads of 128, GELU d_ff 12 288, vocab 49 152; f32 params,
    AdamW, bf16 compute, remat full): ``batch`` x ``seq`` tokens a step of
    ``SyntheticLM(learnable=True)`` at ``lr``, ``warmup`` steps then
    ``steps`` timed, no kernel launched, loss and |g| finite, the loss
    falling; one profiled step; a ``no_grad`` prefill of the same model
    (B2 once a layer); and the launcher's elastic run."""
    grads = train_grad_gate(dev)
    torch.cuda.empty_cache()
    cfg = get_config("starcoder2-3b")
    cut = dataclasses.replace(cfg, n_layers=cut_layers)

    def batch_at(s):
        return train_batch(cfg, s, seq, batch, dev, seed=0, learnable=True,
                           mask=False)

    remat = remat_gate(cut, dev, batch_at(0))
    resume = resume_gate(cut, remat.pop("params"), dev, batch_at)
    gc.collect()
    torch.cuda.empty_cache()

    reset_peak()
    t0 = time.perf_counter()
    params, opt = init_train_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    n_mm = sum(t.numel() for name, t in leaf_paths(params)
               if t.dim() >= 2 and name != "embed")
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} q heads over {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_par / 1e9:.3f} B params ({n_mm / 1e9:.3f} B in products), f32 "
        f"params + AdamW m, v: {4 * 3 * n_par / 1e9:.2f} GB; init "
        f"{time.perf_counter() - t0:.2f} s")
    step_fn = make_train_step(cfg, lr=lr)
    batches = [batch_at(s) for s in range(warmup + steps + 1)]
    reset_launches()
    metrics = []
    for s in range(warmup):
        params, opt, m = step_fn(params, opt, batches[s])
        metrics.append(m)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for s in range(warmup, warmup + steps):
        params, opt, m = step_fn(params, opt, batches[s])
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / steps
    train_launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    tokens = batch * seq
    model_flops = 8.0 * n_mm * tokens        # 6·N·T, + 2·N·T recomputed
    attn_flops = attention_train_flops(cfg, batch, seq)
    log(f"[train] losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"[train] |g| {' '.join(f'{x:.3f}' for x in norms)}")
    log(f"[train] {cfg.name}-train, {batch} x {seq} tokens a step: "
        f"{1e3 * step_s:.1f} ms a step over {steps} steps, "
        f"{tokens / step_s:.0f} tok/s; model {model_flops / 1e12:.1f} TFLOP "
        f"a step (8·N·T, N = {n_mm / 1e9:.3f} B in products, remat full) = "
        f"{model_flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{model_flops / step_s / PEAK_BF16_FLOPS:.3f} of the bf16 dense "
        f"peak; plus {attn_flops / 1e12:.1f} TFLOP of f32 attention "
        f"einsums; peak device memory {peak / 1e9:.2f} GB; kernel launches "
        f"in the train steps {train_launches} [{card()}]")
    check(all(math.isfinite(x) for x in losses + norms),
          f"train: loss or |g| not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    check(not any(train_launches.values()),
          f"train: kernels launched in a train step: {train_launches}")
    prof = split_profile(f"{cfg.name}-train step",
                         lambda: step_fn(params, opt, batches[-1]))
    del opt, metrics
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        logits, prefill_s = timed_prefill(
            make_prefill_step(cfg), params, {"tokens": batches[0]["tokens"]},
            f"{cfg.name} no_grad prefill", cfg.n_layers)
    log(f"[train] no_grad prefill of the trained model, {batch} x {seq}: "
        f"{flash_attention.launches} B2 launches, {1e3 * prefill_s:.1f} ms")
    del params, batches, logits
    gc.collect()
    torch.cuda.empty_cache()
    attention = time_train_attention(cfg, dev, batch, seq)
    torch.cuda.empty_cache()
    launcher = train_launcher(dev.type)
    return {"launches": train_launches, "ms": 1e3 * step_s,
            "tok_s": tokens / step_s, "tflops": model_flops / step_s / 1e12,
            "peak_share": model_flops / step_s / PEAK_BF16_FLOPS,
            "peak_gb": peak / 1e9, "losses": losses, "profile": prof,
            "grads": grads, "remat": remat, "resume": resume,
            "attention": attention, "launcher": launcher}


# ------------------------------------------------------------------ pipeline

# The pipelined train step's first loss against the sequential step's on
# the same parameters and batch: the reference's own bound
# (tests/multi_device_cases.py case_pipeline_train_step). In bf16 compute
# the microbatches' products have another M than the full batch's, so the
# two differ in the last bits of each product, not bit for bit.
PIPE_LOSS_TOL = 1e-3
# MoE under a (data 2, model 2) mesh, card against CPU in f32: the kept
# masks exactly, the outputs to 1e-4 of max|y| (DENSE_TOL's f32 sums in
# other orders).
MOE_MESH_TOL = 1e-4


def pipeline_forward_gate(cfg, params, tokens, dev, stages: int,
                          n_micro: int) -> dict:
    """(a) The dense stack through ``pipeline_apply`` under no_grad on a
    logical ("pipe",) mesh, bf16 compute: wavefronts, stage calls and B2
    launches of the run; bit for bit the sequential ``_scan_segment``
    microbatch by microbatch; a second pipelined run bit for bit the
    first, with each of its B2 calls held to ``mha_ref`` on that call's
    operands (TOL, whole tensor and per head), and its output's difference
    from the stack on the plain attention (``chunked_attention``)
    reported; ms of the pipelined forward, of that sequential one and of
    one full-batch ``_scan_segment`` (CUDA events)."""
    mesh = Mesh((stages,), ("pipe",), dev)
    layers = tfm.unstack(params["dense"])
    per = cfg.n_layers // stages
    parts = [layers[s * per:(s + 1) * per] for s in range(stages)]

    def stage(stage_layers, x):
        return tfm._scan_segment(cfg, "dense", stage_layers, x)[0]

    with torch.no_grad():
        x = params["embed"][tokens].to(tfm.dtype_of(cfg.compute_dtype))
        xs = split_microbatches(x, n_micro)
        reset_launches()
        pipeline_apply.wavefronts = pipeline_apply.stage_calls = 0
        ys = pipeline_apply(stage, parts, xs, mesh=mesh)
        torch.cuda.synchronize()
        counts = {"wavefronts": pipeline_apply.wavefronts,
                  "stage_calls": pipeline_apply.stage_calls,
                  "b2": flash_attention.launches,
                  "copies": flash_attention.copies}
        want = torch.stack([stage(layers, xs[m]) for m in range(n_micro)])
        bits = torch.equal(ys, want)
        finite = bool(torch.isfinite(ys.float()).all())
        del want
        # each B2 call of the path against its plain version, on the
        # operands the stack gave it (views in the model's layout)
        kernel_attention, errs = tfm.prefill_attention, []

        def held(q, k, v, *, causal=True, window=0):
            o = kernel_attention(q, k, v, causal=causal, window=window)
            ref = mha_ref(q, k, v, causal=causal, window=window)
            errs.append((rel_err(o, ref), head_err(o, ref)))
            return o

        tfm.prefill_attention = held
        try:
            again = torch.equal(pipeline_apply(stage, parts, xs, mesh=mesh),
                                ys)
        finally:
            tfm.prefill_attention = kernel_attention
        with plain_attention():
            stack_err = rel_err(ys, pipeline_apply(stage, parts, xs,
                                                   mesh=mesh))
        b2_err = max((e for e, _ in errs), default=math.inf)
        b2_head = max((h for _, h in errs), default=math.inf)
        pipe_ms = cuda_ms(lambda: pipeline_apply(stage, parts, xs,
                                                 mesh=mesh), 3)
        seq_ms = cuda_ms(lambda: [stage(layers, xs[m])
                                  for m in range(n_micro)], 3)
        full_ms = cuda_ms(lambda: stage(layers, x), 3)
    depth = schedule_depth(stages, n_micro)
    log(f"[pipeline] {cfg.name} forward, {stages} stages x {n_micro} "
        f"microbatches of {tuple(xs.shape[1:3])} tokens, bf16, no_grad: "
        f"{counts['wavefronts']} wavefronts (schedule depth {depth}), "
        f"{counts['stage_calls']} stage calls, {counts['b2']} B2 launches, "
        f"{counts['copies']} operands copied; bit for bit the sequential "
        f"stack microbatch by microbatch: {bits}; a second run bit for bit "
        f"the first: {again}, its {len(errs)} B2 calls against mha_ref on "
        f"their operands: max err {b2_err:.3e}, per head {b2_head:.3e} "
        f"(tol {TOL[torch.bfloat16]:.0e}); "
        f"output vs the stack on the plain attention {stack_err:.3e} "
        f"(reported); pipelined {pipe_ms:.1f} "
        f"ms, sequential by microbatch {seq_ms:.1f} ms, one full-batch "
        f"forward {full_ms:.1f} ms [{card()}]")
    check(counts["wavefronts"] == depth == stages + n_micro - 1
          and counts["stage_calls"] == stages * n_micro
          and counts["b2"] == cfg.n_layers * n_micro
          and counts["copies"] == 0,
          f"pipelined forward counts {counts}, depth {depth}")
    check(bits and finite, "pipelined forward is not bit for bit the "
          "sequential stack microbatch by microbatch")
    check(again and len(errs) == cfg.n_layers * n_micro
          and b2_err <= TOL[torch.bfloat16]
          and b2_head <= TOL[torch.bfloat16],
          f"pipelined forward: rerun equal {again}, {len(errs)} B2 calls "
          f"against mha_ref: err {b2_err}, per head {b2_head}")
    return {**counts, "ms": pipe_ms, "seq_ms": seq_ms, "full_ms": full_ms,
            "b2_err": b2_err, "stack_err": stack_err, "ys": ys.cpu()}


def pipeline_grad_gate(dev, stages: int, n_micro: int) -> dict:
    """(c) The pipelined step's loss and gradients of the reduced
    starcoder2-3b (4 layers, f32) on the card against the CPU, under
    ``REPRO_ATTN_CHUNK=16``, with no kernel launched on the card."""
    cfg = reduced(get_config("starcoder2-3b"), n_layers=4,
                  compute_dtype="float32", param_dtype="float32")
    params = tfm.init_params(cfg, seed=0, device="cpu")
    batch = train_batch(cfg, 0, 64, 2 * n_micro, "cpu")
    with env(REPRO_ATTN_CHUNK="16"):
        want_loss, want = value_and_grads(make_pipeline_loss(
            cfg, make_pipeline_mesh(stages, stages, "cpu"),
            n_micro=n_micro), params, batch)
        reset_launches()
        loss, got = value_and_grads(make_pipeline_loss(
            cfg, make_pipeline_mesh(stages, stages, dev), n_micro=n_micro),
            tree_map(lambda t: t.to(dev), params),
            {k: v.to(dev) for k, v in batch.items()})
    launched = sum(launches_now().values())
    loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    grad_err, leaf = worst_leaf(got, want)
    log(f"[pipeline] {cfg.name}-d4 reduced, {stages} stages x {n_micro} "
        f"microbatches, f32, card vs CPU: loss {float(loss):.6f} (rel "
        f"{loss_err:.2e}, tol {TRAIN_LOSS_TOL:.0e}), worst gradient leaf "
        f"{leaf} {grad_err:.2e} (tol {TRAIN_GRAD_TOL:.0e}), kernel launches "
        f"{launched}")
    check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
          and launched == 0, f"pipelined grads card vs CPU: loss {loss_err},"
          f" grads {grad_err} at {leaf}, launches {launched}")
    return {"loss_err": loss_err, "grad_err": grad_err}


def moe_mesh_gate(dev, batch=4, length=64, seed=65) -> dict:
    """(d) ``moe_ffn`` of the reduced grok-1-314b and deepseek-v3-671b in
    f32 under a logical (data 2, model 2) mesh with batch axes "data" (2
    dispatch rows), on the card against the CPU, at the config's capacity
    factor and at 0.5: each row's experts, positions and kept masks
    equal, outputs within MOE_MESH_TOL."""
    rows = {}
    for arch in ("grok-1-314b", "deepseek-v3-671b"):
        cfg = reduced(get_config(arch), compute_dtype="float32")
        params = tfm.init_params(cfg, seed=0, device="cpu")
        layer = {k: v[0].float() for k, v in params["moe"]["moe"].items()}
        layer["router_bias"] = torch.randn(
            layer["router_bias"].shape,
            generator=torch.Generator().manual_seed(seed)) * 0.1
        x = torch.randn((batch, length, cfg.d_model),
                        generator=torch.Generator().manual_seed(seed + 1))
        for cf in ("", "0.5"):
            out = []
            for where in ("cpu", dev):
                mesh = Mesh((2, 2), ("data", "model"), where)
                lw = {k: v.to(where) for k, v in layer.items()}
                with env(REPRO_MOE_CF=cf), launch_mesh(
                        mesh, global_batch=batch):
                    n_rows = moe.dispatch_rows(x)
                    _, routes = moe.dispatch(x.to(where), lw, cfg.moe)
                    y = moe.moe_ffn(x.to(where), lw, cfg.moe, cfg.ffn,
                                    torch.float32)
                out.append((n_rows, routes, y.cpu()))
            (r_cpu, want_routes, want), (r_dev, routes, got) = out
            same = all(torch.equal(a.expert.cpu(), b.expert)
                       and torch.equal(a.pos.cpu(), b.pos)
                       and torch.equal(a.keep.cpu(), b.keep)
                       for a, b in zip(routes, want_routes))
            err = float((got - want).abs().max() / want.abs().max())
            kept = float(torch.cat([r.keep.float().flatten()
                                    for r in routes]).mean())
            log(f"[pipeline] {arch} reduced moe_ffn under a logical (data "
                f"2, model 2) mesh, f32, cf {cf or 'config'}: {r_dev} "
                f"dispatch rows of {x.shape[0] * length // r_dev} tokens, "
                f"capacity {routes[0].capacity}; card vs CPU: experts, "
                f"positions and kept masks equal: {same}, outputs "
                f"{err:.3e} (tol {MOE_MESH_TOL:.0e}); kept {kept:.4f}")
            check(r_cpu == r_dev == 2 and len(routes) == 2 and same
                  and err <= MOE_MESH_TOL,
                  f"moe under a mesh {arch} cf {cf}: rows {r_dev}, masks "
                  f"equal {same}, err {err}")
            rows[f"{arch} cf {cf or 'config'}"] = {"err": err, "kept": kept}
    return rows


def phase_pipeline(dev, train: dict, stages=2, n_micro=4, batch=4, seq=2048,
                   warmup=1, steps=4, lr=3e-4) -> dict:
    """starcoder2-3b-pipe2: the dense stack of starcoder2-3b at full width
    and depth split into ``stages`` stages over ``n_micro`` microbatches
    (the GPipe rule, 2·stages) on a logical mesh of the one card. (a) the
    pipelined forward under no_grad (``pipeline_forward_gate``); (b)
    ``make_pipeline_train_step`` (f32 params, AdamW, remat full) on the
    ``batch`` x ``seq`` tokens of ``phase_train``'s step 0 onwards, from
    the same seeded parameters: each step's loss against ``phase_train``'s
    (the sequential step on the same parameters and batches; the first on
    the very same parameters), ``warmup`` then ``steps`` timed steps, no
    kernel launched, loss and |g| finite and the last loss below the first
    (this trajectory first falls below its start at step 4: 11.313,
    11.304, 11.313, 11.897, 11.228 in both steps), ms a step, tok/s, peak
    memory and one profiled step's idle share beside the sequential
    step's; (c) reduced gradients
    card vs CPU; (d) MoE under a mesh; (e) the dry run of
    starcoder2-3b's train_4k on the production mesh and of (b)'s cell on
    one card: argument bytes (a lower bound) within (b)'s peak."""
    cfg = get_config("starcoder2-3b")

    def batch_at(s):
        return train_batch(cfg, s, seq, batch, dev, seed=0, learnable=True,
                           mask=False)

    reset_peak()
    params = tfm.init_params(cfg, seed=0, device=dev)
    batches = [batch_at(s) for s in range(warmup + steps + 1)]
    fwd = pipeline_forward_gate(cfg, params, batches[0]["tokens"], dev,
                                stages, n_micro)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same parameters and batches as phase_train's step
    reset_peak()
    opt = adamw_init(params)
    mesh = make_pipeline_mesh(stages, stages, dev)
    step_fn = make_pipeline_train_step(cfg, mesh, lr=lr, n_micro=n_micro)
    reset_launches()
    metrics = []
    for s in range(warmup):
        params, opt, m = step_fn(params, opt, batches[s])
        metrics.append(m)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for s in range(warmup, warmup + steps):
        params, opt, m = step_fn(params, opt, batches[s])
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / steps
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    seq_loss = train["losses"][0]
    loss_err = abs(losses[0] - seq_loss) / abs(seq_loss)
    step_errs = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    tokens = batch * seq
    prof = split_profile(f"{cfg.name}-pipe{stages} train step",
                         lambda: step_fn(params, opt, batches[-1]))
    seq_idle = train["profile"].get("idle", float("nan"))
    log(f"[pipeline] losses {' '.join(f'{x:.4f}' for x in losses)}; |g| "
        f"{' '.join(f'{x:.3f}' for x in norms)}")
    log(f"[pipeline] {cfg.name}-pipe{stages} train, {stages} stages x "
        f"{n_micro} microbatches, {batch} x {seq} tokens a step: "
        f"{1e3 * step_s:.1f} ms a step over {steps} steps, "
        f"{tokens / step_s:.0f} tok/s, peak {peak / 1e9:.2f} GB, idle "
        f"{prof.get('idle', float('nan')):.3f}; the sequential step "
        f"(phase_train, this process): {train['ms']:.1f} ms, "
        f"{train['tok_s']:.0f} tok/s, peak {train['peak_gb']:.2f} GB, idle "
        f"{seq_idle:.3f}; first loss {losses[0]:.6f} vs sequential "
        f"{seq_loss:.6f} (rel {loss_err:.2e}, tol {PIPE_LOSS_TOL:.0e}), "
        f"over {len(step_errs)} steps at most {max(step_errs):.2e}; kernel "
        f"launches in the train steps {launches} [{card()}]")
    check(loss_err <= PIPE_LOSS_TOL and max(step_errs) <= PIPE_LOSS_TOL,
          f"pipelined losses {losses} vs sequential {train['losses']}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"pipelined train: loss or |g| not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"pipelined train: loss did not fall: "
          f"{losses}")
    check(not any(launches.values()),
          f"pipelined train: kernels launched in a train step: {launches}")
    del params, opt, metrics, batches
    gc.collect()
    torch.cuda.empty_cache()

    grads = pipeline_grad_gate(dev, stages, n_micro)
    moe_rows = moe_mesh_gate(dev)

    # (e) the dry run, on the meta device
    t1 = time.perf_counter()
    pod = dryrun.run_cell(cfg.name, "train_4k", "pod")
    one = dryrun.run_cell(cfg.name, "train_4k", "1x1", seq=seq,
                          global_batch=batch)
    arg_bytes = one["per_device"]["argument_bytes"]
    log(f"[pipeline] dryrun {cfg.name} train_4k on the logical (16, 16) "
        f"mesh: {pod['per_device']['flops'] / 1e12:.2f} TFLOP and "
        f"{pod['per_device']['argument_bytes'] / 1e9:.3f} GB of arguments "
        f"a device; (b)'s cell on one card ({batch} x {seq}): "
        f"{one['per_device']['flops_total'] / 1e12:.1f} TFLOP a step, "
        f"argument bytes {arg_bytes / 1e9:.2f} GB (a lower bound) against "
        f"(b)'s measured peak {peak / 1e9:.2f} GB; fits 80 GB: "
        f"{one['fits_80gb']}; {time.perf_counter() - t1:.1f} s")
    check(pod["status"] == one["status"] == "ok" and arg_bytes <= peak,
          f"dryrun: argument bytes {arg_bytes} above the peak {peak}")
    return {"forward": fwd, "launches": launches, "ms": 1e3 * step_s,
            "tok_s": tokens / step_s, "peak_gb": peak / 1e9,
            "losses": losses, "norms": norms, "loss_err": loss_err,
            "profile": prof,
            "grads": grads, "moe": moe_rows,
            "dryrun": {"pod_flops": pod["per_device"]["flops"],
                       "one_arg_bytes": arg_bytes}}


# ------------------------------------------------------ pipeline on ranks

# Ranked step against the logical one: step 0's loss bit for bit (the same
# stage bodies on the same operands, each stage's in its own process);
# later losses and every |g| to 1e-5 relative: the gradient sums arrive in
# another order (each stage's microbatches, then the data group's f32
# all-reduce; |g|² summed per stage, then over the pipe), a few f32 ulps
# that AdamW carries into the next steps' losses.
RANK_STEP_TOL = 1e-5


def rank_window(mesh, dev):
    """Start a timed window on every rank: counters zeroed, the stream
    drained, a barrier. Returns the host clock."""
    mesh.transport.reset()
    reset_launches()
    torch.cuda.synchronize(dev)
    torch.distributed.barrier()
    return time.perf_counter()


def rank_window_end(mesh, dev, t0: float) -> dict:
    """End a window opened by ``rank_window``: the stream drained and a
    barrier, then this rank's wall, hand-off, all-reduce and busy ms, the
    bytes it sent per peer by kind, the kernels it launched, and its
    transport's name, staged bytes and mailbox size. The exchange ms are
    the device transport's time on the rank's stream (CUDA events), or
    gloo's host time after the stream drained."""
    torch.cuda.synchronize(dev)
    torch.distributed.barrier()
    net = mesh.transport
    return {"wall_ms": 1e3 * (time.perf_counter() - t0),
            "handoff_ms": net.ms["p2p"], "reduce_ms": net.ms["reduce"],
            "busy_ms": net.busy_ms(),
            "bytes": {k: list(v) for k, v in net.bytes.items()},
            "launches": launches_now(), "transport": net.name,
            "staged_bytes": net.staged_bytes,
            "mailbox_bytes": getattr(net, "mailbox_bytes", 0)}


def ranked_forward(cfg, params, tokens, mesh, n_micro: int, dev) -> dict:
    """(a) on this rank: the pipelined forward under no_grad, bf16, twice:
    the first run's wavefronts, stage calls, B2 launches and copies, the
    second's B2 calls each against ``mha_ref`` on its own operands (whole
    tensor and per head) and its output against the first; a third run
    timed between barriers. Returns the last stage's outputs on the host."""
    compute = tfm.dtype_of(cfg.compute_dtype)
    s = mesh.coords["pipe"]
    layers = tfm.unstack(params["dense"])

    def stage(stage_layers, x):
        return tfm._scan_segment(cfg, "dense", stage_layers, x)[0]

    def run():
        x = (params["embed"][tokens].to(compute) if s == 0 else
             torch.empty((*tokens.shape, cfg.d_model), dtype=compute,
                         device="meta"))
        return pipeline_apply(stage, layers, split_microbatches(x, n_micro),
                              mesh=mesh)

    with torch.no_grad():
        reset_launches()
        pipeline_apply.wavefronts = pipeline_apply.stage_calls = 0
        ys = run()
        torch.cuda.synchronize(dev)
        counts = {"wavefronts": pipeline_apply.wavefronts,
                  "stage_calls": pipeline_apply.stage_calls,
                  "b2": flash_attention.launches,
                  "copies": flash_attention.copies}
        kernel_attention, errs = tfm.prefill_attention, []

        def held(q, k, v, *, causal=True, window=0):
            o = kernel_attention(q, k, v, causal=causal, window=window)
            ref = mha_ref(q, k, v, causal=causal, window=window)
            errs.append((rel_err(o, ref), head_err(o, ref)))
            return o

        tfm.prefill_attention = held
        try:
            again = torch.equal(run(), ys)
        finally:
            tfm.prefill_attention = kernel_attention
        t0 = rank_window(mesh, dev)
        run()
        ms = rank_window_end(mesh, dev, t0)["wall_ms"]
    return {**counts, "again": again, "ms": ms,
            "b2_err": max((e for e, _ in errs), default=math.inf),
            "b2_head": max((h for _, h in errs), default=math.inf),
            "b2_calls": len(errs),
            "ys": ys.cpu() if s == mesh.shape["pipe"] - 1 else None}


def ranked_steps(cfg, mesh, params, batches, warmup: int, lr: float,
                 n_micro: int, dev) -> dict:
    """(b) on this rank: ``warmup`` steps of the ranked pipelined train
    step, then the rest of ``batches`` timed between barriers: every
    step's loss and |g|, the window's counters, this rank's peak memory
    and the card's memory in use at the window's end."""
    opt = adamw_init(params)
    step_fn = make_pipeline_train_step(cfg, mesh, lr=lr, n_micro=n_micro)
    losses, norms = [], []
    for i, batch in enumerate(batches):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
            t0 = rank_window(mesh, dev)
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = rank_window_end(mesh, dev, t0)
    free, total = torch.cuda.mem_get_info(dev)
    return {**out, "losses": losses, "norms": norms,
            "steps": len(batches) - warmup,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "card_used_gb": (total - free) / 1e9,
            "leaf_bytes": sum(t.nbytes for t in tree_leaves(params))}


def pipe_r2_rank(rank, world, n_micro, batch, seq, warmup, steps, lr, *,
                 device):
    """starcoder2-3b-pipe2-r2 on this rank: the whole model drawn from
    seed 0 (the logical phase's draws) and this stage's leaves kept;
    (a) ``ranked_forward`` on ``phase_pipeline``'s first batch, (b)
    ``ranked_steps`` on its batches."""
    dev = torch.device(device)
    cfg = get_config("starcoder2-3b")
    mesh = make_pipeline_mesh(world, world, dev,
                              group=torch.distributed.group.WORLD)
    params = pipeline_shard(cfg, tfm.init_params(cfg, seed=0, device=dev),
                            mesh)
    torch.cuda.empty_cache()
    batches = [train_batch(cfg, s, seq, batch, dev, seed=0, learnable=True,
                           mask=False) for s in range(warmup + steps)]
    fwd = ranked_forward(cfg, params, batches[0]["tokens"], mesh, n_micro,
                         dev)
    out = ranked_steps(cfg, mesh, params, batches, warmup, lr, n_micro, dev)
    return {"coords": mesh.coords, "forward": fwd, **out}


def pipe_r4_rank(rank, world, layers, n_micro, batch, seq, warmup, steps,
                 lr, ckpt_layers, ckpt_dir, *, device):
    """On this rank of a (2, 2, 1) world: starcoder2-3b-d8-pipe2-dp2-r4,
    ``ranked_steps`` of the ``layers``-layer cut on the global batches;
    then the ``ckpt_layers``-layer cut: one step, a checkpoint from the
    ranks into ``ckpt_dir`` (each rank's own rows read back bit for bit),
    a second step (the unkilled run's end), then a fresh state restored
    from the checkpoint's own rows and the second step again, against
    that end bit for bit."""
    dev = torch.device(device)
    cfg = dataclasses.replace(get_config("starcoder2-3b"), n_layers=layers,
                              compute_dtype="float32")
    mesh = make_pipeline_mesh(2, world, dev,
                              group=torch.distributed.group.WORLD)
    params = pipeline_shard(cfg, tfm.init_params(cfg, seed=0, device=dev),
                            mesh)
    torch.cuda.empty_cache()
    batches = [train_batch(cfg, s, seq, batch, dev, seed=0, learnable=True)
               for s in range(warmup + steps)]
    out = ranked_steps(cfg, mesh, params, batches, warmup, lr, n_micro, dev)
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, n_layers=ckpt_layers)
    params = pipeline_shard(cfg, tfm.init_params(cfg, seed=0, device=dev),
                            mesh)
    opt = adamw_init(params)
    step_fn = make_pipeline_train_step(cfg, mesh, lr=lr, n_micro=n_micro)
    batches = [train_batch(cfg, s, seq, batch, dev, seed=0, learnable=True)
               for s in range(2)]
    params, opt, _ = step_fn(params, opt, batches[0])
    state = {"params": params, "opt": opt}
    rows = pipeline_rows(cfg, state, mesh)
    like = tfm.abstract_params(cfg)
    like = {"params": like, "opt": adamw_init(like)}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ckpt.save_from_ranks(ckpt_dir, 0, state if mesh.coords["data"] == 0
                         else None, like=like, rows=rows)
    save_s = time.perf_counter() - t0
    back = ckpt.restore(ckpt_dir, 0, state, rows=rows)
    own_rows = same_bits(back, state)
    params, opt, _ = step_fn(params, opt, batches[1])
    back = step_fn(back["params"], back["opt"], batches[1])[:2]
    resumed = same_bits(back, (params, opt))
    return {**out, "coords": mesh.coords, "save_s": save_s,
            "own_rows": own_rows, "resumed": resumed}


def rank_cell_report(tag: str, runs, logical: dict, bytes_kind: str,
                     want_bytes) -> None:
    """Print a ranked cell's per-rank numbers and hold its counts: every
    rank's timed steps launch no kernel, every loss and |g| against the
    logical step's (RANK_STEP_TOL; step 0's loss bit for bit when
    ``logical["bits"]``), and the bytes each rank sent its peers of kind
    ``bytes_kind`` in a step equal to ``want_bytes(run)`` (a list)."""
    wall = max(r["wall_ms"] for r in runs) / runs[0]["steps"]
    check_transport(tag, runs)
    log(f"[pipeline ranks] {tag}: {wall:.1f} ms a step (host clock between "
        f"barriers, slowest rank, {runs[0]['steps']} steps), "
        f"{logical['tokens'] / wall * 1e3:.0f} tok/s; the logical step in "
        f"this run {logical['ms']:.1f} ms; card in use at the end "
        f"{max(r['card_used_gb'] for r in runs):.2f} GB of 80, the ranks' "
        f"peaks {sum(r['peak_gb'] for r in runs):.2f} GB [{card()}]")
    log(f"[pipeline ranks]   losses {runs[0]['losses']} vs logical "
        f"{logical['losses'][:len(runs[0]['losses'])]}; |g| "
        f"{runs[0]['norms']} vs {logical['norms'][:len(runs[0]['norms'])]}")
    for r in runs:
        n = r["steps"]
        per = {k: [b // n for b in v] for k, v in r["bytes"].items()}
        log(f"[pipeline ranks]   rank {r['coords']}: peak {r['peak_gb']:.2f}"
            f" GB; hand-offs {r['handoff_ms'] / n:.1f} ms a step "
            f"({r['handoff_ms'] / r['wall_ms']:.1%} of its wall), "
            f"all-reduces {r['reduce_ms'] / n:.1f} ms "
            f"({r['reduce_ms'] / r['wall_ms']:.1%}), busy "
            f"{r['busy_ms'] / n:.1f} ms a step (CUDA events between "
            f"exchanges); bytes a step to each peer {per}; kernel launches "
            f"{r['launches']}")
        errs = [abs(a - b) / abs(b) for a, b in zip(
            r["losses"] + r["norms"], logical["losses"][:len(r["losses"])]
            + logical["norms"][:len(r["norms"])])]
        check(not any(r["launches"].values()),
              f"{tag}: kernels launched in a ranked step: {r['launches']}")
        check(max(errs) <= RANK_STEP_TOL, f"{tag}: rank {r['coords']} "
              f"losses {r['losses']} |g| {r['norms']} vs logical "
              f"{logical['losses']} {logical['norms']}")
        check(not logical["bits"] or r["losses"][0] == logical["losses"][0],
              f"{tag}: step 0's loss {r['losses'][0]!r} is not the logical "
              f"step's {logical['losses'][0]!r} bit for bit")
        check(all(b == n * w for b, w in zip(r["bytes"][bytes_kind],
                                             want_bytes(r))),
              f"{tag}: rank {r['coords']} sent {r['bytes'][bytes_kind]} "
              f"{bytes_kind} bytes in {n} steps, want {want_bytes(r)} each")


def logical_d8(cfg, dev, batch, seq, n_micro, warmup, steps, lr) -> dict:
    """The one-process logical pipelined step of ``cfg`` on a (2, 2, 1)
    mesh of the card, on the ranked cell's batches with microbatches of
    the same rows: losses, |g| and ms a step after ``warmup``."""
    params = tfm.init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    step_fn = make_pipeline_train_step(cfg, make_pipeline_mesh(2, 4, dev),
                                       lr=lr, n_micro=2 * n_micro)
    losses, norms = [], []
    for s in range(warmup + steps):
        if s == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        b = train_batch(cfg, s, seq, batch, dev, seed=0, learnable=True)
        params, opt, m = step_fn(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "norms": norms, "ms": ms,
            "tokens": batch * seq, "bits": False}


def same_small_leaves(ranked: str, step: int, cfg,
                      limit: int = 1 << 20) -> tuple:
    """Whether the ranked checkpoint's manifest names every leaf of the
    whole state, and its manifest entries and files of the leaves of at
    most ``limit`` elements (the stacked norms and biases, whose rows both
    stage ranks wrote, their moments, the step) are byte for byte what the
    one-process ``save`` writes for them; and how many leaves that
    compared. The whole directory is held byte for byte on the CPU
    (``tests/test_torch_pipeline_ranks.py``): its layout is host numpy."""
    like = tfm.abstract_params(cfg)
    like = dict(leaf_paths({"params": like, "opt": adamw_init(like)}))
    small = {}
    for leaf, t in like.items():
        if t.numel() <= limit:
            *path, last = leaf.split("/")
            node = small
            for k in path:
                node = node.setdefault(k, {})
            node[last] = t
    name = f"step_{step:08d}"
    with open(os.path.join(ranked, name, "manifest.json")) as f:
        got = json.load(f)["leaves"]
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, step, ckpt.restore(ranked, step, small, device="cpu"))
        with open(os.path.join(d, name, "manifest.json")) as f:
            want = json.load(f)["leaves"]
        same = sorted(got) == sorted(like) and all(
            got[k] == w and filecmp.cmp(
                os.path.join(d, name, "arrays", w["file"]),
                os.path.join(ranked, name, "arrays", w["file"]),
                shallow=False) for k, w in want.items())
    return same, len(want)


def phase_pipeline_ranks(dev, pipe: dict, n_micro=4, batch=4, seq=2048,
                         warmup=1, steps=2, lr=3e-4, layers=8, d8_steps=1,
                         ckpt_layers=2) -> dict:
    """The pipelined mesh's pipe and data axes as rank processes that
    share the card (``make_pipeline_train_step`` on a
    ``make_pipeline_mesh(..., group=)``; hand-offs and all-reduces through
    the device transport's mailboxes).
    starcoder2-3b-pipe2-r2: full width and depth on 2 stage ranks, each
    drawing the whole model from seed 0 and keeping its stage; (a) the
    pipelined forward under no_grad on ``phase_pipeline``'s first batch:
    the last stage's outputs bit for bit that phase's logical forward,
    ``n_micro`` wavefronts and stage calls and 15 x ``n_micro`` B2 launches
    per rank, each B2 call held to ``mha_ref`` on its operands (TOL bf16,
    whole and per head); (b) ``warmup`` then ``steps`` timed steps on that
    phase's batches: losses and |g| against its logical ones
    (RANK_STEP_TOL, step 0's loss bit for bit), no kernel launched, each
    stage's activations and their gradients n_micro x 1 x seq x d_model
    bf16 a step each way. starcoder2-3b-d8-pipe2-dp2-r4: ``layers`` of 30
    layers at full width on a (2, 2, 1) world, global batch 2·batch x seq,
    ``warmup`` then ``d8_steps`` timed steps against the one-process
    logical step on the same cut (RANK_STEP_TOL),
    each stage's f32 leaf bytes all-reduced with its data peer a step (f32
    compute: in bf16 the head's weight gradient is one bf16 product over
    the batch in one process and two over half batches on the data ranks,
    rounded apart, 2^-8 relative, which RANK_STEP_TOL would not hold);
    and on a ``ckpt_layers``-layer cut, a checkpoint from the ranks, its
    small leaves byte for byte the one-process save's
    (``same_small_leaves``), each rank's rows read back bit for bit, and a
    resume bit for bit the unkilled run."""
    t_phase = time.perf_counter()
    fwd_want = pipe["forward"].pop("ys")
    free, total = torch.cuda.mem_get_info()
    log(f"[pipeline ranks] this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved); the card "
        f"has {free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    r2 = spawn_ranks(pipe_r2_rank, 2, n_micro, batch, seq, warmup, steps,
                     lr, device=dev, timeout=600)
    cfg = get_config("starcoder2-3b")
    per = cfg.n_layers // 2
    for r in r2:
        f = r["forward"]
        log(f"[pipeline ranks] starcoder2-3b-pipe2-r2 forward, rank "
            f"{r['coords']}: {f['wavefronts']} wavefronts, "
            f"{f['stage_calls']} stage calls, {f['b2']} B2 launches, "
            f"{f['copies']} operands copied; a second run bit for bit the "
            f"first: {f['again']}, its {f['b2_calls']} B2 calls against "
            f"mha_ref on their operands: max err {f['b2_err']:.3e}, per "
            f"head {f['b2_head']:.3e} (tol {TOL[torch.bfloat16]:.0e}); "
            f"{f['ms']:.1f} ms between barriers (logical forward "
            f"{pipe['forward']['ms']:.1f} ms)")
        check(f["wavefronts"] == f["stage_calls"] == n_micro
              and f["b2"] == f["b2_calls"] == per * n_micro
              and f["copies"] == 0,
              f"ranked forward counts {f}")
        check(f["again"] and f["b2_err"] <= TOL[torch.bfloat16]
              and f["b2_head"] <= TOL[torch.bfloat16],
              f"ranked forward: rerun equal {f['again']}, B2 against "
              f"mha_ref {f['b2_err']}, per head {f['b2_head']}")
    ys = r2[-1]["forward"]["ys"]
    bits = torch.equal(ys, fwd_want)
    log(f"[pipeline ranks]   the last stage's outputs {tuple(ys.shape)} bit "
        f"for bit the logical pipelined forward: {bits}")
    check(bits, "ranked forward differs from the logical pipelined forward")
    handoff = n_micro * (batch // n_micro) * seq * cfg.d_model * 2
    logical = {"losses": pipe["losses"], "norms": pipe["norms"],
               "ms": pipe["ms"], "tokens": batch * seq, "bits": True}
    rank_cell_report(
        "starcoder2-3b-pipe2-r2", r2, logical, "p2p",
        lambda r: [0, handoff] if r["coords"]["pipe"] == 0 else [handoff, 0])
    log(f"[pipeline ranks]   activation bytes a step each way {handoff} "
        f"(scalars apart)")
    forward_b2 = [r["forward"]["b2"] for r in r2]
    step_launches = [r["launches"] for r in r2]
    del r2
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[pipeline ranks] starcoder2-3b-pipe2-r2: "
        f"{time.perf_counter() - t_phase:.1f} s, spawning included")
    t1 = time.perf_counter()
    cfg8 = dataclasses.replace(cfg, n_layers=layers, compute_dtype="float32")
    logical8 = logical_d8(cfg8, dev, 2 * batch, seq, n_micro, warmup,
                          d8_steps, lr)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        r4 = spawn_ranks(pipe_r4_rank, 4, layers, n_micro, 2 * batch, seq,
                         warmup, d8_steps, lr, ckpt_layers, d, device=dev,
                         timeout=900)
        t3 = time.perf_counter()
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(d) for f in fs)
        same, n_same = same_small_leaves(d, 0, dataclasses.replace(
            cfg8, n_layers=ckpt_layers))
    by = {tuple(r["coords"].values()): r for r in r4}
    rank_cell_report(
        f"starcoder2-3b-d{layers}-pipe2-dp2-r4", r4, logical8, "reduce",
        lambda r: [r["leaf_bytes"] if p == (r["coords"]["pipe"],
                                            1 - r["coords"]["data"], 0)
                   else 0 for p in sorted(by)])
    log(f"[pipeline ranks] the d{layers} logical step {t2 - t1:.1f} s, the "
        f"4-rank world {t3 - t2:.1f} s")
    save_s = max(r["save_s"] for r in r4)
    own = all(r["own_rows"] for r in r4)
    resumed = all(r["resumed"] for r in r4)
    log(f"[pipeline ranks] starcoder2-3b-d{ckpt_layers} on the (2, 2, 1) "
        f"ranks: checkpoint from the ranks {nbytes / 1e9:.3f} GB in "
        f"{save_s:.2f} s; its manifest and the files of its {n_same} "
        f"leaves of <= 2^20 elements byte for byte the one-process save's: "
        f"{same}; each rank's own rows read back bit for bit: {own}; a "
        f"resume bit for bit the unkilled run: {resumed}")
    check(same and own and resumed,
          f"ranked checkpoint: small leaves {same}, own rows {own}, resume "
          f"{resumed}")
    log(f"[pipeline ranks] phase: {time.perf_counter() - t_phase:.1f} s")
    return {"forward_b2": forward_b2, "step_launches": step_launches,
            "r4_launches": [r["launches"] for r in r4]}


# The ranked tensor-parallel cells against the one-process run, as
# max|ranked - one process| / max|one process| over the logits of a call.
# Both run the cell's bf16 compute on the same weights; the ranks sum each
# row-parallel product's f32 partials and round once, as one process
# rounds (``dist/tensor_parallel.py``), but their sums run in other orders
# (partials over ranks, batched products over fewer heads or experts, B4's
# split plan), and the random-weight layers carry the roundings that moves
# to the logits. The prefill is held to 2e-2, the bf16 gate. A decode step
# over yi-6b's 32 768-position cache moves as much between two correct
# attention kernels of one process: B4 against ``decode_ref`` 4.57e-2 at
# the first step on the H100 (``tp_one_process`` measures it per step in
# the run). So each step is held to the larger of
# 2e-2 and TP_NOISE times that one-process gap at the same step, and the
# argmax equal where the one-process top-2 gap exceeds the step's gate.
# MLA has no kernel: its prefill and steps are held to the larger of 2e-2
# and TP_NOISE times the one-process gap between its attention and SDPA's
# (``plain_mla``), 2.1-2.9e-2 on deepseek-v3-671b-d5 on the H100. The MoE's
# router flips near ties on such roundings: a token then goes to another
# expert, or a slot past capacity, and its row moves by its own size (on
# the H100 the ranks' own bf16 dispatch differed from one process's in
# 1 292 of deepseek's 2 048 prefill tokens). So the bf16 calls are teacher
# forced on the dispatch as on the tokens (``forced_routes``): each MoE
# call takes the one-process call's experts and kept slots, weighted by
# its own router; the dispatch itself is held bit for bit in f32 by the
# routing gate (``tp_route_report``). The random-weight Mamba-2 stack
# amplifies a rounding difference in one layer about a thousandfold by the
# logits (the MODEL_TOL note): on the H100 the ranks' own bf16 run of
# mamba2-1.3b-tp4-r4 moved 1.245e-1 from one process's in the prefill and
# 3.7e-2 at the first step, 1.3e-1 by the 16th. So the bf16 calls of an
# ssm or hybrid cell are teacher forced on each Mamba-2 mixer's input as
# on the tokens (``mixer_stream``): every ``mamba2_forward`` and
# ``mamba2_step`` call takes the one-process call's normed input, and its
# output is held to the one-process call's at TP_TOL; the logits at TP_TOL
# too. Every decoder layer of an encdec model reads the encoder's output:
# on the H100 the ranks' own bf16 prefill of seamless-m4t-large-v2-tp2-r2
# (24 encoder layers over 2 048 frames, 24 decoder layers) sat 2.198e-2
# from one process's, as far as one process's prefill with B2 sat from its
# prefill with the plain attention (2.080e-2), and its encoder's output
# 3.125e-2 from one process's (max|diff| / max|output| of the residual
# stream). So the bf16 prefill of an encdec cell is teacher forced on
# each encoder block's output (``encoder_stream``): each block runs on
# the one process's input, its output is held to the one process's at
# TP_TOL, and the decoder reads the one process's encoder output; the
# logits at TP_TOL. The ranks' own bf16 prefill is reported beside each
# forced one. The strict check is f32, unforced: the prefill and a decode
# step in f32 compute, ranked against one process, at DENSE_TOL (the ranks
# change only the order of f32 sums), and for Mamba-2 the conv and SSM
# states after that step; an ssm or hybrid cell's f32 prefill at
# MODEL_TOL, the repo's bound for Mamba-2's f32 sums in another order
# (zamba2-1.2b-tp4-r4's over 4 608 tokens sat 2.300e-4 from one process's
# on the H100, while a wrong layer moves the logits by their own size).
TP_TOL = 2e-2
TP_NOISE = 2.0
MIXER_FAMILIES = ("ssm", "hybrid")
# the families whose bf16 calls are teacher forced on a recorded stream
STREAM_FAMILIES = MIXER_FAMILIES + ("encdec",)
# (cell, arch, layers kept (0: all), mesh (data, model) of data x model
# rank processes, cache positions, the prefill where it is not the
# phase's prompt: ``prompt`` tokens and, for encdec, ``frames`` seeded
# frame embeddings; the cross cache then has as many positions). A moe
# arch keeps its leading dense layers in its cut (deepseek-v3-671b-d5: 3
# dense + 2 MoE). zamba2's prompt of 4 608 passes its 4 096-token window
# by 512 queries, and its steps start at 13 522 (3 x 4 096 + 1 234) with
# every slot of its rings seeded.
# Five cells run cut in depth, so that the whole smoke keeps a margin
# under its time limit (their full-depth cells were the longest: PERF.md
# keeps their runs): mamba2-1.3b to 6 of 48 layers (12 until the
# d_model-sharded cells came), zamba2-1.2b to 14 of 38 (two shared
# attention sites), starcoder2-3b to 10 of 30 (still ``kv_head_pad`` 2),
# yi-6b to 16 of 32 and seamless-m4t-large-v2 on 2 ranks to 6 encoder and
# 6 decoder layers of 24 each. On 4 ranks it serves at full
# depth, its vocabulary of 256 206 not dividing: the embedding and the
# head split d_model (``tensor_parallel.vocab_sharded``).
TP_CELLS = (("yi-6b-d16-tp2-r2", "yi-6b", 16, (1, 2), 32768, {}),
            ("starcoder2-3b-d10-tp4-r4", "starcoder2-3b", 10, (1, 4), 4096,
             {}),
            ("grok-1-314b-d4-tp4-r4", "grok-1-314b", 4, (1, 4), 4096, {}),
            ("deepseek-v3-671b-d5-tp4-r4", "deepseek-v3-671b", 5, (1, 4),
             4096, {}),
            ("grok-1-314b-d2-dp2-tp2-r4", "grok-1-314b", 2, (2, 2), 4096,
             {}),
            ("mamba2-1.3b-d6-tp4-r4", "mamba2-1.3b", 6, (1, 4), 4096, {}),
            ("zamba2-1.2b-d14-tp4-r4", "zamba2-1.2b", 14, (1, 4), 13522 + 17,
             {"prompt": 4608}),
            ("seamless-m4t-large-v2-d6-tp2-r2", "seamless-m4t-large-v2", 6,
             (1, 2), 4096, {"prompt": 512, "frames": 2048}),
            ("seamless-m4t-large-v2-tp4-r4", "seamless-m4t-large-v2", 0,
             (1, 4), 4096, {"prompt": 512, "frames": 2048}))


def tp_config(arch: str, layers: int):
    """The cell's config: ``arch`` at full width, cut to ``layers`` (an
    encdec arch's encoder too)."""
    cfg = get_config(arch)
    if not layers:
        return cfg
    cut = {"encoder_layers": layers} if cfg.family == "encdec" else {}
    return dataclasses.replace(cfg, n_layers=layers, **cut)


def tp_inputs(cfg, dev, prompt: int, batch: int, rows: int = 1, seed=17):
    """The cells' seeded prompt [rows, prompt] (a row a data rank) and
    first decode tokens [batch], drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, cfg.vocab_size, (rows, prompt), generator=gen,
                          device=dev),
            torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                          device=dev))


def tp_prompt(cfg, dev, opts: dict, prompt: int, batch: int, rows: int = 1
              ) -> tuple:
    """A cell's prefill inputs (``tp_inputs``' prompt of the cell's length
    as ``{"tokens": ...}``, for encdec with ``"enc_embeds"``: [rows,
    frames, d_model] seeded on the card, the same on every rank) and
    first decode tokens [batch]."""
    toks, first = tp_inputs(cfg, dev, opts.get("prompt", prompt), batch,
                            rows)
    out = {"tokens": toks}
    if opts.get("frames"):
        gen = torch.Generator(device=dev).manual_seed(20)
        out["enc_embeds"] = torch.randn((rows, opts["frames"], cfg.d_model),
                                        generator=gen, device=dev)
    return out, first


def tp_kernels(cfg) -> tuple:
    """(B2 a prefill, B3 a prefill, B4 a step) of ``cfg`` on a rank, as on
    one process: a GQA layer's attention; a Mamba-2 layer's SSD; the
    hybrid's shared sites; the encdec encoder's and the decoder's self and
    cross attention (B4: self and cross); none with MLA."""
    if cfg.family == "ssm":
        return 0, cfg.n_layers, 0
    if cfg.family == "hybrid":
        sites = len(tfm._hybrid_segments(cfg)) - 1
        return sites, cfg.n_layers, sites
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers, 0, 2 * cfg.n_layers
    gqa = 0 if cfg.attention == "mla" else cfg.n_layers
    return gqa, 0, gqa


STATE_FAMILIES = ("ssm", "hybrid", "encdec")


def _like(seg, leaves: list):
    """A cache segment of ``seg``'s kind (a tuple, or a ``Mamba2State``)
    holding ``leaves``."""
    return type(seg)(*leaves) if hasattr(seg, "_fields") else tuple(leaves)


def tp_state(cfg, batch: int, s_max: int, upto: int, seed: int, dev,
             dtype=torch.bfloat16, enc_seq: int = 0, mesh=None):
    """The decode cache of an ssm, hybrid or encdec cell at position
    ``upto``, seeded on the card from one generator layer by layer (at
    each layer index, each segment's leaves in order, the layer's whole
    batch drawn): the conv states, the SSM states (x 0.1), every slot of
    the hybrid's rings, the encdec's self cache at positions [0, upto) and
    its cross cache of ``enc_seq`` positions. With ``mesh``, this rank's
    shard of it (``shard_cache`` of each layer's draw: its rows, heads,
    and conv channels of its heads and groups): a rank holds its shard and
    one layer's draw, never the whole cache. Per head the ranks' seeded
    states are the yardstick's own."""
    enc_out = None
    if cfg.family == "encdec":
        enc_out = tuple(torch.empty(
            (cfg.n_layers, batch, cfg.n_kv_heads, enc_seq, cfg.head_dim),
            dtype=dtype, device="meta") for _ in range(2))
    whole = tfm.init_cache(cfg, batch, s_max, dtype, enc_out=enc_out,
                           device="meta")
    mine = whole if mesh is None else shard_cache(cfg, whole, mesh)
    cache = mine._replace(pos=upto, layers={key: _like(seg, [
        torch.zeros(t.shape, dtype=t.dtype, device=dev) for t in seg])
        for key, seg in mine.layers.items()})
    gen = torch.Generator(device=dev).manual_seed(seed)
    for i in range(max(seg[0].shape[0] for seg in whole.layers.values())):
        layer = {}
        for key, seg in whole.layers.items():
            if i >= seg[0].shape[0]:
                continue
            vals = [torch.zeros((1,) + t.shape[1:], dtype=t.dtype,
                                device=dev) for t in seg]
            for v in vals:
                (v.narrow(3, 0, upto) if key == "cross_self" else v
                 ).normal_(generator=gen)
            if key == "ssm":
                vals[1].mul_(0.1)
            layer[key] = _like(seg, vals)
        drawn = whole._replace(layers=layer)
        if mesh is not None:
            drawn = shard_cache(cfg, drawn, mesh)
        for key, seg in drawn.layers.items():
            for dst, src in zip(cache.layers[key], seg):
                dst[i].copy_(src[0])
    return cache


def tp_fill(cfg, cache, upto: int, seed: int, heads=None, rows=None,
            batch: int = 0):
    """Seeded contents at positions [0, upto) of a dense or moe cache: per
    segment, layer and leaf, a normal draw for the whole ``batch`` (the
    cache's own unless given) from one generator on the card (GQA: k then
    v, [B, Hkv, upto, hd]; MLA: ckv then k_rope, [B, upto, *]); ``rows``
    picks a data rank's rows of it and ``heads`` a rank's (padded) cache
    heads from the Hkv drawn (MLA's latents are whole on every rank).
    Returns the cache at position ``upto``."""
    mla = cfg.attention == "mla"
    gen = torch.Generator(device=next(iter(cache.layers.values()))[0].device
                          ).manual_seed(seed)
    for seg in cache.layers.values():
        for i in range(seg[0].shape[0]):
            for t in seg:
                b = batch or t.shape[1]
                vals = torch.randn(
                    (b, upto, t.shape[-1]) if mla
                    else (b, cfg.n_kv_heads, upto, cfg.head_dim),
                    generator=gen, device=t.device)
                if rows is not None:
                    vals = vals[rows]
                if heads is not None and not mla:
                    vals = vals[:, heads]
                t[i].narrow(t.dim() - 3, 0, upto).copy_(vals)
    return cache._replace(pos=upto)


def tp_f32_cut(cfg, params):
    """The f32 gate's config and parameters (views): the cell's, in f32
    compute; for a moe arch with MLA only its leading dense layers, since
    a MoE layer of deepseek-v3-671b cast to f32 (46 GB) does not fit beside
    the bf16 model (the routing gate holds that layer in f32 alone)."""
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.attention != "mla" or not cfg.moe:
        return f32, params
    return (dataclasses.replace(f32, n_layers=cfg.moe.first_dense_layers),
            dict(params, moe=first_layers(params["moe"], 0)))


def tp_f32(cfg, params, prompt: dict, make_cache, tok) -> tuple:
    """The f32 gate's calls: prefill of ``prompt`` and one serve step of
    ``tok`` from ``make_cache(f32 config)``, both in f32 compute on
    ``tp_f32_cut``'s layers; their logits on the host, and for a Mamba-2
    model the conv and SSM states after the step."""
    f32, params = tp_f32_cut(cfg, params)
    prefill = make_prefill_step(f32)(params, prompt)
    _, step, cache = make_serve_step(f32)(params, tok, make_cache(f32))
    state = (tuple(t.cpu() for t in cache.layers["ssm"])
             if "ssm" in cache.layers else None)
    return prefill.cpu(), step.cpu(), state


@contextlib.contextmanager
def moe_inputs(out: list):
    """Keeps in ``out`` the input of the last ``moe_ffn`` call of the model
    in the block (x [B, S, D]; a reference, no copy)."""
    ffn = tfm.moe_ffn

    def keeping(x, *args):
        out[:] = [x]
        return ffn(x, *args)

    tfm.moe_ffn = keeping
    try:
        yield out
    finally:
        tfm.moe_ffn = ffn


@contextlib.contextmanager
def recorded_routes(out: list):
    """Each ``moe.route`` call's (experts, positions, kept mask) appended to
    ``out``, one a dispatch row, in call order (left on the device: the
    recording adds no synchronisation to a timed window)."""
    route = moe.route

    def recording(xt, p, cfg_moe):
        r = route(xt, p, cfg_moe)
        out.append((r.expert, r.pos, r.keep))
        return r

    moe.route = recording
    try:
        yield out
    finally:
        moe.route = route


@contextlib.contextmanager
def forced_routes(calls: list, own: list):
    """Teacher-forced routing: each ``moe.route`` call in the block takes
    the next of ``calls`` (another run's recorded (experts, positions,
    kept mask), on the device) in place of its own dispatch, weighted by
    its own router scores for those experts, as the tokens of the ranked
    steps are the yardstick's. Its own dispatch goes to ``own``."""
    route = moe.route
    forced = iter(calls)

    def forcing(xt, p, cfg_moe):
        r = route(xt, p, cfg_moe)
        own.append((r.expert, r.pos, r.keep))
        expert, pos, keep = next(forced)
        _, src = moe._scores(xt, p, cfg_moe)
        w = src.gather(1, expert)
        return moe.Routing(expert, w / (w.sum(-1, keepdim=True) + 1e-9),
                           pos, keep, r.capacity)

    moe.route = forcing
    try:
        yield own
    finally:
        moe.route = route


@contextlib.contextmanager
def mixer_stream(calls: list, forced=None):
    """Each Mamba-2 mixer call of the model in the block
    (``mamba2_forward`` in a prefill, ``mamba2_step`` in a step) appends
    (its normed input, its output) to ``calls``, on the device; with
    ``forced`` (an iterator of another run's inputs, on the device) each
    call takes the next of them as its input instead."""
    forward, step = tfm.mamba2_forward, tfm.mamba2_step

    def forward_on(h, p, ssm):
        h = h if forced is None else next(forced)
        y = forward(h, p, ssm)
        calls.append((h, y))
        return y

    def step_on(h, state, p, ssm):
        h = h if forced is None else next(forced)
        y, new = step(h, state, p, ssm)
        calls.append((h, y))
        return y, new

    tfm.mamba2_forward, tfm.mamba2_step = forward_on, step_on
    try:
        yield calls
    finally:
        tfm.mamba2_forward, tfm.mamba2_step = forward, step


@contextlib.contextmanager
def encoder_stream(calls: list, forced=None):
    """Each encoder block of an encdec model in the block appends (its
    output,) (the residual stream, [B, frames, d_model]) to ``calls``, on
    the device; with ``forced`` (an iterator of another run's block
    outputs, on the device) each block still runs, and the next of them
    takes the place of its output: every encoder block, and the decoder,
    read the other run's encoder stream."""
    block = tfm._block_full

    def on(cfg, kind, p, x, **kw):
        out, cache = block(cfg, kind, p, x, **kw)
        if kind != "enc":
            return out, cache
        calls.append((out,))
        return (out if forced is None else next(forced)), cache

    tfm._block_full = on
    try:
        yield calls
    finally:
        tfm._block_full = block


def recording(cfg, calls: list, forced=None):
    """The stream a cell's bf16 calls record or are forced on, each call
    (what a forced run takes, ..., its output): the Mamba-2 mixers'
    (``mixer_stream``) of an ssm or hybrid model, the encoder blocks'
    (``encoder_stream``) of an encdec one, else none."""
    if cfg.family in MIXER_FAMILIES:
        return mixer_stream(calls, forced)
    if cfg.family == "encdec":
        return encoder_stream(calls, forced)
    return contextlib.nullcontext()


def tp_moe_layer(params, i: int) -> dict:
    """The routing gate's layer: MoE layer ``i``'s leaves of ``params``
    (one process's, or a rank's shard) in f32 on their device. The layer
    waits on the host while ``params`` is emptied and the rest of the
    model freed (the caller holds no other reference to it), so the card
    never holds the model and the f32 layer at once (deepseek-v3-671b:
    53.2 GB of bf16 weights, a MoE layer 46 GB in f32)."""
    dev = params["moe"]["moe"]["w_in"].device
    layer = {name: leaf[i].cpu()
             for name, leaf in params["moe"]["moe"].items()}
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {name: layer.pop(name).to(dev).float() for name in list(layer)}


def tp_route_gate(cfg, params, x, mesh, batch: int) -> tuple:
    """One MoE layer (the cut's last) in f32, fed ``x`` (its input in the
    yardstick's bf16 prefill) under ``mesh``: (output on the host, each
    dispatch row's (experts, positions, kept mask)). Frees the model."""
    layer = tp_moe_layer(params, tfm.layer_kinds(cfg)["moe"] - 1)
    routes = []
    with launch_mesh(mesh, global_batch=batch), recorded_routes(routes):
        y = moe.moe_ffn(x.float(), layer, cfg.moe, cfg.ffn, torch.float32)
    return y.cpu(), host(routes)


def host(routes: list) -> list:
    """Recorded dispatch calls on the host."""
    return [tuple(a.cpu() for a in call) for call in routes]


def layer_routes(calls: list, rows: int) -> list:
    """A run's recorded MoE calls by layer (``rows`` dispatch rows a
    layer, in row order): each layer's (experts, kept mask) [T, k] over all
    its tokens."""
    return [tuple(torch.cat([calls[i * rows + r][j] for r in range(rows)])
                  for j in (0, 2)) for i in range(len(calls) // rows)]


def routed_alike(a: list, b: list, tokens=slice(None)):
    """[T] bool over ``tokens`` of ``a`` and ``b`` (two runs'
    ``layer_routes``, ``b`` taken at ``tokens``): whether each token went
    to the same experts with the same kept slots in every MoE layer; None
    without MoE layers."""
    out = None
    for (ea, ka), (eb, kb) in zip(a, b):
        same = (ea == eb[tokens]).all(-1) & (ka == kb[tokens]).all(-1)
        out = same if out is None else out & same
    return out


def tp_one_process(cfg, dev, s_max: int, prompt: int, batch: int,
                   steps: int, gate_batch: int, data: int, model: int,
                   opts: dict) -> dict:
    """The yardstick of a ranked cell, on this process: with a data axis
    under a logical (data, model) mesh (``dispatch_rows()`` is ``data``:
    each data rank's row routed on its own), else with no mesh. Prefill of
    the seeded prompt (a row a data rank), then ``steps`` + 1 greedy serve
    steps from the seeded cache at ``s_max - steps - 1``: the step inputs
    and every logits, on the host, and the ms of the timed steps; the same
    steps fed the same inputs with the plain attention (``decode_ref``),
    the bf16 noise of a step (with MLA, ``plain_mla``'s SDPA against the
    model's attention, in the prefill too; the routing forced to the
    kernel run's, ``forced_routes``); the f32 gate's calls (``tp_f32``,
    a ``gate_batch`` cache); for a moe arch every MoE call's dispatch in
    the prefill and the steps, and the routing gate (``tp_route_gate``) on
    the last MoE layer's input in the prefill. An ssm, hybrid or encdec
    cell's prefill is ``opts``' (``tp_prompt``), its cache seeded by
    ``tp_state`` and its bf16 prefill's and steps' stream recorded
    (``recording``); the f32 step's conv and SSM states come back too."""
    mesh = Mesh((data, model), ("data", "model"), dev) if data > 1 else None
    params = tfm.init_params(cfg, seed=0, device=dev)
    toks, first = tp_prompt(cfg, dev, opts, prompt, batch, rows=data)
    upto = s_max - steps - 1
    serve = make_serve_step(cfg)
    gate_x = []
    enc_seq = opts.get("frames", 0)
    pre_rec, step_rec = [], []

    def seeded(c, rows, seed, dtype=torch.bfloat16):
        if c.family in STATE_FAMILIES:
            return tp_state(c, rows, s_max, upto, seed, dev, dtype, enc_seq)
        return tp_fill(c, tfm.init_cache(c, rows, s_max, dtype, device=dev),
                       upto, seed=seed)

    with torch.inference_mode(), launch_mesh(mesh, global_batch=batch):
        make_prefill_step(cfg)(params, {k: v[:, :256]
                                        for k, v in toks.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre_routes, routes, plain_routes = [], [], []
        with moe_inputs(gate_x), recorded_routes(pre_routes), \
                recording(cfg, pre_rec):
            prefill = make_prefill_step(cfg)(params, toks)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        cache = seeded(cfg, batch, 18)
        tok, inputs, logits = first, [], []
        for i in range(steps + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            inputs.append(tok)
            routes.append([])
            step_rec.append([])
            with recorded_routes(routes[-1]), recording(cfg, step_rec[-1]):
                tok, lg, cache = serve(params, tok, cache)
            logits.append(lg.float().cpu())
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        del cache
        # a second correct attention, the dispatch forced to the run's
        mla = cfg.attention == "mla"
        other = plain_mla if mla else plain_attention
        cache = seeded(cfg, batch, 18)
        plain = []
        with other():
            for tok, forced in zip(inputs, routes):
                with forced_routes(forced, []):
                    _, lg, cache = serve(params, tok, cache)
                plain.append(lg.float().cpu())
        del cache
        prefill_noise = 0.0
        if mla:
            with other(), forced_routes(pre_routes, []):
                again = make_prefill_step(cfg)(params, toks)
            prefill_noise = float((again.float() - prefill.float()).abs().max()
                                  / prefill.float().abs().max())
            del again
        torch.cuda.empty_cache()
        f32 = tp_f32(cfg, params, toks, lambda c: seeded(
            c, gate_batch, 19, torch.float32), first[:gate_batch])
        route = None
        if cfg.moe:
            route = tp_route_gate(cfg, params, gate_x[0], mesh, batch)
    out = {"prefill": prefill.float().cpu(), "prefill_ms": prefill_ms,
           "inputs": torch.stack(inputs).cpu(), "step_ms": step_ms,
           "steps": torch.stack(logits), "noise": [
               float((a - b).abs().max() / a.abs().max())
               for a, b in zip(logits, plain)],
           "prefill_noise": prefill_noise, "f32": f32,
           "route": route, "gate_x": gate_x[0].cpu() if gate_x else None,
           "prefill_routes": host(pre_routes),
           "step_routes": [host(r) for r in routes],
           "stream": {"prefill": host(pre_rec),
                      "steps": [host(m) for m in step_rec]}
           if cfg.family in STREAM_FAMILIES else None}
    del params, prefill, gate_x, pre_rec, step_rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def held_kernels(errs: list):
    """Each B2 call of the model held to ``mha_ref``, each B3 call to
    ``ssd_chunked_ref`` and each B4 call to ``decode_ref`` on its own
    operands, whole and per head or row: ``errs`` gets (kernel, whole, per
    head/row) per call."""
    attn, decode = tfm.prefill_attention, tfm.decode_attention_host
    scan = mamba2.ssd

    def held_scan(x, dt, a, b, c, d=None, *, q_chunk=128):
        o = scan(x, dt, a, b, c, d, q_chunk=q_chunk)
        ref = ssd_chunked_ref(x, dt, a, b, c, d, q_chunk=q_chunk)
        errs.append(("B3", rel_err(o, ref), ssd_head_err(o, ref)))
        return o

    def held_attn(q, k, v, *, causal=True, window=0):
        o = attn(q, k, v, causal=causal, window=window)
        ref = mha_ref(q, k, v, causal=causal, window=window)
        errs.append(("B2", rel_err(o, ref), head_err(o, ref)))
        return o

    def held_decode(q, k, v, kv_len=None):
        o = decode(q, k, v, kv_len)
        ref = decode_ref(q, k, v, kv_len)
        errs.append(("B4", rel_err(o, ref), row_err(o, ref)))
        return o

    tfm.prefill_attention, tfm.decode_attention_host = held_attn, held_decode
    mamba2.ssd = held_scan
    try:
        yield errs
    finally:
        tfm.prefill_attention, tfm.decode_attention_host = attn, decode
        mamba2.ssd = scan


def tp_rank(rank, world, cell, prompt, batch, steps, gate_batch, inputs,
            gate_x, calls, recorded, *, device):
    """A ranked tensor-parallel cell on this rank of its (data, model)
    mesh (``make_dev_mesh(world, model=, group=)``): its shard of the
    seed-0 weights drawn leaf by leaf, then under ``launch_mesh``: a
    warm-up prefill, the timed prefill of its data row of the seeded
    prompt (counted), the same prefill with each B2 call held to
    ``mha_ref``; its shard of the seeded cache (its rows, its KV heads),
    the first serve step with each B4 call held to ``decode_ref``, then
    ``steps`` timed serve steps fed its rows of the yardstick's ``inputs``
    (counted); the MoE's dispatch in these bf16 prefills and steps forced
    to its data row's of the yardstick's (``calls``: the prefill's and
    each step's recorded dispatch calls; ``forced_routes``), its own
    recorded; then the f32 gate's calls (``tp_f32``) and for a moe arch
    last the routing gate (``tp_route_gate``) on its row of ``gate_x``,
    which frees the model, both routed by the rank itself. An ssm, hybrid
    or encdec cell prefills ``tp_prompt``'s inputs and seeds its shard of
    the cache (``tp_state``), and each B3 call is held to
    ``ssd_chunked_ref`` too. Its bf16 prefills and steps are teacher
    forced on the yardstick's stream (``recorded``: the path of a file of
    its recorded calls; ``recording``: the Mamba-2 mixers' inputs of an
    ssm or hybrid cell, the encoder blocks' outputs of an encdec one), each
    forced call's output held to the yardstick's, and its own unforced
    prefill is run once more for the report. Returns every logits
    (gathered: the whole vocabulary), the windows' counters, the held
    errors, its own dispatch, the gate's output and dispatch (and Mamba-2
    states), and this rank's peak memory."""
    _, arch, layers, (_, model), s_max, opts = cell
    dev = torch.device(device)
    t_in = time.perf_counter()
    gc.collect()              # the world's cell before this one
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = tp_config(arch, layers)
    mesh = make_dev_mesh(world, model=model, device=dev,
                         group=torch.distributed.group.WORLD)
    data, d = mesh.shape["data"], mesh.coords["data"]
    rows = slice(d * batch // data, (d + 1) * batch // data)
    t0 = time.perf_counter()
    params = init_shard_params(cfg, mesh, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    leaf_gb = sum(t.nbytes for t in tree_leaves(params)) / 1e9
    torch.cuda.empty_cache()
    toks, _ = tp_prompt(cfg, dev, opts, prompt, batch, rows=data)
    toks = {k: v[d:d + 1] for k, v in toks.items()}
    g_rows = slice(d * gate_batch // data, (d + 1) * gate_batch // data)
    gate_tok = inputs[0, :gate_batch][g_rows].to(dev)
    inputs = inputs[:, rows].to(dev)
    step = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    pad = kv_head_pad(cfg, model)
    per = cfg.n_kv_heads * pad // model
    heads = torch.arange(per * mesh.coords["model"],
                         per * (mesh.coords["model"] + 1)) // pad
    def mine(run):
        """This data row's calls of a yardstick run: call l·data + d."""
        return [tuple(a.to(dev) for a in c) for c in run[d::data]]

    upto = s_max - steps - 1

    def seeded(c, rows, n, seed, dtype=torch.bfloat16):
        if c.family in STATE_FAMILIES:
            return tp_state(c, n, s_max, upto, seed, dev, dtype,
                            opts.get("frames", 0), mesh)
        return tp_fill(c, init_shard_cache(c, mesh, n, s_max, dtype,
                                           device=dev),
                       upto, seed=seed, heads=heads, rows=rows, batch=n)

    pre_calls = mine(calls["prefill"])
    step_calls = [mine(c) for c in calls["steps"]]
    errs, pre_routes, routes = [], [], []
    stream = {"prefill": [], "steps": [[] for _ in range(steps + 1)]}
    if recorded:     # the yardstick's forced values, this rank's rows
        rec = torch.load(recorded, mmap=True)
        forced = {"prefill": [c[0][d:d + 1].to(dev) for c in rec["prefill"]],
                  "steps": [[c[0][rows].to(dev) for c in calls_i]
                            for calls_i in rec["steps"]]}

    def forcing(phase, i=None):
        """The forced stream of a prefill (``i`` None) or step ``i``."""
        if not recorded:
            return contextlib.nullcontext()
        calls_in = forced[phase] if i is None else forced[phase][i]
        out = stream[phase] if i is None else stream[phase][i]
        out.clear()
        return recording(cfg, out, iter(calls_in))

    with torch.inference_mode(), launch_mesh(mesh, global_batch=batch):
        step(params, {k: v[:, :256] for k, v in toks.items()})   # warm-up
        t0 = rank_window(mesh, dev)
        with forced_routes(pre_calls, pre_routes), forcing("prefill"):
            prefill = step(params, toks)
        pre = rank_window_end(mesh, dev, t0)
        pre["gather_ms"] = mesh.transport.ms["gather"]
        pre["copies"] = (flash_attention.copies, ssd_scan.narrow)
        with held_kernels(errs), forced_routes(pre_calls, []), \
                recording(cfg, [], iter(forced["prefill"])) if recorded \
                else contextlib.nullcontext():
            again = step(params, toks)
        own = step(params, toks).float().cpu() if recorded else None
        cache = seeded(cfg, rows, batch, 18)
        routes.append([])
        with held_kernels(errs), forced_routes(step_calls[0], routes[-1]), \
                forcing("steps", 0):
            _, first, cache = serve(params, inputs[0], cache)
        logits = [first]
        t0 = rank_window(mesh, dev)
        for i in range(1, steps + 1):
            routes.append([])
            with forced_routes(step_calls[i], routes[-1]), \
                    forcing("steps", i):
                _, lg, cache = serve(params, inputs[i], cache)
            logits.append(lg)
        dec = rank_window_end(mesh, dev, t0)
        dec["gather_ms"] = mesh.transport.ms["gather"]
        first_seg = next(iter(cache.layers.values()))
        shape = tuple(first_seg[0].shape)
        cache_gb = sum(t.nbytes for seg in cache.layers.values()
                       for t in seg) / 1e9
        del cache, first_seg
        stream_errs = None
        if recorded:     # each forced call's output against the yardstick's
            stream_errs = {
                "prefill": [max_rel(c[-1], w[-1][d:d + 1].to(dev)) for c, w
                            in zip(stream["prefill"], rec["prefill"])],
                "steps": [[max_rel(c[-1], w[-1][rows].to(dev)) for c, w
                           in zip(mine_i, theirs)]
                          for mine_i, theirs in zip(stream["steps"],
                                                    rec["steps"])]}
            del forced, stream, rec
        torch.cuda.empty_cache()
        f32 = tp_f32(cfg, params, toks, lambda c: seeded(
            c, g_rows, gate_batch, 19, torch.float32), gate_tok)
        route = None
        if cfg.moe:
            route = tp_route_gate(cfg, params, gate_x[d:d + 1].to(dev), mesh,
                                  batch)
    return {"coords": mesh.coords, "init_s": init_s, "prefill_window": pre,
            "job_s": time.perf_counter() - t_in,
            "stream_errs": stream_errs, "own_prefill": own,
            "decode_window": dec, "errs": errs, "f32": f32, "route": route,
            "prefill_routes": layer_routes(host(pre_routes), 1),
            "step_routes": [layer_routes(host(r), 1) for r in routes],
            "prefill": prefill.float().cpu(),
            "prefill_again": torch.equal(again, prefill),
            "steps": torch.stack(logits).float().cpu(),
            "cache_shape": shape, "leaf_gb": leaf_gb, "cache_gb": cache_gb,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def tp_gate(tag: str, got: torch.Tensor, want: torch.Tensor, tol: float,
            failed: list) -> float:
    """max|got - want| / max|want| of one call's logits, gated at ``tol``,
    and the argmax equal on every row whose one-process top-2 gap exceeds
    ``tol`` x max|want| (teacher forced: the ranks were fed the one-process
    run's tokens and MoE dispatch); a gate that fails is added to
    ``failed``."""
    err = float((got - want).abs().max() / want.abs().max())
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol * float(want.abs().max())
    same = got.argmax(-1) == want.argmax(-1)
    if err > tol:
        failed.append(f"{tag}: ranked logits vs one process {err} (tol "
                      f"{tol})")
    if not bool(same[sure].all()):
        failed.append(f"{tag}: argmax differs on {int((~same & sure).sum())}"
                      " rows whose top-2 gap exceeds the gate")
    return err


def tp_reduces(cfg, tokens: int, frames: int = 0, model: int = 2) -> int:
    """The f32 bytes a forward of ``tokens`` decoder tokens (``frames``
    encoder frames) all-reduces with each peer of its model group of
    ``model`` ranks, the head's aside (``tp_head_bytes``): a [tokens,
    d_model] for a vocab-sharded embedding, each attention ``wo`` (the
    cross-attention's too), each dense ``w_out``, each MoE combine and
    each shared ``w_out`` (one collective with the combine, its bytes),
    each Mamba-2 ``w_out``, and the encoder's ``wo`` and ``w_out`` at
    [frames, d_model]; and each Mamba-2 gated norm's [tokens, 1] sum of
    squares."""
    kinds = tfm.layer_kinds(cfg)
    d = cfg.d_model
    embed = int(vocab_sharded(cfg, model))
    if cfg.family == "encdec":
        return 4 * d * ((embed + 3 * cfg.n_layers) * tokens
                        + 2 * cfg.encoder_layers * frames)
    if cfg.ssm is not None:
        sites = tp_kernels(cfg)[0]
        return 4 * tokens * ((embed + cfg.n_layers + 2 * sites) * d
                             + cfg.n_layers)
    shared = 1 if cfg.moe and cfg.moe.n_shared_experts else 0
    return 4 * tokens * d * (embed + cfg.n_layers + kinds.get("dense", 0)
                             + kinds.get("moe", 0) * (1 + shared))


def tp_head_bytes(cfg, tokens: int, positions: int, model: int,
                  itemsize: int) -> tuple:
    """(f32 bytes all-reduced, bytes gathered) with each peer of a model
    group of ``model`` ranks by the embedding of ``tokens`` tokens and the
    head's logits at ``positions`` positions, in a forward of the compute
    dtype's ``itemsize``: split on the vocabulary, the logits' [positions,
    V / model] gathered (the embedding's all-reduce is
    ``tp_reduces``'); split on d_model, the embedding's [tokens, d_model /
    model] gathered and the head's f32 partials [positions, V]
    all-reduced."""
    if vocab_sharded(cfg, model):
        return 0, positions * cfg.vocab_size // model * itemsize
    return (4 * positions * cfg.vocab_size,
            tokens * cfg.d_model // model * itemsize)


def tp_route_report(name: str, cfg, runs, want: dict) -> float:
    """Hold every rank's routing gate to the yardstick's: its dispatch
    row's experts, positions and kept masks bit for bit, its output within
    DENSE_TOL; returns the kept share."""
    y_want, r_want = want["route"]
    kept = float(torch.cat([r[2].float().flatten() for r in r_want]).mean())
    errs = []
    for r in runs:
        d = r["coords"]["data"]
        y, routes = r["route"]
        same = len(routes) == 1 and all(
            torch.equal(a, b) for a, b in zip(routes[0], r_want[d]))
        err = float((y[0] - y_want[d]).abs().max() / y_want[d].abs().max())
        errs.append(err)
        check(same and err <= DENSE_TOL, f"{name}: rank {r['coords']} "
              f"routing gate: dispatch equal {same}, output {err}")
    tokens = want["gate_x"].shape[1]
    log(f"[tensor ranks] {name}: its last MoE layer in f32 on the ranks, "
        f"fed the yardstick's bf16 prefill input to it "
        f"{list(want['gate_x'].shape)} ({len(r_want)} dispatch rows of "
        f"{tokens} tokens, capacity {moe.capacity(tokens, cfg.moe)}): "
        f"experts, positions and kept masks bit for bit the yardstick's on "
        f"every rank, outputs {max(errs):.3e} (tol {DENSE_TOL:.0e}); kept "
        f"{kept:.4f} of routed slots [{card()}]")
    return kept


def tp_state_report(name: str, cfg, runs, want: dict) -> float:
    """Hold every rank's conv and SSM states after the f32 gate step to
    the yardstick's slices in the head-aligned layout (``head_columns``:
    the conv channels of its heads and groups; its SSM heads) at
    DENSE_TOL; returns the largest gap."""
    model = max(r["coords"]["model"] for r in runs) + 1
    conv_want, ssm_want = want["f32"][2]
    nh = ssm_want.shape[2]
    worst = 0.0
    for r in runs:
        c = r["coords"]["model"]
        cols = torch.cat([torch.arange(lo, hi) for lo, hi in
                          mamba2.head_columns(cfg.ssm, cfg.d_model, model,
                                              c, "conv")])
        conv, ssm = r["f32"][2]
        gaps = [float((got - w).abs().max() / w.abs().max()) for got, w in (
            (conv, conv_want[..., cols]),
            (ssm, ssm_want[:, :, c * nh // model:(c + 1) * nh // model]))]
        worst = max(worst, *gaps)
        check(conv.shape[-1] == len(cols) and max(gaps) <= DENSE_TOL,
              f"{name}: rank {r['coords']} f32 conv and SSM states vs the "
              f"yardstick's slices {gaps}")
    return worst


def tp_stream_report(name: str, cfg, runs, want: dict, failed: list
                     ) -> None:
    """Hold every rank's teacher-forced calls (``recording``), each output
    within TP_TOL of the yardstick's on the same input: a Mamba-2 mixer a
    layer in each bf16 prefill and step, an encoder block a layer in the
    prefill; report how far the ranks' own (unforced) bf16 prefill moved
    from the yardstick's."""
    mixers = cfg.family in MIXER_FAMILIES
    per = cfg.n_layers if mixers else cfg.encoder_layers
    worst_pre, worst_step, own = 0.0, 0.0, []
    for r in runs:
        m = r["stream_errs"]
        counts = [len(m["prefill"])] + [len(c) for c in m["steps"]]
        check(counts == [per] + [per if mixers else 0] * len(m["steps"]),
              f"{name}: rank {r['coords']} forced calls {counts}")
        worst_pre = max(worst_pre, *m["prefill"])
        worst_step = max(worst_step, 0.0, *(e for c in m["steps"] for e in c))
        dd = r["coords"]["data"]
        own.append(max_rel(r["own_prefill"], want["prefill"][dd:dd + 1]))
    if max(worst_pre, worst_step) > TP_TOL:
        failed.append(f"{name}: forced calls' outputs vs the yardstick's "
                      f"{worst_pre}, {worst_step} (tol {TP_TOL})")
    what = (f"Mamba-2 mixer inputs, {per} calls a prefill and a step per "
            f"rank; each output vs the yardstick's: bf16 prefill "
            f"{worst_pre:.3e}, steps {worst_step:.3e}" if mixers else
            f"encoder block outputs, {per} calls a prefill per rank (the "
            "decoder reads the yardstick's encoder output); each output vs "
            f"the yardstick's: {worst_pre:.3e}")
    log(f"[tensor ranks] {name}: teacher forced on the yardstick's {what} "
        f"(tol {TP_TOL:.0e}); the ranks' own unforced bf16 prefill vs the "
        f"yardstick's: {max(own):.3e} (reported) [{card()}]")


def tp_report(name: str, cfg, runs, want: dict, prompt: int, batch: int,
              steps: int, gate_batch: int, opts: dict, twin: bool = False
              ) -> dict:
    """Hold a ranked cell's per-rank counts, bytes and logits and print
    its numbers (``twin``: the cell's run on gloo, held to every gate but
    the transport's); returns its launches per rank."""
    model = max(r["coords"]["model"] for r in runs) + 1
    data = len(runs) // model
    rows = batch // data
    prompt = opts.get("prompt", prompt)
    n_b2, n_b3, n_b4 = tp_kernels(cfg)
    pre_head = tp_head_bytes(cfg, prompt, 1, model, 2)
    dec_head = tp_head_bytes(cfg, rows, rows, model, 2)
    pre_reduce = tp_reduces(cfg, prompt, opts.get("frames", 0),
                            model) + pre_head[0]
    pre_gather = pre_head[1]
    dec_reduce = steps * (tp_reduces(cfg, rows, 0, model) + dec_head[0])
    dec_gather = steps * dec_head[1]
    for window in ("prefill_window", "decode_window"):
        check_transport(f"{name} {window[:-7]}", [r[window] for r in runs],
                        runs[0][window]["transport"] if twin else "device")
    for r in runs:
        pw, dw = r["prefill_window"], r["decode_window"]
        b2 = [e for e in r["errs"] if e[0] == "B2"]
        b3 = [e for e in r["errs"] if e[0] == "B3"]
        b4 = [e for e in r["errs"] if e[0] == "B4"]
        peers = [p for p, o in enumerate(runs)
                 if o["coords"]["data"] == r["coords"]["data"]
                 and o["coords"] != r["coords"]]
        log(f"[tensor ranks] {name} rank {r['coords']}: weights "
            f"{r['leaf_gb']:.2f} GB (drawn as shards in {r['init_s']:.2f} s)"
            f", cache {r['cache_gb']:.2f} GB {list(r['cache_shape'])}, peak "
            f"{r['peak_gb']:.2f} GB; prefill 1 x {prompt}: "
            f"{pw['wall_ms']:.1f} ms, all-reduce {pw['reduce_ms']:.1f} ms "
            f"({pw['reduce_ms'] / pw['wall_ms']:.1%}), gather "
            f"{pw['gather_ms']:.2f} ms, busy {pw['busy_ms']:.1f} ms, "
            f"launches {pw['launches']}; decode: "
            f"{dw['wall_ms'] / steps:.2f} ms a step, "
            f"{rows * steps / dw['wall_ms'] * 1e3:.1f} tok/s, all-reduce "
            f"{dw['reduce_ms'] / steps:.2f} ms a step "
            f"({dw['reduce_ms'] / dw['wall_ms']:.1%}), gather "
            f"{dw['gather_ms'] / steps:.2f} ms "
            f"({dw['gather_ms'] / dw['wall_ms']:.1%}), busy "
            f"{dw['busy_ms'] / steps:.2f} ms a step, launches "
            f"{dw['launches']}; bytes to each peer: prefill "
            f"{pw['bytes']['reduce'][peers[0]]} all-reduce + "
            f"{pw['bytes']['gather'][peers[0]]} gather, a step "
            f"{dw['bytes']['reduce'][peers[0]] // steps} + "
            f"{dw['bytes']['gather'][peers[0]] // steps} [{card()}]")
        if n_b2:
            log(f"[tensor ranks]   its {len(b2)} B2 calls against mha_ref: "
                f"max err {max(e[1] for e in b2):.3e}, per head "
                f"{max(e[2] for e in b2):.3e}; its {len(b4)} B4 calls against "
                f"decode_ref: {max(e[1] for e in b4):.3e}, per row "
                f"{max(e[2] for e in b4):.3e} (tol {TOL[torch.bfloat16]:.0e}, "
                f"{DECODE_ROW_TOL[torch.bfloat16]:.0e})")
        if n_b3:
            log(f"[tensor ranks]   its {len(b3)} B3 calls against "
                f"ssd_chunked_ref: max err {max(e[1] for e in b3):.3e}, per "
                f"head {max(e[2] for e in b3):.3e} (tol "
                f"{TOL_SSD[torch.bfloat16]:.0e}, "
                f"{SSD_ROW_TOL[torch.bfloat16]:.0e}); operands copied for "
                f"TMA, B3 element-wise copies {pw['copies']}")
        check(pw["launches"]["flash_attention"] == n_b2
              and pw["launches"]["decode_attention"] == 0
              and dw["launches"]["decode_attention"] == n_b4 * steps
              and dw["launches"]["flash_attention"] == 0
              and not pw["launches"]["block_gemm"]
              and not dw["launches"]["block_gemm"]
              and pw["launches"]["ssd_scan"] == n_b3
              and not dw["launches"]["ssd_scan"]
              and pw["copies"] == (0, 0),
              f"{name}: rank {r['coords']} launches {pw['launches']} "
              f"{dw['launches']}, copies {pw['copies']}")
        check(len(b2) == n_b2 and len(b3) == n_b3 and len(b4) == n_b4
              and max((e[1] for e in b2 + b4), default=0)
              <= TOL[torch.bfloat16]
              and max((e[2] for e in b2), default=0) <= TOL[torch.bfloat16]
              and max((e[2] for e in b4), default=0)
              <= DECODE_ROW_TOL[torch.bfloat16]
              and max((e[1] for e in b3), default=0)
              <= TOL_SSD[torch.bfloat16]
              and max((e[2] for e in b3), default=0)
              <= SSD_ROW_TOL[torch.bfloat16],
              f"{name}: held kernel calls {r['errs']}")
        check(r["prefill_again"], f"{name}: a second prefill differs")
        for p in range(len(runs)):
            check(pw["bytes"]["reduce"][p] == (pre_reduce if p in peers
                                               else 0)
                  and pw["bytes"]["gather"][p] == (pre_gather if p in peers
                                                   else 0)
                  and dw["bytes"]["reduce"][p] == (dec_reduce if p in peers
                                                   else 0)
                  and dw["bytes"]["gather"][p] == (dec_gather if p in peers
                                                   else 0)
                  and not any(pw["bytes"]["p2p"] + dw["bytes"]["p2p"]),
                  f"{name}: rank {r['coords']} bytes {pw['bytes']} "
                  f"{dw['bytes']}")
        for p in peers:
            check(torch.equal(r["prefill"], runs[p]["prefill"])
                  and torch.equal(r["steps"], runs[p]["steps"])
                  and all(torch.equal(a, b) for a, b in zip(
                      r["f32"][:2], runs[p]["f32"][:2])),
                  f"{name}: ranks {r['coords']} and {runs[p]['coords']} "
                  "disagree on the gathered logits")
    gates = [max(TP_TOL, TP_NOISE * n) for n in want["noise"]]
    pre_gate = max(TP_TOL, TP_NOISE * want["prefill_noise"])
    errs, step_errs, f32, failed, own = [], [], [], [], []
    for r in runs:
        if r["coords"]["model"]:
            continue
        dd = r["coords"]["data"]
        sl = slice(dd * rows, (dd + 1) * rows)
        gl = slice(dd * gate_batch // data, (dd + 1) * gate_batch // data)
        errs.append(tp_gate(f"{name} prefill, data rank {dd}", r["prefill"],
                            want["prefill"][dd:dd + 1], pre_gate, failed))
        step_errs.append([
            tp_gate(f"{name} step {i}, data rank {dd}", got, w[sl], tol,
                    failed)
            for i, (got, w, tol) in enumerate(zip(r["steps"], want["steps"],
                                                  gates))])
        f32.append([float((a - b).abs().max() / b.abs().max()) for a, b in
                    ((r["f32"][0], want["f32"][0][dd:dd + 1]),
                     (r["f32"][1], want["f32"][1][gl]))])
        if cfg.moe:      # what the ranks' own bf16 dispatch would have been
            own.append((routed_alike(
                r["prefill_routes"],
                layer_routes(want["prefill_routes"], data),
                slice(dd * prompt, (dd + 1) * prompt)), [
                    routed_alike(mine, layer_routes(theirs, data), sl)
                    for mine, theirs in zip(r["step_routes"],
                                            want["step_routes"])]))
    if cfg.moe:
        flips = [sum(int((~a).sum()) for a in step)
                 for step in zip(*(q for _, q in own))]
        log(f"[tensor ranks] {name}: the MoE dispatch of the bf16 prefill "
            f"and steps forced to the yardstick's; the ranks' own would "
            f"have routed otherwise (experts or kept slots of a MoE layer: "
            f"near ties of the router flipped by the bf16 rounding of "
            f"another sum order) {sum(int((~p).sum()) for p, _ in own)} of "
            f"{data * prompt} prefill tokens (the last: "
            f"{sum(int(~p[-1]) for p, _ in own)} of {data}) and of the "
            f"{batch} rows a step {flips} [{card()}]")
    f32_cfg, _ = tp_f32_cut(cfg, {"moe": {}})
    other = ("bf16 prefill and steps with SDPA against its MLA attention: "
             f"prefill {want['prefill_noise']:.3e} (gate {pre_gate:.3e}), "
             "steps " if cfg.attention == "mla" else
             "bf16 steps with B4 against decode_ref: ")
    pre_tol = MODEL_TOL if cfg.family in MIXER_FAMILIES else DENSE_TOL
    log(f"[tensor ranks] {name}: the yardstick's {other}"
        f"{[float(f'{n:.3e}') for n in want['noise']]}; the "
        f"step gates {[float(f'{g:.3e}') for g in gates]}; f32 compute "
        f"({f32_cfg.n_layers} layers), ranked vs the yardstick: prefill "
        f"{max(e[0] for e in f32):.3e} (tol {pre_tol:.0e}), a step at batch "
        f"{gate_batch} {max(e[1] for e in f32):.3e} (tol {DENSE_TOL:.0e})")
    check(max(e[0] for e in f32) <= pre_tol
          and max(e[1] for e in f32) <= DENSE_TOL,
          f"{name}: f32 ranked vs one process {f32}")
    if cfg.family in STREAM_FAMILIES:
        tp_stream_report(name, cfg, runs, want, failed)
    if cfg.ssm is not None:
        log(f"[tensor ranks] {name}: after the f32 step every rank's conv "
            f"and SSM states vs the yardstick's slices (its heads' x "
            f"channels and its groups' B and C; its SSM heads): "
            f"{tp_state_report(name, cfg, runs, want):.3e} (tol "
            f"{DENSE_TOL:.0e})")
    kept = tp_route_report(name, cfg, runs, want) if cfg.moe else None
    wall = max(r["decode_window"]["wall_ms"] for r in runs) / steps
    pre = max(r["prefill_window"]["wall_ms"] for r in runs)
    frames = (f" after {opts['frames']} encoder frames"
              if opts.get("frames") else "")
    log(f"[tensor ranks] {name}: prefill {data} x {prompt} ({prompt} tokens "
        f"a data rank{frames}) {pre:.1f} ms (yardstick "
        f"{want['prefill_ms']:.1f} ms), decode {wall:.2f} ms a step on the "
        f"slowest rank, "
        f"{batch * 1e3 / wall:.1f} tok/s (yardstick {want['step_ms']:.2f} "
        f"ms); bf16 logits vs the yardstick: prefill {max(errs):.3e} (tol "
        f"{pre_gate:.3e}), steps "
        f"{[float(f'{max(e):.3e}') for e in zip(*step_errs)]}; the ranks' "
        f"peaks {[round(r['peak_gb'], 2) for r in runs]} GB, "
        f"{sum(r['peak_gb'] for r in runs):.2f} GB in all [{card()}]")
    check(not failed, "; ".join(failed))
    return {"prefill": [r["prefill_window"]["launches"] for r in runs],
            "decode": [r["decode_window"]["launches"] for r in runs],
            "prefill_ms": pre, "step_ms": wall, "kept": kept}


def phase_tensor_ranks(dev, prompt=2048, batch=8, steps=8, gate_batch=2,
                       cells=TP_CELLS, twin="yi-6b-d16-tp2-r2") -> dict:
    """The model axis as rank processes that share the card
    (``make_dev_mesh(n, model=, group=)``, ``dist.tensor_parallel``;
    all-reduces and gathers through the device transport): each
    cell's arch at full width (cut in depth where the cell says), bf16
    compute, on its (data, model) mesh of rank processes, each drawing
    only its shard of the seed-0 weights. Per cell, first its yardstick on
    this process (``tp_one_process``: with a data axis, under the logical
    mesh of the same shape, where each data row is routed on its own),
    each freed before the next; then one world of rank processes a world
    size runs its cells in turn (``run_jobs``, ``tp_rank``), so that a
    world starts once: prefill ``data`` x ``prompt`` (a
    row a data rank; n_layers B2 launches per rank, none with MLA),
    ``steps`` serve steps at ``batch`` (``batch / data`` rows a data rank)
    over the seeded cache (n_layers B4 launches a step per rank, none
    with MLA), every B2 and B4 call of a further prefill and step held to
    its plain version on its own operands; the bytes per peer by kind
    against their formula (``tp_reduces``), every rank of a model group's
    gathered logits equal, and each data rank's against the yardstick's
    (``tp_gate``: bf16 at TP_TOL, each step at the larger of TP_TOL and
    TP_NOISE times the yardstick step's own B4-vs-plain gap; the f32
    prefill and a ``gate_batch`` f32 step at DENSE_TOL); for a moe arch one
    MoE layer in f32 on the ranks fed the yardstick's input to it, its
    dispatch bit for bit and its output at DENSE_TOL
    (``tp_route_report``). The ssm, hybrid and encdec cells (mamba2-1.3b
    and zamba2-1.2b on 4 ranks, seamless-m4t-large-v2 on 2 and on 4, where
    its embedding and head split d_model: the embedding's d-slices
    gathered, the head's last-position f32 partials all-reduced,
    ``tp_head_bytes``) prefill the
    cell's own prompt (and frames), launch B3 in every Mamba-2 layer
    (held to ``ssd_chunked_ref`` in the further prefill), seed their
    states, rings and caches layer by layer (``tp_state``), force their
    bf16 calls on the yardstick's Mamba-2 mixer inputs or encoder block
    outputs (``tp_stream_report``), and hold each rank's conv and SSM
    states after the f32 step to the yardstick's slices
    (``tp_state_report``). The worlds exchange through the device
    transport; the ``twin`` cell runs once more in a world of its own on
    gloo, is held to the same gates, and its tokens (every prefill's and
    step's greedy argmax) must equal the device transport's."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="stream-")
    wants, worlds, runs, twins = {}, {}, {}, {}
    try:
        for cell in cells:
            name, arch, layers, (data, model), s_max, opts = cell
            t0 = time.perf_counter()
            cfg = tp_config(arch, layers)
            want = tp_one_process(cfg, dev, s_max, prompt, batch, steps,
                                  gate_batch, data, model, opts)
            attn = (f"MLA over {cfg.n_heads} heads"
                    if cfg.attention == "mla"
                    else f"{cfg.ssm.n_heads(cfg.d_model)} SSM heads in "
                    f"{cfg.ssm.n_groups} group" if cfg.family == "ssm"
                    else f"{cfg.n_heads} q heads over {cfg.n_kv_heads} KV "
                    f"heads, kv_head_pad {kv_head_pad(cfg, model)}")
            if cfg.family == "hybrid":
                attn = (f"{cfg.ssm.n_heads(cfg.d_model)} SSM heads; shared "
                        f"block {attn}, window {cfg.sliding_window}")
            experts = (f", {cfg.moe.n_experts} experts" if cfg.moe else "")
            log(f"[tensor ranks] {name}: {cfg.name} at full width, "
                f"{cfg.n_layers} layers ({attn}{experts}) on a ({data}, "
                f"{model}) mesh of {data * model} rank processes; the "
                "yardstick " + ("under a logical mesh of that shape "
                                if data > 1 else "")
                + f"{time.perf_counter() - t0:.1f} s")
            recorded = None
            if want["stream"]:      # the forced stream, read by every rank
                recorded = os.path.join(tmp, f"{name}.pt")
                torch.save(want.pop("stream"), recorded)
            wants[name] = want
            worlds.setdefault(data * model, []).append((cell, (tp_rank, (
                cell, prompt, batch, steps, gate_batch, want["inputs"],
                want["gate_x"], {"prefill": want["prefill_routes"],
                                 "steps": want["step_routes"]}, recorded),
                {})))
            gc.collect()
            torch.cuda.empty_cache()
        log(f"[tensor ranks] this process holds "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated, "
            f"{torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved as "
            "the ranks start")
        for world, jobs in worlds.items():
            t0 = time.perf_counter()
            got = spawn_ranks(run_jobs, world, [job for _, job in jobs],
                              device=dev, timeout=900)
            runs.update({cell[0]: [r[i] for r in got]
                         for i, (cell, _) in enumerate(jobs)})
            wall = time.perf_counter() - t0
            busy = sum(max(r[i]["job_s"] for r in got)
                       for i in range(len(jobs)))
            log(f"[tensor ranks] {len(jobs)} cells on one world of {world} "
                f"ranks: {wall:.1f} s, of which the cells {busy:.1f} s "
                f"(slowest rank each) and the world's start and end "
                f"{wall - busy:.1f} s")
        for world, jobs in worlds.items():
            for cell, job in jobs:
                if cell[0] != twin:
                    continue
                t0 = time.perf_counter()
                twins[twin] = [r[0] for r in spawn_ranks(
                    run_jobs, world, [job], device=dev, timeout=900,
                    transport="gloo")]
                log(f"[tensor ranks] {twin} once more on gloo, a world of "
                    f"{world} ranks: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {}
    for cell in cells:
        name, arch, layers = cell[:3]
        out[name] = tp_report(name, tp_config(arch, layers), runs[name],
                              wants[name], prompt, batch, steps, gate_batch,
                              cell[5])
        if name in twins:
            tp_twin_report(name, tp_config(arch, layers), runs[name],
                           twins.pop(name), wants[name], prompt, batch,
                           steps, gate_batch, cell[5])
        log(f"[tensor ranks] {name}: the slowest rank's cell "
            f"{max(r['job_s'] for r in runs[name]):.1f} s")
        del runs[name], wants[name]
    log(f"[tensor ranks] phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def tp_twin_report(name: str, cfg, runs, gloo, want: dict, prompt: int,
                   batch: int, steps: int, gate_batch: int, opts: dict
                   ) -> None:
    """Hold a cell's gloo run to the cell's gates, and its tokens (the
    greedy argmax of every rank's gathered prefill and step logits) to the
    device transport's run; print both runs' walls and all-reduce shares
    and whether the logits agree bit for bit (two members' f32 sum is a +
    b on either transport)."""
    tp_report(f"{name} on gloo", cfg, gloo, want, prompt, batch, steps,
              gate_batch, opts, twin=True)
    same_tokens = all(
        torch.equal(a[key].argmax(-1), b[key].argmax(-1))
        for a, b in zip(runs, gloo) for key in ("prefill", "steps"))
    diff = max(float((a[key] - b[key]).abs().max())
               for a, b in zip(runs, gloo) for key in ("prefill", "steps"))
    for label, rs in (("device", runs), ("gloo", gloo)):
        pw = max(rs, key=lambda r: r["prefill_window"]["wall_ms"])
        dw = max(rs, key=lambda r: r["decode_window"]["wall_ms"])
        pre, dec = pw["prefill_window"], dw["decode_window"]
        log(f"[tensor ranks] {name} on the {label} transport: prefill "
            f"{pre['wall_ms']:.1f} ms (all-reduce "
            f"{pre['reduce_ms'] / pre['wall_ms']:.1%} of the slowest "
            f"rank's wall), decode {dec['wall_ms'] / steps:.2f} ms a step "
            f"(all-reduce {dec['reduce_ms'] / dec['wall_ms']:.1%}); "
            f"all-reduce bytes a step to each rank "
            f"{[b // steps for b in dec['bytes']['reduce']]}; staged "
            f"{[r['decode_window']['staged_bytes'] for r in rs]}; mailbox "
            f"{dec['mailbox_bytes'] / 2 ** 20:.0f} MiB [{card()}]")
    log(f"[tensor ranks] {name}: tokens on the device transport equal "
        f"gloo's: {same_tokens}; logits max |device - gloo| {diff:.3e}")
    check(same_tokens, f"{name}: tokens differ between the device "
          "transport and gloo")


# ------------------------------------- training on a model axis of ranks

# (name, arch, layers (0: all; an encdec arch's encoder cut too), (data,
# model), compute dtype, rows a data rank, warm-up steps, timed steps, the
# tokens a row where not the phase's ``seq``, an encdec cell's frames, and
# ``"world"``: the cells of one number and world size run in one world of
# ranks, in their order, after the worlds of lower numbers; by default 0
# for bf16 compute and 1 for f32).
# zamba2-1.2b-d13 keeps 13 of 38 layers, two shared-block sites (after
# layers 6 and 12), and trains in f32: the random-weight Mamba-2 stack
# amplifies bf16 roundings about 1000x (the MODEL_TOL note), past any
# gate a bf16 step could hold. seamless-m4t-large-v2-d6 keeps 6 of 24
# encoder and 6 of 24 decoder layers at full width, 2 048 frames and 512
# tokens a row: its vocabulary of 256 206 does not divide over 4, so the
# embedding and the head split d_model.
TRAIN_TP_CELLS = (
    ("starcoder2-3b-d10-train-tp4-r4", "starcoder2-3b", 10, (1, 4),
     "bfloat16", 1, 1, 1, {}),
    ("starcoder2-3b-d4-train-dp2-tp2-r4", "starcoder2-3b", 4, (2, 2),
     "float32", 1, 1, 1, {}),
    ("grok-1-314b-d2-train-tp4-r4", "grok-1-314b", 2, (1, 4), "bfloat16",
     1, 1, 1, {}),
    ("deepseek-v3-671b-d3-train-tp4-r4", "deepseek-v3-671b", 3, (1, 4),
     "float32", 1, 1, 1, {}),
    ("zamba2-1.2b-d13-train-tp4-r4", "zamba2-1.2b", 13, (1, 4),
     "float32", 1, 1, 1, {"world": 2}),
    ("seamless-m4t-large-v2-d6-train-tp4-r4", "seamless-m4t-large-v2", 6,
     (1, 4), "float32", 1, 1, 1,
     {"seq": 512, "frames": 2048, "world": 2}))
# The ranked step against one process on the same weights and batch. In
# f32 the ranks change only the order of f32 sums (partials over ranks,
# the data group's gradient sum, |g|² per rank, Adafactor's statistics):
# the losses to 1e-5 and |g| to 1e-4 relative, the chip's counterparts of
# the CPU tests' 1e-6 and 1e-5 at full width and 64x the tokens. In bf16
# compute each rank rounds its own products to bf16 (its columns, its
# partial input gradients before their f32 sum), which one process rounds
# once over all columns: the first step's loss to 1e-2 and |g| to 5e-2
# relative.
TP_TRAIN_LOSS_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
TP_TRAIN_NORM_TOL = {"bfloat16": 5e-2, "float32": 1e-4}


def tp_train_config(arch: str, layers: int, compute: str):
    """``arch`` at full width, its first ``layers`` layers (0: all; an
    encdec arch's encoder too), in ``compute``; its own parameter dtype
    and optimizer."""
    return dataclasses.replace(tp_config(arch, layers),
                               compute_dtype=compute)


def tp_train_batch(cfg, rows: int, seq: int, frames: int = 0) -> dict:
    """``SyntheticLM``'s learnable batch 0 of ``rows`` x ``seq`` (on the
    CPU), every fifth label of row 0 masked: data rank 0 keeps fewer labels
    than the others. An encdec batch's frame embeddings are ``frames`` a
    row, seeded."""
    batch = train_batch(cfg, 0, seq, rows, "cpu", seed=0, learnable=True)
    if frames:
        gen = torch.Generator().manual_seed(21)
        batch["enc_embeds"] = torch.randn((rows, frames, cfg.d_model),
                                          generator=gen)
    return batch


def moe_layer_routes(routes: list, cfg) -> list:
    """The forward's recorded dispatch of each MoE layer (one dispatch row:
    the first calls; remat recomputes them in the backward) as (experts,
    kept mask) [T, k] on the host."""
    n = tfm.layer_kinds(cfg).get("moe", 0)
    return [(e.cpu(), k.cpu()) for e, _, k in routes[:n]]


@contextlib.contextmanager
def first_grads(out: dict, module, name: str):
    """The gradients the first call of ``module.name`` (an optimizer update:
    ``optimizer.adafactor_update``, which one process's step takes, or
    ``train_step.ranked_adafactor_update``, the ranked step's) is given
    in the block, copied into ``out["grads"]`` (a tree set aside for
    them, or a clone). A step made in the block binds the wrapper."""
    update = getattr(module, name)

    def keeping(params, grads, state, **kw):
        if not out.get("taken"):
            out["taken"] = True
            if "grads" in out:         # room set aside for them
                for room, g in zip(tree_leaves(out["grads"]),
                                   tree_leaves(grads)):
                    room.copy_(g)
            else:
                out["grads"] = tree_map(torch.clone, grads)
        return update(params, grads, state, **kw)

    setattr(module, name, keeping)
    try:
        yield out
    finally:
        setattr(module, name, update)


def held_room(cfg, dev) -> dict:
    """Room on the card for one process's first-step gradients and its
    parameters after that step (``"grads"``, ``"after"``: trees of views
    of one buffer of the parameters' dtype), allocated before anything
    else: one segment of its own, so that freeing the rest of the step
    gives its memory back to the card while the ranks read the room."""
    like = tfm.abstract_params(cfg)
    sizes = [t.numel() for t in tree_leaves(like)]
    flat = torch.empty(2 * sum(sizes), dtype=tfm.dtype_of(cfg.param_dtype),
                       device=dev)
    parts = iter(flat.split(sizes * 2))
    trees = [unflatten(like, [next(parts).view(t.shape)
                              for t in tree_leaves(like)])
             for _ in range(2)]
    return {"grads": trees[0], "after": trees[1]}


def tp_sum_order_gap(cfg, dev, batch: dict, grads) -> float:
    """The largest gap, over the leaves and two other SSD chunk lengths
    (64 and 256 for 128), of one process's first-step gradient of the
    seed-0 weights on ``batch`` from ``grads`` (its own at the default
    chunk), over the leaf's max|g|: the same f32 function summed in other
    orders (TP_F32_NOISE)."""
    params = tfm.init_params(cfg, seed=0, device=dev)
    gap = 0.0
    for chunk in ("64", "256"):
        with env(REPRO_SSD_CHUNK=chunk):
            _, other = loss_and_grads(cfg, params, batch)
        for (_, g), (_, h) in zip(leaf_paths(grads), leaf_paths(other)):
            gap = max(gap, float((g - h).abs().max())
                      / max(float(g.abs().max()), 1e-30))
        del other
    del params
    torch.cuda.empty_cache()
    return gap


def tp_train_one_process(cfg, dev, batch: dict, warmup: int, steps: int,
                         lr: float, hold: bool = False) -> dict:
    """The one-process ``make_train_step`` from seed 0 on ``batch`` every
    step: losses, |g|, ms a step after ``warmup`` (host clock, synchronised)
    and the peak, and each MoE layer's dispatch in the first step. With
    ``hold``, the first step's gradients (those its optimizer took,
    ``first_grads``) and parameters after it kept on the card under
    ``"held"``, for the ranks to read their boxes of in place (CUDA IPC:
    no copy), and for a model with Mamba-2 layers the gradients' tolerance
    from its own sum-order gap (``tp_sum_order_gap``, ``"noise"``)."""
    t_in = time.perf_counter()
    held = held_room(cfg, dev) if hold else None
    params = tfm.init_params(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg.optimizer)[0](params)
    with first_grads(held, optimizer_mod, f"{cfg.optimizer}_update") \
            if hold else contextlib.nullcontext():
        step_fn = make_train_step(cfg, lr=lr)
    batch = {k: v.to(dev) for k, v in batch.items()}
    losses, norms, routes = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for s in range(warmup + steps):
        if s == warmup:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        with recorded_routes(routes) if s == 0 else contextlib.nullcontext():
            params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if s == 0 and hold:
            for room, p in zip(tree_leaves(held["after"]),
                               tree_leaves(params)):
                room.copy_(p)
    torch.cuda.synchronize(dev)
    out = {"losses": losses, "norms": norms,
           "ms": 1e3 * (time.perf_counter() - t0) / steps,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "routes": moe_layer_routes(routes, cfg), "held": held,
           "noise": None}
    del params, opt
    if hold and cfg.ssm is not None:
        gc.collect()
        torch.cuda.empty_cache()
        out["noise"] = tp_sum_order_gap(cfg, dev, batch, held["grads"])
        held["grad_tol"] = max(TP_GRAD_TOL, TP_F32_NOISE * out["noise"])
    out["s"] = time.perf_counter() - t_in
    gc.collect()
    torch.cuda.empty_cache()
    return out


ADAMW_EPS = 1e-8           # train/optimizer.py's adamw_update
# The f32 cells' gradient boxes against one process's, of the leaf's max.
# On an H100 a sound step of starcoder2-3b-d4 read 7.351e-6 at most
# (embed; read off AdamW's m, 0.1 g), the same to the last digit in each
# of six runs (fixed shapes, seeds, sum orders); the subtlest fault
# planted by ``scripts/torch_train_ranks.py --plant`` (f's sum taken on
# bf16-rounded gradients) reads 2.9e-3.
TP_GRAD_TOL = 1e-5
# A random-weight Mamba-2 stack amplifies a difference in the order of f32
# sums about a thousandfold (the MODEL_TOL note), in the backward too: on
# an H100 one process's first-step gradient of zamba2-1.2b-d13 moved
# 1.13e-4 and 1.69e-4 of a leaf's max when only the SSD's chunk length
# changed (256, 64 for 128: the same function summed in other orders;
# seamless-m4t-large-v2-d6's 3.9e-6 and 4.6e-6 for the attention's KV
# chunk; ``scripts/torch_train_sum_order.py``), past TP_GRAD_TOL. So a cell
# with Mamba-2 layers measures that gap on its yardstick
# (``tp_sum_order_gap``) and holds the ranked gradients to TP_F32_NOISE
# times it where that is larger: the ranks reorder every
# split product's and every collective's sums where a chunk length
# reorders the SSD's alone (the ranked gap sat at 0.73-1.10 times the
# chunks' on the H100, at up to 2.2 times on the CPU's reduced zamba2),
# while a fault moves the gradients by their own size. Its later steps
# start from a first update whose tiny-gradient weights that noise turns
# (AdamW moves each by ±lr): they are reported, and the loss must fall;
# the first step's loss and |g| are held at the f32 tolerances.
TP_F32_NOISE = 4.0


def tp_update_gate(cfg, mesh, grads, params, held: dict, lr: float
                   ) -> dict:
    """This rank's first AdamW step against its boxes of the one-process
    step held on the card (``tp_train_one_process(..., hold=True)``). (a)
    Its gradient of every leaf (``grads``: those the step took) within
    TP_GRAD_TOL of the box's max|g|. (b) Its parameters after the step
    within lr / 1000 of the one-process ones for every weight whose update
    a gradient error within (a) cannot turn by more: AdamW's first step
    moves a weight by lr·g/(|g| + eps), which an error δ turns by up to
    lr·eps·δ/(|g| + eps)², so (b) holds the weights with (|g| + eps)² >=
    1e3·eps·δ, δ = TP_GRAD_TOL·max|g| (and |g| > 1e-5 max|g|, the rule of
    ``tests/test_torch_pipeline_ranks.py``). The weights that rule alone
    would hold that differ by more than lr / 1000 are counted
    (``near_eps``). Where the yardstick measured its own sum-order gap
    (``held["grad_tol"]``, TP_F32_NOISE times it) that is the gradients'
    tolerance in (a) and in δ."""
    boxes = shard_boxes(cfg, tfm.abstract_params(cfg), mesh)
    g1, p1 = dict(leaf_paths(held["grads"])), dict(leaf_paths(held["after"]))
    mine = dict(leaf_paths(grads))
    tol, grad_tol = lr * 1e-3, held.get("grad_tol", TP_GRAD_TOL)
    grad, worst, holds, over = (0.0, ""), (0.0, ""), 0, 0
    for name, p in leaf_paths(params):
        w, want = (take_box(p1[name], boxes[name]),
                   take_box(g1[name], boxes[name]))
        top = float(want.abs().max())
        grad = max(grad, (float((mine[name] - want).abs().max())
                          / max(top, 1e-30), name))
        g = want.abs()
        moved = g > 1e-5 * g.max()
        diff = (p - w).abs()
        over += int(((diff > tol) & moved).sum())
        sure = moved & ((g + ADAMW_EPS) ** 2
                        >= 1e3 * ADAMW_EPS * grad_tol * g.max())
        holds += int(sure.sum())
        if sure.any():
            worst = max(worst, (float((diff * sure).max()), name))
    return {"grad_err": grad[0], "grad_leaf": grad[1], "err": worst[0],
            "leaf": worst[1], "held": holds, "near_eps": over, "tol": tol,
            "grad_tol": grad_tol}


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 above |t| (t in bf16; 8 significant bits), in
    f32: 2^(e - 8) for |t| = m·2^e, m in [0.5, 1); bf16's least
    subnormal for 0."""
    _, e = torch.frexp(t.float())
    return torch.where(t == 0, torch.tensor(2.0 ** -133, device=t.device),
                       torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                   e - 8))


# The ranked Adafactor fed one process's gradient boxes, against one
# process's update, bf16 parameters: one bf16 rounding of the result, plus
# TP_STATS_TOL of the step's size |p1 - p0| for the f32 statistics (rows'
# and columns' means of g², the clip) that the ranks sum in another
# order. One ulp alone does not hold where p0 ≈ lr·u: p1 is tiny, and so
# is its ulp. The step's own update, from the ranks' own bf16 gradients
# (of which some lie one ulp off, gate (a)), moves each weight's u by its
# gradient's change and every weight's by the statistics over those: it
# is reported, not gated.
TP_STATS_TOL = 1e-5


def tp_bf16_gate(cfg, mesh, grads, before, params, held: dict,
                 lr: float) -> dict:
    """This rank's first step against its boxes of the one-process step
    held on the card (``tp_train_one_process(..., hold=True)``), for bf16
    parameters, whose gradients are bf16 too: each rounds an f32 sum that
    the ranks form in another order, so an element may land one bf16 ulp
    away. (a) Each gradient element (``grads``: those of the step)
    within max(one bf16 ulp of it, TP_GRAD_TOL of its leaf's max|g|) of one
    process's; the elements not bit for bit are counted. (b) The ranked
    Adafactor (``ranked_adafactor_update``) fed one process's gradient
    boxes from the weights before the step (``before``) gives each weight
    within one bf16 ulp of one process's update plus TP_STATS_TOL of the
    step |p1 - p0|. The step's own weights (``params``) are reported: how
    many lie past one ulp, and the largest excess over it in units of the
    step, where the gradient element is the same and where it differs."""
    boxes = shard_boxes(cfg, tfm.abstract_params(cfg), mesh)
    g1 = {name: leaf[boxes[name]] for name, leaf in leaf_paths(held["grads"])}
    p1 = dict(leaf_paths(held["after"]))
    mine, p0 = dict(leaf_paths(grads)), dict(leaf_paths(before))
    fed = tree_map(torch.clone, before)
    ranked_adafactor_update(
        fed, unflatten(before, [g1[name] for name, _ in leaf_paths(before)]),
        adafactor_init(fed), shards=adafactor_shards(cfg, mesh), lr=lr,
        reduce=lambda t: mesh.transport.all_reduce(t, mesh.groups["model"],
                                                   "adafactor"))
    fed = dict(leaf_paths(fed))
    out = {"grad_err": (0.0, ""), "grad_over": 0, "grad_flips": 0,
           "update_over": 0, "fed_excess": 0.0, "fed_past_ulp": 0,
           "past_ulp": 0, "excess_same": 0.0, "excess_other": 0.0,
           "weights": 0}
    for name, p in leaf_paths(params):
        g, w = mine[name], g1[name]
        want = p1[name][boxes[name]]
        top = float(w.abs().max())
        worst = 0.0
        # in pieces of rows: a rank's f32 temporaries stay small
        rows = max(1, (1 << 24) // max(1, p[0].numel())) if p.dim() else 1
        for i in range(0, max(1, p.shape[0] if p.dim() else 1), rows):
            part = (slice(i, i + rows),) if p.dim() else ()
            gi, wi = g[part], w[part]
            diff = (gi.float() - wi.float()).abs()
            worst = max(worst, float(diff.max()))
            over = diff > torch.clamp(bf16_ulp(wi), min=TP_GRAD_TOL * top)
            out["grad_over"] += int(over.sum())
            for j in over.nonzero()[:4].tolist():     # the first few, shown
                at = (i + j[0], *j[1:]) if p.dim() else ()
                out.setdefault("over_at", []).append(
                    (name, at, float(wi[tuple(j)]), float(gi[tuple(j)]),
                     float(bf16_ulp(wi[tuple(j)])), TP_GRAD_TOL * top))
            same = gi == wi
            out["grad_flips"] += int((~same).sum())
            wp = want[part]
            ulp = bf16_ulp(wp)
            step = (wp.float() - p0[name][part].float()).abs()
            off = (fed[name][part].float() - wp.float()).abs() - ulp
            out["fed_past_ulp"] += int((off > 0).sum())
            out["update_over"] += int((off > TP_STATS_TOL * step).sum())
            out["fed_excess"] = max(out["fed_excess"], float(torch.where(
                off > 0, off / step, 0.0).max()))
            off = (p[part].float() - wp.float()).abs() - ulp
            out["past_ulp"] += int((off > 0).sum())
            excess = torch.where(off > 0, off / step, 0.0)
            for key, mask in (("excess_same", same), ("excess_other",
                                                      ~same)):
                if mask.any():
                    out[key] = max(out[key], float((excess * mask).max()))
        out["grad_err"] = max(out["grad_err"], (worst / max(top, 1e-30),
                                                name))
        out["weights"] += p.numel()
    return out


def tp_replicas_equal(cfg, mesh, params) -> tuple:
    """(whether every rank of this rank's model line that holds the same
    box of a leaf, or the same column piece of a Mamba-2 leaf, holds the
    same bits, the leaves compared): each leaf that several ranks of a
    line hold (the KV heads of ``kv_head_pad``, the replicated norms, the
    router, MLA's down-projections) gathered over the model group, and
    each Mamba-2 leaf whose B and C columns several hold
    (``column_holders``), each holder's piece against this rank's."""
    like = tfm.abstract_params(cfg)
    n = mesh.shape["model"]
    shared = sorted({name for c in range(n)
                     for name, h in box_holders(cfg, like, mesh, c).items()
                     if len(h) > 1})
    mine = box_holders(cfg, like, mesh)
    own = dict(leaf_paths(params))
    same = True
    for name in shared:
        parts = mesh.transport.all_gather(own[name], mesh.groups["model"])
        same &= all(torch.equal(parts[c], own[name]) for c in mine[name])
    pieces = [column_holders(cfg, like, mesh, c) for c in range(n)]
    columns = sorted({name for held in pieces for name, p in held.items()
                      if any(len(h) > 1 for _, _, h in p)})
    boxes = [shard_boxes(cfg, like, mesh, c) for c in range(n)]
    me = mesh.coords["model"]

    def at(c, name):      # (whole leaf's columns, rank c's columns) a piece
        return [(box[-1], lo, hi) for box, (lo, hi, _) in
                zip(boxes[c][name], pieces[c][name])]

    for name in columns:
        parts = mesh.transport.all_gather(own[name], mesh.groups["model"])
        for c in range(n):
            for cols, lo, hi in at(me, name):
                for other, a, b in at(c, name):
                    if other == cols:
                        same &= torch.equal(parts[c][..., a:b],
                                            own[name][..., lo:hi])
    return same, shared + columns


def tp_train_rank(rank, world, cell, batch, lr, held, *, device):
    """One rank of a ranked train cell (a job of ``run_jobs``: the
    world's cells run in turn): its shard of the seed-0 weights
    (``init_shard_params``) and of the optimizer's state,
    ``make_train_step(cfg, mesh=)`` on ``batch`` (the global batch) every
    step, each MoE layer's dispatch in the first; the first step against
    the one-process one where ``held`` (its gradients and update, on the
    card) is given, with the gradients the ranked optimizer took in it
    (``first_grads``); the timed steps between barriers
    (``rank_window``): the wall, the all-reduce, gather and busy ms, the
    bytes sent each peer by kind, the kernels launched, the peak; then the
    replicas compared bit for bit."""
    name, arch, layers, (data, model), compute, rows, warmup, steps = cell[:8]
    dev = torch.device(device)
    t_in = time.perf_counter()
    gc.collect()              # the world's cell before this one
    torch.cuda.empty_cache()
    cfg = tp_train_config(arch, layers, compute)
    mesh = make_dev_mesh(world, model, dev,
                         group=torch.distributed.group.WORLD)
    params = init_shard_params(cfg, mesh, seed=0, device=dev)
    opt = make_optimizer(cfg.optimizer)[0](params)
    mine = {}
    ranked = ((train_step_mod, "ranked_adafactor_update")
              if cfg.optimizer == "adafactor"
              else (optimizer_mod, f"{cfg.optimizer}_update"))
    with first_grads(mine, *ranked) if held is not None \
            else contextlib.nullcontext():
        step_fn = make_train_step(cfg, lr=lr, mesh=mesh)
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.cuda.empty_cache()
    t_ready = time.perf_counter()
    before = (tree_map(torch.clone, params) if held is not None
              and cfg.optimizer == "adafactor" else None)
    losses, norms, update, gate_s, routes = [], [], None, 0.0, []
    for s in range(warmup + steps):
        if s == warmup:
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = rank_window(mesh, dev)
        with recorded_routes(routes) if s == 0 else contextlib.nullcontext():
            params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if s == 0 and held is not None:
            t_gate = time.perf_counter()
            update = (tp_bf16_gate(cfg, mesh, mine.pop("grads"), before,
                                   params, held, lr) if before is not None
                      else tp_update_gate(cfg, mesh, mine.pop("grads"),
                                          params, held, lr))
            before = held = None
            gate_s = time.perf_counter() - t_gate
    out = rank_window_end(mesh, dev, t0)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    net = mesh.transport
    same, shared = tp_replicas_equal(cfg, mesh, params)
    return {**out, "coords": mesh.coords, "losses": losses, "norms": norms,
            "steps": steps, "update": update, "peak_gb": peak,
            "setup_s": t_ready - t_in, "gate_s": gate_s,
            "warmup_s": t0 - t_ready - gate_s,
            "job_s": time.perf_counter() - t_in,
            "reduce_ms": sum(net.ms.get(k, 0.0) for k in (
                "reduce", "grad", "replica", "adafactor", "scalar")),
            "gather_ms": net.ms["gather"], "replicas_equal": same,
            "shared": shared, "routes": moe_layer_routes(routes, cfg)}


def tp_train_reduces(cfg, tokens: int, frames: int, model: int) -> int:
    """The f32 bytes a rank all-reduces with each peer of its model line
    in one ranked train step of ``tokens`` decoder tokens (``frames``
    encoder frames), remat full, which stops recomputing a block at the
    last tensor its backward saved (before the FFN's, the experts' or a
    Mamba-2 ``w_out``'s sum). In units of [tokens, d_model]: a
    vocab-sharded embedding's sum and head's f; per attention layer its
    ``wo`` sum twice (the forward and the recomputed block) and its f once
    (GQA: the input; MLA: the latents q_lat, ckv and k_rope, narrower);
    the dense FFN's sum and f, or the MoE's stacked sum (the combine, and
    the shared experts' partial beside it) and f; per Mamba-2 layer its
    ``w_out`` sum and f, and its gated norm's [tokens, 1] sum of squares
    three times (the forward, the recomputed block, and the backward's
    sum); the hybrid's shared block as an attention layer at each site; an
    encdec decoder layer's self and cross ``wo`` twice, their query f's
    and the FFN's sum and f, each at [frames, d_model] the encoder's
    layers' (an attention layer and an FFN) and the f of every decoder
    layer's cross keys and values. A d_model-split head's f32 partials
    [tokens, V] once."""
    d = cfg.d_model
    if cfg.family == "encdec":
        units = 8 * cfg.n_layers * tokens + (
            5 * cfg.encoder_layers + cfg.n_layers) * frames
        squares = 0
    elif cfg.ssm is not None:
        units = (2 * cfg.n_layers + 5 * tp_kernels(cfg)[0]) * tokens
        squares = 3 * cfg.n_layers * tokens
    else:
        if cfg.attention == "mla":
            m = cfg.mla
            attn = 2 + (m.q_lora_rank + m.kv_lora_rank + m.qk_rope_dim) \
                / cfg.d_model
        else:
            attn = 3
        ffn = {"dense": 2,
               "moe": 2 + bool(cfg.moe and cfg.moe.n_shared_experts)}
        units = tokens * sum(depth * (attn + ffn[seg])
                             for seg, depth in tfm.layer_kinds(cfg).items())
        squares = 0
    if vocab_sharded(cfg, model):
        units += 2 * tokens
        head = 0
    else:
        head = 4 * tokens * cfg.vocab_size
    return round(4 * d * units) + 4 * squares + head


def tp_adafactor_bytes(cfg, mesh) -> tuple:
    """(the bytes of the ranked Adafactor's all-reduces of more than one
    element in one step, the number of one element): for each leaf of the
    rank's shard that its box splits, the row sums of g² where its last
    dim splits, the column sums and the rows' ``vr`` sums where its second
    last does, and the clip sums, one a layer slice; f32."""
    shard = dict(leaf_paths(shard_tree(cfg, tfm.abstract_params(cfg),
                                       mesh)))
    total, scalars = 0, 0
    for name, sh in adafactor_shards(cfg, mesh).items():
        if not sh.split:
            continue
        p = shard[name]
        if p.dim() >= 2 and p.dim() - 1 in sh.split:
            total += p.numel() // p.shape[-1]
        if p.dim() >= 2 and p.dim() - 2 in sh.split:
            total += p.numel() // p.shape[-2] + p.numel() // (
                p.shape[-1] * p.shape[-2])
        clips = p.shape[0] if p.dim() >= 3 else 1
        total, scalars = (total + clips, scalars) if clips > 1 else (
            total, scalars + 1)
    return 4 * total, scalars


def tp_train_bytes(cfg, coords: dict, mesh_shape, rows: int, seq: int,
                   runs, frames: int = 0) -> dict:
    """The bytes the rank at ``coords`` sends each peer in one ranked train
    step, by kind: to each other rank of its model line (``reduce``) the
    f32 all-reduces of ``tp_train_reduces``; in the compute dtype
    (``gather``) its logits [rows·seq, V / model], or where the head
    splits d_model the embedding's [rows·seq, d_model / model] and the
    head input's gradient of that size; with Adafactor its statistics
    (``adafactor``, ``tp_adafactor_bytes``); to the other holders of a box
    of the sharded region (a KV head, the router and its bias) or of a
    Mamba-2 column piece (the B and C of a shared group) its gradient in
    f32 (``replica``); to its data peer every gradient of its shard in f32
    (``grad``); |g|² and Adafactor's one-element clip sums to the model
    peers and the loss to the data peer (``scalar``)."""
    data, model = mesh_shape
    at = {tuple(r["coords"].values()): i for i, r in enumerate(runs)}
    d, c = coords["data"], coords["model"]
    t = rows * seq
    mesh = SimpleNamespace(shape={"data": data, "model": model},
                           coords=coords)
    shard = dict(leaf_paths(shard_tree(cfg, tfm.abstract_params(cfg),
                                       mesh)))
    want = {k: [0] * len(runs) for k in ("p2p", "reduce", "gather",
                                         "scalar")}
    factor, clips = (tp_adafactor_bytes(cfg, mesh)
                     if cfg.optimizer == "adafactor" else (0, 0))
    size = tfm.dtype_of(cfg.compute_dtype).itemsize
    for m in range(model):
        if m != c:
            p = at[(d, m)]
            want["reduce"][p] = tp_train_reduces(cfg, t, rows * frames,
                                                 model)
            want["gather"][p] = (t * cfg.vocab_size // model * size
                                 if vocab_sharded(cfg, model)
                                 else 2 * t * cfg.d_model // model * size)
            want["scalar"][p] = 4 * (1 + clips)
            if factor:
                want.setdefault("adafactor", [0] * len(runs))[p] = factor
    for name, holders in replica_leaves(cfg, mesh).items():
        for m in holders:
            if m != c:
                want.setdefault("replica", [0] * len(runs))
                want["replica"][at[(d, m)]] += shard[name].numel() * 4
    for name, pieces in replica_columns(cfg, mesh).items():
        leaf = shard[name]
        for lo, hi, holders in pieces:
            for m in holders:
                if m != c:
                    want.setdefault("replica", [0] * len(runs))
                    want["replica"][at[(d, m)]] += \
                        leaf.numel() // leaf.shape[-1] * (hi - lo) * 4
    for e in range(data):
        if e != d:
            want.setdefault("grad", [0] * len(runs))[at[(e, c)]] = sum(
                t.numel() * 4 for t in shard.values())
            want["scalar"][at[(e, c)]] = 4
    return want


def phase_train_ranks(dev, cells=TRAIN_TP_CELLS, seq=2048, lr=3e-4) -> dict:
    """Training with a model axis on rank processes that share the card
    (``make_train_step(cfg, mesh=)`` on ``make_dev_mesh(n, model,
    group=)``; ``dist.tensor_parallel``'s collectives with their backward,
    through the device transport). Each cell trains its arch at
    full width (cut in depth where the cell says) with its own parameter
    dtype and optimizer (starcoder2-3b, zamba2-1.2b, seamless-m4t-large-v2:
    f32 and AdamW; grok-1-314b and deepseek-v3-671b: bf16 and Adafactor),
    remat full, on ``SyntheticLM``'s
    learnable batch 0 of ``data`` x ``rows`` x ``seq`` every step (one
    batch, so that the loss must fall), each rank drawing only its shard of
    the seed-0 weights and holding only its shard of the optimizer's state.
    One world of ranks a world size runs the cells in turn, after their
    yardsticks (the one-process step on the same weights and batch, each
    freed before the next but for what an f32 cell's gate reads on the
    card: its first step's gradients and update, held through CUDA IPC, no
    copy). deepseek-v3-671b-d3 and starcoder2-3b-d4 (f32) get a world of
    their own, after, so that what they hold (14.4 GB, 5.6 GB) never
    shares the card with grok-1-314b-d2's ranks (4 x 13 GB) or yardstick
    (71.9 GB); zamba2-1.2b-d13 and seamless-m4t-large-v2-d6 (f32, 8.6 GB
    held in all) in one more, last: beside deepseek-d3's ranks or grok-d2's
    their holds left no room on the card. Each cell:
    ``warmup`` steps, then ``steps`` timed between barriers. Gates: no B1-B4 launch in a step on any rank;
    the first step's loss and |g| against one process's (TP_TRAIN_LOSS_TOL,
    TP_TRAIN_NORM_TOL; in f32 without Mamba-2 layers every step's); the
    loss falling from step to step; the bytes each rank sends each peer by
    kind equal their formula (``tp_train_bytes``); the ranks that hold the
    same box of a leaf, or the same column piece of a Mamba-2 leaf, hold
    the same bits after the steps (``tp_replicas_equal``); in f32 the first
    step held to the one-process step's boxes (``tp_update_gate`` with
    AdamW, with Mamba-2 layers at TP_F32_NOISE times the yardstick's own
    sum-order gap where that is larger; ``tp_bf16_gate`` with Adafactor's
    bf16 parameters). Reports per
    cell ms a step (slowest rank) and tok/s beside one process's, per rank
    its all-reduce and gather ms and share of the wall, busy ms and peak,
    and for the moe cells the MoE slots each rank routed otherwise than one
    process in the first step."""
    t_phase = time.perf_counter()
    ones, runs, worlds = {}, {}, {}
    for cell in cells:      # a world a size; the f32 cells' apart, after
        (data, model), compute = cell[3], cell[4]
        worlds.setdefault((cell[8].get("world", int(compute == "float32")),
                           data * model), []).append(cell)
    try:
        for (_, world), group in sorted(worlds.items()):
            jobs = []
            for cell in group:
                name, arch, layers, (data, model), compute = cell[:5]
                rows, warmup, steps, opts = cell[5:]
                hold = compute == "float32"
                t0 = time.perf_counter()
                cfg = tp_train_config(arch, layers, compute)
                batch = tp_train_batch(cfg, data * rows, opts.get("seq", seq),
                                       opts.get("frames", 0))
                ones[name] = tp_train_one_process(cfg, dev, batch, warmup,
                                                  steps, lr, hold)
                log(f"[train ranks] {name}: {cfg.name} at full width, "
                    f"{cfg.n_layers} layers, {cfg.param_dtype} parameters, "
                    f"{cfg.optimizer}, {compute} compute, on a ({data}, "
                    f"{model}) mesh of {data * model} rank processes, "
                    f"kv_head_pad {kv_head_pad(cfg, model)}; the yardstick "
                    f"{time.perf_counter() - t0:.1f} s, peak "
                    f"{ones[name]['peak_gb']:.2f} GB")
                jobs.append((tp_train_rank, (cell, batch, lr,
                                             ones[name]["held"]), {}))
            log(f"[train ranks] this process holds "
                f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
                f"({torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved) "
                "as the ranks start")
            t0 = time.perf_counter()
            got = spawn_ranks(run_jobs, world, jobs, device=dev, timeout=900)
            jobs.clear()
            for i, cell in enumerate(group):
                runs[cell[0]] = [r[i] for r in got]
                ones[cell[0]]["held"] = None
            wall = time.perf_counter() - t0
            busy = sum(max(r[i]["job_s"] for r in got)
                       for i in range(len(group)))
            log(f"[train ranks] {len(group)} cells on one world of {world} "
                f"ranks: {wall:.1f} s, of which the cells {busy:.1f} s "
                f"(slowest rank each) and the world's start and end "
                f"{wall - busy:.1f} s")
    finally:
        for one in ones.values():
            one["held"] = None
        gc.collect()
        torch.cuda.empty_cache()
    out = {}
    for cell in cells:
        cfg = tp_train_config(*cell[1:3], cell[4])
        out[cell[0]] = tp_train_report(cell[0], cfg, cell, runs[cell[0]],
                                       ones[cell[0]], seq)
    log(f"[train ranks] phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def tp_route_flips(runs, one: dict) -> list:
    """Per rank, per MoE layer: the slots [T, k] whose expert or kept flag
    differs from one process's in the first step's forward."""
    return [[int(((e != e1) | (k != k1)).sum())
             for (e, k), (e1, k1) in zip(r["routes"], one["routes"])]
            for r in runs]


def tp_train_report(name: str, cfg, cell, runs, one: dict, seq: int
                    ) -> dict:
    """Print a ranked train cell's numbers and hold its gates
    (``phase_train_ranks``); returns each rank's launches, ms a step (the
    slowest rank's) beside one process's, each rank's peak and all-reduce
    share of its wall."""
    _, _, _, (data, model), compute, rows, warmup, steps, opts = cell
    seq, frames = opts.get("seq", seq), opts.get("frames", 0)
    tokens = data * rows * seq
    wall = max(r["wall_ms"] for r in runs) / steps
    check_transport(name, runs)
    log(f"[train ranks] {name}: {wall:.1f} ms a step (host clock between "
        f"barriers, slowest rank, {steps} steps after {warmup}), "
        f"{tokens / wall * 1e3:.0f} tok/s; one process {one['ms']:.1f} ms, "
        f"{tokens / one['ms'] * 1e3:.0f} tok/s; the ranks' peaks "
        f"{[round(r['peak_gb'], 2) for r in runs]} GB, "
        f"{sum(r['peak_gb'] for r in runs):.2f} GB in all [{card()}]")
    log(f"[train ranks]   losses {runs[0]['losses']} vs one process "
        f"{one['losses']}; |g| {runs[0]['norms']} vs {one['norms']}")
    if one["routes"]:
        log(f"[train ranks]   MoE slots [T, k] routed otherwise than one "
            f"process in the first step, per rank per layer: "
            f"{tp_route_flips(runs, one)} of {one['routes'][0][0].numel()}"
            " a layer")
    slow = max(runs, key=lambda r: r["job_s"])
    log(f"[train ranks]   slowest rank's {slow['job_s']:.1f} s: set-up "
        f"(weights, optimizer state) {slow['setup_s']:.1f} s, warm-up "
        f"{slow['warmup_s']:.1f} s, first-step gate {slow['gate_s']:.1f} "
        f"s, timed steps {slow['wall_ms'] / 1e3:.1f} s; the yardstick "
        f"{one['s']:.1f} s")
    failed = []
    loss_tol, norm_tol = TP_TRAIN_LOSS_TOL[compute], TP_TRAIN_NORM_TOL[compute]
    gated = (len(one["losses"]) if compute == "float32"
             and one["noise"] is None else 1)
    if one["noise"] is not None:
        log(f"[train ranks]   one process's first-step gradient at SSD "
            f"chunks 64 and 256 vs 128: {one['noise']:.3e} of a leaf's max "
            f"(the f32 sum-order gap; the ranks' gradient tolerance "
            f"max({TP_GRAD_TOL:.0e}, {TP_F32_NOISE:g} x gap)); losses and "
            "|g| held at the first step, the later steps reported "
            f"[{card()}]")
    for r in runs:
        n = r["steps"]
        per = {k: [b // n for b in v] for k, v in r["bytes"].items()}
        want = tp_train_bytes(cfg, r["coords"], (data, model), rows, seq,
                              runs, frames)
        log(f"[train ranks]   rank {r['coords']}: peak {r['peak_gb']:.2f} "
            f"GB; all-reduces {r['reduce_ms'] / n:.1f} ms a step "
            f"({r['reduce_ms'] / r['wall_ms']:.1%} of its wall), gathers "
            f"{r['gather_ms'] / n:.1f} ms ({r['gather_ms'] / r['wall_ms']:.1%}"
            f"), busy {r['busy_ms'] / n:.1f} ms a step (CUDA events between "
            f"exchanges); bytes a step to each peer {per} (formula {want}); "
            f"kernel launches {r['launches']}; replicas of "
            f"{len(r['shared'])} leaves bit for bit: {r['replicas_equal']}")
        u = r["update"]
        if u is not None and "grad_flips" in u:
            log(f"[train ranks]   rank {r['coords']}: first step against "
                f"one process's boxes: gradients within "
                f"{u['grad_err'][0]:.3e} of a leaf's max "
                f"({u['grad_err'][1]}), {u['grad_over']} elements past "
                f"max(one bf16 ulp, {TP_GRAD_TOL:.0e} of the leaf's max), "
                f"{u['grad_flips']} of {u['weights']} not bit for bit; "
                f"Adafactor fed one process's gradients: {u['fed_past_ulp']}"
                f" weights past one bf16 ulp of its update, the largest "
                f"excess {u['fed_excess']:.3e} of the step's size (tol "
                f"{TP_STATS_TOL:.0e}), {u['update_over']} past it; the "
                f"step's own update: {u['past_ulp']} weights past one ulp, "
                f"the largest excess {u['excess_same']:.3e} of the step "
                f"where the gradient element is the same, "
                f"{u['excess_other']:.3e} where it differs")
            if u["grad_over"] or u["update_over"]:
                failed.append(f"{name}: rank {r['coords']} first step {u}")
        elif u is not None:
            log(f"[train ranks]   rank {r['coords']}: first step against "
                f"one process's boxes: gradients within {u['grad_err']:.3e}"
                f" of a leaf's max ({u['grad_leaf']}; tol {u['grad_tol']:.3e})"
                f"; update worst {u['err']:.3e} ({u['leaf']}; tol "
                f"{u['tol']:.0e}) over the {u['held']} weights it cannot "
                f"turn; {u['near_eps']} weights the 1e-5-of-max rule alone "
                f"holds differ by more")
            if u["err"] > u["tol"] or u["grad_err"] > u["grad_tol"]:
                failed.append(f"{name}: rank {r['coords']} first step {u}")
        if any(r["launches"].values()):
            failed.append(f"{name}: rank {r['coords']} launched "
                          f"{r['launches']} in a step")
        for i in range(gated):
            if abs(r["losses"][i] - one["losses"][i]) > loss_tol \
                    * abs(one["losses"][i]) or abs(
                        r["norms"][i] - one["norms"][i]) > norm_tol \
                    * one["norms"][i]:
                failed.append(f"{name}: rank {r['coords']} step {i} loss "
                              f"{r['losses'][i]} |g| {r['norms'][i]} vs one "
                              f"process {one['losses'][i]} "
                              f"{one['norms'][i]}")
        if not all(a > b for a, b in zip(r["losses"], r["losses"][1:])):
            failed.append(f"{name}: rank {r['coords']} losses "
                          f"{r['losses']} do not fall")
        if per != want or any(b % n for v in r["bytes"].values()
                              for b in v):
            failed.append(f"{name}: rank {r['coords']} bytes {per} a step, "
                          f"formula {want}")
        if not r["replicas_equal"]:
            failed.append(f"{name}: rank {r['coords']} replicas differ")
    check(not failed, "; ".join(failed))
    return {"launches": [r["launches"] for r in runs], "ms": wall,
            "one_ms": one["ms"], "peak_gb": [r["peak_gb"] for r in runs],
            "reduce_share": [r["reduce_ms"] / r["wall_ms"] for r in runs]}


ELASTIC_CELL = "starcoder2-3b-d2-train-dp2-tp2-r4-elastic"


def launcher_run(argv, **kwargs):
    """``launch.train.main(argv, **kwargs)`` with its and its rank
    processes' standard output caught: (its lines, its return)."""
    from repro_torch.launch import train as train_launcher

    with tempfile.TemporaryFile("w+") as out:
        saved = os.dup(1)
        sys.stdout.flush()
        os.dup2(out.fileno(), 1)             # the rank processes' prints
        try:
            with contextlib.redirect_stdout(out):        # the launcher's
                got = train_launcher.main(argv, **kwargs)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        out.seek(0)
        return out.read().splitlines(), got


def phase_elastic_ranks(dev, layers=2, rows=1, seq=2048, steps=5, every=2,
                        kill=(1, 2), lease=1) -> dict:
    """Elastic training on rank processes (``launch.train --ranks
    --elastic``), through the launcher's entry point: starcoder2-3b at full
    width cut to ``layers`` layers, f32 parameters and compute, AdamW,
    remat full, on 4 rank processes that share the card as 2 fake hosts of
    2 (a (2, 2) mesh), ``rows`` x ``seq`` tokens a data rank,
    ``--kill-host`` host ``kill[0]`` from step ``kill[1]`` with a lease of
    ``lease`` steps and a checkpoint every ``every`` steps. Host 1's last
    beat is step 1, the poll of step 3 declares it, and a world of 2 ranks
    on (1, 2) restores step 2 and runs steps 3 and 4. Gates: the
    launcher's lines, exactly; the survivors' step 3 against the lost
    world's step 3, which ran from the same state on the same batch (loss
    and |g| within TP_TRAIN_LOSS_TOL and TP_TRAIN_NORM_TOL of f32); no
    B1-B4 launch on any rank. Prints each world's spawn (the launcher's
    call to the ranks' start), the restore, the first resumed step, the
    time to recover (from the plan to the end of that step) and the
    checkpoints' size and seconds."""
    t_phase = time.perf_counter()
    cfg = tp_train_config("starcoder2-3b", layers, "float32")
    where = torch.cuda.get_device_name(dev)
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", cfg.name, "--device", dev.type, "--ranks",
                "--host-devices", "4", "--elastic", "--fake-hosts", "2",
                "--kill-host", f"{kill[0]}@{kill[1]}", "--lease", str(lease),
                "--steps", str(steps), "--ckpt-every", str(every),
                "--global-batch", str(2 * rows), "--seq", str(seq),
                "--ckpt-dir", d]
        lines, worlds = launcher_run(argv, cfg=cfg)
        gb = sum(os.path.getsize(os.path.join(root, f))
                 for root, _, files in os.walk(
                     os.path.join(d, f"step_{steps - 1:08d}"))
                 for f in files) / 1e9
    for line in lines:
        log(f"[elastic ranks] | {line}")
    head = (f"arch={cfg.name} ({cfg.n_params() / 1e9:.2f}B params), "
            f"seq={seq} batch={2 * rows}")
    # the first poll past the lease declares the host; it restores the
    # latest checkpoint by then
    restore = (kill[1] + lease) // every * every
    survivor = 1 - kill[0]
    want = [f"mesh: {{'data': 2, 'model': 2}} on 4 rank processes "
            f"({where}), {head}",
            f"host failure: survivors [{survivor}], re-mesh (1, 2), "
            f"restore step {restore}",
            f"mesh: {{'data': 1, 'model': 2}} on 2 rank processes "
            f"({where}), {head}",
            f"elastic restore from step {restore} (resuming at step "
            f"{restore + 1})", "done"]
    got = [ln for ln in lines if not ln.startswith("step ")]
    check(got == want, f"{ELASTIC_CELL}: the launcher's lines {got}, "
          f"want {want}")
    lost, kept = worlds
    check(not lost["died"] and lost["plan"].survivors == [survivor]
          and len(kept["ranks"]) == 2 and kept["plan"] is None,
          f"{ELASTIC_CELL}: worlds {[(w['died'], w['plan']) for w in worlds]}")
    first = restore + 1
    a, b = lost["ranks"][0]["steps"][first], kept["ranks"][0]["steps"][first]
    loss_err = abs(b["loss"] - a["loss"]) / a["loss"]
    norm_err = abs(b["grad_norm"] - a["grad_norm"]) / a["grad_norm"]
    log(f"[elastic ranks] {ELASTIC_CELL}: step {first} on (1, 2) loss "
        f"{b['loss']:.6f} |g| {b['grad_norm']:.6f} against the lost (2, 2) "
        f"world's {a['loss']:.6f} {a['grad_norm']:.6f}: {loss_err:.3e} and "
        f"{norm_err:.3e} relative")
    check(loss_err <= TP_TRAIN_LOSS_TOL["float32"]
          and norm_err <= TP_TRAIN_NORM_TOL["float32"],
          f"{ELASTIC_CELL}: the survivors' step {first} off the lost "
          f"world's: loss {loss_err:.3e}, |g| {norm_err:.3e}")
    launches = [[r["launches"] for r in w["ranks"]] for w in worlds]
    check(not any(n for w in launches for r in w for n in r.values()),
          f"{ELASTIC_CELL}: kernels launched in a train step: {launches}")
    for i, w in enumerate(worlds):
        check_transport(f"{ELASTIC_CELL} world {i}", w["ranks"])
    for i, w in enumerate(worlds):
        spawn = max(r["t_start"] for r in w["ranks"]) - w["t_spawn"]
        ms = [round(max(r["steps"][s]["ms"] for r in w["ranks"]), 1)
              for s in sorted(w["ranks"][0]["steps"])]
        saves = {s: round(max(r["save_s"][s] for r in w["ranks"]), 2)
                 for s in sorted(w["ranks"][0]["save_s"])}
        log(f"[elastic ranks] world {i}: {len(w['ranks'])} ranks on "
            f"{card()}; spawn {spawn:.1f} s (the call to the ranks' start), "
            f"{w['t_end'] - w['t_spawn']:.1f} s in all; ms a step "
            f"(slowest rank) {ms}; checkpoint s by step {saves}")
    restore_s = max(r["restore_s"] for r in kept["ranks"])
    first_ms = max(r["steps"][first]["ms"] for r in kept["ranks"])
    recover = kept["ranks"][0]["steps"][first]["t"] - lost["ranks"][0]["t_plan"]
    log(f"[elastic ranks] {ELASTIC_CELL}: restore {restore_s:.2f} s, first "
        f"resumed step {first_ms:.1f} ms, time to recover (the plan to the "
        f"end of step {first}) {recover:.1f} s; a checkpoint "
        f"{gb:.2f} GB; B1-B4 launches per rank "
        f"{[[sum(r.values()) for r in w] for w in launches]}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "recover_s": recover,
            "restore_s": restore_s, "first_ms": first_ms, "ckpt_gb": gb}


def phase_yardstick(dev, chol_batch: int, gemm_batch: int, b_chol=512,
                    b_gemm=1024) -> dict:
    """Times at the main path's largest body calls (the Cholesky gemm
    update over ``chol_batch`` tasks, the GEMM update over ``gemm_batch``)
    and at one shard's share of each."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    bc, bg = b_chol, b_gemm
    for name, T, m, k, n, tr in (
            ("cholesky gemm", chol_batch, bc, bc, bc, True),
            ("cholesky gemm, one shard", max(1, chol_batch // 4),
             bc, bc, bc, True),
            ("gemm update", gemm_batch, bg, bg, bg, False),
            ("gemm update, one shard", max(1, gemm_batch // 4),
             bg, bg, bg, False)):
        a, b = gemm_operands(gen, dev, torch.float32, T, m, k, n,
                             b_n=not tr)
        got = block_gemm(a, b)
        err = float((got - block_gemm_ref(a, b)).abs().max())
        reps = 5
        kernel = cuda_ms(lambda: block_gemm(a, b), reps)
        plain = cuda_ms(lambda: block_gemm_ref(a, b), reps)
        library = cuda_ms(lambda: torch.bmm(a, b), reps)
        kernel2 = cuda_ms(lambda: block_gemm(a, b), reps)
        bnd, bound_by = gemm_bound_ms(a, b)
        label = f"{name} [{T},{m},{k}]x[{T},{k},{n}]"
        log(f"[time] block_gemm {label}: kernel {kernel:.3f} / {kernel2:.3f} "
            f"ms, plain {plain:.3f} ms, torch.bmm {library:.3f} ms, bound "
            f"{bnd:.3f} ms ({bound_by}); {2e-9 * T * m * n * k / kernel:.1f} "
            f"TFLOP/s")
        rows[name] = {"ms": min(kernel, kernel2), "plain_ms": plain,
                      "library_ms": library, "bound_ms": bnd,
                      "bound_by": bound_by, "max_abs_err": err,
                      "shape": [T, m, k, n]}
        del a, b, got
    return rows


def phase_time_attention(dev, seq: int, dim: int) -> dict:
    """B2 at the attention chain's task ([1, 1, seq, dim] f32, causal, one
    task per launch), at yi-6b's prefill layout ([1, 32|4, 4096, 128]
    bf16), at the model's own prefill call ([4, 32|4, 2048, 128] bf16,
    strided views), at zamba2's windowed prefill call ([2, 32|32, 8192, 64]
    bf16, window 4 096), at seamless's cross-attention ([4, 16|16,
    512|2048, 64] bf16, full), at grok-1's prefill call ([4, 48|8, 2048,
    128] bf16, GQA 6, strided views) and at the tensor-parallel cells'
    per-rank shards (yi-6b tp2 [1, 16|2, 2048, 128], starcoder2-3b tp4
    [1, 6|1, 2048, 128], grok-1-314b tp4 [1, 12|2, 2048, 128], zamba2-1.2b
    tp4 [1, 8|8, 4608, 64] with its window of 4 096, seamless-m4t-large-v2
    tp4's encoder [1, 4|4, 2048, 64] full, decoder [1, 4|4, 512, 64]
    causal and cross-attention q [1, 4, 512, 64] kv [1, 4, 2048, 64]
    full): the kernel, its plain version and
    ``scaled_dot_product_attention`` with the same mask (an explicit band
    for the window; timed only), with each path's registers, spills and
    resident blocks."""
    gen = torch.Generator(device=dev).manual_seed(5)
    yi = get_config("yi-6b")
    hq, hkv, hd = yi.n_heads, yi.n_kv_heads, yi.head_dim
    zamba, seam = get_config("zamba2-1.2b"), get_config("seamless-m4t-large-v2")
    zh, zd, w = zamba.n_heads, zamba.head_dim, zamba.sliding_window
    sh, sd = seam.n_heads, seam.head_dim
    grok = get_config("grok-1-314b")
    gh, gg, gd = grok.n_heads, grok.n_kv_heads, grok.head_dim
    sc = get_config("starcoder2-3b")
    rows = {}
    for name, shape, model, dtype, causal, win in (
            ("chain task", (1, 1, 1, seq, seq, dim), False, torch.float32,
             True, 0),
            ("yi-6b prefill", (1, hq, hkv, 4096, 4096, hd), False,
             torch.bfloat16, True, 0),
            ("yi-6b model prefill", (4, hq, hkv, 2048, 2048, hd), True,
             torch.bfloat16, True, 0),
            ("zamba2 windowed prefill", (2, zh, zh, 8192, 8192, zd), True,
             torch.bfloat16, True, w),
            ("seamless cross", (4, sh, sh, 512, 2048, sd), True,
             torch.bfloat16, False, 0),
            ("grok prefill", (4, gh, gg, 2048, 2048, gd), True,
             torch.bfloat16, True, 0),
            ("yi-6b tp2 prefill shard", (1, hq // 2, hkv // 2, 2048, 2048,
                                         hd), True, torch.bfloat16, True, 0),
            ("starcoder2-3b tp4 prefill shard", (1, sc.n_heads // 4, 1, 2048,
                                                 2048, sc.head_dim), True,
             torch.bfloat16, True, 0),
            ("grok-1-314b tp4 prefill shard", (1, gh // 4, gg // 4, 2048,
                                               2048, gd), True,
             torch.bfloat16, True, 0),
            ("zamba2-1.2b tp4 windowed prefill shard", (1, zh // 4, zh // 4,
                                                        4608, 4608, zd),
             True, torch.bfloat16, True, w),
            ("seamless-m4t-large-v2 tp4 encoder shard", (1, sh // 4, sh // 4,
                                                         2048, 2048, sd),
             True, torch.bfloat16, False, 0),
            ("seamless-m4t-large-v2 tp4 decoder shard", (1, sh // 4, sh // 4,
                                                         512, 512, sd),
             True, torch.bfloat16, True, 0),
            ("seamless-m4t-large-v2 tp4 cross shard", (1, sh // 4, sh // 4,
                                                       512, 2048, sd),
             True, torch.bfloat16, False, 0)):
        q, k, v = attention_operands(gen, dev, dtype, *shape, model=model)
        kw = dict(causal=causal, window=win)
        got = flash_attention(q, k, v, **kw)
        err = float((got.float() - mha_ref(q, k, v, **kw).float())
                    .abs().max())
        gqa = q.shape[1] != k.shape[1]
        # SDPA with the same mask: causal, an explicit band for the window
        mask = None
        if win:
            pos = torch.arange(q.shape[2], device=dev)[:, None]
            key = torch.arange(k.shape[2], device=dev)[None, :]
            mask = (key <= pos) & (key > pos - win)
        reps = 5
        kernel = cuda_ms(lambda: flash_attention(q, k, v, **kw), reps)
        plain = cuda_ms(lambda: mha_ref(q, k, v, **kw), 2 if win else reps)
        library = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=gqa), reps)
        kernel2 = cuda_ms(lambda: flash_attention(q, k, v, **kw), reps)
        nbytes, flops = attention_work(q, k, causal, win)
        bnd, bound_by = bound(nbytes, flops, dtype)
        info = attention_kernel_info(dtype, q.shape[3], dev.index or 0)
        log(f"[time] flash_attention {name} q{list(q.shape)} "
            f"kv{list(k.shape)} {str(dtype)[6:]}"
            f"{' window %d' % win if win else ''}"
            f"{'' if causal else ' full'}: kernel {kernel:.3f} / "
            f"{kernel2:.3f} ms, plain {plain:.3f} ms, sdpa {library:.3f} ms, "
            f"bound {bnd:.3f} ms ({bound_by}); kernel "
            f"{1e-9 * flops / min(kernel, kernel2):.1f} TFLOP/s, sdpa "
            f"{1e-9 * flops / library:.1f} TFLOP/s; {info.registers} "
            f"registers, {info.spill_bytes} spill bytes, "
            f"{info.blocks_per_sm} blocks per SM")
        rows[name] = {"ms": min(kernel, kernel2), "plain_ms": plain,
                      "library_ms": library, "bound_ms": bnd,
                      "bound_by": bound_by, "max_abs_err": err,
                      "shape": [list(q.shape), list(k.shape),
                                str(dtype)[6:]] + ([win] if win else [])}
        del q, k, v, got, mask
    return rows


def phase_time_ssd(dev, shape, name="mamba2-1.3b", variants=True) -> dict:
    """B3 at a model's layer at prefill (``name``: mamba2-1.3b, or
    zamba2-1.2b's at d_state 64), in the model's layout (x, B and C views
    of one projection): bf16 at Q 128 (the model's; the row returned) and,
    with ``variants``, Q 256 and f32 at Q 128; the kernels and their plain
    version. No single PyTorch call computes the SSD scan, so there is no
    library time."""
    b, l, h, p, g, n = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    row = None
    for dtype, q in ((torch.bfloat16, 128), (torch.bfloat16, 256),
                     (torch.float32, 128))[:3 if variants else 1]:
        ops = ssd_operands(gen, dev, dtype, b, l, h, g, p, n, model=True)
        got = ssd_scan(*ops, q_chunk=q)
        err = float((got.float() - ssd_chunked_ref(*ops, q_chunk=q).float())
                    .abs().max())
        reps = 10
        kernel = cuda_ms(lambda: ssd_scan(*ops, q_chunk=q), reps)
        plain = cuda_ms(lambda: ssd_chunked_ref(*ops, q_chunk=q), 3)
        kernel2 = cuda_ms(lambda: ssd_scan(*ops, q_chunk=q), reps)
        nbytes, flops = ssd_work(ops[0], ops[3], q)
        bnd, bound_by = bound(nbytes, flops, dtype)
        kernels = ssd_plan(b, l, h, g, p, n, q, got.element_size()).kernels
        log(f"[time] ssd_scan {name} layer x[{b},{l},{h},{p}] "
            f"b/c[{b},{l},{g},{n}] {str(dtype)[6:]} Q{q}: kernel "
            f"{kernel:.3f} / {kernel2:.3f} ms ({kernels} kernels a call), "
            f"plain {plain:.3f} ms, library none, bound {bnd:.3f} ms "
            f"({bound_by}); kernel {1e-9 * flops / min(kernel, kernel2):.1f} "
            f"TFLOP/s, {1e-6 * nbytes / min(kernel, kernel2):.0f} GB/s")
        if row is None:      # the model's own call
            row = {"ms": min(kernel, kernel2), "plain_ms": plain,
                   "library_ms": None, "bound_ms": bnd, "bound_by": bound_by,
                   "max_abs_err": err, "shape": list(shape) + ["bfloat16", q],
                   "kernels_per_call": kernels}
        del ops, got
    return row


def phase_time_decode(dev, cell=DECODE_CELL,
                      name="yi-6b decode layer") -> dict:
    """B4 at a decode layer (``cell`` = (B, Hq, Hkv, S, D); yi-6b's over the
    long cache, q [8, 32, 128], K/V [8, 4, 32768, 128], by default), bf16,
    every position live: the kernel, its plain version and
    ``scaled_dot_product_attention`` with the length mask (timed only)."""
    b, hq, hkv, s, d = cell
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = decode_operands(gen, dev, torch.bfloat16, b, hq, hkv, s, d)
    kv_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    got = decode_attention(q, k, v, kv_len)
    want = decode_ref(q, k, v, kv_len)
    err = float((got.float() - want.float()).abs().max())
    row = row_err(got, want)
    log(f"[time] decode_attention {name}: per-row err {row:.3e} (tol "
        f"{DECODE_ROW_TOL[torch.bfloat16]:.0e})")
    check(math.isfinite(row) and row <= DECODE_ROW_TOL[torch.bfloat16],
          f"decode_attention all-live cell: per-row err {row}")
    del want
    reps = 20
    kernel = cuda_ms(lambda: decode_attention(q, k, v, kv_len), reps)
    plain = cuda_ms(lambda: decode_ref(q, k, v, kv_len), 3)
    library = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=hq != hkv), reps)
    kernel2 = cuda_ms(lambda: decode_attention(q, k, v, kv_len), reps)
    live = int(kv_len.sum())      # cache positions read, over the batch
    nbytes = q.element_size() * (2 * q.numel() + 2 * hkv * d * live)
    bnd, bound_by = bound(nbytes, 4.0 * d * hq * live, torch.bfloat16)
    log(f"[time] decode_attention {name} q[{b},{hq},{d}] "
        f"kv[{b},{hkv},{s},{d}] bf16: kernel {kernel:.3f} / {kernel2:.3f} "
        f"ms, plain {plain:.3f} ms, sdpa {library:.3f} ms, bound {bnd:.3f} "
        f"ms ({bound_by}); kernel {1e-6 * nbytes / min(kernel, kernel2):.0f} "
        f"GB/s")
    return {"ms": min(kernel, kernel2), "plain_ms": plain,
            "library_ms": library, "bound_ms": bnd, "bound_by": bound_by,
            "max_abs_err": err, "shape": [[b, hq, d], [b, hkv, s, d],
                                          "bfloat16"]}


def timed(phase, *args, **kwargs):
    """``phase(*args, **kwargs)``, its wall time logged (``[time]``)."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    log(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 means IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    timed(phase_build)
    timed(phase_kernel_vs_plain, dev)
    timed(phase_attention_vs_plain, dev)
    timed(phase_ssd_vs_plain, dev)
    timed(phase_decode_vs_plain, dev)
    torch.cuda.empty_cache()
    chol = timed(phase_cholesky, dev)
    torch.cuda.empty_cache()
    host = timed(phase_host_runtime, dev, chol["L"])
    torch.cuda.empty_cache()
    sched = timed(phase_scheduler, dev)
    torch.cuda.empty_cache()
    gemm = timed(phase_gemm, dev)
    torch.cuda.empty_cache()
    chain = timed(phase_attention_chain, dev)
    torch.cuda.empty_cache()
    ranks = timed(phase_ranks, dev, chol, gemm, chain)["launches"]
    for phase in (chol, gemm, chain):
        for key in ("L", "L_unrolled", "C", "x"):
            phase.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    model = timed(phase_mamba2, dev)
    torch.cuda.empty_cache()
    dense = timed(phase_dense, dev)
    torch.cuda.empty_cache()
    hybrid = timed(phase_hybrid, dev)
    torch.cuda.empty_cache()
    encdec = timed(phase_encdec, dev)
    torch.cuda.empty_cache()
    vlm = timed(phase_vlm, dev)
    torch.cuda.empty_cache()
    grok = timed(phase_moe_grok, dev)
    gc.collect()
    torch.cuda.empty_cache()
    deepseek = timed(phase_moe_deepseek, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train = timed(phase_train, dev)
    torch.cuda.empty_cache()
    pipe = timed(phase_pipeline, dev, train)
    gc.collect()
    torch.cuda.empty_cache()
    pipe_ranks = timed(phase_pipeline_ranks, dev, pipe)
    ranks["starcoder2-3b-pipe2-r2 forward"] = pipe_ranks["forward_b2"]
    gc.collect()
    torch.cuda.empty_cache()
    tensor_ranks = timed(phase_tensor_ranks, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_ranks = timed(phase_train_ranks, dev)
    gc.collect()
    torch.cuda.empty_cache()
    elastic = timed(phase_elastic_ranks, dev)
    times = timed(phase_yardstick, dev, chol["max_batch"], gemm["max_batch"])
    attn_times = timed(phase_time_attention, dev, chain["seq"], chain["dim"])
    ssd_time = timed(phase_time_ssd, dev, model["shape"])
    z = get_config("zamba2-1.2b")
    zamba_ssd = phase_time_ssd(dev, [2, 8192, z.ssm.n_heads(z.d_model),
                                     z.ssm.head_dim, z.ssm.n_groups,
                                     z.ssm.d_state], "zamba2-1.2b", False)
    m = get_config("mamba2-1.3b").ssm
    shard_ssd = phase_time_ssd(dev, [1, 2048, m.n_heads(2048) // 4,
                                     m.head_dim, m.n_groups, m.d_state],
                               "mamba2-1.3b tp4 shard", False)
    decode_time = timed(phase_time_decode, dev)
    decode_rows = {name: phase_time_decode(dev, cell, name) for name, cell in (
        ("zamba2 ring", (8, 32, 32, 4096, 64)),
        ("seamless cross", (4, 16, 16, 2048, 64)),
        ("llava decode layer", (8, 56, 8, 4096, 128)),
        ("grok decode layer", (8, 48, 8, 4096, 128)),
        ("yi-6b tp2 decode shard", (8, 16, 2, 32768, 128)),
        ("starcoder2-3b tp4 decode shard", (8, 6, 1, 4096, 128)),
        ("grok-1-314b tp4 decode shard", (8, 12, 2, 4096, 128)),
        ("zamba2-1.2b tp4 ring shard", (8, 8, 8, 4096, 64)),
        ("seamless-m4t-large-v2 tp4 self shard", (8, 4, 4, 4096, 64)),
        ("seamless-m4t-large-v2 tp4 cross shard", (8, 4, 4, 2048, 64)))}
    log(f"[done] {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{run_peak() / 2 ** 30:.2f} GiB; GEMM main path launches "
        f"{gemm['launches']}")
    rows = [("block_gemm", "block_gemm/block_gemm.py:40", chol["launches"],
             times["cholesky gemm"]),
            ("flash_attention", "flash_attention/flash_attention.py:76",
             chain["launches"], attn_times["chain task"]),
            ("ssd_scan", "ssd_scan/ssd_scan.py:68", model["launches"],
             ssd_time),
            ("decode_attention", "decode_attention/decode_attention.py:65",
             dense["b4_per_step"], decode_time)]
    # B1 on the host runtime's path: one unbatched block a launch; B2, B3
    # and B4 at the hybrid, encdec and vlm paths' shapes, with their
    # launches on each path (per prefill; B4 per decode step)
    extra = {"block_gemm": {
        "host_launches": host["launches"], "host_ms": host["ms"],
        "host_plain_ms": host["plain_ms"],
        "host_library_ms": host["library_ms"],
        "host_bound_ms": host["bound_ms"],
        "sched_launches": sched["launches"]},
        "flash_attention": {"model_rows": {
            "zamba2 windowed prefill": attn_times["zamba2 windowed prefill"],
            "seamless cross": attn_times["seamless cross"],
            "yi-6b model prefill": attn_times["yi-6b model prefill"],
            "grok prefill": attn_times["grok prefill"],
            "yi-6b tp2 prefill shard": attn_times["yi-6b tp2 prefill shard"],
            "starcoder2-3b tp4 prefill shard":
                attn_times["starcoder2-3b tp4 prefill shard"],
            "grok-1-314b tp4 prefill shard":
                attn_times["grok-1-314b tp4 prefill shard"],
            "zamba2-1.2b tp4 windowed prefill shard":
                attn_times["zamba2-1.2b tp4 windowed prefill shard"],
            **{name: attn_times[name] for name in (
                "seamless-m4t-large-v2 tp4 encoder shard",
                "seamless-m4t-large-v2 tp4 decoder shard",
                "seamless-m4t-large-v2 tp4 cross shard")}},
            "launches_per_prefill": {
                "zamba2-1.2b": hybrid["b2_launches"],
                "seamless-m4t-large-v2": encdec["b2_launches"],
                "llava-next-34b-d16": vlm["b2_launches"],
                "yi-6b": dense["b2_launches"],
                "grok-1-314b-d8": grok["b2_launches"],
                "deepseek-v3-671b-d5": deepseek["b2_launches"]},
            "pipeline_launches": {
                "starcoder2-3b-pipe2 forward": pipe["forward"]["b2"]},
            "tensor_ranks_launches_per_prefill": {
                cell: [r["flash_attention"] for r in counts["prefill"]]
                for cell, counts in tensor_ranks.items()}},
        "ssd_scan": {"model_rows": {"zamba2-1.2b layer": zamba_ssd,
                                    "mamba2-1.3b tp4 shard": shard_ssd},
                     "launches_per_prefill": {
                         "zamba2-1.2b": hybrid["b3_launches"]},
                     "tensor_ranks_launches_per_prefill": {
                         cell: [r["ssd_scan"] for r in counts["prefill"]]
                         for cell, counts in tensor_ranks.items()
                         if any(r["ssd_scan"] for r in counts["prefill"])}},
        "decode_attention": {"model_rows": decode_rows,
                             "launches_per_step": {
                                 "zamba2-1.2b": hybrid["b4_per_step"],
                                 "seamless-m4t-large-v2":
                                     encdec["b4_per_step"],
                                 "llava-next-34b-d16": vlm["b4_per_step"],
                                 "grok-1-314b-d8": grok["b4_per_step"],
                                 "deepseek-v3-671b-d5":
                                     deepseek["b4_per_step"]},
                             "tensor_ranks_launches": {
                                 cell: [r["decode_attention"]
                                        for r in counts["decode"]]
                                 for cell, counts in tensor_ranks.items()}}}
    log("kernels: " + ", ".join(name for name, *_ in rows))
    log(card())
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": f"src/repro/kernels/{where}", "launches": launches,
        "train_launches": train["launches"][name],
        "pipeline_train_launches": pipe["launches"][name],
        "pipeline_ranks_train_launches": {
            "starcoder2-3b-pipe2-r2": [
                r[name] for r in pipe_ranks["step_launches"]],
            "starcoder2-3b-d8-pipe2-dp2-r4": [
                r[name] for r in pipe_ranks["r4_launches"]]},
        "ranks_launches": {cell: ranks[cell]
                           for cell in RANK_CELLS.get(name, ())},
        "tensor_ranks_train_launches": {
            cell: [r[name] for r in got["launches"]]
            for cell, got in train_ranks.items()},
        "elastic_ranks_train_launches": {
            ELASTIC_CELL: [[r[name] for r in world]
                           for world in elastic["launches"]]},
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"], **extra.get(name, {})}
        for name, where, launches, row in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
