#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (nsa_vibe_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  (a) build: compile the CUDA kernels of nsa_vibe_tpu_torch/csrc/ from the
      checkout (one nvcc per source, in parallel) and print the ptxas report
      (and, for the kernels of PTXAS_REPORTED, registers and spills; the
      bf16 tensor-core kernels at D = 64 of NO_SPILL must have none);
      the SASS of each bf16 tensor-core kernel (TENSOR_CORE_KERNELS) must
      hold HMMA/HGMMA instructions (cuobjdump -sass);
  (b) kernel checks: each kernel at the m7c-125M serving shapes (B=4,
      S=2048, G=2, h=6, D=64; decode with cache capacity 2080) against its
      plain PyTorch version on the card, in f32 with TF32 off and in bf16,
      with the bounds of `allowed_err`, except the bf16 fused scorer, the
      bf16 prefill selection forward and the bf16 window forward (tensor
      cores, P rounded to bf16), held by `select_cmp_check`,
      `sel_fwd_check` and `banded_fwd_check` to `allowed_tc_err`, which a
      1% fault planted in their output must fail; the scorer, selection and
      window forwards twice for identical bits; select_cmp's sel_idx is
      compared as sets and may differ only on near ties (NEAR_TIE), its
      forced slots in order, and in bf16 its O and lse must be banded_attn's
      in cmp mode bit for bit; then each kernel is timed beside its plain
      version, one PyTorch library call where one computes the same
      function, and its bound on the card, and the scorer at CTAs of each
      size of MMA_ROWS;
  (c) serve: m7c-125M in bf16 with random weights from a seed serves 4
      prompts of 2048 tokens and 32 greedy new tokens each through
      `generate`; the kernels' launch counters must show 12 select_cmp,
      12 win_attn and 12 + 12*31 sel_attn launches. Prefill and decode are
      timed with CUDA events, and must issue with no host-device
      synchronisation; one layer's nsa_prefill and nsa_decode_step on the
      card are compared, in f32, with the plain path (the same functions
      on CPU tensors) on the serve's own inputs; torch.profiler gives the
      device busy time of a prefill and of a decode step, by kernel;
  (d) train: at the m7c-125M training shapes (B=8, S=2048) the fused
      scorer (`select_cmp_check`), the selection forward (`sel_fwd_check`)
      and the window forward (`banded_fwd_check`), each with lse, the forward
      kernels' row statistics (lse) and the two-pass backward kernels
      (banded_bwd for win and cmp, sel_attn_bwd) against their plain
      versions in f32 and bf16 (bounds of `allowed_rel_err` in f32; the
      bf16 kernels, all on tensor cores, `allowed_tc_err`, which a 1%
      fault planted in each of their gradients must fail), each backward
      twice for identical bits, then timed beside its plain version, the
      backward of one scaled_dot_product_attention call and its bound;
      one layer's nsa_prefill forward + backward in f32 on the card
      against the same layer on CPU tensors (every gradient, and no host
      sync on the card); then the m7c-125M train step (bf16, remat, B=8 x
      2048 synthetic tokens) through make_train_step under the port's
      default design keys (ops/tuning.py): a warm-up step, timed steps
      with CUDA events, the launch counts of the kernels those keys
      select, peak memory, a torch.profiler step by kernel, the host syncs
      a step makes; and `train()` for a short run whose loss must fall;
  (e) long context: the banded forward (rows 5 and 3: banded_attn in cmp
      mode, win_attn) at the 64k shapes against its plain version on the
      last 4096 query rows (`banded_fwd_check`, f32 and bf16), and the same
      rows, bit for bit, from banded_attn at t_start = 61440; the
      select-only scorer (row 6, S_sel = 1024) on those rows, twice for
      identical bits, and at that t_start; the selection forward
      on select_blocks' sets (its last 4096 rows, PLAIN_ROWS a call) and at
      the 64k decode cache (`sel_fwd_check`); at 16k, where both routes
      apply, banded_attn against the plain unrounded compressed branch,
      select_cmp's O and lse against banded_attn's bit for bit and
      select_blocks' sets against select_cmp's, and
      compressed_attention forward + backward with no host sync; m7c-125M
      serves one 65536-token prompt and 32 greedy tokens through
      `generate` on the long route (launch counts per prefill: select_cmp
      0, banded_attn, select_blocks, sel_attn and win_attn 12 each; 12
      sel_attn per decode step), timed, traced and checked for host syncs;
      the needle smoke (five depths) and end-to-end probe (three depths)
      at S = 65536 must pass; rows 5, 3 and 6 are timed beside their plain
      versions (over every row, 4096 rows a call) and, for 5 and 3, SDPA,
      and the banded forward at q tiles of 64 and 128 rows (both modes);
      rows 2 and 4 at the 64k prefill and decode shapes, and the union
      forward's mean union and time at each q tile of Q_TILE_TOKENS; row 6
      at CTAs of each size of MMA_ROWS;
  (f) backward designs: the one-pass kernels (banded_bwd_1p for win and
      cmp, sel_attn_bwd_1p) and the diagonal window kernel (win_bwd_diag)
      at the training shapes against their plain versions (f32, bf16; the
      bf16 kernels all run on tensor cores and are held to `allowed_tc_err`
      with a planted 1% fault), twice for identical bits, and against the
      other design of the same function (rows 7/8, 9/10, 11/7/8; rows 11,
      7 and 8 form P and dS alike and are held to each other by
      `allowed_rel_err`); the banded one-pass kernel's chunks per CTA, the
      diagonal kernel's time and strip bytes at each q tile of
      DIAG_TILE_ROWS and the two-pass design's time at each q tile of its
      dQ kernel, MMA_ROWS; the selection's kv-major chunks per CTA
      before and after its work items, and its two-pass dQ kernel's mean
      union size and time at each q tile of Q_TILE_TOKENS, and the same for
      the union forward; the selection and window forwards timed at the
      train shape, the window at q tiles of 64 and 128 rows;
      timed as in (d);
      one m7c layer's f32
      gradients on the card under each setting of DESIGNS against the CPU,
      with no host sync; the m7c train step's first gradient under each
      setting against the default keys' (f32) within STEP_GRAD_TOL per leaf,
      where each of PLANTED_FAULTS must fail it; the m7c train step under
      each setting of DESIGNS: step ms, tokens/s, peak memory, the asserted
      launch counts, a profiler step by kernel, and the losses of the same
      steps from the same seed, equal to the default keys' within LOSS_TOL.

  (g) ragged serve (run after (c)): m7c-125M in bf16 prefills 4 prompts of
      RAGGED_LENS tokens alone and admits them (`admit_row`, in place) as
      rows 0-3 of one ragged batch of capacity CAP; RAGGED_EAGER
      teacher-forced eager ragged steps against each row's own uniform
      step (selection sets equal but for near ties, read counters equal,
      logits within LOGIT_ULPS bf16 ulps); the step captured as a CUDA
      graph (models/decode_graph.py): RAGGED_REPLAYS replays with no host
      sync, bit-equal to as many eager ragged steps, traced: 12 split-kernel
      launches per replay, the count row 4's line takes; at (c)'s
      shape the eager uniform, eager ragged and replayed step timed, and
      one traced replay's busy time; `generate_scan`'s greedy tokens equal
      `generate`'s (or differ first at a near tie, within TIE_ULPS);
      `generate_ragged` on the four prompts; the replayed decode at each
      B of SWEEP_B and depth of SWEEP_S (random caches at t = S); row 4 at
      the ragged shape against its plain version and timed.

  (h) varlen, packed documents (ops/varlen.py; run last): at the train
      shape, documents packed by pack_documents_aligned from VARLEN_MUST
      (shorter than l, exactly l_sel, longer than w, nearly a row) and
      lengths from VARLEN_SEED; rows 1 (select_cmp), 3 (win_attn), 7
      (banded_bwd_1p, win and cmp), 8 (banded_bwd, win and cmp) and 11
      (win_bwd_diag) with seq_start against their plain versions with it
      (f32 TF32 off and bf16, the phases' bounds, sets at near ties, two
      launches bit-equal), and each given the dense bound must fail; rows
      5 (banded_attn, cmp) and 6 (select_blocks) at 1 x 65536 likewise on
      the last N_CHECK rows; m7c bf16 on the packed batch against each
      document alone in its own row (logits within LOGIT_ULPS, the same
      selections; those starting on the compressed key-tile grid, each
      row's first among them, 0 ulps); one document perturbed moves no other document's logits
      (0.0) at 8 x 2048 and at 1 x 65536 (the long route, launches
      counted); the varlen train step (make_varlen_batches, 8 x 2048, bf16,
      remat): step ms, supervised tokens/s, peak memory, launches, host
      syncs, a traced step's busy and idle share, and the same under each
      setting of DESIGNS (losses within LOSS_TOL of the defaults'; the
      backward rows' launches come from these runs); train() with varlen
      whose loss falls, with one eval; one f32 varlen layer card vs CPU;
      the varlen step's first f32 gradient under each setting of DESIGNS
      within STEP_GRAD_TOL of the defaults', where a cmp backward that
      drops seq_start must fail; the kernels' rows on packed documents.

  (i) parallel training (parallel/): (i-kernels) every kernel
      the second sp rank runs, on its rows of the pod shape (8 x 2048 rows
      at t_start = 2048 against 4096 keys): rows 1 (select_cmp at
      pos_offset), 2 (sel_attn at the rows' positions), 3 (the window
      forward at t_start: banded_attn in window mode), 7 (banded_bwd_1p,
      win and cmp), 8 (banded_bwd, win and cmp), 9 (sel_attn_bwd_1p), 10
      (sel_attn_bwd) and 11 (win_bwd_diag), against their plain versions
      at that offset (f32 TF32 off
      and bf16; the phases' bounds with the planted 1% fault; sets at near
      ties; two launches bit-equal) and each launched at offset 0 must
      fail; (i-sp) and (i-fsdp) each start two ranks of this script
      (`--parallel-worker sp|fsdp`, started as torch.distributed.run
      --standalone starts its ranks) on the one card
      over gloo, as NCCL refuses two ranks on one device (so their times
      are two processes time-sharing one card, not NCCL scaling): the
      m7c-125M step at PAR_LAYERS layers (bf16, remat, default keys) at
      configs/m7c_125m_pod.yaml's seq_len, 8 x 4096 rows per dp member,
      sp = 2 (and one step under each of DESIGNS' onepass and twopass
      keys) or dp = 2 with fsdp:
      losses within LOSS_TOL of one process on the same global batch, the
      f32 first gradient within STEP_GRAD_TOL per leaf of one process's
      (with planted faults that must fail: a kernel's dV off by 0.01%, a
      kernel launched at offset 0, fsdp gradients not summed over dp),
      launch counts, no host sync outside the collectives, per-rank step
      ms, busy and idle share, tokens/s and MFU, bytes moved per step
      (sp), parameter + moment bytes per rank (fsdp) and a checkpoint
      saved under fsdp restored on one process.

  (j) packed documents under sequence sharding and pipeline stages
      (parallel/pipeline.py; run last): (j-kernels) rows 1 (select_cmp), 3
      and 5 (banded_attn, window and cmp), 7 (banded_bwd_1p, win and cmp),
      8 (banded_bwd, win and cmp) and 11 (win_bwd_diag) on the second sp
      rank's rows of packed pod-shape rows (8 x 2048 rows at t_start 2048
      against 4096 keys, seq_start of those rows, documents crossing 2048),
      and row 6 (select_blocks) on the last 4096 rows of a packed 64k row at
      t_start 61440, against their plain versions with both arguments (f32
      TF32 off and bf16, the phases' bounds with the planted 1% fault, sets
      at near ties, two launches bit-equal), each launched at offset 0 with
      the same seq_start and at the offset without seq_start failing; the
      build (a) holds the ptxas reports of every instantiation that existed
      before the DOCS x OFF ones to PTXAS_BASELINE and reports the new ones;
      (j-varlen-sp) two ranks, sp = 2 with varlen on packed 8 x 4096 rows
      (m7c, PAR_LAYERS layers, bf16, remat): losses within LOSS_TOL of one
      process, the f32 first gradient within STEP_GRAD_TOL (a window
      backward that drops seq_start must fail it), launch counts under
      three designs, a
      document across position 2048 perturbed moving no other document's
      logits (0.0 on each rank), and the 64k long route under sp with packed
      documents (launch counts, finite logits); (j-pp) two ranks, pp = 2 with
      PP_M micro-batches at m7c full width (PAR_LAYERS layers, 8 x 4096,
      bf16, remat): losses and the f32 first gradient held to one process,
      with three planted faults that must fail (the activation gradient
      sent back zeroed, micro-batches 0 and 1 swapped on the last stage, the
      top-level leaves' gradients not summed over pp); then four ranks, pp =
      2 x dp = 2 with fsdp and pp = 2 x sp = 2 with varlen, PP4_LAYERS
      layers at full width, three steps each held to one process. Each
      setting prints per-rank step ms, busy and idle share, launches a step,
      the bytes sent stage to stage a step, the bubble fraction and MFU; the
      ranks time-share the one card over gloo (not NCCL scaling).

  (k) tensor parallelism (parallel/mesh.py: tp_shard, copy_to_tp,
      reduce_from_tp; run last): (k-kernels) rows 1, 2, 3, 7, 8, 9, 10 and
      11 at a tp = 2 member's shape (one KV group of m7c, h = 6, D = 64,
      8 x 4096) against their plain versions (f32 TF32 off and bf16, the
      phases' bounds with the planted 1% fault, sets at near ties, two
      launches bit-equal, the designs against each other); (k-tp) two
      ranks, tp = 2, m7c at full width, PAR_LAYERS deep (bf16, remat; 2 of
      its 12 layers, for the time limit) on 8 x 4096: losses within
      LOSS_TOL of one process, the f32 first gradient within STEP_GRAD_TOL
      of one process computing each member's
      slice as its own call (`tp_split_grads`; its distance to a single
      call, where narrower f32 products tip near-tie selections, is
      printed), with three planted faults that must fail it ((a)
      copy_to_tp's backward all-reduce dropped, (b) the gate's gradients
      not summed over tp, (c) the top-level gradients summed over tp too),
      the bytes all-reduced over tp a step equal to `tp_bytes`, launch
      counts under three designs, no host sync outside the collectives, a
      checkpoint saved under tp restored on one process as each rank's own
      slices, with the next step's loss (and one saved with W_qkv gathered
      whole, (d), which must not restore so); (k-mesh) four ranks at
      TP4_LAYERS layers, tp x dp + fsdp, tp x sp + varlen and pp x tp, each
      held to one process likewise (losses, f32 first gradient, tp bytes);
      (k-dryrun) parallel/dryrun.py, eight ranks on the one card (every
      mesh of the JAX dry run, pp x sp x tp among them), its tail line the
      JAX run's. Per-rank step ms, busy and idle share, peak memory and
      MFU; the ranks time-share the one card over gloo (not tp scaling).

  (l) host tools (run last): (l1) the native C++ packer
      (nsa_vibe_tpu_torch/native) built with g++ and make_batches(native=True)
      byte-equal to native=False on TOOLS_BATCHES m7c train batches; (l2)
      the trainer CLI in a subprocess at m7c full width, TOOLS_LAYERS deep,
      with every tool on (TOOLS_ARGS: --profile, --mem-dump-every,
      --watchdog, --detect-anomaly): exit 0, finite losses, no bad step,
      the native packer used, mem_step<n>.json with a peak allocation, no
      .HALT, and the profiled steps' trace naming each kernel of the
      default step and no attention library kernel or op; (l3)
      NSAAttention and LlamaBlockNSA (models/nn_module.py) at m7c width,
      bf16, 1 x 2048, bit-equal to nsa_prefill / block_prefill, output and
      gradients.

  (m) the gate-epilogue fold (ops/tuning.py nsa.gate_fold, nsa.flat_io; run
      after (f), on its bf16 train-shape operands and phase (d)'s unfolded
      step): (m1) rows 1, 2, 3 and 5 (cmp) given a gate [B,S,G] f32
      against their gated plain versions (f32 allowed_err; bf16
      allowed_tc_err of the unrounded plain O and rss times the gate, a
      planted 1% fault failing; two launches bit-equal), their lse and
      selections the ungated launches' bits, select_cmp's gated O
      banded_attn's in bf16; (m2) rows 7 (win, cmp) and 9 given the gate
      bit-equal to the ungated launch on (dO * g).to(dtype), f32 and bf16,
      the launch with the gate dropped differing, bf16 within
      allowed_tc_err of the plain version on (dO * g); (m3) the m7c train
      step's f32 first gradient under the fold (default keys and
      DESIGNS["twopass"]) within STEP_GRAD_TOL a leaf of the unfolded
      defaults', a gate backward planted as plain softmax's failing on the
      gate leaves, the bf16 folded step's losses within LOSS_TOL of (d)'s,
      its gated launches, busy and other-kernels ms beside (d)'s; (m4) the
      serve prefill under the fold (and flat-IO, bit-equal) with no host
      sync on each of FOLD_SERVE_SEEDS, and the long route under the fold
      (row 5 gated): in f32 the folded logits within FOLD_F32_TOL of the
      unfolded ones, in bf16 no farther from the f32 unfolded logits than
      the bf16 unfolded ones plus LOGIT_ULPS; (m5) the gated kernels' JSON
      rows. The phase fails past FOLD_BUDGET_S.

  (n) the JAX package's other configurations (run after (m)), each read
      from configs/<name>.yaml through the trainer's load_config at full
      width and depth, on synthetic tokens (fineweb needs the network):
      (n1) m7c_350m.yaml (24 layers, dim 1024, G = 4, h = 4): rows 1, 2,
      3 (with lse), 7 (cmp), 9 and 11 and their partners at 8 x 2048
      against their plain versions (f32 allowed_err / allowed_rel_err;
      bf16 allowed_tc_err with a planted 1% fault; two launches
      bit-equal; lse within LSE_TOL), row 4 at the decode shape, one layer
      in f32 card vs CPU (GRAD_TOL, and STEP_GRAD_TOL a leaf, which each of
      LAYER_FAULTS must exceed), serving 4 x 2048 + 32 (launch counts, no
      host sync, prefill, decode and replayed decode timed and traced), the
      train step; (n2) m7c_125m_16k.yaml (1 x 16384, MLP-only remat,
      rope_scale 8, 8 micro-batches): the fused route (select_cmp_fits at
      S_sel = 256), the same kernel checks at B = 1, S = 16384 (plain
      versions CHUNK_16K rows or HEADS_16K heads a call), the train step,
      remat_accum_check; (n3) m7c_125m_long.yaml (2 x 8192, MLP-only
      remat, rope_scale 4, 4 micro-batches): the train step,
      remat_accum_check; (n4) m7c_125m_fast.yaml (16 x 2048, no remat):
      the train step; (n5) train_showcase.yaml (f32, d_k 16): the train
      step, then the trainer's CLI for SHOWCASE_STEPS steps. Each train
      step (phase_train): launch counts equal to train_launches (forward
      kernels twice a layer and micro-batch under full remat, once
      otherwise), no host sync in a step, finite losses and grad norms
      with no bad step; step ms, busy and idle share, tokens/s, MFU, peak
      memory. The JSON rows <kernel>@350m, sel_attn@350m-decode and
      <kernel>@16k, and the tile sweeps at both shapes (printed only).
      The phase fails past CONFIG_BUDGET_S.

  (o) the multi-tensor AdamW (ops/cuda/adamw_mt.py; run after (d)) at
      m7c-125M's and m7c-350M's trainable leaves, bf16: its update bit for
      bit the tensor ops' (train/optim.py::apply_update_plain_) in p, mu, nu
      and count over a first, an unclipped and a clipped step past
      warm-up, its norm within ADAMW_NORM_TOL of global_norm and repeatable;
      its launches a step; the kernels' optimizer a step timed beside the
      tensor ops and its bytes bound (JSON rows adamw_mt@125m, @350m).
      Every train step (phase_train) also holds the optimizer's launches
      over its timed steps to optimizer_launches.

The last lines are the card's `name, power.limit`, a JSON line of the
kernels' numbers, and {"ok": true, "device": {...}}.
Every process the script starts has ended when it exits (guard_children:
at exit and on SIGTERM, SIGINT or SIGHUP).
"""

from __future__ import annotations

import atexit
import contextlib
import csv
import ctypes
import dataclasses
import functools
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
import types
import warnings
import weakref

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nsa_vibe_tpu_torch import M7C_125M, M7C_125M_TRAIN, native
from nsa_vibe_tpu_torch.convert import params_to, params_to_numpy
from nsa_vibe_tpu_torch.core.cache import (
    admit_row, cache_from_prefill, cache_tensors, ragged_cache,
)
from nsa_vibe_tpu_torch.core import gate as gate_mod
from nsa_vibe_tpu_torch.core.decode import nsa_decode_step
from nsa_vibe_tpu_torch.core.nsa import PROJ_KEYS, init_nsa_params, nsa_prefill, tp_local
from nsa_vibe_tpu_torch.models.llama_block import block_prefill, init_block_params, mlp, rmsnorm
from nsa_vibe_tpu_torch.models.nn_module import LlamaBlockNSA, NSAAttention
from nsa_vibe_tpu_torch.models.remat import remat
from nsa_vibe_tpu_torch.models.decode_graph import DecodeGraph
from nsa_vibe_tpu_torch.models.tinylm import (
    cross_entropy_loss, embed, generate, generate_ragged, generate_scan, head,
    init_model_caches, init_model_params, model_decode_step, model_decode_step_ragged,
    model_forward, model_prefill_with_caches,
)
from nsa_vibe_tpu_torch.ops import cuda as kernels
from nsa_vibe_tpu_torch.ops import attention, tuning
from nsa_vibe_tpu_torch.ops.attention import compressed_attention
from nsa_vibe_tpu_torch.ops.block_index import (
    build_block_meta, build_M_csl_on, expected_decode_reads, num_cmp_blocks,
)
from nsa_vibe_tpu_torch.ops.cuda import build as kbuild
from nsa_vibe_tpu_torch.ops.cuda import adamw_mt
from nsa_vibe_tpu_torch.ops.cuda import banded_attn as ba_mod
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import (
    MMA_TILE_ROWS, banded_attn, banded_attn_plain, banded_attn_rss,
)
from nsa_vibe_tpu_torch.ops.cuda import banded_bwd as bb_mod
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import (
    DQ_TILE_ROWS, banded_bwd, banded_bwd_plain, banded_bwd_rss, banded_mask,
)
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd_1p import banded_bwd_1p, mma_plan, split_shares
from nsa_vibe_tpu_torch.ops.cuda import sel_attn as sa_mod
from nsa_vibe_tpu_torch.ops.cuda.sel_attn import (
    sel_attn, sel_attn_plain, sel_attn_rss, union_tile_tokens,
)
from nsa_vibe_tpu_torch.ops.cuda import sel_attn_bwd as sb_mod
from nsa_vibe_tpu_torch.ops.cuda.common import kv_splits
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd import (
    CHUNKS_PER_ITEM, sel_attn_bwd, sel_attn_bwd_plain, sel_attn_bwd_rss, selection_index,
    selection_tile_union, union_tokens,
)
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd_1p import sel_attn_bwd_1p
from nsa_vibe_tpu_torch.ops.cuda import select_blocks as sk_mod
from nsa_vibe_tpu_torch.ops.cuda.select_blocks import (
    MMA_TILE_ROWS as SEL_TILE_ROWS, select_blocks, select_blocks_plain,
)
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as sc_mod
from nsa_vibe_tpu_torch.ops.cuda.select_cmp import (
    MMA_TILE_ROWS as CMP_TILE_ROWS, select_cmp, select_cmp_plain, tile_plan as cmp_tile_plan,
)
from nsa_vibe_tpu_torch.ops.cuda.win_attn import win_attn, win_attn_plain
from nsa_vibe_tpu_torch.ops.cuda import win_bwd_diag as wd_mod
from nsa_vibe_tpu_torch.ops.cuda.win_bwd_diag import win_bwd_diag
from nsa_vibe_tpu_torch.ops.reference import attention_delta, gate_dO
from nsa_vibe_tpu_torch.ops.selection import (
    canonicalize_sel, select_topn_blocks, selection_token_mask,
)
from nsa_vibe_tpu_torch.ops.varlen import make_varlen_batches, pack_documents_aligned
from nsa_vibe_tpu_torch.parallel import context as pctx
from nsa_vibe_tpu_torch.parallel import mesh as pmesh
from nsa_vibe_tpu_torch.parallel import pipeline
from nsa_vibe_tpu_torch.parallel import train_step as pts
from nsa_vibe_tpu_torch.parallel.context import context_parallel_model_forward
from nsa_vibe_tpu_torch.parallel.mesh import gather_dim, initialize_distributed, make_mesh
from nsa_vibe_tpu_torch.parallel.train_step import (
    build_state, build_state_and_step, full_leaves, gather_full, gathered_params,
    grads_and_stats, local_batch,
)
from nsa_vibe_tpu_torch.train.data import make_batches
from nsa_vibe_tpu_torch.train import optim
from nsa_vibe_tpu_torch.train.train_step import (
    init_train_state, loss_and_grads, make_train_step, param_leaves, tree_from_leaves,
)
from nsa_vibe_tpu_torch.train.trainer import load_config, train
from nsa_vibe_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from nsa_vibe_tpu_torch.utils.device import torch_dtype
from nsa_vibe_tpu_torch.utils.flops import H100_BF16_PEAK_FLOPS, train_step_flops
from nsa_vibe_tpu_torch.utils.needle import NEEDLE_CFG, needle_probe, needle_smoke

HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense tensor-core bf16 / f32 FMA
F32_TOL = 5e-5                  # kernel vs plain, f32 with TF32 off: summation order only
BF16_ULPS, BF16_FLOOR = 2, 1e-4  # kernel vs plain, bf16: see allowed_err
NEAR_TIE = 1e-5            # sel_idx may differ where p_grp scores are this close
LAYER_TOL = 1e-4           # one layer, f32: kernel path vs plain path (|out| ~ 0.1)
LSE_TOL = 1e-4             # forward row statistics, absolute (|lse| < ~20; f32 sum order)
GRAD_TOL = 1e-4            # one layer's gradients, f32, relative to each tensor's max |value|
TRACE_PAD = 0.02           # s of idle profiler window before and after the traced calls
SLEEP_CYCLES_PER_S = 2e9   # >= the H100's SM clock (1.98 GHz), so a sleep lasts at least as asked
B, S, CAP, N_NEW = 4, 2048, 2080, 32
B_TRAIN, TIMED_STEPS, LOSS_STEPS = 8, 5, 120
LOSS_DROP = 0.2            # mean of the last 4 logged losses below the first, at least
PORT_KERNELS = ("select_cmp_kernel", "select_cmp_mma_kernel",                    # CUDA symbols
                "sel_attn_kernel", "sel_attn_union_kernel",
                "sel_attn_split_kernel", "sel_attn_combine_kernel", "win_fwd_mma_kernel",
                "cmp_fwd_mma_kernel",
                "banded_bwd_dq_kernel", "banded_bwd_dq_mma_kernel", "sel_bwd_dq_kernel",
                "sel_bwd_dq_union_kernel", "sel_bwd_kv_mma_kernel", "sel_bwd_kv_fma_kernel",
                "sel_bwd_reduce_kernel", "reduce_splits_kernel", "banded_attn_kernel",
                "select_blocks_kernel", "select_blocks_mma_kernel", "banded_bwd_1p_kernel",
                "win_bwd_diag_kernel", "banded_bwd_1p_mma_kernel", "win_bwd_diag_mma_kernel",
                "sum_slots_kernel", "sum_strips_kernel")
# the bf16 kernels that must run on tensor cores: their SASS holds HMMA
TENSOR_CORE_KERNELS = ("sel_bwd_kv_mma_kernel", "sel_bwd_dq_union_kernel",
                       "sel_attn_union_kernel", "win_fwd_mma_kernel", "cmp_fwd_mma_kernel",
                       "banded_bwd_1p_mma_kernel", "win_bwd_diag_mma_kernel",
                       "banded_bwd_dq_mma_kernel", "select_blocks_mma_kernel",
                       "select_cmp_mma_kernel",
                       # the gate-epilogue fold's entries (phase (m))
                       "gated_sel_bwd_kv_mma_kernel", "gated_sel_attn_union_kernel",
                       "gated_win_fwd_mma_kernel", "gated_cmp_fwd_mma_kernel",
                       "gated_banded_bwd_1p_mma_kernel", "gated_select_cmp_mma_kernel")
# kernels whose ptxas report is printed; the forwards, the banded backward and
# the scorers on tensor cores at D = 64 must have no stack frame and no spills
PTXAS_REPORTED = ("sel_bwd_", "sel_attn_union_kernel", "sel_attn_split_kernel",
                  "fwd_mma_kernel", "bwd_1p_mma_kernel", "bwd_diag_mma_kernel",
                  "bwd_dq_mma_kernel", "select_blocks_mma_kernel", "select_cmp_mma_kernel")
NO_SPILL = ("sel_attn_union_kernelILi64E", "win_fwd_mma_kernelILi64E",   # mangled <64>
            "cmp_fwd_mma_kernelILi64E", "banded_bwd_1p_mma_kernelILi64E",
            "win_bwd_diag_mma_kernelILi64E", "banded_bwd_dq_mma_kernelILi64E",
            "select_blocks_mma_kernelILi64E", "select_cmp_mma_kernelILi64E",
            "gated_sel_attn_union_kernelILi64E", "gated_win_fwd_mma_kernelILi64E",
            "gated_cmp_fwd_mma_kernelILi64E", "gated_banded_bwd_1p_mma_kernelILi64E",
            "gated_select_cmp_mma_kernelILi64E", "gated_sel_bwd_kv_mma_kernelILi64E")
# the reported kernels' ptxas numbers before the packed-documents-at-an-offset
# (DOCS x OFF) instantiations were added: each of those kernels must keep them
PTXAS_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nsa_vibe_tpu_torch",
                              "csrc", "ptxas_baseline.json")
# backward-design settings of phase (f) (ops/tuning.py keys), each a train step
DESIGNS = {
    "onepass": {"bwd.onepass": 1, "sel.bwd_onepass": None, "win.bwd_diag": 0},
    "onepass+diag": {"bwd.onepass": 1, "sel.bwd_onepass": None, "win.bwd_diag": 1},
    "onepass+diag, sel two-pass": {"bwd.onepass": 1, "sel.bwd_onepass": 0, "win.bwd_diag": 1},
    "twopass": {"bwd.onepass": 0, "sel.bwd_onepass": 0, "win.bwd_diag": 0},
}
# the selection backward's bf16 tensor-core kernels round P and dS to bf16
# before their products, as the TPU kernels do (sel_flash.py:438, :514,
# :523, :818), and the plain version does not; their bound (allowed_tc_err)
# adds TC_SIGMAS * 2^-9 * rss, the root sum of squares of each element's
# terms, to one bf16 ulp of the unrounded plain value and F32_TOL of its max
TC_SIGMAS = 4
FAULT = 1.01               # a planted 1% error in one bf16 gradient must fail that bound
Q_TILE_TOKENS = (1, 2, 5, 10)   # q tiles of the union dQ and forward kernels timed at h = 6
DIAG_TILE_ROWS = (64, 128, 192)  # q tiles (rows) of the bf16 diagonal window backward timed
MMA_ROWS = (64, 128)        # q tiles (rows) of the bf16 two-pass dQ kernel and scorers timed
PLAIN_ROWS = 1024          # query rows per call of the selection forward's plain version at 64k
LOSS_TOL = 5e-3   # train-step loss, any design vs the default keys, absolute (loss ~5.6)
# the train step's first gradient, any design vs the default keys, per leaf:
# ||g - g_default|| / ||g_default|| (f32, TF32 off). On the H100 the designs
# differ by at most ~2.7e-6; a 0.01% error in one kernel's dQ, dK or dV
# shows as 4.7e-5 to 1.7e-4 (PERF.md)
STEP_GRAD_TOL = 2e-5
# faults planted in the default keys' backward kernels (kernel, gradient: 0 dQ,
# 1 dK, 2 dV, factor); each must take the first gradient past STEP_GRAD_TOL
PLANTED_FAULTS = (("sel_attn_bwd_1p", 1, 0.0), ("sel_attn_bwd_1p", 0, 0.9999),
                  ("win_bwd_diag", 2, 0.9999), ("banded_bwd_1p", 0, 0.9999))
# the same faults planted in one layer (phase (n)'s m7c-350M layer check), the
# compressed branch's dQ at 0.1%: in one layer its dQ is ~6% of W_Q's gradient
# (a 0.01% fault moved W_Q by 5.6e-6 on the CPU at that layer's shape)
LAYER_FAULTS = PLANTED_FAULTS[:3] + (("banded_bwd_1p", 0, 0.999),)
DECODE_T = (2048, 2055, 2070, 2079)                          # decode positions per row
TRAIN_DIR = os.path.join("artifacts", "chip_smoke_train")   # git-ignored, inside the checkout
S_LONG, N_CHECK = 65536, 4096    # long prompt; its last rows held against the plain versions
S_CROSS = 16384                  # the longest m7c prompt the fused scorer takes (S_sel = 256)
RAGGED_LENS = (2048, 1024, 300, 33)   # prompts prefilled alone, admitted as rows 0-3 (CAP)
RAGGED_EAGER = 8          # teacher-forced eager ragged steps held against the uniform step
RAGGED_REPLAYS = 32       # replays held bit-equal to as many eager ragged steps
SWEEP_S, SWEEP_B = (512, 2048, 16384, 65536), (1, 4)   # decode sweep: depth t = S, batch
SWEEP_STEPS = 20          # timed replays per sweep point (after 2)
# bf16 logits of the eager ragged step (one B = 4 batch) against each row's
# uniform step (B = 1), in ulps of the row's largest |logit|: they read bit
# for bit on the H100 (0 ulps in every run of phase (g)); 2 leave room for a
# GEMM of another batch shape that sums in another order
LOGIT_ULPS = 2
# a greedy token may differ from generate's only where generate's top-2
# logits are this close (ulps of the max |logit|); generate_ragged's rows
# parted from generate at gaps of 1 ulp (decode vs prefill ingestion)
TIE_ULPS = 2
NEEDLE_DEPTHS, PROBE_DEPTHS = (0.1, 0.25, 0.5, 0.75, 0.9), (0.1, 0.5, 0.9)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ------------------------------------------------------------------ processes
# Every process the script starts ends before it does: the script is its
# descendants' subreaper (an orphan re-parents to it, not to init) and, at
# exit or on SIGTERM, SIGINT or SIGHUP, kills what is still below it.

PR_SET_CHILD_SUBREAPER = 36


def _descendants() -> list:
    """The live processes below this one, read from /proc."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            with contextlib.suppress(OSError, ValueError):
                with open(f"/proc/{d}/stat") as f:
                    state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
                if state != "Z":
                    parent[int(d)] = int(ppid)
    out, todo = [], [os.getpid()]
    while todo:
        pid = todo.pop()
        kids = [c for c, p in parent.items() if p == pid]
        out += kids
        todo += kids
    return out


def _reap() -> None:
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(-1, os.WNOHANG)[0]:
            pass


def end_children(grace_s: float = 0.0) -> list:
    """Waits up to grace_s for the processes below this one to end, then
    kills what is left (again while orphans re-parent here) and reaps it;
    returns the command lines of the processes it killed."""
    deadline = time.monotonic() + grace_s
    while _descendants() and time.monotonic() < deadline:
        _reap()
        time.sleep(0.2)
    killed = {}
    for _ in range(100):
        pids = _descendants()
        if not pids:
            break
        for pid in pids:
            with contextlib.suppress(OSError):
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    killed.setdefault(pid, f.read().replace(b"\0", b" ").decode()[:160])
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        time.sleep(0.05)
        _reap()
    _reap()
    return list(killed.values())


def guard_children() -> None:
    """Makes this process its descendants' subreaper and ends them at exit
    and on SIGTERM, SIGINT and SIGHUP."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        fail(f"prctl(PR_SET_CHILD_SUBREAPER): errno {ctypes.get_errno()}")
    atexit.register(end_children)

    def on_signal(signum, _frame):
        end_children()
        os._exit(128 + signum)

    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, on_signal)


def time_ms(fn, iters: int, warmup: int = 2, hold: bool = False) -> float:
    """Mean time of `iters` back-to-back calls of fn, from CUDA events.
    hold=True first parks the stream on a sleep kernel long enough for the
    host to queue every call, so the events time the device's work and not
    the wrapper's Python cost (kernel timings); without it the result is
    the wall time a caller sees (end-to-end timings)."""
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t) / warmup        # upper bound of one call's host cost
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(int(min(2 * host_s * iters, 1.0) * SLEEP_CYCLES_PER_S))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(nbytes: int, ops: float, dtype) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------------ (a)

def demangle(names: list) -> list:
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def ptxas_report(log: str, names) -> list:
    """(kernel, registers, stack frame and spills) of each compiled entry
    whose name holds one of `names`, from the build's `ptxas -v` output."""
    out, cur, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            cur = entry if any(n in entry for n in names) else None
        elif cur and "bytes stack frame" in line:
            frame = line.strip()
        elif cur and "Used" in line and "registers" in line:
            out.append((cur, int(line.split("Used")[1].split()[0]), frame))
            cur = None
    return out


def tensor_core_sass(lib_path) -> dict:
    """mangled name -> count of tensor-core instructions (HMMA, HGMMA) in
    the SASS of each kernel of TENSOR_CORE_KERNELS in the built library
    (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            cur = name if any(k in name for k in TENSOR_CORE_KERNELS) else None
            if cur:
                counts[cur] = 0
        elif cur and ("HMMA" in line or "HGMMA" in line):
            counts[cur] += 1
    return counts


def ptxas_key(name: str) -> str:
    """A demangled kernel name up to its argument list (its template
    arguments kept): the key of PTXAS_BASELINE."""
    i = name.find(">(")
    return name[:i + 1] if i >= 0 else name.split("(")[0]


def ptxas_numbers(regs: int, frame: str) -> list:
    """[registers, stack frame, spill stores, spill loads] of a report line."""
    return [regs] + [int(v) for v in frame.replace(",", " ").split() if v.isdigit()]


def phase_build() -> None:
    t = time.perf_counter()
    path = kbuild.build(force=True)
    print(kbuild.BUILD_LOG)
    kbuild.library()
    print(f"[build] {path.name} built from {len(kbuild.SOURCES)} sources in "
          f"{time.perf_counter() - t:.1f} s")
    report = ptxas_report(kbuild.BUILD_LOG, PTXAS_REPORTED)
    names = demangle([r[0] for r in report])
    for (_, regs, frame), name in zip(report, names):
        print(f"[build] ptxas {name}: {regs} registers; {frame}")
    with open(PTXAS_BASELINE) as f:
        kept = json.load(f)["kernels"]
    changed, new = [], []
    for (_, regs, frame), name in zip(report, names):
        key, got = ptxas_key(name), ptxas_numbers(regs, frame)
        if key not in kept:
            new.append(f"{key}: {got}")
        elif got != kept[key]:
            changed.append(f"{key}: {got} (was {kept[key]})")
    print(f"[build] ptxas reports against {PTXAS_BASELINE} ({len(kept)} kernels): "
          f"{len(kept) - len(changed)} the same, changed: {changed or 'none'}; instantiations "
          f"it lacks [registers, stack frame, spill stores, spill loads]: {new or 'none'}")
    if changed or len(names) - len(new) != len(kept):
        fail("a kept instantiation's ptxas report (registers, stack, spills) changed, or one "
             "is missing")
    spills = [n for n, _, f in report
              if any(int(v) for v in f.replace(",", " ").split() if v.isdigit())]
    print(f"[build] reported kernels with a stack frame or spills: {len(spills)}")
    for k in NO_SPILL:
        if not any(k in n for n, _, _ in report) or any(k in n for n in spills):
            fail(f"ptxas must report {k} (D = 64) with no stack frame or spills")
    counts = tensor_core_sass(path)
    for name, n in zip(demangle(list(counts)), counts.values()):
        print(f"[build] SASS {name}: {n} tensor-core instructions (HMMA/HGMMA)")
    found = {k for k in TENSOR_CORE_KERNELS for name in counts if k in name}
    if found != set(TENSOR_CORE_KERNELS) or not all(counts.values()):
        fail(f"the bf16 kernels {TENSOR_CORE_KERNELS} must hold tensor-core instructions: "
             f"{counts}")


# ------------------------------------------------------------------ (b)

def near_tie_rows(sel_k, sel_p, p_grp):
    """(rows whose selection sets differ, of those the rows whose differing
    blocks' plain scores spread more than NEAR_TIE, the widest such spread
    or 0.0)."""
    ck, cp = canonicalize_sel(sel_k), canonicalize_sel(sel_p)
    S_sel = p_grp.shape[-1]

    def onehot(c):
        ids = torch.where(c < 0, torch.full_like(c, S_sel), c).long()
        oh = torch.zeros((*c.shape[:-1], S_sel + 1), dtype=torch.bool, device=c.device)
        return oh.scatter_(-1, ids, True)[..., :S_sel]

    diff = onehot(ck) ^ onehot(cp)
    differ = diff.any(-1)
    hi = torch.where(diff, p_grp, torch.full_like(p_grp, -1e30)).amax(-1)
    lo = torch.where(diff, p_grp, torch.full_like(p_grp, 1e30)).amin(-1)
    spread = torch.where(differ, hi - lo, torch.zeros_like(hi))
    return int(differ.sum()), int((spread > NEAR_TIE).sum()), float(spread.max())


def kernel_inputs(dtype, dev, gen, cfg=None):
    """Operands of the serving kernels at phase (b)'s shapes, with the
    heads and groups of `cfg` (default m7c-125M's)."""
    cfg = cfg or M7C_125M.nsa
    G, h, D = cfg.n_kv_groups, cfg.h_per_group, cfg.d_k
    meta = build_block_meta(S, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)
    dmeta = build_block_meta(CAP, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    t_dec = torch.tensor(DECODE_T, device=dev)[:, None]                     # [B,1]
    p_dec = torch.rand((B, 1, G, dmeta.S_sel), generator=gen, device=dev)
    return dict(
        cfg=cfg, scale=1.0 / float(np.sqrt(D)),
        Q=r(B, S, G, h, D), Kc=r(B, G, meta.S_cmp, D), Vc=r(B, G, meta.S_cmp, D),
        M=torch.from_numpy(meta.M_csl).to(dev),
        K=r(B, G, S, D), V=r(B, G, S, D), Kw=r(B, G, S, D), Vw=r(B, G, S, D),
        t_pre=torch.arange(S, device=dev),
        Qd=r(B, 1, G, h, D), Kd=r(B, G, CAP, D), Vd=r(B, G, CAP, D), t_dec=t_dec,
        sel_dec=select_topn_blocks(p_dec, cfg.n_sel, t_dec, cfg.l_sel),
    )


def allowed_err(plain: torch.Tensor) -> torch.Tensor:
    """Per-element bound of |kernel - plain|. f32: F32_TOL. bf16: both
    versions round an f32 result (f32 accumulation, f32 softmax) that agrees
    to ~1e-6, so they may land one bf16 ulp of the plain value apart, two
    across a power of two; BF16_ULPS ulps plus BF16_FLOOR."""
    if plain.dtype == torch.float32:
        return torch.full_like(plain, F32_TOL)
    x = plain.float().abs()
    _, e = torch.frexp(x)                                   # x in [2^(e-1), 2^e)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)            # bf16: 8 significant bits
    return torch.where(x > 0, BF16_ULPS * ulp, torch.zeros_like(x)) + BF16_FLOOR


def allowed_rel_err(plain: torch.Tensor) -> torch.Tensor:
    """Per-element bound of |kernel - plain| for the backward kernels. f32:
    F32_TOL of the tensor's max |value| (each gradient sums up to S rows or
    keys, so the sum-order error scales with the largest terms, not with the
    element). bf16: both versions round f32 results that agree within that
    bound, so two bf16 ulps of the plain value on top of it."""
    x = plain.float().abs()
    rel = F32_TOL * float(x.max())
    if plain.dtype == torch.float32:
        return torch.full_like(x, rel)
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return torch.where(x > 0, BF16_ULPS * ulp, torch.zeros_like(x)) + rel


def allowed_tc_err(plain32: torch.Tensor, rss: torch.Tensor) -> torch.Tensor:
    """Per-element bound of |kernel - plain| for the selection's bf16
    tensor-core kernels (backward, and the prefill forward), against the
    plain version's unrounded f32 result from the same bf16 operands
    (sel_attn_bwd_rss, sel_attn_rss): one bf16 ulp of that value (the
    kernel's one rounding of its output, which may cross a power of two),
    F32_TOL of its max |value| (sum order), and TC_SIGMAS * 2^-9 * rss.
    The kernels round each P (O = P V / l, dV = P^T dO) and dS (dK = dS^T
    Q, dQ = dS K) to bf16 before the product, as the TPU kernels do: a
    relative error of either sign, at most 2^-8 and of standard deviation
    ~0.85 * 2^-9 over the mantissas. An element then moves by a sum of
    those errors, whose standard deviation is ~0.85 * 2^-9 * rss, rss the
    root sum of squares of the element's terms, so the last term allows
    ~4.7 of them, the ulp term more where the element is not a sum with
    heavy cancellation. A 1% error exceeds the bound wherever an element
    is not such a sum (phases (b), (d), (e) and (f) plant one in each)."""
    x = plain32.abs()
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return (torch.where(x > 0, ulp, torch.zeros_like(x)) + F32_TOL * float(x.max())
            + TC_SIGMAS * 2.0 ** -9 * rss)


def worst_ratio(got, want, bound) -> float:
    """max |got - want| / bound; `bound` a tensor, or a function of want."""
    b = bound if isinstance(bound, torch.Tensor) else bound(want)
    return float(((got.float() - want.float()).abs() / b).max())


def check(name, got, want, extra="", bound=allowed_err) -> float:
    """Holds a kernel's output against its plain version's (within `bound`:
    a tensor, or a function of the plain output); returns the max absolute
    error."""
    err = (got.float() - want.float()).abs()
    worst = worst_ratio(got, want, bound)
    max_err = float(err.max())
    dt = str(got.dtype).replace("torch.", "")
    print(f"[check] {name:18s} {dt:8s} max_abs_err={max_err:.3e} worst err/bound={worst:.3f}"
          f"{extra}")
    if not worst <= 1.0:
        fail(f"{name} {dt}: an element is {worst:.3f} x its bound")
    return max_err


def fwd_check(name, run, dtype, S_q: int, plain, rss, *, tc: bool, lse: bool, rows,
              chunk) -> float:
    """Holds a forward kernel `run()` (returning (O, lse) when `lse`) over
    S_q query rows against its plain version, after two launches that must
    give the same bits: within allowed_err of `plain(a, b)`, the plain O
    of rows [a, b); or, where `tc` (a bf16 tensor-core kernel, which rounds
    P to bf16 before P V, as the TPU kernels do), within allowed_tc_err of
    `rss(a, b)`, the plain version's unrounded f32 O and rss of those rows,
    where a FAULT planted in O must fail; lse within LSE_TOL of
    `plain(a, b, True)[1]`, with the same rows empty. rows = (r0, r1):
    hold only those query rows, `chunk` at a time. Returns the max
    absolute error of O."""
    got, again = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got if lse else (got,),
                                                  again if lse else (again,))):
        fail(f"{name} {dtype}: two launches differ")
    O, L_ = got if lse else (got, None)
    del again
    r0, r1 = rows or (0, S_q)
    worst = fault = max_err = lse_err = 0.0
    for a in range(r0, r1, chunk or r1 - r0):
        b = min(a + (chunk or r1 - r0), r1)
        if tc:
            want, err_rss = rss(a, b)
            bd = allowed_tc_err(want, err_rss)
            fault = max(fault, worst_ratio(O[:, a:b] * FAULT, want, bd))
            del err_rss
        else:
            want = plain(a, b)
            bd = allowed_err(want)
        worst = max(worst, worst_ratio(O[:, a:b], want, bd))
        max_err = max(max_err, float((O[:, a:b].float() - want.float()).abs().max()))
        del want, bd
        if lse:
            plse = plain(a, b, True)[1]
            empty = plse >= 1e29
            if not torch.equal(L_[:, a:b] >= 1e29, empty):
                fail(f"{name} lse: rows without a visible key differ from the plain version's")
            lse_err = max(lse_err, float(torch.where(empty, torch.zeros_like(plse),
                                                     (L_[:, a:b] - plse).abs()).max()))
    dt = str(dtype).replace("torch.", "")
    print(f"[check] {name:18s} {dt:8s} max_abs_err={max_err:.3e} worst err/bound={worst:.3f} "
          f"({'allowed_tc_err' if tc else 'allowed_err'} over rows [{r0}, {r1}))"
          + (f"; lse max_abs_err={lse_err:.3e} (bound {LSE_TOL:g})" if lse else "")
          + (f"; with a {FAULT - 1:.0%} fault planted in O: worst err/bound {fault:.3f} "
             f"(must exceed 1)" if tc else "") + "; two launches gave identical bits")
    if not worst <= 1.0:
        fail(f"{name} {dt}: an element is {worst:.3f} x its bound")
    if tc and not fault > 1.0:
        fail(f"{name}: a planted {FAULT - 1:.0%} fault passes the bf16 bound")
    if lse and not lse_err <= LSE_TOL:
        fail(f"{name} lse {dt}: error {lse_err:.3e} above {LSE_TOL:g}")
    return max_err


def sel_fwd_check(name, run, Q, K, V, sel, t, *, l_sel: int, scale: float, lse: bool = False,
                  rows=None, chunk=None) -> float:
    """fwd_check of the selection forward `run()` (sel_attn on Q, K, V,
    sel, t): f32 and decode against sel_attn_plain; the bf16 prefill (the
    union kernel, rounding P as sel_flash.py:157 does) against
    sel_attn_rss."""
    def part(a, b):
        return Q[:, a:b], K, V, sel[:, a:b], (t[a:b] if t.dim() == 1 else t[:, a:b])

    return fwd_check(name, run, Q.dtype, Q.shape[1],
                     lambda a, b, with_lse=False: sel_attn_plain(
                         *part(a, b), l_sel=l_sel, scale=scale, return_lse=with_lse),
                     lambda a, b: sel_attn_rss(*part(a, b), l_sel=l_sel, scale=scale),
                     tc=Q.dtype == torch.bfloat16 and Q.shape[1] > 1, lse=lse, rows=rows,
                     chunk=chunk)


def banded_fwd_check(name, run, Q, K, V, *, mode: str, kw: dict, scale: float,
                     lse: bool = False, rows=None, t_start: int = 0, seq_start=None,
                     chunk=None) -> float:
    """fwd_check of the banded forward `run()` (win_attn or banded_attn on
    Q, K, V over every row, row s at position t_start + s, in `mode` with
    kw: w, or l and d; under seq_start [B, S] if given): f32 (the FMA
    kernel) against banded_attn_plain;
    bf16 (the tensor-core kernel, rounding P as flash.py:213 and
    flash_diag.py:119 do) against banded_attn_rss. In window mode the plain
    version of rows [a, b) gets only the keys they can see, with positions
    shifted by as much (the dense scores of every 64k row would take 12.9
    GB); `chunk` rows a plain call if given."""
    def part(a, b):
        ds = None if seq_start is None else seq_start[:, a:b]
        if mode == "win":
            k0 = max(t_start + a - kw["w"] + 1, 0)
            return (Q[:, a:b], K[:, :, k0:], V[:, :, k0:], t_start + a - k0,
                    None if ds is None else ds - k0)
        return Q[:, a:b], K, V, t_start + a, ds

    def plain(a, b, with_lse=False):
        q, k, v, tp, ds = part(a, b)
        return banded_attn_plain(q, k, v, mode=mode, **kw, scale=scale, t_start=tp,
                                 return_lse=with_lse, seq_start=ds)

    def rss(a, b):
        q, k, v, tp, ds = part(a, b)
        return banded_attn_rss(q, k, v, mode=mode, **kw, scale=scale, t_start=tp, seq_start=ds)

    return fwd_check(name, run, Q.dtype, Q.shape[1], plain, rss,
                     tc=Q.dtype == torch.bfloat16, lse=lse, rows=rows, chunk=chunk)


def band_pairs(S_q: int, S_kv: int, mode: str, kw: dict) -> float:
    """Visible (query token, key) pairs of one (b, g, head) of the banded
    forward over positions 0..S_q-1."""
    t = torch.arange(S_q, dtype=torch.float64)
    if mode == "win":
        return float(torch.clamp(torch.clamp(t + 1, max=S_kv) - torch.clamp(t - kw["w"] + 1, min=0),
                                 min=0).sum())
    n = torch.where(t + 1 >= kw["l"], torch.div(t + 1 - kw["l"], kw["d"], rounding_mode="floor")
                    + 1, torch.zeros_like(t))
    return float(torch.clamp(n, max=S_kv).sum())


def band_fwd_tiles(label: str, run, iters: int) -> None:
    """The bf16 banded forward `run()` at q tiles of 64 and 128 rows
    (banded_attn.MMA_TILE_ROWS, replaced for this timing only): the
    kernel's time."""
    for rows in (64, 128):
        ba_mod.MMA_TILE_ROWS = rows
        try:
            ms = time_ms(run, iters, hold=True)
        finally:
            ba_mod.MMA_TILE_ROWS = MMA_TILE_ROWS
        print(f"[band fwd] {label}: q tile {rows} rows: {ms:.4f} ms"
              f"{' (the default)' if rows == MMA_TILE_ROWS else ''}")


def sel_work(sel, tp, l_sel: int, S_kv: int) -> tuple:
    """(visible (query row, key) pairs per head, distinct K/V rows read) of
    the selection forward on these inputs, from the sets alone: a dense
    [B,S,G,S_kv] mask would take 8.6 GB at 64k."""
    B_, S_ = sel.shape[:2]
    NB = -(-S_kv // l_sel)
    ids = canonicalize_sel(sel).long()
    t = tp.to(torch.int64).expand(B_, S_)[:, :, None, None]
    ok = (ids >= 0) & (ids < NB) & (ids * l_sel <= t)
    keys = torch.where(ok, torch.clamp(torch.clamp(t + 1, max=S_kv) - ids * l_sel, max=l_sel), 0)
    idx = torch.where(ok, ids, NB).transpose(1, 2).flatten(2)                  # [B,G,S*n]
    per = torch.zeros((B_, sel.shape[2], NB + 1), dtype=torch.int64, device=sel.device)
    per.scatter_reduce_(-1, idx, keys.transpose(1, 2).flatten(2), "amax")      # keys per block
    return float(keys.sum()), int(per[..., :NB].sum())


def sel_attn_row(name, q, k, v, s, tp, *, launches: int, max_err: float, iters: int = 20,
                 plain_rows=None, library: bool = True, gate=None) -> dict:
    """The JSON row of the selection forward on these inputs: kernel time
    (stream held), plain version's time (over every row, `plain_rows` a
    call if given), one SDPA call with the equivalent mask (`library`),
    and the bound from this run's inputs (under the fold: `gate`, [B,S,G]
    f32, an input of the kernel and its plain version)."""
    cfg = M7C_125M.nsa
    Dk, Dv, h = q.shape[-1], v.shape[-1], q.shape[3]
    sc = 1.0 / float(np.sqrt(Dk))
    kw = dict(l_sel=cfg.l_sel, scale=sc)
    if gate is not None:
        kw["gate"] = gate
    pairs, kv_rows = sel_work(s, tp, cfg.l_sel, k.shape[2])
    o = sel_attn(q, k, v, s, tp, **kw)
    tpb = tp.to(torch.int32).expand(q.shape[0], q.shape[1])
    bms, by = bound(nbytes(q, s, tpb, o, *(() if gate is None else (gate,)))
                    + kv_rows * (Dk + Dv) * k.element_size(), pairs * h * 2 * (Dk + Dv), q.dtype)
    del o
    if plain_rows is None:
        plain_ms = time_ms(lambda: sel_attn_plain(q, k, v, s, tp, **kw), 5, hold=True)
    else:
        plain_ms = time_ms(lambda: [sel_attn_plain(q[:, a:a + plain_rows], k, v,
                                                   s[:, a:a + plain_rows], tp[a:a + plain_rows],
                                                   **kw) for a in range(0, q.shape[1], plain_rows)],
                           1, 1, hold=True)
    lib_ms = None
    if library:
        try:
            mask = selection_token_mask(s, tp, cfg.l_sel, k.shape[2])
            sq, sk, sv, sm = sdpa_operands(q, k, v, mask)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm,
                                                                    scale=sc), 10, hold=True)
        except torch.cuda.OutOfMemoryError:
            print(f"[time] {name}: one SDPA call with the selection's mask ran out of memory")
        mask = sq = sk = sv = sm = None
    decode = q.shape[1] == 1
    src = "sel_attn" if decode or q.dtype != torch.bfloat16 else "sel_attn_fwd_mma"
    row = dict(
        name=name, source=f"nsa_vibe_tpu_torch/csrc/{src}.cu",
        replaces=("nsa_vibe_tpu/ops/pallas/selection.py:97" if decode
                  else "nsa_vibe_tpu/ops/pallas/sel_flash.py:227"),
        launches=launches, max_abs_err=max_err,
        ms=time_ms(lambda: sel_attn(q, k, v, s, tp, **kw), iters, hold=True),
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
    torch.cuda.empty_cache()
    return row


def sel_fwd_tiles(label: str, q, k, v, s, tp, iters: int) -> None:
    """The bf16 union forward at each q tile of Q_TILE_TOKENS (and the
    default tile at these inputs' h) on these inputs: the mean union size
    and the kernel's time."""
    cfg, h = M7C_125M.nsa, q.shape[3]
    kw = dict(l_sel=cfg.l_sel, scale=1.0 / float(np.sqrt(q.shape[-1])))
    for T in sorted({*Q_TILE_TOKENS, union_tile_tokens(h)}):
        _, count, _ = selection_tile_union(s, tp, cfg.l_sel, k.shape[2], T)
        sa_mod.union_tile_tokens = lambda h, T=T: T    # the wrapper's q tile, for this timing only
        try:
            ms = time_ms(lambda: sel_attn(q, k, v, s, tp, **kw), iters, hold=True)
        finally:
            sa_mod.union_tile_tokens = union_tile_tokens
        print(f"[sel fwd] {label}: union q tile {T} tokens ({T * h} rows): mean union "
              f"{float(count.float().mean()):.3f} blocks over {count.shape[2]} tiles per (b, g); "
              f"sel_attn {ms:.4f} ms{' (the default)' if T == union_tile_tokens(h) else ''}")
        del count
    torch.cuda.empty_cache()


def select_cmp_check(name, x, *, lse: bool) -> float:
    """select_cmp on x's Q, K_cmp (Kc), V_cmp (Vc) and M at the m7c
    settings: its sets against select_cmp_plain's, differing only on near
    ties (NEAR_TIE), with the forced slots in order, the same sets from two
    launches; O (and lse) by fwd_check (two launches identical), f32 (the
    FMA kernel) against select_cmp_plain within allowed_err, bf16 (the
    tensor-core kernel, rounding P before P V as scorer.py:388 does)
    against the plain version's unrounded f32 O within allowed_tc_err
    (banded_attn_rss in cmp mode), where a FAULT planted in O must fail; in
    bf16 O and lse are banded_attn's in cmp mode bit for bit (the same
    compressed-prefix walk). Returns the max absolute error of O."""
    cfg, sc = x["cfg"], x["scale"]
    Q, Kc, Vc, M = x["Q"], x["Kc"], x["Vc"], x["M"]
    kw = dict(scale=sc, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)
    sel_k = select_cmp(Q, Kc, Vc, M, **kw)[0]
    sel_2 = select_cmp(Q, Kc, Vc, M, **kw)[0]
    sel_p, _, p_grp = select_cmp_plain(Q, Kc, Vc, M, **kw, return_scores=True)
    torch.cuda.synchronize()
    n_diff, n_far, spread = near_tie_rows(sel_k, sel_p, p_grp)
    forced = torch.equal(sel_k[..., :3], sel_p[..., :3])
    print(f"[check] {name:18s} {str(Q.dtype)[6:]:8s} sel rows differing on near ties: {n_diff} "
          f"of {sel_k.shape[0] * sel_k.shape[1] * sel_k.shape[2]} (widest spread {spread:.3e}); "
          f"forced slots in order: {forced}; two launches gave identical sets: "
          f"{torch.equal(sel_k, sel_2)}")
    if n_far or not forced or not torch.equal(sel_k, sel_2):
        fail(f"{name} {Q.dtype}: {n_far} rows differ beyond the near-tie bound, or the forced "
             f"slots differ, or two launches differ")
    del sel_k, sel_2, sel_p, p_grp

    def run():
        out = select_cmp(Q, Kc, Vc, M, **kw, return_lse=lse)
        return out[1:] if lse else out[1]

    def plain(a, b, with_lse=False):   # every row: the fused scorer has no t_start
        out = select_cmp_plain(Q, Kc, Vc, M, **kw, return_lse=with_lse)
        return out[1:] if with_lse else out[1]

    err = fwd_check(name, run, Q.dtype, Q.shape[1], plain,
                    lambda a, b: banded_attn_rss(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d,
                                                 scale=sc),
                    tc=Q.dtype == torch.bfloat16, lse=lse, rows=None, chunk=None)
    if Q.dtype == torch.bfloat16:
        O, L_ = select_cmp(Q, Kc, Vc, M, **kw, return_lse=True)[1:]
        Ob, Lb = banded_attn(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d, scale=sc, return_lse=True)
        torch.cuda.synchronize()
        same = torch.equal(O, Ob) and torch.equal(L_, Lb)
        print(f"[check] {name}: O and lse bit-equal to banded_attn (cmp): {same}")
        if not same:
            fail(f"{name}: O or lse differ from banded_attn's in cmp mode")
    return err


def phase_kernels(dev) -> dict:
    """Returns per-kernel records: max_abs_err (bf16, the serving dtype) and
    the bf16 inputs for timing."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = kernel_inputs(dtype, dev, gen)
        cfg, sc = x["cfg"], x["scale"]
        kw = dict(scale=sc, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)
        e1 = select_cmp_check("select_cmp", x, lse=False)
        sel_k = select_cmp(x["Q"], x["Kc"], x["Vc"], x["M"], **kw)[0]
        # prefill selection on the scorer's own output (forced slots repeat)
        pre = (x["Q"], x["K"], x["V"], sel_k, x["t_pre"])
        e2 = sel_fwd_check("sel_attn@prefill", lambda: sel_attn(*pre, l_sel=cfg.l_sel, scale=sc),
                           *pre, l_sel=cfg.l_sel, scale=sc)
        dec = (x["Qd"], x["Kd"], x["Vd"], x["sel_dec"], x["t_dec"])
        e3 = sel_fwd_check("sel_attn@decode", lambda: sel_attn(*dec, l_sel=cfg.l_sel, scale=sc),
                           *dec, l_sel=cfg.l_sel, scale=sc)
        win = (x["Q"], x["Kw"], x["Vw"])
        e4 = banded_fwd_check("win_attn@serve", lambda: win_attn(*win, w=cfg.w, scale=sc), *win,
                              mode="win", kw=dict(w=cfg.w), scale=sc)
        rec = {"select_cmp": e1, "sel_attn@prefill": e2, "sel_attn@decode": e3,
               "win_attn": e4, "inputs": x, "sel": sel_k}
    return rec


def sdpa_operands(Q, K, V, mask=None):
    """[B,S,G,h,D] / [B,G,S_kv,D] / mask [B,S,G,S_kv] -> SDPA's [B,H,S,D]
    layout with K/V repeated per head and mask [B,H,S,S_kv]."""
    Bq, Sq, G, h, D = Q.shape
    q = Q.permute(0, 2, 3, 1, 4).reshape(Bq, G * h, Sq, D)
    k, v = K.repeat_interleave(h, dim=1), V.repeat_interleave(h, dim=1)
    m = None if mask is None else mask.permute(0, 2, 1, 3).repeat_interleave(h, dim=1)
    return q, k, v, m


def measure(rec, counts, decode_launches) -> list:
    """Times each kernel (bf16, serving shapes) beside its plain version and
    a library call; computes its bound from this run's inputs."""
    x, sel = rec["inputs"], rec["sel"]
    cfg, sc = x["cfg"], x["scale"]
    Q = x["Q"]
    out = []

    out.append(select_cmp_row("select_cmp", x, lse=False, launches=counts["select_cmp"],
                              max_err=rec["select_cmp"]))
    cmp_tiles("serve", x)

    # sel_attn at prefill and decode: per (b,s,g) the visible keys of its block set
    out.append(sel_attn_row("sel_attn@prefill", Q, x["K"], x["V"], sel, x["t_pre"],
                            launches=counts["sel_attn"] - decode_launches,
                            max_err=rec["sel_attn@prefill"]))
    out.append(sel_attn_row("sel_attn@decode", x["Qd"], x["Kd"], x["Vd"], x["sel_dec"],
                            x["t_dec"], launches=decode_launches, max_err=rec["sel_attn@decode"]))

    # win_attn: per row 2*min(w, t+1)*(Dk + Dv)
    win = (Q, x["Kw"], x["Vw"])
    out.append(band_row("win_attn", lambda: win_attn(*win, w=cfg.w, scale=sc), *win,
                        mode="win", kw=dict(w=cfg.w), lse=False, launches=counts["win_attn"],
                        max_err=rec["win_attn"], iters=20))
    print_rows(out)
    return out


def select_cmp_row(name, x, *, lse: bool, launches: int, max_err: float) -> dict:
    """The JSON row of the fused scorer on x's bf16 Q, Kc, Vc and M (with
    lse where `lse`; under x["ds"], packed documents, or at pos_offset
    x["t0"], where x has it):
    kernel time (stream held), the plain version's time, no library call
    (none computes a top-n block selection), and the bound from this run's
    inputs: Q, K_cmp, V_cmp, M (and seq_start), sel_idx, O (and lse) moved
    once, 2 (Dk + Dv + S_sel) FLOP per visible (row, compressed token)
    pair (the products S, P V and p M)."""
    cfg = x["cfg"]
    Q, Kc, Vc, M, ds, t0 = x["Q"], x["Kc"], x["Vc"], x["M"], x.get("ds"), x.get("t0", 0)
    Bq, S_q, G, h, Dk = Q.shape
    S_cmp, S_sel = M.shape
    kw = dict(scale=x["scale"], l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel,
              return_lse=lse, seq_start=ds, pos_offset=t0)
    if "gate" in x:   # the fold's gated row (phase (m))
        kw["gate"] = x["gate"]
    if ds is None and not t0:
        pairs = band_pairs(S_q, S_cmp, "cmp", dict(l=cfg.l, d=cfg.d)) * Bq * G * h
    else:
        pairs = float(banded_mask(S_q, S_cmp, mode="cmp", l=cfg.l, d=cfg.d, t_start=t0,
                                  device=Q.device, seq_start=ds).sum()) * G * h \
            * (1 if ds is not None else Bq)
    ops = pairs * 2 * (Dk + Vc.shape[3] + S_sel)
    bms, by = bound(nbytes(Q, Kc, Vc, M, *select_cmp(Q, Kc, Vc, M, **kw),
                           *(() if ds is None else (ds,)),
                           *(() if "gate" not in x else (x["gate"],))), ops, Q.dtype)
    return dict(
        name=name, source="nsa_vibe_tpu_torch/csrc/select_cmp_mma.cu",
        replaces="nsa_vibe_tpu/ops/pallas/scorer.py:436", launches=launches,
        max_abs_err=max_err, ms=time_ms(lambda: select_cmp(Q, Kc, Vc, M, **kw), 20, hold=True),
        plain_ms=time_ms(lambda: select_cmp_plain(Q, Kc, Vc, M, **kw), 5, hold=True),
        bound_ms=bms, bound_by=by, library_ms=None)


def cmp_tiles(label: str, x) -> None:
    """The bf16 fused scorer on x's inputs at CTAs of each size of MMA_ROWS
    (select_cmp.MMA_TILE_ROWS, replaced for this timing only): tokens a CTA,
    shared memory a CTA, the kernel's time, and whether its outputs have the
    default CTA's bits."""
    cfg, Q = x["cfg"], x["Q"]
    Dk, Dv, h, S_sel = Q.shape[-1], x["Vc"].shape[-1], Q.shape[3], x["M"].shape[1]
    kw = dict(scale=x["scale"], l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)
    args = (Q, x["Kc"], x["Vc"], x["M"])
    ref = select_cmp(*args, **kw)
    lib = kbuild.library()
    for rows in MMA_ROWS:
        sc_mod.MMA_TILE_ROWS = rows   # the wrapper's CTA, for this timing only
        try:
            got = select_cmp(*args, **kw)
            ms = time_ms(lambda: select_cmp(*args, **kw), 20, hold=True)
            tq = cmp_tile_plan(lib, h, Dk, Dv, S_sel)
        finally:
            sc_mod.MMA_TILE_ROWS = CMP_TILE_ROWS
        print(f"[sel] select_cmp CTAs of {rows} rows ({tq} tokens, "
              f"{lib.nsa_select_cmp_mma_smem_bytes(rows, tq, h, Dk, Dv, S_sel)} bytes of shared "
              f"memory) at the {label} shape: {ms:.4f} ms; sel_idx and O bit-equal to the "
              f"{CMP_TILE_ROWS}-row CTAs': {all(torch.equal(a, b) for a, b in zip(got, ref))}"
              f"{' (the default)' if rows == CMP_TILE_ROWS else ''}")


# the TPU kernel each banded forward row replaces (PERF.md's table, rows 3 and 5)
BAND_REPLACES = {"win": "nsa_vibe_tpu/ops/pallas/flash_diag.py:146",
                 "cmp": "nsa_vibe_tpu/ops/pallas/flash.py:325"}


def band_row(name, kernel, Q, K, V, *, mode: str, kw: dict, lse: bool, launches: int,
             max_err: float, iters: int, chunk=None, seq_start=None, t_start: int = 0,
             gate=None) -> dict:
    """The JSON row of the banded forward `kernel()` (win_attn or
    banded_attn on Q, K, V in `mode` with kw, row s at position t_start +
    s, under seq_start [B, S] if given; returning (O, lse) when `lse`): kernel time
    (stream held), the plain version's time over every row (`chunk` rows a
    call if given, each call with the keys its rows see), one SDPA call
    with the equivalent boolean mask (None where that call runs out of
    device memory), and the bound from this run's inputs: Q, K, V, O (and
    lse) moved once, 2 (Dk + Dv) FLOP per visible (row, key) pair. Under the
    fold `kernel` is the gated launch and `gate` [B,S,G] f32 its gate, an
    input of the plain version too."""
    Dk, Dv, h = Q.shape[-1], V.shape[-1], Q.shape[3]
    S_q, S_kv = Q.shape[1], K.shape[2]
    sc = 1.0 / float(np.sqrt(Dk))
    out = kernel()
    io = nbytes(Q, K, V, *(out if lse else (out,)), *(() if seq_start is None else (seq_start,)),
                *(() if gate is None else (gate,)))
    if seq_start is None and not t_start:
        pairs = band_pairs(S_q, S_kv, mode, kw) * Q.shape[0] * Q.shape[2] * h
    else:
        pairs = float(banded_mask(S_q, S_kv, mode=mode, **kw, t_start=t_start, device=Q.device,
                                  seq_start=seq_start).sum()) * Q.shape[2] * h \
            * (1 if seq_start is not None else Q.shape[0])
    bms, by = bound(io, pairs * 2 * (Dk + Dv), Q.dtype)
    del out

    def plain(a, b):
        t = t_start + a
        Kp, Vp, tp, ds = K, V, t, None if seq_start is None else seq_start[:, a:b]
        if mode == "win":
            k0 = max(t - kw["w"] + 1, 0)
            Kp, Vp, tp = K[:, :, k0:t_start + b], V[:, :, k0:t_start + b], t - k0
            ds = None if ds is None else ds - k0
        return banded_attn_plain(Q[:, a:b], Kp, Vp, mode=mode, **kw, scale=sc, t_start=tp,
                                 return_lse=lse, seq_start=ds,
                                 gate=None if gate is None else gate[:, a:b])

    step = chunk or S_q
    plain_ms = time_ms(lambda: [plain(a, min(a + step, S_q)) for a in range(0, S_q, step)],
                       3 if chunk is None else 1, 1, hold=True)
    lib_ms = None
    try:
        mask = banded_mask(S_q, S_kv, mode=mode, **kw, t_start=t_start, device=Q.device,
                           seq_start=seq_start)
        if mask.dim() == 3:   # [B, S, S_kv] -> [B, 1, S, S_kv], every head alike
            mask = mask[:, None]
        sq, sk, sv, _ = sdpa_operands(Q, K, V)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                                                scale=sc), 3, 1, hold=True)
    except torch.cuda.OutOfMemoryError:
        print(f"[time] {name}: one SDPA call with the [{S_q}, {S_kv}] mask ran out of memory")
    mask = sq = sk = sv = None
    torch.cuda.empty_cache()
    row = dict(
        name=name, source=f"nsa_vibe_tpu_torch/csrc/"
                          f"{'banded_fwd_mma' if Q.dtype == torch.bfloat16 else 'banded_attn'}.cu",
        replaces=BAND_REPLACES[mode], launches=launches, max_abs_err=max_err,
        ms=time_ms(kernel, iters, hold=True), plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms)
    return row


def print_rows(rows) -> None:
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[time] {r['name']:18s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"launches {r['launches']}  max_abs_err(bf16) {r['max_abs_err']:.3e}")


# ------------------------------------------------------------------ (c)

def layer_check(params, prompt, tokens, dev) -> None:
    """Layer 0 in f32: nsa_prefill and 4 nsa_decode_step calls on the card
    (kernels) against the same functions on CPU tensors (plain path), on
    the serve's own layer-0 inputs."""
    mcfg, cfg = M7C_125M, M7C_125M.nsa
    blk = params["blocks"][0]
    pg = params_to(blk["attn"], dtype=torch.float32)
    pc = params_to(blk["attn"], device="cpu", dtype=torch.float32)

    def layer_in(tok):
        return rmsnorm(params["embed"][tok].float(), blk["attn_norm"].float(), mcfg.rmsnorm_eps)

    x = layer_in(prompt)
    out_g, aux_g = nsa_prefill(pg, x, cfg)
    out_c, aux_c = nsa_prefill(pc, x.cpu(), cfg)
    differ = (canonicalize_sel(aux_g["sel_idx"].cpu()) != canonicalize_sel(aux_c["sel_idx"])
              ).any(-1).any(-1)                                        # [B,S]
    err = (out_g.cpu() - out_c).abs().amax(-1)                         # [B,S]
    worst = float(err[~differ].max())
    print(f"[layer] prefill f32 kernels vs plain: max_abs_err={worst:.3e} (bound {LAYER_TOL:g}) "
          f"over rows with equal selection; rows with a near-tie selection flip: "
          f"{int(differ.sum())} of {differ.numel()}")
    if not worst <= LAYER_TOL or differ.float().mean() > 1e-3:
        fail("layer prefill disagrees with the plain path")
    cg, cc = cache_from_prefill(cfg, aux_g, CAP), cache_from_prefill(cfg, aux_c, CAP)
    for i in range(4):
        xt = layer_in(tokens[:, S + i:S + i + 1])
        og, cg, ig = nsa_decode_step(pg, xt, cg, cfg)
        oc, cc, ic = nsa_decode_step(pc, xt.cpu(), cc, cfg)
        e = float((og.cpu() - oc).abs().max())
        want = expected_decode_reads(S + i + 1, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)
        same_sel = bool((ig.sel_idx.cpu() == ic.sel_idx).all())
        print(f"[layer] decode step t={S + i}: max_abs_err={e:.3e} reads_pred={ig.reads_pred} "
              f"(expected {want}) same selection: {same_sel}")
        if ig.reads_pred != want or ic.reads_pred != want:
            fail("decode read counters disagree with expected_decode_reads")
        if same_sel and not e <= LAYER_TOL:
            fail("layer decode disagrees with the plain path")


def phase_serve(dev, mcfg=M7C_125M, tag: str = "serve", label: str = "m7c-125M",
                layer: bool = True) -> dict:
    """m7c-125M (or `mcfg`, named `label`) serves B prompts of S tokens and
    N_NEW greedy tokens through `generate` (launch counts, timings, no host
    sync, traces; with `layer`, layer_check). Returns the launch counts and
    the decode launches of sel_attn, the parameters and the prompt."""
    gen = torch.Generator().manual_seed(0)
    params = init_model_params(mcfg, gen, device=dev)
    prompt = torch.randint(0, mcfg.vocab_size, (B, S), generator=gen).to(dev)
    n_params = sum(p.numel() for k, p in _leaves(params) if k != "W_qkv")
    print(f"[{tag}] {label}: {mcfg.n_layers} layers, dim {mcfg.nsa.dim}, "
          f"{n_params / 1e6:.1f} M parameters, {mcfg.dtype}")
    with torch.no_grad():
        generate(params, prompt, 2, mcfg, capacity=CAP)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        tokens = generate(params, prompt, N_NEW, mcfg, capacity=CAP)
        e1.record()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        decode_launches = sel_attn.decode_launches
        serve_ms = e0.elapsed_time(e1)
        peak = torch.cuda.max_memory_allocated()
        L = mcfg.n_layers
        want = {**dict.fromkeys(counts, 0), "select_cmp": L, "sel_attn": L + L * (N_NEW - 1),
                "win_attn": L}
        print(f"[{tag}] launches on the main path: {counts} "
              f"(sel_attn at decode: {decode_launches}); expected {want}")
        if counts != want:
            fail(f"launch counts {counts} != {want}")
        if tuple(tokens.shape) != (B, S + N_NEW) or not torch.equal(tokens[:, :S], prompt) \
                or int(tokens.min()) < 0 or int(tokens.max()) >= mcfg.vocab_size:
            fail("generate returned a malformed token tensor")
        logits, caches = model_prefill_with_caches(params, prompt, mcfg, CAP)
        if not bool(torch.isfinite(logits).all()):
            fail("prefill logits are not finite")
        prefill_ms = time_ms(lambda: model_prefill_with_caches(params, prompt, mcfg, CAP), 3, 1)
        tok = tokens[:, S:S + 1]
        t_host = time.perf_counter()
        e0.record()
        for i in range(N_NEW - 1):
            logits, caches = model_decode_step(params, tok, caches, mcfg)
            tok = tokens[:, S + i + 1:S + i + 2]
        e1.record()
        decode_host_ms = (time.perf_counter() - t_host) * 1e3 / (N_NEW - 1)
        torch.cuda.synchronize()
        decode_ms = e0.elapsed_time(e1) / (N_NEW - 1)
        if not bool(torch.isfinite(logits).all()):
            fail("decode logits are not finite")
        print(f"[{tag}] {B} requests x ({S} prompt + {N_NEW} new) tokens: generate "
              f"{serve_ms:.2f} ms, {B * N_NEW / (serve_ms / 1e3):.1f} new tokens/s")
        print(f"[{tag}] prefill {prefill_ms:.3f} ms ({B * S / (prefill_ms / 1e3):.0f} tokens/s); "
              f"decode {decode_ms:.4f} ms/token step ({B / (decode_ms / 1e3):.1f} tokens/s "
              f"over {B} rows), of which the host took {decode_host_ms:.4f} ms to issue")
        print(f"[{tag}] max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
        # the serving path never makes the host wait for the card
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, caches = model_prefill_with_caches(params, prompt, mcfg, CAP)
            model_decode_step(params, tokens[:, S:S + 1], caches, mcfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"[{tag}] prefill and decode step issued with no host-device synchronisation "
              "(torch.cuda.set_sync_debug_mode('error'))")
        if layer:
            layer_check(params, prompt, tokens, dev)
        trace(lambda: model_prefill_with_caches(params, prompt, mcfg, CAP), 1,
              "prefill" if tag == "serve" else f"{tag} prefill", prefill_ms)
        _, caches = model_prefill_with_caches(params, prompt, mcfg, CAP)
        trace(lambda: model_decode_step(params, tokens[:, S:S + 1], caches, mcfg), 3,
              "decode step" if tag == "serve" else f"{tag} decode step", decode_ms)
    return {"counts": counts, "decode_launches": decode_launches, "params": params,
            "prompt": prompt, "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def trace(fn, n: int, what: str, wall_ms: float = None) -> dict:
    """Device busy time of fn (mean of n calls) from torch.profiler: the sum
    of its kernels' durations, by kernel, beside the untraced wall time (or,
    if none is given, the traced calls' own). Returns {"busy": ms, "other":
    ms of the kernels that are not the port's, "calls": launches of each
    port kernel in the n calls}. The profiler drops the
    kernels whose converted times fall outside its window: without
    TRACE_PAD at each end, a traced m7c replay lost its last layer's
    kernels in about half the traces on the H100."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD)
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        if wall_ms is None:
            wall_ms = (time.perf_counter() - t) * 1e3 / n
        time.sleep(TRACE_PAD)
    by_name, calls = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            name = next((k for k in PORT_KERNELS if k in e.key), e.key[:48])
            by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3 / n
            calls[name] = calls.get(name, 0) + e.count
    busy = sum(by_name.values())
    if busy <= 0:
        fail(f"the profiler saw no device time for the {what}")
    port = {k: by_name.get(k, 0.0) for k in PORT_KERNELS}
    others = sorted(((v, k) for k, v in by_name.items() if k not in PORT_KERNELS), reverse=True)
    print(f"[trace] {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle share {1 - busy / wall_ms:.3f}); port kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in port.items())
          + f"; other kernels {busy - sum(port.values()):.3f} ms, largest: "
          + "; ".join(f"{k} {v:.3f} ms" for v, k in others[:3]))
    return {"busy": busy, "other": busy - sum(port.values()),
            "calls": {k: calls.get(k, 0) for k in PORT_KERNELS}}


# ------------------------------------------------------------------ (g)

def bf16_ulp(v: float) -> float:
    return float(2.0 ** (np.floor(np.log2(max(v, 2.0 ** -126))) - 7))


def ragged_decode_inputs(dtype, dev, gen) -> tuple:
    """One ragged decode step's selection operands (row 4 at the ragged
    shape): rows at positions RAGGED_LENS of a cache of capacity CAP, Q
    [4,1,G,h,D], K/V [4,G,CAP,D], sel [4,1,G,n] from random block scores,
    t [4,1]."""
    cfg = M7C_125M.nsa
    G, h, D, n_b = cfg.n_kv_groups, cfg.h_per_group, cfg.d_k, len(RAGGED_LENS)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    t = torch.tensor(RAGGED_LENS, device=dev)[:, None]
    p = torch.rand((n_b, 1, G, -(-CAP // cfg.l_sel)), generator=gen, device=dev)
    return (r(n_b, 1, G, h, D), r(n_b, G, CAP, D), r(n_b, G, CAP, D),
            select_topn_blocks(p, cfg.n_sel, t, cfg.l_sel), t)


def step_tick(params, mcfg, caches, tok, out, feed=None, k=None):
    """One decode tick for a DecodeGraph: the ragged step on the static
    token `tok` [B,1], its logits into `out` (at column k of [B,R,V] when k
    is given), then the next token: feed[:, k] (teacher forcing) or the
    greedy choice."""
    def tick():
        if feed is not None:
            tok.copy_(feed.gather(1, k.expand(tok.shape[0], 1)))
        lg, _ = model_decode_step_ragged(params, tok, caches, mcfg)
        if k is None:
            out.copy_(lg)
            tok.copy_(lg[:, -1:].argmax(-1))
        else:
            out.scatter_(1, k.view(1, 1, 1).expand(lg.shape), lg)
            k.add_(1)
    return tick


def eager_vs_uniform(params, mcfg, caches, solos, feed) -> int:
    """RAGGED_EAGER teacher-forced eager ragged steps of the admitted batch
    against each row's own uniform model_decode_step (B = 1): per layer the
    selection sets (differing only on near ties), the read counters (equal,
    and equal to expected_decode_reads), and the logits within LOGIT_ULPS
    bf16 ulps of the row's largest |logit| on rows whose selection agrees in
    every layer. Returns the ragged steps' split-kernel launches."""
    cfg, n_b = mcfg.nsa, len(RAGGED_LENS)
    ragged = []
    before = sel_attn.decode_launches
    for k in range(RAGGED_EAGER):
        infos = []
        lg, _ = model_decode_step_ragged(params, feed[:, k:k + 1], caches, mcfg, infos=infos)
        ragged.append((lg, infos))
    launches = sel_attn.decode_launches - before
    worst, flips, spread_max, n_cmp = 0.0, 0, 0.0, 0
    for i in range(n_b):
        for k, (lg, rinfo) in enumerate(ragged):
            uinfo = []
            lu, solos[i] = model_decode_step(params, feed[i:i + 1, k:k + 1], solos[i], mcfg,
                                             infos=uinfo)
            want = expected_decode_reads(RAGGED_LENS[i] + k + 1, cfg.l, cfg.d, cfg.l_sel,
                                         cfg.n_sel, cfg.w)
            flipped = False
            for r_, u_ in zip(rinfo, uinfo):
                n_diff, n_wide, spread = near_tie_rows(r_.sel_idx[i:i + 1], u_.sel_idx,
                                                       r_.p_grp[i:i + 1])
                if n_wide:
                    fail(f"ragged row {i} step {k}: selection differs from the uniform step "
                         f"beyond a near tie (score spread {spread:.3e})")
                flipped |= n_diff > 0
                flips += n_diff
                spread_max = max(spread_max, spread)
                got = [int(r_.reads_pred[i]), int(r_.reads_cmp[i]), int(r_.reads_win[i]),
                       int(r_.reads_actual_cmp[i]), int(r_.reads_actual_win[i])]
                exp = [u_.reads_pred, u_.reads_cmp, u_.reads_win, u_.reads_actual_cmp,
                       u_.reads_actual_win]
                if got != exp or u_.reads_pred != want or bool(r_.overflow[i]) \
                        or abs(float(r_.reads_actual_sel[i]) - float(u_.reads_actual_sel)) > 1e-3:
                    fail(f"ragged row {i} step {k}: read counters {got} != uniform {exp} "
                         f"(expected reads {want})")
            if not flipped:
                ratio = float((lg[i].float() - lu[0].float()).abs().max()) / (
                    LOGIT_ULPS * bf16_ulp(float(lu.float().abs().max())))
                worst = max(worst, ratio)
                n_cmp += 1
    print(f"[ragged] {RAGGED_EAGER} eager ragged steps (B={n_b}, rows at {RAGGED_LENS}) vs each "
          f"row's uniform step: read counters equal (and = expected_decode_reads); selection "
          f"flips {flips} (near ties, widest score spread {spread_max:.3e} <= {NEAR_TIE:g}); "
          f"logits worst {worst:.3f} of the bound ({LOGIT_ULPS} bf16 ulps of the row's max "
          f"|logit|) over {n_cmp} of {n_b * RAGGED_EAGER} row-steps with equal selection")
    if not worst <= 1.0:
        fail("ragged step logits disagree with the uniform step beyond the bf16 bound")
    return launches


def graph_vs_eager(params, mcfg, caches, feed, dev) -> int:
    """Phase (g)'s main path: the teacher-forced tick captured on the
    admitted batch, the launch counts set to 0 after capture, and
    RAGGED_REPLAYS replays traced, issued with no host sync while tensors
    allocated after capture stay untouched (what the tick allocated while
    captured, the split kernel's workspace included, stays in the graph's
    pool). A replay calls no wrapper: the counts must stay 0, and the trace
    must show the split decode kernel and its combine L times a replay.
    Then as many eager ticks from the same state: logits bit-equal.
    Returns the split kernel's launches in the traced replays."""
    n_b, V, L = len(RAGGED_LENS), mcfg.vocab_size, mcfg.n_layers
    tok = torch.zeros((n_b, 1), dtype=torch.int64, device=dev)
    out = torch.zeros((n_b, RAGGED_REPLAYS, V), dtype=torch_dtype(mcfg.dtype), device=dev)
    k = torch.zeros((1,), dtype=torch.int64, device=dev)
    state = [tok, out, k] + [x for c in caches for x in cache_tensors(c)]
    snap = [x.clone() for x in state]
    graph = DecodeGraph(step_tick(params, mcfg, caches, tok, out, feed, k), state)
    if not all(torch.equal(a, b) for a, b in zip(state, snap)):
        fail("capture moved its state")
    junk = [torch.full((1 << 22,), 7.0, device=dev) for _ in range(16)]      # 256 MB
    host_ms = []

    def replays():
        torch.cuda.set_sync_debug_mode("error")
        try:
            t_host = time.perf_counter()
            for _ in range(RAGGED_REPLAYS):
                graph.replay()
            host_ms.append((time.perf_counter() - t_host) * 1e3 / RAGGED_REPLAYS)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    kernels.reset_launch_counts()
    tr = trace(replays, 1, f"{RAGGED_REPLAYS} replays of the captured tick (admitted batch)")
    counts = dict(kernels.launch_counts(), **{"sel_attn@decode": sel_attn.decode_launches})
    split = tr["calls"]["sel_attn_split_kernel"]
    combine = tr["calls"]["sel_attn_combine_kernel"]
    print(f"[ragged] {RAGGED_REPLAYS} traced replays: split decode kernel {split}, combine "
          f"{combine} launches (expected {RAGGED_REPLAYS * L} each); wrapper counts "
          f"{counts} (expected all 0)")
    if split != RAGGED_REPLAYS * L or combine != RAGGED_REPLAYS * L or any(counts.values()):
        fail("the replays' launches differ from 12 split-kernel launches a replay")
    got = out.clone()
    if not all(bool((j == 7.0).all()) for j in junk):
        fail("a replay wrote into memory allocated after capture")
    del junk
    torch._foreach_copy_(state, snap)
    tick = step_tick(params, mcfg, caches, tok, out, feed, k)
    for _ in range(RAGGED_REPLAYS):
        tick()
    same = torch.equal(out, got)
    print(f"[ragged] {RAGGED_REPLAYS} replays with no host sync (set_sync_debug_mode('error'); "
          f"the host issued a traced replay in {host_ms[0]:.4f} ms), 256 MB allocated after "
          f"capture untouched; logits bit-equal to {RAGGED_REPLAYS} eager ragged steps: {same}")
    if not same or not bool(torch.isfinite(got).all()):
        fail("replayed logits differ from the eager ragged step's")
    return split


def serve_shape_times(params, mcfg, prompt, dev, tag: str = "ragged", iters: int = 20) -> dict:
    """At phase (c)'s shape (B=4 rows at 2048, capacity CAP): ms a step of
    the eager uniform step, the eager ragged step and the replayed graph
    (CUDA events, `iters` steps after 2), the host's issue time of a
    replay, and one traced replay's busy time, idle share and port-kernel
    launches."""
    L = mcfg.n_layers

    def fresh():
        logits, caches = model_prefill_with_caches(params, prompt, mcfg, CAP)
        return logits[:, -1:].argmax(-1), caches

    tok, caches = fresh()
    uni = time_ms(lambda: model_decode_step(params, tok, caches, mcfg), iters)
    tok, caches = fresh()
    caches = [ragged_cache(c) for c in caches]
    eager = time_ms(lambda: model_decode_step_ragged(params, tok, caches, mcfg), iters)
    tok, caches = fresh()
    caches = [ragged_cache(c) for c in caches]
    out = torch.empty((prompt.shape[0], 1, mcfg.vocab_size), dtype=torch_dtype(mcfg.dtype),
                      device=dev)
    graph = DecodeGraph(step_tick(params, mcfg, caches, tok, out),
                        [tok, out] + [x for c in caches for x in cache_tensors(c)])
    replay = time_ms(graph.replay, iters)
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    for _ in range(iters):
        graph.replay()
    host_ms = (time.perf_counter() - t_host) * 1e3 / iters
    tr = trace(graph.replay, 1, "replayed ragged decode step (serve)" if tag == "ragged"
               else f"{tag} replayed ragged decode step", replay)
    print(f"[{tag}] serve shape (B={prompt.shape[0]} at {prompt.shape[1]}, capacity {CAP}): "
          f"eager uniform step {uni:.4f} ms, eager ragged step {eager:.4f} ms, replayed graph "
          f"{replay:.4f} ms a step (host issue {host_ms:.4f} ms, mean of {iters}); split kernel "
          f"launches in one traced replay: {tr['calls']['sel_attn_split_kernel']} (combine "
          f"{tr['calls']['sel_attn_combine_kernel']}), expected {L}")
    if tr["calls"]["sel_attn_split_kernel"] != L or tr["calls"]["sel_attn_combine_kernel"] != L:
        fail("a replay does not launch the split decode kernel once a layer")
    return {"uniform_ms": uni, "eager_ms": eager, "replay_ms": replay, "busy": tr["busy"]}


def token_check(params, mcfg, prompt) -> None:
    """generate_scan's greedy tokens equal generate's at phase (c)'s shape;
    where they differ, the first differing step must be a near tie of the
    eager logits (top-2 gap within TIE_ULPS bf16 ulps of the max |logit|)."""
    S0 = prompt.shape[1]
    t0 = time.perf_counter()
    want = generate(params, prompt, N_NEW, mcfg, capacity=CAP)
    got = generate_scan(params, prompt, N_NEW, mcfg, capacity=CAP)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if got.shape != want.shape or not torch.equal(got[:, :S0], prompt):
        fail("generate_scan returned a malformed token tensor")
    if torch.equal(got, want):
        print(f"[ragged] generate_scan ({prompt.shape[0]} x ({S0} + {N_NEW})) tokens equal "
              f"generate's ({secs:.2f} s for both)")
        return
    cols = (got != want).any(0).nonzero()[:, 0]
    j = int(cols[0])
    row = int((got[:, j] != want[:, j]).nonzero()[0, 0])
    logits, caches = model_prefill_with_caches(params, prompt, mcfg, CAP)
    lg = logits[:, -1]
    for q in range(S0, j):
        lg = model_decode_step(params, want[:, q:q + 1], caches, mcfg)[0][:, -1]
    top = lg[row].float().topk(2).values
    gap = float(top[0] - top[1])
    lim = TIE_ULPS * bf16_ulp(float(lg[row].float().abs().max()))
    print(f"[ragged] generate_scan differs from generate first at new token {j - S0} of row "
          f"{row}: {int(got[row, j])} vs {int(want[row, j])}; eager top-2 logit gap {gap:.4e} "
          f"(near tie if <= {lim:.4e})")
    if gap > lim:
        fail("generate_scan's tokens differ from generate's beyond a near tie")


def first_gaps(params, mcfg, prompts, outs, alone) -> list:
    """For each row where generate_ragged's tokens (the prompt ingested by
    decode steps) and the row's own generate (prefill, then decode) differ:
    (row, first differing new token, the top-2 gap of generate's logits
    there, TIE_ULPS bf16 ulps of their max |logit|). In bf16 the two
    ingestions round differently over the whole prompt, so greedy tokens
    may part, but only at a near tie: the gap must be within the bound."""
    gaps = []
    for i, p in enumerate(prompts):
        diff = (outs[i] != alone[i]).nonzero()
        if diff.numel() == 0:
            continue
        m = int(diff[0, 0])
        logits, caches = model_prefill_with_caches(params, p, mcfg, p.shape[1] + N_NEW)
        lg = logits[0, -1]
        for q in range(m):
            lg = model_decode_step(params, alone[i][None, q:q + 1], caches, mcfg)[0][0, -1]
        top = lg.float().topk(2).values
        gaps.append((i, m, float(top[0] - top[1]),
                     TIE_ULPS * bf16_ulp(float(lg.float().abs().max()))))
    return gaps


def decode_sweep(params, mcfg, dev) -> None:
    """Graph-replayed m7c decode at each B of SWEEP_B and depth S of SWEEP_S:
    caches seeded with random values at t = S (a step reads the same bytes
    whatever they hold), ms a step (CUDA events, SWEEP_STEPS replays after 2),
    the eager ragged step's ms (5 steps after 1), and one traced replay's
    busy time."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for S_ in SWEEP_S:
        for B_ in SWEEP_B:
            caches = [ragged_cache(c)
                      for c in init_model_caches(mcfg, B_, S_ + 64, device=dev)]
            for c in caches:
                for x in cache_tensors(c)[:-1]:
                    x.normal_(generator=gen)
                c.t.fill_(S_)
            tok = torch.zeros((B_, 1), dtype=torch.int64, device=dev)
            out = torch.empty((B_, 1, mcfg.vocab_size), dtype=torch_dtype(mcfg.dtype),
                              device=dev)
            tick = step_tick(params, mcfg, caches, tok, out)
            eager = time_ms(tick, 5, 1)
            graph = DecodeGraph(tick, [tok, out] + [x for c in caches for x in cache_tensors(c)])
            ms = time_ms(graph.replay, SWEEP_STEPS)
            tr = trace(graph.replay, 1, f"replayed decode step B={B_} S={S_}", ms)
            if not bool(torch.isfinite(out).all()):
                fail(f"sweep logits not finite at B={B_} S={S_}")
            print(f"[sweep] B={B_} S={S_}: replayed {ms:.4f} ms a step, device busy "
                  f"{tr['busy']:.3f} ms (idle {1 - tr['busy'] / ms:.3f}); eager ragged step "
                  f"{eager:.4f} ms")
            del caches, graph, tick
            torch.cuda.empty_cache()


def phase_ragged(dev) -> list:
    """Phase (g): continuous batching and the replayed decode step at m7c
    (bf16, 12 layers). Returns the JSON row of the selection decode kernel
    (row 4) at the ragged shape."""
    t0 = time.perf_counter()
    mcfg, cfg, L = M7C_125M, M7C_125M.nsa, M7C_125M.n_layers
    n_b, V = len(RAGGED_LENS), mcfg.vocab_size
    gen = torch.Generator().manual_seed(0)
    params = init_model_params(mcfg, gen, device=dev)
    serve_prompt = torch.randint(0, V, (B, S), generator=gen).to(dev)     # phase (c)'s prompt
    gen = torch.Generator().manual_seed(21)
    prompts = [torch.randint(0, V, (1, n), generator=gen).to(dev) for n in RAGGED_LENS]
    feed = torch.randint(0, V, (n_b, RAGGED_REPLAYS), generator=gen).to(dev)
    with torch.no_grad():
        # admission: each prompt prefilled alone (B = 1), installed as row i
        kernels.reset_launch_counts()
        solos = [model_prefill_with_caches(params, p, mcfg, CAP)[1] for p in prompts]
        caches = [ragged_cache(c) for c in init_model_caches(mcfg, n_b, CAP, device=dev)]
        ptrs = [x.data_ptr() for c in caches for x in cache_tensors(c)]
        for i, solo in enumerate(solos):
            for c, s in zip(caches, solo):
                admit_row(c, s, i)
        if [x.data_ptr() for c in caches for x in cache_tensors(c)] != ptrs \
                or any(c.t.tolist() != list(RAGGED_LENS) for c in caches):
            fail("admit_row did not install the rows in place")
        admitted = [x.clone() for c in caches for x in cache_tensors(c)]
        pre = kernels.launch_counts()
        eager = eager_vs_uniform(params, mcfg, caches, solos, feed)
        print(f"[ragged] launches: admission prefills {pre}; split decode kernel in the "
              f"{RAGGED_EAGER} eager ragged steps {eager}")
        if pre != {**dict.fromkeys(pre, 0), "select_cmp": n_b * L, "sel_attn": n_b * L,
                   "win_attn": n_b * L} or eager != RAGGED_EAGER * L:
            fail("phase (g) launch counts differ from the path's")
        del solos
        torch._foreach_copy_([x for c in caches for x in cache_tensors(c)], admitted)
        decode = graph_vs_eager(params, mcfg, caches, feed, dev)
        del caches, admitted
        times = serve_shape_times(params, mcfg, serve_prompt, dev)
        token_check(params, mcfg, serve_prompt)
        padded = torch.zeros((n_b, max(RAGGED_LENS)), dtype=torch.int64, device=dev)
        for i, p in enumerate(prompts):
            padded[i, :p.shape[1]] = p[0]
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        outs = generate_ragged(params, padded, list(RAGGED_LENS), N_NEW, mcfg)
        torch.cuda.synchronize()
        t_r = time.perf_counter() - t_r
        if tuple(outs.shape) != (n_b, N_NEW) or int(outs.min()) < 0 or int(outs.max()) >= V:
            fail("generate_ragged returned a malformed token tensor")
        alone = [generate(params, p, N_NEW, mcfg)[0, p.shape[1]:] for p in prompts]
        agree = [int((outs[i] == a).sum()) for i, a in enumerate(alone)]
        gaps = first_gaps(params, mcfg, prompts, outs, alone)
        print(f"[ragged] generate_ragged: {n_b} prompts of {RAGGED_LENS} tokens + {N_NEW} new "
              f"each in {t_r:.2f} s ({max(RAGGED_LENS) + N_NEW - 1} replays); tokens equal to "
              f"each row's own generate (B=1, prefill + decode): {agree} of {N_NEW}; first "
              f"differences (row, new token, top-2 gap, near-tie bound): {gaps}")
        if any(gap > lim for _, _, gap, lim in gaps):
            fail("generate_ragged's tokens differ from generate's beyond a near tie")
        decode_sweep(params, mcfg, dev)
        # row 4 at the ragged shape, against its plain version
        kgen = torch.Generator(device=dev).manual_seed(4321)
        err = {}
        for dtype in (torch.float32, torch.bfloat16):
            args = ragged_decode_inputs(dtype, dev, kgen)
            err[dtype] = sel_fwd_check("sel_attn@ragged",
                                       lambda: sel_attn(*args, l_sel=cfg.l_sel,
                                                        scale=1.0 / float(np.sqrt(cfg.d_k))),
                                       *args, l_sel=cfg.l_sel,
                                       scale=1.0 / float(np.sqrt(cfg.d_k)))
        row = sel_attn_row("sel_attn@ragged", *args, launches=decode,
                           max_err=err[torch.bfloat16])
        print_rows([row])
    print(f"[ragged] phase (g): {time.perf_counter() - t0:.1f} s; serve shape {times}")
    return [row]


# ------------------------------------------------------------------ (d)

def train_kernel_inputs(dtype, dev, gen, cfg=None, rows: int = 0, seq: int = 0,
                        tag: str = "train", chunk=None, heads: int = 0) -> dict:
    """Branch operands at the m7c training shapes (or `cfg`'s, rows x seq,
    checks named <kernel>@`tag`) and their forward outputs with row
    statistics, from the kernels; the lse are held to their plain
    versions'. Where a plain version's dense scores over every row would
    not fit the card (16k), `chunk` query rows a plain forward call and
    `heads` heads a plain backward call (x["heads"], read by bwd_calls and
    tc_bounds)."""
    cfg, Bq, Sq = cfg or M7C_125M.nsa, rows or B_TRAIN, seq or S
    G, h, D = cfg.n_kv_groups, cfg.h_per_group, cfg.d_k
    meta = build_block_meta(Sq, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    x = dict(cfg=cfg, scale=1.0 / float(np.sqrt(D)), t=torch.arange(Sq, device=dev),
             Q=r(Bq, Sq, G, h, D), dO=r(Bq, Sq, G, h, D),
             Kc=r(Bq, G, meta.S_cmp, D), Vc=r(Bq, G, meta.S_cmp, D),
             K=r(Bq, G, Sq, D), V=r(Bq, G, Sq, D),
             Kw=r(Bq, G, Sq, D), Vw=r(Bq, G, Sq, D),
             M=torch.from_numpy(meta.M_csl).to(dev), heads=heads)
    kw = dict(scale=x["scale"], l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)
    x["sel"], x["Oc"], x["lse_c"] = select_cmp(x["Q"], x["Kc"], x["Vc"], x["M"], **kw,
                                               return_lse=True)
    x["cmp_fwd_err"] = select_cmp_check(f"select_cmp@{tag}", x, lse=True)
    x["Os"], x["lse_s"] = sel_attn(x["Q"], x["K"], x["V"], x["sel"], x["t"], l_sel=cfg.l_sel,
                                   scale=x["scale"], return_lse=True)
    sargs = (x["Q"], x["K"], x["V"], x["sel"], x["t"])
    x["sel_fwd_err"] = sel_fwd_check(
        f"sel_attn@{tag}", lambda: sel_attn(*sargs, l_sel=cfg.l_sel, scale=x["scale"],
                                            return_lse=True),
        *sargs, l_sel=cfg.l_sel, scale=x["scale"], lse=True, chunk=chunk)
    x["Ow"], x["lse_w"] = win_attn(x["Q"], x["Kw"], x["Vw"], w=cfg.w, scale=x["scale"],
                                   return_lse=True)
    wargs = (x["Q"], x["Kw"], x["Vw"])
    x["win_fwd_err"] = banded_fwd_check(
        f"win_attn@{tag}", lambda: win_attn(*wargs, w=cfg.w, scale=x["scale"], return_lse=True),
        *wargs, mode="win", kw=dict(w=cfg.w), scale=x["scale"], lse=True, chunk=chunk)
    if chunk:   # fwd_check above held the lse of every row, chunk rows at a time
        return x
    plain = {   # select_cmp's lse: select_cmp_check above
        "sel_attn": sel_attn_plain(x["Q"], x["K"], x["V"], x["sel"], x["t"], l_sel=cfg.l_sel,
                                   scale=x["scale"], return_lse=True)[1],
        "win_attn": win_attn_plain(x["Q"], x["Kw"], x["Vw"], w=cfg.w, scale=x["scale"],
                                   return_lse=True)[1],
    }
    for name, key in (("sel_attn", "lse_s"), ("win_attn", "lse_w")):
        got, want = x[key], plain[name]
        empty = want >= 1e29
        if not torch.equal(got >= 1e29, empty):
            fail(f"{name} lse: rows without a visible key differ from the plain version's")
        err = float(torch.where(empty, torch.zeros_like(got), (got - want).abs()).max())
        print(f"[check] {name + ' lse':18s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
              f"(bound {LSE_TOL:g}); rows without a visible key: {int(empty.sum())}")
        if not err <= LSE_TOL:
            fail(f"{name} lse {dtype}: error {err:.3e} above {LSE_TOL:g}")
    return x


# the TPU kernel each backward kernel replaces (PERF.md's table, rows 7-11)
BWD_REPLACES = {"banded_bwd_1p": "nsa_vibe_tpu/ops/pallas/flash_bwd.py:479",
                "banded_bwd": "nsa_vibe_tpu/ops/pallas/flash_bwd.py:664",
                "sel_attn_bwd_1p": "nsa_vibe_tpu/ops/pallas/sel_flash.py:843",
                "sel_attn_bwd": "nsa_vibe_tpu/ops/pallas/sel_flash.py:537",
                "win_bwd_diag": "nsa_vibe_tpu/ops/pallas/flash_diag.py:354"}
# the source of each backward kernel row's bf16 kernel (the one timed)
BWD_SOURCE = {"banded_bwd_1p": "banded_bwd_mma.cu", "banded_bwd": "banded_bwd_mma.cu",
              "sel_attn_bwd_1p": "sel_attn_bwd_1p.cu", "sel_attn_bwd": "sel_attn_bwd.cu",
              "win_bwd_diag": "banded_bwd_mma.cu"}
TWO_PASS = ("banded_bwd@win", "banded_bwd@cmp", "sel_attn_bwd")          # phase (d)
# phase (f): the one-pass and diagonal kernels, each with the other designs
# of the same function it is held against
PARTNERS = {"banded_bwd_1p@win": ("banded_bwd@win",), "banded_bwd_1p@cmp": ("banded_bwd@cmp",),
            "sel_attn_bwd_1p": ("sel_attn_bwd",),
            "win_bwd_diag": ("banded_bwd_1p@win", "banded_bwd@win")}
# the rows whose bf16 kernel runs on tensor cores, rounding P and dS to bf16
# before their products as the TPU kernels do: held to allowed_tc_err (every
# backward row since row 8's redesign)
TC_ROWS = ("sel_attn_bwd", "sel_attn_bwd_1p", "banded_bwd_1p@win", "banded_bwd_1p@cmp",
           "win_bwd_diag", "banded_bwd@win", "banded_bwd@cmp")
# bf16 pairs that form P and dS with the same instructions
# (banded_bwd_mma.cu::p_and_ds: rows 7, 8 and 11) and differ in summation
# order only: held to each other by allowed_rel_err; other pairs by the
# kernel's own bound
SAME_P_DS = {("win_bwd_diag", "banded_bwd_1p@win"), ("win_bwd_diag", "banded_bwd@win"),
             ("banded_bwd_1p@win", "banded_bwd@win"), ("banded_bwd_1p@cmp", "banded_bwd@cmp")}


def branch_of(name: str) -> str:
    """'win', 'cmp' or 'sel': the branch a backward kernel row serves."""
    if name.endswith("@cmp"):
        return "cmp"
    return "sel" if name.startswith("sel") else "win"


def bwd_calls(x) -> dict:
    """name -> (kernel call, plain call, visibility mask [B,S,G,S_kv]) of
    each backward kernel on the inputs of train_kernel_inputs; the designs
    of one function share its plain version and mask."""
    cfg, sc = x["cfg"], x["scale"]
    Q, dO = x["Q"], x["dO"]
    Bq, S, G = Q.shape[:3]
    dc, ds_, dw = (attention_delta(dO, x[k]) for k in ("Oc", "Os", "Ow"))
    win = dict(mode="win", w=cfg.w, scale=sc)
    cmp_ = dict(mode="cmp", l=cfg.l, d=cfg.d, scale=sc)
    sel = dict(l_sel=cfg.l_sel, scale=sc)
    wargs = (Q, x["Kw"], x["Vw"], dO, x["lse_w"], dw)
    cargs = (Q, x["Kc"], x["Vc"], dO, x["lse_c"], dc)
    sargs = (Q, x["K"], x["V"], x["sel"], x["t"], dO, x["lse_s"], ds_)
    S_cmp = x["Kc"].shape[2]

    def win_mask():
        return banded_mask(S, S, mode="win", w=cfg.w, device=Q.device)[None, :, None, :].expand(
            Bq, S, G, S)

    def cmp_mask():
        return banded_mask(S, S_cmp, mode="cmp", l=cfg.l, d=cfg.d,
                           device=Q.device)[None, :, None, :].expand(Bq, S, G, S_cmp)

    def sel_mask():
        return selection_token_mask(x["sel"], x["t"], cfg.l_sel, S)

    def win_plain():
        return by_heads(banded_bwd_plain, wargs, BAND_HEAD_ARGS, x.get("heads", 0), **win)

    def cmp_plain():
        return by_heads(banded_bwd_plain, cargs, BAND_HEAD_ARGS, x.get("heads", 0), **cmp_)

    def sel_plain():
        return by_heads(sel_attn_bwd_plain, sargs, SEL_HEAD_ARGS, x.get("heads", 0), **sel)

    return {
        "banded_bwd@win": (lambda: banded_bwd(*wargs, **win), win_plain, win_mask),
        "banded_bwd@cmp": (lambda: banded_bwd(*cargs, **cmp_), cmp_plain, cmp_mask),
        "sel_attn_bwd": (lambda: sel_attn_bwd(*sargs, **sel), sel_plain, sel_mask),
        "banded_bwd_1p@win": (lambda: banded_bwd_1p(*wargs, **win), win_plain, win_mask),
        "banded_bwd_1p@cmp": (lambda: banded_bwd_1p(*cargs, **cmp_), cmp_plain, cmp_mask),
        "sel_attn_bwd_1p": (lambda: sel_attn_bwd_1p(*sargs, **sel), sel_plain, sel_mask),
        "win_bwd_diag": (lambda: win_bwd_diag(*wargs, w=cfg.w, scale=sc),
                         win_plain, win_mask),
    }


# the arguments with a head axis (Q, dO, lse, delta) of banded_bwd_plain /
# banded_bwd_rss and of sel_attn_bwd_plain / sel_attn_bwd_rss
BAND_HEAD_ARGS, SEL_HEAD_ARGS = (0, 3, 4, 5), (0, 5, 6, 7)


def by_heads(fn, args, head_args, per: int, **kw):
    """A plain backward fn(*args, **kw) -> (dQ, dK, dV) computed `per` heads
    a call (all at once where per is 0): dQ of each slice in place, dK and
    dV summed over the slices in f32 (each head's keys see its own rows
    only). With an rss fn, ((dQ, dK, dV), (rQ, rK, rV)): the root sums of
    squares add in quadrature."""
    h = args[0].shape[3]
    if not per or per >= h:
        return fn(*args, **kw)
    parts = [fn(*(a[:, :, :, i:i + per] if j in head_args else a for j, a in enumerate(args)),
                **kw) for i in range(0, h, per)]

    def join(grads, square=False):
        dq = torch.cat([g[0] for g in grads], dim=3)
        if square:
            return (dq, *(sum(g[k].float() ** 2 for g in grads).sqrt() for k in (1, 2)))
        return (dq, *(sum(g[k].float() for g in grads).to(grads[0][k].dtype) for k in (1, 2)))

    if isinstance(parts[0][0], tuple):   # an rss fn: (gradients, root sums of squares)
        return join([p[0] for p in parts]), join([p[1] for p in parts], square=True)
    return join(parts)


def tc_bounds(x, branch: str) -> tuple:
    """The plain backward's unrounded f32 gradients of `branch` ('sel', 'win'
    or 'cmp') from the bf16 inputs of train_kernel_inputs (x["heads"] heads
    a call), and allowed_tc_err of each."""
    cfg, dO, sc, per = x["cfg"], x["dO"], x["scale"], x.get("heads", 0)
    if branch == "sel":
        want, rss = by_heads(sel_attn_bwd_rss, (x["Q"], x["K"], x["V"], x["sel"], x["t"], dO,
                                                x["lse_s"], attention_delta(dO, x["Os"])),
                             SEL_HEAD_ARGS, per, l_sel=cfg.l_sel, scale=sc)
    elif branch == "win":
        want, rss = by_heads(banded_bwd_rss, (x["Q"], x["Kw"], x["Vw"], dO, x["lse_w"],
                                              attention_delta(dO, x["Ow"])),
                             BAND_HEAD_ARGS, per, mode="win", w=cfg.w, scale=sc)
    else:
        want, rss = by_heads(banded_bwd_rss, (x["Q"], x["Kc"], x["Vc"], dO, x["lse_c"],
                                              attention_delta(dO, x["Oc"])),
                             BAND_HEAD_ARGS, per, mode="cmp", l=cfg.l, d=cfg.d, scale=sc)
    return want, tuple(allowed_tc_err(w, r) for w, r in zip(want, rss))


def phase_train_kernels(dev, names, seed: int = 4321, **shape) -> dict:
    """The named backward kernels vs plain at the training shapes (or
    `shape`: train_kernel_inputs' cfg, rows, seq, tag), f32 then bf16; each
    twice for identical bits, and against the other designs of its
    function (PARTNERS) on the same inputs. The bf16 kernels on tensor
    cores (TC_ROWS) are held to allowed_tc_err against the plain version's
    unrounded result, and a FAULT planted in each of their gradients must
    fail it; a pair of SAME_P_DS is held to allowed_rel_err. Returns the
    bf16 inputs and the bf16 max errors."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = train_kernel_inputs(dtype, dev, gen, **shape)
        calls = bwd_calls(x)
        tc_refs = {}
        for name in names:
            kern, plain, _ = calls[name]
            got, again = kern(), kern()
            tc = dtype == torch.bfloat16 and name in TC_ROWS
            if tc:
                if branch_of(name) not in tc_refs:
                    tc_refs[branch_of(name)] = tc_bounds(x, branch_of(name))
                want, bounds = tc_refs[branch_of(name)]
            else:
                want, bounds = plain(), (allowed_rel_err,) * 3
            torch.cuda.synchronize()
            errs = [check(f"{name}:{n}", g, w, bound=bd)
                    for n, g, w, bd in zip(("dQ", "dK", "dV"), got, want, bounds)]
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{name} {dtype}: two launches differ")
            if tc:
                faults = [worst_ratio(g * FAULT, w, bd) for g, w, bd in zip(got, want, bounds)]
                print(f"[check] {name} bf16 with a {FAULT - 1:.0%} fault planted in dQ, dK, dV: "
                      f"worst err/bound {', '.join(f'{v:.3f}' for v in faults)} (each must "
                      f"exceed 1)")
                if not min(faults) > 1.0:
                    fail(f"{name}: a planted {FAULT - 1:.0%} fault passes the bf16 bound")
            for other in PARTNERS.get(name, ()):
                theirs = calls[other][0]()
                tight = tc and (name, other) in SAME_P_DS
                for n, g, w, bd in zip(("dQ", "dK", "dV"), got, theirs,
                                       (allowed_rel_err,) * 3 if tight else bounds):
                    check(f"{name}:{n} vs {other}", g, w, bound=bd)
                if tight:
                    print(f"[check] {name} vs {other}: bit-equal dQ, dK, dV "
                          f"{[bool(torch.equal(g, w)) for g, w in zip(got, theirs)]}")
                del theirs
            rec[name] = max(errs)
            del got, again, want
        del tc_refs
        print(f"[check] backward kernels {', '.join(names)} {str(dtype)[6:]}: two launches "
              f"gave identical bits")
        if dtype == torch.bfloat16:
            rec["inputs"] = x
        del x, calls
        torch.cuda.empty_cache()
    return rec


def launches_of(counts: dict, name: str) -> int:
    """A backward kernel row's launches in one train-step run's counts."""
    base, _, mode = name.partition("@")
    if mode == "cmp":
        return counts[f"{base}@cmp"]
    return counts[base] - counts.get(f"{base}@cmp", 0)


def chunk_spread(cnt, tq: int, per: int, nsplit: int) -> tuple:
    """Chunks of tq tokens per CTA of the selection's kv-major pass, from
    its member counts cnt [B,G,NB], over the CTAs with work: (max, mean)
    under a split of each block's members into nsplit contiguous shares
    (the former scheme, kv_splits per block), then (max, mean) under the
    work items of `per` tokens."""
    c = cnt.reshape(-1).long()
    share = -(-(-(-c // nsplit)) // tq) * tq
    s = torch.arange(nsplit, device=c.device)
    toks = (torch.minimum(c[:, None], (s + 1) * share[:, None]) - s * share[:, None]).clamp(min=0)
    before = -(-toks[toks > 0] // tq)
    full = (c // per).sum()
    rest = c % per
    after = torch.cat([torch.full((int(full),), per // tq, device=c.device),
                       -(-rest[rest > 0] // tq)])
    return (int(before.max()), float(before.float().mean()), int(after.max()),
            float(after.float().mean()))


def phase_sel_tiles(x) -> None:
    """The selection backward's work at the train shape (bf16 inputs of
    train_kernel_inputs): the kv-major pass's chunks per CTA before and
    after the work items; then, for each q tile of Q_TILE_TOKENS (and the
    default tile at these inputs' h), the mean
    union size of the two-pass dQ kernel and the device time of
    sel_attn_bwd with that tile (the kv pass is the same in each: the
    differences are the dQ kernel's)."""
    cfg, h = x["cfg"], x["cfg"].h_per_group
    Q, K = x["Q"], x["K"]
    B_, S_, G_ = Q.shape[:3]
    _, _, cnt, _ = selection_index(x["sel"], x["t"], cfg.l_sel, S_)
    NB = cnt.shape[-1]
    tq = kbuild.library().nsa_sel_attn_bwd_kv_rows(1, cfg.d_k, cfg.d_v) // h
    nsplit = kv_splits(Q.device, B_ * G_ * NB * -(-cfg.l_sel // 64), 8)
    bmax, bmean, amax, amean = chunk_spread(cnt, tq, tq * CHUNKS_PER_ITEM, nsplit)
    print(f"[sel] kv-major chunks ({tq} tokens) per CTA: {nsplit} splits per block max "
          f"{bmax} mean {bmean:.2f} (max/mean {bmax / bmean:.2f}); work items of "
          f"{CHUNKS_PER_ITEM} chunks max {amax} mean {amean:.2f} (max/mean {amax / amean:.2f})")
    args = (Q, K, x["V"], x["sel"], x["t"], x["dO"], x["lse_s"], attention_delta(x["dO"], x["Os"]))
    default = union_tokens(h)
    for T in sorted({*Q_TILE_TOKENS, default}):
        _, count, _ = selection_tile_union(x["sel"], x["t"], cfg.l_sel, S_, T)
        sb_mod.union_tokens = lambda h, T=T: T     # the wrapper's q tile, for this timing only
        try:
            ms = time_ms(lambda: sel_attn_bwd(*args, l_sel=cfg.l_sel, scale=x["scale"]), 10,
                         hold=True)
        finally:
            sb_mod.union_tokens = union_tokens
        print(f"[sel] union dQ q tile {T} tokens ({T * h} rows): mean union "
              f"{float(count.float().mean()):.3f} "
              f"blocks over {-(-S_ // T)} tiles per (b, g); "
              f"sel_attn_bwd {ms:.4f} ms{' (the default)' if T == default else ''}")


def phase_band_bwd_tiles(x) -> None:
    """The bf16 banded backward's work at the train shape (inputs of
    train_kernel_inputs): the one-pass kernel's CTAs and chunks of band rows
    per CTA in each mode (split_shares, mma_plan); the diagonal window
    kernel's device time and strip bytes at each q tile of DIAG_TILE_ROWS,
    and the two-pass design's (row 8) in each mode at each q tile of its dQ
    kernel, MMA_ROWS, and whether their dQ has the default tile's bits
    (their key tiles sit at multiples of 64, so a row's dQ sums the same
    tiles under any q tile)."""
    cfg, Q = x["cfg"], x["Q"]
    B_, S_, G_, h = Q.shape[:4]
    lib = kbuild.library()
    for mode, K, kw in (("win", x["Kw"], dict(w=cfg.w)), ("cmp", x["Kc"], dict(l=cfg.l, d=cfg.d))):
        S_kv = K.shape[2]
        rows, nsplit = mma_plan(lib, Q.device, B_, S_, S_kv, G_, h, cfg.d_k, cfg.d_v)
        shares = split_shares(S_, S_kv, h, mode=mode, **kw, rows=rows, nsplit=nsplit)
        chunks = [-(-(rb - ra) // rows) for tile in shares for ra, rb in tile if rb > ra]
        print(f"[band] banded_bwd_1p {mode} bf16: {len(shares)} key tiles x {nsplit} splits x "
              f"{B_ * G_} (b, g) = {len(shares) * nsplit * B_ * G_} CTAs; chunks of {rows} band "
              f"rows per CTA with rows: max {max(chunks)} mean "
              f"{sum(chunks) / len(chunks):.2f}; CTAs without rows "
              f"{(len(shares) * nsplit - len(chunks)) * B_ * G_}")
    args = (Q, x["Kw"], x["Vw"], x["dO"], x["lse_w"], attention_delta(x["dO"], x["Ow"]))
    default = wd_mod.MMA_TILE_ROWS
    ref = win_bwd_diag(*args, w=cfg.w, scale=x["scale"])
    for rows in DIAG_TILE_ROWS:
        wd_mod.MMA_TILE_ROWS = rows   # the wrapper's q tile, for this timing only
        try:
            got = win_bwd_diag(*args, w=cfg.w, scale=x["scale"])
            ms = time_ms(lambda: win_bwd_diag(*args, w=cfg.w, scale=x["scale"]), 10, hold=True)
            tq, sl, strip = wd_mod.tile_plan(lib, Q.dtype, B_, S_, S_, G_, h, cfg.d_k, cfg.d_v,
                                             cfg.w)
        finally:
            wd_mod.MMA_TILE_ROWS = default
        print(f"[band] win_bwd_diag q tile {rows} rows ({tq} tokens): {ms:.4f} ms; strips "
              f"{strip} bytes ({sl} keys a tile); dQ bit-equal to the {default}-row tile's: "
              f"{bool(torch.equal(got[0], ref[0]))}{' (the default)' if rows == default else ''}")
        del got
    for mode, K, V, lse, O, kw in (("win", x["Kw"], x["Vw"], x["lse_w"], x["Ow"], dict(w=cfg.w)),
                                   ("cmp", x["Kc"], x["Vc"], x["lse_c"], x["Oc"],
                                    dict(l=cfg.l, d=cfg.d))):
        args = (Q, K, V, x["dO"], lse, attention_delta(x["dO"], O))
        ref = banded_bwd(*args, mode=mode, **kw, scale=x["scale"])
        for rows in MMA_ROWS:
            bb_mod.DQ_TILE_ROWS = rows   # the wrapper's q tile, for this timing only
            try:
                got = banded_bwd(*args, mode=mode, **kw, scale=x["scale"])
                ms = time_ms(lambda: banded_bwd(*args, mode=mode, **kw, scale=x["scale"]), 10,
                             hold=True)
            finally:
                bb_mod.DQ_TILE_ROWS = DQ_TILE_ROWS
            print(f"[band] banded_bwd {mode} dQ q tile {rows} rows ({rows // h} tokens): "
                  f"{ms:.4f} ms; dQ bit-equal to the {DQ_TILE_ROWS}-row tile's: "
                  f"{bool(torch.equal(got[0], ref[0]))}"
                  f"{' (the default)' if rows == DQ_TILE_ROWS else ''}")
            del got
    del ref


def measure_train(rec, runs, names, calls=None, suffix: str = "") -> list:
    """Times the named backward kernels (bf16, training shapes) beside
    their plain version and the backward of one SDPA call with the
    equivalent mask; computes each bound from this run's inputs (the same
    work for every design of a function). launches: over TIMED_STEPS steps
    of the train-step run (of `runs`, phases (d) and (f)) whose keys select
    the kernel. `calls` (default bwd_calls of the inputs) and the row
    names' `suffix`: phase (h)'s packed documents."""
    x = rec["inputs"]
    cfg = x["cfg"]
    Dk = Dv = cfg.d_k
    h = cfg.h_per_group
    kv = {"win": ("Kw", "Vw", "lse_w"), "cmp": ("Kc", "Vc", "lse_c"), "sel": ("K", "V", "lse_s")}
    calls = calls or bwd_calls(x)
    out = []
    for name in names:
        kern, plain, mask_fn = calls[name]
        base = name.split("@")[0]
        K, V, lse = (x[k] for k in kv[branch_of(name)])
        mask = mask_fn()                                              # [B,S,G,S_kv]
        # per visible (row, key): the S, dP, dV, dQ and dK products
        ops = float(mask.sum()) * h * 2 * (3 * Dk + 2 * Dv)
        grads = kern()
        io = nbytes(x["Q"], K, V, x["dO"], lse, lse, *grads)         # lse and delta: same size
        if branch_of(name) == "sel":
            io += nbytes(x["sel"])
        if "ds" in x:
            io += nbytes(x["ds"])
        if "gate" in x:   # the fold's gated rows (phase (m))
            io += nbytes(x["gate"])
        bms, by = bound(io, ops, x["Q"].dtype)
        if name == "win_bwd_diag":
            tq, _, strip = wd_mod.tile_plan(kbuild.library(), x["Q"].dtype, *x["Q"].shape[:2],
                                            K.shape[2], cfg.n_kv_groups, h, Dk, Dv, cfg.w)
            print(f"[time] win_bwd_diag q tile {wd_mod.MMA_TILE_ROWS} rows ({tq} tokens): "
                  f"strips {strip} bytes")
        lib_ms = None
        try:
            sq, sk, sv, sm = sdpa_operands(x["Q"], K, V, mask)
            sq, sk, sv = (t.detach().requires_grad_(True) for t in (sq, sk, sv))
            so = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm, scale=x["scale"])
            sdo = torch.randn_like(so)
            lib_ms = time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), sdo,
                                                         retain_graph=True), 5, hold=True)
        except torch.cuda.OutOfMemoryError:
            print(f"[time] {name + suffix}: SDPA's backward with the [{x['Q'].shape[1]}, "
                  f"{K.shape[2]}] mask ran out of memory")
        sq = sk = sv = sm = so = sdo = None
        out.append(dict(
            name=name + suffix, source=f"nsa_vibe_tpu_torch/csrc/{BWD_SOURCE[base]}",
            replaces=BWD_REPLACES[base],
            launches=max(launches_of(c, name) for c in runs), max_abs_err=rec[name],
            ms=time_ms(kern, 10, hold=True),
            plain_ms=time_ms(plain, 3, hold=True),
            bound_ms=bms, bound_by=by, library_ms=lib_ms))
        del mask, grads
        torch.cuda.empty_cache()
    print_rows(out)
    return out


@contextlib.contextmanager
def design_keys(keys):
    """Runs the body under the backward-design keys `keys` (None: the keys
    in force) by replacing ops/tuning.py's loaded dict, as the JAX
    package's tests replace theirs (tests/test_flash_diag.py)."""
    saved = tuning._load
    if keys is not None:
        tuning._load = lambda: dict(tuning.DEFAULTS, **keys)
    try:
        yield
    finally:
        tuning._load = saved


def train_layer_check(dev, designs: dict, cpu=None, seq_start=None, mcfg=M7C_125M,
                      faults=(), rows: int = 2):
    """Layer 0 of the m7c model (or `mcfg`'s) in f32 (`rows` x S=2048; packed
    documents under seq_start [2, 2048] if given): nsa_prefill forward +
    backward through the kernels, under each entry of `designs` (label ->
    design keys, None for the keys in force), against the same layer on
    CPU tensors (plain versions, computed here unless given in `cpu`): the
    gradients of x and of every parameter within GRAD_TOL of each tensor's
    max |value|; with `faults` (planted_fault's arguments) also every
    leaf's ||g - g_cpu|| / ||g_cpu|| within STEP_GRAD_TOL, which each
    fault, planted in the card's kernels, must exceed; then the card pass
    again under set_sync_debug_mode("error"). Returns the CPU result."""
    cfg = mcfg.nsa
    gen = torch.Generator().manual_seed(7)
    params = init_model_params(mcfg, gen, device="cpu", dtype=torch.float32)
    blk = params["blocks"][0]
    tokens = torch.randint(0, mcfg.vocab_size, (rows, S), generator=gen)
    x = rmsnorm(params["embed"][tokens], blk["attn_norm"], mcfg.rmsnorm_eps)
    dout = torch.randn(rows, S, cfg.dim, generator=gen) * 1e-2

    def layer(d):   # the layer's parameters on d, and [x, its leaves] as gradient targets
        with torch.no_grad():
            p = params_to(blk["attn"], device=d)
        wrt = [x.detach().to(d)] + [t for _, t in param_leaves(p)]
        return p, [t.requires_grad_(True) for t in wrt]

    def starts(d):
        return None if seq_start is None else seq_start.to(d)

    def grads(d):   # the layer's output ("out") and gradients, as numpy leaves
        p, wrt = layer(d)
        out, aux = nsa_prefill(p, wrt[0], cfg, seq_start=starts(d))
        g = torch.autograd.grad(out, wrt, dout.to(d))
        tree = params_to_numpy({"out": out.detach(), "x": g[0],
                                **tree_from_leaves(p, list(g[1:]))})
        return dict(_leaves(tree)), canonicalize_sel(aux["sel_idx"]).cpu()

    gc, sc = cpu if cpu is not None else grads("cpu")

    def leaf_gap(gg):   # (worst leaf's ||g - g_cpu|| / ||g_cpu||, its name), "out" aside
        errs = {k: float(np.linalg.norm(gg[k] - want) / np.linalg.norm(want))
                for k, want in gc.items() if k != "out"}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    for label, keys in designs.items():
        with design_keys(keys):
            gg, sg = grads(dev)
            flips = int((sc != sg).any(-1).sum())
            errs = {k: float(np.abs(gg[k] - want).max() / np.abs(want).max())
                    for k, want in gc.items()}
            worst = max(errs, key=errs.get)
            packed = ", packed documents" if seq_start is not None else ""
            print(f"[layer] train f32 ({label} keys{packed}): "
                  f"nsa_prefill forward + backward, card vs plain path: worst err / max|value| "
                  f"= {errs[worst]:.3e} ({worst}) over the output, x and {len(errs) - 2} "
                  f"parameters' gradients (bound {GRAD_TOL:g}); rows whose selection differs: "
                  f"{flips}")
            if flips or not errs[worst] <= GRAD_TOL:
                fail(f"one layer's gradients on the card ({label} keys) disagree with the "
                     f"plain path")
            if faults:
                gap, leaf = leaf_gap(gg)
                print(f"[layer] train f32 ({label} keys): per leaf ||g - g_cpu|| / ||g_cpu|| "
                      f"{gap:.3e} ({leaf}; bound {STEP_GRAD_TOL:g})")
                if not gap <= STEP_GRAD_TOL:
                    fail(f"one layer's gradients on the card ({label} keys) are {gap:.3e} from "
                         f"the plain path's, past {STEP_GRAD_TOL:g}")
                for fault in faults:
                    with planted_fault(*fault):
                        gap, leaf = leaf_gap(grads(dev)[0])
                    print(f"[layer]   planted: {fault[0]} d{'QKV'[fault[1]]} x {fault[2]:g}: "
                          f"{gap:.3e} ({leaf}); must exceed the bound")
                    if not gap > STEP_GRAD_TOL:
                        fail(f"a fault planted in {fault[0]} passes the one-layer gradient check")
            p, wrt = layer(dev)
            dd, ds = dout.to(dev), starts(dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out, _ = nsa_prefill(p, wrt[0], cfg, seq_start=ds)
                torch.autograd.grad(out, wrt, dd)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    print(f"[layer] one layer's forward + backward issued with no host-device synchronisation "
          f"({', '.join(designs)} keys)")
    return gc, sc


def train_counts() -> dict:
    """The launch counters, with the cmp-mode launches of the banded kernels."""
    return dict(kernels.launch_counts(), **{"banded_bwd@cmp": banded_bwd.cmp_launches,
                                            "banded_bwd_1p@cmp": banded_bwd_1p.cmp_launches})


def train_launches(steps: int, mcfg=M7C_125M, tcfg=M7C_125M_TRAIN) -> dict:
    """The launch counts `steps` train steps of the m7c model (or of mcfg,
    tcfg) must show under the keys in force, per layer and micro-batch: the
    three forward kernels twice under full remat (the block's forward runs
    again in the backward), once under MLP-only remat or none; the
    backward the kernel tuning.backward_kernel names for each of the
    window, compressed and selection branches."""
    per = mcfg.n_layers * tcfg.accum_steps
    fwd = 2 if mcfg.remat in (True, "full") else 1
    want = dict.fromkeys(train_counts(), 0)
    for k in ("select_cmp", "sel_attn", "win_attn"):
        want[k] = fwd * per
    for branch in ("win", "cmp", "sel"):
        k = tuning.backward_kernel(branch, tcfg.seq_len, mcfg.nsa.w)
        want[k] += per
        if branch == "cmp":
            want[f"{k}@cmp"] += per
    return {k: v * steps for k, v in want.items()}


def optimizer_launches(steps: int, leaves) -> dict:
    """The multi-tensor AdamW's launches (ops/cuda/adamw_mt.py) over `steps`
    train steps of these leaves: for each dtype, a launch of the partial
    norms and one of the update per as many leaves as a launch's parameters
    hold; one finalize a step."""
    most = kbuild.library().nsa_adamw_mt_max_leaves()
    per = sum(-(-len(ix) // most) for ix in adamw_mt.by_dtype(
        [t.dtype for t in leaves if t.numel()]).values())
    return {"norm": steps * (per + 1), "update": steps * per}


def train_batches(n: int, dev, varlen: bool = False, tcfg=M7C_125M_TRAIN) -> list:
    """n m7c train batches [1, 8, 2048 + 1] of synthetic tokens (seed
    1337) on dev (or tcfg's [accum, batch, seq + 1], as the trainer reads
    them); with varlen, (tokens, seq_start, loss_mask) of packed
    documents (make_varlen_batches at align l_sel)."""
    if not varlen:
        A, rows, seq = tcfg.accum_steps, tcfg.batch_size, tcfg.seq_len
        data = make_batches("synthetic", seq, rows * A, seed=tcfg.seed)
        return [torch.from_numpy(next(data)).long().reshape(A, rows, seq + 1).to(dev)
                for _ in range(n)]
    data = make_varlen_batches("synthetic", tcfg.seq_len, tcfg.batch_size,
                               align=M7C_125M.nsa.l_sel, seed=tcfg.seed)
    out = []
    for _ in range(n):
        toks, ds, lm = next(data)
        out.append((torch.from_numpy(toks).long().to(dev)[None],
                    torch.from_numpy(ds).to(dev)[None], torch.from_numpy(lm).to(dev)[None]))
    return out


def phase_train(dev, tag: str = "train", varlen: bool = False, mcfg=M7C_125M,
                tcfg=M7C_125M_TRAIN, label: str = "m7c-125M", steps: int = TIMED_STEPS,
                keep: bool = False) -> dict:
    """The m7c-125M train step (bf16, remat, B=8 x S=2048, synthetic data;
    with varlen, packed documents: train_batches), or that of mcfg, tcfg
    (named `label`; tcfg.accum_steps micro-batches a step), under the
    design keys in force, from the same seed and batches in every call: a
    warm-up step, `steps` timed steps whose launch counts must be
    train_launches' and whose losses and grad norms must be finite with
    no bad step, one step with no host sync, one traced step. Returns the
    launch counts over the timed steps, the mean step ms, the losses of the
    warm-up and timed steps, the traced step's busy ms, the peak memory
    (and with `keep`, the state, the step and the batches)."""
    tcfg = dataclasses.replace(tcfg, varlen=varlen)
    state = init_train_state(init_model_params(mcfg, torch.Generator().manual_seed(0),
                                               device=dev), tcfg)
    step = make_train_step(mcfg, tcfg)
    batches = train_batches(steps + 3, dev, varlen, tcfg)
    print(f"[{tag}] {label} {mcfg.dtype}, remat {mcfg.remat}, {tcfg.accum_steps} x "
          f"{tcfg.batch_size} x {tcfg.seq_len} tokens per step, lr {tcfg.lr}, max_grad_norm "
          f"{tcfg.max_grad_norm}; backward kernels: " + ", ".join(
              f"{b} {tuning.backward_kernel(b, tcfg.seq_len, mcfg.nsa.w)}"
              for b in ("win", "cmp", "sel")))
    state, m = step(state, batches[0])                                 # warm-up
    losses, norms, goods = [m["loss"]], [m["grad_norm"]], [m["good"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    ev[0].record()
    for i in range(steps):
        state, m = step(state, batches[1 + i])
        ev[i + 1].record()
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        goods.append(m["good"])
    torch.cuda.synchronize()
    counts, gated = train_counts(), kernels.gated_launch_counts()
    opt = {"norm": adamw_mt.norm_and_good.launches, "update": adamw_mt.update_.launches}
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    peak = torch.cuda.max_memory_allocated()
    want = train_launches(steps, mcfg, tcfg)
    print(f"[{tag}] launches over {steps} steps: {counts}; expected {want}")
    if counts != want:
        fail(f"{tag} launch counts {counts} != {want}")
    want_opt = optimizer_launches(steps, [t for _, t in param_leaves(state.params)])
    print(f"[{tag}] multi-tensor AdamW launches over {steps} steps: {opt}; expected {want_opt}")
    if opt != want_opt:
        fail(f"{tag} optimizer launch counts {opt} != {want_opt}")
    losses, norms = [float(v) for v in losses], [float(v) for v in norms]
    bad = sum(not bool(g) for g in goods)
    if not np.all(np.isfinite(losses + norms)) or bad:
        fail(f"{tag} steps: losses {losses}, grad norms {norms}, {bad} bad steps")
    mean_ms = float(np.mean(step_ms))
    tokens = tcfg.accum_steps * tcfg.batch_size * tcfg.seq_len
    print(f"[{tag}] step ms {', '.join(f'{v:.2f}' for v in step_ms)}; mean {mean_ms:.3f} ms, "
          f"{tokens / (mean_ms / 1e3):.0f} tokens/s; losses (warm-up, timed) "
          f"{', '.join(f'{v:.4f}' for v in losses)}; grad_norm {norms[-1]:.4f}; bad steps {bad}")
    print(f"[{tag}] {mfu_text(tcfg.accum_steps * tcfg.batch_size, tcfg.seq_len, mean_ms, mcfg)}")
    if varlen:   # the timed batches' supervised tokens over their steps' time
        sup = sum(float(b[2].sum()) for b in batches[1:1 + steps])
        print(f"[{tag}] supervised tokens {sup:.0f} of {tokens * steps} over "
              f"{steps} steps ({sup / (tokens * steps):.3f}): "
              f"{sup / (sum(step_ms) / 1e3):.0f} supervised tokens/s")
    print(f"[{tag}] max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    host_syncs(lambda: step(state, batches[-2]), tag)
    traced = trace(lambda: step(state, batches[-1]), 1, f"{tag} step", mean_ms)
    out = {"counts": counts, "gated": gated, "step_ms": mean_ms, "losses": losses,
           "busy": traced["busy"], "other": traced["other"], "peak": peak}
    if keep:
        out.update(state=state, step=step, batches=batches)
    return out


def mfu_text(rows: int, seq: int, step_ms: float, mcfg=M7C_125M) -> str:
    """MFU of an m7c-125M (or `mcfg`) train step of rows x seq tokens taking
    step_ms: utils/flops.py's model FLOPs (no remat recompute) over the
    H100's bf16 dense peak."""
    flops = train_step_flops(mcfg, rows, seq)["total"]
    achieved = flops / (step_ms / 1e3)
    return (f"MFU {100 * achieved / H100_BF16_PEAK_FLOPS:.4f}% ({achieved / 1e12:.4f} TFLOP/s "
            f"of {flops:.6e} model FLOPs a step; bf16 peak {H100_BF16_PEAK_FLOPS / 1e12:g} "
            f"TFLOP/s)")


@contextlib.contextmanager
def planted_fault(kernel: str, index: int, factor: float):
    """Runs the body with ops/attention.py's `kernel` wrapper replaced by
    one that multiplies its gradient `index` (0 dQ, 1 dK, 2 dV) by
    `factor`: a fault the design checks must catch."""
    real = getattr(attention, kernel)

    def faulty(*args, **kw):
        grads = list(real(*args, **kw))
        grads[index] = grads[index] * factor
        return tuple(grads)

    setattr(attention, kernel, faulty)
    try:
        yield
    finally:
        setattr(attention, kernel, real)


@contextlib.contextmanager
def dropped_ds(kernel: str):
    """Runs the body with ops/attention.py's `kernel` wrapper replaced by
    one that drops seq_start (the dense bound on packed documents): a fault
    the varlen gradient check must catch."""
    real = getattr(attention, kernel)
    setattr(attention, kernel, lambda *args, seq_start=None, **kw: real(*args, **kw))
    try:
        yield
    finally:
        setattr(attention, kernel, real)


def first_grads(dev, dtype: str, keys, fault=None, varlen: bool = False) -> list:
    """[(leaf name, gradient)] of the m7c-125M train step's first batch at
    phase_train's initial parameters in `dtype` (remat, B=8 x 2048; with
    varlen, train_batches' packed documents), under the design keys `keys`
    (None: the keys in force) and a planted fault if given (planted_fault's
    arguments, or ("drop ds", kernel): dropped_ds); W_qkv is split into its
    seven projections, so a fault in one branch's dK or dV meets its own
    block."""
    mcfg = dataclasses.replace(M7C_125M, dtype=dtype)
    params = init_model_params(mcfg, torch.Generator().manual_seed(0), device=dev)
    leaves = param_leaves(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    batch = train_batches(1, dev, varlen)[0]
    args = (batch[0][0], mcfg, False, batch[1][0], batch[2][0]) if varlen else (batch[0], mcfg)
    plant = (contextlib.nullcontext() if not fault else dropped_ds(fault[1])
             if fault[0] == "drop ds" else planted_fault(*fault))
    with design_keys(keys), plant:
        grads = loss_and_grads(params, *args)[1]
    c = mcfg.nsa
    widths = [c.n_heads * c.d_k] + [c.n_kv_groups * dim for dim in (c.d_k, c.d_v)] * 3
    out = []
    for (name, _), g in zip(leaves, grads):
        if name.endswith("/W_qkv"):
            out += [(name[:-len("W_qkv")] + k, p)
                    for k, p in zip(PROJ_KEYS, g.split(widths, dim=1))]
        else:
            out.append((name, g))
    return out


def step_grad_check(dev) -> None:
    """The m7c-125M train step's first gradient (first_grads) under each
    setting of DESIGNS against the default keys': in f32, for every leaf
    ||g - g_default|| / ||g_default|| within STEP_GRAD_TOL, and each fault
    of PLANTED_FAULTS, planted in the default keys' kernels, must exceed
    it, so the check is shown to fail where a kernel is wrong. The same
    differences in bf16 (the train step's dtype) are printed, not bounded:
    there one rounding step in a backward kernel moves a gradient that is
    a sum with heavy cancellation (layer 0's W_K_cmp) as far as a 1% fault
    does."""
    runs = {tuning.backward_kernel(b, M7C_125M_TRAIN.seq_len, M7C_125M.nsa.w)
            for b in ("win", "cmp", "sel")}
    bad = []
    for dtype in ("bfloat16", "float32"):
        ref = first_grads(dev, dtype, None)

        def gap(keys, fault=None):   # (worst leaf's relative difference, its name)
            got = first_grads(dev, dtype, keys, fault)
            errs = torch.stack([(g.float() - r.float()).norm() / r.float().norm()
                                for (_, g), (_, r) in zip(got, ref)])
            i = int(errs.argmax())
            return float(errs[i]), got[i][0]

        gated = dtype == "float32"
        print(f"[train grads] {dtype}: first step's gradient over {len(ref)} leaves vs the "
              f"default keys' (per leaf ||g - g_default|| / ||g_default||, "
              f"{f'bound {STEP_GRAD_TOL:g}' if gated else 'not bounded'}):")
        for label, keys in DESIGNS.items():
            err, leaf = gap(keys)
            print(f"[train grads]   {label}: {err:.3e} ({leaf})")
            if gated and not err <= STEP_GRAD_TOL:
                bad.append(label)
        for kernel, index, factor in PLANTED_FAULTS if gated else ():
            if kernel not in runs:
                fail(f"planted fault in {kernel}, which the default keys do not run")
            err, leaf = gap(None, (kernel, index, factor))
            label = f"planted: {kernel} d{'QKV'[index]} x {factor:g}"
            print(f"[train grads]   {label}: {err:.3e} ({leaf}); must exceed the bound")
            if not err > STEP_GRAD_TOL:
                bad.append(label)
        del ref
        torch.cuda.empty_cache()
    if bad:
        fail(f"the train step's first gradient check failed for {bad}")


def train_designs(dev, default_losses, varlen: bool = False) -> list:
    """The m7c train step (phase_train, bf16; with varlen on packed
    documents) under each setting of DESIGNS; each setting's losses must
    equal the default keys' (`default_losses`) within LOSS_TOL. The first
    loss comes before any update and the warm-up lr moves the later ones
    little, so the loss check is weak; the gradient checks are the gate.
    Returns the settings' launch counts, from which the backward kernels'
    rows take theirs."""
    runs = []
    for label, keys in DESIGNS.items():
        tag = f"{'varlen' if varlen else 'train'} {label}"
        with design_keys(keys):
            r = phase_train(dev, tag, varlen)
        diff = max(abs(a - b) for a, b in zip(r["losses"], default_losses))
        print(f"[{tag}] losses vs the default keys': max |difference| {diff:.3e} "
              f"(bound {LOSS_TOL:g})")
        if not diff <= LOSS_TOL:
            fail(f"the {tag} step's losses differ from the default keys'")
        runs.append(r["counts"])
    return runs


def phase_designs(dev, default_losses, cpu) -> list:
    """Phase (f) beyond the kernel checks: one layer's gradients, the m7c
    train step's first gradient (step_grad_check) and the m7c train step
    under each setting of DESIGNS against the default keys' losses (phase
    (d)). Returns the settings' launch counts."""
    train_layer_check(dev, DESIGNS, cpu)
    step_grad_check(dev)
    return train_designs(dev, default_losses)


def loss_falls(dev, varlen: bool = False) -> None:
    """train() on the card for LOSS_STEPS m7c steps with a short warmup: the
    logged losses (every 5 steps) must be finite, with no bad step, and the
    mean of the last four at least LOSS_DROP below the first (the loss at
    initialisation, ~ln 256 + 0.1; one batch's loss moves by ~0.2 between
    logs at this lr, so a shorter run does not show a fall reliably). With
    varlen on packed documents, and one eval at the end, whose loss must be
    finite."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    tcfg = dataclasses.replace(M7C_125M_TRAIN, steps=LOSS_STEPS, warmup_steps=5, log_every=5,
                               save_every=0, eval_every=LOSS_STEPS if varlen else 0,
                               out_dir=TRAIN_DIR, varlen=varlen)
    tag = "varlen" if varlen else "train"
    t = time.perf_counter()
    summary = train(M7C_125M, tcfg, "synthetic", device=dev)
    with open(os.path.join(TRAIN_DIR, "training.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    val = []
    if varlen:
        with open(os.path.join(TRAIN_DIR, "val.csv")) as f:
            val = [float(r[1]) for r in csv.reader(f)]
    print(f"[{tag}] train(): {summary['steps']} steps in {time.perf_counter() - t:.1f} s, "
          f"logged losses {', '.join(f'{v:.4f}' for v in losses)}, bad steps "
          f"{summary['bad_steps']}" + (f"; eval loss {val}" if varlen else ""))
    if not np.all(np.isfinite(losses)) or summary["bad_steps"] or \
            not np.mean(losses[-4:]) < losses[0] - LOSS_DROP:
        fail(f"the m7c training loss did not fall ({tag})")
    if varlen and (len(val) != 1 or not np.isfinite(val[0])):
        fail(f"the varlen train() run's eval gave {val}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


# ------------------------------------------------------------------ (e)

def long_inputs(dtype, dev, gen, S_q: int) -> dict:
    """m7c operands of the compressed and window branches for an S_q-token
    prompt: Q [1,S_q,G,h,D], K_cmp/V_cmp [1,G,S_cmp,D], K/V [1,G,S_q,D]."""
    cfg = M7C_125M.nsa
    G, h, D = cfg.n_kv_groups, cfg.h_per_group, cfg.d_k
    S_cmp = num_cmp_blocks(S_q, cfg.l, cfg.d)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return dict(cfg=cfg, scale=1.0 / float(np.sqrt(D)), S_sel=-(-S_q // cfg.l_sel),
                Q=r(1, S_q, G, h, D), Kc=r(1, G, S_cmp, D), Vc=r(1, G, S_cmp, D),
                K=r(1, G, S_q, D), V=r(1, G, S_q, D))


def sel_kw(x) -> dict:
    cfg = x["cfg"]
    return dict(S_sel=x["S_sel"], scale=x["scale"], l=cfg.l, d=cfg.d, l_sel=cfg.l_sel,
                n_top=cfg.n_sel)


def phase_long_kernels(dev) -> dict:
    """Rows 3 and 5 at the 64k shapes, f32 then bf16: the banded forward in
    both modes (the window through win_attn) over all S_LONG rows, held by
    banded_fwd_check on its last N_CHECK rows (the plain scores of every
    row would take 12.9 GB), and banded_attn on the same rows at t_start =
    S_LONG - N_CHECK must give the same bits as the full call; then row 6
    and the selection forward. Returns the bf16 inputs and max errors."""
    gen = torch.Generator(device=dev).manual_seed(2468)
    t0 = S_LONG - N_CHECK
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = long_inputs(dtype, dev, gen, S_LONG)
        cfg, sc = x["cfg"], x["scale"]
        Qt = x["Q"][:, t0:]
        for mode, K, V, kw, run in (
                ("cmp", x["Kc"], x["Vc"], dict(l=cfg.l, d=cfg.d),
                 lambda: banded_attn(x["Q"], x["Kc"], x["Vc"], mode="cmp", l=cfg.l, d=cfg.d,
                                     scale=sc, return_lse=True)),
                ("win", x["K"], x["V"], dict(w=cfg.w),
                 lambda: win_attn(x["Q"], x["K"], x["V"], w=cfg.w, scale=sc, return_lse=True))):
            name = "banded_attn@cmp" if mode == "cmp" else "win_attn@64k"
            rec[name] = banded_fwd_check(name, run, x["Q"], K, V, mode=mode, kw=kw, scale=sc,
                                         lse=True, rows=(t0, S_LONG))
            O, lse = run()
            Os, lses = banded_attn(Qt, K, V, mode=mode, **kw, scale=sc, t_start=t0,
                                   return_lse=True)
            torch.cuda.synchronize()
            same = torch.equal(Os, O[:, t0:]) and torch.equal(lses, lse[:, t0:])
            print(f"[check] {name}: banded_attn at t_start={t0} gives the full call's rows "
                  f"bit for bit: {same}")
            if not same:
                fail(f"{name}: the t_start={t0} call differs from the full call")
            del O, lse, Os, lses
        sel = select_blocks(x["Q"], x["Kc"], **sel_kw(x))
        again = select_blocks(x["Q"], x["Kc"], **sel_kw(x))
        sels = select_blocks(Qt, x["Kc"], **sel_kw(x), pos_offset=t0)
        selp, p_grp = select_blocks_plain(Qt, x["Kc"], **sel_kw(x), pos_offset=t0,
                                          return_scores=True)
        torch.cuda.synchronize()
        n_diff, n_far, spread = near_tie_rows(sel[:, t0:], selp, p_grp)
        same, offset = torch.equal(sel, again), torch.equal(sels, sel[:, t0:])
        print(f"[check] select_blocks      {str(dtype)[6:]:8s} S_sel={x['S_sel']}: sel rows "
              f"differing on near ties: {n_diff} of {selp.shape[1] * selp.shape[2]} (widest "
              f"score spread {spread:.3e}); t_start={t0} rows equal: {offset}; two launches "
              f"gave identical bits: {same}")
        if n_far or not offset or not same:
            fail(f"select_blocks {dtype}: {n_far} rows differ beyond the near-tie bound, or "
                 f"the pos_offset call differs from the full call, or two launches differ")
        rec["select_blocks"] = spread
        del again, sels, selp, p_grp
        # row 2 on select_blocks' sets (the long route's prefill), then row 4 at the 64k cache
        fwd = (x["Q"], x["K"], x["V"], sel, torch.arange(S_LONG, device=dev))
        rec["sel_attn@64k"] = sel_fwd_check(
            "sel_attn@64k", lambda: sel_attn(*fwd, l_sel=cfg.l_sel, scale=sc, return_lse=True),
            *fwd, l_sel=cfg.l_sel, scale=sc, lse=True, rows=(t0, S_LONG), chunk=PLAIN_ROWS)
        dec = long_decode_inputs(dtype, dev, gen)
        rec["sel_attn@decode-64k"] = sel_fwd_check(
            "sel_attn@decode-64k", lambda: sel_attn(*dec, l_sel=cfg.l_sel, scale=sc),
            *dec, l_sel=cfg.l_sel, scale=sc)
        if dtype == torch.bfloat16:
            rec.update(inputs=x, sel=sel, dec=dec)
        del fwd, sel, dec
        torch.cuda.empty_cache()
    return rec


def long_decode_inputs(dtype, dev, gen) -> tuple:
    """One decode step's selection operands at the 64k cache (capacity
    S_LONG + N_NEW, the query at position S_LONG): Q [1,1,G,h,D], K/V
    [1,G,cap,D], sel [1,1,G,n] from random block scores, t [1,1]."""
    cfg = M7C_125M.nsa
    G, h, D, cap = cfg.n_kv_groups, cfg.h_per_group, cfg.d_k, S_LONG + N_NEW

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    t = torch.full((1, 1), S_LONG, device=dev)
    p = torch.rand((1, 1, G, -(-cap // cfg.l_sel)), generator=gen, device=dev)
    return (r(1, 1, G, h, D), r(1, G, cap, D), r(1, G, cap, D),
            select_topn_blocks(p, cfg.n_sel, t, cfg.l_sel), t)


def cross_check(dev) -> None:
    """At m7c S_CROSS = 16384 tokens both routes apply: on the same bf16
    inputs banded_attn (cmp) against the plain unrounded compressed branch,
    select_cmp's O and lse against banded_attn's bit for bit and
    select_blocks' sets against select_cmp's, then one
    compressed_attention forward + backward with no host sync."""
    x = long_inputs(torch.bfloat16, dev, torch.Generator(device=dev).manual_seed(1357), S_CROSS)
    cfg, sc = x["cfg"], x["scale"]
    M = build_M_csl_on(S_CROSS, cfg.l, cfg.d, cfg.l_sel, dev)
    kw = {k: v for k, v in sel_kw(x).items() if k != "S_sel"}
    sel_f, O_f, lse_f = select_cmp(x["Q"], x["Kc"], x["Vc"], M, **kw, return_lse=True)
    O_b, lse_b = banded_attn(x["Q"], x["Kc"], x["Vc"], mode="cmp", l=cfg.l, d=cfg.d, scale=sc,
                             return_lse=True)
    sel_b = select_blocks(x["Q"], x["Kc"], **sel_kw(x))
    _, p_grp = select_blocks_plain(x["Q"], x["Kc"], **sel_kw(x), return_scores=True)
    torch.cuda.synchronize()
    # both round P to bf16 before P V, as the TPU kernels do: banded_attn is
    # held against the plain version's unrounded f32 result, and select_cmp,
    # whose pass 1 is the same compressed-prefix walk, to banded_attn's bits
    want, rss = banded_attn_rss(x["Q"], x["Kc"], x["Vc"], mode="cmp", l=cfg.l, d=cfg.d, scale=sc)
    bd = allowed_tc_err(want, rss)
    del rss
    check("cross: banded_attn O", O_b, want, bound=bd)
    del want, bd
    same = torch.equal(O_f, O_b) and torch.equal(lse_f, lse_b)
    n_diff, n_far, spread = near_tie_rows(sel_b, sel_f, p_grp)
    print(f"[cross] S={S_CROSS}, S_sel={x['S_sel']}: select_cmp O and lse bit-equal to "
          f"banded_attn (cmp): {same}; select_blocks vs select_cmp sets differing on near ties: "
          f"{n_diff} (widest spread {spread:.3e})")
    if not same or n_far:
        fail("the long route disagrees with select_cmp at 16k")
    Q, Kc, Vc = (x[k].detach().requires_grad_(True) for k in ("Q", "Kc", "Vc"))
    dO = torch.randn_like(O_b)

    def fwd_bwd():
        O = compressed_attention(Q, Kc, Vc, l=cfg.l, d=cfg.d, scale=sc)
        return torch.autograd.grad(O, (Q, Kc, Vc), dO)

    fwd_bwd()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = fwd_bwd()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        fail("compressed_attention gradients are not finite")
    print("[cross] compressed_attention forward + backward (banded_attn + banded_bwd) issued "
          "with no host-device synchronisation")


def phase_long_serve(dev) -> dict:
    """m7c-125M serves one 64k prompt and N_NEW greedy tokens: prefill on
    the long route (12 select_blocks + 12 banded_attn, no select_cmp)."""
    mcfg, L = M7C_125M, M7C_125M.n_layers
    gen = torch.Generator().manual_seed(11)
    params = init_model_params(mcfg, gen, device=dev)
    prompt = torch.randint(0, mcfg.vocab_size, (1, S_LONG), generator=gen).to(dev)
    cap = S_LONG + N_NEW
    with torch.no_grad():
        generate(params, prompt, 2, mcfg, capacity=cap)                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        tokens = generate(params, prompt, N_NEW, mcfg, capacity=cap)
        e1.record()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        decode_launches = sel_attn.decode_launches
        serve_ms = e0.elapsed_time(e1)
        peak = torch.cuda.max_memory_allocated()
        want = {**dict.fromkeys(counts, 0), "sel_attn": L + L * (N_NEW - 1), "win_attn": L,
                "banded_attn": L, "select_blocks": L}
        print(f"[long] launches on the main path: {counts} (sel_attn at decode: "
              f"{decode_launches}); expected {want}")
        if counts != want or decode_launches != L * (N_NEW - 1):
            fail(f"64k launch counts {counts} != {want}")
        if tuple(tokens.shape) != (1, S_LONG + N_NEW) or not torch.equal(tokens[:, :S_LONG],
                                                                          prompt) \
                or int(tokens.min()) < 0 or int(tokens.max()) >= mcfg.vocab_size:
            fail("generate returned a malformed token tensor at 64k")
        logits, caches = model_prefill_with_caches(params, prompt, mcfg, cap)
        if not bool(torch.isfinite(logits).all()):
            fail("64k prefill logits are not finite")
        del logits, caches
        prefill_ms = time_ms(lambda: model_prefill_with_caches(params, prompt, mcfg, cap), 3, 1)
        _, caches = model_prefill_with_caches(params, prompt, mcfg, cap)
        torch.cuda.synchronize()       # the events below time decode, not this prefill's tail
        tok = tokens[:, S_LONG:S_LONG + 1]
        t_host = time.perf_counter()
        e0.record()
        for i in range(N_NEW - 1):
            logits, caches = model_decode_step(params, tok, caches, mcfg)
            tok = tokens[:, S_LONG + i + 1:S_LONG + i + 2]
        e1.record()
        decode_host_ms = (time.perf_counter() - t_host) * 1e3 / (N_NEW - 1)
        torch.cuda.synchronize()
        decode_ms = e0.elapsed_time(e1) / (N_NEW - 1)
        if not bool(torch.isfinite(logits).all()):
            fail("64k decode logits are not finite")
        print(f"[long] 1 request x ({S_LONG} prompt + {N_NEW} new) tokens: generate "
              f"{serve_ms:.2f} ms; prefill {prefill_ms:.3f} ms ({S_LONG / (prefill_ms / 1e3):.0f} "
              f"tokens/s); decode {decode_ms:.4f} ms/token step, of which the host took "
              f"{decode_host_ms:.4f} ms to issue")
        print(f"[long] max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
        del caches
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, caches = model_prefill_with_caches(params, prompt, mcfg, cap)
            model_decode_step(params, tokens[:, S_LONG:S_LONG + 1], caches, mcfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print("[long] 64k prefill and a decode step issued with no host-device synchronisation")
        del caches
        trace(lambda: model_prefill_with_caches(params, prompt, mcfg, cap), 1, "64k prefill",
              prefill_ms)
        _, caches = model_prefill_with_caches(params, prompt, mcfg, cap)
        trace(lambda: model_decode_step(params, tokens[:, S_LONG:S_LONG + 1], caches, mcfg), 3,
              "64k decode step", decode_ms)
    return {**counts, "sel_attn@decode": decode_launches}


def phase_needles(dev) -> None:
    """The needle tools at S_LONG in bf16 (bench/needle_e2e.py's config):
    the selection smoke at five depths and the end-to-end probe at three,
    whose prefill must take the long route (S_sel = 1024)."""
    t = time.perf_counter()
    smoke = needle_smoke(S_LONG, NEEDLE_DEPTHS, device=dev, dtype=torch.bfloat16)
    print(f"[needle] smoke S={S_LONG}: pass {smoke['pass']}, "
          + ", ".join(f"depth {r['depth']} block {r['pos'] // NEEDLE_CFG.l_sel} "
                      f"found {r['found']}" for r in smoke["results"])
          + f" ({time.perf_counter() - t:.1f} s)")
    kernels.reset_launch_counts()
    probes = []
    for depth in PROBE_DEPTHS:
        t = time.perf_counter()
        r = needle_probe(NEEDLE_CFG, S_LONG, depth, dtype=torch.bfloat16, device=dev)
        probes.append(r)
        print(f"[needle] probe S={S_LONG} depth {depth}: found_sel {r['found_sel']} "
              f"cos_needle {r['cos_needle']:.4f} cos_ablated {r['cos_ablated']:.4f} pass "
              f"{r['pass_']} ({time.perf_counter() - t:.1f} s)")
    counts = kernels.launch_counts()
    print(f"[needle] probe launches: {counts}")
    if not smoke["pass"] or not all(r["pass_"] for r in probes):
        fail("a needle smoke or probe failed at 64k")
    if counts["select_cmp"] or counts["select_blocks"] != 2 * len(PROBE_DEPTHS):
        fail("the needle probe's prefill did not take the long route")


def measure_long(rec, counts) -> list:
    """Times rows 5 (cmp, the long route's mode), 3 (the window) and 6 at
    the 64k shapes (bf16) beside their plain versions over every row
    (N_CHECK rows per call, by t_start) and, for rows 5 and 3, one SDPA
    call with the equivalent boolean mask; computes their bounds from this
    run's inputs; sweeps the banded forward's q tile (band_fwd_tiles) and
    the scorer's CTA rows (MMA_ROWS)."""
    x = rec["inputs"]
    cfg, sc, Q = x["cfg"], x["scale"], x["Q"]
    h, D = cfg.h_per_group, cfg.d_k
    pairs = band_pairs(S_LONG, x["Kc"].shape[2], "cmp", dict(l=cfg.l, d=cfg.d)) \
        * cfg.n_kv_groups * h                                  # visible (row, key) pairs
    kw = dict(mode="cmp", l=cfg.l, d=cfg.d, scale=sc)
    starts = range(0, S_LONG, N_CHECK)
    out = []

    cargs, wargs = (Q, x["Kc"], x["Vc"]), (Q, x["K"], x["V"])
    out.append(band_row("banded_attn@cmp", lambda: banded_attn(*cargs, **kw), *cargs,
                        mode="cmp", kw=dict(l=cfg.l, d=cfg.d), lse=False,
                        launches=counts["banded_attn"], max_err=rec["banded_attn@cmp"], iters=5,
                        chunk=N_CHECK))
    out.append(band_row("win_attn@64k", lambda: win_attn(*wargs, w=cfg.w, scale=sc), *wargs,
                        mode="win", kw=dict(w=cfg.w), lse=False, launches=counts["win_attn"],
                        max_err=rec["win_attn@64k"], iters=5, chunk=N_CHECK))
    band_fwd_tiles("64k cmp", lambda: banded_attn(*cargs, **kw), 5)
    band_fwd_tiles("64k win", lambda: win_attn(*wargs, w=cfg.w, scale=sc), 5)

    sel = select_blocks(Q, x["Kc"], **sel_kw(x))
    bms, by = bound(nbytes(Q, x["Kc"], sel), pairs * 2 * D, Q.dtype)   # one Q K^T
    for rows in MMA_ROWS:   # the tensor-core scorer's CTA of 64 or 128 rows
        sk_mod.MMA_TILE_ROWS = rows   # the wrapper's tile, for this timing only
        try:
            same = torch.equal(select_blocks(Q, x["Kc"], **sel_kw(x)), sel)
            ms = time_ms(lambda: select_blocks(Q, x["Kc"], **sel_kw(x)), 5, hold=True)
        finally:
            sk_mod.MMA_TILE_ROWS = SEL_TILE_ROWS
        print(f"[long] select_blocks CTAs of {rows} rows ({rows // h} tokens): {ms:.4f} ms; "
              f"sel_idx bit-equal to the {SEL_TILE_ROWS}-row CTAs': {same}"
              f"{' (the default)' if rows == SEL_TILE_ROWS else ''}")
    out.append(dict(
        name="select_blocks", source="nsa_vibe_tpu_torch/csrc/select_blocks_mma.cu",
        replaces="nsa_vibe_tpu/ops/pallas/scorer.py:186",
        launches=counts["select_blocks"], max_abs_err=rec["select_blocks"],
        ms=time_ms(lambda: select_blocks(Q, x["Kc"], **sel_kw(x)), 5, hold=True),
        plain_ms=time_ms(lambda: [select_blocks_plain(Q[:, s:s + N_CHECK], x["Kc"], **sel_kw(x),
                                                      pos_offset=s) for s in starts], 1, 1,
                         hold=True),
        bound_ms=bms, bound_by=by, library_ms=None))

    # rows 2 and 4 at 64k; no SDPA call at 64k prefill: its mask would take 51 GB
    fwd = (Q, x["K"], x["V"], rec["sel"], torch.arange(S_LONG, device=Q.device))
    dec_launches = counts["sel_attn@decode"]
    out.append(sel_attn_row("sel_attn@64k", *fwd, launches=counts["sel_attn"] - dec_launches,
                            max_err=rec["sel_attn@64k"], iters=5, plain_rows=PLAIN_ROWS,
                            library=False))
    out.append(sel_attn_row("sel_attn@decode-64k", *rec["dec"], launches=dec_launches,
                            max_err=rec["sel_attn@decode-64k"]))
    sel_fwd_tiles("64k", *fwd, iters=3)
    print_rows(out)
    return out


# ------------------------------------------------------------------ (h)

# documents packed first at the train shape (l_sel = 64): one shorter than
# l = 32 (it sees no compressed token), one of exactly l_sel, one longer
# than w = 512, one that nearly fills a row; then lengths from a seed
VARLEN_MUST = (20, 64, 700, 2000)
VARLEN_SEED = 97
# raw tokens under one key tile (64 pooled tokens) of the bf16 compressed
# forward, whose tiles sit at absolute multiples of it
CMP_TILE_TOKENS = 64 * M7C_125M.nsa.d
# the varlen rows' TPU kernels that take seq_start (PERF.md's table): the
# train shape's forwards and backward designs, the 64k route's rows 5 and 6
VARLEN_BWD = ("banded_bwd_1p@win", "banded_bwd_1p@cmp", "banded_bwd@win", "banded_bwd@cmp",
              "win_bwd_diag")


def varlen_pack(rows: int, S_row: int, seed: int, must=()) -> tuple:
    """Documents of random tokens packed by pack_documents_aligned at l_sel:
    `must` lengths first, then lengths drawn from `seed` (a third under 64
    tokens, the rest up to S_row / 3), until `rows` rows are full. Returns
    (tokens [rows, S_row + 1], seq_start [rows, S_row], loss_mask, the
    documents as (row, start, length))."""
    rng = np.random.default_rng(seed)
    lens = list(must)
    while True:
        docs = [rng.integers(0, M7C_125M.vocab_size, size=n).astype(np.int32) for n in lens]
        toks, ds, lm = pack_documents_aligned(docs, S_row, M7C_125M.nsa.l_sel, 1)
        if len(ds) > rows:
            break
        lens += [int(rng.integers(2, 64)) if rng.random() < 0.3
                 else int(rng.integers(64, max(S_row // 3, 65))) for _ in range(8)]
    toks, ds, lm = toks[:rows], ds[:rows], lm[:rows]
    spans = [(r, int(a), int(lm[r, ds[r] == a].sum()) + 1)
             for r in range(rows) for a in np.unique(ds[r]) if lm[r, ds[r] == a].any()]
    return toks, ds, lm, spans


def varlen_kernel_inputs(dtype, dev, gen, ds) -> dict:
    """Branch operands at the m7c training shapes under seq_start ds [B, S]
    (packed documents) and their forward outputs with lse, from the
    kernels."""
    cfg = M7C_125M.nsa
    G, h, D = cfg.n_kv_groups, cfg.h_per_group, cfg.d_k
    meta = build_block_meta(S, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    x = dict(cfg=cfg, scale=1.0 / float(np.sqrt(D)), ds=ds, Q=r(B_TRAIN, S, G, h, D),
             dO=r(B_TRAIN, S, G, h, D), Kc=r(B_TRAIN, G, meta.S_cmp, D),
             Vc=r(B_TRAIN, G, meta.S_cmp, D), Kw=r(B_TRAIN, G, S, D), Vw=r(B_TRAIN, G, S, D),
             M=torch.from_numpy(meta.M_csl).to(dev))
    x["sel"], x["Oc"], x["lse_c"] = select_cmp(x["Q"], x["Kc"], x["Vc"], x["M"], **cmp_kw(x),
                                               return_lse=True, seq_start=ds)
    x["Ow"], x["lse_w"] = win_attn(x["Q"], x["Kw"], x["Vw"], w=cfg.w, scale=x["scale"],
                                   return_lse=True, seq_start=ds)
    return x


def cmp_kw(x) -> dict:
    cfg = x["cfg"]
    return dict(scale=x["scale"], l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)


def dense_bound_fails(name, O_dense, want_bound) -> None:
    """The planted fault of phase (h): the kernel's output with the dense
    bound (seq_start None) on the packed input must fail the varlen check."""
    worst = worst_ratio(O_dense, *want_bound)
    print(f"[varlen] {name}: the same kernel given the dense bound on the packed input: worst "
          f"err/bound {worst:.3f} (must exceed 1)")
    if not worst > 1.0:
        fail(f"{name}: the dense bound passes the varlen check")


def fwd_bound(dtype, plain_O, rss_fn):
    """(want, bound) of a forward's output: f32 allowed_err of the plain O,
    bf16 (tensor cores) allowed_tc_err of the unrounded f32 O."""
    if dtype == torch.float32:
        return plain_O, allowed_err(plain_O)
    want, rss = rss_fn()
    return want, allowed_tc_err(want, rss)


def varlen_fwd_checks(x, dtype) -> dict:
    """Rows 1 and 3 with seq_start at the train shape against their plain
    versions with it (fwd_check: two launches bit-equal; bf16 tensor-core
    bound with a planted 1% fault; lse with the same rows empty); row 1's
    sets equal but at near ties, forced slots in order, and in bf16 its O
    and lse banded_attn's (cmp, seq_start) bit for bit; each given the
    dense bound must fail."""
    cfg, sc, ds = x["cfg"], x["scale"], x["ds"]
    Q, Kc, Vc, M = x["Q"], x["Kc"], x["Vc"], x["M"]
    kw = cmp_kw(x)
    sel_k = select_cmp(Q, Kc, Vc, M, **kw, seq_start=ds)[0]
    sel_2 = select_cmp(Q, Kc, Vc, M, **kw, seq_start=ds)[0]
    sel_p, _, p_grp = select_cmp_plain(Q, Kc, Vc, M, **kw, return_scores=True, seq_start=ds)
    n_diff, n_far, spread = near_tie_rows(sel_k, sel_p, p_grp)
    forced = torch.equal(sel_k[..., :3], sel_p[..., :3])
    dense_far = near_tie_rows(select_cmp(Q, Kc, Vc, M, **kw)[0], sel_p, p_grp)[1]
    print(f"[varlen] select_cmp {str(dtype)[6:]:8s} sel rows differing on near ties: {n_diff} "
          f"(widest spread {spread:.3e}); forced slots in order: {forced}; two launches "
          f"identical: {torch.equal(sel_k, sel_2)}; with the dense bound, rows differing "
          f"beyond a near tie: {dense_far} (must be > 0)")
    if n_far or not forced or not torch.equal(sel_k, sel_2) or not dense_far:
        fail(f"select_cmp with seq_start {dtype}: sets differ beyond the near-tie bound, or "
             f"the forced slots or two launches differ, or the dense bound passes")
    del sel_k, sel_2, sel_p, p_grp

    def plain_c(a, b, with_lse=False):
        out = select_cmp_plain(Q, Kc, Vc, M, **kw, return_lse=with_lse, seq_start=ds)
        return out[1:] if with_lse else out[1]

    def rss_c(a=0, b=0):
        return banded_attn_rss(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d, scale=sc, seq_start=ds)

    errs = {"select_cmp@varlen": fwd_check(
        "select_cmp@varlen", lambda: select_cmp(Q, Kc, Vc, M, **kw, return_lse=True,
                                                seq_start=ds)[1:],
        dtype, S, plain_c, rss_c, tc=dtype == torch.bfloat16, lse=True, rows=None, chunk=None)}
    dense_bound_fails("select_cmp@varlen", select_cmp(Q, Kc, Vc, M, **kw)[1],
                      fwd_bound(dtype, plain_c(0, S), rss_c))
    if dtype == torch.bfloat16:
        O, L_ = select_cmp(Q, Kc, Vc, M, **kw, return_lse=True, seq_start=ds)[1:]
        Ob, Lb = banded_attn(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d, scale=sc, return_lse=True,
                             seq_start=ds)
        same = torch.equal(O, Ob) and torch.equal(L_, Lb)
        print(f"[varlen] select_cmp: O and lse bit-equal to banded_attn (cmp, seq_start): {same}")
        if not same:
            fail("select_cmp with seq_start: O or lse differ from banded_attn's in cmp mode")
    wargs = (Q, x["Kw"], x["Vw"])

    def plain_w(a, b, with_lse=False):
        return banded_attn_plain(*wargs, mode="win", w=cfg.w, scale=sc, return_lse=with_lse,
                                 seq_start=ds)

    def rss_w(a=0, b=0):
        return banded_attn_rss(*wargs, mode="win", w=cfg.w, scale=sc, seq_start=ds)

    errs["win_attn@varlen"] = fwd_check(
        "win_attn@varlen", lambda: win_attn(*wargs, w=cfg.w, scale=sc, return_lse=True,
                                            seq_start=ds),
        dtype, S, plain_w, rss_w, tc=dtype == torch.bfloat16, lse=True, rows=None, chunk=None)
    dense_bound_fails("win_attn@varlen", win_attn(*wargs, w=cfg.w, scale=sc),
                      fwd_bound(dtype, plain_w(0, S), rss_w))
    return errs


def varlen_bwd_calls(x) -> dict:
    """name -> (kernel call under seq_start s, plain call, visibility mask
    [B,S,G,S_kv]) of the banded backward kernels on x's packed documents."""
    cfg, sc, ds = x["cfg"], x["scale"], x["ds"]
    Q, dO = x["Q"], x["dO"]
    G = Q.shape[2]
    win = dict(mode="win", w=cfg.w, scale=sc)
    cmp_ = dict(mode="cmp", l=cfg.l, d=cfg.d, scale=sc)
    wargs = (Q, x["Kw"], x["Vw"], dO, x["lse_w"], attention_delta(dO, x["Ow"]))
    cargs = (Q, x["Kc"], x["Vc"], dO, x["lse_c"], attention_delta(dO, x["Oc"]))

    def mask(args, kw):
        return banded_mask(S, args[1].shape[2], **{k: v for k, v in kw.items() if k != "scale"},
                           device=Q.device, seq_start=ds)[:, :, None, :].expand(-1, -1, G, -1)

    table = {"banded_bwd_1p@win": (banded_bwd_1p, wargs, win),
             "banded_bwd_1p@cmp": (banded_bwd_1p, cargs, cmp_),
             "banded_bwd@win": (banded_bwd, wargs, win), "banded_bwd@cmp": (banded_bwd, cargs, cmp_),
             "win_bwd_diag": (None, wargs, win)}
    out = {}
    for name, (fn, args, kw) in table.items():
        if fn is None:
            def kern(s=ds, args=args):
                return win_bwd_diag(*args, w=cfg.w, scale=sc, seq_start=s)
        else:
            def kern(s=ds, fn=fn, args=args, kw=kw):
                return fn(*args, **kw, seq_start=s)
        out[name] = (kern, lambda args=args, kw=kw: banded_bwd_plain(*args, **kw, seq_start=ds),
                     lambda args=args, kw=kw: mask(args, kw))
    return out


def varlen_bwd_checks(x, dtype) -> dict:
    """Rows 7 (win, cmp), 8 (win, cmp) and 11 with seq_start against the
    plain version with it (f32 allowed_rel_err; bf16 allowed_tc_err of
    banded_bwd_rss under seq_start, where a planted 1% fault must fail),
    two launches bit-equal, the SAME_P_DS pairs within allowed_rel_err of
    each other; each kernel given the dense bound must fail."""
    cfg, sc, ds = x["cfg"], x["scale"], x["ds"]
    calls = varlen_bwd_calls(x)
    refs, errs, got_all = {}, {}, {}
    for name in VARLEN_BWD:
        kern, plain, _ = calls[name]
        branch = branch_of(name)
        if branch not in refs:
            if dtype == torch.bfloat16:
                K, V, lse, O = (x[k] for k in (("Kw", "Vw", "lse_w", "Ow") if branch == "win"
                                                else ("Kc", "Vc", "lse_c", "Oc")))
                kw = dict(mode="win", w=cfg.w) if branch == "win" else dict(mode="cmp", l=cfg.l,
                                                                            d=cfg.d)
                want, rss = banded_bwd_rss(x["Q"], K, V, x["dO"], lse,
                                           attention_delta(x["dO"], O), **kw, scale=sc,
                                           seq_start=ds)
                refs[branch] = (want, tuple(allowed_tc_err(w, r) for w, r in zip(want, rss)))
            else:
                refs[branch] = (plain(), (allowed_rel_err,) * 3)
        want, bounds = refs[branch]
        got, again = kern(), kern()
        errs[name] = max(check(f"{name}@varlen:{n}", g, w, bound=bd)
                         for n, g, w, bd in zip(("dQ", "dK", "dV"), got, want, bounds))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name} with seq_start {dtype}: two launches differ")
        if dtype == torch.bfloat16:
            faults = [worst_ratio(g * FAULT, w, bd) for g, w, bd in zip(got, want, bounds)]
            if not min(faults) > 1.0:
                fail(f"{name} with seq_start: a planted {FAULT - 1:.0%} fault passes the bound")
        dense = max(worst_ratio(g, w, bd) for g, w, bd in zip(kern(None), want, bounds))
        print(f"[varlen] {name} {str(dtype)[6:]}: two launches identical; with the dense bound "
              f"on the packed input: worst err/bound {dense:.3f} (must exceed 1)")
        if not dense > 1.0:
            fail(f"{name}: the dense bound passes the varlen check")
        got_all[name] = got
        del again
    for a, b in (("win_bwd_diag", "banded_bwd_1p@win"), ("banded_bwd@win", "banded_bwd_1p@win"),
                 ("banded_bwd@cmp", "banded_bwd_1p@cmp")):
        for n, g, w in zip(("dQ", "dK", "dV"), got_all[a], got_all[b]):
            check(f"{a}@varlen:{n} vs {b}", g, w, bound=allowed_rel_err)
    return errs


def phase_varlen_kernels(dev, ds) -> dict:
    """Rows 1, 3, 7, 8 and 11 with seq_start ds [B_TRAIN, S] at the train
    shape, f32 (TF32 off) then bf16. Returns the bf16 inputs and max
    errors."""
    gen = torch.Generator(device=dev).manual_seed(8642)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = varlen_kernel_inputs(dtype, dev, gen, ds)
        rec.update(varlen_fwd_checks(x, dtype))
        rec.update(varlen_bwd_checks(x, dtype))
        print(f"[varlen] rows 1, 3, 7, 8, 11 with seq_start {str(dtype)[6:]}: within their bounds, "
              f"two launches identical, the dense bound fails each")
        if dtype == torch.bfloat16:
            rec["inputs"] = x
        del x
        torch.cuda.empty_cache()
    return rec


def phase_varlen_long(dev, ds) -> dict:
    """Rows 5 (banded_attn, cmp) and 6 (select_blocks) with seq_start ds
    [1, S_LONG] at 64k, f32 then bf16, on the last N_CHECK rows against the
    plain versions with it (t_start / pos_offset and the rows' own
    seq_start); two launches identical; the dense bound must fail. Returns
    the bf16 inputs and max errors."""
    gen = torch.Generator(device=dev).manual_seed(1357)
    t0 = S_LONG - N_CHECK
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = long_inputs(dtype, dev, gen, S_LONG)
        cfg, sc = x["cfg"], x["scale"]
        cargs, kw = (x["Q"], x["Kc"], x["Vc"]), dict(mode="cmp", l=cfg.l, d=cfg.d, scale=sc)

        def plain(a, b, with_lse=False):
            return banded_attn_plain(x["Q"][:, a:b], x["Kc"], x["Vc"], **kw, t_start=a,
                                     return_lse=with_lse, seq_start=ds[:, a:b])

        def rss(a=t0, b=S_LONG):
            return banded_attn_rss(x["Q"][:, a:b], x["Kc"], x["Vc"], **kw, t_start=a,
                                   seq_start=ds[:, a:b])

        rec["banded_attn@cmp@varlen-64k"] = fwd_check(
            "banded_attn@cmp@varlen-64k", lambda: banded_attn(*cargs, **kw, return_lse=True,
                                                              seq_start=ds),
            dtype, S_LONG, plain, rss, tc=dtype == torch.bfloat16, lse=True, rows=(t0, S_LONG),
            chunk=None)
        dense_bound_fails("banded_attn@cmp@varlen-64k", banded_attn(*cargs, **kw)[:, t0:],
                          fwd_bound(dtype, plain(t0, S_LONG), rss))
        sel = select_blocks(x["Q"], x["Kc"], **sel_kw(x), seq_start=ds)
        again = select_blocks(x["Q"], x["Kc"], **sel_kw(x), seq_start=ds)
        selp, p_grp = select_blocks_plain(x["Q"][:, t0:], x["Kc"], **sel_kw(x), pos_offset=t0,
                                          return_scores=True, seq_start=ds[:, t0:])
        n_diff, n_far, spread = near_tie_rows(sel[:, t0:], selp, p_grp)
        forced = torch.equal(sel[:, t0:, :, :3], selp[..., :3])
        dense_far = near_tie_rows(select_blocks(x["Q"], x["Kc"], **sel_kw(x))[:, t0:], selp,
                                  p_grp)[1]
        print(f"[varlen] select_blocks {str(dtype)[6:]:8s} 64k: sel rows differing on near ties: "
              f"{n_diff} of {selp.shape[1] * selp.shape[2]} (widest spread {spread:.3e}); "
              f"forced slots in order: {forced}; two launches identical: "
              f"{torch.equal(sel, again)}; with the dense bound, rows differing beyond a near "
              f"tie: {dense_far} (must be > 0)")
        if n_far or not forced or not torch.equal(sel, again) or not dense_far:
            fail(f"select_blocks with seq_start {dtype}: sets differ beyond the near-tie bound, "
                 f"or the forced slots or two launches differ, or the dense bound passes")
        rec["select_blocks@varlen-64k"] = spread
        if dtype == torch.bfloat16:
            rec["inputs"] = dict(x, ds=ds)
        del x, sel, again, selp, p_grp
        torch.cuda.empty_cache()
    return rec


def logit_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of want's largest |logit|."""
    return float((got.float() - want.float()).abs().max()) / bf16_ulp(float(want.abs().max()))


def packed_equals_alone(dev, params, toks, ds, spans) -> None:
    """m7c (bf16, no grad) on a packed batch with seq_start against each
    document run alone, at position 0 of its own row of a batch of the same
    shape without seq_start (so the same GEMM shapes run): logits within
    LOGIT_ULPS bf16 ulps of the document's largest |logit|, and the same
    selection in every layer (packed block ids less the document's first
    block). The witness of where the ulps come from: the compressed
    stream's key tiles (64 pooled tokens, CMP_TILE_TOKENS raw ones) sit at
    absolute multiples, so a document that starts off that grid sums its
    compressed softmax in other chunks than alone; one that starts on it
    (each row's first, at 0) must read 0 ulps."""
    mcfg, l_sel = M7C_125M, M7C_125M.nsa.l_sel
    Bq, S_row = ds.shape
    worst = {True: 0.0, False: 0.0}   # documents on / off the compressed key-tile grid
    flips = 0
    with torch.no_grad():
        logits, aux = model_forward(params, toks[:, :-1], mcfg, collect_aux=True,
                                    seq_start=ds)
        for i in range(0, len(spans), Bq):
            group = spans[i:i + Bq]
            alone = torch.zeros_like(toks[:, :-1])
            for j, (r, a, n) in enumerate(group):
                alone[j, :n] = toks[r, a:a + n]
            la, aux_a = model_forward(params, alone, mcfg, collect_aux=True)
            for j, (r, a, n) in enumerate(group):
                on = a % CMP_TILE_TOKENS == 0
                worst[on] = max(worst[on], logit_ulps(logits[r, a:a + n], la[j, :n]))
                for layer, layer_a in zip(aux, aux_a):
                    sp = canonicalize_sel(layer["sel_idx"][r, a:a + n])
                    sp = torch.where(sp >= 0, sp - a // l_sel, sp)
                    sa = canonicalize_sel(layer_a["sel_idx"][j, :n])
                    flips += int((sp != sa).any(-1).sum())
    n_on = sum(a % CMP_TILE_TOKENS == 0 for _, a, _ in spans)
    print(f"[varlen] packed equals alone: {len(spans)} documents of {Bq} x {S_row} packed rows "
          f"(lengths {min(n for *_, n in spans)} .. {max(n for *_, n in spans)}): logits within "
          f"{max(worst.values()):.2f} bf16 ulps of each document's max |logit| (bound "
          f"{LOGIT_ULPS}); the {n_on} starting at a multiple of {CMP_TILE_TOKENS} tokens "
          f"{worst[True]:.2f} (must be 0), the {len(spans) - n_on} others {worst[False]:.2f}; "
          f"(token, layer, group) selections that differ: {flips}")
    if not max(worst.values()) <= LOGIT_ULPS or worst[True] != 0.0 or flips:
        fail("a packed document's logits or selection differ from the document alone")


def no_leak(name, params, toks, ds, spans, victim: int) -> None:
    """Perturbs document `victim`'s tokens: every other document's logits
    (m7c bf16, no grad, seq_start) must be bit-identical, the victim's not."""
    r, a, n = spans[victim]
    pert = toks.clone()
    pert[r, a:a + n] = (pert[r, a:a + n] + 101) % M7C_125M.vocab_size
    with torch.no_grad():
        base = model_forward(params, toks[:, :-1], M7C_125M, seq_start=ds)[0]
        moved = model_forward(params, pert[:, :-1], M7C_125M, seq_start=ds)[0]
    diff = (moved - base).abs().amax(-1)                                  # [B, S]
    own = torch.zeros_like(diff, dtype=torch.bool)
    own[r] = ds[r] == a                                  # the document and its padding
    other, inside = float(diff[~own].max()), float(diff[own].max())
    print(f"[varlen] no leak at {name}: document {victim} ({n} tokens at row {r}, {a}) "
          f"perturbed: its logits move by up to {inside:.4f}; every other position's by "
          f"{other} (must be 0.0)")
    if other != 0.0 or not inside > 0.0:
        fail(f"cross-document influence at {name}")


def varlen_grad_check(dev) -> None:
    """The varlen m7c step's first f32 gradient under each setting of
    DESIGNS against the default keys' within STEP_GRAD_TOL per leaf; a
    backward kernel of the default keys that drops seq_start must fail it.
    These f32 runs launch the FMA kernels: no row takes its launches from
    them."""
    ref = first_grads(dev, "float32", None, varlen=True)

    def gap(keys, fault=None):
        got = first_grads(dev, "float32", keys, fault, varlen=True)
        errs = torch.stack([(g.float() - r.float()).norm() / r.float().norm()
                            for (_, g), (_, r) in zip(got, ref)])
        i = int(errs.argmax())
        return float(errs[i]), got[i][0]

    bad = []
    print(f"[varlen grads] float32: first step's gradient over {len(ref)} leaves vs the default "
          f"keys' (bound {STEP_GRAD_TOL:g}):")
    for label, keys in DESIGNS.items():
        err, leaf = gap(keys)
        print(f"[varlen grads]   {label}: {err:.3e} ({leaf})")
        if not err <= STEP_GRAD_TOL:
            bad.append(label)
    cmp_kernel = tuning.backward_kernel("cmp", M7C_125M_TRAIN.seq_len, M7C_125M.nsa.w)
    err, leaf = gap(None, ("drop ds", cmp_kernel))
    print(f"[varlen grads]   planted: {cmp_kernel} without seq_start: {err:.3e} ({leaf}); must "
          f"exceed the bound")
    if not err > STEP_GRAD_TOL:
        bad.append("planted")
    if bad:
        fail(f"the varlen step's first gradient check failed for {bad}")


def varlen_rows(krec, lrec, runs, long_counts) -> list:
    """The JSON rows of the kernels that take seq_start, on packed
    documents (bf16): rows 1 and 3 and the backward designs at the train
    shape, rows 5 and 6 at 64k; launches from the varlen bf16 steps (`runs`:
    the default keys' counts, then each design's: train_designs) and the
    64k forward (`long_counts`)."""
    x = krec["inputs"]
    cfg, sc = x["cfg"], x["scale"]
    counts = runs[0]
    out = [select_cmp_row("select_cmp@varlen", x, lse=True, launches=counts["select_cmp"],
                          max_err=krec["select_cmp@varlen"])]
    wargs = (x["Q"], x["Kw"], x["Vw"])
    out.append(band_row("win_attn@varlen", lambda: win_attn(*wargs, w=cfg.w, scale=sc,
                                                            return_lse=True, seq_start=x["ds"]),
                        *wargs, mode="win", kw=dict(w=cfg.w), lse=True,
                        launches=counts["win_attn"], max_err=krec["win_attn@varlen"], iters=10,
                        seq_start=x["ds"]))
    bwd = measure_train(krec, runs, VARLEN_BWD, calls=varlen_bwd_calls(x), suffix="@varlen")
    y = lrec["inputs"]
    cargs, ds = (y["Q"], y["Kc"], y["Vc"]), y["ds"]
    kw = dict(mode="cmp", l=cfg.l, d=cfg.d, scale=y["scale"])
    out.append(band_row("banded_attn@cmp@varlen-64k",
                        lambda: banded_attn(*cargs, **kw, seq_start=ds), *cargs, mode="cmp",
                        kw=dict(l=cfg.l, d=cfg.d), lse=False, launches=long_counts["banded_attn"],
                        max_err=lrec["banded_attn@cmp@varlen-64k"], iters=5, chunk=N_CHECK,
                        seq_start=ds))
    sel = select_blocks(y["Q"], y["Kc"], **sel_kw(y), seq_start=ds)
    pairs = float(banded_mask(S_LONG, y["Kc"].shape[2], mode="cmp", l=cfg.l, d=cfg.d,
                              device=ds.device, seq_start=ds).sum()) * cfg.n_kv_groups \
        * cfg.h_per_group
    bms, by = bound(nbytes(y["Q"], y["Kc"], sel, ds), pairs * 2 * cfg.d_k, y["Q"].dtype)
    out.append(dict(
        name="select_blocks@varlen-64k", source="nsa_vibe_tpu_torch/csrc/select_blocks_mma.cu",
        replaces="nsa_vibe_tpu/ops/pallas/scorer.py:186",
        launches=long_counts["select_blocks"], max_abs_err=lrec["select_blocks@varlen-64k"],
        ms=time_ms(lambda: select_blocks(y["Q"], y["Kc"], **sel_kw(y), seq_start=ds), 5,
                   hold=True),
        plain_ms=time_ms(lambda: [select_blocks_plain(y["Q"][:, s:s + N_CHECK], y["Kc"],
                                                      **sel_kw(y), pos_offset=s,
                                                      seq_start=ds[:, s:s + N_CHECK])
                                  for s in range(0, S_LONG, N_CHECK)], 1, 1, hold=True),
        bound_ms=bms, bound_by=by, library_ms=None))
    print_rows(out)
    return out[:2] + bwd + out[2:]


def phase_varlen(dev) -> list:
    """Phase (h): packed documents (varlen). Kernel checks with seq_start
    (train shape: rows 1, 3, 7, 8, 11; 64k: rows 5, 6), packed-equals-alone
    and no-leak at 8 x 2048, no-leak at 1 x 65536 (the long route, launches
    counted), the varlen train step (timed, traced, launches, syncs), a
    varlen train() whose loss falls, one f32 varlen layer card vs CPU, the
    varlen step's first gradient under every design, and the JSON rows.
    Returns the rows."""
    toks, ds_np, lm, spans = varlen_pack(B_TRAIN, S, VARLEN_SEED, VARLEN_MUST)
    ds = torch.from_numpy(ds_np).to(dev)
    print(f"[varlen] {B_TRAIN} x {S} packed rows at l_sel {M7C_125M.nsa.l_sel}: {len(spans)} "
          f"documents of {min(n for *_, n in spans)} .. {max(n for *_, n in spans)} tokens; "
          f"supervised share {lm.mean():.3f}")
    krec = phase_varlen_kernels(dev, ds)
    toks64, ds64_np, _, spans64 = varlen_pack(1, S_LONG, VARLEN_SEED + 1, VARLEN_MUST[:3])
    ds64 = torch.from_numpy(ds64_np).to(dev)
    lrec = phase_varlen_long(dev, ds64)
    params = init_model_params(M7C_125M, torch.Generator().manual_seed(0), device=dev)
    toks_d = torch.from_numpy(toks).long().to(dev)
    packed_equals_alone(dev, params, toks_d, ds, spans)
    no_leak(f"{B_TRAIN} x {S}", params, toks_d, ds, spans, victim=2)
    toks64_d = torch.from_numpy(toks64).long().to(dev)
    with torch.no_grad():
        model_forward(params, toks64_d[:, :-1], M7C_125M, seq_start=ds64)      # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        model_forward(params, toks64_d[:, :-1], M7C_125M, seq_start=ds64)
        torch.cuda.synchronize()
    long_counts = kernels.launch_counts()
    L = M7C_125M.n_layers
    want = {**dict.fromkeys(long_counts, 0), "sel_attn": L, "win_attn": L, "banded_attn": L,
            "select_blocks": L}
    print(f"[varlen] 1 x {S_LONG} forward on packed documents ({len(spans64)}): launches "
          f"{long_counts}; expected {want}")
    if long_counts != want:
        fail(f"varlen 64k launch counts {long_counts} != {want}")
    no_leak(f"1 x {S_LONG}", params, toks64_d, ds64, spans64, victim=len(spans64) // 2)
    del params, toks64_d
    torch.cuda.empty_cache()
    tr = phase_train(dev, "varlen", varlen=True)
    runs = [tr["counts"]] + train_designs(dev, tr["losses"], varlen=True)
    loss_falls(dev, varlen=True)
    train_layer_check(dev, {"default": None}, seq_start=ds[:2].cpu())
    varlen_grad_check(dev)
    rows = varlen_rows(krec, lrec, runs, long_counts)
    del krec, lrec
    torch.cuda.empty_cache()
    print(f"[varlen] step {tr['step_ms']:.3f} ms, busy {tr['busy']:.3f} ms, idle share "
          f"{1 - tr['busy'] / tr['step_ms']:.3f}; launches over {TIMED_STEPS} steps "
          f"{tr['counts']}")
    return rows


# ------------------------------------------------------------------ (i)
# Data-, fully-sharded- and context-parallel training (parallel/). This
# script needs one card, and NCCL refuses two ranks on one device, so the
# two ranks of (i-sp) and (i-fsdp) share the card over gloo (which stages
# CUDA tensors through host memory): their times are per-rank costs of
# two processes time-sharing one card, and say nothing of NCCL scaling
# across cards.

S_POD, B_POD = 4096, 8    # configs/m7c_125m_pod.yaml's seq_len; rows per dp member
OFF_T0 = S_POD // 2       # (i-kernels): the second sp rank's rows [2048, 4096)
POD_STEPS = 3             # timed parallel steps (after a warm-up)
PAR_RANKS = 2
PAR_DIR = os.path.join("artifacts", "chip_smoke_parallel")   # git-ignored, inside the checkout
PAR_TIMEOUT_S = 900
PAR_LAYERS = 2            # the two-rank runs of (i), (j), (k): m7c at full width, its 12 layers cut
#                           to 2 to keep the whole run within its time limit (4 until phase (n))


def par_model():
    """The model of the two-rank runs of (i) and (j)."""
    return dataclasses.replace(M7C_125M, n_layers=PAR_LAYERS)
OFF_BWD = ("banded_bwd_1p@win", "banded_bwd_1p@cmp", "banded_bwd@win", "banded_bwd@cmp",
           "win_bwd_diag", "sel_attn_bwd_1p", "sel_attn_bwd")


def offset_kernel_inputs(dtype, dev, gen) -> dict:
    """Branch operands of the second sp rank at the pod shape: Q, dO of B_POD
    x (S_POD - OFF_T0) rows at positions t = [OFF_T0, S_POD), K/V of all
    S_POD keys (selection, window) or of their compressed tokens, M of
    S_POD; the selection from select_cmp and the forward outputs with lse
    from the kernels at the offset."""
    cfg = M7C_125M.nsa
    G, h, D = cfg.n_kv_groups, cfg.h_per_group, cfg.d_k
    meta = build_block_meta(S_POD, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)
    S_q = S_POD - OFF_T0

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    x = dict(cfg=cfg, scale=1.0 / float(np.sqrt(D)), t0=OFF_T0, Q=r(B_POD, S_q, G, h, D),
             dO=r(B_POD, S_q, G, h, D), Kc=r(B_POD, G, meta.S_cmp, D),
             Vc=r(B_POD, G, meta.S_cmp, D), Kw=r(B_POD, G, S_POD, D), Vw=r(B_POD, G, S_POD, D),
             K=r(B_POD, G, S_POD, D), V=r(B_POD, G, S_POD, D),
             t=torch.arange(OFF_T0, S_POD, device=dev), M=torch.from_numpy(meta.M_csl).to(dev))
    x["sel"], x["Oc"], x["lse_c"] = select_cmp(x["Q"], x["Kc"], x["Vc"], x["M"], **cmp_kw(x),
                                               return_lse=True, pos_offset=OFF_T0)
    x["Os"], x["lse_s"] = sel_attn(x["Q"], x["K"], x["V"], x["sel"], x["t"], l_sel=cfg.l_sel,
                                   scale=x["scale"], return_lse=True)
    x["Ow"], x["lse_w"] = banded_attn(x["Q"], x["Kw"], x["Vw"], mode="win", w=cfg.w,
                                      scale=x["scale"], return_lse=True, t_start=OFF_T0)
    return x


def offset_zero_fails(name, got0, want, bd) -> None:
    """The second planted fault of phase (i): the kernel launched at offset
    0 on the offset rows must fail their check."""
    worst = worst_ratio(got0, want, bd)
    print(f"[offset] {name}: the same kernel at offset 0: worst err/bound {worst:.3f} (must "
          f"exceed 1)")
    if not worst > 1.0:
        fail(f"{name}: the kernel at offset 0 passes the offset rows' check")


def offset_fwd_checks(x, dtype) -> dict:
    """Row 1 (select_cmp at pos_offset) against its plain version at the
    offset (fwd_check: two launches bit-equal, bf16 tensor-core bound with
    a planted 1% fault, lse); sets equal but at near ties, forced slots in
    order; in bf16 O and lse banded_attn's (cmp, t_start) bit for bit; the
    kernel at offset 0 must fail. Then the forwards the second sp rank runs
    beside it, as fwd_check holds them, each launched at offset 0 failing:
    row 2 (sel_attn on rows at positions t against S_POD keys, S != S_kv)
    and row 3 (the window forward at t_start, banded_attn in window mode,
    as ops/attention.py launches it for t_start > 0)."""
    cfg, sc, t0 = x["cfg"], x["scale"], x["t0"]
    Q, Kc, Vc, M = x["Q"], x["Kc"], x["Vc"], x["M"]
    kw = cmp_kw(x)
    sel_k = select_cmp(Q, Kc, Vc, M, **kw, pos_offset=t0)[0]
    sel_2 = select_cmp(Q, Kc, Vc, M, **kw, pos_offset=t0)[0]
    sel_p, _, p_grp = select_cmp_plain(Q, Kc, Vc, M, **kw, return_scores=True, pos_offset=t0)
    n_diff, n_far, spread = near_tie_rows(sel_k, sel_p, p_grp)
    forced = torch.equal(sel_k[..., :3], sel_p[..., :3])
    far0 = near_tie_rows(select_cmp(Q, Kc, Vc, M, **kw)[0], sel_p, p_grp)[1]
    print(f"[offset] select_cmp {str(dtype)[6:]:8s} at pos_offset {t0}: sel rows differing on "
          f"near ties: {n_diff} (widest spread {spread:.3e}); forced slots in order: {forced}; "
          f"two launches identical: {torch.equal(sel_k, sel_2)}; at offset 0, rows differing "
          f"beyond a near tie: {far0} (must be > 0)")
    if n_far or not forced or not torch.equal(sel_k, sel_2) or not far0:
        fail(f"select_cmp at pos_offset {dtype}: sets differ beyond the near-tie bound, or the "
             f"forced slots or two launches differ, or offset 0 passes")
    del sel_k, sel_2, sel_p, p_grp

    def plain_c(a, b, with_lse=False):
        out = select_cmp_plain(Q, Kc, Vc, M, **kw, return_lse=with_lse, pos_offset=t0)
        return out[1:] if with_lse else out[1]

    def rss_c(a=0, b=0):
        return banded_attn_rss(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d, scale=sc, t_start=t0)

    errs = {"select_cmp@offset": fwd_check(
        "select_cmp@offset", lambda: select_cmp(Q, Kc, Vc, M, **kw, return_lse=True,
                                                pos_offset=t0)[1:],
        dtype, Q.shape[1], plain_c, rss_c, tc=dtype == torch.bfloat16, lse=True, rows=None,
        chunk=None)}
    offset_zero_fails("select_cmp@offset", select_cmp(Q, Kc, Vc, M, **kw)[1],
                      *fwd_bound(dtype, plain_c(0, 0), rss_c))
    if dtype == torch.bfloat16:
        O, L_ = select_cmp(Q, Kc, Vc, M, **kw, return_lse=True, pos_offset=t0)[1:]
        Ob, Lb = banded_attn(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d, scale=sc, return_lse=True,
                             t_start=t0)
        same = torch.equal(O, Ob) and torch.equal(L_, Lb)
        print(f"[offset] select_cmp: O and lse bit-equal to banded_attn (cmp, t_start): {same}")
        if not same:
            fail("select_cmp at pos_offset: O or lse differ from banded_attn's in cmp mode")
        del O, L_, Ob, Lb
    sargs = (Q, x["K"], x["V"], x["sel"], x["t"])
    skw = dict(l_sel=cfg.l_sel, scale=sc)
    errs["sel_attn@offset"] = sel_fwd_check(
        "sel_attn@offset", lambda: sel_attn(*sargs, **skw, return_lse=True), *sargs, **skw,
        lse=True, chunk=S_POD // 4)
    offset_zero_fails("sel_attn@offset", sel_attn(*sargs[:4], x["t"] - t0, **skw),
                      *fwd_bound(dtype, sel_attn_plain(*sargs, **skw),
                                 lambda: sel_attn_rss(*sargs, **skw)))
    wargs, wkw = (Q, x["Kw"], x["Vw"]), dict(mode="win", w=cfg.w, scale=sc)
    errs["banded_attn@win@offset"] = banded_fwd_check(
        "banded_attn@win@offset", lambda: banded_attn(*wargs, **wkw, return_lse=True, t_start=t0),
        *wargs, mode="win", kw=dict(w=cfg.w), scale=sc, lse=True, t_start=t0)
    k0 = t0 - cfg.w + 1   # the window rows see no key before it
    part = (Q, x["Kw"][:, :, k0:], x["Vw"][:, :, k0:])
    offset_zero_fails("banded_attn@win@offset", banded_attn(*wargs, **wkw),
                      *fwd_bound(dtype, banded_attn_plain(*part, **wkw, t_start=t0 - k0),
                                 lambda: banded_attn_rss(*part, **wkw, t_start=t0 - k0)))
    return errs


def offset_bwd_calls(x) -> dict:
    """name -> (kernel call at offset t (under seq_start s), plain call at
    x's offset, visibility mask [B,S,G,S_kv]) of the banded and selection
    backward kernels on x's offset rows; under x["ds"] (phase (j): packed
    documents at the offset; the selection's operands absent) the banded
    ones only, each call under seq_start x["ds"] by default."""
    cfg, sc, t0, ds = x["cfg"], x["scale"], x["t0"], x.get("ds")
    Q, dO = x["Q"], x["dO"]
    Bq, S_q, G = Q.shape[:3]
    win = dict(mode="win", w=cfg.w, scale=sc)
    cmp_ = dict(mode="cmp", l=cfg.l, d=cfg.d, scale=sc)
    wargs = (Q, x["Kw"], x["Vw"], dO, x["lse_w"], attention_delta(dO, x["Ow"]))
    cargs = (Q, x["Kc"], x["Vc"], dO, x["lse_c"], attention_delta(dO, x["Oc"]))
    sel = dict(l_sel=cfg.l_sel, scale=sc)

    def sargs(t):   # the selection's operands, query row s at position t + s
        return (Q, x["K"], x["V"], x["sel"], x["t"] - t0 + t, dO, x["lse_s"],
                attention_delta(dO, x["Os"]))

    def mask(args, kw):
        m = banded_mask(S_q, args[1].shape[2], **{k: v for k, v in kw.items() if k != "scale"},
                        t_start=t0, device=Q.device, seq_start=ds)
        if ds is not None:
            return m[:, :, None, :].expand(-1, -1, G, -1)
        return m[None, :, None, :].expand(Bq, -1, G, -1)

    table = {"banded_bwd_1p@win": (banded_bwd_1p, wargs, win),
             "banded_bwd_1p@cmp": (banded_bwd_1p, cargs, cmp_),
             "banded_bwd@win": (banded_bwd, wargs, win),
             "banded_bwd@cmp": (banded_bwd, cargs, cmp_),
             "win_bwd_diag": (None, wargs, win)}
    out = {} if ds is not None else {
        name: (lambda t=t0, fn=fn: fn(*sargs(t), **sel),
               lambda: sel_attn_bwd_plain(*sargs(t0), **sel),
               lambda: selection_token_mask(x["sel"], x["t"], cfg.l_sel, S_POD))
        for name, fn in (("sel_attn_bwd_1p", sel_attn_bwd_1p), ("sel_attn_bwd", sel_attn_bwd))}
    for name, (fn, args, kw) in table.items():
        if fn is None:
            def kern(t=t0, s=ds, args=args):
                return win_bwd_diag(*args, w=cfg.w, scale=sc, t_start=t, seq_start=s)
        else:
            def kern(t=t0, s=ds, fn=fn, args=args, kw=kw):
                return fn(*args, **kw, t_start=t, seq_start=s)
        out[name] = (kern, lambda args=args, kw=kw: banded_bwd_plain(*args, **kw, t_start=t0,
                                                                      seq_start=ds),
                     lambda args=args, kw=kw: mask(args, kw))
    return out


def bwd_rounded(Q, K, V, dO, lse, delta, mask, scale: float) -> tuple:
    """(dQ, dK, dV) of the dense formula (ops/reference.py::
    attend_masked_bwd) in f32 with P and dS rounded to bf16 before their
    products, as the tensor-core kernels round them and the TPU kernels do
    (flash_bwd.py:345, :350; sel_flash.py): the design's own arithmetic,
    short of the f32 sum order. mask: [1 or B, S, G, h or 1, S_kv]. One
    batch row at a time (a row's dense scores at the pod shape: 400 MB)."""
    outs = []
    for b in range(Q.shape[0]):
        q, k, v, do = (t[b:b + 1].float() for t in (Q, K, V, dO))
        m = mask[b:b + 1] if mask.shape[0] > 1 else mask
        s = torch.einsum("bsghd,bgkd->bsghk", q, k) * scale
        p = torch.where(m, torch.exp(s - lse[b:b + 1, ..., None]), torch.zeros((), device=s.device))
        ds = p * (torch.einsum("bsghv,bgkv->bsghk", do, v) - delta[b:b + 1, ..., None])
        p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
        outs.append((torch.einsum("bsghk,bgkd->bsghd", ds, k) * scale,
                     torch.einsum("bsghk,bsghd->bgkd", ds, q) * scale,
                     torch.einsum("bsghk,bsghv->bgkv", p, do)))
        del s, p, ds
    return tuple(torch.cat(o) for o in zip(*outs))


def offset_tc_refs(x, branch: str) -> tuple:
    """(center, bounds) of the bf16 backward checks of `branch` at the
    offset. The bounds are allowed_tc_err of the plain version's unrounded
    f32 gradients and their rss (sel_attn_bwd_rss, banded_bwd_rss at
    t_start), as in phases (d) and (f); the center is bwd_rounded, the
    same formula with P and dS rounded to bf16 as the kernels round them.
    At this shape every key past the window's edge sums a full band (512
    rows x h heads), so few elements have the ulp term's slack, and the
    design's exact arithmetic lands beyond the rss term's 4.7 standard
    deviations on some of its ~2.6M dV elements (PERF.md §6, PR 13): the
    kernels are held to what their arithmetic gives, with the same width.
    The design's own distance to the unrounded gradients is printed."""
    cfg, sc, t0, dO, ds = x["cfg"], x["scale"], x["t0"], x["dO"], x.get("ds")
    if branch == "sel":
        args = (x["Q"], x["K"], x["V"], dO, x["lse_s"], attention_delta(dO, x["Os"]))
        want, rss = sel_attn_bwd_rss(*args[:3], x["sel"], x["t"], *args[3:], l_sel=cfg.l_sel,
                                     scale=sc)
        mask = selection_token_mask(x["sel"], x["t"], cfg.l_sel, S_POD)[:, :, :, None, :]
    else:
        K, V, lse, O = (x[k] for k in (("Kw", "Vw", "lse_w", "Ow") if branch == "win"
                                        else ("Kc", "Vc", "lse_c", "Oc")))
        kw = dict(mode="win", w=cfg.w) if branch == "win" else dict(mode="cmp", l=cfg.l, d=cfg.d)
        args = (x["Q"], K, V, dO, lse, attention_delta(dO, O))
        want, rss = banded_bwd_rss(*args, **kw, scale=sc, t_start=t0, seq_start=ds)
        mask = banded_mask(x["Q"].shape[1], K.shape[2], **kw, t_start=t0, device=dO.device,
                           seq_start=ds)
        mask = mask[None, :, None, None, :] if ds is None else mask[:, :, None, None, :]
    bounds = tuple(allowed_tc_err(w, r) for w, r in zip(want, rss))
    center = bwd_rounded(*args, mask, sc)
    own = [worst_ratio(c, w, bd) for c, w, bd in zip(center, want, bounds)]
    print(f"[{offset_tag(x)}] {branch} backward, bf16 arithmetic (P and dS rounded) vs the "
          f"unrounded plain gradients: worst err/bound dQ, dK, dV "
          f"{', '.join(f'{v:.3f}' for v in own)}")
    return center, bounds, want


def offset_tag(x) -> str:
    return "offset" if x.get("ds") is None else "docs-offset"


def offset_bwd_checks(x, dtype, names=OFF_BWD) -> dict:
    """Rows 7 (win, cmp), 8 (win, cmp) and 11 at t_start, rows 9 and 10 on
    rows at positions t against S_POD keys (`names` of them), against the
    plain version at the offset (f32 allowed_rel_err; bf16 allowed_tc_err
    around offset_tc_refs' center, where a planted 1% fault must fail), two
    launches bit-equal, the SAME_P_DS pairs within allowed_rel_err of each
    other and rows 9 and 10 within their bound of each other; each kernel
    launched at offset 0 must fail, and under x["ds"] (phase (j)) also each
    launched without seq_start."""
    t0, tag = x["t0"], offset_tag(x)
    calls = offset_bwd_calls(x)
    refs, errs, got_all = {}, {}, {}
    for name in names:
        kern, plain, _ = calls[name]
        branch = branch_of(name)
        if branch not in refs:
            refs[branch] = (offset_tc_refs(x, branch) if dtype == torch.bfloat16
                            else (plain(), (allowed_rel_err,) * 3, None))
        want, bounds, unrounded = refs[branch]
        got, again = kern(), kern()
        errs[name] = max(check(f"{name}@{tag}:{n}", g, w, bound=bd)
                         for n, g, w, bd in zip(("dQ", "dK", "dV"), got, want, bounds))
        if unrounded is not None:   # the JSON row's error, as the other rows': vs unrounded
            errs[name] = max(float((g.float() - w).abs().max()) for g, w in zip(got, unrounded))
            print(f"[{tag}] {name}: vs the unrounded plain gradients, max_abs_err "
                  f"{errs[name]:.3e}, worst err/bound "
                  + ", ".join(f"{worst_ratio(g, w, bd):.3f}"
                              for g, w, bd in zip(got, unrounded, bounds)))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name} at t_start {dtype}: two launches differ")
        if dtype == torch.bfloat16:
            faults = [worst_ratio(g * FAULT, w, bd) for g, w, bd in zip(got, want, bounds)]
            if not min(faults) > 1.0:
                fail(f"{name} at t_start: a planted {FAULT - 1:.0%} fault passes the bound")
        at0 = max(worst_ratio(g, w, bd) for g, w, bd in zip(kern(0), want, bounds))
        dropped = (max(worst_ratio(g, w, bd) for g, w, bd in zip(kern(t0, None), want, bounds))
                   if "ds" in x else 2.0)
        print(f"[{tag}] {name} {str(dtype)[6:]} at offset {t0}: two launches identical; at "
              f"offset 0: worst err/bound {at0:.3f} (must exceed 1)"
              + (f"; without seq_start: {dropped:.3f} (must exceed 1)" if "ds" in x else ""))
        if not at0 > 1.0 or not dropped > 1.0:
            fail(f"{name}: the kernel at offset 0 (or without seq_start) passes the offset rows' "
                 f"check")
        got_all[name] = got
        del again
    for a, b in (("win_bwd_diag", "banded_bwd_1p@win"), ("banded_bwd@win", "banded_bwd_1p@win"),
                 ("banded_bwd@cmp", "banded_bwd_1p@cmp"), ("sel_attn_bwd", "sel_attn_bwd_1p")):
        if a not in got_all:
            continue
        bounds = (allowed_rel_err,) * 3 if branch_of(a) != "sel" else refs["sel"][1]
        for n, g, w, bd in zip(("dQ", "dK", "dV"), got_all[a], got_all[b], bounds):
            check(f"{a}@{tag}:{n} vs {b}", g, w, bound=bd)
    return errs


def phase_offset_kernels(dev) -> dict:
    """(i-kernels): rows 1, 2, 3, 7, 8, 9, 10 and 11 at the query offset of
    the second sp rank of the pod shape, f32 (TF32 off) then bf16. Returns
    the bf16 inputs and max errors."""
    gen = torch.Generator(device=dev).manual_seed(2468)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = offset_kernel_inputs(dtype, dev, gen)
        rec.update(offset_fwd_checks(x, dtype))
        rec.update(offset_bwd_checks(x, dtype))
        print(f"[offset] rows 1, 2, 3, 7, 8, 9, 10, 11 at offset {OFF_T0} ({B_POD} x "
              f"{S_POD - OFF_T0} rows "
              f"against {S_POD} keys) {str(dtype)[6:]}: within their bounds, two launches "
              f"identical, offset 0 fails each")
        if dtype == torch.bfloat16:
            rec["inputs"] = x
        del x
        torch.cuda.empty_cache()
    return rec


def pod_batches(n: int, rows: int, dev) -> list:
    """n global batches [1, rows, S_POD + 1] of synthetic tokens (seed 1337)."""
    data = make_batches("synthetic", S_POD, rows, seed=M7C_125M_TRAIN.seed)
    return [torch.from_numpy(next(data)).long().to(dev)[None] for _ in range(n)]


def pod_tcfg(dp: int, sp: int, fsdp: bool, rows: int):
    return dataclasses.replace(M7C_125M_TRAIN, batch_size=rows, seq_len=S_POD, dp=dp, sp=sp,
                               fsdp=fsdp)


def split_qkv(names, grads) -> list:
    """[(leaf name, gradient)] with each W_qkv split into its seven
    projections (a fault in one branch's dK or dV meets its own block)."""
    c = M7C_125M.nsa
    widths = [c.n_heads * c.d_k] + [c.n_kv_groups * dim for dim in (c.d_k, c.d_v)] * 3
    out = []
    for name, g in zip(names, grads):
        if name.endswith("/W_qkv"):
            out += [(name[:-len("W_qkv")] + k, p)
                    for k, p in zip(PROJ_KEYS, g.split(widths, dim=1))]
        else:
            out.append((name, g))
    return out


def start_ranks(argv: list, n: int, **popen) -> list:
    """n processes of `python argv` as ranks 0..n-1 of one job on this host,
    with the environment that torch.distributed.run --standalone gives its
    ranks (RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT, a free localhost port; OMP_NUM_THREADS 1 unless set) but
    without its launcher process, whose own start (a torch import, ~9 s on
    the H100 machine) each launch paid."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n),
           "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
    return [subprocess.Popen([sys.executable, *argv], **popen,
                             env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
            for r in range(n)]


def wait_ranks(procs: list, timeout_s: float) -> int | None:
    """0 once every rank has exited with 0; else the first nonzero exit
    code, or None after timeout_s, the other ranks killed (as the launcher
    ended a job)."""
    deadline = time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        if all(c == 0 for c in codes):
            return 0
        bad = [c for c in codes if c not in (None, 0)]
        if bad or time.monotonic() > deadline:
            end_children()   # the ranks (nothing else runs beside them)
            for p in procs:
                p.wait()
            return bad[0] if bad else None
        time.sleep(0.1)


def run_ranks(mode: str, n: int = PAR_RANKS) -> list:
    """Runs n ranks of `chip_smoke.py --parallel-worker mode` on the one
    card (start_ranks, gloo) and returns each rank's results; a rank's
    failure, or ranks that outlive PAR_TIMEOUT_S, fail the phase."""
    outs = [os.path.join(PAR_DIR, f"{mode}_rank{r}.json") for r in range(n)]
    for out in outs:
        if os.path.exists(out):
            os.remove(out)
    argv = [os.path.abspath(__file__), "--parallel-worker", mode]
    print(f"[{mode}] starting {n} ranks on the one card over gloo: {' '.join(argv)}", flush=True)
    t = time.perf_counter()
    rc = wait_ranks(start_ranks(argv, n), PAR_TIMEOUT_S)
    print(f"[{mode}] ranks exited with {rc} after {time.perf_counter() - t:.1f} s")
    if rc != 0 or not all(os.path.exists(out) for out in outs):
        fail(f"the {mode} ranks failed (exit {rc})")
    res = []
    for out in outs:
        with open(out) as f:
            res.append(json.load(f))
    return res


@contextlib.contextmanager
def dropped_offset(kernel: str):
    """Runs the body with ops/attention.py's `kernel` wrapper replaced by
    one that launches at offset 0 (the offset lost on the way to the
    kernel): a fault the sp gradient check must catch."""
    real = getattr(attention, kernel)
    setattr(attention, kernel, lambda *args, t_start=0, **kw: real(*args, **kw))
    try:
        yield
    finally:
        setattr(attention, kernel, real)


@contextlib.contextmanager
def unsummed_fsdp_grads():
    """Runs the body with the fsdp gather's backward returning this rank's
    own slice of its gradient, not the sum over dp: a fault the fsdp
    gradient check must catch."""
    real = pmesh.reduce_scatter_dim
    pmesh.reduce_scatter_dim = lambda x, dim, group, n: x.chunk(n, dim)[
        torch.distributed.get_rank(group)].contiguous()
    try:
        yield
    finally:
        pmesh.reduce_scatter_dim = real


def host_syncs(run, tag: str) -> dict:
    """The host-device synchronisations run() makes (one step, of a rank or
    of one process), by file and line; fails if the port's code makes any
    outside its collectives.
    gloo's worker threads report their host copies through torch's own
    frames (torch/cuda/__init__.py); the port's code must make none but its
    collectives (parallel/mesh.py)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    root = os.path.dirname(os.path.abspath(__file__))
    syncs, ours = {}, {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
            syncs[where] = syncs.get(where, 0) + 1
            if os.path.abspath(w.filename).startswith(root) and \
                    not w.filename.endswith(os.path.join("parallel", "mesh.py")):
                ours[where] = syncs[where]
    print(f"[{tag}] host-device synchronisations in one step: {sum(syncs.values())} "
          f"({syncs or 'none'}); in the port's code outside its collectives "
          f"(parallel/mesh.py): {sum(ours.values())}", flush=True)
    if ours:
        fail(f"{tag}: the step makes the host wait outside the collectives: {ours}")
    return syncs


def rank_device() -> torch.device:
    """The card a rank of (i) or (j) runs on: the one card, shared."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def parallel_worker(mode: str) -> None:
    """One rank of (i-sp) (mode "sp": dp 1, sp 2) or (i-fsdp) (mode "fsdp":
    dp 2, fsdp): the m7c-125M pod-shape step (bf16, remat, default keys),
    timed, traced, launches and host syncs counted; in sp also one step
    under each of DESIGNS' onepass and twopass keys; the f32 first gradient
    against one process's (reference_run), with its planted faults; in fsdp
    the per-rank parameter and moment bytes and a checkpoint saved under
    fsdp. Each rank writes PAR_DIR/<mode>_rank<r>.json (the gradient check
    on rank 0)."""
    initialize_distributed("gloo")
    dev = rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(dp=1, sp=PAR_RANKS) if mode == "sp" else make_mesh(dp=PAR_RANKS, sp=1)
    lead = mesh.rank == 0
    rows = B_POD * mesh.dp
    mcfg, tcfg = par_model(), pod_tcfg(mesh.dp, mesh.sp, mode == "fsdp", rows)
    tag = f"{mode} rank {mesh.rank}"
    step, state = build_state_and_step(
        init_model_params(mcfg, torch.Generator().manual_seed(0), device=dev), mcfg, tcfg, mesh)
    batches = [local_batch(b[0], mesh)[None] for b in pod_batches(POD_STEPS + 2, rows, dev)]
    state, m = step(state, batches[0])                                # warm-up
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(POD_STEPS + 1)]
    ev[0].record()
    for i in range(POD_STEPS):
        state, m = step(state, batches[1 + i])
        ev[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    counts = train_counts()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(POD_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * POD_STEPS for k, v in stage_launches(mesh, mcfg, 1).items()}
    print(f"[{tag}] launches over {POD_STEPS} steps: {counts}; expected {want}", flush=True)
    if counts != want:
        fail(f"{tag}: launch counts {counts} != {want}")
    runs = [counts]
    if mode == "sp":   # the other designs' kernels at the offset, one step each
        for label in ("onepass", "twopass"):
            with design_keys(DESIGNS[label]):
                kernels.reset_launch_counts()
                step(state, batches[1])
                torch.cuda.synchronize()
                c = train_counts()
            if c != stage_launches(mesh, mcfg, 1, DESIGNS[label]):
                fail(f"{tag}: {label} launch counts {c} != "
                     f"{stage_launches(mesh, mcfg, 1, DESIGNS[label])}")
            runs.append(c)
    syncs = host_syncs(lambda: step(state, batches[1]), tag)
    mean_ms = float(np.mean(step_ms))
    busy = trace(lambda: step(state, batches[1]), 1, f"{tag} step", mean_ms)["busy"]
    res = {"losses": [float(v) for v in losses], "step_ms": step_ms, "mean_ms": mean_ms,
           "busy": busy, "peak": peak, "runs": runs, "syncs": syncs,
           "n_params": sum(t.numel() for _, t in param_leaves(state.template))}
    if mode == "fsdp":
        local = [t for _, t in param_leaves(state.params)]
        res["state_bytes"] = nbytes(*local, *state.opt_state["mu"], *state.opt_state["nu"])
        res["dp_state_bytes"] = 3 * nbytes(*(t for _, t in param_leaves(state.template)))
        ckpt = os.path.join(PAR_DIR, "ckpt")
        save_checkpoint(ckpt, int(state.step), state, mesh=mesh)
        full, mu, nu = full_leaves(state, mesh)
        res["ckpt"] = {"dir": ckpt, "step": int(state.step),
                       "sums": [float(t.contiguous().double().sum()) for t in full + mu + nu]}
        state, m = step(state, batches[-1])
        res["ckpt"]["next_loss"] = float(m["loss"])
        del full, mu, nu
    del state, step
    torch.cuda.empty_cache()
    # the f32 first gradient, as the rank holds it after the step's sums;
    # sharded leaves gathered over dp to compare whole
    m32 = dataclasses.replace(mcfg, dtype="float32")
    st32 = build_state(init_model_params(m32, torch.Generator().manual_seed(0), device=dev),
                       dataclasses.replace(tcfg, gate_stats=False), mesh)
    names = [k for k, _ in param_leaves(st32.template)]
    ref = torch.load(os.path.join(PAR_DIR, f"ref_grads_pod{rows}.pt")) if lead else None
    faults = {"sp": {"win_bwd_diag dV x 0.9999": lambda: planted_fault("win_bwd_diag", 2, 0.9999),
                     "win_bwd_diag at offset 0": lambda: dropped_offset("win_bwd_diag"),
                     "banded_bwd_1p (cmp) at offset 0": lambda: dropped_offset("banded_bwd_1p")},
              "fsdp": {"win_bwd_diag dV x 0.9999": lambda: planted_fault("win_bwd_diag", 2, 0.9999),
                       "fsdp gradients not summed over dp": unsummed_fsdp_grads}}[mode]
    res["grad_err"] = {}
    for label, plant in [("base", contextlib.nullcontext)] + list(faults.items()):
        with plant():
            grads = grads_and_stats(st32, m32, dataclasses.replace(tcfg, gate_stats=False),
                                    mesh, batches[0])[1]
        full = [g if a is None else gather_dim(g, a, mesh.dp_group, mesh.dp)
                for g, a in zip(grads, st32.axes)]
        if lead:
            errs = [float((g.float() - r.to(dev).float()).norm() / r.float().norm())
                    for (_, g), (_, r) in zip(split_qkv(names, full), ref)]
            i = int(np.argmax(errs))
            res["grad_err"][label] = [errs[i], ref[i][0]]
        del grads, full
    with open(os.path.join(PAR_DIR, f"{mode}_rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def gathered_bytes(sp: int, rows: int, n_params: int) -> dict:
    """Bytes one rank of an sp step receives by all-gather (the six K/V
    streams of each layer, in the forward and again in the remat
    recompute), sends by reduce-scatter (their gradients, once) and
    all-reduces (every gradient, bf16), reckoned from the shapes."""
    c, L = M7C_125M.nsa, PAR_LAYERS
    stream = rows * c.n_kv_groups * S_POD * (3 * c.d_k + 3 * c.d_v) * 2   # bf16, all six
    share = (sp - 1) / sp
    return {"all_gather": int(L * 2 * stream * share), "reduce_scatter": int(L * stream * share),
            "all_reduce": 2 * n_params}


def phase_parallel(dev) -> list:
    """Phase (i): (i-kernels) in this process, then (i-sp) and (i-fsdp), two
    ranks each on the one card, held against one process on the same
    global batch. Returns the JSON rows of rows 1, 2, 3, 7, 8, 9, 10 and
    11 at the offset (launches: the steps of the sp rank at the offset)."""
    os.makedirs(PAR_DIR, exist_ok=True)
    krec = phase_offset_kernels(dev)
    x = krec.pop("inputs")
    results = {}
    for mode, rows in (("sp", B_POD), ("fsdp", PAR_RANKS * B_POD)):
        ref = reference_run(dev, dict(dp=rows // B_POD, pp=1, sp=1, tp=1, fsdp=False,
                                      varlen=False, mcfg=par_model()), f"pod{rows}", grads=True)
        torch.cuda.empty_cache()
        results[mode] = ranks = run_ranks(mode)
        res = ranks[0]
        gap = max(abs(a - b) for a, b in zip(res["losses"], ref["losses"]))
        mean = res["mean_ms"]
        tokens = rows * S_POD
        print(f"[{mode}] {PAR_LAYERS}-layer m7c bf16 {rows} x {S_POD} over {PAR_RANKS} ranks "
              + ("(sp 2: 4096 positions split in two" if mode == "sp"
                 else "(dp 2, fsdp: 8 rows each") +
              f"): per-rank step ms {', '.join(f'{v:.2f}' for v in res['step_ms'])}; mean "
              f"{mean:.3f} ms (one process on the same batch: {ref['step_ms']:.3f} ms); "
              f"{tokens / (mean / 1e3):.0f} tokens/s, {mfu_text(rows, S_POD, mean, par_model())}; "
              f"rank 0 busy "
              f"{res['busy']:.3f} ms, idle share {1 - res['busy'] / mean:.3f}; peak "
              f"{res['peak'] / 2**30:.2f} GiB a rank")
        print(f"[{mode}] losses {', '.join(f'{v:.4f}' for v in res['losses'])}; one process "
              f"{', '.join(f'{v:.4f}' for v in ref['losses'][:len(res['losses'])])}; max gap "
              f"{gap:.3e} (bound LOSS_TOL {LOSS_TOL:g})")
        if not gap <= LOSS_TOL:
            fail(f"{mode}: losses differ from one process's by {gap:.3e}")
        errs = res["grad_err"]
        print(f"[{mode}] f32 first gradient vs one process, worst leaf ||g - g_1|| / ||g_1||: "
              + "; ".join(f"{k} {v[0]:.3e} ({v[1]})" for k, v in errs.items())
              + f" (bound {STEP_GRAD_TOL:g}; each planted fault must exceed it)")
        if not errs["base"][0] <= STEP_GRAD_TOL:
            fail(f"{mode}: the f32 first gradient differs from one process's by {errs['base'][0]}")
        missed = [k for k, v in errs.items() if k != "base" and not v[0] > STEP_GRAD_TOL]
        if missed:
            fail(f"{mode}: planted faults pass the gradient check: {missed}")
        if mode == "sp":
            b = gathered_bytes(PAR_RANKS, rows, res["n_params"])
            print(f"[sp] bytes a rank moves per step, from the shapes: all-gathered "
                  f"{b['all_gather']} (K/V, forward and remat), reduce-scattered "
                  f"{b['reduce_scatter']} (their gradients), all-reduced {b['all_reduce']} "
                  f"(gradients, bf16)")
        else:
            print(f"[fsdp] parameter + moment bytes a rank: {res['state_bytes']} under fsdp, "
                  f"{res['dp_state_bytes']} under dp "
                  f"({res['state_bytes'] / res['dp_state_bytes']:.4f})")
            ckpt_check(dev, res["ckpt"], rows)
        os.remove(ref["grads"])
    rows_out = offset_rows(x, krec, results["sp"][1]["runs"])
    del x
    torch.cuda.empty_cache()
    return rows_out


def ckpt_check(dev, ck, rows) -> None:
    """The fsdp checkpoint restored on one process: every leaf and moment
    as the ranks held them (float64 sums of the contiguous tensors equal),
    and the next step's loss within LOSS_TOL of the ranks'."""
    mcfg, tcfg = par_model(), pod_tcfg(1, 1, False, rows)
    state = init_train_state(init_model_params(mcfg, torch.Generator().manual_seed(1),
                                               device=dev), tcfg)
    restore_checkpoint(ck["dir"], state)
    leaves = [t for _, t in param_leaves(state.params)]
    sums = [float(t.contiguous().double().sum()) for t in leaves + state.opt_state["mu"]
            + state.opt_state["nu"]]
    same = sums == ck["sums"] and int(state.step) == ck["step"]
    step = make_train_step(mcfg, tcfg)
    _, m = step(state, pod_batches(POD_STEPS + 2, rows, dev)[-1])
    gap = abs(float(m["loss"]) - ck["next_loss"])
    print(f"[fsdp] checkpoint of step {ck['step']} saved under fsdp, restored on one process: "
          f"leaves and moments as the ranks held them: {same}; next step's loss "
          f"{float(m['loss']):.4f} vs the ranks' {ck['next_loss']:.4f} (gap {gap:.3e}, bound "
          f"LOSS_TOL)")
    if not same or not gap <= LOSS_TOL:
        fail("fsdp checkpoint: restored state or next loss differs from the ranks'")
    del state, step
    torch.cuda.empty_cache()


def offset_rows(x, errs, runs) -> list:
    """The JSON rows of rows 1, 2, 3, 7, 8, 9, 10 and 11 at the offset
    (bf16; launches from the second sp rank's steps under each design:
    `runs`)."""
    cfg, t0 = x["cfg"], x["t0"]
    wargs = (x["Q"], x["Kw"], x["Vw"])
    out = [select_cmp_row("select_cmp@offset", x, lse=True, launches=runs[0]["select_cmp"],
                          max_err=errs["select_cmp@offset"]),
           sel_attn_row("sel_attn@offset", x["Q"], x["K"], x["V"], x["sel"], x["t"],
                        launches=runs[0]["sel_attn"], max_err=errs["sel_attn@offset"]),
           band_row("banded_attn@win@offset",
                    lambda: banded_attn(*wargs, mode="win", w=cfg.w, scale=x["scale"],
                                        t_start=t0),
                    *wargs, mode="win", kw=dict(w=cfg.w), lse=False,
                    launches=runs[0]["banded_attn"], max_err=errs["banded_attn@win@offset"],
                    iters=20, t_start=t0)]
    print_rows(out)
    out += measure_train({**errs, "inputs": x}, runs, OFF_BWD, calls=offset_bwd_calls(x),
                         suffix="@offset")
    return out


# ------------------------------------------------------------------ (j)
# Packed documents under sequence sharding (varlen x sp) and pipeline
# stages (parallel/pipeline.py). As in (i), the ranks of (j-varlen-sp),
# (j-pp) and the four-rank runs are processes time-sharing the one card over
# gloo (which stages collectives and the stages' activations through host
# memory): their times are per-rank costs on one card, not NCCL scaling.

# first lengths packed at the pod shape: the first row's first document
# starts at 0 and goes on past OFF_T0 (the second sp rank's first row)
DOCS_MUST = (3000, 20, 64, 700)
DOCS_SEED = 4099
# at 64k: the second document [60032, 63032) crosses S_LONG - N_CHECK
DOCS_LONG_MUST = (60000, 3000)
DOCS_BWD = ("banded_bwd_1p@win", "banded_bwd_1p@cmp", "banded_bwd@win", "banded_bwd@cmp",
            "win_bwd_diag")
PP, PP_M = 2, 4           # (j-pp): stages and GPipe micro-batches
PP4_LAYERS = 2            # (j)'s four-rank runs' depth (full width), to stay within the time limit
FOUR_RANKS = {"pp-dp-fsdp": dict(dp=2, pp=PP, sp=1, tp=1, fsdp=True, varlen=False),
              "pp-sp-varlen": dict(dp=1, pp=PP, sp=2, tp=1, fsdp=False, varlen=True)}


def crossing(spans, t: int) -> list:
    """The documents (row, start, length) that start before position t and
    go on past it."""
    return [sp for sp in spans if sp[1] < t < sp[1] + sp[2]]


def docs_offset_inputs(dtype, dev, gen, ds) -> dict:
    """offset_kernel_inputs under packed documents: ds [B_POD, S_POD], the
    second sp rank's rows' starts ds[:, OFF_T0:] (packed positions) beside
    the offset; the fused scorer's and the window's outputs from the kernels
    with both (the selection's operands dropped: rows 2, 9 and 10 take no
    seq_start)."""
    x = offset_kernel_inputs(dtype, dev, gen)
    for k in ("K", "V", "Os", "lse_s", "t"):
        del x[k]
    x["ds"] = ds[:, OFF_T0:].contiguous()
    cfg = x["cfg"]
    x["sel"], x["Oc"], x["lse_c"] = select_cmp(x["Q"], x["Kc"], x["Vc"], x["M"], **cmp_kw(x),
                                               return_lse=True, pos_offset=OFF_T0,
                                               seq_start=x["ds"])
    x["Ow"], x["lse_w"] = banded_attn(x["Q"], x["Kw"], x["Vw"], mode="win", w=cfg.w,
                                      scale=x["scale"], return_lse=True, t_start=OFF_T0,
                                      seq_start=x["ds"])
    return x


def planted_fails(name: str, label: str, got, want, bd) -> None:
    """A planted fault of phase (j) (the kernel at offset 0 with the same
    seq_start, or at the offset without it) must fail the check."""
    worst = worst_ratio(got, want, bd)
    print(f"[docs-offset] {name}: {label}: worst err/bound {worst:.3f} (must exceed 1)")
    if not worst > 1.0:
        fail(f"{name}: the kernel {label} passes the check")


def docs_fwd_checks(x, dtype) -> dict:
    """Rows 1 (select_cmp), 3 (banded_attn, window) and 5 (banded_attn,
    cmp) with seq_start at the offset against their plain versions with
    both (fwd_check / banded_fwd_check: two launches bit-equal, bf16
    tensor-core bound with a planted 1% fault, lse); row 1's sets equal but
    at near ties, forced slots in order, in bf16 its O and lse banded_attn's
    (cmp) bit for bit; each launched at offset 0 with the same seq_start,
    and at the offset without it, must fail."""
    cfg, sc, t0, ds = x["cfg"], x["scale"], x["t0"], x["ds"]
    Q, Kc, Vc, M = x["Q"], x["Kc"], x["Vc"], x["M"]
    kw = cmp_kw(x)
    both = dict(pos_offset=t0, seq_start=ds)
    faults = {"at offset 0": dict(seq_start=ds), "without seq_start": dict(pos_offset=t0)}
    sel_k = select_cmp(Q, Kc, Vc, M, **kw, **both)[0]
    sel_2 = select_cmp(Q, Kc, Vc, M, **kw, **both)[0]
    sel_p, _, p_grp = select_cmp_plain(Q, Kc, Vc, M, **kw, return_scores=True, **both)
    n_diff, n_far, spread = near_tie_rows(sel_k, sel_p, p_grp)
    forced = torch.equal(sel_k[..., :3], sel_p[..., :3])
    far = {k: near_tie_rows(select_cmp(Q, Kc, Vc, M, **kw, **f)[0], sel_p, p_grp)[1]
           for k, f in faults.items()}
    print(f"[docs-offset] select_cmp {str(dtype)[6:]:8s} at pos_offset {t0} with seq_start: sel "
          f"rows differing on near ties: {n_diff} (widest spread {spread:.3e}); forced slots in "
          f"order: {forced}; two launches identical: {torch.equal(sel_k, sel_2)}; rows "
          f"differing beyond a near tie " + ", ".join(f"{k}: {v}" for k, v in far.items())
          + " (each must be > 0)")
    if n_far or not forced or not torch.equal(sel_k, sel_2) or not all(far.values()):
        fail(f"select_cmp with seq_start at pos_offset {dtype}: sets differ beyond the near-tie "
             f"bound, or the forced slots or two launches differ, or a planted fault passes")
    del sel_k, sel_2, sel_p, p_grp

    def plain_c(a, b, with_lse=False):
        out = select_cmp_plain(Q, Kc, Vc, M, **kw, return_lse=with_lse, **both)
        return out[1:] if with_lse else out[1]

    def rss_c(a=0, b=0):
        return banded_attn_rss(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d, scale=sc, t_start=t0,
                               seq_start=ds)

    name = "select_cmp@docs-offset"
    errs = {name: fwd_check(name, lambda: select_cmp(Q, Kc, Vc, M, **kw, return_lse=True,
                                                     **both)[1:],
                            dtype, Q.shape[1], plain_c, rss_c, tc=dtype == torch.bfloat16,
                            lse=True, rows=None, chunk=None)}
    want = fwd_bound(dtype, plain_c(0, 0), rss_c)
    for label, f in faults.items():
        planted_fails(name, label, select_cmp(Q, Kc, Vc, M, **kw, **f)[1], *want)
    if dtype == torch.bfloat16:
        O, L_ = select_cmp(Q, Kc, Vc, M, **kw, return_lse=True, **both)[1:]
        Ob, Lb = banded_attn(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d, scale=sc, return_lse=True,
                             t_start=t0, seq_start=ds)
        same = torch.equal(O, Ob) and torch.equal(L_, Lb)
        print(f"[docs-offset] select_cmp: O and lse bit-equal to banded_attn (cmp, t_start, "
              f"seq_start): {same}")
        if not same:
            fail("select_cmp with seq_start at pos_offset: O or lse differ from banded_attn's")
        del O, L_, Ob, Lb
    for mode in ("win", "cmp"):
        K, V = (x["Kw"], x["Vw"]) if mode == "win" else (Kc, Vc)
        mkw = dict(w=cfg.w) if mode == "win" else dict(l=cfg.l, d=cfg.d)
        name = f"banded_attn@{mode}@docs-offset"
        errs[name] = banded_fwd_check(
            name, lambda: banded_attn(Q, K, V, mode=mode, **mkw, scale=sc, return_lse=True,
                                      t_start=t0, seq_start=ds),
            Q, K, V, mode=mode, kw=mkw, scale=sc, lse=True, t_start=t0, seq_start=ds)
        k0 = t0 - cfg.w + 1 if mode == "win" else 0   # the rows see no window key before it
        part = (Q, K[:, :, k0:], V[:, :, k0:])
        pkw = dict(mode=mode, **mkw, scale=sc, t_start=t0 - k0, seq_start=ds - k0)
        want = fwd_bound(dtype, banded_attn_plain(*part, **pkw),
                         lambda: banded_attn_rss(*part, **pkw))
        for label, f in faults.items():
            planted_fails(name, label, banded_attn(Q, K, V, mode=mode, **mkw, scale=sc,
                                                   t_start=f.get("pos_offset", 0),
                                                   seq_start=f.get("seq_start")), *want)
        del want
    return errs


def docs_long_check(dev) -> dict:
    """Row 6 (select_blocks) on the long route's shapes with seq_start at
    the offset: the last N_CHECK rows of a packed 1 x S_LONG row at
    t_start S_LONG - N_CHECK against all S_LONG keys' compressed tokens, f32
    then bf16, against its plain version with both (sets equal but at near
    ties, forced slots in order, two launches identical, and bit-equal to
    those rows of the full call); launched at offset 0 with the same
    seq_start, and at the offset without it, each must differ beyond a near
    tie. Returns the bf16 inputs and the widest near-tie spread."""
    toks, ds_np, _, spans = varlen_pack(1, S_LONG, DOCS_SEED + 7, DOCS_LONG_MUST)
    t0 = S_LONG - N_CHECK
    if not crossing(spans, t0):
        fail(f"no document of the 64k packing crosses {t0}")
    ds_full = torch.from_numpy(ds_np).to(dev)
    ds = ds_full[:, t0:].contiguous()
    gen = torch.Generator(device=dev).manual_seed(97531)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = long_inputs(dtype, dev, gen, S_LONG)
        Qr = x["Q"][:, t0:].contiguous()

        def run(**k):
            return select_blocks(Qr, x["Kc"], **sel_kw(x), **k)

        sel, again = run(pos_offset=t0, seq_start=ds), run(pos_offset=t0, seq_start=ds)
        full = select_blocks(x["Q"], x["Kc"], **sel_kw(x), seq_start=ds_full)[:, t0:]
        selp, p_grp = select_blocks_plain(Qr, x["Kc"], **sel_kw(x), pos_offset=t0,
                                          return_scores=True, seq_start=ds)
        n_diff, n_far, spread = near_tie_rows(sel, selp, p_grp)
        forced = torch.equal(sel[..., :3], selp[..., :3])
        far = {"at offset 0": near_tie_rows(run(seq_start=ds), selp, p_grp)[1],
               "without seq_start": near_tie_rows(run(pos_offset=t0), selp, p_grp)[1]}
        print(f"[docs-offset] select_blocks {str(dtype)[6:]:8s} 64k rows [{t0}, {S_LONG}) with "
              f"seq_start: sel rows differing on near ties: {n_diff} (widest spread "
              f"{spread:.3e}); forced slots in order: {forced}; two launches identical: "
              f"{torch.equal(sel, again)}; bit-equal to those rows of the full call: "
              f"{torch.equal(sel, full)}; rows differing beyond a near tie "
              + ", ".join(f"{k}: {v}" for k, v in far.items()) + " (each must be > 0)")
        if n_far or not forced or not torch.equal(sel, again) or not torch.equal(sel, full) \
                or not all(far.values()):
            fail(f"select_blocks with seq_start at pos_offset {dtype}: sets differ beyond the "
                 f"near-tie bound, or the forced slots, two launches or the full call's rows "
                 f"differ, or a planted fault passes")
        rec["select_blocks@docs-offset-64k"] = spread
        if dtype == torch.bfloat16:
            rec["long"] = dict(x, Q=Qr, ds=ds, t0=t0)
        del x, Qr, sel, again, full, selp, p_grp
        torch.cuda.empty_cache()
    return rec


def phase_docs_kernels(dev) -> dict:
    """(j-kernels): rows 1, 3, 5, 7 (win, cmp), 8 (win, cmp) and 11 on the
    second sp rank's rows of a packed pod-shape batch (8 x 2048 rows at
    t_start 2048 against 4096 keys, seq_start of those rows), f32 (TF32
    off) then bf16, and row 6 at 64k (docs_long_check). Returns the bf16
    inputs and max errors."""
    _, ds_np, _, spans = varlen_pack(B_POD, S_POD, DOCS_SEED, DOCS_MUST)
    cross = crossing(spans, OFF_T0)
    print(f"[docs-offset] {B_POD} x {S_POD} packed rows: {len(spans)} documents, {len(cross)} "
          f"of them across position {OFF_T0} (the second sp rank's first row), e.g. "
          f"{cross[:3]} (row, start, length)")
    if not cross:
        fail(f"no document crosses position {OFF_T0}")
    ds = torch.from_numpy(ds_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(8246)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = docs_offset_inputs(dtype, dev, gen, ds)
        rec.update(docs_fwd_checks(x, dtype))
        rec.update(offset_bwd_checks(x, dtype, DOCS_BWD))
        print(f"[docs-offset] rows 1, 3, 5, 7, 8, 11 with seq_start at offset {OFF_T0} "
              f"{str(dtype)[6:]}: within their bounds, two launches identical, offset 0 and the "
              f"dropped seq_start fail each")
        if dtype == torch.bfloat16:
            rec["inputs"] = x
        del x
        torch.cuda.empty_cache()
    rec.update(docs_long_check(dev))
    return rec


def docs_pod_batches(n: int, rows: int, dev) -> list:
    """n packed global batches (tokens [1, rows, S_POD + 1], seq_start and
    loss_mask [1, rows, S_POD]) on dev, each row packed by varlen_pack
    (DOCS_MUST first, seeds DOCS_SEED + 1 + i)."""
    out = []
    for i in range(n):
        toks, ds, lm, _ = varlen_pack(rows, S_POD, DOCS_SEED + 1 + i, DOCS_MUST)
        out.append((torch.from_numpy(toks).long().to(dev)[None],
                    torch.from_numpy(ds).to(dev)[None], torch.from_numpy(lm).float().to(dev)[None]))
    return out


def stage_setting(mode: str) -> dict:
    """(dp, pp, sp, tp, fsdp, varlen, model) of a phase (j) or (k) rank
    setting."""
    if mode == "varlen-sp":
        return dict(dp=1, pp=1, sp=2, tp=1, fsdp=False, varlen=True, mcfg=par_model())
    if mode == "pp":
        return dict(dp=1, pp=PP, sp=1, tp=1, fsdp=False, varlen=False, mcfg=par_model())
    if mode == "tp":
        return dict(dp=1, pp=1, sp=1, tp=TP, fsdp=False, varlen=False, mcfg=par_model())
    if mode in FOUR_RANKS:
        return dict(FOUR_RANKS[mode], mcfg=dataclasses.replace(M7C_125M, n_layers=PP4_LAYERS))
    return dict(TP_MESHES[mode], mcfg=dataclasses.replace(M7C_125M, n_layers=TP4_LAYERS))


def stage_tcfg(st: dict):
    return dataclasses.replace(M7C_125M_TRAIN, batch_size=B_POD * st["dp"], seq_len=S_POD,
                               dp=st["dp"], sp=st["sp"], pp=st["pp"], tp=st["tp"],
                               pp_microbatches=PP_M if st["pp"] > 1 else 0, fsdp=st["fsdp"],
                               varlen=st["varlen"])


def stage_batches(st: dict, n: int, dev) -> list:
    rows = B_POD * st["dp"]
    if st["varlen"]:
        return docs_pod_batches(n, rows, dev)
    return pod_batches(n, rows, dev)


def reference_run(dev, st: dict, tag: str, grads: bool) -> dict:
    """One process on setting st's global batches: the bf16 step's losses
    (warm-up + POD_STEPS + the step after them) and mean step ms, and with
    `grads` the f32 first gradient (W_qkv split), saved for the ranks to
    compare with."""
    mcfg, tcfg = st["mcfg"], dataclasses.replace(stage_tcfg(st), dp=0, sp=1, pp=1, tp=1,
                                                 fsdp=False)
    rows = B_POD * st["dp"]
    batches = stage_batches(st, POD_STEPS + 2, dev)
    state = init_train_state(init_model_params(mcfg, torch.Generator().manual_seed(0),
                                               device=dev), tcfg)
    step = make_train_step(mcfg, tcfg)
    losses, ev = [], []
    for i, b in enumerate(batches):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, b)
        e1.record()
        losses.append(m["loss"])
        if 1 <= i <= POD_STEPS:
            ev.append((e0, e1))
    torch.cuda.synchronize()
    mean = float(np.mean([a.elapsed_time(b) for a, b in ev]))
    losses = [float(v) for v in losses]
    del state, step
    torch.cuda.empty_cache()
    path = None
    if grads:
        m32 = dataclasses.replace(mcfg, dtype="float32")
        params = init_model_params(m32, torch.Generator().manual_seed(0), device=dev)
        leaves = param_leaves(params)
        names = [k for k, _ in leaves]
        for _, t in leaves:
            t.requires_grad_(True)
        b = batches[0]
        g = loss_and_grads(params, b[0][0], m32, seq_start=b[1][0], loss_mask=b[2][0])[1] \
            if st["varlen"] else loss_and_grads(params, b[0], m32)[1]
        path = os.path.join(PAR_DIR, f"ref_grads_{tag}.pt")
        if st["pp"] > 1 or st["tp"] > 1:
            # the same rows in the pipeline's micro-batches (under tp with dp,
            # in the dp members' rows), each tp member's slice of every block
            # its own call (tp_split_grads), gradients summed over the chunks
            # (the global mean: every chunk holds as many tokens); the
            # reference the ranks are held to
            M = stage_tcfg(st).pp_microbatches if st["pp"] > 1 else st["dp"]
            if st["tp"] > 1:
                vl = dict(seq_start=b[1][0], loss_mask=b[2][0]) if st["varlen"] else {}
                if vl and M > 1:
                    raise ValueError(f"{tag}: the reference splits no packed batch")
                parts = [tp_split_grads(params, t, m32, st["tp"], **vl)
                         for t in (b[0][0] if vl else b[0]).chunk(M)]
            else:
                parts = [loss_and_grads(params, t, m32)[1] for t in b[0].chunk(M)]
            split = [sum(gs) / M for gs in zip(*parts)]
            errs = [float((a - w).norm() / w.norm()) for (_, a), (_, w) in
                    zip(split_qkv(names, split), split_qkv(names, g))]
            i = int(np.argmax(errs))
            print(f"[{tag}] one process, f32 first gradient over {M} chunk(s) of "
                  f"{rows // M} rows" + (f", each tp member's slice its own call"
                                         if st["tp"] > 1 else "")
                  + f", vs one call of {rows}: worst leaf {errs[i]:.3e} "
                  f"({split_qkv(names, g)[i][0]})")
            torch.save([(n, t.cpu()) for n, t in split_qkv(names, g)],
                       path.replace(".pt", "_whole.pt"))
            g = split
            del parts
        torch.save([(n, t.cpu()) for n, t in split_qkv(names, g)], path)
        del params, leaves, g
        torch.cuda.empty_cache()
    print(f"[{tag}] one process, {mcfg.n_layers}-layer m7c bf16 {rows} x {S_POD}"
          f"{' packed' if st['varlen'] else ''}: step {mean:.3f} ms, "
          f"{mfu_text(rows, S_POD, mean, mcfg)}; losses {', '.join(f'{v:.4f}' for v in losses)}")
    return {"losses": losses, "step_ms": mean, "grads": path}


def tp_split_grads(params, toks, mcfg, tp: int, seq_start=None, loss_mask=None) -> list:
    """One process computing what tp members compute, for the reference of
    the tp settings: each block's slice of member k (mesh.tp_shard's,
    G/tp groups and 1/tp of the hidden dim) run as its own call on the
    block's normed input, the members' partial outputs summed in member
    order (as the all-reduce sums them, in the model dtype), blocks
    recomputed in the backward as remat does. Returns the gradients of the
    mean cross entropy of toks [B, S+1] (packed documents under
    seq_start, loss_mask) with respect to params' leaves (param_leaves
    order; a tp-sharded leaf's assembled from its members', W_qkv
    projection by projection). The members' GEMMs have the ranks' shapes,
    so their rounding, and the selections it may tip, are the ranks'."""
    named = param_leaves(params)
    members = [pmesh.tp_shard(params, types.SimpleNamespace(tp=tp, tp_rank=k))
               for k in range(tp)]
    local = [[t for _, t in param_leaves(m)] for m in members]
    for leaves in local:
        for (k, _), t in zip(named, leaves):
            if pmesh.tp_axis(k) is not None:
                t.requires_grad_(True)
    lcfg = tp_local(mcfg.nsa, tp)
    eps = mcfg.rmsnorm_eps

    def block(x, bps):
        h = rmsnorm(x, bps[0]["attn_norm"], eps)
        outs = [nsa_prefill(bp["attn"], h, lcfg, seq_start=seq_start)[0] for bp in bps]
        x = x + functools.reduce(torch.add, outs)
        h = rmsnorm(x, bps[0]["mlp_norm"], eps)
        return x + functools.reduce(torch.add, [mlp(bp["mlp"], h) for bp in bps])

    with torch.enable_grad():
        x = embed(params, toks[:, :-1], mcfg)
        for i in range(mcfg.n_layers):
            x = remat(block, x, [m["blocks"][i] for m in members])
        loss = cross_entropy_loss(head(params, x, mcfg), toks[:, 1:], mask=loss_mask)
        inputs = [t for (k, t) in named if pmesh.tp_axis(k) is None]
        inputs += [t for leaves in local for (k, _), t in zip(named, leaves)
                   if pmesh.tp_axis(k) is not None]
        got = dict(zip(map(id, inputs), torch.autograd.grad(loss, inputs)))
    widths = pts._tp_widths(members[0])
    out = []
    for i, (k, t) in enumerate(named):
        ax = pmesh.tp_axis(k)
        if ax is None:
            out.append(got[id(t)])
            continue
        parts = [got[id(leaves[i])] for leaves in local]
        w = widths[i]
        if w is None:
            out.append(torch.cat(parts, dim=ax))
        else:   # projection j of every member, in order, then the next projection
            out.append(torch.cat([torch.cat([p.split(w, dim=ax)[j] for p in parts], dim=ax)
                                  for j in range(len(w))], dim=ax))
    return out


def stage_launches(mesh, mcfg, M: int, keys=None) -> dict:
    """The launch counts one parallel step of this rank must show under the
    design keys `keys` (None: those in force): remat runs each of its
    blocks' three forward kernels twice (the window at a nonzero offset as
    banded_attn), the backward one kernel per branch and block; all once
    per micro-batch (M; 1 without pp)."""
    L = len(range(0, mcfg.n_layers, mesh.pp))
    want = dict.fromkeys(train_counts(), 0)
    win = "banded_attn" if mesh.sp_rank > 0 else "win_attn"
    for k in ("select_cmp", "sel_attn", win):
        want[k] = 2 * L * M
    with design_keys(keys):
        for branch in ("win", "cmp", "sel"):
            k = tuning.backward_kernel(branch, S_POD // mesh.sp, mcfg.nsa.w)
            want[k] += L * M
            if branch == "cmp":
                want[f"{k}@cmp"] += L * M
    return want


@contextlib.contextmanager
def zeroed_sent_grads(mesh):
    """On the last stage, every tensor it sends (the activation gradients
    going back) is replaced by zeros: a fault the pp gradient check must
    catch."""
    real = pipeline.send_to
    if mesh.pp_rank == mesh.pp - 1:
        pipeline.send_to = lambda x, dst, m: real(torch.zeros_like(x), dst, m)
    try:
        yield
    finally:
        pipeline.send_to = real


@contextlib.contextmanager
def swapped_microbatches(mesh):
    """On the last stage, the activations of micro-batches 0 and 1 are
    taken in swapped order: a fault the pp gradient check must catch."""
    real, held = pipeline.recv_from, []

    def swapped(shape, dtype, device, src, m):
        if not held and not getattr(swapped, "done", False):
            held.append(real(shape, dtype, device, src, m))
            swapped.done = True
            return real(shape, dtype, device, src, m)
        return held.pop() if held else real(shape, dtype, device, src, m)

    if mesh.pp_rank == mesh.pp - 1:
        pipeline.recv_from = swapped
    try:
        yield
    finally:
        pipeline.recv_from = real


@contextlib.contextmanager
def unsummed_top_grads():
    """The replicated top-level leaves' gradients are not all-reduced (so,
    at dp = sp = 1, not summed over pp): a fault the pp gradient check
    must catch."""
    real = pts._sum_grads_
    pts._sum_grads_ = lambda grads, group: None if group is None else real(grads, group)
    try:
        yield
    finally:
        pts._sum_grads_ = real


@contextlib.contextmanager
def dropped_tp_copy():
    """copy_to_tp as the identity both ways: its backward all-reduce over tp
    dropped, so a sub-block's input gradient covers this member's KV
    groups (or hidden slice) only: a fault the tp gradient check must
    catch."""
    real = pctx.copy_to_tp
    pctx.copy_to_tp = lambda x, mesh: x
    try:
        yield
    finally:
        pctx.copy_to_tp = real


@contextlib.contextmanager
def unsummed_group_grads():
    """The gate's (and conv ϕ's) gradients not summed over tp, each member
    keeping its own groups' share: a fault the tp gradient check must
    catch."""
    real = pts.per_group
    pts.per_group = lambda name: False
    try:
        yield
    finally:
        pts.per_group = real


@contextlib.contextmanager
def top_grads_over_tp(mesh):
    """The replicated top-level leaves' gradients summed over the world, so
    over the tp members too, which each computed them whole: a fault the tp
    gradient check must catch."""
    real = pts._sum_grads_
    pts._sum_grads_ = lambda grads, group: real(grads, None if group is mesh.slice_group
                                                else group)
    try:
        yield
    finally:
        pts._sum_grads_ = real


@contextlib.contextmanager
def whole_qkv_gather(state):
    """A fused W_qkv gathered over tp whole, as one projection (the members'
    projections interleaved in the saved leaf): a fault the tp checkpoint
    check must catch."""
    real = state.tp_widths
    state.tp_widths = [None] * len(real)
    try:
        yield
    finally:
        state.tp_widths = real


# the planted faults of each setting's f32 gradient check (each takes the mesh)
STAGE_FAULTS = {
    "varlen-sp": {"win_bwd_diag without seq_start": lambda mesh: dropped_ds("win_bwd_diag")},
    "pp": {"activation gradient sent back zeroed": zeroed_sent_grads,
           "micro-batches 0 and 1 swapped on the last stage": swapped_microbatches,
           "top-level gradients not summed over pp": lambda mesh: unsummed_top_grads()},
    "tp": {"(a) copy_to_tp's backward all-reduce dropped": lambda mesh: dropped_tp_copy(),
           "(b) gate gradients not summed over tp": lambda mesh: unsummed_group_grads(),
           "(c) top-level gradients summed over tp as well": top_grads_over_tp},
}


def weighted_sum(t: torch.Tensor) -> float:
    """sum_i (i + 1) t_i in float64 over t's elements in order: equal for
    equal tensors of one shape, and moved by a permutation."""
    v = t.detach().reshape(-1).double()
    return float((v * torch.arange(1, v.numel() + 1, device=v.device, dtype=torch.float64)).sum())


def tp_ckpt_save(state, mesh, step, batch) -> dict:
    """(k-tp), on each rank: a checkpoint of the state saved under the mesh
    (a collective; rank 0 writes), and one saved with W_qkv gathered whole
    (whole_qkv_gather, the planted fault); the weighted sums of this rank's
    own leaves and moments (its tp slices), with their tp axes and W_qkv
    widths; then the loss of the next step on `batch`."""
    dirs = {"saved": os.path.join(PAR_DIR, "tp_ckpt"),
            "(d) W_qkv gathered over tp whole": os.path.join(PAR_DIR, "tp_ckpt_whole")}
    if mesh.rank == 0:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    save_checkpoint(dirs["saved"], int(state.step), state, mesh=mesh)
    with whole_qkv_gather(state):
        save_checkpoint(dirs["(d) W_qkv gathered over tp whole"], int(state.step), state,
                        mesh=mesh)
    local = [t for _, t in param_leaves(state.params)]
    out = {"dirs": dirs, "step": int(state.step), "tp_rank": mesh.tp_rank,
           "axes": state.tp_axes, "widths": state.tp_widths,
           "sums": [weighted_sum(t) for t in local + state.opt_state["mu"]
                    + state.opt_state["nu"]]}
    _, m = step(state, batch)
    out["next_loss"] = float(m["loss"])
    return out


def stage_worker(mode: str) -> None:
    """One rank of a phase (j) or (k) setting (stage_setting): the m7c step
    (bf16, remat, default keys) on the setting's batches, warm-up +
    POD_STEPS timed steps, launch counts, the bytes sent stage to stage and
    all-reduced over tp, peak memory, a traced step; in varlen-sp and tp one
    step under each of DESIGNS' onepass and twopass keys; in varlen-sp the
    cross-document check at the shard boundary and the 64k long route's
    forward; in tp the host syncs of a step and its checkpoints
    (tp_ckpt_save); in GRAD_MODES the f32 first gradient (gathered whole)
    against one process's, with the setting's planted faults (STAGE_FAULTS).
    Writes PAR_DIR/<mode>_rank<r>.json."""
    initialize_distributed("gloo")
    dev = rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    st = stage_setting(mode)
    mcfg, tcfg = st["mcfg"], stage_tcfg(st)
    mesh = make_mesh(dp=st["dp"], sp=st["sp"], tp=st["tp"], pp=st["pp"])
    lead = mesh.rank == 0
    tag = f"{mode} rank {mesh.rank}"
    M = tcfg.pp_microbatches if mesh.pp > 1 else 1
    step, state = build_state_and_step(
        init_model_params(mcfg, torch.Generator().manual_seed(0), device=dev), mcfg, tcfg, mesh)
    batches = [local_batch(b, mesh) for b in stage_batches(st, POD_STEPS + 2, dev)]
    state, m = step(state, batches[0])                                # warm-up
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    pipeline.SENT["bytes"] = 0
    pmesh.TP_REDUCED["bytes"] = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(POD_STEPS + 1)]
    ev[0].record()
    for i in range(POD_STEPS):
        state, m = step(state, batches[1 + i])
        ev[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    counts = train_counts()
    sent = pipeline.SENT["bytes"] / POD_STEPS
    reduced = pmesh.TP_REDUCED["bytes"] / POD_STEPS
    peak = torch.cuda.max_memory_allocated()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(POD_STEPS)]
    want = {k: v * POD_STEPS for k, v in stage_launches(mesh, mcfg, M).items()}
    print(f"[{tag}] launches over {POD_STEPS} steps: {counts}; expected {want}", flush=True)
    if counts != want:
        fail(f"{tag}: launch counts {counts} != {want}")
    runs = [counts]
    if mode in ("varlen-sp", "tp"):   # the other designs' kernels, one step each
        for label in ("onepass", "twopass"):
            with design_keys(DESIGNS[label]):
                kernels.reset_launch_counts()
                step(state, batches[1])
                torch.cuda.synchronize()
                c = train_counts()
            if c != stage_launches(mesh, mcfg, M, DESIGNS[label]):
                fail(f"{tag}: {label} launch counts {c}")
            runs.append(c)
    mean_ms = float(np.mean(step_ms))
    res = {"losses": [float(v) for v in losses], "step_ms": step_ms, "mean_ms": mean_ms,
           "runs": runs, "sent": sent, "tp_reduced": reduced, "peak": peak,
           "layers": list(state.layers)}
    if mode == "tp":
        res["syncs"] = host_syncs(lambda: step(state, batches[1]), tag)
    res["busy"] = trace(lambda: step(state, batches[1]), 1, f"{tag} step", mean_ms)["busy"]
    if mode == "varlen-sp":
        res.update(docs_boundary_checks(state, mcfg, mesh, dev))
    if mode == "tp":
        res["ckpt"] = tp_ckpt_save(state, mesh, step, batches[-1])
    del state, step
    torch.cuda.empty_cache()
    if mode in GRAD_MODES:
        m32 = dataclasses.replace(mcfg, dtype="float32")
        t32 = dataclasses.replace(tcfg, gate_stats=False)
        st32 = build_state(init_model_params(m32, torch.Generator().manual_seed(0), device=dev),
                           t32, mesh)
        names = [k for k, _ in param_leaves(st32.full_template)]
        ref = torch.load(os.path.join(PAR_DIR, f"ref_grads_{mode}.pt")) if lead else None
        whole_path = os.path.join(PAR_DIR, f"ref_grads_{mode}_whole.pt")
        whole = torch.load(whole_path) if lead and os.path.exists(whole_path) else None
        faults = STAGE_FAULTS.get(mode, {})
        for label, plant in [("base", contextlib.nullcontext)] + list(faults.items()):
            with plant(mesh):
                grads = grads_and_stats(st32, m32, t32, mesh, batches[0])[1]
            full = gather_full(st32, mesh, grads)
            for key, want in (("grad_err", ref), ("grad_err_whole", whole)):
                if want is None:
                    continue
                errs = [float((g.float() - r.to(dev).float()).norm() / r.float().norm())
                        for (_, g), (_, r) in zip(split_qkv(names, full), want)]
                i = int(np.argmax(errs))
                res.setdefault(key, {})[label] = [errs[i], want[i][0]]
            del grads, full
    with open(os.path.join(PAR_DIR, f"{mode}_rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def docs_boundary_checks(state, mcfg, mesh, dev) -> dict:
    """(j-varlen-sp), on each rank: perturbing one document that crosses
    position OFF_T0 moves no other document's logits (bf16, no grad, the
    rank's rows: 0.0); then the 64k long route under sp with packed
    documents (select_blocks and banded_attn at the offset): launch counts
    and finite logits."""
    toks, ds_np, _, spans = varlen_pack(B_POD, S_POD, DOCS_SEED + 1, DOCS_MUST)
    r, a, n = crossing(spans, OFF_T0)[0]
    toks = torch.from_numpy(toks).long().to(dev)
    ds = torch.from_numpy(ds_np).to(dev)
    pert = toks.clone()
    pert[r, a:a + n] = (pert[r, a:a + n] + 101) % mcfg.vocab_size
    s = S_POD // mesh.sp
    t0 = mesh.sp_rank * s
    params = gathered_params(state, mesh)
    with torch.no_grad():
        base = context_parallel_model_forward(params, toks[:, t0:t0 + s], mcfg, mesh,
                                              seq_start=ds)[0]
        moved = context_parallel_model_forward(params, pert[:, t0:t0 + s], mcfg, mesh,
                                               seq_start=ds)[0]
    diff = (moved - base).abs().amax(-1)                                    # [B, S/sp]
    own = torch.zeros_like(diff, dtype=torch.bool)
    own[r] = ds[r, t0:t0 + s] == a
    out = {"leak": [float(diff[~own].max()), float(diff[own].max()) if own.any() else 0.0],
           "victim": [r, a, n]}
    del base, moved, diff
    toks64, ds64_np, _, _ = varlen_pack(1, S_LONG, DOCS_SEED + 7, DOCS_LONG_MUST)
    toks64 = torch.from_numpy(toks64).long().to(dev)
    ds64 = torch.from_numpy(ds64_np).to(dev)
    s64 = S_LONG // mesh.sp
    with torch.no_grad():
        x = toks64[:, mesh.sp_rank * s64:(mesh.sp_rank + 1) * s64]
        context_parallel_model_forward(params, x, mcfg, mesh, seq_start=ds64)    # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        logits = context_parallel_model_forward(params, x, mcfg, mesh, seq_start=ds64)[0]
        torch.cuda.synchronize()
    L = mcfg.n_layers
    c = kernels.launch_counts()
    want = {**dict.fromkeys(c, 0), "select_blocks": L, "sel_attn": L,
            "banded_attn": 2 * L if mesh.sp_rank else L, "win_attn": 0 if mesh.sp_rank else L}
    out["long"] = {"counts": c, "want": want, "finite": bool(torch.isfinite(logits).all())}
    del params, logits
    torch.cuda.empty_cache()
    return out


def stage_report(mode: str, ranks: list, ref: dict, st: dict) -> None:
    """Prints a phase (j) or (k) setting's numbers (per-rank step ms, busy
    and idle, peak memory, the bubble fraction, launches per stage, bytes
    sent stage to stage and all-reduced over tp per step, MFU), holds the
    bytes all-reduced over tp to tp_bytes, and holds its losses to one
    process's (LOSS_TOL) and, where measured, its f32 first gradient
    (STEP_GRAD_TOL, each planted fault beyond it)."""
    mcfg = st["mcfg"]
    rows = B_POD * st["dp"]
    pp, M = st["pp"], PP_M if st["pp"] > 1 else 1
    for r, res in enumerate(ranks):
        mean = res["mean_ms"]
        print(f"[{mode}] rank {r} (layers {res['layers'][0]}..{res['layers'][-1]}): step ms "
              f"{', '.join(f'{v:.2f}' for v in res['step_ms'])}; mean {mean:.3f} ms; busy "
              f"{res['busy']:.3f} ms, idle share {1 - res['busy'] / mean:.3f}; peak "
              f"{res['peak'] / 2**30:.2f} GiB; launches a step "
              + str({k: v // POD_STEPS for k, v in res["runs"][0].items() if v})
              + f"; bytes sent to stage neighbours a step {res['sent']:.0f}"
              + (f"; bytes all-reduced over tp a step {res['tp_reduced']:.0f}"
                 if st["tp"] > 1 else ""))
    if st["tp"] > 1:
        want = tp_bytes(mcfg, len(ranks[0]["layers"]), rows // st["dp"], S_POD // st["sp"])
        print(f"[{mode}] bytes a rank all-reduces over tp a step, from the code (tp_bytes): "
              f"{want}; measured {sorted({int(res['tp_reduced']) for res in ranks})}")
        if any(res["tp_reduced"] != want for res in ranks):
            fail(f"{mode}: the bytes all-reduced over tp differ from tp_bytes' {want}")
    mean = float(np.mean([res["mean_ms"] for res in ranks]))
    print(f"[{mode}] {mcfg.n_layers}-layer m7c bf16 {rows} x {S_POD} over {len(ranks)} ranks "
          f"(dp {st['dp']}, pp {pp}, sp {st['sp']}, tp {st['tp']}{', fsdp' if st['fsdp'] else ''}"
          f"{', varlen' if st['varlen'] else ''}{f', M {M}' if pp > 1 else ''}) time-sharing the "
          f"one card over gloo: mean step {mean:.3f} ms (one process on the same batch: "
          f"{ref['step_ms']:.3f} ms); bubble fraction (pp-1)/(M+pp-1) {(pp - 1) / (M + pp - 1):.3f}"
          f"; {rows * S_POD / (mean / 1e3):.0f} tokens/s, {mfu_text(rows, S_POD, mean, mcfg)}")
    res = ranks[0]
    gap = max(abs(a - b) for a, b in zip(res["losses"], ref["losses"]))
    print(f"[{mode}] losses {', '.join(f'{v:.4f}' for v in res['losses'])}; one process "
          f"{', '.join(f'{v:.4f}' for v in ref['losses'][:len(res['losses'])])}; max gap "
          f"{gap:.3e} (bound LOSS_TOL {LOSS_TOL:g})")
    if not gap <= LOSS_TOL:
        fail(f"{mode}: losses differ from one process's by {gap:.3e}")
    if "grad_err_whole" in res:   # printed only: near-tie selections differ (PERF.md)
        print(f"[{mode}] f32 first gradient vs one process's single call on all {rows} rows, "
              f"worst leaf: " + "; ".join(f"{k} {v[0]:.3e} ({v[1]})"
                                          for k, v in res["grad_err_whole"].items()))
    if "grad_err" in res:
        errs = res["grad_err"]
        print(f"[{mode}] f32 first gradient vs one process"
              + (f" on the same {M} micro-batches" if pp > 1 else "")
              + (" computing each tp member's slice as its own call" if st["tp"] > 1 else "")
              + ", worst leaf ||g - g_1|| / ||g_1||: "
              + "; ".join(f"{k} {v[0]:.3e} ({v[1]})" for k, v in errs.items())
              + f" (bound {STEP_GRAD_TOL:g}; each planted fault must exceed it)")
        if not errs["base"][0] <= STEP_GRAD_TOL:
            fail(f"{mode}: the f32 first gradient differs from one process's by "
                 f"{errs['base'][0]}")
        missed = [k for k, v in errs.items() if k != "base" and not v[0] > STEP_GRAD_TOL]
        if missed:
            fail(f"{mode}: planted faults pass the gradient check: {missed}")


def phase_stages(dev) -> list:
    """Phase (j): (j-kernels) in this process; (j-varlen-sp) and (j-pp),
    two ranks each, and the four-rank settings of FOUR_RANKS, each held to
    one process on the same global batches. Returns the JSON rows of rows
    1, 3, 5, 6, 7, 8 and 11 with seq_start at the offset (launches: the
    second sp rank's varlen steps under each design, and its 64k forward
    for rows 5 and 6)."""
    os.makedirs(PAR_DIR, exist_ok=True)
    krec = phase_docs_kernels(dev)
    torch.cuda.empty_cache()
    results = {}
    for mode, n in (("varlen-sp", 2), ("pp", 2), *((k, 4) for k in FOUR_RANKS)):
        st = stage_setting(mode)
        ref = reference_run(dev, st, mode, grads=mode in ("varlen-sp", "pp"))
        torch.cuda.empty_cache()
        results[mode] = ranks = run_ranks(mode, n)
        stage_report(mode, ranks, ref, st)
        if mode == "varlen-sp":
            for r, res in enumerate(ranks):
                other, inside = res["leak"]
                lg = res["long"]
                print(f"[varlen-sp] rank {r}: document {res['victim']} (row, start, length) "
                      f"across position {OFF_T0} perturbed: its logits on this rank move by up "
                      f"to {inside:.4f}, every other document's by {other} (must be 0.0); 64k "
                      f"packed forward under sp: launches {lg['counts']} (expected "
                      f"{lg['want']}), logits finite: {lg['finite']}")
                if other != 0.0 or not inside > 0.0:
                    fail(f"varlen-sp rank {r}: cross-document influence at the shard boundary")
                if lg["counts"] != lg["want"] or not lg["finite"]:
                    fail(f"varlen-sp rank {r}: the 64k forward's launches or logits")
        for p in (ref["grads"], ref["grads"] and ref["grads"].replace(".pt", "_whole.pt")):
            if p and os.path.exists(p):
                os.remove(p)
    rows = docs_rows(krec, results["varlen-sp"][1])
    del krec
    torch.cuda.empty_cache()
    return rows


def docs_rows(rec, rank1) -> list:
    """The JSON rows of rows 1, 3, 5, 6, 7, 8 and 11 with seq_start at the
    offset (bf16), launches from the second sp rank of (j-varlen-sp): its
    steps under each design (`runs`) and its 64k forward (rows 5 and 6:
    the cmp-mode banded_attn launches are those past its window's)."""
    x = rec["inputs"]
    cfg, sc, t0, ds = x["cfg"], x["scale"], x["t0"], x["ds"]
    runs, long_counts = rank1["runs"], rank1["long"]["counts"]
    L = PAR_LAYERS
    out = [select_cmp_row("select_cmp@docs-offset", x, lse=True, launches=runs[0]["select_cmp"],
                          max_err=rec["select_cmp@docs-offset"])]
    for mode in ("win", "cmp"):
        K, V = (x["Kw"], x["Vw"]) if mode == "win" else (x["Kc"], x["Vc"])
        mkw = dict(w=cfg.w) if mode == "win" else dict(l=cfg.l, d=cfg.d)
        out.append(band_row(f"banded_attn@{mode}@docs-offset",
                            lambda: banded_attn(x["Q"], K, V, mode=mode, **mkw, scale=sc,
                                                t_start=t0, seq_start=ds),
                            x["Q"], K, V, mode=mode, kw=mkw, lse=False,
                            launches=(runs[0]["banded_attn"] if mode == "win"
                                      else long_counts["banded_attn"] - L),
                            max_err=rec[f"banded_attn@{mode}@docs-offset"], iters=10,
                            seq_start=ds, t_start=t0))
    y = rec["long"]
    Q, Kc, dl, tl = y["Q"], y["Kc"], y["ds"], y["t0"]
    sel = select_blocks(Q, Kc, **sel_kw(y), pos_offset=tl, seq_start=dl)
    pairs = float(banded_mask(Q.shape[1], Kc.shape[2], mode="cmp", l=cfg.l, d=cfg.d, t_start=tl,
                              device=dl.device, seq_start=dl).sum()) * cfg.n_kv_groups \
        * cfg.h_per_group
    bms, by = bound(nbytes(Q, Kc, sel, dl), pairs * 2 * cfg.d_k, Q.dtype)
    out.append(dict(
        name="select_blocks@docs-offset-64k",
        source="nsa_vibe_tpu_torch/csrc/select_blocks_mma.cu",
        replaces="nsa_vibe_tpu/ops/pallas/scorer.py:186",
        launches=long_counts["select_blocks"], max_abs_err=rec["select_blocks@docs-offset-64k"],
        ms=time_ms(lambda: select_blocks(Q, Kc, **sel_kw(y), pos_offset=tl, seq_start=dl), 10,
                   hold=True),
        plain_ms=time_ms(lambda: select_blocks_plain(Q, Kc, **sel_kw(y), pos_offset=tl,
                                                     seq_start=dl), 2, 1, hold=True),
        bound_ms=bms, bound_by=by, library_ms=None))
    print_rows(out)
    return out + measure_train({**rec, "inputs": x}, runs, DOCS_BWD,
                               calls=offset_bwd_calls(x), suffix="@docs-offset")


# ------------------------------------------------------------------ (k)
# Tensor parallelism (parallel/mesh.py: tp_shard, copy_to_tp,
# reduce_from_tp). As in (i) and (j), the ranks time-share the one card
# over gloo, which stages the all-reduces through host memory: per-rank
# costs on one card, not tp scaling.

TP = 2                    # (k-tp): each member holds 1 of m7c's 2 KV groups (h = 6, D = 64)
TP4_LAYERS = 4            # (k-mesh)'s depth (full width)
TP_MESHES = {"tp-dp-fsdp": dict(dp=2, pp=1, sp=1, tp=TP, fsdp=True, varlen=False),
             "tp-sp-varlen": dict(dp=1, pp=1, sp=2, tp=TP, fsdp=False, varlen=True),
             "pp-tp": dict(dp=1, pp=PP, sp=1, tp=TP, fsdp=False, varlen=False)}
GRAD_MODES = ("varlen-sp", "pp", "tp", *TP_MESHES)
TP_BWD = TWO_PASS + tuple(PARTNERS)
DRYRUN_RANKS = 8
DRYRUN_ARGS = ("--device", "cuda:0", "--backend", "gloo")   # every rank on the one card
DRYRUN_LINE = (r"^dryrun_multichip\(8\): mesh 4x2 ok, loss=\d+\.\d{4}; pp train ok; pp x sp train "
               r"ok; pp x tp train ok; pp x sp x tp train ok; cp prefill sp=8 ok$")


def tp_bytes(mcfg, layers: int, rows: int, seq: int) -> int:
    """The bytes a tp member all-reduces over tp in one step, from the
    code: each of its `layers` blocks' two sub-blocks all-reduces its
    [rows, seq, dim] partial output forward (reduce_from_tp) and its normed
    input's gradient backward (copy_to_tp's backward), in the model dtype;
    under full remat the recompute (models/remat.py) runs the attention's
    all-reduce again but not the MLP's, which the block leaves outside it
    (block_prefill's split: nothing after that all-reduce saves a tensor)."""
    recompute = 1 if mcfg.remat in (True, "full") else 0
    return layers * (4 + recompute) * rows * seq * mcfg.nsa.dim * torch_dtype(mcfg.dtype).itemsize


def tp_ckpt_check(dev, ranks, st) -> None:
    """(k-tp): the checkpoints saved under tp restored on one process: the
    one saved as the code saves must give each rank's own slices (tp_slice
    of each restored leaf and moment, a W_qkv projection by projection) with
    the weighted sums the rank took of its leaves, and the next step's loss
    within LOSS_TOL of the ranks'; the one saved with W_qkv gathered whole
    must not give them."""
    mcfg, tcfg = st["mcfg"], dataclasses.replace(stage_tcfg(st), tp=1)
    batch = stage_batches(st, POD_STEPS + 2, dev)[-1]
    ck0 = ranks[0]["ckpt"]
    for label, d in ck0["dirs"].items():
        state = init_train_state(init_model_params(mcfg, torch.Generator().manual_seed(1),
                                                   device=dev), tcfg)
        restore_checkpoint(d, state)
        ts = [t for _, t in param_leaves(state.params)]
        ts += state.opt_state["mu"] + state.opt_state["nu"]
        wrong = 0
        for res in ranks:
            ck = res["ckpt"]
            for t, a, w, want in zip(ts, ck["axes"] * 3, ck["widths"] * 3, ck["sums"]):
                if a is not None:
                    t = pmesh.tp_slice(t, a, ck["tp_rank"], TP,
                                       None if w is None else [x * TP for x in w])
                wrong += weighted_sum(t) != want
        if label == "saved":
            _, m = make_train_step(mcfg, tcfg)(state, batch)
            gap = abs(float(m["loss"]) - ck0["next_loss"])
            print(f"[tp] checkpoint of step {ck0['step']} saved under tp {TP}, restored on one "
                  f"process: leaves and moments that differ from a rank's own slices: {wrong} "
                  f"of {len(ts) * len(ranks)} (must be 0); next step's loss "
                  f"{float(m['loss']):.4f} vs the ranks' {ck0['next_loss']:.4f} (gap "
                  f"{gap:.3e}, bound LOSS_TOL)")
            if wrong or not gap <= LOSS_TOL:
                fail("tp checkpoint: the restored state or the next loss differs from the ranks'")
        else:
            print(f"[tp] planted fault {label}: leaves and moments that differ from a rank's "
                  f"own slices after restoring: {wrong} (must be > 0)")
            if not wrong:
                fail(f"tp checkpoint: the planted fault {label} passes")
        del state, ts
        torch.cuda.empty_cache()


def phase_dryrun() -> None:
    """(k-dryrun): parallel/dryrun.py as DRYRUN_RANKS ranks (start_ranks)
    on the one card over gloo (every mesh of the JAX dry run, pp x sp x tp
    among them, each step's loss held to one process's); its tail line
    must be the JAX run's."""
    argv = ["-m", "nsa_vibe_tpu_torch.parallel.dryrun", *DRYRUN_ARGS]
    print(f"[dryrun] starting {DRYRUN_RANKS} ranks on the one card over gloo: {' '.join(argv)}",
          flush=True)
    t = time.perf_counter()
    with open(os.path.join(PAR_DIR, "dryrun.log"), "w+") as log:
        rc = wait_ranks(start_ranks(argv, DRYRUN_RANKS, stdout=log, stderr=subprocess.STDOUT),
                        PAR_TIMEOUT_S)
        log.seek(0)
        out = log.read()
    lines = [ln for ln in out.splitlines() if ln.startswith(("[dryrun]", "dryrun_"))]
    print("\n".join(lines))
    print(f"[dryrun] ranks exited with {rc} after {time.perf_counter() - t:.1f} s")
    if rc != 0 or not any(re.match(DRYRUN_LINE, ln) for ln in lines):
        print(out[-4000:])
        fail(f"dryrun_multichip({DRYRUN_RANKS}) failed (exit {rc}) or printed another tail line")


def tp_rows(rec, runs) -> list:
    """The JSON rows of rows 1, 2, 3 (forward) and 7, 8, 9, 10, 11
    (backward) at the tp member's shape (G = 1, h = 6, D = 64, 8 x 4096,
    bf16), launches from the tp rank's steps under each design (`runs`)."""
    x = rec["inputs"]
    cfg = x["cfg"]
    sargs, wargs = (x["Q"], x["K"], x["V"], x["sel"], x["t"]), (x["Q"], x["Kw"], x["Vw"])
    out = [select_cmp_row("select_cmp@tp", x, lse=True, launches=runs[0]["select_cmp"],
                          max_err=x["cmp_fwd_err"]),
           sel_attn_row("sel_attn@tp", *sargs, launches=runs[0]["sel_attn"],
                        max_err=x["sel_fwd_err"]),
           band_row("win_attn@tp", lambda: win_attn(*wargs, w=cfg.w, scale=x["scale"],
                                                    return_lse=True), *wargs,
                    mode="win", kw=dict(w=cfg.w), lse=True, launches=runs[0]["win_attn"],
                    max_err=x["win_fwd_err"], iters=10)]
    print_rows(out)
    return out + measure_train(rec, runs, TP_BWD, suffix="@tp")


def phase_tp(dev) -> list:
    """Phase (k): (k-kernels) rows 1, 2, 3, 7, 8, 9, 10 and 11 at the tp
    member's shape in this process; (k-tp) two ranks, tp = 2, m7c at full
    width, PAR_LAYERS deep, on the pod shape, and (k-mesh) four ranks at
    TP4_LAYERS layers (TP_MESHES), each held to one process on the same global
    batches; (k-tp)'s checkpoints; (k-dryrun). Returns the JSON rows of the
    tp member's kernels."""
    t0 = time.perf_counter()
    os.makedirs(PAR_DIR, exist_ok=True)
    krec = phase_train_kernels(dev, TP_BWD, seed=1357, cfg=tp_local(M7C_125M.nsa, TP),
                               rows=B_POD, seq=S_POD, tag="tp")
    print(f"[tp] (k-kernels) rows 1, 2, 3, 7, 8, 9, 10, 11 at the tp member's shape (G = 1, "
          f"h = 6, D = 64, {B_POD} x {S_POD}), f32 and bf16: within their bounds, planted faults "
          f"failing, two launches identical ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    results = {}
    for mode, n in (("tp", TP), *((k, 4) for k in TP_MESHES)):
        st = stage_setting(mode)
        ref = reference_run(dev, st, mode, grads=True)
        torch.cuda.empty_cache()
        results[mode] = ranks = run_ranks(mode, n)
        stage_report(mode, ranks, ref, st)
        if mode == "tp":
            tp_ckpt_check(dev, ranks, st)
        for p in (ref["grads"], ref["grads"].replace(".pt", "_whole.pt")):
            if os.path.exists(p):
                os.remove(p)
        print(f"[tp] {mode} done at {time.perf_counter() - t0:.1f} s", flush=True)
    phase_dryrun()
    rows = tp_rows(krec, results["tp"][0]["runs"])
    del krec
    torch.cuda.empty_cache()
    print(f"[tp] phase (k): {time.perf_counter() - t0:.1f} s")
    return rows


# ------------------------------------------------------------------ (l)

TOOLS_DIR = os.path.join("artifacts", "chip_smoke_tools")   # git-ignored, inside the checkout
TOOLS_BATCHES = 16        # (l1): m7c train batches (8 x 2049) from each packer
TOOLS_STEPS, TOOLS_PROFILE, TOOLS_MEM_EVERY = 8, 2, 4
# (l2)'s depth (full width): under --detect-anomaly an m7c step took 4.3 s at
# 12 layers on the H100 (0.3 s without), which would take the phase to ~60 s
TOOLS_LAYERS = 2
TOOLS_ARGS = ("--config", os.path.join("configs", "m7c_125m.yaml"), "--data", "synthetic",
              "--n-layers", str(TOOLS_LAYERS), "--steps", str(TOOLS_STEPS), "--profile",
              str(TOOLS_PROFILE), "--mem-dump-every", str(TOOLS_MEM_EVERY), "--watchdog",
              "--detect-anomaly", "--log-every", "4")
TOOLS_TIMEOUT_S = 240
# the CUDA symbol that each bf16 kernel of the default m7c step launches, by the
# name of its launch count (rows 1, 2, 3 forward; 7 cmp, 9, 11 backward)
STEP_SYMBOLS = {"select_cmp": "select_cmp_mma_kernel", "sel_attn": "sel_attn_union_kernel",
                "win_attn": "win_fwd_mma_kernel", "banded_bwd_1p": "banded_bwd_1p_mma_kernel",
                "sel_attn_bwd_1p": "sel_bwd_kv_mma_kernel",
                "win_bwd_diag": "win_bwd_diag_mma_kernel"}
# names of PyTorch's attention library kernels and ops (flash, memory-efficient
# cutlass "fmha", cuDNN "sdpa"), none of which the port may run
LIBRARY_ATTENTION = ("flash", "fmha", "sdpa", "scaled_dot_product", "efficient_attention")


def packer_check() -> None:
    """(l1): the native packer built with g++ here; TOOLS_BATCHES m7c train
    batches from make_batches(native=True) byte-equal to native=False's."""
    t = time.perf_counter()
    if not native.native_available():
        fail(f"the native packer did not build: {native._ERROR}")
    built = time.perf_counter() - t
    tcfg, runs, ms = M7C_125M_TRAIN, {}, {True: [], False: []}
    for nat in (False, True, True, False):   # in turns: the first pass warms numpy up
        t = time.perf_counter()
        it = make_batches("synthetic", tcfg.seq_len, tcfg.batch_size, seed=tcfg.seed, native=nat)
        runs[nat] = [next(it) for _ in range(TOOLS_BATCHES)]
        ms[nat].append((time.perf_counter() - t) * 1e3)
    shape = (tcfg.batch_size, tcfg.seq_len + 1)
    if not all(a.shape == b.shape == shape and a.dtype == b.dtype == np.int32
               and np.array_equal(a, b) for a, b in zip(runs[True], runs[False])):
        fail("the native packer's batches differ from the Python packer's")
    print(f"[tools] (l1) native packer {native.library_path()} ready in {built:.2f} s; "
          f"{TOOLS_BATCHES} batches of {shape[0]} x {shape[1]} byte-equal to the Python "
          f"packer's (host ms, synthetic documents included, python, native, native, python: "
          f"{ms[False][0]:.1f}, {ms[True][0]:.1f}, {ms[True][1]:.1f}, {ms[False][1]:.1f})")


def trainer_tools_check() -> None:
    """(l2): the trainer CLI in a subprocess at m7c full width (TOOLS_LAYERS
    deep) with every tool on (TOOLS_ARGS): exit 0, finite losses, no bad step, the native
    packer, mem_step<n>.json with a peak allocation, no .HALT, and a trace
    of the profiled steps that names each kernel of the default step
    (STEP_SYMBOLS) and no attention library kernel or op."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, TOOLS_DIR)
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "nsa_vibe_tpu_torch.train.trainer", *TOOLS_ARGS,
           "--out-dir", out]
    print(f"[tools] (l2) {' '.join(cmd[1:])}", flush=True)
    t = time.perf_counter()
    try:
        run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             timeout=TOOLS_TIMEOUT_S, env={**os.environ, "PYTHONPATH": root})
    except subprocess.TimeoutExpired:
        fail(f"the trainer did not end within {TOOLS_TIMEOUT_S} s")
    secs = time.perf_counter() - t
    print("\n".join(ln for ln in run.stdout.splitlines() if ln.startswith("[trainer]")))
    if run.returncode != 0:
        print(run.stdout[-3000:], run.stderr[-3000:])
        fail(f"the trainer exited with {run.returncode}")
    summary = json.loads(run.stdout.strip().splitlines()[-1])["summary"]
    with open(os.path.join(out, "training.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    if (summary["steps"] != TOOLS_STEPS or summary["bad_steps"] or not rows
            or not np.all(np.isfinite(losses)) or any(int(r["bad_steps"]) for r in rows)):
        fail(f"the trainer's run: {summary}, logged losses {losses}")
    if "[trainer] packer: native C++" not in run.stdout:
        fail("the trainer did not use the native packer")
    if os.path.exists(os.path.join(out, ".HALT")):
        fail("the trainer's run left a .HALT")
    peaks = {}
    for n in range(TOOLS_MEM_EVERY, TOOLS_STEPS + 1, TOOLS_MEM_EVERY):
        path = os.path.join(out, f"mem_step{n}.json")
        if not os.path.exists(path):
            fail(f"no {path}")
        with open(path) as f:
            peaks[n] = json.load(f).get("allocated_bytes.all.peak", 0)
    if not all(v > 0 for v in peaks.values()):
        fail(f"mem_step*.json without a peak allocation: {peaks}")
    # the trainer profiles from its third step (numbered as its log numbers steps)
    path = os.path.join(out, "profile", f"trace_steps3-{2 + TOOLS_PROFILE}.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels_seen = [e["name"] for e in events if e.get("cat") == "kernel"]
    library = sorted({e["name"][:80] for e in events if e.get("cat") in ("kernel", "cpu_op")
                      and any(k in e["name"].lower() for k in LIBRARY_ATTENTION)})
    M = M7C_125M_TRAIN
    want = ["select_cmp", "sel_attn", "win_attn"] + [
        tuning.backward_kernel(b, M.seq_len, M7C_125M.nsa.w) for b in ("win", "cmp", "sel")]
    calls = {k: sum(STEP_SYMBOLS[k] in n for n in kernels_seen) for k in want}
    print(f"[tools] (l2) trainer exit 0 in {secs:.1f} s (its loop {summary['wall_s']:.1f} s): "
          f"logged losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}, bad steps 0; peak allocated "
          + ", ".join(f"step {n} {v} bytes" for n, v in peaks.items())
          + f"; {path}: {len(events)} events, {len(kernels_seen)} kernels, port kernels "
          + ", ".join(f"{k} ({STEP_SYMBOLS[k]}) {v}" for k, v in calls.items())
          + f"; attention library kernels or ops: {library or 'none'}")
    if not all(calls.values()) or library:
        fail("the profiled steps miss a kernel of the default step or ran a library "
             "attention kernel")


def module_check(dev) -> None:
    """(l3): NSAAttention and LlamaBlockNSA (models/nn_module.py) at m7c
    width, bf16, 1 x S, bit-equal to nsa_prefill / block_prefill on the same
    parameters, output and every gradient; the modules' forward and backward
    launch each kernel of the default step."""
    cfg = M7C_125M.nsa
    gen = torch.Generator().manual_seed(2468)
    x = torch.randn((1, S, cfg.dim), generator=gen).to(dev, torch.bfloat16)
    cases = (("NSAAttention", NSAAttention, cfg,
              init_nsa_params(cfg, gen, device=dev, dtype=torch.bfloat16),
              lambda p: nsa_prefill(p, x, cfg)[0]),
             ("LlamaBlockNSA", LlamaBlockNSA, M7C_125M,
              init_block_params(gen, M7C_125M, torch.bfloat16, dev),
              lambda p: block_prefill(p, x, M7C_125M)[0]))
    for name, cls, c, params, functional in cases:
        mod = cls(c, params, device=dev)
        kernels.reset_launch_counts()
        y = mod(x)
        y.float().square().mean().backward()
        counts = train_counts()
        leaves = [t.detach().requires_grad_(True) for _, t in param_leaves(params)]
        want = functional(tree_from_leaves(params, leaves))
        grads = torch.autograd.grad(want.float().square().mean(), leaves)
        paths = [k.strip("/").replace("/", ".") for k, _ in param_leaves(params)]
        same = [torch.equal(mod.tree.get_parameter(k).grad, g) for k, g in zip(paths, grads)]
        launched = {k: counts[k] for k in STEP_SYMBOLS}
        equal = torch.equal(y, want)
        print(f"[tools] (l3) {name} 1 x {S} bf16: output {'bit-equal' if equal else 'DIFFERENT'}"
              f", {sum(same)} of {len(same)} gradients bit-equal to the functional call's; "
              f"launches {launched}")
        if not equal or not all(same) or not all(launched.values()):
            fail(f"{name} is not the functional call, or missed a kernel")


def phase_tools(dev) -> None:
    """Phase (l), host tools (run last): (l1) packer_check, (l2)
    trainer_tools_check, (l3) module_check."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    packer_check()
    trainer_tools_check()
    module_check(dev)
    print(f"[tools] phase (l): {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ (m)

FOLD = {"nsa.gate_fold": 1}
FOLD_SEED = 1811
FOLD_BUDGET_S = 40.0          # phase (m)'s share of the script's time limit (a check)
FOLD_SERVE_SEEDS = (0, 1, 2)  # the serve prefill's seeds under the fold (0: phase (c)'s)
FOLD_F32_TOL = 1e-5           # f32 folded vs unfolded logits, of the max |logit|
S_FOLD_LONG = 20480           # a prompt on the long route (S_sel = 320 > 256) under the fold
FOLD_FWD = ("select_cmp", "sel_attn", "win_attn", "banded_attn")     # rows 1, 2, 3, 5 (cmp)
FOLD_BWD = ("banded_bwd_1p@win", "banded_bwd_1p@cmp", "sel_attn_bwd_1p")   # rows 7, 9


def fold_keys(extra=None) -> dict:
    """The design keys with the gate-epilogue fold on (and `extra`)."""
    return {**(extra or {}), **FOLD}


def fold_operands(x, dtype) -> dict:
    """x's train-shape operands (train_kernel_inputs, bf16) in `dtype` (M
    and the row statistics stay f32) and a gate [B,S,G] f32 in [0.05, 1)
    from FOLD_SEED."""
    y = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() and k != "M"
         and not k.startswith("lse") else v for k, v in x.items()}
    gen = torch.Generator(device=x["Q"].device).manual_seed(FOLD_SEED)
    y["gate"] = torch.rand(x["Q"].shape[:3], generator=gen, device=x["Q"].device) * 0.95 + 0.05
    return y


def fold_fwd_calls(y) -> dict:
    """name -> (the gated launch's O, the gated plain version's O, the
    plain version's unrounded f32 O and rss, each times the gate) of rows
    1, 2, 3 and 5 (cmp) on fold_operands."""
    cfg, sc, g = y["cfg"], y["scale"], y["gate"]
    gg = g[..., None, None]
    c, w = (y["Q"], y["Kc"], y["Vc"]), (y["Q"], y["Kw"], y["Vw"])
    s = (y["Q"], y["K"], y["V"], y["sel"], y["t"])
    ckw = dict(scale=sc, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)
    cmp_ = dict(mode="cmp", l=cfg.l, d=cfg.d, scale=sc)
    skw = dict(l_sel=cfg.l_sel, scale=sc)

    def times_g(pair):
        return pair[0] * gg, pair[1] * gg

    return {
        "select_cmp": (lambda: select_cmp(*c, y["M"], **ckw, gate=g)[1],
                       lambda: select_cmp_plain(*c, y["M"], **ckw, gate=g)[1],
                       lambda: times_g(banded_attn_rss(*c, **cmp_))),
        "sel_attn": (lambda: sel_attn(*s, **skw, gate=g),
                     lambda: sel_attn_plain(*s, **skw, gate=g),
                     lambda: times_g(sel_attn_rss(*s, **skw))),
        "win_attn": (lambda: win_attn(*w, w=cfg.w, scale=sc, gate=g),
                     lambda: win_attn_plain(*w, w=cfg.w, scale=sc, gate=g),
                     lambda: times_g(banded_attn_rss(*w, mode="win", w=cfg.w, scale=sc))),
        "banded_attn": (lambda: banded_attn(*c, **cmp_, gate=g),
                        lambda: banded_attn_plain(*c, **cmp_, gate=g),
                        lambda: times_g(banded_attn_rss(*c, **cmp_))),
    }


def fold_forward_checks(x) -> dict:
    """(m1) Rows 1, 2, 3 and 5 (cmp) given the gate, at the train shape, f32
    then bf16 (fwd_check: two launches bit-equal; f32 within allowed_err of
    the gated plain version; bf16 within allowed_tc_err of the plain
    version's unrounded O and rss times the gate, where a planted 1% fault
    must fail); the gated launches' lse and selection equal the ungated
    ones' bit for bit, and in bf16 select_cmp's gated O equals banded_attn's
    (cmp). Returns the bf16 max errors."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        y = fold_operands(x, dtype)
        tc = dtype == torch.bfloat16
        for name, (run, plain, rss) in fold_fwd_calls(y).items():
            err = fwd_check(f"{name}@fold", run, dtype, y["Q"].shape[1],
                            lambda a, b, p=plain: p(), lambda a, b, r=rss: r(), tc=tc,
                            lse=False, rows=None, chunk=None)
            if tc:
                errs[name] = err
        cfg, sc, g = y["cfg"], y["scale"], y["gate"]
        c = (y["Q"], y["Kc"], y["Vc"])
        ckw = dict(scale=sc, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel, return_lse=True)
        skw = dict(l_sel=cfg.l_sel, scale=sc, return_lse=True)
        cmp_ = dict(mode="cmp", l=cfg.l, d=cfg.d, scale=sc, return_lse=True)
        sel_g, O_g, lse_g = select_cmp(*c, y["M"], **ckw, gate=g)
        sel_u, _, lse_u = select_cmp(*c, y["M"], **ckw)
        Ob_g, lb_g = banded_attn(*c, **cmp_, gate=g)
        same = {"select_cmp sets": torch.equal(sel_g, sel_u),
                "select_cmp lse": torch.equal(lse_g, lse_u),
                "banded_attn lse": torch.equal(lb_g, banded_attn(*c, **cmp_)[1])}
        sargs = (y["Q"], y["K"], y["V"], y["sel"], y["t"])
        same["sel_attn lse"] = torch.equal(sel_attn(*sargs, **skw, gate=g)[1],
                                           sel_attn(*sargs, **skw)[1])
        wargs = (y["Q"], y["Kw"], y["Vw"])
        same["win_attn lse"] = torch.equal(
            win_attn(*wargs, w=cfg.w, scale=sc, return_lse=True, gate=g)[1],
            win_attn(*wargs, w=cfg.w, scale=sc, return_lse=True)[1])
        if tc:
            same["select_cmp O = banded_attn O"] = torch.equal(O_g, Ob_g)
        print(f"[fold] {str(dtype)[6:]}: the gated launches against the ungated ones, bit for "
              f"bit: {same}")
        if not all(same.values()):
            fail(f"a gated forward changed lse or the selection, or select_cmp's gated O is "
                 f"not banded_attn's: {same}")
        del y, sel_g, O_g, lse_g, sel_u, lse_u, Ob_g, lb_g
        torch.cuda.empty_cache()
    return errs


def fold_bwd_calls(y) -> dict:
    """name -> (the gated launch, the ungated launch on (dO * g).to(dtype),
    the ungated launch on dO (the gate dropped), the plain version's
    unrounded f32 gradients and rss on (dO * g).to(dtype), the gated plain
    version, the visibility mask) of rows 7 (win, cmp) and 9 on
    fold_operands; delta = rowsum(dO * Y), Y the gated forward's output."""
    cfg, sc, g, Q, dO = y["cfg"], y["scale"], y["gate"], y["Q"], y["dO"]
    gdO = gate_dO(dO, g)
    Bq, S_q, G = Q.shape[:3]
    win = dict(mode="win", w=cfg.w, scale=sc)
    cmp_ = dict(mode="cmp", l=cfg.l, d=cfg.d, scale=sc)
    sel = dict(l_sel=cfg.l_sel, scale=sc)
    wa, ca = (Q, y["Kw"], y["Vw"]), (Q, y["Kc"], y["Vc"])
    sa = (Q, y["K"], y["V"], y["sel"], y["t"])
    Dw = attention_delta(dO, win_attn(*wa, w=cfg.w, scale=sc, gate=g))
    Dc = attention_delta(dO, banded_attn(*ca, **cmp_, gate=g))
    Ds = attention_delta(dO, sel_attn(*sa, **sel, gate=g))
    wt, ct, st = (y["lse_w"], Dw), (y["lse_c"], Dc), (y["lse_s"], Ds)
    S_cmp = y["Kc"].shape[2]
    return {
        "banded_bwd_1p@win": (
            lambda: banded_bwd_1p(*wa, dO, *wt, **win, gate=g),
            lambda: banded_bwd_1p(*wa, gdO, *wt, **win),
            lambda: banded_bwd_1p(*wa, dO, *wt, **win),
            lambda: banded_bwd_rss(*wa, gdO, *wt, **win),
            lambda: banded_bwd_plain(*wa, dO, *wt, **win, gate=g),
            lambda: banded_mask(S_q, S_q, mode="win", w=cfg.w, device=Q.device)[
                None, :, None, :].expand(Bq, S_q, G, S_q)),
        "banded_bwd_1p@cmp": (
            lambda: banded_bwd_1p(*ca, dO, *ct, **cmp_, gate=g),
            lambda: banded_bwd_1p(*ca, gdO, *ct, **cmp_),
            lambda: banded_bwd_1p(*ca, dO, *ct, **cmp_),
            lambda: banded_bwd_rss(*ca, gdO, *ct, **cmp_),
            lambda: banded_bwd_plain(*ca, dO, *ct, **cmp_, gate=g),
            lambda: banded_mask(S_q, S_cmp, mode="cmp", l=cfg.l, d=cfg.d, device=Q.device)[
                None, :, None, :].expand(Bq, S_q, G, S_cmp)),
        "sel_attn_bwd_1p": (
            lambda: sel_attn_bwd_1p(*sa, dO, *st, **sel, gate=g),
            lambda: sel_attn_bwd_1p(*sa, gdO, *st, **sel),
            lambda: sel_attn_bwd_1p(*sa, dO, *st, **sel),
            lambda: sel_attn_bwd_rss(*sa, gdO, *st, **sel),
            lambda: sel_attn_bwd_plain(*sa, dO, *st, **sel, gate=g),
            lambda: selection_token_mask(y["sel"], y["t"], cfg.l_sel, y["K"].shape[2])),
    }


def fold_backward_checks(x) -> dict:
    """(m2) Rows 7 (win, cmp) and 9 given the gate, at the train shape, f32
    then bf16: bit-equal to the ungated launch on (dO * g).to(dtype), as the
    TPU kernels' in-kernel (dO * g).astype(dO.dtype) (flash_bwd.py:424,
    sel_flash.py:781); the launch with the gate dropped must differ; in bf16
    each gradient within allowed_tc_err of the plain version's unrounded
    result on (dO * g).to(bf16), where a planted 1% fault must fail.
    Returns the bf16 max errors."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        y = fold_operands(x, dtype)
        for name, (gated, dense, dropped, rss, _, _) in fold_bwd_calls(y).items():
            got, want, drop = gated(), dense(), dropped()
            torch.cuda.synchronize()
            equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
            differ = not all(torch.equal(a, b) for a, b in zip(got, drop))
            print(f"[fold] {name} {str(dtype)[6:]} given the gate: dQ, dK, dV bit-equal to the "
                  f"ungated launch on (dO * g).to(dtype): {equal}; the launch with the gate "
                  f"dropped differs: {differ}")
            if not all(equal) or not differ:
                fail(f"{name} {dtype}: the gated backward is not the ungated one on "
                     f"(dO * g).to(dtype), or dropping the gate changes nothing")
            del want, drop
            if dtype == torch.bfloat16:
                plain, rs = rss()
                bounds = [allowed_tc_err(p, r) for p, r in zip(plain, rs)]
                errs[name] = max(check(f"{name}@fold:{n}", a, p, bound=bd) for n, a, p, bd in
                                 zip(("dQ", "dK", "dV"), got, plain, bounds))
                faults = [worst_ratio(a * FAULT, p, bd) for a, p, bd in zip(got, plain, bounds)]
                print(f"[check] {name}@fold bf16 with a {FAULT - 1:.0%} fault planted in dQ, "
                      f"dK, dV: worst err/bound {', '.join(f'{v:.3f}' for v in faults)} (each "
                      f"must exceed 1)")
                if not min(faults) > 1.0:
                    fail(f"{name}@fold: a planted {FAULT - 1:.0%} fault passes the bf16 bound")
                del plain, rs, bounds
            del got
        del y
        torch.cuda.empty_cache()
    return errs


@contextlib.contextmanager
def plain_softmax_gate():
    """Runs the body with the fold's gate backward (core/gate.py::
    _SoftmaxDForm, dz = D - g sum(D)) replaced by plain softmax's, which
    reads the D-form cotangent as dg: dz = g (D - sum(g D)). A fault the
    folded gradient check must catch on the gate leaves."""
    real = gate_mod._SoftmaxDForm.__dict__["backward"]

    def plain(ctx, D):
        (g,) = ctx.saved_tensors
        return g * (D - (g * D).sum(-1, keepdim=True))

    gate_mod._SoftmaxDForm.backward = staticmethod(plain)
    try:
        yield
    finally:
        gate_mod._SoftmaxDForm.backward = real


def fold_grad_check(dev) -> None:
    """(m3a) The m7c train step's first gradient in f32 (first_grads) under
    the fold, with the default backward keys and with DESIGNS["twopass"]
    (rows 8, 10 and 11 on the dense (dO * g).to(dtype)), against the
    unfolded default keys': per leaf ||g - g_ref|| / ||g_ref|| within
    STEP_GRAD_TOL; with plain_softmax_gate the gate leaves must exceed it."""
    ref = first_grads(dev, "float32", None)

    def gaps(keys, plant=None):   # (worst leaf, its name, worst gate leaf)
        with plant or contextlib.nullcontext():
            got = first_grads(dev, "float32", keys)
        errs = [(float((g.float() - r.float()).norm() / r.float().norm()), n)
                for (n, g), (_, r) in zip(got, ref)]
        return (*max(errs), max(e for e, n in errs if "/gate/" in n))

    bad = []
    for label, keys in (("fold", fold_keys()), ("fold, twopass", fold_keys(DESIGNS["twopass"]))):
        err, leaf, gate_err = gaps(keys)
        print(f"[fold grads] f32 first gradient under {label} vs the unfolded default keys': "
              f"{err:.3e} ({leaf}); gate leaves {gate_err:.3e} (bound {STEP_GRAD_TOL:g})")
        if not err <= STEP_GRAD_TOL:
            bad.append(label)
    err, leaf, gate_err = gaps(fold_keys(), plain_softmax_gate())
    print(f"[fold grads]   planted: the gate's D-form backward replaced by plain softmax's: "
          f"gate leaves {gate_err:.3e} (worst leaf {err:.3e}, {leaf}); must exceed the bound")
    if not gate_err > STEP_GRAD_TOL:
        bad.append("planted plain softmax backward")
    del ref
    torch.cuda.empty_cache()
    if bad:
        fail(f"the folded train step's first gradient check failed for {bad}")


def fold_train(dev, tr) -> dict:
    """(m3b) The m7c train step (phase_train, bf16) under the fold with the
    default backward keys: its losses within LOSS_TOL of phase (d)'s
    unfolded ones (`tr`), the gated launches (rows 1, 2 and 3 twice a layer
    a step, row 7 cmp and row 9 once; row 11, the window's backward, ungated
    on the dense (dO * g)), the traced step's busy and other-kernels ms
    beside the unfolded step's. Returns phase_train's record."""
    with design_keys(fold_keys()):
        r = phase_train(dev, "train fold")
        win_bwd = tuning.backward_kernel("win", M7C_125M_TRAIN.seq_len, M7C_125M.nsa.w)
    diff = max(abs(a - b) for a, b in zip(r["losses"], tr["losses"]))
    L, T = M7C_125M.n_layers, TIMED_STEPS
    want = {"select_cmp": 2 * L * T, "sel_attn": 2 * L * T, "win_attn": 2 * L * T,
            "banded_attn": 0, "banded_bwd_1p": L * T, "sel_attn_bwd_1p": L * T}
    print(f"[fold] train step under the fold: losses vs the unfolded step's: max |difference| "
          f"{diff:.3e} (bound {LOSS_TOL:g}); gated launches over {T} steps {r['gated']} "
          f"(expected {want}); the window's backward {win_bwd} (ungated on the dense "
          f"(dO * g)): {r['counts'].get(win_bwd)} launches")
    print(f"[fold] traced step: busy {r['busy']:.3f} ms, other kernels {r['other']:.3f} ms "
          f"under the fold; unfolded (phase (d)) busy {tr['busy']:.3f} ms, other kernels "
          f"{tr['other']:.3f} ms; step {r['step_ms']:.3f} ms vs {tr['step_ms']:.3f} ms")
    if not diff <= LOSS_TOL:
        fail("the folded train step's losses differ from the unfolded step's")
    if r["gated"] != want or win_bwd != "win_bwd_diag" or r["counts"][win_bwd] != L * T:
        fail(f"the folded train step's gated launches {r['gated']} != {want}, or the window's "
             f"backward is not the ungated diagonal kernel")
    return r


def serve_logits(params, prompt, mcfg, cap, keys, sync_check=False):
    """The last-position logits of one m7c prefill under the design keys
    `keys` (None: those in force), issued under set_sync_debug_mode("error")
    where `sync_check`, and the gated launches it made."""
    with design_keys(keys):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error" if sync_check else 0)
        try:
            logits = model_prefill_with_caches(params, prompt, mcfg, cap)[0][:, -1]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return logits, kernels.launch_counts(), kernels.gated_launch_counts()


def fold_logit_check(label, params, prompt, mcfg, cap, want_gated: dict, flat: bool) -> dict:
    """One prompt's last-position logits under the fold against the
    unfolded prefill, bf16 and f32 (the same weights, caches of `cap`
    positions): the f32 folded logits
    within FOLD_F32_TOL of the f32 unfolded ones' max |logit| (the fold is
    exact but for f32 rounding, so this is its witness on the no-grad
    path, where the gated kernels run without lse); the bf16 folded logits
    no farther from the f32 unfolded ones than the bf16 unfolded logits
    plus LOGIT_ULPS (the fold moves bf16 rounding: the kernel rounds g * O
    once from f32, then the plain sum rounds twice, where the unfolded
    combine rounds the bf16 gate's three products and their sum); with
    `flat`, flat-IO's logits bit-equal to the fold's. The bf16 folded
    prefills issue no host sync. Each folded prefill's gated launches equal
    `want_gated` (0 elsewhere). Returns the launches of the bf16 folded
    prefill and its distances in bf16 ulps."""
    cfg32 = dataclasses.replace(mcfg, dtype="float32")
    params32 = params_to(params, dtype=torch.float32)
    ref = serve_logits(params, prompt, mcfg, cap, None)[0]
    ref32 = serve_logits(params32, prompt, cfg32, cap, None)[0]
    fold32, _, gated32 = serve_logits(params32, prompt, cfg32, cap, fold_keys())
    fold, counts, gated = serve_logits(params, prompt, mcfg, cap, fold_keys(), sync_check=True)
    out = dict(counts=counts, gated=gated)
    for name, g in (("f32", gated32), ("bf16", gated)):
        want = dict.fromkeys(g, 0) | want_gated
        if g != want:
            fail(f"{label} under the fold ({name}): gated launches {g} != {want}")
    f32_rel = float((fold32 - ref32).abs().max()) / float(ref32.abs().max())
    out.update(to_unfolded=logit_ulps(fold, ref), fold_err=logit_ulps(fold, ref32),
               unfold_err=logit_ulps(ref, ref32), f32_rel=f32_rel)
    flat_equal = None
    if flat:
        flat_equal = torch.equal(fold, serve_logits(params, prompt, mcfg, cap,
                                                    fold_keys({"nsa.flat_io": 1}),
                                                    sync_check=True)[0])
    print(f"[fold] {label}: f32 folded logits {f32_rel:.3e} of the max |logit| from the f32 "
          f"unfolded (bound {FOLD_F32_TOL:g}); bf16 folded {out['to_unfolded']:.3f} bf16 ulps "
          f"from the bf16 unfolded; from the f32 unfolded: folded {out['fold_err']:.3f}, "
          f"unfolded {out['unfold_err']:.3f} ulps (bound: unfolded + {LOGIT_ULPS})"
          + ("" if flat_equal is None else f"; flat-IO bit-equal to the fold: {flat_equal}"))
    if not f32_rel <= FOLD_F32_TOL:
        fail(f"{label}: the f32 folded logits are not the f32 unfolded ones")
    if not out["fold_err"] <= out["unfold_err"] + LOGIT_ULPS or flat_equal is False:
        fail(f"{label}: the bf16 folded logits are farther from the f32 unfolded ones than "
             f"the bf16 unfolded logits plus LOGIT_ULPS, or flat-IO changed them")
    del params32
    return out


def fold_serve(dev) -> dict:
    """(m4) m7c at phase (c)'s shape (B x S prompts) on each of
    FOLD_SERVE_SEEDS' weights and prompts: fold_logit_check with rows 1, 2
    and 3 gated once a layer (and flat-IO). Then the long route (1 x
    S_FOLD_LONG: select_blocks beside the gated banded_attn, row 5) on the
    first seed's weights, held likewise. Returns the gated launches of the
    long-route bf16 prefill."""
    mcfg = M7C_125M
    L = mcfg.n_layers
    with torch.no_grad():
        for seed in FOLD_SERVE_SEEDS:
            gen = torch.Generator().manual_seed(seed)
            params = init_model_params(mcfg, gen, device=dev)
            prompt = torch.randint(0, mcfg.vocab_size, (B, S), generator=gen).to(dev)
            fold_logit_check(f"serve prefill {B} x {S}, seed {seed}", params, prompt, mcfg, CAP,
                             {"select_cmp": L, "sel_attn": L, "win_attn": L}, flat=True)
            del params, prompt
        gen = torch.Generator().manual_seed(FOLD_SERVE_SEEDS[0])
        params = init_model_params(mcfg, gen, device=dev)
        long_prompt = torch.randint(0, mcfg.vocab_size, (1, S_FOLD_LONG), generator=gen).to(dev)
        r = fold_logit_check(f"long route 1 x {S_FOLD_LONG}", params, long_prompt, mcfg,
                             S_FOLD_LONG + 1, {"sel_attn": L, "win_attn": L, "banded_attn": L},
                             flat=False)
    counts = r["counts"]
    print(f"[fold] long route under the fold: launches {counts}")
    if counts["select_blocks"] != L or counts["select_cmp"] != 0:
        fail("the long-route prefill under the fold did not run select_blocks once a layer")
    del params
    torch.cuda.empty_cache()
    return r["gated"]


def fold_rows(x, fwd_errs, bwd_errs, train_gated, long_gated) -> list:
    """(m5) The gated kernels' JSON rows at the train shape (bf16): kernel,
    plain version and SDPA times, bounds from this run's inputs (the gate
    among them); launches from the folded train step (rows 1, 2, 3, 7 cmp,
    9; row 7 win runs only under win.bwd_diag 0, so 0 here; rows 1 and 3
    timed with lse, as its Functions launch them) and, for row 5, from the
    long-route prefill (no lse)."""
    y = fold_operands(x, torch.bfloat16)
    cfg, sc, g = y["cfg"], y["scale"], y["gate"]
    rows = [select_cmp_row("select_cmp@fold", y, lse=True, launches=train_gated["select_cmp"],
                           max_err=fwd_errs["select_cmp"])]
    sargs = (y["Q"], y["K"], y["V"], y["sel"], y["t"])
    rows.append(sel_attn_row("sel_attn@fold", *sargs, launches=train_gated["sel_attn"],
                             max_err=fwd_errs["sel_attn"], iters=10, gate=g))
    wargs, cargs = (y["Q"], y["Kw"], y["Vw"]), (y["Q"], y["Kc"], y["Vc"])
    rows.append(band_row("win_attn@fold",
                         lambda: win_attn(*wargs, w=cfg.w, scale=sc, return_lse=True, gate=g),
                         *wargs, mode="win", kw=dict(w=cfg.w), lse=True,
                         launches=train_gated["win_attn"], max_err=fwd_errs["win_attn"],
                         iters=10, gate=g))
    ckw = dict(l=cfg.l, d=cfg.d)
    rows.append(band_row("banded_attn@fold",
                         lambda: banded_attn(*cargs, mode="cmp", **ckw, scale=sc, gate=g),
                         *cargs, mode="cmp", kw=ckw, lse=False, launches=long_gated["banded_attn"],
                         max_err=fwd_errs["banded_attn"], iters=10, gate=g))
    calls = {name: (c[0], c[4], c[5]) for name, c in fold_bwd_calls(y).items()}
    runs = [{"banded_bwd_1p": train_gated["banded_bwd_1p"],
             "banded_bwd_1p@cmp": train_gated["banded_bwd_1p"],
             "sel_attn_bwd_1p": train_gated["sel_attn_bwd_1p"]}]
    bwd = measure_train({"inputs": y, **bwd_errs}, runs, FOLD_BWD, calls=calls, suffix="@fold")
    for r in bwd:
        if r["name"].startswith("banded_bwd_1p"):
            r["source"] = "nsa_vibe_tpu_torch/csrc/banded_bwd_gated_mma.cu"
    print_rows(rows)
    del y
    torch.cuda.empty_cache()
    return rows + bwd


def phase_fold(dev, x, tr) -> list:
    """Phase (m), the gate-epilogue fold (nsa.gate_fold) and flat-IO
    (nsa.flat_io), on x (phase (f)'s bf16 train-shape operands) and tr
    (phase (d)'s unfolded train step): (m1) the gated forwards, (m2) the
    gated one-pass backwards, (m3) the m7c train step under the fold, (m4)
    serve prefill under the fold, flat-IO and the long route, (m5) the
    gated kernels' rows. Returns the rows."""
    t = time.perf_counter()
    fwd_errs = fold_forward_checks(x)
    bwd_errs = fold_backward_checks(x)
    fold_grad_check(dev)
    r = fold_train(dev, tr)
    long_gated = fold_serve(dev)
    rows = fold_rows(x, fwd_errs, bwd_errs, r["gated"], long_gated)
    took = time.perf_counter() - t
    print(f"[fold] phase (m) took {took:.1f} s (budget {FOLD_BUDGET_S:g} s)")
    if took > FOLD_BUDGET_S:
        fail(f"phase (m) took {took:.1f} s, past its budget of {FOLD_BUDGET_S:g} s")
    return rows


# ------------------------------------------------------------------ (n)

# the JAX package's configurations (configs/) that no card run had taken,
# each read through the trainer's load_config, in the order phase (n) runs them
CFG_350M, CFG_16K, CFG_LONG, CFG_FAST, CFG_SHOWCASE = (
    "m7c_350m.yaml", "m7c_125m_16k.yaml", "m7c_125m_long.yaml", "m7c_125m_fast.yaml",
    "train_showcase.yaml")
CONFIG_BUDGET_S = 150.0    # phase (n)'s share of the script's time limit (a check)
CONFIG_STEPS = 2           # timed steps of the 16k, 8k, batch-16 and showcase runs
CHUNK_16K = 4096           # query rows a plain forward call at 16k
HEADS_16K = 2              # heads a plain backward call at 16k ([1, 16384, 2, 2, 16384] f32)
PEAK_GROWTH = 0.01         # a step of A micro-batches peaks within 1% of a step of 2
CONFIGS_DIR = os.path.join("artifacts", "chip_smoke_configs")   # git-ignored, in the checkout
SHOWCASE_STEPS, SHOWCASE_TIMEOUT_S = 20, 180
SERVE_ITERS_350M = 5       # timed decode steps of each kind at the 350M serve shape (a step ~0.2 s)


def config_of(name: str) -> tuple:
    """(mcfg, tcfg) of configs/<name> through train/trainer.py::load_config,
    the port's entry point; the data source is synthetic tokens (fineweb
    needs the network, and the port raises on it)."""
    root = os.path.dirname(os.path.abspath(__file__))
    mcfg, tcfg, data = load_config(os.path.join(root, "configs", name))
    c = mcfg.nsa
    print(f"[configs] {name}: {mcfg.n_layers} layers, dim {c.dim}, {c.n_heads} heads in "
          f"{c.n_kv_groups} KV groups (h = {c.h_per_group}), d_k {c.d_k}, {mcfg.dtype}, remat "
          f"{mcfg.remat}, rope_scale {c.rope_scale}; {tcfg.accum_steps} x {tcfg.batch_size} x "
          f"{tcfg.seq_len} tokens a step; data {data}, run on synthetic tokens", flush=True)
    return mcfg, tcfg


def default_bwd(mcfg, tcfg) -> tuple:
    """The backward kernel rows (phase_train_kernels' names) that the keys
    in force run at tcfg's sequence length."""
    names = []
    for branch in ("win", "cmp", "sel"):
        k = tuning.backward_kernel(branch, tcfg.seq_len, mcfg.nsa.w)
        names.append(f"{k}@{branch}" if k.startswith("banded_bwd") else k)
    return tuple(names)


def config_summary(name: str, mcfg, tcfg, tr) -> None:
    """One line of a configuration's train run: step ms, busy, idle share,
    tokens/s, MFU, peak memory."""
    rows = tcfg.accum_steps * tcfg.batch_size
    flops = train_step_flops(mcfg, rows, tcfg.seq_len)["total"]
    print(f"[configs] {name}: step {tr['step_ms']:.3f} ms, busy {tr['busy']:.3f} ms, idle share "
          f"{1 - tr['busy'] / tr['step_ms']:.3f}, "
          f"{rows * tcfg.seq_len / (tr['step_ms'] / 1e3):.0f} tokens/s, MFU "
          f"{100 * flops / (tr['step_ms'] / 1e3) / H100_BF16_PEAK_FLOPS:.4f}%, "
          f"max_memory_allocated {tr['peak']} bytes ({tr['peak'] / 2**30:.2f} GiB)")


def config_kernel_rows(rec, counts, names, tag: str, chunk=None) -> list:
    """The JSON rows of rows 1, 2 and 3 (with lse, as the train step
    launches them) and of the backward rows `names` on
    phase_train_kernels' bf16 inputs (`rec`), named <kernel>@tag, with the
    launches of a train run's timed steps (`counts`; `chunk` rows a plain
    forward call); then the tile sweeps, printed only: the fused scorer's
    CTAs, the union forward's q tiles, the selection backward's chunks a
    CTA and dQ q tiles, the banded one-pass kernel's CTAs and chunks, the
    diagonal and two-pass dQ kernels' q tiles."""
    x = rec["inputs"]
    cfg, sc = x["cfg"], x["scale"]
    sargs, wargs = (x["Q"], x["K"], x["V"], x["sel"], x["t"]), (x["Q"], x["Kw"], x["Vw"])
    rows = [select_cmp_row(f"select_cmp@{tag}", x, lse=True, launches=counts["select_cmp"],
                           max_err=x["cmp_fwd_err"]),
            sel_attn_row(f"sel_attn@{tag}", *sargs, launches=counts["sel_attn"],
                         max_err=x["sel_fwd_err"], iters=10, plain_rows=chunk),
            band_row(f"win_attn@{tag}", lambda: win_attn(*wargs, w=cfg.w, scale=sc,
                                                         return_lse=True), *wargs,
                     mode="win", kw=dict(w=cfg.w), lse=True, launches=counts["win_attn"],
                     max_err=x["win_fwd_err"], iters=10, chunk=chunk)]
    print_rows(rows)
    rows += measure_train(rec, [counts], names, suffix=f"@{tag}")
    cmp_tiles(tag, x)
    sel_fwd_tiles(tag, *sargs, iters=5)
    phase_sel_tiles(x)
    phase_band_bwd_tiles(x)
    return rows


def config_350m(dev) -> list:
    """(n1) configs/m7c_350m.yaml (G = 4, h = 4, 24 layers): rows 1, 2, 3
    (with lse), 7 (cmp), 9 and 11 and their partners at the 8 x 2048 train
    shape against their plain versions (phase_train_kernels), row 4 at the
    decode shape (sel_fwd_check); one layer f32 card vs CPU (1 x 2048)
    with LAYER_FAULTS planted (train_layer_check); serving (phase_serve, 4 x 2048 +
    32, and the replayed decode, serve_shape_times); the train step
    (phase_train); the JSON rows and tile sweeps."""
    mcfg, tcfg = config_of(CFG_350M)
    names = default_bwd(mcfg, tcfg)
    rec = phase_train_kernels(dev, names, cfg=mcfg.nsa, rows=tcfg.batch_size, seq=tcfg.seq_len,
                              tag="350m")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cfg = mcfg.nsa
    for dtype in (torch.float32, torch.bfloat16):
        x = kernel_inputs(dtype, dev, gen, cfg)
        dec = (x["Qd"], x["Kd"], x["Vd"], x["sel_dec"], x["t_dec"])
        dec_err = sel_fwd_check("sel_attn@350m-decode",
                                lambda: sel_attn(*dec, l_sel=cfg.l_sel, scale=x["scale"]),
                                *dec, l_sel=cfg.l_sel, scale=x["scale"])
        del x
    train_layer_check(dev, {"default": None}, mcfg=mcfg, faults=LAYER_FAULTS, rows=1)
    serve = phase_serve(dev, mcfg, tag="350m serve", label="m7c-350M", layer=False)
    times = serve_shape_times(serve.pop("params"), mcfg, serve.pop("prompt"), dev,
                              tag="350m serve", iters=SERVE_ITERS_350M)
    print(f"[configs] m7c_350m.yaml serve: prefill {serve['prefill_ms']:.3f} ms, decode "
          f"{serve['decode_ms']:.4f} ms a step, replayed {times['replay_ms']:.4f} ms a step")
    torch.cuda.empty_cache()
    tr = phase_train(dev, "350m train", mcfg=mcfg, tcfg=tcfg, label="m7c-350M")
    config_summary(CFG_350M, mcfg, tcfg, tr)
    torch.cuda.empty_cache()
    rows = config_kernel_rows(rec, tr["counts"], names, "350m")
    rows.append(sel_attn_row("sel_attn@350m-decode", *dec, launches=serve["decode_launches"],
                             max_err=dec_err))
    print_rows(rows[-1:])
    return rows


def remat_accum_check(tag: str, mcfg, tcfg, tr) -> None:
    """MLP-only remat and accumulation on phase_train's state and batches
    (`tr`, kept): (1) a forward of one micro-batch leaves no [rows, 4 dim]
    MLP hidden activation saved for the backward (without remat it leaves
    two a layer, which shows the check can fail); (2) the peak of a step of
    one micro-batch under MLP-only and under full remat, printed; (3) the
    peak of a step of tcfg.accum_steps micro-batches within PEAK_GROWTH of
    a step of 2, each from the same state: nothing grows from one
    micro-batch to the next."""
    state, batch = tr["state"], tr["batches"][1]
    tokens = batch[0, :, :-1]
    hidden = int(mcfg.nsa.dim * mcfg.mlp_ratio)

    def saved_hidden(m) -> int:
        refs = []

        def pack(t):   # a detached alias: a saved output packed as itself would hold
            d = t.detach()   # its own grad_fn, a cycle through C++ that no gc frees
            refs.append(weakref.ref(d))
            return d

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda d: d):
            logits, _ = model_forward(state.params, tokens, m)
        n = sum(1 for t in (r() for r in refs) if t is not None and t.shape[-1] == hidden
                and t.numel() >= tokens.numel() * hidden)
        del logits
        return n

    n_mlp, n_none = saved_hidden(mcfg), saved_hidden(dataclasses.replace(mcfg, remat=False))

    def peak(m, b) -> int:
        step = make_train_step(m, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, b)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    p_mlp, p_full = peak(mcfg, batch[:1]), peak(dataclasses.replace(mcfg, remat=True), batch[:1])
    p_two, p_all = peak(mcfg, batch[:2]), peak(mcfg, batch)
    print(f"[{tag}] MLP hidden activations [{tokens.numel()}, {hidden}] saved by one forward: "
          f"{n_mlp} under MLP-only remat, {n_none} without remat (must be 0 and at least "
          f"{mcfg.n_layers}); peak of a one-micro-batch step: MLP-only remat {p_mlp} bytes "
          f"({p_mlp / 2**30:.2f} GiB), full remat {p_full} bytes ({p_full / 2**30:.2f} GiB); "
          f"peak of a step of {batch.shape[0]} micro-batches {p_all} bytes, of 2 {p_two} "
          f"bytes (at most {PEAK_GROWTH:.0%} more; the timed steps' {tr['peak']} bytes)")
    if n_mlp or n_none < mcfg.n_layers:
        fail(f"{tag}: MLP-only remat leaves the MLP's hidden activation saved")
    if not p_all <= p_two * (1 + PEAK_GROWTH):
        fail(f"{tag}: a step's peak memory grows with its micro-batches")


def config_16k(dev) -> list:
    """(n2) configs/m7c_125m_16k.yaml (1 x 16384, MLP-only remat, rope_scale
    8, 8 micro-batches): the prefill route must be the fused scorer
    (select_cmp_fits at S_sel = 256); rows 1, 2, 3 (with lse), 7 (cmp), 9
    and 11 and their partners at B = 1, S = 16384 against their plain
    versions (CHUNK_16K rows a plain forward call, HEADS_16K heads a plain
    backward call); the train step (its launch counts show select_cmp once
    a layer and micro-batch, select_blocks never); remat_accum_check; the
    JSON rows and tile sweeps."""
    mcfg, tcfg = config_of(CFG_16K)
    h, S_sel = mcfg.nsa.h_per_group, tcfg.seq_len // mcfg.nsa.l_sel
    fused = sc_mod.select_cmp_fits(h, S_sel)
    print(f"[16k] select_cmp_fits(h = {h}, S_sel = {S_sel}): {fused} (the fused scorer's limit "
          f"S_sel = {sc_mod.SELECT_CMP_MAX_S_SEL})")
    if not fused:
        fail("the 16k prefill would not take the fused scorer")
    names = default_bwd(mcfg, tcfg)
    rec = phase_train_kernels(dev, names, cfg=mcfg.nsa, rows=tcfg.batch_size, seq=tcfg.seq_len,
                              tag="16k", chunk=CHUNK_16K, heads=HEADS_16K)
    torch.cuda.empty_cache()
    tr = phase_train(dev, "16k train", mcfg=mcfg, tcfg=tcfg, label="m7c-125M at 16k",
                     steps=CONFIG_STEPS, keep=True)
    config_summary(CFG_16K, mcfg, tcfg, tr)
    remat_accum_check("16k", mcfg, tcfg, tr)
    counts = tr["counts"]
    del tr
    torch.cuda.empty_cache()
    return config_kernel_rows(rec, counts, names, "16k", chunk=CHUNK_16K)


def showcase_cli() -> None:
    """(n5) the Quick start's trainer command on configs/train_showcase.yaml
    (SHOWCASE_STEPS steps) in a subprocess: exit 0, finite logged losses,
    no bad step."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, CONFIGS_DIR, "showcase")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "nsa_vibe_tpu_torch.train.trainer", "--config",
           os.path.join("configs", CFG_SHOWCASE), "--steps", str(SHOWCASE_STEPS),
           "--out-dir", out]
    print(f"[configs] {' '.join(cmd[1:])}", flush=True)
    t = time.perf_counter()
    try:
        run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             timeout=SHOWCASE_TIMEOUT_S, env={**os.environ, "PYTHONPATH": root})
    except subprocess.TimeoutExpired:
        fail(f"the showcase trainer did not end within {SHOWCASE_TIMEOUT_S} s")
    secs = time.perf_counter() - t
    if run.returncode != 0:
        print(run.stdout[-3000:], run.stderr[-3000:])
        fail(f"the showcase trainer exited with {run.returncode}")
    summary = json.loads(run.stdout.strip().splitlines()[-1])["summary"]
    with open(os.path.join(out, "training.csv")) as f:
        logged = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in logged]
    print(f"[configs] {CFG_SHOWCASE} trainer CLI: exit 0 in {secs:.1f} s (its loop "
          f"{summary['wall_s']:.1f} s), {summary['steps']} steps, logged losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}, bad steps {summary['bad_steps']}")
    if (summary["steps"] != SHOWCASE_STEPS or summary["bad_steps"] or not logged
            or not np.all(np.isfinite(losses)) or any(int(r["bad_steps"]) for r in logged)):
        fail(f"the showcase trainer's run: {summary}, logged losses {losses}")
    shutil.rmtree(out, ignore_errors=True)


def phase_configs(dev) -> list:
    """Phase (n): the JAX package's other configurations on the card, each
    from its yaml file at full width and depth: (n1) m7c-350M, (n2) the 16k
    rung, (n3) the 8k rung (MLP-only remat, rope_scale 4, 4 micro-batches:
    the train step and remat_accum_check), (n4) the batch-16 rung without
    remat (the train step), (n5) the f32 showcase (the train step in this
    process, then the trainer's CLI). Returns the kernels' JSON rows. The
    phase fails past CONFIG_BUDGET_S."""
    t = time.perf_counter()
    rows = config_350m(dev)
    torch.cuda.empty_cache()
    rows += config_16k(dev)
    torch.cuda.empty_cache()
    mcfg, tcfg = config_of(CFG_LONG)
    tr = phase_train(dev, "8k train", mcfg=mcfg, tcfg=tcfg, label="m7c-125M at 8k",
                     steps=CONFIG_STEPS, keep=True)
    config_summary(CFG_LONG, mcfg, tcfg, tr)
    remat_accum_check("8k", mcfg, tcfg, tr)
    del tr
    torch.cuda.empty_cache()
    for name, tag in ((CFG_FAST, "batch-16 train"), (CFG_SHOWCASE, "showcase train")):
        mcfg, tcfg = config_of(name)
        tr = phase_train(dev, tag, mcfg=mcfg, tcfg=tcfg, label=name, steps=CONFIG_STEPS)
        config_summary(name, mcfg, tcfg, tr)
        torch.cuda.empty_cache()
    showcase_cli()
    took = time.perf_counter() - t
    print(f"[configs] phase (n) took {took:.1f} s (budget {CONFIG_BUDGET_S:g} s)")
    if took > CONFIG_BUDGET_S:
        fail(f"phase (n) took {took:.1f} s, past its budget of {CONFIG_BUDGET_S:g} s")
    return rows


# ------------------------------------------------------------------ (o)

ADAMW_NORM_TOL = 2e-6     # the kernels' norm vs global_norm's, relative (another f32 order)
ADAMW_ITERS = 50          # timed calls of the kernels' optimizer (the tensor ops': 3)
# (label, gradient scale, steps from warm-up's end or None for the state as
# it is, clipped): the first step (lr 0), an unclipped step, a clipped step
# past warm-up
ADAMW_STEPS = (("first (lr 0)", 1e-3, None, True), ("unclipped", 1e-5, None, False),
               ("past warm-up", 1e-3, 5, True))


def adamw_check(dev, label: str, mcfg, tcfg) -> dict:
    """(o) at one configuration's trainable leaves, as the train step holds
    them (bf16, from init_train_state): the multi-tensor AdamW's update
    (optim.apply_update_) against the tensor ops (optim.apply_update_plain_)
    on copies of the same state, given the same gradients and the kernels'
    grad_norm and good, bit for bit in p, mu, nu and count through
    ADAMW_STEPS; its norm (optim.norm_and_good) within ADAMW_NORM_TOL of
    global_norm and the same bits twice. Then the JSON row: the kernels'
    optimizer a step (norm_and_good + apply_update_, the train step's
    `train.optimizer` span) timed with the stream held and on the host's
    clock, the tensor ops likewise, its launches a step (optimizer_launches,
    held to the counters) and the bytes bound from the inputs: g read twice,
    p, mu and nu read and written."""
    state = init_train_state(init_model_params(mcfg, torch.Generator().manual_seed(0),
                                               device=dev), tcfg)
    params = [t for _, t in param_leaves(state.params)]
    opt = state.opt_state
    plain = {"mu": [t.clone() for t in opt["mu"]], "nu": [t.clone() for t in opt["nu"]],
             "count": opt["count"].clone()}
    params_plain = [t.detach().clone() for t in params]
    gen = torch.Generator(device=dev).manual_seed(21)
    loss = torch.tensor(2.0, device=dev)
    n = sum(t.numel() for t in params)
    print(f"[adamw] {label}: {len(params)} leaves, {n} elements, {mcfg.dtype}")
    for name, scale, past, want_clip in ADAMW_STEPS:
        if past is not None:
            for c in (opt["count"], plain["count"]):
                c.fill_(tcfg.warmup_steps + past)
        grads = [(torch.randn(t.shape, generator=gen, device=dev) * scale).to(t.dtype)
                 for t in params]
        norm, good = optim.norm_and_good(params, grads, opt, loss)
        again, _ = optim.norm_and_good(params, grads, opt, loss)
        want = optim.global_norm(grads)
        err = abs(float(norm) - float(want)) / float(want)
        optim.apply_update_(params, grads, opt, tcfg, norm, good)
        optim.apply_update_plain_(params_plain, grads, plain, tcfg, norm, good)
        torch.cuda.synchronize()
        differ = sum(not torch.equal(a.reshape(-1).view(torch.uint8),
                                     b.reshape(-1).view(torch.uint8))
                     for a, b in zip(params + opt["mu"] + opt["nu"],
                                     params_plain + plain["mu"] + plain["nu"]))
        clipped = float(norm) >= tcfg.max_grad_norm
        print(f"[adamw] {label} {name}: grad_norm {float(norm):.6f} (clipped {clipped}), vs "
              f"global_norm {err:.3e} (bound {ADAMW_NORM_TOL:g}), repeated bits "
              f"{torch.equal(norm, again)}; p, mu, nu tensors differing from the tensor "
              f"ops' {differ} of {3 * len(params)}; count {int(opt['count'])} / "
              f"{int(plain['count'])}")
        if not err <= ADAMW_NORM_TOL or not torch.equal(norm, again) or not bool(good):
            fail(f"adamw_mt's norm at {label} ({name}) is {err:.3e} from global_norm's or not "
                 f"repeatable")
        if differ or int(opt["count"]) != int(plain["count"]) or clipped != want_clip:
            fail(f"adamw_mt's update at {label} ({name}) is not the tensor ops' bit for bit")
    del params_plain, plain

    def fused():
        norm, good = optim.norm_and_good(params, grads, opt, loss)
        optim.apply_update_(params, grads, opt, tcfg, norm, good)

    def tensor_ops():
        norm = optim.global_norm(grads)
        optim.apply_update_plain_(params, grads, opt, tcfg, norm, torch.isfinite(loss)
                                  & torch.isfinite(norm))

    kernels.reset_launch_counts()
    fused()
    got = {"norm": adamw_mt.norm_and_good.launches, "update": adamw_mt.update_.launches}
    want = optimizer_launches(1, params)
    if got != want:
        fail(f"adamw_mt's launches at {label}: {got} != {want}")
    bms, by = bound(2 * nbytes(*grads, *params, *opt["mu"], *opt["nu"]), 0, params[0].dtype)
    t = time.perf_counter()
    for _ in range(ADAMW_ITERS):
        fused()
    host_ms = (time.perf_counter() - t) * 1e3 / ADAMW_ITERS
    row = dict(name=f"adamw_mt@{label}", source="nsa_vibe_tpu_torch/csrc/adamw_mt.cu",
               replaces="none (optax's clip + AdamW chain, fused by XLA)",
               launches=want["norm"] + want["update"], max_abs_err=0.0,
               ms=time_ms(fused, ADAMW_ITERS, hold=True), host_ms=host_ms,
               plain_ms=time_ms(tensor_ops, 3, warmup=1, hold=True), bound_ms=bms, bound_by=by,
               library_ms=None)
    print(f"[adamw] {label}: the kernels' optimizer {row['ms']:.4f} ms a step (host "
          f"{host_ms:.4f}), the tensor ops {row['plain_ms']:.4f} ms, bound {bms:.4f} ms "
          f"({by}), {want['norm']} + {want['update']} launches a step")
    del state, params, opt, grads
    torch.cuda.empty_cache()
    return row


def phase_adamw(dev) -> list:
    """Phase (o): the multi-tensor AdamW (csrc/adamw_mt.cu) at m7c-125M's and
    m7c-350M's (configs/m7c_350m.yaml) trainable leaves (adamw_check).
    Returns their JSON rows."""
    mcfg, tcfg = config_of(CFG_350M)
    rows = [adamw_check(dev, "125m", M7C_125M, M7C_125M_TRAIN),
            adamw_check(dev, "350m", mcfg, tcfg)]
    print_rows(rows)
    return rows


def _leaves(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, key)
    else:
        yield key, tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    guard_children()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    phase_build()
    rec = phase_kernels(dev)
    serve = phase_serve(dev)
    rows = measure(rec, serve["counts"], serve["decode_launches"])
    del rec, serve
    torch.cuda.empty_cache()
    rows += phase_ragged(dev)
    torch.cuda.empty_cache()
    trec = phase_train_kernels(dev, TWO_PASS)
    cpu = train_layer_check(dev, {"default": None})
    tr = phase_train(dev)
    rows += phase_adamw(dev)
    del trec["inputs"]
    torch.cuda.empty_cache()
    loss_falls(dev)
    lrec = phase_long_kernels(dev)
    cross_check(dev)
    long_counts = phase_long_serve(dev)
    phase_needles(dev)
    rows += measure_long(lrec, long_counts)
    del lrec
    torch.cuda.empty_cache()
    frec = phase_train_kernels(dev, tuple(PARTNERS))
    phase_band_bwd_tiles(frec["inputs"])
    phase_sel_tiles(frec["inputs"])
    x = frec["inputs"]
    sargs = (x["Q"], x["K"], x["V"], x["sel"], x["t"])
    sel_fwd_tiles("train", *sargs, iters=10)
    rows.append(sel_attn_row("sel_attn@train", *sargs, launches=tr["counts"]["sel_attn"],
                             max_err=x["sel_fwd_err"]))
    rows.append(select_cmp_row("select_cmp@train", x, lse=True,
                               launches=tr["counts"]["select_cmp"], max_err=x["cmp_fwd_err"]))
    cfg, wargs = x["cfg"], (x["Q"], x["Kw"], x["Vw"])
    rows.append(band_row("win_attn@train", lambda: win_attn(*wargs, w=cfg.w, scale=x["scale"],
                                                            return_lse=True), *wargs,
                         mode="win", kw=dict(w=cfg.w), lse=True,
                         launches=tr["counts"]["win_attn"], max_err=x["win_fwd_err"], iters=10))
    band_fwd_tiles("train win (lse)", lambda: win_attn(*wargs, w=cfg.w, scale=x["scale"],
                                                       return_lse=True), 10)
    print_rows(rows[-3:])
    del x, sargs, wargs
    runs = [tr["counts"]] + phase_designs(dev, tr["losses"], cpu)
    rows += measure_train({**trec, **frec}, runs, TWO_PASS + tuple(PARTNERS))
    rows += phase_fold(dev, frec["inputs"], tr)
    del trec, frec
    torch.cuda.empty_cache()
    rows += phase_configs(dev)
    torch.cuda.empty_cache()
    rows += phase_varlen(dev)
    torch.cuda.empty_cache()
    rows += phase_parallel(dev)
    torch.cuda.empty_cache()
    rows += phase_stages(dev)
    torch.cuda.empty_cache()
    rows += phase_tp(dev)
    torch.cuda.empty_cache()
    phase_tools(dev)
    left = end_children(grace_s=10)
    print(f"[procs] still running at the end, killed: {left or 'none'}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [{"route": "cuda", **r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:   # a rank of (i), (j) or (k), from start_ranks
        (parallel_worker if sys.argv[2] in ("sp", "fsdp") else stage_worker)(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
