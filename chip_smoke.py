#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It imports
nothing of JAX or of the JAX package ``repro``, and exits non-zero on the
first failed check (and at once where there is no CUDA device, or no port
beside the script).  Phases:

  1. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel); read
     the library's SASS with ``cuobjdump``: the bf16 B9 kernel and every
     instantiation of its backward's tensor-core kernel must issue HGMMA
     (``wgmma``), B9's float32 kernels and every instantiation of the
     backward pair of ``csrc/flash_attention_bwd.cu`` TF32 HMMA
     (``mma.sync``, the three-product split), B7's and B8's tensor-core
     kernels IMMA / HMMA (``mma.sync``), B2, B5 and B7 no atomics, B3, B4,
     B6, B8 and B9's and B10's backward no float atomics; and count the
     SASS instructions of B3's one-trio probes (the exact chain, the
     prefilter);
  2. B1 pairwise_batch (bit-equal across two launches, timed by kernel:
     plan, side pass, reduction), B2 pairwise_corr and B3 pcit_filter
     (with the deciles of its search lengths, the useful share of its
     issued lane-trios, the share of trios its prefilter decided, and its
     time with the exact chain on every trio), and
  3. B4 query_topk and B5 pairwise_threshold, each at its main path's
     shapes against its plain PyTorch version, timed with CUDA events
     beside the plain version and, where one exists, a library yardstick
     (B5: beside a GEMM-only yardstick, ``torch.mm`` over the same active
     tiles);
  4. the engine self-check on the card at P = 2, 5, 8, every mode;
  5. the serving and sparse-join self-checks at P = 2, 5, 8, every mode
     including ``kernel``;
  6. n-body, the quorum path at N = 65,536 bodies over P = 8 devices with
     the fused kernel, against the plain scan path, plus leapfrog steps;
  7. PCIT at N = 8,192 genes x G = 512 samples over P = 8 devices with the
     kernels, against a matmul and the plain filter on the card, and at
     N = 64 against the numpy O(N^3) reference;
  8. serving: a 1,000,000 x 128 corpus (the base-set shape of
     ANN-Benchmarks' sift-128-euclidean; synthetic clustered non-negative
     vectors from a seed) resident over P = 8 devices; 40 microbatches of
     256 l2 top-10 queries through B4, top-100 microbatches, a streamed
     block replace, and a range query that escalates its capacity, held
     against a brute force on the card;
  9. the similarity join of 262,144 x 128 clustered vectors over P = 8
     devices through B5, held against a brute force on the card;
 10. B6 pairwise_topk, B7 pairwise_threshold_q and B8 pairwise_topk_q (int8
     and bf16) at the k-NN and quantized paths' shapes against their plain
     versions, timed beside them and a two-call library yardstick (B6:
     split by kernel, beside its scoring pass alone and with lists in
     global memory; B7: beside a GEMM-only yardstick, ``torch._int_mm`` /
     bf16 ``torch.mm`` over the same active tiles, and on each route at
     d = 128; B8 on both routes too); B8 bf16 at d = 128 to 4,096 on both
     routes against a float64 evaluation and the plain version, and B8 /
     B7 int8 at d = 1,536 against the plain version with its dot in
     float64 rounded once;
 11. the k-NN and quantized-pipeline self-checks at P = 2, 5, 8, every mode
     including ``kernel``;
 12. the k-NN graph (top-10, l2) of the join's corpus through B6, held
     against a brute force on the card;
 13. the quantized join (int8, then bf16) of that corpus through B7, held
     against the f32 join of phase 9;
 14. the quantized k-NN graph (int8) through B8, doubling M until every row
     is certified, held against the f32 graph of phase 12;
 15. quantized serving (int8) of the 1,000,000 x 128 corpus: microbatches
     of 256 l2 top-10 queries before and after a block replace, held
     against the f32 ``ServingCorpus.query``;
 16. B9 flash_attention (one quorum pair [8, 4096, 40 | 8, 128], causal
     and not, bf16 on the ``wgmma`` kernel and f32 on the TF32 tensor
     cores, ``tf32x3``) and B10
     ssd_chunk (mamba2-130m's prefill, [4, 32768, 24, 64], chunk 256, and
     a decode step's [4, 1, 24, 64], chunk 1, timed with 200 launches
     queued behind a spin kernel; bit-equal across two launches; its
     bound with C B^T counted once per chunk and per head) against their
     plain versions, timed beside them and, for B9,
     scaled_dot_product_attention (bf16, and f32 beside the f32 route);
 17. quorum and ring sequence-parallel causal attention at qwen3-14b's
     attention widths (H = 40, KV = 8, hd = 128), T = 32,768, P = 8, in
     bf16 and in f32, held against each other, whole-sequence B9 and the
     f32 plain attention on sampled rows;
 18. mamba2-130m (full config, 128,983,488 random parameters from a seed)
     prefill of 4 x 32,768 tokens through B10, decode == prefill at 1,024
     tokens (bf16 and f32), and the card's prefill against the CPU's;
 19. mamba2-130m serving: ``serve()`` at batch 4, prompt 16, 32 generated
     tokens, B10 launched 24 times per step;
 20. continuous-batching serving over phase 8's corpus: ``serve_queries``
     through ``BatchScheduler`` (B4, 256 requests a launch) drains 40
     microbatches of l2 top-10 requests with a stream update every 10
     (held microbatches against the brute force and, bit for bit, against
     ``ServingCorpus.query``); a heterogeneous pack (k = 1..100, range
     queries with mixed thresholds and capacities) bit-identical to each
     request alone; a capacity escalation; expiry and a partial result
     under injected clocks; the background loop with 1,024 requests;
 21. delta churn: ``DeltaIndex`` over the dense reduce and the k-NN graph
     (65,536 x 128) and the join (16,384 x 128) at P = 8, eight random
     updates of 1, 2 and 4 dirty blocks, each bit-equal to a from-scratch
     fold and sweeping |D|P - C(|D|, 2) tiles;
 22. fault-tolerant sweeps of the same workloads in every mode under a
     seeded kill every 2 rounds, and with every holder of a block killed
     (a restore from the checkpoint), each bit-equal to the fault-free run;
 23. observability: the comm predictor against the traced counters of a
     dense sweep (f32, bf16) and of a quantized gather (int8, bf16) at
     8,192 x 128 a block, every placement at P = 8 and P = 13, exactly;
     the feedback loop at P = 8 (device 2 slowed 4x: a smaller pair share,
     bit-exact output); ``python -m repro_torch.obs.report`` on the trace
     of a sweep on the card (exit 0);
 24. qwen3-14b (full config, 40 layers, 14,768,307,200 random bf16
     parameters from a seed) prefill of 1 x 32,768 tokens through
     ``build_prefill_step``, B9 launched once per layer, its share of the
     device time from torch.profiler; at 2 layers of the same widths the
     B9 route against the plain attention at T = 4,096 and 4,000, and
     decode == prefill at 1,024 tokens;
 25. qwen3-14b serving: ``serve()`` at batch 4, prompt 16, 32 generated
     tokens (no B9 launch: decode attention is a plain product);
 26. jamba-v0.1-52b at full width, depth cut from 32 to 16 layers (its
     bf16 parameters do not fit the card), prefill of 1 x 32,768 tokens
     (B9 in its 2 attention layers, B10 in its 14 Mamba layers, MoE in
     every other layer), a profiled second prefill split into B9, B10,
     GEMMs, the sort / scan / index kernels of the MoE dispatch and the
     rest; B10 on layer 0's real inputs and B9 on the attention layer's
     real q / k / v against their plain versions; one MoE layer on 4,096
     real rows against the port's plain path on the CPU (routing exact
     outside the router's tie margin); decode == prefill at 1,024 tokens
     at one superblock with the capacity raised so nothing drops;
 27. jamba serving: ``serve()``'s loop (``lm.init_decode_state``,
     ``build_serve_step``) on the 16-layer config at batch 4, prompt 16,
     32 generated tokens, 14 B10 launches a step;
 28. llama4-scout at full width and 2 layers (top-1 + shared expert):
     prefill of 1 x 32,768 tokens, decode == prefill at 1,024;
 29. whisper-large-v3 in full: ``build_prefill_step`` on 8 x 1,500 frames
     and 187 decoder tokens (B9 64 times: 32 full, 32 causal), 32 decode
     steps against the cached cross K / V, B9 on the encoder's layer-0
     q / k / v against the plain attention, decode == the teacher-forced
     forward at 2 + 2 layers;
 30. qwen2-vl-72b at full width and 2 layers: 1,024 vision embeddings +
     31,744 text tokens through M-RoPE and B9, and the B9 route against
     the plain attention at T = 4,096;
 31. B9's backward (bf16 ``wgmma`` route ``csrc/flash_attention_bwd_tc.cu``,
     f32 and hd 256 on the TF32 ``csrc/flash_attention_bwd.cu``) against
     its plain version (``kernels/ref.py``, f32) at starcoder2-3b's
     training shape q [2, 4096, 24, 128], k / v [2, 4096, 2, 128] causal in
     bf16 and f32, whisper's encoder shape [8, 1500, 20, 64] full and an
     hd 256 cell, each gradient within its rule (f32 1e-4 max(1, max
     |want|), bf16 2^-6 |want| + 2^-8 max |want|), bit-equal across two
     launches, the forward's o with lse bit-equal to it without, timed
     beside scaled_dot_product_attention's backward (route, ms, issued and
     counted TFLOP/s, share of the bound);
 32. starcoder2-3b training at full width and depth (3,180,705,792 random
     bf16 parameters, AdamW in f32): ``build_train_step`` on train_4k with
     the global batch cut from 256 to 4 (2 microbatches of 2 x 4,096
     tokens from ``data/pipeline.py``, remat on), a warm-up step and 3
     timed steps (B9 forward 120 and backward 60 launches a step), a
     profiled step split by kernel family, AdamW alone; (a) at 2 layers
     the loss and every gradient through B9 against the plain attention;
 33. B10's backward (``csrc/ssd_chunk_bwd.cu``) against its plain version
     (``kernels/ref.py``, f32) with fixed random cotangents from a seed, at
     mamba2-130m's training shape (layer 0's real inputs on a train_4k
     microbatch, x [8, 4096, 24, 64], N 128, chunk 256) and on jamba-v0.1's
     layer 0 at full width (x [1, 4096, 128, 64], N 16, from 4,096 prompt
     tokens through its projection and convolution), both at real dt
     spans and also against a float64 gradient (the kernel's error at most
     twice the plain f32 version's), and on a dyadic cell with dt * A > 0;
     each gradient within 1e-4 max(1, max |want|), bit-equal across two
     launches, timed beside the plain version (no PyTorch call computes
     this gradient), with its device time by kernel and the operations
     the kernels issue against those counted; jamba's layer-0
     ``mamba_block`` forward and backward (its input and parameters)
     through B10 and its backward against the plain step's autograd;
 34. mamba2-130m training at full width and depth (128,983,488 random bf16
     parameters, AdamW in f32): ``build_train_step`` on train_4k with the
     global batch cut from 256 to 16 (2 microbatches of 8 x 4,096 tokens,
     remat on), a warm-up step and 3 timed steps (B10 forward 96 and
     backward 48 launches a step), a profiled step split by kernel family;
     (a) at 2 layers the loss and every gradient through B10 and its
     backward against the plain intra-chunk step and its autograd;
 35. the dry run (``launch/dryrun.py``) against the card: (a) ``--all`` on
     both production meshes (66 records, no error) leaves the card's
     allocator untouched, and in a fresh process leaves CUDA
     uninitialised; (b) on a one-device mesh at phases 32, 34 and 24's cut
     shapes, its predicted bytes of starcoder2-3b's and mamba2-130m's
     parameters and AdamW moments and qwen3-14b's parameters equal the
     bytes those tensors asked the allocator for; ``memory_allocated``
     rose by the blocks the allocator's snapshot gives those tensors, each
     the tensor rounded up to 512 bytes plus, in the large pool, an
     unsplit tail of at most 1 MiB; (c) model
     flops over each measured step as TFLOP/s and a share of the dense
     bf16 peak;
 36. the distributed backend on the card: 8 spawned ranks, each a process
     on cuda:0 with ``DistributedComm`` over gloo, every shift staged
     through pinned host memory (NCCL refuses two ranks on one card; gloo
     carries no CUDA tensor through send / recv), run the engine
     selfcheck at P = 8 (every mode), n-body at N = 65,536 (quorum with
     B1, and atom), PCIT at 8,192 x 512 (B2, B3) and bf16 quorum / ring
     attention at phase 17's widths and inputs (B9); each rank's rows
     bit-equal to this process's single-process run of the same inputs,
     its traced bytes equal to the predictor's, its resident quorum input
     bytes k/P of the atom's, B1, B2, B3 and B9 launched in every rank;
     per-rank wall times and ``max_memory_allocated``, labelled "gloo,
     host-staged, one card";
 37. the serving, join and k-NN paths under the distributed backend: 8
     spawned ranks as in phase 36, the corpora on the host, each rank's
     own blocks on the card: serving on phase 8's 1,000,000 x 128 corpus
     (4 microbatches of 256 l2 top-10 queries through B4, phase 8's range
     query escalated from capacity 16, a block replace), int8 serving of
     it (before and after the replace), the batcher with rank 0 as the
     front end and ranks 1-7 following its broadcast launches (4
     microbatches with a stream update, a heterogeneous pack with
     escalations, a partial result under a stepping clock), the join
     (B5) of phase 9's 262,144 x 128 corpus and the k-NN graph (B6) of
     its first 131,072 rows, and their int8 and bf16 paths (B7, B8); the
     parent runs the same calls
     on one process and every rank's rows equal its share of them (its
     block's k-NN rows, the pairs its device owns, the same answers
     otherwise), bit for bit except the quantized paths' rescored
     scores, which may differ within 1e-5; traced bytes equal the
     predictor's on every rank, B4-B8 launched in every rank; per rank
     and path: wall time, peak memory, and the resident bytes (serving
     state, quantized stacks, sweep quorums) against one process's (1/P);
 38. the LM train and prefill steps on a mesh of ranks (qwen3-14b at 2
     layers on 4 ranks, mamba2-130m at 12 layers on 8), every rank's
     warm-up step and prefill held to one process's;
 39. the decode step on a mesh of ranks (qwen3-14b x2 at B 1 over a
     32,768-slot cache on 4 ranks, mamba2-130m through serve() at B 128
     on 8), every rank's logits held to one process's;
 40. the quantized join (262,144 x 960, gist-960-euclidean's width) and
     k-NN graph (its first 131,072 rows) in bf16 and int8 through B7 /
     B8 on the tensor cores, held to B5's join and B6's graph of the same
     rows; B7 / B8 there and on int8 rows of 1,536 on both routes,
     beside GEMM-only library calls and the bound;
  then a JSON line of every kernel (launches on the main path, error
  against the plain version, times, bound), the nvidia-smi line, and the
  result line ``{"ok": true, "device": {...}}`` last.

Kernel launch counts are set to 0 just before each main path (n-body,
PCIT, serving, join, k-NN graph, quantized join, quantized k-NN, quorum
attention, mamba2 prefill and serving, the batching drain, qwen3-14b
prefill and serving, jamba prefill and serving, llama4-scout, whisper
and qwen2-vl prefill, the starcoder2-3b and mamba2-130m train steps) is
driven and read just after it, so comparison launches do not count;
phase 36's and 37's ranks do the same in each rank and report them as
``dist_launches`` (the fewest over the ranks; phase 37 also ``dist_ms``,
the slowest rank's wall time on the kernel's paths).
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
P = 8
NBODY_N = 65536          # 8,192 bodies per block
NBODY_STEPS = 3
PCIT_N, PCIT_G = 8192, 512
PCIT_RANK = 16           # latent factors of the synthetic expression data
# published H100 SXM peaks (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12  # TF32 tensor cores, dense
PEAK_INT8_OPS = 1979e12  # int8 tensor cores, dense
PEAK_BYTES = 3.35e12     # HBM3
# fp32 operations per body pair of the n-body step (difference 3, r^2 6,
# rsqrt and its cube 3, mass product 2, force 3, row sum 3), plus 3 for the
# column sum where both sides of a tile are needed
NBODY_OPS, NBODY_OPS_BOTH = 20, 23
# fp32 operations per visited (x, y, z) trio of the PCIT filter (squares,
# three denominators with their sqrt, three partial correlations, the eps
# mean with its three divisions, two products, abs and compares)
PCIT_OPS = 36
BOUNDARY_TOL = 1e-6
# serving: the base-set shape of ANN-Benchmarks' sift-128-euclidean
SERVE_N, SERVE_D, SERVE_CLUSTERS = 1_000_000, 128, 1000
SERVE_Q, SERVE_BATCHES, SERVE_TOPK = 256, 40, 10
SERVE_BIG_TOPK, SERVE_BIG_BATCHES, SERVE_AFTER_BATCHES = 100, 4, 4
SERVE_HELD = (0, 13, 26, 39)         # microbatches held against brute force
REPLACED_BLOCK = 3
THR_Q, THR_HITS, THR_CAP0 = 64, 100, 16
# the similarity join: block 32,768 at P = 8
JOIN_N, JOIN_D, JOIN_CLUSTERS = 262_144, 128, 256
JOIN_HITS, JOIN_CAP0, JOIN_SAMPLE = 100_000, 8192, 16384
CLUSTER_SPREAD = 0.3
# the k-NN graph of the join's corpus, and quantized serving microbatches
# before and after the block replace
KNN_TOPK, QSERVE_BATCHES = 10, 4
QUANT_CAP = 1 << 20      # B7's per-device buffer at the join's shape
# B7 / B8 at wide rows (phase 10): bf16 widths held against float64 and
# the plain version, and an int8 width past the float32-exact 1,040
WIDE_BF16_D, WIDE_INT8_D = (128, 256, 960, 1040, 4096), 1536
# phase 40: the quantized join and k-NN graph at gist-960-euclidean's width
# (ANN-Benchmarks: 1,000,000 x 960, l2; synthetic clustered rows), the
# join's N cut as phase 9's, the graph's to its first half (its M doubling
# reaches lists of 512 at this width, and at 262,144 rows their merges ran
# the card out of memory); B7 / B8 also timed on int8 rows at WIDE_INT8_D
# (1,536-wide embeddings) over WIDE_INT8_N rows
WIDE_N, WIDE_D, WIDE_SEED, WIDE_INT8_N = JOIN_N, 960, 40, 65_536
WIDE_KNN_N = WIDE_N // 2
WIDE_CHECK_CAP = 1 << 24   # B7's buffer when device 0's band is checked
# quorum / ring sequence-parallel attention at qwen3-14b's attention widths
# (H = 40, KV = 8, head_dim = 128) and the prefill_32k length, batch cut
# from 32 to 1; ATTN_SAMPLE first and last rows of each block are held
# against the plain f32 attention
ATTN_B, ATTN_T, ATTN_H, ATTN_KV, ATTN_HD = 1, 32_768, 40, 8, 128
ATTN_SAMPLE = 256
# B9's tolerances.  Its partials (o, m, l) are f32 from the same widened
# inputs in either dtype: FLASH_PART_TOL.  An attention output is held
# element by element to |got - want| <= rel * |want| + FLASH_ATOL, with
# rel = 2^-7 for a bf16 output (one bf16 ulp of |want|: a bf16 rounding of
# the f32 value, or two roundings one ulp apart) and 0 for an f32 one.
FLASH_PART_TOL, FLASH_ATOL, BF16_REL = 1e-5, 1e-5, 2.0 ** -7
# mamba2-130m: prefill_32k with the batch cut from 32 to 4; decode checked
# against prefill at SSM_CHECK_T tokens; serving at the defaults of the
# JAX package's serve() (batch 4, prompt 16, 32 generated tokens)
SSM_PREFILL_B, SSM_PREFILL_T, SSM_CHECK_T = 4, 32_768, 1024
SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK = 24, 64, 128, 256
# B10's L = 1 launch (a decode step's shape) is timed over DECODE_REPS
# launches queued behind a spin kernel of SPIN_CYCLES (about 0.1 s), so
# the events time the card's work and not the host's launch rate
DECODE_REPS, SPIN_CYCLES = 200, 200_000_000
SERVE_LM_BATCH, SERVE_LM_PROMPT, SERVE_LM_GEN = 4, 16, 32
# qwen3-14b at full width and depth (40 layers, 14,768,307,200 random bf16
# parameters from a seed; the count the JAX package's count_params gives),
# prefill_32k with the batch cut from 32 to 1; its checks at QWEN_CHECK_LAYERS
# layers of the same widths: the B9 route against the plain attention at
# QWEN_CHECK_T (one of them ragged), and decode == prefill at
# QWEN_DECODE_T tokens; serving at the JAX package's serve() defaults
QWEN_PARAMS, QWEN_B, QWEN_T = 14_768_307_200, 1, 32_768
QWEN_CHECK_LAYERS, QWEN_CHECK_T, QWEN_DECODE_T = 2, (4096, 4000), 1024
# B9 on the prefill's layer-0 q / k / v is checked on the first, middle
# and last QWEN_SAMPLE query rows
QWEN_SAMPLE = 256
# jamba-v0.1-52b at full width, its depth cut from 32 to JAMBA_LAYERS layers
# (2 of 4 superblocks: the full model's 51,460,000,640 bf16 parameters,
# 95.85 GiB, do not fit the card) and prefill_32k's batch from 32 to
# JAMBA_B; one MoE layer held against the CPU on JAMBA_MOE_ROWS rows, and
# decode == prefill at JAMBA_DECODE_T tokens.  The counts are the JAX
# package's count_params.  Router ties: k-th and (k+1)-th probabilities
# within MOE_TIE * max(1, p) may route otherwise on the two devices.
JAMBA_FULL_PARAMS, JAMBA_PARAMS = 51_460_000_640, 25_998_437_824
JAMBA_LAYERS, JAMBA_B, JAMBA_T = 16, 1, 32_768
JAMBA_MOE_ROWS, JAMBA_DECODE_T, MOE_TIE = 4096, 1024, 1e-5
# llama4-scout at full width, 2 of its 48 layers (top-1 routing with the
# shared expert); llama4-maverick runs in the CPU tests only (its 128
# experts take 32 GiB a layer)
LLAMA4_LAYERS, LLAMA4_PARAMS = 2, 6_473_180_160
LLAMA4_T, LLAMA4_DECODE_T = 32_768, 1024
# whisper-large-v3 in full: 8 x 1,500 frames (its 30 s window), 187 decoder
# tokens (dec_ratio 8), then WHISPER_DEC_STEPS decode steps
WHISPER_PARAMS, WHISPER_B, WHISPER_FRAMES = 1_534_809_600, 8, 1500
WHISPER_DEC_STEPS = 32
# qwen2-vl-72b at full width, 2 of its 80 layers: 1,024 vision embeddings
# + 31,744 text tokens; the B9 route against the plain attention at
# QWEN2VL_CHECK_T positions
QWEN2VL_LAYERS, QWEN2VL_PARAMS = 2, 4_246_773_760
QWEN2VL_T, QWEN2VL_CHECK_T = 32_768, 4096
# the observability phase: dense and quantized comm checks at the churn
# phases' block size (N = 65,536 x 128 at P = 8) and P = 13
OBS_BLOCK, OBS_DIM, OBS_P = 8192, 128, (8, 13)
# the continuous batcher over phase 8's corpus: microbatches of SERVE_Q
# requests, a stream update every BATCH_STREAM_EVERY microbatches, the
# background loop with BATCH_ASYNC requests
BATCH_STREAM_EVERY, BATCH_ASYNC = 10, 1024
BATCH_TOPKS = (1, 2, 3, 5, 8, 10, 13, 20, 32, 50, 64, 100)
# churn and the fault-tolerant sweep: the dense reduce and the k-NN graph
# at N = 65,536 x 128, the join at 16,384 x 128 (its constructor forms all
# N(N-1)/2 scores to place its threshold), P = 8, cyclic
CHURN_N, CHURN_JOIN_N, CHURN_D = 65_536, 16_384, 128
CHURN_DIRTY = (1, 2, 4, 1, 2, 4, 1, 2)      # dirty blocks per update
CKPT_BUDGET = 1 << 30                       # npz bytes a sweep may write
# scores within SCORE_TOL * max(1, |s|) of each other (or of the k-th
# score, or of the threshold) may order differently between the kernels'
# fp32 accumulation and cuBLAS's
SCORE_TOL = 1e-5
# static SASS instructions (and MUFU among them) of B3's one-trio probes,
# filled in by check_sass
SASS_COUNTS: dict = {}


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = DECODE_REPS) -> tuple[float, float, float]:
    """Device ms per call of ``fn`` with ``reps`` calls queued behind a
    spin kernel: the host enqueues them while the card spins, so the
    events around them time the card's back-to-back work, not the host's
    launch rate.  Returns (device ms per call, host ms per call to enqueue,
    the spin's ms); fails if the host did not finish enqueuing within the
    spin."""
    fn()
    torch.cuda.synchronize()
    spin0, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    spin0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    spin_ms = spin0.elapsed_time(start)
    check(host_ms < spin_ms, f"queued timing: the host took {host_ms:.1f} ms "
          f"to enqueue {reps} calls, longer than the {spin_ms:.1f} ms spin")
    return start.elapsed_time(end) / reps, host_ms / reps, spin_ms


def bound(nbytes: float, ops: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over
    the memory rate and operations over their type's peak (fp32 unless
    given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_split(fn, calls: int = 3) -> str:
    """Mean device ms of each kernel that ``calls`` calls of ``fn`` launch,
    from torch.profiler (CUPTI), as "name ms (xN captured), ..." in launch
    order; N tells how many of the launches the trace kept.  Late in a
    run, after many traces in one process, the profiler was seen to miss
    the kernels launched just after it starts, so the host waits a moment
    before the first call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if "kernel" not in e.key or e.key.startswith("cuda") \
                or e.device_time_total <= 0:
            continue
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.removeprefix("void ").split("::")[-1]
        parts.append(f"{name} {e.device_time_total / e.count / 1e3:.3f} ms "
                     f"(x{e.count})")
    return ", ".join(parts) or "not measured"


def hot_tiles(got, tile: int = 128) -> int:
    """Distinct (device, 128-row strip, 128-column tile) holding an entry
    of compacted buffers that hold every entry (count <= capacity)."""
    n = 0
    for p in range(P):
        c = int(got[3][p])
        i, j = got[1][p, :c].long() // tile, got[2][p, :c].long() // tile
        n += torch.unique(i * (1 << 32) + j).numel()
    return n


def walked_tiles(meta, tile: int = 128) -> int:
    """The 128 x 128 tiles B5's / B7's count pass walks: every tile of an
    active pair's valid rows, a self pair's from its diagonal on."""
    n = 0
    for a, s_, _ga, _gb, nv_lo, nv_hi in meta.reshape(-1, 6).tolist():
        if a:
            rs, cs_ = -(-nv_lo // tile), -(-nv_hi // tile)
            n += sum(cs_ - r for r in range(rs)) if s_ else rs * cs_
    return n


def sass_functions(lib: Path) -> dict:
    """{mangled kernel name: its SASS text} of the built library, from the
    toolkit's ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = body
    return funcs


# a float atomic in SASS: ATOM / ATOMS / ATOMG / RED on an F16 / F32 / F64
FLOAT_ATOMIC = re.compile(r"\b(?:ATOMG?|ATOMS|RED)\.[A-Z0-9_.]*F(?:16|32|64)")
# any atomic opcode (not the barrier reduction BAR.RED of __syncthreads_or)
ANY_ATOMIC = re.compile(r"(?<![\w.])(?:ATOMG?|ATOMS|RED)\.[A-Z0-9_.]*")


def check_sass(lib: Path) -> None:
    """The bf16 B9 kernel and its backward's tensor-core kernel run on the
    tensor cores (every instantiation issues HGMMA, the SASS of
    ``wgmma``); B7's and B8's tensor-core routes issue IMMA (int8) and HMMA
    (bf16), the SASS of ``mma.sync``; B2, B5 and B7 issue no atomics, and
    B3, B4, B6, B8 and B9's and B10's backward no float atomics."""
    funcs = sass_functions(lib)
    tc = {n: f.count("HGMMA") for n, f in funcs.items()
          if "flash_tc_kernel" in n}
    check(len(tc) == 3 and all(c > 0 for c in tc.values()),
          f"B9 bf16: HGMMA counts per instantiation {sorted(tc.values())}")
    # B9's backward: bwd_tc_kernel<64 | 128> on wgmma; it, its prologue
    # and slice sum (flash_attention_bwd_tc.cu) and the TF32 pair
    # (flash_attention_bwd.cu; the anonymous namespace puts the file's
    # name in every kernel's) issue no float atomic (the dQ chain passes
    # an integer counter)
    bwd_tc = {n: f.count("HGMMA") for n, f in funcs.items()
              if "bwd_tc_kernel" in n}
    check(len(bwd_tc) == 2 and all(c > 0 for c in bwd_tc.values()),
          f"B9 backward bf16: HGMMA counts per instantiation "
          f"{sorted(bwd_tc.values())}")
    bwd = {n: f for n, f in funcs.items() if "flash_attention_bwd" in n}
    bwd_float = sum(len(FLOAT_ATOMIC.findall(f)) for f in bwd.values())
    check(len(bwd) >= 6 and bwd_float == 0,
          f"B9 backward: {len(bwd)} kernels, {bwd_float} float atomics: "
          f"{sorted(bwd)}")
    # B9's float32 routes on the TF32 tensor cores: flash_tf32_wg_kernel<64
    # | 128> issues TF32 HGMMA (wgmma), flash_tf32_kernel<256> and dq_ /
    # dkv_tf32_kernel<64 | 128 | 256, float | bf16> TF32 HMMA (mma.sync
    # m16n8k8); none a float atomic
    tf32 = {n: (sum(".TF32" in ln for ln in f.splitlines()
                    if "HMMA" in ln or "HGMMA" in ln),
                len(FLOAT_ATOMIC.findall(f)))
            for n, f in funcs.items()
            if re.search(r"flash_tf32_(wg_)?kernel|d(q|kv)_tf32_kernel", n)}
    tf32_fwd = sorted(c for n, (c, _a) in tf32.items()
                      if "flash_tf32_" in n)
    tf32_bwd = sorted(c for n, (c, _a) in tf32.items()
                      if "flash_tf32_" not in n)
    tf32_float = sum(a for _c, a in tf32.values())
    check(len(tf32_fwd) == 3 and len(tf32_bwd) == 12
          and all(c > 0 for c in tf32_fwd + tf32_bwd) and tf32_float == 0,
          f"B9 f32 (tf32x3): TF32 HMMA counts per instantiation, forward "
          f"{tf32_fwd}, backward {tf32_bwd}; {tf32_float} float atomics")
    # B10's backward (ssd_chunk_bwd.cu: ssd_bwd_cb_kernel<vec> x 2,
    # ssd_bwd_dx_kernel<64 | 128, vec> x 4, ssd_bwd_g_kernel<vec> x 2,
    # ssd_bwd_bc_kernel<CL, KS, vec> x 8 and ssd_bwd_sum_kernel): no float
    # atomics (dA leaves as partials; the dCB and dB partials sum in order)
    b10b = {n: f for n, f in funcs.items() if "ssd_chunk_bwd" in n}
    b10b_float = sum(len(FLOAT_ATOMIC.findall(f)) for f in b10b.values())
    b10b_any = sum(len(ANY_ATOMIC.findall(f)) for f in b10b.values())
    kinds = {k: sum(k in n for n in b10b)
             for k in ("ssd_bwd_cb_kernel", "ssd_bwd_dx_kernel",
                       "ssd_bwd_g_kernel", "ssd_bwd_bc_kernel",
                       "ssd_bwd_sum_kernel")}
    check(len(b10b) == 17 and list(kinds.values()) == [2, 4, 2, 8, 1]
          and b10b_float == 0,
          f"B10 backward: {len(b10b)} kernels {kinds}, {b10b_float} float "
          f"atomics: {sorted(b10b)}")
    # B2: the 16-byte-copy and the plain-load instantiations
    corr = [f for n, f in funcs.items() if "corr_kernel" in n]
    atomics = sum(f.count("ATOM") + f.count("RED.") for f in corr)
    check(len(corr) == 2 and atomics == 0,
          f"B2: {len(corr)} kernels, {atomics} atomic instructions")
    # B8 (topk_tc_kernel<int8_t | __nv_bfloat16, vec, resident rows, long
    # lists>): eight instantiations of each
    b8 = {n: f for n, f in funcs.items() if "topk_tc_kernel" in n}
    imma = [f.count("IMMA") for n, f in b8.items() if "topk_tc_kernelIa" in n]
    hmma = [f.count("HMMA") for n, f in b8.items()
            if "topk_tc_kernelI13__nv_bfloat16" in n]
    check(len(imma) == 8 and all(c > 0 for c in imma),
          f"B8 int8: IMMA counts per instantiation {imma}")
    check(len(hmma) == 8 and all(c > 0 for c in hmma),
          f"B8 bf16: HMMA counts per instantiation {hmma}")
    # B7 (band_tc_kernel<int8_t | __nv_bfloat16, vec, resident rows,
    # write pass>): eight instantiations of each
    b7 = {n: f for n, f in funcs.items() if "band_tc_kernel" in n}
    imma7 = [f.count("IMMA") for n, f in b7.items() if "band_tc_kernelIa" in n]
    hmma7 = [f.count("HMMA") for n, f in b7.items()
             if "band_tc_kernelI13__nv_bfloat16" in n]
    check(len(imma7) == 8 and all(c > 0 for c in imma7),
          f"B7 int8: IMMA counts per instantiation {imma7}")
    check(len(hmma7) == 8 and all(c > 0 for c in hmma7),
          f"B7 bf16: HMMA counts per instantiation {hmma7}")
    # B4 (score_kernel x 2, merge_kernel of query_topk.cu) and B8
    sel = {n: f for n, f in funcs.items()
           if "query_topk" in n or "topk_tc_kernel" in n}
    f_atomics = sum(len(FLOAT_ATOMIC.findall(f)) for f in sel.values())
    check(len(sel) == 19 and f_atomics == 0,
          f"B4 / B8: {len(sel)} kernels, {f_atomics} float atomics")
    # B5 (tile_kernel x 4, norm_kernel) and B7 (band_tc_kernel x 16,
    # band_simt_kernel x 4) with compact.cuh's scan: no atomic of any kind
    # (no float atomic, and no atomic output cursor)
    thr = {n: f for n, f in funcs.items()
           if "pairwise_threshold" in n or "compact11scan_kernel" in n
           or "row_norms" in n}
    found = sorted({a for f in thr.values() for a in ANY_ATOMIC.findall(f)})
    thr_atomics = sum(len(ANY_ATOMIC.findall(f)) for f in thr.values())
    thr_float = sum(len(FLOAT_ATOMIC.findall(f)) for f in thr.values())
    check(len(thr) >= 25 and thr_atomics == 0 and thr_float == 0,
          f"B5 / B7: {len(thr)} kernels, {thr_atomics} atomics "
          f"({thr_float} float): {found}")
    # B3 (pcit_kernel<prefilter, stats> x 4, the two trio probes) and B6
    # (topk_kernel<vec, long lists, score only> x 6, with row_norms.cuh's
    # norm pass and pair_tile.cuh's order pass in its source): integer
    # atomics only (the shared pair counter and queue slots, B3's stats)
    b3 = {n: f for n, f in funcs.items()
          if "pcit_kernel" in n or "_probe" in n}
    b6 = {n: f for n, f in funcs.items()
          if "11topk_kernelI" in n
          or ("pairwise_topk_cu" in n and "pairwise_topk_q_cu" not in n)}
    b36_float = sum(len(FLOAT_ATOMIC.findall(f))
                    for f in list(b3.values()) + list(b6.values()))
    check(len(b3) == 6 and len([n for n in b6 if "11topk_kernelI" in n]) == 6
          and b36_float == 0,
          f"B3 / B6: {len(b3)} / {len(b6)} kernels, {b36_float} float "
          f"atomics: {sorted(b3)} {sorted(b6)}")
    sass_ops = {}
    for kind in ("exact_probe", "prefilter_probe"):
        body = next(f for n, f in funcs.items() if kind in n)
        ins = [ln for ln in body.splitlines()
               if re.match(r"\s*/\*[0-9a-f]{4}\*/\s+\S", ln)
               and " NOP" not in ln]
        sass_ops[kind] = (len(ins), sum("MUFU" in ln for ln in ins))
    SASS_COUNTS.update(sass_ops)
    say(f"SASS: B3 ({len(b3)} kernels) and B6 ({len(b6)} kernels) float "
        f"atomics {b36_float}; one trio, static SASS instructions (MUFU) "
        f"with its three loads, hoists and store: exact chain "
        f"{sass_ops['exact_probe'][0]} ({sass_ops['exact_probe'][1]}), "
        f"prefilter {sass_ops['prefilter_probe'][0]} "
        f"({sass_ops['prefilter_probe'][1]})")
    say(f"SASS: bf16 B9 (flash_tc_kernel, hd padded to 64 / 128 / 256) "
        f"HGMMA instructions {sorted(tc.values())}; f32 B9 "
        f"(flash_tf32_wg_kernel<64 | 128> HGMMA, flash_tf32_kernel<256> "
        f"HMMA) TF32 {tf32_fwd}, its backward pair "
        f"(dq_ / dkv_tf32_kernel, f32 and bf16) TF32 HMMA {tf32_bwd}, float "
        f"atomics {tf32_float}; B9 backward "
        f"(bwd_tc_kernel, hd padded to 64 / 128) HGMMA "
        f"{sorted(bwd_tc.values())}, float atomics {bwd_float} in its "
        f"{len(bwd)} kernels; B10 backward ({len(b10b)} kernels) float "
        f"atomics {b10b_float}, atomics of any kind {b10b_any}; B2 "
        f"(corr_kernel, two "
        f"instantiations) atomics {atomics}; B8 (topk_tc_kernel) IMMA "
        f"{imma} int8, HMMA {hmma} bf16; B4 / B8 ({len(sel)} kernels) float "
        f"atomics {f_atomics}; B7 (band_tc_kernel) IMMA {imma7} int8, HMMA "
        f"{hmma7} bf16; B5 / B7 ({len(thr)} kernels with the scan) atomics "
        f"{thr_atomics}, float atomics {thr_float}")


def make_bodies(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(n, 3)),
                           rng.uniform(0.5, 2, (n, 1))], -1).astype(np.float32)


def make_expression(n: int, g: int, rank: int, seed: int) -> np.ndarray:
    """Synthetic co-expression data: genes driven by a few latent factors
    plus noise (the shape of the repo's PCIT examples, at scale)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, rank)) @ rng.normal(size=(rank, g))
    return (X + 0.5 * rng.normal(size=(n, g))).astype(np.float32)


def pcit_margin(rxy, rx, ry, gx, gy) -> float:
    """Distance of one (x, y) decision from its boundary: the least
    |max(|r_xy| - |eps r_xz|, |r_xy| - |eps r_yz|)| over the valid z, in
    float64."""
    rxy, rx, ry = float(rxy), rx.double(), ry.double()
    eps_ = 1e-12
    den_z = torch.sqrt(torch.clamp((1 - rx ** 2) * (1 - ry ** 2), min=eps_))
    den_y = torch.sqrt(torch.clamp((1 - rxy ** 2) * (1 - ry ** 2), min=eps_))
    den_x = torch.sqrt(torch.clamp((1 - rxy ** 2) * (1 - rx ** 2), min=eps_))
    e = ((rxy - rx * ry) / den_z / (rxy + eps_)
         + (rx - rxy * ry) / den_y / (rx + eps_)
         + (ry - rxy * rx) / den_x / (ry + eps_)) / 3.0
    m = torch.maximum(abs(rxy) - (e * rx).abs(), abs(rxy) - (e * ry).abs())
    z = torch.arange(rx.numel(), device=rx.device)
    valid = (z != int(gx)) & (z != int(gy))
    return float(m[valid].abs().min())


def compare_keep(got, want, r_xy, rows_x, rows_y, gx, gy, what: str) -> int:
    """Keep masks must agree, except entries within BOUNDARY_TOL of their
    decision boundary; returns the number of differing entries."""
    diff = torch.nonzero(got != want)
    for b, x, y in diff.tolist():
        m = pcit_margin(r_xy[b, x, y], rows_x[b, x], rows_y[b, y],
                        gx[b, x], gy[b, y])
        check(m <= BOUNDARY_TOL,
              f"{what}: keep differs at {(b, x, y)}, {m:.3e} from the "
              f"boundary")
    return len(diff)


def plain_pcit_chunked(r_xy, rows_x, rows_y, gx, gy, rows: int = 16):
    """The plain filter over [B, M, N] tiles, called on row slices so the
    [rows, N, Z] intermediates fit in memory."""
    from repro_torch.kernels.ref import pcit_filter
    out = torch.empty(r_xy.shape, dtype=torch.bool, device=r_xy.device)
    for b in range(r_xy.shape[0]):
        for r0 in range(0, r_xy.shape[1], rows):
            sl = slice(r0, r0 + rows)
            out[b, sl] = pcit_filter(r_xy[b, sl], rows_x[b, sl], rows_y[b],
                                     gx[b, sl], gy[b])
    return out


def pcit_tile_inputs(C, sched, block):
    """The batched mode's B3 operands for every (device, pair) tile of the
    correlation matrix C [N, N]: r_xy [B, bm, bn], rows_x [B, bm, N],
    rows_y [B, bn, N], gx / gy [B, block]."""
    ids = torch.arange(block, device=C.device)
    rx, ry, rxy, gxs, gys = [], [], [], [], []
    for i in range(sched.P):
        for lo, hi in sched.pair_slots.tolist():
            glo = (i + int(sched.shifts[lo])) % sched.P
            ghi = (i + int(sched.shifts[hi])) % sched.P
            rx.append(C[glo * block:(glo + 1) * block])
            ry.append(C[ghi * block:(ghi + 1) * block])
            rxy.append(C[glo * block:(glo + 1) * block,
                         ghi * block:(ghi + 1) * block])
            gxs.append(glo * block + ids)
            gys.append(ghi * block + ids)
    return (torch.stack(rxy), torch.stack(rx), torch.stack(ry),
            torch.stack(gxs).int(), torch.stack(gys).int())


def phase_kernels(report: dict) -> None:
    from repro_torch.apps.pcit import standardize
    from repro_torch.core.comm import SingleProcessComm, shard
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.sweep import pair_mask_table, quorum_gather
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pcit_filter import STATS, pcit_filter_cuda

    comm = SingleProcessComm(P, DEVICE)
    sched = build_schedule(P)
    lo, hi = sched.pair_slots[:, 0], sched.pair_slots[:, 1]
    mask = torch.as_tensor(pair_mask_table(sched), device=DEVICE)

    # ---- B1 at n-body's shape: quorum [P, k, 8192, 4] -------------------
    quorum = quorum_gather(shard(make_bodies(NBODY_N, 0), comm), sched, comm)
    wi = mask
    wj = torch.where(torch.as_tensor(sched.pair_diff == 0, device=DEVICE),
                     torch.zeros_like(mask), mask)
    got = ops.pairwise_batch_forces(quorum, lo, hi, wi, wj)
    want = ref.pairwise_batch_forces(quorum, lo, hi, wi, wj)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    check(torch.isfinite(got).all(), "B1: non-finite forces")
    check(rel < 1e-4, f"B1: max abs err / max |plain| = {rel:.3e} >= 1e-4")
    check(torch.equal(got, ops.pairwise_batch_forces(quorum, lo, hi, wi, wj)),
          "B1: two launches on the same inputs differ")
    ms = cuda_ms(lambda: ops.pairwise_batch_forces(quorum, lo, hi, wi, wj))
    split = kernel_split(lambda: ops.pairwise_batch_forces(quorum, lo, hi, wi,
                                                           wj))
    plain_ms = cuda_ms(lambda: ref.pairwise_batch_forces(quorum, lo, hi, wi,
                                                         wj), reps=2)
    block = quorum.shape[2]
    ops_needed = 0
    for p in range(P):
        for n in range(sched.n_pairs):
            a, b = float(wi[p, n]) != 0, float(wj[p, n]) != 0
            if a or b:
                ops_needed += block * block * (
                    NBODY_OPS_BOTH if a and b else NBODY_OPS)
    w = torch.stack([wi, wj], -1)
    b_ms, b_by = bound(nbytes(quorum, w, got) + 8 * sched.n_pairs, ops_needed)
    say(f"B1 pairwise_batch {tuple(quorum.shape)} x {sched.n_pairs} pairs: "
        f"max_abs_err={err:.3e} (rel {rel:.3e} < 1e-4), bit-equal across two "
        f"launches; kernel {ms:.3f} ms (by kernel, per launch: {split}), "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    report["pairwise_batch"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=None)
    del quorum, got, want

    # ---- B2 at PCIT's shape: [P*n_pairs, 1024, 512] tiles ---------------
    Xs = standardize(make_expression(PCIT_N, PCIT_G, PCIT_RANK, 1))
    xq = quorum_gather(shard(Xs, comm), sched, comm)
    lhs = xq[:, torch.as_tensor(lo, dtype=torch.long)].flatten(0, 1)
    rhs = xq[:, torch.as_tensor(hi, dtype=torch.long)].flatten(0, 1)
    got = ops.pairwise_corr(lhs, rhs)
    want = ref.pairwise_corr(lhs, rhs)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
          f"B2: not within rtol 1e-4 / atol 1e-5 (max abs err {err:.3e})")
    ms = cuda_ms(lambda: ops.pairwise_corr(lhs, rhs), reps=10)
    plain_ms = cuda_ms(lambda: ref.pairwise_corr(lhs, rhs), reps=10)
    lib_ms = cuda_ms(lambda: torch.bmm(lhs, rhs.transpose(1, 2)), reps=10)
    Bt, M, G = lhs.shape
    b_ms, b_by = bound(nbytes(lhs, rhs, got), 2.0 * Bt * M * rhs.shape[1] * G)
    say(f"B2 pairwise_corr {tuple(lhs.shape)} x {tuple(rhs.shape)} "
        f"(SIMT fp32, 128 x 128 tiles, 8 x 16 per thread, k slices of 32 "
        f"in a 3-stage cp.async ring): max_abs_err={err:.3e} kernel "
        f"{ms:.3f} ms ({2.0 * Bt * M * rhs.shape[1] * G / ms / 1e9:.1f} "
        f"TFLOP/s, {ms / lib_ms:.3f} x torch.bmm), plain {plain_ms:.3f} ms, "
        f"torch.bmm (TF32 off) {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    report["pairwise_corr"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=lib_ms)
    del xq, lhs, rhs, got, want

    # ---- B3 at PCIT's shape: every (device, pair) tile, Z = 8192 --------
    X_t = torch.as_tensor(Xs, device=DEVICE)
    C = X_t @ X_t.T
    r_xy, rows_x, rows_y, gx, gy = pcit_tile_inputs(C, sched, PCIT_N // P)
    visits = torch.empty(r_xy.shape, dtype=torch.int32, device=DEVICE)
    stats = torch.empty(len(STATS), dtype=torch.int64, device=DEVICE)
    got = pcit_filter_cuda(r_xy, rows_x, rows_y, gx, gy, visits=visits,
                           stats=stats)
    st = dict(zip(STATS, stats.tolist()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain_pcit_chunked(r_xy, rows_x, rows_y, gx, gy)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_diff = compare_keep(got, want, r_xy, rows_x, rows_y, gx, gy, "B3")
    ms = cuda_ms(lambda: ops.pcit_filter(r_xy, rows_x, rows_y, gx, gy),
                 reps=2)
    exact_ms = cuda_ms(lambda: pcit_filter_cuda(r_xy, rows_x, rows_y, gx, gy,
                                                prefilter=False), reps=2)
    trios = int(visits.long().sum())
    b_ms, b_by = bound(nbytes(r_xy, rows_x, rows_y, gx, gy, got),
                       float(trios) * PCIT_OPS)
    full = r_xy.numel() * rows_x.shape[-1]
    say(f"B3 pcit_filter {tuple(r_xy.shape)} x Z={rows_x.shape[-1]}: keep "
        f"differs at {n_diff} of {got.numel()} entries (all within "
        f"{BOUNDARY_TOL} of the boundary), kept {float(got.float().mean()):.4f};"
        f" visited {trios} of {full} trios; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (host clock, row chunks), bound {b_ms:.3f} ms "
        f"({b_by})")
    live = visits[visits > 0].double()
    sample = live[torch.randperm(live.numel(), device=DEVICE)[:1 << 24]]
    deciles = torch.quantile(sample, torch.linspace(
        0.1, 0.9, 9, device=DEVICE, dtype=torch.float64)).tolist()
    evaluated = st["prefilter_decided"] + st["exact_decided"]
    useful = trios / st["issued_lane_trios"]
    say(f"B3 search: deciles of visits (off the diagonal, a 2^24 sample) "
        f"{[int(q) for q in deciles]}; {st['issued_lane_trios']} lane-trios "
        f"issued, useful share {useful:.4f}; of {evaluated} trios evaluated "
        f"the prefilter decided {st['prefilter_decided'] / evaluated:.6f}, "
        f"the exact chain {st['exact_decided']}; exact chain on every trio "
        f"{exact_ms:.3f} ms; per trio, static SASS instructions (MUFU) of "
        f"the one-trio probes: exact {SASS_COUNTS.get('exact_probe')}, "
        f"prefilter {SASS_COUNTS.get('prefilter_probe')}")
    report["pcit_filter"] = dict(max_abs_err=float(n_diff > 0), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None,
                                 differing=n_diff, visited_trios=trios,
                                 exact_only_ms=exact_ms,
                                 useful_lane_share=useful)


def phase_selfcheck() -> None:
    from repro_torch.core import selfcheck
    for p in (2, 5, 8):
        selfcheck.main(p, device=DEVICE)


def phase_nbody(report: dict) -> None:
    from repro_torch.apps.nbody import distributed_forces, leapfrog_step
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import ops

    comm = SingleProcessComm(P, DEVICE)
    bodies = torch.as_tensor(make_bodies(NBODY_N, 2), device=DEVICE)
    vel = torch.zeros(NBODY_N, 3, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    state = bodies
    first = None
    for _ in range(NBODY_STEPS):
        t0 = time.perf_counter()
        forces = distributed_forces(state, comm, use_kernel=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = forces
        state, vel = leapfrog_step(state, vel, 1e-3, forces)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    report["pairwise_batch"]["launches"] = counts["pairwise_batch"]
    check(counts["pairwise_batch"] > 0, "n-body: B1 was never launched")
    check(first.shape == (NBODY_N, 3) and torch.isfinite(first).all(),
          "n-body: forces not finite or of the wrong shape")
    check(torch.isfinite(state).all() and torch.isfinite(vel).all(),
          "n-body: leapfrog state not finite")
    plain = distributed_forces(bodies, comm, mode="scan", use_kernel=False)
    rel = float((first - plain).abs().max() / plain.abs().max())
    check(rel < 1e-4, f"n-body: kernel path vs plain scan path rel err "
          f"{rel:.3e} >= 1e-4")
    say(f"nbody N={NBODY_N} P={P}: force evaluation "
        f"{', '.join(f'{t:.2f}' for t in times)} ms (host clock, "
        f"synchronized), peak {peak / 2**30:.3f} GiB, B1 launches "
        f"{counts['pairwise_batch']} over {NBODY_STEPS} evaluations, "
        f"vs plain scan path rel err {rel:.3e}")


def phase_pcit(report: dict) -> None:
    from repro_torch.apps.pcit import (correlation_reference, pcit_reference,
                                       run_quorum_pcit, standardize)
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import ops

    comm = SingleProcessComm(P, DEVICE)
    X = make_expression(PCIT_N, PCIT_G, PCIT_RANK, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    corr, keep = run_quorum_pcit(X, comm, use_kernels=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    report["pairwise_corr"]["launches"] = counts["pairwise_corr"]
    report["pcit_filter"]["launches"] = counts["pcit_filter"]
    check(counts["pairwise_corr"] > 0 and counts["pcit_filter"] > 0,
          f"PCIT: kernels not launched on the main path: {counts}")
    check(corr.shape == (PCIT_N, PCIT_N) and keep.shape == (PCIT_N, PCIT_N),
          "PCIT: wrong output shapes")
    check(torch.isfinite(corr).all(), "PCIT: non-finite correlations")
    Xs = torch.as_tensor(standardize(X), device=DEVICE)
    C = Xs @ Xs.T
    err = float((corr - C).abs().max())
    check(torch.allclose(corr, C, rtol=1e-4, atol=1e-5),
          f"PCIT: corr vs Xs @ Xs.T max abs err {err:.3e}")
    del C
    # sampled keep tiles (a diagonal one and two off-diagonal ones) against
    # the plain filter on the pipeline's own correlation rows
    block = PCIT_N // P
    ids = torch.arange(block, device=DEVICE)
    n_diff = 0
    for xb, yb in [(0, 0), (1, P - 2), (P - 1, P // 2 - 1)]:
        xs = slice(xb * block, (xb + 1) * block)
        ys = slice(yb * block, (yb + 1) * block)
        args = (corr[None, xs, ys].contiguous(), corr[None, xs], corr[None, ys],
                (xb * block + ids)[None], (yb * block + ids)[None])
        want = plain_pcit_chunked(*args)
        n_diff += compare_keep(keep[None, xs, ys], want, *args, "PCIT keep")
    say(f"pcit N={PCIT_N} G={PCIT_G} P={P}: {secs * 1e3:.1f} ms (host clock, "
        f"synchronized), peak {peak / 2**30:.3f} GiB, B2 launches "
        f"{counts['pairwise_corr']}, B3 launches {counts['pcit_filter']}, "
        f"corr max abs err {err:.3e}, kept {float(keep.float().mean()):.4f}, "
        f"sampled keep tiles differ at {n_diff} entries (within boundary)")
    del corr, keep
    # the full pipeline on the card against the O(N^3) numpy reference
    rng = np.random.default_rng(0)
    Xsm = (rng.normal(size=(64, 6)) @ rng.normal(size=(6, 24))
           + 0.4 * rng.normal(size=(64, 24))).astype(np.float32)
    corr, keep = run_quorum_pcit(Xsm, comm, use_kernels=True)
    np.testing.assert_allclose(corr.cpu().numpy(), correlation_reference(Xsm),
                               rtol=1e-4, atol=1e-5)
    check((keep.cpu().numpy() == pcit_reference(Xsm)).all(),
          "PCIT N=64: keep differs from pcit_reference")
    say("pcit N=64 G=24 P=8 on the card == numpy pcit_reference")


# ---------------------------------------------------------------------------
# Serving and the similarity join (B4, B5)
# ---------------------------------------------------------------------------

def cluster_centers(n: int, d: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.rand(n, d, generator=g, device=DEVICE)


def clustered(centers: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """n non-negative vectors around random centers, made on the device
    from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    pick = torch.randint(centers.shape[0], (n,), generator=g, device=DEVICE)
    x = centers[pick] + CLUSTER_SPREAD * torch.randn(
        n, centers.shape[1], generator=g, device=DEVICE)
    return x.clamp_(min=0.0)


def l2_scores(q: torch.Tensor, X: torch.Tensor, xn: torch.Tensor):
    """[Q, N] scores 2 q.x - |x|^2 - |q|^2 (the engine's formula) by
    cuBLAS, TF32 off."""
    return 2.0 * (q @ X.T) - xn[None, :] - (q * q).sum(-1)[:, None]


def tol_of(s: torch.Tensor) -> torch.Tensor:
    return SCORE_TOL * torch.clamp(s.abs(), min=1.0)


def check_topk_rows(q, X, xn, got_v, got_i, want_v, want_i, what: str,
                    terms: bool = False) -> int:
    """Top-k rows [Q, topk] against the wanted ones: values within rtol /
    atol 1e-5; an index may differ only where the brute-force scores of
    the two candidates lie within SCORE_TOL of each other or of the k-th
    score.  With ``terms`` the tolerance is SCORE_TOL * max(1, 2 (|q|^2 +
    |x|^2)) of the wanted candidate instead: the size of the terms an l2
    score cancels, which sets how far two float32 sums of wide rows in
    other orders may differ.  Returns the number of differing entries."""
    tol = tol_of(want_v)
    close = torch.allclose(got_v, want_v, rtol=SCORE_TOL, atol=SCORE_TOL)
    if terms:
        qn = (q * q).sum(-1)[:, None]
        tol = SCORE_TOL * torch.clamp(2.0 * (qn + xn[want_i.long()]),
                                      min=1.0)
        close = bool(((got_v - want_v).abs() <= tol).all())
    check(close, f"{what}: values differ by up to "
          f"{float((got_v - want_v).abs().max()):.3e}")
    check(bool((got_i >= 0).all() and (got_i < X.shape[0]).all()),
          f"{what}: an index is out of range (a sentinel?)")
    diff = got_i != want_i
    if not bool(diff.any()):
        return 0
    rows = X[got_i.long()]                                  # [Q, topk, d]
    s_got = (2.0 * torch.einsum("qd,qtd->qt", q, rows) - xn[got_i.long()]
             - (q * q).sum(-1)[:, None])
    kth = want_v[:, -1:].expand_as(want_v)
    tol_k = tol[:, -1:].expand_as(want_v)
    ok = ((s_got - want_v).abs() <= tol) | (
        ((s_got - kth).abs() <= tol_k) & ((want_v - kth).abs() <= tol_k))
    check(bool(ok[diff].all()), f"{what}: {int((diff & ~ok).sum())} indices "
          "differ beyond the tie tolerance")
    return int(diff.sum())


def brute_topk(q, X, xn, topk: int, chunk: int = 32):
    """(-score, index) top-k of every query over the whole corpus: cuBLAS
    scores, then one stable sort by -score (indices are already
    ascending)."""
    vals, idx = [], []
    for c0 in range(0, q.shape[0], chunk):
        s = l2_scores(q[c0:c0 + chunk], X, xn)
        sv, si = torch.sort(-s, dim=-1, stable=True)
        vals.append(-sv[:, :topk])
        idx.append(si[:, :topk].int())
    return torch.cat(vals), torch.cat(idx)


def serving_data():
    """The serving corpus, its queries, the replacement block and the
    range-query batch (all from seeds, on the device)."""
    centers = cluster_centers(SERVE_CLUSTERS, SERVE_D, 10)
    X = clustered(centers, SERVE_N, 11)
    n_batches = SERVE_BATCHES + SERVE_BIG_BATCHES + SERVE_AFTER_BATCHES
    queries = clustered(centers, SERVE_Q * n_batches, 12).reshape(
        n_batches, SERVE_Q, SERVE_D)
    fresh = clustered(centers, SERVE_N // P, 13)
    thr_q = clustered(centers, THR_Q, 14)
    return X, queries, fresh, thr_q


def capture_batch_fn(store: dict, outputs):
    """A batch_fn that records the engine's operands and returns dummies
    of the right shapes: the main path's kernel inputs, bit for bit."""
    def fn(*args):
        store["args"] = args
        return outputs(*args)
    return fn


def phase_kernels_serving(report: dict) -> None:
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.placement import get_placement
    from repro_torch.core.sparse import quorum_allpairs_threshold
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.cover import build_cover
    from repro_torch.serving.engine import quorum_query_topk, quantize_pow2
    from repro_torch.serving.stream import build_state

    comm = SingleProcessComm(P, DEVICE)
    plc = get_placement("cyclic", P)
    sched = plc.schedule()

    # ---- B4 at the serving path's shapes: stack [8, 4, 125000, 128] ----
    X, queries, _fresh, _thr_q = serving_data()
    xn = (X * X).sum(-1)
    q = queries[0]
    topk = quantize_pow2(SERVE_TOPK)
    state = build_state(X, comm, placement=plc)
    mask_table = torch.as_tensor(build_cover(P, plc).mask_table(),
                                 device=DEVICE)
    store: dict = {}
    quorum_query_topk(q, state.stack, state.stack_valid, mask_table,
                      topk=topk, comm=comm, schedule=sched, mode="batched",
                      metric="l2", batch_fn=capture_batch_fn(
                          store, lambda st, qq, m, g: (
                              torch.full((P, qq.shape[0], topk), -1e30,
                                         device=DEVICE),
                              torch.zeros(P, qq.shape[0], topk,
                                          dtype=torch.int32,
                                          device=DEVICE))))
    stack, qq, mask, gidx = store.pop("args")
    got_v, got_i = ops.query_topk(stack, qq, mask, gidx, topk=topk,
                                  metric="l2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [ref.query_topk(stack[p:p + 1], qq, mask[p:p + 1], gidx[p:p + 1],
                           topk=topk, metric="l2") for p in range(P)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    want_v = torch.cat([w[0] for w in want])
    want_i = torch.cat([w[1] for w in want])
    err = float((got_v - want_v).abs().max())
    n_diff = 0
    for p in range(P):
        live = want_i[p, :, 0] != ref.IDX_SENTINEL
        check(bool((live == (got_i[p, :, 0] != ref.IDX_SENTINEL)).all()),
              f"B4: device {p} sentinel rows differ")
        if bool(live.any()):
            n_diff += check_topk_rows(qq, X, xn, got_v[p], got_i[p],
                                      want_v[p], want_i[p], f"B4 device {p}")
    ms = cuda_ms(lambda: ops.query_topk(stack, qq, mask, gidx, topk=topk,
                                        metric="l2"), reps=10)
    live_rows = mask > 0
    n_rows = int(live_rows.sum())
    Xu = stack[live_rows]                                  # [n_rows, d]
    neg_xn = -(Xu * Xu).sum(-1)[None]
    lib_ms = cuda_ms(lambda: torch.topk(torch.addmm(neg_xn, qq, Xu.T,
                                                    alpha=2.0), topk),
                     reps=10)
    Q, d = qq.shape
    b_ms, b_by = bound(n_rows * d * 4 + nbytes(qq, mask, gidx, got_v, got_i),
                       2.0 * Q * d * n_rows)
    say(f"B4 query_topk stack {tuple(stack.shape)} x Q={Q} topk={topk} l2, "
        f"{n_rows} unmasked rows: max_abs_err={err:.3e}, indices differ at "
        f"{n_diff} near-tie entries; kernel {ms:.3f} ms, plain {plain_ms:.3f}"
        f" ms (host clock, device by device), torch.addmm + torch.topk (two "
        f"calls) {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    report["query_topk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib_ms, differing=n_diff)
    del state, stack, mask, gidx, Xu, want, X, queries

    # ---- B5 at the join's shapes: quorum [8, 4, 32768, 128] ------------
    X, xn, thr = join_data()
    N = X.shape[0]
    xs = X.reshape(P, N // P, JOIN_D)
    cap = 1 << 15
    quorum_allpairs_threshold(
        xs, comm, threshold=thr, capacity=cap, schedule=sched,
        mode="batched", n_valid=N, batch_fn=capture_batch_fn(
            store, lambda qu, lo, hi, meta: (
                torch.zeros(P, cap, device=DEVICE),
                torch.zeros(P, cap, dtype=torch.int32, device=DEVICE),
                torch.zeros(P, cap, dtype=torch.int32, device=DEVICE),
                torch.zeros(P, dtype=torch.int32, device=DEVICE))))
    quorum, lo, hi, meta = store.pop("args")
    kw = dict(threshold=thr, capacity=cap, block_rows=N // P, metric="l2")
    got = ops.pairwise_threshold(quorum, lo, hi, meta, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref.pairwise_threshold(quorum, lo, hi, meta, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(bool((got[3] <= cap).all()), f"B5: capacity {cap} overflowed")
    err, n_diff = compare_hits(X, xn, thr, got, want, "B5")
    ms = cuda_ms(lambda: ops.pairwise_threshold(quorum, lo, hi, meta, **kw),
                 reps=3)
    gemm_ms = per_tile_gemm(quorum, lo, hi, meta,
                            lambda a, b, out: torch.mm(a, b.T, out=out),
                            torch.float32)
    split = kernel_split(lambda: ops.pairwise_threshold(quorum, lo, hi, meta,
                                                        **kw))
    cand = 0
    for p in range(P):
        for n in range(len(lo)):
            a, s_, _ga, _gb, nv_lo, nv_hi = (int(v) for v in meta[p, n])
            if a:
                cand += (nv_lo * (nv_lo - 1) // 2 if s_ else nv_lo * nv_hi)
    b_ms, b_by = bound(nbytes(quorum, meta, *got), 2.0 * JOIN_D * cand)
    say(f"B5 pairwise_threshold quorum {tuple(quorum.shape)} x {len(lo)} "
        f"pairs, {cand} candidates in active tiles, {int(got[3].sum())} "
        f"hits: max_abs_err={err:.3e}, {n_diff} hits differ (all within "
        f"{SCORE_TOL} of the threshold); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (host clock), GEMM only, no threshold (torch.mm, "
        f"TF32 off, per active tile) {gemm_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}); by kernel (torch.profiler): {split}; hot tiles "
        f"{hot_tiles(got)} of {walked_tiles(meta)}")
    # an overflowing capacity keeps the plain version's exact prefix
    # (small-integer data: every score exact, so no boundary rounding)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    qi = torch.randint(-2, 3, (2, 3, 300, 8), generator=g,
                       device=DEVICE).float()
    mi = torch.tensor([[1, 1, 0, 0, 300, 300], [1, 0, 0, 1, 280, 300],
                       [1, 0, 1, 2, 300, 250]], dtype=torch.int32,
                      device=DEVICE).expand(2, 3, 6).contiguous()
    kwi = dict(threshold=6.0, capacity=700, block_rows=300, metric="dot")
    a = ops.pairwise_threshold(qi, [0, 0, 1], [0, 1, 2], mi, **kwi)
    b = ref.pairwise_threshold(qi, [0, 0, 1], [0, 1, 2], mi, **kwi)
    check(bool((a[3] > 700).all()) and all(torch.equal(x, y)
                                           for x, y in zip(a, b)),
          "B5: the overflowing prefix differs from the plain version's")
    say(f"B5 overflow: counts {a[3].tolist()} > capacity 700, the kept "
        "prefix equals the plain version's")
    report["pairwise_threshold"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=b_ms,
                                        bound_by=b_by, library_ms=None,
                                        gemm_only_ms=gemm_ms,
                                        differing=n_diff, candidates=cand)


def hit_scores(X, xn, i, j):
    """Brute-force l2 scores of pairs (i, j), the engine's formula."""
    i, j = i.long(), j.long()
    return 2.0 * (X[i] * X[j]).sum(-1) - xn[j] - xn[i]


def pair_keys(i, j, N: int) -> torch.Tensor:
    return i.long() * N + j.long()


def compare_pair_sets(X, xn, thr, got_i, got_j, want_i, want_j,
                      what: str) -> int:
    """Pair sets may differ only by pairs whose brute-force score lies
    within SCORE_TOL * max(1, |thr|) of the threshold."""
    N = X.shape[0]
    gk, wk = pair_keys(got_i, got_j, N), pair_keys(want_i, want_j, N)
    check(gk.unique().numel() == gk.numel(), f"{what}: a pair is repeated")
    only = torch.cat([gk[~torch.isin(gk, wk)], wk[~torch.isin(wk, gk)]])
    if only.numel():
        s = hit_scores(X, xn, only // N, only % N)
        t = SCORE_TOL * max(1.0, abs(thr))
        check(bool(((s - thr).abs() <= t).all()),
              f"{what}: {only.numel()} pairs differ, some beyond {t:.3e} of "
              "the threshold")
    return int(only.numel())


def compare_hits(X, xn, thr, got, want, what: str):
    """Compacted per-device buffers (vals, i, j, count) against the plain
    version's: identical when no pair sits on the threshold, else the
    sets differ only at it.  Returns (max |value error|, differing
    pairs)."""
    if all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
        return float((got[0] - want[0]).abs().max()), 0
    n_diff, err = 0, 0.0
    for p in range(P):
        ng = min(int(got[3][p]), got[1].shape[1])
        nw = min(int(want[3][p]), want[1].shape[1])
        gi, gj = got[1][p, :ng], got[2][p, :ng]
        n_diff += compare_pair_sets(X, xn, thr, gi, gj, want[1][p, :nw],
                                    want[2][p, :nw], f"{what} device {p}")
        err = max(err, float((got[0][p, :ng]
                              - hit_scores(X, xn, gi, gj)).abs().max()))
    return err, n_diff


def join_data(d: int = JOIN_D, n: int = JOIN_N, seed: int = 20):
    """The join's corpus (n x d; phase 9's by default) and a threshold for
    about JOIN_HITS pairs, taken from the pairs of a seeded sample of
    rows."""
    X = clustered(cluster_centers(JOIN_CLUSTERS, d, seed), n, seed + 1)
    xn = (X * X).sum(-1)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    rows = torch.randperm(n, generator=g, device=DEVICE)[:JOIN_SAMPLE]
    # each sampled row sees its pairs with every other row, so the sample
    # holds about 2 * JOIN_HITS * S / N of the passing pairs
    want = max(1, round(2 * JOIN_HITS * JOIN_SAMPLE / n))
    best = None
    for c0 in range(0, JOIN_SAMPLE, 1024):
        r = rows[c0:c0 + 1024]
        s = l2_scores(X[r], X, xn)
        s[torch.arange(len(r), device=DEVICE), r] = -float("inf")
        top = torch.topk(s.flatten(), min(want, s.numel())).values
        best = top if best is None else torch.topk(torch.cat([best, top]),
                                                   want).values
    return X, xn, float(best[-1])


def phase_selfcheck_serving() -> None:
    from repro_torch.core.sparse import selfcheck_main
    from repro_torch.serving import selfcheck
    for p in (2, 5, 8):
        selfcheck.main(p, device=DEVICE)
        selfcheck_main(p, device=DEVICE)


def phase_serving(report: dict) -> None:
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingCorpus
    from repro_torch.serving.engine import quantize_pow2

    comm = SingleProcessComm(P, DEVICE)
    X, queries, fresh, thr_q = serving_data()
    xn = (X * X).sum(-1)
    block = SERVE_N // P
    rb = slice(REPLACED_BLOCK * block, (REPLACED_BLOCK + 1) * block)
    # per-query thresholds midway between the THR_HITS-th and the next
    # score over the corpus as it stands after the replace
    s_thr = l2_scores(thr_q, X, xn)
    s_thr[:, rb] = l2_scores(thr_q, fresh, (fresh * fresh).sum(-1))
    top = torch.topk(s_thr, THR_HITS + 1).values
    thr_vec = (top[:, THR_HITS - 1] + top[:, THR_HITS]) / 2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    t0 = time.perf_counter()
    sc = ServingCorpus.build(X, comm, placement="cyclic")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held, lat = {}, []
    for b in range(SERVE_BATCHES):
        t0 = time.perf_counter()
        out = sc.query(queries[b], topk=SERVE_TOPK, metric="l2",
                       use_kernel=True)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if b in SERVE_HELD:
            held[b] = out
    lat_big = []
    for b in range(SERVE_BATCHES, SERVE_BATCHES + SERVE_BIG_BATCHES):
        t0 = time.perf_counter()
        out = sc.query(queries[b], topk=SERVE_BIG_TOPK, metric="l2",
                       use_kernel=True)
        torch.cuda.synchronize()
        lat_big.append((time.perf_counter() - t0) * 1e3)
    held_big = (b, out)
    t0 = time.perf_counter()
    sc.replace_block(REPLACED_BLOCK, fresh)
    torch.cuda.synchronize()
    replace_ms = (time.perf_counter() - t0) * 1e3
    for b in range(SERVE_BATCHES + SERVE_BIG_BATCHES, queries.shape[0]):
        out = sc.query(queries[b], topk=SERVE_TOPK, metric="l2",
                       use_kernel=True)
    held_after = (b, out)
    t0 = time.perf_counter()
    tv, ti, tc = sc.query_threshold(thr_q, threshold=thr_vec,
                                    capacity=THR_CAP0, mode="batched",
                                    metric="l2")
    torch.cuda.synchronize()
    thr_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    resident = sc.state.stack[0].numel() * sc.state.stack.element_size()
    report["query_topk"]["launches"] = counts["query_topk"]
    check(counts["query_topk"] > 0, "serving: B4 was never launched")
    escalations = (ti.shape[1] // quantize_pow2(THR_CAP0)).bit_length() - 1

    # the results against a brute force on the card
    n_diff = 0
    for b, (v, i) in held.items():
        want_v, want_i = brute_topk(queries[b], X, xn, SERVE_TOPK)
        n_diff += check_topk_rows(queries[b], X, xn, v, i, want_v, want_i,
                                  f"serving microbatch {b}")
    b, (v, i) = held_big
    want_v, want_i = brute_topk(queries[b], X, xn, SERVE_BIG_TOPK)
    n_diff += check_topk_rows(queries[b], X, xn, v, i, want_v, want_i,
                              f"serving top-{SERVE_BIG_TOPK} microbatch {b}")
    X[rb] = fresh
    xn[rb] = (fresh * fresh).sum(-1)
    b, (v, i) = held_after
    want_v, want_i = brute_topk(queries[b], X, xn, SERVE_TOPK)
    n_diff += check_topk_rows(queries[b], X, xn, v, i, want_v, want_i,
                              f"serving after the replace, microbatch {b}")
    hits = 0
    for r in range(THR_Q):
        n = int(tc[r])
        check(n <= ti.shape[1], f"range query {r}: count {n} overflows")
        gi = ti[r, :n]
        check(bool((gi[1:] > gi[:-1]).all()),
              f"range query {r}: hits not in ascending index order")
        check(bool((ti[r, n:] == 2 ** 31 - 1).all()),
              f"range query {r}: no sentinels past the count")
        wi = torch.nonzero(s_thr[r] >= thr_vec[r]).reshape(-1).int()
        only = torch.cat([gi[~torch.isin(gi, wi)], wi[~torch.isin(wi, gi)]])
        t = SCORE_TOL * max(1.0, abs(float(thr_vec[r])))
        check(bool(((s_thr[r, only.long()] - thr_vec[r]).abs() <= t).all()),
              f"range query {r}: hits differ beyond {t:.3e} of the threshold")
        check(torch.allclose(tv[r, :n], s_thr[r, gi.long()], rtol=SCORE_TOL,
                             atol=SCORE_TOL), f"range query {r}: values")
        n_diff += int(only.numel())
        hits += n
    p50, p99 = np.percentile(lat, [50, 99])
    qps = SERVE_BATCHES * SERVE_Q / (sum(lat) / 1e3)
    say(f"serving N={SERVE_N} d={SERVE_D} P={P} (cover {sc.plan.n_cover} "
        f"devices): build {build_s:.2f} s; {SERVE_BATCHES} microbatches of "
        f"Q={SERVE_Q} l2 top-{SERVE_TOPK}: p50 {p50:.3f} ms, p99 {p99:.3f} "
        f"ms (host clock, synchronized), {qps:.1f} queries/s; top-"
        f"{SERVE_BIG_TOPK}: {', '.join(f'{t:.2f}' for t in lat_big)} ms; "
        f"replace_block {replace_ms:.1f} ms; range query Q={THR_Q}: "
        f"{thr_ms:.1f} ms, {hits} hits, {escalations} escalations from "
        f"capacity {THR_CAP0}; peak {peak / 2**30:.3f} GiB; resident stack "
        f"{resident / 2**20:.1f} MiB per device vs N*d*4 = "
        f"{SERVE_N * SERVE_D * 4 / 2**20:.1f} MiB; B4 launches "
        f"{counts['query_topk']}; {n_diff} entries differ from the brute "
        "force, all within the tie tolerance")


def phase_join(report: dict) -> None:
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.sparse import similarity_join
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as obs_trace

    comm = SingleProcessComm(P, DEVICE)
    X, xn, thr = join_data()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = obs_trace.configure(metrics_only=True)
    try:
        t0 = time.perf_counter()
        res = similarity_join(X, comm, threshold=thr, metric="l2",
                              mode="batched", placement="cyclic",
                              capacity=JOIN_CAP0, use_kernel=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        obs_trace.reset()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    report["pairwise_threshold"]["launches"] = counts["pairwise_threshold"]
    check(counts["pairwise_threshold"] > 0, "join: B5 was never launched")
    got_i = torch.as_tensor(res.i, device=DEVICE)
    got_j = torch.as_tensor(res.j, device=DEVICE)
    check(bool((got_i < got_j).all()), "join: a pair has i >= j")
    wi, wj = [], []
    cols = torch.arange(JOIN_N, device=DEVICE)
    for r0 in range(0, JOIN_N, 4096):
        r = cols[r0:r0 + 4096]
        s = l2_scores(X[r], X, xn)
        ii, jj = torch.nonzero((s >= thr) & (cols[None] > r[:, None]),
                               as_tuple=True)
        wi.append(ii + r0)
        wj.append(jj)
    wi, wj = torch.cat(wi), torch.cat(wj)
    n_diff = compare_pair_sets(X, xn, thr, got_i, got_j, wi, wj, "join")
    report["join_pairs"] = (got_i, got_j)
    s_got = hit_scores(X, xn, got_i, got_j)
    check(torch.allclose(torch.as_tensor(res.scores, device=DEVICE), s_got,
                         rtol=SCORE_TOL, atol=SCORE_TOL), "join: scores")
    say(f"join N={JOIN_N} d={JOIN_D} P={P} l2 threshold {thr:.6g}: "
        f"{res.n_pairs} pairs in {secs:.3f} s (host clock, synchronized), "
        f"peak {peak / 2**30:.3f} GiB, {res.escalations} escalations from "
        f"capacity {JOIN_CAP0} to {res.capacity}, "
        f"{int(tr.counter_total('sparse.tiles_pruned'))} of "
        f"{int(tr.counter_total('sparse.tiles_scheduled'))} tiles pruned, "
        f"B5 launches {counts['pairwise_threshold']}; brute force "
        f"{wi.numel()} pairs, {n_diff} differ (all within the threshold "
        "tolerance)")


# ---------------------------------------------------------------------------
# The k-NN graph and the quantized paths (B6, B7, B8)
# ---------------------------------------------------------------------------

def lists_near(got_v, got_i, want_v, want_i, what: str) -> int:
    """Lists [..., topk] against the plain version's where the two sum in
    other orders: values within SCORE_TOL * max(1, |s|) rank by rank, and
    where the ids differ the wanted score at that rank has a near-tie
    partner (another listed score, or the k-th) within that tolerance.
    Returns the number of differing entries."""
    tol = tol_of(want_v)
    check(bool(((got_v - want_v).abs() <= tol).all()),
          f"{what}: values differ by up to "
          f"{float((got_v - want_v).abs().max()):.3e}")
    diff = got_i != want_i
    if not bool(diff.any()):
        return 0
    gap = (want_v[..., :, None] - want_v[..., None, :]).abs()
    eye = torch.eye(want_v.shape[-1], dtype=torch.bool, device=DEVICE)
    partner = ((gap <= tol[..., None]) & ~eye).any(-1)
    kth = (want_v - want_v[..., -1:]).abs() <= tol
    check(bool((partner | kth)[diff].all()),
          f"{what}: {int((diff & ~(partner | kth)).sum())} ids differ "
          "beyond the tie tolerance")
    return int(diff.sum())


def active_candidates(meta) -> int:
    """Unique row pairs of the active tiles (self tiles count once)."""
    cand = 0
    for a, s_, _ga, _gb, nv_lo, nv_hi in meta.reshape(-1, 6).tolist():
        if a:
            cand += nv_lo * (nv_lo - 1) // 2 if s_ else nv_lo * nv_hi
    return cand


def per_tile_library(quorum, lo, hi, meta, product) -> float:
    """The two-call yardstick over every active tile: ``product`` (one
    library matmul) then torch.topk along both orientations (one for a
    self tile).  Device ms of one pass."""
    active = meta[..., 0].cpu()
    lo, hi = [int(v) for v in lo], [int(v) for v in hi]

    def run():
        for p in range(P):
            for n, (l, h) in enumerate(zip(lo, hi)):
                if active[p, n]:
                    s = product(quorum[p, l], quorum[p, h])
                    torch.topk(s, KNN_TOPK, dim=1)
                    if l != h:
                        torch.topk(s, KNN_TOPK, dim=0)
    return cuda_ms(run, reps=1)


def per_tile_gemm(quorum, lo, hi, meta, product, dtype) -> float:
    """The GEMM-only yardstick of B5 / B7 (no threshold, no compaction):
    ``product(a, b, out)`` (one library matmul into a reused [block,
    block] tile of ``dtype``) over every active tile.  Device ms of one
    pass."""
    active = meta[..., 0].cpu()
    lo, hi = [int(v) for v in lo], [int(v) for v in hi]
    block = quorum.shape[2]
    out = torch.empty(block, block, dtype=dtype, device=DEVICE)

    def run():
        for p in range(P):
            for n, (l, h) in enumerate(zip(lo, hi)):
                if active[p, n]:
                    product(quorum[p, l], quorum[p, h], out)
    ms = cuda_ms(run, reps=1)
    del out
    return ms


def common_value_err(got, want, N: int) -> float:
    """Largest |value difference| over the pairs both compacted buffers
    hold (the bf16 bands may differ at their edge)."""
    err = 0.0
    for p in range(got[3].shape[0]):
        ng, nw = int(got[3][p]), int(want[3][p])
        gk, gi = torch.sort(pair_keys(got[1][p, :ng], got[2][p, :ng], N))
        wk, wi = torch.sort(pair_keys(want[1][p, :nw], want[2][p, :nw], N))
        gv = got[0][p, :ng][gi][torch.isin(gk, wk)]
        wv = want[0][p, :nw][wi][torch.isin(wk, gk)]
        if gv.numel():
            err = max(err, float((gv - wv).abs().max()))
    return err


def band_edge_check(qc, thr, got, want, what: str,
                    terms: bool = False) -> int:
    """bf16 band buffers against the plain version's (of one device or
    more): identical, or the pair sets differ only by pairs whose plain
    band score lies within SCORE_TOL * max(1, |thr - eps|) of the band's
    edge ``thr - eps``.  With ``terms`` the score is evaluated in float64
    and the tolerance is SCORE_TOL * max(1, 2 (|x_i|^2 + |x_j|^2)), the
    size of the terms an l2 score cancels (check_topk_rows' rule for wide
    rows, where two float32 orders differ by more than the first rule)."""
    from repro_torch.kernels.ref import quant_eps_tile
    if all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
        return 0
    n_diff = 0
    d = qc.q.shape[1]
    for p in range(got[3].shape[0]):
        ng = min(int(got[3][p]), got[1].shape[1])
        nw = min(int(want[3][p]), want[1].shape[1])
        gk = pair_keys(got[1][p, :ng], got[2][p, :ng], qc.q.shape[0])
        wk = pair_keys(want[1][p, :nw], want[2][p, :nw], qc.q.shape[0])
        only = torch.cat([gk[~torch.isin(gk, wk)], wk[~torch.isin(wk, gk)]])
        if not only.numel():
            continue
        i, j = only // qc.q.shape[0], only % qc.q.shape[0]
        bi, bj = i // qc.block, j // qc.block
        eps = quant_eps_tile(qc.delta[bi], qc.delta[bj], qc.l1[i][:, None],
                             qc.l1[j][:, None], dim=d, metric="l2")[:, 0, 0]
        edge = thr - eps
        if terms:
            s = (qc.q[i].double() * qc.q[j].double()).sum(-1) \
                * (qc.scale[bi].double() * qc.scale[bj].double())
            s = (2.0 * s - qc.sq[j].double()) - qc.sq[i].double()
            tol = SCORE_TOL * torch.clamp(
                2.0 * (qc.sq[i] + qc.sq[j]).double(), min=1.0)
        else:
            s = (qc.q[i].float() * qc.q[j].float()).sum(-1) \
                * (qc.scale[bi] * qc.scale[bj])
            s = (2.0 * s - qc.sq[j]) - qc.sq[i]
            tol = tol_of(edge)
        check(bool(((s - edge).abs() <= tol).all()),
              f"{what} device {p}: {only.numel()} pairs differ, some away "
              "from the band's edge")
        n_diff += int(only.numel())
    return n_diff


WIDE_META = ((1, 1, 0, 0, 200, 200), (1, 0, 0, 1, 200, 200),
             (1, 1, 1, 1, 200, 200))   # two slots of 200 rows, three pairs


def f64_list_err(vals, idx, s64) -> float:
    """Largest |listed score - its float64 score| over the real entries of
    wide_rows' lists [1, 2, 200, M] (row r of slot s is row 200 s + r of
    ``s64``, the candidates its columns)."""
    real = vals > -1e29
    rows = torch.arange(vals.shape[1] * vals.shape[2], device=DEVICE)
    rows = rows.reshape(1, vals.shape[1], vals.shape[2], 1).expand_as(idx)
    want = s64[rows[real], idx[real].long()]
    return float((vals[real].double() - want).abs().max())


def exact_q_dots(qf, scale, l, h, r0, r1):
    """``kernels.ref._q_dots`` with the code dot evaluated in float64 and
    rounded once to float32: int8's contract past d = 1,040, where the
    plain version's float32 sum depends on its order."""
    dots = (qf[:, l, r0:r1].double()
            @ qf[:, h].double().transpose(-1, -2)).float()
    return dots * (scale[:, l] * scale[:, h])[:, None, None]


def wide_rows(report: dict) -> None:
    """B8 bf16 at every width of WIDE_BF16_D on both routes, 6 seeds:
    past d = 128 route_of's route no further from a float64 evaluation
    than the plain float32 version (tensor-core sums truncate: chunks of
    32 joined in float32, compensated), and within the tie rule of the
    plain version up to d = 256 (dot scores down to 0, where the rule is
    1e-5 absolute).  At d <= 128 the route sums in one accumulator, as it
    did before chunks existed: its float64 reading is printed, the tie
    rule held.  Then B8 and B7 int8 at d = WIDE_INT8_D, dots past 2^24,
    equal to the plain version with its dot evaluated in float64 and
    rounded once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_batch_q import (
        pairwise_threshold_q_cuda, pairwise_topk_q_cuda, route_of)

    mb = torch.tensor([WIDE_META], dtype=torch.int32, device=DEVICE)
    lo, hi = [0, 0, 1], [0, 1, 1]
    kwb = dict(topk=512, block_rows=200, metric="dot")
    reads = {}
    for d in WIDE_BF16_D:
        tie = {"tensor_cores": 0.0, "simt": 0.0}
        f64 = {"tensor_cores": 0.0, "simt": 0.0, "plain": 0.0}
        for seed in range(6):
            g = torch.Generator(device=DEVICE).manual_seed(1000 * d + seed)
            codes = torch.randn(1, 2, 200, d, generator=g,
                                device=DEVICE).to(torch.bfloat16)
            flat = codes.double().reshape(400, d)
            s64 = flat @ flat.T
            sdb = torch.ones(1, 2, 2, device=DEVICE)
            sqb = (codes.float() ** 2).sum(-1)
            want_v, want_i = ref.pairwise_topk_q(codes, sdb[..., 0], sqb, lo,
                                                 hi, mb, **kwb)
            f64["plain"] = max(f64["plain"],
                               f64_list_err(want_v, want_i, s64))
            real = want_v > -1e29
            for route in tie:
                got_v, got_i = pairwise_topk_q_cuda(codes, sdb, sqb, lo, hi,
                                                    mb, route=route, **kwb)
                tie[route] = max(tie[route], float(
                    ((got_v - want_v).abs() / tol_of(want_v))[real].max()))
                f64[route] = max(f64[route],
                                 f64_list_err(got_v, got_i, s64))
        chosen = route_of(torch.bfloat16, d)
        check(d <= 128 or f64[chosen] <= f64["plain"],
              f"B8 bf16 d={d}: route {chosen} reads {f64[chosen]:.3e} from "
              f"float64, the plain float32 version {f64['plain']:.3e}")
        check(d > 256 or tie[chosen] <= 1.0,
              f"B8 bf16 d={d}: route {chosen} reads {tie[chosen]:.3f} of "
              "the tie rule")
        reads[d] = (f64[chosen], f64["plain"])
        say(f"B8 bf16 d={d} dot top-512, worst of 6 seeds: max |err| from "
            f"float64 tensor cores {f64['tensor_cores']:.3e}, simt "
            f"{f64['simt']:.3e}, plain float32 {f64['plain']:.3e}; max "
            f"|err| / (1e-5 max(1, |s|)) against the plain version tensor "
            f"cores {tie['tensor_cores']:.3f}, simt {tie['simt']:.3f}; "
            f"route_of picks {chosen}")
    report["pairwise_topk_q"]["bf16_wide_f64_err"] = {
        str(d): list(v) for d, v in reads.items()}

    # int8 past the float32-exact width: dots near 1,536 * 124^2 > 2^24
    d = WIDE_INT8_D
    g = torch.Generator(device=DEVICE).manual_seed(d)
    codes = (127 - torch.randint(0, 8, (1, 2, 200, d), generator=g,
                                 device=DEVICE)).to(torch.int8)
    sd = torch.tensor([[[0.01, 1e-6], [0.02, 2e-6]]], device=DEVICE)
    rowsf = codes.float() * sd[..., 0, None, None]
    l1, sq = rowsf.abs().sum(-1), (rowsf ** 2).sum(-1)
    route = route_of(torch.int8, d)
    with mock.patch.object(ref, "_q_dots", exact_q_dots):
        kw8 = dict(topk=512, block_rows=200, metric="l2")
        want = ref.pairwise_topk_q(codes, sd[..., 0], sq, lo, hi, mb, **kw8)
        got = pairwise_topk_q_cuda(codes, sd, sq, lo, hi, mb, **kw8)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"B8 int8 d={d} ({route}): lists differ from the float64 "
              "dot rounded once")
    f32_diff = int((ref.pairwise_topk_q(codes, sd[..., 0], sq, lo, hi, mb,
                                        **kw8)[0] != want[0]).sum())
    with mock.patch.object(ref, "_q_dots", exact_q_dots):
        s_ex = exact_q_dots(codes.float().reshape(1, 2, 200, d),
                            sd[..., 0], 0, 1, 0, 200)
        kw7 = dict(threshold=float(torch.quantile(s_ex.flatten(), 0.9)),
                   capacity=1 << 16, block_rows=200, metric="dot")
        want7 = ref.pairwise_threshold_q(codes, sd[..., 0], sd[..., 1], l1,
                                         sq, lo, hi, mb, **kw7)
        got7 = pairwise_threshold_q_cuda(codes, sd, l1, sq, lo, hi, mb,
                                         **kw7)
        check(all(torch.equal(a, b) for a, b in zip(got7, want7)),
              f"B7 int8 d={d} ({route}): band differs from the float64 dot "
              "rounded once")
    say(f"B8 / B7 int8 d={d} ({route}; dots up to "
        f"{float(s_ex.max() / (0.01 * 0.02)):.4g}): lists and band "
        f"({int(want7[3].sum())} entries) equal the plain version with its "
        f"dot in float64 rounded once; its float32 matmul moves "
        f"{f32_diff} of {want[0].numel()} list values")


def phase_kernels_knn(report: dict) -> None:
    from repro_torch.core import quant
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.knn import quorum_allpairs_knn
    from repro_torch.core.placement import get_placement
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pairwise_batch_q import (
        pairwise_threshold_q_cuda, pairwise_topk_q_cuda, route_of)
    from repro_torch.kernels.pairwise_topk import (
        pairwise_topk_score_only_cuda)
    from repro_torch.serving.engine import quantize_pow2

    comm = SingleProcessComm(P, DEVICE)
    sched = get_placement("cyclic", P).schedule()
    X, xn, thr = join_data()
    N = X.shape[0]
    block = N // P
    store: dict = {}

    def lists_out(shape_of, topk):
        return lambda qu, lo, hi, meta: (
            torch.full(shape_of(qu) + (topk,), -1e30, device=DEVICE),
            torch.zeros(shape_of(qu) + (topk,), dtype=torch.int32,
                        device=DEVICE))

    # ---- B6 at the k-NN graph's shapes: quorum [8, 4, 32768, 128] ------
    quorum_allpairs_knn(X.reshape(P, block, JOIN_D), comm, topk=KNN_TOPK,
                        schedule=sched, metric="l2", mode="batched",
                        n_valid=N, batch_fn=capture_batch_fn(
                            store, lists_out(lambda qu: qu.shape[:3],
                                             KNN_TOPK)))
    quorum, lo, hi, meta = store.pop("args")
    kw = dict(topk=KNN_TOPK, block_rows=block, metric="l2")
    got_v, got_i = ops.pairwise_topk(quorum, lo, hi, meta, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [ref.pairwise_topk(quorum[p:p + 1], lo, hi, meta[p:p + 1], **kw)
            for p in range(P)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    want_v = torch.cat([w[0] for w in want])
    want_i = torch.cat([w[1] for w in want])
    del want
    err = float((got_v - want_v).abs().max())
    n_diff = 0
    for p in range(P):
        for s_ in range(sched.k):
            g = (p + int(sched.shifts[s_])) % P
            n_diff += check_topk_rows(
                X[g * block:(g + 1) * block], X, xn, got_v[p, s_],
                got_i[p, s_], want_v[p, s_], want_i[p, s_],
                f"B6 device {p} slot {s_}")
    ms = cuda_ms(lambda: ops.pairwise_topk(quorum, lo, hi, meta, **kw),
                 reps=2)
    score_ms = cuda_ms(lambda: pairwise_topk_score_only_cuda(
        quorum, lo, hi, meta, **kw), reps=2)
    # 33 entries round up to lists of 64, past the 32 that B6 keeps in
    # shared memory (csrc/pairwise_topk.cu, kSmemTp)
    kw_long = dict(kw, topk=33)
    long_ms = cuda_ms(lambda: ops.pairwise_topk(quorum, lo, hi, meta,
                                                **kw_long), reps=1)
    split = kernel_split(lambda: ops.pairwise_topk(quorum, lo, hi, meta,
                                                   **kw))
    lib_ms = per_tile_library(quorum, lo, hi, meta,
                              lambda a, b: torch.mm(a, b.T))
    cand = active_candidates(meta)
    b_ms, b_by = bound(nbytes(quorum, meta, got_v, got_i), 2.0 * JOIN_D * cand)
    say(f"B6 pairwise_topk quorum {tuple(quorum.shape)} x {len(lo)} pairs, "
        f"{cand} candidate pairs in active tiles, l2 top-{KNN_TOPK}: "
        f"max_abs_err={err:.3e}, ids differ at {n_diff} near-tie entries; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (host clock, device by "
        f"device), torch.mm (TF32 off) + torch.topk per active tile "
        f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); by kernel "
        f"(torch.profiler): {split}; the scoring pass alone (same tiles, no "
        f"selection) {score_ms:.3f} ms; top-33 (lists in global memory) "
        f"{long_ms:.3f} ms")
    report["pairwise_topk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=lib_ms, differing=n_diff,
                                   scoring_only_ms=score_ms,
                                   global_lists_ms=long_ms)
    del quorum, got_v, got_i, want_v, want_i

    # ---- B8 at the quantized k-NN's first pass: M = 16 ------------------
    M = quantize_pow2(KNN_TOPK)
    kw = dict(topk=M, block_rows=block, metric="l2")
    for qm in ("int8", "bf16"):
        qc = quant.quantize_corpus(X, P, block, qm)
        quant.quorum_allpairs_knn_q(
            qc.blocks(), comm, topk=M, schedule=sched, metric="l2",
            mode="batched", n_valid=N, batch_fn=capture_batch_fn(
                store, lists_out(lambda qb: qb.q.shape[:3], M)))
        qq, lo, hi, meta = store.pop("args")
        sd = quant._kernel_sd(qq)
        got_v, got_i = ops.pairwise_topk_q(qq.q, sd, qq.sq, lo, hi, meta,
                                           **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [ref.pairwise_topk_q(qq.q[p:p + 1], qq.scale[p:p + 1],
                                    qq.sq[p:p + 1], lo, hi, meta[p:p + 1],
                                    **kw) for p in range(P)]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        want_v = torch.cat([w[0] for w in want])
        want_i = torch.cat([w[1] for w in want])
        del want
        err = float((got_v - want_v).abs().max())
        if qm == "int8":
            check(torch.equal(got_v, want_v) and torch.equal(got_i, want_i),
                  f"B8 int8: lists differ from the plain version's "
                  f"(max abs err {err:.3e}, "
                  f"{int((got_i != want_i).sum())} ids)")
            n_diff = 0
        else:
            n_diff = lists_near(got_v, got_i, want_v, want_i, "B8 bf16")
        ms = cuda_ms(lambda: ops.pairwise_topk_q(qq.q, sd, qq.sq, lo, hi,
                                                 meta, **kw), reps=2)
        # the SIMT route at this shape, in the same call
        simt_ms = cuda_ms(lambda: pairwise_topk_q_cuda(
            qq.q, sd, qq.sq, lo, hi, meta, route="simt", **kw), reps=1)
        if qm == "int8":
            lib_ms = per_tile_library(qq.q, lo, hi, meta,
                                      lambda a, b: torch._int_mm(a, b.T))
            lib_name = "torch._int_mm + torch.topk"
        else:
            lib_ms = per_tile_library(qq.q, lo, hi, meta,
                                      lambda a, b: torch.mm(a, b.T))
            lib_name = "torch.mm (bf16) + torch.topk"
        cand = active_candidates(meta)
        b_ms, b_by = bound(nbytes(qq.q, sd, qq.sq, meta, got_v, got_i),
                           2.0 * JOIN_D * cand,
                           PEAK_INT8_OPS if qm == "int8" else PEAK_BF16_FLOPS)
        say(f"B8 pairwise_topk_q {qm} {tuple(qq.q.shape)} x {len(lo)} pairs, "
            f"l2 top-{M}: max_abs_err={err:.3e}, ids differ at {n_diff} "
            f"entries ({'identical' if qm == 'int8' else 'near ties'}); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (host clock, device "
            f"by device), {lib_name} per active tile {lib_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}, {qm} tensor-core peak); route "
            f"{route_of(qq.q.dtype, qq.q.shape[-1])}; route simt "
            f"{simt_ms:.3f} ms")
        if qm == "int8":
            report["pairwise_topk_q"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, simt_ms=simt_ms)
        else:   # the bf16 instance rides the same row
            report["pairwise_topk_q"].update(
                bf16_max_abs_err=err, bf16_ms=ms, bf16_plain_ms=plain_ms,
                bf16_bound_ms=b_ms, bf16_library_ms=lib_ms,
                bf16_simt_ms=simt_ms)
        del qq, got_v, got_i, want_v, want_i

    wide_rows(report)

    # ---- B7 at the quantized join's shapes ------------------------------
    cap = QUANT_CAP
    kw = dict(threshold=thr, capacity=cap, block_rows=block, metric="l2")
    for qm in ("int8", "bf16"):
        qc = quant.quantize_corpus(X, P, block, qm)
        quant.quorum_allpairs_threshold_q(
            qc.blocks(), comm, threshold=thr, capacity=cap, schedule=sched,
            metric="l2", mode="batched", n_valid=N,
            batch_fn=capture_batch_fn(store, lambda qb, lo, hi, meta: (
                torch.zeros(P, cap, device=DEVICE),
                torch.zeros(P, cap, dtype=torch.int32, device=DEVICE),
                torch.zeros(P, cap, dtype=torch.int32, device=DEVICE),
                torch.zeros(P, dtype=torch.int32, device=DEVICE))))
        qq, lo, hi, meta = store.pop("args")
        sd = quant._kernel_sd(qq)
        got = ops.pairwise_threshold_q(qq.q, sd, qq.l1, qq.sq, lo, hi, meta,
                                       **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [ref.pairwise_threshold_q(
            qq.q[p:p + 1], qq.scale[p:p + 1], qq.delta[p:p + 1],
            qq.l1[p:p + 1], qq.sq[p:p + 1], lo, hi, meta[p:p + 1], **kw)
            for p in range(P)]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        want = tuple(torch.cat([w[f] for w in want]) for f in range(4))
        check(bool((got[3] <= cap).all()), f"B7 {qm}: capacity overflowed")
        if qm == "int8":
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  "B7 int8: band buffers differ from the plain version's")
            n_diff, err = 0, 0.0
        else:
            n_diff = band_edge_check(qc, thr, got, want, "B7 bf16")
            err = common_value_err(got, want, N)
        ms = cuda_ms(lambda: ops.pairwise_threshold_q(
            qq.q, sd, qq.l1, qq.sq, lo, hi, meta, **kw), reps=2)
        # each route at this shape (d = 128): the band must not move
        route_ms = {}
        for route in ("tensor_cores", "simt"):
            alt = pairwise_threshold_q_cuda(qq.q, sd, qq.l1, qq.sq, lo, hi,
                                            meta, route=route, **kw)
            if qm == "int8":
                check(all(torch.equal(a, b) for a, b in zip(alt, want)),
                      f"B7 int8 route {route}: band buffers differ")
            del alt
            route_ms[route] = cuda_ms(lambda: pairwise_threshold_q_cuda(
                qq.q, sd, qq.l1, qq.sq, lo, hi, meta, route=route, **kw),
                reps=1)
        if qm == "int8":
            gemm_ms = per_tile_gemm(
                qq.q, lo, hi, meta,
                lambda a, b, out: torch._int_mm(a, b.T, out=out), torch.int32)
            gemm_name = "torch._int_mm"
        else:
            gemm_ms = per_tile_gemm(
                qq.q, lo, hi, meta,
                lambda a, b, out: torch.mm(a, b.T, out=out), torch.bfloat16)
            gemm_name = "torch.mm (bf16)"
        split = kernel_split(lambda: ops.pairwise_threshold_q(
            qq.q, sd, qq.l1, qq.sq, lo, hi, meta, **kw))
        cand = active_candidates(meta)
        b_ms, b_by = bound(nbytes(qq.q, sd, qq.l1, qq.sq, meta, *got),
                           2.0 * JOIN_D * cand,
                           PEAK_INT8_OPS if qm == "int8" else PEAK_BF16_FLOPS)
        say(f"B7 pairwise_threshold_q {qm} {tuple(qq.q.shape)} x {len(lo)} "
            f"pairs, l2 band at threshold {thr:.6g}: {int(got[3].sum())} band "
            f"entries, max_abs_err={err:.3e}, {n_diff} differ (at the band's "
            f"edge); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (host clock,"
            f" device by device), GEMM only, no threshold ({gemm_name} per "
            f"active tile) {gemm_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}, "
            f"{qm} tensor-core peak); route {route_of(qq.q.dtype, JOIN_D)}; "
            f"by route at d = {JOIN_D}: tensor_cores "
            f"{route_ms['tensor_cores']:.3f} ms, simt {route_ms['simt']:.3f} "
            f"ms; by kernel (torch.profiler): {split}; hot tiles "
            f"{hot_tiles(got)} of {walked_tiles(meta)}")
        if qm == "int8":
            report["pairwise_threshold_q"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, gemm_only_ms=gemm_ms,
                simt_ms=route_ms["simt"], band=int(got[3].sum()))
        else:
            report["pairwise_threshold_q"].update(
                bf16_ms=ms, bf16_max_abs_err=err, bf16_plain_ms=plain_ms,
                bf16_bound_ms=b_ms, bf16_gemm_only_ms=gemm_ms,
                bf16_simt_ms=route_ms["simt"])
        del qq, got, want
    # an overflowing capacity keeps the plain version's exact prefix
    g = torch.Generator(device=DEVICE).manual_seed(4)
    qi = torch.randint(-9, 10, (2, 3, 300, 16), generator=g,
                       device=DEVICE).to(torch.int8)
    sdi = torch.full((2, 3, 2), 0.05, device=DEVICE)
    l1i = qi.float().abs().sum(-1) * 0.05
    sqi = (qi.float() ** 2).sum(-1) * 0.0025
    mi = torch.tensor([[1, 1, 0, 0, 300, 300], [1, 0, 0, 1, 280, 300],
                       [1, 0, 1, 2, 300, 250]], dtype=torch.int32,
                      device=DEVICE).expand(2, 3, 6).contiguous()
    kwi = dict(threshold=0.5, capacity=700, block_rows=300, metric="dot")
    a = ops.pairwise_threshold_q(qi, sdi, l1i, sqi, [0, 0, 1], [0, 1, 2], mi,
                                 **kwi)
    b = ref.pairwise_threshold_q(qi, sdi[..., 0], sdi[..., 1], l1i, sqi,
                                 [0, 0, 1], [0, 1, 2], mi, **kwi)
    check(bool((a[3] > 700).all()) and all(torch.equal(x, y)
                                           for x, y in zip(a, b)),
          "B7: the overflowing prefix differs from the plain version's")
    say(f"B7 overflow: counts {a[3].tolist()} > capacity 700, the kept "
        "prefix equals the plain version's")


def phase_selfcheck_knn() -> None:
    from repro_torch.core import knn, quant
    for p in (2, 5, 8):
        knn.selfcheck_main(p, device=DEVICE)
        quant.selfcheck_main(p, device=DEVICE)


def phase_knn(report: dict) -> None:
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.knn import knn_graph
    from repro_torch.kernels import ops

    comm = SingleProcessComm(P, DEVICE)
    X, xn, _thr = join_data()
    N = X.shape[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    g = knn_graph(X, comm, topk=KNN_TOPK, metric="l2", mode="batched",
                  placement="cyclic", use_kernel=True, quant="off")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    report["pairwise_topk"]["launches"] = counts["pairwise_topk"]
    check(counts["pairwise_topk"] > 0, "k-NN: B6 was never launched")
    check(g.indices.shape == (N, KNN_TOPK), "k-NN: wrong graph shape")
    gv = torch.as_tensor(g.scores, device=DEVICE)
    gi = torch.as_tensor(g.indices, device=DEVICE)
    check(bool(torch.isfinite(gv).all()), "k-NN: non-finite scores")
    rows = torch.arange(N, device=DEVICE)
    check(not bool((gi == rows[:, None]).any()), "k-NN: a row lists itself")
    n_diff = 0
    for r0 in range(0, N, 4096):
        r = rows[r0:r0 + 4096]
        s = l2_scores(X[r], X, xn)
        s[torch.arange(len(r), device=DEVICE), r] = -float("inf")
        wv, wi = torch.topk(s, KNN_TOPK)
        n_diff += check_topk_rows(X[r], X, xn, gv[r], gi[r], wv, wi,
                                  f"k-NN rows {r0}..")
    report["knn_graph"] = (gv, gi)
    say(f"knn N={N} d={JOIN_D} P={P} l2 top-{KNN_TOPK}: {secs:.3f} s (host "
        f"clock, synchronized), peak {peak / 2**30:.3f} GiB, B6 launches "
        f"{counts['pairwise_topk']}; against the brute force {n_diff} of "
        f"{gi.numel()} ids differ, all within the tie tolerance")


def phase_quant_join(report: dict) -> None:
    from repro_torch.core import quant
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.kernels import ops

    comm = SingleProcessComm(P, DEVICE)
    X, xn, thr = join_data()
    N = X.shape[0]
    f_i, f_j = report["join_pairs"]
    report["pairwise_threshold_q"]["launches"] = 0
    for qm in ("int8", "bf16"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        st: dict = {}
        t0 = time.perf_counter()
        res = quant.quant_similarity_join(
            X, comm, threshold=thr, quant=qm, metric="l2", mode="batched",
            placement="cyclic", capacity=JOIN_CAP0, use_kernel=True, stats=st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        report["pairwise_threshold_q"]["launches"] += \
            counts["pairwise_threshold_q"]
        check(counts["pairwise_threshold_q"] > 0,
              f"quantized join {qm}: B7 was never launched")
        got_i = torch.as_tensor(res.i, device=DEVICE)
        got_j = torch.as_tensor(res.j, device=DEVICE)
        check(bool((got_i < got_j).all()), f"quantized join {qm}: i >= j")
        n_diff = compare_pair_sets(X, xn, thr, got_i, got_j, f_i, f_j,
                                   f"quantized join {qm} vs the f32 join")
        check(torch.allclose(torch.as_tensor(res.scores, device=DEVICE),
                             hit_scores(X, xn, got_i, got_j),
                             rtol=SCORE_TOL, atol=SCORE_TOL),
              f"quantized join {qm}: scores")
        say(f"quantized join {qm} N={N} P={P} l2 threshold {thr:.6g}: "
            f"{res.n_pairs} pairs in {secs:.3f} s (host clock, synchronized),"
            f" peak {peak / 2**30:.3f} GiB; band emitted {st['emitted']}, "
            f"kept {st['kept']}, certain {st['certain']}, escalations "
            f"{st['escalations']} (capacity {JOIN_CAP0} to {res.capacity}); "
            f"B7 launches {counts['pairwise_threshold_q']}; {n_diff} pairs "
            f"differ from the f32 join's {f_i.numel()} (all within the "
            "threshold tolerance)")
    k = build_schedule(P).k
    sizes = {m: quant.corpus_bytes_per_device(N, JOIN_D, P, k, m)
             for m in ("off", "int8", "bf16")}
    say("corpus_bytes_per_device N=%d d=%d P=%d k=%d: f32 %d B, int8 %d B "
        "(%.2fx less), bf16 %d B (%.2fx less)" % (
            N, JOIN_D, P, k, sizes["off"], sizes["int8"],
            sizes["off"] / sizes["int8"], sizes["bf16"],
            sizes["off"] / sizes["bf16"]))


def phase_quant_knn(report: dict) -> None:
    from repro_torch.core import quant
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.placement import get_placement
    from repro_torch.kernels import ops

    comm = SingleProcessComm(P, DEVICE)
    X, xn, _thr = join_data()
    N = X.shape[0]
    fv, fi = report["knn_graph"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    st: dict = {}
    t0 = time.perf_counter()
    g = quant.quant_knn_graph(X, comm, topk=KNN_TOPK, quant="int8",
                              metric="l2", mode="batched",
                              placement="cyclic", use_kernel=True, stats=st)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    report["pairwise_topk_q"]["launches"] = counts["pairwise_topk_q"]
    check(counts["pairwise_topk_q"] > 0, "quantized k-NN: B8 never launched")
    gv = torch.as_tensor(g.scores, device=DEVICE)
    gi = torch.as_tensor(g.indices, device=DEVICE)
    check(gi.shape == (N, KNN_TOPK), "quantized k-NN: wrong graph shape")
    n_diff = 0
    rows = torch.arange(N, device=DEVICE)
    for r0 in range(0, N, 4096):
        r = rows[r0:r0 + 4096]
        n_diff += check_topk_rows(X[r], X, xn, gv[r], gi[r], fv[r], fi[r],
                                  f"quantized k-NN rows {r0}.. vs f32")
    passes = ", ".join(f"M={m}: {n} pending" for m, n in st["passes"])
    # each pass's device sweep alone (B8 and the scatter merges); the rest
    # of the run is the host's certification and f32 rescoring
    qb = quant.quantize_corpus(X, P, N // P, "int8").blocks()
    sweeps = []
    for m, _n in st["passes"]:
        sweep = quant._qknn_fn(comm, N, N // P, m, "l2", "batched", True,
                               get_placement("cyclic", P))
        sweeps.append((m, cuda_ms(lambda: sweep(qb), reps=1, warmup=0)))
    sweep_s = sum(ms for _m, ms in sweeps) / 1e3
    say(f"quantized k-NN int8 N={N} P={P} l2 top-{KNN_TOPK}: {secs:.3f} s "
        f"(host clock, synchronized), peak {peak / 2**30:.3f} GiB, passes "
        f"[{passes}], B8 launches {counts['pairwise_topk_q']}; each pass's "
        f"sweep alone (CUDA events) "
        f"{', '.join(f'M={m}: {ms:.1f} ms' for m, ms in sweeps)}, "
        f"{sweep_s:.3f} s in all, the rest {secs - sweep_s:.3f} s; against "
        f"the f32 graph {n_diff} ids differ, all within the tie tolerance")


def phase_quant_serving() -> None:
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.quant import _query_q_fn, serving_query
    from repro_torch.serving import ServingCorpus

    comm = SingleProcessComm(P, DEVICE)
    X, queries, fresh, _thr_q = serving_data()
    xn = (X * X).sum(-1)
    batches = range(2 * QSERVE_BATCHES)
    # the f32 path's answers (B4), before and after the replace
    sc = ServingCorpus.build(X, comm, placement="cyclic")
    f32_stack = sc.state.stack[0].numel() * sc.state.stack.element_size()
    want = {}
    for b in batches:
        if b == QSERVE_BATCHES:
            sc.replace_block(REPLACED_BLOCK, fresh)
        want[b] = sc.query(queries[b], topk=SERVE_TOPK, metric="l2",
                           use_kernel=True)
    del sc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scq = ServingCorpus.build(X, comm, placement="cyclic", quant="int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got, lat = {}, []
    for b in batches:
        if b == QSERVE_BATCHES:
            t0 = time.perf_counter()
            scq.replace_block(REPLACED_BLOCK, fresh)
            torch.cuda.synchronize()
            replace_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got[b] = scq.query(queries[b], topk=SERVE_TOPK, metric="l2")
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    q_stack = scq.quant.stack_bytes_per_device()
    # the M passes of one microbatch, and the device sweep of its last one
    st: dict = {}
    serving_query(scq, queries[0], topk=SERVE_TOPK, metric="l2", stats=st)
    m_last = st["passes"][-1][0]
    sweep = _query_q_fn(comm, m_last, "auto", "l2", scq.placement)
    one_pass = cuda_ms(lambda: sweep(queries[0], scq.quant.stacks,
                                     scq.state.stack_valid), reps=2)
    n_diff = 0
    block = SERVE_N // P
    for b in batches:
        if b == QSERVE_BATCHES:
            X[REPLACED_BLOCK * block:(REPLACED_BLOCK + 1) * block] = fresh
            xn = (X * X).sum(-1)
        v, i = got[b]
        n_diff += check_topk_rows(queries[b], X, xn, v, i, *want[b],
                                  f"quantized serving microbatch {b}")
    p50 = float(np.percentile(lat, 50))
    say(f"quantized serving int8 N={SERVE_N} d={SERVE_D} P={P}: build "
        f"{build_s:.2f} s; {len(lat)} microbatches of Q={SERVE_Q} l2 top-"
        f"{SERVE_TOPK} ({QSERVE_BATCHES} before and {QSERVE_BATCHES} after "
        f"replace_block({REPLACED_BLOCK}), {replace_ms:.1f} ms): "
        f"{', '.join(f'{t:.2f}' for t in lat)} ms, p50 {p50:.3f} ms (host "
        f"clock, synchronized); M passes of microbatch 0: "
        f"{', '.join(f'M={m}: {n} pending' for m, n in st['passes'])}; the "
        f"quantized sweep at M={m_last} {one_pass:.2f} ms (CUDA events); "
        "resident "
        "quantized stack "
        f"{q_stack / 2**20:.1f} MiB per device vs f32 "
        f"{f32_stack / 2**20:.1f} MiB; peak {peak / 2**30:.3f} GiB; {n_diff}"
        " ids differ from the f32 path's, all within the tie tolerance")


# ---------------------------------------------------------------------------
# B9 flash attention, quorum / ring attention; B10, mamba2-130m
# ---------------------------------------------------------------------------

def attn_inputs(dtype, seed: int, T: int = ATTN_T, device=None):
    """q [B, T, H, hd], k / v [B, T, KV, hd] of N(0, 1) values, made on
    the card (``device``, default DEVICE) from a seed."""
    device = device or DEVICE
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(heads):
        return torch.randn(ATTN_B, T, heads, ATTN_HD, generator=g,
                           device=device).to(dtype)
    return rnd(ATTN_H), rnd(ATTN_KV), rnd(ATTN_KV)


def plain_flash_block_rows(q, k, v, causal: bool, rows: int = 512):
    """ref.flash_block over row chunks of q (the full [.., 4096, 4096]
    score tensor would not fit twice): rows r0:r1 against keys :r1 with
    the end-aligned mask are rows r0:r1 of the causal block."""
    from repro_torch.kernels import ref
    outs = []
    for r0 in range(0, q.shape[1], rows):
        r1 = min(q.shape[1], r0 + rows)
        kk, vv = (k[:, :r1], v[:, :r1]) if causal else (k, v)
        outs.append(ref.flash_block(q[:, r0:r1], kk, vv, causal=causal))
    return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))


def f64_flash_block_rows(q, k, v, rows: int = 512):
    """The causal flash block (o, m, l) of ``ref.flash_block`` evaluated in
    float64 by row chunks and rounded to float32 (the truth the f32
    partials are read against at large scores)."""
    from repro_torch.kernels import ref
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    outs = []
    for r0 in range(0, Tq, rows):
        r1 = min(Tq, r0 + rows)
        qg = q[:, r0:r1].double().reshape(B, r1 - r0, KV, H // KV, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg / math.sqrt(hd),
                         k[:, :r1].double())
        vis = ref.causal_visible(Tq, Tq, q.device)[r0:r1, :r1]
        s = torch.where(vis, s, -1e30)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        o = torch.einsum("bkgqs,bskh->bkgqh", p, v[:, :r1].double())
        outs.append((o.reshape(B, H, r1 - r0, hd).permute(0, 2, 1, 3),
                     m.reshape(B, H, r1 - r0).permute(0, 2, 1),
                     p.sum(-1).reshape(B, H, r1 - r0).permute(0, 2, 1)))
    return tuple(torch.cat([o[i] for o in outs], 1).float() for i in range(3))


def partial_share(got, want) -> float:
    """Worst share of the f32 partials' rule over (o, m, l): 1e-5 |want| +
    1e-5 max(1, max |want|) for o, 1e-5 |want| + 1e-5 for m and l."""
    return max(float(((a - w).abs() / (1e-5 * w.abs() + 1e-5 * (
        max(1.0, float(w.abs().max())) if i == 0 else 1.0))).max())
        for i, (a, w) in enumerate(zip(got, want)))


def flash_errs(got, want) -> tuple[float, float]:
    """(max abs err of the normalized output o / l, max abs err of m)."""
    go = got[0] / got[2].clamp_min(1e-30)[..., None]
    wo = want[0] / want[2].clamp_min(1e-30)[..., None]
    return float((go - wo).abs().max()), float((got[1] - want[1]).abs().max())


def flash_ops(rows: int, Tq: int, Tk: int, heads: int, hd: int,
              causal: bool) -> float:
    """Operations of attention over visible (query, key) pairs: 2 hd for
    q.k and 2 hd for p.v."""
    if causal:
        pairs = sum(min(Tk, i + Tk - Tq + 1) for i in range(Tq))
    else:
        pairs = Tq * Tk
    return 4.0 * hd * pairs * rows * heads


def sampled_plain_rows(q, k, v):
    """(row ranges, plain f32 causal attention of those rows): the first
    and last ATTN_SAMPLE rows of each of the P sequence blocks."""
    from repro_torch.kernels import ref
    blk = ATTN_T // P
    ranges = []
    for b in range(P):
        ranges += [(b * blk, b * blk + ATTN_SAMPLE),
                   ((b + 1) * blk - ATTN_SAMPLE, (b + 1) * blk)]
    want = [ref.flash_attention(q[:, r0:r1].float(), k[:, :r1].float(),
                                v[:, :r1].float(), causal=True)
            for r0, r1 in ranges]
    return ranges, want


def out_err(got, want) -> tuple[float, float]:
    """(max abs err, worst ratio of |got - want| to its limit) of an
    attention output against ``want``; the check is ratio <= 1."""
    rel = BF16_REL if torch.bfloat16 in (got.dtype, want.dtype) else 0.0
    got, want = got.float(), want.float()
    d = (got - want).abs()
    return (float(d.max()),
            float((d / (rel * want.abs() + FLASH_ATOL)).max()))


def b9_sampled_rows(q, k, v) -> tuple:
    """B9 (causal) on a prefill's q / k / v against kernels/ref.py's f32
    plain attention on the first, middle and last QWEN_SAMPLE query rows,
    under phase 16's rule (2^-7 |want| + 1e-5).  ref's causal mask is
    end-aligned, so rows r0:r1 against keys :r1 are rows r0:r1 of the
    whole sequence.  Returns (B9's output, max abs err, worst ratio)."""
    from repro_torch.kernels import ops
    out = ops.flash_attention(q, k, v, causal=True)
    T = q.shape[1]
    errs = [out_err(out[:, r0:r0 + QWEN_SAMPLE],
                    ref_attention(q[:, r0:r0 + QWEN_SAMPLE],
                                  k[:, :r0 + QWEN_SAMPLE],
                                  v[:, :r0 + QWEN_SAMPLE], True))
            for r0 in (0, (T - QWEN_SAMPLE) // 2, T - QWEN_SAMPLE)]
    return out, max(e[0] for e in errs), max(e[1] for e in errs)


def sampled_err(out, ranges, want) -> tuple[float, float]:
    errs = [out_err(out[:, r0:r1], w) for (r0, r1), w in zip(ranges, want)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def ssd_inputs(seed: int, Bsz: int, T: int):
    """B10's inputs at mamba2-130m's widths: x, B and C as strided views
    into one projection [Bsz, T, d_inner + 2 N] (as ``models/ssm.py``
    passes them), dt in [0.01, 0.2], A in -[0.5, 2] (tests/test_kernels.py's
    ranges)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    H, Pd, N = SSM_HEADS, SSM_HEAD_DIM, SSM_STATE
    xBC = torch.randn(Bsz, T, H * Pd + 2 * N, generator=g, device=DEVICE)
    x = xBC[..., :H * Pd].unflatten(-1, (H, Pd))
    Bm, Cm = xBC[..., H * Pd:H * Pd + N], xBC[..., H * Pd + N:]
    dt = 0.01 + 0.19 * torch.rand(Bsz, T, H, generator=g, device=DEVICE)
    A = -(0.5 + 1.5 * torch.rand(H, generator=g, device=DEVICE))
    return x, dt, A, Bm, Cm


def phase_kernels_lm(report: dict) -> None:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import route_of

    # ---- B9 at one quorum pair: [P*B, 4096, 40 | 8, 128] ---------------
    blk = ATTN_T // P
    rows_b = P * ATTN_B
    res = {}
    tol = FLASH_PART_TOL
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=DEVICE).manual_seed(21)
        q = torch.randn(rows_b, blk, ATTN_H, ATTN_HD, generator=g,
                        device=DEVICE).to(dtype)
        k = torch.randn(rows_b, blk, ATTN_KV, ATTN_HD, generator=g,
                        device=DEVICE).to(dtype)
        v = torch.randn(rows_b, blk, ATTN_KV, ATTN_HD, generator=g,
                        device=DEVICE).to(dtype)
        for causal in (False, True):
            got = ops.flash_block(q, k, v, causal=causal)
            want = plain_flash_block_rows(q, k, v, causal)
            err, m_err = flash_errs(got, want)
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  "B9: non-finite partial")
            check(err < tol and m_err < tol,
                  f"B9 {dtype} causal={causal}: max abs err {err:.3e} (m "
                  f"{m_err:.3e}) >= {tol}")
            l_rel = float(((got[2] - want[2]).abs()
                           / want[2].clamp_min(1e-30)).max())
            check(l_rel < tol, f"B9: row sums rel err {l_rel:.3e} >= {tol}")
            ms = cuda_ms(lambda: ops.flash_block(q, k, v, causal=causal))
            plain_ms = cuda_ms(lambda: plain_flash_block_rows(q, k, v,
                                                              causal),
                               reps=1, warmup=0)
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qs, ks, vs, is_causal=causal,
                                 enable_gqa=True))
            # which backends take these inputs (the default picks one)
            backends = []
            from torch.nn.attention import SDPBackend, sdpa_kernel
            for be in (SDPBackend.FLASH_ATTENTION,
                       SDPBackend.EFFICIENT_ATTENTION):
                try:
                    with sdpa_kernel([be]):
                        be_ms = cuda_ms(lambda: torch.nn.functional
                                        .scaled_dot_product_attention(
                                            qs, ks, vs, is_causal=causal,
                                            enable_gqa=True), reps=1)
                    backends.append(f"{be.name.lower()} alone {be_ms:.3f} ms")
                except RuntimeError:
                    backends.append(f"{be.name.lower()} refuses them")
            del qs, ks, vs
            n_ops = flash_ops(rows_b, blk, blk, ATTN_H, ATTN_HD, causal)
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
                else PEAK_FP32_FLOPS
            b_ms, b_by = bound(nbytes(q, k, v, *got), n_ops, peak)
            route = route_of(dtype)
            # the wgmma route issues 6 hd tensor operations per visible
            # pair (P V as P_hi V + P_lo V), the algorithm's bound 4 hd;
            # the tf32x3 route three TF32 products a multiply-add, 12 hd
            split_ms = (bound(nbytes(q, k, v, *got), 3 * n_ops,
                              PEAK_TF32_FLOPS)[0]
                        if route == "tf32x3" else None)
            work = (f"; the split issues {1.5 * n_ops:.3e} tensor operations"
                    f", {bound(0, 1.5 * n_ops, peak)[0]:.3f} ms"
                    if route == "wgmma" else
                    f" ({b_ms / ms:.3f} of it); the split's bound "
                    f"{split_ms:.3f} ms ({3 * n_ops:.3e} TF32 operations at "
                    f"495 TFLOP/s; {split_ms / ms:.3f} of it)")
            res[(dtype, causal)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, bound_split_ms=split_ms)
            say(f"B9 flash_attention partial {str(dtype)[6:]} ({route} "
                f"kernel) causal="
                f"{causal} q {tuple(q.shape)} kv {tuple(k.shape)}: max_abs"
                f"_err={err:.3e} (m {m_err:.3e}, l rel {l_rel:.3e}; < {tol})"
                f" kernel {ms:.3f} ms ({n_ops / ms / 1e9:.1f} TFLOP/s), "
                f"plain {plain_ms:.3f} ms (row chunks), sdpa {lib_ms:.3f} "
                f"ms ({', '.join(backends)}), bound {b_ms:.3f} ms ({b_by}, {n_ops:.3e} operations on "
                f"{'bf16 tensor cores' if peak == PEAK_BF16_FLOPS else 'fp32'}"
                f"{work})")
            del got, want
        del q, k, v
    # the main path's common launch: a full (non-diagonal) pair in bf16;
    # beside it the f32 route and scaled_dot_product_attention on the same
    # f32 tensors (enable_gqa, TF32 off), full and causal
    report["flash_attention"] = dict(res[(torch.bfloat16, False)])
    for causal, tag in ((False, "f32_"), (True, "f32_causal_")):
        r32 = res[(torch.float32, causal)]
        report["flash_attention"].update({
            tag + "ms": r32["ms"], tag + "library_ms": r32["library_ms"],
            tag + "bound_ms": r32["bound_ms"],
            tag + "bound_split_ms": r32["bound_split_ms"],
            tag + "max_abs_err": r32["max_abs_err"]})
    say("B9 f32 route (csrc/flash_attention.cu, tf32x3) beside sdpa on the "
        "same f32 tensors (enable_gqa, TF32 off): "
        + ", ".join(
            f"{tag} {r['ms']:.3f} vs {r['library_ms']:.3f} ms (bounds: fp32 "
            f"{r['bound_ms']:.3f} ms, {r['bound_ms'] / r['ms']:.3f} of it; "
            f"split {r['bound_split_ms']:.3f} ms, "
            f"{r['bound_split_ms'] / r['ms']:.3f})"
            for tag, r in (("full", res[(torch.float32, False)]),
                           ("causal", res[(torch.float32, True)]))))

    # ---- B9 f32 (tf32x3) partials at large scores: q and k scaled so the
    # scores' std is 8 and 22.6 (a near one-hot softmax, scores up to ~90).
    # There the plain version's own float32 error is most of the 1e-5
    # rule, so the kernel is held to a float64 evaluation: within the
    # rule, or within the plain version's own share of it where that
    # exceeds 1 (tests/test_torch_flash_tf32x3.py models the same) ----
    g = torch.Generator(device=DEVICE).manual_seed(24)
    q, k, v = (torch.randn(1, blk, h, ATTN_HD, generator=g, device=DEVICE)
               for h in (8, 2, 2))
    large = []
    for big in (4.0, 8.0):
        qb, kb = q * big, k * big ** 0.5
        got = ops.flash_block(qb, kb, v, causal=True)
        want = plain_flash_block_rows(qb, kb, v, True)
        exact = f64_flash_block_rows(qb, kb, v)
        check(all(bool(torch.isfinite(t).all()) for t in got),
              "B9 f32 at large scores: non-finite partial")
        k64, p64 = partial_share(got, exact), partial_share(want, exact)
        kp = partial_share(got, want)
        check(k64 <= max(1.0, p64), f"B9 f32 at scores of std "
              f"{big ** 1.5:.1f}: {k64:.3f} of the 1e-5 partial rule against "
              f"float64 (the plain version {p64:.3f})")
        large.append((big ** 1.5, k64, p64, kp))
        del got, want, exact, qb, kb
    report["flash_attention"]["f32_large_score_shares"] = large
    say(f"B9 f32 (tf32x3) partials q {tuple(q.shape)} kv {tuple(k.shape)} "
        "causal at large scores, shares of the 1e-5 rule (kernel against "
        "float64, plain f32 against float64, kernel against plain): "
        + "; ".join(f"std {sd:.1f}: {a:.3f}, {b:.3f}, {c:.3f}"
                    for sd, a, b, c in large))
    del q, k, v

    # ---- B9 bf16 partials at hd 256 over a whole 4,096-key block: 128
    # tiles of 32 keys, each tile's P V joining O by one f32 fmaf --------
    g = torch.Generator(device=DEVICE).manual_seed(23)
    q, k, v = (torch.randn(1, blk, h, 256, generator=g, device=DEVICE)
               .to(torch.bfloat16) for h in (2, 1, 1))
    for causal in (False, True):
        got = ops.flash_block(q, k, v, causal=causal)
        want = plain_flash_block_rows(q, k, v, causal)
        err, m_err = flash_errs(got, want)
        l_rel = float(((got[2] - want[2]).abs()
                       / want[2].clamp_min(1e-30)).max())
        check(all(bool(torch.isfinite(t).all()) for t in got)
              and err < tol and m_err < tol and l_rel < tol,
              f"B9 bf16 hd 256 causal={causal}: max abs err {err:.3e} (m "
              f"{m_err:.3e}, l rel {l_rel:.3e}) >= {tol}")
        say(f"B9 flash_attention partial bf16 hd 256 causal={causal} q "
            f"{tuple(q.shape)} kv {tuple(k.shape)}: max_abs_err={err:.3e} "
            f"(m {m_err:.3e}, l rel {l_rel:.3e}; < {tol})")
        del got, want
    del q, k, v

    # ---- B10 at mamba2-130m's prefill ([4, 32768, 24, 64], chunk 256)
    # and at each decode step's shape ([4, 1, 24, 64], chunk 1) ---------
    errs = []
    for label, Bsz, T, L in (("prefill", SSM_PREFILL_B, SSM_PREFILL_T,
                              SSM_CHUNK),
                             ("decode", SERVE_LM_BATCH, 1, 1)):
        x, dt, A, Bm, Cm = ssd_inputs(22, Bsz, T)
        got = ops.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=L)
        want = ref.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=L)
        e = []
        for name, gt, wt in zip(("y", "S", "cd"), got, want):
            check(gt.shape == wt.shape and bool(torch.isfinite(gt).all()),
                  f"B10 {label}: {name} of the wrong shape or not finite")
            check(torch.allclose(gt, wt, rtol=1e-4, atol=1e-4),
                  f"B10 {label}: {name} not within rtol / atol 1e-4 (max "
                  f"abs err {float((gt - wt).abs().max()):.3e})")
            e.append(float((gt - wt).abs().max()))
        errs += e
        del want
        again = ops.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=L)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"B10 {label}: two launches on the same inputs differ")
        del again
        if L > 1:
            ms = cuda_ms(lambda: ops.ssd_intra_chunk(x, dt, A, Bm, Cm,
                                                     chunk=L))
        else:
            # a decode step's launch is shorter than the host's call: time
            # it queued, and beside it as the events around 50 calls read
            # it while the host sets the pace
            ms, host_ms, spin_ms = queued_ms(
                lambda: ops.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=L))
            paced_ms = cuda_ms(lambda: ops.ssd_intra_chunk(
                x, dt, A, Bm, Cm, chunk=L), reps=50)
        plain_ms = cuda_ms(lambda: ref.ssd_intra_chunk(x, dt, A, Bm, Cm,
                                                       chunk=L),
                           reps=1, warmup=0)
        H, Pd = x.shape[2:]
        N = Bm.shape[-1]
        nc = T // L
        cells = Bsz * H * nc
        tri = L * (L + 1) // 2
        # C B^T below the diagonal once per (batch row, chunk): B and C are
        # one group for every head; per head the product with x and S
        n_ops = (Bsz * nc * 2.0 * N * tri
                 + cells * (2.0 * Pd * tri + 2.0 * L * N * Pd))
        b_ms, b_by = bound(nbytes(x, dt, A, Bm, Cm, *got), n_ops)
        # the same count with C B^T repeated per head
        per_head_ms, _ = bound(nbytes(x, dt, A, Bm, Cm, *got), n_ops
                               + (cells - Bsz * nc) * 2.0 * N * tri)
        ref_note = (f" ({DECODE_REPS} launches queued behind a "
                    f"{spin_ms:.1f} ms spin, {host_ms:.4f} ms each to "
                    f"enqueue; the events around 50 unqueued calls read "
                    f"{paced_ms:.4f} ms, the host's pace)" if L == 1 else "")
        say(f"B10 ssd_chunk {label} x {tuple(x.shape)} B/C "
            f"{tuple(Bm.shape)} chunk {L} ({cells} cells): max_abs_err y "
            f"{e[0]:.3e}, S {e[1]:.3e}, cd {e[2]:.3e} (rtol / atol 1e-4), "
            f"bit-equal across two launches; kernel {ms:.4f} ms{ref_note} "
            f"({n_ops / ms / 1e9:.3f} TFLOP/s), plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {n_ops:.4e} operations; with "
            f"C B^T counted per head {per_head_ms:.4f} ms)")
        if label == "prefill":
            # the row of the kernels line: prefill's launch, the costly one
            report["ssd_chunk"] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by,
                                       library_ms=None)
        else:
            report["ssd_chunk"].update(decode_ms=ms, decode_plain_ms=plain_ms,
                                       decode_bound_ms=b_ms)
        del x, dt, A, Bm, Cm, got
    report["ssd_chunk"]["max_abs_err"] = max(errs)


def phase_attention(report: dict) -> None:
    from repro_torch.apps.attention import distributed_attention
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import route_of
    from repro_torch.obs import trace as obs_trace

    comm = SingleProcessComm(P, DEVICE)
    for dtype in (torch.bfloat16, torch.float32):
        lim = (f"|diff| <= {'2^-7 |want| + ' if dtype == torch.bfloat16 else ''}"
               f"{FLASH_ATOL:g}")
        q, k, v = attn_inputs(dtype, 23)
        ranges, want = sampled_plain_rows(q, k, v)
        outs = {}
        for strategy in ("quorum", "ring"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tr = obs_trace.configure(metrics_only=True)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                out = distributed_attention(q, k, v, comm, strategy=strategy)
                torch.cuda.synchronize()
            finally:
                obs_trace.reset()
            ms = (time.perf_counter() - t0) * 1e3
            n = ops.launch_counts()["flash_attention"]
            peak = torch.cuda.max_memory_allocated() - base
            check(n > 0, f"{strategy} attention: B9 was never launched")
            check(out.shape == q.shape and out.dtype == dtype
                  and bool(torch.isfinite(out).all()),
                  f"{strategy} attention: wrong shape / dtype or not finite")
            if strategy == "quorum" and dtype == torch.bfloat16:
                report["flash_attention"]["quorum_launches"] = n
            if dtype == torch.float32:   # the tf32x3 route end to end
                report["flash_attention"].update({
                    f"f32_{strategy}_ms": ms,
                    f"f32_{strategy}_launches": n})
            moved = sum(tr.counter_total(f"comm.ppermute.{c}")
                        for c in ("gather_bytes", "scatter_bytes",
                                  "ring_bytes"))
            s_err, s_ratio = sampled_err(out, ranges, want)
            check(s_ratio <= 1, f"{strategy} attention: sampled rows vs f32 "
                  f"plain attention max abs err {s_err:.3e}, {s_ratio:.3f} "
                  f"times the limit {lim}")
            outs[strategy] = out
            say(f"{strategy} attention {str(dtype)[6:]} (B9 "
                f"{route_of(dtype)} kernel) B={ATTN_B} "
                f"T={ATTN_T} H={ATTN_H} KV={ATTN_KV} hd={ATTN_HD} P={P}: "
                f"{ms:.1f} ms (host clock, synchronized), peak "
                f"{peak / 2**30:.3f} GiB above the inputs, B9 launches {n}, "
                f"comm {moved / 2**20:.1f} MiB per device (gather "
                f"{tr.counter_total('comm.ppermute.gather_bytes') / 2**20:.1f}"
                f", scatter "
                f"{tr.counter_total('comm.ppermute.scatter_bytes') / 2**20:.1f}"
                f", ring "
                f"{tr.counter_total('comm.ppermute.ring_bytes') / 2**20:.1f})"
                f"; sampled rows vs f32 plain max abs err {s_err:.3e} "
                f"({s_ratio:.3f} of the limit)")
        d, d_ratio = out_err(outs["quorum"], outs["ring"])
        check(d_ratio <= 1, f"quorum vs ring attention: max abs diff "
              f"{d:.3e}, {d_ratio:.3f} times the limit {lim}")
        whole = ops.flash_attention(q, k, v, causal=True)
        w_err, w_ratio = out_err(outs["quorum"], whole)
        check(w_ratio <= 1, f"quorum attention vs whole-sequence B9: max "
              f"abs diff {w_err:.3e}, {w_ratio:.3f} times the limit {lim}")
        ws_err, ws_ratio = sampled_err(whole, ranges, want)
        check(ws_ratio <= 1, f"whole-sequence B9 vs f32 plain rows: "
              f"{ws_err:.3e}, {ws_ratio:.3f} times the limit {lim}")
        whole_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                           reps=2)
        sdpa = "not timed (in f32 it takes the math backend, whose score " \
            "tensor needs 160 GiB)"
        if dtype == torch.bfloat16:
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = "{:.3f} ms".format(cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True), reps=2))
            del qs, ks, vs
        n_ops = flash_ops(ATTN_B, ATTN_T, ATTN_T, ATTN_H, ATTN_HD, True)
        peak_rate = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
            else PEAK_FP32_FLOPS
        b_ms, b_by = bound(nbytes(q, k, v, whole), n_ops, peak_rate)
        say(f"attention {str(dtype)[6:]}: quorum vs ring max abs diff "
            f"{d:.3e} ({d_ratio:.3f} of the limit), quorum vs whole-sequence"
            f" B9 {w_err:.3e} ({w_ratio:.3f}), whole-sequence B9 vs sampled "
            f"f32 plain rows {ws_err:.3e} ({ws_ratio:.3f}; limit {lim}); "
            f"whole-sequence B9 (ops.flash_attention, causal) {whole_ms:.3f}"
            f" ms ({n_ops / whole_ms / 1e9:.1f} TFLOP/s), sdpa causal "
            f"{sdpa}, bound {b_ms:.3f} ms ({b_by})")
        del q, k, v, outs, whole, want


def phase_mamba_prefill(report: dict) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import lm

    cfg = get_config("mamba2_130m")
    n_params = lm.count_params(cfg)
    check(n_params == 128_983_488, f"mamba2-130m has {n_params} parameters")
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    prefill = build_prefill_step(cfg)
    g = torch.Generator(device=DEVICE).manual_seed(24)
    toks = torch.randint(0, cfg.vocab_size, (SSM_PREFILL_B, SSM_PREFILL_T),
                         generator=g, device=DEVICE)
    prefill(params, {"tokens": toks[:, :SSM_CHUNK]})      # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = ops.launch_counts()["ssd_chunk"]
    peak = torch.cuda.max_memory_allocated()
    report["ssd_chunk"]["launches"] = n
    check(n == cfg.n_layers, f"prefill: B10 launched {n} times, expected "
          f"{cfg.n_layers}")
    check(logits.shape == (SSM_PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "prefill: logits of the wrong shape or not finite")
    say(f"mamba2-130m prefill {SSM_PREFILL_B} x {SSM_PREFILL_T} tokens "
        f"({n_params} parameters, bf16): {secs * 1e3:.1f} ms (host clock, "
        f"synchronized), {SSM_PREFILL_B * SSM_PREFILL_T / secs:.0f} tokens/s,"
        f" peak {peak / 2**30:.3f} GiB, B10 launches {n}")
    del logits

    # decode == prefill at SSM_CHECK_T tokens: bf16 within 2e-2 of the
    # largest logit (tests/test_models.py's 2e-2, scaled), and an f32 copy
    # within 1e-4 of it
    short = toks[:2, :SSM_CHECK_T]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = lm.params_from_numpy(
        cfg32, _tree_to_numpy(params), device=DEVICE)
    for c, p, label in ((cfg, params, "bf16"), (cfg32, params32, "f32")):
        want = build_prefill_step(c)(p, {"tokens": short})
        state = lm.init_decode_state(c, short.shape[0], SSM_CHECK_T,
                                     device=DEVICE)
        step = build_serve_step(c)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for t in range(SSM_CHECK_T):
            lg, state = step(p, state, short[:, t:t + 1])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / SSM_CHECK_T
        n_dec = ops.launch_counts()["ssd_chunk"]
        check(n_dec == SSM_CHECK_T * c.n_layers,
              f"decode: {n_dec} B10 launches over {SSM_CHECK_T} steps")
        d = float((lg[:, -1] - want).abs().max())
        rel = 2e-2 if label == "bf16" else 1e-4
        lim = rel * max(1.0, float(want.abs().max()))
        check(d < lim, f"decode vs prefill ({label}) at {SSM_CHECK_T} "
              f"tokens: max abs diff {d:.3e} >= {lim:.3e}")
        say(f"mamba2-130m {label} decode vs prefill at {SSM_CHECK_T} tokens:"
            f" last-position logits max abs diff {d:.3e} (< {lim:.3e}), "
            f"max |logit| {float(want.abs().max()):.3f}; {n_dec} "
            f"single-step B10 launches, {step_ms:.3f} ms per step")
        # the same model on the CPU through the plain path
        p_cpu = lm.params_from_numpy(c, _tree_to_numpy(p), device="cpu")
        t0 = time.perf_counter()
        cpu = build_prefill_step(c)(p_cpu, {"tokens": short[:1].cpu()})
        cpu_s = time.perf_counter() - t0
        d_cpu = float((want[:1].cpu() - cpu).abs().max())
        lim = rel * max(1.0, float(cpu.abs().max()))
        check(d_cpu < lim, f"card vs CPU prefill ({label}): max abs diff "
              f"{d_cpu:.3e} >= {lim:.3e}")
        say(f"mamba2-130m {label} prefill at {SSM_CHECK_T} tokens, card vs "
            f"the CPU plain path: last-position logits max abs diff "
            f"{d_cpu:.3e} (< {lim:.3e}); CPU {cpu_s:.1f} s")
        del p_cpu, state


def _tree_to_numpy(tree):
    return {k: _tree_to_numpy(v) if isinstance(v, dict)
            else v.float().cpu().numpy() for k, v in tree.items()}


def phase_mamba_serve() -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    cfg = get_config("mamba2_130m")
    serve("mamba2_130m", smoke=False, batch=SERVE_LM_BATCH, prompt_len=4,
          gen_len=4, seed=1, device=DEVICE)                    # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    seqs = serve("mamba2_130m", smoke=False, batch=SERVE_LM_BATCH,
                 prompt_len=SERVE_LM_PROMPT, gen_len=SERVE_LM_GEN, seed=0,
                 device=DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = SERVE_LM_PROMPT + SERVE_LM_GEN - 1
    n = ops.launch_counts()["ssd_chunk"]
    check(seqs.shape == (SERVE_LM_BATCH, SERVE_LM_PROMPT + SERVE_LM_GEN),
          f"serve: sequences of shape {seqs.shape}")
    check(((seqs >= 0) & (seqs < cfg.vocab_size)).all(),
          "serve: a token outside the vocabulary")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SERVE_LM_BATCH, SERVE_LM_PROMPT))
    check((seqs[:, :SERVE_LM_PROMPT] == prompt).all(),
          "serve: the teacher-forced prompt was not kept")
    check(n == steps * cfg.n_layers,
          f"serve: {n} B10 launches over {steps} steps, expected "
          f"{cfg.n_layers} per step")
    say(f"mamba2-130m serve batch {SERVE_LM_BATCH}, prompt "
        f"{SERVE_LM_PROMPT}, gen {SERVE_LM_GEN}: {secs:.3f} s with parameter "
        f"init (host clock, synchronized), {n / steps:.0f} B10 launches per "
        f"step over {steps} steps")


# ---------------------------------------------------------------------------
# The continuous-batching front end, delta churn, fault-tolerant sweeps
# ---------------------------------------------------------------------------

def phase_batching() -> None:
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import IDX_SENTINEL, NEG_INF
    from repro_torch.launch.query_serve import serve_queries
    from repro_torch.serving import ServingCorpus
    from repro_torch.serving.batching import BatchScheduler, latency_summary

    comm = SingleProcessComm(P, DEVICE)
    X, queries, _fresh, _thr_q = serving_data()
    sc = ServingCorpus.build(X, comm, placement="cyclic")
    sched = BatchScheduler(sc, max_batch=SERVE_Q, pad_queries_to=SERVE_Q,
                           use_kernel=True)
    drain_q = queries[:SERVE_BATCHES].reshape(-1, SERVE_D)
    # warm-up: one microbatch through a throwaway scheduler
    serve_queries(sc, queries[SERVE_BATCHES], microbatch=SERVE_Q,
                  topk=SERVE_TOPK, metric="l2", use_kernel=True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vals, idx, qps = serve_queries(
        sc, drain_q, microbatch=SERVE_Q, topk=SERVE_TOPK, metric="l2",
        use_kernel=True, stream_every=BATCH_STREAM_EVERY,
        rng=np.random.default_rng(20), scheduler=sched)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["query_topk"]
    st = sched.stats()
    lat = latency_summary(sched.latencies_s)
    check(launches == SERVE_BATCHES == st["launches"],
          f"batching: {launches} B4 launches for {SERVE_BATCHES} microbatches")
    check(vals.shape == (SERVE_BATCHES * SERVE_Q, SERVE_TOPK)
          and np.isfinite(vals).all() and st["done"] == len(vals),
          "batching: results of the wrong shape, not finite or not done")

    # replay the stream updates (the same draws) from the original corpus:
    # each held microbatch against the brute force and, bit for bit, against
    # ServingCorpus.query on the corpus as it stood
    rng = np.random.default_rng(20)
    updates = {bi: (int(rng.integers(P)),
                    rng.normal(size=(sc.block, SERVE_D)).astype(np.float32))
               for bi in range(BATCH_STREAM_EVERY, SERVE_BATCHES,
                               BATCH_STREAM_EVERY)}
    for b, _ in updates.values():
        sc.replace_block(b, X[b * sc.block:(b + 1) * sc.block])
    Xcur = X.clone()
    n_diff = 0
    for bi in range(SERVE_BATCHES):
        if bi in updates:
            b, data = updates[bi]
            data = torch.from_numpy(data).to(DEVICE)
            sc.replace_block(b, data)
            Xcur[b * sc.block:(b + 1) * sc.block] = data
        if bi not in SERVE_HELD:
            continue
        q = queries[bi]
        rows = slice(bi * SERVE_Q, (bi + 1) * SERVE_Q)
        got_v = torch.from_numpy(vals[rows]).to(DEVICE)
        got_i = torch.from_numpy(idx[rows]).to(DEVICE)
        sv, si = sc.query(q, topk=SERVE_TOPK, metric="l2", use_kernel=True)
        check(torch.equal(sv, got_v) and torch.equal(si, got_i),
              f"batching microbatch {bi}: not bit-equal to "
              "ServingCorpus.query")
        xn = (Xcur * Xcur).sum(-1)
        want_v, want_i = brute_topk(q, Xcur, xn, SERVE_TOPK)
        n_diff += check_topk_rows(q, Xcur, xn, got_v, got_i, want_v, want_i,
                                  f"batching microbatch {bi}")
    say(f"batching N={SERVE_N} d={SERVE_D} P={P}: {SERVE_BATCHES} "
        f"microbatches of {SERVE_Q} l2 top-{SERVE_TOPK} requests through "
        f"BatchScheduler(use_kernel, max_batch={SERVE_Q}) with a stream "
        f"update every {BATCH_STREAM_EVERY}: {qps:.1f} queries/s "
        f"steady-state (stream updates excluded), per-request p50 "
        f"{lat['p50_s'] * 1e3:.3f} ms, p99 {lat['p99_s'] * 1e3:.3f} ms (host "
        f"clock); {wall:.2f} s wall with {len(updates)} updates; B4 launches "
        f"{launches}, {st['packed_requests'] / st['launches']:.1f} requests "
        f"per launch; held microbatches {SERVE_HELD} bit-equal to "
        f"ServingCorpus.query, {n_diff} entries differ from the brute force, "
        "all within the tie tolerance")

    # a heterogeneous pack: k from 1 to 100 and range queries with mixed
    # thresholds and capacities, each bit-identical to the request alone
    X = Xcur                       # the corpus as it stands now
    xn = (X * X).sum(-1)
    hq = queries[SERVE_BATCHES:SERVE_BATCHES + 2].reshape(-1, SERVE_D)
    sched = BatchScheduler(sc, max_batch=64, use_kernel=True)
    reqs = []
    for j, k in enumerate(BATCH_TOPKS):
        for metric in ("l2", "dot"):
            reqs.append(sched.submit(hq[2 * j + (metric == "dot")],
                                     kind="topk", topk=k, metric=metric))
    for j, (hits, cap) in enumerate(((10, 16), (100, 8), (300, 64),
                                     (50, 1), (1000, 256), (5, 2))):
        for metric in ("l2", "dot"):
            q = hq[32 + 2 * j + (metric == "dot")]
            s = l2_scores(q[None], X, xn)[0] if metric == "l2" \
                else (X @ q)
            top = torch.topk(s, hits + 1).values
            thr = float((top[hits - 1] + top[hits]) / 2)
            reqs.append(sched.submit(q, kind="threshold", threshold=thr,
                                     capacity=cap, metric=metric))
    sched.drain()
    for r in reqs:
        res = r.result(0)
        check(res.ok, f"pack: request {r.rid} {res.status}")
        if r.kind == "topk":
            sv, si = sc.query(r.query[None], topk=r.topk, metric=r.metric,
                              use_kernel=True)
            same = (np.array_equal(res.scores, sv[0].cpu().numpy())
                    and np.array_equal(res.indices, si[0].cpu().numpy()))
        else:
            sv, si, sn = sc.query_threshold(r.query[None],
                                            threshold=r.threshold,
                                            metric=r.metric)
            n = int(sn[0])
            same = (res.count == n
                    and np.array_equal(res.scores, sv[0, :n].cpu().numpy())
                    and np.array_equal(res.indices, si[0, :n].cpu().numpy()))
        check(same, f"pack: {r.kind} request (k={r.topk}, threshold="
              f"{r.threshold}, {r.metric}) differs from the request alone")
    pst = sched.stats()
    check(pst["escalations"] > 0, "pack: no capacity escalation")

    # one escalation from capacity 1, deadline expiry and a partial result
    # under injected clocks
    sched = BatchScheduler(sc, max_batch=8)
    q = queries[SERVE_BATCHES + 1, 0]
    thr = float(torch.topk(l2_scores(q[None], X, xn)[0], 201).values[199:]
                .mean())
    esc = sched.submit(q, kind="threshold", threshold=thr, capacity=1,
                       metric="l2")
    sched.drain()
    res = esc.result(0)
    sv, si, sn = sc.query_threshold(q[None], threshold=thr, metric="l2")
    check(res.ok and res.count == int(sn[0]) == 200
          and np.array_equal(res.indices, si[0, :200].cpu().numpy())
          and sched.counters["escalations"] == 8,
          f"escalation: {res.status} count {res.count}, "
          f"{sched.counters['escalations']} escalations")
    t = [0.0]
    sched = BatchScheduler(sc, max_batch=8, clock=lambda: t[0],
                           use_kernel=True)
    live = sched.submit(q, kind="topk", topk=SERVE_TOPK, metric="l2")
    dead = sched.submit(q, kind="topk", topk=SERVE_TOPK, metric="l2",
                        deadline_s=1.0)
    t[0] = 2.0
    sched.drain()
    sv, si = sc.query(q[None], topk=SERVE_TOPK, metric="l2",
                      use_kernel=True)
    check(dead.result(0).status == "expired"
          and (dead.result(0).indices == IDX_SENTINEL).all()
          and (dead.result(0).scores == NEG_INF).all()
          and np.array_equal(live.result(0).indices, si[0].cpu().numpy()),
          "deadline: expiry or its live batchmate wrong")
    t2 = [0.0]

    def stepping_clock():
        t2[0] += 0.4
        return t2[0]

    sched = BatchScheduler(sc, max_batch=8, clock=stepping_clock)
    part = sched.submit(q, kind="threshold", threshold=-1e30, capacity=1,
                        deadline_s=0.5, metric="l2")
    sched.step()
    res = part.result(0)
    check(res.status == "partial" and res.count == sc.n_valid
          and len(res.indices) == 1,
          f"deadline: {res.status}, count {res.count} of {sc.n_valid}")

    # the background loop: BATCH_ASYNC requests submitted from this thread
    aq = queries[SERVE_BATCHES + 1:SERVE_BATCHES + 1
                 + BATCH_ASYNC // SERVE_Q].reshape(-1, SERVE_D)
    sched = BatchScheduler(sc, max_batch=SERVE_Q, max_queue=BATCH_ASYNC,
                           use_kernel=True)
    sched.start()
    t0 = time.perf_counter()
    try:
        reqs = [sched.submit(aq[j], kind="topk", topk=SERVE_TOPK,
                             metric="l2") for j in range(BATCH_ASYNC)]
        results = [r.result(timeout=300) for r in reqs]
    finally:
        sched.stop()
    async_s = time.perf_counter() - t0
    for c0 in range(0, BATCH_ASYNC, SERVE_Q):
        sv, si = sc.query(aq[c0:c0 + SERVE_Q], topk=SERVE_TOPK, metric="l2",
                          use_kernel=True)
        got_i = np.stack([r.indices for r in results[c0:c0 + SERVE_Q]])
        got_v = np.stack([r.scores for r in results[c0:c0 + SERVE_Q]])
        check(all(r.ok for r in results[c0:c0 + SERVE_Q])
              and np.array_equal(got_i, si.cpu().numpy())
              and np.array_equal(got_v, sv.cpu().numpy()),
              f"background loop: requests {c0}.. differ from "
              "ServingCorpus.query")
    ast = sched.stats()
    say(f"batching checks: heterogeneous pack of {int(pst['admitted'])} "
        f"requests (top-k k = {BATCH_TOPKS[0]}..{BATCH_TOPKS[-1]}, 12 range "
        f"queries, capacities 1..256) in {int(pst['launches'])} launches, "
        f"{int(pst['escalations'])} escalations, bit-identical to each "
        f"request alone; escalation from capacity 1 to 256 (8 doublings); "
        f"expiry and a partial result under injected clocks; background "
        f"loop {BATCH_ASYNC} requests in {async_s:.2f} s, "
        f"{int(ast['launches'])} launches, p50 {ast['p50_s'] * 1e3:.3f} ms,"
        f" p99 {ast['p99_s'] * 1e3:.3f} ms, bit-equal to ServingCorpus.query")
    del sc, X, queries


def _churn_workloads(churn: bool):
    from repro_torch.core.delta import churn_workload
    from repro_torch.core.faults import (DenseReduceWorkload,
                                         KnnGraphWorkload, SparseJoinWorkload)
    for cls, n in ((DenseReduceWorkload, CHURN_N),
                   (KnnGraphWorkload, CHURN_N),
                   (SparseJoinWorkload, CHURN_JOIN_N)):
        kw = dict(n_items=n, dim=CHURN_D, seed=0, device=DEVICE)
        yield churn_workload(cls, P, **kw) if churn else cls(P, **kw)


def _result_size(res) -> str:
    return (f"{tuple(res.shape)} {str(res.dtype)[6:]}" if res.dim()
            else f"{float(res):.6e}")


def phase_churn() -> None:
    from repro_torch.core.delta import DeltaIndex, random_update, scratch_fold
    from repro_torch.core.placement import get_placement

    plc = get_placement("cyclic", P)
    for wl in _churn_workloads(churn=True):
        t0 = time.perf_counter()
        index = DeltaIndex(wl, plc, mode="batched")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rng = np.random.RandomState(21)
        times = {}
        for u, n_dirty in enumerate(CHURN_DIRTY):
            dirty: set = set()
            while len(dirty) < n_dirty:
                b, data = random_update(wl, rng, index.span_of)
                index.replace_block(b, data)
                dirty.add(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = index.apply()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = scratch_fold(wl)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            tiles = n_dirty * P - n_dirty * (n_dirty - 1) // 2
            check(wl.equal(out, want), f"churn {wl.name} update {u} "
                  f"({n_dirty} dirty): not bit-equal to scratch_fold")
            check(index.stats.last_tiles == tiles, f"churn {wl.name} update "
                  f"{u}: {index.stats.last_tiles} tiles swept, not {tiles}")
            times.setdefault(n_dirty, []).append((t1 - t0, t2 - t1))
        parts = "; ".join(
            f"|D| = {d} ({d * P - d * (d - 1) // 2} of {index.stats.tiles_full}"
            f" tiles): delta {np.mean([a for a, _ in v]) * 1e3:.1f} ms vs "
            f"full {np.mean([b for _, b in v]) * 1e3:.1f} ms"
            for d, v in sorted(times.items()))
        say(f"churn {wl.name} N={wl.n} d={CHURN_D} P={P} cyclic batched "
            f"({_result_size(out)}): build {build_s * 1e3:.1f} ms; "
            f"{len(CHURN_DIRTY)} updates, each bit-equal to scratch_fold; "
            f"{parts} (host clock, synchronized)")
        del index, out, want, wl


def phase_faults() -> None:
    import tempfile
    from repro_torch.core.faults import (FaultEvent, FaultPlan,
                                         run_fault_tolerant_sweep)
    from repro_torch.core.placement import get_placement
    from repro_torch.core.sweep import ENGINE_MODES, sweep_rounds

    plc = get_placement("cyclic", P)
    holders = [i for i in range(P) if 0 in plc.residency_sets[i]]

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_fault_tolerant_sweep(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        for wl in _churn_workloads(churn=False):
            free = {}
            for mode in ENGINE_MODES:
                (res, _st), secs = timed(wl, plc, mode)
                free[mode] = secs
                if mode == "batched":
                    baseline = res
                check(wl.equal(res, baseline),
                      f"faults {wl.name}: fault-free {mode} differs")
            # the largest checkpoint holds every block and every partial
            ckpt_bytes = (sum(b.numel() for b in wl.blocks) * 4
                          + (baseline.numel() * baseline.element_size()
                             if wl.name == "sparse" else 0))
            lines = []
            for mode in ENGINE_MODES:
                n_rounds = len(sweep_rounds(plc.schedule(), mode))
                every = max(1, -(-n_rounds * ckpt_bytes // CKPT_BUDGET))
                plan = FaultPlan.random_kills(P, n_rounds, every=2,
                                              seed=22 + len(mode))
                d = Path(tmp) / f"{wl.name}_{mode}"
                (out, st), secs = timed(wl, plc, mode, plan,
                                        ckpt_dir=str(d), ckpt_every=every)
                check(st.n_kills == plan.n_kills > 0 and wl.equal(out,
                                                                  baseline),
                      f"faults {wl.name} {mode}: not bit-equal to the "
                      f"fault-free run ({st.n_kills} kills)")
                rec = sum(v for k, v in st.recovery_s.items()
                          if k != "checkpoint")
                lines.append(
                    f"{mode}: {n_rounds} rounds, {st.n_kills} kills, "
                    f"ckpt_every {every} ({st.n_checkpoints} checkpoints, "
                    f"{st.recovery_s.get('checkpoint', 0.0) * 1e3:.0f} ms), "
                    f"recovery {rec * 1e3:.1f} ms, {st.n_reassigned} pairs "
                    f"reassigned, {st.n_rereplicated} blocks re-replicated "
                    f"({st.bytes_rereplicated / 2**20:.1f} MiB), "
                    f"{st.n_fetches} fetches ({st.bytes_fetched / 2**20:.1f} "
                    f"MiB), slowdown {secs / free[mode]:.2f}x "
                    f"({secs * 1e3:.0f} vs {free[mode] * 1e3:.0f} ms)")
            # every holder of block 0 dies after the first checkpoint: the
            # sweep restores from it
            n_rounds = len(sweep_rounds(plc.schedule(), "scan"))
            every = max(1, -(-n_rounds * ckpt_bytes // CKPT_BUDGET))
            kill = min(every, n_rounds - 1)
            plan = FaultPlan(events=tuple(FaultEvent("kill", kill, h)
                                          for h in holders))
            (out, st), secs = timed(wl, plc, "scan", plan,
                                    ckpt_dir=str(Path(tmp) / f"{wl.name}_r"),
                                    ckpt_every=every)
            check(st.n_restores == 1 and wl.equal(out, baseline),
                  f"faults {wl.name}: block loss ({st.n_restores} restores) "
                  "not bit-equal to the fault-free run")
            lines.append(
                f"all {len(holders)} holders of block 0 killed at scan round "
                f"{kill}: restored from the checkpoint in "
                f"{st.recovery_s['restore'] * 1e3:.1f} ms, "
                f"{st.n_recomputed} partials recomputed, {st.n_rereplicated} "
                f"blocks re-seeded, {secs * 1e3:.0f} ms in all")
            say(f"faults {wl.name} N={wl.n} d={CHURN_D} P={P} cyclic "
                f"({_result_size(baseline)}), bit-equal to the fault-free "
                f"run, residency invariant asserted after every repair; "
                f"fault-free batched / overlap / scan "
                f"{free['batched'] * 1e3:.0f} / {free['overlap'] * 1e3:.0f} "
                f"/ {free['scan'] * 1e3:.0f} ms; " + "; ".join(lines))
            del wl, baseline, out


# ---------------------------------------------------------------------------
# Observability; qwen3-14b prefill and serving
# ---------------------------------------------------------------------------

def phase_observability() -> None:
    import os
    import tempfile
    from repro_torch.core.allpairs import quorum_allpairs
    from repro_torch.core.comm import SingleProcessComm, shard
    from repro_torch.core.placement import get_placement
    from repro_torch.obs import comm as obs_comm
    from repro_torch.obs import feedback
    from repro_torch.obs import trace as obs_trace

    # predicted bytes == traced bytes, exactly, for every placement at P;
    # verify_* raise on the first difference
    for Pn in OBS_P:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            got = obs_comm.verify_dense_comm(Pn, block=OBS_BLOCK, dim=OBS_DIM,
                                             dtype=dtype, device=DEVICE,
                                             verbose=False)
            say(f"comm predictor, dense sweep {dtype} N = {Pn * OBS_BLOCK} x "
                f"{OBS_DIM}, P = {Pn}: traced == predicted for "
                + ", ".join(f"{r['placement']} (gather "
                            f"{r['gather_bytes']} B x{r['gather_hops']}, "
                            f"scatter {r['scatter_bytes']} B, allgather "
                            f"{r['allgather_bytes']} B)" for r in got)
                + f" ({time.perf_counter() - t0:.2f} s)")
        for qmode in ("int8", "bf16"):
            got = obs_comm.verify_quant_comm(Pn, block=OBS_BLOCK, dim=OBS_DIM,
                                             qmode=qmode, device=DEVICE,
                                             verbose=False)
            say(f"comm predictor, {qmode} QuantBlocks gather, P = {Pn}: "
                "traced == predicted for "
                + ", ".join(f"{r['placement']} ({r['gather_bytes']} B "
                            f"x{r['gather_hops']})" for r in got))
        check({r["placement"] for r in got}
              >= ({"cyclic", "full"} | ({"projective"} if Pn == 13
                                        else set())),
              f"comm predictor at P = {Pn}: placements {got}")

    # the feedback loop: a 4x-slowed device 2 owns fewer pairs, output
    # bit-exact (feedback_selfcheck raises otherwise)
    n = feedback.feedback_selfcheck(P=8, slow_factor=4.0, device=DEVICE,
                                    verbose=False)
    check(n >= 1, "feedback selfcheck checked no placement")
    say(f"feedback selfcheck P = 8, device 2 slowed 4x: {n} placement(s), "
        f"the slowed device's pair share shrank, output bit-exact")

    # obs.report on a trace that a traced sweep on the card wrote
    comm = SingleProcessComm(8, DEVICE)
    x = shard(np.random.default_rng(0).normal(size=(8 * OBS_BLOCK, OBS_DIM)),
              comm, dtype=torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "sweep_trace.json"
        tr = obs_trace.configure(path=path)
        try:
            quorum_allpairs(lambda a, b: (a * (b * b).sum((-2, -1), True),
                                          b * (a * a).sum((-2, -1), True)),
                            x, comm, mode="overlap",
                            placement=get_placement("cyclic", 8))
            torch.cuda.synchronize()
            tr.export()
        finally:
            obs_trace.reset()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", str(path)],
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    check(r.returncode == 0 and "comm.ppermute.gather_bytes" in r.stdout,
          f"obs.report on the card's trace: exit {r.returncode}\n"
          f"{r.stdout}{r.stderr}")
    say(f"python -m repro_torch.obs.report on a traced overlap sweep (P = 8, "
        f"N = {8 * OBS_BLOCK} x {OBS_DIM}): exit 0\n{r.stdout.strip()}")


def device_breakdown(fn) -> dict:
    """Device ms by kernel family over one call of ``fn``, from
    torch.profiler (CUPTI): B9 (``flash``), its backward (the tf32x3 pair's
    ``dq_tf32_kernel`` / ``dkv_tf32_kernel``, the wgmma route's
    ``bwd_*_kernel``s),
    B10 (``ssd_``; its backward, ``ssd_bwd_*``, apart), GEMMs, the
    sort / scan / index / gather kernels (the MoE dispatch, with the
    embedding gather), everything else, the ten costliest kernels by name,
    and ``wall`` the host clock around that same call (synchronized),
    against which the kernels' sum gives the card's idle share of the
    window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    fam = {"b9": 0.0, "b9_bwd": 0.0, "b10": 0.0, "b10_bwd": 0.0,
           "gemm": 0.0, "dispatch": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_time_total <= 0 or e.key.startswith("cuda"):
            continue
        ms = e.device_time_total / 1e3
        key = e.key.lower()
        if re.search(r"\bd(q|kv)_tf32_kernel|"
                     r"\bbwd_(tc|prologue|slices)_kernel", key):
            fam["b9_bwd"] += ms
        elif "flash" in key:
            fam["b9"] += ms
        elif "ssd_bwd" in key:
            fam["b10_bwd"] += ms
        elif "ssd_" in key:
            fam["b10"] += ms
        elif any(w in key for w in ("gemm", "gemv", "nvjet", "xmma",
                                    "cutlass", "sm90_")):
            fam["gemm"] += ms
        elif any(w in key for w in ("sort", "scan", "index", "gather",
                                    "scatter", "histogram")):
            fam["dispatch"] += ms
        else:
            fam["other"] += ms
        name = e.key.replace("(anonymous namespace)::", "")
        top.append((ms, e.count,
                    name.removeprefix("void ").split("(")[0][:80]))
    fam["top"] = sorted(top, reverse=True)[:10]
    fam["wall"] = wall
    return fam


def say_breakdown(what: str, split: dict, counts: dict) -> float:
    """Print a profiled call's idle share and device split; returns the
    summed device ms (0 where the profiler showed none)."""
    fams = ("b9", "b9_bwd", "b10", "b10_bwd", "gemm", "dispatch", "other")
    dev_ms = sum(split[f] for f in fams)
    if dev_ms <= 0:
        say(f"{what} device time: not measured (the profiler showed no "
            "device time)")
        return 0.0
    idle = max(0.0, 1.0 - dev_ms / split["wall"])
    names = {"b9": f"B9 ({counts.get('flash_attention', 0)} launches)",
             "b9_bwd": f"B9 backward ({counts.get('flash_attention_bwd', 0)}"
             " calls)",
             "b10": f"B10 ({counts.get('ssd_chunk', 0)} launches)",
             "b10_bwd": f"B10 backward ({counts.get('ssd_chunk_bwd', 0)} "
             "calls)",
             "gemm": "GEMMs", "dispatch": "sort / scan / index kernels (MoE "
             "dispatch, with the embedding gather)", "other": "the rest"}
    say(f"{what}, a second one under torch.profiler: host clock "
        f"{split['wall']:.1f} ms (synchronized), kernels' summed device "
        f"time {dev_ms:.1f} ms, so the card idles {100 * idle:.2f} % of that "
        "window; device split: " + ", ".join(
            f"{names[f]} {split[f]:.1f} ms ({100 * split[f] / dev_ms:.1f} %)"
            for f in fams if split[f] > 0 or f in ("b9", "gemm", "other")))
    say("  costliest kernels: " + "; ".join(
        f"{name} {ms:.1f} ms (x{cnt})" for ms, cnt, name in split["top"]))
    split["idle"] = idle
    return dev_ms


def alloc_counters() -> tuple[int, int, frozenset]:
    """(bytes the caching allocator holds for tensors, in its blocks;
    bytes the tensors asked it for; the addresses of its segments), on
    the card, after a synchronize."""
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats()["requested_bytes.all.current"],
            frozenset(seg["address"] for seg in torch.cuda.memory_snapshot()))


def window_open(dev=None) -> int:
    """Open a step's memory window (phase 35 (d), (e)): the allocator's
    requested bytes now, then its peaks reset to the current figures."""
    now = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats(dev)
    return now


def window_close(opened: int, dev=None) -> tuple:
    """(the requested bytes' peak rise over the window that ``opened``,
    the allocator's reserved peak less its requested peak there)."""
    stats = torch.cuda.memory_stats(dev)
    return (stats["requested_bytes.all.peak"] - opened,
            stats["reserved_bytes.all.peak"]
            - stats["requested_bytes.all.peak"])


def record_resident(report: dict, arch: str, before: tuple, **trees) -> int:
    """Keep for phase 35 what the allocator's two counters rose by since
    ``before``, every leaf of ``trees`` (argument name -> tree of
    tensors): its shape, dtype and device type, and, for a leaf on the
    card, the block the allocator gave its storage, from the allocator's
    own snapshot: (block bytes, pool, whether its segment is new since
    ``before``, address).  Returns the rise of ``memory_allocated``."""
    from repro_torch.models.common import tree_leaves
    after = alloc_counters()
    owner = {}     # block address -> (bytes, pool, new segment, address)
    expandable = False
    for seg in torch.cuda.memory_snapshot():
        expandable |= bool(seg.get("is_expandable"))
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                at = blk.get("address", addr)
                owner[at] = (blk["size"], seg["segment_type"],
                             seg["address"] not in before[2], at)
            addr += blk["size"]
    leaves, blocks = {}, {}
    for name, tree in trees.items():
        for path, t in tree_leaves(tree):
            key = "/".join((name,) + path)
            leaves[key] = (tuple(t.shape), t.dtype, t.device.type)
            if t.is_cuda:
                blocks[key] = owner.get(t.untyped_storage().data_ptr())
    report.setdefault("dry_run", {})[arch] = {
        "alloc": after[0] - before[0], "requested": after[1] - before[1],
        "leaves": leaves, "blocks": blocks, "expandable": expandable}
    return after[0] - before[0]


def phase_qwen_prefill(report: dict) -> None:
    import dataclasses
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm
    from repro_torch.models.common import apply_norm, tree_map

    cfg = get_config("qwen3_14b")
    n_params = lm.count_params(cfg)
    check(n_params == QWEN_PARAMS, f"qwen3-14b has {n_params} parameters, "
          f"the JAX package's count_params {QWEN_PARAMS}")
    before = alloc_counters()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    param_bytes = record_resident(report, "qwen3_14b", before,
                                  params=params)
    say(f"qwen3-14b: {n_params} random bf16 parameters from a seed, "
        f"{param_bytes / 2**30:.3f} GiB on the card, made in "
        f"{time.perf_counter() - t0:.1f} s")
    prefill = build_prefill_step(cfg)
    g = torch.Generator(device=DEVICE).manual_seed(25)
    toks = torch.randint(0, cfg.vocab_size, (QWEN_B, QWEN_T), generator=g,
                         device=DEVICE)
    prefill(params, {"tokens": toks[:, :512]})              # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    opened = window_open()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rise, headroom = window_close(opened)
    n = ops.launch_counts()["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    report["flash_attention"]["launches"] = n
    check(n == cfg.n_layers, f"prefill: B9 launched {n} times, expected "
          f"{cfg.n_layers} (one per attention layer)")
    check(logits.shape == (QWEN_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "prefill: logits of the wrong shape or not finite")
    del logits
    report["dry_run"]["qwen3_14b"].update(
        kind="prefill", batch=QWEN_B, seq=QWEN_T, ms=secs * 1e3, accum=1,
        rise=[rise], headroom=[headroom], cold_headroom=headroom,
        tokens=toks.dtype)
    say(f"qwen3-14b prefill {QWEN_B} x {QWEN_T} tokens ({cfg.n_layers} "
        f"layers, bf16): {secs * 1e3:.1f} ms (host clock, synchronized), "
        f"{QWEN_B * QWEN_T / secs:.0f} tokens/s, peak "
        f"{peak / 2**30:.3f} GiB above the parameters, B9 launches {n}")
    split = device_breakdown(lambda: prefill(params, {"tokens": toks}))
    dev_ms = say_breakdown("qwen3-14b prefill", split,
                           {"flash_attention": n})
    if dev_ms > 0:
        report["flash_attention"].update(
            prefill_ms=split["b9"] / n, prefill_share=split["b9"] / dev_ms,
            prefill_idle_share=split["idle"])
    # B9 alone on this prefill's first-layer q / k / v, and on N(0, 1)
    # tensors of the same shapes (phase 17's inputs); its output on the
    # real q / k / v against the f32 plain attention on sampled rows
    with torch.inference_mode():
        p0 = tree_map(lambda a: a[0], params["layers"]["pos0"])
        x, positions = lm.embed_inputs(cfg, params, {"tokens": toks})
        qkv = attn_mod.qkv_project(cfg, p0["attn"], apply_norm(
            cfg, p0["norm1"], x), positions)
        del x
        out, err, ratio = b9_sampled_rows(*qkv)
        del out
        check(ratio <= 1.0, f"B9 on the prefill's layer-0 q / k / v "
              f"(T = {QWEN_T}): max abs err {err:.3e}, {ratio:.3f} of the "
              "limit 2^-7 |want| + 1e-5")
        alone = [cuda_ms(lambda: ops.flash_attention(*t, causal=True))
                 for t in (qkv, tuple(torch.randn_like(a) for a in qkv))]
    del qkv
    report["flash_attention"].update(prefill_alone_ms=alone[0],
                                     prefill_max_abs_err=err)
    say(f"B9 on the first layer's q / k / v of this prefill (q [{QWEN_B}, "
        f"{QWEN_T}, {cfg.n_heads}, {cfg.head_dim}], k / v [{QWEN_B}, "
        f"{QWEN_T}, {cfg.n_kv_heads}, {cfg.head_dim}], causal) vs the f32 "
        f"plain attention on the first, middle and last {QWEN_SAMPLE} rows: "
        f"max abs err {err:.3e}, {ratio:.3f} of the limit")
    say(f"B9 alone (CUDA events, 3 launches) on the first layer's q / k / v"
        f" of this prefill: {alone[0]:.3f} ms; on N(0, 1) tensors of the "
        f"same shapes: {alone[1]:.3f} ms")

    # the checks at QWEN_CHECK_LAYERS layers of the same widths (the first
    # layers' parameters, as views)
    cfg2 = dataclasses.replace(cfg, n_layers=QWEN_CHECK_LAYERS)
    params2 = dict(params, layers=tree_map(lambda a: a[:QWEN_CHECK_LAYERS],
                                           params["layers"]))
    prefill2 = build_prefill_step(cfg2)
    # (a) the B9 route against the same model with the plain attention
    # (kernels/ref.py) on the card: the prefill step's last-position
    # logits, and lm.forward's logits at every position, each row within
    # 2e-2 of max(1, its max |logit|)
    for T in QWEN_CHECK_T:
        short = {"tokens": toks[:, :T]}
        ops.reset_launch_counts()
        got = prefill2(params2, short)
        got_all, _ = lm.forward(cfg2, params2, short)
        n_b9 = ops.launch_counts()["flash_attention"]
        with mock.patch.object(ops, "flash_attention", ref.flash_attention):
            want = prefill2(params2, short)
            want_all, _ = lm.forward(cfg2, params2, short)
        check(n_b9 == 2 * QWEN_CHECK_LAYERS and ops.launch_counts()[
            "flash_attention"] == n_b9, f"B9 launches at T = {T}: {n_b9}")
        check(got_all.shape == (QWEN_B, T, cfg.vocab_size)
              and bool(torch.isfinite(got).all())
              and bool(torch.isfinite(got_all).all()),
              f"qwen3-14b x{QWEN_CHECK_LAYERS} at T = {T}: logits of the "
              "wrong shape or not finite")
        d = float((got - want).abs().max())
        lim = 2e-2 * max(1.0, float(want.abs().max()))
        d_all = (got_all - want_all).abs().amax(-1)
        lim_all = 2e-2 * want_all.abs().amax(-1).clamp_min(1.0)
        worst = float((d_all / lim_all).max())
        check(d < lim, f"qwen3-14b x{QWEN_CHECK_LAYERS} at T = {T}: B9 route"
              f" vs plain attention max abs diff {d:.3e} >= {lim:.3e}")
        check(worst < 1.0, f"qwen3-14b x{QWEN_CHECK_LAYERS} at T = {T}: "
              f"forward logits, B9 route vs plain attention, worst position "
              f"at {worst:.3f} of its limit")
        say(f"qwen3-14b {QWEN_CHECK_LAYERS} layers, T = {T}: last-position "
            f"logits through B9 vs the plain attention on the card max abs "
            f"diff {d:.3e} (< {lim:.3e}), max |logit| "
            f"{float(want.abs().max()):.3f}; all {T} positions' logits "
            f"(lm.forward) max abs diff {float(d_all.max()):.3e}, worst "
            f"position at {worst:.3f} of its limit")
        del got, want, got_all, want_all, d_all, lim_all
    # (b) decoding QWEN_DECODE_T tokens one by one == their prefill
    short = toks[:, :QWEN_DECODE_T].repeat(2, 1)
    short[1] = short[1].roll(7)
    want = prefill2(params2, {"tokens": short})
    state = lm.init_decode_state(cfg2, short.shape[0], QWEN_DECODE_T,
                                 device=DEVICE)
    step = build_serve_step(cfg2)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(QWEN_DECODE_T):
        lg, state = step(params2, state, short[:, t:t + 1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / QWEN_DECODE_T
    check(ops.launch_counts()["flash_attention"] == 0,
          "decode launched B9 (its attention is a plain product)")
    d = float((lg[:, -1] - want).abs().max())
    lim = 2e-2 * max(1.0, float(want.abs().max()))
    check(d < lim, f"qwen3-14b decode vs prefill at {QWEN_DECODE_T} tokens: "
          f"max abs diff {d:.3e} >= {lim:.3e}")
    say(f"qwen3-14b {QWEN_CHECK_LAYERS} layers, decode vs prefill at "
        f"{QWEN_DECODE_T} tokens (2 rows): last-position logits max abs diff"
        f" {d:.3e} (< {lim:.3e}), max |logit| {float(want.abs().max()):.3f};"
        f" {step_ms:.3f} ms per step")
    del params, params2, state, want, lg


def phase_qwen_serve() -> None:
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    cfg = get_config("qwen3_14b")
    serve("qwen3_14b", smoke=False, batch=SERVE_LM_BATCH, prompt_len=4,
          gen_len=4, seed=1, device=DEVICE)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        seqs = serve("qwen3_14b", smoke=False, batch=SERVE_LM_BATCH,
                     prompt_len=SERVE_LM_PROMPT, gen_len=SERVE_LM_GEN,
                     seed=0, device=DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(seqs.shape == (SERVE_LM_BATCH, SERVE_LM_PROMPT + SERVE_LM_GEN),
          f"serve: sequences of shape {seqs.shape}")
    check(((seqs >= 0) & (seqs < cfg.vocab_size)).all(),
          "serve: a token outside the vocabulary")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SERVE_LM_BATCH, SERVE_LM_PROMPT))
    check((seqs[:, :SERVE_LM_PROMPT] == prompt).all(),
          "serve: the teacher-forced prompt was not kept")
    n = ops.launch_counts()["flash_attention"]
    check(n == 0, f"serve: B9 launched {n} times; decode attention is a "
          f"plain product")
    say(f"qwen3-14b serve batch {SERVE_LM_BATCH}, prompt {SERVE_LM_PROMPT}, "
        f"gen {SERVE_LM_GEN} (full config): {secs:.3f} s with parameter init "
        f"(host clock, synchronized), B9 launches {n}; serve(): "
        f"{out.getvalue().strip()}")


# ---------------------------------------------------------------------------
# The MoE, hybrid, encoder-decoder and vision families
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def first_args(module, name: str, store: dict):
    """Within the block, ``module.name`` keeps the arguments of its first
    call in ``store[name]`` (as (args, kwargs)); every call goes through."""
    fn = getattr(module, name)

    def kept(*args, **kw):
        store.setdefault(name, (args, kw))
        return fn(*args, **kw)

    with mock.patch.object(module, name, kept):
        yield store


def params_bytes(tree) -> int:
    return sum(params_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def first_layers(tree, n: int):
    """The first ``n`` entries of every stacked layer leaf (views)."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda a: a[:n], tree)


def timed_prefill(prefill, params, batch, counted: tuple):
    """One main-path prefill: launch counts set to 0 just before, read just
    after.  Returns (logits, seconds on the host clock, synchronized,
    {kernel: launches}, peak bytes above what was allocated before)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: ops.launch_counts()[k] for k in counted}
    return logits, secs, counts, torch.cuda.max_memory_allocated() - base


def b10_ops(Bsz: int, T: int, H: int, Pd: int, N: int, L: int) -> float:
    """B10's operations, C B^T counted once per (batch row, chunk) (phase
    16's count)."""
    nc = T // L
    tri = L * (L + 1) // 2
    cells = Bsz * H * nc
    return (Bsz * nc * 2.0 * N * tri
            + cells * (2.0 * Pd * tri + 2.0 * L * N * Pd))


def ref_attention(q, k, v, causal: bool):
    """kernels/ref.py's plain attention in float32."""
    from repro_torch.kernels import ref
    return ref.flash_attention(q.float(), k.float(), v.float(),
                               causal=causal)


def plain_ssd_pieces(x, dt, A, Bm, Cm, chunk: int, pieces: int = 4):
    """ref.ssd_intra_chunk over ``pieces`` runs of whole chunks (each chunk
    is independent), so its [B, nc, L, L, H] decays fit beside a model."""
    from repro_torch.kernels import ref
    T = x.shape[1]
    step = max(chunk, T // pieces)
    outs = [ref.ssd_intra_chunk(x[:, t:t + step], dt[:, t:t + step], A,
                                Bm[:, t:t + step], Cm[:, t:t + step],
                                chunk=chunk)
            for t in range(0, T, step)]
    return (torch.cat([o[0] for o in outs], 1),
            torch.cat([o[1] for o in outs], 1),
            torch.cat([o[2] for o in outs], 1))


def greedy_decode(cfg, params, state, batch: int, prompt_len: int,
                  gen_len: int, seed: int):
    """``launch/serve.py``'s loop over the serve step of ``cfg`` (the
    teacher-forced prompt from ``seed``, then greedy tokens), on the card.
    Returns (sequences [batch, prompt_len + gen_len] numpy, ms a step on
    the host clock, synchronized)."""
    from repro_torch.launch.steps import build_serve_step
    step = build_serve_step(cfg)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, prompt_len))
    prompt_t = torch.as_tensor(prompt, dtype=torch.int32, device=DEVICE)
    toks = prompt_t[:, :1]
    out = [toks]
    n = prompt_len + gen_len - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        logits, state = step(params, state, toks)
        if t + 1 < prompt_len:
            toks = prompt_t[:, t + 1:t + 2]
        else:
            toks = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
        out.append(toks)
    seqs = torch.cat(out, dim=1).cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3 / n
    check(seqs.shape == (batch, prompt_len + gen_len)
          and ((seqs >= 0) & (seqs < cfg.vocab_size)).all()
          and (seqs[:, :prompt_len] == prompt).all(),
          f"{cfg.name}: greedy decode gave sequences of the wrong shape, "
          "outside the vocabulary or without the prompt")
    return seqs, ms


def decode_vs_prefill(what: str, cfg, params, toks) -> str:
    """Decode ``toks`` [B, T] one by one through the serve step and hold the
    last position's logits to the prefill step's, within 2e-2 of max(1,
    max |logit|) (tests/test_models.py's 2e-2, scaled).  Returns the
    printed summary."""
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import lm
    from repro_torch.kernels import ops
    want = build_prefill_step(cfg)(params, {"tokens": toks})
    state = lm.init_decode_state(cfg, toks.shape[0], toks.shape[1],
                                 device=DEVICE)
    step = build_serve_step(cfg)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(toks.shape[1]):
        lg, state = step(params, state, toks[:, t:t + 1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / toks.shape[1]
    n9 = ops.launch_counts()["flash_attention"]
    check(n9 == 0, f"{what}: decode launched B9 {n9} times (its attention "
          "is a plain product)")
    d = float((lg[:, -1] - want).abs().max())
    lim = 2e-2 * max(1.0, float(want.abs().max()))
    check(bool(torch.isfinite(lg).all()) and d < lim,
          f"{what}: decode vs prefill at {toks.shape[1]} tokens max abs diff"
          f" {d:.3e} >= {lim:.3e}")
    return (f"decode vs prefill at {toks.shape[1]} tokens ({toks.shape[0]} "
            f"rows): last-position logits max abs diff {d:.3e} (< {lim:.3e})"
            f", max |logit| {float(want.abs().max()):.3f}; {step_ms:.3f} ms "
            f"per step, {ops.launch_counts()['ssd_chunk']} B10 launches")


def no_drop_config(cfg, n_max: int):
    """``cfg`` with ``capacity_factor`` raised to E / k: then C = n at every
    n, and no expert can hold more than n choices (a token picks an expert
    once), so nothing drops at prefill or decode."""
    import dataclasses
    from repro_torch.models import moe
    big = dataclasses.replace(
        cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    check(all(moe.capacity(big, n) >= n for n in (1, 2, 4, n_max)),
          f"{cfg.name}: the raised capacity still drops")
    return big


def moe_card_vs_cpu(cfg, p, h) -> str:
    """One MoE layer on the card (bf16) against the port's plain path on
    the CPU (float32 copies of the same bf16 parameters and rows): routing
    index-exact except at tokens whose k-th and (k+1)-th router
    probabilities lie within MOE_TIE * max(1, p) (the repo's tie rule),
    rows whose routing agrees within 2e-2 of max(1, their max |value|)."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    n, d = h.shape[0] * h.shape[1], h.shape[-1]
    k = cfg.moe_top_k
    out_g, aux_g = moe.apply_moe(cfg, p, h)
    _pg, _vg, idx_g = moe.route(cfg, p["router"], h.reshape(n, d))
    flat_g, keep_g, _cg, C = moe.dispatch(cfg, idx_g)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p_cpu = tree_map(lambda a: a.cpu().float(), p)
    h_cpu = h.cpu().float()
    t0 = time.perf_counter()
    out_c, aux_c = moe.apply_moe(cfg32, p_cpu, h_cpu)
    cpu_s = time.perf_counter() - t0
    probs_c, _vc, idx_c = moe.route(cfg32, p_cpu["router"],
                                    h_cpu.reshape(n, d))
    flat_c, keep_c, _cc, _C = moe.dispatch(cfg32, idx_c)
    top = torch.sort(probs_c, dim=-1, descending=True).values
    margin = (top[:, k - 1] - top[:, k]) <= MOE_TIE * top[:, k - 1].clamp_min(
        1.0)
    flipped = (idx_g.cpu() != idx_c).any(-1)
    check(not bool((flipped & ~margin).any()),
          f"MoE card vs CPU: {int((flipped & ~margin).sum())} tokens route "
          f"to other experts outside the tie margin")
    same = ~flipped & (keep_g.cpu() == keep_c).view(n, k).all(-1)
    if not bool(flipped.any()):
        check(torch.equal(keep_g.cpu(), keep_c)
              and torch.equal(flat_g.cpu(), flat_c),
              "MoE card vs CPU: same experts, other slots or drops")
    rows_g = out_g.reshape(n, d).float().cpu()
    rows_c = out_c.reshape(n, d)
    diff = (rows_g - rows_c).abs().amax(-1)
    lim = 2e-2 * rows_c.abs().amax(-1).clamp_min(1.0)
    worst = float((diff / lim)[same].max())
    check(worst <= 1.0, f"MoE card vs CPU: a row at {worst:.3f} of its "
          "limit")
    d_aux = abs(float(aux_g) - float(aux_c))
    check(d_aux <= 1e-4 * max(1.0, float(aux_c))
          + cfg.moe_experts * int(flipped.sum()) / (n * k),
          f"MoE card vs CPU: aux {float(aux_g):.6f} vs {float(aux_c):.6f}")
    return (f"one MoE layer ({n} rows, E {cfg.moe_experts}, top-{k}, C {C}) "
            f"on the card vs the port's plain path on the CPU (float32 "
            f"copies, {cpu_s:.1f} s): {int(margin.sum())} tokens within the "
            f"tie margin ({MOE_TIE:g} * max(1, p)), {int(flipped.sum())} "
            f"routed otherwise; {int((~keep_c).sum())} of {n * k} choices "
            f"dropped on both, keep masks "
            f"{'index-exact' if not bool(flipped.any()) else 'exact where the experts agree'}"
            f"; rows max abs diff {float(diff[same].max()):.3e}, worst row at "
            f"{worst:.3f} of its limit (2e-2 max(1, |row|)); aux "
            f"{float(aux_g):.6f} vs {float(aux_c):.6f}")


def phase_jamba_prefill(report: dict, held: dict) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import lm, moe

    full = get_config("jamba_v0_1_52b")
    check(lm.count_params(full) == JAMBA_FULL_PARAMS,
          f"jamba-v0.1-52b has {lm.count_params(full)} parameters")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    n_params = lm.count_params(cfg)
    check(n_params == JAMBA_PARAMS, f"jamba x{JAMBA_LAYERS} has {n_params} "
          f"parameters, the JAX package's count_params {JAMBA_PARAMS}")
    pat = cfg.pattern()
    n_attn = pat.count("A") * cfg.n_superblocks
    n_ssm = pat.count("M") * cfg.n_superblocks
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    say(f"jamba-v0.1-52b at full width (d_model {cfg.d_model}, {cfg.n_heads}"
        f" heads / KV {cfg.n_kv_heads}, hd {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.moe_experts} experts top-{cfg.moe_top_k}, capacity_factor "
        f"{cfg.capacity_factor}, SSM state {cfg.ssm_state} x head dim "
        f"{cfg.ssm_head_dim} ({cfg.ssm_heads} heads), chunk {cfg.ssm_chunk},"
        f" vocab {cfg.vocab_size}); cuts: depth {full.n_layers} -> "
        f"{cfg.n_layers} layers ({cfg.n_superblocks} of "
        f"{full.n_superblocks} superblocks: the full model's "
        f"{JAMBA_FULL_PARAMS} parameters, {JAMBA_FULL_PARAMS * 2 / 2**30:.2f}"
        f" GiB in bf16, do not fit the card), prefill_32k batch 32 -> "
        f"{JAMBA_B}; {n_params} random bf16 parameters from a seed, "
        f"{params_bytes(params) / 2**30:.3f} GiB, made in "
        f"{time.perf_counter() - t0:.1f} s")
    prefill = build_prefill_step(cfg)
    g = torch.Generator(device=DEVICE).manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (JAMBA_B, JAMBA_T), generator=g,
                         device=DEVICE)
    prefill(params, {"tokens": toks[:, :2 * cfg.ssm_chunk]})      # warm-up
    logits, secs, n, peak = timed_prefill(
        prefill, params, {"tokens": toks}, ("flash_attention", "ssd_chunk"))
    report["flash_attention"]["jamba_launches"] = n["flash_attention"]
    report["ssd_chunk"]["jamba_launches"] = n["ssd_chunk"]
    check(n["flash_attention"] == n_attn and n["ssd_chunk"] == n_ssm,
          f"jamba prefill: B9 launched {n['flash_attention']} times, B10 "
          f"{n['ssd_chunk']}, expected {n_attn} and {n_ssm}")
    check(logits.shape == (JAMBA_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "jamba prefill: logits of the wrong shape or not finite")
    del logits
    say(f"jamba x{cfg.n_layers} prefill {JAMBA_B} x {JAMBA_T} tokens (depth "
        f"cut 32 -> {cfg.n_layers}, batch cut 32 -> {JAMBA_B}): "
        f"{secs * 1e3:.1f} ms (host clock, synchronized), "
        f"{JAMBA_B * JAMBA_T / secs:.0f} tokens/s, peak {peak / 2**30:.3f} "
        f"GiB above the parameters, B9 launches {n['flash_attention']}, B10 "
        f"launches {n['ssd_chunk']}; {lm.count_active_params(cfg)} parameters"
        f" active a token")
    split = device_breakdown(lambda: prefill(params, {"tokens": toks}))
    if say_breakdown(f"jamba x{cfg.n_layers} prefill", split, n) > 0:
        report["flash_attention"].update(
            jamba_ms=split["b9"] / n_attn, jamba_idle_share=split["idle"])
        report["ssd_chunk"].update(jamba_ms=split["b10"] / n_ssm,
                                   jamba_idle_share=split["idle"])

    # (a) B10 and (b) B9 on the real inputs of the first M layer and of the
    # first attention layer (the first calls while layers 0-4 run on the
    # whole prompt)
    kept: dict = {}
    with torch.inference_mode(), first_args(ops, "ssd_intra_chunk", kept), \
            first_args(ops, "flash_attention", kept):
        x, positions = lm.embed_inputs(cfg, params, {"tokens": toks})
        sb0 = lm._index(params["layers"], 0)
        for j in range(pat.index("A") + 1):
            x, _ = lm._apply_layer(cfg, pat[j], j, sb0[f"pos{j}"], x,
                                   positions)
        del x
    (xs, dt, A, Bm, Cm), kw = kept["ssd_intra_chunk"]
    L = kw["chunk"]
    got = ops.ssd_intra_chunk(xs, dt, A, Bm, Cm, chunk=L)
    want = plain_ssd_pieces(xs, dt, A, Bm, Cm, L)
    errs = []
    for name, gt, wt in zip(("y", "S", "cd"), got, want):
        check(gt.shape == wt.shape and bool(torch.isfinite(gt).all())
              and torch.allclose(gt, wt, rtol=1e-4, atol=1e-4),
              f"B10 on jamba layer 0's inputs: {name} not within rtol / atol"
              f" 1e-4 (max abs err {float((gt - wt).abs().max()):.3e})")
        errs.append(float((gt - wt).abs().max()))
    del want
    ms = cuda_ms(lambda: ops.ssd_intra_chunk(xs, dt, A, Bm, Cm, chunk=L))
    plain_ms = cuda_ms(lambda: plain_ssd_pieces(xs, dt, A, Bm, Cm, L),
                       reps=1, warmup=0)
    Bsz, T, H, Pd = xs.shape
    N = Bm.shape[-1]
    n_ops = b10_ops(Bsz, T, H, Pd, N, L)
    b_ms, b_by = bound(nbytes(xs, dt, A, Bm, Cm, *got), n_ops)
    report["ssd_chunk"].update(
        jamba_alone_ms=ms, jamba_plain_ms=plain_ms, jamba_bound_ms=b_ms,
        jamba_bound_by=b_by, jamba_max_abs_err=max(errs))
    say(f"(a) B10 on jamba layer 0's x {tuple(xs.shape)} / dt / A / B / C "
        f"{tuple(Bm.shape)} (chunk {L}, {Bsz * H * (T // L)} cells): max_abs"
        f"_err y {errs[0]:.3e}, S {errs[1]:.3e}, cd {errs[2]:.3e} (rtol / "
        f"atol 1e-4); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms (4 pieces),"
        f" bound {b_ms:.4f} ms ({b_by}, {n_ops:.4e} operations)")
    del got, xs, dt, A, Bm, Cm

    (q, k, v), kw = kept["flash_attention"]
    check(kw.get("causal") is True and q.shape == (JAMBA_B, JAMBA_T,
                                                   cfg.n_heads, cfg.head_dim),
          f"jamba's attention layer called B9 with q {tuple(q.shape)}")
    out, err, ratio = b9_sampled_rows(q, k, v)
    check(ratio <= 1.0, f"(b) B9 on jamba's attention layer: max abs err "
          f"{err:.3e}, {ratio:.3f} of the limit 2^-7 |want| + 1e-5")
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    n_ops = flash_ops(JAMBA_B, JAMBA_T, JAMBA_T, cfg.n_heads, cfg.head_dim,
                      True)
    b_ms, b_by = bound(nbytes(q, k, v, out), n_ops, PEAK_BF16_FLOPS)
    report["flash_attention"].update(
        jamba_alone_ms=ms, jamba_bound_ms=b_ms, jamba_max_abs_err=err)
    say(f"(b) B9 on jamba's attention layer q {tuple(q.shape)} k / v "
        f"{tuple(k.shape)} (groups of {cfg.n_heads // cfg.n_kv_heads}, "
        f"causal) vs the f32 plain attention on the first, middle and last "
        f"{QWEN_SAMPLE} rows: max abs err {err:.3e}, {ratio:.3f} of the "
        f"limit; alone {ms:.3f} ms (CUDA events), bound {b_ms:.3f} ms "
        f"({b_by}, {n_ops:.3e} operations on bf16 tensor cores)")
    del q, k, v, out, kept

    # (c) the first MoE layer on the card against the CPU, on its real
    # input rows (the first JAMBA_MOE_ROWS tokens through layers 0-1)
    kept = {}
    with torch.inference_mode(), first_args(moe, "apply_moe", kept):
        lm.forward_hidden(dataclasses.replace(cfg, n_layers=len(pat)),
                          dict(params, layers=first_layers(params["layers"],
                                                           1)),
                          {"tokens": toks[:, :JAMBA_MOE_ROWS]})
        (_c, p_moe, h), _kw = kept["apply_moe"]
        say("(c) " + moe_card_vs_cpu(cfg, p_moe, h))
    del kept, p_moe, h

    # (d) decode == prefill at JAMBA_DECODE_T tokens, one superblock, with
    # the capacity raised so nothing drops (at decode n = B)
    cfg1 = no_drop_config(dataclasses.replace(cfg, n_layers=len(pat)),
                          2 * JAMBA_DECODE_T)
    short = toks[:, :JAMBA_DECODE_T].repeat(2, 1)
    short[1] = short[1].roll(7)
    say(f"(d) jamba 1 superblock ({len(pat)} layers), capacity_factor raised"
        f" {cfg.capacity_factor} -> {cfg1.capacity_factor} (C = n: nothing "
        "drops), " + decode_vs_prefill(
            "jamba", cfg1, dict(params, layers=first_layers(
                params["layers"], 1)), short))
    held["jamba"] = (cfg, params)


def phase_jamba_serve(report: dict, held: dict) -> None:
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import lm
    cfg, params = held.pop("jamba")
    n_ssm = cfg.pattern().count("M") * cfg.n_superblocks
    state = lm.init_decode_state(cfg, SERVE_LM_BATCH, 8, device=DEVICE)
    greedy_decode(cfg, params, state, SERVE_LM_BATCH, 4, 4, 1)   # warm-up
    state = lm.init_decode_state(cfg, SERVE_LM_BATCH,
                                 SERVE_LM_PROMPT + SERVE_LM_GEN,
                                 device=DEVICE)
    ops.reset_launch_counts()
    _seqs, ms = greedy_decode(cfg, params, state, SERVE_LM_BATCH,
                              SERVE_LM_PROMPT, SERVE_LM_GEN, 0)
    steps = SERVE_LM_PROMPT + SERVE_LM_GEN - 1
    n10 = ops.launch_counts()["ssd_chunk"]
    n9 = ops.launch_counts()["flash_attention"]
    check(n10 == steps * n_ssm and n9 == 0,
          f"jamba serve: {n10} B10 launches over {steps} steps (expected "
          f"{n_ssm} a step), B9 {n9}")
    report["ssd_chunk"]["jamba_decode_launches_per_step"] = n10 // steps
    report["ssd_chunk"]["jamba_decode_step_ms"] = ms
    say(f"jamba x{cfg.n_layers} serving (depth cut 32 -> {cfg.n_layers}; "
        f"lm.init_decode_state + build_serve_step, serve()'s loop) batch "
        f"{SERVE_LM_BATCH}, prompt {SERVE_LM_PROMPT}, gen {SERVE_LM_GEN}: "
        f"{ms:.3f} ms per step (host clock, synchronized), {n10 // steps} "
        f"B10 launches per step over {steps} steps, B9 launches {n9}")
    del state

    # B10's L = 1 route on the first M layer's real inputs of a decode
    # step, against its plain version
    kept: dict = {}
    state = lm.init_decode_state(cfg, SERVE_LM_BATCH, 8, device=DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_LM_BATCH, 1),
                         generator=torch.Generator(device=DEVICE)
                         .manual_seed(30), device=DEVICE)
    with torch.inference_mode(), first_args(ops, "ssd_intra_chunk", kept):
        build_serve_step(cfg)(params, state, toks)
    (xs, dt, A, Bm, Cm), kw = kept["ssd_intra_chunk"]
    check(kw["chunk"] == 1 and xs.shape == (SERVE_LM_BATCH, 1, cfg.ssm_heads,
                                             cfg.ssm_head_dim),
          f"jamba decode called B10 with x {tuple(xs.shape)}, chunk "
          f"{kw['chunk']}")
    got = ops.ssd_intra_chunk(xs, dt, A, Bm, Cm, chunk=1)
    want = ref.ssd_intra_chunk(xs, dt, A, Bm, Cm, chunk=1)
    errs = []
    for name, gt, wt in zip(("y", "S", "cd"), got, want):
        check(gt.shape == wt.shape and bool(torch.isfinite(gt).all())
              and torch.allclose(gt, wt, rtol=1e-4, atol=1e-4),
              f"B10 (L = 1) on jamba's decode inputs: {name} not within rtol"
              f" / atol 1e-4 (max abs err {float((gt - wt).abs().max()):.3e})")
        errs.append(float((gt - wt).abs().max()))
    report["ssd_chunk"]["jamba_decode_max_abs_err"] = max(errs)
    say(f"B10's L = 1 route on jamba's decode-step x {tuple(xs.shape)} / dt "
        f"/ A / B / C {tuple(Bm.shape)} (the first M layer's real inputs) vs "
        f"the plain version: max_abs_err y {errs[0]:.3e}, S {errs[1]:.3e}, "
        f"cd {errs[2]:.3e} (rtol / atol 1e-4)")
    del params, state, kept, got, want


def phase_llama4(report: dict) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import lm

    full = get_config("llama4_scout_17b_a16e")
    cfg = dataclasses.replace(full, n_layers=LLAMA4_LAYERS)
    n_params = lm.count_params(cfg)
    check(n_params == LLAMA4_PARAMS, f"llama4-scout x{LLAMA4_LAYERS} has "
          f"{n_params} parameters, the JAX package's count {LLAMA4_PARAMS}")
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    prefill = build_prefill_step(cfg)
    g = torch.Generator(device=DEVICE).manual_seed(27)
    toks = torch.randint(0, cfg.vocab_size, (1, LLAMA4_T), generator=g,
                         device=DEVICE)
    prefill(params, {"tokens": toks[:, :512]})                  # warm-up
    logits, secs, n, peak = timed_prefill(prefill, params, {"tokens": toks},
                                          ("flash_attention",))
    report["flash_attention"]["llama4_launches"] = n["flash_attention"]
    check(n["flash_attention"] == cfg.n_layers,
          f"llama4-scout prefill: B9 launched {n['flash_attention']} times")
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "llama4-scout prefill: logits of the wrong shape or not finite")
    del logits
    say(f"llama4-scout at full width (d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads / KV {cfg.n_kv_heads}, {cfg.moe_experts} experts top-"
        f"{cfg.moe_top_k} + shared, d_ff {cfg.d_ff}, rope_theta "
        f"{cfg.rope_theta:g}, vocab {cfg.vocab_size}); cuts: depth "
        f"{full.n_layers} -> {cfg.n_layers} layers, prefill_32k batch 32 -> "
        f"1; {n_params} random bf16 parameters; prefill 1 x {LLAMA4_T} "
        f"tokens: {secs * 1e3:.1f} ms (host clock, synchronized), "
        f"{LLAMA4_T / secs:.0f} tokens/s, peak {peak / 2**30:.3f} GiB above "
        f"the parameters, B9 launches {n['flash_attention']}")
    big = no_drop_config(cfg, 2 * LLAMA4_DECODE_T)
    short = toks[:, :LLAMA4_DECODE_T].repeat(2, 1)
    short[1] = short[1].roll(5)
    say(f"llama4-scout x{cfg.n_layers}, capacity_factor raised "
        f"{cfg.capacity_factor} -> {big.capacity_factor} (nothing drops), "
        + decode_vs_prefill("llama4-scout", big, params, short))
    del params


def phase_whisper(report: dict) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import whisper

    cfg = get_config("whisper_large_v3")
    n_params = whisper.count_params(cfg)
    check(n_params == WHISPER_PARAMS, f"whisper-large-v3 has {n_params} "
          f"parameters, the JAX package's count_params {WHISPER_PARAMS}")
    params = whisper.init_params(cfg, seed=0, device=DEVICE)
    t_dec = WHISPER_FRAMES // cfg.dec_ratio
    g = torch.Generator(device=DEVICE).manual_seed(28)
    frames = torch.randn(WHISPER_B, WHISPER_FRAMES, cfg.d_model, generator=g,
                         device=DEVICE).to(cfg.dtype)
    toks = torch.randint(0, cfg.vocab_size, (WHISPER_B, t_dec), generator=g,
                         device=DEVICE)
    batch = {"frames": frames, "tokens": toks}
    prefill = build_prefill_step(cfg)
    # warm-up at the main path's own shapes: at 1 x 64 frames the first
    # timed call still paid for choosing the GEMMs of these shapes
    prefill(params, batch)
    logits, secs, n, peak = timed_prefill(prefill, params, batch,
                                          ("flash_attention",))
    n_b9 = cfg.n_enc_layers + cfg.n_layers
    report["flash_attention"]["whisper_launches"] = n["flash_attention"]
    check(n["flash_attention"] == n_b9, f"whisper prefill: B9 launched "
          f"{n['flash_attention']} times, expected {n_b9}")
    check(logits.shape == (WHISPER_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "whisper prefill: logits of the wrong shape or not finite")
    del logits
    say(f"whisper-large-v3 (full config, {cfg.n_enc_layers} + {cfg.n_layers}"
        f" layers, {n_params} random bf16 parameters, no cut) prefill "
        f"{WHISPER_B} x {WHISPER_FRAMES} frames + {t_dec} decoder tokens: "
        f"{secs * 1e3:.1f} ms (host clock, synchronized), peak "
        f"{peak / 2**30:.3f} GiB above the parameters, B9 launches "
        f"{n['flash_attention']} ({cfg.n_enc_layers} full in the encoder, "
        f"{cfg.n_layers} causal in the decoder)")
    split = device_breakdown(lambda: prefill(params, batch))
    if say_breakdown("whisper prefill", split, n) > 0:
        report["flash_attention"].update(whisper_ms=split["b9"] / n_b9,
                                         whisper_idle_share=split["idle"])

    # decoding against the precomputed cross K / V
    memory = whisper.encode(cfg, params, frames)
    state = whisper.init_decode_state(cfg, params, WHISPER_B,
                                      WHISPER_DEC_STEPS, memory)
    step = build_serve_step(cfg)
    lg, state = step(params, state, toks[:, :1])                  # warm-up
    state["pos"] = 0
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cur = toks[:, :1]
    for _ in range(WHISPER_DEC_STEPS):
        lg, state = step(params, state, cur)
        cur = torch.argmax(lg[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / WHISPER_DEC_STEPS
    check(ops.launch_counts()["flash_attention"] == 0
          and bool(torch.isfinite(lg).all()),
          "whisper decode launched B9 or gave non-finite logits")
    say(f"whisper decode {WHISPER_DEC_STEPS} greedy steps at batch "
        f"{WHISPER_B} against the cross K / V of {WHISPER_FRAMES} frames: "
        f"{step_ms:.3f} ms per step (host clock, synchronized), B9 launches "
        f"0")
    del state

    # B9 on the encoder's layer-0 q / k / v (hd 64, KV = H = 20, T = 1,500,
    # full) and on the decoder's layer-0 self-attention q / k / v (T = 187,
    # causal), each against the f32 plain attention on every row
    enc: dict = {}
    dec: dict = {}
    with torch.inference_mode():
        with first_args(ops, "flash_attention", enc):
            whisper.encode(dataclasses.replace(cfg, n_enc_layers=1), params,
                           frames)
        with first_args(ops, "flash_attention", dec):
            whisper.decode_train(dataclasses.replace(cfg, n_layers=1),
                                 params, toks, memory)
    del memory
    for part, kept, causal, T, key in (
            ("encoder", enc, False, WHISPER_FRAMES, "whisper_enc"),
            ("decoder", dec, True, t_dec, "whisper_dec")):
        (q, k, v), kw = kept["flash_attention"]
        check(kw.get("causal") is causal and q.shape == (
            WHISPER_B, T, cfg.n_heads, cfg.head_dim),
            f"whisper's {part} called B9 with q {tuple(q.shape)}, "
            f"causal {kw.get('causal')}")
        out = ops.flash_attention(q, k, v, causal=causal)
        err, ratio = out_err(out, ref_attention(q, k, v, causal))
        check(ratio <= 1.0, f"B9 on whisper's {part} layer 0: max abs err "
              f"{err:.3e}, {ratio:.3f} of the limit 2^-7 |want| + 1e-5")
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
        n_ops = flash_ops(WHISPER_B, T, T, cfg.n_heads, cfg.head_dim, causal)
        b_ms, b_by = bound(nbytes(q, k, v, out), n_ops, PEAK_BF16_FLOPS)
        report["flash_attention"].update({
            f"{key}_alone_ms": ms, f"{key}_bound_ms": b_ms,
            f"{key}_max_abs_err": err})
        say(f"B9 on whisper's {part} layer-0 q {tuple(q.shape)} k / v "
            f"{tuple(k.shape)} ({'causal' if causal else 'full'}, T = {T}"
            f"{' not a multiple of 64' if T % 64 else ''}) vs the f32 plain "
            f"attention on every row:"
            f" max abs err {err:.3e}, {ratio:.3f} of the limit; alone "
            f"{ms:.3f} ms (CUDA events), bound {b_ms:.3f} ms ({b_by})")
        del q, k, v, out
    del enc, dec

    # decode == teacher-forced forward at 2 + 2 layers of the full width
    cfg2 = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2)
    params2 = dict(params, enc_layers=first_layers(params["enc_layers"], 2),
                   dec_layers=first_layers(params["dec_layers"], 2))
    fwd, _ = whisper.forward(cfg2, params2, batch)
    memory = whisper.encode(cfg2, params2, frames)
    state = whisper.init_decode_state(cfg2, params2, WHISPER_B, t_dec, memory)
    step = build_serve_step(cfg2)
    worst = 0.0
    dmax = 0.0
    for t in range(t_dec):
        lg, state = step(params2, state, toks[:, t:t + 1])
        want = fwd[:, t]
        d = (lg[:, 0] - want).abs().amax(-1)
        worst = max(worst, float((d / (2e-2 * want.abs().amax(-1)
                                       .clamp_min(1.0))).max()))
        dmax = max(dmax, float(d.max()))
    check(worst < 1.0, f"whisper 2 + 2 layers: decode vs forward, worst "
          f"position at {worst:.3f} of its limit")
    say(f"whisper 2 + 2 layers of the full width: decode vs the "
        f"teacher-forced forward at all {t_dec} positions x {WHISPER_B} rows:"
        f" max abs diff {dmax:.3e}, worst position at {worst:.3f} of its "
        "limit (2e-2 max(1, max |logit|))")
    del params, params2, state, fwd, memory


def phase_qwen2_vl(report: dict) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import lm

    full = get_config("qwen2_vl_72b")
    cfg = dataclasses.replace(full, n_layers=QWEN2VL_LAYERS)
    n_params = lm.count_params(cfg)
    check(n_params == QWEN2VL_PARAMS, f"qwen2-vl x{QWEN2VL_LAYERS} has "
          f"{n_params} parameters, the JAX package's count {QWEN2VL_PARAMS}")
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(29)
    n_text = QWEN2VL_T - cfg.vis_tokens
    vis = torch.randn(1, cfg.vis_tokens, cfg.d_model, generator=g,
                      device=DEVICE).to(cfg.dtype)
    toks = torch.randint(0, cfg.vocab_size, (1, n_text), generator=g,
                         device=DEVICE)
    prefill = build_prefill_step(cfg)
    prefill(params, {"tokens": toks[:, :256], "vision_embeds": vis[:, :256]})
    logits, secs, n, peak = timed_prefill(
        prefill, params, {"tokens": toks, "vision_embeds": vis},
        ("flash_attention",))
    report["flash_attention"]["qwen2vl_launches"] = n["flash_attention"]
    check(n["flash_attention"] == cfg.n_layers,
          f"qwen2-vl prefill: B9 launched {n['flash_attention']} times")
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "qwen2-vl prefill: logits of the wrong shape or not finite")
    del logits
    say(f"qwen2-vl-72b at full width (d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads / KV {cfg.n_kv_heads}, d_ff {cfg.d_ff}, M-RoPE "
        f"{cfg.mrope_sections}, vocab {cfg.vocab_size}); cuts: depth "
        f"{full.n_layers} -> {cfg.n_layers} layers, prefill_32k batch 32 -> "
        f"1; {n_params} random bf16 parameters; prefill {cfg.vis_tokens} "
        f"vision embeddings + {n_text} text tokens: {secs * 1e3:.1f} ms (host"
        f" clock, synchronized), {QWEN2VL_T / secs:.0f} tokens/s, peak "
        f"{peak / 2**30:.3f} GiB above the parameters, B9 launches "
        f"{n['flash_attention']}")
    # (a) B9 on this prefill's layer-0 q / k / v (after M-RoPE; groups of
    # 8) against the f32 plain attention on sampled rows
    kept: dict = {}
    with torch.inference_mode(), first_args(ops, "flash_attention", kept):
        prefill(params, {"tokens": toks, "vision_embeds": vis})
    (q, k, v), kw = kept["flash_attention"]
    check(kw.get("causal") is True and q.shape == (
        1, QWEN2VL_T, cfg.n_heads, cfg.head_dim),
        f"qwen2-vl's first layer called B9 with q {tuple(q.shape)}")
    out, err, ratio = b9_sampled_rows(q, k, v)
    check(ratio <= 1.0, f"(a) B9 on qwen2-vl's layer 0: max abs err "
          f"{err:.3e}, {ratio:.3f} of the limit 2^-7 |want| + 1e-5")
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    n_ops = flash_ops(1, QWEN2VL_T, QWEN2VL_T, cfg.n_heads, cfg.head_dim,
                      True)
    b_ms, b_by = bound(nbytes(q, k, v, out), n_ops, PEAK_BF16_FLOPS)
    report["flash_attention"].update(
        qwen2vl_alone_ms=ms, qwen2vl_bound_ms=b_ms, qwen2vl_max_abs_err=err)
    say(f"(a) B9 on qwen2-vl's layer-0 q {tuple(q.shape)} k / v "
        f"{tuple(k.shape)} (groups of {cfg.n_heads // cfg.n_kv_heads}, "
        f"causal) vs the f32 plain attention on the first, middle and last "
        f"{QWEN_SAMPLE} rows: max abs err {err:.3e}, {ratio:.3f} of the "
        f"limit; alone {ms:.3f} ms (CUDA events), bound {b_ms:.3f} ms "
        f"({b_by})")
    del q, k, v, out, kept
    # (b) the B9 route against the plain attention (patched in by this script,
    # never a route of the entry point) at QWEN2VL_CHECK_T positions
    short = {"tokens": toks[:, :QWEN2VL_CHECK_T - cfg.vis_tokens],
             "vision_embeds": vis}
    ops.reset_launch_counts()
    got = prefill(params, short)
    got_all, _ = lm.forward(cfg, params, short)
    n_b9 = ops.launch_counts()["flash_attention"]
    with mock.patch.object(ops, "flash_attention", ref.flash_attention):
        want = prefill(params, short)
        want_all, _ = lm.forward(cfg, params, short)
    check(n_b9 == 2 * cfg.n_layers, f"qwen2-vl check: B9 launches {n_b9}")
    d = float((got - want).abs().max())
    lim = 2e-2 * max(1.0, float(want.abs().max()))
    d_all = (got_all - want_all).abs().amax(-1)
    worst = float((d_all / (2e-2 * want_all.abs().amax(-1).clamp_min(1.0)))
                  .max())
    check(bool(torch.isfinite(got_all).all()) and d < lim and worst < 1.0,
          f"qwen2-vl x{cfg.n_layers} at T = {QWEN2VL_CHECK_T}: B9 route vs "
          f"plain attention max abs diff {d:.3e} (limit {lim:.3e}), worst "
          f"position at {worst:.3f} of its limit")
    say(f"(b) qwen2-vl {cfg.n_layers} layers, T = {QWEN2VL_CHECK_T} "
        f"({cfg.vis_tokens} vision + {QWEN2VL_CHECK_T - cfg.vis_tokens} "
        f"text): last-position logits through B9 vs the plain attention on "
        f"the card max abs diff {d:.3e} (< {lim:.3e}); all positions' logits"
        f" (lm.forward) max abs diff {float(d_all.max()):.3e}, worst position"
        f" at {worst:.3f} of its limit")
    del params, got_all, want_all


# phase 31: B9's backward at starcoder2-3b's training shape (H 24 / KV 2,
# hd 128, T 4,096, batch 2 a microbatch) in bf16 and f32, whisper's encoder
# shape (full), and an hd 256 cell; each gradient within its rule against
# kernels/ref.py's f32 plain backward
FLASH_BWD_CELLS = (("starcoder2 train", 2, 4096, 24, 2, 128, True,
                    torch.bfloat16),
                   ("starcoder2 train f32", 2, 4096, 24, 2, 128, True,
                    torch.float32),
                   ("whisper encoder", 8, 1500, 20, 20, 64, False,
                    torch.bfloat16),
                   ("hd 256", 1, 4096, 8, 2, 256, True, torch.bfloat16))
# phase 32: starcoder2-3b at full width and depth (3,180,705,792 random bf16
# parameters from a seed, the JAX package's count_params), train_4k with
# the global batch cut from 256 to STAR_B = STAR_ACCUM microbatches of
# STAR_B / STAR_ACCUM x 4,096 tokens, remat on; one warm-up step, then
# STAR_STEPS timed; check (a) at STAR_CHECK_LAYERS layers, one microbatch
STAR_PARAMS, STAR_B, STAR_T, STAR_ACCUM = 3_180_705_792, 4, 4096, 2
STAR_STEPS, STAR_CHECK_LAYERS = 3, 2


def flash_bwd_ratio(got, want) -> float:
    """Worst share of its rule over a gradient's elements: f32 1e-4 *
    max(1, max |want|); bf16 2^-6 |want| + 2^-8 max |want|."""
    want = want.float()
    err = (got.float() - want).abs()
    top = float(want.abs().max())
    if got.dtype == torch.float32:
        return float(err.max()) / (1e-4 * max(1.0, top))
    return float((err / (2.0 ** -6 * want.abs() + 2.0 ** -8 * top)).max())


def phase_flash_bwd(report: dict) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        bwd_plan, bwd_route_of, flash_attention_bwd_cuda,
        flash_attention_cuda)
    F = torch.nn.functional
    for name, B, T, H, KV, hd, causal, dtype in FLASH_BWD_CELLS:
        g = torch.Generator(device=DEVICE).manual_seed(31 + hd)
        q, do = (torch.randn(B, T, H, hd, generator=g, device=DEVICE)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, T, KV, hd, generator=g, device=DEVICE)
                .to(dtype) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=causal, with_lse=True)
        check(torch.equal(o, flash_attention_cuda(q, k, v, causal=causal)),
              f"B9 backward, {name}: the forward's o with lse differs from "
              "the forward without it")
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
        want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        ratios = [flash_bwd_ratio(a, w) for a, w in zip(got, want)]
        errs = [float((a.float() - w).abs().max()) for a, w in zip(got, want)]
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"B9 backward, {name}: non-finite gradient")
        check(max(ratios) <= 1.0, f"B9 backward, {name}: dq / dk / dv at "
              f"{ratios} of their rules (max abs err {errs})")
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"B9 backward, {name}: two launches differ")
        del again, want
        ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                      causal=causal))
        plain_ms = cuda_ms(lambda: ref.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), reps=1, warmup=0)
        # scaled_dot_product_attention's backward on the same tensors (its
        # [B, H, T, hd] layout), the yardstick; TF32 off
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                             enable_gqa=True)
        dos = do.transpose(1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), dos, retain_graph=True))
        del out, qs, ks, vs, dos
        # 10 hd operations per visible pair (S, dP, dV, dQ, dK), each input
        # read once, each gradient written once; issued: what the route's
        # kernels compute (wgmma: whole tiles, BwdPlan.issued_ops; tf32x3:
        # S and dP in both launches, each product three TF32 ones in f32,
        # and in bf16 S and dP one, the others two: 42 / 20 hd a pair).
        # The split's bound: the algorithm's products as the split issues
        # them (30 / 16 hd) at the TF32 rate
        n_ops = 2.5 * flash_ops(B, T, T, H, hd, causal)
        route = bwd_route_of(dtype, hd)
        f32 = dtype == torch.float32
        issued = (bwd_plan(B, T, T, H, KV, hd, causal).issued_ops()
                  if route == "wgmma" else (4.2 if f32 else 2.0) * n_ops)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
            else PEAK_FP32_FLOPS
        b_ms, b_by = bound(nbytes(q, k, v, o, lse, do, *got), n_ops, peak)
        split_ms = (bound(nbytes(q, k, v, o, lse, do, *got),
                          (3.0 if f32 else 1.6) * n_ops, PEAK_TF32_FLOPS)[0]
                    if route == "tf32x3" else None)
        split = (f"; the split's bound {split_ms:.3f} ms at 495 TFLOP/s TF32"
                 f" ({split_ms / ms:.3f} of it)" if split_ms else "")
        say(f"B9 backward {name} ({str(dtype)[6:]}, {route} route) q "
            f"{tuple(q.shape)} kv {tuple(k.shape)} causal={causal}: dq / dk "
            f"/ dv max abs err {errs[0]:.3e} / {errs[1]:.3e} / "
            f"{errs[2]:.3e}, {ratios[0]:.3f} / {ratios[1]:.3f} / "
            f"{ratios[2]:.3f} of the rule; o with lse bit-equal, two "
            f"launches bit-equal; kernel {ms:.3f} ms ({issued / ms / 1e9:.1f}"
            f" TFLOP/s issued, {n_ops / ms / 1e9:.1f} counted at 10 hd a "
            f"pair; {b_ms / ms:.3f} of the bound), plain {plain_ms:.3f} ms, "
            f"sdpa backward {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}, "
            f"{n_ops:.3e} operations on "
            f"{'bf16 tensor cores' if peak == PEAK_BF16_FLOPS else 'fp32'}"
            f"{split})")
        cell = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    route=route, tflops_issued=issued / ms / 1e9,
                    tflops=n_ops / ms / 1e9, bound_share=b_ms / ms,
                    bound_split_ms=split_ms, rule_share=max(ratios))
        if name == "starcoder2 train":
            report["flash_attention_bwd"] = dict(
                cell, launches=0, **{"bwd_" + k: cell[k] for k in (
                    "route", "tflops_issued", "tflops", "bound_share")})
        else:
            tag = {"starcoder2 train f32": "f32_",
                   "whisper encoder": "whisper_", "hd 256": "hd256_"}[name]
            report["flash_attention_bwd"].update(
                {tag + k: cell[k] for k in ("ms", "library_ms", "bound_ms",
                                            "max_abs_err", "route",
                                            "tflops_issued", "tflops",
                                            "bound_share", "bound_split_ms",
                                            "rule_share")})
        del q, k, v, o, lse, do, got


def loss_and_grads(cfg, params, batch):
    """(loss, {leaf path: gradient}) of ``lm.loss_fn`` through
    torch.autograd (the plain route or B9, whichever ops.flash_attention
    is)."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    paths, leaves = zip(*tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _metrics = lm.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss.detach()), dict(zip(paths, grads))


def phase_starcoder2_train(report: dict) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch, make_pipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    cfg = get_config("starcoder2_3b")
    n_params = lm.count_params(cfg)
    check(n_params == STAR_PARAMS and cfg.n_layers == 30 and cfg.remat,
          f"starcoder2-3b: {n_params} parameters, {cfg.n_layers} layers, "
          f"remat {cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    before = alloc_counters()
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params)
    state_bytes = record_resident(report, "starcoder2_3b", before,
                                  params=params, opt=opt)
    say(f"starcoder2-3b: {n_params} random bf16 parameters from a seed and "
        f"their f32 AdamW moments, {state_bytes / 2**30:.3f} GiB on the "
        f"card; train_4k cut to a batch of {STAR_B} x {STAR_T} tokens in "
        f"{STAR_ACCUM} microbatches, remat on")
    step = build_train_step(cfg, opt_cfg, accum=STAR_ACCUM)
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, batch=STAR_B,
                      seq_len=STAR_T)
    pipe = make_pipeline(dcfg, device=DEVICE)
    try:
        # the warm-up's window opens on an emptied cache: the allocator's
        # reserved-over-requested peak there is a step's own slack (phase
        # 35's budget)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        opened = window_open()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, next(pipe))      # warm-up
        warm_loss = float(met["loss"])
        cold = window_close(opened)
        say(f"warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"loss {warm_loss:.4f}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        times, losses, gnorms, windows = [], [], [], []
        top = 0
        for _ in range(STAR_STEPS):
            batch = next(pipe)
            torch.cuda.synchronize()
            top = max(top, torch.cuda.max_memory_allocated())
            opened = window_open()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            times.append(time.perf_counter() - t0)
            windows.append(window_close(opened))
        counts = ops.launch_counts()
        peak = max(top, torch.cuda.max_memory_allocated()) - base
        fwd, bwd = counts["flash_attention"], counts["flash_attention_bwd"]
        want_fwd = 2 * cfg.n_layers * STAR_ACCUM * STAR_STEPS
        want_bwd = cfg.n_layers * STAR_ACCUM * STAR_STEPS
        check(fwd == want_fwd and bwd == want_bwd,
              f"train steps: B9 forward {fwd} / backward {bwd} launches, "
              f"expected {want_fwd} / {want_bwd} (remat runs each forward "
              "twice)")
        check(all(np.isfinite(losses)) and all(np.isfinite(gnorms))
              and min(gnorms) > 0, f"train steps: loss {losses}, grad norm "
              f"{gnorms}")
        step_ms = 1e3 * sum(times) / len(times)
        tps = STAR_B * STAR_T / (step_ms / 1e3)
        report["flash_attention"]["train_launches"] = fwd // STAR_STEPS
        report["flash_attention_bwd"]["launches"] = bwd
        report["flash_attention_bwd"].update(
            train_step_ms=step_ms, train_tokens_per_s=tps)
        report["dry_run"]["starcoder2_3b"].update(
            kind="train", batch=STAR_B, seq=STAR_T, ms=step_ms,
            accum=STAR_ACCUM, rise=[w[0] for w in windows],
            headroom=[w[1] for w in windows], cold_headroom=cold[1],
            tokens=batch["tokens"].dtype)
        say(f"starcoder2-3b train step ({STAR_B} x {STAR_T} tokens, "
            f"accum {STAR_ACCUM}): {step_ms:.1f} ms a step (host clock, "
            f"synchronized; steps {', '.join(f'{1e3 * t:.1f}' for t in times)}"
            f" ms), {tps:.0f} tokens/s, peak {peak / 2**30:.3f} GiB above the "
            f"parameters and optimizer state; B9 launches a step: forward "
            f"{fwd // STAR_STEPS}, backward {bwd // STAR_STEPS}; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}, grad norms "
            f"{', '.join(f'{x:.4f}' for x in gnorms)}")
        split = device_breakdown(lambda: step(params, opt, next(pipe)))
    finally:
        pipe.close()
    dev_ms = say_breakdown("starcoder2-3b train step", split,
                           {"flash_attention": fwd // STAR_STEPS,
                            "flash_attention_bwd": bwd // STAR_STEPS})
    if dev_ms > 0:
        report["flash_attention_bwd"].update(
            train_ms=split["b9_bwd"] / (bwd // STAR_STEPS),
            train_share=split["b9_bwd"] / dev_ms,
            train_idle_share=split["idle"])
    # AdamW alone over the whole model (zero bf16 gradients, the same work)
    zeros = tree_map(torch.zeros_like, params)
    adam_ms = cuda_ms(lambda: adamw_update(opt_cfg, zeros, opt, params),
                      reps=2)
    say(f"AdamW update alone over {n_params} parameters: {adam_ms:.1f} ms "
        "(CUDA events)")
    report["flash_attention_bwd"]["train_adamw_ms"] = adam_ms
    del zeros, opt

    # (a) at STAR_CHECK_LAYERS layers of the same widths, one microbatch:
    # the loss and every parameter gradient through B9 (forward and
    # backward kernels) against the plain attention of kernels/ref.py
    # patched in by this script (never a route of the entry point)
    cfg2 = dataclasses.replace(cfg, n_layers=STAR_CHECK_LAYERS)
    params2 = dict(params, layers=tree_map(
        lambda a: a[:STAR_CHECK_LAYERS].clone(), params["layers"]))
    mb = {k: torch.as_tensor(v[:STAR_B // STAR_ACCUM], device=DEVICE)
          for k, v in make_batch(dcfg, 9).items()}
    ops.reset_launch_counts()
    loss_k, g_k = loss_and_grads(cfg2, params2, mb)
    counts = ops.launch_counts()
    with mock.patch.object(ops, "flash_attention", ref.flash_attention):
        loss_p, g_p = loss_and_grads(cfg2, params2, mb)
    check(counts["flash_attention"] == 2 * STAR_CHECK_LAYERS
          and counts["flash_attention_bwd"] == STAR_CHECK_LAYERS,
          f"check (a): B9 launches {counts}")
    d_loss = abs(loss_k - loss_p)
    check(d_loss <= 2e-2 * max(1.0, abs(loss_p)), f"check (a): loss through "
          f"B9 {loss_k:.6f}, plain {loss_p:.6f}")
    worst, worst_rel, worst_leaf = 0.0, 0.0, ""
    for path, gp in g_p.items():
        gk = g_k[path]
        check(bool(torch.isfinite(gk).all()), f"check (a): {path} not finite")
        d = float((gk.float() - gp.float()).abs().max())
        top = float(gp.abs().max())
        r = d / (2e-2 * max(1.0, top))
        if r > worst:
            worst, worst_leaf = r, "/".join(path)
        worst_rel = max(worst_rel, d / max(top, 1e-30))
    check(worst <= 1.0, f"check (a): gradient of {worst_leaf} at {worst:.3f}"
          " of 2e-2 max(1, max |g|)")
    say(f"(a) starcoder2-3b {STAR_CHECK_LAYERS} layers, one microbatch of "
        f"{STAR_B // STAR_ACCUM} x {STAR_T}: loss through B9 {loss_k:.6f}, "
        f"plain attention {loss_p:.6f} (diff {d_loss:.3e}); all "
        f"{len(g_p)} gradient leaves within {worst:.4f} of 2e-2 max(1, "
        f"max |g|) (worst {worst_leaf}); largest difference relative to "
        f"its leaf's max |g| {worst_rel:.3e}")
    del params, params2, g_k, g_p


# phase 33: B10's backward against its plain version (kernels/ref.py,
# f32) at mamba2-130m's training shape (layer 0's real inputs on a train_4k
# microbatch of MAMBA_B / MAMBA_ACCUM x MAMBA_T tokens) and on jamba's
# layer 0 at full width (JAMBA_BWD_T prompt tokens through its projection
# and convolution), both at real dt spans and also against a float64
# gradient, and on a
# dyadic cell with dt * A > 0; jamba's layer-0 mamba_block forward and
# backward through B10 against the plain version's autograd.  Phase 34:
# mamba2-130m at full width and depth (the JAX package's count_params),
# train_4k with the global batch cut from 256 to MAMBA_B in MAMBA_ACCUM
# microbatches, remat on; one warm-up step, then MAMBA_STEPS timed; check
# (a) at MAMBA_CHECK_LAYERS layers, one microbatch
MAMBA_PARAMS, MAMBA_B, MAMBA_T, MAMBA_ACCUM = 128_983_488, 16, 4096, 2
MAMBA_STEPS, MAMBA_CHECK_LAYERS = 3, 2
JAMBA_BWD_T = 4096
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def b10_bwd_ops(Bsz: int, T: int, H: int, Pd: int, N: int, L: int) -> float:
    """B10 backward's operations: per visible pair (j <= i) and head 4 Pd
    (G = dy x^T, dx += W^T dy), per position and head 4 N Pd (u = B dS and
    dB's S term), per visible pair 6 N once per (batch row, chunk) (C B^T,
    dC, dB)."""
    nc, tri = T // L, L * (L + 1) // 2
    return Bsz * nc * (H * (4.0 * Pd * tri + 4.0 * N * Pd * L)
                       + 6.0 * N * tri)


def b10_bwd_issued(Bsz: int, T: int, H: int, Pd: int, N: int,
                   L: int) -> float:
    """The operations csrc/ssd_chunk_bwd.cu issues (2 a multiply-add), its
    loops' trip counts: C B^T in 64 x 64 tiles of each column strip, N in
    stages of 32; per group of 8 heads and 64-column j-tile, u over N in
    stages of 16 and W^T dy in 16-row slices, both on 8 P_pad (64 or 128)
    columns, and G on each 64 x 64 tile (i >= j) over P in stages of 8; dC,
    dB and dB's S term on warp tiles of 256 / CL rows x 16 CL columns (CL 1,
    2 or 4 by N), their stages of KD (16 KS, or 8 KS for KS > 2) as the
    kernel walks them."""
    def up(a: int, m: int) -> int:
        return -(-a // m) * m
    nc, nt, groups = T // L, -(-L // 64), -(-H // 8)
    pp = 64 if Pd <= 64 else 128
    cb = dx = g = 0
    for jt in range(nt):
        ni = L - 64 * jt
        cb += -(-ni // 64) * 64 * 64 * up(N, 32)
        dx += 8 * pp * 64 * (up(N, 16) + up(ni, 16))
        g += (nt - jt) * 8 * 64 * 64 * up(Pd, 8)
    CL = 1 if N <= 16 else 2 if N <= 32 else 4
    KS = {1: 8, 2: 4}.get(CL, 2 if N <= 64 else 1)
    ns, KD = 8 // CL // KS, (16 if KS <= 2 else 8) * KS
    RW, NW = 256 // CL, 16 * CL
    stages = 0
    for rt in range(CL):
        if rt * RW >= L:
            continue
        stages += sum(s * KD < rt * RW + RW for s in range(-(-L // KD)))
        stages += sum((s + 1) * KD > rt * RW for s in range(-(-L // KD)))
        stages += H * -(-Pd // KD)
    bc = stages * KD * RW * NW * ns * -(-N // (ns * NW))
    return 2.0 * Bsz * nc * (cb + groups * (dx + g) + bc)


def ssd_cotangents(x, Bm, L: int, seed: int):
    """Fixed random dy, dS, dcd from a seed, at the shapes of B10's
    outputs for these inputs."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    Bsz, T, H, Pd = x.shape
    return (torch.randn(Bsz, T, H, Pd, generator=g, device=DEVICE),
            torch.randn(Bsz, T // L, H, Bm.shape[-1], Pd, generator=g,
                        device=DEVICE),
            torch.randn(Bsz, T, H, generator=g, device=DEVICE))


def b10_bwd_cell(name: str, args, L: int, seed: int,
                 exact: bool = False) -> dict:
    """B10's backward on ``args`` with fixed random cotangents: each
    gradient within 1e-4 max(1, max |want|) of the plain version's, two
    launches bit-equal, timed (also by kernel) beside the plain version;
    with ``exact``, the kernel's and the plain version's errors against a
    float64 gradient."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_cuda
    x, dt, A, Bm, Cm = args
    cot = ssd_cotangents(x, Bm, L, seed)
    got = ssd_chunk_bwd_cuda(*args, *cot, chunk=L)
    want = ref.ssd_intra_chunk_bwd(*args, *cot, chunk=L)
    errs, ratios = [], []
    for n, g, w in zip(SSD_BWD_NAMES, got, want):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"B10 backward, {name}: {n} of the wrong shape or not finite")
        errs.append(float((g - w).abs().max()))
        ratios.append(errs[-1] / (1e-4 * max(1.0, float(w.abs().max()))))
    check(max(ratios) <= 1.0, f"B10 backward, {name}: gradients at "
          f"{[round(r, 4) for r in ratios]} of 1e-4 max(1, max |want|)")
    again = ssd_chunk_bwd_cuda(*args, *cot, chunk=L)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"B10 backward, {name}: two launches differ")
    del again
    note = ""
    if exact:
        e64 = ref.ssd_intra_chunk_bwd(*args, *cot, chunk=L,
                                      dtype=torch.float64)
        vs = []
        for n, g, w, e in zip(SSD_BWD_NAMES, got, want, e64):
            err_k = float((g.double() - e).abs().max())
            err_p = float((w.double() - e).abs().max())
            check(err_k <= 2 * err_p, f"B10 backward, {name}: {n} is "
                  f"{err_k:.3e} from the float64 gradient, the plain f32 "
                  f"version {err_p:.3e}")
            vs.append(f"{n} {err_k:.3e} / {err_p:.3e}")
        note = ("; against the float64 gradient, kernel / plain f32 max abs "
                "err " + ", ".join(vs))
        del e64
    del want
    ms = cuda_ms(lambda: ssd_chunk_bwd_cuda(*args, *cot, chunk=L))
    split = kernel_split(lambda: ssd_chunk_bwd_cuda(*args, *cot, chunk=L),
                         calls=10)
    plain_ms = cuda_ms(lambda: ref.ssd_intra_chunk_bwd(*args, *cot,
                                                       chunk=L),
                       reps=1, warmup=0)
    Bsz, T, H, Pd = x.shape
    N = Bm.shape[-1]
    n_ops = b10_bwd_ops(Bsz, T, H, Pd, N, L)
    issued = b10_bwd_issued(Bsz, T, H, Pd, N, L)
    b_ms, b_by = bound(nbytes(x, dt, A, Bm, Cm, *cot, *got), n_ops)
    say(f"B10 backward {name}: x {tuple(x.shape)} B / C {tuple(Bm.shape)} "
        f"chunk {L}, dt span per chunk up to "
        f"{float(-(dt * A).view(Bsz, T // L, L, H).sum(2).min()):.1f}: max "
        "abs err " + ", ".join(f"{n} {e:.3e}" for n, e in
                               zip(SSD_BWD_NAMES, errs))
        + f" ({max(ratios):.4f} of 1e-4 max(1, max |want|) at worst), two "
        f"launches bit-equal{note}; kernel {ms:.3f} ms ({n_ops / ms / 1e9:.2f}"
        f" TFLOP/s counted, {issued / ms / 1e9:.2f} issued: {issued:.4e} "
        f"operations as built, {issued / n_ops:.3f}x those counted; by "
        f"kernel: {split}), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {n_ops:.4e} fp32 operations; {b_ms / ms:.4f} of it)")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bound_share=b_ms / ms, issued_tflops=issued / ms / 1e9)


def jamba_layer0(seed: int):
    """jamba-v0.1's layer 0 (a Mamba layer) at full width: its embedding,
    norm and Mamba2 parameters, random bf16 from a seed (``init_tree``'s
    recipes), and the normed embeddings of JAMBA_BWD_T prompt tokens, its
    input.  Returns (cfg, ssm parameters, input [1, T, d])."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm, ssm
    from repro_torch.models.common import (apply_norm, embed_tokens,
                                           init_tree, norm_defs)
    cfg = get_config("jamba_v0_1_52b")
    check(cfg.pattern()[0] == "M", f"jamba's pattern {cfg.pattern()}")
    defs = {"embed": lm.model_defs(cfg)["embed"], "norm1": norm_defs(cfg),
            "ssm": ssm.ssm_defs(cfg)}
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    p = init_tree(defs, g, cfg.dtype, device=DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (1, JAMBA_BWD_T), generator=g,
                         device=DEVICE)
    with torch.no_grad():
        h = apply_norm(cfg, p["norm1"], embed_tokens(cfg, p, toks))
    return cfg, p["ssm"], h


def phase_ssd_bwd(report: dict) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm, ssm

    # mamba2-130m's training shape: layer 0's inputs on a microbatch
    cfg = get_config("mamba2_130m")
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    params = lm.init_params(cfg1, seed=0, device=DEVICE)
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size,
                      batch=MAMBA_B // MAMBA_ACCUM, seq_len=MAMBA_T)
    toks = torch.as_tensor(make_batch(dcfg, 0)["tokens"], device=DEVICE)
    kept: dict = {}
    with torch.no_grad(), first_args(ops, "ssd_intra_chunk", kept):
        x, positions = lm.embed_inputs(cfg1, params, {"tokens": toks})
        lm._apply_layer(cfg1, "M", 0, lm._index(params["layers"], 0)["pos0"],
                        x, positions)
    (args, kw), = kept.values()
    check(tuple(args[0].shape) == (MAMBA_B // MAMBA_ACCUM, MAMBA_T,
                                   SSM_HEADS, SSM_HEAD_DIM),
          f"mamba2-130m layer 0 called B10 with x {tuple(args[0].shape)}")
    del params, x, kept
    report["ssd_chunk_bwd"] = b10_bwd_cell(
        "mamba2-130m train_4k microbatch, layer 0's inputs", args,
        kw["chunk"], 33, exact=True)
    del args

    # jamba's layer 0 on its real inputs, and the dyadic growth cell
    cfg_j, p0, h = jamba_layer0(34)
    kept = {}
    with torch.no_grad(), first_args(ops, "ssd_intra_chunk", kept):
        ssm.mamba_block(cfg_j, p0, h)
    (args, kw), = kept.values()
    check(tuple(args[0].shape) == (1, JAMBA_BWD_T, cfg_j.ssm_heads,
                                   cfg_j.ssm_head_dim)
          and args[3].shape[-1] == cfg_j.ssm_state,
          f"jamba layer 0 called B10 with x {tuple(args[0].shape)}")
    cell = b10_bwd_cell("jamba-v0.1 layer 0, real inputs", args,
                        kw["chunk"], 35, exact=True)
    report["ssd_chunk_bwd"].update(
        {"jamba_" + k: cell[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "max_abs_err", "bound_share")})
    del args, kept
    L, H = 96, SSM_HEADS
    x, _dt, _A, Bm, Cm = ssd_inputs(36, 2, 2 * L)
    g = torch.Generator(device=DEVICE).manual_seed(37)
    dt = torch.randint(1, 9, (2, 2 * L, H), generator=g,
                       device=DEVICE).float() / 32
    A = torch.tensor([0.125, -1.0, 0.0625, -2.0, -0.5, 0.125, -1.5, -0.75,
                      0.0625, -1.0] * 3, device=DEVICE)[:H]
    b10_bwd_cell("dyadic dt, A > 0 on some heads", (x, dt, A, Bm, Cm), L,
                 38)
    del x, dt, A, Bm, Cm

    # jamba's layer-0 mamba_block, forward and backward with respect to its
    # parameters and its input: B10 and its backward against the plain
    # intra-chunk step and its autograd (patched in by this script, never
    # a route of the entry point), 2e-2 max(1, max |.|) (bf16 block)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p0.items()}
    hh = h.detach().clone().requires_grad_(True)
    g = torch.Generator(device=DEVICE).manual_seed(39)
    dout = torch.randn(h.shape, generator=g, device=DEVICE).to(h.dtype)

    def block_grads():
        out, _state = ssm.mamba_block(cfg_j, leaves, hh)
        return out.detach(), torch.autograd.grad(
            out, [hh, *leaves.values()], dout)

    ops.reset_launch_counts()
    out_k, g_k = block_grads()
    counts = ops.launch_counts()
    check(counts["ssd_chunk"] == 1 and counts["ssd_chunk_bwd"] == 1,
          f"jamba mamba_block: launches {counts}")
    with mock.patch.object(ops, "ssd_intra_chunk", ref.ssd_intra_chunk):
        out_p, g_p = block_grads()
    worst, worst_name = 0.0, ""
    for n, a, b in zip(["out", "input", *leaves], [out_k, *g_k],
                       [out_p, *g_p]):
        check(bool(torch.isfinite(a).all()), f"jamba mamba_block: {n} not "
              "finite")
        r = float((a.float() - b.float()).abs().max()) / (
            2e-2 * max(1.0, float(b.float().abs().max())))
        if r >= worst:
            worst, worst_name = r, n
    check(worst <= 1.0, f"jamba mamba_block through B10: {worst_name} at "
          f"{worst:.3f} of 2e-2 max(1, max |.|)")
    say(f"jamba-v0.1 layer-0 mamba_block on {JAMBA_BWD_T} prompt tokens "
        f"(bf16, d_model {cfg_j.d_model}, {cfg_j.ssm_heads} heads): output "
        f"and the gradients of its input and {len(leaves)} parameters "
        f"through B10 and its backward vs the plain step's autograd within "
        f"{worst:.4f} of 2e-2 max(1, max |.|) (worst {worst_name})")
    del p0, h, leaves, hh, g_k, g_p, out_k, out_p


def phase_mamba2_train(report: dict) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch, make_pipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config("mamba2_130m")
    n_params = lm.count_params(cfg)
    check(n_params == MAMBA_PARAMS and cfg.n_layers == 24 and cfg.remat,
          f"mamba2-130m: {n_params} parameters, {cfg.n_layers} layers, "
          f"remat {cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    before = alloc_counters()
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    opt = adamw_init(params)
    state_bytes = record_resident(report, "mamba2_130m", before,
                                  params=params, opt=opt)
    say(f"mamba2-130m: {n_params} random bf16 parameters from a seed and "
        f"their f32 AdamW moments, {state_bytes / 2**30:.3f} GiB on the "
        f"card; train_4k cut to a batch of {MAMBA_B} x {MAMBA_T} tokens in "
        f"{MAMBA_ACCUM} microbatches, remat on")
    step = build_train_step(cfg, AdamWConfig(), accum=MAMBA_ACCUM)
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, batch=MAMBA_B,
                      seq_len=MAMBA_T)
    pipe = make_pipeline(dcfg, device=DEVICE)
    try:
        torch.cuda.synchronize()            # as phase 32: a cold window
        torch.cuda.empty_cache()
        opened = window_open()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, next(pipe))      # warm-up
        say(f"warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms, loss "
            f"{float(met['loss']):.4f}")
        cold = window_close(opened)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        times, losses, gnorms, windows = [], [], [], []
        top = 0
        for _ in range(MAMBA_STEPS):
            batch = next(pipe)
            torch.cuda.synchronize()
            top = max(top, torch.cuda.max_memory_allocated())
            opened = window_open()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            times.append(time.perf_counter() - t0)
            windows.append(window_close(opened))
        counts = ops.launch_counts()
        peak = max(top, torch.cuda.max_memory_allocated()) - base
        fwd, bwd = counts["ssd_chunk"], counts["ssd_chunk_bwd"]
        want_fwd = 2 * cfg.n_layers * MAMBA_ACCUM * MAMBA_STEPS
        want_bwd = cfg.n_layers * MAMBA_ACCUM * MAMBA_STEPS
        check(fwd == want_fwd and bwd == want_bwd,
              f"train steps: B10 {fwd} / backward {bwd} launches, expected "
              f"{want_fwd} / {want_bwd} (remat runs each forward twice)")
        check(all(np.isfinite(losses)) and all(np.isfinite(gnorms))
              and min(gnorms) > 0, f"train steps: loss {losses}, grad norm "
              f"{gnorms}")
        step_ms = 1e3 * sum(times) / len(times)
        tps = MAMBA_B * MAMBA_T / (step_ms / 1e3)
        report["ssd_chunk"]["train_launches"] = fwd // MAMBA_STEPS
        report["ssd_chunk_bwd"].update(
            launches=bwd, train_step_ms=step_ms, train_tokens_per_s=tps,
            train_peak_gib=peak / 2**30)
        report["dry_run"]["mamba2_130m"].update(
            kind="train", batch=MAMBA_B, seq=MAMBA_T, ms=step_ms,
            accum=MAMBA_ACCUM, rise=[w[0] for w in windows],
            headroom=[w[1] for w in windows], cold_headroom=cold[1],
            tokens=batch["tokens"].dtype)
        say(f"mamba2-130m train step ({MAMBA_B} x {MAMBA_T} tokens, accum "
            f"{MAMBA_ACCUM}): {step_ms:.1f} ms a step (host clock, "
            f"synchronized; steps {', '.join(f'{1e3 * t:.1f}' for t in times)}"
            f" ms), {tps:.0f} tokens/s, peak {peak / 2**30:.3f} GiB above the "
            f"parameters and optimizer state; B10 launches a step: forward "
            f"{fwd // MAMBA_STEPS}, backward {bwd // MAMBA_STEPS}; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}, grad norms "
            f"{', '.join(f'{x:.4f}' for x in gnorms)}")
        split = device_breakdown(lambda: step(params, opt, next(pipe)))
    finally:
        pipe.close()
    dev_ms = say_breakdown("mamba2-130m train step", split,
                           {"ssd_chunk": fwd // MAMBA_STEPS,
                            "ssd_chunk_bwd": bwd // MAMBA_STEPS})
    if dev_ms > 0:
        report["ssd_chunk_bwd"].update(
            train_ms=split["b10_bwd"] / (bwd // MAMBA_STEPS),
            train_share=split["b10_bwd"] / dev_ms,
            train_idle_share=split["idle"])
    del opt

    # (a) at MAMBA_CHECK_LAYERS layers of the same widths, one microbatch:
    # the loss and every parameter gradient through B10 and its backward
    # against the plain intra-chunk step of kernels/ref.py and its autograd
    # (patched in by this script, never a route of the entry point)
    cfg2 = dataclasses.replace(cfg, n_layers=MAMBA_CHECK_LAYERS)
    params2 = dict(params, layers=tree_map(
        lambda a: a[:MAMBA_CHECK_LAYERS].clone(), params["layers"]))
    mb = {k: torch.as_tensor(v[:MAMBA_B // MAMBA_ACCUM], device=DEVICE)
          for k, v in make_batch(dcfg, 9).items()}
    ops.reset_launch_counts()
    loss_k, g_k = loss_and_grads(cfg2, params2, mb)
    counts = ops.launch_counts()
    with mock.patch.object(ops, "ssd_intra_chunk", ref.ssd_intra_chunk):
        loss_p, g_p = loss_and_grads(cfg2, params2, mb)
    check(counts["ssd_chunk"] == 2 * MAMBA_CHECK_LAYERS
          and counts["ssd_chunk_bwd"] == MAMBA_CHECK_LAYERS,
          f"check (a): B10 launches {counts}")
    d_loss = abs(loss_k - loss_p)
    check(d_loss <= 2e-2 * max(1.0, abs(loss_p)), f"check (a): loss through "
          f"B10 {loss_k:.6f}, plain {loss_p:.6f}")
    worst, worst_rel, worst_leaf = 0.0, 0.0, ""
    for path, gp in g_p.items():
        gk = g_k[path]
        check(bool(torch.isfinite(gk).all()), f"check (a): {path} not finite")
        d = float((gk.float() - gp.float()).abs().max())
        top = float(gp.abs().max())
        r = d / (2e-2 * max(1.0, top))
        if r >= worst:
            worst, worst_leaf = r, "/".join(path)
        worst_rel = max(worst_rel, d / max(top, 1e-30))
    check(worst <= 1.0, f"check (a): gradient of {worst_leaf} at {worst:.3f}"
          " of 2e-2 max(1, max |g|)")
    say(f"(a) mamba2-130m {MAMBA_CHECK_LAYERS} layers, one microbatch of "
        f"{MAMBA_B // MAMBA_ACCUM} x {MAMBA_T}: loss through B10 "
        f"{loss_k:.6f}, plain step {loss_p:.6f} (diff {d_loss:.3e}); all "
        f"{len(g_p)} gradient leaves within {worst:.4f} of 2e-2 max(1, "
        f"max |g|) (worst {worst_leaf}); largest difference relative to "
        f"its leaf's max |g| {worst_rel:.3e}")
    del params, params2, g_k, g_p


# phase 35: the dry run (launch/dryrun.py) on a host with the card.  (a)
# the whole sweep on both production meshes: 66 records, no error, and
# the card's allocator untouched (a fresh process running the same sweep
# leaves CUDA uninitialised); (b) on a one-device mesh at each phase's own
# cut shape, its predicted bytes of the resident state of phases 24, 32
# and 34 against the allocator's counters: the bytes asked for exactly,
# and the bytes it holds: the tensors' blocks in its snapshot, each the
# tensor rounded up to 512 bytes plus at most a 1 MiB unsplit tail in the
# large pool, summing to the rise exactly; (c) model flops a step over
# the measured step time, as a share of the dense bf16 tensor-core peak
#
# (d) the requested bytes a step adds above the resident state, predicted
# by the dry run's trace on meta tensors (launch/meta_trace.py) on a
# one-device mesh at each phase's own cut shape and accum, against the
# rise of the allocator's requested_bytes.all.peak over each step those
# phases timed (window_open / window_close, no step added): equal, or
# above it by exactly one batch where the train phases' pipeline thread
# puts its next batch on the card inside the window; (e) the same for
# every rank of phases 38 and 39 (a rank's batch is on the card before its
# window), traced in the rank on its rank of a CountingComm mesh: equal;
# (f) the counting comm's collectives by kind and bytes against the ranks'
# DistributedComm counters over the same steps: equal; (g) the counted
# flops a step beside model flops, both over the measured step as shares
# of the bf16 peak; (h) the sweep's accum / fits / footprint of the train
# records; and the memory budget of dryrun.HBM_BUDGET derived from the
# card: its memory less the CUDA context and the most the allocator
# reserved above the requested bytes in a step begun on an emptied cache.
DRY_RUN_CELLS = ("starcoder2_3b", "mamba2_130m", "qwen3_14b")
PEAK_BF16_FLOPS = 989e12     # one H100 SXM, dense bf16 tensor cores
ALLOC_BLOCK = 512            # the caching allocator's block rounding
ALLOC_TAIL = 2**20           # the largest rest it leaves unsplit in a block


def dry_run_bytes(report: dict) -> None:
    """Phase 35 (b): the dry run's bytes of each resident state that
    ``record_resident`` kept in ``report["dry_run"]``, on a one-device
    mesh at the phase's own cut shape, against the allocator's counters
    and its snapshot of the tensors' blocks."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import Shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    one = Mesh(("data", "model"), (1, 1))
    for arch in DRY_RUN_CELLS:
        rec = report["dry_run"][arch]
        cfg = get_config(arch)
        shape = Shape(f"{rec['kind']}_cut", rec["kind"], rec["seq"],
                      rec["batch"])
        groups = {path.split("/", 1)[0] for path in rec["leaves"]}
        leaves = {leaf.path: leaf for leaf in dryrun.cell_leaves(
            cfg, shape, one) if leaf.path.split("/", 1)[0] in groups}
        check({p: (leaf.shape, leaf.dtype) for p, leaf in leaves.items()}
              == {p: v[:2] for p, v in rec["leaves"].items()},
              f"{arch}: the dry run's leaves are not the card's")
        on_card = [leaves[p].nbytes(one) for p, v in rec["leaves"].items()
                   if v[2] == "cuda"]
        host = sorted(p for p, v in rec["leaves"].items() if v[2] != "cuda")
        raw = sum(on_card)
        blocks = sum(-(-n // ALLOC_BLOCK) * ALLOC_BLOCK for n in on_card)
        check(raw == rec["requested"], f"{arch}: predicted {raw} bytes, the"
              f" card's tensors asked for {rec['requested']}")
        # memory_allocated counts whole blocks.  The allocator rounds a
        # request up to 512 bytes and splits the rest of the block it takes
        # off, except, in its large pool (requests over 1 MiB), a rest of
        # at most 1 MiB: that unsplit tail stays in the tensor's block.
        # Whether a tensor gets one depends on the free block it lands in
        # (a new segment is the request rounded up to 2 MiB, or 20 MiB
        # below 10 MiB), so the rise is held to the blocks the allocator
        # reports for these tensors, and each tail to that rule
        held_at = rec["blocks"]
        check(None not in held_at.values() and len(
            {b[3] for b in held_at.values()}) == len(on_card),
            f"{arch}: a tensor's storage is not the start of an allocator "
            f"block: {[p for p, b in held_at.items() if b is None][:3]}")
        tails = {p: b[0] - -(-leaves[p].nbytes(one) // ALLOC_BLOCK)
                 * ALLOC_BLOCK for p, b in held_at.items()}
        bad = [p for p, t in tails.items() if t < 0 or t > (
            ALLOC_TAIL if held_at[p][1] == "large" else 0)]
        check(not bad, f"{arch}: blocks against the 512-byte rule: "
              f"{[(p, held_at[p], tails[p]) for p in bad][:3]}")
        in_blocks = sum(b[0] for b in held_at.values())
        check(in_blocks == rec["alloc"], f"{arch}: the tensors' blocks hold"
              f" {in_blocks} bytes, memory_allocated rose by {rec['alloc']}")
        large = [p for p, b in held_at.items() if b[1] == "large"]
        tailed = [p for p in large if tails[p]]
        fresh = [p for p in large if held_at[p][2]]
        say(f"(b) {arch} {' + '.join(sorted(groups))} ({len(on_card)} "
            f"tensors on the card{', host: ' + ', '.join(host) if host else ''}"
            f"): predicted {raw} bytes ({raw / 2**30:.4f} GiB), requested "
            f"from the allocator {rec['requested']}; predicted in 512-byte "
            f"blocks {blocks}, memory_allocated rose by {rec['alloc']} "
            f"(+{rec['alloc'] - blocks}): the allocator's snapshot gives "
            f"these tensors {in_blocks} bytes of blocks; {len(large)} in its "
            f"large pool, {len(fresh)} of them in a segment new since "
            f"before the state was made, {len(tailed)} with an unsplit tail "
            f"({sum(tails[p] for p in tailed)} bytes"
            f"{': ' + ', '.join(tailed) if tailed else ''}); expandable "
            f"segments {rec['expandable']}")


def phase_dry_run(report: dict, smi: str) -> None:
    import io
    import os
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import Shape, all_cells
    from repro_torch.launch import dryrun

    # (a) the sweep, in this process and in a fresh one (started first,
    # so the two run side by side on the host's cores)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    held = alloc_counters()
    with tempfile.TemporaryDirectory() as tmp:
        out, fresh = Path(tmp) / "dryrun.json", Path(tmp) / "fresh.json"
        code = ("import sys, torch\n"
                "from repro_torch.launch import dryrun\n"
                "dryrun.main(['--all', '--out', sys.argv[1]])\n"
                "print('CUDA initialised:', torch.cuda.is_initialized())\n")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", code, str(fresh)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                records = dryrun.main(["--all", "--out", str(out)])
            secs = time.perf_counter() - t0
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        fresh_s = time.perf_counter() - t0
        written = json.loads(out.read_text())
        r = subprocess.CompletedProcess(proc.args, proc.returncode, stdout,
                                        stderr)
        check(r.returncode == 0, f"dry run in a fresh process: "
              f"{r.stderr[-2000:]}")
        fresh_records = json.loads(fresh.read_text())
    cells = {(a, s.name, mp) for a, s in all_cells() for mp in (False, True)}

    def untimed(recs):
        # every figure but the seconds the traces took
        return [{k: v for k, v in c.items() if k != "compile_s"}
                for c in recs]
    check(untimed(written) == untimed(json.loads(json.dumps(records)))
          == untimed(fresh_records),
          "dry run: the records written, returned and made in a fresh "
          "process differ")
    check(len(written) == len(cells) == 66 and not [
        c for c in written if "error" in c] and {
        (c["arch"], c["shape"], c["multi_pod"]) for c in written} == cells,
        f"dry run: {len(written)} records, errors "
        f"{[c for c in written if 'error' in c][:3]}")
    check(alloc_counters() == held and torch.cuda.memory_stats()[
        "allocation.all.allocated"] == allocs,
        "dry run: the card's allocator moved")
    check("CUDA initialised: False" in r.stdout,
          f"dry run in a fresh process initialised CUDA: {r.stdout[-500:]}")
    big = max(written, key=lambda c: c["memory"]["argument_bytes"])
    say(f"(a) dry run --all: {len(written)} records (33 cells x 2 "
        f"production meshes), no error, in {secs:.2f} s on the host (the "
        f"fresh process beside it: {fresh_s:.2f} s; the traces' "
        f"compile_s sum {sum(c['compile_s'] for c in written):.1f}); the "
        f"card's allocator unchanged ({held[0]} bytes held, {allocs} "
        f"allocations before and after); a fresh process running the same "
        f"sweep left CUDA uninitialised and wrote the same records; largest"
        f" per-device arguments {big['arch']} x {big['shape']} mp="
        f"{big['multi_pod']}: {big['memory']['argument_bytes'] / 2**30:.3f}"
        " GiB")

    # (b) predicted bytes of the resident state against the allocator
    dry_run_bytes(report)

    # (c) model flops over the measured step
    for arch in DRY_RUN_CELLS:
        rec = report["dry_run"][arch]
        shape = Shape(f"{rec['kind']}_cut", rec["kind"], rec["seq"],
                      rec["batch"])
        flops, tokens = dryrun.model_flops(get_config(arch), shape)
        rate = flops / (rec["ms"] / 1e3)
        rec.update(model_flops=flops, tflops=rate / 1e12,
                   peak_share=rate / PEAK_BF16_FLOPS)
        say(f"(c) {arch} {rec['kind']} {rec['batch']} x {rec['seq']} "
            f"({tokens} tokens): {flops:.4e} model flops in {rec['ms']:.1f} "
            f"ms = {rate / 1e12:.1f} TFLOP/s, {rate / PEAK_BF16_FLOPS:.4f} of"
            f" the 989 TFLOP/s dense bf16 peak; card {smi}")

    # the budget, (d) the peaks, (g) the counted cost, (h) the sweep
    dry_run_budget(report, smi)
    dry_run_peaks(report, smi)
    train = [c for c in written if c["kind"] == "train"]
    check(len(train) == 20, f"dry run: {len(train)} train records")
    say("(h) --all's train records (accum, fits_hbm, footprint GiB; "
        f"budget {dryrun.HBM_BUDGET / 2**30:.3f} GiB): " + "; ".join(
            f"{c['arch']}{' mp' if c['multi_pod'] else ''} {c['accum']}, "
            f"{c['fits_hbm']}, {c['footprint_bytes'] / 2**30:.3f}"
            for c in train))


def dry_run_budget(report: dict, smi: str) -> None:
    """The footprint budget of one card, from the card: its memory, less
    the CUDA context (what the device holds outside the allocator's
    segments) and the most the allocator reserved above the bytes the
    tensors asked for in a step that began on an emptied cache (phase
    24's timed prefill, the warm-up steps of phases 32 and 34: 512-byte
    rounding, unsplit tails, split segments).  The dry run's
    ``HBM_BUDGET`` may be no more."""
    from repro_torch.launch import dryrun
    free, total = torch.cuda.mem_get_info()
    context = total - free - torch.cuda.memory_reserved()
    slack = {arch: report["dry_run"][arch]["cold_headroom"]
             for arch in DRY_RUN_CELLS}
    headroom = max(slack.values())
    budget = total - context - headroom
    report["dry_run_budget"] = budget
    say(f"budget: {total} bytes of device memory ({total / 2**30:.3f} GiB,"
        f" total_memory {torch.cuda.get_device_properties(0).total_memory}"
        f"), less {context} of CUDA context ({context / 2**30:.3f} GiB) and "
        f"{headroom} reserved above requested at the most in a step begun "
        f"on an emptied cache (" + ", ".join(
            f"{a} {h}" for a, h in slack.items()) + "; over the timed "
        "steps, whose cache held earlier blocks: " + ", ".join(
            f"{a} {max(report['dry_run'][a]['headroom'])}"
            for a in DRY_RUN_CELLS) + f"): {budget} bytes "
        f"({budget / 2**30:.3f} GiB); dryrun.HBM_BUDGET "
        f"{dryrun.HBM_BUDGET} ({dryrun.HBM_BUDGET / 2**30:.3f} GiB); card "
        f"{smi}")
    check(dryrun.HBM_BUDGET <= budget, f"dryrun.HBM_BUDGET "
          f"{dryrun.HBM_BUDGET} is more than the card's {budget}")


def dry_run_trace(cfg, shape, mesh_cell, accum: int, rank: int = 0,
                  tokens=None, cost: bool = False) -> dict:
    """The dry run's trace of one step of ``cfg`` at ``shape`` on rank
    ``rank`` of a mesh of ``mesh_cell`` ((sizes, axes)) at ``accum``:
    ``meta_trace.trace``'s record, ``rise`` (its peak above the held
    arguments) and the counting comm's ``comm`` counters (none on one
    device); ``tokens`` the dtype the phase's batch tokens have."""
    from repro_torch.launch import dryrun, meta_trace
    from repro_torch.launch.mesh import Mesh
    sizes, axes = mesh_cell
    mesh, comm = dryrun.rank_mesh(Mesh(tuple(axes), tuple(sizes)), rank)
    step, args = dryrun.step_and_args(cfg, shape, mesh, accum=accum)
    batch = args[-1]
    if tokens is not None and isinstance(batch, dict):
        for k in ("tokens", "labels"):
            if k in batch:
                batch[k] = batch[k].to(tokens)
    rec = meta_trace.trace(step, args, cost=cost)
    rec["rise"] = rec["peak"] - rec["held"]
    if comm is not None:
        rec["comm"] = comm.counters()
    return rec


def dry_run_peaks(report: dict, smi: str) -> None:
    """Phase 35 (d) and (g) on phases 24, 32 and 34's steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import Shape
    from repro_torch.launch import dryrun
    rows = []
    for arch in DRY_RUN_CELLS:
        rec = report["dry_run"][arch]
        cfg = get_config(arch)
        shape = Shape(f"{rec['kind']}_cut", rec["kind"], rec["seq"],
                      rec["batch"])
        tr = dry_run_trace(cfg, shape, ((1, 1), ("data", "model")),
                           rec["accum"], tokens=rec["tokens"], cost=True)
        gaps = [r - tr["rise"] for r in rec["rise"]]
        # a train phase's pipeline thread may put its next batch (tokens
        # and labels) on the card while a step runs: that batch, or nothing
        prefetched = 2 * rec["batch"] * rec["seq"] * rec["tokens"].itemsize \
            if rec["kind"] == "train" else 0
        rows.append((arch, rec, tr, gaps, prefetched))
        flops, _tokens = dryrun.model_flops(cfg, shape)
        secs = rec["ms"] / 1e3
        say(f"(d) {arch} {rec['kind']} {rec['batch']} x {rec['seq']} accum "
            f"{rec['accum']}: predicted {tr['rise']} requested bytes above "
            f"the resident state ({tr['rise'] / 2**30:.4f} GiB; in 512-byte "
            f"blocks {tr['peak_blocks'] - tr['held']}), the card's "
            f"requested_bytes.all.peak rose by "
            f"{', '.join(str(r) for r in rec['rise'])} over its timed steps"
            f" (measured - predicted {', '.join(str(g) for g in gaps)}; "
            f"a prefetched batch {prefetched}); traced in "
            f"{tr['seconds']:.2f} s on the host; card {smi}")
        kern = ", ".join(f"{k} {n} calls {o:.4e}"
                         for k, (n, o) in sorted(tr["kernels"].items()))
        say(f"(g) {arch}: counted {tr['flops']:.4e} flops a step ({kern}), "
            f"model flops {flops:.4e} (counted / model "
            f"{tr['flops'] / flops:.4f}); over the measured "
            f"{rec['ms']:.1f} ms: {tr['flops'] / secs / 1e12:.1f} and "
            f"{flops / secs / 1e12:.1f} TFLOP/s, "
            f"{tr['flops'] / secs / PEAK_BF16_FLOPS:.4f} and "
            f"{flops / secs / PEAK_BF16_FLOPS:.4f} of the 989 TFLOP/s dense "
            f"bf16 peak; counted bytes {tr['bytes']:.4e}; card {smi}")
    for arch, rec, tr, gaps, prefetched in rows:
        check(all(g in (0, prefetched) for g in gaps),
              f"(d) {arch}: the card's rises {rec['rise']} against the "
              f"predicted {tr['rise']} (a prefetched batch {prefetched})")


def dry_run_ranks(what: str, ranks: list, kind: str, figs) -> None:
    """Phase 35 (e) and (f) on a cell of phases 38 / 39: each rank's
    prediction (``st["predicted"][kind]``, its own trace of the step on
    its rank of a counting mesh, made in the rank before its steps)
    against its measured steps (``figs(st)``, a step's figures each): the
    requested-byte rise equal to it (the ranks' batches are on the card
    before the window opens), the counting comm's calls by kind and bytes
    equal to the rank's ``DistributedComm`` counters over the step."""
    rows, bad = [], []
    for r, st in enumerate(ranks):
        pred = st["predicted"][kind]
        want = (pred["comm"]["calls"], pred["comm"]["bytes"])
        for f in figs(st):
            gap = f["rise"] - pred["rise"]
            rows.append(f"rank {r} {pred['rise']} / {f['rise']} ({gap:+d})")
            if gap:
                bad.append(("peak", r, pred["rise"], f["rise"]))
            got = (f["calls_by_kind"], {"gathered": f["gathered"],
                                        "reduced": f["reduced"]})
            if got != want:
                bad.append(("comm", r, want, got))
    first = ranks[0]["predicted"][kind]
    say(f"(e) {what}: predicted / measured requested-byte rise a step "
        f"(measured - predicted): " + "; ".join(rows) + "; traced in "
        + " / ".join(f"{st['predicted'][kind]['seconds']:.2f}"
                     for st in ranks) + " s in the ranks")
    comm_ok = not [b for b in bad if b[0] == "comm"]
    say(f"(f) {what}: the counting comm a step on rank 0: calls "
        f"{first['comm']['calls']}, bytes {first['comm']['bytes']}; "
        + ("equal" if comm_ok else "NOT equal")
        + " to each rank's DistributedComm counters over each step")
    check(not bad, f"{what}: {bad[:4]}")


# phase 36: the distributed backend on the card.  P ranks, each a process
# of its own on cuda:0 (``DistributedComm`` over gloo, every shift staged
# through pinned host memory: the machine has one card, NCCL refuses two
# ranks on one card, and gloo carries no CUDA tensor through send / recv),
# run the engine selfcheck (every mode), n-body (quorum with B1, and atom),
# PCIT (B2, B3) and bf16 quorum / ring attention (B9) on phases 4, 6, 7 and
# 17's inputs and seeds.  Each rank's rows are held bit for bit to this
# process's single-process run of the same inputs (no path's arithmetic
# depends on the leading axis: the kernels and the plain reductions work
# per device), its traced comm bytes to the predictor's, and its resident
# quorum input bytes to k/P of the atom's.
DIST_JOIN_S = 420            # the ranks' deadline, start-up included
DIST_TIMEOUT_S = 300         # a collective's wait for a peer
DIST_COUNTERS = ("comm.ppermute.gather_bytes", "comm.ppermute.gather_hops",
                 "comm.ppermute.scatter_bytes", "comm.ppermute.scatter_hops",
                 "comm.allgather.bytes", "comm.ppermute.ring_bytes",
                 "comm.ppermute.ring_hops")
DIST_LABEL = "gloo, host-staged, one card"


def dist_rank(rank: int, cfg: dict) -> None:
    """One rank of phase 36, in a spawned process of its own: the paths of
    phases 4, 6, 7 and 17 on a ``DistributedComm``; its rows and figures
    go to ``cfg["out"]/rank<r>.pt`` for the parent to check.  It loads the
    kernel library the parent built and never builds one."""
    from repro_torch.apps.attention import distributed_attention
    from repro_torch.apps.nbody import _blocks, distributed_forces
    from repro_torch.apps.pcit import run_quorum_pcit
    from repro_torch.core import selfcheck
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.sweep import quorum_gather
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as obs_trace

    comm = rank_comm(rank, cfg)
    dev = comm.device
    cuda = dev.type == "cuda"
    rows: dict = {}
    stats: dict = {"transport": comm.transport, "device": str(dev)}

    def run(name, fn):
        """``fn`` run twice: the first warms up (its wall ms kept as
        ``first_ms``), the second under a fresh tracer with the launch
        counts and the peak reset: its result, and its wall ms, peak
        bytes above the bytes held before it, launches and traced
        counters into ``stats``."""
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        first_ms = (time.perf_counter() - t0) * 1e3
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        tr = obs_trace.configure(metrics_only=True)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            out = fn()
            if cuda:
                torch.cuda.synchronize(dev)
        finally:
            obs_trace.reset()
        stats[name] = {
            "first_ms": first_ms, "ms": (time.perf_counter() - t0) * 1e3,
            "peak": (torch.cuda.max_memory_allocated(dev) - base) if cuda
            else 0,
            "launches": ops.launch_counts(),
            "counters": {c: int(tr.counter_total(c)) for c in DIST_COUNTERS}}
        return out

    try:
        for name, out in run("selfcheck", lambda: selfcheck.main(
                cfg["P"], comm=comm)).items():
            rows[f"selfcheck_{name}"] = torch.as_tensor(out)

        bodies = make_bodies(cfg["nbody_n"], 2)       # on the host
        rows["nbody_quorum"] = run("nbody_quorum", lambda: distributed_forces(
            bodies, comm, use_kernel=True)).cpu()
        rows["nbody_atom"] = run("nbody_atom", lambda: distributed_forces(
            bodies, comm, strategy="atom")).cpu()
        xb = _blocks(bodies, comm)
        stats["resident_quorum"] = quorum_gather(
            xb, build_schedule(cfg["P"]), comm).nbytes
        stats["resident_atom"] = comm.all_gather(xb).nbytes
        del xb

        X = make_expression(*cfg["pcit"], 1)
        corr, keep = run("pcit", lambda: run_quorum_pcit(
            X, comm, use_kernels=True))
        rows["pcit_corr"], rows["pcit_keep"] = corr.cpu(), keep.cpu()
        del corr, keep

        # phase 17's inputs, made on the card from its seed and kept on
        # the host: each rank moves only its own blocks to the card
        q, k, v = (t.cpu() for t in attn_inputs(
            torch.bfloat16, 23, T=cfg["attn_t"], device=dev))
        if cuda:
            torch.cuda.empty_cache()
        for strategy in ("quorum", "ring"):
            rows[f"attention_{strategy}"] = run(
                f"attention_{strategy}", lambda: distributed_attention(
                    q, k, v, comm, strategy=strategy)).cpu()
        torch.save({"rows": rows, "stats": stats},
                   Path(cfg["out"]) / f"rank{rank}.pt")
    finally:
        comm.close()


def dist_nccl_rank(rank: int, store: str) -> None:
    """One of two ranks asking for NCCL on the one card: NCCL refuses two
    ranks on one card, and the refusal must reach the caller."""
    import datetime
    from repro_torch.core.comm import DistributedComm
    DistributedComm("nccl", rank=rank, world_size=2,
                    init_method=f"file://{store}",
                    timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


def dist_nccl_refused() -> None:
    """Two ranks asking for NCCL on the one card: NCCL refuses, and the
    refusal must reach the caller (nothing falls back to gloo)."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(dist_nccl_rank, args=(f"{tmp}/store",),
                                 nprocs=2, join=False, start_method="spawn")
        refusal = ""
        try:
            join_ranks(ctx, DIST_JOIN_S)
        except mp.ProcessRaisedException as e:
            refusal = str(e)
    secs = time.perf_counter() - t0
    check("NCCL error" in refusal,
          f"phase 36: two nccl ranks on one card did not raise {refusal}")
    last = refusal.strip().splitlines()[-1].strip()
    say(f"two nccl ranks on cuda:0: NCCL refused in {secs:.1f} s and the "
        f"error reached the caller ({last[:160]}); the spawned ranks' "
        "tracebacks on stderr are this check's")


def dist_single(cfg: dict) -> dict:
    """The single-process rows phase 36's ranks are held to: the same
    paths on the same inputs on a ``SingleProcessComm``, on the host."""
    from repro_torch.apps.attention import distributed_attention
    from repro_torch.apps.nbody import distributed_forces
    from repro_torch.apps.pcit import run_quorum_pcit
    from repro_torch.core import selfcheck
    from repro_torch.core.comm import SingleProcessComm

    comm = SingleProcessComm(cfg["P"], DEVICE)
    out = {f"selfcheck_{name}": torch.as_tensor(v) for name, v in
           selfcheck.main(cfg["P"], device=DEVICE).items()}
    bodies = make_bodies(cfg["nbody_n"], 2)
    out["nbody_quorum"] = distributed_forces(bodies, comm,
                                             use_kernel=True).cpu()
    out["nbody_atom"] = distributed_forces(bodies, comm,
                                           strategy="atom").cpu()
    corr, keep = run_quorum_pcit(make_expression(*cfg["pcit"], 1), comm,
                                 use_kernels=True)
    out["pcit_corr"], out["pcit_keep"] = corr.cpu(), keep.cpu()
    del corr, keep
    q, k, v = attn_inputs(torch.bfloat16, 23, T=cfg["attn_t"])
    for strategy in ("quorum", "ring"):
        out[f"attention_{strategy}"] = distributed_attention(
            q, k, v, comm, strategy=strategy).cpu()
    return out


def dist_predicted(cfg: dict) -> dict:
    """Each rank's comm bytes and hops by the predictor
    (``obs/comm.py``), per path, from the shapes of this run."""
    from repro_torch.core.placement import resolve_placement
    from repro_torch.obs.comm import (predict_ring_gather_comm,
                                      predict_sweep_comm)

    P_ = cfg["P"]
    plc = resolve_placement("cyclic", P_)
    nb = cfg["nbody_n"] // P_                      # bodies a device
    pn, pg = cfg["pcit"][0] // P_, cfg["pcit"][1]  # genes a device, samples
    tq = ATTN_B * cfg["attn_t"] // P_              # positions a device
    bf16, f32 = 2, 4

    def sweep(*pairs):
        preds = [predict_sweep_comm(plc, b, partial_bytes=p) for b, p in pairs]
        return {f"comm.ppermute.{f}": sum(getattr(x, f) for x in preds)
                for f in ("gather_bytes", "gather_hops", "scatter_bytes",
                          "scatter_hops")}

    ring = predict_ring_gather_comm(P_, 2 * tq * ATTN_KV * ATTN_HD * bf16)
    return {
        "nbody_quorum": sweep((nb * 4 * f32, nb * 3 * f32)),
        "nbody_atom": {"comm.allgather.bytes": (P_ - 1) * nb * 4 * f32},
        # correlation tiles: the rows' blocks out, [block, N] strips back;
        # the filter: the correlation rows out, the keep strips back
        "pcit": sweep((pn * pg * f32, pn * cfg["pcit"][0] * f32),
                      (pn * cfg["pcit"][0] * f32, pn * cfg["pcit"][0] * f32)),
        # (q, k, v) blocks out, the (o, m, l) f32 partials back
        "attention_quorum": sweep(
            (tq * (ATTN_H + 2 * ATTN_KV) * ATTN_HD * bf16,
             tq * ATTN_H * (ATTN_HD + 2) * f32)),
        "attention_ring": {"comm.ppermute.ring_bytes": ring["bytes"],
                           "comm.ppermute.ring_hops": ring["hops"]}}


def join_ranks(ctx, seconds: float) -> None:
    """Wait for every rank; a rank that raised fails the phase (its
    context ends the others), and ranks still running at the deadline are
    killed and fail it."""
    deadline = time.monotonic() + seconds
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline,
                  f"ranks still running after {seconds} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


def phase_distributed(report: dict, smi: str) -> None:
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.kernels import _build

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    cfg = dict(P=P, nbody_n=NBODY_N, pcit=(PCIT_N, PCIT_G, PCIT_RANK),
               attn_t=ATTN_T, device=DEVICE, lib=str(_build.build()))
    dist_nccl_refused()
    t0 = time.perf_counter()
    single = dist_single(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    single_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        cfg.update(store=str(Path(tmp) / "store"), out=tmp)
        t0 = time.perf_counter()
        ctx = mp.start_processes(dist_rank, args=(cfg,), nprocs=P,
                                 join=False, start_method="spawn")
        join_ranks(ctx, DIST_JOIN_S)
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=True)
                 for r in range(P)]
    say(f"{P} ranks ({DIST_LABEL}; compute mode {mode}): spawned, ran and "
        f"joined in {wall_s:.1f} s wall; the single-process rows took "
        f"{single_s:.1f} s")

    want = dist_predicted(cfg)
    k = build_schedule(P).k
    for r, res in enumerate(ranks):
        rows, st = res["rows"], res["stats"]
        check(st["transport"] == "gloo, host-staged"
              and st["device"].startswith("cuda"),
              f"rank {r}: transport {st['transport']} on {st['device']}")
        for key, got in rows.items():
            full = single[key]
            axis = 1 if key.startswith("attention") else 0
            n = full.shape[axis] // P
            mine = full.narrow(axis, r * n, n)
            check(got.shape == mine.shape and got.dtype == mine.dtype,
                  f"rank {r} {key}: {tuple(got.shape)} {got.dtype}, single "
                  f"process {tuple(mine.shape)} {mine.dtype}")
            check(torch.equal(got, mine), f"rank {r} {key}: differs from "
                  f"the single-process rows (max abs "
                  f"{float((got.float() - mine.float()).abs().max()):.3e})")
        for path, kern in (("nbody_quorum", ("pairwise_batch",)),
                           ("pcit", ("pairwise_corr", "pcit_filter")),
                           ("attention_quorum", ("flash_attention",)),
                           ("attention_ring", ("flash_attention",))):
            for name in kern:
                check(st[path]["launches"][name] > 0,
                      f"rank {r} {path}: {name} was never launched")
        for path, counters in want.items():
            got = {c: v for c, v in st[path]["counters"].items() if v}
            check(got == counters, f"rank {r} {path}: traced {got}, "
                  f"predicted {counters}")
        check(st["resident_quorum"] * P == st["resident_atom"] * k,
              f"rank {r}: resident quorum bytes {st['resident_quorum']}, "
              f"atom {st['resident_atom']}: not k/P = {k}/{P}")

    def each(path, field, scale=1.0):
        return " / ".join(f"{res['stats'][path][field] * scale:.1f}"
                          for res in ranks)

    mib = 1 / 2**20
    st0 = ranks[0]["stats"]
    say(f"selfcheck P={P} every mode ({DIST_LABEL}), ranks 0-{P - 1}: "
        f"first run (the rank's start-up costs included) "
        f"{each('selfcheck', 'first_ms')} ms, second "
        f"{each('selfcheck', 'ms')} ms")
    say(f"n-body N={NBODY_N} P={P} ({DIST_LABEL}; the second of two "
        f"runs, as below), ranks 0-{P - 1}: quorum "
        f"(B1) {each('nbody_quorum', 'ms')} ms, peak "
        f"{each('nbody_quorum', 'peak', mib)} MiB; atom "
        f"{each('nbody_atom', 'ms')} ms, peak "
        f"{each('nbody_atom', 'peak', mib)} MiB "
        f"(torch.cuda.max_memory_allocated above the rank's held "
        f"bytes); resident input bytes a rank: quorum "
        f"{st0['resident_quorum']}, atom {st0['resident_atom']} (k/P = "
        f"{k}/{P})")
    say(f"PCIT N={PCIT_N} G={PCIT_G} P={P} ({DIST_LABEL}), ranks 0-{P - 1}: "
        f"{each('pcit', 'ms')} ms, peak {each('pcit', 'peak', mib)} MiB")
    for strategy in ("quorum", "ring"):
        path = f"attention_{strategy}"
        moved = sum(v for c, v in st0[path]["counters"].items()
                    if c.endswith("bytes"))
        say(f"{strategy} attention bf16 T={ATTN_T} P={P} ({DIST_LABEL}), "
            f"ranks 0-{P - 1}: {each(path, 'ms')} ms, peak "
            f"{each(path, 'peak', mib)} MiB, comm {moved * mib:.1f} MiB a "
            f"rank")
    say(f"every rank's rows bit-equal to the single-process run ("
        f"{', '.join(ranks[0]['rows'])}); traced bytes == predicted on "
        f"every rank; B1, B2, B3 and B9 launched on every rank; card {smi}")
    for name, path in (("pairwise_batch", "nbody_quorum"),
                       ("pairwise_corr", "pcit"), ("pcit_filter", "pcit"),
                       ("flash_attention", "attention_quorum")):
        report[name]["dist_launches"] = min(
            res["stats"][path]["launches"][name] for res in ranks)


# phase 37: the serving tier, the join, the k-NN graph and the quantized
# paths under the distributed backend.  P ranks on cuda:0 over gloo,
# host-staged (as phase 36), at the single-process phases' shapes, with
# fewer microbatches: serving on phase 8's 1,000,000 x 128 corpus
# (D37_SERVE_BATCHES microbatches of SERVE_Q l2 top-10 through B4, phase
# 8's range query
# escalated from THR_CAP0, a replace_block), int8 serving of the same
# corpus (D37_QSERVE_BATCHES microbatches before and after the replace),
# the batcher on the f32 corpus with rank 0 as the front end (D37_BATCHES
# microbatches with a stream update every D37_STREAM_EVERY, a
# heterogeneous pack, an escalation, a partial result under a stepping
# clock), the join of phase 9's 262,144 x 128 corpus (B5) and the k-NN
# graph of its first D37_KNN_N rows (B6), and their int8 and bf16 paths
# (B7, B8).  The parent runs the
# same calls on a SingleProcessComm on the card; every rank's rows are held
# to its share of them (a rank's k-NN rows: its block's; its join pairs:
# the ones its device owns).  Each rank keeps the corpora on the host and
# moves only its own blocks (and the rows a rescoring pass reads) to the
# card.
D37_SERVE_BATCHES, D37_QSERVE_BATCHES = 4, 1
D37_BATCHES, D37_STREAM_EVERY = 4, 2
# the k-NN graphs (f32, int8, bf16) on the join corpus's first D37_KNN_N
# rows (a depth cut: the quantized ones' M passes were most of the phase)
D37_KNN_N = JOIN_N // 2
D37_PACK_CAPS = (16, 8, 32, 1, 64, 2)  # below THR_HITS: the pack escalates
# the rows whose scores the quantized paths rescore with torch.sum over the
# rows a pass gathers: equal to SCORE_TOL where CUDA's reduction plan
# follows the gathered shape, which differs between a rank and one process
RESCORED = ("qserve", "qjoin_", "qknn_")
D37_COUNTERS = DIST_COUNTERS + ("comm.ppermute.merge_bytes",
                                "comm.ppermute.merge_hops")
# the path of each kernel of the slice, for its per-rank launch count
D37_KERNEL_PATHS = (("query_topk", ("serve_topk", "batcher")),
                    ("pairwise_threshold", ("join",)),
                    ("pairwise_topk", ("knn",)),
                    ("pairwise_threshold_q", ("qjoin_int8", "qjoin_bf16")),
                    ("pairwise_topk_q", ("qknn_int8", "qknn_bf16")))


def rank_comm(rank: int, cfg: dict):
    """Rank ``rank``'s ``DistributedComm`` over gloo on ``cfg["device"]``,
    with the kernel library the parent built loaded (a rank never builds
    one)."""
    import datetime
    from repro_torch.core.comm import DistributedComm
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm = DistributedComm("gloo", rank=rank, world_size=cfg["P"],
                           init_method=f"file://{cfg['store']}",
                           device=cfg["device"],
                           timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    if comm.device.type == "cuda":
        lib = _build.BUILD_ROOT / _build.build_key() / _build.LIB_NAME
        check(lib == Path(cfg["lib"]) and lib.exists(),
              f"rank {rank}: no kernel library at {cfg['lib']} ({lib})")
        _build.library()
    return comm


@contextlib.contextmanager
def recorded_quorums(store: list):
    """Record the bytes of every quorum the pair sweeps gather."""
    from repro_torch.core import sweep
    gather = sweep.quorum_gather

    def recording(x, schedule, comm, **kw):
        got = gather(x, schedule, comm, **kw)
        store.append(sum(t.nbytes for t in sweep._leaves(got)))
        return got
    sweep.quorum_gather = recording
    try:
        yield
    finally:
        sweep.quorum_gather = gather


def d37_data(dirname: str) -> dict:
    """Phase 8's and phase 9's corpora from their seeds, with the range
    query's per-query thresholds (midway between the THR_HITS-th and the
    next l2 score over the corpus), on the card; a host copy of each goes
    to ``dirname`` for the ranks."""
    X, queries, fresh, thr_q = serving_data()
    n_q = max(D37_SERVE_BATCHES, D37_QSERVE_BATCHES, D37_BATCHES + 1)
    queries = queries[:n_q].contiguous()
    top = torch.topk(l2_scores(thr_q, X, (X * X).sum(-1)),
                     THR_HITS + 1).values
    thr_vec = (top[:, THR_HITS - 1] + top[:, THR_HITS]) / 2
    Xj, _xn, thr = join_data()
    data = dict(X=X, queries=queries, fresh=fresh, thr_q=thr_q,
                thr_vec=thr_vec, Xj=Xj, join_thr=torch.tensor(thr))
    torch.save({k: v.cpu() for k, v in data.items()},
               Path(dirname) / "d37_data.pt")
    return data


def d37_batcher(sc, data) -> dict:
    """Rank 0's (or the one process's) front-end traffic: ``serve_queries``
    through ``BatchScheduler`` with stream updates, a heterogeneous pack
    (k = 1..100 in both metrics, range queries with capacities 1..256),
    and a range query whose deadline passes mid-escalation; every
    resolved request's rows, and the launch and escalation counts."""
    from repro_torch.launch.query_serve import serve_queries
    from repro_torch.serving.batching import BatchScheduler

    out: dict = {}
    sched = BatchScheduler(sc, max_batch=SERVE_Q, pad_queries_to=SERVE_Q,
                           use_kernel=True)
    try:
        vals, idx, _qps = serve_queries(
            sc, data["queries"][:D37_BATCHES].reshape(-1, SERVE_D),
            microbatch=SERVE_Q, topk=SERVE_TOPK, metric="l2",
            use_kernel=True, stream_every=D37_STREAM_EVERY,
            rng=np.random.default_rng(20), scheduler=sched)
        out["drain_v"], out["drain_i"] = (torch.from_numpy(vals),
                                          torch.from_numpy(idx))
        hq = data["queries"][D37_BATCHES]
        pack = BatchScheduler(sc, max_batch=64, use_kernel=True)
        reqs = [pack.submit(hq[2 * j + (m == "dot")], kind="topk", topk=k,
                            metric=m)
                for j, k in enumerate(BATCH_TOPKS) for m in ("l2", "dot")]
        reqs += [pack.submit(data["thr_q"][j], kind="threshold",
                             threshold=float(data["thr_vec"][j]),
                             capacity=cap, metric="l2")
                 for j, cap in enumerate(D37_PACK_CAPS)]
        pack.drain()
        for n, r in enumerate(reqs):
            res = r.result(0)
            check(res.ok, f"batcher pack: request {n} {res.status}")
            out[f"pack{n}_v"] = torch.from_numpy(res.scores)
            out[f"pack{n}_i"] = torch.from_numpy(res.indices)
            out[f"pack{n}_n"] = torch.tensor(-1 if res.count is None
                                             else res.count)
        t = [0.0]

        def stepping_clock():
            t[0] += 0.4
            return t[0]
        late = BatchScheduler(sc, max_batch=8, clock=stepping_clock)
        part = late.submit(hq[-1], kind="threshold", threshold=-1e30,
                           capacity=1, deadline_s=0.5, metric="l2")
        late.step()
        res = part.result(0)
        check(res.status == "partial" and res.count == sc.n_valid,
              f"batcher: {res.status}, count {res.count} of {sc.n_valid}")
        out["partial_i"] = torch.from_numpy(res.indices)
        out["counts"] = torch.tensor([sched.counters["launches"],
                                      pack.counters["launches"],
                                      pack.counters["escalations"]])
        check(int(out["counts"][2]) > 0, "batcher pack: no escalation")
    finally:
        sched.close()
    return out


def d37_paths(comm, data: dict, run) -> tuple[dict, dict]:
    """Phase 37's calls on ``comm`` (a rank's or the single process's),
    each through ``run(name, fn)``: (rows as host tensors, figures)."""
    from repro_torch.core.comm import DistributedComm
    from repro_torch.core.knn import knn_graph
    from repro_torch.core.quant import (quant_knn_graph,
                                        quant_similarity_join)
    from repro_torch.core.sparse import similarity_join
    from repro_torch.serving import ServingCorpus
    from repro_torch.serving.batching import follow_launches

    rows: dict = {}
    fig: dict = {}
    follower = isinstance(comm, DistributedComm) and comm.rank != 0

    def state_bytes(*ts):
        return sum(t.nbytes for t in ts)

    sc = run("serve_build", lambda: ServingCorpus.build(
        data["X"], comm, placement="cyclic", quant="off"))
    fig["serve_resident"] = state_bytes(*sc.state)

    def serve_topk():
        for b in range(D37_SERVE_BATCHES):
            v, i = sc.query(data["queries"][b], topk=SERVE_TOPK,
                            metric="l2", use_kernel=True)
            rows[f"serve{b}_v"], rows[f"serve{b}_i"] = v.cpu(), i.cpu()
    run("serve_topk", serve_topk)

    def serve_range():
        v, i, n = sc.query_threshold(data["thr_q"],
                                     threshold=data["thr_vec"],
                                     capacity=THR_CAP0, mode="batched",
                                     metric="l2")
        rows["range_v"], rows["range_i"], rows["range_n"] = (
            v.cpu(), i.cpu(), n.cpu())
    run("serve_range", serve_range)

    def serve_replace():
        sc.replace_block(REPLACED_BLOCK, data["fresh"])
        v, i = sc.query(data["queries"][0], topk=SERVE_TOPK, metric="l2",
                        use_kernel=True)
        rows["replaced_v"], rows["replaced_i"] = v.cpu(), i.cpu()
    run("serve_replace", serve_replace)

    def batcher():
        if follower:
            return {"followed": torch.tensor(follow_launches(sc))}
        return d37_batcher(sc, data)
    rows.update({f"batcher_{k}": v for k, v in run("batcher",
                                                   batcher).items()})
    del sc

    scq = run("qserve_build", lambda: ServingCorpus.build(
        data["X"], comm, placement="cyclic", quant="int8"))
    fig["qserve_resident"] = state_bytes(*scq.quant.stacks)
    fig["qserve_mirror_on_device"] = scq.quant.mirror.resident

    def qserve():
        for b in range(2 * D37_QSERVE_BATCHES):
            if b == D37_QSERVE_BATCHES:
                scq.replace_block(REPLACED_BLOCK, data["fresh"])
            v, i = scq.query(data["queries"][b], topk=SERVE_TOPK,
                             metric="l2")
            rows[f"qserve{b}_v"], rows[f"qserve{b}_i"] = v.cpu(), i.cpu()
    run("qserve", qserve)
    del scq

    Xj, thr = data["Xj"], float(data["join_thr"])
    quorums: list = []

    def join():
        r = similarity_join(Xj, comm, threshold=thr, metric="l2",
                            mode="batched", placement="cyclic",
                            capacity=JOIN_CAP0, use_kernel=True)
        rows["join_i"], rows["join_j"] = (torch.from_numpy(r.i),
                                          torch.from_numpy(r.j))
        rows["join_s"] = torch.from_numpy(r.scores)
        fig["join_sweeps"] = 1 + r.escalations
        fig["join_counts"] = r.counts.tolist()

    def knn():
        g = knn_graph(Xj[:D37_KNN_N], comm, topk=KNN_TOPK, metric="l2",
                      mode="batched", placement="cyclic", use_kernel=True,
                      quant="off")
        rows["knn_i"], rows["knn_v"] = (torch.from_numpy(g.indices),
                                        torch.from_numpy(g.scores))
        fig["knn_row0"] = g.row0

    def qjoin(qm):
        st: dict = {}
        r = quant_similarity_join(Xj, comm, threshold=thr, quant=qm,
                                  metric="l2", mode="batched",
                                  placement="cyclic", capacity=JOIN_CAP0,
                                  use_kernel=True, stats=st)
        rows[f"qjoin_{qm}_i"] = torch.from_numpy(r.i)
        rows[f"qjoin_{qm}_j"] = torch.from_numpy(r.j)
        rows[f"qjoin_{qm}_s"] = torch.from_numpy(r.scores)
        fig[f"qjoin_{qm}_sweeps"] = 1 + r.escalations

    def qknn(qm):
        st: dict = {}
        g = quant_knn_graph(Xj[:D37_KNN_N], comm, topk=KNN_TOPK, quant=qm,
                            metric="l2", mode="batched", placement="cyclic",
                            use_kernel=True, stats=st)
        rows[f"qknn_{qm}_i"] = torch.from_numpy(g.indices)
        rows[f"qknn_{qm}_v"] = torch.from_numpy(g.scores)
        fig[f"qknn_{qm}_passes"] = st["passes"]

    with recorded_quorums(quorums):
        for name, fn in (("join", join), ("knn", knn)):
            run(name, fn)
            fig[f"{name}_quorum"] = max(quorums)
            quorums.clear()
        for qm in ("int8", "bf16"):
            for name, fn in ((f"qjoin_{qm}", qjoin), (f"qknn_{qm}", qknn)):
                run(name, lambda: fn(qm))
                fig[f"{name}_quorum"] = max(quorums)
                quorums.clear()
    return rows, fig


def d37_rank(rank: int, cfg: dict) -> None:
    """One rank of phase 37, in a spawned process of its own: its rows
    and figures go to ``cfg["out"]/d37_rank<r>.pt``."""
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as obs_trace

    comm = rank_comm(rank, cfg)
    dev = comm.device
    cuda = dev.type == "cuda"
    stats: dict = {"transport": comm.transport, "device": str(dev)}

    def run(name, fn):
        """``fn`` once under a fresh tracer, with the launch counts and
        the peak reset: its wall ms (first use included), peak bytes above
        the bytes held before it, launches and traced counters."""
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        tr = obs_trace.configure(metrics_only=True)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            out = fn()
            if cuda:
                torch.cuda.synchronize(dev)
        finally:
            obs_trace.reset()
        stats[name] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "peak": (torch.cuda.max_memory_allocated(dev) - base) if cuda
            else 0,
            "launches": ops.launch_counts(),
            "counters": {c: int(tr.counter_total(c)) for c in D37_COUNTERS}}
        return out

    try:
        data = torch.load(Path(cfg["out"]) / "d37_data.pt", mmap=True,
                          weights_only=True)
        rows, fig = d37_paths(comm, data, run)
        torch.save({"rows": rows, "fig": fig, "stats": stats},
                   Path(cfg["out"]) / f"d37_rank{rank}.pt")
    finally:
        comm.close()


def d37_predicted(fig: dict) -> dict:
    """A rank's comm bytes and hops by the predictor (``obs/comm.py``),
    per path, from this run's shapes, escalations and M passes."""
    from repro_torch.core.placement import resolve_placement
    from repro_torch.obs.comm import (predict_sweep_comm,
                                      predict_tree_merge_comm,
                                      quant_block_bytes)

    plc = resolve_placement("cyclic", P)
    block, kblock = JOIN_N // P, D37_KNN_N // P

    def sweeps(n, block_bytes, partial_bytes=None):
        p = predict_sweep_comm(plc, block_bytes, partial_bytes=partial_bytes)
        out = {"comm.ppermute.gather_bytes": n * p.gather_bytes,
               "comm.ppermute.gather_hops": n * p.gather_hops}
        if partial_bytes is not None:
            out.update({"comm.ppermute.scatter_bytes": n * p.scatter_bytes,
                        "comm.ppermute.scatter_hops": n * p.scatter_hops})
        return out

    # the tree merge of each microbatch's (vals f32, ids i32) [Q, 16]
    merge = predict_tree_merge_comm(P, SERVE_Q * 16 * 8)
    want = {"serve_topk": {
        "comm.ppermute.merge_bytes": D37_SERVE_BATCHES * merge["bytes"],
        "comm.ppermute.merge_hops": D37_SERVE_BATCHES * merge["hops"]},
        "join": sweeps(fig["join_sweeps"], block * JOIN_D * 4),
        "knn": sweeps(1, kblock * JOIN_D * 4, kblock * KNN_TOPK * 8)}
    for qm in ("int8", "bf16"):
        qbb = quant_block_bytes(block, JOIN_D, qm)
        want[f"qjoin_{qm}"] = sweeps(fig[f"qjoin_{qm}_sweeps"], qbb)
        qkb = quant_block_bytes(kblock, JOIN_D, qm)
        passes = [sweeps(1, qkb, kblock * m * 8)
                  for m, _n in fig[f"qknn_{qm}_passes"]]
        want[f"qknn_{qm}"] = {c: sum(p[c] for p in passes)
                              for c in passes[0]}
    return want


def phase_distributed_serving(report: dict, smi: str) -> None:
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.placement import get_placement
    from repro_torch.core.sparse import owned_pairs
    from repro_torch.kernels import _build, ops

    sched = get_placement("cyclic", P).schedule()
    k = sched.k
    with tempfile.TemporaryDirectory() as tmp:
        data = d37_data(tmp)
        # the single process, the same calls on the card
        single_ms: dict = {}
        single_peak: dict = {}

        cuda = torch.device(DEVICE).type == "cuda"

        def run(name, fn):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() if cuda else 0
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize()
            single_ms[name] = (time.perf_counter() - t0) * 1e3
            single_peak[name] = (torch.cuda.max_memory_allocated() - base
                                 if cuda else 0)
            return out
        single, sfig = d37_paths(SingleProcessComm(P, DEVICE), data, run)
        del data
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

        cfg = dict(P=P, device=DEVICE, lib=str(_build.build()),
                   store=str(Path(tmp) / "store37"), out=tmp)
        t0 = time.perf_counter()
        ctx = mp.start_processes(d37_rank, args=(cfg,), nprocs=P,
                                 join=False, start_method="spawn")
        join_ranks(ctx, DIST_JOIN_S)
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"d37_rank{r}.pt",
                            weights_only=True) for r in range(P)]
    say(f"{P} ranks ({DIST_LABEL}): spawned, ran and joined in "
        f"{wall_s:.1f} s wall; the single-process calls took "
        f"{sum(single_ms.values()) / 1e3:.1f} s")

    block = JOIN_N // P
    not_bit_equal: dict = {}
    for r, res in enumerate(ranks):
        rows, fig, st = res["rows"], res["fig"], res["stats"]
        check(st["transport"] == "gloo, host-staged"
              and st["device"].startswith("cuda"),
              f"rank {r}: transport {st['transport']} on {st['device']}")
        mine = {}
        for key, want in single.items():
            if key.startswith(("join_", "qjoin_")):
                continue
            if key.startswith(("knn_", "qknn_")):
                kb = D37_KNN_N // P
                want = want[r * kb:(r + 1) * kb]
            if key.startswith("batcher_") and r:
                continue
            mine[key] = want
        for base in ("join", "qjoin_int8", "qjoin_bf16"):
            own = torch.from_numpy(owned_pairs(
                single[f"{base}_i"].numpy(), single[f"{base}_j"].numpy(),
                block, sched, [r]))
            for f in "ijs":
                mine[f"{base}_{f}"] = single[f"{base}_{f}"][own]
        expect = set(mine) | ({"batcher_followed"} if r else set())
        check(set(rows) == expect,
              f"rank {r}: rows {sorted(set(rows) ^ expect)} unmatched")
        for key, want in mine.items():
            got = rows[key]
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"rank {r} {key}: {tuple(got.shape)} {got.dtype}, single "
                  f"process {tuple(want.shape)} {want.dtype}")
            if torch.equal(got, want):
                continue
            check(key.startswith(RESCORED) and key.endswith(("_v", "_s"))
                  and torch.allclose(got, want, rtol=SCORE_TOL,
                                     atol=SCORE_TOL),
                  f"rank {r} {key}: differs from the single-process rows "
                  f"(max abs {float((got.float() - want.float()).abs().max()):.3e})")
            not_bit_equal[key] = max(not_bit_equal.get(key, 0.0), float(
                (got - want).abs().max()))
        if r:
            n_launch = int(single["batcher_counts"][0]
                           + single["batcher_counts"][1]) + 1 + \
                len(range(D37_STREAM_EVERY, D37_BATCHES, D37_STREAM_EVERY))
            check(int(rows["batcher_followed"]) == n_launch,
                  f"rank {r}: followed {int(rows['batcher_followed'])} "
                  f"launches, rank 0 made {n_launch}")
        for name, paths in D37_KERNEL_PATHS:
            for path in paths:
                check(st[path]["launches"][name] > 0,
                      f"rank {r} {path}: {name} was never launched")
        for path, counters in d37_predicted(fig).items():
            got = {c: v for c, v in st[path]["counters"].items() if v}
            check(got == counters, f"rank {r} {path}: traced {got}, "
                  f"predicted {counters}")
        check(fig["serve_resident"] * P == sfig["serve_resident"]
              and fig["qserve_resident"] * P == sfig["qserve_resident"],
              f"rank {r}: resident serving bytes {fig['serve_resident']} / "
              f"{fig['qserve_resident']}, one process "
              f"{sfig['serve_resident']} / {sfig['qserve_resident']}")
        check(not fig["qserve_mirror_on_device"],
              f"rank {r}: the f32 mirror is on the device")
        for path in ("join", "knn", "qjoin_int8", "qjoin_bf16", "qknn_int8",
                     "qknn_bf16"):
            check(fig[f"{path}_quorum"] * P == sfig[f"{path}_quorum"],
                  f"rank {r} {path}: quorum {fig[f'{path}_quorum']} bytes, "
                  f"one process {sfig[f'{path}_quorum']}")
        check(fig["join_counts"] == sfig["join_counts"],
              f"rank {r}: join counts {fig['join_counts']}")

    mib = 1 / 2**20

    def each(path, field, scale=1.0):
        return " / ".join(f"{res['stats'][path][field] * scale:.1f}"
                          for res in ranks)

    paths = ("serve_build", "serve_topk", "serve_range", "serve_replace",
             "batcher", "qserve_build", "qserve", "join", "knn",
             "qjoin_int8", "qjoin_bf16", "qknn_int8", "qknn_bf16")
    for path in paths:
        moved = sum(v for c, v in ranks[0]["stats"][path]["counters"].items()
                    if c.endswith("bytes"))
        say(f"phase 37 {path} ({DIST_LABEL}), ranks 0-{P - 1}: "
            f"{each(path, 'ms')} ms, peak {each(path, 'peak', mib)} MiB, "
            f"comm {moved * mib:.1f} MiB a rank (traced); one process "
            f"{single_ms[path]:.1f} ms, peak "
            f"{single_peak[path] * mib:.1f} MiB")
    f0 = ranks[0]["fig"]
    say(f"phase 37 resident a rank vs one process: serving f32 state "
        f"{f0['serve_resident'] * mib:.1f} vs {sfig['serve_resident'] * mib:.1f}"
        f" MiB, int8 stacks {f0['qserve_resident'] * mib:.1f} vs "
        f"{sfig['qserve_resident'] * mib:.1f} MiB (f32 mirror on the host; "
        f"one process keeps it on the card), sweep quorums: "
        + ", ".join(f"{p} {f0[f'{p}_quorum'] * mib:.1f} vs "
                    f"{sfig[f'{p}_quorum'] * mib:.1f} MiB"
                    for p in ("join", "knn", "qjoin_int8", "qknn_int8"))
        + f" (k/P = {k}/{P} of the corpus, 1/P of one process's)")
    say(f"phase 37: join {sum(f0['join_counts'])} pairs in "
        f"{f0['join_sweeps']} sweeps; quantized k-NN passes int8 "
        f"{f0['qknn_int8_passes']}, bf16 {f0['qknn_bf16_passes']}; every "
        f"rank's rows equal its share of the single process's, "
        + ("bit for bit" if not not_bit_equal else
           "bit for bit except rescored scores within "
           f"{SCORE_TOL} (max abs {max(not_bit_equal.values()):.3e}: "
           f"{', '.join(sorted(not_bit_equal))})")
        + f"; traced bytes == predicted on every rank; B4-B8 launched in "
        f"every rank; card {smi}")
    for name, paths in D37_KERNEL_PATHS:
        report[name]["dist_launches"] = min(
            sum(res["stats"][p]["launches"][name] for p in paths)
            for res in ranks)
        report[name]["dist_ms"] = max(
            sum(res["stats"][p]["ms"] for p in paths) for res in ranks)



# phase 38: the LM train and prefill steps on a mesh of ranks (ROADMAP
# A.15c-d).  Spawned ranks on the one card over gloo, host-staged (as
# phases 36-37), each holding its shard of the parameters, the AdamW
# moments and the batch as the reference's resolved specs lay them out
# (launch/steps.py with mesh=), and computing on "model" as the
# reference's sharded program does: its heads, MLP columns and vocabulary
# slice, the residual stream its half of the sequence.  Every rank
# records the shapes B9, B10 and their backward kernels were launched at
# (B9 on H / model | KV / model heads, B10 on H / model SSD heads, checked
# on every rank), and rank 0 holds the first launch of each on its real
# inputs against the plain version (B9: phase 24's rule on sampled rows;
# its backward: phase 31's; B10: rtol / atol 1e-4, phase 26's; its
# backward: 1e-4 max(1, max |want|), phase 33's).  Cell "qwen": qwen3-14b at full width,
# depth cut from 40 to D38_QWEN_LAYERS layers (as phase 24's 2-layer
# cells), fsdp on, random bf16 parameters from a seed, on a (data=2,
# model=2) mesh of 4 ranks: train_4k at a global batch of D38_QWEN_B
# (2 rows of 4,096 a dp rank, remat on), a warm-up step and D38_TIMED
# timed steps, then the prefill step on D38_QWEN_B x 4,096.  Cell
# "mamba": mamba2-130m at full width, depth cut from 24 to
# D38_MAMBA_LAYERS, fsdp off, on a (data=4, model=2) mesh of 8 ranks:
# train_4k at a global batch of 16 in 2 microbatches (phase 34's step).  The parent first runs the same
# single-process step on the same parameters and batch, keeps samples of
# its results on the host and frees the card.  Every rank's warm-up step
# is held to it on D38_SAMPLES sampled elements of every leaf (each rank
# checks the samples its shards hold): the loss within 2e-2 max(1, |loss|)
# and the grad norm within 2e-2 of it (phase 32's bf16 rule; the dp sum
# adds the rows' gradients in another order), the gradients the moments
# imply (m / (1 - b1) / clip, sqrt(v / (1 - b2)) / clip) within 2e-2
# max(1, max |g|) of the leaf (phase 32's rule for gradients), the
# parameters within 2^-7 |p| + 2.5 lr (one bf16 rounding, and AdamW's first
# step flips where a gradient's sign does); the prefill logits within
# phase 24's 2e-2 max(1, max |logit|).
D38_QWEN_LAYERS, D38_QWEN_B, D38_T = 2, 4, 4096
D38_MAMBA_LAYERS = 12
D38_CELLS = {
    "qwen": dict(arch="qwen3_14b", layers=D38_QWEN_LAYERS, fsdp=True,
                 mesh=((2, 2), ("data", "model")), batch=D38_QWEN_B,
                 accum=1, prefill=True),
    "mamba": dict(arch="mamba2_130m", layers=D38_MAMBA_LAYERS, fsdp=False,
                  mesh=((4, 2), ("data", "model")), batch=MAMBA_B,
                  accum=MAMBA_ACCUM, prefill=False),
}
D38_TIMED = 1
D38_SAMPLES = 1 << 16
D38_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_chunk",
               "ssd_chunk_bwd")


def d38_config(cell: dict):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(cell["arch"])
    if cell["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=cell["layers"])
    return dataclasses.replace(cfg, fsdp=cell["fsdp"])


def d38_batch(cfg, cell: dict, step: int, prefill: bool = False) -> dict:
    """The global batch of ``step`` (numpy, from the data pipeline's
    (seed, step) draw); a prefill batch has no labels."""
    from repro_torch.data import DataConfig, make_batch
    b = make_batch(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                              batch=cell["batch"], seq_len=D38_T), step)
    return {"tokens": b["tokens"]} if prefill else b


def d38_shape(cell: dict):
    from repro_torch.configs.registry import Shape
    return Shape("train_4k_cut", "train", D38_T, cell["batch"])


def d38_samples(trees: dict) -> dict:
    """Per leaf of each tree (name -> tree of full tensors): D38_SAMPLES
    flat indices drawn from a seed, their float32 values, and the leaf's
    max |x|."""
    from repro_torch.models.common import tree_leaves
    out = {}
    for name, tree in trees.items():
        for i, (path, t) in enumerate(tree_leaves(tree)):
            g = torch.Generator().manual_seed(1000 + i)
            idx = torch.unique(torch.randint(
                t.numel(), (min(D38_SAMPLES, t.numel()),), generator=g))
            flat = t.reshape(-1)
            out[(name,) + path] = (
                idx, flat[idx.to(t.device)].float().cpu(),
                float(t.abs().max()))
    return out


def d38_state_bytes(params, opt) -> tuple[int, int]:
    from repro_torch.models.common import tree_leaves
    p = sum(t.nbytes for _p, t in tree_leaves(params))
    o = sum(t.nbytes for n in ("m", "v")
            for _p, t in tree_leaves(opt[n])) + opt["count"].nbytes
    return p, o


def d38_single(cell: dict, out: Path) -> dict:
    """The single-process step (and prefill) of ``cell`` on the card; its
    samples go to ``out`` for the ranks, its figures are returned."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = d38_config(cell)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    res: dict = {}
    if cell["prefill"]:
        pb = {k: torch.as_tensor(v, device=DEVICE) for k, v in d38_batch(
            cfg, cell, 0, prefill=True).items()}
        res["logits"] = steps.build_prefill_step(cfg)(params, pb).cpu()
        del pb
    opt = adamw_init(params)
    res["bytes"] = d38_state_bytes(params, opt)
    step = steps.build_train_step(cfg, AdamWConfig(), accum=cell["accum"])
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in d38_batch(cfg, cell, 0).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, met = step(params, opt, batch)
    torch.cuda.synchronize()
    res["ms"] = (time.perf_counter() - t0) * 1e3
    res["peak"] = torch.cuda.max_memory_allocated() - base
    res["metrics"] = {k: float(v) for k, v in met.items()}
    res["samples"] = d38_samples({"p": params, "m": opt["m"],
                                  "v": opt["v"]})
    del params, opt, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.save({"samples": res["samples"], "logits": res.get("logits"),
                "metrics": res["metrics"]}, out)
    return res


def d38_compare(shards: dict, specs: dict, full_shapes: dict, mesh,
                want: dict, gnorm: float, lr: float) -> dict:
    """Worst ratio to its limit (1 passes), per tensor kind, of this
    rank's shards against the single process's samples that fall in
    them (see the phase's comment for the limits)."""
    from repro_torch.optim import AdamWConfig
    o = AdamWConfig()
    clip = min(1.0, o.clip_norm / max(gnorm, 1e-9))
    worst = {"p": (0.0, ""), "m": (0.0, ""), "v": (0.0, "")}
    covered = 0
    for key, (idx, val, top) in want.items():
        kind, path = key[0], key[1:]
        shard = shards[kind][path]
        spec = tuple(specs[kind][path]) + (None,) * shard.dim()
        full = full_shapes[path]
        coords = np.unravel_index(idx.numpy(), full)
        keep = np.ones(len(idx), bool)
        local = []
        for d, n in enumerate(full):
            size, i = mesh.index(spec[d])
            blk = n // size
            keep &= (coords[d] >= i * blk) & (coords[d] < (i + 1) * blk)
            local.append(coords[d] - i * blk)
        if not keep.any():
            continue
        covered += int(keep.sum())
        flat = np.ravel_multi_index([c[keep] for c in local],
                                    tuple(shard.shape))
        got = shard.reshape(-1)[torch.as_tensor(flat, device=shard.device)
                                ].float().cpu()
        ref = val[torch.as_tensor(keep)]
        if kind == "p":
            lim = 2.0 ** -7 * ref.abs() + 2.5 * lr
            r = float(((got - ref).abs() / lim).max())
        else:
            if kind == "m":
                gg, gr = got / (1 - o.b1) / clip, ref / (1 - o.b1) / clip
                gtop = top / (1 - o.b1) / clip
            else:
                gg = torch.sqrt(got.clamp_min(0) / (1 - o.b2)) / clip
                gr = torch.sqrt(ref.clamp_min(0) / (1 - o.b2)) / clip
                gtop = (top / (1 - o.b2)) ** 0.5 / clip
            r = float((gg - gr).abs().max()) / (2e-2 * max(1.0, gtop))
        if r >= worst[kind][0]:
            worst[kind] = (r, "/".join(path))
    return {"worst": worst, "covered": covered}


def d38_shapes(cfg, cell: dict) -> dict:
    """The shapes each rank launches the cell's kernels at, as
    ``d38_recorded`` notes them: B9 on the rank's H / model | KV / model
    heads of the whole sequence, B10 on its H / model SSD heads."""
    (sizes, axes) = cell["mesh"]
    m = dict(zip(axes, sizes))["model"]
    rows = cell["batch"] // (math.prod(sizes) // m) // cell["accum"]
    if cfg.ssm_state:
        x = (rows, D38_T, cfg.ssm_heads // m, cfg.ssm_head_dim)
        return {"ssd_chunk": [(x,)], "ssd_chunk_bwd": [(x,)]}
    q = (rows, D38_T, cfg.n_heads // m, cfg.head_dim)
    kv = (rows, D38_T, cfg.n_kv_heads // m, cfg.head_dim)
    return {"flash_attention": [(q, kv)], "flash_attention_bwd": [(q,)]}


def d38_recorded(seen: dict, first: dict):
    """A context in which each kernel wrapper of D38_KERNELS notes the
    shapes of every launch's leading tensors in ``seen[kernel]`` and keeps
    its first launch's arguments in ``first[kernel]``."""
    from repro_torch.kernels import flash_attention as fa, ssd_chunk as sc
    wrappers = {"flash_attention": (fa, "flash_attention_cuda", 2),
                "flash_attention_bwd": (fa, "flash_attention_bwd_cuda", 1),
                "ssd_chunk": (sc, "ssd_chunk_cuda", 1),
                "ssd_chunk_bwd": (sc, "ssd_chunk_bwd_cuda", 1)}
    stack = contextlib.ExitStack()
    for name, (mod, attr, n) in wrappers.items():
        real = getattr(mod, attr)

        def kept(*a, _real=real, _name=name, _n=n, **kw):
            shapes = tuple(tuple(t.shape) for t in a[:_n])
            seen.setdefault(_name, [])
            if shapes not in seen[_name]:
                seen[_name].append(shapes)
            first.setdefault(_name, (a, kw))
            return _real(*a, **kw)
        stack.enter_context(mock.patch.object(mod, attr, kept))
    return stack


def d38_drop_heads(t, dim: int, h0: int):
    """``t`` with its heads from ``h0`` on (along ``dim``) set to zero: the
    output of a kernel that skipped them."""
    t = t.clone()
    t.narrow(dim, h0, t.shape[dim] - h0).zero_()
    return t


def d38_kernel_checks(first: dict) -> dict:
    """Rank 0's kernels of the path on their first launch's real inputs
    against the plain versions: {kernel: {"ratio": worst share of the
    rule, "err": max abs err, "ms", "plain_ms", "bound_ms", "bound_by",
    "zeroed" / "dropped": the least share of the rule over the outputs
    read by zeros in place of the kernel's outputs / by the plain outputs
    with the last head group dropped (B10's ragged group of
    ``BWD_HEADS``-head groups, B9's last K / V head and its query heads),
    "top": max |want| of each output}}.  Each rule is scaled to its
    output's own size, so ``zeroed`` and ``dropped`` must read above 1."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa, ssd_chunk as sc

    def flash_bound(q, k, ops, *ts):
        peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 \
            else PEAK_FP32_FLOPS
        return bound(nbytes(*ts), ops * flash_ops(
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
            True), peak)

    def b10_shape(x, Bm, L):
        return (*x.shape, Bm.shape[-1], L)

    def entry(rule, got, want, dropped, times, bnd):
        """The figures of outputs ``got`` against ``want`` under ``rule``
        (got, want) -> worst share, with the mutated outputs ``dropped``."""
        return {"ratio": max(rule(g, w) for g, w in zip(got, want)),
                "err": max(float((g.float() - w.float()).abs().max())
                           for g, w in zip(got, want)),
                "zeroed": min(rule(torch.zeros_like(g), w)
                              for g, w in zip(got, want)),
                "dropped": min(rule(d.to(g.dtype), w)
                               for d, g, w in zip(dropped, got, want)),
                "top": [float(w.abs().max()) for w in want],
                "ms": times[0], "plain_ms": times[1],
                "bound_ms": bnd[0], "bound_by": bnd[1]}

    def b10_rule(g, w):
        return float(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max())

    def b10_bwd_rule(g, w):
        return float((g - w).abs().max()) \
            / (1e-4 * max(float(w.abs().max()), 1e-30))

    out = {}
    with torch.no_grad():
        if "flash_attention" in first:
            (q, k, v), _kw = first["flash_attention"]
            o, _err, _ratio = b9_sampled_rows(q, k, v)
            T, G = q.shape[1], q.shape[2] // k.shape[2]
            rows = [slice(r0, r0 + QWEN_SAMPLE)
                    for r0 in (0, (T - QWEN_SAMPLE) // 2, T - QWEN_SAMPLE)]
            want = [ref_attention(q[:, r], k[:, :r.stop], v[:, :r.stop],
                                  True) for r in rows]
            got = [o[:, r] for r in rows]
            out["flash_attention"] = entry(
                lambda g, w: out_err(g, w)[1], got, want,
                [d38_drop_heads(w, 2, q.shape[2] - G) for w in want],
                (cuda_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                         causal=True)),
                 cuda_ms(lambda: b9_sampled_rows(q, k, v), reps=1,
                         warmup=0)),
                flash_bound(q, k, 1.0, q, k, v, o))
            del o, got, want
        if "flash_attention_bwd" in first:
            args, kw = first["flash_attention_bwd"]
            got = fa.flash_attention_bwd_cuda(*args, **kw)
            want = ref.flash_attention_bwd(*args, **kw)
            H, KV = args[0].shape[2], args[1].shape[2]
            out["flash_attention_bwd"] = entry(
                flash_bwd_ratio, got, want,
                [d38_drop_heads(w, 2, n - (H // KV if n == H else 1))
                 for w, n in zip(want, (H, KV, KV))],
                (cuda_ms(lambda: fa.flash_attention_bwd_cuda(*args, **kw)),
                 cuda_ms(lambda: ref.flash_attention_bwd(*args, **kw),
                         reps=1, warmup=0)),
                # 10 hd a visible pair: 2.5 times the forward's 4 hd
                flash_bound(args[0], args[1], 2.5, *args, *got))
            del got, want
        if "ssd_chunk" in first:
            (x, dt, A, Bm, Cm), kw = first["ssd_chunk"]
            L = kw["chunk"]
            h0 = sc.BWD_HEADS * ((x.shape[2] - 1) // sc.BWD_HEADS)
            got = sc.ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=L)
            want = plain_ssd_pieces(x, dt, A, Bm, Cm, L)
            out["ssd_chunk"] = entry(
                b10_rule, got, want,
                [d38_drop_heads(w, 2, h0) for w in want],
                (cuda_ms(lambda: sc.ssd_chunk_cuda(x, dt, A, Bm, Cm,
                                                   chunk=L)),
                 cuda_ms(lambda: plain_ssd_pieces(x, dt, A, Bm, Cm, L),
                         reps=1, warmup=0)),
                bound(nbytes(x, dt, A, Bm, Cm, *got),
                      b10_ops(*b10_shape(x, Bm, L))))
            del got, want
        if "ssd_chunk_bwd" in first:
            args, kw = first["ssd_chunk_bwd"]
            x = args[0]
            h0 = sc.BWD_HEADS * ((x.shape[2] - 1) // sc.BWD_HEADS)
            got = sc.ssd_chunk_bwd_cuda(*args, **kw)
            want = ref.ssd_intra_chunk_bwd(*args, **kw)
            # the plain gradient of the first h0 heads only: dB / dC lack
            # the last group's terms, dx / ddt / dA its heads
            part = ref.ssd_intra_chunk_bwd(*[
                a if a is None or i in (3, 4)
                else a.narrow(0 if a.dim() == 1 else 2, 0, h0)
                for i, a in enumerate(args)], **kw)
            dropped = [torch.zeros_like(w) for w in want]
            for d, p, dim in zip(dropped, part, (2, 2, 0, None, None)):
                (d if dim is None else d.narrow(dim, 0, h0)).copy_(p)
            out["ssd_chunk_bwd"] = entry(
                b10_bwd_rule, got, want, dropped,
                (cuda_ms(lambda: sc.ssd_chunk_bwd_cuda(*args, **kw)),
                 cuda_ms(lambda: ref.ssd_intra_chunk_bwd(*args, **kw),
                         reps=1, warmup=0)),
                bound(nbytes(*(t for t in args if t is not None), *got),
                      b10_bwd_ops(*b10_shape(args[0], args[3],
                                             kw["chunk"]))))
            del got, want, part, dropped
    return out


def d38_rank(rank: int, cfg: dict) -> None:
    """One rank of phase 38 cell ``cfg["cell"]``: its figures go to
    ``cfg["out"]/d38_<cell>_rank<r>.pt``."""
    import dataclasses
    comm = rank_comm(rank, cfg)
    dev = comm.device
    cell = D38_CELLS[cfg["cell"]]
    st: dict = {"transport": comm.transport, "device": str(dev),
                "shapes": {}}
    first: dict = {}
    try:
        # phase 35 (e), (f): the dry run's trace of this rank's steps,
        # before the kernels' first launches are recorded
        mcfg = d38_config(cell)
        tokens = torch.from_numpy(
            d38_batch(mcfg, cell, 0)["tokens"][:0]).dtype
        st["predicted"] = {"train": dry_run_trace(
            mcfg, d38_shape(cell), cell["mesh"], cell["accum"], rank,
            tokens)}
        if cell["prefill"]:
            st["predicted"]["prefill"] = dry_run_trace(
                mcfg, dataclasses.replace(d38_shape(cell), kind="prefill"),
                cell["mesh"], 1, rank, tokens)
        with d38_recorded(st["shapes"], first):
            d38_rank_steps(rank, cfg, comm, cell, st)
        if rank == 0:
            torch.cuda.empty_cache()
            st["kernel_checks"] = d38_kernel_checks(first)
        del first
        torch.save(st, Path(cfg["out"]) / f"d38_{cfg['cell']}_rank{rank}.pt")
    finally:
        comm.close()


def d38_rank_steps(rank: int, cfg: dict, comm, cell: dict, st: dict) -> None:
    """Rank ``rank``'s steps of phase 38 cell ``cell``; its figures go to
    ``st``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, cosine_lr

    dev = comm.device
    mcfg = d38_config(cell)
    mesh = make_mesh(*cell["mesh"], comm=comm)
    single = torch.load(cfg["single"], weights_only=False)
    full = lm.init_params(mcfg, seed=0, device=dev)
    shapes = {p: tuple(t.shape) for p, t in tree_leaves(full)}
    params, opt = steps.shard_state(mcfg, full, mesh)
    del full
    torch.cuda.empty_cache()
    init_host = None
    if cell["prefill"]:
        init_host = {p: t.cpu() for p, t in tree_leaves(params)}
    st["bytes"] = d38_state_bytes(params, opt)
    want = dryrun.argument_bytes(mcfg, d38_shape(cell), mesh)
    st["dry_run"] = (want["params"], want["opt"])
    step = steps.build_train_step(mcfg, AdamWConfig(),
                                  accum=cell["accum"], mesh=mesh)

    def batch(s):
        return {k: torch.as_tensor(v, device=dev) for k, v in
                steps.shard_batch(mcfg, d38_batch(mcfg, cell, s),
                                  mesh).items()}

    def timed(fn):
        torch.cuda.synchronize(dev)
        opened = window_open(dev)
        before = dict(comm.bytes)
        calls, secs = dict(comm.calls), comm.seconds
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        rise, headroom = window_close(opened, dev)
        return out, {"ms": (time.perf_counter() - t0) * 1e3,
                     "peak": torch.cuda.max_memory_allocated(dev),
                     "rise": rise, "headroom": headroom,
                     "calls_by_kind": {k: comm.calls[k] - calls[k]
                                       for k in calls},
                     "launches": ops.launch_counts(),
                     "gathered": comm.bytes["gathered"]
                     - before["gathered"],
                     "reduced": comm.bytes["reduced"] - before["reduced"],
                     "calls": {k: comm.calls[k] - calls[k] for k in calls},
                     "comm_ms": (comm.seconds - secs) * 1e3}

    b0 = batch(0)
    (params, opt, met), st["warmup"] = timed(
        lambda: step(params, opt, b0))
    del b0
    st["metrics"] = {k: float(v) for k, v in met.items()}
    p_specs, o_specs = steps.param_and_opt_specs(mcfg, mesh)
    st["check"] = d38_compare(
        {"p": dict(tree_leaves(params)), "m": dict(tree_leaves(opt["m"])),
         "v": dict(tree_leaves(opt["v"]))},
        {"p": dict(tree_leaves(p_specs)),
         "m": dict(tree_leaves(o_specs["m"])),
         "v": dict(tree_leaves(o_specs["v"]))},
        shapes, mesh, single["samples"],
        single["metrics"]["grad_norm"], cosine_lr(AdamWConfig(), 0))
    st["steps"] = []
    for s in range(1, 1 + D38_TIMED):
        bs = batch(s)
        (params, opt, met), fig = timed(lambda: step(params, opt, bs))
        fig["loss"] = float(met["loss"])
        fig["grad_norm"] = float(met["grad_norm"])
        st["steps"].append(fig)
        del bs
    st["shard_shapes"] = {"/".join(p): tuple(t.shape)
                          for p, t in tree_leaves(params)}
    if cell["prefill"]:
        del opt, params
        torch.cuda.empty_cache()
        init = {}
        for path, t in init_host.items():
            node = init
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t.to(dev)
        pb = {k: torch.as_tensor(v, device=dev) for k, v in
              steps.shard_batch(mcfg, d38_batch(mcfg, cell, 0, True),
                                mesh).items()}
        logits, st["prefill"] = timed(
            lambda: steps.build_prefill_step(mcfg, mesh=mesh)(init, pb))
        ref = single["logits"].to(dev)
        st["prefill"]["err"] = float((logits - ref).abs().max())
        st["prefill"]["limit"] = 2e-2 * max(1.0, float(ref.abs().max()))
        st["prefill"]["shape"] = tuple(logits.shape)


def phase_distributed_lm(report: dict, smi: str) -> None:
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.kernels import _build

    gib = 1 / 2**30
    for name in D38_KERNELS:
        report[name].setdefault("dist_train_launches", 0)
    with tempfile.TemporaryDirectory() as tmp:
        for cname, cell in D38_CELLS.items():
            mcfg = d38_config(cell)
            (sizes, axes) = cell["mesh"]
            n = int(np.prod(sizes))
            t0 = time.perf_counter()
            single = d38_single(cell, Path(tmp) / f"d38_{cname}.pt")
            single_s = time.perf_counter() - t0
            cfg = dict(P=n, device=DEVICE, lib=str(_build.build()),
                       store=str(Path(tmp) / f"store38{cname}"), out=tmp,
                       cell=cname, single=str(Path(tmp) / f"d38_{cname}.pt"))
            t0 = time.perf_counter()
            ctx = mp.start_processes(d38_rank, args=(cfg,), nprocs=n,
                                     join=False, start_method="spawn")
            join_ranks(ctx, DIST_JOIN_S)
            wall_s = time.perf_counter() - t0
            ranks = [torch.load(Path(tmp) / f"d38_{cname}_rank{r}.pt",
                                weights_only=False) for r in range(n)]
            mesh_s = ", ".join(f"{a}={s}" for a, s in zip(axes, sizes))
            layers = mcfg.n_layers
            say(f"{cell['arch']} ({layers} layers, fsdp {mcfg.fsdp}) on "
                f"({mesh_s}): {n} ranks ({DIST_LABEL}) spawned, ran and "
                f"joined in {wall_s:.1f} s wall; the single-process step "
                f"(its first: first use included) took {single['ms']:.1f} ms"
                f" (peak {single['peak'] * gib:.2f} GiB above the card's use "
                f"before it), {single_s:.1f} s with its set-up")
            sm = single["metrics"]
            per_step = {"qwen": {"flash_attention": 2 * layers,
                                 "flash_attention_bwd": layers},
                        "mamba": {"ssd_chunk": 2 * layers * cell["accum"],
                                  "ssd_chunk_bwd": layers * cell["accum"]}
                        }[cname]
            shapes = d38_shapes(mcfg, cell)
            for r, st in enumerate(ranks):
                check(st["transport"] == "gloo, host-staged"
                      and st["device"].startswith("cuda"),
                      f"rank {r}: transport {st['transport']} on "
                      f"{st['device']}")
                m = st["metrics"]
                check(abs(m["loss"] - sm["loss"])
                      <= 2e-2 * max(1.0, abs(sm["loss"])),
                      f"{cname} rank {r}: loss {m['loss']:.6f}, single "
                      f"process {sm['loss']:.6f}")
                check(abs(m["grad_norm"] - sm["grad_norm"])
                      <= 2e-2 * sm["grad_norm"],
                      f"{cname} rank {r}: grad norm {m['grad_norm']:.6f}, "
                      f"single process {sm['grad_norm']:.6f}")
                for kind, (w, leaf) in st["check"]["worst"].items():
                    check(w <= 1.0, f"{cname} rank {r}: {kind} of {leaf} at "
                          f"{w:.3f} of its limit")
                check(st["check"]["covered"] > 0,
                      f"{cname} rank {r}: no sample in its shards")
                check(tuple(st["bytes"]) == tuple(st["dry_run"]),
                      f"{cname} rank {r}: resident parameter / moment bytes"
                      f" {st['bytes']}, the dry run's {st['dry_run']}")
                for fig in [st["warmup"]] + st["steps"]:
                    for kname in D38_KERNELS:
                        want = per_step.get(kname, 0)
                        check(fig["launches"][kname] == want,
                              f"{cname} rank {r}: {kname} launched "
                              f"{fig['launches'][kname]} times a step, "
                              f"expected {want}")
                    check(np.isfinite(fig.get("loss", 0.0)),
                          f"{cname} rank {r}: loss not finite")
                check(st["shapes"] == shapes,
                      f"{cname} rank {r}: kernels launched at "
                      f"{st['shapes']}, the rank's heads give {shapes}")
                if cell["prefill"]:
                    pf = st["prefill"]
                    check(pf["shape"] == tuple(single["logits"].shape)
                          and pf["err"] <= pf["limit"],
                          f"{cname} rank {r}: prefill logits {pf['shape']}, "
                          f"max abs err {pf['err']:.4e} (limit "
                          f"{pf['limit']:.4e})")
                    check(pf["launches"]["flash_attention"] == layers,
                          f"{cname} rank {r}: prefill B9 launches "
                          f"{pf['launches']['flash_attention']}")

            def each(fn, fmt="{:.1f}"):
                return " / ".join(fmt.format(fn(st)) for st in ranks)
            step_ms = [sum(f["ms"] for f in st["steps"]) / len(st["steps"])
                       for st in ranks]
            worst = {k: max(st["check"]["worst"][k] for st in ranks)
                     for k in ("p", "m", "v")}
            sb = single["bytes"]
            say(f"{cname}: warm-up step vs the single process on every rank:"
                f" loss {each(lambda s: s['metrics']['loss'], '{:.5f}')} "
                f"(single {sm['loss']:.5f}), grad norm "
                f"{each(lambda s: s['metrics']['grad_norm'], '{:.5f}')} "
                f"(single {sm['grad_norm']:.5f}); the worst sample over the "
                f"ranks " + ", ".join(f"{k} {w:.3f} of its limit ({leaf})"
                                      for k, (w, leaf) in worst.items())
                + f"; samples in the ranks' shards "
                f"{each(lambda s: s['check']['covered'], '{}')}")
            say(f"{cname} ({DIST_LABEL}; {cell['batch']} x {D38_T} tokens a "
                f"step, accum {cell['accum']}), ranks 0-{n - 1}: step "
                + " / ".join(f"{x:.1f}" for x in step_ms)
                + f" ms (mean of {D38_TIMED}; warm-up "
                f"{each(lambda s: s['warmup']['ms'])} ms; the single "
                f"process's first step {single['ms']:.1f} ms), peak "
                f"max_memory_allocated "
                f"{each(lambda s: max(f['peak'] for f in s['steps']) * gib, '{:.2f}')}"
                f" GiB, gathered {each(lambda s: s['steps'][-1]['gathered'] * gib, '{:.3f}')}"
                f" GiB and reduced "
                f"{each(lambda s: s['steps'][-1]['reduced'] * gib, '{:.3f}')}"
                f" GiB a step in "
                f"{each(lambda s: sum(s['steps'][-1]['calls'].values()), '{}')}"
                f" collectives ("
                + ", ".join(f"{k} {v}" for k, v in
                            ranks[0]["steps"][-1]["calls"].items())
                + " on rank 0), "
                f"{each(lambda s: s['steps'][-1]['comm_ms'])} ms of the "
                f"last step in them (host clock, from the end of the "
                f"rank's queued device work); resident parameters / "
                f"moments a rank {ranks[0]['bytes'][0] * gib:.3f} / "
                f"{ranks[0]['bytes'][1] * gib:.3f} GiB (= the dry run's; one"
                f" process {sb[0] * gib:.3f} / {sb[1] * gib:.3f} GiB: "
                f"{ranks[0]['bytes'][0] / sb[0]:.4f} / "
                f"{ranks[0]['bytes'][1] / sb[1]:.4f}); launches a step "
                + ", ".join(f"{k} {v}" for k, v in per_step.items())
                + f" in every rank; losses of the timed steps "
                f"{', '.join(format(f['loss'], '.4f') for f in ranks[0]['steps'])}"
                f"; card {smi}")
            if cell["prefill"]:
                say(f"{cname} prefill {cell['batch']} x {D38_T} on every "
                    f"rank: [B, V] {ranks[0]['prefill']['shape']}, max abs "
                    f"err vs the single process "
                    f"{each(lambda s: s['prefill']['err'], '{:.4e}')} (limit"
                    f" {ranks[0]['prefill']['limit']:.4e}), "
                    f"{each(lambda s: s['prefill']['ms'])} ms")
            say(f"{cname}: every rank launched "
                + "; ".join(f"{k} at " + ", ".join(
                    " x ".join(str(list(t)) for t in shp) for shp in v)
                    for k, v in shapes.items())
                + f" (model = {dict(zip(axes, sizes))['model']}); card {smi}")
            kc = ranks[0]["kernel_checks"]
            for kname, c in kc.items():
                check(c["ratio"] <= 1.0, f"{cname} rank 0: {kname} on its "
                      f"first launch's inputs at {c['ratio']:.4f} of its "
                      f"rule (max abs err {c['err']:.3e})")
                check(min(c["zeroed"], c["dropped"]) > 1.0,
                      f"{cname} rank 0: {kname}'s rule reads zeroed outputs"
                      f" at {c['zeroed']:.4g} and a dropped last head group"
                      f" at {c['dropped']:.4g}: it could pass a wrong kernel")
                report[kname].update(
                    dist_tp_shape=str(shapes[kname][0]),
                    dist_tp_max_abs_err=c["err"], dist_tp_ratio=c["ratio"],
                    dist_tp_ms=c["ms"], dist_tp_plain_ms=c["plain_ms"],
                    dist_tp_bound_ms=c["bound_ms"],
                    dist_tp_bound_by=c["bound_by"])
            check(set(kc) == set(per_step),
                  f"{cname} rank 0: checked {sorted(kc)}, launched "
                  f"{sorted(per_step)}")
            say(f"{cname} rank 0, each kernel's first launch in the step on "
                f"its real inputs vs the plain version: " + "; ".join(
                    f"{k} {c['ratio']:.4f} of its rule (max abs err "
                    f"{c['err']:.3e}; max |want| of each output "
                    + ", ".join(f"{t:.3e}" for t in c["top"])
                    + f"; zeroed outputs read {c['zeroed']:.4g}, the last "
                    f"head group dropped {c['dropped']:.4g}), "
                    f"{c['ms']:.3f} ms (plain {c['plain_ms']:.3f}, bound "
                    f"{c['bound_ms']:.3f} by {c['bound_by']})"
                    for k, c in kc.items())
                + f"; card {smi}")
            for kname in per_step:
                report[kname]["dist_train_launches"] = min(
                    st["steps"][-1]["launches"][kname] for st in ranks)
                report[kname]["dist_train_step_ms"] = max(step_ms)
                report[kname]["dist_train_ranks"] = n
            # phase 35 (e), (f) on the timed steps (the warm-up step's
            # first uses, cuBLAS's workspace among them, are the base)
            dry_run_ranks(f"{cname} train", ranks, "train",
                          lambda st: st["steps"])
            if cell["prefill"]:
                dry_run_ranks(f"{cname} prefill", ranks, "prefill",
                              lambda st: [st["prefill"]])

# Phase 39: the decode step on a mesh of ranks (ROADMAP A.15d(2)), spawned
# as phase 38 is (gloo, host-staged, one card), at full width.
#
# qwen_decode: qwen3-14b cut to 2 of its 40 layers, fsdp (the config's),
# on (data=2, model=2), B = 1 and a cache of decode_32k's 32,768 slots:
# the slots are cut over "data" (B does not divide it) and the 8 K / V
# heads over "model" (layouts (b) and (a) of models/attention.py).  The
# state starts at pos0 = S / 2 - 1 with the caches below it drawn from a
# seed, and 3 teacher-forced steps write across the boundary of the two
# dp ranks' slots.  Each rank's logits are held against one process's
# decode_step on the same state at the bf16 decode rule (PERF.md §2):
# 2e-2 max(1, max |logit|).
#
# mamba_decode: mamba2-130m, all 24 layers, on (data=4, model=2) at
# decode_32k's batch of 128 (32 rows a dp rank): 2 teacher-forced steps,
# then 2 greedy steps through launch.serve.serve(..., comm=).  B10 runs at
# chunk 1 on the rank's 12 of 24 heads (an 8-head group and a ragged
# 4-head one), 24 launches a step.  Rank 0 holds its first B10 launch
# against the plain version under phase 38's rule; the teacher-forced
# steps' logits are held to one process's at the decode rule; the greedy
# tokens must be equal on every rank and, where they differ from one
# process's serve, one process's top-two margin at the first difference
# must lie within the rule.
#
# Every rank reports its ms a step, the bytes gathered and reduced and
# the collectives a token (comm.bytes / calls / seconds), its peak memory,
# and its resident parameter and state bytes, which must equal the dry
# run's per-device figures (dryrun.argument_bytes) for the cell.
D39_CELLS = {
    "qwen_decode": dict(arch="qwen3_14b", layers=2, mesh=((2, 2),
                        ("data", "model")), batch=1, seq=32768, steps=3),
    "mamba_decode": dict(arch="mamba2_130m", layers=None, mesh=((4, 2),
                         ("data", "model")), batch=128, seq=32768,
                         prompt_len=2, gen_len=3),
}
D39_RULE = 2e-2
D39_SMOKE = False           # the smoke widths (a rehearsal on the CPU)


def d39_config(cell: dict):
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if D39_SMOKE else get_config)(cell["arch"])
    if cell["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=cell["layers"])
    return cfg


def d39_shape(cell: dict):
    from repro_torch.launch import steps
    return steps.decode_shape(cell["batch"], cell["seq"])


def d39_state(cfg, cell: dict, dev):
    """qwen_decode's whole state at pos0 = S / 2 - steps / 2, the caches
    below pos0 drawn from a seed on ``dev``."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    pos0 = cell["seq"] // 2 - cell["steps"] // 2
    state = lm.init_decode_state(cfg, cell["batch"], cell["seq"], device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for _path, t in tree_leaves(state["layers"]):
        part = t[:, :, :pos0]
        part.copy_(torch.randn(part.shape, generator=g, device=dev))
    state["pos"] = pos0
    return state


def d39_tokens(cfg, cell: dict) -> np.ndarray:
    return np.random.default_rng(11).integers(
        0, cfg.vocab_size, (cell["steps"], cell["batch"], 1)).astype(np.int32)


def d39_margins(logits) -> tuple:
    """(top-two margin a row, the decode rule's limit) of [B, 1, V]
    logits."""
    top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu(), \
        D39_RULE * max(1.0, float(logits.abs().max()))


def d39_single(cname: str, out: Path) -> dict:
    """One process's decode of ``cname`` on the card: its logits (or
    serve's tokens, teacher-forced logits and margins) go to ``out`` for
    the ranks and the phase, its figures are returned."""
    from repro_torch.launch import serve as t_serve, steps
    from repro_torch.models import lm
    cell = D39_CELLS[cname]
    cfg = d39_config(cell)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res: dict = {"logits": [], "ms": []}
    if cname == "qwen_decode":
        params = lm.init_params(cfg, seed=0, device=DEVICE)
        state = d39_state(cfg, cell, DEVICE)
        step = steps.build_serve_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for toks in d39_tokens(cfg, cell):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = step(params, state, torch.as_tensor(
                toks, device=DEVICE))
            torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["logits"].append(logits.cpu())
        del params, state
    else:
        real = steps.build_serve_step

        def build(cfg_, *, mesh=None):
            step = real(cfg_, mesh=mesh)

            def kept(params, state, toks):
                torch.cuda.synchronize()
                if not res["ms"]:
                    torch.cuda.reset_peak_memory_stats()
                    res["base"] = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                logits, state = step(params, state, toks)
                torch.cuda.synchronize()
                res["ms"].append((time.perf_counter() - t0) * 1e3)
                res.setdefault("margins", []).append(d39_margins(logits))
                if len(res["logits"]) < cell["prompt_len"]:
                    res["logits"].append(logits.cpu())
                return logits, state
            return kept
        with mock.patch.object(steps, "build_serve_step", build):
            res["tokens"] = t_serve.serve(
                cell["arch"], smoke=D39_SMOKE, batch=cell["batch"],
                prompt_len=cell["prompt_len"], gen_len=cell["gen_len"],
                seed=0, device=DEVICE)
    res["peak"] = torch.cuda.max_memory_allocated() - res.pop("base", base)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.save(res, out)
    return res


def d39_rank(rank: int, cfg: dict) -> None:
    """One rank of phase 39 cell ``cfg["cell"]``: its figures go to
    ``cfg["out"]/d39_<cell>_rank<r>.pt``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import serve as t_serve
    from repro_torch.launch.mesh import make_mesh, shard_tree
    from repro_torch.models import attention, lm
    from repro_torch.models.common import tree_leaves

    comm = rank_comm(rank, cfg)
    dev = comm.device
    cname = cfg["cell"]
    cell = D39_CELLS[cname]
    mcfg = d39_config(cell)
    single = torch.load(cfg["single"], weights_only=False)
    st: dict = {"transport": comm.transport, "device": str(dev),
                "shapes": {}, "steps": []}
    first: dict = {}
    attn_bytes: list = []
    real_attn = attention.decode_attention

    def counted_attn(*a, **kw):
        before = sum(comm.bytes.values())
        out = real_attn(*a, **kw)
        attn_bytes.append((sum(comm.bytes.values()) - before,
                           a[3].nbytes + a[4].nbytes))
        return out

    def resident(params, state):
        """The rank's shard bytes, as the steps start (the peak from
        here)."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        st["bytes"] = (sum(t.nbytes for _p, t in tree_leaves(params)),
                       4 + sum(t.nbytes for _p, t in tree_leaves(
                           {k: v for k, v in state.items()
                            if k not in ("pos", "cell")})))

    def timed(step, params, state, toks):
        torch.cuda.synchronize(dev)
        top = torch.cuda.max_memory_allocated(dev)
        opened = window_open(dev)
        before, calls = dict(comm.bytes), dict(comm.calls)
        secs, launched = comm.seconds, ops.launch_counts()
        t0 = time.perf_counter()
        logits, state = step(params, state, toks)
        torch.cuda.synchronize(dev)
        rise, headroom = window_close(opened, dev)
        st["top"] = max(st.get("top", 0), top)
        now = ops.launch_counts()
        st["steps"].append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "rise": rise, "headroom": headroom,
            "gathered": comm.bytes["gathered"] - before["gathered"],
            "reduced": comm.bytes["reduced"] - before["reduced"],
            "calls": sum(comm.calls[k] - calls[k] for k in calls),
            "calls_by_kind": {k: comm.calls[k] - calls[k] for k in calls},
            "comm_ms": (comm.seconds - secs) * 1e3,
            "launches": {k: now[k] - launched[k] for k in now}})
        return logits, state

    def held(logits, t, rows):
        want = single["logits"][t].to(dev)[rows]
        return float((logits - want).abs().max()) / (
            D39_RULE * max(1.0, float(want.abs().max())))

    try:
        mesh = make_mesh(*cell["mesh"], comm=comm)
        st["dry_run"] = tuple(dryrun.argument_bytes(
            mcfg, d39_shape(cell), mesh)[k] for k in ("params", "state"))
        # phase 35 (e), (f): the dry run's trace of this rank's step
        st["predicted"] = {"decode": dry_run_trace(
            mcfg, d39_shape(cell), cell["mesh"], 1, rank)}
        ops.reset_launch_counts()
        with d38_recorded(st["shapes"], first), mock.patch.object(
                attention, "decode_attention", counted_attn):
            if cname == "qwen_decode":
                full = lm.init_params(mcfg, seed=0, device=dev)
                params = shard_tree(full, steps.param_and_opt_specs(
                    mcfg, mesh)[0], mesh)
                del full
                state = steps.shard_decode_state(
                    mcfg, d39_state(mcfg, cell, dev), d39_shape(cell), mesh)
                torch.cuda.empty_cache()
                resident(params, state)
                step = steps.build_serve_step(mcfg, mesh=mesh)
                st["held"] = []
                for t, toks in enumerate(d39_tokens(mcfg, cell)):
                    logits, state = timed(step, params, state,
                                          torch.as_tensor(toks, device=dev))
                    st["held"].append(held(logits, t, slice(None)))
                st["logits_shape"] = tuple(logits.shape)
            else:
                real = steps.build_serve_step
                st["held"] = []
                lo = mesh.dp.index * (cell["batch"] // mesh.dp.size)
                rows = slice(lo, lo + cell["batch"] // mesh.dp.size)

                def build(cfg_, *, mesh=None):
                    step = real(cfg_, mesh=mesh)

                    def kept(params, state, toks):
                        if "bytes" not in st:
                            resident(params, state)
                        logits, state = timed(step, params, state, toks)
                        if len(st["held"]) < cell["prompt_len"]:
                            st["held"].append(held(logits, len(st["held"]),
                                                   rows))
                        return logits, state
                    return kept
                with mock.patch.object(steps, "build_serve_step", build):
                    st["tokens"] = t_serve.serve(
                        cell["arch"], smoke=D39_SMOKE, batch=cell["batch"],
                        prompt_len=cell["prompt_len"],
                        gen_len=cell["gen_len"], seed=0, device=dev,
                        mesh_spec=",".join(f"{a}={s}" for a, s in zip(
                            cell["mesh"][1], cell["mesh"][0])), comm=comm)
        st["launches"] = ops.launch_counts()
        st["peak"] = max(st.pop("top", 0),
                         torch.cuda.max_memory_allocated(dev))
        st["attn_bytes"] = attn_bytes
        if rank == 0 and "ssd_chunk" in first:
            torch.cuda.empty_cache()
            st["kernel_checks"] = d38_kernel_checks(
                {"ssd_chunk": first["ssd_chunk"]})
        del first
        torch.save(st, Path(cfg["out"]) / f"d39_{cname}_rank{rank}.pt")
    finally:
        comm.close()


def d39_say(cname: str, cell: dict, ranks: list, single: dict, wall_s: float,
            smi: str) -> None:
    gib, mib = 1 / 2**30, 1 / 2**20
    (sizes, axes) = cell["mesh"]
    mesh_s = ", ".join(f"{a}={s}" for a, s in zip(axes, sizes))

    def each(fn, fmt="{:.1f}"):
        return " / ".join(fmt.format(fn(st)) for st in ranks)

    def mean(xs):
        return sum(xs) / len(xs)
    say(f"{cname} ({cell['arch']}, {d39_config(cell).n_layers} layers, on "
        f"({mesh_s}), B {cell['batch']}, cache {cell['seq']}; {DIST_LABEL})"
        f": {len(ranks)} ranks spawned, ran and joined in {wall_s:.1f} s; "
        f"ranks 0-{len(ranks) - 1}: ms a decode step "
        f"{each(lambda s: mean([f['ms'] for f in s['steps'][1:]]))} (mean "
        f"of steps 2-{len(ranks[0]['steps'])}; first "
        f"{each(lambda s: s['steps'][0]['ms'])}; one process "
        f"{mean(single['ms'][1:]):.1f}); gathered "
        f"{each(lambda s: s['steps'][-1]['gathered'] * mib, '{:.2f}')} MiB "
        f"and reduced "
        f"{each(lambda s: s['steps'][-1]['reduced'] * mib, '{:.3f}')} MiB "
        f"a token in {each(lambda s: s['steps'][-1]['calls'], '{}')} "
        f"collectives, "
        f"{each(lambda s: s['steps'][-1]['comm_ms'])} ms of the last step "
        f"in them (host clock); peak max_memory_allocated over the steps "
        f"{each(lambda s: s['peak'] * gib, '{:.3f}')} GiB (one process "
        f"{single['peak'] * gib:.3f} GiB above its start); resident "
        f"parameters {ranks[0]['bytes'][0] * gib:.4f} GiB and state "
        f"{ranks[0]['bytes'][1] * mib:.3f} MiB a rank (= the dry run's); "
        f"logits at "
        f"{each(lambda s: max(s['held']), '{:.4f}')} of the decode rule "
        f"against one process; card {smi}")


def phase_distributed_decode(report: dict, smi: str) -> None:
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.kernels import _build

    report["ssd_chunk"].setdefault("dist_decode_launches", 0)
    with tempfile.TemporaryDirectory() as tmp:
        for cname, cell in D39_CELLS.items():
            (sizes, axes) = cell["mesh"]
            n = int(np.prod(sizes))
            out = Path(tmp) / f"d39_{cname}.pt"
            single = d39_single(cname, out)
            cfg = dict(P=n, device=DEVICE, lib=str(_build.build()),
                       store=str(Path(tmp) / f"store39{cname}"), out=tmp,
                       cell=cname, single=str(out))
            t0 = time.perf_counter()
            ctx = mp.start_processes(d39_rank, args=(cfg,), nprocs=n,
                                     join=False, start_method="spawn")
            join_ranks(ctx, DIST_JOIN_S)
            wall_s = time.perf_counter() - t0
            ranks = [torch.load(Path(tmp) / f"d39_{cname}_rank{r}.pt",
                                weights_only=False) for r in range(n)]
            n_steps = len(single["ms"])
            mcfg = d39_config(cell)
            for r, st in enumerate(ranks):
                check(st["transport"] == "gloo, host-staged"
                      and st["device"].startswith("cuda"),
                      f"rank {r}: transport {st['transport']} on "
                      f"{st['device']}")
                check(len(st["steps"]) == n_steps,
                      f"{cname} rank {r}: {len(st['steps'])} steps, one "
                      f"process {n_steps}")
                check(all(np.isfinite(h) and h <= 1.0 for h in st["held"]),
                      f"{cname} rank {r}: logits at "
                      f"{[round(h, 4) for h in st['held']]} of the decode "
                      f"rule against one process")
                check(tuple(st["bytes"]) == tuple(st["dry_run"]),
                      f"{cname} rank {r}: resident parameter / state bytes "
                      f"{st['bytes']}, the dry run's {st['dry_run']}")
                check(st["attn_bytes"] == [] or all(
                    0 < b < cache for b, cache in st["attn_bytes"]),
                      f"{cname} rank {r}: an attention layer moved more "
                      f"than its cache shard: {st['attn_bytes'][:4]}")
            if cname == "qwen_decode":
                layers = mcfg.n_layers
                for r, st in enumerate(ranks):
                    check(st["logits_shape"] == (1, 1, mcfg.vocab_size),
                          f"qwen_decode rank {r}: logits "
                          f"{st['logits_shape']}")
                    check(len(st["attn_bytes"]) == layers * n_steps,
                          f"qwen_decode rank {r}: "
                          f"{len(st['attn_bytes'])} attention calls")
                    check(sum(st["launches"].values()) == 0,
                          f"qwen_decode rank {r}: kernels launched "
                          f"{st['launches']} (decode attention is plain)")
                d39_say(cname, cell, ranks, single, wall_s, smi)
                # phase 35 (e), (f) on the steps after the first (its first
                # uses are the base)
                dry_run_ranks(cname, ranks, "decode",
                              lambda st: st["steps"][1:])
                b, cache = ranks[0]["attn_bytes"][-1]
                say(f"qwen_decode: an attention layer's collectives move "
                    f"{b} B a token on rank 0, its cache shard (K and V) "
                    f"holds {cache / 2**20:.1f} MiB: no cache is gathered")
                continue
            layers = mcfg.n_layers
            H = mcfg.ssm_heads // dict(zip(axes, sizes))["model"]
            rows = cell["batch"] // (n // dict(zip(axes, sizes))["model"])
            want_shape = (rows, 1, H, mcfg.ssm_head_dim)
            toks0 = ranks[0]["tokens"]
            for r, st in enumerate(ranks):
                check(st["launches"]["ssd_chunk"] == layers * n_steps
                      and all(f["launches"]["ssd_chunk"] == layers
                              for f in st["steps"]),
                      f"mamba_decode rank {r}: B10 launched "
                      f"{st['launches']['ssd_chunk']} times, "
                      f"{[f['launches']['ssd_chunk'] for f in st['steps']]}"
                      f" a step, expected {layers} a step")
                check([s[0] for s in st["shapes"].get("ssd_chunk", [])]
                      == [want_shape],
                      f"mamba_decode rank {r}: B10 at "
                      f"{st['shapes'].get('ssd_chunk')}, the rank's heads "
                      f"give {want_shape}")
                check(np.array_equal(st["tokens"], toks0),
                      f"mamba_decode rank {r}: greedy tokens differ from "
                      f"rank 0's")
            want = single["tokens"]
            check(toks0.shape == want.shape,
                  f"mamba_decode: tokens {toks0.shape}, one process "
                  f"{want.shape}")
            diff = np.argwhere(toks0 != want)
            if len(diff):
                row, t = (int(v) for v in diff[np.argmin(diff[:, 1])])
                margins, limit = single["margins"][t - 1]
                margin = float(margins[row])
                check(t >= cell["prompt_len"] and margin <= limit,
                      f"mamba_decode: row {row} differs from one process "
                      f"at position {t}, where its top-two margin is "
                      f"{margin:.4g} (the rule's limit {limit:.4g})")
                first = (f"first differs from one process's at row {row}, "
                         f"position {t} (one process's top-two margin "
                         f"there {margin:.4g}, within the rule's "
                         f"{limit:.4g}); {len(diff)} of {want.size} tokens "
                         f"differ")
            else:
                first = "equal to one process's"
            d39_say(cname, cell, ranks, single, wall_s, smi)
            dry_run_ranks(cname, ranks, "decode", lambda st: st["steps"][1:])
            say(f"mamba_decode: the [{want.shape[0]}, {want.shape[1]}] "
                f"tokens of serve() are equal on every rank and {first}; "
                f"B10 launched {layers} times a step in every rank at "
                f"{want_shape}")
            c = ranks[0]["kernel_checks"]["ssd_chunk"]
            check(c["ratio"] <= 1.0, f"mamba_decode rank 0: B10 on its "
                  f"first launch's inputs at {c['ratio']:.4f} of its rule "
                  f"(max abs err {c['err']:.3e})")
            check(min(c["zeroed"], c["dropped"]) > 1.0,
                  f"mamba_decode rank 0: B10's rule reads zeroed outputs at "
                  f"{c['zeroed']:.4g} and a dropped last head group at "
                  f"{c['dropped']:.4g}: it could pass a wrong kernel")
            say(f"mamba_decode rank 0, B10's first launch at {want_shape} "
                f"(chunk 1) vs its plain version: {c['ratio']:.4f} of its "
                f"rule (max abs err {c['err']:.3e}; max |want| of each "
                f"output " + ", ".join(f"{t:.3e}" for t in c["top"])
                + f"; zeroed outputs read {c['zeroed']:.4g}, the ragged "
                f"last head group dropped {c['dropped']:.4g}), "
                f"{c['ms']:.4f} ms (plain {c['plain_ms']:.3f}, bound "
                f"{c['bound_ms']:.5f} by {c['bound_by']}); card {smi}")
            report["ssd_chunk"].update(
                dist_decode_launches=min(st["launches"]["ssd_chunk"]
                                         for st in ranks),
                dist_decode_shape=str(want_shape),
                dist_decode_max_abs_err=c["err"],
                dist_decode_ratio=c["ratio"], dist_decode_ms=c["ms"],
                dist_decode_plain_ms=c["plain_ms"],
                dist_decode_bound_ms=c["bound_ms"],
                dist_decode_bound_by=c["bound_by"],
                dist_decode_step_ms=max(
                    sum(f["ms"] for f in st["steps"][1:])
                    / (len(st["steps"]) - 1) for st in ranks),
                dist_decode_ranks=n)


def list_value_err(got_v, want_v) -> float:
    """Largest |value difference| of two sets of top-M lists, position by
    position over the wanted lists' real entries (a list's sorted values
    move no further than the scores they sort)."""
    real = want_v > -1e29
    return float((got_v[real] - want_v[real]).abs().max())


def wide_dev0_checks(qc, qq, sd, lo, hi, meta, thr: float, metric: str,
                     M: int) -> dict:
    """B7 and B8 on device 0's tiles at a wide path's shapes (route_of's
    route) against their plain versions on the same tensors: int8 up to
    INT8_EXACT_D equal to the plain version; int8 past it equal to the
    plain version with its dot evaluated in float64 and rounded once
    (``exact_q_dots``); bf16: B8's lists no further from that float64
    evaluation than the plain float32 version's, and B7's band (a capacity
    that holds it) equal to the plain version's but for pairs at its edge
    (``band_edge_check`` with the l2 terms' tolerance)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_batch_q import (
        INT8_EXACT_D, pairwise_threshold_q_cuda, pairwise_topk_q_cuda)

    d = qq.q.shape[-1]
    block = qq.q.shape[2]
    one = slice(0, 1)
    int8 = qq.q.dtype == torch.int8
    kw7 = dict(threshold=thr, capacity=WIDE_CHECK_CAP, block_rows=block,
               metric=metric)
    kw8 = dict(topk=M, block_rows=block, metric=metric)
    got7 = pairwise_threshold_q_cuda(qq.q[one], sd[one], qq.l1[one],
                                     qq.sq[one], lo, hi, meta[one], **kw7)
    got8 = pairwise_topk_q_cuda(qq.q[one], sd[one], qq.sq[one], lo, hi,
                                meta[one], **kw8)
    check(int(got7[3][0]) <= WIDE_CHECK_CAP,
          f"wide B7 check d={d}: device 0's band overflows "
          f"{WIDE_CHECK_CAP}")

    def plain(exact: bool, b7: bool = True):
        with (mock.patch.object(ref, "_q_dots", exact_q_dots) if exact
              else contextlib.nullcontext()):
            w7 = ref.pairwise_threshold_q(
                qq.q[one], qq.scale[one], qq.delta[one], qq.l1[one],
                qq.sq[one], lo, hi, meta[one], **kw7) if b7 else None
            w8 = ref.pairwise_topk_q(qq.q[one], qq.scale[one], qq.sq[one],
                                     lo, hi, meta[one], **kw8)
        return w7, w8

    what = f"wide d={d} {'int8' if int8 else 'bf16'} device 0"
    out = {"B7": {"dev0_band": int(got7[3][0])}, "B8": {}}
    if int8:
        want7, want8 = plain(exact=d > INT8_EXACT_D)
        rule = ("the plain version with its dot in float64 rounded once"
                if d > INT8_EXACT_D else "the plain version")
        check(all(torch.equal(a, b) for a, b in zip(got7, want7)),
              f"{what}: B7's band buffers differ from {rule}")
        check(all(torch.equal(a, b) for a, b in zip(got8, want8)),
              f"{what}: B8's lists differ from {rule}")
        say(f"{what}: B7's band ({int(got7[3][0])} entries) and B8's "
            f"top-{M} lists equal {rule}")
        out["B7"]["dev0_max_abs_err"] = out["B8"]["dev0_max_abs_err"] = 0.0
        return out
    want7, want8 = plain(exact=False)
    _, ex8 = plain(exact=True, b7=False)
    err8, plain8 = (list_value_err(got8[0], ex8[0]),
                    list_value_err(want8[0], ex8[0]))
    check(err8 <= plain8,
          f"{what}: B8's lists read {err8:.3e} from the float64 dot, the "
          f"plain float32 version's {plain8:.3e}")
    n_edge = band_edge_check(qc, thr, got7, want7, f"{what} B7", terms=True)
    err7 = common_value_err(got7, want7, qc.q.shape[0])
    say(f"{what}: B8's top-{M} lists {err8:.3e} from the plain version "
        f"with its dot in float64 rounded once, the plain float32 version "
        f"{plain8:.3e} ({err8 / plain8:.3f} of it), ids differ from the "
        f"plain version's at {int((got8[1] != want8[1]).sum())} of "
        f"{got8[1].numel()} entries; B7's band {int(got7[3][0])} entries "
        f"(plain {int(want7[3][0])}), {n_edge} pairs differ (at its edge), "
        f"values of common pairs within {err7:.3e}")
    out["B7"].update(dev0_max_abs_err=err7, dev0_edge_pairs=n_edge)
    out["B8"].update(dev0_f64_err=err8, dev0_plain_f64_err=plain8)
    return out


def wide_kernel_times(qc, thr: float, metric: str = "l2",
                      checks: bool = True) -> dict:
    """B7 (at ``thr``) and B8 (top-M, M = 16) on the quorum stacks of a
    quantized corpus: device 0's outputs held to the plain versions
    (``wide_dev0_checks``; ``checks=False`` skips them, for
    scripts/pair_q_chunks.py's variants that fail them), route_of's route
    over every device, both routes on device 0's tiles in one call, GEMM
    only per active tile, and the bound (2 d operations a candidate of an
    active tile at the codes' tensor-core peak).  Device ms."""
    from repro_torch.core import quant
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.placement import get_placement
    from repro_torch.kernels import ops
    from repro_torch.kernels.pairwise_batch_q import (
        pairwise_threshold_q_cuda, pairwise_topk_q_cuda)
    from repro_torch.serving.engine import quantize_pow2

    comm = SingleProcessComm(P, DEVICE)
    sched = get_placement("cyclic", P).schedule()
    N, d = qc.q.shape
    block = N // P
    M = quantize_pow2(KNN_TOPK)
    int8 = qc.q.dtype == torch.int8
    store: dict = {}
    quant.quorum_allpairs_threshold_q(
        qc.blocks(), comm, threshold=thr, capacity=QUANT_CAP, schedule=sched,
        metric=metric, mode="batched", n_valid=N,
        batch_fn=capture_batch_fn(store, lambda qb, lo, hi, meta: (
            torch.zeros(P, QUANT_CAP, device=DEVICE),
            torch.zeros(P, QUANT_CAP, dtype=torch.int32, device=DEVICE),
            torch.zeros(P, QUANT_CAP, dtype=torch.int32, device=DEVICE),
            torch.zeros(P, dtype=torch.int32, device=DEVICE))))
    qq, lo, hi, meta = store.pop("args")
    sd = quant._kernel_sd(qq)
    kw7 = dict(threshold=thr, capacity=QUANT_CAP, block_rows=block,
               metric=metric)
    kw8 = dict(topk=M, block_rows=block, metric=metric)
    out = {"B7": ops.pairwise_threshold_q, "B8": ops.pairwise_topk_q}
    one = {"B7": pairwise_threshold_q_cuda, "B8": pairwise_topk_q_cuda}

    def args(name, sl=slice(None)):
        rows = (qq.l1[sl], qq.sq[sl]) if name == "B7" else (qq.sq[sl],)
        return (qq.q[sl], sd[sl]) + rows + (lo, hi, meta[sl])

    res = (wide_dev0_checks(qc, qq, sd, lo, hi, meta, thr, metric, M)
           if checks else {"B7": {}, "B8": {}})
    for name, kw in (("B7", kw7), ("B8", kw8)):
        r = res[name]
        r["ms"] = cuda_ms(lambda: out[name](*args(name), **kw), reps=2)
        for route in ("tensor_cores", "simt"):
            r[f"dev0_{route}_ms"] = cuda_ms(lambda: one[name](
                *args(name, slice(0, 1)), route=route, **kw), reps=1)
    if int8:
        gemm = per_tile_gemm(qq.q, lo, hi, meta, lambda a, b, o: torch._int_mm(
            a, b.T, out=o), torch.int32)
    else:
        gemm = per_tile_gemm(qq.q, lo, hi, meta,
                             lambda a, b, o: torch.mm(a, b.T, out=o),
                             torch.bfloat16)
    cand = active_candidates(meta)
    b_ms, b_by = bound(nbytes(qq.q, sd, qq.l1, qq.sq, meta), 2.0 * d * cand,
                       PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)
    for r in res.values():
        r.update(gemm_only_ms=gemm, bound_ms=b_ms, bound_by=b_by)
    return res


def phase_wide_quant(report: dict) -> None:
    """Phase 40: the quantized join (B7) and k-NN graph (B8) of WIDE_N x
    WIDE_D clustered rows in bf16 and int8, held to the f32 join (B5) and
    graph (B6) of the same rows with phases 13-14's rules; then B7 / B8 at
    this path's shapes and at int8 d = WIDE_INT8_D, device 0's outputs
    held to their plain versions (``wide_dev0_checks``), and timed on
    both routes."""
    from repro_torch.core import quant
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.core.knn import knn_graph
    from repro_torch.core.sparse import similarity_join
    from repro_torch.kernels import ops
    from repro_torch.kernels.pairwise_batch_q import route_of

    comm = SingleProcessComm(P, DEVICE)
    X, xn, thr = join_data(WIDE_D, WIDE_N, WIDE_SEED)
    N = X.shape[0]
    t0 = time.perf_counter()
    fj = similarity_join(X, comm, threshold=thr, metric="l2", mode="batched",
                         placement="cyclic", capacity=JOIN_CAP0,
                         use_kernel=True)
    torch.cuda.synchronize()
    j_s = time.perf_counter() - t0
    f_i = torch.as_tensor(fj.i, device=DEVICE)
    f_j = torch.as_tensor(fj.j, device=DEVICE)
    Xk = X[:WIDE_KNN_N]
    xnk = xn[:WIDE_KNN_N]
    t0 = time.perf_counter()
    fg = knn_graph(Xk, comm, topk=KNN_TOPK, metric="l2", mode="batched",
                   placement="cyclic", use_kernel=True, quant="off")
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    fv = torch.as_tensor(fg.scores, device=DEVICE)
    fi = torch.as_tensor(fg.indices, device=DEVICE)
    del fj, fg
    say(f"wide f32 reference d={WIDE_D} P={P} l2: the join (B5) of {N} "
        f"rows, {f_i.numel()} pairs at threshold {thr:.6g}, in {j_s:.3f} s; "
        f"the top-{KNN_TOPK} graph (B6) of the first {WIDE_KNN_N} in "
        f"{g_s:.3f} s (host clock)")
    rows = torch.arange(WIDE_KNN_N, device=DEVICE)
    for qm in ("bf16", "int8"):
        route = route_of(torch.int8 if qm == "int8" else torch.bfloat16,
                         WIDE_D)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        st: dict = {}
        t0 = time.perf_counter()
        res = quant.quant_similarity_join(
            X, comm, threshold=thr, quant=qm, metric="l2", mode="batched",
            placement="cyclic", capacity=JOIN_CAP0, use_kernel=True, stats=st)
        torch.cuda.synchronize()
        j_s = time.perf_counter() - t0
        j_peak = torch.cuda.max_memory_allocated()
        n7 = ops.launch_counts()["pairwise_threshold_q"]
        check(n7 > 0, f"wide quantized join {qm}: B7 was never launched")
        got_i = torch.as_tensor(res.i, device=DEVICE)
        got_j = torch.as_tensor(res.j, device=DEVICE)
        check(bool((got_i < got_j).all()), f"wide quantized join {qm}: i >= j")
        j_diff = compare_pair_sets(X, xn, thr, got_i, got_j, f_i, f_j,
                                   f"wide quantized join {qm} vs f32")
        check(torch.allclose(torch.as_tensor(res.scores, device=DEVICE),
                             hit_scores(X, xn, got_i, got_j),
                             rtol=SCORE_TOL, atol=SCORE_TOL),
              f"wide quantized join {qm}: scores")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        gst: dict = {}
        t0 = time.perf_counter()
        g = quant.quant_knn_graph(Xk, comm, topk=KNN_TOPK, quant=qm,
                                  metric="l2", mode="batched",
                                  placement="cyclic", use_kernel=True,
                                  stats=gst)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        g_peak = torch.cuda.max_memory_allocated()
        n8 = ops.launch_counts()["pairwise_topk_q"]
        check(n8 > 0, f"wide quantized k-NN {qm}: B8 was never launched")
        gv = torch.as_tensor(g.scores, device=DEVICE)
        gi = torch.as_tensor(g.indices, device=DEVICE)
        check(gi.shape == (WIDE_KNN_N, KNN_TOPK),
              f"wide quantized k-NN {qm}: shape")
        g_diff = 0
        for r0 in range(0, WIDE_KNN_N, 4096):
            r = rows[r0:r0 + 4096]
            g_diff += check_topk_rows(Xk[r], Xk, xnk, gv[r], gi[r], fv[r],
                                      fi[r], f"wide quantized k-NN {qm} "
                                      f"rows {r0}.. vs f32", terms=True)
        del g, gv, gi
        passes = ", ".join(f"M={m}: {n} pending" for m, n in gst["passes"])
        say(f"wide quantized {qm} N={N} d={WIDE_D} P={P} l2 (B7 / B8 route "
            f"{route}): join {res.n_pairs} pairs in {j_s:.3f} s (host clock,"
            f" synchronized), peak {j_peak / 2**30:.3f} GiB, band emitted "
            f"{st['emitted']}, kept {st['kept']}, escalations "
            f"{st['escalations']}, B7 launches {n7}, {j_diff} pairs differ "
            f"from the f32 join's {f_i.numel()} (at the threshold); k-NN "
            f"top-{KNN_TOPK} of {WIDE_KNN_N} rows in {g_s:.3f} s, peak "
            f"{g_peak / 2**30:.3f} GiB, "
            f"passes [{passes}], B8 launches {n8}, {g_diff} ids differ from "
            "the f32 graph (near ties)")
        qc = quant.quantize_corpus(X, P, N // P, qm)
        t = wide_kernel_times(qc, thr)
        del qc
        for name, kern in (("B7", "pairwise_threshold_q"),
                           ("B8", "pairwise_topk_q")):
            r = t[name]
            say(f"wide {name} {kern} {qm} [{P}, k, {N // P}, {WIDE_D}] "
                f"(route {route}): {r['ms']:.3f} ms over every device; "
                f"device 0's tiles tensor cores "
                f"{r['dev0_tensor_cores_ms']:.3f} ms, simt "
                f"{r['dev0_simt_ms']:.3f} ms ("
                f"{r['dev0_simt_ms'] / r['dev0_tensor_cores_ms']:.2f}x); GEMM"
                f" only per active tile {r['gemm_only_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.3f} ms ({r['bound_by']}, {qm} tensor-core "
                "peak)")
            row = report.setdefault(kern, {})
            row[f"wide_{qm}_launches"] = n7 if name == "B7" else n8
            row.update({f"wide_{qm}_{k}": v for k, v in r.items()
                        if k != "bound_by"})
            row[f"wide_{qm}_{'join' if name == 'B7' else 'knn'}_s"] = (
                j_s if name == "B7" else g_s)
    del X, xn, Xk, xnk, f_i, f_j, fv, fi
    torch.cuda.empty_cache()

    # int8 at 1,536: the kernels alone, both routes (device 0's tiles)
    X8, _xn8, thr8 = join_data(WIDE_INT8_D, WIDE_INT8_N, WIDE_SEED + 10)
    qc = quant.quantize_corpus(X8, P, WIDE_INT8_N // P, "int8")
    del X8, _xn8
    t = wide_kernel_times(qc, thr8)
    for name, kern in (("B7", "pairwise_threshold_q"),
                       ("B8", "pairwise_topk_q")):
        r = t[name]
        say(f"wide {name} {kern} int8 [{P}, k, {WIDE_INT8_N // P}, "
            f"{WIDE_INT8_D}] (route {route_of(torch.int8, WIDE_INT8_D)}): "
            f"{r['ms']:.3f} ms over every device; device 0's tiles tensor "
            f"cores {r['dev0_tensor_cores_ms']:.3f} ms, simt "
            f"{r['dev0_simt_ms']:.3f} ms "
            f"({r['dev0_simt_ms'] / r['dev0_tensor_cores_ms']:.2f}x); GEMM "
            f"only per active tile {r['gemm_only_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
        report.setdefault(kern, {}).update(
            {f"wide_int8_{WIDE_INT8_D}_{k}": v for k, v in r.items()
             if k != "bound_by"})


KERNELS = {
    "pairwise_batch": ("src/repro_torch/csrc/pairwise_batch.cu",
                       "src/repro/kernels/pairwise_batch.py:97"),
    "pairwise_corr": ("src/repro_torch/csrc/pairwise_corr.cu",
                      "src/repro/kernels/pairwise_corr.py:52"),
    "pcit_filter": ("src/repro_torch/csrc/pcit_filter.cu",
                    "src/repro/kernels/pcit_filter.py:79"),
    "query_topk": ("src/repro_torch/csrc/query_topk.cu",
                   "src/repro/kernels/query_score.py:121"),
    "pairwise_threshold": ("src/repro_torch/csrc/pairwise_threshold.cu",
                           "src/repro/kernels/pairwise_threshold.py:150"),
    "pairwise_topk": ("src/repro_torch/csrc/pairwise_topk.cu",
                      "src/repro/kernels/pairwise_topk.py:158"),
    "pairwise_threshold_q": ("src/repro_torch/csrc/pairwise_threshold_q.cu",
                             "src/repro/kernels/pairwise_batch_q.py:178"),
    "pairwise_topk_q": ("src/repro_torch/csrc/pairwise_topk_q.cu",
                        "src/repro/kernels/pairwise_batch_q.py:291"),
    # the row's launch is bf16 (wgmma); f32 runs csrc/flash_attention.cu
    "flash_attention": ("src/repro_torch/csrc/flash_attention_tc.cu",
                        "src/repro/kernels/flash_attention.py:103"),
    # B9's gradient: no Pallas backward exists (the JAX package's train
    # step differentiates its plain attention with XLA); it is the backward
    # of the kernel above.  The row's launch is bf16 at hd 128 (wgmma);
    # f32 and the other widths run csrc/flash_attention_bwd.cu
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd_tc.cu",
                            "src/repro/kernels/flash_attention.py:103"),
    "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk.py:60"),
    # B10's gradient: no Pallas backward exists (the JAX package's train
    # step differentiates its plain scan with XLA); it is the backward of
    # the kernel above
    "ssd_chunk_bwd": ("src/repro_torch/csrc/ssd_chunk_bwd.cu",
                      "src/repro/kernels/ssd_chunk.py:60"),
}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this smoke run needs "
            "a CUDA device")
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        say(f"FAIL: no src/repro_torch beside {Path(__file__).name}; run it "
            "from the root of a checkout")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    say(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
        f"({lib})")
    say((lib.parent / "build.log").read_text())
    check_sass(lib)

    report: dict = {}
    held: dict = {}            # the jamba model, from its prefill to serving
    phases = [("kernels B1-B3 vs plain versions",
               lambda: phase_kernels(report)),
              ("kernels B4, B5 vs plain versions",
               lambda: phase_kernels_serving(report)),
              ("engine selfcheck", phase_selfcheck),
              ("serving and sparse selfchecks", phase_selfcheck_serving),
              ("n-body main path", lambda: phase_nbody(report)),
              ("PCIT main path", lambda: phase_pcit(report)),
              ("serving main path", lambda: phase_serving(report)),
              ("join main path", lambda: phase_join(report)),
              ("kernels B6-B8 vs plain versions",
               lambda: phase_kernels_knn(report)),
              ("k-NN and quant selfchecks", phase_selfcheck_knn),
              ("k-NN graph main path", lambda: phase_knn(report)),
              ("quantized join main path", lambda: phase_quant_join(report)),
              ("quantized k-NN main path", lambda: phase_quant_knn(report)),
              ("quantized serving", phase_quant_serving),
              ("kernels B9, B10 vs plain versions",
               lambda: phase_kernels_lm(report)),
              ("quorum and ring attention main path",
               lambda: phase_attention(report)),
              ("mamba2-130m prefill main path",
               lambda: phase_mamba_prefill(report)),
              ("mamba2-130m serving", phase_mamba_serve),
              ("continuous-batching serving", phase_batching),
              ("delta churn", phase_churn),
              ("fault-tolerant sweeps", phase_faults),
              ("observability: comm predictor, feedback, report",
               phase_observability),
              ("qwen3-14b prefill main path",
               lambda: phase_qwen_prefill(report)),
              ("qwen3-14b serving", phase_qwen_serve),
              ("jamba-v0.1 prefill main path",
               lambda: phase_jamba_prefill(report, held)),
              ("jamba-v0.1 serving", lambda: phase_jamba_serve(report, held)),
              ("llama4-scout prefill main path",
               lambda: phase_llama4(report)),
              ("whisper-large-v3 prefill and decode main path",
               lambda: phase_whisper(report)),
              ("qwen2-vl prefill main path", lambda: phase_qwen2_vl(report)),
              ("kernel B9 backward vs its plain version",
               lambda: phase_flash_bwd(report)),
              ("starcoder2-3b train step main path",
               lambda: phase_starcoder2_train(report)),
              ("kernel B10 backward vs its plain version",
               lambda: phase_ssd_bwd(report)),
              ("mamba2-130m train step main path",
               lambda: phase_mamba2_train(report)),
              ("dry run against the card",
               lambda: phase_dry_run(report, smi)),
              ("the distributed backend on the card",
               lambda: phase_distributed(report, smi)),
              ("the serving, join and k-NN paths under the distributed "
               "backend", lambda: phase_distributed_serving(report, smi)),
              ("the LM steps on a mesh of ranks",
               lambda: phase_distributed_lm(report, smi)),
              ("the decode step on a mesh of ranks",
               lambda: phase_distributed_decode(report, smi)),
              ("the quantized join and k-NN graph at d = 960",
               lambda: phase_wide_quant(report))]
    for i, (name, fn) in enumerate(phases, start=2):
        t0 = time.perf_counter()
        say(f"== phase {i}: {name}")
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(f"== phase {i} OK ({time.perf_counter() - t0:.1f} s)")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = report[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     **{k: v for k, v in r.items()
                        if k.startswith(("bf16_", "gemm_only", "simt_",
                                         "f32_", "decode_", "quorum_",
                                         "prefill_", "jamba_", "llama4_",
                                         "whisper_", "qwen2vl_",
                                         "hd256_", "train_", "bwd_",
                                         "dist_", "wide_"))}})
    say(f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
