#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and hold
its CUDA kernels against their plain PyTorch versions.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It prints the card's name and power limit (``nvidia-smi``), then one JSON
line per phase:

* ``build``: compiles ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``
  for ``sm_90a`` (one process per source) and prints the ptxas report;
* ``flash_path``: the long-context path of ``kernels.ops.flash_attention``,
  the float online-softmax kernel, at full width on the models the port
  serves: qwen2-0.5b's 32k causal prefill (14 query / 2 KV heads of 64,
  the ``prefill_32k`` cell of ``repro_torch.launch.shapes`` with its
  global batch cut from 32 to 1) in float32 and in bfloat16, mixtral's 32k
  prefill under its 4096-token window (48 / 8 heads of 128), and a
  BERT-base bucket (8 x 512, 12 heads of 64, bidirectional); each called
  once with the counters zeroed just before and read just after (one launch
  a call), then held against ``flash_attention_plain`` on the card (rtol =
  atol = 2e-4; a 16-bit output also one rounding of its type) and timed
  beside its bound (its operations at the rate the card could do them at
  float32 accuracy: 989 TFLOP/s for 16-bit inputs, 3xTF32's 165 for
  float32) and ``F.scaled_dot_product_attention`` (top-left aligned like
  the kernel; for the window an explicit mask);
* ``main_path``: full-width BERT-base (random weights from a seed, a 15-way
  ``cls`` head) under the golden plan tiled 3x to 12 layers: calibrated with
  ``capture_stats``, quantized with ``apply_plan``, and 32 requests served
  through ``EncoderServeEngine(backend="fused")``, with every kernel's launch
  counter zeroed just before and read just after; the same requests through
  ``backend="reference"`` on the card must give identical predictions and
  logits within rel-Linf 5e-3 (the JAX package's fused-vs-reference budget);
* ``span_path``: the same model, weights and requests under the whole-layer
  int8 span, the tiled golden plan passed through ``int8_dataflow_variant``
  (schema v3: ``softmax='uint8'`` + ``norm='int8'`` on layers 0, 3, 4, 7, 8
  and 11), with the same checks, the plan's fingerprint (which must be the
  JAX package's), and the launches per forward with their sub-counts:
  ``quant_flash_attention`` with ``o_scale``, requantizing ``quant_linear``
  and int8-input ``addnorm_quant``;
* ``pipeline_path``: the paper's main path, ``toolkit.Pipeline``: the
  same model and tiled golden plan bound through ``Pipeline.build(cfg,
  "tnews")`` and ``with_policy`` on the fused and the reference backends,
  a ``WordPieceTokenizer`` trained on a seeded synthetic corpus, and 32 raw
  texts of 8-128 tokens through ``predict_texts`` in batches of 8: identical
  predictions on both backends, logits within rel-Linf 5e-3, the fused
  logits equal to ``EncoderServeEngine``'s on the same token ids at the same
  bucket, and 42 / 6 / 6 / 1 launches a forward with no float
  ``flash_attention`` launch;
* ``autotune_path``: the paper's workflow through the ``SAMP`` facade on
  the same model and weights (float32, ``tnews``, 128 positions, the fused
  backend): ``autotune`` over the prefix grid at stride 4 with the
  int8-dataflow variants, each candidate's accuracy from 2 dev batches of
  64 and its latency from ``WallclockBackend`` (warmup 2, median of 5
  forwards at the facade's (32, 128), on the fused kernels); the report's
  10 candidates must be the grid's, in order. The chosen plan's bundle and
  the tiled golden plan's (``apply`` + ``save``) must each carry the plan's
  fingerprint, pass ``plan_lint`` against bert-base, reload through
  ``SAMP.load`` with logits bit-identical to the pipeline saved, agree with
  the reference backend (rel-Linf 5e-3, identical predictions) and serve
  ``main_path``'s 32 requests with ``predict``'s predictions; the chosen
  plan's forwards, counted, must launch every kernel its layers name, and
  the golden bundle's ``dynamic_quant``. It prints the sweep (accuracy,
  wallclock median and min-max, roofline ms and both speedups over float),
  the chosen candidate, the seconds of ``autotune``, and each bundle's
  bytes and load seconds;
* ``train_path``: the paper's step 0 on the card. ``SAMP.from_config`` on
  full-width BERT-base (float32, ``tnews``, 128 positions, the fused
  backend) and ``finetune`` from seed 0 (``TRAIN_STEPS`` steps at
  ``TRAIN_LR``, batches of 32): every step's loss finite, the last 10
  steps' mean at least 0.1 below the first 10's, float dev accuracy (4
  batches of 32) above 2/15; ``torch.profiler`` over 3 more steps. Then
  ``Trainer.fit`` for 6 steps with checkpoints (10 before slice 18), again
  uninterrupted (the run-to-run spread), and cut at step 3 (5) and
  resumed by a fresh Trainer (``resumed from step 3``, params within the
  spread + 1e-6), with one
  checkpoint's save and load seconds. The trained weights go through
  ``main_path`` (calibrated on its batches, the tiled golden plan, its 32
  requests on both backends, 42 / 6 / 6 / 1 launches a forward) and the
  int8 dev accuracy is read beside the float one. Its training CLI
  (``phase_train_clis``, which runs beside the kernels' build, before
  ``flash_path``: it launches no kernel): ``python -m
  repro_torch.launch.train --arch qwen2-0.5b --full --steps 3 --batch 8
  --seq 256 --ckpt <tmp>`` as a subprocess, then with ``--steps 5``, which
  must resume from step 3 (10 and 15 steps before slice 18); both exit 0.
  Beside it, on two ranks, ``mesh_train_path``'s CLI (below). It prints
  the median step
  ms (host clock after the loss is read), training tokens/s, peak device
  memory and the phase's seconds; the served path joins the kernel
  summary (``by_path``);
* ``setup_decoder``: full-width qwen2-0.5b (random weights from seed 0),
  the golden plan tiled 6x to 24 layers, its calibration batches (2 of
  4 x 128 tokens) and 16 requests (prompt lengths uniform in 8-64, tokens
  uniform, both from numpy seed 0; 16 greedy tokens each);
* ``decode_path``: the requests served by ``ServeEngine(kv_cache=
  "int8_per_token")`` over a paged pool (8 slots, pages of 16, max_len 128,
  no oversubscription) on the fused backend, counted, and on the reference
  backend: identical tokens, logits within rel-Linf 5e-3 at every tick where
  both engines saw the same inputs, the launches per tick the plan implies
  (``decode_attention`` on the 12 layers whose qkv block is float), no page
  in use afterwards, the int8 pool's bytes beside a float pool's;
* ``decode_head_path``: the same with every layer's KV cache
  ``int8_per_head`` and ``softmax='uint8'`` on the float-qkv layers (schema
  v3, fingerprint held to the JAX package's): the kernel's per-head scales
  and its two-pass ``p_scale`` mode;
* ``adaptive_path``: input-adaptive precision on the fused backend. The
  routed encoder: ``main_path``'s model and weights, ``LengthBuckets((16,
  64))`` (three clusters, at lengths 16, 64 and 128), calibrated per
  cluster on ``clustered_synthetic_batches`` under a plan set of three
  members (the span plan, the tiled golden plan, ``quant_ffn_only`` at k =
  8), ``main_path``'s 32 requests through ``EncoderServeEngine(router=)``:
  logits equal (0.0) to an unrouted engine running each cluster's entry
  alone, one cached callable per (cluster, bucket) reached, each member
  forward launching exactly what its plan names, ``requests_by_cluster``
  the length split. Then ``EmbeddingKMeans(k=2)`` fitted on the pooled
  calibration embeddings (through ``fused_embed``) routes 8 requests, each
  assignment equal to the card's argmin and to a numpy one on embeddings
  recomputed on the CPU; ``SAMP.autotune(clusters=LengthBuckets((16,
  64)))`` (stride 4, ``autotune_path``'s evaluation and wallclock), saved
  as a v3 bundle and reloaded on both backends (member trees and fused
  predictions bit-identical, routed serving too, the reference within
  5e-3 with identical predictions); and routed decode, full-width
  qwen2-0.5b under ``LengthBuckets((32,))`` and the tiled golden plan with
  per-cluster scales over shared int8 per-token pages, the 16 prompts at 8
  tokens each: tokens equal to each member served alone, 0 pages in use,
  the plan's launches on every routed tick. It records requests/s routed
  and unrouted, admission ms a request, ``autotune`` s, v3 bundle bytes and
  load s, and is a path of the kernel summary (``by_path``, per one forward
  of each member);
* ``http_path``: the HTTP/SSE front-end and the serving CLIs, as a user
  starts them. ``repro_torch.launch.server.build_frontend`` on the
  server's argv builds full-width BERT-base (``--task tnews``, the tiled
  golden plan from a file, the fused backend, 8 slots, max_len 128):
  ``main_path``'s 32 requests from concurrent clients (a warm-up pass, the
  counted pass, a timed pass), every response's logits equal (0.0) to a
  direct ``EncoderServeEngine`` over the front-end's params and plan fed
  the micro-batches the batcher made, in their order, predictions equal,
  the reference backend within rel-Linf 5e-3 with identical predictions,
  42 / 6 / 6 / 1 launches a forward the batcher made, every
  ``CORE_METRICS`` family at ``/metrics``; then, on engines sharing its
  runtime, 429 + ``Retry-After: 1`` for 4 of 6 clients against
  ``max_pending=2``, 504 for a queued request past its 100 ms deadline
  (evicted, never batched), and a drain answering 200 in flight and 503 +
  ``Retry-After: 5`` to a new request. It builds full-width qwen2-0.5b
  (``--task lm``, the golden plan tiled 6x, int8 per-token pages of 16) and
  streams the 16 decode prompts over SSE, 16 tokens each: each stream's
  tokens equal to a direct ``ServeEngine``'s, the ``done`` transcript equal
  to the streamed tokens with indices 0..15, 0 pages in use after, 102 /
  12 / 18 / 12 launches a tick. Last, ``python -m
  repro_torch.launch.server`` as a subprocess (its port read from its
  ``listening on`` line, ``/healthz`` and 8 ``/v1/encode`` requests,
  SIGTERM, exit 0 within 60 s) and ``python -m repro_torch.launch.serve``
  on qwen2-0.5b (exit 0). It records HTTP and direct requests/s, the
  driver's latency p50 / p95, SSE and direct generated tokens/s and the
  start-up seconds, each with the card's name and power limit; both
  front-ends are paths of the kernel summary (``http_path``,
  ``http_decode_path``);
* ``mesh_path``: multi-GPU serving on mesh ranks. Two ranks spawned with
  ``repro_torch.distributed.comm.spawn``, both on this card over gloo (NCCL
  refuses two ranks on one device; the gloo collectives it runs on CUDA
  tensors are probed and printed, with the process-group backend), each
  rebuilding main_path's BERT-base (seed 0, the tiled golden plan,
  calibrated on the mesh: stats equal to main_path's exactly) and serving
  its 32 requests through ``EncoderServeEngine(backend="fused", mesh=...)``
  at (data=2, model=1) and (data=1, model=2), then qwen2-0.5b (8 of the
  decode prompts, 16 greedy tokens, int8 per-token pages of 16, 8 slots).
  Data parallel is held bit for bit against unmeshed runs at the per-rank
  shapes (each call's rows at the rank's bucket; the decode at 4 slots);
  tensor parallel, whose int8 GEMMs sum exact int32 accumulators
  (``quant_linear``'s accumulator mode, ``dynamic_quant``'s scale-in mode
  for the per-token row-parallel inputs) and whose float layers reorder
  their sums, within ``MESH_BUDGET`` of main_path's encode logits, and
  its golden decode, teacher-forced on the unmeshed 8-slot run's tokens,
  within ``MESH_DECODE_BUDGET`` of that run's logits row by row (a
  reordered float sum flips int8 codes at ties, which stay in the pages;
  the unmeshed port's own 4-slot run is compared the same way); under an
  all-int8 plan (the golden plan's static layers beside fully per-token
  ones) every teacher-forced row within ``MESH_EXACT_TOL`` and every
  argmax equal; predictions equal main_path's, no page in use after, and
  each rank's launches a forward or tick as ``EXPECTED_MESH`` (the
  unmeshed paths' counts: the kernels take a rank's blocks at any width,
  qwen2's 64-column ``wk``/``wv`` shards and ``decode_attention`` on one
  KV head included). The kernels' mesh shapes are held against their
  plain versions. It records each rank's wall a forward or tick, its
  collectives and its peak memory, beside the unmeshed port's own
  batching noise; two ranks on one card measure no multi-GPU speed;
* ``http_mesh_path``: the HTTP front-end on mesh ranks (slice 19), inside
  ``mesh_path``'s two ranks on the engines they built. At each topology
  rank 0 mounts the meshed BERT-base encoder in ``HTTPFrontend``, whose
  driver publishes each pass's engine operations over the gloo control
  group (``comm.broadcast_object``), and rank 1 replays them
  (``driver.follow``); ``mesh_path``'s 32 requests arrive over HTTP.
  Every rank's served logits equal (0.0) the direct meshed engine fed the
  micro-batches rank 0's batcher made (rank 1's batches equal rank 0's),
  predictions identical, 42 / 6 / 6 / 1 launches a forward a rank; then a
  drain with one request in flight (200; a new one 503; both ranks
  return). The same for qwen2-0.5b: the 8 prompts as SSE streams of 16
  tokens equal to the direct meshed ``ServeEngine``'s (data parallel's
  is ``mesh_path``'s own free run), one ``done`` a stream, 0 pages in use,
  102 / 12 / 18 / 12 launches a tick a rank. The CLI, ``python -m
  repro_torch.launch.server --arch bert-base --plan <the tiled golden
  plan> --backend fused --mesh 2,1 --port 0``, starts after the build and
  runs beside the phases up to ``mesh_path`` (``start_http_mesh_cli``);
  afterwards it must answer ``/healthz`` and one ``/v1/encode`` (its
  ``samp_build_info`` naming the mesh), exit 0 within ``HTTP_EXIT_S`` of
  SIGTERM after ``drained; bye``, and leave no rank. It records each
  rank's HTTP and direct requests/s, p50 / p95, SSE and direct tokens/s,
  the control channel's calls, bytes and host seconds, and the CLI's
  start-up seconds;
* ``mesh_train_path``: training on mesh ranks (``Trainer(mesh=...)``):
  two ranks on this card over gloo train full-width BERT-base (tnews
  ``cls``, float32, seed 0, batches of 32 x 128, lr 1e-4) from one init on
  the same global batches at (data=2, model=1) (FSDP, data parallel, 6
  steps, checkpoints at 3 and 6), (data=1, model=2) (tensor parallel, 6
  steps) and (pod=2, data=1, model=1) with ``compress_pod_grads`` (2
  steps), beside the unmeshed port on rank 0 at one batch of 32 and at
  two of 16 (its own noise). Data parallel's first loss and every
  gathered gradient bit for bit the unmeshed port's at ``grad_accum = 2``,
  every step's loss within ``MESH_TRAIN_NOISE_FACTOR`` times the loss
  noise of it and the params after 6 steps within
  ``MESH_TRAIN_DP_PARAMS`` (1e-5); tensor parallel's step-1 gradient,
  every step's loss and the params after 6 steps against the one-batch
  run's, each within ``MESH_TRAIN_NOISE_FACTOR`` times that noise; both
  pod steps bit for bit the port's plain version (error state g -
  q·scale, update, step 2's loss); ZeRO-3 bytes a rank; the
  tensor-parallel mesh resumes the data-parallel run's step-3 checkpoint
  bit for bit. The step-6 checkpoint is served like ``main_path``
  (identical predictions, 5e-3, 42 / 6 / 6 / 1). Its CLI, ``python -m
  repro_torch.launch.train --arch qwen2-0.5b --full --mesh-model 2
  --ranks 2 --batch 4 --seq 64``, runs 3 steps, then resumes to 5, side
  by side with ``train_path``'s CLI and both beside the kernels' build
  (they launch no kernel; start-up and the 6 GB checkpoints take most of
  them). It records
  each rank's step ms, collectives (calls, bytes, host s) and peak memory
  a topology;
* ``kernel``: each kernel against its plain version at every shape a path
  gave it, and at the (8, 128) bucket (the decode paths: 8 slots, the
  longest tick) its time, its plain version's and a PyTorch library call's
  where one computes the same function (CUDA events, median of 25, L2
  flushed: ``ms``, which holds the wrapper's host time), the kernel's and
  the library call's device time (``torch.profiler``, L2 flushed:
  ``device_ms``, ``library_device_ms``), beside its bound: the larger of
  its bytes over 3.35 TB/s and its operations over 1979 TOP/s (int8) or 67
  TFLOP/s (float32); ``decode_attention`` at 4096 cached tokens in
  each of the 8 slots (seeded operands, pages of 16), the context its
  split over pages is for, and at head dim 256 with pages of 128 tokens
  (gemma2-2b's 4 KV heads, a group of 2, softcap 50, 1024 tokens a slot),
  where K and V share one page buffer, bit for bit;
  ``quant_flash_attention`` at BERT-base's full 512 positions (8 x 12
  heads x 512 x 64, seeded, with and without ``o_scale``), equal to its
  plain version bit for bit; and the streamed
  variants of ``addnorm_quant`` (8 rows of 16384) and ``dynamic_quant`` (8
  rows of 40000), rows past their register plans (``wide_rows``), h and the
  dynamic codes equal to the plain versions bit for bit;
* ``profile``: ``torch.profiler`` over forwards of each encoder path at the
  (8, 128) bucket and over a window of full decode ticks: device-busy ms per
  forward or tick, idle share, ms of each ported kernel and the top device
  kernels.

The models of those four paths are then freed, and the MoE slice runs:

* ``setup_moe``: full-width mixtral-8x22b cut to 2 layers (random float32
  weights from seed 0, 21.9 GB; 4 until slice 17), the golden v4 plan's
  first two layers (the plan's fingerprint held to the JAX package's), 2 calibration batches of 4 x 128 and 16 requests
  (prompts uniform in 8-64 tokens over the 32768-token vocab, numpy seed 0;
  16 greedy tokens each);
* ``moe_decode_path``: calibrated, quantized (the float tree then dropped),
  and served by ``ServeEngine(precision=plan)`` (8 slots, max_len 128, pages
  of 16 for the plan's int8 KV, which every local layer's dense ring leaves
  unused) on the fused backend, counted, and on the reference backend, with
  the decode paths' checks: identical tokens, logits within rel-Linf 5e-3,
  the launches per tick the plan implies (``quant_expert_gemm`` on the
  routed expert stacks of layers 0 and 1: static and per-token scales),
  0 pages in use, and the
  phase's peak device memory; then its kernels (``quant_expert_gemm`` at
  the served capacity C = 3 and at C = 160, a (4, 128) forward's) and a
  profiled window of its ticks. It also counts the (slot, expert) routings
  of live slots that expert capacity dropped over the run, on both
  backends (idle slots route too and take capacity, as in the JAX engine),
  in two further runs outside the timed ones that must serve the same
  tokens.

Then ``arch_mesh_path`` (slice 17): two ranks on this card over gloo, as
``mesh_path``, serve one model at a time at full width, each rank building
and calibrating the whole float tree (unmeshed and on the mesh: stats
equal) and quantizing it under the model's plan (the MoE archs also under
an all-int8 expert plan): mixtral-8x22b cut to 2 layers (golden v4's first two) and
deepseek-v2-236b cut to 2 (layer 0 dense, layer 1 the 160-expert MoE) at
(data=2, model=1), expert parallel (a rank's experts over every group's
rows by ``all_to_all``), and at (data=1, model=2), each expert's hidden
units split (``wd`` through ``quant_expert_gemm``'s accumulator mode) and
deepseek-v2's MLA heads; hubert-xlarge (4 layers, the span: one encode of
8 x 64 frames), paligemma-3b (4), recurrentgemma-9b (3: two RG-LRU, one
local attention) and xlstm-125m (2) at (data=1, model=2). The decoders
serve 8 prompts of 4-8 tokens, 16 greedy tokens, 8 slots, pages of 16.
Data parallel is held bit for bit against an unmeshed engine with the
rank's 4 slots serving the rank's requests (its token group); tensor
parallel, teacher-forced on the unmeshed 8-slot run, within
``MESH_DECODE_BUDGET`` (deepseek-v2 ``MESH_MOE_DECODE_BUDGET``, hubert's
encode ``MESH_BUDGET``) under the served plan and within
``MESH_EXACT_TOL`` with every argmax equal under the all-int8 plan; launches a tick as the unmeshed runs', the accumulator mode
once a MoE layer a tensor-parallel tick, no page in use after. It prints
each rank's peak memory, wall a tick, collectives and the routings expert
capacity dropped beside the unmeshed run's, and times the accumulator mode
at its mesh shapes against its plain version.

Then the attention archs of slice 13, one model at a time (``setup_arch``:
full width, seeded float32 weights, 2 calibration batches of 4 x 128; each
calibrated, quantized, its float tree dropped, served on the fused and the
reference backends, its kernels held against their plain versions at the
shapes it gave them and timed there, then freed; ``arch_summary`` prints
its seconds and peak device memory). The decode paths serve 8 prompts of
8-64 tokens (numpy seed 0), 16 greedy tokens each, 8 slots, max_len 128,
with the decode paths' checks (identical tokens, logits within rel-Linf
5e-3 at every tick both engines saw, the plan's launches a tick exactly,
0 pages in use after):

* ``gemma2_decode_path``: gemma2-2b cut from 26 to 7 layers, the
  golden plan tiled over them, int8 per-token pages of 128 tokens on the 3
  global layers beside the 4 local layers' dense rings: ``decode_attention`` at head
  dim 256 with pages of 128 and softcap 50 on the float-qkv global
  layers, the final softcap 30;
* ``granite_decode_path``: granite-20b cut from 52 to 4 layers (the
  golden plan), MQA: ``decode_attention`` with a group of 48, split over two blocks;
* ``deepseek_coder_decode_path``: deepseek-coder-33b cut from 62 to 4
  layers, a group of 7;
* ``hubert_encode_path``: hubert-xlarge cut from 48 to 12 layers (24 in
  slices 17-18), the span (golden x 3 through ``int8_dataflow_variant``): 16
  seeded frame sequences (T
  uniform in 16-128, 512 features) through ``Runtime.encode`` with their
  lengths, 8 a call, frame logits within rel-Linf 5e-3 and the predicted
  codes identical: ``quant_flash_attention`` at head dim 80;
* ``paligemma_path`` and ``paligemma_decode_path``: paligemma-3b cut from
  18 to 4 layers: one ``Runtime.encode`` of 8 rows of 256 seeded prefix embeddings
  (1152 wide) beside 8-32 tokens (hidden states and the text positions'
  logits within 5e-3, their argmax identical), then the text decode of
  the prompts over int8 per-token pages of 16;
* ``mla_decode_path``: deepseek-v2-236b cut from 60 to 2 layers (layer 0
  dense, layer 1 MoE: 160 experts, top 6, 2 shared), ``quant_ffn_only``
  with the experts family: MLA's absorbed decode over float latent pages
  on the reference path, ``quant_expert_gemm`` at 160 experts (C = 1 a
  tick), and the routings expert capacity dropped on both backends.

Then the recurrent archs of slice 14, the same way:

* ``recurrentgemma_decode_path``: recurrentgemma-9b cut from 38 to 10
  layers (7 RG-LRU, 3 local attention), the golden plan tiled
  over them: the RG-LRU mix on the reference path, its FFN's GEMMs through
  ``quant_linear`` and ``dynamic_quant``, ``addnorm_quant`` at the local
  layers' residual boundary, no ``decode_attention`` (the local layers
  keep rings);
* ``xlstm_decode_path`` and ``xlstm_encode_path``: xlstm-125m cut from
  12 to 6 layers (3 mLSTM, 3 sLSTM blocks): the decode of the prompts, and one
  ``Runtime.encode`` of 4 x 512 seeded tokens (two mLSTM chunks: logits
  within 5e-3, argmax identical). No kernel launches on either: each
  count is held to 0.

Every launch count is also held to the table :data:`EXPECTED_ARCHS`, and
``fused_embed`` launches on none of them (no learned positions). The
kernel phase also runs the three attention kernels at head dims 320 and
512 (``run_wide_head_cases``: their wide kernels, which no config serves).

Then the kernel summary line (per kernel, its sums over one forward of the
span path at (8, 128), or over one tick of the decode path, or of the MoE
path for ``quant_expert_gemm``, and over one forward or tick of each path
under ``by_path``, the slice-13 paths included; for ``flash_attention`` its qwen2 float32 32k call, the
other cases under ``by_case``) and, last, ``{"ok": true, "device": ...}``. A failed
check or a missing CUDA device exits non-zero before the ok line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN_PLAN = ROOT / "tests" / "data" / "golden_plan.json"
GOLDEN_V4 = ROOT / "tests" / "data" / "golden_plan_v4.json"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # dense bf16 / fp16 tensor-core peak
TF32_OPS_PER_S = 495e12          # dense TF32 tensor-core peak
TILE = 3                         # golden plan (4 layers) x 3 = 12 layers
N_REQUESTS = 32
PROFILE_BUCKET = (8, 128)
REL_LINF_BUDGET = 5e-3
# the JAX package's fingerprint of int8_dataflow_variant(golden x 3)
SPAN_FINGERPRINT = ("b93bbe742882640bd8f7f33f32a317dc"
                    "1e33de5a595a6666fb2382e7879cbea8")
# launches per forward each plan implies, with the span's sub-counts
EXPECTED = {
    "main_path": {"quant_linear": 42, "addnorm_quant": 6, "dynamic_quant": 6,
                  "fused_embed": 1},
    "span_path": {"quant_linear": 42, "addnorm_quant": 6, "dynamic_quant": 6,
                  "fused_embed": 1, "quant_flash_attention": 6},
}
EXPECTED["train_path"] = EXPECTED["main_path"]
EXPECTED_SUB = {"quant_flash_attention with o_scale": 6,
                "quant_linear with out_scale": 12,
                "addnorm_quant with an int8 delta": 6}

DECODE_TILE = 6                  # golden plan (4 layers) x 6 = 24 layers
DECODE_REQUESTS = 16
DECODE_MAX_TOKENS = 16           # 32 before mesh_path: the time limit
DECODE_SLOTS = 8
PAGE_SIZE = 16
DECODE_MAX_LEN = 128
DECODE_BUCKET = (DECODE_SLOTS, 1)
LONG_DECODE_TOKENS = 4096        # a slot's cached tokens, kernel phase
# quant_flash_attention off the served paths at BERT-base's full 512
# positions: (batch, heads, length, head dim), kernel phase
LONG_ATTENTION = (8, 12, 512, 64)
# rows past the register plans, kernel phase: addnorm_quant's (over 8192
# values) and dynamic_quant's (over 32768) streamed variants
WIDE_ADDNORM = (8, 16384)
WIDE_DYNAMIC_QUANT = (8, 40000)
# the JAX package's fingerprint of the decode_head_path plan
HEAD_FINGERPRINT = ("2c48bdf24412c6c9ca841741bb5088ad"
                    "b664eb99e9791e86a62cf21e257e3b11")
# launches per tick each decode plan implies, with the p_scale sub-count
EXPECTED_DECODE = {"quant_linear": 102, "addnorm_quant": 12,
                   "dynamic_quant": 18, "decode_attention": 12}
EXPECTED_DECODE_SUB = {
    "decode_path": {"decode_attention with p_scale": 0},
    "decode_head_path": {"decode_attention with p_scale": 12}}

# the golden v4 plan's first two layers (of its 4; of mixtral's 56): one
# expert stack at static per-expert scales, one at per-token scales. 4
# until slice 17, cut to keep the script at its time beside arch_mesh_path
MOE_LAYERS = 2
# the JAX package's fingerprint of tests/data/golden_plan_v4.json
MOE_FINGERPRINT = ("1975482e7c32269fe19291e8b571accb"
                   "fec0a6647da894a507e6531f228bc9ac")
MOE_FORWARD = (4, 128)           # the calibration batches' shape
# launches per tick the golden v4 plan's first two layers imply on
# mixtral, with sub-counts
EXPECTED_MOE = {"quant_linear": 4, "dynamic_quant": 3,
                "quant_expert_gemm": 6}
EXPECTED_MOE_SUB = {"quant_linear with out_scale": 1,
                    "quant_expert_gemm with per-token scales": 3}

# the long-context cases of the float flash_attention path: (name, (B, Hq,
# Hkv, S, d), mask, dtype, origin); "prefill_32k" stands for that cell of
# repro_torch.launch.shapes (its seq_len), read when the phase runs
FLASH_CASES = (
    ("qwen2", (1, 14, 2, "prefill_32k", 64), {"causal": True}, "float32",
     "qwen2-0.5b, prefill_32k (repro_torch.launch.shapes.SHAPES), global "
     "batch 32 cut to 1"),
    ("qwen2_bf16", (1, 14, 2, "prefill_32k", 64), {"causal": True},
     "bfloat16", "the same in bfloat16"),
    ("mixtral", (1, 48, 8, 32768, 128), {"causal": True, "window": 4096},
     "float32", "mixtral-8x22b, 32k prefill under its sliding window"),
    ("bert", (8, 12, 12, 512, 64), {}, "float32",
     "bert-base, a batch of 8 at 512 tokens, bidirectional"),
)
FLASH_TOL = 2e-4                 # the JAX test's budget (tests/test_kernels.py)
PIPELINE_TEXTS = 32
PIPELINE_BATCH = 8
AUTOTUNE_STRIDE = 4              # the prefix grid at k = 4, 8, 12
AUTOTUNE_EVAL = (2, 64)          # dev batches x batch size a candidate
AUTOTUNE_LATENCY = (32, 128)     # the facade's latency batch x positions
# train_path: SAMP.finetune of full-width BERT-base on tnews (float32, 128
# positions), its gates, the resume check's run length, the CLI's two runs
TRAIN_STEPS = 60                 # 100 until slice 19 (its time limit)
TRAIN_LR = 1e-4
TRAIN_BATCH = 32
TRAIN_SEQ = 128
TRAIN_EVAL = (4, 32)             # dev batches x batch size
TRAIN_LOSS_DROP = 0.1            # mean of the last 10 below the first 10
TRAIN_RESUME = (6, 3)            # steps, and the step the run is cut at
                                 # ((10, 5) before slice 18: the time limit)
# arch, steps, resumed, B, S (10 and 15 before slice 18: the time limit)
TRAIN_CLI = ("qwen2-0.5b", 3, 5, 8, 256)
TRAIN_CLI_S = 600.0
# adaptive_path: BERT-base routed over three length clusters (<= 16, <= 64,
# <= 128 tokens: the buckets 16, 64 and 128), the quant_ffn_only member's
# prefix, the requests the k-means router admits, and qwen2-0.5b routed
# over two (<= 32, > 32) with generation cut from 32 tokens to 8 (the
# routed and the solo runs serve the requests twice more)
ADAPTIVE_EDGES = (16, 64)
ADAPTIVE_FFN_K = 8
ADAPTIVE_KMEANS_REQUESTS = 8
ADAPTIVE_DECODE_EDGES = (32,)
ADAPTIVE_DECODE_MAX_TOKENS = 8
# the JAX package's fingerprint of the golden plan tiled 3x
GOLDEN_FINGERPRINT = ("15b938404e76359d6c4ef8dc3ac5eae8"
                      "9eb7b67e01c0f6125744d146dc46c0f1")
# decode_attention at head dim 256 with pages of 128 tokens, kernel phase:
# gemma2-2b's attention (4 KV heads, a group of 2, softcap 50), 8 slots of
# 1024 cached tokens
WIDE_PAGE_DECODE = {"kv_heads": 4, "group": 2, "head_dim": 256,
                    "page_size": 128, "softcap": 50.0, "tokens": 1024}
# http_path: the front-ends' slots (encoder micro-batch, decode slots) and
# length cap; the time limits of one HTTP exchange, one front-end session,
# a server subprocess's start (spawn to its listening line) and its exit
# after SIGTERM, and the one-shot serve CLI; its requests and tokens, and
# the /v1/encode requests sent to the server subprocess
HTTP_SLOTS = 8
HTTP_MAX_LEN = 128
HTTP_EXCHANGE_S = 120.0
HTTP_SESSION_S = 300.0
HTTP_START_S = 300.0
HTTP_EXIT_S = 60.0
HTTP_CLI_S = 600.0
HTTP_CLI_REQUESTS = 8
HTTP_CLI_TOKENS = 16
HTTP_CLI_ENCODES = 8
# slice 13, the attention archs, each built after the MoE path and freed
# before the next: (arch, its paths). Decode: 8 prompts of 8-64 tokens, 16
# greedy tokens each, 8 slots, max_len 128, int8 per-token pages of 16
# (gemma2-2b: of 128; deepseek-v2's latent pages are float). Cuts of depth
# (the float tree must fit beside PTQ on one 80 GB card, and the script in
# its time): :data:`ARCH_CUTS`
ARCH_PHASES = (("gemma2-2b", ("gemma2_decode_path",)),
               ("granite-20b", ("granite_decode_path",)),
               ("deepseek-coder-33b", ("deepseek_coder_decode_path",)),
               ("hubert-xlarge", ("hubert_encode_path",)),
               ("paligemma-3b", ("paligemma_path", "paligemma_decode_path")),
               ("deepseek-v2-236b", ("mla_decode_path",)),
               # slice 14, the recurrent archs
               ("recurrentgemma-9b", ("recurrentgemma_decode_path",)),
               ("xlstm-125m", ("xlstm_decode_path", "xlstm_encode_path")))
ARCH_CUTS = {"granite-20b": 4, "deepseek-coder-33b": 4,
             "deepseek-v2-236b": 2,
             # halved again beside arch_mesh_path (slice 17) to keep the
             # script at its time: granite and deepseek-coder from 8,
             # deepseek-v2 from 3 (layer 0 dense, layer 1 MoE), gemma2 from
             # 13 (26), recurrentgemma from 19 (38; 7 RG-LRU, 3 local
             # attention), paligemma from 9 (18) to 4, xlstm from 12,
             # hubert from 48
             "gemma2-2b": 7, "recurrentgemma-9b": 10, "paligemma-3b": 4,
             # and hubert from 24 to 12 beside http_mesh_path (slice 19)
             "xlstm-125m": 6, "hubert-xlarge": 12}
# xlstm_encode_path: one Runtime.encode of 4 x 512 seeded tokens, two mLSTM
# chunks of 256, so the chunk hand-off runs on the card
XLSTM_ENCODE = (4, 512)
# head dims over 256 (the attention kernels' wide kernels), which no
# registered config serves: quant_flash_attention and flash_attention at
# (B, Hq, Hkv, S), decode_attention at the decode paths' 8 slots of 512
# cached tokens over pages of 16, 2 KV heads in groups of 4
WIDE_HEAD_DIMS = (320, 512)
WIDE_ATTENTION = (2, 8, 2, 512)
WIDE_DECODE = {"kv_heads": 2, "group": 4, "tokens": 512, "page_size": 16}
ARCH_PROMPTS = 8
ARCH_MAX_TOKENS = 16
ARCH_PAGE_SIZE = {"gemma2_decode_path": 128}
HUBERT_SEQS = 16                 # frame sequences, T uniform in 16-128
HUBERT_BATCH = 8                 # sequences a Runtime.encode call
PALIGEMMA_ROWS = 8               # encode rows: 256 prefix embeddings +
PALIGEMMA_TOKENS = 32            # up to 32 tokens
# launches per tick (decode) or forward (encode) each plan implies: the
# golden plan's four layers cost 17 quant_linear, 2 addnorm_quant, 3
# dynamic_quant and 2 decode_attention (layers 1 and 2, float qkv over int8
# pages) a tick; gemma2's local layers (even) keep rings, so only its
# global layers 1 and 5 (of 7) run the decode kernel; hubert's span runs
# per four layers 14 / 2 / 2 and 2 quant_flash_attention; deepseek-v2's MLA
# body stays on the reference path: layer 0's FFN (3 + 1 addnorm) and each
# MoE layer's shared experts (3) and routed stacks (3 quant_expert_gemm).
# recurrentgemma's 7 RG-LRU layers run only their FFN's GEMMs (the mix is
# on the reference path, the residual boundary unfused) and its 3 local
# attention layers keep rings (no decode_attention); xlstm's blocks run no
# kernel at all, so both of its paths launch none
EXPECTED_ARCHS = {
    "gemma2_decode_path": {"quant_linear": 27, "addnorm_quant": 3,
                           "dynamic_quant": 6, "decode_attention": 2},
    "granite_decode_path": {"quant_linear": 17, "addnorm_quant": 2,
                            "dynamic_quant": 3, "decode_attention": 2},
    "deepseek_coder_decode_path": {"quant_linear": 17, "addnorm_quant": 2,
                                   "dynamic_quant": 3,
                                   "decode_attention": 2},
    "hubert_encode_path": {"quant_linear": 42, "addnorm_quant": 6,
                           "dynamic_quant": 6,
                           "quant_flash_attention": 6},
    "paligemma_path": {"quant_linear": 17, "addnorm_quant": 2,
                       "dynamic_quant": 3},
    "paligemma_decode_path": {"quant_linear": 17, "addnorm_quant": 2,
                              "dynamic_quant": 3, "decode_attention": 2},
    "mla_decode_path": {"quant_linear": 6, "addnorm_quant": 1,
                        "quant_expert_gemm": 3},
    "recurrentgemma_decode_path": {"quant_linear": 28, "addnorm_quant": 1,
                                   "dynamic_quant": 9},
    "xlstm_decode_path": {},
    "xlstm_encode_path": {},
}
# the times of each kernel's summary entry
TIMES = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
         "library_device_ms")

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "quant_linear": ("src/repro_torch/kernels/csrc/quant_linear.cu",
                     "src/repro/kernels/quant_linear.py:81"),
    "addnorm_quant": ("src/repro_torch/kernels/csrc/addnorm_quant.cu",
                      "src/repro/kernels/addnorm_quant.py:53"),
    "dynamic_quant": ("src/repro_torch/kernels/csrc/dynamic_quant.cu",
                      "src/repro/kernels/dynamic_quant.py:31"),
    "fused_embed": ("src/repro_torch/kernels/csrc/fused_embed.cu",
                    "src/repro/kernels/fused_embed.py:36"),
    "quant_flash_attention": (
        "src/repro_torch/kernels/csrc/quant_flash_attention.cu",
        "src/repro/kernels/flash_attention.py:131"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:134"),
    "quant_expert_gemm": (
        "src/repro_torch/kernels/csrc/quant_expert_gemm.cu",
        "src/repro/kernels/ops.py:82"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:186"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def measured(v):
    """``v`` with each NaN time (a profile window that recorded nothing)
    made None, through dicts and lists: the kernel line stays JSON."""
    if isinstance(v, dict):
        return {k: measured(x) for k, x in v.items()}
    if isinstance(v, list):
        return [measured(x) for x in v]
    return None if isinstance(v, float) and math.isnan(v) else v


def rel_linf(a, b) -> float:
    import torch
    a, b = a.to(torch.float32), b.to(torch.float32)
    return float((a - b).abs().max() / (a.abs().max() + 1e-9))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median CUDA-event time of a callable, with the 50 MB L2 flushed
    before each run (a forward streams ~85 MB of int8 weights, so the real
    caller finds them cold)."""

    def __init__(self, device, reps: int = 25, warmup: int = 3):
        import torch
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
        self.flush_kernel = None     # the flush's kernel name in a profile

    def ms(self, fn) -> float:
        import torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(self, fn, kernel=None, reps: int = 10) -> float:
        """Mean device time of one call of ``fn`` from ``torch.profiler``
        over ``reps`` calls, the L2 flushed before each (the flush is not
        counted): of ``kernel``'s CUDA functions (:func:`kernel_named`), or
        with ``kernel`` None of every kernel the call runs. The host's time
        in the wrapper, which CUDA events hold, is not in it. A call is the
        run of kernels, in time order, after its flush. In a long process
        the profiler hands some device events to a later window (a call's
        last kernels go missing, an earlier window's appear first, or a
        window records nothing), so each window ends in three more flushes,
        events before the first flush are dropped, and only the calls with
        the most common number of kernels count. NaN (not measured) when
        no window recorded the call."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        def window(step, n):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    step()
                for _ in range(3):
                    self.flush.zero_()
                torch.cuda.synchronize()
            return sorted((e for e in prof.events()
                           if e.device_type == DeviceType.CUDA),
                          key=lambda e: e.time_range.start)

        for _ in range(3):    # a window now and then records no event
            if self.flush_kernel is None:
                names = collections.Counter(
                    e.name for e in window(self.flush.zero_, 3))
                self.flush_kernel = (names.most_common(1)[0][0] if names
                                     else None)
        if self.flush_kernel is None:
            return float("nan")
        fn()
        torch.cuda.synchronize()

        def step():
            self.flush.zero_()
            fn()
        for _ in range(6):
            calls = []
            for e in window(step, reps):
                if e.name == self.flush_kernel:
                    calls.append([])
                elif calls and (kernel_named(kernel, e.name) if kernel
                                else True):
                    calls[-1].append(e.time_range.elapsed_us())
            counts = collections.Counter(len(c) for c in calls if c)
            if counts:
                break
        else:
            return float("nan")
        n = max(counts, key=lambda k: (counts[k], k))
        return statistics.mean(sum(c) for c in calls if len(c) == n) / 1e3


def bound(nbytes: float, int8_ops: float = 0.0, f32_ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int8_ops / INT8_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return t_bytes, t_ops


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    info = build.build()
    emit({"phase": "build", "seconds": info.seconds,
          "compiled": info.compiled,
          "library": str(info.library.relative_to(ROOT)),
          "nvcc_flags": list(build.NVCC_FLAGS), "ptxas": list(info.ptxas)})




def flash_bound(B, Hq, Hkv, S, d, kw, dtype):
    """(bytes bound ms, operations bound ms, valid pairs, run pairs, peak):
    q, k, v read once and out written once; two d-long dot products (4 d
    operations) for every (query, key) pair the function needs, the keys
    each row may attend under its mask (S (S + 1) / 2 causal, the sum of
    min(i + 1, window) with a causal window), at the least time the card
    could take for them at float32 accuracy: bfloat16 / float16 inputs at
    the 16-bit tensor cores' 989 TFLOP/s (their products are exact in
    float32), float32 at the better of the CUDA cores' 67 TFLOP/s and
    3xTF32 on the tensor cores (495 / 3 TFLOP/s). The masked entries of
    the logical (512, 512) blocks the kernel runs (``run_pairs``) add
    exactly 0 and are not counted."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    causal, window = kw.get("causal", False), kw.get("window")
    i = np.arange(S, dtype=np.int64)
    hi = i + 1 if causal else np.full(S, S, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    pairs = B * Hq * int(np.clip(hi - lo, 0, None).sum())
    bq = bk = min(512, S)
    rows = sum(r1 - r0 for r0, r1 in (
        FA.run_rows(S, bq, k_lo, bk, causal, window)
        for k_lo in range(0, S, bk)))
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * d * (2 * B * Hq * S + 2 * B * Hkv * S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == torch.float32:
        rate = max(F32_OPS_PER_S, TF32_OPS_PER_S / 3)
        peak = (f"{rate / 1e12:g} TFLOP/s: the better of float32 on the "
                f"CUDA cores ({F32_OPS_PER_S / 1e12:g}) and 3xTF32 on the "
                f"tensor cores ({TF32_OPS_PER_S / 1e12:g} / 3)")
    else:
        rate = BF16_OPS_PER_S
        peak = (f"{rate / 1e12:g} TFLOP/s: {dtype} on the tensor cores, "
                f"float32 sums")
    t_ops = 4.0 * d * pairs / rate * 1e3
    return (t_bytes, t_ops, pairs, B * Hq * rows * bk,
            peak + f"; {HBM_BYTES_PER_S / 1e12:g} TB/s (H100 SXM data sheet)")


def phase_flash(device):
    """The long-context path of ``ops.flash_attention``: each case called
    once with the launch counters zeroed just before and read just after,
    then checked against the plain version and timed (few reps at 32k)
    beside its bound and the library's SDPA."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch.shapes import SHAPES
    timer = Timer(device, reps=3, warmup=1)
    records = []
    for name, (B, Hq, Hkv, S, d), kw, dt, origin in FLASH_CASES:
        if isinstance(S, str):
            S = SHAPES[S].seq_len
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=device).manual_seed(S + Hq + d)
        q = torch.randn((B, Hq, S, d), generator=gen, device=device).to(dtype)
        k = torch.randn((B, Hkv, S, d), generator=gen,
                        device=device).to(dtype)
        v = torch.randn((B, Hkv, S, d), generator=gen,
                        device=device).to(dtype)
        kernels.reset_launches()
        out = ops.flash_attention(q, k, v, **kw)         # the path's call
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        # the plain version in float32 on the same inputs (exact for 16-bit
        # ones): the kernel's result before its cast, within 2e-4 of it
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        err = (out.float() - want).abs()
        ulp = {"float32": 0.0, "bfloat16": 2.0 ** -8}[dt]
        excess = float((err - FLASH_TOL - (FLASH_TOL + ulp) * want.abs())
                       .max())
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp(min=1e-6)).max())
        rel = float(err.max() / (want.abs().max() + 1e-9))
        finite = bool(torch.isfinite(out).all())
        del want, err
        t_bytes, t_ops, pairs, run_pairs, peak = flash_bound(
            B, Hq, Hkv, S, d, kw, dtype)
        rec = {"phase": "kernel", "kernel": "flash_attention", "case": name,
               "origin": origin, "B": B, "Hq": Hq, "Hkv": Hkv, "S": S,
               "head_dim": d, "dtype": dt, "mask": kw,
               "launches": launches["flash_attention"],
               "other_launches": sum(launches.values())
               - launches["flash_attention"],
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "rel_linf": rel, "finite": finite,
               "tolerance": (f"|out - plain| <= {FLASH_TOL:g} + "
                             f"({FLASH_TOL:g} + {ulp:g}) |plain|, plain in "
                             f"float32 on the same inputs"),
               "valid_pairs": pairs, "run_pairs": run_pairs,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_peak": peak}
        rec["ms"] = timer.ms(lambda: ops.flash_attention(q, k, v, **kw))
        rec["device_ms"] = timer.device_ms(
            lambda: ops.flash_attention(q, k, v, **kw), "flash_attention",
            reps=3)
        rec["plain_ms"] = timer.ms(
            lambda: FA.flash_attention_plain(q, k, v, **kw))
        # SDPA on K and V expanded to Hq heads outside the timing; its
        # causal mask is top-left aligned, like the kernel's. A window
        # takes an explicit additive (S, S) mask (4.3 GB at 32k), made
        # outside the timing, and the memory-efficient backend, the one
        # that takes a float32 mask without a (B, H, S, S) score tensor
        g = Hq // Hkv
        ke, ve = (t.repeat_interleave(g, dim=1) for t in (k, v))
        if "window" in kw:
            from torch.nn.attention import SDPBackend, sdpa_kernel
            idx = torch.arange(S, device=device)
            keep = ((idx[None] <= idx[:, None])
                    & (idx[None] > idx[:, None] - kw["window"]))
            mask = torch.zeros((S, S), dtype=dtype, device=device)
            mask.masked_fill_(~keep, float("-inf"))
            del keep

            def library():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return Fn.scaled_dot_product_attention(
                        q, ke, ve, attn_mask=mask[None, None],
                        scale=d ** -0.5)
            rec["library"] = ("F.scaled_dot_product_attention, K and V "
                              "expanded to the query heads, an additive "
                              "causal-window mask, memory-efficient backend")
        else:
            mask = None

            def library():
                return Fn.scaled_dot_product_attention(
                    q, ke, ve, is_causal=kw.get("causal", False),
                    scale=d ** -0.5)
            rec["library"] = ("F.scaled_dot_product_attention, K and V "
                              "expanded to the query heads")
        lib_err = float((library().float() - out.float()).abs().max())
        rec["library_max_abs_diff"] = lib_err
        rec["library_ms"] = timer.ms(library)
        rec["library_device_ms"] = timer.device_ms(library, reps=3)
        del ke, ve, mask
        torch.cuda.synchronize()
        emit(rec)
        records.append(rec)
        del q, k, v, out
        torch.cuda.empty_cache()
        if excess > 0 or not finite:
            fail(f"flash_attention ({name}) disagrees with its plain "
                 f"version: {rec}")
        if rec["launches"] != 1 or rec["other_launches"]:
            fail(f"flash_attention ({name}): launches {launches}, not one "
                 f"float flash_attention launch")
    return records


def setup_model(device):
    """Full-width BERT-base with seeded float weights, the tiled golden
    plan and the calibration batches: what both served paths start from."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T

    cfg = get_config("bert-base")
    golden = PrecisionPlan.load(str(GOLDEN_PLAN))
    plan = PrecisionPlan(golden.layers * TILE, golden.float_dtype)
    if plan.num_layers != cfg.num_layers:
        fail(f"tiled plan has {plan.num_layers} layers, bert-base "
             f"{cfg.num_layers}")
    t0 = time.perf_counter()
    float_policy = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, float_policy, seed=0, head=("cls", 15),
                           device=device)
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=4,
                                            seq_len=128, seed=0)
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 129, N_REQUESTS)
    requests = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                for n in lengths]
    return {"cfg": cfg, "plan": plan, "params": params, "batches": batches,
            "float_plan": T.build_plan(cfg, float_policy),
            "requests": requests, "tokens": int(lengths.sum()),
            "init_s": time.perf_counter() - t0}


def serve(engine, requests):
    """Submit every request, run the engine dry; (done by uid, wall s)."""
    from repro_torch.serve import EncoderRequest
    for i, toks in enumerate(requests):
        engine.submit(EncoderRequest(uid=i, tokens=toks))
    t = time.perf_counter()
    done = sorted(engine.run(), key=lambda r: r.uid)
    return done, time.perf_counter() - t


class SubCounts:
    """Counts, over one served run, the fused backend's calls of the
    kernels' variants (on CUDA tensors every call launches): spies around
    the wrappers the backend module calls, removed on exit. When
    ``capture`` is set, the next ``decode_attention`` call's operands are
    cloned into ``decode_args`` (the decode phases set it at each new
    longest tick). The first ``quant_expert_gemm`` call of each shape and
    scale mode leaves its routed buffer in ``expert_args``."""

    NAMES = ("quant_flash_attention", "quant_linear", "addnorm_quant",
             "paged_decode_attention", "quant_expert_gemm")

    def __init__(self):
        self.capture = False
        self.decode_args = None
        self.expert_args = {}

    def __enter__(self):
        import torch
        from repro_torch.kernels import backend as B
        self.B, self.counts = B, collections.Counter()
        self.orig = {n: getattr(B, n) for n in self.NAMES}
        orig, c = self.orig, self.counts

        def flash(*a, **kw):
            c["quant_flash_attention with o_scale"] += \
                kw.get("o_scale") is not None
            return orig["quant_flash_attention"](*a, **kw)

        def linear(*a, **kw):
            c["quant_linear with out_scale"] += kw.get("out_scale") is not None
            return orig["quant_linear"](*a, **kw)

        def addnorm(x, *a, **kw):
            c["addnorm_quant with an int8 delta"] += x.dtype == torch.int8
            return orig["addnorm_quant"](x, *a, **kw)

        def decode(**kw):
            c["decode_attention with p_scale"] += kw.get("p_scale") is not None
            if self.capture:
                self.capture = False
                self.decode_args = {k: v.clone() if torch.is_tensor(v)
                                    else v for k, v in kw.items()}
            return orig["paged_decode_attention"](**kw)

        def experts(xe, w_q, w_scale, xs):
            key = (w_q.shape[1], w_q.shape[2], xs is None)
            if key not in self.expert_args:
                self.expert_args[key] = xe.clone()
            return orig["quant_expert_gemm"](xe, w_q, w_scale, xs)

        B.quant_flash_attention, B.quant_linear, B.addnorm_quant = \
            flash, linear, addnorm
        B.paged_decode_attention, B.quant_expert_gemm = decode, experts
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.B, n, f)


def phase_serve(name, model, plan, device):
    """Calibrate and quantize ``model`` under ``plan``, serve the requests
    on the fused backend (launch counters zeroed just before the counted
    run, read just after) and on the reference backend, and check them."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.quant import ptq
    from repro_torch.serve import EncoderServeEngine

    cfg = model["cfg"]
    t0 = time.perf_counter()
    stats = ptq.capture_stats(model["params"], model["batches"], cfg,
                              model["float_plan"], precision=plan)
    qparams, qplan = ptq.apply_plan(model["params"], cfg, plan, stats,
                                    float_plan=model["float_plan"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    requests = model["requests"]
    fused = EncoderServeEngine(cfg, qparams, qplan, backend="fused",
                               max_batch=8, device=device)
    serve(fused, requests)                         # warm-up, not counted
    calls_before = fused.runtime.stats["calls"]
    with SubCounts() as sub:
        kernels.reset_launches()
        done, wall = serve(fused, requests)
        launches = kernels.launch_counts()
    forwards = fused.runtime.stats["calls"] - calls_before

    reference = EncoderServeEngine(cfg, qparams, qplan, backend="reference",
                                   max_batch=8, device=device)
    ref_done, ref_wall = serve(reference, requests)

    logits = torch.from_numpy(np.stack([r.logits for r in done]))
    ref_logits = torch.from_numpy(np.stack([r.logits for r in ref_done]))
    if logits.shape != (N_REQUESTS, 15) or not torch.isfinite(logits).all():
        fail(f"{name}: fused logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    err = rel_linf(ref_logits, logits)
    preds = [int(r.prediction) for r in done]
    ref_preds = [int(r.prediction) for r in ref_done]
    cases = kernel_cases(cfg, plan)
    per_fwd, sub_fwd = collections.Counter(), collections.Counter()
    for key, case in cases.items():
        per_fwd[key[0]] += case["count"]
        if case["sub"]:
            sub_fwd[case["sub"]] += case["count"]
    want = {k: per_fwd[k] * forwards for k in launches}
    tokens = model["tokens"]
    rec = {"phase": name, "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "plan": plan.describe(),
           "plan_fingerprint": plan.fingerprint(), "setup_s": setup_s,
           "requests": N_REQUESTS, "tokens": tokens, "forwards": forwards,
           "buckets": fused.runtime.stats["buckets"],
           "wall_s": wall, "requests_per_s": N_REQUESTS / wall,
           "tokens_per_s": tokens / wall, "reference_wall_s": ref_wall,
           "launches": launches, "expected_launches": want,
           "launches_per_forward": dict(per_fwd),
           "sub_counts": dict(sub.counts),
           "sub_counts_per_forward": dict(sub_fwd),
           "fused_vs_reference_rel_linf": err,
           "predictions_equal": preds == ref_preds}
    emit(rec)
    if err > REL_LINF_BUDGET:
        fail(f"{name}: fused vs reference rel-Linf {err} > "
             f"{REL_LINF_BUDGET}")
    if preds != ref_preds:
        fail(f"{name}: fused and reference predictions differ")
    if dict(per_fwd) != EXPECTED[name]:
        fail(f"{name}: the plan implies {dict(per_fwd)} launches per "
             f"forward, not {EXPECTED[name]}")
    if launches != want or any(launches[k] == 0 for k in EXPECTED[name]):
        fail(f"{name}: launch counts {launches} != plan-implied {want}")
    if name == "span_path":
        if plan.fingerprint() != SPAN_FINGERPRINT:
            fail(f"span plan fingerprint {plan.fingerprint()} is not the "
                 f"JAX package's {SPAN_FINGERPRINT}")
        if dict(sub_fwd) != EXPECTED_SUB or dict(sub.counts) != {
                k: n * forwards for k, n in EXPECTED_SUB.items()}:
            fail(f"span sub-counts {dict(sub.counts)} over {forwards} "
                 f"forwards; the plan implies {dict(sub_fwd)} per forward, "
                 f"expected {EXPECTED_SUB}")
    buckets = set(map(tuple, fused.runtime.stats["buckets"]))
    return {"name": name, "cfg": cfg, "qparams": qparams, "qplan": qplan,
            "fused": fused, "stats": stats, "logits": logits, "preds": preds,
            "requests": requests,
            "launches": launches, "per_fwd": per_fwd, "cases": cases,
            "buckets": sorted(buckets | {PROFILE_BUCKET}),
            "timed_bucket": PROFILE_BUCKET, "unit": "forward"}


def synthetic_texts(seed: int = 0):
    """A seeded synthetic corpus of 400 lowercase words (2-9 letters) for
    the tokenizer, and the 32 request texts: 6-126 of those words each, so
    8-128 tokens with [CLS] and [SEP]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, int(n)))
                    for n in rng.integers(2, 10, 400)})
    corpus = [" ".join(rng.choice(words, int(n)))
              for n in rng.integers(4, 40, 2000)]
    texts = [" ".join(rng.choice(words, int(n)))
             for n in rng.integers(6, 127, PIPELINE_TEXTS)]
    return corpus, texts


def phase_pipeline(model, main, device):
    """The paper's main path through ``toolkit.Pipeline``: the tiled golden
    plan's PTQ output (``main_path``'s) bound by ``with_policy`` into
    pipelines on the fused and the reference backends, raw texts through
    ``predict_texts`` in batches of 8 (counters zeroed just before the
    fused run, read just after), checked against each other and against
    ``EncoderServeEngine`` on the same token ids."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.data.tokenizer import WordPieceTokenizer
    from repro_torch.serve import EncoderRequest, EncoderServeEngine
    from repro_torch.serve.metrics import engine_counters
    from repro_torch.toolkit import Pipeline

    cfg, plan = model["cfg"], model["plan"]
    qparams, qplan = main["qparams"], main["qplan"]
    t0 = time.perf_counter()
    corpus, texts = synthetic_texts(0)
    tok = WordPieceTokenizer.train(corpus,
                                   vocab_size=min(8192, cfg.vocab_size))
    pipes = {}
    for name in ("fused", "reference"):
        base = Pipeline.build(cfg, "tnews", seq_len=128, float_dtype="float32",
                              tokenizer=tok, backend=name, device=device)
        pipes[name] = base.with_policy(qparams, qplan, plan)
    setup_s = time.perf_counter() - t0
    chunks = [texts[i:i + PIPELINE_BATCH]
              for i in range(0, len(texts), PIPELINE_BATCH)]
    fused = pipes["fused"]
    fused.predict_texts(chunks[0])                    # warm-up, not counted
    calls_before = fused.runtime.stats["calls"]
    kernels.reset_launches()
    t = time.perf_counter()
    preds = np.concatenate([fused.predict_texts(c) for c in chunks])
    wall = time.perf_counter() - t
    launches = kernels.launch_counts()
    forwards = fused.runtime.stats["calls"] - calls_before
    batches = [fused.tokenizer(c) for c in chunks]
    logits = np.concatenate([fused.predict_logits(b) for b in batches])
    ref_logits = np.concatenate([pipes["reference"].predict_logits(b)
                                 for b in batches])
    ref_preds = np.concatenate([pipes["reference"].predict_texts(c)
                                for c in chunks])
    ids = np.concatenate([b["tokens"] for b in batches])
    lengths = [len(tok.encode(x)[:128]) for x in texts]
    engine = EncoderServeEngine(cfg, qparams, qplan, backend="fused",
                                max_batch=PIPELINE_BATCH, max_len=128,
                                device=device)
    for i, row in enumerate(ids):
        engine.submit(EncoderRequest(uid=i, tokens=row.tolist()))
    done = sorted(engine.run(), key=lambda r: r.uid)
    eng_logits = np.stack([r.logits for r in done])
    err = rel_linf(torch.from_numpy(ref_logits), torch.from_numpy(logits))
    want = {k: v * forwards for k, v in EXPECTED["main_path"].items()}
    rec = {"phase": "pipeline_path", "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "plan": plan.describe(), "plan_fingerprint": plan.fingerprint(),
           "describe": fused.describe(), "setup_s": setup_s,
           "tokenizer_vocab": tok.vocab_size, "texts": len(texts),
           "text_tokens_min_max": [min(lengths), max(lengths)],
           "batch": PIPELINE_BATCH, "forwards": forwards,
           "buckets": fused.runtime.stats["buckets"], "wall_s": wall,
           "requests_per_s": len(texts) / wall, "launches": launches,
           "expected_launches": want,
           "fused_vs_reference_rel_linf": err,
           "predictions_equal": bool((preds == ref_preds).all()),
           "logits_equal_encoder_engine": bool(np.array_equal(logits,
                                                              eng_logits)),
           "engine_counters": engine_counters(engine)}
    emit(rec)
    if logits.shape != (len(texts), 15) or not np.isfinite(logits).all():
        fail(f"pipeline_path: logits of shape {logits.shape}, finite "
             f"{bool(np.isfinite(logits).all())}")
    if not rec["predictions_equal"] or err > REL_LINF_BUDGET:
        fail(f"pipeline_path: fused vs reference predictions equal "
             f"{rec['predictions_equal']}, rel-Linf {err}")
    if not rec["logits_equal_encoder_engine"]:
        fail("pipeline_path: the pipeline's logits differ from "
             "EncoderServeEngine's on the same token ids")
    if forwards != len(chunks) or {k: v for k, v in launches.items()
                                   if v} != want:
        fail(f"pipeline_path: {forwards} forwards, launches {launches} "
             f"(expected {want})")
    return rec


def _device_busy(call, n: int = 5):
    """``torch.profiler`` over ``n`` calls after one untimed: device-busy ms
    and device kernels a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / n,
            len(events) / n)


def _bundle_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_autotune(model, device):
    """The paper's workflow through the ``SAMP`` facade: ``from_config`` on
    full-width BERT-base (float32, ``tnews``, 128 positions, the fused
    backend), ``main_path``'s seed-0 weights bound to its pipeline, then
    ``autotune`` over the prefix grid at stride 4 with the int8-dataflow
    variants (10 candidates), each candidate's accuracy from 2 dev batches
    of 64 and its latency from ``WallclockBackend`` (warmup 2, median of 5
    forwards at the facade's (32, 128)), saved as a bundle; then the tiled
    golden plan through ``apply`` and ``save``. Each bundle is linted,
    reloaded with ``SAMP.load`` on both backends and served; the chosen
    plan's forward is counted (counters zeroed just before, read just
    after)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.precision import LayerMode
    from repro_torch.core.samp import _grid_candidates
    from repro_torch.data.pipeline import get_batch
    from repro_torch.models import transformer as T
    from repro_torch.toolkit import SAMP, plan_lint
    from repro_torch.toolkit.latency import RooflineBackend, WallclockBackend

    phase_t0 = time.perf_counter()
    cfg = model["cfg"]
    B, S = AUTOTUNE_LATENCY
    n_eval, eval_bs = AUTOTUNE_EVAL
    wall = WallclockBackend(reps=5, warmup=2)
    samp = SAMP.from_config(cfg, task="tnews", seq_len=S,
                            float_dtype="float32", latency=wall,
                            latency_batch=B, backend="fused", device=device)
    samp.pipeline.params = model["params"]
    modes = (LayerMode.FULLY_QUANT, LayerMode.QUANT_FFN_ONLY)
    grid = [(n, k, p.fingerprint()) for n, k, p in _grid_candidates(
        samp.engine, AUTOTUNE_STRIDE, modes, "minmax", dataflow=True)]
    eval_batches = [get_batch(samp.task, i, eval_bs, "dev")
                    for i in range(n_eval)]
    tmp = Path(tempfile.mkdtemp(prefix="samp_autotune_"))
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = samp.autotune(strategy="prefix_grid", stride=AUTOTUNE_STRIDE,
                               dataflow=True, eval_batches=n_eval,
                               eval_batch_size=eval_bs,
                               save_to=str(tmp / "autotuned"))
        torch.cuda.synchronize()
        autotune_s = time.perf_counter() - t0
        autotune_launches = kernels.launch_counts()
        points = [(p.mode_name, p.k, p.plan.fingerprint())
                  for p in report.points]
        # the chosen plan's forwards on the eval batches, counted
        chosen = report.plan
        per_fwd = collections.Counter()
        cases = kernel_cases(cfg, chosen)
        for key, case in cases.items():
            per_fwd[key[0]] += case["count"]
        kernels.reset_launches()
        tuned_logits = [samp.current.predict_logits(b) for b in eval_batches]
        launches = kernels.launch_counts()
        counted = {k: v for k, v in launches.items() if v}
        want = {k: v * n_eval for k, v in per_fwd.items()}
        qparams, qplan = samp.current.params, samp.current.plan

        roof = RooflineBackend().bind(cfg, batch=B, seq=S)
        base, r0 = report.points[0], roof(None, None, report.points[0].plan)
        sweep = []
        for p in report.points:
            times = wall.samples[p.plan.fingerprint()]
            rf = roof(None, None, p.plan)
            sweep.append({
                "mode": p.mode_name, "k": p.k,
                "plan": p.plan.fingerprint()[:12], "accuracy": p.accuracy,
                "wallclock_ms": p.latency * 1e3,
                "wallclock_ms_min_max": [times[0] * 1e3, times[-1] * 1e3],
                "roofline_ms": rf * 1e3,
                "wallclock_speedup": base.latency / p.latency,
                "roofline_speedup": r0 / rf})

        # where the latency batch's time goes: the device-busy ms of the
        # float forward and of the fastest candidate's, on the inputs the
        # wallclock backend timed (seed-0 tokens, zero segments)
        gen = torch.Generator(device=device).manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=device, dtype=torch.int32)
        inputs = {"tokens": tokens, "segments": torch.zeros_like(tokens)}
        fastest = min(report.points[1:], key=lambda p: p.latency)
        latency_profile = {}
        for p in (base, fastest):
            p_params, p_plan = ((model["params"], samp.engine.float_plan)
                                if p is base else samp.engine.apply(
                                    model["params"], samp.stats, p.plan))

            def forward(p_params=p_params, p_plan=p_plan):
                with torch.inference_mode():
                    T.forward(p_params, inputs, cfg, p_plan,
                              return_hidden=True,
                              backend=samp.pipeline.backend)
            busy, launched = _device_busy(forward)
            latency_profile[f"{p.mode_name} {p.k}"] = {
                "wallclock_ms": p.latency * 1e3, "device_busy_ms": busy,
                "device_kernels": launched,
                "device_idle_share": max(0.0, 1.0 - busy / (p.latency * 1e3))}

        bundles = {}
        for name in ("autotuned", "golden"):
            path = tmp / name
            if name == "golden":
                samp.apply(model["plan"])
                samp.save(str(path))
            plan = samp.current.precision
            mine = (tuned_logits if name == "autotuned" else
                    [samp.current.predict_logits(b) for b in eval_batches])
            with open(path / "artifact.json") as f:
                saved_fp = json.load(f)["plan_fingerprint"]
            plan.save(str(tmp / f"{name}_plan.json"))
            lint_rc = plan_lint.main([str(tmp / f"{name}_plan.json"),
                                      "--arch", "bert-base"])
            t0 = time.perf_counter()
            loaded = SAMP.load(str(path), backend="fused", device=device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            kernels.reset_launches()
            fused = [loaded.current.predict_logits(b) for b in eval_batches]
            bundle_launches = {k: v for k, v in
                               kernels.launch_counts().items() if v}
            ref = SAMP.load(str(path), backend="reference", device=device)
            refl = [ref.current.predict_logits(b) for b in eval_batches]
            # predict one request a batch, with the engine's all-zero
            # segments; served the same way, the buckets are the same. In
            # batches of 8 the buckets differ, and so may the float32
            # GEMMs' rounding and a near-tied argmax (ROADMAP §3,
            # test_encoder_micro_batch_invariance): counted, not gated
            predicted = [int(loaded.predict(
                {"tokens": np.asarray([toks], np.int32),
                 "segments": np.zeros((1, len(toks)), np.int32)})[0])
                for toks in model["requests"]]
            served = [int(r.prediction) for r in serve(
                loaded.serve(batch_slots=1, max_len=S),
                model["requests"])[0]]
            engine = loaded.serve(batch_slots=8, max_len=S)
            batched = [int(r.prediction)
                       for r in serve(engine, model["requests"])[0]]
            got, ref_all = np.concatenate(fused), np.concatenate(refl)
            bundles[name] = {
                "plan": plan.describe(), "plan_fingerprint":
                plan.fingerprint(), "saved_fingerprint": saved_fp,
                "lint_rc": lint_rc, "bytes": _bundle_bytes(path),
                "load_s": load_s,
                "loaded_vs_saved_rel_linf": rel_linf(
                    torch.from_numpy(np.concatenate(mine)),
                    torch.from_numpy(got)),
                "reference_vs_fused_rel_linf": rel_linf(
                    torch.from_numpy(ref_all), torch.from_numpy(got)),
                "reference_predictions_equal": bool(
                    (ref_all.argmax(-1) == got.argmax(-1)).all()),
                "served_equal_predict": served == predicted,
                "batched_predictions_differing": sum(
                    a != b for a, b in zip(batched, predicted)),
                "launches": bundle_launches}
            if name == "autotuned":
                served_engine = engine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "autotune_path", "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "strategy": report.strategy, "stride": AUTOTUNE_STRIDE,
           "eval": [n_eval, eval_bs], "latency_batch": [B, S],
           "wallclock": {"reps": wall.reps, "warmup": wall.warmup},
           "candidates": [[n, k, fp[:12]] for n, k, fp in points],
           "sweep": sweep, "chosen": {
               "mode": report.chosen.mode_name, "k": report.chosen.point.k,
               "plan": chosen.describe(),
               "plan_fingerprint": chosen.fingerprint(),
               "accuracy": report.accuracy},
           "recommendations": [[r.mode_name, r.point.k]
                               for r in report.recommendations],
           "latency_profile": latency_profile,
           "autotune_s": autotune_s, "autotune_launches": autotune_launches,
           "chosen_forward_launches": counted,
           "chosen_expected_launches": want,
           "bundles": bundles, "phase_s": time.perf_counter() - phase_t0}
    emit(rec)
    if len(points) != 10 or points != grid:
        fail(f"autotune_path: the report's candidates {points} are not the "
             f"full-width grid {grid}")
    if any(v["device_busy_ms"] <= 0.0 for v in latency_profile.values()):
        fail("autotune_path: the profiler recorded no device time at the "
             "latency batch")
    if counted != want or not per_fwd.get("fused_embed"):
        fail(f"autotune_path: the chosen plan's forwards launched "
             f"{counted}, its layers name {want}")
    for name, b in bundles.items():
        if b["saved_fingerprint"] != b["plan_fingerprint"]:
            fail(f"autotune_path: {name} bundle's artifact.json says "
                 f"{b['saved_fingerprint']}, the plan is "
                 f"{b['plan_fingerprint']}")
        if b["lint_rc"] != 0:
            fail(f"autotune_path: plan_lint refused the {name} plan")
        if b["loaded_vs_saved_rel_linf"] != 0.0:
            fail(f"autotune_path: the loaded {name} bundle's logits differ "
                 f"from the saved pipeline's by "
                 f"{b['loaded_vs_saved_rel_linf']}")
        if b["reference_vs_fused_rel_linf"] > REL_LINF_BUDGET \
                or not b["reference_predictions_equal"]:
            fail(f"autotune_path: the {name} bundle on the reference "
                 f"backend: rel-Linf {b['reference_vs_fused_rel_linf']}, "
                 f"predictions equal {b['reference_predictions_equal']}")
        if not b["served_equal_predict"]:
            fail(f"autotune_path: serving the {name} bundle disagrees with "
                 f"its predict")
    if chosen.fingerprint() != bundles["autotuned"]["plan_fingerprint"]:
        fail("autotune_path: the autotuned bundle is not the chosen plan")
    if not bundles["golden"]["launches"].get("dynamic_quant"):
        fail(f"autotune_path: the golden bundle's forwards launched "
             f"{bundles['golden']['launches']}, no dynamic_quant")
    return {"name": "autotune_path", "cfg": cfg, "qparams": qparams,
            "qplan": qplan, "fused": served_engine,
            "launches": launches, "per_fwd": per_fwd, "cases": cases,
            "buckets": sorted(set(map(tuple, served_engine.runtime.stats[
                "buckets"])) | {PROFILE_BUCKET, AUTOTUNE_LATENCY}),
            "timed_bucket": PROFILE_BUCKET, "unit": "forward"}


def _train_losses(lines):
    """(losses, step seconds) from the Trainer's ``[trainer] step i
    loss=... dt=...s`` lines, in step order."""
    import re
    pat = re.compile(r"\[trainer\] step (\d+) loss=(\S+) gnorm=\S+ "
                     r"dt=(\S+)s")
    rows = sorted((int(m.group(1)), float(m.group(2)), float(m.group(3)))
                  for m in map(pat.match, lines) if m)
    return [r[1] for r in rows], [r[2] for r in rows]


def _max_param_diff(a, b) -> float:
    from repro_torch.interop import flatten_names
    fb = dict(flatten_names(b))
    return max(float((x - fb[n]).abs().max()) for n, x in flatten_names(a))


def train_profile(samp, device, card, step_ms, n: int = 3):
    """``torch.profiler`` over ``n`` more steps of the fine-tune's step
    function on its trained params (the update is functional: they stay
    as they are): device-busy ms a step, idle share against the median
    step, device kernels a step and the top kernels by device ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import get_batch
    from repro_torch.train import AdamW, TrainConfig, Trainer

    pipe = samp.pipeline
    tr = Trainer(samp.cfg, samp.engine.float_precision,
                 optimizer=AdamW(lr=TRAIN_LR),
                 tcfg=TrainConfig(remat=False, compute_dtype="float32"),
                 loss_fn=pipe.loss_fn(), device=device)
    opt = tr.optimizer.init(pipe.params)
    step = tr.make_step()
    batch = get_batch(samp.task, 0, TRAIN_BATCH)

    def call():
        float(step(pipe.params, opt, None, batch)[3]["loss"])
    call()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    kernels_run = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
            kernels_run += 1
    busy = sum(by_name.values())
    if busy <= 0.0:
        fail("train_path: the profiler recorded no device time")
    return {"phase": "train_path", "part": "profile", "card": card,
            "steps": n, "device_busy_ms_per_step": busy,
            "device_idle_share": max(0.0, 1.0 - busy / step_ms),
            "device_kernels_per_step": kernels_run / n,
            "top_device_kernels": [
                {"kernel": k[:100], "ms_per_step": v,
                 "share_of_busy": v / busy}
                for k, v in by_name.most_common(6)]}


def train_resume(cfg, device, card):
    """``Trainer.fit`` on full-width BERT-base for ``TRAIN_RESUME[0]``
    steps with checkpoints, a second uninterrupted run (the card's
    run-to-run spread: CUDA's embedding backward sums with atomics), and a
    run cut at ``TRAIN_RESUME[1]`` then resumed by a fresh Trainer; the
    resumed params must be within the spread (+ 1e-6) of the first run's.
    Also times one checkpoint save and one restore."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.data.pipeline import get_batch, make_task
    from repro_torch.train import AdamW, TrainConfig, Trainer, TrainState

    steps, cut = TRAIN_RESUME
    task = make_task("tnews", vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ)
    policy = PrecisionPlan.full_float(cfg.num_layers, "float32")

    def run(n, ckpt, log):
        tcfg = TrainConfig(steps=n, log_every=1000, checkpoint_every=cut,
                           checkpoint_dir=ckpt, remat=False,
                           compute_dtype="float32")
        tr = Trainer(cfg, policy, optimizer=AdamW(lr=TRAIN_LR), tcfg=tcfg,
                     head=("cls", task.n_classes), device=device)
        state = tr.fit(tr.init_state(0), lambda i: get_batch(
            task, i, TRAIN_BATCH), log=log)
        return tr, state

    tmp = Path(tempfile.mkdtemp(prefix="samp_train_"))
    try:
        logs = []
        tr, full = run(steps, str(tmp / "a"), logs.append)
        _, again = run(steps, None, logs.append)
        run(cut, str(tmp / "b"), logs.append)
        resumed_logs = []
        _, resumed = run(steps, str(tmp / "b"), resumed_logs.append)
        spread = _max_param_diff(full.params, again.params)
        diff = _max_param_diff(full.params, resumed.params)
        torch.cuda.synchronize()
        t = time.perf_counter()
        store.save(str(tmp / "c"), steps, full.as_tree(tr.plan))
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back = TrainState.from_tree(
            store.restore(str(tmp / "c"), steps, full.as_tree(tr.plan)),
            tr.plan, device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        ckpt_bytes = _bundle_bytes(tmp / "c")
        exact = _max_param_diff(full.params, back.params) == 0.0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "train_path", "part": "resume", "card": card,
           "steps": steps, "cut_at": cut,
           "resumed_log": [m for m in resumed_logs if "resumed" in m],
           "resumed_step_counter": int(resumed.opt_state.step),
           "max_param_diff_resumed": diff,
           "max_param_diff_two_full_runs": spread,
           "checkpoint_bytes": ckpt_bytes,
           "checkpoint_save_s": save_s, "checkpoint_load_s": load_s,
           "restore_bit_exact": exact}
    emit(rec)
    if rec["resumed_log"] != [f"[trainer] resumed from step {cut}"] or \
            rec["resumed_step_counter"] != steps:
        fail(f"train_path: the resumed run logged {resumed_logs} and ended "
             f"at step {rec['resumed_step_counter']}")
    if diff > spread + 1e-6 or not exact:
        fail(f"train_path: resumed params differ by {diff} from an "
             f"uninterrupted run (two uninterrupted runs: {spread}); "
             f"restore bit-exact {exact}")
    return rec


def _cli_runs(args, counts, prefix, clis):
    """``python -m repro_torch.launch.train`` with ``args``, once for each
    step count in ``counts`` on one checkpoint directory (each run after
    the first must resume): a record a run. Each run is a process group of
    its own in ``clis["procs"]`` (its mesh ranks are its children), so
    :func:`stop_train_clis` can end it."""
    import os
    import shutil
    import signal
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = Path(tempfile.mkdtemp(prefix=prefix))
    runs = []
    try:
        for n in counts:
            t = time.perf_counter()
            with clis["lock"]:
                if clis["stop"].is_set():
                    break
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.train",
                     *args, "--steps", str(n), "--ckpt", str(tmp / "run")],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, cwd=ROOT, env=env, start_new_session=True)
                clis["procs"].append(proc)
            try:
                stdout, stderr = proc.communicate(timeout=TRAIN_CLI_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise
            lines = stdout.splitlines()
            losses, _ = _train_losses(lines)
            runs.append({"steps": n, "exit_code": proc.returncode,
                         "s": time.perf_counter() - t,
                         "resumed": [ln for ln in lines if "resumed" in ln],
                         "done": [ln for ln in lines
                                  if ln.startswith("[train] done")],
                         "logged_losses": losses,
                         "checkpoint_bytes": _bundle_bytes(tmp / "run"),
                         "stderr_tail": stderr[-1500:]
                         if proc.returncode else ""})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def _check_cli(phase, runs, steps, more):
    first, second = runs
    if first["exit_code"] != 0 or not first["done"] or first["resumed"]:
        fail(f"{phase}: launch.train ({steps} steps) exited "
             f"{first['exit_code']}: {first}")
    if second["exit_code"] != 0 or not second["done"] or \
            second["resumed"] != [f"[trainer] resumed from step {steps}"]:
        fail(f"{phase}: launch.train ({more} steps) did not resume from "
             f"step {steps}: {second}")


def start_train_clis():
    """Start :func:`phase_train_clis`'s two CLIs, each in a thread of its
    own: neither launches a kernel, so both run beside the kernels' build,
    which leaves the card idle. Returns their handle."""
    import concurrent.futures
    import threading

    arch, steps, more, B, S = TRAIN_CLI
    m_arch, m_steps, m_more, m_B, m_S = MESH_TRAIN_CLI
    clis = {"lock": threading.Lock(), "stop": threading.Event(),
            "procs": [], "pool": concurrent.futures.ThreadPoolExecutor(2)}
    clis["plain"] = clis["pool"].submit(
        _cli_runs, ["--arch", arch, "--full", "--batch", str(B), "--seq",
                    str(S)], (steps, more), "samp_train_cli_", clis)
    clis["meshed"] = clis["pool"].submit(
        _cli_runs, ["--arch", m_arch, "--full", "--mesh-model", "2",
                    "--ranks", "2", "--batch", str(m_B), "--seq", str(m_S)],
        (m_steps, m_more), "samp_mesh_train_cli_", clis)
    return clis


def stop_train_clis(clis):
    """End every CLI run still going (after a failure beside them) and
    wait for their threads."""
    import os
    import signal

    with clis["lock"]:
        clis["stop"].set()
        for proc in clis["procs"]:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
    clis["pool"].shutdown(wait=True)


def phase_train_clis(card, clis):
    """The training CLI as a user runs it on the full qwen2-0.5b, twice on
    one checkpoint directory (the second run must resume): unmeshed for
    ``train_path`` (``TRAIN_CLI``) and on two ranks sharing the card for
    ``mesh_train_path`` (``MESH_TRAIN_CLI``: ``--mesh-model 2 --ranks
    2``), started by :func:`start_train_clis`. The two run side by side,
    since start-up and 6 GB checkpoints take most of their time: each
    run's seconds overlap the other's and the build's."""
    arch, steps, more, B, S = TRAIN_CLI
    m_arch, m_steps, m_more, m_B, m_S = MESH_TRAIN_CLI
    runs, m_runs = clis["plain"].result(), clis["meshed"].result()
    emit({"phase": "train_path", "part": "cli", "card": card, "arch": arch,
          "batch": B, "seq": S, "side_by_side": "mesh_train_path, build",
          "runs": runs})
    emit({"phase": "mesh_train_path", "part": "cli", "card": card,
          "arch": m_arch, "batch": m_B, "seq": m_S,
          "side_by_side": "train_path, build", "runs": m_runs})
    _check_cli("train_path", runs, steps, more)
    _check_cli("mesh_train_path", m_runs, m_steps, m_more)


def phase_train(model, device, card):
    """``train_path``: the paper's step 0 on the card, then what was trained
    through the kernels. (a) ``SAMP.from_config`` on full-width BERT-base
    (float32, ``tnews``, 128 positions, the fused backend) and ``finetune``
    for ``TRAIN_STEPS`` steps at ``TRAIN_LR``, batch 32, seed 0: every
    step's loss finite, the last 10 steps' mean loss at least 0.1 below the
    first 10's, float dev accuracy (4 batches of 32) above 2/15. (b)
    :func:`train_resume`. (c) The trained weights calibrated on
    ``main_path``'s batches, quantized under the tiled golden plan and
    served like ``main_path`` (:func:`phase_serve`: identical predictions,
    rel-Linf 5e-3, 42 / 6 / 6 / 1 launches a forward), and the int8 dev
    accuracy. Its CLI runs in :func:`phase_train_clis`. Returns the served
    path."""
    import statistics as stats
    import torch
    from repro_torch.quant import ptq
    from repro_torch.toolkit import SAMP

    phase_t0 = time.perf_counter()
    cfg = model["cfg"]
    samp = SAMP.from_config(cfg, task="tnews", seq_len=TRAIN_SEQ,
                            float_dtype="float32", backend="fused",
                            device=device)
    logs = []
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    samp.finetune(steps=TRAIN_STEPS, lr=TRAIN_LR, batch_size=TRAIN_BATCH,
                  log_every=1, seed=0, log=logs.append)
    torch.cuda.synchronize()
    finetune_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    losses, dts = _train_losses(logs)
    n_eval, eval_bs = TRAIN_EVAL
    float_acc = samp.eval(batches=n_eval, batch_size=eval_bs)
    step_ms = stats.median(dts) * 1e3
    first, last = stats.mean(losses[:10]), stats.mean(losses[-10:])
    rec = {"phase": "train_path", "part": "finetune", "card": card,
           "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "task": "tnews", "steps": TRAIN_STEPS,
           "lr": TRAIN_LR, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "compute_dtype": "float32", "finetune_s": finetune_s,
           "median_step_ms": step_ms,
           "step_ms_min_max": [min(dts) * 1e3, max(dts) * 1e3],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_memory_gb": peak / 1e9,
           "peak_above_start_gb": (peak - start_bytes) / 1e9,
           "loss_first10_mean": first, "loss_last10_mean": last,
           "losses_every_10": losses[::10],
           "float_dev_accuracy": float_acc,
           "stragglers": [m for m in logs if "STRAGGLER" in m]}
    emit(rec)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train_path: {len(losses)} step losses of {TRAIN_STEPS}, "
             f"finite {all(map(math.isfinite, losses))}")
    if last > first - TRAIN_LOSS_DROP:
        fail(f"train_path: the loss fell from {first} to {last}, less than "
             f"{TRAIN_LOSS_DROP}")
    if float_acc <= 2.0 / 15:
        fail(f"train_path: float dev accuracy {float_acc} <= 2/15")
    emit(train_profile(samp, device, card, step_ms))
    resume = train_resume(cfg, device, card)
    trained = dict(model, params=samp.pipeline.params)
    path = phase_serve("train_path", trained, model["plan"], device)
    qpipe = samp.pipeline.with_policy(path["qparams"], path["qplan"],
                                      model["plan"])
    int8_acc = qpipe.eval(batches=n_eval, batch_size=eval_bs)
    emit({"phase": "train_path", "part": "summary", "card": card,
          "float_dev_accuracy": float_acc, "int8_dev_accuracy": int8_acc,
          "plan": model["plan"].describe(),
          "median_step_ms": step_ms, "tokens_per_s": rec["tokens_per_s"],
          "peak_memory_gb": rec["peak_memory_gb"],
          "checkpoint_save_s": resume["checkpoint_save_s"],
          "checkpoint_load_s": resume["checkpoint_load_s"],
          "phase_s": time.perf_counter() - phase_t0})
    del samp, qpipe
    path.pop("fused")               # not profiled: main_path's shapes
    return path


def setup_decoder(device):
    """Full-width qwen2-0.5b with seeded float weights, the golden plan
    tiled to 24 layers, its calibration batches and the decode requests."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T

    cfg = get_config("qwen2-0.5b")
    golden = PrecisionPlan.load(str(GOLDEN_PLAN))
    plan = PrecisionPlan(golden.layers * DECODE_TILE, golden.float_dtype)
    if plan.num_layers != cfg.num_layers:
        fail(f"tiled plan has {plan.num_layers} layers, qwen2-0.5b "
             f"{cfg.num_layers}")
    t0 = time.perf_counter()
    float_policy = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, float_policy, seed=0, device=device)
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=4,
                                            seq_len=128, seed=0)
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 65, DECODE_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    emit({"phase": "setup_decoder", "model": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "plan": plan.describe(), "requests": DECODE_REQUESTS,
          "prompt_tokens": int(lengths.sum()),
          "init_s": time.perf_counter() - t0})
    return {"cfg": cfg, "plan": plan, "params": params, "batches": batches,
            "float_plan": T.build_plan(cfg, float_policy),
            "prompts": prompts}


def decode_head_plan(plan):
    """Every layer's KV cache int8_per_head, and softmax='uint8' on the
    layers whose qkv block is float (they take the decode kernel): the
    kernel's per-head scales and its two-pass p_scale mode."""
    from repro_torch.core.plan import PrecisionPlan
    return PrecisionPlan(tuple(
        lp.with_kv("int8_per_head") if lp.qkv.quantized else
        lp.with_kv("int8_per_head").with_dataflow(softmax="uint8")
        for lp in plan.layers), plan.float_dtype)


class Ticks:
    """Wraps an engine's decode step: records each tick's inputs, its wall
    (to the synchronized end of the step) and, without ``against``, a
    device copy of its logits; with ``against`` (the fused run's Ticks),
    compares the logits of the live rows at every tick whose inputs equal
    that run's. ``on_tick(pos, active)`` runs before each step."""

    def __init__(self, engine, against=None, on_tick=None):
        self.step, engine._decode = engine._decode, self
        self.against, self.on_tick = against, on_tick
        self.inputs, self.logits, self.walls = [], [], []
        self.compared, self.max_rel, self.finite = 0, 0.0, True

    def __call__(self, params, caches, tokens, pos, active, pages=None):
        import numpy as np
        import torch
        if self.on_tick is not None:
            self.on_tick(pos, active)
        t = time.perf_counter()
        out, caches = self.step(params, caches, tokens, pos, active, pages)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t)
        i = len(self.inputs)
        self.inputs.append((tokens.copy(), pos.copy(), active.copy()))
        live = torch.from_numpy(active).to(out.device)
        if self.against is None:
            self.logits.append(out.clone())
            self.finite &= bool(torch.isfinite(out[live]).all())
        elif i < len(self.against.inputs) and all(
                np.array_equal(a, b)
                for a, b in zip(self.inputs[i], self.against.inputs[i])):
            ref = self.against.logits[i]
            self.against.logits[i] = None
            self.max_rel = max(self.max_rel, rel_linf(ref[live], out[live]))
            self.compared += 1
        return out, caches


def serve_decode(engine, prompts, max_tokens=DECODE_MAX_TOKENS):
    """Submit every prompt, run the engine dry; (outputs by uid, wall s)."""
    from repro_torch.serve import Request
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=list(p), max_tokens=max_tokens))
    t = time.perf_counter()
    done = engine.run()
    return {r.uid: r.output for r in done}, time.perf_counter() - t


def phase_decode(name, model, plan, device, kv_cache=None):
    """Calibrate and quantize the decoder under ``plan``, serve the requests
    on the fused backend (counters zeroed just before the counted run, read
    just after) and on the reference backend, and check them."""
    import statistics as st
    import torch
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    from repro_torch.serve import ServeEngine

    cfg = model["cfg"]
    t0 = time.perf_counter()
    stats = ptq.capture_stats(model["params"], model["batches"], cfg,
                              model["float_plan"], precision=plan)
    qparams, qplan = ptq.apply_plan(model["params"], cfg, plan, stats,
                                    float_plan=model["float_plan"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kw = dict(batch_slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN,
              page_size=PAGE_SIZE, kv_cache=kv_cache, precision=plan,
              device=device)
    schemes = ((kv_cache,) * cfg.num_layers if kv_cache is not None
               else plan.kv_schemes)
    prompts = model["prompts"]
    serve_decode(ServeEngine(cfg, qparams, qplan, backend="fused", **kw),
                 prompts[:2], max_tokens=4)            # warm-up, not counted

    fused = ServeEngine(cfg, qparams, qplan, backend="fused", **kw)
    with SubCounts() as sub:
        longest = [-1]

        def on_tick(pos, active):
            total = int((pos + 1)[active].sum())
            if total >= longest[0]:
                longest[0], sub.capture = total, True
        ticks = Ticks(fused, on_tick=on_tick)
        kernels.reset_launches()
        outputs, wall = serve_decode(fused, prompts)
        launches = kernels.launch_counts()
    fused._decode = ticks.step          # the profile times the bare engine
    n_ticks = fused.stats["ticks"]
    in_use = fused.kv_pages_in_use

    reference = ServeEngine(cfg, qparams, qplan, backend="reference", **kw)
    ref_ticks = Ticks(reference, against=ticks)
    ref_outputs, ref_wall = serve_decode(reference, prompts)

    cases = kernel_cases(cfg, plan, schemes)
    per_tick, sub_tick = collections.Counter(), collections.Counter()
    for key, case in cases.items():
        per_tick[key[0]] += case["count"]
        if case["sub"]:
            sub_tick[case["sub"]] += case["count"]
    sub_tick = {k: sub_tick[k] for k in EXPECTED_DECODE_SUB[name]}
    want = {k: per_tick[k] * n_ticks for k in launches}
    with torch.inference_mode():
        float_pool = T.cache_bytes(T.init_caches(
            cfg, qplan, DECODE_SLOTS, DECODE_MAX_LEN, page_size=PAGE_SIZE,
            kv_schemes=("float",) * cfg.num_layers, device=device))
    generated = sum(len(o) for o in outputs.values())
    slot_tokens = fused.stats["tokens"]
    rec = {"phase": name, "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "plan": plan.describe(),
           "plan_fingerprint": plan.fingerprint(),
           "kv_schemes": sorted(set(schemes)), "setup_s": setup_s,
           "requests": len(prompts), "slots": DECODE_SLOTS,
           "page_size": PAGE_SIZE, "max_len": DECODE_MAX_LEN,
           "ticks": n_ticks, "slot_tokens": slot_tokens,
           "generated_tokens": generated, "wall_s": wall,
           "tokens_per_s": slot_tokens / wall,
           "generated_tokens_per_s": generated / wall,
           "median_tick_ms": st.median(ticks.walls) * 1e3,
           "reference_wall_s": ref_wall,
           "reference_median_tick_ms": st.median(ref_ticks.walls) * 1e3,
           "launches": launches, "expected_launches": want,
           "launches_per_tick": dict(per_tick),
           "sub_counts": dict(sub.counts), "sub_counts_per_tick": sub_tick,
           "ticks_compared": ref_ticks.compared,
           "fused_vs_reference_rel_linf": ref_ticks.max_rel,
           "tokens_equal": outputs == ref_outputs,
           "kv_pages_in_use_after": [in_use, reference.kv_pages_in_use],
           "kv_cache_bytes": fused.kv_cache_bytes,
           "float_pool_kv_cache_bytes": float_pool,
           "kv_bytes_ratio": fused.kv_cache_bytes / float_pool,
           "longest_tick_tokens": longest[0]}
    emit(rec)
    if outputs != ref_outputs:
        fail(f"{name}: fused and reference tokens differ")
    if sorted(outputs) != list(range(len(prompts))) or any(
            len(o) != DECODE_MAX_TOKENS or not all(0 <= t < cfg.vocab_size
                                                   for t in o)
            for o in outputs.values()) or not ticks.finite:
        fail(f"{name}: outputs are not {DECODE_MAX_TOKENS} in-vocabulary "
             f"tokens per request from finite logits")
    if ref_ticks.compared == 0 or ref_ticks.max_rel > REL_LINF_BUDGET:
        fail(f"{name}: fused vs reference logits rel-Linf "
             f"{ref_ticks.max_rel} over {ref_ticks.compared} ticks (budget "
             f"{REL_LINF_BUDGET})")
    expected = dict(EXPECTED_DECODE)
    if {k: v for k, v in per_tick.items()} != expected:
        fail(f"{name}: the plan implies {dict(per_tick)} launches per tick, "
             f"not {expected}")
    if launches != want or any(launches[k] == 0 for k in expected):
        fail(f"{name}: launch counts {launches} != plan-implied {want}")
    if sub_tick != EXPECTED_DECODE_SUB[name] or dict(sub.counts).get(
            "decode_attention with p_scale", 0) != \
            EXPECTED_DECODE_SUB[name]["decode_attention with p_scale"] \
            * n_ticks:
        fail(f"{name}: p_scale sub-counts {dict(sub.counts)} over "
             f"{n_ticks} ticks; the plan implies {sub_tick} per tick")
    if in_use or reference.kv_pages_in_use:
        fail(f"{name}: {in_use} / {reference.kv_pages_in_use} pages still "
             f"in use after the run")
    if name == "decode_head_path" and plan.fingerprint() != HEAD_FINGERPRINT:
        fail(f"decode head plan fingerprint {plan.fingerprint()} is not the "
             f"JAX package's {HEAD_FINGERPRINT}")
    if sub.decode_args is None:
        fail(f"{name}: no decode_attention call was captured")
    return {"name": name, "cfg": cfg, "qparams": qparams, "fused": fused,
            "launches": launches, "per_fwd": per_tick, "cases": cases,
            "buckets": [DECODE_BUCKET], "timed_bucket": DECODE_BUCKET,
            "unit": "tick", "decode_args": sub.decode_args,
            "prompts": prompts}


def _counted_encodes(router, calls):
    """Spy on each member runtime's ``encode``: appends (cluster, (B, S),
    the kernel launches of that forward) to ``calls``. Returns a function
    that removes the spies."""
    import numpy as np
    from repro_torch import kernels

    def spy(entry):
        orig = entry.runtime.encode

        def encode(params, inputs, lengths=None):
            before = kernels.launch_counts()
            out = orig(params, inputs, lengths)
            after = kernels.launch_counts()
            calls.append((entry.cluster,
                          tuple(np.asarray(inputs["tokens"]).shape),
                          {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}))
            return out
        entry.runtime.encode = encode

    for e in router.entries.values():
        spy(e)

    def remove():
        for e in router.entries.values():
            del e.runtime.encode            # back to the class's method
    return remove


def adaptive_encoder(model, device):
    """The routed encoder: full-width BERT-base with ``main_path``'s
    weights, LengthBuckets(16, 64), cluster-conditional calibration on
    ``clustered_synthetic_batches`` (2 batches of 4 a cluster, at 16, 64 and
    128 tokens, each member's calibrators), and three members: the span
    plan, the tiled golden plan and quant_ffn_only at k = 8. ``main_path``'s
    32 requests are served through ``EncoderServeEngine(router=...)`` on
    the fused backend (a warm-up, then the counted run with every member
    forward's launches read around it) and each cluster's requests through
    an unrouted engine running that cluster's entry alone."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.adaptive import (LengthBuckets, PlanSet, batch_clusters,
                                      build_router,
                                      clustered_synthetic_batches)
    from repro_torch.core.plan import plan_from_policy
    from repro_torch.core.precision import EncoderPolicy, LayerMode
    from repro_torch.core.samp import int8_dataflow_variant
    from repro_torch.quant import ptq
    from repro_torch.serve import EncoderRequest, EncoderServeEngine
    from repro_torch.serve.runtime import bucket_size

    cfg, params = model["cfg"], model["params"]
    cm = LengthBuckets(ADAPTIVE_EDGES)
    ffn = plan_from_policy(EncoderPolicy.prefix(
        cfg.num_layers, ADAPTIVE_FFN_K, LayerMode.QUANT_FFN_ONLY, "float32"))
    planset = PlanSet(((0, int8_dataflow_variant(model["plan"])),
                       (1, model["plan"]), (2, ffn)), default=1)
    t0 = time.perf_counter()
    batches, classes = clustered_synthetic_batches(
        cfg, cm, batches_per_cluster=2, batch_size=4, max_len=128)
    stats = ptq.capture_stats(params, batches, cfg, model["float_plan"],
                              precision=planset, clusters=batch_clusters(
                                  cm, batches, batch_classes=classes))
    router = build_router(cfg, params, planset, stats, cluster_model=cm,
                          float_plan=model["float_plan"], backend="fused")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    requests = model["requests"]
    split = collections.Counter(cm.assign(t) for t in requests)
    d = router.entry(planset.default)
    routed = EncoderServeEngine(cfg, d.params, d.plan, backend="fused",
                                max_batch=8, router=router, device=device)
    serve(routed, requests)                        # warm-up, not counted
    calls = []
    remove = _counted_encodes(router, calls)
    with SubCounts() as sub:
        kernels.reset_launches()
        done, _ = serve(routed, requests)
        launches = kernels.launch_counts()
    remove()
    _, routed_wall = serve(routed, requests)       # timed, no spies

    expected, cases_by = {}, {}
    for cid, plan in planset:
        cases_by[cid] = kernel_cases(cfg, plan)
        per = collections.Counter()
        for key, case in cases_by[cid].items():
            per[key[0]] += case["count"]
        expected[cid] = dict(per)
    wrong = [(c, shape, got) for c, shape, got in calls
             if got != expected[c]]
    want = collections.Counter()
    for c, _, _ in calls:
        want.update(expected[c])

    # each cluster's requests alone through its entry, at the same buckets
    solo, solo_wall = {}, 0.0
    for cid in planset.cluster_ids:
        e = router.entry(cid)
        eng = EncoderServeEngine(cfg, e.params, e.plan, backend="fused",
                                 max_batch=8, device=device)
        uids = [i for i, t in enumerate(requests) if cm.assign(t) == cid]
        for i in uids:
            eng.submit(EncoderRequest(uid=i, tokens=requests[i]))
        t = time.perf_counter()
        for r in eng.run():
            solo[r.uid] = r.logits
        solo_wall += time.perf_counter() - t
    diff = max(float(np.abs(r.logits - solo[r.uid]).max()) for r in done)
    logits = np.stack([r.logits for r in done])

    # one unrouted engine under the default member serving all 32, warm
    unrouted = EncoderServeEngine(cfg, d.params, d.plan, backend="fused",
                                  max_batch=8, device=device)
    serve(unrouted, requests)
    _, unrouted_wall = serve(unrouted, requests)

    # admission: LengthBuckets needs no compute
    t = time.perf_counter()
    for toks in requests:
        cm.assign(toks)
    admit_ms = (time.perf_counter() - t) * 1e3 / len(requests)

    served = {(c, bucket_size(shape[0]), bucket_size(shape[1], 8, 256))
              for c, shape, _ in calls}
    keys = [k for k in routed.runtime._exe if k[0] == "encode"]
    by_bucket = collections.Counter(("fused",) + k[2:4] for k in keys)
    key_ok = all(k[1][0] == "fused" and k[1][-1] in planset.cluster_ids
                 and k[1][1] == planset.plan_for(k[1][-1]).fingerprint()
                 for k in keys)
    served_by_bucket = collections.Counter(("fused", b, s)
                                           for _, b, s in served)
    rec = {"phase": "adaptive_path", "part": "encoder", "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "cluster_model": cm.describe(), "planset": planset.describe(),
           "members": {c: {"plan": p.describe(),
                           "fingerprint": p.fingerprint()}
                       for c, p in planset},
           "setup_s": setup_s, "requests": len(requests),
           "requests_by_cluster": dict(router.requests_by_cluster),
           "length_split": dict(split),
           "member_forwards": len(calls),
           "forwards_by_cluster": dict(collections.Counter(
               c for c, _, _ in calls)),
           "launches": launches, "expected_launches": dict(want),
           "launches_per_member_forward": expected,
           "forwards_off_plan": wrong[:3],
           "sub_counts": dict(sub.counts),
           "routed_vs_solo_max_abs": diff,
           "callables": len(keys),
           "callables_by_bucket": {f"{b}x{s}": n for (_, b, s), n in
                                   sorted(by_bucket.items())},
           "served_cluster_buckets": len(served),
           "routed_wall_s": routed_wall,
           "routed_requests_per_s": len(requests) / routed_wall,
           "unrouted_wall_s": unrouted_wall,
           "unrouted_requests_per_s": len(requests) / unrouted_wall,
           "solo_engines_wall_s": solo_wall,
           "admission_ms_per_request": admit_ms}
    emit(rec)
    if logits.shape != (N_REQUESTS, 15) or not np.isfinite(logits).all():
        fail(f"adaptive_path: routed logits shape {logits.shape} or "
             f"not finite")
    if diff != 0.0:
        fail(f"adaptive_path: routed logits differ from the solo members' "
             f"by {diff}")
    if dict(router.requests_by_cluster) != {c: 3 * split[c]
                                             for c in planset.cluster_ids}:
        fail(f"adaptive_path: requests_by_cluster "
             f"{router.requests_by_cluster} over three runs, the length "
             f"split {dict(split)}")
    if wrong:
        fail(f"adaptive_path: {len(wrong)} member forwards launched off "
             f"their plan: {wrong[:3]}; the plans name {expected}")
    if launches != {k: want.get(k, 0) for k in launches} \
            or not launches["quant_flash_attention"]:
        fail(f"adaptive_path: launch counts {launches} != the member "
             f"plans' {dict(want)}")
    if not key_ok or set((k[1][-1],) + k[2:4] for k in keys) != served \
            or by_bucket != served_by_bucket:
        fail(f"adaptive_path: the runtime holds {len(keys)} callables "
             f"{sorted(by_bucket.items())}; the routed forwards reached "
             f"{sorted(served)}")
    union = collections.OrderedDict()
    for cid, cases in cases_by.items():
        for key, case in cases.items():
            c = union.setdefault(key, dict(
                case, count=0, qparams=router.entry(cid).params))
            c["count"] += case["count"]
    per_fwd = collections.Counter()
    for per in expected.values():
        per_fwd.update(per)
    buckets = {(b, s) for _, b, s in served}
    return {"name": "adaptive_path", "cfg": cfg, "qparams": d.params,
            "qplan": d.plan, "fused": routed, "launches": launches,
            "per_fwd": per_fwd, "cases": union,
            "buckets": sorted(buckets | {PROFILE_BUCKET}),
            "timed_bucket": PROFILE_BUCKET, "unit": "member_forwards",
            "batches": batches, "router": router}


def adaptive_kmeans(model, batches, device):
    """EmbeddingKMeans(k=2) fitted on the pooled embeddings of the
    encoder's calibration batches (on the card, through fused_embed),
    calibrated per cluster, deployed under quant_ffn_only uniformly, and 8
    of ``main_path``'s requests admitted and served: each assignment is
    held against the torch argmin on the card and a numpy argmin from the
    same centroids on embeddings recomputed on the CPU."""
    import numpy as np
    import torch
    from repro_torch.adaptive import (EmbeddingKMeans, PlanSet,
                                      batch_clusters, build_router,
                                      fit_cluster_model, pooled_embeddings)
    from repro_torch.core.plan import plan_from_policy
    from repro_torch.core.precision import EncoderPolicy, LayerMode
    from repro_torch.interop import map_leaves
    from repro_torch.quant import ptq
    from repro_torch.serve import EncoderRequest, EncoderServeEngine

    cfg, params = model["cfg"], model["params"]
    t0 = time.perf_counter()
    cm = EmbeddingKMeans(2, seed=0)
    fit_cluster_model(cm, params, batches, cfg, backend="fused")
    ffn = plan_from_policy(EncoderPolicy.prefix(
        cfg.num_layers, ADAPTIVE_FFN_K, LayerMode.QUANT_FFN_ONLY, "float32"))
    stats = ptq.capture_stats(params, batches, cfg, model["float_plan"],
                              precision=ffn,
                              clusters=batch_clusters(cm, batches))
    router = build_router(cfg, params, PlanSet.uniform(ffn, range(2)),
                          stats, cluster_model=cm,
                          float_plan=model["float_plan"], backend="fused")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    requests = model["requests"][:ADAPTIVE_KMEANS_REQUESTS]
    reqs = [EncoderRequest(uid=i, tokens=t) for i, t in enumerate(requests)]
    walls = []
    for r in reqs:
        t = time.perf_counter()
        router.admit(r)
        walls.append((time.perf_counter() - t) * 1e3)
    admitted = [r.cluster for r in reqs]
    cpu_embed = {"embed": map_leaves(params["embed"], lambda _, v: v.cpu())}
    on_card, on_cpu, pooled_diff = [], [], 0.0
    for toks in requests:
        batch = {"tokens": np.asarray([toks], np.int32),
                 "segments": np.zeros((1, len(toks)), np.int32)}
        x = pooled_embeddings(params, batch, cfg, backend="fused")
        on_card.append(int(cm.assign_embedded(
            torch.from_numpy(x).to(device))[0]))
        xc = pooled_embeddings(cpu_embed, batch, cfg)
        pooled_diff = max(pooled_diff, float(np.abs(x - xc).max()))
        on_cpu.append(int(((cm.centroids - xc) ** 2).sum(-1).argmin()))
    e = router.entry(0)
    engine = EncoderServeEngine(cfg, e.params, e.plan, backend="fused",
                                max_batch=8, router=router, device=device)
    for r in reqs:
        engine.batcher.submit(r)              # admitted above
    served = engine.run()
    keys = [k for k in engine.runtime._exe if k[0] == "encode"]
    rec = {"phase": "adaptive_path", "part": "kmeans",
           "cluster_model": cm.describe(), "setup_s": setup_s,
           "calibration_rows": int(sum(len(b["tokens"]) for b in batches)),
           "requests": len(requests), "assignments": admitted,
           "card_argmin": on_card, "cpu_argmin": on_cpu,
           "pooled_card_vs_cpu_max_abs": pooled_diff,
           "admission_ms_per_request": statistics.median(walls),
           "admission_ms_runs": walls,
           "served": len(served),
           "callables_by_bucket": dict(collections.Counter(
               f"{k[2]}x{k[3]}" for k in keys))}
    emit(rec)
    if admitted != on_card or admitted != on_cpu:
        fail(f"adaptive_path: k-means admission {admitted}, card argmin "
             f"{on_card}, CPU recomputation {on_cpu}")
    if len(served) != len(requests) or not all(
            np.isfinite(r.logits).all() for r in served):
        fail("adaptive_path: the k-means routed requests were not all "
             "served with finite logits")


def adaptive_facade(model, device):
    """``SAMP.autotune(clusters=LengthBuckets(16, 64))`` on full-width
    BERT-base (``main_path``'s weights, float32, ``tnews``, 128 positions,
    the fused backend, wallclock latency): one prefix-grid search per
    cluster at ``autotune_path``'s stride and evaluation, saved as a v3
    bundle and reloaded on both backends. The reloaded member trees and
    fused predictions must be the saved ones bit for bit, the routed
    serving of ``main_path``'s requests too, and the reference backend
    within rel-Linf 5e-3 with identical predictions."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.adaptive import LengthBuckets
    from repro_torch.data.pipeline import get_batch
    from repro_torch.interop import flatten_names
    from repro_torch.toolkit import SAMP
    from repro_torch.toolkit.latency import WallclockBackend

    cfg = model["cfg"]
    B, S = AUTOTUNE_LATENCY
    n_eval, eval_bs = AUTOTUNE_EVAL
    samp = SAMP.from_config(cfg, task="tnews", seq_len=S,
                            float_dtype="float32",
                            latency=WallclockBackend(reps=5, warmup=2),
                            latency_batch=B, backend="fused", device=device)
    samp.pipeline.params = model["params"]
    tmp = Path(tempfile.mkdtemp(prefix="samp_adaptive_"))
    try:
        t0 = time.perf_counter()
        report = samp.autotune(clusters=LengthBuckets(ADAPTIVE_EDGES),
                               stride=AUTOTUNE_STRIDE, eval_batches=n_eval,
                               eval_batch_size=eval_bs)
        torch.cuda.synchronize()
        autotune_s = time.perf_counter() - t0
        path = samp.save(str(tmp / "adaptive"))
        with open(Path(path) / "artifact.json") as f:
            version = json.load(f)["version"]
        t0 = time.perf_counter()
        fused = SAMP.load(path, backend="fused", device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ref = SAMP.load(path, backend="reference", device=device)
        trees_equal = True
        for cid in samp.planset.cluster_ids:
            a = flatten_names(samp.router.entry(cid).params)
            b = flatten_names(fused.router.entry(cid).params)
            trees_equal &= [n for n, _ in a] == [n for n, _ in b] and all(
                x.dtype == y.dtype and torch.equal(x, y)
                for (_, x), (_, y) in zip(a, b))
        batches = [get_batch(samp.task, i, eval_bs, "dev")
                   for i in range(n_eval)]
        mine = np.concatenate([samp.current.predict_logits(b)
                               for b in batches])
        got = np.concatenate([fused.current.predict_logits(b)
                              for b in batches])
        refl = np.concatenate([ref.current.predict_logits(b)
                               for b in batches])
        routed = {}
        for name, s in (("saved", samp), ("loaded", fused)):
            routed[name] = np.stack([r.logits for r in serve(
                s.serve(batch_slots=8, max_len=S), model["requests"])[0]])
        nbytes = _bundle_bytes(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    per_cluster = {
        c: {"candidates": len(points), "chosen": [ch.mode_name, ch.point.k],
            "plan": ch.point.plan.describe(), "accuracy": ch.point.accuracy,
            "wallclock_ms": ch.point.latency * 1e3}
        for c, (points, _, ch) in report.per_cluster.items()}
    rec = {"phase": "adaptive_path", "part": "facade",
           "stride": AUTOTUNE_STRIDE, "eval": [n_eval, eval_bs],
           "latency_batch": [B, S], "planset": report.planset.describe(),
           "per_cluster": per_cluster, "accuracy": report.accuracy,
           "autotune_s": autotune_s, "bundle_version": version,
           "bundle_bytes": nbytes, "load_s": load_s,
           "member_trees_equal": bool(trees_equal),
           "loaded_vs_saved_max_abs": float(np.abs(got - mine).max()),
           "routed_loaded_vs_saved_max_abs": float(np.abs(
               routed["loaded"] - routed["saved"]).max()),
           "reference_vs_fused_rel_linf": rel_linf(
               torch.from_numpy(refl), torch.from_numpy(got)),
           "reference_predictions_equal": bool(
               (refl.argmax(-1) == got.argmax(-1)).all())}
    emit(rec)
    if version != 3 or len(report.planset) != 3:
        fail(f"adaptive_path: the facade saved a v{version} bundle of "
             f"{len(report.planset)} members, not v3 of 3")
    if not trees_equal or rec["loaded_vs_saved_max_abs"] != 0.0 \
            or rec["routed_loaded_vs_saved_max_abs"] != 0.0:
        fail(f"adaptive_path: the v3 reload on the fused backend is not "
             f"the saved deployment: trees equal {trees_equal}, logits "
             f"{rec['loaded_vs_saved_max_abs']}, routed "
             f"{rec['routed_loaded_vs_saved_max_abs']}")
    if rec["reference_vs_fused_rel_linf"] > REL_LINF_BUDGET \
            or not rec["reference_predictions_equal"]:
        fail(f"adaptive_path: the v3 reload on the reference backend: "
             f"rel-Linf {rec['reference_vs_fused_rel_linf']}, predictions "
             f"equal {rec['reference_predictions_equal']}")


def adaptive_decode(decoder, device):
    """Routed decode: full-width qwen2-0.5b, LengthBuckets(32), the tiled
    golden plan deployed uniformly with per-cluster scales (calibrated on
    one batch of 4 a cluster, at 32 and 64 tokens), int8 per-token pages
    shared by both clusters; the 16 decode prompts served routed on the
    fused backend (counted) and each cluster's prompts through an unrouted
    engine running that member alone."""
    import torch
    from repro_torch import kernels
    from repro_torch.adaptive import (LengthBuckets, PlanSet, batch_clusters,
                                      build_router,
                                      clustered_synthetic_batches)
    from repro_torch.quant import ptq
    from repro_torch.serve import Request, ServeEngine

    cfg, plan, params = decoder["cfg"], decoder["plan"], decoder["params"]
    cm = LengthBuckets(ADAPTIVE_DECODE_EDGES)
    t0 = time.perf_counter()
    batches, classes = clustered_synthetic_batches(
        cfg, cm, batches_per_cluster=1, batch_size=4, max_len=64)
    stats = ptq.capture_stats(params, batches, cfg, decoder["float_plan"],
                              precision=plan, clusters=batch_clusters(
                                  cm, batches, batch_classes=classes))
    planset = PlanSet.uniform(plan, range(cm.num_clusters))
    router = build_router(cfg, params, planset, stats, cluster_model=cm,
                          float_plan=decoder["float_plan"], backend="fused")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kw = dict(batch_slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN,
              page_size=PAGE_SIZE, kv_cache="int8_per_token",
              backend="fused", device=device)
    prompts = decoder["prompts"]
    e = router.entry(planset.default)
    routed = ServeEngine(cfg, e.params, e.plan, router=router, **kw)
    kernels.reset_launches()
    outputs, wall = serve_decode(routed, prompts,
                                 max_tokens=ADAPTIVE_DECODE_MAX_TOKENS)
    launches = kernels.launch_counts()
    n_ticks = routed.stats["ticks"]
    per_tick = collections.Counter()
    for key, case in kernel_cases(
            cfg, plan, ("int8_per_token",) * cfg.num_layers).items():
        per_tick[key[0]] += case["count"]
    want = {k: per_tick[k] * n_ticks for k in launches}
    solo, solo_wall, solo_ticks = {}, 0.0, 0
    for cid in planset.cluster_ids:
        ec = router.entry(cid)
        eng = ServeEngine(cfg, ec.params, ec.plan, **kw)
        for i, p in enumerate(prompts):
            if cm.assign(p) == cid:
                eng.submit(Request(uid=i, prompt=list(p),
                                   max_tokens=ADAPTIVE_DECODE_MAX_TOKENS))
        t = time.perf_counter()
        solo.update({r.uid: r.output for r in eng.run()})
        solo_wall += time.perf_counter() - t
        solo_ticks += eng.stats["ticks"]
    split = collections.Counter(cm.assign(p) for p in prompts)
    decode_keys = sorted(k[1][-1] for k in routed.runtime._exe
                         if k[0] == "decode")
    generated = sum(len(o) for o in outputs.values())
    rec = {"phase": "adaptive_path", "part": "decode", "model": cfg.name,
           "layers": cfg.num_layers, "cluster_model": cm.describe(),
           "planset": planset.describe(), "setup_s": setup_s,
           "requests": len(prompts), "max_tokens": ADAPTIVE_DECODE_MAX_TOKENS,
           "slots": DECODE_SLOTS, "page_size": PAGE_SIZE,
           "requests_by_cluster": dict(router.requests_by_cluster),
           "ticks": n_ticks, "generated_tokens": generated,
           "wall_s": wall, "generated_tokens_per_s": generated / wall,
           "solo_wall_s": solo_wall, "solo_ticks": solo_ticks,
           "solo_generated_tokens_per_s": generated / solo_wall,
           "launches": launches, "expected_launches": want,
           "decode_callables_by_cluster": decode_keys,
           "tokens_equal_solo": outputs == solo,
           "kv_pages_in_use_after": routed.kv_pages_in_use}
    emit(rec)
    if outputs != solo or any(len(o) != ADAPTIVE_DECODE_MAX_TOKENS
                              for o in outputs.values()):
        fail("adaptive_path: routed decode tokens differ from the solo "
             "members'")
    if dict(router.requests_by_cluster) != dict(split) or len(split) != 2:
        fail(f"adaptive_path: decode requests_by_cluster "
             f"{router.requests_by_cluster}, the length split {dict(split)}")
    if routed.kv_pages_in_use:
        fail(f"adaptive_path: {routed.kv_pages_in_use} pages in use after "
             f"the routed decode run")
    if launches != want or not launches["decode_attention"]:
        fail(f"adaptive_path: routed decode launched {launches}, the plan "
             f"implies {want} over {n_ticks} ticks")
    if decode_keys != [0, 1]:
        fail(f"adaptive_path: decode callables for clusters {decode_keys}")


def phase_adaptive(model, decoder, device):
    """``adaptive_path``: input-adaptive precision on the card, the routed
    encoder (its record and kernel summary entry are the path's), the
    k-means router, the facade's clustered autotune with its v3 bundle, and
    routed decode. Returns the routed encoder as a path of the kernel
    phase."""
    path = adaptive_encoder(model, device)
    adaptive_kmeans(model, path.pop("batches"), device)
    path.pop("router")
    adaptive_facade(model, device)
    adaptive_decode(decoder, device)
    return path


# ---------------------------------------------------------------------------
# http_path: the HTTP/SSE front-end and the serving CLIs
# ---------------------------------------------------------------------------


def _http_request(method: str, path: str, body=None) -> bytes:
    data = b"" if body is None else json.dumps(body).encode("utf-8")
    return (f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Content-Length: {len(data)}\r\n\r\n").encode("latin1") + data


async def http_exchange(port: int, method: str, path: str, body=None):
    """One request on its own connection, read to close (the front-end
    answers ``Connection: close``), within ``HTTP_EXCHANGE_S``:
    ``(status, headers, body bytes)``."""
    import asyncio

    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            writer.write(_http_request(method, path, body))
            await writer.drain()
            return await reader.read()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    raw = await asyncio.wait_for(go(), HTTP_EXCHANGE_S)
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(lines[0].split()[1]), headers, payload


async def http_json(port: int, method: str, path: str, body=None):
    status, headers, payload = await http_exchange(port, method, path, body)
    return status, headers, json.loads(payload)


async def http_sse(port: int, body):
    """``POST /v1/generate``: ``(status, [(event, data), ...])`` parsed by
    the port's ``protocol.parse_sse``."""
    from repro_torch.serve.frontend import protocol
    status, headers, payload = await http_exchange(port, "POST",
                                                   "/v1/generate", body)
    if headers.get("content-type") != "text/event-stream":
        return status, json.loads(payload)
    return status, protocol.parse_sse(payload.decode("utf-8"))


def run_http(fe, scenario):
    """Start ``fe``, run ``scenario(port)`` (which returns a dict) within
    ``HTTP_SESSION_S``, always stop it (a hard stop: 503 into anything
    still waiting); the dict gains ``listen_s``, the seconds to bind."""
    import asyncio

    async def main():
        t = time.perf_counter()
        await fe.start()
        listen_s = time.perf_counter() - t
        try:
            out = await asyncio.wait_for(scenario(fe.port), HTTP_SESSION_S)
        finally:
            await fe.stop()
        out["listen_s"] = listen_s
        return out

    return asyncio.run(main())


def _quiet(*args, **kw):
    pass


def _server_argv(plan_path, *extra):
    return ["--plan", str(plan_path), "--backend", "fused", "--slots",
            str(HTTP_SLOTS), "--max-len", str(HTTP_MAX_LEN), "--port", "0",
            *extra]


def http_encoder(model, tmp, device, card):
    """Full-width BERT-base over HTTP, in process: ``build_frontend`` on
    the server's argv (the tiled golden plan from a file, the fused
    backend), ``main_path``'s 32 requests from concurrent clients (a
    warm-up pass, the counted pass, a timed pass), every response held
    bit for bit against a direct engine over the front-end's own params
    and plan fed the very batches the micro-batcher made, and against the
    reference backend; the front-end's kernels counted per forward. Then
    admission (429), deadline (504) and drain (503) on engines sharing its
    runtime."""
    import asyncio
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.launch.server import (build_frontend, load_kernels,
                                           make_parser)
    from repro_torch.serve import EncoderRequest, EncoderServeEngine
    from repro_torch.serve.metrics import CORE_METRICS

    plan_path = tmp / "golden_x3.json"
    model["plan"].save(str(plan_path))
    args = make_parser().parse_args(
        ["--arch", "bert-base", "--task", "tnews"]
        + _server_argv(plan_path))
    t0 = time.perf_counter()
    fe = build_frontend(args, log=_quiet)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_kernels(fe, log=_quiet)
    kernels_s = time.perf_counter() - t0
    eng = fe.encoder
    cfg = eng.cfg
    if cfg.num_layers != 12 or cfg.d_model != 768 or cfg.vocab_size != 21128:
        fail(f"http_path: --device cuda built {cfg.name} at "
             f"{cfg.num_layers} layers x {cfg.d_model}, not full width")
    requests = model["requests"]
    batches = []                     # the micro-batches, as flushed
    ready = eng.batcher.ready

    def spy(now=None, force=False):
        out = ready(now, force)
        batches.extend([list(reqs) for _, reqs in out])
        return out
    eng.batcher.ready = spy

    async def burst(port):
        t = time.perf_counter()
        res = await asyncio.gather(*(http_json(
            port, "POST", "/v1/encode", {"tokens": toks})
            for toks in requests))
        return res, time.perf_counter() - t

    async def scenario(port):
        out = {}
        t = time.perf_counter()
        await burst(port)                              # warm-up
        batches.clear()
        calls = eng.runtime.stats["calls"]
        kernels.reset_launches()
        out["results"], out["wall"] = await burst(port)
        out["launches"] = kernels.launch_counts()
        out["forwards"] = eng.runtime.stats["calls"] - calls
        out["batches"] = list(batches)
        _, out["wall_2"] = await burst(port)
        _, _, m = await http_exchange(port, "GET", "/metrics")
        out["metrics"] = m.decode("utf-8")
        out["health"] = await http_json(port, "GET", "/healthz")
        out["p50"] = fe.driver.latency.quantile(0.5)
        out["p95"] = fe.driver.latency.quantile(0.95)
        out["session_s"] = time.perf_counter() - t
        return out

    got = run_http(fe, scenario)
    eng.batcher.ready = ready

    # replay each micro-batch, in its order, through direct engines
    def replay(backend):
        direct = EncoderServeEngine(cfg, eng.params, eng.plan,
                                    target=eng.target, backend=backend,
                                    max_batch=HTTP_SLOTS,
                                    max_len=HTTP_MAX_LEN, device=device)
        out = {}
        for group in got["batches"]:
            calls = direct.runtime.stats["calls"]
            for r in group:
                direct.submit(EncoderRequest(uid=r.uid,
                                             tokens=list(r.tokens)))
            done = direct.run()
            if direct.runtime.stats["calls"] - calls != 1:
                fail(f"http_path: a micro-batch of {len(group)} took "
                     f"{direct.runtime.stats['calls'] - calls} forwards "
                     f"in the direct engine")
            out.update({r.uid: r for r in done})
        return out, direct

    fused, direct = replay("fused")
    reference, _ = replay("reference")
    _, direct_wall = serve(direct, requests)           # warm, then timed
    _, direct_wall = serve(direct, requests)
    statuses = [s for s, _, _ in got["results"]]
    objs = {o["uid"]: o for s, _, o in got["results"] if s == 200}
    if statuses != [200] * N_REQUESTS or sorted(objs) != sorted(fused):
        fail(f"http_path: statuses {collections.Counter(statuses)}, "
             f"{len(objs)} answers for {len(fused)} batched requests")
    http = np.stack([np.asarray(objs[u]["logits"], np.float32)
                     for u in sorted(objs)])
    dfused = np.stack([fused[u].logits for u in sorted(objs)])
    dref = np.stack([reference[u].logits for u in sorted(objs)])
    diff = float(np.abs(http - dfused).max())
    ref_err = rel_linf(torch.from_numpy(dref), torch.from_numpy(dfused))
    preds = [objs[u]["prediction"] for u in sorted(objs)]
    dpreds = [int(fused[u].prediction) for u in sorted(objs)]
    rpreds = [int(reference[u].prediction) for u in sorted(objs)]
    cases = kernel_cases(cfg, model["plan"])
    per_fwd = collections.Counter()
    for key, case in cases.items():
        per_fwd[key[0]] += case["count"]
    launches, forwards = got["launches"], got["forwards"]
    want = {k: per_fwd[k] * forwards for k in launches}
    missing = [n for n in CORE_METRICS if n not in got["metrics"]]
    rec = {"phase": "http_path", "part": "encode", "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "plan_fingerprint":
           PrecisionPlan.load(str(plan_path)).fingerprint(), "card": card,
           "build_frontend_s": build_s, "load_kernels_s": kernels_s,
           "listen_s": got["listen_s"], "session_s": got["session_s"],
           "requests": N_REQUESTS, "forwards": forwards,
           "micro_batches": [len(g) for g in got["batches"]],
           "buckets": eng.runtime.stats["buckets"],
           "http_wall_s": [got["wall"], got["wall_2"]],
           "http_requests_per_s": [N_REQUESTS / got["wall"],
                                   N_REQUESTS / got["wall_2"]],
           "direct_wall_s": direct_wall,
           "direct_requests_per_s": N_REQUESTS / direct_wall,
           "latency_p50_s": got["p50"], "latency_p95_s": got["p95"],
           "latency_samples": fe.driver.latency.count,
           "http_vs_direct_max_abs": diff,
           "predictions_equal_direct": preds == dpreds,
           "reference_rel_linf": ref_err,
           "reference_predictions_equal": rpreds == dpreds,
           "launches": launches, "expected_launches": want,
           "launches_per_forward": dict(per_fwd),
           "metrics_missing": missing, "healthz": got["health"][2]}
    emit(rec)
    if rec["plan_fingerprint"] != GOLDEN_FINGERPRINT:
        fail(f"http_path: the plan file holds {rec['plan_fingerprint']}, "
             f"not the tiled golden plan")
    if diff != 0.0 or preds != dpreds:
        fail(f"http_path: HTTP logits differ from the direct engine's at "
             f"the same buckets by {diff}, predictions equal "
             f"{preds == dpreds}")
    if ref_err > REL_LINF_BUDGET or rpreds != dpreds:
        fail(f"http_path: the reference backend is {ref_err} rel-Linf "
             f"away, predictions equal {rpreds == dpreds}")
    if dict(per_fwd) != EXPECTED["main_path"]:
        fail(f"http_path: the plan implies {dict(per_fwd)} launches per "
             f"forward, not {EXPECTED['main_path']}")
    if forwards != len(got["batches"]) or launches != want \
            or any(launches[k] == 0 for k in per_fwd):
        fail(f"http_path: {launches} launches over {forwards} forwards "
             f"({len(got['batches'])} micro-batches), plan-implied {want}")
    if missing:
        fail(f"http_path: /metrics lacks {missing}")
    http_admission(eng, device, card)
    path = {"name": "http_path", "cfg": cfg, "launches": launches,
            "per_fwd": per_fwd, "cases": cases,
            "buckets": sorted(set(map(tuple, eng.runtime.stats["buckets"]))
                              | {PROFILE_BUCKET}),
            "timed_bucket": PROFILE_BUCKET, "unit": "forward"}
    return path, rec


def http_admission(eng, device, card):
    """Admission control on the card, on engines sharing the encoder
    front-end's runtime, each held as ``tests/test_frontend.py`` holds it:
    6 concurrent clients against ``max_pending=2`` (4 answered 429 +
    ``Retry-After: 1``), a queued request past its 100 ms deadline (504,
    evicted, never batched) and ``begin_drain`` with one request in flight
    (200 for it, 503 + ``Retry-After: 5`` for a new one; the forced flush
    waits at a gate until the 503 is read)."""
    import asyncio
    import threading
    from repro_torch.serve import EncoderServeEngine
    from repro_torch.serve.frontend import HTTPFrontend

    def engine(max_wait):
        return EncoderServeEngine(eng.cfg, eng.params, eng.plan,
                                  target=eng.target, runtime=eng.runtime,
                                  max_batch=HTTP_SLOTS, max_wait=max_wait,
                                  max_len=HTTP_MAX_LEN, device=device)

    def toks(i):
        return [3 + i, 5, 9, 2]

    fe = HTTPFrontend(encoder=engine(0.5), port=0, max_pending=2,
                      log=_quiet)

    async def burst(port):
        res = await asyncio.gather(*(http_json(
            port, "POST", "/v1/encode", {"tokens": toks(i)})
            for i in range(6)))
        _, _, m = await http_exchange(port, "GET", "/metrics")
        return {"results": res, "metrics": m.decode("utf-8")}

    got = run_http(fe, burst)
    statuses = sorted(s for s, _, _ in got["results"])
    retry = sorted({h.get("retry-after") for s, h, _ in got["results"]
                    if s == 429})
    counted = ('samp_requests_rejected_total{reason="capacity"} 4'
               in got["metrics"])

    late_engine = engine(10.0)
    late = HTTPFrontend(encoder=late_engine, port=0, log=_quiet)

    async def deadline(port):
        t = time.perf_counter()
        res = await http_json(port, "POST", "/v1/encode",
                              {"tokens": toks(0), "deadline_ms": 100})
        return {"result": res, "took": time.perf_counter() - t}

    dl = run_http(late, deadline)

    drain_engine = engine(30.0)
    gate = threading.Event()
    step = drain_engine.step

    def gated(now=None, force=False):
        if force:
            gate.wait(HTTP_SESSION_S)
        return step(now, force)
    drain_engine.step = gated
    dfe = HTTPFrontend(encoder=drain_engine, port=0, log=_quiet)

    async def drain(port):
        try:
            inflight = asyncio.create_task(http_json(
                port, "POST", "/v1/encode", {"tokens": toks(1)}))
            for _ in range(1000):
                if dfe.driver.inflight:
                    break
                await asyncio.sleep(0.01)
            dfe.begin_drain()
            rejected = await http_json(port, "POST", "/v1/encode",
                                       {"tokens": toks(2)})
        finally:
            gate.set()
        done = await inflight
        await asyncio.wait_for(dfe.serve_forever(), HTTP_SESSION_S)
        return {"done": done, "rejected": rejected}

    dr = run_http(dfe, drain)
    rec = {"phase": "http_path", "part": "admission", "card": card,
           "burst_statuses": statuses, "burst_retry_after": retry,
           "rejections_at_metrics": counted,
           "deadline_status": dl["result"][0],
           "deadline_s": dl["took"],
           "deadline_evicted": late_engine.batcher.evicted,
           "deadline_batches": late_engine._stats["batches"],
           "drain_inflight_status": dr["done"][0],
           "drain_new_status": dr["rejected"][0],
           "drain_retry_after": dr["rejected"][1].get("retry-after")}
    emit(rec)
    if statuses != [200, 200, 429, 429, 429, 429] or retry != ["1"] \
            or not counted or fe.driver.counts["rejected_capacity"] != 4:
        fail(f"http_path: 6 clients against max_pending 2 got {statuses}, "
             f"Retry-After {retry}, counted at /metrics {counted}")
    if dl["result"][0] != 504 or "deadline" not in dl["result"][2]["error"] \
            or dl["took"] >= 5.0 or late_engine.batcher.evicted != 1 \
            or late_engine._stats["batches"] != 0:
        fail(f"http_path: a request past its deadline: {rec}")
    if dr["done"][0] != 200 or "logits" not in dr["done"][2] \
            or dr["rejected"][0] != 503 \
            or dr["rejected"][1].get("retry-after") != "5":
        fail(f"http_path: drain answered {dr['done'][0]} in flight and "
             f"{dr['rejected'][0]} to a new request")


def http_decode(decoder, tmp, device, card):
    """Full-width qwen2-0.5b over SSE, in process: ``build_frontend`` on
    the server's argv (``--task lm``, the golden plan tiled 6x from a file,
    int8 per-token pages of 16, the fused backend), the 16 decode prompts
    as concurrent ``/v1/generate`` streams of 16 tokens (after a 2-stream
    warm-up), each stream's tokens held against a direct ``ServeEngine``
    over the front-end's own params and plan, the ticks' launches
    counted."""
    import asyncio
    import torch
    from repro_torch import kernels
    from repro_torch.launch.server import build_frontend, make_parser
    from repro_torch.serve import ServeEngine

    plan_path = tmp / "golden_x6.json"
    decoder["plan"].save(str(plan_path))
    args = make_parser().parse_args(
        ["--arch", "qwen2-0.5b", "--task", "lm", "--page-size",
         str(PAGE_SIZE), "--kv-dtype", "int8_per_token"]
        + _server_argv(plan_path))
    t0 = time.perf_counter()
    fe = build_frontend(args, log=_quiet)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng, prompts = fe.decode, decoder["prompts"]
    cfg = eng.cfg
    if fe.encoder is not None or cfg.num_layers != 24 \
            or cfg.d_model != 896:
        fail(f"http_path: --task lm built {cfg.name} at {cfg.num_layers} "
             f"layers x {cfg.d_model}, encoder {fe.encoder is not None}")

    async def scenario(port):
        out = {}
        await asyncio.gather(*(http_sse(port, {"prompt": p,
                                                "max_tokens": 4})
                               for p in prompts[:2]))   # warm-up
        ticks = eng.stats["ticks"]
        kernels.reset_launches()
        t = time.perf_counter()
        out["results"] = await asyncio.gather(*(http_sse(
            port, {"prompt": p, "max_tokens": DECODE_MAX_TOKENS})
            for p in prompts))
        out["wall"] = time.perf_counter() - t
        out["launches"] = kernels.launch_counts()
        out["ticks"] = eng.stats["ticks"] - ticks
        out["pages_in_use"] = eng.kv_pages_in_use
        out["p50"] = fe.driver.latency.quantile(0.5)
        out["p95"] = fe.driver.latency.quantile(0.95)
        return out

    got = run_http(fe, scenario)
    direct = ServeEngine(cfg, eng.params, eng.plan,
                         batch_slots=HTTP_SLOTS, max_len=HTTP_MAX_LEN,
                         page_size=PAGE_SIZE, kv_cache="int8_per_token",
                         precision=eng.runtime.precision, backend="fused",
                         device=device)
    serve_decode(direct, prompts[:2], max_tokens=4)    # warm-up
    want, direct_wall = serve_decode(direct, prompts)
    streams, bad = {}, []
    for i, (status, events) in enumerate(got["results"]):
        toks = [d["token"] for e, d in events if e == "token"] \
            if status == 200 else None
        done = [d for e, d in events if e == "done"] if toks is not None \
            else []
        idx = [d["index"] for e, d in events if e == "token"] \
            if toks is not None else []
        streams[i] = toks
        if status != 200 or len(done) != 1 or done[0]["tokens"] != toks \
                or idx != list(range(len(toks))) \
                or len(toks) != DECODE_MAX_TOKENS:
            bad.append((i, status, len(done), toks and len(toks)))
    schemes = ("int8_per_token",) * cfg.num_layers
    cases = kernel_cases(cfg, decoder["plan"], schemes)
    per_tick = collections.Counter()
    for key, case in cases.items():
        per_tick[key[0]] += case["count"]
    launches, ticks = got["launches"], got["ticks"]
    expect = {k: per_tick[k] * ticks for k in launches}
    generated = len(prompts) * DECODE_MAX_TOKENS
    rec = {"phase": "http_path", "part": "generate", "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model, "card": card,
           "plan_fingerprint": eng.runtime.precision.fingerprint(),
           "build_frontend_s": build_s, "listen_s": got["listen_s"],
           "streams": len(prompts), "max_tokens": DECODE_MAX_TOKENS,
           "slots": HTTP_SLOTS, "page_size": PAGE_SIZE, "ticks": ticks,
           "sse_wall_s": got["wall"],
           "sse_generated_tokens_per_s": generated / got["wall"],
           "direct_wall_s": direct_wall,
           "direct_generated_tokens_per_s": generated / direct_wall,
           "latency_p50_s": got["p50"], "latency_p95_s": got["p95"],
           "tokens_equal_direct": streams == want,
           "bad_streams": bad, "kv_pages_in_use_after": got["pages_in_use"],
           "launches": launches, "expected_launches": expect,
           "launches_per_tick": dict(per_tick)}
    emit(rec)
    if bad:
        fail(f"http_path: malformed streams (index, status, done events, "
             f"tokens): {bad}")
    if streams != want:
        fail("http_path: SSE tokens differ from the direct ServeEngine's")
    if got["pages_in_use"] or direct.kv_pages_in_use:
        fail(f"http_path: {got['pages_in_use']} pages in use after the "
             f"streams")
    if dict(per_tick) != EXPECTED_DECODE:
        fail(f"http_path: the plan implies {dict(per_tick)} launches per "
             f"tick, not {EXPECTED_DECODE}")
    if launches != expect or any(launches[k] == 0 for k in per_tick):
        fail(f"http_path: {launches} launches over {ticks} ticks, "
             f"plan-implied {expect}")
    path = {"name": "http_decode_path", "cfg": cfg, "launches": launches,
            "per_fwd": per_tick, "cases": cases, "buckets": [DECODE_BUCKET],
            "timed_bucket": DECODE_BUCKET, "unit": "tick"}
    return path, rec


def http_cli(model, tmp, card):
    """The entry points as a user starts them, as subprocesses: the server
    (``--port 0``; its port read from its ``listening on`` line; 8
    ``/v1/encode`` requests and ``/healthz``; SIGTERM; exit 0 within
    ``HTTP_EXIT_S``) and the one-shot serve CLI on qwen2-0.5b (exit 0)."""
    import asyncio
    import os
    import queue
    import re
    import signal
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = [sys.executable, "-m", "repro_torch.launch.server", "--arch",
            "bert-base", "--task", "tnews"] + _server_argv(tmp /
                                                         "golden_x3.json")
    err = (tmp / "server.err").open("w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err,
                            text=True, cwd=ROOT, env=env)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout]
                     + [lines.put(None)], daemon=True).start()
    out, port, start_s = [], None, None
    try:
        while port is None:
            left = HTTP_START_S - (time.perf_counter() - t0)
            try:
                line = lines.get(timeout=max(left, 0.0))
            except queue.Empty:
                fail(f"http_path: the server printed no listening line in "
                     f"{HTTP_START_S} s: {out}")
            if line is None:
                fail(f"http_path: the server exited ({proc.wait()}) before "
                     f"listening: {out} "
                     f"{(tmp / 'server.err').read_text()[-2000:]}")
            out.append(line.rstrip())
            m = re.search(r"listening on http://[\d.]+:(\d+)", line)
            if m:
                port, start_s = int(m.group(1)), time.perf_counter() - t0

        async def scenario():
            health = await http_json(port, "GET", "/healthz")
            res = await asyncio.gather(*(http_json(
                port, "POST", "/v1/encode", {"tokens": toks})
                for toks in model["requests"][:HTTP_CLI_ENCODES]))
            return health, res

        health, res = asyncio.run(scenario())
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(HTTP_EXIT_S)
        except subprocess.TimeoutExpired:
            fail(f"http_path: the server did not exit within {HTTP_EXIT_S} "
                 f"s of SIGTERM")
        exit_s = time.perf_counter() - t
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    while (line := lines.get(timeout=HTTP_EXIT_S)) is not None:
        out.append(line.rstrip())
    loaded = [ln for ln in out if "kernels loaded" in ln]
    t = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-0.5b", "--policy", "ffn", "--backend", "fused",
         "--requests", str(HTTP_CLI_REQUESTS), "--max-tokens",
         str(HTTP_CLI_TOKENS)], capture_output=True, text=True,
        timeout=HTTP_CLI_S, cwd=ROOT, env=env)
    cli_s = time.perf_counter() - t
    summary = [ln for ln in cli.stdout.splitlines()
               if ln.startswith("[serve] backend=")]
    statuses = [s for s, _, _ in res]
    rec = {"phase": "http_path", "part": "cli", "card": card,
           "server_start_s": start_s, "server_kernels_line": loaded,
           "server_healthz": health[2], "server_encode_statuses": statuses,
           "server_exit_code": rc, "server_exit_s": exit_s,
           "server_last_line": out[-1] if out else None,
           "serve_cli_exit_code": cli.returncode, "serve_cli_s": cli_s,
           "serve_cli_summary": summary}
    emit(rec)
    if health[0] != 200 or statuses != [200] * HTTP_CLI_ENCODES or any(
            len(o["logits"]) != 15 for _, _, o in res):
        fail(f"http_path: the server subprocess answered /healthz "
             f"{health[0]} and /v1/encode {statuses}")
    if rc != 0 or "drained; bye" not in out[-1] or len(loaded) != 1:
        fail(f"http_path: the server exited {rc} after SIGTERM: {out} "
             f"{(tmp / 'server.err').read_text()[-2000:]}")
    if cli.returncode != 0 or not summary:
        fail(f"http_path: launch.serve exited {cli.returncode}: "
             f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    return rec


def phase_http(model, decoder, device, card):
    """``http_path``: the HTTP/SSE front-end and the serving CLIs on the
    card. Returns the encoder and the decode front-end as paths of the
    kernel phase."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="samp_http_"))
    try:
        enc_path, enc = http_encoder(model, tmp, device, card)
        dec_path, dec = http_decode(decoder, tmp, device, card)
        cli = http_cli(model, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "http_path", "part": "summary", "card": card,
          "http_requests_per_s": enc["http_requests_per_s"],
          "direct_requests_per_s": enc["direct_requests_per_s"],
          "encode_latency_p50_s": enc["latency_p50_s"],
          "encode_latency_p95_s": enc["latency_p95_s"],
          "sse_generated_tokens_per_s": dec["sse_generated_tokens_per_s"],
          "direct_generated_tokens_per_s":
              dec["direct_generated_tokens_per_s"],
          "generate_latency_p50_s": dec["latency_p50_s"],
          "generate_latency_p95_s": dec["latency_p95_s"],
          "encoder_startup_s": {"build_frontend": enc["build_frontend_s"],
                                "load_kernels": enc["load_kernels_s"],
                                "listen": enc["listen_s"]},
          "decoder_startup_s": {"build_frontend": dec["build_frontend_s"],
                                "listen": dec["listen_s"]},
          "server_subprocess_start_s": cli["server_start_s"],
          "phase_s": time.perf_counter() - t0})
    return [enc_path, dec_path]


def setup_moe(device):
    """Full-width mixtral-8x22b cut to :data:`MOE_LAYERS` layers under the
    golden v4 plan's first layers, with seeded float weights on the card,
    its calibration batches and the decode requests. Resets the card's peak-memory counter: the phase's peak
    covers the float model, calibration, PTQ and serving."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T

    full = get_config("mixtral-8x22b")
    cfg = full.replace(num_layers=MOE_LAYERS)
    v4 = PrecisionPlan.load(str(GOLDEN_V4))
    if v4.fingerprint() != MOE_FINGERPRINT:
        fail(f"golden v4 plan fingerprint {v4.fingerprint()} is not the "
             f"JAX package's {MOE_FINGERPRINT}")
    plan = PrecisionPlan(v4.layers[:MOE_LAYERS], v4.float_dtype)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    float_policy = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, float_policy, seed=0, device=device)
    B, S = MOE_FORWARD
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=B,
                                            seq_len=S, seed=0)
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 65, DECODE_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    n_params = sum(t.numel() for t in _tensors(params))
    emit({"phase": "setup_moe", "model": cfg.name, "layers": cfg.num_layers,
          "of_layers": full.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "experts": cfg.moe.num_experts,
          "top_k": cfg.moe.top_k, "d_ff_expert": cfg.moe.d_ff_expert,
          "vocab": cfg.vocab_size, "sliding_window": cfg.sliding_window,
          "float_params": n_params, "float_bytes": 4 * n_params,
          "plan": plan.describe(), "plan_fingerprint": plan.fingerprint(),
          "requests": DECODE_REQUESTS, "prompt_tokens": int(lengths.sum()),
          "init_s": time.perf_counter() - t0})
    return {"cfg": cfg, "plan": plan, "params": params, "batches": batches,
            "float_plan": T.build_plan(cfg, float_policy),
            "prompts": prompts}


def _tensors(tree):
    """Every tensor of a parameter tree (int8 values and scales of the
    quantized leaves included)."""
    import torch
    from repro_torch.core.quantize import QuantizedTensor
    if isinstance(tree, QuantizedTensor):
        yield tree.values
        yield tree.scale
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class MoEDrops:
    """Counts, over a served run, the (slot, expert) routings that expert
    capacity dropped, in all and for the slots live at that tick: a spy
    around ``models.layers._dispatch_one``, removed on exit. ``on_tick``
    (a ``Ticks`` hook) records each tick's active slots; the counts stay on
    the device until read."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.orig = L, L._dispatch_one
        self.live = None
        self.all = self.live_dropped = self.live_routed = 0

        def dispatch(xt, logits, E, K, C):
            out = self.orig(xt, logits, E, K, C)
            _, st, _, keep, _ = out
            rows = xt.shape[0] // self.live.shape[0]     # tokens per slot
            live = self.live.repeat_interleave(rows)
            self.all = self.all + L.dropped_routings(keep, st)
            self.live_dropped = self.live_dropped + L.dropped_routings(
                keep, st, live.to(xt.device))
            self.live_routed += K * int(live.sum())
            return out
        L._dispatch_one = dispatch
        return self

    def on_tick(self, pos, active):
        import torch
        self.live = torch.from_numpy(active.copy())     # on the host

    def counts(self) -> dict:
        return {"routings_of_live_slots": int(self.live_routed),
                "dropped_of_live_slots": int(self.live_dropped),
                "dropped_all_slots": int(self.all)}

    def __exit__(self, *exc):
        self.L._dispatch_one = self.orig


def phase_moe(model, device):
    """Calibrate and quantize mixtral under the golden v4 plan, drop the
    float tree, serve the requests on the fused backend (counters zeroed
    just before the counted run, read just after) and on the reference
    backend, and check them as the decode paths are checked."""
    import statistics as st
    import torch
    from repro_torch import kernels
    from repro_torch.quant import ptq
    from repro_torch.serve import ServeEngine

    cfg, plan = model["cfg"], model["plan"]
    t0 = time.perf_counter()
    stats = ptq.capture_stats(model["params"], model["batches"], cfg,
                              model["float_plan"], precision=plan)
    qparams, qplan = ptq.apply_plan(model["params"], cfg, plan, stats,
                                    float_plan=model["float_plan"])
    torch.cuda.synchronize()
    ptq_peak = torch.cuda.max_memory_allocated(device)
    # the float tree goes: qparams keeps only what the plan left float
    model["params"] = None
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    q_bytes = sum(t.numel() * t.element_size() for t in _tensors(qparams))
    kw = dict(batch_slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN,
              page_size=PAGE_SIZE, precision=plan, device=device)
    prompts = model["prompts"]
    serve_decode(ServeEngine(cfg, qparams, qplan, backend="fused", **kw),
                 prompts[:2], max_tokens=4)            # warm-up, not counted

    fused = ServeEngine(cfg, qparams, qplan, backend="fused", **kw)
    with SubCounts() as sub:
        ticks = Ticks(fused)
        kernels.reset_launches()
        outputs, wall = serve_decode(fused, prompts)
        launches = kernels.launch_counts()
        per_token = kernels.expert_gemm.per_token_launches
    fused._decode = ticks.step          # the profile times the bare engine
    n_ticks = fused.stats["ticks"]
    in_use = fused.kv_pages_in_use

    reference = ServeEngine(cfg, qparams, qplan, backend="reference", **kw)
    ref_ticks = Ticks(reference, against=ticks)
    ref_outputs, ref_wall = serve_decode(reference, prompts)
    in_use_ref = reference.kv_pages_in_use

    # the capacity drops, counted on fresh engines apart from the timed
    # runs (the spy copies each tick's live mask to the device); the
    # counted runs must serve the same tokens
    dropped, drop_tokens_equal = {}, True
    for backend in ("fused", "reference"):
        engine = ServeEngine(cfg, qparams, qplan, backend=backend, **kw)
        with MoEDrops() as drops:
            Ticks(engine, on_tick=drops.on_tick)
            counted, _ = serve_decode(engine, prompts)
            dropped[backend] = drops.counts()
        drop_tokens_equal &= counted == outputs
        del engine
    peak = torch.cuda.max_memory_allocated(device)

    cases = kernel_cases(cfg, plan, plan.kv_schemes)
    per_tick, sub_tick = collections.Counter(), collections.Counter()
    for key, case in cases.items():
        per_tick[key[0]] += case["count"]
        if case["sub"]:
            sub_tick[case["sub"]] += case["count"]
    want = {k: per_tick[k] * n_ticks for k in launches}
    subs = dict(sub.counts)
    subs["quant_expert_gemm with per-token scales"] = per_token
    generated = sum(len(o) for o in outputs.values())
    slot_tokens = fused.stats["tokens"]
    E = cfg.moe.num_experts
    capacity = max(1, math.ceil(cfg.moe.capacity_factor * DECODE_SLOTS
                                * cfg.moe.top_k / E))
    rec = {"phase": "moe_decode_path", "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "plan": plan.describe(), "plan_fingerprint": plan.fingerprint(),
           "kv_schemes": list(plan.kv_schemes), "setup_s": setup_s,
           "requests": len(prompts), "slots": DECODE_SLOTS,
           "max_len": DECODE_MAX_LEN, "expert_capacity": capacity,
           "ticks": n_ticks, "slot_tokens": slot_tokens,
           "generated_tokens": generated, "wall_s": wall,
           "tokens_per_s": slot_tokens / wall,
           "generated_tokens_per_s": generated / wall,
           "median_tick_ms": st.median(ticks.walls) * 1e3,
           "reference_wall_s": ref_wall,
           "reference_median_tick_ms": st.median(ref_ticks.walls) * 1e3,
           "launches": launches, "expected_launches": want,
           "launches_per_tick": dict(per_tick),
           "sub_counts": subs, "sub_counts_per_tick": dict(sub_tick),
           "expert_capacity_drops": dropped,
           "drop_count_runs_tokens_equal": drop_tokens_equal,
           "ticks_compared": ref_ticks.compared,
           "fused_vs_reference_rel_linf": ref_ticks.max_rel,
           "tokens_equal": outputs == ref_outputs,
           "kv_pages_in_use_after": [in_use, in_use_ref],
           "kv_cache_bytes": fused.kv_cache_bytes,
           "page_pool": fused.pool is not None,
           "quantized_params_bytes": q_bytes,
           "ptq_peak_memory_bytes": ptq_peak,
           "peak_memory_bytes": peak,
           "memory_allocated_after_bytes": torch.cuda.memory_allocated(
               device)}
    emit(rec)
    if not drop_tokens_equal:
        fail("moe_decode_path: the runs that count capacity drops served "
             "other tokens")
    if outputs != ref_outputs:
        fail("moe_decode_path: fused and reference tokens differ")
    if sorted(outputs) != list(range(len(prompts))) or any(
            len(o) != DECODE_MAX_TOKENS or not all(0 <= t < cfg.vocab_size
                                                   for t in o)
            for o in outputs.values()) or not ticks.finite:
        fail(f"moe_decode_path: outputs are not {DECODE_MAX_TOKENS} "
             f"in-vocabulary tokens per request from finite logits")
    if ref_ticks.compared == 0 or ref_ticks.max_rel > REL_LINF_BUDGET:
        fail(f"moe_decode_path: fused vs reference logits rel-Linf "
             f"{ref_ticks.max_rel} over {ref_ticks.compared} ticks (budget "
             f"{REL_LINF_BUDGET})")
    if dict(per_tick) != EXPECTED_MOE or dict(sub_tick) != EXPECTED_MOE_SUB:
        fail(f"moe_decode_path: the plan implies {dict(per_tick)} launches "
             f"per tick with {dict(sub_tick)}, not {EXPECTED_MOE} with "
             f"{EXPECTED_MOE_SUB}")
    if launches != want or any(launches[k] == 0 for k in EXPECTED_MOE):
        fail(f"moe_decode_path: launch counts {launches} != plan-implied "
             f"{want}")
    if subs != {k: n * n_ticks for k, n in EXPECTED_MOE_SUB.items()}:
        fail(f"moe_decode_path: sub-counts {subs} over {n_ticks} ticks; "
             f"the plan implies {EXPECTED_MOE_SUB} per tick")
    if in_use or in_use_ref or fused.pool is None:
        fail(f"moe_decode_path: page pool {fused.pool is not None}, "
             f"{in_use} / {in_use_ref} pages still in use after the run")
    if len(sub.expert_args) != 4:
        fail(f"moe_decode_path: captured {sorted(sub.expert_args)} expert "
             f"GEMM classes, not the 4 of the plan")
    B, S = MOE_FORWARD
    prefill_c = max(1, math.ceil(cfg.moe.capacity_factor * B * S
                                 * cfg.moe.top_k / E))
    return {"name": "moe_decode_path", "cfg": cfg, "qparams": qparams,
            "fused": fused, "launches": launches, "per_fwd": per_tick,
            "cases": cases, "buckets": [DECODE_BUCKET],
            "timed_bucket": DECODE_BUCKET, "capacities": [capacity,
                                                          prefill_c],
            "timed_capacity": capacity, "unit": "tick",
            "expert_args": sub.expert_args, "prompts": prompts}


def setup_arch(arch, device):
    """Full-width ``arch`` (cut to :data:`ARCH_CUTS` layers where its float
    tree must fit beside PTQ on one card) with seeded float32 weights on the
    card, 2 calibration batches of 4 x 128 (frames for an audio arch, 256
    prefix embeddings beside the tokens for a vision one) and
    :data:`ARCH_PROMPTS` decode prompts (8-64 tokens uniform over the vocab,
    numpy seed 0). Resets the card's peak-memory counter: the phase's peak
    covers the float model, calibration, PTQ and serving."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T

    full = get_config(arch)
    cfg = full.replace(num_layers=ARCH_CUTS.get(arch, full.num_layers))
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    float_policy = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, float_policy, seed=0, device=device)
    B, S = MOE_FORWARD
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=B,
                                            seq_len=S, seed=0)
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 65, ARCH_PROMPTS)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    n_params = sum(t.numel() for t in _tensors(params))
    rec = {"phase": "setup_arch", "model": cfg.name,
           "layers": cfg.num_layers, "of_layers": full.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "float_params": n_params, "float_bytes": 4 * n_params,
           "init_s": time.perf_counter() - t0}
    if cfg.moe is not None:
        rec.update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                   shared_experts=cfg.moe.num_shared,
                   d_ff_expert=cfg.moe.d_ff_expert)
    if cfg.mla is not None:
        rec["mla"] = dataclasses.asdict(cfg.mla)
    emit(rec)
    return {"cfg": cfg, "params": params, "batches": batches,
            "float_plan": T.build_plan(cfg, float_policy),
            "prompts": prompts, "t0": t0}


def arch_plan(name, cfg):
    """The plan each slice-13 path serves: the golden plan's four layers
    tiled over the depth (``setup_decoder``'s rule for qwen2, cut at the
    last layer), for hubert its ``int8_dataflow_variant`` (the span), for
    deepseek-v2 ``quant_ffn_only`` on every layer with the experts family
    (``tests/test_conformance.py``'s MoE plan)."""
    from repro_torch.core.plan import PrecisionPlan, plan_from_policy
    from repro_torch.core.precision import make_policy
    from repro_torch.core.samp import (int8_dataflow_variant,
                                       moe_family_variant)
    if name == "mla_decode_path":
        return moe_family_variant(plan_from_policy(
            make_policy(cfg, "ffn", float_dtype="float32")))
    golden = PrecisionPlan.load(str(GOLDEN_PLAN))
    reps = -(-cfg.num_layers // golden.num_layers)
    plan = PrecisionPlan((golden.layers * reps)[:cfg.num_layers],
                         golden.float_dtype)
    return int8_dataflow_variant(plan) if name == "hubert_encode_path" \
        else plan


def quantize_arch(model, plan, device):
    """Calibrate and quantize the float model under ``plan``, then drop the
    float tree (``qparams`` keeps what the plan left float). Returns
    (qparams, qplan, the PTQ peak device bytes)."""
    import torch
    from repro_torch.quant import ptq
    cfg = model["cfg"]
    stats = ptq.capture_stats(model["params"], model["batches"], cfg,
                              model["float_plan"], precision=plan)
    qparams, qplan = ptq.apply_plan(model["params"], cfg, plan, stats,
                                    float_plan=model["float_plan"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    model["params"] = None
    gc.collect()
    torch.cuda.empty_cache()
    return qparams, qplan, peak


def per_pass(cases):
    """Launches per forward or tick of each kernel, and of each sub-count
    variant, from :func:`kernel_cases`."""
    per, sub = collections.Counter(), collections.Counter()
    for key, case in cases.items():
        per[key[0]] += case["count"]
        if case["sub"]:
            sub[case["sub"]] += case["count"]
    return per, sub


def check_launches(name, per, sub, launches, subs, n):
    """The launches a run of ``n`` forwards or ticks counted against the
    plan's (``per``, ``sub`` a pass, from :func:`kernel_cases`) and against
    :data:`EXPECTED_ARCHS`: every kernel the plan names ran, ``fused_embed``
    never (no arch here has learned positions)."""
    want_per = EXPECTED_ARCHS[name]
    if dict(per) != want_per:
        fail(f"{name}: the plan implies {dict(per)} launches per pass, not "
             f"{want_per}")
    # every kernel's count against the plan's, so a plan that names no
    # kernel (xlstm's blocks) holds each count to 0
    want = {k: per[k] * n for k in launches}
    if launches != want or any(launches[k] == 0 for k in want_per) \
            or launches["fused_embed"]:
        fail(f"{name}: launch counts {launches} != plan-implied {want}")
    want_sub = {k: v * n for k, v in sub.items()}
    if {k: v for k, v in subs.items() if v} != want_sub:
        fail(f"{name}: sub-counts {subs} over {n} passes; the plan implies "
             f"{dict(sub)} a pass")


def serve_arch_decode(name, model, qparams, qplan, plan, device, *,
                      page_size=PAGE_SIZE, kv_cache=None):
    """Serve the model's prompts (:data:`ARCH_MAX_TOKENS` greedy tokens
    each, 8 slots, max_len 128, paged) on the fused backend (counters zeroed
    just before the counted run, read just after) and on the reference
    backend, and check them as the decode paths are checked: identical
    tokens, logits within rel-Linf 5e-3 at every tick both engines saw, the
    plan's launches a tick exactly, 0 pages in use after. An MoE model's
    runs also count the routings expert capacity dropped."""
    import statistics as st
    import torch
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    cfg, prompts = model["cfg"], model["prompts"]
    kw = dict(batch_slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN,
              page_size=page_size, kv_cache=kv_cache, precision=plan,
              device=device)
    schemes = ((kv_cache,) * cfg.num_layers if kv_cache is not None
               else plan.kv_schemes)
    serve_decode(ServeEngine(cfg, qparams, qplan, backend="fused", **kw),
                 prompts[:2], max_tokens=4)            # warm-up, not counted
    moe = cfg.moe is not None
    fused = ServeEngine(cfg, qparams, qplan, backend="fused", **kw)
    with SubCounts() as sub, MoEDrops() as drops:
        longest = [-1]

        def on_tick(pos, active):
            drops.on_tick(pos, active)
            total = int((pos + 1)[active].sum())
            if total >= longest[0]:
                longest[0], sub.capture = total, True
        ticks = Ticks(fused, on_tick=on_tick)
        kernels.reset_launches()
        outputs, wall = serve_decode(fused, prompts, ARCH_MAX_TOKENS)
        launches = kernels.launch_counts()
        subs = dict(sub.counts)
        subs["quant_expert_gemm with per-token scales"] = \
            kernels.expert_gemm.per_token_launches
        dropped = {"fused": drops.counts()}
    fused._decode = ticks.step
    n_ticks = fused.stats["ticks"]
    in_use = fused.kv_pages_in_use
    reference = ServeEngine(cfg, qparams, qplan, backend="reference", **kw)
    with MoEDrops() as drops:
        ref_ticks = Ticks(reference, against=ticks, on_tick=drops.on_tick)
        ref_outputs, ref_wall = serve_decode(reference, prompts,
                                             ARCH_MAX_TOKENS)
        dropped["reference"] = drops.counts()
    in_use_ref = reference.kv_pages_in_use
    cases = kernel_cases(cfg, plan, schemes, page_size)
    per_tick, sub_tick = per_pass(cases)
    generated = sum(len(o) for o in outputs.values())
    rec = {"phase": name, "model": cfg.name, "layers": cfg.num_layers,
           "plan": plan.describe(), "plan_fingerprint": plan.fingerprint(),
           "kv_schemes": sorted(set(schemes)), "requests": len(prompts),
           "slots": DECODE_SLOTS, "page_size": page_size,
           "max_len": DECODE_MAX_LEN, "ticks": n_ticks,
           "slot_tokens": fused.stats["tokens"],
           "generated_tokens": generated, "wall_s": wall,
           "tokens_per_s": fused.stats["tokens"] / wall,
           "generated_tokens_per_s": generated / wall,
           "median_tick_ms": st.median(ticks.walls) * 1e3,
           "reference_wall_s": ref_wall,
           "reference_median_tick_ms": st.median(ref_ticks.walls) * 1e3,
           "launches": launches, "launches_per_tick": dict(per_tick),
           "sub_counts": subs, "sub_counts_per_tick": dict(sub_tick),
           "ticks_compared": ref_ticks.compared,
           "fused_vs_reference_rel_linf": ref_ticks.max_rel,
           "tokens_equal": outputs == ref_outputs,
           "kv_pages_in_use_after": [in_use, in_use_ref],
           "kv_cache_bytes": fused.kv_cache_bytes,
           "cache_layers": {"paged": sum("pages_pos" in c
                                         for c in fused.caches),
                            "ring": sum("k_pos" in c
                                        for c in fused.caches)},
           "kv_geometry": list(T.kv_geometry(fused.caches)),
           "longest_tick_tokens": longest[0]}
    if moe:
        E = cfg.moe.num_experts
        rec["expert_capacity"] = max(1, math.ceil(
            cfg.moe.capacity_factor * DECODE_SLOTS * cfg.moe.top_k / E))
        rec["expert_capacity_drops"] = dropped
    emit(rec)
    if outputs != ref_outputs:
        fail(f"{name}: fused and reference tokens differ")
    if sorted(outputs) != list(range(len(prompts))) or any(
            len(o) != ARCH_MAX_TOKENS or not all(0 <= t < cfg.vocab_size
                                                 for t in o)
            for o in outputs.values()) or not ticks.finite:
        fail(f"{name}: outputs are not {ARCH_MAX_TOKENS} in-vocabulary "
             f"tokens per request from finite logits")
    if ref_ticks.compared == 0 or ref_ticks.max_rel > REL_LINF_BUDGET:
        fail(f"{name}: fused vs reference logits rel-Linf "
             f"{ref_ticks.max_rel} over {ref_ticks.compared} ticks (budget "
             f"{REL_LINF_BUDGET})")
    check_launches(name, per_tick, sub_tick, launches, subs, n_ticks)
    if in_use or in_use_ref or fused.pool is None:
        fail(f"{name}: page pool {fused.pool is not None}, {in_use} / "
             f"{in_use_ref} pages still in use after the run")
    if per_tick["decode_attention"] and sub.decode_args is None:
        fail(f"{name}: no decode_attention call was captured")
    out = {"name": name, "cfg": cfg, "qparams": qparams, "launches": launches,
           "per_fwd": per_tick, "cases": cases, "buckets": [DECODE_BUCKET],
           "timed_bucket": DECODE_BUCKET, "unit": "tick",
           "decode_args": sub.decode_args, "record": rec}
    if moe:
        B, S = MOE_FORWARD
        prefill_c = max(1, math.ceil(cfg.moe.capacity_factor * B * S
                                     * cfg.moe.top_k / cfg.moe.num_experts))
        out.update(expert_args=sub.expert_args, timed_capacity=rec[
            "expert_capacity"], capacities=[rec["expert_capacity"],
                                            prefill_c])
    return out


def encode_pair(cfg, qparams, qplan, device, batches, *, head):
    """``Runtime.encode`` of ``batches`` (each (inputs, lengths)) on a fused
    runtime (one warm-up pass, then counted) and on a reference one; returns
    the outputs of both, the launches and the wall of the counted pass."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve import Runtime
    rts = [Runtime(cfg, qplan, head=head, token_level=True, backend=b,
                   device=device) for b in ("fused", "reference")]
    for inputs, lengths in batches:
        rts[0].encode(qparams, inputs, lengths)      # warm-up, not counted
    with SubCounts() as sub:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fused = [rts[0].encode(qparams, i, n) for i, n in batches]
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
    t = time.perf_counter()
    ref = [rts[1].encode(qparams, i, n) for i, n in batches]
    return fused, ref, launches, dict(sub.counts), wall, \
        time.perf_counter() - t, rts[0].stats["buckets"]


def phase_hubert(model, device):
    """hubert-xlarge (:data:`ARCH_CUTS`), under the span (the tiled golden
    plan's ``int8_dataflow_variant``): :data:`HUBERT_SEQS` seeded frame sequences
    (T uniform in 16-128, 512 features, numpy seed 1) through
    ``Runtime.encode`` with their ``lengths``, :data:`HUBERT_BATCH` a call,
    on both backends: frame logits (``lm_head`` over the 504-code
    codebook) within rel-Linf 5e-3 and the predicted codes identical on
    every real frame; ``quant_flash_attention`` at head dim 80 (run padded
    to 128) in the span layers."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T

    name, cfg = "hubert_encode_path", model["cfg"]
    plan = arch_plan(name, cfg)
    qparams, qplan, ptq_peak = quantize_arch(model, plan, device)
    rng = np.random.default_rng(1)
    lengths = rng.integers(16, 129, HUBERT_SEQS).astype(np.int32)
    frames = rng.standard_normal((HUBERT_SEQS, int(lengths.max()),
                                  cfg.frontend_dim), dtype=np.float32)
    batches = []
    for i in range(0, HUBERT_SEQS, HUBERT_BATCH):
        n = lengths[i:i + HUBERT_BATCH]
        batches.append(({"frames": frames[i:i + HUBERT_BATCH,
                                          :int(n.max())]}, n))
    fused, ref, launches, subs, wall, ref_wall, buckets = encode_pair(
        cfg, qparams, qplan, device, batches,
        head=lambda p, x: T.unembed(x, p, cfg))
    errs, equal, finite = [], True, True
    for (inputs, n), f, r in zip(batches, fused, ref):
        for b, m in enumerate(n):
            fb, rb = torch.from_numpy(f[b, :m]), torch.from_numpy(r[b, :m])
            finite &= bool(torch.isfinite(fb).all())
            errs.append(rel_linf(rb, fb))
            equal &= bool((fb.argmax(-1) == rb.argmax(-1)).all())
    cases = kernel_cases(cfg, plan)
    per_fwd, sub_fwd = per_pass(cases)
    rec = {"phase": name, "model": cfg.name, "layers": cfg.num_layers,
           "plan": plan.describe(), "plan_fingerprint": plan.fingerprint(),
           "sequences": HUBERT_SEQS, "frames": int(lengths.sum()),
           "forwards": len(batches), "buckets": buckets, "wall_s": wall,
           "frames_per_s": int(lengths.sum()) / wall,
           "reference_wall_s": ref_wall, "launches": launches,
           "launches_per_forward": dict(per_fwd), "sub_counts": subs,
           "sub_counts_per_forward": dict(sub_fwd),
           "fused_vs_reference_rel_linf": max(errs),
           "predictions_equal": equal, "ptq_peak_memory_bytes": ptq_peak}
    emit(rec)
    if not finite or any(f.shape != (HUBERT_BATCH, int(n.max()),
                                     cfg.vocab_size)
                         for f, (_, n) in zip(fused, batches)):
        fail(f"{name}: frame logits are not finite (B, T, 504)")
    if max(errs) > REL_LINF_BUDGET or not equal:
        fail(f"{name}: fused vs reference rel-Linf {max(errs)}, predictions "
             f"equal {equal}")
    check_launches(name, per_fwd, sub_fwd, launches, subs, len(batches))
    shapes = sorted({(HUBERT_BATCH, int(n.max())) for _, n in batches})
    return {"name": name, "cfg": cfg, "qparams": qparams,
            "launches": launches, "per_fwd": per_fwd, "cases": cases,
            "buckets": shapes, "timed_bucket": shapes[-1],
            "unit": "forward", "record": rec}


def phase_paligemma(model, device):
    """paligemma-3b, all 18 layers, under the tiled golden plan: one
    ``Runtime.encode`` of :data:`PALIGEMMA_ROWS` rows of 256 seeded prefix
    embeddings (1152 wide, the SigLIP width, numpy seed 1) beside
    :data:`PALIGEMMA_TOKENS` tokens (lengths 8-32), on both backends: the
    final hidden states within rel-Linf 5e-3, the text positions' logits
    within 5e-3 and their argmax identical; then the text decode of the
    prompts over int8 per-token pages (``serve_arch_decode``). Returns the
    encode path and the decode path."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T

    cfg = model["cfg"]
    plan = arch_plan("paligemma_path", cfg)
    qparams, qplan, ptq_peak = quantize_arch(model, plan, device)
    rng = np.random.default_rng(1)
    P, S, B = cfg.num_prefix_embeds, PALIGEMMA_TOKENS, PALIGEMMA_ROWS
    inputs = {"prefix_embeds": rng.standard_normal(
                  (B, P, cfg.frontend_dim), dtype=np.float32),
              "tokens": rng.integers(1, cfg.vocab_size, (B, S),
                                     dtype=np.int32)}
    lengths = rng.integers(8, S + 1, B).astype(np.int32)
    lengths[0] = S
    fused, ref, launches, subs, wall, ref_wall, buckets = encode_pair(
        cfg, qparams, qplan, device, [(inputs, lengths)],
        head=None)
    hf, hr = (torch.from_numpy(x[0]).to(device) for x in (fused, ref))
    errs, equal = [rel_linf(hr, hf)], True
    with torch.inference_mode():
        for b, n in enumerate(lengths):       # the row's real positions
            lf, lr = (T.unembed(h[b:b + 1, P:P + n], qparams, cfg)
                      for h in (hf, hr))
            errs.append(rel_linf(lr, lf))
            equal &= bool((lf.argmax(-1) == lr.argmax(-1)).all())
    finite = bool(torch.isfinite(hf).all())
    cases = kernel_cases(cfg, plan)
    per_fwd, sub_fwd = per_pass(cases)
    rec = {"phase": "paligemma_path", "model": cfg.name,
           "layers": cfg.num_layers, "plan": plan.describe(),
           "plan_fingerprint": plan.fingerprint(), "rows": B,
           "prefix_embeds": P, "tokens": int(lengths.sum()),
           "buckets": buckets, "wall_s": wall,
           "reference_wall_s": ref_wall, "launches": launches,
           "launches_per_forward": dict(per_fwd), "sub_counts": subs,
           "hidden_rel_linf": errs[0],
           "fused_vs_reference_rel_linf": max(errs),
           "text_predictions_equal": equal,
           "ptq_peak_memory_bytes": ptq_peak}
    emit(rec)
    if not finite or tuple(hf.shape) != (B, P + S, cfg.d_model):
        fail(f"paligemma_path: hidden states {tuple(hf.shape)}, finite "
             f"{finite}")
    if max(errs) > REL_LINF_BUDGET or not equal:
        fail(f"paligemma_path: fused vs reference rel-Linf {max(errs)}, "
             f"text predictions equal {equal}")
    check_launches("paligemma_path", per_fwd, sub_fwd, launches, subs, 1)
    Sb = buckets[0][1]
    encode = {"name": "paligemma_path", "cfg": cfg, "qparams": qparams,
              "launches": launches, "per_fwd": per_fwd, "cases": cases,
              "buckets": [(B, P + Sb)], "timed_bucket": (B, P + Sb),
              "unit": "forward", "record": rec}
    decode = serve_arch_decode("paligemma_decode_path", model, qparams,
                               qplan, plan, device,
                               kv_cache="int8_per_token")
    return [encode, decode]


def phase_xlstm(model, device):
    """xlstm-125m (:data:`ARCH_CUTS`), under the tiled golden plan (its MHA
    blocks have no GEMM to quantize: the blocks' projections are FFN-group
    GEMMs): the decode of the prompts (``serve_arch_decode``; the recurrent
    states take no pages), then one ``Runtime.encode`` of
    :data:`XLSTM_ENCODE` seeded tokens on both backends, the logits within
    rel-Linf 5e-3 and their argmax identical. Neither path launches a
    kernel: the fused backend declines every op of the blocks. Returns the
    decode path and the encode path."""
    import numpy as np
    import torch
    from repro_torch.interop import flatten_names
    from repro_torch.models import transformer as T

    cfg = model["cfg"]
    plan = arch_plan("xlstm_decode_path", cfg)
    qparams, qplan, ptq_peak = quantize_arch(model, plan, device)
    # int8 GEMMs of the FFN group and of the MHA group (no attention here)
    weights = [n for n, _ in flatten_names(qparams["layers"])
               if n.endswith("/w/values")]
    mha = sum("/attn/" in n for n in weights)
    int8 = [len(weights) - mha, mha]
    decode = serve_arch_decode("xlstm_decode_path", model, qparams, qplan,
                               plan, device, kv_cache="int8_per_token")
    decode["record"].update(int8_ffn_gemms=int8[0], int8_mha_gemms=int8[1])
    rng = np.random.default_rng(1)
    B, S = XLSTM_ENCODE
    inputs = {"tokens": rng.integers(1, cfg.vocab_size, (B, S),
                                     dtype=np.int32)}
    fused, ref, launches, subs, wall, ref_wall, buckets = encode_pair(
        cfg, qparams, qplan, device, [(inputs, None)],
        head=lambda p, x: T.unembed(x, p, cfg))
    lf, lr = torch.from_numpy(fused[0]), torch.from_numpy(ref[0])
    err = rel_linf(lr, lf)
    equal = bool((lf.argmax(-1) == lr.argmax(-1)).all())
    finite = bool(torch.isfinite(lf).all())
    cases = kernel_cases(cfg, plan)
    per_fwd, sub_fwd = per_pass(cases)
    rec = {"phase": "xlstm_encode_path", "model": cfg.name,
           "layers": cfg.num_layers, "plan": plan.describe(),
           "plan_fingerprint": plan.fingerprint(), "rows": B, "tokens": S,
           "mlstm_chunks": S // 256, "buckets": buckets, "wall_s": wall,
           "tokens_per_s": B * S / wall, "reference_wall_s": ref_wall,
           "launches": launches, "launches_per_forward": dict(per_fwd),
           "sub_counts": subs, "fused_vs_reference_rel_linf": err,
           "predictions_equal": equal, "int8_ffn_gemms": int8[0],
           "int8_mha_gemms": int8[1], "ptq_peak_memory_bytes": ptq_peak}
    emit(rec)
    if not finite or tuple(lf.shape) != (B, S, cfg.vocab_size):
        fail(f"xlstm_encode_path: logits {tuple(lf.shape)}, finite {finite}")
    if err > REL_LINF_BUDGET or not equal:
        fail(f"xlstm_encode_path: fused vs reference rel-Linf {err}, "
             f"predictions equal {equal}")
    if int8[1] or not int8[0]:
        fail(f"xlstm: {int8[0]} int8 FFN-group GEMMs, {int8[1]} MHA ones")
    check_launches("xlstm_encode_path", per_fwd, sub_fwd, launches, subs, 1)
    encode = {"name": "xlstm_encode_path", "cfg": cfg, "qparams": qparams,
              "launches": launches, "per_fwd": per_fwd, "cases": cases,
              "buckets": [(B, S)], "timed_bucket": (B, S),
              "unit": "forward", "record": rec}
    return [decode, encode]


def phase_arch_decode(name, model, device):
    """Quantize a decoder under its plan and serve it
    (:func:`serve_arch_decode`): int8 per-token pages, but MLA's float
    latent pages. The quantized tree lives in the returned path only, so
    the caller frees it with the path."""
    plan = arch_plan(name, model["cfg"])
    qparams, qplan, _ = quantize_arch(model, plan, device)
    return serve_arch_decode(
        name, model, qparams, qplan, plan, device,
        page_size=ARCH_PAGE_SIZE.get(name, PAGE_SIZE),
        kv_cache=None if model["cfg"].mla is not None else "int8_per_token")


def phase_archs(device, timed, max_err):
    """The slice-13 paths, one model at a time: each built, served, its
    kernels held against their plain versions at the shapes it gave them
    (timed at its bucket), then freed. Each path's record gains its
    seconds and the phase's peak device memory. Returns the paths, their
    models dropped."""
    import torch
    paths = []
    for arch, names in ARCH_PHASES:
        model = setup_arch(arch, device)
        if arch == "hubert-xlarge":
            run = [phase_hubert(model, device)]
        elif arch == "paligemma-3b":
            run = phase_paligemma(model, device)
        elif arch == "xlstm-125m":
            run = phase_xlstm(model, device)
        else:
            run = [phase_arch_decode(names[0], model, device)]
        for p in run:
            # each path keeps the times of its own shape classes: a class
            # may recur at another bucket on the next path
            p["timed"] = {}
            check_kernels([p], device, p["timed"], max_err)
            for key, t in p["timed"].items():
                timed.setdefault(key, t)
        summary = {"phase": "arch_summary", "model": model["cfg"].name,
                   "paths": [p["name"] for p in run],
                   "seconds": time.perf_counter() - model["t0"],
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(
                       device)}
        emit(summary)
        for p in run:
            for k in ("qparams", "decode_args", "expert_args"):
                p.pop(k, None)
            p["record"].update(seconds=summary["seconds"],
                               peak_memory_bytes=summary[
                                   "peak_memory_bytes"])
        paths += run
        del model, run
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def _gemms(cfg, ffn=("ffn",)):
    """(block, K, N, activation, param path) of each GEMM of a layer, the
    FFN's under the path ``ffn``."""
    D, F, Q, KV = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    out = [("qkv", D, Q, None, ("attn", "wq")),
           ("qkv", D, KV, None, ("attn", "wk")),
           ("qkv", D, KV, None, ("attn", "wv")),
           ("attn_out", Q, D, None, ("attn", "wo"))]
    if cfg.ffn_kind == "glu":
        return out + [("ffn_in", D, F, "silu", ffn + ("wg",)),
                      ("ffn_in", D, F, None, ffn + ("wu",)),
                      ("ffn_out", F, D, None, ffn + ("wd",))]
    return out + [("ffn_in", D, F, "gelu", ffn + ("wi",)),
                  ("ffn_out", F, D, None, ffn + ("wo",))]


def kernel_cases(cfg, plan, kv_schemes=None, page_size=PAGE_SIZE):
    """The kernel calls one forward of the fused backend makes under
    ``plan`` (with ``kv_schemes``, the served per-layer KV-cache schemes,
    over pages of ``page_size``: one decode tick), grouped by shape class
    and variant, each with its
    count, the layer whose parameters it reads and the sub-count variant it
    is (``sub``, or None). GEMMs of one block and shape form one class,
    named by the first one's parameters."""
    D = cfg.d_model
    kinds = cfg.layer_kinds()
    cases = collections.OrderedDict()

    def add(key, layer, n=1, sub=None):
        if key not in cases:
            cases[key] = {"layer": layer, "count": 0, "sub": sub}
        cases[key]["count"] += n

    for i, lp in enumerate(plan.layers):
        body = kinds[i].body
        if body in ("mlstm", "slstm"):
            continue                 # an xLSTM block: the reference path
        moe = kinds[i].moe
        span = lp.norm == "int8"
        ffn_out_static = lp.ffn_out.quantized and lp.ffn_out.static_acts
        first = {}
        # an MLA body keeps every GEMM on the reference path, and so does an
        # RG-LRU mix (its FFN is a dense layer's); an MoE layer runs its
        # shared experts' GLU (under the shared_ffn family) where a dense
        # layer runs its FFN
        gemms = [] if cfg.mla is not None or body == "rglru" \
            else _gemms(cfg)[:4]
        if not moe:
            gemms += _gemms(cfg)[4:]
        elif cfg.moe.num_shared:
            gemms += _gemms(cfg.replace(
                d_ff=cfg.moe.d_ff_expert * cfg.moe.num_shared),
                ("ffn", "shared"))[4:]
        for block, K, N, act, path in gemms:
            spec = (lp.shared_ffn or lp.spec(block)) if "shared" in path \
                else lp.spec(block)
            if not spec.quantized:
                continue
            token = not spec.static_acts
            out = span and (block == "attn_out" or (
                block == "ffn_in" and ffn_out_static
                and cfg.ffn_kind != "glu"))
            path = first.setdefault((block, K, N, act), path)
            add(("quant_linear", K, N, act, token, path, out), i, 1,
                "quant_linear with out_scale" if out else None)
            if token:
                add(("dynamic_quant", K), i)
        if moe:
            # the routed expert stacks under the experts family (else the
            # ffn blocks' specs): wg, wu (D -> F) and wd (F -> D), one
            # launch each for every expert; per-token scales come from one
            # dynamic_quant launch over the whole routed buffer
            F = cfg.moe.d_ff_expert
            for (K, N, n, w), block in (((D, F, 2, "wg"), "ffn_in"),
                                        ((F, D, 1, "wd"), "ffn_out")):
                spec = lp.experts or lp.spec(block)
                if not spec.quantized:
                    continue
                token = not spec.static_acts
                add(("quant_expert_gemm", K, N, token, ("ffn", w)), i, n,
                    "quant_expert_gemm with per-token scales" if token
                    else None)
                if token:
                    add(("dynamic_quant", K, "experts"), i, n)
        elif lp.ffn_in.quantized and lp.ffn_in.static_acts \
                and body == "attn":
            # an RG-LRU layer adds its residual and norms on the reference
            # path: only an attention layer's boundary is fused
            add(("addnorm_quant", D, span, cfg.norm_kind), i, 1,
                "addnorm_quant with an int8 delta" if span else None)
        if body != "attn":
            continue
        if kv_schemes is not None:
            # the kernel takes the one-token step of float-bmm layers over
            # int8 pages; int8-bmm layers gather the pages, and local layers
            # keep dense rings
            # keep dense rings; an MLA layer pages its latent in float.
            # A shape class is a mode at one geometry: (KV heads, group,
            # head dim, page size)
            if (not lp.qkv.quantized and kv_schemes[i] != "float"
                    and not kinds[i].local and cfg.mla is None):
                quant_p = lp.softmax == "uint8"
                mode = ("per_token" if kv_schemes[i] == "int8_per_token"
                        else "per_head")
                add(("decode_attention", mode + ("_p_scale" if quant_p
                                                 else ""),
                     cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                     cfg.head_dim, page_size), i, 1,
                    "decode_attention with p_scale" if quant_p else None)
        elif (lp.softmax == "uint8" and lp.qkv.quantized
              and lp.qkv.static_acts):
            requant = lp.attn_out.quantized and lp.attn_out.static_acts
            add(("quant_flash_attention", requant, cfg.num_heads,
                 cfg.num_kv_heads, cfg.head_dim), i, 1,
                "quant_flash_attention with o_scale" if requant else None)
    if cfg.position == "learned":
        add(("fused_embed", D), 0)
    return cases


def _codes(shape, gen, device, std=32.0):
    import torch
    x = torch.randn(shape, generator=gen, device=device) * std
    return torch.clamp(torch.round(x), -128, 127).to(torch.int8)


def run_case(cfg, key, layer, bucket, qparams, device, timer=None):
    """Check one kernel call of shape class ``key`` at a (batch, length)
    bucket against its plain version; with ``timer``, also time kernel,
    plain and library."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import (addnorm_quant, dynamic_quant,
                                     flash_attention, fused_embed,
                                     quant_linear)
    Bb, Sb = bucket
    M = Bb * Sb
    gen = torch.Generator(device=device).manual_seed(M)
    rec = {"phase": "kernel", "kernel": key[0], "bucket": [Bb, Sb], "M": M}
    lp = qparams["layers"][layer]
    lib = None
    aside = None
    if key[0] == "quant_linear":
        _, K, N, act, token, path, out = key
        p = lp
        for k in path:
            p = p[k]
        w = p["w"]
        ws = w.scale.reshape(-1).expand(N).contiguous()
        x_q = torch.randint(-128, 128, (M, K), generator=gen, device=device,
                            dtype=torch.int8)
        if token:
            xs = torch.rand((M, 1), generator=gen, device=device) * 0.05 \
                + 1e-3
        else:
            xs = p["xs"]
        b = p.get("b")
        args = (x_q, w.values, ws, xs)
        kw = dict(bias=b, act=act)
        y = quant_linear.quant_linear(*args, **kw)
        y_ref = quant_linear.quant_linear_plain(*args, **kw)
        err = float((y - y_ref).abs().max())
        rel = rel_linf(y_ref, y)
        ok = rel <= 1e-6
        rec.update(K=K, N=N, act=act, per_token_scales=token, out_scale=out,
                   max_abs_err=err, rel_linf=rel,
                   tolerance="float out rel-Linf <= 1e-6; int8 out within "
                             "one code")
        # the requantizing epilogue (int8 out within one code): at the
        # calibrated out_xs where the span gives one
        os_ = (p["out_xs"] if out else torch.tensor(
            float(y_ref.abs().max()) / 127.0, device=device))
        kw_q = dict(kw, out_scale=os_)
        q = quant_linear.quant_linear(*args, **kw_q)
        q_ref = quant_linear.quant_linear_plain(*args, **kw_q)
        code = int((q.to(torch.int32) - q_ref.to(torch.int32)).abs().max())
        rec.update(out_scale_max_code_diff=code)
        ok = ok and code <= 1
        kw_t = kw_q if out else kw
        kern = lambda: quant_linear.quant_linear(*args, **kw_t)       # noqa
        plain = lambda: quant_linear.quant_linear_plain(*args, **kw_t)  # noqa
        nbytes = (M * K + K * N + 4 * N + 4 * (M if token else 1)
                  + (4 * N if b is not None else 0)
                  + (M * N + 4 if out else 4 * M * N))
        t_bytes, t_ops = bound(nbytes, int8_ops=2.0 * M * N * K,
                               f32_ops=(13.0 if act else 3.0) * M * N)
        bias = b if b is not None else torch.zeros(N, device=device)
        # torch._int_mm takes more than 16 rows: at decode (M = 8) it runs
        # on x padded with zero rows to 32, and the rows are cut after it
        x_lib = x_q if M > 16 else torch.cat(
            [x_q, torch.zeros((32 - M, K), dtype=torch.int8, device=device)])
        rec["library"] = ("torch._int_mm + epilogue" if M > 16 else
                          "torch._int_mm at M padded to 32 + epilogue")

        def lib():
            acc = torch._int_mm(x_lib, w.values)[:M]
            y = acc.to(torch.float32) * (xs * ws) + bias
            if act == "gelu":
                y = Fn.gelu(y, approximate="tanh")
            elif act == "silu":
                y = Fn.silu(y)
            if out:
                return torch.clamp(torch.round(y / os_), -128, 127).to(
                    torch.int8)
            return y
    elif key[0] == "dynamic_quant":
        K = key[1]
        if len(key) > 2:         # a routed expert buffer: (E, C) -> E C rows
            rec.update(rows="experts x capacity", bucket=None,
                       experts=Bb, capacity=Sb)
        x = torch.randn((M, K), generator=gen, device=device)
        kern = lambda: dynamic_quant.dynamic_quant(x)               # noqa
        plain = lambda: dynamic_quant.dynamic_quant_plain(x)         # noqa
        (q, s), (q_ref, s_ref) = kern(), plain()
        err = max(float((q.to(torch.int32) - q_ref.to(torch.int32)).abs()
                        .max()), float((s - s_ref).abs().max()))
        ok = err == 0.0
        rec.update(D=K, max_abs_err=err, tolerance="codes and scales exact")
        t_bytes, t_ops = bound(5.0 * M * K + 4 * M, f32_ops=6.0 * M * K)
    elif key[0] == "addnorm_quant":
        D, int8_in, kind = key[1], key[2], key[3]
        rms = kind == "rmsnorm"
        if int8_in:
            x = torch.randint(-128, 128, (M, D), generator=gen,
                              device=device, dtype=torch.int8)
            x_in = lp["attn"]["wo"]["out_xs"]
        else:
            x = torch.randn((M, D), generator=gen, device=device)
            x_in = None
        res = torch.randn((M, D), generator=gen, device=device) * 2.0
        bias = torch.zeros(D, device=device)
        gamma = 1.0 + 0.1 * torch.randn(D, generator=gen, device=device)
        beta = None if rms else 0.1 * torch.randn(D, generator=gen,
                                                  device=device)
        s = lp["ffn"]["wg" if cfg.ffn_kind == "glu" else "wi"]["xs"]
        args = (x, res, bias, gamma, beta, s)
        kern = lambda: addnorm_quant.addnorm_quant(       # noqa
            *args, x_in_scale=x_in, kind=kind)
        plain = lambda: addnorm_quant.addnorm_quant_plain(  # noqa
            *args, x_in_scale=x_in, kind=kind)
        (h, q), (h_ref, q_ref) = kern(), plain()
        diff = (q.to(torch.int32) - q_ref.to(torch.int32)).abs()
        flipped = float((diff > 0).to(torch.float32).mean())
        err = float((h - h_ref).abs().max())
        ok = (bool(h.equal(h_ref)) and flipped < 0.005
              and int(diff.max()) <= 1)
        rec.update(D=D, norm=kind, int8_delta=int8_in, max_abs_err=err,
                   h_exact=bool(h.equal(h_ref)),
                   q_flipped_share=flipped, q_max_code_diff=int(diff.max()),
                   tolerance="h bit for bit; < 0.5% of codes flipped, each "
                             "by <= 1")
        t_bytes, t_ops = bound((1.0 if int8_in else 4.0) * M * D
                               + 9.0 * M * D + (8 if rms else 12) * D + 8,
                               f32_ops=16.0 * M * D)
        if not rms or hasattr(Fn, "rms_norm"):
            def lib():
                xf = x.to(torch.float32) * x_in if int8_in else x
                hh = xf + res + bias
                y = (Fn.rms_norm(hh, (D,), gamma, eps=1e-6) if rms else
                     Fn.layer_norm(hh, (D,), gamma, beta, eps=1e-6))
                return hh, torch.clamp(torch.round(y / s), -128, 127).to(
                    torch.int8)
    elif key[0] == "quant_flash_attention":
        requant = key[1]
        attn = lp["attn"]
        H, Hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q_ = _codes((Bb, H, Sb, d), gen, device)
        k_, v_ = (_codes((Bb, Hkv, Sb, d), gen, device) for _ in range(2))
        lens = torch.randint(1, Sb + 1, (Bb,), generator=gen, device=device)
        idx = torch.arange(Sb, device=device, dtype=torch.int32)
        k_pos = torch.where(idx[None] < lens[:, None], idx[None],
                            -1).to(torch.int32)
        scales = {n: attn[f"{n}_scale"] for n in ("q", "k", "p", "v")}
        kw = {f"{n}_scale": x for n, x in scales.items()}
        args = (q_, k_, v_, k_pos)
        o_scale = attn["wo"]["xs"]
        o = flash_attention.quant_flash_attention(*args, **kw)
        o_ref = flash_attention.quant_flash_attention_plain(*args, **kw)
        oq = flash_attention.quant_flash_attention(*args, **kw,
                                                   o_scale=o_scale)
        oq_ref = flash_attention.quant_flash_attention_plain(
            *args, **kw, o_scale=o_scale)
        err = float((o - o_ref).abs().max())
        diff = (oq.to(torch.int32) - oq_ref.to(torch.int32)).abs()
        share = float((diff > 0).to(torch.float32).mean())
        # no softcap on the served paths: the same int32 products, the same
        # float32 softmax summed in the same order, so the same bits
        ok = bool(o.equal(o_ref)) and bool(oq.equal(oq_ref))
        rec.update(heads=H, head_dim=d, valid_keys=int(lens.sum()),
                   max_abs_err=err, rel_linf=rel_linf(o_ref, o),
                   float_out_exact=err == 0.0,
                   o_scale_max_code_diff=int(diff.max()),
                   o_scale_codes_differing_share=share,
                   tolerance="bit for bit, float and int8 out (no softcap)")
        kw_t = dict(kw, o_scale=o_scale) if requant else kw
        kern = lambda: flash_attention.quant_flash_attention(  # noqa
            *args, **kw_t)
        plain = lambda: flash_attention.quant_flash_attention_plain(  # noqa
            *args, **kw_t)
        n_out, n_kv = Bb * H * Sb * d, Bb * Hkv * Sb * d
        # each input read once, the output written once; the operations
        # this data needs: two int8 products over the valid keys, and
        # about ten float32 operations per valid score (dequantize, mask,
        # max, exp, sum, two divides, round) plus four per output
        pairs = H * Sb * int(lens.sum())
        t_bytes, t_ops = bound(n_out + 2.0 * n_kv + 4.0 * Bb * Sb + 20
                               + (1.0 if requant else 4.0) * n_out,
                               int8_ops=4.0 * pairs * d,
                               f32_ops=10.0 * pairs + 4.0 * n_out)
        # not the same function (a float softmax, no uint8 codes): an aside
        # to set the kernel beside, used nowhere in the port
        qf, kf, vf = (t.to(torch.float32) * scales[n]
                      for t, n in ((q_, "q"), (k_, "k"), (v_, "v")))
        kf, vf = (t.repeat_interleave(H // Hkv, dim=1) for t in (kf, vf))
        mask = (k_pos >= 0)[:, None, None, :]

        def aside():
            return Fn.scaled_dot_product_attention(qf, kf, vf,
                                                   attn_mask=mask, scale=1.0)
    else:
        emb = qparams["embed"]
        tok, pos, seg = emb["tok"], emb["pos"], emb["seg"]
        ids = torch.randint(0, tok.shape[0], (M,), generator=gen,
                            device=device, dtype=torch.int32)
        positions = torch.arange(M, device=device, dtype=torch.int32) % Sb
        segs = torch.randint(0, seg.shape[0], (M,), generator=gen,
                             device=device, dtype=torch.int32)
        args = (ids, tok, pos, seg, segs)
        kern = lambda: fused_embed.fused_embed(*args,                # noqa
                                               positions=positions)
        plain = lambda: fused_embed.fused_embed_plain(*args,         # noqa
                                                      positions=positions)
        err = float((kern() - plain()).abs().max())
        ok = err == 0.0
        rows = (int(torch.unique(ids).numel())
                + int(torch.unique(positions).numel())
                + int(torch.unique(segs).numel()))
        rec.update(D=key[1], max_abs_err=err, distinct_rows=rows,
                   tolerance="exact")
        t_bytes, t_ops = bound(12.0 * M + 4.0 * key[1] * (rows + M),
                               f32_ops=2.0 * M * key[1])
        lib_ids = (ids.long(), positions.long(), segs.long())

        def lib():
            return (Fn.embedding(lib_ids[0], tok)
                    + Fn.embedding(lib_ids[1], pos)
                    + Fn.embedding(lib_ids[2], seg))
    torch.cuda.synchronize()
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if timer is not None:
        rec["ms"] = timer.ms(kern)
        rec["device_ms"] = timer.device_ms(kern, key[0])
        rec["plain_ms"] = timer.ms(plain)
        rec["library_ms"] = timer.ms(lib) if lib is not None else None
        rec["library_device_ms"] = (timer.device_ms(lib) if lib is not None
                                    else None)
        if aside is not None:
            rec["sdpa_float_aside_ms"] = timer.ms(aside)
    emit(rec)
    if not ok:
        fail(f"{key[0]} at M={M} disagrees with its plain version: {rec}")
    return rec, (t_bytes, t_ops)


def gathered_kv(args):
    """The decode operands' pages gathered per slot and dequantized: K and
    V as (B, Hkv, pages_per_slot * page_size, hd) float32, and the mask of
    the keys a slot holds (its table entry names a page, the token is below
    its length) as (B, T)."""
    import torch
    table, lengths = args["page_table"], args["lengths"]
    NP, ps, Hkv, hd = args["k_pages"].shape
    B, pps = table.shape
    safe = table.clamp(0, NP - 1).long()
    kf = args["k_pages"][safe].float()            # (B, pps, ps, Hkv, hd)
    vf = args["v_pages"][safe].float()
    if args["per_head"]:
        kf = kf * args["k_scale"].reshape(1, 1, 1, Hkv, 1)
        vf = vf * args["v_scale"].reshape(1, 1, 1, Hkv, 1)
    else:
        kf = kf * args["k_scale"][safe][..., None]
        vf = vf * args["v_scale"][safe][..., None]
    kf, vf = (t.reshape(B, pps * ps, Hkv, hd).transpose(1, 2)
              for t in (kf, vf))
    tok = torch.arange(pps * ps, device=table.device)
    mask = (((table >= 0) & (table < NP)).repeat_interleave(ps, dim=1)
            & (tok[None] < lengths[:, None]))
    return kf, vf, mask


def decode_witness(args):
    """Paged decode attention by gather: one softmax over all of a slot's
    dequantized keys at once, and with ``p_scale`` the probabilities coded
    to uint8 before P.V. It shares neither the page recurrence nor the
    order of sums with the kernel and its plain version."""
    import torch
    q = args["q"]
    B, Hkv, g, hd = q.shape
    kf, vf, mask = gathered_kv(args)
    scale = args.get("scale") or hd ** -0.5
    s = torch.einsum("bhgd,bhtd->bhgt", q * scale, kf)
    if args.get("softcap") is not None:
        s = torch.tanh(s / args["softcap"]) * args["softcap"]
    keep = mask[:, None, None, :]
    s = torch.where(keep, s, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp(min=-3e38)    # rows with no keys
    p = torch.where(keep, torch.exp(s - m), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    if args.get("p_scale") is not None:
        p = torch.clamp(torch.round(p / args["p_scale"]), 0, 255) \
            * args["p_scale"]
    return torch.einsum("bhgt,bhtd->bhgd", p, vf)


def decode_operands(device, lengths, pages_per_slot, mode="per_token",
                    seed=0, kv_heads=2, group=7, head_dim=64,
                    page_size=PAGE_SIZE):
    """Seeded operands of one ``decode_attention`` call, by default at the
    decode paths' geometry (qwen2-0.5b: 8 slots, 2 KV heads, a GQA group of
    7, head dim 64; pages of 16): each slot's pages scattered over the pool
    in a seeded order, its table filled as far as ``lengths`` reach; mode
    "per_token" (``decode_path``'s scale pages) or "p_scale"
    (``decode_head_path``'s per-head scales and uint8 softmax)."""
    import torch
    B, Hkv, g, hd, ps = DECODE_SLOTS, kv_heads, group, head_dim, page_size
    gen = torch.Generator(device=device).manual_seed(seed)
    NP = B * pages_per_slot
    q = torch.randn((B, Hkv, g, hd), generator=gen, device=device)
    k, v = (torch.randint(-127, 128, (NP, ps, Hkv, hd), generator=gen,
                          device=device, dtype=torch.int8)
            for _ in range(2))
    order = torch.randperm(NP, generator=gen, device=device)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    first = torch.arange(pages_per_slot, device=device)[None] * ps
    table = torch.where(first < lengths[:, None],
                        order.reshape(B, pages_per_slot), -1)
    shape = (NP, ps, Hkv) if mode == "per_token" else (Hkv,)
    ks, vs = (torch.rand(shape, generator=gen, device=device) * 0.04 + 0.01
              for _ in range(2))
    return {"q": q, "k_pages": k, "v_pages": v,
            "page_table": table.to(torch.int32).contiguous(),
            "lengths": lengths, "k_scale": ks, "v_scale": vs,
            "per_head": mode != "per_token",
            "p_scale": (torch.tensor(0.9 / 255, device=device)
                        if mode == "p_scale" else None)}


def check_decode(args, device, timer=None):
    """``decode_attention`` on ``args`` against its plain version (max abs
    <= 2e-5; with ``p_scale`` rel-Linf <= 5e-3) and :func:`decode_witness`,
    the gathered float attention (rel-Linf 1e-4; 5e-3 with ``p_scale``), and
    its bound; with ``timer``, also the kernel's and the plain version's
    times. No one PyTorch call computes paged int8 decode: SDPA on the
    gathered, dequantized K/V is timed as a labelled aside. Returns the
    record, (bytes bound, operations bound) and whether it held."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import decode_attention as DA
    q, table, lengths = args["q"], args["page_table"], args["lengths"]
    B, Hkv, g, hd = q.shape
    NP, ps = args["k_pages"].shape[:2]
    pps = table.shape[1]
    out = DA.decode_attention(**args)
    want = DA.decode_attention_plain(**args)
    err = float((out - want).abs().max())
    rel = rel_linf(want, out)
    quant_p = args["p_scale"] is not None
    ok = (rel <= REL_LINF_BUDGET) if quant_p else (err <= 2e-5)
    # the independent witness: float rounding only, and in the p_scale
    # mode the uint8 codes at ties
    witness_rel = rel_linf(decode_witness(args), out)
    witness_tol = REL_LINF_BUDGET if quant_p else 1e-4
    ok = ok and witness_rel <= witness_tol
    # each input read once: the valid tokens' K and V rows of both heads
    # (and their per-token scales), q, the table and lengths; out written
    # once. The operations this data needs: two hd-long dots per valid
    # token and query head, about ten float32 operations per score for the
    # softmax, and in the p_scale mode the recomputed dot and the codes
    live = sum(int(((table[b] >= 0) & (lengths[b] > torch.arange(
        pps, device=device) * ps)).sum()) for b in range(B))
    tokens = int(lengths.sum())
    per_token = not args["per_head"]
    nbytes = (8.0 * q.numel() + tokens * Hkv * (2 * hd
                                                + (8 if per_token else 0))
              + 4.0 * table.numel() + 4.0 * B + 8.0 * Hkv + 4.0)
    f32_ops = tokens * Hkv * g * (4.0 * hd + 10.0
                                  + (2.0 * hd + 8.0 if quant_p else 0.0))
    t_bytes, t_ops = bound(nbytes, f32_ops=f32_ops)
    split = DA.decode_split_pages(pps)
    rec = {"slots": B, "kv_heads": Hkv, "group": g, "head_dim": hd,
           "page_size": ps, "pages": NP, "pages_per_slot": pps,
           "split_pages": split, "splits": DA.decode_splits(pps, split),
           "live_pages": live,
           "valid_tokens": tokens, "max_abs_err": err, "rel_linf": rel,
           "exact": bool(out.equal(want)),
           "tolerance": ("float out rel-Linf <= 5e-3 (uint8 codes at ties)"
                         if quant_p else "max abs <= 2e-5"),
           "witness_rel_linf": witness_rel,
           "witness_tolerance": f"rel-Linf <= {witness_tol:g}",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if timer is not None:
        rec["ms"] = timer.ms(lambda: DA.decode_attention(**args))
        rec["device_ms"] = timer.device_ms(
            lambda: DA.decode_attention(**args), "decode_attention")
        rec["plain_ms"] = timer.ms(lambda: DA.decode_attention_plain(**args))
        rec["library_ms"] = rec["library_device_ms"] = None
        # the aside: float SDPA over the gathered, dequantized pages
        kf, vf, mask = gathered_kv(args)
        kf, vf = (t.repeat_interleave(g, dim=1) for t in (kf, vf))
        mask = mask[:, None, None, :]
        qf = q.reshape(B, Hkv * g, 1, hd)
        rec["sdpa_float_aside_ms"] = timer.ms(
            lambda: Fn.scaled_dot_product_attention(qf, kf, vf,
                                                    attn_mask=mask))
    torch.cuda.synchronize()
    return rec, (t_bytes, t_ops), ok


def run_decode_case(path, mode, device, timer=None):
    """:func:`check_decode` on the operands one layer gave the kernel at
    the decode path's longest tick (``mode`` "per_head" drops the head
    path's ``p_scale``)."""
    args = dict(path["decode_args"])
    if mode == "per_head":
        args["p_scale"] = None
    rec, tb, ok = check_decode(args, device, timer)
    rec = {"phase": "kernel", "kernel": "decode_attention",
           "path": path["name"], "mode": mode, **rec}
    emit(rec)
    if not ok:
        fail(f"decode_attention ({mode}) disagrees with its plain version "
             f"or the gathered witness: {rec}")
    return rec, tb


def run_long_decode_case(device, timer):
    """:func:`check_decode` at :data:`LONG_DECODE_TOKENS` cached tokens in
    every slot (pages of 16), seeded operands with per-token scales: the
    context the split over pages is for."""
    pps = LONG_DECODE_TOKENS // PAGE_SIZE
    args = decode_operands(device, [LONG_DECODE_TOKENS] * DECODE_SLOTS, pps)
    rec, _, ok = check_decode(args, device, timer)
    rec = {"phase": "kernel", "kernel": "decode_attention",
           "path": "long_context", "mode": "per_token", **rec}
    emit(rec)
    if not ok:
        fail(f"decode_attention at {LONG_DECODE_TOKENS} cached tokens "
             f"disagrees with its plain version or the gathered witness: "
             f"{rec}")
    return rec


def run_wide_page_decode_case(device, timer):
    """:func:`check_decode` at head dim 256 with pages of 128 tokens
    (:data:`WIDE_PAGE_DECODE`, gemma2-2b's attention), the shape whose K and
    V pages share one buffer in a block: seeded operands with per-token
    scales."""
    w = WIDE_PAGE_DECODE
    pps = w["tokens"] // w["page_size"]
    args = decode_operands(device, [w["tokens"]] * DECODE_SLOTS, pps,
                           kv_heads=w["kv_heads"], group=w["group"],
                           head_dim=w["head_dim"], page_size=w["page_size"])
    args["softcap"] = w["softcap"]
    rec, _, ok = check_decode(args, device, timer)
    rec = {"phase": "kernel", "kernel": "decode_attention",
           "path": "hd256_pages128", "mode": "per_token",
           "softcap": w["softcap"], **rec}
    emit(rec)
    if not ok or not rec["exact"]:
        fail(f"decode_attention at head dim 256 with pages of 128 "
             f"disagrees with its plain version or the gathered witness: "
             f"{rec}")
    return rec


def run_long_attention_case(device, timer):
    """``quant_flash_attention`` at :data:`LONG_ATTENTION` (BERT-base's
    full 512 positions, batch 8, 12 heads of 64), seeded codes, key lengths
    and scales, with and without ``o_scale``: equal to its plain version
    bit for bit (no softcap: the same int32 products, the same float32
    softmax summed in the same order), timed beside its bound."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    B, H, S, d = LONG_ATTENTION
    gen = torch.Generator(device=device).manual_seed(B * S + d)
    q, k, v = (_codes((B, H, S, d), gen, device) for _ in range(3))
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=device)
    lens[0] = S
    idx = torch.arange(S, device=device, dtype=torch.int32)
    k_pos = torch.where(idx[None] < lens[:, None], idx[None],
                        -1).to(torch.int32)
    kw = dict(q_scale=torch.tensor(0.35 / d, device=device),
              k_scale=torch.tensor(0.013, device=device),
              p_scale=torch.tensor(0.6 / 255, device=device),
              v_scale=torch.tensor(0.02, device=device))
    n_out = B * H * S * d
    pairs = H * S * int(lens.sum())
    recs = {}
    for requant in (False, True):
        kw_t = dict(kw, o_scale=torch.tensor(0.01, device=device)) \
            if requant else kw
        kern = lambda: FA.quant_flash_attention(q, k, v, k_pos,  # noqa
                                                **kw_t)
        plain = lambda: FA.quant_flash_attention_plain(  # noqa
            q, k, v, k_pos, **kw_t)
        out, want = kern(), plain()
        exact = bool(out.equal(want))
        err = float((out.to(torch.float32) - want.to(torch.float32)).abs()
                    .max())
        # as the served cases count it: each input read once, the output
        # written once; two int8 products and the float softmax over the
        # valid keys
        t_bytes, t_ops = bound(3.0 * n_out + 4.0 * B * S + 20
                               + (1.0 if requant else 4.0) * n_out,
                               int8_ops=4.0 * pairs * d,
                               f32_ops=10.0 * pairs + 4.0 * n_out)
        rec = {"phase": "kernel", "kernel": "quant_flash_attention",
               "path": "bert_512", "batch": B, "heads": H, "length": S,
               "head_dim": d, "o_scale": requant,
               "tiled": FA.quant_flash_attention_tiled(S, d),
               "valid_keys": int(lens.sum()), "max_abs_err": err,
               "exact": exact, "tolerance": "bit for bit (no softcap)",
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "ms": timer.ms(kern),
               "device_ms": timer.device_ms(kern, "quant_flash_attention"),
               "plain_ms": timer.ms(plain), "library_ms": None,
               "library_device_ms": None}
        emit(rec)
        if not exact:
            fail(f"quant_flash_attention at {LONG_ATTENTION} differs from "
                 f"its plain version: {rec}")
        recs["o_scale" if requant else "float_out"] = rec
    return recs


def run_wide_head_cases(device, timer):
    """The three attention kernels at the head dims over 256 of
    :data:`WIDE_HEAD_DIMS` (their wide kernels), seeded:
    ``quant_flash_attention`` at :data:`WIDE_ATTENTION` with ragged key
    lengths, equal to its plain version bit for bit; ``flash_attention`` at
    the same shape in float32, causal, within its 2e-4 budget, beside SDPA;
    ``decode_attention`` at :data:`WIDE_DECODE` (per-token scales), equal
    to its plain version bit for bit and within 1e-4 of the gathered
    witness. Each is timed beside its bound. Returns {kernel: {"hd<d>":
    record}}."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as FA
    out = collections.defaultdict(dict)
    B, Hq, Hkv, S = WIDE_ATTENTION
    g = Hq // Hkv
    for d in WIDE_HEAD_DIMS:
        gen = torch.Generator(device=device).manual_seed(S + d)
        q = _codes((B, Hq, S, d), gen, device)
        k, v = (_codes((B, Hkv, S, d), gen, device) for _ in range(2))
        lens = torch.tensor([S, S // 2 + 7], device=device)
        idx = torch.arange(S, device=device, dtype=torch.int32)
        k_pos = torch.where(idx[None] < lens[:, None], idx[None],
                            -1).to(torch.int32)
        kw = dict(q_scale=torch.tensor(0.35 / d, device=device),
                  k_scale=torch.tensor(0.013, device=device),
                  p_scale=torch.tensor(0.6 / 255, device=device),
                  v_scale=torch.tensor(0.02, device=device))
        kern = lambda: FA.quant_flash_attention(q, k, v, k_pos, **kw)  # noqa
        plain = lambda: FA.quant_flash_attention_plain(  # noqa
            q, k, v, k_pos, **kw)
        got, want = kern(), plain()
        exact = bool(got.equal(want))
        pairs = Hq * S * int(lens.sum())
        n_q, n_kv = B * Hq * S * d, B * Hkv * S * d
        t_bytes, t_ops = bound(n_q + 2.0 * n_kv + 4.0 * B * S + 16
                               + 4.0 * n_q, int8_ops=4.0 * pairs * d,
                               f32_ops=10.0 * pairs + 4.0 * n_q)
        rec = {"phase": "kernel", "kernel": "quant_flash_attention",
               "path": f"hd{d}", "batch": B, "heads": Hq, "kv_heads": Hkv,
               "length": S, "head_dim": d, "valid_keys": int(lens.sum()),
               "max_abs_err": float((got - want).abs().max()),
               "exact": exact, "tolerance": "bit for bit",
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "ms": timer.ms(kern),
               "device_ms": timer.device_ms(kern, "quant_flash_attention"),
               "plain_ms": timer.ms(plain), "library_ms": None,
               "library_device_ms": None}
        emit(rec)
        out["quant_flash_attention"][f"hd{d}"] = rec
        if not exact:
            fail(f"quant_flash_attention at head dim {d} differs from its "
                 f"plain version: {rec}")
        del q, k, v, got, want

        qf = torch.randn((B, Hq, S, d), generator=gen, device=device)
        kf, vf = (torch.randn((B, Hkv, S, d), generator=gen, device=device)
                  for _ in range(2))
        fkw = {"causal": True}
        kern = lambda: FA.flash_attention(qf, kf, vf, **fkw)  # noqa
        plain = lambda: FA.flash_attention_plain(qf, kf, vf, **fkw)  # noqa
        got, want = kern(), plain()
        err = (got - want).abs()
        excess = float((err - FLASH_TOL - FLASH_TOL * want.abs()).max())
        t_bytes, t_ops, pairs, _, _ = flash_bound(B, Hq, Hkv, S, d, fkw,
                                                  torch.float32)
        ke, ve = (t.repeat_interleave(g, dim=1) for t in (kf, vf))

        def library():
            return Fn.scaled_dot_product_attention(qf, ke, ve,
                                                   is_causal=True,
                                                   scale=d ** -0.5)
        rec = {"phase": "kernel", "kernel": "flash_attention",
               "path": f"hd{d}", "batch": B, "heads": Hq, "kv_heads": Hkv,
               "length": S, "head_dim": d, "dtype": "float32",
               "mask": fkw, "valid_pairs": pairs,
               "max_abs_err": float(err.max()),
               "tolerance": (f"|out - plain| <= {FLASH_TOL:g} + "
                             f"{FLASH_TOL:g} |plain|"),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "ms": timer.ms(kern),
               "device_ms": timer.device_ms(kern, "flash_attention"),
               "plain_ms": timer.ms(plain),
               "library": ("F.scaled_dot_product_attention, K and V "
                           "expanded to the query heads"),
               "library_max_abs_diff": float((library() - got).abs().max()),
               "library_ms": timer.ms(library),
               "library_device_ms": timer.device_ms(library)}
        emit(rec)
        out["flash_attention"][f"hd{d}"] = rec
        if excess > 0 or not bool(torch.isfinite(got).all()):
            fail(f"flash_attention at head dim {d} disagrees with its plain "
                 f"version: {rec}")
        del qf, kf, vf, ke, ve, got, want, err

        w = WIDE_DECODE
        pps = w["tokens"] // w["page_size"]
        args = decode_operands(device, [w["tokens"]] * DECODE_SLOTS, pps,
                               kv_heads=w["kv_heads"], group=w["group"],
                               head_dim=d, page_size=w["page_size"])
        rec, _, ok = check_decode(args, device, timer)
        rec = {"phase": "kernel", "kernel": "decode_attention",
               "path": f"hd{d}", "mode": "per_token", **rec}
        emit(rec)
        out["decode_attention"][f"hd{d}"] = rec
        if not ok or not rec["exact"]:
            fail(f"decode_attention at head dim {d} disagrees with its "
                 f"plain version or the gathered witness: {rec}")
        del args
        torch.cuda.empty_cache()
    return out


def run_wide_row_cases(device, timer):
    """``addnorm_quant`` and ``dynamic_quant`` at rows past their register
    plans, which no served path reaches and which both kernels stream:
    :data:`WIDE_ADDNORM` (LayerNorm with beta, float x) and
    :data:`WIDE_DYNAMIC_QUANT`, seeded; h and the dynamic codes and scales
    equal to the plain versions bit for bit, addnorm's codes within its
    budget; timed beside their bounds."""
    import torch
    from repro_torch.kernels import addnorm_quant, dynamic_quant
    recs = {}
    M, D = WIDE_ADDNORM
    gen = torch.Generator(device=device).manual_seed(M * D)
    x, res = (torch.randn((M, D), generator=gen, device=device)
              for _ in range(2))
    gamma = 1.0 + 0.1 * torch.randn(D, generator=gen, device=device)
    bias, beta = (0.1 * torch.randn(D, generator=gen, device=device)
                  for _ in range(2))
    args = (x, res, bias, gamma, beta, torch.tensor(0.025, device=device))
    kern = lambda: addnorm_quant.addnorm_quant(*args)           # noqa
    plain = lambda: addnorm_quant.addnorm_quant_plain(*args)    # noqa
    (h, q), (h_ref, q_ref) = kern(), plain()
    diff = (q.to(torch.int32) - q_ref.to(torch.int32)).abs()
    flipped = float((diff > 0).to(torch.float32).mean())
    ok = bool(h.equal(h_ref)) and flipped < 0.005 and int(diff.max()) <= 1
    t_bytes, t_ops = bound(13.0 * M * D + 12 * D + 4, f32_ops=16.0 * M * D)
    recs["addnorm_quant"] = rec = {
        "phase": "kernel", "kernel": "addnorm_quant", "path": "wide_rows",
        "M": M, "D": D, "norm": "layernorm",
        "streamed": addnorm_quant.plan(M, D)[0] == 0,
        "max_abs_err": float((h - h_ref).abs().max()),
        "h_exact": bool(h.equal(h_ref)), "q_flipped_share": flipped,
        "q_max_code_diff": int(diff.max()),
        "tolerance": "h bit for bit; < 0.5% of codes flipped, each by <= 1",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "ms": timer.ms(kern),
        "device_ms": timer.device_ms(kern, "addnorm_quant"),
        "plain_ms": timer.ms(plain), "library_ms": None,
        "library_device_ms": None}
    emit(rec)
    if not ok:
        fail(f"addnorm_quant at {WIDE_ADDNORM} differs from its plain "
             f"version: {rec}")
    M, D = WIDE_DYNAMIC_QUANT
    x = torch.randn((M, D), generator=gen, device=device) * 3
    kern = lambda: dynamic_quant.dynamic_quant(x)               # noqa
    plain = lambda: dynamic_quant.dynamic_quant_plain(x)         # noqa
    (q, sc), (q_ref, sc_ref) = kern(), plain()
    err = max(float((q.to(torch.int32) - q_ref.to(torch.int32)).abs()
                    .max()), float((sc - sc_ref).abs().max()))
    t_bytes, t_ops = bound(5.0 * M * D + 4 * M, f32_ops=6.0 * M * D)
    recs["dynamic_quant"] = rec = {
        "phase": "kernel", "kernel": "dynamic_quant", "path": "wide_rows",
        "M": M, "D": D, "max_abs_err": err, "exact": err == 0.0,
        "tolerance": "codes and scales exact",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "ms": timer.ms(kern),
        "device_ms": timer.device_ms(kern, "dynamic_quant"),
        "plain_ms": timer.ms(plain), "library_ms": None,
        "library_device_ms": None}
    emit(rec)
    if err != 0.0:
        fail(f"dynamic_quant at {WIDE_DYNAMIC_QUANT} differs from its plain "
             f"version: {rec}")
    return recs


def run_expert_case(path, key, layer, C, device, timer=None):
    """Check ``quant_expert_gemm`` of shape class ``key`` at capacity ``C``
    (G = 1) against its plain version: on the routed buffer the served run
    gave it at its own capacity, on a seeded one at others; with ``timer``,
    also time kernel, plain and the library yardstick, a loop of E
    ``torch._int_mm`` calls (rows padded to 32 at decode) with the same
    quantization and epilogue, which the port never calls."""
    import torch
    from repro_torch.core.quantize import quantize, quantize_per_token
    from repro_torch.kernels import dynamic_quant
    from repro_torch.kernels import expert_gemm as EG
    _, K, N, token, wpath = key
    cfg = path["cfg"]
    E = cfg.moe.num_experts
    p = path["qparams"]["layers"][layer][wpath[0]][wpath[1]]
    w, xs = p["w"], None if token else p["xs"]
    xe = path["expert_args"].get((K, N, token))
    served = xe is not None and xe.shape[-2] == C
    if not served:
        gen = torch.Generator(device=device).manual_seed(C * K + N)
        xe = torch.randn((1, E, C, K), generator=gen, device=device)
        if xs is not None:            # codes of a few tens of units
            xe = xe * (xs * 24.0)
    args = (xe, w.values, w.scale, xs)
    y = EG.quant_expert_gemm(*args)
    want = EG.quant_expert_gemm_plain(*args)
    err = float((y - want).abs().max())
    rel = rel_linf(want, y)
    codes_exact = True
    if token:          # the kernel's codes: one dynamic_quant launch
        q, sc = dynamic_quant.dynamic_quant(xe.reshape(-1, K))
        ref = quantize_per_token(xe)
        codes_exact = bool(q.equal(ref.values.reshape(-1, K))
                           and sc.equal(ref.scale.reshape(-1, 1)))
    ok = rel <= 1e-6 and codes_exact
    rec = {"phase": "kernel", "kernel": "quant_expert_gemm",
           "path": path["name"], "layer": layer, "weight": wpath[1],
           "G": 1, "E": E, "C": C, "D": K, "F": N,
           "per_token_scales": token, "routed_buffer_of_the_run": served,
           "max_abs_err": err, "rel_linf": rel, "exact": bool(y.equal(want)),
           "codes_exact": codes_exact,
           "tolerance": "codes exact; rel-Linf <= 1e-6 (both sum in int32 "
                        "and dequantize as acc * (xs * ws))"}
    # each input read once (the float buffer, the int8 stack, the scales),
    # the float output written once; the operations: the int8 products, the
    # quantization (3 a value; 2 more for a per-token amax) and a
    # two-multiply epilogue
    rows = E * C
    nbytes = (4.0 * rows * K + E * K * N + 4.0 * E * N
              + (0.0 if token else 4.0 * E) + 4.0 * rows * N)
    t_bytes, t_ops = bound(nbytes, int8_ops=2.0 * rows * K * N,
                           f32_ops=(5.0 if token else 3.0) * rows * K
                           + 2.0 * rows * N)
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if timer is not None:
        Mp = max(32, -(-C // 8) * 8)
        x_pad = torch.zeros((E, Mp, K), dtype=torch.int8, device=device)
        ws = w.scale.reshape(E, 1, N)
        out = torch.empty((1, E, C, N), device=device)

        def lib():
            if token:
                qt = quantize_per_token(xe)
                codes, x_scale = qt.values[0], qt.scale[0]   # (E, C, 1)
            else:
                codes = quantize(xe, xs)[0]
                x_scale = xs.reshape(E, 1, 1)
            x_pad[:, :C].copy_(codes)
            for e in range(E):
                acc = torch._int_mm(x_pad[e], w.values[e])[:C]
                out[0, e] = acc.to(torch.float32) * (x_scale[e] * ws[e])
            return out
        rec["ms"] = timer.ms(lambda: EG.quant_expert_gemm(*args))
        rec["device_ms"] = timer.device_ms(
            lambda: EG.quant_expert_gemm(*args), "quant_expert_gemm")
        rec["plain_ms"] = timer.ms(lambda: EG.quant_expert_gemm_plain(*args))
        rec["library_ms"] = timer.ms(lib)
        rec["library_device_ms"] = timer.device_ms(lib)
        rec["library"] = (f"a loop of {E} torch._int_mm calls (rows padded "
                          f"to {Mp}) with the same quantization and "
                          f"epilogue")
    torch.cuda.synchronize()
    emit(rec)
    if not ok:
        fail(f"quant_expert_gemm at C={C} disagrees with its plain version: "
             f"{rec}")
    return rec, (t_bytes, t_ops)


def check_kernels(paths, device, timed, max_err):
    """Every kernel against its plain version at every shape a path gave it
    (each shape class at each of that path's buckets, or capacities for the
    routed expert GEMM and its buffers; the decode kernel on the operands of
    the longest tick, in all three modes), timed at the profile bucket of
    encoder paths, at the decode paths' 8 slots and at the MoE path's served
    capacity; fills ``timed`` (key -> (record, (bytes bound, ops bound)))
    and ``max_err`` (kernel -> its largest max abs error)."""
    classes = collections.OrderedDict()
    for path in paths:
        for key, case in path["cases"].items():
            # a routed path's case carries its member's params
            c = classes.setdefault(key, {"layer": case["layer"],
                                         "path": path, "buckets": set(),
                                         "qparams": case.get(
                                             "qparams", path.get("qparams"))})
            c["buckets"] |= set(path["buckets"])
    timer = Timer(device)
    for key, c in classes.items():
        path = c["path"]
        if key[0] == "decode_attention":
            rec, tb = run_decode_case(path, key[1], device, timer)
            timed[key] = (rec, tb)
            max_err[key[0]] = max(max_err[key[0]], rec["max_abs_err"])
            if key[1] == "per_head_p_scale":       # the third mode
                rec, _ = run_decode_case(path, "per_head", device)
                max_err[key[0]] = max(max_err[key[0]], rec["max_abs_err"])
            continue
        routed = key[0] == "quant_expert_gemm" or key[-1] == "experts"
        # a bucket, or for the routed buffers a capacity per expert
        for shape in path["capacities"] if routed else sorted(c["buckets"]):
            at = shape == (path["timed_capacity"] if routed
                           else path["timed_bucket"])
            # the expert GEMM is timed at a forward's capacity as well
            t = timer if at or key[0] == "quant_expert_gemm" else None
            if key[0] == "quant_expert_gemm":
                rec, tb = run_expert_case(path, key, c["layer"], shape,
                                          device, t)
            else:
                bucket = ((path["cfg"].moe.num_experts, shape) if routed
                          else shape)
                rec, tb = run_case(path["cfg"], key, c["layer"], bucket,
                                   c["qparams"], device, t)
            max_err[key[0]] = max(max_err[key[0]], rec["max_abs_err"])
            if at:
                timed[key] = (rec, tb)


def summarize(paths, timed, max_err, flash, long_decode, wide_page,
              long_attention, wide, wide_heads, mesh, arch_mesh):
    """The per-kernel summary entries: sums over one forward of the span
    path, else one tick of the decode path, else one tick of the MoE path,
    and over one forward or tick of each path under ``by_path``; for the
    float ``flash_attention``, which no served path runs, its long-context
    path's qwen2 float32 call, each case under ``by_case``; for
    ``decode_attention`` also its call at 4096 cached tokens a slot
    (``long_context``) and at head dim 256 with pages of 128
    (``hd256_pages128``), for ``quant_flash_attention`` its calls at 512
    positions (``bert_512``), and for the three attention kernels their
    calls at head dims over 256 (``wide_head_dims``). Every entry carries
    its launches per rank a forward or tick on the mesh paths
    (``mesh_launches_per_rank``: ``mesh_path``'s, and ``arch_mesh_path``'s
    by model and topology), and ``quant_expert_gemm`` its accumulator mode
    (``accumulator_mode``: its launches a tensor-parallel tick and its
    calls at the mesh shapes)."""
    arch_launches, acc_ticks, acc_cases = arch_mesh

    def mesh_launches(name):
        out = dict(mesh[name])
        for arch, runs in arch_launches.items():
            for t, per in runs.items():
                out[f"arch_mesh_path {arch} {t}"] = per.get(name, 0.0)
        return out

    def sums(path, name):
        out = {"launches": path["launches"][name],
               "launches_per_" + path["unit"]: path["per_fwd"][name],
               "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "library_ms": 0.0, "library_device_ms": 0.0}
        t_bytes = t_ops = 0.0
        for key, case in path["cases"].items():
            if key[0] != name:
                continue
            rec, (tb, to) = path.get("timed", timed)[key]
            n = case["count"]
            for f in ("ms", "plain_ms", "bound_ms"):
                out[f] += n * rec[f]
            t_bytes += n * tb
            t_ops += n * to
            for f in ("device_ms", "library_ms", "library_device_ms"):
                out[f] = (None if measured(rec[f]) is None or out[f] is None
                          else out[f] + n * rec[f])
        out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        return out

    summary = []
    for name, (src, rep) in KERNELS.items():
        if name == "flash_attention":
            top = flash[0]
            entry = {"name": name, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": sum(r["launches"] for r in flash),
                     "max_abs_err": max(r["max_abs_err"] for r in flash)}
            entry.update({f: top[f] for f in TIMES})
            entry["served_path_launches"] = {
                p["name"]: p["launches"][name] for p in paths}
            entry["by_case"] = {r["case"]: {f: r[f] for f in (
                "launches", "max_abs_err") + TIMES} for r in flash}
            entry["per"] = ("one call of ops.flash_attention at qwen2's 32k "
                            "causal prefill in float32 (by_case: each "
                            "case); launches: one a call of the flash path")
            _wide_heads(entry, wide_heads[name])
            entry["mesh_launches_per_rank"] = mesh_launches(name)
            summary.append(entry)
            continue
        by_path = {p["name"]: sums(p, name) for p in paths
                   if p["per_fwd"][name]}
        top = next(by_path[n] for n in ("span_path", "decode_path",
                                        "main_path", "moe_decode_path")
                   if n in by_path)
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": sum(b["launches"] for b in by_path.values()),
                 "max_abs_err": max_err[name]}
        entry.update({f: top[f] for f in TIMES})
        entry["by_path"] = by_path
        if name == "decode_attention":
            for case, r in (("long_context", long_decode),
                            ("hd256_pages128", wide_page)):
                entry[case] = {f: r[f] for f in (
                    "slots", "head_dim", "valid_tokens", "page_size",
                    "pages_per_slot", "splits", "max_abs_err", "exact")
                    + TIMES}
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           r["max_abs_err"])
        if name == "quant_flash_attention":
            entry["bert_512"] = {k: {f: r[f] for f in (
                "valid_keys", "max_abs_err", "exact") + TIMES}
                for k, r in long_attention.items()}
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [
                r["max_abs_err"] for r in long_attention.values()])
        if name in wide_heads:
            _wide_heads(entry, wide_heads[name])
        if name in wide:
            r = wide[name]
            entry["wide_rows"] = {f: r[f] for f in (
                "M", "D", "max_abs_err") + TIMES}
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       r["max_abs_err"])
        entry["per"] = (f"one forward of the span path at bucket "
                        f"{PROFILE_BUCKET}, or one tick of the decode path "
                        f"at its longest ({DECODE_SLOTS} slots) where the "
                        f"span path does not run the kernel, or one tick "
                        f"of the MoE path where neither does: the sum over "
                        f"its launches (by_path for each path); launches: "
                        f"the counted runs of every path")
        entry["mesh_launches_per_rank"] = mesh_launches(name)
        if name == "quant_expert_gemm":
            entry["accumulator_mode"] = {
                "launches_per_tp_tick": {k: v for k, v in acc_ticks.items()
                                         if v},
                "cases": [{k: r[k] for k in (
                    "model", "G", "E", "C", "D", "F", "per_token_scales",
                    "max_abs_err") + TIMES if k in r} for r in acc_cases]}
        summary.append(entry)
    return measured(summary)


def _wide_heads(entry, recs):
    """Add a kernel's calls at head dims over 256 to its summary entry."""
    entry["wide_head_dims"] = {k: {f: r[f] for f in (
        "head_dim", "max_abs_err") + TIMES} for k, r in recs.items()}
    entry["max_abs_err"] = max([entry["max_abs_err"]] + [
        r["max_abs_err"] for r in recs.values()])


def kernel_named(kernel: str, device_name: str) -> bool:
    """Whether a profiled device kernel is one of ``kernel``'s CUDA
    functions, its wide kernel (head dims over 256) included
    (``flash_attention_kernel`` is a suffix of
    ``quant_flash_attention_kernel``, so the name must not follow a letter
    or an underscore)."""
    import re
    return re.search(r"(^|[^A-Za-z_])" + kernel + r"(_wide)?_kernel",
                     device_name) is not None


def phase_profile(model, paths, device):
    """Forwards of each path at the (8, 128) bucket and serving passes of
    the requests, both timed on the host in turns (main, span, span, main,
    twice: one call's host is shared and drifts), then ``torch.profiler`` over
    forwards of each path: device-busy ms, idle share, ms of each ported
    kernel, the top device kernels and the top host ops by self time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, S = PROFILE_BUCKET
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(1, model["cfg"].vocab_size, (B, S),
                                     dtype=np.int32)}
    lengths = np.full((B,), S, np.int32)
    n = 5

    def forwards(path):
        for _ in range(n):
            path["fused"].runtime.encode(path["qparams"], inputs, lengths)

    paths = [p for p in paths if p["unit"] == "forward" and "fused" in p]
    for path in paths:
        for _ in range(3):
            path["fused"].runtime.encode(path["qparams"], inputs, lengths)
    walls = collections.defaultdict(list)
    rates = collections.defaultdict(list)
    for path in (paths + paths[::-1]) * 2:
        torch.cuda.synchronize()
        t = time.perf_counter()
        forwards(path)
        torch.cuda.synchronize()
        walls[path["name"]].append((time.perf_counter() - t) * 1e3 / n)
        _, wall = serve(path["fused"], model["requests"])
        rates[path["name"]].append(N_REQUESTS / wall)
    for path in paths:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forwards(path)
            torch.cuda.synchronize()
        by_name, kernels_run = collections.Counter(), 0
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
                kernels_run += 1
        busy = sum(by_name.values()) / n
        if busy <= 0.0:
            fail("the profiler recorded no device time")
        wall_ms = statistics.median(walls[path["name"]])
        ported = {k: sum(v for name, v in by_name.items()
                         if kernel_named(k, name)) / n for k in KERNELS}
        top = [{"kernel": name[:100], "ms_per_forward": v / n,
                "share_of_busy": v / n / busy}
               for name, v in by_name.most_common(8)]
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        top_host = [{"op": e.key[:80], "calls_per_forward": e.count / n,
                     "self_ms_per_forward": e.self_cpu_time_total / 1e3 / n}
                    for e in host[:8]]
        emit({"phase": "profile", "path": path["name"],
              "bucket": list(PROFILE_BUCKET), "forward_wall_ms": wall_ms,
              "forward_wall_ms_runs": walls[path["name"]],
              "requests_per_s_runs": rates[path["name"]],
              "device_busy_ms_per_forward": busy,
              "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
              "device_kernels_per_forward": kernels_run / n,
              "ported_kernels_ms_per_forward": ported,
              "top_device_kernels": top, "top_host_ops": top_host})


def phase_profile_decode(path):
    """A window of full decode ticks (every slot live) of the decode path's
    fused engine: the host's wall per tick over 10 ticks, then
    ``torch.profiler`` over 10 more: device-busy ms per tick, idle share,
    ms per tick of each ported kernel, the top device kernels and host
    ops."""
    import statistics as st
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request

    eng, n = path["fused"], 10
    for i, p in enumerate(path["prompts"][:DECODE_SLOTS]):
        eng.submit(Request(uid=i, prompt=list(p),
                           max_tokens=DECODE_MAX_TOKENS))
    for _ in range(5):
        eng.step()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t) * 1e3)
    live = len(eng.sched.live())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    by_name, kernels_run = collections.Counter(), 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            kernels_run += 1
    busy = sum(by_name.values()) / n
    if busy <= 0.0:
        fail("the profiler recorded no device time in the decode window")
    wall_ms = st.median(walls)
    ported = {k: sum(v for name, v in by_name.items()
                     if kernel_named(k, name)) / n for k in KERNELS}
    top = [{"kernel": name[:100], "ms_per_tick": v / n,
            "share_of_busy": v / n / busy}
           for name, v in by_name.most_common(8)]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    top_host = [{"op": e.key[:80], "calls_per_tick": e.count / n,
                 "self_ms_per_tick": e.self_cpu_time_total / 1e3 / n}
                for e in host[:8]]
    emit({"phase": "profile", "path": path["name"], "slots_live": live,
          "tick_wall_ms": wall_ms, "tick_wall_ms_runs": walls,
          "device_busy_ms_per_tick": busy,
          "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
          "device_kernels_per_tick": kernels_run / n,
          "ported_kernels_ms_per_tick": ported,
          "top_device_kernels": top, "top_host_ops": top_host})


# ---------------------------------------------------------------------------
# mesh_path: multi-GPU serving on mesh ranks (slice 16)
# ---------------------------------------------------------------------------

MESH_TOPOLOGIES = ("2,1", "1,2")    # (data, model): 2-way DP, 2-way TP
MESH_PROMPTS = 8                    # of decode_path's prompts
MESH_MAX_TOKENS = 16
MESH_EXACT_TOKENS = 8               # the all-int8 plan's decode check
MESH_DEADLINE_S = 400.0
# a meshed encode against main_path's (rel-Linf of the logits): tensor
# parallel reorders its float layers' sums (row-parallel partial sums,
# half-width GEMMs), and at full width one int8 code flipped at a tie
# moves the logits by about a code's share of the range. The unmeshed port
# itself moves main_path's logits by 7.4e-3 to 1.44e-2 between one call
# of 8 rows and two of 4 (the same effect; ``unmeshed_rebatch_rel_linf``,
# four groups of 8 requests, PERF.md), above the encoder's 5e-3: the
# budget is 1.7 times the largest reading. Data parallel is held bit for
# bit at the per-rank shapes instead
MESH_BUDGET = 2.5e-2
# tensor-parallel golden decode, teacher-forced on the unmeshed 8-slot
# run's tokens, against that run's logits row by row (max rel-Linf): the
# float layers' reordered sums flip int8 codes at ties, in the activations
# and in the int8 pages, where they stay. The unmeshed port at 4 slots
# differs from itself at 8 by the same effect, 4.40e-2 on the rows both saw
# (``unmeshed_4_vs_8``; tensor parallel 4.36e-2, PERF.md): the budget is
# about twice that
MESH_DECODE_BUDGET = 1e-1
# the same decode under an all-int8 plan (every GEMM and both attention
# matmuls int8, static and dynamic scales): tensor parallel sums exact
# int32 accumulators and codes at the whole tensor's scales, so only the
# float unembedding's half-width GEMM reorders a sum: rows within this
# rel-Linf and every argmax equal
MESH_EXACT_TOL = 1e-5
# launches per rank a forward (encode) or a tick (decode): every topology
# runs the unmeshed path's kernels on the rank's rows or its block (the
# row-parallel GEMMs in the accumulator mode, the per-token ones coded at
# the whole row's scale: one launch each, as unmeshed)
EXPECTED_MESH = {
    ("mesh_encode_path", "2,1"): EXPECTED["main_path"],
    ("mesh_encode_path", "1,2"): EXPECTED["main_path"],
    ("mesh_decode_path", "2,1"): EXPECTED_DECODE,
    ("mesh_decode_path", "1,2"): EXPECTED_DECODE,
}


def _mesh_kernel_checks(device):
    """The kernels at the shapes 2-way TP gives them, against their plain
    versions on the same inputs: ``quant_linear``'s accumulator mode on
    the row-parallel GEMMs (BERT's M = 1024 rows of K 384 / 1536, qwen2's
    8 of 448 / 2432; exact), its fused epilogue on qwen2's column-parallel
    shards (N = 64 for wk / wv, 448 for wq, 2432 for wg / wu; rel-Linf
    1e-6), ``dynamic_quant``'s scale-in mode on the per-token row-parallel
    inputs (exact), ``fused_embed`` on the 384-column slice of BERT's
    tables (exact) and ``decode_attention`` on a rank's one KV head and its
    7 query heads over int8 per-token pages (max abs 2e-5, as the kernel
    phase). Returns {name: (error, tolerance)}, the error a max abs
    difference (the epilogue's a rel-Linf)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dynamic_quant as dq
    from repro_torch.kernels import fused_embed as fe
    from repro_torch.kernels import quant_linear as ql
    g = torch.Generator(device=device).manual_seed(16)
    err = collections.defaultdict(float)

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=device,
                             dtype=torch.int8)
    for M, K, N in ((1024, 384, 768), (1024, 1536, 768), (8, 448, 896),
                    (8, 2432, 896)):
        xq, wq = codes(M, K), codes(K, N)
        acc = ql.quant_linear_acc(xq, wq)
        ref = ql.quant_linear_acc(xq.cpu(), wq.cpu())
        err["quant_linear acc"] = max(err["quant_linear acc"], float(
            (acc.cpu() - ref).abs().max()))
    for N, act in ((64, None), (448, None), (2432, "silu")):
        xq, wq = codes(8, 896), codes(896, N)
        ws = torch.rand(N, generator=g, device=device) * 1e-3
        bias = torch.randn(N, generator=g, device=device)
        args = (xq, wq, ws, torch.tensor(0.02, device=device))
        y = ql.quant_linear(*args, bias=bias, act=act)
        want = ql.quant_linear_plain(*args, bias=bias, act=act)
        err["quant_linear shard"] = max(err["quant_linear shard"],
                                        rel_linf(want, y))
    for M, D in ((1024, 1536), (8, 2432)):
        x = torch.randn((M, 2 * D), generator=g, device=device)
        amax = x.abs().amax(dim=-1)
        part = x[:, :D].contiguous()
        q, s = dq.dynamic_quant(part, row_amax=amax)
        q_ref, s_ref = dq.dynamic_quant_plain(part, amax)
        err["dynamic_quant"] = max(err["dynamic_quant"], float(
            (q.int() - q_ref.int()).abs().max()), float(
            (s - s_ref).abs().max()))
    tok = torch.randn((30522, 384), generator=g, device=device)
    pos = torch.randn((512, 384), generator=g, device=device)
    seg = torch.randn((2, 384), generator=g, device=device)
    ids = torch.randint(0, 30522, (1024,), generator=g, device=device)
    p_ids = torch.arange(1024, device=device) % 128
    s_ids = torch.zeros(1024, dtype=torch.int64, device=device)
    y = fe.fused_embed(ids, tok, pos, seg, s_ids, positions=p_ids)
    y_ref = fe.fused_embed_plain(ids, tok, pos, seg, s_ids, positions=p_ids)
    err["fused_embed"] = float((y - y_ref).abs().max())
    # decode_path's 8 slots of up to 128 tokens over pages of 16, a rank's
    # one KV head of qwen2's two
    B, pps, ps, hd = DECODE_SLOTS, DECODE_MAX_LEN // PAGE_SIZE, PAGE_SIZE, 64
    NP = B * pps
    args = {"q": torch.randn((B, 1, 7, hd), generator=g, device=device),
            "k_pages": codes(NP, ps, 1, hd), "v_pages": codes(NP, ps, 1, hd),
            "page_table": torch.randperm(NP, generator=g, device=device)
            .to(torch.int32).reshape(B, pps),
            "lengths": torch.randint(1, pps * ps + 1, (B,), generator=g,
                                     device=device, dtype=torch.int32),
            "k_scale": torch.rand((NP, ps, 1), generator=g, device=device)
            * 1e-2,
            "v_scale": torch.rand((NP, ps, 1), generator=g, device=device)
            * 1e-2, "per_head": False}
    out = da.decode_attention(**args)
    err["decode_attention"] = float(
        (out - da.decode_attention_plain(**args)).abs().max())
    tol = {"quant_linear shard": 1e-6, "decode_attention": 2e-5}
    return {k: (v, tol.get(k, 0.0)) for k, v in err.items()}


def _mesh_served(engine, counted):
    """One served run on a mesh rank, counted: (launches, forwards or
    ticks, host s, collective calls and s)."""
    import torch
    from repro_torch import kernels
    from repro_torch.distributed import comm
    before = engine.runtime.stats["calls"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    comm.reset_stats()
    t = time.perf_counter()
    out = counted()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (out, kernels.launch_counts(),
            engine.runtime.stats["calls"] - before, wall, dict(comm.STATS))


def _rank_rows_exact(eng, calls, device):
    """Each data-parallel call's rows this rank ran against an unmeshed
    runtime encoding the same rows at the rank's bucket (the per-rank
    shapes, so every float op runs as unmeshed): max abs difference."""
    import numpy as np
    from repro_torch.serve import Runtime
    from repro_torch.serve.runtime import bucket_size
    rt, diff = eng.runtime, 0.0
    for inputs, lengths, out in calls:
        B = len(lengths)
        Bb = -(-bucket_size(B, rt.min_batch) // rt._dp) * rt._dp
        lo, hi = rt.rows(Bb)
        own = Runtime(rt.cfg, rt.plan, head=rt.head,
                      token_level=rt.token_level, max_len=rt.max_len,
                      min_batch=hi - lo, backend="fused", device=device)
        n = min(hi, B)
        if n <= lo:
            continue
        want = own.encode(eng.params, {k: v[lo:n] for k, v in inputs.items()},
                          lengths[lo:n])
        diff = max(diff, float(np.abs(want - out[lo:n]).max()))
    return diff


class RowLogits:
    """Wraps an engine's decode step and keeps each live row's logits on
    the device by (request uid, position), with the tokens each request
    was fed: two runs compare wherever a request saw the same tokens,
    whatever their slots and ticks."""

    def __init__(self, engine):
        self.engine = engine
        self.step, engine._decode = engine._decode, self
        self.rows = {}

    def __call__(self, params, caches, tokens, pos, active, pages=None):
        import numpy as np
        out, caches = self.step(params, caches, tokens, pos, active, pages)
        for s in np.flatnonzero(active):
            uid = self.engine.sched.active[s].uid
            self.rows[(uid, int(pos[s]))] = out[s].float().clone()
        return out, caches


def _compare_rows(ref, got):
    """``got``'s logit rows against ``ref``'s on the rows both computed from
    the same tokens (``seq``: each uid's prompt and output): the rows
    compared, their max rel-Linf, the sampled positions whose argmax
    differs, and the tokens each request's argmax kept before its first
    difference (what a free-running run generates before it diverges)."""
    rows, worst, differ, kept = 0, 0.0, 0, 0
    for uid, seq in got["seq"].items():
        want = ref["seq"][uid]
        n = 0
        while n < min(len(seq), len(want)) and seq[n] == want[n]:
            n += 1
        first = ref["prompt_len"][uid] - 1       # the first sampled row
        diverged = False
        for pos in range(n):
            a, b = ref["rows"].get((uid, pos)), got["rows"].get((uid, pos))
            if a is None or b is None:
                continue
            rows += 1
            worst = max(worst, rel_linf(a, b))
            if pos >= first:
                same = int(a.argmax()) == int(b.argmax())
                differ += not same
                diverged |= not same
                kept += not diverged
    return {"rows": rows, "ref_rows": sum(uid in got["seq"]
                                          for uid, _ in ref["rows"]),
            "max_rel": worst, "argmax_differ": differ, "tokens_kept": kept}


# ---------------------------------------------------------------------------
# http_mesh_path: the HTTP front-end on mesh ranks (slice 19), run inside
# mesh_path's ranks on the engines they built
# ---------------------------------------------------------------------------


def _http_mesh_session(rank, fe_or_engines, scenario, counted):
    """One front-end session on a mesh: rank 0 serves ``scenario`` over
    HTTP (:func:`run_http`) with its driver publishing each pass's engine
    operations; every other rank replays them (``driver.follow``). Kernel
    launches and collectives are counted over the session on each rank;
    ``counted()`` gives (forwards or ticks) so far. Returns the rank's
    record."""
    import torch
    from repro_torch import kernels
    from repro_torch.distributed import comm
    from repro_torch.serve.frontend.driver import follow
    torch.cuda.synchronize()
    before = counted()
    kernels.reset_launches()
    comm.reset_stats()
    t = time.perf_counter()
    if rank == 0:
        out = run_http(fe_or_engines, scenario)
    else:
        out = {"replayed": follow(**fe_or_engines,
                                  receive=comm.broadcast_object)}
    torch.cuda.synchronize()
    out.update(session_s=time.perf_counter() - t,
               launches=kernels.launch_counts(), units=counted() - before,
               collectives=dict(comm.STATS), control=dict(comm.CONTROL))
    return out


def _http_mesh_encode(rank, eng, requests, device):
    """``http_mesh_path``'s encode on one topology: ``mesh_path``'s 32
    requests over HTTP to a front-end on rank 0 whose engine shares the
    meshed ``eng``'s runtime, every rank running every forward; then each
    rank feeds the micro-batches rank 0's batcher made, in order, to
    ``eng`` itself (the direct meshed engine, timed) and holds each
    request's logits against the front-end's."""
    import asyncio
    import numpy as np
    from repro_torch.distributed import comm
    from repro_torch.serve import EncoderRequest, EncoderServeEngine
    from repro_torch.serve.frontend import HTTPFrontend

    served = EncoderServeEngine(eng.cfg, eng.params, eng.plan,
                                target=eng.target, runtime=eng.runtime,
                                max_batch=HTTP_SLOTS, max_wait=0.005,
                                max_len=HTTP_MAX_LEN, device=device)
    batches, logits = [], {}
    ready, step = served.batcher.ready, served.step

    def spy_ready(now=None, force=False):
        got = ready(now, force)
        batches.extend([r.uid for r in reqs] for _, reqs in got)
        return got

    def spy_step(now=None, force=False):
        done = step(now, force)
        logits.update({r.uid: np.asarray(r.logits) for r in done})
        return done
    served.batcher.ready, served.step = spy_ready, spy_step

    async def scenario(port):
        t = time.perf_counter()
        res = await asyncio.gather(*(http_json(
            port, "POST", "/v1/encode", {"tokens": toks})
            for toks in requests))
        return {"results": res, "wall": time.perf_counter() - t}

    if rank == 0:
        fe = HTTPFrontend(encoder=served, port=0, log=_quiet,
                          publish=comm.broadcast_object)
        got = _http_mesh_session(rank, fe, scenario,
                                 lambda: eng.runtime.stats["calls"])
        got["p50"] = fe.driver.latency.quantile(0.5)
        got["p95"] = fe.driver.latency.quantile(0.95)
    else:
        got = _http_mesh_session(rank, {"encoder": served}, None,
                                 lambda: eng.runtime.stats["calls"])
    # every rank replays rank 0's batches, so every rank runs the same
    # collectives; a follower's own batches must equal them
    order = comm.broadcast_object(batches if rank == 0 else None)
    by_uid = {}
    # the front-end numbers its requests from 1 in arrival order: map each
    # uid to its tokens through rank 0's record of what it answered
    tokens = comm.broadcast_object(
        {o["uid"]: requests[i] for i, (s, _, o) in enumerate(
            got["results"]) if s == 200} if rank == 0 else None)
    t = time.perf_counter()
    for group in order:
        calls = eng.runtime.stats["calls"]
        for uid in group:
            eng.submit(EncoderRequest(uid=uid, tokens=list(tokens[uid])))
        by_uid.update({r.uid: r for r in eng.run()})
        if eng.runtime.stats["calls"] - calls != 1:
            fail(f"http_mesh_path: a micro-batch of {len(group)} took "
                 f"{eng.runtime.stats['calls'] - calls} forwards")
    direct_wall = time.perf_counter() - t
    diff = max((float(np.abs(logits[u] - by_uid[u].logits).max())
                for u in by_uid), default=float("inf"))
    rec = {"batches_equal_rank_0": batches == order,
           "micro_batches": [len(g) for g in order],
           "engine_vs_direct_max_abs": diff,
           "answered": len(logits), "direct_wall_s": direct_wall,
           "direct_requests_per_s": len(requests) / direct_wall,
           "session_s": got["session_s"], "launches": got["launches"],
           "forwards": got["units"], "control": got["control"],
           "collectives": got["collectives"]}
    if rank == 0:
        statuses = [s for s, _, _ in got["results"]]
        objs = {o["uid"]: o for s, _, o in got["results"] if s == 200}
        http = {u: np.asarray(o["logits"], np.float32)
                for u, o in objs.items()}
        rec.update(
            statuses=dict(collections.Counter(statuses)),
            http_vs_direct_max_abs=max(
                (float(np.abs(http[u] - by_uid[u].logits).max())
                 for u in http), default=float("inf")),
            predictions_equal=all(
                objs[u]["prediction"] == int(by_uid[u].prediction)
                for u in objs) and len(objs) == len(requests),
            http_wall_s=got["wall"],
            http_requests_per_s=len(requests) / got["wall"],
            latency_p50_s=got["p50"], latency_p95_s=got["p95"],
            listen_s=got["listen_s"])
    else:
        rec["replayed"] = got["replayed"]
    return rec


def _http_mesh_drain(rank, eng, device):
    """A drain on a mesh: one request in flight (its forced flush held at
    a gate on rank 0 until the new request's answer is read) answers 200,
    a request after ``begin_drain`` 503, then rank 0's ``stop`` ends the
    follower and both ranks return."""
    import asyncio
    import threading
    from repro_torch.distributed import comm
    from repro_torch.serve import EncoderServeEngine
    from repro_torch.serve.frontend import HTTPFrontend

    served = EncoderServeEngine(eng.cfg, eng.params, eng.plan,
                                target=eng.target, runtime=eng.runtime,
                                max_batch=HTTP_SLOTS, max_wait=30.0,
                                max_len=HTTP_MAX_LEN, device=device)
    if rank:
        got = _http_mesh_session(rank, {"encoder": served}, None,
                                 lambda: 0)
        return {"replayed": got["replayed"]}
    gate = threading.Event()
    step = served.step

    def gated(now=None, force=False):
        if force:
            gate.wait(HTTP_SESSION_S)
        return step(now, force)
    served.step = gated
    fe = HTTPFrontend(encoder=served, port=0, log=_quiet,
                      publish=comm.broadcast_object)

    async def drain(port):
        try:
            inflight = asyncio.create_task(http_json(
                port, "POST", "/v1/encode", {"tokens": [4, 5, 9, 2]}))
            for _ in range(1000):
                if fe.driver.inflight:
                    break
                await asyncio.sleep(0.01)
            fe.begin_drain()
            rejected = await http_json(port, "POST", "/v1/encode",
                                       {"tokens": [5, 5, 9, 2]})
        finally:
            gate.set()
        done = await inflight
        await asyncio.wait_for(fe.serve_forever(), HTTP_SESSION_S)
        return {"done": done, "rejected": rejected}

    got = _http_mesh_session(rank, fe, drain, lambda: 0)
    return {"inflight_status": got["done"][0],
            "new_status": got["rejected"][0],
            "retry_after": got["rejected"][1].get("retry-after")}


def _http_mesh_generate(rank, make_engine, prompts, direct_run=None):
    """``http_mesh_path``'s generate on one topology: the prompts as
    concurrent SSE streams of ``MESH_MAX_TOKENS`` tokens to a meshed
    decode front-end on rank 0, every rank ticking; then a fresh engine
    of the same mesh serves them directly (timed), unless ``direct_run``
    (``mesh_path``'s own free-running record at this topology: its tokens,
    wall and pages) already did: tokens, the ``done`` transcripts and the
    pages left."""
    import asyncio
    from repro_torch.distributed import comm
    from repro_torch.serve.frontend import HTTPFrontend

    eng = make_engine()

    async def scenario(port):
        t = time.perf_counter()
        res = await asyncio.gather(*(http_sse(
            port, {"prompt": p, "max_tokens": MESH_MAX_TOKENS})
            for p in prompts))
        return {"results": res, "wall": time.perf_counter() - t}

    if rank == 0:
        fe = HTTPFrontend(decode=eng, port=0, log=_quiet,
                          publish=comm.broadcast_object)
        got = _http_mesh_session(rank, fe, scenario,
                                 lambda: eng.stats["ticks"])
        got["p50"] = fe.driver.latency.quantile(0.5)
        got["p95"] = fe.driver.latency.quantile(0.95)
    else:
        got = _http_mesh_session(rank, {"decode": eng}, None,
                                 lambda: eng.stats["ticks"])
    if direct_run is None:
        direct = make_engine()
        want, direct_wall = serve_decode(direct, prompts,
                                         max_tokens=MESH_MAX_TOKENS)
        direct_pages = direct.kv_pages_in_use
    else:
        want, direct_wall, direct_pages = (direct_run["tokens"],
                                           direct_run["wall_s"],
                                           direct_run["pages_in_use"])
    generated = len(prompts) * MESH_MAX_TOKENS
    rec = {"ticks": got["units"], "launches": got["launches"],
           "session_s": got["session_s"], "control": got["control"],
           "collectives": got["collectives"],
           "pages_in_use_after": eng.kv_pages_in_use + direct_pages,
           "direct_reused_from_mesh_path": direct_run is not None,
           "direct_wall_s": direct_wall,
           "direct_generated_tokens_per_s": generated / direct_wall}
    if rank == 0:
        streams, bad = {}, []
        for i, (status, events) in enumerate(got["results"]):
            toks = ([d["token"] for e, d in events if e == "token"]
                    if status == 200 else None)
            done = ([d for e, d in events if e == "done"]
                    if toks is not None else [])
            streams[i] = toks
            if status != 200 or len(done) != 1 \
                    or done[0]["tokens"] != toks \
                    or len(toks) != MESH_MAX_TOKENS:
                bad.append((i, status, len(done), toks and len(toks)))
        rec.update(tokens_equal_direct=streams == want, bad_streams=bad,
                   sse_wall_s=got["wall"],
                   sse_generated_tokens_per_s=generated / got["wall"],
                   latency_p50_s=got["p50"], latency_p95_s=got["p95"])
    else:
        rec["replayed"] = got["replayed"]
    return rec


def _children(pid: int) -> dict:
    """{pid: command line} of ``pid``'s child processes, read from /proc."""
    import os
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == pid:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    out[int(d)] = f.read().replace(b"\0", b" ").decode()
        except (OSError, ValueError, IndexError):
            continue
    return out


def start_http_mesh_cli():
    """Start ``http_mesh_path``'s server CLI in the background once the
    kernels are built (it loads them; its ranks build full-width BERT-base
    and calibrate on the mesh beside the earlier phases): ``python -m
    repro_torch.launch.server --arch bert-base --plan <the tiled golden
    plan> --backend fused --mesh 2,1 --port 0``, in a session of its own
    so every rank can be stopped. Its output lines are read, with their
    times, by a thread. Returns its handle."""
    import os
    import queue
    import tempfile
    import threading
    from repro_torch.core.plan import PrecisionPlan
    tmp = Path(tempfile.mkdtemp(prefix="samp_http_mesh_"))
    golden = PrecisionPlan.load(str(GOLDEN_PLAN))
    PrecisionPlan(golden.layers * TILE, golden.float_dtype).save(
        str(tmp / "golden_x3.json"))
    argv = [sys.executable, "-m", "repro_torch.launch.server", "--arch",
            "bert-base", "--task", "tnews", "--mesh", "2,1"] \
        + _server_argv(tmp / "golden_x3.json")
    err = (tmp / "server.err").open("w")
    cli = {"tmp": tmp, "err": err, "t0": time.perf_counter(),
           "lines": queue.Queue(), "out": []}
    cli["proc"] = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        start_new_session=True)

    def read():
        for line in cli["proc"].stdout:
            cli["lines"].put((time.perf_counter(), line.rstrip()))
        cli["lines"].put((time.perf_counter(), None))
    threading.Thread(target=read, daemon=True).start()
    return cli


def stop_http_mesh_cli(cli):
    """Stop the server CLI's session (its ranks with it) if it still runs,
    and remove its files."""
    import os
    import shutil
    import signal
    if cli is None:
        return
    if cli["proc"].poll() is None:
        os.killpg(cli["proc"].pid, signal.SIGKILL)
        cli["proc"].wait()
    cli["err"].close()
    shutil.rmtree(cli["tmp"], ignore_errors=True)


def phase_http_mesh_cli(cli, model, card):
    """``http_mesh_path``'s CLI, started by :func:`start_http_mesh_cli`:
    its ``listening on`` line (the start-up seconds since its start), its
    two ranks among its children, ``/healthz`` and one ``/v1/encode``
    answered, then SIGTERM: exit 0 within ``HTTP_EXIT_S`` after ``drained;
    bye``, and no rank left."""
    import asyncio
    import os
    import queue
    import re
    import signal
    proc, out = cli["proc"], cli["out"]
    port = start_s = None

    def err():
        cli["err"].flush()
        return (cli["tmp"] / "server.err").read_text()[-3000:]
    while port is None:
        left = HTTP_START_S - (time.perf_counter() - cli["t0"])
        try:
            at, line = cli["lines"].get(timeout=max(left, 0.0))
        except queue.Empty:
            fail(f"http_mesh_path: the meshed server printed no listening "
                 f"line in {HTTP_START_S} s: {out} {err()}")
        if line is None:
            fail(f"http_mesh_path: the meshed server exited "
                 f"({proc.wait()}) before listening: {out} {err()}")
        out.append(line)
        m = re.search(r"listening on http://[\d.]+:(\d+)", line)
        if m:
            port, start_s = int(m.group(1)), at - cli["t0"]
    ranks = {p: c for p, c in _children(proc.pid).items()
             if "multiprocessing" in c and "resource_tracker" not in c}

    async def scenario():
        return (await http_json(port, "GET", "/healthz"),
                await http_json(port, "POST", "/v1/encode",
                                {"tokens": model["requests"][0]}),
                (await http_exchange(port, "GET", "/metrics"))[2])

    health, encoded, metrics = asyncio.run(scenario())
    t = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(HTTP_EXIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    exit_s = time.perf_counter() - t
    left = [p for p in ranks if os.path.exists(f"/proc/{p}")]
    while (item := cli["lines"].get(timeout=HTTP_EXIT_S))[1] is not None:
        out.append(item[1])
    info = [ln for ln in metrics.decode("utf-8").splitlines()
            if ln.startswith("samp_build_info")]
    rec = {"phase": "http_mesh_path", "part": "cli", "card": card,
           "mesh": "2,1", "start_s": start_s, "ranks": len(ranks),
           "healthz": health[2], "encode_status": encoded[0],
           "logits": len(encoded[2].get("logits", [])),
           "build_info": info, "exit_code": rc, "exit_s": exit_s,
           "ranks_left": left, "last_line": out[-1] if out else None,
           "kernels_lines": [ln for ln in out if "kernels loaded" in ln],
           "overlaps": "the train CLIs' tail, flash_path to mesh_path"}
    emit(rec)
    if health[0] != 200 or encoded[0] != 200 or rec["logits"] != 15 \
            or len(ranks) != 2 or not any('mesh="data=2,model=1"' in ln
                                          for ln in info):
        fail(f"http_mesh_path: the meshed server CLI: {rec} {err()}")
    if rc != 0 or left or "drained; bye" not in out[-1] \
            or len(rec["kernels_lines"]) != 1:
        fail(f"http_mesh_path: the meshed server CLI exited {rc} "
             f"{exit_s:.1f} s after SIGTERM, ranks left {left}: {out} "
             f"{err()}")
    return rec


def _check_http_mesh(ranks, card, failures):
    """``http_mesh_path``'s gates and records, from ``mesh_path``'s ranks:
    each rank's served logits 0.0 from the direct meshed engine fed the
    same micro-batches (rank 0's HTTP answers too, and the follower's
    batches equal rank 0's), predictions equal, SSE tokens equal to the
    direct meshed engine's with one ``done`` a stream, no page in use,
    launches a forward or tick as ``EXPECTED_MESH``, and the drain's
    200 / 503. Returns the launches a rank a forward or tick."""
    per_rank = collections.defaultdict(dict)
    for r in ranks:
        rank = r["rank"]
        for t in MESH_TOPOLOGIES:
            e, d = r[f"http encode {t}"], r[f"http drain {t}"]
            fwd = max(e["forwards"], 1)
            per = {k: v / fwd for k, v in e["launches"].items() if v}
            per_rank[("http_mesh_encode", t)][rank] = per
            want = EXPECTED_MESH[("mesh_encode_path", t)]
            emit({"phase": "http_mesh_path", "part": "encode", "rank": rank,
                  "topology": t, "model": "bert-base",
                  "launches_per_forward": per, "drain": d, "card": card,
                  **{k: v for k, v in e.items() if k != "launches"}})
            if e["engine_vs_direct_max_abs"] != 0.0 \
                    or not e["batches_equal_rank_0"] \
                    or e["answered"] != N_REQUESTS:
                failures.append(
                    f"http_mesh_path rank {rank} encode on {t}: "
                    f"{e['answered']} answered, "
                    f"{e['engine_vs_direct_max_abs']} from the direct "
                    f"engine, batches equal rank 0's "
                    f"{e['batches_equal_rank_0']}")
            if rank == 0 and (e["statuses"] != {200: N_REQUESTS}
                              or e["http_vs_direct_max_abs"] != 0.0
                              or not e["predictions_equal"]):
                failures.append(
                    f"http_mesh_path encode on {t}: statuses "
                    f"{e['statuses']}, HTTP logits "
                    f"{e['http_vs_direct_max_abs']} from the direct "
                    f"engine, predictions equal {e['predictions_equal']}")
            if per != want:
                failures.append(f"http_mesh_path rank {rank} encode on {t} "
                                f"launched {per} a forward, not {want}")
            if rank == 0 and (d["inflight_status"], d["new_status"],
                              d["retry_after"]) != (200, 503, "5"):
                failures.append(f"http_mesh_path drain on {t}: {d}")
            g = r[f"http generate {t}"]
            ticks = max(g["ticks"], 1)
            per = {k: v / ticks for k, v in g["launches"].items() if v}
            per_rank[("http_mesh_decode", t)][rank] = per
            want = EXPECTED_MESH[("mesh_decode_path", t)]
            emit({"phase": "http_mesh_path", "part": "generate",
                  "rank": rank, "topology": t, "model": "qwen2-0.5b",
                  "launches_per_tick": per, "card": card,
                  **{k: v for k, v in g.items() if k != "launches"}})
            if g["pages_in_use_after"] or (rank == 0 and (
                    not g["tokens_equal_direct"] or g["bad_streams"])):
                failures.append(
                    f"http_mesh_path rank {rank} generate on {t}: tokens "
                    f"equal the direct engine's "
                    f"{g.get('tokens_equal_direct')}, bad streams "
                    f"{g.get('bad_streams')}, "
                    f"{g['pages_in_use_after']} pages in use after")
            if per != want:
                failures.append(f"http_mesh_path rank {rank} generate on "
                                f"{t} launched {per} a tick, not {want}")
    return per_rank

def _mesh_rank(rank, device, job):
    """One rank of ``mesh_path``: full-width BERT-base and qwen2-0.5b
    calibrated on the mesh, quantized, and served at each topology, with
    the unmeshed runs its gates compare against."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.plan import LayerMode, LayerPlan, PrecisionPlan
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.quant import ptq
    from repro_torch.serve import EncoderServeEngine, ServeEngine

    out = {"rank": rank, "device": str(device),
           "backend": dist.get_backend(),
           "gloo_cuda": comm.probe_gloo_cuda(device)}
    meshes = {t: make_serving_mesh(t) for t in MESH_TOPOLOGIES}
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = setup_model(device)
    cfg = model["cfg"]
    # calibration on a mesh splits the batches over every rank, whatever
    # the topology: one run, on the tensor-parallel mesh
    out["stats"] = ptq.capture_stats(
        model["params"], model["batches"], cfg, model["float_plan"],
        precision=model["plan"], mesh=meshes["1,2"])
    qparams, qplan = ptq.apply_plan(model["params"], cfg, model["plan"],
                                    out["stats"],
                                    float_plan=model["float_plan"])
    del model["params"]
    out["encode_setup_s"] = time.perf_counter() - t0
    for t, mesh in meshes.items():
        eng = EncoderServeEngine(cfg, qparams, qplan, backend="fused",
                                 max_batch=8, device=device, mesh=mesh)
        serve(eng, model["requests"])              # warm-up, not counted
        calls, encode = [], eng.runtime.encode

        def spy(params, inputs, lengths=None):
            y = encode(params, inputs, lengths)
            calls.append(({k: np.asarray(v) for k, v in inputs.items()},
                          np.asarray(lengths), y))
            return y
        eng.runtime.encode = spy
        (done, _), launches, fwd, wall, coll = _mesh_served(
            eng, lambda: serve(eng, model["requests"]))
        eng.runtime.encode = encode
        rec = {"logits": np.stack([r.logits for r in done]),
               "predictions": [int(r.prediction) for r in done],
               "launches": launches, "forwards": fwd, "wall_s": wall,
               "collectives": coll,
               "wq_shard": tuple(eng.params["layers"][0]["attn"]["wq"]["w"]
                                 .values.shape)}
        if mesh.shape["data"] > 1:
            rec["rank_rows_max_abs_diff"] = _rank_rows_exact(eng, calls,
                                                             device)
        out[f"encode {t}"] = rec
        t0 = time.perf_counter()
        out[f"http encode {t}"] = _http_mesh_encode(
            rank, eng, model["requests"], device)
        out[f"http drain {t}"] = _http_mesh_drain(rank, eng, device)
        out["http_s"] = out.get("http_s", 0.0) + time.perf_counter() - t0
    del qparams, eng
    gc.collect()
    torch.cuda.empty_cache()

    with contextlib.redirect_stdout(io.StringIO()):   # rank 0 of the parent
        dec = setup_decoder(device)                    # prints its own
    cfg = dec["cfg"]
    prompts = dec["prompts"][:MESH_PROMPTS]
    kw = dict(max_len=DECODE_MAX_LEN, page_size=PAGE_SIZE,
              kv_cache="int8_per_token", backend="fused", device=device)

    def quantized(plan, mesh):
        t = time.perf_counter()
        stats = ptq.capture_stats(dec["params"], dec["batches"], cfg,
                                  dec["float_plan"], precision=plan,
                                  mesh=mesh)
        q = ptq.apply_plan(dec["params"], cfg, plan, stats,
                           float_plan=dec["float_plan"])
        return q, time.perf_counter() - t

    def decode(tree, plan, mesh, slots, max_tokens, forced=None):
        """One served run, counted and its rows kept; ``forced`` (a run's
        record) feeds each request that run's tokens (teacher forcing: the
        prompt and all but the last output, one token to generate)."""
        eng = ServeEngine(cfg, *tree, batch_slots=slots, mesh=mesh,
                          precision=plan, **kw)
        serve_decode(eng, [prompts[0][:4]], max_tokens=1)  # warm-up
        ticks0 = eng.stats["ticks"]
        feed = (prompts if forced is None else
                [forced["seq"][i][:-1] for i in range(len(prompts))])
        rows = RowLogits(eng)
        (tokens, _), launches, _, wall, coll = _mesh_served(
            eng, lambda: serve_decode(eng, feed, max_tokens=(
                max_tokens if forced is None else 1)))
        return {"tokens": tokens, "rows": rows.rows,
                "seq": {i: list(feed[i]) + tokens[i] for i in tokens},
                "prompt_len": {i: len(prompts[i]) for i in tokens},
                "launches": launches, "ticks": eng.stats["ticks"] - ticks0,
                "wall_s": wall, "collectives": coll,
                "pages_in_use": eng.kv_pages_in_use,
                "slots": int(eng.caches[0]["pos"].shape[0]),
                "kv_heads": int(eng.caches[1]["pages_k"].shape[2])}

    def summary(r):
        return {k: v for k, v in r.items()
                if k not in ("rows", "seq", "prompt_len")}

    golden = dec["plan"]
    tree, out["decode_setup_s"] = quantized(golden, meshes["2,1"])
    runs = {"unmeshed": decode(tree, golden, None, DECODE_SLOTS,
                               MESH_MAX_TOKENS)}
    # the unmeshed port at a rank's data-parallel slots
    runs["unmeshed_half"] = decode(tree, golden, None, DECODE_SLOTS // 2,
                                   MESH_MAX_TOKENS)
    runs["2,1"] = decode(tree, golden, meshes["2,1"], DECODE_SLOTS,
                         MESH_MAX_TOKENS)
    runs["1,2"] = decode(tree, golden, meshes["1,2"], DECODE_SLOTS,
                         MESH_MAX_TOKENS, forced=runs["unmeshed"])
    t0 = time.perf_counter()
    for t in MESH_TOPOLOGIES:
        # data parallel's direct run is mesh_path's own free-running one;
        # tensor parallel's there is teacher-forced, so it gets its own
        out[f"http generate {t}"] = _http_mesh_generate(
            rank, lambda: ServeEngine(cfg, *tree, batch_slots=DECODE_SLOTS,
                                      mesh=meshes[t], precision=golden,
                                      **kw), prompts,
            runs["2,1"] if t == "2,1" else None)
    out["http_s"] += time.perf_counter() - t0
    u8 = runs["unmeshed"]
    out["decode"] = {t: summary(r) for t, r in runs.items()}
    out["decode"]["unmeshed"]["finite"] = all(
        bool(torch.isfinite(v).all()) for v in u8["rows"].values())
    out["compare"] = {
        "unmeshed_4_vs_8": _compare_rows(u8, runs["unmeshed_half"]),
        "2,1_vs_unmeshed_half": _compare_rows(runs["unmeshed_half"],
                                              runs["2,1"]),
        "2,1_vs_unmeshed": _compare_rows(u8, runs["2,1"]),
        "1,2_vs_unmeshed": _compare_rows(u8, runs["1,2"])}
    del runs, tree, u8
    gc.collect()
    # the all-int8 plan: the golden plan's static int8 layers beside fully
    # quantized per-token ones (dynamic activation and attention scales)
    dyn = LayerPlan.for_mode(LayerMode.FULLY_QUANT, dynamic_acts=True)
    g = dec["plan"].layers
    exact = PrecisionPlan(tuple(g[i] if i % 4 in (0, 3) else dyn
                                for i in range(cfg.num_layers)),
                          dec["plan"].float_dtype)
    tree, out["exact_setup_s"] = quantized(exact, meshes["1,2"])
    ux = decode(tree, exact, None, DECODE_SLOTS, MESH_EXACT_TOKENS)
    tx = decode(tree, exact, meshes["1,2"], DECODE_SLOTS, MESH_EXACT_TOKENS,
                forced=ux)
    out["exact"] = {"plan": exact.describe(), "unmeshed": summary(ux),
                    "1,2": summary(tx), "compare": _compare_rows(ux, tx)}
    del tree, ux, tx
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if rank == 0:
        out["kernel_errors"] = _mesh_kernel_checks(device)
    return out


def _rebatch_noise(main, device):
    """The unmeshed port's own batching noise on main_path's engine: for
    each of four groups of 8 requests (by length), its logits in one call
    of 8 against two calls of 4 (rel-Linf). Every float GEMM and reduction
    of the card may round differently at another batch, and one int8 code
    flipped at a tie moves the logits by about a code's share of the
    range: the floor any comparison across shapes or summation orders
    meets."""
    import numpy as np
    from repro_torch.serve import Runtime
    rt = main["fused"].runtime
    params = main["qparams"]
    half = Runtime(rt.cfg, rt.plan, head=rt.head, max_len=rt.max_len,
                   min_batch=4, backend="fused", device=device)
    reqs = sorted(main["requests"], key=len)
    noise = []
    for g in range(0, len(reqs) - 7, 8):
        group = reqs[g:g + 8]
        S = max(len(r) for r in group)
        toks = np.zeros((8, S), np.int32)
        for i, r in enumerate(group):
            toks[i, :len(r)] = r
        lens = np.asarray([len(r) for r in group], np.int32)
        whole = rt.encode(params, {"tokens": toks}, lens)
        parts = np.concatenate([half.encode(params,
                                            {"tokens": toks[i:i + 4]},
                                            lens[i:i + 4]) for i in (0, 4)])
        noise.append(float(np.abs(whole - parts).max()
                           / np.abs(whole).max()))
    return noise


def phase_mesh(main, device, card, max_err):
    """``mesh_path``: two ranks on the card over gloo (NCCL refuses two
    ranks on one device), each serving full-width BERT-base (main_path's
    model, weights, tiled golden plan and 32 requests, calibrated on the
    mesh) and qwen2-0.5b (8 of decode_path's prompts, 16 greedy tokens,
    int8 per-token pages of 16, 8 slots) at (data=2, model=1) and (data=1,
    model=2). Gates, on every rank:

    * the mesh stats equal main_path's exactly;
    * data parallel: each rank's rows of every call equal an unmeshed
      runtime encoding those rows at the rank's bucket, bit for bit, and
      its decode tokens an unmeshed engine's with the rank's 4 slots (the
      per-rank shapes: every op runs as unmeshed);
    * tensor parallel (its int8 GEMMs sum exact int32 accumulators, its
      float layers reorder float sums): the encode logits within
      ``MESH_BUDGET`` of main_path's (data parallel's too); the golden
      decode, teacher-forced on the unmeshed 8-slot run's tokens, every
      logit row within ``MESH_DECODE_BUDGET`` of that run's; under an
      all-int8 plan every row within ``MESH_EXACT_TOL`` and every argmax
      equal;
    * predictions equal main_path's, every decode token in the vocabulary,
      no page in use after, and the launches a forward or tick as
      ``EXPECTED_MESH``.

    It also reports the unmeshed port's own noise beside each comparison
    (:func:`_rebatch_noise`; its decode at 4 slots against 8), the tokens
    tensor parallel keeps before its first argmax difference, each rank's
    wall a forward or tick, its collectives and peak memory. Two ranks on
    one card prove the sharded computation and the kernels at shard
    widths; they measure no multi-GPU speed."""
    import torch
    from repro_torch.distributed import comm
    t0 = time.perf_counter()
    noise = _rebatch_noise(main, device)
    ranks = comm.spawn(2, _mesh_rank, (None,), device="cuda",
                       deadline_s=MESH_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    emit({"phase": "mesh_path", "part": "process_group",
          "backend": ranks[0]["backend"], "ranks": len(ranks),
          "devices": [r["device"] for r in ranks], "card": card,
          "gloo_cuda_collectives": ranks[0]["gloo_cuda"],
          "unmeshed_rebatch_rel_linf": noise})
    for r in ranks:
        bad = [op for op in comm.COLLECTIVES if r["gloo_cuda"].get(op)
               is not True]
        if r["backend"] == "gloo" and bad:
            fail(f"mesh_path: gloo refused {bad} on CUDA tensors: "
                 f"{r['gloo_cuda']}")
    main_logits = main["logits"]
    per_rank = collections.defaultdict(dict)
    failures = []
    for r in ranks:
        rank = r["rank"]
        if r["stats"] != main["stats"]:
            failures.append(f"rank {rank}'s stats on the mesh differ from "
                            f"main_path's")
        for t in MESH_TOPOLOGIES:
            e = r[f"encode {t}"]
            logits = torch.from_numpy(e["logits"])
            err = rel_linf(main_logits, logits)
            fwd = max(e["forwards"], 1)
            per = {k: v / fwd for k, v in e["launches"].items() if v}
            rec = {"phase": "mesh_path", "part": "encode", "rank": rank,
                   "topology": t, "model": "bert-base",
                   "rel_linf_vs_main_path": err,
                   "max_abs_diff_vs_main_path": float(
                       (logits - main_logits).abs().max()),
                   "predictions_equal": e["predictions"] == main["preds"],
                   "forwards": e["forwards"], "launches": e["launches"],
                   "launches_per_forward": per, "wall_s": e["wall_s"],
                   "ms_per_forward": e["wall_s"] / fwd * 1e3,
                   "collectives": e["collectives"],
                   "wq_shard": e["wq_shard"], "card": card}
            if "rank_rows_max_abs_diff" in e:
                rec["rank_rows_max_abs_diff"] = e["rank_rows_max_abs_diff"]
            emit(rec)
            per_rank[("mesh_encode_path", t)][rank] = per
            if e["predictions"] != main["preds"]:
                failures.append(f"rank {rank} encode on {t}: predictions "
                                f"differ from main_path's")
            if e.get("rank_rows_max_abs_diff", 0.0) != 0.0:
                failures.append(
                    f"rank {rank} encode on {t}: its rows differ from the "
                    f"unmeshed encode at its bucket by "
                    f"{e['rank_rows_max_abs_diff']}")
            if err > MESH_BUDGET:
                failures.append(f"rank {rank} encode on {t}: rel-Linf {err} "
                                f"vs main_path > {MESH_BUDGET}")
            if per != EXPECTED_MESH[("mesh_encode_path", t)]:
                failures.append(
                    f"rank {rank} encode on {t} launched {per} a forward, "
                    f"not {EXPECTED_MESH[('mesh_encode_path', t)]}")
        dec, cmp_ = r["decode"], r["compare"]
        if not dec["unmeshed"]["finite"]:
            failures.append(f"rank {rank}: unmeshed decode logits are not "
                            f"finite")
        for t in MESH_TOPOLOGIES:
            d = dec[t]
            ticks = max(d["ticks"], 1)
            per = {k: v / ticks for k, v in d["launches"].items() if v}
            ref = dec["unmeshed_half" if t == "2,1" else "unmeshed"]
            rec = {"phase": "mesh_path", "part": "decode", "rank": rank,
                   "topology": t, "model": "qwen2-0.5b",
                   "teacher_forced": t == "1,2",
                   "vs_unmeshed": cmp_[f"{t}_vs_unmeshed"],
                   "unmeshed_4_vs_8": cmp_["unmeshed_4_vs_8"],
                   "ticks": d["ticks"], "launches": d["launches"],
                   "launches_per_tick": per, "wall_s": d["wall_s"],
                   "ms_per_tick": d["wall_s"] / ticks * 1e3,
                   "unmeshed_ms_per_tick": ref["wall_s"]
                   / max(ref["ticks"], 1) * 1e3,
                   "collectives": d["collectives"],
                   "pages_in_use_after": d["pages_in_use"],
                   "slots_held": d["slots"], "kv_heads_held": d["kv_heads"],
                   "card": card}
            if t == "2,1":
                rec["tokens_equal_unmeshed_4_slots"] = (d["tokens"]
                                                        == ref["tokens"])
                rec["vs_unmeshed_4_slots"] = cmp_["2,1_vs_unmeshed_half"]
            emit(rec)
            per_rank[("mesh_decode_path", t)][rank] = per
            want = 1 if t == "1,2" else MESH_MAX_TOKENS
            if sorted(d["tokens"]) != list(range(MESH_PROMPTS)) or any(
                    len(o) != want or not all(0 <= x < 151936 for x in o)
                    for o in d["tokens"].values()):
                failures.append(f"rank {rank} decode on {t}: not {want} "
                                f"in-vocabulary tokens a prompt")
            if t == "2,1" and d["tokens"] != ref["tokens"]:
                failures.append(f"rank {rank} decode on {t}: tokens differ "
                                f"from the unmeshed run at its slots")
            c = cmp_[f"{t}_vs_unmeshed"]
            if t == "1,2" and (c["rows"] < c["ref_rows"]
                               or c["max_rel"] > MESH_DECODE_BUDGET):
                failures.append(
                    f"rank {rank} decode on {t}: {c['rows']} rows within "
                    f"rel-Linf {c['max_rel']} of the unmeshed run's "
                    f"(budget {MESH_DECODE_BUDGET})")
            if d["pages_in_use"] or ref["pages_in_use"]:
                failures.append(f"rank {rank} decode on {t}: "
                                f"{d['pages_in_use']} pages in use after")
            if per != EXPECTED_MESH[("mesh_decode_path", t)]:
                failures.append(
                    f"rank {rank} decode on {t} launched {per} a tick, not "
                    f"{EXPECTED_MESH[('mesh_decode_path', t)]}")
        x = r["exact"]
        c = x["compare"]
        emit({"phase": "mesh_path", "part": "decode_exact", "rank": rank,
              "topology": "1,2", "model": "qwen2-0.5b", "plan": x["plan"],
              "teacher_forced": True, "vs_unmeshed": c,
              "ms_per_tick": x["1,2"]["wall_s"]
              / max(x["1,2"]["ticks"], 1) * 1e3,
              "unmeshed_ms_per_tick": x["unmeshed"]["wall_s"]
              / max(x["unmeshed"]["ticks"], 1) * 1e3,
              "launches": x["1,2"]["launches"], "card": card})
        if (c["rows"] < c["ref_rows"] or c["argmax_differ"]
                or c["max_rel"] > MESH_EXACT_TOL
                or x["1,2"]["pages_in_use"]):
            failures.append(
                f"rank {rank} all-int8 decode on 1,2: {c['rows']} rows, "
                f"rel-Linf {c['max_rel']} (tolerance {MESH_EXACT_TOL}), "
                f"{c['argmax_differ']} argmax differences")
        for case, (e, tol) in r.get("kernel_errors", {}).items():
            if e > tol:
                failures.append(f"{case} at the mesh's shapes differs from "
                                f"its plain version by {e} (> {tol})")
            name = case.split()[0]
            if case != "quant_linear shard":      # a rel-Linf
                max_err[name] = max(max_err[name], e)
    http = _check_http_mesh(ranks, card, failures)
    emit({"phase": "http_mesh_path", "part": "summary", "card": card,
          "seconds_per_rank": [r["http_s"] for r in ranks],
          "note": "inside mesh_path's ranks, on the engines they built"})
    emit({"phase": "mesh_path", "part": "summary", "spawn_s": spawn_s,
          "seconds": time.perf_counter() - t0,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
          "encode_setup_s": [r["encode_setup_s"] for r in ranks],
          "decode_setup_s": [r["decode_setup_s"] for r in ranks],
          "exact_setup_s": [r["exact_setup_s"] for r in ranks],
          "kernel_errors": ranks[0].get("kernel_errors"), "card": card,
          "note": "two ranks share one card over gloo: the sharded "
                  "computation and the kernels at shard widths, no "
                  "multi-GPU speed"})
    if failures:
        fail("mesh_path: " + "; ".join(failures))
    per_rank.update(http)
    return {name: {f"{path}_{'dp' if t == '2,1' else 'tp'}":
                   int(per_rank[(path, t)][0].get(name, 0))
                   for (path, t) in per_rank}
            for name in KERNELS}


# ---------------------------------------------------------------------------
# arch_mesh_path: the MoE, MLA, recurrent and front-end archs on mesh ranks
# (slice 17)
# ---------------------------------------------------------------------------

# (arch, layers, topologies): each rank builds and calibrates the whole
# float tree at full width, so the depth is the deepest cut that leaves 10
# GB of the card free with both ranks' peaks summed (mixtral: about 10.1 GB
# of float32 a layer plus 1.6 GB of tables, 3 layers would not; deepseek-v2:
# layer 0 dense, layer 1 the 160-expert MoE, 15 GB of experts and 4.2 GB
# of tables)
ARCH_MESH = (("mixtral-8x22b", 2, ("2,1", "1,2")),
             ("deepseek-v2-236b", 2, ("2,1", "1,2")),
             ("hubert-xlarge", 4, ("1,2",)),
             ("paligemma-3b", 4, ("1,2",)),
             ("recurrentgemma-9b", 3, ("1,2",)),
             ("xlstm-125m", 2, ("1,2",)))
# the models served under the all-int8 expert plan too, tensor parallel
# held there within MESH_EXACT_TOL: the MoE archs. The others are held to
# their served plan's budget alone (hubert's float frontend_proj, split by
# columns, rounds a 512 x 640 product unlike the columns of a 512 x 1280
# one on an H100 (PERF.md); xlstm's sLSTM runs a float per-head matvec
# over a rank's 2 heads)
ARCH_MESH_EXACT = ("mixtral-8x22b", "deepseek-v2-236b")
ARCH_MESH_PROMPTS = 8
ARCH_MESH_TOKENS = 16
ARCH_MESH_PROMPT_LEN = (4, 9)       # prompt lengths, uniform
ARCH_MESH_FRAMES = (8, 64)          # hubert: one encode of 8 x 64 frames
ARCH_MESH_DEADLINE_S = 600.0


# the served plan's tensor-parallel decode on deepseek-v2 against the
# unmeshed run, teacher-forced (max row rel-Linf): its float MLA splits
# wq_a / wq_b by columns and sums wo's float partials in another order,
# and at its expert capacity of 1 a code flipped at a tie, or a router
# logit at a near-tie, reroutes a token, which moves its rows by a
# routing's worth. The unmeshed port moves those rows by 0.186 when its
# token group changes (4 slots against 8 on an H100, PERF.md: the MoE
# analogue of the batching noise behind MESH_DECODE_BUDGET); the budget is
# twice that. The other models keep MESH_DECODE_BUDGET
MESH_MOE_DECODE_BUDGET = {"deepseek-v2-236b": 0.37}


def arch_mesh_plans(arch, cfg):
    """``{name: plan}`` of an ``arch_mesh_path`` model: ``plan``, the one it
    serves (golden v4's first layers on mixtral, the slice-13 paths' plans,
    :func:`arch_plan`: deepseek-v2's experts family, hubert's span, the
    golden plan tiled), and on :data:`ARCH_MESH_EXACT` ``exact``, every
    layer fully quantized at per-token scales (the attention's int8 matmuls
    too) with per-token expert stacks, under which tensor parallelism sums
    only exact int32 accumulators."""
    from repro_torch.core.plan import LayerMode, LayerPlan, PrecisionPlan
    from repro_torch.core.samp import moe_family_variant
    if arch == "mixtral-8x22b":
        v4 = PrecisionPlan.load(str(GOLDEN_V4))
        plan = PrecisionPlan(v4.layers[:cfg.num_layers], v4.float_dtype)
    else:
        plan = arch_plan({"deepseek-v2-236b": "mla_decode_path",
                          "hubert-xlarge": "hubert_encode_path"}.get(arch, ""),
                         cfg)
    if arch not in ARCH_MESH_EXACT:
        return {"plan": plan}
    dyn = LayerPlan.for_mode(LayerMode.FULLY_QUANT, dynamic_acts=True)
    exact = PrecisionPlan((dyn,) * cfg.num_layers, "float32")
    if cfg.moe is not None:
        exact = moe_family_variant(exact, dynamic_acts=True)
    return {"plan": plan, "exact": exact}


class DropCount:
    """The (token, expert) routings expert capacity dropped over a run, a
    rank's groups only (every slot, idle ones included): a spy around
    ``models.layers._dispatch_one``, removed on exit."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.orig, self.n = L, L._dispatch_one, 0

        def dispatch(*args):
            out = self.orig(*args)
            self.n = self.n + L.dropped_routings(out[3], out[1])
            return out
        L._dispatch_one = dispatch
        return self

    def __exit__(self, *exc):
        self.L._dispatch_one = self.orig


def _arch_mesh_model(arch, layers, topologies, rank, meshes, device):
    """One model of ``arch_mesh_path`` on a rank: for each plan, built,
    calibrated unmeshed and on the mesh, quantized, the float tree dropped,
    then served unmeshed and at each topology; returns what the parent
    checks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels import expert_gemm as EG
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    from repro_torch.serve import Runtime, ServeEngine

    torch.cuda.reset_peak_memory_stats(device)
    cfg = get_config(arch).replace(num_layers=layers)
    fp = PrecisionPlan.full_float(layers, "float32")
    float_plan = T.build_plan(cfg, fp)
    B, S = MOE_FORWARD
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=B,
                                            seq_len=S, seed=0)
    rng = np.random.default_rng(0)
    lengths = rng.integers(*ARCH_MESH_PROMPT_LEN, ARCH_MESH_PROMPTS)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    plans = arch_mesh_plans(arch, cfg)
    out = {"layers": layers, "setup_s": 0.0, "stats_equal": True,
           "plans": {k: v.describe() for k, v in plans.items()}}
    trees = {}

    def quantized(name):
        """The seeded float tree, built, calibrated unmeshed and on the
        mesh, quantized under ``plans[name]`` and dropped: one plan's int8
        tree at a time beside it (the same weights each time)."""
        t0 = time.perf_counter()
        # the engines of the plan served before hold their blocks in
        # reference cycles (an engine and its decode spy): collect them
        # before the float tree is rebuilt
        gc.collect()
        torch.cuda.empty_cache()
        params = T.init_params(cfg, fp, seed=0, device=device)
        stats = ptq.capture_stats(params, batches, cfg, float_plan,
                                  precision=plans[name])
        out["stats_equal"] &= stats == ptq.capture_stats(
            params, batches, cfg, float_plan, precision=plans[name],
            mesh=meshes["1,2"])
        trees[name] = ptq.apply_plan(params, cfg, plans[name], stats,
                                     float_plan=float_plan)
        torch.cuda.synchronize()
        out["ptq_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["setup_s"] += time.perf_counter() - t0

    if not cfg.supports_decode:                  # hubert: one encode
        fr = np.random.default_rng(1).standard_normal(
            ARCH_MESH_FRAMES + (cfg.frontend_dim,), dtype=np.float32)
        quantized("plan")
        # the front-end alone: the rank's half of frontend_proj's columns,
        # all-gathered, against the whole GEMM
        with torch.inference_mode():
            tree = trees["plan"][0]
            rt = Runtime(cfg, trees["plan"][1], device=device,
                         mesh=meshes["1,2"])
            x = torch.from_numpy(fr).to(device)
            pos = torch.arange(fr.shape[1], device=device)
            whole = T.embed_inputs(tree, {"frames": x}, cfg, positions=pos)
            split = T.embed_inputs(rt.local_params(tree), {"frames": x}, cfg,
                                   positions=pos, mesh=meshes["1,2"])
            out["frontend_max_abs_diff"] = float((whole - split).abs().max())
        for name in plans:
            runs = {}
            for t, mesh in (("unmeshed", None), ("1,2", meshes["1,2"])):
                rt = Runtime(cfg, trees[name][1], precision=plans[name],
                             head=lambda p, x, m=mesh: T.unembed(x, p, cfg,
                                                                 m),
                             token_level=True, backend="fused",
                             device=device, mesh=mesh)
                rt.encode(trees[name][0], {"frames": fr})       # warm-up
                counted = _counted_encode(rt, trees[name][0], fr)
                runs[t] = counted
            u, m = runs["unmeshed"], runs["1,2"]
            out[f"encode {name}"] = {
                "rel_linf": rel_linf(torch.from_numpy(u.pop("logits")),
                                     torch.from_numpy(m["logits"])),
                "argmax_differ": int((u.pop("argmax")
                                      != m["argmax"]).sum()),
                "finite": bool(np.isfinite(m.pop("logits")).all()),
                "unmeshed": u, "1,2": {k: v for k, v in m.items()
                                       if k != "argmax"}}
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        return out

    kw = dict(max_len=DECODE_MAX_LEN, page_size=PAGE_SIZE, backend="fused",
              device=device)
    warm = []

    def decode(name, mesh, slots, feed_prompts, forced=None):
        tree, pl = trees[name], plans[name]
        eng = ServeEngine(cfg, *tree, batch_slots=slots, mesh=mesh,
                          precision=pl, **kw)
        if not warm:           # the model's first engine: one warm-up pass
            serve_decode(eng, [feed_prompts[0][:4]], max_tokens=1)
            warm.append(True)
        ticks0 = eng.stats["ticks"]
        feed = (feed_prompts if forced is None else
                [forced["seq"][i][:-1] for i in range(len(feed_prompts))])
        rows = RowLogits(eng)
        with DropCount() as drops:
            (tokens, _), launches, _, wall, coll = _mesh_served(
                eng, lambda: serve_decode(eng, feed, max_tokens=(
                    ARCH_MESH_TOKENS if forced is None else 1)))
        launches["quant_expert_gemm accumulator mode"] = EG.acc_launches
        ticks = eng.stats["ticks"] - ticks0
        return {"tokens": tokens, "rows": rows.rows,
                "seq": {i: list(feed[i]) + tokens[i] for i in tokens},
                "prompt_len": {i: len(feed_prompts[i]) for i in tokens},
                "launches": launches, "ticks": ticks,
                "per_tick": {k: v / max(ticks, 1)
                             for k, v in launches.items() if v},
                "wall_s": wall, "ms_per_tick": wall / max(ticks, 1) * 1e3,
                "collectives": coll, "dropped_routings": int(drops.n),
                "pages_in_use": eng.kv_pages_in_use,
                "slots": T.cache_slots(eng.caches)}

    def summary(r):
        return {k: v for k, v in r.items()
                if k not in ("rows", "seq", "prompt_len")}

    def exact_rows(ref, got, uids):
        diff = 0.0
        for key, row in got["rows"].items():
            if key[0] in uids:
                want = ref["rows"].get(key)
                if want is None:
                    return float("inf")
                diff = max(diff, float((want - row).abs().max()))
        return diff

    quantized("plan")
    u8 = decode("plan", None, DECODE_SLOTS, prompts)
    out["decode"] = {"unmeshed": summary(u8)}
    out["compare"] = {}
    if "2,1" in topologies:
        half = DECODE_SLOTS // 2
        mine = list(range(rank * half, (rank + 1) * half))
        u4 = decode("plan", None, half, [prompts[i] for i in mine])
        # the 4-slot run numbered its requests 0..3: renumber as the
        # 8-slot runs number them
        u4["rows"] = {(mine[u], p): v for (u, p), v in u4["rows"].items()}
        u4["tokens"] = {mine[u]: v for u, v in u4["tokens"].items()}
        dp = decode("plan", meshes["2,1"], DECODE_SLOTS, prompts)
        out["decode"]["unmeshed_rank_slots"] = summary(u4)
        out["decode"]["2,1"] = summary(dp)
        out["compare"]["2,1_vs_unmeshed_rank_slots"] = {
            "rank_uids": mine,
            "tokens_equal": all(dp["tokens"][u] == u4["tokens"][u]
                                for u in mine),
            "rows_max_abs_diff": exact_rows(u4, dp, mine)}
        out["compare"]["2,1_vs_unmeshed"] = _compare_rows(u8, dp)
        del u4, dp
    tp = decode("plan", meshes["1,2"], DECODE_SLOTS, prompts, forced=u8)
    out["decode"]["1,2"] = summary(tp)
    out["compare"]["1,2_vs_unmeshed"] = _compare_rows(u8, tp)
    out["finite"] = all(bool(torch.isfinite(v).all())
                        for v in u8["rows"].values())
    del tp, u8, trees["plan"]
    if "exact" in plans:
        quantized("exact")
        x8 = decode("exact", None, DECODE_SLOTS, prompts)
        xt = decode("exact", meshes["1,2"], DECODE_SLOTS, prompts,
                    forced=x8)
        out["decode"]["exact unmeshed"] = summary(x8)
        out["decode"]["exact 1,2"] = summary(xt)
        out["compare"]["exact_1,2_vs_unmeshed"] = _compare_rows(x8, xt)
        del x8, xt
    trees.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def _counted_encode(rt, params, frames):
    """One counted ``Runtime.encode`` of ``frames``: logits, argmax,
    launches, wall and collectives."""
    import torch
    from repro_torch import kernels
    from repro_torch.distributed import comm
    torch.cuda.synchronize()
    kernels.reset_launches()
    comm.reset_stats()
    t = time.perf_counter()
    y = rt.encode(params, {"frames": frames})
    torch.cuda.synchronize()
    return {"logits": y, "argmax": y.argmax(-1),
            "launches": kernels.launch_counts(),
            "wall_s": time.perf_counter() - t,
            "collectives": dict(comm.STATS)}


def _arch_mesh_rank(rank, device, job):
    """One rank of ``arch_mesh_path``: each model of :data:`ARCH_MESH` in
    turn, freed before the next."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import make_serving_mesh

    out = {"rank": rank, "device": str(device),
           "backend": dist.get_backend(),
           "gloo_cuda": comm.probe_gloo_cuda(device), "models": {}}
    meshes = {t: make_serving_mesh(t) for t in MESH_TOPOLOGIES}
    for arch, layers, topologies in ARCH_MESH:
        out["models"][arch] = _arch_mesh_model(arch, layers, topologies,
                                               rank, meshes, device)
    return out


def _acc_mode_cases(device, timer):
    """``quant_expert_gemm``'s accumulator mode at the shapes per-expert
    tensor parallelism gives it in ``arch_mesh_path`` (a rank's half of
    ``wd``'s hidden units at decode's capacity: mixtral-8x22b 8 experts of
    8192 x 6144 at C = 3, deepseek-v2 160 of 768 x 5120 at C = 1; static
    per-expert and per-token codes) against its plain version (the int32
    product, exact), each timed at static codes: the kernel (events and
    profiler), the plain version, and the bound (the codes and the int8 stack read once,
    the int32 sums written once; the int8 products)."""
    import torch
    from repro_torch.core.quantize import QuantizedTensor, int_matmul
    from repro_torch.kernels import expert_gemm as EG
    from repro_torch.kernels.backend import FusedBackend
    recs = []
    g = torch.Generator(device=device).manual_seed(17)
    for model, (G, E, C, D, F) in (("mixtral-8x22b", (1, 8, 3, 8192, 6144)),
                                   ("deepseek-v2-236b",
                                    (1, 160, 1, 768, 5120))):
        wq = torch.randint(-127, 128, (E, D, F), generator=g, device=device,
                           dtype=torch.int8)
        ws = torch.rand((E, 1, F), generator=g, device=device) * 1e-3
        w = QuantizedTensor(wq, ws, None)
        xe = torch.randn((G, E, C, 2 * D), generator=g, device=device)
        half = xe[..., :D].contiguous()
        whole = xe.abs().amax(dim=-1)
        for token in (False, True):
            xs = None if token else (whole.amax(dim=(0, 2)) / 127.0
                                     ).reshape(E, 1, 1)

            def call():
                return FusedBackend().expert_gemm_acc(
                    half, w, xs, row_amax=lambda a: torch.maximum(a, whole))
            acc, x_scale = call()
            codes, _ = EG.expert_codes_plain(half, E, xs, None if xs
                                             is not None else whole)
            want = int_matmul(codes, wq)
            err = float((acc - want).abs().max())
            rows = G * E * C
            t_bytes, t_ops = bound(rows * D + E * D * F + 4.0 * rows * F,
                                   int8_ops=2.0 * rows * D * F)
            rec = {"phase": "kernel", "kernel": "quant_expert_gemm",
                   "mode": "accumulator", "path": "arch_mesh_path",
                   "model": model, "G": G, "E": E, "C": C, "D": D, "F": F,
                   "per_token_scales": token, "max_abs_err": err,
                   "exact": bool(acc.equal(want)),
                   "tolerance": "exact (int32 sums)",
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None}
            if not token:    # the same launch at either scale's codes
                rec.update(
                    ms=timer.ms(lambda: EG.quant_expert_gemm_acc(codes, wq)),
                    device_ms=timer.device_ms(
                        lambda: EG.quant_expert_gemm_acc(codes, wq),
                        "quant_expert_gemm"),
                    plain_ms=timer.ms(lambda: int_matmul(codes, wq)))
            emit(rec)
            recs.append(rec)
            if not rec["exact"]:
                fail(f"quant_expert_gemm's accumulator mode differs from its "
                     f"plain version: {rec}")
    return recs


def phase_arch_mesh(device, card, max_err):
    """``arch_mesh_path``: two ranks on the card over gloo serve, one model
    at a time, each model of :data:`ARCH_MESH` at full width (depth cut),
    calibrated unmeshed and on the mesh, quantized under its plan and under
    the all-int8 plan (:func:`arch_mesh_plans`), then served unmeshed and at
    each of its topologies: 8 prompts (4-8 tokens) of 16 greedy tokens on
    8 slots, pages of 16 (hubert: one encode of 8 x 64 frames). Gates, on
    every rank:

    * the mesh stats equal the unmeshed stats exactly;
    * data parallel (mixtral-8x22b, 4 experts a rank; deepseek-v2, 80): the
      rank's requests' tokens equal, and their logit rows equal bit for bit,
      an unmeshed engine's with the rank's 4 slots serving them (``groups``
      1 is then the rank's own group: the per-rank shapes, the int8 expert
      stacks exact whatever rows they see);
    * tensor parallel, teacher-forced on the unmeshed 8-slot run's tokens:
      every logit row within ``MESH_DECODE_BUDGET`` of that run's under the
      served plan (deepseek-v2 within ``MESH_MOE_DECODE_BUDGET``, hubert's
      encode within ``MESH_BUDGET``), and under the all-int8 plan
      (:data:`ARCH_MESH_EXACT`) within ``MESH_EXACT_TOL`` with every argmax
      equal;
    * every run's launches a tick or forward equal its unmeshed run's (the
      rank's shapes for data parallel), the accumulator mode launched on
      every MoE layer a tensor-parallel tick, no page in use after, finite
      logits.

    It reports each rank's peak memory, wall a tick, collectives and the
    routings expert capacity dropped beside the unmeshed run's (the groups
    change which tokens drop), and times the accumulator mode at its mesh
    shapes (:func:`_acc_mode_cases`)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import comm
    t0 = time.perf_counter()
    ranks = comm.spawn(2, _arch_mesh_rank, (None,), device="cuda",
                       deadline_s=ARCH_MESH_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    failures = []
    for r in ranks:
        if r["backend"] == "gloo" and r["gloo_cuda"].get("all_to_all") \
                is not True:
            failures.append(f"rank {r['rank']}: gloo refused all_to_all on "
                            f"CUDA tensors: {r['gloo_cuda']}")
    launches = collections.defaultdict(dict)
    acc_ticks = {}
    for r in ranks:
        rank = r["rank"]
        for arch, layers, topologies in ARCH_MESH:
            m = r["models"][arch]
            head = {"phase": "arch_mesh_path", "rank": rank, "model": arch,
                    "card": card}
            emit(dict(head, part="setup", layers=layers, plans=m["plans"],
                      setup_s=m["setup_s"],
                      stats_equal_unmeshed=m["stats_equal"],
                      ptq_peak_bytes=m["ptq_peak_bytes"],
                      peak_bytes=m["peak_bytes"],
                      **({"frontend_max_abs_diff": m[
                          "frontend_max_abs_diff"]}
                         if "frontend_max_abs_diff" in m else {})))
            if not m["stats_equal"]:
                failures.append(f"rank {rank} {arch}: stats on the mesh "
                                f"differ from the unmeshed stats")
            if "decode" not in m:
                for name in m["plans"]:
                    e = m[f"encode {name}"]
                    emit(dict(head, part=f"encode {name}", topology="1,2",
                              **e))
                    if e["rel_linf"] > MESH_BUDGET or not e["finite"]:
                        failures.append(
                            f"rank {rank} {arch} encode {name} on 1,2: "
                            f"rel-Linf {e['rel_linf']} (budget "
                            f"{MESH_BUDGET}), finite {e['finite']}")
                    per = {k: v for k, v in e["1,2"]["launches"].items()
                           if v}
                    if per != {k: v for k, v in
                               e["unmeshed"]["launches"].items() if v}:
                        failures.append(f"rank {rank} {arch} encode {name}:"
                                        f" launches {per} differ from the "
                                        f"unmeshed encode's")
                    launches[arch][f"1,2 {name}"] = per
                continue
            d, c = m["decode"], m["compare"]
            emit(dict(head, part="decode", decode=d, compare=c,
                      finite=m["finite"]))
            if not m["finite"]:
                failures.append(f"rank {rank} {arch}: decode logits are not "
                                f"finite")
            pairs = [("1,2", "unmeshed")]
            if "exact" in m["plans"]:
                pairs.append(("exact 1,2", "exact unmeshed"))
            if "2,1" in topologies:
                pairs.append(("2,1", "unmeshed_rank_slots"))
                x = c["2,1_vs_unmeshed_rank_slots"]
                if not x["tokens_equal"] or x["rows_max_abs_diff"] != 0.0:
                    failures.append(
                        f"rank {rank} {arch} on 2,1: its requests' tokens "
                        f"equal {x['tokens_equal']}, rows differ by "
                        f"{x['rows_max_abs_diff']} from the unmeshed run "
                        f"at its 4 slots")
            for t, ref in pairs:
                got, want = d[t]["per_tick"], d[ref]["per_tick"]
                acc = got.pop("quant_expert_gemm accumulator mode", 0)
                want.pop("quant_expert_gemm accumulator mode", None)
                launches[arch][t] = got
                acc_ticks[f"{arch} {t}"] = acc
                if got != want:
                    failures.append(f"rank {rank} {arch} on {t}: {got} "
                                    f"launches a tick, unmeshed {want}")
                moe_layers = sum(k.moe for k in get_config(arch).replace(
                    num_layers=layers).layer_kinds())
                if t.endswith("1,2") and acc != moe_layers:
                    failures.append(f"rank {rank} {arch} on {t}: "
                                    f"{acc} accumulator-mode launches a "
                                    f"tick, not {moe_layers}")
                if d[t]["pages_in_use"] or d[ref]["pages_in_use"]:
                    failures.append(f"rank {rank} {arch} on {t}: pages in "
                                    f"use after")
            tp = c["1,2_vs_unmeshed"]
            budget = MESH_MOE_DECODE_BUDGET.get(arch, MESH_DECODE_BUDGET)
            if tp["rows"] < tp["ref_rows"] or tp["max_rel"] > budget:
                failures.append(f"rank {rank} {arch} on 1,2: {tp['rows']} "
                                f"rows within rel-Linf {tp['max_rel']} "
                                f"(budget {budget})")
            x = c.get("exact_1,2_vs_unmeshed")
            if x is not None and (x["rows"] < x["ref_rows"]
                                  or x["argmax_differ"]
                                  or x["max_rel"] > MESH_EXACT_TOL):
                failures.append(f"rank {rank} {arch} all-int8 on 1,2: "
                                f"{x['rows']} rows, rel-Linf {x['max_rel']}"
                                f", {x['argmax_differ']} argmax "
                                f"differences")
    acc = _acc_mode_cases(device, Timer(device))
    max_err["quant_expert_gemm"] = max(
        [max_err["quant_expert_gemm"]] + [r["max_abs_err"] for r in acc])
    emit({"phase": "arch_mesh_path", "part": "summary", "spawn_s": spawn_s,
          "seconds": time.perf_counter() - t0,
          "peak_bytes_per_rank": {a: [r["models"][a]["peak_bytes"]
                                      for r in ranks]
                                  for a, _, _ in ARCH_MESH},
          "card": card,
          "note": "two ranks share one card over gloo: the sharded "
                  "computation and the kernels at shard widths, no "
                  "multi-GPU speed"})
    if failures:
        fail("arch_mesh_path: " + "; ".join(failures))
    return launches, acc_ticks, acc


# ---------------------------------------------------------------------------
# mesh_train_path: training on two ranks sharing the card
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 6
MESH_TRAIN_CKPT = 3                 # the DP run's checkpoint the TP resumes
MESH_TRAIN_TOPOLOGIES = {"dp": {"data": 2, "model": 1},
                         "tp": {"data": 1, "model": 2},
                         "pod": {"pod": 2, "data": 1, "model": 1}}
MESH_TRAIN_DEADLINE_S = 600.0
# tensor parallel against the unmeshed port is held to this many times the
# port's own noise, its run at one batch of 32 against two of 16 from the
# same init, measured first in the same run: TP reorders the same float
# sums (row-parallel partials, the copy_to sums) as the batch split does.
# Each gradient leaf (rel-Linf) against the gradient noise (TP 5.54e-6,
# noise 6.11e-6 on the H100), every step's loss (relative) against the
# largest of the steps' loss noise (TP 1.5e-7, noise 2.6e-7), the params
# after the steps (max abs) against the params' noise
MESH_TRAIN_NOISE_FACTOR = 4.0
# data parallel's params after the steps (max abs) against the unmeshed
# run at grad_accum = 2, whose micro-batches are the ranks' rows: the
# gradients are equal, and only the sharded norm's order of sums parts
# the two (2.09e-7 - 2.91e-7 measured on the H100: a float32 ulp near 2);
# its losses are held as tensor parallel's are
MESH_TRAIN_DP_PARAMS = 1e-5
MESH_TRAIN_CLI = ("qwen2-0.5b", 3, 5, 4, 64)  # arch, steps, resumed, B, S
EXPECTED["mesh_train_path"] = EXPECTED["main_path"]


def _tree_diff(a, b) -> tuple[float, float]:
    """(max abs difference, max rel-Linf) over the leaves of two trees of
    the same names (tensors or numpy)."""
    import torch
    from repro_torch.interop import flatten_names
    fb = dict(flatten_names(b))
    worst_abs = worst_rel = 0.0
    for n, x in flatten_names(a):
        x, y = torch.as_tensor(x), torch.as_tensor(fb[n]).to(x.device)
        worst_abs = max(worst_abs, float((x - y).abs().max()))
        worst_rel = max(worst_rel, rel_linf(y, x))
    return worst_abs, worst_rel


def _tree_equal(a, b) -> bool:
    import torch
    from repro_torch.interop import flatten_names
    fb = dict(flatten_names(b))
    return all(torch.equal(torch.as_tensor(x),
                           torch.as_tensor(fb[n]).to(torch.as_tensor(x)
                                                     .device))
               for n, x in flatten_names(a))


def _mesh_train_rank(rank, device, job):
    """One rank of ``mesh_train_path``: full-width BERT-base (tnews
    ``cls``, float32, seed 0, batches of 32 x 128) at (data=2, model=1),
    (data=1, model=2) and (pod=2, data=1, model=1) with
    ``compress_pod_grads``, from one init and the same global batches; rank
    0 also runs the unmeshed port and holds the gates' comparisons."""
    import os
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.data.pipeline import get_batch, make_task
    from repro_torch.distributed import comm
    from repro_torch.distributed.compression import \
        compress_allreduce_pytree
    from repro_torch.interop import flatten_names, tree_from_names
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.train import AdamW, TrainConfig, Trainer, TrainState
    from repro_torch.train.optimizer import zeros_f32

    cfg = get_config("bert-base")
    task = make_task("tnews", vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ)
    batches = [get_batch(task, i, TRAIN_BATCH)
               for i in range(MESH_TRAIN_STEPS)]
    policy = PrecisionPlan.full_float(cfg.num_layers, "float32")

    def trainer(mesh=None, **tk):
        tc = dict(steps=MESH_TRAIN_STEPS, log_every=1, remat=False,
                  compute_dtype="float32")
        tc.update(tk)
        return Trainer(cfg, policy, mesh=mesh, optimizer=AdamW(lr=TRAIN_LR),
                       tcfg=TrainConfig(**tc), head=("cls", task.n_classes),
                       device=device)

    def steps(tr, state, n, first=0):
        step, losses = tr.make_step(), []
        for i in range(first, first + n):
            p, o, e, m = step(state.params, state.opt_state,
                              state.err_state, batches[i])
            state = TrainState(p, o, e, tr.layout)
            losses.append(float(m["loss"]))
        return state, losses

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for _, t in flatten_names(tree))

    out = {"rank": rank, "device": str(device),
           "backend": dist.get_backend(), "seconds": {}}
    clock = [time.perf_counter()]

    def part(name):
        """Seconds since the last part ended, this rank's wall clock."""
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now
    ref = {}
    if rank == 0:
        # the unmeshed port on the card: one batch of 32 against two of 16
        # (its noise, and the data-parallel reference), the steps of each
        un, acc = trainer(), trainer(grad_accum=2)
        s0 = un.init_state(0)
        ref["loss"], ref["grads"] = un.loss_and_grads(s0.params, batches[0])
        ref["accum loss"], ref["accum grads"] = acc.loss_and_grads(
            s0.params, batches[0])
        ref["noise"] = _tree_diff(ref["accum grads"], ref["grads"])[1]
        ref["norm"] = float(torch.sqrt(sum(
            torch.sum(torch.square(g)) for _, g in flatten_names(
                ref["accum grads"]))))
        # the plain int8 error feedback of the reduced gradient, and its
        # update: what the pod's two steps must give (the pod's gradient
        # is the two-of-16 one at the same params, bit for bit)
        q, ref["pod err"] = compress_allreduce_pytree(
            ref["accum grads"], zeros_f32(ref["accum grads"]))
        ref["pod params"], opt = acc.optimizer.update(q, s0.opt_state,
                                                      s0.params)
        ref["pod loss 2"], g = acc.loss_and_grads(ref["pod params"],
                                                  batches[1])
        q, ref["pod err 2"] = compress_allreduce_pytree(g, ref["pod err"])
        ref["pod params 2"], _ = acc.optimizer.update(q, opt,
                                                      ref["pod params"])
        end, ref["losses"] = steps(un, s0, MESH_TRAIN_STEPS)
        ref["params"] = end.params
        end, ref["accum losses"] = steps(acc, s0, MESH_TRAIN_STEPS)
        ref["accum params"] = end.params
        ref["loss noise"] = max(abs(a - b) / abs(b) for a, b in zip(
            ref["losses"], ref["accum losses"]))
        ref["param noise"] = _tree_diff(ref["accum params"],
                                        ref["params"])[0]
        del s0, end, q, g, opt
        out["unmeshed"] = {k: (float(ref[k]) if torch.is_tensor(ref[k])
                               else ref[k])
                           for k in ("loss", "accum loss", "noise", "losses",
                                     "accum losses", "loss noise",
                                     "param noise")}
    dist.barrier()
    part("unmeshed")
    meshes = {k: ProcessMesh(v) for k, v in MESH_TRAIN_TOPOLOGIES.items()}

    def timed(name, mesh, run):
        """``run()`` on ``mesh`` with the collectives and peak memory
        counted; its record."""
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        comm.reset_stats()
        t = time.perf_counter()
        got = run()
        torch.cuda.synchronize(device)
        rec = {"s": time.perf_counter() - t, "collectives": dict(comm.STATS),
               "peak_memory_gb": torch.cuda.max_memory_allocated(device)
               / 1e9}
        out[name] = rec
        return got, rec

    # (data=2, model=1): FSDP + DP, checkpoints at 3 and 6
    ckpt = job["ckpt"]
    tr = trainer(meshes["dp"], checkpoint_dir=ckpt,
                 checkpoint_every=MESH_TRAIN_CKPT)
    st = tr.init_state(0)
    lay = tr.layout
    loss, grads = tr.loss_and_grads(st.params, batches[0])
    norm = float(lay.global_norm(grads))
    whole = lay.whole(grads)
    fsdp = [n for n, d in lay.fsdp_dim.items() if d is not None]
    want_bytes = sum(math.prod(s) * 4 // (2 if n in fsdp else 1)
                     for n, s in lay.shapes.items())
    logs, losses = [], []
    make_step = tr.make_step

    def recording_step():
        """``fit``'s step, each step's loss kept unrounded (its log line
        has 4 decimals)."""
        step = make_step()

        def run(*args):
            got = step(*args)
            losses.append(float(got[3]["loss"]))
            return got
        return run
    tr.make_step = recording_step
    end, rec = timed("dp", meshes["dp"], lambda: tr.fit(
        st, lambda i: batches[i], log=logs.append))
    rec.update(step_ms=[d * 1e3 for d in tr._step_times], losses=losses,
               logged_steps=len(_train_losses(logs)[0]),
               param_bytes=nbytes(st.params), mu_bytes=nbytes(
                   st.opt_state.mu), nu_bytes=nbytes(st.opt_state.nu),
               want_bytes=want_bytes, fsdp_leaves=len(fsdp),
               leaves=len(lay.shapes), norm=norm, loss0=float(loss))
    end_whole = lay.whole(end.params)
    if rank == 0:
        rec["grads_equal_accum"] = _tree_equal(whole, ref["accum grads"])
        rec["grads_vs_accum"] = _tree_diff(whole, ref["accum grads"])
        rec["loss_equal_accum"] = float(loss) == float(ref["accum loss"])
        rec["norm_rel_vs_accum"] = abs(norm - ref["norm"]) / ref["norm"]
        rec["params_vs_accum"] = _tree_diff(end_whole, ref["accum params"])
        rec["losses_vs_accum"] = [
            abs(a - b) / abs(b) for a, b in zip(losses,
                                               ref["accum losses"])]
    del st, grads, whole, end_whole
    dist.barrier()
    part("dp")

    # (data=1, model=2): TP from the same init; its gradient and the steps
    tr = trainer(meshes["tp"])
    st = tr.init_state(0)
    loss, grads = tr.loss_and_grads(st.params, batches[0])
    whole = tr.layout.whole(grads)
    (end, losses), rec = timed("tp", meshes["tp"], lambda: steps(
        tr, st, MESH_TRAIN_STEPS))
    rec.update(step_ms=None, losses=losses, loss0=float(loss))
    end_whole = tr.layout.whole(end.params)
    if rank == 0:
        rec["grads_vs_unmeshed"] = _tree_diff(whole, ref["grads"])[1]
        rec["loss_vs_unmeshed"] = abs(float(loss) - float(ref["loss"])) \
            / abs(float(ref["loss"]))
        rec["params_vs_unmeshed"] = _tree_diff(end_whole, ref["params"])
        rec["losses_vs_unmeshed"] = [
            abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    rec["step_s"] = rec["s"] / MESH_TRAIN_STEPS
    del st, grads, whole, end, end_whole
    part("tp")

    # resume: the TP mesh picks up the DP run's mid-run checkpoint, alone
    # in a directory of its own (hard links)
    src = os.path.join(job["tmp"], "resume")
    if rank == 0:
        os.makedirs(src)
        shutil.copytree(os.path.join(ckpt, f"step_{MESH_TRAIN_CKPT:08d}"),
                        os.path.join(src, f"step_{MESH_TRAIN_CKPT:08d}"),
                        copy_function=os.link)
    dist.barrier()
    tr = trainer(meshes["tp"], steps=MESH_TRAIN_CKPT + 1, checkpoint_dir=src,
                 checkpoint_every=100)
    fresh = tr.init_state(1)
    logs = []
    t = time.perf_counter()
    end = tr.fit(fresh, lambda i: batches[i], log=logs.append)
    resume_s = time.perf_counter() - t
    # the restore as fit does it (the leaves by name, cut to the rank's
    # blocks), gathered back against the leaves written
    written = store.load_leaves(src, MESH_TRAIN_CKPT)
    back = TrainState.from_tree(tree_from_names(written), tr.plan, device,
                                layout=tr.layout)
    restored = dict(flatten_names(back.as_tree(tr.plan)))
    exact = restored.keys() == written.keys() and all(
        (restored[k] == written[k]).all() for k in written)
    out["resume"] = {"logs": [m for m in logs if "resumed" in m],
                     "restore_bit_exact": bool(exact),
                     "resume_and_step_s": resume_s,
                     "step": int(end.opt_state.step)}
    del back, fresh, end, restored, written
    dist.barrier()
    part("resume")

    # (pod=2): the int8 pod all-reduce with error feedback, two steps: the
    # first from a zero error state, the second carrying the first's
    tr = trainer(meshes["pod"], compress_pod_grads=True)
    st = tr.init_state(0)
    (first, _), rec = timed("pod", meshes["pod"], lambda: steps(tr, st, 1))
    if rank == 0:
        rec["err_equal_plain"] = _tree_equal(first.err_state,
                                             ref["pod err"])
        rec["params_equal_plain"] = _tree_equal(first.params,
                                                ref["pod params"])
        rec["err_nonzero"] = any(bool(e.abs().max() > 0) for _, e in
                                 flatten_names(first.err_state))
    (end, losses), more = timed("pod step 2", meshes["pod"], lambda: steps(
        tr, first, 1, first=1))
    rec.update(loss2=losses[0], step_s=more["s"],
               err_bytes=nbytes(end.err_state))
    if rank == 0:
        rec["loss2_equal_plain"] = losses[0] == float(ref["pod loss 2"])
        rec["err2_equal_plain"] = _tree_equal(end.err_state,
                                              ref["pod err 2"])
        rec["params2_equal_plain"] = _tree_equal(end.params,
                                                 ref["pod params 2"])
    part("pod")
    return out


def phase_mesh_train(model, device, card):
    """``mesh_train_path``: ``Trainer(mesh=...)`` on two ranks sharing the
    card over gloo (:func:`_mesh_train_rank`), then the DP run's trained
    tree served like ``main_path``; its CLI runs in
    :func:`phase_train_clis`. Gates:

    The unmeshed port on rank 0 runs the same steps at one batch of 32
    and at two of 16 (``grad_accum = 2``) first; their differences are the
    port's own noise: of the step-1 gradient (rel-Linf), of each step's
    loss (relative; the largest) and of the params after the steps (max
    abs). Gates:

    * DP (data=2, model=1): the first step's loss and every gathered
      gradient bit for bit the ``grad_accum = 2`` run's (its micro-batches
      are the ranks' rows); the sharded norm reorders each FSDP leaf's
      sum of squares, so every step's loss is held within
      ``MESH_TRAIN_NOISE_FACTOR`` times the loss noise of that run's and
      the params after ``MESH_TRAIN_STEPS`` steps within
      ``MESH_TRAIN_DP_PARAMS``; each rank holds 1/2 of the FSDP-sharded
      leaves and the whole of the others, in params and both moments;
    * TP (data=1, model=2): every gathered step-1 gradient leaf, every
      step's loss and the params after the steps against the one-batch
      run's, each within ``MESH_TRAIN_NOISE_FACTOR`` times its noise;
    * pod (pod=2, compress_pod_grads): two steps, each bit for bit the
      port's plain version on the ``grad_accum = 2`` gradient: the error
      state g - q·scale (step 2 from step 1's), the update of q·scale and
      step 2's loss;
    * resume: the TP mesh restores the DP run's ``MESH_TRAIN_CKPT``
      checkpoint bit for bit, logs that it resumed from it and takes one
      step;
    * the DP run's last checkpoint, as served by ``main_path``: fused vs
      reference ≤ 5e-3, identical predictions, 42 / 6 / 6 / 1 a forward.

    It records each rank's step ms, collectives (calls, bytes, host s) and
    peak memory a topology. Two ranks on one card prove the sharded
    training; they measure no multi-GPU speed."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import store
    from repro_torch.distributed import comm
    from repro_torch.interop import params_from_numpy, tree_from_names

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="samp_mesh_train_"))
    try:
        job = {"ckpt": str(tmp / "dp"), "tmp": str(tmp)}
        ranks = comm.spawn(2, _mesh_train_rank, (job,), device="cuda",
                           deadline_s=MESH_TRAIN_DEADLINE_S)
        leaves = store.load_leaves(job["ckpt"], MESH_TRAIN_STEPS)
        trained = params_from_numpy(
            tree_from_names({k[len("params/"):]: v for k, v in
                             leaves.items() if k.startswith("params/")}),
            model["float_plan"], device)
        ckpt_bytes = _bundle_bytes(tmp / "dp")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spawn_s = time.perf_counter() - phase_t0
    r0 = ranks[0]
    for r in ranks:
        emit({"phase": "mesh_train_path", "part": "rank", "card": card,
              **{k: v for k, v in r.items()}})
    failures = []
    dp, tp, pod, res = r0["dp"], r0["tp"], r0["pod"], r0["resume"]
    if not (dp["grads_equal_accum"] and dp["loss_equal_accum"]):
        failures.append(f"DP: step 1's loss equal {dp['loss_equal_accum']}, "
                        f"gradients equal {dp['grads_equal_accum']} "
                        f"(max abs, rel {dp['grads_vs_accum']}) to the "
                        f"unmeshed port's at grad_accum = 2")
    un = r0["unmeshed"]
    loss_budget = MESH_TRAIN_NOISE_FACTOR * un["loss noise"]
    if len(dp["losses"]) != MESH_TRAIN_STEPS or \
            dp["logged_steps"] != MESH_TRAIN_STEPS or \
            max(dp["losses_vs_accum"]) > loss_budget:
        failures.append(f"DP: {len(dp['losses'])} losses, "
                        f"{dp['logged_steps']} logged, of "
                        f"{MESH_TRAIN_STEPS}; relative to the grad_accum = "
                        f"2 run's {dp['losses_vs_accum']} (budget "
                        f"{loss_budget})")
    if dp["params_vs_accum"][0] > MESH_TRAIN_DP_PARAMS:
        failures.append(f"DP: params {dp['params_vs_accum']} > "
                        f"{MESH_TRAIN_DP_PARAMS}")
    for r in ranks:
        d = r["dp"]
        if not d["param_bytes"] == d["mu_bytes"] == d["nu_bytes"] \
                == d["want_bytes"]:
            failures.append(f"rank {r['rank']}: ZeRO-3 bytes params "
                            f"{d['param_bytes']}, mu {d['mu_bytes']}, nu "
                            f"{d['nu_bytes']}, want {d['want_bytes']}")
    grad_budget = MESH_TRAIN_NOISE_FACTOR * un["noise"]
    if tp["grads_vs_unmeshed"] > grad_budget:
        failures.append(f"TP: gradients {tp['grads_vs_unmeshed']} > "
                        f"{grad_budget} ({MESH_TRAIN_NOISE_FACTOR} x the "
                        f"unmeshed noise {un['noise']})")
    if len(tp["losses"]) != MESH_TRAIN_STEPS or \
            max(tp["losses_vs_unmeshed"]) > loss_budget:
        failures.append(f"TP: losses relative to the unmeshed run's "
                        f"{tp['losses_vs_unmeshed']} > {loss_budget}")
    param_budget = MESH_TRAIN_NOISE_FACTOR * un["param noise"]
    if tp["params_vs_unmeshed"][0] > param_budget:
        failures.append(f"TP: params {tp['params_vs_unmeshed']} > "
                        f"{param_budget} ({MESH_TRAIN_NOISE_FACTOR} x the "
                        f"unmeshed noise {un['param noise']})")
    pod_exact = {k: pod[k] for k in (
        "err_equal_plain", "params_equal_plain", "err_nonzero",
        "loss2_equal_plain", "err2_equal_plain", "params2_equal_plain")}
    if not all(pod_exact.values()):
        failures.append(f"pod: against the plain version {pod_exact}")
    if res["logs"] != [f"[trainer] resumed from step {MESH_TRAIN_CKPT}"] or \
            not res["restore_bit_exact"] or \
            res["step"] != MESH_TRAIN_CKPT + 1:
        failures.append(f"resume: {res}")
    if any(not all(map(math.isfinite, r[k]["losses"])) for r in ranks
           for k in ("dp", "tp")):
        failures.append("a meshed loss is not finite")
    summary = {
        "phase": "mesh_train_path", "part": "summary", "card": card,
        "model": "bert-base", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": MESH_TRAIN_STEPS, "lr": TRAIN_LR,
        "backend": r0["backend"],
        "unmeshed_noise": {k: un[k] for k in ("noise", "loss noise",
                                              "param noise")},
        "grad_budget": grad_budget, "loss_budget": loss_budget,
        "tp_param_budget": param_budget,
        "dp_param_budget": MESH_TRAIN_DP_PARAMS,
        "dp_grads_bit_exact": dp["grads_equal_accum"],
        "dp_norm_rel_vs_accum": dp["norm_rel_vs_accum"],
        "dp_losses_vs_accum": dp["losses_vs_accum"],
        "dp_params_vs_accum": dp["params_vs_accum"],
        "tp_grads_rel_linf": tp["grads_vs_unmeshed"],
        "tp_loss_rel": tp["loss_vs_unmeshed"],
        "tp_losses_vs_unmeshed": tp["losses_vs_unmeshed"],
        "tp_params_vs_unmeshed": tp["params_vs_unmeshed"],
        "pod_exact": pod_exact,
        "resume": res,
        "step_ms_a_rank": {t: [r[t].get("step_ms") or
                               [r[t]["s"] / MESH_TRAIN_STEPS * 1e3]
                               for r in ranks] for t in ("dp", "tp")},
        "pod_step_s": [r["pod"]["step_s"] for r in ranks],
        "collectives_a_rank": {t: [r[t]["collectives"] for r in ranks]
                               for t in ("dp", "tp", "pod", "pod step 2")},
        "peak_memory_gb_a_rank": {t: [r[t]["peak_memory_gb"]
                                      for r in ranks]
                                  for t in ("dp", "tp", "pod")},
        "rank_seconds": [r["seconds"] for r in ranks],
        "checkpoint_bytes": ckpt_bytes, "spawn_s": spawn_s}
    emit(summary)
    if failures:
        fail("mesh_train_path: " + "; ".join(failures))
    path = phase_serve("mesh_train_path", dict(model, params=trained),
                       model["plan"], device)
    del trained
    emit({"phase": "mesh_train_path", "part": "timing", "card": card,
          "phase_s": time.perf_counter() - phase_t0})
    path.pop("fused")               # not profiled: main_path's shapes
    return path


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout of the "
             f"repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    laps, t_last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = laps.get(name, 0.0) + now - t_last[0]
        t_last[0] = now
    clis, server = start_train_clis(), None
    try:
        try:
            phase_build()
            lap("build, beside the training CLIs")
            server = start_http_mesh_cli()
            phase_train_clis(card, clis)
            lap("the training CLIs past the build")
        finally:
            stop_train_clis(clis)
        return run_paths(device, card, laps, lap, server)
    finally:
        stop_http_mesh_cli(server)


def run_paths(device, card, laps, lap, server) -> int:
    """Every phase after the build, in order; ``server`` is the meshed
    server CLI started beside them."""
    import torch
    flash = phase_flash(device)
    lap("flash_path")
    from repro_torch.core.samp import int8_dataflow_variant
    model = setup_model(device)
    paths = [phase_serve("main_path", model, model["plan"], device),
             phase_serve("span_path", model,
                         int8_dataflow_variant(model["plan"]), device)]
    lap("main_path, span_path")
    phase_pipeline(model, paths[0], device)
    lap("pipeline_path")
    autotune = phase_autotune(model, device)
    lap("autotune_path")
    train = phase_train(model, device, card)
    lap("train_path")
    decoder = setup_decoder(device)
    paths += [phase_decode("decode_path", decoder, decoder["plan"], device,
                           kv_cache="int8_per_token"),
              phase_decode("decode_head_path", decoder,
                           decode_head_plan(decoder["plan"]), device),
              autotune, train]
    lap("decode_path, decode_head_path")
    paths.append(phase_adaptive(model, decoder, device))
    lap("adaptive_path")
    paths += phase_http(model, decoder, device, card)
    lap("http_path")
    timed, max_err = {}, collections.defaultdict(float)
    mesh = phase_mesh(paths[0], device, card, max_err)
    lap("mesh_path, with http_mesh_path in its ranks")
    phase_http_mesh_cli(server, model, card)
    lap("http_mesh_path's CLI")
    paths.append(phase_mesh_train(model, device, card))
    lap("mesh_train_path")
    check_kernels(paths, device, timed, max_err)
    long_decode = run_long_decode_case(device, Timer(device))
    wide_page = run_wide_page_decode_case(device, Timer(device))
    long_attention = run_long_attention_case(device, Timer(device))
    wide = run_wide_row_cases(device, Timer(device))
    wide_heads = run_wide_head_cases(device, Timer(device, reps=5))
    phase_profile(model, paths, device)
    phase_profile_decode(paths[2])
    lap("kernel, profile")
    # free the earlier paths' models and engines before the 42 GB MoE model;
    # their summaries keep only counts and timings
    del model, decoder
    for path in paths:
        for k in ("qparams", "qplan", "fused", "decode_args", "prompts"):
            path.pop(k, None)
        for case in path["cases"].values():
            case.pop("qparams", None)
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(setup_moe(device), device)
    paths.append(moe)
    check_kernels([moe], device, timed, max_err)
    phase_profile_decode(moe)
    for k in ("qparams", "fused", "expert_args", "prompts"):
        moe.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()
    lap("moe_decode_path")
    arch_mesh = phase_arch_mesh(device, card, max_err)
    lap("arch_mesh_path")
    paths += phase_archs(device, timed, max_err)
    lap("slice-13 and -14 paths")
    emit({"phase": "timing", "seconds": laps,
          "total_s": sum(laps.values()), "card": card})
    emit({"kernels": summarize(paths, timed, max_err, flash, long_decode,
                               wide_page, long_attention, wide,
                               wide_heads, mesh, arch_mesh)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
