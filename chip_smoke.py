"""Smoke run of the PyTorch + CUDA port (``video3d_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the process then exits non-zero):

1. Preconditions: a CUDA device, its name and power limit (nvidia-smi), TF32
   off for float32 products and convolutions.
2. Build: compiles ``video3d_tpu_torch/csrc/*.cu`` with nvcc (printed
   seconds, ptxas report in ``chiprun_out/ptxas.txt``).
3. Kernels against their plain PyTorch versions at the main paths' shapes,
   first the HBM stream probes (B9, at the probe scripts' default shapes:
   rows and per-block checksums equal to the plain version, a checksum
   skipping each block's last row and, for the split form, columns one
   block late as controls; the best L2-flushed rate printed as the
   measured read ceiling), then fused geometry (B1: voxel ids and world
   coordinates at the main path's V=32 480x640 shape and at 240x320, with
   controls: frame f's ids from frame f + 1's pose, the crop window one
   patch to the right), flash prefill attention (B2), GQA-folded
   cached-chunk attention (B2 folded), split-K decode attention (B3),
   shared-prefix attention (B5), and the int8 configuration's kernels: the
   B=1 int8 weight matvec (B4) at the vocab head (twice, the same bits;
   timed beside B4's B>1 form on the same one-row head and B9b's read of
   the same weight) and the int8-cache forms of B3,
   B2 folded and B5, and their int4-cache forms (values packed two per
   byte) at the same shapes; paged decode attention (B7, bf16, int8 and
   int4 pools) at the paged batcher's shapes (8 slots aliasing a 52-page
   scene prefix); the head-width-256 forms (B2, B2 folded, B3, B7 and B5
   over bf16 at Gemma-2B's heads, B7 and B5 at the hd-128 rows' shapes);
   B2 folded and B5 (all three forms) also at the cases that exercise their
   splits over keys (a split boundary inside the chunk's own keys, a batch
   row with empty splits, B5 at B=2) and 128-row tiles that straddle batch
   rows, each case called twice and held to the same bits; B2 folded (all
   three forms) also at the speculative verify shape (B=8, L = K+1 = 5,
   each row at its own offset in 6716-6801, layer 27), held the same way
   and timed beside its bound; B3 and B7 (all
   three forms) each case called twice too, B3 also timed at phase 5's
   B=8 rows and B7's DRAM and logical bytes (the aliased pages once, or
   once per slot) printed, and B3 also at two launches of fewer live
   positions than its 33 CTAs per kv head (one row of 20; rows of 7, 0,
   9 and 3, the empty row read as zeros);
   the training kernels at the training shapes: B2 with
   the per-row logsumexp and the fused flash backward B6, and their hd-256
   forms at Gemma-2B's heads and at edge cases (lengths 1, 63, 64 and 65;
   L = 129, a row past a 128-row query tile; groups of 1, 2 and 8), the
   lse form's output equal to the inference form's bit for bit and hd-256
   B6's dK and dV the same bits on a second call (dQ, added by
   reduce-adds, within its bound); the
   weight-streaming kernels, B4's B>1 form (int8) and B8 (int4), at every
   decode projection shape of Qwen2-7B and the vocab head at 1, 8 and 32
   rows, each case called twice and held to the same bits; max error,
   median times (CUDA events), each kernel's bound (the larger of its
   operations over the card's peak and its bytes over the memory rate;
   B1's bytes: the 32-byte sectors of depth its pooled crop reads) and,
   where one PyTorch call computes the same function
   (``scaled_dot_product_attention``; for B4 ``torch._weight_int8pack_mm``
   where it runs on CUDA; for B8 ``torch._weight_int4pack_mm`` on the
   weight converted to its layout; for B9 the checksums as one ``sum``),
   that call's time. The kernels are timed warm and with the L2 flushed
   before each call (B2 warm only; B4's
   matvec and B9b-d read more than the 50 MB L2 either way); each
   byte-bound row also prints its bytes
   over the measured read ceiling. Then the int8 forms of B2 folded
   (untimed), B3 and B7 (timed) at phase 11's 32k shapes (4096-query
   chunks at offsets 0 and 28672 of a 32768-slot cache, kv_len 32760, the
   1 x 32k + 7 x ~520 page mix), with the same bound and controls.
4. Main path: the ScanQA answer path at full width (``ModelConfig()``:
   26-layer SigLIP-so400m, 28-layer Qwen2-7B, bf16, random weights from a
   seeded generator) answers two questions on a synthetic 32-frame 480x640
   scene through ``run_scanqa``; kernel launch counts must match the path.
   Decode runs as captured CUDA graphs (``models/decode_graph.py``), here
   and in phases 5-10; the two answers again with the loop uncaptured
   must give the same ids, one replayed step the same logits bit for bit
   and an 8-step chunk the same tokens (captured and uncaptured walls
   printed).
5. Scene-prefix path: the same model and scene with the scene-feature and
   scene-prefix caches on answers 16 questions through
   ``run_generative(..., batch_size=8)`` (one miss with a full prefill, then
   a B=7 and a B=8 suffix batch over the shared prefix) and one more through
   ``generate_answer`` (a B=1 suffix over the cached prefix); launch counts
   must match the path, and the first-step logits of the suffix paths must
   agree with a full prefill of the same question; the B=8 batch decoded
   captured and uncaptured gives the same ids, and its decode chunk
   replayed the same logits and tokens bit for bit.
8. Serving (runs after phase 5, and again inside phase 6): the paged
   continuous batcher (``serve/batcher.py``: 8 slots, chunks of 8, pages
   of 128, shared scene-prefix pages, a pool too small for eight full
   footprints) serves 24 requests submitted from threads in three waves
   over two scenes, budgets of 8 / 16 / 32 tokens, one cancelled
   mid-stream; every request returns, the prefix-sharing counts and the
   launch counts are exact (B7: 28 per decode step), every page is back
   after the last eviction, and the first paged decode step equals the
   dense one from the same admitted states (with a swapped-page control);
   the batcher's chunks are replayed CUDA graphs, and a chunk from the
   same admitted states replayed equals the uncaptured one bit for bit.
6. The int8 configuration: the bf16 model is freed and the same model is
   built with int8 LLM projections and lm_head (``init_model(bits=8)``);
   phases 4, 5 and 8 run again with ``kv_cache_dtype="int8"``, and phase
   12's ScanRefer prefix run (1 miss, 3 hits, B2 folded int8), with exact
   launch counts of B4 (its B>1 form on every decode projection and on
   heads of 2-32 rows, its matvec on one-row heads) and the int8 kernels
   and the first-step logit check at its own bound; one beam answer
   (phase 13's K) over the int8 cache, launch counts exact, its score's
   distance to a teacher-forced recompute printed; and phase 14's
   speculation and chunked prefill over the int8 cache: one greedy
   speculative answer (self-draft k=4), equal to the int8 greedy answer
   up to a near-tie, and one chunked admission, its first-step logits
   within LOGIT_ATOL of the atomic prefill's, with exact launch counts of
   B2 folded int8, B3 int8 and B4.
9. The int4 configuration: the int8 model is freed and the same model,
   cut to SHALLOW_LAYERS decoder layers (the run's time limit), is
   built with int4 LLM projections and lm_head (``init_model(bits=4)``,
   groups of 512 input rows); phases 4, 5 and 8 run again with the bf16
   KV cache, with exact launch counts of B8 (every decode projection and
   every head of at most 32 rows) and the first-step logit check at its
   own bound; the first decode step of a B=8 suffix batch through B8 must
   agree with the same step with every int4 product forced through the
   dequantize-then-matmul path (control: scales read one group off).
10. The int4 KV cache, on phase 9's int4 model before it is freed: phases 5
   and 8 again with ``kv_cache_dtype="int4"`` (uint8 values, two channels
   per byte, f32 scales per token and kv head), with exact launch counts
   of the int4 forms of B3, B2 folded, B5 and B7; the first-step logits of
   the B=8 suffix rows and the B=1 hit against the same first step with
   the four int4 forms' plain versions swapped in (f32; control: scales
   one position off), their distance to a full prefill over raw K/V
   printed as the int4 cache's own error.
11. The benchmark (``video3d_tpu_torch/bench``), inside phase 6 on its
   int8 model: the HBM probes (the bench line's read rate through B9b-d,
   and B9a at 4096-token blocks), the bench line (steady
   state and cold frames/s at V=8 with 4 bf16 decoder layers on a model of
   its own, the V=32 chain and the B=8 scene-prefix steady state, the live
   CPU baseline, the measured read ceiling), the flagship's stages,
   mc-chain (its picks on the card equal to a CPU run on the same voxels)
   and ctx32k, the paged batcher's dense 1 x 32k and paged 1 x 32k + 7
   x 512 int8 decode rows, and the grounding benchmark's ``cold --batch 1``
   and ``prefix --batch 8`` (``bench/grounding.py``); each prints its JSON
   line, and every kernel of those paths (B9's four forms among them) must
   launch.
12. Grounding and Scan2Cap (after phase 8, on phase 4's bf16 model; its
   INFONCE ground head drawn last from the same generator): a third
   synthetic scene of 32 frames with GROUND_OBJECTS proposals;
   ``run_scanrefer`` over 6 queries with the prefix cache (a miss through
   ``grounding_forward_cached``, 5 hits through ``ground_suffix`` on B2
   folded), the same 6 through ``ground`` without it (the full forward),
   4 through ``run_scanrefer(batch_size=4)`` (one B=4 prefill),
   ``run_multi3drefer`` over 4 (hits), ``run_scan2cap`` over 8 captions
   with their ``<coord>`` boxes at ``batch_size=8`` (a B=8 suffix on B5)
   and one B=1 hit. Launch counts exact; hit and batched scores within
   GROUND_SCORE_ATOL of the full forward with the same argmax (control: the
   query one position early); the cached object features equal a miss's
   bit for bit; compacted scores finite in JAX's layout; the captions'
   first-step logits within LOGIT_ATOL of a full prefill with the box, and
   the box PE at its slot; the protocols' metrics, the seconds per query
   and the peak memory (a full grounding call, the chunked masks) printed.
13. Sampling, beam search and box inputs (after phase 12, on phase 4's bf16
   model): the engine at temperature 0 with top-p / top-k set gives phase
   4's greedy ids; sampled answers (temperature 0.7, top-p 0.9, top-k 50)
   at B=1 and in a B=8 scene-prefix batch, captured, equal an uncaptured
   per-step loop token for token with every draw inside its step's warped
   support; beam search (K=BEAMS) at B=1 and B=2 on full prefills (the
   prefix cache bypassed), each best score within BEAM_SCORE_ATOL of a
   teacher-forced recompute (control: each id scored one position late);
   8 Scan2Cap captions with their boxes through the paged batcher, each
   admission's first-step logits within LOGIT_ATOL of the full prefill
   with the box and bit for bit the same path's outside the batcher
   (control: without the box, which must differ); launch counts exact for
   the engine's runs; greedy against sampled ms per step, the token pick
   alone, beam ms per step, the reorder's bytes and the peak memory
   printed.
14. Speculative decoding and chunked prefill (after phase 13, on phase 4's
   bf16 model): greedy speculation (K = 4) through ``generate_answer`` on
   phase 4's two questions, first with the full-depth self-draft (the
   target its own draft), then with a 4-layer self-draft whose head is cut
   to 32768 tokens, each answer equal to phase 4's greedy ids up to a
   near-tie (the two ids' logits within twice the largest distance
   between B3 steps and B2-folded verify blocks along phase 4's ids,
   measured here and held to LOGIT_ATOL), and every rejection of the
   full-depth run a near-tie (the target's logit gap between its id and
   the rejected draft id within the same bound); control: the full-depth
   run with every draft id moved
   to the next vocabulary id must reject its first draft in >= 90% of
   rounds; acceptance, target forwards and ms per emitted token beside
   phase 4's. Sampled speculation (temperature 0.7, top-p 0.9, top-k 50):
   every id inside its position's warped target support by a
   teacher-forced recompute, budgets held; top_k = 1 gives the greedy ids.
   The paged speculative batcher (8 slots, self-draft k=4, shared prefix
   pages) on 16 requests over two scenes against the sequential
   speculative engine, every page back. ``start_request_chunked`` at chunk
   lengths 512 and 2048 against ``start_request``: first-step logits
   within LOGIT_ATOL, the 32 greedy ids equal up to a near-tie. Phase 8's
   requests and budgets, plus one LONG_BUDGET stream (EOS off; both
   scenes' features and the first scene's prefix cached beforehand),
   through the paged batcher with and without ``chunked_prefill=512``,
   the second wave submitted once the first decodes: every request
   returns, answers equal up to a near-tie, every page back, decode
   chunks run inside a cold admission's job; the longest decode stall
   over a cold admission printed for both. Launch
   counts exact for the engine's runs; the phase's launch counts sum its
   main-path runs only (the engine's answers, the two batchers, the
   chunked admissions and their decode), not the references, timings and
   checks' recomputes; the phase's seconds and peak memory printed.
7. Training: the int4 model is freed; ``ModelConfig()`` cut to
   ``TRAIN_LAYERS`` decoder layers with its INFONCE ground head, f32
   master weights from a seeded generator, ``Trainer.train()`` with bf16
   compute, remat and two mini-steps per update for four mini-steps on
   phase 12's scene: two ScanQA-style records (LM mini-steps) and two
   ScanRefer records (ground mini-steps), ~6.8k tokens each: finite
   losses and gradient norms, the master tree bit for bit after the first
   update (learning rate 0), every leaf moved after the second (the ground
   head's too), exact launch counts; before it, one V=8 LM and one V=8
   ground mini-step through the kernels against the same mini-steps with
   the plain attention swapped in. Phase 7b: the same on LLaVA over
   Gemma-2B (head_dim 256, 8 query heads on one kv head) cut to
   GEMMA_TRAIN_LAYERS decoder layers (at all 18 the f32 masters and AdamW
   do not fit the card): every mini-step's attention on the hd-256 forms
   (B2 with the lse 2 x layers, B6 layers, no hd-128 training launch),
   its swap check with Gemma's bounds and controls (GEMMA_SWAP_CASES);
   seconds per mini-step, tokens/s and the peak printed.
15. LoRA, QLoRA, the adapted answer and DPO (after phase 7 frees its
   model; ``run_lora_paths``): ``Trainer.train()`` with ``lora_r=128,
   lora_alpha=256`` at full width and depth (28 layers), f32 masters, bf16
   compute, remat: (a) over a frozen bf16 base, 4 mini-steps (2 LM, 2
   ground) at two per update on phase 7's records; (b) over int8 and int4
   bases (QLoRA), 2 LM mini-steps at one per update. Each run: the
   trainables bit for bit after update 1 (learning rate 0); after update
   2 every B and every extra trainable with a gradient moved and every A
   unchanged with zero Adam moments (its gradient is exactly zero while B
   is zero, PEFT's init); the frozen base's checksums unchanged; exact
   launches per mini-step (B2 with the lse 2 x 28, B6 28, no other
   kernel); the export read back by ``load_lora_export`` bit for bit.
   (c) The int8 export through ``maybe_merge_lora`` (adapters lazy over
   the int8 base), every B replaced by seeded N(0, 0.02) draws: phase 4's
   path on it (captured decode, launch counts, captured vs uncaptured
   ids), the first-step logits within LOGIT_ATOL of the same prefill with
   B2 and B4's matvec plain (control: the bare int8 base, >= 4x), and a
   decode-row adapted product through B4's B>1 form within one bf16 ulp.
   (d) Two ``dpo_train_step``s at TRAIN_LAYERS layers (full fine-tune)
   against a bf16 copy of the initial policy on a ``DPODataset`` pair:
   log 2 and margin 0 at step 1, the policy moved after step 2, the
   reference's checksums unchanged, exact launches per step. Seconds per
   mini-step, tokens/s, peaks and the adapted ms/token are printed.
16. Other inputs (after phase 15; ``run_other_inputs``), on a bf16 model
   at full width and SHALLOW_LAYERS decoder layers: (a)
   ``generate_answer_image`` on a seeded
   768x768 image through anyres + spatial_unpad (5 tiles, 3699 vision
   tokens) and through pad, (b) ``generate_answer_video_file`` on a
   48-frame 480x640 mp4 the phase writes with cv2 (force-sampled to 32
   frames, the time instruction on, the world PE off); each answer's
   launches exact (B2 per layer, B3 per layer and step) and its ids equal
   to an uncaptured decode, the anyres and video-file first-step logits
   within LOGIT_ATOL of the same prefill with B2 plain (controls: the
   block without its base view, the frames in reverse order; >= 2x); the
   same model with seeded ``world_pe_mlp`` leaves answers a ScanQA
   question under the MLP world PE (B1, B2, B3 exact); (c) LoRA
   (``lora_r=128, lora_alpha=256``) over that bf16 base on
   two image records and one video-file record, one mini-step each: the
   trainables bit for bit after update 1, every B moved after update 2,
   B2 with the lse 2 x layers and B6 once a layer per mini-step; (d) at
   TRAIN_LAYERS
   layers with f32 masters, one V=8 mini-step per coordinate-pooling and
   world-PE variant (min-max + sin3d, sample9 + sin3d, avg + MLP, sample1
   + mrope) against the same mini-step with the plain attention swapped
   in (phase 7's bounds; control: the plain attention without its causal
   mask reading the next kv head), the mrope batch's vision rows read back on the card with their
   three axes apart. The phase's seconds, peak and launches are printed.
17. Serving over HTTP (after phase 16; ``run_http_serving``), on a bf16
   model at full width and depth (seed 17), ``serve_controller`` and
   ``serve_worker`` on 127.0.0.1 in this process, ``FakeTokenizer``: (a)
   the sequential worker, reached through the controller's
   ``get_worker_address``, answers phase 4's two questions as
   ``generate_answer`` does; (b) ``/worker_generate_stream``'s
   ``\0``-separated chunks are cumulative, the last equal to (a), its ms
   per decoded token printed beside phase 4's captured ms/token; then
   the worker's cap on open engine streams (4 open, each holding its
   cache, a fifth refused, every cache freed when they end; not a main
   path, its launches not counted); (c)
   ``/v1/chat/completions`` gives (a)'s text, its SSE deltas join to it,
   and with ``max_tokens`` 8 it is the decode of the first 8 greedy ids;
   (d) a three-turn history through a second, prefix-cached worker equals
   that engine's direct answer, a prefix hit; (e) two 384x384 PNGs as
   ``image_url`` data URIs equal ``generate_answer_images``; (f)
   ``/worker_ground`` on phase 12's scene equals ``engine.ground`` within
   GROUND_SCORE_ATOL, the same argmax and ``best_box``; (g) a paged
   batcher worker (8 slots, ``chunked_prefill=512``) on 8 concurrent
   requests (each the sequential engine's answer up to a near-tie), a
   client that hangs up mid-stream (its slot back within 3 s), eight
   distinct sampling overrides on the eager bypass route (no new
   ``DecodeGraphs`` entry; top_k 1 gives the greedy ids), its metrics
   (no slot in use, every page free, the request count); (h) an engine
   with ``device_geometry=False`` answers phase 4's first question, its
   voxel ids against B1's, its first-step logits within LOGIT_ATOL of the
   B1 route's. Every request must succeed (HTTP 200, ``error_code`` 0);
   launches exact per part where stated (B1, B2, B3), summed over the
   HTTP runs only (not (g)'s near-tie recomputes); its seconds, peak, the
   first chunk's latency and the batcher's tokens/s printed with the
   card's name and power limit. Phase 15 adds (i): the adapted int8
   engine served as an adapter beside the bare base (``/v1/models`` lists
   both, the adapter by name gives its answer through its engine's
   captured decode and its stream through the eager one, each with exact
   launches, the stream's ms per token beside 15c's captured ms/token, an
   unknown name a 404).
18. Variants and real weights (``run_variants_and_weights``), at
   SHALLOW_LAYERS decoder layers, on a bf16
   ``ModelConfig()`` drawn on the card: (a) w8a8 (``quantize_tree(act=
   "int8")``) and int8 weight-only trees of the same weights, the w8a8
   first-step logits within W8A8_GAP_FACTOR times the int8 model's RMS
   distance to the bf16 model's (control: the w8a8 scales left off, at
   least 4x the bound), phase 4's path on both (exact launches, one
   ``torch._int_mm`` per projection and head of every forward, counted as
   ``int_mm_w8a8``; captured ms/token, prefill, peak), the first 8 ids of
   each answer the int8 model's up to a near-tie, one B=8 suffix batch on
   a cached prefix; (b) one llava3d answer (budget 3096), the dedup's
   means against a float64 host loop over the same pooled features and
   order, the voxel count, the block's length, the dedup's and the
   block prefill's ms; (c) FRAME and NO_TOKEN answers (197 / 196 tokens a
   frame), a prefix hit's ids the miss's up to a near-tie, ONE_TOKEN
   refused; (d) an ``mlp2x_res2x_gelu`` projector: an answer, its bf16
   output within 2^-5 of max |out| of its f32 version (control: the raw
   input as the residual); (e) a REAL_LAYERS-layer model at full width
   exported (``export_llava_checkpoint``, f32 safetensors) and loaded
   (``load_pretrained_model``): the tree bit for bit, the greedy ids
   equal, the file's bytes and the write and load seconds. The phase's
   seconds, peak and launches, with the card's name and power limit.
19. Decoder families and towers (``run_families``), each model drawn on
   the card in bf16 from a seed, its ``LLMConfig`` from
   ``builder.llm_config_from_hf`` fed the published config.json values
   below: (a) LLaVA over Qwen1.5-MoE-A2.7B at full width and depth, a
   prefix miss and a hit of one question (the hit's ids the miss's up to
   a near-tie, exact attention launches), the MoE block at full width in
   bf16 against its f32 version on the same inputs and routing (control:
   each token's top expert dropped); (b) LLaVA over Gemma-2B (head_dim
   256: the three hd-256 forms); (c) Mixtral-8x7B at MIXTRAL_LAYERS
   layers, one answer and its MoE block; (d) MPT-7B at MPT_LAYERS layers
   and MPT_FRAMES frames, one answer on the plain ALiBi attention (no
   attention kernel launched), the paged batcher refused; each with its
   B=1 prefill ms, captured decode ms/token and peak; (e) CLIP
   ViT-L/14-336 alone and under S2, ``hf:`` SigLIP in its four feature
   modes, OpenCLIP ViT-H-14, ImageBind-Huge and the four resamplers on two
   images, each bf16 output within 2^-5 of max |out| of its f32 run
   (control: the images swapped, or a pooled output's channels shifted).
   Gemma-2B also serves through (b2) the scene-grouped batched answers
   (a miss, then ``prepare_answers_batch_prefix`` takes 8 questions as one
   suffix batch: B5 at hd 256; row 0's first-step logits within
   LOGIT_ATOL of a full prefill, control one position early; the ids
   those of B=1 full prefills up to a near-tie; seconds per question) and
   (b3) the paged batcher (8 slots, pages of 128, shared prefix pages; 16
   requests in GEMMA_SERVE_WAVES over two scenes: B7 at hd 256 in every
   decode step, eager and captured; every page back; the ids the dense
   batcher's up to a near-tie; ms per step and tokens/s; phase 8's paged
   vs dense first step and its control), each with exact attention
   launches. Phase 3 holds the five hd-256 forms at Gemma-2B's heads with
   controls (a mask dropped, a kv head off by one, a key tile or the
   focused keys dropped; B7: two slots' page rows swapped, the last live
   page dropped; B5: the suffix's causal mask dropped, the next row's
   suffix attended, the first prefix tile skipped).

B2 folded, B5, B7, the int8 and int4 kernels, B2 with the logsumexp and B6
are held against their plain versions run in float32 on the same bf16 / int8
/ int4 values. Every accuracy check of those kernels and of phases 5-8
also reads controls, deliberately
broken plain versions (a mask dropped, scales read one position off or
from the wrong kv head, ...), which must miss the bound by a wide margin:
the check could otherwise not fail a wrong kernel.

Prints a ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``; the whole output also goes to
``chiprun_out/chip_smoke.log``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

KERNEL_INFO = {
    "fused_geometry": ("video3d_tpu_torch/csrc/fused_geometry.cu",
                       "video3d_tpu/kernels/fused_geometry.py:41"),
    "flash_attention": ("video3d_tpu_torch/csrc/flash_attention.cu",
                        "video3d_tpu/kernels/flash_attention.py:64"),
    "flash_attention_folded": ("video3d_tpu_torch/csrc/chunk_sm90.cuh",
                               "video3d_tpu/kernels/flash_attention.py:64"),
    "decode_attention": ("video3d_tpu_torch/csrc/decode_sm90.cuh",
                         "video3d_tpu/kernels/decode_attention.py:68"),
    "shared_prefix_attention": (
        "video3d_tpu_torch/csrc/chunk_sm90.cuh",
        "video3d_tpu/kernels/flash_attention.py:503"),
    "int8_matvec": ("video3d_tpu_torch/csrc/weight_stream.cuh",
                    "video3d_tpu/kernels/quant_matvec.py:100"),
    "decode_attention_int8": ("video3d_tpu_torch/csrc/decode_sm90.cuh",
                              "video3d_tpu/kernels/decode_attention.py:68"),
    "flash_attention_folded_int8": (
        "video3d_tpu_torch/csrc/chunk_sm90.cuh",
        "video3d_tpu/kernels/flash_attention.py:64"),
    "shared_prefix_attention_int8": (
        "video3d_tpu_torch/csrc/chunk_sm90.cuh",
        "video3d_tpu/kernels/flash_attention.py:503"),
    "flash_attention_lse": ("video3d_tpu_torch/csrc/flash_attention.cu",
                            "video3d_tpu/kernels/flash_attention.py:64"),
    "flash_attention_bwd": (
        "video3d_tpu_torch/csrc/flash_attention_bwd.cu",
        "video3d_tpu/kernels/flash_attention.py:181, :216"),
    "paged_attention": ("video3d_tpu_torch/csrc/decode_sm90.cuh",
                        "video3d_tpu/kernels/paged_attention.py:60"),
    "paged_attention_int8": ("video3d_tpu_torch/csrc/decode_sm90.cuh",
                             "video3d_tpu/kernels/paged_attention.py:60"),
    "int8_matmul": ("video3d_tpu_torch/csrc/weight_stream.cuh",
                    "video3d_tpu/kernels/quant_matvec.py:116"),
    "int4_matmul": ("video3d_tpu_torch/csrc/weight_stream.cuh",
                    "video3d_tpu/kernels/quant_matvec.py:33"),
    "decode_attention_int4": ("video3d_tpu_torch/csrc/decode_sm90.cuh",
                              "video3d_tpu/kernels/decode_attention.py:68"),
    "flash_attention_folded_int4": (
        "video3d_tpu_torch/csrc/chunk_sm90.cuh",
        "video3d_tpu/kernels/flash_attention.py:64"),
    "shared_prefix_attention_int4": (
        "video3d_tpu_torch/csrc/chunk_sm90.cuh",
        "video3d_tpu/kernels/flash_attention.py:503"),
    "paged_attention_int4": ("video3d_tpu_torch/csrc/decode_sm90.cuh",
                             "video3d_tpu/kernels/paged_attention.py:60"),
    "stream_probe_kv": ("video3d_tpu_torch/csrc/stream_probe.cu",
                        "scripts/bench/kv_probe.py:42"),
    "stream_probe_one": ("video3d_tpu_torch/csrc/stream_probe.cu",
                         "scripts/bench/int8_matvec.py:55"),
    "stream_probe_multi": ("video3d_tpu_torch/csrc/stream_probe.cu",
                           "scripts/bench/stream_probe.py:73"),
    "stream_probe_split": ("video3d_tpu_torch/csrc/stream_probe.cu",
                           "scripts/bench/stream_probe.py:113"),
    "flash_attention_hd256": (
        "video3d_tpu_torch/csrc/flash_attention_hd256.cu",
        "video3d_tpu/kernels/flash_attention.py:64"),
    "flash_attention_folded_hd256": (
        "video3d_tpu_torch/csrc/attention_hd256.cu",
        "video3d_tpu/kernels/flash_attention.py:64"),
    "decode_attention_hd256": ("video3d_tpu_torch/csrc/decode_sm90.cuh",
                               "video3d_tpu/kernels/decode_attention.py:68"),
    "paged_attention_hd256": ("video3d_tpu_torch/csrc/decode_sm90.cuh",
                              "video3d_tpu/kernels/paged_attention.py:60"),
    "shared_prefix_attention_hd256": (
        "video3d_tpu_torch/csrc/shared_prefix_hd256.cu",
        "video3d_tpu/kernels/flash_attention.py:503"),
    "flash_attention_lse_hd256": (
        "video3d_tpu_torch/csrc/flash_attention_hd256.cu",
        "video3d_tpu/kernels/flash_attention.py:64"),
    "flash_attention_bwd_hd256": (
        "video3d_tpu_torch/csrc/flash_attention_bwd_hd256.cu",
        "video3d_tpu/kernels/flash_attention.py:181, :216"),
    **{f"{name}_hd256_int{bits}": (f"video3d_tpu_torch/csrc/{src}", replaces)
       for bits in (8, 4)
       for name, src, replaces in (
           ("flash_attention_folded", "attention_hd256.cu",
            "video3d_tpu/kernels/flash_attention.py:64"),
           ("decode_attention", "decode_sm90.cuh",
            "video3d_tpu/kernels/decode_attention.py:68"),
           ("paged_attention", "decode_sm90.cuh",
            "video3d_tpu/kernels/paged_attention.py:60"),
           ("shared_prefix_attention", "shared_prefix_hd256.cu",
            "video3d_tpu/kernels/flash_attention.py:503"))},
}
#: kernels of the int8 configuration (phase 6); the others run in phases
#: 4, 5 and 8
INT8_KERNELS = ("int8_matvec", "decode_attention_int8",
                "flash_attention_folded_int8", "shared_prefix_attention_int8",
                "paged_attention_int8", "int8_matmul")
#: kernels of the int4 configuration (phase 9)
INT4_KERNELS = ("int4_matmul",)
#: kernels of the int4 KV cache (phase 10)
INT4_CACHE_KERNELS = ("decode_attention_int4", "flash_attention_folded_int4",
                      "shared_prefix_attention_int4", "paged_attention_int4")
#: the HBM stream probes, B9 (their main path: phase 11, the benchmark)
PROBE_KERNELS = ("stream_probe_kv", "stream_probe_one", "stream_probe_multi",
                 "stream_probe_split")
#: kernels of the training path (phase 7; the hd-256 forms: phase 7b's
#: Gemma-2B)
TRAIN_KERNELS = ("flash_attention_lse", "flash_attention_bwd",
                 "flash_attention_lse_hd256", "flash_attention_bwd_hd256")
#: the head-width-256 forms (their main path: phase 19's Gemma-2B; the
#: int8 and int4 forms under phase 19 (f))
HD256_KERNELS = ("flash_attention_hd256", "flash_attention_folded_hd256",
                 "decode_attention_hd256", "paged_attention_hd256",
                 "shared_prefix_attention_hd256",
                 *(f"{name}_hd256_int{bits}" for bits in (8, 4)
                   for name in ("flash_attention_folded", "decode_attention",
                                "paged_attention",
                                "shared_prefix_attention")))
MAX_NEW = 32          # answer budget of both main paths
DECODE_STEPS = 8      # steps of the captured-vs-uncaptured chunks
BF16_ATOL = 2e-2      # kernel against plain, bf16 outputs of magnitude < 4
# Inputs of the B2 folded and B5 checks. Queries at three times a unit
# normal make attention peaked (scores of std ~3), so a skipped key tile
# moves some output by the size of a value; FOCUS, added to channel 0 of every
# query and of the keys a check is about (the chunk's own keys, the
# suffix), gives those keys most of the softmax weight, so a wrong mask
# there moves the output by O(1). The kernels are held against their plain
# version run in float32 on the same bf16 values: the bf16 plain version
# rounds the scores to bf16 before the softmax (as the JAX reference does),
# which at peaked attention moves outputs by more than BF16_ATOL by itself;
# its distance is printed. Each check also holds the float32 plain version
# with one part broken against the correct one: such a control must read
# at least CONTROL_MIN, or the check could not fail that kernel.
Q_SCALE, FOCUS = 3.0, 11.0
CONTROL_MIN = 4 * BF16_ATOL
# first-step logits of a suffix over the cached prefix against a full
# prefill of the same question (bf16 model, random weights). The two paths
# round differently in every layer (other GEMM shapes, other attention
# tiles). The control reads the logits one position early, as an
# off-by-one last-token gather or a suffix one token short would; it must
# read at least twice the bound.
LOGIT_ATOL = 0.25
# the same with int8 weights and an int8 KV cache (phase 6): the suffix
# paths attend the prefix as quantized in the cache, the full prefill
# attends its raw K/V. On an H100 80GB HBM3 (700 W) the B=8 row and the
# B=1 hit read 0.185 and 0.177, their controls 4.41 and 4.38.
INT8_LOGIT_ATOL = 0.5
# layers of the stacked caches of the B3 / B2 folded checks (the kernels
# read the last one by strides)
CACHE_LAYERS = 28
# decoder depth of the models phases 9, 10, 16 and 18 draw for themselves
# (widths stay ModelConfig()'s): their checks hold each path against
# itself on the same model, and at all 28 layers the whole run took 1008
# and 1188 s of its 1200 on two H100 80GB HBM3 machines (700 W)
SHALLOW_LAYERS = 14
# B4 against its plain version in f32: the kernel rounds its f32 sum once
# to bf16, which moves it by up to half a bf16 ulp, 2^-8 of |ref| at worst;
# the bound allows one ulp, |d| <= B4_REL * |ref| + B4_ABS. The check reads
# max |d| / (B4_REL * |ref| + B4_ABS), which must be <= 1, and its
# controls must read >= 4
B4_REL, B4_ABS = 2.0 ** -7, 1e-4
# (B4's B>1 form and B8 are held to the same bound and controls.)
# Phase 9's first decode step of a B=8 suffix batch through B8 against the
# same step with every int4 product forced through the dequantize path (a
# bf16 dequantized weight, which rounds nibble x scale to bf16, and a cuBLAS
# product); the control reads the scales one group off and must read at
# least twice the bound. On an H100 80GB HBM3 (700 W), over the runs made
# (|logits| up to 5.44), the step read at most 0.219 (0.219 with the first,
# CUDA-core B8; 0.191 with the kept one) and the control at least 4.98.
INT4_STEP_ATOL = 0.5
# the suffix-vs-full-prefill first-step logit check with int4 weights and
# a bf16 cache (phase 9); on an H100 80GB HBM3 (700 W) the B=8 row and the
# B=1 hit read 0.112 and 0.133, their controls 5.01 and 4.89
INT4_LOGIT_ATOL = 0.25
# phase 10: the first-step logits of the suffix paths over an int4 cache
# (the B=8 suffix rows and the B=1 hit) against the same first step with the
# four int4 forms' plain versions swapped in, run in f32 on the same packed
# values; the control swaps in the plain versions reading the scales one
# position off and must read at least twice the bound. Against a full
# prefill over raw K/V the suffixes differ by the 4-bit quantization itself,
# so that distance is printed, not held.
INT4_CACHE_LOGIT_ATOL = 0.25
# B6 against its plain version in f32: P and dS are rounded to bf16 before
# the tensor-core products (dS from the rounded P) and each gradient once
# to bf16 at the end, so the check reads max |kernel - plain| / max |plain|
# per gradient; its controls must read >= 4x. dQ is summed over the key
# tiles by TMA reduce-adds in an order that changes from run to run, so it
# is not bit-reproducible; the bound holds for any order, and two calls'
# dQ are held to it. B2's logsumexp: f32 in both, the scores' sums in
# another order.
B6_REL = 2e-2
LSE_ATOL = 1e-3
# B, L = S, H, KV, length of the B2-with-lse and B6 checks: one ~6.8k-token
# training record in the 8192 bucket at Qwen2-7B's heads, and at Gemma-2B's
# (hd 256), whose forms are also held at edge cases (B, L, H, KV, lengths):
# L = 129 with 8 heads on one kv head (a 128-row query tile and one row
# past it; B6 splits the group of 8 over CTAs), lengths 1, 63, 64 and 65
# in groups of 2, and groups of 1
TRAIN_ATTENTION = (1, 8192, 28, 4, 6780)
TRAIN_ATTENTION_HD256 = (1, 8192, 8, 1, 6780)
TRAIN_EDGES_HD256 = ((1, 129, 8, 1, [129]), (4, 130, 8, 4, [1, 63, 64, 65]),
                     (2, 200, 2, 2, [200, 64]))
# B2 prefill's checks: the phase-3 shape (B, L, lengths) at Qwen2-7B's
# heads, and the cases at its tiles' edges (B, L, lengths, causal)
FLASH_HEADS = (28, 4)
FLASH_MAIN = (1, 8192, [6780])
FLASH_EDGES = ((1, 1000, [1000], True), (3, 256, [127, 128, 129], True),
               (2, 2048, [2048, 1111], True), (2, 1000, [1000, 555], False))


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def preconditions():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    print(_card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)


def build():
    from video3d_tpu_torch.kernels import _build

    path = _build.build()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(_build.build_log)
    _build.library()
    print(f"build: {_build.build_seconds:.1f} s -> {os.path.relpath(path, ROOT)}",
          flush=True)


def _median_ms(fn, iters: int, flush_l2: bool = False) -> float:
    """Median device ms of ``fn()``: CUDA events around each call, each
    queued behind a ~1 ms spin kernel so the events time the device work
    and not the host's launch overhead; ``flush_l2``: 256 MB written before
    each call, so it reads its inputs from HBM and not from the 50 MB L2
    (``video3d_tpu_torch/bench/timing.py``)."""
    from video3d_tpu_torch.bench import timing

    return timing.median_ms(fn, iters, flush_l2_cache=flush_l2)


def _kernel_ms(fn, iters: int):
    """(warm ms, L2-flushed ms) of a kernel whose inputs fit in the L2: the
    warm time reads them from the L2 after the first call, as a loop over
    the same inputs does; a decode step over 28 layers' caches finds them
    in HBM."""
    return _median_ms(fn, iters), _median_ms(fn, iters, flush_l2=True)


# the measured read ceiling (GB/s, the best L2-flushed B9 rate) and B9b's
# (warm, L2-flushed) ms over the vocab-head weight, set by check_kernels
# before the other kernels' checks
READ_CEILING_GBPS: Optional[float] = None
B9B_MS: Optional[tuple] = None


def _timed_row(name: str, fn, nbytes: float, iters: int = 30) -> None:
    """Warm and L2-flushed ms of one more call shape of a byte-bound
    kernel, its share of the byte bound (nbytes at the data sheet's rate)
    and its multiple of nbytes at the measured read ceiling."""
    warm, flushed = _kernel_ms(fn, iters)
    bound = nbytes / H100_HBM_BYTES * 1e3
    at = "" if READ_CEILING_GBPS is None else (
        f", {flushed / (nbytes / READ_CEILING_GBPS / 1e6):.1f}x its bytes "
        f"at the measured ceiling")
    print(f"  {name}: {warm:.4f} ms warm, {flushed:.4f} ms L2 flushed; "
          f"{nbytes / 1e6:.2f} MB, bound {bound:.4f} ms ({bound / flushed:.1%}"
          f" of it flushed){at}", flush=True)


def _check(name: str, ok: bool, detail: str) -> None:
    print(f"  {name}: {detail}", flush=True)
    if not ok:
        raise AssertionError(f"{name} failed: {detail}")


def _rows_err(a, b, rows) -> float:
    """Max |a - b| over the first rows[i] query rows of batch row i."""
    return max(float((a[i, :n].float() - b[i, :n].float()).abs().max())
               for i, n in enumerate(rows))


def _check_controls(name: str, ref, rows, controls: dict) -> None:
    """Each broken plain version must differ from the correct one by at
    least CONTROL_MIN on the rows the kernel check compares."""
    for what, broken in controls.items():
        err = _rows_err(broken, ref, rows)
        _check(f"{name} control, {what}", err >= CONTROL_MIN,
               f"max |d| {err:.2e} (must be >= {CONTROL_MIN:.0e})")


# peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): a
# kernel's bound is the larger of the
# operations it must do over the peak rate of their type and the bytes it
# must move (each input read once, each output written once) over the
# memory rate
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12


def _bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _attn(pairs: int, H: int, hd: int = 128, products: int = 2) -> float:
    """FLOPs of ``products`` (64-query, hd) x (hd, key) style products over
    ``pairs`` allowed (query, key) pairs of each of H heads."""
    return 2.0 * products * hd * H * pairs


def _causal_pairs(L: int, lengths) -> int:
    """(query, key) pairs the prefill mask allows over all L query rows:
    key < length and key <= row."""
    return sum(sum(min(r + 1, n) for r in range(L)) for n in lengths)


def _sdpa_ms(q, k, v, iters: int, **kw) -> float:
    """Median ms of one ``scaled_dot_product_attention`` call on (B, H, L,
    hd) tensors: the library yardstick, used nowhere in the port."""
    import torch.nn.functional as F

    return _median_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw),
                      iters)


def _heads_first(x, H: int):
    """(B, S, KV, hd) -> contiguous (B, H, S, hd), kv heads repeated."""
    return x.repeat_interleave(H // x.shape[2], dim=2).transpose(1, 2) \
        .contiguous()


def _random_poses(g, V: int):
    """(V, 4, 4) rigid poses: random rotations, translations in [-2, 2] m."""
    import torch

    a = torch.randn(V, 3, 3, generator=g, dtype=torch.float64)
    rot, _ = torch.linalg.qr(a)
    poses = torch.zeros(V, 4, 4, dtype=torch.float64)
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = torch.rand(V, 3, generator=g, dtype=torch.float64) * 4 - 2
    poses[:, 3, 3] = 1.0
    return poses.to(torch.float32)


# B1 against its plain version: at most GEOMETRY_IDS of the voxel ids
# differ (f32 sums in another order put a few on the other side of a .5),
# by at most 1, and world coordinates within GEOMETRY_ATOL metres; each
# control must miss by CONTROL_FACTOR x that
GEOMETRY_IDS, GEOMETRY_ATOL, CONTROL_FACTOR = 1e-3, 1e-3, 4.0
# (V, H, W, crop, grid): the main path's shape (32 frames of a ScanNet-size
# depth map, crop 384, grid 14) and a second size the kernel takes
GEOMETRY_SHAPES = ((32, 480, 640, 384, 14), (8, 240, 320, 224, 16))


def _geometry_case(g, dev, V: int, H: int, W: int, crop: int, grid: int):
    """Depths in [500, 5000) mm, a pinhole intrinsic and random rigid poses
    of V frames; returns them and a call of B1 or its plain version."""
    import torch

    from video3d_tpu_torch.kernels import fused_geometry as fg

    depths = torch.randint(500, 5000, (V, H, W), generator=g,
                           dtype=torch.int32).to(dev)
    intr = torch.eye(4)
    intr[0, 0] = intr[1, 1] = 0.9 * W
    intr[0, 2], intr[1, 2] = W / 2 - 0.5, H / 2 - 0.5
    intr = intr.to(dev)
    poses = _random_poses(g, V).to(dev)

    def call(fn, d=depths, p=poses, **kw):
        return fn(d, intr, p, crop=crop, grid=grid, **kw)
    return depths, intr, poses, call


def _geometry_misses(got, ref, discretize: bool) -> float:
    """B1's distance from a plain result in units of its bound: the share
    of ids that differ over GEOMETRY_IDS, or max |d| (m) over
    GEOMETRY_ATOL."""
    diff = (got - ref).abs()
    if discretize:
        return float((diff > 0).float().mean()) / GEOMETRY_IDS
    return float(diff.max()) / GEOMETRY_ATOL


def _geometry_source_bytes(plan, V: int) -> int:
    """Bytes of the int32 depths that B1 must read: the 32-byte sectors
    holding the source pixels of the pooled crop (its distinct source rows
    x the sectors of its source columns), V frames."""
    rows, cols = plan.source_maps()
    n = plan.grid * plan.patch
    sectors = len(set((cols[:n] * 4 // 32).tolist()))
    return V * len(set(rows[:n].tolist())) * sectors * 32


def check_geometry(dev):
    """B1 at GEOMETRY_SHAPES, voxel ids and world coordinates, against the
    plain version; controls: frame f's ids from frame f + 1's pose, and the
    crop window one patch to the right (the depths read one patch's source
    columns over). Timed at the main path's shape."""
    import torch

    from video3d_tpu_torch.kernels import fused_geometry as fg

    g = torch.Generator().manual_seed(1)
    timed = None
    for V, H, W, crop, grid in GEOMETRY_SHAPES:
        depths, intr, poses, call = _geometry_case(g, dev, V, H, W, crop,
                                                   grid)
        shift = (crop // grid) * W // fg.geometry_plan(H, W, crop,
                                                       grid).new_w
        for discretize, what in ((True, "voxel ids"),
                                 (False, "world coords")):
            got = call(fg.fused_patch_voxel_coords, discretize=discretize)
            ref = call(fg.reference_patch_voxel_coords,
                       discretize=discretize)
            miss = _geometry_misses(got, ref, discretize)
            name = f"B1 {what} V={V} {H}x{W} crop {crop} grid {grid}"
            diff = (got - ref).abs()
            _check(name, miss <= 1.0 and float(diff.max()) <= (
                1 if discretize else GEOMETRY_ATOL),
                f"max |d| {float(diff.max()):.2e}, "
                f"{float((diff > 0).float().mean()):.2e} differ; "
                f"{miss:.3f} of the bound")
            for control, broken in (
                    ("frame f + 1's pose", call(
                        fg.reference_patch_voxel_coords,
                        p=torch.roll(poses, -1, dims=0),
                        discretize=discretize)),
                    ("crop one patch to the right", call(
                        fg.reference_patch_voxel_coords,
                        d=torch.roll(depths, -shift, dims=2),
                        discretize=discretize))):
                r = _geometry_misses(got, broken, discretize)
                _check(f"{name} control, {control}", r >= CONTROL_FACTOR,
                       f"{r:.1f} x the bound (must be >= "
                       f"{CONTROL_FACTOR:.0f})")
            if not discretize and timed is None:
                err = float(diff.max())
                # ~10 f32 operations per pooled pixel (scale, camera x/y,
                # patch sums); bytes: the depths' sectors the pooled
                # pixels lie in, the intrinsic, the poses and the output
                plan = fg.geometry_plan(H, W, crop, grid)
                pooled = V * (grid * plan.patch) ** 2
                source = _geometry_source_bytes(plan, V)
                bound = _bound(10.0 * pooled,
                               source + _nbytes(intr, poses, got),
                               H100_F32_FLOPS)
                print(f"  B1 bound: {source / 1e6:.2f} MB of the "
                      f"{_nbytes(depths) / 1e6:.2f} MB of depths (the "
                      f"32-byte sectors its {pooled} pooled pixels' source "
                      f"pixels lie in)", flush=True)
                timed = err, (
                    _kernel_ms(lambda: call(fg.fused_patch_voxel_coords),
                               30),
                    _median_ms(lambda: call(fg.reference_patch_voxel_coords),
                               5)), bound, None
        del depths, poses
    return timed


def _tile_dropped(q, k, v, lengths, a: int, b: int):
    """The plain prefill with keys [a, b) removed: every query keeps the
    other keys it may attend (causal, below its length)."""
    import torch

    from video3d_tpu_torch.kernels.attention import mha_reference

    L = q.shape[1]
    keep = torch.cat([torch.arange(a), torch.arange(b, k.shape[1])]).to(
        k.device)
    r = torch.arange(L, device=q.device)
    pos = torch.where(r < a, r, torch.where(r < b, a - 1, r - (b - a)))
    return mha_reference(q, k[:, keep], v[:, keep],
                         q_positions=pos[None].expand(q.shape[0], L),
                         kv_len=lengths - (b - a))


def check_flash(dev):
    """B2 prefill at peaked inputs: queries at Q_SCALE x N(0, 1), FOCUS on
    channel 0 of every query and of the keys of the second 128-key tile, so
    a skipped tile or a wrong mask moves outputs by O(1). Held against its
    plain version in f32 at the phase-3 shape (B=1, L=8192, length 6780;
    controls: that key tile dropped, the causal mask dropped) and at the
    tiles' edges: L=1000, lengths 127 / 128 / 129, B=2 with mixed lengths,
    non-causal."""
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(2)
    H, KV, hd, tile = FLASH_HEADS[0], FLASH_HEADS[1], 128, (128, 256)

    def case(B, L, lengths, causal=True):
        q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        k = torch.randn(B, L, KV, hd, generator=g, device=dev)
        k[:, tile[0]:tile[1], :, 0] += FOCUS
        # |v| < ~2.5 keeps |out| below 4, where one bf16 ulp is 1.6e-2
        v = 0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = fa.flash_attention(q, k, v, lengths=lens, causal=causal)
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                       lengths=lens, causal=causal)
        err = _rows_err(out, ref, lengths)
        plain_err = _rows_err(fa.flash_attention_plain(q, k, v, lens, causal),
                              ref, lengths)
        finite = bool(torch.isfinite(out.float()).all())
        _check(f"B2 B={B} L={L} lengths={lengths} causal={causal}",
               err <= BF16_ATOL and finite,
               f"max |d| {err:.2e} on rows < length, finite={finite} (the "
               f"bf16 plain version: {plain_err:.2e})")
        return err, (q, k, v, lens), ref

    worst = max(case(*args)[0] for args in FLASH_EDGES)
    err, (q, k, v, lens), ref = case(*FLASH_MAIN)
    qf, kf, vf = q.float(), k.float(), v.float()
    B, L, lengths = FLASH_MAIN
    _check_controls(f"B2 L={L} lengths {lengths}", ref, lengths, {
        f"keys {tile[0]}-{tile[1] - 1} dropped": _tile_dropped(
            qf, kf, vf, lens, *tile),
        "no causal mask": fa.flash_attention_plain(qf, kf, vf, lengths=lens,
                                                   causal=False)})
    del ref, qf, kf, vf
    n = lengths[0]
    # the bound counts the rows the check holds (rows < length: those past
    # it are garbage by contract); B2 with lse's counts all L (B6 reads them)
    rows = tuple(x[:, :n] for x in (q, k, v, q))
    bound = _bound(_attn(_causal_pairs(n, [n]), H), _nbytes(*rows))
    del rows
    sdpa, sdpa_all = _sdpa_both(q, k, v, n)
    print(f"  SDPA forward on the {n} valid rows {sdpa:.4f} ms, causal on "
          f"all {L} rows {sdpa_all:.4f} ms", flush=True)
    bound["library_ms_all_rows"] = sdpa_all
    return max(worst, err), (
        _median_ms(lambda: fa.flash_attention(q, k, v, lengths=lens), 10),
        _median_ms(lambda: fa.flash_attention_plain(q, k, v, lengths=lens), 3)
    ), bound, sdpa


def _sdpa_both(q, k, v, n: int, iters: int = 10):
    """SDPA's causal forward on the first n rows (the valid ones) and on all
    L rows: the second does within a few percent of the kernel's work (all
    L query rows attend keys below n)."""
    qh, kh, vh = (_heads_first(x[:, :n], q.shape[2]) for x in (q, k, v))
    qa, ka, va = (_heads_first(x, q.shape[2]) for x in (q, k, v))
    return (_sdpa_ms(qh, kh, vh, iters, is_causal=True),
            _sdpa_ms(qa, ka, va, iters, is_causal=True))


def check_decode(dev):
    import torch

    from video3d_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(3)
    NL, H, KV, hd, S, layer = 28, 28, 4, 128, 8704, 27
    worst = 0.0
    timed = None
    # the last two: fewer live positions than the 33 CTAs of a kv head, so
    # some CTAs' ranges are empty, also inside a row's span; a kv_len 0 row
    # must read zeros
    for lens in ([6812], [8704, 6812, 300, 4097], [20], [7, 0, 9, 3]):
        B = len(lens)
        q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(torch.bfloat16)
        k_all = torch.randn(NL, B, S, KV * hd, generator=g,
                            device=dev).to(torch.bfloat16)
        v_all = torch.randn(NL, B, S, KV * hd, generator=g,
                            device=dev).to(torch.bfloat16)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = da.decode_attention(q, k_all, v_all, kv_len, layer, KV)
        ref = da.decode_attention_plain(q, k_all, v_all, kv_len, layer, KV)
        live = [b for b, n in enumerate(lens) if n]
        err = float((out[live].float() - ref[live].float()).abs().max())
        zeros = all(bool((out[b] == 0).all())
                    for b, n in enumerate(lens) if n == 0)
        _check(f"B3 B={B} kv_len={lens}", err <= 2e-2 and zeros,
               f"max |d| {err:.2e} over the live rows; kv_len 0 rows zero: "
               f"{zeros}")
        _check_repeat(f"B3 B={B} kv_len={lens}", lambda: da.decode_attention(
            q, k_all, v_all, kv_len, layer, KV), out)
        worst = max(worst, err)
        if timed is None:
            timed = (q, k_all, v_all, kv_len)
        del k_all, v_all
    q, k_all, v_all, kv_len = timed
    n = int(kv_len[0])
    # the layer's first kv_len keys and values, the query, the output
    bound = _bound(_attn(n, H), 2 * n * KV * hd * 2 + 2 * _nbytes(q))
    _time_decode_b8(dev, "bf16")
    kh, vh = (_heads_first(x[layer, :, :n].reshape(1, n, KV, hd), H)
              for x in (k_all, v_all))
    return worst, (
        _kernel_ms(lambda: da.decode_attention(q, k_all, v_all, kv_len,
                                               layer, KV), 50),
        _median_ms(lambda: da.decode_attention_plain(q, k_all, v_all, kv_len,
                                                     layer, KV), 10)
    ), bound, _sdpa_ms(q.transpose(1, 2).contiguous(), kh, vh, 50)


# B2 folded's cases (L, offsets, kv_len): the B=1 prefix-hit shape; two
# batch rows; a 256-query bucket; a chunk whose own keys hold a boundary
# between two splits over keys (8 splits of 3 key tiles: key 256); a batch
# row so short that some of its splits hold no key tile
FOLDED_CASES = ((64, [6716], [6756]), (64, [6716, 5000], [6756, 5064]),
                (256, [6716], [6916]), (64, [200], [264]),
                (64, [6716, 100], [6756, 164]))
# the speculative verify block (phase 14, K = SPEC_K drafts): L = K+1 = 5
# query rows per batch row of B=8, each row at its own offset in 6.7k-6.8k
SPEC_K = 4
VERIFY_OFFSETS = [6716, 6731, 6745, 6752, 6768, 6779, 6790, 6801]
VERIFY_CASE = (SPEC_K + 1, VERIFY_OFFSETS,
               [o + SPEC_K + 1 for o in VERIFY_OFFSETS])
FOLDED_CASES += (VERIFY_CASE,)
#: B2 folded's times at the verify shape, by kernel name (phase 3)
VERIFY_ROWS: dict = {}


def _time_verify(name: str, args) -> None:
    """B2 folded (any form) at the verify shape: warm and L2-flushed ms,
    the plain version's ms and the bound, kept in VERIFY_ROWS."""
    from video3d_tpu_torch.kernels import flash_attention as fa

    warm, flushed = _kernel_ms(lambda: fa.flash_attention_gqa_folded(*args),
                               50)
    plain = _median_ms(lambda: fa.flash_attention_gqa_folded_plain(*args), 10)
    bound = _folded_bound(*args)
    library = _folded_sdpa_ms(*args)
    VERIFY_ROWS[name] = {"ms": warm, "ms_l2_flushed": flushed,
                         "plain_ms": plain, "bound_ms": bound["bound_ms"],
                         "bound_by": bound["bound_by"],
                         "library_ms": library}
    print(f"  {name} at the verify shape (B=8, L={SPEC_K + 1}): {warm:.4f} "
          f"ms warm, {flushed:.4f} ms L2 flushed, plain {plain:.4f} ms, "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
          f"{bound['bytes'] / 1e6:.1f} MB), library "
          + ("none" if library is None else f"{library:.4f} ms (SDPA, "
             "masked, the rows padded to the longest)"), flush=True)
# B5's cases (P, suffix_lens) at L=64: B=8, whose 128-row CTAs straddle
# batch rows (448 rows per batch row); B=3 with P not a multiple of the key
# tile; B=2, whose prefix pass splits over keys
PREFIX_CASES = ((6716, [64, 40, 17, 64, 33, 50, 8, 60]), (1000, [64, 1, 45]),
                (6716, [64, 23]))


# phase 5's B=8 rows (a scene prefix of 6716 positions, its suffix and the
# answer so far) in a cache of 8704 slots
B8_LENS = [6780, 6801, 6750, 6912, 6790, 6760, 6845, 6812]


def _time_decode_b8(dev, form: str) -> None:
    """B3 (``form``) timed at phase 5's B=8 shape: 8 rows of ~6.8k over
    layer 27 of a stacked 28-layer cache of 8704 slots."""
    import torch

    from video3d_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(30)
    NL, H, KV, hd, S, B = CACHE_LAYERS, 28, 4, 128, 8704, len(B8_LENS)
    q = (Q_SCALE * torch.randn(B, 1, H, hd, generator=g,
                               device=dev)).to(torch.bfloat16)
    kv_len = torch.tensor(B8_LENS, dtype=torch.int32, device=dev)
    ks = vs = None
    if form == "bf16":
        k = torch.randn(NL, B, S, KV * hd, generator=g,
                        device=dev).to(torch.bfloat16)
        v = torch.randn(NL, B, S, KV * hd, generator=g,
                        device=dev).to(torch.bfloat16)
    else:
        bits = 8 if form == "int8" else 4
        k, ks = _int8_cache(g, dev, (NL, B, S), KV, hd, bits=bits)
        v, vs = _int8_cache(g, dev, (NL, B, S), KV, hd, v_scale=0.5,
                            bits=bits)
    args = (q, k, v, kv_len, NL - 1, KV, ks, vs)
    per = 2 * k.shape[-1] * k.element_size() + (2 * KV * 4 if ks is not None
                                                 else 0)
    _timed_row(f"B3 {form} B=8 kv_len ~6.8k (phase 5's rows)",
               lambda: da.decode_attention(*args),
               sum(B8_LENS) * per + 2 * _nbytes(q))
    del args, k, v, ks, vs
    torch.cuda.empty_cache()


def _check_repeat(name: str, fn, out) -> None:
    """A second call on the same inputs gives the same bits (the splits
    merge in a fixed order)."""
    import torch

    same = bool(torch.equal(fn(), out))
    _check(f"{name} repeat", same, f"bit-identical to the first call: {same}")


def check_folded(dev):
    """B2 folded at the B=1 prefix-hit shape: a 64-token suffix bucket at
    position ~6716 of a stacked 28-layer cache of 8224 slots, and the other
    FOLDED_CASES; controls: the chunk's causal mask dropped, the first key
    tile skipped; each case called twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(4)
    NL, H, KV, hd, S, layer = 28, 28, 4, 128, 8224, 27
    worst, timed = 0.0, None
    for L, offs, lens in FOLDED_CASES:
        B = len(offs)
        q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)
        k_all = torch.randn(NL, B, S, KV * hd, generator=g,
                            device=dev).to(torch.bfloat16)
        for b, (o, n) in enumerate(zip(offs, lens)):
            k_all[layer, b, o:n, ::hd] += FOCUS       # the chunk's own keys
        v_all = (0.5 * torch.randn(NL, B, S, KV * hd, generator=g,
                                   device=dev)).to(torch.bfloat16)
        offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, k_all, v_all, lens_t, offs_t, layer, KV)
        rows = [n - o for o, n in zip(offs, lens)]
        out = fa.flash_attention_gqa_folded(*args)
        qf = q.float()          # the plain version on the same values in f32
        ref = fa.flash_attention_gqa_folded_plain(qf, *args[1:])
        err = _rows_err(out, ref, rows)
        plain_err = _rows_err(fa.flash_attention_gqa_folded_plain(*args),
                              ref, rows)
        finite = bool(torch.isfinite(out.float()).all())
        name = f"B2 folded B={B} L={L} offsets={offs} kv_len={lens}"
        _check(name, err <= BF16_ATOL and finite,
               f"max |d| {err:.2e} on rows below kv_len, finite={finite} "
               f"(the bf16 plain version: {plain_err:.2e})")
        _check_repeat(name, lambda: fa.flash_attention_gqa_folded(*args), out)
        _check_controls(name, ref, rows, {
            # every row sees the whole chunk
            "no causal mask in the chunk": fa.flash_attention_gqa_folded_plain(
                qf, k_all, v_all, lens_t, lens_t - 1, layer, KV),
            "first key tile skipped": fa.flash_attention_gqa_folded_plain(
                qf, k_all[:, :, 64:], v_all[:, :, 64:], lens_t - 64,
                offs_t - 64, layer, KV)})
        worst = max(worst, err)
        if timed is None:
            timed = args
        if (L, offs, lens) == VERIFY_CASE:
            _time_verify("flash_attention_folded", args)
    return worst, (
        _kernel_ms(lambda: fa.flash_attention_gqa_folded(*timed), 50),
        _median_ms(lambda: fa.flash_attention_gqa_folded_plain(*timed), 10)
    ), _folded_bound(*timed), _folded_sdpa_ms(*timed)


def _folded_bound(q, k_all, v_all, lens, offs, layer, KV, ks=None, vs=None):
    """Rows below kv_len attend keys up to their position; the layer's
    first kv_len keys and values (and the scales of a quantized cache) are
    read once."""
    H, L, hd = q.shape[2], q.shape[1], q.shape[3]
    pairs = sum(sum(o + r + 1 for r in range(n - o))
                for o, n in zip(offs.tolist(), lens.tolist()))
    kv = sum(lens.tolist()) * k_all.shape[-1] * k_all.element_size() * 2
    if ks is not None:
        kv += sum(lens.tolist()) * KV * 4 * 2
    return _bound(_attn(pairs, H, hd), kv + 2 * _nbytes(q))


def _folded_sdpa_ms(q, k_all, v_all, lens, offs, layer, KV, ks=None,
                    vs=None):
    """SDPA over the bf16 cache's layer with an explicit mask: every batch
    row's keys up to the longest row, each query row seeing the keys up to
    its own position (the verify shape's rows sit at their own offsets);
    None for a quantized cache (no single PyTorch call reads it)."""
    import torch

    if ks is not None:
        return None
    B, L, H, hd = q.shape
    n = int(lens.max())
    kh, vh = (_heads_first(x[layer, :, :n].reshape(B, n, KV, hd), H)
              for x in (k_all, v_all))
    pos = offs.long()[:, None] + torch.arange(L, device=q.device)
    mask = torch.arange(n, device=q.device)[None, None, :] <= pos[..., None]
    return _sdpa_ms(q.transpose(1, 2).contiguous(), kh, vh, 50,
                    attn_mask=mask[:, None])


# phase 3 at head width 256 (Gemma-2B: 8 query heads on one kv head):
# B2's prefill at the 8192 bucket, B2 folded at the B=1 prefix-hit shape
# over an 18-layer cache, B3 at ~6.8k positions; each case's edge shapes
# put a second kv head in, for the kv-head-off-by-one control
HD256_HEADS = (8, 1)
HD256_LAYERS = 18
HD256_FLASH = ((1, 8192, [6780]), (2, 300, [300, 150]), (3, 65, [1, 64, 65]))
HD256_FOLDED = ((64, [6716], [6756]), (64, [700, 100], [740, 164]))
HD256_DECODE = ([6812], [8704, 6812, 300, 4097], [7, 0, 9, 3])


def _kv_head_shifted(x, hd: int):
    """A flat (..., KV * hd) cache with every kv head reading the next
    one's channels (a kv head off by one)."""
    return x.roll(hd, dims=-1)


def check_flash_hd256(dev):
    """B2's prefill form at hd 256 against its plain twin in f32: the main
    case at Gemma-2B's heads (B=1, L=8192, length 6780), two edge cases
    (ragged lengths, a row of length 1, 64-row tile edges; the second with
    two kv heads); controls: the key tile 64-127 dropped, the causal mask
    dropped, and (KV = 2) each query head reading the other kv head."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(21)
    hd, tile = 256, (64, 128)
    worst, main = 0.0, None
    for i, (B, L, lengths) in enumerate(HD256_FLASH):
        H, KV = (HD256_HEADS if i != 1 else (8, 2))
        q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        k = torch.randn(B, L, KV, hd, generator=g, device=dev)
        k[:, tile[0]:tile[1], :, 0] += FOCUS
        v = 0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = fa.flash_attention(q, k, v, lengths=lens)
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = h256.prefill_hd256_plain(qf, kf, vf, lens)
        err = _rows_err(out, ref, lengths)
        finite = bool(torch.isfinite(out.float()).all())
        name = f"B2 hd256 B={B} L={L} H={H} KV={KV} lengths={lengths}"
        _check(name, err <= BF16_ATOL and finite,
               f"max |d| {err:.2e} on rows < length, finite={finite}")
        controls = {"no causal mask": h256.prefill_hd256_plain(
            qf, kf, vf, lens, causal=False)}
        if L > tile[1]:
            controls[f"keys {tile[0]}-{tile[1] - 1} dropped"] = \
                _tile_dropped(qf, kf, vf, lens, *tile)
        if KV > 1:
            controls["kv head off by one"] = h256.prefill_hd256_plain(
                qf, kf.roll(1, dims=2), vf.roll(1, dims=2), lens)
        _check_controls(name, ref, lengths, controls)
        del ref, qf, kf, vf, controls
        worst = max(worst, err)
        if main is None:
            main = (q, k, v, lens)
    q, k, v, lens = main
    B, L, lengths = HD256_FLASH[0]
    H = HD256_HEADS[0]
    n = lengths[0]
    rows = tuple(x[:, :n] for x in (q, k, v, q))
    bound = _bound(_attn(_causal_pairs(n, [n]), H, hd), _nbytes(*rows))
    del rows
    sdpa, sdpa_all = _sdpa_both(q, k, v, n)
    print(f"  SDPA forward on the {n} valid rows {sdpa:.4f} ms, causal on "
          f"all {L} rows {sdpa_all:.4f} ms", flush=True)
    bound["library_ms_all_rows"] = sdpa_all
    return worst, (
        _kernel_ms(lambda: fa.flash_attention(q, k, v, lengths=lens), 10),
        _median_ms(lambda: h256.prefill_hd256_plain(q, k, v, lens), 3)
    ), bound, sdpa


def check_folded_hd256(dev):
    """B2 folded at hd 256: a 64-token suffix at ~6716 of an 18-layer
    stacked cache of 8224 slots at Gemma-2B's heads, and a two-row case
    with two kv heads whose short row leaves splits empty; controls: the
    chunk's causal mask dropped, the chunk's own keys dropped, (KV = 2)
    the first key tile skipped and a kv head off by one; each case twice,
    bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(22)
    NL, hd, S, layer = HD256_LAYERS, 256, 8224, HD256_LAYERS - 1
    worst, timed = 0.0, None
    for i, (L, offs, lens) in enumerate(HD256_FOLDED):
        H, KV = HD256_HEADS if i == 0 else (8, 2)
        B = len(offs)
        q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)
        k_all = torch.randn(NL, B, S, KV * hd, generator=g,
                            device=dev).to(torch.bfloat16)
        for b, (o, n) in enumerate(zip(offs, lens)):
            k_all[layer, b, o:n, ::hd] += FOCUS
        v_all = (0.5 * torch.randn(NL, B, S, KV * hd, generator=g,
                                   device=dev)).to(torch.bfloat16)
        offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, k_all, v_all, lens_t, offs_t, layer, KV)
        rows = [n - o for o, n in zip(offs, lens)]
        out = fa.flash_attention_gqa_folded(*args)
        qf = q.float()
        ref = h256.folded_hd256_plain(qf, *args[1:])
        err = _rows_err(out, ref, rows)
        finite = bool(torch.isfinite(out.float()).all())
        name = f"B2 folded hd256 B={B} L={L} KV={KV} offsets={offs}"
        _check(name, err <= BF16_ATOL and finite,
               f"max |d| {err:.2e} on rows below kv_len, finite={finite}")
        _check_repeat(name, lambda: fa.flash_attention_gqa_folded(*args), out)
        controls = {
            "no causal mask in the chunk": h256.folded_hd256_plain(
                qf, k_all, v_all, lens_t, lens_t - 1, layer, KV),
            "the chunk's own keys dropped": h256.folded_hd256_plain(
                qf, k_all, v_all, offs_t, offs_t, layer, KV)}
        if KV > 1:
            # (at KV = 1 the first tile's unfocused keys weigh too little
            # for this control to clear 4x: it read 7.87e-02 on an H100,
            # and one focused key of 64 dropped read 1.20e-02)
            controls["first key tile skipped"] = h256.folded_hd256_plain(
                qf, k_all[:, :, 64:], v_all[:, :, 64:], lens_t - 64,
                offs_t - 64, layer, KV)
            controls["kv head off by one"] = h256.folded_hd256_plain(
                qf, _kv_head_shifted(k_all, hd), _kv_head_shifted(v_all, hd),
                lens_t, offs_t, layer, KV)
        _check_controls(name, ref, rows, controls)
        worst = max(worst, err)
        if timed is None:
            timed = args
    return worst, (
        _kernel_ms(lambda: fa.flash_attention_gqa_folded(*timed), 50),
        _median_ms(lambda: h256.folded_hd256_plain(*timed), 10)
    ), _folded_bound(*timed), _folded_sdpa_ms(*timed)


def check_decode_hd256(dev):
    """B3 at hd 256 over an 18-layer cache of 8704 slots at Gemma-2B's
    heads: one row of 6812 positions, four rows, and fewer live positions
    than CTAs with a kv_len 0 row (zeros); controls: the 4 peaked last keys
    dropped and (KV = 2 on the four rows) a kv head off by one."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(23)
    NL, hd, S, layer = HD256_LAYERS, 256, 8704, HD256_LAYERS - 1
    worst, timed = 0.0, None
    for i, lens in enumerate(HD256_DECODE):
        H, KV = HD256_HEADS if i != 1 else (8, 2)
        B = len(lens)
        q = Q_SCALE * torch.randn(B, 1, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)
        k_all = torch.randn(NL, B, S, KV * hd, generator=g,
                            device=dev).to(torch.bfloat16)
        for b, n in enumerate(lens):
            k_all[layer, b, max(n - 4, 0):n, ::hd] += FOCUS
        v_all = (0.5 * torch.randn(NL, B, S, KV * hd, generator=g,
                                   device=dev)).to(torch.bfloat16)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = da.decode_attention(q, k_all, v_all, kv_len, layer, KV)
        qf = q.float()
        ref = h256.decode_hd256_plain(qf, k_all, v_all, kv_len, layer, KV)
        live = [b for b, n in enumerate(lens) if n]
        err = float((out[live].float() - ref[live]).abs().max())
        zeros = all(bool((out[b] == 0).all())
                    for b, n in enumerate(lens) if n == 0)
        name = f"B3 hd256 B={B} KV={KV} kv_len={lens}"
        _check(name, err <= BF16_ATOL and zeros,
               f"max |d| {err:.2e} over the live rows; kv_len 0 rows zero: "
               f"{zeros}")
        _check_repeat(name, lambda: da.decode_attention(
            q, k_all, v_all, kv_len, layer, KV), out)
        controls = {"the 4 focused keys dropped": h256.decode_hd256_plain(
            qf, k_all, v_all, (kv_len - 4).clamp(min=1), layer, KV)[live]}
        if KV > 1:
            controls["kv head off by one"] = h256.decode_hd256_plain(
                qf, _kv_head_shifted(k_all, hd), _kv_head_shifted(v_all, hd),
                kv_len, layer, KV)[live]
        _check_controls(name, ref[live], [1] * len(live), controls)
        worst = max(worst, err)
        if timed is None:
            timed = (q, k_all, v_all, kv_len)
        else:
            del k_all, v_all
    q, k_all, v_all, kv_len = timed
    H, KV = HD256_HEADS
    n = int(kv_len[0])
    bound = _bound(_attn(n, H, hd), 2 * n * KV * hd * 2 + 2 * _nbytes(q))
    kh, vh = (_heads_first(x[layer, :, :n].reshape(1, n, KV, hd), H)
              for x in (k_all, v_all))
    return worst, (
        _kernel_ms(lambda: da.decode_attention(q, k_all, v_all, kv_len,
                                               layer, KV), 50),
        _median_ms(lambda: h256.decode_hd256_plain(q, k_all, v_all, kv_len,
                                                   layer, KV), 10)
    ), bound, _sdpa_ms(q.transpose(1, 2).contiguous(), kh, vh, 50)


def check_paged_hd256(dev):
    """B7 at hd 256 at the hd-128 B7 row's serving shape (8 slots of ~6.8k
    aliasing 52 prefix pages of 128, a kv_len 0 slot, one ending mid-page)
    over an 18-layer pool at Gemma-2B's heads, against its twin in f32 on
    the same values; controls: the two longest slots' page rows swapped,
    each slot's last live page dropped; called twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(24)
    args = _paged_inputs(g, dev, "bf16", NL=HD256_LAYERS, heads=HD256_HEADS,
                         hd=256)[:7]
    q, k, v, table, kv_len, layer, KV = args
    live = sum(-(-n // PAGED_PAGE) for n in PAGED_LENS)
    name = (f"B7 hd256 S={q.shape[0]} kv_len={PAGED_LENS} ({live} live "
            f"pages over a pool of {k.shape[1]})")
    out = pa.paged_decode_attention(*args)
    qf = q.float()
    ref = h256.paged_hd256_plain(qf, *args[1:])
    rows = [1] * q.shape[0]
    err = _rows_err(out, ref, rows)
    finite = bool(torch.isfinite(out.float()).all())
    zero = bool((out[PAGED_LENS.index(0)] == 0).all())
    _check(name, err <= BF16_ATOL and finite and zero,
           f"max |d| {err:.2e}, finite={finite}, kv_len 0 slot zero={zero}")
    _check_repeat(name, lambda: pa.paged_decode_attention(*args), out)
    a, b = sorted(range(len(PAGED_LENS)), key=PAGED_LENS.__getitem__)[-2:]
    swapped = table.clone()
    swapped[[a, b]] = table[[b, a]]
    last_page = ((kv_len - 1).clamp(min=0) // PAGED_PAGE) * PAGED_PAGE
    _check_controls(name, ref, rows, {
        "the two longest slots' page rows swapped": h256.paged_hd256_plain(
            qf, k, v, swapped, kv_len, layer, KV),
        "each slot's last live page dropped": h256.paged_hd256_plain(
            qf, k, v, table, last_page, layer, KV)})
    bound = _paged_bound(*args)
    _print_paged_bytes(bound, k, KV)
    return err, (
        _kernel_ms(lambda: pa.paged_decode_attention(*args), 50),
        _median_ms(lambda: h256.paged_hd256_plain(*args), 5)
    ), bound, None


def check_shared_prefix_hd256(dev):
    """B5 at hd 256 at the B=8 suffix-batch shape (64-token bucket, a
    6716-token prefix whose last 64-key tile is partial, ragged suffix
    lengths) at Gemma-2B's heads, against its twin in f32 on the same
    values; the first prefix tile and the suffix focused; controls: the
    suffix's causal mask dropped, the next row's suffix attended, the
    first prefix tile skipped; called twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import flash_attention as fa
    from video3d_tpu_torch.kernels.attention import mha_reference

    g = torch.Generator(device=dev).manual_seed(25)
    (H, KV), hd, L = HD256_HEADS, 256, 64
    P, slens = PREFIX_CASES[0]
    B = len(slens)
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    pk = torch.randn(P, KV, hd, generator=g, device=dev)
    pk[:64, :, 0] += FOCUS
    pv = 0.5 * torch.randn(P, KV, hd, generator=g, device=dev)
    sk = torch.randn(B, L, KV, hd, generator=g, device=dev)
    sk[..., 0] += FOCUS
    sv = 0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)
    q, pk, pv, sk, sv = (x.to(torch.bfloat16) for x in (q, pk, pv, sk, sv))
    slens_t = torch.tensor(slens, dtype=torch.int32, device=dev)
    args = (q, pk, pv, sk, sv, slens_t)
    out = fa.flash_attention_shared_prefix(*args)
    qf = q.float()
    ref = h256.shared_prefix_hd256_plain(qf, *args[1:])
    err = _rows_err(out, ref, slens)
    plain_err = _rows_err(h256.shared_prefix_hd256_plain(*args), ref, slens)
    finite = bool(torch.isfinite(out.float()).all())
    name = f"B5 hd256 B={B} L={L} P={P} suffix_lens={slens}"
    _check(name, err <= BF16_ATOL and finite,
           f"max |d| {err:.2e} on rows below suffix_lens, finite={finite} "
           f"(the bf16 plain version: {plain_err:.2e})")
    _check_repeat(name, lambda: fa.flash_attention_shared_prefix(*args), out)
    k = torch.cat([pk.expand(B, P, KV, hd), sk], 1).float()
    v = torch.cat([pv.expand(B, P, KV, hd), sv], 1).float()
    _check_controls(name, ref, slens, {
        "no causal mask in the suffix": mha_reference(
            qf, k, v, q_positions=torch.full((B, L), P + L - 1, device=dev),
            kv_len=P + slens_t),
        "the next row's suffix attended": h256.shared_prefix_hd256_plain(
            qf, pk, pv, sk.roll(1, 0), sv.roll(1, 0), slens_t.roll(1, 0)),
        "first prefix tile skipped": h256.shared_prefix_hd256_plain(
            qf, pk[64:], pv[64:], sk, sv, slens_t)})
    del k, v
    return err, (
        _kernel_ms(lambda: fa.flash_attention_shared_prefix(*args), 10),
        _median_ms(lambda: h256.shared_prefix_hd256_plain(*args), 3)
    ), _prefix_bound(*args), _prefix_sdpa_ms(*args)


def _hd256_quant_controls(plain, k8, v8, ks, vs, pos_dim: int,
                          kv_dim: int, KV: int, bits: int) -> dict:
    """The broken plain versions of a quantized hd-256 check, each
    ``plain(k8, v8, ks, vs)`` with one part wrong: the scales one position
    off, (KV > 1) the next kv head's scales, the value scales dropped,
    (int4) the nibbles of each byte swapped."""
    import torch

    def rolled(dim):
        return torch.roll(ks, 1, dims=dim), torch.roll(vs, 1, dims=dim)

    controls = {"scales one position off": plain(k8, v8, *rolled(pos_dim)),
                "the value scales dropped": plain(k8, v8, ks,
                                                  torch.ones_like(vs))}
    if KV > 1:
        controls["the next kv head's scales"] = plain(k8, v8,
                                                      *rolled(kv_dim))
    if bits == 4:
        controls["nibbles of each byte swapped"] = plain(
            _nibbles_swapped(k8), _nibbles_swapped(v8), ks, vs)
    return controls


def check_folded_hd256_quant(dev, bits: int):
    """B2 folded at hd 256 over an int8 (bits 8) or packed int4 (bits 4)
    18-layer cache at the bf16 row's shapes (HD256_FOLDED: Gemma-2B's B=1
    hit, and two rows with two kv heads), the chunk's own keys focused
    before quantization, against its twin in f32 on the same quantized
    values and scales; controls: the scale controls and the chunk's own
    keys dropped; each case twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(26 if bits == 8 else 36)
    NL, hd, S, layer = HD256_LAYERS, 256, 8224, HD256_LAYERS - 1
    worst, timed = 0.0, None
    for i, (L, offs, lens) in enumerate(HD256_FOLDED):
        H, KV = HD256_HEADS if i == 0 else (8, 2)
        B = len(offs)
        q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)

        def focus(j, x):       # the chunk's own keys, before quantization
            if j == layer:
                for b, (o, n) in enumerate(zip(offs, lens)):
                    x[b, o:n, :, 0] += FOCUS

        k8, ks = _int8_cache(g, dev, (NL, B, S), KV, hd, edit=focus,
                             bits=bits)
        v8, vs = _int8_cache(g, dev, (NL, B, S), KV, hd, v_scale=0.5,
                             bits=bits)
        offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, k8, v8, lens_t, offs_t, layer, KV, ks, vs)
        rows = [n - o for o, n in zip(offs, lens)]
        out = fa.flash_attention_gqa_folded(*args)
        qf = q.float()

        def plain(k_, v_, ks_, vs_, lens_=lens_t, offs_=offs_t):
            return h256.folded_hd256_plain(qf, k_, v_, lens_, offs_, layer,
                                           KV, ks_, vs_)
        ref = plain(k8, v8, ks, vs)
        err = _rows_err(out, ref, rows)
        plain_err = _rows_err(h256.folded_hd256_plain(*args), ref, rows)
        finite = bool(torch.isfinite(out.float()).all())
        name = (f"B2 folded hd256 int{bits} B={B} L={L} KV={KV} "
                f"offsets={offs}")
        _check(name, err <= BF16_ATOL and finite,
               f"max |d| {err:.2e} on rows below kv_len, finite={finite} "
               f"(the bf16 plain version: {plain_err:.2e})")
        _check_repeat(name, lambda: fa.flash_attention_gqa_folded(*args), out)
        controls = _hd256_quant_controls(plain, k8, v8, ks, vs, 2, 3, KV,
                                         bits)
        controls["the chunk's own keys dropped"] = plain(
            k8, v8, ks, vs, offs_t, offs_t)
        _check_controls(name, ref, rows, controls)
        del controls
        worst = max(worst, err)
        if timed is None:
            timed = args
    return worst, (
        _kernel_ms(lambda: fa.flash_attention_gqa_folded(*timed), 50),
        _median_ms(lambda: h256.folded_hd256_plain(*timed), 10)
    ), _folded_bound(*timed), None


def check_decode_hd256_quant(dev, bits: int):
    """B3 at hd 256 over an int8 / packed int4 18-layer cache of 8704
    slots at the bf16 row's lengths (HD256_DECODE: one row of 6812, four
    rows with two kv heads, fewer live positions than CTAs with a kv_len 0
    row), the last 4 keys focused before quantization, against its twin in
    f32 on the same quantized values; controls: the scale controls and the
    4 focused keys dropped."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(27 if bits == 8 else 37)
    NL, hd, S, layer = HD256_LAYERS, 256, 8704, HD256_LAYERS - 1
    worst, timed = 0.0, None
    for i, lens in enumerate(HD256_DECODE):
        H, KV = HD256_HEADS if i != 1 else (8, 2)
        B = len(lens)
        q = Q_SCALE * torch.randn(B, 1, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)

        def focus(j, x):
            if j == layer:
                for b, n in enumerate(lens):
                    x[b, max(n - 4, 0):n, :, 0] += FOCUS

        k8, ks = _int8_cache(g, dev, (NL, B, S), KV, hd, edit=focus,
                             bits=bits)
        v8, vs = _int8_cache(g, dev, (NL, B, S), KV, hd, v_scale=0.5,
                             bits=bits)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, k8, v8, kv_len, layer, KV, ks, vs)
        out = da.decode_attention(*args)
        qf = q.float()
        live = [b for b, n in enumerate(lens) if n]

        def plain(k_, v_, ks_, vs_, lens_=kv_len):
            return h256.decode_hd256_plain(qf, k_, v_, lens_, layer, KV, ks_,
                                           vs_)[live]
        ref = plain(k8, v8, ks, vs)
        err = float((out[live].float() - ref).abs().max())
        plain_err = float((h256.decode_hd256_plain(*args)[live].float()
                           - ref).abs().max())
        zeros = all(bool((out[b] == 0).all())
                    for b, n in enumerate(lens) if n == 0)
        name = f"B3 hd256 int{bits} B={B} KV={KV} kv_len={lens}"
        _check(name, err <= BF16_ATOL and zeros,
               f"max |d| {err:.2e} over the live rows; kv_len 0 rows zero: "
               f"{zeros} (the bf16 plain version: {plain_err:.2e})")
        _check_repeat(name, lambda: da.decode_attention(*args), out)
        controls = _hd256_quant_controls(plain, k8, v8, ks, vs, 2, 3, KV,
                                         bits)
        controls["the 4 focused keys dropped"] = plain(
            k8, v8, ks, vs, (kv_len - 4).clamp(min=1))
        _check_controls(name, ref, [1] * len(live), controls)
        del controls
        worst = max(worst, err)
        if timed is None:
            timed = args
        else:
            del k8, v8
    q, k8, v8, kv_len, layer, KV, ks, vs = timed
    H = HD256_HEADS[0]
    n = int(kv_len[0])
    row_bytes = k8.shape[-1] * k8.element_size()
    # the layer's first kv_len quantized keys and values and their f32
    # scales, the query and the output
    bound = _bound(_attn(n, H, hd),
                   2 * n * (row_bytes + KV * 4) + 2 * _nbytes(q))
    return worst, (
        _kernel_ms(lambda: da.decode_attention(*timed), 50),
        _median_ms(lambda: h256.decode_hd256_plain(*timed), 10)
    ), bound, None


def check_paged_hd256_quant(dev, bits: int):
    """B7 at hd 256 over int8 / packed int4 18-layer pools at the bf16
    row's serving shape (8 slots of ~6.8k aliasing 52 prefix pages of 128,
    a kv_len 0 slot, the last 16 keys of every slot focused before
    quantization) at Gemma-2B's heads, against its twin in f32 on the same
    values; controls: the scale controls, the two longest slots' page rows
    swapped, each slot's last live page dropped; twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(28 if bits == 8 else 38)
    args = _paged_inputs(g, dev, f"int{bits}", NL=HD256_LAYERS,
                         heads=HD256_HEADS, hd=256)
    q, k, v, table, kv_len, layer, KV, ks, vs = args
    live = sum(-(-n // PAGED_PAGE) for n in PAGED_LENS)
    name = (f"B7 hd256 int{bits} S={q.shape[0]} kv_len={PAGED_LENS} ({live} "
            f"live pages over a pool of {k.shape[1]})")
    out = pa.paged_decode_attention(*args)
    qf = q.float()

    def plain(k_, v_, ks_, vs_, table_=table, lens_=kv_len):
        return h256.paged_hd256_plain(qf, k_, v_, table_, lens_, layer, KV,
                                      ks_, vs_)
    ref = plain(k, v, ks, vs)
    rows = [1] * q.shape[0]
    err = _rows_err(out, ref, rows)
    plain_err = _rows_err(h256.paged_hd256_plain(*args), ref, rows)
    finite = bool(torch.isfinite(out.float()).all())
    zero = bool((out[PAGED_LENS.index(0)] == 0).all())
    _check(name, err <= BF16_ATOL and finite and zero,
           f"max |d| {err:.2e}, finite={finite}, kv_len 0 slot zero={zero} "
           f"(the bf16 plain version: {plain_err:.2e})")
    _check_repeat(name, lambda: pa.paged_decode_attention(*args), out)
    a, b = sorted(range(len(PAGED_LENS)), key=PAGED_LENS.__getitem__)[-2:]
    swapped = table.clone()
    swapped[[a, b]] = table[[b, a]]
    last_page = ((kv_len - 1).clamp(min=0) // PAGED_PAGE) * PAGED_PAGE
    controls = _hd256_quant_controls(plain, k, v, ks, vs, -1, 2, KV, bits)
    controls["the two longest slots' page rows swapped"] = plain(
        k, v, ks, vs, swapped)
    controls["each slot's last live page dropped"] = plain(
        k, v, ks, vs, table, last_page)
    _check_controls(name, ref, rows, controls)
    del controls
    bound = _paged_bound(*args)
    _print_paged_bytes(bound, k, KV, ks)
    return err, (
        _kernel_ms(lambda: pa.paged_decode_attention(*args), 50),
        _median_ms(lambda: h256.paged_hd256_plain(*args), 5)
    ), bound, None


def check_shared_prefix_hd256_quant(dev, bits: int):
    """B5 at hd 256 over an int8 / packed int4 prefix at the bf16 row's
    B=8 suffix-batch shape (64-token bucket, a 6716-token prefix, ragged
    suffix lengths) at Gemma-2B's heads, the first prefix tile focused
    before quantization and the bf16 suffix focused, against its twin in
    f32 on the same values; controls: the scale controls and the first
    prefix tile skipped; twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(29 if bits == 8 else 39)
    (H, KV), hd, L = HD256_HEADS, 256, 64
    P, slens = PREFIX_CASES[0]
    B = len(slens)
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    q = q.to(torch.bfloat16)

    def focus(_, x):
        x[:64, :, 0] += FOCUS

    pk8, pks = _int8_cache(g, dev, (1, P), KV, hd, edit=focus, bits=bits)
    pv8, pvs = _int8_cache(g, dev, (1, P), KV, hd, v_scale=0.5, bits=bits)
    pk8, pks, pv8, pvs = (t[0].reshape(P, KV, -1)
                          for t in (pk8, pks, pv8, pvs))
    sk = torch.randn(B, L, KV, hd, generator=g, device=dev)
    sk[..., 0] += FOCUS
    sk = sk.to(torch.bfloat16)
    sv = (0.5 * torch.randn(B, L, KV, hd, generator=g,
                            device=dev)).to(torch.bfloat16)
    slens_t = torch.tensor(slens, dtype=torch.int32, device=dev)
    args = (q, pk8, pv8, sk, sv, slens_t, pks, pvs)
    out = fa.flash_attention_shared_prefix(*args)
    qf = q.float()

    def plain(k_, v_, ks_, vs_):
        return h256.shared_prefix_hd256_plain(qf, k_, v_, sk, sv, slens_t,
                                              ks_, vs_)
    ref = plain(pk8, pv8, pks, pvs)
    err = _rows_err(out, ref, slens)
    plain_err = _rows_err(h256.shared_prefix_hd256_plain(*args), ref, slens)
    finite = bool(torch.isfinite(out.float()).all())
    name = f"B5 hd256 int{bits} B={B} L={L} P={P} suffix_lens={slens}"
    _check(name, err <= BF16_ATOL and finite,
           f"max |d| {err:.2e} on rows below suffix_lens, finite={finite} "
           f"(the bf16 plain version: {plain_err:.2e})")
    _check_repeat(name, lambda: fa.flash_attention_shared_prefix(*args), out)
    controls = _hd256_quant_controls(plain, pk8, pv8, pks, pvs, 0, 1, KV,
                                     bits)
    controls["first prefix tile skipped"] = plain(pk8[64:], pv8[64:],
                                                  pks[64:], pvs[64:])
    _check_controls(name, ref, slens, controls)
    del controls
    return err, (
        _kernel_ms(lambda: fa.flash_attention_shared_prefix(*args), 10),
        _median_ms(lambda: h256.shared_prefix_hd256_plain(*args), 3)
    ), _prefix_bound(*args), None


def check_shared_prefix(dev):
    """B5 at the B=8 suffix-batch shape (64-token bucket, ~6716-token
    prefix, ragged suffix lengths), and the other PREFIX_CASES; controls:
    the suffix dropped, its causal mask dropped, the first prefix tile
    skipped; each case called twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa
    from video3d_tpu_torch.kernels.attention import (
        mha_reference, mha_shared_prefix_reference)

    g = torch.Generator(device=dev).manual_seed(5)
    H, KV, hd, L = 28, 4, 128, 64
    worst, timed = 0.0, None
    for P, slens in PREFIX_CASES:
        B = len(slens)
        q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)
        pk = torch.randn(P, KV, hd, generator=g, device=dev).to(torch.bfloat16)
        pv = (0.5 * torch.randn(P, KV, hd, generator=g,
                                device=dev)).to(torch.bfloat16)
        sk = torch.randn(B, L, KV, hd, generator=g, device=dev)
        sk[..., 0] += FOCUS
        sk = sk.to(torch.bfloat16)
        sv = (0.5 * torch.randn(B, L, KV, hd, generator=g,
                                device=dev)).to(torch.bfloat16)
        slens_t = torch.tensor(slens, dtype=torch.int32, device=dev)
        args = (q, pk, pv, sk, sv, slens_t)
        out = fa.flash_attention_shared_prefix(*args)
        qf = q.float()          # the plain version on the same values in f32
        ref = mha_shared_prefix_reference(qf, *args[1:])
        err = _rows_err(out, ref, slens)
        plain_err = _rows_err(mha_shared_prefix_reference(*args), ref, slens)
        finite = bool(torch.isfinite(out.float()).all())
        name = f"B5 B={B} L={L} P={P} suffix_lens={slens}"
        _check(name, err <= BF16_ATOL and finite,
               f"max |d| {err:.2e} on rows below suffix_lens, "
               f"finite={finite} (the bf16 plain version: {plain_err:.2e})")
        _check_repeat(name, lambda: fa.flash_attention_shared_prefix(*args),
                      out)
        k = torch.cat([pk.expand(B, P, KV, hd), sk], 1).float()
        v = torch.cat([pv.expand(B, P, KV, hd), sv], 1).float()
        _check_controls(name, ref, slens, {
            "suffix dropped": mha_shared_prefix_reference(
                qf, pk, pv, sk, sv, torch.zeros_like(slens_t)),
            # every row sees its whole suffix
            "no causal mask in the suffix": mha_reference(
                qf, k, v, q_positions=torch.full((B, L), P + L - 1,
                                                 device=dev),
                kv_len=P + slens_t),
            "first prefix tile skipped": mha_shared_prefix_reference(
                qf, pk[64:], pv[64:], sk, sv, slens_t)})
        del k, v
        worst = max(worst, err)
        if timed is None:
            timed = args
    return worst, (
        _kernel_ms(lambda: fa.flash_attention_shared_prefix(*timed), 20),
        _median_ms(lambda: mha_shared_prefix_reference(*timed), 5)
    ), _prefix_bound(*timed), _prefix_sdpa_ms(*timed)


def _prefix_bound(q, pk, pv, sk, sv, slens, pks=None, pvs=None):
    """Each row's suffix queries below suffix_lens attend the whole prefix
    and their suffix causally; the prefix (and a quantized one's scales)
    is read once."""
    B, L, H, hd = q.shape
    P = pk.shape[0]
    pairs = sum(sum(P + r + 1 for r in range(n)) for n in slens.tolist())
    nbytes = _nbytes(pk, pv, sk, sv) + 2 * _nbytes(q)
    if pks is not None:
        nbytes += _nbytes(pks, pvs)
    return _bound(_attn(pairs, H, hd), nbytes)


def _prefix_sdpa_ms(q, pk, pv, sk, sv, slens, pks=None, pvs=None):
    """SDPA over the prefix broadcast to every row and the row's suffix,
    with an explicit mask (prepared outside the timing); None for a
    quantized prefix."""
    import torch

    if pks is not None:
        return None
    B, L, H, hd = q.shape
    P = pk.shape[0]
    kh, vh = (_heads_first(torch.cat([p.expand(B, *p.shape), s], 1), H)
              for p, s in ((pk, sk), (pv, sv)))
    cols = torch.arange(P + L, device=q.device)
    mask = cols[None, :] <= P + torch.arange(L, device=q.device)[:, None]
    return _sdpa_ms(q.transpose(1, 2).contiguous(), kh, vh, 20,
                    attn_mask=mask)


def _int8_cache(g, dev, lead, KV: int, hd: int, v_scale: float = 1.0,
                edit=None, bits: int = 8):
    """A flat (*lead, KV*hd) int8 cache, or (bits 4) an int4 one packed two
    values per uint8 byte, (*lead, KV*hd / 2), and its (*lead, KV, 1) f32
    scales, quantized with the port's cache write (``quantize_rows``) from
    bf16 N(0, v_scale) values, one leading index at a time (to bound the
    temporaries); ``edit(i, x)`` may change the bf16 values x (lead[1:] +
    (KV, hd)) of leading index i first."""
    import torch

    from video3d_tpu_torch.models.qwen2 import quantize_rows

    storage = torch.int8 if bits == 8 else torch.uint8
    vals = torch.empty((*lead, KV * hd * bits // 8), dtype=storage,
                       device=dev)
    scales = torch.empty((*lead, KV, 1), dtype=torch.float32, device=dev)
    for i in range(lead[0]):
        x = (v_scale * torch.randn(*lead[1:], KV, hd, generator=g,
                                   device=dev)).to(torch.bfloat16)
        if edit is not None:
            edit(i, x)
        vals[i], scales[i] = quantize_rows(x, storage)
    return vals, scales


def _nibbles_swapped(x):
    """Packed int4 bytes with their two nibbles swapped (a control)."""
    return ((x >> 4) & 0x0F) | (x << 4)


def _ulp_ratio(a, ref) -> float:
    """max |a - ref| / (B4_REL |ref| + B4_ABS): <= 1 is within one bf16
    ulp of the f32 reference."""
    return float(((a.float() - ref).abs()
                  / (B4_REL * ref.abs() + B4_ABS)).max())


def _stream_check(name: str, got, ref, controls: dict) -> float:
    """A weight-streaming kernel's output against its plain version in f32
    (one bf16 ulp), and each broken plain version at >= 4x the bound."""
    import torch

    err = float((got.float() - ref).abs().max())
    finite = bool(torch.isfinite(got.float()).all())
    _check(name, _ulp_ratio(got, ref) <= 1.0 and finite,
           f"max |d| {err:.2e}, max |d| / ({B4_REL:.2e} |ref| + "
           f"{B4_ABS:.0e}) {_ulp_ratio(got, ref):.3f} (bound 1), "
           f"finite={finite}")
    for what, broken in controls.items():
        r = _ulp_ratio(broken, ref)
        _check(f"{name} control, {what}", r >= 4.0,
               f"max |d| / bound {r:.1f} (must be >= 4)")
    return err


def _library_ms(what: str, call, ref):
    """Median ms of one PyTorch library call (a yardstick, used nowhere in
    the port), its distance from the plain version printed in bf16 ulps;
    None where it does not run on CUDA (the reason printed)."""
    import torch

    try:
        y = call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"  {what}: none, not on CUDA ({str(e).splitlines()[0][:160]})",
              flush=True)
        return None
    r = _ulp_ratio(y.reshape(ref.shape), ref)
    ms = _median_ms(call, 20)
    print(f"  {what}: {ms:.4f} ms, max |d| / bound {r:.3f} against the "
          f"plain version", flush=True)
    return ms


def _int8pack(q, scale):
    """B4's weight in ``torch._weight_int8pack_mm``'s layout (int8 (out,
    in), per-channel scales), converted once; the call takes bf16 x."""
    import torch

    qt, sc = q.t().contiguous(), scale.reshape(-1).contiguous()
    return lambda x2: torch._weight_int8pack_mm(x2, qt, sc)


def _int4pack(q4, scales):
    """B8's weight converted once to ``torch._weight_int4pack_mm``'s layout
    (each nibble + 8 as an unsigned nibble, the even input in the high
    nibble, zero points 0, each 512-row scale repeated over two groups of
    256, the largest group it takes), as a call on bf16 x; None where the
    conversion does not run on CUDA. The library call dequantizes each
    weight to bf16 before its product, so it rounds nibble x scale where B8
    does not."""
    import torch

    from video3d_tpu_torch.kernels import quant_matvec as qm

    try:
        u = (qm.unpack_int4(q4) + 8).to(torch.uint8).t().contiguous()
        w = torch._convert_weight_to_int4pack(
            ((u[:, 0::2] << 4) | u[:, 1::2]).contiguous(), 8)
        del u
        s = scales.repeat_interleave(2, dim=0)
        sz = torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous()
    except (RuntimeError, NotImplementedError) as e:
        print(f"  torch._convert_weight_to_int4pack: none, not on CUDA "
              f"({str(e).splitlines()[0][:160]})", flush=True)
        return None
    return lambda x2: torch._weight_int4pack_mm(x2, w, 256, sz)


def check_int8_matvec(dev):
    """B4 at the B=1 vocab head: x (1, 1, 3584) bf16 against the int8
    (3584, 152064) weight and its bf16 (1, 152064) scale, from N(0, 0.02)
    weights quantized by the port's ``quantize_weight``; the same bits on a
    second call; controls: the scale one column off, the last 1024 input
    rows dropped. Timed warm and with the L2 flushed (the 546 MB weight
    does not fit the L2, so both read HBM), beside B4's B>1 form on the
    same one-row head and B9b's read of the same weight (phase 3's probe
    rows, this run)."""
    import torch

    from video3d_tpu_torch.kernels import quant_matvec as qm
    from video3d_tpu_torch.models.quant import quantize_weight

    g = torch.Generator(device=dev).manual_seed(6)
    in_, out = 3584, 152064
    d = quantize_weight((0.02 * torch.randn(in_, out, generator=g,
                                             device=dev)).to(torch.bfloat16))
    q, scale = d["q"], d["scale"]
    x = torch.randn(1, 1, in_, generator=g, device=dev).to(torch.bfloat16)
    y = qm.int8_matvec(x, q, scale)
    ref = qm.int8_matmul_plain(x.float(), q, scale)
    name = f"B4 x {tuple(x.shape)} q {tuple(q.shape)}"
    err = _stream_check(name, y, ref, {
        "scale one column off": qm.int8_matmul_plain(
            x.float(), q, torch.roll(scale, 1, dims=1)),
        "last 1024 input rows dropped": qm.int8_matmul_plain(
            x[..., :-1024].float(), q[:-1024], scale)})
    _check_repeat(name, lambda: qm.int8_matvec(x, q, scale), y)
    ms, flushed = _kernel_ms(lambda: qm.int8_matvec(x, q, scale), 50)
    dequant_ms = _median_ms(lambda: (x @ q.to(x.dtype)) * scale, 10)
    print(f"  B4 {q.numel() / flushed / 1e6:.0f} GB/s of int8 weight "
          f"(flushed); the dequantize-then-matmul path {dequant_ms:.4f} ms",
          flush=True)
    # the same one-row head through B4's B>1 form (the one-row matvec's
    # rival; the matvec stays the head's route) and B9b's read of it
    _stream_check(f"B4 B>1 at the head x {tuple(x.shape)}",
                  qm.int8_matmul(x, q, scale), ref, {})
    stream_ms, stream_flushed = _kernel_ms(
        lambda: qm.int8_matmul(x, q, scale), 50)
    probe = "" if B9B_MS is None else (
        f"; B9b {B9B_MS[0]:.4f} / {B9B_MS[1]:.4f} (matvec flushed / B9b "
        f"flushed {flushed / B9B_MS[1]:.3f})")
    print(f"  the head, ms warm / L2 flushed: B4's matvec {ms:.4f} / "
          f"{flushed:.4f}, B4's B>1 form {stream_ms:.4f} / "
          f"{stream_flushed:.4f} (matvec / B>1 flushed "
          f"{flushed / stream_flushed:.3f}){probe}", flush=True)
    pack = _int8pack(q, scale)
    library_ms = _library_ms("torch._weight_int8pack_mm",
                             lambda: pack(x.reshape(1, in_)), ref)
    del pack
    # bytes: the int8 weight, its scale, x and y; 2 * in * out operations
    bound = _bound(2.0 * q.numel(), _nbytes(q, scale, x) + 2 * out)
    return err, ((ms, flushed),
                 _median_ms(lambda: qm.int8_matmul_plain(x, q, scale), 10)), \
        bound, library_ms


# Qwen2-7B's decode projections by distinct (in, out), and the vocab head:
# B4's B>1 form and B8 are checked and timed at each at STREAM_ROWS rows
STREAM_SHAPES = (("wq / wo", 3584, 3584), ("wk / wv", 3584, 512),
                 ("w_gate / w_up", 3584, 18944), ("w_down", 18944, 3584),
                 ("lm_head", 3584, 152064))
STREAM_ROWS = (1, 8, 32)


def _check_stream(dev, bits: int, report):
    """B4's B>1 form (bits 8) or B8 (bits 4) at every STREAM_SHAPES shape
    and STREAM_ROWS row count, from N(0, 0.02) weights quantized by the
    port's ``quantize_weight`` / ``quantize_weight_int4`` (int4: padded as
    the model pads them): within one bf16 ulp of the plain version in f32,
    bit for bit over two calls, each control at >= 4x the bound (int8: the
    scale one column off, the last 512 inputs dropped; int4: scales one
    group off, the nibbles swapped, the last group dropped). One line per
    case: kernel ms warm and with the L2 flushed (the small weights fit in
    the 50 MB L2; a decode step reads them from HBM), plain ms, library ms
    (``torch._weight_int8pack_mm`` / ``_weight_int4pack_mm``) and the
    bound. Returns the numbers of the ``report`` = (shape, rows) case."""
    import torch

    from video3d_tpu_torch.kernels import quant_matvec as qm
    from video3d_tpu_torch.models.quant import (quantize_weight,
                                                quantize_weight_int4)

    g = torch.Generator(device=dev).manual_seed(12 if bits == 8 else 13)
    label = "B4 B>1" if bits == 8 else "B8"
    result = None
    for what, in_, out in STREAM_SHAPES:
        w = (0.02 * torch.randn(in_, out, generator=g,
                                device=dev)).to(torch.bfloat16)
        if bits == 8:
            d = quantize_weight(w)
            q, scale = d["q"], d["scale"]
            del d

            def kernel(x):
                return qm.int8_matmul(x, q, scale)

            def plain(x, q=q, scale=scale):
                return qm.int8_matmul_plain(x, q, scale)

            def controls(xf):
                return {"scale one column off": plain(
                            xf, scale=torch.roll(scale, 1, dims=1)),
                        "last input chunk dropped": plain(
                            xf[..., :-512], q[:-512])}
            weight = (q, scale)
            pack = _int8pack(q, scale)
        else:
            w4 = quantize_weight_int4(w)
            q, scale = w4.q4, w4.scale4
            del w4
            swapped = _nibbles_swapped(q)

            def kernel(x):
                return qm.int4_matmul(x, q, scale)

            def plain(x, q=q, scale=scale):
                return qm.int4_matmul_plain(x, q, scale)

            def controls(xf):
                return {"scales one group off": plain(
                            xf, scale=torch.roll(scale, 1, dims=0)),
                        "nibbles swapped": plain(xf, swapped),
                        "last group dropped": plain(
                            xf[..., :-512], q[:-256], scale[:-1])}
            weight = (q, scale)
            pack = _int4pack(q, scale)
        del w
        in_p, out_p = 2 * q.shape[0] if bits == 4 else in_, q.shape[1]
        for B in STREAM_ROWS:
            x = torch.randn(B, 1, in_p, generator=g,
                            device=dev).to(torch.bfloat16)
            y = kernel(x)
            ref = plain(x.float())
            name = f"{label} {what} x {tuple(x.shape)} w {tuple(q.shape)}"
            err = _stream_check(name, y, ref, controls(x.float()))
            _check_repeat(name, lambda: kernel(x), y)
            library_ms = None if pack is None else _library_ms(
                f"{label} {what} B={B} library", lambda: pack(
                    x.reshape(B, in_p)), ref)
            del ref
            ms, flushed = _kernel_ms(lambda: kernel(x), 50)
            plain_ms = _median_ms(lambda: plain(x), 5)
            bound = _bound(2.0 * B * in_p * out_p,
                           _nbytes(*weight, x) + 2 * B * out_p)
            lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"  {label} {what} B={B}: kernel {ms:.4f} ms ({flushed:.4f} "
                  f"L2 flushed; {bound['bound_ms'] / ms:.0%} / "
                  f"{bound['bound_ms'] / flushed:.0%} of the bound), plain "
                  f"{plain_ms:.4f} ms, library {lib}, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})",
                  flush=True)
            if (what, B) == report:
                result = err, ((ms, flushed), plain_ms), bound, library_ms
        torch.cuda.empty_cache()
    return result


def check_int8_matmul(dev):
    """B4's B>1 form at the decode shapes (:func:`_check_stream`); reports
    w_gate at B=8."""
    return _check_stream(dev, 8, ("w_gate / w_up", 8))


def check_int4_matmul(dev):
    """B8 at the decode shapes (:func:`_check_stream`); reports the vocab
    head at B=1."""
    return _check_stream(dev, 4, ("lm_head", 1))


def check_decode_int8(dev, bits: int = 8):
    """B3 int8 (bits 4: int4) at B=1 and B=8 over layer 27 of a stacked
    quantized cache of 8704 slots with peaked queries; controls: the two
    scale controls and (int4) the nibbles of each byte swapped."""
    import torch

    from video3d_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(7 if bits == 8 else 17)
    NL, H, KV, hd, S = CACHE_LAYERS, 28, 4, 128, 8704
    layer = NL - 1
    worst, timed = 0.0, None
    for lens in ([6812], [8704, 6812, 300, 4097, 6000, 2048, 7777, 1]):
        B = len(lens)
        q = (Q_SCALE * torch.randn(B, 1, H, hd, generator=g,
                                   device=dev)).to(torch.bfloat16)
        k8, ks = _int8_cache(g, dev, (NL, B, S), KV, hd, bits=bits)
        v8, vs = _int8_cache(g, dev, (NL, B, S), KV, hd, v_scale=0.5,
                             bits=bits)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, k8, v8, kv_len, layer, KV, ks, vs)
        out = da.decode_attention(*args)
        qf = q.float()          # the plain version on the same values in f32
        ref = da.decode_attention_plain(qf, *args[1:])
        rows = [1] * B
        err = _rows_err(out, ref, rows)
        plain_err = _rows_err(da.decode_attention_plain(*args), ref, rows)
        name = f"B3 int{bits} B={B} kv_len={lens}"
        _check(name, err <= BF16_ATOL,
               f"max |d| {err:.2e} (the bf16 plain version: {plain_err:.2e})")
        _check_repeat(name, lambda: da.decode_attention(*args), out)
        controls = {
            "scales one position off": da.decode_attention_plain(
                qf, k8, v8, kv_len, layer, KV, torch.roll(ks, 1, dims=2),
                torch.roll(vs, 1, dims=2)),
            "scales of the wrong kv head": da.decode_attention_plain(
                qf, k8, v8, kv_len, layer, KV, torch.roll(ks, 1, dims=3),
                torch.roll(vs, 1, dims=3))}
        if bits == 4:
            controls["nibbles of each byte swapped"] = \
                da.decode_attention_plain(qf, _nibbles_swapped(k8),
                                          _nibbles_swapped(v8), kv_len,
                                          layer, KV, ks, vs)
        _check_controls(name, ref, rows, controls)
        worst = max(worst, err)
        if timed is None:
            timed = args
        del k8, v8, controls
    n = int(timed[3][0])
    row_bytes = timed[1].shape[-1] * timed[1].element_size()
    # the layer's first kv_len quantized keys and values and their f32
    # scales, the query and the output
    bound = _bound(_attn(n, H),
                   2 * n * (row_bytes + KV * 4) + 2 * _nbytes(timed[0]))
    _time_decode_b8(dev, f"int{bits}")
    return worst, (
        _kernel_ms(lambda: da.decode_attention(*timed), 50),
        _median_ms(lambda: da.decode_attention_plain(*timed), 10)
    ), bound, None


def check_folded_int8(dev, bits: int = 8):
    """B2 folded int8 (bits 4: int4) at the bf16 check's FOLDED_CASES,
    over a quantized stacked cache; controls: the two scale controls, the
    chunk's causal mask dropped and (int4) the nibbles of each byte
    swapped; each case called twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(8 if bits == 8 else 18)
    NL, H, KV, hd, S = CACHE_LAYERS, 28, 4, 128, 8224
    layer = NL - 1
    worst, timed = 0.0, None
    for L, offs, lens in FOLDED_CASES:
        B = len(offs)
        q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)

        def focus(i, x):       # the chunk's own keys, before quantization
            if i == layer:
                for b, (o, n) in enumerate(zip(offs, lens)):
                    x[b, o:n, :, 0] += FOCUS

        k8, ks = _int8_cache(g, dev, (NL, B, S), KV, hd, edit=focus,
                             bits=bits)
        v8, vs = _int8_cache(g, dev, (NL, B, S), KV, hd, v_scale=0.5,
                             bits=bits)
        offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, k8, v8, lens_t, offs_t, layer, KV, ks, vs)
        rows = [n - o for o, n in zip(offs, lens)]
        out = fa.flash_attention_gqa_folded(*args)
        qf = q.float()          # the plain version on the same values in f32
        ref = fa.flash_attention_gqa_folded_plain(qf, *args[1:])
        err = _rows_err(out, ref, rows)
        plain_err = _rows_err(fa.flash_attention_gqa_folded_plain(*args),
                              ref, rows)
        finite = bool(torch.isfinite(out.float()).all())
        name = (f"B2 folded int{bits} B={B} L={L} offsets={offs} "
                f"kv_len={lens}")
        _check(name, err <= BF16_ATOL and finite,
               f"max |d| {err:.2e} on rows below kv_len, finite={finite} "
               f"(the bf16 plain version: {plain_err:.2e})")
        _check_repeat(name, lambda: fa.flash_attention_gqa_folded(*args), out)
        controls = {
            "scales one position off": fa.flash_attention_gqa_folded_plain(
                qf, k8, v8, lens_t, offs_t, layer, KV,
                torch.roll(ks, 1, dims=2), torch.roll(vs, 1, dims=2)),
            "scales of the wrong kv head": fa.flash_attention_gqa_folded_plain(
                qf, k8, v8, lens_t, offs_t, layer, KV,
                torch.roll(ks, 1, dims=3), torch.roll(vs, 1, dims=3)),
            "no causal mask in the chunk": fa.flash_attention_gqa_folded_plain(
                qf, k8, v8, lens_t, lens_t - 1, layer, KV, ks, vs)}
        if bits == 4:
            controls["nibbles of each byte swapped"] = \
                fa.flash_attention_gqa_folded_plain(
                    qf, _nibbles_swapped(k8), _nibbles_swapped(v8), lens_t,
                    offs_t, layer, KV, ks, vs)
        _check_controls(name, ref, rows, controls)
        del controls
        worst = max(worst, err)
        if timed is None:
            timed = args
        if (L, offs, lens) == VERIFY_CASE:
            _time_verify(f"flash_attention_folded_int{bits}", args)
    return worst, (
        _kernel_ms(lambda: fa.flash_attention_gqa_folded(*timed), 50),
        _median_ms(lambda: fa.flash_attention_gqa_folded_plain(*timed), 10)
    ), _folded_bound(*timed), None


def check_shared_prefix_int8(dev, bits: int = 8):
    """B5 int8 (bits 4: int4) at the bf16 check's PREFIX_CASES (a
    quantized prefix with scales, raw bf16 suffixes); controls: the two
    scale controls, the suffix dropped and (int4) the nibbles of each byte
    swapped; each case called twice, bit for bit."""
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa
    from video3d_tpu_torch.kernels.attention import \
        mha_shared_prefix_reference

    g = torch.Generator(device=dev).manual_seed(9 if bits == 8 else 19)
    H, KV, hd, L = 28, 4, 128, 64
    worst, timed = 0.0, None
    for P, slens in PREFIX_CASES:
        B = len(slens)
        q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)
        pk8, pks = _int8_cache(g, dev, (1, P), KV, hd, bits=bits)
        pv8, pvs = _int8_cache(g, dev, (1, P), KV, hd, v_scale=0.5,
                               bits=bits)
        pk8, pks, pv8, pvs = (t[0].reshape(P, KV, -1)
                              for t in (pk8, pks, pv8, pvs))
        sk = torch.randn(B, L, KV, hd, generator=g, device=dev)
        sk[..., 0] += FOCUS
        sk = sk.to(torch.bfloat16)
        sv = (0.5 * torch.randn(B, L, KV, hd, generator=g,
                                device=dev)).to(torch.bfloat16)
        slens_t = torch.tensor(slens, dtype=torch.int32, device=dev)
        args = (q, pk8, pv8, sk, sv, slens_t, pks, pvs)
        out = fa.flash_attention_shared_prefix(*args)
        qf = q.float()          # the plain version on the same values in f32
        ref = mha_shared_prefix_reference(qf, *args[1:])
        err = _rows_err(out, ref, slens)
        plain_err = _rows_err(mha_shared_prefix_reference(*args), ref, slens)
        finite = bool(torch.isfinite(out.float()).all())
        name = f"B5 int{bits} B={B} L={L} P={P} suffix_lens={slens}"
        _check(name, err <= BF16_ATOL and finite,
               f"max |d| {err:.2e} on rows below suffix_lens, "
               f"finite={finite} (the bf16 plain version: {plain_err:.2e})")
        _check_repeat(name, lambda: fa.flash_attention_shared_prefix(*args),
                      out)
        controls = {
            "scales one position off": mha_shared_prefix_reference(
                qf, pk8, pv8, sk, sv, slens_t, torch.roll(pks, 1, dims=0),
                torch.roll(pvs, 1, dims=0)),
            "scales of the wrong kv head": mha_shared_prefix_reference(
                qf, pk8, pv8, sk, sv, slens_t, torch.roll(pks, 1, dims=1),
                torch.roll(pvs, 1, dims=1)),
            "suffix dropped": mha_shared_prefix_reference(
                qf, pk8, pv8, sk, sv, torch.zeros_like(slens_t), pks, pvs)}
        if bits == 4:
            controls["nibbles of each byte swapped"] = \
                mha_shared_prefix_reference(
                    qf, _nibbles_swapped(pk8), _nibbles_swapped(pv8), sk, sv,
                    slens_t, pks, pvs)
        _check_controls(name, ref, slens, controls)
        del controls
        worst = max(worst, err)
        if timed is None:
            timed = args
    return worst, (
        _kernel_ms(lambda: fa.flash_attention_shared_prefix(*timed), 20),
        _median_ms(lambda: mha_shared_prefix_reference(*timed), 5)
    ), _prefix_bound(*timed), None


# B7's checks at the paged batcher's serving shapes: 8 slots of Qwen2-7B
# heads over 28-layer pools of 128-token pages, the last layer read by
# strides; every slot aliases the same 52 scene-prefix pages (~6.7k tokens)
# and owns a few private pages after them, so the live (slot, page) pairs
# (~380) outnumber the pool (85 pages); one slot has kv_len 0 and one ends
# mid-page. The last 16 keys of every slot carry most of the weight.
PAGED_SLOTS, PAGED_PAGE, PAGED_PREFIX_PAGES, PAGED_MAXP = 8, 128, 52, 56
PAGED_LENS = [6780, 6801, 0, 6750, 6912, 6790, 6760, 6845]


def _paged_inputs(g, dev, form: str, lens=PAGED_LENS,
                  prefix_pages: int = PAGED_PREFIX_PAGES,
                  maxp: int = PAGED_MAXP, own=None, NL: int = CACHE_LAYERS,
                  heads=(28, 4), hd: int = 128):
    """q, stacked pools (bf16, or int8 / packed int4 with (NL, P, KV, 1,
    page) scales), table and lengths of the B7 check: one slot per entry of
    ``lens``, every slot aliasing the same ``prefix_pages`` pages, then
    ``own[b]`` pages of its own (default: the rest of its ``maxp``), all
    in order of slot; ``heads`` (query heads, kv heads) of width ``hd``
    over NL layers."""
    import torch

    from video3d_tpu_torch.models.qwen2 import quantize_rows

    H, KV = heads
    page, S = PAGED_PAGE, len(lens)
    own = own or [maxp - prefix_pages] * S
    P = 1 + prefix_pages + sum(own)
    table = torch.zeros((S, maxp), dtype=torch.int32)
    table[:, :prefix_pages] = torch.arange(1, 1 + prefix_pages)
    first = 1 + prefix_pages
    for b, n in enumerate(own):
        table[b, prefix_pages:prefix_pages + n] = torch.arange(first,
                                                               first + n)
        first += n
    focus = [(int(table[b, s // page]), s % page)
             for b, n in enumerate(lens)
             for s in range(max(n - 16, 0), n)]
    pid = torch.tensor([f[0] for f in focus], device=dev)
    off = torch.tensor([f[1] for f in focus], device=dev)
    shape = (P, page, KV, hd)
    storage = {"bf16": torch.bfloat16, "int8": torch.int8,
               "int4": torch.uint8}[form]
    width = KV * hd // (2 if form == "int4" else 1)
    k = torch.empty((NL, P, page, width), device=dev, dtype=storage)
    v = torch.empty_like(k)
    ks = vs = None
    if form != "bf16":
        ks = torch.empty((NL, P, KV, 1, page), device=dev)
        vs = torch.empty_like(ks)
    for layer in range(NL):             # one layer at a time: temporaries
        kl = torch.randn(shape, generator=g, device=dev)
        vl = 0.5 * torch.randn(shape, generator=g, device=dev)
        if layer == NL - 1:
            kl[pid, off, :, 0] += FOCUS
        for dst, sdst, x in ((k, ks, kl), (v, vs, vl)):
            if form != "bf16":
                dst[layer], xs = quantize_rows(x.to(torch.bfloat16), storage)
                sdst[layer] = xs.permute(0, 2, 3, 1)
            else:
                dst[layer] = x.reshape(P, page, KV * hd)
    q = Q_SCALE * torch.randn(S, 1, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    return (q.to(torch.bfloat16), k, v, table.to(dev), kv_len, NL - 1, KV,
            ks, vs)


def _paged_unique(lens) -> int:
    """Positions of B7's serving shape read from DRAM: the shared prefix
    pages once, each slot's positions past them once."""
    shared = PAGED_PREFIX_PAGES * PAGED_PAGE
    return shared + sum(max(n - shared, 0) for n in lens)


def _paged_bound(q, k, v, table, kv_len, layer, KV, ks=None, vs=None):
    """The least HBM traffic: the shared prefix pages once, each slot's
    positions past them once (values and, quantized, scales), q, the
    output, the table and the lengths; 4 * hd FLOPs per (head, key)
    pair."""
    H, hd = q.shape[2], q.shape[3]
    lens = kv_len.tolist()
    unique = _paged_unique(lens)
    per_pos = 2 * k.shape[-1] * k.element_size() + (
        2 * KV * 4 if ks is not None else 0)
    return _bound(_attn(sum(lens), H, hd),
                  unique * per_pos + 2 * _nbytes(q) + _nbytes(table, kv_len))


def _print_paged_bytes(bound: dict, k, KV: int, ks=None) -> None:
    """B7's bound in DRAM bytes (the aliased prefix pages once) beside its
    logical bytes (every slot's positions)."""
    per = 2 * k.shape[-1] * k.element_size() + (2 * KV * 4 if ks is not None
                                                 else 0)
    logical = sum(PAGED_LENS) * per + bound["bytes"] - _paged_unique(
        PAGED_LENS) * per
    print(f"  B7 bound counts the {PAGED_PREFIX_PAGES} aliased prefix pages "
          f"once ({PAGED_PREFIX_PAGES * PAGED_PAGE} positions): DRAM bytes "
          f"{bound['bytes'] / 1e6:.2f} MB; logical bytes, every slot's "
          f"positions, {logical / 1e6:.2f} MB (the rest from the L2)",
          flush=True)


def check_paged(dev, form: str = "bf16"):
    """B7 (bf16, int8 or int4 pools) at the serving shapes against its
    plain version in f32 on the same values; controls: one page-table
    entry pointed at another slot's page, kv_len one short, (quantized) the
    scales of the wrong kv head and (int4) the nibbles of each byte
    swapped."""
    import torch

    from video3d_tpu_torch.kernels import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(
        {"bf16": 10, "int8": 11, "int4": 21}[form])
    args = _paged_inputs(g, dev, form)
    q, k, v, table, kv_len, layer, KV, ks, vs = args
    live = sum(-(-n // PAGED_PAGE) for n in PAGED_LENS)
    name = (f"B7 {form} S={q.shape[0]} kv_len={PAGED_LENS} ({live} live "
            f"pages over a pool of {k.shape[1]})")
    out = pa.paged_decode_attention(*args)
    qf = q.float()          # the plain version on the same values in f32
    ref = pa.paged_attention_plain(qf, *args[1:])
    rows = [1] * q.shape[0]
    err = _rows_err(out, ref, rows)
    plain_err = _rows_err(pa.paged_attention_plain(*args), ref, rows)
    finite = bool(torch.isfinite(out.float()).all())
    zero = bool((out[PAGED_LENS.index(0)] == 0).all())
    _check(name, err <= BF16_ATOL and finite and zero,
           f"max |d| {err:.2e}, finite={finite}, kv_len 0 slot zero={zero} "
           f"(the bf16 plain version: {plain_err:.2e})")
    _check_repeat(name, lambda: pa.paged_decode_attention(*args), out)
    wrong_page = table.clone()
    last = (PAGED_LENS[0] - 1) // PAGED_PAGE
    wrong_page[0, last] = table[1, last]
    controls = {
        "a table entry pointed at another slot's page":
            pa.paged_attention_plain(qf, k, v, wrong_page, kv_len, layer, KV,
                                     ks, vs),
        "kv_len one short": pa.paged_attention_plain(
            qf, k, v, table, (kv_len - 1).clamp(min=0), layer, KV, ks, vs)}
    if form != "bf16":
        controls["scales of the wrong kv head"] = pa.paged_attention_plain(
            qf, k, v, table, kv_len, layer, KV, torch.roll(ks, 1, dims=2),
            torch.roll(vs, 1, dims=2))
    if form == "int4":
        controls["nibbles of each byte swapped"] = pa.paged_attention_plain(
            qf, _nibbles_swapped(k), _nibbles_swapped(v), table, kv_len,
            layer, KV, ks, vs)
    _check_controls(name, ref, rows, controls)
    del controls
    bound = _paged_bound(*args)
    _print_paged_bytes(bound, k, KV, ks)
    return err, (
        _kernel_ms(lambda: pa.paged_decode_attention(*args), 50),
        _median_ms(lambda: pa.paged_attention_plain(*args), 5)
    ), bound, None


# phase 11's 32k int8 shapes, held in phase 3 (not timed): ctx32k's
# 4096-query chunks of B2 folded over a 32768-slot cache, at the first and
# the last offset (keys valid to 32768, the causal mask alone bounds a
# chunk); B3 at the dense B=1 row's kv_len; B7 over the paged row's
# 1 x 32k + 7 x 512 mix (pages for len + 16 positions, at most 256: the
# benchmark's 292-page pool). The plain version of a 4096-query chunk runs on its first
# and last LONG_ROWS queries (its scores: 28 x 512 x 32768 f32, 1.9 GB).
LONG_S, LONG_CHUNK, LONG_ROWS = 32768, 4096, 512
LONG_DECODE_LEN = 32760
LONG_PAGED_LENS = [32760, 520, 513, 527, 512, 521, 515, 524]


def check_long_context_int8(dev) -> None:
    """B2 folded int8, B3 int8 and B7 int8 at phase 11's 32k shapes
    against their plain versions in f32 on the same values, with the
    controls of phase 3's checks at the same bound."""
    import torch

    from video3d_tpu_torch.kernels import decode_attention as da
    from video3d_tpu_torch.kernels import flash_attention as fa
    from video3d_tpu_torch.kernels import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(40)
    NL, H, KV, hd, S, L = CACHE_LAYERS, 28, 4, 128, LONG_S, LONG_CHUNK
    layer = NL - 1
    offsets = (0, S - L)

    def focus(i, x):           # each checked chunk's own keys
        if i == layer:
            for o in offsets:
                x[0, o:o + L, :, 0] += FOCUS

    k8, ks = _int8_cache(g, dev, (NL, 1, S), KV, hd, edit=focus)
    v8, vs = _int8_cache(g, dev, (NL, 1, S), KV, hd, v_scale=0.5)
    lens_t = torch.tensor([S], dtype=torch.int32, device=dev)
    for off in offsets:
        q = Q_SCALE * torch.randn(1, L, H, hd, generator=g, device=dev)
        q[..., 0] += FOCUS
        q = q.to(torch.bfloat16)
        offs_t = torch.tensor([off], dtype=torch.int32, device=dev)
        out = fa.flash_attention_gqa_folded(q, k8, v8, lens_t, offs_t,
                                            layer, KV, ks, vs)
        finite = bool(torch.isfinite(out.float()).all())
        for first in (0, L - LONG_ROWS):
            rows = slice(first, first + LONG_ROWS)
            qf = q[:, rows].float()
            o_t = offs_t + first

            def plain(o=o_t, kk=ks, vv=vs):
                return fa.flash_attention_gqa_folded_plain(
                    qf, k8, v8, lens_t, o, layer, KV, kk, vv)

            ref = plain()
            err = _rows_err(out[:, rows], ref, [LONG_ROWS])
            name = (f"B2 folded int8 L={L} offset={off} kv_len={S} of "
                    f"({NL}, 1, {S}, 512), queries {first}-"
                    f"{first + LONG_ROWS - 1}")
            _check(name, err <= BF16_ATOL and finite,
                   f"max |d| {err:.2e}, finite={finite}")
            _check_controls(name, ref, [LONG_ROWS], {
                "scales one position off": plain(
                    kk=torch.roll(ks, 1, dims=2),
                    vv=torch.roll(vs, 1, dims=2)),
                "scales of the wrong kv head": plain(
                    kk=torch.roll(ks, 1, dims=3),
                    vv=torch.roll(vs, 1, dims=3)),
                "no causal mask in the chunk": plain(o=lens_t - 1)})
            del ref
        del out, q
    torch.cuda.empty_cache()
    q = (Q_SCALE * torch.randn(1, 1, H, hd, generator=g,
                               device=dev)).to(torch.bfloat16)
    kv_len = torch.tensor([LONG_DECODE_LEN], dtype=torch.int32, device=dev)
    out = da.decode_attention(q, k8, v8, kv_len, layer, KV, ks, vs)
    qf = q.float()
    ref = da.decode_attention_plain(qf, k8, v8, kv_len, layer, KV, ks, vs)
    err = _rows_err(out, ref, [1])
    name = f"B3 int8 B=1 kv_len={LONG_DECODE_LEN} of S={S}"
    _check(name, err <= BF16_ATOL, f"max |d| {err:.2e}")
    _check_repeat(name, lambda: da.decode_attention(q, k8, v8, kv_len, layer,
                                                    KV, ks, vs), out)
    _timed_row(name, lambda: da.decode_attention(q, k8, v8, kv_len, layer,
                                                 KV, ks, vs),
               LONG_DECODE_LEN * 2 * (k8.shape[-1] + KV * 4) + 2 * _nbytes(q))
    _check_controls(name, ref, [1], {
        "scales one position off": da.decode_attention_plain(
            qf, k8, v8, kv_len, layer, KV, torch.roll(ks, 1, dims=2),
            torch.roll(vs, 1, dims=2)),
        "scales of the wrong kv head": da.decode_attention_plain(
            qf, k8, v8, kv_len, layer, KV, torch.roll(ks, 1, dims=3),
            torch.roll(vs, 1, dims=3))})
    del k8, v8, ks, vs
    torch.cuda.empty_cache()
    lens = LONG_PAGED_LENS
    own = [min(S // PAGED_PAGE, -(-(n + 16) // PAGED_PAGE)) for n in lens]
    args = _paged_inputs(g, dev, "int8", lens=lens, prefix_pages=0,
                         maxp=S // PAGED_PAGE, own=own)
    q, k, v, table, kv_len, layer, KV, ks, vs = args
    out = pa.paged_decode_attention(*args)
    qf = q.float()
    ref = pa.paged_attention_plain(qf, *args[1:])
    err = _rows_err(out, ref, [1] * len(lens))
    name = (f"B7 int8 S={len(lens)} kv_len={lens} ({sum(own)} pages of "
            f"{PAGED_PAGE})")
    _check(name, err <= BF16_ATOL and bool(torch.isfinite(out.float()).all()),
           f"max |d| {err:.2e}")
    _check_repeat(name, lambda: pa.paged_decode_attention(*args), out)
    _timed_row(f"B7 int8 1 x {lens[0]} + 7 x ~520 (no shared pages)",
               lambda: pa.paged_decode_attention(*args),
               sum(lens) * 2 * (k.shape[-1] + KV * 4) + 2 * _nbytes(q)
               + _nbytes(table, kv_len))
    wrong_page = table.clone()
    wrong_page[0, (lens[0] - 1) // PAGED_PAGE] = table[1, 0]
    _check_controls(name, ref, [1] * len(lens), {
        "a table entry pointed at another slot's page":
            pa.paged_attention_plain(qf, k, v, wrong_page, kv_len, layer, KV,
                                     ks, vs),
        "kv_len one short": pa.paged_attention_plain(
            qf, k, v, table, kv_len - 1, layer, KV, ks, vs),
        "scales of the wrong kv head": pa.paged_attention_plain(
            qf, k, v, table, kv_len, layer, KV, torch.roll(ks, 1, dims=2),
            torch.roll(vs, 1, dims=2))})
    del args, q, k, v, ks, vs
    torch.cuda.empty_cache()


def check_stream_probes(dev):
    """B9 at the probe scripts' default shapes, through the probe CLI's
    functions with their checks (``bench/probes.py``, ``--check``): every
    row and checksum equal to the plain version's, and each control
    caught; int8 K and V (32768, 4, 128) in blocks of 4096, 8192 and 16384
    tokens; the (3584, 152064) vocab-head weight in 1536-column blocks,
    int8 and bf16; K = 1-4 such int8 weights strided, K = 4 as contiguous
    slabs; K = 1-4 streams over one weight. Returns the kernel rows (bs
    4096, int8, K = 4 strided, K = 4 split) and the measured read ceiling
    (GB/s, the best L2-flushed rate)."""
    import torch

    from video3d_tpu_torch.bench import probes

    runs = {"stream_probe_kv": (probes.probe_kv(dev, iters=20, check=True),
                                0),
            "stream_probe_one": (
                probes.probe_matvec(dev, iters=20, check=True)
                + probes.probe_matvec(dev, "bfloat16", iters=20, check=True),
                0)}
    torch.cuda.empty_cache()
    runs["stream_probe_multi"] = (
        probes.probe_stream(dev, iters=20, check=True)
        + probes.probe_stream(dev, ks=(4,), contig=True, iters=20,
                              check=True), 3)
    torch.cuda.empty_cache()
    runs["stream_probe_split"] = (
        probes.probe_stream(dev, iters=20, split_same=True, check=True), 3)
    torch.cuda.empty_cache()
    rows, rates = {}, []
    for name, (lines, kernel_row) in runs.items():
        for line in lines:
            for what, caught in line["caught"].items():
                _check(f"B9 {line['probe']} control, {what}", caught > 0,
                       f"{caught} rows and checksums differ (must be > 0)")
            rates.append(line["gbps"])
        r = lines[kernel_row]
        rows[name] = {"max_abs_err": r["max_abs_err"], "ms": r["ms_warm"],
                      "ms_l2_flushed": r["ms"], "plain_ms": r["plain_ms"],
                      **_bound(0.0, r["io_bytes"]),
                      "library_ms": r["library_ms"]}
        print(f"  {name}: the kernels line reads '{r['probe']}'",
              flush=True)
    ceiling = max(rates)
    print(f"measured read ceiling: {ceiling:.0f} GB/s (best L2-flushed B9 "
          f"rate; data sheet {H100_HBM_BYTES / 1e9:.0f} GB/s)", flush=True)
    return rows, ceiling


def check_kernels():
    import torch

    dev = torch.device("cuda", 0)
    global READ_CEILING_GBPS, B9B_MS
    print("stream probes (B9):", flush=True)
    rows, ceiling = check_stream_probes(dev)
    READ_CEILING_GBPS = ceiling
    B9B_MS = (rows["stream_probe_one"]["ms"],
              rows["stream_probe_one"]["ms_l2_flushed"])
    torch.cuda.empty_cache()
    for name, fn in (("fused_geometry", check_geometry),
                     ("flash_attention", check_flash),
                     ("flash_attention_folded", check_folded),
                     ("decode_attention", check_decode),
                     ("shared_prefix_attention", check_shared_prefix),
                     ("int8_matvec", check_int8_matvec),
                     ("decode_attention_int8", check_decode_int8),
                     ("flash_attention_folded_int8", check_folded_int8),
                     ("shared_prefix_attention_int8",
                      check_shared_prefix_int8),
                     ("paged_attention", check_paged),
                     ("paged_attention_int8",
                      lambda d: check_paged(d, "int8")),
                     ("int8_matmul", check_int8_matmul),
                     ("int4_matmul", check_int4_matmul),
                     ("decode_attention_int4",
                      lambda d: check_decode_int8(d, bits=4)),
                     ("flash_attention_folded_int4",
                      lambda d: check_folded_int8(d, bits=4)),
                     ("shared_prefix_attention_int4",
                      lambda d: check_shared_prefix_int8(d, bits=4)),
                     ("paged_attention_int4",
                      lambda d: check_paged(d, "int4")),
                     ("flash_attention_hd256", check_flash_hd256),
                     ("flash_attention_folded_hd256", check_folded_hd256),
                     ("decode_attention_hd256", check_decode_hd256),
                     ("paged_attention_hd256", check_paged_hd256),
                     ("shared_prefix_attention_hd256",
                      check_shared_prefix_hd256),
                     *((f"{form}_hd256_int{bits}",
                        lambda d, c=check, b=bits: c(d, b))
                       for bits in (8, 4)
                       for form, check in (
                           ("flash_attention_folded",
                            check_folded_hd256_quant),
                           ("decode_attention", check_decode_hd256_quant),
                           ("paged_attention", check_paged_hd256_quant),
                           ("shared_prefix_attention",
                            check_shared_prefix_hd256_quant)))):
        print(f"{name}:", flush=True)
        err, (ms, plain_ms), bound, library_ms = fn(dev)
        flushed = None
        if isinstance(ms, tuple):
            ms, flushed = ms
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        fl = "" if flushed is None else f" ({flushed:.4f} ms L2 flushed)"
        print(f"  {name}: kernel {ms:.4f} ms{fl}, plain {plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), one "
              f"PyTorch call {lib}", flush=True)
        if bound["bound_by"] == "bytes":
            at_ceiling = bound["bytes"] / ceiling / 1e6
            print(f"  {name}: its bytes at the measured ceiling "
                  f"{at_ceiling:.4f} ms (kernel {ms / at_ceiling:.1f}x"
                  + ("" if flushed is None
                     else f", flushed {flushed / at_ceiling:.1f}x") + ")",
                  flush=True)
        rows[name] = {"max_abs_err": err, "ms": ms, "ms_l2_flushed": flushed,
                      "plain_ms": plain_ms, **bound, "library_ms": library_ms}
        if name in VERIFY_ROWS:
            rows[name]["verify_shape"] = VERIFY_ROWS[name]
        torch.cuda.empty_cache()
    print("the int8 kernels at phase 11's 32k shapes (B3 and B7 also "
          "timed):", flush=True)
    check_long_context_int8(dev)
    rows.update(check_training_kernels(dev))
    rows.update(check_training_kernels_hd256(dev))
    return rows, ceiling


def _train_inputs(g, dev, B: int, L: int, H: int, KV: int, hd: int):
    """q (peaked), k, v and dO of a training attention case, bf16."""
    import torch

    q = (Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
         ).to(torch.bfloat16)
    k = torch.randn(B, L, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    v = (0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)
         ).to(torch.bfloat16)
    do = torch.randn(B, L, H, hd, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, do


def _check_training_case(label: str, q, k, v, do, lengths,
                         reproducible: tuple = ()):
    """B2 with the logsumexp and B6 on one case against their plain
    versions in float32 on the same bf16 values: the output equal to the
    inference instantiation's bit for bit, the output within BF16_ATOL on
    the rows below each length, the lse within LSE_ATOL, each gradient
    within B6_REL of its largest value; controls, each required to miss
    by 4x: the lse with the causal mask dropped; dK/dV of one query head
    per group (no group sum; G > 1), delta left out, the causal mask
    dropped. ``reproducible`` (names of dq, dk, dv): a second B6 call
    gives the same bits for these, the others within B6_REL of the first
    call's largest value. Returns (out, lse, grads, plain grads, output
    err, lse err)."""
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa

    B, L, H, hd = q.shape
    KV = k.shape[2]
    name = f"{label} B={B} L={L} H={H} KV={KV} lengths={lengths}"
    lens = torch.tensor(lengths, dtype=torch.int32, device=q.device)
    out, lse = fa.flash_attention_fwd(q, k, v, lens)
    _check(f"B2 with lse {name}: output == the inference instantiation's",
           torch.equal(out, fa.flash_attention(q, k, v, lengths=lens)),
           "bit for bit")
    qf, kf, vf = q.float(), k.float(), v.float()
    ref_out, ref_lse = fa.flash_attention_fwd_plain(qf, kf, vf, lens)
    err = _rows_err(out, ref_out, lengths)
    lse_err = float((lse - ref_lse).abs().max())
    _check(f"B2 with lse {name}", err <= BF16_ATOL and lse_err <= LSE_ATOL,
           f"output max |d| {err:.2e} on rows < length (bound "
           f"{BF16_ATOL:.0e}), lse max |d| {lse_err:.2e} (bound "
           f"{LSE_ATOL:.0e})")
    _, broken = fa.flash_attention_fwd_plain(qf, kf, vf, lens, causal=False)
    control = float((broken - ref_lse).abs().max())
    _check(f"B2 with lse {name} control, no causal mask",
           control >= 4 * LSE_ATOL,
           f"lse max |d| {control:.2e} (must be >= {4 * LSE_ATOL:.0e})")
    del ref_out, broken

    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, lens)
    of, dof = out.float(), do.float()
    ref = fa.flash_attention_bwd_plain(qf, kf, vf, of, lse, dof, lens)
    for what, got, want in zip(("dq", "dk", "dv"), grads, ref):
        rel = _rel_err(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        _check(f"B6 {name} {what}", rel <= B6_REL and finite,
               f"max |d| / max |ref| {rel:.2e} (bound {B6_REL:.0e}), "
               f"finite={finite}")
    if reproducible:
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, lens)
        for what, a, b in zip(("dq", "dk", "dv"), grads, again):
            if what in reproducible:
                _check(f"B6 {name}: a second call's {what}",
                       torch.equal(a, b), "the same bits")
            else:
                rel = _rel_err(b, a)
                _check(f"B6 {name}: a second call's {what}", rel <= B6_REL,
                       f"max |d| / max |first| {rel:.2e} (bound "
                       f"{B6_REL:.0e}; reduce-adds in another order)")
        del again
    G = H // KV
    controls = {
        "delta left out": (
            fa.flash_attention_bwd_plain(qf, kf, vf, torch.zeros_like(of),
                                         lse, dof, lens), (0, 1)),
        "no causal mask": (
            fa.flash_attention_bwd_plain(qf, kf, vf, of, lse, dof, lens,
                                         causal=False), (0, 1, 2))}
    if G > 1:
        controls["dK/dV of one q head per group"] = (
            fa.flash_attention_bwd_plain(qf[:, :, ::G], kf, vf,
                                         of[:, :, ::G], lse[:, ::G],
                                         dof[:, :, ::G], lens), (1, 2))
    for what, (broken, which) in controls.items():
        c = max(_rel_err(broken[i], ref[i]) for i in which)
        _check(f"B6 {name} control, {what}", c >= 4 * B6_REL,
               f"max |d| / max |ref| {c:.2e} (must be >= {4 * B6_REL:.0e})")
    return out, lse, grads, ref, err, lse_err


def _time_training_forms(names, q, k, v, do, lengths, out, lse, grads,
                         ref) -> dict:
    """Phase 3's rows of B2 with the lse and B6 (``names``) at one shape:
    kernel ms warm and L2 flushed, the plain versions' ms, the bound over
    the (query, key) pairs the mask allows on all L rows (2 products
    forward; S^T, dP^T, dV, dK and dQ backward), and the yardstick, one
    SDPA call: its forward, and its backward alone through autograd,
    causal, the kv heads repeated outside the timing; on the valid rows
    and on all L."""
    import torch
    import torch.nn.functional as F

    from video3d_tpu_torch.kernels import flash_attention as fa

    B, L, H, hd = q.shape
    n = lengths[0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=q.device)
    pairs = _causal_pairs(L, lengths)
    fwd, bwd = names
    rows = {
        fwd: dict(
            ms=_kernel_ms(lambda: fa.flash_attention_fwd(q, k, v, lens), 10),
            plain_ms=_median_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, lens), 3),
            **_bound(_attn(pairs, H, hd), _nbytes(q, k, v, out, lse))),
        bwd: dict(
            max_abs_err=max(float((a.float() - b).abs().max())
                            for a, b in zip(grads, ref)),
            ms=_kernel_ms(lambda: fa.flash_attention_bwd(
                q, k, v, out, lse, do, lens), 10),
            plain_ms=_median_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, do, lens), 3),
            **_bound(_attn(pairs, H, hd, products=5),
                     _nbytes(q, k, v, out, do, lse, *grads)))}
    for r in rows.values():
        r["ms"], r["ms_l2_flushed"] = r["ms"]
    for rows_used, key in ((n, "library_ms"), (L, "library_ms_all_rows")):
        qh, kh, vh = (_heads_first(x[:, :rows_used], H).requires_grad_(True)
                      for x in (q, k, v))
        doh = do[:, :rows_used].transpose(1, 2).contiguous()
        with torch.no_grad():
            rows[fwd][key] = _sdpa_ms(qh, kh, vh, 10, is_causal=True)
        sout = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        rows[bwd][key] = _median_ms(
            lambda: torch.autograd.grad(sout, (qh, kh, vh), doh,
                                        retain_graph=True), 10)
        del sout, qh, kh, vh, doh
    for name, r in rows.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms ({r['ms_l2_flushed']:.4f} "
              f"ms L2 flushed), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), SDPA "
              f"{'forward' if name == fwd else 'backward'} "
              f"{r['library_ms']:.4f} ms on the {n} valid rows, "
              f"{r['library_ms_all_rows']:.4f} ms causal on all {L}",
              flush=True)
    print(f"  SDPA forward + backward "
          f"{sum(r['library_ms'] for r in rows.values()):.4f} ms "
          f"({sum(r['library_ms_all_rows'] for r in rows.values()):.4f} on "
          f"all rows) against B2 with lse + B6 "
          f"{sum(r['ms'] for r in rows.values()):.4f} ms", flush=True)
    return rows


def check_training_kernels(dev) -> dict:
    """B2 with the logsumexp and B6 at the training shapes (B=1, L=S=8192,
    length 6780, H=28, KV=4, hd=128, causal), each against its plain
    version in float32 on the same bf16 values, with the controls of
    :func:`_check_training_case`; then timed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(10)
    B, L, H, KV, n = TRAIN_ATTENTION
    q, k, v, do = _train_inputs(g, dev, B, L, H, KV, 128)
    print("flash_attention_lse and flash_attention_bwd (B6):", flush=True)
    out, lse, grads, ref, err, lse_err = _check_training_case(
        "hd128", q, k, v, do, [n])
    rows = _time_training_forms(TRAIN_KERNELS[:2], q, k, v, do, [n], out,
                                lse, grads, ref)
    rows[TRAIN_KERNELS[0]]["max_abs_err"] = max(err, lse_err)
    torch.cuda.empty_cache()
    return rows


def check_training_kernels_hd256(dev) -> dict:
    """The hd-256 forms of B2 with the logsumexp and of B6 at Gemma-2B's
    heads (B=1, L=S=8192, length 6780, H=8, KV=1, causal), then the edge
    cases of TRAIN_EDGES_HD256 (lengths 1, 63, 64 and 65, L = 129, groups
    of 8, 2 and 1), each against its plain version in float32 with the
    controls of :func:`_check_training_case`; B6's dK and dV
    bit-reproducible on the main case (its splits' partials are summed in
    a fixed order), dQ within B6_REL (reduce-adds); then the main case
    timed."""
    import torch

    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels import _launch

    g = torch.Generator(device=dev).manual_seed(26)
    print("flash_attention_lse_hd256 and flash_attention_bwd_hd256 (B6 at "
          "hd 256):", flush=True)
    worst = (0.0, 0.0)
    for B, L, H, KV, lengths in TRAIN_EDGES_HD256:
        plan = h256.bwd_hd256_plan(B, L, H, KV, True, _launch.sm_count(0))
        case = _train_inputs(g, dev, B, L, H, KV, 256)
        *_, err, lse_err = _check_training_case(
            f"hd256 (B6: {plan.splits} head split"
            f"{'s' * (plan.splits > 1)})", *case, lengths)
        worst = (max(worst[0], err), max(worst[1], lse_err))
        del case
    B, L, H, KV, n = TRAIN_ATTENTION_HD256
    q, k, v, do = _train_inputs(g, dev, B, L, H, KV, 256)
    out, lse, grads, ref, err, lse_err = _check_training_case(
        "hd256", q, k, v, do, [n], reproducible=("dk", "dv"))
    rows = _time_training_forms(TRAIN_KERNELS[2:], q, k, v, do, [n], out,
                                lse, grads, ref)
    rows[TRAIN_KERNELS[2]]["max_abs_err"] = max(err, lse_err, *worst)
    torch.cuda.empty_cache()
    return rows


def _rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max()) \
        / float(b.float().abs().max())


SCANQA_TEXTS = ("What color is the chair next to the desk?",
                "How many pillows are on the bed?")
PREFIX_TEXTS = (
    "Where is the lamp?", "What is on the table?", "Is the door open?",
    "What is left of the sofa?", "How many chairs are there?",
    "What is above the sink?", "Where is the trash can?",
    "What color is the rug?", "What is behind the monitor?",
    "How many windows are in the room?",
    "What is next to the refrigerator?", "Where is the backpack?",
    "What shape is the table?", "What is under the desk?",
    "Which side of the bed is the nightstand on?",
    "What is hanging on the wall?", "Is the blanket folded?")


def _questions(video_id: str, texts, tag: str):
    return [{
        "id": f"{tag}{i}",
        "video": video_id,
        "conversations": [
            {"from": "human", "value": f"<image>\n{text}"},
            {"from": "gpt", "value": "a brown wooden chair"},
        ],
        "metadata": {"dataset": "scanqa", "question_type": "what"},
    } for i, text in enumerate(texts)]


def _make_engine(params, cfg, root: str, frames: int = 32, **ecfg):
    """An InferenceEngine on the synthetic scene (``frames`` frames a
    question) that keeps every GenerateResult, the first-step logits of
    each decode-state request and every grounding result, so a run can be
    checked."""
    import torch

    from fixtures import FakeTokenizer

    from video3d_tpu_torch.config import DataConfig
    from video3d_tpu_torch.eval.drivers import (EngineConfig, InferenceEngine,
                                                VideoProcessor)

    class RecordingEngine(InferenceEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.results = []
            self.first_logits = []
            self.grounded = []        # (compacted scores, objects) per query
            self.decoded = []         # the id lists decoded to text

        def _decode_text(self, toks):
            self.decoded.append([int(t) for t in toks])
            return super()._decode_text(toks)

        def _generate(self, batch, vision_features=None, cfg=None):
            res = super()._generate(batch, vision_features, cfg)
            self.results.append(res)
            return res

        def _generate_from_state(self, state):
            self.first_logits.append(state.next_logits.float().clone())
            res = super()._generate_from_state(state)
            self.results.append(res)
            return res

        def ground(self, record, prepared_video=None):
            out = super().ground(record, prepared_video)
            self.grounded.append(out)
            return out

        def ground_from_prepared(self, prepared):
            out = super().ground_from_prepared(prepared)
            self.grounded.extend(out)
            return out

    tok = FakeTokenizer()
    return RecordingEngine(
        params, cfg, tok,
        VideoProcessor(DataConfig(
            video_folder=root,
            annotation_dir=os.path.join(root, "embodiedscan"),
            metadata_dir=os.path.join(root, "metadata"),
            frames_upbound=frames)),
        engine_cfg=EngineConfig(max_new_tokens=MAX_NEW,
                                eos_token_id=tok.eos_token_id,
                                max_frames=frames, stop_str="", **ecfg),
        device=torch.device("cuda", 0))


def _forwards(res) -> int:
    """Decode forwards of one generate call: it runs chunks of
    DECODE_CHUNK steps and stops after the chunk in which its last row
    finished, or after MAX_NEW steps."""
    from video3d_tpu_torch.models.decode_graph import DECODE_CHUNK

    steps = int(res.lengths.max()) + 1
    return min(-(-steps // DECODE_CHUNK) * DECODE_CHUNK, MAX_NEW)


def _clone_state(state):
    """A copy of a dense or paged decode state (every tensor cloned)."""
    return type(state)(*(
        type(x)(*(None if t is None else t.clone() for t in x))
        if isinstance(x, tuple) else x.clone() for x in state))


def _capture_vs_eager(name: str, chunk_fn, params, cfg, state, steps: int,
                      eos: int) -> None:
    """From copies of ``state``: one decode step replayed as a captured
    CUDA graph against the same step uncaptured (next logits bit for bit),
    then a chunk of ``steps`` steps both ways (tokens and next logits bit
    for bit); prints both chunks' walls. ``state`` is left as it was."""
    import torch

    from video3d_tpu_torch.models.decode_graph import (DecodeGraphs,
                                                       state_tensors)

    graphs = DecodeGraphs(state.next_logits.device)
    walls = {}
    with torch.inference_mode():
        work, eager = _clone_state(state), _clone_state(state)

        def reset(dst):
            for a, b in zip(state_tensors(dst), state_tensors(state)):
                a.copy_(b)

        chunk_fn(params, cfg, work, 1, eos, graphs=graphs)   # capture
        capture_one = graphs.capture_seconds * 1e3
        reset(work)
        chunk_fn(params, cfg, work, 1, eos, graphs=graphs)   # replay
        chunk_fn(params, cfg, eager, 1, eos, capture=False)
        first = torch.equal(work.next_logits, eager.next_logits)
        diff = float((work.next_logits.float()
                      - eager.next_logits.float()).abs().max())
        reset(work)
        chunk_fn(params, cfg, work, steps, eos, graphs=graphs)
        toks = {}
        for tag, st, kw in (("captured", work, {"graphs": graphs}),
                            ("uncaptured", eager, {"capture": False})):
            reset(st)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, toks[tag] = chunk_fn(params, cfg, st, steps, eos, **kw)
            toks[tag] = toks[tag].tolist()
            walls[tag] = (time.perf_counter() - t0) * 1e3
        same = toks["captured"] == toks["uncaptured"] and \
            torch.equal(work.next_logits, eager.next_logits)
    _check(f"{name}: first step replayed as a CUDA graph vs uncaptured",
           first and graphs.replays >= 1,
           f"next logits bit for bit: {first} (max |d| {diff:.3g}); "
           f"{graphs.captures} captures, {graphs.replays} replays")
    _check(f"{name}: a {steps}-step chunk replayed vs uncaptured", same,
           f"tokens and next logits bit for bit: {same}")
    print(f"  {name}: a {steps}-step chunk of {state.next_logits.shape[0]} "
          f"rows {walls['captured']:.2f} ms captured, "
          f"{walls['uncaptured']:.2f} ms uncaptured (host clock, "
          f"synchronised); its capture took "
          f"{graphs.capture_seconds * 1e3 - capture_one:.1f} ms of host "
          f"time", flush=True)
    del work, eager, graphs
    torch.cuda.empty_cache()


def _decode_forwards(results, vocab: int) -> int:
    """Check the emitted ids of every row and count the decode forwards the
    generate calls made."""
    for res in results:
        lengths = res.lengths.tolist()
        ok = all(bool(((res.tokens[b, :n] >= 0)
                       & (res.tokens[b, :n] < vocab)).all())
                 for b, n in enumerate(lengths))
        _check("emitted ids", ok, f"rows of {lengths} ids in [0, {vocab})")
    return sum(_forwards(res) for res in results)


def _tokens_digest(results) -> str:
    """The first 12 hex digits of a sha1 over the ids every generate call
    emitted, in order: runs of the same seeds answer alike iff it is
    equal."""
    import hashlib

    h = hashlib.sha1()
    for res in results:
        for b, n in enumerate(res.lengths.tolist()):
            h.update(json.dumps(res.tokens[b, :n].tolist()).encode())
    return h.hexdigest()[:12]


def _expected_launches(params, kv_cache_dtype: str, layers: int,
                       forwards: int, results, **per_path) -> dict:
    """Launch counts a run must show: ``per_path`` gives the geometry and
    attention kernels of the path under their bf16 names; an int8 (int4)
    cache moves the decode, folded and shared-prefix counts to their
    ``*_int8`` (``*_int4``) kernels. Quantized weights add their kernels:
    every decode forward runs
    7 projections per layer on at most 8 rows, and every generate call one
    lm_head at its prefill and one per decode forward, on its B rows. int4
    runs B8 on all of them; int8 runs B4's B>1 form on the projections and
    on heads of 2-32 rows, B4's matvec on one-row heads. w8a8 calls
    ``torch._int_mm`` once per projection of every forward, prefills
    included, and once per head."""
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models.quant import (W8A8_COUNT, Int4Weight,
                                                W8A8Weight, is_quantized)

    expected = dict.fromkeys(_build.LAUNCHES, 0)
    expected.update(per_path, decode_attention=layers * forwards)
    if kv_cache_dtype in ("int8", "int4"):
        for name in ("decode_attention", "flash_attention_folded",
                     "shared_prefix_attention"):
            expected[f"{name}_{kv_cache_dtype}"] = expected.pop(name)
            expected[name] = 0
    head = params["llm"]["lm_head"]
    heads = [(int(res.tokens.shape[0]), 1 + _forwards(res))
             for res in results]
    projections = 7 * layers * forwards
    if isinstance(head, W8A8Weight):
        # torch._int_mm on every projection of the prefills too
        expected[W8A8_COUNT] = 7 * layers * (forwards + len(results)) \
            + sum(n for _, n in heads)
    elif isinstance(head, Int4Weight):
        expected["int4_matmul"] = projections + sum(n for _, n in heads)
    elif is_quantized(head):
        expected["int8_matmul"] = projections + sum(n for b, n in heads
                                                    if b > 1)
        expected["int8_matvec"] = sum(n for b, n in heads if b == 1)
    return expected


def _answer_file(root: str, path: str, params, kv_cache_dtype: str) -> str:
    """A fresh answer file per configuration (the drivers append; a file
    of an earlier run of the same configuration is removed)."""
    from video3d_tpu_torch.models.decode_graph import weight_form

    out = os.path.join(root, f"{path}_{weight_form(params)}_"
                             f"{kv_cache_dtype}.jsonl")
    if os.path.exists(out):
        os.remove(out)
    return out


def _read_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_main_path(params, cfg, root: str, info,
                  kv_cache_dtype: str = "bfloat16",
                  results: Optional[list] = None) -> tuple:
    """Answer two questions at full width through ``run_scanqa``; returns the
    kernel launch counts of that run and the captured B=1 decode's ms per
    token (``results``, if given, receives the two answers'
    GenerateResults)."""
    import torch

    from video3d_tpu_torch.eval.drivers import run_scanqa
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import llava_video3d as lv3d

    engine = _make_engine(params, cfg, root, kv_cache_dtype=kv_cache_dtype)
    qs = _questions(info["sample_idx"], SCANQA_TEXTS, "smoke")
    engine.generate_answer(qs[0])                 # warm-up, not counted
    engine.results.clear()
    answer_file = _answer_file(root, "scanqa", params, kv_cache_dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    times = run_scanqa(engine, qs, answer_file)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    records = _read_jsonl(answer_file)
    if results is not None:
        results.extend(engine.results)

    # checks of what came out
    _check("answer records", len(records) == 2 and all(
        isinstance(r["pred_response"], str) for r in records),
        f"{len(records)} jsonl records")
    forwards = _decode_forwards(engine.results, cfg.llm.vocab_size)
    L = cfg.llm.num_hidden_layers
    expected = _expected_launches(params, kv_cache_dtype, L, forwards,
                                  engine.results, fused_geometry=2,
                                  flash_attention=2 * L)
    _check("launch counts", launches == expected,
           f"{launches}, expected {expected} ({forwards} decode forwards)")
    print(f"  answers' token ids: sha1 {_tokens_digest(engine.results)}",
          flush=True)
    print(f"  per-request seconds (prep excluded): "
          f"{[round(t, 4) for t in times]}; wall for 2 requests "
          f"(prep included) {wall:.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)

    # the two answers again with the decode loop uncaptured: the same ids
    eos = engine.ecfg.eos_token_id
    for i, q in enumerate(qs):
        b, vf = engine._prepare_generation(q)
        ref = gen.generate_greedy(params, cfg, b, MAX_NEW, eos, vf,
                                  engine.cache_dtype, capture=False)
        got = engine.results[i]
        _check(f"answer {i}: captured decode vs uncaptured",
               torch.equal(got.tokens, ref.tokens)
               and torch.equal(got.lengths, ref.lengths),
               f"ids bit for bit (lengths {got.lengths.tolist()} / "
               f"{ref.lengths.tolist()})")

    # a separately timed request: vision, LLM prefill, decode
    batch, _ = engine._prepare_generation(qs[1])
    seq_len = int(batch.seq_len[0])
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vis = lv3d.encode_video(params, cfg, batch.images,
                                batch.patch_coords).spliceable
        torch.cuda.synchronize()
        t_vis = time.perf_counter() - t0
        t0 = time.perf_counter()
        logits, _, _ = gen.prefill_multimodal(
            params, cfg, batch, batch.text_ids.shape[1] + MAX_NEW,
            vision_features=vis, cache_dtype=engine.cache_dtype)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
    _check("prefill logits", logits.shape == (1, cfg.llm.vocab_size)
           and bool(torch.isfinite(logits.float()).all()),
           f"shape {tuple(logits.shape)}, all finite")
    walls = {}
    for tag, kw in (("captured", {"graphs": engine._graphs}),
                    ("uncaptured", {"capture": False})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gen.generate_greedy(params, cfg, batch, MAX_NEW,
                                  engine.ecfg.eos_token_id, vis,
                                  engine.cache_dtype, **kw)
        steps = _forwards(res)
        torch.cuda.synchronize()
        walls[tag] = ((time.perf_counter() - t0) - t_pre) / steps * 1e3
    print(f"  vision (tower+projector+pool+PE, {batch.images.shape[1]} "
          f"frames) {t_vis * 1e3:.1f} ms; LLM prefill {seq_len} tokens "
          f"(bucket {batch.text_ids.shape[1]}) {t_pre * 1e3:.1f} ms = "
          f"{seq_len / t_pre:.0f} tokens/s; B=1 decode "
          f"{walls['captured']:.2f} ms/token captured, "
          f"{walls['uncaptured']:.2f} uncaptured, over {steps} steps",
          flush=True)
    with torch.inference_mode():
        logits, cache, pos = gen.prefill_multimodal(
            params, cfg, batch, batch.text_ids.shape[1] + MAX_NEW,
            vision_features=vis, cache_dtype=engine.cache_dtype)
        state = gen._initial_state(logits, cache, pos)
    _capture_vs_eager("B=1 decode (phase 4's path)", gen.decode_chunk,
                      params, cfg, state, DECODE_STEPS, eos)
    del state, cache
    return launches, walls["captured"]


def _full_prefill_logits(params, cfg, engine, q):
    """(first-step logits (V,) f32 of a full prefill of ``q``, the same one
    position early, the prefill's seconds); vision features from the
    engine's scene cache."""
    import torch

    from video3d_tpu_torch.models import generate as gen

    batch, vis = engine._prepare_generation(q)
    max_len = batch.text_ids.shape[1] + MAX_NEW
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, _, _ = gen.prefill_multimodal(
            params, cfg, batch, max_len, vision_features=vis,
            cache_dtype=engine.cache_dtype)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        early, _, _ = gen.prefill_multimodal(
            params, cfg, batch._replace(seq_len=batch.seq_len - 1),
            max_len, vision_features=vis, cache_dtype=engine.cache_dtype)
    return ref[0].float(), early[0].float(), seconds


def run_prefix_path(params, cfg, root: str, info,
                    kv_cache_dtype: str = "bfloat16",
                    logit_atol: Optional[float] = LOGIT_ATOL,
                    step_check=None) -> dict:
    """Scene-prefix path: 16 same-scene questions through
    ``run_generative(batch_size=8)`` (a miss that runs the full prefill and
    stores the prefix, a B=7 and a B=8 suffix batch), then one B=1 hit;
    returns the kernel launch counts of that run. The first-step logits of
    the suffix paths must be within ``logit_atol`` of a full prefill, and
    their one-position-early control at least twice that far (``None``:
    both distances printed, not held). ``step_check(engine, prep, hit_q)``,
    if given, runs last, on the prepared B=8 suffix batch and the B=1 hit's
    question."""
    import torch

    from video3d_tpu_torch.eval.drivers import run_generative
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import generate as gen

    engine = _make_engine(params, cfg, root, prefix_cache_scenes=1,
                          scene_cache_scenes=1,
                          kv_cache_dtype=kv_cache_dtype)
    qs = _questions(info["sample_idx"], PREFIX_TEXTS, "prefix")
    batch_qs, hit_q = qs[:16], qs[16]
    answer_file = _answer_file(root, "prefix", params, kv_cache_dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    times = run_generative(engine, batch_qs, answer_file, batch_size=8)
    wall = time.perf_counter() - t0
    hit_prep = engine.prepare_request(hit_q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._answer_from_prep(hit_prep)
    torch.cuda.synchronize()
    t_hit = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    graph_stats = engine._graphs.stats()
    peak = torch.cuda.max_memory_allocated()
    records = _read_jsonl(answer_file)

    _check("prefix answer records", len(records) == 16 and all(
        isinstance(r["pred_response"], str) for r in records),
        f"{len(records)} jsonl records")
    _check("prefix cache stats", engine.prefix_cache_stats == [16, 1],
           f"[hits, misses] {engine.prefix_cache_stats}")
    rows = [int(r.tokens.shape[0]) for r in engine.results]
    _check("generate calls", rows == [1, 7, 8, 1],
           f"batch rows {rows} (miss, suffix batches, B=1 hit)")
    forwards = _decode_forwards(engine.results, cfg.llm.vocab_size)
    L = cfg.llm.num_hidden_layers
    expected = _expected_launches(
        params, kv_cache_dtype, L, forwards, engine.results, fused_geometry=1,
        flash_attention=L, flash_attention_folded=L,
        shared_prefix_attention=2 * L)
    _check("launch counts", launches == expected,
           f"{launches}, expected {expected} ({forwards} decode forwards)")

    # first-step logits of a B=8 row and of the B=1 hit against a full
    # prefill of the same question (vision features from the scene cache),
    # and against the full prefill's logits one position early (control)
    t_full, refs = None, []
    pairs = (("B=8 row 0", batch_qs[8], engine.first_logits[2][0]),
             ("B=1 hit", hit_q, engine.first_logits[3][0]))
    for name, q, got in pairs:
        ref, early, t_full = _full_prefill_logits(params, cfg, engine, q)
        refs.append(ref)
        diff = float((got - ref).abs().max())
        control = float((got - early).abs().max())
        if logit_atol is None:
            print(f"  first-step logits vs full prefill over raw K/V "
                  f"({name}), the {kv_cache_dtype} cache's own error: max "
                  f"|d| {diff:.4f} (|logits| up to "
                  f"{float(ref.abs().max()):.2f}); one position early: "
                  f"{control:.4f}", flush=True)
            continue
        _check(f"first-step logits vs full prefill ({name})",
               diff <= logit_atol and bool(torch.isfinite(got).all()),
               f"max |d| {diff:.4f} (bound {logit_atol}; |logits| up to "
               f"{float(ref.abs().max()):.2f})")
        _check(f"first-step logits control ({name}), one position early",
               control >= 2 * logit_atol,
               f"max |d| {control:.4f} (must be >= {2 * logit_atol})")
    # what a swap of two questions would read (printed, not checked)
    print(f"  first-step logits of {pairs[0][0]} vs the full prefill of the "
          f"other question: max |d| "
          f"{float((pairs[0][2] - refs[1]).abs().max()):.4f}", flush=True)

    # separately timed: the B=8 suffix prefill and its decode steps
    prep = engine.prepare_answers_batch_prefix(batch_qs[8:])
    entry = prep["entry"]
    pre_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = gen.start_decode_prefix(
            params, cfg, prep["batch"], entry.cache, entry.prefix_len,
            prep["bucket"] + MAX_NEW, engine.cache_dtype)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    eos = engine.ecfg.eos_token_id
    with torch.inference_mode():
        spare = _clone_state(state)
        second = _clone_state(state)
    t0 = time.perf_counter()
    res = engine._generate_from_state(state)
    torch.cuda.synchronize()
    steps = _forwards(res)
    decode_ms = (time.perf_counter() - t0) / steps * 1e3
    t0 = time.perf_counter()
    ref = gen.generate_from_state(params, cfg, second, MAX_NEW, eos,
                                  capture=False)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / _forwards(ref) * 1e3
    _check("B=8 suffix batch: captured decode vs uncaptured",
           torch.equal(res.tokens, ref.tokens)
           and torch.equal(res.lengths, ref.lengths),
           f"ids bit for bit (lengths {res.lengths.tolist()})")
    del second
    _capture_vs_eager("B=8 decode (phase 5's batch)", gen.decode_chunk,
                      params, cfg, spare, DECODE_STEPS, eos)
    del spare
    print(f"  seconds per question (prep excluded): miss chunk "
          f"{times[0]:.4f} (1 full prefill + B=7 suffix batch), hit chunk "
          f"{times[8]:.4f} (B=8 suffix batch), B=1 hit {t_hit:.4f}; wall "
          f"for 16 questions {wall:.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"  the engine's decode graphs over the pass: {graph_stats['keys']} "
          f"keys, {graph_stats['captures']} captures, "
          f"{graph_stats['replays']} replays, {graph_stats['evictions']} "
          f"evictions; its held states "
          f"{graph_stats['held_state_bytes'] / 1e9:.3f} GB, the graphs' "
          f"pools {graph_stats['pool_bytes'] / 1e9:.3f} GB", flush=True)
    entry_bytes = sum(t.numel() * t.element_size() for t in entry.cache
                      if t is not None)
    print(f"  prefix {entry.prefix_len} tokens, {entry_bytes / 1e9:.3f} GB "
          f"cached ({entry.cache.k.dtype}); B=8 suffix prefill "
          f"(bucket {prep['batch'].text_ids.shape[1]}) "
          f"{sorted(pre_ms)[1]:.1f} ms (median of 3) against a B=1 full "
          f"prefill {t_full * 1e3:.1f} ms; B=8 decode {decode_ms:.2f} "
          f"ms/step captured, {eager_ms:.2f} uncaptured, over {steps} "
          f"steps", flush=True)
    if step_check is not None:
        del state, res
        step_check(engine, prep, hit_q)
    return launches


# phase 8: the paged continuous batcher at full width and depth
SERVE_SLOTS, SERVE_CHUNK, SERVE_PAGE = 8, 8, 128
SERVE_BUDGETS = (8, 16, 32)
SERVE_TEXTS = PREFIX_TEXTS[:12]
# requests of the three waves: 12 on scene A (one cancelled mid-stream),
# 11 on scene B (storing B's prefix evicts A's, releasing its shared
# pages), then 1 on scene A (evicting B's, so every page comes back)
SERVE_WAVES = ((0, 12), (1, 11), (0, 1))
SERVE_CANCEL = 5            # the request of wave 1 cancelled mid-stream
# phase 8's paged step against the dense step from the same sub-states:
# both read the same bf16 (int8) K/V through B7 and B3, whose split-K
# arithmetic is the same, and run the same products, so they agree to
# float32 summation order. LOGIT_ATOL could not see a wrong page: with
# random weights attention is diffuse, and even a swapped question moves
# the first-step logits by only ~0.2 (PERF.md section 7).
PAGED_LOGIT_ATOL = 1e-3


def _serve_footprints(engine, q):
    """(bucket, pages of one request's full footprint at the largest
    budget, full prefix pages) of a question, from its splice plan (host
    only)."""
    from video3d_tpu_torch.models.paged_kv import pages_needed
    from video3d_tpu_torch.models.splice import vision_end_from_kind

    frames = engine.ecfg.max_frames
    plan, bucket = engine._splice_plan([engine._tokenize_prompt(q)],
                                       [frames], frames)
    prefix = vision_end_from_kind(plan.kind[0])
    return (bucket, pages_needed(bucket + max(SERVE_BUDGETS) + SERVE_CHUNK,
                                 SERVE_PAGE), prefix // SERVE_PAGE)


def _timed_batcher(engine, total_pages: int):
    """A ContinuousBatcher whose admissions and decode chunks this script
    times (CUDA-synchronised host clock) and counts, with the pages in use
    sampled after every chunk."""
    import torch

    from video3d_tpu_torch.serve import batcher as sb

    log = {"admit": [], "defer": 0, "chunks": [], "in_use": 0}

    class TimedBatcher(sb.ContinuousBatcher):
        def _admit(self, slot, req, prepared):
            before = engine.prefix_cache_stats[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._admit(slot, req, prepared)
            torch.cuda.synchronize()
            if out is self._DEFER:
                log["defer"] += 1
            elif out:
                hit = engine.prefix_cache_stats[0] > before
                log["admit"].append(("hit" if hit else "miss",
                                     (time.perf_counter() - t0) * 1e3))
            return out

    decode = sb.paged_decode_chunk

    def chunk_fn(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(*args, **kwargs)
        torch.cuda.synchronize()
        log["chunks"].append((time.perf_counter() - t0) * 1e3)
        b = batcher
        log["in_use"] = max(log["in_use"],
                            b.total_pages - 1 - b._alloc.available)
        return out

    batcher = TimedBatcher(engine, num_slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
                           paged=True, page_size=SERVE_PAGE,
                           total_pages=total_pages)
    return batcher, log, chunk_fn


def _serve_wave(batcher, engine, questions, first: int, cancel=None):
    """Submit each question from its own thread with budgets cycling
    through SERVE_BUDGETS; the request ``cancel`` is cancelled after its
    first streamed tokens. Returns [(budget, handle, cancelled)]."""
    import threading

    out, errors = [None] * len(questions), []

    def run(i, q):
        try:
            budget = SERVE_BUDGETS[(first + i) % len(SERVE_BUDGETS)]
            h = batcher.submit(q, max_new_tokens=budget)
            if i == cancel:
                stream = h.text_stream(engine._decode_text)
                next(stream)
                h.cancel()
                for _ in stream:
                    pass
            else:
                h.result(engine._decode_text, timeout=600)
            out[i] = (budget, h, i == cancel)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"request {first + i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i, q))
               for i, q in enumerate(questions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _check(f"requests {first}..{first + len(questions) - 1} returned",
           not errors, "; ".join(errors) or "no errors")
    return out


def _check_paged_vs_dense(params, cfg, engine, questions, other):
    """The first step of ``paged_decode_chunk`` against ``decode_chunk``
    over a dense state, from the same admitted B=1 sub-states: two hits on
    the cached scene (sharing its prefix pages) and a full prefill on the
    other scene. Next logits within PAGED_LOGIT_ATOL; the control (slot
    0's boundary page swapped with the other scene's slot's page) must
    read at least twice that."""
    import torch

    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models.paged_kv import pages_needed

    page = SERVE_PAGE
    eos = engine.ecfg.eos_token_id
    dev, dtype = engine.device, engine.cache_dtype
    preps = [engine.prepare_request(q) for q in questions]
    entry = preps[0]["entry"]
    n_full = entry.prefix_len // page
    batch, vf = engine._prepare_generation(other)
    n_pages = [pages_needed(b, page) for b in
               [p["bucket"] for p in preps] + [int(batch.text_ids.shape[1])]]
    skips = [n_full] * len(preps) + [0]
    # the dense rows hold the paged slots' capacity, so B3 and B7 (and
    # their hd-256 forms, whose splits follow the capacity) plan alike
    M = (max(n_pages) + 1) * page
    with torch.inference_mode():
        subs = [engine.start_request(p, max_cache_len=M) for p in preps]
        subs.append(gen.start_decode(params, cfg, batch, M, vf, dtype))
        S = len(subs)
        own = [n + 1 - k for n, k in zip(n_pages, skips)]
        dense = gen.empty_decode_state(cfg, S, M, dtype, device=dev)
        paged = gen.empty_paged_state(cfg, S, 1 + n_full + sum(own), page,
                                      max(n_pages) + 1, dtype, device=dev)
        shared = list(range(1, 1 + n_full))
        gen.write_shared_prefix(paged.cache, entry.cache, shared, n_full)
        first = 1 + n_full
        for s, sub in enumerate(subs):
            gen.insert_decode_slot(dense, s, sub)
            row = shared[:skips[s]] + list(range(first, first + own[s]))
            row += [0] * (paged.cache.max_pages - len(row))
            first += own[s]
            gen.insert_paged_slot(
                paged, s, sub, torch.tensor(row, dtype=torch.int32,
                                            device=dev),
                n_pages[s], skip_pages=skips[s])
        del subs
        control = gen.PagedDecodeState(
            paged.next_logits.clone(),
            paged.cache._replace(**{f: t.clone() for f, t in
                                    paged.cache._asdict().items()
                                    if t is not None}),
            paged.done.clone(), paged.step.clone())
        table = control.cache.page_table
        table[[0, S - 1], n_full] = table[[S - 1, 0], n_full]
    _capture_vs_eager(f"paged chunk ({S} admitted slots)",
                      gen.paged_decode_chunk, params, cfg, paged,
                      SERVE_CHUNK, eos)
    with torch.inference_mode():
        d, _ = gen.decode_chunk(params, cfg, dense, 1, eos, capture=False)
        p, _ = gen.paged_decode_chunk(params, cfg, paged, 1, eos,
                                      capture=False)
        c, _ = gen.paged_decode_chunk(params, cfg, control, 1, eos,
                                      capture=False)
    diff = float((p.next_logits - d.next_logits).abs().max())
    ctl = float((c.next_logits[0] - d.next_logits[0]).abs().max())
    _check(f"paged vs dense first-step logits ({S} slots)",
           diff <= PAGED_LOGIT_ATOL
           and bool(torch.isfinite(p.next_logits).all()),
           f"max |d| {diff:.2e} (bound {PAGED_LOGIT_ATOL:.0e})")
    _check("paged vs dense control, slot 0's boundary page swapped with "
           "the other scene's", ctl >= 2 * PAGED_LOGIT_ATOL,
           f"max |d| {ctl:.2e} (must be >= {2 * PAGED_LOGIT_ATOL:.0e})")
    del d, p, c, dense, paged, control
    torch.cuda.empty_cache()


def run_serving(params, cfg, root: str, infos,
                kv_cache_dtype: str = "bfloat16") -> dict:
    """Phase 8: the paged continuous batcher (8 slots, chunks of 8, pages
    of 128) with shared prefix pages serves 24 requests in three waves
    over two scenes (SERVE_WAVES) on a pool too small for eight full
    footprints; returns the kernel launch counts of that run."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models.quant import Int4Weight, is_quantized
    from video3d_tpu_torch.serve import batcher as sb

    engine = _make_engine(params, cfg, root, prefix_cache_scenes=1,
                          scene_cache_scenes=1, kv_cache_dtype=kv_cache_dtype)
    scenes = [_questions(info["sample_idx"], SERVE_TEXTS, f"serve{i}_")
              for i, info in enumerate(infos)]
    bucket, need, n_full = _serve_footprints(engine, scenes[0][0])
    # the first miss, the shared prefix and three private remainders: the
    # deferred FIFO holds the rest of each wave
    total = 1 + need + n_full + 3 * (need - n_full)
    batcher, log, chunk_fn = _timed_batcher(engine, total)
    L = cfg.llm.num_hidden_layers
    dense_pages = SERVE_SLOTS * batcher.max_pages
    print(f"  pool {total} pages of {SERVE_PAGE} ({need} per full "
          f"footprint at bucket {bucket}, {n_full} prefix pages) against "
          f"{dense_pages} for {SERVE_SLOTS} dense-equivalent rows",
          flush=True)
    orig = sb.paged_decode_chunk
    sb.paged_decode_chunk = chunk_fn
    handles = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        n = 0
        for scene, count in SERVE_WAVES:
            handles += _serve_wave(batcher, engine, scenes[scene][:count], n,
                                   SERVE_CANCEL if n == 0 else None)
            n += count
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        drained = _wait_for(lambda: not batcher._shared and
                            batcher._alloc.available == total - 1)
    finally:
        sb.paged_decode_chunk = orig
        batcher.shutdown()
    free = batcher._alloc.available
    _check("every page back after the last eviction",
           drained and free == total - 1,
           f"available {free} of {total - 1}, shared entries "
           f"{len(batcher._shared)}")
    tokens = sum(len(h.tokens) for _, h, _ in handles)
    early = [(b, len(h.tokens)) for b, h, c in handles if c]
    over = [(b, len(h.tokens)) for b, h, c in handles
            if len(h.tokens) > b or (not c and h.error is not None)]
    _check("budgets and the cancelled request",
           not over and len(early) == 1 and early[0][1] < early[0][0],
           f"{tokens} tokens; cancelled request {early} (budget, tokens); "
           f"over budget or failed {over}")
    # each wave's first admission misses (the engine keeps one scene's
    # prefix and the waves alternate scenes); the rest hit and share
    misses = len(SERVE_WAVES)
    hits = sum(c for _, c in SERVE_WAVES) - misses
    _check("prefix sharing", batcher.prefix_share_stats == [hits, 2]
           and engine.prefix_cache_stats == [hits, misses],
           f"batcher [shared admissions, creations] "
           f"{batcher.prefix_share_stats}, engine [hits, misses] "
           f"{engine.prefix_cache_stats}")
    _check("deferred admissions", log["defer"] > 0,
           f"{log['defer']} admissions deferred for pages")
    steps = SERVE_CHUNK * len(log["chunks"])
    form = "" if kv_cache_dtype == "bfloat16" else f"_{kv_cache_dtype}"
    expected = dict.fromkeys(_build.LAUNCHES, 0)
    expected.update({"paged_attention" + form: L * steps,
                     "flash_attention": L * misses,
                     "flash_attention_folded" + form: L * hits,
                     "fused_geometry": launches["fused_geometry"]})
    # each decode step: 7 projections per layer and the lm_head on the
    # SERVE_SLOTS rows; each admission: one B=1 lm_head
    head = params["llm"]["lm_head"]
    if isinstance(head, Int4Weight):
        expected["int4_matmul"] = (7 * L + 1) * steps + misses + hits
    elif is_quantized(head):
        expected["int8_matmul"] = (7 * L + 1) * steps
        expected["int8_matvec"] = misses + hits
    _check("launch counts", launches == expected
           and misses <= launches["fused_geometry"] <= 2 * misses,
           f"{launches}, expected {expected} ({steps} decode steps; B1 "
           f"once or twice per wave)")
    chunks = sorted(log["chunks"])
    ms_chunk = chunks[len(chunks) // 2]
    admit = {k: sorted(ms for kind, ms in log["admit"] if kind == k)
             for k in ("miss", "hit")}
    smi = _card()
    print(f"  {len(handles)} requests, {tokens} output tokens in "
          f"{wall:.3f} s = {tokens / wall:.1f} tokens/s over all slots; "
          f"{len(chunks)} decode chunks, median {ms_chunk:.2f} ms per chunk"
          f" = {ms_chunk / SERVE_CHUNK:.2f} ms per step of {SERVE_SLOTS} "
          f"slots; admission median ms: miss "
          f"{admit['miss'][len(admit['miss']) // 2]:.1f} "
          f"({len(admit['miss'])}), hit "
          f"{admit['hit'][len(admit['hit']) // 2]:.1f} "
          f"({len(admit['hit'])}); pages in use at most {log['in_use']} "
          f"against {dense_pages} dense-equivalent; peak device memory "
          f"{peak / 2**30:.2f} GiB; {smi}", flush=True)
    _check_paged_vs_dense(params, cfg, engine, scenes[0][:2], scenes[1][0])
    del batcher, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 12: grounding (ScanRefer, Multi3DRefer) and Scan2Cap at full width
GROUND_OBJECTS = 150       # the third scene's proposals: max_objects
GROUND_TEXTS = (
    "Find the brown chair next to the desk.",
    "The lamp on the nightstand.", "The white door on the left.",
    "Find the trash can under the sink near the wall.",
    "The pillow on the bed near the window.",
    "Find the monitor behind the keyboard.")
M3DR_TEXTS = ("All the chairs around the table.", "The two lamps.",
              "Every pillow on the sofa.", "The shelves on the wall.")
CAPTION_TEXTS = (
    "Describe the object at <coord> .", "What is at <coord> ?",
    "Describe the object at <coord> in detail.",
    "Tell me about the object at <coord> .",
    "What does the object at <coord> look like?",
    "Describe <coord> .", "What is the object located at <coord> ?",
    "Give a caption for the object at <coord> .",
    "Describe the thing at <coord> briefly.")
# the grounding scores (INFONCE cosines, bf16 model) of a prefix hit, and
# of a query in the B=4 batch, against the full grounding forward of the
# same query: the hit attends the prefix K/V through B2 folded, the full
# forward through B2 in another order. A control reads the full forward's
# query one position before the <ground> slot; it must read at least 4x
# the bound. On an H100 80GB HBM3 (700 W) the hits read 1.83e-3, the B=4
# batch and the miss 0, the control 4.09e-2 (the objects in reversed
# order 5.06e-2), with the 151 scores of a query spread over 0.062.
GROUND_SCORE_ATOL = 5e-3
# the <coord> box PE added to the bf16 embedding at its slot: the
# embedding's change there against the PE in bf16, within a bf16 rounding
# of |PE| <= 1 (every other slot must not change)
BOX_PE_ATOL = 8e-3


def _ground_queries(info, texts, tag: str, dataset: str):
    import numpy as np

    boxes = np.asarray(info["boxes"], np.float32)
    out = []
    for i, text in enumerate(texts):
        box = boxes[i % len(boxes)].tolist()
        out.append({
            "id": f"{tag}{i}", "video": info["sample_idx"],
            "box": [box] if dataset == "multi3drefer" else box,
            "conversations": [
                {"from": "human", "value": f"<image>\n{text}"},
                {"from": "gpt", "value": "<ground>"}],
            "metadata": {"dataset": dataset, "gt_box": box,
                         "question_type": "st_w_d" if dataset ==
                         "multi3drefer" else "unique"}})
    return out


def _caption_queries(info):
    import numpy as np

    boxes = np.asarray(info["boxes"], np.float32)
    return [{
        "id": f"cap{i}", "video": info["sample_idx"],
        "box_input": boxes[3 * i].tolist(),
        "conversations": [
            {"from": "human", "value": f"<image>\n{text}"},
            {"from": "gpt", "value": "a brown wooden chair"}],
        "annotations": ["a brown wooden chair", "the chair by the desk"],
        "metadata": {"dataset": "scan2cap"}}
        for i, text in enumerate(CAPTION_TEXTS)]


def _ground_inputs(engine, q):
    """The device inputs of one grounding forward without the prefix
    cache: (batch, coordinates, boxes, valid, <ground> slot, n)."""
    ids, labels = engine._ground_tokenize(q)
    batch, _, coords, boxes, valid, slot, _, n = engine._ground_inputs(
        ids, labels, q["video"])
    return batch, coords, boxes, valid, slot, n


def _scores_diff(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _check_grounded(name: str, got, want, info) -> None:
    """Compacted scores of the same queries two ways: finite, JAX's layout
    (the N real objects + the zero target; the scene's boxes), within
    GROUND_SCORE_ATOL of each other with the same argmax."""
    import numpy as np

    boxes = np.asarray(info["boxes"], np.float32)
    ok = all(s.shape == (len(boxes) + 1,) and bool(np.isfinite(s).all())
             and np.array_equal(o, boxes) for s, o in got + want)
    _check(f"{name}: compacted scores", ok,
           f"{len(got)} + {len(want)} results of {len(boxes)} objects + 1, "
           f"finite, boxes the scene's")
    diff = max(_scores_diff(a, b) for (a, _), (b, _) in zip(got, want))
    same = all(int(np.argmax(a)) == int(np.argmax(b))
               for (a, _), (b, _) in zip(got, want))
    spread = max(float(b.max() - b.min()) for b, _ in want)
    _check(name, diff <= GROUND_SCORE_ATOL and same,
           f"max |d| {diff:.2e} (bound {GROUND_SCORE_ATOL:.0e}; scores "
           f"spread over up to {spread:.3f}); argmax equal: {same}")


def run_grounding(params, cfg, root: str, info,
                  kv_cache_dtype: str = "bfloat16", full: bool = True
                  ) -> dict:
    """Phase 12 on the third scene (32 frames, GROUND_OBJECTS proposals):
    ``run_scanrefer`` over 6 queries with the prefix cache (a miss through
    ``grounding_forward_cached``, 5 hits through ``ground_suffix``, B2
    folded), the same 6 through ``ground`` without it (the full forward,
    B2), 4 of them through ``run_scanrefer(batch_size=4)`` without it (one
    B=4 prefill), ``run_multi3drefer`` over 4 (hits), ``run_scan2cap`` over
    8 captions with their boxes at ``batch_size=8`` (one B=8 suffix, B5)
    and one more caption (a B=1 hit); returns the launch counts of those
    runs, checked exactly, then holds the hits and the batch against the
    full forward, the object cache against a recomputation, the caption
    logits against a full prefill and the box PE at its slot, and prints
    the protocols' metrics, the seconds and the peak memory.
    ``full=False`` (phase 6, int8): the ScanRefer prefix run of 4 queries
    (1 miss, 3 hits) and its launch counts only."""
    import numpy as np
    import torch

    from fixtures import FakeTokenizer

    from video3d_tpu_torch.eval import protocols
    from video3d_tpu_torch.eval.drivers import (run_multi3drefer,
                                                run_scan2cap, run_scanrefer)
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import llava_video3d as lv3d
    from video3d_tpu_torch.ops.pos_embed import sin3d_position_embedding

    vocab = FakeTokenizer().vocab
    ground_id, coord_id = vocab["<ground>"], vocab["<coord>"]
    kw = dict(kv_cache_dtype=kv_cache_dtype, ground_token_id=ground_id,
              max_objects=GROUND_OBJECTS)
    cached = _make_engine(params, cfg, root, prefix_cache_scenes=1, **kw)
    gq = _ground_queries(info, GROUND_TEXTS, "ground", "scanrefer")
    L = cfg.llm.num_hidden_layers
    refer_file = _answer_file(root, "scanrefer", params, kv_cache_dtype)
    dev = torch.device("cuda", 0)
    if not full:
        _build.reset_launches()
        times = run_scanrefer(cached, gq[:4], refer_file)
        launches = dict(_build.LAUNCHES)
        expected = _expected_launches(params, kv_cache_dtype, L, 0, [],
                                      flash_attention=L,
                                      flash_attention_folded=3 * L)
        _check("launch counts", launches == expected,
               f"{launches}, expected {expected} (1 miss, 3 hits)")
        _check("prefix cache stats", cached.prefix_cache_stats == [3, 1],
               f"[hits, misses] {cached.prefix_cache_stats}")
        plain = _make_engine(params, cfg, root, **kw)
        want = [plain.ground(q) for q in gq[1:4]]
        diff = max(_scores_diff(a, b) for (a, _), (b, _)
                   in zip(cached.grounded[1:], want))
        same = all(int(np.argmax(a)) == int(np.argmax(b)) for (a, _), (b, _)
                   in zip(cached.grounded[1:], want))
        print(f"  {kv_cache_dtype} cache: hits vs the full forward over raw "
              f"K/V, max |d| {diff:.2e}, argmax equal: {same}; seconds: "
              f"miss {times[0]:.4f}, hits "
              f"{[round(t, 4) for t in times[1:]]}", flush=True)
        return launches

    plain = _make_engine(params, cfg, root, **kw)
    mq = _ground_queries(info, M3DR_TEXTS, "m3dr", "multi3drefer")
    cq = _caption_queries(info)
    b4_file = _answer_file(root, "scanrefer_b4", params, kv_cache_dtype)
    m3dr_file = _answer_file(root, "multi3drefer", params, kv_cache_dtype)
    cap_file = _answer_file(root, "scan2cap", params, kv_cache_dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    t_prefix = run_scanrefer(cached, gq, refer_file)
    t_plain = []
    for q in gq:
        t = time.perf_counter()
        plain.ground(q)
        torch.cuda.synchronize()
        t_plain.append(time.perf_counter() - t)
    t_b4 = run_scanrefer(plain, gq[:4], b4_file, batch_size=4)
    ground_peak = torch.cuda.max_memory_allocated()
    t_m3dr = run_multi3drefer(cached, mq, m3dr_file)
    t_cap = run_scan2cap(cached, cq[:8], cap_file, coord_id, batch_size=8)
    hit_box = np.asarray(cq[8]["box_input"][:3], np.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cached.generate_answer(cq[8], hit_box, coord_id)
    torch.cuda.synchronize()
    t_cap_hit = time.perf_counter() - t
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    # what came out, and the launches
    records = {name: _read_jsonl(f) for name, f in (
        ("scanrefer", refer_file), ("scanrefer_b4", b4_file),
        ("multi3drefer", m3dr_file), ("scan2cap", cap_file))}
    n_obj = len(info["boxes"])
    _check("grounding and caption records", [len(r) for r in
                                             records.values()] == [6, 4, 4, 8]
           and all(len(r["pred_response"]) == 6
                   for r in records["scanrefer"] + records["scanrefer_b4"])
           and all(len(r["scores"]) == len(r["objects"]) + 1 == n_obj + 1
                   for r in records["multi3drefer"])
           and all(isinstance(r["pred_response"], str)
                   for r in records["scan2cap"]),
           f"{[len(r) for r in records.values()]} jsonl records")
    _check("prefix cache stats", cached.prefix_cache_stats == [18, 1],
           f"[hits, misses] {cached.prefix_cache_stats} (5 + 4 grounding "
           f"hits, a B=8 and a B=1 caption suffix over the grounding miss's "
           f"prefix)")
    rows = [int(r.tokens.shape[0]) for r in cached.results]
    _check("caption generate calls", rows == [8, 1],
           f"batch rows {rows} (the B=8 suffix batch, the B=1 hit)")
    forwards = _decode_forwards(cached.results, cfg.llm.vocab_size)
    expected = _expected_launches(
        params, kv_cache_dtype, L, forwards, cached.results,
        flash_attention=8 * L, flash_attention_folded=10 * L,
        shared_prefix_attention=L)
    _check("launch counts", launches == expected,
           f"{launches}, expected {expected} (B2: the miss, 6 full forwards "
           f"and the B=4 prefill; B2 folded: 9 grounding hits and the B=1 "
           f"caption; B5: the B=8 captions; {forwards} decode forwards)")

    # the hits and the batch against the full forward of the same queries
    _check_grounded("prefix hits vs the full forward",
                    cached.grounded[1:6], plain.grounded[1:6], info)
    _check_grounded("the miss (cached prefill) vs the full forward",
                    cached.grounded[:1], plain.grounded[:1], info)
    _check_grounded("the B=4 batch vs B=1", plain.grounded[6:10],
                    plain.grounded[:4], info)
    batch, coords, boxes, valid, slot, n = _ground_inputs(plain, gq[1])
    with torch.inference_mode():
        early = plain._compact(lv3d.grounding_forward(
            params, cfg, batch, coords, boxes, valid, slot - 1), n)
    hit, full_scores = cached.grounded[1][0], plain.grounded[1][0]
    control = _scores_diff(hit, early)
    reversed_ = _scores_diff(hit[:n], full_scores[:n][::-1])
    _check("grounding control, the query one position before <ground>",
           control >= 4 * GROUND_SCORE_ATOL,
           f"max |d| {control:.2e} (must be >= {4 * GROUND_SCORE_ATOL:.0e}); "
           f"the objects in reversed order read {reversed_:.2e}")

    # the object cache against the features a miss recomputes; the mask's
    # and one full grounding call's transient memory
    batch, coords, boxes, valid, slot, n = _ground_inputs(cached, gq[0])
    with torch.inference_mode():
        _, _, again = lv3d.grounding_forward_cached(
            params, cfg, batch, coords, boxes, valid, slot,
            batch.text_ids.shape[1], cached.cache_dtype)
    feats = cached._ground_obj_cache[info["sample_idx"]][0]
    _check("object cache vs recomputed features", torch.equal(feats, again),
           f"({tuple(feats.shape)} {feats.dtype}) bit for bit: "
           f"{torch.equal(feats, again)}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    side = cfg.vision.num_patches_per_side
    masks = lv3d.object_patch_masks(coords, boxes,
                                    cfg.world_3d.object_feature_type,
                                    side=side,
                                    patch_px=coords.shape[-3] // side)
    mask_peak = torch.cuda.max_memory_allocated() - base
    one_object = coords.shape[0] * side * side \
        * (coords.shape[-3] // side) ** 2 * 3
    del masks
    torch.cuda.reset_peak_memory_stats()
    plain.ground(gq[0])
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated() - base

    # the captions: first-step logits against a full prefill with the box,
    # and the box PE at its slot
    pairs = (("B=8 row 0", cq[0], cached.first_logits[0][0]),
             ("B=1 hit", cq[8], cached.first_logits[1][0]))
    for name, q, got in pairs:
        box = np.asarray(q["box_input"][:3], np.float32)
        fb, vf = cached._prepare_generation(q, box, coord_id)
        max_len = fb.text_ids.shape[1] + MAX_NEW
        with torch.inference_mode():
            ref, _, _ = gen.prefill_multimodal(params, cfg, fb, max_len, vf,
                                               cached.cache_dtype)
            moved_b, _ = cached._prepare_generation(
                q, box + np.float32(1.0), coord_id)
            moved, _, _ = gen.prefill_multimodal(params, cfg, moved_b,
                                                 max_len, vf,
                                                 cached.cache_dtype)
        diff = float((got - ref[0].float()).abs().max())
        control = float((got - moved[0].float()).abs().max())
        _check(f"caption first-step logits vs full prefill ({name})",
               diff <= LOGIT_ATOL and bool(torch.isfinite(got).all()),
               f"max |d| {diff:.4f} (bound {LOGIT_ATOL}; |logits| up to "
               f"{float(ref.abs().max()):.2f})")
        # one token's PE moves the random model's logits less than the bound
        # does: printed, and the PE itself is held at its slot below
        print(f"  control ({name}), the box 1 m further on each axis: max "
              f"|d| {control:.4f} ({control / LOGIT_ATOL:.1f}x the bound: "
              f"too small to hold, so the box PE is checked at its slot)",
              flush=True)
    with torch.inference_mode():
        emb = params["llm"]["embed_tokens"]
        dummy = torch.zeros((1, 1, emb.shape[-1]), dtype=emb.dtype,
                            device=dev)
        args = (fb.text_ids, fb.kind, torch.zeros_like(fb.vision_index))
        with_box = lv3d.assemble_embeds(params, cfg, dummy, *args,
                                        fb.coord_mask, fb.box_input)
        without = lv3d.assemble_embeds(params, cfg, dummy, *args)
        pe = sin3d_position_embedding(fb.box_input[:, None].float(),
                                      cfg.llm.hidden_size,
                                      cfg.world_3d.pe_temperature)[0, 0]
        moved_pe = sin3d_position_embedding(
            moved_b.box_input[:, None].float(), cfg.llm.hidden_size,
            cfg.world_3d.pe_temperature)[0, 0]
    slot_c = int(fb.coord_mask[0].nonzero()[0, 0])
    delta = (with_box - without)[0].float()
    pe_err = float((delta[slot_c] - pe.to(emb.dtype).float()).abs().max())
    pe_ctl = float((delta[slot_c] - moved_pe).abs().max())
    others = bool((delta[torch.arange(delta.shape[0], device=dev)
                         != slot_c] == 0).all())
    _check("the box PE at the <coord> slot", pe_err <= BOX_PE_ATOL and others
           and int(fb.coord_mask.sum()) == 1 and pe_ctl >= 4 * BOX_PE_ATOL,
           f"max |d| {pe_err:.2e} (bound {BOX_PE_ATOL:.0e}), every other "
           f"slot unchanged: {others}; control, the box moved 1 m: "
           f"{pe_ctl:.3f} (must be >= {4 * BOX_PE_ATOL:.0e})")

    # the scoring protocols on the jsonl files (random weights: printed)
    print(f"  scanrefer_metrics: "
          f"{protocols.scanrefer_metrics(records['scanrefer'])}", flush=True)
    print(f"  multi3drefer_metrics: "
          f"{protocols.multi3drefer_metrics(records['multi3drefer'])}",
          flush=True)
    cap = protocols.scan2cap_metrics(records["scan2cap"])
    print(f"  scan2cap_metrics: "
          f"{ {k: v for k, v in cap.items() if k != 'meteor_provenance'} }",
          flush=True)
    print(f"  seconds per query (prep excluded): ScanRefer miss "
          f"{t_prefix[0]:.4f}, hits {[round(x, 4) for x in t_prefix[1:]]}; "
          f"full forward (video IO and coordinates included) "
          f"{[round(x, 4) for x in t_plain]}; B=4 batch {t_b4[0]:.4f} per "
          f"query; Multi3DRefer hits {[round(x, 4) for x in t_m3dr]}; "
          f"Scan2Cap {t_cap[0]:.4f} per caption at B=8 (32 tokens), the B=1 "
          f"hit {t_cap_hit:.4f}; wall {wall:.2f} s", flush=True)
    print(f"  peak device memory: grounding runs {ground_peak / 2**30:.2f} "
          f"GiB, the phase {peak / 2**30:.2f} GiB; over the "
          f"{base / 2**30:.2f} GiB held, one full grounding call "
          f"{call_peak / 2**30:.2f} GiB, the {n} objects' masks "
          f"{mask_peak / 2**30:.3f} GiB (one broadcast would hold "
          f"{3 * n * one_object / 2**30:.2f} GiB of bool temporaries)",
          flush=True)
    return launches


# phase 13: sampling, beam search and the batcher's box inputs, on phase
# 4's bf16 model (the reference's eval kwargs: temperature, top_p, top_k,
# num_beams)
SAMPLING = {"temperature": 0.7, "top_p": 0.9, "top_k": 50}
BEAMS = 4
# a beam's best hypothesis's score (its summed log-probabilities over its
# generated length) against a teacher-forced recompute of the same tokens:
# the prompt's full prefill and one cached forward of the hypothesis (B2
# and B2 folded), where the beam scored them one step at a time at B*K
# rows (B3). The control scores each token one position late and must read
# at least 4x the bound. On an H100 80GB HBM3 (700 W) the B=1 answer read
# 0.0000, the B=2 batch 0.0088, phase 6's over the int8 cache 0.0058, the
# controls at least 0.97.
BEAM_SCORE_ATOL = 0.05


def _launch_delta(before: dict) -> dict:
    from video3d_tpu_torch.kernels import _build

    return {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}


def _add_launches(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def _sampled_steps(params, cfg, state, eos: int, steps: int):
    """``steps`` sampled steps of ``state`` one uncaptured decode chunk at a
    time: (tokens (B, steps), draws outside their step's warped support
    among the live rows)."""
    import torch

    from video3d_tpu_torch.models import generate as gen

    toks, outside = [], 0
    with torch.inference_mode():
        for _ in range(steps):
            warped = gen.warp_logits(state.next_logits, **SAMPLING)
            live = ~state.done
            _, tok = gen.decode_chunk(params, cfg, state, 1, eos,
                                      capture=False, **SAMPLING)
            picked = warped[torch.arange(tok.shape[0], device=tok.device),
                            tok[:, 0]]
            outside += int((~torch.isfinite(picked) & live).sum())
            toks.append(tok)
    return torch.cat(toks, 1), outside


def _teacher_forced(params, cfg, batch, vf, cache_dtype, seq):
    """Log-probabilities of the ids ``seq`` after a B=1 prompt, by its full
    prefill and one cached forward of ``seq``: (each id at its position,
    each id one position late), both (len(seq),) float32."""
    import torch

    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2

    n = len(seq)
    dev = batch.text_ids.device
    logp = torch.log_softmax(_logits_along(params, cfg, batch, vf,
                                           cache_dtype, seq), -1)
    ids = torch.tensor(seq, device=dev)
    rows = torch.arange(n, device=dev)
    return logp[rows, ids], logp[rows + 1, ids]


def _logits_along(params, cfg, batch, vf, cache_dtype, seq):
    """(len(seq) + 1, V) float32 logits after a B=1 prompt and each prefix
    of the ids ``seq``: its full prefill and one cached forward of ``seq``
    (padded to a multiple of 64, B2 folded)."""
    import torch

    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2

    n = len(seq)
    chunk = max(64, -(-n // 64) * 64)     # a suffix bucket's multiple
    dev = batch.text_ids.device
    with torch.inference_mode():
        first, cache, pos = gen.prefill_multimodal(
            params, cfg, batch, batch.text_ids.shape[1] + chunk, vf,
            cache_dtype)
        if n == 0:
            return first.float()
        ids = torch.tensor([seq + seq[-1:] * (chunk - n)], device=dev)
        at = (pos.long() + torch.arange(chunk, device=dev))[None]
        hidden = qwen2.qwen2_forward(
            params["llm"], cfg.llm, qwen2.embed_tokens(params["llm"], ids),
            at[..., None].expand(1, chunk, 3), kv_cache=cache,
            cache_positions=at, kv_len=pos + n, contiguous_update=True)
        return torch.cat([first[:, None],
                          qwen2.lm_head(params["llm"], hidden[:, :n])],
                         1)[0].float()


def _check_beam_scores(name, params, cfg, engine, questions, res,
                       bound: Optional[float] = BEAM_SCORE_ATOL) -> None:
    """Each row's best hypothesis against :func:`_teacher_forced`, held to
    ``bound`` with its control at 4x (None: printed, not held)."""
    import torch

    eos = engine.ecfg.eos_token_id
    lp = engine.ecfg.length_penalty
    diffs, controls = [], []
    for b, q in enumerate(questions):
        n = int(res.lengths[b])
        seq = res.tokens[b, :n].tolist()
        if n < res.steps:
            seq.append(eos)   # ended by EOS (finalized beams have `steps`)
        batch, vf = engine._prepare_generation(q)
        at, late = _teacher_forced(params, cfg, batch, vf,
                                   engine.cache_dtype, seq)
        norm = float(len(seq)) ** lp
        want = float(at.sum()) / norm
        diffs.append(abs(float(res.scores[b]) - want))
        controls.append(abs(float(res.scores[b]) - float(late.sum()) / norm))
        _check(f"{name} row {b}: score finite", bool(torch.isfinite(
            res.scores[b])), f"{float(res.scores[b]):.4f} over {len(seq)} "
            f"generated ids")
    scores = [round(float(s), 4) for s in res.scores]
    if bound is None:
        print(f"  {name}: best hypotheses' scores {scores} vs a "
              f"teacher-forced recompute, max |d| {max(diffs):.4f}; each id "
              f"scored one position late, min |d| {min(controls):.4f}",
              flush=True)
        return
    _check(f"{name}: best hypotheses' scores vs a teacher-forced recompute",
           max(diffs) <= bound,
           f"max |d| {max(diffs):.4f} (bound {bound}); scores {scores}")
    _check(f"{name}: control, each id scored one position late",
           min(controls) >= 4 * bound,
           f"min |d| {min(controls):.4f} (must be >= {4 * bound})")


def run_decode_modes(params, cfg, root: str, info, ground_info,
                     greedy_results) -> dict:
    """Phase 13 on phase 4's model: the engine's answers at temperature 0
    with top-p / top-k set (phase 4's greedy ids), sampled answers at B=1
    and in a B=8 scene-prefix batch (captured against an uncaptured
    per-step loop, token for token, every draw inside its step's warped
    support), beam search at K=BEAMS over B=1 and B=2 (scores against a
    teacher-forced recompute), and 8 Scan2Cap captions with their boxes
    through the paged batcher (first-step logits against the engine's full
    prefill with the box). Returns the launch counts of those runs."""
    import numpy as np
    import torch

    from fixtures import FakeTokenizer

    from video3d_tpu_torch.eval.drivers import run_generative
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import beam_search as bs
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2
    from video3d_tpu_torch.serve.batcher import ContinuousBatcher

    L = cfg.llm.num_hidden_layers
    vocab = cfg.llm.vocab_size
    launches: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qs = _questions(info["sample_idx"], SCANQA_TEXTS, "smoke")

    # temperature 0 with top-p / top-k set: phase 4's greedy ids
    eng0 = _make_engine(params, cfg, root, temperature=0.0, top_p=0.9,
                        top_k=50)
    before = dict(_build.LAUNCHES)
    for q in qs:
        eng0.generate_answer(q)
    _add_launches(launches, _launch_delta(before))
    same = all(torch.equal(a.tokens, b.tokens)
               and torch.equal(a.lengths, b.lengths)
               for a, b in zip(eng0.results, greedy_results))
    _check("temperature 0 (top_p 0.9, top_k 50): phase 4's greedy ids",
           same and len(eng0.results) == len(greedy_results) == 2,
           f"ids bit for bit: {same}")

    # sampled answers at B=1 (no caches), captured
    eng = _make_engine(params, cfg, root, **SAMPLING)
    eos = eng.ecfg.eos_token_id
    eng.generate_answer(qs[0])               # warm-up and capture
    eng.results.clear()
    before = dict(_build.LAUNCHES)
    for q in qs:
        eng.generate_answer(q)
    part = _launch_delta(before)
    _add_launches(launches, part)
    forwards = _decode_forwards(eng.results, vocab)
    expected = _expected_launches(params, "bfloat16", L, forwards,
                                  eng.results, fused_geometry=2,
                                  flash_attention=2 * L)
    _check("sampled B=1 answers: launch counts", part == expected,
           f"{part}, expected {expected} ({forwards} decode forwards)")
    for i, q in enumerate(qs):
        b, vf = eng._prepare_generation(q)
        state = gen.start_decode(params, cfg, b, b.text_ids.shape[1]
                                 + MAX_NEW, vf, eng.cache_dtype)
        toks, outside = _sampled_steps(params, cfg, state, eos, MAX_NEW)
        got = eng.results[i]
        _check(f"sampled answer {i} (B=1): captured vs an uncaptured "
               f"per-step loop", torch.equal(got.tokens, toks)
               and outside == 0,
               f"ids token for token: {torch.equal(got.tokens, toks)} "
               f"(length {got.lengths.tolist()}); draws outside the warped "
               f"support: {outside}")
    differs = any(not torch.equal(a.tokens, b.tokens)
                  for a, b in zip(eng.results, greedy_results))
    print(f"  sampled B=1 answers differ from the greedy ones: {differs}",
          flush=True)

    # sampled in a B=8 scene-prefix batch: a miss stores the prefix, then 8
    # questions as one B=8 suffix batch
    peng = _make_engine(params, cfg, root, prefix_cache_scenes=1,
                        scene_cache_scenes=1, **SAMPLING)
    pq = _questions(info["sample_idx"], PREFIX_TEXTS, "sampled")
    before = dict(_build.LAUNCHES)
    peng.generate_answer(pq[0])
    run_generative(peng, pq[1:9], os.path.join(root, "sampled_b8.jsonl"),
                   batch_size=8)
    part = _launch_delta(before)
    _add_launches(launches, part)
    rows = [int(r.tokens.shape[0]) for r in peng.results]
    _check("sampled prefix run: generate calls", rows == [1, 8]
           and peng.prefix_cache_stats == [8, 1],
           f"batch rows {rows}, [hits, misses] {peng.prefix_cache_stats}")
    forwards = _decode_forwards(peng.results, vocab)
    expected = _expected_launches(params, "bfloat16", L, forwards,
                                  peng.results, fused_geometry=1,
                                  flash_attention=L,
                                  shared_prefix_attention=L)
    _check("sampled prefix run: launch counts", part == expected,
           f"{part}, expected {expected} ({forwards} decode forwards)")
    prep = peng.prepare_answers_batch_prefix(pq[1:9])
    entry = prep["entry"]
    state = gen.start_decode_prefix(
        params, cfg, prep["batch"], entry.cache, entry.prefix_len,
        prep["bucket"] + MAX_NEW, peng.cache_dtype)
    with torch.inference_mode():
        timing_state = _clone_state(state)
        greedy_state = _clone_state(state)
    toks, outside = _sampled_steps(params, cfg, state, eos, MAX_NEW)
    got = peng.results[1]
    _check("sampled B=8 suffix batch: captured vs an uncaptured per-step "
           "loop", torch.equal(got.tokens, toks) and outside == 0,
           f"ids token for token: {torch.equal(got.tokens, toks)} (lengths "
           f"{got.lengths.tolist()}); draws outside the warped support: "
           f"{outside}")
    del state

    # sampled against greedy decode, per step, captured, from one B=8 state;
    # and the warpers and the draw alone against the greedy argmax
    walls = {}
    for tag, st, kw in (("greedy", greedy_state, {}),
                        ("sampled", timing_state, SAMPLING)):
        # the first call binds the state's cache as its entry's own (and
        # captures a new key); the timed second call reads it in place
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = gen.generate_from_state(params, cfg, st, MAX_NEW, eos,
                                          graphs=peng._graphs, **kw)
            torch.cuda.synchronize()
        walls[tag] = (time.perf_counter() - t0) / _forwards(res) * 1e3
    pick_ms = {}
    g = torch.Generator(device="cuda").manual_seed(13)
    for rows_ in (1, 8):
        logits = torch.randn(rows_, vocab, device="cuda", generator=g)
        step = torch.zeros((), dtype=torch.long, device="cuda")
        sampled = gen.Sampling(**SAMPLING)
        pick_ms[rows_] = (
            _median_ms(lambda: gen.sample_token(logits, gen.GREEDY, step),
                       30),
            _median_ms(lambda: gen.sample_token(logits, sampled, step), 30))
    print(f"  B=8 decode, captured: greedy {walls['greedy']:.2f} ms/step, "
          f"sampled {walls['sampled']:.2f} ms/step (temperature "
          f"{SAMPLING['temperature']}, top_p {SAMPLING['top_p']}, top_k "
          f"{SAMPLING['top_k']}); the token pick alone over ({{1, 8}}, "
          f"{vocab}) f32 logits (median device ms): greedy argmax "
          f"{pick_ms[1][0]:.4f} / {pick_ms[8][0]:.4f}, warpers + sort + "
          f"draw {pick_ms[1][1]:.4f} / {pick_ms[8][1]:.4f}", flush=True)
    del timing_state, greedy_state

    # beam search at K=BEAMS: B=1 and a ragged B=2 batch, full prefills
    beng = _make_engine(params, cfg, root, num_beams=BEAMS,
                        prefix_cache_scenes=1)
    before = dict(_build.LAUNCHES)
    beng.generate_answer(qs[0])
    beng.generate_answers_batch(qs)
    part = _launch_delta(before)
    _add_launches(launches, part)
    r1, r2 = beng.results
    expected = dict.fromkeys(part, 0)
    expected.update(fused_geometry=3, flash_attention=2 * L,
                    decode_attention=L * (r1.steps + r2.steps))
    _check("beam answers: launch counts", part == expected
           and beng.prefix_cache_stats == [0, 0],
           f"{part}, expected {expected} ({r1.steps} + {r2.steps} beam "
           f"steps at {BEAMS} and {2 * BEAMS} rows); the prefix cache "
           f"bypassed: [hits, misses] {beng.prefix_cache_stats}")
    _decode_forwards([r1, r2], vocab)
    _check_beam_scores(f"beam K={BEAMS} B=1", params, cfg, beng, qs[:1], r1)
    _check_beam_scores(f"beam K={BEAMS} B=2", params, cfg, beng, qs, r2)
    # timed: the B=1 beam answer's prefill and its whole generate_beam
    # (expansion, steps, finalize) on a prepared batch; the reorder alone
    b1, vf1 = beng._prepare_generation(qs[0])
    ecfg = beng.ecfg
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.prefill_multimodal(params, cfg, b1, b1.text_ids.shape[1]
                               + MAX_NEW, vf1, beng.cache_dtype)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = bs.generate_beam(
            params, cfg, b1, num_beams=BEAMS, max_new_tokens=MAX_NEW,
            eos_token_id=eos, cache_dtype=beng.cache_dtype,
            length_penalty=ecfg.length_penalty,
            early_stopping=ecfg.early_stopping, vision_features=vf1)
        torch.cuda.synchronize()
        t_beam = time.perf_counter() - t0
        cache = qwen2.KVCache.zeros(cfg.llm, BEAMS, b1.text_ids.shape[1]
                                    + MAX_NEW, dtype=beng.cache_dtype,
                                    device=b1.text_ids.device)
        spare = qwen2.KVCache(*(None if t is None else torch.empty_like(t)
                                for t in cache))
        order = torch.tensor([0, 0, 1, 2], device=b1.text_ids.device)
        reorder_ms = _median_ms(
            lambda: bs._reorder_cache(cache, order, spare), 10)
        nbytes = bs.reorder_nbytes(cache)
        del cache, spare
    _check(f"beam K={BEAMS} B=1 again on a prepared batch",
           torch.equal(again.tokens, r1.tokens) and again.steps == r1.steps,
           f"ids bit for bit: {torch.equal(again.tokens, r1.tokens)}")
    print(f"  beam K={BEAMS} B=1: {(t_beam - t_pre) / again.steps * 1e3:.2f}"
          f" ms/step eager over {again.steps} steps (generate_beam's "
          f"{t_beam:.3f} s less a {t_pre * 1e3:.1f} ms prefill); each "
          f"step's cache reorder reads and writes {nbytes / 1e9:.3f} GB "
          f"({BEAMS} rows x {b1.text_ids.shape[1] + MAX_NEW} positions) in "
          f"{reorder_ms:.3f} ms (median device ms, "
          f"{nbytes / reorder_ms / 1e6:.0f} GB/s)", flush=True)

    # Scan2Cap captions with their boxes through the paged batcher: each
    # admission's first-step logits against the engine's full prefill with
    # the box; the control, the full prefill without the box, must be
    # further away
    coord_id = FakeTokenizer().vocab["<coord>"]
    ceng = _make_engine(params, cfg, root, prefix_cache_scenes=1)
    firsts = {}
    start = ceng.start_request

    def recording_start(prep, max_cache_len=None):
        state = start(prep, max_cache_len=max_cache_len)
        key = tuple(prep["batch"].box_input[0].tolist())
        firsts[key] = (prep["mode"], max_cache_len,
                       state.next_logits[0].float().clone())
        return state

    ceng.start_request = recording_start
    cq = _caption_queries(ground_info)[:8]
    boxes = [np.asarray(q["box_input"][:3], np.float32) for q in cq]
    bucket = _serve_footprints(ceng, cq[0])[0]
    batcher = ContinuousBatcher(ceng, num_slots=SERVE_SLOTS,
                                chunk=SERVE_CHUNK, paged=True,
                                page_size=SERVE_PAGE,
                                max_cache_len=bucket + MAX_NEW)
    before = dict(_build.LAUNCHES)
    try:
        handles = [batcher.submit(q, box_input=bx, coord_token_id=coord_id)
                   for q, bx in zip(cq, boxes)]
        texts = [h.result(ceng._decode_text, timeout=600) for h in handles]
    finally:
        batcher.shutdown()
    part = _launch_delta(before)
    _add_launches(launches, part)
    _check("box-input captions through the paged batcher",
           len(texts) == 8 and all(isinstance(t, str) for t in texts)
           and len(firsts) == 8 and part["paged_attention"] > 0,
           f"{len(texts)} captions, {len(firsts)} admissions recorded; "
           f"launches {({k: v for k, v in part.items() if v})}; [hits, "
           f"misses] {ceng.prefix_cache_stats}")
    # each admission against the engine's full prefill with the box
    # (LOGIT_ATOL), and against the same path, the same cache length,
    # outside the batcher, with the box (bit for bit) and without it (the
    # control: it must differ). A suffix path lies ~0.15 from a full
    # prefill by its own rounding, more than the box moves the logits, so
    # the full prefill without the box cannot serve as the control.
    diffs, same, controls = [], [], []
    for q, bx in zip(cq, boxes):
        fb, vf = ceng._prepare_generation(q, bx, coord_id)
        nb, _ = ceng._prepare_generation(q)
        mode, mcl, got = firsts[tuple(fb.box_input[0].tolist())]
        max_len = fb.text_ids.shape[1] + MAX_NEW
        with torch.inference_mode():
            ref, _, _ = gen.prefill_multimodal(params, cfg, fb, max_len, vf,
                                               ceng.cache_dtype)
            nobox, _, _ = gen.prefill_multimodal(params, cfg, nb, max_len,
                                                 vf, ceng.cache_dtype)
            if mode == "prefix":
                ref_same = start(ceng.prepare_request(q, bx, coord_id),
                                 max_cache_len=mcl).next_logits
                nobox = start(ceng.prepare_request(q),
                              max_cache_len=mcl).next_logits
            else:
                ref_same = ref
        diffs.append(float((got - ref[0].float()).abs().max()))
        same.append(torch.equal(got, ref_same[0].float()))
        controls.append(float((got - nobox[0].float()).abs().max()))
    _check("batcher captions: first-step logits vs the full prefill with "
           "the box", max(diffs) <= LOGIT_ATOL,
           f"max |d| {max(diffs):.4f} (bound {LOGIT_ATOL})")
    _check("batcher captions: the same path outside the batcher, with the "
           "box and without it (control)", all(same) and min(controls) > 0,
           f"with the box bit for bit: {same}; without it max |d| "
           f"{[round(c, 4) for c in controls]} (each must be > 0)")
    peak = torch.cuda.max_memory_allocated()
    print(f"  phase 13 peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    return launches


# phase 14: speculative decoding and chunked prefill, on phase 4's bf16
# model. SPEC_K (phase 3's verify shape) drafted tokens per round; the
# fast self-draft is the target's first SPEC_DRAFT_LAYERS layers with its
# head cut to SPEC_DRAFT_VOCAB tokens
SPEC_DRAFT_LAYERS = 4
SPEC_DRAFT_VOCAB = 32768
CHUNK_LENS = (512, 2048)       # start_request_chunked's chunk lengths
SERVE_CHUNKED = 512            # the chunked batcher's chunk
# phase 14's traffic adds to phase 8's requests one stream of this many
# tokens, submitted first, so that decode still runs when the second
# wave's cold admission comes (phase 8's answers are over by then); EOS is
# off there, so every request runs to its budget
LONG_BUDGET = 32 * MAX_NEW
SPEC_SERVE_ROUNDS = 2          # speculative rounds per batcher chunk
# the shifted-draft control: each draft id replaced by the next vocabulary
# id, with the full-depth self-draft (whose drafts are the target's own
# ids); at least this share of rounds must reject the first draft
SHIFT_REJECT_MIN = 0.9
# Greedy speculation against phase 4's greedy ids: the verify block runs B2
# folded, a plain step B3, with other bf16 reduction orders. Phase 14
# measures both paths' logits along phase 4's ids (one-token steps against
# verify-shaped blocks of K+1) and takes twice their largest distance as
# the near-tie bound: the ids may differ first only where the two ids'
# logits lie within it. Two paths that round differently in every layer
# (a suffix over the cached prefix or a chunked prefill against a full
# prefill, the paged verify's plain gather against B2 folded) are held to
# twice the suffix path's LOGIT_ATOL instead.
CROSS_TIE = 2 * LOGIT_ATOL


def _with_eos(ids, eos: int, budget: int):
    """An answer's ids with its EOS when it ended before ``budget``."""
    ids = [int(t) for t in ids][:budget]
    return ids + [eos] if len(ids) < budget else ids


def _first_mismatch(a, b) -> Optional[int]:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _near_tie_check(name: str, params, cfg, engine, q, want, got,
                    bound: float, logits=None) -> bool:
    """``got`` equals ``want`` (id lists with their EOS) up to a near-tie:
    at the first position where they differ, the two ids' logits,
    recomputed along the common prefix by a full prefill and one cached
    forward (or read from ``logits`` (n, V) along ``want``), lie within
    ``bound``. Returns whether the ids were equal."""
    m = _first_mismatch(want, got)
    if m is None:
        _check(name, len(want) == len(got),
               f"the same {len(want)} ids")
        return True
    if logits is None:
        batch, vf = engine._prepare_generation(q)
        logits = _logits_along(params, cfg, batch, vf, engine.cache_dtype,
                               want[:m])
    row = logits[m]
    gap = float((row[want[m]] - row[got[m]]).abs())
    top2 = row.topk(2).values
    _check(name, gap <= bound,
           f"equal up to position {m}, where {want[m]} and {got[m]} lie "
           f"{gap:.4f} apart (the near-tie bound {bound:.4f}; the top-2 gap "
           f"there {float(top2[0] - top2[1]):.4f})")
    return False


def _b3_b2_logits(params, cfg, batch, vf, seq, K: int):
    """Logits predicting each id of ``seq`` after a B=1 prompt, (n, V)
    float32 twice: row 0 the prefill's, the rest by one-token steps (B3)
    and by verify-shaped blocks of K+1 ids at the prompt's end (B2
    folded), each over its own copy of the prefilled cache."""
    import torch

    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2

    llm, n = params["llm"], len(seq)
    dev = batch.text_ids.device
    with torch.inference_mode():
        first, cache, pos = gen.prefill_multimodal(
            params, cfg, batch, batch.text_ids.shape[1] + n + K + 2, vf,
            torch.bfloat16)
        blocks = qwen2.KVCache(*(None if t is None else t.clone()
                                 for t in cache))
        ids = torch.tensor([seq + seq[-1:] * (K + 1)], device=dev)
        steps, verify = [first.float()], [first.float()]
        for t in range(n - 1):
            p = pos.long()[:, None] + t
            h = qwen2.qwen2_forward(
                llm, cfg.llm, qwen2.embed_tokens(llm, ids[:, t:t + 1]),
                gen._decode_position_ids(p), kv_cache=cache,
                cache_positions=p, kv_len=p[:, 0] + 1)
            steps.append(qwen2.lm_head(llm, h)[:, 0].float())
        for s0 in range(0, n - 1, K + 1):
            bpos = pos.long()[:, None] + s0 + torch.arange(K + 1, device=dev)
            h = qwen2.qwen2_forward(
                llm, cfg.llm, qwen2.embed_tokens(llm, ids[:, s0:s0 + K + 1]),
                gen._decode_position_ids(bpos), kv_cache=blocks,
                cache_positions=bpos, kv_len=bpos[:, -1] + 1)
            verify.append(qwen2.lm_head(llm, h)[0, :min(K + 1, n - 1 - s0)]
                          .float())
    return torch.cat(steps), torch.cat(verify)


@contextlib.contextmanager
def _spec_recorder():
    """Records every SpecResult of ``generate_speculative``, the
    acceptance count ``a`` of every verify round and, for every greedy
    rejection (a row with a < K), the verify block's logit gap there
    between the target's id and the rejected draft id, while active."""
    import torch

    from video3d_tpu_torch.models import speculative as spec

    rec = {"results": [], "accepted": [], "rejected_gaps": []}
    gen_orig, acc_orig = spec.generate_speculative, spec._accept_block

    def generate(*args, **kwargs):
        res = gen_orig(*args, **kwargs)
        rec["results"].append(res)
        return res

    def accept(d, q_probs, t_logits, K, sampling, step):
        emit, a = acc_orig(d, q_probs, t_logits, K, sampling, step)
        rec["accepted"].append(a.clone())
        rows = torch.nonzero(a < K)[:, 0]
        if sampling.greedy and rows.numel():
            at = a[rows]
            row = t_logits[rows, at].float()
            gap = row.gather(1, emit[rows, at][:, None]) \
                - row.gather(1, d[rows, at][:, None])
            rec["rejected_gaps"] += gap[:, 0].tolist()
        return emit, a

    spec.generate_speculative, spec._accept_block = generate, accept
    try:
        yield rec
    finally:
        spec.generate_speculative, spec._accept_block = gen_orig, acc_orig


def _spec_expected(params, kv_cache_dtype: str, L: int, k: int,
                   results, answers: int) -> dict:
    """Launch counts of ``answers`` speculative full-prefill answers (B=1)
    whose SpecResults are ``results``: per answer B1 once and B2's prefill
    per layer (the self-draft's cache is the target's first layers,
    copied); per round K+1 draft steps of k layers (B3) and one verify
    block of L layers (B2 folded); int8 weights add B4 on the prefill's
    head, K draft heads (its matvec), the projections of the draft steps
    and of the verify block and the verify's head (its B>1 form)."""
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models.quant import is_quantized

    rounds = sum(r.target_forwards - 1 for r in results)
    form = "" if kv_cache_dtype == "bfloat16" else f"_{kv_cache_dtype}"
    expected = dict.fromkeys(_build.LAUNCHES, 0)
    expected.update({"fused_geometry": answers, "flash_attention": L * answers,
                     "decode_attention" + form: k * (SPEC_K + 1) * rounds,
                     "flash_attention_folded" + form: L * rounds})
    if is_quantized(params["llm"]["lm_head"]):
        expected["int8_matvec"] = answers + SPEC_K * rounds
        expected["int8_matmul"] = rounds * (7 * k * (SPEC_K + 1) + 7 * L + 1)
    return expected


def _chunk_expected(n_true: int, chunk_len: int, L: int, form: str,
                    int8: bool) -> dict:
    """Attention (and int8 projection) launches of a chunked prefill of
    n_true tokens: B2 folded per layer for a chunk of more than one token,
    B3 for a one-token chunk; chunks of at most 32 rows run the int8
    projections through B4's B>1 form."""
    sizes = [min(chunk_len, n_true - s) for s in range(0, n_true, chunk_len)]
    out = {"flash_attention_folded" + form: L * sum(c > 1 for c in sizes),
           "decode_attention" + form: L * sum(c == 1 for c in sizes)}
    if int8:
        out["int8_matmul"] = 7 * L * sum(c <= 32 for c in sizes)
    return out


def _spec_runs(name: str, params, cfg, engine, questions, k: int,
               kv_cache_dtype: str = "bfloat16"):
    """The engine's speculative answers to ``questions`` through
    ``generate_answer``, launch counts exact; returns (the recorder, wall
    seconds per answer, the launch counts)."""
    import torch

    from video3d_tpu_torch.kernels import _build

    L = cfg.llm.num_hidden_layers
    engine.results.clear()
    with _spec_recorder() as rec:
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in questions:
            engine.generate_answer(q)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(questions)
        part = _launch_delta(before)
    expected = _spec_expected(params, kv_cache_dtype, L, k, rec["results"],
                              len(questions))
    _check(f"{name}: launch counts", part == expected,
           f"{part}, expected {expected} "
           f"({sum(r.target_forwards - 1 for r in rec['results'])} rounds)")
    _decode_forwards(engine.results, cfg.llm.vocab_size)
    return rec, wall, part


def _spec_ms_per_token(params, cfg, engine, q) -> tuple:
    """(decode ms per emitted token, target forwards, acceptance) of one
    speculative answer on a prepared batch: ``generate_speculative``'s wall
    less its prefill's (``spec_prefill``), over the ids after the first."""
    import torch

    from video3d_tpu_torch.models import speculative as spec

    batch, vf = engine._prepare_generation(q)
    dp, dc = engine._draft()
    ecfg = engine.ecfg
    L = batch.text_ids.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec.spec_prefill(params, dp, cfg, dc, batch,
                      L + MAX_NEW + SPEC_K + 2, engine.cache_dtype, vf)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = spec.generate_speculative(
        params, dp, cfg, dc, batch, SPEC_K, MAX_NEW, ecfg.eos_token_id,
        cache_dtype=engine.cache_dtype, vision_features=vf,
        **ecfg.sampling())
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    emitted = min(MAX_NEW, int(res.lengths[0]) + 1)
    return ((t_all - t_pre) / max(emitted - 1, 1) * 1e3, res.target_forwards,
            res.accepted_drafts / max(res.offered_drafts, 1))


def _acceptance(rec) -> str:
    acc = sum(r.accepted_drafts for r in rec["results"])
    off = sum(r.offered_drafts for r in rec["results"])
    fwd = [r.target_forwards for r in rec["results"]]
    return (f"acceptance {acc}/{off} = {acc / max(off, 1):.3f}, target "
            f"forwards {fwd} (the prefill counted)")


def _spec_greedy(params, cfg, root, qs, greedy_results, b1_ms: float,
                 launches: dict) -> float:
    """Phase 14's greedy speculation through ``generate_answer``, its
    answers' launch counts added to ``launches``; returns the near-tie
    bound it measured."""
    import torch

    from video3d_tpu_torch.models import speculative as spec

    L = cfg.llm.num_hidden_layers
    V = cfg.llm.vocab_size
    ref = _make_engine(params, cfg, root)
    eos = ref.ecfg.eos_token_id
    wants, paths, deltas = [], [], []
    for q, res in zip(qs, greedy_results):
        batch, vf = ref._prepare_generation(q)
        steps, verify = _b3_b2_logits(params, cfg, batch, vf,
                                      res.tokens[0].tolist(), SPEC_K)
        deltas.append(float((steps - verify).abs().max()))
        paths.append(steps)
        wants.append(_with_eos(res.tokens[0, :int(res.lengths[0])], eos,
                               MAX_NEW))
        del verify
    tie = 2 * max(deltas)
    _check(f"B3 steps against B2 folded verify blocks (K+1 = {SPEC_K + 1}) "
           f"along phase 4's greedy ids", max(deltas) <= LOGIT_ATOL,
           f"max |d logits| {deltas} (bound {LOGIT_ATOL}) -> the near-tie "
           f"bound {tie:.4f}")

    def held(tag, engine):
        for i, (q, want) in enumerate(zip(qs, wants)):
            res = engine.results[i]
            got = _with_eos(res.tokens[0, :int(res.lengths[0])], eos,
                            MAX_NEW)
            _near_tie_check(f"{tag} answer {i} vs phase 4's greedy ids",
                            params, cfg, ref, q, want, got, tie,
                            logits=paths[i])

    # the full-depth self-draft: the target is its own draft
    full = _make_engine(params, cfg, root, speculative_draft_layers=L,
                        speculative_k=SPEC_K)
    rec, wall, part = _spec_runs("full-depth self-draft", params, cfg, full,
                                 qs, L)
    _add_launches(launches, part)
    held("full-depth self-draft", full)
    gaps = rec["rejected_gaps"]
    _check("full-depth self-draft: every rejection a near-tie",
           max(gaps, default=0.0) <= tie,
           f"{len(gaps)} rejections, the target's logit over the rejected "
           f"draft id's at most {max(gaps, default=0.0):.4f} (the near-tie "
           f"bound {tie:.4f})")
    print(f"  full-depth self-draft (k={L}, K={SPEC_K}): {_acceptance(rec)};"
          f" {wall:.3f} s per answer (generate_answer)", flush=True)
    # its control: every draft id shifted to the next vocabulary id
    draft_orig = spec._draft_block

    def shifted(*args, **kwargs):
        d, probs = draft_orig(*args, **kwargs)
        return (d + 1) % V, probs

    spec._draft_block = shifted
    try:
        full.results.clear()
        with _spec_recorder() as ctl:
            full.generate_answer(qs[0])
    finally:
        spec._draft_block = draft_orig
    first = [int(a[0]) for a in ctl["accepted"]]
    share = sum(a == 0 for a in first) / max(len(first), 1)
    _check("control: full-depth self-draft with each draft id shifted by "
           "one", share >= SHIFT_REJECT_MIN,
           f"{share:.1%} of {len(first)} rounds rejected the first draft "
           f"(must be >= {SHIFT_REJECT_MIN:.0%}); {_acceptance(ctl)}")
    res = full.results[0]
    _near_tie_check("the shifted-draft run's ids vs phase 4's greedy ids",
                    params, cfg, ref, qs[0], wants[0],
                    _with_eos(res.tokens[0, :int(res.lengths[0])], eos,
                              MAX_NEW), tie, logits=paths[0])
    # the fast self-draft: 4 layers, the head cut to 32768 tokens
    fast = _make_engine(params, cfg, root,
                        speculative_draft_layers=SPEC_DRAFT_LAYERS,
                        speculative_k=SPEC_K,
                        speculative_draft_vocab=SPEC_DRAFT_VOCAB)
    rec, wall, part = _spec_runs("self-draft k=4", params, cfg, fast, qs,
                                 SPEC_DRAFT_LAYERS)
    _add_launches(launches, part)
    held(f"self-draft k={SPEC_DRAFT_LAYERS}", fast)
    print(f"  self-draft k={SPEC_DRAFT_LAYERS} (head cut to "
          f"{SPEC_DRAFT_VOCAB}), K={SPEC_K}: {_acceptance(rec)}; {wall:.3f} s"
          f" per answer (generate_answer)", flush=True)
    for tag, engine in ((f"full-depth self-draft k={L}", full),
                        (f"self-draft k={SPEC_DRAFT_LAYERS}", fast)):
        ms, fwd, acc = _spec_ms_per_token(params, cfg, engine, qs[1])
        print(f"  {tag}: decode {ms:.2f} ms per emitted token ({fwd} target "
              f"forwards, acceptance {acc:.3f}) beside phase 4's captured "
              f"{b1_ms:.2f} ms/token", flush=True)
    del full, fast
    torch.cuda.empty_cache()
    return tie


def _spec_sampled(params, cfg, root, qs, greedy_results, tie: float,
                  launches: dict) -> None:
    """Phase 14's sampled speculation: every emitted id inside its
    position's warped target support (a teacher-forced recompute; an id
    within ``tie`` of the support's edge is counted apart), budgets, and
    top_k = 1 giving phase 4's greedy ids; the answers' launch counts are
    added to ``launches``."""
    import torch

    from video3d_tpu_torch.models import generate as gen

    eng = _make_engine(params, cfg, root,
                       speculative_draft_layers=SPEC_DRAFT_LAYERS,
                       speculative_k=SPEC_K, **SAMPLING)
    eos = eng.ecfg.eos_token_id
    rec, wall, part = _spec_runs("sampled self-draft", params, cfg, eng, qs,
                                 SPEC_DRAFT_LAYERS)
    _add_launches(launches, part)
    outside = edge = total = 0
    for q, res in zip(qs, eng.results):
        n = int(res.lengths[0])
        _check("sampled answer within its budget", n <= MAX_NEW,
               f"{n} ids (budget {MAX_NEW})")
        seq = res.tokens[0, :n].tolist()
        batch, vf = eng._prepare_generation(q)
        raw = _logits_along(params, cfg, batch, vf, eng.cache_dtype, seq)[:n]
        warped = gen.warp_logits(raw, **SAMPLING)
        ids = torch.tensor(seq, device=raw.device)
        rows = torch.arange(n, device=raw.device)
        inside = torch.isfinite(warped[rows, ids])
        kept_min = torch.where(torch.isfinite(warped), raw,
                               torch.full_like(raw, float("inf"))).amin(-1)
        near = ~inside & (raw[rows, ids] >= kept_min - tie)
        outside += int((~inside & ~near).sum())
        edge += int(near.sum())
        total += n
    _check("sampled speculation: every id inside its warped target support",
           outside == 0,
           f"{total} ids, {outside} outside, {edge} outside the recomputed "
           f"support by less than the near-tie bound {tie:.4f}; "
           f"{_acceptance(rec)}; {wall:.3f} s per answer")
    top1 = _make_engine(params, cfg, root,
                        speculative_draft_layers=SPEC_DRAFT_LAYERS,
                        speculative_k=SPEC_K, temperature=0.7, top_k=1)
    _add_launches(launches, _spec_runs("sampled top_k = 1", params, cfg,
                                       top1, qs, SPEC_DRAFT_LAYERS)[2])
    for i, (q, g) in enumerate(zip(qs, greedy_results)):
        res = top1.results[i]
        _near_tie_check(f"top_k = 1 answer {i} vs phase 4's greedy ids",
                        params, cfg, top1, q,
                        _with_eos(g.tokens[0, :int(g.lengths[0])], eos,
                                  MAX_NEW),
                        _with_eos(res.tokens[0, :int(res.lengths[0])], eos,
                                  MAX_NEW), tie)


def _spec_batcher(params, cfg, root, infos, launches: dict) -> None:
    """The paged speculative batcher (8 slots, self-draft k=4) on 16
    requests over two scenes against the sequential speculative engine;
    the batcher's launch counts are added to ``launches``."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.serve.batcher import ContinuousBatcher

    kw = dict(prefix_cache_scenes=1, scene_cache_scenes=1,
              speculative_draft_layers=SPEC_DRAFT_LAYERS,
              speculative_k=SPEC_K)
    ref = _make_engine(params, cfg, root, **kw)
    eng = _make_engine(params, cfg, root, **kw)
    scenes = [_questions(info["sample_idx"], PREFIX_TEXTS[:8], f"spec{i}_")
              for i, info in enumerate(infos)]
    eos = ref.ecfg.eos_token_id
    for e in (ref, eng):
        for wave in scenes:
            for q in wave:
                e._tokenize_prompt(q)
    wants = []
    for wave in scenes:
        for q in wave:
            ref.generate_answer(q)
            wants.append(_with_eos(ref.decoded[-1], eos, MAX_NEW))
    batcher = ContinuousBatcher(eng, num_slots=SERVE_SLOTS,
                                chunk=SPEC_SERVE_ROUNDS, paged=True,
                                page_size=SERVE_PAGE)
    got, tokens = [], 0
    try:
        _check("speculative paged batcher", batcher.spec and batcher.paged
               and batcher.chunk_prefill == 0, f"spec {batcher.spec}")
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        for wave in scenes:
            handles = [batcher.submit(q) for q in wave]
            for h in handles:
                h.result(eng._decode_text, timeout=600)
                got.append(_with_eos(h.tokens, eos, MAX_NEW))
                tokens += len(h.tokens)
        wall = time.perf_counter() - t0
        drained = _wait_for(lambda: all(s is None for s in batcher.slots))
        _add_launches(launches, _launch_delta(before))
        held = sum(len(sh["pages"]) for sh in batcher._shared.values())
        free = batcher._alloc.available
    finally:
        batcher.shutdown()
    _check("speculative batcher: every page back", drained
           and free + held == batcher.total_pages - 1,
           f"available {free} + {held} held by the cached scene's shared "
           f"prefix of {batcher.total_pages - 1}")
    _check("speculative batcher: [hits, misses], shared admissions",
           eng.prefix_cache_stats == ref.prefix_cache_stats == [14, 2],
           f"{eng.prefix_cache_stats} (sequential {ref.prefix_cache_stats}),"
           f" shared {batcher.prefix_share_stats}")
    equal = 0
    for i, (q, want, g) in enumerate(zip(scenes[0] + scenes[1], wants, got)):
        equal += _near_tie_check(
            f"speculative batcher request {i} vs the sequential engine",
            params, cfg, ref, q, want, g, CROSS_TIE)
    print(f"  speculative paged batcher: 16 requests, {tokens} tokens in "
          f"{wall:.3f} s ({tokens / wall:.1f} tokens/s over 8 slots); "
          f"{equal} of 16 answers equal id for id", flush=True)
    del batcher, ref, eng
    torch.cuda.empty_cache()


def _chunked_vs_atomic(params, cfg, root, info, launches: dict) -> float:
    """start_request_chunked at CHUNK_LENS against start_request on one
    question, the chunked runs' launch counts (chunks and their decode)
    exact and added to ``launches``; returns the largest first-step
    distance."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import generate as gen

    L = cfg.llm.num_hidden_layers
    eng = _make_engine(params, cfg, root)
    eos = eng.ecfg.eos_token_id
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "chunked")[0]
    prep = eng.prepare_request(q)
    n_true = int(prep["batch"].seq_len[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = eng.start_request(prep)
    torch.cuda.synchronize()
    t_atomic = time.perf_counter() - t0
    first = full.next_logits.float().clone()
    res = gen.generate_from_state(params, cfg, full, MAX_NEW, eos,
                                  graphs=eng._graphs)
    want = _with_eos(res.tokens[0, :int(res.lengths[0])], eos, MAX_NEW)
    worst = 0.0
    for c in CHUNK_LENS:
        before = dict(_build.LAUNCHES)
        cp = eng.start_request_chunked(prep, chunk_len=c)
        steps = []
        done = False
        while not done:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = cp.step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
        state = cp.result()
        diff = float((state.next_logits.float() - first).abs().max())
        worst = max(worst, diff)
        _check(f"chunk {c}: first-step logits vs start_request",
               diff <= LOGIT_ATOL, f"max |d| {diff:.4f} (bound {LOGIT_ATOL})")
        res = gen.generate_from_state(params, cfg, state, MAX_NEW, eos,
                                      graphs=eng._graphs)
        part = _launch_delta(before)
        forwards = _forwards(res)
        expected = _expected_launches(params, "bfloat16", L, forwards, [res])
        _add_launches(expected, _chunk_expected(n_true, c, L, "", False))
        _check(f"chunk {c}: launch counts (chunks and decode)",
               part == expected,
               f"{part}, expected {expected} ({forwards} decode forwards)")
        _add_launches(launches, part)
        _near_tie_check(f"chunk {c}: {MAX_NEW} greedy ids vs start_request's",
                        params, cfg, eng, q, want,
                        _with_eos(res.tokens[0, :int(res.lengths[0])], eos,
                                  MAX_NEW), CROSS_TIE)
        print(f"  chunk {c}: {len(steps) - 1} chunks of {n_true} tokens; "
              f"the tower and assembly {steps[0]:.1f} ms, the longest chunk "
              f"{max(steps[1:]):.1f} ms, in all {sum(steps):.1f} ms against "
              f"the atomic prefill's {t_atomic * 1e3:.1f} ms", flush=True)
    return worst


def _chunk_traffic(params, cfg, root, infos, chunked: int):
    """Phase 8's questions and budgets through the paged batcher (8 slots,
    pages of 128, prefix sharing, the default pool, both scenes' features
    and the first scene's prefix cached) with one LONG_BUDGET stream
    submitted first, the second wave submitted once the first streams, so
    its cold admission meets running decode. Returns (ids by request, the
    longest gap in ms between two decode chunks that share a waiting
    request over a cold admission, the decode chunks inside cold
    admissions, every page back, the engine, the batcher's launch
    counts)."""
    import threading

    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.serve.batcher import ContinuousBatcher

    engine = _make_engine(params, cfg, root, prefix_cache_scenes=1,
                          scene_cache_scenes=2)
    engine.ecfg = dataclasses.replace(engine.ecfg, eos_token_id=-1)
    scenes = [_questions(info["sample_idx"], SERVE_TEXTS, f"serve{i}_")
              for i, info in enumerate(infos)]
    waves = [scenes[s][:n] for s, n in SERVE_WAVES]
    for wave in waves:
        for q in wave:
            engine._tokenize_prompt(q)
    # both scenes' vision features and the first scene's prefix cached
    # beforehand, so the preparations are cheap and a cold admission is
    # the LLM prefill alone: otherwise the video loads and towers of the
    # preparations (two prep threads, every request of a wave a miss until
    # the first admission stores the scene) delay the second wave's cold
    # admission until the running streams are over
    engine.generate_answer(scenes[1][0])
    engine.generate_answer(scenes[0][0])
    log = {"chunks": [], "cold": []}
    start_req, start_chunked = engine.start_request, \
        engine.start_request_chunked
    finish_chunked = engine.finish_chunked
    open_jobs = {}

    def timed_start(prep, max_cache_len=None):
        misses = engine.prefix_cache_stats[1]
        t0 = time.perf_counter()
        state = start_req(prep, max_cache_len=max_cache_len)
        if engine.prefix_cache_stats[1] > misses:
            torch.cuda.synchronize()
            log["cold"].append((t0, time.perf_counter()))
        return state

    def timed_chunked(prep, max_cache_len=None, chunk_len=256):
        t0 = time.perf_counter()
        out = start_chunked(prep, max_cache_len=max_cache_len,
                            chunk_len=chunk_len)
        open_jobs[id(prep)] = t0
        return out

    def timed_finish(prep, state):
        out = finish_chunked(prep, state)
        torch.cuda.synchronize()
        log["cold"].append((open_jobs.pop(id(prep)), time.perf_counter()))
        return out

    engine.start_request = timed_start
    engine.start_request_chunked = timed_chunked
    engine.finish_chunked = timed_finish

    class Batcher(ContinuousBatcher):
        def _decode_rows(self):
            active = {id(r) for r in self.slots if r is not None}
            rows = super()._decode_rows()
            log["chunks"].append((time.perf_counter(), active))
            return rows

    batcher = Batcher(engine, num_slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
                      paged=True, page_size=SERVE_PAGE,
                      chunked_prefill=chunked)
    answers, errors = {}, []

    def run(w, i, q):
        try:
            budget = LONG_BUDGET if w == "long" \
                else SERVE_BUDGETS[i % len(SERVE_BUDGETS)]
            h = batcher.submit(q, max_new_tokens=budget)
            h.result(engine._decode_text, timeout=600)
            answers[(w, q["id"])] = (q, budget, list(h.tokens))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"wave {w} {q['id']}: {e!r}")

    try:
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run,
                                    args=("long", 0, scenes[0][0]))]
        threads[0].start()
        for w, wave in enumerate(waves):
            if w == 2:
                for t in threads:
                    t.join()
            threads_w = [threading.Thread(target=run, args=(w, i, q))
                         for i, q in enumerate(wave)]
            for t in threads_w:
                t.start()
            threads += threads_w
            if w == 0:
                # the second wave once the first has started decoding
                _wait_for(lambda: len(log["chunks"]) >= 2, 300)
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        drained = _wait_for(lambda: all(s is None for s in batcher.slots))
        held = sum(len(sh["pages"]) for sh in batcher._shared.values())
        pages_back = drained and \
            batcher._alloc.available + held == batcher.total_pages - 1
        part = _launch_delta(before)
    finally:
        batcher.shutdown()
    _check(f"traffic (chunked_prefill={chunked}): every request returned",
           not errors and len(answers) == 1 + sum(map(len, waves)),
           "; ".join(errors) or f"{len(answers)} requests")
    # a stall: two consecutive decode chunks that share a waiting request,
    # between whose ends a cold admission ran
    chunks = log["chunks"]
    gaps, inside, met = [], 0, set()
    for (a, live_a), (b, live_b) in zip(chunks, chunks[1:]):
        over = {i for i, (c0, c1) in enumerate(log["cold"])
                if c0 < b and a < c1}
        if live_a & live_b and over:
            gaps.append((b - a) * 1e3)
            met |= over
    for t, _ in chunks:
        inside += any(c0 < t < c1 for c0, c1 in log["cold"])
    colds = [round(c0 - t0, 2) for c0, _ in log["cold"]]
    print(f"  cold admissions at {colds} s, decode chunks ending from "
          f"{chunks[0][0] - t0:.2f} to {chunks[-1][0] - t0:.2f} s"
          if chunks else "  no decode chunk", flush=True)
    tokens = sum(len(ids) for _, _, ids in answers.values())
    print(f"  chunked_prefill={chunked}: {len(answers)} requests, {tokens} "
          f"tokens in {wall:.3f} s; {len(log['cold'])} cold admissions, "
          f"{len(met)} of them while requests decoded, the longest gap "
          f"between decode chunks over one "
          f"{max(gaps) if gaps else 0.0:.1f} ms, {inside} decode chunks "
          f"inside them", flush=True)
    del batcher
    return (answers, (max(gaps) if gaps else 0.0), inside, pages_back,
            engine, part)


def run_spec_chunked(params, cfg, root: str, info, infos, greedy_results,
                     b1_ms: float) -> dict:
    """Phase 14 on phase 4's model: greedy speculation through
    ``generate_answer`` (the full-depth self-draft with its shifted-draft
    control, then k=4 with a 32768-token head) against phase 4's ids by
    the near-tie rule; sampled speculation inside the warped support and
    top_k = 1 as greedy; the paged speculative batcher against the
    sequential speculative engine; start_request_chunked against
    start_request; phase 8's traffic through the paged batcher with and
    without chunked prefill (``b1_ms``: phase 4's captured ms/token).
    Returns the launch counts of those runs, the reference and check runs
    left out."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qs = _questions(info["sample_idx"], SCANQA_TEXTS, "smoke")
    total = {}
    tie = _spec_greedy(params, cfg, root, qs, greedy_results, b1_ms, total)
    _spec_sampled(params, cfg, root, qs, greedy_results, tie, total)
    print("  the paged speculative batcher:", flush=True)
    _spec_batcher(params, cfg, root, infos, total)
    print("  chunked prefill against the atomic prefill:", flush=True)
    worst = _chunked_vs_atomic(params, cfg, root, info, total)
    print(f"  phase 8's traffic, unchunked and chunked_prefill="
          f"{SERVE_CHUNKED}:", flush=True)
    plain, gap0, _, back0, eng0, part = _chunk_traffic(params, cfg, root,
                                                       infos, 0)
    _add_launches(total, part)
    chunked, gap1, inside, back1, _, part = _chunk_traffic(
        params, cfg, root, infos, SERVE_CHUNKED)
    _add_launches(total, part)
    _check("traffic: every page back", back0 and back1,
           f"unchunked {back0}, chunked {back1}")
    _check("chunked traffic: decode chunks ran inside a cold admission's "
           "job", inside > 0, f"{inside} decode chunks")
    eos = eng0.ecfg.eos_token_id
    equal = 0
    for key, (q, budget, ids) in plain.items():
        equal += _near_tie_check(
            f"chunked traffic {key[1]} (wave {key[0]}) vs unchunked",
            params, cfg, eng0, q, _with_eos(ids, eos, budget),
            _with_eos(chunked[key][2], eos, budget), CROSS_TIE)
    print(f"  {equal} of {len(plain)} answers equal id for id; the longest "
          f"decode stall over a cold admission {gap0:.1f} ms unchunked, "
          f"{gap1:.1f} ms with chunked_prefill={SERVE_CHUNKED}; chunked "
          f"first-step logits within {worst:.4f} of the atomic prefill's",
          flush=True)
    peak = torch.cuda.max_memory_allocated()
    smi = _card()
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s, peak device "
          f"memory {peak / 2**30:.2f} GiB; {smi}", flush=True)
    return total


def run_spec_chunked_int8(params, cfg, root: str, info,
                          greedy_results) -> dict:
    """Phase 6's speculation and chunked admission over the int8 cache:
    one greedy speculative answer (self-draft k=4), held against the int8
    ScanQA path's greedy answer (``greedy_results[0]``) by the near-tie
    rule, and one chunked admission (start_request_chunked at
    SERVE_CHUNKED, then the captured decode), its first-step logits within
    LOGIT_ATOL of the atomic prefill's; launch counts of B2 folded int8,
    B3 int8 and B4 exact. Returns the launch counts of those two runs."""
    import torch

    from video3d_tpu_torch.kernels import _build

    L = cfg.llm.num_hidden_layers
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "smoke")[0]
    eng = _make_engine(params, cfg, root, kv_cache_dtype="int8",
                       speculative_draft_layers=SPEC_DRAFT_LAYERS,
                       speculative_k=SPEC_K)
    rec, wall, total = _spec_runs("int8 speculative answer", params, cfg,
                                  eng, [q], SPEC_DRAFT_LAYERS, "int8")
    print(f"  int8 speculative answer (k={SPEC_DRAFT_LAYERS}, K={SPEC_K}): "
          f"{_acceptance(rec)}; {wall:.3f} s", flush=True)
    eos = eng.ecfg.eos_token_id
    want, got = (_with_eos(r.tokens[0, :int(r.lengths[0])], eos, MAX_NEW)
                 for r in (greedy_results[0], eng.results[0]))
    _near_tie_check("int8 speculative answer vs the int8 greedy answer",
                    params, cfg, eng, q, want, got, CROSS_TIE)
    ceng = _make_engine(params, cfg, root, kv_cache_dtype="int8")
    prep = ceng.prepare_request(q)
    n_true = int(prep["batch"].seq_len[0])
    mark = dict(_build.LAUNCHES)
    cp = ceng.start_request_chunked(prep, chunk_len=SERVE_CHUNKED)
    while not cp.step():
        pass
    state = ceng.finish_chunked(prep, cp.result())
    first = state.next_logits.float().clone()
    res = ceng._generate_from_state(state)
    part = _launch_delta(mark)
    forwards = _decode_forwards([res], cfg.llm.vocab_size)
    expected = _expected_launches(params, "int8", L, forwards, [res])
    for k, v in _chunk_expected(n_true, SERVE_CHUNKED, L, "_int8",
                                True).items():
        expected[k] = expected.get(k, 0) + v
    _check("int8 chunked admission: launch counts", part == expected,
           f"{part}, expected {expected} ({forwards} decode forwards)")
    _add_launches(total, part)
    atomic = ceng.start_request(prep).next_logits.float()
    diff = float((first - atomic).abs().max())
    _check(f"int8 chunked admission (chunks of {SERVE_CHUNKED}): first-step "
           f"logits vs the atomic prefill", diff <= LOGIT_ATOL,
           f"max |d| {diff:.4f} (bound {LOGIT_ATOL})")
    del eng, ceng, state
    torch.cuda.empty_cache()
    return total


def _wait_for(pred, seconds: float = 30.0) -> bool:
    deadline = time.time() + seconds
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def run_int8_paths(cfg, root: str, infos, ground_info) -> dict:
    """Phase 6: the int8 configuration at full width and depth (int8 LLM
    projections and lm_head from ``init_model(bits=8)``, int8 KV cache)
    through phase 4's, phase 5's and phase 8's paths and phase 12's
    ScanRefer prefix run; returns the launch counts of the four runs,
    summed, phase 11's, and the captured B=1 decode's ms per token."""
    import torch

    from video3d_tpu_torch.params import init_model

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, bits=8)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"int8 configuration: ModelConfig() {cfg.vision.num_hidden_layers}"
          f"+{cfg.llm.num_hidden_layers} layers, int8 LLM projections and "
          f"lm_head, {n_bytes / 2**30:.2f} GiB of parameters initialised "
          f"on the card in {time.perf_counter() - t0:.1f} s (init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); int8 KV "
          f"cache", flush=True)
    print("int8 ScanQA path:", flush=True)
    greedy8 = []
    scanqa, b1_ms = run_main_path(params, cfg, root, infos[0],
                                  kv_cache_dtype="int8", results=greedy8)
    print(f"  launches (int8 ScanQA path): {scanqa}", flush=True)
    print("int8 scene-prefix path:", flush=True)
    prefix = run_prefix_path(params, cfg, root, infos[0],
                             kv_cache_dtype="int8",
                             logit_atol=INT8_LOGIT_ATOL)
    print(f"  launches (int8 scene-prefix path): {prefix}", flush=True)
    print("int8 serving path:", flush=True)
    serve = run_serving(params, cfg, root, infos, kv_cache_dtype="int8")
    print(f"  launches (int8 serving path): {serve}", flush=True)
    print("int8 ScanRefer prefix path (phase 12's, 1 miss and 3 hits):",
          flush=True)
    ground = run_grounding(params, cfg, root, ground_info,
                           kv_cache_dtype="int8", full=False)
    print(f"  launches (int8 ScanRefer prefix path): {ground}", flush=True)
    print(f"int8 beam search (K={BEAMS}, B=1, phase 13's):", flush=True)
    beam = run_beam_int8(params, cfg, root, infos[0])
    print(f"  launches (int8 beam answer): {beam}", flush=True)
    print("int8 speculation and chunked admission (phase 14's):", flush=True)
    spec8 = run_spec_chunked_int8(params, cfg, root, infos[0], greedy8)
    print(f"  launches (int8 speculation and chunked admission): {spec8}",
          flush=True)
    print("benchmark paths (phase 11, on the int8 model):", flush=True)
    bench = run_bench_paths(params, cfg)
    return {k: scanqa[k] + prefix[k] + serve[k] + ground[k] + beam[k]
            + spec8.get(k, 0) for k in scanqa}, bench, b1_ms


def run_beam_int8(params, cfg, root: str, info) -> dict:
    """One beam answer (K=BEAMS) over the int8 cache with int8 weights:
    exact launch counts (B3 int8 at K rows per step, B4's B>1 form on
    every projection and K-row head, its matvec on the prefill's one-row
    head), a finite best score, and its distance to a teacher-forced
    recompute printed (the recompute attends the cache as quantized by a
    prefill and a chunk; the beam's steps attend it one step at a time)."""
    from video3d_tpu_torch.kernels import _build

    engine = _make_engine(params, cfg, root, kv_cache_dtype="int8",
                          num_beams=BEAMS)
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "beam8")[0]
    _build.reset_launches()
    engine.generate_answer(q)
    launches = dict(_build.LAUNCHES)
    (res,) = engine.results
    L = cfg.llm.num_hidden_layers
    expected = dict.fromkeys(launches, 0)
    expected.update(fused_geometry=1, flash_attention=L,
                    decode_attention_int8=L * res.steps,
                    int8_matmul=(7 * L + 1) * res.steps, int8_matvec=1)
    _decode_forwards([res], cfg.llm.vocab_size)
    _check("int8 beam answer: launch counts", launches == expected,
           f"{launches}, expected {expected} ({res.steps} beam steps at "
           f"{BEAMS} rows)")
    _check_beam_scores(f"int8 beam K={BEAMS} B=1", params, cfg, engine,
                       [q], res, bound=None)
    return launches


# phase 11: the benchmark's iterations (few: the call's time limit is
# shared with every other phase) and its 32k decode rows' chunk
BENCH_ITERS = 3
BENCH_DECODE_CHUNK = 8
#: kernels phase 11 must launch: B9's four forms, and the kernels of the
#: benchmark's modes (steady state and chain: B1, B2; prefix: B5 int8;
#: ctx32k: B2 folded int8; the 32k decode rows: B3 int8, B7 int8, B4)
BENCH_KERNELS = PROBE_KERNELS + (
    "fused_geometry", "flash_attention", "shared_prefix_attention_int8",
    "flash_attention_folded_int8", "decode_attention_int8",
    "paged_attention_int8", "int8_matvec", "int8_matmul")


def run_bench_paths(params, cfg) -> dict:
    """Phase 11: the port's benchmark on the card, on phase 6's int8 model
    (``video3d_tpu_torch/bench``): the HBM probes (B9: the bench line's
    ``measured_read_gbps``, which runs B9b-d, and B9a at 4096-token
    blocks), the bench line (steady-state and cold frames/s at
    V=8 with 4 bf16 decoder layers on a model of its own, the V=32 chain and
    the B=8 prefix on the int8 model, the live CPU baseline, the measured
    read ceiling), the flagship's stages, mc-chain (picks on the card equal
    to a CPU run on the same voxels) and ctx32k (one iteration, no warm-up),
    and the paged batcher's two 32k int8 rows with a short chunk, then
    ``bench/grounding.py``'s ``cold --batch 1`` and ``prefix --batch 8``;
    each prints its JSON line (the 32k rows captured and uncaptured).
    Returns the launch counts of the run."""
    import torch

    from video3d_tpu_torch.bench import __main__ as bench
    from video3d_tpu_torch.bench import (flagship, grounding, paged_batcher,
                                         probes, timing)
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.params import init_model

    dev = params["llm"]["norm"].device
    t0 = time.perf_counter()
    _build.reset_launches()
    print("HBM probes (module 3: the bench line's read rate, and the K/V "
          "probe at 4096-token blocks; phase 3 ran every form with its "
          "controls):", flush=True)
    hbm = probes.measured_read_gbps(dev, iters=BENCH_ITERS)
    probes.probe_kv(dev, bss=(4096,), iters=BENCH_ITERS)
    torch.cuda.empty_cache()
    info = timing.device_info(dev)
    bcfg = bench.bench_config()
    bparams = init_model(bcfg, dev, torch.Generator(device=dev).manual_seed(0),
                         torch.bfloat16)
    warm, cold = bench.bench_device(bparams, bcfg, dev, iters=BENCH_ITERS)
    del bparams
    torch.cuda.empty_cache()
    flag = bench.bench_flagship(params, cfg, dev, chain_iters=2,
                                prefix_iters=BENCH_ITERS)
    line = bench.bench_line(warm, cold, flag, bench.bench_reference_cpu(),
                            info, hbm)
    print(json.dumps(line), flush=True)
    _check("bench line", all(math.isfinite(x) for x in (
        warm, cold, line["vs_baseline"],
        flag["chain32_int8"]["frames_per_s"],
        flag["prefix32_int8_b8"]["question_ms"])),
        f"{warm:.2f} f/s steady, {cold:.2f} cold, chain "
        f"{flag['chain32_int8']['frames_per_s']:.2f} f/s (MFU "
        f"{flag['chain32_int8']['mfu_pct_bf16peak']:.2f}% of 989 TFLOP/s), "
        f"B=8 prefix {flag['prefix32_int8_b8']['question_ms']:.3f} ms per "
        f"question, HBM read {hbm} GB/s")
    for res in (flagship.run_stages(params, cfg, dev, iters=2),
                flagship.run_mc_chain(params, cfg, dev, iters=1),
                flagship.run_ctx32k(params, cfg, dev, warmup=0)):
        res["device"] = info
        print(json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    for mode, slots in (("dense", 1), ("paged", 8)):
        for capture in (True, False):
            res = paged_batcher.run(params, cfg, mode, dev, slots=slots,
                                    cache_len=32768,
                                    chunk=BENCH_DECODE_CHUNK, int8=True,
                                    capture=capture)
            res["device"] = info
            print(json.dumps(res), flush=True)
            torch.cuda.empty_cache()
    for run, B in ((grounding.run_cold, 1), (grounding.run_prefix, 8)):
        res = run(params, cfg, dev, B=B, iters=BENCH_ITERS)
        res["device"] = info
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    counts = dict(_build.LAUNCHES)
    missing = [k for k in BENCH_KERNELS if counts[k] == 0]
    _check("phase 11 launches", not missing,
           f"{ {k: counts[k] for k in BENCH_KERNELS} } (not launched: "
           f"{missing}); {time.perf_counter() - t0:.1f} s")
    return counts


def _check_int4_decode_step(params, cfg, engine, prep) -> None:
    """Phase 9: the first decode step of the prepared B=8 suffix batch
    through B8 against the same step from a copy of the same state with
    every int4 product of at most 32 rows forced through the dequantize-
    then-matmul path (the path B8 replaces); within INT4_STEP_ATOL, and the
    control (the forced path reading each weight's scales one group off)
    at least twice that."""
    import torch

    from video3d_tpu_torch.kernels import quant_matvec as qm
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2
    from video3d_tpu_torch.models.quant import dequantize_int4

    entry = prep["entry"]
    eos = engine.ecfg.eos_token_id
    with torch.inference_mode():
        state = gen.start_decode_prefix(
            params, cfg, prep["batch"], entry.cache, entry.prefix_len,
            prep["bucket"] + MAX_NEW, engine.cache_dtype)

    def dequantized(roll: int):
        def product(x, packed, scales, group=512):
            w = dequantize_int4(packed, torch.roll(scales, roll, dims=0),
                                group, torch.bfloat16)
            return (x.to(torch.bfloat16) @ w).to(x.dtype)
        return product

    def first_step(product=None):
        copy = gen.DecodeState(
            state.next_logits.clone(),
            qwen2.KVCache(*(t.clone() if t is not None else None
                            for t in state.cache)),
            state.pos.clone(), state.done.clone(), state.step.clone())
        kernel = qm.int4_matmul
        if product is not None:
            qm.int4_matmul = product
        try:
            with torch.inference_mode():
                out, _ = gen.decode_chunk(params, cfg, copy, 1, eos,
                                          capture=False)
        finally:
            qm.int4_matmul = kernel
        logits = out.next_logits.float()
        del copy, out
        torch.cuda.empty_cache()
        return logits

    got = first_step()
    ref = first_step(dequantized(0))
    ctl = first_step(dequantized(1))
    diff = float((got - ref).abs().max())
    _check(f"first decode step through B8 vs the dequantize path "
           f"(B={got.shape[0]})", diff <= INT4_STEP_ATOL
           and bool(torch.isfinite(got).all()),
           f"max |d| {diff:.4f} (bound {INT4_STEP_ATOL}; |logits| up to "
           f"{float(ref.abs().max()):.2f})")
    control = float((ctl - ref).abs().max())
    _check("first decode step control, scales one group off",
           control >= 2 * INT4_STEP_ATOL,
           f"max |d| {control:.4f} (must be >= {2 * INT4_STEP_ATOL})")
    del state


@contextlib.contextmanager
def _plain_quant_forms(roll: int = 0, storage: str = "uint8"):
    """Swap the four quantized-cache wrappers (B3, B2 folded, B5, B7) of
    one storage (``uint8``: the int4 cache; ``int8``) for their plain
    versions run in f32 on the same quantized values, output in q's dtype,
    with the scales rolled ``roll`` positions along the positions (a
    control when non-zero); other cache forms keep their kernels."""
    import torch

    from video3d_tpu_torch.kernels import decode_attention as da
    from video3d_tpu_torch.kernels import flash_attention as fa
    from video3d_tpu_torch.kernels import paged_attention as pa
    from video3d_tpu_torch.kernels.attention import \
        mha_shared_prefix_reference

    dtype = getattr(torch, storage)

    def rolled(scale, dim):
        return torch.roll(scale, roll, dims=dim)

    def swap(module, name, plain, dim):
        kernel = getattr(module, name)

        def fn(q, k, v, *args, **kwargs):
            if k.dtype != dtype:
                return kernel(q, k, v, *args, **kwargs)
            # the plain version takes the wrapper's arguments, the two
            # scales last
            *rest, ks, vs = inspect.signature(plain).bind(
                q.float(), k, v, *args, **kwargs).args
            return plain(*rest, rolled(ks, dim), rolled(vs, dim)).to(q.dtype)
        return module, name, kernel, fn

    swaps = [swap(da, "decode_attention", da.decode_attention_plain, 2),
             swap(fa, "flash_attention_gqa_folded",
                  fa.flash_attention_gqa_folded_plain, 2),
             swap(fa, "flash_attention_shared_prefix",
                  mha_shared_prefix_reference, 0),
             swap(pa, "paged_decode_attention", pa.paged_attention_plain, -1)]
    for module, name, _, fn in swaps:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, kernel, _ in swaps:
            setattr(module, name, kernel)


def _check_quant_cache_steps(params, cfg, engine, prep, hit_q,
                             atol: float, kv: str = "int4",
                             decode_step: bool = False,
                             label: str = "") -> None:
    """The first-step logits of the prepared B=8 suffix batch and of the
    B=1 hit over the quantized prefix (``decode_step``: also the logits
    after one decode step from each), through the kernels, against the
    same steps with the ``kv`` cache's forms' plain versions swapped in
    (f32); within ``atol``, and the control (the plain versions reading
    the scales one position off) at least twice that. Every run's decode
    step decodes the kernels' run's greedy tokens. Phase 10 (int4 cache)
    and phase 19 (f)."""
    import torch

    from video3d_tpu_torch.models import generate as gen

    storage = "uint8" if kv == "int4" else "int8"
    eos = engine.ecfg.eos_token_id
    hit = engine.prepare_request(hit_q)
    _check(f"{label}the B=1 question hits the {kv} prefix",
           hit["mode"] == "prefix", f"mode {hit['mode']}")

    def steps(first=None):
        """The first steps' logits (and the decode steps'); ``first``: the
        first steps' logits of the kernels' run, put in place of this
        run's before its decode step, so that every run decodes the same
        greedy tokens (a near-tie that the two first steps break apart
        would compare decode steps of different tokens)."""
        out = []
        for i, p in enumerate((prep, hit)):
            entry = p["entry"]
            with torch.inference_mode():
                state = gen.start_decode_prefix(
                    params, cfg, p["batch"], entry.cache, entry.prefix_len,
                    p["bucket"] + MAX_NEW, engine.cache_dtype)
                out.append(state.next_logits.float().clone())
                if decode_step:
                    if first is not None:
                        state.next_logits.copy_(first[2 * i])
                    state, _ = gen.decode_chunk(params, cfg, state, 1, eos,
                                                capture=False)
                    out.append(state.next_logits.float())
            del state
            torch.cuda.empty_cache()
        return out

    got = steps()
    with _plain_quant_forms(storage=storage):
        ref = steps(got)
    with _plain_quant_forms(roll=1, storage=storage):
        ctl = steps(got)
    # rows whose greedy token the plain versions' first step changes
    flips = sum(int((a.argmax(-1) != b.argmax(-1)).sum())
                for a, b in zip(got[::2 if decode_step else 1],
                                ref[::2 if decode_step else 1]))
    diffs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    diff = max(diffs)
    control = max(float((a - b).abs().max()) for a, b in zip(ctl, ref))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    what = "first-step and first-decode-step" if decode_step \
        else "first-step"
    parts = ("B=8 first step", "B=8 decode step", "hit first step",
             "hit decode step") if decode_step else ("B=8", "hit")
    _check(f"{label}{what} logits over the {kv} prefix, kernels vs their "
           f"plain versions in f32 (B={got[0].shape[0]} suffix rows, B=1 "
           f"hit)", diff <= atol and finite,
           f"max |d| {diff:.4f} ("
           + ", ".join(f"{n} {d:.4f}" for n, d in zip(parts, diffs))
           + f"; bound {atol}; |logits| up to "
           f"{max(float(a.abs().max()) for a in ref):.2f}; the plain "
           f"versions' first step changes the greedy token of {flips} "
           f"row(s)"
           + ("; every run's decode step takes the kernels' tokens"
              if decode_step else "") + ")")
    _check(f"{label}{what} logits control, plain versions with the scales "
           f"one position off", control >= 2 * atol,
           f"max |d| {control:.4f} (must be >= {2 * atol})")


def run_int4_cache_paths(params, cfg, root: str, infos) -> dict:
    """Phase 10: the int4 KV cache on phase 9's int4 model, through phase
    5's and phase 8's paths with ``kv_cache_dtype="int4"``; returns the
    launch counts of the two runs, summed."""
    print("int4 KV cache (phase 10): the int4 model, kv_cache_dtype=int4 "
          "(uint8, two channels per byte, f32 scales per token and kv "
          "head)", flush=True)
    print("int4-cache scene-prefix path:", flush=True)
    prefix = run_prefix_path(
        params, cfg, root, infos[0], kv_cache_dtype="int4", logit_atol=None,
        step_check=lambda engine, prep, hit_q: _check_quant_cache_steps(
            params, cfg, engine, prep, hit_q, INT4_CACHE_LOGIT_ATOL))
    print(f"  launches (int4-cache scene-prefix path): {prefix}", flush=True)
    print("int4-cache serving path:", flush=True)
    serve = run_serving(params, cfg, root, infos, kv_cache_dtype="int4")
    print(f"  launches (int4-cache serving path): {serve}", flush=True)
    return {k: prefix[k] + serve[k] for k in prefix}


def run_int4_paths(cfg, root: str, infos):
    """Phase 9: the int4 configuration at ``cfg``'s width and depth (int4 LLM
    projections and lm_head from ``init_model(bits=4)``, bf16 KV cache)
    through phase 4's, phase 5's and phase 8's paths, then phase 10 on the
    same model; returns the launch counts of phase 9's three runs, summed,
    and phase 10's."""
    import torch

    from video3d_tpu_torch.params import init_model

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, bits=4)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"int4 configuration: ModelConfig() {cfg.vision.num_hidden_layers}"
          f"+{cfg.llm.num_hidden_layers} layers, int4 LLM projections and "
          f"lm_head (groups of 512), {n_bytes / 2**30:.2f} GiB of parameters "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s "
          f"(init peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB);"
          f" bf16 KV cache", flush=True)
    print("int4 ScanQA path:", flush=True)
    scanqa, _ = run_main_path(params, cfg, root, infos[0])
    print(f"  launches (int4 ScanQA path): {scanqa}", flush=True)
    print("int4 scene-prefix path:", flush=True)
    prefix = run_prefix_path(
        params, cfg, root, infos[0], logit_atol=INT4_LOGIT_ATOL,
        step_check=lambda engine, prep, _: _check_int4_decode_step(
            params, cfg, engine, prep))
    print(f"  launches (int4 scene-prefix path): {prefix}", flush=True)
    print("int4 serving path:", flush=True)
    serve = run_serving(params, cfg, root, infos)
    print(f"  launches (int4 serving path): {serve}", flush=True)
    int4_cache = run_int4_cache_paths(params, cfg, root, infos)
    return {k: scanqa[k] + prefix[k] + serve[k] for k in scanqa}, int4_cache


TRAIN_LAYERS = 4        # decoder depth of phase 7 (widths are Qwen2-7B's)
TRAIN_MINI_STEPS = 4    # at gradient_accumulation_steps 2: two updates
# phase 7's records: two ScanQA questions and two ScanRefer queries on the
# grounding scene (object ids of its proposals), in the seeded order
TRAIN_QA = ("What is object 0 ?", "What is object 1 ?")
TRAIN_REFER = (("Find the brown chair next to the desk.", 3),
               ("The lamp on the nightstand.", 17))
# phase 7's V=8 mini-steps through the kernels against the same mini-steps
# with the plain attention (B2 / B6's plain versions in f32 on the same
# bf16 values) swapped in by this script: the loss and the global gradient
# norm within these relative bounds, and the gradient tree within
# TRAIN_GRAD_REL in relative L2 norm. The LM mini-step's control, the plain
# attention without its causal mask, must miss each by at least twice.
TRAIN_LOSS_REL = 2e-3
TRAIN_GN_REL = 2e-2
TRAIN_GRAD_REL = 5e-2
# the ground mini-step's bounds (loss, grad_norm, gradients), measured: on
# an H100 80GB HBM3 (700 W) it read 4.15e-4, 2.25e-3 and 8.86e-2 in two
# runs (its gradient reaches the model through one query position, so B6's
# bf16 P and dS weigh more than in the LM step's 9.2e-3). Its control must
# miss each by 4x: the plain attention reading every query head's keys and
# values from the next kv head (a GQA mapping off by one) read 7.94e-3,
# 1.68e-1 and 1.32. Without the causal mask the loss moved only 2.9e-3:
# the <ground> query sits at the end of the prompt and sees nearly every
# key either way, and random weights' cosines barely move the loss.
GROUND_TRAIN_REL = (1.5e-3, 1e-2, 2e-1)


def _plain_train_attention(causal: bool = True, roll_kv: int = 0,
                           roll_pos: int = 0, scale_q: float = 1.0):
    """``mha_train`` computed by the plain versions of B2 with the lse and
    of B6 in f32 (the kernels' inputs are bf16), for the swap in phase 7;
    ``roll_kv`` (a control) reads each query head's keys and values from
    the kv head that many further on, ``roll_pos`` (a control for a
    decoder with one kv head) from the position that many further on;
    ``scale_q`` (a control) multiplies the queries, so the softmax's
    temperature."""
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, lengths):
            k, v = (x.roll((roll_kv, roll_pos), dims=(2, 1)) for x in (k, v))
            q = q * scale_q
            f = [t.float() for t in (q, k, v)]
            out, lse = fa.flash_attention_fwd_plain(*f, lengths, causal)
            ctx.save_for_backward(q, k, v, out, lse, lengths)
            return out.to(q.dtype)

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse, lengths = ctx.saved_tensors
            dq, dk, dv = fa.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), out, lse, do.float(),
                lengths, causal)
            dk, dv = (x.roll((-roll_kv, -roll_pos), dims=(2, 1))
                      for x in (dk, dv))
            dq = dq * scale_q
            return (*(g.to(t.dtype) for g, t in zip((dq, dk, dv),
                                                    (q, k, v))), None)

    return lambda q, k, v, kv_len: PlainAttention.apply(q, k, v, kv_len)


def _train_data(root: str, info, cfg, frames: int, max_len: int,
                refer: bool = True):
    """SupervisedDataset + Collator on the grounding scene: TRAIN_QA's
    ScanQA records and (``refer``) TRAIN_REFER's ScanRefer records
    (FakeTokenizer; the collator's grounding extras at GROUND_OBJECTS
    proposals)."""
    from fixtures import FakeTokenizer

    from video3d_tpu_torch.config import DataConfig
    from video3d_tpu_torch.data.dataset import (Collator, CollatorConfig,
                                                SupervisedDataset)
    from video3d_tpu_torch.data.image_processor import SigLipImageProcessor

    records = [{"id": f"train_qa{i}", "video": info["sample_idx"],
                "conversations": [
                    {"from": "human", "value": f"<image>\n{text}"},
                    {"from": "gpt", "value": f"a brown chair {i}"}],
                "metadata": {"dataset": "scanqa"}}
               for i, text in enumerate(TRAIN_QA)]
    records += [{"id": f"train_refer{i}", "video": info["sample_idx"],
                 "conversations": [
                     {"from": "human", "value": f"<image>\n{text}"},
                     {"from": "gpt", "value": "<ground>"}],
                 "metadata": {"dataset": "scanrefer", "object_id": obj}}
                for i, (text, obj) in enumerate(TRAIN_REFER) if refer]
    ann = os.path.join(root, f"train_mix{'' if refer else '_qa'}.json")
    with open(ann, "w") as f:
        json.dump(records, f)
    tok = FakeTokenizer()
    ds = SupervisedDataset(ann, tok, DataConfig(
        video_folder=root, annotation_dir=os.path.join(root, "embodiedscan"),
        metadata_dir=os.path.join(root, "metadata"), frames_upbound=frames),
        image_processor=SigLipImageProcessor(
            size=(cfg.vision.image_size,) * 2))
    return ds, Collator(cfg, CollatorConfig(
        max_len=max_len, frames_upbound=frames, max_objects=GROUND_OBJECTS,
        ground_token_id=tok.vocab["<ground>"]))


def _loss_and_grads(params, cfg, batch, extras=None):
    """One mini-step's loss, global gradient norm and gradients (bf16
    compute over the f32 master leaves, remat), without an update: the LM
    loss, or with the grounding ``extras`` the InfoNCE loss."""
    import torch

    from video3d_tpu_torch.train.optim import global_norm, tree_leaves
    from video3d_tpu_torch.train.train_step import cast_to_compute, loss_fn
    from video3d_tpu_torch.train.trainer import grounding_loss_fn

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        if extras is None:
            loss, _ = loss_fn(params, cfg, batch, remat=True,
                              compute_dtype=torch.bfloat16)
        else:
            loss, _ = grounding_loss_fn(
                cast_to_compute(params, torch.bfloat16), cfg, batch, extras,
                remat=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return float(loss.detach()), float(global_norm(grads)), grads


def _swap_results(params, cfg, batch, extras, variants: dict):
    """One mini-step's (loss, grad_norm) through the kernels, and for each
    of ``variants`` (name -> ``_plain_train_attention`` keywords) the same
    mini-step with that plain attention swapped into
    ``models.qwen2.mha_train`` (restored after): its loss and grad_norm
    relative to the kernels' and its gradients' relative L2 distance."""
    import torch

    from video3d_tpu_torch.models import qwen2

    loss, gn, grads = _loss_and_grads(params, cfg, batch, extras)
    sq = sum(float((g.float() ** 2).sum()) for g in grads)
    kernel = qwen2.mha_train
    results = {}
    try:
        for name, kw in variants.items():
            qwen2.mha_train = _plain_train_attention(**kw)
            p_loss, p_gn, p_grads = _loss_and_grads(params, cfg, batch,
                                                    extras)
            diff = sum(float(((a.float() - b.float()) ** 2).sum())
                       for a, b in zip(grads, p_grads))
            results[name] = (abs(loss - p_loss) / abs(p_loss),
                             abs(gn - p_gn) / p_gn, (diff / sq) ** 0.5)
            del p_grads
    finally:
        qwen2.mha_train = kernel
    del grads
    torch.cuda.empty_cache()
    return loss, gn, results


def _check_plain_swap(params, cfg, root: str, info, dev, frames: int,
                      max_len: int, cases=None) -> None:
    """Phase 7's kernel-vs-plain checks: one V=``frames`` LM mini-step and
    one ground mini-step through the kernels, then with the plain attention
    swapped in, each within its (loss, grad_norm, gradients) bounds; a
    control, a broken plain attention, must miss each bound by its factor.
    ``cases``: (kind, record index, bounds, factor, control, its
    ``_plain_train_attention`` keywords) per mini-step; by default phase
    7's: the LM step's control drops the causal mask, the ground step's
    reads the next kv head."""
    from video3d_tpu_torch.train.trainer import ground_extras, to_batch

    ds, col = _train_data(root, info, cfg, frames, max_len)
    if cases is None:
        cases = (("LM", 0, (TRAIN_LOSS_REL, TRAIN_GN_REL, TRAIN_GRAD_REL),
                  2, "plain attention without its causal mask",
                  {"causal": False}),
                 ("ground", len(TRAIN_QA), GROUND_TRAIN_REL, 4,
                  "plain attention reading the next kv head",
                  {"roll_kv": 1}))
    for kind, index, bounds, factor, control, broken in cases:
        arrays = col([ds[index]])
        batch = to_batch(arrays, dev)
        extras = ground_extras(arrays, dev)
        _check(f"{kind} mini-step batch", (extras is None) == (kind == "LM"),
               f"grounding extras: {extras is not None}")
        loss, gn, results = _swap_results(
            params, cfg, batch, extras,
            {"plain attention": {}, control: broken})
        n = int(batch.seq_len[0])
        got = results["plain attention"]
        _check(f"V={frames} {kind} mini-step ({n} tokens), kernels vs plain "
               f"attention", all(g <= b for g, b in zip(got, bounds)),
               f"loss {loss:.6f} rel |d| {got[0]:.2e} (bound "
               f"{bounds[0]:.2g}), grad_norm {gn:.6f} rel |d| {got[1]:.2e} "
               f"(bound {bounds[1]:.2g}), gradients rel L2 {got[2]:.2e} "
               f"(bound {bounds[2]:.2g})")
        ctl = results[control]
        _check(f"V={frames} {kind} control, {control}",
               all(c >= factor * b for c, b in zip(ctl, bounds)),
               f"loss rel |d| {ctl[0]:.2e}, grad_norm {ctl[1]:.2e}, "
               f"gradients {ctl[2]:.2e} (each must be >= {factor}x its "
               f"bound)")


def _time_mini_steps(trainer, steps: list, after_step=None) -> None:
    """Wrap the trainer's LM and ground step functions: each mini-step
    appends its kind, seconds (synchronised), tokens and launch-count
    deltas to ``steps``, then ``after_step(state)`` runs its checks."""
    import torch

    from video3d_tpu_torch.kernels import _build

    def timed(kind, fn):
        def step(state, batch, *extras):
            before = dict(_build.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = fn(state, batch, *extras)
            torch.cuda.synchronize()
            steps.append({"kind": kind, "seconds": time.perf_counter() - t,
                          "tokens": int(batch.seq_len.sum()),
                          "launches": {k: v - before[k]
                                       for k, v in _build.LAUNCHES.items()}})
            if after_step is not None:
                after_step(state)
            return state, metrics
        return step

    trainer._step_fn = timed("lm", trainer._step_fn)
    trainer._ground_step_fn = timed("ground", trainer._ground_step_fn)


def _check_step_launches(label: str, steps, L: int,
                         names=TRAIN_KERNELS[:2]) -> None:
    """Per mini-step, LM or ground, full fine-tune or LoRA: B2 with the lse
    in the forward and again in each layer's remat recompute, B6 once per
    layer's backward (``names``: the hd-128 forms, or the hd-256 ones),
    and no other kernel (a training product never reaches the
    weight-streaming kernels, which have no backward)."""
    from video3d_tpu_torch.kernels import _build

    per_step = dict.fromkeys(_build.LAUNCHES, 0)
    per_step.update({names[0]: 2 * L, names[1]: L})
    nonzero = [{k: v for k, v in s["launches"].items() if v} for s in steps]
    _check(f"{label}launch counts per mini-step",
           all(s["launches"] == per_step for s in steps),
           f"{nonzero}, expected {({k: v for k, v in per_step.items() if v})}"
           f" (B2 with lse 2 x {L} layers, B6 {L})")


def run_training(cfg, root: str, info, dev, frames: int = 32,
                 max_len: int = 8192, swap_frames: int = 8,
                 swap_len: int = 2048, label: str = "ModelConfig() widths",
                 names=TRAIN_KERNELS[:2], swap_cases=None,
                 out_name: str = "train") -> dict:
    """Phase 7: ``Trainer.train()`` at full width, ``TRAIN_LAYERS`` decoder
    layers and the INFONCE ground head, f32 master weights with bf16
    compute, remat, two mini-steps per update, on the grounding scene's
    ScanQA and ScanRefer records (LM and ground mini-steps); returns the
    kernel launch counts of the run. Phase 7b runs it on Gemma-2B
    (``label``), whose attention launches the hd-256 forms (``names``),
    with its own swap check (``swap_cases``, see
    :func:`_check_plain_swap`) and its own output directory
    (``out_name`` under ``root``: checkpoints and metrics)."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.params import init_model
    from video3d_tpu_torch.train.optim import (OptimConfig, tree_leaves,
                                               tree_leaves_with_path)
    from video3d_tpu_torch.train.trainer import Trainer, TrainingConfig

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.float32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"training: {label}, {cfg.vision.num_hidden_layers}"
          f"+{cfg.llm.num_hidden_layers} layers, the {cfg.ground_head.name} "
          f"ground head, {n_params / 1e9:.3f} B f32 master parameters "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _check_plain_swap(params, cfg, root, info, dev, swap_frames, swap_len,
                      swap_cases)
    print(f"  the kernel-vs-plain mini-steps' peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    ds, col = _train_data(root, info, cfg, frames, max_len)
    out_dir = os.path.join(root, out_name)
    metrics_file = os.path.join(out_dir, "metrics.jsonl")
    trainer = Trainer(cfg, params, ds, col,
                      OptimConfig(total_steps=TRAIN_MINI_STEPS),
                      TrainingConfig(output_dir=out_dir, bf16=True,
                                     master_f32=True, remat=True,
                                     gradient_accumulation_steps=2,
                                     group_by="none",
                                     metrics_file=metrics_file), device=dev)
    initial = [t.detach().to("cpu", copy=True)
               for t in tree_leaves(trainer.state.params)]
    head = [i for i, (p, _) in enumerate(tree_leaves_with_path(
        trainer.state.params)) if p.startswith("ground_head")]
    steps = []

    def after_step(state):
        leaves = tree_leaves(state.params)
        if len(steps) == 2:      # after update 1, at learning rate 0
            same = all(torch.equal(a.cpu(), b)
                       for a, b in zip(leaves, initial))
            _check("update 1 (learning rate 0): f32 master tree", same,
                   "bit for bit the initial tree")
        if len(steps) == 4:      # after update 2
            moved = [not torch.equal(a.cpu(), b)
                     for a, b in zip(leaves, initial)]
            _check("update 2: every tunable leaf moved", all(moved),
                   f"{sum(moved)} of {len(initial)} leaves")
            _check("update 2: the ground head's leaves moved",
                   len(head) == 13 and all(moved[i] for i in head),
                   f"{sum(moved[i] for i in head)} of {len(head)}")

    _time_mini_steps(trainer, steps, after_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state = trainer.train(resume=False)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del initial

    records = _read_jsonl(metrics_file)
    kinds = [s["kind"] for s in steps]
    _check("mini-steps", len(records) == TRAIN_MINI_STEPS
           and state.step == TRAIN_MINI_STEPS
           and state.opt_state.gradient_step == TRAIN_MINI_STEPS // 2
           and sorted(kinds) == ["ground"] * len(TRAIN_REFER)
           + ["lm"] * len(TRAIN_QA),
           f"{len(records)} logged ({kinds}), step {state.step}, "
           f"{state.opt_state.gradient_step} optimizer updates")
    for r, kind in zip(records, kinds):
        key = "lm_loss" if kind == "lm" else "ground_loss"
        _check(f"mini-step {r['step']} ({kind}) loss and grad_norm",
               key in r and all(math.isfinite(r[k]) and r[k] > 0
                                for k in (key, "grad_norm")),
               f"{key} {r.get(key, float('nan')):.6f}, grad_norm "
               f"{r['grad_norm']:.6f}")
    _check_step_launches("", steps, cfg.llm.num_hidden_layers, names)
    smi = _card()
    print(f"  per-mini-step seconds "
          f"{[(s['kind'], round(s['seconds'], 4)) for s in steps]}; tokens/s "
          f"{[round(s['tokens'] / s['seconds']) for s in steps]} "
          f"({[s['tokens'] for s in steps]} tokens per mini-step); wall for "
          f"Trainer.train() {wall:.2f} s (data, checks of the master tree and "
          f"the bf16 export included); peak device memory "
          f"{peak / 2**30:.2f} GiB; {smi}", flush=True)
    del trainer, state, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 7b: phase 7 on LLaVA over Gemma-2B (GEMMA_2B_HF's widths, head_dim
# 256), its attention on the hd-256 forms of B2 with the lse and B6. At all
# 18 decoder layers (3.45 B f32 masters with AdamW) the first update ran
# out of the card's memory (77.74 GiB in use, an H100 80GB HBM3); at 14
# the phase peaked at 68.03 GiB
GEMMA_TRAIN_LAYERS = 14
# Its V=8 mini-steps through the kernels against the plain attention: on
# an H100 80GB HBM3 (700 W) the LM step read 1.55e-3, 1.93e-3 and 4.16e-2
# (loss, grad_norm, gradients; within phase 7's bounds) and the ground step
# 1.68e-3, 5.16e-4 and 1.32e-1: its loss is above phase 7's ground bound
# (measured on Qwen2's 4 layers), so Gemma's ground loss bound is 2.5e-3.
# With one kv head phase 7's ground control reads nothing else, and
# without the causal mask the LM step's grad_norm moved only 7.40e-3; the
# controls read the keys and values 64 positions on (LM: 9.35e-3,
# 2.14e-1, 9.16e-1, each >= 2x its bound) and double the queries, the
# softmax's temperature (ground: 4.40e-2, 4.75e-1, 1.84, each >= 4x).
# Those readings came from the first, WMMA forms of the hd-256 training
# kernels; the TMA + wgmma forms read 8.72e-4, 1.16e-3-1.50e-3, 4.1e-2
# (LM) and 3.44e-4, 7.39e-3-8.22e-3, 1.51e-1 (ground). The ground
# grad_norm sits near sqrt(1 + r^2) - 1 for gradients r = 0.15 apart in
# relative L2 norm, whatever B6's rounding: with dS from a bf16 P it read
# 1.06e-2-1.08e-2, from the f32 P 9.56e-3-9.81e-3, with dQ over dS's hi
# and lo parts (the kernel's form) 7.39e-3-8.37e-3, with dK's too
# 1.07e-2-1.08e-2, while the gradients' distance stayed at 0.150-0.152
GEMMA_GROUND_TRAIN_REL = (2.5e-3, 1e-2, 2e-1)
GEMMA_SWAP_CASES = (
    ("LM", 0, (TRAIN_LOSS_REL, TRAIN_GN_REL, TRAIN_GRAD_REL), 2,
     "plain attention reading the keys and values 64 positions on",
     {"roll_pos": 64}),
    ("ground", len(TRAIN_QA), GEMMA_GROUND_TRAIN_REL, 4,
     "plain attention with the queries doubled", {"scale_q": 2.0}))


def run_gemma_training(root: str, info, dev) -> dict:
    """Phase 7b: :func:`run_training` on Gemma-2B at GEMMA_TRAIN_LAYERS of
    its 18 decoder layers with the INFONCE ground head; every mini-step's
    attention on the hd-256 training forms; the swap check with
    GEMMA_SWAP_CASES. Returns the launch counts."""
    from video3d_tpu_torch.config import GroundHeadType

    cfg = _family_config(GEMMA_2B_HF, GEMMA_TRAIN_LAYERS)
    cfg = dataclasses.replace(cfg, ground_head=GroundHeadType.INFONCE)
    launches = run_training(
        cfg, root, info, dev, label=f"Gemma-2B widths ({GEMMA_TRAIN_LAYERS} "
        f"of 18 decoder layers: the cut keeps the peak under the card's 80 "
        f"GB)", names=TRAIN_KERNELS[2:], swap_cases=GEMMA_SWAP_CASES,
        out_name="train_gemma")
    # nothing later reads its checkpoint or its ~6 GB bf16 export
    shutil.rmtree(os.path.join(root, "train_gemma"), ignore_errors=True)
    return launches


# phase 15: LoRA / QLoRA at full depth, the adapted answer, DPO
LORA_R, LORA_ALPHA = 128, 256      # the reference's LoRA rank and alpha
LORA_MINI_STEPS = 4                # bf16 base: at accumulation 2, two updates
LORA_FRAMES, LORA_LEN = 32, 8192   # phase 7's records: V=32, 8192 bucket
QLORA_MINI_STEPS = 2               # int8 / int4 bases: at accumulation 1
# decoder depth of the int4 QLoRA run (full depth; cut it before the int8
# run's if the time limit forces a choice)
QLORA_INT4_LAYERS = 28
# the adapted answer's B leaves, replaced by N(0, LORA_B_STD) draws from
# this seed: after one update they are too small to move the logits
LORA_B_STD, LORA_B_SEED = 0.02, 15
# DPO (phase 15d): TRAIN_LAYERS decoder layers, full fine-tune, V frames in
# a bucket of DPO_LEN tokens, so the policy's f32 masters and moments, its
# bf16 copy, the bf16 reference and the two sequences' f32 log-softmaxes
# fit: at V=8 in 2048 the step peaked at 54.19 GiB on an H100 80GB HBM3
# (700 W), so V=16 in 4096 (~5 GB more of logits)
DPO_FRAMES, DPO_LEN = 16, 4096
# at step 1 the policy is the reference, so the loss reads log 2 and the
# reward margin 0; the policy's forwards (B2 with the lse) and the
# reference's (B2) are two kernels, whose outputs may differ by bf16
# rounding: a response log-probability moved by ~0.05 moves the margin by
# beta x 0.05 = 5e-3 and the loss by half that
DPO_LOSS_ATOL, DPO_MARGIN_ATOL = 5e-3, 1e-2
DPO_RECORD = {"id": "dpo0", "prompt": "What color is the chair next to "
              "the desk?", "chosen": "a brown wooden chair",
              "rejected": "a blue plastic sofa"}


def _byte_sums(tensors) -> list:
    """Per tensor, the int64 sum of its bytes read as 32-bit words (bytes
    where the size is not a multiple of 4): a checksum that any in-place
    write changes."""
    import torch

    out = []
    for t in tensors:
        b = t.detach().reshape(-1).view(torch.uint8)
        w = b.view(torch.int32) if b.numel() % 4 == 0 else b
        out.append(int(torch.sum(w, dtype=torch.int64)))
    return out


def _adam_moments(trainer, state, index: int):
    """(mu, nu) of leaf ``index`` of the trainable tree."""
    inner = getattr(state.opt_state, "inner_opt_state", state.opt_state)
    opt = getattr(trainer.tx, "inner", trainer.tx)
    for group, idx in opt.groups.items():
        if index in idx:
            j = idx.index(index)
            return inner[group].mu[j], inner[group].nu[j]
    raise KeyError(index)


def _lora_train(label: str, cfg, params, ds, col, dev, out_dir: str,
                bits: int, accumulate: int, mini_steps: int):
    """``Trainer.train()`` in LoRA mode (r LORA_R, alpha LORA_ALPHA, the
    base frozen in bf16 or quantized to ``bits``, f32 masters, bf16
    compute, remat) with its checks: the trainables bit for bit after
    update 1 (learning rate 0); after update 2 every B and every extra
    trainable that had a gradient moved, every A unchanged with zero Adam
    moments (its gradient is x^T (dy B^T) scale, exactly zero while B is
    zero: PEFT's init); the frozen base's checksums unchanged; finite
    losses; B2 with the lse 2 x L and B6 L launches per mini-step and no
    other kernel (a training product never reaches the weight-streaming
    kernels); the export read back by ``load_lora_export`` equal to the
    final trainables in bf16. Returns (trainer, launches)."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.train.lora import load_lora_export, lora_size
    from video3d_tpu_torch.train.optim import (OptimConfig, tree_leaves,
                                               tree_leaves_with_path)
    from video3d_tpu_torch.train.trainer import Trainer, TrainingConfig

    metrics_file = os.path.join(out_dir, "metrics.jsonl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, params, ds, col,
                      OptimConfig(total_steps=mini_steps),
                      TrainingConfig(output_dir=out_dir, bf16=True,
                                     master_f32=True, remat=True,
                                     gradient_accumulation_steps=accumulate,
                                     group_by="none",
                                     metrics_file=metrics_file,
                                     lora_r=LORA_R, lora_alpha=LORA_ALPHA,
                                     lora_bits=bits), device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    del params
    paths = [p for p, _ in tree_leaves_with_path(trainer.state.params)]
    initial = [t.detach().to("cpu", copy=True)
               for t in tree_leaves(trainer.state.params)]
    base_sums = _byte_sums(_leaves(trainer.base_params))
    base_bytes = sum(t.numel() * t.element_size()
                     for t in _leaves(trainer.base_params))
    n_adapters = sum(t.numel() for p, t in zip(paths, initial)
                     if p.endswith("/A") or p.endswith("/B"))
    print(f"  {label}: {len(base_sums)} frozen base tensors, "
          f"{base_bytes / 2**30:.2f} GiB; {n_adapters / 1e6:.1f} M "
          f"adapter and {(lora_size(trainer.state.params) - n_adapters) / 1e6:.1f}"
          f" M extra f32 trainables; trainer set up in {t_init:.1f} s",
          flush=True)
    steps = []

    def after_step(state):
        if len(steps) == accumulate:     # update 1, at learning rate 0
            same = all(torch.equal(a.cpu(), b) for a, b in zip(
                tree_leaves(state.params), initial))
            _check(f"{label}: update 1 (learning rate 0): trainables", same,
                   "bit for bit the initial tree")

    _time_mini_steps(trainer, steps, after_step)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    state = trainer.train(resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    records = _read_jsonl(metrics_file)
    kinds = [s["kind"] for s in steps]
    updates = state.opt_state.gradient_step if accumulate > 1 \
        else state.step
    _check(f"{label}: mini-steps", len(records) == mini_steps
           and state.step == mini_steps and updates == 2,
           f"{len(records)} logged ({kinds}), step {state.step}, {updates} "
           f"optimizer updates")
    for r, kind in zip(records, kinds):
        key = "lm_loss" if kind == "lm" else "ground_loss"
        _check(f"{label}: mini-step {r['step']} ({kind}) loss and grad_norm",
               key in r and all(math.isfinite(r[k]) and r[k] > 0
                                for k in (key, "grad_norm")),
               f"{key} {r.get(key, float('nan')):.6f}, grad_norm "
               f"{r['grad_norm']:.6f}")
    final = tree_leaves(state.params)
    grounded = "ground" in kinds
    moved, want, a_quiet = [], [], True
    for i, (p, a, b) in enumerate(zip(paths, final, initial)):
        moved.append(not torch.equal(a.cpu(), b))
        if p.endswith("/A"):
            want.append(False)
            mu, nu = _adam_moments(trainer, state, i)
            a_quiet &= not bool(mu.any()) and not bool(nu.any())
        else:
            want.append(p.endswith("/B") or grounded
                        or not p.startswith("ground_head"))
    n_a = sum(p.endswith("/A") for p in paths)
    _check(f"{label}: update 2: every B and every extra trainable with a "
           f"gradient moved, every A unchanged", moved == want and a_quiet,
           f"{sum(moved)} of {len(moved)} leaves moved, {sum(want)} "
           f"expected ({n_a} A leaves unchanged, their Adam moments zero: "
           f"{a_quiet}; the ground head moves only with ground mini-steps)")
    _check(f"{label}: the frozen base",
           _byte_sums(_leaves(trainer.base_params)) == base_sums, f"checksums of its {len(base_sums)} tensors "
           f"unchanged")
    _check_step_launches(f"{label}: ", steps, cfg.llm.num_hidden_layers)
    export, lcfg, got_bits = load_lora_export(os.path.join(out_dir, "model"),
                                              trainer.base_params)
    same = [p for p, _ in tree_leaves_with_path(export)] == paths and all(
        torch.equal(a, b.to(torch.bfloat16))
        for a, b in zip(tree_leaves(export), final))
    _check(f"{label}: export read back by load_lora_export", same
           and (lcfg.r, lcfg.alpha, got_bits) == (LORA_R, LORA_ALPHA, bits),
           f"{len(paths)} tensors bit for bit the final trainables in bf16, "
           f"r {lcfg.r}, alpha {lcfg.alpha}, bits {got_bits}")
    del export, initial
    print(f"  {label}: per-mini-step seconds "
          f"{[(s['kind'], round(s['seconds'], 4)) for s in steps]}; tokens/s "
          f"{[round(s['tokens'] / s['seconds']) for s in steps]} "
          f"({[s['tokens'] for s in steps]} tokens per mini-step); wall for "
          f"Trainer.train() {wall:.2f} s (data, checks and the export "
          f"included); peak device memory {peak / 2**30:.2f} GiB", flush=True)
    return trainer, launches


@contextlib.contextmanager
def _plain_prefill_kernels():
    """B2 (prefill attention, through ``qwen2.mha``) and B4's matvec (the
    B=1 int8 head) swapped for their plain versions in f32 on the same
    bf16 / int8 values, output in the input's dtype."""
    from video3d_tpu_torch.kernels import flash_attention as fa
    from video3d_tpu_torch.kernels import quant_matvec as qm
    from video3d_tpu_torch.models import qwen2

    kernels = (qwen2.mha, qm.int8_matvec)
    qwen2.mha = lambda q, k, v, kv_len: fa.flash_attention_plain(
        q.float(), k.float(), v.float(), kv_len, True).to(q.dtype)
    qm.int8_matvec = qm.int8_matmul_plain
    try:
        yield
    finally:
        qwen2.mha, qm.int8_matvec = kernels


def run_adapted_serving(base, export_dir: str, cfg, root: str, info,
                        int8_b1_ms: float) -> dict:
    """Phase 15c: the int8 QLoRA export served lazily over the int8 base
    (``maybe_merge_lora``), its B leaves replaced by seeded N(0, 0.02)
    draws; phase 4's path on it (captured decode, launch counts, captured
    vs uncaptured ids); the first-step logits against the same prefill with
    B2 and B4 plain (control: the bare int8 base); one decode-row adapted
    product through B4's B>1 form against its plain base term plus the same
    delta. Returns the main-path run's launch counts."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.kernels import quant_matvec as qm
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models.quant import (LoraAdapted, is_quantized,
                                                matmul)
    from video3d_tpu_torch.train.lora import maybe_merge_lora

    dev = torch.device("cuda", 0)
    params = maybe_merge_lora(base, export_dir)
    g = torch.Generator(device=dev).manual_seed(LORA_B_SEED)
    adapted = [w for lp in params["llm"]["layers"] for grp in ("attn", "mlp")
               for w in lp[grp].values() if isinstance(w, LoraAdapted)]
    for w in adapted:
        w.B = torch.empty_like(w.B).normal_(0.0, LORA_B_STD, generator=g)
    L = cfg.llm.num_hidden_layers
    _check("adapted weights", len(adapted) == 7 * L and all(
        is_quantized(w.base) and w.A.dtype == torch.bfloat16
        for w in adapted) and is_quantized(params["llm"]["lm_head"]),
        f"{len(adapted)} LoraAdapted projections over int8 bases (bf16 "
        f"factors, B drawn N(0, {LORA_B_STD})), the int8 head unadapted")
    greedy = []
    launches, b1_ms = run_main_path(params, cfg, root, info,
                                    results=greedy)

    engine = _make_engine(params, cfg, root)
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "smoke")[0]
    batch, _ = engine._prepare_generation(q)
    cap = batch.text_ids.shape[1] + 1
    with torch.inference_mode():
        def first(p):
            return gen.prefill_multimodal(p, cfg, batch, cap)[0].float()

        before = dict(_build.LAUNCHES)
        got = first(params)
        ran = {k: v - before[k] for k, v in _build.LAUNCHES.items()
               if v != before[k]}
        with _plain_prefill_kernels():
            plain = first(params)
        bare = first(base)
    d = float((got - plain).abs().max())
    ctl = float((got - bare).abs().max())
    _check("adapted first-step logits vs B2 and B4 plain", d <= LOGIT_ATOL
           and ran == {"flash_attention": L, "int8_matvec": 1},
           f"max |d| {d:.4f} (bound {LOGIT_ATOL}; the kernels' run launched "
           f"{ran}), |logits| up to {float(got.abs().max()):.2f}")
    _check("control: the bare int8 base's first-step logits",
           ctl >= 4 * LOGIT_ATOL, f"max |d| {ctl:.4f} (must be >= "
           f"{4 * LOGIT_ATOL})")
    w = params["llm"]["layers"][0]["attn"]["wq"]
    x = torch.randn(8, w.A.shape[0], generator=g, device=dev).bfloat16()
    with torch.inference_mode():
        before = _build.LAUNCHES["int8_matmul"]
        y = matmul(x, w)
        torch.cuda.synchronize()
        n = _build.LAUNCHES["int8_matmul"] - before
        base_term = qm.int8_matmul_plain(x.float(), w.base["q"],
                                         w.base["scale"])
        delta = (((x @ w.A) @ w.B) * w.scale).float()
        ref = base_term + delta
        # the kernel rounds the base term once to bf16, the sum is rounded
        # once more: one ulp of |base| + |delta| bounds both
        ulp = B4_REL * (base_term.abs() + delta.abs()) + B4_ABS
        r = float(((y.float() - ref).abs() / ulp).max())
        r_ctl = float(((base_term - ref).abs() / ulp).max())
    _check("decode-row LoraAdapted product (8 rows, layer 0 wq) through "
           "B4's B>1 form", n == 1 and r <= 1.0 and r_ctl >= 4.0,
           f"{r:.3f} of one bf16 ulp of |base| + |delta| from the f32 plain "
           f"base term plus the same bf16 delta ({n} launch); control, the "
           f"base term alone: {r_ctl:.2f}")
    print(f"  adapted int8 B=1 decode {b1_ms:.2f} ms/token captured (bf16 "
          f"cache) beside phase 6's bare int8 {int8_b1_ms:.2f} (int8 "
          f"cache); answers' ids sha1 {_tokens_digest(greedy)}", flush=True)
    print("the adapter over HTTP (phase 15i):", flush=True)
    _add_launches(launches, _serve_adapter(base, engine, cfg, root, info,
                                           greedy[0], b1_ms))
    del params, engine, adapted, greedy
    gc.collect()
    torch.cuda.empty_cache()
    return launches


LORA_SERVED = "video3d-qlora-smoke"   # phase 15i's adapter name


def _serve_adapter(base, adapted, cfg, root: str, info, greedy,
                   b1_ms: float) -> dict:
    """Phase 15i: the adapted engine served as an adapter beside the bare
    int8 base (``serve_worker(adapters=)``): /v1/models lists both, a
    request naming the adapter gives phase 15c's adapted answer (``greedy``:
    its GenerateResult) through the adapter engine's captured decode, and
    its stream through the eager host-chunked decode, each with exact
    launches (the stream's ms per token printed beside ``b1_ms``, 15c's
    captured ms/token); an unknown name is a 404. Returns the two
    requests' launches."""
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.serve.model_worker import serve_worker

    base_engine = _make_engine(base, cfg, root)
    base_engine.tokenizer = adapted.tokenizer
    port = _free_port()
    worker, server = serve_worker(base_engine, HTTP_MODEL, port=port,
                                  background=True, heartbeat=False,
                                  adapters={LORA_SERVED: adapted})
    addr = f"http://127.0.0.1:{port}"
    L = cfg.llm.num_hidden_layers
    total: dict = {}
    try:
        status, models = _http(addr + "/v1/models")
        ids = [m["id"] for m in models.get("data", [])]
        _check("(i) /v1/models", status == 200
               and ids == [HTTP_MODEL, LORA_SERVED], f"{ids}")
        q = _questions(info["sample_idx"], SCANQA_TEXTS, "smoke")[0]
        want_ids = _answer_ids(greedy)
        want = adapted._decode_text(want_ids)
        payload = {"video": q["video"], "model": LORA_SERVED,
                   "prompt": q["conversations"][0]["value"]}
        graphs = adapted._graphs

        def decoded_captured():
            return graphs.captures + graphs.replays if graphs else 0

        seen = decoded_captured()
        before = dict(_build.LAUNCHES)
        out = _served("(i) the adapter by name", addr + "/worker_generate",
                      payload)
        part = _launch_delta(before)
        ran = decoded_captured() - seen
        _check("(i) the adapted answer over HTTP", out["text"] == want
               and ran > 0, f"equal to phase 15c's adapted answer: "
               f"{out['text'] == want}; through its engine's captured "
               f"decode ({ran} captures and replays); the request took "
               f"{out['inference_time']:.3f} s")
        steps = _forwards(greedy)
        _check_launches("(i)", part, fused_geometry=1, flash_attention=L,
                        decode_attention=L * steps,
                        int8_matmul=7 * L * steps, int8_matvec=1 + steps)
        _add_launches(total, part)
        before = dict(_build.LAUNCHES)
        items, arrivals = _stream(addr + "/worker_generate_stream",
                                  {**payload, "stream_chunk":
                                   HTTP_STREAM_CHUNK}, b"\0")
        part = _launch_delta(before)
        chunks = [json.loads(p) for p in items]
        steps = _stream_steps(len(want_ids), HTTP_STREAM_CHUNK, MAX_NEW)
        ms = _stream_ms_per_token(arrivals, steps, HTTP_STREAM_CHUNK)
        _check("(i) the adapter's stream", bool(chunks) and all(
            c.get("error_code") == 0 for c in chunks)
            and chunks[-1]["text"] == want,
            f"{len(chunks)} chunks, the last equal to the adapted answer "
            f"after {arrivals[-1] if arrivals else float('nan'):.3f} s; "
            f"{ms:.2f} ms per decoded token after the first chunk (eager "
            f"chunks of {HTTP_STREAM_CHUNK}) beside 15c's captured "
            f"{b1_ms:.2f} ms/token; {_card()}")
        _check_launches("(i) stream", part, fused_geometry=1,
                        flash_attention=L, decode_attention=L * steps,
                        int8_matmul=7 * L * steps, int8_matvec=1 + steps)
        _add_launches(total, part)
        status, err = _http(addr + "/v1/chat/completions", {
            "model": "no-such-adapter", "video": q["video"],
            "messages": [{"role": "user", "content": SCANQA_TEXTS[0]}]})
        _check("(i) an unknown model name", status == 404
               and err.get("error", {}).get("code") == "model_not_found",
               f"HTTP {status} {err.get('error', {}).get('code')}")
        _check("(i) worker errors", worker.n_errors == 0,
               f"{worker.n_errors} request errors")
    finally:
        server.shutdown()
        server.server_close()
    return total


def run_dpo(cfg, root: str, info, dev) -> dict:
    """Phase 15d: two ``dpo_train_step``s at full width and ``cfg``'s
    depth, a full fine-tune (f32 masters, bf16 compute, remat) against a
    bf16 copy of the initial policy, on a chosen / rejected pair that
    ``DPODataset`` builds from the grounding scene (DPO_FRAMES frames,
    DPO_LEN bucket). Checks: step 1 reads log 2 and margin 0 (the policy is
    the reference); after step 2 every leaf but the ground head's (no DPO
    gradient) moved; the reference's checksums unchanged; per step, B2 with
    the lse 2 x 2 x L (two policy forwards and their recomputes), B6 2 x L
    and B2 2 x L (the reference's forwards); finite values. Returns the
    launch counts of the two steps."""
    import torch

    from fixtures import FakeTokenizer

    from video3d_tpu_torch.config import DataConfig
    from video3d_tpu_torch.data.dataset import Collator, CollatorConfig
    from video3d_tpu_torch.data.image_processor import SigLipImageProcessor
    from video3d_tpu_torch.data.video_processor import VideoProcessor
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.params import init_model
    from video3d_tpu_torch.train.dpo import DPOConfig, dpo_train_step
    from video3d_tpu_torch.train.dpo_data import DPOCollator, DPODataset
    from video3d_tpu_torch.train.optim import (OptimConfig, build_optimizer,
                                               tree_leaves,
                                               tree_leaves_with_path)
    from video3d_tpu_torch.train.train_step import (cast_to_compute,
                                                    create_train_state)
    from video3d_tpu_torch.train.trainer import to_batch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    policy = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(16),
                        torch.float32)
    ref = cast_to_compute(policy, torch.bfloat16)
    ds = DPODataset([dict(DPO_RECORD, video=info["sample_idx"])],
                    FakeTokenizer(), VideoProcessor(DataConfig(
                        video_folder=root,
                        annotation_dir=os.path.join(root, "embodiedscan"),
                        metadata_dir=os.path.join(root, "metadata"),
                        frames_upbound=DPO_FRAMES)),
                    SigLipImageProcessor(size=(cfg.vision.image_size,) * 2),
                    frames_upbound=DPO_FRAMES)
    col = DPOCollator(Collator(cfg, CollatorConfig(
        max_len=DPO_LEN, frames_upbound=DPO_FRAMES)))
    chosen, rejected = col([ds[0]])
    pair = (to_batch(chosen, dev), to_batch(rejected, dev))
    tokens = [int(b.seq_len[0]) for b in pair]
    _check("DPO pair", (chosen["labels"] != rejected["labels"]).any()
           and chosen["images"].shape[1] == DPO_FRAMES,
           f"chosen / rejected of {tokens} tokens in a {DPO_LEN} bucket, "
           f"{DPO_FRAMES} frames, labels differ")
    tx = build_optimizer(policy, OptimConfig(total_steps=2))
    state = create_train_state(policy, tx)
    paths = [p for p, _ in tree_leaves_with_path(policy)]
    policy_sums = _byte_sums(tree_leaves(policy))
    ref_sums = _byte_sums(tree_leaves(ref))
    L = cfg.llm.num_hidden_layers
    expected = dict.fromkeys(_build.LAUNCHES, 0)
    expected.update(flash_attention_lse=4 * L, flash_attention_bwd=2 * L,
                    flash_attention=2 * L)
    readings = []
    for step in range(2):
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = dpo_train_step(state, ref, pair, cfg, DPOConfig(), tx,
                                  remat=True, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        ran = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        vals = {k: float(v) for k, v in m.items()}
        readings.append((seconds, vals, ran))
        _check(f"DPO step {step + 1}: finite metrics and launch counts",
               all(math.isfinite(v) for v in vals.values())
               and ran == expected,
               f"{vals}; launches {({k: v for k, v in ran.items() if v})}, "
               f"expected {({k: v for k, v in expected.items() if v})} "
               f"(B2 with lse 2 policy forwards x 2 (remat) x {L}, B6 "
               f"2 x {L}, B2 2 reference forwards x {L})")
    loss, margin = readings[0][1]["dpo_loss"], readings[0][1]["reward_margin"]
    _check("DPO step 1: the policy is the reference",
           abs(loss - math.log(2)) <= DPO_LOSS_ATOL
           and abs(margin) <= DPO_MARGIN_ATOL,
           f"dpo_loss {loss:.6f} (log 2 = {math.log(2):.6f}, bound "
           f"{DPO_LOSS_ATOL}), reward_margin {margin:.3e} (bound "
           f"{DPO_MARGIN_ATOL})")
    moved = [a != b for a, b in zip(_byte_sums(tree_leaves(state.params)),
                                    policy_sums)]
    want = [not p.startswith("ground_head") for p in paths]
    _check("DPO step 2: the policy moved", moved == want,
           f"{sum(moved)} of {len(moved)} leaves moved ({sum(want)} "
           f"expected: every leaf but the ground head's)")
    _check("DPO: the reference", _byte_sums(tree_leaves(ref)) == ref_sums,
           f"checksums of its {len(ref_sums)} tensors unchanged")
    peak = torch.cuda.max_memory_allocated()
    print(f"  DPO: seconds per step {[round(r[0], 4) for r in readings]}; "
          f"peak device memory {peak / 2**30:.2f} GiB (f32 policy and "
          f"moments, bf16 reference, {DPO_FRAMES} frames, bucket "
          f"{DPO_LEN})", flush=True)
    total = dict.fromkeys(_build.LAUNCHES, 0)
    for _, _, ran in readings:
        for k, v in ran.items():
            total[k] += v
    del state, policy, ref, pair
    gc.collect()
    torch.cuda.empty_cache()
    return total


def run_lora_paths(cfg, train_cfg, root: str, info, ground_info, dev,
                   int8_b1_ms: float) -> dict:
    """Phase 15: LoRA over a bf16 base at full depth (LM and ground
    mini-steps), QLoRA over int8 and int4 bases (LM mini-steps), the int8
    export served lazily, DPO at ``train_cfg``'s depth; each part's peak
    and seconds printed. Returns the launch counts of the main-path runs
    (the trainers', the adapted answers', the DPO steps')."""
    import torch

    from video3d_tpu_torch.params import init_model

    t_phase = time.perf_counter()
    total = {}

    def add(part):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v

    def model(layers, bits):
        c = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, num_hidden_layers=layers))
        t0 = time.perf_counter()
        p = init_model(c, dev, torch.Generator(device=dev).manual_seed(15),
                       torch.bfloat16, bits=bits)
        torch.cuda.synchronize()
        print(f"  {layers}-layer {'bf16' if bits == 16 else f'int{bits}'} "
              f"base initialised in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return c, p

    L = cfg.llm.num_hidden_layers
    print(f"LoRA, bf16 base, {L} layers (phase 15a):", flush=True)
    c, params = model(L, 16)
    ds, col = _train_data(root, ground_info, c, LORA_FRAMES, LORA_LEN)
    trainer, launches = _lora_train(
        "LoRA bf16", c, params, ds, col, dev, os.path.join(root, "lora16"),
        16, 2, LORA_MINI_STEPS)
    del params, trainer
    add(launches)
    gc.collect()
    torch.cuda.empty_cache()

    print(f"QLoRA, int8 base, {L} layers (phase 15b):", flush=True)
    c, params = model(L, 8)
    ds, col = _train_data(root, ground_info, c, LORA_FRAMES, LORA_LEN,
                          refer=False)
    trainer, launches = _lora_train(
        "QLoRA int8", c, params, ds, col, dev, os.path.join(root, "lora8"),
        8, 1, QLORA_MINI_STEPS)
    del params
    add(launches)
    base = trainer.base_params
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    print("the int8 export served lazily (phase 15c):", flush=True)
    add(run_adapted_serving(base, os.path.join(root, "lora8", "model"), c,
                            root, info, int8_b1_ms))
    del base
    gc.collect()
    torch.cuda.empty_cache()

    print(f"QLoRA, int4 base, {QLORA_INT4_LAYERS} layers (phase 15b):",
          flush=True)
    c, params = model(QLORA_INT4_LAYERS, 4)
    ds, col = _train_data(root, ground_info, c, LORA_FRAMES, LORA_LEN,
                          refer=False)
    trainer, launches = _lora_train(
        "QLoRA int4", c, params, ds, col, dev, os.path.join(root, "lora4"),
        4, 1, QLORA_MINI_STEPS)
    del params, trainer
    add(launches)
    gc.collect()
    torch.cuda.empty_cache()

    print(f"DPO, {train_cfg.llm.num_hidden_layers} layers (phase 15d):",
          flush=True)
    add(run_dpo(train_cfg, root, ground_info, dev))
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


# phase 16: other inputs, the 2D-image and video-file modalities and the
# coordinate-pooling and world-PE variants
IMAGE_SIDE = 768     # a seeded square image: anyres 2x2 tiles + the base view
IMAGE_TOKENS = 3699  # its spatial_unpad block: 729 + 54 rows of 54 + newline
# the mp4 the phase writes with cv2: seeded 480x640 frames at 24 fps, force
# sampled to the engine's 32 frames
VIDEO_FILE_FRAMES, VIDEO_FILE_FPS = 48, 24.0
OTHER_PROMPT = "What color is the chair next to the desk?"
# the LoRA run's image records (the video-file record is the mp4 above)
LORA_IMAGES = ((IMAGE_SIDE, IMAGE_SIDE), (640, 480))
# the variants' mini-steps: TRAIN_LAYERS decoder layers, V frames of phase
# 12's scene in a bucket of VARIANT_LEN tokens
VARIANTS = ("minmax-discrete-sin3d", "sample9-discrete-sin3d",
            "avg-discrete-mlp", "sample1-discrete-mrope")
VARIANT_FRAMES, VARIANT_LEN = 8, 2048


def _seeded_image(w: int, h: int, seed: int):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _write_mp4(path: str) -> None:
    """VIDEO_FILE_FRAMES seeded 480x640 frames at VIDEO_FILE_FPS through
    cv2's mp4v writer (raises where cv2 cannot write one)."""
    import cv2
    import numpy as np

    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                        VIDEO_FILE_FPS, (640, 480))
    if not w.isOpened():
        raise RuntimeError("cv2 has no mp4 writer here")
    rng = np.random.default_rng(16)
    for i in range(VIDEO_FILE_FRAMES):
        frame = np.full((480, 640, 3), i * 5 % 256, np.uint8)
        frame[:240, :320] = rng.integers(0, 255, (240, 320, 3),
                                         dtype=np.uint8)
        w.write(frame)
    w.release()


def _first_step_logits(params, cfg, batch, vf=None):
    """The prefill's next-token logits (f32) in a cache of one more slot."""
    import torch

    from video3d_tpu_torch.models import generate as gen

    with torch.inference_mode():
        return gen.prefill_multimodal(params, cfg, batch,
                                      batch.text_ids.shape[1] + 1,
                                      vision_features=vf)[0].float()


def _other_answer(label: str, engine, params, cfg, call, prepare,
                  **per_path) -> dict:
    """One counted answer of an entry point after a warm-up one: exact
    launches (``per_path``, by default B2 once per layer; B3 per layer and
    decode forward), its ids against the same batch decoded uncaptured
    (``prepare()``: batch, vision features, the call's configuration);
    returns the counted call's launches."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import generate as gen

    call()                                          # warm-up, not counted
    engine.results.clear()
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    text = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    part = _launch_delta(before)
    res = engine.results[-1]
    L = cfg.llm.num_hidden_layers
    forwards = _decode_forwards([res], cfg.llm.vocab_size)
    expected = _expected_launches(params, "bfloat16", L, forwards, [res],
                                  **(per_path or {"flash_attention": L}))
    _check(f"{label}: launch counts", part == expected,
           f"{ {k: v for k, v in part.items() if v} }, expected "
           f"{ {k: v for k, v in expected.items() if v} } ({forwards} "
           f"decode forwards)")
    batch, vf, call_cfg = prepare()
    ref = gen.generate_greedy(params, call_cfg, batch, MAX_NEW,
                              engine.ecfg.eos_token_id, vf,
                              engine.cache_dtype, capture=False)
    _check(f"{label}: captured decode vs uncaptured",
           isinstance(text, str) and torch.equal(res.tokens, ref.tokens)
           and torch.equal(res.lengths, ref.lengths),
           f"ids bit for bit (lengths {res.lengths.tolist()} / "
           f"{ref.lengths.tolist()}); wall {wall:.3f} s")
    return part


def _logit_check(label: str, got, plain, controls: dict) -> None:
    """First-step logits through the kernels within LOGIT_ATOL of the
    plain-attention prefill's; the first control must read at least twice
    the bound (the others are printed)."""
    d = float((got - plain).abs().max())
    _check(f"{label}: first-step logits vs B2 plain", d <= LOGIT_ATOL,
           f"max |d| {d:.4f} (bound {LOGIT_ATOL}), |logits| up to "
           f"{float(got.abs().max()):.2f}")
    for i, (name, ctl) in enumerate(controls.items()):
        c = float((got - ctl).abs().max())
        if i == 0:
            _check(f"{label}: control, {name}", c >= 2 * LOGIT_ATOL,
                   f"max |d| {c:.4f} (must be >= {2 * LOGIT_ATOL})")
        else:
            print(f"  {label}: another control, {name}: max |d| {c:.4f}",
                  flush=True)


def _image_answers(params, cfg, root: str) -> dict:
    """Phase 16a: ``generate_answer_image`` on a seeded IMAGE_SIDE^2 image
    through anyres + spatial_unpad (5 tiles, IMAGE_TOKENS vision tokens)
    and through pad (one view); launches, captured vs uncaptured ids; the
    anyres prefill's first-step logits against B2 plain (control: the
    block without its base view), its vision and prefill ms."""
    import torch

    from video3d_tpu_torch.models import generate as gen

    engine = _make_engine(params, cfg, root)
    img = _seeded_image(IMAGE_SIDE, IMAGE_SIDE, 16)
    launches = {}
    for aspect in ("anyres", "pad"):
        def prepare(aspect=aspect):
            return (*engine.prepare_image(OTHER_PROMPT, img,
                                          image_aspect_ratio=aspect), cfg)

        _add_launches(launches, _other_answer(
            f"image ({aspect})", engine, params, cfg,
            lambda aspect=aspect: engine.generate_answer_image(
                OTHER_PROMPT, img, image_aspect_ratio=aspect), prepare))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch, feat = engine.prepare_image(OTHER_PROMPT, img)
    torch.cuda.synchronize()
    t_vis = time.perf_counter() - t0
    n = int(batch.seq_len[0])
    _check("image (anyres): vision block", feat.shape[1] == IMAGE_TOKENS
           and bool(torch.isfinite(feat.float()).all()),
           f"{feat.shape[1]} tokens (expected {IMAGE_TOKENS}), finite")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.prefill_multimodal(params, cfg, batch,
                               batch.text_ids.shape[1] + MAX_NEW,
                               vision_features=feat)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
    got = _first_step_logits(params, cfg, batch, feat)
    with _plain_prefill_kernels():
        plain = _first_step_logits(params, cfg, batch, feat)
    nb_batch, nb_feat = engine.prepare_image(
        OTHER_PROMPT, img, patch_merge_type="spatial_unpad_nobase")
    _logit_check("image (anyres)", got, plain, {
        "the block without its base view": _first_step_logits(
            params, cfg, nb_batch, nb_feat),
        "the logits one position early": _first_step_logits(
            params, cfg, batch._replace(seq_len=batch.seq_len - 1), feat)})
    print(f"  image (anyres): tiling + tower + projector + arrangement "
          f"{t_vis * 1e3:.1f} ms; LLM prefill {n} tokens (bucket "
          f"{batch.text_ids.shape[1]}) {t_pre * 1e3:.1f} ms", flush=True)
    del engine
    return launches


def _video_file_answer(params, cfg, root: str, mp4: str) -> dict:
    """Phase 16b: ``generate_answer_video_file`` on the phase's mp4 with
    the time instruction (32 frames, the world PE off): launches, captured
    vs uncaptured ids, the first-step logits against B2 plain (control:
    the frames in reverse order)."""
    import torch

    engine = _make_engine(params, cfg, root)

    def prepare():
        batch, plain = engine.prepare_video_file(OTHER_PROMPT, mp4,
                                                 add_time_instruction=True)
        return batch, None, plain

    part = _other_answer(
        "video file", engine, params, cfg,
        lambda: engine.generate_answer_video_file(
            OTHER_PROMPT, mp4, add_time_instruction=True), prepare)
    batch, _, plain_cfg = prepare()
    V = batch.images.shape[1]
    _check("video file: frames and configuration",
           V == 32 and plain_cfg.world_3d.pos_embed.value == "none"
           and engine.cfg is cfg,
           f"{V} frames sampled from {VIDEO_FILE_FRAMES}, world PE "
           f"{plain_cfg.world_3d.pos_embed.value}, the engine's own "
           f"configuration untouched")
    got = _first_step_logits(params, plain_cfg, batch)
    with _plain_prefill_kernels():
        plain = _first_step_logits(params, plain_cfg, batch)
    _logit_check("video file", got, plain, {
        "the frames in reverse order": _first_step_logits(
            params, plain_cfg, batch._replace(images=batch.images.flip(1))),
        "the logits one position early": _first_step_logits(
            params, plain_cfg, batch._replace(seq_len=batch.seq_len - 1))})
    print(f"  video file: {int(batch.seq_len[0])} tokens (bucket "
          f"{batch.text_ids.shape[1]})", flush=True)
    del engine
    return part


def _mlp_pe_answer(params, cfg, root: str, info, dev) -> dict:
    """Phase 16d's answer: phase 4's model with seeded ``world_pe_mlp``
    leaves answers a ScanQA question under the MLP world PE (B1, the MLP
    PE, B2, B3): exact launches, captured vs uncaptured ids; the first-step
    logits' distance from the same model's under sin3d printed. The leaves
    are removed again."""
    import torch

    from video3d_tpu_torch.config import PosEmbedType
    from video3d_tpu_torch.ops.pos_embed import init_mlp_position_embedding

    mcfg = dataclasses.replace(cfg, world_3d=dataclasses.replace(
        cfg.world_3d, pos_embed=PosEmbedType.MLP))
    params["world_pe_mlp"] = init_mlp_position_embedding(
        cfg.llm.hidden_size, dev, torch.Generator(device=dev).manual_seed(16),
        dtype=torch.bfloat16)
    try:
        engine = _make_engine(params, mcfg, root)
        q = _questions(info["sample_idx"], SCANQA_TEXTS, "mlp")[0]

        def prepare():
            return (*engine._prepare_generation(q), mcfg)

        part = _other_answer("MLP world PE answer", engine, params, mcfg,
                             lambda: engine.generate_answer(q), prepare,
                             fused_geometry=1,
                             flash_attention=cfg.llm.num_hidden_layers)
        batch, vf, _ = prepare()
        d = float((_first_step_logits(params, mcfg, batch, vf)
                   - _first_step_logits(params, cfg, batch)).abs().max())
        print(f"  MLP world PE answer: first-step logits {d:.4f} from the "
              f"same model's under sin3d", flush=True)
        del engine
    finally:
        del params["world_pe_mlp"]
    return part


def _lora_other_inputs(params, cfg, root: str, mp4: str, dev) -> dict:
    """Phase 16c: ``Trainer.train()`` with ``lora_r=LORA_R``,
    ``lora_alpha=LORA_ALPHA`` over the phase's frozen bf16 model (``cfg``,
    the world PE off) on LORA_IMAGES' two image records and one record of
    the phase's mp4 (32 frames, the time instruction), each its own
    mini-step at one per update: finite losses, the trainables bit for
    bit after update 1 (learning rate 0), every B moved after update 2,
    exact launches per mini-step. Returns the run's launches."""
    import torch

    from fixtures import FakeTokenizer

    from video3d_tpu_torch.config import DataConfig, PosEmbedType
    from video3d_tpu_torch.data.dataset import (Collator, CollatorConfig,
                                                SupervisedDataset)
    from video3d_tpu_torch.data.image_processor import SigLipImageProcessor
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.train.optim import (OptimConfig, tree_leaves,
                                               tree_leaves_with_path)
    from video3d_tpu_torch.train.trainer import Trainer, TrainingConfig

    plain = dataclasses.replace(cfg, world_3d=dataclasses.replace(
        cfg.world_3d, pos_embed=PosEmbedType.NONE))
    records = []
    for i, (w, h) in enumerate(LORA_IMAGES):
        _seeded_image(w, h, 20 + i).save(os.path.join(root, f"img{i}.png"))
        records.append({"id": f"img{i}", "image": f"img{i}.png",
                        "conversations": [
                            {"from": "human",
                             "value": f"<image>\n{OTHER_PROMPT}"},
                            {"from": "gpt", "value": f"a brown chair {i}"}]})
    records.append({"id": "clip", "video": mp4, "conversations": [
        {"from": "human", "value": f"<image>\n{OTHER_PROMPT}"},
        {"from": "gpt", "value": "a brown chair"}]})
    ann = os.path.join(root, "other_inputs.json")
    with open(ann, "w") as f:
        json.dump(records, f)
    ds = SupervisedDataset(ann, FakeTokenizer(), DataConfig(
        video_folder=root, image_folder=root,
        annotation_dir=os.path.join(root, "embodiedscan"),
        metadata_dir=os.path.join(root, "metadata"),
        frames_upbound=LORA_FRAMES, add_time_instruction=True),
        image_processor=SigLipImageProcessor(
            size=(cfg.vision.image_size,) * 2))
    col = Collator(plain, CollatorConfig(max_len=LORA_LEN,
                                         frames_upbound=LORA_FRAMES))
    out_dir = os.path.join(root, "lora_other")
    metrics_file = os.path.join(out_dir, "metrics.jsonl")
    trainer = Trainer(plain, params, ds, col,
                      OptimConfig(total_steps=len(records)),
                      TrainingConfig(output_dir=out_dir, bf16=True,
                                     master_f32=True, remat=True,
                                     gradient_accumulation_steps=1,
                                     group_by="none",
                                     metrics_file=metrics_file,
                                     lora_r=LORA_R, lora_alpha=LORA_ALPHA),
                      device=dev)
    paths = [p for p, _ in tree_leaves_with_path(trainer.state.params)]
    initial = [t.detach().to("cpu", copy=True)
               for t in tree_leaves(trainer.state.params)]
    steps = []

    def after_step(state):
        leaves = tree_leaves(state.params)
        if len(steps) == 1:              # update 1, at learning rate 0
            same = all(torch.equal(a.cpu(), b)
                       for a, b in zip(leaves, initial))
            _check("LoRA other inputs: update 1 (learning rate 0): "
                   "trainables", same, "bit for bit the initial tree")
        if len(steps) == 2:
            moved = [not torch.equal(a.cpu(), b) for p, a, b in zip(
                paths, leaves, initial) if p.endswith("/B")]
            _check("LoRA other inputs: update 2: every B moved",
                   len(moved) == 7 * cfg.llm.num_hidden_layers
                   and all(moved), f"{sum(moved)} of {len(moved)}")

    _time_mini_steps(trainer, steps, after_step)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    state = trainer.train(resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    records_out = _read_jsonl(metrics_file)
    kinds = [s["kind"] for s in steps]
    _check("LoRA other inputs: mini-steps", state.step == len(records)
           and len(records_out) == len(records) and kinds == ["lm"] * 3,
           f"{len(records_out)} logged ({kinds}), step {state.step}")
    for r in records_out:
        _check(f"LoRA other inputs: mini-step {r['step']} loss and "
               f"grad_norm", all(math.isfinite(r[k]) and r[k] > 0
                                 for k in ("lm_loss", "grad_norm")),
               f"lm_loss {r['lm_loss']:.6f}, grad_norm {r['grad_norm']:.6f}")
    _check_step_launches("LoRA other inputs: ", steps,
                         cfg.llm.num_hidden_layers)
    print(f"  LoRA other inputs: per-mini-step seconds "
          f"{[round(s['seconds'], 4) for s in steps]}; tokens "
          f"{[s['tokens'] for s in steps]} (bucket {LORA_LEN}); wall for "
          f"Trainer.train() {wall:.2f} s (data and the export included)",
          flush=True)
    del trainer, state, initial
    return launches


def _variant_steps(cfg, root: str, info, dev) -> dict:
    """Phase 16d's mini-steps: ``cfg`` at TRAIN_LAYERS decoder layers, f32
    master weights, for each of VARIANTS one V=VARIANT_FRAMES LM mini-step
    (bf16 compute, remat) on phase 12's scene through the kernels, exact
    launches, then with the plain attention swapped in (phase 7's bounds;
    control: the plain attention without its causal mask and reading the
    next kv head, which must miss each bound by 2x; either break alone is
    printed beside it: on an H100 80GB HBM3 (700 W) the causal mask alone
    moved the MLP variant's loss by 9.7e-5, the kv head alone the min-max
    variant's by 3.6e-3 and the mrope variant's grad_norm by 3.5e-2);
    the mrope batch's vision rows read back on the card with their three
    axes apart. Returns the kernel runs' launches."""
    import torch

    from video3d_tpu_torch.config import PosEmbedType, World3DConfig
    from video3d_tpu_torch.models import qwen2
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models.splice import KIND_VISION
    from video3d_tpu_torch.params import init_model
    from video3d_tpu_torch.train.trainer import to_batch

    def variant(name):
        return dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm,
                                         num_hidden_layers=TRAIN_LAYERS),
            world_3d=World3DConfig.from_reference_string(name))

    # one f32 init with the MLP PE's leaves; the other variants drop them
    params = init_model(variant("avg-discrete-mlp"), dev,
                        torch.Generator(device=dev).manual_seed(16),
                        torch.float32)
    launches = {}
    bounds = (TRAIN_LOSS_REL, TRAIN_GN_REL, TRAIN_GRAD_REL)
    for name in VARIANTS:
        vcfg = variant(name)
        p = params if vcfg.world_3d.pos_embed == PosEmbedType.MLP else {
            k: v for k, v in params.items() if k != "world_pe_mlp"}
        ds, col = _train_data(root, info, vcfg, VARIANT_FRAMES, VARIANT_LEN,
                              refer=False)
        batch = to_batch(col([ds[0]]), dev)
        if vcfg.world_3d.pos_embed == PosEmbedType.MROPE:
            ids = batch.mrope_position_ids[batch.kind == KIND_VISION]
            apart = bool(((ids[:, 0] != ids[:, 1])
                          & (ids[:, 1] != ids[:, 2])).any())
            _check(f"{name}: mrope ids of the vision rows on the card",
                   apart and ids.dtype == torch.long
                   and ids.device.type == "cuda",
                   f"{ids.shape[0]} rows, the three axes apart: {apart}")
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        loss, gn, grads = _loss_and_grads(p, vcfg, batch)
        torch.cuda.synchronize()
        part = _launch_delta(before)
        want = {"flash_attention_lse": 2 * TRAIN_LAYERS,
                "flash_attention_bwd": TRAIN_LAYERS}
        _check(f"{name}: launches of the mini-step",
               {k: v for k, v in part.items() if v} == want,
               f"{ {k: v for k, v in part.items() if v} }, expected {want}")
        _add_launches(launches, part)
        sq = sum(float((g.float() ** 2).sum()) for g in grads)
        kernel = qwen2.mha_train
        results = {}
        try:
            for ctl, kw in (("plain attention", {}),
                            ("control", {"causal": False, "roll_kv": 1}),
                            ("without the causal mask", {"causal": False}),
                            ("reading the next kv head", {"roll_kv": 1})):
                qwen2.mha_train = _plain_train_attention(**kw)
                p_loss, p_gn, p_grads = _loss_and_grads(p, vcfg, batch)
                diff = sum(float(((a.float() - b.float()) ** 2).sum())
                           for a, b in zip(grads, p_grads))
                results[ctl] = (abs(loss - p_loss) / abs(p_loss),
                                abs(gn - p_gn) / p_gn, (diff / sq) ** 0.5)
                del p_grads
        finally:
            qwen2.mha_train = kernel
        del grads
        got, ctl = results["plain attention"], results["control"]
        mask, head = (results["without the causal mask"],
                      results["reading the next kv head"])
        _check(f"{name}: V={VARIANT_FRAMES} mini-step ({int(batch.seq_len[0])}"
               f" tokens), kernels vs plain attention",
               all(g <= b for g, b in zip(got, bounds)),
               f"loss {loss:.6f} rel |d| {got[0]:.2e}, grad_norm {gn:.4f} "
               f"rel |d| {got[1]:.2e}, gradients rel L2 {got[2]:.2e} "
               f"(bounds {bounds})")
        _check(f"{name}: control, plain attention without its causal mask "
               f"reading the next kv head",
               all(c >= 2 * b for c, b in zip(ctl, bounds)),
               f"{ctl[0]:.2e}, {ctl[1]:.2e}, {ctl[2]:.2e} (each must be >= "
               f"2x its bound); without the causal mask alone "
               f"{mask[0]:.2e}, {mask[1]:.2e}, {mask[2]:.2e}; the next kv "
               f"head alone {head[0]:.2e}, {head[1]:.2e}, {head[2]:.2e}")
        torch.cuda.empty_cache()
    del params
    return launches


def run_other_inputs(cfg, root: str, info, ground_info, dev) -> dict:
    """Phase 16: the 2D-image and video-file modalities at ``cfg``'s width
    and depth on a bf16 model (phase 4's seed 16), the MLP world PE's ScanQA
    answer on it, a LoRA run over it on image and video-file records,
    then the variants' mini-steps at TRAIN_LAYERS layers; prints the
    phase's seconds, peak and launches, and returns the launches."""
    import torch

    from video3d_tpu_torch.params import init_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = {}
    t0 = time.perf_counter()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(16),
                        torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  {cfg.llm.num_hidden_layers}-layer bf16 model initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mp4 = os.path.join(root, "clip.mp4")
    _write_mp4(mp4)
    print("a 2D image through generate_answer_image (phase 16a):",
          flush=True)
    _add_launches(total, _image_answers(params, cfg, root))
    print("a video file through generate_answer_video_file (phase 16b):",
          flush=True)
    _add_launches(total, _video_file_answer(params, cfg, root, mp4))
    print("the MLP world PE (phase 16d):", flush=True)
    _add_launches(total, _mlp_pe_answer(params, cfg, root, info, dev))
    print(f"LoRA over the bf16 base, {cfg.llm.num_hidden_layers} layers, on "
          f"images and a video file (phase 16c):", flush=True)
    _add_launches(total, _lora_other_inputs(params, cfg, root, mp4, dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"the coordinate-pooling and world-PE variants, {TRAIN_LAYERS} "
          f"layers (phase 16d):", flush=True)
    _add_launches(total, _variant_steps(cfg, root, ground_info, dev))
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s, peak device "
          f"memory {peak / 2**30:.2f} GiB, launches "
          f"{ {k: v for k, v in total.items() if v} }", flush=True)
    return total


# ---------------------------------------------------------------------------
# Phase 17: the serving stack over HTTP (serve/controller.py,
# serve/model_worker.py) on a bf16 model at full width and depth
# ---------------------------------------------------------------------------

HTTP_MODEL = "video3d-smoke"
HTTP_PREFIX_MODEL = "video3d-smoke-prefix"
HTTP_STREAM_CHUNK = 8          # (b)'s stream_chunk
HTTP_CAPPED = 8                # (c)'s max_tokens
HTTP_IMAGE_SIDE = 384          # (e)'s two PNGs: 729 unpooled tokens each
HTTP_IMAGE_PROMPT = "What changed between the two images?"
HTTP_BATCH_TEXTS = PREFIX_TEXTS[:8]   # (g): four questions on each scene
HTTP_HANGUP_BUDGET = 1024      # (g): the budget of the stream hung up on
# (g): eight distinct sampling combinations, each a bypass request of
# HTTP_CAPPED tokens; the last (top_k = 1) must give the greedy ids
HTTP_SAMPLINGS = ({"temperature": 0.7, "top_p": 0.9, "top_k": 50},
                  {"temperature": 0.7}, {"temperature": 1.0},
                  {"temperature": 0.5, "top_k": 20}, {"top_p": 0.8,
                                                      "temperature": 0.3},
                  {"temperature": 1.2, "top_p": 0.95},
                  {"temperature": 0.9, "top_k": 5},
                  {"temperature": 0.7, "top_k": 1})


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(url: str, payload: Optional[dict] = None, timeout: float = 600.0):
    """(status, parsed JSON reply) of a POST (or a GET without
    ``payload``); an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _served(name: str, url: str, payload: dict) -> dict:
    """A request that must succeed: HTTP 200 and error_code 0 (a device
    fault caught by the worker's per-request ``except`` fails the run)."""
    status, out = _http(url, payload)
    _check(f"{name}: served", status == 200 and out.get("error_code", 0) == 0
           and "error" not in out, f"HTTP {status}, error_code "
           f"{out.get('error_code')} {out.get('error', '')!r}")
    return out


def _stream(url: str, payload: dict, sep: bytes):
    """The items of a streamed reply split at ``sep``, and the seconds from
    the request to each one's arrival."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    buf, items, arrivals = b"", [], []
    with urllib.request.urlopen(req, timeout=600) as r:
        while True:
            chunk = r.read1(65536)
            if not chunk:
                break
            buf += chunk
            while sep in buf:
                piece, buf = buf.split(sep, 1)
                if piece.strip():
                    arrivals.append(time.perf_counter() - t0)
                    items.append(piece)
    return items, arrivals


def _stream_ms_per_token(arrivals, steps: int, chunk: int) -> float:
    """A stream's ms per decoded token after its first chunk: the time
    from the first chunk's arrival to the last's over the steps decoded in
    between (nan when the answer ended in the first chunk)."""
    later = steps - min(chunk, steps)
    if later <= 0 or len(arrivals) < 2:
        return float("nan")
    return (arrivals[-1] - arrivals[0]) / later * 1e3


def _content(out: dict):
    """The message content of a chat.completion reply, or None."""
    choices = out.get("choices") or [{}]
    return choices[0].get("message", {}).get("content")


def _stream_steps(n: int, chunk: int, budget: int) -> int:
    """Decode steps of a host-chunked stream that emitted ``n`` ids: every
    chunk up to the one that emitted EOS, the last cut to the budget."""
    return budget if n >= budget else min(-(-(n + 1) // chunk) * chunk,
                                          budget)


def _answer_ids(res) -> list:
    return res.tokens[0, :int(res.lengths[0])].tolist()


def _check_launches(name: str, got: dict, **want) -> None:
    from video3d_tpu_torch.kernels import _build

    expected = dict.fromkeys(_build.LAUNCHES, 0)
    expected.update(want)
    _check(f"{name}: launch counts", got == expected,
           f"{ {k: v for k, v in got.items() if v} }, expected "
           f"{ {k: v for k, v in expected.items() if v} }")


def _http_sequential(engine, params, cfg, caddr: str, waddr: str, infos,
                     b1_ms: float, total: dict) -> dict:
    """(a)-(c), (e) on the sequential worker (``b1_ms``: phase 4's captured
    ms/token, beside the stream's); returns what the summary reuses."""
    import base64
    import io

    from video3d_tpu_torch.kernels import _build

    video = infos[0]["sample_idx"]
    L = cfg.llm.num_hidden_layers
    qs = _questions(video, SCANQA_TEXTS, "http")
    _, got = _http(caddr + "/get_worker_address", {"model": HTTP_MODEL,
                                                    "video": video})
    _check("(a) the controller's dispatch", got.get("address") == waddr,
           f"get_worker_address -> {got.get('address')}")
    # the engine's direct answers first: they capture the decode chunks the
    # worker's answers then replay
    want = [engine.generate_answer(q) for q in qs]
    want_ids = [_answer_ids(r) for r in engine.results[-2:]]
    engine.results.clear()
    before = dict(_build.LAUNCHES)
    texts, times = [], []
    for i, q in enumerate(qs):
        t0 = time.perf_counter()
        out = _served(f"(a) /worker_generate {i}", waddr + "/worker_generate",
                      {"video": video,
                       "prompt": q["conversations"][0]["value"]})
        times.append((out["inference_time"], time.perf_counter() - t0))
        texts.append(out["text"])
    part = _launch_delta(before)
    _check("(a) sequential worker vs generate_answer", texts == want,
           f"texts equal: {[t == w for t, w in zip(texts, want)]}; seconds "
           f"per request, the worker's inference_time / the HTTP round "
           f"trip: {[(round(a, 4), round(b, 4)) for a, b in times]}")
    forwards = sum(_forwards(r) for r in engine.results)
    _check_launches("(a)", part, fused_geometry=2, flash_attention=2 * L,
                    decode_attention=L * forwards)
    _add_launches(total, part)

    # (b) the \0-separated stream
    before = dict(_build.LAUNCHES)
    items, arrivals = _stream(waddr + "/worker_generate_stream",
                              {"video": video, "prompt": qs[0]
                               ["conversations"][0]["value"],
                               "stream_chunk": HTTP_STREAM_CHUNK}, b"\0")
    part = _launch_delta(before)
    ttfc = arrivals[0] if arrivals else float("nan")
    steps = _stream_steps(len(want_ids[0]), HTTP_STREAM_CHUNK, MAX_NEW)
    stream_ms = _stream_ms_per_token(arrivals, steps, HTTP_STREAM_CHUNK)
    chunks = [json.loads(p) for p in items]
    for c in chunks:
        _check("(b) stream chunk", c.get("error_code") == 0,
               f"error_code {c.get('error_code')} {c.get('error', '')!r}")
    cumulative = all(b["text"].startswith(a["text"])
                     for a, b in zip(chunks, chunks[1:]))
    _check("(b) /worker_generate_stream", bool(chunks) and cumulative
           and chunks[-1]["text"] == want[0],
           f"{len(chunks)} cumulative chunks, the last equal to (a): "
           f"{bool(chunks) and chunks[-1]['text'] == want[0]}; first chunk "
           f"after {ttfc * 1e3:.1f} ms, then {stream_ms:.2f} ms per decoded "
           f"token (eager chunks of {HTTP_STREAM_CHUNK}) beside phase 4's "
           f"captured {b1_ms:.2f} ms/token; {_card()}")
    _check_launches("(b)", part, fused_geometry=1, flash_attention=L,
                    decode_attention=L * steps)
    _add_launches(total, part)

    # (c) the OpenAI route, plain, SSE and capped
    oa = {"model": HTTP_MODEL, "messages": [
        {"role": "system", "content": "You are a helpful assistant."},
        {"role": "user", "content": [
            {"type": "video_id", "video_id": video},
            {"type": "text", "text": SCANQA_TEXTS[0]}]}]}
    before = dict(_build.LAUNCHES)
    status, out = _http(waddr + "/v1/chat/completions", oa)
    _check("(c) /v1/chat/completions", status == 200
           and _content(out) == want[0],
           f"HTTP {status}, content equal to (a): {_content(out) == want[0]}")
    events, _ = _stream(waddr + "/v1/chat/completions",
                        {**oa, "stream": True}, b"\n\n")
    events = [e.decode()[len("data: "):] for e in events]
    deltas = [json.loads(e) for e in events[:-1]]
    sse = "".join(d["choices"][0]["delta"].get("content", "")
                  for d in deltas)
    _check("(c) SSE", events[-1] == "[DONE]" and sse == want[0]
           and deltas[-1]["choices"][0]["finish_reason"] == "stop",
           f"{len(deltas)} chat.completion.chunk events, deltas joined "
           f"equal to (a): {sse == want[0]}")
    status, out = _http(waddr + "/v1/chat/completions",
                        {**oa, "max_tokens": HTTP_CAPPED})
    capped = engine._decode_text(want_ids[0][:HTTP_CAPPED])
    _check("(c) max_tokens", status == 200 and _content(out) == capped,
           f"HTTP {status}, the decode of the first {HTTP_CAPPED} greedy "
           f"ids: {_content(out) == capped}")
    _add_launches(total, _launch_delta(before))

    # (e) two PNGs as image_url data URIs
    imgs = [_seeded_image(HTTP_IMAGE_SIDE, HTTP_IMAGE_SIDE, 170 + i)
            for i in range(2)]
    uris = []
    for img in imgs:
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        uris.append("data:image/png;base64,"
                    + base64.b64encode(buf.getvalue()).decode())
    prompt = HTTP_IMAGE_PROMPT
    direct = engine.generate_answer_images(
        None, imgs, conversations=[{"from": "human", "value": prompt}])
    engine.results.clear()
    before = dict(_build.LAUNCHES)
    status, out = _http(waddr + "/v1/chat/completions", {"messages": [
        {"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": u}} for u in uris]
         + [{"type": "text", "text": prompt}]}]})
    part = _launch_delta(before)
    _check("(e) 2D images over /v1/chat/completions", status == 200
           and _content(out) == direct,
           f"HTTP {status}, equal to generate_answer_images: "
           f"{_content(out) == direct}")
    res = engine.results[-1]
    _check_launches("(e)", part, flash_attention=L,
                    decode_attention=L * _forwards(res))
    _add_launches(total, part)
    return {"ttfc": ttfc, "stream_ms": stream_ms}


def _http_open_streams(worker, infos) -> int:
    """The cap on open engine streams, on the sequential worker's own
    generators (a client that reads no further): ``MAX_OPEN_STREAMS``
    streams each hold their prefilled cache after their first chunk, one
    more is refused, and each ends freeing its cache. Returns the peak
    bytes with them open. Runs no main path: its launches are not
    counted."""
    import torch

    video = infos[0]["sample_idx"]
    req = {"video": video, "prompt": f"<image>\n{SCANQA_TEXTS[0]}",
           "stream_chunk": HTTP_STREAM_CHUNK}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gens = [worker.generate_stream(dict(req))
            for _ in range(worker.MAX_OPEN_STREAMS)]
    firsts = [next(g) for g in gens]
    torch.cuda.synchronize()
    each = (torch.cuda.memory_allocated() - held) / len(gens)
    extra = worker.generate_stream(dict(req))
    refused = next(extra)
    extra.close()
    for g in gens:
        g.close()
    torch.cuda.synchronize()
    freed = torch.cuda.memory_allocated() - held
    peak = torch.cuda.max_memory_allocated()
    _check("open engine streams capped",
           all(f["error_code"] == 0 for f in firsts)
           and refused["error_code"] == 1
           and "streams are open" in refused.get("error", "")
           and freed < each / 2, f"{len(gens)} streams open "
           f"({each / 2**20:.1f} MiB of device memory each), one more "
           f"refused: {refused.get('error')!r}; after they ended "
           f"{freed / 2**20:+.1f} MiB; peak {peak / 2**30:.2f} GiB; "
           f"{_card()}")
    return peak


def _http_history(params, cfg, root: str, caddr: str, info, tokenizer,
                  total: dict) -> None:
    """(d): a three-turn history through a second worker whose engine has
    the scene-prefix cache on."""
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.serve.model_worker import serve_worker

    engine = _make_engine(params, cfg, root, prefix_cache_scenes=1)
    engine.tokenizer = tokenizer
    port = _free_port()
    worker, server = serve_worker(engine, HTTP_PREFIX_MODEL, port=port,
                                  controller_addr=caddr, background=True,
                                  heartbeat=False)
    try:
        _, got = _http(caddr + "/get_worker_address",
                       {"model": HTTP_PREFIX_MODEL})
        addr = got.get("address")
        _check("(d) the controller's second worker",
               addr == f"http://127.0.0.1:{port}", f"-> {addr}")
        video = info["sample_idx"]
        history = [{"from": "human", "value": f"<image>\n{SCANQA_TEXTS[0]}"},
                   {"from": "gpt", "value": "a brown wooden chair"},
                   {"from": "human", "value": SCANQA_TEXTS[1]}]
        before = dict(_build.LAUNCHES)
        first = _served("(d) turn 1", addr + "/worker_generate",
                        {"video": video, "conversations": history[:1]})
        hist = _served("(d) turn 3", addr + "/worker_generate",
                       {"video": video, "conversations": history})
        _add_launches(total, _launch_delta(before))
        stats = list(engine.prefix_cache_stats)
        direct = engine.generate_answer(
            {"video": video,
             "conversations": history + [{"from": "gpt", "value": None}]})
        _check("(d) history with the prefix cache", hist["text"] == direct
               and stats == [1, 1] and isinstance(first["text"], str),
               f"the three-turn answer equal to generate_answer on the same "
               f"record: {hist['text'] == direct}; prefix_cache_stats after "
               f"the two requests {stats} (the history a hit)")
    finally:
        server.shutdown()
        server.server_close()
    _check("(d) worker errors", worker.n_errors == 0,
           f"{worker.n_errors} request errors")


def _http_ground(engine, waddr: str, ground_info, total: dict) -> None:
    """(f): /worker_ground against engine.ground."""
    import numpy as np

    from video3d_tpu_torch.kernels import _build

    text = GROUND_TEXTS[0]
    q = {"video": ground_info["sample_idx"], "conversations": [
        {"from": "human", "value": text},
        {"from": "gpt", "value": "<ground>"}]}
    scores, objects = engine.ground(q)
    before = dict(_build.LAUNCHES)
    out = _served("(f) /worker_ground", waddr + "/worker_ground",
                  {"video": ground_info["sample_idx"], "query": text})
    part = _launch_delta(before)
    got = np.asarray(out["scores"], np.float32)
    d = float(np.abs(got - scores).max()) if got.shape == scores.shape \
        else float("inf")
    i = int(np.argmax(scores))
    best = None if i >= len(objects) else [float(x) for x in objects[i]]
    _check("(f) grounding over HTTP", d <= GROUND_SCORE_ATOL
           and int(np.argmax(got)) == i and out["best_box"] == best
           and len(out["objects"]) == len(objects),
           f"{len(got)} scores within {d:.2e} of engine.ground (bound "
           f"{GROUND_SCORE_ATOL}), argmax {int(np.argmax(got))} / {i}, "
           f"best_box equal: {out['best_box'] == best}")
    _check_launches("(f)", part, flash_attention=engine.cfg.llm
                    .num_hidden_layers)
    _add_launches(total, part)


def _http_batcher(params, cfg, root: str, infos, engine, caddr: str,
                  total: dict) -> dict:
    """(g): a worker with the paged batcher (8 slots, chunked prefill)
    takes 8 concurrent requests, one hung-up stream, then eight distinct
    sampling overrides on the bypass route."""
    import threading
    import urllib.request

    import torch

    from video3d_tpu_torch.eval.drivers import InferenceEngine
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.serve.model_worker import serve_worker

    beng = _make_engine(params, cfg, root)
    # the engines number words alike; a longer budget for the hung-up
    # stream (the other requests ask for MAX_NEW)
    beng.tokenizer = engine.tokenizer
    beng.ecfg = dataclasses.replace(beng.ecfg,
                                    max_new_tokens=HTTP_HANGUP_BUDGET)

    def text_of(ids):
        return InferenceEngine._decode_text(beng, ids)

    qs = [q for i in range(2) for q in _questions(
        infos[i]["sample_idx"], HTTP_BATCH_TEXTS[4 * i:4 * i + 4],
        f"http{i}_")]
    want = [engine.generate_answer(q) for q in qs]
    want_ids = [_with_eos(_answer_ids(r), beng.ecfg.eos_token_id, MAX_NEW)
                for r in engine.results[-len(qs):]]
    port = _free_port()
    worker, server = serve_worker(beng, "video3d-smoke-batched", port=port,
                                  controller_addr=caddr, background=True,
                                  heartbeat=False, num_slots=8, paged=True,
                                  chunked_prefill=SERVE_CHUNKED)
    addr = f"http://127.0.0.1:{port}"
    try:
        batcher = worker.batcher
        out = [None] * len(qs)

        def hit(i):
            out[i] = _http(addr + "/worker_generate", {
                "video": qs[i]["video"],
                "prompt": qs[i]["conversations"][0]["value"],
                "max_new_tokens": MAX_NEW})

        before = dict(_build.LAUNCHES)
        beng.decoded.clear()
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(qs))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        # the window closes before the near-tie checks, which recompute
        _add_launches(total, _launch_delta(before))
        for i, (status, o) in enumerate(out):
            _check(f"(g) request {i}", status == 200
                   and o.get("error_code") == 0,
                   f"HTTP {status}, error_code {o.get('error_code')} "
                   f"{o.get('error', '')!r}")
        decoded = list(beng.decoded)
        equal = 0
        for i, (q, (_, o)) in enumerate(zip(qs, out)):
            if o["text"] == want[i]:
                equal += 1
                continue
            # the batcher's ids for this text (its chunked prefill rounds
            # otherwise than the atomic one): equal up to a near-tie
            ids = next((d for d in decoded if text_of(d) == o["text"]),
                       None)
            _check(f"(g) request {i}: its ids", ids is not None,
                   "found among the batcher's decoded answers")
            _near_tie_check(f"(g) request {i} vs the sequential engine",
                            params, cfg, engine, q, want_ids[i],
                            _with_eos(ids, beng.ecfg.eos_token_id, MAX_NEW),
                            CROSS_TIE)
        n_tokens = sum(len(d) for d in decoded[-len(qs):])
        tps = n_tokens / wall
        # one client hangs up mid-stream: its slot and pages come back long
        # before its HTTP_HANGUP_BUDGET steps could have run
        before = dict(_build.LAUNCHES)
        req = urllib.request.Request(
            addr + "/worker_generate_stream", data=json.dumps({
                "video": qs[0]["video"],
                "prompt": qs[0]["conversations"][0]["value"]}).encode(),
            headers={"Content-Type": "application/json"})
        r = urllib.request.urlopen(req, timeout=600)
        r.read1(16)
        busy = _wait_for(lambda: any(s is not None
                                     for s in batcher.slots), 60)
        r.close()
        t_hang = time.perf_counter()
        back = _wait_for(lambda: all(s is None for s in batcher.slots)
                         and worker.queue_length == 0, 3.0)
        _check("(g) a client hung up mid-stream", busy and back,
               f"its slot back after {time.perf_counter() - t_hang:.2f} s "
               f"(at most 3 s; its budget of {HTTP_HANGUP_BUDGET} tokens "
               f"would hold it for ~{HTTP_HANGUP_BUDGET // 8} decode "
               f"chunks)")
        _add_launches(total, _launch_delta(before))
        # eight distinct sampling combinations on the bypass route; top_k =
        # 1 against the greedy answer of the same route
        greedy = list(beng.generate_answer_stream(
            qs[0], max_new_tokens=HTTP_CAPPED))[-1]
        gstats = engine._graphs.stats() if engine._graphs else {}
        bstats = beng._graphs.stats() if beng._graphs else {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(_build.LAUNCHES)
        sampled = []
        for i, s in enumerate(HTTP_SAMPLINGS):
            sampled.append(_served(
                f"(g) sampling override {i}", addr + "/worker_generate",
                {"video": qs[0]["video"],
                 "prompt": qs[0]["conversations"][0]["value"],
                 "max_new_tokens": HTTP_CAPPED, **s}))
        _add_launches(total, _launch_delta(before))
        peak = torch.cuda.max_memory_allocated()
        after = beng._graphs.stats() if beng._graphs else {}
        own = batcher._graphs.stats()["entries"] if batcher._graphs else None
        _check("(g) sampling overrides", sampled[-1]["text"] == greedy
               and after.get("entries") == bstats.get("entries")
               and after.get("captures") == bstats.get("captures"),
               f"{len(HTTP_SAMPLINGS)} distinct combinations served, "
               f"top_k = 1 gives the greedy ids: "
               f"{sampled[-1]['text'] == greedy}; the DecodeGraphs of the "
               f"worker's engine (the bypass route) {after.get('entries')} "
               f"entries / {after.get('captures')} captures before and after "
               f"(the overrides decode eagerly), the batcher's own "
               f"{own}, the sequential "
               f"engine's {gstats.get('entries')}; peak device memory over "
               f"them {peak / 2**30:.2f} GiB")
        _, m = _http(addr + "/worker_metrics", {})
        n_req = len(qs) + 1 + len(HTTP_SAMPLINGS)
        _check("(g) /worker_metrics", m["slots_in_use"] == 0
               and m["pages_free"] == m["pages"]
               and m["requests_total"] == n_req and m["errors_total"] == 0,
               f"slots_in_use {m['slots_in_use']}, pages free "
               f"{m['pages_free']} of {m['pages']}, requests_total "
               f"{m['requests_total']} (expected {n_req}), errors "
               f"{m['errors_total']}")
        print(f"  (g) {len(qs)} concurrent requests, {equal} equal to the "
              f"sequential engine's text ({len(qs) - equal} up to a "
              f"near-tie): {n_tokens} tokens in {wall:.2f} s = {tps:.1f} "
              f"tokens/s; {_card()}", flush=True)
    finally:
        worker.batcher.shutdown()
        server.shutdown()
        server.server_close()
    return {"tps": tps, "override_peak": peak,
            "graph_entries": after.get("entries")}


def _http_host_route(params, cfg, root: str, info, engine,
                     total: dict) -> float:
    """(h): an engine with device_geometry=False answers phase 4's first
    question; its voxel ids against B1's, its first-step logits against
    the B1 route's. Returns the logits' max |d|."""
    import torch

    from video3d_tpu_torch.kernels import _build

    # the scene cache keeps the host route's features for the logit check:
    # its geometry (2.4-3.5 s of host time a call on the H100's machine,
    # 700 W, PERF.md §5) runs twice, not three times
    host = _make_engine(params, cfg, root, scene_cache_scenes=1)
    host.tokenizer = engine.tokenizer     # the engines number words alike
    host.device_geometry = False
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "host")[0]
    V, _, b1 = engine._video_arrays(info["sample_idx"])
    Vh, _, hp = host._video_arrays(info["sample_idx"])
    share = float((b1[0, :V] != hp[0, :V]).any(-1).float().mean())
    before = dict(_build.LAUNCHES)
    text = host.generate_answer(q)
    part = _launch_delta(before)
    L = cfg.llm.num_hidden_layers
    _check_launches("(h) host route", part, flash_attention=L,
                    decode_attention=L * _forwards(host.results[-1]))
    _add_launches(total, part)
    got = _first_step_logits(params, cfg, *host._prepare_generation(q))
    ref = _first_step_logits(params, cfg, engine._prepare_generation(q)[0])
    d = float((got - ref).abs().max())
    _check("(h) host geometry route", d <= LOGIT_ATOL and Vh == V
           and isinstance(text, str),
           f"{V} frames; {share:.4%} of the {V * hp.shape[2] * hp.shape[3]} "
           f"patches' voxel ids differ from B1's; first-step logits within "
           f"{d:.4f} of the B1 route's (bound {LOGIT_ATOL}); {_card()}")
    return d


def run_http_serving(cfg, root: str, infos, ground_info, dev,
                     b1_ms: float) -> dict:
    """Phase 17: the serving stack over HTTP on a bf16 model at full width
    and depth (seed 17): ``serve_controller`` and ``serve_worker`` on
    127.0.0.1 in this process. (a) the sequential worker, reached through
    the controller, answers phase 4's questions as ``generate_answer``;
    (b) its stream's chunks are cumulative, the last equal to (a); (c) the
    OpenAI route plain, as SSE deltas and capped at HTTP_CAPPED tokens;
    then the cap on open engine streams (not a main path);
    (d) a three-turn history through a prefix-cached second worker; (e)
    two PNGs as ``image_url`` parts against ``generate_answer_images``;
    (f) /worker_ground against ``engine.ground``; (g) a paged batcher
    worker (8 slots, chunked prefill) on 8 concurrent requests, a client
    that hangs up, eight distinct sampling overrides; (h) the host
    geometry route. Every request must succeed; launches of the HTTP runs
    are exact where stated and summed; returns them."""
    import torch

    from video3d_tpu_torch.params import init_model
    from video3d_tpu_torch.serve.controller import serve_controller
    from video3d_tpu_torch.serve.model_worker import serve_worker

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(17),
                        torch.bfloat16)
    from fixtures import FakeTokenizer

    vocab = FakeTokenizer().vocab
    engine = _make_engine(params, cfg, root, ground_token_id=vocab["<ground>"],
                          max_objects=GROUND_OBJECTS)
    # FakeTokenizer numbers words at first use, and ids decode to words only
    # once numbered: number every word the phase sends before any answer
    # is decoded, so that a text reads the same whenever it is decoded
    for text in (*SCANQA_TEXTS, *HTTP_BATCH_TEXTS, HTTP_IMAGE_PROMPT,
                 GROUND_TEXTS[0], "a brown wooden chair"):
        engine.tokenizer(text)
    total: dict = {}
    cport, wport = _free_port(), _free_port()
    _, cserver = serve_controller(port=cport, background=True)
    caddr = f"http://127.0.0.1:{cport}"
    worker, wserver = serve_worker(engine, HTTP_MODEL, port=wport,
                                   controller_addr=caddr, background=True,
                                   heartbeat=False)
    waddr = f"http://127.0.0.1:{wport}"
    try:
        print("(a)-(c), (e): the sequential worker:", flush=True)
        seq = _http_sequential(engine, params, cfg, caddr, waddr, infos,
                               b1_ms, total)
        streams_peak = _http_open_streams(worker, infos)
        print("(d): history through the prefix cache:", flush=True)
        _http_history(params, cfg, root, caddr, infos[0], engine.tokenizer,
                      total)
        print("(f): grounding:", flush=True)
        _http_ground(engine, waddr, ground_info, total)
        print("(g): the batcher worker:", flush=True)
        batched = _http_batcher(params, cfg, root, infos, engine, caddr,
                                total)
        print("(h): the host geometry route:", flush=True)
        d_host = _http_host_route(params, cfg, root, infos[0], engine, total)
        _check("(a)-(f) worker errors", worker.n_errors == 1,
               f"{worker.n_errors} request errors (1 expected: the open "
               f"stream past the cap) over "
               f"{worker.n_requests} requests")
    finally:
        wserver.shutdown()
        wserver.server_close()
        cserver.shutdown()
        cserver.server_close()
    del params, engine
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s, peak device "
          f"memory {peak / 2**30:.2f} GiB; first stream chunk after "
          f"{seq['ttfc'] * 1e3:.1f} ms, then {seq['stream_ms']:.2f} ms per "
          f"token (captured {b1_ms:.2f}); {worker.MAX_OPEN_STREAMS} open "
          f"streams peak {streams_peak / 2**30:.2f} GiB; batcher "
          f"{batched['tps']:.1f} "
          f"tokens/s; after the eight sampling overrides peak "
          f"{batched['override_peak'] / 2**30:.2f} GiB, the bypass engine's "
          f"DecodeGraphs {batched['graph_entries']} entries; host route's "
          f"first-step logits within {d_host:.4f}; launches "
          f"{ {k: v for k, v in total.items() if v} }; {_card()}",
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 18: the variants and real weights
# ---------------------------------------------------------------------------

# (a) w8a8: the first-step logits of the w8a8 model lie within
# W8A8_GAP_FACTOR times the int8 weight-only model's own distance to the
# bf16 model's (RMS over the vocabulary, the same question and weights):
# w8a8 keeps the int8 weights and rounds the activations too, one more
# rounding of the same size; the control (the weights' scales left off)
# must read at least 4x the bound
W8A8_GAP_FACTOR = 2.0
W8A8_BATCH = 8                 # the batched hit's rows
LLAVA3D_BUDGET = 3096          # the reference's voxel budget
REAL_LAYERS = 2                # (e)'s decoder depth
NEWLINE_TOKENS = {"frame": 197, "no_token": 196}   # at g = 14


def _rms(a, b) -> float:
    import torch

    d = (a.float() - b.float())
    if not bool(torch.isfinite(d).all()):
        return float("inf")
    return float(d.pow(2).mean().sqrt())


def _w8a8_phase(params, cfg, root: str, info, total: dict) -> None:
    """(a): int8 weight-only and w8a8 trees made from phase 18's bf16
    weights; the logit bound and its control, phase 4's path on both
    (captured ms/token, prefill, peak, exact launches: one
    ``torch._int_mm`` per projection and head of every forward), the ids
    of the two answers up to a near-tie, one B=8 suffix batch on a
    cached prefix."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import llava_video3d as lv3d
    from video3d_tpu_torch.models import quant

    int8 = quant.quantize_tree(params, bits=8)
    w8a8 = quant.quantize_tree(params, bits=8, act="int8")
    engine = _make_engine(params, cfg, root)
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "w8a8")[0]
    batch, vf = engine._prepare_generation(q)
    with torch.inference_mode():
        vf = lv3d.encode_video(params, cfg, batch.images,
                               batch.patch_coords).spliceable
    l16 = _first_step_logits(params, cfg, batch, vf)
    l8 = _first_step_logits(int8, cfg, batch, vf)
    lw = _first_step_logits(w8a8, cfg, batch, vf)
    gap = _rms(l8, l16)
    bound = W8A8_GAP_FACTOR * gap
    d = _rms(lw, l8)
    _check("(a) w8a8 first-step logits vs int8 weight-only", d <= bound,
           f"RMS {d:.4f} (max |d| {float((lw - l8).abs().max()):.4f}); "
           f"bound {W8A8_GAP_FACTOR} x the int8 vs bf16 RMS {gap:.4f} = "
           f"{bound:.4f}; w8a8 vs bf16 RMS {_rms(lw, l16):.4f}")
    bare = {k: v for k, v in w8a8.items()}
    bare["llm"] = _unscaled(w8a8["llm"])
    c = _rms(_first_step_logits(bare, cfg, batch, vf), l8)
    _check("(a) control, the w8a8 weights' scales left off",
           c >= 4 * bound, f"RMS {c:.4f} (must be >= {4 * bound:.4f})")
    del bare
    # a divergence of the answers is a near-tie when the two ids' logits
    # lie within twice the first-step distance of the two models
    tie = 2 * float((lw - l8).abs().max())
    rows = {}
    for tag, p in (("int8 weight-only", int8), ("w8a8", w8a8)):
        print(f"  (a) {tag}, phase 4's path (bf16 KV cache):", flush=True)
        res = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        part, ms = run_main_path(p, cfg, root, info, results=res)
        rows[tag] = (ms, torch.cuda.max_memory_allocated(), res)
        _add_launches(total, part)
    steps = _forwards(rows["w8a8"][2][0])
    per_step = 7 * cfg.llm.num_hidden_layers + 1
    print(f"  (a) torch._int_mm calls: {per_step} a decode step (7 x "
          f"{cfg.llm.num_hidden_layers} projections + the head) and "
          f"{per_step} a prefill; the answer's {steps} steps", flush=True)
    eos = engine.ecfg.eos_token_id
    eng8 = _make_engine(int8, cfg, root)
    for i, (a, b) in enumerate(zip(rows["int8 weight-only"][2],
                                   rows["w8a8"][2])):
        want = _with_eos(a.tokens[0, :int(a.lengths[0])].tolist(), eos,
                         MAX_NEW)
        got = _with_eos(b.tokens[0, :int(b.lengths[0])].tolist(), eos,
                        MAX_NEW)
        qi = _questions(info["sample_idx"], SCANQA_TEXTS, "smoke")[i]
        _near_tie_check(f"(a) answer {i}: w8a8 ids vs int8's first 8",
                        int8, cfg, eng8, qi, want[:8], got[:8], tie)
    print(f"  (a) captured B=1 decode: w8a8 {rows['w8a8'][0]:.2f} ms/token, "
          f"int8 weight-only {rows['int8 weight-only'][0]:.2f} (phase 6's "
          f"int8 line above: int8 weights and an int8 KV cache); peaks "
          f"{rows['w8a8'][1] / 2**30:.2f} / "
          f"{rows['int8 weight-only'][1] / 2**30:.2f} GiB; {_card()}",
          flush=True)
    # one batched hit: W8A8_BATCH questions on the cached scene prefix
    eng = _make_engine(w8a8, cfg, root, prefix_cache_scenes=2)
    qs = _questions(info["sample_idx"], PREFIX_TEXTS[:W8A8_BATCH], "w8b")
    eng.generate_answer(qs[0])
    before = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = eng.generate_answers_batch_prefix(qs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    part = _launch_delta(before)
    _add_launches(total, part)
    res = eng.results[-1]
    _check("(a) w8a8 B=8 suffix batch on the cached prefix",
           len(texts) == W8A8_BATCH and eng.prefix_cache_stats[0]
           == W8A8_BATCH and int(res.tokens.shape[0]) == W8A8_BATCH,
           f"{len(texts)} answers, prefix hits {eng.prefix_cache_stats}, "
           f"{int(res.lengths.sum())} ids in {wall:.3f} s; "
           f"torch._int_mm calls {part[quant.W8A8_COUNT]}")
    _decode_forwards([res], cfg.llm.vocab_size)
    del int8, w8a8, engine, eng, eng8


def _unscaled(tree):
    """``tree`` with every W8A8Weight's scales set to 1 (the control)."""
    from video3d_tpu_torch.models.quant import W8A8Weight

    if isinstance(tree, W8A8Weight):
        return W8A8Weight(tree.q, tree.scale.new_ones(tree.scale.shape))
    if isinstance(tree, dict):
        return {k: _unscaled(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unscaled(v) for v in tree]
    return tree


def _llava3d_phase(params, cfg, root: str, info, total: dict) -> None:
    """(b): one llava3d answer (budget 3096) on phase 18's weights; the
    dedup's means against a float64 host loop over the same pooled
    features and the order the engine drew; the voxel count, the block's
    length, the dedup's and the block prefill's ms."""
    import numpy as np
    import torch

    from video3d_tpu_torch.config import World3DConfig
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import llava_video3d as lv3d
    from video3d_tpu_torch.ops.voxel_dedup import (linearize_voxels,
                                                   voxel_dedup_features)

    cfg3 = dataclasses.replace(cfg, world_3d=dataclasses.replace(
        World3DConfig.from_reference_string("avg-discrete-llava3d"),
        llava3d_budget=LLAVA3D_BUDGET))
    engine = _make_engine(params, cfg3, root)
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "l3d")[0]
    engine.generate_answer(q)                     # warm-up, not counted
    before = dict(_build.LAUNCHES)
    text = engine.generate_answer(q)
    torch.cuda.synchronize()
    _add_launches(total, _launch_delta(before))
    res = engine.results[-1]
    _decode_forwards([res], cfg.llm.vocab_size)
    V, images, patch = engine._video_arrays(info["sample_idx"])
    with torch.inference_mode():
        pooled, _ = lv3d.encode_video_pooled(params, cfg3,
                                             images[:, :V].to(torch.bfloat16))
        feats = pooled[0].reshape(-1, pooled.shape[-1])
        coords = patch[0, :V].reshape(-1, 3)
        keys = engine._llava3d_order_keys(feats.shape[0])
        grid = cfg3.world_3d.voxel.grid_dims
        t_dedup = _median_ms(lambda: voxel_dedup_features(
            feats, coords, grid, LLAVA3D_BUDGET, keys), 5)
        block, mask = voxel_dedup_features(feats, coords, grid,
                                           LLAVA3D_BUDGET, keys)
    ids = linearize_voxels(coords, grid).cpu().numpy()
    f64 = feats.double().cpu().numpy()
    uniq, inv = np.unique(ids, return_inverse=True)
    sums = np.zeros((len(uniq), f64.shape[1]))
    np.add.at(sums, inv, f64)
    means = sums / np.bincount(inv)[:, None]
    k = keys.numpy()[:len(uniq)]
    take = min(len(uniq), LLAVA3D_BUDGET)
    order = np.argsort(k, kind="stable")[:take]
    want = means[order]
    got = block[:take].double().cpu().numpy()
    err = np.abs(got - want)
    tol = 2.0 ** -8 * np.abs(want) + 1e-5 * np.abs(f64).max()
    _check("(b) llava3d dedup means vs a float64 host loop",
           bool((err <= tol).all()) and int(mask.sum()) == take,
           f"{len(uniq)} unique voxels of {len(ids)} patches, {take} "
           f"genuine of {LLAVA3D_BUDGET} tokens; max |d| {err.max():.2e} "
           f"(bf16 rounding of the means)")
    batch, vf = engine._prepare_generation(q)
    with torch.inference_mode():
        t_pre = _median_ms(lambda: gen.prefill_multimodal(
            params, cfg3, batch, batch.text_ids.shape[1] + 1, vf), 3)
    _check("(b) llava3d answer", isinstance(text, str)
           and int(batch.seq_len[0]) > LLAVA3D_BUDGET
           and vf.shape[1] == LLAVA3D_BUDGET,
           f"{int(res.lengths[0])} ids; block {vf.shape[1]} tokens in a "
           f"{int(batch.seq_len[0])}-token prompt (bucket "
           f"{batch.text_ids.shape[1]}); dedup {t_dedup:.2f} ms, prefill "
           f"{t_pre:.1f} ms; {_card()}")


def _newline_phase(params, cfg, root: str, info, total: dict) -> None:
    """(c): an answer at FRAME and at NO_TOKEN, a miss then a prefix hit
    of the same question (the hit's ids the miss's up to a near-tie);
    ONE_TOKEN, which JAX cannot run, refused."""
    import torch

    from video3d_tpu_torch.config import NewlinePosition
    from video3d_tpu_torch.kernels import _build

    q = _questions(info["sample_idx"], SCANQA_TEXTS, "nl")[0]
    for mode, want_t in NEWLINE_TOKENS.items():
        cfg_m = dataclasses.replace(cfg,
                                    newline_position=NewlinePosition(mode))
        engine = _make_engine(params, cfg_m, root, prefix_cache_scenes=2)
        eos = engine.ecfg.eos_token_id
        before = dict(_build.LAUNCHES)
        miss = engine.generate_answer(q)
        hit = engine.generate_answer(q)
        torch.cuda.synchronize()
        _add_launches(total, _launch_delta(before))
        a, b = engine.results[-2], engine.results[-1]
        _check(f"(c) {mode}: tokens per frame and the prefix cache",
               cfg_m.tokens_per_frame == want_t
               and engine.prefix_cache_stats == [1, 1]
               and isinstance(miss, str) and isinstance(hit, str),
               f"{cfg_m.tokens_per_frame} vision tokens a frame, prefix "
               f"hits/misses {engine.prefix_cache_stats}")
        _near_tie_check(
            f"(c) {mode}: the hit's ids vs the miss's", params, cfg_m,
            engine, q,
            _with_eos(a.tokens[0, :int(a.lengths[0])].tolist(), eos,
                      MAX_NEW),
            _with_eos(b.tokens[0, :int(b.lengths[0])].tolist(), eos,
                      MAX_NEW), CROSS_TIE)
    cfg_1 = dataclasses.replace(cfg,
                                newline_position=NewlinePosition.ONE_TOKEN)
    try:
        _make_engine(params, cfg_1, root).generate_answer(q)
        refused = ""
    except ValueError as e:
        refused = str(e)
    _check("(c) one_token refused", "one_token" in refused, refused)


def _res_projector_phase(params, cfg, root: str, info, total: dict) -> None:
    """(d): an mlp2x_res2x_gelu projector (drawn on the card) in phase
    18's model: one answer, and the projector's bf16 output on the
    tower's features of the scene within bf16 rounding of its f32 plain
    version; the control (the residual of the raw input) must miss."""
    import torch

    from video3d_tpu_torch.config import ProjectorConfig
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import llava_video3d as lv3d
    from video3d_tpu_torch.models import siglip

    ptype = "mlp2x_res2x_gelu"
    dev = torch.device("cuda", 0)
    cfg_r = dataclasses.replace(cfg, projector=ProjectorConfig(ptype))
    proj = lv3d.init_projector(cfg.vision.hidden_size, cfg.llm.hidden_size,
                               dev, torch.Generator(device=dev)
                               .manual_seed(19), torch.bfloat16, ptype)
    p_r = dict(params, projector=proj)
    engine = _make_engine(p_r, cfg_r, root)
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "res")[0]
    before = dict(_build.LAUNCHES)
    text = engine.generate_answer(q)
    torch.cuda.synchronize()
    _add_launches(total, _launch_delta(before))
    _decode_forwards([engine.results[-1]], cfg.llm.vocab_size)
    V, images, _ = engine._video_arrays(info["sample_idx"])
    with torch.inference_mode():
        feats = siglip.vision_tower_forward(
            params["vision"], images[0, :4].to(torch.bfloat16), cfg.vision)
        got = lv3d.project_features(proj, feats).float()
        p32 = {k: ([{n: t.float() for n, t in b.items()} for b in v]
                   if k == "res" else v.float()) for k, v in proj.items()}
        ref = lv3d.project_features(p32, feats.float())
        h = feats.float() @ p32["w1"] + p32["b1"]
        h = torch.nn.functional.gelu(h) @ p32["w2"] + p32["b2"]
        for blk in p32["res"]:
            hn = lv3d._layer_norm(h, blk["ln_s"], blk["ln_b"])
            h = h + torch.nn.functional.gelu(hn @ blk["w1"] + blk["b1"]) \
                @ blk["w2"] + blk["b2"]
    bound = 2.0 ** -5 * float(ref.abs().max())
    d = float((got - ref).abs().max())
    c = float((h - ref).abs().max())
    _check(f"(d) {ptype}: answer and projector output vs f32 plain",
           isinstance(text, str) and d <= bound,
           f"max |d| {d:.4f} over 4 frames x {feats.shape[1]} patches "
           f"(bound {bound:.4f}, |out| up to {float(ref.abs().max()):.2f})")
    _check(f"(d) control, the residual of the raw input", c >= 4 * bound,
           f"max |d| {c:.4f} (must be >= {4 * bound:.4f}); identity and "
           f"the pooler are refused on the video path (JAX fails there)")


def _real_weights_phase(cfg, root: str, info, dev, total: dict) -> None:
    """(e): full width, REAL_LAYERS decoder layers: init_model, then
    export_llava_checkpoint (f32 safetensors + config.json) into a
    temporary directory, then load_pretrained_model; the loaded tree bit
    for bit the original, the greedy ids of both trees equal."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models.builder import load_pretrained_model
    from video3d_tpu_torch.models.weights import export_llava_checkpoint
    from video3d_tpu_torch.params import init_model

    cfg2 = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=REAL_LAYERS))
    p2 = init_model(cfg2, dev, torch.Generator(device=dev).manual_seed(23),
                    torch.bfloat16)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        export_llava_checkpoint(p2, cfg2.llm, cfg2, out)
        t_write = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(out, "model.safetensors"))
        t0 = time.perf_counter()
        _, loaded, lcfg, _ = load_pretrained_model(
            out, dtype=torch.bfloat16, load_tokenizer=False, device=dev,
            vision_config=cfg2.vision)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    mismatched = [path for path, a, b in _paired(p2, loaded)
                  if not (a.dtype == b.dtype and torch.equal(a, b))]
    _check("(e) loaded tree vs the original",
           not mismatched and lcfg.world_3d == cfg2.world_3d
           and lcfg.llm == cfg2.llm,
           f"{sum(1 for _ in _paired(p2, loaded))} leaves bit for bit "
           f"(mismatched: {mismatched[:4]}); model.safetensors "
           f"{nbytes} bytes, written in {t_write:.1f} s, loaded onto the "
           f"card in {t_load:.1f} s; {_card()}")
    q = _questions(info["sample_idx"], SCANQA_TEXTS, "real")[0]
    ids = []
    for p in (p2, loaded):
        engine = _make_engine(p, lcfg, root)
        before = dict(_build.LAUNCHES)
        engine.generate_answer(q)
        torch.cuda.synchronize()
        _add_launches(total, _launch_delta(before))
        res = engine.results[-1]
        ids.append(res.tokens[0, :int(res.lengths[0])].tolist())
    _check("(e) greedy ids of the original and the loaded tree",
           ids[0] == ids[1], f"{len(ids[0])} ids, equal")
    del p2, loaded


def _paired(a, b, path=""):
    """(path, leaf of a, leaf of b) over two trees of one structure."""
    if isinstance(a, dict):
        if set(a) != set(b):
            yield path + "/keys", a, None
            return
        for k in a:
            yield from _paired(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _paired(x, y, f"{path}/{i}")
    else:
        yield path, a, b


def run_variants_and_weights(cfg, root: str, info, dev) -> dict:
    """Phase 18: (a) w8a8, (b) llava3d, (c) the FRAME and NO_TOKEN newline
    layouts, (d) a res projector, on one bf16 model of ``cfg`` drawn on
    the card, then (e) real weights on a REAL_LAYERS-layer model; returns
    the launch counts of the phase's answers, summed."""
    import torch

    from video3d_tpu_torch.params import init_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(18),
                        torch.bfloat16)
    total: dict = {}
    print("(a) w8a8:", flush=True)
    _w8a8_phase(params, cfg, root, info, total)
    gc.collect()
    torch.cuda.empty_cache()
    print("(b) llava3d:", flush=True)
    _llava3d_phase(params, cfg, root, info, total)
    print("(c) newline layouts:", flush=True)
    _newline_phase(params, cfg, root, info, total)
    print("(d) the res projector:", flush=True)
    _res_projector_phase(params, cfg, root, info, total)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print("(e) real weights:", flush=True)
    _real_weights_phase(cfg, root, info, dev, total)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches { {k: v for k, v in total.items() if v} }; {_card()}",
          flush=True)
    return total


# phase 19: the other decoder families and the other towers. Each model is
# built from seeded random weights on the card in bf16, its LLMConfig from
# builder.llm_config_from_hf fed the published config.json values below
# (nothing is downloaded); depth is cut where the model does not fit.
QWEN_MOE_HF = {   # Qwen/Qwen1.5-MoE-A2.7B config.json
    "model_type": "qwen2_moe", "vocab_size": 151936, "hidden_size": 2048,
    "intermediate_size": 5632, "num_hidden_layers": 24,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "num_experts": 60, "num_experts_per_tok": 4,
    "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632,
    "norm_topk_prob": False, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
    "max_position_embeddings": 8192, "tie_word_embeddings": False}
GEMMA_2B_HF = {   # google/gemma-2b config.json
    "model_type": "gemma", "vocab_size": 256000, "hidden_size": 2048,
    "intermediate_size": 16384, "num_hidden_layers": 18,
    "num_attention_heads": 8, "num_key_value_heads": 1, "head_dim": 256,
    "hidden_act": "gelu", "hidden_activation": "gelu_pytorch_tanh",
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "max_position_embeddings": 8192}
MIXTRAL_HF = {    # mistralai/Mixtral-8x7B-v0.1 config.json
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_local_experts": 8, "num_experts_per_tok": 2, "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "max_position_embeddings": 32768}
MPT_7B_HF = {     # mosaicml/mpt-7b config.json
    "model_type": "mpt", "d_model": 4096, "n_heads": 32, "n_layers": 32,
    "expansion_ratio": 4, "max_seq_len": 2048, "vocab_size": 50432,
    "attn_config": {"alibi": True, "alibi_bias_max": 8}}
MIXTRAL_LAYERS = 2      # of 32: the full depth is ~94 GB in bf16
MPT_LAYERS = 4          # of 32
MPT_FRAMES = 8          # the prompt within MPT-7B's max_seq_len of 2048
# the MoE block at full width, bf16 against f32 on the same bf16 inputs
# and the same routing: max |d| <= MOE_REL x max |ref| (bf16 rounds the
# (T, E, I) products, the expert outputs and their weighted sum); the
# control drops each token's largest routed expert and must read 4x
MOE_TOKENS, MOE_REL = 512, 2.0 ** -6
# phase 19 (e): a tower's or resampler's bf16 output against its f32 run
# on the card within 2^-5 of max |out| (phase 18's rule for projectors); the
# control (the two images' outputs swapped) must read 4x
TOWER_REL = 2.0 ** -5


def _family_config(hf: dict, layers: Optional[int] = None):
    """ModelConfig of a published decoder's config.json (the default
    SigLIP tower and mlp2x_gelu projector), its depth cut to ``layers``."""
    from video3d_tpu_torch.models.builder import model_config_from_hf

    cfg = model_config_from_hf(hf)
    if layers is not None:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, num_hidden_layers=layers))
    return cfg


def _family_model(name: str, cfg, seed: int, bits: int = 16):
    """Seeded random weights of ``cfg`` on the card, in bf16 or (bits 8)
    with int8 LLM projections and lm_head."""
    import torch

    from video3d_tpu_torch.params import init_model

    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, dev, torch.Generator(device=dev)
                        .manual_seed(seed), torch.bfloat16, bits=bits)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    form = "bf16" if bits == 16 else f"int{bits} / bf16"
    print(f"  {name}: {cfg.llm.num_hidden_layers} decoder layers, "
          f"{n / 1e9:.3f} B {form} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def _family_answers(name: str, params, cfg, root: str, info, total: dict,
                    hit: bool = True, frames: int = 32,
                    hit_tie: Optional[float] = CROSS_TIE, **ecfg):
    """One question through a prefix-caching engine (``ecfg``: more of its
    EngineConfig, such as a quantized ``kv_cache_dtype``): the miss (full
    prefill, the prefix stored) and, with ``hit``, the same question again
    over the stored prefix; the hit's ids equal the miss's up to a
    near-tie within ``hit_tie`` (None: the first difference is printed,
    not held). Adds the answers' launches into ``total``; then prints the
    B=1 prefill ms, the captured decode ms/token over the engine's cache
    and the peak memory. Returns (the launch delta, the engine)."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import generate as gen

    engine = _make_engine(params, cfg, root, frames=frames,
                          prefix_cache_scenes=1, **ecfg)
    q = _questions(info["sample_idx"], SCANQA_TEXTS[:1], name)[0]
    eos = engine.ecfg.eos_token_id
    before = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = [engine.generate_answer(q)]
    torch.cuda.synchronize()
    t_miss = time.perf_counter() - t0
    if hit:
        texts.append(engine.generate_answer(q))
        torch.cuda.synchronize()
    delta = _launch_delta(before)
    _add_launches(total, delta)
    stats = engine.prefix_cache_stats
    _check(f"{name}: answers", all(isinstance(t, str) for t in texts)
           and stats == ([1, 1] if hit else [0, 1]),
           f"{len(texts)} answers, prefix cache [hits, misses] {stats}; "
           f"miss {t_miss:.2f} s")
    ids = [_with_eos(d, eos, MAX_NEW) for d in engine.decoded]
    if hit and hit_tie is not None:
        _near_tie_check(f"{name}: hit ids vs miss ids", params, cfg, engine,
                        q, ids[0], ids[1], hit_tie)
    elif hit:
        m = _first_mismatch(ids[0], ids[1])
        print(f"  {name}: hit ids vs miss ids (not held): "
              + ("equal" if m is None else f"first differ at {m}"),
              flush=True)
    batch, vf = engine._prepare_generation(q)
    max_len = batch.text_ids.shape[1] + MAX_NEW
    with torch.inference_mode():
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = gen.start_decode(params, cfg, batch, max_len,
                                     vision_features=vf,
                                     cache_dtype=engine.cache_dtype)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    res = gen.generate_from_state(params, cfg, state, MAX_NEW, eos,
                                  graphs=engine._graphs)
    torch.cuda.synchronize()
    per_tok = (time.perf_counter() - t0) / _forwards(res) * 1e3
    print(f"  {name}: B=1 prefill of {int(batch.seq_len[0])} tokens "
          f"{min(ms):.1f} ms (LLM only), decode {per_tok:.2f} ms/token "
          f"captured over {_forwards(res)} steps; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return delta, engine


def _attention_launches(name: str, delta: dict, engine, layers: int,
                        prefill: str, folded: Optional[str],
                        decode: str) -> None:
    """The answers' attention launches: ``layers`` of ``prefill`` (the
    miss), of ``folded`` (the hit), and of ``decode`` per decode forward;
    every other attention kernel none."""
    forwards = sum(_forwards(r) for r in engine.results)
    want = {prefill: layers, decode: layers * forwards}
    if folded:
        want[folded] = layers
    attn = {k: v for k, v in delta.items() if v and "attention" in k}
    _check(f"{name}: attention launches", attn == want,
           f"{attn}, expected {want} ({forwards} decode forwards)")


def _moe_block_check(name: str, p, cfg, dev) -> None:
    """The MoE block at full width in bf16 against its f32 version on the
    same bf16 inputs and the same routing; the control drops each token's
    largest routed expert."""
    import torch
    import torch.nn.functional as F

    from video3d_tpu_torch.models import moe

    g = torch.Generator(device=dev).manual_seed(190)
    x = torch.randn(1, MOE_TOKENS, cfg.hidden_size, generator=g,
                    device=dev).to(torch.bfloat16)
    mc = cfg.moe
    with torch.inference_mode():
        got = moe.moe_block(p, x, mc).float()
        t_ms = _median_ms(lambda: moe.moe_block(p, x, mc), 5)
        xt = x.reshape(-1, cfg.hidden_size)
        w = moe.routing_weights(xt @ p["router"], mc, x.dtype).float()
        p32 = {k: ({n: t.float() for n, t in v.items()}
                   if isinstance(v, dict) else v.float())
               for k, v in p.items()}
        x32 = xt.float()

        def block32(weights):
            ex = p32["experts"]
            gate = torch.einsum("td,edi->tei", x32, ex["w_gate"])
            up = torch.einsum("td,edi->tei", x32, ex["w_up"])
            out = torch.einsum("tei,eid->ted", F.silu(gate) * up,
                               ex["w_down"])
            routed = torch.einsum("te,ted->td", weights, out)
            if "shared" in p32:
                sh = p32["shared"]
                shared = (F.silu(x32 @ sh["w_gate"]) * (x32 @ sh["w_up"])) \
                    @ sh["w_down"]
                routed = routed + shared * torch.sigmoid(
                    x32 @ p32["shared_gate"])
            return routed

        ref = block32(w)
        top = w.argmax(-1)
        dropped = block32(w.scatter(-1, top[:, None], 0.0))
        flips = float((moe.routing_weights(x32 @ p32["router"], mc,
                                           torch.float32) > 0).ne(w > 0)
                      .any(-1).float().mean())
    bound = MOE_REL * float(ref.abs().max())
    d = float((got.reshape(ref.shape) - ref).abs().max())
    c = float((dropped - ref).abs().max())
    _check(f"{name}: MoE block bf16 vs f32 ({MOE_TOKENS} tokens, "
           f"{mc.num_experts} experts, top-{mc.num_experts_per_tok})",
           d <= bound, f"max |d| {d:.4f} (bound {bound:.4f} = 2^-6 x "
           f"max |ref| {float(ref.abs().max()):.3f}); {t_ms:.3f} ms a "
           f"bf16 block; f32 routing picks another expert set on "
           f"{flips:.1%} of the tokens (both sides use the bf16 routing)")
    _check(f"{name}: MoE control, each token's top expert dropped",
           c >= 4 * bound, f"max |d| {c:.4f} (must be >= {4 * bound:.4f})")


# phase 19 (b): Gemma-2B's requests through the paged batcher, in waves as
# phase 8's (each wave's first admission misses, storing the scene's prefix
# and evicting the other scene's, the rest hit and share its pages), and
# the scene-grouped batched answers at batch_size=8
GEMMA_SERVE_WAVES = ((0, 8), (1, 7), (0, 1))
GEMMA_BATCH = 8


def _quant_tie(params, cfg, engine, qs, hits) -> float:
    """The near-tie bound of two paths over a quantized cache that may
    quantize different keys: a B=8 suffix attends its own raw K/V and a
    B=1 hit the suffix as written to the cache; a miss attends raw K/V
    throughout, a hit the prefix as stored (which request of a batcher's
    wave misses is up to its threads). Twice the largest first-step
    distance between the B=1 hits' logits (``hits``) and a full prefill's
    of the same questions, measured here, and at least CROSS_TIE."""
    import torch

    from video3d_tpu_torch.models import generate as gen

    dist = 0.0
    for q, h in zip(qs, hits):
        batch, vis = engine._prepare_generation(q)
        with torch.inference_mode():
            full, _, _ = gen.prefill_multimodal(
                params, cfg, batch, batch.text_ids.shape[1] + MAX_NEW,
                vision_features=vis, cache_dtype=engine.cache_dtype)
        dist = max(dist, float((h[0] - full[0].float()).abs().max()))
    tie = max(CROSS_TIE, 2 * dist)
    print(f"  the B=1 hits' first steps over the {engine.ecfg.kv_cache_dtype}"
          f" prefix lie up to {dist:.4f} from full prefills of the same "
          f"questions: near-tie bound {tie:.4f} across paths", flush=True)
    return tie


def _gemma_batched_answers(params, cfg, root: str, info, total: dict,
                           kv: str = "bfloat16",
                           logit_atol: Optional[float] = None) -> float:
    """A miss stores the scene prefix; ``prepare_answers_batch_prefix``
    then takes the next GEMMA_BATCH questions as one suffix batch over it
    (B5 at hd 256 in every layer, over the ``kv`` cache's prefix); its
    launches go into ``total``. A bf16 cache: row 0's first-step logits
    within LOGIT_ATOL of a full prefill (control: one position early), and
    every answer's ids those of a B=1 full prefill of its question, up to
    a near-tie. A quantized cache (phase 19 (f)): the first-step logits of
    the batch and of a B=1 hit, and one decode step from each, within
    ``logit_atol`` of the same steps with the quantized forms' twins
    swapped in (control: the scales one position off), and every answer's
    ids those of the question asked alone over the same cached prefix (a
    B=1 hit), up to a near-tie (int8: CROSS_TIE; int4: ``_quant_tie``'s
    measured bound). Returns the near-tie bound used."""
    import torch

    from video3d_tpu_torch.kernels import _build

    sfx = "" if kv == "bfloat16" else f"_{kv}"
    tag = f"gemma{sfx}"
    engine = _make_engine(params, cfg, root, prefix_cache_scenes=1,
                          scene_cache_scenes=1, kv_cache_dtype=kv)
    qs = _questions(info["sample_idx"], PREFIX_TEXTS[:GEMMA_BATCH + 1],
                    f"gemma_batch{sfx}")
    full = None if sfx else _make_engine(params, cfg, root,
                                         scene_cache_scenes=1)
    for e in (engine, full):
        if e is not None:
            for q in qs:
                e._tokenize_prompt(q)
    engine.generate_answer(qs[0])
    before = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep = engine.prepare_answers_batch_prefix(qs[1:])
    _check(f"{tag}: the batched answers take the prefix path",
           prep is not None and prep["mode"] == "prefix_batch",
           f"prepare_answers_batch_prefix -> "
           f"{None if prep is None else prep['mode']}")
    engine.answers_from_prefix_batch(prep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = _launch_delta(before)
    _add_launches(total, delta)
    L = cfg.llm.num_hidden_layers
    forwards = _forwards(engine.results[-1])
    attn = {k: v for k, v in delta.items() if v and "attention" in k}
    want = {f"shared_prefix_attention_hd256{sfx}": L,
            f"decode_attention_hd256{sfx}": L * forwards}
    _check(f"{tag}: the batched answers' attention launches", attn == want,
           f"{attn}, expected {want} ({forwards} decode forwards)")
    eos = engine.ecfg.eos_token_id
    batch_ids = [_with_eos(d, eos, MAX_NEW)
                 for d in engine.decoded[-GEMMA_BATCH:]]
    if sfx:
        _check_quant_cache_steps(params, cfg, engine, prep, qs[1],
                                 logit_atol, kv, decode_step=True,
                                 label=f"{tag}: ")
        ref = engine
        for q in qs[1:]:
            engine.generate_answer(q)          # B=1 hits, one at a time
        ref_ids = [_with_eos(d, eos, MAX_NEW)
                   for d in engine.decoded[-GEMMA_BATCH:]]
        tie = CROSS_TIE if kv == "int8" else _quant_tie(
            params, cfg, engine, qs[1:], engine.first_logits[-GEMMA_BATCH:])
        what = "a B=1 hit"
    else:
        got = engine.first_logits[-1][0]
        ref_logits, early, _ = _full_prefill_logits(params, cfg, engine,
                                                    qs[1])
        diff = float((got - ref_logits).abs().max())
        control = float((got - early).abs().max())
        _check("gemma: B=8 row 0's first-step logits vs full prefill",
               diff <= LOGIT_ATOL and bool(torch.isfinite(got).all()),
               f"max |d| {diff:.4f} (bound {LOGIT_ATOL}; |logits| up to "
               f"{float(ref_logits.abs().max()):.2f})")
        _check("gemma: first-step logits control, one position early",
               control >= 2 * LOGIT_ATOL,
               f"max |d| {control:.4f} (must be >= {2 * LOGIT_ATOL})")
        ref = full
        for q in qs[1:]:
            full.generate_answer(q)
        ref_ids = [_with_eos(d, eos, MAX_NEW) for d in full.decoded]
        what = "a full prefill"
        tie = CROSS_TIE
    equal = sum(_near_tie_check(
        f"{tag}: batched answer {i} ids vs {what}", params, cfg, ref, q,
        want_ids, got_ids, tie)
        for i, (q, want_ids, got_ids) in enumerate(zip(qs[1:], ref_ids,
                                                      batch_ids)))
    print(f"  {tag}: B={GEMMA_BATCH} suffix batch over a "
          f"{prep['entry'].prefix_len}-token prefix: {wall / GEMMA_BATCH:.4f}"
          f" s per question (prep included); {equal} of {GEMMA_BATCH} "
          f"answers equal to {what}'s", flush=True)
    return tie


def _gemma_serve(params, cfg, root: str, scenes, paged: bool,
                 kv: str = "bfloat16"):
    """GEMMA_SERVE_WAVES through an 8-slot batcher (paged: pages of
    SERVE_PAGE with shared prefix pages, timed; else dense rows) on an
    engine caching one scene's prefix, over the ``kv`` cache (pools of
    that dtype): (engine, batcher, handles, chunk log, launch delta,
    wall)."""
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.serve import batcher as sb

    engine = _make_engine(params, cfg, root, prefix_cache_scenes=1,
                          scene_cache_scenes=1, kv_cache_dtype=kv)
    for s, n in GEMMA_SERVE_WAVES:
        for q in scenes[s][:n]:
            engine._tokenize_prompt(q)
    log, orig = {"chunks": []}, sb.paged_decode_chunk
    if paged:
        batcher, log, chunk_fn = _timed_batcher(engine, None)
        sb.paged_decode_chunk = chunk_fn
    else:
        batcher = sb.ContinuousBatcher(engine, num_slots=SERVE_SLOTS,
                                       chunk=SERVE_CHUNK)
    handles = []
    try:
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s, n in GEMMA_SERVE_WAVES:
            handles += _serve_wave(batcher, engine, scenes[s][:n],
                                   len(handles))
        wall = time.perf_counter() - t0
        delta = _launch_delta(before)
        if paged:
            _wait_for(lambda: not batcher._shared and
                      batcher._alloc.available == batcher.total_pages - 1)
    finally:
        sb.paged_decode_chunk = orig
        batcher.shutdown()
    return engine, batcher, handles, log, delta, wall


def _gemma_paged_batcher(params, cfg, root: str, infos, total: dict,
                         kv: str = "bfloat16", tie: float = CROSS_TIE):
    """The paged batcher at 8 slots over two scenes (prefix pages aliased
    by every hit of a wave) over pools of the ``kv`` cache's dtype: B7 at
    hd 256 (its int8 / int4 form) in every decode step, eager (each graph
    key's first chunk) and captured; its launches go into ``total``. Every
    page comes back; every answer's ids the dense batcher's on the same
    requests, up to a near-tie within ``tie``; the first paged step
    against the dense step (phase 8's check, captured against eager)."""
    sfx = "" if kv == "bfloat16" else f"_{kv}"
    tag = f"gemma{sfx}"
    scenes = [_questions(info["sample_idx"], PREFIX_TEXTS[:8],
                         f"gemma_serve{sfx}{i}_")
              for i, info in enumerate(infos)]
    engine, batcher, handles, log, delta, wall = _gemma_serve(
        params, cfg, root, scenes, paged=True, kv=kv)
    _add_launches(total, delta)
    free = batcher._alloc.available
    _check(f"{tag}: every page back after the last eviction",
           not batcher._shared and free == batcher.total_pages - 1,
           f"available {free} of {batcher.total_pages - 1}, shared entries "
           f"{len(batcher._shared)}")
    misses = len(GEMMA_SERVE_WAVES)
    hits = sum(n for _, n in GEMMA_SERVE_WAVES) - misses
    _check(f"{tag}: prefix sharing",
           batcher.prefix_share_stats == [hits, 2]
           and engine.prefix_cache_stats == [hits, misses],
           f"batcher [shared admissions, creations] "
           f"{batcher.prefix_share_stats}, engine [hits, misses] "
           f"{engine.prefix_cache_stats}")
    L = cfg.llm.num_hidden_layers
    steps = SERVE_CHUNK * len(log["chunks"])
    attn = {k: v for k, v in delta.items() if v and "attention" in k}
    want = {f"paged_attention_hd256{sfx}": L * steps,
            "flash_attention_hd256": L * misses,
            f"flash_attention_folded_hd256{sfx}": L * hits}
    _check(f"{tag}: the paged batcher's attention launches", attn == want,
           f"{attn}, expected {want} ({steps} decode steps)")
    _, _, dense, _, _, _ = _gemma_serve(params, cfg, root, scenes,
                                        paged=False, kv=kv)
    eos = engine.ecfg.eos_token_id
    qs = [q for s, n in GEMMA_SERVE_WAVES for q in scenes[s][:n]]
    equal = sum(_near_tie_check(
        f"{tag}: paged request {i} ids vs dense", params, cfg, engine, q,
        _with_eos(d.tokens, eos, budget), _with_eos(h.tokens, eos, budget),
        tie)
        for i, (q, (budget, h, _), (_, d, _)) in enumerate(zip(qs, handles,
                                                              dense)))
    tokens = sum(len(h.tokens) for _, h, _ in handles)
    chunks = sorted(log["chunks"])
    ms_chunk = chunks[len(chunks) // 2]
    print(f"  {tag}: paged batcher, {len(handles)} requests, {tokens} output "
          f"tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s over "
          f"{SERVE_SLOTS} slots; median {ms_chunk / SERVE_CHUNK:.2f} ms per "
          f"step over {len(chunks)} chunks; {equal} of {len(handles)} "
          f"answers equal to the dense batcher's; {_card()}", flush=True)
    _check_paged_vs_dense(params, cfg, engine, scenes[0][:2], scenes[1][0])


# phase 19 (f): Gemma-2B over quantized caches, each in the configuration
# the repo serves Qwen2 with that cache: (weight bits, kv cache dtype):
# phase 10's int4 cache over bf16 weights (phase 10 runs it over int4
# weights), phase 6's int8 weights and int8 cache
GEMMA_QUANT = ((16, "int4"), (8, "int8"))
# Its first steps (and one decode step) through the hd-256 kernels against
# the same steps with their plain versions in f32 swapped in. The kernel
# rounds p x value scale to bf16 before its PV product, as the TPU kernel
# does, and its output once; over 18 layers that moved Gemma-2B's logits
# (|logits| up to 8.9) by 0.25-0.30 over either cache on an H100 80GB HBM3
# (700 W), above phase 10's 0.25 (measured on Qwen2's hd-128 kernels), so
# both caches are held to phase 6's bound; the control (the scales one
# position off) read 11.2-12.8, and must read twice the bound
GEMMA_QUANT_LOGIT_ATOL = INT8_LOGIT_ATOL


def _gemma_quantized(params, cfg, root: str, infos, total: dict,
                     kv: str) -> None:
    """Phase 19 (f), one configuration: Gemma-2B's answer (a miss, then a
    prefix hit, captured decode), the B=8 batched answers and the paged
    batcher against the dense one, over the ``kv`` cache: every attention
    launch on the quantized hd-256 forms (the misses' prefill on B2's
    bf16 form), counted exactly. Ids across paths are held to CROSS_TIE
    over an int8 cache; over an int4 cache, where paths that quantize
    different keys differ by more, to ``_quant_tie``'s measured bound (the
    hit's ids against its miss's are printed: that bound is measured after
    them)."""
    t0 = time.perf_counter()
    delta, engine = _family_answers(
        f"gemma_{kv}", params, cfg, root, infos[0], total, kv_cache_dtype=kv,
        hit_tie=CROSS_TIE if kv == "int8" else None)
    _attention_launches(f"gemma_{kv}", delta, engine,
                        cfg.llm.num_hidden_layers, "flash_attention_hd256",
                        f"flash_attention_folded_hd256_{kv}",
                        f"decode_attention_hd256_{kv}")
    del engine
    tie = _gemma_batched_answers(params, cfg, root, infos[0], total, kv=kv,
                                 logit_atol=GEMMA_QUANT_LOGIT_ATOL)
    _gemma_paged_batcher(params, cfg, root, infos, total, kv=kv, tie=tie)
    print(f"  gemma_{kv}: (f) took {time.perf_counter() - t0:.1f} s",
          flush=True)


def _families_llm(root: str, infos, total: dict) -> None:
    """Phase 19 (a) - (d): the decoders of the other families."""
    import torch

    from video3d_tpu_torch.serve.batcher import ContinuousBatcher

    dev = torch.device("cuda", 0)
    info = infos[0]
    print("(a) LLaVA over Qwen1.5-MoE-A2.7B (full width and depth):",
          flush=True)
    cfg = _family_config(QWEN_MOE_HF)
    params = _family_model("Qwen1.5-MoE-A2.7B", cfg, 191)
    delta, engine = _family_answers("qwen2-moe", params, cfg, root, info,
                                    total)
    L = cfg.llm.num_hidden_layers
    _attention_launches("qwen2-moe", delta, engine, L, "flash_attention",
                        "flash_attention_folded", "decode_attention")
    _moe_block_check("qwen2-moe", params["llm"]["layers"][0]["moe"], cfg.llm,
                     dev)
    del params, engine
    gc.collect()
    torch.cuda.empty_cache()

    print("(b) LLaVA over Gemma-2B (full width and depth, head_dim 256):",
          flush=True)
    cfg = _family_config(GEMMA_2B_HF)
    params = _family_model("Gemma-2B", cfg, 192)
    delta, engine = _family_answers("gemma", params, cfg, root, info, total)
    _attention_launches("gemma", delta, engine, cfg.llm.num_hidden_layers,
                        "flash_attention_hd256",
                        "flash_attention_folded_hd256",
                        "decode_attention_hd256")
    del engine
    t0 = time.perf_counter()
    _gemma_batched_answers(params, cfg, root, info, total)
    _gemma_paged_batcher(params, cfg, root, infos, total)
    print(f"  gemma: the batched answers and the paged batcher took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for bits, kv in GEMMA_QUANT:
        if bits != 16:
            del params
            gc.collect()
            torch.cuda.empty_cache()
            params = _family_model("Gemma-2B", cfg, 192, bits=bits)
        print(f"(f) Gemma-2B, {'bf16' if bits == 16 else f'int{bits}'} "
              f"weights over an {kv} cache:", flush=True)
        _gemma_quantized(params, cfg, root, infos, total, kv)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    print(f"(c) Mixtral-8x7B (full width, {MIXTRAL_LAYERS} of 32 layers):",
          flush=True)
    cfg = _family_config(MIXTRAL_HF, MIXTRAL_LAYERS)
    params = _family_model("Mixtral-8x7B", cfg, 193)
    delta, engine = _family_answers("mixtral", params, cfg, root, info,
                                    total, hit=False)
    _attention_launches("mixtral", delta, engine, MIXTRAL_LAYERS,
                        "flash_attention", None, "decode_attention")
    _moe_block_check("mixtral", params["llm"]["layers"][0]["moe"], cfg.llm,
                     dev)
    del params, engine
    gc.collect()
    torch.cuda.empty_cache()

    print(f"(d) MPT-7B (full width, {MPT_LAYERS} of 32 layers, ALiBi, "
          f"{MPT_FRAMES} frames):", flush=True)
    cfg = _family_config(MPT_7B_HF, MPT_LAYERS)
    params = _family_model("MPT-7B", cfg, 194)
    delta, engine = _family_answers("mpt", params, cfg, root, info, total,
                                    hit=False, frames=MPT_FRAMES)
    attn = {k: v for k, v in delta.items() if v and "attention" in k}
    _check("mpt: plain attention with the ALiBi bias", not attn,
           f"attention kernel launches {attn} (the bias keeps every layer "
           f"on the plain path, as JAX)")
    try:
        ContinuousBatcher(engine, num_slots=2, paged=True)
        refused = "no error"
    except ValueError as e:
        refused = f"ValueError: {e}"
    _check("mpt: the paged batcher refuses ALiBi",
           refused.startswith("ValueError"), refused)
    del params, engine
    gc.collect()
    torch.cuda.empty_cache()


def _tower_entry(name: str, fwd32, fwd16, total_ms: list,
                 control: str = "swap") -> None:
    """A tower's (or resampler's) bf16 output on two images against its f32
    run: within TOWER_REL x max |f32|. The control must read 4x the bound:
    "swap", the two images' outputs swapped (per-patch outputs); "shift",
    the output's channels shifted by one (a pooled or latent output, which
    random weights make depend little on the image)."""
    import torch

    with torch.inference_mode():
        got = fwd16().float()
        ref = fwd32().float()
        ms = _median_ms(fwd16, 3)
    total_ms.append(ms)
    bound = TOWER_REL * float(ref.abs().max())
    d = float((got - ref).abs().max())
    broken = ref.flip(0) if control == "swap" else ref.roll(1, dims=-1)
    c = float((broken - ref).abs().max())
    _check(f"{name}: bf16 vs f32 on the card", d <= bound
           and bool(torch.isfinite(got).all()),
           f"{tuple(got.shape)}, max |d| {d:.4f} (bound {bound:.4f}); "
           f"{ms:.2f} ms in bf16")
    what = "the two images swapped" if control == "swap" \
        else "channels shifted by one"
    _check(f"{name}: control, {what}", c >= 4 * bound,
           f"max |d| {c:.4f} (must be >= {4 * bound:.4f})")


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32_tree(v) for v in tree]
    return tree.float()


def _families_towers(dev) -> None:
    """Phase 19 (e): the towers and resamplers at published widths, each
    on two images."""
    import torch

    from video3d_tpu_torch.config import VisionConfig
    from video3d_tpu_torch.models import clip, hf_vision, imagebind
    from video3d_tpu_torch.models import resampler as rs
    from video3d_tpu_torch.models import siglip

    print("(e) towers and resamplers (published widths, two images):",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(195)
    times: list = []
    bf = torch.bfloat16

    def pixels(size):
        return torch.randn(2, 3, size, size, generator=gen, device=dev)

    # CLIP ViT-L/14-336, select_layer -2, alone and under S2
    ccfg = VisionConfig(hidden_size=1024, intermediate_size=4096,
                        num_hidden_layers=24, num_attention_heads=16,
                        image_size=336, patch_size=14, layer_norm_eps=1e-5)
    cp = clip.init_clip(ccfg, dev, gen, bf)
    cp32 = _f32_tree(cp)
    px = pixels(336)
    _tower_entry("CLIP ViT-L/14-336", lambda: clip.clip_tower_forward(
        cp32, px, ccfg), lambda: clip.clip_tower_forward(cp, px.to(bf), ccfg),
        times)
    px3 = pixels(1008)
    _tower_entry("CLIP ViT-L/14-336 under S2 (336, 672, 1008)",
                 lambda: clip.clip_s2_forward(cp32, px3, ccfg),
                 lambda: clip.clip_s2_forward(cp, px3.to(bf), ccfg), times)
    with torch.inference_mode():
        feats = clip.clip_tower_forward(cp, px.to(bf), ccfg)
    del cp, cp32, px3
    # hf: SigLIP so400m with each feature_select mode
    scfg = VisionConfig()
    sp = siglip.init_vision_tower(scfg, dev, gen, bf)
    sp32 = _f32_tree(sp)
    spx = pixels(scfg.image_size)
    for mode in ("patch", "cls_patch", "slicefour_patch",
                 "slicefour_cls_patch"):
        _tower_entry(
            f"hf: SigLIP so400m feature_select {mode}",
            lambda m=mode: hf_vision.hf_vision_tower_forward(
                sp32, spx, scfg, "siglip", -2, m),
            lambda m=mode: hf_vision.hf_vision_tower_forward(
                sp, spx.to(bf), scfg, "siglip", -2, m), times)
    del sp, sp32
    # OpenCLIP ViT-H-14
    ocfg = VisionConfig(hidden_size=1280, intermediate_size=5120,
                        num_hidden_layers=32, num_attention_heads=16,
                        image_size=224, patch_size=14, layer_norm_eps=1e-5)
    op = clip.init_clip(ocfg, dev, gen, bf)
    op32 = _f32_tree(op)
    opx = pixels(224)
    _tower_entry("OpenCLIP ViT-H-14", lambda: hf_vision.open_clip_tower_forward(
        op32, opx, ocfg), lambda: hf_vision.open_clip_tower_forward(
        op, opx.to(bf), ocfg), times)
    del op, op32
    # ImageBind-Huge vision
    icfg = imagebind.ImageBindConfig()
    ip = imagebind.init_imagebind(icfg, dev, gen, bf)
    ip32 = _f32_tree(ip)
    _tower_entry("ImageBind-Huge vision",
                 lambda: imagebind.imagebind_vision_forward(ip32, opx, icfg),
                 lambda: imagebind.imagebind_vision_forward(
                     ip, opx.to(bf), icfg), times, "shift")
    del ip, ip32
    # the resamplers on the CLIP features (2, 576, 1024)
    D = ccfg.hidden_size
    f32 = feats.float()
    hw = (ccfg.image_size, ccfg.image_size)
    pool = rs.init_spatial_pool(D, D, dev, gen, dtype=bf)
    pool32 = _f32_tree(pool)
    _tower_entry("spatial_pool (conv, stride 2)",
                 lambda: rs.apply_resampler("spatial_pool", pool32, f32,
                                            images_hw=hw, mode="conv"),
                 lambda: rs.apply_resampler("spatial_pool", pool, feats,
                                            images_hw=hw, mode="conv"), times)
    noise = torch.rand(feats.shape[:2], generator=gen, device=dev)
    _tower_entry("masked_drop (fixed, ratio 0.5)",
                 lambda: rs.apply_resampler("masked_drop", {}, f32,
                                            noise=noise, training=True),
                 lambda: rs.apply_resampler("masked_drop", {}, feats,
                                            noise=noise, training=True),
                 times)
    per = rs.init_perceiver(D, dev, gen, dtype=bf)
    per32 = _f32_tree(per)
    _tower_entry("perceiver (3 layers, 32 latents)",
                 lambda: rs.apply_resampler("perceiver", per32, f32),
                 lambda: rs.apply_resampler("perceiver", per, feats), times,
                 "shift")
    qf = rs.init_qformer(D, dev, gen, dtype=bf)
    qf["query_tokens"] = torch.randn(qf["query_tokens"].shape, generator=gen,
                                     device=dev).to(bf)
    qf32 = _f32_tree(qf)
    _tower_entry("qformer (bert-base, 32 queries)",
                 lambda: rs.apply_resampler("qformer", qf32, f32),
                 lambda: rs.apply_resampler("qformer", qf, feats), times,
                 "shift")
    print(f"  (e): {len(times)} entries, {sum(times):.1f} ms of bf16 forwards",
          flush=True)


def run_families(root: str, infos, dev) -> dict:
    """Phase 19: (a) LLaVA over Qwen1.5-MoE-A2.7B, (b) over Gemma-2B (also
    through the batched prefix answers and the paged batcher, over the two
    scenes of ``infos``; (f) all of it again over an int4 cache and, with
    int8 weights, over an int8 cache), (c) Mixtral-8x7B cut to
    MIXTRAL_LAYERS layers,
    (d) MPT-7B cut to MPT_LAYERS layers, each from seeded random weights in
    bf16 through the engine; (e) the towers and resamplers. Returns the
    main paths' launch counts."""
    import torch

    t_phase = time.perf_counter()
    total: dict = {}
    _families_llm(root, infos, total)
    _families_towers(dev)
    gc.collect()
    torch.cuda.empty_cache()
    missing = [k for k in HD256_KERNELS if not total.get(k)]
    _check("phase 19: the hd-256 forms launched", not missing,
           f"none launched: {missing}" if missing else
           f"{ {k: total[k] for k in HD256_KERNELS} }")
    print(f"  phase 19: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{ {k: v for k, v in total.items() if v} }; {_card()}",
          flush=True)
    return total


def _leaves(tree):
    from video3d_tpu_torch.models.quant import Int4Weight

    if tree is None:
        return
    if isinstance(tree, Int4Weight):
        yield from (tree.q4, tree.scale4)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class _Tee:
    """Standard output copied to a file as well, for consoles that keep
    only the end of a long output."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def main() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    sys.stdout = _Tee(sys.__stdout__,
                      open(os.path.join(OUT_DIR, "chip_smoke.log"), "w"))
    preconditions()
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from fixtures import make_fake_scene

    from video3d_tpu_torch.config import ModelConfig
    from video3d_tpu_torch.params import init_model

    build()
    rows, ceiling = check_kernels()
    dev = torch.device("cuda", 0)
    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"main path: ModelConfig() {cfg.vision.num_hidden_layers}+"
          f"{cfg.llm.num_hidden_layers} layers, {n_params / 1e9:.3f} B "
          f"bf16 parameters initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as root:
        infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00",
                                 n_frames=32, H=480, W=640, extend=i > 0)
                 for i in range(2)]
        ground_info = make_fake_scene(root, scene_id="scene0002_00",
                                      n_frames=32, H=480, W=640,
                                      n_objects=GROUND_OBJECTS, seed=2,
                                      extend=True)
        info = infos[0]
        greedy = []
        scanqa, b1_ms = run_main_path(params, cfg, root, info,
                                      results=greedy)
        print(f"  launches (ScanQA path): {scanqa}", flush=True)
        print("scene-prefix path:", flush=True)
        prefix = run_prefix_path(params, cfg, root, info)
        print(f"  launches (scene-prefix path): {prefix}", flush=True)
        print("serving path (paged continuous batcher):", flush=True)
        serve = run_serving(params, cfg, root, infos)
        print(f"  launches (serving path): {serve}", flush=True)
        print("grounding and Scan2Cap (phase 12):", flush=True)
        ground = run_grounding(params, cfg, root, ground_info)
        print(f"  launches (grounding and Scan2Cap): {ground}", flush=True)
        print("sampling, beam search and box-input captions (phase 13):",
              flush=True)
        decode = run_decode_modes(params, cfg, root, info, ground_info,
                                  greedy)
        print(f"  launches (phase 13): {decode}", flush=True)
        print("speculative decoding and chunked prefill (phase 14):",
              flush=True)
        spec14 = run_spec_chunked(params, cfg, root, info, infos, greedy,
                                  b1_ms)
        print(f"  launches (phase 14): {spec14}", flush=True)
        del params, greedy
        gc.collect()
        torch.cuda.empty_cache()
        int8, bench, int8_b1_ms = run_int8_paths(cfg, root, infos,
                                                 ground_info)
        gc.collect()
        torch.cuda.empty_cache()
        shallow = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, num_hidden_layers=SHALLOW_LAYERS))
        int4, int4_cache = run_int4_paths(shallow, root, infos)
        gc.collect()
        torch.cuda.empty_cache()
        train_cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm,
                                         num_hidden_layers=TRAIN_LAYERS))
        train = run_training(train_cfg, root, ground_info, dev)
        print(f"  launches (training path): {train}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        print("Gemma-2B training (phase 7b):", flush=True)
        gemma_train = run_gemma_training(root, ground_info, dev)
        print(f"  launches (Gemma-2B training path): {gemma_train}",
              flush=True)
        train = {k: v + gemma_train[k] for k, v in train.items()}
        gc.collect()
        torch.cuda.empty_cache()
        lora = run_lora_paths(cfg, train_cfg, root, info, ground_info, dev,
                              int8_b1_ms)
        print(f"  launches (phase 15): {lora}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        print("other inputs (phase 16):", flush=True)
        other = run_other_inputs(shallow, root, info, ground_info, dev)
        gc.collect()
        torch.cuda.empty_cache()
        print("serving over HTTP (phase 17):", flush=True)
        http = run_http_serving(cfg, root, infos, ground_info, dev, b1_ms)
        gc.collect()
        torch.cuda.empty_cache()
        print("variants and real weights (phase 18):", flush=True)
        variants = run_variants_and_weights(shallow, root, info, dev)
        gc.collect()
        torch.cuda.empty_cache()
        print("decoder families and towers (phase 19):", flush=True)
        families = run_families(root, infos, dev)
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        if name in PROBE_KERNELS:
            launches = bench[name]
        elif name in TRAIN_KERNELS:
            launches = train[name]
        elif name in INT8_KERNELS:
            launches = int8[name]
        elif name in INT4_KERNELS:
            launches = int4[name]
        elif name in INT4_CACHE_KERNELS:
            launches = int4_cache[name]
        else:
            launches = scanqa[name] + prefix[name] + serve[name] \
                + ground[name] + decode.get(name, 0) + spec14.get(name, 0)
        launches += lora.get(name, 0) + other.get(name, 0) \
            + http.get(name, 0) + variants.get(name, 0) \
            + families.get(name, 0)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "ms_l2_flushed": None, **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
