#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from a checkout of the repository; it needs one CUDA card and nothing
but the sources in the checkout.  Phases, in order; any failure exits
non-zero and prints no result:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every kernel of the serving and training paths with
   nvcc (sm_90a), and the sweep libraries of K2's candidate plans and of
   K3's yardstick designs, one nvcc per library, all started together;
   then the SASS of K3's design and its yardsticks (cuobjdump):
   instructions per state entry in the scan loop, and per entry and step
   in the sub-chunk loop of K3's backward (the design's, PR 24's form's);
3. kernels: hold each kernel against its plain torch version on the card
   at the main-path shape and at edge shapes, elementwise and row by row,
   show that a deliberately wrong result would fail the checks, and time
   the kernel, the plain version and (where one exists) a PyTorch
   library call as a yardstick: flash attention (K1), WKV6 (K2), then
   the Mamba selective scan (K3); K1's two variants (the Hopper one
   that the serving shapes take, and the general one) in turns at the
   main-path shape and at Jamba's 64 heads, each case checked for the
   variant it took (the Hopper variant at hd 64, 120 and 128 in bf16:
   hd 120 ragged, non-causal, softcapped, windowed, in a (b, h, s, hd)
   storage and as the first 120 columns of a 128-column storage whose
   last 8 hold 1e4; the general one at f32 hd 120), and at a wave of the
   sliding-window paths (4 x 6144 rows, window 4096: the Hopper variant
   at danube's hd 120 and at mixtral's hd 128, the general one as the
   yardstick) beside SDPA with a band mask, held to the O(s·w)
   sliding_window_attention, with a window one kv tile shorter or longer
   shown to fail, and at hd 120 the padding columns read from the next
   head or the second TMA box dropped shown to fail; at a prefill wave of
   deepseek-v3-671b's MLA (4 x 1024 rows, 128 heads, q and k 192 columns,
   v 128: the Hopper variant, the function of v zero-padded to 192 with
   o's first 128 columns), with the third q/k box dropped shown to fail,
   and the general variant on v zero-padded to 192 as the model padded it
   before (the output's columns 128..191 then exactly zero) as the
   yardstick, timed in turns (hopper, general, sdpa, sdpa, general,
   hopper; SDPA on the padded q/k/v, and on v at 128 columns where it
   takes them) beside both functions' bounds; small Hopper cases at (192,
   128): ragged, non-causal with sq != skv, softcapped, q and k the two
   halves of one 384-column storage; bf16 (192, 192) on the general
   variant; at whisper-tiny's shapes (6 heads of 64, 1500 frames, none
   causal, all on the Hopper variant): a prefill wave's encoder (4, 1500,
   1500), the cross-attention of 224-token prompts (4, 224, 1500), and of
   4- and 1-token prompts (4, 4, 1500), (2, 1, 1500), whose q tile lies
   almost wholly past sq; the first two timed in turns with SDPA
   (general, hopper, sdpa, sdpa, hopper, general); at a mesh rank's local
   heads (mistral-nemo-12b's 16 of 32 and DeepSeek-V3's 64 of 128 MLA
   heads, 2 rows of 1024; path j's 16 of 32, 1 row of 4096), timed in
   turns with SDPA; at the local shapes of phase mesh_wq (whisper-tiny's
   encoder (2, 1500, 1500, 6, 64) and cross-attention (2, 224, 1500),
   mixtral-8x7b's 16 of 32 heads, 1 row of 2048, window 4096), timed in
   turns with SDPA; at gemma3-4b's prefill waves (4, 2048, 2048, 8, 256)
   with a local layer's window 1024 and a global layer's none, on the
   Hopper variant (Hd256Tile: 64-row kv tiles, one Q buffer), its
   training mode's o bit for bit and its LSE within f32's limit of
   attention_lse (and at a small softcapped case), the fourth TMA box
   dropped, a lost kv tile and a 64-row stage read stale shown to fail,
   timed queued in turns with the general variant and SDPA (a boolean
   band mask for the window), and without and with the LSE; K2 through its
   dispatcher, and its candidate plans (G, C, CB, double buffer) in two
   passes at the main-path shape, each case checked for the plan it
   took, and a stale chunk and a lost row group shown to fail, and at a
   mesh rank's local heads (2, 1024, 16, 64) timed queued and back to
   back beside its plain version and bound; the
   SFUs' ex2 rate measured on every SM, alone and beside FFMAs; K3
   through its dispatcher, and its first design (the yardstick), the
   same with ex2.approx and the serving design checked and timed in two
   passes at the main-path shape, beside its bound and its design's
   floor, and at a mesh rank's local channels (2, 1024, 8192, 16) timed
   as K2 at its local heads;
4. main paths, each with every kernel's launch count set to 0 just
   before it and read just after, served through the port's rFaaS stack
   (ModelServer, ServeEngine, Invoker, ResourceManager, BatchSystem,
   Ledger) at full width in bf16 with seeded random weights: 8 requests,
   batch 4, 16 new tokens each; prompts of 256-1024 tokens and max_len
   2048 (a-c), 4097-6144 tokens and max_len 6160 (d, e: past the
   4096-token window), 1025-2048 tokens and max_len 2064 (r: past the
   1024-token window of gemma3-4b's local layers); each checks that
   every request gets its tokens, every logit is finite and each of its
   kernels ran as often per prefill wave as the path has layers that run
   it (and no other kernel ran), every K1 launch through the Hopper
   variant (path r's too, at hd 256: K1_VARIANT); the device
   memory of the path before is freed first; it prints the peak memory
   and the decode step's time beside the least time to read the weights
   a step reads:
   a. mistral-nemo-12b (40 layers, d_model 5120): K1 40 times a wave;
   b. rwkv6-1.6b (24 layers, d_model 2048): K2 24 times a wave, every
      launch under kernel.plan's (G, C, CB);
   c. jamba-1.5-large-398b cut in depth to 4 layers, every width as
      published (d_model 8192, 16 experts of 24576, d_inner 16384):
      layers 4-7 of a published period (attention + MLP, Mamba + MoE,
      Mamba + MLP, Mamba + MoE), 23.0 B params; K1 once and K3 3 times
      a wave.  One period (8 layers) would be 45.2 B params, 90.4 GB in
      bf16: more than the card holds;
   d. h2o-danube-3-4b (24 layers, d_model 3840, hd 120, window 4096 on
      every layer, 3.96 B params): K1 24 times a wave, Hopper variant;
   e. mixtral-8x7b cut in depth to its first 8 layers, every width as
      published (window 4096, 8 experts top-2 of 14336), 11.87 B params:
      K1 8 times a wave, Hopper variant;
   f. deepseek-v3-671b cut in depth to 2 layers without its MTP block,
      every width as published (d_model 7168, 128 heads, q_lora 1536,
      kv_lora 512, nope/rope/v 128/64/128, 256 experts top-8 of 2048
      plus 1 shared, vocab 129280 untied), 24.87 B params: MLA prefill
      through K1 at q·k 192 and v 128, twice a wave, Hopper variant;
      absorbed decode against the latent cache;
   r. gemma3-4b as published (34 layers, d_model 2560, 8 heads of 256
      over 4 KV heads, geglu, vocab 262144 tied, 3.88 B params): K1 34
      times a wave (29 local layers with window 1024, 5 global), every
      launch on the Hopper variant (Hd256Tile).
   g. whisper-tiny as published (4 + 4 layers, d_model 384, 6 heads of
      64, vocab 51865 tied, 36.44 M params), driven at its model entry
      points (prefill with frames, decode), not through the engine: the
      reference's ModelServer passes no frames.  8 requests in 2 waves
      of 4, each 1500 frames (N(0, 1) from a seed: the conv frontend is a
      stub) and a prompt of 4-224 tokens, left-padded with token 0, 32
      greedy new tokens, max_len 448: K1 12 times a wave (4 encoder, 4
      causal self-attention, 4 cross-attention with sq != skv), all
      Hopper, no other kernel, no plain version; decode attention, the
      cross-attention over the 1500 cached frames too, plain torch.
   With --profile, after each, one prefill wave (at the path's longest
   prompt) and three decode steps outside the engine, timed and traced
   with torch.profiler, the time by kernel group beside the largest
   kernels;
5. decode vs prefill: full-width f32 models cut to 2 layers (Jamba:
   layers 4-5 of a period, attention + MLP then Mamba + MoE with all 16
   experts, capacity factor 16 so that no token drops), teacher-forced
   decode against one forward over the whole sequence: the three paths
   above; h2o-danube-3-4b across its window's edge (a 4090-token
   prompt, 12 steps), with the full cache and with the ring buffer of
   4096 slots (window_cache); internvl2-76b (d_model 8192) with 256
   patch embeddings in front of the prompt; deepseek-v3-671b cut to 1
   layer (13.36 B params, 53.4 GB), capacity factor 32, the absorbed
   decode against the expanded prefill; then whisper-tiny at full width
   and depth on the card against the same model on the CPU (the same
   weights, copied across): a wave of 2 requests of 1500 frames and a
   37-token prompt, its logits and k/v/ck/cv caches, and 8 teacher-forced
   decode steps' logits, in f32 (K1's general variant, TF32 off; each
   logits row and cache within 1e-4 of its largest |value|) and in bf16
   (the Hopper variant; each row within 5e-2 of the CPU's f32 run), with
   the encoder run causal, the cross-attention's k/v taken from the
   decoder's input, and decode embedding at position length instead of 0
   each shown to fail;
   then the mesh phase (phase_mesh): DecoderLM's serving path on a (2, 2)
   ("data", "model") mesh of 4 spawned ranks, all on the one card, over
   gloo (NCCL refuses two ranks on one device; the collectives are staged
   through host memory), each rank cutting its blocks of seed-0 weights
   by the rule table: path h, mistral-nemo-12b cut to 8 layers (heads,
   MLP and vocab split over `model`, SP decode over 1024 slots a rank),
   and path i, deepseek-v3-671b cut to 1 layer (MLA's heads split, full
   EP: 64 experts a rank, tokens all-gathered over `data`), path a's 8
   prompts in 2 waves (2 rows a `data` rank), 16 new tokens; each path's
   prefill and 4 teacher-forced decode steps' logits, row by row, within
   5e-2 of the row's largest |logit| in the same model's one-device run
   on the card; a wrong shard, a missing psum and a missing pmax on one
   rank shown to fail that; K1 on every rank on local heads, all Hopper;
   rank 0's prefill and decode times, each rank's peak memory and the
   bytes each collective moved in a decode step; then path h at 2 layers
   on a one-rank NCCL mesh, the deployment backend, held the same way;
   then the mesh training phase (phase_mesh_train), path j:
   mistral-nemo-12b at full width cut to 4 layers (2.433 B params)
   trained 3 steps of 4 x 4096 tokens (the synthetic stream, seed 1) in 2
   microbatches with grad_specs, f32 accumulators, AdamW with f32 moments
   and the reference cell's cosine schedule: first on one device on the
   card (kept: each step's loss and grad_norm), then on the (2, 2) gloo
   mesh of 4 ranks sharing the card, each rank cutting its FSDP (`data`)
   and TP (`model`) blocks of the seed-0 weights; each step's loss and
   grad_norm on every rank within MESH_TRAIN_LIMIT of the one-device
   run's; at the first step's params, the row-parallel psum's backward
   left out, the `data` reduction of a gradient left out and a replicated
   leaf counted twice, each on rank (0, 1), shown to move grad_norm far
   past the limit; every kernel's launches a step on every rank the
   one-device step's and MESH_TRAIN's, K1's all Hopper; rank 0's step
   time, each rank's peak memory and the collectives' calls, bytes and
   host seconds by op a step; then the 2-layer cut for 2 steps on a
   one-rank NCCL mesh, held the same way;
   then the recurrent families' mesh phase (phase_mesh_ssm), on the same
   four gloo ranks, every width as published: path k, rwkv6-1.6b at full
   depth (16 of its 32 heads a `model` rank, K2 on them 24 times a wave),
   and path l, Jamba's 2-layer MoE cut (layers 4-5 of a period; 8 of its
   16 experts and 8192 of its 16384 Mamba channels a rank, K1 and K3 once
   a wave), and path k-bf16, rwkv6-1.6b at 2 layers in its published
   bf16, each serving path a's 8 prompts as the mesh phase does, rows and
   Jamba's Mamba state within MESH_ROW_LIMIT of the one-device run, wo's
   psum left out and u and w0 at head offset 0 (RWKV), in_proj cut as one
   contiguous block and x_proj's psum left out (Jamba), each on rank (0,
   1), shown to take the rows or the state past twice the limit;
   then path m, rwkv6-1.6b cut to 4 layers in f32, and path n, Jamba's
   2-layer dense cut in bf16, each trained 2 steps of 4 x 2048 tokens in
   2 microbatches with grad_specs, each step's loss and grad_norm on
   every rank within MESH_TRAIN_LIMIT of one device, every kernel's
   launches a step on every rank as MESH_SSM_TRAIN says; then path m at 2
   layers on a one-rank NCCL mesh, bit for bit with one device; it prints
   bytes and calls by collective a decode step and a training step, each
   rank's peak memory and the phase's wall time;
   then phase mesh_wq (phase_mesh_wq) on the same four gloo ranks: path
   o, whisper-tiny as published (WhisperLM in the reference's layout:
   every `model` rank runs K1 on all 6 heads of its rows, the MLP split
   over `model`, the vocab of 51865 whole, the self cache's slots over
   `model`) serving path g's 8 requests in 2 waves (2 rows a `data`
   rank, 1500 frames each, 4 forced then greedy tokens), each logits row
   and the caches gathered whole within MESH_ROW_LIMIT of the one-device
   run, the MLP's psum left out (rank (0, 1)) and the self cache's slots
   written and read at offset 0 (every rank) shown to fail, K1 12
   launches a rank and wave, all Hopper; path p, whisper-tiny trained 2
   steps of 16 x 448 tokens with frames (2 microbatches, grad_specs, f32
   moments); path q, mixtral-8x7b cut to 1 layer at full width (1.71 B
   params) trained 2 steps of 4 x 2048 with int8 AdamW moments and bf16
   accumulators, the reference's setting above 30 B params: each step's
   loss and grad_norm within MESH_TRAIN_LIMIT of one device, the
   lm_head's block scales (62.5 blocks a `model` rank: quantized on the
   whole row after a gather) within MESH_QUANT_SCALE_LIMIT of one
   device's, each rank's columns quantized on their own shown to fail,
   the bytes the moments' gathers bring a rank; K1's launches a rank and
   step as MESH_WHISPER_TRAIN and MESH_QUANT_TRAIN say, all Hopper;
6. K1's backward (flash_bwd): the gradients the training path takes
   (torch.autograd.grad through ops.flash_attention, whose backward
   launches the kernels of the route kernel_bwd.plan picks) against
   attention_bwd_ref on f32 copies at the training shape (4, 2048, 36,
   64) bf16 causal and at hd 128, hd 120 with a window, a softcap, f32,
   sq != skv without the causal mask, a strided storage, an expanded GQA
   view, hd 64 with a window and a softcap, hd 128 with sq != skv, and sq
   = 1000 (ragged TMA boxes), and whisper-tiny's training shapes without
   the causal mask, the cross-attention (16, 448, 1500, 6, 64) and the
   encoder (16, 1500, 1500, 6, 64), path j's local heads (1, 4096,
   4096, 16, 128) and path q's (1, 2048, 2048, 16, 128), window 4096;
   above hd 128 on the general route: gemma3-4b's training shape (2,
   2048, 2048, 8, 256) with a local layer's window 1024 and a global
   layer's none (the Hopper forward in training mode; the general route
   reads its LSE, its stats kernel computing D alone), DeepSeek-V3's MLA
   wave (4, 1024, 1024, 128) at q·k 192 with v, o and dO at 128 columns
   unpadded (its forward on the Hopper MlaTile, no LSE; the stats kernel
   recomputes it), hd 256 in f32, with a softcap and as an expanded GQA
   view (bf16: the forward's LSE read);
   each case checked for its route and for where its LSE came from
   ("hopper": the forward's LSE, preprocess, dK/dV, dQ on TMA and wgmma;
   "general": stats, dK/dV, dQ on mma.sync); two calls bit for bit; a
   backward with D dropped, the softcap derivative dropped, a kv tile
   skipped, the LSE of the neighbouring row, the LSE in log2 units, or a
   Q/dO ring stage read one tile stale, or dK's and dV's columns past 128
   dropped (gemma's global shape, with the LSE of the neighbouring row and
   in log2 units there too) shown to fail the checks; at the
   training shape, at hd 128 and at paths j's and q's local heads, timed
   in turns: the Hopper backward
   (each kernel alone and the whole call), the general one as the
   yardstick, SDPA's backward, and K1's forward with and without the
   LSE, beside the bound; at gemma's global shape and MLA's wave the
   general backward in turns with SDPA's backward, each of its kernels,
   the forward and the plain version, beside the bound and the design's
   floor, and at gemma's the call and its stats kernel reading the
   forward's LSE and recomputing it in turns, the forward without and
   with it;
7. K2's backward (wkv6_bwd): the gradients the training path takes
   (torch.autograd.grad through ops.wkv6, whose backward launches the
   backward kernel on the route kernel_bwd.plan picked before the forward,
   "hopper" from the forward's checkpoints or "general", and K2's forward
   kernel run backward in time for dv and dS_0) against wkv6_bwd_ref at
   the training shape (4, 2048, 32, 64) in bf16 and f32, and on strided
   views, with nonzero S_0 and dS_T, at s = 1000 and 2047, with w down to
   0, and at hd 16 and 24; each case's route printed and held to
   WKV_BWD_ROUTES; every gradient row held to its scale
   (checks.bwd_row_scales), finite, two calls bit for bit; the G update
   without its decay, dw one step late, du over one batch row and dk
   without its u term shown to fail; at the training shape the forward in
   training mode held bit for bit to serving mode and its checkpoints to
   the plain ones, the general route held to the limits too, and timed in
   turns: both routes' calls and each kernel alone, the forward with and
   without checkpoints, every Hopper tile of the sweep library (each held
   to the limits), the plain backward, beside the bound (wkv_bwd_bound);
8. K3's backward (scan_bwd): the gradients the training path takes
   (torch.autograd.grad through ops.selective_scan, whose forward runs in
   training mode and stores the state every 16 steps, and whose backward
   launches kernel_bwd's two kernels on those checkpoints: the reverse
   pass, the dB/dC sum) against selective_scan_bwd_ref at the training
   shape (4, 2048, 16384, 16) in bf16 and f32, with B and C strided views
   of the projection, nonzero h_0 and dh_T, s = 1000 and 2047, N = 8 and
   4, exponentials that underflow, shuffled A, and long-memory decays
   held to an f64 backward; every gradient row held to its scale
   (checks.bwd_row_scales), finite, two calls bit for bit, the forward
   launches counted in training mode; dB over one channel block, dA one
   step late, dx without D and the states recomputed without their decay
   shown to fail; at the training shape the forward's training mode held
   bit for bit to serving mode and its checkpoints to those of PR 24's
   "ckpt" kernel, PR 24's form (the sweep library) held to the limits and
   to the design, and timed in turns (PR 24's form, the design, the
   design, PR 24's form): the call, each kernel of each alone, the
   forward with and without checkpoints, the plain backward, beside the
   bound (scan_bwd_bound);
9. train, each path of TRAIN_PATHS in bf16 through
   repro_torch.launch.train, 6 steps of 4 x 2048 tokens (but gemma3-4b's
   4 of 2 x 2048), every loss
   finite, counts set to 0 before each step and read after it, no plain
   version called, one step profiled by kernel group:
   a. minicpm-2b (40 layers, d_model 2304, 2.72 B params) with WSD: K1
      80 forward launches and 40 backward calls (120 kernel launches:
      preprocess, dK/dV, dQ) a step, all on the "hopper" route;
      F.embedding's backward bit for bit twice; no stats kernel in the
      profiled step;
   b. rwkv6-1.6b (24 layers, d_model 2048, 1.60 B params) with cosine:
      K2 48 forward launches (under kernel.plan's choice) and 24 backward
      calls (48 kernel launches: bwd, dv) a step, all on the "hopper"
      route, no K1 and no K3;
   c. jamba-1.5-large-398b cut to 2 layers, both dense (attention + MLP,
      Mamba + MLP: layers 4 and 6 of a period), every width as published
      (2.85 B params) with cosine: K1 2 forward launches and 1 backward
      call (3 launches) and K3 2 forward launches (both in training mode)
      and 1 backward call (2 launches: bwd, sum) a step, K1 all "hopper";
      K3's launches a step printed;
   d. whisper-tiny as published (36.44 M params), not through
      launch/train.py (which feeds no frames, as the reference's does
      not): make_train_step with AdamW (weight decay 0.01) and the cosine
      schedule, 6 steps of 16 x 448 tokens (the synthetic stream, seed 1)
      and 16 x 1500 frames: K1 20 forward launches (4 encoder, 8 decoder
      twice: the forward and its recompute) and 12 backward calls (36
      launches) a step, all "hopper", no stats kernel;
   e. gemma3-4b as published (3.88 B params) with cosine, 4 steps of 2 x
      2048 (4 x 2048 would pass the card with its 262144-wide logits): K1
      68 forward launches a step on the Hopper variant in training mode
      and 34 backward calls (102 launches: stats, dK/dV, dQ) on the
      "general" route, each reading its forward's LSE (every path's
      backward calls do: none recomputes it);
   then a 2-layer cut of minicpm-2b at full width, whose gradients under
   remat policy None and "dots" equal those without remat, bit for bit;
10. jamba_moe_grad: the 2-layer MoE cut of jamba-1.5-large-398b
    (attention + MLP, Mamba + MoE with all 16 experts; 11.9 B params) in
    bf16: JambaLM.loss and its gradients on 1 x 2048 tokens, no
    optimizer; loss, aux loss and every gradient finite, every expert
    that received a token with nonzero gradients, its peak memory;
11. train_restart: examples/train_elastic_torch.py (4 layers at d_model
    128): train, checkpoint, drop, restore bit for bit, continue, and
    hold the losses to an uninterrupted run bit for bit, eval batches on
    rFaaS-leased executors, the ledger's bill;
12. the kernels line (K1, K1's backward, K2, K2's backward, K3, K3's
    backward, each with its launches by path, Whisper's path g and its
    training among K1's, the mesh paths' K1, K2 and K3 launches summed
    over their ranks; K2 and K3 with their times at a mesh rank's local
    shape), the card line and the result line, last.

The Whisper phases print their own wall times.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
JAMBA = "jamba-1.5-large-398b"
DANUBE = "h2o-danube-3-4b"
MIXTRAL = "mixtral-8x7b"
INTERNVL = "internvl2-76b"
DEEPSEEK = "deepseek-v3-671b"
GEMMA = "gemma3-4b"
# Depth cuts of the published configs; every width stays as published.
# Jamba's main path: layers 4-7 of a period (one attention layer, then
# three Mamba layers, MoE on the 2nd and 4th).  Mixtral's: its first 8
# of 32 layers (11.87 B params; all 32 are 46.7 B, 93 GB in bf16).
# DeepSeek-V3's: 2 of 61 layers (24.87 B params, 49.7 GB in bf16; a third
# layer, 36.4 B and 72.8 GB, leaves no room for a wave) without the MTP
# block, which prefill and decode never read and which would add one more
# MoE layer (about 11.6 B params).
PATH_CUTS = {JAMBA: dict(n_layers=4, attn_layer_period=4,
                         attn_layer_offset=0),
             MIXTRAL: dict(n_layers=8),
             DEEPSEEK: dict(n_layers=2, mtp_depth=0)}
# Decode-vs-prefill models: 2 layers each; Jamba's are layers 4-5 of a
# period (attention + MLP, Mamba + MoE).  DeepSeek-V3's is 1 layer
# without the MTP block (13.36 B params, 53.4 GB in f32).
DECODE_CUTS = {"mistral-nemo-12b": dict(n_layers=2),
               "rwkv6-1.6b": dict(n_layers=2),
               JAMBA: dict(n_layers=2, attn_layer_period=2,
                           attn_layer_offset=0),
               DANUBE: dict(n_layers=2),
               INTERNVL: dict(n_layers=2),
               DEEPSEEK: dict(n_layers=1, mtp_depth=0)}
# Path g: whisper-tiny as published (4 + 4 layers, d_model 384, 6 heads of
# 64, vocab 51865 tied), driven at its model entry points (prefill with
# frames, decode), as the reference's launch cells drive it: the
# reference's ModelServer passes no frames.  Each request: 1500 frames
# (30 s of audio after the conv frontend, which is a stub: N(0, 1) from a
# seed) and a prompt of 4-224 tokens drawn from seed 0 (Whisper's
# previous-text prompt and its start sequence); a wave left-padded with
# token 0 to its longest prompt; 32 greedy new tokens each; max_len 448,
# the released decoder's context.
WHISPER = "whisper-tiny"
WHISPER_SERVE = dict(requests=8, batch=4, prompt=(4, 224), new_tokens=32,
                     max_len=448)
# Whisper's training path: 16 x 448 tokens of the synthetic stream (seed
# 1) and 16 x 1500 frames a step, 6 steps
WHISPER_TRAIN = dict(batch=16, seq=448, steps=6)
# Whisper on the card against the same model on the CPU (full width and
# depth, the same weights): a wave of 2 requests of 1500 frames and a
# 37-token prompt, then 8 teacher-forced decode steps; each logits row
# within WHISPER_ROW_LIMIT of the row's largest |logit| of the CPU's f32
# run.  f32: the card runs K1's general variant and cuBLAS with TF32 off,
# and sums in other orders than the CPU.  bf16 (the Hopper variant):
# weights and activations rounded to bf16 (2^-9 relative) through 8
# layers and the head, against f32.
WHISPER_CHECK = dict(batch=2, prompt=37, steps=8, max_len=48)
WHISPER_ROW_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# Phase mesh: DecoderLM's serving path on a ("data", "model") mesh of
# MESH_SHAPE ranks, all on the one card.  NCCL refuses two ranks on one
# device, so they join over gloo (every collective staged through host
# memory: slow here, and no figure for NCCL on NVLink); the deployment
# backend, NCCL with one rank a card, serves MESH_NCCL on a one-rank
# mesh.  Path h: mistral-nemo-12b cut to 8 of 40 layers, every width as
# published (3.6 GB of weights a rank: `data` dims stored whole); path i:
# deepseek-v3-671b cut to 1 of 61 layers without the MTP block (13.36 B
# params), full EP: 64 of its 256 experts a rank.  Knobs:
# optimized_overrides(arch, "decode_32k").  Traffic as path a's: the same
# 8 prompts of 256-1024 tokens in waves of 4 (2 rows a `data` rank),
# max_len 2048 (1024 slots a `model` rank), 16 new tokens, the first
# MESH_FORCED of them teacher-forced (tokens from seed 29), greedy after.
MESH_SHAPE = (2, 2)
MESH_PATHS = {"mistral-nemo-12b": dict(n_layers=8),
              DEEPSEEK: dict(n_layers=1, mtp_depth=0)}
MESH_NCCL = ("mistral-nemo-12b", dict(n_layers=2))
MESH_FORCED = 4
# Each logits row of the mesh (prefill and the forced steps) within
# MESH_ROW_LIMIT of the row's largest |logit| in the one-device run on
# the card, as phase_whisper_card_vs_cpu holds bf16: both sides round
# weights and activations to bf16 (2^-9 relative); the mesh also rounds
# each row-parallel partial sum and the SP decode's q and probabilities
# to bf16 (the reference's SP numerics) and sums full EP's combine in
# bf16, through the layers and the head.  A wrong shard or a lost
# collective errs by O(1) of the row's scale.
MESH_ROW_LIMIT = 5e-2
# the phase's deadline: a rank that fails or hangs fails the phase
MESH_DEADLINE_S = 900
# Decode-vs-prefill traffic where it is not a 6-token prompt and 5 steps:
# danube's 4090-token prompt and 12 steps cross its 4096-token window in
# decode, with the full cache and again with the ring buffer of 4096
# slots (window_cache), which wraps; internvl2's prompt follows 256 patch
# embeddings (its published n_vision_patches).
DECODE_TRAFFIC = {DANUBE: dict(prompt=4090, steps=12, ring=True),
                  INTERNVL: dict(patches=256)}
# each main path and the launches of each kernel per prefill wave: one
# per layer that runs it
MAIN_PATHS = {"mistral-nemo-12b": {"flash_attention": 40},
              "rwkv6-1.6b": {"wkv6": 24},
              JAMBA: {"flash_attention": 1, "selective_scan": 3},
              DANUBE: {"flash_attention": 24},
              MIXTRAL: {"flash_attention": 8},
              DEEPSEEK: {"flash_attention": 2},
              GEMMA: {"flash_attention": 34}}
# the K1 forward variant and backward route every launch of a path takes,
# where they are not both "hopper": gemma3-4b's hd 256 takes the Hopper
# forward (Hd256Tile; in training mode it writes the LSE) and the general
# backward, which reads that LSE
K1_VARIANT = {GEMMA: ("hopper", "general")}
# each main path's traffic: prompt lengths drawn from seed 0 in [lo, hi]
# and max_len; the sliding-window paths' prompts all pass their 4096-token
# window (gemma3-4b's, its local layers' 1024-token one), so it bites in
# prefill and in every decode step
SHORT_TRAFFIC = ((256, 1024), 2048)
TRAFFIC = {DANUBE: ((4097, 6144), 6160), MIXTRAL: ((4097, 6144), 6160),
           GEMMA: ((1025, 2048), 2064)}
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor cores
              torch.float32: 67e12}            # CUDA cores, no TF32
SMS, BOOST_HZ = 132, 1.98e9                    # H100 SXM
# exp2 on the SFUs: 16 results a clock per SM (CUDA C++ programming
# guide, arithmetic instruction throughput, compute capability 9.0).  K3's
# bound takes the larger of this and the rate phase_ex2_rate measures, at
# 132 SMs and the 1.98 GHz boost clock.
GUIDE_EX2_PER_CLOCK = 16
# f32 FMA-pipe instructions: 128 a clock per SM, as many as the four
# schedulers dispatch (one warp instruction a clock each), so an
# instruction of any pipe takes a dispatch slot of this rate
PEAK_FMA_INSTR_PER_S = 128 * SMS * BOOST_HZ
# Elementwise limit (atol = rtol).  f32: the kernel tests' 2e-5.  bf16:
# both sides round the output to bf16, and at |out| ~ 1-4 one bf16 ulp is
# 0.008-0.03, so an absolute 1e-2 plus 1e-2 of |ref|.
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# Limit on ||out - ref|| / ||ref|| of every (b, q, h) row.  bf16: the
# kernel rounds P to bf16 (relative 2^-9) and the output to bf16 (2^-9),
# so ~3e-3 at most.  A row that loses the key it attends to errs by O(1).
ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# name, (b, sq, skv, h, hd[, dv]) (dv: v's and o's columns where fewer
# than hd), dtype, causal, window, softcap, layout of q/k/v ("plain" (b,
# s, h, hd); "strided": a (b, h, s, hd) storage; "padded": the first hd
# columns of a (b, s, h, 128) storage whose other columns hold 1e4;
# "zero-v": v's columns from 128 on zero; "qk-halves": q and k the two
# halves of one (b, s, h, 2 hd) storage), the variant kernel.plan must
# pick
FLASH_CASES = [
    ("main-path", (4, 1024, 1024, 32, 128), torch.bfloat16, True, 0, 0.0,
     "plain", "hopper"),
    ("window", (1, 257, 257, 4, 64), torch.float32, True, 64, 0.0, "plain",
     "general"),
    ("minicpm-hd12", (2, 100, 100, 6, 12), torch.float32, True, 0, 0.0,
     "plain", "general"),
    ("softcap-hd256", (1, 96, 96, 2, 256), torch.bfloat16, True, 0, 30.0,
     "plain", "hopper"),
    ("ragged-noncausal", (1, 64, 192, 2, 64), torch.float32, False, 0, 0.0,
     "plain", "general"),
    ("strided-gemma-hd16", (2, 130, 130, 4, 16), torch.float32, True, 16,
     0.0, "strided", "general"),
    ("ragged-wave", (4, 916, 916, 32, 128), torch.bfloat16, True, 0, 0.0,
     "plain", "hopper"),
    ("window-257", (2, 700, 700, 8, 128), torch.bfloat16, True, 257, 0.0,
     "plain", "hopper"),
    ("window-64", (1, 257, 257, 4, 64), torch.bfloat16, True, 64, 0.0,
     "plain", "hopper"),
    ("noncausal-hd64", (1, 200, 333, 4, 64), torch.bfloat16, False, 0, 0.0,
     "plain", "hopper"),
    ("softcap-30", (1, 300, 300, 4, 128), torch.bfloat16, True, 0, 30.0,
     "plain", "hopper"),
    ("strided-hd128", (1, 300, 300, 4, 128), torch.bfloat16, True, 0, 0.0,
     "strided", "hopper"),
    ("jamba-64-heads", (4, 1024, 1024, 64, 128), torch.bfloat16, True, 0,
     0.0, "plain", "hopper"),
    # hd 120 (h2o-danube-3-4b): two TMA boxes a row, the second's columns
    # 120..127 zero-filled by TMA
    ("ragged-wave-hd120", (4, 916, 916, 32, 120), torch.bfloat16, True, 0,
     0.0, "plain", "hopper"),
    ("noncausal-hd120", (1, 200, 333, 4, 120), torch.bfloat16, False, 0,
     0.0, "plain", "hopper"),
    ("softcap-30-hd120", (1, 300, 300, 4, 120), torch.bfloat16, True, 0,
     30.0, "plain", "hopper"),
    ("window-257-hd120", (2, 700, 700, 8, 120), torch.bfloat16, True, 257,
     0.0, "plain", "hopper"),
    ("strided-hd120", (1, 300, 300, 4, 120), torch.bfloat16, True, 0, 0.0,
     "strided", "hopper"),
    ("padded-hd120", (2, 300, 300, 4, 120), torch.bfloat16, True, 0, 0.0,
     "padded", "hopper"),
    ("f32-hd120", (1, 300, 300, 4, 120), torch.float32, True, 0, 0.0,
     "plain", "general"),
    # a wave of the sliding-window paths: 4 prompts padded to 6144, window
    # 4096, hd 120 (danube) and 128 (mixtral)
    ("danube-window-4096", (4, 6144, 6144, 32, 120), torch.bfloat16, True,
     4096, 0.0, "plain", "hopper"),
    ("mixtral-window-4096", (4, 6144, 6144, 32, 128), torch.bfloat16, True,
     4096, 0.0, "plain", "hopper"),
    # a prefill wave of deepseek-v3-671b's MLA: 128 heads, q and k 128
    # nope + 64 rope, v 128 (the Hopper variant); and the general variant
    # on v zero-padded to 192 as mla_prefill padded it before ("zero-v"),
    # the yardstick
    ("mla-hd192", (4, 1024, 1024, 128, 192, 128), torch.bfloat16, True, 0,
     0.0, "plain", "hopper"),
    ("mla-hd192-general", (4, 1024, 1024, 128, 192), torch.bfloat16, True,
     0, 0.0, "zero-v", "general"),
    # MLA's head dims at small shapes: a ragged wave, sq != skv without the
    # causal mask, a softcap, q and k as the two halves of one storage;
    # bf16 (192, 192), which no Hopper instantiation takes
    ("ragged-mla", (1, 1000, 1000, 8, 192, 128), torch.bfloat16, True, 0,
     0.0, "plain", "hopper"),
    ("noncausal-mla", (1, 200, 333, 4, 192, 128), torch.bfloat16, False, 0,
     0.0, "plain", "hopper"),
    ("softcap-30-mla", (1, 300, 300, 4, 192, 128), torch.bfloat16, True, 0,
     30.0, "plain", "hopper"),
    ("qk-halves-mla", (2, 500, 500, 4, 192, 128), torch.bfloat16, True, 0,
     0.0, "qk-halves", "hopper"),
    ("square-hd192", (1, 300, 300, 4, 192), torch.bfloat16, True, 0, 0.0,
     "plain", "general"),
    # whisper-tiny (6 heads of 64, 1500 frames), none causal: a prefill
    # wave's encoder, the cross-attention of a wave of 224-token prompts,
    # and of 4- and 1-token prompts, whose one q tile lies almost wholly
    # past sq (TMA zero-fills its rows, the epilogue stores none of them)
    ("whisper-encoder", (4, 1500, 1500, 6, 64), torch.bfloat16, False, 0,
     0.0, "plain", "hopper"),
    ("whisper-cross", (4, 224, 1500, 6, 64), torch.bfloat16, False, 0, 0.0,
     "plain", "hopper"),
    ("whisper-cross-4", (4, 4, 1500, 6, 64), torch.bfloat16, False, 0, 0.0,
     "plain", "hopper"),
    ("whisper-cross-1", (2, 1, 1500, 6, 64), torch.bfloat16, False, 0, 0.0,
     "plain", "hopper"),
    # a rank's local heads on the mesh phase's (2, 2) mesh: 2 rows a `data`
    # rank, half the heads a `model` rank (mistral-nemo-12b's 16 of 32 at
    # hd 128; DeepSeek-V3's MLA 64 of 128 at (192, 128))
    ("mesh-local-heads", (2, 1024, 1024, 16, 128), torch.bfloat16, True, 0,
     0.0, "plain", "hopper"),
    ("mla-local-heads", (2, 1024, 1024, 64, 192, 128), torch.bfloat16, True,
     0, 0.0, "plain", "hopper"),
    # a rank's local heads on path j (mesh_train): 1 row of 4096 a `data`
    # rank and microbatch, mistral-nemo-12b's 16 of 32 heads a `model` rank
    ("mesh-train-local-heads", (1, 4096, 4096, 16, 128), torch.bfloat16,
     True, 0, 0.0, "plain", "hopper"),
    # a rank's local shapes on paths o and q (phase mesh_wq): whisper-tiny's
    # 2 rows a `data` rank with all 6 heads (the encoder, the cross-
    # attention of 224-token prompts); mixtral-8x7b's 1 row of 2048 and 16
    # of 32 heads, its window 4096 past the row (the causal mask)
    ("mesh-whisper-encoder", (2, 1500, 1500, 6, 64), torch.bfloat16, False,
     0, 0.0, "plain", "hopper"),
    ("mesh-whisper-cross", (2, 224, 1500, 6, 64), torch.bfloat16, False, 0,
     0.0, "plain", "hopper"),
    ("mesh-mixtral-local-heads", (1, 2048, 2048, 16, 128), torch.bfloat16,
     True, 4096, 0.0, "plain", "hopper"),
    # a prefill wave of gemma3-4b (path r): 4 prompts padded to 2048, its 8
    # heads of 256, a local layer's window 1024 and a global layer's none;
    # the Hopper variant (Hd256Tile: 64-row kv tiles, one Q buffer)
    ("gemma-local-wave", (4, 2048, 2048, 8, 256), torch.bfloat16, True,
     1024, 0.0, "plain", "hopper"),
    ("gemma-global-wave", (4, 2048, 2048, 8, 256), torch.bfloat16, True, 0,
     0.0, "plain", "hopper"),
]
# the forward faults (checks.FWD_FAULTS) a case also shows its checks
# can see
FLASH_FAULTS = {"danube-window-4096": ("pad-from-next-head",
                                       "second-box-dropped"),
                "mla-hd192": ("third-box-dropped",),
                "gemma-global-wave": ("fourth-box-dropped",)}
# the cases whose checks are also shown to see a lost kv tile and a ring
# stage read stale, by the rows of their kv tiles: (the tile's rows, how
# many rows back a stale read lands).  The main path's 128-row tiles
# (read as the tile before); hd 256's 64-row tiles (read as the tile two
# before: what the same stage of a two-stage ring held a round earlier)
STALE_STAGE = {"main-path": (128, 128), "gemma-global-wave": (64, 128)}
# the cases timed beside the main-path case, each under its own key of
# the kernels line
TIMED_FLASH_CASES = ("jamba-64-heads", "danube-window-4096",
                     "mixtral-window-4096", "mla-hd192", "whisper-encoder",
                     "whisper-cross", "mesh-local-heads", "mla-local-heads",
                     "mesh-train-local-heads", "mesh-whisper-encoder",
                     "mesh-whisper-cross", "mesh-mixtral-local-heads",
                     "gemma-local-wave", "gemma-global-wave")
# the timed cases whose SDPA call also runs in the turns of K1's variants
# (general, hopper, sdpa, sdpa, hopper, general), each timed queued
# behind a sleep of the stream: their kernels take less time than the
# host takes to launch them
SDPA_IN_TURNS = ("whisper-encoder", "whisper-cross", "mesh-local-heads",
                 "mesh-train-local-heads", "mesh-whisper-encoder",
                 "mesh-whisper-cross", "mesh-mixtral-local-heads",
                 "gemma-local-wave", "gemma-global-wave")
# cycles of torch.cuda._sleep before a queued timing's calls (about 10 ms
# at 1.98 GHz), more than the host takes to enqueue them
QUEUE_SLEEP_CYCLES = 20_000_000
# name fragments of the serving kernels K1, K2 and K3, which a profile
# prints even where they are not among a step's largest
PORT_KERNELS = ("flash_fwd_", "wkv6_kernel", "scan_pipe_kernel")
# the most bytes of f32 scores attention_ref may build as a plain version
PLAIN_SCORES_BYTES = 2 ** 32


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2, queued=False):
    """Mean device time of one call, from CUDA events around ``iters``
    calls after ``warmup`` calls.  Back to back, calls whose host work
    outlasts their kernels time the host; ``queued`` holds the stream
    (``torch.cuda._sleep``) while the host enqueues the calls, so that
    the events time their kernels alone."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phases


def kernel_ops():
    """The dispatcher module of every kernel, by name; each counts its
    launches in ``launches``."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    return {"flash_attention": flash_ops, "wkv6": wkv_ops,
            "selective_scan": scan_ops}


def phase_build():
    """One nvcc per kernel library, all started together (each ``build``
    in a thread of its own), then each library loaded: every kernel
    module's serving library, K1's, K2's and K3's backward libraries, and
    the sweep libraries of K2, K2's backward, K3 and K3's backward, which
    hold the candidates and yardsticks that phase_wkv6, phase_wkv6_bwd,
    phase_scan and phase_scan_bwd time.  Returns the libraries' paths by
    name."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import kernel_bwd
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import kernel_bwd as scan_kernel_bwd
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import kernel_bwd as wkv_kernel_bwd
    libs = [(m.NAME, m.build, m.library)
            for m in (flash_kernel, kernel_bwd, wkv_kernel, wkv_kernel_bwd,
                      scan_kernel, scan_kernel_bwd)]
    for m in (wkv_kernel, wkv_kernel_bwd, scan_kernel, scan_kernel_bwd):
        libs.append((m.SWEEP_NAME, functools.partial(m.build, True),
                     functools.partial(m.library, True)))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: lib[1](), libs))
    for _, _, load in libs:
        load()
    dt = time.perf_counter() - t0
    print(f"[build] {', '.join(name for name, _, _ in libs)} (in "
          f"parallel) in {dt:.1f} s")
    for (name, _, _), so in zip(libs, paths):
        print(f"[build] {name} -> {so.relative_to(ROOT)}")
        log = so.parent / "build.log"
        if log.exists():
            for line in ptxas_summary(log.read_text()):
                print(f"[build]   {line}")
    return {name: so for (name, _, _), so in zip(libs, paths)}


def phase_sass(paths):
    """K3's instructions per state entry, from the SASS of its serving
    design and its two yardsticks at the main-path types (bf16 x, N =
    16): cuobjdump's listing of the kernel, its innermost loop that holds
    MUFU.EX2 instructions (the unrolled one, if the compiler split the
    loop), that loop's instructions (NOPs left out) over the entries it
    updates; and of its backward's reverse pass, per entry and step, the
    design's and PR 24's form's.  Printed only: a static count, not a
    check."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    check(tool.exists(), f"no cuobjdump beside nvcc ({tool})")
    # design: (library, a fragment of its mangled name)
    kernels = {
        "first": (scan_kernel.SWEEP_NAME,
                  "11scan_kernelI13__nv_bfloat16Li16ELb0E"),
        "first-ex2": (scan_kernel.SWEEP_NAME,
                      "11scan_kernelI13__nv_bfloat16Li16ELb1E"),
        scan_kernel.DESIGN: (scan_kernel.NAME,
                             "16scan_pipe_kernelI13__nv_bfloat16Li16ELb0EE")}
    listings = {}
    for name, (lib, frag) in kernels.items():
        if lib not in listings:
            proc = subprocess.run([str(tool), "-sass", str(paths[lib])],
                                  capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0, f"cuobjdump failed on {lib}: "
                                        f"{proc.stderr[-2000:]}")
            listings[lib] = sass_functions(proc.stdout)
        found = [body for fn, body in listings[lib].items() if frag in fn]
        check(len(found) == 1, f"sass: {len(found)} functions match {name}")
        count = sass_loop_count(found[0], 16)
        print(f"[sass] selective_scan {name} ({lib}): scan loop of "
              f"{count['instr']} instructions for {count['entries']:g} "
              f"entries ({count['steps']:g} steps x 16): "
              f"{count['per_entry']:.3f} an entry; opcodes "
              f"{json.dumps(count['opcodes'])}")
    # K3's backward reverse pass, its sub-chunk loop: a lane's 16 steps of
    # its 4 entries (at N = 16), the design's and PR 24's; both form each
    # decay twice (the compiler may reuse one of the recompute's last
    # step's for the walk back's first)
    from repro_torch.kernels.mamba_scan import kernel_bwd as scan_kernel_bwd
    steps = scan_kernel_bwd.CK_STEPS * 16 // scan_kernel_bwd.LANES
    for name, lib, frag in (
            ("design", scan_kernel_bwd.NAME,
             "20scan_bwd_pipe_kernelI13__nv_bfloat16Li16E"),
            ("PR 24's form", scan_kernel_bwd.SWEEP_NAME,
             "15scan_bwd_kernelI13__nv_bfloat16Li16E")):
        proc = subprocess.run([str(tool), "-sass", str(paths[lib])],
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"cuobjdump failed on {lib}: "
                                    f"{proc.stderr[-2000:]}")
        found = [body for fn, body in sass_functions(proc.stdout).items()
                 if frag in fn]
        check(len(found) == 1, f"sass: {len(found)} functions match the "
                               f"backward's reverse pass ({name})")
        count = sass_loop_count(found[0], 4)
        print(f"[sass] selective_scan_bwd reverse pass, {name} (bf16, N = "
              f"16): sub-chunk loop of {count['instr']} instructions and "
              f"{count['entries']:g} MUFU.EX2 for {steps} entry-steps of a "
              f"lane: {count['instr'] / steps:.3f} an entry and step; "
              f"opcodes {json.dumps(count['opcodes'])}")
        if name == "design":
            hot = sass_recompute_and_walk(found[0])
            print(f"[sass] selective_scan_bwd reverse pass, design: its "
                  f"recompute and walk back (from the copies' commit to "
                  f"their wait) {hot['instr']} instructions, "
                  f"{hot['instr'] / steps:.3f} an entry and step; opcodes "
                  f"{json.dumps(hot['opcodes'])}")


def sass_recompute_and_walk(body):
    """Instructions (NOPs left out) of K3's backward reverse pass between
    the commit of the next sub-chunk's copies (the LDGDEPBAR before its
    first MUFU.EX2) and their wait (the DEPBAR after its last): the
    recompute and the walk back, without the staging and the write-out
    that the sub-chunk loop also holds."""
    ops = [op for _, op in body if op != "NOP"]
    ex2 = [i for i, op in enumerate(ops) if op.startswith("MUFU.EX2")]
    lo = max(i for i, op in enumerate(ops[:ex2[0]])
             if op.startswith("LDGDEPBAR"))
    hi = next(i for i, op in enumerate(ops) if i > ex2[-1]
              and op.startswith("DEPBAR"))
    hist = {}
    for op in ops[lo + 1:hi]:
        key = "BRA" if op.startswith("BRA") else op.split(".")[0]
        hist[key] = hist.get(key, 0) + 1
    return {"instr": hi - lo - 1,
            "opcodes": dict(sorted(hist.items(), key=lambda kv: -kv[1]))}


def sass_functions(listing):
    """{mangled name: [(address, opcode), ...]} from ``cuobjdump -sass``
    output; a branch's opcode carries its target address, ``BRA->N``."""
    funcs, body = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            body = funcs[m.group(1)] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if body is None or not m:
            continue
        addr, op, args = int(m.group(1), 16), m.group(2), m.group(3)
        target = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and target:
            op = f"BRA->{int(target.group(1), 16)}"
        body.append((addr, op))
    return funcs


def sass_loop_count(body, n_state):
    """Instructions of the innermost loop that holds MUFU.EX2 (the one
    with the most of them, if several), NOPs left out, and per state
    entry: each entry's update takes one MUFU.EX2, so the loop runs
    (MUFU.EX2 count) / ``n_state`` steps of ``n_state`` entries."""
    loops = []
    for addr, op in body:
        if op.startswith("BRA->"):
            target = int(op[5:])
            if 0 <= target <= addr:
                loops.append((target, addr))

    def ops_in(lo, hi):
        return [op for a, op in body if lo <= a <= hi and op != "NOP"]

    with_exp = [(lo, hi) for lo, hi in loops
                if any(op.startswith("MUFU.EX2") for op in ops_in(lo, hi))]
    check(with_exp, "sass: no loop holds MUFU.EX2")
    inner = [(lo, hi) for lo, hi in with_exp
             if not any((lo2, hi2) != (lo, hi) and lo <= lo2 and hi2 <= hi
                        for lo2, hi2 in with_exp)]
    lo, hi = max(inner, key=lambda r: sum(
        op.startswith("MUFU.EX2") for op in ops_in(*r)))
    ops = ops_in(lo, hi)
    entries = sum(op.startswith("MUFU.EX2") for op in ops)
    hist = {}
    for op in ops:
        key = "BRA" if op.startswith("BRA") else op.split(".")[0]
        hist[key] = hist.get(key, 0) + 1
    return {"instr": len(ops), "steps": entries / n_state,
            "entries": entries, "per_entry": len(ops) / entries,
            "opcodes": dict(sorted(hist.items(), key=lambda kv: -kv[1]))}


def _demangle(mangled):
    """`flash_fwd_hopper_kernel<128, 0>` from the mangled name of a kernel
    template in a namespace (its last name and its integer arguments)."""
    rest, names = mangled.strip()[3:], []       # after "_ZN"
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group(0)
        rest = rest[len(n):]
        names.append(rest[:int(n)])
        rest = rest[int(n):]
    args = re.findall(r"L[a-z](\d+)E", rest)
    return f"{names[-1]}<{', '.join(args)}>" if names else mangled.strip()


def ptxas_summary(log):
    """One line per kernel of nvcc's -Xptxas -v output: the kernel (its
    template arguments), registers, spills, static shared memory, and any
    performance warning of ptxas."""
    out, name = [], None
    for line in log.splitlines():
        if "Function properties for " in line:
            name = _demangle(line.split("Function properties for ")[1])
        elif "spill" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
        elif "Performance Loss" in line:
            out.append(line.strip().split(" in the function")[0])
    return out


def _flash_inputs(shape, dtype, layout, gen):
    """q, k ~ N(0, 4) and v ~ N(0, 1): scores q.k/sqrt(hd) have standard
    deviation 4, so each row's softmax is peaked on a few keys and |out|
    is O(1) in every row, however many keys it sees.  A kernel that
    loses or doubles any kv tile then moves the rows that attend into it
    by O(1), which the checks see.  ``layout``: see ``FLASH_CASES``; a
    kernel that read the "padded" storage's columns past hd would see
    scores of about 1e8; "zero-v" is "plain" with v's columns from 128 on
    zero, as MLA's prefill padded v; "qk-halves": q and k the first and
    the last hd columns of one (b, s, h, 2 hd) storage."""
    b, sq, skv, h, hd, dv = flash_dims(shape)

    def randn(s, scale, d=hd):
        if layout == "strided":       # (b, h, s, hd) seen as (b, s, h, hd)
            x = torch.randn((b, h, s, d), generator=gen, device="cuda")
            return (x.transpose(1, 2) * scale).to(dtype)
        if layout == "padded":
            x = torch.randn((b, s, h, 128), generator=gen, device="cuda")
            x = (x * scale).to(dtype)
            x[..., d:] = 1e4
            return x[..., :d]
        x = torch.randn((b, s, h, d), generator=gen, device="cuda")
        return (x * scale).to(dtype)

    q, k, v = randn(sq, 2.0), randn(skv, 2.0), randn(skv, 1.0, dv)
    if layout == "zero-v":
        v[..., 128:] = 0
    if layout == "qk-halves":
        check(sq == skv, "qk-halves needs sq == skv")
        qk = torch.cat([q, k], dim=-1)
        q, k = qk[..., :hd], qk[..., hd:]
    return q, k, v


def flash_dims(shape):
    """(b, sq, skv, h, hd, dv) of a ``FLASH_CASES`` shape; dv = hd where
    the shape gives none."""
    return (*shape, shape[4]) if len(shape) == 5 else tuple(shape)


def row_err(out, ref):
    """Worst ||out - ref|| / ||ref|| over the (b, q, h) rows."""
    out, ref = out.float(), ref.float()
    return ((out - ref).norm(dim=-1)
            / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


def flash_bound(shape, dtype, causal, window):
    """Least time for the function: bytes (q, k, v read once, o written
    once) over HBM bandwidth, or the products of the unmasked (query,
    key) pairs (2 hd for S, 2 dv for P V) over the peak rate for the
    dtype, whichever is larger."""
    b, sq, skv, h, hd, dv = flash_dims(shape)
    size = torch.finfo(dtype).bits // 8
    nbytes = (b * sq * h * (hd + dv) + b * skv * h * (hd + dv)) * size
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= i - j < window
    flops = 2 * (hd + dv) * int(mask.sum()) * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_mask(q, skv, kw):
    """SDPA's mask for K1's arguments: a boolean band where the window
    bites (SDPA then takes another backend than is_causal's), else the
    causal flag."""
    if kw["window"] and kw["window"] < skv:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(skv, device=q.device)[None, :]
        return dict(attn_mask=(i >= j) & (i - j < kw["window"]))
    return dict(is_causal=kw["causal"])


def flash_plain(shape, kw):
    """The plain version a K1 case is held to: ``attention_ref``, which
    builds the (sq, skv) f32 scores, or, where those would pass 4 GiB
    (the sliding-window paths' 6144-row waves: 19 GB), the model's
    ``sliding_window_attention``, the same function in O(s·w) memory."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.attention import sliding_window_attention
    b, sq, skv, h = shape[:4]
    if b * h * sq * skv * 4 <= PLAIN_SCORES_BYTES:
        return functools.partial(attention_ref, **kw)
    check(kw["causal"] and kw["window"] and sq == skv,
          f"no plain version fits for {shape} {kw}")
    return functools.partial(sliding_window_attention, window=kw["window"],
                             softcap=kw["softcap"])


def phase_flash():
    """K1, each case: kernel vs plain version, tolerance by dtype, and the
    variant the dispatcher took.  Returns the kernels-line entry (numbers
    at the main-path case; those of ``TIMED_FLASH_CASES`` beside them)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import checks
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry, timed = None, {}
    for (name, shape, dtype, causal, window, softcap, layout,
         variant) in FLASH_CASES:
        q, k, v = _flash_inputs(shape, dtype, layout, gen)
        kw = dict(causal=causal, window=window, softcap=softcap)
        plain = flash_plain(shape, kw)
        before = dict(flash_ops.launches_by_variant)
        with torch.inference_mode():
            out = flash_ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = plain(q, k, v)
        took = [vt for vt, n in flash_ops.launches_by_variant.items()
                if n != before[vt]]
        err = (out.float() - ref.float()).abs().max().item()
        rerr = row_err(out, ref)
        tol, rtol = TOL[dtype], ROW_TOL[dtype]
        print(f"[kernels] flash_attention {name} {tuple(shape)} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"softcap={softcap} {layout}, variant {took}: "
              f"max_abs_err {err:.3e} (limit {tol:g} + {tol:g} x |ref|), "
              f"worst row rel err {rerr:.3e} (tol {rtol:g}) against "
              f"{plain.func.__name__}")
        check(took == [variant], f"flash_attention {name}: took {took}, "
                                 f"expected [{variant!r}]")
        check(math.isfinite(err), f"flash_attention {name}: non-finite")
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        check(rerr <= rtol, f"flash_attention {name}: worst row rel err "
                            f"{rerr:.3e} > {rtol:g}")
        if layout == "zero-v":
            check(torch.equal(out[..., 128:], torch.zeros_like(
                out[..., 128:])), f"flash_attention {name}: the padded "
                                  f"columns of o are not zero")
        if 1024 <= window < shape[2]:   # a window past skv masks nothing
            _window_checks_can_fail(plain, q, k, v, ref, rtol, name)
        for fault in FLASH_FAULTS.get(name, ()):
            _forward_fault_fails(checks, plain, q, k, v, ref, tol, rtol,
                                 name, fault)
        if name in STALE_STAGE:
            _lost_and_stale_fail(plain, q, k, v, ref, rtol, name,
                                 *STALE_STAGE[name])
        if variant == "hopper" and shape[4] == 256:
            _lse_holds(flash_kernel, q, k, v, out, kw, name)
        if name in TIMED_FLASH_CASES:
            timed[name] = {"variant": variant, "max_abs_err": err,
                           **_time_flash(flash_kernel, F, q, k, v, shape,
                                         dtype, kw, name, variant,
                                         lambda: plain(q, k, v))}
        if name != "main-path":
            del q, k, v, out, ref
            continue
        entry = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
            "launches": None, "max_abs_err": err,
            **_time_flash(flash_kernel, F, q, k, v, shape, dtype, kw, name,
                          variant, lambda: plain(q, k, v)),
        }
        del q, k, v, out, ref
    check(entry is not None and set(timed) == set(TIMED_FLASH_CASES),
          "flash_attention: a timed case did not run")
    for name, numbers in timed.items():
        entry[name.replace("-", "_")] = numbers
    torch.cuda.empty_cache()
    return entry


def _lost_and_stale_fail(plain, q, k, v, ref, rtol, name, tile, back):
    """The checks can fail here: the plain version with the values of
    kv rows [512, 576) zeroed (what a kernel that lost a 64-row tile
    would return), and with the ``tile`` kv rows from 512 replaced by
    those ``back`` rows before them (what a ring stage read with a stale
    phase would hold), must each be far outside the row limit."""
    lo, hi = 512, 512 + tile
    with torch.inference_mode():
        v_lost = v.clone()
        v_lost[:, 512:576] = 0
        lost = row_err(plain(q, k, v_lost), ref)
        del v_lost
        k_stale, v_stale = k.clone(), v.clone()
        k_stale[:, lo:hi] = k[:, lo - back:hi - back]
        v_stale[:, lo:hi] = v[:, lo - back:hi - back]
        stale = row_err(plain(q, k_stale, v_stale), ref)
        del k_stale, v_stale
    print(f"[kernels] flash_attention {name}: a lost kv tile [512, 576) "
          f"gives worst row rel err {lost:.3e}; a stale stage of {tile} "
          f"rows (kv [{lo}, {hi}) read as [{lo - back}, {hi - back})) "
          f"{stale:.3e} (limit {rtol:g})")
    check(lost > 10 * rtol, f"{name}: a lost kv tile gives only "
                            f"{lost:.3e}: the check cannot see it")
    check(stale > 10 * rtol, f"{name}: a stale stage gives only "
                             f"{stale:.3e}: the check cannot see it")


def _lse_holds(flash_kernel, q, k, v, out, kw, name):
    """The Hopper forward's training mode at hd 256: its o bit for bit
    the serving call's, its LSE within f32's limit (2e-5 + 2e-5 |lse|:
    the products are exact on both sides, only the sums' order differs)
    of ``attention_lse`` on the same inputs, and so within bf16's too;
    rows past sq unwritten."""
    from repro_torch.kernels.flash_attention.ref import attention_lse
    lse = flash_kernel.lse_buffer(q).fill_(7.0)
    sq = q.shape[1]
    with torch.inference_mode():
        o_t = flash_kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse,
                                                **kw)
        want = attention_lse(q, k, **kw)
    got = lse[..., :sq]
    err = (got - want).abs().max().item()
    excess = {str(dt)[6:]: ((got - want).abs() - TOL[dt]
                            - TOL[dt] * want.abs()).max().item()
              for dt in (torch.float32, torch.bfloat16)}
    same = torch.equal(o_t, out)
    print(f"[kernels] flash_attention {name}: training mode's LSE max abs "
          f"err {err:.3e} against attention_lse, past f32's limit (2e-5 + "
          f"2e-5 |lse|) by {excess['float32']:.3e}, past bf16's by "
          f"{excess['bfloat16']:.3e}; its o and the serving o "
          f"{'bit-identical' if same else 'DIFFER'}")
    check(math.isfinite(err) and excess["float32"] <= 0,
          f"{name}: the LSE errs {err:.3e}, past f32's limit")
    check(same, f"{name}: training mode's o differs from serving's")
    check(bool((lse[..., sq:] == 7.0).all()),
          f"{name}: the LSE's rows past sq were written")
    del lse, o_t, want


def _window_checks_can_fail(plain, q, k, v, ref, rtol, name):
    """A long window's checks can fail: the plain version with the window
    one kv tile (64 keys) shorter, what a kernel that skipped one tile too
    many before the window would return, and one tile longer, what a
    kernel that kept a tile from past the window's edge would, must each
    land far outside the row limit."""
    w = plain.keywords["window"]
    with torch.inference_mode():
        errs = {dw: row_err(plain.func(q, k, v, **{**plain.keywords,
                                                   "window": w + dw}), ref)
                for dw in (-64, 64)}
    print(f"[kernels] flash_attention {name}: the window {w - 64} (a kv "
          f"tile lost at its edge) gives worst row rel err {errs[-64]:.3e}, "
          f"the window {w + 64} (a tile kept past it) {errs[64]:.3e} "
          f"(limit {rtol:g})")
    for dw, e in errs.items():
        check(e > 10 * rtol, f"{name}: the window {w + dw} gives only "
                             f"{e:.3e}: the check cannot see it")


def _forward_fault_fails(checks, plain, q, k, v, ref, tol, rtol, name,
                         fault):
    """The plain version on the inputs the Hopper forward would read with
    ``fault`` (``checks.forward_fault_inputs``) must fail the elementwise
    check (some element past tol + tol x |ref|) and land far past the
    row limit."""
    with torch.inference_mode():
        bad = plain(*checks.forward_fault_inputs(q, k, v, fault))
        bad = bad[..., :q.shape[3]]
        excess = ((bad - ref.float()).abs() - tol
                  - tol * ref.float().abs()).max().item()
        rerr = row_err(bad, ref)
    del bad
    print(f"[kernels] flash_attention {name}: a forward with {fault} gives "
          f"worst row rel err {rerr:.3e} (limit {rtol:g}) and an element "
          f"{excess:.3e} past the elementwise limit")
    check(excess > 0 and rerr > 10 * rtol,
          f"{name}: {fault} gives row err {rerr:.3e}, elementwise excess "
          f"{excess:.3e}: the checks cannot see it")


def _time_flash(flash_kernel, F, q, k, v, shape, dtype, kw, name, variant,
                plain):
    """Times K1 through the kernel module (no launch counted): both
    variants in turns (general, hopper, hopper, general) where ``plan``
    takes the Hopper one, with SDPA in the same turns for the cases of
    ``SDPA_IN_TURNS`` (general, hopper, sdpa, sdpa, hopper, general),
    whose turns are queued behind a sleep of the stream (``time_ms``) and
    whose hopper and SDPA calls are timed back to back once more;
    where v is narrower than q and k (MLA), the
    Hopper one in turns with the general one and SDPA on v zero-padded to
    hd, the model's call before the Hopper variant took v as it is, and
    with SDPA on v as it is where SDPA takes it (hopper, general, sdpa,
    sdpa-dv, sdpa-dv, sdpa, general, hopper); else the general one in
    turns with SDPA (general, sdpa, sdpa, general); where it takes the
    Hopper one at a head dim with a training mode
    (``kernel.LSE_HEAD_DIMS``), its serving instantiation against its
    training mode (the LSE written; without, with, with, without);
    SDPA on the same inputs (in those turns for the general variant;
    ``sdpa_mask``'s band where a window bites); and the plain version.  Prints
    them beside the bound (and, where v is narrower, the padded
    function's) and returns the kernels-line numbers (``ms`` is that of
    ``variant``, the one the dispatcher takes; ``library_ms`` SDPA's on
    the same inputs, on padded v only where SDPA refuses them)."""
    _, _, _, _, hd, dv = flash_dims(shape)
    narrow = dv < hd
    vp = F.pad(v, (0, hd - dv)) if narrow else v
    qt, kt, vt_, vpt = (t.transpose(1, 2) for t in (q, k, v, vp))
    mask = sdpa_mask(q, k.shape[1], kw)
    sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt, **mask)
    sdpa_dv = narrow
    if narrow:
        try:
            with torch.inference_mode():
                sdpa(vt_)
            torch.cuda.synchronize()
        except RuntimeError as e:
            sdpa_dv = False
            print(f"[kernels] flash_attention {name}: SDPA refuses v at {dv} "
                  f"columns beside q and k at {hd}: {e}")
    if narrow:
        order = (("hopper", "general", "sdpa")
                 + ("sdpa-dv", "sdpa-dv") * sdpa_dv
                 + ("sdpa", "general", "hopper"))
    elif name in SDPA_IN_TURNS:
        order = ("general", variant, "sdpa", "sdpa", variant, "general")
    elif variant == "hopper":
        order = ("general", "hopper", "hopper", "general")
    else:
        order = ("general", "sdpa", "sdpa", "general")
    in_turns, lse_turns = [], []
    queued = name in SDPA_IN_TURNS
    with torch.inference_mode():
        for vt in order:
            if vt == "sdpa":
                fn = functools.partial(sdpa, vpt)
            elif vt == "sdpa-dv":
                fn = functools.partial(sdpa, vt_)
            else:      # the general variant takes the padded v, if any
                fn = functools.partial(flash_kernel.flash_attention_cuda, q,
                                       k, v if vt == "hopper" else vp, vt,
                                       **kw)
            in_turns.append((vt, time_ms(fn, queued=queued)))
        turns = [(u, t) for u, t in in_turns if not u.startswith("sdpa")]
        sdpa_turns = {u: [t for w, t in in_turns if w == u]
                      for u in ("sdpa", "sdpa-dv")}
        if variant == "hopper" and q.shape[3] in flash_kernel.LSE_HEAD_DIMS:
            lse = flash_kernel.lse_buffer(q)
            for with_lse in (False, True, True, False):
                lse_turns.append((with_lse, time_ms(
                    lambda: flash_kernel.flash_attention_cuda(
                        q, k, v, "hopper", lse=lse if with_lse else None,
                        **kw), queued=queued)))
            del lse
        if sdpa_turns["sdpa"]:
            library_ms = float(np.mean(sdpa_turns["sdpa-dv"]
                                       or sdpa_turns["sdpa"]))
        elif "attn_mask" in mask:
            library_ms = time_ms(lambda: sdpa(vt_), iters=3)
        else:
            library_ms = time_ms(lambda: sdpa(vt_))
        plain_ms = time_ms(plain, iters=3)
        # the same calls back to back: the host's launch work included
        back_to_back = {u: time_ms(fn) for u, fn in (
            ("hopper", functools.partial(flash_kernel.flash_attention_cuda,
                                         q, k, v, "hopper", **kw)),
            ("sdpa", functools.partial(sdpa, vpt)))} if queued else None
    del vp, vpt, mask, sdpa
    ms_by_variant = {u: float(np.mean([t for w, t in turns if w == u]))
                     for u in dict(turns)}
    ms = ms_by_variant[variant]
    bound_ms, bound_by = flash_bound(shape, dtype, kw["causal"],
                                     kw["window"])
    ratio = ("" if len(ms_by_variant) == 1 else
             f", general / hopper "
             f"{ms_by_variant['general'] / ms_by_variant['hopper']:.2f}")
    lse_ms = {("with_lse" if u else "without_lse"):
              float(np.mean([t for w, t in lse_turns if w == u]))
              for u in (False, True)} if lse_turns else None
    if lse_ms:
        print(f"[kernels] flash_attention {name}: hopper without / with the "
              f"LSE in turns {', '.join(f'{t:.4f}' for _, t in lse_turns)} "
              f"ms; with / without "
              f"{lse_ms['with_lse'] / lse_ms['without_lse']:.3f}")
    extra = {}
    padded = ""
    if narrow:
        # the function on v zero-padded to hd, as the model computed it
        # before: the general variant's and SDPA's yardstick
        extra["padded_bound_ms"] = flash_bound(shape[:5], dtype,
                                               kw["causal"],
                                               kw["window"])[0]
        extra["sdpa_padded_ms"] = float(np.mean(sdpa_turns["sdpa"]))
        if sdpa_turns["sdpa-dv"]:
            extra["sdpa_dv_ms"] = library_ms
        padded = (f"; on v padded to {hd}: sdpa "
                  f"{extra['sdpa_padded_ms']:.4f} ms, bound "
                  f"{extra['padded_bound_ms']:.4f} ms; hopper / padded "
                  f"sdpa {ms / extra['sdpa_padded_ms']:.2f}")
    if back_to_back:
        extra["back_to_back_ms"] = back_to_back
        b2b = ", ".join(f"{u} {t:.4f}" for u, t in back_to_back.items())
        print(f"[kernels] flash_attention {name}: turns queued behind a "
              f"sleep of the stream (kernels alone); back to back, the "
              f"host's launch work included: {b2b} ms")
    print(f"[kernels] flash_attention {name}: in turns "
          f"{', '.join(f'{u} {t:.4f}' for u, t in in_turns)} ms; "
          f"{', '.join(f'{u} {t:.4f} ms' for u, t in ms_by_variant.items())}"
          f", plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); {variant} / sdpa "
          f"{ms / library_ms:.2f}, {variant} / bound {ms / bound_ms:.2f}"
          f"{ratio}{padded}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "ms_by_variant": ms_by_variant, "ms_turns": turns,
            **({"sdpa_ms_turns": sdpa_turns["sdpa"]}
               if sdpa_turns["sdpa"] else {}),
            **({"sdpa_dv_ms_turns": sdpa_turns["sdpa-dv"]}
               if sdpa_turns["sdpa-dv"] else {}),
            **({"hopper_ms_by_lse": lse_ms} if lse_ms else {}), **extra}


# WKV6 (K2): inputs and limits from repro_torch.kernels.rwkv6.checks.
# name, (b, s, H, hd), dtype, strided, scale of the initial state
WKV_CASES = [
    ("main-path", (4, 1024, 32, 64), torch.bfloat16, False, 0.0),
    ("s1", (2, 1, 32, 64), torch.float32, False, 10.0),
    ("s37-hd16-strided", (2, 37, 4, 16), torch.float32, True, 10.0),
    ("s37-hd16", (3, 37, 4, 16), torch.bfloat16, False, 10.0),
    ("s1000-strided", (2, 1000, 8, 64), torch.bfloat16, True, 10.0),
    ("s1024-f32", (1, 1024, 8, 64), torch.float32, False, 10.0),
    ("s100-hd24", (2, 100, 4, 24), torch.float32, False, 10.0),
    ("s33", (2, 33, 32, 64), torch.bfloat16, False, 10.0),
    ("s1024-f32-main-width", (4, 1024, 32, 64), torch.float32, False, 10.0),
    # a mesh rank's local heads: 16 of rwkv6-1.6b's 32, the 2 rows of a
    # `data` rank (phase mesh_ssm), in the published bf16 (path k-bf16)
    # and in f32 (paths k and m); timed (_time_local)
    ("mesh-local-heads", (2, 1024, 16, 64), torch.bfloat16, False, 0.0),
    ("mesh-local-heads-f32", (2, 1024, 16, 64), torch.float32, False, 0.0),
]


def wkv_bound(shape, dtype):
    """Least time for the function: bytes (r, k, v in ``dtype``, w f32
    and the state read once; y and the state written once) over HBM
    bandwidth, or its f32 operations over the f32 peak, whichever is
    larger.  Operations per (b, h, step): 4 hd^2 + 5 hd.  With the state
    kept scaled by the running product of the decays (rescaled once per
    chunk, a cost that vanishes with the chunk's length), S += k^T v is
    one FMA per entry and y = (r*D).S one more: 2 hd^2 each; the u term
    and the decay products are O(hd)."""
    b, s, h, hd = shape
    size = torch.finfo(dtype).bits // 8
    n = b * s * h * hd
    nbytes = 4 * n * size + 4 * n + h * hd * size + 2 * b * h * hd * hd * 4
    flops = b * h * s * (4 * hd * hd + 5 * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def wkv_floor(shape):
    """The kernel design's own floor: 3 f32 FMA-pipe instructions per
    state entry and step (k v, the state's FMA, y's FMA), against the
    bound's 2, at the FMA pipe's peak instruction rate."""
    b, s, h, hd = shape
    return 3 * b * h * s * hd * hd / PEAK_FMA_INSTR_PER_S * 1e3


def _plan_name(groups, cols, col_blocks, pipelined=True):
    return (f"G{groups}-C{cols}-CB{col_blocks}"
            + ("" if pipelined else "-nopipe"))


def _close(out, ref, tol, row_tol, what):
    """Elementwise and row checks; returns (max_abs_err, worst row)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    rerr = row_err(out, ref)
    check(math.isfinite(err), f"{what}: non-finite")
    scale = ref.pow(2).mean().sqrt().item()
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol * scale)
    check(rerr <= row_tol, f"{what}: worst row rel err {rerr:.3e} > "
                           f"{row_tol:g}")
    return err, rerr


def phase_wkv6():
    """K2, each case: kernel vs plain version, y and the final state, and
    the (G, C, CB) that kernel.plan chose.  Returns the kernels-line entry
    (numbers at the main-path case)."""
    from repro_torch.kernels.rwkv6 import checks
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    entry = None
    for name, shape, dtype, strided, state_scale in WKV_CASES:
        args = checks.inputs(shape, dtype, gen, strided, state_scale)
        before = dict(wkv_ops.launches_by_plan)
        with torch.inference_mode():
            y, S = wkv_ops.wkv6(*args)
            torch.cuda.synchronize()
            y_ref, S_ref = wkv6_ref(*args)
        took = [pl for pl, n in wkv_ops.launches_by_plan.items()
                if n != before.get(pl, 0)]
        plan = wkv_kernel.plan(shape, dtype)
        check(took == [plan], f"wkv6 {name}: took {took}, expected "
                              f"[{plan}]")
        check(y.dtype == dtype and S.dtype == torch.float32,
              f"wkv6 {name}: dtypes {y.dtype}, {S.dtype}")
        tol, rtol = checks.TOL[dtype], checks.ROW_TOL[dtype]
        err, rerr = _close(y, y_ref, tol, rtol, f"wkv6 {name} y")
        s_err, s_rerr = _close(S, S_ref, checks.STATE_TOL,
                               checks.STATE_ROW_TOL,
                               f"wkv6 {name} state")
        print(f"[kernels] wkv6 {name} {tuple(shape)} {str(dtype)[6:]} "
              f"strided={strided} state x{state_scale:g}, plan (G, C, CB) "
              f"{plan}: y max_abs_err "
              f"{err:.3e} (limit {tol:g} x (rms + |ref|), rms "
              f"{y_ref.float().pow(2).mean().sqrt().item():.3g}), worst row "
              f"{rerr:.3e} (tol {rtol:g}); state max_abs_err {s_err:.3e}, "
              f"worst row {s_rerr:.3e} (tol {checks.STATE_ROW_TOL:g})")
        if name.startswith("mesh-local-heads"):
            entry[name.replace("-", "_")] = _time_local(
                "wkv6", name, shape, lambda: wkv_ops.wkv6(*args),
                lambda: wkv6_ref(*args), wkv_bound(shape, dtype))
        if name != "main-path":
            del args, y, S, y_ref, S_ref
            continue
        _wkv_checks_can_fail(wkv6_ref, args, y_ref, S_ref, rtol,
                             checks.STATE_ROW_TOL,
                             wkv_kernel.chunk_steps(shape[3], dtype, plan))
        entry = {
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:49",
            "launches": None, "max_abs_err": err,
            **_time_wkv(wkv_kernel, wkv_ops, wkv6_ref, args, shape, dtype,
                        plan),
        }
        del args, y, S, y_ref, S_ref
    torch.cuda.empty_cache()
    return entry


def _time_local(kernel, name, shape, fn, plain, bound):
    """A kernel at a mesh rank's local shape through its dispatcher:
    device time queued behind a sleep of the stream (its kernel alone),
    twice, and back to back (the host's launch work included), and the
    plain version's, beside the bound (``bound``: a bound function's
    value).  Printed and returned for the kernels line."""
    bound_ms, bound_by = bound[:2]
    with torch.inference_mode():
        queued = [time_ms(fn, iters=20, queued=True) for _ in range(2)]
        back = time_ms(fn, iters=20)
        plain_ms = time_ms(plain, iters=2, warmup=1)
    print(f"[kernels] {kernel} {name} {tuple(shape)}: queued "
          f"{', '.join(f'{t:.4f}' for t in queued)} ms "
          f"({min(queued) / bound_ms:.2f} x bound), back to back "
          f"{back:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), no library call")
    return {"shape": list(shape), "ms": queued, "ms_back_to_back": back,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _wkv_checks_can_fail(wkv6_ref, args, y_ref, S_ref, rtol, s_rtol, chunk):
    """The plain version with three faults, each of which must land far
    outside the limits: the update at t = s/2 dropped (k = 0, w = 1 there:
    the state skips the step, as a kernel that lost it would); a stale
    chunk (the steps of chunk 2 replaced by those of chunk 1, what a
    missed cp.async wait reads); a lost row group (r's rows [16, 32) of
    every head zeroed, what a row group's partial dropped from the sum
    of y loses; which quarter of the rows a group holds depends on the
    layout, how far y moves does not)."""
    r, k, v, w, u, state = args
    half = r.shape[1] // 2
    c1, c2 = slice(chunk, 2 * chunk), slice(2 * chunk, 3 * chunk)
    with torch.inference_mode():
        k_drop, w_drop = k.clone(), w.clone()
        k_drop[:, half] = 0
        w_drop[:, half] = 1
        y_f, S_f = wkv6_ref(r, k_drop, v, w_drop, u, state)
        lost, s_lost = row_err(y_f, y_ref), row_err(S_f, S_ref)
        del k_drop, w_drop
        stale_in = [t.clone() for t in (r, k, v, w)]
        for t in stale_in:
            t[:, c2] = t[:, c1]
        y_f, S_f = wkv6_ref(*stale_in, u, state)
        stale, s_stale = row_err(y_f, y_ref), row_err(S_f, S_ref)
        del stale_in
        r_lost = r.clone()
        r_lost[..., 16:32] = 0
        y_f, _ = wkv6_ref(r_lost, k, v, w, u, state)
        group = row_err(y_f, y_ref)
        del r_lost, y_f, S_f
    print(f"[kernels] wkv6 main-path: the update at t = {half} dropped "
          f"gives worst row rel err {lost:.3e} in y (limit {rtol:g}) and "
          f"{s_lost:.3e} in the state (limit {s_rtol:g}); a stale chunk "
          f"(steps [{c2.start}, {c2.stop}) read as [{c1.start}, "
          f"{c1.stop})) {stale:.3e} in y and {s_stale:.3e} in the state; a "
          f"lost row group (r rows [16, 32) zeroed) {group:.3e} in y")
    check(lost > 10 * rtol and s_lost > 10 * s_rtol,
          f"a dropped update gives only {lost:.3e} / {s_lost:.3e}: the "
          f"check cannot see it")
    check(stale > 10 * rtol or s_stale > 10 * s_rtol,
          f"a stale chunk gives only {stale:.3e} / {s_stale:.3e}: the "
          f"check cannot see it")
    check(group > 10 * rtol, f"a lost row group gives only {group:.3e}: "
                             f"the check cannot see it")


def _time_wkv(wkv_kernel, wkv_ops, wkv6_ref, args, shape, dtype, plan):
    """Times the dispatcher (``ms``: what the main path calls, u's cast
    included), every candidate (G, C, CB, overlapped
    copies) through the sweep library (no launch counted) in two passes,
    the second in reverse order (``ms_by_plan``), and the plain version;
    prints them beside the bound and the design's floor and returns the
    kernels-line numbers."""
    r, k, v, w, u, state = args
    uf = u.float()
    turns = {}
    order = list(wkv_kernel.CANDIDATES)
    with torch.inference_mode():
        ms = time_ms(lambda: wkv_ops.wkv6(*args))
        for cand in order + order[::-1]:
            turns.setdefault(_plan_name(*cand), []).append(time_ms(
                lambda: wkv_kernel.wkv6_cuda(r, k, v, w, uf, state,
                                             cand[:3], cand[3], sweep=True),
                iters=20))
        plain_ms = time_ms(lambda: wkv6_ref(*args), iters=2, warmup=1)
    ms_by_plan = {name: float(np.mean(ts)) for name, ts in turns.items()}
    bound_ms, bound_by = wkv_bound(shape, dtype)
    floor_ms = wkv_floor(shape)
    chosen = _plan_name(*plan)
    check(chosen in ms_by_plan, f"wkv6: plan {chosen} is not a candidate")
    fastest = min(ms_by_plan, key=ms_by_plan.get)
    for name, ts in turns.items():
        print(f"[kernels] wkv6 main-path {name}: "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms, mean "
              f"{ms_by_plan[name]:.4f} ms = {ms_by_plan[name] / bound_ms:.2f}"
              f" x bound, {ms_by_plan[name] / floor_ms:.2f} x floor")
    yard = ms_by_plan[_plan_name(1, 1, 1, False)]
    print(f"[kernels] wkv6 main-path: through the dispatcher {ms:.4f} ms "
          f"({ms / bound_ms:.2f} x bound), plan {chosen} "
          f"{ms_by_plan[chosen]:.4f} ms in the sweep, fastest {fastest} "
          f"{ms_by_plan[fastest]:.4f} ms, G1-C1-CB1-nopipe (one thread per "
          f"column) {yard:.4f} ms ({yard / ms_by_plan[chosen]:.2f} x the "
          f"plan), plain {plain_ms:.4f} ms, no library call, bound "
          f"{bound_ms:.4f} ms ({bound_by}), design floor {floor_ms:.4f} ms "
          f"(3 f32 instructions per entry)")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "plan": list(plan), "ms_by_plan": ms_by_plan,
            "fastest": fastest}


# K2's backward: inputs, limits and faults from
# repro_torch.kernels.rwkv6.checks.  name, (b, s, H, hd), dtype, strided
# (r/k/v, w and dy views of wider storages), scale of S_0, scale of dS_T
# (0: none), fast decay (w from about 1 down to 0); the first is the
# training shape (rwkv6-1.6b, batch 4 x 2048)
WKV_BWD_CASES = [
    ("training", (4, 2048, 32, 64), torch.bfloat16, False, 0.0, 0.0, False),
    ("training-f32", (4, 2048, 32, 64), torch.float32, False, 0.0, 0.0,
     False),
    ("strided", (2, 1024, 32, 64), torch.bfloat16, True, 0.0, 0.0, False),
    ("states", (2, 1024, 16, 64), torch.float32, False, 10.0, 1.0, False),
    ("s1000", (2, 1000, 32, 64), torch.bfloat16, False, 10.0, 1.0, False),
    ("s2047-strided-f32", (1, 2047, 8, 64), torch.float32, True, 10.0, 1.0,
     False),
    ("small-w", (2, 1024, 16, 64), torch.float32, False, 10.0, 1.0, True),
    ("small-w-bf16", (2, 1024, 16, 64), torch.bfloat16, False, 10.0, 1.0,
     True),
    ("hd16-s37-strided", (2, 37, 4, 16), torch.float32, True, 10.0, 1.0,
     False),
    ("hd24-s100", (2, 100, 4, 24), torch.float32, False, 10.0, 1.0, False),
]
# the route kernel_bwd.plan gives each case: "hopper" at hd 64 (strided
# views of fused storages included: their strides are multiples of 16
# bytes), "general" below it
WKV_BWD_ROUTES = {name: "hopper" if shape[3] == 64 else "general"
                  for name, shape, *_ in WKV_BWD_CASES}
# the faults (checks.BWD_FAULTS) each case shows its checks can see: f32
# cases, whose limits are 2e-5 for every gradient; the u term of dk is
# small beside G v where w ~ 1, so it is shown where w forgets fast
WKV_BWD_FAULTS = {"training-f32": ("no-g-decay", "dw-late", "du-one-row"),
                  "small-w": ("no-u-in-dk",)}


def wkv_bwd_bound(shape, dtype):
    """Least time for K2's backward: bytes (r, k, v, dy in ``dtype``, w
    f32, u and the two states read once; dr, dk, dv in ``dtype``, dw f32,
    du and dS_0 written once) over HBM bandwidth, or its f32 operations
    over the f32 peak, whichever is larger.  Operations per (b, h, step):
    10 hd^2 + 16 hd -- the S and G recurrences at one FMA an entry each
    (the states kept scaled by running decay products, as ``wkv_bound``),
    the dr, dk and dv contractions at one FMA an entry each; dw from the
    pair-sum identity d(log w_t) = sum_{t'>t} r_t' dr^S_t' - sum_{tau>=t}
    k_tau dk^G_tau + rowsum(dS_T S_T), with v.dy, the u terms, a_t and du,
    O(hd)."""
    b, s, h, hd = shape
    size = torch.finfo(dtype).bits // 8
    n = b * s * h * hd
    nbytes = (7 * n * size + 2 * 4 * n + 2 * h * hd * 4
              + 3 * b * h * hd * hd * 4)
    flops = b * h * s * (10 * hd * hd + 16 * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _wkv_grads(wkv_ops, args, dy, dstate):
    """(dr, dk, dv, dw, du, dS_0) through ops.wkv6 and autograd, as the
    training path takes them: the forward kernel, then the backward's
    kernels through ``_WKV6``.  Each input keeps its strides; u is f32,
    so du comes back in f32."""
    leaves = [t.detach().requires_grad_() for t in args]
    y, s_out = wkv_ops.wkv6(*leaves)
    outs, grads = ((y, s_out), (dy, dstate)) if dstate is not None \
        else ((y,), (dy,))
    return torch.autograd.grad(outs, leaves, grads)


def _tile_name(tile):
    return "R{}-C{}-SUB{}".format(*tile)


def phase_wkv6_bwd():
    """K2's backward, each case: its route (kernel_bwd.plan) held to
    WKV_BWD_ROUTES; the gradients of the training path's entry against
    wkv6_bwd_ref, row by row against each row's scale
    (checks.bwd_row_scales), finite, two calls bit for bit, one forward
    launch and the backward's kernels counted on the case's route; faults
    that must land past the limits; at the training shape the forward's
    training mode checked and both routes, every Hopper tile, the forward
    and the plain backward timed.  Returns the kernels-line entry."""
    from repro_torch.kernels.rwkv6 import checks, kernel_bwd
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    entry = None
    per_call = len(kernel_bwd.KERNELS)
    for (name, shape, dtype, strided, state_scale, dstate_scale,
         fast) in WKV_BWD_CASES:
        r, k, v, w, u, state, dy, dstate = checks.bwd_inputs(
            shape, dtype, gen, strided, state_scale, dstate_scale, fast)
        args = (r, k, v, w, u.float(), state)
        route = kernel_bwd.plan(r, k, v, w)
        check(route == WKV_BWD_ROUTES[name],
              f"wkv6_bwd {name}: route {route}, expected "
              f"{WKV_BWD_ROUTES[name]}")
        before = (wkv_ops.launches, wkv_ops.launches_bwd,
                  dict(wkv_ops.launches_bwd_by_route))
        got = _wkv_grads(wkv_ops, args, dy, dstate)
        again = _wkv_grads(wkv_ops, args, dy, dstate)
        torch.cuda.synchronize()
        took = (wkv_ops.launches - before[0],
                wkv_ops.launches_bwd - before[1])
        by_route = {rt: n - before[2][rt]
                    for rt, n in wkv_ops.launches_bwd_by_route.items()}
        check(took == (2, 2 * per_call)
              and by_route[route] == 2 * per_call,
              f"wkv6_bwd {name}: launches (forward, backward) {took}, by "
              f"route {by_route}, expected (2, {2 * per_call}) on {route}")
        with torch.no_grad():
            ref = wkv6_bwd_ref(*args, dy, dstate)
            scales = checks.bwd_row_scales(*args, dy, dstate)
        errs = checks.bwd_errors(got, ref, scales)
        max_abs = max((a.float() - b).abs().max().item()
                      for a, b in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(torch.isfinite(g).all().item() for g in got)
        zeros = int((w == 0).sum().item())
        limits = checks.BWD_ROW_TOL[dtype]
        print(f"[wkv6_bwd] {name} {tuple(shape)} {str(dtype)[6:]} "
              f"strided={strided} S_0 x{state_scale:g} dS_T "
              f"x{dstate_scale:g} fast_decay={fast} (w == 0 at {zeros}) "
              f"route {route}: worst row rel err " + ", ".join(
                  f"{g} {e:.3e} (limit {limits[g]:g})"
                  for g, e in errs.items())
              + f"; max_abs_err {max_abs:.3e}; finite {finite}; two calls "
              f"{'bit-identical' if same else 'DIFFER'}")
        check(finite, f"wkv6_bwd {name}: a gradient is not finite")
        check(checks.bwd_within(errs, dtype),
              f"wkv6_bwd {name}: worst rows {errs} past {limits}")
        check(same, f"wkv6_bwd {name}: two calls differ")
        for fault in WKV_BWD_FAULTS.get(name, ()):
            with torch.no_grad():
                bad = checks.wkv6_bwd_faulty(*args, dy, dstate, fault)
            worst = checks.bwd_errors(bad, ref, scales)
            hit = {g: e for g, e in worst.items() if e > 10 * limits[g]}
            del bad
            print(f"[wkv6_bwd] {name}: a backward with {fault} gives worst "
                  f"rows {', '.join(f'{g} {e:.3e}' for g, e in hit.items())}"
                  f" (past 10 x their limits)")
            check(hit, f"wkv6_bwd {name}: {fault} gives only {worst}: the "
                       f"check cannot see it")
        del got, again
        if name == "training":
            entry = {
                "name": "wkv6_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu",
                "replaces": "src/repro/kernels/rwkv6/kernel.py:49",
                "gradient_of": "src/repro/kernels/rwkv6/ops.py:27",
                "launches": None, "calls": None, "launches_by_route": None,
                "kernels_per_call": {kn: 1 for kn in kernel_bwd.KERNELS},
                "max_abs_err": max_abs,
                **_time_wkv_bwd(args, dy, ref, scales, shape, dtype)}
        del ref, scales
        del r, k, v, w, u, state, dy, dstate, args
        torch.cuda.empty_cache()
    check(entry is not None, "wkv6_bwd: the training case did not run")
    return entry


def _training_mode_checks(args, shape, dtype):
    """K2's forward in training mode against serving mode, bit for bit (y
    and the final state), and its checkpoints (put back in place) against
    ref.wkv6_checkpoints within the forward's state limits.  Returns the
    checkpoints at kernel_bwd.PLAN's steps."""
    from repro_torch.kernels.rwkv6 import checks, kernel_bwd
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_checkpoints
    r, k, v, w, uf, state = args
    steps = kernel_bwd.PLAN[2]
    plan = wkv_kernel.plan(shape, dtype)
    ck = torch.empty(kernel_bwd.checkpoint_shape(shape, steps),
                     dtype=torch.float32, device="cuda")
    with torch.no_grad():
        y0, s0 = wkv_kernel.wkv6_cuda(r, k, v, w, uf, state, plan)
        y1, s1 = wkv_kernel.wkv6_cuda(r, k, v, w, uf, state, plan,
                                      checkpoints=ck, ck_steps=steps)
        torch.cuda.synchronize()
        same = torch.equal(y0, y1) and torch.equal(s0, s1)
        want = wkv6_checkpoints(k, v, w, state, steps)
        err, rerr = _close(kernel_bwd.checkpoint_states(ck), want,
                           checks.STATE_TOL, checks.STATE_ROW_TOL,
                           "wkv6 training-mode checkpoints")
    print(f"[wkv6_bwd] training mode of K2's forward at {tuple(shape)} "
          f"{str(dtype)[6:]}: y and S_T {'bit-identical' if same else 'DIFFER'}"
          f" to serving mode; {ck.shape[2]} checkpoints every {steps} steps "
          f"({ck.numel() * 4 / 1e6:.1f} MB) against the plain states: "
          f"elementwise {err:.3e} (limit {checks.STATE_TOL:g}), row "
          f"{rerr:.3e} (limit {checks.STATE_ROW_TOL:g})")
    check(same, "wkv6 training mode: y or the final state differ from "
                "serving mode")
    del y0, s0, y1, s1, want
    return ck


def _time_wkv_bwd(args, dy, ref, scales, shape, dtype):
    """At the training shape: the training-mode checks; the general
    route's gradients held to the limits; then in turns (general, hopper,
    hopper, general) the backward call on each route (both kernels and
    du's batch sum, the Hopper one from the forward's checkpoints), each
    route's kernels alone, the forward without and with checkpoints, every
    Hopper tile of the sweep library (held to the limits, its checkpoints
    from its own forward), the plain backward; printed beside the bound."""
    from repro_torch.kernels.rwkv6 import checks, kernel_bwd
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref
    r, k, v, w, uf, state = args
    limits = checks.BWD_ROW_TOL[dtype]
    ck = _training_mode_checks(args, shape, dtype)
    steps = kernel_bwd.PLAN[2]
    plan = wkv_kernel.plan(shape, dtype)

    def call(route, kernels=kernel_bwd.KERNELS, tile=None, ckp=None,
             sweep=False):
        return kernel_bwd.wkv6_bwd_cuda(
            r, k, v, w, uf, state, dy, kernels=kernels, route=route,
            checkpoints=(ck if ckp is None else ckp) if route == "hopper"
            else None, tile=tile, sweep=sweep)

    with torch.no_grad():
        errs = checks.bwd_errors(call("general"), ref, scales)
        check(checks.bwd_within(errs, dtype),
              f"wkv6_bwd training on general: worst rows {errs}")
        turns = {"general": [], "hopper": []}
        for route in ("general", "hopper", "hopper", "general"):
            turns[route].append(time_ms(lambda: call(route)))
        kernel_ms = {rt: {kn: time_ms(lambda: call(rt, (kn,)))
                          for kn in kernel_bwd.KERNELS}
                     for rt in kernel_bwd.ROUTES}
        ck_tmp = torch.empty_like(ck)
        fwd = {"serving": [], "training": []}
        for mode in ("serving", "training", "training", "serving"):
            kw = {} if mode == "serving" else dict(checkpoints=ck_tmp,
                                                   ck_steps=steps)
            fwd[mode].append(time_ms(lambda: wkv_kernel.wkv6_cuda(
                r, k, v, w, uf, state, plan, **kw)))
        del ck_tmp
        by_tile = {}
        for tile in kernel_bwd.SWEEP_TILES:
            ck_t = kernel_bwd.forward_checkpoints(r, k, v, w, uf, state,
                                                  tile[2])
            got = call("hopper", tile=tile, ckp=ck_t, sweep=True)
            errs_t = checks.bwd_errors(got, ref, scales)
            del got
            ok = all(errs_t[g] <= limits[g] for g in ("dr", "dk", "dw",
                                                      "du"))
            check(ok, f"wkv6_bwd tile {tile}: worst rows {errs_t}")
            bwd_ms = time_ms(lambda: call("hopper", ("bwd",), tile, ck_t,
                                          True))
            fck_ms = time_ms(lambda: wkv_kernel.wkv6_cuda(
                r, k, v, w, uf, state, plan, checkpoints=ck_t,
                ck_steps=tile[2]))
            by_tile[_tile_name(tile)] = {"bwd_ms": bwd_ms,
                                         "forward_ms": fck_ms}
            del ck_t
            torch.cuda.empty_cache()
        plain_ms = time_ms(lambda: wkv6_bwd_ref(r, k, v, w, uf, state, dy),
                           iters=1, warmup=1)
    bound_ms, bound_by = wkv_bwd_bound(shape, dtype)
    ms = float(np.mean(turns["hopper"]))
    print(f"[wkv6_bwd] training {tuple(shape)} {str(dtype)[6:]}, in turns: "
          f"backward call on hopper "
          f"{', '.join(f'{t:.4f}' for t in turns['hopper'])}"
          f" ms ({ms / bound_ms:.2f} x bound), on general "
          f"{', '.join(f'{t:.4f}' for t in turns['general'])} ms; alone "
          + "; ".join(f"{rt}: " + ", ".join(f"{n} {t:.4f}"
                                            for n, t in kms.items())
                      for rt, kms in kernel_ms.items())
          + f" ms; forward serving "
          f"{', '.join(f'{t:.4f}' for t in fwd['serving'])}"
          f", training (checkpoints every {steps} steps) "
          f"{', '.join(f'{t:.4f}' for t in fwd['training'])} ms; plain "
          f"backward {plain_ms:.1f} ms, no library call, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    for name, t in by_tile.items():
        print(f"[wkv6_bwd] hopper tile {name}: bwd alone {t['bwd_ms']:.4f} "
              f"ms, forward with its checkpoints {t['forward_ms']:.4f} ms"
              + (" (the plan)" if name == _tile_name(kernel_bwd.PLAN)
                 else ""))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "ms_by_route": turns, "kernel_ms": kernel_ms,
            "forward_ms": fwd, "plan": list(kernel_bwd.PLAN),
            "ms_by_tile": by_tile}


# Selective scan (K3): inputs and limits from
# repro_torch.kernels.mamba_scan.checks.
# name, (b, s, di, N), dtype, scale of the initial state, options of
# checks.inputs
SCAN_CASES = [
    ("main-path", (4, 1024, 16384, 16), torch.bfloat16, 0.0, {}),
    ("f32", (2, 1024, 2048, 16), torch.float32, 10.0, {}),
    ("s33-di1000", (2, 33, 1000, 16), torch.bfloat16, 10.0, {}),
    ("s2", (2, 2, 16384, 16), torch.float32, 10.0, {}),
    ("n8", (2, 100, 512, 8), torch.float32, 10.0, {}),
    ("n4-di200", (3, 37, 200, 4), torch.bfloat16, 10.0, {}),
    ("state-f32", (1, 64, 16384, 16), torch.float32, 10.0, {}),
    # s = 31 chunks of 32 steps and 8: a ragged last chunk in the double
    # buffer at the main width
    ("s1000-ragged", (4, 1000, 16384, 16), torch.bfloat16, 10.0, {}),
    # dt ~ softplus(2 N(0, 1) + 6): dt A log2 e < -150 on many entries, so
    # both exponentials must give 0 there
    ("large-dt", (2, 256, 4096, 16), torch.bfloat16, 10.0,
     dict(dt_bias=6.0, dt_scale=2.0)),
    # every row of A a random order of -(1..N), each entry times U(1, 2)
    ("shuffled-A", (2, 512, 4096, 16), torch.float32, 10.0,
     dict(A_kind="shuffled")),
    # A = -exp(N(0, 1.5^2)): decays that remember thousands of steps, held
    # to an f64 scan (checks.py)
    ("long-memory", (2, 512, 4096, 16), torch.float32, 10.0,
     dict(A_kind="long-memory")),
    # x's rows 1998 bytes apart: bf16 staged by plain 2-byte copies
    ("odd-di-bf16", (2, 65, 999, 16), torch.bfloat16, 10.0, {}),
    # a mesh rank's local channels on path l: 8192 of Jamba's 16384, the 2
    # rows of a `data` rank (phase mesh_ssm); timed (_time_local)
    ("mesh-local-channels", (2, 1024, 8192, 16), torch.bfloat16, 0.0, {}),
]


def scan_bound(shape, dtype, ex2_per_s):
    """Least time for the function, the largest of three: bytes (x, B, C
    in ``dtype``, dt f32, A, D and the state read once; y and the state
    written once) over HBM bandwidth; its exponentials, one per state
    entry and step, over the SFUs' exp2 rate ``ex2_per_s``; its f32
    operations, 6 per state entry and step (dt*A, dx*B, the state's FMA,
    the y FMA) and 3 per channel and step (dt*x, D*x + y), over the f32
    peak."""
    b, s, di, n = shape
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * s * di * size + 4 * b * s * di + 2 * b * s * n * size
              + 4 * (di * n + di) + 2 * 4 * b * di * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_exp = b * s * di * n / ex2_per_s
    t_flops = b * s * di * (6 * n + 3) / PEAK_FLOPS[torch.float32]
    t_ops = max(t_exp, t_flops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "exp": b * s * di * n,
             "flops": b * s * di * (6 * n + 3), "t_bytes_ms": t_bytes * 1e3,
             "t_exp_ms": t_exp * 1e3, "t_flops_ms": t_flops * 1e3})


def scan_floor(shape, ex2_per_s, mufu_slots):
    """The floor of the kernel's design: its dispatch slots or its
    exponentials on the SFUs, whichever take longer.  Per state entry and
    step it dispatches 4 FMA-pipe instructions (dt*A, dx*B, the state's
    FMA, y's FMA) and one MUFU.EX2, which takes ``mufu_slots`` dispatch
    slots (what phase_ex2_rate measures); per channel and step 3 more
    (dt*x, acc0 + acc1, D*x + y).  While the slots take longer, moving
    exponentials to an FMA-pipe polynomial (a range reduction and a
    polynomial: more instructions than a MUFU's slots) can only add
    time, so this is that split's floor too."""
    b, s, di, n = shape
    n_exp = b * s * di * n
    t_sfu = n_exp / ex2_per_s
    t_dispatch = (b * s * di * (4 * n + 3) + mufu_slots * n_exp) \
        / PEAK_FMA_INSTR_PER_S
    return max(t_sfu, t_dispatch) * 1e3


def phase_ex2_rate():
    """The SFUs' ex2.approx rate on this card (the sweep library's probe,
    kernel.ex2_rate): per SM per clock from the SMs' cycle counters,
    beside the programming guide's 16; then beside 8 FFMAs an ex2, which
    gives the dispatch slots a MUFU.EX2 takes.  Returns the ex2 rate K3's
    bound takes (the larger of the guide's and the measured one, at 132
    SMs and the 1.98 GHz boost clock) and the slots."""
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    rates = {}
    for fmas, lds in scan_kernel.PROBES:
        r = scan_kernel.ex2_rate(fmas=fmas, lds=lds)
        check(r["finite"], f"ex2 probe ({fmas}, {lds}): non-finite results")
        check(r["distinct_sms"] == r["sms"],
              f"ex2 probe ({fmas}, {lds}): {r['sms']} blocks ran on "
              f"{r['distinct_sms']} SMs")
        rates[fmas] = r
    alone, mixed = rates[0], rates[8]["per_sm_per_clock"]
    per_clock = max(GUIDE_EX2_PER_CLOCK, alone["per_sm_per_clock"])
    # a scheduler holds 8 warps of the probe; with 8 FFMAs beside each ex2
    # it spends 128 / rate clocks a warp ex2, 8 of them on the FFMAs (one
    # a clock) and the rest on the MUFU's dispatch
    mufu_slots = 128 / mixed - 8
    print(f"[kernels] ex2 rate: {alone['per_sm_per_clock']:.3f} ex2.approx "
          f"a clock per SM (the SMs' mean; the programming guide's "
          f"{GUIDE_EX2_PER_CLOCK}), {alone['per_s'] / 1e12:.3f} T/s on "
          f"{alone['sms']} SMs at {alone['clock_ghz']:.3f} GHz "
          f"({alone['ms']:.3f} ms); K3's bound takes {per_clock:.3f} x "
          f"{SMS} SMs x {BOOST_HZ / 1e9:g} GHz.  Beside 8 FFMAs an ex2: "
          f"{mixed:.3f} a clock, so a warp's MUFU.EX2 holds its scheduler "
          f"{mufu_slots:.2f} clocks (1 if the pipes overlapped fully)")
    return per_clock * SMS * BOOST_HZ, mufu_slots


def phase_scan(ex2_per_s, mufu_slots):
    """K3, each case: kernel vs plain version, y and the final state; at
    the main-path case every design of the sweep library too, then the
    timings.  Returns the kernels-line entry (numbers at the main-path
    case)."""
    from repro_torch.kernels.mamba_scan import checks
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    entry = None
    for name, shape, dtype, state_scale, opts in SCAN_CASES:
        args = checks.inputs(shape, dtype, gen, state_scale, **opts)
        with torch.inference_mode():
            y, h = scan_ops.selective_scan(*args)
            torch.cuda.synchronize()
            y_ref, h_ref = selective_scan_ref(*args)
        check(y.dtype == dtype and h.dtype == torch.float32,
              f"selective_scan {name}: dtypes {y.dtype}, {h.dtype}")
        tol, rtol = checks.TOL[dtype], checks.ROW_TOL[dtype]
        if opts.get("A_kind") == "long-memory":
            _scan_long_memory(checks, args, (y, h), (y_ref, h_ref), name)
            del args, y, h, y_ref, h_ref
            continue
        err, rerr = _close(y, y_ref, tol, rtol, f"selective_scan {name} y")
        h_err, h_rerr = _close(h, h_ref, checks.STATE_TOL,
                               checks.STATE_ROW_TOL,
                               f"selective_scan {name} state")
        x, dt, A = args[:3]
        extra = ""
        if name == "large-dt":
            arg = dt[..., None] * (A * math.log2(math.e))
            deep = (arg < -150).float().mean().item()
            extra = (f", dt A log2 e < -150 on {100 * deep:.1f}% of the "
                     f"entries")
            check(deep > 0.01, f"large-dt: only {deep:.4f} of the entries "
                               f"below -150")
            del arg
        print(f"[kernels] selective_scan {name} {tuple(shape)} "
              f"{str(dtype)[6:]} state x{state_scale:g}, copy widths x "
              f"{scan_kernel.copy_width(x)} B, dt "
              f"{scan_kernel.copy_width(dt)} B{extra}: y max_abs_err "
              f"{err:.3e} (limit {tol:g} x (rms + |ref|), rms "
              f"{y_ref.float().pow(2).mean().sqrt().item():.3g}), worst row "
              f"{rerr:.3e} (tol {rtol:g}); state max_abs_err {h_err:.3e}, "
              f"worst row {h_rerr:.3e} (tol {checks.STATE_ROW_TOL:g})")
        if name == "mesh-local-channels":
            entry["mesh_local_channels"] = _time_local(
                "selective_scan", name, shape,
                lambda: scan_ops.selective_scan(*args),
                lambda: selective_scan_ref(*args),
                scan_bound(shape, dtype, ex2_per_s))
        if name != "main-path":
            del args, x, dt, A, y, h, y_ref, h_ref
            continue
        _scan_candidates_close(scan_kernel, args, y_ref, h_ref, tol, rtol,
                               checks)
        # The checks can fail here: the plain version with the update at
        # t = s/2 dropped (dt = 0 there: the state skips the step, as a
        # kernel that lost it would) must be far outside the y row limit.
        # The final state has forgotten the step by t = s (checks.py).
        B, C, D, state = args[3:]
        half = shape[1] // 2
        with torch.inference_mode():
            dt_drop = dt.clone()
            dt_drop[:, half] = 0
            y_drop, h_drop = selective_scan_ref(x, dt_drop, A, B, C, D, state)
            lost, h_lost = row_err(y_drop, y_ref), row_err(h_drop, h_ref)
            del dt_drop, y_drop, h_drop
        print(f"[kernels] selective_scan main-path: the update at t = "
              f"{half} dropped gives worst row rel err {lost:.3e} in y "
              f"(limit {rtol:g}) and {h_lost:.3e} in the final state")
        check(lost > 10 * rtol, f"a dropped update gives only {lost:.3e}: "
                                f"the check cannot see it")
        entry = {
            "name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                      "selective_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/kernel.py:51",
            "launches": None, "max_abs_err": err,
            **_time_scan(scan_kernel, scan_ops, selective_scan_ref, args,
                         shape, dtype, ex2_per_s, mufu_slots),
        }
        del args, x, dt, A, B, C, D, state, y, h, y_ref, h_ref
    torch.cuda.empty_cache()
    return entry


def _scan_long_memory(checks, args, out, ref, name):
    """Long memory: the kernel's y and final state no further from an f64
    scan, row by row, than ``checks.LONG_MEMORY_RATIO`` times the plain
    version's (checks.py says why the f32 limits do not apply)."""
    with torch.inference_mode():
        exact = checks.f64_scan(*args)
    ratio = checks.LONG_MEMORY_RATIO
    parts = []
    for what, got, plain, want in zip(("y", "state"), out, ref, exact):
        k_err, p_err = row_err(got, want), row_err(plain, want)
        parts.append(f"{what}: kernel {k_err:.3e}, plain {p_err:.3e} from "
                     f"f64, {row_err(got, plain):.3e} apart")
        check(math.isfinite(k_err) and k_err <= ratio * p_err,
              f"selective_scan {name} {what}: {k_err:.3e} from the f64 scan, "
              f"more than {ratio:g} x the plain version's {p_err:.3e}")
    print(f"[kernels] selective_scan {name} {tuple(args[0].shape)} + N = "
          f"{args[2].shape[1]} {str(args[0].dtype)[6:]}, A = -exp(N(0, "
          f"1.5^2)), worst rows {'; '.join(parts)} (limit: kernel <= "
          f"{ratio:g} x plain)")


def _scan_candidates_close(scan_kernel, args, y_ref, h_ref, tol, rtol,
                           checks):
    """Every design of the sweep library within the limits at the
    main-path case, before any of them is timed."""
    worst = []
    for cand in scan_kernel.CANDIDATES:
        with torch.inference_mode():
            y, h = scan_kernel.selective_scan_cuda(*args, design=cand,
                                                   sweep=True)
            torch.cuda.synchronize()
        _, rerr = _close(y, y_ref, tol, rtol, f"selective_scan {cand} y")
        _, h_rerr = _close(h, h_ref, checks.STATE_TOL, checks.STATE_ROW_TOL,
                           f"selective_scan {cand} state")
        worst.append(f"{cand} {rerr:.2e}/{h_rerr:.2e}")
        del y, h
    print(f"[kernels] selective_scan main-path, every design of the sweep "
          f"library, worst y row / state row: {', '.join(worst)}")


def _time_scan(scan_kernel, scan_ops, selective_scan_ref, args, shape,
               dtype, ex2_per_s, mufu_slots):
    """Times the dispatcher (``ms``: what the main path calls), every
    design of the sweep library (no launch counted) in two passes, the
    second in reverse order (``ms_by_design``), and the plain version;
    prints them beside the bound and the floor and returns the
    kernels-line numbers."""
    turns = {}
    order = list(scan_kernel.CANDIDATES)
    with torch.inference_mode():
        ms = time_ms(lambda: scan_ops.selective_scan(*args), iters=20)
        for cand in order + order[::-1]:
            turns.setdefault(cand, []).append(
                time_ms(lambda: scan_kernel.selective_scan_cuda(
                    *args, design=cand, sweep=True), iters=20))
        plain_ms = time_ms(lambda: selective_scan_ref(*args), iters=2,
                           warmup=1)
    ms_by_design = {name: float(np.mean(ts)) for name, ts in turns.items()}
    bound_ms, bound_by, count = scan_bound(shape, dtype, ex2_per_s)
    floor_ms = scan_floor(shape, ex2_per_s, mufu_slots)
    for name, ts in turns.items():
        print(f"[kernels] selective_scan main-path {name}: "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms, mean "
              f"{ms_by_design[name]:.4f} ms = "
              f"{ms_by_design[name] / bound_ms:.2f} x bound, "
              f"{ms_by_design[name] / floor_ms:.2f} x floor")
    yard = ms_by_design["first"]
    print(f"[kernels] selective_scan main-path: through the dispatcher "
          f"{ms:.4f} ms ({ms / bound_ms:.2f} x bound, {ms / floor_ms:.2f} x "
          f"floor), the first design {yard:.4f} ms ({yard / ms:.2f} x), "
          f"plain {plain_ms:.4f} ms, no library call; bound "
          f"{bound_ms:.4f} ms ({bound_by}; {json.dumps(count)}); floor "
          f"{floor_ms:.4f} ms (4 FMA-pipe instructions and a MUFU.EX2 of "
          f"{mufu_slots:.2f} dispatch slots an entry)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "ms_by_design": ms_by_design}


# K3's backward: inputs, limits and faults from
# repro_torch.kernels.mamba_scan.checks (B and C are column slices of one
# (b, s, dt_rank + 2N) projection, as apply_mamba hands them over).
# name, (b, s, di, N), dtype, scale of the initial state, scale of dh_T
# (0: none), options of checks.inputs; the first two are the training
# shape (jamba-1.5-large-398b, batch 4 x 2048)
SCAN_BWD_CASES = [
    ("training", (4, 2048, 16384, 16), torch.bfloat16, 0.0, 0.0, {}),
    ("training-f32", (4, 2048, 16384, 16), torch.float32, 0.0, 0.0, {}),
    ("states-s1000", (2, 1000, 4096, 16), torch.float32, 10.0, 1.0, {}),
    ("s2047-bf16", (1, 2047, 4096, 16), torch.bfloat16, 10.0, 1.0, {}),
    ("n8", (2, 1000, 2048, 8), torch.float32, 10.0, 1.0, {}),
    ("n4-di200", (3, 37, 200, 4), torch.bfloat16, 10.0, 1.0, {}),
    # dt A log2 e < -150 on many entries: both exponentials give 0 there
    ("large-dt", (2, 256, 4096, 16), torch.bfloat16, 10.0, 1.0,
     dict(dt_bias=6.0, dt_scale=2.0)),
    ("shuffled-A", (2, 512, 4096, 16), torch.float32, 10.0, 1.0,
     dict(A_kind="shuffled")),
    # decays that remember thousands of steps, held to an f64 backward
    ("long-memory", (2, 512, 4096, 16), torch.float32, 10.0, 1.0,
     dict(A_kind="long-memory")),
]
# the faults (checks.BWD_FAULTS) a case shows its checks can see: an f32
# case, whose limits are 2e-5 for every gradient
SCAN_BWD_FAULTS = {"states-s1000": ("dB-one-block", "dA-late", "no-D-in-dx",
                                    "no-decay")}


def scan_bwd_bound(shape, dtype, ex2_per_s):
    """Least time for K3's backward, the largest of three: bytes (x, dy,
    B, C in ``dtype``, dt f32, A, D and the two states read once; dx, dB,
    dC in ``dtype``, ddt f32, dA, dD and dh_0 written once) over HBM
    bandwidth; its exponentials, one per state entry and step, over the
    SFUs' exp2 rate ``ex2_per_s``; its f32 operations, 10 per state entry
    and step (the decay's argument, g, dB's and dC's terms, g.B, the
    decay term of ddt and dA, the next g) and 6 per channel and step,
    over the f32 peak.  Also the time of the bytes with the design's
    scratch (its checkpoints and dB/dC partials, each written and read
    once)."""
    from repro_torch.kernels.mamba_scan import kernel_bwd
    b, s, di, n = shape
    size = torch.finfo(dtype).bits // 8
    nbytes = (b * s * di * (3 * size + 8) + 4 * b * s * n * size
              + 2 * 4 * (di * n + di) + 3 * 4 * b * di * n)
    scratch = 2 * 4 * (math.prod(kernel_bwd.checkpoint_shape(shape))
                       + math.prod(kernel_bwd.partials_shape(shape)))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_exp = b * s * di * n / ex2_per_s
    t_flops = b * s * di * (10 * n + 6) / PEAK_FLOPS[torch.float32]
    t_ops = max(t_exp, t_flops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "exp": b * s * di * n,
             "flops": b * s * di * (10 * n + 6),
             "t_bytes_ms": t_bytes * 1e3, "t_exp_ms": t_exp * 1e3,
             "t_flops_ms": t_flops * 1e3, "scratch_bytes": scratch,
             "t_bytes_with_scratch_ms":
                 (nbytes + scratch) / HBM_BYTES_PER_S * 1e3})


def _scan_grads(scan_ops, args, dy, dstate):
    """(dx, ddt, dA, dB, dC, dD, dh_0) through ops.selective_scan and
    autograd, as the training path takes them: the forward kernel, then
    the backward's kernels through ``_SelectiveScan``.  Each input keeps
    its strides (B and C stay views of the projection)."""
    leaves = [t.detach().requires_grad_() for t in args]
    y, h = scan_ops.selective_scan(*leaves)
    outs, grads = ((y, h), (dy, dstate)) if dstate is not None \
        else ((y,), (dy,))
    return torch.autograd.grad(outs, leaves, grads)


def phase_scan_bwd(ex2_per_s):
    """K3's backward, each case: the gradients of the training path's
    entry against selective_scan_bwd_ref, row by row against each row's
    scale (checks.bwd_row_scales), or for long memory against an f64
    backward; finite, two calls bit for bit, one forward launch (in
    training mode) and the backward's kernels counted; faults that must
    land past the limits; at the training shape the training mode's
    checks, PR 24's form held to the same limits, and the call (in turns
    with PR 24's form), each kernel alone, the forward with and without
    checkpoints and the plain backward timed.  Returns the kernels-line
    entry."""
    from repro_torch.kernels.mamba_scan import checks, kernel_bwd
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    entry = None
    per_call = len(kernel_bwd.KERNELS)
    for name, shape, dtype, state_scale, dstate_scale, opts in \
            SCAN_BWD_CASES:
        *args, dy, dstate = checks.bwd_inputs(shape, dtype, gen, state_scale,
                                              dstate_scale, **opts)
        before = (scan_ops.launches, scan_ops.launches_bwd,
                  scan_ops.launches_by_mode["training"])
        got = _scan_grads(scan_ops, args, dy, dstate)
        again = _scan_grads(scan_ops, args, dy, dstate)
        torch.cuda.synchronize()
        took = (scan_ops.launches - before[0],
                scan_ops.launches_bwd - before[1],
                scan_ops.launches_by_mode["training"] - before[2])
        check(took == (2, 2 * per_call, 2),
              f"scan_bwd {name}: launches (forward, backward, forward in "
              f"training mode) {took}, expected (2, {2 * per_call}, 2)")
        with torch.no_grad():
            ref = selective_scan_bwd_ref(*args, dy, dstate)
            scales = checks.bwd_row_scales(*args, dy, dstate)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(torch.isfinite(g).all().item() for g in got)
        dtypes = [g.dtype for g in got]
        check(dtypes == [dtype, torch.float32, torch.float32, dtype, dtype,
                         torch.float32, torch.float32],
              f"scan_bwd {name}: gradient dtypes {dtypes}")
        max_abs = max((a.float() - b).abs().max().item()
                      for a, b in zip(got, ref))
        head = (f"[scan_bwd] {name} {tuple(shape)} {str(dtype)[6:]} state "
                f"x{state_scale:g} dh_T x{dstate_scale:g}"
                + (f" {opts}" if opts else ""))
        if opts.get("A_kind") == "long-memory":
            with torch.no_grad():
                exact = checks.f64_bwd(*args, dy, dstate)
            held = checks.bwd_long_memory(got, ref, exact, scales, dtype)
            del exact
            print(f"{head}: worst rows from an f64 backward, kernel / plain: "
                  + ", ".join(f"{g} {k:.3e} / {p:.3e}"
                              for g, (k, p, _) in held.items())
                  + f" (limit: kernel <= {checks.LONG_MEMORY_RATIO:g} x "
                  f"plain; {', '.join(checks.STATELESS)} within its f32 "
                  f"limit of plain); finite {finite}; two calls "
                  f"{'bit-identical' if same else 'DIFFER'}")
            check(all(ok for _, _, ok in held.values()),
                  f"scan_bwd {name}: {held}")
        else:
            errs = checks.bwd_errors(got, ref, scales)
            limits = checks.BWD_ROW_TOL[dtype]
            print(f"{head}: worst row rel err " + ", ".join(
                f"{g} {e:.3e} (limit {limits[g]:g})" for g, e in errs.items())
                + f"; max_abs_err {max_abs:.3e}; finite {finite}; two calls "
                f"{'bit-identical' if same else 'DIFFER'}")
            check(checks.bwd_within(errs, dtype),
                  f"scan_bwd {name}: worst rows {errs} past {limits}")
        if name == "large-dt":
            arg = args[1][..., None] * (args[2] * math.log2(math.e))
            deep = (arg < -150).float().mean().item()
            del arg
            print(f"[scan_bwd] large-dt: dt A log2 e < -150 on "
                  f"{100 * deep:.1f}% of the entries")
            check(deep > 0.01, f"scan_bwd large-dt: only {deep:.4f} below "
                               f"-150")
        check(finite, f"scan_bwd {name}: a gradient is not finite")
        check(same, f"scan_bwd {name}: two calls differ")
        for fault in SCAN_BWD_FAULTS.get(name, ()):
            with torch.no_grad():
                bad = checks.selective_scan_bwd_faulty(*args, dy, dstate,
                                                       fault)
            worst = checks.bwd_errors(bad, ref, scales)
            limits = checks.BWD_ROW_TOL[dtype]
            hit = {g: e for g, e in worst.items() if e > 10 * limits[g]}
            del bad
            print(f"[scan_bwd] {name}: a backward with {fault} gives worst "
                  f"rows {', '.join(f'{g} {e:.3e}' for g, e in hit.items())}"
                  f" (past 10 x their limits)")
            check(hit, f"scan_bwd {name}: {fault} gives only {worst}: the "
                       f"check cannot see it")
        del got, again
        if name == "training":
            entry = {
                "name": "selective_scan_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                          "selective_scan_bwd.cu",
                "replaces": "src/repro/kernels/mamba_scan/kernel.py:51",
                "gradient_of": "src/repro/kernels/mamba_scan/ops.py:13",
                "launches": 0, "launches_by_path": {}, "calls": 0,
                "kernels_per_call": {kn: 1 for kn in kernel_bwd.KERNELS},
                "design": kernel_bwd.DESIGN, "max_abs_err": max_abs,
                **_scan_training_mode_checks(args, shape, dtype),
                **_time_scan_bwd(args, dy, ref, scales, shape, dtype,
                                 ex2_per_s)}
        del ref, scales, args, dy, dstate
        torch.cuda.empty_cache()
    check(entry is not None, "scan_bwd: the training case did not run")
    return entry


def _scan_training_mode_checks(args, shape, dtype):
    """K3's forward in training mode against serving mode, bit for bit (y
    and the final state); its checkpoints against those of PR 24's "ckpt"
    kernel (the sweep library), bit for bit, and against
    ref.selective_scan_checkpoints within the forward's elementwise state
    limit; each row's distance from the f64 states, the checkpoints' and
    the plain states', printed beside."""
    from repro_torch.kernels.mamba_scan import checks, kernel_bwd
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan.ref import selective_scan_checkpoints
    x, dt, A, B, C, D, state = args
    n = shape[3]
    with torch.no_grad():
        y0, h0 = scan_kernel.selective_scan_cuda(*args)
        ck = torch.empty(kernel_bwd.checkpoint_shape(shape),
                         dtype=torch.float32, device="cuda")
        y1, h1 = scan_kernel.selective_scan_cuda(*args, checkpoints=ck)
        first = torch.full_like(ck, float("nan"))
        kernel_bwd.selective_scan_bwd_cuda(
            *args, torch.zeros_like(x), kernels=("ckpt",), checkpoints=first,
            design="first", sweep=True)
        torch.cuda.synchronize()
        same = torch.equal(y0, y1) and torch.equal(h0, h1)
        same_ck = torch.equal(ck, first)
        want = selective_scan_checkpoints(x, dt, A, B, state,
                                          kernel_bwd.CK_STEPS)
        got = ck[..., :n]
        err = (got - want).abs().max().item()
        scale = want.pow(2).mean().sqrt().item()
        within = bool(((got - want).abs()
                       <= checks.STATE_TOL * (scale + want.abs())).all())
        exact = selective_scan_checkpoints(x, dt, A, B, state,
                                           kernel_bwd.CK_STEPS,
                                           compute=torch.float64)
        k_rerr, p_rerr = (((t.double() - exact).norm(dim=-1)
                           / exact.norm(dim=-1).clamp_min(1e-30)).max().item()
                          for t in (got, want))
        del exact
    print(f"[scan_bwd] training mode of K3's forward at {tuple(shape)} "
          f"{str(dtype)[6:]}: y and h_T "
          f"{'bit-identical' if same else 'DIFFER'} to serving mode; "
          f"{ck.shape[1]} checkpoints every {kernel_bwd.CK_STEPS} steps "
          f"({ck.numel() * 4 / 1e6:.1f} MB) "
          f"{'bit-identical' if same_ck else 'DIFFER'} to PR 24's ckpt "
          f"kernel's; against the plain states: elementwise {err:.3e} "
          f"(limit {checks.STATE_TOL:g} of rms + |state|: {within}); worst "
          f"row from the f64 states, kernel / plain: {k_rerr:.3e} / "
          f"{p_rerr:.3e}")
    check(same, "scan training mode: y or the final state differ from "
                "serving mode")
    check(same_ck, "scan training mode: checkpoints differ from PR 24's "
                   "ckpt kernel's")
    check(within, f"scan training mode: checkpoints {err:.3e} from the "
                  f"plain states")
    del y0, h0, y1, h1, ck, first, want, got
    return {"training_mode": {"bit_identical_to_serving": same,
                              "checkpoints_as_first": same_ck,
                              "checkpoint_err": err,
                              "checkpoint_row_err_f64": [k_rerr, p_rerr]}}


def _time_scan_bwd(args, dy, ref, scales, shape, dtype, ex2_per_s):
    """At the training shape: PR 24's form (the sweep library's "first":
    ckpt, bwd, sum) held to the limits and compared with the design; then
    in turns (first, pipe, pipe, first) the backward call of each (the
    design's from the forward's checkpoints; dA's and dD's batch sums
    included), each kernel of each alone, the forward without and with
    checkpoints, then the plain backward; printed beside the bound."""
    from repro_torch.kernels.mamba_scan import checks, kernel_bwd
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref
    x, dt, A, B, C, D, state = args
    ck = kernel_bwd.forward_checkpoints(*args)

    def call(design, kernels=None):
        if design == "first":
            return kernel_bwd.selective_scan_bwd_cuda(
                *args, dy, kernels=kernels, design="first", sweep=True)
        return kernel_bwd.selective_scan_bwd_cuda(*args, dy, kernels=kernels,
                                                  checkpoints=ck)

    with torch.no_grad():
        got, first = call("pipe"), call("first")
        errs = checks.bwd_errors(first, ref, scales)
        check(checks.bwd_within(errs, dtype),
              f"scan_bwd training on PR 24's form: worst rows {errs}")
        apart = checks.bwd_errors(got, first, scales)
        same = [g for g, a, b in zip(checks.GRADS, got, first)
                if torch.equal(a, b)]
        check(checks.bwd_within(apart, dtype),
              f"scan_bwd training: the design from PR 24's form {apart}")
        del got, first
        turns = {"first": [], "pipe": []}
        for design in ("first", "pipe", "pipe", "first"):
            turns[design].append(time_ms(lambda: call(design)))
        kernel_ms = {d: {kn: time_ms(lambda: call(d, (kn,)))
                         for kn in kernel_bwd.DESIGNS[d]}
                     for d in ("pipe", "first")}
        ck_tmp = torch.empty_like(ck)
        fwd = {"serving": [], "training": []}
        for mode in ("serving", "training", "training", "serving"):
            kw = {} if mode == "serving" else dict(checkpoints=ck_tmp)
            fwd[mode].append(time_ms(
                lambda: scan_kernel.selective_scan_cuda(*args, **kw)))
        del ck_tmp
        plain_ms = time_ms(lambda: selective_scan_bwd_ref(*args, dy),
                           iters=1, warmup=1)
    bound_ms, bound_by, count = scan_bwd_bound(shape, dtype, ex2_per_s)
    ms = float(np.mean(turns["pipe"]))
    print(f"[scan_bwd] training {tuple(shape)} {str(dtype)[6:]}: PR 24's "
          f"form within the limits ({', '.join(f'{g} {e:.3e}' for g, e in errs.items())}); "
          f"the design from it: worst rows "
          f"{', '.join(f'{g} {e:.3e}' for g, e in apart.items())}, "
          f"bit-identical {same}")
    print(f"[scan_bwd] training {tuple(shape)} {str(dtype)[6:]}, in turns: "
          f"backward call pipe "
          f"{', '.join(f'{t:.4f}' for t in turns['pipe'])} ms "
          f"({ms / bound_ms:.2f} x bound), PR 24's form (first) "
          f"{', '.join(f'{t:.4f}' for t in turns['first'])} ms; alone "
          + "; ".join(f"{d}: " + ", ".join(f"{n} {t:.4f}"
                                           for n, t in kms.items())
                      for d, kms in kernel_ms.items())
          + f" ms; forward serving "
          f"{', '.join(f'{t:.4f}' for t in fwd['serving'])}, training "
          f"(checkpoints every {kernel_bwd.CK_STEPS} steps) "
          f"{', '.join(f'{t:.4f}' for t in fwd['training'])} ms; plain "
          f"backward {plain_ms:.1f} ms, no library call; bound "
          f"{bound_ms:.4f} ms ({bound_by}; {json.dumps(count)})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "ms_by_design": turns,
            "kernel_ms": kernel_ms, "forward_ms": fwd,
            "bit_identical_to_first": same}


class StepProbe:
    """Wraps a model: counts non-finite logits of every step and times
    each step on the host clock, up to the card finishing it."""

    def __init__(self, model):
        self.model = model
        self.reset()

    def reset(self):
        self.nonfinite = 0
        self.seconds = {"prefill": [], "decode": []}

    def _timed(self, kind, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.nonfinite += int((~torch.isfinite(out[0])).sum())   # syncs
        self.seconds[kind].append(time.perf_counter() - t0)
        return out

    def prefill(self, params, tokens, max_len):
        return self._timed("prefill", self.model.prefill, params, tokens,
                           max_len)

    def decode(self, params, cache, tokens, length):
        return self._timed("decode", self.model.decode, params, cache,
                           tokens, length)


def phase_main_path(arch, card, profile):
    """Serves ``arch``'s smoke traffic (``TRAFFIC``); returns each
    kernel's launches in that run (counts set to 0 just before it, read
    just after)."""
    from repro_torch.configs import get_config
    from repro_torch.core import (BatchSystem, Invoker, Ledger,
                                  ResourceManager)
    from repro_torch.models.factory import build_model
    from repro_torch.serving import ModelServer, ServeEngine

    ops = kernel_ops()
    n_req, batch, new_tokens = 8, 4, 16
    (lo, hi), max_len = TRAFFIC.get(arch, SHORT_TRAFFIC)
    published = get_config(arch)
    cfg = published.replace(**PATH_CUTS.get(arch, {}))
    if cfg != published:
        print(f"[main] {arch} cut in depth, every width as published: "
              f"{PATH_CUTS[arch]} ({published.n_layers} layers, "
              f"{published.param_counts()['total'] / 1e9:.2f} B params "
              f"published; {cfg.param_counts()['total'] / 1e9:.2f} B in "
              f"the cut)")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in _leaves(params))
    params_gb = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) / 1e9
    print(f"[main] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B params ({params_gb:.2f} GB) in "
          f"{str(model.dtype)[6:]} initialised in {init_s:.1f} s, init "
          f"peak {init_peak_gb:.2f} GB")
    probe = StepProbe(model)
    server = ModelServer(probe, params, max_len=max_len)
    ledger = Ledger()
    rm = ResourceManager(n_replicas=2)
    cluster = BatchSystem(rm, ledger, n_nodes=2, workers_per_node=2,
                          hot_period=10.0)
    cluster.release_idle()
    rm.start_heartbeats()
    invoker = Invoker("serve", rm, server.make_library(), seed=SEED)
    try:
        check(invoker.allocate(1) == 1, "no worker leased")
        # warm-up wave (cuBLAS handles, first launches) off the record
        warm = ServeEngine(invoker, batch_size=1)
        warm.enqueue(np.arange(1, 33), max_new_tokens=2)
        warm.run()

        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(1, cfg.vocab_size,
                                size=int(rng.integers(lo, hi + 1)))
                   for _ in range(n_req)]
        window = getattr(model, "static_window", 0)
        if cfg.local_global_period:     # gemma3's local layers
            window = cfg.local_window
        if window:
            check(min(map(len, prompts)) > window,
                  f"a prompt within the {window}-token window")
        engine = ServeEngine(invoker, batch_size=batch)
        for p in prompts:
            engine.enqueue(p, max_new_tokens=new_tokens)
        probe.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in ops.values():
            mod.launches = 0
        flash_variants = ops["flash_attention"].launches_by_variant
        for variant in flash_variants:
            flash_variants[variant] = 0
        ops["wkv6"].launches_by_plan.clear()
        done = engine.run()
        launches = {name: mod.launches for name, mod in ops.items()}
        launches["flash_attention_by_variant"] = dict(flash_variants)
        launches["wkv6_by_plan"] = {_plan_name(*pl): n for pl, n in
                                    ops["wkv6"].launches_by_plan.items()}
        m = engine.metrics()
    finally:
        invoker.deallocate()
        rm.stop()
    waves = -(-n_req // batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache_gb = sum(t.numel() * t.element_size() for t in _leaves(
        model.init_cache(batch, max_len, "meta"))) / 1e9
    prefill_ms = [t * 1e3 for t in probe.seconds["prefill"]]
    decode_ms = float(np.median(probe.seconds["decode"])) * 1e3
    print(f"[main] prompts {[len(p) for p in prompts]}"
          f"{f', window {window}' if window else ''}, max_len "
          f"{max_len}, {waves} waves; "
          f"kernel launches {launches}; "
          f"{len(probe.seconds['decode'])} decode steps; "
          f"{probe.nonfinite} non-finite logits")
    # a decode step reads every weight at least once, but an untied input
    # embedding table (one row a token)
    emb = params["embed"]
    step_gb = params_gb - ("lm_head" in emb) * emb["tokens"].numel() * \
        emb["tokens"].element_size() / 1e9
    print(f"[main] step times on the host clock: prefill per wave "
          f"{[round(t, 1) for t in prefill_ms]} ms, decode step median "
          f"{decode_ms:.1f} ms (reading the {step_gb:.2f} GB of weights "
          f"a step reads takes at least {step_gb / HBM_BYTES_PER_S * 1e12:.1f}"
          f" ms at {HBM_BYTES_PER_S / 1e12:g} TB/s); peak memory "
          f"{peak_gb:.2f} GB")
    check(len(done) == n_req, f"{len(done)} of {n_req} requests served")
    check(all(len(r.tokens_out) == new_tokens for r in done),
          "a request got the wrong number of tokens")
    check(probe.nonfinite == 0, f"{probe.nonfinite} non-finite logits")
    want = {name: MAIN_PATHS[arch].get(name, 0) * waves for name in ops}
    # every K1 launch of a main path takes the Hopper variant, but where
    # K1_VARIANT says otherwise
    k1_variant = K1_VARIANT.get(arch, ("hopper", "hopper"))[0]
    want["flash_attention_by_variant"] = {
        "hopper": 0, "general": 0, k1_variant: want["flash_attention"]}
    if want["flash_attention"]:
        print(f"[main] {arch}: K1 launches by variant "
              f"{launches['flash_attention_by_variant']} (expected all "
              f"{k1_variant!r})")
    # every K2 launch takes kernel.plan's (G, C, CB) for the model's head dim
    want["wkv6_by_plan"] = {}
    if want["wkv6"]:
        from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
        hd = cfg.rwkv.head_dim
        wkv_plan = wkv_kernel.plan((batch, 1, cfg.d_model // hd, hd),
                                   model.dtype)
        want["wkv6_by_plan"] = {_plan_name(*wkv_plan): want["wkv6"]}
    check(launches == want, f"kernel launches {launches}, expected {want}")
    max_latency = max(r.latency for r in done)
    result = {
        "arch": arch, "prompt_lengths": [len(p) for p in prompts],
        "max_len": max_len, "requests": m["requests"], "tokens": m["tokens"],
        "throughput_tok_s": m["throughput_tok_s"],
        "p50_ttft_s": m["p50_ttft_s"], "p50_latency_s": m["p50_latency_s"],
        "p99_latency_s": m["p99_latency_s"], "max_latency_s": max_latency,
        "peak_memory_gb": peak_gb, "init_peak_memory_gb": init_peak_gb,
        "init_s": init_s, "params_gb": params_gb,
        "prefill_ms": prefill_ms, "decode_step_ms_median": decode_ms,
        "cache_gb": cache_gb, "bill_invocations":
            ledger.bill("serve").invocations, "card": card,
    }
    # 8 requests in 2 waves: a smoke of the path, not a serving
    # measurement; of 8 latencies the maximum is reported, not a p99.
    print(f"[main] smoke of {n_req} requests in {waves} waves: "
          f"{m['tokens']} tokens, {m['throughput_tok_s']:.2f} tok/s, "
          f"p50 TTFT {m['p50_ttft_s'] * 1e3:.1f} ms, p50 latency "
          f"{m['p50_latency_s'] * 1e3:.1f} ms, max latency "
          f"{max_latency * 1e3:.1f} ms, peak memory {peak_gb:.2f} GB "
          f"serving, {init_peak_gb:.2f} GB at init, cache {cache_gb:.3f} "
          f"GB | {card}")
    print("main_path " + json.dumps(result))
    if profile:
        profile_steps(model, params, max_len, seq=hi)
    return launches


def free_device_memory(what):
    """Frees what the previous phase left: the serving stack holds the
    model's params in reference cycles (server, library, invoker), which
    only the cycle collector breaks.  Fails if more than 1 GB is still
    allocated, so the next model's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"[memory] after {what}: {left / 1e9:.3f} GB still allocated")
    check(left < 1e9, f"{left / 1e9:.2f} GB still allocated after {what}")


def profile_steps(model, params, max_len, seq, batch=4, steps=3,
                  prefill_kw=None):
    """Where a step's time goes: one prefill wave (batch x seq; the
    model's other prefill inputs, Whisper's frames, in ``prefill_kw``)
    and ``steps`` decode steps, each timed on the host clock without the
    profiler, then run again under torch.profiler for the device time of
    its kernels (the kernels alone, not the host-side ops that launched
    them).  Prints, per step, the wall time, the kernel time and launches,
    the device-busy share (kernel time over wall time), the time by
    kernel group (``KERNEL_GROUPS``), the kernels that take the most, and
    the repository's own kernels (``PORT_KERNELS``) where they are not
    among those."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    toks = torch.randint(1, model.cfg.vocab_size, (batch, seq),
                         generator=gen, device="cuda")
    prefill_kw = prefill_kw or {}
    with torch.inference_mode():
        _, cache, length = model.prefill(params, toks, max_len,
                                         **prefill_kw)   # warm
        nxt = toks[:, -1:]
        model.decode(params, cache, nxt, length)

        def run_decode():
            for i in range(steps):
                model.decode(params, cache, nxt, length + 1 + i)

        runs = {"prefill": (1, seq, lambda: model.prefill(
                    params, toks, max_len, **prefill_kw)),
                "decode": (steps, 1, run_decode)}
        for kind, (n, tokens, run) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            if not kernels:
                print(f"[profile] {kind}: wall {wall_ms:.1f} ms per step; "
                      f"device time not measured (no CUDA events)")
                continue
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
            n_launch = sum(e.count for e in kernels) // n
            print(f"[profile] {kind} ({batch} x {tokens} tokens): wall "
                  f"{wall_ms:.1f} ms per step, kernels {busy_ms:.1f} ms in "
                  f"{n_launch} launches, device busy "
                  f"{100 * busy_ms / wall_ms:.0f}%")
            print(f"[profile]   by group: {group_line(kernels, n)}")
            ranked = sorted(kernels, key=lambda e: e.self_device_time_total,
                            reverse=True)
            for e in ranked[:8] + [e for e in ranked[8:] if any(
                    name in e.key for name in PORT_KERNELS)]:
                print(f"[profile]   {e.self_device_time_total / 1e3 / n:8.2f}"
                      f" ms {e.count // n:5d}x  {e.key[:90]}")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def full_logits(model, params, toks, patch_embeds=None):
    """Logits at every token position from one forward over the whole
    sequence: cache-free for the dense and Jamba models (Jamba's Mamba
    layers from a zero state, through K3), with ``patch_embeds`` in front
    of the tokens; for RWKV the same layers prefill runs (the kernel for
    the whole sequence), every position kept."""
    from repro_torch.models import common as C
    from repro_torch.models import layers as L
    from repro_torch.models.rwkv_lm import RWKVLM
    cfg = model.cfg
    if isinstance(model, RWKVLM):
        x = model._embed(params, toks)
        x = model._run_layers(x, params, model.init_cache(
            toks.shape[0], 0, toks.device))
    else:
        x = model._embed_inputs(params, toks, patch_embeds)
        pos = torch.arange(x.shape[1], device=toks.device)[None, :]
        x = model._run_layers(x, params, pos, None, None, "train")[0]
        x = x[:, x.shape[1] - toks.shape[1]:]
    return C.lm_logits(L.apply_norm(x, params["final_norm"], cfg),
                       params["embed"], cfg)


def phase_decode_vs_prefill(arch, prompt=6, steps=5, patches=0, ring=False):
    """Teacher-forced decode reproduces the logits of one forward over the
    whole sequence: a ``prompt``-token prefill (after ``patches`` random
    patch embeddings), then ``steps`` decode steps, with a cache of
    prompt + steps + 5 slots; with ``ring``, again through the ring
    buffer (``window_cache``) of the window's slots, held to the forward
    and to the full cache's logits.  f32 at 1e-3: both paths are f32
    (TF32 off) but reduce over the model's widths in different orders (a
    CUDA kernel against plain torch: attention, or the recurrence's step
    path).  Whisper does not take this check: its decode embeds each new
    token at sinusoidal position 0, as the reference's does, where its
    prefill embeds position i at i, so the two cannot agree;
    ``phase_whisper_card_vs_cpu`` holds its decode to the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build_model

    cfg = get_config(arch).replace(dtype="float32", **DECODE_CUTS[arch])
    if cfg.moe is not None:
        # no drops on either side: an expert's capacity holds every token
        # once the factor is n_experts / top_k (32 for DeepSeek-V3)
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=max(
            16.0, cfg.moe.n_experts / cfg.moe.top_k)))
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = model.init(gen, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, prompt + steps),
                         generator=gen, device="cuda")
    patch = (torch.randn((1, patches, cfg.d_model), generator=gen,
                         device="cuda") if patches else None)
    tol, worst = 1e-3, {}
    window = getattr(model, "static_window", 0)
    runs = {"full cache": prompt + steps + 5}
    if ring:
        check(prompt <= window < prompt + steps,
              f"{arch}: a ring of {window} slots would not take the prompt "
              f"or would not wrap")
        runs["ring"] = window
    with torch.inference_mode():
        ref = full_logits(model, params, toks, patch)
        got = {}
        for run, slots in runs.items():
            if ring:
                model.window_cache = run == "ring"
            logits, cache, length = model.prefill(params, toks[:, :prompt],
                                                  slots, patch)
            if patches:
                check(cache["k"].shape[2] == slots + patches,
                      f"{arch}: {cache['k'].shape[2]} cache slots")
            got[run] = [logits[:, 0]]
            for i in range(prompt, prompt + steps):
                logits, cache, length = model.decode(
                    params, cache, toks[:, i:i + 1], length)
                got[run].append(logits[:, 0])
            check(length == patches + prompt + steps,
                  f"{arch} {run}: length {length}")
            del cache
            pairs = [(a, ref[:, prompt - 1 + n])
                     for n, a in enumerate(got[run])]
            if run == "ring":
                pairs += list(zip(got[run], got["full cache"]))
            worst[run] = 0.0
            for a, b in pairs:
                worst[run] = max(worst[run], (a - b).abs().max().item())
                torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    what = f"{patches} patch embeddings, then " if patches else ""
    where = (f"; window {window}, positions {prompt}-{prompt + steps - 1} "
             f"decoded" if window else "")
    ring_txt = "; the ring also against the full cache's logits" if ring \
        else ""
    print(f"[decode] {arch} {DECODE_CUTS[arch]} f32 full width: {what}"
          f"{prompt}-token prefill and {steps} teacher-forced decode "
          f"steps vs one forward over {patches + prompt + steps} positions"
          f"{where}: max_abs_err "
          f"{', '.join(f'{r} {e:.3e}' for r, e in worst.items())} (tol "
          f"{tol:g}{ring_txt})")
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------ Whisper (path g)


@contextlib.contextmanager
def _swapped(obj, attr, value):
    """``obj.attr`` set to ``value`` inside the block; yields the old."""
    real = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield real
    finally:
        setattr(obj, attr, real)


def whisper_k1_launches(cfg):
    """K1's launches in a Whisper prefill wave (the encoder's layers, each
    decoder layer's self- and cross-attention), and in a training step:
    (forward: the encoder's, and the decoder's twice, its layers
    recomputed under activation checkpointing; backward kernel launches:
    a call for each attention, ``kernel_bwd.KERNELS["hopper"]`` each)."""
    from repro_torch.kernels.flash_attention import kernel_bwd
    attentions = cfg.n_enc_layers + 2 * cfg.n_layers
    return attentions, (cfg.n_enc_layers + 4 * cfg.n_layers,
                        attentions * len(kernel_bwd.KERNELS["hopper"]))


def phase_whisper_serve(card, profile):
    """Path g: WHISPER_SERVE's 8 requests in waves of 4 through
    ``WhisperLM.prefill(frames=)`` and ``decode`` on the card, in bf16
    from seed 0.  Every request gets its tokens, every logit finite; each
    wave launches K1 ``whisper_k1_launches`` times, all on the Hopper
    variant, and no other kernel; no plain version is called.  Prints
    each wave's prefill time and the median decode step (host clock,
    synchronised), the least time to read what a decode step reads, and
    the peak memory; with ``profile``, one prefill wave and three decode
    steps profiled.  Returns the run's counts (``read_counts``' keys)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_tiny import N_AUDIO_FRAMES
    from repro_torch.models.factory import build_model
    ops = kernel_ops()
    spec = WHISPER_SERVE
    n_req, batch, new = spec["requests"], spec["batch"], spec["new_tokens"]
    (lo, hi), max_len = spec["prompt"], spec["max_len"]
    t_phase = time.perf_counter()
    cfg = get_config(WHISPER)
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    nbytes = {k: sum(t.numel() * t.element_size() for t in _leaves(v))
              if isinstance(v, dict) else 0 for k, v in params.items()}
    params_gb = sum(nbytes.values()) / 1e9
    print(f"[whisper] {WHISPER}: {cfg.n_enc_layers} + {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {n_params / 1e6:.2f} M params "
          f"({params_gb * 1e3:.1f} MB) in {str(model.dtype)[6:]} "
          f"initialised in {init_s:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(lo, hi + 1)))
               for _ in range(n_req)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    frames = torch.randn((n_req, N_AUDIO_FRAMES, cfg.d_model),
                         generator=gen, device="cuda")
    waves = [list(range(i, min(i + batch, n_req)))
             for i in range(0, n_req, batch)]
    seconds = {"prefill": [], "decode": []}

    def serve(idx, n_new):
        """One wave: left-padded prompts, prefill, n_new - 1 greedy decode
        steps; returns (tokens (len(idx), n_new), non-finite logits)."""
        s = max(len(prompts[i]) for i in idx)
        toks = np.zeros((len(idx), s), np.int32)
        for row, i in enumerate(idx):
            toks[row, s - len(prompts[i]):] = prompts[i]
        toks = torch.from_numpy(toks).cuda()
        fr = frames[idx[0]:idx[-1] + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, length = model.prefill(params, toks, max_len,
                                              frames=fr)
        bad = int((~torch.isfinite(logits)).sum())          # syncs
        seconds["prefill"].append(time.perf_counter() - t0)
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        out = [nxt]
        for _ in range(n_new - 1):
            t0 = time.perf_counter()
            logits, cache, length = model.decode(params, cache, nxt, length)
            bad += int((~torch.isfinite(logits)).sum())
            seconds["decode"].append(time.perf_counter() - t0)
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            out.append(nxt)
        return torch.cat(out, dim=1).cpu(), bad

    k1_wave = whisper_k1_launches(cfg)[0]
    want = expected_counts({"flash_attention": (k1_wave, 0)}, ops)
    with torch.inference_mode():
        serve(waves[0][:1], 2)           # warm-up (cuBLAS handles), unread
    for times in seconds.values():
        times.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain, undo = _count_plain_calls()
    per_wave, got, nonfinite = [], [], 0
    try:
        with torch.inference_mode():
            for idx in waves:
                reset_counts(ops)
                toks, bad = serve(idx, new)
                per_wave.append(read_counts(ops))
                got.append(toks)
                nonfinite += bad
    finally:
        undo()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms = [t * 1e3 for t in seconds["prefill"]]
    decode_ms = float(np.median(seconds["decode"])) * 1e3
    # a decode step reads the decoder's weights, the tied embedding (its
    # head) and the final norm, and the wave's caches: self k/v at
    # max_len slots, cross k/v at 1500
    step_gb = (nbytes["dec"] + nbytes["embed"] + nbytes["final_norm"]) / 1e9
    cache_gb = sum(t.numel() * t.element_size() for t in _leaves(
        model.init_cache(batch, max_len, "meta"))) / 1e9
    hbm = HBM_BYTES_PER_S / 1e12
    print(f"[whisper] path g: prompts {[len(p) for p in prompts]}, "
          f"{len(waves)} waves of {batch}, {N_AUDIO_FRAMES} frames a "
          f"request, max_len {max_len}; tokens a request "
          f"{[t.shape[1] for t in got for _ in range(t.shape[0])]}; "
          f"{len(seconds['decode'])} decode steps; {nonfinite} non-finite "
          f"logits; counts a wave {per_wave}; plain versions called "
          f"{plain}")
    print(f"[whisper] path g step times on the host clock: prefill per "
          f"wave {[round(t, 2) for t in prefill_ms]} ms, decode step "
          f"median {decode_ms:.2f} ms (reading the {step_gb * 1e3:.1f} MB "
          f"of weights a step reads takes at least "
          f"{step_gb / hbm:.4f} ms at {hbm:g} TB/s, with the "
          f"{cache_gb * 1e3:.1f} MB of a wave's caches "
          f"{(step_gb + cache_gb) / hbm:.4f} ms); peak memory "
          f"{peak_gb:.3f} GB; phase {time.perf_counter() - t_phase:.1f} "
          f"s | {card}")
    check(len(got) == len(waves) and sum(t.shape[0] for t in got) == n_req,
          f"whisper: {sum(t.shape[0] for t in got)} of {n_req} served")
    check(all(t.shape[1] == new for t in got),
          "whisper: a request got the wrong number of tokens")
    check(nonfinite == 0, f"whisper: {nonfinite} non-finite logits")
    check(all(c == want for c in per_wave),
          f"whisper: counts a wave {per_wave}, expected {want}")
    check(not any(plain.values()), f"whisper: plain versions {plain}")
    result = {"arch": WHISPER, "prompt_lengths": [len(p) for p in prompts],
              "frames": N_AUDIO_FRAMES, "max_len": max_len,
              "new_tokens": new, "prefill_ms": prefill_ms,
              "decode_step_ms_median": decode_ms, "peak_memory_gb": peak_gb,
              "params_mb": params_gb * 1e3, "step_read_mb": step_gb * 1e3,
              "cache_mb": cache_gb * 1e3, "card": card}
    print("whisper_serve " + json.dumps(result))
    if profile:
        profile_steps(model, params, max_len, seq=hi, batch=batch,
                      prefill_kw={"frames": frames[:batch]})
    del params, frames
    return _sum_counts(per_wave)


def phase_whisper_card_vs_cpu():
    """whisper-tiny at full width and depth on the card against the same
    model on the CPU, with the same weights (drawn once on the CPU from
    seed 0 and copied across): WHISPER_CHECK's prefill wave (its logits
    and its k/v/ck/cv caches), then 8 teacher-forced decode steps' logits
    and the self caches after them.  In f32 (K1's general variant, TF32
    off) every logits row within 1e-4 of its largest |logit| and each
    cache within 1e-4 of its largest |value|; in bf16 (the Hopper
    variant) every row within 5e-2 against the CPU's f32 run, its worst
    row printed.  Three faults run in f32 on the card must land far past
    the f32 limit: the encoder causal, the cross-attention's k/v from the
    decoder's input instead of the encoder's output, and decode embedding
    the token at position ``length`` instead of 0."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_tiny import N_AUDIO_FRAMES
    from repro_torch.models import attention as A
    from repro_torch.models.factory import build_model
    from repro_torch.models.whisper import WhisperLM
    flash = kernel_ops()["flash_attention"]
    spec = WHISPER_CHECK
    b, prompt, steps = spec["batch"], spec["prompt"], spec["steps"]
    t_phase = time.perf_counter()
    cfg = get_config(WHISPER).replace(dtype="float32")
    params = WhisperLM(cfg).init(torch.Generator().manual_seed(SEED), "cpu")
    rng = np.random.default_rng(SEED + 13)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (b, prompt + steps)))
    frames = torch.from_numpy(rng.standard_normal(
        (b, N_AUDIO_FRAMES, cfg.d_model)).astype(np.float32))

    def run(model, p, device):
        """(logits (b, 1 + steps, V), caches after prefill, self caches
        after the last step), f32 on the CPU; K1's launches by variant."""
        before = dict(flash.launches_by_variant)
        with torch.inference_mode():
            logits, cache, length = model.prefill(
                p, toks[:, :prompt].to(device), spec["max_len"],
                frames=frames.to(device))
            rows = [logits[:, 0].float().cpu()]
            # copies: decode writes the cache in place
            caches = {k: v.to("cpu", torch.float32, copy=True)
                      for k, v in cache.items()}
            for i in range(prompt, prompt + steps):
                logits, cache, length = model.decode(
                    p, cache, toks[:, i:i + 1].to(device), length)
                rows.append(logits[:, 0].float().cpu())
            check(length == prompt + steps, f"whisper: length {length}")
            end = {k: cache[k].float().cpu() for k in ("k", "v")}
        took = {vt: n - before[vt]
                for vt, n in flash.launches_by_variant.items()}
        return torch.stack(rows, dim=1), caches, end, took

    def row_ratio(got, want):
        """Worst max |got - want| / max |want| over the logits rows."""
        return ((got - want).abs().amax(-1)
                / want.abs().amax(-1).clamp_min(1e-30)).max().item()

    def cache_ratio(got, want):
        return {k: ((got[k] - want[k]).abs().max()
                    / want[k].abs().max().clamp_min(1e-30)).item()
                for k in want}

    t0 = time.perf_counter()
    want, want_cache, want_end, _ = run(WhisperLM(cfg), params, "cpu")
    cpu_s = time.perf_counter() - t0
    wave = whisper_k1_launches(cfg)[0]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(cfg.replace(dtype=str(dtype)[6:]))
        on_card = T.map_tree(lambda t: t.to("cuda", dtype), params)
        got, cache, end, took = run(model, on_card, "cuda")
        variant = "general" if dtype == torch.float32 else "hopper"
        ratio = row_ratio(got, want)
        caches = {**cache_ratio(cache, want_cache),
                  **{f"{k} after decode": e for k, e in
                     cache_ratio(end, want_end).items()}}
        limit = WHISPER_ROW_LIMIT[dtype]
        results[str(dtype)[6:]] = {"worst_row": ratio, "caches": caches}
        print(f"[whisper_check] {str(dtype)[6:]} on the card vs f32 on the "
              f"CPU, {b} x {prompt} tokens, {N_AUDIO_FRAMES} frames, "
              f"{steps} decode steps: K1 launches by variant {took}; worst "
              f"logits row err {ratio:.3e} of the row's largest |logit| "
              f"(limit {limit:g}); caches (err over largest |value|) "
              f"{', '.join(f'{k} {e:.3e}' for k, e in caches.items())}")
        check(took == {vt: wave if vt == variant else 0 for vt in took},
              f"whisper {dtype}: K1 launches {took}, expected {wave} "
              f"{variant}")
        check(math.isfinite(ratio) and ratio <= limit,
              f"whisper {dtype}: worst row {ratio:.3e} past {limit:g}")
        if dtype == torch.float32:
            check(all(e <= limit for e in caches.values()),
                  f"whisper f32: caches {caches} past {limit:g}")
            card_params = on_card
        else:
            del on_card

    real_flash, real_qkv = flash.flash_attention, A.project_qkv

    class CausalEncoder(WhisperLM):
        def encode(self, p, fr):
            def causal(q, k, v, **kw):
                return real_flash(q, k, v, **{**kw, "causal": True})
            with _swapped(flash, "flash_attention", causal):
                return super().encode(p, fr)

    class CrossFromDecoder(WhisperLM):
        def _dec_layer_full(self, x, lp, enc, cache_entry):
            def from_x(x, p, c, kv_x=None):
                return real_qkv(x, p, c)
            with _swapped(A, "project_qkv", from_x):
                return super()._dec_layer_full(x, lp, enc, cache_entry)

    class DecodeAtLength(WhisperLM):
        def decode(self, p, cache, tokens, length):
            real = self._embed_tokens
            self._embed_tokens = lambda pp, t, offset=0: real(
                pp, t, offset=length)
            try:
                return super().decode(p, cache, tokens, length)
            finally:
                del self._embed_tokens

    limit = WHISPER_ROW_LIMIT[torch.float32]
    faults = {}
    for name, cls in (("the encoder causal", CausalEncoder),
                      ("cross k/v from the decoder's input",
                       CrossFromDecoder),
                      ("decode at position length", DecodeAtLength)):
        faults[name] = row_ratio(run(cls(cfg), card_params, "cuda")[0],
                                 want)
    print(f"[whisper_check] faults in f32 on the card, worst logits row "
          f"err: {', '.join(f'{k} {e:.3e}' for k, e in faults.items())} "
          f"(limit {limit:g}); the CPU run {cpu_s:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    for name, e in faults.items():
        check(e > 100 * limit, f"whisper: {name} gives only {e:.3e}: the "
                               f"check cannot see it")
    print("whisper_check " + json.dumps({**results, "faults": faults}))
    del card_params


# ------------------------------------------------------------------- mesh


def mesh_waves(vocab):
    """Path a's 8 prompts (seed 0, 256-1024 tokens) in waves of 4, each
    left-padded with token 0 to its longest (as ServeEngine pads), and
    each request's MESH_FORCED teacher-forced tokens: [(tokens (4, L),
    forced (4, MESH_FORCED))], int64 on the CPU."""
    (lo, hi), _ = SHORT_TRAFFIC
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1)))
               for _ in range(8)]
    forced = np.random.default_rng(SEED + 29).integers(
        1, vocab, (len(prompts), MESH_FORCED))
    waves = []
    for w0 in range(0, len(prompts), 4):
        wave = prompts[w0:w0 + 4]
        toks = np.zeros((len(wave), max(map(len, wave))), np.int64)
        for i, p in enumerate(wave):
            toks[i, toks.shape[1] - len(p):] = p
        waves.append((torch.from_numpy(toks),
                      torch.from_numpy(forced[w0:w0 + 4])))
    return waves


class RouteLog:
    """Inside the block, every MoE routing call records, for each wave row
    (the last prompt position in a prefill call of ``rows`` x L tokens,
    the row's token in a decode call), its top-k experts (sorted) and its
    margin at the k-th choice: the k-th largest router logit less the
    (k+1)-th, in bf16 value spacings at the k-th.  The router's logits
    are rounded to bf16, so a margin of 0-2 spacings is a near tie that a
    rounding elsewhere can turn."""

    def __init__(self, rows):
        self.rows, self.calls = rows, []

    def __enter__(self):
        from repro_torch.models import moe as M
        self.M, self.real = M, M.route

        def route(x, w, m, mode):
            out = self.real(x, w, m, mode)
            length = x.shape[0] // self.rows
            keep = torch.arange(self.rows, device=x.device) * length + (
                length - 1)
            top = (x[keep] @ w).float().topk(m.top_k + 1, dim=-1).values
            kth = top[:, -2]
            spacing = torch.exp2(torch.floor(torch.log2(
                kth.abs().clamp_min(1e-30))) - 7)
            self.calls.append((out[0][keep].sort(-1).values.cpu(),
                               ((kth - top[:, -1]) / spacing).cpu()))
            return out

        M.route = route
        return self

    def __exit__(self, *exc):
        self.M.route = self.real


def mesh_reference(arch, cut):
    """The one-device run of a mesh path on the card, with the weights the
    ranks draw (seed 0): each wave's prefill logits and its forced decode
    steps', (waves, 4, 1 + MESH_FORCED, V) f32 on the CPU, the MoE
    routing calls of those forwards (RouteLog), and each wave's Mamba
    state after its forced steps (``mamba_state``; None without Mamba)."""
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build_model
    cfg = get_config(arch).replace(**cut)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    out, states = [], []
    with torch.inference_mode(), RouteLog(4) as routes:
        for toks, forced in mesh_waves(cfg.vocab_size):
            logits, cache, length = model.prefill(params, toks.cuda(),
                                                  SHORT_TRAFFIC[1])
            rows = [logits[:, 0].float().cpu()]
            for i in range(MESH_FORCED):
                logits, cache, length = model.decode(
                    params, cache, forced[:, i:i + 1].cuda(), length)
                rows.append(logits[:, 0].float().cpu())
            out.append(torch.stack(rows, dim=1))
            states.append(mamba_state(model, cache))
            del cache
    del params
    free_device_memory(f"{arch}'s one-device run")
    return torch.stack(out), routes.calls, states


def mamba_state(model, cache, ctx=None):
    """The Mamba layers' ssm state of a serving cache, (P, n_mamba, b, di,
    N) f32 on the CPU, gathered whole over the mesh by ``cache_specs``
    where ``ctx`` is given (every rank issues the gathers); None for a
    model without Mamba layers."""
    from repro_torch.distribution.sharding import unshard
    if model.cfg.mamba is None:
        return None
    ssm = cache["mamba"]["ssm"]
    if ctx is not None:
        ssm = unshard({"ssm": ssm},
                      {"ssm": model.cache_specs()["mamba"]["ssm"]},
                      ctx)["ssm"]
    return ssm.float().cpu()


def _mesh_rows(t, ctx):
    """This rank's rows of a wave (split over `data`)."""
    n = t.shape[0] // ctx.dp_size
    return t[ctx.comm.axis_index(ctx.dp) * n:][:n]


def _mesh_forward(model, params, ctx, toks, forced, steps, frames=None,
                  max_len=SHORT_TRAFFIC[1], state_fn=None):
    """One wave on this rank: prefill (with this rank's rows of
    ``frames`` where given: Whisper's), then ``steps`` decode steps (the
    forced tokens first, greedy after).  Returns (logits rows (b_l, 1 +
    MESH_FORCED, V) f32 on the CPU, prefill s, decode s each, collective
    bytes and calls of the prefill and of the sixth step, the state after
    the forced steps: ``state_fn(model, cache, ctx)``, by default the
    Mamba state gathered whole, ``mamba_state``, None without Mamba or
    forced steps)."""
    comm = ctx.comm
    state_fn = state_fn or mamba_state
    toks = _mesh_rows(toks, ctx).cuda()
    forced = _mesh_rows(forced, ctx).cuda()
    extra = ({} if frames is None
             else {"frames": _mesh_rows(frames, ctx).cuda()})
    comm.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, length = model.prefill(params, toks, max_len, **extra)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    moved = {"prefill": dict(comm.bytes_by_op)}
    rows, decode_s, state = [logits[:, 0].float().cpu()], [], None
    for i in range(steps):
        tok = (forced[:, i:i + 1] if i < MESH_FORCED
               else logits[:, -1].argmax(-1, keepdim=True))
        comm.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, length = model.decode(params, cache, tok, length)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        if i < MESH_FORCED:
            rows.append(logits[:, 0].float().cpu())
        if i == MESH_FORCED - 1:
            state = state_fn(model, cache, ctx)
        if i == 5:
            moved["decode_step"] = dict(comm.bytes_by_op)
            moved["decode_step_calls"] = dict(comm.calls_by_op)
    return torch.stack(rows, dim=1), prefill_s, decode_s, moved, state


def _mesh_path(ctx, label, spec, faults):
    """A mesh serving path on this rank (``spec``: its arch and cut): its
    weights (each rank in turn draws the
    full model from seed 0 on the card, cuts its blocks and frees the
    rest, so one full copy exists at a time), a warm-up wave off the
    record, then both waves with K1's counts and the collectives' bytes
    set to 0 before and read after; with ``faults``, wave 0 again under
    each of three faults on rank (data 0, model 1).  Returns what the
    parent checks and prints."""
    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.distribution.sharding import param_specs
    from repro_torch.launch.specs import optimized_overrides
    from repro_torch.models.factory import build_model
    ops = kernel_ops()
    comm = ctx.comm
    coords = (comm.axis_index("data"), comm.axis_index("model"))
    arch = spec["arch"]
    cfg = get_config(arch).replace(**spec["cut"])
    model = build_model(cfg, ctx)
    for knob, value in optimized_overrides(arch, "decode_32k").items():
        setattr(model, knob, value)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    in_proj_block = None
    for r in range(tdist.get_world_size()):
        if r == tdist.get_rank():
            full = build_model(cfg).init(
                torch.Generator(device="cuda").manual_seed(SEED), "cuda")
            if faults and cfg.mamba is not None:
                in_proj_block = _contiguous_block(
                    full["periods"]["mamba"]["in_proj"], ctx)
            params = _cut_freeing(full, param_specs(model, full), ctx)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        tdist.barrier()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params_gb = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) / 1e9
    waves = mesh_waves(cfg.vocab_size)
    n_moe = sum(map(cfg.layer_is_moe, range(cfg.n_layers))) \
        if cfg.moe else 0
    with torch.inference_mode():
        toks, forced = waves[0]
        _mesh_forward(model, params, ctx, toks[:, -32:], forced, 2)
        reset_counts(ops)
        torch.cuda.reset_peak_memory_stats()
        logits, prefill_s, decode_s, moved, routes = [], [], [], [], []
        states = []
        for toks, forced in waves:
            with RouteLog(toks.shape[0]) as log:
                got = _mesh_forward(model, params, ctx, toks, forced, 16)
            # the prefill's and the forced steps' routing calls
            routes += log.calls[:(1 + MESH_FORCED) * n_moe]
            logits.append(got[0])
            prefill_s.append(got[1])
            decode_s += got[2]
            moved.append(got[3])
            states.append(got[4])
        counts = read_counts(ops)
        out = {"coords": coords, "logits": torch.stack(logits),
               "prefill_ms": [t * 1e3 for t in prefill_s],
               "decode_ms": float(np.median(decode_s)) * 1e3,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "init_peak_gb": init_peak_gb, "params_gb": params_gb,
               "init_s": init_s, "k1": counts["k1_by_variant"],
               "counts": counts, "moved": moved[-1], "routes": routes,
               "states": states, "faults": {}}
        if faults and cfg.mamba is None and cfg.rwkv is None:
            out["faults"] = _mesh_faults(model, params, ctx, coords,
                                         waves[0])
        elif faults:
            out["faults"] = _mesh_ssm_faults(model, params, ctx, coords,
                                             waves[0], in_proj_block)
    del params
    return out


def _mesh_faults(model, params, ctx, coords, wave):
    """Wave 0 again under each fault, on rank (0, 1) alone; every rank
    still takes part in every collective (no rank waits): "wrong shard"
    (its wq block's heads rolled by one), "missing psum" (it keeps its
    own partial sums), "missing pmax" (it keeps its own maxima in the SP
    decode's combine).  Returns each fault's logits rows (and None for
    its state)."""
    comm, hd = ctx.comm, model.cfg.resolved_head_dim
    faulty = coords == (0, 1)
    rolled = {**params, "layers": {**params["layers"], "attn": {
        **params["layers"]["attn"],
        "wq": torch.roll(params["layers"]["attn"]["wq"], hd, dims=-1)}}}
    real_psum, real_pmax = comm.psum, comm.pmax
    runs = {"wrong shard": (rolled, {}),
            "missing psum": (params, {"psum": lambda x, axes: (
                real_psum(x, axes), x)[1]}),
            "missing pmax": (params, {"pmax": lambda x, axes: (
                real_pmax(x, axes), x)[1]})}
    out = {}
    toks, forced = wave
    for name, (p, patches) in runs.items():
        with contextlib.ExitStack() as stack:
            for attr, fn in patches.items():
                if faulty:
                    stack.enter_context(_swapped(comm, attr, fn))
            got = _mesh_forward(model, p if faulty else params, ctx, toks,
                                forced, MESH_FORCED)
            out[name] = {"logits": got[0], "state": got[4]}
    return out


def _cut_freeing(full, specs, ctx, train=False):
    """``sharding.shard_params`` leaf by leaf, each full leaf dropped from
    ``full`` once its block is cut: the drawing rank's peak is the full
    model and one block, not the full model and all of its blocks."""
    from repro_torch.distribution.sharding import shard_params
    out = {}
    for key in list(full):
        if isinstance(full[key], dict):
            out[key] = _cut_freeing(full[key], specs[key], ctx, train)
        else:
            out[key] = shard_params(full[key], specs[key], ctx, train)
        del full[key]
    return out


def _contiguous_block(in_proj, ctx):
    """This rank's block of Mamba's in_proj (.., d, 2 di) cut as one
    contiguous block of its 2 di columns over `model` (the layout fault:
    ``sharding.Parts`` cuts x's and z's halves each)."""
    n = in_proj.shape[-1] // ctx.tp_size
    return in_proj.narrow(-1, ctx.comm.axis_index(ctx.tp) * n, n).clone()


def _mesh_ssm_faults(model, params, ctx, coords, wave, in_proj_block):
    """Wave 0 again under each of the recurrent paths' faults, on rank (0,
    1) alone; every rank takes part in every collective.  RWKV: "wo's psum
    left out" (the rank keeps its own partial sums of the time mix's
    row-split output projection), "u and w0 at head offset 0" (the 1-D
    leaves it holds whole sliced at channel 0, not at its heads).  Jamba:
    "in_proj cut as one contiguous block" (its block of the 2 di columns,
    x's second half then z's, where ``sharding.Parts`` gives it x's and
    z's second halves), "x_proj's psum left out" (its own partial (dt, B,
    C) projections).  Returns each fault's logits rows and Mamba state
    (``_mesh_forward``)."""
    from repro_torch.models import common as C
    cfg = model.cfg
    real_sum = C.row_sum

    def keep_own(width):
        def row_sum(y, rows, full_rows, dist):
            out = real_sum(y, rows, full_rows, dist)
            return y if y.shape[-1] == width else out
        return row_sum

    if cfg.rwkv is not None:
        runs = {"wo's psum left out": (params, {
                    "row_sum": keep_own(cfg.d_model)}),
                "u and w0 at head offset 0": (params, {
                    "local_block": lambda t, n, dist: t[..., :n]})}
    else:
        mamba = {**params["periods"]["mamba"], "in_proj": in_proj_block}
        contiguous = {**params, "periods": {**params["periods"],
                                            "mamba": mamba}}
        width = cfg.mamba.dt_rank + 2 * cfg.mamba.d_state
        runs = {"in_proj cut as one contiguous block": (contiguous, {}),
                "x_proj's psum left out": (params, {
                    "row_sum": keep_own(width)})}
    faulty = coords == (0, 1)
    out = {}
    toks, forced = wave
    for name, (p, patches) in runs.items():
        with contextlib.ExitStack() as stack:
            for attr, fn in patches.items():
                if faulty:
                    stack.enter_context(_swapped(C, attr, fn))
            got = _mesh_forward(model, p if faulty else params, ctx, toks,
                                forced, MESH_FORCED)
            out[name] = {"logits": got[0], "state": got[4]}
    return out


def _mesh_rank(rank, shape, backend, paths, workdir, runner, cards):
    """One rank of a mesh phase (a spawned process) on card ``rank %
    cards``: joins the mesh, runs ``runner`` (the name of ``_mesh_path``,
    serving, or of ``_mesh_train_path``) on each of ``paths`` ((label,
    spec, faults)) and saves what it returns to ``workdir/rank<r>.pt``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as tdist

    from repro_torch.distribution.collectives import Collectives
    from repro_torch.distribution.context import make_context
    from repro_torch.launch.mesh import make_smoke_mesh
    # four processes share the card: memory a rank frees (the full model
    # it drew) goes back to the card, not to blocks its allocator keeps
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    # f32 products in full f32, as main() sets them for the parent's runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank % cards)
    store = tdist.FileStore(str(Path(workdir) / "store"), math.prod(shape))
    mesh = make_smoke_mesh(shape, ("data", "model"), device_type="cuda",
                           backend=backend, store=store, rank=rank)
    ctx = make_context(mesh, comm=Collectives(mesh))
    out = {"backend": ctx.comm.backend, "staged": ctx.comm.stage}
    for label, spec, faults in paths:
        out[label] = globals()[runner](ctx, label, spec, faults)
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    tdist.barrier()
    tdist.destroy_process_group()


def run_mesh_ranks(shape, backend, paths, runner="_mesh_path", cards=1):
    """Spawns the ranks of a ``shape`` mesh on ``backend``, rank r on card
    r % ``cards`` (all on card 0 by default), and joins them by
    MESH_DEADLINE_S; fails (stopping every rank) if one fails or the
    deadline passes.  Returns each rank's results by its (data, model)
    coordinates."""
    import tempfile

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=_mesh_rank,
                             args=(r, shape, backend, paths, workdir,
                                   runner, cards))
                 for r in range(math.prod(shape))]
        for p in procs:
            p.start()
        end = time.monotonic() + MESH_DEADLINE_S
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                check(not failed, f"mesh {shape} {backend}: rank(s) "
                                  f"{failed} failed")
                check(time.monotonic() < end,
                      f"mesh {shape} {backend}: ranks still running after "
                      f"{MESH_DEADLINE_S} s")
                time.sleep(0.5)
            codes = [p.exitcode for p in procs]
            check(codes == [0] * len(procs),
                  f"mesh {shape} {backend}: rank exit codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        outs = [torch.load(Path(workdir) / f"rank{r}.pt", weights_only=False)
                for r in range(len(procs))]
    return {o[paths[0][0]]["coords"]: o for o in outs}


def mesh_row_errs(got, want):
    """max |got - want| / max |want| of each logits row."""
    return ((got - want).abs().amax(-1)
            / want.abs().amax(-1).clamp_min(1e-30))


def mesh_row_err(got, want):
    """The worst row's."""
    return mesh_row_errs(got, want).max().item()


def _routing_near_ties(want_routes, got_routes, shape, n_moe):
    """(rows whose top-k experts differ between the runs at some MoE
    layer, those of them where every such layer's one-device margin is a
    near tie (<= 2 bf16 spacings)): boolean (waves, 4, 1 + MESH_FORCED)."""
    differ = torch.zeros(shape, dtype=torch.bool)
    near = torch.ones(shape, dtype=torch.bool)
    for c, ((wi, wm), (gi, _)) in enumerate(zip(want_routes, got_routes)):
        step = c // n_moe
        w, j = divmod(step, shape[2])
        d = (wi != gi).any(-1)
        differ[w, :, j] |= d
        near[w, :, j] &= ~d | (wm <= 2)
    return differ, differ & near


def mesh_state_err(got, want):
    """The worst batch row's max |got - want| / max |want| of a Mamba
    state (P, n_mamba, b, di, N), or of each of Whisper's caches ({k, v,
    ck, cv}: (L, b, slots, h, hd)), the worst of them."""
    if isinstance(want, dict):
        return max(mesh_row_err(got[k].movedim(1, 0).flatten(1).float(),
                                w.movedim(1, 0).flatten(1).float())
                   for k, w in want.items())
    return mesh_row_err(got.movedim(2, 0).flatten(1),
                        want.movedim(2, 0).flatten(1))


def _mesh_check(label, spec, outs, want, shape, backend, card):
    """Holds a serving path's rows on the mesh (``spec``: its arch, cut
    and ``per_wave``, {kernel: launches a wave}, K1 once a layer by
    default), and its Mamba state after the forced steps where it has
    one, within MESH_ROW_LIMIT of the one-device run; each of its faults
    past twice the limit in the rows or the state; its kernels' launches
    on every rank to ``per_wave``, K1's all Hopper, K2's under
    kernel.plan's choice, K3's in serving mode; prints its numbers and
    returns them.  With MoE layers, a row may pass the limit only where
    the two runs' router took other experts for its token at a near tie
    (RouteLog): both runs round the router's logits to bf16, and
    roundings elsewhere can turn such a tie."""
    from repro_torch.configs import get_config
    want, want_routes, want_states = want
    arch = spec["arch"]
    cfg = get_config(arch).replace(**spec["cut"])
    layers = cfg.n_layers
    per_wave = spec.get("per_wave", {"flash_attention": layers})
    blocks = []
    for di in range(shape[0]):
        first = outs[(di, 0)][label]["logits"]
        for mi in range(1, shape[1]):
            check(torch.equal(outs[(di, mi)][label]["logits"], first),
                  f"mesh {label}: ranks ({di}, 0) and ({di}, {mi}) "
                  f"disagree")
        blocks.append(first)
    got = torch.cat(blocks, dim=1)
    errs = mesh_row_errs(got, want)
    r0 = outs[(0, 0)][label]
    state_errs = []
    if want_states[0] is not None:
        state_errs = [mesh_state_err(g, w)
                      for g, w in zip(r0["states"], want_states)]
    n_moe = sum(map(cfg.layer_is_moe, range(layers))) if cfg.moe else 0
    differ = near = torch.zeros(errs.shape, dtype=torch.bool)
    if n_moe:
        check(len(r0["routes"]) == len(want_routes),
              f"mesh {arch}: {len(r0['routes'])} routing calls, one device "
              f"{len(want_routes)}")
        differ, near = _routing_near_ties(want_routes, r0["routes"],
                                          errs.shape, n_moe)
    over = errs > MESH_ROW_LIMIT
    bad = over & ~near
    err = errs[~(over & near)].max().item()
    waves = want.shape[0]
    print(f"[mesh] {label}: {arch} ({layers} layers of "
          f"{get_config(arch).n_layers}, {cfg.dtype}) on a {shape} "
          f"('data', 'model') mesh over {backend} (staged through the "
          f"host: {outs[(0, 0)]['staged']}): worst logits row err "
          f"{err:.3e} of the row's largest |logit| against the one-device "
          f"run (limit {MESH_ROW_LIMIT:g}), {waves} waves x 4 rows x "
          f"{1 + MESH_FORCED} (prefill + forced steps)"
          + (f"; the router chose other experts for {int(differ.sum())} "
             f"of {differ.numel()} rows' tokens, {int(near.sum())} at near "
             f"ties; {int((over & near).sum())} rows past the limit, each "
             f"at a near tie: errs "
             f"{[round(e, 3) for e in errs[over & near].tolist()]}"
             if n_moe else "")
          + (f"; {spec.get('state', 'Mamba state')} after the forced "
             f"steps, worst row err "
             f"{', '.join(f'{e:.3e}' for e in state_errs)} (each wave)"
             if state_errs else ""))
    print(f"[mesh] {label} {backend}: rank (0, 0) prefill per wave "
          f"{[round(t, 1) for t in r0['prefill_ms']]} ms, decode step "
          f"median {r0['decode_ms']:.1f} ms (host clock, synchronised); "
          f"weights drawn and cut in {r0['init_s']:.1f} s | {card}")
    expect = expected_counts({k: (n * waves, 0) for k, n in per_wave.items()},
                             kernel_ops(), k3_mode="serving")
    for c in sorted(outs):
        o = outs[c][label]
        got = o["counts"]
        print(f"[mesh] {label} {backend} rank {c}: {o['params_gb']:.2f} GB "
              f"of weights, peak {o['peak_gb']:.2f} GB serving "
              f"({o['init_peak_gb']:.2f} GB drawing the full model to cut "
              f"it); launches {got['launches']}, K1 by variant "
              f"{got['k1_by_variant']}, K2 by plan {got['k2_by_plan']}, K3 "
              f"by mode {got['k3_by_mode']}; bytes moved in a decode step "
              f"{o['moved']['decode_step']} (calls "
              f"{o['moved']['decode_step_calls']}), in the last prefill "
              f"{o['moved']['prefill']}")
        check(got == expect, f"mesh {label} rank {c}: kernel counts {got}, "
                             f"expected {expect}")
    check(math.isfinite(err) and not bad.any(),
          f"mesh {label} {backend}: rows {bad.nonzero().tolist()} past "
          f"{MESH_ROW_LIMIT:g} (errs {errs[bad].tolist()}) without a "
          f"routing near tie")
    check(all(e <= MESH_ROW_LIMIT for e in state_errs),
          f"mesh {label} {backend}: {spec.get('state', 'Mamba state')} err "
          f"{state_errs} past {MESH_ROW_LIMIT:g}")
    faults = {}
    for name, run in r0["faults"].items():
        rows = max(mesh_row_err(outs[(0, mi)][label]["faults"][name]
                                ["logits"], want[0, :2])
                   for mi in range(shape[1]))
        state = (mesh_state_err(run["state"], want_states[0])
                 if run["state"] is not None else None)
        faults[name] = {"rows": rows, "state": state}
    if faults:
        print(f"[mesh] {label} faults on rank (0, 1) (the self cache's "
              f"slots: on every rank), wave 0, worst logits row err / "
              f"{spec.get('state', 'Mamba state')} err: "
              + ", ".join(f"{k} {f['rows']:.3e} / "
                          + ("-" if f["state"] is None
                             else f"{f['state']:.3e}")
                          for k, f in faults.items())
              + f" (limit {MESH_ROW_LIMIT:g}, a fault must pass twice it)")
        for name, f in faults.items():
            e = max(f["rows"], f["state"] or 0.0)
            check(e > 2 * MESH_ROW_LIMIT,
                  f"mesh {label}: {name} gives only {e:.3e}: the check "
                  f"cannot see it")
    return {"worst_row": err, "near_tie_rows_past_limit":
            errs[over & near].tolist(), "routing_differs": int(differ.sum()),
            "state_errs": state_errs, "faults": faults,
            "prefill_ms_rank0": r0["prefill_ms"],
            "decode_ms_rank0": r0["decode_ms"],
            "k1_by_rank": {str(c): outs[c][label]["k1"] for c in outs},
            "launches_by_rank": {str(c): outs[c][label]["counts"]["launches"]
                                 for c in outs},
            "peak_gb_by_rank": {str(c): outs[c][label]["peak_gb"]
                                for c in outs},
            "decode_step_bytes_rank0": r0["moved"]["decode_step"]}


def phase_mesh(card):
    """DecoderLM's serving path on a ("data", "model") mesh (MESH_SHAPE,
    gloo, every rank on card 0): paths h and i (MESH_PATHS), each held row
    by row to the same model on one device (MESH_ROW_LIMIT), three faults
    on one rank shown to fail it, K1's launches on every rank all Hopper;
    then path h at 2 layers on a one-rank NCCL mesh.  The parent's kernel
    builds come first (phase_build); each one-device run is freed before
    the ranks start.  Returns the mesh paths' K1 launches and results."""
    t_phase = time.perf_counter()
    specs = {arch: dict(arch=arch, cut=cut)
             for arch, cut in MESH_PATHS.items()}
    wants = {arch: mesh_reference(arch, cut)
             for arch, cut in MESH_PATHS.items()}
    first = next(iter(MESH_PATHS))
    paths = [(arch, spec, arch == first) for arch, spec in specs.items()]
    outs = run_mesh_ranks(MESH_SHAPE, "gloo", paths)
    results = {arch: _mesh_check(arch, specs[arch], outs, want,
                                 MESH_SHAPE, "gloo", card)
               for arch, want in wants.items()}
    arch, cut = MESH_NCCL
    spec = dict(arch=arch, cut=cut)
    want = mesh_reference(arch, cut)
    outs1 = run_mesh_ranks((1, 1), "nccl", [(arch, spec, False)])
    check(outs1[(0, 0)]["backend"] == "nccl" and not outs1[(0, 0)]["staged"],
          f"the one-rank mesh ran {outs1[(0, 0)]['backend']}")
    results[f"{arch} nccl"] = _mesh_check(arch, spec, outs1, want, (1, 1),
                                          "nccl", card)
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s | {card}")
    print("mesh " + json.dumps(results))
    launches = {f"{a} (mesh {MESH_SHAPE[0]}x{MESH_SHAPE[1]} gloo)":
                {vt: sum(outs[c][a]["k1"][vt] for c in outs)
                 for vt in ("hopper", "general")} for a in MESH_PATHS}
    launches[f"{arch} (mesh 1x1 nccl)"] = dict(outs1[(0, 0)][arch]["k1"])
    return launches


# ------------------------------------------------------------- mesh train

# Path j: DecoderLM trained on the (2, 2) ("data", "model") gloo mesh of
# four ranks sharing card 0 (FSDP over `data`, TP over `model`), then on a
# one-rank NCCL mesh.  mistral-nemo-12b at full width (d_model 5120, 32
# q / 8 kv heads of 128, d_ff 14336, vocab 131072 untied) cut to 4 of its
# 40 layers (2.433 B params), 3 steps (the NCCL run: 2 layers, 2 steps);
# global batch 4 x 4096 tokens (train_4k's sequence) of the synthetic
# stream (seed 1), the reference's microbatches override at 2 with
# grad_specs set (its shard_grad_accum), f32 accumulators, AdamW with f32
# moments under the reference cell's cosine schedule (peak 3e-4, warmup
# 100, total 10000; launch/specs.py:170-175).  Kernel launches a step on
# every rank, (forward, backward): K1 4 a layer (2 microbatches, each
# forward and its checkpointed recompute) and 2 backward calls a layer (6
# launches).  A mesh training path is such a spec: its arch, cut and
# config replacements, batch shape, steps and kernels (``expected_counts``).
MESH_TRAIN = dict(arch="mistral-nemo-12b", cut=dict(n_layers=4),
                  shape=dict(batch=4, seq=4096, microbatches=2), steps=3,
                  kernels={"flash_attention": (16, 24)})
MESH_TRAIN_NCCL = dict(MESH_TRAIN, cut=dict(n_layers=2), steps=2,
                       kernels={"flash_attention": (8, 12)})
# Each step's loss and grad_norm on every rank against the one-device run
# of the same cut on the card, relative.  Both runs are bf16 with f32
# accumulators; the mesh rounds each row-parallel partial sum to bf16 and
# sums the gradients' parts in another order (FSDP reduce-scatters, the
# norm's psums), and the mesh serving paths' logits rows agree to ~2e-2
# of their scale (PERF.md §5).  The loss averages 16384 tokens' errors
# and the norm millions of entries', so both should agree to ~1e-4; the
# limits leave room for a bias of ten times that.  A lost psum or a
# gradient part counted twice moves them by percent.
MESH_TRAIN_LIMIT = {"loss": 2e-3, "grad_norm": 5e-3}
# faults on rank (0, 1) at the first step's params; every rank issues the
# same collectives: "row-parallel psum's backward left out" (the psum that
# ``comm.enter`` runs in the backward, before a column-split product,
# kept to the rank's own part) and "data reduction left out" (the FSDP
# gather's reduce-scatter, the rank keeping its own part of its block),
# each a gradient pass through the step with an optimizer that only takes
# the norm; "replicated leaf counted twice" (the leaves `model` does not
# cut counted on both `model` ranks), a second norm of step 1's gradients
MESH_TRAIN_FAULTS = ("row-parallel psum's backward left out",
                     "data reduction left out",
                     "replicated leaf counted twice")


def mesh_train_config(spec):
    """(config, shape) of a mesh training path's spec (MESH_TRAIN,
    MESH_SSM_TRAIN, MESH_WHISPER_TRAIN, MESH_QUANT_TRAIN): its arch with
    its cut, replacements, MoE offset and MoE replacements, and its batch
    shape."""
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"]).replace(**spec["cut"],
                                           **spec.get("replace", {}))
    if "moe_offset" in spec:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, layer_offset=spec["moe_offset"]))
    if "moe" in spec:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **spec["moe"]))
    return cfg, spec["shape"]


def mesh_train_parts(cfg, shape, dist=None, wrap=None, spec=None):
    """(model, optimizer, step_fn, data) of a mesh training path: the
    reference's train cell for ``cfg`` at ``shape``'s batch, sequence and
    microbatches; the optimizer is AdamW, or ``wrap(AdamW)``, with int8
    moments where ``spec`` says ``quantized`` and the accumulators in its
    ``accum`` dtype (f32 by default)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.factory import build_model
    from repro_torch.optim import AdamW, AdamWConfig, cosine
    from repro_torch.training.step import make_train_step
    spec = spec or {}
    model = build_model(cfg, dist)
    opt = AdamW(lambda s: cosine(s, peak_lr=3e-4, warmup=100,
                                 total=10_000),
                AdamWConfig(quantized=spec.get("quantized", False)))
    if wrap is not None:
        opt = wrap(opt)
    specs = model.layout()[0] if dist is not None else None
    step_fn = make_train_step(model, opt,
                              microbatches=shape["microbatches"],
                              accum_dtype=getattr(torch, spec.get(
                                  "accum", "float32")),
                              grad_specs=specs)
    data = SyntheticLMDataset(cfg.vocab_size, shape["seq"], shape["batch"],
                              seed=1)
    return model, opt, step_fn, data


def _batch_on_card(data, step, cfg):
    """The stream's batch ``step`` on the card; for Whisper with its
    frames (N(0, 1), seeded by the step on the CPU, so every rank and the
    one-device run draw the same)."""
    from repro_torch.configs.whisper_tiny import N_AUDIO_FRAMES
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in data.batch_at(step).items()}
    if cfg.is_encdec:
        gen = torch.Generator().manual_seed(SEED + 11 + step)
        batch["frames"] = torch.randn(
            (batch["tokens"].shape[0], N_AUDIO_FRAMES, cfg.d_model),
            generator=gen).cuda()
    return batch


def _leaf_scales(state, leaf, plans=None, ctx=None):
    """The block scales of ``leaf`` (a key path) of each quantized moment,
    (rows, blocks) f32 on the CPU: on a mesh gathered whole by the plan's
    ``q`` spec (every rank gathers; rank (0, 0) keeps them)."""
    from repro_torch.distribution.sharding import unshard
    out = {}
    for key in ("m", "v"):
        qt = state[key]
        for k in leaf:
            qt = qt[k]
        scale = qt.scale
        if plans is not None:
            plan = plans
            for k in leaf:
                plan = plan[k]
            scale = unshard(scale, plan.qspec, ctx)
        out[key] = scale[..., 0].float().cpu()
    return out


def mesh_train_reference(spec):
    """The one-device run of a mesh training path's spec on the card, from
    the weights the ranks draw: each step's loss and grad_norm and every
    kernel's counts a step; with ``spec["scales_of"]``, that leaf's block
    scales of each quantized moment after each step."""
    ops = kernel_ops()
    cfg, shape = mesh_train_config(spec)
    model, opt, step_fn, data = mesh_train_parts(cfg, shape, spec=spec)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    state = opt.init(params)
    out = {"loss": [], "grad_norm": [], "step_ms": [], "counts": [],
           "scales": [],
           "params_b": sum(t.numel() for t in _leaves(params)) / 1e9}
    for step in range(spec["steps"]):
        batch = _batch_on_card(data, step, cfg)
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["counts"].append(read_counts(ops))
        if "scales_of" in spec:
            out["scales"].append(_leaf_scales(state, spec["scales_of"]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, state
    free_device_memory(f"{cfg.name}'s one-device training run "
                       f"({cfg.n_layers} layers)")
    return out


class _NormOnly:
    """An optimizer for the fault runs: the step's global norm, no update
    (the params stay the first step's)."""

    @staticmethod
    def update(grads, state, params, mesh=None):
        from repro_torch import tree as T
        from repro_torch.optim import adamw
        gsq = adamw.global_square_sum(T.leaves(grads), mesh)
        return params, state, {"grad_norm": torch.sqrt(gsq)}


class _NormProbe:
    """AdamW's update, and before it, while ``norm`` is set (a function of
    the flat gradients and the mesh, issuing the same collectives on every
    rank), a second norm of the same gradients (``probed``)."""

    def __init__(self, opt):
        self.opt, self.norm, self.probed = opt, None, None
        self.cfg = opt.cfg           # make_train_step reads its moments

    def init(self, params, plans=None):
        return self.opt.init(params, plans=plans)

    def update(self, grads, state, params, mesh=None):
        from repro_torch import tree as T
        if self.norm is not None:
            self.probed = float(torch.sqrt(self.norm(T.leaves(grads), mesh)))
        return self.opt.update(grads, state, params, mesh=mesh)


def _counted_twice(tp):
    """``adamw.global_square_sum`` with each leaf `model` does not cut
    counted on every `model` rank (its ``tp`` copies: the leaf scaled by
    sqrt(tp)), through the same collectives."""
    def norm(flat_g, mesh):
        from repro_torch import tree as T
        from repro_torch.optim import adamw
        scaled = [g if "model" in ax else g * math.sqrt(tp)
                  for g, ax in zip(flat_g, T.leaves(mesh[1]))]
        return adamw.global_square_sum(scaled, mesh)

    return norm


def _mesh_train_fault(name, comm):
    """A context that puts fault ``name`` (one of the first two
    MESH_TRAIN_FAULTS) on this rank; every collective still runs, on
    every rank."""
    from repro_torch.distribution import collectives as CL
    stack = contextlib.ExitStack()
    real_psum, real_scatter = comm.psum, comm.psum_scatter

    class KeepOwnPsum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axes):
            ctx.axes = axes
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            real_psum(g, ctx.axes)
            return g, None

    class KeepOwnScatter(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axes, dim):
            ctx.axes, ctx.dim = axes, dim
            return comm._all_gather(x, axes, dim)

        @staticmethod
        def backward(ctx, g):
            real_scatter(g, ctx.axes, ctx.dim)
            return comm._own_block(g, ctx.axes, ctx.dim), None, None

    if name == MESH_TRAIN_FAULTS[0]:
        stack.enter_context(_swapped(
            comm, "enter", lambda x, axes: KeepOwnPsum.apply(
                x, comm._axes(axes)) if x.requires_grad else x))
    else:
        real_gather = comm.all_gather

        def gather(x, axes, dim):
            axes = comm._axes(axes)
            if x.requires_grad and all(a in CL.BATCH_AXES for a in axes):
                return KeepOwnScatter.apply(x, axes, dim % x.dim())
            return real_gather(x, axes, dim)

        stack.enter_context(_swapped(comm, "all_gather", gather))
    return stack


def _mesh_train_path(ctx, label, spec, faults):
    """A mesh training path on this rank (its ``spec``: MESH_TRAIN,
    MESH_SSM_TRAIN, MESH_WQ_TRAIN): its FSDP+TP blocks (each rank in turn
    draws the full model from seed 0 on the card and cuts them); with
    ``faults`` (path j), the norms under MESH_TRAIN_FAULTS on rank (0, 1)
    at the first step's params (the third from step 1's own gradients);
    the spec's steps, every kernel's counts and the collectives' bytes set
    to 0 before each step and read after it, and the bytes the quantized
    moments' gathers brought.  With ``spec["scales_of"]`` (path q), that
    leaf's block scales of each moment after each step, gathered whole,
    and after step 1 the scales of the fault MESH_QUANT_FAULT: the f32
    moments this rank stored quantized on their own (this rank's columns
    as if they were the whole leaf), gathered by rows over `data` and by
    blocks over `model`."""
    import torch.distributed as tdist

    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw, quant
    from repro_torch.training.step import make_train_step
    ops = kernel_ops()
    comm = ctx.comm
    coords = (comm.axis_index("data"), comm.axis_index("model"))
    cfg, shape = mesh_train_config(spec)
    model, probe, step_fn, data = mesh_train_parts(cfg, shape, ctx,
                                                   _NormProbe, spec)
    specs = model.layout()[0]
    torch.cuda.reset_peak_memory_stats()
    for r in range(tdist.get_world_size()):
        if r == tdist.get_rank():
            full = build_model(cfg).init(
                torch.Generator(device="cuda").manual_seed(SEED), "cuda")
            params = _cut_freeing(full, specs, ctx, train=True)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        tdist.barrier()
    params_gb = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) / 1e9
    state = probe.init(params, plans=step_fn.plans)
    out = {"coords": coords, "params_gb": params_gb, "faults": {},
           "steps": []}
    if faults:
        norm_fn = make_train_step(model, _NormOnly(),
                                  microbatches=shape["microbatches"],
                                  grad_specs=specs)
        batch = _batch_on_card(data, 0, cfg)
        for name in MESH_TRAIN_FAULTS[:2]:
            with contextlib.ExitStack() as stack:
                if coords == (0, 1):
                    stack.enter_context(_mesh_train_fault(name, comm))
                m = norm_fn(params, state, batch)[2]
            out["faults"][name] = float(m["grad_norm"])
            gc.collect()
        probe.norm = (_counted_twice(ctx.tp_size) if coords == (0, 1)
                      else adamw.global_square_sum)
    stored, capturing = [], [True]
    if "scales_of" in spec:
        plan = step_fn.plans
        for k in spec["scales_of"]:
            plan = plan[k]
        real_store = plan.store

        def store(x):
            if capturing[0]:         # step 1's m, then its v
                stored.append(x.clone())
            return real_store(x)

        plan.store = store
    for step in range(spec["steps"]):
        batch = _batch_on_card(data, step, cfg)
        torch.cuda.synchronize()
        reset_counts(ops)
        comm.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        loss = float(m["loss"])                     # waits for the card
        out["steps"].append({
            "loss": loss, "grad_norm": float(m["grad_norm"]),
            "step_ms": (time.perf_counter() - t0) * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "bytes": dict(comm.bytes_by_op),
            "calls": dict(comm.calls_by_op),
            "seconds": dict(comm.seconds_by_op),
            "staging_s": comm.staging_seconds, "counts": read_counts(ops),
            "moment_gather_bytes": probe.opt.gathered_bytes})
        if "scales_of" in spec:
            scales = _leaf_scales(state, spec["scales_of"], step_fn.plans,
                                  ctx)
            out["steps"][-1]["scales"] = scales if coords == (0, 0) else None
        if stored:
            capturing[0] = False
            local = {key: quant.quantize(x).scale for key, x in
                     zip(("m", "v"), stored)}
            stored.clear()
            fault = {key: comm.all_gather(comm.all_gather(
                t, "data", dim=0), "model", dim=-2)[..., 0].float().cpu()
                for key, t in local.items()}
            out["faults"][MESH_QUANT_FAULT] = (fault if coords == (0, 0)
                                               else None)
            del local
        if probe.norm is not None:
            out["faults"][MESH_TRAIN_FAULTS[2]] = probe.probed
            probe.norm = None
    del params, state
    return out


def _rel(got, want):
    return abs(got - want) / abs(want)


def _mesh_train_check(label, outs, want, shape, card, path, kernels):
    """Holds every rank's losses and norms to the one-device run's, every
    kernel's launches on every rank to the one-device run's a step and to
    ``kernels`` ({kernel: (forward, backward) launches a step};
    ``expected_counts``); prints each step's numbers.  Returns (every
    kernel's counts summed over ranks and steps, the worst relative
    errors)."""
    lim = MESH_TRAIN_LIMIT
    errs = {"loss": 0.0, "grad_norm": 0.0}
    counts = []
    for c in sorted(outs):
        o = outs[c][path]
        check(len(o["steps"]) == len(want["loss"]),
              f"{label} rank {c}: {len(o['steps'])} steps")
        for i, st in enumerate(o["steps"]):
            for key in errs:
                e = _rel(st[key], want[key][i])
                errs[key] = max(errs[key], e)
                check(math.isfinite(st[key]) and e <= lim[key],
                      f"{label} rank {c} step {i + 1}: {key} {st[key]:.6f}, "
                      f"one device {want[key][i]:.6f} (rel err {e:.3e}, "
                      f"limit {lim[key]:g})")
            check(st["counts"] == want["counts"][i],
                  f"{label} rank {c} step {i + 1}: kernel counts "
                  f"{st['counts']}, the one-device step's "
                  f"{want['counts'][i]}")
            counts.append(st["counts"])
    r0 = outs[(0, 0)][path]
    for i, st in enumerate(r0["steps"]):
        peak = max(outs[c][path]["steps"][i]["peak_gb"] for c in outs)
        print(f"[mesh_train] {label} step {i + 1}: loss {st['loss']:.6f} "
              f"(one device {want['loss'][i]:.6f}), grad_norm "
              f"{st['grad_norm']:.6f} ({want['grad_norm'][i]:.6f}); rank "
              f"(0, 0) {st['step_ms']:.1f} ms (host clock; one device "
              f"{want['step_ms'][i]:.1f} ms); peak {peak:.2f} GB a rank "
              f"(the largest); collectives bytes {st['bytes']} "
              f"calls {st['calls']} host seconds "
              f"{ {k: round(v, 3) for k, v in st['seconds'].items()} } "
              f"(of which the host copies {st['staging_s']:.3f})")
    k1 = want["counts"][0]
    print(f"[mesh_train] {label} on a {shape} mesh: worst rel err loss "
          f"{errs['loss']:.3e} (limit {lim['loss']:g}), grad_norm "
          f"{errs['grad_norm']:.3e} (limit {lim['grad_norm']:g}) over every "
          f"rank and step; kernel launches a step on every rank (forward, "
          f"backward) {k1['launches']}, K1 by variant "
          f"{k1['k1_by_variant']} / {k1['k1_bwd_by_variant']}, K2 by plan "
          f"{k1['k2_by_plan']} / route {k1['k2_bwd_by_route']}, K3 by mode "
          f"{k1['k3_by_mode']}; {r0['params_gb']:.2f} GB of params a rank "
          f"| {card}")
    expect = expected_counts(kernels, kernel_ops())
    check(k1 == expect, f"{label}: kernel counts a step {k1}, expected "
                        f"{expect}")
    return _sum_counts(counts), errs


def phase_mesh_train(card):
    """Path j (MESH_TRAIN): the one-device runs of MESH_TRAIN's and
    MESH_TRAIN_NCCL's cuts on the card, freed, then the four gloo ranks
    (faults, then the steps), then MESH_TRAIN_NCCL on a one-rank NCCL
    mesh; each held step by step to its one-device run.  Returns each
    mesh run's kernel counts."""
    t_phase = time.perf_counter()
    want = mesh_train_reference(MESH_TRAIN)
    want_nccl = mesh_train_reference(MESH_TRAIN_NCCL)
    cfg, shape = mesh_train_config(MESH_TRAIN)
    print(f"[mesh_train] path j: {cfg.name} cut to {cfg.n_layers} layers "
          f"({cfg.param_counts()['total'] / 1e9:.3f} B params), "
          f"{shape['batch']} x {shape['seq']} tokens a step in "
          f"{shape['microbatches']} microbatches; one device: losses "
          f"{want['loss']}, grad_norms {want['grad_norm']}, "
          f"{[round(t, 1) for t in want['step_ms']]} ms a step, peak "
          f"{want['peak_gb']:.2f} GB | {card}")
    outs = run_mesh_ranks(MESH_SHAPE, "gloo", [("path_j", MESH_TRAIN, True)],
                          runner="_mesh_train_path")
    counts, errs = _mesh_train_check("gloo", outs, want, MESH_SHAPE, card,
                                     "path_j", MESH_TRAIN["kernels"])
    faults = {}
    for name in MESH_TRAIN_FAULTS:
        faults[name] = max(_rel(outs[c]["path_j"]["faults"][name],
                                want["grad_norm"][0]) for c in outs)
    listed = ", ".join(f"{k} {e:.3e}" for k, e in faults.items())
    print(f"[mesh_train] faults on rank (0, 1), worst rank's grad_norm rel "
          f"err at step 1: {listed} (limit "
          f"{MESH_TRAIN_LIMIT['grad_norm']:g})")
    for name, e in faults.items():
        check(e > 5 * MESH_TRAIN_LIMIT["grad_norm"],
              f"mesh_train: {name} gives only {e:.3e}: the check cannot "
              f"see it")
    outs1 = run_mesh_ranks((1, 1), "nccl",
                           [("path_j", MESH_TRAIN_NCCL, False)],
                           runner="_mesh_train_path")
    check(outs1[(0, 0)]["backend"] == "nccl" and not outs1[(0, 0)]["staged"],
          f"the one-rank mesh ran {outs1[(0, 0)]['backend']}")
    counts1, errs1 = _mesh_train_check("nccl", outs1, want_nccl, (1, 1),
                                       card, "path_j",
                                       MESH_TRAIN_NCCL["kernels"])
    steps = outs[(0, 0)]["path_j"]["steps"]
    result = {"arch": cfg.name, "layers": cfg.n_layers,
              "params_b": cfg.param_counts()["total"] / 1e9, **shape,
              "one_device": {k: want[k] for k in ("loss", "grad_norm",
                                                  "step_ms", "peak_gb")},
              "mesh_loss_rank0": [st["loss"] for st in steps],
              "mesh_grad_norm_rank0": [st["grad_norm"] for st in steps],
              "worst_rel_err": errs, "faults": faults,
              "step_ms_rank0": [st["step_ms"] for st in steps],
              "peak_gb_by_rank": {str(c): max(st["peak_gb"] for st in
                                              outs[c]["path_j"]["steps"])
                                  for c in outs},
              "bytes_a_step_rank0": steps[-1]["bytes"],
              "calls_a_step_rank0": steps[-1]["calls"],
              "seconds_a_step_rank0": steps[-1]["seconds"],
              "staging_s_a_step_rank0": steps[-1]["staging_s"],
              "nccl": {"worst_rel_err": errs1, "step_ms": [
                  st["step_ms"] for st in outs1[(0, 0)]["path_j"]["steps"]]},
              "card": card}
    print("mesh_train " + json.dumps(result))
    print(f"[mesh_train] phase {time.perf_counter() - t_phase:.1f} s | "
          f"{card}")
    return {f"{cfg.name} (mesh train {MESH_SHAPE[0]}x{MESH_SHAPE[1]} gloo, "
            f"{cfg.n_layers} layers)": counts,
            f"{cfg.name} (mesh train 1x1 nccl, "
            f"{MESH_TRAIN_NCCL['cut']['n_layers']} layers)": counts1}


# ------------------------------------------------------------- mesh ssm

# Phase mesh_ssm: RWKVLM and JambaLM on MESH_SHAPE's ("data", "model")
# gloo mesh of four ranks sharing card 0, as phase mesh has them, every
# width as published.  Path k: rwkv6-1.6b at full depth (24 layers, 1.60 B
# params; 16 of its 32 heads a `model` rank, K2 on them); path l: Jamba's
# 2-layer MoE cut (DECODE_CUTS: layers 4-5 of a period, attention + MLP,
# then Mamba + MoE with all 16 experts, 8 a `model` rank; 11.9 B params;
# 8192 of its 16384 Mamba channels a rank, K3 on them), at the published
# capacity factor.  Path a's traffic as phase mesh serves it, the knobs of
# optimized_overrides(arch, "decode_32k"); each logits row, and Jamba's
# Mamba state after the forced steps, within MESH_ROW_LIMIT of the same
# model's one-device run on the card.  Path k serves in f32: rwkv6-1.6b's
# forward at random init amplifies rounding about 1.15x a layer, so one
# device's bf16 rows are 0.24-0.38 of their scale from its own f32 rows at
# 24 layers (PERF.md §6), and two bf16 runs that round in other places
# (the mesh's partial sums) cannot agree within the limit; K2 takes the
# same plan in f32.  Path k-bf16 holds the published dtype on the mesh at
# 2 layers, where one device's bf16 rows are 1.4-1.7e-2 of their scale
# from its f32 rows.  A fault must take its rows or the state past twice
# the limit: at init Jamba's Mamba output is small beside the residual,
# so x_proj's psum left out on one rank moves path l's rows by about 0.1
# of their scale, and its Mamba state by O(1).
F32 = {"dtype": "float32"}
MESH_SSM_SERVE = {
    "path_k": dict(arch="rwkv6-1.6b", cut=F32, per_wave={"wkv6": 24}),
    "path_k_bf16": dict(arch="rwkv6-1.6b", cut=dict(n_layers=2),
                        per_wave={"wkv6": 2}),
    "path_l": dict(arch=JAMBA, cut=DECODE_CUTS[JAMBA],
                   per_wave={"flash_attention": 1, "selective_scan": 1}),
}
# the paths that also run the faults
MESH_SSM_FAULTS = ("path_k", "path_l")
# Paths m and n: training on the same mesh (FSDP over `data`, TP over
# `model`), as path j: MESH_SSM_TRAIN_SHAPE's steps of the synthetic
# stream (seed 1) in 2 microbatches with grad_specs, f32 accumulators,
# AdamW with f32 moments under the reference cell's cosine schedule.
# Path m: rwkv6-1.6b cut to 4 of its 24 layers (0.49 B params); path n:
# Jamba's 2-layer dense cut (TRAIN_PATHS: attention + MLP, then Mamba +
# MLP; 2.845 B).  Each step's loss and grad_norm on every rank within
# MESH_TRAIN_LIMIT of the one-device run's; kernel launches a step on
# every rank, (forward, backward): K2 16 and 8 backward calls (16
# launches, "hopper"); K1 4 and 2 calls (6 launches), K3 4 in training
# mode and 2 calls (4 launches).  Then path m at 2 layers on a one-rank
# NCCL mesh, its losses and norms bit for bit with one device's.  Path m
# trains in f32: rwkv6-1.6b's bf16 gradients at init are dominated by
# their roundings (14.5x their f32 norm, PERF.md §7), so two bf16 runs
# that round in other places (the mesh's partial sums) cannot agree on
# grad_norm; K2 takes the same plan and backward route in f32.  It takes
# 4 layers, not 8: at 8 layers on this stream even f32's gradient is
# chaotic at init (one device's own grad_norm moves 13% when its batch is
# cut into 2 microbatches instead of 1; at 4 layers 3.6e-6; PERF.md §6).
MESH_SSM_TRAIN_SHAPE = dict(batch=4, seq=2048, microbatches=2)
MESH_SSM_TRAIN = {
    "path_m": dict(arch="rwkv6-1.6b", cut=dict(n_layers=4), replace=F32,
                   shape=MESH_SSM_TRAIN_SHAPE, steps=2,
                   kernels={"wkv6": (16, 16)}),
    "path_n": dict(arch=JAMBA, cut=DECODE_CUTS[JAMBA], moe_offset=2,
                   shape=MESH_SSM_TRAIN_SHAPE, steps=2,
                   kernels={"flash_attention": (4, 6),
                            "selective_scan": (4, 4)}),
}
MESH_SSM_NCCL = dict(MESH_SSM_TRAIN["path_m"], cut=dict(n_layers=2),
                     kernels={"wkv6": (8, 8)})


def phase_mesh_ssm(card):
    """Paths k-n: serving (``mesh_ssm_serve``), then training
    (``mesh_ssm_train``).  Prints both halves' results and the phase's
    wall time; returns each mesh run's kernel counts, summed over its
    ranks, by label."""
    t_phase = time.perf_counter()
    results, runs = mesh_ssm_serve(card)
    more, more_runs = mesh_ssm_train(card)
    results.update(more)
    runs.update(more_runs)
    wall = time.perf_counter() - t_phase
    results["phase_s"] = wall
    print("mesh_ssm " + json.dumps(results))
    print(f"[mesh_ssm] phase {wall:.1f} s | {card}")
    return runs


def mesh_ssm_serve(card):
    """Paths k, k-bf16 and l: the one-device runs on the card (freed),
    then the four gloo ranks, the four faults on rank (0, 1) shown to
    fail the limit.  Returns (results, kernel counts by label)."""
    wants = {label: mesh_reference(spec["arch"], spec["cut"])
             for label, spec in MESH_SSM_SERVE.items()}
    outs = run_mesh_ranks(MESH_SHAPE, "gloo",
                          [(label, spec, label in MESH_SSM_FAULTS)
                           for label, spec in MESH_SSM_SERVE.items()])
    results, runs = {}, {}
    for label, want in wants.items():
        spec = MESH_SSM_SERVE[label]
        results[label] = _mesh_check(label, spec, outs, want, MESH_SHAPE,
                                     "gloo", card)
        runs[f"{spec['arch']} ({label}, mesh {MESH_SHAPE[0]}x"
             f"{MESH_SHAPE[1]} gloo)"] = \
            _sum_counts(outs[c][label]["counts"] for c in outs)
    return results, runs


def mesh_ssm_train(card):
    """Paths m and n: the one-device runs on the card (freed), the four
    gloo ranks, then path m at 2 layers on a one-rank NCCL mesh, bit for
    bit with one device.  Returns (results, kernel counts by label)."""
    train_wants = {name: mesh_train_reference(spec)
                   for name, spec in MESH_SSM_TRAIN.items()}
    want_nccl = mesh_train_reference(MESH_SSM_NCCL)
    for name, spec in MESH_SSM_TRAIN.items():
        cfg = mesh_train_config(spec)[0]
        w = train_wants[name]
        print(f"[mesh_ssm] {name}: {cfg.name} cut to {cfg.n_layers} layers "
              f"in {cfg.dtype} ({w['params_b']:.3f} B params), "
              f"{MESH_SSM_TRAIN_SHAPE}; one device: losses {w['loss']}, "
              f"grad_norms {w['grad_norm']}, "
              f"{[round(t, 1) for t in w['step_ms']]} ms a step, peak "
              f"{w['peak_gb']:.2f} GB | {card}")
    outs = run_mesh_ranks(MESH_SHAPE, "gloo",
                          [(name, spec, False)
                           for name, spec in MESH_SSM_TRAIN.items()],
                          runner="_mesh_train_path")
    results, runs = {}, {}
    for name, spec in MESH_SSM_TRAIN.items():
        counts, errs = _mesh_train_check(f"{name} gloo", outs,
                                         train_wants[name], MESH_SHAPE,
                                         card, path=name,
                                         kernels=spec["kernels"])
        steps = outs[(0, 0)][name]["steps"]
        results[name] = {
            "arch": spec["arch"], "cut": spec["cut"],
            "worst_rel_err": errs,
            "one_device": {k: train_wants[name][k] for k in
                           ("loss", "grad_norm", "step_ms", "peak_gb")},
            "step_ms_rank0": [st["step_ms"] for st in steps],
            "peak_gb_by_rank": {str(c): max(st["peak_gb"] for st in
                                            outs[c][name]["steps"])
                                for c in outs},
            "bytes_a_step_rank0": steps[-1]["bytes"],
            "calls_a_step_rank0": steps[-1]["calls"]}
        runs[f"{spec['arch']} (mesh train {MESH_SHAPE[0]}x{MESH_SHAPE[1]} "
             f"gloo, {spec['cut']['n_layers']} layers)"] = counts
    outs1 = run_mesh_ranks((1, 1), "nccl", [("path_m", MESH_SSM_NCCL, False)],
                           runner="_mesh_train_path")
    check(outs1[(0, 0)]["backend"] == "nccl" and not outs1[(0, 0)]["staged"],
          f"the one-rank mesh ran {outs1[(0, 0)]['backend']}")
    counts1, _ = _mesh_train_check("path_m nccl", outs1, want_nccl, (1, 1),
                                   card, path="path_m",
                                   kernels=MESH_SSM_NCCL["kernels"])
    got = outs1[(0, 0)]["path_m"]["steps"]
    same = all(st["loss"] == want_nccl["loss"][i]
               and st["grad_norm"] == want_nccl["grad_norm"][i]
               for i, st in enumerate(got))
    print(f"[mesh_ssm] path_m at {MESH_SSM_NCCL['cut']['n_layers']} layers "
          f"on a one-rank NCCL mesh: losses and grad_norms bit for bit with "
          f"one device: {same}")
    check(same, "mesh_ssm: the one-rank NCCL mesh's losses or norms differ "
                "from one device's")
    runs[f"rwkv6-1.6b (mesh train 1x1 nccl, "
         f"{MESH_SSM_NCCL['cut']['n_layers']} layers)"] = counts1
    results["path_m nccl"] = {"bit_for_bit": same, "step_ms": [
        st["step_ms"] for st in got]}
    return results, runs


# ------------------------------------------- mesh Whisper, int8 moments

# Phase mesh_wq: WhisperLM and AdamW's int8 moments on MESH_SHAPE's
# ("data", "model") gloo mesh of four ranks sharing card 0, in the
# reference's layout (whisper.py's docstring: every `model` rank runs K1
# on all 6 heads of its rows, the MLP split over `model`, the vocab of
# 51865 whole).  Path o: whisper-tiny as published, path g's 8 requests
# (seed 0, prompts of 4-224 tokens, 1500 frames each, N(0, 1) from a
# seed on the CPU) in 2 waves of 4 (2 rows a `data` rank), max_len 448
# (224 self-cache slots a `model` rank), 4 forced then greedy tokens to
# MESH_WHISPER_STEPS; each logits row of the prefill and the forced
# steps, and each batch row of the k, v, ck, cv caches gathered whole by
# cache_specs after them, within MESH_ROW_LIMIT of the one-device run on
# the card; two faults, the MLP's psum left out on rank (0, 1) and the
# self cache's slot block written and read at offset 0 on every rank,
# each past twice the limit; K1 12 launches a rank and wave (4 encoder at
# (2, 1500, 1500, 6, 64), 4 causal self-attention, 4 cross-attention at
# (2, <= 224, 1500)), all Hopper.
MESH_WHISPER_SERVE = dict(arch=WHISPER, cut={}, state="caches",
                          per_wave={"flash_attention": 12})
MESH_WHISPER_STEPS = 8
# Path p: whisper-tiny trained there (FSDP over `data`, the MLP over
# `model`): 2 steps of 16 x 448 tokens (the synthetic stream, seed 1)
# with 16 x 1500 frames (N(0, 1), seeded by the step), 2 microbatches,
# grad_specs, f32 accumulators and AdamW moments (36.4 M params, under
# the reference's 30 B threshold), the reference cell's cosine; each
# step's loss and grad_norm on every rank within MESH_TRAIN_LIMIT of one
# device.  K1 a rank and step: 20 forward launches a microbatch (4
# encoder, the decoder's 8 twice: its forward and recompute) and 12
# backward calls (36 launches), all "hopper".
MESH_WHISPER_TRAIN = dict(arch=WHISPER, cut={},
                          shape=dict(batch=16, seq=448, microbatches=2),
                          steps=2, kernels={"flash_attention": (40, 72)})
# Path q: mixtral-8x7b cut to 1 of its 32 layers at full width (8 experts
# of 4096 x 14336, 4 a `model` rank; 32 q / 8 kv heads of 128, window
# 4096; vocab 32000 untied; 1.71 B params) trained with the reference's
# setting for the 46.7 B model (QUANTIZED_OPT_THRESHOLD: int8 moments,
# shape-preserving blocks; bf16 accumulators), cosine, 2 steps of 4 x
# 2048 tokens in 2 microbatches with grad_specs; each step's loss and
# grad_norm within MESH_TRAIN_LIMIT of one device on the card.  The
# reference's MoE on a mesh takes its capacity from each `data` shard's
# tokens (ROADMAP Queue 3), so at the published capacity factor 1.25 a
# shard and one device drop other tokens (the first probe: grad_norm
# 8.7e-3 apart at step 1, before any update); path q runs at capacity
# factor 4 (= n_experts / top_k: every token's slot, no drop on either
# side), as the CPU tests hold MoE configs without drops.  Its
# lm_head (4096, 32000) holds 16000 columns a `model` rank, 62.5 of the
# reference's 125 blocks of 256: the unaligned case, whose block scales
# (m's and v's, gathered whole) are held to one device's after each step
# within MESH_QUANT_SCALE_LIMIT, and whose fault, each rank quantizing
# its 16000 columns on their own, must land past twice it.  K1 a rank
# and step: 4 forward launches at (1, 2048, 2048, 16, 128) and 2
# backward calls (6 launches).
MESH_QUANT_TRAIN = dict(arch=MIXTRAL, cut=dict(n_layers=1),
                        moe=dict(capacity_factor=4.0),
                        shape=dict(batch=4, seq=2048, microbatches=2),
                        steps=2, quantized=True, accum="bfloat16",
                        scales_of=("embed", "lm_head"),
                        kernels={"flash_attention": (4, 6)})
# Block scales of the bf16 moments on the mesh against one device's, each
# block's difference over the leaf's largest scale (as the CPU tests hold
# them): the gradient's entries differ by about a bf16 rounding of their
# partial sums (each `data` rank's rounded, then reduce-scattered in
# bf16), so the largest entries of m by about 4e-3 of their size and of
# v (their square) by 8e-3.  A block whose entries nearly cancel between
# the two `data` ranks' halves (an lm_head column no label hits: p_v
# times the sum of h over the tokens) may differ by more than its own
# size, and is small beside the leaf's largest (the first probe: 2.3
# times a block's own scale at step 1).  A block quantized on the wrong
# columns takes another set's largest entry: a label column's, or not.
MESH_QUANT_SCALE_LIMIT = 2e-2
MESH_QUANT_FAULT = "each rank's columns quantized on their own"


def whisper_waves(cfg):
    """Path g's 8 requests in waves of 4, each left-padded with token 0 to
    its longest, MESH_FORCED teacher-forced tokens a request, and 1500
    frames a request (N(0, 1) from seed SEED + 3 on the CPU): [(tokens,
    forced, frames)] on the CPU."""
    from repro_torch.configs.whisper_tiny import N_AUDIO_FRAMES
    spec = WHISPER_SERVE
    (lo, hi), n = spec["prompt"], spec["requests"]
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(lo, hi + 1)))
               for _ in range(n)]
    forced = np.random.default_rng(SEED + 29).integers(
        1, cfg.vocab_size, (n, MESH_FORCED))
    frames = torch.randn((n, N_AUDIO_FRAMES, cfg.d_model),
                         generator=torch.Generator().manual_seed(SEED + 3))
    waves = []
    for w0 in range(0, n, spec["batch"]):
        wave = prompts[w0:w0 + spec["batch"]]
        toks = np.zeros((len(wave), max(map(len, wave))), np.int64)
        for i, p in enumerate(wave):
            toks[i, toks.shape[1] - len(p):] = p
        waves.append((torch.from_numpy(toks),
                      torch.from_numpy(forced[w0:w0 + len(wave)]),
                      frames[w0:w0 + len(wave)]))
    return waves


def whisper_caches(model, cache, ctx=None):
    """Whisper's caches {k, v, ck, cv}, bf16 on the CPU, gathered whole by
    ``cache_specs`` on a mesh (every rank gathers; rank (0, 0) keeps
    them, the others return None)."""
    from repro_torch.distribution.sharding import unshard
    if ctx is not None:
        cache = unshard(cache, model.cache_specs(), ctx)
        if (ctx.comm.axis_index("data"), ctx.comm.axis_index("model")) \
                != (0, 0):
            return None
    return {k: v.cpu() for k, v in cache.items()}


def whisper_mesh_reference():
    """Path o's one-device run on the card from the weights the ranks
    draw: each wave's prefill and forced steps' logits rows, (waves, 4,
    1 + MESH_FORCED, V) f32 on the CPU, no routes, and each wave's caches
    after its forced steps."""
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build_model
    cfg = get_config(WHISPER)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    out, states = [], []
    with torch.inference_mode():
        for toks, forced, frames in whisper_waves(cfg):
            logits, cache, length = model.prefill(
                params, toks.cuda(), WHISPER_SERVE["max_len"],
                frames=frames.cuda())
            rows = [logits[:, 0].float().cpu()]
            for i in range(MESH_FORCED):
                logits, cache, length = model.decode(
                    params, cache, forced[:, i:i + 1].cuda(), length)
                rows.append(logits[:, 0].float().cpu())
            out.append(torch.stack(rows, dim=1))
            states.append(whisper_caches(model, cache))
            del cache
    del params
    free_device_memory(f"{WHISPER}'s one-device run")
    return torch.stack(out), [], states


def _mesh_whisper_path(ctx, label, spec, faults):
    """Path o on this rank: whisper-tiny's blocks (each rank in turn draws
    the model from seed 0 on the card and cuts them by the serving rules),
    a warm-up wave off the record, both waves with the counts and the
    collectives' bytes set to 0 before and read after, then with
    ``faults`` wave 0 again under each of them.  Returns what
    ``_mesh_check`` reads."""
    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.distribution.sharding import param_specs
    from repro_torch.models import attention as A
    from repro_torch.models import common as C
    from repro_torch.models.factory import build_model
    ops = kernel_ops()
    comm = ctx.comm
    coords = (comm.axis_index("data"), comm.axis_index("model"))
    cfg = get_config(spec["arch"]).replace(**spec["cut"])
    model = build_model(cfg, ctx)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in range(tdist.get_world_size()):
        if r == tdist.get_rank():
            full = build_model(cfg).init(
                torch.Generator(device="cuda").manual_seed(SEED), "cuda")
            params = _cut_freeing(full, param_specs(model, full), ctx)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        tdist.barrier()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params_gb = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) / 1e9
    waves = whisper_waves(cfg)
    kw = dict(max_len=WHISPER_SERVE["max_len"], state_fn=whisper_caches)
    with torch.inference_mode():
        toks, forced, frames = waves[0]
        _mesh_forward(model, params, ctx, toks[:, -8:], forced, 2,
                      frames=frames, **kw)
        reset_counts(ops)
        torch.cuda.reset_peak_memory_stats()
        logits, prefill_s, decode_s, moved, states = [], [], [], [], []
        for toks, forced, frames in waves:
            got = _mesh_forward(model, params, ctx, toks, forced,
                                MESH_WHISPER_STEPS, frames=frames, **kw)
            logits.append(got[0])
            prefill_s.append(got[1])
            decode_s += got[2]
            moved.append(got[3])
            states.append(got[4])
        counts = read_counts(ops)
        out = {"coords": coords, "logits": torch.stack(logits),
               "prefill_ms": [t * 1e3 for t in prefill_s],
               "decode_ms": float(np.median(decode_s)) * 1e3,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "init_peak_gb": init_peak_gb, "params_gb": params_gb,
               "init_s": init_s, "k1": counts["k1_by_variant"],
               "counts": counts, "moved": moved[-1], "routes": [],
               "states": states, "faults": {}}
        if faults:
            real_sum = C.row_sum

            def keep_own(y, rows, full_rows, dist):
                return (real_sum(y, rows, full_rows, dist), y)[1]

            runs = {"MLP psum left out": (
                        C, "row_sum", keep_own, coords == (0, 1)),
                    "self cache slots at offset 0": (
                        A.SlotCache, "_slot0", lambda self, S_l: 0, True)}
            toks, forced, frames = waves[0]
            for name, (obj, attr, fn, here) in runs.items():
                with contextlib.ExitStack() as stack:
                    if here:
                        stack.enter_context(_swapped(obj, attr, fn))
                    got = _mesh_forward(model, params, ctx, toks, forced,
                                        MESH_FORCED, frames=frames, **kw)
                out["faults"][name] = {"logits": got[0], "state": got[4]}
    del params
    return out


def phase_mesh_wq(card):
    """Paths o, p and q (MESH_WHISPER_SERVE, MESH_WHISPER_TRAIN,
    MESH_QUANT_TRAIN): the one-device runs on the card (freed), then the
    four gloo ranks for each, held as their comments say.  Prints each
    path's numbers and the phase's wall time; returns each mesh run's
    kernel counts, summed over its ranks, by label."""
    t_phase = time.perf_counter()
    results, runs = {}, {}
    want = whisper_mesh_reference()
    outs = run_mesh_ranks(MESH_SHAPE, "gloo",
                          [("path_o", MESH_WHISPER_SERVE, True)],
                          runner="_mesh_whisper_path")
    results["path_o"] = _mesh_check("path_o", MESH_WHISPER_SERVE, outs,
                                    want, MESH_SHAPE, "gloo", card)
    runs[f"{WHISPER} (path_o, mesh {MESH_SHAPE[0]}x{MESH_SHAPE[1]} "
         f"gloo)"] = _sum_counts(outs[c]["path_o"]["counts"] for c in outs)
    del outs, want
    for name, spec in (("path_p", MESH_WHISPER_TRAIN),
                       ("path_q", MESH_QUANT_TRAIN)):
        results[name], counts = mesh_wq_train(name, spec, card)
        runs[f"{spec['arch']} ({name}, mesh train {MESH_SHAPE[0]}x"
             f"{MESH_SHAPE[1]} gloo, {results[name]['layers']} "
             f"layers)"] = counts
    wall = time.perf_counter() - t_phase
    results["phase_s"] = wall
    print("mesh_wq " + json.dumps(results))
    print(f"[mesh_wq] phase {wall:.1f} s | {card}")
    return runs


def mesh_wq_train(name, spec, card):
    """Path p or q: the one-device run on the card (freed), then the four
    gloo ranks, each step held to it (``_mesh_train_check``; path q's
    block scales and its fault too).  Returns (results, the mesh run's
    kernel counts)."""
    from repro_torch.configs import get_config
    cfg, shape = mesh_train_config(spec)
    want = mesh_train_reference(spec)
    print(f"[mesh_wq] {name}: {cfg.name} cut to {cfg.n_layers} layers "
          f"of {get_config(spec['arch']).n_layers} in {cfg.dtype} "
          f"({want['params_b']:.3f} B params), {shape}, "
          f"{'int8' if spec.get('quantized') else 'f32'} moments, "
          f"{spec.get('accum', 'float32')} accumulators; one device: "
          f"losses {want['loss']}, grad_norms {want['grad_norm']}, "
          f"{[round(t, 1) for t in want['step_ms']]} ms a step, peak "
          f"{want['peak_gb']:.2f} GB | {card}")
    outs = run_mesh_ranks(MESH_SHAPE, "gloo", [(name, spec, False)],
                          runner="_mesh_train_path")
    counts, errs = _mesh_train_check(f"{name} gloo", outs, want,
                                     MESH_SHAPE, card, path=name,
                                     kernels=spec["kernels"])
    steps = outs[(0, 0)][name]["steps"]
    result = {
        "arch": spec["arch"], "layers": cfg.n_layers, **shape,
        "params_b": want["params_b"], "worst_rel_err": errs,
        "one_device": {k: want[k] for k in
                       ("loss", "grad_norm", "step_ms", "peak_gb")},
        "step_ms_rank0": [st["step_ms"] for st in steps],
        "peak_gb_by_rank": {str(c): max(st["peak_gb"] for st in
                                        outs[c][name]["steps"])
                            for c in outs},
        "bytes_a_step_rank0": steps[-1]["bytes"],
        "calls_a_step_rank0": steps[-1]["calls"],
        "seconds_a_step_rank0": steps[-1]["seconds"],
        "moment_gather_bytes_by_rank": {
            str(c): outs[c][name]["steps"][-1]["moment_gather_bytes"]
            for c in outs}}
    if "scales_of" in spec:
        result.update(_quant_scales_check(name, spec, outs, want, cfg,
                                          card))
    del outs, want
    free_device_memory(name)
    return result, counts


def _quant_scales_check(name, spec, outs, want, cfg, card):
    """Path q's block scales: each step's, gathered on the mesh, against
    one device's, block by block, each difference over the leaf's largest
    scale (the convention of ``tests/test_torch_mesh_quant.py``); the
    fault's (each rank's columns quantized on their own, step 1) against
    the reference's blocks its columns fall in, the same way.  Also
    prints each step's worst difference relative to its own block's
    scale.  Returns the worst errors."""
    steps = outs[(0, 0)][name]["steps"]
    errs, own = [], []
    for i, st in enumerate(steps):
        e, o = {}, {}
        for key, w in want["scales"][i].items():
            diff = (st["scales"][key] - w).abs()
            e[key] = (diff.max() / w.max()).item()
            o[key] = (diff / w).max().item()
        errs.append(e)
        own.append(o)
        check(all(math.isfinite(v) and v <= MESH_QUANT_SCALE_LIMIT
                  for v in e.values()),
              f"{name} step {i + 1}: block scales' worst err {e} of the "
              f"leaf's largest scale, past {MESH_QUANT_SCALE_LIMIT:g}")
    fault = outs[(0, 0)][name]["faults"][MESH_QUANT_FAULT]
    cols = cfg.vocab_size // MESH_SHAPE[1]          # a `model` rank's
    per_rank = -(-cols // 256)
    worst = {}
    for key, f in fault.items():
        ref = want["scales"][0][key]
        e = 0.0
        for r in range(MESH_SHAPE[1]):
            for b in range(per_rank):
                c0 = r * cols + 256 * b
                c1 = min(c0 + 256, (r + 1) * cols)
                got = f[:, r * per_rank + b]
                for j in range(c0 // 256, (c1 - 1) // 256 + 1):
                    e = max(e, (got - ref[:, j]).abs().max().item())
        worst[key] = e / ref.max().item()
    listed = "; ".join(", ".join(f"{k} {v:.3e}" for k, v in e.items())
                       for e in errs)
    listed_own = "; ".join(", ".join(f"{k} {v:.3e}" for k, v in o.items())
                           for o in own)
    gathered = [outs[c][name]["steps"][-1]["moment_gather_bytes"] / 1e9
                for c in sorted(outs)]
    print(f"[mesh_wq] {name}: {'/'.join(spec['scales_of'])}'s block scales "
          f"({tuple(want['scales'][0]['m'].shape)} blocks of 256) on the "
          f"mesh against one device, worst difference over the leaf's "
          f"largest scale a step: {listed} (limit "
          f"{MESH_QUANT_SCALE_LIMIT:g}); over the block's own scale: "
          f"{listed_own}; {MESH_QUANT_FAULT} at step 1: "
          f"{', '.join(f'{k} {v:.3e}' for k, v in worst.items())} (must "
          f"pass {2 * MESH_QUANT_SCALE_LIMIT:g}); the moments' gathers "
          f"brought {gathered} GB a rank in the last step | {card}")
    for key, e in worst.items():
        check(e > 2 * MESH_QUANT_SCALE_LIMIT,
              f"{name}: {MESH_QUANT_FAULT} gives only {e:.3e} on {key}: the "
              f"check cannot see it")
    return {"scale_err_by_step": errs, "scale_own_rel_err_by_step": own,
            "fault_scale_err": worst}


def phase_whisper_train(card):
    """whisper-tiny as published in bf16 from seed 0: WHISPER_TRAIN's
    steps through training.step.make_train_step with AdamW (weight decay
    0.01) and launch.train's cosine schedule, each batch the synthetic
    stream's tokens (seed 1) and frames from another seed, as the
    reference's train cell feeds them (its launch/train.py feeds no
    frames).  Every loss finite; counts set to 0 before each step and
    read after it: K1 ``whisper_k1_launches`` (forward, backward) a step,
    all "hopper"; no other kernel, no plain version; no stats kernel in
    the profiled step.  Returns the path's counts over its steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_tiny import N_AUDIO_FRAMES
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import schedule_for, to_device
    from repro_torch.models.factory import build_model
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.training.step import make_train_step
    ops = kernel_ops()
    shape = dict(WHISPER_TRAIN)
    b, seq, steps = shape["batch"], shape["seq"], shape["steps"]
    t_phase = time.perf_counter()
    cfg = get_config(WHISPER)
    model = build_model(cfg)
    opt = AdamW(schedule_for(cfg, steps), AdamWConfig(weight_decay=0.01))
    step_fn = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    opt_state = opt.init(params)
    data = SyntheticLMDataset(cfg.vocab_size, seq, b, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def batch_at(step):
        batch = to_device(data.batch_at(step), "cuda")
        batch["frames"] = torch.randn((b, N_AUDIO_FRAMES, cfg.d_model),
                                      generator=gen, device="cuda")
        return batch

    k1 = whisper_k1_launches(cfg)[1]
    want = expected_counts({"flash_attention": k1}, ops)
    print(f"[whisper_train] {WHISPER}: {cfg.n_enc_layers} + {cfg.n_layers} "
          f"layers, {b} x {seq} tokens and {b} x {N_AUDIO_FRAMES} frames a "
          f"step; K1 (forward launches, backward kernel launches) a step "
          f"expected {k1}")
    plain, undo = _count_plain_calls()
    records, per_step = [], []
    try:
        for step in range(steps):
            batch = batch_at(step)
            torch.cuda.synchronize()
            reset_counts(ops)
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])                # waits for the card
            dt = time.perf_counter() - t0
            per_step.append(read_counts(ops))
            records.append({"step": step + 1, "loss": loss,
                            "grad_norm": float(m["grad_norm"]),
                            "step_ms": dt * 1e3})
            print(f"[whisper_train] step {step + 1} loss {loss:.4f} lr "
                  f"{float(m['lr']):.2e} gnorm {float(m['grad_norm']):.3f} "
                  f"{dt * 1e3:.1f} ms")
    finally:
        undo()
    losses = [r["loss"] for r in records]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = float(np.median([r["step_ms"] for r in records[1:]]))
    tok_s = b * seq / step_ms * 1e3
    print(f"[whisper_train] losses {losses}; launches a step {per_step}; "
          f"plain versions called {plain}")
    print(f"[whisper_train] step time (median of steps 2-{steps}) "
          f"{step_ms:.1f} ms, {tok_s:.0f} tok/s, peak memory {peak_gb:.3f} "
          f"GB | {card}")
    check(len(records) == steps and all(map(math.isfinite, losses)),
          f"whisper_train: losses {losses}")
    check(all(p == want for p in per_step),
          f"whisper_train: launches a step {per_step}, expected {want}")
    check(not any(plain.values()), f"whisper_train: plain versions {plain}")
    kernels = profile_train_step({"step_fn": step_fn, "params": params,
                                  "opt_state": opt_state}, shape,
                                 batch_at(steps))
    check(kernels is None or "bwd_stats" not in kernels,
          f"whisper_train: a stats kernel ran: {kernels}")
    result = {"arch": WHISPER, **shape, "frames": N_AUDIO_FRAMES,
              "losses": losses, "step_ms": [r["step_ms"] for r in records],
              "step_ms_median": step_ms, "tok_s": tok_s,
              "peak_memory_gb": peak_gb, "card": card}
    print("whisper_train " + json.dumps(result))
    print(f"[whisper_train] phase {time.perf_counter() - t_phase:.1f} s")
    del params, opt_state
    return _sum_counts(per_step)


# ------------------------------------------------ K1's backward, training

# name, (b, sq, skv, h, hd[, dv]) (dv: v's, o's and dO's columns where
# fewer than hd), dtype, causal, window, softcap, q/k scale, layout, the
# route kernel_bwd.plan must pick and the forward variant kernel.plan must
# pick (hd 120 and MLA's (192, 128): the Hopper forward without an LSE,
# the general backward recomputing it; bf16 hd 256: the Hopper forward in
# training mode, the general backward reading its LSE); the first is the
# training shape (minicpm-2b, batch 4 x 2048)
BWD_CASES = [
    ("training", (4, 2048, 2048, 36, 64), torch.bfloat16, True, 0, 0.0,
     2.0, "plain", "hopper", "hopper"),
    ("hd128", (2, 1024, 1024, 32, 128), torch.bfloat16, True, 0, 0.0, 2.0,
     "plain", "hopper", "hopper"),
    ("hd120-window256", (2, 1024, 1024, 32, 120), torch.bfloat16, True, 256,
     0.0, 2.0, "plain", "general", "hopper"),
    # q, k ~ N(0, 36): scores of standard deviation 36 against the cap 50,
    # where tanh's derivative (1 - t^2) is far from 1
    ("softcap-50", (2, 512, 512, 8, 64), torch.bfloat16, True, 0, 50.0,
     6.0, "plain", "hopper", "hopper"),
    ("f32-hd64", (2, 512, 512, 8, 64), torch.float32, True, 0, 0.0, 2.0,
     "plain", "general", "general"),
    ("ragged-noncausal", (2, 300, 500, 4, 64), torch.bfloat16, False, 0,
     0.0, 2.0, "plain", "hopper", "hopper"),
    # (b, h, s, hd) storage seen as (b, s, h, hd): TMA reads it
    ("strided", (2, 700, 700, 8, 64), torch.bfloat16, True, 0, 0.0, 2.0,
     "strided", "hopper", "hopper"),
    # k and v one KV head seen as all 32 (stride 0 over heads): an
    # expanded GQA view, read with no copy (TMA takes the stride 0)
    ("gqa-view", (2, 1024, 1024, 32, 64), torch.bfloat16, True, 0, 0.0, 2.0,
     "gqa-view", "hopper", "hopper"),
    ("window256-softcap30", (2, 1024, 1024, 8, 64), torch.bfloat16, True,
     256, 30.0, 6.0, "plain", "hopper", "hopper"),
    ("noncausal-hd128", (2, 300, 500, 4, 128), torch.bfloat16, False, 0,
     0.0, 2.0, "plain", "hopper", "hopper"),
    # sq not a multiple of a tile: the last Q/dO boxes run past sq
    ("ragged-1000", (2, 1000, 1000, 8, 64), torch.bfloat16, True, 0, 0.0,
     2.0, "plain", "hopper", "hopper"),
    # whisper-tiny's training step (16 x 448 tokens, 1500 frames), neither
    # causal: the cross-attention (sq != skv) and the encoder
    ("whisper-cross", (16, 448, 1500, 6, 64), torch.bfloat16, False, 0,
     0.0, 2.0, "plain", "hopper", "hopper"),
    ("whisper-encoder", (16, 1500, 1500, 6, 64), torch.bfloat16, False, 0,
     0.0, 2.0, "plain", "hopper", "hopper"),
    # a rank's local heads on path j (mesh_train): (1, 4096, 16, 128)
    ("mesh-train-local-heads", (1, 4096, 4096, 16, 128), torch.bfloat16,
     True, 0, 0.0, 2.0, "plain", "hopper", "hopper"),
    # a rank's local heads on path q (phase mesh_wq): mixtral-8x7b's
    # (1, 2048, 16, 128), its window 4096 past the row
    ("mesh-mixtral-local-heads", (1, 2048, 2048, 16, 128), torch.bfloat16,
     True, 4096, 0.0, 2.0, "plain", "hopper", "hopper"),
    # gemma3-4b's training step (2 x 2048, 8 heads of 256): a local
    # layer's window 1024 and a global layer; the Hopper forward (its LSE)
    # and the general backward
    ("gemma-local-hd256", (2, 2048, 2048, 8, 256), torch.bfloat16, True,
     1024, 0.0, 2.0, "plain", "general", "hopper"),
    ("gemma-global-hd256", (2, 2048, 2048, 8, 256), torch.bfloat16, True, 0,
     0.0, 2.0, "plain", "general", "hopper"),
    # a prefill wave of DeepSeek-V3's MLA with v at its 128 columns, not
    # padded: the Hopper forward (MlaTile, no LSE), the general backward
    # (its stats kernel recomputes the LSE)
    ("mla-192-128", (4, 1024, 1024, 128, 192, 128), torch.bfloat16, True, 0,
     0.0, 2.0, "plain", "general", "hopper"),
    # hd 256 in f32 (32-row tiles), with a softcap, and k and v one KV head
    # seen as all 8 (stride 0 over heads)
    ("f32-hd256", (1, 300, 300, 2, 256), torch.float32, True, 0, 0.0, 2.0,
     "plain", "general", "general"),
    ("softcap-30-hd256", (2, 512, 512, 4, 256), torch.bfloat16, True, 0,
     30.0, 6.0, "plain", "general", "hopper"),
    ("gqa-view-hd256", (2, 1024, 1024, 8, 256), torch.bfloat16, True, 0,
     0.0, 2.0, "gqa-view", "general", "hopper"),
]
# the fault each case also shows the checks can see (checks.FAULTS)
BWD_FAULTS = {"training": ("no-delta", "skip-last-tile", "lse-neighbour-row",
                           "lse-log2", "stale-q-stage"),
              "softcap-50": ("no-softcap-derivative",),
              "hd120-window256": ("skip-first-tile",),
              # the general route reading the forward's LSE
              "gemma-global-hd256": ("dkdv-past-128-dropped",
                                     "lse-neighbour-row", "lse-log2")}
# the cases timed in turns (the training shape is the kernels line's)
TIMED_BWD_CASES = ("training", "hd128", "mesh-train-local-heads",
                   "mesh-mixtral-local-heads", "gemma-global-hd256",
                   "mla-192-128")
# A gradient row's error is measured against the row's scale
# (checks.bwd_row_scales: the norm of the sum of magnitudes that makes the
# row), held to ROW_TOL.  dS = P (dP - D) cancels as a row's softmax nears
# one key (the first causal row attends to one key and its dq is 0 in
# exact arithmetic), so there both sides carry rounding of the terms, not
# of the small sum; on a row without cancellation the scale is a few times
# the row's norm.  A fault (D dropped, a kv tile lost) moves rows by
# O(their scale) and still lands far past the limit.
# Each training path, in bf16 from seed 0: its batch and steps, the
# kernels its layers call and each one's launches in a step, (forward,
# backward): the forward kernel twice a layer that calls it (the forward
# and its recompute under activation checkpointing), the backward once,
# which launches its kernels (K1: kernel_bwd.KERNELS["hopper"],
# preprocess, dK/dV, dQ; K2: kernel_bwd.KERNELS, bwd and dv; K3:
# kernel_bwd.KERNELS, bwd and sum, from the checkpoints of K3's forward
# in training mode); the cut of the published
# config where it does not fit whole (every width as published), and the
# MoE layer offset it takes (none of Jamba's dense cut's 2 layers is MoE)
TRAIN_PATHS = {
    "minicpm-2b": dict(batch=4, seq=2048, steps=6,
                       kernels={"flash_attention": (80, 120)}),
    "rwkv6-1.6b": dict(batch=4, seq=2048, steps=6,
                       kernels={"wkv6": (48, 48)}),
    JAMBA: dict(batch=4, seq=2048, steps=6,
                cut=dict(n_layers=2, attn_layer_period=2,
                         attn_layer_offset=0), moe_offset=2,
                kernels={"flash_attention": (2, 3),
                         "selective_scan": (2, 2)}),
    # full width and depth (3.88 B params); 2 x 2048, since 4 x 2048 with
    # its 262144-wide logits would pass the card; K1 on "general"
    GEMMA: dict(batch=2, seq=2048, steps=4,
                kernels={"flash_attention": (68, 102)}),
}
# The MoE cut's gradient (phase jamba_moe_grad): DECODE_CUTS[JAMBA]
# (attention + MLP, then Mamba + MoE with all 16 experts) in bf16, one
# sequence of this many tokens, no optimizer
MOE_GRAD_SEQ = 2048
# the remat check's model, its cut (every width as published) and batch
REMAT_ARCH = "minicpm-2b"
REMAT_CUT = dict(n_layers=2)
REMAT_SHAPE = dict(batch=2, seq=1024)
RESTART = dict(steps=40, preempt_at=20, ckpt_every=10)
# kernel-name fragments of the groups a profiled step's time is summed in
K1_KERNEL_PARTS = ("flash_fwd", "bwd_preprocess", "bwd_stats", "bwd_dkdv",
                   "bwd_dq")
KERNEL_GROUPS = (
    ("K1", K1_KERNEL_PARTS),
    ("K2", ("wkv6_kernel", "wkv6_bwd_kernel", "wkv6_bwd_hopper_kernel")),
    ("K3", ("scan_pipe_kernel", "scan_bwd")),
    ("GEMM", ("nvjet", "gemm", "cutlass", "cublas", "sm90_xmma")),
    ("reductions", ("reduce_kernel", "softmax", "LogSumExp", "cunn_")),
    ("copies and casts", ("copy_kernel", "CatArrayBatchedCopy")),
    ("elementwise", ("elementwise",)),
)


def _bwd_inputs(shape, dtype, qk_scale, layout, gen):
    """q, k, v, dO for a backward case, on the card in ``dtype``."""
    b, sq, skv, h, hd, dv = flash_dims(shape)

    def randn(s, scale, heads=h, d=hd):
        if layout == "strided":       # (b, h, s, d) storage
            x = torch.randn((b, heads, s, d), generator=gen, device="cuda")
            x = x.transpose(1, 2)
        else:
            x = torch.randn((b, s, heads, d), generator=gen, device="cuda")
        return (x * scale).to(dtype)

    q, do = randn(sq, qk_scale), randn(sq, 1.0, d=dv)
    if layout == "gqa-view":
        k = randn(skv, qk_scale, 1).expand(b, skv, h, hd)
        v = randn(skv, 1.0, 1, dv).expand(b, skv, h, dv)
    else:
        k, v = randn(skv, qk_scale), randn(skv, 1.0, d=dv)
    return q, k, v, do


def bwd_bound(shape, dtype, causal, window):
    """Least time for the backward: its bytes (q, k, v, o, dO read once;
    dq, dk, dv written once) over HBM bandwidth, or the 5 products per
    unmasked (query, key) pair (S, dQ, dK of 2 hd FLOPs; dP, dV of 2 dv)
    over the dtype's peak, whichever is larger.  Returns (ms, "bytes" |
    "operations", pairs)."""
    b, sq, skv, h, hd, dv = flash_dims(shape)
    size = torch.finfo(dtype).bits // 8
    nbytes = (b * sq + b * skv) * h * (2 * hd + 2 * dv) * size
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= i - j < window
    pairs = int(mask.sum()) * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (6 * hd + 4 * dv) * pairs / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", pairs)


def phase_flash_bwd():
    """K1's backward, each case: the gradients of the training path's
    entry (torch.autograd.grad through ops.flash_attention, whose
    backward launches the kernels of the route kernel_bwd.plan picks)
    against attention_bwd_ref on f32 copies, row by row, two calls bit
    for bit, the route checked; faults that must land past the limits;
    at ``TIMED_BWD_CASES`` the kernels called directly for the timings.
    Returns the kernels-line entry (the training shape's numbers)."""
    from repro_torch.kernels.flash_attention import checks
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import kernel_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    entry, timed = None, {}
    for (name, shape, dtype, causal, window, softcap, qk_scale,
         layout, route, forward) in BWD_CASES:
        q, k, v, do = _bwd_inputs(shape, dtype, qk_scale, layout, gen)
        kw = dict(causal=causal, window=window, softcap=softcap)
        before = dict(flash_ops.launches_bwd_by_variant)
        before_fwd = dict(flash_ops.launches_by_variant)
        before_lse = dict(flash_ops.bwd_calls_by_lse)
        o, got = _flash_grads(flash_ops, q, k, v, do, kw)
        again = _flash_grads(flash_ops, q, k, v, do, kw)[1]
        torch.cuda.synchronize()
        took = {vt: n - before[vt]
                for vt, n in flash_ops.launches_bwd_by_variant.items()}
        want = {vt: 2 * len(kernel_bwd.KERNELS[vt]) if vt == route else 0
                for vt in kernel_bwd.VARIANTS}
        check(took == want, f"flash_bwd {name}: kernel launches by route "
                            f"{took}, expected {want}")
        took = {vt: n - before_fwd[vt]
                for vt, n in flash_ops.launches_by_variant.items()}
        want = {vt: 2 if vt == forward else 0 for vt in took}
        check(took == want, f"flash_bwd {name}: forward launches by variant "
                            f"{took}, expected {want}")
        # where the forward writes an LSE (every Hopper route, and hd 256
        # in bf16), each backward call reads it
        lse_from = ("forward" if flash_kernel.writes_lse(q, k, v)
                    else "recomputed")
        took = {u: n - before_lse[u]
                for u, n in flash_ops.bwd_calls_by_lse.items()}
        want = {u: 2 if u == lse_from else 0 for u in took}
        check(took == want, f"flash_bwd {name}: backward calls by the LSE's "
                            f"source {took}, expected {want}")
        with torch.no_grad():
            f32 = [t.float() for t in (q, k, v, o, do)]
            ref = attention_bwd_ref(*f32, **kw)
            scales = checks.bwd_row_scales(*f32, **kw)
        rtol = ROW_TOL[dtype]
        errs = {g: checks.grad_row_err(a, r, m) for g, a, r, m in
                zip(("dq", "dk", "dv"), got, ref, scales)}
        raw = max(row_err(a, r) for a, r in zip(got, ref))
        max_abs = max((a.float() - r).abs().max().item()
                      for a, r in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"[flash_bwd] {name} {tuple(shape)} {str(dtype)[6:]} "
              f"causal={causal} window={window} softcap={softcap} "
              f"{layout}, forward {forward}, route {route}, LSE "
              f"{lse_from}: worst row rel "
              f"err {', '.join(f'{g} {e:.3e}' for g, e in errs.items())} "
              f"(limit {rtol:g}, against each row's scale; against its norm "
              f"{raw:.3e}), max_abs_err {max_abs:.3e}; two calls "
              f"{'bit-identical' if same else 'DIFFER'}")
        check(all(math.isfinite(e) and e <= rtol for e in errs.values()),
              f"flash_bwd {name}: worst rows {errs} past {rtol:g}")
        check(same, f"flash_bwd {name}: two calls differ")
        for fault in BWD_FAULTS.get(name, ()):
            with torch.no_grad():
                bad = checks.attention_bwd_faulty(*f32, fault, **kw)
            worst = max(checks.grad_row_err(a, r, m)
                        for a, r, m in zip(bad, ref, scales))
            del bad
            print(f"[flash_bwd] {name}: a backward with {fault} gives worst "
                  f"row rel err {worst:.3e} (limit {rtol:g})")
            check(worst > 10 * rtol, f"flash_bwd {name}: {fault} gives only "
                                     f"{worst:.3e}: the check cannot see it")
        del f32, ref, scales
        torch.cuda.empty_cache()
        if name in TIMED_BWD_CASES:
            timing = (_time_flash_bwd if route == "hopper"
                      else _time_flash_bwd_general)
            timed[name] = {"route": route, "max_abs_err": max_abs,
                           **timing(kernel_bwd, attention_bwd_ref, q, k, v,
                                    o, do, shape, dtype, kw, name)}
        if name == "training":
            entry = {
                "name": "flash_attention_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention_bwd.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
                "gradient_of": "src/repro/models/attention.py:81",
                "launches": None, "calls": None,
                "kernels_per_call": {vt: len(ks) for vt, ks in
                                     kernel_bwd.KERNELS.items()},
                **timed[name]}
        del q, k, v, do, o, got, again
        torch.cuda.empty_cache()
    check(entry is not None and set(timed) == set(TIMED_BWD_CASES),
          "flash_bwd: a timed case did not run")
    for name, numbers in timed.items():
        if name != "training":
            entry[name.replace("-", "_")] = numbers
    return entry


def _flash_grads(flash_ops, q, k, v, do, kw):
    """(o, (dq, dk, dv)) through ops.flash_attention and autograd, as the
    training path takes them: the forward kernel, then the backward
    kernels through ``_FlashAttention``.  Each input keeps its strides (an
    expanded view its stride-0 heads)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = flash_ops.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(o, (q, k, v), do)
    return o.detach(), grads


def _time_flash_bwd(kernel_bwd, attention_bwd_ref, q, k, v, o, do, shape,
                    dtype, kw, name):
    """In turns, through the kernel modules (no launch counted; the
    backward's arguments prepared once, so no host time between its
    launches): the Hopper backward and the general one, whole (hopper,
    general, general, hopper), each Hopper kernel alone (twice), K1's forward
    without and with the LSE (without, with, with, without), SDPA's
    backward through autograd (forward + backward, minus the forward),
    and the plain version; beside the bound and the Hopper design's
    floor.  Returns the kernels-line numbers (``ms`` is the Hopper call's,
    the one the training path takes)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    lse = flash_kernel.lse_buffer(q)
    with torch.no_grad():
        flash_kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse, **kw)

        def call(variant, kernels=None):
            return kernel_bwd.launcher(
                q, k, v, o, do, variant, kernels=kernels,
                lse=lse if variant == "hopper" else None, **kw)[0]

        call("hopper", ("preprocess",))()   # D for dK/dV and dQ alone
        turns = [(vt, time_ms(call(vt)))
                 for vt in ("hopper", "general", "general", "hopper")]
        kernel_turns = [(kn, time_ms(call("hopper", (kn,))))
                        for _ in range(2)
                        for kn in kernel_bwd.KERNELS["hopper"]]
        fwd_turns = [(with_lse, time_ms(lambda: flash_kernel
                                        .flash_attention_cuda(
                                            q, k, v, "hopper",
                                            lse=lse if with_lse else None,
                                            **kw)))
                     for with_lse in (False, True, True, False)]
        plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, do, **kw),
                           iters=2, warmup=1)
    fwd, fwd_bwd, _ = _sdpa_grad(q, k, v, do, kw, name)
    sdpa = [time_ms(fwd), time_ms(fwd_bwd), time_ms(fwd_bwd), time_ms(fwd)]
    sdpa_fwd_ms = (sdpa[0] + sdpa[3]) / 2
    library_ms = (sdpa[1] + sdpa[2]) / 2 - sdpa_fwd_ms
    ms_by_variant = {u: float(np.mean([t for w, t in turns if w == u]))
                     for u in kernel_bwd.VARIANTS}
    kernel_ms = {u: float(np.mean([t for w, t in kernel_turns if w == u]))
                 for u in kernel_bwd.KERNELS["hopper"]}
    fwd_ms = {("with_lse" if u else "without_lse"):
              float(np.mean([t for w, t in fwd_turns if w == u]))
              for u in (False, True)}
    ms = ms_by_variant["hopper"]
    bound_ms, bound_by, pairs = bwd_bound(shape, dtype, kw["causal"],
                                          kw["window"])
    hd = shape[4]
    floor_ms = 14 * hd * pairs / PEAK_FLOPS[dtype] * 1e3
    print(f"[flash_bwd] {name}: in turns "
          f"{', '.join(f'{u} {t:.4f}' for u, t in turns)} ms; hopper "
          f"kernels alone {', '.join(f'{u} {t:.4f}' for u, t in kernel_turns)}"
          f" ms; forward without / with LSE "
          f"{', '.join(f'{t:.4f}' for _, t in fwd_turns)} ms; plain "
          f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms (forward "
          f"{sdpa_fwd_ms:.4f}, forward + backward {sdpa[1]:.4f}, "
          f"{sdpa[2]:.4f}); bound {bound_ms:.4f} ms ({bound_by}; {pairs} "
          f"unmasked pairs, {10 * hd * pairs / 1e9:.1f} GFLOP), the hopper "
          f"design's floor {floor_ms:.4f} ms ({14 * hd * pairs / 1e9:.1f} "
          f"GFLOP); hopper / bound {ms / bound_ms:.2f}, hopper / sdpa "
          f"{ms / library_ms:.2f}, general / hopper "
          f"{ms_by_variant['general'] / ms:.2f}, "
          f"{14 * hd * pairs / ms / 1e9:.1f} TFLOP/s of its 7 products")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "floor_ms": floor_ms, "ms_by_variant": ms_by_variant,
            "ms_turns": turns, "kernel_ms": kernel_ms,
            "forward_ms": fwd_ms, "sdpa_forward_ms": sdpa_fwd_ms}


def _sdpa_grad(q, k, v, do, kw, name):
    """SDPA's forward, and its forward and backward through autograd, on
    (b, h, s, d) copies of q, k, v that record a gradient (``sdpa_mask``'s
    mask; v at its own columns, or zero-padded to hd where SDPA refuses
    that), for timing its backward as their difference.  Returns (fwd,
    fwd_bwd, how v went in)."""
    import torch.nn.functional as F
    hd, dv = q.shape[3], v.shape[3]
    mask = sdpa_mask(q, k.shape[1], kw)
    qt, kt, vt_ = (t.transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt_, **mask)

    how = "as is"
    try:
        with torch.no_grad():
            fwd()
        torch.cuda.synchronize()
    except RuntimeError as e:
        how = f"zero-padded to {hd}"
        print(f"[flash_bwd] {name}: SDPA refuses v at {dv} columns beside "
              f"q and k at {hd}: {e}")
        vt_ = F.pad(v, (0, hd - dv)).transpose(1, 2).detach()
        vt_.requires_grad_()
        dot = F.pad(do, (0, hd - dv)).transpose(1, 2)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt_), dot)

    return fwd, fwd_bwd, how


def _time_flash_bwd_general(kernel_bwd, attention_bwd_ref, q, k, v, o, do,
                            shape, dtype, kw, name):
    """The general backward, through the kernel module (no launch
    counted; its arguments prepared once) as the training path calls it,
    reading the forward's LSE where the forward writes one (hd 256): the
    whole call in turns with SDPA's backward through autograd (general,
    sdpa, sdpa, general; SDPA's forward timed around them and taken off;
    v at its own columns, or zero-padded to hd where SDPA refuses that; a
    boolean band mask where a window bites), its kernels (stats alone,
    then stats with dK/dV and with dQ, each less stats), the forward on
    the variant kernel.plan picks, and the plain version; where the
    forward writes an LSE, also the call and its stats kernel recomputing
    it (with, without, without, with) and the forward without and with
    it; beside the bound and the design's floor (its products: S three
    times, twice with the forward's LSE, dP twice, each twice in dK/dV
    and dQ above hd 128 in bf16).  Returns the kernels-line numbers
    (``ms`` is the general call's as the training path takes it)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    hd, dv = flash_dims(shape)[4:]
    variant = flash_kernel.plan(q, k, v)
    lse = None
    if flash_kernel.writes_lse(q, k, v):
        lse = flash_kernel.lse_buffer(q)
        with torch.no_grad():
            flash_kernel.flash_attention_cuda(q, k, v, variant, lse=lse, **kw)

    def call(kernels=None, with_lse=True):
        return kernel_bwd.launcher(q, k, v, o, do, "general",
                                   kernels=kernels,
                                   lse=lse if with_lse else None, **kw)[0]

    fwd, fwd_bwd, sdpa_v = _sdpa_grad(q, k, v, do, kw, name)
    # q, k, v, o and dO need no gradient: only SDPA's copies record one
    whole = call()
    turns, sdpa = [("general", time_ms(whole))], [time_ms(fwd)]
    sdpa += [time_ms(fwd_bwd), time_ms(fwd_bwd)]
    sdpa.append(time_ms(fwd))
    turns.append(("general", time_ms(whole)))
    stats_ms = time_ms(call(("stats",)))
    kernel_ms = {"stats": stats_ms,
                 **{kn: time_ms(call(("stats", kn))) - stats_ms
                    for kn in ("dkdv", "dq")}}

    def forward(with_lse):
        return lambda: flash_kernel.flash_attention_cuda(
            q, k, v, variant, lse=lse if with_lse else None, **kw)

    fwd_ms = {variant: time_ms(forward(False))}
    lse_turns = []
    if lse is not None:
        runs = {(part, w): call(kernels, w)
                for part, kernels in (("call", None), ("stats", ("stats",)))
                for w in (True, False)}
        lse_turns = [((part, w), time_ms(runs[part, w]))
                     for part in ("call", "stats")
                     for w in (True, False, False, True)]
        fwd_turns = [(w, time_ms(forward(w)))
                     for w in (False, True, True, False)]
        fwd_ms = {f"{variant}{'_with_lse' if w else ''}":
                  float(np.mean([t for u, t in fwd_turns if u == w]))
                  for w in (False, True)}
    plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, do, **kw),
                       iters=2, warmup=1)
    del fwd, fwd_bwd
    sdpa_fwd_ms = (sdpa[0] + sdpa[3]) / 2
    library_ms = (sdpa[1] + sdpa[2]) / 2 - sdpa_fwd_ms
    ms = float(np.mean([t for _, t in turns]))
    bound_ms, bound_by, pairs = bwd_bound(shape, dtype, kw["causal"],
                                          kw["window"])
    split = 2 if dtype == torch.bfloat16 and hd > 128 else 1
    s_products = 4 if lse is not None else 6    # S in stats too, or not
    design_flops = (s_products * hd + 2 * dv
                    + 2 * split * (2 * hd + 2 * dv)) * pairs
    floor_ms = design_flops / PEAK_FLOPS[dtype] * 1e3
    by_lse = {f"{part}_{'forward_lse' if w else 'recomputed'}":
              float(np.mean([t for u, t in lse_turns if u == (part, w)]))
              for part in ("call", "stats") for w in (True, False)
              } if lse_turns else None
    print(f"[flash_bwd] {name}: general (LSE "
          f"{'the forward' if lse is not None else 'recomputed'}'s) in "
          f"turns with sdpa {', '.join(f'{t:.4f}' for _, t in turns)} ms; "
          f"kernels alone "
          f"{', '.join(f'{u} {t:.4f}' for u, t in kernel_ms.items())} ms; "
          f"forward {', '.join(f'{u} {t:.4f}' for u, t in fwd_ms.items())}"
          f" ms; plain {plain_ms:.4f} ms, "
          f"sdpa backward {library_ms:.4f} ms (v {sdpa_v}; forward "
          f"{sdpa_fwd_ms:.4f}, forward + backward {sdpa[1]:.4f}, "
          f"{sdpa[2]:.4f}); bound {bound_ms:.4f} ms ({bound_by}; {pairs} "
          f"unmasked pairs), the design's floor {floor_ms:.4f} ms "
          f"({design_flops / 1e9:.1f} GFLOP); general / bound "
          f"{ms / bound_ms:.2f}, general / sdpa {ms / library_ms:.2f}, "
          f"{design_flops / ms / 1e9:.1f} TFLOP/s of the design's products")
    if lse_turns:
        print(f"[flash_bwd] {name}: the forward's LSE read / recomputed, in "
              f"turns: " + ", ".join(
                  f"{part} {'read' if w else 'recomputed'} {t:.4f}"
                  for (part, w), t in lse_turns)
              + f" ms; forward without / with the LSE in turns "
              f"{', '.join(f'{t:.4f}' for _, t in fwd_turns)} ms")
    del lse
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "floor_ms": floor_ms, "ms_turns": turns, "kernel_ms": kernel_ms,
            "forward_ms": fwd_ms, "sdpa_forward_ms": sdpa_fwd_ms,
            "sdpa_v": sdpa_v, **({"ms_by_lse": by_lse} if by_lse else {})}


def _count_plain_calls():
    """Wraps K1's, K2's and K3's plain forwards and backwards where the
    dispatchers and the models could reach them; returns (calls, undo)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    calls = {"attention_ref": 0, "attention_bwd_ref": 0, "wkv6_ref": 0,
             "wkv6_bwd_ref": 0, "selective_scan_ref": 0,
             "selective_scan_bwd_ref": 0}
    saved = [(ref, "attention_ref", ref.attention_ref),
             (ref, "attention_bwd_ref", ref.attention_bwd_ref),
             (flash_ops, "attention_ref", flash_ops.attention_ref),
             (wkv_ref, "wkv6_ref", wkv_ref.wkv6_ref),
             (wkv_ref, "wkv6_bwd_ref", wkv_ref.wkv6_bwd_ref),
             (wkv_ops, "wkv6_ref", wkv_ops.wkv6_ref),
             (scan_ref, "selective_scan_ref", scan_ref.selective_scan_ref),
             (scan_ref, "selective_scan_bwd_ref",
              scan_ref.selective_scan_bwd_ref),
             (scan_ops, "selective_scan_ref", scan_ops.selective_scan_ref)]
    for mod, attr, fn in saved:
        def counted(*a, _fn=fn, _attr=attr, **kw):
            calls[_attr] += 1
            return _fn(*a, **kw)
        setattr(mod, attr, counted)

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return calls, undo


def train_config(arch):
    """TRAIN_PATHS' config of ``arch``: the published one, cut where the
    path says so."""
    from repro_torch.configs import get_config
    spec = TRAIN_PATHS[arch]
    cfg = get_config(arch).replace(**spec.get("cut", {}))
    if "moe_offset" in spec:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, layer_offset=spec["moe_offset"]))
    return cfg


def reset_counts(ops):
    """Every kernel's launch counts set to 0."""
    flash, wkv = ops["flash_attention"], ops["wkv6"]
    for mode in ops["selective_scan"].launches_by_mode:
        ops["selective_scan"].launches_by_mode[mode] = 0
    for m in ops.values():
        m.launches = 0
        if hasattr(m, "launches_bwd"):
            m.launches_bwd = 0
    for counts in (flash.launches_by_variant, flash.launches_bwd_by_variant,
                   flash.bwd_calls_by_lse):
        for variant in counts:
            counts[variant] = 0
    wkv.launches_by_plan.clear()
    for route in wkv.launches_bwd_by_route:
        wkv.launches_bwd_by_route[route] = 0


def read_counts(ops):
    """Every kernel's (forward, backward) launches, K1's by variant (and
    its backward calls by where their LSE came from), K2's by plan and
    route, and K3's forward by mode."""
    flash, wkv = ops["flash_attention"], ops["wkv6"]
    return {"launches": {k: (m.launches, getattr(m, "launches_bwd", 0))
                         for k, m in ops.items()},
            "k1_by_variant": dict(flash.launches_by_variant),
            "k1_bwd_by_variant": dict(flash.launches_bwd_by_variant),
            "k1_bwd_by_lse": dict(flash.bwd_calls_by_lse),
            "k2_by_plan": {_plan_name(*pl): c
                           for pl, c in wkv.launches_by_plan.items()},
            "k2_bwd_by_route": dict(wkv.launches_bwd_by_route),
            "k3_by_mode": dict(ops["selective_scan"].launches_by_mode)}


def expected_counts(kernels, ops, k3_mode="training", k1_variant="hopper",
                    k1_route="hopper"):
    """``read_counts``' value for a run whose kernels launch ``kernels``
    ({name: (forward, backward)}) times: every K1 forward launch on
    ``k1_variant``, every K1 backward launch on ``k1_route``, every K1
    backward call reading its forward's LSE (none recomputing it), every
    K2 forward under kernel.plan's choice and backward on "hopper", every
    K3 forward in ``k3_mode``, no other kernel."""
    from repro_torch.kernels.flash_attention import kernel_bwd
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    k1 = kernels.get("flash_attention", (0, 0))
    k2 = kernels.get("wkv6", (0, 0))
    k3 = kernels.get("selective_scan", (0, 0))
    return {"launches": {k: tuple(kernels.get(k, (0, 0))) for k in ops},
            "k1_by_variant": {"hopper": 0, "general": 0,
                              k1_variant: k1[0]},
            "k1_bwd_by_variant": {"hopper": 0, "general": 0,
                                  k1_route: k1[1]},
            "k1_bwd_by_lse": {"forward": k1[1] // len(
                kernel_bwd.KERNELS[k1_route]), "recomputed": 0},
            "k2_by_plan": ({_plan_name(*wkv_kernel.PLAN): k2[0]}
                           if k2[0] else {}),
            "k2_bwd_by_route": {"hopper": k2[1], "general": 0},
            "k3_by_mode": {"serving": 0, "training": 0, k3_mode: k3[0]}}


def phase_train(arch, card):
    """``arch`` (TRAIN_PATHS' config: the published one, or its cut) in
    bf16, random init from seed 0, through repro_torch.launch.train on the
    card: TRAIN_PATHS' steps on the synthetic stream (WSD for minicpm-2b,
    cosine otherwise).  Every kernel's counts are set to 0 before each
    step and read after it: each kernel of the path launched TRAIN_PATHS'
    times, forward and backward (K1's on the "hopper" route, K2's forward
    under kernel.plan's choice and its backward on the "hopper" route), no
    plain version called, no other kernel.  Then one step profiled.
    Returns the path's counts over its steps (``read_counts``' keys)."""
    from repro_torch.launch import train as launch_train
    spec = TRAIN_PATHS[arch]
    shape = {key: spec[key] for key in ("batch", "seq", "steps")}
    ops = kernel_ops()
    cfg = train_config(arch)
    print(f"[train] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{shape}, kernels {list(spec['kernels'])}")
    per_step = []

    def on_step(rec):
        per_step.append(read_counts(ops))
        reset_counts(ops)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain, undo = _count_plain_calls()
    reset_counts(ops)
    try:
        out = launch_train.run(cfg, device="cuda", on_step=on_step,
                               log=lambda line: print(f"[train] {line}"),
                               **shape)
    finally:
        undo()
    records = out["records"]
    losses = [r["loss"] for r in records]
    params = sum(t.numel() for t in _leaves(out["params"]))
    k1_variant, k1_route = K1_VARIANT.get(arch, ("hopper", "hopper"))
    want = expected_counts(spec["kernels"], ops, k1_variant=k1_variant,
                           k1_route=k1_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = float(np.median([r["step_ms"] for r in records[1:]]))
    tok_s = shape["batch"] * shape["seq"] / step_ms * 1e3
    print(f"[train] {arch} losses {losses}; launches a step {per_step}; "
          f"plain versions called {plain}")
    if "selective_scan" in spec["kernels"]:
        from repro_torch.kernels.mamba_scan import kernel_bwd as scan_bwd
        k3 = [(p["k3_by_mode"]["training"], p["launches"]["selective_scan"][1])
              for p in per_step]
        print(f"[train] {arch} K3 launches a step (forward in training mode, "
              f"backward kernels {'/'.join(scan_bwd.KERNELS)}): {k3}")
    print(f"[train] {arch} ({params / 1e9:.3f} B params) step time (median "
          f"of steps 2-{len(records)}) {step_ms:.1f} ms, {tok_s:.0f} tok/s, "
          f"peak memory {peak_gb:.2f} GB | {card}")
    check(len(records) == shape["steps"], f"train {arch}: steps missing")
    check(all(math.isfinite(x) for x in losses),
          f"train {arch}: losses {losses}")
    check(all(p == want for p in per_step),
          f"train {arch}: launches a step {per_step}, expected {want}")
    check(not any(plain.values()),
          f"train {arch}: plain versions called {plain}")
    k1 = "flash_attention" in spec["kernels"]
    if arch == "minicpm-2b":
        _embedding_backward_is_deterministic(out)
    kernels = profile_train_step(out, shape)
    if k1 and k1_route == "hopper":
        check(kernels is None or "bwd_stats" not in kernels,
              f"train: a stats kernel ran on the hopper route: {kernels}")
    result = {"arch": arch, **shape, "layers": cfg.n_layers,
              "losses": losses, "step_ms": [r["step_ms"] for r in records],
              "step_ms_median": step_ms, "tok_s": tok_s,
              "peak_memory_gb": peak_gb, "params": params, "card": card}
    print("train " + json.dumps(result))
    del out
    return _sum_counts(per_step)


def _sum_counts(runs):
    """``read_counts``' values of several runs, summed key by key."""
    out = {"launches": {}, "k1_by_variant": {}, "k1_bwd_by_variant": {},
           "k1_bwd_by_lse": {}, "k2_by_plan": {}, "k2_bwd_by_route": {},
           "k3_by_mode": {}}
    for run in runs:
        for k, (f, b) in run["launches"].items():
            f0, b0 = out["launches"].get(k, (0, 0))
            out["launches"][k] = (f0 + f, b0 + b)
        for part in ("k1_by_variant", "k1_bwd_by_variant", "k1_bwd_by_lse",
                     "k2_by_plan", "k2_bwd_by_route", "k3_by_mode"):
            for key, c in run[part].items():
                out[part][key] = out[part].get(key, 0) + c
    return out


def phase_jamba_moe_grad(card):
    """The MoE cut of jamba-1.5-large-398b (DECODE_CUTS[JAMBA]: attention +
    MLP, then Mamba + MoE with all 16 experts, every width as published)
    in bf16 from seed 0: JambaLM.loss and its gradients
    (training.step.value_and_grad, no optimizer) on one sequence of
    MOE_GRAD_SEQ tokens.  The loss, the aux loss and every gradient
    finite; every expert that received a token has a nonzero gradient in
    gate, up and down; K1 and K3 launched twice forward and once backward,
    K1 on "hopper", no plain version.  Returns the run's counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.factory import build_model
    from repro_torch.training.step import value_and_grad
    ops = kernel_ops()
    cfg = get_config(JAMBA).replace(**DECODE_CUTS[JAMBA])
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(SEED + 9)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, MOE_GRAD_SEQ + 1))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    routed = []
    real_route = M.route

    def recording(*a, **kw):
        out = real_route(*a, **kw)
        routed.append(out[0].detach())
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain, undo = _count_plain_calls()
    reset_counts(ops)
    M.route = recording
    try:
        t0 = time.perf_counter()
        loss, metrics, grads = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        M.route = real_route
        undo()
    counts = read_counts(ops)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_counts({"flash_attention": (2, 3),
                            "selective_scan": (2, 2)}, ops)
    leaves = list(_leaves(grads))
    finite = all(torch.isfinite(g).all().item() for g in leaves)
    moe = grads["periods"]["moe"]
    E = cfg.moe.n_experts
    got_tokens = sorted(set(routed[0].reshape(-1).tolist()))
    nonzero = [e for e in range(E)
               if all(moe[w][0, 0, e].count_nonzero().item() > 0
                      for w in ("gate", "up", "down"))]
    aux = metrics["aux_loss"].item()
    print(f"[moe_grad] {JAMBA} cut to {cfg.n_layers} layers (attention + "
          f"MLP, Mamba + MoE of {E} experts of {cfg.moe.d_expert}), "
          f"{n_params / 1e9:.3f} B params, 1 x {MOE_GRAD_SEQ} tokens bf16: "
          f"loss {loss.item():.4f} (xent {metrics['xent'].item():.4f}, aux "
          f"{aux:.4f}), {len(leaves)} gradient leaves finite {finite}; "
          f"experts that received tokens {got_tokens}, with nonzero "
          f"gate/up/down gradients {nonzero}; router gradient norm "
          f"{moe['router'].float().norm().item():.4e}; {dt:.1f} s; launches "
          f"{counts['launches']}; plain versions called {plain}; peak "
          f"memory {peak_gb:.2f} GB | {card}")
    check(math.isfinite(loss.item()) and math.isfinite(aux) and aux > 0,
          f"moe_grad: loss {loss.item()}, aux {aux}")
    check(finite, "moe_grad: a gradient is not finite")
    check(got_tokens and set(got_tokens) <= set(nonzero),
          f"moe_grad: experts with tokens {got_tokens}, nonzero {nonzero}")
    check(counts == want, f"moe_grad: launches {counts}, expected {want}")
    check(not any(plain.values()), f"moe_grad: plain versions {plain}")
    del params, grads, leaves, moe, model
    return counts


def phase_remat_bits():
    """A cut of REMAT_ARCH (REMAT_CUT, every width as published) on the
    card in bf16: DecoderLM.loss's gradients with each layer under
    activation checkpointing, remat policy None (the layer recomputed,
    K1's forward and its LSE with it) and "dots", equal those of the same
    layers without remat, bit for bit; every K1 backward on the "hopper"
    route."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build_model
    from repro_torch.training.step import value_and_grad
    flash = kernel_ops()["flash_attention"]
    cfg = get_config(REMAT_ARCH).replace(**REMAT_CUT)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (REMAT_SHAPE["batch"], REMAT_SHAPE["seq"] + 1))
    ).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    class NoRemat(type(model)):
        def _run_layers(self, *a, remat=False):
            return super()._run_layers(*a, remat=False)

    before = dict(flash.launches_bwd_by_variant)
    loss0, _, grads0 = value_and_grad(NoRemat(cfg), params, batch)
    differ = {}
    try:
        for policy in (None, "dots"):
            model.remat_policy = policy
            loss, _, grads = value_and_grad(model, params, batch)
            differ[str(policy)] = [path for (path, g), g0 in zip(
                T.flatten(grads), T.leaves(grads0))
                if not torch.equal(g, g0)] + (
                [] if torch.equal(loss, loss0) else ["loss"])
            del grads
    finally:
        model.remat_policy = None
    took = {vt: n - before[vt]
            for vt, n in flash.launches_bwd_by_variant.items()}
    n_leaves = len(T.leaves(grads0))
    print(f"[train] remat at {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{REMAT_SHAPE}: loss {loss0.item():.6f}; leaves of {n_leaves} "
          f"that differ from no remat: {differ}; K1 backward launches by "
          f"route {took}")
    check(not any(differ.values()),
          f"remat: gradients differ from no remat: {differ}")
    check(took["general"] == 0 and took["hopper"] > 0,
          f"remat: backward routes {took}")
    del params, grads0, model


def _embedding_backward_is_deterministic(out):
    """F.embedding's backward (what C.embed takes) gives the same bits
    twice on a batch of the stream, at the model's vocab and width; the
    indexing backward it replaced is printed beside it."""
    import torch.nn.functional as F
    w = out["params"]["embed"]["tokens"].detach().requires_grad_()
    toks = torch.from_numpy(out["data"].batch_at(0)["tokens"]).long().cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    g_out = torch.randn((*toks.shape, w.shape[1]), generator=gen,
                        device="cuda").to(w.dtype)
    same = {}
    for name, fn in (("F.embedding", lambda: F.embedding(toks, w)),
                     ("indexing", lambda: w[toks])):
        g1, g2 = (torch.autograd.grad(fn(), w, g_out)[0] for _ in range(2))
        same[name] = torch.equal(g1, g2)
        del g1, g2
    print(f"[train] embedding backward, two calls bit-identical: {same} "
          f"({toks.numel()} tokens, {len(torch.unique(toks))} distinct)")
    check(same["F.embedding"], "F.embedding's backward is not deterministic")


def profile_train_step(out, shape, batch=None):
    """One more training step (of ``shape``'s batch: ``batch`` where
    given, else the stream's next), timed on the host clock, then again
    under torch.profiler: its kernels by device time and by group
    (KERNEL_GROUPS), K1's forward and backward kernels, launches and the
    device-busy share.  Returns K1's kernels ({name fragment: (ms,
    launches)}), or None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import to_device
    if batch is None:
        batch = to_device(out["data"].batch_at(shape["steps"]), "cuda")
    state = [out["params"], out["opt_state"]]

    def step():
        state[0], state[1], m = out["step_fn"](state[0], state[1], batch)
        return m

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[profile] train step: wall {wall_ms:.1f} ms; device time "
              f"not measured (no CUDA events)")
        return None
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] train step ({shape['batch']} x "
          f"{shape['seq']} tokens): wall {wall_ms:.1f} ms, kernels "
          f"{busy_ms:.1f} ms in {sum(e.count for e in kernels)} launches, "
          f"device busy {100 * busy_ms / wall_ms:.0f}%")
    k1 = {}
    for e in kernels:
        for part in K1_KERNEL_PARTS:
            if part in e.key:
                ms, cnt = k1.get(part, (0.0, 0))
                k1[part] = (ms + e.self_device_time_total / 1e3,
                            cnt + e.count)
    print(f"[profile]   K1: " + ", ".join(
        f"{p} {ms:.2f} ms in {c}" for p, (ms, c) in k1.items()))
    print(f"[profile]   by group: {group_line(kernels)}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:5d}x  {e.key[:90]}")
    return k1


def group_line(kernels, n=1):
    """Profiled kernels' device time and launches by ``KERNEL_GROUPS``,
    largest first, per step of ``n``."""
    groups = {}
    for e in kernels:
        key = next((g for g, marks in KERNEL_GROUPS
                    if any(m in e.key for m in marks)), "other")
        ms, cnt = groups.get(key, (0.0, 0))
        groups[key] = (ms + e.self_device_time_total / 1e3 / n,
                       cnt + e.count // n)
    return ", ".join(f"{g} {ms:.2f} ms in {c}" for g, (ms, c) in sorted(
        groups.items(), key=lambda kv: -kv[1][0]))


def phase_train_restart():
    """examples/train_elastic_torch.py on the card: train to RESTART's
    preempt_at, checkpoint, drop the state, restore (held bit for bit to
    what was saved), continue, and hold the continued losses to an
    uninterrupted run of the same seed, bit for bit; eval batches go to
    rFaaS-leased executors."""
    import importlib.util
    path = ROOT / "examples" / "train_elastic_torch.py"
    spec = importlib.util.spec_from_file_location("train_elastic_torch",
                                                  path)
    elastic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(elastic)
    res = elastic.train_elastic(device="cuda",
                                log=lambda line: print(f"[restart] {line}"),
                                **RESTART)
    losses, straight = res["losses"], res["straight"]
    differ = [i for i, (a, b) in enumerate(zip(losses, straight)) if a != b]
    print(f"[restart] {elastic.make_cfg().n_layers} layers at d_model "
          f"{elastic.make_cfg().d_model}: restored leaves that differ "
          f"{res['restored_same_bits']}; losses that differ from the "
          f"uninterrupted run at steps {differ}; evals {res['evals']}; "
          f"bill {res['bill']}")
    check(not res["restored_same_bits"],
          f"restart: restored leaves differ {res['restored_same_bits']}")
    check(len(losses) == len(straight) == RESTART["steps"],
          "restart: steps missing")
    check(all(math.isfinite(x) for x in losses), "restart: non-finite loss")
    check(not differ, f"restart: losses differ at steps {differ}")
    check(res["evals"], "restart: no eval ran on a leased executor")
    check(res["bill"].invocations > 0, "restart: nothing billed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each main path, profile one prefill wave "
                         "and three decode steps with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's sources are not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)
    phase_sass(phase_build())
    ex2_per_s, mufu_slots = phase_ex2_rate()
    entries = {"flash_attention": phase_flash(), "wkv6": phase_wkv6(),
               "selective_scan": phase_scan(ex2_per_s, mufu_slots)}
    check(all(entries.values()), "no main-path kernel measurement")
    for entry in entries.values():
        entry["launches"], entry["launches_by_path"] = 0, {}
    flash = entries["flash_attention"]
    flash["launches_by_variant"] = {"hopper": 0, "general": 0}
    flash["launches_by_path_and_variant"] = {}
    entries["wkv6"]["launches_by_plan"] = {}
    for arch, per_wave in MAIN_PATHS.items():
        free_device_memory("the previous phase")
        launches = phase_main_path(arch, card, args.profile)
        for name in per_wave:
            entries[name]["launches"] += launches[name]
            entries[name]["launches_by_path"][arch] = launches[name]
        for variant, n in launches["flash_attention_by_variant"].items():
            flash["launches_by_variant"][variant] += n
        if "flash_attention" in per_wave:
            flash["launches_by_path_and_variant"][arch] = \
                launches["flash_attention_by_variant"]
        for pl, n in launches["wkv6_by_plan"].items():
            by_plan = entries["wkv6"]["launches_by_plan"]
            by_plan[pl] = by_plan.get(pl, 0) + n
    free_device_memory("the previous phase")
    g = phase_whisper_serve(card, args.profile)
    flash["launches"] += g["launches"]["flash_attention"][0]
    flash["launches_by_path"][WHISPER] = g["launches"]["flash_attention"][0]
    for variant, n in g["k1_by_variant"].items():
        flash["launches_by_variant"][variant] += n
    flash["launches_by_path_and_variant"][WHISPER] = g["k1_by_variant"]
    for arch in DECODE_CUTS:
        free_device_memory("the previous phase")
        phase_decode_vs_prefill(arch, **DECODE_TRAFFIC.get(arch, {}))
    free_device_memory("the previous phase")
    phase_whisper_card_vs_cpu()
    free_device_memory("the previous phase")
    for path, by_variant in phase_mesh(card).items():
        flash["launches"] += sum(by_variant.values())
        flash["launches_by_path"][path] = sum(by_variant.values())
        flash["launches_by_path_and_variant"][path] = by_variant
        for variant, n in by_variant.items():
            flash["launches_by_variant"][variant] += n
    free_device_memory("the previous phase")
    mesh_train_runs = phase_mesh_train(card)
    free_device_memory("the previous phase")
    mesh_train_runs.update(phase_mesh_ssm(card))
    free_device_memory("the previous phase")
    mesh_train_runs.update(phase_mesh_wq(card))
    free_device_memory("the previous phase")
    bwd = phase_flash_bwd()
    free_device_memory("the previous phase")
    wkv_bwd = phase_wkv6_bwd()
    free_device_memory("the previous phase")
    scan_bwd = phase_scan_bwd(ex2_per_s)
    runs = dict(mesh_train_runs)
    for arch in TRAIN_PATHS:
        free_device_memory("the previous phase")
        runs[f"{arch} (train)"] = phase_train(arch, card)
    free_device_memory("the previous phase")
    runs[f"{WHISPER} (train)"] = phase_whisper_train(card)
    free_device_memory("the previous phase")
    phase_remat_bits()
    free_device_memory("the previous phase")
    runs[f"{JAMBA} (moe grad)"] = phase_jamba_moe_grad(card)
    # kernel launches, as every entry counts them, by path; calls of the
    # backwards
    bwd_entries = {"flash_attention": bwd, "wkv6": wkv_bwd,
                   "selective_scan": scan_bwd}
    for entry in bwd_entries.values():
        entry["launches"], entry["launches_by_path"] = 0, {}
    bwd["launches_by_variant"] = {"hopper": 0, "general": 0}
    bwd["calls_by_lse"] = {"forward": 0, "recomputed": 0}
    wkv_bwd["launches_by_route"] = {"hopper": 0, "general": 0}
    for path, got in runs.items():
        for name, (fwd_n, bwd_n) in got["launches"].items():
            if fwd_n:
                entries[name]["launches"] += fwd_n
                entries[name]["launches_by_path"][path] = fwd_n
            if bwd_n:
                bwd_entries[name]["launches"] += bwd_n
                bwd_entries[name]["launches_by_path"][path] = bwd_n
        for vt, c in got["k1_by_variant"].items():
            flash["launches_by_variant"][vt] += c
        for vt, c in got["k1_bwd_by_variant"].items():
            bwd["launches_by_variant"][vt] += c
        for src, c in got["k1_bwd_by_lse"].items():
            bwd["calls_by_lse"][src] += c
        by_plan = entries["wkv6"]["launches_by_plan"]
        for pl, c in got["k2_by_plan"].items():
            by_plan[pl] = by_plan.get(pl, 0) + c
        for rt, c in got["k2_bwd_by_route"].items():
            wkv_bwd["launches_by_route"][rt] += c
        scan = entries["selective_scan"]
        scan["launches_training_mode"] = (
            scan.get("launches_training_mode", 0)
            + got["k3_by_mode"].get("training", 0))
    bwd["calls"] = sum(c // bwd["kernels_per_call"][vt]
                       for vt, c in bwd["launches_by_variant"].items())
    for entry in (wkv_bwd, scan_bwd):
        entry["calls"] = entry["launches"] // len(entry["kernels_per_call"])
    entries["flash_attention_bwd"] = bwd
    entries["wkv6_bwd"] = wkv_bwd
    entries["selective_scan_bwd"] = scan_bwd
    free_device_memory("the previous phase")
    phase_train_restart()
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
