"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. the card (name and power limit as nvidia-smi gives them) and the TF32
     settings: PyTorch's defaults (cuDNN convolutions in TF32, matrix
     products in full f32) for the CLI and training runs and every timing;
     the whole-network comparisons run their convolutions in full f32 on
     both sides, since under TF32 a 1e-6 change in an attention output can
     flip a TF32 rounding (2^-11 relative) downstream;
  2. build every hand-written kernel from the sources in the checkout, all
     `nvcc`s at once, with each kernel's registers and spills, the build
     seconds and the instance count, and the SASS count of HMMA
     (tensor-core `mma.sync`), HGMMA (warpgroup `wgmma`) and MUFU.EX2
     instructions in every tensor-core instance (TC_KERNELS: the forward
     in f32 (3xTF32), exact and fast math, and the backward's two kernels
     in each dtype, at every staged width Dp 8/16/32/64 with G 1/2/4/8 where
     G * Dp <= 64, and at G 1 for the general staging; the bf16 forward at
     Dp 8 on `mma.sync` and at Dp 16 to 256 on `wgmma`; the wide kernels at
     Dp 128 and 256), each of which must hold its product instruction
     (HGMMA for the `wgmma` kernel, HMMA for the rest) and spill nothing;
  3. the attention forward against its plain PyTorch version at the
     sampling path's shapes (and at batch 16, the guided sampler's and the
     trainer's, and at ragged T, 101 and 1000), in both layouts; also its
     log-sum-exp against `attention_lse_reference` and the output
     torch.equal with and without it, and in f32 the kernel against
     `attention_tf32x3_kernel_order` (`tf32_order_tol`); then timed beside its
     bound (the largest of bytes, products and one pass of exponentials),
     the plain version and `scaled_dot_product_attention`, launched from
     the host and, for the device time alone, replayed from a CUDA graph;
     then the kernel table's own rows (`python3 chip_smoke.py
     --kernel-table` runs them alone): K2, the (B, H, T, D) layout, in turns
     with K1 (the UNet's views) and SDPA at the UNet's shapes, both dtypes;
     every other head_dim's route (K1 and K3 on the tensor cores at a staged
     width of 8 for D 4, of D itself for 16 to 256; the bf16 forward from
     16 on the warpgroup-product kernel) checked (forward and
     lse, fast math against its order, backward from the saved statistics
     against plain and its order, G bit identity) and timed at D4_SHAPES
     (the tiny test config's calls and (8,64,1024,4)) and at HEADDIM_SHAPES,
     (8, 256/D, 1024, D), both dtypes, host-launched and from a CUDA graph,
     in turns with SDPA (the backward with SDPA's backward alone on a
     prebuilt forward), beside their bounds and the plain versions;
  4. the attention backward likewise at the training path's shapes and at
     ragged T; also from the exact forward's saved output and log-sum-exp:
     the output
     torch.equal with and without the log-sum-exp, the log-sum-exp against
     `attention_lse_reference`, the gradients against the plain version of
     the kernel's own rounding (bf16 `attention_bwd_kernel_order` within
     BWD_ORDER_TOL, f32 `attention_bwd_tf32x3_kernel_order` within
     `tf32_order_tol`), two calls and the standalone call (with its
     statistics launch) torch.equal; timed from saved statistics,
     standalone, beside SDPA's backward alone, and its forward+backward
     beside the plain path's and `scaled_dot_product_attention`'s through
     autograd;
  5. the full-width UNet2D (random weights from a seed): one forward with
     the kernel and one with the plain attention, f32 and bf16; then one
     backward each way at batch 4, f32 and bf16 compute on f32 parameters:
     every attention projection gets a gradient through the kernels; in f32
     every parameter's gradient agrees with the plain path's, in bf16 the
     kernel path is as close to the f32 gradients as the plain path is;
  6. the sampling path through its entry point: `synt_isic_tpu_torch.cli.main`
     generating 8 MEL images, batch 8, DDIM 10 steps, from a random
     full-width checkpoint; the forward kernel's launch count must read
     exactly 6 attention calls x 10 steps; then 3 warm sampler steps under
     `torch.profiler`: device busy s/step, idle share, attention part;
  7. the training path through its entry point:
     `synt_isic_tpu_torch.train.__main__.main` on 64 procedural MEL images,
     2 epochs of batch 16 (8 steps, bf16 compute, f32 parameters); the
     launch counts must read exactly 6 forward and 6 backward per step and
     no statistics launch (the backward reads the forward's); the
     checkpoint it writes is then loaded by `ModelManager` and sampled
     (DDIM 10, 8 images);
  8. `measure_train_step` at batch 32, then 3 more steps under
     `torch.profiler`: the device's busy time per step, its idle share and
     the attention kernels' part (or "not measured" where the profiler
     records no device time);
  8b. [train-f32] `train --no-bf16` through the same entry point and run as
     7 (f32 compute): 6 forward and 6 backward launches per step, no
     statistics launch; then [f32]: K3 in f32 from the forward's saved
     statistics and standalone, and K4 in f32, at the training shapes (CUDA
     events, in turns, medians of F32_ROUNDS), and the warm f32 training
     step at batch 32 (`measure_train_step` handed a TrainConfig with
     bf16_compute off) with its profiler split; `python3 chip_smoke.py
     --f32` runs [f32] alone after the build, also in a parent tree with
     this script copied in;
   8c. [distill] `python -m synt_isic_tpu_torch.train --distill-from` on a
     seeded full-width teacher (save_checkpoint of `UNet2DConfig()`), 32
     procedural MEL images, batch 16, 16 -> 4 steps: phases 8 and 4 of 8
     steps; exactly 18 forward launches per step (two teacher forwards
     without the log-sum-exp, the student's with it) and 6 backward, no
     statistics launch; finite losses; `unet_MEL_distill8.pth` and
     `unet_MEL_distill4.pth` written; the 4-step student loaded by
     `ModelManager(variant="distill4")` and sampled at DDIM 4 trailing
     (exactly 24 launches, finite images); then the warm distillation step
     at batch 32 beside [bench]'s train step, its peak memory and its
     profiler split (`python3 chip_smoke.py --distill` runs card, build,
     the train step and this phase alone);
  8d. [remat] `measure_train_step(remat_mode=m)` for none/all/hires/attn/dots
     at batch 32 and 64: s/step, peak memory, launches per step (6 or 12
     forward, 6 backward, no statistics launch), every mode's peak below
     none's; one step's gradients at full width under deterministic cuDNN,
     every mode torch.equal to none's (`python3 chip_smoke.py --remat` runs
     card, build and this phase alone);
  8e. [train-classifier] `train --train-classifier` on 8 procedural JPEGs per
     class for the seven classes and their one-hot CSV, 2 epochs of batch
     16: finite epochs; `classifier.pth` loaded by the XAI classifier with
     nothing skipped, its logits on a probe batch torch.equal to an f32
     rebuild from the file and near the trained model's own; the warm step;
 9. [kernel-fast] the forward kernel's fast-math variant (bf16
     exponentials) at the sampling path's shapes, f32 and bf16, in both
     layouts (both on the tensor cores at head_dim 8): within 1e-2 of its
     plain version, within the JAX package's fast-math tolerance (rtol
     0.05, atol 0.02) of exact attention, and near the plain version of its
     own rounding order (`attention_fast_math_kernel_order` at 64 keys per
     max update, in f32 with the 3xTF32 logits and the one-pass tile max):
     in f32 each output within FAST_FLIPS bf16 flips of it (a limit the
     exact kernel must miss), in bf16 within one bf16 ulp; in both dtypes,
     at logits 8x wider, the exact kernel's mean distance from that order
     must exceed the fast kernel's FAST_SEPARATION times; timed in turns
     with the exact kernel and `scaled_dot_product_attention` (medians of
     FAST_ROUNDS), launched from the host and replayed from a CUDA graph,
     beside the bound and the plain version; `python3 chip_smoke.py
     --fast-f32` runs the f32 timing alone after the build, also in a
     parent tree with this script copied in;
 10. [kernel-group] heads_per_program G in {1, 2, 4, 8} at (8,32,1024,8), f32
     and bf16, exact and fast math: every G torch.equal to G = 1 (exact:
     the log-sum-exp too), and a time for each; G* is the fastest G > 1 for
     fast math in bf16, the variant [generator] runs, whose error and time
     the `kernels` line reports, beside f32 fast math's time at each G;
 10b. [host] the wrappers' host path at T=256 (and T=1024): per wrapper
     (`fused_attention` bf16, f32 and fast math, K4 forward+backward) the
     host time of one call, and the kernel and SDPA launched from the host
     in turns (medians of HOST_ROUNDS), with a cProfile split at T=256;
     `python3 chip_smoke.py --host` runs this phase alone after the build;
 11. [generator] the library path: `ImageGenerator` (bf16 compute) on the
     full-width random checkpoint, `set_attention_tuning(G*, fast_math=True)`,
     DDIM 10 steps, batch 8, fixed base seed, `generate_images([("MEL", 16)])`:
     16 PNGs, sidecars and CSV rows; exactly 120 fast-math launches (2 blocks x
     10 steps x 6), 0 exact ones, 120 grouped; wall time and images/s, cold
     and warm (the same call again on the same generator, byte-identical to
     the cold one), and the sampler alone on one block;
 11b. [generator-f32-fast] the same library path in f32 (`ImageGenerator`
     with f32 compute, `set_attention_tuning(heads_per_program=1,
     fast_math=True)`), 16 MEL images in 2 blocks of 8, DDIM 10, fixed base
     seed: exactly 120 fast-math launches (the f32 tensor-core kernel), 0
     exact and 0 grouped; the warm sampler block timed in turns with the same
     generator at fast_math=False (medians of GEN_ROUNDS), and 3 warm steps of
     each under `torch.profiler` (device busy, attention part); then
     `cli --reproduce` of a sidecar of the second block in a fresh process:
     byte-identical, 60 fast-math launches;
 11c. [samplers] the rest of the sampler on the [cli] checkpoint, f32, exact
     kernel: `cli.main` at MEL:8 with `--scheduler unipc` and with
     `--scheduler dpm_solver_sde`, 20 steps, trailing (bench.py's UNIPC and
     SDE configurations at batch 8), each with exactly 6 x 20 = 120 launches
     and a fresh-process `--reproduce` of one JPEG (byte-identical, 120
     launches); `--augment-source` with `--augment-mask` (the mask keeps the
     left half of a seeded source PNG), DDIM 10 at strength 0.6, 2 variants:
     exactly 2 x 6 x 6 = 72 launches, the kept half within one 8-bit level of
     the source, and a fresh-process `--reproduce` of one (byte-identical, 36
     launches); a UniPC-20 walk with injected noise on both grids, kernel
     vs plain attention under full-f32 convolutions: leading within
     UNIPC_WALK_TOL, trailing within the bound carried from its first step
     (UNIPC_FIRST_STEP_FACTOR, derived beside it); DDIM-20,
     UniPC-20 and SDE-20 (trailing, batch 8) timed in turns on the host
     clock (s/step of a warm walk, and each against DDIM), and UniPC and SDE
     under `torch.profiler` (device busy, idle share, attention part);
 11d. [xai] the XAI engine on the [cli] checkpoint (f32, exact kernel) and a
     classifier.pth of seeded random ResNet-18 weights (torchvision's names,
     8 outputs): `run_standalone_xai` at the reference defaults (MEL, seed
     42, DDPM 50 keeping every 5th step and the last: 11 frames, IG 50,
     SHAP 512, Grad-CAM and sanity, 1000 bootstraps, 10 000 permutations):
     exactly 6 x 50 = 300 launches and no plain attention call, every
     classifier tensor on the card, no stage's caught failure, the files and
     their keys, its stage_seconds, wall time and trajectories per hour;
     the same DDPM-50 walk kernel vs plain attention (XAI_WALK_TOL, derived
     beside it); the pipeline on the card under full-f32 convolutions
     against the CPU port over the same frames (XAI_TOL; IG and SHAP cut to
     XAI_CMP_IG_STEPS and XAI_CMP_SHAP_SAMPLES on both sides); K1 at the walk's
     batch-1 shapes in turns with SDPA, host-launched and from a CUDA
     graph; `ImageGenerator` with `create_integrated_xai_analyzer`, DDPM 10
     on 4 MEL images, every 2nd analysed: exactly 240 launches and 2
     `xai_results/MEL/*.json` files without a failed stage; without
     matplotlib both runs go on without figures and say so
     (`python3 chip_smoke.py --xai` runs card, build, [unet] and this phase
     alone);
 11e. [serve] the serving path: an in-process `GenerationServer` over
     `ImageGenerator(device="cuda")` (bf16, batch 16, DDIM 10): warmup with
     `compile: true` (`compiled_batches == [1, 16]`), 4 concurrent clients x
     8 seedless images (coalesced; served images/s beside the warm
     `generate_images` rate), a fixed-seed request byte-identical to
     `generate_images`, the `bench_serve.py --mixed` load (interactive b1
     replies before a 64-image DDIM-50 bulk reply; p50/p95), the UniPC-8
     fast lane, an `xai` request, `status`; exactly 6 K1 launches per UNet
     evaluation of every walk, counted from the sampler calls, and no
     plain attention; then `python -m synt_isic_tpu_torch.serve` in a fresh
     process (classes, a 2-image generate, shutdown at rc 0) and the web UI
     (a 4-image generation, device memory in `/api/state`); `python3
     chip_smoke.py --serve` runs card, build, [unet] and this phase alone,
     and `--generator` runs [generator] alone (e.g. in an unpacked parent
     tree);
 12. [reproduce] `python -m synt_isic_tpu_torch.cli --reproduce` in a fresh
     process: a sidecar of the second [generator] block (60 fast-math
     launches) and a JPEG sidecar of the CLI phase (f32, 60 exact launches),
     each byte-identical to its original; and the fast-math image with the
     flag taken out of its sidecar, which must come out different (60 exact
     launches);
 13. [kernel-bwd-group] the backward kernel at heads_per_program G in
     {1, 2, 4, 8} at the training shapes, f32 and bf16, in both layouts:
     every G > 1 torch.equal to G = 1 for dq, dk and dv, standalone and
     from saved statistics, the grouped launches counted, a time for each
     G (from saved statistics) beside the bound;
 14. [train-conditional] the conditional training entry point in a fresh
     process, `python -m synt_isic_tpu_torch.train --conditional` on the
     seven classes x 16 procedural images, 1 epoch of batch 16 with the eval
     probe: exactly 6 forward and 6 backward launches per step plus 6 x 8
     forward launches of the probe, no statistics launch; it writes
     `unet_conditional_best.pth`
     and its `.json`. Then `train_conditional` as a library call with a
     full-width conditional UNet at heads_per_program = 2 (bf16 compute,
     f32 parameters): `attention_bwd_grouped` = `attention_bwd` = 6 per
     step; and one training step's gradients at G = 2 torch.equal to those
     at G = 1 (same injected t, eps and dropout mask, cuDNN deterministic);
 15. [conditional] `ImageGenerator(conditional=True, guidance_scale=3.0,
     guidance_map={"MEL": 2.5, "NV": 1.0})` on that checkpoint, f32, exact
     kernel, DDIM 10, batch 8: MEL:6, NV:6, VASC:4 in two mixed-class
     blocks, exactly 120 attention_fwd launches (one 2B-batched forward per
     step); 16 PNGs with conditional sidecars and CSV rows; one guided
     prediction (2B forward and the CFG combine) on a mixed-label batch of
     8, kernel vs plain attention, within UNET_TOL; warm s/step and
     images/s;
 16. [reproduce-conditional] `cli --reproduce` in a fresh process of a
     sidecar of the second mixed block: byte-identical, exactly 60
     launches;
 16b. [mesh] data parallelism over device meshes on the full-width UNet of
     [unet]: `cli --dp-mesh 1` (MEL:8, DDIM 10, f32) against the same run
     without a mesh: 60 launches each, the JPEGs byte-identical, sidecars
     recording dp_mesh 1, and a fresh-process `--reproduce` of one
     byte-identical with 60 launches; the library `ShardedSampler` over
     [cuda:0, cuda:0] and over every card when there are more on 5 seeds
     (padded to 6), over [cuda:0, cpu] (two distinct devices: a CPU replica
     and a thread per device) on 2, within MESH_WALK_TOL of the unsharded
     walk, exactly 6 x CUDA shards x 10 K1 launches, host-clock walk times
     beside the unsharded walk's; `train --dp-mesh` in a fresh process with
     RANK=0 WORLD_SIZE=1 (a one-rank NCCL group: its all_reduce runs once
     per step), 2 steps with [train]'s 6 + 6 launches per step; one f32 dp
     train step at batch 32 on [cuda:0, cuda:0] and on [cuda:0, cpu]
     against the single-device step (the loss, every reduced gradient and
     every weight within the bounds stated at MESH_LOSS_RTOL, and the
     replicas torch.equal to the primary); `serve --mesh auto` from a
     fresh process (status, a 3-image bulk generate whose sidecars record
     the mesh); the standalone XAI through its environment protocol with
     XAI_MESH_DEVICES=1 against the run without (attribution maps within
     [xai]'s bound), and the library XAI fan-out over [cuda:0, cpu]
     against no mesh. `python3 chip_smoke.py --mesh` runs card, build,
     [unet] and this phase alone;
 16b'. [tp] tensor parallelism over ('data', 'model') meshes whose devices
     repeat cuda:0, on the full-width UNet of [unet]: `ShardedSampler` over
     {data 1, model 2} (8 seeds, DDIM 10, f32, exactly 120 K1 launches, each
     at 16 heads) and {data 2, model 2} (240 at batch 4), each walk and its
     frames within MESH_WALK_TOL of the unsharded walk under full-f32
     convolutions, the distance under TF32 printed, host-clock walk times
     beside the unsharded walk's; bf16 fast math at heads_per_program 2
     (120 K1-fast launches, all grouped, 16 heads); `ImageGenerator.set_mesh`
     over 1 x 2 writing MEL:8 (120 launches, sidecars recording dp_mesh 2);
     a `GenerationServer` on it (status reports the mesh; generates of 3
     and 2 images: 240 launches); one f32 train step and the standalone XAI
     run on 1 x 2 against no mesh at [mesh]'s bounds; K1 and K1-fast timed
     at the shapes a shard hands them, (8,16,1024,8) and (8,16,256,8),
     beside the bound, the plain version and SDPA. Since the sidecars
     record the mesh's axes and devices, a fresh-process `--reproduce` of
     one image of the generator's block and one of the server's (the two
     processes at once) rebuilds the 1 x 2 mesh: byte-identical, 120
     launches each. Then rows of the card and the CPU, [cuda:0, cpu] and
     [cpu, cuda:0] (TP_MIXED_ROWS: every activation crosses between two
     devices): 2 seeds each within MESH_WALK_TOL of the unsharded walk, 60
     K1 launches at 16 heads from the card's shard, 60 plain calls at 16
     heads from the CPU's. `python3 chip_smoke.py --tp` runs card, build,
     [unet] and this phase alone;
 16c. [eval] image-set evaluation through its four entry points, on the
     full-width UNet of [unet] (MEL) and a seeded NV one, a seeded random
     classifier.pth and a seeded random inception_v3.pth (torchvision's
     names): `eval_fid`'s generator (64 MEL images, DDIM 10: 60 launches);
     `default_extractor(require_standard=True)` must pick Inception-v3 from
     the file; its pool3 features of the 64 images at batch 32 in f32 (TF32
     off for its calls): images/s warm on the host clock, device busy from
     `torch.profiler`, peak memory, and the bound from the FLOPs of the
     manifest's convolutions, 4 images held to the CPU port within
     INCEPTION_CARD_TOL; `compute_fid` of two 16-image sets with each
     extractor (Inception, classifier, pixel) on the card and on the CPU,
     held to the bound the two runs' features give at this small N
     (`frechet_feature_bound`); `parity_gauntlet` at DDIM 10, 2 images a
     class: every step passes (FID standard, not skipped), exactly 420
     launches; `fairness_audit --images` on the gauntlet's FID PNGs; a cut
     `e2e_loop` (E2E_ARGS): exactly 312 forward and 24 backward launches,
     its report keys and finite Fréchet batteries. `python3 chip_smoke.py
     --eval` runs card, build and this phase alone;
 16d. [score] the quality ladders and the per-class family through their
     entry points (`synt_isic_tpu_torch.scripts.<name>.main`), full width,
     bf16 (augment_eval f32), cut as SCORE_* says: train_family over MEL and
     NV (and again: both skipped, checkpoints byte for byte), score_family
     and rescore_family_consistency --skip-probe (the same consistency and
     probe accuracy), score_checkpoint --flagship with --ab-fast-math (the
     fast row K1-fast only, its sidecars recording it) and with
     --heads-per-program 2 (K1-G), sampler_ladder with one rung per
     scheduler, distill_ladder 8 -> 4, augment_eval (border preserved),
     e2e_conditional at guidance 1 and 3: every launch count as read from the
     code (SCORE_WANT), no plain attention call, every report's keys, wall
     times, images/s per rung, and the warm family and distillation steps
     beside [bench]'s (`python3 chip_smoke.py --score` runs card, build, a
     [bench] step and this phase alone);
 16e. [app] the desktop window and the tool scripts on the full-width UNet
     of [unet] (f32, exact kernel) and [xai]'s seeded classifier.pth: the
     window (`app/gui.py` through the headless Qt stub) with its default
     devices: the combo lists cuda:0, the memory label reads MB; Start at
     MEL:8, 10 steps, fixed seed 0 (the config's batch 8: one block) makes
     exactly 60 K1 launches and no plain attention call, 8 PNGs with
     sidecars and CSV rows, one of them `--reproduce`d byte-identical in
     process (60 more); with "Integrated XAI" at MEL:4, every 2nd (one block
     of 4 in trajectory mode: 60 launches; a short pipeline, APP_XAI_RUN):
     2 analyses by a classifier on the card; `display_image` shows the overlay
     artifact; "Standalone XAI" (a fresh process, 10 steps) exits 0 on the
     window's device (its log names it) with its analysis_results.json;
     `python -m
     synt_isic_tpu_torch.app.gui` exits 1 with the port's message.
     `smoke_generate --samples 4 --steps 20`: 4 PNGs, 120 launches;
     `convert_checkpoint` inspect (the parameter count), to-npz then to-pth
     (every tensor torch.equal); `warm_cache` at APP_WARM_CONFIGS, bf16,
     classifier batches 64 and 256: both walks of each config (cold, warm)
     with 2 x 6 x (10 + 10 + 20) = 480 launches, the cold and warm seconds
     printed; `GPU_PEAKS` holds the card's name. `python3 chip_smoke.py
     --app` runs card, build, [unet] and this phase alone;
 16f. [headdim] the library path at other head_dims: for attention_head_dim
     in HEADDIM_WALKS (4, 32, 64, 128, 256: 64, 8, 4, 2 and 1 heads at the
     256-channel blocks) `ImageGenerator(model_config=UNet2DConfig(attention_head_dim=D))`
     on one full-width checkpoint (the weights do not depend on D), f32
     exact, DDIM 10, `generate_images([("MEL", 16)])` in two blocks of 8:
     exactly 120 K1 launches, all at that head count, 16 PNGs; the first
     block's walk kernel vs plain attention (`use_fused_attention` off)
     under full-f32 convolutions within HEADDIM_WALK_TOL; the same in bf16
     at head_dim HEADDIM_BF16_WALK (120 K1 launches, each on the `wgmma`
     kernel); then at each of HEADDIM_TRAIN_DIMS (32, 128) a few warm steps
     of `make_train_step` at batch 32, bf16: 6 K1 with their statistics (on
     the `wgmma` kernel) and 6 K3 per step, no statistics launch, and the
     full-width UNet's f32 gradient kernel vs plain within UNET_GRAD_TOL
     (`python3 chip_smoke.py --headdim` runs card, build and this phase);
 17. a JSON line of per-kernel numbers, then as the last line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package. Needs one CUDA device; exits
non-zero without one.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import cProfile
import csv
import functools
import importlib.util
import io
import json
import math
import multiprocessing
import os
import pickle
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from synt_isic_tpu_torch import cli
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.model_manager import ModelManager
from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from synt_isic_tpu_torch.ops import attention, native
from synt_isic_tpu_torch.diffusion.schedules import DiffusionSchedule
from synt_isic_tpu_torch.train import __main__ as train_entry
from synt_isic_tpu_torch.train.benchmark import PROFILE_STEPS, device_seconds, measure_train_step
from synt_isic_tpu_torch.train.procedural import ProceduralDataset
from synt_isic_tpu_torch.train.train_conditional import LabeledMixtureDataset, train_conditional
from synt_isic_tpu_torch.train.train_ddpm import TrainConfig, create_train_state, make_train_step
from synt_isic_tpu_torch.utils.compute import GPU_PEAKS

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit), from
# the port's table (`utils/compute.py`)
H100 = GPU_PEAKS["NVIDIA H100 80GB HBM3"]
PEAK_BYTES_PER_S = H100["bytes_per_s"]
# f32: products accurate to f32 on the tensor cores, as the f32 attention
# forward computes them, take three TF32 passes (3xTF32: hi*hi + hi*lo +
# lo*hi), so a third of the dense TF32 rate; this is above the CUDA cores'
# 67e12, so it is the least time any f32 kernel could take for the products
PEAK_FLOPS = {torch.float32: H100["tf32_flops"] / 3, torch.bfloat16: H100["bf16_flops"]}
SFU_EXP_PER_S = H100["exp_per_s"]   # exponentials: 16 per clock per SM at boost clock

# f32: the tolerance the Pallas kernel is held to against its einsum
# reference (tests/test_pallas_ops.py). bf16: the kernel and the plain
# version round the output (and the plain version the probabilities) to
# bf16 at different points, so they may differ by one bf16 ulp of the
# output, 2^-6 at |x| < 4; randn inputs give |out| < 4.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
# whole UNet, kernel vs plain attention, as max|diff| / max|plain|: the
# attention outputs differ by the rounding above, which the remaining
# layers carry to the output; f32 (full-f32 convolutions) allows 1e-4, bf16
# (every layer rounds to 8 bits of mantissa) 5e-2.
UNET_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}

MAIN_SHAPES = [(8, 32, 1024, 8), (8, 32, 256, 8)]   # the UNet's 6 calls at batch 8
# [kernel]'s table rows: K2 (the (B, H, T, D) layout) at MAIN_SHAPES beside
# K1 (the UNet's (B, T, C) views) and SDPA, in turns; head_dim 4 (the
# tensor-core kernels at a staged width of 8), forward and backward, at the
# tiny test config's calls (batch 2: 4 heads at T = 64 and at T = 16) and at
# (8, 64, 1024, 4), and head_dims 16, 32, 64, 128 and 256 at the main path's
# size, 256 channels in heads of D, beside their bound, the plain version and
# SDPA's call (its backward alone on a prebuilt forward)
D4_SHAPES = [(2, 4, 64, 4), (2, 4, 16, 4), (8, 64, 1024, 4)]
HEADDIM_SHAPES = [(8, 16, 1024, 16), (8, 8, 1024, 32), (8, 4, 1024, 64), (8, 2, 1024, 128),
                  (8, 1, 1024, 256), (8, 1, 1024, 320), (4, 1, 1024, 512)]
WIDE_SHAPE = (8, 1, 1024, 256)   # the wide kernels' row in the kernels line
WGMMA_SHAPE = (8, 4, 1024, 64)   # the `wgmma` kernel's row in the kernels line
# [headdim]: the generator's walks at these attention_head_dims (64, 8 and 4
# heads at the 256-channel blocks, 16 images in two blocks of 8), each kernel
# vs plain attention within HEADDIM_WALK_TOL (f32 attention outputs 2e-5
# apart at most, carried through 10 DDIM steps of the full UNet under
# full-f32 convolutions: the [tp] and [mesh] walks, held to the same kernel,
# land within 3e-5-5e-5), a bf16 walk at HEADDIM_BF16_WALK (the `wgmma`
# forward), and the train steps at HEADDIM_TRAIN_DIMS
HEADDIM_WALKS = (4, 32, 64, 128, 256)
HEADDIM_WALK_TOL = 1e-3
HEADDIM_BF16_WALK = 128
HEADDIM_TRAIN_DIMS, HEADDIM_TRAIN_STEPS = (32, 128), 3
# a model whose attention blocks are 512 channels wide, at one head of 512:
# its f32 and bf16 walks and its train step, all on the wide kernels
HEADDIM_WIDE = UNet2DConfig(block_out_channels=(128, 256, 512, 512), attention_head_dim=512)
# [kernel-group]: heads_per_program values past what one block holds (the
# wide kernels at 128 and 512 run one head a block), each against G = 1 bit
# for bit, forward (output, lse) and backward, both dtypes
GROUP_EXTRA = [((8, 32, 1024, 8), 16), ((8, 4, 1024, 64), 2), ((8, 2, 1024, 128), 2),
               ((2, 2, 1024, 512), 2)]
TABLE_ROUNDS = 3     # timings in turns, medians
CLI_STEPS, CLI_BATCH = 10, 8
ATTENTION_CALLS_PER_UNET = 6

# backward, per gradient as max|diff| <= tol * max|g|: f32 the tolerance of
# the Pallas backward against autodiff of the einsum path
# (tests/test_pallas_ops.py); bf16 the whole-UNet gradient tolerance there:
# the kernel keeps f32 where the plain version rounds P and ds to bf16.
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# the bf16 tensor-core backward against `attention_bwd_kernel_order`, the
# same maths rounded at the same points, as max|diff| / max|g| per
# gradient: both round the f32 results to bf16, so they may differ by one
# bf16 ulp of the largest gradient (2^-7 = 7.8e-3 of it); the rest, 2.2e-3,
# covers f32 summation order and the rare one-ulp bf16 flips of P or dS
# where the two f32 values straddle a rounding point
BWD_ORDER_TOL = 1e-2
# the forward's base-2 log-sum-exp against its plain version: f32 sums of up
# to T = 1024 terms in another order, T * 2^-24 / ln 2 = 8.8e-5 at worst
LSE_TOL = 1e-4
# the f32 tensor-core forward against `attention_tf32x3_kernel_order` at
# head_dim 8 (`tf32_order_tol` below for the other staged widths), the
# same splits and products in the same order of terms: they differ only where
# f32 rounds, in the tensor cores' accumulation, ex2.approx (2^-22 relative)
# and the order of the f32 row sums, each a few f32 ulps of a weight or a
# logit; randn inputs give |out| < 4, where an ulp is at most 2^-22 = 2.4e-7,
# and 5e-6 allows 20 of them: a fourth of the 2e-5 the kernel is held to
# against the reference (a single TF32 pass misses that by 15-30x)
TF32_ORDER_TOL = 5e-6
# the f32 tensor-core backward against `attention_bwd_tf32x3_kernel_order`,
# the same splits and products with the same per-tile partial sums, as
# max|diff| / max|g| per gradient. They differ where f32 rounds: ex2.approx
# (2^-22 relative) and the exponent's one fma against a double-rounded shift,
# the tensor cores' truncated f32 sums (each add loses under 2^-23 of a
# partial sum, in chains of 3 products for S and dP, which enter the
# exponent as an absolute error of a few 2^-23 |q||k|, and of 24 for a
# tile's dq, dk, dv) and the order of the f32 sums; each is a few 2^-23 of
# the terms of a gradient entry, whose sum of magnitudes is a few times
# max|g| at randn inputs. The order function itself lies about 1e-6 max|g|
# from float64 gradients (CPU, up to T=1024); 1e-5 allows ten times that, a
# fifth of BWD_TOL, which one TF32 pass misses 10-50x
# (tests/test_torch_attention_tf32_bwd.py)
TF32_BWD_ORDER_TOL = 1e-5


def tf32_order_tol(head_dim: int, bwd: bool = False) -> float:
    """The f32 kernels' limits against their rounding orders at any
    head_dim: the limits at head_dim 8 (TF32_ORDER_TOL, TF32_BWD_ORDER_TOL,
    derived above) times sqrt(W / 8), W = `attention.staged_channels` (the
    staged width up to 64 channels, above it the head's 64-channel chunks).
    The products over channels (S, dP) chain W / 8 k-steps of three TF32
    products each before the f32 adds that follow, so W / 8 times as many
    truncated f32 sums enter each logit; a share shared by a row's logits
    cancels in the softmax, and the rest, independent from step to step,
    grows as the square root of the chain. The products that give channels
    (P V, dS K, ...) chain over keys, as at head_dim 8. On the H100 every D
    from 1 to 64 reads about 5e-7 forward and 1e-6 max|g| backward, near
    head_dim 8's own readings."""
    base = TF32_BWD_ORDER_TOL if bwd else TF32_ORDER_TOL
    return base * math.sqrt(attention.staged_channels(head_dim) / 8)
# ragged T (a short last key tile, a short last block of rows), checked in
# both dtypes with the forward's lse and the backward from it, at head_dim 8
# and at head_dims that leave part of the staged width zero (D 5, 12, 40)
RAGGED_SHAPES = [(2, 4, 101, 8), (2, 32, 1000, 8), (2, 4, 101, 5), (2, 8, 77, 12),
                 (2, 2, 130, 40)]
# whole-UNet parameter gradients, per parameter as max|diff| / max|g|. f32
# (full-f32 convolutions): kernel path vs plain attention within 1e-3. bf16
# compute on f32 parameters: every layer rounds to 8 bits of mantissa, and
# the plain path's own gradients lie up to about 1e-1 from the f32 ones at
# batch 4 (median about 4e-2), so kernel vs plain cannot be held to less.
# Instead both bf16 paths are held against the f32 gradients: the kernel
# path's median and worst distance may not exceed the plain path's by more
# than these factors.
UNET_GRAD_TOL = 1e-3
BF16_GRAD_FACTOR = {"median": 1.25, "worst": 1.5}
GRAD_BATCH = 4
TRAIN_IMAGES, TRAIN_EPOCHS, TRAIN_BATCH = 64, 2, 16
TRAIN_STEPS = TRAIN_EPOCHS * (TRAIN_IMAGES // TRAIN_BATCH)
TRAIN_SHAPES = [(TRAIN_BATCH, 32, 1024, 8), (TRAIN_BATCH, 32, 256, 8)]
BENCH_BATCH, BENCH_STEPS = 32, 10
# [distill]: the distillation entry point on a seeded full-width teacher,
# 32 procedural MEL images, batch 16, 16 -> 4 steps (phases 8 and 4) of 8
# optimizer steps each, no eval probe. Per step the teacher's two forwards
# launch K1 without the log-sum-exp (12), the student's forward K1 with it
# (6) and its backward K3 (6); the 4-step student then samples DDIM 4
# trailing at the CLI's batch: 6 x 4 K1. The warm step is timed at
# BENCH_BATCH (DistillConfig's defaults otherwise: clip 1.0, EMA 0.999)
# beside the train step of [bench] at the same batch.
DISTILL_IMAGES, DISTILL_BATCH, DISTILL_START, DISTILL_END, DISTILL_STEPS = 32, 16, 16, 4, 8
DISTILL_PHASES = (8, 4)
DISTILL_WARM_STEPS = 10
# [remat]: measure_train_step for every remat mode at each batch (5 warm
# steps per row, cut from 10 to keep the whole script inside its time; the
# profiler, about 10 s a row, only at the first batch), then one step's
# gradients at full width, batch 4, under
# deterministic cuDNN: every mode's torch.equal to no remat's
REMAT_BATCHES, REMAT_STEPS, REMAT_GRAD_BATCH = (32, 64), 5, 4
# [train-classifier]: the classifier entry point on 8 procedural JPEGs per
# class for the seven classes and their one-hot CSV, 2 epochs of batch 16
# (3 steps each); the exported classifier.pth against a probe batch: the
# XAI classifier's logits (f32 convolutions) torch.equal to an f32
# ResNet18Trainable loaded from the same file, and, where the last epoch was
# the best (the file then holds the final weights), within CLF_BF16_TOL x
# max|logit| of the trained model's own eval-mode logits (bf16
# convolutions: each of the 20 convolutions rounds its inputs and weights
# to 8 bits of mantissa, 2^-9 relative, and BatchNorm rescales each layer)
CLF_IMAGES_PER_CLASS, CLF_EPOCHS, CLF_BATCH, CLF_WARM_STEPS = 8, 2, 16, 10
CLF_BF16_TOL = 2.0 ** -4
CLF_STATE_ENTRIES = 102      # ResNet-18's weights and BatchNorm statistics
# fast math: against its plain version, bf16-level (the kernel and the plain
# version round the weights relative to different maxima); against exact
# attention, the JAX package's own fast-math tolerance
# (tests/test_pallas_ops.py). Exact attention meets both, so the kernel is
# also held to the plain version of its own rounding
# (`attention_fast_math_kernel_order` by the kernel's rule,
# `fast_math_kernel_order`). Both head_dim-8 kernels differ from it only
# where an f32-level difference (the tensor cores' truncating f32 sums in S
# and the tile max, summation order, ex2.approx's 2^-22) meets a bf16
# rounding point: a "flip", rare, but each one moves a weight by a bf16 ulp.
# In bf16 one bf16 ulp of the output, as TOL, a limit both kernels meet. In
# f32 the output keeps those moves: the shifted logit x rounds to bf16 with
# an ulp of at most 2^-7 |x|, so a flip of x moves its weight 2^x by at most
# 2^-7 |x| 2^x ln 2 <= 2^-7 / e, and a flip of the weight's own bf16 rounding
# by one bf16 ulp of it, at most 2^-7 (weights are at most about 1 against
# the running max); either moves output i by at most FLIP_MOVE = 2^-7 times
# max_j |v_j - o_i| / l_i, with l_i the row's weight sum in units of its
# largest weight (`flip_bound`). Each f32 output must lie within FAST_FLIPS
# such moves of the order function. (The CUDA-core kernel of an earlier tree
# formed its logits by f32 fmas, as the order function does, and was held at
# 5e-6; the tensor cores' 3xTF32 logits carry f32-level differences that flip
# a few weights.) On the H100 the fast kernel's worst output reads under half
# of one move, and the exact kernel's, whose weights are not rounded at all,
# 1.4-4 moves, so one move separates them at the sampling shapes and the
# exact kernel must miss it. In both dtypes a second check tells them apart:
# at logits FAST_WIDE_Q times wider (q scaled), where the bf16 rounding of
# the shifted logits weighs more, the mean |diff| of each kernel from the
# fast-math rounding order. The fast kernel differs from it only at the
# flips, a small fraction of the outputs; the exact kernel at every weight by
# the bf16 rounding of its shifted logit (relative 2^-9 |x| ln 2), which
# moves a large share of the outputs. The exact kernel must lie more than
# FAST_SEPARATION times as far as the fast one. On the plain versions
# (tests/test_torch_attention_fast.py), where only the f32 rounding of the
# rescale separates the kernel's walk from the order function, the two are
# orders of magnitude apart; on the card the tensor cores' f32 accumulation
# and ex2.approx add f32-level differences of their own, and the factor 10
# leaves room for them.
FAST_TOL = 1e-2
FAST_VS_EXACT = {"rtol": 0.05, "atol": 0.02}
FAST_ORDER_TOL = {torch.bfloat16: 2.0 ** -6}
FLIP_MOVE, FAST_FLIPS = 2.0 ** -7, 1
FAST_WIDE_Q, FAST_SEPARATION = 8.0, 10.0
# [kernel-fast] timings in turns (exact, fast, sdpa, then reversed), medians
FAST_ROUNDS = 4
GROUP_SHAPE = (8, 32, 1024, 8)       # grouped_attention's own shape
GROUPS = (1, 2, 4, 8)
GEN_IMAGES, GEN_SEED = 16, 1234
GEN_ROUNDS = 3    # [generator-f32-fast]: the warm sampler block, fast and exact in turns
GEN_GROUP = 2     # `--generator`: heads_per_program of the phase run alone (the G* [kernel-group] picks on the H100)
GEN_WARM_ROUNDS = 5   # [generator]: warm generate_images runs, in turns with one block
# [serve]: the daemon at serve's default dtype (bf16, exact kernel), device
# batch 16, DDIM 10 leading (serve's default walk is DDPM 1000: cut to keep
# the run short). Interactive cost 10 puts a b1 DDIM-10 request on the fast
# lane and an 8-image one in bulk; the mixed load is bench_serve.py --mixed:
# a bulk request of SERVE_BULK images at DDIM SERVE_BULK_STEPS (its default
# bulk walk, long enough that the interactive requests arrive while it runs)
# and SERVE_INTERACTIVE b1 requests SERVE_GAP s apart; the fast lane is
# UniPC 8 trailing on the same weights; the XAI request runs the [xai]
# integrated settings (IG 10, SHAP 64)
SERVE_BATCH, SERVE_STEPS, SERVE_COST = 16, 10, 10
SERVE_CLIENTS, SERVE_COUNT, SERVE_SEED = 4, 8, 2024
SERVE_BULK, SERVE_BULK_STEPS, SERVE_INTERACTIVE, SERVE_GAP = 64, 50, 4, 0.2
SERVE_FAST_STEPS, SERVE_WEBUI_IMAGES = 8, 4
REPO = Path(__file__).resolve().parent
# the class-conditional family: the seven ISIC classes plus the null row
COND_CLASSES = ("MEL", "NV", "BCC", "AKIEC", "BKL", "DF", "VASC")
COND_IMAGES = 16                      # procedural images per class, entry-point run
COND_STEPS = len(COND_CLASSES) * COND_IMAGES // TRAIN_BATCH
EVAL_T_POINTS = 8                     # TrainConfig.eval_t_points: probe forwards
COND_LIB_IMAGES = 5                   # per class: 35 images, 2 steps of 16 at G = 2
COND_GROUP = 2
COND_REQUEST = [("MEL", 6), ("NV", 6), ("VASC", 4)]
COND_GUIDANCE, COND_MAP = 3.0, {"MEL": 2.5, "NV": 1.0}
# [host]: the wrappers' host path at the UNet's T=256 call (and T=1024,
# where the device sets the pace): host time per call over HOST_CALLS
# calls, then kernel and SDPA launched from the host in turns, the median
# of HOST_ROUNDS rounds (single runs of the same tree have read 0.0513 and
# 0.0281 ms for one call)
HOST_SHAPES = [(8, 32, 256, 8), (8, 32, 1024, 8)]
HOST_CALLS, HOST_ROUNDS = 1000, 7
# [f32]: K3 and K4 in f32 timed in turns, medians of F32_ROUNDS rounds; the
# backward's two launches split by torch.profiler over F32_PROFILED calls
F32_ROUNDS, F32_PROFILED = 3, 10
SCHEDULER_NAMES = {"ddpm": "DDPM", "ddim": "DDIM", "dpm_solver": "DPM-Solver++(2M)",
                   "dpm_solver_sde": "SDE-DPM-Solver++(2M)", "unipc": "UniPC"}
# [samplers]: bench.py's UNIPC and SDE configurations (20 steps, trailing) at
# the CLI's batch, timed in turns with DDIM at the same steps and spacing
# (medians of SAMPLER_ROUNDS: single walks spread over +-5 ms per step on
# the host clock), each also with an identity eps model, which leaves the
# update, the noise draws and the loop's own host work; the augment run:
# DDIM 10 at strength 0.6 runs round(0.6 x 10) = 6 steps per image
SAMPLER_STEPS, SAMPLER_SPACING, SAMPLER_ROUNDS = 20, "trailing", 7
SAMPLER_KINDS = ("ddim", "unipc", "dpm_solver_sde")
AUGMENT_STEPS, AUGMENT_STRENGTH, AUGMENT_COUNT = 10, 0.6, 2
AUGMENT_RUN = round(AUGMENT_STRENGTH * AUGMENT_STEPS)
# the whole UniPC-20 walk, kernel vs plain attention (full-f32 convolutions,
# the same injected noise), max|diff| of the final images, on both grids.
# Leading (first step t = 950, where the x0 estimate multiplies the eps
# difference by sigma/alpha = 13): held as the DDIM-10 walk of [cli] is, to
# 1e-3 (it reads 3.4e-5 on the H100), times two: UniPC-20 runs twice the UNet
# evaluations, and each x0 difference enters a second time through the next
# step's history term d1 = x0 - x0_prev (weights c_d1 <= 1/2, p_d1 < 1).
# Trailing (bench.py's grid, first step t = 999): there sigma/alpha =
# 1/sqrt(abar_999) = 2.0e4, so the first step turns the two forwards' eps
# difference d0 (itself held to UNET_TOL by [unet]) into an x0 difference of
# up to 2.0e4 d0 on the pixels the clip to [-1, 1] leaves alone. That
# difference is a shift of the walk's data estimate, which the rest of the
# walk carries to the image at a gain of about one; UNIPC_FIRST_STEP_FACTOR
# = 2 leaves as much again for the 19 later evaluations, each amplified far
# less (sigma/alpha <= 13 from t = 949 on). So the trailing walk is held to
# 2 (sigma_0/alpha_0) d0, with d0 measured on the walk's first input.
UNIPC_WALK_TOL, UNIPC_FIRST_STEP_FACTOR = 2e-3, 2.0
# [xai]: the standalone XAI run at the reference defaults (`xai/XAI.py`;
# `synt_isic_tpu/xai/standalone.py`): MEL, seed 42, DDPM 50 keeping every
# 5th step plus the last (11 frames), IG 50 steps, SHAP 512 masks, Grad-CAM
# and sanity on, 1000 bootstraps and 10 000 permutations, on the [cli]
# checkpoint and a classifier.pth of seeded random ResNet-18 weights
# (torchvision's names, 8 outputs, the XAI path's NUM_CLASSES + 1); then
# the library generator's integrated XAI: DDPM 10 on 4 MEL images at
# batch 1, every 2nd image of the class analysed (a short pipeline: IG 10,
# SHAP 64)
XAI_CLASS, XAI_SEED, XAI_STEPS, XAI_SAVE_EVERY = "MEL", 42, 50, 5
XAI_IG_STEPS, XAI_SHAP_SAMPLES, XAI_BOOTSTRAP, XAI_PERMUTATIONS = 50, 512, 1000, 10000
XAI_CLASSIFIER_SEED, XAI_OUTPUTS = 13, 8
XAI_GEN_IMAGES, XAI_GEN_STEPS, XAI_GEN_FREQUENCY = 4, 10, 2
XAI_BATCH1_SHAPES = [(1, 32, 1024, 8), (1, 32, 256, 8)]
# the DDPM-50 walk at batch 1, kernel vs plain attention (full-f32
# convolutions, the same injected initial noise and the same seed-derived
# step noise), max|diff| over every kept frame: [cli] holds its DDIM-10 walk
# to 1e-3, 1e-4 per UNet evaluation (it reads 3.4e-5); the DDPM-50 walk runs
# 50 evaluations, so 5e-3. The DDPM posterior mean weighs each step's x0
# estimate by at most one and clips it to [-1, 1], so no step amplifies an
# eps difference as the trailing grid's t = 999 step does in [samplers].
XAI_WALK_TOL = 5e-3
# the pipeline on the card (full-f32 convolutions) against the CPU port on
# the same frames, at the CPU tests' tolerances (tests/test_torch_xai*.py):
# attribution maps 1e-4 x max|map|, Time-SHAP's probabilities and
# log-probability scores 1e-5 (its min-max-normalised importance at the
# bound that carries, see `_xai_compare`), Grad-CAM 1e-3, CFI 1e-5 where
# both top/bottom-k masks agree, the sanity checks' correlations 1e-4
# (their draws come from the same CPU generators on both sides)
XAI_TOL = {"attribution": 1e-4, "time_shap": 1e-5, "gradcam": 1e-3, "cfi": 1e-5,
           "sanity": 1e-4}
# that comparison runs IG and SHAP cut from the standalone run's 50 steps and
# 512 masks (the CPU port took 127 s of the phase at those; every stage and
# every bound stays): the same cut on both sides
XAI_CMP_IG_STEPS, XAI_CMP_SHAP_SAMPLES = 10, 64
# [mesh]: the library ShardedSampler on MESH_SEEDS seeds (5 on 2 shards: one
# pad row) at DDIM 10, f32, full-f32 convolutions and deterministic cuDNN,
# held to the unsharded walk: a shard of 3 and the batch of 5 pick their own
# convolution algorithms, whose f32 sums differ in order only. [cli] holds
# the kernel-vs-plain attention walk (DDIM 10, batch 8) to 1e-3; a batch
# composition changes far less than the attention route, so the same 1e-3.
# The dp train step: MESH_TRAIN_BATCH rows (the [bench] batch) in f32 on
# [cuda:0, cuda:0], MESH_MIXED_TRAIN_BATCH on [cuda:0, cpu] (the CPU's rows
# of the full-width UNet take seconds each), against one device at the
# same batch, from the same weights and draws. The loss
# and the reduced gradients are equal up to the order of the sum: the loss
# within MESH_LOSS_RTOL, each leaf's gradient within MESH_GRAD_TOL x its
# largest magnitude where every shard runs on a card; a CPU shard runs the
# plain attention, so a mesh with one is held at UNET_GRAD_TOL, the bound
# of the kernel path's gradients against the plain path's. The attention
# key biases' gradient is zero in exact arithmetic (softmax ignores a shift
# shared by every key), so theirs is rounding alone and is held to the
# same factor of the step's largest gradient. Adam's first step moves a
# weight by u(g) = lr g / (|g| + eps) whatever the scale of g, so the
# weights after it are held to what the two runs' gradients predict:
# |(w_mesh - w_one) + u(g_mesh) - u(g_one)| within MESH_ADAM_TOL (f32
# rounding of the weights is below 1e-7). After the step every replica is
# torch.equal to the primary. `train --dp-mesh` takes 2 steps of
# TRAIN_BATCH on MESH_TRAIN_IMAGES procedural images.
# The [cuda:0, cpu] mesh has two distinct devices, so it runs what one card
# alone never does: a replica rebuilt with the CPU's switches (plain
# attention, f32 GroupNorm), a thread per device, the cross-replica
# gradient sum and the weights copied back. Its XAI fan-out (IG, patch-SHAP,
# Time-SHAP, Grad-CAM, fairness scores on MESH_XAI_FRAMES frames) is held,
# row by row, to what the row's device gives without a mesh (the analyzer
# on the card, or on a CPU copy of the classifier with the same draws), at
# [xai]'s bounds: the card and the CPU themselves differ by more on IG at
# few steps over noise frames, where f32 rounding flips ReLU gates.
MESH_SEEDS, MESH_MIXED_SEEDS, MESH_WALK_TOL = 5, 2, 1e-3
MESH_TRAIN_BATCH, MESH_MIXED_TRAIN_BATCH, MESH_TRAIN_IMAGES = 32, 4, 32
MESH_LOSS_RTOL, MESH_GRAD_TOL, MESH_ADAM_TOL = 1e-5, 1e-4, 1e-6
MESH_XAI_FRAMES, MESH_XAI_IG_STEPS, MESH_XAI_SHAP_SAMPLES = 3, 8, 16
# [tp]: tensor parallelism over ('data', 'model') meshes whose devices all
# repeat cuda:0: one card holds the port to the unsharded results, but
# shows no speed-up (each sharded layer runs T products where one ran, and
# attention T launches on H/T heads; the copies between cards are none
# here). TP_SEEDS MEL seeds at DDIM 10 (CLI_STEPS), f32, exact kernel, on
# [unet]'s seeded full-width UNet: the 1 x 2 mesh launches K1 6 x 2 x 10 =
# 120 times, each at 32 / 2 = 16 heads; the 2 x 2 mesh walks 2 rows of 4
# seeds, 6 x 2 x 2 x 10 = 240 launches at 16 heads. Under full-f32
# convolutions (and deterministic cuDNN) each walk, every captured frame,
# is held to the unsharded one within MESH_WALK_TOL, [mesh]'s bound for a
# data-parallel walk: a sharded convolution or projection forms the same
# sums over fewer output channels, so only the algorithm cuDNN and cuBLAS
# pick for the narrower product can change their order, as a batch
# composition does. Under the default TF32 convolutions the distance is
# printed, not held. bf16 with fast math at heads_per_program 2: the same
# 120 launches, all fast-math and grouped (16 heads per shard, G = 2). The
# library generator over the 1 x 2 mesh writes MEL:8 in one block (120
# launches; sidecars record dp_mesh 2 = the mesh's devices, as the JAX
# generator does), and a GenerationServer over it answers status and two
# bulk generates of 3 and 2 images (one walk each: 240 launches). One f32
# train step at MESH_TRAIN_BATCH and the standalone XAI run (its
# defaults) on the 1 x 2 mesh are held to no mesh at [mesh]'s bounds: both
# replicate over 'model', so their data shard is the whole batch on cuda:0.
TP_SEEDS = 8
TP_MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2}}
TP_WANT = {"1x2": 120, "2x2": 240}
TP_HEADS = 16
TP_SHAPES = [(8, 16, 1024, 8), (8, 16, 256, 8)]
TP_SERVE_COUNTS = (3, 2)
TP_ROUNDS = 3     # walks timed in turns, medians
# [tp] rows over the card and the CPU (the copies between distinct devices,
# which rows that repeat cuda:0 never make): {data 1, model 2} with the
# activations on the card, then on the CPU, MESH_MIXED_SEEDS seeds at DDIM
# 10, f32, exact kernel, full-f32 convolutions, against the unsharded walk
# within MESH_WALK_TOL. Only the card's shard launches K1, 6 x 10 = 60 per
# walk at 16 heads; the CPU's shard runs the plain version on its 16.
TP_MIXED_ROWS = {"[cuda:0, cpu]": ["cuda:0", "cpu"], "[cpu, cuda:0]": ["cpu", "cuda:0"]}
TP_MIXED_WANT = ATTENTION_CALLS_PER_UNET * CLI_STEPS
XAI_RESULT_KEYS = {"metadata", "xai_maps", "region_analysis", "interventions",
                   "cfi_analysis", "time_shap", "statistical_validation", "sanity_checks",
                   "visualizations", "gradcam", "gradcam_most_important", "gradcam_summary"}
# [eval]: image-set evaluation. eval_fid's generator samples EVAL_IMAGES
# 128² MEL images at DDIM EVAL_STEPS in blocks of 64 (6 K1 launches per
# step and block); Inception-v3 (a seeded random inception_v3.pth in
# torchvision's names) extracts them at EVAL_BATCH, the default batch, and
# EVAL_HOLD of them are held to the CPU port within INCEPTION_CARD_TOL x
# max|feature| (two f32 convolution algorithms over ~20 sequential
# convolutions, the classifier's bound in tests/test_torch_gpu.py); the
# first two EVAL_FID_SET-image slices are the two sets `compute_fid`
# compares, card against CPU, with each extractor. parity_gauntlet runs on
# two full-width classes at GAUNTLET_SAMPLES images each, DDIM EVAL_STEPS,
# bf16: one walk per block of smoke samples (2), per reproduced sidecar
# (2), the XAI image (1) and each FID set of max(16, 4 x samples) images
# in one block (2). e2e_loop is cut to 128², quarter width, 32 training
# images, 2 epochs of 16 (4 steps, each 6 K1 + 6 K3; the eval probe at the
# last epoch runs eval_t_points = 8 forwards), 8 samples per sampler at
# DDIM 10 and DPM-Solver++ 5 (one raw and one post-processed run each) and
# one DDIM-10 XAI trajectory; its classifier trains 8 epochs on 3 x 64
# procedural images (run_loop's defaults; no UNet launch).
EVAL_IMAGES, EVAL_BATCH, EVAL_STEPS, EVAL_HOLD, EVAL_FID_SET = 64, 32, 10, 4, 16
EVAL_NV_SEED, EVAL_CLASSIFIER_SEED, EVAL_INCEPTION_SEED = 5, 3, 0
INCEPTION_CARD_TOL = 1e-4
GAUNTLET_SAMPLES = 2
GAUNTLET_LAUNCHES = ATTENTION_CALLS_PER_UNET * EVAL_STEPS * (2 + 2 + 1 + 2)
E2E_TRAIN_STEPS, E2E_DDIM, E2E_DPM = 4, 10, 5
E2E_ARGS = ["--size", "128", "--width", "quarter", "--train-images", "32", "--heldout", "32",
            "--epochs", "2", "--batch", "16", "--sample-count", "8", "--ddim-steps",
            str(E2E_DDIM), "--dpm-steps", str(E2E_DPM), "--seed", "0", "--device", "cuda"]
E2E_FWD_LAUNCHES = ATTENTION_CALLS_PER_UNET * (E2E_TRAIN_STEPS + EVAL_T_POINTS + 2 * E2E_DDIM
                                               + 2 * E2E_DPM + E2E_DDIM)
E2E_BWD_LAUNCHES = ATTENTION_CALLS_PER_UNET * E2E_TRAIN_STEPS
E2E_KEYS = {"class", "size", "width", "train_images", "epochs", "train_fused", "train",
            "classifier", "timestep_spacing", "fast_scheduler", "sample_ddim", "sample_dpm",
            "xai", "fid_pixel", "fid_proxy", "fid_extractor", "quality_bar",
            "model_converged", "sampler_within_bar", "converged"}

# [score]: the quality ladders and the per-class family through their entry
# points, at full width (`UNet2DConfig()`, 128²) in bf16 unless stated, each
# cut in depth and count (PERF.md §4). K1 per UNet evaluation is
# ATTENTION_CALLS_PER_UNET, at every block of every walk, the warm passes of
# `ladder_common.score_rung` (one block of the same size) included.
#  * train_family over SCORE_CLASSES, SCORE_FAMILY_IMAGES procedural images
#    a class, 1 epoch of SCORE_FAMILY_BATCH: per class 2 steps (6 K1 + 6 K3
#    each) and the eval probe at the last epoch (EVAL_T_POINTS forwards);
#    a second call skips both classes: no launch, checkpoints unchanged;
#  * score_family: the probe (SCORE_PROBE_IMAGES a class, 1 epoch) runs no
#    UNet; each class one DDIM-SCORE_STEPS walk of SCORE_COUNT images;
#    rescore_family_consistency --skip-probe runs no UNet;
#  * score_checkpoint --flagship, ddim:SCORE_STEPS:trailing, SCORE_COUNT
#    images at batch SCORE_COUNT: a warm and a timed walk a row, the exact
#    row K1, the --ab-fast-math row K1-fast only; --heads-per-program 2
#    one row of K1 at G = 2 (every launch grouped);
#  * sampler_ladder --width full, one rung per scheduler (SCORE_LADDER) at
#    SCORE_LADDER_COUNT images: a warm and a timed walk a rung, UniPC and
#    DDPM taking one UNet evaluation a step as the others do;
#  * distill_ladder --width full, 8 -> 4 at 2 steps a phase of batch
#    SCORE_DISTILL_BATCH: per step two teacher forwards and the student's (18
#    K1) and its backward (6 K3); then the teacher at DDIM 8 and 4 and the
#    student at 4, warm and timed walks of SCORE_LADDER_COUNT images;
#  * augment_eval --width full (f32, the JAX script's manager default),
#    SCORE_LADDER_COUNT sources at DDIM SCORE_AUGMENT_STEPS trailing: the
#    strengths 0.2-1.0 walk round(s x 10) = 2+4+6+8+10 steps, the plain rung
#    10, the diversity probe (32 seeds at 0.6) 6, the inpaint rung 10;
#  * e2e_conditional --width full over SCORE_COND_CLASSES, SCORE_COND_IMAGES
#    images a class, 1 epoch of SCORE_COND_BATCH (3 steps), the probe's
#    EVAL_T_POINTS forwards, guidance 1 and 3 over SCORE_LADDER_COUNT samples
#    a class at DDIM SCORE_STEPS in mixed blocks of SCORE_LADDER_COUNT (one
#    forward a step at 2B when guided).
# The held-out sets are cut to SCORE_HELDOUT images (default 128), the
# classifier judges to SCORE_PROBE_IMAGES a class; the warm steps of the
# family recipe (batch SCORE_FAMILY_BATCH) and of the ladder's distillation
# (batch SCORE_DISTILL_BATCH) are timed over SCORE_WARM_STEPS steps, and
# one more step of each is profiled.
SCORE_CLASSES, SCORE_COND_CLASSES = ("MEL", "NV"), ("MEL", "NV", "VASC")
SCORE_FAMILY_IMAGES, SCORE_FAMILY_BATCH, SCORE_PROBE_IMAGES = 32, 16, 16
SCORE_COUNT, SCORE_STEPS, SCORE_HELDOUT, SCORE_LADDER_COUNT = 16, 10, 32, 8
SCORE_LADDER = (("ddim", 10, "trailing"), ("dpm_solver", 10, "trailing"),
                ("unipc", 8, "trailing"), ("dpm_solver_sde", 10, "trailing"), ("ddpm", 20))
SCORE_DISTILL_BATCH, SCORE_DISTILL_IMAGES, SCORE_AUGMENT_STEPS = 8, 16, 10
SCORE_COND_IMAGES, SCORE_COND_BATCH, SCORE_GUIDANCE = 16, 16, (1.0, 3.0)
# (the trace of one eager step takes seconds to read: one profiled step)
SCORE_WARM_STEPS, SCORE_PROFILED_STEPS = 5, 1
SCORE_FAMILY_STEPS = SCORE_FAMILY_IMAGES // SCORE_FAMILY_BATCH
# [app]: the window's run (its config's generation.batch_size, so MEL:8 is
# one block), its integrated-XAI run (one block of 4 in trajectory mode:
# block_cap = min(8, 4 GiB / (10 x 128^2 x 3 x 4 B)) = 8), with [xai]'s
# short integrated pipeline; smoke_generate; warm_cache at the production
# batch of 128 (serve's) with fewer steps, each config walked cold and warm
APP_BATCH, APP_STEPS, APP_IMAGES, APP_XAI_IMAGES, APP_XAI_FREQUENCY = 8, 10, 8, 4, 2
APP_XAI_RUN = dict(verbose=False, ig_n_steps=10, shap_n_samples=64, n_bootstrap=200,
                   n_permutations=1000, viz_every_n=5)
APP_SMOKE_SAMPLES, APP_SMOKE_STEPS = 4, 20
APP_WARM_CONFIGS = ("ddim:10:128", "dpm_solver:10:128", "ddpm:20:8")
APP_WARM_CLASSIFIER_BATCHES = (64, 256)
# the window's standalone XAI command, and the wrapper that runs the same
# module's main() with the figures off where matplotlib is missing
APP_STANDALONE_ARGV = ["-u", "-m", "synt_isic_tpu_torch.xai.standalone"]
APP_STANDALONE_NO_FIGURES = (
    "import functools, sys\n"
    "from synt_isic_tpu_torch.xai import standalone\n"
    "standalone.run_standalone_xai = functools.partial(standalone.run_standalone_xai, "
    "save_figures=False)\n"
    "sys.exit(standalone.main())\n")
# K1 launches of each entry point, read from the code: 6 per UNet
# evaluation of a block
APP_WANT = {
    "window": ATTENTION_CALLS_PER_UNET * APP_STEPS,
    "window_reproduce": ATTENTION_CALLS_PER_UNET * APP_STEPS,
    "window_xai": ATTENTION_CALLS_PER_UNET * APP_STEPS,
    "smoke_generate": ATTENTION_CALLS_PER_UNET * APP_SMOKE_STEPS,
    "warm_cache": 2 * ATTENTION_CALLS_PER_UNET * sum(int(c.split(":")[1])
                                                     for c in APP_WARM_CONFIGS),
}
SCORE_COND_STEPS = len(SCORE_COND_CLASSES) * SCORE_COND_IMAGES // SCORE_COND_BATCH
SCORE_AUGMENT_EVALS = sum(max(1, round(s * SCORE_AUGMENT_STEPS))
                          for s in (0.2, 0.4, 0.6, 0.8, 1.0, 1.0, 0.6, 1.0))
# (UNet evaluations, UNet backward passes) of each entry point, read from the
# code: x ATTENTION_CALLS_PER_UNET they are its K1 (or K1-fast) and K3 launches
SCORE_WANT = {
    "train_family": (len(SCORE_CLASSES) * (SCORE_FAMILY_STEPS + EVAL_T_POINTS),
                     len(SCORE_CLASSES) * SCORE_FAMILY_STEPS),
    "train_family_again": (0, 0),
    "score_family": (len(SCORE_CLASSES) * SCORE_STEPS, 0),
    "rescore_family_consistency": (0, 0),
    "score_checkpoint_ab_fast_math": (2 * 2 * SCORE_STEPS, 0),
    "score_checkpoint_heads_per_program_2": (2 * SCORE_STEPS, 0),
    "sampler_ladder": (2 * sum(r[1] for r in SCORE_LADDER), 0),
    "distill_ladder": (3 * 2 + 2 * (8 + 4 + 4), 2),
    "augment_eval": (SCORE_AUGMENT_EVALS, 0),
    "e2e_conditional": (SCORE_COND_STEPS + EVAL_T_POINTS + len(SCORE_GUIDANCE) * SCORE_STEPS
                        * math.ceil(len(SCORE_COND_CLASSES) * SCORE_LADDER_COUNT
                                    / SCORE_LADDER_COUNT), SCORE_COND_STEPS),
}
# the report keys of the JAX scripts (tests/test_torch_ladders.py,
# test_torch_family.py and test_torch_e2e_conditional.py cite their lines)
SCORE_KEYS = {
    "score_checkpoint": {"checkpoints", "class", "size", "count", "variant",
                         "floor_train_vs_heldout", "ceiling_noise_vs_heldout", "rows"},
    "sampler_ladder": {"class", "size", "count", "checkpoints", "floor_train_vs_heldout",
                       "floor_train_n_vs_heldout", "ceiling_noise_vs_heldout", "rungs",
                       "headline", "headline_rule"},
    "distill_ladder": {"class", "size", "count", "teacher", "timestep_spacing",
                       "steps_per_phase", "distill_wall_s", "floor_train_vs_heldout",
                       "floor_train_n_vs_heldout", "ceiling_noise_vs_heldout", "rungs"},
    "augment_eval": {"class", "size", "count", "steps", "timestep_spacing", "anchors",
                     "strength_sweep", "plain_generation_frechet", "diversity",
                     "inpaint_center_box"},
    "train_family": {"config", "classes", "family_complete"},
    "score_family": {"checkpoints_dir", "classes", "size", "width", "count", "steps", "seed",
                     "started", "probe", "per_class", "family_converged",
                     "family_consistent_absolute", "probe_competent"},
    "rescore_family_consistency": {"checkpoints_dir", "classes", "probe", "merged_from",
                                   "note", "rescored", "per_class", "family_converged",
                                   "family_consistent_absolute", "probe_competent"},
    "e2e_conditional": {"classes", "size", "width", "clf_hard", "epochs",
                        "train_images_per_class", "guidance_scales", "train_fused", "train",
                        "classifier", "anchors", "results", "best_guidance",
                        "conditional_ok", "per_class_best_guidance",
                        "consistent_absolute_all", "probe_competent_all"},
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def full_f32_convolutions():
    """cuDNN convolutions in full f32 (no TF32) inside the block."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20) -> float:
    """Mean device time of one call of `fn`, `calls` calls captured in a
    CUDA graph and replayed, so that no host work (the wrapper's checks,
    allocation, the launch itself) sits between the kernels: the time the
    card takes, where `cuda_ms` of a short kernel measures the host."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                 # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, iters=5, warmup=1) / calls
    del graph
    return ms


def _largest_bound(bytes_ms: float, ops_ms: float, exp_ms: float) -> tuple[float, str, str]:
    """(bound ms, "bytes" or "operations", what sets it): the largest of
    the bytes over the memory rate, the products over the dtype's peak and
    one exponential per (i, j) on the special-function units."""
    bound, unit = max((bytes_ms, "bytes"), (ops_ms, "products"), (exp_ms, "exponentials"))
    return bound, ("bytes" if unit == "bytes" else "operations"), unit


def attention_bound_ms(shape, dtype) -> tuple[float, str, float, str]:
    """(bound ms, "bytes" or "operations", exponential ms, what sets the
    bound) for one attention call: q, k, v read once and out written once;
    2 contractions of 2*B*H*T^2*D flops each at the dtype's peak; B*H*T^2
    exponentials."""
    b, h, t, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    exp_ms = b * h * t * t / SFU_EXP_PER_S * 1e3
    bound, bound_by, unit = _largest_bound(4 * b * h * t * d * itemsize / PEAK_BYTES_PER_S * 1e3,
                                           4 * b * h * t * t * d / PEAK_FLOPS[dtype] * 1e3, exp_ms)
    return bound, bound_by, exp_ms, unit


def attention_bwd_bound_ms(shape, dtype) -> tuple[float, str, float, str]:
    """(bound ms, "bytes" or "operations", exponential ms, what sets the
    bound) for one backward call: q, k, v, do read once and dq, dk, dv
    written once; the 5 T x T contractions of 2*B*H*T^2*D flops each at the
    dtype's peak; one pass of B*H*T^2 exponentials (the probabilities must
    be rebuilt at least once; the bf16 kernels take two passes)."""
    b, h, t, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    exp_ms = b * h * t * t / SFU_EXP_PER_S * 1e3
    bound, bound_by, unit = _largest_bound(7 * b * h * t * d * itemsize / PEAK_BYTES_PER_S * 1e3,
                                           10 * b * h * t * t * d / PEAK_FLOPS[dtype] * 1e3, exp_ms)
    return bound, bound_by, exp_ms, unit


def reset_launches() -> None:
    for key in attention.LAUNCHES:
        attention.LAUNCHES[key] = 0


def phase_card() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    return {"card": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# the tensor-core kernels (bf16, and f32 in 3xTF32; the forward exact and
# fast math): instances per source. The `mma.sync` templates run at the
# staged widths 16, 32 and 64 with every G of GROUPS where G * Dp <=
# MAX_GROUP_WIDTH (the Wide instances), and at G = 1 at every width up to 64
# for the general staging (the bf16 forward at Dp 8 only); head dim 8 at
# full width runs the `_d8` kernels at every G; the bf16 forward at Dp 16 to
# 256 runs the `wgmma` kernel (exact and fast math, TMA and `cp.async`
# staging), and heads wider than 64 (the bf16 forward: 256) the wide kernels
# at WIDE_CHUNKS
MMA_WIDTHS = tuple(w for w in attention.STAGED_WIDTHS if w <= attention.MAX_GROUP_WIDTH)
# the wide kernels' channel groups of NC chunks of 64: the forward in f32 at
# each and in bf16 (above 256 channels) at 8, exact and fast math; the dq
# launch at each, the dk/dv launch at 2 and 4, in both dtypes
WIDE_CHUNKS = (2, 4, 8)
WGMMA_WIDTHS = tuple(w for w in attention.STAGED_WIDTHS if w >= 16)
_WIDE = sum(1 for w in MMA_WIDTHS[1:] for g in GROUPS if g * w <= attention.MAX_GROUP_WIDTH)
_TEMPLATES = _WIDE + len(MMA_WIDTHS)
TC_KERNELS = {attention.KERNEL: {"attention_fwd_tc_kernel": 2,
                                 "attention_fwd_tf32_kernel": 2 * _TEMPLATES,
                                 "attention_fwd_tc_d8_kernel": 2 * len(GROUPS),
                                 "attention_fwd_tf32_d8_kernel": 2 * len(GROUPS),
                                 "attention_fwd_wgmma_kernel": 4 * len(WGMMA_WIDTHS),
                                 "attention_fwd_wide_kernel": 2 * (len(WIDE_CHUNKS) + 1)},
              attention.BWD_KERNEL: {**{f"attention_bwd_{k}_kernel": _TEMPLATES
                                        for k in ("dq_tc", "dkdv_tc", "dq_tf32", "dkdv_tf32")},
                                     **{f"attention_bwd_{k}_d8_kernel": len(GROUPS)
                                        for k in ("dq_tc", "dkdv_tc", "dq_tf32", "dkdv_tf32")},
                                     "attention_bwd_dq_wide_kernel": 2 * len(WIDE_CHUNKS),
                                     "attention_bwd_dkdv_wide_kernel": 2 * (len(WIDE_CHUNKS) - 1)}}


def _product_op(kernel: str) -> str:
    """The product instruction a kernel instance's SASS must hold: HGMMA in
    the `wgmma` forward and in the wide kernels' bf16 instances, HMMA in
    every other."""
    if kernel.startswith("attention_fwd_wgmma_kernel<") or (
            "_wide_" in kernel and "bfloat16" in kernel):
        return "HGMMA"
    return "HMMA"

# the kernel's own name follows its length in the mangled name (after the
# anonymous namespace, which names the source file)
_KERNEL_NAME = re.compile(r"(?<=\d)(attention_[a-z0-9_]+?(?:tf32_)?kernel)(I\w*?E)Ev")


def _kernel_label(mangled: str) -> str:
    """`name<args>` from a mangled kernel name, e.g. attention_fwd_tc_kernel<2, true>."""
    found = _KERNEL_NAME.search(mangled)
    if not found:
        return mangled
    args = re.findall(r"Li(\d+)E|Lb([01])E|13__nv_(bfloat16)|(f)", found.group(2)[1:-1])
    words = [i or {"0": "false", "1": "true"}.get(b, "") or t or "float" for i, b, t, _ in args]
    return f"{found.group(1)}<{', '.join(words)}>"


def phase_build() -> dict:
    t0 = time.time()
    names = [attention.KERNEL, attention.BWD_KERNEL]
    logs = native.build(names)
    build_s = time.time() - t0
    instances = sum(log.count("Compiling entry function") for log in logs.values())
    print(f"[build] {', '.join(names)} in {build_s:.1f} s: {instances} kernel instances "
          f"(want {sum(sum(v.values()) for v in TC_KERNELS.values())} on the tensor cores)",
          flush=True)
    cuobjdump = Path(native._nvcc()).with_name("cuobjdump")
    spilled = []
    report = {"sass": {}, "registers": {}}
    for name in names:
        kernel = ""
        for line in logs.get(name, "").splitlines():
            if "Compiling entry function" in line:
                kernel = _kernel_label(line)
            if "registers" in line or "spill" in line:
                print(f"[build]   {name}: {kernel}: {line.strip()}", flush=True)
            used = re.search(r"Used (\d+) registers", line)
            if used and (kernel.startswith("attention_fwd_wgmma_kernel") or "_wide_" in kernel):
                report["registers"][kernel] = int(used.group(1))
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if (spills and kernel.split("<")[0] in TC_KERNELS[name]
                    and not spills.group(1) == spills.group(2) == "0"):
                spilled.append(f"{kernel}: {line.strip()}")
    for name in names:
        # the head_dim-8 tensor-core kernels run their products there
        sass = subprocess.run([str(cuobjdump), "-sass", str(native.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts, kernel = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                kernel = _kernel_label(line.split("Function :")[1].strip())
                counts[kernel] = {"HMMA": 0, "HGMMA": 0, "MUFU.EX2": 0}
            elif kernel is not None:
                for op in counts[kernel]:
                    counts[kernel][op] += f"{op} " in line or f"{op}." in line
        for label, want in TC_KERNELS[name].items():
            found = {k: c for k, c in counts.items() if k.startswith(label + "<")}
            check(len(found) == want and all(c[_product_op(k)] > 0 for k, c in found.items()),
                  f"[build] HMMA or HGMMA missing in {label} (want {want} instances): {found}; "
                  f"the SASS of {name} holds {sorted(counts)}")
            for k, c in sorted(found.items()):
                print(f"[build]   SASS of {k}: {c['HMMA']} HMMA, {c['HGMMA']} HGMMA, "
                      f"{c['MUFU.EX2']} MUFU.EX2", flush=True)
                report["sass"][k] = c
    check(not spilled, f"[build] tensor-core kernels spill: {spilled}")
    return {"build_s": build_s, "instances": instances, **report}


def phase_kernel() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    # the CFG sampler's 2B-batched forward gives batch 16 (checked, not timed)
    shapes = MAIN_SHAPES + TRAIN_SHAPES + RAGGED_SHAPES + [(2, 4, 64, 4)] + HEADDIM_SHAPES
    report = {}
    for shape in shapes:
        b, h, t, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            want = attention.attention_reference(q, k, v).float()
            # the f32 tensor-core kernel's own rounding (3xTF32, max per tile)
            order = (attention.attention_tf32x3_kernel_order(q, k, v)
                     if dtype == torch.float32 else None)
            # contiguous (B, H, T, D), and the (B, T, C) projection layout
            # split into heads by a view, as the UNet hands it over
            btc = [z.transpose(1, 2).reshape(b, t, h * d) for z in (q, k, v)]
            views = [z.view(b, t, h, d).transpose(1, 2) for z in btc]
            for layout, args in (("BHTD", (q, k, v)), ("BTC", views)):
                got = attention.fused_attention(*args)
                torch.cuda.synchronize()
                check(got.stride() == args[0].stride(), f"{layout} output strides")
                err = (got.float() - want).abs()
                max_abs = err.max().item()
                max_rel = (err / want.abs().clamp_min(1e-3)).max().item()
                tol = TOL[dtype]
                ok = torch.allclose(got.float(), want, rtol=tol, atol=tol)
                print(f"[kernel] {shape} {str(dtype)[6:]:8s} {layout}: max_abs_err "
                      f"{max_abs:.3e} max_rel_err {max_rel:.3e} (atol=rtol={tol:.3g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"attention kernel disagrees with plain at {shape} {dtype} {layout}")
                report[(shape, dtype, layout)] = max_abs
                if order is not None:
                    order_err = (got - order).abs().max().item()
                    print(f"[kernel]   vs attention_tf32x3_kernel_order: max_abs_err "
                          f"{order_err:.3e} (allowed {tf32_order_tol(d):.1e})", flush=True)
                    check(order_err <= tf32_order_tol(d),
                          f"f32 kernel vs its rounding order at {shape} {layout}")
                    report[(shape, dtype, layout, "order")] = order_err
                # the kernels' log-sum-exp, and the output unchanged by
                # writing it
                out, lse = attention.fused_attention(*args, with_lse=True)
                lse_err = (lse - attention.attention_lse_reference(q, k)).abs().max().item()
                print(f"[kernel]   with lse: output torch.equal {torch.equal(out, got)}, "
                      f"lse max_abs_err {lse_err:.3e} (allowed {LSE_TOL:.0e})", flush=True)
                check(torch.equal(out, got) and lse_err <= LSE_TOL,
                      f"forward lse at {shape} {layout}")
            if shape in MAIN_SHAPES:
                kernel_ms = cuda_ms(lambda: attention.fused_attention(*views))
                device_ms = graph_ms(lambda: attention.fused_attention(*views))
                plain_ms = cuda_ms(lambda: attention.attention_reference(q, k, v))
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                library_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                bound, bound_by, exp_ms, unit = attention_bound_ms(shape, dtype)
                print(f"[time] attention {shape} {str(dtype)[6:]}: kernel {kernel_ms:.4f} ms "
                      f"({device_ms:.4f} ms on the device alone, from a CUDA graph), plain "
                      f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms ({library_device_ms:.4f} "
                      f"from a graph), bound {bound:.4f} ms ({unit}), exponentials on the "
                      f"SFUs {exp_ms:.4f} ms", flush=True)
                report[(shape, dtype, "time")] = dict(
                    ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms,
                    library_ms=library_ms, library_device_ms=library_device_ms,
                    bound_ms=bound, bound_by=bound_by)
    report["table"] = kernel_table_times()
    return report


def phase_kernel_bwd() -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    report = {}
    for shape in TRAIN_SHAPES + RAGGED_SHAPES + [(2, 4, 64, 4)] + HEADDIM_SHAPES:
        b, h, t, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                           for _ in range(4))
            want = attention.attention_bwd_reference(q, k, v, do)
            views = [z.transpose(1, 2).reshape(b, t, h * d).view(b, t, h, d).transpose(1, 2)
                     for z in (q, k, v, do)]
            for layout, args in (("BHTD", (q, k, v, do)), ("BTC", views)):
                got = attention.fused_attention_bwd(*args)
                torch.cuda.synchronize()
                worst, max_abs = 0.0, 0.0
                for name, a, w, src in zip(("dq", "dk", "dv"), got, want, args):
                    check(a.stride() == src.stride(), f"{layout} {name} strides")
                    err = (a.float() - w.float()).abs().max().item()
                    worst = max(worst, err / w.float().abs().max().item())
                    max_abs = max(max_abs, err)
                ok = worst <= BWD_TOL[dtype]
                print(f"[kernel-bwd] {shape} {str(dtype)[6:]:8s} {layout}: max_abs_err "
                      f"{max_abs:.3e}, worst max|diff|/max|g| {worst:.3e} (allowed "
                      f"{BWD_TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"attention backward kernel disagrees with plain at "
                          f"{shape} {dtype} {layout}")
                report[(shape, dtype, layout)] = max_abs
                report[(shape, dtype, layout, "order")] = check_bwd_from_stats(shape, args)
            if shape in TRAIN_SHAPES:
                kernel_ms = cuda_ms(lambda: attention.fused_attention_bwd(*views))
                plain_ms = cuda_ms(lambda: attention.attention_bwd_reference(q, k, v, do),
                                   iters=5)
                leaves = [z.detach().requires_grad_() for z in (q, k, v)]

                def fwd_bwd(fn):
                    return lambda: torch.autograd.grad(fn(*leaves), leaves, do)

                pair_ms = cuda_ms(fwd_bwd(attention.fused_attention_trainable))
                library_ms = cuda_ms(fwd_bwd(F.scaled_dot_product_attention), iters=5)
                plain_pair_ms = cuda_ms(fwd_bwd(attention.attention_reference), iters=5)
                # SDPA's backward alone, on a prebuilt forward
                out = F.scaled_dot_product_attention(*leaves)
                library_bwd_ms = cuda_ms(
                    lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=5)
                bound, bound_by, exp_ms, unit = attention_bwd_bound_ms(shape, dtype)
                times = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                             fwd_bwd_ms=pair_ms, plain_fwd_bwd_ms=plain_pair_ms,
                             library_bwd_ms=library_bwd_ms, bound_ms=bound,
                             bound_by=bound_by, exp_ms=exp_ms)
                # the two launches K4 runs, from the forward's statistics
                o, lse = attention.fused_attention(*views[:3], with_lse=True)
                times["from_stats_ms"] = cuda_ms(
                    lambda: attention.fused_attention_bwd(*views, o=o, lse=lse))
                extra = (f"from saved statistics {times['from_stats_ms']:.4f} ms, "
                         f"standalone (with its statistics launch) ")
                print(f"[time] attention backward {shape} {str(dtype)[6:]}: kernel {extra}"
                      f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward alone "
                      f"{library_bwd_ms:.4f} ms, bound {bound:.4f} ms ({unit}), one pass "
                      f"of exponentials on the SFUs {exp_ms:.4f} ms; forward+backward "
                      f"through autograd: kernels {pair_ms:.4f} ms, plain "
                      f"{plain_pair_ms:.4f} ms, sdpa {library_ms:.4f} ms", flush=True)
                report[(shape, dtype, "time")] = times
                del leaves, out
            del q, k, v, do, want, views
    return report


def _in_turns_ms(fns: dict, graph: bool = True) -> dict:
    """{name: (host-launched ms, device ms from a CUDA graph or None)} for
    each of `fns`, timed in turns TABLE_ROUNDS times, medians."""
    runs = {name: [] for name in fns}
    for _ in range(TABLE_ROUNDS):
        for name, fn in fns.items():
            runs[name].append((cuda_ms(fn), graph_ms(fn) if graph else None))
    return {name: (statistics.median(r[0] for r in rs),
                   statistics.median(r[1] for r in rs) if graph else None)
            for name, rs in runs.items()}


def _parent_libraries(trees: dict, out_dir: Path) -> dict:
    """{label: {KERNEL: attention_fwd, BWD_KERNEL: attention_bwd}} of other
    trees' `csrc/` ({label: path}; e.g. the parent commit's, unpacked beside
    this checkout), all built at once with the port's flags and loaded with
    ctypes: the launchers take the same packed arguments (`_FwdArgs`,
    `_BwdArgs`)."""
    import ctypes
    procs = {}
    for label, csrc in trees.items():
        for name in (attention.KERNEL, attention.BWD_KERNEL):
            lib = out_dir / f"lib{label}_{name}.so"
            procs[label, name] = (lib, subprocess.Popen(
                [native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib), str(csrc / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {label: {} for label in trees}
    for (label, name), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"[kernel] {label}'s {name}.cu: nvcc failed\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes = [ctypes.c_void_p] * (7 if name == attention.KERNEL else 12)
        fn.restype = ctypes.c_int
        fns[label][name] = fn
    return fns


def _parent_calls(parent: dict, q, k, v, do, o, lse) -> dict:
    """Each other tree's forward (exact, no lse) and backward (from o and
    lse) on these tensors, as `_in_turns_ms` entries "{label}_fwd" and
    "{label}_bwd", where its kernels take the head (a tree whose launcher
    refuses the head_dim is left out). Before it is timed, each call's
    output is held against the plain version at the table's tolerances, so
    that a launcher whose packed arguments no longer match this tree's
    fails here instead of timing a wrong launch."""
    if not parent:
        return {}
    calls = {}
    index = q.device.index
    fplan = attention._ForwardPlan(q, k, v, False, 1, False, ())
    bplan = attention._BackwardPlan(q, k, v, do, o, 1, False, None)
    want = attention.attention_reference(q, k, v).float()
    want_grads = attention.attention_bwd_reference(q, k, v, do)
    for label, lib in (parent or {}).items():
        out, grads = torch.empty_like(q), [torch.empty_like(z) for z in (q, k, v)]
        delta = torch.empty(q.shape[:3], device=q.device)
        fwd = lambda fn=lib[attention.KERNEL], out=out: attention._launch(
            fn, fplan.address, index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None)
        bwd = lambda fn=lib[attention.BWD_KERNEL], grads=grads, delta=delta: attention._launch(
            fn, bplan.address, index, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            o.data_ptr(), *(z.data_ptr() for z in grads), lse.data_ptr(), delta.data_ptr())
        try:
            fwd()
        except RuntimeError:   # this tree's launcher refuses the head_dim
            continue
        bwd()
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        check(torch.allclose(out.float(), want, rtol=TOL[q.dtype], atol=TOL[q.dtype]),
              f"[kernel] {label}'s forward at {tuple(q.shape)}: max_abs_err {err:.3e}")
        worst = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
                    for a, w in zip(grads, want_grads))
        check(worst <= BWD_TOL[q.dtype],
              f"[kernel] {label}'s backward at {tuple(q.shape)}: max|diff|/max|g| {worst:.3e}")
        calls[f"{label}_fwd"], calls[f"{label}_bwd"] = fwd, bwd
    return calls


def kernel_table_times(parent: dict = None) -> dict:
    """[kernel] the kernel table's own rows: K2 in the (B, H, T, D) layout
    at MAIN_SHAPES in both dtypes, in turns with K1 (the UNet's views) and
    SDPA, host-launched and from a CUDA graph; then every other head_dim's
    route at D4_SHAPES (f32, and bf16 at the largest) and HEADDIM_SHAPES
    (both dtypes): the forward and the backward from the forward's saved
    statistics (K3 as K4 runs it) checked against their plain versions, the
    forward in turns with SDPA host-launched and from a CUDA graph, the
    backward host-launched in turns with SDPA's backward alone on a
    prebuilt forward and from a CUDA graph alone, beside their bounds and
    the plain versions. With `parent` (`_parent_libraries`), other
    trees' kernels on the same inputs join the turns where they take the
    head (`_parent_calls`): the before and after from one card and run."""
    g = torch.Generator(device="cuda").manual_seed(5)
    report = {"K2": {}, "head_dim_fwd": {}, "head_dim_bwd": {}}
    for shape in MAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            views = _btc_views(q, k, v)
            t = _in_turns_ms({"K2": lambda: attention.fused_attention(q, k, v),
                              "K1": lambda: attention.fused_attention(*views),
                              "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)})
            bound, bound_by, _, unit = attention_bound_ms(shape, dtype)
            row = dict(ms=t["K2"][0], device_ms=t["K2"][1], k1_ms=t["K1"][0],
                       k1_device_ms=t["K1"][1], library_ms=t["sdpa"][0],
                       library_device_ms=t["sdpa"][1], bound_ms=bound, bound_by=bound_by)
            report["K2"][f"{shape} {str(dtype)[6:]}"] = row
            print(f"[kernel] K2 (B,H,T,D) {shape} {str(dtype)[6:]}: {row['ms']:.4f} ms "
                  f"({row['device_ms']:.4f} from a graph); K1 (B,T,C) {row['k1_ms']:.4f} "
                  f"({row['k1_device_ms']:.4f}); sdpa {row['library_ms']:.4f} "
                  f"({row['library_device_ms']:.4f}); bound {bound:.4f} ms ({unit}); medians "
                  f"of {TABLE_ROUNDS} in turns", flush=True)
            del q, k, v, views
    for shape in D4_SHAPES + HEADDIM_SHAPES:
        dtypes = ((torch.float32,) if shape in D4_SHAPES[:-1]
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            name = f"{shape} {str(dtype)[6:]}"
            q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                           for _ in range(4))
            want = attention.attention_reference(q, k, v).float()
            got, lse = attention.fused_attention(q, k, v, with_lse=True)
            err = (got.float() - want).abs().max().item()
            check(torch.allclose(got.float(), want, rtol=TOL[dtype], atol=TOL[dtype]),
                  f"[kernel] head_dim-{shape[-1]} forward at {name}: max_abs_err {err:.3e}")
            older = _parent_calls(parent, q, k, v, do, got, lse)
            t = _in_turns_ms({"kernel": lambda: attention.fused_attention(q, k, v),
                              "sdpa": lambda: F.scaled_dot_product_attention(q, k, v),
                              **{n: f for n, f in older.items() if n.endswith("_fwd")}})
            bound, bound_by, _, unit = attention_bound_ms(shape, dtype)
            fwd = dict(ms=t["kernel"][0], device_ms=t["kernel"][1],
                       plain_ms=cuda_ms(lambda: attention.attention_reference(q, k, v),
                                        iters=5),
                       library_ms=t["sdpa"][0], library_device_ms=t["sdpa"][1],
                       bound_ms=bound, bound_by=bound_by, max_abs_err=err,
                       wide=attention.uses_wide(dtype, shape[-1]))
            for n in older:
                if n.endswith("_fwd"):
                    fwd[f"{n[:-4]}_ms"] = t[n][0]
            report["head_dim_fwd"][name] = fwd
            grads = attention.fused_attention_bwd(q, k, v, do, o=got, lse=lse)
            ref = attention.attention_bwd_reference(q, k, v, do)
            worst = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
                        for a, w in zip(grads, ref))
            bwd_abs = max((a.float() - w.float()).abs().max().item() for a, w in zip(grads, ref))
            check(worst <= BWD_TOL[dtype],
                  f"[kernel] head_dim-{shape[-1]} backward at {name}: max|diff|/max|g| "
                  f"{worst:.3e}")
            leaves = [z.detach().requires_grad_() for z in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves)
            t = _in_turns_ms({
                "kernel": lambda: attention.fused_attention_bwd(q, k, v, do, o=got, lse=lse),
                "sdpa": lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                **{n: f for n, f in older.items() if n.endswith("_bwd")}},
                graph=False)
            bbound, bbound_by, _, bunit = attention_bwd_bound_ms(shape, dtype)
            bwd = dict(ms=t["kernel"][0],
                       device_ms=graph_ms(lambda: attention.fused_attention_bwd(
                           q, k, v, do, o=got, lse=lse)),
                       library_ms=t["sdpa"][0],
                       plain_ms=cuda_ms(lambda: attention.attention_bwd_reference(q, k, v, do),
                                        iters=5),
                       bound_ms=bbound, bound_by=bbound_by, max_rel_err=worst,
                       max_abs_err=bwd_abs,
                       wide=attention.uses_wide(dtype, shape[-1], forward=False))
            for n in older:
                if n.endswith("_bwd"):
                    bwd[f"{n[:-4]}_ms"] = t[n][0]
            report["head_dim_bwd"][name] = bwd
            print(f"[kernel] head_dim {shape[-1]} forward {name}: {fwd['ms']:.4f} ms "
                  f"({fwd['device_ms']:.4f} from a graph), plain {fwd['plain_ms']:.4f}, sdpa "
                  f"{fwd['library_ms']:.4f} ({fwd['library_device_ms']:.4f}), bound "
                  f"{bound:.4f} ms ({unit}), {fwd['ms'] / bound:.1f}x it; backward from the "
                  f"saved statistics {bwd['ms']:.4f} ms ({bwd['device_ms']:.4f} from a graph), "
                  f"plain {bwd['plain_ms']:.4f}, sdpa backward alone {bwd['library_ms']:.4f}, "
                  f"bound {bbound:.4f} ms ({bunit}), {bwd['ms'] / bbound:.1f}x it; medians of "
                  f"{TABLE_ROUNDS} in turns", flush=True)
            for label in sorted({n[:-4] for n in older}):
                print(f"[kernel]   {label}'s kernels in the same turns: forward "
                      f"{fwd[label + '_ms']:.4f} ms, backward {bwd[label + '_ms']:.4f} ms",
                      flush=True)
            del q, k, v, do, want, got, lse, grads, ref, leaves, out, older
    return report


def check_bwd_from_stats(shape, args) -> float:
    """The tensor-core backward (f32 or bf16, any head_dim) from the exact
    forward's statistics: the output torch.equal with and without the
    log-sum-exp, the log-sum-exp against its plain version, the gradients
    against the plain version of the kernel's own rounding, two calls
    torch.equal, and the standalone call (its own statistics launch)
    torch.equal to them. Returns the largest difference from the kernel
    order."""
    q, k, v, do = args
    dtype = str(q.dtype)[6:]
    if q.dtype == torch.float32:
        order_fn = attention.attention_bwd_tf32x3_kernel_order
        order_tol = tf32_order_tol(shape[-1], bwd=True)
    else:
        order_fn, order_tol = attention.attention_bwd_kernel_order, BWD_ORDER_TOL
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    alone = attention.fused_attention(q, k, v)
    got = attention.fused_attention_bwd(*args, o=o, lse=lse)
    again = attention.fused_attention_bwd(*args, o=o, lse=lse)
    before = attention.LAUNCHES[attention.STATS_KERNEL]
    standalone = attention.fused_attention_bwd(*args)
    torch.cuda.synchronize()
    check(attention.LAUNCHES[attention.STATS_KERNEL] == before + 1,
          f"standalone {dtype} backward did not count its statistics launch")
    check(torch.equal(o, alone), f"forward output changes with the lse output at {shape}")
    lse_err = (lse - attention.attention_lse_reference(q, k)).abs().max().item()
    check(lse_err <= LSE_TOL, f"forward lse {lse_err:.3e} from plain at {shape}")
    order = order_fn(q, k, v, do, o, lse)
    worst, max_abs = 0.0, 0.0
    for name, a, w, a2, a3 in zip(("dq", "dk", "dv"), got, order, again, standalone):
        check(torch.equal(a, a2) and torch.equal(a, a3),
              f"{dtype} backward {name} at {shape}: two calls, or saved and standalone "
              f"statistics, differ")
        err = (a.float() - w.float()).abs().max().item()
        worst = max(worst, err / w.float().abs().max().item())
        max_abs = max(max_abs, err)
    print(f"[kernel-bwd]   from the forward's statistics: output torch.equal with and "
          f"without lse, lse max_abs_err {lse_err:.3e} (allowed {LSE_TOL:.0e}); vs its own "
          f"rounding order ({order_fn.__name__}) worst max|diff|/max|g| {worst:.3e} (allowed "
          f"{order_tol:.0e}); two calls and the standalone call torch.equal", flush=True)
    check(worst <= order_tol, f"{dtype} backward vs {order_fn.__name__} at {shape}")
    del order, got, again, standalone
    return max_abs


def _btc_views(*tensors):
    """(B, H, T, D) tensors re-laid as (B, T, C) and split into heads by a
    view, as the UNet hands them over."""
    b, h, t, d = tensors[0].shape
    return [z.transpose(1, 2).reshape(b, t, h * d).view(b, t, h, d).transpose(1, 2)
            for z in tensors]


def flip_bound(q, k, v, order) -> torch.Tensor:
    """Per output, the most one bf16 flip of a weight can move it (see
    FLIP_MOVE): FLIP_MOVE * max_j |v_j - o_i| / l_i, with o the order
    function's output and l_i the row's weight sum in units of its largest
    weight."""
    logits = torch.matmul(q.float() * attention._scale_log2(q.shape[-1]),
                          k.float().transpose(-1, -2))
    total = torch.exp2(logits - logits.amax(dim=-1, keepdim=True)).sum(dim=-1, keepdim=True)
    vf = v.float()
    spread = torch.maximum(vf.amax(dim=-2, keepdim=True) - order,
                           order - vf.amin(dim=-2, keepdim=True))
    return FLIP_MOVE * spread / total


def phase_kernel_fast() -> dict:
    g = torch.Generator(device="cuda").manual_seed(5)
    report = {}
    for shape in MAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            plain = attention.attention_fast_math_reference(q, k, v).float()
            order = attention.fast_math_kernel_order(q, k, v)
            exact = attention.attention_reference(q, k, v).float()
            f32 = dtype == torch.float32
            # f32: FAST_FLIPS moves per output; bf16: one bf16 ulp
            limit = (FAST_FLIPS * flip_bound(q, k, v, order) if f32
                     else FAST_ORDER_TOL[dtype])
            rule = (f"{FAST_FLIPS} flip moves per output" if f32
                    else f"{limit:.2e}")
            views = _btc_views(q, k, v)
            for layout, args in (("BHTD", (q, k, v)), ("BTC", views)):
                before = attention.LAUNCHES[attention.FAST_KERNEL]
                got = attention.fused_attention(*args, fast_math=True)
                torch.cuda.synchronize()
                check(attention.LAUNCHES[attention.FAST_KERNEL] == before + 1,
                      "fast-math launch not counted")
                check(got.stride() == args[0].stride() and got.dtype == dtype,
                      f"{layout} output strides or dtype")
                err = (got.float() - plain).abs().max().item()
                diff = (got.float() - order).abs()
                err_order = diff.max().item()
                moves = (diff / limit).max().item()
                err_exact = (got.float() - exact).abs().max().item()
                near = torch.allclose(got.float(), exact, **FAST_VS_EXACT)
                ok = err <= FAST_TOL and near and moves <= 1
                print(f"[kernel-fast] {shape} {str(dtype)[6:]:8s} {layout}: max_abs_err "
                      f"{err:.3e} vs its plain version (allowed {FAST_TOL:.0e}), "
                      f"{err_order:.3e} vs its own rounding order at "
                      f"{attention.fast_math_step(q)} keys per max update ({moves:.3f} of the "
                      f"allowed {rule}), {err_exact:.3e} vs exact attention (rtol "
                      f"{FAST_VS_EXACT['rtol']}, atol {FAST_VS_EXACT['atol']}: "
                      f"{'within' if near else 'OUTSIDE'}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                check(ok, f"fast-math kernel at {shape} {dtype} {layout}")
                report[(shape, dtype, layout)] = err
                report[(shape, dtype, layout, "order")] = err_order
            # the order check tells fast from exact in f32: the exact kernel misses it
            exact_kernel = attention.fused_attention(*views).float()
            diff = (exact_kernel - order).abs()
            miss = (diff / limit).max().item()
            print(f"[kernel-fast] {shape} {str(dtype)[6:]:8s} exact kernel: max_abs_err "
                  f"{diff.max().item():.3e} vs the fast-math rounding order, {miss:.3f} of the "
                  f"allowed {rule} ({'must exceed 1' if f32 else 'not checked in bf16'})",
                  flush=True)
            check(not f32 or miss > 1,
                  f"the exact kernel passes the fast-math order check at {shape}")
            check_fast_separation(shape, q, k, v)
            del plain, order, exact, exact_kernel, diff, limit
            times = fast_times(q, k, v)
            print(f"[time] attention fast math {shape} {str(dtype)[6:]}: kernel "
                  f"{times['ms']:.4f} ms ({times['device_ms']:.4f} ms on the device alone, "
                  f"from a CUDA graph), exact kernel {times['exact_ms']:.4f} ms "
                  f"({times['exact_device_ms']:.4f}), sdpa {times['library_ms']:.4f} ms "
                  f"({times['library_device_ms']:.4f}) (in turns, medians of {FAST_ROUNDS}), "
                  f"plain {times['plain_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms "
                  f"({times['bound_unit']}), exponentials on the SFUs {times['exp_ms']:.4f} ms",
                  flush=True)
            report[(shape, dtype, "time")] = times
            del q, k, v, views
    return report


def fast_times(q, k, v) -> dict:
    """[kernel-fast] timings of fast math on q, k, v in the UNet's layout:
    the kernel, the exact kernel and `scaled_dot_product_attention` launched
    from the host in turns (medians of FAST_ROUNDS) and replayed from a CUDA
    graph, the plain version, the bound. Uses only what a parent tree has
    (`python3 chip_smoke.py --fast-f32`)."""
    views = _btc_views(q, k, v)
    fns = {"exact_ms": lambda: attention.fused_attention(*views),
           "ms": lambda: attention.fused_attention(*views, fast_math=True),
           "library_ms": lambda: F.scaled_dot_product_attention(q, k, v)}
    times = in_turns(fns, rounds=FAST_ROUNDS)
    for name, fn in fns.items():
        times[name.replace("ms", "device_ms")] = graph_ms(fn)
    times["plain_ms"] = cuda_ms(lambda: attention.attention_fast_math_reference(q, k, v),
                                iters=5)
    bound, bound_by, exp_ms, unit = attention_bound_ms(tuple(q.shape), q.dtype)
    times.update(bound_ms=bound, bound_by=bound_by, exp_ms=exp_ms, bound_unit=unit)
    return times


def phase_fast_f32() -> dict:
    """`--fast-f32`: the f32 fast-math timing of [kernel-fast] alone, at
    MAIN_SHAPES, also in a parent tree."""
    g = torch.Generator(device="cuda").manual_seed(5)
    report = {}
    for shape in MAIN_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        times = fast_times(q, k, v)
        print(f"[fast-f32] {shape}: kernel {times['ms']:.4f} ms ({times['device_ms']:.4f} on the "
              f"device), exact kernel {times['exact_ms']:.4f} ms ({times['exact_device_ms']:.4f}), "
              f"sdpa {times['library_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms", flush=True)
        report[str(shape)] = times
        del q, k, v
    return report


def check_fast_separation(shape, q, k, v) -> None:
    """At logits FAST_WIDE_Q times wider, the exact kernel's mean distance
    from the fast-math rounding order exceeds the fast kernel's
    FAST_SEPARATION times (see FAST_SEPARATION)."""
    wide = (q.float() * FAST_WIDE_Q).to(q.dtype)
    views = _btc_views(wide, k, v)
    order = attention.fast_math_kernel_order(wide, k, v)
    fast = (attention.fused_attention(*views, fast_math=True).float() - order).abs()
    exact = (attention.fused_attention(*views).float() - order).abs()
    fast_mean, exact_mean = fast.mean().item(), exact.mean().item()
    ok = exact_mean > FAST_SEPARATION * fast_mean
    print(f"[kernel-fast] {shape} {str(q.dtype)[6:]}, q x {FAST_WIDE_Q:g}: mean |diff| from the "
          f"fast-math rounding order: fast kernel {fast_mean:.3e} (max {fast.max().item():.3e}), "
          f"exact kernel {exact_mean:.3e}: {exact_mean / max(fast_mean, 1e-30):.1f}x (must "
          f"exceed {FAST_SEPARATION:g}x) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{q.dtype} fast math not told from exact at {shape}")


def phase_kernel_group() -> dict:
    g = torch.Generator(device="cuda").manual_seed(6)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(GROUP_SHAPE, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        views = _btc_views(q, k, v)
        for fast_math in (False, True):
            math_name = "fast" if fast_math else "exact"
            base = attention.fused_attention(*views, fast_math=fast_math)
            if not fast_math:
                _, base_lse = attention.fused_attention(*views, with_lse=True)
            times = {}
            for group in GROUPS:
                before = attention.LAUNCHES[attention.GROUPED_KERNEL]
                got = attention.fused_attention(*views, fast_math=fast_math,
                                                heads_per_program=group)
                torch.cuda.synchronize()
                check(attention.LAUNCHES[attention.GROUPED_KERNEL]
                      == before + (group > 1), "grouped launch not counted")
                check(torch.equal(got, base),
                      f"G={group} {math_name} {dtype}: not bit-identical to G=1")
                if not fast_math:
                    _, lse = attention.fused_attention(*views, heads_per_program=group,
                                                       with_lse=True)
                    check(torch.equal(lse, base_lse),
                          f"G={group} {dtype}: log-sum-exp not bit-identical to G=1")
                times[group] = cuda_ms(lambda: attention.fused_attention(
                    *views, fast_math=fast_math, heads_per_program=group))
            report[(dtype, math_name)] = times
            print(f"[kernel-group] {GROUP_SHAPE} {str(dtype)[6:]:8s} {math_name}: "
                  f"G in {GROUPS} torch.equal to G=1"
                  f"{'' if fast_math else ' (output and lse)'}; kernel ms "
                  + ", ".join(f"G={grp} {ms:.4f}" for grp, ms in times.items()),
                  flush=True)
        if dtype == torch.bfloat16:
            # the variant [generator] runs: fast math at G*
            report["g_star"] = min((grp for grp in GROUPS if grp > 1),
                                   key=report[(dtype, "fast")].get)
            got = attention.fused_attention(*views, fast_math=True,
                                            heads_per_program=report["g_star"]).float()
            plain = attention.attention_fast_math_reference(q, k, v).float()
            order = attention.fast_math_kernel_order(q, k, v)
            report["max_abs_err"] = (got - plain).abs().max().item()
            report["max_abs_err_kernel_order"] = (got - order).abs().max().item()
            check(report["max_abs_err"] <= FAST_TOL
                  and report["max_abs_err_kernel_order"] <= FAST_ORDER_TOL[dtype],
                  f"fast-math G={report['g_star']} kernel against its plain versions")
            report["plain_ms"] = cuda_ms(
                lambda: attention.attention_fast_math_reference(q, k, v), iters=5)
            report["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        del q, k, v, views
    fast = report[(torch.bfloat16, "fast")]
    best = min(fast, key=fast.get)
    print(f"[kernel-group] fastest G for fast math in bf16: G={best} ({fast[best]:.4f} ms, "
          f"G=1 {fast[1]:.4f} ms); G* = {report['g_star']} (the fastest G > 1) drives "
          f"[generator]", flush=True)
    report["extra"] = check_any_group(g)
    return report


def check_any_group(g: torch.Generator) -> dict:
    """[kernel-group] the heads_per_program values past what one block
    holds (GROUP_EXTRA: G 16 at 32 heads of 8, G 2 at heads of 64 and 128),
    which run as G / G' consecutive groups of G' heads a block: in the
    UNet's (B, T, C) views, both dtypes, the forward (exact with its lse, and
    fast math) and the backward from the saved statistics torch.equal to
    G = 1, each launch counted as grouped; the G launch timed beside G = 1."""
    report = {}
    for shape, group in GROUP_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = _btc_views(*(torch.randn(shape, generator=g, device="cuda").to(dtype)
                                       for _ in range(4)))
            out, lse = attention.fused_attention(q, k, v, with_lse=True)
            fast = attention.fused_attention(q, k, v, fast_math=True)
            grads = attention.fused_attention_bwd(q, k, v, do, o=out, lse=lse)
            before = dict(attention.LAUNCHES)
            out_g, lse_g = attention.fused_attention(q, k, v, heads_per_program=group,
                                                     with_lse=True)
            fast_g = attention.fused_attention(q, k, v, fast_math=True, heads_per_program=group)
            grads_g = attention.fused_attention_bwd(q, k, v, do, heads_per_program=group, o=out,
                                                    lse=lse)
            torch.cuda.synchronize()
            counted = (attention.LAUNCHES[attention.GROUPED_KERNEL]
                       - before[attention.GROUPED_KERNEL],
                       attention.LAUNCHES[attention.BWD_GROUPED_KERNEL]
                       - before[attention.BWD_GROUPED_KERNEL])
            same = (torch.equal(out_g, out) and torch.equal(lse_g, lse)
                    and torch.equal(fast_g, fast)
                    and all(torch.equal(a, w) for a, w in zip(grads_g, grads)))
            times = {grp: cuda_ms(lambda: attention.fused_attention(
                q, k, v, heads_per_program=grp)) for grp in (1, group)}
            print(f"[kernel-group] {shape} {str(dtype)[6:]:8s} G={group} (blocks of "
                  f"{attention.block_group(group, shape[-1], dtype, True)} heads): output, lse, "
                  f"fast math and gradients torch.equal to G=1 {same}; grouped launches "
                  f"counted {counted} (want (2, 1)); exact ms G=1 {times[1]:.4f}, "
                  f"G={group} {times[group]:.4f}", flush=True)
            check(same and counted == (2, 1),
                  f"[kernel-group] G={group} at {shape} {dtype}: not bit-identical to G=1 or "
                  f"not counted ({counted})")
            report[f"{shape} {str(dtype)[6:]} G{group}"] = times[group]
            del q, k, v, do, out, lse, fast, grads, out_g, lse_g, fast_g, grads_g
    return report


# `--wgmma-ablation`: copies of `csrc/attention_fwd.cu` with one part of the
# `wgmma` forward removed or replaced (the results of a removal are wrong;
# only the time is read), each a list of (start marker, old, new) edits of
# the kernel's source. Removing the copies keeps the waits balanced: tiles
# past the second are neither copied nor waited for.
_WGMMA_KERNEL = "attention_fwd_wgmma_kernel(const bf16*"
WGMMA_ABLATIONS = {
    "cp.async staging": [("cudaError_t launch_wgmma(", "const bool tma = wg::tensor_map<Dp>",
                          "const bool tma = false && wg::tensor_map<Dp>")],
    "no exponentials": [("__device__ __forceinline__ void wgmma_softmax(",
                         "const float p[4] = {ex2(fmaf(f[0], scale_log2, -m[0])), "
                         "ex2(fmaf(f[1], scale_log2, -m[0])),\n                            "
                         "ex2(fmaf(f[2], scale_log2, -m[1])), ex2(fmaf(f[3], scale_log2, -m[1]))};",
                         "const float p[4] = {fmaf(f[0], scale_log2, -m[0]), "
                         "fmaf(f[1], scale_log2, -m[0]),\n                            "
                         "fmaf(f[2], scale_log2, -m[1]), fmaf(f[3], scale_log2, -m[1])};")],
    "no S = Q K^T": [(_WGMMA_KERNEL, "wg::wgmma_ss_n64(s, wg::k_major<Dp>(q_addr, kk), "
                      "wg::k_major<Dp>(k_addr, kk), kk > 0);", ";")],
    "no P V": [(_WGMMA_KERNEL, "wg::wgmma_pv<Dp>(acc, pa[kk], wg::mn_major<Dp>(v_addr, kk));",
                ";")],
    "no K/V copies after tile 1": [
        (_WGMMA_KERNEL, "if (threadIdx.x == 0 && t + 1 < tiles) load_tile(t + 1);",
         "if (threadIdx.x == 0 && t + 1 < tiles && t + 1 < 2) load_tile(t + 1);"),
        (_WGMMA_KERNEL, "wg::mbar_wait(kv_full + t % 2, (t / 2) & 1);",
         "if (t < 2) wg::mbar_wait(kv_full + t % 2, (t / 2) & 1);")],
}


def _ablated_library(name: str, edits, out_dir: Path):
    """(Popen, library path) of `csrc/attention_fwd.cu` with each of `edits`
    applied from its marker on, built with the port's flags."""
    src_dir = out_dir / re.sub(r"[^a-z0-9]+", "_", name.lower())
    shutil.copytree(native.CSRC_DIR, src_dir)
    source = src_dir / "attention_fwd.cu"
    text = source.read_text()
    for marker, old, new in edits:
        start = text.index(marker)
        check(text[start:].count(old) == 1, f"[wgmma-ablation] {name}: the edit does not apply")
        text = text[:start] + text[start:].replace(old, new)
    source.write_text(text)
    lib = src_dir / "libablated.so"
    proc = subprocess.Popen([native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def phase_wgmma_ablation() -> dict:
    """[wgmma-ablation]: the bf16 forward's `wgmma` kernel at (8, 256/D,
    1024, D) for D 16 to 256, exact maths, contiguous inputs (the TMA
    route), intact and with each part of WGMMA_ABLATIONS removed or
    replaced, every copy built at once from the checkout's sources, timed in
    turns (CUDA events, medians of TABLE_ROUNDS): what each part costs is
    the intact time less the ablated one."""
    import ctypes
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {name: _ablated_library(name, edits, Path(tmp))
                  for name, edits in WGMMA_ABLATIONS.items()}
        native.build([attention.KERNEL])   # the intact kernel, beside the copies' builds
        fns = {"intact": attention._lib(attention.KERNEL).attention_fwd}
        for name, (proc, lib) in builds.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"[wgmma-ablation] {name}: nvcc failed\n{log[-3000:]}")
            fn = ctypes.CDLL(str(lib)).attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 7
            fn.restype = ctypes.c_int
            fns[name] = fn
        g = torch.Generator(device="cuda").manual_seed(8)
        for shape in [s for s in HEADDIM_SHAPES if attention.uses_wgmma(torch.bfloat16, s[-1])]:
            q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(3))
            plan = attention._ForwardPlan(q, k, v, False, 1, False, ())
            out = torch.empty_like(q)

            def call(fn):
                return lambda: attention._launch(fn, plan.address, q.device.index, q.data_ptr(),
                                                 k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                 None)

            times = {name: ms for name, (ms, _) in
                     _in_turns_ms({name: call(fn) for name, fn in fns.items()},
                                  graph=False).items()}
            report[str(shape)] = times
            print(f"[wgmma-ablation] {shape} bf16 exact: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in times.items()) + f"; medians of "
                  f"{TABLE_ROUNDS} in turns", flush=True)
            del q, k, v, out
    return report


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    """Host time of one call of `fn`: `time.perf_counter` over `calls` calls
    with no synchronisation inside (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def in_turns(fns: dict, rounds: int = HOST_ROUNDS) -> dict:
    """The median over `rounds` of each function's `cuda_ms`, the functions
    taken in turns, the order reversed every other round (a, b, b, a, ...)."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_ms(fns[name]))
    return {name: statistics.median(ts) for name, ts in times.items()}


def host_profile(fn, calls: int = 200, top: int = 8) -> list:
    """cProfile of `calls` calls of `fn` (the calling thread only): the
    `top` functions by own time, as (microseconds per call of `fn`, calls
    per call of `fn`, where)."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = []
    for (path, line, func), (_, ncalls, tottime, _, _) in pstats.Stats(prof).stats.items():
        rows.append((tottime / calls * 1e6, ncalls / calls, f"{Path(path).name}:{line}({func})"))
    return sorted(rows, reverse=True)[:top]


def phase_host() -> dict:
    """The wrappers' host path at the UNet's T=256 call and at T=1024: per
    wrapper the host time of one call, the kernel launched from the host and
    `scaled_dot_product_attention` launched from the host (CUDA events, in
    turns, medians of HOST_ROUNDS rounds), and where the host time goes
    (cProfile, T=256)."""
    g = torch.Generator(device="cuda").manual_seed(10)
    report = {}
    for shape in HOST_SHAPES:
        for dtype, fast_math in ((torch.bfloat16, False), (torch.float32, False),
                                 (torch.bfloat16, True)):
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            views = _btc_views(q, k, v)
            name = host_name(shape, dtype, fast_math)

            def kernel():
                return attention.fused_attention(*views, fast_math=fast_math)

            def sdpa():
                return F.scaled_dot_product_attention(*views)

            report[name] = _host_line(name, kernel, sdpa, shape[2] == 256)
            del q, k, v, views
    # K4 at the training path's T=256 call, forward+backward through autograd
    shape = (TRAIN_BATCH, 32, 256, 8)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                   for _ in range(4))
    leaves = [z.detach().requires_grad_() for z in _btc_views(q, k, v)]

    def k4():
        return torch.autograd.grad(attention.fused_attention_trainable(*leaves), leaves, do)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, do)

    name = host_name(shape, torch.bfloat16, False, trainable=True)
    report[name] = _host_line(name, k4, sdpa_fwd_bwd, False)
    # its backward alone, from the forward's statistics (cProfile sees the
    # calling thread only, and autograd runs the backward on its own)
    with torch.no_grad():
        o, lse = attention.fused_attention(*leaves, with_lse=True)
    for entry in host_profile(lambda: attention.fused_attention_bwd(*leaves, do, o=o, lse=lse)):
        print(f"[host]   cProfile fused_attention_bwd {shape} bfloat16 from saved statistics: "
              f"{entry[0]:.2f} us/call in {entry[2]} ({entry[1]:g} calls)", flush=True)
    return report


def host_name(shape, dtype, fast_math: bool, trainable: bool = False) -> str:
    if trainable:
        return f"fused_attention_trainable fwd+bwd {shape} {str(dtype)[6:]}"
    return f"fused_attention{'(fast_math)' if fast_math else ''} {shape} {str(dtype)[6:]}"


def _host_line(name: str, kernel, sdpa, profile: bool) -> dict:
    row = dict(host_ms=host_ms(kernel), sdpa_host_ms=host_ms(sdpa))
    timed = in_turns({"kernel": kernel, "sdpa": sdpa})
    row.update(ms=timed["kernel"], sdpa_ms=timed["sdpa"])
    print(f"[host] {name}: host {row['host_ms']:.4f} ms per call (sdpa {row['sdpa_host_ms']:.4f}); "
          f"launched from the host, in turns, median of {HOST_ROUNDS}: kernel {row['ms']:.4f} "
          f"ms, sdpa {row['sdpa_ms']:.4f} ms ({row['ms'] / row['sdpa_ms']:.2f}x)", flush=True)
    if profile:
        for us, ncalls, where in host_profile(kernel):
            print(f"[host]   cProfile: {us:.2f} us/call in {where} ({ncalls:g} calls)", flush=True)
    return row


def _png_arrays(paths):
    return [np.asarray(Image.open(p)) for p in paths]


def phase_generator(state: dict, card: str, base: Path, g_star: int,
                    check_sync: bool = True) -> dict:
    """[generator]: `generate_images` cold and warm, its launches, and the
    sampler alone on one block; block k's writes overlap block
    k+1's walk, so the warm time is set beside the sampler's blocks (their
    share) and, with `check_sync`, one block is queued under
    `torch.cuda.set_sync_debug_mode("error")`: `sample()` may not wait for
    the card (`python3 chip_smoke.py --generator` runs this phase alone
    without that check, e.g. in an unpacked parent tree)."""
    ckpt = base / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / "unet_MEL_best.pth")
    gen = ImageGenerator(checkpoints_dir=str(ckpt), compute_dtype=torch.bfloat16)
    gen.model_manager.set_attention_tuning(heads_per_program=g_star, fast_math=True)
    gen.scheduler_kind = "ddim"
    gen.set_inference_steps(CLI_STEPS)
    gen.batch_size = CLI_BATCH
    gen.set_generation_seed(GEN_SEED)

    def run(out: Path) -> tuple:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        result = gen.generate_images([("MEL", GEN_IMAGES)], str(out))
        torch.cuda.synchronize()
        return result, time.time() - t0, dict(attention.LAUNCHES)

    out = base / "generated"
    result, wall, launches = run(out)
    check(result.get("generated") == GEN_IMAGES, f"generate_images returned {result}")
    pngs = sorted((out / "MEL").glob("ISIC_*.png"))
    sidecars = [json.loads(p.with_suffix(".json").read_text()) for p in pngs]
    rows = (out / "synthetic_dataset.csv").read_text().splitlines()[1:]
    check(len(pngs) == GEN_IMAGES and len(rows) == GEN_IMAGES,
          f"generator wrote {len(pngs)} PNGs, {len(rows)} CSV rows")
    for meta in sidecars:
        sched = meta["scheduler"]
        check(sched.get("attention_fast_math") is True and sched["dtype"] == "bfloat16"
              and sched["kind"] == "ddim" and meta["device"].startswith("cuda")
              and len(meta["block"]["seeds"]) == CLI_BATCH, f"sidecar {meta}")
    arrays = _png_arrays(pngs)
    check(all(a.shape == (128, 128, 3) for a in arrays), "PNG shapes")
    check(len({a.tobytes() for a in arrays}) == GEN_IMAGES, "generated images repeat")
    steps = GEN_IMAGES // CLI_BATCH * CLI_STEPS
    want = ATTENTION_CALLS_PER_UNET * steps
    print(f"[generator] ImageGenerator bf16, set_attention_tuning(heads_per_program="
          f"{g_star}, fast_math=True), DDIM {CLI_STEPS}, batch {CLI_BATCH}: "
          f"{GEN_IMAGES} PNGs, sidecars and CSV rows in {wall:.3f} s cold "
          f"({GEN_IMAGES / wall:.2f} images/s; model load and first-call set-up "
          f"included); launches {launches} (want {want} fast-math, 0 exact, "
          f"{want if g_star > 1 else 0} grouped)", flush=True)
    check(launches[attention.FAST_KERNEL] == want and launches[attention.KERNEL] == 0
          and launches[attention.GROUPED_KERNEL] == (want if g_star > 1 else 0),
          f"generator launched {launches}")

    # the same call again on the warm generator, and its sampler alone
    # the same call again on the warm generator, in turns with its sampler
    # alone on one block (medians: single runs spread by 0.1 s and more on
    # the host clock)
    seeds = np.asarray(sidecars[0]["block"]["seeds"], np.uint32)
    warm_runs, runs, same = [], [], True
    for r in range(GEN_WARM_ROUNDS):
        warm_out = base / f"generated_warm{r}"
        _, warm, warm_launches = run(warm_out)
        check(warm_launches == launches, f"warm run launched {warm_launches}")
        same = same and all(a.read_bytes() == b.read_bytes() for a, b in
                            zip(pngs, sorted((warm_out / "MEL").glob("ISIC_*.png"))))
        warm_runs.append(warm)
        torch.cuda.synchronize()
        t0 = time.time()
        gen._sample_block(["MEL"] * CLI_BATCH, seeds, False)
        torch.cuda.synchronize()
        runs.append(time.time() - t0)
    warm, block_s = statistics.median(warm_runs), statistics.median(runs)
    blocks = GEN_IMAGES // CLI_BATCH
    share = blocks * block_s / warm
    print(f"[generator] warm (same ImageGenerator), median of {GEN_WARM_ROUNDS} "
          f"({', '.join(f'{r:.4f}' for r in warm_runs)} s): {warm:.4f} s, "
          f"{GEN_IMAGES / warm:.2f} images/s on {card}; PNGs byte-identical to the cold "
          f"run: {same}; the sampler alone, one block, in turns with it "
          f"({', '.join(f'{r:.4f}' for r in runs)} s): {block_s / CLI_STEPS:.5f} s/step, "
          f"{CLI_BATCH / block_s:.2f} images/s, so {blocks} blocks sample in "
          f"{blocks * block_s:.4f} s of the {warm:.4f} s (sampler share {share:.3f}; the "
          f"rest is the writes the walks do not hide)", flush=True)
    check(same, "the same generate_images call wrote other bytes the second time")
    if check_sync:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            queued = gen._sample_block(["MEL"] * CLI_BATCH, seeds, False)
            queue_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        check(list(queued["noise_hashes"]) == [m["noise_hash"] for m in sidecars[:CLI_BATCH]],
              "the noise hashes of a re-queued first block")
        print(f"[generator] one block queued under set_sync_debug_mode('error'): no host "
              f"synchronisation; sample() returned after {queue_s:.4f} s, the walk ended "
              f"after {walk_s:.4f} s; its noise hashes are the sidecars'", flush=True)
    return dict(launches=launches, wall_s=wall, warm_s=warm, warm_runs=warm_runs,
                block_s=block_s, sampler_share=share, out=out, ckpt=ckpt)


def phase_generator_f32_fast(state: dict, card: str, base: Path) -> dict:
    """[generator-f32-fast] the library path in f32 with fast math (the f32
    tensor-core fast-math kernel), its warm block beside the same generator
    without fast math, and a fresh-process `--reproduce` of one image."""
    ckpt = base / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / "unet_MEL_best.pth")
    gens = {}
    for fast_math in (True, False):
        gen = ImageGenerator(checkpoints_dir=str(ckpt), compute_dtype=torch.float32)
        gen.model_manager.set_attention_tuning(heads_per_program=1, fast_math=fast_math)
        gen.scheduler_kind = "ddim"
        gen.set_inference_steps(CLI_STEPS)
        gen.batch_size = CLI_BATCH
        gen.set_generation_seed(GEN_SEED)
        gens[fast_math] = gen
    out = base / "generated"
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    result = gens[True].generate_images([("MEL", GEN_IMAGES)], str(out))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(attention.LAUNCHES)
    check(result.get("generated") == GEN_IMAGES, f"generate_images returned {result}")
    pngs = sorted((out / "MEL").glob("ISIC_*.png"))
    sidecars = [json.loads(p.with_suffix(".json").read_text()) for p in pngs]
    check(len(pngs) == GEN_IMAGES, f"generator wrote {len(pngs)} PNGs")
    for meta in sidecars:
        sched = meta["scheduler"]
        check(sched.get("attention_fast_math") is True and sched["dtype"] == "float32",
              f"sidecar {meta}")
    arrays = _png_arrays(pngs)
    check(all(a.shape == (128, 128, 3) for a in arrays)
          and len({a.tobytes() for a in arrays}) == GEN_IMAGES, "PNG shapes or repeats")
    want = ATTENTION_CALLS_PER_UNET * GEN_IMAGES // CLI_BATCH * CLI_STEPS
    print(f"[generator-f32-fast] ImageGenerator f32, set_attention_tuning(heads_per_program=1, "
          f"fast_math=True), DDIM {CLI_STEPS}, batch {CLI_BATCH}: {GEN_IMAGES} PNGs and "
          f"sidecars in {wall:.3f} s cold; launches {launches} (want {want} fast-math, 0 exact, "
          f"0 grouped)", flush=True)
    check(launches[attention.FAST_KERNEL] == want and launches[attention.KERNEL] == 0
          and launches[attention.GROUPED_KERNEL] == 0, f"f32 fast-math generator launched {launches}")

    # the warm block (one sampler walk of 8 images), fast and exact in turns
    seeds = np.asarray(sidecars[0]["block"]["seeds"], np.uint32)
    gens[False]._sample_block(["MEL"] * CLI_BATCH, seeds, False)   # loads the model
    runs = {True: [], False: []}
    for r in range(2 * GEN_ROUNDS):
        for fast_math in ((True, False) if r % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.time()
            gens[fast_math]._sample_block(["MEL"] * CLI_BATCH, seeds, False)
            torch.cuda.synchronize()
            runs[fast_math].append((time.time() - t0) / CLI_STEPS)
    step = {fm: statistics.median(ts) for fm, ts in runs.items()}
    print(f"[generator-f32-fast] the sampler alone, one block of {CLI_BATCH}, in turns, "
          f"medians of {2 * GEN_ROUNDS}: fast math {step[True]:.5f} s/step, exact "
          f"{step[False]:.5f} s/step on {card}", flush=True)
    profiles = {fm: profile_sampler(gens[fm].model_manager, seeds, "[generator-f32-fast]",
                                    "f32, fast math" if fm else "f32, exact")
                for fm in (True, False)}

    # one image of the second block, regenerated in a fresh process
    sidecar = out / "MEL" / f"ISIC_{CLI_BATCH + 4:07d}.json"
    meta = json.loads(sidecar.read_text())
    rc, redo_launches, output = run_cli_process(
        ["--reproduce", str(sidecar), "--checkpoints", str(ckpt), "--device", "cuda"])
    original = sidecar.with_name(meta["filename"])
    redo = sidecar.with_name(f"{original.stem}_reproduced{original.suffix}")
    identical = redo.exists() and redo.read_bytes() == original.read_bytes()
    redo_want = ATTENTION_CALLS_PER_UNET * CLI_STEPS
    print(f"[generator-f32-fast] --reproduce {sidecar.name} in a fresh process: rc {rc}, "
          f"byte-identical {identical}, launches {redo_launches} (want {redo_want} fast-math, "
          f"0 exact)", flush=True)
    check(rc == 0 and identical, f"--reproduce of an f32 fast-math image: rc {rc}\n{output}")
    check(redo_launches[attention.FAST_KERNEL] == redo_want
          and redo_launches[attention.KERNEL] == 0,
          f"--reproduce of an f32 fast-math image launched {redo_launches}")
    return dict(launches=launches, step_s=step, profiles=profiles,
                reproduce_launches=redo_launches)


def run_cli_process(argv, module: str = "synt_isic_tpu_torch.cli", env=None,
                    count_all_reduce: bool = False) -> tuple:
    """`python -m MODULE ARGV` in a fresh process (with `env` added to its
    environment), plus the launch counts it ends with, and with
    `count_all_reduce` the number of `torch.distributed.all_reduce` calls
    (an `ALL_REDUCE n` line). Returns (rc, launches, output)."""
    spy = ("import torch.distributed as dist\n"
           "calls = [0]\n"
           "real = dist.all_reduce\n"
           "def counted(*a, **k):\n"
           "    calls[0] += 1\n"
           "    return real(*a, **k)\n"
           "dist.all_reduce = counted\n") if count_all_reduce else ""
    code = ("import json, runpy, sys\n"
            "from synt_isic_tpu_torch.ops import attention\n"
            + spy +
            f"sys.argv = ['{module}'] + sys.argv[1:]\n"
            "try:\n"
            f"    runpy.run_module('{module}', run_name='__main__')\n"
            "    rc = 0\n"
            "except SystemExit as exc:\n"
            "    rc = exc.code or 0\n"
            "print('LAUNCHES ' + json.dumps(attention.LAUNCHES), flush=True)\n"
            + ("print(f'ALL_REDUCE {calls[0]}', flush=True)\n" if count_all_reduce else "")
            + "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env or {}))
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    found = re.findall(r"^LAUNCHES (.*)$", proc.stdout, re.M)
    check(bool(found), f"no launch counts from the CLI process:\n{proc.stdout}\n{proc.stderr}")
    return proc.returncode, json.loads(found[-1]), (proc.stdout + proc.stderr).strip()


def _max_pixel_diff(a: Path, b: Path) -> int:
    x, y = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    return int(np.abs(x - y).max())


def phase_reproduce(gen: dict, cli_base: Path) -> dict:
    want = ATTENTION_CALLS_PER_UNET * CLI_STEPS
    report = {}
    second_block = gen["out"] / "MEL" / f"ISIC_{CLI_BATCH + 4:07d}.json"
    jpeg = sorted((cli_base / "ISIC2018_Task3_synt").glob("ISIC_*.json"))[2]
    cases = [("generator PNG, fast math, block 2", second_block, gen["ckpt"],
              attention.FAST_KERNEL),
             ("console JPEG, f32, exact", jpeg, cli_base / "checkpoints",
              attention.KERNEL)]
    for label, sidecar, ckpt, kernel in cases:
        meta = json.loads(sidecar.read_text())
        t0 = time.time()
        rc, launches, output = run_cli_process(
            ["--reproduce", str(sidecar), "--checkpoints", str(ckpt), "--device", "cuda"])
        wall = time.time() - t0
        original = sidecar.with_name(meta["filename"])
        redo = sidecar.with_name(f"{original.stem}_reproduced{original.suffix}")
        identical = redo.exists() and redo.read_bytes() == original.read_bytes()
        diff = _max_pixel_diff(original, redo) if redo.exists() else None
        said = [line for line in output.splitlines() if line.startswith("reproduced")]
        print(f"[reproduce] {label}: {sidecar.name} -> rc {rc}, byte-identical "
              f"{identical} (max pixel difference {diff}), launches {launches} "
              f"(want {want} {kernel}), {wall:.1f} s in a fresh process; "
              f"{said[-1] if said else output}", flush=True)
        check(rc == 0 and identical, f"--reproduce of {label}: rc {rc}\n{output}")
        others = sum(n for key, n in launches.items()
                     if key not in (kernel, attention.BWD_KERNEL, attention.GROUPED_KERNEL))
        check(launches[kernel] == want and others == 0 and launches[attention.GROUPED_KERNEL] == 0,
              f"--reproduce of {label} launched {launches}")
        report[label] = launches

    # the same fast-math image, with the flag taken out of its sidecar
    off = gen["out"] / "fast_math_off"
    off.mkdir()
    meta = json.loads(second_block.read_text())
    del meta["scheduler"]["attention_fast_math"]
    sidecar = off / second_block.name
    sidecar.write_text(json.dumps(meta, indent=2))
    shutil.copy(second_block.with_name(meta["filename"]), off / meta["filename"])
    rc, launches, output = run_cli_process(
        ["--reproduce", str(sidecar), "--checkpoints", str(gen["ckpt"]), "--device", "cuda"])
    redo = off / f"{Path(meta['filename']).stem}_reproduced.png"
    diff = _max_pixel_diff(off / meta["filename"], redo) if redo.exists() else None
    print(f"[reproduce] the same image with attention_fast_math taken out of its sidecar: "
          f"rc {rc} (want 1, bytes differ), max pixel difference {diff}, launches "
          f"{launches} (want {want} {attention.KERNEL})", flush=True)
    check(rc == 1 and "DIFFER" in output and diff is not None and diff > 0,
          f"fast math switched off still reproduced the image: rc {rc}\n{output}")
    check(launches[attention.KERNEL] == want and launches[attention.FAST_KERNEL] == 0,
          f"--reproduce without fast math launched {launches}")
    report["fast math off"] = launches
    return report


def phase_unet_grad() -> None:
    """One backward of the full-width UNet each way, f32 and bf16 compute on
    f32 parameters: every attention projection weight gets a non-zero
    gradient through the kernels, and the kernel path's gradients agree with
    the plain path's (f32) or are as close to the f32 gradients as the plain
    path's (bf16)."""
    torch.manual_seed(0)
    state = UNet2D(UNet2DConfig()).state_dict()
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(GRAD_BATCH, 3, 128, 128, generator=g, device="cuda")
    eps = torch.randn(GRAD_BATCH, 3, 128, 128, generator=g, device="cuda")
    t = torch.tensor([999, 500, 100, 3], device="cuda")

    def gradients(dtype, fused):
        model = UNet2D(UNet2DConfig(), dtype=dtype, param_dtype=torch.float32,
                       use_fused_attention=fused, fast_norm=dtype != torch.float32)
        model.load_state_dict(state)
        model = model.cuda()
        reset_launches()
        with full_f32_convolutions():
            torch.mean((model(x, t) - eps) ** 2).backward()
        torch.cuda.synchronize()
        want = ATTENTION_CALLS_PER_UNET if fused else 0
        check(attention.LAUNCHES[attention.KERNEL] == want
              and attention.LAUNCHES[attention.BWD_KERNEL] == want,
              f"UNet backward launched {attention.LAUNCHES}, want {want} each")
        grads = {n: p.grad for n, p in model.named_parameters()}
        projections = [n for n in grads if re.search(r"\.to_[qkv]\.weight$", n)]
        if fused:
            check(len(projections) == 3 * ATTENTION_CALLS_PER_UNET,
                  f"{len(projections)} projections")
            for name in projections:
                check(grads[name] is not None and grads[name].abs().max().item() > 0,
                      f"{name} got no gradient through the kernel path")
        return grads

    def distances(grads, ref):
        """max|diff| / max|g_ref| per parameter, sorted, worst first. Softmax
        ignores a shift shared by every key, so the key bias's gradient is
        zero in exact arithmetic and only rounding noise on both sides: it is
        held against the largest gradient instead."""
        largest = max(w.abs().max().item() for w in ref.values())
        out = []
        for name, w in ref.items():
            scale = largest if name.endswith("to_k.bias") else w.abs().max().item()
            out.append(((grads[name] - w).abs().max().item() / scale, name))
        return sorted(out, reverse=True)

    ref = gradients(torch.float32, False)
    f32 = distances(gradients(torch.float32, True), ref)
    print(f"[unet-grad] full width, batch {GRAD_BATCH}, f32: all {3 * ATTENTION_CALLS_PER_UNET} "
          f"q/k/v projection weights have non-zero gradients through the kernels; "
          f"kernel vs plain attention, worst max|diff|/max|g| {f32[0][0]:.3e} at "
          f"{f32[0][1]} (allowed {UNET_GRAD_TOL:.0e})", flush=True)
    check(f32[0][0] <= UNET_GRAD_TOL, "UNet f32 gradients, kernel vs plain")

    kernel = gradients(torch.bfloat16, True)
    plain = gradients(torch.bfloat16, False)
    stats = {}
    for label, d in (("kernel vs f32", distances(kernel, ref)),
                     ("plain vs f32", distances(plain, ref)),
                     ("kernel vs plain", distances(kernel, plain))):
        stats[label] = {"median": d[len(d) // 2][0], "worst": d[0][0]}
        print(f"[unet-grad] full width, batch {GRAD_BATCH}, bf16 compute, f32 parameters, "
              f"{label}: median max|diff|/max|g| {stats[label]['median']:.3e}, worst "
              f"{stats[label]['worst']:.3e} at {d[0][1]}", flush=True)
    for key, factor in BF16_GRAD_FACTOR.items():
        mine, theirs = stats["kernel vs f32"][key], stats["plain vs f32"][key]
        check(mine <= factor * theirs, f"bf16 gradients: kernel path {key} distance "
                                       f"from f32 {mine:.3e} > {factor} x plain {theirs:.3e}")
    print(f"[unet-grad] bf16: the kernel path is as close to the f32 gradients as the "
          f"plain path (allowed {BF16_GRAD_FACTOR['median']} x its median, "
          f"{BF16_GRAD_FACTOR['worst']} x its worst)", flush=True)


def _headdim_generator(ckpt: Path, cfg: UNet2DConfig, dtype: torch.dtype) -> ImageGenerator:
    gen = ImageGenerator(checkpoints_dir=str(ckpt), compute_dtype=dtype, model_config=cfg)
    gen.scheduler_kind = "ddim"
    gen.set_inference_steps(CLI_STEPS)
    gen.batch_size = CLI_BATCH
    gen.set_generation_seed(GEN_SEED)
    return gen


def _attention_heads(cfg: UNet2DConfig) -> int:
    """Heads of every attention call of `cfg`'s UNet: its attention blocks
    (the third level's and the middle's) over the head_dim."""
    return cfg.block_out_channels[2] // cfg.attention_head_dim


def _headdim_walk(gen: ImageGenerator, out: Path, heads: int, label: str) -> tuple:
    """`generate_images([("MEL", GEN_IMAGES)])` with the launches counted:
    (launches, heads per launch, PNG paths, wall seconds), after checking
    the images were written and every launch ran at `heads` heads."""
    reset_launches()
    with heads_per_launch() as launch_heads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = gen.generate_images([("MEL", GEN_IMAGES)], str(out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(attention.LAUNCHES)
    pngs = sorted((out / "MEL").glob("ISIC_*.png"))
    check(result.get("generated") == GEN_IMAGES and len(pngs) == GEN_IMAGES,
          f"[headdim] {label}: generate_images returned {result}, {len(pngs)} PNGs")
    check(set(launch_heads) == {heads},
          f"[headdim] {label}: heads per launch {set(launch_heads)}")
    return launches, list(launch_heads), pngs, wall


def _headdim_f32_walk(ckpt: Path, cfg: UNet2DConfig, out: Path) -> dict:
    """The f32 exact walk of `cfg` (`generate_images`, DDIM CLI_STEPS,
    GEN_IMAGES MEL images): exactly 120 K1 launches, every one at
    `_attention_heads(cfg)` heads, on the wide kernel where the head is
    wider than 64 channels; then the first block again, kernel and plain
    attention, under full-f32 convolutions, within HEADDIM_WALK_TOL."""
    head_dim, heads = cfg.attention_head_dim, _attention_heads(cfg)
    want = ATTENTION_CALLS_PER_UNET * CLI_STEPS * GEN_IMAGES // CLI_BATCH
    wide = want if attention.uses_wide(torch.float32, head_dim) else 0
    gen = _headdim_generator(ckpt, cfg, torch.float32)
    launches, launch_heads, pngs, wall = _headdim_walk(
        gen, out, heads, f"head_dim {head_dim}")
    check(launches[attention.KERNEL] == want and launches[attention.FAST_KERNEL] == 0
          and launches[attention.WIDE_KERNEL] == wide and len(launch_heads) == want,
          f"[headdim] head_dim {head_dim}: launches {launches}")
    # the first block again, kernel and plain attention, from the same seeds
    seeds = np.asarray(json.loads(pngs[0].with_suffix(".json").read_text())
                       ["block"]["seeds"], np.uint32)
    walks = {}
    with full_f32_convolutions():
        for fused in (True, False):
            gen.model_manager.use_fused_attention = fused
            gen.model_manager.loaded_models.clear()
            gen.model_manager._samplers.clear()
            walks[fused] = gen._sample_block(["MEL"] * CLI_BATCH, seeds, False)["images"]
    gen.model_manager.use_fused_attention = True
    dist = (walks[True] - walks[False]).abs().max().item()
    finite = bool(torch.isfinite(walks[True]).all())
    print(f"[headdim] ImageGenerator(model_config=UNet2DConfig(block_out_channels="
          f"{cfg.block_out_channels}, attention_head_dim={head_dim})), f32 exact, DDIM "
          f"{CLI_STEPS}, MEL:{GEN_IMAGES} in blocks of {CLI_BATCH}: {len(pngs)} PNGs in "
          f"{wall:.3f} s; K1 launches {launches[attention.KERNEL]} (want {want}), on the wide "
          f"kernel {launches[attention.WIDE_KERNEL]} (want {wide}), every one at {heads} heads "
          f"of {head_dim}; the first block kernel vs plain attention, full-f32 convolutions: "
          f"max|diff| {dist:.3e} (allowed {HEADDIM_WALK_TOL:.0e}), finite {finite}", flush=True)
    check(finite and dist <= HEADDIM_WALK_TOL,
          f"[headdim] head_dim {head_dim} walk kernel vs plain {dist:.3e}")
    return {"launches": launches[attention.KERNEL],
            "wide_launches": launches[attention.WIDE_KERNEL], "heads": heads, "wall_s": wall,
            "max_abs_err": dist}


def _headdim_bf16_walk(ckpt: Path, cfg: UNet2DConfig, out: Path) -> dict:
    """The bf16 walk of `cfg`: exactly 120 K1 launches, each on the `wgmma`
    kernel (heads of 9 to 256 channels) or on the wide kernel (wider)."""
    head_dim, heads = cfg.attention_head_dim, _attention_heads(cfg)
    want = ATTENTION_CALLS_PER_UNET * CLI_STEPS * GEN_IMAGES // CLI_BATCH
    route = (attention.WIDE_KERNEL if attention.uses_wide(torch.bfloat16, head_dim)
             else attention.WGMMA_KERNEL)
    gen = _headdim_generator(ckpt, cfg, torch.bfloat16)
    launches, launch_heads, pngs, wall = _headdim_walk(
        gen, out, heads, f"bf16 head_dim {head_dim}")
    got = tuple(launches[k] for k in (attention.KERNEL, route, attention.FAST_KERNEL))
    print(f"[headdim] ImageGenerator(model_config=UNet2DConfig(block_out_channels="
          f"{cfg.block_out_channels}, attention_head_dim={head_dim}), compute_dtype="
          f"torch.bfloat16), DDIM {CLI_STEPS}, MEL:{GEN_IMAGES}: {len(pngs)} PNGs in {wall:.3f} "
          f"s; K1/{route}/fast launches {got} (want {want}/{want}/0), every one at {heads} "
          f"heads", flush=True)
    check(got == (want, want, 0) and len(launch_heads) == want,
          f"[headdim] bf16 head_dim {head_dim}: K1/{route}/fast launches {got}")
    return {"head_dim": head_dim, "launches": want, "route": route, "route_launches": got[1],
            "wall_s": wall}


def phase_headdim(card: str, base: Path) -> dict:
    """[headdim]: the library generator at other head_dims (HEADDIM_WALKS),
    f32 exact, DDIM 10, 16 MEL images in two blocks of 8 on one full-width
    checkpoint: exactly 120 K1 launches each, every one at 256 / D heads
    (on the wide kernel above 64 channels); the first block's walk kernel vs
    plain attention under full-f32 convolutions; the same walk in bf16 at
    HEADDIM_BF16_WALK, its 120 K1 launches each on the `wgmma` kernel; then
    the f32 and bf16 walks of a full-width checkpoint of HEADDIM_WIDE (one
    head of 512 channels a call, on the wide kernel); then the train step
    at each of HEADDIM_TRAIN_DIMS and of HEADDIM_WIDE (batch BENCH_BATCH,
    bf16): 6 K1 with their statistics (on the `wgmma` or the wide kernel) and
    6 K3 per step (on the wide kernels above 64 channels), no statistics
    launch, and the f32 gradient kernel vs plain."""
    report = {"walks": {}, "train": {}}
    ckpts = {}
    for name, cfg in (("default", UNet2DConfig()), ("wide", HEADDIM_WIDE)):
        torch.manual_seed(0)
        ckpts[name] = base / f"checkpoints_{name}"
        ckpts[name].mkdir(parents=True)
        torch.save(UNet2D(cfg).state_dict(), ckpts[name] / "unet_MEL_best.pth")
    for head_dim in HEADDIM_WALKS:
        report["walks"][head_dim] = _headdim_f32_walk(
            ckpts["default"], UNet2DConfig(attention_head_dim=head_dim),
            base / f"head_dim_{head_dim}")
    report["bf16_walk"] = _headdim_bf16_walk(
        ckpts["default"], UNet2DConfig(attention_head_dim=HEADDIM_BF16_WALK),
        base / f"head_dim_{HEADDIM_BF16_WALK}_bf16")
    wide = HEADDIM_WIDE.attention_head_dim
    report["walks"][wide] = _headdim_f32_walk(ckpts["wide"], HEADDIM_WIDE,
                                              base / f"head_dim_{wide}")
    report["bf16_walk_wide"] = _headdim_bf16_walk(ckpts["wide"], HEADDIM_WIDE,
                                                  base / f"head_dim_{wide}_bf16")
    for train_dim in HEADDIM_TRAIN_DIMS:
        report["train"][train_dim] = _headdim_train(
            card, UNet2DConfig(attention_head_dim=train_dim))
    report["train"][wide] = _headdim_train(card, HEADDIM_WIDE)
    return report


def _headdim_train(card: str, cfg: UNet2DConfig) -> dict:
    """The train step of `cfg` (bf16 compute, f32 parameters, batch
    BENCH_BATCH): 6 K1 with their statistics, each on the `wgmma` kernel
    (or the wide kernel above 256 channels), and 6 K3 per step (on the wide
    kernels above 64), no statistics launch; then the whole UNet's f32
    gradient, kernel vs plain."""
    head_dim, heads = cfg.attention_head_dim, _attention_heads(cfg)
    train_cfg = TrainConfig(batch_size=BENCH_BATCH)
    torch.manual_seed(0)
    model = UNet2D(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                   use_fused_attention=True, fast_norm=True).cuda().train()
    state = create_train_state(model, train_cfg)
    step = make_train_step(DiffusionSchedule.create(), train_cfg)
    g = torch.Generator(device="cuda").manual_seed(6)
    batch = torch.rand(BENCH_BATCH, 128, 128, 3, generator=g, device="cuda") * 2 - 1
    step(state, batch, g)                   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with heads_per_launch() as launch_heads:
        t0 = time.perf_counter()
        losses = [step(state, batch, g) for _ in range(HEADDIM_TRAIN_STEPS)]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / HEADDIM_TRAIN_STEPS
    launches = dict(attention.LAUNCHES)
    per_step = ATTENTION_CALLS_PER_UNET * HEADDIM_TRAIN_STEPS
    route = (attention.WIDE_KERNEL if attention.uses_wide(torch.bfloat16, head_dim)
             else attention.WGMMA_KERNEL)
    bwd_wide = per_step if attention.uses_wide(torch.bfloat16, head_dim, forward=False) else 0
    got = tuple(launches[k] for k in (attention.KERNEL, route, attention.BWD_KERNEL,
                                      attention.BWD_WIDE_KERNEL, attention.STATS_KERNEL))
    check(got == (per_step, per_step, per_step, bwd_wide, 0) and set(launch_heads) == {heads}
          and all(bool(torch.isfinite(x)) for x in losses),
          f"[headdim] train steps at head_dim {head_dim}: K1/{route}/K3/K3 wide/stats {got}, "
          f"heads {set(launch_heads)}, losses {[x.item() for x in losses]}")
    del model, state

    # the whole UNet's f32 gradient at head_dim, kernel vs plain
    torch.manual_seed(0)
    weights = UNet2D(cfg).state_dict()
    x = torch.randn(GRAD_BATCH, 3, 128, 128, generator=g, device="cuda")
    eps = torch.randn(GRAD_BATCH, 3, 128, 128, generator=g, device="cuda")
    t = torch.tensor([999, 500, 100, 3], device="cuda")
    grads = {}
    reset_launches()
    for fused in (True, False):
        unet = UNet2D(cfg, use_fused_attention=fused)
        unet.load_state_dict(weights)
        unet = unet.cuda()
        with full_f32_convolutions():
            torch.mean((unet(x, t) - eps) ** 2).backward()
        grads[fused] = {n: p.grad for n, p in unet.named_parameters()}
    f32_wide = tuple(attention.LAUNCHES[k] for k in (attention.WIDE_KERNEL,
                                                     attention.BWD_WIDE_KERNEL))
    want_f32 = tuple(ATTENTION_CALLS_PER_UNET if attention.uses_wide(torch.float32, head_dim, f)
                     else 0 for f in (True, False))
    check(f32_wide == want_f32, f"[headdim] f32 gradient at head_dim {head_dim}: wide "
                                f"launches {f32_wide} (want {want_f32})")
    largest = max(w.abs().max().item() for w in grads[False].values())
    worst, worst_name = max(
        ((grads[True][n] - w).abs().max().item()
         / (largest if n.endswith("to_k.bias") else w.abs().max().item()), n)
        for n, w in grads[False].items())
    print(f"[headdim] train step at head_dim {head_dim} ({heads} heads of "
          f"{cfg.block_out_channels[2]} channels), batch {BENCH_BATCH}, bf16: {step_s:.4f} s/step "
          f"warm on {card}; K1/{route}/K3/K3 wide/stats launches {got} over "
          f"{HEADDIM_TRAIN_STEPS} steps (want {per_step}/{per_step}/{per_step}/{bwd_wide}/0); the "
          f"full-width UNet's f32 gradient at batch {GRAD_BATCH}, kernel vs plain (wide "
          f"K1/K3 launches {f32_wide}): worst max|diff|/max|g| {worst:.3e} at {worst_name} "
          f"(allowed {UNET_GRAD_TOL:.0e})", flush=True)
    check(worst <= UNET_GRAD_TOL, f"[headdim] gradient at head_dim {head_dim}")
    return {"launches": dict(zip(("fwd", "route", "bwd", "bwd_wide", "stats"), got)),
            "route": route, "step_s": step_s, "grad_rel": worst}


def phase_unet() -> dict:
    torch.manual_seed(0)
    state = UNet2D(UNet2DConfig()).state_dict()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 3, 128, 128, generator=g, device="cuda")
    t = torch.tensor([999, 900, 700, 500, 300, 100, 10, 0], device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        outs = {}
        for fused in (True, False):
            model = UNet2D(UNet2DConfig(), dtype=dtype, use_fused_attention=fused,
                           fast_norm=dtype != torch.float32)
            model.load_state_dict(state)
            model = model.cuda().eval()
            before = attention.LAUNCHES[attention.KERNEL]
            with torch.inference_mode(), full_f32_convolutions():
                outs[fused] = model(x, t)
            torch.cuda.synchronize()
            launched = attention.LAUNCHES[attention.KERNEL] - before
            check(launched == (ATTENTION_CALLS_PER_UNET if fused else 0),
                  f"UNet forward launched the kernel {launched} times")
        check(bool(torch.isfinite(outs[True]).all()), "UNet output not finite")
        check(outs[True].shape == x.shape, f"UNet output shape {outs[True].shape}")
        err = (outs[True] - outs[False]).abs().max().item()
        scale = outs[False].abs().max().item()
        print(f"[unet] full width, batch 8, {str(dtype)[6:]}: kernel vs plain attention "
              f"max_abs_err {err:.3e} (max |out| {scale:.3f}; allowed "
              f"{UNET_TOL[dtype]:.0e} x max |out|)", flush=True)
        check(err <= UNET_TOL[dtype] * scale, f"UNet {dtype} kernel vs plain")
    return state


def phase_cli(state: dict, card: str, base: Path) -> int:
    """The console CLI into `base`; `[reproduce]` reads its sidecars later."""
    (base / "checkpoints").mkdir(parents=True)
    torch.save(state, base / "checkpoints" / "unet_MEL_best.pth")
    argv = ["--base-dir", str(base), "--class-counts", f"MEL:{CLI_BATCH}",
            "--batch", str(CLI_BATCH), "--scheduler", "ddim",
            "--steps", str(CLI_STEPS), "--seed", "0", "--device", "cuda"]
    reset_launches()
    t0 = time.time()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(attention.LAUNCHES)
    check(rc == 0, f"cli.main returned {rc}")
    out = base / "ISIC2018_Task3_synt"
    jpgs = sorted(out.glob("ISIC_*.jpg"))
    sidecars = sorted(out.glob("ISIC_*.json"))
    rows = (base / "ISIC2018_Task3_GroundTruth_synt.csv").read_text().splitlines()[1:]
    check(len(jpgs) == CLI_BATCH and len(sidecars) == CLI_BATCH
          and len(rows) == CLI_BATCH,
          f"CLI wrote {len(jpgs)} images, {len(sidecars)} sidecars, {len(rows)} rows")
    for p in jpgs:
        arr = np.asarray(Image.open(p))
        check(arr.shape == (128, 128, 3), f"{p.name} has shape {arr.shape}")
    meta = json.loads(sidecars[0].read_text())
    check(meta["scheduler"]["kind"] == "ddim" and meta["device"].startswith("cuda"),
          f"sidecar {meta}")
    want = ATTENTION_CALLS_PER_UNET * CLI_STEPS
    print(f"[cli] wrote {len(jpgs)} JPEGs, sidecars and CSV rows in {wall:.3f} s "
          f"(cold: model load, first-call set-up, JPEG writes included); "
          f"attention_fwd launches {launches[attention.KERNEL]} (want {want})",
          flush=True)
    check(launches[attention.KERNEL] == want and launches[attention.FAST_KERNEL] == 0,
          f"main path launched {launches}, not {want} exact attention_fwd")

    # the same sampler, warm, timed alone; and its output against the
    # plain attention on the same seeds
    mm = ModelManager(checkpoints_dir=str(base / "checkpoints"), device="cuda")
    check(mm.load_model("MEL"), "ModelManager.load_model")
    sampler = mm.create_sampler(CLI_STEPS, scheduler="ddim")
    seeds = np.arange(CLI_BATCH, dtype=np.uint32)
    sampler.sample(mm.loaded_models["MEL"], seeds)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        sampler.sample(mm.loaded_models["MEL"], seeds)
        torch.cuda.synchronize()
        runs.append(time.time() - t0)
    sample_s = sorted(runs)[1]
    plain_model = UNet2D(mm.config, dtype=mm.dtype, use_fused_attention=False,
                         fast_norm=mm.fast_norm)
    plain_model.load_state_dict(state)
    with full_f32_convolutions():
        fused = sampler.sample(mm.loaded_models["MEL"], seeds)["images"]
        plain = sampler.sample(plain_model.cuda().eval(), seeds)["images"]
    check(bool(torch.isfinite(fused).all()), "sampled images not finite")
    check(fused.shape == (CLI_BATCH, 128, 128, 3), f"images shape {fused.shape}")
    err = (fused - plain).abs().max().item()
    print(f"[cli] DDIM {CLI_STEPS} steps, batch {CLI_BATCH}, f32, warm, median of "
          f"3 ({', '.join(f'{r:.4f}' for r in runs)} s): "
          f"{sample_s / CLI_STEPS:.5f} s/step, {CLI_BATCH / sample_s:.2f} images/s "
          f"on {card}; images kernel vs plain attention (full-f32 convolutions) "
          f"max_abs_err {err:.3e}", flush=True)
    check(err <= 1e-3, "sampled images, kernel vs plain attention")
    profile_sampler(mm, seeds, "[cli]", "f32")
    return launches[attention.KERNEL]


def profile_sampler(mm: ModelManager, seeds, tag: str, label: str,
                    scheduler: str = "ddim", spacing: str = "leading") -> dict:
    """PROFILE_STEPS warm steps of the `scheduler` sampler of `mm` (DDIM by
    default) under `torch.profiler`: the device's busy time per step, its
    idle share of the same walk on the host clock (median of 3, outside the
    profiler), and the attention kernels' part; printed under `tag`, the run
    named `label`."""
    from torch.profiler import ProfilerActivity, profile

    # imported here: `--host` runs this script on trees that lack it
    from synt_isic_tpu_torch.train.benchmark import device_seconds

    sampler = mm.create_sampler(PROFILE_STEPS, scheduler=scheduler, timestep_spacing=spacing)
    model = mm.loaded_models["MEL"]
    sampler.sample(model, seeds)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample(model, seeds)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / PROFILE_STEPS)
    step_s = statistics.median(runs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler.sample(model, seeds)
        torch.cuda.synchronize()
    busy, attn = (x / PROFILE_STEPS for x in device_seconds(prof))
    if busy == 0:
        print(f"{tag} torch.profiler recorded no device time: busy time and idle share not "
              "measured", flush=True)
        return {}
    print(f"{tag} torch.profiler over {PROFILE_STEPS} warm {SCHEDULER_NAMES[scheduler]} steps, "
          f"batch {CLI_BATCH}, {label}: "
          f"device busy {busy:.5f} s/step of {step_s:.5f} s/step on the host clock (idle "
          f"share {1 - busy / step_s:.3f}), of which the attention kernels {attn:.5f} s/step "
          f"({attn / busy:.3f} of busy)", flush=True)
    return dict(busy_s=busy, step_s=step_s, attention_s=attn)


def _cli_run(argv, want: int, what: str) -> dict:
    """`cli.main(argv)` in this process, with exactly `want` exact-kernel
    launches and no other; returns the launch counts."""
    reset_launches()
    t0 = time.time()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(attention.LAUNCHES)
    print(f"[samplers] {what}: rc {rc} in {wall:.3f} s (cold), attention_fwd launches "
          f"{launches[attention.KERNEL]} (want {want})", flush=True)
    check(rc == 0, f"{what}: cli.main returned {rc}")
    others = sum(n for key, n in launches.items() if key != attention.KERNEL)
    check(launches[attention.KERNEL] == want and others == 0, f"{what} launched {launches}")
    return launches


def _fresh_reproduce(sidecar: Path, ckpt: Path, want: int, what: str) -> dict:
    """`--reproduce` of `sidecar` in a fresh process: rc 0, byte-identical,
    exactly `want` exact-kernel launches."""
    meta = json.loads(sidecar.read_text())
    rc, launches, output = run_cli_process(
        ["--reproduce", str(sidecar), "--checkpoints", str(ckpt), "--device", "cuda"])
    original = sidecar.with_name(meta["filename"])
    redo = sidecar.with_name(f"{original.stem}_reproduced{original.suffix}")
    identical = redo.exists() and redo.read_bytes() == original.read_bytes()
    print(f"[samplers] --reproduce of {what} ({sidecar.name}) in a fresh process: rc {rc}, "
          f"byte-identical {identical}, launches {launches[attention.KERNEL]} (want {want})",
          flush=True)
    check(rc == 0 and identical, f"--reproduce of {what}: rc {rc}\n{output}")
    others = sum(n for key, n in launches.items() if key != attention.KERNEL)
    check(launches[attention.KERNEL] == want and others == 0,
          f"--reproduce of {what} launched {launches}")
    return launches


def phase_samplers(state: dict, card: str, base: Path, ckpt: Path) -> dict:
    """[samplers] the rest of the sampler through its entry points, f32 on
    the random full-width checkpoint `[cli]` wrote to `ckpt`: the CLI at UniPC-20 and SDE-20
    (trailing, batch 8) and a fresh-process `--reproduce` of each; the
    augment run (inpainting, DDIM 10 at strength 0.6, 2 variants) and its
    `--reproduce`; a UniPC-20 walk kernel vs plain attention; DDIM-20,
    UniPC-20 and SDE-20 timed in turns, and UniPC and SDE profiled."""
    base.mkdir(parents=True)
    per_walk = ATTENTION_CALLS_PER_UNET * SAMPLER_STEPS
    report = {}
    for kind in ("unipc", "dpm_solver_sde"):
        run_base = base / kind
        launches = _cli_run(["--base-dir", str(run_base), "--checkpoints", str(ckpt),
                             "--class-counts", f"MEL:{CLI_BATCH}", "--batch", str(CLI_BATCH),
                             "--scheduler", kind, "--steps", str(SAMPLER_STEPS),
                             "--timestep-spacing", SAMPLER_SPACING, "--seed", "0",
                             "--device", "cuda"],
                            per_walk, f"cli {SCHEDULER_NAMES[kind]} {SAMPLER_STEPS} steps "
                                      f"{SAMPLER_SPACING}, MEL:{CLI_BATCH}")
        out = run_base / "ISIC2018_Task3_synt"
        jpgs = sorted(out.glob("ISIC_*.jpg"))
        sidecars = sorted(out.glob("ISIC_*.json"))
        check(len(jpgs) == CLI_BATCH == len(sidecars), f"{kind}: {len(jpgs)} JPEGs")
        arrays = _png_arrays(jpgs)
        check(all(a.shape == (128, 128, 3) for a in arrays)
              and len({a.tobytes() for a in arrays}) == CLI_BATCH, f"{kind}: JPEG shapes")
        meta = json.loads(sidecars[2].read_text())
        check(meta["scheduler"]["kind"] == kind
              and meta["scheduler"]["timestep_spacing"] == SAMPLER_SPACING, f"sidecar {meta}")
        report[kind] = launches[attention.KERNEL]
        report[f"{kind}_reproduce"] = _fresh_reproduce(
            sidecars[2], ckpt, per_walk, f"a {SCHEDULER_NAMES[kind]} JPEG")[attention.KERNEL]

    # the augment run: a seeded source, a mask that keeps the left half
    src, mask_path = base / "source.png", base / "mask.png"
    pixels = np.random.default_rng(12).integers(0, 256, (128, 128, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(src)
    mask = np.full((128, 128), 255, np.uint8)
    mask[:, :64] = 0
    Image.fromarray(mask).save(mask_path)
    aug = base / "augmented"
    want = AUGMENT_COUNT * ATTENTION_CALLS_PER_UNET * AUGMENT_RUN
    launches = _cli_run(["--checkpoints", str(ckpt), "--classes", "MEL",
                         "--augment-source", str(src), "--augment-mask", str(mask_path),
                         "--augment-strength", str(AUGMENT_STRENGTH), "--scheduler", "ddim",
                         "--steps", str(AUGMENT_STEPS), "--count", str(AUGMENT_COUNT),
                         "--seed", "0", "--output", str(aug), "--device", "cuda"],
                        want, f"cli --augment-source with --augment-mask, DDIM "
                              f"{AUGMENT_STEPS} at strength {AUGMENT_STRENGTH}, "
                              f"{AUGMENT_COUNT} variants")
    outs = sorted(aug.glob("source_aug_*.png"))
    check(len(outs) == AUGMENT_COUNT, f"augment wrote {[p.name for p in outs]}")
    kept = [int(np.abs(np.asarray(Image.open(p)).astype(int)[:, :64]
                       - pixels[:, :64]).max()) for p in outs]
    print(f"[samplers] augment: the kept half of each output differs from the source by at "
          f"most {kept} 8-bit levels (allowed 1)", flush=True)
    check(max(kept) <= 1, "augment did not keep the masked-off half")
    report["augment"] = launches[attention.KERNEL]
    report["augment_reproduce"] = _fresh_reproduce(
        outs[1].with_suffix(".json"), ckpt, ATTENTION_CALLS_PER_UNET * AUGMENT_RUN,
        "an inpainted PNG")[attention.KERNEL]

    mm = ModelManager(checkpoints_dir=str(ckpt), device="cuda")
    check(mm.load_model("MEL"), "ModelManager.load_model")
    model = mm.loaded_models["MEL"]
    seeds = np.arange(CLI_BATCH, dtype=np.uint32)

    # the whole UniPC-20 walk, kernel vs plain attention, the same noise
    plain = UNet2D(mm.config, dtype=mm.dtype, use_fused_attention=False, fast_norm=mm.fast_norm)
    plain.load_state_dict(state)
    plain = plain.cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(21)
    noise = torch.randn(CLI_BATCH, 128, 128, 3, generator=g, device="cuda")
    report["unipc_walk_max_abs_err"] = {}
    for spacing in ("leading", "trailing"):
        sampler = mm.create_sampler(SAMPLER_STEPS, scheduler="unipc", timestep_spacing=spacing)
        x = noise.permute(0, 3, 1, 2).contiguous()
        t = sampler.params.timesteps[0].expand(CLI_BATCH)
        with torch.inference_mode(), full_f32_convolutions():
            eps_fused, eps_plain = model(x, t), plain(x, t)
            fused = sampler.sample(model, seeds, initial_noise=noise)["images"]
            reference = sampler.sample(plain, seeds, initial_noise=noise)["images"]
        d0 = (eps_fused - eps_plain).abs().max().item()
        scale = eps_plain.abs().max().item()
        check(d0 <= UNET_TOL[torch.float32] * scale, f"first-step eps difference {d0:.3e}")
        gain = (sampler.params.sigma[0] * sampler.params.inv_alpha[0]).item()
        bound = (UNIPC_WALK_TOL if spacing == "leading"
                 else UNIPC_FIRST_STEP_FACTOR * gain * d0)
        check(bool(torch.isfinite(fused).all()) and fused.shape == (CLI_BATCH, 128, 128, 3),
              f"UniPC images {fused.shape}")
        err = (fused - reference).abs().max().item()
        print(f"[samplers] UniPC {SAMPLER_STEPS} {spacing}, batch {CLI_BATCH}, f32: final images "
              f"kernel vs plain attention (full-f32 convolutions) max_abs_err {err:.3e} "
              f"(allowed {bound:.3e}); first step t={int(sampler.timesteps[0])}: eps "
              f"difference {d0:.3e} (max |eps| {scale:.3f}), sigma/alpha {gain:.1f}",
              flush=True)
        check(err <= bound, f"UniPC {spacing} walk, kernel vs plain attention")
        report["unipc_walk_max_abs_err"][spacing] = err

    # seconds per step of the warm walks, in turns; and of the same walks
    # with an identity eps model: the update's own cost, noise draws included
    samplers = {kind: mm.create_sampler(SAMPLER_STEPS, scheduler=kind,
                                        timestep_spacing=SAMPLER_SPACING)
                for kind in SAMPLER_KINDS}
    models = {"unet": model, "update": lambda x, t: x}
    for walk in samplers.values():
        for m in models.values():
            walk.sample(m, seeds)
    runs = {(kind, which): [] for kind in SAMPLER_KINDS for which in models}
    for r in range(SAMPLER_ROUNDS):
        for kind in (SAMPLER_KINDS if r % 2 == 0 else SAMPLER_KINDS[::-1]):
            for which, m in models.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                samplers[kind].sample(m, seeds)
                torch.cuda.synchronize()
                runs[kind, which].append((time.perf_counter() - t0) / SAMPLER_STEPS)
    step = {kind: statistics.median(runs[kind, "unet"]) for kind in SAMPLER_KINDS}
    update = {kind: statistics.median(runs[kind, "update"]) for kind in SAMPLER_KINDS}
    print(f"[samplers] warm walks of {SAMPLER_STEPS} {SAMPLER_SPACING} steps, batch "
          f"{CLI_BATCH}, f32, in turns, medians of {SAMPLER_ROUNDS} on {card}: "
          + "; ".join(f"{SCHEDULER_NAMES[k]} {step[k]:.5f} s/step "
                      f"({', '.join(f'{t:.5f}' for t in runs[k, 'unet'])})" for k in SAMPLER_KINDS)
          + "; against DDIM: " + ", ".join(f"{SCHEDULER_NAMES[k]} "
                                           f"{(step[k] - step['ddim']) * 1e3:+.3f} ms/step"
                                           for k in SAMPLER_KINDS[1:]), flush=True)
    print(f"[samplers] the same walks with an identity eps model (the update, its noise "
          f"draws and the loop alone), medians of {SAMPLER_ROUNDS}: "
          + "; ".join(f"{SCHEDULER_NAMES[k]} {update[k] * 1e3:.3f} ms/step" for k in SAMPLER_KINDS)
          + "; against DDIM: " + ", ".join(f"{SCHEDULER_NAMES[k]} "
                                           f"{(update[k] - update['ddim']) * 1e3:+.3f} ms/step"
                                           for k in SAMPLER_KINDS[1:]), flush=True)
    report["update_s"] = update
    report["step_s"] = step
    report["profiles"] = {kind: profile_sampler(mm, seeds, "[samplers]",
                                                f"f32, {SAMPLER_SPACING}", scheduler=kind,
                                                spacing=SAMPLER_SPACING)
                          for kind in SAMPLER_KINDS[1:]}
    return report


def _xai_stage_errors(results: dict) -> dict:
    """The stages of a pipeline result that recorded a caught failure, with
    its message."""
    return {key: results[key]["error"]
            for key in ("time_shap", "statistical_validation", "sanity_checks", "gradcam")
            if isinstance(results.get(key), dict) and "error" in results[key]}


def _xai_compare(card_res: dict, cpu_res: dict) -> dict:
    """The card's pipeline result against the CPU port's on the same frames:
    the largest difference of each part, each against its XAI_TOL."""
    out = {"attribution": 0.0, "time_shap": 0.0, "gradcam": 0.0, "cfi": 0.0, "sanity": 0.0}
    masks_equal = masks_total = pixels_off = 0
    for step, want in cpu_res["xai_maps"].items():
        got = card_res["xai_maps"][step]["attribution_map"]
        ref = want["attribution_map"]
        out["attribution"] = max(out["attribution"],
                                 float(np.abs(got - ref).max() / np.abs(ref).max()))
        for region in ("top_k", "bottom_k"):
            a = card_res["region_analysis"][step][region]["mask"]
            b = cpu_res["region_analysis"][step][region]["mask"]
            masks_total += 1
            masks_equal += int(np.array_equal(a, b))
            pixels_off = max(pixels_off, int((a != b).sum()))
    for step, per_key in cpu_res["cfi_analysis"].items():
        for key, want in per_key.items():
            region = "top_k" if key.startswith("top_k") else "bottom_k"
            if np.array_equal(card_res["region_analysis"][step][region]["mask"],
                              cpu_res["region_analysis"][step][region]["mask"]):
                got = card_res["cfi_analysis"][step][key]["target_class_analysis"]["cfi"]
                out["cfi"] = max(out["cfi"], abs(got - want["target_class_analysis"]["cfi"]))
    raw_card, raw_cpu = card_res["time_shap"]["raw_data"], cpu_res["time_shap"]["raw_data"]
    conf_diff = float(np.abs(raw_card["confidence_scores"] - raw_cpu["confidence_scores"]).max())
    out["time_shap"] = max(conf_diff, float(np.abs(raw_card["probability_scores"]
                                                   - raw_cpu["probability_scores"]).max()))
    # the importance is min-max normalised, (c - min c) / R: a difference d
    # of the scores moves it by at most 4 d / R (d in c and in min c, 2 d in
    # R), so it is held to that, from the scores' own difference
    spread = float(np.ptp(raw_cpu["confidence_scores"]))
    out["importance"] = float(np.abs(card_res["time_shap"]["importance"]
                                     - cpu_res["time_shap"]["importance"]).max())
    out["importance_bound"] = 4 * max(conf_diff, 1e-12) / spread if spread > 1e-6 else 1e-12
    for step, cam in cpu_res["gradcam"].items():
        out["gradcam"] = max(out["gradcam"], float(np.abs(card_res["gradcam"][step] - cam).max()))
    out["gradcam"] = max(out["gradcam"], float(np.abs(card_res["gradcam_summary"]
                                                      - cpu_res["gradcam_summary"]).max()))
    for test, key in (("weight_randomization_test", "correlations_per_trial"),
                      ("input_independence_test", "independence_correlations"),
                      ("model_sensitivity_test", "different_class_correlations")):
        got = np.asarray(card_res["sanity_checks"][test][key])
        want = np.asarray(cpu_res["sanity_checks"][test][key])
        check(got.shape == want.shape, f"sanity {test} shapes {got.shape} {want.shape}")
        out["sanity"] = max(out["sanity"], float(np.abs(got - want).max()))
    out["masks_equal"], out["masks_total"], out["mask_pixels_off"] = (masks_equal, masks_total,
                                                                      pixels_off)
    return out


def phase_xai(state: dict, card: str, base: Path) -> dict:
    """[xai] the XAI engine through its two entry points on the card: the
    standalone run (`run_standalone_xai`, as `python -m
    synt_isic_tpu_torch.xai.standalone` runs it) at the reference defaults,
    with its K1 launches, its walk kernel vs plain, its pipeline against the
    CPU port's on the same frames and its files; K1 at the walk's batch-1
    shapes in turns with SDPA; and `ImageGenerator`'s integrated XAI."""
    from unittest import mock

    from synt_isic_tpu_torch.diffusion.sampler import save_indices
    from synt_isic_tpu_torch.models import unet2d as unet2d_module
    from synt_isic_tpu_torch.models.classifier import LesionClassifier, random_resnet
    from synt_isic_tpu_torch.xai import (XAIAnalyzer, create_integrated_xai_analyzer,
                                         run_comprehensive_xai_pipeline, standalone)

    report = {}
    ckpt = base / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / "unet_MEL_best.pth")
    clf_state = {}
    for key, value in random_resnet(XAI_OUTPUTS, XAI_CLASSIFIER_SEED).state_dict().items():
        clf_state[key] = value
        if key.endswith("running_var"):         # torchvision's BatchNorm entry
            clf_state[key.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    clf_path = ckpt / "classifier.pth"
    torch.save(clf_state, clf_path)
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        print("[xai] matplotlib is not installed here: both runs write their results "
              "without figures (save_figures=False)", flush=True)

    # the standalone run; the pipeline call and the plain attention watched
    seen, plain_calls, logs = {}, [], []
    plain_ref = unet2d_module.attention_reference

    def pipeline_spy(**kwargs):
        seen.update(kwargs)
        return run_comprehensive_xai_pipeline(**kwargs)

    def plain_spy(*args, **kwargs):
        plain_calls.append(1)
        return plain_ref(*args, **kwargs)

    out_dir = base / "standalone"
    reset_launches()
    with mock.patch.object(standalone, "run_comprehensive_xai_pipeline", pipeline_spy), \
            mock.patch.object(unet2d_module, "attention_reference", plain_spy):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = standalone.run_standalone_xai(
            target_class=XAI_CLASS, seed=XAI_SEED, inference_steps=XAI_STEPS,
            save_every=XAI_SAVE_EVERY, checkpoints_dir=str(ckpt), results_dir=str(out_dir),
            ig_n_steps=XAI_IG_STEPS, shap_n_samples=XAI_SHAP_SAMPLES,
            n_bootstrap=XAI_BOOTSTRAP, n_permutations=XAI_PERMUTATIONS, device="cuda",
            save_figures=figures, log=lambda msg: logs.append((time.perf_counter(), msg)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(attention.LAUNCHES)
    check(results is not None, f"run_standalone_xai returned None: {logs}")
    want = ATTENTION_CALLS_PER_UNET * XAI_STEPS
    others = sum(n for key, n in launches.items() if key != attention.KERNEL)
    print(f"[xai] standalone run (MEL, seed {XAI_SEED}, DDPM {XAI_STEPS}, every "
          f"{XAI_SAVE_EVERY}th step and the last kept): attention_fwd launches "
          f"{launches[attention.KERNEL]} "
          f"(want {want}), other kernels {others}, plain attention calls {len(plain_calls)}",
          flush=True)
    check(launches[attention.KERNEL] == want and others == 0 and not plain_calls,
          f"the standalone walk launched {launches} with {len(plain_calls)} plain calls")
    clf = seen["classifier"]
    tensors = list(clf.model.state_dict().values())
    check(clf.device.type == "cuda" and all(t.is_cuda for t in tensors),
          "a classifier tensor is not on the card")
    frames = np.asarray(seen["trajectory"])
    timesteps = list(seen["timesteps"])
    n_frames = len(save_indices(XAI_STEPS, XAI_SAVE_EVERY))
    check(frames.shape == (n_frames, 128, 128, 3) and bool(np.isfinite(frames).all()),
          f"trajectory {frames.shape}")
    failures = [msg for _, msg in logs if "failed" in msg]
    check(not _xai_stage_errors(results) and not failures,
          f"stages failed: {_xai_stage_errors(results)}; {failures}")
    check(len(results["xai_maps"]) == n_frames and len(results["gradcam"]) == n_frames,
          "a frame's maps are missing")
    saved = json.loads((out_dir / "analysis_results.json").read_text())
    with open(out_dir / "full_results.pkl", "rb") as f:
        pickled = pickle.load(f)
    check(set(pickled) == XAI_RESULT_KEYS and set(saved) == XAI_RESULT_KEYS - {
        "gradcam", "gradcam_most_important", "gradcam_summary"},
        f"result files' keys {sorted(saved)} / {sorted(pickled)}")
    stamps = {msg.split(":")[0]: t for t, msg in logs}
    walk_s = stamps.get("[xai-standalone] trajectory", t0) - stamps.get(
        "[xai-standalone] classifier loaded", t0)
    stage_s = results["metadata"]["stage_seconds"]
    files = sorted(p.name for p in out_dir.iterdir())
    print(f"[xai] standalone on {card}: {wall:.3f} s in all ({n_frames} frames; the DDPM load "
          f"and the walk {walk_s:.3f} s), {3600 / wall:.1f} trajectories/hour, "
          f"{3600 * n_frames / wall:.0f} frame attributions/hour; {len(files)} files "
          f"({sum(n.endswith('.png') for n in files)} figures)", flush=True)
    print(f"[xai] stage_seconds on {card}: {json.dumps(stage_s)}", flush=True)
    report.update(launches=launches[attention.KERNEL], wall_s=wall, walk_s=walk_s,
                  stage_seconds=stage_s, trajectories_per_hour=3600 / wall,
                  frames=n_frames, figures=figures)

    # the same walk through the plain attention, from the same noise
    mm = ModelManager(checkpoints_dir=str(ckpt), device="cuda")
    check(mm.load_model(XAI_CLASS), "ModelManager.load_model")
    sampler = mm.create_sampler(XAI_STEPS)
    model = mm.loaded_models[XAI_CLASS]
    plain = UNet2D(mm.config, dtype=mm.dtype, use_fused_attention=False, fast_norm=mm.fast_norm)
    plain.load_state_dict(state)
    plain = plain.to(mm.device).eval()
    seeds = np.asarray([XAI_SEED], np.uint32)
    noise = sampler.initial_noise(seeds)
    runs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample(model, seeds, initial_noise=noise)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / XAI_STEPS)
    step_s = statistics.median(runs[1:])
    with full_f32_convolutions():
        walks = [sampler.sample(m, seeds, capture_trajectory=XAI_SAVE_EVERY, stream_to_host=True,
                                initial_noise=noise)["trajectory"] for m in (model, plain)]
    walk_err = float(np.abs(walks[0] - walks[1]).max())
    print(f"[xai] DDPM {XAI_STEPS}, batch 1, f32 on {card}: warm {step_s:.5f} s/step on the "
          f"host clock (median of 3: {', '.join(f'{r:.5f}' for r in runs[1:])}); the {n_frames} "
          f"kept frames kernel vs plain attention (full-f32 convolutions) max_abs_err "
          f"{walk_err:.3e} (allowed {XAI_WALK_TOL:.0e})", flush=True)
    check(walk_err <= XAI_WALK_TOL, "the XAI walk, kernel vs plain attention")
    report.update(walk_step_s=step_s, walk_max_abs_err=walk_err)

    # the pipeline on the card and on the CPU over the same frames
    def pipeline(device):
        classifier, _ = LesionClassifier.from_checkpoint(str(clf_path), num_classes=XAI_OUTPUTS,
                                                         device=device)
        analyzer = XAIAnalyzer(classifier, ig_n_steps=XAI_CMP_IG_STEPS,
                               shap_n_samples=XAI_CMP_SHAP_SAMPLES, seed=XAI_SEED)
        failed = []
        t0 = time.perf_counter()
        res = run_comprehensive_xai_pipeline(
            frames, timesteps, analyzer, classifier, 0, XAI_CLASS, save_results=False,
            save_figures=False, n_bootstrap=XAI_BOOTSTRAP, n_permutations=XAI_PERMUTATIONS,
            log=lambda msg: failed.append(msg) if "failed" in msg else None)
        if device == "cuda":
            torch.cuda.synchronize()
        check(not _xai_stage_errors(res) and not failed,
              f"{device} pipeline stages failed: {_xai_stage_errors(res)}; {failed}")
        return res, time.perf_counter() - t0

    with full_f32_convolutions():
        card_res, card_s = pipeline("cuda")
    cpu_res, cpu_s = pipeline("cpu")
    diff = _xai_compare(card_res, cpu_res)
    print(f"[xai] pipeline card (full-f32 convolutions, {card_s:.3f} s) vs CPU port "
          f"({cpu_s:.3f} s, {torch.get_num_threads()} threads) on the same {n_frames} frames: "
          f"attribution maps {diff['attribution']:.3e} x max|map| (allowed "
          f"{XAI_TOL['attribution']:.0e}), Time-SHAP scores {diff['time_shap']:.3e} (allowed "
          f"{XAI_TOL['time_shap']:.0e}) and importance {diff['importance']:.3e} (allowed "
          f"{diff['importance_bound']:.3e}: 4 x the scores' difference over their range), "
          f"Grad-CAM {diff['gradcam']:.3e} (allowed "
          f"{XAI_TOL['gradcam']:.0e}), CFI {diff['cfi']:.3e} (allowed {XAI_TOL['cfi']:.0e}) "
          f"where the masks agree ({diff['masks_equal']} of {diff['masks_total']} top/bottom-k "
          f"masks equal, at most {diff['mask_pixels_off']} pixels apart), sanity correlations "
          f"{diff['sanity']:.3e} (allowed {XAI_TOL['sanity']:.0e})", flush=True)
    for part, tol in list(XAI_TOL.items()) + [("importance", diff["importance_bound"])]:
        check(diff[part] <= tol, f"the XAI pipeline, card vs CPU: {part} {diff[part]:.3e}")
    report["card_vs_cpu"] = diff
    report["card_f32_pipeline_s"], report["cpu_pipeline_s"] = card_s, cpu_s

    # K1 at the walk's batch-1 shapes, in turns with SDPA
    g = torch.Generator(device="cuda").manual_seed(9)
    report["batch1"] = {}
    for shape in XAI_BATCH1_SHAPES:
        b, h, t, d = shape
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        views = [z.transpose(1, 2).reshape(b, t, h * d).view(b, t, h, d).transpose(1, 2)
                 for z in (q, k, v)]
        err = (attention.fused_attention(*views) - attention.attention_reference(q, k, v)
               ).abs().max().item()
        check(err <= TOL[torch.float32], f"K1 at {shape}: {err:.3e}")
        fns = {"kernel": lambda: attention.fused_attention(*views),
               "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)}
        host = in_turns(fns)
        device = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                device[name].append(graph_ms(fns[name]))
        device = {name: statistics.mean(ts) for name, ts in device.items()}
        plain_ms = cuda_ms(lambda: attention.attention_reference(q, k, v))
        bound, bound_by, exp_ms, unit = attention_bound_ms(shape, torch.float32)
        print(f"[xai] attention {shape} f32 on {card}, in turns with SDPA: kernel "
              f"{host['kernel']:.4f} ms host-launched ({device['kernel']:.4f} on the device "
              f"alone, from a CUDA graph), sdpa {host['sdpa']:.4f} ms ({device['sdpa']:.4f}), "
              f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({unit}); max_abs_err {err:.3e}",
              flush=True)
        report["batch1"][str(shape)] = dict(
            ms=host["kernel"], device_ms=device["kernel"], library_ms=host["sdpa"],
            library_device_ms=device["sdpa"], plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, max_abs_err=err)

    # the library generator's integrated XAI
    lib = base / "library"
    gen = ImageGenerator(checkpoints_dir=str(ckpt), device="cuda")
    gen.set_inference_steps(XAI_GEN_STEPS)
    gen.set_generation_seed(0)
    gen_logs = []
    gen.set_log_callback(lambda msg, level: gen_logs.append((level, msg)))
    gen.set_xai_analyzer(create_integrated_xai_analyzer(
        str(clf_path), device="cuda", verbose=False, ig_n_steps=10, shap_n_samples=64,
        n_bootstrap=200, n_permutations=1000, save_figures=figures, viz_every_n=5))
    gen.set_save_trajectory(True)
    gen.set_xai_frequency(XAI_GEN_FREQUENCY)
    reset_launches()
    t0 = time.perf_counter()
    result = gen.generate_images([(XAI_CLASS, XAI_GEN_IMAGES)], str(lib))
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = attention.LAUNCHES[attention.KERNEL]
    jsons = sorted((lib / "xai_results" / XAI_CLASS).glob("xai_*.json"))
    failed = [msg for level, msg in gen_logs if "integrated XAI failed" in msg]
    print(f"[xai] ImageGenerator integrated XAI on {card}: {result.get('generated')} images "
          f"(DDPM {XAI_GEN_STEPS}) in {gen_wall:.3f} s, attention_fwd launches {gen_launches} "
          f"(want {ATTENTION_CALLS_PER_UNET * XAI_GEN_STEPS * XAI_GEN_IMAGES}), "
          f"{len(jsons)} xai_results JSON files ({', '.join(p.name for p in jsons)}), "
          f"failures logged {len(failed)}", flush=True)
    check(result.get("generated") == XAI_GEN_IMAGES and not failed,
          f"generator run {result}; {failed}")
    check(gen_launches == ATTENTION_CALLS_PER_UNET * XAI_GEN_STEPS * XAI_GEN_IMAGES,
          f"integrated run launched {gen_launches}")
    check([p.name.rsplit("_", 2)[0] for p in jsons] == ["xai_ISIC_0000002", "xai_ISIC_0000004"],
          f"xai_results files {[p.name for p in jsons]}")
    for path in jsons:
        data = json.loads(path.read_text())
        check(not _xai_stage_errors(data) and data["metadata"]["n_timesteps"] == XAI_GEN_STEPS
              and len(data["xai_maps"]) == XAI_GEN_STEPS,
              f"{path.name}: {_xai_stage_errors(data)}")
    report.update(launches_integrated=gen_launches, integrated_wall_s=gen_wall,
                  integrated_json=len(jsons))
    return report


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.seen = out, io.StringIO()

    def write(self, text):
        self.seen.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _serve_requests(host: str, port: int, payloads: list, delays: list) -> list:
    """Each payload sent by its own client thread `delays[i]` s after the
    call; returns (reply, seconds from the first send to the reply, clock
    at the reply) per payload."""
    from synt_isic_tpu_torch.serve import request

    results = [None] * len(payloads)
    t0 = time.perf_counter()

    def client(i):
        time.sleep(max(0.0, t0 + delays[i] - time.perf_counter()))
        sent = time.perf_counter()
        reply = request(host, port, payloads[i], timeout=600)
        done = time.perf_counter()
        results[i] = (reply, done - sent, done)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads) and all(results), "a client got no reply")
    return results


def _serve_subprocess(ckpt: Path, out: Path) -> dict:
    """`python -m synt_isic_tpu_torch.serve` in a fresh process: the bound
    port from its "serving on" line, then classes, a 2-image generate and
    shutdown; the process is killed if it is still running at the end."""
    from synt_isic_tpu_torch.serve import request

    argv = ["--port", "0", "--warmup", "MEL", "--batch", str(SERVE_BATCH), "--steps",
            str(SERVE_STEPS), "--scheduler", "ddim", "--checkpoints", str(ckpt),
            "--output-root", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-m", "synt_isic_tpu_torch.serve", *argv],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, serving = [], []
    found = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving on "):
                serving.append(line)
                found.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        t0 = time.perf_counter()
        check(found.wait(timeout=300), "the daemon printed no 'serving on' line:\n"
              + "\n".join(lines))
        up_s = time.perf_counter() - t0
        host, port = re.search(r"serving on ([\d.]+):(\d+)", serving[0]).groups()
        classes = request(host, int(port), {"op": "classes"}, timeout=60)
        reply = request(host, int(port), {"op": "generate", "class": "MEL", "count": 2},
                        timeout=300)
        down = request(host, int(port), {"op": "shutdown"}, timeout=60)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    check(classes == {"ok": True, "classes": ["MEL"]}, f"daemon classes: {classes}")
    check(reply.get("ok") and len(reply["files"]) == 2
          and all(Path(f).exists() for f in reply["files"]), f"daemon generate: {reply}")
    check(down.get("ok") and rc == 0, f"daemon shutdown {down}, rc {rc}:\n" + "\n".join(lines))
    warm_line = next((line for line in lines if "compiled_batches" in line), "")
    print(f"[serve] python -m synt_isic_tpu_torch.serve {' '.join(argv[:8])} ...: up in "
          f"{up_s:.1f} s ({warm_line.strip()}); classes, a 2-image generate "
          f"({reply['elapsed_s']} s) and shutdown: rc {rc}", flush=True)
    return {"up_s": up_s, "rc": rc}


def _serve_webui(ckpt: Path, base: Path) -> dict:
    """The web UI on the card: one 4-image generation through its worker,
    then the device memory its state reports."""
    import urllib.request

    from synt_isic_tpu_torch.app.webui import WebUIServer
    from synt_isic_tpu_torch.utils.config import ConfigManager

    cfg = ConfigManager(config_file=str(base / "config.json"), project_root=str(base))
    gen = ImageGenerator(config=cfg, checkpoints_dir=str(ckpt), device="cuda")
    app = WebUIServer(generator=gen, config=cfg, checkpoints_dir=str(ckpt),
                      output_dir=str(base / "generated")).start()

    def call(path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{app.port}{path}",
                                     data=None if body is None else json.dumps(body).encode(),
                                     method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    try:
        t0 = time.perf_counter()
        started = call("/api/generate", {"classes": {"MEL": SERVE_WEBUI_IMAGES},
                                         "steps": SERVE_STEPS, "seed_mode": "fixed",
                                         "seed": SERVE_SEED, "postprocess": False})
        deadline = time.time() + 300
        state = call("/api/state")
        while state["busy"] and time.time() < deadline:
            time.sleep(0.1)
            state = call("/api/state")
        wall = time.perf_counter() - t0
    finally:
        app.stop()
    files = sorted((base / "generated" / "MEL").glob("ISIC_*.png"))
    check(started.get("ok") and not state["busy"]
          and (state["last_result"] or {}).get("generated") == SERVE_WEBUI_IMAGES
          and len(files) == SERVE_WEBUI_IMAGES, f"web UI generation: {state}")
    mem = state["memory"]
    check(state["device"].startswith("cuda") and (mem["mb_in_use"] or 0) > 0,
          f"web UI state reports no device memory: {state['device']} {mem}")
    print(f"[serve] web UI (WebUIServer, f32, batch {gen.batch_size}, "
          f"{gen.scheduler_kind} {SERVE_STEPS}): {SERVE_WEBUI_IMAGES} PNGs in {wall:.2f} s; "
          f"/api/state memory {mem} on {state['device']}, n_devices {state['n_devices']}",
          flush=True)
    return {"wall_s": wall, "memory": mem}


def phase_serve(state: dict, card: str, base: Path) -> dict:
    """[serve] the serving path on the card: an in-process `GenerationServer`
    over `ImageGenerator(device="cuda")` (warmup, coalesced concurrent
    clients, the served bytes against the library's, interactive requests
    behind a bulk job, the scheduler-only fast lane, an XAI request,
    status), the daemon as `python -m synt_isic_tpu_torch.serve` in a fresh
    process, and the web UI; K1 launched exactly 6 times per UNet
    evaluation of every walk, counted from the sampler calls, and no plain
    attention call."""
    from unittest import mock

    from synt_isic_tpu_torch.diffusion.sampler import DiffusionSampler
    from synt_isic_tpu_torch.models import unet2d as unet2d_module
    from synt_isic_tpu_torch.serve import GenerationServer, request
    from synt_isic_tpu_torch.xai import create_integrated_xai_analyzer

    ckpt = base / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / "unet_MEL_best.pth")
    report = {}

    def generator() -> ImageGenerator:
        gen = ImageGenerator(checkpoints_dir=str(ckpt), compute_dtype=torch.bfloat16)
        gen.scheduler_kind = "ddim"
        gen.set_inference_steps(SERVE_STEPS)
        gen.batch_size = SERVE_BATCH
        return gen

    gen = generator()
    fast = generator()
    fast.model_manager = gen.model_manager          # serve --fast-scheduler: one set of weights
    fast.scheduler_kind, fast.timestep_spacing = "unipc", "trailing"
    fast.set_inference_steps(SERVE_FAST_STEPS)
    fast.save_trajectory = False
    figures = importlib.util.find_spec("matplotlib") is not None
    srv = GenerationServer(
        gen, port=0, output_root=str(base / "served"), max_batch=SERVE_BATCH,
        interactive_cost=SERVE_COST, fast_generator=fast,
        xai_analyzer_factory=lambda: create_integrated_xai_analyzer(
            device="cuda", verbose=False, ig_n_steps=10, shap_n_samples=64,
            n_bootstrap=200, n_permutations=1000, save_figures=figures, viz_every_n=5))
    host, port = srv.address

    walks, plain_calls = [], []
    sample = DiffusionSampler.sample
    plain_ref = unet2d_module.attention_reference

    def counted_sample(self, model, seeds, *args, **kwargs):
        walks.append(self.config.num_inference_steps)
        return sample(self, model, seeds, *args, **kwargs)

    def plain_spy(*args, **kwargs):
        plain_calls.append(1)
        return plain_ref(*args, **kwargs)

    reset_launches()
    t_phase = time.perf_counter()
    with mock.patch.object(DiffusionSampler, "sample", counted_sample), \
            mock.patch.object(unet2d_module, "attention_reference", plain_spy):
        srv.start()
        try:
            # 1. warmup: weights, kernels, a b1 and a device-batch walk
            w = request(host, port, {"op": "warmup", "class": "MEL", "compile": True})
            check(w.get("ok") and w.get("compiled_batches") == [1, SERVE_BATCH],
                  f"warmup: {w}")
            print(f"[serve] GenerationServer over ImageGenerator(device='cuda'), bf16, batch "
                  f"{SERVE_BATCH}, DDIM {SERVE_STEPS} leading: warmup {w}", flush=True)

            # 2. concurrent seedless clients, coalesced; the library's warm rate
            burst = _serve_requests(host, port, [
                {"op": "generate", "class": "MEL", "count": SERVE_COUNT,
                 "postprocess": False}] * SERVE_CLIENTS, [0.0] * SERVE_CLIENTS)
            replies = [r for r, _, _ in burst]
            files = [f for r in replies for f in r.get("files", [])]
            served_s = max(done for _, _, done in burst) - min(
                done - lat for _, lat, done in burst)
            check(all(r.get("ok") for r in replies) and len(files) == SERVE_CLIENTS * SERVE_COUNT
                  and all(Path(f).exists() for f in files)
                  and max(r["coalesced"] for r in replies) >= 2, f"burst replies {replies}")
            lib = generator()
            lib.generate_images([("MEL", SERVE_CLIENTS * SERVE_COUNT)], str(base / "lib_cold"),
                                postprocess=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lib.generate_images([("MEL", SERVE_CLIENTS * SERVE_COUNT)], str(base / "lib_warm"),
                                postprocess=False)
            torch.cuda.synchronize()
            lib_s = time.perf_counter() - t0
            n = SERVE_CLIENTS * SERVE_COUNT
            report.update(served_img_s=n / served_s, library_img_s=n / lib_s)
            print(f"[serve] {SERVE_CLIENTS} concurrent clients x {SERVE_COUNT} seedless images: "
                  f"all ok, {len(files)} files, coalesced "
                  f"{sorted(r['coalesced'] for r in replies)}; served {n} images in "
                  f"{served_s:.3f} s = {n / served_s:.2f} images/s (host clock, first send "
                  f"to last reply) against generate_images warm {n / lib_s:.2f} images/s "
                  f"({n} images in blocks of {SERVE_BATCH}, {lib_s:.3f} s) on {card}: "
                  f"{lib_s / served_s:.3f} of the library's rate", flush=True)

            # 3. the served bytes are the library's
            seeded = request(host, port, {"op": "generate", "class": "MEL",
                                          "count": SERVE_BATCH, "seed": SERVE_SEED})
            lib.set_generation_seed(SERVE_SEED)
            lib.generate_images([("MEL", SERVE_BATCH)], str(base / "lib_seeded"))
            mine = [Path(f).read_bytes() for f in seeded.get("files", [])]
            theirs = [p.read_bytes() for p in
                      sorted((base / "lib_seeded" / "MEL").glob("ISIC_*.png"))]
            check(seeded.get("ok") and len(mine) == SERVE_BATCH and mine == theirs,
                  f"served fixed-seed PNGs differ from generate_images': {seeded}")
            print(f"[serve] fixed-seed generate of {SERVE_BATCH}: PNGs byte-identical to "
                  f"ImageGenerator.generate_images([('MEL', {SERVE_BATCH})]) at seed "
                  f"{SERVE_SEED} on a second generator", flush=True)

            # 4. interactive requests behind a bulk job
            mixed = _serve_requests(host, port, [
                {"op": "generate", "class": "MEL", "count": SERVE_BULK,
                 "steps": SERVE_BULK_STEPS, "postprocess": False}] + [
                {"op": "generate", "class": "MEL", "count": 1, "steps": SERVE_STEPS,
                 "postprocess": False}] * SERVE_INTERACTIVE,
                [0.0] + [0.5 + SERVE_GAP * i for i in range(SERVE_INTERACTIVE)])
            (bulk, bulk_s, bulk_done), inter = mixed[0], mixed[1:]
            lat = sorted(l for _, l, _ in inter)
            p50 = lat[min(len(lat) - 1, round(0.5 * (len(lat) - 1)))]
            p95 = lat[min(len(lat) - 1, round(0.95 * (len(lat) - 1)))]
            check(bulk.get("ok") and len(bulk["files"]) == SERVE_BULK, f"bulk reply {bulk}")
            check(all(r.get("ok") and r.get("interactive") is True and done < bulk_done
                      for r, _, done in inter),
                  f"interactive replies {[(r, done - bulk_done) for r, _, done in inter]}")
            report.update(interactive_p50_s=p50, interactive_p95_s=p95, bulk_s=bulk_s)
            print(f"[serve] mixed load (bench_serve.py --mixed): bulk {SERVE_BULK} images at "
                  f"DDIM {SERVE_BULK_STEPS} in {bulk_s:.3f} s; {SERVE_INTERACTIVE} interactive b1 "
                  f"DDIM {SERVE_STEPS} requests {SERVE_GAP} s apart, all served between its "
                  f"blocks and answered before it: p50 {p50:.3f} s, p95 {p95:.3f} s "
                  f"({', '.join(f'{x:.3f}' for x in lat)})", flush=True)

            # 5. the scheduler-only fast lane; 6. an XAI request
            f = request(host, port, {"op": "generate", "class": "MEL", "count": 2,
                                     "fast": True, "postprocess": False})
            check(f.get("ok") and f.get("fast_steps") == SERVE_FAST_STEPS
                  and len(f["files"]) == 2, f"fast lane reply {f}")
            t0 = time.perf_counter()
            x = request(host, port, {"op": "generate", "class": "MEL", "count": 1,
                                     "xai": True, "postprocess": False})
            xai_s = time.perf_counter() - t0
            check(x.get("ok") and x.get("xai_dir") and "xai_error" not in x
                  and any(Path(x["xai_dir"]).rglob("analysis_results.json")),
                  f"xai reply {x}")
            print(f"[serve] fast lane (UniPC {SERVE_FAST_STEPS} trailing, the same weights): "
                  f"2 images in {f['elapsed_s']} s, fast_steps {f['fast_steps']}; an xai "
                  f"request of 1 image (IG 10, SHAP 64): {xai_s:.2f} s, {x['xai_dir']}",
                  flush=True)

            # 7. status
            st = request(host, port, {"op": "status"})
            check(st.get("ok") and st["loaded_models"] == ["MEL"] and st["mesh"] is None
                  and st["latency"]["n"] > 0 and st["interactive_latency"]["n"] >= 1
                  and st["throughput_img_s"] > 0, f"status {st}")
            print(f"[serve] status: latency {st['latency']}, interactive "
                  f"{st['interactive_latency']}, throughput {st['throughput_img_s']} img/s, "
                  f"served {st['served_images']}, loaded {st['loaded_models']}", flush=True)
        finally:
            srv.stop()
        webui = _serve_webui(ckpt, base / "webui")
        torch.cuda.synchronize()
    launches = dict(attention.LAUNCHES)
    evaluations = sum(walks)
    others = sum(n for key, n in launches.items() if key != attention.KERNEL)
    print(f"[serve] {len(walks)} walks, {evaluations} UNet evaluations in-process: "
          f"attention_fwd launches {launches[attention.KERNEL]} (want "
          f"{ATTENTION_CALLS_PER_UNET * evaluations}), other kernels {others}, plain "
          f"attention calls {len(plain_calls)}; in-process part "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(launches[attention.KERNEL] == ATTENTION_CALLS_PER_UNET * evaluations
          and others == 0 and not plain_calls,
          f"the serving path launched {launches} for {evaluations} evaluations, "
          f"{len(plain_calls)} plain calls")
    daemon = _serve_subprocess(ckpt, base / "daemon")
    report.update(launches=launches[attention.KERNEL], unet_evaluations=evaluations,
                  webui=webui, daemon=daemon)
    return report


def phase_train(card: str, f32: bool = False) -> dict:
    """The training entry point (`[train]`; with `f32`, `train --no-bf16` as
    `[train-f32]`), its launch counts, and train -> sample."""
    tag, compute = ("[train-f32]", "f32 compute") if f32 else ("[train]", "bf16 compute")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--classes", "MEL", "--procedural", str(TRAIN_IMAGES),
                "--epochs", str(TRAIN_EPOCHS), "--batch", str(TRAIN_BATCH),
                "--checkpoints", tmp, "--seed", "0", "--device", "cuda"]
        argv += ["--no-bf16"] if f32 else []
        tee = _Tee(sys.stdout)
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            rc = train_entry.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(attention.LAUNCHES)
        check(rc == 0, f"train main returned {rc}")
        losses = [float(m) for m in re.findall(r"\[train:MEL\] epoch \d+/\d+ loss=(\S+)",
                                               tee.seen.getvalue())]
        check(len(losses) == TRAIN_EPOCHS and all(math.isfinite(x) for x in losses),
              f"loss history {losses}")
        want = ATTENTION_CALLS_PER_UNET * TRAIN_STEPS
        print(f"{tag} {TRAIN_STEPS} steps of batch {TRAIN_BATCH} ({compute}, f32 "
              f"parameters) in {wall:.3f} s (cold: model build, first-call set-up and "
              f"checkpoint writes included); losses {losses}; launches attention_fwd "
              f"{launches[attention.KERNEL]}, attention_bwd {launches[attention.BWD_KERNEL]} "
              f"(want {want} each), attention_bwd_stats "
              f"{launches[attention.STATS_KERNEL]} (want 0: the backward reads the "
              f"forward's saved statistics)", flush=True)
        check(launches[attention.KERNEL] == want and launches[attention.BWD_KERNEL] == want
              and launches[attention.STATS_KERNEL] == 0,
              f"{tag} training launched {launches}, not {want} of each kernel and no "
              f"statistics launch")
        best = Path(tmp) / "unet_MEL_best.pth"
        resume = Path(tmp) / "train_state_MEL.pt"
        check(best.exists() and resume.exists(), "training wrote no best checkpoint or resume state")
        saved = torch.load(resume, map_location="cpu", weights_only=True)
        # the log prints losses to 5 decimals
        check(saved["step"] == TRAIN_STEPS and abs(saved["best_loss"] - min(losses)) <= 1e-5,
              f"resume state step {saved['step']} best_loss {saved['best_loss']}")

        # train -> sample: the checkpoint just written, through the sampling path
        mm = ModelManager(checkpoints_dir=tmp, device="cuda")
        check(mm.load_model("MEL"), "ModelManager.load_model of the trained checkpoint")
        images = mm.create_sampler(CLI_STEPS, scheduler="ddim").sample(
            mm.loaded_models["MEL"], np.arange(CLI_BATCH, dtype=np.uint32))["images"]
        check(images.shape == (CLI_BATCH, 128, 128, 3) and bool(torch.isfinite(images).all()),
              f"samples from the trained checkpoint: {tuple(images.shape)}")
        print(f"{tag} the trained checkpoint loads in ModelManager and samples "
              f"{CLI_BATCH} finite images (DDIM {CLI_STEPS}) on {card}", flush=True)
    return launches


def phase_bench(card: str) -> dict:
    r = measure_train_step(batch=BENCH_BATCH, steps=BENCH_STEPS)
    check(math.isfinite(r["loss"]), f"measure_train_step loss {r['loss']}")
    print(f"[bench] measure_train_step: batch {r['batch']}, bf16 compute / f32 parameters, "
          f"fused attention, fast_norm, {r['steps']} warm steps: {r['sec_per_step']:.5f} "
          f"s/step, {r['img_per_s']:.2f} images/s, peak device memory "
          f"{r['peak_bytes'] / 2**30:.3f} GiB, on {card}", flush=True)
    if r["device_busy_s_per_step"] is None:
        print("[bench] torch.profiler recorded no device time: busy time and idle share "
              "not measured", flush=True)
    else:
        print(f"[bench] torch.profiler over {PROFILE_STEPS} more steps: device busy "
              f"{r['device_busy_s_per_step']:.5f} s/step (idle share {r['idle_share']:.3f} of "
              f"the timed step), of which the attention kernels "
              f"{r['attention_s_per_step']:.5f} s/step "
              f"({r['attention_s_per_step'] / r['device_busy_s_per_step']:.3f} of busy)",
              flush=True)
    return r


def phase_f32() -> dict:
    """[f32] the f32 training path's attention and step: K3 in f32 from the
    forward's saved statistics (as K4 runs it) and standalone, and K4 in f32
    forward+backward through autograd, at TRAIN_SHAPES in the UNet's layout
    (in turns, medians of F32_ROUNDS); then the warm f32 training step at
    batch 32 with its profiler split. Uses only what a parent tree has
    (`python3 chip_smoke.py --f32`): on a tree whose f32 backward ignores o
    and lse, "from saved statistics" times the same launch as standalone."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from synt_isic_tpu_torch.train import train_ddpm

    g = torch.Generator(device="cuda").manual_seed(11)
    report = {}
    for shape in TRAIN_SHAPES:
        args = [torch.randn(shape, generator=g, device="cuda") for _ in range(4)]
        views = _btc_views(*args)
        o, lse = attention.fused_attention(*views[:3], with_lse=True)
        leaves = [z.detach().requires_grad_() for z in views[:3]]
        times = in_turns({
            "from_stats_ms": lambda: attention.fused_attention_bwd(*views, o=o, lse=lse),
            "standalone_ms": lambda: attention.fused_attention_bwd(*views),
            "fwd_bwd_ms": lambda: torch.autograd.grad(
                attention.fused_attention_trainable(*leaves), leaves, views[3]),
        }, rounds=F32_ROUNDS)
        # each launch of the backward from saved statistics on its own
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(F32_PROFILED):
                attention.fused_attention_bwd(*views, o=o, lse=lse)
            torch.cuda.synchronize()
        times["launches_ms"] = {
            re.search(r"attention_\w+<[^>]*>", evt.key).group(0):
                evt.device_time_total / evt.count / 1e3
            for evt in prof.key_averages() if re.search(r"attention_bwd\w*<", evt.key)}
        report[str(shape)] = times
        print(f"[f32] attention backward {shape} float32: from saved statistics "
              f"{times['from_stats_ms']:.4f} ms, standalone {times['standalone_ms']:.4f} ms; "
              f"forward+backward through autograd {times['fwd_bwd_ms']:.4f} ms (medians of "
              f"{F32_ROUNDS}, in turns); per launch (torch.profiler, {F32_PROFILED} calls): "
              + ", ".join(f"{k} {ms:.4f} ms" for k, ms in times["launches_ms"].items()),
              flush=True)
        del args, views, o, lse, leaves
    # `measure_train_step` has no dtype knob (nor has the JAX package's): it
    # builds its TrainConfig inside, so it is handed one with bf16 compute off
    built, config = [], train_ddpm.TrainConfig

    def f32_config(*a, **kw):
        built.append(config(*a, bf16_compute=False, **kw))
        return built[-1]

    with mock.patch.object(train_ddpm, "TrainConfig", f32_config):
        r = measure_train_step(batch=BENCH_BATCH, steps=BENCH_STEPS)
    check(len(built) == 1 and math.isfinite(r["loss"]),
          f"f32 measure_train_step: {len(built)} configs, loss {r['loss']}")
    report["train_step"] = r
    split = ("not measured (torch.profiler recorded no device time)"
             if r["device_busy_s_per_step"] is None else
             f"device busy {r['device_busy_s_per_step']:.5f} s/step (idle share "
             f"{r['idle_share']:.3f}), attention kernels {r['attention_s_per_step']:.5f} s/step "
             f"({r['attention_s_per_step'] / r['device_busy_s_per_step']:.3f} of busy)")
    print(f"[f32] measure_train_step with f32 compute: batch {r['batch']}, {r['steps']} warm "
          f"steps: {r['sec_per_step']:.5f} s/step, {r['img_per_s']:.2f} images/s, peak device "
          f"memory {r['peak_bytes'] / 2**30:.3f} GiB; torch.profiler over {PROFILE_STEPS} more "
          f"steps: {split}", flush=True)
    return report


def phase_distill(card: str, bench: dict) -> dict:
    """[distill] `python -m synt_isic_tpu_torch.train --distill-from` (in
    process) on a seeded full-width teacher: exact launch counts, finite
    losses over both phases, both students written; the 4-step student
    loaded by `ModelManager(variant="distill4")` and sampled at DDIM 4
    trailing; then the warm distillation step at BENCH_BATCH beside
    `bench`'s train step, its peak memory and its profiler split."""
    from synt_isic_tpu_torch.io.pth import save_checkpoint
    from synt_isic_tpu_torch.train import distill
    from synt_isic_tpu_torch.train.train_ddpm import default_model

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(0)
        save_checkpoint(UNet2D(UNet2DConfig()).state_dict(), str(Path(tmp) / "unet_MEL_best.pth"))
        argv = ["--classes", "MEL", "--procedural", str(DISTILL_IMAGES),
                "--batch", str(DISTILL_BATCH),
                "--distill-from", str(Path(tmp) / "unet_{CLASS}_best.pth"),
                "--distill-start", str(DISTILL_START), "--distill-end", str(DISTILL_END),
                "--distill-steps-per-phase", str(DISTILL_STEPS), "--checkpoints", tmp,
                "--seed", "0", "--device", "cuda"]
        tee = _Tee(sys.stdout)
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            rc = train_entry.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(attention.LAUNCHES)
        check(rc == 0, f"train --distill-from returned {rc}")
        losses = {}
        for n, loss in re.findall(r"\[distill:(\d+)\] step \d+/\d+ loss=(\S+)",
                                  tee.seen.getvalue()):
            losses.setdefault(int(n), []).append(float(loss))
        check(tuple(losses) == DISTILL_PHASES
              and all(math.isfinite(x) for v in losses.values() for x in v),
              f"distillation losses by phase {losses}")
        steps = len(DISTILL_PHASES) * DISTILL_STEPS
        want_fwd, want_bwd = 3 * ATTENTION_CALLS_PER_UNET * steps, ATTENTION_CALLS_PER_UNET * steps
        print(f"[distill] train --distill-from, {DISTILL_START} -> {DISTILL_END} steps (phases "
              f"{DISTILL_PHASES}), {steps} steps of batch {DISTILL_BATCH} in {wall:.3f} s (cold: "
              f"model build, first-call set-up and checkpoint writes included); block losses "
              f"{losses}; launches attention_fwd {launches[attention.KERNEL]} (want {want_fwd}: "
              f"2 teacher forwards without the log-sum-exp and 1 student forward with it), "
              f"attention_bwd {launches[attention.BWD_KERNEL]} (want {want_bwd}), "
              f"attention_bwd_stats {launches[attention.STATS_KERNEL]} (want 0)", flush=True)
        others = sum(v for k, v in launches.items()
                     if k not in (attention.KERNEL, attention.BWD_KERNEL))
        check(launches[attention.KERNEL] == want_fwd and launches[attention.BWD_KERNEL] == want_bwd
              and others == 0, f"[distill] launched {launches}")
        written = [Path(tmp) / f"unet_MEL_distill{n}.pth" for n in DISTILL_PHASES]
        check(all(path.exists() for path in written), f"students written: "
              f"{sorted(q.name for q in Path(tmp).iterdir())}")

        mm = ModelManager(checkpoints_dir=tmp, device="cuda", variant=f"distill{DISTILL_END}")
        check(mm.load_model("MEL"), f"ModelManager(variant='distill{DISTILL_END}').load_model")
        reset_launches()
        images = mm.create_sampler(DISTILL_END, scheduler="ddim", timestep_spacing="trailing"
                                   ).sample(mm.loaded_models["MEL"],
                                            np.arange(CLI_BATCH, dtype=np.uint32))["images"]
        torch.cuda.synchronize()
        sample_launches = attention.LAUNCHES[attention.KERNEL]
        want = ATTENTION_CALLS_PER_UNET * DISTILL_END
        check(sample_launches == want and images.shape == (CLI_BATCH, 128, 128, 3)
              and bool(torch.isfinite(images).all()),
              f"distill{DISTILL_END} sample: {sample_launches} launches (want {want}), "
              f"{tuple(images.shape)}")
        print(f"[distill] unet_MEL_distill{DISTILL_END}.pth loads in ModelManager and samples "
              f"{CLI_BATCH} finite images at DDIM {DISTILL_END} trailing with {sample_launches} "
              f"K1 launches", flush=True)
        report.update(launches=launches, sample_launches=sample_launches, losses=losses,
                      wall_s=wall)

    dev = torch.device("cuda")
    cfg = distill.DistillConfig(batch_size=BENCH_BATCH)
    student = default_model(TrainConfig(), dev).to(dev).train()
    teacher = default_model(TrainConfig(seed=1), dev).to(dev).requires_grad_(False)
    state = distill.create_distill_state(student, cfg)
    step = distill.make_distill_step(DiffusionSchedule.create(), cfg, DISTILL_END)
    gen = torch.Generator(device=dev).manual_seed(3)
    base = torch.rand((BENCH_BATCH, 128, 128, 3), generator=gen, device=dev) * 2 - 1
    step(state, teacher, base, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(1, DISTILL_WARM_STEPS + 1):
        loss = step(state, teacher, base * (1.0 + 1e-4 * i), gen)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / DISTILL_WARM_STEPS
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(loss)), f"warm distillation loss {float(loss)}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILE_STEPS):
            step(state, teacher, base * (1.0 - 1e-4 * (i + 1)), gen)
        torch.cuda.synchronize()
    busy, attn = (x / PROFILE_STEPS for x in device_seconds(prof))
    busy, attn = (busy, attn) if busy > 0 else (None, None)
    train_s = bench["sec_per_step"]
    split = ("torch.profiler recorded no device time: busy and idle share not measured"
             if busy is None else
             f"torch.profiler over {PROFILE_STEPS} more steps: device busy {busy:.5f} s/step "
             f"(idle share {1.0 - busy / sec:.3f}), attention kernels {attn:.5f} s/step")
    print(f"[distill] warm distillation step, batch {BENCH_BATCH} (bf16 compute / f32 "
          f"parameters, clip, Adam, EMA), {DISTILL_WARM_STEPS} steps: {sec:.5f} s/step = "
          f"{sec / train_s:.3f} x the train step of [bench] ({train_s:.5f} s/step at the same "
          f"batch); peak device memory {peak / 2**30:.3f} GiB (train step "
          f"{bench['peak_bytes'] / 2**30:.3f}); {split}; on {card}", flush=True)
    report.update(step_s=sec, train_step_s=train_s, peak_bytes=peak, busy_s=busy,
                  attention_s=attn)
    del student, teacher, state
    return report


def phase_remat(card: str) -> dict:
    """[remat] `measure_train_step(remat_mode=m)` for every mode at each of
    REMAT_BATCHES: s/step, peak memory and launches per step (K1 twice per
    attention call where attention blocks recompute, K3 once, no statistics
    launch), each mode's peak below `none`'s; then one step's gradients at
    full width, every mode torch.equal to no remat's under deterministic
    cuDNN."""
    from synt_isic_tpu_torch.models.unet2d import REMAT_MODES
    from synt_isic_tpu_torch.train.train_ddpm import default_model

    rows = []
    for batch in REMAT_BATCHES:
        peaks = {}
        for mode in REMAT_MODES:
            reset_launches()
            t0 = time.time()
            profiled = batch == REMAT_BATCHES[0]
            r = measure_train_step(mode, batch=batch, steps=REMAT_STEPS, profile=profiled)
            wall = time.time() - t0
            calls = 1 + REMAT_STEPS + (PROFILE_STEPS if profiled else 0)
            per_step = {k: v / calls for k, v in attention.LAUNCHES.items() if v}
            recompute = mode in ("all", "attn", "dots")
            want = {attention.KERNEL: ATTENTION_CALLS_PER_UNET * (2 if recompute else 1),
                    attention.BWD_KERNEL: ATTENTION_CALLS_PER_UNET}
            check(per_step == want, f"[remat] {mode} batch {batch}: launches per step "
                                    f"{per_step}, want {want}")
            peaks[mode] = r["peak_bytes"]
            busy = r["device_busy_s_per_step"]
            print(f"[remat] {mode:5s} batch {batch}: {r['sec_per_step']:.5f} s/step, "
                  f"{r['img_per_s']:.2f} images/s, peak {r['peak_bytes'] / 2**30:.3f} GiB, "
                  f"launches per step attention_fwd {per_step[attention.KERNEL]:g} "
                  f"attention_bwd {per_step[attention.BWD_KERNEL]:g} attention_bwd_stats 0; "
                  + ("device busy not measured (no profiler at this batch)" if busy is None else
                     f"device busy {busy:.5f} s/step (idle share {r['idle_share']:.3f})")
                  + f"; the row took {wall:.1f} s", flush=True)
            rows.append({k: r[k] for k in ("remat", "batch", "sec_per_step", "img_per_s",
                                           "peak_bytes", "device_busy_s_per_step",
                                           "idle_share", "attention_s_per_step")}
                        | {"launches_per_step": per_step[attention.KERNEL]})
        lower = all(peaks[m] < peaks["none"] for m in REMAT_MODES if m != "none")
        check(lower, f"[remat] batch {batch}: peak memory {peaks} not below none's for "
                     f"every other mode")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((REMAT_GRAD_BATCH, 3, 128, 128), generator=gen, device=dev)
    eps = torch.randn((REMAT_GRAD_BATCH, 3, 128, 128), generator=gen, device=dev)
    t = torch.tensor([3, 250, 600, 999], device=dev)
    grads = {}
    with deterministic_cudnn():
        for mode in REMAT_MODES:
            model = default_model(TrainConfig(), dev, remat=mode).to(dev)
            torch.mean((model(x, t) - eps) ** 2).backward()
            grads[mode] = {k: p.grad for k, p in model.named_parameters()}
            del model
    same = {m: all(torch.equal(g, grads["none"][k]) for k, g in grads[m].items())
            for m in REMAT_MODES}
    print(f"[remat] one step's gradients at full width (batch {REMAT_GRAD_BATCH}, bf16 compute, "
          f"deterministic cuDNN) torch.equal to no remat's: {same}", flush=True)
    check(all(same.values()), f"[remat] gradients differ from no remat's: {same}")
    return {"rows": rows, "grads_equal": same}


def _classifier_images(root: Path) -> tuple:
    """CLF_IMAGES_PER_CLASS procedural JPEGs per class of the seven and
    their one-hot ground-truth CSV (the ISIC column order)."""
    from synt_isic_tpu_torch.train.procedural import procedural_image

    img_dir = root / "images"
    img_dir.mkdir()
    csv_path = root / "groundtruth.csv"
    with open(csv_path, "w") as f:
        f.write("image," + ",".join(COND_CLASSES) + "\n")
        for c, cls in enumerate(COND_CLASSES):
            for i in range(CLF_IMAGES_PER_CLASS):
                name = f"ISIC_{100 * c + i:07d}"
                arr = procedural_image(cls, i, 128, seed=0)
                Image.fromarray(np.round((arr + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
                                ).save(img_dir / f"{name}.jpg")
                f.write(name + "," + ",".join("1.0" if j == c else "0.0"
                                              for j in range(len(COND_CLASSES))) + "\n")
    return img_dir, csv_path


def phase_train_classifier(card: str) -> dict:
    """[train-classifier] `python -m synt_isic_tpu_torch.train
    --train-classifier` (in process) on procedural JPEGs: finite epochs,
    `classifier.pth` loaded by the XAI classifier with nothing skipped, its
    logits on a probe batch against the file's f32 rebuild and the trained
    model; then the warm training step."""
    from unittest import mock

    from synt_isic_tpu_torch.io.pth import load_checkpoint
    from synt_isic_tpu_torch.models.classifier import LesionClassifier
    from synt_isic_tpu_torch.train import train_classifier as tc
    from synt_isic_tpu_torch.train.data import MultiClassDataset

    with tempfile.TemporaryDirectory() as tmp:
        img_dir, csv_path = _classifier_images(Path(tmp))
        trained = {}
        library_call = tc.train_classifier

        def keep_result(*args, **kwargs):
            trained.update(library_call(*args, **kwargs))
            return trained

        argv = ["--train-classifier", "--data-dir", str(img_dir), "--csv", str(csv_path),
                "--epochs", str(CLF_EPOCHS), "--batch", str(CLF_BATCH), "--checkpoints", tmp,
                "--seed", "0", "--device", "cuda"]
        tee = _Tee(sys.stdout)
        t0 = time.time()
        with mock.patch.object(tc, "train_classifier", keep_result), \
                contextlib.redirect_stdout(tee):
            rc = train_entry.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        check(rc == 0, f"train --train-classifier returned {rc}")
        epochs = [(float(a), float(b)) for a, b in re.findall(
            r"\[clf\] epoch \d+/\d+ loss=(\S+) acc=(\S+)", tee.seen.getvalue())]
        check(len(epochs) == CLF_EPOCHS and all(math.isfinite(x) for e in epochs for x in e),
              f"classifier epochs {epochs}")
        path = str(Path(tmp) / "classifier.pth")
        clf, counts = LesionClassifier.from_checkpoint(path, device="cuda")
        check(counts == {"loaded": CLF_STATE_ENTRIES, "skipped": 0},
              f"classifier.pth load counts {counts}")
        images, _ = next(MultiClassDataset(str(img_dir), str(csv_path), seed=0).batches(
            CLF_BATCH, np.random.default_rng(1)))
        probe = torch.from_numpy(images).cuda().permute(0, 3, 1, 2)
        model = trained["state"].model
        rebuilt = tc.ResNet18Trainable(len(COND_CLASSES)).cuda().eval()
        rebuilt.load_state_dict(load_checkpoint(path), strict=True)
        with torch.no_grad():
            got, want, own = clf.model(probe), rebuilt(probe), model.eval()(probe)
        check(torch.equal(got, want), "the XAI classifier's logits differ from the f32 "
                                      "rebuild of the same classifier.pth")
        last_best = epochs[-1][1] >= max(acc for _, acc in epochs)
        dist = float((got - own).abs().max() / own.abs().max())
        print(f"[train-classifier] {CLF_EPOCHS} epochs of batch {CLF_BATCH} on "
              f"{len(COND_CLASSES) * CLF_IMAGES_PER_CLASS} images in {wall:.3f} s (cold); "
              f"(loss, acc) per epoch {epochs}; classifier.pth loads {counts}; its logits "
              f"torch.equal to the f32 rebuild; the trained (bf16) model's own eval-mode "
              f"logits within {dist:.2e} x max|logit|"
              + ("" if last_best else " (not checked: an earlier epoch was the best, so the "
                                      "file holds its weights)"), flush=True)
        check(not last_best or dist <= CLF_BF16_TOL,
              f"trained model's logits {dist} x max|logit| from the export's")

    model.train()
    step = tc.make_classifier_train_step()
    labels = torch.arange(CLF_BATCH, device="cuda") % len(COND_CLASSES)
    batch = torch.from_numpy(images).cuda()
    step(trained["state"], batch, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, CLF_WARM_STEPS + 1):
        loss, _ = step(trained["state"], batch * (1.0 + 1e-4 * i), labels)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / CLF_WARM_STEPS
    check(math.isfinite(float(loss)), f"warm classifier loss {float(loss)}")
    print(f"[train-classifier] warm step (ResNet-18 at 224x224, bf16 convolutions, batch "
          f"{CLF_BATCH}, device-resident batch): {sec:.5f} s/step on {card}", flush=True)
    return {"step_s": sec, "wall_s": wall, "epochs": epochs, "logit_dist": dist}


def phase_kernel_bwd_group() -> dict:
    """K3 at G heads per block: bit-identical to G = 1, timed per G."""
    g = torch.Generator(device="cuda").manual_seed(8)
    report = {}
    for shape in TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(4)]
            views = _btc_views(*args)
            for layout, a in (("BHTD", args), ("BTC", views)):
                base = attention.fused_attention_bwd(*a)
                for group in GROUPS[1:]:
                    before = dict(attention.LAUNCHES)
                    got = attention.fused_attention_bwd(*a, heads_per_program=group)
                    torch.cuda.synchronize()
                    check(attention.LAUNCHES[attention.BWD_KERNEL]
                          == before[attention.BWD_KERNEL] + 1
                          and attention.LAUNCHES[attention.BWD_GROUPED_KERNEL]
                          == before[attention.BWD_GROUPED_KERNEL] + 1,
                          "grouped backward launch not counted")
                    for name, x, y in zip(("dq", "dk", "dv"), got, base):
                        check(torch.equal(x, y), f"backward G={group} {shape} {dtype} "
                                                 f"{layout} {name}: not bit-identical to G=1")
            # as the trainer runs it: from the forward's statistics (read at
            # head_dim 8 in both dtypes), checked against G = 1 and timed per G
            o, lse = attention.fused_attention(*views[:3], with_lse=True)
            base = attention.fused_attention_bwd(*views, o=o, lse=lse)
            for group in GROUPS[1:]:
                got = attention.fused_attention_bwd(*views, heads_per_program=group, o=o,
                                                    lse=lse)
                check(all(torch.equal(x, y) for x, y in zip(got, base)),
                      f"backward from saved statistics at G={group} {shape} {dtype}: not "
                      f"bit-identical to G=1")
            want = attention.attention_bwd_reference(*args)
            got = attention.fused_attention_bwd(*views, heads_per_program=COND_GROUP, o=o,
                                                lse=lse)
            err = max((x.float() - w.float()).abs().max().item() for x, w in zip(got, want))
            times = {grp: cuda_ms(lambda: attention.fused_attention_bwd(
                *views, heads_per_program=grp, o=o, lse=lse)) for grp in GROUPS}
            bound, bound_by, _, unit = attention_bwd_bound_ms(shape, dtype)
            report[(shape, dtype)] = dict(times=times, max_abs_err=err, bound_ms=bound,
                                          bound_by=bound_by)
            print(f"[kernel-bwd-group] {shape} {str(dtype)[6:]:8s}: G in {GROUPS[1:]} "
                  f"torch.equal to G=1 for dq, dk, dv in both layouts, standalone and from "
                  f"saved statistics; G={COND_GROUP} vs "
                  f"plain max_abs_err {err:.3e}; kernel ms "
                  + ", ".join(f"G={grp} {ms:.4f}" for grp, ms in times.items())
                  + f"; bound {bound:.4f} ms ({unit})", flush=True)
            del args, views, base, got, want, o, lse
    shape = TRAIN_SHAPES[0]
    args = [torch.randn(shape, generator=g, device="cuda") for _ in range(4)]
    report["plain_ms"] = cuda_ms(lambda: attention.attention_bwd_reference(*args), iters=5)
    return report


def _cond_datasets(per_class: int) -> dict:
    return {c: ProceduralDataset(c, per_class, 128, seed=0, device="cuda")
            for c in COND_CLASSES}


def _cond_model(group: int) -> UNet2D:
    """The trainer's full-width conditional UNet: bf16 compute on f32
    parameters, the kernels, f32-statistics GroupNorm, G heads per block."""
    return UNet2D(UNet2DConfig(num_class_embeds=len(COND_CLASSES) + 1),
                  dtype=torch.bfloat16, param_dtype=torch.float32,
                  use_fused_attention=True, fast_norm=True,
                  fused_heads_per_program=group).cuda()


@contextlib.contextmanager
def deterministic_cudnn():
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old


def phase_train_conditional(card: str, ckpt: Path) -> dict:
    """The conditional training entry point in a fresh process (its
    checkpoint goes to `ckpt` for [conditional]), then the library call at
    G = 2, then G = 2 against G = 1 gradients on one step."""
    argv = ["--conditional", "--classes", ",".join(COND_CLASSES), "--procedural",
            str(COND_IMAGES), "--epochs", "1", "--batch", str(TRAIN_BATCH),
            "--eval-every", "1", "--checkpoints", str(ckpt), "--seed", "0",
            "--device", "cuda"]
    t0 = time.time()
    rc, launches, output = run_cli_process(argv, "synt_isic_tpu_torch.train")
    wall = time.time() - t0
    check(rc == 0, f"train --conditional exited {rc}:\n{output}")
    losses = [float(m) for m in re.findall(r"\[train:conditional\] epoch \d+/\d+ loss=(\S+)",
                                           output)]
    check(len(losses) == 1 and math.isfinite(losses[0]), f"loss history {losses}")
    probe = ATTENTION_CALLS_PER_UNET * EVAL_T_POINTS
    want_fwd = ATTENTION_CALLS_PER_UNET * COND_STEPS + probe
    want_bwd = ATTENTION_CALLS_PER_UNET * COND_STEPS
    meta = json.loads((ckpt / "unet_conditional_best.json").read_text())
    print(f"[train-conditional] python -m synt_isic_tpu_torch.train {' '.join(argv[:8])} "
          f"...: {COND_STEPS} steps of batch {TRAIN_BATCH} (bf16 compute, f32 parameters) "
          f"and one probe evaluation in {wall:.1f} s in a fresh process (start-up, "
          f"model build and checkpoint writes included); loss {losses[0]}; launches "
          f"attention_fwd {launches[attention.KERNEL]} (want {want_fwd}: "
          f"{ATTENTION_CALLS_PER_UNET} x {COND_STEPS} steps + {probe} of the probe), "
          f"attention_bwd {launches[attention.BWD_KERNEL]} (want {want_bwd}), "
          f"attention_bwd_stats {launches[attention.STATS_KERNEL]} (want 0); metadata "
          f"{meta}", flush=True)
    check(launches[attention.KERNEL] == want_fwd and launches[attention.BWD_KERNEL] == want_bwd
          and launches[attention.GROUPED_KERNEL] == launches[attention.BWD_GROUPED_KERNEL] == 0
          and launches[attention.FAST_KERNEL] == launches[attention.STATS_KERNEL] == 0,
          f"train --conditional launched {launches}")
    check((ckpt / "unet_conditional_best.pth").exists()
          and meta["classes"] == list(COND_CLASSES)
          and meta["num_class_embeds"] == len(COND_CLASSES) + 1,
          "train --conditional wrote no checkpoint or wrong metadata")

    # the library call with a G = 2 model
    cfg = TrainConfig(image_size=128, batch_size=TRAIN_BATCH, epochs=1, seed=0)
    datasets = _cond_datasets(COND_LIB_IMAGES)
    lib_steps = len(COND_CLASSES) * COND_LIB_IMAGES // TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(0)
        model = _cond_model(COND_GROUP)
        reset_launches()
        t0 = time.time()
        result = train_conditional(datasets, tmp, cfg, model=model, device="cuda",
                                   log=lambda msg: None)
        torch.cuda.synchronize()
        lib_wall = time.time() - t0
        lib = dict(attention.LAUNCHES)
    want = ATTENTION_CALLS_PER_UNET * lib_steps
    print(f"[train-conditional] train_conditional(model=UNet2D(full width, num_class_embeds="
          f"{len(COND_CLASSES) + 1}, bf16 on f32, fused_heads_per_program={COND_GROUP})): "
          f"{result['steps']} steps in {lib_wall:.2f} s; launches {lib} (want {want} "
          f"attention_bwd = attention_bwd_grouped, {want} attention_fwd = "
          f"attention_fwd_grouped, 0 attention_bwd_stats)", flush=True)
    check(result["steps"] == lib_steps and math.isfinite(result["best_loss"])
          and lib[attention.BWD_KERNEL] == lib[attention.BWD_GROUPED_KERNEL] == want
          and lib[attention.KERNEL] == lib[attention.GROUPED_KERNEL] == want
          and lib[attention.STATS_KERNEL] == 0,
          f"train_conditional at G={COND_GROUP} launched {lib}")

    # one step's gradients at G = 2 against G = 1, with the same draws
    mix = LabeledMixtureDataset(datasets)
    images, labels = (torch.as_tensor(z).cuda() for z in
                      next(mix.batches(TRAIN_BATCH, np.random.default_rng(1))))
    gen = torch.Generator(device="cuda").manual_seed(2)
    t = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")
    eps = torch.randn(images.shape, generator=gen, device="cuda")
    drop = torch.rand(TRAIN_BATCH, generator=gen, device="cuda") < 0.5
    torch.manual_seed(3)
    state = _cond_model(1).state_dict()
    step = make_train_step(DiffusionSchedule.create(), cfg)
    grads, params, counts = {}, {}, {}
    with deterministic_cudnn():
        for group in (1, COND_GROUP):
            model = _cond_model(group)
            model.load_state_dict(state)
            train_state = create_train_state(model, cfg)
            reset_launches()
            step(train_state, (images, labels), t=t, eps=eps, drop=drop)
            torch.cuda.synchronize()
            counts[group] = dict(attention.LAUNCHES)
            grads[group] = {n: q.grad for n, q in model.named_parameters()}
            params[group] = {n: q.detach() for n, q in model.named_parameters()}
    unequal = [n for n in grads[1] if not torch.equal(grads[1][n], grads[COND_GROUP][n])]
    moved = [n for n in params[1] if not torch.equal(params[1][n], params[COND_GROUP][n])]
    print(f"[train-conditional] one step at G=1 and G={COND_GROUP}, same t/eps/drop, "
          f"cudnn.deterministic: {len(grads[1]) - len(unequal)}/{len(grads[1])} parameter "
          f"gradients torch.equal, {len(params[1]) - len(moved)}/{len(params[1])} updated "
          f"parameters torch.equal; launches G=1 {counts[1]}, G={COND_GROUP} "
          f"{counts[COND_GROUP]}", flush=True)
    check(not unequal and not moved, f"G={COND_GROUP} vs G=1 gradients differ: {unequal[:5]}")
    check(counts[COND_GROUP][attention.BWD_GROUPED_KERNEL] == ATTENTION_CALLS_PER_UNET
          and counts[1][attention.BWD_GROUPED_KERNEL] == 0
          and counts[1][attention.STATS_KERNEL] == counts[COND_GROUP][attention.STATS_KERNEL] == 0,
          "gradient comparison did not run the grouped backward")
    return dict(entry=launches, lib=lib, wall_s=wall)


def phase_conditional(card: str, ckpt: Path, base: Path) -> dict:
    """Mixed-class guided generation through ImageGenerator on the
    checkpoint [train-conditional] wrote."""
    gen = ImageGenerator(checkpoints_dir=str(ckpt), conditional=True,
                         guidance_scale=COND_GUIDANCE, guidance_map=COND_MAP)
    gen.scheduler_kind = "ddim"
    gen.set_inference_steps(CLI_STEPS)
    gen.batch_size = CLI_BATCH
    gen.set_generation_seed(GEN_SEED)
    total = sum(n for _, n in COND_REQUEST)

    def run(out: Path) -> tuple:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        result = gen.generate_images(COND_REQUEST, str(out))
        torch.cuda.synchronize()
        return result, time.time() - t0, dict(attention.LAUNCHES)

    out = base / "generated"
    result, wall, launches = run(out)
    check(result.get("generated") == total, f"generate_images returned {result}")
    want = ATTENTION_CALLS_PER_UNET * CLI_STEPS * (total // CLI_BATCH)
    pngs = sorted(out.rglob("ISIC_*.png"))
    rows = (out / "synthetic_dataset.csv").read_text().splitlines()[1:]
    metas = [json.loads(q.with_suffix(".json").read_text()) for q in pngs]
    blocks = {tuple(m["block"]["seeds"]): m["block"]["classes"] for m in metas}
    print(f"[conditional] ImageGenerator(conditional=True, guidance_scale={COND_GUIDANCE}, "
          f"guidance_map={COND_MAP}), f32, exact kernel, DDIM {CLI_STEPS}, batch "
          f"{CLI_BATCH}, {COND_REQUEST}: {len(pngs)} PNGs, {len(rows)} CSV rows in "
          f"{wall:.3f} s cold; blocks {list(blocks.values())}; launches {launches} (want "
          f"{want} attention_fwd: one 2B-batched forward of 6 calls per step)", flush=True)
    check(len(pngs) == total and len(rows) == total, "conditional generator outputs")
    check(launches[attention.KERNEL] == want
          and sum(launches.values()) == launches[attention.KERNEL],
          f"conditional generator launched {launches}, not {want} attention_fwd")
    check(len(blocks) == total // CLI_BATCH
          and all(len(set(classes)) > 1 for classes in blocks.values()),
          f"blocks {blocks}")
    for meta in metas:
        sched = meta["scheduler"]
        check(sched.get("conditional") is True and sched.get("guidance_map") == COND_MAP
              and sched["guidance_scale"] == COND_MAP.get(meta["class"], COND_GUIDANCE)
              and meta["device"].startswith("cuda"), f"sidecar {meta}")
    arrays = _png_arrays(pngs)
    check(all(a.shape == (128, 128, 3) for a in arrays)
          and len({a.tobytes() for a in arrays}) == total, "conditional PNGs")

    # warm: the same call again, and the sampler alone on one block
    _, warm, warm_launches = run(base / "generated_warm")
    check(warm_launches == launches, f"warm run launched {warm_launches}")
    mm = gen.model_manager
    classes = [c for c, n in COND_REQUEST for _ in range(n)][:CLI_BATCH]
    seeds = np.arange(CLI_BATCH, dtype=np.uint32)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        gen._sample_block(classes, seeds, False)
        torch.cuda.synchronize()
        runs.append(time.time() - t0)
    block_s = sorted(runs)[1]
    print(f"[conditional] warm (same ImageGenerator): {warm:.3f} s, {total / warm:.2f} "
          f"images/s on {card}; the sampler alone, one guided block of {CLI_BATCH} (batch "
          f"{2 * CLI_BATCH} forwards), median of 3 ({', '.join(f'{r:.4f}' for r in runs)} "
          f"s): {block_s / CLI_STEPS:.5f} s/step, {CLI_BATCH / block_s:.2f} images/s",
          flush=True)

    # one guided prediction on a mixed-label batch, kernel vs plain attention
    sampler = gen._sampler()
    labels = torch.tensor([mm.class_id(c) for c in classes], device="cuda")
    predict = sampler._make_predict(labels)
    kernel_model = mm.loaded_models[classes[0]]
    plain_model = UNet2D(mm.config, dtype=mm.dtype, use_fused_attention=False,
                         fast_norm=mm.fast_norm)
    plain_model.load_state_dict(kernel_model.state_dict())
    plain_model = plain_model.cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(CLI_BATCH, 3, 128, 128, generator=g, device="cuda")
    t = sampler.params.timesteps[CLI_STEPS // 2].expand(CLI_BATCH)
    before = attention.LAUNCHES[attention.KERNEL]
    with torch.inference_mode(), full_f32_convolutions():
        eps_kernel = predict(kernel_model, x, t)
        eps_plain = predict(plain_model, x, t)
    torch.cuda.synchronize()
    check(attention.LAUNCHES[attention.KERNEL] - before == ATTENTION_CALLS_PER_UNET,
          "guided prediction did not run one forward")
    err = (eps_kernel - eps_plain).abs().max().item()
    scale = eps_plain.abs().max().item()
    print(f"[conditional] one guided prediction (2B forward + CFG combine, labels "
          f"{labels.tolist()}), full-f32 convolutions: kernel vs plain attention "
          f"max_abs_err {err:.3e} (max |eps| {scale:.3f}; allowed "
          f"{UNET_TOL[torch.float32]:.0e} x max |eps|)", flush=True)
    check(bool(torch.isfinite(eps_kernel).all()) and err <= UNET_TOL[torch.float32] * scale,
          "guided prediction, kernel vs plain")
    return dict(launches=launches, wall_s=wall, warm_s=warm, block_s=block_s, out=out,
                err=err)


def phase_reproduce_conditional(cond: dict, ckpt: Path) -> dict:
    """A sidecar of the second mixed block regenerated in a fresh process:
    the first VASC image (items 12-15 of the request are VASC)."""
    want = ATTENTION_CALLS_PER_UNET * CLI_STEPS
    sidecar = cond["out"] / "VASC" / "ISIC_0000001.json"
    meta = json.loads(sidecar.read_text())
    first = json.loads((cond["out"] / "MEL" / "ISIC_0000001.json").read_text())
    check(meta["block"]["seeds"] != first["block"]["seeds"], "VASC is not in block 2")
    t0 = time.time()
    rc, launches, output = run_cli_process(
        ["--reproduce", str(sidecar), "--checkpoints", str(ckpt), "--device", "cuda"])
    wall = time.time() - t0
    original = sidecar.with_name(meta["filename"])
    redo = sidecar.with_name(f"{original.stem}_reproduced{original.suffix}")
    identical = redo.exists() and redo.read_bytes() == original.read_bytes()
    said = [line for line in output.splitlines() if line.startswith("reproduced")]
    print(f"[reproduce-conditional] {sidecar.parent.name}/{sidecar.name} (block classes "
          f"{meta['block']['classes']}, index {meta['block']['index']}): rc {rc}, "
          f"byte-identical {identical}, launches {launches} (want {want} attention_fwd), "
          f"{wall:.1f} s in a fresh process; {said[-1] if said else output}", flush=True)
    check(rc == 0 and identical, f"--reproduce of a conditional sidecar: rc {rc}\n{output}")
    check(launches[attention.KERNEL] == want
          and sum(launches.values()) == launches[attention.KERNEL],
          f"--reproduce of a conditional sidecar launched {launches}")
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_cli(base: Path, ckpt: Path, dp: Optional[int]) -> tuple:
    """`cli.main` at MEL:8, DDIM 10, f32 into `base` (over a `--dp-mesh dp`
    when given): the JPEGs, the sidecars and the K1 launches."""
    argv = ["--base-dir", str(base), "--checkpoints", str(ckpt), "--class-counts",
            f"MEL:{CLI_BATCH}", "--batch", str(CLI_BATCH), "--scheduler", "ddim",
            "--steps", str(CLI_STEPS), "--seed", "0", "--device", "cuda"]
    argv += ["--dp-mesh", str(dp)] if dp else []
    reset_launches()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(attention.LAUNCHES)
    check(rc == 0, f"cli.main {' '.join(argv[-2:])} returned {rc}")
    out = base / "ISIC2018_Task3_synt"
    return sorted(out.glob("ISIC_*.jpg")), sorted(out.glob("ISIC_*.json")), launches


def _mesh_walks(mm: ModelManager, meshes: dict, seeds) -> dict:
    """The DDIM-10 walk of `seeds` unsharded and over each mesh, full-f32
    convolutions and deterministic cuDNN: images held to the unsharded ones
    within MESH_WALK_TOL, exact K1 launch counts, host-clock walk times
    (after `synchronize`) beside the unsharded one: warm where every shard
    is on a card, cold (the replica built inside) where a CPU shard paces
    the walk."""
    from synt_isic_tpu_torch.parallel import ShardedSampler

    sampler = mm.create_sampler(CLI_STEPS, scheduler="ddim")
    model = mm.loaded_models["MEL"]
    report = {}
    with full_f32_convolutions(), deterministic_cudnn():
        walkers = {"unsharded": sampler, **{name: ShardedSampler(sampler, mesh)
                                            for name, mesh in meshes.items()}}
        for name, walker in walkers.items():        # warm: replicas, plans
            if name not in meshes or all(d.type == "cuda"
                                         for d in meshes[name].shard_devices()):
                walker.sample(model, seeds)
        torch.cuda.synchronize()
        outs = {}
        for name, walker in walkers.items():
            reset_launches()
            t0 = time.perf_counter()
            outs[name] = walker.sample(model, seeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            devices = meshes[name].shard_devices() if name in meshes else [torch.device("cuda")]
            shards = len(devices)
            padded = -(-len(seeds) // shards) * shards
            # one walk per shard, each ATTENTION_CALLS_PER_UNET x steps on a
            # card; a CPU shard's replica runs the plain attention
            want = ATTENTION_CALLS_PER_UNET * CLI_STEPS * sum(d.type == "cuda" for d in devices)
            got = attention.LAUNCHES[attention.KERNEL]
            report[name] = {"walk_s": wall, "launches": got, "shards": shards,
                            "padded": padded}
            check(got == want, f"[mesh] {name} walk launched K1 {got} times, not {want}")
    ref = outs["unsharded"]
    for name in meshes:
        images = outs[name]["images"]
        check(images.shape == ref["images"].shape and bool(torch.isfinite(images).all()),
              f"[mesh] {name} images {tuple(images.shape)}")
        check(list(outs[name]["noise_hashes"]) == list(ref["noise_hashes"])
              and list(outs[name]["seeds"]) == list(ref["seeds"]),
              f"[mesh] {name} noise hashes or seeds differ from the unsharded walk")
        err = (images - ref["images"]).abs().max().item()
        report[name]["max_abs_err"] = err
        print(f"[mesh] ShardedSampler over {name}: {len(seeds)} seeds padded to "
              f"{report[name]['padded']} in {report[name]['shards']} shards, K1 launches "
              f"{report[name]['launches']}; images vs unsharded max_abs_err {err:.3e} "
              f"(allowed {MESH_WALK_TOL:.0e}); walk {report[name]['walk_s']:.4f} s vs "
              f"unsharded {report['unsharded']['walk_s']:.4f} s (host clock)", flush=True)
        check(err <= MESH_WALK_TOL, f"[mesh] {name} images vs the unsharded walk")
    return report


def _mesh_train_step(name: str, mesh, batch_size: int, tag: str = "[mesh]") -> dict:
    """One f32 train step at `batch_size` on `mesh` against the
    single-device step from the same weights, batch and draws, full-f32
    convolutions and deterministic cuDNN: the loss, each leaf's reduced
    gradient and the weights after the step within the bounds stated at
    MESH_LOSS_RTOL, every replica torch.equal to the primary after the
    step, and the launch counts of one forward and backward per CUDA
    shard."""
    from synt_isic_tpu_torch.train.train_ddpm import default_model

    cfg = TrainConfig(batch_size=batch_size, bf16_compute=False)
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = torch.rand(batch_size, 128, 128, 3, generator=g, device="cuda") * 2 - 1
    step = make_train_step(DiffusionSchedule.create(), cfg)
    runs = {}
    with full_f32_convolutions(), deterministic_cudnn():
        for run_name, run_mesh in (("single", None), (name, mesh)):
            model = default_model(cfg, torch.device("cuda")).cuda().train()
            state = create_train_state(model, cfg, mesh=run_mesh)
            reset_launches()
            t0 = time.perf_counter()
            loss = step(state, batch, torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(bool(torch.isfinite(loss)), f"{tag} {run_name} train step loss {loss}")
            weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
            replicas = state.replicas.others() if run_mesh is not None else []
            for other in replicas:
                check(all(torch.equal(weights[k], v.to(weights[k].device))
                          for k, v in other.state_dict().items()),
                      f"{tag} {name}: a replica differs from the primary after the step")
            cuda_shards = (1 if run_mesh is None else
                           sum(d.type == "cuda" for d in run_mesh.shard_devices()))
            runs[run_name] = {"loss": loss.item(), "wall_s": wall, "weights": weights,
                          "lr": float(state.lr_schedule(0)),
                          "grads": {n: p.grad.detach().clone()
                                    for n, p in model.named_parameters() if p.grad is not None},
                          "launches": dict(attention.LAUNCHES), "replicas": len(replicas),
                          "cuda_shards": cuda_shards}
    one = runs.pop("single")
    got = tuple(one["launches"][k] for k in (attention.KERNEL, attention.BWD_KERNEL,
                                              attention.STATS_KERNEL))
    check(got == (ATTENTION_CALLS_PER_UNET, ATTENTION_CALLS_PER_UNET, 0),
          f"{tag} single train step launched K1/K3/stats {got}")
    g_max = max(gr.abs().max().item() for gr in one["grads"].values())
    run = runs[name]
    want = (ATTENTION_CALLS_PER_UNET * run["cuda_shards"],) * 2 + (0,)
    got = tuple(run["launches"][k] for k in (attention.KERNEL, attention.BWD_KERNEL,
                                              attention.STATS_KERNEL))
    check(got == want, f"{tag} {name} train step launched K1/K3/stats {got}, not {want}")
    check(set(run["grads"]) == set(one["grads"]),
          f"{tag} {name} train step: gradients of other parameters than the single step's")
    loss_rel = abs(run["loss"] - one["loss"]) / abs(one["loss"])
    tol = (MESH_GRAD_TOL if run["cuda_shards"] == len(mesh.shard_devices())
           else UNET_GRAD_TOL)
    grad_rel, adam_err = {}, {}

    def adam(g):
        g = g.double()
        return run["lr"] * g / (g.abs() + 1e-8)

    for k, gr in one["grads"].items():
        scale = g_max if k.endswith("to_k.bias") else gr.abs().max().item()
        grad_rel[k] = (run["grads"][k] - gr).abs().max().item() / max(scale, 1e-30)
        moved = (run["weights"][k] - one["weights"][k]).double()
        adam_err[k] = (moved + adam(run["grads"][k]) - adam(gr)).abs().max().item()
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_w = max(adam_err, key=adam_err.get)
    print(f"{tag} one f32 train step at batch {batch_size}, {name} vs one device: "
          f"loss {run['loss']:.7f} vs {one['loss']:.7f} (rel {loss_rel:.3e}, allowed "
          f"{MESH_LOSS_RTOL:.0e}); worst gradient {worst_g} at {grad_rel[worst_g]:.3e} of "
          f"its scale (allowed {tol:.0e}); weights vs Adam's step from the gradients: "
          f"worst {worst_w} {adam_err[worst_w]:.3e} (allowed {MESH_ADAM_TOL:.0e}); "
          f"{run['replicas']} replica(s) torch.equal to the primary; launches K1/K3 "
          f"{got[0]}/{got[1]}; step {run['wall_s']:.3f} s vs {one['wall_s']:.3f} s "
          f"(host clock)", flush=True)
    check(loss_rel <= MESH_LOSS_RTOL, f"{tag} {name} dp train loss vs the single step")
    check(grad_rel[worst_g] <= tol, f"{tag} {name} dp gradients vs the single step "
          f"({worst_g})")
    check(adam_err[worst_w] <= MESH_ADAM_TOL, f"{tag} {name} dp weights vs Adam's step "
          f"from the gradients ({worst_w})")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel[worst_g], "adam_err": adam_err[worst_w],
            "max_weight_diff": max((run["weights"][k] - w).abs().max().item()
                                   for k, w in one["weights"].items()),
            "launches": run["launches"], "wall_s": run["wall_s"]}


def _mesh_xai_fan_out(mesh) -> dict:
    """The library XAI fan-out (IG and patch-SHAP over every frame, the
    Time-SHAP scores, Grad-CAM, the fairness scores) over `mesh`, held row
    by row to the same analyzer without a mesh on the row's device: on the
    card with [xai]'s seeded classifier, on the CPU with a copy of it, the
    same draws on every side. Full-f32 convolutions; each output within
    [xai]'s bound of its largest magnitude."""
    from synt_isic_tpu_torch.models.classifier import LesionClassifier, random_resnet
    from synt_isic_tpu_torch.parallel.mesh import pad_to_multiple
    from synt_isic_tpu_torch.xai import FairnessAuditor, XAIAnalyzer
    from synt_isic_tpu_torch.xai.gradcam import compute_gradcam

    rng = np.random.default_rng(XAI_SEED)
    frames = (0.95 * np.tanh(rng.normal(size=(MESH_XAI_FRAMES, 128, 128, 3)))
              ).astype(np.float32)
    images = rng.integers(0, 256, size=(5, 128, 128, 3)).astype(np.uint8)
    cls, timesteps = 2, [float(t) for t in range(MESH_XAI_FRAMES - 1, -1, -1)]
    fair_batch = 3
    classifiers = {dev: LesionClassifier(random_resnet(XAI_OUTPUTS, XAI_CLASSIFIER_SEED),
                                         device=dev) for dev in ("cuda", "cpu")}
    outs = {}
    with full_f32_convolutions(), deterministic_cudnn():
        for name, clf, m in (("cuda", classifiers["cuda"], None),
                             ("cpu", classifiers["cpu"], None),
                             ("mesh", classifiers["cuda"], mesh)):
            xai = XAIAnalyzer(clf, ig_n_steps=MESH_XAI_IG_STEPS,
                              shap_n_samples=MESH_XAI_SHAP_SAMPLES, batch_size=8,
                              seed=XAI_SEED, mesh=m)
            outs[name] = {
                "ig": xai.compute_ig_frames(frames, cls),
                "shap": xai.compute_shap_frames(frames, cls),
                "time_shap": xai.compute_time_shap(frames, timesteps, cls)[1][
                    "probability_scores"],
                "gradcam": compute_gradcam(clf, frames, cls, output_size=128, mesh=m),
                "fairness": FairnessAuditor(clf, batch_size=fair_batch, mesh=m
                                            ).probabilities(images)}
    devices = mesh.shard_devices()

    def on_card(n: int) -> np.ndarray:
        """Whether each of n rows split over the mesh ran on a card."""
        per = pad_to_multiple(n, len(devices)) // len(devices)
        return np.array([devices[i // per].type == "cuda" for i in range(n)])

    rows = {key: on_card(MESH_XAI_FRAMES) for key in ("ig", "shap", "time_shap", "gradcam")}
    rows["fairness"] = np.concatenate([on_card(len(images[a:a + fair_batch]))
                                       for a in range(0, len(images), fair_batch)])
    bounds = {"ig": XAI_TOL["attribution"], "shap": XAI_TOL["attribution"],
              "time_shap": XAI_TOL["time_shap"], "gradcam": XAI_TOL["gradcam"],
              "fairness": XAI_TOL["time_shap"]}
    errs, apart = {}, {}
    for key, bound in bounds.items():
        card, cpu, got = (np.asarray(_np(outs[k][key]), np.float64)
                          for k in ("cuda", "cpu", "mesh"))
        check(got.shape == card.shape and np.isfinite(got).all(),
              f"[mesh] XAI fan-out {key}: {got.shape} vs {card.shape}")
        mask = rows[key].reshape((-1,) + (1,) * (card.ndim - 1))
        want = np.where(mask, card, cpu)
        errs[key] = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        apart[key] = np.abs(cpu - card).max() / max(np.abs(card).max(), 1e-30)
    check(rows["ig"].any() and not rows["ig"].all(), f"[mesh] {mesh} puts no frame on a card "
          "or none on the CPU")
    print(f"[mesh] XAI fan-out over {mesh} vs no mesh on each row's device ({MESH_XAI_FRAMES} "
          f"frames, IG {MESH_XAI_IG_STEPS} steps, SHAP {MESH_XAI_SHAP_SAMPLES} samples): "
          f"max |diff| / max |out| " + ", ".join(
              f"{k} {v:.3e} (allowed {bounds[k]:.0e}; card vs CPU {apart[k]:.3e})"
              for k, v in errs.items()), flush=True)
    for key, err in errs.items():
        check(err <= bounds[key], f"[mesh] XAI fan-out {key} over {mesh} vs no mesh")
    return errs


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _mesh_serve(ckpt: Path, out: Path) -> dict:
    """`python -m synt_isic_tpu_torch.serve --mesh auto` in a fresh process:
    its status reports the mesh and the rounded device batch, and a bulk
    generate is answered, its sidecars recording the mesh."""
    from synt_isic_tpu_torch.serve import request

    argv = ["--port", "0", "--mesh", "auto", "--warmup", "MEL", "--batch", "3",
            "--steps", str(CLI_STEPS), "--scheduler", "ddim", "--dtype", "f32",
            "--interactive-cost", "1", "--checkpoints", str(ckpt), "--output-root", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-m", "synt_isic_tpu_torch.serve", *argv],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, serving = [], []
    found = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving on "):
                serving.append(line)
                found.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        check(found.wait(timeout=300), "the mesh daemon printed no 'serving on' line:\n"
              + "\n".join(lines))
        host, port = re.search(r"serving on ([\d.]+):(\d+)", serving[0]).groups()
        status = request(host, int(port), {"op": "status"}, timeout=60)
        t0 = time.perf_counter()
        reply = request(host, int(port), {"op": "generate", "class": "MEL", "count": 3,
                                          "seed": 9}, timeout=300)
        served_s = time.perf_counter() - t0
        down = request(host, int(port), {"op": "shutdown"}, timeout=60)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    cards = torch.cuda.device_count()
    batch = -(-3 // cards) * cards
    check(status.get("mesh") == {"data": cards} and status.get("device_batch") == batch,
          f"mesh daemon status {status}")
    check(reply.get("ok") and len(reply["files"]) == 3
          and all(Path(f).exists() for f in reply["files"]), f"mesh daemon generate: {reply}")
    meta = json.loads(Path(reply["files"][0]).with_suffix(".json").read_text())
    check(meta.get("block", {}).get("dp_mesh") == cards, f"mesh daemon sidecar {meta}")
    check(down.get("ok") and rc == 0, f"mesh daemon shutdown {down}, rc {rc}:\n"
          + "\n".join(lines))
    print(f"[mesh] python -m synt_isic_tpu_torch.serve --mesh auto: status mesh "
          f"{status['mesh']}, device batch {status['device_batch']}; a 3-image generate in "
          f"{served_s:.2f} s (host clock), sidecars record dp_mesh {cards}; shutdown rc {rc}",
          flush=True)
    return {"mesh": status["mesh"], "served_s": served_s}


def _mesh_xai(ckpt: Path, base: Path) -> dict:
    """`python -m synt_isic_tpu_torch.xai.standalone` (through `main()`, the
    environment protocol) at its defaults, without a mesh and with
    `XAI_MESH_DEVICES=1`: every frame's attribution map within [xai]'s
    XAI_TOL['attribution'] x max|map|."""
    from unittest import mock

    from synt_isic_tpu_torch.xai import standalone

    env = {"XAI_TARGET_CLASS": "MEL", "XAI_CHECKPOINTS_DIR": str(ckpt),
           "XAI_DEVICE": "cuda", "XAI_GENERATION_SEED": str(XAI_SEED)}
    figures = importlib.util.find_spec("matplotlib") is not None
    runner = functools.partial(standalone.run_standalone_xai, save_figures=figures,
                               log=lambda *_: None)
    results, walls = {}, {}
    for name, extra in (("plain", {}), ("mesh", {"XAI_MESH_DEVICES": "1"})):
        out = base / f"xai_{name}"
        with mock.patch.dict(os.environ, {**env, **extra, "XAI_RESULTS_DIR": str(out)}), \
                mock.patch.object(standalone, "run_standalone_xai", runner):
            t0 = time.perf_counter()
            rc = standalone.main()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        check(rc == 0, f"[mesh] standalone XAI ({name}) returned {rc}")
        (run_dir,) = (out / "MEL").iterdir()
        results[name] = pickle.loads((run_dir / "full_results.pkl").read_bytes())
    want, got = results["plain"]["xai_maps"], results["mesh"]["xai_maps"]
    check(set(got) == set(want) and want, f"[mesh] XAI frames {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for step, maps in want.items():
        ref = np.asarray(maps["attribution_map"], np.float64)
        err = np.abs(np.asarray(got[step]["attribution_map"], np.float64) - ref).max()
        worst = max(worst, err / max(np.abs(ref).max(), 1e-30))
    print(f"[mesh] standalone XAI with XAI_MESH_DEVICES=1 vs without: {len(want)} frames, "
          f"attribution maps max |diff| / max |map| {worst:.3e} (allowed "
          f"{XAI_TOL['attribution']:.0e}); wall {walls['mesh']:.2f} s vs {walls['plain']:.2f} s",
          flush=True)
    check(worst <= XAI_TOL["attribution"], "[mesh] XAI over a mesh vs unsharded")
    return {"rel_err": worst, "wall_s": walls}


def phase_mesh(state: dict, card: str, base: Path) -> dict:
    """[mesh] data-parallel sampling, serving, training and XAI over device
    meshes on the full-width UNet with [unet]'s seeded weights."""
    from synt_isic_tpu_torch.parallel import create_mesh

    t_phase = time.perf_counter()
    ckpt = base / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / "unet_MEL_best.pth")
    report = {}

    # 1. the CLI with --dp-mesh 1 against no mesh, and a fresh --reproduce
    plain_jpgs, _, plain_launches = _mesh_cli(base / "cli_plain", ckpt, None)
    jpgs, sidecars, launches = _mesh_cli(base / "cli_mesh", ckpt, 1)
    want = ATTENTION_CALLS_PER_UNET * CLI_STEPS
    check(plain_launches[attention.KERNEL] == want and launches[attention.KERNEL] == want,
          f"[mesh] CLI launches {plain_launches[attention.KERNEL]} / "
          f"{launches[attention.KERNEL]}, not {want}")
    check(len(jpgs) == len(plain_jpgs) == CLI_BATCH, f"[mesh] CLI wrote {len(jpgs)} JPEGs")
    identical = all(a.read_bytes() == b.read_bytes() for a, b in zip(jpgs, plain_jpgs))
    metas = [json.loads(p.read_text()) for p in sidecars]
    check(all(m.get("block", {}).get("dp_mesh") == 1 for m in metas),
          f"[mesh] sidecars do not record dp_mesh 1: {metas[0]}")
    rc, redo_launches, output = run_cli_process(
        ["--reproduce", str(sidecars[3]), "--checkpoints", str(ckpt), "--device", "cuda"])
    redo_same = "byte-identical" in output
    print(f"[mesh] cli --dp-mesh 1 (MEL:{CLI_BATCH}, DDIM {CLI_STEPS}, f32): K1 launches "
          f"{launches[attention.KERNEL]} (want {want}), JPEGs byte-identical to the run "
          f"without a mesh: {identical}; sidecars record dp_mesh 1; fresh-process "
          f"--reproduce rc {rc}, byte-identical {redo_same}, "
          f"{redo_launches[attention.KERNEL]} launches", flush=True)
    check(identical, "[mesh] --dp-mesh 1 JPEGs differ from the run without a mesh")
    check(rc == 0 and redo_same and redo_launches[attention.KERNEL] == want,
          f"[mesh] --reproduce of a dp_mesh sidecar: rc {rc}\n{output}")
    report["cli_launches"] = launches[attention.KERNEL]
    report["cli_reproduce_launches"] = redo_launches[attention.KERNEL]

    # 2. the library ShardedSampler over [cuda:0, cuda:0] (and every card)
    mm = ModelManager(checkpoints_dir=str(ckpt), device="cuda")
    check(mm.load_model("MEL"), "ModelManager.load_model")
    meshes = {"[cuda:0, cuda:0]": create_mesh({"data": 2}, ["cuda:0", "cuda:0"])}
    if torch.cuda.device_count() > 1:
        meshes["every card"] = create_mesh({"data": -1})
    report["walks"] = _mesh_walks(mm, meshes, np.arange(MESH_SEEDS, dtype=np.uint32))
    # two distinct devices, one seed each: the CPU's full-width walk takes
    # about a second a step
    mixed = meshes["[cuda:0, cpu]"] = create_mesh({"data": 2}, ["cuda:0", "cpu"])
    report["walks"]["[cuda:0, cpu]"] = _mesh_walks(
        mm, {"[cuda:0, cpu]": mixed}, np.arange(MESH_MIXED_SEEDS, dtype=np.uint32)
    )["[cuda:0, cpu]"]
    # the walk's CPU shard ran on a replica built with the CPU's switches
    from synt_isic_tpu_torch.parallel.replicas import sampling_replica

    model = mm.loaded_models["MEL"]
    cpu_replica = sampling_replica(model, torch.device("cpu"))
    check(cpu_replica is not model and not cpu_replica.use_fused_attention
          and all(torch.equal(v, model.state_dict()[k].cpu())
                  for k, v in cpu_replica.state_dict().items()),
          "[mesh] the CPU sampling replica is not the primary's weights on the plain path")

    # 3. train --dp-mesh under a one-rank NCCL group, then one dp step
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--dp-mesh", "--classes", "MEL", "--procedural", str(MESH_TRAIN_IMAGES),
                "--epochs", "1", "--batch", str(TRAIN_BATCH), "--checkpoints", tmp,
                "--seed", "0", "--device", "cuda"]
        rc, train_launches, output = run_cli_process(argv, "synt_isic_tpu_torch.train",
                                                     env=env, count_all_reduce=True)
        steps = MESH_TRAIN_IMAGES // TRAIN_BATCH
        reduces = int(re.findall(r"^ALL_REDUCE (\d+)$", output, re.M)[-1])
        print(f"[mesh] RANK=0 WORLD_SIZE=1 python -m synt_isic_tpu_torch.train --dp-mesh: "
              f"rc {rc}, {steps} steps, K1/K3/stats launches "
              f"{train_launches[attention.KERNEL]}/{train_launches[attention.BWD_KERNEL]}/"
              f"{train_launches[attention.STATS_KERNEL]}, nccl all_reduce calls {reduces}",
              flush=True)
        check(rc == 0 and "data-parallel mesh {'data': 1} (process 0 of 1)" in output
              and (Path(tmp) / "unet_MEL_best.pth").exists(),
              f"[mesh] train --dp-mesh: rc {rc}\n{output}")
    check((train_launches[attention.KERNEL], train_launches[attention.BWD_KERNEL],
           train_launches[attention.STATS_KERNEL])
          == (ATTENTION_CALLS_PER_UNET * steps, ATTENTION_CALLS_PER_UNET * steps, 0)
          and reduces == steps, f"[mesh] train --dp-mesh launches {train_launches}, "
          f"{reduces} all_reduce calls")
    report["train_launches"] = {k: train_launches[k] for k in
                                (attention.KERNEL, attention.BWD_KERNEL, attention.STATS_KERNEL)}
    report["train_step"] = {
        name: _mesh_train_step(name, meshes[name], batch)
        for name, batch in (("[cuda:0, cuda:0]", MESH_TRAIN_BATCH),
                            ("[cuda:0, cpu]", MESH_MIXED_TRAIN_BATCH))}

    # 4. serve --mesh auto; 5. XAI_MESH_DEVICES=1
    report["serve"] = _mesh_serve(ckpt, base / "served")
    report["xai"] = _mesh_xai(ckpt, base)
    report["xai_fan_out"] = _mesh_xai_fan_out(mixed)
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"[mesh] phase wall {report['wall_s']:.1f} s on {card}", flush=True)
    return report


def _tp_mesh(name: str):
    """A TP_MESHES mesh over repeats of cuda:0."""
    from synt_isic_tpu_torch.parallel import create_mesh

    axes = TP_MESHES[name]
    return create_mesh(axes, ["cuda:0"] * (axes["data"] * axes["model"]))


@contextlib.contextmanager
def heads_per_launch():
    """Records the head count of every forward kernel launch made inside."""
    from unittest import mock

    heads = []
    original = attention._ForwardPlan.__call__

    def call(plan, q, k, v):
        heads.append(q.shape[1])
        return original(plan, q, k, v)

    with mock.patch.object(attention._ForwardPlan, "__call__", call):
        yield heads


def _tp_walk(walker, model, seeds) -> tuple:
    """One walk of `seeds` with its trajectory: (result, host seconds after
    `synchronize`, launches, head count of each launch)."""
    reset_launches()
    with heads_per_launch() as heads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = walker.sample(model, seeds, capture_trajectory=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, dict(attention.LAUNCHES), list(heads)


def _tp_distance(a: dict, b: dict) -> float:
    """The largest |difference| of the images and of every captured frame."""
    return max((a["images"] - b["images"]).abs().max().item(),
               (a["trajectory"].float() - b["trajectory"].float()).abs().max().item())


def _tp_kernel_times() -> dict:
    """K1 (f32, exact) and K1-fast (bf16) at the shapes one of two shards
    hands the kernel, beside the bound, the plain version and SDPA."""
    g = torch.Generator(device="cuda").manual_seed(3)
    report = {}
    for shape in TP_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        views = _btc_views(q, k, v)
        got = attention.fused_attention(*views)
        err = (got - attention.attention_reference(q, k, v)).abs().max().item()
        check(err <= TOL[torch.float32], f"[tp] K1 at {shape}: max_abs_err {err:.3e}")
        bound, bound_by, _, unit = attention_bound_ms(shape, torch.float32)
        exact = dict(ms=cuda_ms(lambda: attention.fused_attention(*views)),
                     device_ms=graph_ms(lambda: attention.fused_attention(*views)),
                     plain_ms=cuda_ms(lambda: attention.attention_reference(q, k, v)),
                     library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                     bound_ms=bound, bound_by=bound_by, max_abs_err=err)
        qb, kb, vb = (z.to(torch.bfloat16) for z in (q, k, v))
        fast = fast_times(qb, kb, vb)
        report[str(shape)] = {"exact_f32": exact, "fast_bf16": fast}
        print(f"[tp] K1 f32 at {shape}: {exact['ms']:.4f} ms ({exact['device_ms']:.4f} ms "
              f"from a CUDA graph), plain {exact['plain_ms']:.4f} ms, sdpa "
              f"{exact['library_ms']:.4f} ms, bound {bound:.4f} ms ({unit}); K1-fast bf16: "
              f"{fast['ms']:.4f} ms ({fast['device_ms']:.4f} from a graph), exact bf16 "
              f"{fast['exact_ms']:.4f} ms, sdpa {fast['library_ms']:.4f} ms, bound "
              f"{fast['bound_ms']:.4f} ms", flush=True)
    return report


def phase_tp(state: dict, card: str, base: Path) -> dict:
    """[tp] tensor parallelism over ('data', 'model') meshes on repeats of
    cuda:0, on the full-width UNet with [unet]'s seeded weights: the
    ShardedSampler walks against the unsharded walk, bf16 fast math at
    G = 2, the library generator and a server over the 1 x 2 mesh, and one
    train step and the standalone XAI run on it against no mesh."""
    from synt_isic_tpu_torch.parallel import ShardedSampler
    from synt_isic_tpu_torch.parallel import tensor_parallel
    from synt_isic_tpu_torch.serve import GenerationServer, request
    from synt_isic_tpu_torch.xai import standalone

    t_phase = time.perf_counter()
    ckpt = base / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / "unet_MEL_best.pth")
    seeds = np.arange(TP_SEEDS, dtype=np.uint32)
    report = {"walks": {}}

    # (a), (b): the f32 walks over 1 x 2 and 2 x 2 against the unsharded walk
    mm = ModelManager(checkpoints_dir=str(ckpt), device="cuda")
    check(mm.load_model("MEL"), "[tp] ModelManager.load_model")
    model = mm.loaded_models["MEL"]
    sampler = mm.create_sampler(CLI_STEPS, scheduler="ddim")
    walkers = {"unsharded": sampler,
               **{name: ShardedSampler(sampler, _tp_mesh(name)) for name in TP_MESHES}}
    for name in TP_MESHES:
        check(walkers[name].tp_axis == "model",
              f"[tp] ShardedSampler over {name}: tp_axis {walkers[name].tp_axis}")
    refs = {}
    for settings in ("f32", "tf32"):
        with contextlib.ExitStack() as ctx:
            if settings == "f32":
                ctx.enter_context(full_f32_convolutions())
                ctx.enter_context(deterministic_cudnn())
            for walker in walkers.values():          # warm: replicas, plans, cuDNN's
                walker.sample(model, seeds)
            # in turns (host-clock figures spread between runs), medians
            runs = {name: [] for name in walkers}
            for _ in range(TP_ROUNDS):
                for name, walker in walkers.items():
                    runs[name].append(_tp_walk(walker, model, seeds))
        walk_s = {name: statistics.median(r[1] for r in rs) for name, rs in runs.items()}
        ref = refs[settings] = runs["unsharded"][-1][0]
        for name in TP_MESHES:
            out = runs[name][-1][0]
            dist = _tp_distance(out, ref)
            row = report["walks"].setdefault(name, {})
            row[f"max_abs_err_{settings}"] = dist
            check(bool(torch.isfinite(out["images"]).all())
                  and out["images"].shape == ref["images"].shape
                  and list(out["noise_hashes"]) == list(ref["noise_hashes"]),
                  f"[tp] {name} walk ({settings}): images or noise hashes")
            if settings == "f32":
                counts = [(r[2][attention.KERNEL], len(r[3]), sorted(set(r[3])))
                          for r in runs[name]]
                row.update(walk_s=walk_s[name], unsharded_walk_s=walk_s["unsharded"],
                           launches=counts[0][0], heads=counts[0][2])
                print(f"[tp] ShardedSampler over {name} on [cuda:0] x "
                      f"{len(_tp_mesh(name).devices.reshape(-1))} ({TP_SEEDS} seeds, DDIM "
                      f"{CLI_STEPS}, f32, full-f32 convolutions): K1 launches per walk "
                      f"{[c[0] for c in counts]} (want {TP_WANT[name]}), heads per launch "
                      f"{counts[0][2]} (want [{TP_HEADS}]); images and trajectory vs the "
                      f"unsharded walk max_abs_err {dist:.3e} (allowed {MESH_WALK_TOL:.0e}); "
                      f"walk {walk_s[name]:.4f} s vs unsharded {walk_s['unsharded']:.4f} s "
                      f"(host clock, medians of {TP_ROUNDS} in turns)", flush=True)
                check(all(c == (TP_WANT[name], TP_WANT[name], [TP_HEADS]) for c in counts),
                      f"[tp] {name} launched K1 (count, calls, heads) {counts}")
                check(dist <= MESH_WALK_TOL, f"[tp] {name} walk vs the unsharded walk")
            else:
                row.update(walk_s_tf32=walk_s[name], unsharded_walk_s_tf32=walk_s["unsharded"])
                print(f"[tp] the same walk over {name} under the default TF32 convolutions: "
                      f"max_abs_err vs the unsharded walk {dist:.3e} (printed, not held); walk "
                      f"{walk_s[name]:.4f} s vs unsharded {walk_s['unsharded']:.4f} s (host "
                      f"clock, medians of {TP_ROUNDS} in turns)", flush=True)
    report["routes"] = dict(tensor_parallel.ROUTES)

    # (c): bf16, fast math, heads_per_program 2
    mm16 = ModelManager(checkpoints_dir=str(ckpt), device="cuda", dtype=torch.bfloat16)
    mm16.set_attention_tuning(heads_per_program=2, fast_math=True)
    check(mm16.load_model("MEL"), "[tp] bf16 ModelManager.load_model")
    model16 = mm16.loaded_models["MEL"]
    sampler16 = mm16.create_sampler(CLI_STEPS, scheduler="ddim")
    walker16 = ShardedSampler(sampler16, _tp_mesh("1x2"))
    # one forward of the sharded bf16 UNet against the unsharded one, at
    # [unet]'s inputs and its bf16 bound (kernel vs plain attention)
    twin = tensor_parallel.tp_replica(model16, [torch.device("cuda", 0)] * 2)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 3, 128, 128, generator=g, device="cuda")
    t = torch.tensor([999, 900, 700, 500, 300, 100, 10, 0], device="cuda")
    with torch.inference_mode(), full_f32_convolutions():
        got, want16 = twin(x, t), model16(x, t)
    fwd_err = (got - want16).abs().max().item()
    fwd_scale = want16.abs().max().item()
    walker16.sample(model16, seeds)
    sampler16.sample(model16, seeds)
    runs16 = {"1x2": [], "unsharded": []}
    for _ in range(TP_ROUNDS):
        runs16["1x2"].append(_tp_walk(walker16, model16, seeds))
        runs16["unsharded"].append(_tp_walk(sampler16, model16, seeds))
    out16, _, launches16, heads16 = runs16["1x2"][-1]
    alone16 = runs16["unsharded"][-1][0]
    wall16, alone16_s = (statistics.median(r[1] for r in runs16[k]) for k in ("1x2", "unsharded"))
    dist16 = _tp_distance(out16, alone16)
    # the scale of a bf16 walk's rounding: each bf16 walk's distance from the
    # f32 walk under TF32 convolutions (the bf16 walks' own settings)
    from_f32 = {k: (runs16[k][-1][0]["images"] - refs["tf32"]["images"]).abs().max().item()
                for k in runs16}
    want = TP_WANT["1x2"]
    print(f"[tp] bf16, fast math, heads_per_program 2 over 1x2: launches "
          f"{ {k: v for k, v in launches16.items() if v} } (want {want} fast-math and "
          f"{want} grouped, 0 exact), heads per launch {sorted(set(heads16))}; one forward "
          f"at batch 8 vs the unsharded bf16 UNet max_abs_err {fwd_err:.3e} (max |out| "
          f"{fwd_scale:.3f}; allowed {UNET_TOL[torch.bfloat16]:.0e} x max |out|); the walk vs "
          f"the unsharded bf16 walk max_abs_err {dist16:.3e} (printed), images vs the f32 "
          f"walk: sharded {from_f32['1x2']:.3e}, unsharded {from_f32['unsharded']:.3e}; walk "
          f"{wall16:.4f} s vs {alone16_s:.4f} s (host clock, medians of {TP_ROUNDS} in turns)",
          flush=True)
    check(all(r[2][attention.FAST_KERNEL] == want and r[2][attention.GROUPED_KERNEL] == want
              and r[2][attention.KERNEL] == 0 and set(r[3]) == {TP_HEADS}
              for r in runs16["1x2"])
          and bool(torch.isfinite(out16["images"]).all()),
          f"[tp] bf16 fast-math walk launched {launches16} at heads {sorted(set(heads16))}")
    check(fwd_err <= UNET_TOL[torch.bfloat16] * fwd_scale, "[tp] bf16 sharded UNet forward")
    report["fast_bf16"] = {"launches": launches16[attention.FAST_KERNEL],
                           "grouped": launches16[attention.GROUPED_KERNEL],
                           "max_abs_err": dist16, "forward_max_abs_err": fwd_err,
                           "from_f32": from_f32, "walk_s": wall16, "unsharded_walk_s": alone16_s}
    del mm16, model16, walker16, twin

    # (d): ImageGenerator.set_mesh over 1 x 2, MEL:8 in one block
    gen = ImageGenerator(checkpoints_dir=str(ckpt))
    gen.scheduler_kind = "ddim"
    gen.set_inference_steps(CLI_STEPS)
    gen.batch_size = TP_SEEDS
    gen.set_generation_seed(GEN_SEED)
    gen.set_mesh(_tp_mesh("1x2"))
    reset_launches()
    t0 = time.perf_counter()
    result = gen.generate_images([("MEL", TP_SEEDS)], str(base / "generated"))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = attention.LAUNCHES[attention.KERNEL]
    pngs = sorted((base / "generated" / "MEL").glob("ISIC_*.png"))
    metas = [json.loads(p.with_suffix(".json").read_text()) for p in pngs]
    print(f"[tp] ImageGenerator.set_mesh(1x2), MEL:{TP_SEEDS}, DDIM {CLI_STEPS}, f32: "
          f"{len(pngs)} PNGs in {gen_s:.3f} s (host clock, first call on the mesh), K1 "
          f"launches {gen_launches} (want {want}); sidecars' dp_mesh "
          f"{sorted({m.get('block', {}).get('dp_mesh') for m in metas})} (want [2])",
          flush=True)
    check(result.get("generated") == TP_SEEDS and len(pngs) == TP_SEEDS
          and gen_launches == want
          and all(m.get("block", {}).get("dp_mesh") == 2 for m in metas),
          f"[tp] generator over 1x2: {result}, {gen_launches} launches, {metas[:1]}")
    report["generator"] = {"launches": gen_launches, "wall_s": gen_s}

    # (e): a GenerationServer on that generator
    srv = GenerationServer(gen, port=0, output_root=str(base / "served"),
                           interactive_cost=0).start()
    try:
        host, port = srv.address
        reset_launches()
        status = request(host, port, {"op": "status"}, timeout=60)
        t0 = time.perf_counter()
        replies = [request(host, port, {"op": "generate", "class": "MEL", "count": n,
                                        "seed": 20 + n, "steps": CLI_STEPS,
                                        "postprocess": False}, timeout=300)
                   for n in TP_SERVE_COUNTS]
        served_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        served_launches = attention.LAUNCHES[attention.KERNEL]
    finally:
        srv.stop()
    want_served = ATTENTION_CALLS_PER_UNET * 2 * CLI_STEPS * len(TP_SERVE_COUNTS)
    served_meta = [json.loads(Path(f).with_suffix(".json").read_text())
                   for r in replies if r.get("ok") for f in r["files"]]
    print(f"[tp] GenerationServer over the 1x2 generator: status mesh {status.get('mesh')}, "
          f"device batch {status.get('device_batch')}; generates of {TP_SERVE_COUNTS} images "
          f"answered {[r.get('ok') for r in replies]} in {served_s:.3f} s (host clock), K1 "
          f"launches {served_launches} (want {want_served}), sidecars' dp_mesh "
          f"{sorted({m.get('block', {}).get('dp_mesh') for m in served_meta})}", flush=True)
    check(status.get("mesh") == {"data": 1, "model": 2}, f"[tp] server status {status}")
    check(all(r.get("ok") and len(r["files"]) == n for r, n in zip(replies, TP_SERVE_COUNTS))
          and served_launches == want_served
          and all(m.get("block", {}).get("dp_mesh") == 2 for m in served_meta),
          f"[tp] server replies {replies}, {served_launches} launches")
    report["serve"] = {"launches": served_launches, "served_s": served_s,
                       "mesh": status["mesh"]}
    del gen

    # (e'): --reproduce, each in a fresh process (the two at once), of one
    # image of the generator's 1 x 2 block and one of the server's: the
    # sidecar records the mesh's axes and devices, and the regeneration
    # rebuilds that mesh, its 'model' axis included
    record = {"axes": TP_MESHES["1x2"], "devices": ["cuda:0", "cuda:0"]}
    redo = {"generator": (pngs[3].with_suffix(".json"), []),
            "server": (Path(replies[0]["files"][1]).with_suffix(".json"), ["--no-postprocess"])}
    with concurrent.futures.ThreadPoolExecutor(len(redo)) as pool:
        jobs = {name: pool.submit(run_cli_process, ["--reproduce", str(sidecar),
                                                    "--checkpoints", str(ckpt),
                                                    "--device", "cuda", *extra])
                for name, (sidecar, extra) in redo.items()}
        t0 = time.perf_counter()
        done = {name: job.result() for name, job in jobs.items()}
        redo_s = time.perf_counter() - t0
    report["reproduce"] = {"wall_s": redo_s}
    for name, (sidecar, _) in redo.items():
        rc, launches, output = done[name]
        meta = json.loads(sidecar.read_text())
        original = sidecar.with_name(meta["filename"])
        again = sidecar.with_name(f"{original.stem}_reproduced{original.suffix}")
        identical = again.exists() and again.read_bytes() == original.read_bytes()
        mesh_seen = meta.get("block", {}).get("mesh")
        print(f"[tp] --reproduce of the {name}'s 1x2 image {sidecar.name} in a fresh process: "
              f"rc {rc}, byte-identical {identical}, K1 launches {launches[attention.KERNEL]} "
              f"(want {want}); its sidecar's block.mesh {mesh_seen} (want {record}); both "
              f"processes {redo_s:.1f} s (host clock)", flush=True)
        check(mesh_seen == record, f"[tp] the {name}'s sidecar records the mesh {mesh_seen}")
        check(rc == 0 and identical, f"[tp] --reproduce of the {name}'s image: rc {rc}\n{output}")
        others = sum(n for key, n in launches.items() if key != attention.KERNEL)
        check(launches[attention.KERNEL] == want and others == 0,
              f"[tp] --reproduce of the {name}'s image launched {launches}")
        report["reproduce"][name] = launches[attention.KERNEL]

    # (f): one f32 train step, and the standalone XAI run, on the 1 x 2 mesh
    report["train_step"] = _mesh_train_step("1x2", _tp_mesh("1x2"), MESH_TRAIN_BATCH, "[tp]")
    figures = importlib.util.find_spec("matplotlib") is not None
    xai, xai_s = {}, {}
    for name, mesh in (("plain", None), ("1x2", _tp_mesh("1x2"))):
        t0 = time.perf_counter()
        xai[name] = standalone.run_standalone_xai(
            target_class="MEL", seed=XAI_SEED, checkpoints_dir=str(ckpt), device="cuda",
            results_dir=str(base / f"xai_{name}"), mesh=mesh, save_figures=figures,
            log=lambda *_: None)
        torch.cuda.synchronize()
        xai_s[name] = time.perf_counter() - t0
        check(xai[name] is not None, f"[tp] standalone XAI ({name}) returned None")
    want_maps, got_maps = xai["plain"]["xai_maps"], xai["1x2"]["xai_maps"]
    check(set(got_maps) == set(want_maps) and want_maps, "[tp] standalone XAI frames")
    worst = 0.0
    for step, maps in want_maps.items():
        ref = np.asarray(maps["attribution_map"], np.float64)
        err = np.abs(np.asarray(got_maps[step]["attribution_map"], np.float64) - ref).max()
        worst = max(worst, err / max(np.abs(ref).max(), 1e-30))
    print(f"[tp] standalone XAI with the 1x2 mesh vs without: {len(want_maps)} frames, "
          f"attribution maps max |diff| / max |map| {worst:.3e} (allowed "
          f"{XAI_TOL['attribution']:.0e}); wall {xai_s['1x2']:.2f} s vs {xai_s['plain']:.2f} s"
          f"{'' if figures else ' (no matplotlib here: no figures)'}", flush=True)
    check(worst <= XAI_TOL["attribution"], "[tp] standalone XAI over 1x2 vs no mesh")
    report["xai"] = {"rel_err": worst, "wall_s": xai_s}

    report["kernel"] = _tp_kernel_times()
    report["mixed"] = _tp_mixed_rows(model, sampler)
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"[tp] phase wall {report['wall_s']:.1f} s on {card}", flush=True)
    return report


def _tp_mixed_rows(model, sampler) -> dict:
    """(g) `ShardedSampler` over {data 1, model 2} rows of the card and the
    CPU (TP_MIXED_ROWS), each walk of MESH_MIXED_SEEDS seeds against the
    unsharded walk under full-f32 convolutions: every activation crosses
    between the devices twice per sharded layer. K1 launches on the card's
    shard only (TP_MIXED_WANT, 16 heads each); the CPU's shard runs the
    plain version on its 16 heads. Each walk's first call builds its
    replica, which the seconds printed include."""
    from synt_isic_tpu_torch.parallel import ShardedSampler, create_mesh
    from synt_isic_tpu_torch.parallel import tensor_parallel
    from unittest import mock

    seeds = np.arange(MESH_MIXED_SEEDS, dtype=np.uint32)
    report = {}
    plain = []
    reference = attention.attention_reference

    def counted_plain(q, k, v):
        plain.append((q.device.type, q.shape[1]))
        return reference(q, k, v)

    with full_f32_convolutions(), deterministic_cudnn():
        alone, alone_s, _, _ = _tp_walk(sampler, model, seeds)
        for name, devices in TP_MIXED_ROWS.items():
            walker = ShardedSampler(sampler, create_mesh(TP_MESHES["1x2"], devices))
            routes = dict(tensor_parallel.ROUTES)
            plain.clear()
            with mock.patch.object(attention, "attention_reference", counted_plain):
                out, wall, launches, heads = _tp_walk(walker, model, seeds)
            dist = _tp_distance(out, alone)
            routed = {k: tensor_parallel.ROUTES[k] - routes[k] for k in routes}
            print(f"[tp] ShardedSampler over 1x2 on {name} ({MESH_MIXED_SEEDS} seeds, DDIM "
                  f"{CLI_STEPS}, f32, full-f32 convolutions): K1 launches {launches[attention.KERNEL]} "
                  f"(want {TP_MIXED_WANT}) at heads {sorted(set(heads))} (want [{TP_HEADS}]), "
                  f"plain attention calls {len(plain)} on {sorted(set(plain))} (want "
                  f"{TP_MIXED_WANT} on [('cpu', {TP_HEADS})]), routes {routed}; images and "
                  f"trajectory vs the unsharded walk max_abs_err {dist:.3e} (allowed "
                  f"{MESH_WALK_TOL:.0e}); walk {wall:.2f} s, replica build included, vs "
                  f"unsharded {alone_s:.4f} s (host clock)", flush=True)
            check(launches[attention.KERNEL] == len(heads) == TP_MIXED_WANT
                  and set(heads) == {TP_HEADS}
                  and sum(n for key, n in launches.items() if key != attention.KERNEL) == 0,
                  f"[tp] {name} launched {launches} at heads {sorted(set(heads))}")
            check(len(plain) == TP_MIXED_WANT and set(plain) == {("cpu", TP_HEADS)},
                  f"[tp] {name}: plain attention calls {len(plain)} on {sorted(set(plain))}")
            check(routed == {tensor_parallel.HEADS: TP_MIXED_WANT, tensor_parallel.FIRST: 0},
                  f"[tp] {name} routes {routed}")
            check(bool(torch.isfinite(out["images"]).all())
                  and out["images"].shape == alone["images"].shape
                  and list(out["noise_hashes"]) == list(alone["noise_hashes"]),
                  f"[tp] {name}: images or noise hashes")
            check(dist <= MESH_WALK_TOL, f"[tp] {name} walk vs the unsharded walk")
            report[name] = {"launches": launches[attention.KERNEL], "max_abs_err": dist,
                            "walk_s": wall, "unsharded_walk_s": alone_s}
    return report


def fid_from_svd(fa, fb) -> float:
    """The exact Fréchet distance of two feature sets, from the singular
    values of the centred cross product (see `frechet_feature_bound`): no
    matrix square root, so no sqrtm rounding at any rank."""
    fa, fb = np.asarray(fa, np.float64), np.asarray(fb, np.float64)
    xa, xb = fa - fa.mean(0), fb - fb.mean(0)
    na, nb = len(fa) - 1, len(fb) - 1
    nuclear = np.linalg.svd(xa @ xb.T, compute_uv=False).sum()
    return float(np.sum((fa.mean(0) - fb.mean(0)) ** 2) + np.sum(xa ** 2) / na
                 + np.sum(xb ** 2) / nb - 2 * nuclear / math.sqrt(na * nb))


def frechet_feature_bound(fa, fb, ga, gb) -> float:
    """The largest |FID(fa, fb) - FID(ga, gb)| of the EXACT Fréchet distance
    that feature differences of these sizes allow, at any number of rows n:
    with X the centred features and S = XᵀX / (n-1), Tr S = ||X||_F² / (n-1)
    and Tr (Sa Sb)^{1/2} = ||Xa Xbᵀ||_* / sqrt((na-1)(nb-1)) (the nonzero
    eigenvalues of Sa Sb are the squared singular values of Xa Xbᵀ over
    (na-1)(nb-1)); ||A B||_* <= ||A||_F ||B||_F bounds the change of each
    term. (tests/test_torch_fid.py holds the same bound on the CPU.)"""
    fa, fb, ga, gb = (np.asarray(f, np.float64) for f in (fa, fb, ga, gb))
    xa, xb = fa - fa.mean(0), fb - fb.mean(0)
    da = np.linalg.norm((ga - ga.mean(0)) - xa)
    db = np.linalg.norm((gb - gb.mean(0)) - xb)
    na, nb = len(fa) - 1, len(fb) - 1
    a, b = np.linalg.norm(xa), np.linalg.norm(xb)
    m = np.linalg.norm(fa.mean(0) - fb.mean(0))
    dm = np.linalg.norm((ga.mean(0) - gb.mean(0)) - (fa.mean(0) - fb.mean(0)))
    return float(2 * m * dm + dm ** 2 + (2 * a * da + da ** 2) / na
                 + (2 * b * db + db ** 2) / nb
                 + 2 * (da * b + a * db + da * db) / math.sqrt(na * nb))


def inception_bound_ms(model, images: int, size: int) -> tuple:
    """(bound ms, "bytes" or "operations", GFLOP) of pool3 features of
    `images` [-1,1] images of size² through `model`: the convolutions'
    2 * Cout * Cin * kh * kw * Ho * Wo flops per image, the weight shapes
    those of the torchvision manifest and Ho, Wo traced from one image at
    299², at the f32 peak (f32-accurate products at a third of the dense
    TF32 rate, the table's f32 figure); the weights, the images and the
    features each moved once."""
    from synt_isic_tpu_torch.models.inception_v3 import (BasicConv2d,
                                                         expected_inception_state_shapes)

    flops = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: flops.append(
        2 * out[0].numel() * mod.conv.weight[0].numel()))
        for m in model.modules() if isinstance(m, BasicConv2d)]
    try:
        with torch.no_grad():
            model.pool3_features(torch.zeros(1, 3, 299, 299, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    manifest = expected_inception_state_shapes()
    check(len(flops) == sum(k.endswith(".conv.weight") for k in manifest),
          f"traced {len(flops)} convolutions")
    weight_bytes = 4 * sum(int(np.prod(s)) for k, s in manifest.items() if not k.startswith("fc."))
    io_bytes = 4 * images * (size * size * 3 + 2048)
    total = images * sum(flops)
    bound, bound_by, _ = _largest_bound((weight_bytes + io_bytes) / PEAK_BYTES_PER_S * 1e3,
                                        total / PEAK_FLOPS[torch.float32] * 1e3, 0.0)
    return bound, bound_by, total / 1e9


def fid_run(extractor, set_a, set_b) -> tuple:
    """(compute_fid of the two sets with `extractor`, the features it
    extracted for each set, seconds)."""
    from synt_isic_tpu_torch.metrics.fid import compute_fid

    feats = []

    def recording(images):
        feats.append(extractor(images))
        return feats[-1]
    t0 = time.time()
    fid = compute_fid(set_a, set_b, recording)
    return fid, feats, time.time() - t0


def cpu_inception_fid(path: str, set_a, set_b) -> tuple:
    """`fid_run` with the CPU port's Inception extractor from `path`; run
    in a child process beside the card's work (the host's 2048-d sqrtm
    takes 13-34 s and holds the interpreter)."""
    from synt_isic_tpu_torch.metrics.fid import InceptionFeatureExtractor

    return fid_run(InceptionFeatureExtractor(path, device="cpu"), set_a, set_b)


def check_fid(card: str, name: str, on_card: tuple, on_cpu: tuple) -> dict:
    """One extractor's `compute_fid` on the card printed beside the CPU's
    and held to the bound of the two runs' features
    (`frechet_feature_bound`) plus what sqrtm's own rounding adds on each
    side (its distance from `fid_from_svd` of the same features); the
    host-only pixel extractor must give the same value on both sides."""
    (fid_card, card_feats, card_s), (fid_cpu, cpu_feats, cpu_s) = on_card, on_cpu
    exact_card, exact_cpu = fid_from_svd(*card_feats), fid_from_svd(*cpu_feats)
    feature_bound = frechet_feature_bound(*cpu_feats, *card_feats)
    bound = feature_bound + abs(fid_card - exact_card) + abs(fid_cpu - exact_cpu)
    print(f"[eval] compute_fid, {name} extractor ({card_feats[0].shape[1]}-d), "
          f"{len(card_feats[0])} vs {len(card_feats[1])} images: card {fid_card!r} "
          f"({card_s:.1f} s) CPU {fid_cpu!r} ({cpu_s:.1f} s) (|diff| "
          f"{abs(fid_card - fid_cpu):.3e}; allowed "
          f"{bound:.3e} = feature bound {feature_bound:.3e} + sqrtm rounding "
          f"{abs(fid_card - exact_card):.3e} / {abs(fid_cpu - exact_cpu):.3e}); exact "
          f"(singular values) card {exact_card!r} CPU {exact_cpu!r}; on {card}", flush=True)
    check(np.isfinite(fid_card) and np.isfinite(fid_cpu), f"{name} FID not finite")
    check(abs(exact_card - exact_cpu) <= feature_bound,
          f"{name}: exact FIDs {exact_card} / {exact_cpu} beyond {feature_bound}")
    check(abs(fid_card - fid_cpu) <= bound, f"{name}: FID card {fid_card} vs CPU {fid_cpu}")
    if name == "pixel":
        check(fid_card == fid_cpu, "the pixel extractor runs on the host: the same value")
    return {"card": fid_card, "cpu": fid_cpu, "bound": bound, "feature_bound": feature_bound,
            "card_s": card_s, "cpu_s": cpu_s}


def _eval_checkpoints(state: dict, ckpt: Path) -> None:
    """The gauntlet's folder: full-width MEL (the [unet] weights) and NV
    (seeded) UNets, a seeded random classifier.pth (torchvision's names, 7
    outputs) and a seeded random inception_v3.pth (torchvision's names)."""
    from synt_isic_tpu_torch.io.pth import save_checkpoint
    from synt_isic_tpu_torch.models.classifier import random_resnet
    from synt_isic_tpu_torch.models.inception_v3 import random_inception_state

    ckpt.mkdir(parents=True)
    save_checkpoint(state, str(ckpt / "unet_MEL_best.pth"))
    torch.manual_seed(EVAL_NV_SEED)
    save_checkpoint(UNet2D(UNet2DConfig()).state_dict(), str(ckpt / "unet_NV_best.pth"))
    save_checkpoint(random_resnet(7, EVAL_CLASSIFIER_SEED).state_dict(),
                    str(ckpt / "classifier.pth"))
    save_checkpoint({k: torch.from_numpy(v) for k, v in
                     random_inception_state(EVAL_INCEPTION_SEED).items()},
                    str(ckpt / "inception_v3.pth"))


def phase_eval(state: dict, card: str, base: Path) -> dict:
    """[eval] image-set evaluation on the card: Inception-v3 from a seeded
    inception_v3.pth through `default_extractor(require_standard=True)`,
    timed on 64 generated images and held to the CPU; `compute_fid` with
    the three extractors, card vs CPU; `parity_gauntlet` (every step),
    `fairness_audit --images` and a cut `e2e_loop`, each with its K1 (and
    K3) launches counted exactly."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from synt_isic_tpu_torch.metrics.fid import (FeatureExtractor, InceptionFeatureExtractor,
                                                 PixelFeatureExtractor, default_extractor)
    from synt_isic_tpu_torch.models.classifier import LesionClassifier
    from synt_isic_tpu_torch.scripts import e2e_loop, eval_fid, fairness_audit, parity_gauntlet
    from synt_isic_tpu_torch.xai import integration

    t_phase = time.time()
    ckpt = base / "checkpoints"
    _eval_checkpoints(state, ckpt)
    report = {}
    # the gauntlet's and the loop's XAI draw figures; where matplotlib is
    # missing they write their results without them, as [xai] does
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        print("[eval] matplotlib is not installed here: the gauntlet's and e2e_loop's XAI "
              "write their results without figures (save_figures=False)", flush=True)
    analyzer = integration.IntegratedXAIAnalyzer
    figures_as_installed = mock.patch.object(
        integration, "IntegratedXAIAnalyzer",
        lambda *args, **kwargs: analyzer(*args, **{**kwargs, "save_figures": figures}))

    # -- eval_fid --generate's sampler: 64 images of 128², DDIM 10 ---------------------
    reset_launches()
    t0 = time.time()
    images = eval_fid.generate("MEL", str(ckpt), EVAL_IMAGES, EVAL_STEPS, 0, "cuda")
    torch.cuda.synchronize()
    launches = dict(attention.LAUNCHES)
    want = ATTENTION_CALLS_PER_UNET * EVAL_STEPS * math.ceil(EVAL_IMAGES / 64)
    print(f"[eval] eval_fid --generate MEL --count {EVAL_IMAGES} --steps {EVAL_STEPS}: "
          f"{images.shape} in {time.time() - t0:.3f} s (cold), attention_fwd launches "
          f"{launches[attention.KERNEL]} (want {want}); on {card}", flush=True)
    check(launches[attention.KERNEL] == want and sum(launches.values()) == want,
          f"eval_fid generate launched {launches}")
    check(images.shape == (EVAL_IMAGES, 128, 128, 3) and bool(np.isfinite(images).all()),
          "generated images")
    report["launches_generate"] = launches[attention.KERNEL]

    # -- Inception-v3 on the card at batch 32: throughput, bound -------------------------
    ex = default_extractor(str(ckpt), require_standard=True)
    check(isinstance(ex, InceptionFeatureExtractor) and ex.pretrained
          and ex.batch_size == EVAL_BATCH and ex.device.type == "cuda",
          f"default_extractor picked {type(ex).__name__}")
    feats = ex(images)                                       # warm: cuDNN plans
    runs = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = ex(images)
        runs.append(time.perf_counter() - t0)
    wall = statistics.median(runs)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex(images)
        torch.cuda.synchronize()
    busy, _ = device_seconds(prof)
    peak = torch.cuda.max_memory_allocated()
    bound_ms, bound_by, gflop = inception_bound_ms(ex.model, EVAL_IMAGES, 128)
    print(f"[eval] Inception-v3 pool3 (f32, TF32 off), {EVAL_IMAGES} images of 128² at batch "
          f"{EVAL_BATCH}: {EVAL_IMAGES / wall:.2f} images/s warm ({wall:.4f} s, host clock "
          f"after synchronize, median of 3), device busy {busy:.4f} s "
          + ("(torch.profiler)" if busy else "(not measured: no device time recorded)")
          + f", peak memory {peak / 2**20:.1f} MiB; bound {bound_ms:.4f} ms by {bound_by} "
          f"({gflop:.1f} GFLOP), {EVAL_IMAGES / (bound_ms / 1e3):.0f} images/s; on {card}",
          flush=True)
    check(feats.shape == (EVAL_IMAGES, 2048) and bool(np.isfinite(feats).all()),
          "Inception features")
    report["inception"] = {"images_per_s": EVAL_IMAGES / wall, "wall_s": wall,
                           "busy_s": busy or None, "peak_bytes": peak, "bound_ms": bound_ms,
                           "bound_by": bound_by, "gflop": gflop}

    # -- compute_fid, card vs CPU, on two seeded sets: the CPU port's Inception
    # run in a child process while the card goes on to the gauntlet ---------------------------
    clf_path = str(ckpt / "classifier.pth")
    set_a, set_b = images[:EVAL_FID_SET], images[EVAL_FID_SET:2 * EVAL_FID_SET]
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    with pool:
        cpu_inception = pool.submit(cpu_inception_fid, str(ckpt / "inception_v3.pth"),
                                    set_a, set_b)
        card_inception = fid_run(ex, set_a, set_b)
        report["fid"] = {
            "classifier": check_fid(card, "classifier", fid_run(FeatureExtractor(
                LesionClassifier.from_checkpoint(clf_path)[0]), set_a, set_b), fid_run(
                FeatureExtractor(LesionClassifier.from_checkpoint(clf_path, device="cpu")[0]),
                set_a, set_b)),
            "pixel": check_fid(card, "pixel", fid_run(PixelFeatureExtractor(), set_a, set_b),
                               fid_run(PixelFeatureExtractor(), set_a, set_b))}

        # -- parity_gauntlet: every step ----------------------------------------------------
        reset_launches()
        t0 = time.time()
        with figures_as_installed:
            gauntlet = parity_gauntlet.run_gauntlet(
                str(ckpt), str(base / "gauntlet_report.json"),
                samples_per_class=GAUNTLET_SAMPLES, steps=EVAL_STEPS,
                work_dir=str(base / "gauntlet"), log=print, device="cuda")
        torch.cuda.synchronize()
        report["gauntlet_s"] = time.time() - t0
        launches = dict(attention.LAUNCHES)
        print(f"[eval] parity_gauntlet, 2 classes x {GAUNTLET_SAMPLES}, DDIM {EVAL_STEPS}: "
              f"passed {gauntlet['passed']} in {report['gauntlet_s']:.3f} s; attention_fwd "
              f"launches {launches[attention.KERNEL]} (want {GAUNTLET_LAUNCHES}); on {card}",
              flush=True)
        check(gauntlet["passed"] and not any(s["skipped"] for s in gauntlet["steps"].values()),
              f"gauntlet {gauntlet['steps']}")
        check(launches[attention.KERNEL] == GAUNTLET_LAUNCHES
              and sum(launches.values()) == GAUNTLET_LAUNCHES, f"gauntlet launched {launches}")
        report["launches_gauntlet"] = launches[attention.KERNEL]
        report["gauntlet_fid"] = gauntlet["fid_value"]

        # -- the CPU port's Inception run: the FID pair and EVAL_HOLD images' features
        on_cpu = cpu_inception.result()
    report["fid"]["inception"] = check_fid(card, "inception", card_inception, on_cpu)
    hold = on_cpu[1][0][:EVAL_HOLD]
    err = float(np.abs(feats[:EVAL_HOLD] - hold).max())
    scale = float(np.abs(hold).max())
    print(f"[eval] Inception-v3 pool3 of {EVAL_HOLD} images, card vs the CPU port: "
          f"max_abs_err {err:.3e} (max|feature| {scale:.3f}; allowed "
          f"{INCEPTION_CARD_TOL:.0e} x); on {card}", flush=True)
    check(err <= INCEPTION_CARD_TOL * scale, "Inception features card vs CPU")
    report["inception"]["max_abs_err"] = err

    # -- fairness_audit --images on the gauntlet's PNGs -----------------------------------------
    reset_launches()
    t0 = time.time()
    rc = fairness_audit.main(["--images", str(base / "gauntlet" / "fid_a"), "--checkpoints",
                              str(ckpt), "--split", "median-luminance", "--target-class", "MEL",
                              "--out", str(base / "fairness.json")])
    torch.cuda.synchronize()
    audit = json.loads((base / "fairness.json").read_text())
    print(f"[eval] fairness_audit --images (the gauntlet's {audit['n_group'] + audit['n_rest']} "
          f"FID PNGs): rc {rc}, verdict {audit['verdict']} in {time.time() - t0:.3f} s, "
          f"launches {sum(attention.LAUNCHES.values())}; on {card}", flush=True)
    check(rc == 0 and audit["confidence"]["statistics"] is not None
          and sum(attention.LAUNCHES.values()) == 0, f"fairness_audit rc {rc}: {audit}")

    # -- e2e_loop, cut ----------------------------------------------------------------------
    reset_launches()
    t0 = time.time()
    with figures_as_installed:
        rc = e2e_loop.main(["--out", str(base / "e2e"), *E2E_ARGS])
    torch.cuda.synchronize()
    report["e2e_s"] = time.time() - t0
    launches = dict(attention.LAUNCHES)
    e2e = json.loads((base / "e2e" / "report.json").read_text())
    print(f"[eval] e2e_loop {' '.join(E2E_ARGS)}: rc {rc} in {report['e2e_s']:.3f} s; "
          f"attention_fwd {launches[attention.KERNEL]} (want {E2E_FWD_LAUNCHES}), "
          f"attention_bwd {launches[attention.BWD_KERNEL]} (want {E2E_BWD_LAUNCHES}), "
          f"statistics {launches[attention.STATS_KERNEL]}; fid_pixel {e2e['fid_pixel']}; "
          f"fid_proxy {e2e['fid_proxy']}; on {card}", flush=True)
    check(rc == 0 and E2E_KEYS <= set(e2e) and e2e["train_fused"],
          f"e2e_loop report {sorted(e2e)}")
    check(all(math.isfinite(v) for k in ("fid_pixel", "fid_proxy") for v in e2e[k].values()),
          "e2e Fréchet values")
    check(launches[attention.KERNEL] == E2E_FWD_LAUNCHES
          and launches[attention.BWD_KERNEL] == E2E_BWD_LAUNCHES
          and sum(launches.values()) == E2E_FWD_LAUNCHES + E2E_BWD_LAUNCHES,
          f"e2e_loop launched {launches}")
    report["launches_e2e"] = {attention.KERNEL: launches[attention.KERNEL],
                              attention.BWD_KERNEL: launches[attention.BWD_KERNEL]}
    report["phase_s"] = time.time() - t_phase
    print(f"[eval] phase {report['phase_s']:.1f} s on {card}", flush=True)
    return report


def _score_step_times(card: str, bench: dict) -> dict:
    """The warm training step of train_family's recipe (batch
    SCORE_FAMILY_BATCH: EMA, cosine lr, min-SNR, offset noise) and the warm
    step of distill_ladder's distillation (batch SCORE_DISTILL_BATCH, 4-step
    student), each over SCORE_WARM_STEPS steps on the host clock after a
    synchronize, then SCORE_PROFILED_STEPS more under `torch.profiler`
    (device busy s/step and idle share), beside `bench`'s train step."""
    from torch.profiler import ProfilerActivity, profile

    from synt_isic_tpu_torch.scripts import train_family
    from synt_isic_tpu_torch.train import distill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    schedule = DiffusionSchedule.create()
    times, busy = {}, {}

    def warm(name, step, batch):
        base = torch.rand((batch, 128, 128, 3), generator=gen, device=dev) * 2 - 1
        step(base)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, SCORE_WARM_STEPS + 1):
            loss = step(base * (1.0 + 1e-4 * i))
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / SCORE_WARM_STEPS
        check(math.isfinite(float(loss)), f"{name} warm loss {float(loss)}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(SCORE_PROFILED_STEPS):
                step(base * (1.0 - 1e-4 * (i + 1)))
            torch.cuda.synchronize()
        seconds = device_seconds(prof)[0] / SCORE_PROFILED_STEPS
        busy[name] = seconds if seconds > 0 else None

    cfg = train_family.family_train_config(128, SCORE_FAMILY_IMAGES, 1, SCORE_FAMILY_BATCH, 0)
    state = create_train_state(train_family.family_model(128, "full", 0, fused=True).to(dev),
                               cfg, total_steps=100)
    train_step = make_train_step(schedule, cfg)
    warm("family", lambda x: train_step(state, x, gen), SCORE_FAMILY_BATCH)
    del state
    dcfg = distill.DistillConfig(batch_size=SCORE_DISTILL_BATCH, steps_per_phase=2,
                                 timestep_spacing="trailing", seed=1)
    student = UNet2D(UNet2DConfig(), dtype=torch.bfloat16, param_dtype=torch.float32,
                     use_fused_attention=True, fast_norm=True).to(dev).train()
    teacher = UNet2D(UNet2DConfig(), dtype=torch.bfloat16, param_dtype=torch.float32,
                     use_fused_attention=True, fast_norm=True).to(dev).requires_grad_(False)
    dstate = distill.create_distill_state(student, dcfg)
    dstep = distill.make_distill_step(schedule, dcfg, 4)
    warm("distill", lambda x: dstep(dstate, teacher, x, gen), SCORE_DISTILL_BATCH)
    del dstate, student, teacher
    train_s, train_batch = bench["sec_per_step"], bench["batch"]
    for name, batch in (("family", SCORE_FAMILY_BATCH), ("distill", SCORE_DISTILL_BATCH)):
        split = ("torch.profiler recorded no device time: busy not measured"
                 if busy[name] is None else
                 f"device busy {busy[name]:.5f} s/step (idle share "
                 f"{1.0 - busy[name] / times[name]:.3f}, torch.profiler over "
                 f"{SCORE_PROFILED_STEPS} step)")
        print(f"[score] warm {name} step at batch {batch} ({SCORE_WARM_STEPS} steps, host clock "
              f"after synchronize): {times[name]:.5f} s/step, {batch / times[name]:.2f} "
              f"images/s, {split}; beside the [bench] train step at batch {train_batch}: "
              f"{train_s:.5f} s/step, {train_batch / train_s:.2f} images/s; on {card}",
              flush=True)
    return {"s_per_step": times, "busy_s_per_step": busy}


def phase_score(card: str, base: Path, bench: dict) -> dict:
    """[score] the quality ladders and the per-class family through their
    `python -m synt_isic_tpu_torch.scripts.<name>` entry points (`main(argv)`
    in process), at full width: each one's K1, K1-fast, K1-G and K3 launches
    exactly as read from the code (SCORE_WANT) and no plain attention call;
    every report's keys; the checks of each path (a second train_family run
    skips and leaves the checkpoints byte for byte; rescore gives
    score_family's consistency and probe accuracy; the fast rows run K1-fast
    only and G = 2 K1-G only; the inpaint border is kept); each script's wall
    time and each rung's images/s; and the family and distillation steps
    beside [bench]'s."""
    import hashlib
    from unittest import mock

    from synt_isic_tpu_torch.models import unet2d as unet2d_module
    from synt_isic_tpu_torch.scripts import (augment_eval, distill_ladder, e2e_conditional,
                                             rescore_family_consistency, sampler_ladder,
                                             score_checkpoint, score_family, train_family)

    t_phase = time.time()
    base.mkdir(parents=True)
    report = {"launches": {}, "wall_s": {}}
    plain_calls = []
    plain_ref = unet2d_module.attention_reference

    def plain_spy(*args, **kwargs):
        plain_calls.append(1)
        return plain_ref(*args, **kwargs)

    def run(name, main, argv, out, keys, rcs=(0,), fast_share=0.0, grouped=False):
        """`main(argv)` with its launches counted and its wall time taken;
        returns the report it wrote to `out`, whose keys must be
        SCORE_KEYS[keys].
        `fast_share` of the UNet evaluations run K1-fast, the rest K1;
        `grouped`: every forward launch at G > 1."""
        evals, backwards = SCORE_WANT[name]
        want = dict.fromkeys(attention.LAUNCHES, 0)
        want[attention.FAST_KERNEL] = round(ATTENTION_CALLS_PER_UNET * evals * fast_share)
        want[attention.KERNEL] = ATTENTION_CALLS_PER_UNET * evals - want[attention.FAST_KERNEL]
        want[attention.BWD_KERNEL] = ATTENTION_CALLS_PER_UNET * backwards
        if grouped:
            want[attention.GROUPED_KERNEL] = ATTENTION_CALLS_PER_UNET * evals
        reset_launches()
        plain_calls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(unet2d_module, "attention_reference", plain_spy):
            rc = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(attention.LAUNCHES)
        print(f"[score] {name}: rc {rc} in {wall:.3f} s (host clock after synchronize); "
              f"launches {launches} (want {want}), plain attention calls {len(plain_calls)}; "
              f"on {card}", flush=True)
        check(rc in rcs, f"{name} returned {rc}")
        check(launches == want and not plain_calls,
              f"{name} launched {launches} with {len(plain_calls)} plain calls (want {want})")
        report["launches"][name] = {k: v for k, v in launches.items() if v}
        report["wall_s"][name] = wall
        written = json.loads(Path(out).read_text())
        check(set(written) == SCORE_KEYS[keys], f"{name} report keys {sorted(written)}")
        return written

    def digests(ckpt):
        return {c: hashlib.sha256((ckpt / f"unet_{c}_best.pth").read_bytes()).hexdigest()
                for c in SCORE_CLASSES}

    # -- train_family, then again (both classes skipped) ------------------------------------
    fam = base / "family"
    ckpt = fam / "checkpoints"
    argv = ["--out", str(fam), "--classes", ",".join(SCORE_CLASSES), "--size", "128",
            "--train-images", str(SCORE_FAMILY_IMAGES), "--epochs", "1",
            "--batch", str(SCORE_FAMILY_BATCH), "--width", "full", "--device", "cuda"]
    trained = run("train_family", train_family.main, argv, fam / "family_train.json",
                  "train_family")
    check(trained["family_complete"]
          and all(trained["classes"][c]["steps"] == SCORE_FAMILY_STEPS
                  and math.isfinite(trained["classes"][c]["best_loss"])
                  and not (ckpt / f"train_state_{c}.pt").exists() for c in SCORE_CLASSES),
          f"train_family report {trained['classes']}")
    before = digests(ckpt)
    again = run("train_family_again", train_family.main, argv, fam / "family_train.json",
                "train_family")
    check(again["family_complete"] and digests(ckpt) == before,
          "a second train_family changed a finished class's checkpoint")
    print(f"[score] train_family: {SCORE_CLASSES} trained ({SCORE_FAMILY_STEPS} steps of batch "
          f"{SCORE_FAMILY_BATCH} each, best losses "
          f"{[trained['classes'][c]['best_loss'] for c in SCORE_CLASSES]}); the second call "
          f"skipped both, checkpoints byte for byte", flush=True)

    # -- score_family, rescore_family_consistency --skip-probe --------------------------------
    scored = run("score_family", score_family.main, [
        "--checkpoints", str(ckpt), "--out", str(base / "family_score.json"), "--size", "128",
        "--width", "full", "--count", str(SCORE_COUNT), "--heldout", str(SCORE_HELDOUT),
        "--steps", str(SCORE_STEPS), "--clf-per-class", str(SCORE_PROBE_IMAGES),
        "--clf-epochs", "1", "--device", "cuda"], base / "family_score.json", "score_family",
        rcs=(0, 1))
    rescored = run("rescore_family_consistency", rescore_family_consistency.main, [
        "--checkpoints", str(ckpt), "--samples", str(base / "family_score_samples"),
        "--reports", str(base / "family_score.json"), "--classes", ",".join(SCORE_CLASSES),
        "--out", str(base / "family_rescore.json"), "--skip-probe", "--device", "cuda"],
        base / "family_rescore.json", "rescore_family_consistency")
    for c in SCORE_CLASSES:
        got, want = rescored["per_class"][c], scored["per_class"][c]
        same = all(got[k] == want[k] for k in ("class_consistency", "probe_heldout_acc"))
        if not same:
            from synt_isic_tpu_torch.models.classifier import LesionClassifier
            from synt_isic_tpu_torch.scripts.e2e_loop import load_generated_images

            clf, _ = LesionClassifier.from_checkpoint(str(ckpt / "classifier.pth"))
            logits = clf.logits(load_generated_images(
                base / "family_score_samples" / c / c, SCORE_COUNT)).float()
            top2 = logits.topk(2, dim=-1).values
            print(f"[score] rescore {c}: {got} vs score_family {want}; the probe's smallest "
                  f"top-2 logit margin on the samples {float((top2[:, 0] - top2[:, 1]).min()):.3e}",
                  flush=True)
        check(same, f"rescore of {c} differs from score_family")
        print(f"[score] {c}: pixel Fréchet {want['frechet_vs_heldout']} (floor "
              f"{want['floor_train_vs_heldout']}, ceiling {want['ceiling_noise_vs_heldout']}), "
              f"consistency {want['class_consistency']}, probe held-out accuracy "
              f"{want['probe_heldout_acc']}, {want['img_per_s']} images/s; rescore gives "
              f"{got['class_consistency']} and {got['probe_heldout_acc']}; on {card}",
              flush=True)
    report["family_img_per_s"] = {c: scored["per_class"][c]["img_per_s"] for c in SCORE_CLASSES}

    # -- score_checkpoint --flagship: --ab-fast-math, then --heads-per-program 2 -------------
    common = ["--checkpoints", str(ckpt), "--flagship", "--configs",
              f"ddim:{SCORE_STEPS}:trailing", "--count", str(SCORE_COUNT), "--heldout",
              str(SCORE_HELDOUT), "--device", "cuda"]
    ab_launches = {}

    def ab_main(argv):
        """score_checkpoint.main with each row's launches kept apart (the
        exact row, then the fast one); the run's totals stay counted."""
        from synt_isic_tpu_torch.scripts import ladder_common

        score_rung = ladder_common.score_rung

        def row_counted(gen, *args, **kwargs):
            before = dict(attention.LAUNCHES)
            row = score_rung(gen, *args, **kwargs)
            ab_launches[row["tag"]] = {k: v - before[k] for k, v in attention.LAUNCHES.items()}
            return row

        with mock.patch.object(ladder_common, "score_rung", row_counted):
            return score_checkpoint.main(argv)

    ab = run("score_checkpoint_ab_fast_math", ab_main,
             common + ["--ab-fast-math", "--out", str(base / "score_ab.json")],
             base / "score_ab.json", "score_checkpoint", fast_share=0.5)
    check([r["fast_math"] for r in ab["rows"]] == [False, True]
          and "frechet_delta_vs_exact" in ab["rows"][1], f"score_checkpoint rows {ab['rows']}")
    exact_row, fast_row = (ab_launches[r["tag"]] for r in ab["rows"])
    want_row = ATTENTION_CALLS_PER_UNET * SCORE_WANT["score_checkpoint_ab_fast_math"][0] // 2
    check(exact_row[attention.KERNEL] == want_row and exact_row[attention.FAST_KERNEL] == 0
          and fast_row[attention.FAST_KERNEL] == want_row and fast_row[attention.KERNEL] == 0,
          f"score_checkpoint rows launched {exact_row} (exact) and {fast_row} (fast math)")
    fast_sidecar = json.loads(next((base / "score_ab_runs" / ab["rows"][1]["tag"] / "MEL")
                                   .glob("*.json")).read_text())
    check(fast_sidecar["scheduler"].get("attention_fast_math") is True,
          "the fast row's sidecar does not record attention_fast_math")
    g2 = run("score_checkpoint_heads_per_program_2", score_checkpoint.main,
             common + ["--heads-per-program", "2", "--out", str(base / "score_g2.json")],
             base / "score_g2.json", "score_checkpoint", grouped=True)
    for row in ab["rows"] + g2["rows"]:
        print(f"[score] score_checkpoint {row['tag']} (G {2 if row in g2['rows'] else 1}): "
              f"pixel Fréchet {row['frechet_vs_heldout']}, {row['img_per_s']} images/s "
              f"(timed walk), delta vs exact {row.get('frechet_delta_vs_exact')}; on {card}",
              flush=True)
    report["score_checkpoint_img_per_s"] = {
        ("g2_" if row in g2["rows"] else "") + row["tag"]: row["img_per_s"]
        for row in ab["rows"] + g2["rows"]}
    report["launches"]["score_checkpoint_rows"] = {"exact": exact_row[attention.KERNEL],
                                                   "fast_math": fast_row[attention.FAST_KERNEL]}
    # the fast row's launches, the grouped run's, for the kernels line
    report["fast_launches"] = fast_row[attention.FAST_KERNEL]
    report["grouped_launches"] = report["launches"]["score_checkpoint_heads_per_program_2"][
        attention.GROUPED_KERNEL]

    # -- sampler_ladder, one rung per scheduler ---------------------------------------------------
    spec = ",".join(":".join(str(x) for x in r) for r in SCORE_LADDER)
    ladder = run("sampler_ladder", sampler_ladder.main, [
        "--checkpoints", str(ckpt), "--out", str(base / "ladder" / "ladder.json"),
        "--width", "full", "--configs", spec, "--count", str(SCORE_LADDER_COUNT),
        "--heldout", str(SCORE_HELDOUT), "--device", "cuda"], base / "ladder" / "ladder.json",
        "sampler_ladder")
    check([(r["scheduler"], r["steps"]) for r in ladder["rungs"]]
          == [r[:2] for r in SCORE_LADDER] and ladder["headline"] in ladder["rungs"]
          and all(math.isfinite(r["frechet_vs_heldout"]) for r in ladder["rungs"]),
          f"sampler_ladder rungs {ladder['rungs']}")
    for r in ladder["rungs"]:
        print(f"[score] sampler_ladder {r['scheduler']}-{r['steps']} {r['timestep_spacing']}: "
              f"{r['img_per_s']} images/s at batch {SCORE_LADDER_COUNT}, pixel Fréchet "
              f"{r['frechet_vs_heldout']}; on {card}", flush=True)
    print(f"[score] sampler_ladder headline {ladder['headline']['scheduler']}-"
          f"{ladder['headline']['steps']} (the fastest rung within 15% of the best Fréchet; "
          f"random weights: a path check, not a quality claim)", flush=True)
    report["ladder_img_per_s"] = {f"{r['scheduler']}{r['steps']}": r["img_per_s"]
                                  for r in ladder["rungs"]}

    # -- distill_ladder 8 -> 4 ----------------------------------------------------------------
    dist = run("distill_ladder", distill_ladder.main, [
        "--checkpoints", str(ckpt), "--out", str(base / "distill"), "--width", "full",
        "--start", "8", "--end", "4", "--steps-per-phase", "2", "--batch",
        str(SCORE_DISTILL_BATCH), "--train-images", str(SCORE_DISTILL_IMAGES), "--count",
        str(SCORE_LADDER_COUNT), "--heldout", str(SCORE_HELDOUT), "--device", "cuda"],
        base / "distill" / "report.json", "distill_ladder")
    check([r["tag"] for r in dist["rungs"]] == ["teacher_ddim8", "teacher_ddim4", "distill4"]
          and math.isfinite(dist["rungs"][2]["phase_final_loss"])
          and (base / "distill" / "checkpoints" / "unet_MEL_distill4.pth").exists(),
          f"distill_ladder rungs {dist['rungs']}")
    for r in dist["rungs"]:
        print(f"[score] distill_ladder {r['tag']}: {r['img_per_s']} images/s, pixel Fréchet "
              f"{r['frechet_vs_heldout']}; on {card}", flush=True)
    report["distill_img_per_s"] = {r["tag"]: r["img_per_s"] for r in dist["rungs"]}
    report["distill_wall_s"] = dist["distill_wall_s"]

    # -- augment_eval -------------------------------------------------------------------------
    aug = run("augment_eval", augment_eval.main, [
        "--checkpoints", str(ckpt), "--out", str(base / "augment.json"), "--width", "full",
        "--count", str(SCORE_LADDER_COUNT), "--heldout", str(SCORE_HELDOUT), "--steps",
        str(SCORE_AUGMENT_STEPS), "--device", "cuda"], base / "augment.json", "augment_eval")
    check(aug["inpaint_center_box"]["border_preserved"],
          f"augment_eval inpaint border {aug['inpaint_center_box']}")
    for r in aug["strength_sweep"]:
        print(f"[score] augment_eval strength {r['strength']}: "
              f"{SCORE_LADDER_COUNT / max(r['wall_s'], 1e-9):.2f} images/s ({r['wall_s']} s as "
              f"the report rounds it), pixel Fréchet {r['frechet_vs_heldout']}, rms to source "
              f"{r['mean_rms_to_source']}; on {card}", flush=True)
    print(f"[score] augment_eval inpaint border max error "
          f"{aug['inpaint_center_box']['border_max_abs_err']} (preserved)", flush=True)
    report["augment_wall_s"] = {str(r["strength"]): r["wall_s"] for r in aug["strength_sweep"]}

    # -- e2e_conditional ----------------------------------------------------------------------
    cond = run("e2e_conditional", e2e_conditional.main, [
        "--out", str(base / "cond"), "--width", "full", "--classes",
        ",".join(SCORE_COND_CLASSES), "--train-images", str(SCORE_COND_IMAGES), "--epochs", "1",
        "--batch", str(SCORE_COND_BATCH), "--heldout", str(SCORE_HELDOUT), "--sample-count",
        str(SCORE_LADDER_COUNT), "--ddim-steps", str(SCORE_STEPS), "--guidance",
        ",".join(f"{g:g}" for g in SCORE_GUIDANCE), "--clf-per-class", str(SCORE_PROBE_IMAGES),
        "--clf-epochs", "1", "--device", "cuda"], base / "cond" / "report.json",
        "e2e_conditional")
    check(cond["train_fused"] and cond["train"]["steps"] == SCORE_COND_STEPS
          and set(cond["results"]) == {f"g{g:g}" for g in SCORE_GUIDANCE},
          f"e2e_conditional report {cond['train']} {sorted(cond['results'])}")
    for g, res in cond["results"].items():
        print(f"[score] e2e_conditional {g}: {res['img_per_s']} images/s "
              f"({res['unet_evals_per_step']} UNet evaluation(s) a step), consistency "
              f"{ {c: v['class_consistency'] for c, v in res['per_class'].items()} }; on {card}",
              flush=True)
    report["cond_img_per_s"] = {g: res["img_per_s"] for g, res in cond["results"].items()}

    report["steps"] = _score_step_times(card, bench)
    report["phase_s"] = time.time() - t_phase
    print(f"[score] phase {report['phase_s']:.1f} s; wall s by script "
          f"{ {k: round(v, 3) for k, v in report['wall_s'].items()} }; on {card}", flush=True)
    return report


def _app_pngs(folder: Path) -> list:
    """The uint8 arrays of a folder's PNGs, in name order."""
    return [np.asarray(Image.open(p).convert("RGB")) for p in sorted(folder.glob("*.png"))]


def _check_images(images: list, n: int, what: str) -> None:
    """n images of the full size, not flat, no two alike."""
    check(len(images) == n, f"[app] {what}: {len(images)} images, not {n}")
    size = UNet2DConfig().sample_size
    check(all(a.shape == (size, size, 3) and a.std() > 0 for a in images),
          f"[app] {what}: an image of the wrong shape or flat")
    check(len({a.tobytes() for a in images}) == n, f"[app] {what}: two images alike")


def _app_overlay(image: Path, run_dir: Path, figures: bool) -> Path:
    """The attribution artifact `run_xai_analysis` finds for `image`. With
    matplotlib the pipeline drew it; without, the run's most important
    Grad-CAM (from its full_results.pkl) is blended over the image here with
    PIL, under the pipeline's file name, so the window's overlay path runs
    on the card's own results."""
    if figures:
        found = sorted(run_dir.glob("xai_step_*.png"))
        check(bool(found), f"[app] no xai_step_*.png in {run_dir}")
        return found[0]
    gmi = pickle.loads((run_dir / "full_results.pkl").read_bytes())["gradcam_most_important"]
    rgb = np.asarray(Image.open(image).convert("RGB").resize((224, 224)), np.float32) / 255.0
    cam = np.clip(np.asarray(gmi["gradcam"], np.float32), 0.0, 1.0)[..., None]
    heat = np.concatenate([cam, np.zeros_like(cam), 1.0 - cam], axis=-1)
    path = run_dir / f"gradcam_most_important_t{gmi['timestep']:.0f}.png"
    Image.fromarray((255 * (0.5 * rgb + 0.5 * heat)).astype(np.uint8)).save(path)
    return path


def phase_app(state: dict, card: str, base: Path) -> dict:
    """[app] the desktop window through the headless Qt stub and the four
    tool scripts on the card, each launch of K1 counted exactly."""
    from unittest import mock

    from synt_isic_tpu_torch.app import gui, qt_compat
    from synt_isic_tpu_torch.io.pth import load_checkpoint
    from synt_isic_tpu_torch.models import unet2d as unet2d_module
    from synt_isic_tpu_torch.models.classifier import random_resnet
    from synt_isic_tpu_torch.scripts import convert_checkpoint, smoke_generate, warm_cache
    from synt_isic_tpu_torch.utils.config import ConfigManager
    from synt_isic_tpu_torch.xai import integration

    t_phase = time.perf_counter()
    name = card.split(",")[0].strip()
    check(name in GPU_PEAKS, f"[app] GPU_PEAKS has no entry for {name!r}")
    check(qt_compat.QT_BACKEND == "stub",
          f"[app] drives the window through the headless stub; Qt is {qt_compat.QT_BACKEND}")
    report = {"launches": {}}
    ckpt = base / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / "unet_MEL_best.pth")
    torch.save(random_resnet(XAI_OUTPUTS, XAI_CLASSIFIER_SEED).state_dict(),
               ckpt / "classifier.pth")
    (base / "config.json").write_text(json.dumps({"generation": {"batch_size": APP_BATCH}}))
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        print("[app] matplotlib is not installed here: the XAI runs write their results "
              "without figures (save_figures=False; the standalone child through a -c "
              "wrapper that passes it to standalone.main), and the overlay artifact is "
              "drawn here from the run's Grad-CAM with PIL", flush=True)
    plain_calls = []
    plain_ref = unet2d_module.attention_reference

    def plain_spy(*args, **kwargs):
        plain_calls.append(1)
        return plain_ref(*args, **kwargs)

    def counted(what: str) -> int:
        got = attention.LAUNCHES[attention.KERNEL]
        others = {k: v for k, v in attention.LAUNCHES.items() if k != attention.KERNEL and v}
        report["launches"][what] = got
        check(got == APP_WANT[what] and not others and not plain_calls,
              f"[app] {what}: K1 launches {got} (want {APP_WANT[what]}), other kernels "
              f"{others}, plain attention calls {len(plain_calls)}")
        plain_calls.clear()
        return got

    # 1. the window with its default devices
    win = gui.SyntheticDataGeneratorWindow(
        config=ConfigManager(config_file=str(base / "config.json"), project_root=str(base)),
        checkpoints_dir=str(ckpt), output_dir=str(base / "generated"),
        xai_results_dir=str(base / "xai_results"))
    devices = list(win.device_combo._items)
    win._update_memory_info()
    mem = win.mem_label.text()
    check(devices[0] == "cuda:0" and re.fullmatch(r"mem: \d+ MB \(peak \d+ MB\)", mem),
          f"[app] device combo {devices}, memory label {mem!r}")
    for cls, (box, count) in win.class_rows.items():
        box.setChecked(cls == XAI_CLASS)
    win.class_rows[XAI_CLASS][1].setValue(APP_IMAGES)
    win.steps_spin.setValue(APP_STEPS)
    win.seed_mode.setCurrentText("fixed")
    win.seed_spin.setValue(0)
    win.xai_check.setChecked(False)
    with mock.patch.object(unet2d_module, "attention_reference", plain_spy):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win.start_btn.click()
        torch.cuda.synchronize()
        report["window_s"] = time.perf_counter() - t0
        counted("window")
    out = base / "generated" / XAI_CLASS
    _check_images(_app_pngs(out), APP_IMAGES, "window")
    sidecars = sorted(out.glob("*.json"))
    with open(base / "generated" / "synthetic_dataset.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    blocks = {tuple(json.loads(p.read_text())["block"]["seeds"]) for p in sidecars}
    check(len(sidecars) == APP_IMAGES and len(rows) == APP_IMAGES and len(blocks) == 1
          and all(r["class"] == XAI_CLASS for r in rows)
          and win.status_label.text().startswith("done:"),
          f"[app] window run: {len(sidecars)} sidecars, {len(rows)} CSV rows, "
          f"{len(blocks)} blocks, status {win.status_label.text()!r}")
    with mock.patch.object(unet2d_module, "attention_reference", plain_spy):
        reset_launches()
        rc = cli.reproduce_from_sidecar(str(sidecars[3]), str(ckpt),
                                        output=str(base / "redo.png"), device="cuda")
        check(rc == 0, f"[app] --reproduce of {sidecars[3].name} returned {rc}")
        counted("window_reproduce")
    print(f"[app] window on {card}: combo {devices}, {mem}; Start MEL:{APP_IMAGES}, "
          f"{win.sampler_combo.currentText()} {APP_STEPS} steps, f32, one block: "
          f"{report['window_s']:.3f} s, K1 launches "
          f"{report['launches']['window']} (want {APP_WANT['window']}), no plain attention; "
          f"{len(sidecars)} PNGs + sidecars + CSV rows; --reproduce of {sidecars[3].name} "
          f"byte-identical ({report['launches']['window_reproduce']} launches)", flush=True)

    # 2. the same with "Integrated XAI", every 2nd image
    win.out_edit.setText(str(base / "generated_xai"))
    win.class_rows[XAI_CLASS][1].setValue(APP_XAI_IMAGES)
    win.xai_freq.setValue(APP_XAI_FREQUENCY)
    win.xai_check.setChecked(True)
    analyzers, create = [], integration.create_integrated_xai_analyzer

    def factory(**kwargs):
        analyzers.append(create(**kwargs, save_figures=figures, **APP_XAI_RUN))
        return analyzers[-1]

    with mock.patch.object(integration, "create_integrated_xai_analyzer", factory), \
            mock.patch.object(unet2d_module, "attention_reference", plain_spy):
        reset_launches()
        t0 = time.perf_counter()
        win.start_btn.click()
        torch.cuda.synchronize()
        report["window_xai_s"] = time.perf_counter() - t0
        counted("window_xai")
    xai_dir = base / "generated_xai" / "xai_results" / XAI_CLASS
    jsons = sorted(xai_dir.glob("xai_*.json"))
    check([p.name.rsplit("_", 2)[0] for p in jsons] == ["xai_ISIC_0000002", "xai_ISIC_0000004"]
          and "integrated XAI failed" not in win.logs.toPlainText(),
          f"[app] integrated XAI files {[p.name for p in jsons]}")
    check(len(analyzers) == 1 and analyzers[0].classifier.device.type == "cuda",
          f"[app] the window's analyzers: {[str(a.classifier.device) for a in analyzers]}")
    for path in jsons:
        data = json.loads(path.read_text())
        check(not _xai_stage_errors(data) and data["metadata"]["n_timesteps"] == APP_STEPS,
              f"[app] {path.name}: {_xai_stage_errors(data)}")
    image = base / "generated_xai" / XAI_CLASS / "ISIC_0000002.png"
    (run_dir,) = xai_dir.glob("ISIC_0000002_*")
    artifact = _app_overlay(image, run_dir, figures)
    win.display_image(str(image))
    check(win._preview_path == str(artifact) and win.preview.pixmap_set is not None,
          f"[app] display_image showed {win._preview_path}, not {artifact}")
    win.xai_check.setChecked(False)
    print(f"[app] window with integrated XAI (MEL:{APP_XAI_IMAGES}, every "
          f"{APP_XAI_FREQUENCY}nd, IG {APP_XAI_RUN['ig_n_steps']}, SHAP "
          f"{APP_XAI_RUN['shap_n_samples']}): {report['window_xai_s']:.3f} s, K1 launches "
          f"{report['launches']['window_xai']} (want {APP_WANT['window_xai']}), "
          f"{len(jsons)} JSON files from a classifier on the card; display_image shows "
          f"{artifact.name}"
          + ("" if figures else " (drawn by this script from the run's Grad-CAM: no matplotlib)"),
          flush=True)

    # 3. "Standalone XAI": the port's module in a fresh process on cuda:0
    # the child inherits this environment, which the window's variables extend;
    # without matplotlib it runs standalone.main() through a -c wrapper that
    # turns the figures off, with the window's environment as it stands
    spawned, popen = [], subprocess.Popen

    def child(argv, env=None, **kwargs):
        spawned.append((list(argv), dict(env or {})))
        if not figures and argv[1:] == APP_STANDALONE_ARGV:
            argv = [argv[0], "-u", "-c", APP_STANDALONE_NO_FIGURES]
        return popen(argv, env=env, **kwargs)

    with mock.patch.dict(os.environ, {"PYTHONPATH": str(REPO)}), \
            mock.patch.object(subprocess, "Popen", child):
        t0 = time.perf_counter()
        win.run_standalone_xai()
        report["standalone_s"] = time.perf_counter() - t0
    check(len(spawned) == 1 and spawned[0][0] == [sys.executable, *APP_STANDALONE_ARGV]
          and spawned[0][1].get("XAI_DEVICE") == "cuda:0"
          and spawned[0][1].get("XAI_CHECKPOINTS_DIR") == str(ckpt),
          f"[app] the window spawned {[(a, {k: v for k, v in e.items() if k.startswith('XAI_')}) for a, e in spawned]}")
    logs = win.logs.toPlainText()
    results = sorted((base / "xai_results" / XAI_CLASS).glob("standalone_seed0_*/"
                                                              "analysis_results.json"))
    check("standalone XAI exited (0)" in logs and "[xai-standalone] device cuda:0" in logs
          and len(results) == 1, f"[app] standalone XAI: {logs[-2000:]}")
    data = json.loads(results[0].read_text())
    meta = data["metadata"]
    check(not _xai_stage_errors(data) and meta["n_timesteps"] > 0,
          f"[app] standalone XAI: {_xai_stage_errors(data)}, metadata {meta}")
    gui_main = subprocess.run([sys.executable, "-m", "synt_isic_tpu_torch.app.gui"], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=str(REPO)),
                              capture_output=True, text=True, timeout=300)
    check(gui_main.returncode == 1 and "python -m synt_isic_tpu_torch.cli" in gui_main.stdout,
          f"[app] python -m synt_isic_tpu_torch.app.gui: rc {gui_main.returncode}, "
          f"{gui_main.stdout} {gui_main.stderr[-2000:]}")
    print(f"[app] standalone XAI child ({APP_STEPS} steps, on cuda:0"
          f"{'' if figures else ', figures off by the -c wrapper'}): exit 0 in "
          f"{report['standalone_s']:.3f} s, {meta['n_timesteps']} frames; python -m "
          f"synt_isic_tpu_torch.app.gui: rc 1 ({gui_main.stdout.splitlines()[0]})", flush=True)

    # 4. smoke_generate
    with mock.patch.object(unet2d_module, "attention_reference", plain_spy):
        reset_launches()
        t0 = time.perf_counter()
        rc = smoke_generate.main(["--checkpoints", str(ckpt), "--output", str(base / "smoke"),
                                  "--samples", str(APP_SMOKE_SAMPLES),
                                  "--steps", str(APP_SMOKE_STEPS)])
        report["smoke_generate_s"] = time.perf_counter() - t0
        check(rc == 0, f"[app] smoke_generate returned {rc}")
        counted("smoke_generate")
    _check_images(_app_pngs(base / "smoke"), APP_SMOKE_SAMPLES, "smoke_generate")

    # 5. convert_checkpoint, host only
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rcs = [convert_checkpoint.main(argv) for argv in (
            ["inspect", str(ckpt / "unet_MEL_best.pth")],
            ["to-npz", str(ckpt / "unet_MEL_best.pth"), str(base / "unet_MEL.npz")],
            ["to-pth", str(base / "unet_MEL.npz"), str(base / "unet_MEL_back.pth")])]
    report["convert_checkpoint_s"] = time.perf_counter() - t0
    n_params = sum(v.numel() for v in state.values())
    summary = f"{len(state)} tensors, {n_params / 1e6:.2f} M parameters"
    back = load_checkpoint(str(base / "unet_MEL_back.pth"))
    exact = sorted(back) == sorted(state) and all(
        torch.equal(back[k], state[k].detach().cpu()) for k in state)
    check(rcs == [0, 0, 0] and summary in text.getvalue() and exact,
          f"[app] convert_checkpoint rcs {rcs}, inspect {summary!r} in output "
          f"{summary in text.getvalue()}, round trip exact {exact}")

    # 6. warm_cache at the production batch, bf16
    text = io.StringIO()
    with mock.patch.object(unet2d_module, "attention_reference", plain_spy), \
            contextlib.redirect_stdout(text):
        reset_launches()
        t0 = time.perf_counter()
        rc = warm_cache.main(["--configs", *APP_WARM_CONFIGS, "--classifier-batches",
                              *map(str, APP_WARM_CLASSIFIER_BATCHES), "--dtype", "bf16"])
        report["warm_cache_s"] = time.perf_counter() - t0
    check(rc == 0, f"[app] warm_cache returned {rc}: {text.getvalue()}")
    counted("warm_cache")
    report["warm_cache"] = {m.group(1): {"cold_s": float(m.group(2)), "warm_s": float(m.group(3))}
                            for m in re.finditer(r"^  (.+?): cold ([\d.]+)s, warm ([\d.]+)s$",
                                                 text.getvalue(), re.M)}
    check(set(report["warm_cache"]) == set(APP_WARM_CONFIGS) | {
        f"classifier b{b}" for b in APP_WARM_CLASSIFIER_BATCHES},
        f"[app] warm_cache printed {text.getvalue()}")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[app] smoke_generate --samples {APP_SMOKE_SAMPLES} --steps {APP_SMOKE_STEPS}: "
          f"{report['smoke_generate_s']:.3f} s, K1 launches {report['launches']['smoke_generate']}"
          f" (want {APP_WANT['smoke_generate']}); convert_checkpoint inspect ({summary}), "
          f"to-npz, to-pth: every tensor torch.equal ({report['convert_checkpoint_s']:.3f} s); "
          f"warm_cache {' '.join(APP_WARM_CONFIGS)} bf16 on {card}: K1 launches "
          f"{report['launches']['warm_cache']} (want {APP_WANT['warm_cache']}: each config "
          f"cold and warm), {report['warm_cache_s']:.3f} s in all; GPU_PEAKS has {name!r}; "
          f"the phase {report['phase_s']:.1f} s", flush=True)
    print(f"[app] warm_cache cold / warm s: {json.dumps(report['warm_cache'])}", flush=True)
    return report


def main() -> int:
    card = phase_card()
    if sys.argv[1:] == ["--host"]:
        # the [host] phase alone, e.g. in an unpacked parent tree with this
        # script copied in (so no check of which kernels the tree has)
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        print(json.dumps({"host": phase_host(), "card": card["card"]}), flush=True)
        return 0
    if sys.argv[1:] == ["--f32"]:
        # the [f32] phase alone, likewise
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        print(json.dumps({"f32": phase_f32(), "card": card["card"]}), flush=True)
        return 0
    if sys.argv[1:] == ["--xai"]:
        # the [xai] phase alone (on the full-width UNet of [unet]), likewise
        native.build([attention.KERNEL])
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_xai(phase_unet(), card["card"], Path(tmp))
        print(json.dumps({"xai": report, "card": card["card"]}, default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--generator"]:
        # the [generator] phase alone at G = GEN_GROUP, likewise (on a parent
        # tree: its warm time without the pipeline)
        native.build([attention.KERNEL])
        torch.manual_seed(0)
        state = UNet2D(UNet2DConfig()).state_dict()
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_generator(state, card["card"], Path(tmp), GEN_GROUP,
                                     check_sync=False)
        print(json.dumps({"generator": {k: report[k] for k in
                                        ("wall_s", "warm_s", "warm_runs", "block_s",
                                         "sampler_share")},
                          "card": card["card"]}), flush=True)
        return 0
    if sys.argv[1:] == ["--serve"]:
        # the [serve] phase alone, on the full-width UNet of [unet]
        native.build([attention.KERNEL])
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_serve(phase_unet(), card["card"], Path(tmp))
        print(json.dumps({"serve": report, "card": card["card"]}, default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--distill"]:
        # the [distill] phase alone, with the [bench] train step it is read against
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        report = phase_distill(card["card"], measure_train_step(batch=BENCH_BATCH,
                                                                steps=BENCH_STEPS))
        print(json.dumps({"distill": report, "card": card["card"]}, default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--remat"]:
        # the [remat] phase alone
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        print(json.dumps({"remat": phase_remat(card["card"]), "card": card["card"]},
                         default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        # the [mesh] phase alone, on the full-width UNet of [unet]
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_mesh(phase_unet(), card["card"], Path(tmp))
        print(json.dumps({"mesh": report, "card": card["card"]}, default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--tp"]:
        # the [tp] phase alone, on the full-width UNet of [unet]
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_tp(phase_unet(), card["card"], Path(tmp))
        print(json.dumps({"tp": report, "card": card["card"]}, default=str), flush=True)
        print(card["card"], flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                                 "count": card["count"]}}), flush=True)
        return 0
    if sys.argv[1:] == ["--headdim"]:
        # the [headdim] phase alone
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_headdim(card["card"], Path(tmp))
        print(json.dumps({"headdim": report, "card": card["card"]}, default=str), flush=True)
        print(card["card"], flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                                 "count": card["count"]}}), flush=True)
        return 0
    if sys.argv[1:] == ["--wgmma-ablation"]:
        # the `wgmma` forward with each of its parts removed in turn
        print(json.dumps({"wgmma_ablation": phase_wgmma_ablation(), "card": card["card"]}),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--kernel-table"]:
        # the kernel table's K2 and head_dim rows alone; `--kernel-table
        # [LABEL=]DIR ...` times other trees' kernels (DIR: a tree's csrc/,
        # LABEL by default "parent") in the same turns
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        trees = dict((a.split("=", 1) if "=" in a else ("parent", a)) for a in sys.argv[2:])
        with tempfile.TemporaryDirectory() as tmp:
            parent = _parent_libraries({label: Path(d).resolve() for label, d in trees.items()},
                                       Path(tmp)) if trees else None
            table = kernel_table_times(parent)
        print(json.dumps({"table": table, "card": card["card"]}), flush=True)
        return 0
    if sys.argv[1:] == ["--eval"]:
        # the [eval] phase alone, on a seeded full-width UNet
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        torch.manual_seed(0)
        state = UNet2D(UNet2DConfig()).state_dict()
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_eval(state, card["card"], Path(tmp))
        print(json.dumps({"eval": report, "card": card["card"]}, default=str), flush=True)
        print(card["card"], flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                                 "count": card["count"]}}), flush=True)
        return 0
    if sys.argv[1:] == ["--score"]:
        # the [score] phase alone, with the [bench] train step it is read against
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        bench = measure_train_step(batch=BENCH_BATCH, steps=BENCH_STEPS, profile=False)
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_score(card["card"], Path(tmp) / "score", bench)
        print(json.dumps({"score": report, "card": card["card"]}, default=str), flush=True)
        print(card["card"], flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                                 "count": card["count"]}}), flush=True)
        return 0
    if sys.argv[1:] == ["--app"]:
        # the [app] phase alone, on the full-width UNet of [unet]
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        with tempfile.TemporaryDirectory() as tmp:
            report = phase_app(phase_unet(), card["card"], Path(tmp))
        print(json.dumps({"app": report, "card": card["card"]}, default=str), flush=True)
        print(card["card"], flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                                 "count": card["count"]}}), flush=True)
        return 0
    if sys.argv[1:] == ["--fast-f32"]:
        # the f32 fast-math timing of [kernel-fast] alone, likewise
        native.build([attention.KERNEL])
        print(json.dumps({"fast_f32": phase_fast_f32(), "card": card["card"]}), flush=True)
        return 0
    started = time.time()

    def timed(name, fn, *args):
        """`fn(*args)`, its wall time printed beside the script's."""
        t0 = time.time()
        out = fn(*args)
        print(f"[time] {name} {time.time() - t0:.1f} s (script at {time.time() - started:.1f} s)",
              flush=True)
        return out

    built = timed("build", phase_build)
    kernel_report = timed("kernel", phase_kernel)
    bwd_report = timed("kernel-bwd", phase_kernel_bwd)
    fast_report = timed("kernel-fast", phase_kernel_fast)
    group_report = timed("kernel-group", phase_kernel_group)
    host_report = timed("host", phase_host)
    bwd_group_report = timed("kernel-bwd-group", phase_kernel_bwd_group)
    state = timed("unet", phase_unet)
    timed("unet-grad", phase_unet_grad)
    with tempfile.TemporaryDirectory() as tmp:
        launches = timed("cli", phase_cli, state, card["card"], Path(tmp) / "cli")
        gen = timed("generator", phase_generator, state, card["card"], Path(tmp) / "library",
                    group_report["g_star"])
        timed("reproduce", phase_reproduce, gen, Path(tmp) / "cli")
        gen_f32 = timed("generator-f32-fast", phase_generator_f32_fast, state, card["card"],
                        Path(tmp) / "library_f32")
        samplers = timed("samplers", phase_samplers, state, card["card"],
                         Path(tmp) / "samplers", Path(tmp) / "cli" / "checkpoints")
        xai = timed("xai", phase_xai, state, card["card"], Path(tmp) / "xai")
        served = timed("serve", phase_serve, state, card["card"], Path(tmp) / "serve")
        meshed = timed("mesh", phase_mesh, state, card["card"], Path(tmp) / "mesh")
        tp = timed("tp", phase_tp, state, card["card"], Path(tmp) / "tp")
        evaluated = timed("eval", phase_eval, state, card["card"], Path(tmp) / "eval")
        app = timed("app", phase_app, state, card["card"], Path(tmp) / "app")
        headdim = timed("headdim", phase_headdim, card["card"], Path(tmp) / "headdim")
    train_launches = timed("train", phase_train, card["card"])
    bench = timed("bench", phase_bench, card["card"])
    train_f32_launches = timed("train-f32", phase_train, card["card"], True)
    f32_report = timed("f32", phase_f32)
    distilled = timed("distill", phase_distill, card["card"], bench)
    remat = timed("remat", phase_remat, card["card"])
    classifier = timed("train-classifier", phase_train_classifier, card["card"])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "checkpoints"
        cond_train = timed("train-conditional", phase_train_conditional, card["card"], ckpt)
        cond = timed("conditional", phase_conditional, card["card"], ckpt,
                     Path(tmp) / "conditional")
        cond_redo = timed("reproduce-conditional", phase_reproduce_conditional, cond, ckpt)
        scored = timed("score", phase_score, card["card"], Path(tmp) / "score", bench)

    shape, dtype = MAIN_SHAPES[0], torch.float32
    timing = kernel_report[(shape, dtype, "time")]
    timing_bf16 = kernel_report[(shape, torch.bfloat16, "time")]
    bwd_shape = TRAIN_SHAPES[0]
    bwd_timing = bwd_report[(bwd_shape, dtype, "time")]
    bwd_bf16 = bwd_report[(bwd_shape, torch.bfloat16, "time")]
    bwd_group_bf16 = bwd_group_report[(bwd_shape, torch.bfloat16)]
    fast_timing = fast_report[(MAIN_SHAPES[0], torch.bfloat16, "time")]
    fast_f32 = fast_report[(MAIN_SHAPES[0], torch.float32, "time")]
    g_star = group_report["g_star"]
    group_bound, group_bound_by, _, _ = attention_bound_ms(GROUP_SHAPE, torch.bfloat16)
    wgmma_row = kernel_report["table"]["head_dim_fwd"][f"{WGMMA_SHAPE} bfloat16"]
    wide_fwd = kernel_report["table"]["head_dim_fwd"][f"{WIDE_SHAPE} float32"]
    wide_bwd = kernel_report["table"]["head_dim_bwd"][f"{WIDE_SHAPE} float32"]
    line = {"kernels": [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "synt_isic_tpu/ops/pallas/attention.py:28",
        "launches": launches,
        "launches_train": train_launches[attention.KERNEL],
        # [distill]: train --distill-from over phases 8 and 4 (3 UNet forwards
        # per step), and the 4-step student sampled at DDIM 4 trailing
        "launches_distill": distilled["launches"][attention.KERNEL],
        "launches_distill4_sample": distilled["sample_launches"],
        "distill_step_s": distilled["step_s"],
        "distill_step_vs_train_step": distilled["step_s"] / distilled["train_step_s"],
        # [remat]: launches per training step by mode and batch (the
        # recomputing modes with attention blocks run the forward twice)
        "launches_remat_per_step": {f"{r['remat']}@{r['batch']}": r["launches_per_step"]
                                    for r in remat["rows"]},
        "launches_conditional": cond["launches"][attention.KERNEL],
        "launches_reproduce_conditional": cond_redo[attention.KERNEL],
        "launches_train_conditional": cond_train["entry"][attention.KERNEL],
        # [samplers]: the CLI at UniPC-20 and SDE-20 (trailing, batch 8), the
        # inpainting augment run (2 x 6 steps) and a fresh-process
        # --reproduce of each
        "launches_unipc": samplers["unipc"],
        "launches_unipc_reproduce": samplers["unipc_reproduce"],
        "launches_sde": samplers["dpm_solver_sde"],
        "launches_sde_reproduce": samplers["dpm_solver_sde_reproduce"],
        "launches_augment": samplers["augment"],
        "launches_augment_reproduce": samplers["augment_reproduce"],
        "max_abs_err_unipc_walk": samplers["unipc_walk_max_abs_err"],
        "sampler_step_s": samplers["step_s"],
        # [xai]: the standalone XAI run's DDPM-50 walk at batch 1 and the
        # integrated run's 4 x DDPM-10; K1 at the batch-1 shapes
        "launches_xai": xai["launches"],
        "launches_xai_integrated": xai["launches_integrated"],
        "max_abs_err_xai_walk": xai["walk_max_abs_err"],
        "xai_batch1": xai["batch1"],
        "xai_stage_seconds": xai["stage_seconds"],
        "xai_wall_s": xai["wall_s"],
        # [serve]: the daemon's in-process server and the web UI, every walk
        # counted from its sampler call (6 per UNet evaluation); served
        # images/s beside the library's warm rate, interactive p50/p95
        "launches_serve": served["launches"],
        "serve": {k: served[k] for k in ("served_img_s", "library_img_s",
                                         "interactive_p50_s", "interactive_p95_s",
                                         "bulk_s", "unet_evaluations")},
        # [mesh]: cli --dp-mesh 1 and its fresh-process --reproduce, the
        # ShardedSampler walks (6 per UNet evaluation per shard), the
        # one-rank NCCL `train --dp-mesh` and the [cuda:0, cuda:0] train step
        "launches_mesh_cli": meshed["cli_launches"],
        "launches_mesh_reproduce": meshed["cli_reproduce_launches"],
        "launches_mesh_sharded": {k: v["launches"] for k, v in meshed["walks"].items()},
        "mesh_walk_s": {k: v["walk_s"] for k, v in meshed["walks"].items()},
        "max_abs_err_mesh_walk": {k: v.get("max_abs_err")
                                  for k, v in meshed["walks"].items() if k != "unsharded"},
        "launches_mesh_train": meshed["train_launches"][attention.KERNEL],
        "launches_mesh_train_step": {k: v["launches"][attention.KERNEL]
                                     for k, v in meshed["train_step"].items()},
        # [tp]: ShardedSampler over 1 x 2 and 2 x 2 meshes of cuda:0 (each
        # launch at 16 heads), the generator and the server over 1 x 2, the
        # train step on it; K1 at the shapes one of two shards hands it
        "launches_tp": {**{k: v["launches"] for k, v in tp["walks"].items()},
                        "generator": tp["generator"]["launches"],
                        "serve": tp["serve"]["launches"],
                        "train_step": tp["train_step"]["launches"][attention.KERNEL]},
        "tp_walk_s": {k: [v["walk_s"], v["unsharded_walk_s"], v["walk_s_tf32"],
                          v["unsharded_walk_s_tf32"]] for k, v in tp["walks"].items()},
        "max_abs_err_tp_walk": {k: [v["max_abs_err_f32"], v["max_abs_err_tf32"]]
                                for k, v in tp["walks"].items()},
        "tp_ms": {k: v["exact_f32"] for k, v in tp["kernel"].items()},
        # [tp] rows over the card and the CPU (the card's shard launches),
        # and the fresh-process --reproduce of the generator's and the
        # server's 1 x 2 images
        "launches_tp_mixed": {k: v["launches"] for k, v in tp["mixed"].items()},
        "max_abs_err_tp_mixed": {k: v["max_abs_err"] for k, v in tp["mixed"].items()},
        "tp_mixed_walk_s": {k: [v["walk_s"], v["unsharded_walk_s"]]
                            for k, v in tp["mixed"].items()},
        "launches_tp_reproduce": {k: tp["reproduce"][k] for k in ("generator", "server")},
        # [kernel]: K2, the (B, H, T, D) layout, in turns with K1 and SDPA;
        # the forward at head_dims 4, 16, 32 and 64 (the tensor cores at a
        # staged width of 8, 16, 32, 64)
        "k2": kernel_report["table"]["K2"],
        # [headdim]: the generator's walks at head_dims 4, 32, 64, 128 and 256
        # (K1 at 64, 8, 4, 2 and 1 heads), and the train steps at head_dims 32
        # and 128; [build]
        "launches_headdim": {str(d): w["launches"] for d, w in headdim["walks"].items()},
        "max_abs_err_headdim_walk": {str(d): w["max_abs_err"]
                                     for d, w in headdim["walks"].items()},
        "launches_headdim_train": {str(d): r["launches"]["fwd"]
                                   for d, r in headdim["train"].items()},
        "build_s": built["build_s"],
        "instances": built["instances"],
        "head_dims": kernel_report["table"]["head_dim_fwd"],
        # [eval]: eval_fid --generate's 64 images, parity_gauntlet (420:
        # seven DDIM-10 walks) and the cut e2e_loop (training, probe,
        # samplers, XAI); Inception-v3 at batch 32 and the FIDs card vs CPU
        "launches_eval_generate": evaluated["launches_generate"],
        "launches_eval_gauntlet": evaluated["launches_gauntlet"],
        "launches_eval_e2e": evaluated["launches_e2e"][attention.KERNEL],
        "eval_inception": evaluated["inception"],
        "eval_fid": evaluated["fid"],
        "eval_wall_s": {k: evaluated[k] for k in ("gauntlet_s", "e2e_s", "phase_s")},
        # [app]: the desktop window's run and its integrated-XAI run, an
        # in-process --reproduce of one of its images, smoke_generate, and
        # warm_cache's cold and warm walks (bf16, the production batch)
        "launches_app": app["launches"],
        "app_wall_s": {k: app[k] for k in ("window_s", "window_xai_s", "standalone_s",
                                           "smoke_generate_s", "warm_cache_s", "phase_s")},
        "warm_cache_s": app["warm_cache"],
        # [score]: the ladders and the family through their entry points
        # (K1 per script; the --ab-fast-math row's K1-fast and the G = 2
        # run's K1-G are on their own rows), wall times and images/s
        "launches_score": {k: v.get(attention.KERNEL, 0)
                           for k, v in scored["launches"].items() if k != "score_checkpoint_rows"},
        "score_wall_s": scored["wall_s"],
        "score_phase_s": scored["phase_s"],
        "score_img_per_s": {k: scored[k] for k in (
            "family_img_per_s", "score_checkpoint_img_per_s", "ladder_img_per_s",
            "distill_img_per_s", "cond_img_per_s")},
        "generator_warm_s": gen["warm_s"],
        "generator_sampler_share": gen["sampler_share"],
        "sampler_update_s": samplers["update_s"],
        "sampler_busy_s": {k: p.get("busy_s") for k, p in samplers["profiles"].items()},
        "sampler_attention_s": {k: p.get("attention_s")
                                for k, p in samplers["profiles"].items()},
        "max_abs_err": kernel_report[(shape, dtype, "BTC")],
        # the f32 kernel (3xTF32 on the tensor cores) vs its own rounding order
        "max_abs_err_kernel_order": kernel_report[(shape, dtype, "BTC", "order")],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "device_ms": timing["device_ms"],
        "library_device_ms": timing["library_device_ms"],
        # [host] at the UNet's T=256 call: host ms per call, and kernel and
        # SDPA launched from the host in turns (medians)
        "host_t256": host_report[host_name(MAIN_SHAPES[1], dtype, False)],
        "host_t256_bf16": host_report[host_name(MAIN_SHAPES[1], torch.bfloat16, False)],
        # bf16 (the tensor-core kernel, which the training path's launches
        # run): host-launched and from a CUDA graph, beside SDPA
        "max_abs_err_bf16": kernel_report[(shape, torch.bfloat16, "BTC")],
        "ms_bf16": timing_bf16["ms"],
        "device_ms_bf16": timing_bf16["device_ms"],
        "plain_ms_bf16": timing_bf16["plain_ms"],
        "bound_ms_bf16": timing_bf16["bound_ms"],
        "bound_by_bf16": timing_bf16["bound_by"],
        "library_ms_bf16": timing_bf16["library_ms"],
        "library_device_ms_bf16": timing_bf16["library_device_ms"],
        "shape": list(shape),
        "dtype": "float32",
    }, {
        "name": "attention_bwd",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "synt_isic_tpu/ops/pallas/attention.py:149",
        "launches": train_launches[attention.BWD_KERNEL],
        "max_abs_err": bwd_report[(bwd_shape, dtype, "BTC")],
        # f32 (3xTF32 on the tensor cores): from the forward's saved
        # statistics, as K4 runs it, and standalone with its statistics launch
        "ms": bwd_timing["from_stats_ms"],
        "ms_standalone": bwd_timing["ms"],
        "max_abs_err_kernel_order": bwd_report[(bwd_shape, dtype, "BTC", "order")],
        "launches_train_f32": train_f32_launches[attention.BWD_KERNEL],
        "launches_stats_train_f32": train_f32_launches[attention.STATS_KERNEL],
        # [f32]: in turns at both training shapes, and the f32 training step
        "f32": f32_report,
        "plain_ms": bwd_timing["plain_ms"],
        "bound_ms": bwd_timing["bound_ms"],
        "bound_by": bwd_timing["bound_by"],
        # scaled_dot_product_attention forward+backward through autograd,
        # beside the kernels' forward+backward (fwd_bwd_ms)
        "library_ms": bwd_timing["library_ms"],
        "fwd_bwd_ms": bwd_timing["fwd_bwd_ms"],
        "plain_fwd_bwd_ms": bwd_timing["plain_fwd_bwd_ms"],
        "library_bwd_ms": bwd_timing["library_bwd_ms"],
        # bf16, the trainer's type: K4 (kernels), the plain path and SDPA
        # forward+backward through autograd
        "fwd_bwd_ms_bf16": bwd_bf16["fwd_bwd_ms"],
        "plain_fwd_bwd_ms_bf16": bwd_bf16["plain_fwd_bwd_ms"],
        "library_ms_bf16": bwd_bf16["library_ms"],
        # K3 in bf16 (the tensor-core kernels): from the forward's saved
        # statistics, as K4 runs it, and standalone with its statistics
        # launch; SDPA's backward alone on a prebuilt forward
        "ms_bf16": bwd_bf16["from_stats_ms"],
        "ms_bf16_from_stats": bwd_bf16["from_stats_ms"],
        "ms_bf16_standalone": bwd_bf16["ms"],
        "plain_ms_bf16": bwd_bf16["plain_ms"],
        "library_bwd_ms_bf16": bwd_bf16["library_bwd_ms"],
        "bound_ms_bf16": bwd_bf16["bound_ms"],
        # one pass of B*H*T^2 exponentials on the special-function units
        "exp_bound_ms": bwd_bf16["exp_ms"],
        "max_abs_err_bf16_kernel_order": bwd_report[(bwd_shape, torch.bfloat16, "BTC",
                                                     "order")],
        # [host]: K4 forward+backward through autograd at the training
        # path's T=256 call, beside SDPA's
        "host_fwd_bwd_t256_bf16": host_report[host_name((TRAIN_BATCH, 32, 256, 8),
                                                        torch.bfloat16, False, trainable=True)],
        "launches_stats_train": train_launches[attention.STATS_KERNEL],
        # [headdim]: the train steps at head_dims 32 and 128 (6 per step; at
        # 128 the wide kernels), their statistics launches (0) and their f32
        # gradients vs plain
        "launches_headdim_train": {str(d): r["launches"]["bwd"]
                                   for d, r in headdim["train"].items()},
        "launches_stats_headdim_train": {str(d): r["launches"]["stats"]
                                         for d, r in headdim["train"].items()},
        "headdim_grad_rel": {str(d): r["grad_rel"] for d, r in headdim["train"].items()},
        # [mesh]: `train --dp-mesh` (one-rank NCCL) and the [cuda:0, cuda:0]
        # f32 train step against one device
        "launches_mesh_train": meshed["train_launches"][attention.BWD_KERNEL],
        "launches_mesh_train_step": {k: v["launches"][attention.BWD_KERNEL]
                                     for k, v in meshed["train_step"].items()},
        "mesh_train_max_weight_diff": {k: v["max_weight_diff"]
                                       for k, v in meshed["train_step"].items()},
        "launches_distill": distilled["launches"][attention.BWD_KERNEL],
        "launches_stats_distill": distilled["launches"][attention.STATS_KERNEL],
        # [remat]: s/step and peak bytes of the training step by mode and batch
        "remat": {f"{r['remat']}@{r['batch']}": [r["sec_per_step"], r["peak_bytes"]]
                  for r in remat["rows"]},
        "classifier_step_s": classifier["step_s"],
        "launches_stats_train_conditional": cond_train["entry"][attention.STATS_KERNEL],
        "launches_eval_e2e": evaluated["launches_e2e"][attention.BWD_KERNEL],
        "launches_train_conditional": cond_train["entry"][attention.BWD_KERNEL],
        # [score]: train_family, distill_ladder and e2e_conditional's training
        "launches_score": {k: v[attention.BWD_KERNEL] for k, v in scored["launches"].items()
                           if v.get(attention.BWD_KERNEL)},
        "score_family_step_s": scored["steps"]["s_per_step"]["family"],
        "score_distill_step_s": scored["steps"]["s_per_step"]["distill"],
        "score_step_busy_s": scored["steps"]["busy_s_per_step"],
        # [kernel]: the backward (K3 from the saved statistics) at head_dims
        # 4, 16, 32 and 64
        "head_dims": kernel_report["table"]["head_dim_bwd"],
        "shape": list(bwd_shape),
        "dtype": "float32",
    }, {
        "name": "attention_bwd_grouped",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "synt_isic_tpu/ops/pallas/attention.py:149",
        # the G = 2 conditional training run's launches
        "launches": cond_train["lib"][attention.BWD_GROUPED_KERNEL],
        "max_abs_err": bwd_group_bf16["max_abs_err"],
        "ms": bwd_group_bf16["times"][COND_GROUP],
        "plain_ms": bwd_group_report["plain_ms"],
        "bound_ms": bwd_group_bf16["bound_ms"],
        "bound_by": bwd_group_bf16["bound_by"],
        # SDPA's backward alone, on a prebuilt forward, at this shape in bf16
        "library_ms": bwd_bf16["library_bwd_ms"],
        "heads_per_program": COND_GROUP,
        "ms_by_heads_per_program": {str(grp): ms for grp, ms in
                                    bwd_group_bf16["times"].items()},
        "f32_ms_by_heads_per_program": {str(grp): ms for grp, ms in
                                        bwd_group_report[(bwd_shape, dtype)]["times"].items()},
        "shape": list(bwd_shape),
        "dtype": "bfloat16",
    }, {
        "name": "attention_fwd_fast_math",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "synt_isic_tpu/ops/pallas/attention.py:43",
        "launches": gen["launches"][attention.FAST_KERNEL],
        "max_abs_err": fast_report[(MAIN_SHAPES[0], torch.bfloat16, "BTC")],
        "max_abs_err_kernel_order": fast_report[(MAIN_SHAPES[0], torch.bfloat16, "BTC",
                                                 "order")],
        "ms": fast_timing["ms"],
        "plain_ms": fast_timing["plain_ms"],
        "bound_ms": fast_timing["bound_ms"],
        "bound_by": fast_timing["bound_by"],
        "library_ms": fast_timing["library_ms"],
        "exact_ms": fast_timing["exact_ms"],
        "device_ms": fast_timing["device_ms"],
        "host_t256": host_report[host_name(MAIN_SHAPES[1], torch.bfloat16, True)],
        # f32 (the 3xTF32 tensor-core kernel with fast math), in turns with
        # the exact f32 kernel and SDPA f32, host-launched and from a CUDA
        # graph; its launches on the f32 fast-math generator's path
        "launches_f32": gen_f32["launches"][attention.FAST_KERNEL],
        "launches_f32_reproduce": gen_f32["reproduce_launches"][attention.FAST_KERNEL],
        # [score]: score_checkpoint --ab-fast-math's fast row (bf16)
        "launches_score_ab_fast_math": scored["fast_launches"],
        # [tp]: the bf16 G = 2 walk over 1 x 2 (16 heads per launch), and
        # K1-fast at the shapes one of two shards hands it
        "launches_tp": tp["fast_bf16"]["launches"],
        "tp_ms": {k: {m: v["fast_bf16"][m] for m in ("ms", "device_ms", "exact_ms",
                                                      "plain_ms", "library_ms", "bound_ms")}
                  for k, v in tp["kernel"].items()},
        "ms_f32": fast_f32["ms"],
        "device_ms_f32": fast_f32["device_ms"],
        "exact_ms_f32": fast_f32["exact_ms"],
        "exact_device_ms_f32": fast_f32["exact_device_ms"],
        "plain_ms_f32": fast_f32["plain_ms"],
        "bound_ms_f32": fast_f32["bound_ms"],
        "library_ms_f32": fast_f32["library_ms"],
        "library_device_ms_f32": fast_f32["library_device_ms"],
        "ms_f32_t256": fast_report[(MAIN_SHAPES[1], torch.float32, "time")]["ms"],
        "max_abs_err_f32": fast_report[(MAIN_SHAPES[0], torch.float32, "BTC")],
        "max_abs_err_f32_kernel_order": fast_report[(MAIN_SHAPES[0], torch.float32, "BTC",
                                                     "order")],
        # [generator-f32-fast]: the warm sampler step with and without fast
        # math (in turns), and the attention kernels' device time per step
        "generator_f32_step_s": {"fast": gen_f32["step_s"][True],
                                 "exact": gen_f32["step_s"][False]},
        "generator_f32_attention_s": {"fast": gen_f32["profiles"][True].get("attention_s"),
                                      "exact": gen_f32["profiles"][False].get("attention_s")},
        "shape": list(MAIN_SHAPES[0]),
        "dtype": "bfloat16",
    }, {
        "name": "attention_fwd_grouped",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "scripts/profile_attn_grouped.py:25",
        # the variant the launches counted: fast math at G* in bf16
        "launches": gen["launches"][attention.GROUPED_KERNEL],
        "max_abs_err": group_report["max_abs_err"],
        "max_abs_err_kernel_order": group_report["max_abs_err_kernel_order"],
        "ms": group_report[(torch.bfloat16, "fast")][g_star],
        "plain_ms": group_report["plain_ms"],
        "bound_ms": group_bound,
        "bound_by": group_bound_by,
        "library_ms": group_report["library_ms"],
        "heads_per_program": g_star,
        "fast_math": True,
        # [score]: score_checkpoint --heads-per-program 2 (exact maths, bf16)
        "launches_score_heads_per_program_2": scored["grouped_launches"],
        "fast_ms_by_heads_per_program": {str(grp): ms for grp, ms in
                                         group_report[(torch.bfloat16, "fast")].items()},
        "f32_fast_ms_by_heads_per_program": {str(grp): ms for grp, ms in
                                             group_report[(torch.float32, "fast")].items()},
        # exact maths, as grouped_attention computes it (the K5 row)
        "ms_by_heads_per_program": {str(grp): ms for grp, ms in
                                    group_report[(torch.bfloat16, "exact")].items()},
        "shape": list(GROUP_SHAPE),
        "dtype": "bfloat16",
        # [kernel-group]: G past one block's heads (16 at 32 heads of 8, 2 at
        # heads of 64 and 128), exact ms at G, torch.equal to G = 1
        "ms_any_group": group_report["extra"],
    }, {
        "name": "attention_fwd_wgmma",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "synt_isic_tpu/ops/pallas/attention.py:28",
        # [headdim]: the bf16 generator walk at head_dim 128 (all of its K1
        # launches), and the train steps' K1 at head_dims 32 and 128
        "launches": headdim["bf16_walk"]["route_launches"],
        "launches_headdim_train": {str(d): r["launches"]["route"]
                                   for d, r in headdim["train"].items()
                                   if r["route"] == attention.WGMMA_KERNEL},
        "max_abs_err": wgmma_row["max_abs_err"],
        "ms": wgmma_row["ms"],
        "device_ms": wgmma_row["device_ms"],
        "plain_ms": wgmma_row["plain_ms"],
        "bound_ms": wgmma_row["bound_ms"],
        "bound_by": wgmma_row["bound_by"],
        "library_ms": wgmma_row["library_ms"],
        # [kernel]: the bf16 forward at (8, 256/D, 1024, D) for D 16 to 256
        "by_head_dim": {name: row for name, row in kernel_report["table"]["head_dim_fwd"].items()
                        if name.endswith("bfloat16") and attention.uses_wgmma(
                            torch.bfloat16, int(name.split(")")[0].rsplit(",", 1)[1]))},
        "registers": built["registers"],
        "hgmma": {k: c["HGMMA"] for k, c in built["sass"].items()
                  if k.startswith("attention_fwd_wgmma_kernel")},
        "shape": list(WGMMA_SHAPE),
        "dtype": "bfloat16",
    }, {
        "name": "attention_fwd_wide",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "synt_isic_tpu/ops/pallas/attention.py:28",
        # [headdim]: the f32 walk of HEADDIM_WIDE (one head of 512 a call, all
        # of its K1 launches on the wide kernel); the other walks and train
        # steps that ran it
        "launches": headdim["walks"][HEADDIM_WIDE.attention_head_dim]["wide_launches"],
        "launches_headdim": {**{f"f32 {d}": w["wide_launches"]
                                for d, w in headdim["walks"].items()},
                             "bf16 512": headdim["bf16_walk_wide"]["route_launches"],
                             **{f"train {d}": r["launches"]["route"]
                                for d, r in headdim["train"].items()
                                if r["route"] == attention.WIDE_KERNEL}},
        **{key: wide_fwd[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")},
        # [kernel]: the f32 forward at (8, 256/D, 1024, D) for D 128 to 320
        # and at (4, 1, 1024, 512), and the bf16 one above 256
        "by_head_dim": {name: row for name, row in kernel_report["table"]["head_dim_fwd"].items()
                        if row["wide"]},
        "registers": {k: r for k, r in built["registers"].items() if "wide" in k},
        "shape": list(WIDE_SHAPE),
        "dtype": "float32",
    }, {
        "name": "attention_bwd_wide",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "synt_isic_tpu/ops/pallas/attention.py:149",
        # [headdim]: the bf16 train steps of HEADDIM_WIDE (3 steps, 6 K3
        # each, all on the wide kernels) and at head_dim 128
        "launches": headdim["train"][HEADDIM_WIDE.attention_head_dim]["launches"]["bwd_wide"],
        "launches_headdim_train": {str(d): r["launches"]["bwd_wide"]
                                   for d, r in headdim["train"].items()},
        **{key: wide_bwd[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")},
        # [kernel]: K3 from saved statistics at (8, 256/D, 1024, D) for D 128 to
        # 320 and at (4, 1, 1024, 512), both dtypes
        "by_head_dim": {name: row for name, row in kernel_report["table"]["head_dim_bwd"].items()
                        if row["wide"]},
        "shape": list(WIDE_SHAPE),
        "dtype": "float32",
    }]}
    print(json.dumps(line), flush=True)
    print(card["card"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
