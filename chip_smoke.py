#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one Hopper GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card, each through its fused CUDA
kernel: the first rows of the reference's three sweeps, the linear sweep
(seed_linpadding_expts.sh) through K1 and the sigmoid sweep
(sigmoid_vae_padding_expts.sh) through K2, both in
vae_training_tpu_torch/csrc/linear_vae.cu, and the sphere sweep
(sphere_vae_padding_expts.sh, 200|200|200 ReLU stacks) through K5
(csrc/mlp_vae.cu); then a seed grid and the whole linear and sigmoid
sweeps through K6a, the grid mode of the linear kernel (one launch a chunk
over every row); then the sphere sweep and a sphere seed grid through K6b,
the grid mode of the MLP kernel, and sigmoid MLPs with the dual decoder
through K5-dual, the MLP kernel's dual branch; then all of them again with
bf16 Adam moments (K4, --adam_dtype bf16); then the probes T1–T5, each
through its tool's entry point (vae_training_tpu_torch/tools/), on
csrc/probes.cu and, for T1, the training kernels' sampler; then the MLP kernel's step
split into its parts, then the linear kernel's; last, the port's surfaces
beyond the kernels: the bench, the sampler, the background artifact
writer, the gaussian dataset, --profile, --debug_nans and the closed-form
ELBO floor on K1; then the torch path as one CUDA graph replay a step, the
warm starts and --track_correlation; then epoch mode and the conv VAE at
the bench's conv configuration (BASELINE.json config 5), on the torch path
as one CUDA graph replay an epoch (no TPU kernel lies on that path); last,
the parallel backends that one card can check: the dp path over NCCL at
world size 1, and the sharded seed grid and grouped sweep in two processes
sharing the card, on K6a and K6b, one launch a rank over its own rows;
last, ``--precision bf16``, the reference's default, which the CLI takes
on the card when the flag is not given (every CLI phase above runs it):
each training kernel in its bf16-dot mode against its bf16 plain version,
the torch path's forms in it, the times of both modes, and the CLI's rows
1 under ``--precision fp32``. The direct kernel calls of phases 4-31 keep
the wrappers' default, fp32 dots (phase 32 times both); phases 33, 39 and 47 pass
``--precision fp32`` (their figures and oracle are fp32's); last, the
sweep runner's supervised rows (``--isolate``: each run in a process of
its own under a deadline, a retry resuming from its checkpoint) and
``--ckpt_backend orbax`` (a torch.distributed.checkpoint directory).
Fifty-nine phases:

  1. device: CUDA, compute capability 9.0, TF32 off;
  2. build: nvcc builds the three kernel libraries (linear_vae, mlp_vae,
     probes) from the checkout's sources, the builds started together;
  3. sampler: the kernel's Philox words equal ops/rng.py's bitwise, its
     normals agree to 1e-5 and the normals-only draw's equal them bitwise,
     and 4M kernel normals have the right moments;
  4. parity: the kernel against its plain PyTorch version on the card,
     from the same state, 64 steps, external noise and in-kernel sampling,
     -tdv on and off;
  5. main path: the CLI's main() for 12000 steps with --kernels cuda; K1
     must launch and the plain path must not run; the artifacts must exist
     and the eval loss and padding norm must fall;
  6. resume: 7000 steps, then --resume to 12000, equal to phase 5 bitwise;
  7. times: kernel and torch-path steps/s at the slice's shapes;
  8. the MLP library's registers and spills, its cluster plan (one cluster
     a row, of 16 CTAs where that takes no more turns than 8; at 1, 7, 15
     and 20 rows) and its shared memory a CTA at every sweep shape on both
     cluster sizes in both dot modes, equal to kernels/mlp_vae.py's planner;
  9. K2 against its plain version at sigmoid row 1 (64 steps, external
     noise and in-kernel sampling, -tdv on and off; K1's tolerances) and a
     40 = 15 + 25 chunk split bitwise;
 10. K5 against its plain version at sphere row 1, full width (the same
     cases, and one linear_gaussian MLP case) and the chunk split bitwise;
 11. the CLI's sigmoid row 1 (K2) and sphere row 1 (K5), 12000 steps each
     with --kernels cuda; each kernel must launch and the plain path must
     not run; artifacts; the eval loss must fall;
 12. sphere resume: 7000 steps, then --resume to 12000, equal to phase 11
     bitwise;
 13. times: K2 and K5 against the torch path, steps/s;
 14. K6a on the linear sweep's 21 rows and the sigmoid sweep's 18: every
     row equal to its solo K1/K2 launch bitwise (64 steps, in-kernel
     sampler), K6a against its plain version with external noise (K1's
     tolerances), a 40 = 15 + 25 chunk split bitwise;
 15. the CLI's --seed_grid 2,3,4 at linear row 1, 12000 steps, --kernels
     cuda: one K6a launch a chunk, no solo launch, and row seed2 equal to
     phase 5's solo run bitwise;
 16. the sweep runner, --grouped, linear (21 runs) and sigmoid (18 runs),
     12000 steps: one K6a launch a chunk, the wall-accounting line, every
     run's loss falling, and the linear sweep's --resume from 7000 equal to
     the uninterrupted sweep bitwise;
 17. times: K6a against the same rows as sequential solo launches and its
     plain version, with each launch's bound; the launch-step time against
     the number of rows (1, 21, 132, 264), with the SM clock nvidia-smi
     reads during each window;
 18. K6b on the sphere sweep's 15 rows and on 3 sigmoid-MLP dual rows
     (200|200|200): every row equal to its solo K5 launch bitwise (64
     steps, in-kernel sampler), K6b against its plain version with external
     noise (32 steps one at a time: losses at MLP_TOL, each row's state by
     relative 2-norm at MLP_TOL's rtol), a 40 = 15 + 25 split;
 19. K5-dual against its plain version at sigmoid row 1 with 200|200|200
     (64 steps one at a time, as in phase 18; external noise and in-kernel
     sampling, -tdv on and off), a chunk split bitwise, and the CLI for
     12000 steps on it;
 20. the CLI's --seed_grid 69,24,48 at sphere row 1 (one K6b launch a
     chunk, row seed69 equal to phase 11's solo run bitwise) and the sphere
     sweep through the sweep runner, --grouped (15 runs, one K6b launch a
     chunk, every run's loss falling, --resume from 7000 bitwise);
 21. times: K6b against the same rows as sequential solo K5 launches and
     its plain version, with its bound; the launch-step against copies of
     sphere row 1 (1, 15, 45); K5-dual against the torch path;
 22. K4 against its plain version: K1 and K2 at row 1 (64 steps, external
     noise and the in-kernel sampler, -tdv on and off), K5 and K5-dual at
     row 1, K6a on the linear (21) and sigmoid (18) sweeps, K6b on the
     sphere sweep (15) and 3 sigmoid-MLP rows, one step at a time from the
     kernel's state (16 steps on the MLP kernel and K6a). Every step is
     also launched with f32 moments from the same state, and the bf16
     launch's matrix moments must be the f32 launch's rounded to nearest
     even, bitwise. Against the plain version the matrix moments keep
     tests/kernel_test_helpers.py's ulp contract (strict on the linear
     kernel, drift on the MLP kernel; >= 95% bitwise); K1 and K2 also as
     one 64-step launch (drift);
 23. in bf16, every row of those four grids equal to its solo launch
     bitwise (64 steps), and 40 = 15 + 25 bitwise on every kernel;
 24. the CLI with --adam_dtype bf16 --kernels cuda, 12000 steps, on linear,
     sigmoid, sphere and sigmoid-MLP row 1 (the [kernels] line names the
     kernel and bf16 moments, only that kernel launches, losses fall, the
     checkpoint's moments are bf16); sphere --resume from 7000 bitwise; the
     sphere (K6b) and linear (K6a) sweeps through `sweep --grouped
     --adam_dtype bf16`, 4 launches and nothing else;
 25. times: every kernel with f32 and bf16 moments in turn (f32, bf16,
     bf16, f32) and its bf16 plain version, with K4's bound;
 26. T4: the cluster and phase kernels' registers, shared memory and spills
     (ptxas, both dot modes) and the cluster plan at 1, 2 and 4 chains
     (kernels/probes.py's mirror of the library's constants); chains of 24 dependent
     104x256x256 dots, the phase and the cluster form, against the plain
     version (3 steps, 1/2/4 chains, rtol 1e-6; random inputs, 8 dots, rtol
     1e-4 / atol 1e-5), two cluster launches bitwise equal; in the TPU
     tool's bf16 dots (mma.sync, f32 sums) the tool's inputs (3 steps) and
     two-term inputs (2 steps) bitwise the plain bf16 version, random
     inputs one dot deep at rho <= 1e-3 (the fp32 instantiation >= 0.5), 8
     random dots' drift printed beside the plain chain's under float64
     sums; then the tool's table (1, 2, 1, 2, 4 chains, each form in bf16
     then fp32 dots) and VERDICTs; torch.matmul + clamp a step in device
     time (20 steps in a CUDA graph; bf16 operands for bf16); the cluster
     form's step split by launch variants (staging, + products, + the store
     into the CTA's own h (fp32: with the partial tiles' sums; bf16: the
     clamp and rounding), whole) at 1, 2 and 4 chains (bf16 dots: 1), in
     device time, beside the bf16 cut's shared-memory wavefronts a warp a
     dot under the 32-bank model (kernels/probes.py cluster_wavefronts;
     printed, not measured); the phase form's cuts (fp32 units of 16 x 16
     outputs, K over 8 half-warps; bf16 16 x 32, K over 8 warps) and chain 0
     of 4 chains bitwise chain 0 alone in both dot modes (the sums' order
     does not depend on the chain count), two fp32 phase launches bitwise
     equal; its dot split by launch variants (the grid barriers alone, the
     phases' work without them, whole) at 1 and 4 chains in both dot modes,
     in device time;
 27. T3: 8 distinct weights a chain, renormalised a trip, the phase and
     the stream form (the stream kernel's registers and spills, ptxas),
     against the plain version (2 trips, 1/2/4 chains, rtol 1e-4 / atol
     1e-5), two stream launches bitwise equal (both dot modes); in bf16
     dots two-term inputs (2 trips) bitwise, one dense dot at rho <= 1e-3
     (the phase form on the first weight, the stream form on a trip of 7
     identities and it), 2 dense trips' drift printed; then the tool: ns a dot for
     1/2/4 chains and the independence speed-up, each form and dot mode;
     torch.matmul a dot in device time (200 dots in a CUDA graph); the
     stream form's dot split by launch variants (the weights streamed
     alone, the products alone, the products with the stream, + sums and
     the row exchange, whole) at 1, 2 and 4 chains (bf16 dots: 1), in
     turns, beside the bf16 products' shared-memory wavefronts a warp a dot
     under the 32-bank model (kernels/probes.py stream_product_wavefronts;
     printed, not measured); the phase form's split at 1 and 4 chains in
     both dot modes; the fp32 phase dot beside torch.matmul's;
 28. T5: 25 dots and Adam on 5 buffers, tail and interleaved, each form,
     against the plain versions (3 steps; h at MLP_TOL, what Adam changed
     within DELTA_RTOL, with its controls; bf16 dots 2 steps, h at rho <=
     0.1, the fp32 instantiation >= 0.5), two stream launches bitwise
     equal (both dot modes); then tail and interleaved in turns and the
     VERDICT, each form and dot mode; the stream form's step split by
     launch variants (as phase 27's, whole with Adam) and the phase form's
     (tail), both in both dot modes, in turns;
 29. T2: the dot kernel's registers, shared memory and spills (ptxas) and
     its plan, the library's equal to kernels/probes.py's; every mode
     against its plain version at four odd shapes; then the tool: one dot in
     fp32, TF32 and bf16 modes against the plain versions (rtol 1e-5 / atol
     1e-4) and a float64 host product (fp32's error under bf16's / 100,
     TF32's between), with torch.matmul's times, each also in device time
     (200 calls captured in one CUDA graph); the kernel's split by launch
     variants (launch only, + staging, + products, whole) and its staging
     rate in bytes a clock an SM, with the SM clock read beside it;
 30. T1: the draw at the battery's shape: words bitwise ops/rng.py's,
     normals within 1e-5, the normals-only draw's bitwise the words
     entry's; the statistical battery (chi-squared, lags 1-4, the four streams, 16
     grid row keys) on the normals-only draw; the normals-only draw, the
     words entry and torch.randn of as many normals in device time, in
     turns.

 31. the MLP kernel's step at sphere row 1 split by timing variants that
     leave parts out: the layer sums, the operand stages, Adam, everything
     but the cluster barriers (windows of at least 0.5 s), in both dot
     modes in turn (fp32 FMA chains, bf16 tensor-core sums); the step on
     clusters of 8 beside the launch's 16; and 16 steps on clusters of 8
     equal to 16 steps on clusters of 16 bitwise, solo and dual, f32 and
     bf16 moments, fp32 and bf16 dots;
 32. the linear kernel's step at linear row 1, sigmoid row 1 and the
     sigmoid sweep's largest row (D 28, L 24) split by timing variants that
     leave parts out: the noise (sampler and manifold draw), the per-row
     pass, the per-parameter pass with Adam, everything but the two
     barriers; what leaving each part out saves, and each part alone; in
     both dot modes in turn (fp32 FMA chains, bf16 tensor-core products,
     with the bf16 mode's warp roles);
 33. the bench (``vae_training_tpu_torch._scripts.bench`` ``main``, the
     console script vae-bench-torch's entry, ``--precision fp32``) in this
     process on linear, sigmoid,
     sphere, grid_linear, grid_sigmoid and grid_sphere with f32 moments,
     and on linear and grid_sphere with bf16 ones: one JSON line each with
     a positive value, an mfu_pct and the card's name and power limit; its
     launch counts on stderr: one launch of the config's kernel a chunk and
     nothing else; each value within 25% of this run's phase 7, 13, 17 or
     21 figure for that shape (the f32 figure for the bf16 runs); --config
     conv is phase 47's;
 34. sample (vae-sample-torch) on phase 5's linear run and phase 11's
     sphere run: shapes, finite values, the same --seed bitwise, another
     seed different, and a copy of the directory holding only model.pkl
     giving the checkpoint's samples bitwise;
 35. the background writer: the linear, sigmoid and sphere sweeps through
     `sweep --grouped` with the saves written synchronously (the parent's
     way, a stand-in writer) and in the background, in turns: the
     wall-accounting split of each, and every run's artifacts equal
     between the two bitwise (phases 6, 12, 15, 16 and 20 already hold the
     resumes and the grid rows bitwise with the writer);
 36. the gaussian dataset through the CLI on the torch path (dd 3, pd 9,
     latent 20, 512|512, 400 steps): no kernel launches, the eval loss
     falls, the banner and losses.npz carry the eigenvalue arrays; the
     torch path's steps/s at that shape;
 37. --profile on linear row 1 through K1: the Chrome trace names K1's
     kernel function once, and the artifacts equal phase 5's bitwise;
 38. --debug_nans: a NaN put into the state (--state_dict) raises
     FloatingPointError at step 0; a diverging run (lr 1e30) on K1 raises
     it at the first non-finite loss; a clean run equals phase 5 bitwise;
 39. the closed-form ELBO floor oracle of tests/test_convergence_oracles.py
     (20000 + 200 steps, its config and its three asserts) through K1, on
     the port's own dataset matrix A;
 40. the torch path's graph form (train/step.py GraphChunk) against its
     op-by-op chunk from the same state, 200 steps: sphere row 1 with
     --kernels torch, gaussian 512|512 and the grid's torch path at linear
     row 1 with --seed_grid 2,3,4 (losses, parameters and moments bitwise,
     or within tests/kernel_test_helpers.py's tolerances where cuBLAS picks
     another algorithm under capture; the phase says which held); wall ms a
     step, the CUDA-event span and the profiler's kernel time a step, and
     the busy share, for both forms; the CLI with --kernels torch, 300
     steps, equal to 150 steps and --resume bitwise; --debug_nans and
     -nojit op by op, the [kernels] line saying so; a capture that fails
     raises and runs nothing op by op;
 41. -ws through the CLI: linear row 1 on K1 and a sigmoid run (latent 7)
     on K2, each starting below its cold start, and --seed_grid 2,3,4 -ws
     on K6a, every row equal to its solo -ws K1 run bitwise;
 42. --track_correlation on linear row 1 through K1: losses.npz carries the
     whole-tree ratio and the per-parameter ones under the JAX package's
     names, all finite, and a run resumed from 1500 steps equals the
     uninterrupted run bitwise.
 43. the conv VAE's epoch chunk (train/step.py EpochChunk) at the bench's
     conv configuration (4096 synthetic 28x28x1 images from seed 0, batch
     128, 32|64, latent 16, lr 1e-3, eps -1, -tdv; full width): one epoch
     as one CUDA graph replay equal to the op-by-op epoch bitwise (32
     losses, every parameter and Adam moment);
 44. the main path: the CLI's main() with --dataset image at that
     configuration, 10 epochs (320 steps): the [kernels] line names the
     graph form, ten graph epochs and no kernel launch or op-by-op epoch,
     "Completed Epoch 9", args.json, losses.npz (320 losses + 11 evals)
     and model.pkl, the eval loss falling;
 45. 4 epochs, then --resume to 10, equal to phase 44 bitwise;
 46. times: the epoch chunk op by op, as one graph replay an epoch (the
     form EpochChunk keeps), and as one graph replay a step (the form it
     was measured against; equal bitwise): wall ms a step, the CUDA-event
     span, the profiler's kernel time and count a step, the busy share;
 47. the bench's --config conv in this process (one JSON line, the JAX
     bench's conv_step_flops, one graph epoch a chunk, within 25% of phase
     46's graph figure) and vae-sample-torch on phase 44's run (shapes,
     finite, a model.pkl-only copy giving the checkpoint's samples
     bitwise);
 48. the synthetic corpus written to an .npz and one epoch through the CLI
     from it, equal to phase 44's first epoch bitwise.
 49. a one-rank process group (gloo for host objects; the dp path makes
     its NCCL group on the card): --mesh dp=1 through the CLI at sphere
     row 1 (1000 steps) and at the conv configuration (2 epochs): the
     [kernels] line names the dp form, one CUDA graph replay a step (an
     epoch) with the all-reduces captured, no kernel launch, and
     losses.npz, model.pkl and the checkpoint's params, m and v equal the
     no-mesh torch path's bitwise;
 50. two processes sharing the card, each a rank of a gloo group of two
     (LOCAL_RANK 0): --seed_grid 2,3,4,5 --mesh dp=2 --multihost at linear
     row 1 through K6a (2000 steps), each rank launching over its own 2
     rows and printing only them, with its [pK] prefix; then
     vae-sweep-torch sphere --grouped --mesh dp=2 through K6b (200 steps;
     15 rows padded to 16, 8 a rank); every row equal to the one-process
     run's bitwise; the processes load the kernels phase 2 built;
 51. times, with the card's name and power limit: the dp=1 step over NCCL
     against the no-mesh graph step at sphere row 1 (wall, CUDA-event and
     profiler kernel time, in turns), the world-size-1 all-reduce of a
     step's gradients (device time in a CUDA graph and op by op), and K6a's
     launch-step a rank over the linear sweep's rows sharded over two
     processes on the card, beside phase 17's one-process figure;
 52. InvertibleBatchNorm with a one-rank NCCL group equal to it without a
     group on the card: outputs, gradients and running stats bitwise.

 53. bf16 dots, the linear kernel: K1 at linear row 1 and K2 at sigmoid
     row 1, 32 steps one at a time from the bf16 plain version's state
     (external noise and the in-kernel sampler, -tdv on and off); each
     step launched in both dot modes, the kernel and the plain version.
     ρ = ‖kernel − plain_bf16‖ / ‖plain_fp32 − plain_bf16‖ over the steps'
     losses and over each step's m and v must be ≤ 0.1 for the bf16-dot
     kernel and ≥ 0.5 for the fp32 one (the control). K6a the same on the
     linear (21) and sigmoid (18) sweeps, 16 steps; every K6a row equal to
     its solo launch bitwise (64 steps) and 40 = 15 + 25 bitwise, with f32
     and bf16 moments;
 54. bf16 dots, the MLP kernel (tensor-core sums): K5 at sphere row 1
     and a linear_gaussian 64|64 MLP with observation noise, K5-dual at
     sigmoid-MLP row 1 (32 steps one at a time, ρ as in phase 53), K5 and
     K5-dual at the narrow and ragged 7|13|200 stacks (16 steps:
     contractions that are no multiple of 16, narrow units) and K5 at three
     8-layer stacks that put the bias row of [a_in, 1]ᵀ·G at every row of
     a 32-row and of a 16-row unit (16 steps), K6b on the sphere sweep's 15
     rows and 3 sigmoid-MLP rows (16 steps); 40 = 15 + 25, clusters of 8 =
     16 (16 steps) and every K6b row = its solo K5 launch (32 steps), all
     bitwise;
 55. bf16 dots on the torch path: sphere row 1's CUDA graph step = op by
     op bitwise over 200 steps, the conv epoch's graph = op by op bitwise;
     the fp32 path parts from it (phases 40 and 45 hold --resume in the
     CLI's default bf16);
 56. times, fp32 dots against bf16 dots in turn: µs a step of K1, K2, K5,
     K5-dual, of their plain versions, µs a launch-step of K6a (both
     sweeps) and K6b and of their plain versions, K4 in K5, K5-dual, K6b,
     K1, K2 and K6a (both sweeps) under bf16 dots (f32 against bf16
     moments, in turn), the torch path's graph
     step at sphere row 1 and the conv step; the bench's line for linear,
     sigmoid, sphere, grid_linear, grid_sigmoid, grid_sphere and conv under
     each --precision (the [kernels] line naming the dot mode); the bf16-dot
     records of the kernels' JSON line, bound by the dense bf16 peak;
 57. the CLI's linear, sigmoid and sphere rows 1 at 12000 steps under
     --precision fp32 (the [kernels] line without bf16 dots), their eval
     loss and padding norm beside phases 5's and 11's bf16 runs; both
     modes' must fall.

 58. supervised rows: vae-sweep-torch linear --isolate --shard 0/11 (2 runs,
     12000 steps, each in a process of its own whose [kernels] line names
     K1; the supervising process launches nothing) equal to the same runs
     in process (losses.npz, model.pkl and the checkpoint, bitwise); then
     sphere row 1 (K5) --isolate --num_batches 60000 --checkpoint_every
     10000, once uninterrupted (its wall time and the times its
     checkpoints land), once with --retries 1 and --row_timeout T =
     (wall + start-up + checkpoint interval) / 2 + 1.5 s, the least a retry
     can meet with a margin (half the wall time leaves a retry, which pays
     the start-up again, too little), short of the wall time by more than
     an interval: attempt 1 must end in "run exceeded", attempt 2 carry
     --resume <run dir> without -ow and resume from a step > 0 with the
     run's history (the newest save whose state, aux and meta are all on
     disk), and the final losses.npz, model.pkl and checkpoint equal the
     uninterrupted run's bitwise;
 59. --ckpt_backend orbax on K1 at linear row 1: 15000 steps, then
     --resume to 40000, equal to 40000 steps uninterrupted bitwise
     (losses.npz, model.pkl, the DCP state; the run holds a dcp_ckpt/
     directory and no ckpt.pt), with f32 and with bf16 moments; a run
     saved with the default backend at 15000 resumes under orbax to 40000,
     equal to the same.

Phase 29 also runs the T2 tool's check_kernel_divergence (sphere and
linear through the bench's trainers, 50 steps each way: the first losses
of --precision bf16 and fp32 differ).

``python3 chip_smoke.py --only-parallel`` runs phases 1, 2 and 49-52 alone,
``--only-supervision`` phases 1, 2, 58 and 59, ``--only-probes`` phases 1,
2 and 26-30,
``--only-bf16-dots`` phases 1, 2, 31, 32 and 53-57 (with the MLP library's
ptxas lines; phase 57 then runs the bf16 rows too) and
check_kernel_divergence: the quick card check of the bf16-dot modes.

Imports no JAX. Every check raises on failure, so any failed phase exits
nonzero. The last two stdout lines are JSON: the kernels' record, then
{"ok": true, "device": {...}}. A training kernel's record names the dot
mode it was timed in ("dots"); the bf16-dot records carry the fp32 figures
of the same calls beside theirs, and every record's launches are the
wrapper's count on the main path, which runs the CLI's default bf16 dots.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROW1 = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "",
        "--layer_sizes", "", "-ow", "--latent_dim", "20", "--padding_dim", "9",
        "-dd", "3", "--epsilon", "-1", "-tdv", "-ds", "2", "-lr", "1e-3"]
B, D, L, ID = 100, 12, 20, 3  # the slice's shapes: batch, ambient, latent, intrinsic
# tests/test_pallas_kernel.py's tolerances (fp32 on both sides)
TOL = {"losses": (2e-4, 2e-4), "params": (5e-4, 5e-5), "m": (5e-4, 1e-6),
       "v": (5e-4, 1e-7)}
# bench.py CONFIGS["sigmoid"] / ["sphere"], default dataset seed 69
SIGMOID_ROW1 = ["--dataset", "sigmoid", "--encoder_layer_sizes", "", "--layer_sizes", "",
                "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3",
                "--epsilon", "-3", "-tdv", "-lr", "1e-4"]
SPHERE_ROW1 = ["--dataset", "sphere", "--encoder_layer_sizes", "200|200|200",
               "--layer_sizes", "200|200|200", "-ow", "--latent_dim", "6",
               "--padding_dim", "3", "-dd", "3", "--epsilon", "-3", "-tdv", "-lr", "1e-4"]
SIG_D, SIG_L, SIG_DD = 7, 6, 3  # sigmoid row 1: ambient 3 + 1 + 3, latent 6
SPH_D, SPH_L, SPH_DD = 6, 6, 3  # sphere row 1: ambient 3 + 3, latent 6
SPH_ENC, SPH_DEC = (6, 200, 200, 200, 6), (6, 200, 200, 200, 6)
# (encoder widths, decoder widths) whose layers' g_W products hold the bias
# row of [a_in, 1]ᵀ·G at every row of a unit in the bf16-dot plan: rows 0-7,
# 30 and 8-14 of a 32-row unit; 15-22, 31 and 23-29; every row of a
# 16-row one (tests/test_torch_mlp_tc.py:BIAS_ROW_STACKS, which checks it)
BIAS_ROW_STACKS = (((32, 33, 34, 35, 36, 37, 38, 39, 30), (30, 40, 41, 42, 43, 44, 45, 46, 32)),
                   ((47, 48, 49, 50, 51, 52, 53, 54, 31), (31, 55, 56, 57, 58, 59, 60, 61, 47)),
                   ((8, 1, 2, 3, 4, 5, 6, 7, 9), (9, 10, 11, 12, 13, 14, 15, 16, 8)))
# sigmoid row 1 with the sphere sweep's 200|200|200 stacks: the MLP kernel's
# dual-decoder branch (K5-dual); no reference script runs it
SIGMOID_MLP_ROW1 = [a if a != "" else "200|200|200" for a in SIGMOID_ROW1]
# tests/test_mlp_kernel.py's tolerances: fp32 on both sides, but the
# 200-wide stacks sum 200 terms per output in another order than cuBLAS,
# and four layers each way compound the rounding, so the MLP kernel's
# tolerances are twice the linear kernel's
MLP_TOL = {"losses": (3e-4, 3e-4), "params": (1e-3, 1e-5), "m": (1e-3, 1e-6),
           "v": (1e-3, 1e-9)}
# the bench's conv configuration (_scripts/bench.py build_conv, BASELINE.json
# config 5) as CLI flags: 4096 synthetic 28x28x1 images from seed 0, batch 128
CONV = ["--dataset", "image", "--num_images", "4096", "--image_size", "28", "--batch_size",
        "128", "--latent_dim", "16", "--conv_channels", "32|64", "-lr", "1e-3", "--epsilon",
        "-1", "-tdv", "-ow", "-ds", "0"]
CONV_NB = 4096 // 128  # steps an epoch
FP32_PEAK = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet, 700 W)
TF32_PEAK = 495e12  # dense TF32 on the tensor cores
BF16_PEAK = 989e12  # dense bf16 on the tensor cores
HBM_RATE = 3.35e12  # H100 SXM bytes/s


# the bench's --precision fp32 lines of phases 33 and 47, for phase 56
_BENCH_FP32: dict = {}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


_T0 = time.perf_counter()


def phase(n: int, title: str) -> None:
    print(f"\n== phase {n}: {title} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.data import LinearGaussianDataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels._build import load_library
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState, step as torch_step

    # --- 1 ---------------------------------------------------------------
    phase(1, "device")
    dev = torch.device("cuda")
    cap = torch.cuda.get_device_capability(dev)
    require(tuple(cap) == (9, 0), f"compute capability 9.0 (got {cap})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 2 ---------------------------------------------------------------
    phase(2, "build")
    t0 = time.perf_counter()
    libraries = ("linear_vae", "mlp_vae", "probes")
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, started together
        builds = dict(zip(libraries, pool.map(load_library, libraries)))
    for name, (_, record) in builds.items():
        print(f"{name}: built={record['built']} in {record['seconds']:.2f} s: {record['path']}")
    print(f"all three libraries loaded after {time.perf_counter() - t0:.2f} s")
    _print_ptxas(builds["linear_vae"][1])
    _print_ptxas(builds["probes"][1])
    need = k1.smem_bytes(B, D, L, ID, ID)
    need_bf16 = k1.smem_bytes(B, D, L, ID, ID, bf16_dots=True)
    require(k1.kernel_smem_bytes(B, D, L, ID, ID) == need
            and k1.kernel_smem_bytes(B, D, L, ID, ID, bf16_dots=True) == need_bf16,
            "shared-memory layout of the library equals kernels/linear_vae.py's, both dot modes")
    print(f"shared memory per launch at the slice's shapes: {need} B (bf16 dots: {need_bf16} B)")
    if sys.argv[1:] == ["--only-parallel"]:  # phases 1, 2 and 49-52 alone, to develop them
        with tempfile.TemporaryDirectory() as tmp:
            _parallel(torch, np, smi, tmp, [])
        print(f"phases 1, 2 and 49-52 passed in {time.perf_counter() - _T0:.1f} s")
        return 0
    if sys.argv[1:] == ["--only-supervision"]:  # phases 1, 2, 58 and 59 alone
        with tempfile.TemporaryDirectory() as tmp:
            _supervision(torch, np, smi, tmp)
        print(f"phases 1, 2, 58 and 59 passed in {time.perf_counter() - _T0:.1f} s")
        return 0
    if sys.argv[1:] == ["--only-probes"]:  # phases 1, 2 and 26-30 alone
        recs = _probes(torch, np, smi)
        print(json.dumps({"kernels": recs}))
        print(f"phases 1, 2 and 26-30 passed in {time.perf_counter() - _T0:.1f} s")
        return 0
    if sys.argv[1:] == ["--only-bf16-dots"]:  # phases 1, 2, 31, 32 and 53-57 alone
        from vae_training_tpu_torch.tools import check_precision as t2

        _print_ptxas(builds["mlp_vae"][1])
        _mlp_split(torch, np, smi)
        _linear_split(torch, np, smi)
        with tempfile.TemporaryDirectory() as tmp:
            recs = []
            _bf16_dots(torch, np, smi, tmp, recs)
            t2.check_kernel_divergence(dev)
        print(json.dumps({"kernels": recs}))
        print(f"phases 1, 2, 31, 32 and 53-57 passed in {time.perf_counter() - _T0:.1f} s")
        return 0

    # --- 3 ---------------------------------------------------------------
    phase(3, "sampler: in-kernel Philox vs ops/rng.py")
    for seed, step, stream in ((0, 0, 0), (2**64 - 1, 4_000_000_000, 3),
                               (rng.derive_seed(2, 1), 11999, 1), (12345, 77, 2)):
        words, normals = k1.sampler_check(100, 6, step, stream, seed, dev)
        ref = rng.words(seed, step, 100, stream, 6)
        require(torch.equal(rng.widen(words.cpu()), ref),
                f"words bitwise at {(seed, step, stream)}")
        err = (normals.cpu() - rng.box_muller(ref)).abs().max().item()
        require(err <= 1e-5, f"normals |Δ| {err} <= 1e-5 at {(seed, step, stream)}")
        require(torch.equal(k1.sampler_normals(100, 6, step, stream, seed, dev), normals),
                f"the normals-only draw equals the words entry's bitwise at {(seed, step, stream)}")
    print("words bitwise equal; normals within 1e-5; the normals-only draw's bitwise the "
          "words entry's")
    _, big = k1.sampler_check(65536, 16, 5, 0, 987654321, dev)  # 4M normals
    big = big.reshape(-1, 4).double()
    mean, std = big.mean().item(), big.std().item()
    rho = max(abs(torch.corrcoef(big[:, [a, b]].T)[0, 1].item()) for a, b in ((0, 1), (2, 3)))
    print(f"4M kernel normals: mean {mean:.2e}, std-1 {std - 1:.2e}, partner |rho| {rho:.2e}")
    require(abs(mean) < 3e-3 and abs(std - 1) < 3e-3 and rho < 3e-3, "normal moments")

    # --- 4 ---------------------------------------------------------------
    phase(4, "kernel vs plain PyTorch version on the card (64 steps)")
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=dev)
    data_seed, model_seed = rng.derive_seed(2, rng.SEED_TRAIN_DATA), rng.derive_seed(0, rng.SEED_TRAIN_Z)

    def flat_state(tdv):
        model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=tdv)
        model.init_parameters(0)
        return k1.pack_state(TrainState.create(dict(model.named_parameters()), 0, 0).to(dev), D, L)

    def chunk(fn, bufs, n, step0, tdv, noise=None, var_added=0.0):
        return fn(*bufs, ds.A, n_steps=n, batch=B, data_dim=D, latent_dim=L,
                  intrinsic_dim=ID, manifold_dim=ID, step0=step0, t0=step0,
                  data_seed=data_seed, model_seed=model_seed, var_added=var_added,
                  eps_const=-1.0, tdv=tdv, lr=1e-3, external_noise=noise)

    max_err = 0.0
    n = 64
    rs = np.random.RandomState(0)
    xs = np.zeros((n, B, D), np.float32)
    xs[:, :, :3] = rs.randn(n, B, 3).astype(np.float32) @ ds.A.cpu().numpy().T
    ext = tuple(torch.as_tensor(a, device=dev) for a in (
        xs, rs.randn(n, B, L).astype(np.float32), rs.randn(n, B, D).astype(np.float32)))
    for tdv in (True, False):
        for mode, noise, var_added in (("external", ext, 0.0), ("sampler", None, 0.0),
                                       ("sampler+obs", None, 0.25)):
            kb = flat_state(tdv)
            pb = tuple(t.clone() for t in kb)
            kl = chunk(k1.run_fused_chunk, kb, n, 0, tdv, noise, var_added)
            pl = chunk(k1.plain_fused_chunk, pb, n, 0, tdv, noise, var_added)
            torch.cuda.synchronize()
            errs = []
            for name, a, b in (("losses", kl, pl), ("params", kb[0], pb[0]),
                               ("m", kb[1], pb[1]), ("v", kb[2], pb[2])):
                a, b = a.cpu().numpy(), b.cpu().numpy()
                require(bool(np.all(np.isfinite(a))), f"{name} finite")
                np.testing.assert_allclose(a, b, *TOL[name],
                                           err_msg=f"{name} tdv={tdv} {mode}")
                errs.append(float(np.abs(a - b).max()))
            max_err = max(max_err, *errs)
            print(f"tdv={tdv!s:5} {mode:11}: max |Δ| losses {errs[0]:.2e} params "
                  f"{errs[1]:.2e} m {errs[2]:.2e} v {errs[3]:.2e}")
    a = flat_state(True)
    b = tuple(t.clone() for t in a)
    la = chunk(k1.run_fused_chunk, a, 40, 0, True)
    lb = torch.cat([chunk(k1.run_fused_chunk, b, 15, 0, True),
                    chunk(k1.run_fused_chunk, b, 25, 15, True)])
    torch.cuda.synchronize()
    require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
            "a 40-step launch equals a 15 + 25 split bitwise")
    print("chunk split 40 = 15 + 25: bitwise equal")

    # --- 5 ---------------------------------------------------------------
    phase(5, "main path: the CLI, 12000 steps, --kernels cuda --device cuda")
    tmp = tempfile.TemporaryDirectory()
    data_dir = tmp.name

    def cli(name, num_batches, *extra):
        cfg = parse_arguments([name, *ROW1, "--num_batches", str(num_batches),
                               "--kernels", "cuda", "--device", "cuda",
                               "--data_dir", data_dir, *extra])
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t

    k1.run_fused_chunk.launches = 0
    _torch_chunks(torch_step, reset=True)
    rc, out, secs = cli("main", 12000)
    launches, plain_calls = k1.run_fused_chunk.launches, _torch_chunks(torch_step)
    batch_lines = [ln for ln in out.splitlines() if ln.startswith(("Batch |", "[kernels]", "Score"))]
    print("\n".join(batch_lines))
    print(f"main path: rc {rc}, {secs:.2f} s, K1 launches {launches}, "
          f"plain-path chunks {plain_calls}")
    require(rc == 0, "main() returned 0")
    require(launches > 0, "K1 launched on the main path")
    require(plain_calls == 0, "the plain path did not run on the main path")
    run_dir = os.path.join(data_dir, "main")
    for f in ("args.json", "losses.npz", "model.pkl", "ckpt.pt", "ckpt_meta.json"):
        require(os.path.exists(os.path.join(run_dir, f)), f"artifact {f}")
    evals = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^Batch \| (\d+) \| VAE Loss \| (-?[\d.]+)", out, re.M)}
    z = np.load(os.path.join(run_dir, "losses.npz"))
    pad = z["Squared Norm of padding dimensions"]
    require(sorted(evals) == [0, 5000, 10000], f"eval lines at 0/5000/10000 ({sorted(evals)})")
    require(evals[10000] < evals[0], "eval VAE Loss lower at 10000 than at 0")
    require(pad[2] < pad[0], "padding norm lower at 10000 than at 0")
    require(bool(np.all(np.isfinite(z["VAE Loss"]))) and z["VAE Loss"].shape == (12003,),
            "finite per-step loss trace of 12000 steps + 3 evals")
    print(f"eval VAE Loss {evals[0]:.3f} -> {evals[10000]:.3f}; padding norm "
          f"{pad[0]:.4f} -> {pad[2]:.6f}")

    # --- 6 ---------------------------------------------------------------
    phase(6, "resume: 7000 steps, then --resume to 12000")
    rc1, _, _ = cli("part", 7000)
    rc2, _, _ = cli("resumed", 12000, "--resume", os.path.join(data_dir, "part"))
    require(rc1 == 0 and rc2 == 0, "both runs returned 0")
    za = np.load(os.path.join(run_dir, "losses.npz"))
    zb = np.load(os.path.join(data_dir, "resumed", "losses.npz"))
    require(set(za.files) == set(zb.files), "same npz channels")
    for k in za.files:
        require(np.array_equal(za[k], zb[k]), f"losses.npz {k!r} bitwise equal")
    with open(os.path.join(run_dir, "model.pkl"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(data_dir, "resumed", "model.pkl"), "rb") as f:
        pb = pickle.load(f)
    for name in pa["target"]:
        for x, y in zip(_leaves(pa["target"][name]), _leaves(pb["target"][name])):
            require(np.array_equal(x, y), f"model.pkl {name} bitwise equal")
    print("losses.npz and model.pkl params equal the uninterrupted run bitwise")

    # --- 7 ---------------------------------------------------------------
    phase(7, "times at the slice's shapes (batch 100, D 12, L 20)")
    kb = flat_state(True)
    chunk_steps = 5000

    def kernel_call():
        chunk(k1.run_fused_chunk, kb, chunk_steps, 0, True)

    model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), data_seed, model_seed).to(dev)
    torch_steps = 100

    def torch_call():
        torch_step.train_chunk(model, ds, state, torch_steps, batch_size=B, lr=1e-3)

    rates = {}
    for name, fn, steps in (("plain", torch_call, torch_steps), ("kernel", kernel_call, chunk_steps),
                            ("kernel2", kernel_call, chunk_steps), ("plain2", torch_call, torch_steps)):
        rates[name] = _steps_per_second(torch, fn, steps)
    k_rate = max(rates["kernel"], rates["kernel2"])
    p_rate = max(rates["plain"], rates["plain2"])
    print(f"card: {smi}")
    print(f"K1 kernel:  {rates['kernel']:.1f} / {rates['kernel2']:.1f} steps/s "
          f"({1e3 / k_rate:.5f} ms/step, {chunk_steps}-step launches)")
    print(f"torch path: {rates['plain']:.1f} / {rates['plain2']:.1f} steps/s "
          f"({1e3 / p_rate:.5f} ms/step)")

    k1_record = {
        "name": "linear_vae_chunk (K1)", "route": "cuda",
        "source": "vae_training_tpu_torch/csrc/linear_vae.cu",
        "replaces": "vae_training_tpu/kernels/linear_vae.py:678",
        "launches": launches, "max_abs_err": max_err,
        "ms": 1e3 / k_rate, "plain_ms": 1e3 / p_rate,
        **_bound(linear_flops(B, D, L, ID, ID, False), 6 * 4 * k1.n_params(D, L), chunk_steps),
        "library_ms": None}

    sweeps_dir = os.path.join(data_dir, "sweeps")
    records = [k1_record] + _sweeps(torch, np, smi, builds["mlp_vae"][1], sweeps_dir)
    records += _grids(torch, np, smi, run_dir, data_dir)
    records += _mlp_grids(torch, np, smi, os.path.join(sweeps_dir, "main_K5"), data_dir)
    records += _bf16_moments(torch, np, smi, os.path.join(data_dir, "bf16"))
    records += _probes(torch, np, smi)
    _mlp_split(torch, np, smi)
    _linear_split(torch, np, smi)
    _surfaces(torch, np, smi, records, data_dir, run_dir, os.path.join(sweeps_dir, "main_K5"))
    _graph_and_library(torch, np, smi, data_dir, run_dir)
    _epochs(torch, np, smi, os.path.join(data_dir, "epochs"))
    _parallel(torch, np, smi, os.path.join(data_dir, "parallel"), records)
    _bf16_dots(torch, np, smi, os.path.join(data_dir, "bf16_dots"), records,
               {"linear": run_dir, "sigmoid": os.path.join(sweeps_dir, "main_K2"),
                "sphere": os.path.join(sweeps_dir, "main_K5")})
    _supervision(torch, np, smi, os.path.join(data_dir, "supervision"))
    for r in records:  # the dot mode each training kernel was held in
        if "(K" in r["name"]:
            r.setdefault("dots", "bf16" if r["name"].endswith("bf16 dots") else "fp32")
    tmp.cleanup()
    print(f"all phases passed in {time.perf_counter() - _T0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _sweeps(torch, np, smi, mlp_build, data_dir):
    """Phases 8–13: K2 on the sigmoid sweep's row 1 and K5 on the sphere
    sweep's row 1, the CLI runs writing under ``data_dir``. Returns their
    records for the kernels' JSON line."""
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.data import (
        LinearGaussianDataset,
        SigmoidDataset,
        SphereDataset,
    )
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import mlp_vae as k5
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState, step as torch_step

    dev = torch.device("cuda")
    data_seed, model_seed = rng.derive_seed(69, rng.SEED_TRAIN_DATA), rng.derive_seed(0, rng.SEED_TRAIN_Z)

    # --- 8 ---------------------------------------------------------------
    phase(8, "the MLP library (K5): registers, cluster plan, shared memory")
    _print_ptxas(mlp_build)
    shapes = [(f"sphere {dd}|{pd}|{ld}", (dd + pd, *SPH_ENC[1:-1], ld), (ld, *SPH_ENC[1:-1], dd + pd),
               False) for dd, pd, ld in ((3, 3, 6), (3, 13, 8), (5, 16, 16), (5, 5, 10), (7, 7, 13))]
    shapes += [("sigmoid-MLP row 1", (SIG_D, 200, 200, 200, SIG_L), (SIG_L, 200, 200, 200, SIG_D),
                True), ("linear_gaussian 64|64", (12, 64, 64, 20), (20, 64, 64, 12), False)]
    smem = {k5.CLUSTER: 0, k5.CLUSTER_WIDE: 0}
    smem_bf16 = dict(smem)  # the bf16-dot mode's plan (tensor-core sums)
    for label, enc, dec, dual in shapes:
        for dots in (False, True):
            for size in smem:
                need = k5.smem_bytes(B, enc, dec, dual, size, dots)
                require(k5.library_smem_bytes(B, enc, dec, dual, size, dots) == need,
                        f"{label}: the library's shared memory a CTA equals kernels/mlp_vae.py's "
                        f"(bf16 dots {dots})")
                require(0 < need <= k5.SMEM_MAX, f"{label}: {need} B a CTA fits {k5.SMEM_MAX} B")
                mode = smem_bf16 if dots else smem
                mode[size] = max(mode[size], need)
        print(f"{label}: " + ", ".join(f"{k5.smem_bytes(B, enc, dec, dual, size)} B" for size in smem)
              + " (bf16 dots: " + ", ".join(f"{k5.smem_bytes(B, enc, dec, dual, size, True)} B"
                                            for size in smem)
              + ") of shared memory a CTA on clusters of " + " and ".join(map(str, smem))
              + " (library and planner agree)")
    most = {size: k5.grid(1, smem, size)["max_clusters"] for size in smem}
    for n_rows in (1, 7, 15, 20):
        plan = k5.grid(n_rows, smem)
        turns = max(t for _, t in k5.cluster_plan(n_rows, plan["max_clusters"])) + 1
        print(f"MLP kernel's cluster plan at {n_rows} row(s): {plan['clusters']} clusters of "
              f"{plan['cluster_size']} CTAs x {k5.THREADS} threads ({plan['max_clusters']} fit "
              f"at once), {turns} row(s) a cluster in turn")
        require(plan["cluster_size"] == k5.cluster_size(n_rows, most),
                "the cluster size the planner picks for the rows")
        require(plan["clusters"] == min(n_rows, plan["max_clusters"]), "one cluster a row")
        plan_bf16 = k5.grid(n_rows, smem_bf16, bf16_dots=True)
        print(f"  bf16 dots: {plan_bf16['clusters']} clusters of {plan_bf16['cluster_size']} "
              f"CTAs ({plan_bf16['max_clusters']} fit at once)")
        require(plan_bf16["clusters"] == min(n_rows, plan_bf16["max_clusters"]),
                "one cluster a row, bf16 dots")

    # --- 9 ---------------------------------------------------------------
    phase(9, "K2 vs its plain PyTorch version at sigmoid row 1 (64 steps)")
    sig = SigmoidDataset.create(69, SIG_DD, 3, device=dev)
    require(k1.kernel_smem_bytes(B, SIG_D, SIG_L, SIG_DD, SIG_DD, True)
            == k1.smem_bytes(B, SIG_D, SIG_L, SIG_DD, SIG_DD, True),
            "K2's shared-memory layout of the library equals kernels/linear_vae.py's")

    def k2_state(tdv):
        model = build_vae(data_dim=SIG_D, latent_dim=SIG_L, epsilon=-3.0,
                          tunable_decoder_var=tdv, dataset_name="sigmoid")
        model.init_parameters(0)
        return k1.pack_state(TrainState.create(dict(model.named_parameters()), 0, 0).to(dev),
                             SIG_D, SIG_L, dual=True)

    def k2_chunk(fn, bufs, n, step0, tdv, noise=None):
        return fn(*bufs, sig.A, n_steps=n, batch=B, data_dim=SIG_D, latent_dim=SIG_L,
                  intrinsic_dim=SIG_DD, manifold_dim=SIG_DD, step0=step0, t0=step0,
                  data_seed=data_seed, model_seed=model_seed, var_added=0.0, eps_const=-3.0,
                  tdv=tdv, lr=1e-4, external_noise=noise, dual=True)

    n = 64
    rs = np.random.RandomState(1)
    z = rs.randn(n, B, SIG_DD).astype(np.float32)
    xs = np.concatenate([z, 1 / (1 + np.exp(-(z @ sig.A.cpu().numpy()))),
                         np.zeros((n, B, SIG_D - SIG_DD - 1), np.float32)], axis=-1)
    ext = tuple(torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        xs, rs.randn(n, B, SIG_L), rs.randn(n, B, SIG_D)))
    k2_err = _parity(torch, np, "K2", TOL, k2_state, k1.run_fused_chunk, k1.plain_fused_chunk,
                     k2_chunk, n, ext)
    _split(torch, "K2", k2_state, k1.run_fused_chunk, k2_chunk)

    # --- 10 --------------------------------------------------------------
    phase(10, "K5 vs its plain PyTorch version at sphere row 1, full width (64 steps)")
    print(f"tolerances {MLP_TOL} (rtol, atol): tests/test_mlp_kernel.py's; 200-term "
          "sums in another order than cuBLAS's, compounded through 4 + 4 layers")

    def k5_state(tdv, enc=SPH_ENC, dec=SPH_DEC):
        model = build_vae(data_dim=enc[0], latent_dim=enc[-1],
                          encoder_layer_sizes="|".join(map(str, enc[1:-1])),
                          decoder_layer_sizes="|".join(map(str, dec[1:-1])),
                          epsilon=-3.0, tunable_decoder_var=tdv)
        model.init_parameters(0)
        return k5.pack_state(TrainState.create(dict(model.named_parameters()), 0, 0).to(dev),
                             enc, dec)

    def k5_chunk(fn, bufs, n, step0, tdv, noise=None):
        return fn(*bufs, None, n_steps=n, batch=B, enc_widths=SPH_ENC, dec_widths=SPH_DEC,
                  kind="sphere", intrinsic_dim=SPH_DD, manifold_dim=SPH_DD, step0=step0,
                  t0=step0, data_seed=data_seed, model_seed=model_seed, var_added=0.0,
                  eps_const=-3.0, tdv=tdv, lr=1e-4, external_noise=noise)

    g = rs.randn(n, B, SPH_DD).astype(np.float32)
    xs = np.concatenate([g / np.linalg.norm(g, axis=-1, keepdims=True),
                         np.zeros((n, B, SPH_D - SPH_DD), np.float32)], axis=-1)
    ext = tuple(torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        xs, rs.randn(n, B, SPH_L), rs.randn(n, B, SPH_D)))
    k5_err = _parity(torch, np, "K5", MLP_TOL, k5_state, k5.run_mlp_fused_chunk,
                     k5.plain_mlp_fused_chunk, k5_chunk, n, ext)
    lin = LinearGaussianDataset.create(2, 3, 3, 9, device=dev)
    lin_enc, lin_dec = (12, 64, 64, 20), (20, 64, 64, 12)

    def k5_linear(fn, bufs, n, step0, tdv, noise=None):
        return fn(*bufs, lin.A, n_steps=n, batch=B, enc_widths=lin_enc, dec_widths=lin_dec,
                  kind="linear", intrinsic_dim=3, manifold_dim=3, step0=step0, t0=step0,
                  data_seed=data_seed, model_seed=model_seed, var_added=0.25, eps_const=-1.0,
                  tdv=tdv, lr=1e-3, external_noise=noise)

    k5_err = max(k5_err, _parity(
        torch, np, "K5 linear_gaussian 64|64 +obs", MLP_TOL,
        lambda tdv: k5_state(tdv, lin_enc, lin_dec), k5.run_mlp_fused_chunk,
        k5.plain_mlp_fused_chunk, k5_linear, n, None, tdvs=(True,)))
    _split(torch, "K5", k5_state, k5.run_mlp_fused_chunk, k5_chunk)

    # --- 11 --------------------------------------------------------------
    phase(11, "main paths: the CLI's sigmoid row 1 (K2) and sphere row 1 (K5), 12000 steps")

    def cli(row, name, num_batches, *extra):
        cfg = parse_arguments([name, *row, "--num_batches", str(num_batches),
                               "--kernels", "cuda", "--device", "cuda",
                               "--data_dir", data_dir, *extra])
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t

    launches = {}
    for label, row, counter, keys in (
            ("K2", SIGMOID_ROW1, k1.run_fused_chunk,
             ("Squared Norm of Padding Dimensions", "Squared Norm of Manifold Dimension")),
            ("K5", SPHERE_ROW1, k5.run_mlp_fused_chunk, ("Sphere Error", "Padding Error"))):
        name = f"main_{label}"
        counter.launches = 0
        _torch_chunks(torch_step, reset=True)
        rc, out, secs = cli(row, name, 12000)
        launches[label], plain_calls = counter.launches, _torch_chunks(torch_step)
        print("\n".join(ln for ln in out.splitlines()
                        if ln.startswith(("Batch |", "[kernels]", "Score"))))
        print(f"{label} main path: rc {rc}, {secs:.2f} s, {label} launches {launches[label]}, "
              f"plain-path chunks {plain_calls}")
        require(rc == 0, f"{label}: main() returned 0")
        require(f"kernel {label} (" in out, f"the [kernels] line names {label}")
        require(launches[label] > 0, f"{label} launched on its main path")
        require(plain_calls == 0, f"the plain path did not run on {label}'s main path")
        run_dir = os.path.join(data_dir, name)
        for f in ("args.json", "losses.npz", "model.pkl", "ckpt.pt", "ckpt_meta.json"):
            require(os.path.exists(os.path.join(run_dir, f)), f"{label}: artifact {f}")
        evals = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
            r"^Batch \| (\d+) \| VAE Loss \| (-?[\d.]+)", out, re.M)}
        require(sorted(evals) == [0, 5000, 10000], f"{label}: eval lines at 0/5000/10000")
        require(evals[10000] < evals[0], f"{label}: eval VAE Loss lower at 10000 than at 0")
        z = np.load(os.path.join(run_dir, "losses.npz"))
        require(bool(np.all(np.isfinite(z["VAE Loss"]))) and z["VAE Loss"].shape == (12003,),
                f"{label}: finite per-step loss trace of 12000 steps + 3 evals")
        print(f"{label}: eval VAE Loss {evals[0]:.3f} -> {evals[10000]:.3f}; " + "; ".join(
            f"{k} {z[k][0]:.4f} -> {z[k][2]:.4f}" for k in keys))

    # --- 12 --------------------------------------------------------------
    phase(12, "sphere resume: 7000 steps, then --resume to 12000")
    rc1, _, _ = cli(SPHERE_ROW1, "part", 7000)
    rc2, _, _ = cli(SPHERE_ROW1, "resumed", 12000, "--resume", os.path.join(data_dir, "part"))
    require(rc1 == 0 and rc2 == 0, "both runs returned 0")
    _require_same_run(np, os.path.join(data_dir, "main_K5"), os.path.join(data_dir, "resumed"))
    print("losses.npz and model.pkl params equal the uninterrupted run bitwise")

    # --- 13 --------------------------------------------------------------
    phase(13, "times: K2 at sigmoid row 1, K5 at sphere row 1, against the torch path")
    sig_model = build_vae(data_dim=SIG_D, latent_dim=SIG_L, epsilon=-3.0,
                          tunable_decoder_var=True, dataset_name="sigmoid")
    sph_model = build_vae(data_dim=SPH_D, latent_dim=SPH_L, encoder_layer_sizes="200|200|200",
                          decoder_layer_sizes="200|200|200", epsilon=-3.0,
                          tunable_decoder_var=True)
    sph = SphereDataset(SPH_DD, SPH_D - SPH_DD, device=dev)
    records = []
    for label, state_fn, chunk_fn, run_fn, model, ds, k_steps, p_steps, flops, n_p in (
            ("K2", k2_state, k2_chunk, k1.run_fused_chunk, sig_model, sig, 5000, 100,
             linear_flops(B, SIG_D, SIG_L, SIG_DD, SIG_DD, True),
             k1.n_params(SIG_D, SIG_L, True)),
            ("K5", k5_state, k5_chunk, k5.run_mlp_fused_chunk, sph_model, sph, 1000, 50,
             mlp_flops(B, SPH_ENC, SPH_DEC), k5.n_params(SPH_ENC, SPH_DEC))):
        kb = state_fn(True)
        model.init_parameters(0)
        state = TrainState.create(dict(model.named_parameters()), data_seed, model_seed).to(dev)

        def kernel_call():
            chunk_fn(run_fn, kb, k_steps, 0, True)

        def torch_call():
            torch_step.train_chunk(model, ds, state, p_steps, batch_size=B, lr=1e-4)

        rates = {}
        for name, fn, steps in (("plain", torch_call, p_steps), ("kernel", kernel_call, k_steps),
                                ("kernel2", kernel_call, k_steps), ("plain2", torch_call, p_steps)):
            rates[name] = _steps_per_second(torch, fn, steps)
        k_rate = max(rates["kernel"], rates["kernel2"])
        p_rate = max(rates["plain"], rates["plain2"])
        print(f"card: {smi}")
        print(f"{label} kernel: {rates['kernel']:.1f} / {rates['kernel2']:.1f} steps/s "
              f"({1e3 / k_rate:.5f} ms/step, {k_steps}-step launches)")
        print(f"torch path: {rates['plain']:.1f} / {rates['plain2']:.1f} steps/s "
              f"({1e3 / p_rate:.5f} ms/step)")
        bound = _bound(flops, 6 * 4 * n_p, k_steps)
        print(f"{label} bound {bound['bound_ms'] * 1e3:.4f} us/step ({bound['bound_by']}; "
              f"{flops / 1e6:.3f} MFLOP/step), kernel at {bound['bound_ms'] * k_rate / 10:.3f}% of it")
        if label == "K2":
            records.append({
                "name": "linear_vae_chunk dual (K2)", "route": "cuda",
                "source": "vae_training_tpu_torch/csrc/linear_vae.cu",
                "replaces": "vae_training_tpu/kernels/linear_vae.py:678",
                "launches": launches["K2"], "max_abs_err": k2_err})
        else:
            print(f"K5's products as 3xTF32 passes on the tensor cores (a mode this kernel does "
                  f"not have): {mlp_pass_ms(B, SPH_ENC, SPH_DEC) * 1e3:.4f} us/step")
            records.append({
                "name": "mlp_vae_chunk (K5)", "route": "cuda",
                "source": "vae_training_tpu_torch/csrc/mlp_vae.cu",
                "replaces": "vae_training_tpu/kernels/mlp_vae.py:644",
                "launches": launches["K5"], "max_abs_err": k5_err})
        records[-1].update({"ms": 1e3 / k_rate, "plain_ms": 1e3 / p_rate, **bound,
                            "library_ms": None})

    # K5's floor: the same 17 phases and cluster barriers a step at 8|8|8
    # widths, where the layers' work is ~1% of the sphere row's
    tiny = (6, 8, 8, 8, 6)
    kb = k5_state(True, tiny, tiny)
    rate = _steps_per_second(torch, lambda: k5.run_mlp_fused_chunk(
        *kb, None, n_steps=1000, batch=B, enc_widths=tiny, dec_widths=tiny, kind="sphere",
        intrinsic_dim=SPH_DD, manifold_dim=SPH_DD, step0=0, t0=0, data_seed=data_seed,
        model_seed=model_seed, var_added=0.0, eps_const=-3.0, tdv=True, lr=1e-4), 1000)
    print(f"K5 at 8|8|8 widths (the same 17 cluster barriers a step): {rate:.1f} steps/s "
          f"({1e3 / rate:.5f} ms/step)")
    return records


def _grids(torch, np, smi, solo_dir, data_dir):
    """Phases 14–17: K6a, the grid mode of the linear kernel, on the linear
    sweep's 21 rows (K1 rows) and the sigmoid sweep's 18 rows (K2 rows).
    ``solo_dir`` is phase 5's solo CLI run. Returns K6a's records."""
    from vae_training_tpu_torch._scripts import sweep
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.train import step as torch_step
    from vae_training_tpu_torch.train.grid import GridTrainer

    dev = torch.device("cuda")
    families = {}
    for which in ("linear", "sigmoid"):
        cfgs = list(sweep.sweep_configs(which, data_dir, 64, "cuda"))
        seeds = sweep.SWEEP_SEEDS[which]
        groups = {}
        for cfg in cfgs:
            groups.setdefault((cfg.dataset_dimension, cfg.padding_dim,
                               cfg.latent_dimension), cfg)
        grids = [GridTrainer(cfg, seeds, build_chunk=False) for cfg in groups.values()]
        rows = [(g.model, ds, st) for g in grids for ds, st in zip(g.datasets, g.states)]
        c0 = cfgs[0]
        families[which] = dict(
            rows=rows, dual=which == "sigmoid",
            kw=dict(batch=c0.batch_size, eps_const=c0.epsilon, tdv=True,
                    lr=c0.learning_rate))

    def grid_rows(rows):
        return [k1.GridRow(ds.dimension, model.latent_dim, ds.intrinsic_dim, ds.dim, ds.A,
                           st.step, st.count, st.data_seed, st.model_seed, ds.var_added)
                for model, ds, st in rows]

    # --- 14 --------------------------------------------------------------
    phase(14, "K6a vs solo K1/K2 launches on the card: the linear sweep's 21 rows and "
              "the sigmoid sweep's 18, 64 steps")
    errs = {}
    for which, fam in families.items():
        dual, kw, grows = fam["dual"], fam["kw"], grid_rows(fam["rows"])
        states = [st for _, _, st in fam["rows"]]
        need = max(k1.smem_bytes(B, r.data_dim, r.latent_dim, r.intrinsic_dim,
                                 r.manifold_dim, dual) for r in grows)
        require(need == max(k1.kernel_smem_bytes(B, r.data_dim, r.latent_dim, r.intrinsic_dim,
                                                 r.manifold_dim, dual) for r in grows),
                f"{which}: the library's shared-memory layout equals kernels/linear_vae.py's")
        print(f"{which}: {len(grows)} rows, up to {need} B of shared memory a block, "
              f"{k1.blocks_per_sm(need, dual)} block(s) of the kernel fit an SM")
        p, m, v = k1.pack_rows(states, grows, dual)
        losses = k1.run_grid_chunk(p, m, v, grows, n_steps=64, dual=dual, **kw)
        for i, (st, r) in enumerate(zip(states, grows)):
            sp, sm, sv = k1.pack_state(st, r.data_dim, r.latent_dim, dual)
            solo = k1.run_fused_chunk(
                sp, sm, sv, r.a, n_steps=64, data_dim=r.data_dim, latent_dim=r.latent_dim,
                intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
                t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed,
                var_added=r.var_added, dual=dual, **kw)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(losses[i]).all()), f"{which} row {i}: finite losses")
            require(torch.equal(losses[i], solo), f"{which} row {i}: losses equal the solo "
                                                  f"launch's bitwise")
            for name, got, want in zip("pmv", k1.row_views(p, m, v, grows, dual)[i],
                                       (sp, sm, sv)):
                require(torch.equal(got, want), f"{which} row {i}: {name} equals the solo "
                                                f"launch's bitwise")
        print(f"{which}: every row's losses, p, m and v equal its solo "
              f"{'K2' if dual else 'K1'} launch bitwise")

        # external noise: K6a against its plain version, K1's tolerances
        n = 32
        rs = np.random.RandomState(14)
        noise = []
        for r in grows:
            z = rs.randn(n, B, r.intrinsic_dim).astype(np.float32)
            a = r.a.cpu().numpy()
            if dual:
                x = np.concatenate([z, 1 / (1 + np.exp(-(z @ a))), np.zeros(
                    (n, B, r.data_dim - r.manifold_dim - 1), np.float32)], axis=-1)
            else:
                x = np.zeros((n, B, r.data_dim), np.float32)
                x[:, :, :r.manifold_dim] = z @ a.T
            noise.append(tuple(torch.as_tensor(t.astype(np.float32), device=dev) for t in (
                x, rs.randn(n, B, r.latent_dim), rs.randn(n, B, r.data_dim))))
        kb = k1.pack_rows(states, grows, dual)
        pb = tuple(t.clone() for t in kb)
        kl = k1.run_grid_chunk(*kb, grows, n_steps=n, dual=dual, external_noise=noise, **kw)
        pl = k1.plain_grid_chunk(*pb, grows, n_steps=n, dual=dual, external_noise=noise, **kw)
        torch.cuda.synchronize()
        worst = []
        for name, a, b in (("losses", kl, pl), ("params", kb[0], pb[0]), ("m", kb[1], pb[1]),
                           ("v", kb[2], pb[2])):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            require(bool(np.all(np.isfinite(a))), f"{which} {name} finite")
            np.testing.assert_allclose(a, b, *TOL[name], err_msg=f"K6a {which} {name}")
            worst.append(float(np.abs(a - b).max()))
        errs[which] = max(worst)
        print(f"{which} external noise, K6a vs plain_grid_chunk ({n} steps): max |Δ| losses "
              f"{worst[0]:.2e} params {worst[1]:.2e} m {worst[2]:.2e} v {worst[3]:.2e}")

        a = k1.pack_rows(states, grows, dual)
        b = tuple(t.clone() for t in a)
        la = k1.run_grid_chunk(*a, grows, n_steps=40, dual=dual, **kw)
        later = [dataclasses.replace(r, step0=r.step0 + 15, t0=r.t0 + 15) for r in grows]
        lb = torch.cat([k1.run_grid_chunk(*b, grows, n_steps=15, dual=dual, **kw),
                        k1.run_grid_chunk(*b, later, n_steps=25, dual=dual, **kw)], dim=1)
        torch.cuda.synchronize()
        require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
                f"K6a {which}: a 40-step launch equals a 15 + 25 split bitwise")
        print(f"{which}: K6a chunk split 40 = 15 + 25 bitwise equal")

    # --- 15 --------------------------------------------------------------
    phase(15, "--seed_grid 2,3,4 through the CLI at linear row 1, 12000 steps, "
              "--kernels cuda")
    counters = (k1.run_grid_chunk, k1.run_fused_chunk)
    for c in counters:
        c.launches = 0
    _torch_chunks(torch_step, reset=True)
    k1.plain_grid_chunk.calls = 0
    cfg = parse_arguments(["grid", *ROW1, "--num_batches", "12000", "--kernels", "cuda",
                           "--device", "cuda", "--data_dir", data_dir, "--seed_grid", "2,3,4"])
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = run_main(cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    out = buf.getvalue()
    grid_launches, solo_launches = (c.launches for c in counters)
    plain = _torch_chunks(torch_step) + k1.plain_grid_chunk.calls
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith(("[kernels]", "[seed 2]"))))
    print(f"seed grid: rc {rc}, {secs:.2f} s for 3 rows, K6a launches {grid_launches}, "
          f"solo K1 launches {solo_launches}, plain chunks {plain}")
    require(rc == 0, "the seed grid's main() returned 0")
    require("[kernels] cuda: K6a" in out, "the [kernels] line names K6a")
    # chunks 0-5000, 5000-10000, 10000-11999, 11999-12000: one launch each
    require(grid_launches == 4, f"one K6a launch a chunk (4 chunks, got {grid_launches})")
    require(solo_launches == 0 and plain == 0, "no solo K1 launch and no plain chunk")
    _require_same_run(np, solo_dir, os.path.join(data_dir, "grid_seed2"))
    print("row seed2's losses.npz and model.pkl equal phase 5's solo run bitwise")

    # --- 16 --------------------------------------------------------------
    phase(16, "the sweep runner, --grouped, on the card: linear (21 runs) and sigmoid "
              "(18 runs), 12000 steps")

    def run_sweep(which, sub, num_batches, *extra):
        for c in counters:
            c.launches = 0
        _torch_chunks(torch_step, reset=True)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = sweep.main([which, "--grouped", "--kernels", "cuda", "--num_batches",
                             str(num_batches), "--data_dir", os.path.join(data_dir, sub),
                             *extra])
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t, [c.launches for c in counters]

    sweep_launches = {}
    for which, rows in (("linear", 21), ("sigmoid", 18)):
        rc, out, secs, (grid_n, solo_n) = run_sweep(which, which, 12000)
        sweep_launches[which] = grid_n
        acct = [ln for ln in out.splitlines() if ln.startswith("[sweep]")]
        print("\n".join(ln for ln in out.splitlines() if ln.startswith("[kernels]")))
        print("\n".join(acct))
        print(f"{which} sweep: rc {rc}, {secs:.2f} s, K6a launches {grid_n}, solo launches "
              f"{solo_n}, plain chunks {_torch_chunks(torch_step)}")
        require(rc == 0, f"{which} sweep returned 0")
        require(f"[kernels] cuda: K6a, the grid mode of the fused linear-VAE kernel, {rows} "
                f"rows in one launch a chunk" in out, f"{which}: one launch over {rows} rows")
        require(grid_n == 4 and solo_n == 0 and _torch_chunks(torch_step) == 0,
                f"{which}: one K6a launch a chunk and nothing else")
        require(any("wall accounting: banners" in ln for ln in acct),
                f"{which}: the wall-accounting line")
        falling = 0
        for c in sweep.sweep_configs(which, data_dir, 12000, "cuda"):
            trace = np.load(os.path.join(data_dir, which, c.name, "losses.npz"))["VAE Loss"]
            require(bool(np.all(np.isfinite(trace))) and trace.shape == (12003,),
                    f"{c.name}: finite loss trace of 12000 steps + 3 evals")
            falling += bool(trace[-100:].mean() < trace[0])
        print(f"{which}: the last 100 steps' mean loss is below the step-0 eval's in "
              f"{falling} of {rows} runs")
        require(falling == rows, f"{which}: every run's loss falls")
    rc1, _, _, _ = run_sweep("linear", "linear_resumed", 7000)
    rc2, _, _, (grid_n, _) = run_sweep("linear", "linear_resumed", 12000, "--resume")
    require(rc1 == 0 and rc2 == 0 and grid_n > 0, "the stopped and resumed sweeps ran on K6a")
    for c in sweep.sweep_configs("linear", data_dir, 12000, "cuda"):
        _require_same_run(np, os.path.join(data_dir, "linear", c.name),
                          os.path.join(data_dir, "linear_resumed", c.name))
    print("linear sweep --resume from 7000 to 12000: all 21 runs equal the uninterrupted "
          "sweep bitwise")

    # --- 17 --------------------------------------------------------------
    phase(17, "times: K6a against sequential solo launches and its plain version")
    records = []
    for which, fam in families.items():
        dual, kw, grows = fam["dual"], fam["kw"], grid_rows(fam["rows"])
        states = [st for _, _, st in fam["rows"]]
        n_rows, steps = len(grows), 5000
        kb = k1.pack_rows(states, grows, dual)
        pb = tuple(t.clone() for t in kb)
        solo_bufs = [k1.pack_state(st, r.data_dim, r.latent_dim, dual)
                     for st, r in zip(states, grows)]

        def grid_call():
            k1.run_grid_chunk(*kb, grows, n_steps=steps, dual=dual, **kw)

        def solo_call():
            for bufs, r in zip(solo_bufs, grows):
                k1.run_fused_chunk(
                    *bufs, r.a, n_steps=steps, data_dim=r.data_dim, latent_dim=r.latent_dim,
                    intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim,
                    step0=r.step0, t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed,
                    var_added=r.var_added, dual=dual, **kw)

        def plain_call():
            k1.plain_grid_chunk(*pb, grows, n_steps=2, dual=dual, **kw)

        rates = {}
        for name, fn, n in (("plain", plain_call, 2), ("grid", grid_call, steps),
                            ("solo", solo_call, steps), ("solo2", solo_call, steps),
                            ("grid2", grid_call, steps), ("plain2", plain_call, 2)):
            rates[name] = _steps_per_second(torch, fn, n)  # launch-steps a second
        g_rate = max(rates["grid"], rates["grid2"])
        s_rate = max(rates["solo"], rates["solo2"])
        p_rate = max(rates["plain"], rates["plain2"])
        flops = sum(linear_flops(B, r.data_dim, r.latent_dim, r.intrinsic_dim, r.manifold_dim,
                                 dual) for r in grows)
        state_bytes = sum(6 * 4 * k1.n_params(r.data_dim, r.latent_dim, dual) for r in grows)
        bound = _bound(flops, state_bytes, steps, losses_per_step=n_rows)
        print(f"card: {smi}")
        print(f"K6a {which}, {n_rows} rows, {steps}-step launches: {rates['grid']:.1f} / "
              f"{rates['grid2']:.1f} launch-steps/s ({1e3 / g_rate:.5f} ms a launch-step, "
              f"{g_rate * n_rows:.1f} row-steps/s)")
        print(f"sequential solo {'K2' if dual else 'K1'} launches of the same rows: "
              f"{rates['solo'] * n_rows:.1f} / {rates['solo2'] * n_rows:.1f} row-steps/s "
              f"(K6a {g_rate / s_rate:.2f}x)")
        print(f"plain_grid_chunk: {rates['plain']:.3f} / {rates['plain2']:.3f} launch-steps/s "
              f"({1e3 / p_rate:.3f} ms a launch-step)")
        print(f"K6a {which} bound {bound['bound_ms'] * 1e3:.4f} us a launch-step "
              f"({bound['bound_by']}; {flops / 1e6:.3f} MFLOP), kernel at "
              f"{bound['bound_ms'] * g_rate / 10:.4f}% of it")
        records.append({
            "name": f"linear_vae_grid_chunk (K6a), {which} sweep, {n_rows} rows",
            "route": "cuda", "source": "vae_training_tpu_torch/csrc/linear_vae.cu",
            "replaces": "vae_training_tpu/kernels/linear_vae.py:678",
            "launches": sweep_launches[which], "max_abs_err": errs[which],
            "ms": 1e3 / g_rate, "plain_ms": 1e3 / p_rate, **bound, "library_ms": None})

    # rows against the launch-step time: do rows share SMs past one per SM?
    fam = families["linear"]
    base = grid_rows(fam["rows"])[0]
    state0 = fam["rows"][0][2]
    for n_rows in (1, 21, 132, 264):
        grows = [base] * n_rows
        bufs = k1.pack_rows([state0] * n_rows, grows)
        with _SmClock() as clock:
            rate = _steps_per_second(torch, lambda: k1.run_grid_chunk(
                *bufs, grows, n_steps=1000, **fam["kw"]), 1000)
        print(f"K6a with {n_rows:3d} copies of linear row 1: {1e3 / rate:.5f} ms a "
              f"launch-step ({rate * n_rows:.1f} row-steps/s); SM clock {clock}")
    return records


def _mlp_grids(torch, np, smi, solo_sphere_dir, data_dir):
    """Phases 18–21: K6b, the grid mode of the MLP kernel, on the sphere
    sweep's 15 rows (and on sigmoid-MLP rows with the dual decoder), and
    K5-dual at sigmoid row 1 with 200|200|200 stacks. ``solo_sphere_dir``
    is phase 11's solo CLI run of sphere row 1. Returns their records."""
    from vae_training_tpu_torch._scripts import sweep
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.data import SigmoidDataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import mlp_vae as k5
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState, step as torch_step
    from vae_training_tpu_torch.train.grid import GridTrainer

    dev = torch.device("cuda")
    hidden = (200, 200, 200)
    counters = (k5.run_grid_chunk, k5.run_mlp_fused_chunk, k1.run_grid_chunk,
                k1.run_fused_chunk, torch_step.train_chunk, torch_step.GraphChunk,
                k5.plain_grid_chunk, k1.plain_grid_chunk)

    def reset_counts():
        for c in counters:
            if hasattr(c, "launches"):
                c.launches = 0
            else:
                c.calls = 0

    def plain_chunks():
        return (_torch_chunks(torch_step) + k5.plain_grid_chunk.calls
                + k1.plain_grid_chunk.calls)

    def family(cfgs, seeds):
        groups = {}
        for cfg in cfgs:
            groups.setdefault((cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension), cfg)
        grids = [GridTrainer(cfg, seeds, build_chunk=False) for cfg in groups.values()]
        trip = [(g.model, ds, st) for g in grids for ds, st in zip(g.datasets, g.states)]
        kind = k5.dataset_kind(trip[0][1])
        rows = [k1.GridRow(ds.dimension, m.latent_dim, ds.intrinsic_dim, ds.dim,
                           None if kind == "sphere" else ds.A, st.step, st.count,
                           st.data_seed, st.model_seed, ds.var_added) for m, ds, st in trip]
        c0 = cfgs[0]
        return dict(states=[st for _, _, st in trip], rows=rows, dual=kind == "sigmoid",
                    kw=dict(batch=c0.batch_size, enc_hidden=hidden, dec_hidden=hidden,
                            kind=kind, eps_const=c0.epsilon, tdv=True,
                            lr=c0.learning_rate, dual=kind == "sigmoid"))

    sig_cfg = parse_arguments(["dual", *SIGMOID_MLP_ROW1, "--num_batches", "64",
                               "--kernels", "cuda", "--device", "cuda", "--data_dir", data_dir])
    families = {"sphere": family(list(sweep.sweep_configs("sphere", data_dir, 64, "cuda")),
                                 sweep.SWEEP_SEEDS["sphere"]),
                "sigmoid-MLP": family([sig_cfg], [69, 24, 48])}

    def solo(fam, i, bufs, n):
        r, kw = fam["rows"][i], fam["kw"]
        enc, dec = k5.row_widths(r, hidden, hidden)
        return k5.run_mlp_fused_chunk(
            *bufs, r.a, n_steps=n, batch=kw["batch"], enc_widths=enc, dec_widths=dec,
            kind=kw["kind"], intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim,
            step0=r.step0, t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed,
            var_added=r.var_added, eps_const=kw["eps_const"], tdv=True, lr=kw["lr"],
            dual=fam["dual"])

    # --- 18 --------------------------------------------------------------
    phase(18, "K6b vs solo K5 launches on the card: the sphere sweep's 15 rows and 3 "
              "sigmoid-MLP dual rows, full width")
    errs = {}
    for which, fam in families.items():
        rows, dual, kw, states = fam["rows"], fam["dual"], fam["kw"], fam["states"]
        print(f"{which}: {len(rows)} rows, (D, L) {sorted({(r.data_dim, r.latent_dim) for r in rows})}, "
              f"up to {max(k5.row_offsets([r], hidden, hidden, dual)[-1] for r in rows)} "
              f"parameters a row")
        p, m, v = k5.pack_rows(states, rows, hidden, hidden, dual)
        losses = k5.run_grid_chunk(p, m, v, rows, n_steps=64, **kw)
        views = k5.row_views(p, m, v, rows, hidden, hidden, dual)
        for i, st in enumerate(states):
            bufs = k5.pack_state(st, *k5.row_widths(rows[i], hidden, hidden), dual)
            want = solo(fam, i, bufs, 64)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(losses[i]).all()), f"{which} row {i}: finite losses")
            require(torch.equal(losses[i], want), f"{which} row {i}: losses equal the solo "
                                                  f"launch's bitwise")
            for name, got, ref in zip("pmv", views[i], bufs):
                require(torch.equal(got, ref), f"{which} row {i}: {name} equals the solo "
                                               f"launch's bitwise")
        print(f"{which}: every row's losses, p, m and v equal its solo "
              f"K5{'-dual' if dual else ''} launch bitwise (64 steps, in-kernel sampler)")

        # external noise, K6b against its plain version along 32 steps of
        # the kernel's trajectory, one step at a time (see _hold_mlp)
        n = 32
        rs = np.random.RandomState(18)
        noise = [_manifold_noise(torch, np, rs, r, n, kw["batch"], dev) for r in rows]
        kb = k5.pack_rows(states, rows, hidden, hidden, dual)
        worst = 0.0
        for step in range(n):
            srows = [dataclasses.replace(r, step0=r.step0 + step, t0=r.t0 + step) for r in rows]
            ext = [tuple(t[step:step + 1].contiguous() for t in nz) for nz in noise]
            pb = tuple(t.clone() for t in kb)
            kl = k5.run_grid_chunk(*kb, srows, n_steps=1, external_noise=ext, **kw)
            pl = k5.plain_grid_chunk(*pb, srows, n_steps=1, external_noise=ext, **kw)
            torch.cuda.synchronize()
            worst = max(worst, _hold_mlp(
                torch, np, f"K6b {which} step {step}", kl, pl,
                k5.row_views(*kb, rows, hidden, hidden, dual),
                k5.row_views(*pb, rows, hidden, hidden, dual)))
        errs[which] = worst
        print(f"{which} external noise, K6b vs plain_grid_chunk ({n} steps, one at a time): "
              f"losses at MLP_TOL, every row's p, m, v within MLP_TOL's rtol in 2-norm; "
              f"max |Δ| {worst:.2e}")

        a = k5.pack_rows(states, rows, hidden, hidden, dual)
        b = tuple(t.clone() for t in a)
        la = k5.run_grid_chunk(*a, rows, n_steps=40, **kw)
        later = [dataclasses.replace(r, step0=r.step0 + 15, t0=r.t0 + 15) for r in rows]
        lb = torch.cat([k5.run_grid_chunk(*b, rows, n_steps=15, **kw),
                        k5.run_grid_chunk(*b, later, n_steps=25, **kw)], dim=1)
        torch.cuda.synchronize()
        require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
                f"K6b {which}: a 40-step launch equals a 15 + 25 split bitwise")
        print(f"{which}: K6b chunk split 40 = 15 + 25 bitwise equal")

    # --- 19 --------------------------------------------------------------
    phase(19, "K5-dual vs its plain PyTorch version at sigmoid row 1, 200|200|200 (64 steps)")
    sig = SigmoidDataset.create(69, SIG_DD, 3, device=dev)
    data_seed = rng.derive_seed(69, rng.SEED_TRAIN_DATA)
    model_seed = rng.derive_seed(0, rng.SEED_TRAIN_Z)
    enc, dec = (SIG_D, *hidden, SIG_L), (SIG_L, *hidden, SIG_D)

    def dual_state(tdv):
        model = build_vae(data_dim=SIG_D, latent_dim=SIG_L, encoder_layer_sizes="200|200|200",
                          decoder_layer_sizes="200|200|200", epsilon=-3.0,
                          tunable_decoder_var=tdv, dataset_name="sigmoid")
        model.init_parameters(0)
        state = TrainState.create(dict(model.named_parameters()), 0, 0).to(dev)
        return k5.pack_state(state, enc, dec, dual=True)

    def dual_chunk(fn, bufs, n, step0, tdv, noise=None):
        return fn(*bufs, sig.A, n_steps=n, batch=B, enc_widths=enc, dec_widths=dec,
                  kind="sigmoid", intrinsic_dim=SIG_DD, manifold_dim=SIG_DD, step0=step0,
                  t0=step0, data_seed=data_seed, model_seed=model_seed, var_added=0.0,
                  eps_const=-3.0, tdv=tdv, lr=1e-4, external_noise=noise, dual=True)

    row1 = k1.GridRow(SIG_D, SIG_L, SIG_DD, SIG_DD, sig.A, 0, 0, data_seed, model_seed)
    ext = _manifold_noise(torch, np, np.random.RandomState(19), row1, 64, B, dev)
    dual_err = 0.0
    for tdv in (True, False):
        for mode, noise in (("external", ext), ("sampler", None)):
            kb = dual_state(tdv)
            err = 0.0
            for step in range(64):  # one step at a time (see _hold_mlp)
                pb = tuple(t.clone() for t in kb)
                one = None if noise is None else tuple(t[step:step + 1].contiguous()
                                                       for t in noise)
                kl = dual_chunk(k5.run_mlp_fused_chunk, kb, 1, step, tdv, one)
                pl = dual_chunk(k5.plain_mlp_fused_chunk, pb, 1, step, tdv, one)
                torch.cuda.synchronize()
                err = max(err, _hold_mlp(torch, np, f"K5-dual tdv={tdv} {mode} step {step}",
                                         kl, pl, [kb], [pb]))
            dual_err = max(dual_err, err)
            print(f"K5-dual tdv={tdv!s:5} {mode:8}: 64 steps one at a time within tolerance, "
                  f"max |Δ| {err:.2e}")
    _split(torch, "K5-dual", dual_state, k5.run_mlp_fused_chunk, dual_chunk)

    def cli(name, row, num_batches, *extra):
        cfg = parse_arguments([name, *row, "--num_batches", str(num_batches), "--kernels",
                               "cuda", "--device", "cuda", "--data_dir", data_dir, *extra])
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t

    reset_counts()
    rc, out, secs = cli("main_dual", SIGMOID_MLP_ROW1, 12000)
    dual_launches, plain = k5.run_mlp_fused_chunk.launches, plain_chunks()
    print("\n".join(ln for ln in out.splitlines() if ln.startswith(("Batch |", "[kernels]"))))
    print(f"K5-dual main path: rc {rc}, {secs:.2f} s, K5-dual launches {dual_launches}, "
          f"plain chunks {plain}")
    require(rc == 0, "K5-dual: main() returned 0")
    require("[kernels] cuda: fused MLP-VAE kernel K5 (dual decoder) (" in out,
            "the [kernels] line names K5 (dual decoder)")
    require(dual_launches > 0 and plain == 0, "K5-dual launched and no plain chunk ran")
    evals = {int(mt.group(1)): float(mt.group(2)) for mt in re.finditer(
        r"^Batch \| (\d+) \| VAE Loss \| (-?[\d.]+)", out, re.M)}
    require(sorted(evals) == [0, 5000, 10000] and evals[10000] < evals[0],
            "K5-dual: eval VAE Loss lower at 10000 than at 0")
    z = np.load(os.path.join(data_dir, "main_dual", "losses.npz"))
    require(bool(np.all(np.isfinite(z["VAE Loss"]))) and z["VAE Loss"].shape == (12003,),
            "K5-dual: finite per-step loss trace of 12000 steps + 3 evals")
    print(f"K5-dual: eval VAE Loss {evals[0]:.3f} -> {evals[10000]:.3f}")

    # --- 20 --------------------------------------------------------------
    phase(20, "the CLI's --seed_grid 69,24,48 at sphere row 1 and the sphere sweep through "
              "the sweep runner, 12000 steps, on K6b")
    reset_counts()
    rc, out, secs = cli("grid", SPHERE_ROW1, 12000, "--seed_grid", "69,24,48")
    grid_n, solo_n, plain = (k5.run_grid_chunk.launches, k5.run_mlp_fused_chunk.launches,
                             plain_chunks())
    print("\n".join(ln for ln in out.splitlines() if ln.startswith(("[kernels]", "[seed 69]"))))
    print(f"seed grid: rc {rc}, {secs:.2f} s for 3 rows, K6b launches {grid_n}, solo K5 "
          f"launches {solo_n}, plain chunks {plain}")
    require(rc == 0 and "[kernels] cuda: K6b" in out, "the seed grid ran, its [kernels] "
                                                      "line naming K6b")
    require(grid_n == 4 and solo_n == 0 and plain == 0,
            f"one K6b launch a chunk (4 chunks, got {grid_n}), no solo launch, no plain chunk")
    _require_same_run(np, solo_sphere_dir, os.path.join(data_dir, "grid_seed69"))
    print("row seed69's losses.npz and model.pkl equal phase 11's solo run bitwise")

    def run_sweep(sub, num_batches, *extra):
        reset_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = sweep.main(["sphere", "--grouped", "--kernels", "cuda", "--num_batches",
                             str(num_batches), "--data_dir", os.path.join(data_dir, sub),
                             *extra])
        torch.cuda.synchronize()
        counts = (k5.run_grid_chunk.launches, k5.run_mlp_fused_chunk.launches
                  + k1.run_grid_chunk.launches + k1.run_fused_chunk.launches, plain_chunks())
        return rc, buf.getvalue(), time.perf_counter() - t, counts

    rc, out, secs, (grid_n, other_n, plain) = run_sweep("sphere", 12000)
    sweep_launches = grid_n
    acct = [ln for ln in out.splitlines() if ln.startswith("[sweep]")]
    print("\n".join(ln for ln in out.splitlines() if ln.startswith("[kernels]")))
    print("\n".join(acct))
    print(f"sphere sweep: rc {rc}, {secs:.2f} s, K6b launches {grid_n}, other launches "
          f"{other_n}, plain chunks {plain}")
    require(rc == 0, "the sphere sweep returned 0")
    require("[kernels] cuda: K6b, the grid mode of the fused MLP-VAE kernel, 15 rows in one "
            "launch a chunk" in out, "one K6b launch over the sweep's 15 rows")
    require(grid_n == 4 and other_n == 0 and plain == 0,
            "sphere sweep: one K6b launch a chunk and nothing else")
    require(any("wall accounting: banners" in ln for ln in acct), "the wall-accounting line")
    falling = 0
    for c in sweep.sweep_configs("sphere", data_dir, 12000, "cuda"):
        trace = np.load(os.path.join(data_dir, "sphere", c.name, "losses.npz"))["VAE Loss"]
        require(bool(np.all(np.isfinite(trace))) and trace.shape == (12003,),
                f"{c.name}: finite loss trace of 12000 steps + 3 evals")
        falling += bool(trace[-100:].mean() < trace[0])
    print(f"sphere: the last 100 steps' mean loss is below the step-0 eval's in {falling} "
          f"of 15 runs")
    require(falling == 15, "sphere: every run's loss falls")
    rc1, _, _, _ = run_sweep("sphere_resumed", 7000)
    rc2, _, _, (grid_n, _, _) = run_sweep("sphere_resumed", 12000, "--resume")
    require(rc1 == 0 and rc2 == 0 and grid_n > 0, "the stopped and resumed sweeps ran on K6b")
    for c in sweep.sweep_configs("sphere", data_dir, 12000, "cuda"):
        _require_same_run(np, os.path.join(data_dir, "sphere", c.name),
                          os.path.join(data_dir, "sphere_resumed", c.name))
    print("sphere sweep --resume from 7000 to 12000: all 15 runs equal the uninterrupted "
          "sweep bitwise")

    # --- 21 --------------------------------------------------------------
    phase(21, "times: K6b against sequential solo K5 launches and its plain version; "
              "K5-dual against the torch path")
    records = []
    fam = families["sphere"]
    rows, kw, states = fam["rows"], fam["kw"], fam["states"]
    n_rows, steps = len(rows), 200
    kb = k5.pack_rows(states, rows, hidden, hidden)
    pb = tuple(t.clone() for t in kb)
    solo_bufs = [k5.pack_state(st, *k5.row_widths(r, hidden, hidden))
                 for st, r in zip(states, rows)]

    def grid_call():
        k5.run_grid_chunk(*kb, rows, n_steps=steps, **kw)

    def solo_call():
        for i, bufs in enumerate(solo_bufs):
            solo(fam, i, bufs, steps)

    def plain_call():
        k5.plain_grid_chunk(*pb, rows, n_steps=2, **kw)

    rates = {}
    for name, fn, n in (("plain", plain_call, 2), ("grid", grid_call, steps),
                        ("solo", solo_call, steps), ("solo2", solo_call, steps),
                        ("grid2", grid_call, steps), ("plain2", plain_call, 2)):
        rates[name] = _steps_per_second(torch, fn, n)  # launch-steps a second
    g_rate = max(rates["grid"], rates["grid2"])
    s_rate = max(rates["solo"], rates["solo2"])
    p_rate = max(rates["plain"], rates["plain2"])
    widths = [k5.row_widths(r, hidden, hidden) for r in rows]
    flops = sum(mlp_flops(B, e, d) for e, d in widths)
    state_bytes = sum(6 * 4 * k5.n_params(e, d) for e, d in widths)
    bound = _bound(flops, state_bytes, steps, losses_per_step=n_rows)
    print(f"card: {smi}")
    print(f"K6b sphere sweep, {n_rows} rows, {steps}-step launches: {rates['grid']:.1f} / "
          f"{rates['grid2']:.1f} launch-steps/s ({1e3 / g_rate:.5f} ms a launch-step, "
          f"{g_rate * n_rows:.1f} row-steps/s)")
    print(f"sequential solo K5 launches of the same rows: {rates['solo'] * n_rows:.1f} / "
          f"{rates['solo2'] * n_rows:.1f} row-steps/s (K6b {g_rate / s_rate:.2f}x)")
    print(f"plain_grid_chunk: {rates['plain']:.3f} / {rates['plain2']:.3f} launch-steps/s "
          f"({1e3 / p_rate:.3f} ms a launch-step)")
    passes = sum(mlp_pass_ms(B, e, d) for e, d in widths)
    print(f"K6b bound {bound['bound_ms'] * 1e3:.4f} us a launch-step ({bound['bound_by']}; "
          f"{flops / 1e6:.3f} MFLOP), kernel at {bound['bound_ms'] * g_rate / 10:.4f}% of it; "
          f"as 3xTF32 passes (not this kernel's mode) {passes * 1e3:.4f} us")
    records.append({
        "name": f"mlp_vae_chunk grid (K6b), sphere sweep, {n_rows} rows", "route": "cuda",
        "source": "vae_training_tpu_torch/csrc/mlp_vae.cu",
        "replaces": "vae_training_tpu/kernels/mlp_vae.py:644",
        "launches": sweep_launches, "max_abs_err": max(errs.values()),
        "ms": 1e3 / g_rate, "plain_ms": 1e3 / p_rate, **bound, "library_ms": None})

    # the launch-step against the number of copies of sphere row 1
    for copies in (1, 15, 45):
        crows = [rows[0]] * copies
        bufs = k5.pack_rows([states[0]] * copies, crows, hidden, hidden)
        rate = _steps_per_second(torch, lambda: k5.run_grid_chunk(
            *bufs, crows, n_steps=steps, **kw), steps)
        print(f"K6b with {copies:2d} copies of sphere row 1: {1e3 / rate:.5f} ms a launch-step "
              f"({rate * copies:.1f} row-steps/s)")

    # K5-dual at sigmoid row 1 against the torch path
    model = build_vae(data_dim=SIG_D, latent_dim=SIG_L, encoder_layer_sizes="200|200|200",
                      decoder_layer_sizes="200|200|200", epsilon=-3.0,
                      tunable_decoder_var=True, dataset_name="sigmoid")
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), data_seed, model_seed).to(dev)
    kb = dual_state(True)
    k_steps, p_steps = 1000, 50

    def kernel_call():
        dual_chunk(k5.run_mlp_fused_chunk, kb, k_steps, 0, True)

    def torch_call():
        torch_step.train_chunk(model, sig, state, p_steps, batch_size=B, lr=1e-4)

    rates = {}
    for name, fn, n in (("plain", torch_call, p_steps), ("kernel", kernel_call, k_steps),
                        ("kernel2", kernel_call, k_steps), ("plain2", torch_call, p_steps)):
        rates[name] = _steps_per_second(torch, fn, n)
    k_rate = max(rates["kernel"], rates["kernel2"])
    p_rate = max(rates["plain"], rates["plain2"])
    flops = mlp_flops(B, enc, dec, dual=True)
    bound = _bound(flops, 6 * 4 * k5.n_params(enc, dec, True), k_steps)
    print(f"K5-dual kernel: {rates['kernel']:.1f} / {rates['kernel2']:.1f} steps/s "
          f"({1e3 / k_rate:.5f} ms/step, {k_steps}-step launches)")
    print(f"torch path: {rates['plain']:.1f} / {rates['plain2']:.1f} steps/s "
          f"({1e3 / p_rate:.5f} ms/step)")
    passes = mlp_pass_ms(B, enc, dec, dual=True)
    print(f"K5-dual bound {bound['bound_ms'] * 1e3:.4f} us/step ({bound['bound_by']}; "
          f"{flops / 1e6:.3f} MFLOP/step), kernel at {bound['bound_ms'] * k_rate / 10:.3f}% of it; "
          f"as 3xTF32 passes (not this kernel's mode) {passes * 1e3:.4f} us")
    records.append({
        "name": "mlp_vae_chunk dual (K5-dual)", "route": "cuda",
        "source": "vae_training_tpu_torch/csrc/mlp_vae.cu",
        "replaces": "vae_training_tpu/kernels/mlp_vae.py:644",
        "launches": dual_launches, "max_abs_err": dual_err,
        "ms": 1e3 / k_rate, "plain_ms": 1e3 / p_rate, **bound, "library_ms": None})
    return records


def _bf16_moments(torch, np, smi, data_dir):
    """Phases 22–25: K4, the bf16 Adam moments (``--adam_dtype bf16``), in
    every kernel: K1, K2 and K6a (csrc/linear_vae.cu), K5, K5-dual and K6b
    (csrc/mlp_vae.cu). Returns the K4 records for the kernels' JSON line."""
    from vae_training_tpu_torch._scripts import sweep
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.data import (
        LinearGaussianDataset,
        SigmoidDataset,
        SphereDataset,
    )
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import mlp_vae as k5
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.runio.checkpoint import read_checkpoint_meta, restore_checkpoint
    from vae_training_tpu_torch.train import TrainState, moment_dtype, step as torch_step
    from vae_training_tpu_torch.train.grid import GridTrainer

    dev = torch.device("cuda")
    hidden = (200, 200, 200)
    counters = (k1.run_fused_chunk, k1.run_grid_chunk, k5.run_mlp_fused_chunk,
                k5.run_grid_chunk)
    plain_counters = (torch_step.train_chunk, torch_step.GraphChunk, k1.plain_grid_chunk,
                      k5.plain_grid_chunk)

    def reset_counts():
        for c in counters:
            c.launches = 0
        for c in plain_counters:
            c.calls = 0

    # --- the solo configurations: row 1 of each sweep ------------------------
    lin = LinearGaussianDataset.create(2, 3, 3, 9, device=dev)
    sig = SigmoidDataset.create(69, SIG_DD, 3, device=dev)
    sph = SphereDataset(SPH_DD, SPH_D - SPH_DD, device=dev)
    seeds = {s: (rng.derive_seed(s, rng.SEED_TRAIN_DATA), rng.derive_seed(0, rng.SEED_TRAIN_Z))
             for s in (2, 69)}
    dual_enc, dual_dec = (SIG_D, *hidden, SIG_L), (SIG_L, *hidden, SIG_D)

    def solo(label):
        """(model, dataset, layout, chunk(fn, bufs, n, step0, tdv, noise, adam), lr, the
        kernel, its plain version) of one solo configuration."""
        if label in ("K1", "K2"):
            dual = label == "K2"
            D_, L_, ds = (SIG_D, SIG_L, sig) if dual else (D, L, lin)
            ds_seed, md_seed = seeds[69 if dual else 2]
            lr, eps = (1e-4, -3.0) if dual else (1e-3, -1.0)

            def make_model(tdv):
                return build_vae(data_dim=D_, latent_dim=L_, epsilon=eps, tunable_decoder_var=tdv,
                                 dataset_name="sigmoid" if dual else None)

            def chunk(fn, bufs, n, step0, tdv, noise=None, adam="bf16"):
                return fn(*bufs, ds.A, n_steps=n, batch=B, data_dim=D_, latent_dim=L_,
                          intrinsic_dim=ds.intrinsic_dim, manifold_dim=ds.dim, step0=step0,
                          t0=step0, data_seed=ds_seed, model_seed=md_seed, var_added=0.0,
                          eps_const=eps, tdv=tdv, lr=lr, external_noise=noise, dual=dual,
                          adam_dtype=adam)

            return dict(make_model=make_model, ds=ds, layout=k1.param_layout(D_, L_, dual),
                        chunk=chunk, lr=lr, kernel=k1.run_fused_chunk,
                        plain=k1.plain_fused_chunk,
                        pack=lambda st: k1.pack_state(st, D_, L_, dual),
                        row=k1.GridRow(D_, L_, ds.intrinsic_dim, ds.dim, ds.A, 0, 0,
                                       ds_seed, md_seed),
                        flops=linear_flops(B, D_, L_, ds.intrinsic_dim, ds.dim, dual))
        dual = label == "K5-dual"
        enc, dec = (dual_enc, dual_dec) if dual else (SPH_ENC, SPH_DEC)
        ds = sig if dual else sph
        ds_seed, md_seed = seeds[69]

        def make_model(tdv):
            return build_vae(data_dim=enc[0], latent_dim=enc[-1], encoder_layer_sizes="200|200|200",
                             decoder_layer_sizes="200|200|200", epsilon=-3.0,
                             tunable_decoder_var=tdv, dataset_name="sigmoid" if dual else None)

        def chunk(fn, bufs, n, step0, tdv, noise=None, adam="bf16"):
            return fn(*bufs, sig.A if dual else None, n_steps=n, batch=B, enc_widths=enc,
                      dec_widths=dec, kind="sigmoid" if dual else "sphere",
                      intrinsic_dim=ds.dim, manifold_dim=ds.dim, step0=step0, t0=step0,
                      data_seed=ds_seed, model_seed=md_seed, var_added=0.0, eps_const=-3.0,
                      tdv=tdv, lr=1e-4, external_noise=noise, dual=dual, adam_dtype=adam)

        return dict(make_model=make_model, ds=ds, layout=k5.param_layout(enc, dec, dual),
                    chunk=chunk, lr=1e-4, kernel=k5.run_mlp_fused_chunk,
                    plain=k5.plain_mlp_fused_chunk,
                    pack=lambda st: k5.pack_state(st, enc, dec, dual),
                    row=k1.GridRow(enc[0], enc[-1], ds.dim, ds.dim, sig.A if dual else None, 0,
                                   0, ds_seed, md_seed),
                    flops=mlp_flops(B, enc, dec, dual))

    configs = {label: solo(label) for label in ("K1", "K2", "K5", "K5-dual")}

    def state_of(cfg, tdv, adam="bf16", seeded=False):
        model = cfg["make_model"](tdv)
        model.init_parameters(0)
        ds_seed, md_seed = (cfg["row"].data_seed, cfg["row"].model_seed) if seeded else (0, 0)
        return model, TrainState.create(dict(model.named_parameters()), ds_seed, md_seed,
                                        adam).to(dev)

    # --- the grid families: the sweeps' rows, bf16 moments ---------------------
    def family(which, cfgs, seeds_):
        groups = {}
        for cfg in cfgs:
            groups.setdefault((cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension), cfg)
        grids = [GridTrainer(cfg, seeds_, build_chunk=False) for cfg in groups.values()]
        trip = [(g.model, ds, st) for g in grids for ds, st in zip(g.datasets, g.states)]
        kind = k5.dataset_kind(trip[0][1])
        rows = [k1.GridRow(ds.dimension, m.latent_dim, ds.intrinsic_dim, ds.dim,
                           None if kind == "sphere" else ds.A, st.step, st.count, st.data_seed,
                           st.model_seed, ds.var_added) for m, ds, st in trip]
        mlp = bool(trip[0][0].encoder_features[:-1])
        dual, c0 = trip[0][0].dual_sigmoid_decoder, cfgs[0]
        kw = dict(batch=c0.batch_size, eps_const=c0.epsilon, tdv=True, lr=c0.learning_rate,
                  dual=dual)
        if mlp:
            kw.update(enc_hidden=hidden, dec_hidden=hidden, kind=kind)
            widths = [k5.row_widths(r, hidden, hidden) for r in rows]
            layouts = [k5.param_layout(e, d, dual) for e, d in widths]
            flops = sum(mlp_flops(B, e, d, dual) for e, d in widths)
        else:
            layouts = [k1.param_layout(r.data_dim, r.latent_dim, dual) for r in rows]
            flops = sum(linear_flops(B, r.data_dim, r.latent_dim, r.intrinsic_dim,
                                     r.manifold_dim, dual) for r in rows)
        module = k5 if mlp else k1
        extra = (hidden, hidden) if mlp else ()
        states = [st for _, _, st in trip]

        def solo_launch(i, bufs, n, adam="bf16"):
            r = rows[i]
            if mlp:
                e, d = k5.row_widths(r, hidden, hidden)
                return k5.run_mlp_fused_chunk(
                    *bufs, r.a, n_steps=n, batch=B, enc_widths=e, dec_widths=d, kind=kind,
                    intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
                    t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed,
                    var_added=r.var_added, eps_const=kw["eps_const"], tdv=True, lr=kw["lr"],
                    dual=dual, adam_dtype=adam)
            return k1.run_fused_chunk(
                *bufs, r.a, n_steps=n, batch=B, data_dim=r.data_dim, latent_dim=r.latent_dim,
                intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
                t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed, var_added=r.var_added,
                eps_const=kw["eps_const"], tdv=True, lr=kw["lr"], dual=dual, adam_dtype=adam)

        return dict(
            label=f"K6{'b' if mlp else 'a'} {which}", rows=rows, states=states, kw=kw,
            layouts=layouts, mlp=mlp, module=module, flops=flops, solo=solo_launch,
            pack=lambda sts: module.pack_rows(sts, rows, *extra, dual),
            views=lambda p, m, v: module.row_views(p, m, v, rows, *extra, dual),
            pack_solo=lambda i: (k5.pack_state(states[i], *k5.row_widths(rows[i], *extra), dual)
                                 if mlp else k1.pack_state(states[i], rows[i].data_dim,
                                                           rows[i].latent_dim, dual)),
            state_bytes=sum(6 * 4 * sum(int(np.prod(s)) for _, s in lay) for lay in layouts))

    def sweep_family(which):
        cfgs = list(sweep.sweep_configs(which, data_dir, 64, "cuda", adam_dtype="bf16"))
        return family(which, cfgs, sweep.SWEEP_SEEDS[which])

    sig_mlp_cfg = parse_arguments(["dual", *SIGMOID_MLP_ROW1, "--num_batches", "64", "--kernels",
                                   "cuda", "--device", "cuda", "--data_dir", data_dir,
                                   "--adam_dtype", "bf16"])
    families = {"linear": sweep_family("linear"), "sigmoid": sweep_family("sigmoid"),
                "sphere": sweep_family("sphere"),
                "sigmoid-MLP": family("sigmoid-MLP", [sig_mlp_cfg], [69, 24, 48])}

    def noise_for(row, n, rs, kind):
        """External (x, z1, z2) of ``n`` steps for one row: x on its manifold."""
        if kind == "linear":
            z = rs.randn(n, B, row.intrinsic_dim).astype(np.float32)
            x = np.zeros((n, B, row.data_dim), np.float32)
            x[:, :, :row.manifold_dim] = z @ row.a.cpu().numpy().T
            return tuple(torch.as_tensor(t.astype(np.float32), device=dev) for t in (
                x, rs.randn(n, B, row.latent_dim), rs.randn(n, B, row.data_dim)))
        return _manifold_noise(torch, np, rs, row, n, B, dev)

    # --- 22 -------------------------------------------------------------------
    phase(22, "K4: each kernel's bf16 moments against its plain version on the card")
    print("one step at a time from the kernel's own state, each step also launched with f32 "
          "moments from the same state: the bf16 launch's matrix moments must be the f32 "
          "launch's rounded to nearest even, bitwise; against the plain version: losses and "
          "the f32 slots at TOL (MLP: MLP_TOL, p, m, v by relative 2-norm), the matrix "
          "slots by the ulp contract (K1, K2, K6a strict: <= 1 bf16 ulp above the f32 atol; "
          "the MLP kernel: at most 0.1% of a row's matrix moments outside the drift bound "
          "max(1e-3, 0.02|x|); >= 95% bitwise)")
    errs, exact = {}, {}

    def step_hold(label, launch, plain, bufs, rows_of, layouts, n, mlp, noise_at):
        """``n`` steps one at a time: launch(bufs, step, noise, adam) runs one step
        of the kernel in place, plain(...) its plain version; rows_of(bufs) are
        the rows' (p, m, v). Returns (largest |d|, smallest bitwise share)."""
        worst, share = 0.0, 1.0
        for step in range(n):
            one = noise_at(step)
            f32 = tuple(t.clone() for t in bufs)
            pb = tuple(t.clone() for t in bufs)
            lf = launch(f32, step, one, "f32")
            kl = launch(bufs, step, one, "bf16")
            pl = plain(pb, step, one, "bf16")
            torch.cuda.synchronize()
            _require_rounded(torch, f"{label} step {step}", lf, kl, rows_of(f32), rows_of(bufs),
                             layouts)
            w, e = _hold_bf16(torch, np, f"{label} step {step}", kl, pl, rows_of(bufs),
                              rows_of(pb), layouts, MLP_TOL if mlp else TOL,
                              "tail" if mlp else "strict", norms=mlp)
            worst, share = max(worst, w), min(share, e)
        return worst, share

    for label in ("K1", "K2", "K5", "K5-dual"):
        cfg = configs[label]
        mlp = label.startswith("K5")
        n = 16 if mlp else 64
        ext = noise_for(cfg["row"], n, np.random.RandomState(22),
                        "linear" if label == "K1" else ("sphere" if label == "K5" else "sigmoid"))
        errs[label], exact[label] = 0.0, 1.0
        for tdv in ((True,) if mlp else (True, False)):
            for mode in ("external", "sampler"):
                _, st = state_of(cfg, tdv)
                bufs = cfg["pack"](st)

                def launch(b, step, one, adam, fn=cfg["kernel"], tdv=tdv):
                    return cfg["chunk"](fn, b, 1, step, tdv, one, adam)

                def plain(b, step, one, adam, tdv=tdv):
                    return cfg["chunk"](cfg["plain"], b, 1, step, tdv, one, adam)

                def noise_at(step, mode=mode):
                    return None if mode == "sampler" else tuple(
                        t[step:step + 1].contiguous() for t in ext)

                w, e = step_hold(f"{label} tdv={tdv} {mode}", launch, plain, bufs,
                                 lambda b: [b], [cfg["layout"]], n, mlp, noise_at)
                errs[label], exact[label] = max(errs[label], w), min(exact[label], e)
                print(f"{label} tdv={tdv!s:5} {mode:8}: {n} steps one at a time, max |d| {w:.2e}, "
                      f"bitwise share of the matrix moments >= {e:.4f}")
                if not mlp:  # and one launch of all 64 steps against the plain chunk
                    _, st = state_of(cfg, tdv)
                    kb = cfg["pack"](st)
                    pb = tuple(t.clone() for t in kb)
                    noise = None if mode == "sampler" else ext
                    kl = cfg["chunk"](cfg["kernel"], kb, n, 0, tdv, noise)
                    pl = cfg["chunk"](cfg["plain"], pb, n, 0, tdv, noise)
                    torch.cuda.synchronize()
                    w, e = _hold_bf16(torch, np, f"{label} tdv={tdv} {mode} {n}-step launch", kl,
                                      pl, [kb], [pb], [cfg["layout"]], TOL, "drift")
                    errs[label] = max(errs[label], w)
                    print(f"{label} tdv={tdv!s:5} {mode:8}: one {n}-step launch, max |d| {w:.2e}, "
                          f"bitwise share >= {e:.4f} (drift contract)")
    for which, fam in families.items():
        n = 32 if fam["mlp"] else 16
        rs = np.random.RandomState(23)
        kind = {"linear": "linear", "sigmoid": "sigmoid", "sphere": "sphere",
                "sigmoid-MLP": "sigmoid"}[which]
        noise = [noise_for(r, n, rs, kind) for r in fam["rows"]]
        bufs = fam["pack"](fam["states"])
        rows = fam["rows"]

        def launch(b, step, one, adam, fam=fam, rows=rows, fn="run_grid_chunk"):
            srows = [dataclasses.replace(r, step0=r.step0 + step, t0=r.t0 + step) for r in rows]
            return getattr(fam["module"], fn)(*b, srows, n_steps=1, external_noise=one,
                                              **fam["kw"], adam_dtype=adam)

        def plain(b, step, one, adam, launch=launch):
            return launch(b, step, one, adam, fn="plain_grid_chunk")

        def noise_at(step, noise=noise):
            return [tuple(t[step:step + 1].contiguous() for t in nz) for nz in noise]

        w, e = step_hold(fam["label"], launch, plain, bufs, lambda b, fam=fam: fam["views"](*b),
                         fam["layouts"], n, fam["mlp"], noise_at)
        errs[fam["label"]], exact[fam["label"]] = w, e
        print(f"{fam['label']}: {len(rows)} rows, {n} steps one at a time, external noise, max "
              f"|d| {w:.2e}, bitwise share of the matrix moments >= {e:.4f}")

    # --- 23 -------------------------------------------------------------------
    phase(23, "K4 bitwise: grid rows equal their solo launches, 40 = 15 + 25, in bf16")
    for which, fam in families.items():
        p, m, v = fam["pack"](fam["states"])
        losses = fam["module"].run_grid_chunk(p, m, v, fam["rows"], n_steps=64, **fam["kw"],
                                              adam_dtype="bf16")
        views = fam["views"](p, m, v)
        for i in range(len(fam["rows"])):
            bufs = fam["pack_solo"](i)
            want = fam["solo"](i, bufs, 64)
            torch.cuda.synchronize()
            require(torch.equal(losses[i], want), f"{fam['label']} row {i}: bf16 losses equal "
                                                  f"the solo launch's bitwise")
            for name, got, ref in zip("pmv", views[i], bufs):
                require(torch.equal(got, ref), f"{fam['label']} row {i}: bf16 {name} equals "
                                               f"the solo launch's bitwise")
            for got, lay in zip(views[i][1:], (fam["layouts"][i],) * 2):
                mask = k1.matrix_mask(lay).to(dev)
                require(torch.equal(got[mask], got[mask].bfloat16().float()),
                        f"{fam['label']} row {i}: matrix moments are bfloat16 values")
        print(f"{fam['label']}: {len(fam['rows'])} rows, 64 bf16 steps: every row's losses, p, "
              f"m and v equal its solo launch bitwise")
        a = fam["pack"](fam["states"])
        b = tuple(t.clone() for t in a)
        la = fam["module"].run_grid_chunk(*a, fam["rows"], n_steps=40, **fam["kw"],
                                          adam_dtype="bf16")
        later = [dataclasses.replace(r, step0=r.step0 + 15, t0=r.t0 + 15) for r in fam["rows"]]
        lb = torch.cat([fam["module"].run_grid_chunk(*b, fam["rows"], n_steps=15, **fam["kw"],
                                                     adam_dtype="bf16"),
                        fam["module"].run_grid_chunk(*b, later, n_steps=25, **fam["kw"],
                                                     adam_dtype="bf16")], dim=1)
        torch.cuda.synchronize()
        require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
                f"{fam['label']}: a 40-step bf16 launch equals a 15 + 25 split bitwise")
        print(f"{fam['label']}: bf16 chunk split 40 = 15 + 25 bitwise equal")
    for label, cfg in configs.items():
        _split(torch, f"{label} bf16", lambda tdv, cfg=cfg: cfg["pack"](state_of(cfg, tdv)[1]),
               cfg["kernel"], cfg["chunk"])

    # --- 24 -------------------------------------------------------------------
    phase(24, "K4 main paths: the CLI and the sweep runner with --adam_dtype bf16 "
              "--kernels cuda, 12000 steps")

    def cli(name, row, num_batches, *extra):
        cfg = parse_arguments([name, *row, "--num_batches", str(num_batches), "--kernels", "cuda",
                               "--device", "cuda", "--data_dir", data_dir, "--adam_dtype",
                               "bf16", *extra])
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t

    def require_bf16_state(label, run_dir):
        st = restore_checkpoint(run_dir)
        for tree in (st.m, st.v):
            for k, t in tree.items():
                require(t.dtype == moment_dtype(t.shape, "bf16"),
                        f"{label}: checkpoint moment {k} is {t.dtype}")
        require((read_checkpoint_meta(run_dir) or {}).get("adam_dtype") == "bf16",
                f"{label}: ckpt_meta.json records adam_dtype bf16")

    launches = {}
    for label, row, counter in (("K1", ROW1, k1.run_fused_chunk),
                                ("K2", SIGMOID_ROW1, k1.run_fused_chunk),
                                ("K5", SPHERE_ROW1, k5.run_mlp_fused_chunk),
                                ("K5-dual", SIGMOID_MLP_ROW1, k5.run_mlp_fused_chunk)):
        name = f"bf16_{label}"
        reset_counts()
        rc, out, secs = cli(name, row, 12000)
        launches[label] = counter.launches
        others = sum(c.launches for c in counters) - counter.launches
        plain = sum(c.calls for c in plain_counters)
        kline = [ln for ln in out.splitlines() if ln.startswith("[kernels]")]
        print("\n".join(kline + [ln for ln in out.splitlines() if ln.startswith("Batch |")]))
        print(f"{label} bf16 main path: rc {rc}, {secs:.2f} s, {label} launches "
              f"{launches[label]}, other launches {others}, plain chunks {plain}")
        require(rc == 0, f"{label} bf16: main() returned 0")
        name_in_line = ("kernel K5 (dual decoder) (" if label == "K5-dual"
                        else f"kernel {label} (")
        require(len(kline) == 1 and name_in_line in kline[0]
                and kline[0].endswith("with bf16-operand dots and bf16 Adam moments"),
                f"{label} bf16: the [kernels] line names {label}, the CLI's default bf16 "
                f"dots and bf16 moments")
        require(launches[label] > 0 and others == 0 and plain == 0,
                f"{label} bf16: {label} launched, nothing else, no plain chunk")
        evals = {int(mt.group(1)): float(mt.group(2)) for mt in re.finditer(
            r"^Batch \| (\d+) \| VAE Loss \| (-?[\d.]+)", out, re.M)}
        require(sorted(evals) == [0, 5000, 10000] and evals[10000] < evals[0],
                f"{label} bf16: eval VAE Loss lower at 10000 than at 0")
        run_dir = os.path.join(data_dir, name)
        z = np.load(os.path.join(run_dir, "losses.npz"))
        require(bool(np.all(np.isfinite(z["VAE Loss"]))) and z["VAE Loss"].shape == (12003,),
                f"{label} bf16: finite per-step loss trace of 12000 steps + 3 evals")
        require_bf16_state(label, run_dir)
        print(f"{label} bf16: eval VAE Loss {evals[0]:.3f} -> {evals[10000]:.3f}; "
              f"checkpoint moments bf16 for the weight matrices, f32 for the rest")

    rc1, _, _ = cli("bf16_part", SPHERE_ROW1, 7000)
    require(rc1 == 0, "sphere bf16 7000 steps returned 0")
    require_bf16_state("sphere bf16 part", os.path.join(data_dir, "bf16_part"))
    rc2, _, _ = cli("bf16_resumed", SPHERE_ROW1, 12000, "--resume",
                    os.path.join(data_dir, "bf16_part"))
    require(rc2 == 0, "sphere bf16 --resume returned 0")
    _require_same_run(np, os.path.join(data_dir, "bf16_K5"), os.path.join(data_dir, "bf16_resumed"))
    print("sphere bf16 --resume from 7000 to 12000: losses.npz and model.pkl params equal the "
          "uninterrupted bf16 run bitwise")

    def run_sweep(which, sub, *extra):
        reset_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = sweep.main([which, "--grouped", "--kernels", "cuda", "--num_batches", "12000",
                             "--adam_dtype", "bf16", "--data_dir", os.path.join(data_dir, sub),
                             *extra])
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t

    for which, grid_label, module, rows in (("sphere", "K6b", k5, 15), ("linear", "K6a", k1, 21)):
        rc, out, secs = run_sweep(which, f"bf16_{which}")
        grid_n = module.run_grid_chunk.launches
        others = sum(c.launches for c in counters) - grid_n
        plain = sum(c.calls for c in plain_counters)
        launches[grid_label] = grid_n
        kline = [ln for ln in out.splitlines() if ln.startswith("[kernels]")]
        print("\n".join(kline + [ln for ln in out.splitlines() if ln.startswith("[sweep]")]))
        print(f"{which} bf16 sweep: rc {rc}, {secs:.2f} s, {grid_label} launches {grid_n}, other "
              f"launches {others}, plain chunks {plain}")
        require(rc == 0, f"{which} bf16 sweep returned 0")
        require(len(kline) == 1 and kline[0].startswith(f"[kernels] cuda: {grid_label}, the grid "
                                                        f"mode") and f"{rows} rows" in kline[0]
                and kline[0].endswith("with bf16-operand dots and bf16 Adam moments"),
                f"{which} bf16 sweep: the [kernels] line names {grid_label}, the CLI's default "
                f"bf16 dots and bf16 moments")
        require(grid_n == 4 and others == 0 and plain == 0,
                f"{which} bf16 sweep: one {grid_label} launch a chunk and nothing else")
        falling = 0
        for c in sweep.sweep_configs(which, data_dir, 12000, "cuda"):
            run_dir = os.path.join(data_dir, f"bf16_{which}", c.name)
            trace = np.load(os.path.join(run_dir, "losses.npz"))["VAE Loss"]
            require(bool(np.all(np.isfinite(trace))) and trace.shape == (12003,),
                    f"{c.name} bf16: finite loss trace of 12000 steps + 3 evals")
            falling += bool(trace[-100:].mean() < trace[0])
        require_bf16_state(f"{which} bf16 sweep", run_dir)
        print(f"{which} bf16: the last 100 steps' mean loss is below the step-0 eval's in "
              f"{falling} of {rows} runs")
        require(falling == rows, f"{which} bf16: every run's loss falls")

    # --- 25 -------------------------------------------------------------------
    phase(25, "K4 times: each kernel with f32 and bf16 moments in turn (f32, bf16, bf16, f32), "
              "and the bf16 plain versions")
    records = []
    timed = [(label, configs[label]) for label in ("K1", "K2", "K5", "K5-dual")]
    timed += [("K6a", families["linear"]), ("K6b", families["sphere"])]
    for label, cfg in timed:
        grid = label.startswith("K6")
        if grid:
            k_steps, p_steps = (5000 if label == "K6a" else 200), 2
            bufs = {a: cfg["pack"](cfg["states"]) for a in ("f32", "bf16")}
            mod, rows, kw = cfg["module"], cfg["rows"], cfg["kw"]
            pbufs = cfg["pack"](cfg["states"])

            def kernel_call(adam, bufs=bufs, mod=mod, rows=rows, kw=kw, k_steps=k_steps):
                mod.run_grid_chunk(*bufs[adam], rows, n_steps=k_steps, **kw, adam_dtype=adam)

            def plain_call(mod=mod, rows=rows, kw=kw, pbufs=pbufs):
                mod.plain_grid_chunk(*pbufs, rows, n_steps=2, **kw, adam_dtype="bf16")

            n_matrix = sum(int(k1.matrix_mask(lay).sum()) for lay in cfg["layouts"])
            state_bytes, rows_n = cfg["state_bytes"], len(rows)
        else:
            mlp = label.startswith("K5")
            k_steps, p_steps = (1000, 50) if mlp else (5000, 100)
            bufs = {a: cfg["pack"](state_of(cfg, True, a)[1]) for a in ("f32", "bf16")}
            model, pstate = state_of(cfg, True, "bf16", seeded=True)

            def kernel_call(adam, cfg=cfg, bufs=bufs, k_steps=k_steps):
                cfg["chunk"](cfg["kernel"], bufs[adam], k_steps, 0, True, None, adam)

            def plain_call(cfg=cfg, model=model, pstate=pstate, p_steps=p_steps):
                torch_step.train_chunk(model, cfg["ds"], pstate, p_steps, batch_size=B,
                                       lr=cfg["lr"])

            n_matrix = int(k1.matrix_mask(cfg["layout"]).sum())
            state_bytes = 6 * 4 * len(k1.matrix_mask(cfg["layout"]))
            rows_n = 1
        rates = {}
        for name, fn, n in (("plain", plain_call, p_steps),
                            ("f32", lambda: kernel_call("f32"), k_steps),
                            ("bf16", lambda: kernel_call("bf16"), k_steps),
                            ("bf16 2", lambda: kernel_call("bf16"), k_steps),
                            ("f32 2", lambda: kernel_call("f32"), k_steps),
                            ("plain 2", plain_call, p_steps)):
            rates[name] = _steps_per_second(torch, fn, n, 0.3)
        ms = {k: 1e3 / r for k, r in rates.items()}
        b_ms, f_ms = min(ms["bf16"], ms["bf16 2"]), min(ms["f32"], ms["f32 2"])
        p_ms = min(ms["plain"], ms["plain 2"])
        # K4's work: the kernel's, plus 4 operations a matrix element a step
        # (m and v each rounded to bf16 and widened back)
        bound = _bound(cfg["flops"] + 4 * n_matrix, state_bytes, k_steps, losses_per_step=rows_n)
        unit = "a launch-step" if grid else "a step"
        print(f"card: {smi}")
        print(f"{label}: f32 {ms['f32'] * 1e3:.3f} / {ms['f32 2'] * 1e3:.3f} us {unit}, bf16 "
              f"{ms['bf16'] * 1e3:.3f} / {ms['bf16 2'] * 1e3:.3f} us (bf16 / f32 "
              f"{b_ms / f_ms:.4f}); bf16 plain version {ms['plain']:.3f} / "
              f"{ms['plain 2']:.3f} ms; bound {bound['bound_ms'] * 1e3:.4f} us "
              f"({bound['bound_by']}), bf16 kernel at {100 * bound['bound_ms'] / b_ms:.3f}% "
              f"of it")
        source = "linear_vae.cu" if label in ("K1", "K2", "K6a") else "mlp_vae.cu"
        records.append({
            "name": f"K4 bf16 Adam moments in {label}", "route": "cuda",
            "source": f"vae_training_tpu_torch/csrc/{source}",
            "replaces": "vae_training_tpu/kernels/linear_vae.py:188",
            "launches": launches[label],
            "max_abs_err": errs[label if not grid else cfg["label"]],
            "ms": b_ms, "plain_ms": p_ms, **bound, "library_ms": None,
            "f32_ms": f_ms})
    return records


def _probes(torch, np, smi):
    """Phases 26–30: the probes T4, T3, T5 and T2 (csrc/probes.cu), each
    kernel against its plain version on the card, then the tool's own run
    through its entry point (the probes' main path; the launch counts are
    read around it) with its verdict; and T1's battery on the kernels'
    sampler. Returns their records for the kernels' JSON line."""
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import probes
    from vae_training_tpu_torch.kernels._build import load_library
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.tools import check_kernel_rng as t1
    from vae_training_tpu_torch.tools import check_precision as t2
    from vae_training_tpu_torch.tools import probe_adam_overlap as t5
    from vae_training_tpu_torch.tools import probe_mlp_interleave as t4
    from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3
    from vae_training_tpu_torch.ops.precision import bf16_round
    from vae_training_tpu_torch.tools._common import DOT_MODES, seconds_per_step, split_in_turns

    dev = torch.device("cuda")
    # the tools' default window is 1 s; T3-T5 run each form in both dot modes
    window = ["--device", "cuda", "--seconds", "0.25"]
    R, Wd = probes.ROWS, probes.W
    dot_flops = 2 * R * Wd * Wd

    def sync_cpu(*ts):
        torch.cuda.synchronize()
        return [t.cpu().numpy() for t in ts]

    def reset_counts():
        for fn in (probes.chain_chunk, probes.adam_overlap_chunk):
            for name in [n for n in vars(fn) if n.endswith("launches")]:
                setattr(fn, name, 0)
        probes.dot_modes.launches = 0
        k1.sampler_check.launches = k1.sampler_normals.launches = 0

    def rho(got, ref, other):
        """‖got − ref‖ / ‖other − ref‖ (bf16 dots: ref the plain bf16
        version, other the plain fp32 one)."""
        got, ref, other = (t.double() for t in (got, ref, other))
        return float((got - ref).norm() / (other - ref).norm())

    def wide_chain(xs, ws, n_steps, depth, weights_per_depth, epilogue):
        """The plain bf16 chain with each dot's f32 sums taken in float64
        and rounded once: another summation order, for the scale of the
        drift that rounding flips give any two orders on dense inputs."""
        h = xs
        for _ in range(n_steps):
            for d in range(depth):
                w = ws[:, d * Wd:(d + 1) * Wd] if weights_per_depth else ws
                h = (bf16_round(h).double() @ bf16_round(w).double()).float()
                if epilogue == "clamp":
                    h = torch.clamp(h, max=probes.CLAMP)
            if epilogue == "renorm":
                h = h * (1.0 / torch.clamp(h.abs().amax(dim=(1, 2), keepdim=True), min=1e-6))
        return h

    def dense_rho(xs, ws, form, ckw, wide=False):
        """(ρ of the form's bf16 dots, ρ of its fp32 instantiation (or, with
        ``wide``, of wide_chain), max |Δ| of the bf16 dots) against the
        plain bf16 version, the plain fp32 version the yardstick."""
        got = probes.chain_chunk(xs, ws, form=form, bf16_dots=True, **ckw)
        want = probes.plain_chain_chunk(xs, ws, bf16_dots=True, **ckw)
        f32 = probes.plain_chain_chunk(xs, ws, **ckw)
        other = wide_chain(xs, ws, **ckw) if wide else probes.chain_chunk(xs, ws, form=form,
                                                                          **ckw)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"{form} bf16 dots finite")
        return rho(got, want, f32), rho(other, want, f32), float((got - want).abs().max())

    def per_step_ms(fn, seconds=0.25):
        """ms a step of ``fn(n)`` (n steps), in a ≥ ``seconds`` window."""
        return 1e3 * seconds_per_step(fn, dev, seconds)[0]

    def chain_library(xs, ws, depth, per_depth, clamp):
        """The chain as one torch.matmul (+ clamp) a dot: the library's yardstick."""
        def run(n):
            h = xs
            for _ in range(n):
                for d in range(depth):
                    h = torch.matmul(h, ws[:, d * Wd:(d + 1) * Wd] if per_depth else ws)
                    if clamp:
                        h = torch.clamp(h, max=probes.CLAMP)
        return run

    records = []

    # --- 26 -------------------------------------------------------------------
    phase(26, "T4: chains of 24 dependent dots, phase and cluster forms, in fp32 and in the "
              "tool's bf16 dots, against the plain versions; then the tool in both modes")
    t_phase = time.perf_counter()
    _print_ptxas(load_library("probes")[1], only="chain_cluster")
    _print_ptxas(load_library("probes")[1], only="chain_phase")
    for n_chains in (1, 2, 4):
        print(f"T4 cluster plan, {n_chains} chain(s): {probes.chain_plan(n_chains)} (fp32; bf16 "
              f"dots {probes.CLUSTER_BF16_SMEM} bytes of shared memory, N over the warps)")
    t4_err = {f: 0.0 for f in probes.T4_FORMS}
    kw = dict(n_steps=3, depth=probes.T4_DEPTH, weights_per_depth=False, epilogue="clamp")
    for form in probes.T4_FORMS:
        for n_chains in (1, 2, 4):
            xs, ws = t4.inputs(n_chains, dev)
            got, want = sync_cpu(probes.chain_chunk(xs, ws, form=form, **kw),
                                 probes.plain_chain_chunk(xs, ws, **kw))
            require(bool(np.all(np.isfinite(got))), f"T4 {form} finite")
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"T4 {form} {n_chains}")
            t4_err[form] = max(t4_err[form], float(np.abs(got - want).max()))
            print(f"T4 {form:7s} {n_chains} chain(s), 3 steps: max |Δ| vs plain "
                  f"{float(np.abs(got - want).max()):.2e} (bitwise: {np.array_equal(got, want)})")
            # random inputs: a transposed or permuted slice, a misplaced
            # exchange or a dropped term fails here, not on the identity
            xs, ws = t4.check_inputs(n_chains, dev)
            rkw = dict(n_steps=1, depth=8, weights_per_depth=False, epilogue="clamp")
            got, want = sync_cpu(probes.chain_chunk(xs, ws, form=form, **rkw),
                                 probes.plain_chain_chunk(xs, ws, **rkw))
            require(bool(np.all(np.isfinite(got))), f"T4 {form} random finite")
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"T4 {form} {n_chains} random")
            t4_err[form] = max(t4_err[form], float(np.abs(got - want).max()))
            print(f"T4 {form:7s} {n_chains} chain(s), random inputs, 8 dots: max |Δ| vs plain "
                  f"{float(np.abs(got - want).max()):.2e} (rtol 1e-4, atol 1e-5)")
    # the cluster form launched twice: fixed sums, no atomics, the same bits
    random_kw = dict(n_steps=1, depth=8, weights_per_depth=False, epilogue="clamp")
    for bf16 in (False, True):
        for n_chains in (1, 2, 4):
            for inputs_of, ckw in ((t4.inputs, kw), (t4.check_inputs, random_kw)):
                xs, ws = inputs_of(n_chains, dev)
                a, b = sync_cpu(*(probes._chain_cluster_launch(
                    xs, ws, ckw["n_steps"], ckw["depth"], bf16_dots=bf16) for _ in range(2)))
                require(np.array_equal(a, b), f"T4 cluster form (bf16 dots {bf16}), {n_chains} "
                                              "chain(s): two launches give the same bits")
    print("T4 cluster form: two launches bitwise equal (1, 2, 4 chains; both inputs; both "
          "dot modes)")
    # bf16 dots, the TPU tool's own mode (every dot of bf16-rounded operands,
    # f32 sums, on the tensor cores): the tool's inputs (3 steps) and
    # two_term_inputs (2 steps) bitwise; dense random inputs one dot deep at
    # ρ ≤ 1e-3, the fp32 instantiation at ρ ≥ 0.5. Deeper, dense chains part
    # between any two summation orders (a last-bit difference flips a
    # rounding to bf16, which moves the next dot's every output): 8 dots'
    # ρ is printed beside the plain chain's under float64 sums, and held to
    # nothing
    t4_bf = {f: {"err": 0.0, "rho": 0.0, "rho_8": 0.0} for f in probes.T4_FORMS}
    one = dict(n_steps=1, depth=1, weights_per_depth=False, epilogue="clamp")
    two = dict(n_steps=2, depth=probes.T4_DEPTH, weights_per_depth=False, epilogue="clamp")
    for form in probes.T4_FORMS:
        for n_chains in (1, 2, 4):
            for inputs_of, ckw in ((t4.inputs, kw), (t4.two_term_inputs, two)):
                xs, ws = inputs_of(n_chains, dev)
                got = probes.chain_chunk(xs, ws, form=form, bf16_dots=True, **ckw)
                want = probes.plain_chain_chunk(xs, ws, bf16_dots=True, **ckw)
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"T4 {form} bf16 dots, {n_chains} chain(s), "
                                                f"{inputs_of.__name__}: bitwise the plain version")
            xs, ws = t4.check_inputs(n_chains, dev)
            r, rc, err = dense_rho(xs, ws, form, one)
            r8, rw8, _ = dense_rho(xs, ws, form, random_kw, wide=True)
            require(r <= 1e-3 and rc >= 0.5, f"T4 {form} bf16 dots, {n_chains} chain(s), one "
                                             f"dot: ρ {r:.2e} <= 1e-3, fp32's {rc:.3f} >= 0.5")
            st = t4_bf[form]
            st["err"], st["rho"], st["rho_8"] = max(st["err"], err), max(st["rho"], r), max(
                st["rho_8"], r8)
            print(f"T4 {form:7s} bf16 dots, {n_chains} chain(s): the tool's inputs (3 steps) and "
                  f"two-term inputs (2 steps) bitwise the plain version; random inputs, one dot: "
                  f"ρ {r:.2e} (the fp32 instantiation {rc:.3f}), max |Δ| {err:.2e}; 8 dots: ρ "
                  f"{r8:.3f} (the plain chain under float64 sums {rw8:.3f})")
    reset_counts()
    t4_report = t4.main(window)
    t4_launches = {"fp32": {"phase": probes.chain_chunk.launches,
                            "cluster": probes.chain_chunk.cluster_launches},
                   "bf16": {"phase": probes.chain_chunk.bf16_launches,
                            "cluster": probes.chain_chunk.bf16_cluster_launches}}
    print(f"T4 tool launches: {t4_launches}")
    xs, ws = t4.inputs(1, dev)
    t4_plain = {mode: per_step_ms(lambda n, b=bf16: probes.plain_chain_chunk(
        xs, ws, n_steps=n, depth=probes.T4_DEPTH, weights_per_depth=False, epilogue="clamp",
        bf16_dots=b)) for mode, bf16 in DOT_MODES.items()}
    t4_lib_call = per_step_ms(chain_library(xs, ws, probes.T4_DEPTH, False, True))
    # the library's step in device time: 20 steps (480 dots) in one CUDA
    # graph; in bf16, torch.matmul on bf16 operands (bf16 out)
    operands = {"fp32": (xs, ws), "bf16": (xs.bfloat16(), ws.bfloat16())}
    t4_lib = {mode: _device_us(torch, lambda m=mode: chain_library(
        *operands[m], probes.T4_DEPTH, False, True)(1), calls=20) / 1e3 for mode in DOT_MODES}
    # a step: 24 dots; x and w read and h written once (counted as if a
    # call ran one step: the bound stays the operations')
    bounds = {mode: _bound(probes.T4_DEPTH * dot_flops, 4 * (2 * R * Wd + Wd * Wd), 1,
                           losses_per_step=0, peak=BF16_PEAK if bf16 else FP32_PEAK)
              for mode, bf16 in DOT_MODES.items()}
    print(f"card: {smi}")
    for mode in DOT_MODES:
        b = bounds[mode]
        print(f"T4 one chain, {mode} dots: plain {t4_plain[mode] * 1e3:.2f} us/step, "
              f"torch.matmul + clamp {t4_lib[mode] * 1e3:.2f} us/step device time, bound "
              f"{b['bound_ms'] * 1e3:.3f} us/step ({b['bound_by']})"
              + (f" ({t4_lib_call * 1e3:.2f} in Python calls, one a dot)" if mode == "fp32"
                 else ""))
    # the cluster form's step split by launch variants that stop each dot
    # after the products, after the sums into the CTA's own h, or run whole
    # (and one that stages W and x only), in turns, at 1, 2 and 4 chains
    # (bf16 dots: at 1); device time, 10 steps a launch
    t4_split = {"fp32": {}, "bf16": {}}
    configs = (("fp32", 1), ("fp32", 2), ("fp32", 4), ("bf16", 1))
    t4_in = {n: t4.inputs(n, dev) for n in (1, 2, 4)}
    got = split_in_turns({f"{m} {n}": lambda u, m=m, n=n: probes._chain_cluster_launch(
        *t4_in[n], 10, probes.T4_DEPTH, u, bf16_dots=m == "bf16") for m, n in configs},
        probes.CHAIN_UPTO, 1 / 10)
    for mode, n_chains in configs:
        sp = t4_split[mode][n_chains] = got[f"{mode} {n_chains}"]
        print(f"T4 cluster split, {mode} dots, {n_chains} chain(s), us a step (device time, min "
              f"of two): staging {sp['stage']:.2f} (a launch of 10 steps / 10), + products "
              f"{sp['products']:.2f}, + store {sp['store']:.2f}, whole {sp['all']:.2f}; so "
              f"products {sp['products'] - sp['stage']:.2f}, store ("
              f"{'the sums' if mode == 'fp32' else 'clamp and rounding'}) "
              f"{sp['store'] - sp['products']:.2f}, push and wait {sp['all'] - sp['store']:.2f}")
    cluster_wf = probes.cluster_wavefronts()
    print(f"T4 cluster, bf16 dots: {cluster_wf['total']} shared-memory wavefronts a warp a dot "
          f"(ldmatrix {cluster_wf['ldmatrix']}, stores {cluster_wf['stores']}; the 32-bank model "
          f"of kernels/probes.py, not a measurement)")
    # the bound on the SMs one chain's cluster uses (the card's is the bound)
    chain_sms = probes.chain_plan(1).cluster
    card_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chain_bound_ms = {m: b["bound_ms"] * card_sms / chain_sms for m, b in bounds.items()}
    print(f"T4 bound on one chain's {chain_sms} SMs: fp32 {chain_bound_ms['fp32'] * 1e3:.3f}, "
          f"bf16 dots {chain_bound_ms['bf16'] * 1e3:.3f} us/step")
    # the phase form's cuts, and chain 0's bits alone and beside 3 more
    # chains (the sums' order must not depend on the chain count)
    for mode, bf16 in DOT_MODES.items():
        units = {n: probes.phase_units(n, card_sms, bf16_dots=bf16) for n in (1, 4)}
        cols, slots, over = ((probes.PHASE_COLS, probes.PHASE_SLOTS, "warps") if bf16 else
                             (probes.PHASE_COLS_FP32, probes.PHASE_SLOTS_FP32, "half-warps"))
        print(f"T4/T3/T5 phase form, {mode} cut: units of 16 rows x {cols} columns, K over "
              f"{probes.PHASE_K_SPLIT} {over} of {Wd // probes.PHASE_K_SPLIT} k, {slots} units a "
              f"CTA a round on {card_sms} CTAs: "
              + ", ".join(f"{n} chain(s) {len(u)} units in {1 + max(x['round'] for x in u)} "
                          "round(s)" for n, u in units.items()))
    xs, ws = t4.check_inputs(4, dev)
    for bf16 in (True, False):
        for ckw in (one, random_kw):
            a = probes.chain_chunk(xs, ws, form="phase", bf16_dots=bf16, **ckw)
            a2 = probes.chain_chunk(xs, ws, form="phase", bf16_dots=bf16, **ckw)
            b = probes.chain_chunk(xs[:1], ws[:1], form="phase", bf16_dots=bf16, **ckw)[0]
            torch.cuda.synchronize()
            mode = "bf16" if bf16 else "fp32"
            require(torch.equal(a[0], b), f"T4 phase {mode} dots, {ckw['depth']} dot(s): chain 0 "
                                          "of 4 chains bitwise chain 0 alone")
            require(torch.equal(a, a2), f"T4 phase {mode} dots, {ckw['depth']} dot(s): two "
                                        "launches give the same bits")
    print("T4 phase form, both dot modes: chain 0 of 4 chains bitwise chain 0 alone, two launches "
          "bitwise equal (1 and 8 dots)")
    # the phase form's dot split by launch variants (the grid barriers alone,
    # the phases' work without them, whole), in turns, at 1 and 4 chains in
    # both dot modes; device time, 4 steps a launch
    phase_split = _phase_split(torch, probes, dev, "T4", lambda n: t4.inputs(n, dev),
                               dict(n_steps=4, depth=probes.T4_DEPTH, weights_per_depth=False,
                                    epilogue="clamp"))
    for form in probes.T4_FORMS:
        us = {mode: t4_report[mode][form]["us_per_step"] for mode in DOT_MODES}
        print(f"T4 {form} one chain, us a step, bf16 / fp32 dots (the tool's windows, in turn): "
              f"{min(us['bf16'][1]):.3f} / {min(us['fp32'][1]):.3f}")
        for mode in DOT_MODES:
            require(t4_launches[mode][form] > 0,
                    f"T4's {form} kernel ({mode} dots) launched in the tool's run")
        records.append({
            "name": f"chain_{form}_kernel (T4, {form} form)", "route": "cuda",
            "source": "vae_training_tpu_torch/csrc/probes.cu",
            "replaces": "tools/probe_mlp_interleave.py:62", "launches": t4_launches["fp32"][form],
            "max_abs_err": t4_err[form], "ms": min(us["fp32"][1]) / 1e3,
            "plain_ms": t4_plain["fp32"], **bounds["fp32"], "library_ms": t4_lib["fp32"],
            "library_call_ms": t4_lib_call,
            "us_per_step_by_chains": {c: min(v) for c, v in us["fp32"].items()},
            "verdict": t4_report["fp32"][form]["verdict"],
            **({"split_us_per_step": t4_split["fp32"],
                "bound_chain_sms_ms": chain_bound_ms["fp32"]} if form == "cluster" else
               {"split_ns_per_dot": phase_split["fp32"]})})
        records.append({
            "name": f"chain_{form}_kernel<bf16> (T4, {form} form), bf16 dots", "route": "cuda",
            "source": "vae_training_tpu_torch/csrc/probes.cu",
            "replaces": "tools/probe_mlp_interleave.py:62", "launches": t4_launches["bf16"][form],
            "max_abs_err": t4_bf[form]["err"], "ms": min(us["bf16"][1]) / 1e3,
            "plain_ms": t4_plain["bf16"], **bounds["bf16"], "library_ms": t4_lib["bf16"],
            "us_per_step_by_chains": {c: min(v) for c, v in us["bf16"].items()},
            "verdict": t4_report["bf16"][form]["verdict"], "rho_one_dot": t4_bf[form]["rho"],
            "rho_8_dots": t4_bf[form]["rho_8"], "fp32_dots_ms": min(us["fp32"][1]) / 1e3,
            **({"split_us_per_step": t4_split["bf16"],
                "bound_chain_sms_ms": chain_bound_ms["bf16"]} if form == "cluster" else
               {"split_ns_per_dot": phase_split["bf16"]})})
    print(f"T4 one chain: phase, fp32 dots {min(t4_report['fp32']['phase']['us_per_step'][1]):.3f} "
          f"us a step; cluster, bf16 dots {min(t4_report['bf16']['cluster']['us_per_step'][1]):.3f}")
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s")

    # --- 27 -------------------------------------------------------------------
    phase(27, "T3: chains of 8 dots with distinct weights, renormalised a trip, phase and "
              "stream forms, in fp32 and in the tool's bf16 dots, against the plain versions; "
              "then the tool in both modes")
    t_phase = time.perf_counter()
    _print_ptxas(load_library("probes")[1], only="chain_stream")
    stream_sms = probes.CHAIN_CLUSTER  # one chain's cluster
    t3_err = {f: 0.0 for f in probes.T3_FORMS}
    kw = dict(n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")
    for form in probes.T3_FORMS:
        for n_chains in (1, 2, 4):
            xs, ws = t3.inputs(n_chains, dev)
            got, want = sync_cpu(probes.chain_chunk(xs, ws, form=form, **kw),
                                 probes.plain_chain_chunk(xs, ws, **kw))
            require(bool(np.all(np.isfinite(got))), f"T3 {form} finite")
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"T3 {form} {n_chains}")
            t3_err[form] = max(t3_err[form], float(np.abs(got - want).max()))
            print(f"T3 {form:6s} {n_chains} chain(s), 2 trips: max |Δ| vs plain "
                  f"{float(np.abs(got - want).max()):.2e} (rtol 1e-4, atol 1e-5)")
    for bf16 in (False, True):
        for n_chains in (1, 2, 4):  # fixed sums, no atomics: the same bits twice
            xs, ws = t3.inputs(n_chains, dev)
            a, b = sync_cpu(*(probes._stream_launch("t3", xs, ws, None, None, 2, bf16_dots=bf16)
                              for _ in range(2)))
            require(np.array_equal(a, b), f"T3 stream (bf16 dots {bf16}), {n_chains} chain(s): "
                                          "two launches, same bits")
    print("T3 stream form: two launches bitwise equal (1, 2, 4 chains; both dot modes)")
    # bf16 dots: two_term_inputs, 2 trips, bitwise; dense inputs one dot deep
    # (the phase form; a stream launch runs whole trips of 8) at ρ ≤ 1e-3;
    # 2 dense trips' drift printed, as phase 26's (a rounding flip in the
    # element that sets a chain's max|y| rescales the whole chain)
    t3_bf = {f: {"err": 0.0, "rho": 0.0, "rho_16": 0.0} for f in probes.T3_FORMS}
    one = dict(n_steps=1, depth=1, weights_per_depth=True, epilogue="renorm")
    for form in probes.T3_FORMS:
        for n_chains in (1, 2, 4):
            xs, ws = t3.two_term_inputs(n_chains, dev)
            got = probes.chain_chunk(xs, ws, form=form, bf16_dots=True, **kw)
            want = probes.plain_chain_chunk(xs, ws, bf16_dots=True, **kw)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"T3 {form} bf16 dots, {n_chains} chain(s), two-term "
                                            "inputs, 2 trips: bitwise the plain version")
            xs, ws = t3.inputs(n_chains, dev)
            st = t3_bf[form]
            # one dense dot: the phase form on the first weight; a stream
            # launch runs whole trips, so 7 identities then the first weight
            # (an identity dot of bf16 operands only rounds h, exactly)
            if form == "phase":
                r, rc, err = dense_rho(xs, ws[:, :Wd].contiguous(), form, one)
            else:
                r, rc, err = dense_rho(*t3.dense_trip_inputs(n_chains, dev), form,
                                       dict(kw, n_steps=1))
            require(r <= 1e-3 and rc >= 0.5, f"T3 {form} bf16 dots, one dense dot: ρ {r:.2e} <= "
                                             f"1e-3, fp32's {rc:.3f} >= 0.5")
            st["err"], st["rho"] = max(st["err"], err), max(st["rho"], r)
            line = (f"; one dense dot{'' if form == 'phase' else ' (a trip of 7 identities and it)'}"
                    f": ρ {r:.2e} (the fp32 instantiation {rc:.3f}), max |Δ| {err:.2e}")
            r16, rw16, _ = dense_rho(xs, ws, form, kw, wide=True)
            st["rho_16"] = max(st["rho_16"], r16)
            print(f"T3 {form:6s} bf16 dots, {n_chains} chain(s): two-term inputs (2 trips) bitwise "
                  f"the plain version{line}; random inputs, 2 trips: ρ {r16:.3f} (the plain chain "
                  f"under float64 sums {rw16:.3f})")
    reset_counts()
    t3_report = t3.main(window)
    t3_launches = {"fp32": {"phase": probes.chain_chunk.launches,
                            "stream": probes.chain_chunk.stream_launches},
                   "bf16": {"phase": probes.chain_chunk.bf16_launches,
                            "stream": probes.chain_chunk.bf16_stream_launches}}
    print(f"T3 tool launches: {t3_launches}")
    xs, ws = t3.inputs(1, dev)
    per_dot = 1.0 / probes.T3_DEPTH
    t3_plain = {mode: per_dot * per_step_ms(lambda n, b=bf16: probes.plain_chain_chunk(
        xs, ws, n_steps=n, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm",
        bf16_dots=b)) for mode, bf16 in DOT_MODES.items()}
    t3_lib_call = per_dot * per_step_ms(chain_library(xs, ws, probes.T3_DEPTH, True, False))
    # the library's dot in device time: 25 trips (200 dots) in one CUDA
    # graph; in bf16, torch.matmul on bf16 operands (bf16 out)
    operands = {"fp32": (xs, ws), "bf16": (xs.bfloat16(), ws.bfloat16())}
    t3_lib = {mode: per_dot * _device_us(torch, lambda m=mode: chain_library(
        *operands[m], probes.T3_DEPTH, True, False)(1), calls=25) / 1e3 for mode in DOT_MODES}
    # a dot: its weight read, h read and written once
    bounds = {mode: _bound(dot_flops, 4 * (2 * R * Wd + Wd * Wd), 1, losses_per_step=0,
                           peak=BF16_PEAK if bf16 else FP32_PEAK)
              for mode, bf16 in DOT_MODES.items()}
    t3_chain_bound = {m: b["bound_ms"] * card_sms / stream_sms for m, b in bounds.items()}
    print(f"card: {smi}")
    for mode in DOT_MODES:
        b = bounds[mode]
        print(f"T3 one chain, {mode} dots: plain {t3_plain[mode] * 1e6:.1f} ns/dot, "
              f"torch.matmul {t3_lib[mode] * 1e6:.1f} ns/dot device time, bound "
              f"{b['bound_ms'] * 1e6:.1f} ns/dot ({b['bound_by']}), on a chain's {stream_sms} SMs "
              f"{t3_chain_bound[mode] * 1e6:.1f}"
              + (f" ({t3_lib_call * 1e6:.1f} a Python call)" if mode == "fp32" else ""))
    # the stream form's dot split by launch variants (the weights streamed
    # alone; the products alone, from a ring filled once; the products with
    # the stream; + sums and the row exchange; whole), in turns, at 1, 2 and
    # 4 chains (bf16 dots: at 1); device time, 20 trips a launch
    t3_split = {"fp32": {}, "bf16": {}}
    t3_in = {n: t3.inputs(n, dev) for n in (1, 2, 4)}
    got = split_in_turns({f"{m} {n}": lambda u, m=m, n=n: probes._stream_launch(
        "t3", *t3_in[n], None, None, 20, upto=u, bf16_dots=m == "bf16") for m, n in configs},
        probes.STREAM_UPTO, 1e3 / (20 * probes.T3_DEPTH))
    for mode, n_chains in configs:
        sp = t3_split[mode][n_chains] = got[f"{mode} {n_chains}"]
        print(f"T3 stream split, {mode} dots, {n_chains} chain(s), ns a dot (device time, min of "
              f"two): weights alone {sp['weights']:.1f}, products alone {sp['compute']:.1f}, "
              f"products with the stream {sp['products']:.1f} (the stream adds "
              f"{sp['products'] - sp['compute']:.1f}), + sums and exchange "
              f"{sp['exchange'] - sp['products']:.1f}, + renorm "
              f"{sp['all'] - sp['exchange']:.1f}: whole {sp['all']:.1f}")
    t3_phase_split = _phase_split(torch, probes, dev, "T3", lambda n: t3.inputs(n, dev),
                                  dict(n_steps=12, depth=probes.T3_DEPTH, weights_per_depth=True,
                                       epilogue="renorm"))
    for form in probes.T3_FORMS:
        rep = {mode: t3_report[mode][form] for mode in DOT_MODES}
        print(f"T3 {form} one chain, ns a dot, bf16 / fp32 dots (the tool's windows, in turn): "
              f"{rep['bf16']['ns_per_dot'][1]:.1f} / {rep['fp32']['ns_per_dot'][1]:.1f}")
        for mode in DOT_MODES:
            require(t3_launches[mode][form] > 0,
                    f"T3's {form} kernel ({mode} dots) launched in the tool's run")
        records.append({
            "name": f"chain_{form}_kernel (T3, distinct weights)", "route": "cuda",
            "source": "vae_training_tpu_torch/csrc/probes.cu",
            "replaces": "tools/probe_mxu_pipelining.py:82", "launches": t3_launches["fp32"][form],
            "max_abs_err": t3_err[form], "ms": rep["fp32"]["ns_per_dot"][1] / 1e6,
            "plain_ms": t3_plain["fp32"], **bounds["fp32"], "library_ms": t3_lib["fp32"],
            "library_call_ms": t3_lib_call, "ns_per_dot_by_chains": rep["fp32"]["ns_per_dot"],
            "speedup_x2": rep["fp32"]["x2"], "speedup_x4": rep["fp32"]["x4"],
            **({"split_ns_per_dot": t3_split["fp32"],
                "bound_chain_sms_ms": t3_chain_bound["fp32"]} if form == "stream" else
               {"split_ns_per_dot": t3_phase_split["fp32"]})})
        records.append({
            "name": f"chain_{form}_kernel<bf16> (T3, distinct weights), bf16 dots",
            "route": "cuda", "source": "vae_training_tpu_torch/csrc/probes.cu",
            "replaces": "tools/probe_mxu_pipelining.py:82", "launches": t3_launches["bf16"][form],
            "max_abs_err": t3_bf[form]["err"], "ms": rep["bf16"]["ns_per_dot"][1] / 1e6,
            "plain_ms": t3_plain["bf16"], **bounds["bf16"], "library_ms": t3_lib["bf16"],
            "ns_per_dot_by_chains": rep["bf16"]["ns_per_dot"], "speedup_x2": rep["bf16"]["x2"],
            "speedup_x4": rep["bf16"]["x4"], "rho_2_trips": t3_bf[form]["rho_16"],
            "fp32_dots_ms": rep["fp32"]["ns_per_dot"][1] / 1e6, "rho_one_dot": t3_bf[form]["rho"],
            **({"split_ns_per_dot": t3_phase_split["bf16"]} if form == "phase" else
               {"split_ns_per_dot": t3_split["bf16"],
                "bound_chain_sms_ms": t3_chain_bound["bf16"]})})
    print(f"T3 phase one chain, fp32 dots: {t3_report['fp32']['phase']['ns_per_dot'][1]:.1f} ns a "
          f"dot, torch.matmul {t3_lib['fp32'] * 1e6:.1f}")
    print(f"T3 stream, bf16 dots: products alone {t3_split['bf16'][1]['compute']:.1f} ns a dot; the "
          f"32-bank model of kernels/probes.py, not a measurement: "
          f"{probes.stream_product_wavefronts()['total']} shared-memory wavefronts a warp a dot")
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s")

    # --- 28 -------------------------------------------------------------------
    phase(28, "T5: 25 dots and Adam on 5 buffers, tail and interleaved, phase and stream "
              "forms, in fp32 and in the tool's bf16 dots, against the plain versions; then "
              "the tool (tail, interleaved, interleaved, tail; each form and dot mode)")
    t_phase = time.perf_counter()
    print(f"h at {MLP_TOL['params']} (rtol, atol), tests/test_mlp_kernel.py's; what Adam "
          f"changed in w, m and v at rtol {t5.DELTA_RTOL}, atol {t5.DELTA_RTOL} of the plain "
          f"version's largest change; bf16 dots (2 steps): h at ρ <= 0.1 of the plain bf16 "
          f"version, the fp32 instantiation at ρ >= 0.5")
    t5_err = {(f, il, m): 0.0 for f in probes.T5_FORMS for il in (False, True) for m in DOT_MODES}
    t5_rho = {(f, il): 0.0 for f in probes.T5_FORMS for il in (False, True)}
    for form in probes.T5_FORMS:
        for mode, bf16 in (("fp32", False), ("bf16", True)):
            n_steps = 2 if bf16 else 3
            for inputs_of, label in ((t5.inputs, "the tool's inputs"),
                                     (t5.check_inputs, "check inputs")):
                for interleave in (False, True):
                    kb = inputs_of(dev)
                    pb, start, other, fb, cb = (tuple(t.clone() for t in kb) for _ in range(5))
                    step_kw = dict(n_steps=n_steps, interleave=interleave)
                    h = probes.adam_overlap_chunk(*kb, form=form, bf16_dots=bf16, **step_kw)
                    ph = probes.plain_adam_overlap_chunk(*pb, bf16_dots=bf16, **step_kw)
                    probes.plain_adam_overlap_chunk(*other, n_steps=n_steps,
                                                    interleave=not interleave, bf16_dots=bf16)
                    a, b = sync_cpu(h, ph)
                    require(bool(np.all(np.isfinite(a))), "T5 h finite")
                    extra = ""
                    if bf16:
                        fh = probes.plain_adam_overlap_chunk(*fb, **step_kw)
                        ctrl = probes.adam_overlap_chunk(*cb, form=form, **step_kw)
                        r, rc = rho(h, ph, fh), rho(ctrl, ph, fh)
                        require(r <= 0.1 and rc >= 0.5,
                                f"T5 {form} bf16 dots {label} interleave={interleave}: h ρ "
                                f"{r:.2e} <= 0.1, the fp32 instantiation's {rc:.3f} >= 0.5")
                        t5_rho[form, interleave] = max(t5_rho[form, interleave], r)
                        extra = f"; h ρ {r:.2e} (the fp32 instantiation {rc:.3f})"
                    else:
                        np.testing.assert_allclose(a, b, *MLP_TOL["params"],
                                                   err_msg=f"T5 {form} h {interleave}")
                    errs, mism = [float(np.abs(a - b).max())], []
                    for name, got, ref, s0, o in zip("wmv", kb[1:], pb[1:], start[1:],
                                                     other[1:]):
                        require(bool(torch.isfinite(got).all()), f"T5 {name} finite")
                        mm = t5.delta_mismatch(got, ref, s0)
                        require(mm <= t5.DELTA_RTOL,
                                f"T5 {form} {mode} dots {label} interleave={interleave}: "
                                f"Δ{name} mismatch {mm:.3e} <= {t5.DELTA_RTOL}")
                        # controls: Adam dropped, and the other variant's gradients
                        require(t5.delta_mismatch(s0, ref, s0) > 100 * t5.DELTA_RTOL,
                                f"T5 Δ{name}: the state left as it was fails the comparison")
                        if inputs_of is t5.check_inputs and not bf16:
                            require(t5.delta_mismatch(o, ref, s0) > 10 * t5.DELTA_RTOL,
                                    f"T5 Δ{name}: the other variant fails the comparison")
                        errs.append(float((got - ref).abs().max()))
                        mism.append(mm)
                    t5_err[form, interleave, mode] = max(t5_err[form, interleave, mode], *errs)
                    print(f"T5 {form:6s} {mode} dots, {label}, interleave={interleave!s:5}, "
                          f"{n_steps} steps: max |Δ| h {errs[0]:.2e} w {errs[1]:.2e} m "
                          f"{errs[2]:.2e} v {errs[3]:.2e}; Adam's change mismatch w {mism[0]:.2e} "
                          f"m {mism[1]:.2e} v {mism[2]:.2e}{extra}")
    for bf16 in (False, True):
        for mode in ("tail", "interleaved"):  # fixed sums, no atomics: the same bits twice
            runs = []
            for _ in range(2):
                x, ws, ms, vs = t5.check_inputs(dev)
                runs.append((probes._stream_launch(mode, x[None], ws, ms, vs, 3, bf16_dots=bf16),
                             ws, ms, vs))
            torch.cuda.synchronize()
            require(all(torch.equal(p, q) for p, q in zip(*runs)),
                    f"T5 stream {mode} (bf16 dots {bf16}): two launches give the same h, w, m, v")
    print("T5 stream form: two launches bitwise equal (tail, interleaved; h, w, m, v; both dot "
          "modes)")
    reset_counts()
    t5_report = t5.main(window)
    t5_launches = {"fp32": {"phase": probes.adam_overlap_chunk.launches,
                            "stream": probes.adam_overlap_chunk.stream_launches},
                   "bf16": {"phase": probes.adam_overlap_chunk.bf16_launches,
                            "stream": probes.adam_overlap_chunk.bf16_stream_launches}}
    print(f"T5 tool launches: {t5_launches}")
    n_dots, n_w = probes.N_BUF * probes.DOTS_PER_BUF, probes.N_BUF * Wd * Wd
    # a step: 25 dots, 5 column means of h, Adam's ~12 operations an element;
    # h read and written, w, m and v read and written once (7.9 MB, which
    # L2 holds: the bound is the operations'). In bf16 dots the dots at the
    # bf16 peak, the column means and Adam at the fp32 one
    rest_flops = probes.N_BUF * R * Wd + 12 * n_w
    flops = n_dots * dot_flops + rest_flops
    t5_bytes = 4 * (2 * R * Wd + 6 * n_w)
    bounds = {"fp32": _bound(flops, t5_bytes, 1, losses_per_step=0),
              "bf16": _bound(n_dots * dot_flops, t5_bytes, 1, losses_per_step=0, peak=BF16_PEAK,
                             fp32_flops_per_step=rest_flops)}
    t5_chain_bound = {m: b["bound_ms"] * card_sms / stream_sms for m, b in bounds.items()}
    t5_plain = {}
    for mode, bf16 in DOT_MODES.items():
        for interleave in (False, True):
            kb = t5.inputs(dev)
            t5_plain[mode, interleave] = per_step_ms(
                lambda n, kb=kb, i=interleave, b=bf16: probes.plain_adam_overlap_chunk(
                    *kb, n_steps=n, interleave=i, bf16_dots=b))
    print(f"card: {smi}")
    for mode in DOT_MODES:
        b = bounds[mode]
        print(f"T5 {mode} dots: plain tail {t5_plain[mode, False]:.3f} ms/step, interleaved "
              f"{t5_plain[mode, True]:.3f} ms/step; bound {b['bound_ms'] * 1e3:.3f} us/step "
              f"({b['bound_by']}, {flops / 1e6:.1f} MFLOP), on the cluster's {stream_sms} SMs "
              f"{t5_chain_bound[mode] * 1e3:.3f}")
    # the stream form's step split by launch variants (as phase 27's, whole
    # with Adam), in turns; device time, 4 steps a launch; both dot modes.
    # Then the phase form's (tail): the barriers alone, the work alone, whole
    t5_split = {"fp32": {}, "bf16": {}}
    t5_in = {(dots, mode): t5.inputs(dev) for dots in DOT_MODES for mode in ("tail", "interleaved")}
    got = split_in_turns({f"{dots} {mode}": lambda u, d=dots, m=mode: probes._stream_launch(
        m, t5_in[d, m][0][None], *t5_in[d, m][1:], 4, upto=u, bf16_dots=DOT_MODES[d])
        for dots, mode in t5_in}, probes.STREAM_UPTO, 1 / 4)
    for dots, mode in t5_in:
        sp = t5_split[dots][mode] = got[f"{dots} {mode}"]
        print(f"T5 stream split, {mode}, {dots} dots, us a step (device time, min of two): "
              f"weights alone {sp['weights']:.2f}, products alone {sp['compute']:.2f}, "
              f"products with the stream {sp['products']:.2f} (the stream adds "
              f"{sp['products'] - sp['compute']:.2f}), + sums and exchange "
              f"{sp['exchange'] - sp['products']:.2f}, + Adam "
              f"{sp['all'] - sp['exchange']:.2f}: whole {sp['all']:.2f}")
    kb = t5.inputs(dev)
    t5_phase_split = split_in_turns({dots: lambda u, b=bf16: probes._phase_launch(
        kb[0][None], kb[1], 2, n_dots, False, "clamp", 1, kb[2], kb[3], upto=u, bf16_dots=b)
        for dots, bf16 in DOT_MODES.items()}, probes.PHASE_UPTO, 1 / 2)
    for dots, sp in t5_phase_split.items():
        print(f"T5 phase split, tail, {dots} dots, us a step (device time, min of two): the grid "
              f"barriers alone {sp['barriers']:.2f}, the work alone {sp['work']:.2f}, whole "
              f"{sp['all']:.2f}")
    for form in probes.T5_FORMS:
        for mode in DOT_MODES:
            require(t5_launches[mode][form] > 0,
                    f"T5's {form} kernel ({mode} dots) launched in the tool's run")
        rep = {mode: t5_report[mode][form] for mode in DOT_MODES}
        print(f"T5 {form}, us a step, bf16 / fp32 dots (the tool's windows, in turn): tail "
              f"{min(rep['bf16']['us_per_step']['tail']):.3f} / "
              f"{min(rep['fp32']['us_per_step']['tail']):.3f}, interleaved "
              f"{min(rep['bf16']['us_per_step']['interleaved']):.3f} / "
              f"{min(rep['fp32']['us_per_step']['interleaved']):.3f}")
        for interleave, label in ((False, "tail"), (True, "interleaved")):
            records.append({
                "name": f"chain_{form}_kernel (T5, Adam {label})", "route": "cuda",
                "source": "vae_training_tpu_torch/csrc/probes.cu",
                "replaces": "tools/probe_adam_overlap.py:110",
                "launches": t5_launches["fp32"][form],
                "max_abs_err": t5_err[form, interleave, "fp32"],
                "ms": min(rep["fp32"]["us_per_step"][label]) / 1e3,
                "plain_ms": t5_plain["fp32", interleave], **bounds["fp32"], "library_ms": None,
                "interleaved_over_tail": rep["fp32"]["ratio"],
                **({"split_us_per_step": t5_split["fp32"][label],
                    "bound_chain_sms_ms": t5_chain_bound["fp32"]} if form == "stream" else
                   {"split_us_per_step_tail": t5_phase_split["fp32"]})})
            records.append({
                "name": f"chain_{form}_kernel<bf16> (T5, Adam {label}), bf16 dots",
                "route": "cuda", "source": "vae_training_tpu_torch/csrc/probes.cu",
                "replaces": "tools/probe_adam_overlap.py:110",
                "launches": t5_launches["bf16"][form],
                "max_abs_err": t5_err[form, interleave, "bf16"],
                "ms": min(rep["bf16"]["us_per_step"][label]) / 1e3,
                "plain_ms": t5_plain["bf16", interleave], **bounds["bf16"], "library_ms": None,
                "interleaved_over_tail": rep["bf16"]["ratio"],
                "rho_h_2_steps": t5_rho[form, interleave],
                "fp32_dots_ms": min(rep["fp32"]["us_per_step"][label]) / 1e3,
                **({"split_us_per_step": t5_split["bf16"][label],
                    "bound_chain_sms_ms": t5_chain_bound["bf16"]} if form == "stream" else
                   {"split_us_per_step_tail": t5_phase_split["bf16"]})})
            if form == "phase":
                print(f"T5 phase {label}, fp32 dots: {min(rep['fp32']['us_per_step'][label]):.3f} "
                      "us a step")
    print(f"phase 28: {time.perf_counter() - t_phase:.1f} s")

    # --- 29 -------------------------------------------------------------------
    phase(29, "T2: one (128x256)·(256x256) dot in fp32, TF32 and bf16 modes against the "
              "plain versions and a float64 host product; library times; the kernel's split")
    _print_ptxas(load_library("probes")[1], only="dot_kernel")
    M, K, N = t2.M, t2.K, t2.N
    for mode in probes.MODES:
        plan = probes.dot_plan(M, K, N, mode)
        require(probes.library_dot_plan(M, K, N, mode) == plan, f"T2 {mode}: the library's plan")
        print(f"T2 {mode} plan: {plan}")
    shapes = ((16, 16, 8), (48, 32, 24), (112, 272, 40), (256, 512, 512))
    for (m, k, n) in shapes:  # odd shapes: zero padding, uneven slices, several rounds
        rs = np.random.RandomState(m + k + n)
        xo = torch.as_tensor(rs.randn(m, k).astype(np.float32), device=dev)
        wo = torch.as_tensor(rs.randn(k, n).astype(np.float32), device=dev)
        for mode in probes.MODES:
            got, want = sync_cpu(probes.dot_modes(xo, wo, mode), probes.plain_dot_modes(xo, wo, mode))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                       err_msg=f"T2 {mode} at {(m, k, n)}")
    print(f"T2 at {shapes}, every mode: equal to the plain version (rtol 1e-5, atol 1e-4)")
    reset_counts()
    t2_report = t2.main(["--device", "cuda", "--seconds", "0.25"])
    t2_launches = probes.dot_modes.launches
    require(t2_launches > 0, "T2's kernel launched in the tool's run")
    require(set(t2_report["divergence"]) == {"sphere", "linear"},
            "the tool's check_kernel_divergence ran on sphere and linear")
    for config, ls in t2_report["divergence"].items():
        print(f"check_kernel_divergence {config}: step-1 loss bf16 {ls['bf16'][0]:.6f}, "
              f"fp32 {ls['fp32'][0]:.6f}; 50-step mean bf16 {ls['bf16'].mean():.6f}, fp32 "
              f"{ls['fp32'].mean():.6f}")
    us = t2_report["us"]
    # device time: 200 calls captured in one CUDA graph, replayed in windows
    # timed with CUDA events (the per-call figures above include the host);
    # then the kernel's split by launch variants that stop after the launch,
    # the staging, the products, in turns with the whole kernel
    xs, ws = t2.inputs(dev)
    dev_us, split_us = {}, {}
    with t2.tf32_matmul(False), _SmClock() as clock:
        for mode in probes.MODES:
            dev_us[(mode, "kernel")] = _device_us(torch, lambda m=mode: probes.dot_modes(xs, ws, m))
            dev_us[(mode, "library")] = _device_us(torch, t2.library_call(mode, xs, ws))
            runs = {}
            for upto in ("all", "launch", "stage", "products", "all", "products", "stage",
                         "launch"):
                runs.setdefault(upto, []).append(_device_us(
                    torch, lambda m=mode, u=upto: probes._dot_launch(xs, ws, m, u)))
            split_us[mode] = {u: min(v) for u, v in runs.items()}
            # the staging over 8 rounds a CTA (K 2048): what a further round costs
            x8, w8 = (torch.randn(M, 8 * K, device=dev), torch.randn(8 * K, N, device=dev))
            for upto in ("launch", "stage"):
                split_us[mode][f"{upto}, K 2048"] = _device_us(
                    torch, lambda m=mode, u=upto: probes._dot_launch(x8, w8, m, u))
    mhz = clock.mhz[len(clock.mhz) // 2] if clock.mhz else float("nan")
    print(f"card: {smi}; SM clock during the timings {clock}")
    plan = probes.dot_plan(M, K, N, "fp32")
    ctas = plan.grid_x * plan.grid_y
    staged = 4 * (plan.tile_m * plan.chunk_k + plan.chunk_k * plan.tile_n)  # fp32 bytes a round
    for mode, peak in (("fp32", FP32_PEAK), ("tf32", TF32_PEAK), ("bf16", BF16_PEAK)):
        bound = _bound(2 * M * K * N, 4 * (M * K + K * N + M * N), 1, losses_per_step=0,
                       peak=peak)
        sp = split_us[mode]
        stage_us = sp["stage"] - sp["launch"]
        rounds_us = (sp["stage, K 2048"] - sp["launch, K 2048"] - stage_us) / 7
        print(f"T2 {mode}: kernel {us[(mode, 'kernel')]:.3f} us a Python call, "
              f"{dev_us[(mode, 'kernel')]:.3f} us device time; torch.matmul "
              f"{us[(mode, 'library')]:.3f} us a Python call, {dev_us[(mode, 'library')]:.3f} us "
              f"device time; bound {bound['bound_ms'] * 1e3:.4f} us ({bound['bound_by']}); max "
              f"error vs float64 {t2_report['err'][mode]:.3e}")
        print(f"T2 {mode} split, device time a call (min of two): launch only {sp['launch']:.3f} "
              f"us, + staging {sp['stage']:.3f}, + products {sp['products']:.3f}, whole "
              f"{sp['all']:.3f}; so staging {stage_us:.3f}, products "
              f"{sp['products'] - sp['stage']:.3f}, exchange and store "
              f"{sp['all'] - sp['products']:.3f} us")
        print(f"T2 {mode} staging: {staged} B a CTA ({ctas} CTAs, one a round) in {stage_us:.3f} "
              f"us = {staged / (stage_us * mhz):.2f} B a clock an SM at {mhz} MHz; a further "
              f"round (K 2048: {sp['stage, K 2048']:.3f} us with staging, "
              f"{sp['launch, K 2048']:.3f} launch only) {rounds_us:.3f} us = "
              f"{staged / (rounds_us * mhz):.2f} B a clock an SM")
        records.append({
            "name": f"dot_kernel (T2, {mode})", "route": "cuda",
            "source": "vae_training_tpu_torch/csrc/probes.cu",
            "replaces": "tools/check_precision.py:43", "launches": t2_launches,
            "max_abs_err": t2_report["vs_plain"][mode], "ms": dev_us[(mode, "kernel")] / 1e3,
            "plain_ms": us[(mode, "plain")] / 1e3, **bound,
            "library_ms": dev_us[(mode, "library")] / 1e3,
            "call_ms": us[(mode, "kernel")] / 1e3, "library_call_ms": us[(mode, "library")] / 1e3,
            "max_err_vs_float64": t2_report["err"][mode],
            "split_us": split_us[mode], "sm_mhz": mhz})

    # --- 30 -------------------------------------------------------------------
    phase(30, "T1: the draw (philox_draw_kernel), words entry and normals-only, against "
              "ops/rng.py; the statistical battery on the normals-only draw; times")
    n_rows, n_draws = 16384, 32  # the global battery's draw: 2,097,152 normals
    words, normals = k1.sampler_check(n_rows, n_draws, 0, 0, 12345, dev)
    ref = rng.words(12345, 0, n_rows, 0, n_draws, device=dev)
    require(torch.equal(rng.widen(words), ref), "sampler words bitwise at the battery's shape")
    t1_err = float((normals - rng.box_muller(ref)).abs().max())
    require(t1_err <= 1e-5, f"sampler normals |Δ| {t1_err} <= 1e-5")
    only = k1.sampler_normals(n_rows, n_draws, 0, 0, 12345, dev)
    require(torch.equal(only, normals), "the normals-only draw equals the words entry's bitwise")
    reset_counts()
    require(t1.main(["--device", "cuda"]), "T1's battery passes on the normals-only draw")
    t1_launches = k1.sampler_normals.launches
    require(t1_launches > 0 and k1.sampler_check.launches == 0,
            "the normals-only draw (and not the words entry) launched in the battery's run")
    n_calls = n_rows * n_draws
    t1_call = per_step_ms(lambda n: [k1.sampler_normals(n_rows, n_draws, 0, 0, 12345, dev)
                                     for _ in range(n)])
    # device time, 200 draws in one CUDA graph, in turns: the normals-only
    # draw, the words entry (its kernel writes the words beside the
    # normals; the wrapper widens nothing) and torch.randn of as many
    # normals on the CUDA default generator (another Philox stream than the
    # port's; normals only)
    torch.cuda.manual_seed(12345)
    draws = {"normals": lambda: k1.sampler_normals(n_rows, n_draws, 0, 0, 12345, dev),
             "words": lambda: k1.sampler_check(n_rows, n_draws, 0, 0, 12345, dev),
             "randn": lambda: torch.randn(4 * n_calls, device=dev)}
    t1_us = {}
    for name in ("normals", "words", "randn", "randn", "words", "normals"):
        t1_us.setdefault(name, []).append(_device_us(torch, draws[name]))
    t1_ms, t1_words, t1_lib = (min(t1_us[k]) / 1e3 for k in ("normals", "words", "randn"))
    t1_plain = per_step_ms(lambda n: [rng.box_muller(rng.words(12345, 0, n_rows, 0, n_draws,
                                                               device=dev)) for _ in range(n)])
    # a Philox call: 10 rounds of 2 wide multiplies (hi, lo) and 4 xors/adds;
    # Box–Muller: 2 logs, 2 square roots, 2 sincos, ~40 operations; it
    # writes 4 normals (the words entry also 4 words)
    bound = _bound(n_calls * (10 * 8 + 40), n_calls * 4 * 4, 1, losses_per_step=0)
    words_bound = _bound(n_calls * (10 * 8 + 40), n_calls * 4 * 8, 1, losses_per_step=0)
    print(f"card: {smi}")
    print(f"T1 draw of {4 * n_calls} normals, device time (min of two): normals only "
          f"{t1_ms * 1e3:.3f} us (bound {bound['bound_ms'] * 1e3:.3f}, {bound['bound_by']}; "
          f"{t1_call * 1e3:.2f} a Python call), words entry {t1_words * 1e3:.3f} us (bound "
          f"{words_bound['bound_ms'] * 1e3:.3f}), torch.randn {t1_lib * 1e3:.3f} us; ops/rng.py on "
          f"the card {t1_plain * 1e3:.2f} us; all: "
          f"{ {k: [round(x, 3) for x in v] for k, v in t1_us.items()} }")
    records.append({
        "name": "philox_draw_kernel (T1 battery, normals only)", "route": "cuda",
        "source": "vae_training_tpu_torch/csrc/linear_vae.cu",
        "replaces": "tools/check_kernel_rng.py:80", "launches": t1_launches,
        "max_abs_err": t1_err, "ms": t1_ms, "plain_ms": t1_plain, **bound,
        "library_ms": t1_lib, "call_ms": t1_call, "words_entry_ms": t1_words,
        "words_entry_bound_ms": words_bound["bound_ms"]})
    return records


def _mlp_split(torch, np, smi):
    """Phase 31: one K5 step at sphere row 1 split into its parts by timing
    variants of the same launch that leave parts out (``k5.SKIP``): the
    layer sums, the operand stages, Adam, and everything but the phases'
    cluster barriers; the whole step on clusters of 8 against the launch's
    own choice (16 for one row); in both dot modes, in turn (fp32 FMA
    chains, bf16 tensor-core sums); and the cluster size held to change no
    result in either mode. Windows of at least 0.5 s of 500-step launches;
    the skip variants' results are not used."""
    from vae_training_tpu_torch.data import SigmoidDataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import mlp_vae as k5
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState

    phase(31, "the MLP kernel's step at sphere row 1, split by variants that leave parts out, "
              "fp32 and bf16 dots in turn; clusters of 8 against 16")
    dev = torch.device("cuda")

    def sphere_bufs(dual=False):
        d, l = (SIG_D, SIG_L) if dual else (SPH_D, SPH_L)
        model = build_vae(data_dim=d, latent_dim=l, encoder_layer_sizes="200|200|200",
                          decoder_layer_sizes="200|200|200", epsilon=-3.0,
                          tunable_decoder_var=True, dataset_name="sigmoid" if dual else None)
        model.init_parameters(0)
        enc, dec = (d, 200, 200, 200, l), (l, 200, 200, 200, d)
        return k5.pack_state(TrainState.create(dict(model.named_parameters()), 0, 0).to(dev),
                             enc, dec, dual)

    bufs = sphere_bufs()
    row = k1.GridRow(SPH_D, SPH_L, SPH_DD, SPH_DD, None, 0, 0, rng.derive_seed(69, 1),
                     rng.derive_seed(0, 3), 0.0)
    steps = 500
    losses = torch.empty(1, steps, device=dev)

    sig = SigmoidDataset.create(69, SIG_DD, 3, device=dev)
    sig_row = k1.GridRow(SIG_D, SIG_L, SIG_DD, SIG_DD, sig.A, 0, 0, rng.derive_seed(69, 1),
                         rng.derive_seed(0, 3), 0.0)

    def launch(skip, cluster=0, n=steps, state=bufs, out=losses, r=row, dual=False,
               adam_dtype="f32", dots=False):
        k5._launch([state], out, [r], n_steps=n, batch=B, enc_hidden=SPH_ENC[1:-1],
                   dec_hidden=SPH_DEC[1:-1], kind="sigmoid" if dual else "sphere",
                   eps_const=-3.0, tdv=True, lr=1e-4, dual=dual, external_noise=None,
                   adam_dtype=adam_dtype, bf16_dots=dots, cluster=cluster, skip=skip)

    launch(0, n=1)
    size = k5.last_launch()["cluster_size"]
    variants = {"whole step": (0, 0), "no layer sums": (k5.SKIP["mma"], 0),
                "no sums, no stages": (k5.SKIP["mma"] | k5.SKIP["stage"], 0),
                "no Adam": (k5.SKIP["adam"], 0),
                "cluster barriers only": (k5.SKIP["work"], 0),
                "clusters of 8": (0, k5.CLUSTER)}
    modes = {False: "fp32 dots", True: "bf16 dots"}
    us = {dots: {} for dots in modes}
    for name in list(variants) + ["clusters of 8", "whole step"]:  # in turns
        for dots in modes:
            us[dots].setdefault(name, []).append(1e6 / _steps_per_second(
                torch, lambda v=variants[name], d=dots: launch(*v, dots=d), steps))
    print(f"card: {smi}")
    print(f"one row: clusters of {size} CTAs")
    for dots, mode in modes.items():
        t = {k: min(v) for k, v in us[dots].items()}
        for name, vals in us[dots].items():
            print(f"{mode}, {name:22}: " + " / ".join(f"{x:.2f}" for x in vals) + " us a step")
        split = {"layer sums": t["whole step"] - t["no layer sums"],
                 "operand stages": t["no layer sums"] - t["no sums, no stages"],
                 "Adam": t["whole step"] - t["no Adam"],
                 "cluster barriers": t["cluster barriers only"]}
        split["epilogues, sampler, loss, rest"] = (t["no sums, no stages"] - split["Adam"]
                                                   - split["cluster barriers"])
        print(f"split of a step, {mode}: " + "; ".join(
            f"{k} {v:.2f} us ({100 * v / t['whole step']:.1f}%)" for k, v in split.items()))
        require(all(v > 0 for v in t.values()), f"every variant ran ({mode})")
        print(f"{mode}: clusters of 8 / of {size}: {t['clusters of 8'] / t['whole step']:.4f}")

    # no result depends on the cluster size: 16 steps on each, bitwise, in
    # both dot modes and with both moment dtypes (K4 in each)
    for dual in (False, True):
        for adam_dtype in ("f32", "bf16"):
            for dots, mode in modes.items():
                start = sphere_bufs(dual)
                got = {}
                for cluster in (k5.CLUSTER, k5.CLUSTER_WIDE):
                    state = tuple(t_.clone() for t_ in start)
                    out = torch.empty(1, 16, device=dev)
                    launch(0, cluster, 16, state, out, sig_row if dual else row, dual,
                           adam_dtype, dots)
                    require(k5.last_launch()["cluster_size"] == cluster,
                            f"clusters of {cluster}")
                    got[cluster] = (out, *state)
                torch.cuda.synchronize()
                require(all(torch.equal(a, b) for a, b in zip(got[k5.CLUSTER],
                                                              got[k5.CLUSTER_WIDE])),
                        f"{'K5-dual' if dual else 'K5'} {adam_dtype} moments, {mode}: clusters "
                        f"of 8 and of 16 train bitwise the same")
    print("16 steps on clusters of 8 = on clusters of 16, bitwise: K5 and K5-dual, f32 and "
          "bf16 moments, fp32 and bf16 dots")


LINEAR_SPLIT_SHAPES = (("linear row 1 (K1)", 3, 9, 20, False),
                       ("sigmoid row 1 (K2)", 3, 3, 6, True),
                       ("sigmoid sweep's largest row (K2, D 28, L 24)", 7, 20, 24, True))


def _linear_split(torch, np, smi, steps=2000, min_seconds=0.3):
    """Phase 32: one step of the linear kernel (K1, K2) split into its parts
    by timing variants of the same launch that leave parts out
    (``k1.SKIP``): the sampler and manifold draw, the per-row pass, the
    per-parameter pass with Adam, and nothing but the barriers (and the
    loop); the rest is what the whole step takes beyond those. A part that
    overlaps another (the noise drawn beside the row pass) counts only what
    it adds. At linear row 1, sigmoid row 1 and the sigmoid sweep's largest
    row, in both dot modes (fp32 FMA chains; bf16 tensor-core products,
    with the bf16 mode's warp roles printed); each variant in the two modes
    in turn, each a window of at least ``min_seconds`` of ``steps``-step
    launches; their results are not used. Returns {shape: {mode: {part:
    µs}}}."""
    from vae_training_tpu_torch.data import LinearGaussianDataset, SigmoidDataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState

    phase(32, "the linear kernel's step (K1, K2) split by variants that leave parts out, "
              "fp32 and bf16 dots in turn")
    dev = torch.device("cuda")
    sk = k1.SKIP
    variants = {"whole step": 0, "no noise": sk["noise"], "no per-row pass": sk["rows"],
                "no per-parameter pass": sk["params"], "noise alone": sk["rows"] | sk["params"],
                "per-row pass alone": sk["noise"] | sk["params"],
                "per-parameter pass alone": sk["noise"] | sk["rows"],
                "barriers only": sk["work"]}
    order = list(variants) + ["whole step"]
    out = {}
    print(f"card: {smi}")
    for label, dd, pd, ld, dual in LINEAR_SPLIT_SHAPES:
        if dual:
            ds = SigmoidDataset.create(69, dd, pd, device=dev)
        else:
            ds = LinearGaussianDataset.create(2, dd, dd, pd, device=dev)
        model = build_vae(data_dim=ds.dimension, latent_dim=ld, epsilon=-3.0 if dual else -1.0,
                          tunable_decoder_var=True, dataset_name="sigmoid" if dual else None)
        model.init_parameters(0)
        state = TrainState.create(dict(model.named_parameters()), 0, 0).to(dev)
        bufs = k1.pack_state(state, ds.dimension, ld, dual)
        row = k1.GridRow(ds.dimension, ld, ds.intrinsic_dim, ds.dim, ds.A, 0, 0,
                         rng.derive_seed(69 if dual else 2, 1), rng.derive_seed(0, 3))
        kw = dict(batch=B, eps_const=-3.0 if dual else -1.0, tdv=True,
                  lr=1e-4 if dual else 1e-3, dual=dual)
        us = {}
        for name in order:
            for dots in (False, True):
                us.setdefault(dots, {}).setdefault(name, []).append(1e6 / _steps_per_second(
                    torch, lambda s=variants[name], d=dots: k1._grid_launch(
                        *bufs, [row], n_steps=steps, skip=s, bf16_dots=d, **kw),
                    steps, min_seconds))
        roles = k1.warp_roles(B, ds.dimension, ld, ds.intrinsic_dim, dual)
        print(f"{label}: bf16-dot warp roles: {roles['rw']} row warps (phase A), "
              f"{roles['tw']} tile warps and {roles['pw']} pool warps (phase B), the rest "
              f"draw; z2 drawn in phase {'A' if roles['z2a'] else 'B'}")
        out[label] = {}
        for dots in (False, True):
            mode = "bf16 dots" if dots else "fp32 dots"
            t = {k: min(v) for k, v in us[dots].items()}
            split = {"sampler and manifold draw": t["whole step"] - t["no noise"],
                     "per-row pass": t["whole step"] - t["no per-row pass"],
                     "per-parameter pass with Adam": t["whole step"] - t["no per-parameter pass"],
                     "barriers": t["barriers only"]}
            split["rest"] = t["whole step"] - sum(split.values())
            alone = {k: t[f"{k} alone"] - t["barriers only"]
                     for k in ("noise", "per-row pass", "per-parameter pass")}
            require(all(v > 0 for v in t.values()), f"{label}, {mode}: every variant ran")
            print(f"{label}, {mode}: " + "; ".join(
                f"{k} " + " / ".join(f"{x:.3f}" for x in v) + " us" for k, v in us[dots].items()))
            print(f"{label}, {mode}, split of a {t['whole step']:.3f} us step (what leaving each "
                  f"part out saves): " + "; ".join(
                      f"{k} {v:.3f} us ({100 * v / t['whole step']:.1f}%)"
                      for k, v in split.items()))
            print(f"{label}, {mode}, each part alone beyond the barriers: " + "; ".join(
                f"{k} {v:.3f} us" for k, v in alone.items()))
            out[label][mode] = {"step": t["whole step"], **split, "alone": alone}
    return out


def _surfaces(torch, np, smi, records, data_dir, solo_dir, sphere_dir):
    """Phases 33-39: the port's surfaces beyond the training kernels, on the
    card: the bench, the sampler, the background writer, the gaussian
    dataset, --profile, --debug_nans and the closed-form ELBO floor on K1.
    ``records`` are the kernels' records (their times are phases 7, 13, 17
    and 21's), ``solo_dir`` phase 5's run and ``sphere_dir`` phase 11's
    sphere run."""
    from vae_training_tpu_torch._scripts import sample as sample_mod
    from vae_training_tpu_torch._scripts import sweep
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import RunConfig, parse_arguments
    from vae_training_tpu_torch.data import get_dataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import mlp_vae as k5
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.runio import background, make_output_dir
    from vae_training_tpu_torch.train import TrainState, grid as grid_mod
    from vae_training_tpu_torch.train import loop as loop_mod
    from vae_training_tpu_torch.train import mixed_grid as mixed_mod
    from vae_training_tpu_torch.train import step as torch_step

    repo = os.path.dirname(os.path.abspath(__file__))
    counters = {"K1/K2": (k1.run_fused_chunk, "launches"), "K6a": (k1.run_grid_chunk, "launches"),
                "K5": (k5.run_mlp_fused_chunk, "launches"), "K6b": (k5.run_grid_chunk, "launches"),
                "torch path": (torch_step.train_chunk, "calls"),
                "torch graph": (torch_step.GraphChunk, "calls")}

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    def cli(name, row, num_batches, *extra):
        cfg = parse_arguments([name, *row, "--num_batches", str(num_batches), "--device",
                               "cuda", "--data_dir", data_dir, *extra])
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t

    def record(prefix):
        (rec,) = [r for r in records if r["name"].startswith(prefix)]
        return rec

    # --- 33 --------------------------------------------------------------
    phase(33, "the bench (vae-bench-torch) on the six configs, f32 moments, and linear and "
              "grid_sphere with bf16 moments")
    # steps/s (row-steps/s for the grids) of phases 7, 13, 17 and 21
    figures = {"linear": 1e3 / record("linear_vae_chunk (K1)")["ms"],
               "sigmoid": 1e3 / record("linear_vae_chunk dual (K2)")["ms"],
               "sphere": 1e3 / record("mlp_vae_chunk (K5)")["ms"],
               "grid_linear": 21e3 / record("linear_vae_grid_chunk (K6a), linear")["ms"],
               "grid_sigmoid": 18e3 / record("linear_vae_grid_chunk (K6a), sigmoid")["ms"],
               "grid_sphere": 15e3 / record("mlp_vae_chunk grid (K6b)")["ms"]}
    kernel_of = {"linear": "K1/K2", "sigmoid": "K1/K2", "sphere": "K5",
                 "grid_linear": "K6a", "grid_sigmoid": "K6a", "grid_sphere": "K6b"}
    card_name = smi.split(",")[0].strip()
    for config, adam in [(c, "f32") for c in figures] + [("linear", "bf16"),
                                                         ("grid_sphere", "bf16")]:
        # --precision fp32: the phases' figures are the fp32-dot kernels'
        # (phase 56 runs the bench under both values)
        proc = _bench(["--config", config, "--adam_dtype", adam, "--precision", "fp32"])
        require(proc.returncode == 0, f"bench {config} {adam} exited {proc.returncode}:\n"
                                      f"{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        require(len(lines) == 1, f"bench {config} {adam}: one line on stdout ({len(lines)})")
        print(lines[0])
        got = json.loads(lines[0])
        if adam == "f32":
            _BENCH_FP32[config] = lines[0]
        for ln in proc.stderr.splitlines():
            if ln.startswith(("steps/s:", "fp32 share", "flops/step", "[kernels]")):
                print(f"  {ln}")
        m = re.search(r"^\[kernels\] (\d+) chunks timed \(warm-up included\); launches: (.*)$",
                      proc.stderr, re.M)
        require(m is not None, f"bench {config} {adam}: the launch counts on stderr")
        chunks = int(m.group(1))
        launched = {k: int(v) for k, v in (s.rsplit(" ", 1) for s in m.group(2).split(", "))}
        kernel = kernel_of[config]
        require(launched[kernel] == chunks and sum(launched.values()) == chunks,
                f"bench {config} {adam}: one {kernel} launch a chunk and nothing else "
                f"({launched}, {chunks} chunks)")
        require(got["metric"].endswith("_per_gpu") and got["value"] > 0
                and got["mfu_pct"] is not None and got["flops_per_step"] > 0,
                f"bench {config} {adam}: a positive value and an mfu_pct")
        require(got["device"] == card_name, f"bench {config}: the card's name")
        ratio = got["value"] / figures[config]
        print(f"  {config} {adam}: {got['value']:.1f} steps/s against this run's phase figure "
              f"{figures[config]:.1f} ({ratio:.3f}x)")
        require(abs(ratio - 1) <= 0.25, f"bench {config} {adam} within 25% of the phase's "
                                        f"figure ({ratio:.3f}x)")

    # --- 34 --------------------------------------------------------------
    phase(34, "sample (vae-sample-torch) on phase 5's linear run and phase 11's sphere run")
    for label, run, width in (("linear row 1", solo_dir, (12, 32)),
                              ("sphere row 1", sphere_dir, (6, 12))):
        only_pkl = os.path.join(data_dir, f"{os.path.basename(run)}_pkl_only")
        os.makedirs(only_pkl, exist_ok=True)
        for f in ("args.json", "model.pkl"):
            shutil.copy(os.path.join(run, f), only_pkl)
        got = {}
        for tag, d, extra in (("a", run, ["--png", os.path.join(data_dir, "s.png")]),
                              ("b", run, []), ("seed7", run, ["--seed", "7"]),
                              ("pkl", only_pkl, [])):
            path = os.path.join(data_dir, f"samples_{os.path.basename(run)}_{tag}.npz")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = sample_mod.main([d, "-n", "1000", "-o", path, "--device", "cuda", *extra])
            require(rc == 0, f"{label} sample {tag}: exit 0")
            if tag == "a":
                print("\n".join(f"  {ln}" for ln in buf.getvalue().splitlines()))
            got[tag] = np.load(path)
        a = got["a"]
        require(a["samples"].shape == (1000, width[0]) and a["latents"].shape == (1000, width[1]),
                f"{label}: shapes {a['samples'].shape}, {a['latents'].shape}")
        require(bool(np.all(np.isfinite(a["samples"]))), f"{label}: finite samples")
        require(np.array_equal(a["samples"], got["b"]["samples"]),
                f"{label}: the same --seed gives the same samples bitwise")
        require(not np.array_equal(a["samples"], got["seed7"]["samples"]),
                f"{label}: another --seed gives other samples")
        require(np.array_equal(a["samples"], got["pkl"]["samples"]),
                f"{label}: the model.pkl-only copy gives the checkpoint's samples bitwise")
        print(f"{label}: samples {a['samples'].shape}, latents {a['latents'].shape}, finite; "
              f"seed 0 twice bitwise equal, seed 7 differs, model.pkl only = ckpt.pt bitwise")

    # --- 35 --------------------------------------------------------------
    phase(35, "the background writer: the grouped sweeps with saves written synchronously "
              "(the parent's way) and in the background, in turns (sync, background, "
              "background, sync)")

    class SyncWriter:
        """Writes each job when it is submitted, as the parent's saves did."""

        def submit(self, job):
            job()

        def drain(self):
            pass

        drain_quietly = drain

    sync_writer = SyncWriter()
    writer_fns = {m: m.get_artifact_writer for m in (loop_mod, grid_mod, mixed_mod)}
    # the training thread's parts of plot+save, summed over a sweep: the
    # in-loop events', and apart from them the final saves' (what runs
    # inside save_all(final=True), its drain included)
    spent, final = {}, [False]

    def timed(owner, name):
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            outer = not final[0] and bool(k.get("final"))
            final[0] = final[0] or outer
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                key = f"{name} final" if final[0] else name
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
                final[0] = final[0] and not outer
        return fn, wrapper

    patched = [(owner, name) for owner, name in ((grid_mod.GridTrainer, "plot_all"),
                                                 (grid_mod.GridTrainer, "save_all"),
                                                 (TrainState, "host_copy"),
                                                 (background.ArtifactWriter, "drain"))]
    acct_re = re.compile(r"banners ([\d.]+)s, train chunks ([\d.]+)s, stat evals ([\d.]+)s, "
                         r"plot\+save ([\d.]+)s")
    kernel_of = {"linear": "K6a", "sigmoid": "K6a", "sphere": "K6b"}
    for which in ("linear", "sigmoid", "sphere"):
        for turn, mode in enumerate(("sync", "background", "background", "sync")):
            originals = []
            for owner, name in patched:
                fn, wrapper = timed(owner, name)
                originals.append((owner, name, fn))
                setattr(owner, name, wrapper)
            if mode == "sync":
                for mod in writer_fns:
                    mod.get_artifact_writer = lambda: sync_writer
            spent.clear()
            try:
                reset_counts()
                buf = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = sweep.main([which, "--grouped", "--kernels", "cuda", "--num_batches",
                                     "12000", "--data_dir",
                                     os.path.join(data_dir, f"writer_{mode}{turn}", which)])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            finally:
                for mod, fn in writer_fns.items():
                    mod.get_artifact_writer = fn
                for owner, name, fn in originals:
                    setattr(owner, name, fn)
            n = counts()
            require(rc == 0 and n[kernel_of[which]] == 4
                    and sum(n.values()) == 4,
                    f"{which} {mode}: one {kernel_of[which]} launch a chunk and nothing else ({n})")
            m = acct_re.search(buf.getvalue())
            require(m is not None, f"{which} {mode}: the wall-accounting line")
            banners, chunks, evals, io_s = (float(x) for x in m.groups())
            print(f"{which} sweep, saves {mode:10}: wall {wall:.3f} s: banners {banners:.3f}, "
                  f"train chunks {chunks:.3f}, stat evals {evals:.3f}, plot+save {io_s:.3f} "
                  f"(of it on this thread: plot_all {spent.get('plot_all', 0):.3f}, save_all "
                  f"{spent.get('save_all', 0):.3f} with host copies "
                  f"{spent.get('host_copy', 0):.3f}, the drain "
                  f"{spent.get('drain', 0):.3f}); final saves "
                  f"{spent.get('save_all final', 0):.3f}")
        for c in sweep.sweep_configs(which, data_dir, 12000, "cuda"):
            for other in ("writer_background1", "writer_background2", "writer_sync3"):
                _require_same_run(np, os.path.join(data_dir, "writer_sync0", which, c.name),
                                  os.path.join(data_dir, other, which, c.name))
        print(f"{which}: every run's losses.npz and model.pkl equal in all four sweeps bitwise")

    # --- 36 --------------------------------------------------------------
    phase(36, "the gaussian dataset on the card: the CLI on the torch path, 400 steps")
    gauss = ["--dataset", "gaussian", "-dd", "3", "--padding_dim", "9", "--latent_dim", "20",
             "-ow", "-lr", "1e-3", "--n_print", "100", "--n_plot", "400"]
    reset_counts()
    rc, out, secs = cli("gauss", gauss, 400)
    n = counts()
    print("\n".join(ln for ln in out.splitlines() if ln.startswith(("[kernels]", "Batch |"))))
    banner = re.search(r"^Score for real data: (\{.*?\})$", out, re.M | re.S)
    require(rc == 0 and banner is not None, "the gaussian run returned 0 with its banner")
    print("Score for real data: " + " ".join(banner.group(1).split()))
    torch_n = n["torch path"] + n["torch graph"]
    require("[kernels] torch: plain PyTorch path" in out and torch_n > 0
            and sum(n.values()) == torch_n, f"the torch path and no kernel ({n})")
    require("'ground truth eigenvalue': array(" in banner.group(1)
            and "'learnt eigenvalue': array(" in banner.group(1),
            "the banner carries the eigenvalue arrays")
    evals = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^Batch \| (\d+) \| VAE Loss \| (-?[\d.]+)", out, re.M)}
    require(sorted(evals) == [0, 100, 200, 300], f"eval lines at 0/100/200/300 ({sorted(evals)})")
    require(evals[300] < evals[0], "the gaussian eval loss falls")
    z = np.load(os.path.join(data_dir, "gauss", "losses.npz"))
    require(z["learnt eigenvalue"].shape == (4, 12) and z["ground truth eigenvalue"].shape == (4, 12),
            "losses.npz holds the eigenvalues of every eval")
    cfg = parse_arguments(["g", *gauss, "--device", "cuda"])
    ds = get_dataset("gaussian", 69, cfg, device=torch.device("cuda"))
    model = build_vae(data_dim=12, latent_dim=20, encoder_layer_sizes="512|512",
                      decoder_layer_sizes="512|512", epsilon=0.0)
    model.init_parameters(0)
    model.to("cuda")
    state = TrainState.create(dict(model.named_parameters()), 1, 2)
    rate = _steps_per_second(torch, lambda: torch_step.train_chunk(
        model, ds, state, 50, batch_size=B, lr=1e-3), 50)
    print(f"card: {smi}")
    print(f"gaussian on the torch path op by op (512|512, D 12, L 20, batch {B}): "
          f"{rate:.1f} steps/s "
          f"({1e3 / rate:.4f} ms/step); the CLI run: eval loss {evals[0]:.3f} -> "
          f"{evals[300]:.3f}, {secs:.2f} s for 400 steps with 4 evals")

    # --- 37 --------------------------------------------------------------
    phase(37, "--profile: linear row 1 through K1, 12000 steps, the first chunk traced")
    reset_counts()
    rc, out, _ = cli("prof", ROW1, 12000, "--kernels", "cuda", "--profile")
    n = counts()
    require(rc == 0 and n["K1/K2"] > 0 and n["torch path"] + n["torch graph"] == 0,
            f"K1 ran ({n})")
    trace = os.path.join(data_dir, "prof", "profile", "trace.json")
    require(os.path.exists(trace), "the trace exists")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e["name"] for e in kernels})
    print(f"{trace}: {len(events)} events, {len(kernels)} CUDA kernel events; kernels: "
          f"{', '.join(name[:60] for name in names)}")
    k1_events = [e for e in kernels if "linear_vae_chunk_kernel" in e["name"]]
    require(len(k1_events) == 1, "the trace names K1's kernel function, once (one launch)")
    print(f"linear_vae_chunk_kernel: {k1_events[0]['dur'] / 1e3:.3f} ms in the trace for the "
          f"5000-step chunk")
    _require_same_run(np, solo_dir, os.path.join(data_dir, "prof"))
    print("the profiled run's losses.npz and model.pkl equal phase 5's bitwise")

    # --- 38 --------------------------------------------------------------
    phase(38, "--debug_nans: a NaN in the state, a diverging run on K1, a clean run")
    with open(os.path.join(solo_dir, "model.pkl"), "rb") as f:
        sd = pickle.load(f)
    sd["target"]["Decoder"]["FC0"]["kernel"][1, 2] = np.nan
    nan_pkl = os.path.join(data_dir, "nan.pkl")
    with open(nan_pkl, "wb") as f:
        pickle.dump(sd, f)
    for label, extra, match in (
            ("a NaN put into the state", ["--state_dict", nan_pkl],
             "non-finite state at step 0: params[Decoder.FC0.kernel]"),
            ("learning rate 1e30 on K1", ["-lr", "1e30"], "non-finite training loss at step")):
        reset_counts()
        try:
            cli("nan", ROW1, 12000, "--kernels", "cuda", "--debug_nans", *extra)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        require(raised is not None and match in raised,
                f"{label}: FloatingPointError ({raised!r})")
        print(f"{label}: FloatingPointError: {raised} (K1 launches {counts()['K1/K2']})")
    reset_counts()
    rc, _, _ = cli("dn", ROW1, 12000, "--kernels", "cuda", "--debug_nans")
    require(rc == 0 and counts()["K1/K2"] > 0, "the clean --debug_nans run on K1")
    _require_same_run(np, solo_dir, os.path.join(data_dir, "dn"))
    print("the clean --debug_nans run's losses.npz and model.pkl equal phase 5's bitwise")

    # --- 39 --------------------------------------------------------------
    phase(39, "the closed-form ELBO floor (tests/test_convergence_oracles.py) through K1, "
              "20000 + 200 steps")
    cfg = RunConfig(
        name="floor", dataset="linear_gaussian", encoder_layer_sizes="", layer_sizes="",
        latent_dimension=8, padding_dim=5, dataset_dimension=3, dataset_intrinsic_dimension=3,
        num_batches=20000, batch_size=100, learning_rate=1e-3, epsilon=-1.0,
        tunable_decoder_var=True, dataset_seed=2, overwrite=True, tqdm=False,
        data_dir=data_dir, kernels="cuda", device="cuda",
        precision="fp32").validate()  # the oracle is the fp32 model's closed form
    out = make_output_dir(cfg.name, True, cfg, data_dir=cfg.data_dir)
    ds = get_dataset(cfg.dataset, cfg.dataset_seed, cfg, device=torch.device("cuda"))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = loop_mod.Trainer(cfg, ds, out)
    D = ds.dimension
    a64 = ds.A.cpu().numpy().astype(np.float64)
    s2 = np.sort(np.linalg.svd(a64, compute_uv=False) ** 2)[::-1]

    def floor(eps):
        active = s2 > np.exp(eps)
        return float(np.sum(active * (0.5 + 0.5 * np.log(s2) - 0.5 * eps))
                     + 0.5 * D + 0.5 * D * (np.log(2 * np.pi) + eps))

    reset_counts()
    t = time.perf_counter()
    trainer.state, _ = trainer.train_chunk(trainer.state, 20000)
    eps_a = float(trainer.state.params["epsilon"][0]) * -1.0
    trainer.state, losses = trainer.train_chunk(trainer.state, 200)
    eps_b = float(trainer.state.params["epsilon"][0]) * -1.0
    secs = time.perf_counter() - t
    require(counts()["K1/K2"] == 2 and counts()["torch path"] + counts()["torch graph"] == 0,
            "two K1 launches")
    l_obs = float(losses.mean())
    gap = l_obs - floor(0.5 * (eps_a + eps_b))
    print(f"A's singular values {np.sqrt(s2)}; eps {eps_a:.4f} -> {eps_b:.4f}; loss "
          f"{l_obs:.4f}, floor {floor(0.5 * (eps_a + eps_b)):.4f}, gap {gap:.4f}; "
          f"{secs:.3f} s for 20200 steps")
    require(gap > -0.25, f"(1) the loss does not undercut the floor (gap {gap})")
    require(gap < 3.0, f"(2) the loss is within 3 nats of the floor (gap {gap})")
    p = {k: v.cpu().numpy().astype(np.float64) for k, v in trainer.state.params.items()}
    wd, we = p["Decoder.FC0.kernel"], p["Encoder.FC0.kernel"]
    dvals = np.sort(np.linalg.svd(wd, compute_uv=False))[::-1]
    ep_sorted = np.sort(p["epsilon_p"])
    for i in range(2):
        pred = eps_b - np.log(dvals[i] ** 2)
        print(f"direction {i}: ep {ep_sorted[i]:.4f}, conditional optimum {pred:.4f}")
        require(abs(ep_sorted[i] - pred) < 0.3, f"(3) direction {i} at its optimum")
    roundtrip = np.sort(np.linalg.svd(a64.T @ we[:ds.dim] @ wd[:, :ds.dim],
                                      compute_uv=False))[::-1]
    print(f"roundtrip singular values {roundtrip} against A's {np.sqrt(s2)}")
    require(bool(np.allclose(roundtrip[:2], np.sqrt(s2)[:2], rtol=0.05, atol=0)),
            "(3) c_i·d_i = s_i on the strong directions")


def _graph_and_library(torch, np, smi, data_dir, solo_dir):
    """Phases 40-42: the torch path as one CUDA graph replay a step
    (``train/step.py`` ``GraphChunk``) against its op-by-op chunk, then the
    library surface on the card: warm starts through K1, K2 and K6a, and
    ``--track_correlation`` through K1. ``solo_dir`` is phase 5's run."""
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.data import get_dataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels.dispatch import make_grid_chunk
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState, step as torch_step

    dev = torch.device("cuda")
    repo = os.path.dirname(os.path.abspath(__file__))

    def cli(name, row, num_batches, *extra):
        cfg = parse_arguments([name, *row, "--num_batches", str(num_batches), "--device",
                               "cuda", "--data_dir", data_dir, *extra])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue()

    def kernels_line(out):
        return next(ln for ln in out.splitlines() if ln.startswith("[kernels]"))

    # --- 40 --------------------------------------------------------------
    phase(40, "the torch path as one CUDA graph replay a step against its op-by-op chunk: "
              "sphere row 1 (--kernels torch), gaussian 512|512, the grid's torch path at "
              "linear row 1 (--seed_grid 2,3,4), 200 steps each")
    gauss = ["--dataset", "gaussian", "-dd", "3", "--padding_dim", "9", "--latent_dim", "20",
             "-ow", "-lr", "1e-3"]

    def setup(flags, seed=None):
        cfg = parse_arguments(["g40", *flags, "--device", "cuda", "--kernels", "torch"])
        seed = cfg.dataset_seed if seed is None else seed
        ds = get_dataset(cfg.dataset, seed, cfg, device=dev)
        model = build_vae(data_dim=ds.dimension, latent_dim=cfg.latent_dimension,
                          encoder_layer_sizes=cfg.encoder_layer_sizes,
                          decoder_layer_sizes=cfg.layer_sizes, epsilon=cfg.epsilon,
                          tunable_decoder_var=cfg.tunable_decoder_var, dataset_name=cfg.dataset)
        model.init_parameters(cfg.model_seed)
        model.to(dev)
        state = TrainState.create(dict(model.named_parameters()),
                                  rng.derive_seed(seed, rng.SEED_TRAIN_DATA),
                                  rng.derive_seed(cfg.model_seed, rng.SEED_TRAIN_Z))
        return cfg, ds, model, state

    def copy(state):
        return dataclasses.replace(state, **{t: {k: x.clone() for k, x in getattr(state, t).items()}
                                             for t in ("params", "m", "v")})

    def hold(label, tol, eager, graph):
        """Bitwise, else tests/kernel_test_helpers.py's tolerances (cuBLAS
        may pick another algorithm under capture); says which held."""
        (se, le), (sg, lg) = eager, graph
        pairs = [("losses", "losses", le, lg)] + [
            (t, f"{t}[{k}]", getattr(se, t)[k], getattr(sg, t)[k])
            for t in ("params", "m", "v") for k in se.params]
        require(all(bool(torch.isfinite(b).all()) for _, _, _, b in pairs), f"{label}: finite")
        require((se.step, se.count) == (sg.step, sg.count), f"{label}: the same step and count")
        if all(torch.equal(a, b) for _, _, a, b in pairs):
            print(f"{label}: graph = eager bitwise (losses, parameters, moments)")
            return
        worst = 0.0
        for tree, name, a, b in pairs:
            a, b = a.cpu().numpy(), b.cpu().numpy()
            np.testing.assert_allclose(b, a, *tol[tree], err_msg=f"{label} {name}")
            worst = max(worst, float(np.abs(a - b).max()))
        print(f"{label}: graph = eager within tests/kernel_test_helpers.py's tolerances "
              f"(not bitwise; max |delta| {worst:.3e})")

    steps = 200
    print(f"card: {smi}")
    for label, flags, tol in (("sphere row 1", SPHERE_ROW1, MLP_TOL),
                              ("gaussian 512|512", gauss, MLP_TOL)):
        cfg, ds, model, s0 = setup(flags)
        kw = dict(batch_size=cfg.batch_size, lr=float(cfg.learning_rate))
        graph = torch_step.GraphChunk(model, ds, **kw)
        _torch_chunks(torch_step, reset=True)
        eager = torch_step.train_chunk(model, ds, copy(s0), steps, **kw)
        hold(label, tol, eager, graph(copy(s0), steps))
        require(torch_step.GraphChunk.calls == 1 and torch_step.train_chunk.calls == 1,
                 f"{label}: one graph chunk and one eager chunk")
        state = [copy(s0), copy(s0)]

        def run_eager(n):
            state[0] = torch_step.train_chunk(model, ds, state[0], n, **kw)[0]

        def run_graph(n):
            state[1] = graph(state[1], n)[0]

        e = _timed(torch, f"{label}, eager (op by op)", run_eager, 40, 10)
        g = _timed(torch, f"{label}, graph (one replay a step)", run_graph, steps, 20)
        print(f"  {label}: the graph's wall time a step is {e[0] / g[0]:.2f}x shorter")

    seeds = (2, 3, 4)
    rows = [setup(ROW1, seed) for seed in seeds]
    cfg, model = rows[0][0], rows[0][2]
    kw = dict(batch_size=cfg.batch_size, lr=float(cfg.learning_rate))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chunk = make_grid_chunk([model] * 3, [r[1] for r in rows], cfg)
    line = buf.getvalue().strip()
    print(line)
    require(line.startswith("[kernels] torch: plain PyTorch path, row by row for 3 rows "
                            "(--kernels torch)") and line.endswith("; one CUDA graph replay a step"),
            "the grid's torch path names the graph form")
    _torch_chunks(torch_step, reset=True)
    g_states, g_losses = chunk([copy(r[3]) for r in rows], steps)
    require(torch_step.GraphChunk.calls == 3 and torch_step.train_chunk.calls == 0,
            "one graph chunk a row")
    for i, (seed, r) in enumerate(zip(seeds, rows)):
        hold(f"linear row 1, grid row seed {seed}", TOL,
             torch_step.train_chunk(model, r[1], copy(r[3]), steps, **kw),
             (g_states[i], g_losses[i]))
    box = [[copy(r[3]) for r in rows]]

    def run_grid(n):
        box[0] = chunk(box[0], n)[0]

    def run_grid_eager(n):
        box[0] = [torch_step.train_chunk(model, r[1], s, n, **kw)[0] for r, s in zip(rows, box[0])]

    e = _timed(torch, "linear row 1 grid of 3, eager, a launch-step of all rows", run_grid_eager, 15, 5)
    g = _timed(torch, "linear row 1 grid of 3, graph, a launch-step of all rows", run_grid, steps, 20)
    print(f"  the grid's graph form is {e[0] / g[0]:.2f}x shorter a step")

    # the CLI: --resume in the middle of an uninterrupted run's chunk
    tflags = [*SPHERE_ROW1, "--kernels", "torch", "--n_print", "200", "--n_plot", "300"]
    _torch_chunks(torch_step, reset=True)
    t = time.perf_counter()
    rc, out = cli("g40_full", tflags, 300)
    print(f"the CLI, 300 steps with --kernels torch: {time.perf_counter() - t:.2f} s")
    require(rc == 0 and torch_step.GraphChunk.calls == 3 and torch_step.train_chunk.calls == 0,
            f"the CLI ran 3 graph chunks ({torch_step.GraphChunk.calls}) and no eager one")
    print(kernels_line(out))
    require(kernels_line(out) == "[kernels] torch: plain PyTorch path (--kernels torch) with "
                                 "bf16-operand dots; one CUDA graph replay a step",
            "the [kernels] line (the CLI's default --precision bf16)")
    rc1, _ = cli("g40_part", tflags, 150)
    rc2, _ = cli("g40_resumed", tflags, 300, "--resume", os.path.join(data_dir, "g40_part"))
    require(rc1 == 0 and rc2 == 0, "the part and the resumed run returned 0")
    _require_same_run(np, os.path.join(data_dir, "g40_full"), os.path.join(data_dir, "g40_resumed"))
    print("chunks [0, 200), [200, 299), [299, 300) against 150 steps, then --resume: [150, 200), "
          "...; losses.npz and model.pkl bitwise equal")
    for flag, words in (("--debug_nans", "eager (--debug_nans"), ("-nojit", "eager (-nojit")):
        _torch_chunks(torch_step, reset=True)
        rc, out = cli("g40_eager", gauss, 20, "--n_print", "10", "--n_plot", "20", flag)
        print(kernels_line(out))
        require(rc == 0 and words in kernels_line(out) and torch_step.GraphChunk.calls == 0
                and torch_step.train_chunk.calls > 0, f"{flag}: op by op, and the line says so")
    # a step the graph cannot capture (a host sync in the sample) raises and runs
    # nothing op by op; in a process of its own, so that no capture state is left here
    code = (
        "import torch\n"
        "from vae_training_tpu_torch.data import SphereDataset\n"
        "from vae_training_tpu_torch.models import build_vae\n"
        "from vae_training_tpu_torch.train import TrainState, step\n"
        "class Syncing(SphereDataset):\n"
        "    def sample(self, seed, step_, n):\n"
        "        x = super().sample(seed, step_, n)\n"
        "        float(x.sum())\n"
        "        return x\n"
        "ds = Syncing(3, 3, device='cuda')\n"
        "m = build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes='8', decoder_layer_sizes='8')\n"
        "m.init_parameters(0)\n"
        "m.to('cuda')\n"
        "s = TrainState.create(dict(m.named_parameters()), 1, 2)\n"
        "try:\n"
        "    step.GraphChunk(m, ds, batch_size=10, lr=1e-3)(s, 5)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, 'eager chunks', step.train_chunk.calls)\n"
        "else:\n"
        "    print('no error')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=300)
    print(f"a failed capture: {proc.stdout.strip()} (at {time.perf_counter() - _T0:.1f} s)")
    require(proc.returncode == 0 and proc.stdout.startswith("raised")
            and proc.stdout.strip().endswith("eager chunks 0"),
            f"a failed capture raises and runs no eager chunk:\n{proc.stderr[-2000:]}")

    # --- 41 --------------------------------------------------------------
    phase(41, "-ws on the card: linear row 1 through K1, a sigmoid run (latent 7) through "
              "K2, --seed_grid 2,3,4 -ws through K6a, 2000 steps each")
    launch = (k1.run_fused_chunk, k1.run_grid_chunk)

    def counted(name, row, *extra):
        for c in launch:
            c.launches = 0
        _torch_chunks(torch_step, reset=True)
        rc, out = cli(name, row, 2000, "--kernels", "cuda", *extra)
        require(rc == 0 and _torch_chunks(torch_step) == 0, f"{name}: rc 0, no torch path")
        return out, [c.launches for c in launch]

    def first_eval(run):
        return float(np.load(os.path.join(data_dir, run, "losses.npz"))["VAE Loss"][0])

    out, (solo_n, grid_n) = counted("ws_lin", ROW1, "-ws")
    require(solo_n > 0 and grid_n == 0 and "K1" in kernels_line(out), "-ws on K1")
    sig_ws = [a if a != "6" else "7" for a in SIGMOID_ROW1]  # latent 7 = dd 3 + 1 + pd 3
    counted("ws_sig_cold", sig_ws)
    out, (solo_n, _) = counted("ws_sig", sig_ws, "-ws")
    require(solo_n > 0 and "K2" in kernels_line(out), "-ws on K2")
    for label, warm, cold in (("linear row 1 (K1)", "ws_lin", os.path.relpath(solo_dir, data_dir)),
                              ("sigmoid, latent 7 (K2)", "ws_sig", "ws_sig_cold")):
        w, c = first_eval(warm), first_eval(cold)
        print(f"{label}: the first eval loss {w:.4f} with -ws, {c:.4f} cold")
        require(w < c, f"{label}: -ws starts below the cold start")
    for seed in (3, 4):
        counted(f"ws_lin{seed}", ROW1, "-ws", "-ds", str(seed))
    out, (solo_n, grid_n) = counted("ws_grid", ROW1, "-ws", "--seed_grid", "2,3,4")
    print(kernels_line(out))
    require(grid_n > 0 and solo_n == 0 and "K6a" in kernels_line(out), "the -ws grid on K6a")
    for seed, solo in ((2, "ws_lin"), (3, "ws_lin3"), (4, "ws_lin4")):
        _require_same_run(np, os.path.join(data_dir, solo),
                          os.path.join(data_dir, f"ws_grid_seed{seed}"))
    print(f"K6a launches {grid_n}; rows seed 2, 3, 4 equal their solo -ws K1 runs bitwise")

    # --- 42 --------------------------------------------------------------
    phase(42, "--track_correlation on linear row 1 through K1, 3000 steps; --resume from 1500")
    tc = ["--track_correlation", "--n_print", "1000", "--n_plot", "3000"]
    k1.run_fused_chunk.launches = 0
    _torch_chunks(torch_step, reset=True)
    rc, out = cli("tc", ROW1, 3000, "--kernels", "cuda", *tc)
    require(rc == 0 and k1.run_fused_chunk.launches > 0 and _torch_chunks(torch_step) == 0,
            "--track_correlation trains on K1")
    z = np.load(os.path.join(data_dir, "tc", "losses.npz"))
    names = {"Correlation Ratio"} | {f"Correlation Ratio/{p}" for p in (
        "Decoder/FC0/bias", "Decoder/FC0/kernel", "Encoder/FC0/bias", "Encoder/FC0/kernel",
        "epsilon", "epsilon_p")}
    got = {k for k in z.files if k.startswith("Correlation Ratio")}
    require(got == names, f"the JAX package's ratio keys ({sorted(got)})")
    for k in sorted(names):
        require(z[k].shape == (3,) and bool(np.all(np.isfinite(z[k]))), f"{k}: 3 finite ratios")
        print(f"{k}: {z[k]}")
    rc1, _ = cli("tc_part", ROW1, 1500, "--kernels", "cuda", *tc)
    rc2, _ = cli("tc_resumed", ROW1, 3000, "--kernels", "cuda", *tc, "--resume",
                 os.path.join(data_dir, "tc_part"))
    require(rc1 == 0 and rc2 == 0, "the part and the resumed run returned 0")
    _require_same_run(np, os.path.join(data_dir, "tc"), os.path.join(data_dir, "tc_resumed"))
    print("the resumed run's ratios (and all of losses.npz, model.pkl) equal the "
          "uninterrupted run's bitwise")


def _epochs(torch, np, smi, data_dir):
    """Phases 43-48: epoch mode and the conv VAE on the card at the bench's
    conv configuration (``CONV``, full width): the epoch chunk as one CUDA
    graph replay a step against op by op, the CLI's 10 epochs, --resume,
    times, the bench and the sampler, an .npz corpus."""
    from vae_training_tpu_torch._scripts import bench
    from vae_training_tpu_torch._scripts import sample as sample_mod
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments, use_fp32_math
    from vae_training_tpu_torch.data import ImageDataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import mlp_vae as k5
    from vae_training_tpu_torch.models.conv import build_conv_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState, step as torch_step

    dev = torch.device("cuda")
    use_fp32_math(dev)  # as every entry point: no TF32, cuDNN deterministic
    repo = os.path.dirname(os.path.abspath(__file__))
    launchers = (k1.run_fused_chunk, k1.run_grid_chunk, k5.run_mlp_fused_chunk,
                 k5.run_grid_chunk)

    def reset_counts():
        for fn in launchers:
            fn.launches = 0
        _torch_chunks(torch_step, reset=True)

    def counts():
        return (sum(fn.launches for fn in launchers), torch_step.GraphChunk.calls,
                torch_step.train_chunk.calls)

    def cli(name, *extra):
        cfg = parse_arguments([name, *CONV, "--device", "cuda", "--data_dir", data_dir, *extra])
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t

    def epoch_evals(out):
        return [float(v) for v in re.findall(r"^Epoch \| \d+ \| VAE Loss \| (-?[\d.]+)", out,
                                             re.M)]

    # --- 43 --------------------------------------------------------------
    phase(43, "the conv VAE's epoch chunk as one CUDA graph replay an epoch against its "
              "op-by-op form at the bench's conv configuration (4096 28x28x1 images, batch "
              "128, 32|64, latent 16), one epoch of 32 steps")
    print(f"card: {smi}")
    t = time.perf_counter()
    ds = ImageDataset.synthetic_digits(0, n=4096, size=28, device=dev)
    print(f"the synthetic corpus {tuple(ds.images.shape)} in {time.perf_counter() - t:.2f} s")
    model = build_conv_vae(image_hwc=ds.shape, latent_dim=16, channels_spec="32|64",
                           epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)
    model.to(dev)
    kw = dict(batch_size=128, lr=1e-3)

    def fresh():
        return TrainState.create(dict(model.named_parameters()),
                                 rng.derive_seed(0, rng.SEED_TRAIN_DATA),
                                 rng.derive_seed(0, rng.SEED_TRAIN_Z))

    eager = torch_step.EpochChunk(model, ds, graph=False, **kw)
    graph = torch_step.EpochChunk(model, ds, graph=True, **kw)
    reset_counts()
    se, le = eager(fresh(), 0)
    sg, lg = graph(fresh(), 0)
    torch.cuda.synchronize()
    require(counts() == (0, 1, 1), f"one graph epoch and one op-by-op epoch ({counts()})")
    require(le.shape == (CONV_NB,) and bool(torch.isfinite(le).all()), "32 finite losses")
    require(torch.equal(le, lg), "graph losses = op-by-op losses bitwise")
    require((se.step, se.count) == (sg.step, sg.count) == (CONV_NB, CONV_NB), "step and count")
    for tree in ("params", "m", "v"):
        for k, x in getattr(se, tree).items():
            require(torch.equal(x, getattr(sg, tree)[k]), f"{tree}[{k}] bitwise")
    print(f"one epoch: graph = op by op bitwise (32 losses, {len(se.params)} parameters and "
          f"their moments); loss {le[0].item():.3f} -> {le[-1].item():.3f}")

    # --- 44 --------------------------------------------------------------
    phase(44, "main path: the CLI with --dataset image, 10 epochs (320 steps) at the bench's "
              "conv configuration")
    reset_counts()
    rc, out, secs = cli("conv", "--num_epochs", "10")
    (kline,) = [ln for ln in out.splitlines() if ln.startswith("[kernels]")]
    print(kline)
    print("\n".join(ln for ln in out.splitlines() if ln.startswith(("Epoch |", "Completed"))))
    print(f"the CLI, 10 epochs: rc {rc}, {secs:.2f} s; fused-kernel launches, graph epochs, "
          f"op-by-op epochs: {counts()}")
    require(rc == 0, "main() returned 0")
    require(kline == "[kernels] torch: plain PyTorch path (an image corpus in epoch mode: the "
                     "fused kernels train the manifolds) with bf16-operand dots; one CUDA graph "
                     "replay an epoch", "the [kernels] line names bf16 dots and the graph form")
    require(counts() == (0, 10, 0), "ten graph epochs, no kernel launch, no op-by-op epoch")
    require("Completed Epoch 9" in out.splitlines(), "Completed Epoch 9")
    conv_dir = os.path.join(data_dir, "conv")
    for f in ("args.json", "losses.npz", "model.pkl", "ckpt.pt", "ckpt_meta.json"):
        require(os.path.exists(os.path.join(conv_dir, f)), f"artifact {f}")
    z = np.load(os.path.join(conv_dir, "losses.npz"))
    require(z["VAE Loss"].shape == (10 * CONV_NB + 11,)
            and bool(np.all(np.isfinite(z["VAE Loss"]))) and z["KL divergence"].shape == (11,),
            "losses.npz: 320 finite losses + 11 evals")
    evals = epoch_evals(out)
    require(len(evals) == 11 and evals[-1] < evals[0], f"the eval loss falls ({evals})")
    print(f"eval VAE Loss {evals[0]:.3f} -> {evals[-1]:.3f}")

    # --- 45 --------------------------------------------------------------
    phase(45, "resume: 4 epochs, then --resume to 10")
    rc1, _, _ = cli("conv_part", "--num_epochs", "4")
    reset_counts()
    rc2, out, _ = cli("conv_resumed", "--num_epochs", "10", "--resume",
                      os.path.join(data_dir, "conv_part"))
    require(rc1 == 0 and rc2 == 0 and counts() == (0, 6, 0),
            f"both returned 0; six graph epochs resumed ({counts()})")
    require(out.count("Completed Epoch") == 6 and "Completed Epoch 4" in out.splitlines(),
            "the resumed run trains epochs 4-9")
    _require_same_run(np, conv_dir, os.path.join(data_dir, "conv_resumed"))
    print("losses.npz and model.pkl equal the uninterrupted run bitwise")

    # --- 46 --------------------------------------------------------------
    phase(46, "times: the epoch chunk op by op, as one graph replay an epoch and as one "
              "graph replay a step")
    print(f"card: {smi}")
    box = {}

    def runner(chunk):
        box[chunk] = [fresh(), 0]

        def run(n):
            while n > 0:
                k = min(n, CONV_NB)
                box[chunk][0] = chunk(box[chunk][0], box[chunk][1], k)[0]
                box[chunk][1] += 1
                n -= k
        return run

    step_graph = _StepGraphEpochs(torch_step, model, ds, **kw)
    e = _timed(torch, "conv, op by op", runner(eager), CONV_NB, 8)
    s1 = _timed(torch, "conv, one graph replay a step", runner(step_graph), 10 * CONV_NB,
                CONV_NB)
    run_graph = runner(graph)
    g = _timed(torch, "conv, one graph replay an epoch (EpochChunk)", run_graph,
               10 * CONV_NB, CONV_NB, warm=CONV_NB)
    print(f"  the epoch graph's wall time a step is {e[0] / g[0]:.2f}x shorter than op by op "
          f"and {s1[0] / g[0]:.3f}x shorter than one replay a step")
    _kernel_table(torch, lambda: run_graph(CONV_NB), CONV_NB)
    ss, ls = step_graph(fresh(), 0)
    sg, lg = graph(fresh(), 0)
    require(torch.equal(ls, lg) and all(torch.equal(x, sg.params[k])
                                        for k, x in ss.params.items()),
            "the epoch graph equals the one-step graph bitwise")
    print("the epoch graph equals the one-step graph bitwise (losses, parameters)")

    # --- 47 --------------------------------------------------------------
    phase(47, "the bench (vae-bench-torch --config conv) and the sampler (vae-sample-torch) "
              "on phase 44's run")
    proc = _bench(["--config", "conv", "--precision", "fp32"])  # phase 46's fp32 model
    require(proc.returncode == 0, f"bench conv exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    require(len(lines) == 1, f"bench conv: one line on stdout ({len(lines)})")
    print(lines[0])
    _BENCH_FP32["conv"] = lines[0]
    for ln in proc.stderr.splitlines():
        if ln.startswith(("steps/s:", "fp32 share", "flops/step", "[kernels]")):
            print(f"  {ln}")
    got = json.loads(lines[0])
    m = re.search(r"^\[kernels\] (\d+) chunks timed \(warm-up included\); launches: (.*)$",
                  proc.stderr, re.M)
    require(m is not None, "bench conv: the launch counts on stderr")
    launched = {k: int(v) for k, v in (x.rsplit(" ", 1) for x in m.group(2).split(", "))}
    require(launched["torch graph"] == int(m.group(1)) == sum(launched.values()),
            f"bench conv: one graph epoch a chunk and nothing else ({launched})")
    require(got["metric"] == "conv_vae_train_steps_per_sec_per_gpu" and got["value"] > 0
            and got["mfu_pct"] is not None
            and got["flops_per_step"] == bench.conv_step_flops(128, (28, 28, 1), 16, (32, 64))
            and got["device"] == smi.split(",")[0].strip(),
            "bench conv: metric, value, mfu_pct, the JAX bench's conv_step_flops, the card")
    ratio = got["value"] / (1e3 / g[1])
    print(f"  conv: {got['value']:.1f} steps/s against phase 46's graph figure "
          f"{1e3 / g[1]:.1f} ({ratio:.3f}x)")
    require(abs(ratio - 1) <= 0.25, f"bench conv within 25% of phase 46's figure ({ratio:.3f}x)")
    only_pkl = os.path.join(data_dir, "conv_pkl_only")
    os.makedirs(only_pkl, exist_ok=True)
    for f in ("args.json", "model.pkl"):
        shutil.copy(os.path.join(conv_dir, f), only_pkl)
    samples = {}
    for tag, d in (("ckpt", conv_dir), ("pkl", only_pkl)):
        path = os.path.join(data_dir, f"conv_samples_{tag}.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            require(sample_mod.main([d, "-n", "1000", "-o", path, "--device", "cuda"]) == 0,
                    f"sample {tag}: exit 0")
        samples[tag] = np.load(path)
    a = samples["ckpt"]
    require(a["samples"].shape == (1000, 784) and a["latents"].shape == (1000, 800)
            and bool(np.all(np.isfinite(a["samples"]))), "samples (1000, 784), finite")
    require(np.array_equal(a["samples"], samples["pkl"]["samples"]),
            "the model.pkl-only copy gives the checkpoint's samples bitwise")
    print(f"sample: {a['samples'].shape}, latents {a['latents'].shape}, finite; model.pkl only "
          f"= ckpt.pt bitwise (at {time.perf_counter() - _T0:.1f} s)")

    # --- 48 --------------------------------------------------------------
    phase(48, "an .npz corpus: the synthetic corpus written to an .npz, one epoch through the CLI")
    corpus = os.path.join(data_dir, "digits.npz")
    np.savez(corpus, images=ds.images.cpu().numpy())
    reset_counts()
    rc, out, secs = cli("conv_npz", "--num_epochs", "1", "--image_source", corpus)
    require(rc == 0 and counts() == (0, 1, 0) and "Completed Epoch 0" in out.splitlines(),
            f"one graph epoch from the .npz ({counts()})")
    za = np.load(os.path.join(data_dir, "conv_npz", "losses.npz"))["VAE Loss"]
    require(np.array_equal(za, z["VAE Loss"][:CONV_NB + 2]),
            "its losses equal phase 44's first epoch bitwise (the same images)")
    print(f"one epoch from {os.path.basename(corpus)} in {secs:.2f} s; its 32 losses and 2 evals "
          f"equal phase 44's first epoch bitwise")


class _StepGraphEpochs:
    """Epochs as ``EpochChunk`` runs them, but one CUDA graph replay a step
    (``GraphChunk`` with one step a replay over ``EpochBatches``): the form
    phase 46 measures the kept one, one replay an epoch, against."""

    def __init__(self, torch_step, model, dataset, batch_size, lr):
        self.dataset = dataset
        self.batches = torch_step.EpochBatches(dataset.images, batch_size)
        self.chunk = torch_step.GraphChunk(model, self.batches, batch_size=batch_size, lr=lr)

    def __call__(self, state, epoch, n_batches=None):
        self.batches.set_epoch(self.dataset.epoch_permutation(state.data_seed, epoch),
                               state.step)
        return self.chunk(state, n_batches or self.batches.n_batches)


# the rank program of phases 50 and 51: one process of a gloo group
# sharing the card (LOCAL_RANK 0). "run"/"sweep" drive vae-train-torch /
# vae-sweep-torch and print the kernels' launch counts; "time <steps>
# <mesh>" times K6a's launch-step over this rank's rows of the linear sweep
# (sharded over the mesh, or all 21 rows without one)
_RANK = r'''
import json, sys, time
from vae_training_tpu_torch.kernels import linear_vae as k1, mlp_vae as k5
what, argv = sys.argv[1], sys.argv[2:]
if what == "time":
    import dataclasses, torch
    from vae_training_tpu_torch._scripts.sweep import SWEEP_SEEDS, sweep_configs
    from vae_training_tpu_torch.train.grid import GridTrainer
    from vae_training_tpu_torch.train.mixed_grid import MixedGridSweep, _clone
    from vae_training_tpu_torch.utils.process import init_distributed, process_index
    init_distributed(True, "cuda")
    rows, seeds = {}, SWEEP_SEEDS["linear"]
    for cfg in sweep_configs("linear", "unused", 5000, "cuda"):
        key = (cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension)
        rows.setdefault(key, {})[cfg.dataset_seed] = cfg
    groups = [GridTrainer(by[seeds[0]], seeds, build_chunk=False) for by in rows.values()]
    sweep = MixedGridSweep(groups, mesh_spec=argv[1] if len(argv) > 1 else "")
    states = [g.states[i] for g, i in sweep._real] + [_clone(g.states[i]) for g, i in sweep._pads]
    steps = int(argv[0])
    sweep._chunk(states, steps)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calls, t = 0, time.perf_counter()
    start.record()
    while True:
        sweep._chunk(states, steps)
        calls += 1
        end.record()
        end.synchronize()
        if start.elapsed_time(end) >= 2000:
            break
    print("TIME " + json.dumps({
        "rank": process_index(), "rows": len(states),
        "event_ms": start.elapsed_time(end) / (calls * steps),
        "wall_ms": (time.perf_counter() - t) * 1e3 / (calls * steps)}))
    sys.exit(0)
if what == "run":
    from vae_training_tpu_torch._scripts.run import cli as entry
else:
    from vae_training_tpu_torch._scripts.sweep import main as entry
rc = entry(argv)
print("LAUNCHES " + json.dumps({
    "K1": k1.run_fused_chunk.launches, "K5": k5.run_mlp_fused_chunk.launches,
    "K6a": k1.run_grid_chunk.launches, "K6b": k5.run_grid_chunk.launches}))
sys.exit(rc)
'''


def _parallel(torch, np, smi, data_dir, records):
    """Phases 49-52: the parallel backends on one card. A one-rank process
    group (gloo for host objects, NCCL for device collectives) for the dp
    path, the dp epoch and InvertibleBatchNorm; two processes sharing the
    card for the sharded seed grid and the sharded grouped sweep (their
    training has no collective, so no NCCL group between them)."""
    import torch.distributed as dist

    from vae_training_tpu_torch._scripts import sweep as sweep_mod
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments, use_fp32_math
    from vae_training_tpu_torch.data import SphereDataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import mlp_vae as k5
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.ops.flows import InvertibleBatchNorm
    from vae_training_tpu_torch.parallel import data_parallel, make_mesh
    from vae_training_tpu_torch.parallel.dryrun import spawn_ranks
    from vae_training_tpu_torch.runio.checkpoint import restore_checkpoint
    from vae_training_tpu_torch.train import TrainState, step as torch_step
    from vae_training_tpu_torch.utils.process import device_group

    dev = torch.device("cuda")
    use_fp32_math(dev)
    repo = os.path.dirname(os.path.abspath(__file__))
    launchers = (k1.run_fused_chunk, k1.run_grid_chunk, k5.run_mlp_fused_chunk,
                 k5.run_grid_chunk)

    def reset_counts():
        for fn in launchers:
            fn.launches = 0
        _torch_chunks(torch_step, reset=True)

    def counts():
        return (sum(fn.launches for fn in launchers), torch_step.GraphChunk.calls,
                torch_step.train_chunk.calls)

    def cli(name, flags, *extra):
        cfg = parse_arguments([name, *flags, "--device", "cuda", "--data_dir", data_dir,
                               *extra])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue()

    def same_state(a, b):
        """Max |Δ| of the checkpoints' losses-bearing state: params, m, v."""
        sa, sb = restore_checkpoint(a), restore_checkpoint(b)
        require((sa.step, sa.count) == (sb.step, sb.count), f"steps {a} {b}")
        return max(float((t.float() - getattr(sb, tree)[k].float()).abs().max())
                   for tree in ("params", "m", "v") for k, t in getattr(sa, tree).items())

    def ranks(argv, n=2, timeout=300):
        results = spawn_ranks(n, [sys.executable, "-c", _RANK, *argv], timeout=timeout,
                              cwd=repo, local_rank=0)
        for r, (rc, out, err) in enumerate(results):
            if rc != 0:
                print(out[-3000:])
                print(err[-6000:], file=sys.stderr)
            require(rc == 0, f"rank {r} of {argv[:2]} exited {rc}")
        return [out for _, out, _ in results]

    def launches(out):
        (line,) = [ln for ln in out.splitlines() if ln.startswith("LAUNCHES ")]
        return json.loads(line[len("LAUNCHES "):])

    rendezvous = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}/rendezvous", rank=0,
                            world_size=1)
    try:
        # --- 49 ----------------------------------------------------------
        phase(49, "NCCL at world size 1: --mesh dp=1 through the CLI at sphere row 1 "
                  "(1000 steps) and at the conv configuration (2 epochs), against the "
                  "no-mesh torch path")
        for name, flags, extra, form in (
                ("sphere", SPHERE_ROW1, ["--num_batches", "1000"], "a step"),
                ("conv", CONV, ["--num_epochs", "2"], "an epoch")):
            reset_counts()
            rc, out = cli(f"{name}_dp1", flags, *extra, "--mesh", "dp=1")
            (kline,) = [ln for ln in out.splitlines() if ln.startswith("[kernels]")]
            print(kline)
            dp_counts = counts()
            print(f"{name} --mesh dp=1: rc {rc}; kernel launches, graph chunks, op-by-op "
                  f"chunks: {dp_counts}")
            require(rc == 0, "main() returned 0")
            require(kline == "[kernels] torch: plain PyTorch path (--mesh dp=1: data parallel "
                             f"over dp=1) with bf16-operand dots; one CUDA graph replay {form}, "
                             "the all-reduces captured in it", "the [kernels] line names the dp "
                             "form")
            require(dp_counts[0] == 0 and dp_counts[1] > 0 and dp_counts[2] == 0,
                    "graph chunks only: no kernel launch, no op-by-op chunk")
            rc, _ = cli(f"{name}_nomesh", flags, *extra, "--kernels", "torch")
            require(rc == 0, "the no-mesh run returned 0")
            a, b = (os.path.join(data_dir, f"{name}_{k}") for k in ("dp1", "nomesh"))
            _require_same_run(np, a, b)
            err = same_state(a, b)
            require(err == 0.0, f"params, m and v bitwise (max |Δ| {err})")
            print(f"{name}: losses.npz, model.pkl and the checkpoint's params, m and v equal "
                  f"the no-mesh torch path bitwise")

        # --- 50 ----------------------------------------------------------
        phase(50, "two processes sharing the card (LOCAL_RANK 0, WORLD_SIZE 2, a gloo "
                  "group): --seed_grid 2,3,4,5 --mesh dp=2 --multihost at linear row 1 on "
                  "K6a, then vae-sweep-torch sphere --grouped --mesh dp=2 on K6b")
        print("both processes load the kernel libraries phase 2 built (build/kernels/, keyed "
              "by the sources' hash): neither builds")
        grid = [*ROW1, "--num_batches", "2000", "--kernels", "cuda", "--device", "cuda",
                "--seed_grid", "2,3,4,5"]
        ref_dir, sh_dir = os.path.join(data_dir, "grid_ref"), os.path.join(data_dir, "grid_sh")
        cfg = parse_arguments(["g", *grid, "--data_dir", ref_dir])
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            require(run_main(cfg) == 0, "the one-process grid returned 0")
        t = time.perf_counter()
        outs = ranks(["run", "g", *grid, "--data_dir", sh_dir, "--mesh", "dp=2",
                      "--multihost"])
        print(f"two ranks, --seed_grid 2,3,4,5 --mesh dp=2: {time.perf_counter() - t:.1f} s")
        for r, out in enumerate(outs):
            got = launches(out)
            mine = [[2, 3], [4, 5]][r]
            kline = [ln for ln in out.splitlines() if "[kernels]" in ln]
            print(f"rank {r}: {kline[0]}; launches {got}")
            require(got["K6a"] > 0 and got["K1"] == got["K5"] == got["K6b"] == 0,
                    f"rank {r} launched K6a and nothing else")
            require(kline[0].startswith(f"[p{r}] [kernels] cuda: K6a") and
                    "2 rows in one launch a chunk" in kline[0], f"rank {r}: K6a over 2 rows")
            seeds = set(map(int, re.findall(r"^\[p\d\] \[seed (\d+)\]", out, re.M)))
            require(seeds == set(mine), f"rank {r} printed its rows {mine} ({seeds})")
            require(not re.search(r"^\[seed ", out, re.M), f"rank {r}'s lines carry [p{r}]")
        for s in (2, 3, 4, 5):
            a, b = os.path.join(ref_dir, f"g_seed{s}"), os.path.join(sh_dir, f"g_seed{s}")
            _require_same_run(np, a, b)
            require(same_state(a, b) == 0.0, f"row seed{s}: params, m and v bitwise")
        print("every row equals the one-process grid's bitwise (losses.npz, model.pkl, "
              "checkpoint)")
        sw = ["sphere", "--grouped", "--num_batches", "200", "--kernels", "cuda",
              "--device", "cuda"]
        ref_sw, sh_sw = os.path.join(data_dir, "sweep_ref"), os.path.join(data_dir, "sweep_sh")
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            require(sweep_mod.main([*sw, "--data_dir", ref_sw]) == 0, "one-process sweep")
        t = time.perf_counter()
        outs = ranks(["sweep", *sw, "--data_dir", sh_sw, "--mesh", "dp=2"])
        print(f"two ranks, sphere --grouped --mesh dp=2: {time.perf_counter() - t:.1f} s")
        for r, out in enumerate(outs):
            got = launches(out)
            kline = [ln for ln in out.splitlines() if "[kernels]" in ln]
            print(f"rank {r}: {kline[0]}; launches {got}")
            require(got["K6b"] > 0 and got["K1"] == got["K5"] == got["K6a"] == 0,
                    f"rank {r} launched K6b and nothing else")
            require("8 rows in one launch a chunk" in kline[0],
                    f"rank {r}: K6b over 8 rows (15 rows padded to 16)")
        names = sorted(os.listdir(ref_sw))
        require(len(names) == 15 and sorted(os.listdir(sh_sw)) == names, "15 run dirs")
        for name in names:
            a, b = os.path.join(ref_sw, name), os.path.join(sh_sw, name)
            _require_same_run(np, a, b)
            require(same_state(a, b) == 0.0, f"{name}: params, m and v bitwise")
        print("every sphere run equals the one-process grouped sweep's bitwise")

        # --- 51 ----------------------------------------------------------
        phase(51, "times: the dp=1 step over NCCL against the no-mesh step at sphere row 1; "
                  "the world-size-1 all-reduce; the sharded grid's launch-step a rank with "
                  "two processes on the card")
        print(f"card: {smi}")
        ds = SphereDataset(3, 3, device=dev)
        model = build_vae(data_dim=SPH_D, latent_dim=SPH_L, encoder_layer_sizes="200|200|200",
                          decoder_layer_sizes="200|200|200", epsilon=-3.0,
                          tunable_decoder_var=True, dataset_name="sphere")
        model.init_parameters(0)
        model.to(dev)
        dp = data_parallel(make_mesh("dp=1"), B, 0, dev)
        group = dp.groups[0][0]
        require(dist.get_backend(group) == "nccl", "the dp group is NCCL on the card")
        box = {}

        def runner(par):
            chunk = torch_step.GraphChunk(model, ds, batch_size=B, lr=1e-4, dp=par)
            box[par is None] = TrainState.create(dict(model.named_parameters()),
                                                 rng.derive_seed(69, rng.SEED_TRAIN_DATA),
                                                 rng.derive_seed(0, rng.SEED_TRAIN_Z))

            def run(n):
                box[par is None] = chunk(box[par is None], n)[0]
            return run

        plain, dp_run = runner(None), runner(dp)
        times = {}
        for label, fn in (("no mesh", plain), ("dp=1 over NCCL", dp_run),
                          ("dp=1 over NCCL (2)", dp_run), ("no mesh (2)", plain)):
            times[label] = _timed(torch, f"sphere row 1, {label}", fn, 1000, 20)
        wall = {k: min(times[k][0], times[k + " (2)"][0]) for k in ("no mesh", "dp=1 over NCCL")}
        event = {k: min(times[k][1], times[k + " (2)"][1]) for k in ("no mesh", "dp=1 over NCCL")}
        print(f"dp=1 step over NCCL: wall {wall['dp=1 over NCCL']:.4f} ms against "
              f"{wall['no mesh']:.4f} ({wall['dp=1 over NCCL'] - wall['no mesh']:+.4f}); "
              f"CUDA-event {event['dp=1 over NCCL']:.4f} against {event['no mesh']:.4f} "
              f"({event['dp=1 over NCCL'] - event['no mesh']:+.4f})")
        n_flat = sum(p.numel() for p in model.parameters()) + 1
        flat = torch.zeros(n_flat, device=dev)
        ms, n_kernels = _kernel_ms(torch, lambda: [dist.all_reduce(flat, group=group)
                                                   for _ in range(100)])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(1000):
            dist.all_reduce(flat, group=group)
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t) * 1e3
        device = ("no kernel: NCCL returns a one-rank in-place all-reduce without device work"
                  if not n_kernels else f"{ms * 10:.3f} us of {n_kernels // 100} kernel(s)")
        print(f"the world-size-1 all-reduce of the step's {n_flat} floats, a call: on the "
              f"device {device} (100 calls in a torch.profiler trace); {host_us:.3f} us op by "
              f"op with the host's dispatch (1000 calls)")
        linear = [rec for rec in records
                  if rec["name"].startswith("linear_vae_grid_chunk (K6a), linear sweep")]
        p17 = f"{linear[0]['ms']:.5f} ms" if linear else "not measured in this run"
        times = [ranks(["time", "5000"], n=1)[0], *ranks(["time", "5000", "dp=2"])]
        for out in times:
            (line,) = [ln for ln in out.splitlines() if ln.startswith("TIME ")]
            got = json.loads(line[5:])
            who = ("one process alone" if got["rows"] == 21 else
                   f"rank {got['rank']} of two processes on the card, dp=2")
            print(f"K6a over {got['rows']} rows of the linear sweep, {who}: "
                  f"{got['event_ms']:.5f} ms a launch-step (CUDA events), {got['wall_ms']:.5f} "
                  f"wall; phase 17's one-process figure, 21 rows: {p17}")

        # --- 52 ----------------------------------------------------------
        phase(52, "InvertibleBatchNorm with a one-rank NCCL group against none, on the card")
        nccl = device_group([0], dev)
        x = torch.randn(4096, 64, generator=torch.Generator().manual_seed(0)).to(dev) * 3 + 2
        got = []
        for g in (None, nccl):
            bn = InvertibleBatchNorm(64, process_group=g).to(dev)
            xi = x.clone().requires_grad_(True)
            y = bn(xi)
            (y * y).sum().backward()
            got.append((y.detach(), xi.grad, bn.scale.grad, bn.bias.grad,
                        dict(bn.named_buffers())))
        (ya, ga, sa, ba, bufa), (yb, gb, sb, bb, bufb) = got
        require(torch.equal(ya, yb) and torch.equal(ga, gb) and torch.equal(sa, sb)
                and torch.equal(ba, bb) and all(torch.equal(bufa[k], bufb[k]) for k in bufa),
                "outputs, gradients and running stats bitwise")
        print("(4096, 64): outputs, gradients and running stats equal the group-less module's "
              "bitwise")
    finally:
        dist.destroy_process_group()


def _bf16_dots(torch, np, smi, data_dir, records, row1_dirs=None):
    """Phases 53-57: ``--precision bf16``, the reference's default, on the
    card. Each kernel in its bf16-dot mode against its bf16 plain version
    (one step at a time from the plain's state, by ρ = ‖kernel − plain_bf16‖
    / ‖plain_fp32 − plain_bf16‖, with the fp32 kernel as the negative
    control) and its bitwise properties in that mode; the torch path's
    graph and epoch forms in it; the times of both modes in turn; the CLI's
    rows 1 under ``--precision fp32`` beside the bf16 runs of phases 5 and
    11 (``row1_dirs``; run here when None). Appends the bf16-dot records to
    ``records``."""
    from vae_training_tpu_torch._scripts import bench
    from vae_training_tpu_torch._scripts import sweep
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments, use_fp32_math
    from vae_training_tpu_torch.data import (ImageDataset, LinearGaussianDataset,
                                             SigmoidDataset, SphereDataset)
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels import mlp_vae as k5
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.models.conv import build_conv_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState, step as torch_step
    from vae_training_tpu_torch.train.grid import GridTrainer

    dev = torch.device("cuda")
    use_fp32_math(dev)
    hidden = (200, 200, 200)
    seeds = (rng.derive_seed(2, rng.SEED_TRAIN_DATA), rng.derive_seed(0, rng.SEED_TRAIN_Z))
    RHO_MAX, RHO_CONTROL = 0.1, 0.5

    def rho(got, plain_b, plain_f):
        g, b, f = (t.double().flatten() for t in (got, plain_b, plain_f))
        return float((g - b).norm() / (f - b).norm().clamp_min(1e-300))

    def clone(bufs):
        return tuple(t.clone() for t in bufs)

    class Hold:
        """ρ of the kernel's losses over the steps (one vector), and of each
        row's m and v over the steps (each row's vectors of every step, one
        ratio of norms a row), in both kernel modes; then the checks. The
        largest single step's ρ is printed too: a bf16-dot mode rounds
        intermediates (g_y, g_mu) that differ between two f32 orders by an
        ulp, so now and then an element lands one bfloat16 ulp apart, and
        one step of one row can show it."""

        def __init__(self, label):
            self.label, self.losses, self.err = label, {}, 0.0
            self.sq = {}  # (dots, row, "m"|"v") → [Σ‖kernel − plain_bf16‖², Σ‖plain_fp32 − plain_bf16‖²]
            self.worst_step = 0.0

        def step(self, losses, views, plain_losses, plain_views):
            """losses[mode], views[mode]: each kernel mode's (rows, 1) losses
            and per-row (p, m, v); plain_*[mode] the plain version's."""
            for dots in (True, False):
                self.losses.setdefault(dots, []).append(losses[dots])
                for i, ((_, m, v), (_, mb, vb), (_, mf, vf)) in enumerate(zip(
                        views[dots], plain_views[True], plain_views[False])):
                    for key, got, b, f in (("m", m, mb, mf), ("v", v, vb, vf)):
                        num = float((got.double() - b.double()).norm() ** 2)
                        den = float((f.double() - b.double()).norm() ** 2)
                        acc = self.sq.setdefault((dots, i, key), [0.0, 0.0])
                        acc[0] += num
                        acc[1] += den
                        if dots:
                            self.worst_step = max(self.worst_step, (num / max(den, 1e-300)) ** 0.5)
            self.losses.setdefault("pb", []).append(plain_losses[True])
            self.losses.setdefault("pf", []).append(plain_losses[False])
            self.err = max(self.err, float((losses[True] - plain_losses[True]).abs().max()))

        def check(self):
            cat = {k: torch.cat([x.reshape(-1) for x in v]) for k, v in self.losses.items()}
            require(bool(torch.isfinite(cat[True]).all()), f"{self.label}: finite losses")
            r_b, r_f = rho(cat[True], cat["pb"], cat["pf"]), rho(cat[False], cat["pb"], cat["pf"])
            rows = {dots: [(num / max(den, 1e-300)) ** 0.5 for (d, _, _), (num, den)
                           in self.sq.items() if d == dots] for dots in (True, False)}
            mv_b, mv_f = max(rows[True]), min(rows[False])
            print(f"{self.label}: losses rho {r_b:.2e} (fp32 kernel {r_f:.2f}); each row's m, v "
                  f"rho max {mv_b:.2e} (fp32 kernel min {mv_f:.2f}; one step's max "
                  f"{self.worst_step:.2e}); max |Δ| losses {self.err:.2e}")
            require(r_b <= RHO_MAX and mv_b <= RHO_MAX,
                    f"{self.label}: the bf16-dot kernel within rho {RHO_MAX} of its bf16 plain "
                    f"version (losses {r_b:.2e}, m/v {mv_b:.2e})")
            require(r_f >= RHO_CONTROL and mv_f >= RHO_CONTROL,
                    f"{self.label}: the fp32 kernel at rho >= {RHO_CONTROL} from the bf16 plain "
                    f"version (losses {r_f:.2f}, m/v {mv_f:.2f})")
            return self.err

    def walk(label, n, state, kernel, plain, views, noise=None):
        """n steps one at a time from the bf16 plain version's state:
        kernel(bufs, step, ext, dots) and plain(...) launch one step in
        place and return (rows, 1) losses; views(bufs) → per-row (p, m, v)."""
        hold = Hold(label)
        for step in range(n):
            ext = None if noise is None else noise(step)
            lk, vk, lp, vp, nxt = {}, {}, {}, {}, None
            for dots in (True, False):
                kb, pb = clone(state), clone(state)
                lk[dots] = kernel(kb, step, ext, dots).reshape(-1, 1)
                lp[dots] = plain(pb, step, ext, dots).reshape(-1, 1)
                vk[dots], vp[dots] = views(kb), views(pb)
                if dots:
                    nxt = pb
            torch.cuda.synchronize()
            hold.step(lk, vk, lp, vp)
            state = nxt
        return hold.check()

    errs = {}

    # --- 53 --------------------------------------------------------------
    phase(53, "bf16 dots, the linear kernel: K1 and K2 at rows 1 (32 steps one at a time from "
              "the bf16 plain version's state, external noise and in-kernel sampler, -tdv on "
              "and off) and K6a on the linear (21) and sigmoid (18) sweeps; rho against "
              "the bf16 plain version, the fp32 kernel as control; bitwise properties")
    print(f"card: {smi}; rho = |kernel - plain_bf16| / |plain_fp32 - plain_bf16|, "
          f"<= {RHO_MAX} for the bf16-dot kernel, >= {RHO_CONTROL} for the fp32 one")
    lin_ds = LinearGaussianDataset.create(2, 3, 3, 9, device=dev)
    sig_ds = SigmoidDataset.create(69, 3, 3, device=dev)
    solo = {"K1": dict(ds=lin_ds, D=D, L=L, dd=ID, eps=-1.0, lr=1e-3, dual=False),
            "K2": dict(ds=sig_ds, D=SIG_D, L=SIG_L, dd=SIG_DD, eps=-3.0, lr=1e-4, dual=True)}

    def k1_state(c, tdv, adam="f32"):
        model = build_vae(data_dim=c["D"], latent_dim=c["L"], epsilon=c["eps"],
                          tunable_decoder_var=tdv, dataset_name="sigmoid" if c["dual"] else None)
        model.init_parameters(0)
        st = TrainState.create(dict(model.named_parameters()), *seeds, adam).to(dev)
        return k1.pack_state(st, c["D"], c["L"], c["dual"])

    def k1_call(fn, c, bufs, n, step0, tdv, ext, dots, adam="f32"):
        return fn(*bufs, c["ds"].A, n_steps=n, batch=B, data_dim=c["D"], latent_dim=c["L"],
                  intrinsic_dim=c["dd"], manifold_dim=c["dd"], step0=step0, t0=step0,
                  data_seed=seeds[0], model_seed=seeds[1], var_added=0.0,
                  eps_const=c["eps"], tdv=tdv, lr=c["lr"], external_noise=ext,
                  dual=c["dual"], adam_dtype=adam, bf16_dots=dots)

    n = 32
    for name, c in solo.items():
        rs = np.random.RandomState(53)
        row = k1.GridRow(c["D"], c["L"], c["dd"], c["dd"], c["ds"].A if c["dual"] else None,
                         0, 0, 0, 0)
        if c["dual"]:
            ext_all = _manifold_noise(torch, np, rs, row, n, B, dev)
        else:
            xs = np.zeros((n, B, c["D"]), np.float32)
            xs[:, :, :c["dd"]] = rs.randn(n, B, c["dd"]).astype(np.float32) @ \
                c["ds"].A.cpu().numpy().T
            ext_all = tuple(torch.as_tensor(a, device=dev) for a in (
                xs, rs.randn(n, B, c["L"]).astype(np.float32),
                rs.randn(n, B, c["D"]).astype(np.float32)))
        for tdv in (True, False):
            for mode in ("external", "sampler"):
                noise = None if mode == "sampler" else (
                    lambda s: tuple(t[s:s + 1].contiguous() for t in ext_all))
                errs[name] = max(errs.get(name, 0.0), walk(
                    f"{name} tdv={tdv} {mode}", n, k1_state(c, tdv),
                    lambda b, s, e, d, c=c, t=tdv: k1_call(k1.run_fused_chunk, c, b, 1, s, t, e, d),
                    lambda b, s, e, d, c=c, t=tdv: k1_call(k1.plain_fused_chunk, c, b, 1, s, t, e,
                                                         d),
                    lambda b: [b], noise))
        for adam in ("f32", "bf16"):
            a = k1_state(c, True, adam)
            b = clone(a)
            la = k1_call(k1.run_fused_chunk, c, a, 40, 0, True, None, True, adam)
            lb = torch.cat([k1_call(k1.run_fused_chunk, c, b, 15, 0, True, None, True, adam),
                            k1_call(k1.run_fused_chunk, c, b, 25, 15, True, None, True, adam)])
            torch.cuda.synchronize()
            require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
                    f"{name} bf16 dots, {adam} moments: 40 = 15 + 25 bitwise")
        print(f"{name} bf16 dots: a 40-step launch = 15 + 25 bitwise, f32 and bf16 moments")

    def sweep_family(which, hid=None):
        cfgs = list(sweep.sweep_configs(which, data_dir, 64, "cuda"))
        groups = {}
        for cfg in cfgs:
            groups.setdefault((cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension), cfg)
        grids = [GridTrainer(cfg, sweep.SWEEP_SEEDS[which], build_chunk=False)
                 for cfg in groups.values()]
        trip = [(g.model, ds, st) for g in grids for ds, st in zip(g.datasets, g.states)]
        require(all(m.bf16_dots and ds.bf16_dots for m, ds, _ in trip),
                f"{which}: --precision bf16 resolved to bf16 dots on the card")
        sphere = which == "sphere"
        rows = [k1.GridRow(ds.dimension, m.latent_dim, ds.intrinsic_dim, ds.dim,
                           None if sphere else ds.A, st.step, st.count, st.data_seed,
                           st.model_seed, ds.var_added) for m, ds, st in trip]
        c0 = cfgs[0]
        kw = dict(batch=c0.batch_size, eps_const=c0.epsilon, tdv=True, lr=c0.learning_rate,
                  dual=which == "sigmoid" or bool(hid and trip[0][0].dual_sigmoid_decoder))
        if hid:
            kw.update(enc_hidden=hid, dec_hidden=hid, kind=k5.dataset_kind(trip[0][1]))
        return [st for _, _, st in trip], rows, kw

    grid_fams = {"linear": sweep_family("linear"), "sigmoid": sweep_family("sigmoid")}
    for which, (states, rows, kw) in grid_fams.items():
        dual = kw["dual"]
        rs = np.random.RandomState(530)
        noise_rows = [_manifold_noise(torch, np, rs, r, 16, B, dev) if dual else None
                      for r in rows]
        if not dual:  # the linear manifold: x = pad(z·Aᵀ)
            noise_rows = []
            for r in rows:
                xs = np.zeros((16, B, r.data_dim), np.float32)
                xs[:, :, :r.manifold_dim] = rs.randn(16, B, r.intrinsic_dim).astype(
                    np.float32) @ r.a.cpu().numpy().T
                noise_rows.append(tuple(torch.as_tensor(t, device=dev) for t in (
                    xs, rs.randn(16, B, r.latent_dim).astype(np.float32),
                    rs.randn(16, B, r.data_dim).astype(np.float32))))
        packed = k1.pack_rows(states, rows, dual)

        def at(s, rows=rows):
            return [dataclasses.replace(r, step0=r.step0 + s, t0=r.t0 + s) for r in rows]

        for mode in ("external", "sampler"):
            def ext(s, mode=mode, noise_rows=noise_rows):
                return None if mode == "sampler" else [
                    tuple(t[s:s + 1].contiguous() for t in nz) for nz in noise_rows]
            errs["K6a"] = max(errs.get("K6a", 0.0), walk(
                f"K6a {which} ({len(rows)} rows) {mode}", 16, packed,
                lambda b, s, e, d, rows=rows, kw=kw: k1.run_grid_chunk(
                    *b, at(s, rows), n_steps=1, external_noise=e, bf16_dots=d, **kw),
                lambda b, s, e, d, rows=rows, kw=kw: k1.plain_grid_chunk(
                    *b, at(s, rows), n_steps=1, external_noise=e, bf16_dots=d, **kw),
                lambda b, rows=rows, dual=dual: k1.row_views(*b, rows, dual),
                None if mode == "sampler" else ext))
        for adam in ("f32", "bf16"):
            st = [dataclasses.replace(s, m={k: t.to(torch.bfloat16) if t.dim() >= 2 and
                                            adam == "bf16" else t for k, t in s.m.items()},
                                      v={k: t.to(torch.bfloat16) if t.dim() >= 2 and
                                         adam == "bf16" else t for k, t in s.v.items()})
                  for s in states]
            p = k1.pack_rows(st, rows, dual)
            grid = k1.run_grid_chunk(*p, rows, n_steps=64, adam_dtype=adam, bf16_dots=True,
                                     **kw)
            views = k1.row_views(*p, rows, dual)
            for i, r in enumerate(rows):
                bufs = k1.pack_state(st[i], r.data_dim, r.latent_dim, dual)
                want = k1.run_fused_chunk(
                    *bufs, r.a, n_steps=64, batch=B, data_dim=r.data_dim,
                    latent_dim=r.latent_dim, intrinsic_dim=r.intrinsic_dim,
                    manifold_dim=r.manifold_dim, step0=r.step0, t0=r.t0,
                    data_seed=r.data_seed, model_seed=r.model_seed, var_added=r.var_added,
                    eps_const=kw["eps_const"], tdv=True, lr=kw["lr"], dual=dual,
                    adam_dtype=adam, bf16_dots=True)
                torch.cuda.synchronize()
                require(torch.equal(grid[i], want) and all(
                    torch.equal(x, y) for x, y in zip(views[i], bufs)),
                    f"K6a {which} row {i}, bf16 dots, {adam} moments: = its solo launch bitwise")
            a = k1.pack_rows(st, rows, dual)
            b = clone(a)
            la = k1.run_grid_chunk(*a, rows, n_steps=40, adam_dtype=adam, bf16_dots=True, **kw)
            lb = torch.cat([
                k1.run_grid_chunk(*b, rows, n_steps=15, adam_dtype=adam, bf16_dots=True, **kw),
                k1.run_grid_chunk(*b, at(15), n_steps=25, adam_dtype=adam, bf16_dots=True,
                                  **kw)], dim=1)
            torch.cuda.synchronize()
            require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
                    f"K6a {which} bf16 dots, {adam} moments: 40 = 15 + 25 bitwise")
        print(f"K6a {which} bf16 dots: every row = its solo launch bitwise (64 steps), "
              f"40 = 15 + 25 bitwise, f32 and bf16 moments")

    # --- 54 --------------------------------------------------------------
    phase(54, "bf16 dots, the MLP kernel: K5 at sphere row 1 and a linear_gaussian MLP, "
              "K5-dual at sigmoid-MLP row 1 (32 steps one at a time), K5 and K5-dual at the "
              "narrow and ragged 7|13|200 stacks and K5 at three 8-layer stacks that put the "
              "bias row at every row of a unit (16 steps), K6b on the sphere sweep (15 "
              "rows) and 3 sigmoid-MLP rows (16 steps); clusters of 8 = 16 bitwise; rho as "
              "in phase 53")
    lin_enc, lin_dec = (12, 64, 64, 20), (20, 64, 64, 12)
    mlp = {"K5": dict(enc=SPH_ENC, dec=SPH_DEC, kind="sphere", a=None, dd=SPH_DD, eps=-3.0,
                      lr=1e-4, dual=False, var=0.0),
           "K5 linear_gaussian 64|64 +obs": dict(enc=lin_enc, dec=lin_dec, kind="linear",
                                                 a=lin_ds.A, dd=3, eps=-1.0, lr=1e-3,
                                                 dual=False, var=0.25),
           "K5-dual": dict(enc=(SIG_D, *hidden, SIG_L), dec=(SIG_L, *hidden, SIG_D),
                           kind="sigmoid", a=sig_ds.A, dd=SIG_DD, eps=-3.0, lr=1e-4,
                           dual=True, var=0.0),
           # the narrow and ragged stacks of tests/test_torch_mlp_tc.py: contractions
           # of 7, 13, 16 and 21 (padded to 16 or 32), narrow units on both sides of
           # a stack, the bias row at several rows of a unit (din 7, 13, 200, 21)
           "K5 narrow 7|13|200": dict(enc=(21, 7, 13, 200, 16), dec=(16, 7, 13, 200, 21),
                                      kind="sphere", a=None, dd=5, eps=-3.0, lr=1e-3,
                                      dual=False, var=0.0, n=16),
           "K5-dual narrow 7|13|200": dict(enc=(7, 7, 13, 200, 6), dec=(6, 7, 13, 200, 7),
                                           kind="sigmoid", a=sig_ds.A, dd=SIG_DD, eps=-3.0,
                                           lr=1e-3, dual=True, var=0.0, n=16)}
    # 8-layer stacks whose [a_in, 1]ᵀ·G products put the bias row at every row
    # of a 32-row unit (the first two) and of a narrow 16-row one (the third):
    # BIAS_ROW_STACKS, as tests/test_torch_mlp_tc.py checks
    for i, (enc, dec) in enumerate(BIAS_ROW_STACKS):
        mlp[f"K5 bias rows {i}"] = dict(enc=enc, dec=dec, kind="sphere", a=None, dd=3, eps=-3.0,
                                        lr=1e-3, dual=False, var=0.0, n=16)

    def k5_state(c, tdv):
        model = build_vae(data_dim=c["enc"][0], latent_dim=c["enc"][-1],
                          encoder_layer_sizes="|".join(map(str, c["enc"][1:-1])),
                          decoder_layer_sizes="|".join(map(str, c["dec"][1:-1])),
                          epsilon=c["eps"], tunable_decoder_var=tdv,
                          dataset_name="sigmoid" if c["dual"] else None)
        model.init_parameters(0)
        st = TrainState.create(dict(model.named_parameters()), *seeds).to(dev)
        return k5.pack_state(st, c["enc"], c["dec"], c["dual"])

    def k5_call(fn, c, bufs, n, step0, tdv, ext, dots, adam="f32"):
        return fn(*bufs, c["a"], n_steps=n, batch=B, enc_widths=c["enc"], dec_widths=c["dec"],
                  kind=c["kind"], intrinsic_dim=c["dd"], manifold_dim=c["dd"], step0=step0,
                  t0=step0, data_seed=seeds[0], model_seed=seeds[1], var_added=c["var"],
                  eps_const=c["eps"], tdv=tdv, lr=c["lr"], external_noise=ext, dual=c["dual"],
                  bf16_dots=dots, adam_dtype=adam)

    for name, c in mlp.items():
        rs = np.random.RandomState(54)
        row = k1.GridRow(c["enc"][0], c["enc"][-1], c["dd"], c["dd"], c["a"], 0, 0, 0, 0)
        cases = [(True, "sampler")]
        n_walk = c.get("n", n)
        if c["kind"] != "linear":
            ext_all = _manifold_noise(torch, np, rs, row, n_walk, B, dev)
            cases += [(True, "external")] + ([(False, "external")] if name == "K5" else [])
        for tdv, mode in cases:
            noise = None if mode == "sampler" else (
                lambda s: tuple(t[s:s + 1].contiguous() for t in ext_all))
            errs[name.split()[0]] = max(errs.get(name.split()[0], 0.0), walk(
                f"{name} tdv={tdv} {mode}", n_walk, k5_state(c, tdv),
                lambda b, s, e, d, c=c, t=tdv: k5_call(k5.run_mlp_fused_chunk, c, b, 1, s, t, e,
                                                     d),
                lambda b, s, e, d, c=c, t=tdv: k5_call(k5.plain_mlp_fused_chunk, c, b, 1, s, t,
                                                     e, d),
                lambda b: [b], noise))
        if name == "K5 linear_gaussian 64|64 +obs":
            continue
        a = k5_state(c, True)
        b = clone(a)
        la = k5_call(k5.run_mlp_fused_chunk, c, a, 40, 0, True, None, True)
        lb = torch.cat([k5_call(k5.run_mlp_fused_chunk, c, b, 15, 0, True, None, True),
                        k5_call(k5.run_mlp_fused_chunk, c, b, 25, 15, True, None, True)])
        torch.cuda.synchronize()
        require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
                f"{name} bf16 dots: 40 = 15 + 25 bitwise")
        r = k1.GridRow(c["enc"][0], c["enc"][-1], c["dd"], c["dd"], c["a"], 0, 0, *seeds)
        outs = {}
        for cluster in (8, 16):
            bufs = k5_state(c, True)
            out = torch.empty(1, 16, device=dev)
            k5._launch([bufs], out, [r], n_steps=16, batch=B, enc_hidden=c["enc"][1:-1],
                       dec_hidden=c["dec"][1:-1], kind=c["kind"], eps_const=c["eps"], tdv=True,
                       lr=c["lr"], dual=c["dual"], external_noise=None, adam_dtype="f32",
                       bf16_dots=True, cluster=cluster)
            torch.cuda.synchronize()
            require(k5.last_launch()["cluster_size"] == cluster, f"clusters of {cluster}")
            outs[cluster] = (out, bufs)
        require(torch.equal(outs[8][0], outs[16][0]) and all(
            torch.equal(x, y) for x, y in zip(outs[8][1], outs[16][1])),
            f"{name} bf16 dots: clusters of 8 = 16 bitwise (16 steps)")
        print(f"{name} bf16 dots: 40 = 15 + 25 bitwise; clusters of 8 = 16 bitwise")

    sig_cfg = parse_arguments(["dual", *SIGMOID_MLP_ROW1, "--num_batches", "64",
                               "--kernels", "cuda", "--device", "cuda", "--data_dir", data_dir])
    k6b = {"sphere": sweep_family("sphere", hidden)}
    grids = [GridTrainer(sig_cfg, [69, 24, 48], build_chunk=False)]
    trip = [(g.model, ds, st) for g in grids for ds, st in zip(g.datasets, g.states)]
    k6b["sigmoid-MLP"] = (
        [st for _, _, st in trip],
        [k1.GridRow(ds.dimension, m.latent_dim, ds.intrinsic_dim, ds.dim, ds.A, st.step,
                    st.count, st.data_seed, st.model_seed, ds.var_added) for m, ds, st in trip],
        dict(batch=B, eps_const=-3.0, tdv=True, lr=1e-4, dual=True, enc_hidden=hidden,
             dec_hidden=hidden, kind="sigmoid"))
    for which, (states, rows, kw) in k6b.items():
        dual = kw["dual"]
        rs = np.random.RandomState(54)
        noise_rows = [_manifold_noise(torch, np, rs, r, 16, B, dev) for r in rows]
        packed = k5.pack_rows(states, rows, hidden, hidden, dual)

        def at(s, rows=rows):
            return [dataclasses.replace(r, step0=r.step0 + s, t0=r.t0 + s) for r in rows]

        for mode in ("external", "sampler") if which == "sphere" else ("external",):
            def ext(s, noise_rows=noise_rows):
                return [tuple(t[s:s + 1].contiguous() for t in nz) for nz in noise_rows]
            errs["K6b"] = max(errs.get("K6b", 0.0), walk(
                f"K6b {which} ({len(rows)} rows) {mode}", 16, packed,
                lambda b, s, e, d, rows=rows, kw=kw: k5.run_grid_chunk(
                    *b, at(s, rows), n_steps=1, external_noise=e, bf16_dots=d, **kw),
                lambda b, s, e, d, rows=rows, kw=kw: k5.plain_grid_chunk(
                    *b, at(s, rows), n_steps=1, external_noise=e, bf16_dots=d, **kw),
                lambda b, rows=rows, dual=dual: k5.row_views(*b, rows, hidden, hidden, dual),
                None if mode == "sampler" else ext))
        p = k5.pack_rows(states, rows, hidden, hidden, dual)
        grid = k5.run_grid_chunk(*p, rows, n_steps=32, bf16_dots=True, **kw)
        views = k5.row_views(*p, rows, hidden, hidden, dual)
        for i, r in enumerate(rows):
            bufs = k5.pack_state(states[i], *k5.row_widths(r, hidden, hidden), dual)
            e, d_ = k5.row_widths(r, hidden, hidden)
            want = k5.run_mlp_fused_chunk(
                *bufs, r.a, n_steps=32, batch=B, enc_widths=e, dec_widths=d_, kind=kw["kind"],
                intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim, step0=r.step0,
                t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed, var_added=r.var_added,
                eps_const=kw["eps_const"], tdv=True, lr=kw["lr"], dual=dual, bf16_dots=True)
            torch.cuda.synchronize()
            require(torch.equal(grid[i], want) and all(
                torch.equal(x, y) for x, y in zip(views[i], bufs)),
                f"K6b {which} row {i}, bf16 dots: = its solo launch bitwise")
        print(f"K6b {which} bf16 dots: every row = its solo K5 launch bitwise (32 steps)")

    # --- 55 --------------------------------------------------------------
    phase(55, "bf16 dots, the torch path: one CUDA graph replay a step = op by op bitwise "
              "at sphere row 1 (200 steps), the conv epoch's graph = op by op bitwise; "
              "--resume in mid-chunk (phases 40 and 45 run the CLI's default bf16)")

    def sphere_model(dots):
        model = build_vae(data_dim=SPH_D, latent_dim=SPH_L, encoder_layer_sizes="200|200|200",
                          decoder_layer_sizes="200|200|200", epsilon=-3.0,
                          tunable_decoder_var=True, bf16_dots=dots)
        model.init_parameters(0)
        return model.to(dev)

    def fresh(model):
        return TrainState.create(dict(model.named_parameters()), *seeds)

    def same(label, a, b):
        (sa, la), (sb, lb) = a, b
        require(bool(torch.isfinite(la).all()), f"{label}: finite losses")
        require(torch.equal(la, lb) and all(
            torch.equal(x, getattr(sb, t)[k]) for t in ("params", "m", "v")
            for k, x in getattr(sa, t).items()), f"{label}: graph = op by op bitwise")

    sph_ds = SphereDataset(SPH_DD, SPH_D - SPH_DD, device=dev)
    model = sphere_model(True)
    eager = torch_step.train_chunk(model, sph_ds, fresh(model), 200, batch_size=B, lr=1e-4)
    graph = torch_step.GraphChunk(model, sph_ds, batch_size=B, lr=1e-4)(fresh(model), 200)
    torch.cuda.synchronize()
    same("sphere row 1 bf16 dots, 200 steps", eager, graph)
    f32 = torch_step.train_chunk(sphere_model(False), sph_ds, fresh(model), 200, batch_size=B,
                                 lr=1e-4)
    require(not torch.equal(f32[1], eager[1]), "the bf16-dot torch path parts from fp32's")
    print(f"sphere row 1, bf16 dots: graph = op by op bitwise over 200 steps; loss "
          f"{eager[1][0].item():.4f} -> {eager[1][-1].item():.4f} (fp32: "
          f"{f32[1][-1].item():.4f})")
    img = ImageDataset.synthetic_digits(0, n=4096, size=28, device=dev)

    def conv_model(dots):
        m = build_conv_vae(image_hwc=img.shape, latent_dim=16, channels_spec="32|64",
                           epsilon=-1.0, tunable_decoder_var=True, bf16_dots=dots)
        m.init_parameters(0)
        return m.to(dev)

    cmodel = conv_model(True)
    ckw = dict(batch_size=128, lr=1e-3)
    ce = torch_step.EpochChunk(cmodel, img, graph=False, **ckw)(fresh(cmodel), 0)
    cg = torch_step.EpochChunk(cmodel, img, graph=True, **ckw)(fresh(cmodel), 0)
    torch.cuda.synchronize()
    same("conv epoch bf16 dots", ce, cg)
    print(f"conv epoch, bf16 dots: graph = op by op bitwise (32 steps); loss "
          f"{ce[1][0].item():.3f} -> {ce[1][-1].item():.3f}")

    # --- 56 --------------------------------------------------------------
    phase(56, "times, bf16 dots against fp32 dots in turn (fp32, bf16, bf16, fp32), "
              "with the card's name and power limit")
    print(f"card: {smi}")

    def in_turn(label, fn, steps, min_seconds=0.2):
        r = {}
        for dots in (False, True, True, False):
            r.setdefault(dots, []).append(_steps_per_second(torch, lambda: fn(dots), steps,
                                                            min_seconds))
        ms = {dots: 1e3 / max(v) for dots, v in r.items()}
        print(f"{label}: fp32 dots {ms[False] * 1e3:.3f} µs, bf16 dots {ms[True] * 1e3:.3f} µs "
              f"a step ({ms[True] / ms[False]:.3f}x)")
        return ms

    times = {}
    for name, c in solo.items():
        bufs = k1_state(c, True)
        times[name] = in_turn(f"{name} (5000-step launches)", lambda d, c=c, b=bufs: k1_call(
            k1.run_fused_chunk, c, b, 5000, 0, True, None, d), 5000)
    for name in ("K5", "K5-dual"):
        c, bufs = mlp[name], k5_state(mlp[name], True)
        times[name] = in_turn(f"{name} (200-step launches)", lambda d, c=c, b=bufs: k5_call(
            k5.run_mlp_fused_chunk, c, b, 200, 0, True, None, d), 200)
    for which, (states, rows, kw) in grid_fams.items():
        p = k1.pack_rows(states, rows, kw["dual"])
        times[f"K6a {which}"] = in_turn(
            f"K6a {which}, {len(rows)} rows (2000-step launches; a launch-step)",
            lambda d, p=p, rows=rows, kw=kw: k1.run_grid_chunk(*p, rows, n_steps=2000,
                                                               bf16_dots=d, **kw), 2000)
    states, rows, kw = k6b["sphere"]
    p = k5.pack_rows(states, rows, hidden, hidden, False)
    times["K6b"] = in_turn("K6b sphere, 15 rows (100-step launches; a launch-step)",
                           lambda d: k5.run_grid_chunk(*p, rows, n_steps=100, bf16_dots=d,
                                                       **kw), 100)

    def moments_in_turn(label, fn, steps):
        """K4 in the bf16-dot mode: f32 against bf16 moments, in turn."""
        r = {}
        for adam in ("f32", "bf16", "bf16", "f32"):
            r.setdefault(adam, []).append(_steps_per_second(torch, lambda: fn(adam), steps, 0.2))
        us = {a: 1e6 / max(v) for a, v in r.items()}
        print(f"{label}, bf16 dots: f32 moments {us['f32']:.3f} µs, bf16 moments "
              f"{us['bf16']:.3f} µs a step ({us['bf16'] / us['f32']:.4f}x)")

    for name in ("K5", "K5-dual"):
        c, mbufs = mlp[name], {a: k5_state(mlp[name], True) for a in ("f32", "bf16")}
        moments_in_turn(f"K4 in {name} (200-step launches)", lambda a, c=c, b=mbufs: k5_call(
            k5.run_mlp_fused_chunk, c, b[a], 200, 0, True, None, True, a), 200)
    pm = {a: k5.pack_rows(states, rows, hidden, hidden, False) for a in ("f32", "bf16")}
    moments_in_turn("K4 in K6b sphere, 15 rows (100-step launches; a launch-step)",
                    lambda a: k5.run_grid_chunk(*pm[a], rows, n_steps=100, bf16_dots=True,
                                                adam_dtype=a, **kw), 100)
    for name, c in solo.items():
        kb = {a: k1_state(c, True, a) for a in ("f32", "bf16")}
        moments_in_turn(f"K4 in {name} (5000-step launches)", lambda a, c=c, kb=kb: k1_call(
            k1.run_fused_chunk, c, kb[a], 5000, 0, True, None, True, a), 5000)
    for which, (lstates, lrows, lkw) in grid_fams.items():
        pk = {a: k1.pack_rows(lstates, lrows, lkw["dual"]) for a in ("f32", "bf16")}
        moments_in_turn(f"K4 in K6a {which}, {len(lrows)} rows (2000-step launches; a "
                        f"launch-step)", lambda a, pk=pk, lrows=lrows, lkw=lkw: k1.run_grid_chunk(
                            *pk[a], lrows, n_steps=2000, bf16_dots=True, adam_dtype=a, **lkw),
                        2000)
    plain = {}
    for name, c in solo.items():  # the plain versions: the torch path op by op
        plain[name] = in_turn(f"{name}'s plain version (20 steps)", lambda d, c=c: k1_call(
            k1.plain_fused_chunk, c, k1_state(c, True), 20, 0, True, None, d), 20)
    for name in ("K5", "K5-dual"):
        plain[name] = in_turn(f"{name}'s plain version (20 steps)", lambda d, name=name: k5_call(
            k5.plain_mlp_fused_chunk, mlp[name], k5_state(mlp[name], True), 20, 0, True, None,
            d), 20)
    for which, (states, rows, kw) in grid_fams.items():
        p = k1.pack_rows(states, rows, kw["dual"])
        plain[f"K6a {which}"] = in_turn(
            f"K6a {which}'s plain version (1 step; a launch-step)",
            lambda d, p=p, rows=rows, kw=kw: k1.plain_grid_chunk(*p, rows, n_steps=1,
                                                                 bf16_dots=d, **kw), 1)
    states, rows, kw = k6b["sphere"]
    p6 = k5.pack_rows(states, rows, hidden, hidden, False)
    plain["K6b"] = in_turn("K6b sphere's plain version (1 step; a launch-step)",
                           lambda d: k5.plain_grid_chunk(*p6, rows, n_steps=1, bf16_dots=d,
                                                         **kw), 1)
    gmodels = {d: sphere_model(d) for d in (False, True)}
    gchunks = {d: torch_step.GraphChunk(gmodels[d], sph_ds, batch_size=B, lr=1e-4)
               for d in (False, True)}
    gstates = {d: fresh(gmodels[d]) for d in (False, True)}
    in_turn("the torch path at sphere row 1, one CUDA graph replay a step (200 steps)",
            lambda d: gchunks[d](gstates[d], 200), 200)
    cmodels = {d: conv_model(d) for d in (False, True)}
    cchunks = {d: torch_step.EpochChunk(cmodels[d], img, graph=True, **ckw) for d in (False, True)}
    cstates = {d: fresh(cmodels[d]) for d in (False, True)}
    in_turn("the conv step, one CUDA graph replay an epoch (32 steps)",
            lambda d: cchunks[d](cstates[d], 0), CONV_NB)
    for config in ("linear", "sigmoid", "sphere", "grid_linear", "grid_sigmoid", "grid_sphere",
                   "conv"):
        if config in _BENCH_FP32:  # phase 33's or 47's run, --precision fp32
            print(f"bench --config {config} --precision fp32 (phase 33 or 47): "
                  f"{_BENCH_FP32[config]}")
        for prec in ("bf16",) if config in _BENCH_FP32 else ("fp32", "bf16"):
            proc = _bench(["--config", config, "--precision", prec])
            require(proc.returncode == 0, f"bench {config} --precision {prec} returned 0")
            (line,) = proc.stdout.strip().splitlines()
            print(f"bench --config {config} --precision {prec}: {line}")
            kl = [ln for ln in proc.stderr.splitlines() if ln.startswith("[kernels]")][:1]
            require(not kl or ("bf16-operand dots" in kl[0]) == (prec == "bf16"),
                    f"bench {config} {prec}: the [kernels] line names the dot mode")

    flops = {"K1": linear_flops(B, D, L, ID, ID, False),
             "K2": linear_flops(B, SIG_D, SIG_L, SIG_DD, SIG_DD, True),
             "K5": mlp_flops(B, SPH_ENC, SPH_DEC),
             "K5-dual": mlp_flops(B, mlp["K5-dual"]["enc"], mlp["K5-dual"]["dec"], True)}
    state_bytes = {"K1": 6 * 4 * k1.n_params(D, L), "K2": 6 * 4 * k1.n_params(SIG_D, SIG_L, True),
                   "K5": 6 * 4 * k5.n_params(SPH_ENC, SPH_DEC),
                   "K5-dual": 6 * 4 * k5.n_params(mlp["K5-dual"]["enc"], mlp["K5-dual"]["dec"],
                                                  True)}
    steps = {"K1": 5000, "K2": 5000, "K5": 200, "K5-dual": 200}
    for which, (states, rows, kw) in grid_fams.items():
        flops[f"K6a {which}"] = sum(linear_flops(B, r.data_dim, r.latent_dim, r.intrinsic_dim,
                                                 r.manifold_dim, kw["dual"]) for r in rows)
        state_bytes[f"K6a {which}"] = 6 * 4 * k1.row_offsets(rows, kw["dual"])[-1]
        steps[f"K6a {which}"] = 2000
    states, rows, kw = k6b["sphere"]
    flops["K6b"] = sum(mlp_flops(B, *k5.row_widths(r, hidden, hidden)) for r in rows)
    state_bytes["K6b"] = 6 * 4 * k5.row_offsets(rows, hidden, hidden)[-1]
    steps["K6b"] = 100
    names = {"K1": ("linear_vae_chunk (K1)", "kernels/linear_vae.py:678"),
             "K2": ("linear_vae_chunk dual (K2)", "kernels/linear_vae.py:678"),
             "K6a linear": ("linear_vae_grid_chunk (K6a), linear sweep, 21 rows",
                            "kernels/linear_vae.py:678"),
             "K6a sigmoid": ("linear_vae_grid_chunk (K6a), sigmoid sweep, 18 rows",
                             "kernels/linear_vae.py:678"),
             "K5": ("mlp_vae_chunk (K5)", "kernels/mlp_vae.py:644"),
             "K5-dual": ("mlp_vae_chunk dual (K5-dual)", "kernels/mlp_vae.py:644"),
             "K6b": ("mlp_vae_chunk grid (K6b), sphere sweep, 15 rows",
                     "kernels/mlp_vae.py:644")}
    # launches: the wrapper's count on the main path (phases 5, 11, 16, 20),
    # which runs the CLI's default, bf16 dots; 0 in --only-bf16-dots
    by_name = {r["name"]: r for r in records}
    for key, (name, site) in names.items():
        fp32_rec = by_name.get(name, {})
        err_key = key.split()[0]
        rows_n = 1 if key in ("K1", "K2", "K5", "K5-dual") else None
        records.append({
            "name": f"{name}, bf16 dots", "route": "cuda",
            "source": ("vae_training_tpu_torch/csrc/linear_vae.cu" if key.startswith(("K1", "K2",
                       "K6a")) else "vae_training_tpu_torch/csrc/mlp_vae.cu"),
            "replaces": f"vae_training_tpu/{site}",
            "launches": fp32_rec.get("launches", 0), "max_abs_err": errs[err_key],
            "ms": times[key][True], "plain_ms": plain[key][True],
            **_bound(flops[key], state_bytes[key], steps[key],
                     losses_per_step=rows_n or len(grid_fams.get(key.split()[-1], k6b["sphere"])[1]),
                     peak=BF16_PEAK),
            "library_ms": None, "fp32_dots_ms": times[key][False],
            "fp32_dots_plain_ms": plain[key][False]})
    print("the bf16-dot records: " + "; ".join(
        f"{r['name']} {r['ms'] * 1e3:.3f} µs (fp32 dots {r['fp32_dots_ms'] * 1e3:.3f}), bound "
        f"{r['bound_ms'] * 1e3:.4f} µs by {r['bound_by']}" for r in records
        if r["name"].endswith("bf16 dots")))

    # --- 57 --------------------------------------------------------------
    phase(57, "the CLI's three rows 1 at 12000 steps under --precision fp32, beside the bf16 "
              "runs of phases 5 and 11")

    def cli(name, flags, *extra):
        cfg = parse_arguments([name, *flags, "--num_batches", "12000", "--kernels", "cuda",
                               "--device", "cuda", "--data_dir", data_dir, *extra])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        require(rc == 0, f"{name}: main() returned 0")
        kline = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[kernels]")]
        return buf.getvalue(), kline[0] if kline else ""

    pad_key = {"linear": "Squared Norm of padding dimensions",
               "sigmoid": "Squared Norm of Padding Dimensions", "sphere": "Padding Error"}
    for which, flags in (("linear", ROW1), ("sigmoid", SIGMOID_ROW1), ("sphere", SPHERE_ROW1)):
        dirs = {}
        for prec in ("bf16", "fp32"):
            given = (row1_dirs or {}).get(which) if prec == "bf16" else None
            if given is None:
                _, kline = cli(f"row1_{which}_{prec}", flags, "--precision", prec)
                require(("bf16-operand dots" in kline) == (prec == "bf16"),
                        f"{which} {prec}: the [kernels] line names the dot mode ({kline})")
                given = os.path.join(data_dir, f"row1_{which}_{prec}")
            dirs[prec] = given
        z = {p: np.load(os.path.join(d, "losses.npz")) for p, d in dirs.items()}
        for prec in ("bf16", "fp32"):
            # the interleaved trace: the evals at 0, 5000 and 10000 sit at
            # 0, 5001 and 10002, each after the steps before it
            ev, pad = z[prec]["VAE Loss"][[0, 5001, 10002]], z[prec][pad_key[which]]
            print(f"{which} row 1, --precision {prec}: eval VAE Loss {ev[0]:.4f} -> "
                  f"{ev[-1]:.4f}; padding {pad[0]:.6f} -> {pad[-1]:.6f}")
            require(bool(np.all(np.isfinite(z[prec]["VAE Loss"]))), f"{which} {prec}: finite")
            require(ev[-1] < ev[0] and pad[-1] < pad[0],
                    f"{which} {prec}: the eval loss and the padding norm fall")


def _supervision(torch, np, smi, data_dir):
    """Phases 58 and 59: the sweep runner's supervised rows (--isolate,
    --row_timeout, --retries) and --ckpt_backend orbax (a DCP directory) on
    the card."""
    from vae_training_tpu_torch._scripts import _supervise, sweep
    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.kernels import linear_vae as k1, mlp_vae as k5
    from vae_training_tpu_torch.runio import checkpoint as ck
    from vae_training_tpu_torch.train import step as torch_step

    def reset_counts():
        k1.run_fused_chunk.launches = k5.run_mlp_fused_chunk.launches = 0
        _torch_chunks(torch_step, reset=True)

    def run_sweep(sub, *argv):
        out, err = io.StringIO(), io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = sweep.main([*argv, "--data_dir", os.path.join(data_dir, sub)])
        return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t

    def same_checkpoint(dir_a, dir_b):
        a, b = ck.restore_checkpoint(dir_a), ck.restore_checkpoint(dir_b)
        require((a.step, a.count, a.data_seed, a.model_seed)
                == (b.step, b.count, b.data_seed, b.model_seed), f"{dir_b}: checkpoint counts")
        for tree in ("params", "m", "v"):
            ta, tb = getattr(a, tree), getattr(b, tree)
            require(list(ta) == list(tb) and all(
                ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]) for k in ta),
                f"{dir_b}: checkpoint {tree} bitwise equal")

    # --- 58 --------------------------------------------------------------
    phase(58, "supervised rows: vae-sweep-torch --isolate, each run in a process of its own, "
              "and a run its deadline ends, resumed from its checkpoint")
    print(smi)
    linear = ["linear", "--num_batches", "12000", "--shard", "0/11"]
    reset_counts()
    rc, out, err, secs = run_sweep("linear_iso", *linear, "--isolate")
    names = [c.name for c in sweep.shard_items(
        list(sweep.sweep_configs("linear", "", 12000, "auto")), (0, 11))]
    print("\n".join(ln for ln in out.splitlines() if ln.startswith("[sweep]")))
    require(rc == 0 and all(f"[sweep] {n} done in" in out for n in names),
            f"--isolate linear --shard 0/11: rc 0, {len(names)} runs done")
    require(out.count("[kernels] cuda: fused linear-VAE kernel K1 (") == len(names),
            "each child's [kernels] line names K1")
    require(err.count("device: cuda (") == len(names), "each child printed its device line")
    require(k1.run_fused_chunk.launches == 0 and _torch_chunks(torch_step) == 0,
            "the supervising process launched nothing")
    reset_counts()
    rc, out, _, secs_in = run_sweep("linear_inproc", *linear)
    launches = k1.run_fused_chunk.launches
    require(rc == 0 and launches > 0 and _torch_chunks(torch_step) == 0,
            "the in-process runs ran on K1")
    for n in names:
        _require_same_run(np, os.path.join(data_dir, "linear_iso", n),
                          os.path.join(data_dir, "linear_inproc", n))
        same_checkpoint(os.path.join(data_dir, "linear_inproc", n),
                        os.path.join(data_dir, "linear_iso", n))
    print(f"{len(names)} isolated runs in {secs:.2f} s (in process {secs_in:.2f} s, K1 launches "
          f"{launches}): losses.npz, model.pkl and the checkpoint bitwise the in-process runs'")

    # sphere row 1 (K5), 60000 steps, a checkpoint every 10000: uninterrupted,
    # then with a row timeout of about half its wall time and one retry
    sphere = ["sphere", "--isolate", "--shard", "0/15", "--num_batches", "60000",
              "--checkpoint_every", "10000"]
    name = next(iter(sweep.sweep_configs("sphere", "", 60000, "auto"))).name
    attempts = []  # (argv, checkpoint step on disk at the start, stdout offset)
    real_supervised = _supervise.run_supervised
    sink = {}

    def watched(argv, **kw):
        run_dir = argv[argv.index("--data_dir") + 1] + "/" + name
        meta = ck.read_checkpoint_meta(run_dir) or {}
        attempts.append((list(argv), meta.get("step"), len(sink["out"].getvalue())))
        return real_supervised(argv, **kw)

    def supervised_sweep(sub, *extra):
        out, err = io.StringIO(), io.StringIO()
        sink["out"] = out
        timeline = []  # (seconds since start, checkpoint step) as the child saves
        done = []

        def watch(run_dir=os.path.join(data_dir, sub, name)):
            last = None
            while not done:
                step = (ck.read_checkpoint_meta(run_dir) or {}).get("step")
                if step != last and step is not None:
                    timeline.append((time.perf_counter() - t, step))
                    last = step
                time.sleep(0.02)

        _supervise.run_supervised = watched
        attempts.clear()
        t = time.perf_counter()
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = sweep.main([*sphere, *extra, "--data_dir", os.path.join(data_dir, sub)])
        finally:
            _supervise.run_supervised = real_supervised
            done.append(True)
            watcher.join()
        return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t, timeline

    reset_counts()
    rc, out, err, wall, timeline = supervised_sweep("sphere_whole", "--retries", "0")
    whole_out = out
    require(rc == 0 and f"[sweep] {name} done in" in out, "the uninterrupted sphere run")
    require("[kernels] cuda: fused MLP-VAE kernel K5 (" in out, "its [kernels] line names K5")
    require(k5.run_mlp_fused_chunk.launches == 0, "the supervising process launched nothing")
    print(f"uninterrupted: {wall:.2f} s; checkpoints (s, step): "
          + ", ".join(f"({s:.2f}, {st})" for s, st in timeline))
    start = next((s for s, st in timeline if st == 0), None)  # the step-0 save: start-up
    steps = int(sphere[sphere.index("--num_batches") + 1])
    mid = [s for s, st in timeline if 0 < st < steps - 1]  # 59999: the last step's save
    require(start is not None and len(mid) >= 3, f"the run wrote mid-run checkpoints ({len(mid)})")
    # Half the wall time cannot do: a retry pays the start-up again (the
    # process, the CUDA context, the libraries, the step-0 events), so after
    # a deadline T it needs start-up + (wall - t), t the time its checkpoint
    # landed in attempt 1, t >= T - interval: T >= (wall + start-up +
    # interval) / 2, over half the wall time. Add 1.5 s of margin; T must
    # still end attempt 1 before its end.
    interval = (mid[-1] - mid[0]) / (len(mid) - 1)
    timeout = round((wall + start + interval) / 2 + 1.5, 1)
    require(timeout < wall - interval,
            f"the deadline {timeout} s ends attempt 1 before its end ({wall:.2f} s)")
    print(f"--row_timeout {timeout} s: (wall {wall:.2f} + start-up {start:.2f} + checkpoint "
          f"interval {interval:.2f}) / 2 + 1.5 s, {timeout / wall:.0%} of the wall time (half, "
          f"{wall / 2:.2f} s, leaves a retry too little)")
    rc, out, err, secs, timeline = supervised_sweep("sphere_killed", "--retries", "1",
                                                    "--row_timeout", str(timeout))
    print("\n".join(ln for ln in (out + err).splitlines()
                    if ln.startswith(("[sweep", "[resume]"))))
    print(f"killed and resumed: {secs:.2f} s; checkpoints (s, step): "
          + ", ".join(f"({s:.2f}, {st})" for s, st in timeline))
    require(rc == 0 and f"[sweep] {name} done in" in out, "the killed row succeeded on retry")
    require(f"run exceeded {timeout:.0f}s (attempt 1/2); terminating" in err,
            "attempt 1 ended at its deadline ('run exceeded')")
    require(len(attempts) == 2, f"two attempts ({len(attempts)})")
    (argv1, _, _), (argv2, step2, offset2) = attempts
    run_dir = os.path.join(data_dir, "sphere_killed", name)
    require("-ow" in argv1 and "--resume" not in argv1, "attempt 1 started fresh")
    require("-ow" not in argv2 and argv2[-2:] == ["--resume", run_dir],
            "attempt 2 carries --resume <run dir> and no -ow")
    second = out[offset2:]
    resumed_at = [int(m) for m in re.findall(r"^Batch \| (\d+) \|", second, re.M)]
    print(f"attempt 2 began with the meta at step {step2}; its first stat line is at "
          f"step {resumed_at[0] if resumed_at else None}")
    # it resumes from the newest complete save (restore_run): the meta's
    # step or, after a kill in the middle of a save, the one before; its
    # first stat line is that step, or the next where the save came after
    # that step's events; its host history comes with it (no banner)
    require(step2 is not None and step2 > 0 and resumed_at and resumed_at[0] > 0
            and "Score for real data" not in second,
            "attempt 2 resumed from a step > 0 with its run's history")
    whole = os.path.join(data_dir, "sphere_whole", name)
    stat_lines = {"whole": whole_out, "killed": out}
    if not _same_npz(np, whole, run_dir):
        # tell a resume fault from a run that is not reproducible across
        # processes: a second uninterrupted run, and the stat lines of all
        rc, stat_lines["whole2"], _, _, _ = supervised_sweep("sphere_whole2", "--retries", "0")
        print(f"a second uninterrupted run equals the first: "
              f"{_same_npz(np, whole, os.path.join(data_dir, 'sphere_whole2', name))}")
        for label, text in stat_lines.items():
            print(f"{label}:\n" + "\n".join(ln[:120] for ln in text.splitlines()
                                             if ln.startswith("Batch |")))
    _require_same_run(np, whole, run_dir)
    same_checkpoint(whole, run_dir)
    print("the killed and resumed run's losses.npz, model.pkl and checkpoint equal the "
          "uninterrupted run's bitwise")

    # --- 59 --------------------------------------------------------------
    phase(59, "--ckpt_backend orbax (a torch.distributed.checkpoint directory) on the card: "
              "40000 = 15000 + --resume, linear row 1 on K1")
    dcp_dir = os.path.join(data_dir, "dcp")

    def cli(name, num_batches, *extra):
        cfg = parse_arguments([name, *ROW1, "--num_batches", str(num_batches), "--kernels",
                               "cuda", "--device", "cuda", "--data_dir", dcp_dir, *extra])
        reset_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        require(rc == 0 and k1.run_fused_chunk.launches > 0 and _torch_chunks(torch_step) == 0,
                f"{name}: rc 0 on K1 ({k1.run_fused_chunk.launches} launches)")
        return time.perf_counter() - t

    orbax = ["--ckpt_backend", "orbax"]
    for adam in ("f32", "bf16"):
        flags = [*orbax, "--adam_dtype", adam]
        t_whole = cli(f"whole_{adam}", 40000, *flags)
        cli(f"part_{adam}", 15000, *flags)
        part = os.path.join(dcp_dir, f"part_{adam}")
        require(os.path.isdir(os.path.join(part, ck.DCP_NAME))
                and not os.path.exists(os.path.join(part, ck.CKPT_NAME)),
                f"{adam}: the run wrote a DCP directory and no torch.save checkpoint")
        t_resume = cli(f"part_{adam}", 40000, *flags, "--resume", part)
        meta = ck.read_checkpoint_meta(part)
        require(meta["backend"] == "dcp" and meta["step"] == 40000 and meta["adam_dtype"] == adam,
                f"{adam}: the meta names the DCP backend at step 40000 ({meta})")
        state = ck.restore_checkpoint(part)
        want = torch.bfloat16 if adam == "bf16" else torch.float32
        require(state.m["Encoder.FC0.kernel"].dtype == want, f"{adam}: the moments' dtype")
        _require_same_run(np, os.path.join(dcp_dir, f"whole_{adam}"), part)
        same_checkpoint(os.path.join(dcp_dir, f"whole_{adam}"), part)
        print(f"--adam_dtype {adam}: 40000 steps {t_whole:.2f} s; 15000 + --resume to 40000 "
              f"({t_resume:.2f} s) equal to it bitwise (losses.npz, model.pkl, DCP state)")
    cli("default", 15000)
    default = os.path.join(dcp_dir, "default")
    require(ck.read_checkpoint_meta(default)["backend"] == "torch", "a default-backend run")
    cli("default", 40000, *orbax, "--resume", default)
    require(ck.read_checkpoint_meta(default)["backend"] == "dcp", "resumed under orbax")
    _require_same_run(np, os.path.join(dcp_dir, "whole_f32"), default)
    same_checkpoint(os.path.join(dcp_dir, "whole_f32"), default)
    print("a default-backend run at 15000, resumed under orbax to 40000, equals the "
          "uninterrupted orbax run bitwise")


def _kernel_events(torch, fn):
    """(name, µs) of every CUDA kernel ``fn`` ran, from a torch.profiler
    trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            events = json.load(g)["traceEvents"]
    return [(e["name"], e["dur"]) for e in events if e.get("cat") == "kernel"]


def _kernel_ms(torch, fn):
    """Device time of ``fn`` as the sum of its CUDA kernels' durations in a
    torch.profiler trace, and their count (None, 0 when the trace holds no
    kernel)."""
    durs = [d for _, d in _kernel_events(torch, fn)]
    return (sum(durs) / 1e3 if durs else None), len(durs)


def _kernel_table(torch, fn, steps, top=10):
    """Where ``fn``'s ``steps`` steps spend their kernel time: the ``top``
    kernel names by time, each with µs and launches a step."""
    by_name = {}
    for name, dur in _kernel_events(torch, fn):
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + dur, n + 1)
    total = sum(t for t, _ in by_name.values())
    print(f"  kernel time by name, a step ({total / steps:.1f} us in all):")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {t / steps:9.2f} us {n / steps:6.1f} launches  {name[:90]}")


def _timed(torch, label, fn, steps, traced, warm=2):
    """Wall ms a step (host clock to a sync) and the CUDA-event span a step
    over one call of ``fn(steps)``, and the profiler's kernel time a step
    over one call of ``fn(traced)``, after a warm call of ``fn(warm)`` (a
    graph chunk given a new state captures there). Returns (wall, event,
    kernel ms a step, kernels a step)."""
    fn(warm)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    e0.record()
    fn(steps)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / steps
    event = e0.elapsed_time(e1) / steps
    busy, n_kernels = _kernel_ms(torch, lambda: fn(traced))
    busy = None if busy is None else busy / traced
    busy_txt = ("kernel time not in the trace" if busy is None else
                f"kernels {busy:.4f} ms a step ({n_kernels // traced} a step), "
                f"busy share {busy / wall:.3f}")
    print(f"  {label}: wall {wall:.4f} ms a step, CUDA-event span {event:.4f}, {busy_txt} "
          f"(at {time.perf_counter() - _T0:.1f} s)")
    return wall, event, busy, n_kernels // traced


def _torch_chunks(torch_step, reset: bool = False) -> int:
    """Chunks the torch path ran, op by op (``train_chunk``) or as CUDA-graph
    replays (``GraphChunk``); ``reset`` sets both counts to 0 first."""
    if reset:
        torch_step.train_chunk.calls = torch_step.GraphChunk.calls = 0
    return torch_step.train_chunk.calls + torch_step.GraphChunk.calls


def _ulp_keys(torch, x):
    """bfloat16 values → int32 keys monotonic in float order, 1 apart per
    ulp (tests/kernel_test_helpers.py's _bf16_ulp_keys)."""
    s = x.bfloat16().view(torch.int16).to(torch.int32)
    return torch.where(s < 0, -32768 - s, s)


def _require_rounded(torch, label, f32_losses, losses, f32_rows, rows, layouts):
    """One step from the same state: the bf16 launch's weight-matrix moments
    are the f32 launch's rounded to nearest even, bitwise; its other
    moments, its vector parameters and its losses are the f32 launch's (the
    gradients and the f32 update are the same code; K4 only rounds)."""
    from vae_training_tpu_torch.kernels.linear_vae import matrix_mask

    require(torch.equal(f32_losses, losses), f"{label}: bf16 losses equal the f32 launch's")
    for i, ((fp, fm, fv), (p, m, v), lay) in enumerate(zip(f32_rows, rows, layouts)):
        mask = matrix_mask(lay).to(p.device)
        require(torch.equal(p[~mask], fp[~mask]), f"{label} row {i}: vector params equal")
        for name, got, ref in (("m", m, fm), ("v", v, fv)):
            require(torch.equal(got[mask], ref[mask].bfloat16().float()),
                    f"{label} row {i}: bf16 {name} is the f32 launch's rounded to nearest even")
            require(torch.equal(got[~mask], ref[~mask]),
                    f"{label} row {i}: f32-slot {name} equals the f32 launch's")


def _hold_bf16(torch, np, label, losses, plain_losses, rows, plain_rows, layouts, tol, mode,
               norms=False):
    """Hold a bf16-moment launch to its plain version. Losses at ``tol``;
    params and the f32 moment slots elementwise at ``tol`` (``norms``: p, m
    and v by relative 2-norm, as _hold_mlp). Each weight matrix's moments
    (bfloat16 values on both sides, checked) by tests/kernel_test_helpers.py's
    ulp contract: ``strict``, at most 1 bf16 ulp apart where they differ by
    more than the f32 atol; ``drift``, |d| <= max(1e-3, 0.02|x|); and at
    least 95% bitwise, each matrix. ``tail`` (the MLP kernel at full width):
    at most 0.1% of a row's matrix moments outside the drift bound, and 95%
    of them bitwise: the ReLU-mask and rounding-floor partings that
    _hold_mlp describes move single elements of m past any elementwise
    bound (one SigDecoder.FC0.kernel element at 2.7x the drift bound in 32
    steps of 3 sigmoid-MLP rows, on the H100), in bf16 as in f32. Returns
    (largest |d|, smallest bitwise share)."""
    from vae_training_tpu_torch.kernels.linear_vae import matrix_mask

    if norms:
        worst = _hold_mlp(torch, np, label, losses, plain_losses, rows, plain_rows)
    else:
        a, b = losses.cpu().numpy(), plain_losses.cpu().numpy()
        require(bool(np.all(np.isfinite(a))), f"{label}: finite losses")
        np.testing.assert_allclose(a, b, *tol["losses"], err_msg=f"{label} losses")
        worst = float(np.abs(a - b).max())
    share = 1.0
    for i, (got, want, lay) in enumerate(zip(rows, plain_rows, layouts)):
        mask = matrix_mask(lay)
        got, want = [t.cpu() for t in got], [t.cpu() for t in want]
        if not norms:
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), *tol["params"],
                                       err_msg=f"{label} row {i} params")
            worst = max(worst, float((got[0] - want[0]).abs().max()))
        for name, x, y in (("m", got[1], want[1]), ("v", got[2], want[2])):
            if not norms:
                np.testing.assert_allclose(x[~mask].numpy(), y[~mask].numpy(), *tol[name],
                                           err_msg=f"{label} row {i} f32-slot {name}")
            worst = max(worst, float((x - y).abs().max()))
            require(torch.equal(x[mask], x[mask].bfloat16().float())
                    and torch.equal(y[mask], y[mask].bfloat16().float()),
                    f"{label} row {i}: {name} of the weight matrices are bfloat16 values")
            same = _ulp_keys(torch, x) == _ulp_keys(torch, y)
            if mode == "tail":
                share = min(share, float(same[mask].float().mean()))
                out = (x - y).abs() > (0.02 * y.abs()).clamp_min(1e-3)
                tail = float(out[mask].float().mean())
                require(tail <= 1e-3, f"{label} row {i} {name}: {tail:.2e} of the matrix moments "
                                      f"outside max(1e-3, 0.02|x|) (at most 1e-3)")
                continue
            off = 0
            for leaf, shape in lay:
                n = int(np.prod(shape))
                if len(shape) >= 2:
                    xs, ys = x[off:off + n], y[off:off + n]
                    diff = (xs - ys).abs()
                    if mode == "strict":
                        ulp = (_ulp_keys(torch, xs) - _ulp_keys(torch, ys)).abs()
                        far = ulp[diff > tol[name][1]]
                        w = int(far.max()) if far.numel() else 0
                        require(w <= 1, f"{label} row {i} {name} {leaf}: {w} bf16 ulp apart above "
                                        f"the {tol[name][1]} floor (at most 1)")
                    else:
                        w = float((diff / (0.02 * ys.abs()).clamp_min(1e-3)).max())
                        require(w <= 1.0, f"{label} row {i} {name} {leaf}: drift {w:.2f}x the "
                                          f"bound max(1e-3, 0.02|x|)")
                    share = min(share, float(same[off:off + n].float().mean()))
                off += n
    require(share >= 0.95, f"{label}: only {share:.1%} of the bf16 moments bitwise equal")
    return worst, share


def _manifold_noise(torch, np, rs, row, n, batch, device):
    """External (x, z1, z2) for ``n`` steps of one row: x on the row's
    manifold (the sphere's, or [z, σ(z·a), 0] with ``row.a``), the rest
    standard normals."""
    z = rs.randn(n, batch, row.manifold_dim).astype(np.float32)
    x = np.zeros((n, batch, row.data_dim), np.float32)
    if row.a is None:
        x[:, :, :row.manifold_dim] = z / np.linalg.norm(z, axis=-1, keepdims=True)
    else:
        x[:, :, :row.manifold_dim] = z
        x[:, :, row.manifold_dim] = 1 / (1 + np.exp(-(z @ row.a.cpu().numpy()[:, 0])))
    return tuple(torch.as_tensor(t.astype(np.float32), device=device) for t in (
        x, rs.randn(n, batch, row.latent_dim), rs.randn(n, batch, row.data_dim)))


def _hold_mlp(torch, np, label, losses, plain_losses, rows, plain_rows):
    """Hold one step of the MLP kernel to its plain version: the losses
    elementwise at MLP_TOL, and each row's p, m and v by the 2-norm of
    their difference relative to the plain version's, at MLP_TOL's rtol.
    Returns the largest |Δ|.

    Why norms: at 200|200|200 a row has ~10⁵ ReLU pre-activations a step,
    and some lie within float32 rounding of zero; two correct float32 sums
    then mask one sample's gradient differently, which moves ~0.5% of a
    row's m by ~1e-3 relative: past MLP_TOL elementwise at about one step
    in twenty over the sphere sweep's 15 rows. Adam also turns gradients at
    the rounding floor (|g| ~ 1e-8) into steps of up to lr either way. A
    relative 2-norm of 1e-3 absorbs both and still fails on a wrong layer,
    bias or stack. Why one step at a time: those partings compound."""
    a, b = losses.cpu().numpy(), plain_losses.cpu().numpy()
    require(bool(np.all(np.isfinite(a))), f"{label}: finite losses")
    np.testing.assert_allclose(a, b, *MLP_TOL["losses"], err_msg=f"{label} losses")
    worst = float(np.abs(a - b).max())
    for i, (got, want) in enumerate(zip(rows, plain_rows)):
        for name, x, y in zip(("params", "m", "v"), got, want):
            x, y = x.double(), y.double()
            require(bool(torch.isfinite(x).all()), f"{label} row {i} {name} finite")
            rel = float((x - y).norm() / y.norm().clamp_min(1e-300))
            require(rel <= MLP_TOL[name][0], f"{label} row {i} {name}: relative 2-norm of "
                                             f"the difference {rel:.2e} > {MLP_TOL[name][0]}")
            worst = max(worst, float((x - y).abs().max()))
    return worst


def linear_flops(batch, data_dim, latent_dim, intrinsic_dim, manifold_dim, dual):
    """Operations of one K1/K2 step at these shapes: 2 per multiply-add of
    each product (the manifold draw; x·We, s·Wd, g_Wd, g_s, g_We; with the
    dual decoder also s·Ws, g_Ws and g_u·Wsᵀ) and 12 per parameter for the
    Adam update."""
    bdl = 2 * batch * data_dim * latent_dim
    draw = 2 * batch * manifold_dim * (1 if dual else intrinsic_dim)
    n_p = 2 * data_dim * latent_dim + 2 * latent_dim + data_dim + 1
    n_p += latent_dim * data_dim + data_dim if dual else 0
    return draw + (8 if dual else 5) * bdl + 12 * n_p


def mlp_flops(batch, enc, dec, dual=False):
    """Operations of one K5 step: 2 per multiply-add of each product (every
    layer's forward and g_W, every layer's g_in but the encoder's first; the
    SigDecoder's layers too with the dual decoder) and 12 per parameter for
    the Adam update."""
    stacks = (enc, dec, dec) if dual else (enc, dec)
    layers = [(a, b) for w in stacks for a, b in zip(w[:-1], w[1:])]
    macs = sum(a * b for a, b in layers)
    n_p = macs + sum(b for _, b in layers) + enc[-1] + 1
    return 2 * batch * (3 * macs - enc[0] * enc[1]) + 12 * n_p


def mlp_pass_ms(batch, enc, dec, dual=False, passes=3):
    """The time in ms of one step of one row if every layer product ran as
    ``passes`` TF32 products a term on the tensor cores (495 TFLOP/s; 3 is
    3xTF32) and Adam's 12 operations a parameter in fp32: the bound of a
    tensor-core design, printed beside ``_bound``'s all-fp32 bound of the
    kernel's own FMA chains."""
    stacks = (enc, dec, dec) if dual else (enc, dec)
    layers = [(a, b) for w in stacks for a, b in zip(w[:-1], w[1:])]
    macs = sum(a * b for a, b in layers)
    n_p = macs + sum(b for _, b in layers) + enc[-1] + 1
    products = 2 * batch * (3 * macs - enc[0] * enc[1])
    return 1e3 * (12 * n_p / FP32_PEAK + passes * products / TF32_PEAK)


def _bound(flops_per_step, state_bytes_per_chunk, steps_per_chunk, losses_per_step=1,
           peak=FP32_PEAK, fp32_flops_per_step=0):
    """The least time one step could take on the card: the larger of the
    operations over the peak (fp32 unless the operands are TF32 or bf16;
    ``fp32_flops_per_step`` more over the fp32 peak, beside products at
    another) and the bytes over the memory rate: the state read and written
    once per chunk of ``steps_per_chunk`` steps, and each step's losses (one
    a row) written."""
    t_ops = flops_per_step / peak + fp32_flops_per_step / FP32_PEAK
    t_bytes = (state_bytes_per_chunk / steps_per_chunk + 4 * losses_per_step) / HBM_RATE
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _phase_split(torch, probes, dev, label, inputs_of, ckw):
    """The phase form's dot split by launch variants (the grid barriers
    alone, every phase's work without them, whole), in turns, at 1 and 4
    chains in both dot modes; ns a dot of one chain in device time (CUDA
    events around 5 queued launches), the least of two. Returns {mode:
    {chains: {variant: ns}}}."""
    from vae_training_tpu_torch.tools._common import DOT_MODES, split_in_turns

    inputs = {n: inputs_of(n) for n in (1, 4)}
    got = split_in_turns({f"{mode} {n}": lambda u, b=bf16, n=n: probes._phase_launch(
        *inputs[n], ckw["n_steps"], ckw["depth"], ckw["weights_per_depth"], ckw["epilogue"],
        upto=u, bf16_dots=b) for mode, bf16 in DOT_MODES.items() for n in inputs},
        probes.PHASE_UPTO, 1e3 / (ckw["n_steps"] * ckw["depth"]))
    out = {mode: {} for mode in DOT_MODES}
    for mode in DOT_MODES:
        for n_chains in inputs:
            sp = out[mode][n_chains] = got[f"{mode} {n_chains}"]
            print(f"{label} phase split, {mode} dots, {n_chains} chain(s), ns a dot (device time, "
                  f"min of two): the grid barriers alone {sp['barriers']:.1f}, the work alone "
                  f"{sp['work']:.1f}, whole {sp['all']:.1f}")
    return out


def _print_ptxas(record, only=None):
    """The build log's per-kernel lines (registers, shared memory, spills);
    with ``only``, just those of the kernels whose names contain it."""
    keep = only is None
    for line in record["log"].splitlines():
        if "Compiling entry" in line:
            keep = only is None or only in line
        if keep and ("registers" in line or "spill" in line or "Compiling entry" in line):
            print("  ptxas:", line.strip())


def _parity(torch, np, label, tol, make_state, kernel_fn, plain_fn, chunk, n, ext,
            tdvs=(True, False)):
    """The kernel against its plain version from the same state, with
    external noise (when given) and the in-kernel sampler; returns the
    largest |Δ| seen."""
    max_err = 0.0
    for tdv in tdvs:
        for mode, noise in (("external", ext), ("sampler", None)):
            if mode == "external" and ext is None:
                continue
            kb = make_state(tdv)
            pb = tuple(t.clone() for t in kb)
            kl = chunk(kernel_fn, kb, n, 0, tdv, noise)
            pl = chunk(plain_fn, pb, n, 0, tdv, noise)
            torch.cuda.synchronize()
            errs = []
            for name, a, b in (("losses", kl, pl), ("params", kb[0], pb[0]),
                               ("m", kb[1], pb[1]), ("v", kb[2], pb[2])):
                a, b = a.cpu().numpy(), b.cpu().numpy()
                require(bool(np.all(np.isfinite(a))), f"{label} {name} finite")
                np.testing.assert_allclose(a, b, *tol[name],
                                           err_msg=f"{label} {name} tdv={tdv} {mode}")
                errs.append(float(np.abs(a - b).max()))
            max_err = max(max_err, *errs)
            print(f"{label} tdv={tdv!s:5} {mode:8}: max |Δ| losses {errs[0]:.2e} params "
                  f"{errs[1]:.2e} m {errs[2]:.2e} v {errs[3]:.2e}")
    return max_err


def _split(torch, label, make_state, kernel_fn, chunk):
    a = make_state(True)
    b = tuple(t.clone() for t in a)
    la = chunk(kernel_fn, a, 40, 0, True)
    lb = torch.cat([chunk(kernel_fn, b, 15, 0, True), chunk(kernel_fn, b, 25, 15, True)])
    torch.cuda.synchronize()
    require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
            f"{label}: a 40-step launch equals a 15 + 25 split bitwise")
    print(f"{label} chunk split 40 = 15 + 25: bitwise equal")


def _require_same_run(np, dir_a, dir_b):
    za = np.load(os.path.join(dir_a, "losses.npz"))
    zb = np.load(os.path.join(dir_b, "losses.npz"))
    require(set(za.files) == set(zb.files), "same npz channels")
    for k in za.files:
        require(np.array_equal(za[k], zb[k]), f"losses.npz {k!r} bitwise equal")
    with open(os.path.join(dir_a, "model.pkl"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(dir_b, "model.pkl"), "rb") as f:
        pb = pickle.load(f)
    for name in pa["target"]:
        for x, y in zip(_leaves(pa["target"][name]), _leaves(pb["target"][name])):
            require(np.array_equal(x, y), f"model.pkl {name} bitwise equal")


def _same_npz(np, dir_a, dir_b) -> bool:
    """Whether two runs' losses.npz are equal bitwise; where not, each
    differing channel's shapes and first differing index are printed."""
    za = np.load(os.path.join(dir_a, "losses.npz"))
    zb = np.load(os.path.join(dir_b, "losses.npz"))
    same = True
    for k in sorted(set(za.files) | set(zb.files)):
        a, b = za.get(k), zb.get(k)
        if a is None or b is None or a.shape != b.shape or not np.array_equal(a, b):
            same = False
            where = (np.flatnonzero((a != b).reshape(-1))[:3].tolist()
                     if a is not None and b is not None and a.shape == b.shape else "-")
            print(f"losses.npz {k!r}: shapes {getattr(a, 'shape', None)} / "
                  f"{getattr(b, 'shape', None)}, first differences at {where}")
    return same


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _device_us(torch, fn, calls=200, min_seconds=0.25):
    """µs a call of ``fn`` in device time: ``calls`` calls captured in one
    CUDA graph (after a warm-up on a side stream), the graph replayed in a
    window of at least ``min_seconds`` timed with CUDA events. The host's
    per-call cost is out; the graph's gap between kernels is in."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    replays = 0
    start.record()
    while True:
        graph.replay()
        replays += 1
        end.record()
        end.synchronize()
        if start.elapsed_time(end) >= 1e3 * min_seconds:
            return 1e3 * start.elapsed_time(end) / (replays * calls)


class _SmClock:
    """The SM clock in MHz as nvidia-smi reads it every 100 ms during a
    ``with`` block: str() gives min / median / max of the samples."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms",
             "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.mhz = sorted(int(x) for x in out.split() if x.strip().isdigit())
        return False

    def __str__(self):
        m = self.mhz
        if not m:
            return "not read"
        return f"{m[0]} / {m[len(m) // 2]} / {m[-1]} MHz (min / median / max of {len(m)})"


def _bench(argv):
    """``vae-bench-torch`` with ``argv`` in this process (its ``main``, the
    console script's entry): (returncode, stdout, stderr) as a completed
    process; the kernels are loaded once for every bench call."""
    from vae_training_tpu_torch._scripts import bench

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(argv)
    return subprocess.CompletedProcess(["vae-bench-torch", *argv], rc, out.getvalue(),
                                       err.getvalue())


def _steps_per_second(torch, fn, steps_per_call: int, min_seconds: float = 0.5) -> float:
    """Training steps per second over a window of at least ``min_seconds``
    of device time, timed with CUDA events after one warm-up call. Each call
    is waited for, so the queue never runs ahead of the window."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calls = 0
    start.record()
    while True:
        fn()
        calls += 1
        end.record()
        end.synchronize()
        if start.elapsed_time(end) >= 1e3 * min_seconds:
            return calls * steps_per_call / (start.elapsed_time(end) / 1e3)


if __name__ == "__main__":
    sys.exit(main())
