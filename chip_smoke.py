#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's serving and training paths, its
training, preprocessing and evaluation entry points, streaming separation,
Griffin-Lim, the speaker encoders, long-form (sequence-parallel) separation,
exported programs, the gate split's sharded training state and conv-block
recompute, at
`configs/voicesplit.json` and at the wide `configs/voicesplit_wide.json`
(NVIDIA H100).

    python3 chip_smoke.py [--seed 0] [--profile DIR] [--phases a,b,...]

Phases, each printing one JSON line:

1. device   — the card's name and power limit (``nvidia-smi``).
2. build    — compiles every `voicesplit_tpu_torch/csrc/*.cu` with nvcc for
   sm_90a into ``build/`` (one nvcc per source, all at once) and prints
   ``ptxas -v`` (registers, shared memory, spills) and each kernel's grid:
   the LSTM walks' (forward and backward at the paths' batches and at
   ROW_GROUP_BATCH rows a direction) with their cluster size, threads, row
   groups and rows a cluster, the clusters the card holds at once (at least
   one), registers and spilled bytes (none), both walks' routes, which
   must be the cluster walk at H=400 and, at GRID_HIDDEN, WIDE_ROUTES in
   bf16 (the split walk: the forward at B=1, 2 and two directions at B=8,
   every cluster of the launch resident at once) and the grid route in fp32
   and where the clusters are not all resident (two directions at B=24),
   each with its blocks, resident blocks or clusters, registers and spills,
   and the grid backward's ``w_shared``);
   the conv kernels' (the forward / data-gradient kernel body in its three
   modes, the weight-gradient kernel) per layer and batch (B=1, 2, 8; fp32
   at the reduced shape) beside the blocks the card holds at once, their
   registers and spilled bytes (more blocks than resident, or any spilled
   byte, fails the phase); and every instantiation of the wide-tile conv
   kernels, registers and spilled bytes read from the library (any spilled
   byte fails the phase).
3. kernels  — at H=400, T=301 holds each kernel against its plain PyTorch
   version on the card, in bf16 and fp32 operands, with two launches on the
   same inputs giving the same bits: ``lstm_fwd`` (B=1, random h0/c0; hs,
   cs, gates, final (h, c)), ``bilstm_fwd`` (B=8, and ROW_GROUP_BATCH rows
   a direction), both on the cluster walk, ``lstm_fwd`` (B=1) and
   ``bilstm_fwd`` (B=8) at GRID_HIDDEN on the split walk in bf16
   (``lstm_fwd_split``, ``bilstm_fwd_split``) and on the grid route in fp32
   (``lstm_fwd_grid``, ``bilstm_fwd_grid``), ``lstm_bwd`` (B=2, random dhs, dhf,
   dcf; dxp, dW_hh, dh0, dc0) and ``bilstm_bwd`` (B=8 and ROW_GROUP_BATCH;
   dxp, both dW_hh), and both at GRID_HIDDEN on the backward's split walk
   in bf16 (``lstm_bwd_split`` B=2, ``bilstm_bwd_split`` B=8) and grid route
   in fp32 (``lstm_bwd_grid``, ``bilstm_bwd_grid``), each launch counted
   by route, and each backward's dW_hh the bits of the dW_hh kernel alone
   on the call's dxp.  Then times kernel, plain version and a cuDNN
   ``torch.nn.LSTM`` yardstick (its forward, or its ``.backward()`` alone
   after a forward; both also cover the input projection, which the kernels
   leave to a matmul), and the backward's dW_hh kernel alone (``dwhh_ms``)
   beside its bound.
4. separate — builds the full-width `configs/voicesplit.json` model (bf16)
   with weights made from ``--seed``, zeroes the launch counters, runs
   `separate_batch` at B=1 and at B=8 on 3 s synthetic mixtures, reads the
   counters, and checks the output (48000 finite samples, mask in [0, 1],
   agreement with the same model run through the plain LSTM versions on
   the card, and an unnormalized STFT→iSTFT round trip of the mixture);
   every forward launch must have taken the cluster walk.
   Prints the steady-state latency per batch (median and p75 of 40 calls)
   and audio-seconds per second.
5. train    — the same model and config (si_snr loss, Adam; learning rate
   1e-3, see TRAIN_LR) in train mode, weights from ``--seed``, synthetic 3 s batches at B=2 (the config's
   batch; BiLSTM via ``lstm_fwd``/``lstm_bwd`` twice) and B=8 (one
   ``bilstm_fwd``/``bilstm_bwd``).  For each: zeroes the launch counters,
   runs one `make_train_step` step, reads the counters (exactly the
   kernels' launches per step), checks a finite loss, grad_norm > 0 and
   that every parameter and BatchNorm running statistic moved; then runs
   the same step from the same weights through the plain LSTM versions on
   the card and compares loss, grad_norm and the LSTM weights' gradients;
   then prints the step time (p50, p75 of 20 synchronized steps after 3
   warm ones), audio-seconds per second of training, the losses (which
   must fall on the fixed batch) and gradient norms of those steps and
   the peak device memory.
6. conv kernels — the three kernels of the fused conv chain
   (``conv_bn_act_fwd``, ``conv_dgrad``, ``conv_wgrad``) against their plain
   versions on the card: bf16 at the path's shape ``[2, 301, 601, 64]`` for
   every layer of conv2 … conv7 (the (7,1) layer and the (5,5) layers of
   dilation 1 to 16) and the wide config's extra block (dilation 32), with
   and without the prologue (mish, relu once); fp32
   at a reduced shape; the statistics and
   ``dbias`` in fp32; the first and last 32 time rows and 2 frequency
   columns on their own; two launches on the same inputs must give the same
   bits, and ``conv_wgrad`` with a prologue the bits of
   ``conv_dilated_wgrad`` on its prologue pass's output.  Then times each
   kernel per layer kind at B=2 and B=8 beside its plain version, its bound
   and a library yardstick that the port never calls (cuDNN ``conv2d`` plus
   the eager BatchNorm + activation pass and ``torch.var_mean``;
   ``aten.convolution_backward``) at
   all six layers (``conv_bn_act_fwd`` and ``conv_wgrad`` with their
   prologue pass inside their time, and the pass on its own), with each
   kernel's sum over them per train step.
6b. prologue — the BatchNorm-backward prologue branches of the chain's
   data- and weight-gradient kernels, which no path takes (`make_chain`
   draws d_raw with eager passes): the d_raw pass ``conv_draw_prologue``
   and the branches it makes, the pass then ``conv_dgrad`` and the pass
   then ``conv_wgrad`` (its input prologue on too, but on the (7,1) layer),
   against their plain versions (CONV_TOL, the same bits twice) in bf16 at
   ``[2 | 8, 301, 601, 64]`` on every layer of the conv kernels phase, at
   ``C`` = PROLOGUE_CHANNELS on PROLOGUE_WIDE_LAYERS, with relu once, and in
   fp32 at the reduced shape; against the chain's eager route (the d_raw of
   `_materialize_draw` from `_stage1`'s dz and x̂, then the prologue-free
   kernels; PROLOGUE_VS_EAGER_TOL); then times per layer the pass, each
   branch, each kernel alone, the plain versions, the eager draw and
   `_stage1`, and the library routes the port never calls (the eager draw
   and cuDNN's data or weight gradient) beside ``draw_bound`` and
   ``branch_bound``, and prints the phase's launches.
7. train fused — the train phase again with ``VOICESPLIT_FUSED_CHAIN=1``
   (conv2 … conv7 through the chain's kernels): exact launches per step
   (6 + 6 + 6 conv kernels and 10 prologue passes beside the LSTM's), the same step again
   (reports whether it gave the same bits), through the plain versions on
   the card and with the chain off, 20 timed steps.

8. dilated conv kernels — the two kernels of the opt-in conv path
   (``conv_dilated_fwd``, as forward and, with flipped weights, as data
   gradient; ``conv_dilated_wgrad``) against their plain versions on the
   card: bf16 at ``[2, 301, 601, 64]`` for all six layers of conv2 … conv7
   and the wide config's extra block (dilation 32), fp32 at a reduced shape; the forward also against the same sum rounded
   once; edge rows and columns on their own; the same bits twice.  Then
   times per layer at B=2 and B=8 beside the bound, the plain version, a
   library yardstick the port never calls (cuDNN ``conv2d``;
   ``aten.convolution_backward``) and the fused chain's ``conv_dgrad`` for
   the same layer, with the sums per serving call and train step.  The
   eval-mode block ``conv_bn_act_eval`` (conv, bias, BatchNorm with running
   statistics and mish or relu in one launch) likewise against
   ``conv_bn_act_eval_round_once_ref``: bf16 at ``[B, 301, 601, 64]``, B=1
   and B=8 (the serving batches), every layer kind, both activations, fp32
   at the reduced shape; then timed per layer and activation at B=1 and B=8
   beside its bound, its plain version, the port's eager block it replaces
   (``conv_dilated_fwd``, the bias add, ``bn_act_eval``), the plain kernel
   alone and the library yardstick (cuDNN ``conv2d`` with the bias, then
   ``bn_act_eval``), with the sums per serving call.
9. separate dilated — the separate phase's model with
   ``VOICESPLIT_PALLAS_CONV=1`` at B=1 and B=8: exactly 6
   ``conv_bn_act_eval`` launches per call (the eval-mode blocks conv2 …
   conv7, each one launch) beside the LSTM's, mask and waveform against the
   switch-off run, latency of both.
10. trainer — writes a synthetic dataset (3 s clips) into a temporary
   directory and, with the switch on, holds one step of the trainer's own
   model and first batch against the plain versions and the switch-off step
   (exact launches per step: 12 + 6 conv launches beside the LSTM's); runs
   `voicesplit_tpu_torch.cli.train.main` at full width for 16 steps across
   two checkpoint intervals with three validations (SDR and SI-SNRi on the
   card) and checks the launches of the whole run, finite losses, a falling
   validation loss, the checkpoint files and that the last one serves; then
   a second run resumed from the middle checkpoint, whose final weights must
   equal the uninterrupted run's.  Prints step time (p50, p75 between
   summaries), audio-seconds per second and the share of `fit()`'s wall time
   outside train steps.
11. separate wide — `configs/voicesplit_wide.json` (H=800, one extra (5,5)
   block at time dilation 32) served at B=1: `separate_batch` with both
   LSTM directions on the forward's split walk (against the plain LSTM
   versions), again with ``VOICESPLIT_PALLAS_CONV=1`` (7 ``conv_bn_act_eval``
   launches; against the switch-off call), and through the serving CLI;
   latency p50, p75.
12. train wide — the wide config at B=2 on each conv route (library convs,
   the dilated switch, the fused chain): one counted step (exact launches,
   forward and backward on WIDE_ROUTES), held against the plain
   versions (the LSTM's; the conv kernels' in bf16 against plain versions
   that round once as the kernels do, and in fp32 compute), 8 timed steps
   whose loss must fall, peak memory; then `cli.train.main` on each route
   for 4 steps with checkpoints at 2 and 4 and three validations.
13. evaluate — `cli.test.main` on the last checkpoint of the train wide
   phase's library-conv run (SDR on the card, and on the host, which must
   agree within EVAL_SDR_TOL_DB), then `cli.sweep.main` over both
   checkpoints (batches padded to 8 on the card: ``bilstm_fwd`` on the
   split walk): finite metrics, the best-checkpoint copies and the curve.
14. preprocess — writes a speaker-per-directory corpus (CORPUS_SPEAKERS ×
   CORPUS_UTTERANCES synthetic voices of CORPUS_SECONDS from ``--seed``) and
   two triplet CSVs, runs `cli.preprocess.main` with ``--save_specs`` on the
   card (a spawned pool of PREPROCESS_WORKERS) and checks the triplets
   written and the spectrograms against the host's (SPEC_TOL); writes each
   triplet's spectral d-vector as its ``*-emb.npy``; holds the native
   loader's first three batches to the Python iterator's; runs
   `cli.train.main` for PREPROCESS_STEPS steps over the triplets with
   ``VOICESPLIT_PALLAS_CONV=1`` through the native loader: exact launches,
   a finite loss, every compiled library under ``build/``.  Prints
   preprocessing seconds a triplet, step p50 / p75, `fit()`'s wall seconds
   by activity and its data-wait share.
15. trainer online — `configs/voicesplit.json` with dropout and SpecAugment
   (ONLINE_DROPOUT, ONLINE_SPEC_AUG): one regularized step of an online
   batch (exact launches, every parameter moved, against the same step
   through the plain LSTM versions with the same generators, TRAIN_TOL;
   dropout's keep share within KEEP_SHARE_TOL, SpecAugment's bands within
   their limits); `cli.train.main --online --emb_mode spectral` for
   ONLINE_STEPS steps (checkpoints every ONLINE_CKPT_EVERY), a run resumed
   from the middle checkpoint (TRAINER_RESUME_TOL), and a
   ``Trainer(debug_nans=True)`` whose loader poisons batch NAN_BATCH, which
   must stop one step later with a report naming an op.  Prints step p50 /
   p75 beside the trainer phase's, the data-wait share and, under
   ``--profile``, the regularizers' device time.
16. dsp — Griffin-Lim and the other audio backends: `cli.separate.main
   --griffin_lim` on a 3 s clip (the config's 60 rounds), Griffin-Lim on the
   card against the same call on the CPU from the same angles
   (GRIFFIN_LIM_CARD_TOL), its spectral convergence after the first and the
   last round (no worse), and the wavernn and waveglow processors' (linear
   and mel) ``wav2spec_batch`` → ``spec2wav_batch`` against the CPU
   (BACKEND_ROUNDTRIP_TOL of the waveform's peak).  Prints Griffin-Lim's
   seconds a call.
17. streaming — `streaming.StreamingSeparator` at full width in bf16, chunks
   of STREAM_CHUNK frames (STREAM_CASES): the causal model at B=1 and B=8,
   the symmetric one with ``VOICESPLIT_PALLAS_CONV=1`` and without, each a
   counted 3 s stream with exact launches a chunk (``lstm_fwd`` 1 on the
   cluster walk, and 6 ``conv_bn_act_eval`` with the switch; no conv kernel
   for a causal model), the algorithmic latency (STREAM_LATENCY), the same
   stream through the plain versions (WIDE_SEPARATE_TOL), the per-chunk
   p50 / p75 of STREAM_TIMED_CHUNKS chunks, the real-time factor and
   audio-seconds a second; the causal B=1 stream's output before a
   perturbation of its input unchanged; chunk 50 against 25 in fp32
   (STREAM_INVARIANCE_TOL) and, measured, in bf16.
18. train streaming — the causal config's streaming model at B=2 with
   ``VOICESPLIT_PALLAS_CONV=1``: one counted step (``lstm_fwd`` 1,
   ``lstm_bwd`` 1, no conv kernel), every parameter moved, against the
   plain LSTM versions (TRAIN_TOL), timed steps, peak memory; `cli.train.main`
   for STREAM_TRAIN_STEPS steps with checkpoints; a random BiLSTM checkpoint
   through `cli.convert_streaming.main`, served by `cli.separate.main
   --streaming`: the same bits as `StreamingSeparator.separate`.
19. encoder — the speaker encoders at full width in fp32: (a) ``lstm_fwd``
   at the GE2E training step's 96 rows and the extraction CLI's 32 windows
   (T=80, H=768, the grid route) and at CorentinJ's 32 partials (T=160,
   H=256, the cluster walk), ``lstm_bwd`` at 96 rows (the grid route),
   each against its plain version (TOL, the same bits twice), timed beside
   its bound at this T and cuDNN's fp32 ``torch.nn.LSTM``, the backward's
   dW_hh kernel alone beside one fp32 ``torch.matmul`` of its product; (b) GE2E
   training through `train_ge2e` (N=16 x M=6, Adam, clip 3.0) on a
   synthetic corpus of ENCODER_SPEAKERS x ENCODER_UTTERANCES voices:
   exactly 3 ``lstm_fwd`` and 3 ``lstm_bwd`` a step on the grid routes,
   the first steps' losses against the plain versions (ENCODER_LOSS_TOL),
   step p50 / p75 of ENCODER_STEPS after ENCODER_WARM, peak memory; then
   `cli.train_encoder.main` resumed from that run's ``.pt`` for 4 steps
   with the held-out EER and a checkpoint; (c) `cli.extract_embeddings.main`
   with ``ge2e`` (random, then the trained ``.pt``), ``corentinj``,
   ``speech2phone`` and ``spectral`` on ENCODER_REFS references and one
   shorter than a window (the ``[0]`` sentinel): 3 ``lstm_fwd`` a window
   batch of 32, finite d-vectors (unit norm where renormalized), seconds a
   file, the trained encoder's windows against the plain versions
   (ENCODER_EMB_TOL), and one batch of the ``-emb.npy`` files through
   `data/dataset.py`.
20. voicefilter — `configs/voicefilter.json` (relu, power-law loss, bf16) in
   train mode at B=2 on the unfused path and on the fused chain: exact
   launches (2 + 2 LSTM; on the chain 6 + 6 + 6 and 10 prologue passes),
   each step against the same step through the plain versions (TRAIN_TOL,
   FUSED_TOL), every chain layer's relu prologue against its plain version
   (RELU_PROLOGUE_LAYERS), step p50 / p75 and peak memory beside the si_snr
   steps' of the train phases.
21. reference — `cli.separate.main --reference_wav --encoder_checkpoint`
   with a random GE2E ``embedder.pt`` in the reference's layout, on a 3 s
   and a 14 s reference: 3 ``lstm_fwd`` a window batch of 32 plus the mask
   network's 2, the d-vector against the plain versions' (DVECTOR_TOL), the
   CLI's file equal to `separate_batch`'s with that d-vector.
22. import — a random full-width model exported to the reference's
   ``checkpoint_<step>.pt`` layout, imported by `cli.import_torch.main` and
   served on the card bit for bit as the original; `cli.convert` (card),
   `cli.generate_csv` and `cli.resample` (host) on a synthetic corpus,
   seconds a file.
23. distributed — `parallel.initialize_distributed` starts an NCCL world of
   one; a B=2 step of each route under it (exact launches; NCCL kernels and
   all-reduce calls a step from a profile; DIST_ROUNDS rounds of DIST_TIMED
   steps without the group, then as many with it); then `cli.train.main
   --coordinator --num_processes 1 --process_id 0` for DIST_STEPS steps on
   each route against the same run with no group (and a second run with
   none): the weights after every step bit for bit (cuDNN deterministic
   for the phase).
24. long — `parallel.sequence.separate_long` on a 120 s mixture (12,001
   frames, B=1) at full width on the library convs and with
   ``VOICESPLIT_PALLAS_CONV=1``: a world of one bit for bit
   `separate_batch`'s, 2 ``lstm_fwd`` (and 6 ``conv_bn_act_eval``) a call;
   2 and 4 shards in one process (`InProcessExchange`: halos, the carry
   relay from a nonzero carry, 1 and 3 padded frames) against the world of
   one's mask: the same bits, or only the two library calls that pick
   their kernel by shape differing (LIBRARY_SHAPE_OPS, LONG_SHARDED_TOL),
   with `long_sharded_launches` (8 and 32 ``lstm_fwd``, 12 and 24
   ``conv_bn_act_eval`` with the switch); the relay alone bit for bit;
   p50 and peak memory of each pass;
   ``lstm_fwd`` from a carry and ``conv_dilated_fwd`` on a masked window
   against their plain versions; the longest utterance a world of one
   takes (55,831 frames, 558.3 s) run on each route, one frame more
   refused; `cli.separate.main --sequence_parallel` on the clip written as
   a wav, the default path's file byte for byte.
25. export — the full-width separator exported by `cli.export.main` from a
   trainer checkpoint for the card (symbolic batch; symbolic with the
   dilated switch; batch pinned to 8) and the streaming chunk step, loaded
   cold in a fresh
   interpreter that imports only the kernels' operators: launches counted
   there (EXPORT_LAUNCHES), outputs against the eager path (bits; B=8 of
   the symbolic program within EXPORT_B8_TOL), sizes, seconds, the B=1
   and chunk p50 of program and eager.
26. model parallel — `configs/voicesplit_wide.json` at full width (bf16,
   B=2, library convs) with its training state split over MP_SHARDS
   in-process model shards (`parallel.sharding.InProcessShardExchange`:
   each shard owns its slices of the split parameters and their Adam
   moments, gathered into the module before each step): MP_STEPS steps
   against the unsharded state's from the same weights, bit for bit (loss,
   every parameter, the moments, the running statistics); 2 ``lstm_fwd`` +
   2 ``lstm_bwd`` a step on the split walks; each shard's bytes against
   the whole; step p50 / p75 and peak memory of each.
27. remat — `configs/voicesplit.json` at full width (bf16) trained at B=2
   and B=8 on each conv route with ``VOICESPLIT_REMAT_CONV=1`` and without,
   from the same weights: REMAT_STEPS steps bit for bit (cuDNN
   deterministic for both phases), the switch's exact launches
   (REMAT_CONV_LAUNCHES: 18 ``conv_dilated_fwd`` a step with the dilated
   switch), step p50 / p75 and peak memory on each side.
28. channels — the conv kernels at the other channel counts the JAX package
   takes: at ``[2, 301, 601, C]`` bf16 on the (7,1) layer and on (5,5) at
   time dilation 1 and 16, ``conv_dilated_fwd`` (forward and data
   gradient) and ``conv_dilated_wgrad`` at C = 96, 128, 192 and 64 -> 128,
   ``conv_bn_act_fwd``, ``conv_dgrad`` and ``conv_wgrad`` at C = 128 and
   192, each against its plain version (DILATED_TOL, CONV_TOL, the same
   bits twice) and timed beside its plain version, bound and cuDNN, with
   its grid (blocks within the resident ones; registers and spilled bytes
   reported); a 100-channel layer, zero-padded to 104 around the launch,
   with the padding's cost; then `configs/voicesplit.json` at full width
   with ``conv_channels`` = 128: served at B=1 and B=8 with
   ``VOICESPLIT_PALLAS_CONV=1`` and trained at B=2 with it and with
   ``VOICESPLIT_FUSED_CHAIN=1``, each counted (exact launches), held
   against the same run through the plain versions on the card
   (SEPARATE_DILATED_TOL, DILATED_STEP_TOL, FUSED_TOL) and timed (p50, p75,
   peak memory).  Its figures stay on its own two lines; the ``kernels``
   line keeps the 64-channel figures.
29. checkpoint — the serving CLI on the JAX CLI's command line at the full
   width of `configs/voicesplit.json` (bf16) with random weights from
   ``--seed``: a JAX-layout ``checkpoint_0.msgpack`` (flax's msgpack layout:
   ext 1 arrays, an ext 3 step count, ``config_str``) of
   `weights.random_jax_variables`, served by `cli.separate.main
   --checkpoint_path` with no ``-c`` and a ``.pt`` d-vector; the same
   weights as a port ``checkpoint_0.pt``; a causal streaming file in the
   JAX layout served with ``--streaming``; and the BiLSTM file with
   ``--streaming``, which must raise before any launch.  Each call counted
   (exactly 2 ``lstm_fwd`` at B=1, 1 a streaming chunk, none refused) and
   timed; each output file byte for byte the one `separate_batch` (or
   `StreamingSeparator` driven directly) writes for `state_dict_from_jax`
   of the same trees.

Then a ``{"kernels": [...]}`` line (each kernel's ``main_path``: false for
the routes no path takes, OFF_PATH, launched only in the kernels phases),
the ``nvidia-smi``
name/power-limit line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero and no result line is printed.  It also exits
non-zero without a card, or without the rest of the repository beside it.
``--profile DIR`` additionally writes a ``torch.profiler`` kernel table and
trace of the serving runs and the train steps into DIR and reports the
device's idle share under the profiler and the device time by kind of
kernel.  ``--phases`` runs a subset (of kernels, bwd_kernels, separate,
train, conv_kernels, prologue, train_fused, dilated_kernels, separate_dilated,
trainer, separate_wide, train_wide, evaluate, preprocess, trainer_online, dsp,
streaming, train_streaming, encoder, voicefilter, reference, import,
distributed, long, export, model_parallel, remat, channels, checkpoint; device
and build always run)
and ends with a line marked
``"partial"`` instead of the result lines.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the H100 SXM's data-sheet peaks: HBM3 bytes a second; dense bf16 on the
# tensor cores and fp32 on the CUDA cores
from voicesplit_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS

ROOT = Path(__file__).resolve().parent
T_FRAMES, HIDDEN, IN_FEATURES = 301, 400, 8 * 601 + 256
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# rows a direction past what one cluster of the LSTM walks holds at H=400
# (bf16 backward 23, fp32 11): the forward and backward kernels phases also
# run both directions at this batch, over row groups of clusters
ROW_GROUP_BATCH = 24
# configs/voicesplit_wide.json's lstm_dim: a block's columns of W_hh do not
# fit the cluster walk, so bf16 takes the split walk (two clusters a
# direction and row group) and fp32 the grid route (lstm_fwd_grid_kernel,
# lstm_bwd_grid_kernel)
GRID_HIDDEN = 800
# the routes the wide config's bf16 paths take at GRID_HIDDEN
WIDE_ROUTES = {"forward": "split", "backward": "split"}
# where the clusters of a split walk are not all resident at once (two
# directions of 24 rows: 8 clusters of 16, of 7 an H100 holds): the grid route
NOT_RESIDENT_BATCH = 24
# bf16: a different summation order can flip one bf16 rounding of h (or, in
# the backward, of dgates), which then carries through the recurrence; fp32
# (TF32 off) differs by order only.  The backward's errors are taken
# relative to each output's largest magnitude (gradients grow over the
# reverse walk), the forward's are absolute (|h|, |c|, gates <~ 1).
SEPARATE_TOL = 5e-2  # mask and peak-relative waveform error, kernel vs plain LSTM (bf16)
# the same at the wide config (GRID_HIDDEN): its random-weight mask spans
# only about [0.45, 0.57], so 5e-2 would pass a badly wrong LSTM output; the
# grid route's flipped bf16 roundings moved it by 4.9e-4 (mask) and 2.7e-4
# (waveform) on an H100, and a tenth of the spread is 1.2e-2
WIDE_SEPARATE_TOL = 5e-3
ROUNDTRIP_MIN_SNR_DB = 60.0
LATENCY_CALLS = 40  # p75 is then the highest percentile with ten calls beyond it
TRAIN_WARM, TRAIN_STEPS = 3, 20
# learning rate of the train phase: the JAX package's own training test's
# (tests/test_train.py).  At the config's 1e-2 the sigmoid mask of the
# random-weight model saturates after Adam's first step (measured on the
# card: grad norm 27 at the first step, 4e-6 by the fifth), so the loss
# could not show that training moves it.
TRAIN_LR = 1e-3
# one train step through the kernels vs through the plain LSTM versions, bf16
# model: the forward's bf16 roundings that fall the other way (mask error
# ~5e-4 in serving) and the backward's move loss, grad_norm and gradients
TRAIN_TOL = {"loss_rel": 5e-3, "grad_norm_rel": 2e-2, "lstm_grad_peak_rel": 5e-2}
TRAIN_LAUNCHES = {  # kernel launches per train step, by batch
    2: {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0},
    8: {"lstm_fwd": 0, "bilstm_fwd": 1, "lstm_bwd": 0, "bilstm_bwd": 1},
}
# The fused chain's kernels.  bf16: raw (or dx) is rounded once from an fp32
# sum taken in another order than the plain version's, so an element may
# round the other way: one bf16 ulp, at most 2^-7 = 7.8e-3 of the output's
# peak.  The statistics and dbias sum rounded values over 3.6e5 positions
# in another order (fp32), and a flipped rounding moves them by one ulp of
# one term.  dW sums 0.36-1.45 M exact products in fp32 in another order.
# All relative to each output's peak.
CONV_TOL = {
    "bfloat16": {"out": 1e-2, "sums": 1e-3, "dw": 1e-3},
    "float32": {"out": 1e-4, "sums": 1e-4, "dw": 1e-4},
}
CONV_SHAPE = (2, T_FRAMES, 601, 64)  # the training path's activations at B=2
CONV_SHAPE_FP32 = (1, 40, 150, 64)  # reduced: the fp32 kernels are the tests' instantiation
# conv2 … conv7 of the model, each layer kind once; every conv kernel is
# checked and timed at each
CONV_LAYERS = {"7x1": ((7, 1), 1), "5x5-d1": ((5, 5), 1), "5x5-d2": ((5, 5), 2),
               "5x5-d4": ((5, 5), 4), "5x5-d8": ((5, 5), 8), "5x5-d16": ((5, 5), 16)}
# the wide config's extra dilated block (configs/voicesplit_wide.json),
# checked and timed at B=2 beside the six
WIDE_CONV_LAYERS = {"5x5-d32": ((5, 5), 32)}
ALL_CONV_LAYERS = {**CONV_LAYERS, **WIDE_CONV_LAYERS}
CONV_KERNELS = ("conv_bn_act_fwd", "conv_dgrad", "conv_wgrad")
# per train step; the prologue pass runs for conv3 … conv7 twice, before
# conv_bn_act_fwd and before conv_wgrad; the chain draws d_raw with eager
# passes and takes no d_raw pass
CONV_LAUNCHES = {"conv_bn_act_fwd": 6, "conv_dgrad": 6, "conv_wgrad": 6, "conv_wgrad_prologue": 10,
                 "conv_draw_prologue": 0}
# The chain's BatchNorm-backward prologue branches, the d_raw pass
# `conv_draw_prologue` then `conv_dgrad` or `conv_wgrad`: bf16 at every layer
# the conv kernels phase times (B=2 and B=8, the wide block at B=2), at
# PROLOGUE_CHANNELS on PROLOGUE_WIDE_LAYERS (B=2) and with relu once; fp32 at
# the reduced shape on PROLOGUE_FP32_LAYERS (relu).  Against their plain
# versions with CONV_TOL: the pass rounds an fp32 draw once ("out": an
# element may round the other way), the branches' dx and dbias as
# `conv_dgrad`'s, dW as `conv_wgrad`'s.
PROLOGUE_CHANNELS = 128
PROLOGUE_WIDE_LAYERS = ("7x1", "5x5-d1", "5x5-d16")
PROLOGUE_FP32_LAYERS = ("7x1", "5x5-d2")
# the branches against the chain's eager route, which draws d_raw in the
# compute dtype (bf16: every step of z, act', dz, x̂ and d_raw rounded, the
# table's rows too) where the branches draw in fp32 and round once.  d_raw is
# held by direction: a z near 0 whose bf16 rounding changes sign moves relu'
# from 0 to 1, a whole dy·inv.  dbias, whose per-channel sum of d_raw nearly
# cancels (inv·(Σdz − n·mean(dz) − mean(dz·x̂)·Σx̂)), relative to the sum of
# |d_raw| it cancels from; dW carries that difference through the input's
# mean (an activated input has one; the (7,1) layer's is not activated
# here).  Measured on an H100 at this phase's inputs (the same every run):
# d_raw peak 0.5002 (relu; mish 0.029), cosine 0.99977; dx peak 0.0894,
# cosine 0.99977; dbias 1.55e-3; dW peak 0.2597, cosine 0.9553.  The limits
# are 1.5x those distances.
PROLOGUE_VS_EAGER_TOL = {"d_raw": 0.75, "d_raw_cosine_min": 0.9996, "dx": 0.134,
                         "dx_cosine_min": 0.9996, "dbias_rel_to_abs_sum": 2.3e-3, "dw": 0.39,
                         "dw_cosine_min": 0.933}
# fp32 operations a d_raw element: z (2), act' (mish: min, exp, 5 additions
# or subtractions, 4 products, 2 divisions; relu: 1 comparison), dz (1),
# x̂ (2), d_raw (4)
DRAW_OPS = {"mish": 22, "relu": 10}
# fused step, kernels vs the plain versions on the card (same arithmetic).
# The BatchNorm backward between two convs works in bf16, as in the JAX
# package: its per-channel constants (mean, r, mean dz, mean dz·x̂) are
# rounded to bf16, so a sum that differs in its last fp32 bits can round one
# of them the other way and move a whole channel of d_raw together.  The
# gradients of conv2 … conv7 are therefore held by direction (cosine) and
# loosely by size, relative to each one's peak (the 64-element BatchNorm
# bias gradients move most; measured on an H100: cosine >= 0.992, size
# <= 0.15); loss, grad_norm and the running statistics are held tightly.
FUSED_TOL = {"loss_rel": 5e-3, "grad_norm_rel": 2e-2, "grad_peak_rel": 0.3,
             "grad_cosine_min": 0.98, "running_stat_abs": 1e-3}
# fused step vs the unfused (eager) step from the same weights: besides the
# above, the chain normalizes in fp32 and rounds once where the eager
# BatchNorm rounds the scale, the shift and each step of mish to bf16, and
# it takes the statistics inside the conv kernel (measured: cosine >= 0.988,
# size <= 0.17, running statistics 7e-4)
FUSED_VS_EAGER_TOL = {"loss_rel": 2e-2, "grad_norm_rel": 0.1, "grad_peak_rel": 0.3,
                      "grad_cosine_min": 0.97, "running_stat_abs": 2e-2}
# The dilated conv kernels (`ops/conv_cuda.py`).  bf16 forward / data gradient:
# the plain version keeps the TPU kernel's rounding (each of the kf frequency
# taps' partial sums rounded to bf16, then added in bf16: up to 2·kf − 1
# roundings of an output), the CUDA kernel sums every tap in fp32 and rounds
# once.  Against the plain version an output may therefore differ by a few
# bf16 ulps ("out": 2e-2 of the peak; one ulp is at most 2^-7 = 7.8e-3);
# against the same sum rounded once (`conv_dilated_fwd_round_once_ref`) by one flipped
# rounding ("out_round_once": 1e-2, the fused chain's tolerance).  dW sums
# exact products in fp32 in another order.  All relative to each output's peak.
DILATED_TOL = {
    "bfloat16": {"out": 2e-2, "out_round_once": 1e-2, "dw": 1e-3},
    "float32": {"out": 1e-4, "out_round_once": 1e-4, "dw": 1e-4},
}
# per serving call: conv2 … conv7 in eval mode, one launch a block
DILATED_SERVE_LAUNCHES = {"conv_dilated_fwd": 0, "conv_dilated_wgrad": 0, "conv_bn_act_eval": 6}
DILATED_TRAIN_LAUNCHES = {"conv_dilated_fwd": 12, "conv_dilated_wgrad": 6}  # per train step
# serving with the switch on (bf16), mask (absolute, values in [0, 1]) and
# waveform (relative to its peak): against the same call through the plain
# versions on the card (which round each frequency tap's partial sum, see
# above) and against the switch-off call (cuDNN sums in another order).  Six
# layers whose conv outputs may round the other way, each followed by
# BatchNorm with running statistics, which does not amplify them as a batch's
# statistics do in training.
SEPARATE_DILATED_TOL = 5e-3
# One full-width train step with the switch on (bf16): through the kernels vs
# through their plain versions (which round the forward as the TPU kernel
# does) and vs the switch-off step (cuDNN convs).  BatchNorm + activation are
# the eager op in all three, whose backward works in bf16 with per-channel
# constants rounded to bf16 (see FUSED_TOL): a conv output that rounds the
# other way can move a whole channel, so gradients are held by direction and
# loosely by size, loss, grad_norm and running statistics more tightly.
DILATED_STEP_TOL = {"loss_rel": 2e-2, "grad_norm_rel": 0.1, "grad_peak_rel": 0.3,
                    "grad_cosine_min": 0.97, "running_stat_abs": 2e-2}
# The wide config (lstm_dim 800: the LSTM's WIDE_ROUTES; one extra (5,5)
# block at time dilation 32, so seven kernel layers on the conv routes), at
# its batch B=2: launches per train step by conv route
WIDE_CONFIG = "configs/voicesplit_wide.json"
WIDE_KERNEL_LAYERS = 7
WIDE_CONV_ROUTES = ("unfused", "pallas_conv", "fused_chain")
WIDE_TRAIN_LAUNCHES = {"lstm_fwd": 2, "bilstm_fwd": 0, "lstm_bwd": 2, "bilstm_bwd": 0}
WIDE_CONV_LAUNCHES = {
    "unfused": {},
    "pallas_conv": {"conv_dilated_fwd": 2 * WIDE_KERNEL_LAYERS, "conv_dilated_wgrad": WIDE_KERNEL_LAYERS},
    # the prologue pass runs for every chain layer but the first, twice
    "fused_chain": {"conv_bn_act_fwd": WIDE_KERNEL_LAYERS, "conv_dgrad": WIDE_KERNEL_LAYERS,
                    "conv_wgrad": WIDE_KERNEL_LAYERS, "conv_wgrad_prologue": 2 * (WIDE_KERNEL_LAYERS - 1)},
}
WIDE_TRAIN_STEPS = 8  # timed steps on a fixed batch, each route
# A wide step on a conv kernel route against its plain versions.  bf16:
# against plain versions that round once as the kernels do (the dilated
# route's own plain forward rounds each frequency tap as the TPU kernel
# does: seven such layers moved one BatchNorm bias gradient of the wide
# model by 0.30 of its peak, where the same step in fp32 agrees to 5e-6;
# the round-once plain versions leave 0.14, cosine >= 0.995),
# with the tolerances of the narrow phases (FUSED_TOL, DILATED_STEP_TOL).
# fp32 (the same model in fp32 compute): summation order only, as the fp32
# kernel checks (measured on an H100: 5e-6 of a gradient's peak)
WIDE_FP32_STEP_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "grad_peak_rel": 1e-4,
                      "grad_cosine_min": 0.9999, "running_stat_abs": 1e-5}
# the training CLI on each route: steps, checkpoint interval (two
# checkpoints, which the evaluate phase reads), synthetic 3 s clips
WIDE_CLI_STEPS, WIDE_CLI_CKPT_EVERY = 4, 2
WIDE_CLI_TRAIN_ITEMS, WIDE_CLI_EVAL_ITEMS = 8, 2
# cli/test.py's SDR on the card (batched float32 projection) against the
# host's float64 one: tests/test_torch_eval.py's tolerance
EVAL_SDR_TOL_DB = 0.05
# the trainer phase: steps, checkpoint interval, dataset sizes (3 s clips)
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_RESUME_AT = 16, 6, 6
TRAINER_TRAIN_ITEMS, TRAINER_EVAL_ITEMS = 40, 4
# a run resumed from the middle checkpoint against the uninterrupted one:
# every parameter within this (absolute; ten steps of Adam at lr 1e-3 move a
# weight by at most 1e-2).  The port's kernels give the same bits twice; the
# library's backward kernels for conv1 and conv8 need not.
TRAINER_RESUME_TOL = 1e-3
# the preprocess phase: a speaker-per-directory corpus (speakers × utterances
# of CORPUS_SECONDS, 16 kHz) and a CSV of triplets mixed by `cli.preprocess`
# (a spawned pool of PREPROCESS_WORKERS), then `cli.train` over the triplets
# with the dilated switch through the native loader
CORPUS_SPEAKERS, CORPUS_UTTERANCES, CORPUS_SECONDS = 6, 3, 4.0
PREPROCESS_TRAIN_ROWS, PREPROCESS_TEST_ROWS, PREPROCESS_WORKERS = 24, 4, 4
PREPROCESS_STEPS, PREPROCESS_CKPT_EVERY = 8, 4
# spectrograms written on the card against the same wavs' on the host
# (normalized dB, values in [0, 1])
SPEC_TOL = 1e-4
NATIVE_BATCH_TOL = 2e-7  # native loader vs Python iterator (wav samples)
# the trainer_online phase: `cli.train --online --emb_mode spectral` with the
# JAX package's regularizer probe values (scripts/run_reg_probes.py:72-73)
ONLINE_DROPOUT, ONLINE_SPEC_AUG = 0.3, (24, 40)
ONLINE_STEPS, ONLINE_CKPT_EVERY = 12, 6
KEEP_SHARE_TOL = 0.01  # dropout's keep share against 1 - rate
NAN_BATCH = 2  # the debug_nans run's loader poisons this batch (0-based)
# the dsp phase: Griffin-Lim on the card against the CPU from the same angles
# after the config's 60 rounds (peak-relative), and the wavernn / waveglow
# processors' analysis and synthesis (peak-relative, the issue's bound)
GRIFFIN_LIM_CARD_TOL = 1e-3
BACKEND_ROUNDTRIP_TOL = 1e-4
GRIFFIN_LIM_CALLS = 5
# the streaming phase: chunk, cases (causal, batch, VOICESPLIT_PALLAS_CONV),
# launches a chunk by switch, algorithmic latency by causal (samples)
STREAM_CHUNK = 50
STREAM_CASES = {"causal_B1": (True, 1, "0"), "symmetric_switch_B1": (False, 1, "1"),
                "symmetric_B1": (False, 1, "0"), "causal_B8": (True, 8, "0")}
STREAM_LAUNCHES = {"0": {"lstm_fwd": 1}, "1": {"lstm_fwd": 1, "conv_bn_act_eval": 6}}
STREAM_LATENCY = {True: 1040, False: 11440}
STREAM_WARM_CHUNKS, STREAM_TIMED_CHUNKS = 4, 48
# chunk 50 against chunk 25 in fp32 compute: tests/test_streaming.py:54's bound
STREAM_INVARIANCE_TOL = 2e-4
# the causal stream's output before a perturbation of its input at this
# sample (mid-chunk) against the unperturbed stream, relative to its peak
STREAM_PERTURB_AT, STREAM_CAUSAL_TOL = 35000, 1e-6
# the train_streaming phase
STREAM_TRAIN_LAUNCHES = {"lstm_fwd": 1, "lstm_bwd": 1}
STREAM_TRAIN_TIMED = 12
STREAM_TRAIN_STEPS, STREAM_TRAIN_CKPT_EVERY = 8, 4
STREAM_TRAIN_ITEMS, STREAM_EVAL_ITEMS = 16, 2
REPLACES = {
    "lstm_fwd": "voicesplit_tpu/ops/lstm_pallas.py:71",
    "lstm_fwd_grid": "voicesplit_tpu/ops/lstm_pallas.py:71",
    "lstm_fwd_split": "voicesplit_tpu/ops/lstm_pallas.py:71",
    "bilstm_fwd": "voicesplit_tpu/ops/lstm_pallas.py:251",
    "bilstm_fwd_grid": "voicesplit_tpu/ops/lstm_pallas.py:251",
    "bilstm_fwd_split": "voicesplit_tpu/ops/lstm_pallas.py:251",
    "lstm_bwd": "voicesplit_tpu/ops/lstm_pallas.py:135",
    "lstm_bwd_grid": "voicesplit_tpu/ops/lstm_pallas.py:135",
    "lstm_bwd_split": "voicesplit_tpu/ops/lstm_pallas.py:135",
    "bilstm_bwd": "voicesplit_tpu/ops/lstm_pallas.py:317",
    "bilstm_bwd_grid": "voicesplit_tpu/ops/lstm_pallas.py:317",
    "bilstm_bwd_split": "voicesplit_tpu/ops/lstm_pallas.py:317",
    "conv_bn_act_fwd": "voicesplit_tpu/ops/conv_fused.py:303",
    "conv_dgrad": "voicesplit_tpu/ops/conv_fused.py:411",
    "conv_wgrad": "voicesplit_tpu/ops/conv_fused.py:524",
    "conv_dilated_fwd": "voicesplit_tpu/ops/conv_pallas.py:95",
    "conv_dilated_wgrad": "voicesplit_tpu/ops/conv_pallas.py:234",
    # _fwd_kernel with conv_dispatch's bias (:406-420) and bn_act.py's
    # folded_bn_act_eval after it
    "conv_bn_act_eval": "voicesplit_tpu/ops/conv_pallas.py:95",
    # the BatchNorm-backward prologue of _dgrad_kernel (prologue=True) and
    # _wgrad_kernel (rhs_prologue=True)
    "conv_draw_prologue": "voicesplit_tpu/ops/conv_fused.py:221",
}
SOURCES = {
    "lstm_fwd": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
    "lstm_fwd_grid": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
    "lstm_fwd_split": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
    "bilstm_fwd": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
    "bilstm_fwd_grid": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
    "bilstm_fwd_split": "voicesplit_tpu_torch/csrc/lstm_fwd.cu",
    "lstm_bwd": "voicesplit_tpu_torch/csrc/lstm_bwd.cu",
    "lstm_bwd_grid": "voicesplit_tpu_torch/csrc/lstm_bwd.cu",
    "lstm_bwd_split": "voicesplit_tpu_torch/csrc/lstm_bwd.cu",
    "bilstm_bwd": "voicesplit_tpu_torch/csrc/lstm_bwd.cu",
    "bilstm_bwd_grid": "voicesplit_tpu_torch/csrc/lstm_bwd.cu",
    "bilstm_bwd_split": "voicesplit_tpu_torch/csrc/lstm_bwd.cu",
    "conv_bn_act_fwd": "voicesplit_tpu_torch/csrc/conv_fwd.cu",
    "conv_dgrad": "voicesplit_tpu_torch/csrc/conv_fwd.cu",
    "conv_wgrad": "voicesplit_tpu_torch/csrc/conv_wgrad.cu",
    "conv_dilated_fwd": "voicesplit_tpu_torch/csrc/conv_fwd.cu",
    "conv_dilated_wgrad": "voicesplit_tpu_torch/csrc/conv_wgrad.cu",
    "conv_bn_act_eval": "voicesplit_tpu_torch/csrc/conv_fwd.cu",
    "conv_draw_prologue": "voicesplit_tpu_torch/csrc/conv_wgrad.cu",
}
# kernels that the paths do not launch (the `kernels` line lists them with
# "main_path": false): the two-direction grid routes, which only fp32 takes
# at H=800, and the two-direction backward at H=800 (B=8; the wide config
# trains at B=2), checked and timed in the kernels phases.  The
# one-direction grid routes are the GE2E encoder's (fp32, H=768).  The d_raw
# pass of the chain's prologue branches: `make_chain` takes neither branch,
# so it runs only from the ops entries (the prologue phase).
OFF_PATH = ("bilstm_fwd_grid", "bilstm_bwd_grid", "bilstm_bwd_split", "conv_draw_prologue")


REPORTS: dict = {}  # each phase's printed fields, by phase name


def emit(phase: str, **fields) -> None:
    REPORTS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def lstm_bound(directions: int, batch: int, dtype: str, H: int = HIDDEN,
               T: int = T_FRAMES) -> dict:
    """Least time for the recurrence: each input byte read once, each output
    byte written once, and the recurrent products at the operand type's
    peak."""
    R = directions * batch
    op_bytes = 2 if dtype == "bfloat16" else 4
    bytes_ = (
        T * R * 4 * H * op_bytes  # xp
        + directions * H * 4 * H * op_bytes  # W_hh
        + (2 * R * H * 4 if directions == 1 else 0)  # h0, c0
        + 2 * T * R * H * 4  # hs, cs
        + T * R * 4 * H * 4  # gates
    )
    flops = 2 * T * R * H * 4 * H
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {
        "bytes": bytes_,
        "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def lstm_bwd_bound(directions: int, batch: int, dtype: str, H: int = HIDDEN,
                   T: int = T_FRAMES) -> dict:
    """The same for the backward: W_hh, gates, cs, hs, dhs (and h0, c0, dhf,
    dcf for one direction) read once, dxp, dW_hh (and dh0, dc0) written
    once, and both products (dh_prev and dW_hh) at the operand type's peak."""
    R = directions * batch
    op_bytes = 2 if dtype == "bfloat16" else 4
    bytes_ = (
        directions * H * 4 * H * op_bytes  # W_hh
        + T * R * 4 * H * 4  # gates
        + 3 * T * R * H * 4  # cs, hs, dhs
        + (6 * R * H * 4 if directions == 1 else 0)  # h0, c0, dhf, dcf, dh0, dc0
        + T * R * 4 * H * op_bytes  # dxp
        + directions * H * 4 * H * 4  # dW_hh
    )
    flops = 2 * 2 * T * R * H * 4 * H
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {
        "bytes": bytes_,
        "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def lstm_dwhh_bound(directions: int, batch: int, dtype: str, H: int = HIDDEN,
                    T: int = T_FRAMES) -> dict:
    """The same for the dW_hh kernel alone: hs (and h0 for one direction)
    and dxp read once, dW_hh written once, its product at the operand
    type's peak."""
    R = directions * batch
    op_bytes = 2 if dtype == "bfloat16" else 4
    bytes_ = (
        T * R * H * 4  # hs
        + (R * H * 4 if directions == 1 else 0)  # h0
        + T * R * 4 * H * op_bytes  # dxp
        + directions * H * 4 * H * 4  # dW_hh
    )
    flops = 2 * T * R * H * 4 * H
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": bytes_, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    emit(
        "device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=line, torch=torch.__version__, cuda=torch.version.cuda,
        capability=list(torch.cuda.get_device_capability(0)),
    )
    return line


def ptxas_summary(log: str, fragment: str) -> list:
    """``function: registers, shared memory, spills`` of the kernels whose
    (mangled) name holds `fragment`, from nvcc's ``-Xptxas -v`` output."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and fragment in name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


# instantiations of the wide-tile kernels: kf in (1, 3, 5) x (the forward
# body plain and eval at n 64, 96, 128, 192, 256, its dgrad and chain modes
# at 128, 192, 256; the weight gradient at 64, 96, 128)
WIDE_INSTANTIATIONS = 3 * (5 + 5 + 3 + 3 + 3)


def phase_build(torch, lstm_cuda, conv_fused) -> None:
    from voicesplit_tpu_torch.ops import _build
    from voicesplit_tpu_torch.ops import conv_cuda

    t0 = time.perf_counter()
    lib, log = _build.build()
    seconds = time.perf_counter() - t0
    grids = {
        f"{name}_B{b}_{dt}": lstm_cuda.launch_config(d, b, HIDDEN, getattr(torch, dt), bwd)
        for name, d, b, bwd in (
            ("lstm_fwd", 1, 1, False), ("lstm_fwd", 1, 2, False), ("bilstm_fwd", 2, 8, False),
            ("bilstm_fwd", 2, ROW_GROUP_BATCH, False),
            ("lstm_bwd", 1, 2, True), ("bilstm_bwd", 2, 8, True),
            ("bilstm_bwd", 2, ROW_GROUP_BATCH, True),
        )
        for dt in ("bfloat16", "float32")
    }
    # both LSTM walks: clusters of 16 blocks, one a direction and row group,
    # which the card must hold at least once, with no spilled byte, at H=400
    # on the cluster walk
    for key, gr in grids.items():
        check(gr.get("route", "cluster") == "cluster", f"{key}: not on the cluster walk ({gr})")
        check(gr["max_active_clusters"] >= 1, f"{key}: no cluster fits the card ({gr})")
        check(gr["local_bytes"] == 0, f"{key}: {gr['local_bytes']} local (spilled) bytes a thread")
    # at GRID_HIDDEN (the wide config) the forward (serving B=1, training B=2,
    # two directions at B=8) and the backward (B=2 and two directions at B=8)
    # on WIDE_ROUTES in bf16, the grid route in fp32 and where the split
    # walk's clusters are not all resident at once (NOT_RESIDENT_BATCH): every
    # cluster or block of the launch resident at once and no spilled byte
    wide = [(name, d, b, bwd, dt) for name, d, b, bwd in (
        ("lstm_fwd", 1, 1, False), ("lstm_fwd", 1, 2, False), ("bilstm_fwd", 2, 8, False),
        ("lstm_bwd", 1, 2, True), ("bilstm_bwd", 2, 8, True)) for dt in ("bfloat16", "float32")]
    wide += [(name, 2, NOT_RESIDENT_BATCH, bwd, "bfloat16")
             for name, bwd in (("bilstm_fwd", False), ("bilstm_bwd", True))]
    for name, d, b, bwd, dt in wide:
        key = f"{name}_B{b}_H{GRID_HIDDEN}_{dt}"
        gr = grids[key] = lstm_cuda.launch_config(d, b, GRID_HIDDEN, getattr(torch, dt), bwd)
        want = WIDE_ROUTES["backward" if bwd else "forward"]
        if dt == "float32" or b == NOT_RESIDENT_BATCH:
            want = "grid"
        check(gr["route"] == want, f"{key}: not on the {want} route ({gr})")
        if want == "grid":
            check(gr["resident_blocks"] >= gr["blocks"], f"{key}: more blocks than resident ({gr})")
        else:
            check(gr["max_active_clusters"] >= gr["blocks"] // gr["cluster"],
                  f"{key}: more clusters than resident ({gr})")
        check(gr["local_bytes"] == 0, f"{key}: {gr['local_bytes']} local (spilled) bytes a thread")
    # conv_dilated_fwd, conv_dgrad, conv_bn_act_fwd and conv_bn_act_eval
    # share the forward kernel body, conv_wgrad and conv_dilated_wgrad the
    # weight-gradient kernel: each a whole wave at most and no spilled byte,
    # at the paths' batches (B=1: serving with the dilated switch) and in
    # fp32 at the reduced shape
    configs = {
        "conv_dilated_fwd": lambda *a: conv_fused.fwd_launch_config(*a, dgrad=False),
        "conv_bn_act_eval": lambda *a: conv_fused._fwd_config(*a, conv_cuda.FWD_MODES["eval"]),
        "conv_dgrad": lambda *a: conv_fused.fwd_launch_config(*a, dgrad=True),
        "conv_bn_act_fwd": conv_fused.launch_config,
        "conv_wgrad": conv_fused.wgrad_launch_config,
    }
    cases = [(name, f"B{b}", (b, *CONV_SHAPE[1:]), torch.bfloat16) for name in configs for b in (2, 8)]
    cases += [(name, "B1", (1, *CONV_SHAPE[1:]), torch.bfloat16) for name in ("conv_dilated_fwd", "conv_bn_act_eval")]
    cases += [(name, "reduced_float32", CONV_SHAPE_FP32, torch.float32) for name in configs]
    for layer, ((kt, kf), dt) in ALL_CONV_LAYERS.items():
        for name, tag, shape, dtype in cases:
            key = f"{name}_{layer}_{tag}"
            gr = grids[key] = configs[name](shape, kt, kf, dt, dtype)
            check(gr["blocks"] <= gr["resident_blocks"],
                  f"{key}: {gr['blocks']} blocks > {gr['resident_blocks']} resident")
            check(gr["local_bytes"] == 0, f"{key}: {gr['local_bytes']} local (spilled) bytes a thread")
    # the wide tiles (bf16 at other widths than 64): no instantiation in the
    # library spills a byte, read from the library itself (so a cached build
    # is checked as a fresh one)
    wide = conv_cuda.wide_kernel_attributes()
    spilled = {k: a for k, a in wide.items() if a["local_bytes"]}
    check(len(wide) == WIDE_INSTANTIATIONS and not spilled,
          f"wide-tile kernels: {len(wide)} instantiations (want {WIDE_INSTANTIATIONS}), spilled {spilled}")
    emit("build", library=str(lib.relative_to(ROOT)), seconds=seconds,
         ptxas_lstm=ptxas_summary(log, "lstm"), ptxas_conv=ptxas_summary(log, "conv"),
         ptxas_passes=ptxas_summary(log, "prologue_kernel"),
         wide_kernels=wide, grids=grids)


def _fwd_case(torch, lstm_cuda, g, directions: int, batch: int, H: int, route: str,
              timed: bool, dtypes=("bfloat16", "float32"), T: int = T_FRAMES) -> dict:
    """One forward kernel against its plain version on the card at (batch,
    H) over T steps, in `dtypes`: errors, two launches with the same bits,
    the route they took; with `timed`, kernel and plain times."""
    dev = torch.device("cuda")
    R = directions * batch
    s = H ** -0.5
    xp32 = torch.randn(T, R, 4 * H, generator=g)
    ws32 = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g) for _ in range(directions)]
    h0 = torch.randn(R, H, generator=g).to(dev)
    c0 = torch.randn(R, H, generator=g).to(dev)
    name = "lstm_fwd" if directions == 1 else "bilstm_fwd"
    entry = {}
    for dt in dtypes:
        dtype = getattr(torch, dt)
        xp = xp32.to(dev, dtype)
        ws = [w.to(dev, dtype) for w in ws32]
        if directions == 1:
            args = (xp, ws[0], h0, c0)
            kernel, plain = lstm_cuda.lstm_fwd, lstm_cuda.lstm_fwd_ref
        else:
            args = (xp, ws[0], ws[1])
            kernel, plain = lstm_cuda.bilstm_fwd, lstm_cuda.bilstm_fwd_ref
        routes = dict(lstm_cuda.ROUTES)
        with torch.inference_mode():
            got = kernel(*args)
            again = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
        took = {k: v - routes[k] for k, v in lstm_cuda.ROUTES.items()}
        errs = {
            k: (a - b).abs().max().item()
            for k, a, b in zip(("hs", "cs", "gates"), got, want)
        }
        if directions == 1:
            errs["h_final"] = (got[0][-1] - want[0][-1]).abs().max().item()
            errs["c_final"] = (got[1][-1] - want[1][-1]).abs().max().item()
        finite = all(torch.isfinite(a).all().item() for a in got)
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(errs.values())
        entry[dt] = {"max_abs_err": err, "errors": errs, "tol": TOL[dt], "same_bits_twice": same_bits,
                     "routes": took}
        check(finite, f"{name} B={batch} H={H} {dt}: non-finite output")
        check(err <= TOL[dt], f"{name} B={batch} H={H} {dt}: max abs err {err} > {TOL[dt]}")
        check(same_bits, f"{name} B={batch} H={H} {dt}: two launches on the same inputs differ")
        check(took[route] == 2, f"{name} B={batch} H={H} {dt}: routes {took}, wanted {route}")
        if timed:
            with torch.inference_mode():
                entry[dt]["ms"] = time_ms(torch, lambda: kernel(*args), iters=20)
                entry[dt]["plain_ms"] = time_ms(torch, lambda: plain(*args), iters=3, warmup=1)
    return entry


def _cudnn_lstm_ms(torch, g, directions: int, batch: int, H: int, dtype: str = "bfloat16",
                   T: int = T_FRAMES, in_features: int = IN_FEATURES) -> float:
    """Yardstick: cuDNN LSTM's forward over the model's LSTM input (incl.
    the input projection), bf16 by default; its weights are compacted on
    every call in bf16 (torch's flatten_parameters takes only
    fp16/fp32/fp64).  In fp32, TF32 is off (`set_fp32_precision`)."""
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    lstm = torch.nn.LSTM(in_features, H, batch_first=True, bidirectional=directions == 2)
    lstm = lstm.to(dev, dt)
    x = torch.randn(batch, T, in_features, generator=g).to(dev, dt)
    with torch.inference_mode():
        return time_ms(torch, lambda: lstm(x), iters=20)


def phase_kernels(torch, lstm_cuda, seed: int) -> dict:
    """Forward kernels vs their plain versions on the card, both operand
    types, at the paths' shapes on the cluster walk, at ROW_GROUP_BATCH rows
    a direction (row groups) and at GRID_HIDDEN (bf16 on the split walk,
    fp32 on the grid route); times at the path's operand type (bf16) and on
    the grid route in fp32."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    T, H = T_FRAMES, HIDDEN
    results = {}
    for name, directions, batch in (("lstm_fwd", 1, 1), ("bilstm_fwd", 2, 8)):
        entry = _fwd_case(torch, lstm_cuda, g, directions, batch, H, "cluster", timed=True)
        results[name] = {"bf16": entry["bfloat16"], "fp32": entry["float32"],
                         "library_ms": _cudnn_lstm_ms(torch, g, directions, batch, H),
                         **lstm_bound(directions, batch, "bfloat16")}
        emit("kernels", kernel=name, batch=batch, T=T, H=H,
             bound_fp32=lstm_bound(directions, batch, "float32"), **results[name])
    entry = _fwd_case(torch, lstm_cuda, g, 2, ROW_GROUP_BATCH, H, "cluster", timed=True)
    results["bilstm_fwd"]["row_groups"] = {
        "batch": ROW_GROUP_BATCH, "bf16": entry["bfloat16"], "fp32": entry["float32"],
        **lstm_bound(2, ROW_GROUP_BATCH, "bfloat16")}
    emit("kernels", kernel="bilstm_fwd", T=T, H=H, **results["bilstm_fwd"]["row_groups"])
    # at GRID_HIDDEN: one direction as the wide config serves and trains it,
    # two at B=8 as the evaluation sweep's padded batches run; bf16 on the
    # split walk, fp32 on the grid route
    for name, directions, batch in (("lstm_fwd", 1, 1), ("bilstm_fwd", 2, 8)):
        library_ms = _cudnn_lstm_ms(torch, g, directions, batch, GRID_HIDDEN)
        for route, dt, key in (("split", "bfloat16", "bf16"), ("grid", "float32", "fp32")):
            entry = _fwd_case(torch, lstm_cuda, g, directions, batch, GRID_HIDDEN, route, timed=True,
                              dtypes=(dt,))
            results[f"{name}_{route}"] = {key: entry[dt], "library_ms": library_ms,
                                          **lstm_bound(directions, batch, dt, GRID_HIDDEN)}
            emit("kernels", kernel=f"{name}_{route}", batch=batch, T=T, H=GRID_HIDDEN,
                 **results[f"{name}_{route}"])
    return results


def _bwd_case(torch, lstm_cuda, g, directions: int, batch: int, timed: bool, H: int = HIDDEN,
              route: str = "cluster", dtypes=("bfloat16", "float32"), T: int = T_FRAMES) -> dict:
    """One backward kernel against its plain version on the card at `batch`
    rows a direction, H units and T steps, in `dtypes`, on the plain forward's
    outputs for random inputs and random cotangents: peak-relative errors,
    two launches with the same bits, both on `route`, and the call's dW_hh
    the bits of the dW_hh kernel alone on its dxp; with `timed`, kernel,
    plain and the dW_hh kernel alone."""
    dev = torch.device("cuda")
    R = directions * batch
    s = H ** -0.5
    xp32 = torch.randn(T, R, 4 * H, generator=g)
    ws32 = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g) for _ in range(directions)]
    states = [torch.randn(R, H, generator=g).to(dev) for _ in range(4)]  # h0 c0 dhf dcf
    dhs = torch.randn(T, R, H, generator=g).to(dev)
    name = "lstm_bwd" if directions == 1 else "bilstm_bwd"
    entry = {}
    for dt in dtypes:
        dtype = getattr(torch, dt)
        xp = xp32.to(dev, dtype)
        ws = [w.to(dev, dtype) for w in ws32]
        with torch.inference_mode():
            if directions == 1:
                hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, ws[0], *states[:2])
                args = (ws[0], gates, cs, hs, *states[:2], dhs, *states[2:], dtype)
                outs = ("dxp", "dwhh", "dh0", "dc0")
                kernel, plain = lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_ref
            else:
                hs, cs, gates = lstm_cuda.bilstm_fwd_ref(xp, ws[0], ws[1])
                args = (ws[0], ws[1], gates, cs, hs, dhs, dtype)
                outs = ("dxp", "dwhh_f", "dwhh_b")
                kernel, plain = lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_ref
            routes = dict(lstm_cuda.ROUTES_BWD)
            got = kernel(*args)
            again = kernel(*args)
            took = {k: v - routes[k] for k, v in lstm_cuda.ROUTES_BWD.items()}
            want = plain(*args)
            torch.cuda.synchronize()
        errs, rel = {}, {}
        for k, a, b in zip(outs, got, want):
            errs[k] = (a.float() - b.float()).abs().max().item()
            rel[k] = errs[k] / b.float().abs().max().item()
        finite = all(torch.isfinite(a).all().item() for a in got)
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(rel.values())
        entry[dt] = {"max_abs_err": max(errs.values()), "max_peak_rel_err": err,
                     "errors": errs, "peak_rel_errors": rel, "tol_peak_rel": TOL[dt],
                     "same_bits_twice": same_bits, "routes": took}
        what = f"{name} B={batch} H={H} {dt}"
        check(finite, f"{what}: non-finite output")
        check(err <= TOL[dt], f"{what}: peak-relative err {err} > {TOL[dt]}")
        check(same_bits, f"{what}: two launches on the same inputs differ")
        check(took[route] == 2, f"{what}: routes {took}, wanted {route}")
        # dW_hh is the dW_hh kernel's on every route: the same bits alone on
        # this call's dxp
        h_init = states[0] if directions == 1 else None
        dwhh = lambda: lstm_cuda.lstm_dwhh(hs, h_init, got[0], directions, dtype)  # noqa: E731
        with torch.inference_mode():
            alone = dwhh()
        check(all(torch.equal(a, b) for a, b in zip(alone, got[1:1 + directions])),
              f"{what}: dW_hh differs from the dW_hh kernel on the same dxp")
        if timed:
            # the dW_hh kernel alone, on this call's dxp (the walk is the rest)
            with torch.inference_mode():
                entry[dt]["ms"] = time_ms(torch, lambda: kernel(*args), iters=20)
                entry[dt]["dwhh_ms"] = time_ms(torch, dwhh, iters=20)
                entry[dt]["plain_ms"] = time_ms(torch, lambda: plain(*args), iters=3, warmup=1)
            entry[dt]["dwhh_bound"] = lstm_dwhh_bound(directions, batch, dt, H, T)
    return entry


def _cudnn_lstm_bwd_ms(torch, g, directions: int, batch: int, H: int, dtype: str = "bfloat16",
                       T: int = T_FRAMES, in_features: int = IN_FEATURES) -> float:
    """Yardstick: .backward() alone of a cuDNN LSTM over the model's LSTM
    input, bf16 by default (it also computes the input projection's
    gradients)."""
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    lstm = torch.nn.LSTM(in_features, H, batch_first=True, bidirectional=directions == 2)
    lstm = lstm.to(dev, dt)
    x = torch.randn(batch, T, in_features, generator=g).to(dev, dt)
    x.requires_grad_(True)
    out, _ = lstm(x)
    cot = torch.randn_like(out)
    return time_ms(torch, lambda: out.backward(cot, retain_graph=True), iters=20)


def phase_bwd_kernels(torch, lstm_cuda, seed: int) -> dict:
    """Backward kernels vs their plain versions on the card, both operand
    types, at the training path's shapes on the cluster walk, at
    ROW_GROUP_BATCH rows a direction (row groups) and at GRID_HIDDEN (the
    wide config's training batch B=2, and two directions at B=8) on the grid
    route; times at the path's operand type (bf16)."""
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    T, H = T_FRAMES, HIDDEN
    results = {}
    for name, directions, batch in (("lstm_bwd", 1, 2), ("bilstm_bwd", 2, 8)):
        entry = _bwd_case(torch, lstm_cuda, g, directions, batch, timed=True)
        results[name] = {"bf16": entry["bfloat16"], "fp32": entry["float32"],
                         "library_ms": _cudnn_lstm_bwd_ms(torch, g, directions, batch, H),
                         **lstm_bwd_bound(directions, batch, "bfloat16")}
        emit("kernels", kernel=name, batch=batch, T=T, H=H,
             bound_fp32=lstm_bwd_bound(directions, batch, "float32"), **results[name])
    # at GRID_HIDDEN: bf16 on the split walk, which the wide config's training
    # takes (B=2), fp32 on the grid route
    for name, directions, batch in (("lstm_bwd", 1, 2), ("bilstm_bwd", 2, 8)):
        library_ms = _cudnn_lstm_bwd_ms(torch, g, directions, batch, GRID_HIDDEN)
        for route, dt, key in (("split", "bfloat16", "bf16"), ("grid", "float32", "fp32")):
            entry = _bwd_case(torch, lstm_cuda, g, directions, batch, timed=True, H=GRID_HIDDEN,
                              route=route, dtypes=(dt,))
            results[f"{name}_{route}"] = {key: entry[dt], "library_ms": library_ms,
                                          **lstm_bwd_bound(directions, batch, dt, GRID_HIDDEN)}
            emit("kernels", kernel=f"{name}_{route}", batch=batch, T=T, H=GRID_HIDDEN,
                 **results[f"{name}_{route}"])
    entry = _bwd_case(torch, lstm_cuda, g, 2, ROW_GROUP_BATCH, timed=True)
    results["bilstm_bwd"]["row_groups"] = {
        "batch": ROW_GROUP_BATCH, "bf16": entry["bfloat16"], "fp32": entry["float32"],
        **lstm_bwd_bound(2, ROW_GROUP_BATCH, "bfloat16")}
    emit("kernels", kernel="bilstm_bwd", T=T, H=H, **results["bilstm_bwd"]["row_groups"])
    return results


def synthetic_batch(seed: int, batch: int, n: int, sr: int, emb_dim: int):
    """Two harmonic 'voices' plus noise per item, and unit-norm d-vectors."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    wav = np.zeros((batch, n), np.float64)
    for b in range(batch):
        for _ in range(2):
            f0 = rng.uniform(90.0, 260.0)
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0) * t + rng.uniform(0, 6.3))
            for k in range(1, 8):
                wav[b] += env * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3)) / k
        wav[b] += 0.01 * rng.standard_normal(n)
    wav *= 0.3 / np.abs(wav).max(axis=1, keepdims=True)
    emb = rng.standard_normal((batch, emb_dim))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return wav.astype(np.float32), emb.astype(np.float32)


class _PlainVersions:
    """Routes the kernel launches of a kernel module (`lstm_cuda`,
    `conv_fused`, `conv_cuda`) to the plain versions on the card while
    active.  `round_once`: `conv_cuda`'s forward and eval-mode block through
    `conv_dilated_fwd_round_once_ref` and `conv_bn_act_eval_round_once_ref`,
    which sum every tap in fp32 and round once as the kernel does, instead of
    their plain versions, which round each frequency tap's partial sum as
    the TPU kernel does (and, for the block, after each eager op); the
    other modules' plain versions already round once."""

    def __init__(self, module, round_once: bool = False):
        self.m, self.round_once = module, round_once

    def __enter__(self):
        self.saved = {n: getattr(self.m, f"_launch_{n}") for n in self.m.LAUNCHES}
        for n in self.saved:
            setattr(self.m, f"_launch_{n}", getattr(self.m, f"{n}_ref"))
        if self.round_once and "conv_dilated_fwd" in self.saved:
            self.m._launch_conv_dilated_fwd = self.m.conv_dilated_fwd_round_once_ref
            self.m._launch_conv_bn_act_eval = self.m.conv_bn_act_eval_round_once_ref

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.m, f"_launch_{n}", fn)


LSTM_WRAPPERS = ("lstm_fwd", "bilstm_fwd", "lstm_bwd", "bilstm_bwd")


def _route_name(name: str, route: str) -> str:
    """A wrapper's name on `route` as the kernels line names it: the cluster
    walk under the wrapper's own name, the others with the route appended."""
    return name if route == "cluster" else f"{name}_{route}"


def _check_routes(lstm_cuda, launches: dict, what: str, routes=None) -> dict:
    """Checks that every LSTM launch counted in `launches` (the wrappers'
    counts since the counters were zeroed) took its route: `routes` maps
    "forward" and "backward" to a route of `lstm_cuda.ROUTES` /
    `ROUTES_BWD` (default: the cluster walk, as at H=400; WIDE_ROUTES at
    GRID_HIDDEN).  Returns `launches` with each wrapper's count under its
    name on that route (`_route_name`), zero under its other routes' names,
    as the kernels line names them."""
    routes = routes or {"forward": "cluster", "backward": "cluster"}
    fwd = launches["lstm_fwd"] + launches["bilstm_fwd"]
    bwd = launches["lstm_bwd"] + launches["bilstm_bwd"]
    for kind, counts, n in (("forward", lstm_cuda.ROUTES, fwd), ("backward", lstm_cuda.ROUTES_BWD, bwd)):
        check(counts[routes[kind]] == n and sum(counts.values()) == n,
              f"{what}: {kind} routes {counts}, {n} launches, wanted {routes[kind]}")
    out = dict(launches)
    for k in LSTM_WRAPPERS:
        kind = "backward" if k.endswith("bwd") else "forward"
        for route in ("cluster", "split", "grid"):
            out[_route_name(k, route)] = launches[k] if route == routes[kind] else 0
    return out


def phase_separate(torch, lstm_cuda, seed: int, profile_dir) -> dict:
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.dsp.stft import istft_magphase, stft_magphase
    from voicesplit_tpu_torch.models.masknet import make_masknet

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), seed)
    n = int(config.audio.audio_len * ap.sample_rate)
    batches = {b: synthetic_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim)
               for b in (1, 8)}

    # the counted run of the main path
    torch.cuda.synchronize()
    lstm_cuda.reset_launch_counts()
    outs = {b: separate_batch(model, ap, *batches[b]) for b in (1, 8)}
    torch.cuda.synchronize()
    launches = dict(lstm_cuda.LAUNCHES)
    check(launches["lstm_fwd"] >= 2, f"lstm_fwd launches {launches['lstm_fwd']} < 2 (B=1)")
    check(launches["bilstm_fwd"] >= 1, f"bilstm_fwd launches {launches['bilstm_fwd']} < 1 (B=8)")
    # every forward launch on the cluster walk (lstm_fwd_kernel)
    launches = _check_routes(lstm_cuda, launches, "serving")

    report = {"launches": launches, "params": sum(p.numel() for p in model.parameters())}
    for b, out in outs.items():
        mixed, emb = (torch.as_tensor(a, device="cuda") for a in batches[b])
        check(tuple(out.shape) == (b, n), f"B={b}: output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"B={b}: non-finite output")
        with torch.inference_mode():
            spec, phase = ap.wav2spec_batch(mixed)
            mask = model(spec, emb)
            with _PlainVersions(lstm_cuda):
                mask_plain = model(spec, emb)
                out_plain = separate_batch(model, ap, mixed, emb)
            mag, ph = stft_magphase(mixed, ap.n_fft, ap.hop_length, ap.win_length)
            roundtrip = istft_magphase(mag, ph, ap.n_fft, ap.hop_length, ap.win_length, length=n)
        check(float(mask.min()) >= 0.0 and float(mask.max()) <= 1.0, f"B={b}: mask outside [0, 1]")
        mask_err = (mask - mask_plain).abs().max().item()
        wav_err = ((out - out_plain).abs().max() / out_plain.abs().max()).item()
        rt_snr = (10 * torch.log10((mixed ** 2).sum() / ((roundtrip - mixed) ** 2).sum())).item()
        check(mask_err <= SEPARATE_TOL, f"B={b}: mask vs plain LSTM {mask_err} > {SEPARATE_TOL}")
        check(wav_err <= SEPARATE_TOL, f"B={b}: waveform vs plain LSTM {wav_err} > {SEPARATE_TOL}")
        check(rt_snr >= ROUNDTRIP_MIN_SNR_DB, f"B={b}: STFT round trip {rt_snr} dB")
        ms = time_ms(torch, lambda: separate_batch(model, ap, mixed, emb), iters=10)
        p50, p75 = _latency_ms(torch, lambda: separate_batch(model, ap, mixed, emb), LATENCY_CALLS)
        report[f"B{b}"] = {
            "samples": n, "mask_range": [float(mask.min()), float(mask.max())],
            "mask_err_vs_plain": mask_err, "wave_rel_err_vs_plain": wav_err,
            "roundtrip_snr_db": rt_snr, "device_ms_mean": ms, "calls": LATENCY_CALLS,
            "latency_ms_p50": p50, "latency_ms_p75": p75,
            "audio_s_per_s": b * config.audio.audio_len / (p50 / 1e3),
        }
        if profile_dir:
            report[f"B{b}"]["profile"] = profile(
                torch, profile_dir, f"separate_B{b}", lambda: separate_batch(model, ap, mixed, emb)
            )
    emit("separate", device=torch.cuda.get_device_name(0), **report)
    return launches


def train_batch(seed: int, batch: int, n: int, sr: int, emb_dim: int) -> dict:
    """Target = one synthetic voice, mixture = target + another voice."""
    target, emb = synthetic_batch(seed, batch, n, sr, emb_dim)
    other, _ = synthetic_batch(seed + 1000, batch, n, sr, emb_dim)
    return {"mixed_wav": target + other, "target_wav": target, "emb": emb,
            "wav_len": np.full((batch,), n, np.int32)}


def _snapshot(model, optimizer, state):
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            copy.deepcopy(optimizer.state_dict()), state.step)


def _restore(model, optimizer, state, snap) -> None:
    model.load_state_dict(snap[0])
    optimizer.load_state_dict(snap[1])
    state.step = snap[2]


def _lstm_grads(model) -> dict:
    return {k: p.grad.detach().float().clone() for k, p in model.lstm.named_parameters()}


def phase_train(torch, lstm_cuda, seed: int, profile_dir) -> dict:
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    config.train_config.learning_rate = TRAIN_LR
    ap = make_audio_processor(config)
    n = int(config.audio.audio_len * ap.sample_rate)
    report = {"config": "configs/voicesplit.json", "loss_name": config.loss.loss_name,
              "compute_dtype": config.train_config.compute_dtype, "learning_rate": TRAIN_LR,
              "tolerances": TRAIN_TOL}
    launches = {k: 0 for k in lstm_cuda.LAUNCHES}
    for b in (2, 8):
        model = weights.init_random_(make_masknet(config), seed)
        optimizer = make_optimizer(config, model)
        state = create_train_state(model, optimizer)
        step = make_train_step(config, model, ap, optimizer)
        batch = train_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim)
        before = _snapshot(model, optimizer, state)

        # the counted run of the training path: one step from fresh weights
        torch.cuda.synchronize()
        lstm_cuda.reset_launch_counts()
        mk = step(state, batch)
        torch.cuda.synchronize()
        counted = dict(lstm_cuda.LAUNCHES)
        for k, v in counted.items():
            launches[k] += v
        check(counted == TRAIN_LAUNCHES[b], f"B={b}: launches per step {counted}")
        _check_routes(lstm_cuda, counted, f"train B={b}")
        loss0, gn0 = float(mk["loss"]), float(mk["grad_norm"])
        check(np.isfinite(loss0) and not bool(mk["loss_exploded"]), f"B={b}: loss {loss0}")
        check(gn0 > 0 and np.isfinite(gn0), f"B={b}: grad_norm {gn0}")
        unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[0][k])]
        check(not unmoved, f"B={b}: unchanged after a step: {unmoved}")

        # the same step from the same weights through the plain versions
        gk = _lstm_grads(model)
        _restore(model, optimizer, state, before)
        with _PlainVersions(lstm_cuda):
            mp = step(state, batch)
        gp = _lstm_grads(model)
        vs_plain = {
            "loss_rel": abs(loss0 - float(mp["loss"])) / abs(float(mp["loss"])),
            "grad_norm_rel": abs(gn0 - float(mp["grad_norm"])) / float(mp["grad_norm"]),
            "lstm_grad_peak_rel": {
                k: ((gk[k] - gp[k]).abs().max() / gp[k].abs().max()).item() for k in gk
            },
        }
        for k, tol in TRAIN_TOL.items():
            err = vs_plain[k]
            err = max(err.values()) if isinstance(err, dict) else err
            check(err <= tol, f"B={b}: kernels vs plain {k} {err} > {tol}")

        # steady state: synchronized steps
        for _ in range(TRAIN_WARM):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(step(state, batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        losses = [float(m["loss"]) for m in metrics]
        grad_norms = [float(m["grad_norm"]) for m in metrics]
        check(all(np.isfinite(losses)), f"B={b}: non-finite loss in {losses}")
        check(losses[-1] < loss0, f"B={b}: loss did not fall on a fixed batch: {loss0} -> {losses}")
        p50, p75 = (float(np.percentile(times, q)) for q in (50, 75))
        report[f"B{b}"] = {
            "launches_per_step": counted, "first_loss": loss0, "first_grad_norm": gn0,
            "kernels_vs_plain": vs_plain, "steps": TRAIN_STEPS,
            "step_ms_p50": p50, "step_ms_p75": p75,
            "audio_s_per_s": b * config.audio.audio_len / (p50 / 1e3),
            "losses": losses, "grad_norms": grad_norms,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        }
        if profile_dir:
            report[f"B{b}"]["profile"] = profile(
                torch, profile_dir, f"train_B{b}", lambda: step(state, batch)
            )
        del model, optimizer, state, step
        torch.cuda.empty_cache()
    emit("train", device=torch.cuda.get_device_name(0), **report)
    return launches


def conv_bound(kind: str, shape, kt: int, kf: int, dt: int, dtype: str,
               cout: int = None) -> dict:
    """Least time for one conv kernel: activations, weights and results each
    moved once, against the products of the taps that fall inside the
    tensor (a tap in the halo multiplies zeros and is not counted) at the
    operand type's peak.  `shape` is the input's ``[B, T, F, Cin]``; the
    output (or, for a weight gradient, the cotangent) has `cout` channels,
    by default Cin."""
    B, T, F, cin = shape
    cout = cin if cout is None else cout
    op = 2 if dtype == "bfloat16" else 4
    in_bytes, out_bytes = B * T * F * cin * op, B * T * F * cout * op
    w_elems = kt * kf * cin * cout
    if kind == "conv_wgrad":
        bytes_ = in_bytes + out_bytes + w_elems * 4 + 2 * cin * 4  # x, d_raw; dW; inv, shift
    elif kind == "conv_dilated_wgrad":
        bytes_ = in_bytes + out_bytes + w_elems * 4  # x, dy; dW
    elif kind == "conv_dilated_fwd":
        bytes_ = in_bytes + out_bytes + w_elems * op  # x, out; W
    elif kind == "conv_bn_act_eval":
        bytes_ = in_bytes + out_bytes + w_elems * op + 5 * cout * 4  # x, out; W; bias, BN vectors
    elif kind == "conv_dgrad":
        bytes_ = in_bytes + out_bytes + w_elems * op + cin * 4  # d_raw, dx; W; dbias
    else:  # x, raw; W; inv, shift; bias, stats
        bytes_ = in_bytes + out_bytes + w_elems * op + (2 * cin + 3 * cout) * 4
    pad_t, pad_f = (kt - 1) * dt // 2, (kf - 1) // 2
    rows = sum(max(0, T - abs(i * dt - pad_t)) for i in range(kt))
    cols = sum(max(0, F - abs(j - pad_f)) for j in range(kf))
    flops = 2 * cin * cout * B * rows * cols
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": bytes_, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def draw_bound(shape, dtype: str, act: str) -> dict:
    """Least time for the d_raw pass: dy and x read once, d_raw written once
    (and its table's six [C] rows read once) at the memory rate, against
    DRAW_OPS fp32 operations an element at the fp32 rate."""
    n, C = int(np.prod(shape)), shape[-1]
    bytes_ = 3 * n * (2 if dtype == "bfloat16" else 4) + 6 * C * 4
    flops = n * DRAW_OPS[act]
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return {"bytes": bytes_, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def branch_bound(kind: str, shape, kt: int, kf: int, dt: int, act: str) -> dict:
    """Least time for a prologue branch as one function (bf16): the conv
    kernel's bytes (`conv_bound`, dy in d_raw's place) plus the raw x and its
    table's rows, d_raw being no tensor of its own, at the memory rate,
    against its products at the bf16 rate and the draw's DRAW_OPS at the fp32
    rate, each on its own units (the tensor cores and the fp32 units can run
    at once); the largest of the three."""
    conv = conv_bound(kind, shape, kt, kf, dt, "bfloat16")
    draw = draw_bound(shape, "bfloat16", act)
    bytes_ = conv["bytes"] + int(np.prod(shape)) * 2 + 6 * shape[-1] * 4
    times = {"bytes": bytes_ / HBM_BYTES_PER_S * 1e3,
             "operations": max(conv["flops"] / PEAK_FLOPS["bfloat16"],
                               draw["flops"] / PEAK_FLOPS["float32"]) * 1e3}
    bound_by = max(times, key=times.get)
    return {"bytes": bytes_, "flops": conv["flops"] + draw["flops"], "bound_ms": times[bound_by],
            "bound_by": bound_by}


def _timed_conv_layers() -> list:
    """The (batch, layer) pairs the conv phases time: conv2 … conv7's six
    layer kinds at B=2 and B=8, and the wide config's extra block (time
    dilation 32) at its batch, B=2."""
    return [(b, layer) for b in (2, 8) for layer in CONV_LAYERS] + [(2, layer) for layer in WIDE_CONV_LAYERS]


def _per_step(times: dict, ms: str = "ms") -> dict:
    """A kernel's time (`ms`) summed over conv2 … conv7 (one launch per
    layer), by batch, beside the same sums of its library yardstick and
    bound."""
    return {f"B{b}": {k: sum(times[f"B{b}/{layer}"][k] for layer in CONV_LAYERS)
                      for k in (ms, "library_ms", "bound_ms")}
            for b in (2, 8)}


def _peak_rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _edge_errs(got, want) -> dict:
    """Peak-relative error of the first and last 32 time rows and 2
    frequency columns of a [B, T, F, C] output, each on its own."""
    peak = want.float().abs().max()
    cuts = {"rows_first32": (slice(None), slice(0, 32)), "rows_last32": (slice(None), slice(-32, None)),
            "cols_first2": (slice(None), slice(None), slice(0, 2)),
            "cols_last2": (slice(None), slice(None), slice(-2, None))}
    return {k: ((got[c].float() - want[c].float()).abs().max() / peak).item()
            for k, c in cuts.items()}


def _conv_inputs(torch, shape, kt, kf, dtype, g, cout: int = None):
    """Random activations ``shape`` (Cin channels), cotangent (`cout`
    channels, by default Cin), weights, bias and BatchNorm scalars of one
    layer on the card; fan-in-scaled weights keep raw of order 1."""
    dev = torch.device("cuda")
    C = shape[-1]
    cout = C if cout is None else cout
    x = torch.randn(shape, generator=g).to(dev, dtype)
    d = torch.randn(*shape[:-1], cout, generator=g).to(dev, dtype)
    w = (torch.randn(kt, kf, C, cout, generator=g) * (kt * kf * C) ** -0.5).to(dev, dtype)
    bias = (0.1 * torch.randn(cout, generator=g)).to(dev)
    mean, var = 0.2 * torch.randn(C, generator=g), torch.empty(C).uniform_(0.5, 2.0, generator=g)
    scale, beta = torch.empty(C).uniform_(0.5, 1.5, generator=g), 0.1 * torch.randn(C, generator=g)
    return x, d, w, bias, (mean.to(dev), var.to(dev), scale.to(dev), beta.to(dev))


def _check_conv_case(torch, cf, cc, case, shape, layer, act, dtype_name, g) -> dict:
    """One layer and prologue through the three kernels and their plain
    versions; raises on disagreement or
    on two launches that differ.  With a prologue, `conv_wgrad` must also
    give the bits of `conv_dilated_wgrad` on the prologue pass's output."""
    (kt, kf), dt = ALL_CONV_LAYERS[layer]
    dtype = getattr(torch, dtype_name)
    tol = CONV_TOL[dtype_name]
    x, d, w, bias, bn = _conv_inputs(torch, shape, kt, kf, dtype, g)
    scal = cf._scal_table(*bn)
    on = act is not None
    wf = cf.pack_weight_flipped(w, dtype)
    runs = {
        "conv_bn_act_fwd": (cf.conv_bn_act_fwd, cf.conv_bn_act_fwd_ref, (x, w, bias, scal, dt, act, on),
                            ("out", "sums")),
        "conv_dgrad": (cf.conv_dgrad, cf.conv_dgrad_ref, (d, wf, dt), ("out", "sums")),
        "conv_wgrad": (cf.conv_wgrad, cf.conv_wgrad_ref, (x, d, scal, kt, kf, dt, act, on), ("dw",)),
    }
    report = {}
    with torch.inference_mode():
        for name, (kernel, plain, args, kinds) in runs.items():
            if name == "conv_dgrad" and on:
                continue  # no prologue on this kernel: checked in the plain case
            got, again, want = kernel(*args), kernel(*args), plain(*args)
            torch.cuda.synchronize()
            got, again, want = (o if isinstance(o, tuple) else (o,) for o in (got, again, want))
            errs = {k: _peak_rel(a, b) for k, a, b in zip(kinds, got, want)}
            if kinds[0] == "out":
                errs.update({f"out_{k}": v for k, v in _edge_errs(got[0], want[0]).items()})
            entry = {"errors": errs,
                     "abs_err": (got[0].float() - want[0].float()).abs().max().item(),
                     "share_of_elements_that_differ": (got[0] != want[0]).float().mean().item()}
            for k, v in errs.items():
                limit = tol["out" if k.startswith("out") else k]
                check(np.isfinite(v) and v <= limit, f"{name} {case}: {k} error {v} > {limit}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {case}: two launches on the same inputs differ")
            report[name] = entry
        if on:
            y, y_plain = cf.conv_wgrad_prologue(x, scal, act), cf._prologue(x, scal, act, True)
            split = cc.conv_dilated_wgrad(y, d, kt, kf, dt)
            torch.cuda.synchronize()
            check(torch.equal(cf.conv_wgrad(x, d, scal, kt, kf, dt, act, on), split),
                  f"conv_wgrad {case}: not the bits of conv_dilated_wgrad on its prologue's output")
            err = _peak_rel(y, y_plain)
            check(np.isfinite(err) and err <= tol["out"],
                  f"conv_wgrad prologue {case}: error {err} > {tol['out']}")
            report["conv_wgrad"]["prologue_vs_plain"] = {
                "peak_rel": err, "share_of_elements_that_differ": (y != y_plain).float().mean().item()}
    return report


def _chain_times(torch, cf, x, d, w, bias, bn, dt: int, act, iters: int) -> dict:
    """The chain's three kernels on one layer's bf16 operands (`act`: the
    prologue, or None), by kernel: time, plain version's time, a library
    yardstick the port never calls, bound; `conv_bn_act_fwd` and
    `conv_wgrad` with their prologue pass inside their time, and the pass
    on its own."""
    import torch.nn.functional as F

    from voicesplit_tpu_torch.ops import bn_act

    kt, kf = w.shape[:2]
    shape = tuple(x.shape)
    on = act is not None
    scal = cf._scal_table(*bn)
    wf = cf.pack_weight_flipped(w, torch.bfloat16)
    pad = ((kt - 1) * dt // 2, (kf - 1) // 2)
    # library yardsticks: cuDNN convs on channels-last bf16 views; for the
    # forward also the eager BatchNorm + activation pass the prologue
    # replaces and the batch statistics (`torch.var_mean`)
    x_nchw, d_nchw = x.permute(0, 3, 1, 2), d.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    cbias = bias.to(torch.bfloat16)

    def lib_fwd():
        y = bn_act.bn_act_eval(x_nchw, bn[2], bn[3], bn[0], bn[1], act) if on else x_nchw
        raw = F.conv2d(y, w_oihw, cbias, padding=pad, dilation=(dt, 1))
        return raw, torch.var_mean(raw, dim=(0, 2, 3), correction=0)

    def lib_bwd(mask):
        return torch.ops.aten.convolution_backward(
            d_nchw, x_nchw, w_oihw, None, (1, 1), pad, (dt, 1), False, (0, 0), 1, mask)

    calls = {
        "conv_bn_act_fwd": (lambda: cf.conv_bn_act_fwd(x, w, bias, scal, dt, act, on),
                            lambda: cf.conv_bn_act_fwd_ref(x, w, bias, scal, dt, act, on),
                            lib_fwd),
        "conv_dgrad": (lambda: cf.conv_dgrad(d, wf, dt), lambda: cf.conv_dgrad_ref(d, wf, dt),
                       lambda: lib_bwd((True, False, False))),
        "conv_wgrad": (lambda: cf.conv_wgrad(x, d, scal, kt, kf, dt, act, on),
                       lambda: cf.conv_wgrad_ref(x, d, scal, kt, kf, dt, act, on),
                       lambda: lib_bwd((False, True, False))),
    }
    out = {}
    with torch.inference_mode():
        for name, (kernel, plain, library) in calls.items():
            out[name] = {
                "ms": time_ms(torch, kernel, iters=iters, warmup=1),
                "plain_ms": time_ms(torch, plain, iters=2, warmup=1),
                "library_ms": time_ms(torch, library, iters=iters, warmup=1),
                **conv_bound(name, shape, kt, kf, dt, "bfloat16"),
            }
        if on:
            pass_ms = time_ms(torch, lambda: cf.conv_wgrad_prologue(x, scal, act), iters=iters, warmup=1)
            for name in ("conv_bn_act_fwd", "conv_wgrad"):
                out[name]["prologue_pass_ms"] = pass_ms
    return out


def _dilated_times(torch, cc, cf, x, d, w, dt: int, iters: int) -> tuple:
    """`conv_dilated_fwd` (as forward and as data gradient) and
    `conv_dilated_wgrad` on one layer's bf16 operands (x ``[B, T, F, Cin]``,
    d ``[B, T, F, Cout]``, w ``[kt, kf, Cin, Cout]``): time, plain
    version's time, a library yardstick the port never calls (cuDNN
    ``conv2d``; ``aten.convolution_backward``), bound, and for a layer the
    chain also takes (Cin = Cout, a multiple of its slab) the chain's
    ``conv_dgrad``."""
    import torch.nn.functional as F

    kt, kf, cin, cout = w.shape
    shape = tuple(x.shape)
    wf = cc.flip_weight(w)
    pad = ((kt - 1) * dt // 2, (kf - 1) // 2)
    x_nchw, d_nchw = x.permute(0, 3, 1, 2), d.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def lib_bwd(mask):
        return torch.ops.aten.convolution_backward(
            d_nchw, x_nchw, w_oihw, None, (1, 1), pad, (dt, 1), False, (0, 0), 1, mask)

    with torch.inference_mode():
        fwd = {
            "ms": time_ms(torch, lambda: cc.conv_dilated_fwd(x, w, dt), iters, warmup=1),
            "data_gradient_ms": time_ms(torch, lambda: cc.conv_dilated_fwd(d, wf, dt), iters, warmup=1),
            "plain_ms": time_ms(torch, lambda: cc.conv_dilated_fwd_ref(x, w, dt), 2, warmup=1),
            "library_ms": time_ms(
                torch, lambda: F.conv2d(x_nchw, w_oihw, None, padding=pad, dilation=(dt, 1)),
                iters, warmup=1),
            "library_data_gradient_ms": time_ms(torch, lambda: lib_bwd((True, False, False)),
                                                iters, warmup=1),
        }
        if cin == cout and cin % cf.CHANNEL_SLAB == 0:
            fwd["fused_chain_conv_dgrad_ms"] = time_ms(torch, lambda: cf.conv_dgrad(d, wf, dt),
                                                       iters, warmup=1)
        fwd.update(conv_bound("conv_dilated_fwd", shape, kt, kf, dt, "bfloat16", cout))
        wgrad = {
            "ms": time_ms(torch, lambda: cc.conv_dilated_wgrad(x, d, kt, kf, dt), iters, warmup=1),
            "plain_ms": time_ms(torch, lambda: cc.conv_dilated_wgrad_ref(x, d, kt, kf, dt), 2, warmup=1),
            "library_ms": time_ms(torch, lambda: lib_bwd((False, True, False)), iters, warmup=1),
            **conv_bound("conv_dilated_wgrad", shape, kt, kf, dt, "bfloat16", cout),
        }
    return fwd, wgrad


def phase_conv_kernels(torch, cf, cc, seed: int) -> dict:
    """The fused chain's kernels vs their plain versions on the card, then
    their times per layer kind and batch."""
    g = torch.Generator(device="cpu").manual_seed(seed + 2)
    # every layer without a prologue (conv_dgrad has none) and with mish,
    # and relu once
    cases = [(layer, act) for layer in ALL_CONV_LAYERS for act in (None, "mish")] + [("5x5-d1", "relu")]
    worst = {name: {"bfloat16": 0.0, "float32": 0.0} for name in CONV_KERNELS}
    agreement = {}
    for dtype_name, shape in (("bfloat16", CONV_SHAPE), ("float32", CONV_SHAPE_FP32)):
        for layer, act in cases:
            case = f"{layer}/{act or 'plain'}/{dtype_name}"
            agreement[case] = _check_conv_case(torch, cf, cc, case, shape, layer, act, dtype_name, g)
            for name, entry in agreement[case].items():
                worst[name][dtype_name] = max(worst[name][dtype_name], entry["abs_err"])
        torch.cuda.empty_cache()
    # why the plain versions are one matrix product per tap and no library
    # conv: cuDNN's fp32 weight gradient (TF32 off) against the plain version
    # on the same bf16-valued operands, whose products are exact in fp32
    (kt, kf), dt = CONV_LAYERS["5x5-d1"]
    x, d, _, _, bn = _conv_inputs(torch, CONV_SHAPE, kt, kf, torch.bfloat16, g)
    with torch.inference_mode():
        want = cf.conv_wgrad_ref(x, d, cf._scal_table(*bn), kt, kf, dt, None, False)
        lib = torch.ops.aten.convolution_backward(
            d.float().permute(0, 3, 1, 2), x.float().permute(0, 3, 1, 2),
            torch.empty(64, 64, kt, kf, device=x.device), None, (1, 1),
            ((kt - 1) * dt // 2, (kf - 1) // 2), (dt, 1), False, (0, 0), 1, (False, True, False),
        )[1].permute(2, 3, 1, 0)
        library_fp32_wgrad_err = _peak_rel(lib, want)
    del x, d, want, lib
    emit("conv kernels", shape_bf16=list(CONV_SHAPE), shape_fp32=list(CONV_SHAPE_FP32),
         tolerances_peak_rel=CONV_TOL, agreement=agreement,
         cudnn_fp32_wgrad_vs_plain_peak_rel=library_fp32_wgrad_err)

    # times: bf16, the chain's prologue (mish) on, per layer kind and batch;
    # the times of conv_bn_act_fwd and conv_wgrad hold their prologue pass,
    # also timed on its own
    timing = {name: {} for name in CONV_KERNELS}
    for b, layer in _timed_conv_layers():
        shape = (b, *CONV_SHAPE[1:])
        (kt, kf), dt = ALL_CONV_LAYERS[layer]
        act = None if layer == "7x1" else "mish"  # the chain's first layer has no prologue
        x, d, w, bias, bn = _conv_inputs(torch, shape, kt, kf, torch.bfloat16, g)
        times = _chain_times(torch, cf, x, d, w, bias, bn, dt, act, iters=5 if b == 2 else 3)
        for name, entry in times.items():
            timing[name][f"B{b}/{layer}"] = entry
        del x, d, w
        torch.cuda.empty_cache()
    emit("conv kernel times", dtype="bfloat16", prologue="mish (none on the 7x1 layer)",
         library="cuDNN conv2d (+ eager BN + act, + var_mean) / aten.convolution_backward, "
                 "channels-last bf16",
         times=timing, ms_per_step={name: _per_step(timing[name]) for name in CONV_KERNELS})
    # the kernels line quotes the (5,5) dilation-1 layer at the config's batch
    head = "B2/5x5-d1"
    return {
        name: {"bf16": {"max_abs_err": worst[name]["bfloat16"], **timing[name][head]},
               "fp32": {"max_abs_err": worst[name]["float32"]},
               "library_ms": timing[name][head]["library_ms"],
               "bound_ms": timing[name][head]["bound_ms"], "bound_by": timing[name][head]["bound_by"],
               "timed_at": head, "ms_by_batch_and_layer": {k: v["ms"] for k, v in timing[name].items()}}
        for name in CONV_KERNELS
    }


def _prologue_inputs(torch, cf, shape, dtype, act: str, g) -> dict:
    """One shape's operands of the prologue branches on the card, from the
    card generator `g`: the layer's input ``x_in`` and its input prologue's
    BatchNorm (``bn_lhs``, table ``scal_lhs``), the cotangent ``dy`` of the
    layer's activated output, the raw conv output ``raw`` drawn with the
    statistics of a BatchNorm ``bn``, and the chain's route to d_raw:
    `_stage1`'s sums (in ``scal``'s rows 4 and 5, as the chain fills them),
    dz and x̂."""
    dev, C = torch.device("cuda"), shape[-1]

    def affine():
        return (0.2 * torch.randn(C, device=dev, generator=g),
                0.5 + 1.5 * torch.rand(C, device=dev, generator=g),
                0.5 + torch.rand(C, device=dev, generator=g),
                0.1 * torch.randn(C, device=dev, generator=g))

    bn, bn_lhs = affine(), affine()
    x_in = torch.randn(shape, device=dev, generator=g).to(dtype)
    dy = (0.1 * torch.randn(shape, device=dev, generator=g)).to(dtype)
    raw = (bn[0] + bn[1].sqrt() * torch.randn(shape, device=dev, generator=g)).to(dtype)
    fwd = cf._scal_table(*bn)
    s_dz, s_dzx, dz, xhat = cf._stage1(dy, raw, fwd, act)
    n = shape[0] * shape[1] * shape[2]
    return {"x_in": x_in, "dy": dy, "raw": raw, "bn": bn, "bn_lhs": bn_lhs,
            "scal": cf._scal_table(*bn, mean_dz=s_dz / n, mean_dzx=s_dzx / n),
            "scal_lhs": cf._scal_table(*bn_lhs), "dz": dz, "xhat": xhat}


def _check_prologue_case(torch, cf, case, inp, w, dt: int, act: str, lhs: bool, dtype_name) -> dict:
    """The d_raw pass and both branches (the pass, then `conv_dgrad` or
    `conv_wgrad`) on one layer against their plain versions (CONV_TOL; the
    same bits twice), and against the chain's eager route
    (`_materialize_draw` of `_stage1`'s dz and x̂, then the same kernels),
    which draws in the compute dtype."""
    kt, kf = w.shape[:2]
    tol = CONV_TOL[dtype_name]
    dy, raw, scal, x_in, scal_lhs = inp["dy"], inp["raw"], inp["scal"], inp["x_in"], inp["scal_lhs"]
    wf = cf.pack_weight_flipped(w, dy.dtype)
    act_prev = "mish" if lhs else None
    report = {}

    def draw():
        return cf.conv_draw_prologue(dy, raw, scal, act)

    def draw_ref():
        return cf.conv_draw_prologue_ref(dy, raw, scal, act)

    with torch.inference_mode():
        runs = {
            "conv_draw_prologue": (lambda: (draw(),), lambda: (draw_ref(),), ("out",)),
            "dgrad_branch": (lambda: cf.conv_dgrad(draw(), wf, dt),
                             lambda: cf.conv_dgrad_ref(draw_ref(), wf, dt), ("out", "sums")),
            "wgrad_branch": (lambda: (cf.conv_wgrad(x_in, draw(), scal_lhs, kt, kf, dt, act_prev, lhs),),
                             lambda: (cf.conv_wgrad_ref(x_in, draw_ref(), scal_lhs, kt, kf, dt, act_prev, lhs),),
                             ("dw",)),
        }
        outs = {}
        for name, (kernel, plain, kinds) in runs.items():
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            errs = {k: _peak_rel(a, b) for k, a, b in zip(kinds, got, want)}
            for k, v in errs.items():
                check(np.isfinite(v) and v <= tol[k], f"{name} {case}: {k} error {v} > {tol[k]}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {case}: two launches on the same inputs differ")
            report[name] = {"errors": errs, "abs_err": (got[0].float() - want[0].float()).abs().max().item(),
                            "share_of_elements_that_differ": (got[0] != want[0]).float().mean().item()}
            outs[name] = got
        d_raw = outs["conv_draw_prologue"][0]
        # the chain's eager route to d_raw, then the same prologue-free kernels
        d_eager = cf._materialize_draw(inp["dz"], inp["xhat"], scal).contiguous()
        dx_e, db_e = cf.conv_dgrad(d_eager, wf, dt)
        dw_e = cf.conv_wgrad(x_in, d_eager, scal_lhs, kt, kf, dt, act_prev, lhs)
        pairs = {"d_raw": (d_raw, d_eager), "dx": (outs["dgrad_branch"][0], dx_e),
                 "dbias": (outs["dgrad_branch"][1], db_e), "dw": (outs["wgrad_branch"][0], dw_e)}
        report["vs_eager_route"] = {
            k: {"peak_rel": _peak_rel(a, b),
                "cosine": torch.nn.functional.cosine_similarity(
                    a.float().flatten(), b.float().flatten(), dim=0).item()}
            for k, (a, b) in pairs.items()}
        # dbias against the sum of |d_raw| it cancels down from, per channel
        abs_sum = d_raw.float().abs().sum(dim=(0, 1, 2)).max()
        report["vs_eager_route"]["dbias"]["rel_to_abs_sum"] = (
            (outs["dgrad_branch"][1] - db_e).abs().max() / abs_sum).item()
    return report


def _prologue_times(torch, cf, inp, w, dt: int, act: str, lhs: bool, iters: int) -> dict:
    """bf16, one layer: the d_raw pass alone, each branch (pass + kernel), the
    prologue-free kernel alone, the plain versions, the chain's eager draw
    (dz, x̂ and `_materialize_draw`: the pass's inputs and output) and its
    `_stage1` (which also takes the sums), and the library routes the port
    never calls (the eager draw, then cuDNN's data or weight gradient,
    ``aten.convolution_backward``, on channels-last bf16; the weight
    gradient's input through the eager BN + activation where the chain has
    an input prologue), beside the bounds."""
    from voicesplit_tpu_torch.ops import bn_act

    kt, kf = w.shape[:2]
    shape = tuple(inp["dy"].shape)
    dy, raw, scal, x_in, scal_lhs = inp["dy"], inp["raw"], inp["scal"], inp["x_in"], inp["scal_lhs"]
    wf = cf.pack_weight_flipped(w, dy.dtype)
    act_prev = "mish" if lhs else None
    pad = ((kt - 1) * dt // 2, (kf - 1) // 2)
    x_nchw = x_in.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def eager_draw():
        return cf._materialize_draw(*cf._dz_xhat(dy, raw, scal, act), scal)

    def library(mask):
        y = x_nchw
        if lhs and mask[1]:
            b = inp["bn_lhs"]
            y = bn_act.bn_act_eval(x_nchw, b[2], b[3], b[0], b[1], act_prev)
        return torch.ops.aten.convolution_backward(
            eager_draw().permute(0, 3, 1, 2), y, w_oihw, None, (1, 1), pad, (dt, 1), False, (0, 0), 1,
            mask)

    with torch.inference_mode():
        d_raw = cf.conv_draw_prologue(dy, raw, scal, act)

        def t(fn, n=iters):
            return time_ms(torch, fn, iters=n, warmup=1)

        out = {
            "pass_ms": t(lambda: cf.conv_draw_prologue(dy, raw, scal, act)),
            "pass_plain_ms": t(lambda: cf.conv_draw_prologue_ref(dy, raw, scal, act), 2),
            "eager_draw_ms": t(eager_draw),
            "eager_stage1_ms": t(lambda: cf._stage1(dy, raw, scal, act)),
            "dgrad_branch_ms": t(lambda: cf.conv_dgrad(cf.conv_draw_prologue(dy, raw, scal, act), wf, dt)),
            "dgrad_ms": t(lambda: cf.conv_dgrad(d_raw, wf, dt)),
            "dgrad_branch_plain_ms": t(
                lambda: cf.conv_dgrad_ref(cf.conv_draw_prologue_ref(dy, raw, scal, act), wf, dt), 2),
            "dgrad_library_route_ms": t(lambda: library((True, False, False))),
            "wgrad_branch_ms": t(lambda: cf.conv_wgrad(
                x_in, cf.conv_draw_prologue(dy, raw, scal, act), scal_lhs, kt, kf, dt, act_prev, lhs)),
            "wgrad_ms": t(lambda: cf.conv_wgrad(x_in, d_raw, scal_lhs, kt, kf, dt, act_prev, lhs)),
            "wgrad_branch_plain_ms": t(lambda: cf.conv_wgrad_ref(
                x_in, cf.conv_draw_prologue_ref(dy, raw, scal, act), scal_lhs, kt, kf, dt, act_prev, lhs), 2),
            "wgrad_library_route_ms": t(lambda: library((False, True, False))),
        }
    out["pass_bound"] = draw_bound(shape, "bfloat16", act)
    out["dgrad_branch_bound"] = branch_bound("conv_dgrad", shape, kt, kf, dt, act)
    out["wgrad_branch_bound"] = branch_bound("conv_wgrad", shape, kt, kf, dt, act)
    return out


def phase_prologue(torch, cf, seed: int) -> dict:
    """The chain's BatchNorm-backward prologue branches on the card: the d_raw
    pass and both branches against their plain versions and the chain's
    eager route at every layer and shape of PROLOGUE_*, then their times;
    the launches of the phase (all from the ops entries: no path takes the
    branches)."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed + 22)
    bf16_cases = [(b, layer, 64, "mish") for b, layer in _timed_conv_layers()]
    bf16_cases += [(2, layer, PROLOGUE_CHANNELS, "mish") for layer in PROLOGUE_WIDE_LAYERS]
    bf16_cases += [(2, "5x5-d1", 64, "relu")]
    groups: dict = {}
    for b, layer, C, act in bf16_cases:
        groups.setdefault(((b, *CONV_SHAPE[1:-1], C), "bfloat16", act), []).append(layer)
    groups[(CONV_SHAPE_FP32, "float32", "relu")] = list(PROLOGUE_FP32_LAYERS)
    _reset_counts(torch, cf)
    agreement, timing = {}, {}
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for (shape, dtype_name, act), layers in groups.items():
        dtype = getattr(torch, dtype_name)
        inp = _prologue_inputs(torch, cf, shape, dtype, act, g)
        for layer in layers:
            (kt, kf), dt = ALL_CONV_LAYERS[layer]
            C = shape[-1]
            w = (torch.randn(kt, kf, C, C, device="cuda", generator=g) * (kt * kf * C) ** -0.5).to(dtype)
            lhs = layer != "7x1"  # the chain's first layer has no input prologue
            case = f"B{shape[0]}/{layer}/C{C}/{act}/{dtype_name}"
            agreement[case] = _check_prologue_case(torch, cf, case, inp, w, dt, act, lhs, dtype_name)
            worst[dtype_name] = max(worst[dtype_name], agreement[case]["conv_draw_prologue"]["abs_err"])
            if dtype_name == "bfloat16":
                timing[case] = _prologue_times(torch, cf, inp, w, dt, act, lhs, 5 if shape[0] == 2 else 3)
            del w
        del inp
        torch.cuda.empty_cache()
    launches = _counts(torch, cf)
    check(launches["conv_draw_prologue"] > 0, "the d_raw pass was not launched")
    bf16_cases = [a["vs_eager_route"] for c, a in agreement.items() if c.endswith("bfloat16")]
    worst_vs_eager = {k: max(a[k]["peak_rel"] for a in bf16_cases) for k in ("d_raw", "dx", "dbias", "dw")}
    worst_vs_eager["dbias_rel_to_abs_sum"] = max(a["dbias"]["rel_to_abs_sum"] for a in bf16_cases)
    min_cos_vs_eager = {k: min(a[k]["cosine"] for a in bf16_cases) for k in ("d_raw", "dx", "dbias", "dw")}
    emit("prologue", tolerances_peak_rel=CONV_TOL, agreement=agreement,
         vs_eager_route_tolerances=PROLOGUE_VS_EAGER_TOL,
         vs_eager_route_worst_peak_rel=worst_vs_eager, vs_eager_route_min_cosine=min_cos_vs_eager,
         times=timing, launches=launches, seconds=time.perf_counter() - t0)
    tol = PROLOGUE_VS_EAGER_TOL
    for k in ("d_raw", "dx", "dw"):
        check(min_cos_vs_eager[k] >= tol[f"{k}_cosine_min"] and worst_vs_eager[k] <= tol[k],
              f"prologue branches vs the eager route: {k} {worst_vs_eager[k]}, cosine {min_cos_vs_eager[k]}")
    check(worst_vs_eager["dbias_rel_to_abs_sum"] <= tol["dbias_rel_to_abs_sum"],
          f"prologue branches vs the eager route: dbias {worst_vs_eager['dbias_rel_to_abs_sum']}")
    head = "B2/5x5-d1/C64/mish/bfloat16"
    r = timing[head]
    return {"conv_draw_prologue": {
        "bf16": {"max_abs_err": worst["bfloat16"], "ms": r["pass_ms"], "plain_ms": r["pass_plain_ms"]},
        "fp32": {"max_abs_err": worst["float32"]},
        "library_ms": None,  # no one PyTorch call draws d_raw
        "bound_ms": r["pass_bound"]["bound_ms"], "bound_by": r["pass_bound"]["bound_by"],
        "timed_at": head, "eager_draw_ms": r["eager_draw_ms"],
        "ms_by_batch_and_layer": {k: v["pass_ms"] for k, v in timing.items()},
        "launches_by_ops_entry": launches["conv_draw_prologue"],
    }}


def _chain_state(model, last: int = 7) -> tuple:
    """Gradients of conv2 … conv<last> (weights, BatchNorm scale and bias)
    and every running statistic after a step."""
    grads = {k: p.grad.detach().float().clone() for k, p in model.named_parameters()
             if k.split(".")[0] in {f"conv{i}" for i in range(2, last + 1)}
             and not k.endswith("conv.bias")}
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return grads, stats


def _compare_steps(torch, m_a, st_a, m_b, st_b) -> dict:
    """Step a against step b: loss, grad_norm, gradients (peak-relative and
    cosine) and running statistics."""
    (ga, ra), (gb, rb) = st_a, st_b
    return {
        "loss_rel": abs(float(m_a["loss"]) - float(m_b["loss"])) / abs(float(m_b["loss"])),
        "grad_norm_rel": abs(float(m_a["grad_norm"]) - float(m_b["grad_norm"])) / float(m_b["grad_norm"]),
        "grad_peak_rel": {k: _peak_rel(ga[k], gb[k]) for k in gb},
        "grad_cosine": {k: torch.nn.functional.cosine_similarity(
            ga[k].flatten(), gb[k].flatten(), dim=0).item() for k in gb},
        "running_stat_abs": max((ra[k] - rb[k]).abs().max().item() for k in rb),
    }


def _check_step_agreement(what: str, cmp: dict, tol: dict) -> None:
    for k, limit in tol.items():
        if k == "grad_cosine_min":
            cos = cmp["grad_cosine"]
            v = min(cos.values())
            check(v >= limit, f"{what}: gradient cosine {v} < {limit} ({min(cos, key=cos.get)})")
            continue
        v = cmp[k]
        where = f" ({max(v, key=v.get)})" if isinstance(v, dict) else ""
        v = max(v.values()) if isinstance(v, dict) else v
        check(np.isfinite(v) and v <= limit, f"{what}: {k} {v} > {limit}{where}")


def phase_train_fused(torch, lstm_cuda, cf, seed: int, profile_dir) -> dict:
    """The train phase with the fused conv chain on: same model, config,
    batches and learning rate."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    config.train_config.learning_rate = TRAIN_LR
    ap = make_audio_processor(config)
    n = int(config.audio.audio_len * ap.sample_rate)
    report = {"config": "configs/voicesplit.json", "switch": "VOICESPLIT_FUSED_CHAIN=1",
              "compute_dtype": config.train_config.compute_dtype, "learning_rate": TRAIN_LR,
              "tolerances_vs_plain": FUSED_TOL, "tolerances_vs_eager": FUSED_VS_EAGER_TOL}
    launches = {k: 0 for k in (*lstm_cuda.LAUNCHES, *cf.LAUNCHES)}
    previous = os.environ.get("VOICESPLIT_FUSED_CHAIN")
    os.environ["VOICESPLIT_FUSED_CHAIN"] = "1"
    try:
        for b in (2, 8):
            model = weights.init_random_(make_masknet(config), seed)
            optimizer = make_optimizer(config, model)
            state = create_train_state(model, optimizer)
            step = make_train_step(config, model, ap, optimizer)
            batch = train_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim)
            before = _snapshot(model, optimizer, state)

            # the counted run: one step from fresh weights through the chain
            torch.cuda.synchronize()
            lstm_cuda.reset_launch_counts()
            cf.reset_launch_counts()
            mk = step(state, batch)
            torch.cuda.synchronize()
            counted = {**lstm_cuda.LAUNCHES, **cf.LAUNCHES}
            for k, v in counted.items():
                launches[k] += v
            check(counted == {**TRAIN_LAUNCHES[b], **CONV_LAUNCHES}, f"B={b}: launches per step {counted}")
            loss0, gn0 = float(mk["loss"]), float(mk["grad_norm"])
            check(np.isfinite(loss0) and not bool(mk["loss_exploded"]), f"B={b}: loss {loss0}")
            check(gn0 > 0 and np.isfinite(gn0), f"B={b}: grad_norm {gn0}")
            unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[0][k])]
            check(not unmoved, f"B={b}: unchanged after a step: {unmoved}")
            through_kernels = _chain_state(model)

            # the same step through the kernels once more.  The chain's kernels
            # give the same bits twice (checked in the conv kernels phase);
            # whether the whole step does also depends on PyTorch's own
            # backward kernels, so this is reported, not required
            _restore(model, optimizer, state, before)
            mr = step(state, batch)
            again = _chain_state(model)
            same_bits = float(mr["loss"]) == loss0 and all(
                torch.equal(through_kernels[0][k], again[0][k]) for k in again[0])
            del again

            # (a) the same step through the conv kernels' plain versions
            _restore(model, optimizer, state, before)
            with _PlainVersions(cf):
                mp = step(state, batch)
            vs_plain = _compare_steps(torch, mk, through_kernels, mp, _chain_state(model))
            _check_step_agreement(f"B={b}: kernels vs plain", vs_plain, FUSED_TOL)

            # (b) the same step with the chain off (the eager BatchNorm path)
            _restore(model, optimizer, state, before)
            os.environ["VOICESPLIT_FUSED_CHAIN"] = "0"
            cf.reset_launch_counts()
            me = step(state, batch)
            os.environ["VOICESPLIT_FUSED_CHAIN"] = "1"
            check(not any(cf.LAUNCHES.values()), f"B={b}: conv kernels ran with the chain off")
            vs_eager = _compare_steps(torch, mk, through_kernels, me, _chain_state(model))
            _check_step_agreement(f"B={b}: chain vs eager", vs_eager, FUSED_VS_EAGER_TOL)
            _restore(model, optimizer, state, before)
            del through_kernels

            for _ in range(TRAIN_WARM):
                step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, metrics = [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                metrics.append(step(state, batch))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            losses = [float(m["loss"]) for m in metrics]
            check(all(np.isfinite(losses)), f"B={b}: non-finite loss in {losses}")
            check(losses[-1] < losses[0], f"B={b}: loss did not fall on a fixed batch: {losses}")
            p50, p75 = (float(np.percentile(times, q)) for q in (50, 75))
            report[f"B{b}"] = {
                "launches_per_step": counted, "first_loss": loss0, "first_grad_norm": gn0,
                "eager_first_loss": float(me["loss"]), "same_bits_twice": same_bits,
                "kernels_vs_plain": vs_plain,
                "chain_vs_eager": vs_eager, "steps": TRAIN_STEPS,
                "step_ms_p50": p50, "step_ms_p75": p75,
                "audio_s_per_s": b * config.audio.audio_len / (p50 / 1e3),
                "losses": losses, "grad_norms": [float(m["grad_norm"]) for m in metrics],
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            }
            if profile_dir:
                report[f"B{b}"]["profile"] = profile(
                    torch, profile_dir, f"train_fused_B{b}", lambda: step(state, batch)
                )
            del model, optimizer, state, step
            torch.cuda.empty_cache()
    finally:
        if previous is None:
            del os.environ["VOICESPLIT_FUSED_CHAIN"]
        else:
            os.environ["VOICESPLIT_FUSED_CHAIN"] = previous
    emit("train fused", device=torch.cuda.get_device_name(0), **report)
    return launches


class _Env:
    """Sets an environment variable while active and restores it after."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.previous = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.previous is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.previous


def _latency_ms(torch, fn, calls: int):
    """p50 and p75 of `calls` synchronized calls on the host clock."""
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return tuple(float(np.percentile(lat, q)) for q in (50, 75))


def _check_dilated_case(torch, cc, case, shape, layer, dtype_name, g, cout: int = None) -> dict:
    """One layer (`shape` in, `cout` channels out, by default as many)
    through `conv_dilated_fwd` (as forward and as data gradient) and
    `conv_dilated_wgrad` and their plain versions; raises on disagreement or
    on two launches that differ."""
    (kt, kf), dt = ALL_CONV_LAYERS[layer]
    dtype = getattr(torch, dtype_name)
    tol = DILATED_TOL[dtype_name]
    x, d, w, _, _ = _conv_inputs(torch, shape, kt, kf, dtype, g, cout)
    wf = cc.flip_weight(w)
    report = {}
    with torch.inference_mode():
        for what, (a, wt) in {"forward": (x, w), "data_gradient": (d, wf)}.items():
            got, again = cc.conv_dilated_fwd(a, wt, dt), cc.conv_dilated_fwd(a, wt, dt)
            want = cc.conv_dilated_fwd_ref(a, wt, dt)
            once = cc.conv_dilated_fwd_round_once_ref(a, wt, dt)
            torch.cuda.synchronize()
            errs = {"out": _peak_rel(got, want), "out_round_once": _peak_rel(got, once),
                    **{f"out_{k}": v for k, v in _edge_errs(got, want).items()}}
            for k, v in errs.items():
                limit = tol["out_round_once" if k == "out_round_once" else "out"]
                check(np.isfinite(v) and v <= limit,
                      f"conv_dilated_fwd {what} {case}: {k} error {v} > {limit}")
            check(torch.equal(got, again),
                  f"conv_dilated_fwd {what} {case}: two launches on the same inputs differ")
            report[what] = {
                "errors": errs, "abs_err": (got.float() - want.float()).abs().max().item(),
                "share_of_elements_that_differ": (got != want).float().mean().item(),
                "plain_vs_round_once": _peak_rel(want, once)}
            del got, again, want, once
        got, again = cc.conv_dilated_wgrad(x, d, kt, kf, dt), cc.conv_dilated_wgrad(x, d, kt, kf, dt)
        want = cc.conv_dilated_wgrad_ref(x, d, kt, kf, dt)
        torch.cuda.synchronize()
        err = _peak_rel(got, want)
        check(np.isfinite(err) and err <= tol["dw"],
              f"conv_dilated_wgrad {case}: dw error {err} > {tol['dw']}")
        check(torch.equal(got, again),
              f"conv_dilated_wgrad {case}: two launches on the same inputs differ")
        report["weight_gradient"] = {"errors": {"dw": err},
                                     "abs_err": (got - want).abs().max().item()}
    return report


# the eval-mode block's BatchNorm epsilon and the serving batches it is checked and timed at
EVAL_EPS, EVAL_BATCHES, EVAL_ACTS = 1e-5, (1, 8), ("mish", "relu")


def _eval_inputs(torch, shape, kt, kf, dtype, g):
    """One layer's operands for `conv_bn_act_eval`: x, w and the fp32
    ``(bias, scale, beta, mean, var)`` vectors."""
    x, _, w, bias, (mean, var, scale, beta) = _conv_inputs(torch, shape, kt, kf, dtype, g)
    return x, w, (bias, scale, beta, mean, var)


def _check_eval_case(torch, cc, case, shape, layer, act, dtype_name, g) -> dict:
    """`conv_bn_act_eval` against `conv_bn_act_eval_round_once_ref` on one
    layer (edges on their own too) and two launches with the same bits;
    raises on disagreement."""
    (kt, kf), dt = ALL_CONV_LAYERS[layer]
    x, w, vecs = _eval_inputs(torch, shape, kt, kf, getattr(torch, dtype_name), g)
    limit = DILATED_TOL[dtype_name]["out_round_once"]
    with torch.inference_mode():
        got = cc.conv_bn_act_eval(x, w, *vecs, act, EVAL_EPS, dt)
        again = cc.conv_bn_act_eval(x, w, *vecs, act, EVAL_EPS, dt)
        want = cc.conv_bn_act_eval_round_once_ref(x, w, *vecs, EVAL_EPS, act, dt)
    torch.cuda.synchronize()
    errs = {"out_round_once": _peak_rel(got, want),
            **{f"out_round_once_{k}": v for k, v in _edge_errs(got, want).items()}}
    for k, v in errs.items():
        check(np.isfinite(v) and v <= limit, f"conv_bn_act_eval {case}: {k} error {v} > {limit}")
    check(torch.equal(got, again), f"conv_bn_act_eval {case}: two launches on the same inputs differ")
    return {"errors": errs, "abs_err": (got.float() - want.float()).abs().max().item(),
            "share_of_elements_that_differ": (got != want).float().mean().item()}


def _eval_times(torch, cc, x, w, vecs, dt: int, act: str, iters: int) -> dict:
    """`conv_bn_act_eval` on one layer's bf16 operands: time, its plain
    version's, the port's eager block it replaces in eval mode
    (`conv_dilated_fwd`, the bias add and `bn_act_eval`, as the model ran it
    before), the plain kernel alone, a library yardstick the port never
    calls (cuDNN ``conv2d`` with the bias, then `bn_act_eval`), and the
    bound."""
    import torch.nn.functional as F

    from voicesplit_tpu_torch.ops import bn_act

    kt, kf, _, cout = w.shape
    bias, scale, beta, mean, var = vecs
    pad = ((kt - 1) * dt // 2, (kf - 1) // 2)
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def eager_block():
        y = cc.conv2d_dilated_bias(x, w, bias, (dt, 1))
        return bn_act.bn_act_eval(y.permute(0, 3, 1, 2), scale, beta, mean, var, act, EVAL_EPS)

    def library():
        y = F.conv2d(x_nchw, w_oihw, bias.to(x.dtype), padding=pad, dilation=(dt, 1))
        return bn_act.bn_act_eval(y, scale, beta, mean, var, act, EVAL_EPS)

    with torch.inference_mode():
        return {
            "ms": time_ms(torch, lambda: cc.conv_bn_act_eval(x, w, *vecs, act, EVAL_EPS, dt), iters, warmup=1),
            "plain_ms": time_ms(torch, lambda: cc.conv_bn_act_eval_ref(x, w, *vecs, EVAL_EPS, act, dt),
                                2, warmup=1),
            "eager_block_ms": time_ms(torch, eager_block, iters, warmup=1),
            "conv_dilated_fwd_ms": time_ms(torch, lambda: cc.conv_dilated_fwd(x, w, dt), iters, warmup=1),
            "library_ms": time_ms(torch, library, iters, warmup=1),
            **conv_bound("conv_bn_act_eval", tuple(x.shape), kt, kf, dt, "bfloat16", cout),
        }


def phase_dilated_kernels(torch, cc, cf, seed: int) -> dict:
    """The dilated conv kernels and the eval-mode block vs their plain
    versions on the card, then their times per layer kind and batch beside
    the bound, the plain version, a library yardstick the port never calls
    and the fused chain's kernels for the same layer (the eval block: the
    eager block it replaces)."""
    g = torch.Generator(device="cpu").manual_seed(seed + 3)
    worst = {name: {"bfloat16": 0.0, "float32": 0.0} for name in DILATED_TRAIN_LAUNCHES}
    agreement = {}
    for dtype_name, shape in (("bfloat16", CONV_SHAPE), ("float32", CONV_SHAPE_FP32)):
        for layer in ALL_CONV_LAYERS:
            case = f"{layer}/{dtype_name}"
            r = agreement[case] = _check_dilated_case(torch, cc, case, shape, layer, dtype_name, g)
            worst["conv_dilated_fwd"][dtype_name] = max(
                worst["conv_dilated_fwd"][dtype_name], r["forward"]["abs_err"],
                r["data_gradient"]["abs_err"])
            worst["conv_dilated_wgrad"][dtype_name] = max(
                worst["conv_dilated_wgrad"][dtype_name], r["weight_gradient"]["abs_err"])
        torch.cuda.empty_cache()
    worst["conv_bn_act_eval"] = {"bfloat16": 0.0, "float32": 0.0}
    eval_cases = [(f"B{b}", "bfloat16", (b, *CONV_SHAPE[1:])) for b in EVAL_BATCHES]
    eval_cases.append(("reduced", "float32", CONV_SHAPE_FP32))
    for tag, dtype_name, shape in eval_cases:
        for layer in ALL_CONV_LAYERS:
            for act in EVAL_ACTS:
                case = f"conv_bn_act_eval/{tag}/{layer}/{act}/{dtype_name}"
                r = agreement[case] = _check_eval_case(torch, cc, case, shape, layer, act, dtype_name, g)
                worst["conv_bn_act_eval"][dtype_name] = max(worst["conv_bn_act_eval"][dtype_name], r["abs_err"])
        torch.cuda.empty_cache()
    emit("dilated conv kernels", shape_bf16=list(CONV_SHAPE), shape_fp32=list(CONV_SHAPE_FP32),
         eval_batches=list(EVAL_BATCHES), tolerances_peak_rel=DILATED_TOL, agreement=agreement)

    timing = {name: {} for name in DILATED_TRAIN_LAUNCHES}
    for b, layer in _timed_conv_layers():
        (kt, kf), dt = ALL_CONV_LAYERS[layer]
        x, d, w, _, _ = _conv_inputs(torch, (b, *CONV_SHAPE[1:]), kt, kf, torch.bfloat16, g)
        fwd, wgrad = _dilated_times(torch, cc, cf, x, d, w, dt, iters=5 if b == 2 else 3)
        timing["conv_dilated_fwd"][f"B{b}/{layer}"] = fwd
        timing["conv_dilated_wgrad"][f"B{b}/{layer}"] = wgrad
        del x, d, w
        torch.cuda.empty_cache()
    emit("dilated conv kernel times", dtype="bfloat16",
         library="cuDNN conv2d / aten.convolution_backward, channels-last bf16", times=timing,
         conv_dilated_fwd_ms_per_serving_call=_per_step(timing["conv_dilated_fwd"]),
         conv_dilated_fwd_data_gradient_ms_per_step=_per_step(timing["conv_dilated_fwd"], "data_gradient_ms"),
         conv_dilated_wgrad_ms_per_step=_per_step(timing["conv_dilated_wgrad"]))

    # the eval-mode block at the serving batches, conv2 … conv7's layer kinds
    timing["conv_bn_act_eval"] = {}
    for b in EVAL_BATCHES:
        for layer in CONV_LAYERS:
            (kt, kf), dt = CONV_LAYERS[layer]
            x, w, vecs = _eval_inputs(torch, (b, *CONV_SHAPE[1:]), kt, kf, torch.bfloat16, g)
            for act in EVAL_ACTS:
                timing["conv_bn_act_eval"][f"B{b}/{layer}/{act}"] = _eval_times(
                    torch, cc, x, w, vecs, dt, act, iters=5)
            del x, w, vecs
            torch.cuda.empty_cache()
    per_call = {f"B{b}/{act}": {k: sum(timing["conv_bn_act_eval"][f"B{b}/{layer}/{act}"][k] for layer in CONV_LAYERS)
                                for k in ("ms", "eager_block_ms", "conv_dilated_fwd_ms", "library_ms", "bound_ms")}
                for b in EVAL_BATCHES for act in EVAL_ACTS}
    emit("eval conv block times", dtype="bfloat16",
         library="cuDNN conv2d with the bias, then bn_act_eval, channels-last bf16",
         times=timing["conv_bn_act_eval"], conv_bn_act_eval_ms_per_serving_call=per_call)
    heads = {name: "B2/5x5-d1" for name in DILATED_TRAIN_LAUNCHES}
    heads["conv_bn_act_eval"] = "B8/5x5-d1/mish"  # the B=8 serving cell's block
    return {
        name: {"bf16": {"max_abs_err": worst[name]["bfloat16"], **timing[name][head]},
               "fp32": {"max_abs_err": worst[name]["float32"]},
               "library_ms": timing[name][head]["library_ms"],
               "bound_ms": timing[name][head]["bound_ms"], "bound_by": timing[name][head]["bound_by"],
               "timed_at": head, "ms_by_batch_and_layer": {k: v["ms"] for k, v in timing[name].items()}}
        for name, head in heads.items()
    }


def phase_separate_dilated(torch, lstm_cuda, cc, seed: int, profile_dir) -> dict:
    """The separate phase's model and mixtures with `VOICESPLIT_PALLAS_CONV=1`:
    conv2 … conv7 as eval-mode blocks through `conv_bn_act_eval`, held at each batch size
    against the same call through the plain versions and against the
    switch-off run."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), seed)
    n = int(config.audio.audio_len * ap.sample_rate)
    lstm_per_call = {1: {"lstm_fwd": 2, "bilstm_fwd": 0}, 8: {"lstm_fwd": 0, "bilstm_fwd": 1}}
    launches = {k: 0 for k in (*lstm_cuda.LAUNCHES, *cc.LAUNCHES)}
    report = {"switch": "VOICESPLIT_PALLAS_CONV=1", "tolerance": SEPARATE_DILATED_TOL}
    for b in (1, 8):
        mixed, emb = (torch.as_tensor(a, device="cuda")
                      for a in synthetic_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim))
        with _Env("VOICESPLIT_PALLAS_CONV", "1"):
            # the counted run of this path: one serving call
            torch.cuda.synchronize()
            lstm_cuda.reset_launch_counts()
            cc.reset_launch_counts()
            out = separate_batch(model, ap, mixed, emb)
            torch.cuda.synchronize()
            counted = {**lstm_cuda.LAUNCHES, **cc.LAUNCHES}
            want = {**{k: 0 for k in lstm_cuda.LAUNCHES}, **lstm_per_call[b], **DILATED_SERVE_LAUNCHES}
            check(counted == want, f"B={b}: launches per call {counted}, expected {want}")
            for k, v in counted.items():
                launches[k] += v
            with torch.inference_mode():
                spec, _ = ap.wav2spec_batch(mixed)
                mask = model(spec, emb)
                cc.reset_launch_counts()
                with _PlainVersions(cc):
                    mask_plain = model(spec, emb)
                    out_plain = separate_batch(model, ap, mixed, emb)
            torch.cuda.synchronize()
            check(not any(cc.LAUNCHES.values()), f"B={b}: the plain run launched a dilated kernel")
            p50, p75 = _latency_ms(torch, lambda: separate_batch(model, ap, mixed, emb), LATENCY_CALLS)
            prof = profile(torch, profile_dir, f"separate_dilated_B{b}",
                           lambda: separate_batch(model, ap, mixed, emb)) if profile_dir else None
        cc.reset_launch_counts()
        out_off = separate_batch(model, ap, mixed, emb)
        with torch.inference_mode():
            mask_off = model(spec, emb)
        torch.cuda.synchronize()
        check(not any(cc.LAUNCHES.values()), f"B={b}: dilated kernels ran with the switch off")
        off50, off75 = _latency_ms(torch, lambda: separate_batch(model, ap, mixed, emb), LATENCY_CALLS)
        check(tuple(out.shape) == (b, n) and bool(torch.isfinite(out).all()), f"B={b}: output")
        check(float(mask.min()) >= 0.0 and float(mask.max()) <= 1.0, f"B={b}: mask outside [0, 1]")
        mask_err = (mask - mask_off).abs().max().item()
        wav_err = ((out - out_off).abs().max() / out_off.abs().max()).item()
        mask_err_plain = (mask - mask_plain).abs().max().item()
        wav_err_plain = ((out - out_plain).abs().max() / out_plain.abs().max()).item()
        check(mask_err_plain <= SEPARATE_DILATED_TOL, f"B={b}: mask vs plain conv {mask_err_plain}")
        check(wav_err_plain <= SEPARATE_DILATED_TOL, f"B={b}: waveform vs plain conv {wav_err_plain}")
        check(mask_err <= SEPARATE_DILATED_TOL, f"B={b}: mask vs switch off {mask_err}")
        check(wav_err <= SEPARATE_DILATED_TOL, f"B={b}: waveform vs switch off {wav_err}")
        report[f"B{b}"] = {
            "launches_per_call": counted, "mask_err_vs_plain": mask_err_plain,
            "wave_rel_err_vs_plain": wav_err_plain, "mask_err_vs_switch_off": mask_err,
            "wave_rel_err_vs_switch_off": wav_err, "calls": LATENCY_CALLS,
            "latency_ms_p50": p50, "latency_ms_p75": p75,
            "switch_off_latency_ms_p50": off50, "switch_off_latency_ms_p75": off75,
            "audio_s_per_s": b * config.audio.audio_len / (p50 / 1e3),
        }
        if prof:
            report[f"B{b}"]["profile"] = prof
    emit("separate dilated", device=torch.cuda.get_device_name(0), **report)
    return launches


def _trainer_config(tmp: Path, seed: int, name: str = "voicesplit.json",
                    n_train: int = TRAINER_TRAIN_ITEMS, n_eval: int = TRAINER_EVAL_ITEMS,
                    ckpt_every: int = TRAINER_CKPT_EVERY):
    """`configs/<name>` at full width over a synthetic dataset on disk
    (`n_train` and `n_eval` 3 s clips, checkpoints every `ckpt_every`
    steps); returns the config's path and the config."""
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset

    config = load_config(str(ROOT / "configs" / name))
    config.dataset.train_dir, config.dataset.test_dir = str(tmp / "train"), str(tmp / "test")
    tc = config.train_config
    tc.learning_rate, tc.seed = TRAIN_LR, seed
    tc.summary_interval = tc.check_interval = 1  # every step waits for the card: host-clock
    tc.checkpoint_interval = ckpt_every  # step times, and the guard on every step
    sr = config.audio.active.sample_rate
    for split, n_items, s in (("train", n_train, seed), ("test", n_eval, seed + 1)):
        made = build_synthetic_dataset(
            str(tmp / split), n_items, sample_rate=sr, audio_len=config.audio.audio_len,
            emb_dim=config.model.emb_dim, fmt=config.dataset.format, seed=s)
        check(len(made) == n_items, f"{split}: {len(made)} of {n_items} synthetic items written")
    path = tmp / "config.json"
    path.write_text(config.to_json())
    return str(path), config


def _read_metrics(log_dir: Path) -> list:
    return [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]


def phase_trainer(torch, lstm_cuda, cc, seed: int, profile_dir) -> dict:
    """`cli.train.main` at full width with `VOICESPLIT_PALLAS_CONV=1` over a
    synthetic dataset on disk: one step held against the plain versions and
    the switch-off step, an uninterrupted run across checkpoints and
    validations, and a run resumed from the middle checkpoint."""
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.cli.train import main as train_main
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train.checkpoint import (
        list_checkpoints, load_checkpoint, load_model_variables)
    from voicesplit_tpu_torch.train.trainer import Trainer

    step_launches = {**{k: 0 for k in (*lstm_cuda.LAUNCHES, *cc.LAUNCHES)}, "lstm_fwd": 2, "lstm_bwd": 2,
                     **DILATED_TRAIN_LAUNCHES}
    report = {"config": "configs/voicesplit.json", "switch": "VOICESPLIT_PALLAS_CONV=1",
              "learning_rate": TRAIN_LR, "steps": TRAINER_STEPS,
              "checkpoint_interval": TRAINER_CKPT_EVERY, "train_items": TRAINER_TRAIN_ITEMS,
              "eval_items": TRAINER_EVAL_ITEMS, "step_tolerances": DILATED_STEP_TOL,
              "resume_tolerance_abs": TRAINER_RESUME_TOL}
    with tempfile.TemporaryDirectory(prefix="voicesplit_smoke_") as tmp_name, \
            _Env("VOICESPLIT_PALLAS_CONV", "1"):
        tmp = Path(tmp_name)
        t0 = time.perf_counter()
        config_path, config = _trainer_config(tmp, seed)
        report["dataset_seconds"] = time.perf_counter() - t0
        b = config.train_config.batch_size

        # (1) one step of the trainer's own model, optimizer and first batch
        probe = Trainer(config, log_dir=str(tmp / "probe"), enable_tb=False)
        model, state, step = probe.model, probe.state, probe.train_step
        batch = next(probe.train_loader)
        before = _snapshot(model, state.optimizer, state)
        torch.cuda.synchronize()
        lstm_cuda.reset_launch_counts()
        cc.reset_launch_counts()
        mk = step(state, batch)
        torch.cuda.synchronize()
        counted = {**lstm_cuda.LAUNCHES, **cc.LAUNCHES}
        check(counted == step_launches, f"launches per step {counted}, expected {step_launches}")
        loss0, gn0 = float(mk["loss"]), float(mk["grad_norm"])
        check(np.isfinite(loss0) and not bool(mk["loss_exploded"]), f"loss {loss0}")
        check(gn0 > 0 and np.isfinite(gn0), f"grad_norm {gn0}")
        through_kernels = _chain_state(model)
        _restore(model, state.optimizer, state, before)
        with _PlainVersions(cc):
            mp = step(state, batch)
        vs_plain = _compare_steps(torch, mk, through_kernels, mp, _chain_state(model))
        _check_step_agreement("trainer step: kernels vs plain", vs_plain, DILATED_STEP_TOL)
        _restore(model, state.optimizer, state, before)
        with _Env("VOICESPLIT_PALLAS_CONV", "0"):
            cc.reset_launch_counts()
            mo = step(state, batch)
            check(not any(cc.LAUNCHES.values()), "dilated kernels ran with the switch off")
        vs_off = _compare_steps(torch, mk, through_kernels, mo, _chain_state(model))
        _check_step_agreement("trainer step: switch on vs off", vs_off, DILATED_STEP_TOL)
        report["first_step"] = {"launches_per_step": counted, "loss": loss0, "grad_norm": gn0,
                                "switch_off_loss": float(mo["loss"]),
                                "kernels_vs_plain": vs_plain, "switch_on_vs_off": vs_off}
        if profile_dir:
            report["first_step"]["profile"] = profile(
                torch, profile_dir, f"train_dilated_B{b}", lambda: step(state, batch))
        probe.close()
        del probe, model, state, step, through_kernels, before
        torch.cuda.empty_cache()

        # (2) the counted run of this slice's main path: the training CLI
        run_a, run_b = tmp / "run_a", tmp / "run_b"
        torch.cuda.synchronize()
        lstm_cuda.reset_launch_counts()
        cc.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        result = train_main(["-c", config_path, "--logs_path", str(run_a),
                             "--max_steps", str(TRAINER_STEPS), "--eval_sdr"])
        torch.cuda.synchronize()
        launches = {**lstm_cuda.LAUNCHES, **cc.LAUNCHES}
        peak_memory = torch.cuda.max_memory_allocated()
        check(result.get("step") == TRAINER_STEPS and not result.get("exploded"), f"run: {result}")
        # validations: at step 0 and at every checkpoint interval, one item per call
        n_evals = 1 + TRAINER_STEPS // TRAINER_CKPT_EVERY
        want = {k: v * TRAINER_STEPS for k, v in step_launches.items()}
        want["lstm_fwd"] += 2 * n_evals * TRAINER_EVAL_ITEMS
        want["conv_bn_act_eval"] += 6 * n_evals * TRAINER_EVAL_ITEMS
        check(launches == want, f"launches of the run {launches}, expected {want}")

        records = _read_metrics(run_a)
        train = [r for r in records if "train_loss" in r]
        evals = [r for r in records if "eval_loss" in r]
        losses = [r["train_loss"] for r in train]
        check(len(train) == TRAINER_STEPS and all(np.isfinite(losses)), f"train losses {losses}")
        check(len(evals) == n_evals, f"{len(evals)} validations, expected {n_evals}")
        # every step sees another batch, so the loss that must fall is the
        # validation set's
        eval_losses = [r["eval_loss"] for r in evals]
        check(eval_losses[-1] < eval_losses[0], f"validation loss did not fall: {eval_losses}")
        for r in evals:
            vals = {k: r[k] for k in ("eval_loss", "eval_si_snr", "eval_sdr", "eval_si_snri")}
            check(all(np.isfinite(v) for v in vals.values()), f"validation at {r['step']}: {vals}")
        ckpts = [Path(p).name for p in list_checkpoints(str(run_a))]
        steps_saved = sorted({*range(TRAINER_CKPT_EVERY, TRAINER_STEPS + 1, TRAINER_CKPT_EVERY),
                              TRAINER_STEPS})
        check(ckpts == [f"checkpoint_{k}.pt" for k in steps_saved], f"checkpoints {ckpts}")
        check((run_a / "config.json").exists(), "no config copy beside the checkpoints")
        final_a = load_checkpoint(str(run_a / f"checkpoint_{TRAINER_STEPS}.pt"))
        check(final_a["step"] == TRAINER_STEPS and set(final_a) == {
            "model", "batch_stats", "optimizer", "step", "config_str", "data_state"},
            f"checkpoint payload {sorted(final_a)}")
        # the checkpoint serves: weights into a fresh model, one clip separated
        served = make_masknet(config)
        served.load_state_dict(load_model_variables(
            config, str(run_a / f"checkpoint_{TRAINER_STEPS}.pt")))
        n = int(config.audio.audio_len * config.audio.active.sample_rate)
        wav, emb = synthetic_batch(seed, 1, n, config.audio.active.sample_rate, config.model.emb_dim)
        out = separate_batch(served, make_audio_processor(config), wav, emb)
        check(tuple(out.shape) == (1, n) and bool(torch.isfinite(out).all()),
              "the final checkpoint does not serve")
        del served, out

        deltas = np.diff([r["time"] for r in train]) * 1e3  # step to step, host clock
        p50, p75 = (float(np.percentile(deltas, q)) for q in (50, 75))
        wall = result["wall_seconds"]
        in_steps = wall["train_step"] + wall["check"]
        report["run"] = {
            "launches": launches, "losses": losses,
            "validations": [{k: v for k, v in r.items() if k != "time"} for r in evals],
            "checkpoints": ckpts, "step_ms_p50": p50, "step_ms_p75": p75,
            "audio_s_per_s_at_p50": b * config.audio.audio_len / (p50 / 1e3),
            "audio_s_per_s_summaries_median": float(np.median(
                [r["audio_sec_per_sec_per_chip"] for r in train])),
            "audio_s_per_s_whole_fit": TRAINER_STEPS * b * config.audio.audio_len / wall["fit"],
            "wall_seconds": wall, "share_outside_train_steps": 1.0 - in_steps / wall["fit"],
            "max_memory_allocated_bytes": peak_memory,
        }

        # (3) a second run resumed from the middle checkpoint
        resumed = train_main(["-c", config_path, "--logs_path", str(run_b), "--max_steps",
                              str(TRAINER_STEPS), "--checkpoint_path",
                              str(run_a / f"checkpoint_{TRAINER_RESUME_AT}.pt")])
        check(resumed.get("step") == TRAINER_STEPS, f"resumed run: {resumed}")
        first_b = [r for r in _read_metrics(run_b) if "train_loss" in r][0]
        check(first_b["step"] == TRAINER_RESUME_AT + 1, f"resumed run began at {first_b['step']}")
        final_b = load_checkpoint(str(run_b / f"checkpoint_{TRAINER_STEPS}.pt"))
        diffs = {k: (final_a[g][k] - final_b[g][k]).abs().max().item()
                 for g in ("model", "batch_stats") for k in final_a[g]}
        worst = max(diffs, key=diffs.get)
        check(diffs[worst] <= TRAINER_RESUME_TOL,
              f"resumed run differs: {worst} by {diffs[worst]} > {TRAINER_RESUME_TOL}")
        check(final_a["data_state"] == final_b["data_state"], "data-iterator states differ")
        report["resume"] = {
            "from_step": TRAINER_RESUME_AT, "max_abs_diff": diffs[worst], "worst": worst,
            "same_bits": all(torch.equal(final_a[g][k], final_b[g][k])
                             for g in ("model", "batch_stats") for k in final_a[g]),
            "same_loss_at_resumed_step": first_b["train_loss"] == losses[TRAINER_RESUME_AT],
            "data_state": final_b["data_state"],
        }
    emit("trainer", device=torch.cuda.get_device_name(0), **report)
    return launches


def _speaker_corpus(tmp: Path, seed: int) -> Path:
    """A speaker-per-directory corpus of synthetic voices from `seed`
    (`data/synthetic.py`'s signal helper), and two triplet CSVs (train and
    test, with a header); made once per temporary directory."""
    from voicesplit_tpu_torch.data.synthetic import _speaker_wav
    from voicesplit_tpu_torch.dsp.audio_io import save_wav_float

    root = tmp / "corpus"
    if root.exists():
        return root
    sr, rng = 16000, np.random.default_rng(seed)
    n = int(CORPUS_SECONDS * sr)
    for s in range(CORPUS_SPEAKERS):
        (root / f"spk{s}").mkdir(parents=True)
        for k in range(CORPUS_UTTERANCES):
            save_wav_float(_speaker_wav(rng, s, n, sr), str(root / f"spk{s}" / f"u{k}.wav"), sr)
    for name, rows in (("train.csv", PREPROCESS_TRAIN_ROWS), ("test.csv", PREPROCESS_TEST_ROWS)):
        lines = ["clean_utterance,embedding_utterance,interference_utterance"]
        for _ in range(rows):
            a, b = rng.choice(CORPUS_SPEAKERS, 2, replace=False)
            k, e = rng.choice(CORPUS_UTTERANCES, 2, replace=False)
            lines.append(f"spk{a}/u{k}.wav,spk{a}/u{e}.wav,spk{b}/u{rng.integers(CORPUS_UTTERANCES)}.wav")
        (root / name).write_text("\n".join(lines) + "\n")
    return root


def _corpus_config(tmp: Path, seed: int, train_dir: Path, test_dir: Path, name: str, **model):
    """`configs/voicesplit.json` at full width (bf16) over the given
    directories, summaries and the guard every step; returns its path and
    the config."""
    from voicesplit_tpu_torch.config import load_config

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    config.dataset.train_dir, config.dataset.test_dir = str(train_dir), str(test_dir)
    tc = config.train_config
    tc.learning_rate, tc.seed = TRAIN_LR, seed
    tc.summary_interval = tc.check_interval = 1
    for k, v in model.items():
        setattr(config.model if hasattr(config.model, k) else tc, k, v)
    path = tmp / name
    path.write_text(config.to_json())
    return str(path), config


def _preprocessed(tmp: Path, seed: int):
    """The corpus's CSVs mixed by `cli.preprocess` on the card (spectrograms
    too) under ``tmp/mixed``, each triplet with a spectral d-vector of its
    reference utterance as ``*-emb.npy``; made once.  Returns the output
    directory and the seconds of each part."""
    from voicesplit_tpu_torch.cli.preprocess import main as preprocess_main
    from voicesplit_tpu_torch.dsp.audio_io import load_wav
    from voicesplit_tpu_torch.models.speaker_encoder import spectral_dvector

    out = tmp / "mixed"
    if out.exists():
        return out, None
    corpus = _speaker_corpus(tmp, seed)
    config_path, config = _corpus_config(tmp, seed, corpus, corpus, "preprocess.json")
    t0 = time.perf_counter()
    written = preprocess_main(["-c", config_path, "-r", str(corpus), "-d", str(corpus / "train.csv"),
                               "-t", str(corpus / "test.csv"), "-o", str(out), "--save_specs",
                               "--num_workers", str(PREPROCESS_WORKERS)])
    t1 = time.perf_counter()
    check(written == {"train": PREPROCESS_TRAIN_ROWS, "test": PREPROCESS_TEST_ROWS},
          f"triplets written {written}")
    fmt, sr = config.dataset.format, config.audio.active.sample_rate
    for ref in sorted(out.glob("*/" + fmt.emb_wav)):
        emb = spectral_dvector(load_wav(str(ref), sr), sr, emb_dim=config.model.emb_dim)
        np.save(str(ref).replace(fmt.emb_wav[1:], fmt.emb[1:]), emb)
    return out, {"preprocess_cli": t1 - t0, "spectral_embeddings": time.perf_counter() - t1}


def _step_ms(log_dir: Path) -> tuple:
    """p50 and p75 of the host-clock time between consecutive summaries
    (one a step) of a training run."""
    deltas = np.diff([r["time"] for r in _read_metrics(log_dir) if "train_loss" in r]) * 1e3
    return tuple(float(np.percentile(deltas, q)) for q in (50, 75))


def phase_preprocess(torch, lstm_cuda, cc, seed: int, tmp: Path) -> dict:
    """Offline preprocessing on the card, then the training CLI over its
    output through the native loader with the dilated switch: triplets
    written, spectrograms against the host's, the native loader's batches
    against the Python iterator's, exact launches, a finite loss, every
    compiled library under ``build/``."""
    from voicesplit_tpu_torch.cli.train import main as train_main
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.data import native_loader
    from voicesplit_tpu_torch.data.dataset import BatchIterator, SeparationDataset, discover_samples
    from voicesplit_tpu_torch.dsp.audio_io import load_wav
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.ops import _build

    out, seconds = _preprocessed(tmp, seed)
    check(seconds is not None, "the preprocess phase runs first on its directory")
    n_triplets = PREPROCESS_TRAIN_ROWS + PREPROCESS_TEST_ROWS
    config = load_config(str(tmp / "preprocess.json"))
    fmt, sr = config.dataset.format, config.audio.active.sample_rate
    # spectrograms written on the card against the host's of the same wavs
    host_ap = make_audio_processor(config, device="cpu")
    spec_err = 0.0
    for saved in sorted(out.glob("*/*.npy")):
        if saved.name.endswith(fmt.emb[1:]):
            continue
        wav = load_wav(str(saved)[: -len(".npy")] + ".wav", sr)
        host, _ = host_ap.wav2spec(wav)
        spec_err = max(spec_err, float(np.abs(np.load(saved) - host).max()))
    n_specs = len([p for p in out.glob("*/*.npy") if not p.name.endswith(fmt.emb[1:])])
    check(n_specs == 2 * n_triplets, f"{n_specs} spectrograms for {n_triplets} triplets")
    check(spec_err <= SPEC_TOL, f"card spectrograms vs host: {spec_err} > {SPEC_TOL}")

    # the native loader's first batches against the Python iterator's
    ds = SeparationDataset(discover_samples(str(out / "train"), fmt), host_ap,
                           config.audio.audio_len, config.model.emb_dim)
    nat = native_loader.NativeBatchIterator(ds, 2, seed=seed, n_threads=2)
    py = BatchIterator(ds, 2, seed=seed)
    batch_err = 0.0
    for _ in range(3):
        a, b = next(nat), next(py)
        for k in ("emb", "mixed_wav", "target_wav"):
            batch_err = max(batch_err, float(np.abs(a[k] - b[k]).max()))
        check(np.array_equal(a["wav_len"], b["wav_len"]), "native loader: wav_len differs")
    nat.close()
    check(batch_err <= NATIVE_BATCH_TOL, f"native vs Python batches {batch_err}")

    # the training CLI over the preprocessed triplets
    step_launches = {**{k: 0 for k in (*lstm_cuda.LAUNCHES, *cc.LAUNCHES)}, "lstm_fwd": 2, "lstm_bwd": 2,
                     **DILATED_TRAIN_LAUNCHES}
    config_path, config = _corpus_config(tmp, seed, out / "train", out / "test", "mixed.json",
                                         checkpoint_interval=PREPROCESS_CKPT_EVERY)
    run = tmp / "run_mixed"
    with _Env("VOICESPLIT_PALLAS_CONV", "1"), _Env("VOICESPLIT_FUSED_CHAIN", "0"):
        _reset_counts(torch, lstm_cuda, cc)
        result = train_main(["-c", config_path, "--logs_path", str(run),
                             "--max_steps", str(PREPROCESS_STEPS)])
        launches = _counts(torch, lstm_cuda, cc)
    check(result["train_loader"] == "NativeBatchIterator", f"train loader {result['train_loader']}")
    check(result.get("step") == PREPROCESS_STEPS and not result.get("exploded")
          and np.isfinite(result["loss"]), f"run: {result}")
    # validations: at each epoch start and every checkpoint interval
    n_evals = (-(-PREPROCESS_STEPS // (PREPROCESS_TRAIN_ROWS // config.train_config.batch_size))
               + PREPROCESS_STEPS // PREPROCESS_CKPT_EVERY)
    want = {k: v * PREPROCESS_STEPS for k, v in step_launches.items()}
    want["lstm_fwd"] += 2 * n_evals * PREPROCESS_TEST_ROWS
    want["conv_bn_act_eval"] += 6 * n_evals * PREPROCESS_TEST_ROWS
    check(launches == want, f"launches of the run {launches}, expected {want}")
    build_dir = (ROOT / "build").resolve()
    libs = [_build.build()[0].resolve(), native_loader.library_path().resolve()]
    check(all(p.exists() and p.parent == build_dir for p in libs), f"libraries {libs}")
    p50, p75 = _step_ms(run)
    wall = result["wall_seconds"]
    emit("preprocess", device=torch.cuda.get_device_name(0), config="configs/voicesplit.json",
         switch="VOICESPLIT_PALLAS_CONV=1", corpus={
             "speakers": CORPUS_SPEAKERS, "utterances": CORPUS_UTTERANCES,
             "seconds": CORPUS_SECONDS},
         triplets={"train": PREPROCESS_TRAIN_ROWS, "test": PREPROCESS_TEST_ROWS},
         workers=PREPROCESS_WORKERS, seconds=seconds,
         preprocess_s_per_triplet=seconds["preprocess_cli"] / n_triplets,
         spec_max_abs_err_vs_host=spec_err, spec_tolerance=SPEC_TOL,
         native_vs_python_max_abs_err=batch_err, train_loader=result["train_loader"],
         libraries=[str(p.relative_to(ROOT.resolve())) for p in libs],
         steps=PREPROCESS_STEPS, launches=launches, launches_per_step=step_launches,
         final_loss=result["loss"], step_ms_p50=p50, step_ms_p75=p75, wall_seconds=wall,
         data_wait_share_of_fit=wall["data"] / wall["fit"])
    return launches


class _PoisonedLoader:
    """An iterator whose batch number `at` (0-based) carries a NaN in its
    mixed waveform; state and length are the wrapped iterator's."""

    def __init__(self, inner, at: int):
        self.inner, self.at, self.count = inner, at, 0

    def batches_per_epoch(self):
        return self.inner.batches_per_epoch()

    @property
    def state(self):
        return self.inner.state

    def load_state(self, state):
        self.inner.load_state(state)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.inner)
        if self.count == self.at:
            batch["mixed_wav"][0, 7] = np.nan
        self.count += 1
        return batch


def phase_trainer_online(torch, lstm_cuda, seed: int, profile_dir, tmp: Path) -> dict:
    """`cli.train --online --emb_mode spectral` over the corpus with dropout
    and SpecAugment: one regularized step against the plain LSTM versions
    with the same generators (the keep share and the bands recorded), a run
    across a checkpoint, a run resumed from it, and a `debug_nans` run whose
    loader poisons a batch."""
    from voicesplit_tpu_torch.cli.train import main as train_main
    from voicesplit_tpu_torch.data.online import OnlineMixIterator, discover_utterances
    from voicesplit_tpu_torch.dsp import augment
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
    from voicesplit_tpu_torch.train import steps as steps_mod
    from voicesplit_tpu_torch.train.checkpoint import load_checkpoint
    from voicesplit_tpu_torch.train.trainer import Trainer
    from voicesplit_tpu_torch.weights import init_for_training_

    out, _ = _preprocessed(tmp, seed)
    corpus = _speaker_corpus(tmp, seed)
    sa_time, sa_freq = ONLINE_SPEC_AUG
    config_path, config = _corpus_config(
        tmp, seed, corpus, out / "test", "online.json", dropout=ONLINE_DROPOUT,
        spec_aug_time=sa_time, spec_aug_freq=sa_freq, checkpoint_interval=ONLINE_CKPT_EVERY)
    step_launches = TRAIN_LAUNCHES[config.train_config.batch_size]
    active = config.audio.active

    def online():
        return OnlineMixIterator(
            discover_utterances(str(corpus)), config.train_config.batch_size,
            sample_rate=active.sample_rate, audio_len=config.audio.audio_len,
            hop_length=active.hop_length, emb_dim=config.model.emb_dim, emb_mode="spectral",
            seed=config.train_config.seed)

    report = {"config": "configs/voicesplit.json", "dropout": ONLINE_DROPOUT,
              "spec_aug": {"time": sa_time, "freq": sa_freq,
                           "n": config.train_config.spec_aug_n},
              "steps": ONLINE_STEPS, "checkpoint_interval": ONLINE_CKPT_EVERY,
              "tolerances": TRAIN_TOL, "resume_tolerance_abs": TRAINER_RESUME_TOL}
    with _route_env("unfused"):
        # (1) one regularized step, recorded, against the plain LSTM versions
        ap = make_audio_processor(config)
        model = init_for_training_(make_masknet(config), seed)
        optimizer = make_optimizer(config, model)
        state = create_train_state(model, optimizer)
        step = make_train_step(config, model, ap, optimizer)
        batch = next(online())
        kept, bands = [], []
        draw_keep = model.draw_dropout_keep

        def recording_keep(shape, keep_prob, generator):
            keep = draw_keep(shape, keep_prob, generator)
            kept.append((int(keep.sum()), keep.numel()))
            return keep

        def recording_mask(spec, generator, max_time, max_freq, n_masks):
            drawn = augment.draw_spec_bands(generator, spec.shape, max_time, max_freq, n_masks)
            bands.append(drawn)
            return augment.apply_spec_bands(spec, drawn)

        model.draw_dropout_keep = recording_keep
        steps_mod.spec_time_freq_mask, real_mask = recording_mask, steps_mod.spec_time_freq_mask
        before = _snapshot(model, optimizer, state)
        try:
            _reset_counts(torch, lstm_cuda)
            mk = step(state, batch)
            counted = _counts(torch, lstm_cuda)
            gk = _lstm_grads(model)
            after_k = {k: v.clone() for k, v in model.state_dict().items()}
            unmoved = [k for k, v in after_k.items() if torch.equal(v, before[0][k])]
            _restore(model, optimizer, state, before)
            again = step(state, batch)
            same_bits = float(again["loss"]) == float(mk["loss"]) and all(
                torch.equal(v, after_k[k]) for k, v in model.state_dict().items())
            _restore(model, optimizer, state, before)
            with _PlainVersions(lstm_cuda):
                mp = step(state, batch)
            gp = _lstm_grads(model)
        finally:
            steps_mod.spec_time_freq_mask = real_mask
            model.draw_dropout_keep = draw_keep
        check(counted == step_launches, f"regularized step launches {counted}")
        check(not unmoved, f"unchanged after a regularized step: {unmoved}")
        check(np.isfinite(float(mk["loss"])) and not bool(mk["loss_exploded"]),
              f"regularized step loss {float(mk['loss'])}")
        vs_plain = {
            "loss_rel": abs(float(mk["loss"]) - float(mp["loss"])) / abs(float(mp["loss"])),
            "grad_norm_rel": abs(float(mk["grad_norm"]) - float(mp["grad_norm"]))
            / float(mp["grad_norm"]),
            "lstm_grad_peak_rel": {k: _peak_rel(gk[k], gp[k]) for k in gk},
        }
        for k, tol in TRAIN_TOL.items():
            err = vs_plain[k]
            err = max(err.values()) if isinstance(err, dict) else err
            check(err <= tol, f"regularized step: kernels vs plain {k} {err} > {tol}")
        # 3 steps drew: kernels, kernels again, plain versions; each draws 2
        # dropout sites and one set of bands
        check(len(kept) == 6 and len(bands) == 3, f"draws {len(kept)}, {len(bands)}")
        keep_share = sum(k for k, _ in kept[:2]) / sum(n for _, n in kept[:2])
        check(abs(keep_share - (1 - ONLINE_DROPOUT)) <= KEEP_SHARE_TOL, f"keep share {keep_share}")
        widest = {}
        for axis, limit in (("time", sa_time), ("freq", sa_freq)):
            start, width = bands[0][axis]
            widest[axis] = int(width.max())
            check(int(width.min()) >= 0 and widest[axis] <= limit, f"{axis} band {widest[axis]}")
            check(bool((start >= 0).all()), f"{axis} band start < 0")
        same_draws = all(torch.equal(bands[0][a][i], bands[2][a][i])
                         for a in ("time", "freq") for i in (0, 1))
        check(same_draws, "the plain-version step drew other bands")
        report["regularized_step"] = {
            "launches": counted, "loss": float(mk["loss"]), "grad_norm": float(mk["grad_norm"]),
            "kernels_vs_plain": vs_plain, "same_bits_twice": same_bits,
            "dropout_keep_share": keep_share, "widest_band": widest}
        if profile_dir:
            spec = torch.rand((2, T_FRAMES, active.num_freq), device="cuda").bfloat16()
            feats = torch.rand((2, T_FRAMES, 8 * active.num_freq + config.model.emb_dim),
                               device="cuda").bfloat16()
            hidden = torch.rand((2, T_FRAMES, 2 * config.model.lstm_dim), device="cuda").bfloat16()
            model.train()

            def regularizers():
                g = steps_mod.step_generator(steps_mod.SPEC_AUG_SEED, 0, torch.device("cuda"))
                augment.spec_time_freq_mask(spec, g, sa_time, sa_freq, config.train_config.spec_aug_n)
                gd = steps_mod.step_generator(steps_mod.DROPOUT_SEED, 0, torch.device("cuda"))
                model._drop(feats, gd)
                model._drop(hidden, gd)

            report["regularizers_profile"] = profile(torch, profile_dir, "regularizers", regularizers)
            report["regularized_step_profile"] = profile(
                torch, profile_dir, "train_regularized_B2", lambda: step(state, batch))
        initial = {k: v.clone() for k, v in before[0].items()}
        del model, optimizer, state, step, before, after_k, gk, gp
        torch.cuda.empty_cache()

        # (2) the counted run of this phase's path: the training CLI, online
        run_a, run_b = tmp / "online_a", tmp / "online_b"
        _reset_counts(torch, lstm_cuda)
        result = train_main(["-c", config_path, "--logs_path", str(run_a), "--max_steps",
                             str(ONLINE_STEPS), "--online", "--emb_mode", "spectral"])
        launches = _counts(torch, lstm_cuda)
        check(result["train_loader"] == "OnlineMixIterator", f"loader {result['train_loader']}")
        check(result.get("step") == ONLINE_STEPS and not result.get("exploded")
              and np.isfinite(result["loss"]), f"online run: {result}")
        # validations: at each epoch start and every checkpoint interval
        n_evals = -(-ONLINE_STEPS // online().batches_per_epoch()) + ONLINE_STEPS // ONLINE_CKPT_EVERY
        want = {k: v * ONLINE_STEPS for k, v in step_launches.items()}
        want["lstm_fwd"] += 2 * n_evals * PREPROCESS_TEST_ROWS
        check(launches == want, f"launches of the online run {launches}, expected {want}")
        final_a = load_checkpoint(str(run_a / f"checkpoint_{ONLINE_STEPS}.pt"))
        unmoved = [k for k, v in final_a["model"].items()
                   if torch.equal(v, initial[k].cpu())]
        check(not unmoved, f"parameters that never moved: {unmoved}")
        losses = [r["train_loss"] for r in _read_metrics(run_a) if "train_loss" in r]
        check(len(losses) == ONLINE_STEPS and all(np.isfinite(losses)), f"losses {losses}")
        p50, p75 = _step_ms(run_a)
        wall = result["wall_seconds"]

        # (3) resumed from the middle checkpoint
        resumed = train_main(["-c", config_path, "--logs_path", str(run_b), "--max_steps",
                              str(ONLINE_STEPS), "--online", "--emb_mode", "spectral",
                              "--checkpoint_path", str(run_a / f"checkpoint_{ONLINE_CKPT_EVERY}.pt")])
        check(resumed.get("step") == ONLINE_STEPS, f"resumed run: {resumed}")
        final_b = load_checkpoint(str(run_b / f"checkpoint_{ONLINE_STEPS}.pt"))
        diffs = {k: (final_a[g][k] - final_b[g][k]).abs().max().item()
                 for g in ("model", "batch_stats") for k in final_a[g]}
        worst = max(diffs, key=diffs.get)
        check(diffs[worst] <= TRAINER_RESUME_TOL, f"resumed online run differs: {worst} by "
              f"{diffs[worst]} > {TRAINER_RESUME_TOL}")
        check(final_a["data_state"] == final_b["data_state"], "data-iterator states differ")
        losses_b = [r["train_loss"] for r in _read_metrics(run_b) if "train_loss" in r]

        # (4) NaN triage on the card
        tr = Trainer(config, log_dir=str(tmp / "nan"), enable_tb=False, debug_nans=True,
                     train_loader=_PoisonedLoader(online(), NAN_BATCH))
        res = tr.fit(max_steps=NAN_BATCH + 4, validate_at_epoch_start=False)
        tr.close()
        check(res.get("exploded") is True and res["step"] == NAN_BATCH + 1,
              f"debug_nans run: {({k: v for k, v in res.items() if k != 'nan_report'})}")
        first_line = res["nan_report"].splitlines()[0]
        check(re.match(r"nan or inf in the output of \S+", first_line) is not None,
              f"the NaN report names no op: {first_line}")
    trainer_p50 = REPORTS.get("trainer", {}).get("run", {}).get("step_ms_p50")
    report["run"] = {
        "launches": launches, "launches_per_step": step_launches, "losses": losses,
        "step_ms_p50": p50, "step_ms_p75": p75, "trainer_phase_step_ms_p50": trainer_p50,
        "wall_seconds": wall, "data_wait_share_of_fit": wall["data"] / wall["fit"]}
    report["resume"] = {
        "from_step": ONLINE_CKPT_EVERY, "max_abs_diff": diffs[worst], "worst": worst,
        "same_bits": all(torch.equal(final_a[g][k], final_b[g][k])
                         for g in ("model", "batch_stats") for k in final_a[g]),
        "same_losses_after_resume": losses_b == losses[ONLINE_CKPT_EVERY:]}
    report["debug_nans"] = {"step": res["step"], "report_first_line": first_line}
    emit("trainer online", device=torch.cuda.get_device_name(0), **report)
    return launches


def _route_env(route: str):
    """The environment of a conv route: "unfused" (library convs), "pallas_conv"
    (`VOICESPLIT_PALLAS_CONV=1`) or "fused_chain" (`VOICESPLIT_FUSED_CHAIN=1`)."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(_Env("VOICESPLIT_PALLAS_CONV", "1" if route == "pallas_conv" else "0"))
    stack.enter_context(_Env("VOICESPLIT_FUSED_CHAIN", "1" if route == "fused_chain" else "0"))
    return stack


def _reset_counts(torch, *modules) -> None:
    """Zeroes the launch counters of kernel `modules` once the card is idle."""
    torch.cuda.synchronize()
    for m in modules:
        m.reset_launch_counts()


def _counts(torch, *modules) -> dict:
    """The launch counters of kernel `modules` once the card is idle."""
    torch.cuda.synchronize()
    out: dict = {}
    for m in modules:
        out.update(m.LAUNCHES)
    return out


def _add(total: dict, counted: dict) -> None:
    for k, v in counted.items():
        total[k] = total.get(k, 0) + v


def phase_separate_wide(torch, lstm_cuda, cc, seed: int, profile_dir, tmp: Path) -> dict:
    """`configs/voicesplit_wide.json` served at B=1: `separate_batch` (both
    LSTM directions on the forward's split walk, the extra dilated block
    through cuDNN, then with `VOICESPLIT_PALLAS_CONV=1` through
    `conv_bn_act_eval`, 7 launches a call) and the serving CLI on a
    synthetic mixture, held against the plain LSTM versions and the switch-off
    call; latency p50 and p75."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import main as separate_main
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet

    config = load_config(str(ROOT / WIDE_CONFIG))
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), seed)
    n = int(config.audio.audio_len * ap.sample_rate)
    mixed, emb = (torch.as_tensor(a, device="cuda")
                  for a in synthetic_batch(seed + 11, 1, n, ap.sample_rate, config.model.emb_dim))
    zero = {k: 0 for k in (*lstm_cuda.LAUNCHES, *cc.LAUNCHES)}
    launches: dict = {}
    report = {"config": WIDE_CONFIG, "params": sum(p.numel() for p in model.parameters()),
              "blocks": model.block_names, "tolerance_vs_plain": WIDE_SEPARATE_TOL,
              "tolerance_switch": SEPARATE_DILATED_TOL}

    # the counted run of the path: one serving call
    _reset_counts(torch, lstm_cuda, cc)
    out = separate_batch(model, ap, mixed, emb)
    counted = _counts(torch, lstm_cuda, cc)
    check(counted == {**zero, "lstm_fwd": 2}, f"launches per call {counted}")
    counted = _check_routes(lstm_cuda, counted, "separate wide", WIDE_ROUTES)
    _add(launches, counted)
    check(tuple(out.shape) == (1, n) and bool(torch.isfinite(out).all()), "output")
    with torch.inference_mode():
        spec, _ = ap.wav2spec_batch(mixed)
        mask = model(spec, emb)
        with _PlainVersions(lstm_cuda):
            mask_plain = model(spec, emb)
            out_plain = separate_batch(model, ap, mixed, emb)
    check(float(mask.min()) >= 0.0 and float(mask.max()) <= 1.0, "mask outside [0, 1]")
    mask_err = (mask - mask_plain).abs().max().item()
    wav_err = ((out - out_plain).abs().max() / out_plain.abs().max()).item()
    check(mask_err <= WIDE_SEPARATE_TOL, f"mask vs plain LSTM {mask_err} > {WIDE_SEPARATE_TOL}")
    check(wav_err <= WIDE_SEPARATE_TOL, f"waveform vs plain LSTM {wav_err} > {WIDE_SEPARATE_TOL}")
    p50, p75 = _latency_ms(torch, lambda: separate_batch(model, ap, mixed, emb), LATENCY_CALLS)
    report["B1"] = {"launches_per_call": counted, "samples": n,
                    "mask_range": [float(mask.min()), float(mask.max())],
                    "mask_err_vs_plain": mask_err, "wave_rel_err_vs_plain": wav_err,
                    "device_ms_mean": time_ms(torch, lambda: separate_batch(model, ap, mixed, emb), 10),
                    "calls": LATENCY_CALLS, "latency_ms_p50": p50, "latency_ms_p75": p75,
                    "audio_s_per_s": config.audio.audio_len / (p50 / 1e3)}
    if profile_dir:
        report["B1"]["profile"] = profile(
            torch, profile_dir, "separate_wide_B1", lambda: separate_batch(model, ap, mixed, emb))

    # the dilated switch: the extra block's conv (dilation 32) on its kernel
    with _route_env("pallas_conv"):
        _reset_counts(torch, lstm_cuda, cc)
        out_on = separate_batch(model, ap, mixed, emb)
        counted = _counts(torch, lstm_cuda, cc)
        check(counted == {**zero, "lstm_fwd": 2, "conv_bn_act_eval": WIDE_KERNEL_LAYERS},
              f"launches per call with the switch {counted}")
        counted = _check_routes(lstm_cuda, counted, "separate wide, switch", WIDE_ROUTES)
        _add(launches, counted)
        with torch.inference_mode():
            mask_on = model(spec, emb)
        on50, on75 = _latency_ms(torch, lambda: separate_batch(model, ap, mixed, emb), LATENCY_CALLS)
    mask_err = (mask_on - mask).abs().max().item()
    wav_err = ((out_on - out).abs().max() / out.abs().max()).item()
    check(mask_err <= SEPARATE_DILATED_TOL, f"switch: mask vs switch off {mask_err}")
    check(wav_err <= SEPARATE_DILATED_TOL, f"switch: waveform vs switch off {wav_err}")
    report["B1_dilated_switch"] = {"launches_per_call": counted, "mask_err_vs_switch_off": mask_err,
                                   "wave_rel_err_vs_switch_off": wav_err, "latency_ms_p50": on50,
                                   "latency_ms_p75": on75}

    # the serving CLI on a synthetic mixture and d-vector, weights from a file
    made = build_synthetic_dataset(str(tmp / "serve"), 1, sample_rate=ap.sample_rate,
                                   audio_len=config.audio.audio_len, emb_dim=config.model.emb_dim,
                                   fmt=config.dataset.format, seed=seed)
    mix_path = made[0]
    emb_path = mix_path.replace("-mixed.wav", "-emb.npy")
    weights.save(model, str(tmp / "wide.pt"))
    _reset_counts(torch, lstm_cuda, cc)
    t0 = time.perf_counter()
    separate_main(["-c", str(ROOT / WIDE_CONFIG), "--weights", str(tmp / "wide.pt"),
                   "--mixed_wav", mix_path, "--emb", emb_path, "--output", str(tmp / "out.wav")])
    cli_s = time.perf_counter() - t0
    counted = _check_routes(lstm_cuda, _counts(torch, lstm_cuda, cc), "separate CLI", WIDE_ROUTES)
    _add(launches, counted)
    wav = ap.load_wav(str(tmp / "out.wav"))
    check(wav.shape == (n,) and bool(np.isfinite(wav).all()), f"CLI output {wav.shape}")
    report["cli"] = {"launches": counted, "seconds": cli_s, "samples": int(wav.shape[0])}
    emit("separate wide", device=torch.cuda.get_device_name(0), **report)
    return launches


def _fp32_step_vs_plain(torch, config, ap, batch, seed: int, module, last: int) -> dict:
    """One train step of `config`'s model in fp32 compute through the
    kernels of `module` against the same step through its plain versions:
    held to WIDE_FP32_STEP_TOL (summation order only)."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    config = copy.deepcopy(config)
    config.train_config.compute_dtype = "float32"
    model = weights.init_random_(make_masknet(config), seed)
    optimizer = make_optimizer(config, model)
    state = create_train_state(model, optimizer)
    step = make_train_step(config, model, ap, optimizer)
    before = _snapshot(model, optimizer, state)
    mk = step(state, batch)
    through_kernels = _chain_state(model, last)
    _restore(model, optimizer, state, before)
    with _PlainVersions(module):
        mp = step(state, batch)
    cmp = _compare_steps(torch, mk, through_kernels, mp, _chain_state(model, last))
    _check_step_agreement("fp32: kernels vs plain", cmp, WIDE_FP32_STEP_TOL)
    return cmp


def phase_train_wide(torch, lstm_cuda, cf, cc, seed: int, profile_dir, tmp: Path):
    """`configs/voicesplit_wide.json` trained at B=2 on each conv route: one
    counted step (the LSTM's forward and backward on WIDE_ROUTES, the
    conv kernels at the extra block's dilation 32 on the kernel routes)
    against the plain versions, timed steps on a fixed batch whose loss must
    fall; then the training CLI on each route over a synthetic dataset, with
    two checkpoints and three validations.  Returns the launches and the
    unfused run's directory and config (for the evaluate phase)."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.train import main as train_main
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
    from voicesplit_tpu_torch.train.checkpoint import list_checkpoints

    config = load_config(str(ROOT / WIDE_CONFIG))
    config.train_config.learning_rate = TRAIN_LR
    ap = make_audio_processor(config)
    n = int(config.audio.audio_len * ap.sample_rate)
    b = config.train_config.batch_size
    check(b == 2 and config.model.lstm_dim == GRID_HIDDEN, f"the wide config's batch {b}")
    modules = (lstm_cuda, cf, cc)
    zero = {k: 0 for m in modules for k in m.LAUNCHES}
    plain_of = {"pallas_conv": (cc, DILATED_STEP_TOL), "fused_chain": (cf, FUSED_TOL)}
    last = 7 + config.model.num_extra_dilated_blocks  # the last kernel layer
    batch = train_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim)
    launches: dict = {}
    report = {"config": WIDE_CONFIG, "compute_dtype": config.train_config.compute_dtype,
              "learning_rate": TRAIN_LR, "batch": b}
    for route in WIDE_CONV_ROUTES:
        with _route_env(route):
            model = weights.init_random_(make_masknet(config), seed)
            optimizer = make_optimizer(config, model)
            state = create_train_state(model, optimizer)
            step = make_train_step(config, model, ap, optimizer)
            before = _snapshot(model, optimizer, state)

            # the counted run: one step from fresh weights
            _reset_counts(torch, *modules)
            mk = step(state, batch)
            counted = _counts(torch, *modules)
            want = {**zero, **WIDE_TRAIN_LAUNCHES, **WIDE_CONV_LAUNCHES[route]}
            check(counted == want, f"{route}: launches per step {counted}, expected {want}")
            counted = _check_routes(lstm_cuda, counted, f"train wide {route}", WIDE_ROUTES)
            _add(launches, counted)
            loss0, gn0 = float(mk["loss"]), float(mk["grad_norm"])
            check(np.isfinite(loss0) and not bool(mk["loss_exploded"]), f"{route}: loss {loss0}")
            check(gn0 > 0 and np.isfinite(gn0), f"{route}: grad_norm {gn0}")
            unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[0][k])]
            check(not unmoved, f"{route}: unchanged after a step: {unmoved}")

            # the same step through the plain versions: the LSTM's on the
            # library-conv route (as the train phase), the conv kernels' on
            # the kernel routes (as the train fused and trainer phases)
            if route == "unfused":
                gk = _lstm_grads(model)
                _restore(model, optimizer, state, before)
                with _PlainVersions(lstm_cuda):
                    mp = step(state, batch)
                gp = _lstm_grads(model)
                vs_plain = {
                    "loss_rel": abs(loss0 - float(mp["loss"])) / abs(float(mp["loss"])),
                    "grad_norm_rel": abs(gn0 - float(mp["grad_norm"])) / float(mp["grad_norm"]),
                    "lstm_grad_peak_rel": {
                        k: ((gk[k] - gp[k]).abs().max() / gp[k].abs().max()).item() for k in gk},
                }
                for k, tol in TRAIN_TOL.items():
                    err = vs_plain[k]
                    err = max(err.values()) if isinstance(err, dict) else err
                    check(err <= tol, f"{route}: kernels vs plain {k} {err} > {tol}")
            else:
                module, tol = plain_of[route]
                through_kernels = _chain_state(model, last)
                _restore(model, optimizer, state, before)
                with _PlainVersions(module, round_once=True):
                    mp = step(state, batch)
                vs_plain = _compare_steps(torch, mk, through_kernels, mp, _chain_state(model, last))
                _check_step_agreement(f"{route}: kernels vs plain", vs_plain, tol)
                del through_kernels
                vs_plain = {"bf16_round_once": vs_plain,
                            "fp32": _fp32_step_vs_plain(torch, config, ap, batch, seed, module, last)}
            _restore(model, optimizer, state, before)

            for _ in range(TRAIN_WARM):
                step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, metrics = [], []
            for _ in range(WIDE_TRAIN_STEPS):
                t0 = time.perf_counter()
                metrics.append(step(state, batch))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            losses = [float(m["loss"]) for m in metrics]
            check(all(np.isfinite(losses)), f"{route}: non-finite loss in {losses}")
            check(losses[-1] < loss0, f"{route}: loss did not fall on a fixed batch: {loss0} -> {losses}")
            p50, p75 = (float(np.percentile(times, q)) for q in (50, 75))
            report[route] = {
                "launches_per_step": counted, "first_loss": loss0, "first_grad_norm": gn0,
                "kernels_vs_plain": vs_plain, "steps": WIDE_TRAIN_STEPS,
                "step_ms_p50": p50, "step_ms_p75": p75,
                "audio_s_per_s": b * config.audio.audio_len / (p50 / 1e3), "losses": losses,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            }
            if profile_dir:
                report[route]["profile"] = profile(
                    torch, profile_dir, f"train_wide_{route}_B{b}", lambda: step(state, batch))
            del model, optimizer, state, step, before
            torch.cuda.empty_cache()

    # the training entry point on each route: checkpoints and validations
    config_path, cli_config = _trainer_config(
        tmp, seed, Path(WIDE_CONFIG).name, WIDE_CLI_TRAIN_ITEMS, WIDE_CLI_EVAL_ITEMS, WIDE_CLI_CKPT_EVERY)
    n_evals = 1 + WIDE_CLI_STEPS // WIDE_CLI_CKPT_EVERY
    report["cli"] = {"steps": WIDE_CLI_STEPS, "checkpoint_interval": WIDE_CLI_CKPT_EVERY,
                     "train_items": WIDE_CLI_TRAIN_ITEMS, "eval_items": WIDE_CLI_EVAL_ITEMS}
    for route in WIDE_CONV_ROUTES:
        run = tmp / f"run_{route}"
        with _route_env(route):
            _reset_counts(torch, *modules)
            result = train_main(["-c", config_path, "--logs_path", str(run),
                                 "--max_steps", str(WIDE_CLI_STEPS), "--eval_sdr"])
            counted = _counts(torch, *modules)
        check(result.get("step") == WIDE_CLI_STEPS and not result.get("exploded"), f"{route}: {result}")
        # every step's launches, and a serving forward per validation item
        # (eval mode: the fused chain is off, the dilated switch on)
        want = {k: v * WIDE_CLI_STEPS for k, v in {**zero, **WIDE_TRAIN_LAUNCHES,
                                                   **WIDE_CONV_LAUNCHES[route]}.items()}
        want["lstm_fwd"] += 2 * n_evals * WIDE_CLI_EVAL_ITEMS
        if route == "pallas_conv":
            want["conv_bn_act_eval"] += WIDE_KERNEL_LAYERS * n_evals * WIDE_CLI_EVAL_ITEMS
        check(counted == want, f"{route} CLI: launches {counted}, expected {want}")
        counted = _check_routes(lstm_cuda, counted, f"train wide CLI {route}", WIDE_ROUTES)
        _add(launches, counted)
        records = _read_metrics(run)
        losses = [r["train_loss"] for r in records if "train_loss" in r]
        evals = [r for r in records if "eval_loss" in r]
        check(len(losses) == WIDE_CLI_STEPS and all(np.isfinite(losses)), f"{route} CLI: losses {losses}")
        check(len(evals) == n_evals and all(np.isfinite(r["eval_sdr"]) for r in evals),
              f"{route} CLI: validations {evals}")
        ckpts = [Path(p).name for p in list_checkpoints(str(run))]
        steps_saved = range(WIDE_CLI_CKPT_EVERY, WIDE_CLI_STEPS + 1, WIDE_CLI_CKPT_EVERY)
        check(ckpts == [f"checkpoint_{k}.pt" for k in steps_saved], f"{route} CLI: checkpoints {ckpts}")
        report["cli"][route] = {"launches": counted, "losses": losses, "checkpoints": ckpts,
                                "eval_sdr": [r["eval_sdr"] for r in evals],
                                "wall_seconds": result["wall_seconds"]}
    emit("train wide", device=torch.cuda.get_device_name(0), **report)
    return launches, tmp / "run_unfused", cli_config


def phase_evaluate(torch, lstm_cuda, seed: int, tmp: Path, run, config) -> dict:
    """`cli/test.py` on the last checkpoint of the wide model that the train
    wide phase wrote (the SDR on the card, and once more on the host, which
    must agree), then `cli/sweep.py` over both checkpoints of that run: the
    metrics finite, the best-checkpoint copies and the curve written.
    Without the train wide phase it first trains its own run."""
    from voicesplit_tpu_torch.cli.sweep import main as sweep_main
    from voicesplit_tpu_torch.cli.test import main as test_main
    from voicesplit_tpu_torch.cli.train import main as train_main
    from voicesplit_tpu_torch.train.checkpoint import list_checkpoints

    if run is None:
        config_path, config = _trainer_config(
            tmp, seed, Path(WIDE_CONFIG).name, WIDE_CLI_TRAIN_ITEMS, WIDE_CLI_EVAL_ITEMS,
            WIDE_CLI_CKPT_EVERY)
        run = tmp / "run_unfused"
        with _route_env("unfused"):
            train_main(["-c", config_path, "--logs_path", str(run), "--max_steps", str(WIDE_CLI_STEPS)])
    ckpts = list_checkpoints(str(run))
    check(len(ckpts) == 2, f"checkpoints {ckpts}")
    launches: dict = {}
    report = {"config": WIDE_CONFIG, "checkpoints": [Path(p).name for p in ckpts],
              "test_items": WIDE_CLI_EVAL_ITEMS}
    with _route_env("unfused"):
        _reset_counts(torch, lstm_cuda)
        t0 = time.perf_counter()
        metrics = test_main(["--checkpoint_path", ckpts[-1], "--test_dir", config.dataset.test_dir])
        test_s = time.perf_counter() - t0
        test_counted = _check_routes(lstm_cuda, _counts(torch, lstm_cuda), "cli test", WIDE_ROUTES)
        _add(launches, test_counted)
        check(sorted(metrics) == ["loss", "sdr", "si_snr", "si_snri"]
              and all(np.isfinite(v) for v in metrics.values()), f"cli test: {metrics}")
        host = test_main(["--checkpoint_path", ckpts[-1], "--test_dir", config.dataset.test_dir,
                          "--sdr_backend", "host"])
        sdr_diff = abs(metrics["sdr"] - host["sdr"])
        check(sdr_diff <= EVAL_SDR_TOL_DB, f"cli test: SDR on the card vs host {sdr_diff} dB")
        _reset_counts(torch, lstm_cuda)
        t0 = time.perf_counter()
        swept = sweep_main(["--checkpoints_path", str(run), "--test_dir", config.dataset.test_dir])
        sweep_s = time.perf_counter() - t0
        sweep_counted = _check_routes(lstm_cuda, _counts(torch, lstm_cuda), "cli sweep", WIDE_ROUTES)
        _add(launches, sweep_counted)
    check(swept["n_checkpoints"] == 2 and swept["best_path"] in ckpts, f"cli sweep: {swept}")
    copies = sorted(p.name for p in run.iterdir() if p.name.startswith(("best_", "sdr_curve")))
    check(copies == ["best_checkpoint.pt", "best_loss_checkpoint.pt", "sdr_curve.npy"],
          f"cli sweep wrote {copies}")
    curve = np.load(run / "sdr_curve.npy")
    check(curve.shape == (2, 2) and bool(np.isfinite(curve).all()), f"sdr curve {curve}")
    report.update(test=metrics, test_seconds=test_s, test_launches=test_counted,
                  sweep_launches=sweep_counted,
                  host_sdr=host["sdr"], sdr_card_vs_host_db=sdr_diff, sdr_tolerance_db=EVAL_SDR_TOL_DB,
                  sweep={k: v for k, v in swept.items() if k != "results"},
                  sweep_results=[{k: v for k, v in r.items() if k != "path"} for r in swept["results"]],
                  sweep_seconds=sweep_s, curve=curve.tolist())
    emit("evaluate", device=torch.cuda.get_device_name(0), **report)
    return launches


# ---------------------------------------------------------------------------
# The remaining DSP, streaming separation and the streaming model's training
# ---------------------------------------------------------------------------


def phase_dsp(torch, lstm_cuda, seed: int, tmp: Path) -> dict:
    """Griffin-Lim and the wavernn / waveglow processors on the card: the
    serving CLI with ``--griffin_lim`` (the config's 60 rounds), Griffin-Lim
    against the same call on the CPU from the same angles, its spectral
    convergence after the first and the last round, and each backend's
    ``wav2spec_batch`` → ``spec2wav_batch`` against the CPU."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import main as separate_main
    from voicesplit_tpu_torch.config import AudioConfig, load_config
    from voicesplit_tpu_torch.dsp.griffin_lim import griffin_lim, griffin_lim_angles
    from voicesplit_tpu_torch.dsp.processor import AudioProcessor, make_audio_processor
    from voicesplit_tpu_torch.dsp.stft import stft_magphase
    from voicesplit_tpu_torch.models.masknet import make_masknet

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    ap = make_audio_processor(config)
    ap_cpu = make_audio_processor(config, device="cpu")
    sr, n = ap.sample_rate, int(config.audio.audio_len * ap.sample_rate)
    wav, emb = synthetic_batch(seed + 21, 1, n, sr, config.model.emb_dim)
    report = {"config": "configs/voicesplit.json", "griffin_lim_iters": ap.griffin_lim_iters,
              "tolerance_card_vs_cpu": GRIFFIN_LIM_CARD_TOL,
              "backend_tolerance_card_vs_cpu": BACKEND_ROUNDTRIP_TOL}

    # the serving CLI with Griffin-Lim phase estimation
    weights.save(weights.init_random_(make_masknet(config), seed), str(tmp / "w.pt"))
    ap.save_wav(wav[0], str(tmp / "mix.wav"))
    np.save(tmp / "emb.npy", emb[0])
    _reset_counts(torch, lstm_cuda)
    t0 = time.perf_counter()
    separate_main(["-c", str(ROOT / "configs" / "voicesplit.json"), "--weights", str(tmp / "w.pt"),
                   "--mixed_wav", str(tmp / "mix.wav"), "--emb", str(tmp / "emb.npy"),
                   "--output", str(tmp / "gl.wav"), "--griffin_lim"])
    cli_s = time.perf_counter() - t0
    launches = _counts(torch, lstm_cuda)
    check(launches == {**{k: 0 for k in launches}, "lstm_fwd": 2}, f"CLI launches {launches}")
    launches = _check_routes(lstm_cuda, launches, "dsp: separate --griffin_lim")
    out = ap.load_wav(str(tmp / "gl.wav"))
    check(out.shape == (n,) and bool(np.isfinite(out).all()), f"CLI output {out.shape}")
    report["cli_griffin_lim"] = {"seconds": cli_s, "samples": int(out.shape[0]),
                                 "launches": launches}

    # Griffin-Lim on the card against the CPU from the same angles
    mixed = torch.as_tensor(wav, device=ap.device)
    mag = stft_magphase(mixed, ap.n_fft, ap.hop_length, ap.win_length)[0] ** ap.power
    angles = griffin_lim_angles(mag.shape, torch.Generator().manual_seed(seed))
    times = []
    for _ in range(GRIFFIN_LIM_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_card = ap.griffin_lim_batch(mag, angles=angles)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    y_cpu = ap_cpu.griffin_lim_batch(mag.cpu(), angles=angles)
    gl_err = _peak_rel(y_card.cpu(), y_cpu)
    check(bool(torch.isfinite(y_card).all()) and tuple(y_card.shape) == (1, n), "Griffin-Lim output")
    check(gl_err <= GRIFFIN_LIM_CARD_TOL, f"Griffin-Lim card vs CPU {gl_err} > {GRIFFIN_LIM_CARD_TOL}")

    def convergence(rounds: int) -> float:
        y = griffin_lim(mag, ap.n_fft, ap.hop_length, ap.win_length, rounds, angles=angles)
        got = stft_magphase(y, ap.n_fft, ap.hop_length, ap.win_length)[0]
        return float(torch.linalg.vector_norm(got - mag) / torch.linalg.vector_norm(mag))

    sc_first, sc_last = convergence(1), convergence(ap.griffin_lim_iters)
    check(sc_last <= sc_first, f"spectral convergence {sc_first} after 1 round, {sc_last} after last")
    report["griffin_lim"] = {
        "shape": list(mag.shape), "calls": GRIFFIN_LIM_CALLS,
        "seconds_p50": float(np.median(times)), "seconds_all": times,
        "card_vs_cpu_peak_rel": gl_err,
        "spectral_convergence_first_round": sc_first, "spectral_convergence_last_round": sc_last}

    # the wavernn and waveglow processors, linear and mel
    backends = {}
    for backend in ("wavernn", "waveglow"):
        for mel_spec in (False, True):
            cfg = AudioConfig(backend=backend, mel_spec=mel_spec)
            on_card, on_cpu = AudioProcessor(cfg), AudioProcessor(cfg, device="cpu")
            y = synthetic_batch(seed + 22, 1, int(config.audio.audio_len * on_card.sample_rate),
                                on_card.sample_rate, config.model.emb_dim)[0]
            rec = {}
            for name, p in (("card", on_card), ("cpu", on_cpu)):
                spec, phase = p.wav2spec_batch(torch.as_tensor(y, device=p.device))
                rec[name] = (spec.cpu(), p.spec2wav_batch(spec, phase).cpu())
            # the spectrogram's difference is reported, not held: a quiet bin's
            # dB or ln carries its sum's relative round-off (1.3e-4 wavernn,
            # 1.8e-3 waveglow on an H100); the waveform is what is held
            spec_err = float((rec["card"][0] - rec["cpu"][0]).abs().max())
            wav_err = _peak_rel(rec["card"][1], rec["cpu"][1])
            key = f"{backend}{'_mel' if mel_spec else ''}"
            check(bool(torch.isfinite(rec["card"][1]).all()), f"{key}: non-finite")
            check(wav_err <= BACKEND_ROUNDTRIP_TOL,
                  f"{key}: card vs CPU waveform {wav_err} > {BACKEND_ROUNDTRIP_TOL}")
            backends[key] = {"spec_shape": list(rec["card"][0].shape),
                             "spec_max_abs_err": spec_err, "wave_peak_rel": wav_err}
    report["backends"] = backends
    emit("dsp", device=torch.cuda.get_device_name(0), **report)
    return launches


def _stream_config(causal: bool, dtype: str = "bfloat16"):
    from voicesplit_tpu_torch.config import load_config

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    config.model.causal = causal  # set in code, as the JAX package's tests do
    config.train_config.compute_dtype = dtype
    return config


def _streamer(config, seed: int, chunk: int = STREAM_CHUNK):
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.streaming import StreamingSeparator

    model = weights.init_random_(make_masknet(config, streaming=True), seed)
    return StreamingSeparator(config, model, chunk)


def phase_streaming(torch, lstm_cuda, cc, cf, seed: int, profile_dir) -> dict:
    """The streaming engine at full width in bf16 with random weights: (a) the
    causal model at B=1, (b) the symmetric model with
    `VOICESPLIT_PALLAS_CONV=1` at B=1 and, for its latency, without, (c) the
    causal model at B=8.  Each:
    a counted 3 s stream (exact launches a chunk), the same stream through
    the plain versions, per-chunk latency; (a) also a perturbation of the
    future input; then chunk-size invariance (50 against 25 frames)."""
    report = {"chunk_frames": STREAM_CHUNK, "tolerance_vs_plain": WIDE_SEPARATE_TOL,
              "invariance_tolerance_fp32": STREAM_INVARIANCE_TOL, "streams": {}}
    launches: dict = {}
    zero = {k: 0 for k in (*lstm_cuda.LAUNCHES, *cc.LAUNCHES, *cf.LAUNCHES)}
    for name, (causal, B, switch) in STREAM_CASES.items():
        config = _stream_config(causal)
        with _Env("VOICESPLIT_PALLAS_CONV", switch):
            sep = _streamer(config, seed)
            sr = sep.ap.sample_rate
            n = int(config.audio.audio_len * sr)
            chunk_s = sep.chunk_samples / sr
            check(sep.latency_samples == STREAM_LATENCY[causal],
                  f"{name}: latency {sep.latency_samples} samples")
            wav, emb = synthetic_batch(seed + 31 + B, B, n, sr, config.model.emb_dim)
            # `separate` pads to whole chunks covering the latency, as JAX's does
            chunks = (n + (-n) % sep.chunk_samples + sep.latency_samples) // sep.chunk_samples + 1

            # the counted run of the path: one stream, chunk by chunk
            _reset_counts(torch, lstm_cuda, cc, cf)
            out = sep.separate(wav, emb)
            counted = _counts(torch, lstm_cuda, cc, cf)
            want = {**zero, **{k: v * chunks for k, v in STREAM_LAUNCHES[switch].items()}}
            check(counted == want, f"{name}: launches for {chunks} chunks {counted}, expected {want}")
            counted = _check_routes(lstm_cuda, counted, f"streaming {name}")
            _add(launches, counted)
            check(out.shape == (B, n) and bool(np.isfinite(out).all()), f"{name}: output {out.shape}")
            with _PlainVersions(lstm_cuda), _PlainVersions(cc, round_once=True):
                out_plain = sep.separate(wav, emb)
            err = _peak_rel(torch.from_numpy(out), torch.from_numpy(out_plain))
            check(err <= WIDE_SEPARATE_TOL, f"{name}: stream vs plain {err} > {WIDE_SEPARATE_TOL}")

            # per-chunk latency, the state carried from chunk to chunk
            state = sep.init_state(B)
            cs = sep.chunk_samples
            lat = []
            for i in range(STREAM_WARM_CHUNKS + STREAM_TIMED_CHUNKS):
                piece = wav[:, (i * cs) % (n - cs):][:, :cs]
                t0 = time.perf_counter()
                state, o = sep.process_chunk(state, piece, emb)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            lat = lat[STREAM_WARM_CHUNKS:]
            p50, p75 = (float(np.percentile(lat, q)) for q in (50, 75))
            entry = {"batch": B, "causal": causal, "switch": switch == "1",
                     "latency_samples": sep.latency_samples,
                     "latency_ms_algorithmic": sep.latency_samples / sr * 1e3,
                     "chunks_counted": chunks, "launches_per_chunk": {
                         k: v // chunks for k, v in counted.items() if v},
                     "peak_rel_vs_plain": err, "chunks_timed": STREAM_TIMED_CHUNKS,
                     "chunk_ms_p50": p50, "chunk_ms_p75": p75,
                     "real_time_factor_p50": p50 / (chunk_s * 1e3),
                     "audio_s_per_s_p50": B * chunk_s / (p50 / 1e3)}
            if profile_dir:
                entry["profile"] = prof = profile(torch, profile_dir, f"streaming_{name}",
                                                  lambda: sep.process_chunk(state, piece, emb))
                # the device's idle share of the unprofiled chunk time
                entry["idle_share_of_p50"] = 1.0 - prof["kernel_ms"] / prof["runs"] / p50
            if causal and B == 1:
                # a perturbation of the future: the samples emitted before it
                # (one latency and one hop earlier) do not move
                s = STREAM_PERTURB_AT
                other = wav.copy()
                other[:, s:] = synthetic_batch(seed + 99, 1, n - s, sr, config.model.emb_dim)[0]
                moved = sep.separate(other, emb)
                keep = s - sep.latency_samples - sep.hop
                before = float(np.abs(moved[:, :keep] - out[:, :keep]).max())
                after = float(np.abs(moved[:, s:] - out[:, s:]).max())
                check(before <= STREAM_CAUSAL_TOL * float(np.abs(out).max()),
                      f"{name}: output before the perturbation moved by {before}")
                check(after > 0.0, f"{name}: the perturbation changed nothing")
                entry["perturbation"] = {"at_sample": s, "unchanged_samples": keep,
                                         "max_abs_change_before": before,
                                         "same_bits_before": before == 0.0,
                                         "max_abs_change_after": after}
            report["streams"][name] = entry
            del sep
    # chunk-size invariance: fp32 compute within the JAX test's bound; bf16
    # measured (its carry is rounded at other chunk boundaries)
    for dtype in ("float32", "bfloat16"):
        config = _stream_config(True, dtype)
        wav, emb = synthetic_batch(seed + 41, 1, int(config.audio.audio_len * 16000), 16000,
                                   config.model.emb_dim)
        a = _streamer(config, seed, STREAM_CHUNK).separate(wav, emb)
        b = _streamer(config, seed, STREAM_CHUNK // 2).separate(wav, emb)
        diff = float(np.abs(a - b).max())
        if dtype == "float32":
            check(diff <= STREAM_INVARIANCE_TOL, f"chunk-size invariance (fp32) {diff}")
        report[f"chunk_{STREAM_CHUNK}_vs_{STREAM_CHUNK // 2}_{dtype}"] = {
            "max_abs_diff": diff, "peak": float(np.abs(a).max())}
    emit("streaming", device=torch.cuda.get_device_name(0), **report)
    return launches


def phase_train_streaming(torch, lstm_cuda, cc, cf, seed: int, profile_dir) -> dict:
    """The streaming (causal) model's training at full width with
    `VOICESPLIT_PALLAS_CONV=1`, which no causal layer takes: one counted step
    at B=2 held against the plain LSTM versions, timed steps, then
    `cli.train.main` (the `Trainer` builds the streaming model from the
    causal config) with checkpoints; then a random BiLSTM checkpoint through
    `cli.convert_streaming.main` served by `cli.separate.main --streaming`
    against `StreamingSeparator.separate` on the same weights."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.convert_streaming import main as convert_main
    from voicesplit_tpu_torch.cli.separate import main as separate_main
    from voicesplit_tpu_torch.cli.train import main as train_main
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.streaming import StreamingSeparator
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
    from voicesplit_tpu_torch.train.checkpoint import (
        config_from_checkpoint, list_checkpoints, load_model_variables, save_checkpoint)

    zero = {k: 0 for k in (*lstm_cuda.LAUNCHES, *cc.LAUNCHES, *cf.LAUNCHES)}
    step_launches = {**zero, **STREAM_TRAIN_LAUNCHES}
    report = {"switch": "VOICESPLIT_PALLAS_CONV=1", "learning_rate": TRAIN_LR,
              "tolerances": TRAIN_TOL, "cli_steps": STREAM_TRAIN_STEPS,
              "checkpoint_interval": STREAM_TRAIN_CKPT_EVERY}
    with tempfile.TemporaryDirectory(prefix="voicesplit_stream_") as tmp_name, \
            _Env("VOICESPLIT_PALLAS_CONV", "1"):
        tmp = Path(tmp_name)
        config_path, config = _trainer_config(tmp, seed, n_train=STREAM_TRAIN_ITEMS,
                                              n_eval=STREAM_EVAL_ITEMS,
                                              ckpt_every=STREAM_TRAIN_CKPT_EVERY)
        config.model.causal = True
        Path(config_path).write_text(config.to_json())
        ap = make_audio_processor(config)
        b, sr = config.train_config.batch_size, ap.sample_rate
        n = int(config.audio.audio_len * sr)

        # (1) one counted step of the streaming model from random weights
        model = weights.init_random_(make_masknet(config, streaming=True), seed)
        check(model.causal and model.streaming, "not the streaming causal model")
        optimizer = make_optimizer(config, model)
        state = create_train_state(model, optimizer)
        step = make_train_step(config, model, ap, optimizer)
        batch = train_batch(seed + 51, b, n, sr, config.model.emb_dim)
        before = _snapshot(model, optimizer, state)
        _reset_counts(torch, lstm_cuda, cc, cf)
        mk = step(state, batch)
        counted = _counts(torch, lstm_cuda, cc, cf)
        check(counted == step_launches, f"launches per step {counted}, expected {step_launches}")
        counted = _check_routes(lstm_cuda, counted, "train streaming")
        launches = dict(counted)
        loss0, gn0 = float(mk["loss"]), float(mk["grad_norm"])
        check(np.isfinite(loss0) and not bool(mk["loss_exploded"]), f"loss {loss0}")
        check(gn0 > 0 and np.isfinite(gn0), f"grad_norm {gn0}")
        unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[0][k])]
        check(not unmoved, f"unchanged after a step: {unmoved}")
        gk = _lstm_grads(model)
        _restore(model, optimizer, state, before)
        with _PlainVersions(lstm_cuda):
            mp = step(state, batch)
        gp = _lstm_grads(model)
        vs_plain = {
            "loss_rel": abs(loss0 - float(mp["loss"])) / abs(float(mp["loss"])),
            "grad_norm_rel": abs(gn0 - float(mp["grad_norm"])) / float(mp["grad_norm"]),
            "lstm_grad_peak_rel": {k: _peak_rel(gk[k], gp[k]) for k in gk},
        }
        for k, tol in TRAIN_TOL.items():
            err = vs_plain[k]
            err = max(err.values()) if isinstance(err, dict) else err
            check(err <= tol, f"train streaming: kernels vs plain {k} {err} > {tol}")
        for _ in range(TRAIN_WARM):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(STREAM_TRAIN_TIMED):
            t0 = time.perf_counter()
            losses.append(step(state, batch)["loss"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        losses = [float(v) for v in losses]
        check(all(np.isfinite(losses)) and losses[-1] < loss0, f"losses {loss0} -> {losses}")
        report["step"] = {
            "batch": b, "launches_per_step": {k: v for k, v in counted.items() if v},
            "first_loss": loss0, "first_grad_norm": gn0, "kernels_vs_plain": vs_plain,
            "steps_timed": STREAM_TRAIN_TIMED, "losses": losses,
            "step_ms_p50": float(np.percentile(times, 50)),
            "step_ms_p75": float(np.percentile(times, 75)),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        if profile_dir:
            report["step"]["profile"] = profile(torch, profile_dir, "train_streaming_B2",
                                                lambda: step(state, batch))
        del model, optimizer, state, step
        torch.cuda.empty_cache()

        # (2) the training CLI on the causal config
        run = tmp / "run"
        _reset_counts(torch, lstm_cuda, cc, cf)
        result = train_main(["-c", config_path, "--logs_path", str(run),
                             "--max_steps", str(STREAM_TRAIN_STEPS)])
        counted = _counts(torch, lstm_cuda, cc, cf)
        check(result.get("step") == STREAM_TRAIN_STEPS and not result.get("exploded"),
              f"run: {result}")
        n_evals = 1 + STREAM_TRAIN_STEPS // STREAM_TRAIN_CKPT_EVERY
        want = {k: v * STREAM_TRAIN_STEPS for k, v in step_launches.items()}
        want["lstm_fwd"] += n_evals * STREAM_EVAL_ITEMS  # one item a validation call
        check(counted == want, f"launches of the run {counted}, expected {want}")
        _add(launches, _check_routes(lstm_cuda, counted, "train streaming CLI"))
        train = [r for r in _read_metrics(run) if "train_loss" in r]
        run_losses = [r["train_loss"] for r in train]
        check(len(train) == STREAM_TRAIN_STEPS and all(np.isfinite(run_losses)),
              f"train losses {run_losses}")
        ckpts = [Path(p).name for p in list_checkpoints(str(run))]
        want_ckpts = [f"checkpoint_{k}.pt" for k in range(
            STREAM_TRAIN_CKPT_EVERY, STREAM_TRAIN_STEPS + 1, STREAM_TRAIN_CKPT_EVERY)]
        check(ckpts == want_ckpts, f"checkpoints {ckpts}")
        load_model_variables(config, str(run / ckpts[-1]), streaming=True)  # raises on a misfit
        deltas = np.diff([r["time"] for r in train]) * 1e3
        report["cli"] = {"launches": counted, "losses": run_losses, "checkpoints": ckpts,
                         "step_ms_p50": float(np.percentile(deltas, 50)),
                         "step_ms_p75": float(np.percentile(deltas, 75)),
                         "wall_seconds": result["wall_seconds"]}

        # (3) a BiLSTM checkpoint converted and served by the streaming CLI
        offline = load_config(str(ROOT / "configs" / "voicesplit.json"))
        bilstm = weights.init_random_(make_masknet(offline), seed + 1)
        src = save_checkpoint(str(tmp / "offline"), create_train_state(
            bilstm, make_optimizer(offline, bilstm)), offline)
        del bilstm
        converted = convert_main(["--checkpoint_path", src, "--output_dir", str(tmp / "stream")])
        sconfig = config_from_checkpoint(converted)
        check(sconfig.model.causal, "the converted config is not causal")
        (tmp / "stream.json").write_text(sconfig.to_json())
        wav, emb = synthetic_batch(seed + 61, 1, n, sr, config.model.emb_dim)
        ap.save_wav(wav[0], str(tmp / "mix.wav"))
        np.save(tmp / "emb.npy", emb[0])
        _reset_counts(torch, lstm_cuda, cc, cf)
        t0 = time.perf_counter()
        separate_main(["-c", str(tmp / "stream.json"), "--weights", converted,
                       "--mixed_wav", str(tmp / "mix.wav"), "--emb", str(tmp / "emb.npy"),
                       "--output", str(tmp / "served.wav"), "--streaming"])
        cli_s = time.perf_counter() - t0
        served_launches = _counts(torch, lstm_cuda, cc, cf)
        check(served_launches["lstm_fwd"] > 0 and sum(served_launches.values()) ==
              served_launches["lstm_fwd"], f"served launches {served_launches}")
        _add(launches, _check_routes(lstm_cuda, served_launches, "separate --streaming"))
        smodel = make_masknet(sconfig, streaming=True)
        smodel.load_state_dict(load_model_variables(sconfig, converted, streaming=True))
        want = StreamingSeparator(sconfig, smodel).separate(ap.load_wav(str(tmp / "mix.wav"))[None],
                                                            emb)[0]
        ap.save_wav(want, str(tmp / "want.wav"))
        served, expected = ap.load_wav(str(tmp / "served.wav")), ap.load_wav(str(tmp / "want.wav"))
        check(served.shape == expected.shape == (n,) and np.array_equal(served, expected),
              "separate --streaming differs from StreamingSeparator.separate")
        report["convert_and_serve"] = {"converted": Path(converted).name, "seconds": cli_s,
                                       "launches": served_launches, "same_bits": True}
    emit("train streaming", device=torch.cuda.get_device_name(0), **report)
    return launches


# the speaker encoders (encoder phase): GE2E trained at N x M windows of
# ENCODER_FRAMES log-mel frames, H=768, 3 layers, fp32; extraction in fixed
# batches of ENCODER_WINDOW_BATCH windows; CorentinJ at H=256 over 160-frame
# partials.  Each LSTM shape (name, T, rows, H) with the route it must take
# (with the training CLI's held-out EER batch, `_encoder_kernels`): fp32 at
# H=768 fits no cluster walk (a block's W_hh columns alone are 590 KB): the
# grid routes; H=256 one cluster.
ENCODER_N, ENCODER_M, ENCODER_FRAMES, ENCODER_HIDDEN = 16, 6, 80, 768
ENCODER_WINDOW_BATCH = 32
ENCODER_HOLDOUT = 4  # the training CLI's held-out speakers
ENCODER_SHAPES = {"ge2e_train": (ENCODER_FRAMES, ENCODER_N * ENCODER_M, ENCODER_HIDDEN, "grid"),
                  "ge2e_extract": (ENCODER_FRAMES, ENCODER_WINDOW_BATCH, ENCODER_HIDDEN, "grid"),
                  "corentinj_extract": (160, ENCODER_WINDOW_BATCH, 256, "cluster")}
ENCODER_LAUNCHES = {"lstm_fwd": 3, "bilstm_fwd": 0, "lstm_bwd": 3, "bilstm_bwd": 0}  # a GE2E step
ENCODER_WARM, ENCODER_STEPS, ENCODER_PLAIN_STEPS = 4, 20, 3  # 24 steps: the CLI's 4 more end on an interval
# a GE2E step's losses through the kernels against the plain versions (fp32,
# summation order only, three steps of Adam)
ENCODER_LOSS_TOL = 1e-4
ENCODER_EMB_TOL = 1e-4  # d-vectors (unit windows) kernels vs plain versions
# the synthetic corpus: at least 20 speakers x 4 utterances (16 train a step,
# 4 held out by the CLI's EER)
ENCODER_SPEAKERS, ENCODER_UTTERANCES, ENCODER_SECONDS = 24, 4, 2.0
ENCODER_LR = 1e-4  # the JAX CLI's default
ENCODER_REFS, ENCODER_REF_SECONDS = 8, 3.0  # extraction: references a directory


def _encoder_corpus(root: Path, seed: int) -> dict:
    """root/<speaker>/*.wav of synthetic voices (`data/synthetic.py`'s
    signal helper) from `seed`; returns speaker → wavs."""
    from voicesplit_tpu_torch.data.synthetic import _speaker_wav
    from voicesplit_tpu_torch.dsp.audio_io import save_wav_float

    sr, rng = 16000, np.random.default_rng(seed)
    n = int(ENCODER_SECONDS * sr)
    speakers = {}
    for s in range(ENCODER_SPEAKERS):
        d = root / f"spk{s:02d}"
        d.mkdir(parents=True)
        speakers[d.name] = []
        for k in range(ENCODER_UTTERANCES):
            path = str(d / f"u{k}.wav")
            save_wav_float(_speaker_wav(rng, s, n, sr), path, sr)
            speakers[d.name].append(path)
    return speakers


def _encoder_kernels(torch, lstm_cuda, seed: int) -> dict:
    """(a) `lstm_fwd` at ENCODER_SHAPES and `lstm_bwd` at the GE2E training
    shape, fp32, against their plain versions on the card (TOL, the same
    bits twice, the route), timed beside the bound (this T) and cuDNN's fp32
    `torch.nn.LSTM` (TF32 off) over the layer's input (H wide: the upper
    layers'), as a yardstick, and the backward's dW_hh kernel alone beside
    `_matmul_dwhh_ms`.  The forward also at the training CLI's held-out EER
    batch, its rows as the CLI counts them."""
    from voicesplit_tpu_torch.cli.train_encoder import eval_rows

    g = torch.Generator(device="cpu").manual_seed(seed + 15)
    out = {}
    shapes = {**ENCODER_SHAPES,
              "ge2e_eval": (ENCODER_FRAMES, eval_rows(ENCODER_HOLDOUT), ENCODER_HIDDEN, "grid")}
    for key, (T, R, H, route) in shapes.items():
        cfg = lstm_cuda.launch_config(1, R, H, torch.float32, backward=False)
        check(cfg["route"] == route, f"lstm_fwd {key}: route {cfg}")
        check(cfg["local_bytes"] == 0, f"lstm_fwd {key}: {cfg['local_bytes']} spilled bytes")
        entry = _fwd_case(torch, lstm_cuda, g, 1, R, H, route, timed=True, dtypes=("float32",), T=T)
        out[f"lstm_fwd_{key}"] = {
            "fp32": entry["float32"], "T": T, "rows": R, "H": H, "route": route, "grid": cfg,
            "library_ms": _cudnn_lstm_ms(torch, g, 1, R, H, "float32", T, H),
            **lstm_bound(1, R, "float32", H, T)}
        emit("encoder kernels", kernel="lstm_fwd", shape=key, **out[f"lstm_fwd_{key}"])
    T, R, H, route = ENCODER_SHAPES["ge2e_train"]
    cfg = lstm_cuda.launch_config(1, R, H, torch.float32, backward=True)
    check(cfg["route"] == route and cfg["resident_blocks"] >= cfg["blocks"], f"lstm_bwd ge2e_train: {cfg}")
    entry = _bwd_case(torch, lstm_cuda, g, 1, R, timed=True, H=H, route=route, dtypes=("float32",), T=T)
    out["lstm_bwd_ge2e_train"] = {
        "fp32": entry["float32"], "T": T, "rows": R, "H": H, "route": route, "grid": cfg,
        "library_ms": _cudnn_lstm_bwd_ms(torch, g, 1, R, H, "float32", T, H),
        "dwhh_ms": entry["float32"]["dwhh_ms"], "dwhh_library_ms": _matmul_dwhh_ms(torch, g, R, H, T),
        **lstm_bwd_bound(1, R, "float32", H, T)}
    emit("encoder kernels", kernel="lstm_bwd", shape="ge2e_train", **out["lstm_bwd_ge2e_train"])
    return out


def _matmul_dwhh_ms(torch, g, rows: int, H: int, T: int) -> float:
    """Yardstick of the dW_hh kernel alone: one fp32 `torch.matmul` (TF32
    off) of the same product, h_prev^T [H, T rows] times dgates [T rows, 4H]."""
    dev = torch.device("cuda")
    hp = torch.randn(H, T * rows, generator=g).to(dev)
    dg = torch.randn(T * rows, 4 * H, generator=g).to(dev)
    with torch.inference_mode():
        return time_ms(torch, lambda: torch.matmul(hp, dg), iters=20)


def phase_encoder(torch, lstm_cuda, seed: int, profile_dir, tmp: Path) -> tuple:
    """The speaker encoders at full width on the card: (a) the LSTM kernels
    at the encoders' shapes; (b) GE2E training through `train_ge2e` and the
    training CLI (under ``--profile`` also a GE2E step's device time by
    kind); (c) `cli.extract_embeddings` with each encoder, its ``-emb.npy``
    files loaded by `data/dataset.py`.  Returns the kernels' results and the
    launches of the counted runs."""
    from voicesplit_tpu_torch.cli.extract_embeddings import main as extract_main
    from voicesplit_tpu_torch.cli.train_encoder import main as train_encoder_main
    from voicesplit_tpu_torch.config import Config
    from voicesplit_tpu_torch.data.dataset import BatchIterator, SeparationDataset, discover_samples
    from voicesplit_tpu_torch.data.synthetic import _speaker_wav
    from voicesplit_tpu_torch.dsp.audio_io import save_wav_float
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.train.encoder import (
        MelSampler,
        embed_windows,
        load_encoder_checkpoint,
        make_ge2e_step,
        save_encoder_checkpoint,
        train_ge2e,
        utterance_windows,
        window_count,
    )
    from voicesplit_tpu_torch.train.state import make_adam

    kernels = _encoder_kernels(torch, lstm_cuda, seed)
    report = {"kernels": {k: {"ms": v["fp32"]["ms"], "bound_ms": v["bound_ms"],
                              "library_ms": v["library_ms"], "max_abs_err": v["fp32"]["max_abs_err"],
                              **{x: v[x] for x in ("dwhh_ms", "dwhh_library_ms") if x in v}}
                          for k, v in kernels.items()}}
    config = Config()
    ap = make_audio_processor(config)
    speakers = _encoder_corpus(tmp / "corpus", seed)

    # (b) GE2E training: the counted run of the main path, warm-up steps then
    # timed ones (each step's loss read on the host: a synchronize a step)
    kw = dict(n_speakers=ENCODER_N, m_utts=ENCODER_M, lr=ENCODER_LR, emb_dim=config.model.emb_dim,
              seed=seed, log_interval=1)
    init = train_ge2e(ap, speakers, steps=0, log=lambda s: None, **kw)[1]
    start = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    stamps = []
    n_steps = ENCODER_WARM + ENCODER_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lstm_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    encoder, model, opt_state, losses = train_ge2e(
        ap, speakers, steps=n_steps, params=start, log=lambda s: stamps.append(time.perf_counter()),
        **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lstm_cuda.LAUNCHES)
    want = {k: v * n_steps for k, v in ENCODER_LAUNCHES.items()}
    check(launches == want, f"GE2E: launches {launches} for {n_steps} steps, wanted {want}")
    counted = _check_routes(lstm_cuda, launches, "GE2E training",
                            {"forward": "grid", "backward": "grid"})
    check(all(np.isfinite(losses)) and len(losses) == n_steps, f"GE2E losses {losses}")
    step_ms = np.diff(stamps[ENCODER_WARM - 1:]) * 1e3
    # the same first steps from the same weights through the plain versions
    with _PlainVersions(lstm_cuda):
        plain = train_ge2e(ap, speakers, steps=ENCODER_PLAIN_STEPS, params=start,
                           log=lambda s: None, **kw)[3]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    check(loss_rel <= ENCODER_LOSS_TOL, f"GE2E losses {losses[:3]} vs plain {plain}")
    report["ge2e"] = {
        "N": ENCODER_N, "M": ENCODER_M, "H": ENCODER_HIDDEN, "layers": 3, "frames": ENCODER_FRAMES,
        "dtype": "float32", "lr": ENCODER_LR, "corpus": [ENCODER_SPEAKERS, ENCODER_UTTERANCES],
        "steps": n_steps, "launches": launches, "launches_per_step": ENCODER_LAUNCHES,
        "losses": losses, "plain_losses": plain, "loss_rel_vs_plain": loss_rel,
        "loss_tol": ENCODER_LOSS_TOL, "timed_steps": len(step_ms),
        "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_p75": float(np.percentile(step_ms, 75)), "wall_seconds": wall,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "w": model.w.item(), "b": model.b.item()}
    trained = str(tmp / f"encoder_{n_steps}.pt")
    save_encoder_checkpoint(trained, model, opt_state, n_steps)
    if profile_dir:
        sampler = MelSampler(ap, speakers, ENCODER_FRAMES, np.random.default_rng(seed))
        mels = torch.as_tensor(sampler.batch(ENCODER_N, ENCODER_M)[0], device="cuda")
        step = make_ge2e_step(model, make_adam(model.parameters(), ENCODER_LR), ENCODER_N, ENCODER_M)
        report["ge2e"]["profile"] = profile(torch, profile_dir, "ge2e_step", lambda: step(mels))
    del encoder, model, opt_state

    # the training CLI: a resumed run of four steps with the held-out EER
    # and a checkpoint
    t0 = time.perf_counter()
    lstm_cuda.reset_launch_counts()
    train_encoder_main(["--data_root", str(tmp / "corpus"), "--steps", str(n_steps + 4),
                        "--checkpoint_interval", "4", "--eval_interval", "4", "--log_interval", "4",
                        "--holdout_speakers", str(ENCODER_HOLDOUT),
                        "--output_path", str(tmp / "cli"), "--resume", trained])
    torch.cuda.synchronize()
    cli_launches = dict(lstm_cuda.LAUNCHES)
    # 4 steps, and one forward of the held-out EER
    want = {"lstm_fwd": 4 * 3 + 3, "bilstm_fwd": 0, "lstm_bwd": 4 * 3, "bilstm_bwd": 0}
    check(cli_launches == want, f"train_encoder CLI launches {cli_launches}, wanted {want}")
    _add(counted, _check_routes(lstm_cuda, cli_launches, "train_encoder CLI",
                                {"forward": "grid", "backward": "grid"}))
    cli_ckpt = load_encoder_checkpoint(str(tmp / "cli" / f"encoder_{n_steps + 4}.pt"))
    check(cli_ckpt["step"] == n_steps + 4, f"CLI checkpoint step {cli_ckpt['step']}")
    report["train_encoder_cli"] = {"seconds": time.perf_counter() - t0, "launches": cli_launches}

    # (c) extraction: references with mixtures and targets (triplets), one
    # shorter than a window (the sentinel); each encoder through the CLI
    sr, rng = 16000, np.random.default_rng(seed + 3)
    refs = tmp / "refs"
    refs.mkdir()
    for i in range(ENCODER_REFS + 1):
        seconds = 0.3 if i == ENCODER_REFS else ENCODER_REF_SECONDS
        save_wav_float(_speaker_wav(rng, i, int(seconds * sr), sr), str(refs / f"k{i}-ref_emb.wav"), sr)
        for role in ("mixed", "target"):
            save_wav_float(_speaker_wav(rng, i, 3 * sr, sr), str(refs / f"k{i}-{role}.wav"), sr)
    frames = {"ge2e": ap.frames_for(int(ENCODER_REF_SECONDS * sr)),
              "corentinj": 1 + (int(ENCODER_REF_SECONDS * sr) - 400) // 160}
    windows = {"ge2e": (ENCODER_FRAMES, ENCODER_FRAMES // 2), "corentinj": (160, 80)}  # (W, S)
    batches = {k: ENCODER_REFS * -(-window_count(frames[k], *windows[k]) // ENCODER_WINDOW_BATCH)
               for k in frames}
    runs = {"ge2e_random": ("ge2e", None), "ge2e_trained": ("ge2e", trained),
            "corentinj": ("corentinj", None), "speech2phone": ("speech2phone", None),
            "spectral": ("spectral", None)}
    report["extract"] = {}
    for name, (enc, ckpt) in runs.items():
        for f in refs.glob("*-emb.npy"):
            f.unlink()
        lstm_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        extract_main(["--data_dir", str(refs), "--encoder", enc]
                     + (["--encoder_checkpoint", ckpt] if ckpt else []))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(lstm_cuda.LAUNCHES)
        n_batches = batches.get(enc, 0)
        check(got == {**{k: 0 for k in got}, "lstm_fwd": 3 * n_batches},
              f"extract {name}: launches {got}, wanted {3 * n_batches} lstm_fwd")
        route = "cluster" if enc == "corentinj" else "grid"
        _add(counted, _check_routes(lstm_cuda, got, f"extract {name}", {"forward": route, "backward": route}))
        embs = [np.load(refs / f"k{i}-emb.npy") for i in range(ENCODER_REFS + 1)]
        dim = 80 if enc == "speech2phone" else 256
        check(all(e.shape == (dim,) and np.isfinite(e).all() for e in embs[:-1]),
              f"extract {name}: shapes {[e.shape for e in embs]}")
        norms = [float(np.linalg.norm(e)) for e in embs[:-1]]
        if enc in ("corentinj", "spectral"):  # renormalized
            check(max(abs(n - 1.0) for n in norms) < 1e-5, f"extract {name}: norms {norms}")
        elif enc == "ge2e":  # the mean of unit windows
            check(0.0 < min(norms) and max(norms) <= 1.0 + 1e-5, f"extract {name}: norms {norms}")
        short = embs[-1].tolist() == [0.0]
        check(short == (enc in ("ge2e", "corentinj")), f"extract {name}: short reference {embs[-1][:4]}")
        report["extract"][name] = {"seconds_per_file": seconds / (ENCODER_REFS + 1),
                                   "window_batches": n_batches, "launches": got,
                                   "launches_per_window_batch": 3 if n_batches else 0,
                                   "norms": [min(norms), max(norms)], "short_sentinel": short}
    # the trained encoder's windows through the kernels and the plain versions
    from voicesplit_tpu_torch.train.encoder import load_ge2e_encoder
    from voicesplit_tpu_torch.device import resolve_device

    enc = load_ge2e_encoder(trained, config.audio.active.num_mels, resolve_device())
    mel = ap.get_mel_bucketed(ap.load_wav(str(refs / "k0-ref_emb.wav")))
    wins = utterance_windows(mel, enc.window, enc.stride)
    kern = embed_windows(enc, wins, ENCODER_WINDOW_BATCH)
    with _PlainVersions(lstm_cuda):
        plain_embs = embed_windows(enc, wins, ENCODER_WINDOW_BATCH)
    emb_err = float(np.abs(kern - plain_embs).max())
    check(emb_err <= ENCODER_EMB_TOL, f"extract ge2e: windows vs plain {emb_err}")
    report["extract"]["ge2e_windows_vs_plain"] = emb_err
    # the -emb.npy files (the last run's are spectral; the trained GE2E's
    # again) feed the port's dataset: the sentinel dropped, one batch
    extract_main(["--data_dir", str(refs), "--encoder", "ge2e", "--encoder_checkpoint", trained])
    samples = discover_samples(str(refs), config.dataset.format)
    check(len(samples) == ENCODER_REFS, f"dataset: {len(samples)} triplets")
    batch = next(iter(BatchIterator(SeparationDataset(samples, ap, config.audio.audio_len,
                                                      config.model.emb_dim), 4, shuffle=False)))
    check(batch["emb"].shape == (4, 256) and np.isfinite(batch["emb"]).all(), "dataset batch")
    report["dataset_batch"] = {k: list(v.shape) for k, v in batch.items() if hasattr(v, "shape")}
    emit("encoder", device=torch.cuda.get_device_name(0), **report)
    return kernels, counted


# ---------------------------------------------------------------------------
# The power-law config, the reference clip, the reference import and the
# small CLIs, and the world of one
# ---------------------------------------------------------------------------

VOICEFILTER_CONFIG = "configs/voicefilter.json"
VOICEFILTER_ROUTES = ("unfused", "fused_chain")
VOICEFILTER_STEPS = 12  # timed steps on a fixed batch, each route
# the chain layers with a relu prologue: the (7,1) layer's successor to d16
RELU_PROLOGUE_LAYERS = ("5x5-d1", "5x5-d2", "5x5-d4", "5x5-d8", "5x5-d16")
REFERENCE_SECONDS = (3.0, 14.0)  # 6 windows (one batch of 32) and 34 (two)
DVECTOR_TOL = 1e-5  # d-vector, kernels vs plain versions (fp32, unit windows)
DIST_STEPS = 2  # `cli.train` steps a run in the distributed phase
DIST_ROUNDS, DIST_TIMED = 3, 10  # rounds of timed steps without, then with the group


def _fresh_step(config, seed: int, b: int):
    """A fresh full-width model of `config` from `seed`, its optimizer, state,
    train step and a B=`b` batch."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    ap = make_audio_processor(config)
    n = int(config.audio.audio_len * ap.sample_rate)
    model = weights.init_random_(make_masknet(config), seed)
    optimizer = make_optimizer(config, model)
    state = create_train_state(model, optimizer)
    step = make_train_step(config, model, ap, optimizer)
    return model, optimizer, state, step, train_batch(seed + b, b, n, ap.sample_rate,
                                                      config.model.emb_dim)


def phase_voicefilter(torch, lstm_cuda, cf, cc, seed: int, profile_dir) -> dict:
    """`configs/voicefilter.json` (relu, power-law loss, bf16) trained at full
    width at B=2 on the unfused path and on the fused chain: the counted
    step, the same step through the plain versions, the relu prologue of
    every chain layer against its plain version, step p50 / p75 and peak
    memory beside the si_snr steps' of the train phases."""
    from voicesplit_tpu_torch.config import load_config

    config = load_config(str(ROOT / VOICEFILTER_CONFIG))
    config.train_config.learning_rate = TRAIN_LR
    check(config.loss.loss_name == "power_law_compression" and config.model_name == "voicefilter",
          f"{VOICEFILTER_CONFIG}: {config.model_name}, {config.loss.loss_name}")
    b = config.train_config.batch_size
    report = {"config": VOICEFILTER_CONFIG, "loss_name": config.loss.loss_name,
              "activation": "relu", "compute_dtype": config.train_config.compute_dtype,
              "batch": b, "learning_rate": TRAIN_LR, "tolerances_unfused": TRAIN_TOL,
              "tolerances_fused_chain": FUSED_TOL}
    launches = {k: 0 for k in (*lstm_cuda.LAUNCHES, *cf.LAUNCHES)}
    for route in VOICEFILTER_ROUTES:
        with _route_env(route):
            model, optimizer, state, step, batch = _fresh_step(config, seed, b)
            report.setdefault("params", sum(p.numel() for p in model.parameters()))
            before = _snapshot(model, optimizer, state)
            _reset_counts(torch, lstm_cuda, cf)
            mk = step(state, batch)
            counted = _counts(torch, lstm_cuda, cf)
            _add(launches, counted)
            want = {**TRAIN_LAUNCHES[b], **(CONV_LAUNCHES if route == "fused_chain"
                                             else {k: 0 for k in cf.LAUNCHES})}
            check(counted == want, f"voicefilter {route}: launches per step {counted}")
            _check_routes(lstm_cuda, {k: counted[k] for k in lstm_cuda.LAUNCHES}, f"voicefilter {route}")
            loss0, gn0 = float(mk["loss"]), float(mk["grad_norm"])
            check(np.isfinite(loss0) and not bool(mk["loss_exploded"]) and gn0 > 0,
                  f"voicefilter {route}: loss {loss0}, grad_norm {gn0}")
            unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[0][k])]
            check(not unmoved, f"voicefilter {route}: unchanged after a step: {unmoved}")
            if route == "unfused":
                gk = _lstm_grads(model)
                _restore(model, optimizer, state, before)
                with _PlainVersions(lstm_cuda):
                    mp = step(state, batch)
                gp = _lstm_grads(model)
                vs_plain = {
                    "loss_rel": abs(loss0 - float(mp["loss"])) / abs(float(mp["loss"])),
                    "grad_norm_rel": abs(gn0 - float(mp["grad_norm"])) / float(mp["grad_norm"]),
                    "lstm_grad_peak_rel": {k: _peak_rel(gk[k], gp[k]) for k in gk},
                }
                for k, tol in TRAIN_TOL.items():
                    err = vs_plain[k]
                    err = max(err.values()) if isinstance(err, dict) else err
                    check(err <= tol, f"voicefilter unfused: kernels vs plain {k} {err} > {tol}")
            else:
                through = _chain_state(model)
                _restore(model, optimizer, state, before)
                with _PlainVersions(cf):
                    mp = step(state, batch)
                vs_plain = _compare_steps(torch, mk, through, mp, _chain_state(model))
                _check_step_agreement("voicefilter fused_chain: kernels vs plain", vs_plain, FUSED_TOL)
            _restore(model, optimizer, state, before)
            for _ in range(TRAIN_WARM):
                step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            for _ in range(VOICEFILTER_STEPS):
                t0 = time.perf_counter()
                losses.append(float(step(state, batch)["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
            check(all(np.isfinite(losses)) and losses[-1] < loss0,
                  f"voicefilter {route}: losses {loss0} -> {losses}")
            si_snr = REPORTS.get("train fused" if route == "fused_chain" else "train", {}).get(f"B{b}", {})
            report[route] = {
                "launches_per_step": counted, "first_loss": loss0, "first_grad_norm": gn0,
                "kernels_vs_plain": vs_plain, "steps": VOICEFILTER_STEPS,
                "step_ms_p50": float(np.percentile(times, 50)),
                "step_ms_p75": float(np.percentile(times, 75)),
                "si_snr_step_ms_p50_p75": [si_snr.get("step_ms_p50"), si_snr.get("step_ms_p75")],
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "si_snr_max_memory_allocated_bytes": si_snr.get("max_memory_allocated_bytes"),
                "losses": losses,
            }
            if profile_dir:
                report[route]["profile"] = profile(
                    torch, profile_dir, f"voicefilter_{route}", lambda: step(state, batch))
            del model, optimizer, state, step
            torch.cuda.empty_cache()
    # the relu prologue of every chain layer that has one, each kernel
    # against its plain version (bf16, the path's shape)
    g = torch.Generator(device="cpu").manual_seed(seed + 16)
    report["relu_prologue"] = {
        layer: {name: entry["errors"] for name, entry in _check_conv_case(
            torch, cf, cc, f"{layer}/relu/bfloat16", CONV_SHAPE, layer, "relu", "bfloat16", g).items()}
        for layer in RELU_PROLOGUE_LAYERS
    }
    torch.cuda.empty_cache()
    emit("voicefilter", device=torch.cuda.get_device_name(0), **report)
    return launches


def _random_embedder(torch, path: Path, seed: int) -> None:
    """A GE2E ``embedder.pt`` in the reference's layout (a 3-layer
    ``nn.LSTM(40 → 768)`` under ``lstm.``, ``proj.linear_layer``), random
    weights from `seed`."""
    torch.manual_seed(seed)
    lstm, proj = torch.nn.LSTM(40, 768, num_layers=3), torch.nn.Linear(768, 256)
    sd = {f"lstm.{k}": v for k, v in lstm.state_dict().items()}
    sd.update({f"proj.linear_layer.{k}": v for k, v in proj.state_dict().items()})
    torch.save(sd, path)


def phase_reference(torch, lstm_cuda, seed: int, tmp: Path) -> dict:
    """`cli.separate --reference_wav --encoder_checkpoint` on the card with a
    random GE2E encoder in the reference's ``embedder.pt`` layout, for a 3 s
    and a 14 s reference (one and two window batches of 32): the counted
    CLI run, the d-vector against the plain versions' and the CLI's output
    against `separate_batch` with that d-vector."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import main as separate_main
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.data.synthetic import _speaker_wav
    from voicesplit_tpu_torch.dsp.audio_io import load_wav, save_wav_float
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train.encoder import embed_reference, load_ge2e_encoder, window_count

    config_path = str(ROOT / "configs" / "voicesplit.json")
    config = load_config(config_path)
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), seed)
    weights.save(model, str(tmp / "w.pt"))
    _random_embedder(torch, tmp / "embedder.pt", seed)
    rng, sr = np.random.default_rng(seed + 17), ap.sample_rate
    n = int(config.audio.audio_len * sr)
    save_wav_float(_speaker_wav(rng, 0, n, sr) + _speaker_wav(rng, 1, n, sr), str(tmp / "mix.wav"), sr)
    enc = load_ge2e_encoder(str(tmp / "embedder.pt"), config.audio.active.num_mels, "cuda").eval()
    report = {"encoder": "GE2E, random embedder.pt (reference layout), H=768, fp32",
              "window_batch": ENCODER_WINDOW_BATCH, "dvector_tolerance": DVECTOR_TOL}
    launches = {k: 0 for k in lstm_cuda.LAUNCHES}
    for seconds in REFERENCE_SECONDS:
        ref = tmp / f"ref{seconds:g}.wav"
        save_wav_float(_speaker_wav(rng, 0, int(seconds * sr), sr), str(ref), sr)
        wav = ap.load_wav(str(ref))
        n_win = window_count(ap.get_mel(wav).shape[1], enc.window, enc.stride)
        batches = -(-n_win // ENCODER_WINDOW_BATCH)
        out = tmp / f"out{seconds:g}.wav"
        _reset_counts(torch, lstm_cuda)
        t0 = time.perf_counter()
        separate_main(["-c", config_path, "--weights", str(tmp / "w.pt"),
                       "--mixed_wav", str(tmp / "mix.wav"), "--reference_wav", str(ref),
                       "--encoder_checkpoint", str(tmp / "embedder.pt"), "--output", str(out)])
        cli_s = time.perf_counter() - t0
        counted = _counts(torch, lstm_cuda)
        _add(launches, counted)
        # the encoder's layers on [80, 32] a batch, the mask network's BiLSTM at B=1
        want = {"lstm_fwd": 3 * batches + 2, "bilstm_fwd": 0, "lstm_bwd": 0, "bilstm_bwd": 0}
        check(counted == want, f"reference {seconds:g} s: launches {counted}, wanted {want}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dvec = embed_reference(enc, ap, wav)
        embed_ms = (time.perf_counter() - t0) * 1e3
        with _PlainVersions(lstm_cuda):
            plain = embed_reference(enc, ap, wav)
        err = float(np.abs(dvec - plain).max())
        check(np.isfinite(dvec).all() and err <= DVECTOR_TOL,
              f"reference {seconds:g} s: d-vector vs plain {err} > {DVECTOR_TOL}")
        mixed = ap.load_wav(str(tmp / "mix.wav"))
        with torch.inference_mode():
            want_wav = separate_batch(model.eval(), ap, mixed[None], dvec[None])[0].cpu().numpy()
        ap.save_wav(want_wav, str(tmp / "want.wav"))
        got = load_wav(str(out))
        check(got.shape == (n,) and np.isfinite(got).all(), f"reference {seconds:g} s: output {got.shape}")
        same = out.read_bytes() == (tmp / "want.wav").read_bytes()
        check(same, f"reference {seconds:g} s: the CLI's output is not separate_batch's with its d-vector")
        report[f"{seconds:g}s"] = {"windows": n_win, "window_batches": batches, "launches": counted,
                                   "dvector_vs_plain_abs": err, "dvector_norm": float(np.linalg.norm(dvec)),
                                   "embed_ms": embed_ms, "cli_seconds": cli_s,
                                   "cli_output_equals_separate_batch": same}
    emit("reference", device=torch.cuda.get_device_name(0), **report)
    return launches


def phase_import(torch, seed: int, tmp: Path) -> dict:
    """A random full-width port model exported to the reference's layout
    (a ``checkpoint_<step>.pt`` payload, ``config_str`` a dict repr), imported
    back by `cli.import_torch`, and served through the imported checkpoint
    on the card: bit for bit the original.  Then the three small CLIs on a
    synthetic corpus: `cli.convert` on the card, `cli.generate_csv` and
    `cli.resample` on the host, seconds a file."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.convert import main as convert_main
    from voicesplit_tpu_torch.cli.generate_csv import main as generate_csv_main
    from voicesplit_tpu_torch.cli.import_torch import main as import_main
    from voicesplit_tpu_torch.cli.resample import main as resample_main
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.audio_io import load_wav
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train.checkpoint import load_model_variables
    from voicesplit_tpu_torch.train.torch_import import export_torch_state_dict

    config_path = str(ROOT / "configs" / "voicesplit.json")
    config = load_config(config_path)
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), seed).eval()
    num_freq = config.audio.active.num_freq
    ref_sd = export_torch_state_dict(model.state_dict(), num_freq, config.model.conv_out_channels)
    pt = tmp / "checkpoint_777.pt"
    torch.save({"model": ref_sd, "optimizer": {}, "step": 777, "config_str": str(config.to_dict())}, pt)
    t0 = time.perf_counter()
    path = import_main(["--torch_checkpoint", str(pt), "--output_dir", str(tmp / "imported")])
    import_s = time.perf_counter() - t0
    check(Path(path).name == "checkpoint_777.pt", f"import wrote {path}")
    imported = make_masknet(config).eval()
    imported.load_state_dict(load_model_variables(config, path))
    n = int(config.audio.audio_len * ap.sample_rate)
    mixed, emb = synthetic_batch(seed + 19, 2, n, ap.sample_rate, config.model.emb_dim)
    with torch.inference_mode():
        a = separate_batch(model, ap, mixed, emb)
        b = separate_batch(imported, ap, mixed, emb)
    same = bool(torch.equal(a, b))
    check(same, "serving through the imported checkpoint differs from the original")
    report = {"import_seconds": import_s, "serving_same_bits": same,
              "params": sum(p.numel() for p in imported.parameters())}

    # the small CLIs
    corpus = _speaker_corpus(tmp, seed)
    specs = tmp / "specs"
    specs.mkdir()
    wavs = sorted(corpus.glob("spk0/*.wav"))
    for i, w in enumerate(wavs):
        np.save(specs / f"s{i}.npy", ap.wav2spec(ap.load_wav(str(w)))[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = convert_main(["--input_dir", str(specs), "--output_dir", str(tmp / "converted"),
                            "-c", config_path])
    convert_s = time.perf_counter() - t0
    check(len(written) == len(wavs) and all(np.isfinite(load_wav(p)).all() for p in written),
          f"convert wrote {written}")
    t0 = time.perf_counter()
    rows = generate_csv_main(["--dataset_dir", str(corpus), "--output", str(tmp / "dev.csv"),
                              "--audio_len", str(CORPUS_SECONDS - 0.5), "--seed", str(seed)])
    csv_s = time.perf_counter() - t0
    check(len(rows) == CORPUS_SPEAKERS * (CORPUS_SPEAKERS - 1), f"generate_csv: {len(rows)} rows")
    tree = tmp / "tree"
    shutil.copytree(corpus / "spk0", tree / "spk0")
    t0 = time.perf_counter()
    done = resample_main(["--root", str(tree), "--num_workers", "2"])
    resample_s = time.perf_counter() - t0
    check(done[0] == done[1] > 0, f"resample processed {done}")
    report["small_clis"] = {
        "convert": {"files": len(written), "seconds_per_file": convert_s / len(written),
                    "device": "cuda"},
        "generate_csv": {"rows": len(rows), "seconds": csv_s,
                         "wavs": CORPUS_SPEAKERS * CORPUS_UTTERANCES, "device": "host"},
        "resample": {"files": done[1], "seconds_per_file": resample_s / done[1],
                     "workers": 2, "device": "host"},
    }
    emit("import", device=torch.cuda.get_device_name(0), **report)
    return {}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _checkpoint_bits(torch, path: str) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=False)
    return {**payload["model"], **payload["batch_stats"]}


def _step_times(torch, step, state, batch, n: int) -> list:
    """Host-clock ms of `n` synchronized steps."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _world_of_one_step(torch, lstm_cuda, cf, route: str, step, state, batch, launches: dict,
                       profile_dir) -> dict:
    """Under the group: one counted step (exact launches), then 3 profiled
    steps for the NCCL kernels and the all-reduce calls a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    b = len(batch["mixed_wav"])
    _reset_counts(torch, lstm_cuda, cf)
    m = step(state, batch)
    counted = _counts(torch, lstm_cuda, cf)
    _add(launches, counted)
    want = {**TRAIN_LAUNCHES[b], **(CONV_LAUNCHES if route == "fused_chain"
                                     else {k: 0 for k in cf.LAUNCHES})}
    check(counted == want and np.isfinite(float(m["loss"])),
          f"distributed {route}: launches {counted}, loss {float(m['loss'])}")
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
    nccl = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and kernel_kind(e.name) == "collectives"]
    calls: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and "allreduce" in e.name.replace("_", "").lower():
            calls[e.name] = calls.get(e.name, 0) + 1 / 3
    out = {
        "launches_per_step": counted,
        "nccl_kernels_per_step": len(nccl) / 3,
        "nccl_kernel_ms_per_step": sum(e.time_range.elapsed_us() for e in nccl) / 3e3,
        "nccl_kernel_names": sorted({e.name for e in nccl})[:4],
        "all_reduce_events_per_step": calls,
    }
    if profile_dir:
        out["profile"] = profile(torch, profile_dir, f"distributed_{route}",
                                 lambda: step(state, batch))
    return out


def phase_distributed(torch, lstm_cuda, cf, seed: int, profile_dir, tmp: Path) -> dict:
    """A world of one on the card: `initialize_distributed` with NCCL, one
    B=2 step of each route counted and profiled under the group (the
    BatchNorm and gradient all-reduces run; NCCL kernels timed), its steps
    timed in rounds against the same steps with no group, then
    `cli.train --coordinator --num_processes 1 --process_id 0` for
    DIST_STEPS steps on each route against the same run with no group: the
    weights after every step bit for bit."""
    import torch.distributed as dist

    from voicesplit_tpu_torch.cli.train import main as train_main
    from voicesplit_tpu_torch.parallel.mesh import initialize_distributed, world_size

    config_path, config = _trainer_config(tmp, seed, n_train=4, n_eval=2, ckpt_every=1)
    b = config.train_config.batch_size
    report = {"config": "configs/voicesplit.json", "batch": b, "steps": DIST_STEPS}
    launches = {k: 0 for k in (*lstm_cuda.LAUNCHES, *cf.LAUNCHES)}
    prev = torch.backends.cudnn.deterministic
    # both runs of a pair must be reproducible for their bits to be compared
    torch.backends.cudnn.deterministic = True
    try:
        for route in VOICEFILTER_ROUTES:
            with _route_env(route):
                model, optimizer, state, step, batch = _fresh_step(config, seed, b)
                for _ in range(TRAIN_WARM):
                    step(state, batch)
                # rounds of steps without and with the group, in turns
                times = {"no_group": [], "world_of_one": []}
                for rnd in range(DIST_ROUNDS):
                    times["no_group"] += _step_times(torch, step, state, batch, DIST_TIMED)
                    check(initialize_distributed(f"localhost:{_free_port()}", 1, 0),
                          "initialize_distributed did not start a world of one")
                    check(dist.get_backend() == "nccl" and world_size() == 1,
                          f"group {dist.get_backend()}, world {world_size()}")
                    if rnd == 0:
                        report[route] = _world_of_one_step(
                            torch, lstm_cuda, cf, route, step, state, batch, launches, profile_dir)
                    times["world_of_one"] += _step_times(torch, step, state, batch, DIST_TIMED)
                    dist.destroy_process_group()
                report[route]["step_ms_p50_p75"] = {
                    k: [float(np.percentile(v, q)) for q in (50, 75)] for k, v in times.items()}
                report[route]["timed_rounds"] = [DIST_ROUNDS, DIST_TIMED]
                del model, optimizer, state, step
                torch.cuda.empty_cache()

        # the training CLI in a world of one against no group, per route
        for route in VOICEFILTER_ROUTES:
            runs = {}
            with _route_env(route):
                for name, group in (("no_group", False), ("world_of_one", True), ("no_group_again", False)):
                    logs = tmp / f"{route}_{name}"
                    argv = ["-c", config_path, "--logs_path", str(logs), "--max_steps", str(DIST_STEPS)]
                    if group:
                        argv += ["--coordinator", f"localhost:{_free_port()}",
                                 "--num_processes", "1", "--process_id", "0"]
                    t0 = time.perf_counter()
                    res = train_main(argv)
                    check(res["step"] == DIST_STEPS and not dist.is_initialized(),
                          f"distributed {route} {name}: {res}")
                    runs[name] = (logs, time.perf_counter() - t0, res)
            same = {}
            for s in range(1, DIST_STEPS + 1):
                ck = {k: _checkpoint_bits(torch, str(v[0] / f"checkpoint_{s}.pt")) for k, v in runs.items()}
                same[s] = all(torch.equal(ck["world_of_one"][k], v) for k, v in ck["no_group"].items())
                again = all(torch.equal(ck["no_group_again"][k], v) for k, v in ck["no_group"].items())
                check(again, f"distributed {route}: two runs without a group differ at step {s}")
                check(same[s], f"distributed {route}: step {s} with a group of one differs from no group")
            report[route]["cli"] = {
                "same_bits_by_step": same,
                "seconds": {k: v[1] for k, v in runs.items()},
                "losses": {k: v[2].get("loss") for k, v in runs.items()},
            }
    finally:
        torch.backends.cudnn.deterministic = prev
        if dist.is_initialized():
            dist.destroy_process_group()
    emit("distributed", device=torch.cuda.get_device_name(0), **report)
    return launches


# --- long-form separation (`parallel/sequence.py`) ----------------------------
LONG_SECONDS = 120.0  # 12,001 frames at the 160-sample hop
# in-process shard counts: 2 (6,001 frames a shard, 1 of padding) and 4
# (3,001 a shard, 12,004 padded frames, 3 of padding)
LONG_SHARDS = (2, 4)
# The sharded mask against the world of one's.  Every operation the port
# runs is the same on a shard's window as on the whole utterance (the kernels,
# the elementwise ops, the relay, and the library matmuls and convs of the
# other layers), except two library calls that choose their kernel by shape:
# cuDNN's conv1 (1x7, one input channel) on some window lengths, and
# cuBLAS's fc2 ([rows, 600] @ [600, 601]) on some row counts, each then one
# bf16 rounding away (`scripts/port_sp_bits.py` on an H100: at 120 s two
# shards give the same bits, three and four differ by 4.9e-4 of the mask).
# Where the bits differ, only those operations may (`_sp_differences`), and
# the mask (values in [0, 1]) by at most LONG_SHARDED_TOL: one rounding of a
# logit is at most 2^-8 of it, through the sigmoid's slope of 1/4.
LIBRARY_SHAPE_OPS = ("conv1 conv", "fc2")
LONG_SHARDED_TOL = 2e-3
LONG_ROUTES = ("library", "dilated")  # VOICESPLIT_PALLAS_CONV off, on
LONG_CALLS = 3  # timed calls a pass, each over the whole 120 s
LONG_WINDOW = 301  # frames of the kernels' plain-version comparisons at the long-form shapes
# launches of a world-of-one call by conv route: each LSTM direction once, as
# `separate_batch` at B=1, and conv2 … conv7 through the kernel with the switch
LONG_LAUNCHES = {"library": {"lstm_fwd": 2, "bilstm_fwd": 0, "conv_dilated_fwd": 0, "conv_bn_act_eval": 0},
                 "dilated": {"lstm_fwd": 2, "bilstm_fwd": 0, "conv_dilated_fwd": 0, "conv_bn_act_eval": 6}}


def long_sharded_launches(n_shards: int, valid_shards: int, dilated: bool) -> dict:
    """Launches of K in-process shards: each direction takes K-1 relay rounds
    and one output scan, one `lstm_fwd` each on every shard with a valid
    frame (2·K² with no empty shard: 32 at K=4); every shard runs the conv
    stack (6 `conv_bn_act_eval` with the switch)."""
    return {"lstm_fwd": 2 * n_shards * valid_shards, "bilstm_fwd": 0, "conv_dilated_fwd": 0,
            "conv_bn_act_eval": 6 * n_shards if dilated else 0}


def _sp_differences(torch, lstm_cuda, model, spec, emb, n_shards: int, shard: int = 1) -> dict:
    """The operations of one shard of the in-process sharded pass whose
    output differs from the world of one's when both get the same inputs:
    each conv block's raw conv output (on the dilated switch's kernel layers
    the eval-mode block's output, which one kernel computes; its input the
    world of one's block input, cut to the shard's window with the sharded
    pass's halos and edge mask), the LSTM input projection, `lstm_fwd` from the true carry, fc1
    and fc2 (each over the shard's rows against the utterance's).  A
    library call that picks its kernel by shape shows here."""
    import torch.nn.functional as tnf

    from voicesplit_tpu_torch.ops.conv_cuda import conv2d_bn_act_eval, pallas_conv_enabled, takes_layer
    from voicesplit_tpu_torch.parallel import sequence

    T = spec.shape[1]
    Tp = sequence.pad_frames(T, n_shards, model.conv_context_left)
    Tc = Tp // n_shards
    lo, hi = model.conv_context_left, model.conv_context_right
    cd, lstm = model.compute_dtype, model.lstm
    g = torch.arange(shard * Tc - lo, (shard + 1) * Tc + hi, device=spec.device)
    valid = ((g >= 0) & (g < T)).to(cd)[None, None, :, None]
    rows = slice(shard * Tc, min((shard + 1) * Tc, T))
    n = rows.stop - rows.start

    def window(x):  # [B, C, T, F] → the shard's window, zeros outside [0, T), masked
        x = tnf.pad(x, (0, 0, lo, Tp - T + hi))
        return x[:, :, shard * Tc:(shard + 1) * Tc + lo + hi] * valid

    def raw(block, x):
        c = block.conv
        if pallas_conv_enabled() and takes_layer((*c.kernel_size, c.in_channels, c.out_channels), c.dilation):
            y = conv2d_bn_act_eval(x.to(cd).permute(0, 2, 3, 1).contiguous(), c.weight.permute(2, 3, 1, 0),
                                   c.bias, block.bn, block.activation, c.dilation)
            return y.permute(0, 3, 1, 2)
        seen = []
        orig = block.bn_act
        block.bn_act = lambda y: seen.append(y) or orig(y)
        try:
            block(x)
        finally:
            del block.bn_act
        return seen[0]

    def diff(a, b):
        return None if torch.equal(a, b) else (a.float() - b.float()).abs().max().item()

    out = {"shard": shard, "shards": n_shards, "differs": {}}
    with torch.inference_mode():
        x = spec.to(cd)[:, None]
        for name in model.block_names:
            block = getattr(model, name)
            y_full = raw(block, x)
            y_win = raw(block, window(x))[:, :, lo:lo + n]
            d = diff(y_win, y_full[:, :, rows])
            if d is not None:
                out["differs"][f"{name} conv"] = d
            x = block.bn_act(y_full)
        feats = x.permute(0, 2, 3, 1).reshape(x.shape[0], T, -1)
        emb_t = emb.to(cd)[:, None, :].expand(feats.shape[0], T, model.emb_dim)
        xc = torch.cat([feats, emb_t], dim=-1).to(cd)

        def proj(v):
            return v @ lstm.fwd_w_ih.to(cd) + lstm.fwd_b.to(cd)

        xp = proj(xc)
        d = diff(proj(xc[:, rows]), xp[:, rows])
        if d is not None:
            out["differs"]["LSTM input projection"] = d
        w = lstm.fwd_w_hh.to(cd)
        z = torch.zeros(xp.shape[0], lstm.hidden, device=spec.device)
        hs, cs, _ = lstm_cuda.lstm_fwd(xp.transpose(0, 1).contiguous(), w, z, z)
        s0 = rows.start
        h0 = hs[s0 - 1].contiguous() if s0 else z
        c0 = cs[s0 - 1].contiguous() if s0 else z
        hs1, _, _ = lstm_cuda.lstm_fwd(xp[:, rows].transpose(0, 1).contiguous(), w, h0, c0)
        d = diff(hs1, hs[rows])
        if d is not None:
            out["differs"]["lstm_fwd from the true carry"] = d
        h = torch.relu(torch.cat([hs, hs], dim=-1).transpose(0, 1).to(cd))
        f = torch.relu(model._dense(model.fc1, h))
        d = diff(torch.relu(model._dense(model.fc1, h[:, rows])), f[:, rows])
        if d is not None:
            out["differs"]["fc1"] = d
        d = diff(model._dense(model.fc2, f[:, rows]), model._dense(model.fc2, f)[:, rows])
        if d is not None:
            out["differs"]["fc2"] = d
    return out


def _long_cli(torch, lstm_cuda, config, ap, model, wav, emb) -> dict:
    """`cli.separate.main --sequence_parallel` on the long mixture written as
    a wav (no process group: a world of one): its file is the default
    serving path's, byte for byte, with 2 `lstm_fwd` launches."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli import separate

    with tempfile.TemporaryDirectory(prefix="voicesplit_long_") as d:
        tmp = Path(d)
        weights.save(model, str(tmp / "w.pt"))
        ap.save_wav(wav[0], str(tmp / "mix.wav"))
        np.save(tmp / "emb.npy", emb[0])
        args = ["-c", str(ROOT / "configs" / "voicesplit.json"), "--weights", str(tmp / "w.pt"),
                "--mixed_wav", str(tmp / "mix.wav"), "--emb", str(tmp / "emb.npy")]
        _reset_counts(torch, lstm_cuda)
        t0 = time.perf_counter()
        separate.main(args + ["--output", str(tmp / "long.wav"), "--sequence_parallel"])
        seconds = time.perf_counter() - t0
        launches = _counts(torch, lstm_cuda)["lstm_fwd"]
        separate.main(args + ["--output", str(tmp / "batch.wav")])
        same = (tmp / "long.wav").read_bytes() == (tmp / "batch.wav").read_bytes()
    check(same and launches == 2,
          f"cli.separate --sequence_parallel: same file {same}, {launches} lstm_fwd launches")
    return {"same_file_as_the_default_path": same, "lstm_fwd": launches, "seconds": seconds}


def _relay_exact(torch, lstm_cuda, model, spec, emb, n_shards: int) -> dict:
    """The carry relay alone at the long-form shapes: the world of one's
    LSTM inputs (both directions) cut into `n_shards` in-process shards with
    the alignment padding as `separate_long` pads them, through
    `sequence._relay_scan`, against `BiLSTM`'s two `lstm_fwd` over the
    whole utterance: the same bits, by direction."""
    from voicesplit_tpu_torch.parallel import sequence

    T = spec.shape[1]
    Tp = sequence.pad_frames(T, n_shards, model.conv_context_left)
    Tc = Tp // n_shards
    cd, lstm = model.compute_dtype, model.lstm
    n_valid = [min(max(T - d * Tc, 0), Tc) for d in range(n_shards)]
    out = {}
    with torch.inference_mode():
        feats = model.conv_features(spec)
        emb_t = emb.to(cd)[:, None, :].expand(1, T, model.emb_dim)
        xc = torch.cat([feats, emb_t], dim=-1).to(cd)
        z = torch.zeros(1, lstm.hidden, device=spec.device)
        for d, reverse in (("fwd", False), ("bwd", True)):
            xp = xc @ getattr(lstm, f"{d}_w_ih").to(cd) + getattr(lstm, f"{d}_b").to(cd)
            w = getattr(lstm, f"{d}_w_hh").to(cd)
            seq_in = (xp.flip(1) if reverse else xp).transpose(0, 1).contiguous()
            hs, _, _ = lstm_cuda.lstm_fwd(seq_in, w, z, z)
            want = hs.flip(0) if reverse else hs
            xp_p = torch.nn.functional.pad(xp, (0, 0, 0, Tp - T))
            shards = [xp_p[:, i * Tc:(i + 1) * Tc] for i in range(n_shards)]
            got = torch.cat(sequence._relay_scan(shards, w, reverse, n_valid,
                                                 sequence.InProcessExchange(n_shards)), dim=0)[:T]
            out[d] = torch.equal(got, want)
    return out


def _long_kernel_windows(torch, lstm_cuda, cc, model, seed: int) -> dict:
    """The forward kernels at the long-form path's shapes, on a window of
    LONG_WINDOW frames, against their plain versions on the card: `lstm_fwd`
    at B=1 from a nonzero carry (as every relay round after the first runs
    it) and `conv_dilated_fwd` on `[1, LONG_WINDOW, 601, 64]` with the last
    frames zero (the edge mask's halo and padding), bf16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    H = model.lstm.hidden
    w = model.lstm.fwd_w_hh.to(bf)
    out = {}
    with torch.inference_mode():
        z = torch.zeros(1, H, device="cuda")
        xp0 = (0.5 * torch.randn(LONG_WINDOW, 1, 4 * H, device="cuda", generator=g)).to(bf)
        hs0, cs0, _ = lstm_cuda.lstm_fwd(xp0, w, z, z)
        h0, c0 = hs0[-1].contiguous(), cs0[-1].contiguous()  # a carry, as the relay passes it
        xp = (0.5 * torch.randn(LONG_WINDOW, 1, 4 * H, device="cuda", generator=g)).to(bf)
        got, again = lstm_cuda.lstm_fwd(xp, w, h0, c0), lstm_cuda.lstm_fwd(xp, w, h0, c0)
        want = lstm_cuda.lstm_fwd_ref(xp, w, h0, c0)
        err = max((a - b).abs().max().item() for a, b in zip(got[:2], want[:2]))
        check(err <= TOL["bfloat16"], f"lstm_fwd from a carry vs plain: {err} > {TOL['bfloat16']}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)), "lstm_fwd from a carry: two launches differ")
        out["lstm_fwd_from_carry"] = {
            "shape": [LONG_WINDOW, 1, 4 * H], "max_abs_err": err,
            "ms": time_ms(torch, lambda: lstm_cuda.lstm_fwd(xp, w, h0, c0), 10),
            "plain_ms": time_ms(torch, lambda: lstm_cuda.lstm_fwd_ref(xp, w, h0, c0), 1, warmup=0),
            **lstm_bound(1, 1, "bfloat16", H=H, T=LONG_WINDOW)}
        block = model.conv7  # (5, 5) at time dilation 16
        wc = block.conv.weight.permute(2, 3, 1, 0).to(bf).contiguous()
        x = torch.randn(1, LONG_WINDOW, 601, 64, device="cuda", generator=g).to(bf)
        x[:, -(LONG_WINDOW // 4):] = 0
        dt = block.conv.dilation[0]
        got, again = cc.conv_dilated_fwd(x, wc, dt), cc.conv_dilated_fwd(x, wc, dt)
        errs = {"out": _peak_rel(got, cc.conv_dilated_fwd_ref(x, wc, dt)),
                "out_round_once": _peak_rel(got, cc.conv_dilated_fwd_round_once_ref(x, wc, dt))}
        for k, v in errs.items():
            check(v <= DILATED_TOL["bfloat16"][k], f"conv_dilated_fwd on a masked window: {k} {v}")
        check(torch.equal(got, again), "conv_dilated_fwd on a masked window: two launches differ")
        out["conv_dilated_fwd_masked_window"] = {
            "shape": list(x.shape), "dt": dt, "errors": errs,
            "ms": time_ms(torch, lambda: cc.conv_dilated_fwd(x, wc, dt), 10),
            "plain_ms": time_ms(torch, lambda: cc.conv_dilated_fwd_ref(x, wc, dt), 2),
            **conv_bound("conv_dilated_fwd", tuple(x.shape), 5, 5, dt, "bfloat16")}
    return out


def phase_long(torch, lstm_cuda, cc, seed: int) -> dict:
    """`parallel.sequence.separate_long` on a LONG_SECONDS mixture at full
    width, B=1, on each conv route: a world of one (no process group) against
    `separate_batch` on the same clip, bit for bit, with exact launches; the
    mask of each of LONG_SHARDS in-process shard counts (halos, the carry
    relay, the padded tail) against the world of one's, bit for bit or
    differing only in LIBRARY_SHAPE_OPS and within LONG_SHARDED_TOL, with
    exact launches; the relay alone bit for bit (`_relay_exact`); p50 and
    peak memory of each pass; the kernels at the path's shapes against their
    plain versions on a window; and the longest utterance a world of one
    takes before the 32-bit index limit, run, and one frame more refused."""
    import torch.nn.functional as tnf

    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.parallel import sequence

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), seed)
    n = int(LONG_SECONDS * ap.sample_rate)
    wav, emb = synthetic_batch(seed + 11, 1, n, ap.sample_rate, config.model.emb_dim)
    e = torch.as_tensor(emb, device="cuda")
    with torch.inference_mode():
        spec, _ = ap.wav2spec_batch(torch.as_tensor(wav, device="cuda"))
    T, F = spec.shape[1:]
    one = sequence.make_sp_mask_fn(model, sequence.InProcessExchange(1))
    shardings = {}
    for K in LONG_SHARDS:
        Tp = sequence.pad_frames(T, K, model.conv_context_left)
        Tc = Tp // K
        spec_p = tnf.pad(spec, (0, 0, 0, Tp - T))
        fn = sequence.make_sp_mask_fn(model, sequence.InProcessExchange(K))

        def sharded_mask(fn=fn, spec_p=spec_p):
            with torch.inference_mode():
                return fn(spec_p, e, T)

        shardings[K] = {"padded_frames": Tp, "frames_a_shard": Tc,
                        "valid_shards": sum(1 for d in range(K) if T - d * Tc > 0),
                        "run": sharded_mask}

    report = {"seconds": LONG_SECONDS, "frames": T,
              "shards": {K: {k: v for k, v in sh.items() if k != "run"} for K, sh in shardings.items()}}
    by_path = {}
    t_phase = time.perf_counter()
    for route in LONG_ROUTES:
        r = {}
        with _Env("VOICESPLIT_PALLAS_CONV", "1" if route == "dilated" else "0"):
            _reset_counts(torch, lstm_cuda, cc)
            out = sequence.separate_long(config, model, wav[0], emb[0])
            counted = _counts(torch, lstm_cuda, cc)
            _check_routes(lstm_cuda, counted, f"long {route}")
            want = separate_batch(model, ap, wav, emb)[0].cpu().numpy()
            check(out.shape == (n,) and bool(np.isfinite(out).all()), f"long {route}: output")
            r["world_of_one_same_bits_as_separate_batch"] = bool(np.array_equal(out, want))
            r["world_of_one_max_abs_diff"] = float(np.abs(out - want).max())
            check(r["world_of_one_same_bits_as_separate_batch"],
                  f"long {route}: separate_long differs from separate_batch by "
                  f"{r['world_of_one_max_abs_diff']}")
            r["launches_world_of_one"] = {k: counted[k] for k in LONG_LAUNCHES[route]}
            check(r["launches_world_of_one"] == LONG_LAUNCHES[route],
                  f"long {route}: launches {r['launches_world_of_one']}, wanted {LONG_LAUNCHES[route]}")
            by_path[route] = [counted]

            with torch.inference_mode():
                mask_1 = one(spec, e, T)
            for K, sh in shardings.items():
                _reset_counts(torch, lstm_cuda, cc)
                mask_k = sh["run"]()[:, :T]
                counted_k = _counts(torch, lstm_cuda, cc)
                _check_routes(lstm_cuda, counted_k, f"long {route}, {K} shards")
                rk = {"same_bits_as_world_of_one": torch.equal(mask_k, mask_1),
                      "max_abs_diff": (mask_k - mask_1).abs().max().item()}
                if not rk["same_bits_as_world_of_one"]:
                    rk["ops_that_differ"] = _sp_differences(torch, lstm_cuda, model, spec, e, K)["differs"]
                    check(set(rk["ops_that_differ"]) <= set(LIBRARY_SHAPE_OPS)
                          and rk["max_abs_diff"] <= LONG_SHARDED_TOL,
                          f"long {route}: the {K}-shard mask differs from the world of one's: {rk}")
                expected = long_sharded_launches(K, sh["valid_shards"], route == "dilated")
                rk["launches"] = {k: counted_k[k] for k in expected}
                check(rk["launches"] == expected,
                      f"long {route}: {K}-shard launches {rk['launches']}, wanted {expected}")
                by_path[route].append(counted_k)
                r[f"shards_{K}"] = rk

            timed = [("separate_long", lambda: sequence.separate_long(config, model, wav[0], emb[0])),
                     ("separate_batch", lambda: separate_batch(model, ap, wav, emb))]
            timed += [(f"sharded_mask_{K}", sh["run"]) for K, sh in shardings.items()]
            for name, fn in timed:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                p50, p75 = _latency_ms(torch, fn, LONG_CALLS)
                r[name] = {"p50_ms": p50, "p75_ms": p75,
                           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "audio_s_per_s": LONG_SECONDS / (p50 / 1e3)}
        report[route] = r
    report["cli"] = _long_cli(torch, lstm_cuda, config, ap, model, wav, emb)
    report["relay_exact"] = _relay_exact(torch, lstm_cuda, model, spec, e, max(LONG_SHARDS))
    check(all(report["relay_exact"].values()), f"long: the relay differs: {report['relay_exact']}")
    report["kernels_on_windows"] = _long_kernel_windows(torch, lstm_cuda, cc, model, seed)

    # the longest utterance a world of one takes: B·T·F·C within 32-bit indexing
    limit = sequence.MAX_CONV_ELEMENTS // (F * model.conv_channels)
    longest = {"frames": limit, "seconds": (limit - 1) * ap.hop_length / ap.sample_rate}
    long_wav = np.resize(wav[0], (limit - 1) * ap.hop_length)
    for route in LONG_ROUTES:
        with _Env("VOICESPLIT_PALLAS_CONV", "1" if route == "dilated" else "0"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = sequence.separate_long(config, model, long_wav, emb[0])
            check(out.shape == long_wav.shape and bool(np.isfinite(out).all()),
                  f"long {route}: the longest utterance's output")
            longest[route] = {"seconds_a_call": time.perf_counter() - t0,
                              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            try:
                sequence.separate_long(config, model, np.resize(long_wav, len(long_wav) + ap.hop_length),
                                       emb[0])
                refused = None
            except ValueError as err:
                refused = str(err)
            check(refused is not None and "at most" in refused,
                  f"long {route}: one frame past the limit was not refused")
            longest[route]["one_frame_more"] = refused
    # what the limit guards: the library conv of conv1 (every route runs it)
    # one frame past it
    with torch.inference_mode():
        try:
            torch.nn.functional.conv2d(
                torch.zeros(1, 1, limit + 1, F, dtype=torch.bfloat16, device="cuda"),
                model.conv1.conv.weight.to(torch.bfloat16), padding=model.conv1.conv.padding)
            torch.cuda.synchronize()
            longest["library_conv1_one_frame_more"] = "ran"
        except RuntimeError as err:
            longest["library_conv1_one_frame_more"] = f"raised: {str(err).splitlines()[0]}"
    torch.cuda.empty_cache()
    report["longest_world_of_one"] = longest
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit("long", device=torch.cuda.get_device_name(0), **report)
    out = {}
    for runs in by_path.values():
        for counted in runs:
            _add(out, {k: counted[k] for k in ("lstm_fwd", "bilstm_fwd", "conv_dilated_fwd", "conv_bn_act_eval")})
    return out


# --- export (`export.py`): programs saved, loaded cold, launched ------------
EXPORT_SECONDS = 3.0
EXPORT_BATCHES = (1, 3, 8)  # the symbolic-batch program's calls
EXPORT_PINNED = 8  # the pinned-batch program's batch (`bilstm_fwd`)
EXPORT_CHUNKS = 4  # chunks threaded through the streaming program at B=1
# B=8 through the symbolic-batch program (two `lstm_fwd`) against the eager
# model (one `bilstm_fwd`): bf16 products over other row groups, waveform
# relative to its peak (WIDE_SEPARATE_TOL's bound)
EXPORT_B8_TOL = 5e-3
# launches inside the loaded programs, by run (every forward on the cluster walk)
EXPORT_LAUNCHES = {
    **{f"symbolic_B{b}": {"lstm_fwd": 2, "bilstm_fwd": 0, "conv_bn_act_eval": 0}
       for b in EXPORT_BATCHES},
    "symbolic_dilated_B1": {"lstm_fwd": 2, "bilstm_fwd": 0, "conv_bn_act_eval": 6},
    f"pinned_B{EXPORT_PINNED}": {"lstm_fwd": 0, "bilstm_fwd": 1, "conv_bn_act_eval": 0},
    "chunks": {"lstm_fwd": EXPORT_CHUNKS, "bilstm_fwd": 0, "conv_bn_act_eval": 0},
}

# A fresh interpreter that loads the saved programs with nothing of the port
# but its kernels' operators, runs them on the card with the launch counters
# zeroed before each run, times the B=1 call and the chunk, and checks that no
# model, DSP or streaming module (nor JAX) was imported.
COLD_RUN = r'''
import json, sys, time
import numpy as np
import torch
import voicesplit_tpu_torch.ops  # registers the kernels' operators
from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda

spec = json.load(open(sys.argv[1]))
data = np.load(spec["inputs"])
dev = lambda k: torch.as_tensor(data[k], device="cuda")
report = {"launches": {}, "routes": {}, "load_seconds": {}, "graph_calls": {}}
outs = {}


def load(name):
    t0 = time.perf_counter()
    program = torch.export.load(spec["programs"][name]).module()
    report["load_seconds"][name] = time.perf_counter() - t0
    report["graph_calls"][name] = sum(n.op == "call_function" for n in program.graph.nodes)
    return program


def counted(name, fn):
    torch.cuda.synchronize()
    lstm_cuda.reset_launch_counts(); conv_cuda.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    report["launches"][name] = {**lstm_cuda.LAUNCHES, **conv_cuda.LAUNCHES}
    report["routes"][name] = dict(lstm_cuda.ROUTES)
    return res


def p50_ms(fn, calls):
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter(); fn(); torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50))


with torch.no_grad():
    sep = load("symbolic")
    for b in spec["batches"]:
        outs[f"symbolic_B{b}"] = counted(f"symbolic_B{b}", lambda: sep(dev(f"wav{b}"), dev(f"emb{b}")))
    report["symbolic_B1_p50_ms"] = p50_ms(lambda: sep(dev("wav1"), dev("emb1")), spec["calls"])
    sep_dil = load("symbolic_dilated")
    outs["symbolic_dilated_B1"] = counted("symbolic_dilated_B1", lambda: sep_dil(dev("wav1"), dev("emb1")))
    pinned = load("pinned")
    b = spec["pinned"]
    outs[f"pinned_B{b}"] = counted(f"pinned_B{b}", lambda: pinned(dev(f"wav{b}"), dev(f"emb{b}")))
    step = load("chunk")
    state = [dev(f"state{i}") for i in range(6)]

    def chunks():
        s, res = state, []
        for i in range(spec["chunks"]):
            *s, o = step(*s, dev(f"chunk{i}"), dev("chunk_emb"))
            res.append(o)
        return torch.cat(res, dim=-1), s

    stream, final = counted("chunks", chunks)
    outs["chunks"] = stream
    for i, f in enumerate(final):
        outs[f"final_state{i}"] = f
    report["chunk_p50_ms"] = p50_ms(lambda: step(*state, dev("chunk0"), dev("chunk_emb")), spec["calls"])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "voicesplit_tpu")
       or m.startswith(("voicesplit_tpu_torch.models", "voicesplit_tpu_torch.dsp",
                        "voicesplit_tpu_torch.streaming", "voicesplit_tpu_torch.export"))]
report["model_modules_loaded"] = bad
np.savez(spec["outputs"], **{k: v.float().cpu().numpy() for k, v in outs.items()})
print("COLD " + json.dumps(report))
'''


def run_programs_cold(programs: dict, inputs: Path, outputs: Path, calls: int) -> dict:
    """Runs COLD_RUN on `programs` ({"symbolic", "symbolic_dilated",
    "pinned", "chunk"}: path) and the arrays of `inputs` in a fresh
    interpreter; returns its report, the outputs in `outputs` (``.npz``)."""
    spec = {"programs": {k: str(v) for k, v in programs.items()}, "inputs": str(inputs),
            "outputs": str(outputs), "batches": list(EXPORT_BATCHES), "pinned": EXPORT_PINNED,
            "chunks": EXPORT_CHUNKS, "calls": calls}
    spec_path = outputs.with_suffix(".json")
    spec_path.write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", COLD_RUN, str(spec_path)], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"cold load failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    lines = [line for line in proc.stdout.splitlines() if line.startswith("COLD ")]
    check(len(lines) == 1, f"cold load printed no report:\n{proc.stdout[-2000:]}")
    report = json.loads(lines[0][5:])
    check(not report["model_modules_loaded"],
          f"the cold load imported model code: {report['model_modules_loaded']}")
    for run, want in EXPORT_LAUNCHES.items():
        got = {k: report["launches"][run][k] for k in want}
        check(got == want, f"cold {run}: launches {got}, wanted {want}")
        routes = report["routes"][run]
        check(routes["cluster"] == want["lstm_fwd"] + want["bilstm_fwd"] == sum(routes.values()),
              f"cold {run}: forward routes {routes}")
    return report


def export_programs(torch, config, model, smodel, tmp: Path) -> dict:
    """Exports the full-width separator (symbolic batch; symbolic with
    ``VOICESPLIT_PALLAS_CONV=1``; batch pinned to EXPORT_PINNED) and the
    streaming chunk step through `cli.export.main` from trainer checkpoints
    of `model` and of the streaming `smodel`, for the card (the CLI's
    default platform); returns ``{name: (path, seconds to export)}`` and the
    chunk step's manifest."""
    from voicesplit_tpu_torch.cli import export as export_cli
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer
    from voicesplit_tpu_torch.train.checkpoint import save_checkpoint

    ckpts = {kind: save_checkpoint(str(tmp / kind), create_train_state(m, make_optimizer(config, m)),
                                   config)
             for kind, m in (("offline", model), ("streaming", smodel))}
    cases = {
        "symbolic": ("0", ["--seconds", str(EXPORT_SECONDS)]),
        "symbolic_dilated": ("1", ["--seconds", str(EXPORT_SECONDS)]),
        "pinned": ("0", ["--seconds", str(EXPORT_SECONDS), "--fixed_batch", str(EXPORT_PINNED)]),
        "chunk": ("0", ["--streaming", "--chunk_frames", str(STREAM_CHUNK), "--batch_size", "1"]),
    }
    out = {}
    for name, (switch, args) in cases.items():
        path = tmp / f"{name}.pt2"
        ckpt = ckpts["streaming" if name == "chunk" else "offline"]
        with _Env("VOICESPLIT_PALLAS_CONV", switch):
            t0 = time.perf_counter()
            files = export_cli.main(["--checkpoint_path", ckpt, "--output", str(path), *args])
            seconds = time.perf_counter() - t0
        check(files == {"cuda": str(path)}, f"cli.export {name}: wrote {files}")
        out[name] = (path, seconds)
    manifest = json.loads((tmp / "chunk.pt2.json").read_text())
    check(manifest["platforms"] == ["cuda"] and manifest["artifacts"] == {"cuda": "chunk.pt2"},
          f"cli.export chunk: manifest {manifest}")
    return out, manifest


def phase_export(torch, lstm_cuda, cc, seed: int, tmp: Path) -> dict:
    """`cli.export` (`export.export_separator`, `export.export_streaming`)
    at full width for the card (`export_programs`), each program loaded cold
    in a fresh interpreter that imports no model code (`run_programs_cold`),
    where the launches of `lstm_fwd`, `bilstm_fwd` and `conv_bn_act_eval`
    are counted: the symbolic-batch program at B=1, 3 (the eager path's
    bits) and 8 (EXPORT_B8_TOL; the eager model takes `bilstm_fwd`), with the
    dilated switch at B=1 (bits), the batch pinned to 8 (bits, and against
    the plain versions, SEPARATE_TOL), EXPORT_CHUNKS chunks of the streaming
    step (`process_chunk`'s bits, output and state); the programs' sizes,
    export and load seconds, and their B=1 and chunk p50 beside eager's."""
    from voicesplit_tpu_torch import export, weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.streaming import StreamingSeparator

    t_phase = time.perf_counter()
    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), seed)
    smodel = weights.init_random_(make_masknet(config, streaming=True), seed + 1)
    programs, manifest = export_programs(torch, config, model, smodel, tmp)
    n = int(EXPORT_SECONDS * ap.sample_rate)
    arrays, want = {}, {}
    for b in EXPORT_BATCHES:
        arrays[f"wav{b}"], arrays[f"emb{b}"] = synthetic_batch(seed + 40 + b, b, n, ap.sample_rate,
                                                               config.model.emb_dim)
        want[f"symbolic_B{b}"] = separate_batch(model, ap, arrays[f"wav{b}"], arrays[f"emb{b}"])
    want[f"pinned_B{EXPORT_PINNED}"] = want[f"symbolic_B{EXPORT_PINNED}"]
    with _Env("VOICESPLIT_PALLAS_CONV", "1"):
        want["symbolic_dilated_B1"] = separate_batch(model, ap, arrays["wav1"], arrays["emb1"])
    with _PlainVersions(lstm_cuda):
        plain8 = separate_batch(model, ap, arrays[f"wav{EXPORT_PINNED}"], arrays[f"emb{EXPORT_PINNED}"])
    sep = StreamingSeparator(config, smodel, STREAM_CHUNK)
    state = sep.init_state(1)
    for i, f in enumerate(export.state_fields(state)):
        arrays[f"state{i}"] = f.cpu().numpy()
    stream_wav, arrays["chunk_emb"] = synthetic_batch(seed + 50, 1, EXPORT_CHUNKS * sep.chunk_samples,
                                                      ap.sample_rate, config.model.emb_dim)
    chunk_outs = []
    for i in range(EXPORT_CHUNKS):
        arrays[f"chunk{i}"] = stream_wav[:, i * sep.chunk_samples:(i + 1) * sep.chunk_samples]
        state, o = sep.process_chunk(state, arrays[f"chunk{i}"], arrays["chunk_emb"])
        chunk_outs.append(o)
    want["chunks"] = torch.cat(chunk_outs, dim=-1)
    for i, f in enumerate(export.state_fields(state)):
        want[f"final_state{i}"] = f
    np.savez(tmp / "inputs.npz", **arrays)

    cold = run_programs_cold({k: v[0] for k, v in programs.items()}, tmp / "inputs.npz",
                             tmp / "outputs.npz", LATENCY_CALLS)
    got = np.load(tmp / "outputs.npz")
    agreement = {}
    for name, w in want.items():
        w = w.float().cpu().numpy()
        same = bool(np.array_equal(got[name], w))
        agreement[name] = {"same_bits": same,
                           "peak_rel_err": float(np.abs(got[name] - w).max() / max(np.abs(w).max(), 1e-30))}
        if name == f"symbolic_B{EXPORT_PINNED}":
            check(agreement[name]["peak_rel_err"] <= EXPORT_B8_TOL,
                  f"export {name}: {agreement[name]} against the eager bilstm_fwd path")
        else:
            check(same, f"export {name}: the loaded program differs from the eager path: {agreement[name]}")
    plain = plain8.float().cpu().numpy()
    pinned_vs_plain = float(np.abs(got[f"pinned_B{EXPORT_PINNED}"] - plain).max() / np.abs(plain).max())
    check(pinned_vs_plain <= SEPARATE_TOL, f"export pinned: {pinned_vs_plain} from the plain versions")

    mixed, e = (torch.as_tensor(arrays[k], device="cuda") for k in ("wav1", "emb1"))
    eager_p50, _ = _latency_ms(torch, lambda: separate_batch(model, ap, mixed, e), LATENCY_CALLS)
    st0 = sep.init_state(1)
    eager_chunk_p50, _ = _latency_ms(
        torch, lambda: sep.process_chunk(st0, arrays["chunk0"], arrays["chunk_emb"]), LATENCY_CALLS)
    report = {
        "programs": {k: {"bytes": v[0].stat().st_size, "export_seconds": v[1],
                         "load_seconds": cold["load_seconds"][k],
                         "graph_calls": cold["graph_calls"][k]} for k, v in programs.items()},
        "chunk_manifest": manifest, "agreement": agreement,
        "pinned_vs_plain_versions_peak_rel": pinned_vs_plain,
        "launches_in_loaded_programs": cold["launches"],
        "B1_p50_ms": {"program": cold["symbolic_B1_p50_ms"], "eager": eager_p50},
        "chunk_p50_ms": {"program": cold["chunk_p50_ms"], "eager": eager_chunk_p50},
        "phase_seconds": time.perf_counter() - t_phase,
    }
    emit("export", device=torch.cuda.get_device_name(0), **report)
    out = {}
    for counted in cold["launches"].values():
        _add(out, {k: counted[k] for k in ("lstm_fwd", "bilstm_fwd", "conv_bn_act_eval")})
    return out


# kinds for the device time split under --profile.  The port's kernels:
# every __global__ of voicesplit_tpu_torch/csrc by its whole name
# (tests/test_torch_kernel_kinds.py holds the list complete), tried before
# the library's name fragments.
PORT_KERNEL_KINDS = (
    ("dilated conv kernels", ("conv_dilated_fwd_kernel", "conv_dilated_fwd_wide_kernel")),
    # the eval-mode block of the dilated path: conv, bias, BatchNorm and
    # activation in the forward kernel's epilogue
    ("eval conv block kernels", ("conv_bn_act_eval_kernel", "conv_bn_act_eval_wide_kernel")),
    ("conv chain kernels", ("conv_bn_act_fwd_kernel", "conv_dgrad_kernel", "reduce_rows_kernel",
                            "conv_bn_act_fwd_wide_kernel", "conv_dgrad_wide_kernel")),
    # the chain's BatchNorm + activation before conv_bn_act_fwd and conv_wgrad
    ("conv prologue passes", ("wgrad_prologue_kernel",)),
    # the BatchNorm backward between two convs (d_raw) before conv_dgrad and
    # conv_wgrad in their prologue branches
    ("conv draw passes", ("draw_prologue_kernel",)),
    # the weight gradient of both conv paths
    ("conv weight-gradient kernels", ("conv_wgrad_kernel", "conv_wgrad_kf1_kernel",
                                      "reduce_taps_kernel", "conv_wgrad_wide_kernel",
                                      "reduce_segments_kernel")),
    ("lstm kernels", ("lstm_fwd_kernel", "lstm_fwd_split_kernel", "lstm_fwd_grid_kernel",
                      "lstm_bwd_kernel", "lstm_bwd_split_kernel", "lstm_bwd_grid_kernel",
                      "lstm_dwhh_kernel", "lstm_dwhh_f32_kernel")),
)
# NCCL's kernels (`ncclDevKernel_*`, `ncclKernel_*`) first, cuDNN's
# implicit-GEMM convs before the matmuls (their names hold "gemm"), and
# cuBLAS's `sm80_xmma_gemm_*` matmuls before the rest of cuDNN's xmma
LIBRARY_KERNEL_KINDS = (
    # NCCL's collectives first: their names hold fragments of the kinds below
    ("collectives", ("nccldevkernel", "ncclkernel")),
    ("convs", ("conv", "cudnn", "implicit", "fprop", "wgrad", "dgrad")),
    ("matmuls", ("gemm", "cutlass", "nvjet", "splitk")),
    ("convs", ("xmma",)),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("layout", ("nchw", "nhwc", "transpose", "permute", "copy")),
)


# --- the gate split (`parallel/sharding.py`) and conv-block remat --------------
MP_SHARDS = (2, 4)  # in-process model shards of the wide config's training state
MP_STEPS = 3  # steps held bit for bit against the unsharded state's
MP_TIMED = 8
REMAT_ROUTES = ("unfused", "pallas_conv", "fused_chain")
REMAT_BATCHES = (2, 8)
REMAT_STEPS = 2  # steps held bit for bit against the switch off
REMAT_TIMED = 6
# conv kernel launches a train step with VOICESPLIT_REMAT_CONV=1: the
# recompute launches the dilated forward of conv2 … conv7 again (6 forward,
# 6 recomputed, 6 data gradients); the chain's kernels run no block's call
REMAT_CONV_LAUNCHES = {"unfused": {},
                       "pallas_conv": {"conv_dilated_fwd": 18, "conv_dilated_wgrad": 6},
                       "fused_chain": CONV_LAUNCHES}


def _state_bits(torch, state) -> tuple:
    """A train state's parameters and running statistics, and its optimizer
    state in the one-process layout (the gate split's moments gathered), on
    the host."""
    from voicesplit_tpu_torch.train.checkpoint import optimizer_state_dict

    state.gather_()
    sd = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    opt = {f"{i}/{k}": v.detach().cpu().clone()
           for i, st in optimizer_state_dict(state)["state"].items()
           for k, v in st.items() if torch.is_tensor(v)}
    return sd, opt


def _bits_differ(torch, got: tuple, want: tuple) -> list:
    """Names whose bits differ between two `_state_bits`."""
    out = []
    for g, w in zip(got, want):
        out += sorted(k for k in set(g) | set(w) if k not in g or k not in w
                      or not torch.equal(g[k], w[k]))
    return out


def phase_model_parallel(torch, lstm_cuda, cf, cc, seed: int) -> dict:
    """`configs/voicesplit_wide.json` at full width (bf16, B=2, 3 s clips,
    library convs) trained with its state split over MP_SHARDS in-process
    model shards (`parallel.sharding.InProcessShardExchange`, one card):
    MP_STEPS steps against the unsharded state's from the same weights, bit
    for bit (loss, every parameter, Adam's moments, running statistics);
    the launches of every step (both LSTM directions on the split walks);
    each shard's bytes against the whole; step p50 of each."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.parallel import InProcessShardExchange, make_mesh, shard_train_state
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    config = load_config(str(ROOT / WIDE_CONFIG))
    config.train_config.learning_rate = TRAIN_LR
    ap = make_audio_processor(config)
    n = int(config.audio.audio_len * ap.sample_rate)
    b = config.train_config.batch_size
    batch = train_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim)
    modules = (lstm_cuda, cf, cc)
    zero = {k: 0 for m in modules for k in m.LAUNCHES}
    launches: dict = {}
    report = {"config": WIDE_CONFIG, "batch": b, "steps_held": MP_STEPS, "shards": MP_SHARDS}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the runs' bits are compared
    try:
        with _route_env("unfused"):
            runs = {}
            for k in (1, *MP_SHARDS):
                model = weights.init_random_(make_masknet(config), seed)
                state = create_train_state(model, make_optimizer(config, model))
                if k > 1:
                    state = shard_train_state(state, make_mesh(), model_parallel=True,
                                              exchange=InProcessShardExchange(k))
                step = make_train_step(config, model, ap, state.optimizer)
                losses = []
                for _ in range(MP_STEPS):
                    _reset_counts(torch, *modules)
                    m = step(state, batch)
                    counted = _counts(torch, *modules)
                    want = {**zero, **WIDE_TRAIN_LAUNCHES}
                    check(counted == want, f"model parallel K={k}: launches {counted}, expected {want}")
                    counted = _check_routes(lstm_cuda, counted, f"model parallel K={k}", WIDE_ROUTES)
                    if k > 1:
                        _add(launches, counted)
                    losses.append(float(m["loss"]))
                check(all(np.isfinite(losses)), f"model parallel K={k}: losses {losses}")
                bits = _state_bits(torch, state)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = _step_times(torch, step, state, batch, MP_TIMED)
                opt_bytes = sum(v.numel() * v.element_size() for st in state.optimizer.state.values()
                                for v in st.values() if torch.is_tensor(v))
                runs[k] = {"losses": losses, "bits": bits,
                           "step_ms_p50": float(np.percentile(times, 50)),
                           "step_ms_p75": float(np.percentile(times, 75)),
                           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                           "optimizer_state_bytes_in_process": opt_bytes}
                if k > 1:
                    runs[k]["bytes"] = state.shards.bytes(state.optimizer)
                    runs[k]["split_parameters"] = len(state.shards.dims)
                del model, state, step
                torch.cuda.empty_cache()
        ref = runs[1]
        for k in MP_SHARDS:
            differ = _bits_differ(torch, runs[k]["bits"], ref["bits"])
            check(runs[k]["losses"] == ref["losses"] and not differ,
                  f"model parallel K={k}: losses {runs[k]['losses']} against {ref['losses']}, "
                  f"bits differ at {differ[:8]}")
            bts = runs[k]["bytes"]
            whole = bts["working_copy"]
            report[f"shards_{k}"] = {
                "same_bits_as_unsharded": True, "losses": runs[k]["losses"],
                "launches_per_step": {**zero, **WIDE_TRAIN_LAUNCHES},
                "step_ms_p50": runs[k]["step_ms_p50"], "step_ms_p75": runs[k]["step_ms_p75"],
                "max_memory_allocated_bytes": runs[k]["max_memory_allocated_bytes"],
                "split_parameters": runs[k]["split_parameters"],
                "split_param_bytes_whole": whole,
                "shard_param_bytes": [s["params"] for s in bts["shards"]],
                "shard_optimizer_bytes": [s["optimizer_state"] for s in bts["shards"]],
                "unsharded_optimizer_bytes": ref["optimizer_state_bytes_in_process"],
                "replicated_param_bytes": bts["replicated_params"],
                "replicated_optimizer_bytes": bts["replicated_optimizer_state"],
                "gathered_working_copy_bytes": whole,
            }
        report["unsharded"] = {k: ref[k] for k in ("losses", "step_ms_p50", "step_ms_p75",
                                                  "max_memory_allocated_bytes")}
    finally:
        torch.backends.cudnn.deterministic = prev
    emit("model parallel", device=torch.cuda.get_device_name(0), **report)
    return launches


def phase_remat(torch, lstm_cuda, cf, cc, seed: int) -> dict:
    """`configs/voicesplit.json` at full width (bf16) trained at B=2 and B=8
    on each conv route (library convs, the dilated switch, the fused chain)
    with ``VOICESPLIT_REMAT_CONV=1`` and without, from the same weights:
    REMAT_STEPS steps bit for bit (losses, parameters, Adam's moments,
    running statistics), the switch's exact launches a step (with the
    dilated switch 18 ``conv_dilated_fwd``), then REMAT_TIMED steps' p50 and
    peak memory on each side."""
    from voicesplit_tpu_torch.config import load_config

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    config.train_config.learning_rate = TRAIN_LR
    modules = (lstm_cuda, cf, cc)
    zero = {k: 0 for m in modules for k in m.LAUNCHES}
    plain_conv = {"unfused": {}, "pallas_conv": DILATED_TRAIN_LAUNCHES, "fused_chain": CONV_LAUNCHES}
    launches: dict = {}
    report: dict = {"config": "configs/voicesplit.json", "steps_held": REMAT_STEPS,
                    "timed": REMAT_TIMED}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the runs' bits are compared
    try:
        for route in REMAT_ROUTES:
            with _route_env(route):
                for b in REMAT_BATCHES:
                    sides = {}
                    for remat in ("0", "1"):
                        with _Env("VOICESPLIT_REMAT_CONV", remat):
                            model, optimizer, state, step, batch = _fresh_step(config, seed, b)
                            conv = REMAT_CONV_LAUNCHES[route] if remat == "1" else plain_conv[route]
                            want = {**zero, **TRAIN_LAUNCHES[b], **conv}
                            losses = []
                            for _ in range(REMAT_STEPS):
                                _reset_counts(torch, *modules)
                                m = step(state, batch)
                                counted = _counts(torch, *modules)
                                check(counted == want, f"remat {remat} {route} B={b}: launches "
                                      f"{counted}, expected {want}")
                                counted = _check_routes(lstm_cuda, counted, f"remat {route} B={b}")
                                if remat == "1":
                                    _add(launches, counted)
                                losses.append(float(m["loss"]))
                            bits = _state_bits(torch, state)
                            torch.cuda.synchronize()
                            torch.cuda.reset_peak_memory_stats()
                            times = _step_times(torch, step, state, batch, REMAT_TIMED)
                            sides[remat] = {
                                "losses": losses, "bits": bits, "launches_per_step": want,
                                "step_ms_p50": float(np.percentile(times, 50)),
                                "step_ms_p75": float(np.percentile(times, 75)),
                                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
                            del model, optimizer, state, step
                            torch.cuda.empty_cache()
                    differ = _bits_differ(torch, sides["1"]["bits"], sides["0"]["bits"])
                    check(sides["1"]["losses"] == sides["0"]["losses"] and not differ,
                          f"remat {route} B={b}: losses {sides['1']['losses']} against "
                          f"{sides['0']['losses']}, bits differ at {differ[:8]}")
                    on, off = sides["1"], sides["0"]
                    report[f"{route}_B{b}"] = {
                        "same_bits": True, "losses": on["losses"],
                        "launches_per_step": {k: v for k, v in on["launches_per_step"].items() if v},
                        "step_ms_p50": {"on": on["step_ms_p50"], "off": off["step_ms_p50"]},
                        "step_ms_p75": {"on": on["step_ms_p75"], "off": off["step_ms_p75"]},
                        "max_memory_allocated_bytes": {"on": on["max_memory_allocated_bytes"],
                                                       "off": off["max_memory_allocated_bytes"]},
                        "peak_saved_bytes": off["max_memory_allocated_bytes"]
                        - on["max_memory_allocated_bytes"],
                    }
    finally:
        torch.backends.cudnn.deterministic = prev
    emit("remat", device=torch.cuda.get_device_name(0), **report)
    return launches


# --- other channel counts than 64: the widths the JAX package takes ----------
# The conv kernels at [2, 301, 601, C] bf16 against their plain versions
# (DILATED_TOL, CONV_TOL), on their wide tiles (csrc/conv_fwd_wide.cu,
# csrc/conv_wgrad_wide.cu): the dilated kernels at Cin = Cout of 96, 128,
# 192, 256 (one n256 tile) and 320 (two output groups), 64 -> 128 and
# 192 -> 256, the chain's at 128 and 192 (it takes multiples of 64), each on
# the (7,1) layer and on (5,5) at time dilation 1 and 16; and one layer of
# 100 channels, which the 16-byte copies cannot align: the wrapper zero-pads
# it to 104 around the launch (CHANNEL_PADS).  Each launched shape's tile
# from the C planner (`conv_cuda.wide_tile_of_library`) must be the Python
# table's (`conv_cuda.fwd_tile`, `wgrad_tile`), and its grid spill nothing.
CHANNEL_DILATED_WIDTHS = {"96": (96, 96), "128": (128, 128), "192": (192, 192),
                          "256": (256, 256), "320": (320, 320), "64-128": (64, 128),
                          "192-256": (192, 256)}
CHANNEL_CHAIN_WIDTHS = (128, 192)
CHANNEL_LAYERS = ("7x1", "5x5-d1", "5x5-d16")
CHANNEL_PADDED = (100, "5x5-d1")
# The wide forward body at the edges of [0, T): on a dilated layer whose
# reach nearly spans T a warpgroup's sub-steps alternate between products
# and none (its input or output row outside [0, T)), and the refills after
# each sub-step must still wait for the previous one's products.  B=1,
# CHANNEL_EDGE_F positions (several items a block), T just past the reach;
# each launch CHANNEL_EDGE_REPEATS times on the same inputs must give the
# first launch's bits, and that one the plain version's result (DILATED_TOL,
# CONV_TOL): `conv_dilated_fwd` at each width, the chain's two forward-body
# modes where Cin = Cout.
CHANNEL_EDGES = {"5x5-d16": 40, "5x5-d32": 70}  # layer: T
CHANNEL_EDGE_WIDTHS = {"128": (128, 128), "192": (192, 192), "128-64": (128, 64)}
CHANNEL_EDGE_F = 2048
CHANNEL_EDGE_REPEATS = 20
# the full-width configs/voicesplit.json model with model.conv_channels
# changed in memory, served at B=1 and B=8 with the dilated switch and
# trained at B=2 with the dilated switch and with the fused chain
CHANNEL_MODEL = 128
CHANNEL_ROUTES = {"pallas_conv": DILATED_TRAIN_LAUNCHES, "fused_chain": CONV_LAUNCHES}


def _channel_grids(torch, cf, cc, shape, kt, kf, dt, cout, chain: bool) -> dict:
    """The wide tiles' launch shapes at `shape` in, `cout` out: blocks
    against resident blocks (more fails), no spilled byte (else fails),
    registers; and each kernel's tile, the C planner's against the Python
    table's (a difference fails) and its shared memory the grid's."""
    cin = shape[-1]
    grids = {"conv_dilated_fwd": cf.fwd_launch_config(shape, kt, kf, dt, torch.bfloat16, False, cout),
             "conv_dilated_fwd_data_gradient": cf.fwd_launch_config((*shape[:3], cout), kt, kf, dt,
                                                                   torch.bfloat16, False, cin),
             "conv_dilated_wgrad": cf.wgrad_launch_config(shape, kt, kf, dt, torch.bfloat16, cout)}
    # (kind, mode, Cin, Cout) of each grid's tile
    tiles = {"conv_dilated_fwd": ("fwd", "plain", cin, cout),
             "conv_dilated_fwd_data_gradient": ("fwd", "plain", cout, cin),
             "conv_dilated_wgrad": ("wgrad", None, cin, cout)}
    if chain:
        grids["conv_bn_act_fwd"] = cf.launch_config(shape, kt, kf, dt, torch.bfloat16)
        grids["conv_dgrad"] = cf.fwd_launch_config(shape, kt, kf, dt, torch.bfloat16, True)
        tiles.update(conv_bn_act_fwd=("fwd", "chain", cin, cin), conv_dgrad=("fwd", "dgrad", cin, cin))
    out = {}
    for name, gr in grids.items():
        check(gr["blocks"] <= gr["resident_blocks"],
              f"{name} {shape} -> {cout}: {gr['blocks']} blocks > {gr['resident_blocks']} resident")
        check(gr["local_bytes"] == 0, f"{name} {shape} -> {cout}: {gr['local_bytes']} spilled bytes a thread")
        kind, mode, ci, co = tiles[name]
        if kind == "fwd":
            table = cc.fwd_tile(ci, co, kt, kf, torch.bfloat16, mode)
            planner = cc.wide_tile_of_library("fwd", ci, co, kt, kf, mode)
        else:
            table = cc.wgrad_tile(ci, co, kf, torch.bfloat16)
            planner = cc.wide_tile_of_library("wgrad", ci, co, kt, kf)
        differ = {k: (v, table.get(k)) for k, v in planner.items() if table.get(k) != v}
        check(table["route"] == "tiles" and not differ,
              f"{name} {ci} -> {co} ({kt},{kf}): the C planner's tile differs from the table: {differ}")
        check(gr["smem_bytes"] == table["smem_bytes"],
              f"{name} {ci} -> {co}: the grid's {gr['smem_bytes']} B of shared memory, the tile's "
              f"{table['smem_bytes']}")
        out[name] = {**{f: gr[f] for f in ("blocks", "smem_bytes", "registers", "local_bytes")},
                     "tile": {k: v for k, v in table.items() if k not in ("route", "smem_bytes")}}
    return out


def _channel_edges(torch, cf, cc, g) -> dict:
    """CHANNEL_EDGES: each forward-body launch repeated on the same inputs,
    against its first launch's bits and its plain version."""
    out = {}
    for width, (cin, cout) in CHANNEL_EDGE_WIDTHS.items():
        for layer, T in CHANNEL_EDGES.items():
            (kt, kf), dt = ALL_CONV_LAYERS[layer]
            case = f"edges/{width}/{layer}/T{T}"
            x, d, w, bias, bn = _conv_inputs(torch, (1, T, CHANNEL_EDGE_F, cin), kt, kf, torch.bfloat16, g, cout)
            runs = {"conv_dilated_fwd": (lambda: (cc.conv_dilated_fwd(x, w, dt),),
                                         lambda: (cc.conv_dilated_fwd_round_once_ref(x, w, dt),),
                                         DILATED_TOL["bfloat16"]["out_round_once"])}
            if cin == cout:
                scal, wf = cf._scal_table(*bn), cf.pack_weight_flipped(w, torch.bfloat16)
                tol = CONV_TOL["bfloat16"]
                runs["conv_bn_act_fwd"] = (lambda: cf.conv_bn_act_fwd(x, w, bias, scal, dt, None, False),
                                           lambda: cf.conv_bn_act_fwd_ref(x, w, bias, scal, dt, None, False),
                                           (tol["out"], tol["sums"]))
                runs["conv_dgrad"] = (lambda: cf.conv_dgrad(d, wf, dt), lambda: cf.conv_dgrad_ref(d, wf, dt),
                                      (tol["out"], tol["sums"]))
            entry = {}
            with torch.inference_mode():
                for name, (kernel, plain, tols) in runs.items():
                    first = kernel()
                    same = sum(all(torch.equal(a, b) for a, b in zip(first, kernel()))
                               for _ in range(CHANNEL_EDGE_REPEATS - 1))
                    want = plain()
                    torch.cuda.synchronize()
                    errs = [_peak_rel(a, b) for a, b in zip(first, want)]
                    check(same == CHANNEL_EDGE_REPEATS - 1,
                          f"{name} {case}: {CHANNEL_EDGE_REPEATS - 1 - same} of {CHANNEL_EDGE_REPEATS - 1} "
                          "repeated launches differ from the first")
                    tols = tols if isinstance(tols, tuple) else (tols,)
                    check(all(np.isfinite(e) and e <= t for e, t in zip(errs, tols)),
                          f"{name} {case}: errors {errs} > {tols}")
                    entry[name] = {"errors": errs, "repeats_with_the_first_bits": same + 1}
            out[case] = entry
            del x, d, w
            torch.cuda.empty_cache()
    return out


def _channel_kernels(torch, cf, cc, seed: int) -> None:
    """Each generalized kernel against its plain version at the widths
    above, with its time, plain version's time, bound and cuDNN's time."""
    g = torch.Generator(device="cpu").manual_seed(seed + 20)
    cases: dict = {}
    for width, (cin, cout) in CHANNEL_DILATED_WIDTHS.items():
        shape = (*CONV_SHAPE[:3], cin)
        for layer in CHANNEL_LAYERS:
            (kt, kf), dt = ALL_CONV_LAYERS[layer]
            case = f"dilated/{width}/{layer}"
            agreement = _check_dilated_case(torch, cc, case, shape, layer, "bfloat16", g, cout)
            x, d, w, _, _ = _conv_inputs(torch, shape, kt, kf, torch.bfloat16, g, cout)
            fwd, wgrad = _dilated_times(torch, cc, cf, x, d, w, dt, iters=5)
            cases[case] = {"agreement": agreement, "conv_dilated_fwd": fwd, "conv_dilated_wgrad": wgrad,
                           "grids": _channel_grids(torch, cf, cc, shape, kt, kf, dt, cout, False)}
            del x, d, w
            torch.cuda.empty_cache()
    for C in CHANNEL_CHAIN_WIDTHS:
        shape = (*CONV_SHAPE[:3], C)
        for layer in CHANNEL_LAYERS:
            (kt, kf), dt = ALL_CONV_LAYERS[layer]
            act = None if layer == "7x1" else "mish"  # as the chain calls its first layer
            case = f"chain/{C}/{layer}"
            agreement = _check_conv_case(torch, cf, cc, case, shape, layer, act, "bfloat16", g)
            x, d, w, bias, bn = _conv_inputs(torch, shape, kt, kf, torch.bfloat16, g)
            cases[case] = {"agreement": agreement,
                           **_chain_times(torch, cf, x, d, w, bias, bn, dt, act, iters=5),
                           "grids": _channel_grids(torch, cf, cc, shape, kt, kf, dt, C, True)}
            del x, d, w
            torch.cuda.empty_cache()
    # the padded width: the launch on 100 channels pads to 104 and slices back;
    # against the same kernel on operands padded beforehand, the copies' cost
    C, layer = CHANNEL_PADDED
    (kt, kf), dt = ALL_CONV_LAYERS[layer]
    shape = (*CONV_SHAPE[:3], C)
    case = f"dilated/{C}/{layer}"
    cc.reset_launch_counts()
    agreement = _check_dilated_case(torch, cc, case, shape, layer, "bfloat16", g)
    check(cc.CHANNEL_PADS == cc.LAUNCHES and cc.LAUNCHES["conv_dilated_fwd"] > 0,
          f"{case}: launches {cc.LAUNCHES}, padded {cc.CHANNEL_PADS}")
    x, d, w, _, _ = _conv_inputs(torch, shape, kt, kf, torch.bfloat16, g)
    fwd, wgrad = _dilated_times(torch, cc, cf, x, d, w, dt, iters=5)
    a = cc._aligned(C) - C
    xa, da, wa = cc._pad_last(x, a), cc._pad_last(d, a), cc._pad_last(w, a, a)
    with torch.inference_mode():
        fwd["kernel_on_padded_operands_ms"] = time_ms(torch, lambda: cc.conv_dilated_fwd(xa, wa, dt), 5, warmup=1)
        wgrad["kernel_on_padded_operands_ms"] = time_ms(
            torch, lambda: cc.conv_dilated_wgrad(xa, da, kt, kf, dt), 5, warmup=1)
    for entry in (fwd, wgrad):
        entry["padding_ms"] = entry["ms"] - entry["kernel_on_padded_operands_ms"]
    cases[case] = {"agreement": agreement, "padded_to": C + a, "conv_dilated_fwd": fwd,
                   "conv_dilated_wgrad": wgrad}
    del x, d, w, xa, da, wa
    torch.cuda.empty_cache()
    cases.update(_channel_edges(torch, cf, cc, g))
    emit("channel kernels", shape=list(CONV_SHAPE[:3]), dtype="bfloat16",
         tolerances_peak_rel={"dilated": DILATED_TOL["bfloat16"], "chain": CONV_TOL["bfloat16"]},
         library="cuDNN conv2d (+ eager BN + act, + var_mean) / aten.convolution_backward, "
                 "channels-last bf16", cases=cases)


def phase_channels(torch, lstm_cuda, cf, cc, seed: int) -> dict:
    """The conv kernels at other channel counts than 64 (`_channel_kernels`),
    then `configs/voicesplit.json` at full width with ``conv_channels`` =
    CHANNEL_MODEL: `separate_batch` at B=1 and B=8 with the dilated switch
    and one B=2 train step on each of CHANNEL_ROUTES, each counted (exact
    launches) and held against the same run through the plain versions on
    the card (SEPARATE_DILATED_TOL, DILATED_STEP_TOL, FUSED_TOL), then timed:
    latency p50 / p75 of LATENCY_CALLS calls, TRAIN_STEPS steps' p50 / p75
    (their loss must fall) and peak memory."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet

    _channel_kernels(torch, cf, cc, seed)

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    config.model.conv_channels = CHANNEL_MODEL
    config.train_config.learning_rate = TRAIN_LR
    ap = make_audio_processor(config)
    n = int(config.audio.audio_len * ap.sample_rate)
    modules = (lstm_cuda, cf, cc)
    zero = {k: 0 for m in modules for k in m.LAUNCHES}
    launches: dict = {}
    report = {"config": "configs/voicesplit.json", "conv_channels": CHANNEL_MODEL,
              "compute_dtype": config.train_config.compute_dtype,
              "tolerances": {"serve_vs_plain": SEPARATE_DILATED_TOL,
                             "pallas_conv_step_vs_plain": DILATED_STEP_TOL,
                             "fused_chain_step_vs_plain": FUSED_TOL}}

    model = weights.init_random_(make_masknet(config), seed)
    check(model.conv_channels == CHANNEL_MODEL, f"model built with {model.conv_channels} channels")
    report["parameters"] = sum(p.numel() for p in model.parameters())
    lstm_per_call = {1: {"lstm_fwd": 2}, 8: {"bilstm_fwd": 1}}
    for b in (1, 8):
        mixed, emb = (torch.as_tensor(a, device="cuda")
                      for a in synthetic_batch(seed + b, b, n, ap.sample_rate, config.model.emb_dim))
        with _route_env("pallas_conv"):
            _reset_counts(torch, *modules)
            out = separate_batch(model, ap, mixed, emb)
            counted = _counts(torch, *modules)
            want = {**zero, **lstm_per_call[b], **DILATED_SERVE_LAUNCHES}
            check(counted == want, f"channels serve B={b}: launches {counted}, expected {want}")
            check(not any(cc.CHANNEL_PADS.values()), f"channels serve B={b}: padded {cc.CHANNEL_PADS}")
            _add(launches, _check_routes(lstm_cuda, counted, f"channels serve B={b}"))
            with torch.inference_mode():
                spec, _ = ap.wav2spec_batch(mixed)
                mask = model(spec, emb)
                with _PlainVersions(cc):
                    mask_plain = model(spec, emb)
                    out_plain = separate_batch(model, ap, mixed, emb)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            p50, p75 = _latency_ms(torch, lambda: separate_batch(model, ap, mixed, emb), LATENCY_CALLS)
            peak = torch.cuda.max_memory_allocated()
        check(tuple(out.shape) == (b, n) and bool(torch.isfinite(out).all()), f"channels B={b}: output")
        check(float(mask.min()) >= 0.0 and float(mask.max()) <= 1.0, f"channels B={b}: mask outside [0, 1]")
        mask_err = (mask - mask_plain).abs().max().item()
        wav_err = ((out - out_plain).abs().max() / out_plain.abs().max()).item()
        check(mask_err <= SEPARATE_DILATED_TOL, f"channels serve B={b}: mask vs plain {mask_err}")
        check(wav_err <= SEPARATE_DILATED_TOL, f"channels serve B={b}: waveform vs plain {wav_err}")
        report[f"serve_pallas_conv_B{b}"] = {
            "launches_per_call": {k: v for k, v in counted.items() if v},
            "mask_err_vs_plain": mask_err, "wave_rel_err_vs_plain": wav_err,
            "calls": LATENCY_CALLS, "latency_ms_p50": p50, "latency_ms_p75": p75,
            "audio_s_per_s": b * config.audio.audio_len / (p50 / 1e3),
            "max_memory_allocated_bytes": peak}
    del model
    torch.cuda.empty_cache()

    for route, conv_launches in CHANNEL_ROUTES.items():
        module = cc if route == "pallas_conv" else cf
        tol = DILATED_STEP_TOL if route == "pallas_conv" else FUSED_TOL
        with _route_env(route):
            model, optimizer, state, step, batch = _fresh_step(config, seed, 2)
            before = _snapshot(model, optimizer, state)
            _reset_counts(torch, *modules)
            mk = step(state, batch)
            counted = _counts(torch, *modules)
            want = {**zero, **TRAIN_LAUNCHES[2], **conv_launches}
            check(counted == want, f"channels train {route}: launches {counted}, expected {want}")
            _add(launches, _check_routes(lstm_cuda, counted, f"channels train {route}"))
            loss0, gn0 = float(mk["loss"]), float(mk["grad_norm"])
            check(np.isfinite(loss0) and not bool(mk["loss_exploded"]), f"channels {route}: loss {loss0}")
            check(gn0 > 0 and np.isfinite(gn0), f"channels {route}: grad_norm {gn0}")
            unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[0][k])]
            check(not unmoved, f"channels {route}: unchanged after a step: {unmoved}")
            through_kernels = _chain_state(model)
            _restore(model, optimizer, state, before)
            with _PlainVersions(module):
                mp = step(state, batch)
            vs_plain = _compare_steps(torch, mk, through_kernels, mp, _chain_state(model))
            _check_step_agreement(f"channels {route}: kernels vs plain", vs_plain, tol)
            _restore(model, optimizer, state, before)
            for _ in range(TRAIN_WARM):
                step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = []
            times = []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                losses.append(float(step(state, batch)["loss"]))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            check(all(np.isfinite(losses)) and losses[-1] < loss0,
                  f"channels {route}: loss did not fall on a fixed batch: {loss0} -> {losses}")
            report[f"train_{route}_B2"] = {
                "launches_per_step": {k: v for k, v in counted.items() if v},
                "first_loss": loss0, "first_grad_norm": gn0, "kernels_vs_plain": vs_plain,
                "steps": TRAIN_STEPS, "step_ms_p50": float(np.percentile(times, 50)),
                "step_ms_p75": float(np.percentile(times, 75)), "losses": losses,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
            del model, optimizer, state, step, through_kernels, before
            torch.cuda.empty_cache()
    emit("channels", device=torch.cuda.get_device_name(0), **report)
    return launches


def flax_msgpack(tree) -> bytes:
    """`tree` (nested dicts of numpy arrays and scalars, ints and strings) as
    ``flax.serialization.msgpack_serialize`` writes it: keys in sorted order
    (the order of JAX's tree map), an array as msgpack extension 1 and a
    numpy scalar as extension 3, each holding the packed ``(shape, dtype
    name, bytes)``."""
    import msgpack

    def ordered(t):
        return {k: ordered(t[k]) for k in sorted(t)} if isinstance(t, dict) else t

    def ext(x):
        if not isinstance(x, (np.ndarray, np.generic)):
            raise TypeError(f"no flax msgpack layout for {type(x).__name__}")
        a = np.asarray(x)
        data = msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True)
        return msgpack.ExtType(1 if isinstance(x, np.ndarray) else 3, data)

    return msgpack.packb(ordered(tree), default=ext, strict_types=True)


def jax_checkpoint_tree(params: dict, stats: dict, config) -> dict:
    """The payload of a JAX ``checkpoint_<step>.msgpack`` at step 0
    (`voicesplit_tpu/train/checkpoint.py::save_checkpoint`): the variables,
    a fresh Adam state (count 0, zero moments), the config string and the
    data position."""
    from voicesplit_tpu_torch.data.dataset import IteratorState

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}

    return {"model": params, "batch_stats": stats,
            "optimizer": {"0": {"count": np.int32(0), "mu": zeros(params), "nu": zeros(params)},
                          "1": {}},
            "step": 0, "config_str": config.to_json(), "data_state": IteratorState().to_dict()}


def phase_checkpoint(torch, lstm_cuda, seed: int, tmp: Path) -> dict:
    """`cli.separate.main` on the JAX CLI's command line (`--checkpoint_path`,
    no ``-c``, a ``.pt`` d-vector) at full width: a JAX-layout ``.msgpack``,
    the port's ``.pt`` of the same weights, a JAX-layout streaming file with
    ``--streaming``, and the BiLSTM file with ``--streaming`` (refused before
    any launch).  Each call is counted and timed, and its file is held byte
    for byte to the one the same trees give through `separate_batch` or
    `StreamingSeparator`."""
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.cli.separate import main as separate_main
    from voicesplit_tpu_torch.cli.separate import separate_batch
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.streaming import StreamingSeparator
    from voicesplit_tpu_torch.train.checkpoint import save_checkpoint
    from voicesplit_tpu_torch.train.state import create_train_state, make_optimizer

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    causal = _stream_config(True)
    ap = make_audio_processor(config)
    sr, n = ap.sample_rate, int(config.audio.audio_len * ap.sample_rate)
    wav, emb = synthetic_batch(seed + 51, 1, n, sr, config.model.emb_dim)
    ap.save_wav(wav[0], str(tmp / "mix.wav"))
    torch.save(torch.from_numpy(emb[0]), str(tmp / "emb.pt"))
    mixed = ap.load_wav(str(tmp / "mix.wav"))  # what the CLI reads

    files, models, write_s = {}, {}, {}
    for i, (name, cfg, streaming) in enumerate((("bilstm", config, False),
                                                ("streaming", causal, True))):
        model = make_masknet(cfg, streaming=streaming)
        params, stats = weights.random_jax_variables(model, seed + i)
        t0 = time.perf_counter()
        (tmp / name).mkdir()
        files[name] = tmp / name / "checkpoint_0.msgpack"
        files[name].write_bytes(flax_msgpack(jax_checkpoint_tree(params, stats, cfg)))
        write_s[name] = time.perf_counter() - t0
        model.load_state_dict(weights.state_dict_from_jax(params, stats))
        models[name] = model
    files["port"] = Path(save_checkpoint(str(tmp / "port"), create_train_state(
        models["bilstm"], make_optimizer(config, models["bilstm"])), config))

    # the outputs the same trees give when driven directly
    with torch.inference_mode():
        want = separate_batch(models["bilstm"], ap, mixed[None], emb)[0].cpu().numpy()
    ap.save_wav(want, str(tmp / "want.wav"))
    sep = StreamingSeparator(causal, models["streaming"], STREAM_CHUNK)
    ap.save_wav(sep.separate(mixed[None], emb)[0], str(tmp / "want_stream.wav"))
    chunks = (n + (-n) % sep.chunk_samples + sep.latency_samples) // sep.chunk_samples + 1

    zero = {k: 0 for k in lstm_cuda.LAUNCHES}
    calls = {  # name: (checkpoint, extra flags, launches, file it must equal)
        "jax_msgpack": (files["bilstm"], [], {**zero, "lstm_fwd": 2}, "want.wav"),
        "port_pt": (files["port"], [], {**zero, "lstm_fwd": 2}, "want.wav"),
        "jax_msgpack_streaming": (files["streaming"], ["--streaming"],
                                  {**zero, "lstm_fwd": chunks}, "want_stream.wav"),
    }
    report = {"config": "configs/voicesplit.json (bf16; causal for the streaming file)",
              "msgpack_bytes": files["bilstm"].stat().st_size,
              "streaming_msgpack_bytes": files["streaming"].stat().st_size,
              "port_pt_bytes": files["port"].stat().st_size, "msgpack_write_seconds": write_s,
              "streaming_chunks": chunks, "calls": {}}
    launches = dict(zero)
    for name, (path, extra, want_launches, want_file) in calls.items():
        out = tmp / f"{name}.wav"
        _reset_counts(torch, lstm_cuda)
        t0 = time.perf_counter()
        separate_main(["--checkpoint_path", str(path), "--mixed_wav", str(tmp / "mix.wav"),
                       "--emb", str(tmp / "emb.pt"), "--output", str(out), *extra])
        seconds = time.perf_counter() - t0
        counted = _counts(torch, lstm_cuda)
        check(counted == want_launches, f"checkpoint {name}: launches {counted}, wanted {want_launches}")
        counted = _check_routes(lstm_cuda, counted, f"checkpoint {name}")
        _add(launches, counted)
        same = out.read_bytes() == (tmp / want_file).read_bytes()
        check(same, f"checkpoint {name}: the CLI's file is not the one the same trees give")
        report["calls"][name] = {"seconds": seconds, "launches": counted,
                                 "same_bytes_as_direct": same}

    # a BiLSTM checkpoint does not fit the streaming model: refused unlaunched
    _reset_counts(torch, lstm_cuda)
    t0 = time.perf_counter()
    try:
        separate_main(["--checkpoint_path", str(files["bilstm"]), "--mixed_wav",
                       str(tmp / "mix.wav"), "--emb", str(tmp / "emb.pt"),
                       "--output", str(tmp / "refused.wav"), "--streaming"])
        refused = None
    except ValueError as e:
        refused = str(e)
    seconds = time.perf_counter() - t0
    counted = _counts(torch, lstm_cuda)
    check(refused is not None and "does not fit the streaming model" in refused,
          f"checkpoint: a BiLSTM file with --streaming was not refused ({refused})")
    check(counted == zero and not (tmp / "refused.wav").exists(),
          f"checkpoint: the refused call launched {counted}")
    report["calls"]["bilstm_streaming_refused"] = {"seconds": seconds, "launches": counted,
                                                   "error": refused[:160]}
    emit("checkpoint", device=torch.cuda.get_device_name(0), **report)
    return launches


def kernel_kind(name: str) -> str:
    idents = set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", name))
    for kind, names in PORT_KERNEL_KINDS:
        if idents.intersection(names):
            return kind
    low = name.lower()
    for kind, frags in LIBRARY_KERNEL_KINDS:
        if any(f in low for f in frags):
            return kind
    return "elementwise and other"


def profile(torch, out_dir, tag, fn, runs: int = 5) -> dict:
    """Kernel time by name over `runs` calls (torch.profiler), written to
    out_dir; returns the device's busy share of the profiled wall time
    (profiler overhead lengthens the wall, so the idle share is an upper
    bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    (out / f"{tag}.txt").write_text(table)
    prof.export_chrome_trace(str(out / f"{tag}.json"))
    split: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = kernel_kind(e.name)
            split[kind] = split.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3 / runs
    kernel_ms = sum(split.values()) * runs
    return {"runs": runs, "wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "idle_share": 1.0 - kernel_ms / wall_ms, "ms_per_run_by_kind": split}


PHASES = ("kernels", "bwd_kernels", "separate", "train", "conv_kernels", "prologue", "train_fused",
          "dilated_kernels", "separate_dilated", "trainer", "separate_wide", "train_wide",
          "evaluate", "preprocess", "trainer_online", "dsp", "streaming", "train_streaming",
          "encoder", "voicefilter", "reference", "import", "distributed", "long", "export",
          "model_parallel", "remat", "channels", "checkpoint")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", type=str, default=None)
    parser.add_argument("--phases", type=str, default=",".join(PHASES),
                        help="comma-separated subset of: " + ", ".join(PHASES))
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.device import set_fp32_precision
    from voicesplit_tpu_torch.ops import conv_cuda, conv_fused, lstm_cuda

    set_fp32_precision()
    smi_line = phase_device(torch)
    phase_build(torch, lstm_cuda, conv_fused)
    kern, by_path = {}, {}
    if "kernels" in phases:
        kern.update(phase_kernels(torch, lstm_cuda, args.seed))
    if "bwd_kernels" in phases:
        kern.update(phase_bwd_kernels(torch, lstm_cuda, args.seed))
    if "separate" in phases:
        by_path["separate"] = phase_separate(torch, lstm_cuda, args.seed, args.profile)
    if "train" in phases:
        by_path["train"] = phase_train(torch, lstm_cuda, args.seed, args.profile)
    if "conv_kernels" in phases:
        kern.update(phase_conv_kernels(torch, conv_fused, conv_cuda, args.seed))
    if "prologue" in phases:
        kern.update(phase_prologue(torch, conv_fused, args.seed))
    if "train_fused" in phases:
        by_path["train_fused"] = phase_train_fused(
            torch, lstm_cuda, conv_fused, args.seed, args.profile)
    if "dilated_kernels" in phases:
        kern.update(phase_dilated_kernels(torch, conv_cuda, conv_fused, args.seed))
    if "separate_dilated" in phases:
        by_path["separate_dilated"] = phase_separate_dilated(
            torch, lstm_cuda, conv_cuda, args.seed, args.profile)
    if "trainer" in phases:
        by_path["trainer"] = phase_trainer(torch, lstm_cuda, conv_cuda, args.seed, args.profile)
    with tempfile.TemporaryDirectory(prefix="voicesplit_wide_") as wide_tmp:
        tmp, run, run_config = Path(wide_tmp), None, None
        if "separate_wide" in phases:
            (tmp / "serve").mkdir()
            by_path["separate_wide"] = phase_separate_wide(
                torch, lstm_cuda, conv_cuda, args.seed, args.profile, tmp / "serve")
        if "train_wide" in phases:
            (tmp / "train").mkdir()
            by_path["train_wide"], run, run_config = phase_train_wide(
                torch, lstm_cuda, conv_fused, conv_cuda, args.seed, args.profile, tmp / "train")
        if "evaluate" in phases:
            (tmp / "evaluate").mkdir()
            by_path["evaluate"] = phase_evaluate(
                torch, lstm_cuda, args.seed, tmp / "evaluate", run, run_config)
    with tempfile.TemporaryDirectory(prefix="voicesplit_corpus_") as corpus_tmp:
        if "preprocess" in phases:
            by_path["preprocess"] = phase_preprocess(
                torch, lstm_cuda, conv_cuda, args.seed, Path(corpus_tmp))
        if "trainer_online" in phases:
            by_path["trainer_online"] = phase_trainer_online(
                torch, lstm_cuda, args.seed, args.profile, Path(corpus_tmp))
    with tempfile.TemporaryDirectory(prefix="voicesplit_dsp_") as dsp_tmp:
        if "dsp" in phases:
            by_path["dsp"] = phase_dsp(torch, lstm_cuda, args.seed, Path(dsp_tmp))
    if "streaming" in phases:
        by_path["streaming"] = phase_streaming(
            torch, lstm_cuda, conv_cuda, conv_fused, args.seed, args.profile)
    if "train_streaming" in phases:
        by_path["train_streaming"] = phase_train_streaming(
            torch, lstm_cuda, conv_cuda, conv_fused, args.seed, args.profile)
    if "encoder" in phases:
        with tempfile.TemporaryDirectory(prefix="voicesplit_encoder_") as enc_tmp:
            enc_kernels, by_path["encoder"] = phase_encoder(
                torch, lstm_cuda, args.seed, args.profile, Path(enc_tmp))
        # the fp32 grid routes' figures at the GE2E training shape, the one
        # path that launches them (their H=800 figures stay on the kernels
        # phase's lines)
        for name, key in (("lstm_fwd_grid", "lstm_fwd_ge2e_train"), ("lstm_bwd_grid", "lstm_bwd_ge2e_train")):
            r = enc_kernels[key]
            kern[name] = {**r, "timed_at": f"T={r['T']}, {r['rows']} rows, H={r['H']}, fp32 (GE2E step)"}
    if "voicefilter" in phases:
        by_path["voicefilter"] = phase_voicefilter(
            torch, lstm_cuda, conv_fused, conv_cuda, args.seed, args.profile)
    with tempfile.TemporaryDirectory(prefix="voicesplit_port_") as port_tmp:
        for name in ("reference", "import", "distributed", "export"):
            if name in phases:
                (Path(port_tmp) / name).mkdir()
        if "reference" in phases:
            by_path["reference"] = phase_reference(
                torch, lstm_cuda, args.seed, Path(port_tmp) / "reference")
        if "import" in phases:
            phase_import(torch, args.seed, Path(port_tmp) / "import")
        if "distributed" in phases:
            by_path["distributed"] = phase_distributed(
                torch, lstm_cuda, conv_fused, args.seed, args.profile, Path(port_tmp) / "distributed")
        if "long" in phases:
            by_path["long"] = phase_long(torch, lstm_cuda, conv_cuda, args.seed)
        if "export" in phases:
            by_path["export"] = phase_export(torch, lstm_cuda, conv_cuda, args.seed,
                                             Path(port_tmp) / "export")
    if "model_parallel" in phases:
        by_path["model_parallel"] = phase_model_parallel(
            torch, lstm_cuda, conv_fused, conv_cuda, args.seed)
    if "remat" in phases:
        by_path["remat"] = phase_remat(torch, lstm_cuda, conv_fused, conv_cuda, args.seed)
    if "channels" in phases:
        by_path["channels"] = phase_channels(torch, lstm_cuda, conv_fused, conv_cuda, args.seed)
    if "checkpoint" in phases:
        with tempfile.TemporaryDirectory(prefix="voicesplit_checkpoint_") as ckpt_tmp:
            by_path["checkpoint"] = phase_checkpoint(torch, lstm_cuda, args.seed, Path(ckpt_tmp))
    emit("total", wall_seconds=time.perf_counter() - t_start, phases=phases)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if set(phases) != set(PHASES):
        print(smi_line)
        print(json.dumps({"ok": True, "partial": phases, "device": device}))
        return 0
    # each kernel's launches come from the counted run of the path it serves
    home = {"lstm_fwd": "separate", "bilstm_fwd": "separate",
            "lstm_fwd_split": "separate_wide", "bilstm_fwd_split": "evaluate",
            "lstm_fwd_grid": "encoder", "bilstm_fwd_grid": "evaluate",
            "lstm_bwd": "train", "bilstm_bwd": "train",
            "lstm_bwd_split": "train_wide", "bilstm_bwd_split": "train_wide",
            "lstm_bwd_grid": "encoder", "bilstm_bwd_grid": "train_wide",
            "conv_bn_act_fwd": "train_fused", "conv_dgrad": "train_fused",
            "conv_wgrad": "train_fused",
            "conv_dilated_fwd": "trainer", "conv_dilated_wgrad": "trainer",
            "conv_bn_act_eval": "separate_dilated", "conv_draw_prologue": "train_fused"}
    # each kernel's figures in the type its path runs (bf16), or, for a route
    # that only fp32 takes (the forward's grid route at GRID_HIDDEN), in fp32
    kernels = [
        {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": by_path[home[name]].get(name, 0),
            "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
            "dtype": "bfloat16" if "bf16" in r else "float32",
            "max_abs_err": r.get("bf16", r.get("fp32"))["max_abs_err"],
            "max_abs_err_fp32": r["fp32"]["max_abs_err"] if "fp32" in r else None,
            "ms": r.get("bf16", r.get("fp32"))["ms"], "plain_ms": r.get("bf16", r.get("fp32"))["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("timed_at", "ms_by_batch_and_layer", "row_groups", "dwhh_ms",
                                 "dwhh_library_ms", "eager_draw_ms", "launches_by_ops_entry") if k in r},
        }
        for name, r in kern.items()
    ]
    check(len(kernels) == len(home), f"{len(kernels)} kernels reported, {len(home)} ported")
    for k in kernels:
        # the split walks and grid routes serve the shapes the cluster walks
        # cannot hold (H=800, the wide config): the wide paths take
        # WIDE_ROUTES in bf16 at B=1 and B=2 and, forward, two directions at
        # B=8 (the evaluation sweep); the one-direction grid routes serve the
        # GE2E encoder (fp32, H=768); the grid routes off every path are
        # OFF_PATH
        k["main_path"] = k["name"] not in OFF_PATH
        check(k["launches"] > 0 or not k["main_path"], f"{k['name']} was not launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
