#!/usr/bin/env python3
"""Smoke test of eeg_gnn_tpu_torch on one CUDA card (an NVIDIA H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. print the card's name and power limit; turn TF32 off; build the six
   CUDA sources of ``eeg_gnn_tpu_torch/csrc`` with nvcc, in parallel (one
   nvcc each), and print ptxas' register and spill report;
2. hold every kernel against its plain PyTorch version on the card at
   T=60, N=19, H=64 (D=100 and 64; M=3 and M=5, each per-clip and
   shared; B=128 and 37; float32 and bfloat16): the forward kernels
   (the ru/c residuals in one case each): the x-in layer as a whole and
   its bulk projection and state loop each on the same inputs, and the
   hoisted kernel; then the backward kernels on the forward's residuals
   and a random seeded h_seq cotangent (every output: dx or dx_proj, each
   dW, each db, dh0; at D=100 the x-in backward also without dx, as the
   first layer runs it, and both backwards once more, bitwise equal), the
   x-in backward's state loop, bulk dW split partials and bulk dx each on
   the same inputs, the hoisted backward as a whole (its loop, bulk dW at
   D=0 and reduction) and its bulk dW at D=0 alone, and the dW reduction,
   by the normalized inf-norm error
   max|k-p| / max|p|: float32 <= 1e-4
   (the same f32 arithmetic summed in another order), bfloat16 <= 2e-2
   (the bf16 bound of benchmarks/tpu_kernel_parity.json); then the
   seq2seq decoder kernels at T_out=12, D=100 (L=3, 2 and 1; the same M,
   B and dtype grid; force none, all and mixed): proj (and once each
   residual), and on a seeded proj cotangent the backward as a whole (dx,
   dh0 and all 14 weight and bias gradients; twice, bitwise equal) and
   each of its kernels on the same inputs (the state loop's dx, dh0, dpre
   and dproj; the bulk dW of layer 0 and of the tied cell, each reduced;
   the dWp partials), under the same bounds; the fused diffusion conv at
   the use_pallas loop's shapes (D=H=64, O=128 and 64, M=3 and 5, B=128
   and 37, once K=3; float32 <= 1e-4; operands staged by the wrapper) and
   its autograd Function's dx, dW,
   db against autograd of the plain version; the block-sparse SDDMM at the
   re-score study's montages (benchmarks/graph_build_bench.py:69-107:
   D=6000, N=19, 1024 and 4096 top-3, 4096 banded +-32; <= 1e-5, a bar
   that one TF32 pass on the same inputs, read beside it, must miss; twice,
   bitwise equal; at top-3 the edges its scores keep against a float64
   host oracle's), and a 19-node clip's normalized edge scores against
   its correlation adjacency (<= 1e-5);
3. serve the flagship DCRNN detector (2 DCGRU layers x 64 units, K=2,
   input_dim 100, T=60, batch 128, random weights from a seeded
   torch.Generator) through ``Predictor`` for both graph types, float32
   and bfloat16 and both ``input_fusion`` settings: every batch must
   launch its forward kernels once per layer (``SERVE_BATCH``: the x-in
   layer's projection and loop) and no backward kernel, and
   the probabilities must be finite, in [0, 1], and match an all-plain
   forward on the card (float32 atol 1e-4, bfloat16 atol 2e-2) and, on a
   small input, the CPU;
4. train the same detector through ``TrainStep`` in the same 8
   configurations (random labels, per-clip adjacency, Adam lr 1e-4, L2
   5e-4, clip 5.0, 100 epochs of 100 steps, as bench.py): 3 steps each,
   each launching exactly the kernels of ``TRAIN_STEP`` (per layer a
   forward and a backward; the x-in layer's projection, loops, dW and its
   reduction, and dx on layer 1 only; the hoisted layer's loop, its
   backward loop, dW at D=0 and reduction) and no other; finite
   losses; float32
   step-1 gradients against a ``recurrence="stacked"`` step from the same
   weights on the card (normalized per tensor, <= 1e-4) and, on a small
   input, the CPU; in bfloat16, the two-layer encoder's gradients under
   one seeded cotangent against the float32 stacked path's (<= 2e-2),
   and the model's step-1 gradients, the kernels' and the bfloat16
   stacked path's, each against a float32 stacked step (printed);
5. SSL next-window pre-training of the paper's SSL model through
   ``TrainStep`` (3 DCGRU layers x 64, K=2, D=100, T_in=60 -> T_out=12,
   batch 128, Adam lr 5e-4, L2 5e-4, clip 5.0, 350 epochs of 100 steps,
   as benchmarks/ssl_bench.py), combined and individual graphs, float32
   and bfloat16, curriculum on at batches_seen 24,000 (teacher-forcing
   ratio ~0.5, so the force vectors mix), 3 steps each, plus one
   curriculum-off run: each step launches exactly the kernels of
   ``SSL_STEP`` (3 x-in layers, 2 with dx; the decoder's forward, its
   backward loop, its 2 bulk dW products and dWp; 6 dW reductions, one
   per encoder layer and 3 for the decoder); finite
   losses; float32 step-1 gradients against a stacked step from the same
   weights and force draws (<= 1e-4) and, on 4 clips, the CPU; in
   bfloat16 the decoder's gradients under one seeded cotangent, and the
   model's step-1 gradients, each against the float32 stacked path's
   (<= 2e-2; the bfloat16 stacked path's printed beside);
6. time each kernel with CUDA events (median of 20 runs after warm-up;
   its plain version: of 5): the encoder's per layer (B=128, M=3; the
   x-in wrappers as a whole and each of their kernels alone; the first
   layer's backward without dx, as the train step runs it, and with dx;
   the bulk projection's and dx's operand staging alone, and their launch
   plans),
   the decoder's (B=128, M=3, L=3: the forward, the backward as a whole
   and each of its kernels; dWp beside one ``torch.matmul``; the state
   loops' weight staging alone, and their launch plans), the dW
   reduction beside ``torch.sum`` (at each x-in layer's split partials
   and at the decoder's three); bounds with every product of the bulk
   kernels (diffusions included) and dWp at the tensor-core rate for the
   stream dtype (bf16, or 3xTF32 for f32), the serial chains' products
   (diffusions included) likewise, split partials not counted (scratch),
   with the all-f32 bound of the x-in wrappers beside;
   the wrappers, which launch no kernel of their own, on a ``wrappers``
   line of their own without a launch count; the Predictor's clips/s, the
   detection and SSL train steps' ms and clips/s (detection also with
   input_fusion=False in bfloat16, the hoisted BPTT's path); trace one
   bfloat16 batch, the bfloat16 detection steps and one SSL step in each
   dtype with torch.profiler;
7. the ``use_pallas`` paths: the detector served through ``Predictor`` and
   trained through ``TrainStep`` (3 steps) in the 4 configurations of
   both graph types and dtypes, per-clip adjacency: every forward launches
   the fused diffusion-conv kernel 2 T L = 240 times and no other kernel;
   probabilities against the naive recurrence (float32 atol 1e-4,
   bfloat16 2e-2); float32 step-1 gradients against a stacked step (1e-4);
   in bfloat16 the encoder's VJP against the float32 stacked encoder
   (2e-2); and one SSL configuration (combined, float32, 3 steps, 360
   launches per step beside the decoder's kernels, ``DEC_BWD_STEP``);
8. the correlation re-score of each montage's fixed graph through
   ``sddmm_edges_blocksparse`` (one launch each), against the plain edge
   list;
9. time the two kernels beside their plain versions and bounds (both at
   the 3xTF32 tensor-core rate; #7's FMA-rate figure beside it), #7 on
   operands staged once and its staging of a layer's operands alone, the
   SDDMM also beside ``torch.sparse.sampled_addmm`` and the dense
   ``x @ x.T``; the use_pallas Predictor's clips/s and train step's ms;
10. the training CLI (``phase_cli``, run after 8, before the timings of 6
   and 9): a synthetic corpus of 64 files x 180 s held in memory (the card's
   machine has no h5py), then ``eeg_gnn_tpu_torch.cli.train.main`` three
   times at full width, 2 epochs, bf16: detection, SSL pre-training
   (curriculum on) and detection fine-tuned from the SSL run's best.npz,
   each with every count at 0 before it and its kernels launched; run
   files, finite losses, one train/Loss line per step, the transplanted
   encoder, and Predictor on run 1's best.npz reproducing its test AUROC
   within 1e-6; each epoch's wall time, train-loop clips/s beside the
   step's at B=40 (timed in 6), the loaders' share, and device busy over
   the traced fine-tune run;
11. the on-device input path (``phase_input``, run after 10, before the
   timings of 6): ``Predictor(pipeline=...).predict_proba_raw`` at B=128 on
   raw (128, 19, 12000) clips from a seed, both graphs and dtypes, against
   ``predict_proba`` on the numpy oracle's features with host supports
   (float32 <= 1e-4, bfloat16 <= 2e-2, normalized, all 128 clips; the at
   most 2 whose top-3 graph the card's rounding reorders take host
   supports built from the card's adjacency), its launches, the
   median of 20 batches and one traced batch (device busy, H2D ms); the
   pipeline's pieces (``featurize_clip``, ``features``, ``ssl_features``,
   the raw call; augmentation off and on, the same draws) on the card
   against the CPU (<= 1e-4); a resident bf16 cache of 4096 seeded
   detection clips (0.93 GB): an epoch of the cached train step at B=128
   with fused_steps 1 and 4 (accepted and ignored: the same losses), the
   same split rotating under a 0.5 GiB budget in 6 shards (each clip once
   an epoch, at most two slabs live, one x and one y copy a shard in the
   traced epoch, their overlap with the kernels from the trace),
   and an SSL cache (x and y, 72 windows): clips/s (beside the bare
   TrainStep's at B=128, logged after 6), device busy over a traced
   epoch, ``max_memory_allocated`` and the launches; the combined graph
   without augmentation, so the supports are one shared (S, N, N) slab;
   then ``cli.train.main`` on phase 10's corpus with --hbm_cache
   (detection, SSL), --device_pipeline --graph_type individual and
   --hbm_cache --fused_steps 4, each untraced (epoch s, clips/s, loader
   wait) and traced (device busy);
12. seizure-type classification (``phase_classification``, run last;
   configs/run_dcrnn_classification.sh: 2 layers x 64, K=2, D=100, T=60,
   4 classes, dropout 0.5): the train step through ``TrainStep`` at
   B=128, combined (M=3) and individual (M=5), float32 and bfloat16, on
   zero-padded clips of seeded lengths over 1..60 that include 1 and 60,
   each step launching exactly ``TRAIN_STEP[True]``; step 1 twice on the
   same inputs and dropout draws, bitwise equal gradients; logits against
   the stacked path (float32 <= 1e-4, bfloat16 <= 2e-2) and float32
   step-1 gradients (<= 1e-4); in bfloat16 the encoder's gradients under
   the classifier's scattered cotangent (one (B, N, H) slab at each
   clip's last step) against the float32 stacked encoder (<= 2e-2);
   ``Predictor`` class probabilities with per-clip ``seq_lengths``
   against the stacked path; a ``.pth.tar`` export served through
   ``from_checkpoint`` bitwise equal to the ``.npz``'s; the step's ms
   and clips/s (synchronised, back to back) and one traced step; then
   ``cli.train.main --task classification --num_classes 4 --dropout 0.5
   --data_augment`` on phase 10's corpus: streaming, --hbm_cache
   (combined, individual), rotating past --hbm_budget_gb, and
   --fine_tune from a ``.pth.tar`` of phase 10's SSL run, each
   launching the detector's kernels and no other (epoch s, clips/s,
   loader wait);
13. the baselines (``phase_baselines``, after 12; configs/run_lstm*.sh,
   run_cnnlstm*.sh, run_densecnn*.sh: T=60, N=19, D=100; LSTM 2 x 64 on
   1900 inputs, the CNN-LSTM's fixed widths, the Dense-CNN's 10 channels
   on (6000, 19), fc1 54720 -> 128), float32, TF32 off as phase 1 left
   it: each family's eval forward on the card against the same weights
   on the CPU at the serving batch (128; the Dense-CNN's 2), <= 1e-4;
   ``TrainStep``'s step-1 gradients (dropout 0) on the card against the
   CPU's, <= 1e-3, the Dense-CNN's in float64 on both sides (its
   max-pools' gradients jump at near ties, which float32 rounding flips;
   its card float32 gradients against float64 printed beside); the step
   at B=40 (median of 20 synchronised, best of 3 runs back to back; the
   Dense-CNN 5, and again under cuDNN TF32, torch's default), its FLOP/s
   and one traced step; ``Predictor`` clips/s; a ``.pth.tar`` and an
   ``.npz`` (+ ``.state.npz``) of the trained weights served bitwise
   equal; then ``cli.train.main`` for 2 epochs on phase 10's corpus
   (LSTM and CNN-LSTM detection, the Dense-CNN's 4-class classification
   on the flat-clip dataset; --dtype bfloat16 accepted, the baselines run
   float32). No hand-written kernel launches in the phase (the kernels
   line's ``launches_by_path`` gains ``baselines``, all 0);
14. data-parallel scale-out (``phase_scaleout``, after 13;
   ``eeg_gnn_tpu_torch/parallel``): (a) one NCCL rank in this process,
   the flagship detection step (bf16, then f32) through the mesh path for
   3 steps at B=128, each launching ``TRAIN_STEP[True]`` and one gradient
   all-reduce, its parameters bitwise equal to ``TrainStep`` without a
   mesh; (b)-(d) two gloo ranks sharing the card, each a process of this
   script (``--scaleout-rank RANK PORT DIR``; the kernels built in 1, so no
   rank runs nvcc; each rank's exit code checked, a time limit on each):
   (b) the same 3 steps at global B=128, 64 rows a rank, f32 (TF32 off)
   and bf16, each rank's launches ``TRAIN_STEP``'s a step, the ranks'
   parameters bitwise equal and against (a)'s (normalized inf-norm of the
   parameter vector: f32 <= 1e-5, bf16 <= 2e-2); (c) ``Predictor(mesh=)``
   on 200 clips at batch 128 against a single Predictor (f32, <= 1e-5),
   the same probabilities on both ranks; (d) ``cli.train.main`` on two
   ranks and on one, 2 epochs on phase 10's corpus (made again in each
   rank), f32: streaming at the recipe's lr (the same batches on one
   rank and two), and ``--hbm_cache`` (each rank its block of the train
   split) at lr 1e-7, under which each rank's own shuffle of its block
   (JAX's sharded plans) cannot part the runs: the ranks' metrics equal,
   and close to one rank's (loss rtol and atol
   2e-3, acc 1e-6, AUROC 5e-3); ``time scaleout ...`` lines (the step ms
   at one NCCL rank and a rank of two; the gradient all-reduce's ms and
   bytes a step, the gloo figure through the host). The kernels line's
   ``launches_by_path`` gains ``scaleout_nccl`` and each gloo rank's
   ``scaleout_gloo_*`` paths (rank 1's with ``_rank1``).
15. the mesh's graph axis (``phase_graph_axis``, after 14;
   ``parallel/edge_partition``, ``parallel/sparse_model``, ``entry``): (a)
   graph:1 on one NCCL rank in this process: the ring SpMM at N=4096,
   D=128, E=4N (f32, TF32 off) against the dense product (rtol and atol
   1e-4); the sparse DCGRU encoder at the detector's full width (2 layers
   x 64, K=2, D=100, T=60, B=128, one laplacian support a clip: 2432
   nodes) against the dense encoder (``recurrence="stacked"``) on the
   same supports (rtol 2e-4, atol 2e-5); one sparse step's gradients
   against the dense path's (rtol 2e-3, atol 1e-5); 3 steps; then, outside
   the counted window, ``time graph axis (a) ...`` (the ring beside
   ``torch.sparse.mm`` on CSR, the sparse forward and step beside the
   dense step, stacked and through the kernels; median of 20) and
   ``entry()``'s forward on the card against the CPU (normalized <= 1e-4);
   (b) two gloo ranks sharing the card (``--graph-rank RANK PORT DIR``,
   logs in ``chiprun_out/graph_axis/rank{R}.log``; NCCL refuses two ranks
   on one device): the ring SpMM gathered against (a)'s, each rank's
   ``max_memory_allocated`` across it within 1.5x the block budget (3
   (N/p, D) blocks, the gathered-edge temporary, the edge shard), 3 sparse
   steps at full width (ranks bitwise equal; the first step's gradients
   and the parameters after the steps against (a)'s, normalized inf-norm
   <= 1e-5, phase 14's bar, beside (a)'s own spread between two runs:
   CUDA ``index_add_`` sums with atomics), the ring shifts and bytes a
   step, the step's time, and
   ``dryrun_multichip(2)``. No hand-written kernel launches on the graph
   path: the kernels line's ``launches_by_path`` gains ``graph_axis``,
   ``graph_axis_gloo`` (and ``_rank1``), all 0, beside ``entry`` (the
   flagship forward's kernels) and ``dryrun_gloo`` (and ``_rank1``; the
   dry run's data-parallel steps launch the detector's).
16. the offline input path (``phase_ingest``, run after 11, before the
   timings of 6; ``data/edf.py``, ``cli/preprocess.py``,
   ``data/clipstore.py`` and ``native/clipstore.cpp``): phase 10's 64
   recordings written as EDF at 250 Hz (scipy's FFT resampling up from
   200 Hz; TUSZ-style ``-REF`` labels, 4 seeded channels outside the
   montage, the channels in a seeded order; the annotations beside),
   ingested by ``resample_all(signals=...)`` (s a file, EDF MB/s) and held
   against the 200 Hz originals channel by channel: at most the clean
   200 -> 250 -> 200 Hz round trip's error plus half an int16 step of the
   channel's EDF range grown by the 250 -> 200 Hz resampler's inf-norm;
   a clip store a split from the detection markers on the ingested
   signals (g++ builds the native gather at first use), whose train
   store's native gather is bitwise equal to its plain version on every
   batch of an epoch's plan at B=40, a batch bitwise equal to
   ``raw_clip`` of the ingested signals, and out-of-range indices raise;
   the gather's ms, clips/s and GB/s at B=40 and 128, one thread and the
   default, a fresh batch and a reused one; step 1 of the full-width
   detector (combined, bf16, ``--device_pipeline``'s ``DevicePipeline``)
   on the store's first batch against the same clips streamed through
   ``RawDetectionDataset`` (same weights and generator; rel 1e-4, bitwise
   expected); then ``run_experiment`` for 2 epochs at B=40 on
   ``ClipStoreLoader``s, untraced and traced, and on the streaming
   loaders, each step launching exactly ``TRAIN_STEP[True]``: epoch s,
   train-loop clips/s, loader-wait share and device busy beside
   ``phase_input``'s ``--device_pipeline`` run. The phase's files (EDF,
   stores, runs) are removed at the end. The kernels line's
   ``launches_by_path`` gains ``ingest_clipstore``.

The second-to-last line is a JSON object describing the kernels (the
x-in wrappers, the hoisted backward and the decoder's backward, which
launch none of their own, are on the ``wrappers`` line before it); the
last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T, N, H, K = 60, 19, 64, 2
T_OUT, SSL_LAYERS = 12, 3   # configs/run_dcrnn_ssl.sh, ssl_bench.py:55-66
BATCHES_SEEN = 24_000       # ratio 3000 / (3000 + e^8) ~ 0.5
BATCH = 128
F32_TOL, BF16_TOL = 1e-4, 2e-2
# the 3xTF32 SDDMM against full f32: above its f32-accurate reading, below
# one TF32 pass's, which phase_sddmm_parity reads beside it as a control
SDDMM_TOL = 1e-5
PEAK_F32_FLOPS = 67e12   # H100 SXM, non-tensor float32 (NVIDIA data sheet)
PEAK_BF16_TC = 989e12    # dense bf16 tensor cores
PEAK_TF32_TC = 495e12    # dense TF32 tensor cores; 3xTF32 does 3 per product
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
REPS = 20
STEPS_PER_EPOCH = 100
TRAIN_KW = dict(lr_init=1e-4, l2_wd=5e-4, max_grad_norm=5.0,
                num_epochs=100)  # bench.py:66
SSL_KW = dict(lr_init=5e-4, l2_wd=5e-4, max_grad_norm=5.0,
              num_epochs=350)  # benchmarks/ssl_bench.py:62
FWD = ("dcgru_recurrence_xin_fwd", "dcgru_recurrence_fwd")
BWD = ("dcgru_recurrence_xin_bwd", "dcgru_recurrence_bwd")
DEC = ("dcgru_decoder_fwd", "dcgru_decoder_bwd")
DEC_BWD = ("dcgru_dec_bwd_loop", "dcgru_dec_dwp")  # kernels of DEC[1]
FDC = "fused_diffusion_conv_fwd"  # kernel #7, the use_pallas loop's
SDDMM = "sddmm_blocksparse"       # kernel #8, the correlation re-score
XIN_FWD = ("dcgru_xin_proj", "dcgru_xin_fwd_loop")  # the kernels of FWD[0]
XIN_BWD = ("dcgru_xin_bwd_loop", "dcgru_xin_dw", "dcgru_xin_dx")  # of BWD[0]
# BWD[1]'s: the same loop, the bulk dW at D = 0 (no input x), a reduction
HOISTED_BWD = XIN_BWD[:2] + ("dcgru_dw_reduce",)
# FWD[0], BWD[0], BWD[1] and DEC[1] launch no kernel of their own: they are
# timed and held against their plain versions as wrappers, and their
# kernels are counted
KERNELS = ((FWD[1], "dcgru_dw_reduce") + XIN_FWD + XIN_BWD
           + (DEC[0],) + DEC_BWD + (FDC, SDDMM))
SSL_KERNELS = ("dcgru_dw_reduce",) + XIN_FWD + XIN_BWD + (DEC[0],) + DEC_BWD
# launches per batch or step: the x-in layer's forward is a projection and
# a loop, its backward a loop, a dW product (+ its reduction) and, on every
# layer but the first (fed data), a dx product; the hoisted layer's forward
# is one loop, its backward a loop and a dW product at D = 0 (+ reduction)
SERVE_BATCH = {True: {XIN_FWD[0]: 2, XIN_FWD[1]: 2}, False: {FWD[1]: 2}}
TRAIN_STEP = {True: {"dcgru_dw_reduce": 2, XIN_FWD[0]: 2, XIN_FWD[1]: 2,
                     XIN_BWD[0]: 2, XIN_BWD[1]: 2, XIN_BWD[2]: 1},
              False: {FWD[1]: 2, XIN_BWD[0]: 2, XIN_BWD[1]: 2,
                      "dcgru_dw_reduce": 2}}
# the decoder's backward (L > 1): its loop, one bulk dW product per cell
# (layer 0; the tied cell over layers 1..L-1), dWp, and a reduction each
DEC_BWD_STEP = {DEC_BWD[0]: 1, XIN_BWD[1]: 2, DEC_BWD[1]: 1,
                "dcgru_dw_reduce": 3}
SSL_STEP = {"dcgru_dw_reduce": 3 + 3, DEC[0]: 1, DEC_BWD[0]: 1,
            DEC_BWD[1]: 1, XIN_FWD[0]: 3, XIN_FWD[1]: 3, XIN_BWD[0]: 3,
            XIN_BWD[1]: 3 + 2, XIN_BWD[2]: 2}  # at 3 layers
XIN_GRADS = ("dx", "dwxg_f", "dwxc_f", "dwg_r", "dwc_r", "dbg", "dbc", "dh0")
HOISTED_GRADS = ("dx_proj", "dwg_r", "dwc_r", "dbg", "dbc", "dh0")
DW_D0 = f"{XIN_BWD[1]} (D=0)"  # the bulk dW as BWD[1] runs it
DEC_GRADS = ("dx", "dh0", "dwx0g", "dwx0c", "dwh0g", "dwh0c", "db0g",
             "db0c", "dwxsg", "dwxsc", "dwhsg", "dwhsc", "dbsg", "dbsc",
             "dwp", "dbp")
# (M, shared graph) of the encoder kernels' parity cases: the combined
# graph (M=3) per clip and shared, the individual graph (M=5) likewise
OPS_CASES = ((3, False), (3, True), (5, False), (5, True))
PALLAS_FWD = 2 * T * 2           # fused convs per 2-layer detector forward
PALLAS_SSL = 2 * T * SSL_LAYERS  # per SSL step
D_SIG, TOP_K, BAND = 6000, 3, 32  # benchmarks/graph_build_bench.py:70-100
# the training CLI's corpus (synthetic, held in memory: the card's machine
# has no h5py) and runs: the detector at full width, 2 epochs
CLI_CORPUS = dict(num_files=64, file_seconds=180, clip_len=T, seed=0)
CLI_BATCH, CLI_EPOCHS = 40, 2   # --train_batch_size (the JAX default)
CLI_DETECT = XIN_FWD + XIN_BWD + ("dcgru_dw_reduce",)  # kernels #1, #3
MONTAGES = ((19, "topk"), (1024, "topk"), (4096, "topk"), (4096, "banded"))
# the on-device input path (phase_input): a resident split at a size a user
# holds (4096 clips x (60, 19, 100) in bf16 = 0.93 GB), the budget that
# rotates it in 6 shards, and the seeded data's scale
INPUT_CLIPS = 4096
ROTATING_BUDGET = 2 ** 29        # 0.5 GiB
FEAT_MEAN, FEAT_STD = 5.0, 1.0   # the scaler of the log-amplitude features
RAW_SCALE = 20.0                 # amplitude of the seeded raw clips
# seizure-type classification (configs/run_dcrnn_classification.sh): 4
# classes, dropout 0.5; the CLI's rotating run's budget (4 train shards)
CLS_CLASSES, CLS_DROPOUT = 4, 0.5
CLS_ROTATING_GB = 0.01
# the offline input path (phase_ingest): phase 10's recordings as EDF at
# TUSZ's usual rate, with channels outside the montage; the markers'
# undersampling seed and the loaders' shuffle seed; the gather's timed reps
INGEST_RATE = 250
INGEST_EXTRA = ("EEG A1-REF", "EKG1-REF", "EEG A2-REF", "PHOTIC-REF")
INGEST_SEED = 123
GATHER_REPS = 20
# the baselines (configs/run_{lstm,cnnlstm,densecnn}*.sh): (model, task, lr,
# epochs of the recipe); LSTM 2 x 64 on 1900 inputs, the CNN-LSTM at its
# fixed widths, the Dense-CNN 10 channels on the (6000, 19) plane; train
# batch 40 (the default), serving batch 128 (the Dense-CNN's recipes: 2)
BASELINES = (("lstm", "detection", 1e-4, 100),
             ("cnnlstm", "detection", 1e-4, 100),
             ("densecnn", "classification", 3e-4, 60))
BASE_SERVE = {"lstm": BATCH, "cnnlstm": BATCH, "densecnn": 2}
BASE_GRAD_BATCH = {"lstm": 8, "cnnlstm": 8, "densecnn": 2}
BASE_REPS = {"lstm": REPS, "cnnlstm": REPS, "densecnn": 5}
GRAD_TOL = 1e-3  # the baselines' step-1 gradients, card against the CPU
# data-parallel scale-out (phase_scaleout): steps a run, the two gloo ranks
# and their time limit, the f32 bar of two ranks against one (normalized
# inf-norm of the parameters after the steps), and the CLI runs on two
# ranks and on one, in f32 (an untrained model's test probabilities lie
# within bf16's rounding of each other, so its AUROC would read the
# rounding): streaming at the recipe's lr (the same batches as one
# rank's), and --hbm_cache at a learning rate under which each rank's own
# shuffle of its block (the sharded plans) cannot part the runs
SCALE_STEPS, SCALE_RANKS, SCALE_TIMEOUT = 3, 2, 240
SCALE_F32_TOL = 1e-5
SCALE_CLI_LR = 1e-7
SCALE_CLI = {"stream": ["--dtype", "float32"],
             "hbm": ["--dtype", "float32", "--hbm_cache", "--lr_init",
                     str(SCALE_CLI_LR)]}
# the graph axis (phase_graph_axis): the ring SpMM at the per-rank memory
# test's shape (tests/test_sparse_distributed.py: N=4096, D=128, E=4N),
# the sparse encoder and step at the detector's full width (B*N = 2432
# nodes, one laplacian support a clip); the two gloo ranks, their steps
# and time limit; the bars: the ring against the dense product and the
# sparse encoder against the dense one (tests/test_sparse_distributed.py),
# a step's gradients against the dense path's (the same file's), and the
# memory's slack over the block budget (the same file's). Two ranks'
# first-step gradients and parameters after the steps are held to one
# rank's at SCALE_F32_TOL, phase_scaleout's bar and measure (normalized
# inf-norm of the vector): CUDA index_add_ adds with atomics, so every run
# sums in its own order, and Adam turns the rounding of gradients near its
# eps (1e-8) into differences of up to ~1% of lr in a few entries; one
# rank's two runs differ by as much (the phase prints that spread beside)
RING_N, RING_D = 4096, 128
GRAPH_RANKS, GRAPH_STEPS, GRAPH_TIMEOUT = 2, 3, 300
RING_TOL = 1e-4
ENC_RTOL, ENC_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5
MEM_SLACK = 1.5


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def adjacency(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Random symmetric adjacency with unit diagonal (bench.py:34-43)."""
    adj = np.abs(rng.rand(n, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    return adj


def layer_inputs(torch, dev, *, d, m, shared, b, dtype, seed):
    """Operators, weights and streams of one DCGRU layer, as the model's
    ``_layer_scan`` hands them to the kernels."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcgru import DCGRUConfig, init_dcgru_cell
    from eeg_gnn_tpu_torch.ops.recurrent import (
        chebyshev_operators,
        rearrange_hidden_weight,
    )

    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    filt = "laplacian" if m == 3 else "dual_random_walk"
    adj = torch.from_numpy(adjacency(rng, 1 if shared else b)).to(dev)
    a_ops = chebyshev_operators(compute_supports_torch(adj, filt), K)
    a_ops = a_ops.contiguous()
    cfg = DCGRUConfig(d, H, K, N, (m - 1) // K)
    p = {k: v.to(dev) for k, v in init_dcgru_cell(gen, cfg).items()}
    p["gate_b"] = 0.1 * torch.randn(2 * H, generator=gen).to(dev)
    p["cand_b"] = 0.1 * torch.randn(H, generator=gen).to(dev)
    cut = d * m
    wx_g, wx_c = p["gate_w"][:cut], p["cand_w"][:cut]
    mmajor = lambda w: w.reshape(d, m, -1).transpose(0, 1).reshape(
        m * d, -1).contiguous()
    x = torch.randn((T, b, N, d), generator=gen).to(dev, dtype)
    x_proj = (0.5 * torch.randn((T, b, N, 3 * H), generator=gen)).to(
        dev, dtype)
    return {
        "x": x, "x_proj": x_proj, "a_ops": a_ops,
        "wxg_f": mmajor(wx_g), "wxc_f": mmajor(wx_c),
        "wg_r": rearrange_hidden_weight(p["gate_w"][cut:], H, m).contiguous(),
        "wc_r": rearrange_hidden_weight(p["cand_w"][cut:], H, m).contiguous(),
        "gate_b": p["gate_b"], "cand_b": p["cand_b"],
        "h0": (0.1 * torch.randn((b, N, H), generator=gen)).to(dev),
    }


def xin_args(a):
    return (a["x"], a["a_ops"], a["wxg_f"], a["wxc_f"], a["wg_r"], a["wc_r"],
            a["gate_b"], a["cand_b"], a["h0"])


def hoisted_args(a):
    return (a["x_proj"], a["a_ops"], a["wg_r"], a["wc_r"], a["gate_b"],
            a["cand_b"], a["h0"])


def bwd_args(torch, a, seed):
    """Backward-kernel arguments of one layer: the forward's residuals
    (plain version) and a random seeded h_seq cotangent."""
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
    from eeg_gnn_tpu_torch.ops.recurrent import shift_h_prev

    h_seq, ru, c = cr.dcgru_recurrence_xin_fwd_plain(*xin_args(a),
                                                     residuals=True)
    gen = torch.Generator().manual_seed(seed)
    d_seq = torch.randn(tuple(h_seq.shape), generator=gen).to(
        h_seq.device, h_seq.dtype)
    streams = (shift_h_prev(a["h0"], h_seq), ru, c)
    xin = (a["a_ops"], a["wxg_f"], a["wxc_f"], a["wg_r"], a["wc_r"],
           *streams, a["x"], d_seq)
    hoisted = (a["a_ops"], a["wg_r"], a["wc_r"], *streams, d_seq)
    return xin, hoisted


def wrappers() -> dict:
    """Each kernel's wrapper, by name (its ``.launches`` is the count)."""
    from eeg_gnn_tpu_torch.ops import (
        cuda_decoder,
        cuda_kernels,
        cuda_recurrent,
        sddmm,
    )

    module = {FDC: cuda_kernels, SDDMM: sddmm}
    module.update({k: cuda_decoder for k in (DEC[0],) + DEC_BWD})
    return {k: getattr(module.get(k, cuda_recurrent), k) for k in KERNELS}


def counts() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def norm_err(k, p) -> tuple[float, float]:
    """(normalized inf-norm error, max abs error) of kernel vs plain."""
    k, p = k.float(), p.float()
    max_abs = float((k - p).abs().max())
    return max_abs / max(float(p.abs().max()), 1e-12), max_abs


# ---------------------------------------------------------------------------
# counts for the bound
# ---------------------------------------------------------------------------


def layer_work(*, xin: bool, d: int, m: int, b: int, a_batch: int,
               stream_bytes: int, xp_bytes: int = 0) -> tuple:
    """The work of one forward launch: the identity operator A_0 is
    skipped, each input is read once and each output written once. The
    loop fed x_proj (``xp_bytes`` wide elements, by default the stream's):
    (0, bytes, chain FLOPs, their rate), its products, diffusions included,
    at the tensor-core rate for the stream dtype (``_tc``), as the loop
    runs them. ``xin``: the x-in wrapper's work as one launch, (FLOPs,
    bytes) with every product at the f32 FMA rate (its all-f32 bound)."""
    diff_h = 2 * (m - 1) * N * N * H           # A_m h and A_m (r*h)
    gemm_h = 2 * N * (m * H) * 3 * H           # hidden rows, gate + cand
    per_step = 2 * diff_h + gemm_h
    nbytes = (m * H * 3 * H + 3 * H) * 4       # hidden weights + biases
    if xin:
        per_step += 2 * (m - 1) * N * N * d    # A_m x
        per_step += 2 * N * (m * d) * 3 * H    # input rows, gate + cand
        nbytes += m * d * 3 * H * 4 + T * b * N * d * stream_bytes
    else:
        nbytes += T * b * N * 3 * H * (xp_bytes or stream_bytes)
    nbytes += m * a_batch * N * N * 4 + b * N * H * 4      # a_ops, h0
    nbytes += T * b * N * H * stream_bytes                 # h_seq
    if xin:
        return float(per_step) * T * b, float(nbytes)
    return (0.0, float(nbytes), *_tc(per_step * T * b, stream_bytes))


def bwd_work(*, xin: bool, d: int, m: int, b: int, a_batch: int,
             stream_bytes: int, need_dx: bool = True) -> tuple:
    """The work of one backward launch (A_0 = I skipped; the per-clip dW
    partial slabs are scratch and not counted). Per step and clip: the
    diffusions of [h_prev | r h_prev | x] recomputed, the dW products, the
    weight-transpose products and two A^T applies; without ``need_dx`` the
    last two have no x columns and dx is not written. The hoisted kernel's:
    (db's sums, bytes, the products, their rate), products at the
    tensor-core rate for the stream dtype (``_tc``); with ``xin`` the old
    fused x-in kernel's, (FLOPs, bytes) all at the f32 FMA rate (the
    all-f32 bound of the x-in wrapper)."""
    dx = d if xin else 0
    dxo = dx if need_dx else 0
    per_step = 2 * (m - 1) * N * N * (2 * H + dx)    # recomputed features
    per_step += 2 * N * m * (H + dx) * 3 * H         # dW
    per_step += 2 * N * 3 * H * m * (H + dxo)        # dpre W^T
    per_step += 2 * 2 * (m - 1) * N * N * (H + dxo)  # two A^T applies
    db = N * 3 * H
    wsize = m * (H + dx) * 3 * H
    nbytes = wsize * 4 * 2 + 3 * H * 4                 # W in, dW + db out
    nbytes += T * b * N * (5 * H + dx) * stream_bytes  # h_prev ru c d_seq x
    nbytes += T * b * N * (dxo if xin else 3 * H) * stream_bytes  # dx/dxp
    nbytes += m * a_batch * N * N * 4 + b * N * H * 4  # a_ops, dh0
    if xin:
        return float(per_step + db) * T * b, float(nbytes)
    return (float(db) * T * b, float(nbytes),
            *_tc(per_step * T * b, stream_bytes))


def _tc(flops: float, stream_bytes: int) -> tuple[float, float]:
    """Products at the tensor-core rate for the stream dtype: bf16 for bf16
    streams (the reference's one bf16 pass); for f32 the exact-f32 3xTF32
    (three TF32 products each, a third of the TF32 rate)."""
    if stream_bytes == 2:
        return float(flops), PEAK_BF16_TC
    return float(flops), PEAK_TF32_TC / 3


def proj_work(*, d: int, m: int, b: int, a_batch: int,
              stream_bytes: int) -> tuple:
    """(FMA FLOPs, bytes, tensor-core FLOPs, their rate) of one bulk input
    projection: the diffusions A_m x (A_0 = I skipped) and the (M*D, 3H)
    product, all products at the tensor-core rate; x, Wx, the operators
    read once, XP (f32) written once."""
    rows = T * b * N
    diff = 2 * (m - 1) * N * N * d * T * b
    nbytes = (rows * d * stream_bytes + m * d * 3 * H * 4
              + m * a_batch * N * N * 4 + rows * 3 * H * 4)
    return (0.0, float(nbytes),
            *_tc(diff + 2 * rows * m * d * 3 * H, stream_bytes))


def bwd_loop_work(*, m: int, b: int, a_batch: int, stream_bytes: int):
    """(0, bytes, chain FLOPs, their rate) of the state-only backward loop:
    per step and clip the weight-transpose products dpre W_h^T and two A^T
    applies, at the tensor-core rate for the stream dtype (``_tc``); h_prev,
    ru, c, d_seq read once, dpre (f32) and dh0 written once."""
    per_step = 2 * N * 3 * H * m * H + 4 * (m - 1) * N * N * H
    nbytes = m * H * 3 * H * 4 + T * b * N * 5 * H * stream_bytes
    nbytes += T * b * N * 3 * H * 4 + m * a_batch * N * N * 4 + b * N * H * 4
    return (0.0, float(nbytes), *_tc(per_step * T * b, stream_bytes))


def dw_work(*, d: int, m: int, b: int, a_batch: int, stream_bytes: int,
            t: int = T) -> tuple:
    """One bulk dW product over ``t`` steps: the features A_m [x | h_prev |
    r h_prev] and the three products at the tensor-core rate, db's sums on
    FMA; x, h_prev, r, dpre and the operators read once, dW and db written
    once (the split partials are scratch of the design)."""
    from eeg_gnn_tpu_torch.ops.cuda_recurrent import dw_size

    rows = t * b * N
    diff = 2 * (m - 1) * N * N * (d + 2 * H) * t * b
    nbytes = rows * (d + 2 * H) * stream_bytes + rows * 3 * H * 4
    nbytes += m * a_batch * N * N * 4 + dw_size(m, d, H) * 4
    tc = diff + 2 * rows * (m * d * 3 * H + m * H * 2 * H + m * H * H)
    return (float(rows * 3 * H), float(nbytes), *_tc(tc, stream_bytes))


def dx_work(*, d: int, m: int, b: int, a_batch: int,
            stream_bytes: int) -> tuple:
    """One bulk dx product: A_m^T dpre and the (3H, M*D) product at the
    tensor-core rate; dpre, Wx, the operators read once, dx written
    once."""
    rows = T * b * N
    diff = 2 * (m - 1) * N * N * 3 * H * T * b
    nbytes = (rows * 3 * H * 4 + m * d * 3 * H * 4
              + m * a_batch * N * N * 4 + rows * d * stream_bytes)
    return (0.0, float(nbytes),
            *_tc(diff + 2 * rows * 3 * H * m * d, stream_bytes))


def _cell_fwd_flops(d: int, m: int) -> int:
    """FLOPs of one DCGRU cell step of one clip at input width d (A_0 = I
    skipped): the diffusions of [h | in] and of r*h, and the products."""
    return (2 * (m - 1) * N * N * (2 * H + d)
            + 2 * N * (m * d + m * H) * 3 * H)


def _dec_weights(d: int, m: int, layers: int) -> int:
    """Floats of the decoder's weights and biases (layer 0, the shared
    cell, the projection)."""
    cell = lambda din: m * (din + H) * 3 * H + 3 * H
    return cell(d) + (cell(H) if layers > 1 else 0) + H * d + d


def dec_work(*, d: int, m: int, layers: int, b: int, a_batch: int,
             stream_bytes: int) -> tuple:
    """(0, bytes, chain FLOPs, their rate) of one decoder forward launch:
    per clip-step each layer's cell (layer 0 at width d, the rest at H) and
    the projection, at the tensor-core rate for the stream dtype (``_tc``);
    x, the operators, h0 and the weights read once, proj and the residuals
    (in0, h, ru, c) written once."""
    per_step = _cell_fwd_flops(d, m) + (layers - 1) * _cell_fwd_flops(H, m)
    per_step += 2 * N * H * d
    nbytes = _dec_weights(d, m, layers) * 4 + T_OUT * 4
    nbytes += m * a_batch * N * N * 4 + layers * b * N * H * 4
    nbytes += T_OUT * b * N * (3 * d + 4 * layers * H) * stream_bytes
    return (0.0, float(nbytes), *_tc(per_step * T_OUT * b, stream_bytes))


def dec_loop_work(*, d: int, m: int, layers: int, b: int, a_batch: int,
                  stream_bytes: int) -> tuple:
    """(0, bytes, chain FLOPs, their rate) of the decoder's backward state
    loop, at the tensor-core rate for the stream dtype (``_tc``): per
    clip-step dproj Wp^T and per layer the weight-transpose products dpre
    W^T, two A^T applies of the state's width (drh, dh) and one of the
    input's (both halves of dpre summed before it; layer 0's D wide);
    h_prev, ru, c, d_seq read once, dx, dpre and dproj (f32) and dh0
    written once."""
    def cell(din):
        return (2 * N * 3 * H * m * (H + din)             # dpre W^T
                + 2 * (m - 1) * N * N * (2 * H + din))    # A^T applies
    per_step = cell(d) + (layers - 1) * cell(H) + 2 * N * d * H
    weights = m * (d + H) * 3 * H + H * d            # no biases read
    weights += m * 2 * H * 3 * H if layers > 1 else 0
    nbytes = weights * 4 + T_OUT * 4
    nbytes += m * a_batch * N * N * 4 + layers * b * N * H * 4
    rows = T_OUT * b * N
    nbytes += rows * (4 * layers * H + 2 * d) * stream_bytes  # in; dx out
    nbytes += rows * (3 * layers * H + d) * 4                 # dpre, dproj
    return (0.0, float(nbytes), *_tc(per_step * T_OUT * b, stream_bytes))


def dec_dw_work(*, d: int, m: int, layers: int, b: int, a_batch: int,
                stream_bytes: int) -> list:
    """The decoder's two bulk dW products: layer 0 (input width d, T_out
    steps) and the tied cell (width H, (L-1) T_out stacked steps)."""
    kw = dict(m=m, b=b, a_batch=a_batch, stream_bytes=stream_bytes)
    work = [dw_work(d=d, t=T_OUT, **kw)]
    if layers > 1:
        work.append(dw_work(d=H, t=(layers - 1) * T_OUT, **kw))
    return work


def dwp_work(*, d: int, b: int, stream_bytes: int) -> tuple:
    """dWp = h_top^T dproj over T_out*B*N rows: the product at the
    tensor-core rate for the stream dtype (the reference's one bf16 pass,
    ``pallas_decoder.py:262``), dbp's sums on FMA; h_top and dproj (f32)
    read once, dWp and dbp written once (the split partials are scratch of
    the design)."""
    rows = T_OUT * b * N
    return (float(rows * d),
            float(rows * (H * stream_bytes + d * 4) + (H * d + d) * 4),
            *_tc(2 * rows * H * d, stream_bytes))


def reduce_work(b: int, w: int) -> tuple[float, float]:
    """(FLOPs, bytes) of summing a (B, W) f32 slab over B."""
    return float(b * w), float((b * w + w) * 4)


def bound_ms(work) -> tuple[float, str]:
    """The least time for the work items, one per kernel launch (FMA
    FLOPs, bytes[, tensor-core FLOPs, their rate]): in each item FMA at
    the non-tensor f32 rate and tensor-core products at theirs, which
    overlap (the larger of the two); bytes at the HBM rate; the larger of
    operations and bytes over all items."""
    t_ops = sum(max(w[0] / PEAK_F32_FLOPS, w[2] / w[3] if len(w) > 2 else 0)
                for w in work)
    t_bytes = sum(w[1] for w in work) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps=REPS, warmup=3, lead=True) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events). With
    ``lead`` the stream first sleeps ~1 ms so the host's enqueue cost does
    not show as device idle inside the window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_steps(torch, run, reps=REPS) -> tuple[float, float, float]:
    """A train step's median time over ``reps`` single synchronised runs,
    the best of 3 runs of ``reps`` steps back to back (one sync each:
    bench.py's loop), in ms, and the last loss."""
    ms = time_ms(torch, run, reps=reps, lead=False)
    loop = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            loss = run()
        end.record()
        end.synchronize()
        loop.append(start.elapsed_time(end) / reps)
    return ms, min(loop), float(loss)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)  # name, power limit: as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from eeg_gnn_tpu_torch.ops import (
        _build,
        cuda_decoder,
        cuda_kernels,
        cuda_recurrent,
        sddmm,
    )

    names = ("dcgru_recurrence", "dcgru_recurrence_bwd", "dcgru_xin_gemm",
             "dcgru_decoder", "fused_diffusion_conv", "sddmm")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        built = list(pool.map(_build.build, names))
    log(f"build: {len(names)} sources in {time.perf_counter() - t0:.1f} s "
        "wall")
    for name, (path, secs, report) in zip(names, built):
        log(f"build: {name}.cu -> {path} in {secs:.1f} s")
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry")):
                log(f"  ptxas: {line.strip()}")
    cuda_recurrent._lib()
    cuda_recurrent._lib_bwd()
    cuda_recurrent._lib_xin()
    cuda_decoder._lib()
    cuda_kernels._lib()
    sddmm._lib()
    return card


def phase_parity(torch, dev):
    """The forward kernels against their plain versions: the x-in layer as
    a whole, and each of its two kernels on the same inputs (the loop fed
    the plain projection), and the hoisted kernel."""
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr

    worst = {k: 0.0 for k in FWD + XIN_FWD}
    main_abs = dict(worst)
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for m, shared in OPS_CASES:
            for b in (BATCH, 37):
                # the hoisted kernel's input is x_proj (3H wide) whatever
                # D is, so it runs once per case, beside D=100
                for d in (100, 64):
                    seed += 1
                    a = layer_inputs(torch, dev, d=d, m=m, shared=shared,
                                     b=b, dtype=dtype, seed=seed)
                    residuals = (b == BATCH and d == 100 and m == 3
                                 and not shared and dtype == torch.float32)
                    wx = torch.cat([a["wxg_f"], a["wxc_f"]], dim=1)
                    kw = dict(residuals=residuals)
                    runs = [(FWD[0], cr.dcgru_recurrence_xin_fwd,
                             cr.dcgru_recurrence_xin_fwd_plain, xin_args(a),
                             kw),
                            (XIN_FWD[0], cr.dcgru_xin_proj,
                             cr.dcgru_xin_proj_plain,
                             (a["x"], a["a_ops"], wx), {}),
                            (XIN_FWD[1], cr.dcgru_xin_fwd_loop,
                             cr.dcgru_xin_fwd_loop_plain,
                             (cr.dcgru_xin_proj_plain(a["x"], a["a_ops"],
                                                      wx),
                              *hoisted_args(a)[1:]),
                             dict(kw, stream_dtype=dtype))]
                    if d == 100:
                        runs.append((FWD[1], cr.dcgru_recurrence_fwd,
                                     cr.dcgru_recurrence_fwd_plain,
                                     hoisted_args(a), kw))
                    for name, kern, plain, args, kw in runs:
                        got = kern(*args, **kw)
                        torch.cuda.synchronize()
                        want = plain(*args, **kw)
                        if name == XIN_FWD[0]:
                            got, want = (got,), (want,)
                        outs = (("xp",) if name == XIN_FWD[0] else
                                ("h_seq", "ru_seq", "c_seq") if residuals
                                else ("h_seq",))
                        for i, out in enumerate(outs):
                            if got[i].dtype != want[i].dtype:
                                fail(f"{name} {out}: {got[i].dtype} != "
                                     f"{want[i].dtype}")
                            err, max_abs = norm_err(got[i], want[i])
                            if not np.isfinite(err) or err > tol:
                                fail(f"{name} {out} D={d} M={m} shared="
                                     f"{shared} B={b} {dtype}: normalized "
                                     f"error {err:.3e} > {tol:.0e}")
                            worst[name] = max(worst[name], err)
                            if (b == BATCH and m == 3 and not shared
                                    and dtype == torch.bfloat16):
                                main_abs[name] = max(main_abs[name], max_abs)
                            log(f"parity {name} {out} D={d} M={m} "
                                f"{'shared' if shared else 'per-clip'} B={b} "
                                f"{str(dtype)[6:]}: norm err {err:.3e} "
                                f"(max abs {max_abs:.3e}, tol {tol:.0e})")
    return worst, main_abs


def phase_bwd_parity(torch, dev):
    """Backward kernels and the dW reduction against their plain versions
    on the forward grid; every output of every case: the x-in layer's
    BPTT as a whole, and each of its kernels on the same inputs (the dW
    and dx products fed the plain loop's dpre); the hoisted layer's BPTT
    as a whole and its bulk dW at D = 0 fed the plain loop's dpre; each
    BPTT twice on the same inputs, bitwise-equal gradients."""
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr

    worst = {k: 0.0 for k in BWD + XIN_BWD + ("dcgru_dw_reduce", DW_D0)}
    main_abs = dict(worst)
    seed = 500
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for m, shared in OPS_CASES:
            for b in (BATCH, 37):
                # the hoisted kernel has no input x: once per case, with
                # D=100's residuals
                for d in (100, 64):
                    seed += 1
                    a = layer_inputs(torch, dev, d=d, m=m, shared=shared,
                                     b=b, dtype=dtype, seed=seed)
                    xin, hoisted = bwd_args(torch, a, seed)
                    loop = (*xin[:1], *xin[3:8], xin[9])
                    dpre, _ = cr.dcgru_xin_bwd_loop_plain(*loop)
                    wx = torch.cat([a["wxg_f"], a["wxc_f"]], dim=1)
                    runs = [(BWD[0], cr.dcgru_recurrence_xin_bwd,
                             cr.dcgru_recurrence_xin_bwd_plain, xin,
                             XIN_GRADS),
                            (XIN_BWD[0], cr.dcgru_xin_bwd_loop,
                             cr.dcgru_xin_bwd_loop_plain, loop,
                             ("dpre", "dh0")),
                            (XIN_BWD[1], cr.dcgru_xin_dw,
                             cr.dcgru_xin_dw_plain,
                             (a["a_ops"], *xin[5:7], a["x"], dpre),
                             ("partials",)),
                            (XIN_BWD[2], cr.dcgru_xin_dx,
                             cr.dcgru_xin_dx_plain,
                             (a["a_ops"], wx, dpre, dtype), ("dx",))]
                    if d == 100:
                        # the hoisted loop's arguments are ``loop``: its
                        # dpre is the same
                        x0 = hoisted[3].new_empty((T, b, N, 0))
                        runs += [(BWD[1], cr.dcgru_recurrence_bwd,
                                  cr.dcgru_recurrence_bwd_plain, hoisted,
                                  HOISTED_GRADS),
                                 (DW_D0, cr.dcgru_xin_dw,
                                  cr.dcgru_xin_dw_plain,
                                  (a["a_ops"], *hoisted[3:5], x0, dpre),
                                  ("partials",))]
                    for name, kern, plain, args, outs in runs:
                        got = kern(*args)
                        torch.cuda.synchronize()
                        want = plain(*args)
                        if len(outs) == 1:
                            got, want = (got,), (want,)
                        pairs = list(zip(outs, got, want))
                        if name in BWD and d == 100:
                            # the same inputs again: bitwise the same
                            again = kern(*args)
                            for out, g, w in zip(outs, got, again):
                                if not torch.equal(g, w):
                                    fail(f"{name} {out} D={d} M={m} B={b} "
                                         f"{dtype}: two runs differ")
                        if name == BWD[0] and d == 100:
                            # need_dx=False, as for the first layer: no dx,
                            # the rest as the plain version's
                            nodx = kern(*args, need_dx=False)
                            if nodx[0] is not None:
                                fail(f"{name} need_dx=False returned dx")
                            pairs += [(f"{o}[no dx]", g, w) for o, g, w in
                                      zip(outs[1:], nodx[1:], want[1:])]
                        errs = []
                        for out, g, w in pairs:
                            if g.shape != w.shape or g.dtype != w.dtype:
                                fail(f"{name} {out}: {g.dtype} "
                                     f"{tuple(g.shape)} != {w.dtype} "
                                     f"{tuple(w.shape)}")
                            err, max_abs = norm_err(g, w)
                            if not np.isfinite(err) or err > tol:
                                fail(f"{name} {out} D={d} M={m} shared="
                                     f"{shared} B={b} {dtype}: normalized "
                                     f"error {err:.3e} > {tol:.0e}")
                            worst[name] = max(worst[name], err)
                            if (b == BATCH and m == 3 and not shared
                                    and dtype == torch.bfloat16):
                                main_abs[name] = max(main_abs[name],
                                                     max_abs)
                            errs.append(f"{out} {err:.2e}")
                        log(f"parity {name} D={d} M={m} "
                            f"{'shared' if shared else 'per-clip'} B={b} "
                            f"{str(dtype)[6:]} (tol {tol:.0e}): "
                            + ", ".join(errs))
    log("parity: dcgru_recurrence_xin_bwd and dcgru_recurrence_bwd twice on "
        "the same inputs gave bitwise-equal dx (dx_proj), dW, db and dh0 "
        "(every M, B, dtype)")
    gen = torch.Generator().manual_seed(1)
    part = torch.randn((BATCH, cr.dw_size(3, 100, H)), generator=gen).to(dev)
    err, max_abs = norm_err(cr.dcgru_dw_reduce(part),
                            cr.dcgru_dw_reduce_plain(part))
    if err > F32_TOL:
        fail(f"dcgru_dw_reduce: normalized error {err:.3e}")
    worst["dcgru_dw_reduce"], main_abs["dcgru_dw_reduce"] = err, max_abs
    log(f"parity dcgru_dw_reduce B={BATCH} W={part.shape[1]}: norm err "
        f"{err:.3e} (max abs {max_abs:.3e})")
    return worst, main_abs


def dec_inputs(torch, dev, *, layers, m, shared, b, dtype, force, seed):
    """Decoder-kernel forward arguments as the SSL model hands them over:
    weights from a seeded ``decoder_init`` (biases made random) re-packed
    by ``decoder_kernel_weights``, a random teacher-forcing stream in the
    stream dtype, random f32 initial states, and the force pattern."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcgru import (
        decoder_init,
        decoder_kernel_weights,
    )
    from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    filt = "laplacian" if m == 3 else "dual_random_walk"
    adj = torch.from_numpy(adjacency(rng, 1 if shared else b)).to(dev)
    a_ops = chebyshev_operators(compute_supports_torch(adj, filt), K)
    params, (cfg0, _) = decoder_init(gen, 100, H, K, N, (m - 1) // K,
                                     layers, 100)
    for cell in ("layer0", "shared")[:layers]:
        for k in ("gate_b", "cand_b"):
            params[cell][k] = 0.1 * torch.randn(params[cell][k].shape,
                                                generator=gen)
    params = {k: ({n: t.to(dev) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in params.items()}
    pattern = {"none": [0.0] * T_OUT, "all": [1.0] * T_OUT,
               "mixed": [float(i % 2) for i in range(T_OUT)]}[force]
    return (a_ops.contiguous(),
            torch.randn((T_OUT, b, N, 100), generator=gen).to(dev, dtype),
            torch.tensor(pattern, device=dev),
            *decoder_kernel_weights(cfg0, params, layers),
            (0.1 * torch.randn((layers, b, N, H), generator=gen)).to(dev))


def dec_bwd_args(torch, args, layers, seed):
    """Decoder-backward arguments: the plain forward's residuals and a
    random seeded proj cotangent."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    _, in0, h_seq, ru, c = cd.dcgru_decoder_fwd_plain(*args, layers,
                                                      residuals=True)
    a_ops, x, force, *w = args
    gen = torch.Generator().manual_seed(seed)
    d_seq = torch.randn(tuple(x.shape), generator=gen).to(x.device, x.dtype)
    return (a_ops, *w[0:4], *w[6:10], w[12], cd.decoder_h_prev(w[14], h_seq),
            h_seq, ru, c, in0, d_seq, force)


def phase_dec_parity(torch, dev):
    """The decoder kernels against their plain versions, every output of
    every case of the grid: the forward; the backward as a whole (the
    composite of its kernels) and each of its kernels on the same inputs
    (the loop; the two bulk dW products fed the plain loop's dpre, each
    reduced; dWp fed its dproj); and the whole backward twice on the same
    inputs, bitwise equal."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr

    names = DEC + DEC_BWD + ("dcgru_xin_dw (decoder)",)
    worst = {k: 0.0 for k in names}
    main_abs = dict(worst)
    seed = 900
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for layers in (SSL_LAYERS, 2, 1):
            for m, shared in ((3, False), (3, True), (5, False)):
                for b in (BATCH, 37):
                    for force in ("none", "all", "mixed"):
                        seed += 1
                        args = dec_inputs(torch, dev, layers=layers, m=m,
                                          shared=shared, b=b, dtype=dtype,
                                          force=force, seed=seed)
                        residuals = (b == BATCH and m == 3 and not shared
                                     and layers == SSL_LAYERS
                                     and force == "mixed")
                        main = (b == BATCH and m == 3 and not shared
                                and layers == SSL_LAYERS
                                and dtype == torch.bfloat16)
                        got = cd.dcgru_decoder_fwd(*args, layers,
                                                   residuals=residuals)
                        torch.cuda.synchronize()
                        want = cd.dcgru_decoder_fwd_plain(
                            *args, layers, residuals=residuals)
                        outs = ("proj", "in0", "h_seq", "ru_seq", "c_seq")
                        checks = {DEC[0]: [(o, g, w) for o, g, w in
                                           zip(outs, got, want)
                                           if w is not None]}
                        bwd_a = dec_bwd_args(torch, args, layers, seed)
                        got = cd.dcgru_decoder_bwd(*bwd_a, layers)
                        torch.cuda.synchronize()
                        again = cd.dcgru_decoder_bwd(*bwd_a, layers)
                        for out, g, w in zip(DEC_GRADS, got, again):
                            if (g is None) != (w is None) or (
                                    g is not None and not torch.equal(g, w)):
                                fail(f"{DEC[1]} {out} L={layers} M={m} "
                                     f"B={b} {dtype}: two runs differ")
                        want = cd.dcgru_decoder_bwd_plain(*bwd_a, layers)
                        checks[DEC[1]] = [(o, g, w) for o, g, w in
                                          zip(DEC_GRADS, got, want)
                                          if w is not None]
                        loop_a, dw_cells, h_top = cd.decoder_bwd_pieces(
                            *bwd_a, layers)
                        got = cd.dcgru_dec_bwd_loop(*loop_a)
                        torch.cuda.synchronize()
                        want = cd.dcgru_dec_bwd_loop_plain(*loop_a)
                        checks[DEC_BWD[0]] = list(zip(
                            ("dx", "dh0", "dpre", "dproj"), got, want))
                        dpre, dproj = want[2], want[3]
                        checks[names[-1]] = []
                        for cell, dw_a in zip(("layer0", "tied"),
                                              dw_cells(dpre)):
                            got = cr.dcgru_dw_reduce(cr.dcgru_xin_dw(*dw_a))
                            torch.cuda.synchronize()
                            want = cr.dcgru_xin_dw_plain(*dw_a).sum(0)
                            checks[names[-1]].append((cell, got, want))
                        got = cd.dcgru_dec_dwp(h_top, dproj)
                        torch.cuda.synchronize()
                        checks[DEC_BWD[1]] = [
                            ("partials", got,
                             cd.dcgru_dec_dwp_plain(h_top, dproj))]
                        errs = []
                        for name, pairs in checks.items():
                            for out, g, w in pairs:
                                if g.shape != w.shape or g.dtype != w.dtype:
                                    fail(f"{name} {out}: {g.dtype} "
                                         f"{tuple(g.shape)} != {w.dtype} "
                                         f"{tuple(w.shape)}")
                                err, max_abs = norm_err(g, w)
                                if not np.isfinite(err) or err > tol:
                                    fail(f"{name} {out} L={layers} M={m} "
                                         f"shared={shared} B={b} {dtype} "
                                         f"force={force}: normalized error "
                                         f"{err:.3e} > {tol:.0e}")
                                worst[name] = max(worst[name], err)
                                if main:
                                    main_abs[name] = max(main_abs[name],
                                                         max_abs)
                                errs.append(f"{out} {err:.1e}")
                        log(f"parity decoder L={layers} M={m} "
                            f"{'shared' if shared else 'per-clip'} B={b} "
                            f"{str(dtype)[6:]} force={force} (tol "
                            f"{tol:.0e}): " + ", ".join(errs))
    log("parity: dcgru_decoder_bwd twice on the same inputs gave "
        "bitwise-equal dx, dh0, dW, db, dWp and dbp (every case)")
    return worst, main_abs


def ssl_cfg(graph_type, dtype, **kw):
    from eeg_gnn_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(task="SS pre-training", graph_type=graph_type,
                            dtype=dtype, max_seq_len=T,
                            num_rnn_layers=SSL_LAYERS, rnn_units=H,
                            max_diffusion_step=K, input_dim=100,
                            output_dim=100, **SSL_KW, **kw).finalize()


def ssl_batch(torch, dev, b, seed):
    """An SSL pre-training batch on the device (ssl_bench.py:68-71):
    random clips and next windows, per-clip adjacency."""
    rng = np.random.RandomState(seed)
    return {"x": torch.from_numpy(rng.randn(b, T, N, 100).astype(
                np.float32)).to(dev),
            "y": torch.from_numpy(rng.randn(b, T_OUT, N, 100).astype(
                np.float32)).to(dev),
            "adjacency": torch.from_numpy(adjacency(rng, b)).to(dev)}


def ssl_step(torch, cfg, init, dev, seed=5):
    """A fresh SSL ``TrainStep`` from the weights ``init``; its generator
    (the force draws) seeded with ``seed``."""
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    model = build_model(cfg)
    model.load_state_dict(init)
    return TrainStep(cfg, model, STEPS_PER_EPOCH, device=dev,
                     generator=torch.Generator(dev).manual_seed(seed),
                     mean=0.0, std=1.0)


def decoder_grads(torch, cfg, init, batch, seed=37):
    """Gradients of the decoder's weights and of h0_stack under a seeded
    dense cotangent on its output: the decoder's BPTT alone, fed the
    encoder's final states (float32, no grad) and one force draw."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcgru import (
        decoder_apply,
        draw_force,
        encoder_apply,
    )
    from eeg_gnn_tpu_torch.models.dcrnn import compute_sampling_threshold
    from eeg_gnn_tpu_torch.models.registry import build_model

    dev = batch["x"].device
    model = build_model(cfg)
    model.load_state_dict(init)
    model.to(dev).train()
    sup = compute_supports_torch(batch["adjacency"], cfg.filter_type)
    with torch.no_grad():
        f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        f32.load_state_dict(init)
        f32.to(dev)
        h0, _ = encoder_apply(f32.cell_cfgs, [c.params() for c in
                                              f32.encoder], sup,
                              batch["x"].transpose(0, 1))
    h0 = h0.clone().requires_grad_()
    force = draw_force(T_OUT, compute_sampling_threshold(3000, BATCHES_SEEN),
                       torch.Generator(dev).manual_seed(seed), dev)
    out = decoder_apply(model.dec_cfgs, model.decoder.params(), sup,
                        batch["y"].transpose(0, 1), h0, SSL_LAYERS,
                        force=force, training=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cot = torch.randn(tuple(out.shape), generator=gen, device=dev)
    named = list(model.decoder.named_parameters())
    grads = torch.autograd.grad((out * cot).sum(),
                                [p for _, p in named] + [h0])
    out = {f"decoder.{n}": g for (n, _), g in zip(named, grads)}
    out["h0_stack"] = grads[-1]
    return out


def phase_ssl(torch, dev):
    """The SSL pre-training path: 3 steps in each of 4 configurations and a
    curriculum-off run, launch counts per step, finite losses, step-1
    gradients against the stacked step (same weights, same force draws),
    the bfloat16 decoder's VJP, and once the card against the CPU."""
    from eeg_gnn_tpu_torch.models.registry import build_model

    batch = ssl_batch(torch, dev, BATCH, seed=41)
    runs = [(gt, dt, True) for gt in ("combined", "individual")
            for dt in ("float32", "bfloat16")] + [("combined", "float32",
                                                   False)]
    # the SSL path's run: counts start at 0 here and are read below
    reset_counts()
    first, vjp_cases = None, []
    for gt, dtype, curriculum in runs:
        cfg = ssl_cfg(gt, dtype, use_curriculum_learning=curriculum)
        init = {k: v.clone() for k, v in build_model(
            cfg, torch.Generator().manual_seed(11)).state_dict().items()}
        step = ssl_step(torch, cfg, init, dev)
        losses, grads = [], None
        for i in range(3 if curriculum else 1):
            before = counts()
            losses.append(step.loss_and_grads(
                batch, batches_seen=BATCHES_SEEN + i * BATCH))
            if grads is None:
                grads = {n: p.grad.clone()
                         for n, p in step.model.named_parameters()}
            step.update()
            after = counts()
            rose = {k: after[k] - before[k] for k in KERNELS}
            want = {k: SSL_STEP.get(k, 0) for k in KERNELS}
            if rose != want:
                fail(f"ssl {gt} {dtype} curriculum={curriculum} step {i}: "
                     f"launches rose by {rose}, want {want}")
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            fail(f"ssl {gt} {dtype}: losses {losses}")
        ref_cfg = dataclasses.replace(cfg, recurrence="stacked")
        ref = ssl_step(torch, ref_cfg, init, dev)
        before = counts()
        ref_loss = float(ref.loss_and_grads(batch,
                                            batches_seen=BATCHES_SEEN))
        if counts() != before:
            fail("the stacked SSL step launched a kernel")
        ref_grads = {n: p.grad for n, p in ref.model.named_parameters()}
        errs = {n: norm_err(grads[n], g)[0] for n, g in ref_grads.items()}
        name, err = max(errs.items(), key=lambda kv: kv[1])
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        if dtype == "float32":
            if abs(losses[0] - ref_loss) > tol * abs(ref_loss):
                fail(f"ssl {gt} {dtype}: step-1 loss {losses[0]} vs "
                     f"stacked {ref_loss}")
            if not np.isfinite(err) or err > tol:
                fail(f"ssl {gt} {dtype} curriculum={curriculum}: step-1 "
                     f"gradient {name} vs stacked {err:.3e} > {tol:.0e}")
        log(f"ssl {gt} {dtype} curriculum={curriculum}: losses "
            f"{', '.join(f'{v:.6f}' for v in losses)} (stacked "
            f"{ref_loss:.6f}); step-1 grads vs stacked: worst {name} "
            f"{err:.3e} "
            f"({f'tol {tol:.0e}' if dtype == 'float32' else 'not gated'})")
        if first is None and dtype == "float32":
            first = (cfg, init)
        if dtype == "bfloat16":
            vjp_cases.append((cfg, init))
            bf16_ssl_errors(torch, cfg, init, batch, grads, ref_grads)
    launched = counts()
    log(f"ssl: launches {launched}")

    # bfloat16: the decoder's gradients under one seeded cotangent, the
    # kernels' against the float32 stacked decoder's
    for cfg, init in vjp_cases:
        got = decoder_grads(torch, cfg, init, batch)
        exact = decoder_grads(torch, dataclasses.replace(
            cfg, recurrence="stacked", dtype="float32"), init, batch)
        errs = {n: norm_err(got[n], exact[n])[0] for n in exact}
        name, err = max(errs.items(), key=lambda kv: kv[1])
        if not np.isfinite(err) or err > BF16_TOL:
            fail(f"ssl {cfg.graph_type} bfloat16: decoder VJP {name} vs "
                 f"float32 stacked {err:.3e} > {BF16_TOL:.0e}")
        log(f"ssl {cfg.graph_type} bfloat16: decoder VJP vs float32 "
            f"stacked: worst {name} {err:.3e} (tol {BF16_TOL:.0e}), "
            + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()))

    # once, on 4 clips (no force draws: they differ between devices): the
    # card's step-1 loss and gradients vs the CPU's
    cfg, init = first
    small = {k: v[:4] for k, v in batch.items()}
    res = []
    for device in (dev, "cpu"):
        step = ssl_step(torch, cfg, init, device)
        loss = float(step.loss_and_grads(
            {k: v.to(device) for k, v in small.items()}))
        res.append((loss, {n: p.grad.cpu()
                           for n, p in step.model.named_parameters()}))
    err = max(norm_err(res[0][1][n], res[1][1][n])[0] for n in res[1][1])
    if abs(res[0][0] - res[1][0]) > F32_TOL * abs(res[1][0]) \
            or err > F32_TOL:
        fail(f"ssl card vs CPU on 4 clips: loss {res[0][0]} vs "
             f"{res[1][0]}, gradients {err:.3e}")
    log(f"ssl {cfg.graph_type} float32: card vs CPU on 4 clips: loss "
        f"{res[0][0]:.7f} vs {res[1][0]:.7f}, gradients {err:.3e}")
    return launched


def bf16_ssl_errors(torch, cfg, init, batch, grads, stacked):
    """The bfloat16 SSL model's step-1 gradients, the kernels' (``grads``,
    gated at 2e-2) and the bfloat16 stacked path's (``stacked``, printed),
    each against a float32 stacked step from the same weights and force
    draws. Unlike the detector's, this model has no max over nodes whose
    ties bf16 rounding could reorder, and the gate holds (PERF.md, PR 3)."""
    f32 = ssl_step(torch, dataclasses.replace(
        cfg, recurrence="stacked", dtype="float32"), init, batch["x"].device)
    f32.loss_and_grads(batch, batches_seen=BATCHES_SEEN)
    exact = {n: p.grad for n, p in f32.model.named_parameters()}
    rows = {n: (norm_err(grads[n], g)[0], norm_err(stacked[n], g)[0])
            for n, g in exact.items()}
    name, (err, _) = max(rows.items(), key=lambda kv: kv[1][0])
    if not np.isfinite(err) or err > BF16_TOL:
        fail(f"ssl {cfg.graph_type} bfloat16: step-1 gradient {name} vs "
             f"float32 stacked {err:.3e} > {BF16_TOL:.0e}")
    log(f"ssl {cfg.graph_type} bfloat16: step-1 grads vs float32 stacked, "
        "kernels/bfloat16 stacked: worst "
        f"{max(r[0] for r in rows.values()):.3e}/"
        f"{max(r[1] for r in rows.values()):.3e}, "
        + ", ".join(f"{n} {a:.1e}/{b:.1e}" for n, (a, b) in rows.items()))


def flagship_cfg(graph_type, dtype, input_fusion, **kw):
    from eeg_gnn_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(graph_type=graph_type, dtype=dtype,
                            input_fusion=input_fusion, max_seq_len=T,
                            num_rnn_layers=2, rnn_units=H,
                            max_diffusion_step=K, input_dim=100,
                            test_batch_size=BATCH, **kw).finalize()


def phase_serve(torch):
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.serve import Predictor

    rng = np.random.RandomState(7)
    requests = []
    for n in (BATCH, 37):  # one full batch, one padded partial batch
        requests.append((rng.randn(n, T, N, 100).astype(np.float32),
                         rng.randint(T // 2, T + 1, size=n),
                         adjacency(rng, n)))
    batches = sum(-(-len(r[0]) // BATCH) for r in requests)
    # the serving path's run: counts start at 0 here and are read at the end
    reset_counts()
    checked_cpu = False
    for gt in ("combined", "individual"):
        for dtype in ("float32", "bfloat16"):
            for fusion in (True, False):
                cfg = flagship_cfg(gt, dtype, fusion)
                params = build_model(
                    cfg, torch.Generator().manual_seed(11)).state_dict()
                pred = Predictor(cfg, params)
                plain = Predictor(dataclasses.replace(cfg, recurrence="stacked"),
                                  params)
                before = counts()
                probs = [pred.predict_proba(x, lens, adjacency=adj)
                         for x, lens, adj in requests]
                after = counts()
                rose = {k: after[k] - before[k] for k in KERNELS}
                want = {k: SERVE_BATCH[fusion].get(k, 0) * batches
                        for k in KERNELS}
                if rose != want:
                    fail(f"{gt} {dtype} fusion={fusion}: launches rose by "
                         f"{rose}, want {want}")
                tol = F32_TOL if dtype == "float32" else BF16_TOL
                diff = 0.0
                for (x, lens, adj), p in zip(requests, probs):
                    if p.shape != (len(x),) or not np.all(np.isfinite(p)) \
                            or p.min() < 0 or p.max() > 1:
                        fail(f"{gt} {dtype} fusion={fusion}: bad "
                             f"probabilities {p.shape} [{p.min()}, {p.max()}]")
                    ref = plain.predict_proba(x, lens, adjacency=adj)
                    diff = max(diff, float(np.abs(p - ref).max()))
                    if diff > tol:
                        fail(f"{gt} {dtype} fusion={fusion}: |kernel - plain|"
                             f" = {diff:.3e} > {tol:.0e}")
                log(f"serve {gt} {dtype} input_fusion={fusion}: "
                    f"{sum(len(r[0]) for r in requests)} clips, launches "
                    f"+{ {k: v for k, v in rose.items() if v} }, "
                    f"max |kernel - plain| {diff:.3e}, "
                    f"mean p {float(np.mean(probs[0])):.4f}")
                if not checked_cpu and dtype == "float32":
                    x, lens, adj = requests[1]
                    cpu = Predictor(cfg, params, device="cpu", batch_size=4)
                    diff = float(np.abs(
                        cpu.predict_proba(x[:4], lens[:4], adjacency=adj[:4])
                        - probs[1][:4]).max())
                    if diff > F32_TOL:
                        fail(f"card vs CPU on 4 clips: {diff:.3e}")
                    log(f"serve {gt} float32: card vs CPU on 4 clips "
                        f"{diff:.3e}")
                    checked_cpu = True
    launched = counts()
    if any(launched[k] for k in ("dcgru_dw_reduce",) + XIN_BWD):
        fail(f"serving launched a backward kernel: {launched}")
    log(f"serve: launches {launched}")
    return launched


def train_batch(torch, dev, b, seed):
    """A flagship detection batch on the device (bench.py:34-43): random
    clips and labels, full lengths, per-clip adjacency."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, T, N, 100).astype(np.float32)
    y = rng.randint(0, 2, size=b).astype(np.float32)
    return {"x": torch.from_numpy(x).to(dev),
            "y": torch.from_numpy(y).to(dev),
            "seq_lengths": torch.full((b,), T, dtype=torch.int64,
                                      device=dev),
            "adjacency": torch.from_numpy(adjacency(rng, b)).to(dev)}


def encoder_grads(torch, cfg, init, batch, seed=31):
    """Gradients of the encoder's weights under a seeded dense cotangent
    on the top layer's h_seq: the two layers' BPTT, with no head."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcgru import encoder_apply
    from eeg_gnn_tpu_torch.models.registry import build_model

    dev = batch["x"].device
    model = build_model(cfg)
    model.load_state_dict(init)
    model.to(dev).train()
    sup = compute_supports_torch(batch["adjacency"], cfg.filter_type)
    _, top = encoder_apply(model.cell_cfgs, [c.params() for c in
                                             model.encoder],
                           sup, batch["x"].transpose(0, 1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    cot = torch.randn(tuple(top.shape), generator=gen, device=dev)
    named = list(model.encoder.named_parameters())
    grads = torch.autograd.grad((top.float() * cot).sum(),
                                [p for _, p in named])
    return {f"encoder.{n}": g for (n, _), g in zip(named, grads)}


def bf16_model_errors(torch, cfg, init, batch, grads, stacked):
    """Printed, not gated: the bfloat16 model's step-1 gradients, the
    kernels' (``grads``) and the bfloat16 stacked path's (``stacked``),
    each against a float32 stacked step from the same weights."""
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    f32_cfg = dataclasses.replace(cfg, recurrence="stacked",
                                  dtype="float32", use_pallas=False)
    model = build_model(f32_cfg)
    model.load_state_dict(init)
    step = TrainStep(f32_cfg, model, STEPS_PER_EPOCH, device=batch["x"].device)
    step.loss_and_grads(batch)
    exact = {n: p.grad for n, p in step.model.named_parameters()}
    rows = {n: (norm_err(grads[n], g)[0], norm_err(stacked[n], g)[0])
            for n, g in exact.items()}
    log(f"train {cfg.graph_type} bfloat16 input_fusion={cfg.input_fusion}: "
        "step-1 grads vs float32 stacked, kernels/bfloat16 stacked: worst "
        f"{max(r[0] for r in rows.values()):.3e}/"
        f"{max(r[1] for r in rows.values()):.3e}, "
        + ", ".join(f"{n} {a:.1e}/{b:.1e}" for n, (a, b) in rows.items()))


def phase_train(torch, dev):
    """The training path: 3 steps in each of 8 configurations, launch
    counts per step, finite losses, step-1 gradients against the stacked
    step on the card, and once the card against the CPU."""
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    batch = train_batch(torch, dev, BATCH, seed=21)
    # the training path's run: counts start at 0 here and are read below
    reset_counts()
    first, vjp_cases = None, []
    for gt in ("combined", "individual"):
        for dtype in ("float32", "bfloat16"):
            for fusion in (True, False):
                cfg = flagship_cfg(gt, dtype, fusion, **TRAIN_KW)
                model = build_model(cfg, torch.Generator().manual_seed(11))
                init = {k: v.clone() for k, v in model.state_dict().items()}
                step = TrainStep(cfg, model, STEPS_PER_EPOCH, device=dev)
                losses, grads = [], None
                for i in range(3):
                    before = counts()
                    losses.append(step.loss_and_grads(batch))
                    if grads is None:
                        grads = {n: p.grad.clone()
                                 for n, p in step.model.named_parameters()}
                    step.update()
                    after = counts()
                    rose = {k: after[k] - before[k] for k in KERNELS}
                    want = {k: TRAIN_STEP[fusion].get(k, 0) for k in KERNELS}
                    if rose != want:
                        fail(f"train {gt} {dtype} fusion={fusion} step {i}: "
                             f"launches rose by {rose}, want {want}")
                losses = [float(v) for v in losses]
                if not all(np.isfinite(losses)):
                    fail(f"train {gt} {dtype} fusion={fusion}: losses "
                         f"{losses}")
                ref_cfg = dataclasses.replace(cfg, recurrence="stacked")
                ref_model = build_model(ref_cfg)
                ref_model.load_state_dict(init)
                ref = TrainStep(ref_cfg, ref_model, STEPS_PER_EPOCH,
                                device=dev)
                before = counts()
                ref_loss = float(ref.loss_and_grads(batch))
                if counts() != before:
                    fail("the stacked step launched a kernel")
                tol = F32_TOL if dtype == "float32" else BF16_TOL
                if abs(losses[0] - ref_loss) > tol * abs(ref_loss):
                    fail(f"train {gt} {dtype} fusion={fusion}: step-1 loss "
                         f"{losses[0]} vs stacked {ref_loss}")
                ref_grads = {n: p.grad for n, p in
                             ref.model.named_parameters()}
                errs = {n: norm_err(grads[n], g)[0]
                        for n, g in ref_grads.items()}
                name, err = max(errs.items(), key=lambda kv: kv[1])
                # float32 gates the model's step-1 gradients; in bfloat16
                # the head's ReLU and max over nodes route each clip's
                # gradient by values that bf16 noise reorders, so the
                # encoder's VJP under one shared cotangent is gated below
                if dtype == "float32" and (not np.isfinite(err)
                                           or err > tol):
                    fail(f"train {gt} {dtype} fusion={fusion}: step-1 "
                         f"gradient {name} vs stacked {err:.3e} > {tol:.0e}")
                log(f"train {gt} {dtype} input_fusion={fusion}: losses "
                    f"{', '.join(f'{v:.6f}' for v in losses)} (stacked "
                    f"{ref_loss:.6f}); step-1 grads vs stacked: worst "
                    f"{name} {err:.3e} "
                    f"({f'tol {tol:.0e}' if dtype == 'float32' else 'not gated'}"
                    "), " + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()))
                if first is None and dtype == "float32":
                    first = (cfg, init)
                if dtype == "bfloat16":
                    vjp_cases.append((cfg, init))
                    bf16_model_errors(torch, cfg, init, batch, grads,
                                      ref_grads)
    launched = counts()
    log(f"train: launches {launched}")

    # bfloat16: the two-layer encoder's gradients under one seeded dense
    # cotangent on the top h_seq, the kernels' against the float32 stacked
    # path's (the truth), same weights and batch on the card; the bfloat16
    # stacked path's distance to it is printed beside
    for cfg, init in vjp_cases:
        got = encoder_grads(torch, cfg, init, batch)
        want = encoder_grads(torch, dataclasses.replace(
            cfg, recurrence="stacked"), init, batch)
        exact = encoder_grads(torch, dataclasses.replace(
            cfg, recurrence="stacked", dtype="float32"), init, batch)
        errs = {n: norm_err(got[n], exact[n])[0] for n in exact}
        name, err = max(errs.items(), key=lambda kv: kv[1])
        stacked = {n: norm_err(want[n], exact[n])[0] for n in exact}
        if not np.isfinite(err) or err > BF16_TOL:
            fail(f"train {cfg.graph_type} bfloat16 fusion="
                 f"{cfg.input_fusion}: encoder VJP {name} vs float32 "
                 f"stacked {err:.3e} > {BF16_TOL:.0e}")
        log(f"train {cfg.graph_type} bfloat16 input_fusion="
            f"{cfg.input_fusion}: encoder VJP vs float32 stacked: worst "
            f"{name} {err:.3e} (tol {BF16_TOL:.0e}; bfloat16 stacked vs "
            f"float32 stacked: worst {max(stacked.values()):.3e}; kernels "
            f"vs bfloat16 stacked: worst "
            f"{max(norm_err(got[n], want[n])[0] for n in want):.3e}), "
            + ", ".join(f"{n} {e:.1e}/{stacked[n]:.1e}"
                        for n, e in errs.items()))

    # once, on 4 clips: the card's step-1 loss and gradients vs the CPU's
    cfg, init = first
    small = {k: v[:4] for k, v in batch.items()}
    res = []
    for device in (dev, "cpu"):
        model = build_model(cfg)
        model.load_state_dict(init)
        step = TrainStep(cfg, model, STEPS_PER_EPOCH, device=device)
        loss = float(step.loss_and_grads(
            {k: v.to(device) for k, v in small.items()}))
        res.append((loss, {n: p.grad.cpu()
                           for n, p in step.model.named_parameters()}))
    err = max(norm_err(res[0][1][n], res[1][1][n])[0] for n in res[1][1])
    if abs(res[0][0] - res[1][0]) > F32_TOL * abs(res[1][0]) \
            or err > F32_TOL:
        fail(f"train card vs CPU on 4 clips: loss {res[0][0]} vs "
             f"{res[1][0]}, gradients {err:.3e}")
    log(f"train {cfg.graph_type} float32: card vs CPU on 4 clips: loss "
        f"{res[0][0]:.7f} vs {res[1][0]:.7f}, gradients {err:.3e}")
    return launched


def phase_times(torch, dev):
    """Each encoder kernel and its plain version at each layer of the
    detector (B=128, M=3; the x-in layer's kernels alone, and its two
    wrappers as a whole), the dW reduction beside torch.sum, then the
    Predictor's and the train step's end-to-end times."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
    from eeg_gnn_tpu_torch.serve import Predictor
    from eeg_gnn_tpu_torch.train import TrainStep

    def report(key, name, kern, plain, args, work, note=""):
        ms = time_ms(torch, lambda: kern(*args))
        # the plain versions repeat the kernels' arithmetic op by op and are
        # no yardstick of speed: a median of 5
        plain_ms = time_ms(torch, lambda: plain(*args), reps=5, warmup=1)
        bms, by = bound_ms(work)
        out[key] = (ms, plain_ms, work)
        flops = sum(w[0] + (w[2] if len(w) > 2 else 0) for w in work)
        log(f"time {name} D={d} M=3 B={BATCH} {key[1]}{note}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}; {flops / 1e9:.2f} GFLOP, "
            f"{sum(w[1] for w in work) / 1e6:.2f} MB)")

    out, reduce_shapes = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        sb = 2 if dtype == torch.bfloat16 else 4
        for d in (100, 64):
            kw = dict(m=3, b=BATCH, a_batch=BATCH, stream_bytes=sb)
            a = layer_inputs(torch, dev, d=d, m=3, shared=False, b=BATCH,
                             dtype=dtype, seed=100 + d)
            wx = torch.cat([a["wxg_f"], a["wxc_f"]], dim=1)
            xp = cr.dcgru_xin_proj_plain(a["x"], a["a_ops"], wx)
            pw = proj_work(d=d, **kw)
            lw = layer_work(xin=False, d=d, xp_bytes=4, **kw)
            report((FWD[0], tag, d), FWD[0], cr.dcgru_recurrence_xin_fwd,
                   cr.dcgru_recurrence_xin_fwd_plain, xin_args(a), [pw, lw])
            report((XIN_FWD[0], tag, d), XIN_FWD[0], cr.dcgru_xin_proj,
                   cr.dcgru_xin_proj_plain, (a["x"], a["a_ops"], wx), [pw])
            loop_args = (xp, *hoisted_args(a)[1:], "tanh", False, dtype)
            report((XIN_FWD[1], tag, d), XIN_FWD[1], cr.dcgru_xin_fwd_loop,
                   cr.dcgru_xin_fwd_loop_plain, loop_args, [lw])
            report((FWD[1], tag, d), FWD[1], cr.dcgru_recurrence_fwd,
                   cr.dcgru_recurrence_fwd_plain, hoisted_args(a),
                   [layer_work(xin=False, d=d, **kw)])
            out[(FWD[0], tag, d, "f32 bound")] = layer_work(xin=True, d=d,
                                                            **kw)

            xin_b, hoisted_b = bwd_args(torch, a, seed=200 + d)
            loop = (*xin_b[:1], *xin_b[3:8], xin_b[9])
            dpre, _ = cr.dcgru_xin_bwd_loop_plain(*loop)
            splits = cr.dw_splits(T * BATCH, 3, d, H)
            if dtype == torch.bfloat16:  # the main path's split partials
                reduce_shapes[d] = (splits, cr.dw_size(3, d, H))
            blw = bwd_loop_work(**kw)
            dww = dw_work(d=d, **kw)
            dxw = dx_work(d=d, **kw)
            # the main path's first layer (D=100) is fed data and asks for
            # no dx; with dx it is timed too, as the A/B of that skip (the
            # bound leaves out the reduction of the split partials, scratch)
            for need_dx in ((False, True) if d == 100 else (True,)):
                key = (BWD[0], tag, d if d != 100 or not need_dx else "dx")
                report(key, BWD[0],
                       lambda *z, nd=need_dx: cr.dcgru_recurrence_xin_bwd(
                           *z, need_dx=nd),
                       lambda *z, nd=need_dx: cr.dcgru_recurrence_xin_bwd_plain(
                           *z, need_dx=nd), xin_b,
                       [blw, dww] + ([dxw] if need_dx else []),
                       f" need_dx={need_dx} (all its kernels)")
                out[key + ("f32 bound",)] = bwd_work(
                    xin=True, d=d, need_dx=need_dx, **kw)
            report((XIN_BWD[0], tag, d), XIN_BWD[0], cr.dcgru_xin_bwd_loop,
                   cr.dcgru_xin_bwd_loop_plain, loop, [blw])
            report((XIN_BWD[1], tag, d), XIN_BWD[1], cr.dcgru_xin_dw,
                   cr.dcgru_xin_dw_plain,
                   (a["a_ops"], *xin_b[5:7], a["x"], dpre), [dww])
            report((XIN_BWD[2], tag, d), XIN_BWD[2], cr.dcgru_xin_dx,
                   cr.dcgru_xin_dx_plain, (a["a_ops"], wx, dpre, dtype),
                   [dxw])
            # the bulk projection's and dx's wrappers stage the operators
            # and weights as fragments at every launch (inside their times
            # above): the staging alone, and the launch plans
            bf16 = dtype == torch.bfloat16
            stage = [time_ms(torch, lambda tr=tr: (
                cr.dw_op_frags(a["a_ops"], bf16, tr, batch_major=True),
                cr.xin_weight_frags((a["wxg_f"], a["wxc_f"]), 3, tr, bf16)))
                for tr in (False, True)]
            plans = [cr.xin_bulk_plan(proj, T, BATCH, N, d, H, 3, BATCH, bf16)
                     for proj in (True, False)]
            log(f"time operand staging of the bulk projection and dx D={d} "
                f"M=3 {tag}: projection {stage[0]:.4f} ms, dx "
                f"{stage[1]:.4f} ms a launch; plans: " + "; ".join(
                    f"{k} {pl}" for k, pl in zip(("projection", "dx"),
                                                  plans)))
            # the hoisted layer's BPTT: the same loop (3·l, above), its bulk
            # dW at D = 0 alone, and the composite as a whole (its bound the
            # function's, intermediates not counted)
            x0 = hoisted_b[3].new_empty((T, BATCH, N, 0))
            report((DW_D0, tag, d), DW_D0, cr.dcgru_xin_dw,
                   cr.dcgru_xin_dw_plain,
                   (a["a_ops"], *hoisted_b[3:5], x0, dpre),
                   [dw_work(d=0, **kw)])
            hw = bwd_work(xin=False, d=d, **kw)
            report((BWD[1], tag, d), BWD[1], cr.dcgru_recurrence_bwd,
                   cr.dcgru_recurrence_bwd_plain, hoisted_b, [hw],
                   " (all its kernels)")
            out[(BWD[1], tag, d, "f32 bound")] = (hw[0] + hw[2], hw[1])
        # the loops' wrappers stage the hidden weights at every launch
        # (inside the loop times above): the staging alone
        bf16 = dtype == torch.bfloat16
        stage = [time_ms(torch, lambda f=f: f(a["wg_r"], a["wc_r"], bf16))
                 for f in (cr.fwd_loop_weights, cr.bwd_loop_weights)]
        log(f"time weight staging of the state loops H={H} M=3 {tag}: "
            f"forward {stage[0]:.4f} ms, backward {stage[1]:.4f} ms a "
            "launch")
    log("library_ms: none — no single PyTorch call computes a DCGRU "
        "recurrence or its BPTT (torch.nn.GRU has no graph diffusion), nor "
        "a diffused input projection or its dW / dx (each is a diffusion "
        "per clip and a product)")
    # the x-in layers' bf16 split partials (D=100, 64)
    for d, shape in ((100, reduce_shapes[100]), (64, reduce_shapes[64])):
        gen = torch.Generator().manual_seed(shape[1])
        part = torch.randn(shape, generator=gen).to(dev)
        ms = time_ms(torch, lambda: cr.dcgru_dw_reduce(part))
        plain_ms = time_ms(torch, lambda: cr.dcgru_dw_reduce_plain(part))
        lib_ms = time_ms(torch, lambda: torch.sum(part, dim=0))
        work = reduce_work(*shape)
        bms, by = bound_ms([work])
        out[("dcgru_dw_reduce", "float32", d)] = (ms, plain_ms, work, lib_ms)
        log(f"time dcgru_dw_reduce D={d} M=3 ({shape[0]}, {shape[1]}): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sum "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}; "
            f"{work[1] / 1e6:.2f} MB)")

    rng = np.random.RandomState(3)
    x = rng.randn(BATCH, T, N, 100).astype(np.float32)
    lens = np.full((BATCH,), T, np.int64)
    adj = adjacency(rng, BATCH)
    for gt in ("combined", "individual"):
        for dtype in ("bfloat16", "float32"):
            cfg = flagship_cfg(gt, dtype, True)
            pred = Predictor(cfg, build_model(
                cfg, torch.Generator().manual_seed(11)).state_dict())
            ms = time_ms(torch, lambda: pred.predict_proba(x, lens,
                                                           adjacency=adj),
                         lead=False)
            log(f"time Predictor {gt} {dtype} input_fusion=True B={BATCH}: "
                f"{ms:.3f} ms/batch, {BATCH / ms * 1e3:.1f} clips/s "
                "(host numpy in, probabilities out)")
            if dtype == "bfloat16":
                profile_batch(torch, lambda: pred.predict_proba(
                    x, lens, adjacency=adj), f"Predictor {gt} {dtype}", ms)

    # the train step as bench.py times it: supports built once, on device;
    # each graph and dtype with input fusion, and the hoisted
    # (input_fusion=False) step in bf16, the path of BWD[1]
    adj_batch = train_batch(torch, dev, BATCH, seed=5)
    cases = [(gt, dtype, True) for gt in ("combined", "individual")
             for dtype in ("bfloat16", "float32")]
    for gt, dtype, fusion in cases + [("combined", "bfloat16", False)]:
        cfg = flagship_cfg(gt, dtype, fusion, **TRAIN_KW)
        batch = dict(adj_batch, supports=compute_supports_torch(
            adj_batch["adjacency"], cfg.filter_type))
        step = TrainStep(cfg, build_model(
            cfg, torch.Generator().manual_seed(11)), STEPS_PER_EPOCH,
            device=dev)
        ms, best, loss = time_steps(torch, lambda: step(batch))
        if not np.isfinite(loss):
            fail(f"train step {gt} {dtype} fusion={fusion}: loss {loss}")
        out[("train", gt, dtype, fusion)] = (ms, best)
        log(f"time train step {gt} {dtype} input_fusion={fusion} "
            f"B={BATCH}: {ms:.3f} ms/step (median of {REPS}, each "
            f"synchronised), {BATCH / ms * 1e3:.1f} clips/s; "
            f"{REPS} back to back: {best:.3f} ms/step, "
            f"{BATCH / best * 1e3:.1f} clips/s (best of 3)")
        if dtype == "bfloat16":
            profile_batch(torch, lambda: step(batch),
                          f"train step {gt} {dtype}"
                          + ("" if fusion else " input_fusion=False"), ms)
    # the training CLI's batch: the same step at B=40 (log_cli_rates)
    cfg = flagship_cfg("combined", "bfloat16", True, **TRAIN_KW)
    small = train_batch(torch, dev, CLI_BATCH, seed=6)
    small["supports"] = compute_supports_torch(small["adjacency"],
                                               cfg.filter_type)
    step = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(11)),
                     STEPS_PER_EPOCH, device=dev)
    ms, best, loss = time_steps(torch, lambda: step(small))
    if not np.isfinite(loss):
        fail(f"train step B={CLI_BATCH}: loss {loss}")
    out[("train", CLI_BATCH)] = (ms, best)
    log(f"time train step combined bfloat16 input_fusion=True "
        f"B={CLI_BATCH}: {ms:.3f} ms/step, {CLI_BATCH / ms * 1e3:.1f} "
        f"clips/s; {REPS} back to back: {best:.3f} ms/step, "
        f"{CLI_BATCH / best * 1e3:.1f} clips/s (best of 3)")
    return out


def phase_ssl_times(torch, dev):
    """The decoder's kernels beside their plain versions and bounds (the
    forward; the backward as a whole and each of its kernels: the loop,
    the two bulk dW products, dWp, the three reductions beside
    torch.sum), and the SSL train step's ms and clips/s."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr

    out = {}

    def report(key, name, kern, plain, work, note=""):
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=5, warmup=1)
        bms, by = bound_ms(work)
        out[key] = (ms, plain_ms, work)
        flops = sum(w[0] + (w[2] if len(w) > 2 else 0) for w in work)
        log(f"time {name} L={SSL_LAYERS} T_out={T_OUT} D=100 M=3 "
            f"B={BATCH} {key[1]}{note}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}; "
            f"{flops / 1e9:.2f} GFLOP, {sum(w[1] for w in work) / 1e6:.2f} "
            f"MB), {flops / ms / 1e9:.2f} TFLOP/s")

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        args = dec_inputs(torch, dev, layers=SSL_LAYERS, m=3, shared=False,
                          b=BATCH, dtype=dtype, force="mixed", seed=300)
        bwd = dec_bwd_args(torch, args, SSL_LAYERS, seed=301)
        sb = 2 if dtype == torch.bfloat16 else 4
        kw = dict(d=100, m=3, layers=SSL_LAYERS, b=BATCH, a_batch=BATCH,
                  stream_bytes=sb)
        loop_a, dw_cells, h_top = cd.decoder_bwd_pieces(*bwd, SSL_LAYERS)
        _, _, dpre, dproj = cd.dcgru_dec_bwd_loop_plain(*loop_a)
        dw_a = dw_cells(dpre)
        splits = tuple(cr.dw_splits(a[3].shape[0] * a[3].shape[1], 3,
                                    a[3].shape[-1], H) for a in dw_a)
        rows = T_OUT * BATCH * N
        dws = cd.dwp_splits(rows)
        lw = dec_loop_work(**kw)
        dww = dec_dw_work(**kw)
        pw = dwp_work(d=100, b=BATCH, stream_bytes=sb)
        shapes = [(sp, cr.dw_size(3, d, H)) for sp, d in zip(splits,
                                                             (100, H))]
        shapes.append((dws, H * 100 + 100))
        rws = [reduce_work(*sh) for sh in shapes]
        # the two loops' wrappers stage their weights at every launch
        # (inside the loop times below): the staging alone, and the plans
        w = args[3:17]
        bf16 = dtype == torch.bfloat16
        stage = [time_ms(torch, lambda f=f: f(w[0:4], w[6:10], w[12], bf16))
                 for f in (cd.decoder_fwd_weights, cd.decoder_bwd_weights)]
        plans = [cd.decoder_plan(f, N, 100, H, 3, SSL_LAYERS, bf16)
                 for f in (True, False)]
        log(f"time weight staging of the decoder loops L={SSL_LAYERS} D=100 "
            f"M=3 {tag}: forward {stage[0]:.4f} ms, backward "
            f"{stage[1]:.4f} ms a launch; plans: " + ", ".join(
                f"{k} {p['in_smem']} of {p['staged']} staged bytes in "
                f"shared memory, {p['smem']} bytes a block"
                for k, p in zip(("forward", "backward"), plans)))
        report((DEC[0], tag), DEC[0],
               lambda: cd.dcgru_decoder_fwd(*args, SSL_LAYERS,
                                            residuals=True),
               lambda: cd.dcgru_decoder_fwd_plain(*args, SSL_LAYERS,
                                                  residuals=True),
               [dec_work(**kw)], " (with residuals, as the train step)")
        # the bound leaves out the reductions of the split partials, scratch
        report((DEC[1], tag), DEC[1],
               lambda: cd.dcgru_decoder_bwd(*bwd, SSL_LAYERS),
               lambda: cd.dcgru_decoder_bwd_plain(*bwd, SSL_LAYERS),
               [lw, *dww, pw], " (all its kernels)")
        report((DEC_BWD[0], tag), DEC_BWD[0],
               lambda: cd.dcgru_dec_bwd_loop(*loop_a),
               lambda: cd.dcgru_dec_bwd_loop_plain(*loop_a), [lw])
        report(("dcgru_xin_dw (decoder)", tag), "dcgru_xin_dw (decoder: "
               "layer 0 + tied cell)",
               lambda: [cr.dcgru_xin_dw(*a) for a in dw_a],
               lambda: [cr.dcgru_xin_dw_plain(*a) for a in dw_a], dww,
               f" (splits {splits})")
        report((DEC_BWD[1], tag), DEC_BWD[1],
               lambda: cd.dcgru_dec_dwp(h_top, dproj),
               lambda: cd.dcgru_dec_dwp_plain(h_top, dproj), [pw],
               f" ({dws} splits)")
        if dtype == torch.bfloat16:
            # dWp's library call: one product [h_top | 1]^T dproj gives
            # [dWp; dbp] (the ones column built beforehand)
            aug = torch.cat([h_top.reshape(rows, H).float(),
                             torch.ones((rows, 1), device=dev)], dim=1)
            g = dproj.reshape(rows, 100)
            out[(DEC_BWD[1], "library")] = time_ms(
                torch, lambda: torch.matmul(aug.t(), g))
            # what the composite runs for it: the kernel and its reduction
            out[(DEC_BWD[1], "with reduce")] = time_ms(
                torch, lambda: cr.dcgru_dw_reduce(cd.dcgru_dec_dwp(h_top,
                                                                   dproj)))
            log(f"time dWp library call torch.matmul([h_top | 1]^T, dproj) "
                f"({rows} rows, f32): {out[(DEC_BWD[1], 'library')]:.4f} ms; "
                f"{DEC_BWD[1]} with its dcgru_dw_reduce "
                f"{out[(DEC_BWD[1], 'with reduce')]:.4f} ms")
            # the main path's three reductions
            gen = torch.Generator().manual_seed(7)
            parts = [torch.randn(sh, generator=gen).to(dev) for sh in shapes]
            ms = time_ms(torch, lambda: [cr.dcgru_dw_reduce(q)
                                         for q in parts])
            plain_ms = time_ms(torch, lambda: [cr.dcgru_dw_reduce_plain(q)
                                               for q in parts])
            lib_ms = time_ms(torch, lambda: [torch.sum(q, dim=0)
                                             for q in parts])
            bms, by = bound_ms(rws)
            out[("dcgru_dw_reduce", "float32", "dec")] = (ms, plain_ms, rws,
                                                          lib_ms)
            log(f"time dcgru_dw_reduce decoder partials {shapes}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sum "
                f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    log("library_ms: none — no single PyTorch call computes a DCGRU "
        "seq2seq decoder, its BPTT, its state loop or a diffused dW; dWp "
        "is one product, timed above")

    # the SSL step as ssl_bench.py times it: supports built once, on device
    batch = ssl_batch(torch, dev, BATCH, seed=6)
    for dtype in ("bfloat16", "float32"):
        cfg = ssl_cfg("combined", dtype, use_curriculum_learning=True)
        b = dict(batch, supports=compute_supports_torch(
            batch["adjacency"], cfg.filter_type))
        step = ssl_step(torch, cfg, build_model(
            cfg, torch.Generator().manual_seed(11)).state_dict(), dev)
        run = lambda: step(b, batches_seen=BATCHES_SEEN)
        ms, best, loss = time_steps(torch, run)
        if not np.isfinite(loss):
            fail(f"ssl train step {dtype}: loss {loss}")
        out[("ssl", dtype)] = (ms, best)
        log(f"time ssl train step combined {dtype} L={SSL_LAYERS} "
            f"T_in={T} T_out={T_OUT} B={BATCH}: {ms:.3f} ms/step (median "
            f"of {REPS}, each synchronised), {BATCH / ms * 1e3:.1f} "
            f"clips/s; {REPS} back to back: {best:.3f} ms/step, "
            f"{BATCH / best * 1e3:.1f} clips/s (best of 3)")
        profile_batch(torch, run, f"ssl train step combined {dtype}", ms)
    return out


# ---------------------------------------------------------------------------
# the use_pallas path (kernel #7) and the correlation re-score (kernel #8)
# ---------------------------------------------------------------------------


def fdc_work(*, s: int, k: int, o: int, b: int, d: int = H):
    """(FMA FLOPs, bytes, tensor-core FLOPs, their rate) of one fused
    diffusion conv: the Chebyshev terms' S*K support products and the
    (M*D, O) product at the 3xTF32 tensor-core rate (``_tc``), as the
    kernel runs them; the 2 A v - v of the later terms and the bias on
    FMA; supports, x, W and bias read once, out written once."""
    m = s * k + 1
    tc = s * k * 2 * N * N * d + 2 * N * m * d * o
    fma = s * (k - 1) * 2 * N * d + N * o
    nbytes = (s * b * N * N + b * N * d + m * d * o + o + b * N * o) * 4
    return (float(fma * b), float(nbytes), *_tc(tc * b, 4))


def sddmm_work(n: int, d: int, block_rows, block_cols,
               block: int = 128) -> tuple:
    """(FMA FLOPs, bytes, tensor-core FLOPs, their rate) of one block-sparse
    SDDMM of x with itself: 2 D FLOPs per output entry inside N (those past
    N are zeros) at the 3xTF32 rate (a third of the TF32 one: the exact-f32
    product the kernel runs); x and the block coordinates read once, the
    blocks written once."""
    vr = np.clip(n - np.asarray(block_rows, np.int64) * block, 0, block)
    vc = np.clip(n - np.asarray(block_cols, np.int64) * block, 0, block)
    nnzb = len(vr)
    return (0.0, float(n * d * 4 + 2 * nnzb * 4 + nnzb * block * block * 4),
            *_tc(float(2 * d * np.sum(vr * vc)), 4))


def fdc_inputs(torch, dev, *, s, k, o, b, seed):
    """Kernel #7's arguments as the use_pallas loop hands them over:
    per-clip supports from random adjacency, a hidden state in (-1, 1),
    the hidden rows of a xavier-scaled weight re-laid (M, H, O), a random
    bias."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.ops.cuda_kernels import rearrange_weight

    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    m = s * k + 1
    filt = "laplacian" if s == 1 else "dual_random_walk"
    sup = compute_supports_torch(torch.from_numpy(adjacency(rng, b)).to(dev),
                                 filt).contiguous()
    w = 1.414 * (2.0 / (H * m + o)) ** 0.5 * torch.randn((H * m, o),
                                                         generator=gen)
    return (sup, torch.tanh(torch.randn((b, N, H), generator=gen)).to(dev),
            rearrange_weight(w, H, m).contiguous().to(dev),
            (0.1 * torch.randn(o, generator=gen)).to(dev), k)


def phase_fdc_parity(torch, dev):
    """Kernel #7 against its plain version at the loop's shapes: gate
    (O=2H) and candidate (O=H), M=3 (S=1) and M=5 (S=2), B=128 and 37, and
    once K=3; then the autograd Function's dx, dW and db against autograd
    of the plain version under a seeded cotangent."""
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    worst, main_abs, seed = 0.0, 0.0, 1300
    cases = [(s, K, o, b) for s in (1, 2) for o in (2 * H, H)
             for b in (BATCH, 37)] + [(2, 3, 2 * H, BATCH)]
    for s, k, o, b in cases:
        seed += 1
        args = fdc_inputs(torch, dev, s=s, k=k, o=o, b=b, seed=seed)
        got = ck.fused_diffusion_conv_fwd(*args)
        torch.cuda.synchronize()
        err, max_abs = norm_err(got, ck.fused_diffusion_conv_plain(*args))
        if not np.isfinite(err) or err > F32_TOL:
            fail(f"{FDC} S={s} K={k} O={o} B={b}: normalized error "
                 f"{err:.3e} > {F32_TOL:.0e}")
        worst = max(worst, err)
        if (s, k, o, b) == (1, K, 2 * H, BATCH):
            main_abs = max_abs
        log(f"parity {FDC} M={s * k + 1} (S={s}, K={k}) D={H} O={o} B={b} "
            f"float32: norm err {err:.3e} (max abs {max_abs:.3e}, tol "
            f"{F32_TOL:.0e})")
    for s in (1, 2):
        sup, x, w, bias, k = fdc_inputs(torch, dev, s=s, k=K, o=2 * H,
                                        b=BATCH, seed=1400 + s)
        gen = torch.Generator(device=dev).manual_seed(s)
        cot = torch.randn((BATCH, N, 2 * H), generator=gen, device=dev)
        grads = []
        for fn in (ck.fused_diffusion_conv, ck.fused_diffusion_conv_plain):
            leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
            (fn(sup, *leaves, k) * cot).sum().backward()
            grads.append([t.grad for t in leaves])
        errs = [norm_err(g, p)[0] for g, p in zip(*grads)]
        if not all(np.isfinite(errs)) or max(errs) > F32_TOL:
            fail(f"fused_diffusion_conv Function S={s}: gradient errors "
                 f"{errs} > {F32_TOL:.0e}")
        log(f"parity fused_diffusion_conv Function M={s * K + 1} O={2 * H} "
            f"B={BATCH}: dx {errs[0]:.2e}, dW {errs[1]:.2e}, db "
            f"{errs[2]:.2e} vs autograd of the plain version (tol "
            f"{F32_TOL:.0e})")
    return worst, main_abs


def montages(torch, dev):
    """The re-score study's montages (benchmarks/graph_build_bench.py:
    69-107): x (N, 6000) from one seeded stream and a fixed topology, the
    top-3 of |x x^T| per row (directed, no self loops; built on the card)
    or a band of +-32 neighbours."""
    from eeg_gnn_tpu_torch.graphs.xcorr import (
        full_f32_matmul,
        keep_topk_torch,
    )
    from eeg_gnn_tpu_torch.ops.sddmm import edges_to_blocks

    rng = np.random.RandomState(0)
    out = []
    for n, topo in MONTAGES:
        x = torch.from_numpy(rng.randn(n, D_SIG).astype(np.float32)).to(dev)
        if topo == "banded":
            rows = np.repeat(np.arange(n), 2 * BAND)
            offs = np.concatenate([np.arange(-BAND, 0),
                                   np.arange(1, BAND + 1)])
            cols = (rows.reshape(n, 2 * BAND) + offs).reshape(-1) % n
        else:
            with full_f32_matmul():
                adj = keep_topk_torch(torch.matmul(x, x.t()).abs(), TOP_K)
            adj.fill_diagonal_(0.0)
            rows, cols = (v.cpu().numpy() for v in adj.nonzero(
                as_tuple=True))
        br, bc, _, _ = edges_to_blocks(rows, cols, n)
        out.append({"n": n, "topology": topo, "x": x, "rows": rows,
                    "cols": cols, "block_rows": br, "block_cols": bc})
        log(f"montage N={n} {topo}: {len(rows)} edges, {len(br)} of "
            f"{((n + 127) // 128) ** 2} blocks occupied")
    return out


def sddmm_tf32_control(torch, x, y, block_rows, block_cols, block=128):
    """The plain SDDMM's gathered product in one TF32 pass (cuBLAS with
    TF32 on): the lower precision the 3xTF32 kernel exists to avoid."""
    n, d = x.shape
    slabs = lambda v: torch.nn.functional.pad(
        v, (0, 0, 0, (-n) % block)).view(-1, block, d)
    idx = lambda b: torch.as_tensor(np.asarray(b), device=x.device).long()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(slabs(x)[idx(block_rows)],
                            slabs(y)[idx(block_cols)].transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def phase_sddmm_parity(torch, dev, mts):
    """Kernel #8 against its plain version at every montage (D=6000; twice,
    bitwise equal), within a bar that one TF32 pass on the same inputs must
    miss (the control, read beside it); at the top-k montages, whose every
    block is occupied,
    the top-3 of |x x^T| re-scored by the kernel against the host oracle's
    (the top-3 of the float64 Gram on the host, ``graphs/xcorr.keep_topk``);
    and a 19-node clip's normalized edge scores against its correlation
    adjacency."""
    from eeg_gnn_tpu_torch.graphs.xcorr import (
        correlation_adjacency_torch,
        keep_topk,
        keep_topk_torch,
    )
    from eeg_gnn_tpu_torch.ops import sddmm as sd

    worst, main_abs = 0.0, 0.0
    for mt in mts:
        args = (mt["x"], mt["x"], mt["block_rows"], mt["block_cols"])
        got = sd.sddmm_blocksparse(*args)
        torch.cuda.synchronize()
        if not torch.equal(sd.sddmm_blocksparse(*args), got):
            fail(f"{SDDMM} N={mt['n']} {mt['topology']}: two runs differ")
        plain = sd.sddmm_blocksparse_plain(*args)
        err, max_abs = norm_err(got, plain)
        if not np.isfinite(err) or err > SDDMM_TOL:
            fail(f"{SDDMM} N={mt['n']} {mt['topology']}: normalized error "
                 f"{err:.3e} > {SDDMM_TOL:.0e}")
        # the control: the same products in one TF32 pass must miss the bar
        ctrl = norm_err(sddmm_tf32_control(torch, *args), plain)[0]
        del plain
        if not ctrl > SDDMM_TOL:
            fail(f"{SDDMM} N={mt['n']} {mt['topology']}: one TF32 pass reads "
                 f"{ctrl:.3e}, within the bar {SDDMM_TOL:.0e}: the check "
                 "cannot tell it from 3xTF32")
        worst = max(worst, err)
        if (mt["n"], mt["topology"]) == (4096, "banded"):
            main_abs = max_abs
        log(f"parity {SDDMM} N={mt['n']} {mt['topology']} D={D_SIG} "
            f"({len(mt['block_rows'])} blocks): norm err {err:.3e} (max abs "
            f"{max_abs:.3e}, tol {SDDMM_TOL:.0e}); one TF32 pass (control) "
            f"{ctrl:.3e}")
        if mt["topology"] != "topk":
            continue
        n, nb = mt["n"], (mt["n"] + 127) // 128
        if len(mt["block_rows"]) != nb * nb:
            fail(f"top-k montage N={n}: {len(mt['block_rows'])} of "
                 f"{nb * nb} blocks occupied, the re-score check needs all")
        dense = torch.zeros((nb, nb, 128, 128), device=dev)
        dense[torch.as_tensor(mt["block_rows"], device=dev).long(),
              torch.as_tensor(mt["block_cols"], device=dev).long()] = got
        dense = dense.transpose(1, 2).reshape(nb * 128, nb * 128)[:n, :n]
        kept = keep_topk_torch(dense.abs(), TOP_K).fill_diagonal_(0.0)
        x64 = mt["x"].double().cpu().numpy()
        oracle = keep_topk(np.abs(x64 @ x64.T), TOP_K)
        np.fill_diagonal(oracle, 0.0)
        same = np.array_equal(kept.cpu().numpy() != 0, oracle != 0)
        if not same:
            fail(f"top-k montage N={n}: the kernel's re-scored top-{TOP_K} "
                 "edges differ from the host oracle's")
        log(f"parity {SDDMM} N={n} top-{TOP_K}: the edges kept from the "
            f"kernel's scores are the host float64 oracle's "
            f"({int(np.count_nonzero(oracle))} edges)")
    rng = np.random.RandomState(19)
    clip = torch.from_numpy(rng.randn(T, N, 100).astype(np.float32)).to(dev)
    adj = correlation_adjacency_torch(clip)
    off = adj.clone().fill_diagonal_(0.0)
    rows, cols = (v.cpu().numpy() for v in off.nonzero(as_tuple=True))
    flat = clip.transpose(0, 1).reshape(N, -1).contiguous()
    vals = sd.sddmm_edges_blocksparse(rows, cols, flat, flat, N,
                                      normalize=True)
    idx = (torch.as_tensor(rows, device=dev), torch.as_tensor(cols,
                                                              device=dev))
    err = float((vals.abs() - adj[idx]).abs().max())
    if not np.isfinite(err) or err > 1e-5:
        fail(f"19-node clip: |normalized SDDMM| vs correlation adjacency "
             f"{err:.3e} > 1e-05")
    log(f"parity 19-node clip (T={T}, D=100): {len(rows)} top-{TOP_K} "
        f"edges, |normalized SDDMM| vs correlation_adjacency_torch max abs "
        f"{err:.3e} (tol 1e-05)")
    return worst, main_abs


def phase_rescore(torch, mts):
    """Kernel #8's path: each montage's fixed graph re-scored through
    ``sddmm_edges_blocksparse`` (normalized, as the correlation graph
    needs), held against the plain edge-list SDDMM (in chunks of edges)."""
    from eeg_gnn_tpu_torch.ops import sddmm as sd

    # the re-score path's run: counts start at 0 here and are read below
    reset_counts()
    for mt in mts:
        x, rows, cols = mt["x"], mt["rows"], mt["cols"]
        vals = sd.sddmm_edges_blocksparse(rows, cols, x, x, mt["n"],
                                          normalize=True)
        ref = torch.cat([sd.sddmm_edges(rows[i:i + 16384],
                                        cols[i:i + 16384], x, x, True)
                         for i in range(0, len(rows), 16384)])
        err = norm_err(vals, ref)[0]
        if vals.shape != ref.shape or not np.isfinite(err) or err > F32_TOL:
            fail(f"re-score N={mt['n']} {mt['topology']}: {tuple(vals.shape)}"
                 f", normalized error vs the edge list {err:.3e}")
        log(f"rescore N={mt['n']} {mt['topology']}: {len(rows)} normalized "
            f"edge scores, vs the plain edge list {err:.3e}, mean |score| "
            f"{float(vals.abs().mean()):.5f}")
    launched = counts()
    want = {k: 0 for k in KERNELS}
    want[SDDMM] = len(mts)
    if launched != want:
        fail(f"re-score launches {launched}, want {want}")
    log(f"rescore: launches {launched}")
    return launched


def phase_pallas_serve(torch):
    """The use_pallas detector through ``Predictor`` for both graph types in
    float32 and bfloat16: each batch launches kernel #7 2 T L = 240 times
    and no other kernel; probabilities against the naive recurrence's."""
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.serve import Predictor

    rng = np.random.RandomState(7)
    requests = [(rng.randn(n, T, N, 100).astype(np.float32),
                 rng.randint(T // 2, T + 1, size=n), adjacency(rng, n))
                for n in (BATCH, 37)]
    batches = sum(-(-len(r[0]) // BATCH) for r in requests)
    # the use_pallas serving path's run: counts start at 0 here
    reset_counts()
    for gt in ("combined", "individual"):
        for dtype in ("float32", "bfloat16"):
            cfg = flagship_cfg(gt, dtype, True, use_pallas=True)
            params = build_model(
                cfg, torch.Generator().manual_seed(11)).state_dict()
            pred = Predictor(cfg, params)
            naive = Predictor(dataclasses.replace(
                cfg, use_pallas=False, recurrence="naive"), params)
            before = counts()
            probs = [pred.predict_proba(x, lens, adjacency=adj)
                     for x, lens, adj in requests]
            after = counts()
            rose = {k: after[k] - before[k] for k in KERNELS}
            want = {k: 0 for k in KERNELS}
            want[FDC] = PALLAS_FWD * batches
            if rose != want:
                fail(f"use_pallas serve {gt} {dtype}: launches rose by "
                     f"{rose}, want {want}")
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            diff = 0.0
            for (x, lens, adj), p in zip(requests, probs):
                if p.shape != (len(x),) or not np.all(np.isfinite(p)) \
                        or p.min() < 0 or p.max() > 1:
                    fail(f"use_pallas serve {gt} {dtype}: bad probabilities")
                ref = naive.predict_proba(x, lens, adjacency=adj)
                diff = max(diff, float(np.abs(p - ref).max()))
            if counts() != after:
                fail("the naive Predictor launched a kernel")
            if diff > tol:
                fail(f"use_pallas serve {gt} {dtype}: |kernel - naive| = "
                     f"{diff:.3e} > {tol:.0e}")
            log(f"serve use_pallas {gt} {dtype}: "
                f"{sum(len(r[0]) for r in requests)} clips, launches "
                f"+{rose[FDC]} of {FDC}, max |kernel - naive| {diff:.3e} "
                f"(tol {tol:.0e}), mean p {float(np.mean(probs[0])):.4f}")
    launched = counts()
    log(f"serve use_pallas: launches {launched}")
    return launched


def phase_pallas_train(torch, dev):
    """The use_pallas detector through ``TrainStep`` in the same 4
    configurations, 3 steps each: 240 launches of kernel #7 per step and no
    other kernel (its backward is the plain VJP); finite losses; float32
    step-1 gradients against a stacked step from the same weights; in
    bfloat16 the encoder's VJP under one seeded cotangent against the
    float32 stacked encoder (<= 2e-2), the model's step-1 gradients
    printed."""
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    batch = train_batch(torch, dev, BATCH, seed=21)
    # the use_pallas training path's run: counts start at 0 here
    reset_counts()
    vjp_cases = []
    for gt in ("combined", "individual"):
        for dtype in ("float32", "bfloat16"):
            cfg = flagship_cfg(gt, dtype, True, use_pallas=True, **TRAIN_KW)
            model = build_model(cfg, torch.Generator().manual_seed(11))
            init = {k: v.clone() for k, v in model.state_dict().items()}
            step = TrainStep(cfg, model, STEPS_PER_EPOCH, device=dev)
            losses, grads = [], None
            for i in range(3):
                before = counts()
                losses.append(step.loss_and_grads(batch))
                if grads is None:
                    grads = {n: p.grad.clone()
                             for n, p in step.model.named_parameters()}
                step.update()
                after = counts()
                rose = {k: after[k] - before[k] for k in KERNELS}
                want = {k: 0 for k in KERNELS}
                want[FDC] = PALLAS_FWD
                if rose != want:
                    fail(f"use_pallas train {gt} {dtype} step {i}: launches "
                         f"rose by {rose}, want {want}")
            losses = [float(v) for v in losses]
            if not all(np.isfinite(losses)):
                fail(f"use_pallas train {gt} {dtype}: losses {losses}")
            ref_cfg = dataclasses.replace(cfg, use_pallas=False,
                                          recurrence="stacked")
            ref_model = build_model(ref_cfg)
            ref_model.load_state_dict(init)
            ref = TrainStep(ref_cfg, ref_model, STEPS_PER_EPOCH, device=dev)
            before = counts()
            ref_loss = float(ref.loss_and_grads(batch))
            if counts() != before:
                fail("the stacked step launched a kernel")
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            if abs(losses[0] - ref_loss) > tol * abs(ref_loss):
                fail(f"use_pallas train {gt} {dtype}: step-1 loss "
                     f"{losses[0]} vs stacked {ref_loss}")
            ref_grads = {n: p.grad for n, p in ref.model.named_parameters()}
            errs = {n: norm_err(grads[n], g)[0] for n, g in ref_grads.items()}
            name, err = max(errs.items(), key=lambda kv: kv[1])
            if dtype == "float32" and (not np.isfinite(err) or err > tol):
                fail(f"use_pallas train {gt} {dtype}: step-1 gradient {name}"
                     f" vs stacked {err:.3e} > {tol:.0e}")
            log(f"train use_pallas {gt} {dtype}: losses "
                f"{', '.join(f'{v:.6f}' for v in losses)} (stacked "
                f"{ref_loss:.6f}); step-1 grads vs stacked: worst {name} "
                f"{err:.3e} "
                f"({f'tol {tol:.0e}' if dtype == 'float32' else 'not gated'})")
            if dtype == "bfloat16":
                vjp_cases.append((cfg, init, grads, ref_grads))
    launched = counts()
    log(f"train use_pallas: launches {launched}")

    for cfg, init, grads, ref_grads in vjp_cases:
        bf16_model_errors(torch, cfg, init, batch, grads, ref_grads)
        got = encoder_grads(torch, cfg, init, batch)
        exact = encoder_grads(torch, dataclasses.replace(
            cfg, use_pallas=False, recurrence="stacked", dtype="float32"),
            init, batch)
        errs = {n: norm_err(got[n], exact[n])[0] for n in exact}
        name, err = max(errs.items(), key=lambda kv: kv[1])
        if not np.isfinite(err) or err > BF16_TOL:
            fail(f"use_pallas train {cfg.graph_type} bfloat16: encoder VJP "
                 f"{name} vs float32 stacked {err:.3e} > {BF16_TOL:.0e}")
        log(f"train use_pallas {cfg.graph_type} bfloat16: encoder VJP vs "
            f"float32 stacked: worst {name} {err:.3e} (tol {BF16_TOL:.0e}), "
            + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()))
    return launched


def phase_pallas_ssl(torch, dev):
    """SSL pre-training with use_pallas (combined, float32, curriculum on,
    3 steps): per step 3 * 2 T = 360 launches of kernel #7 and the
    decoder's kernels (the decoder ignores the flag: its forward, and its
    backward's ``DEC_BWD_STEP``);
    finite losses; step-1 gradients against a stacked step from the same
    weights and force draws."""
    from eeg_gnn_tpu_torch.models.registry import build_model

    batch = ssl_batch(torch, dev, BATCH, seed=41)
    cfg = ssl_cfg("combined", "float32", use_curriculum_learning=True,
                  use_pallas=True)
    init = {k: v.clone() for k, v in build_model(
        cfg, torch.Generator().manual_seed(11)).state_dict().items()}
    per_step = {k: 0 for k in KERNELS}
    per_step.update({FDC: PALLAS_SSL, DEC[0]: 1, **DEC_BWD_STEP})
    # the use_pallas SSL path's run: counts start at 0 here
    reset_counts()
    step = ssl_step(torch, cfg, init, dev)
    losses, grads = [], None
    for i in range(3):
        before = counts()
        losses.append(step.loss_and_grads(
            batch, batches_seen=BATCHES_SEEN + i * BATCH))
        if grads is None:
            grads = {n: p.grad.clone()
                     for n, p in step.model.named_parameters()}
        step.update()
        after = counts()
        rose = {k: after[k] - before[k] for k in KERNELS}
        if rose != per_step:
            fail(f"use_pallas ssl step {i}: launches rose by {rose}, want "
                 f"{per_step}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        fail(f"use_pallas ssl: losses {losses}")
    ref = ssl_step(torch, dataclasses.replace(
        cfg, use_pallas=False, recurrence="stacked"), init, dev)
    before = counts()
    ref_loss = float(ref.loss_and_grads(batch, batches_seen=BATCHES_SEEN))
    if counts() != before:
        fail("the stacked SSL step launched a kernel")
    launched = counts()
    errs = {n: norm_err(grads[n], p.grad)[0]
            for n, p in ref.model.named_parameters()}
    name, err = max(errs.items(), key=lambda kv: kv[1])
    if abs(losses[0] - ref_loss) > F32_TOL * abs(ref_loss) \
            or not np.isfinite(err) or err > F32_TOL:
        fail(f"use_pallas ssl: step-1 loss {losses[0]} vs stacked "
             f"{ref_loss}, gradient {name} {err:.3e} > {F32_TOL:.0e}")
    log(f"ssl use_pallas combined float32: losses "
        f"{', '.join(f'{v:.6f}' for v in losses)} (stacked {ref_loss:.6f}); "
        f"step-1 grads vs stacked: worst {name} {err:.3e} (tol "
        f"{F32_TOL:.0e}); launches {launched}")
    return launched


def phase_pallas_times(torch, dev, mts):
    """Kernels #7 and #8 beside their plain versions, bounds and library
    calls, and the use_pallas Predictor's clips/s and train step's ms."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.graphs.xcorr import full_f32_matmul
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck
    from eeg_gnn_tpu_torch.ops import sddmm as sd
    from eeg_gnn_tpu_torch.serve import Predictor
    from eeg_gnn_tpu_torch.train import TrainStep

    out = {}
    for s in (1, 2):
        layer = {}
        for o in (2 * H, H):
            args = fdc_inputs(torch, dev, s=s, k=K, o=o, b=BATCH,
                              seed=1500 + s * o)
            # the operands staged once, as the use_pallas loop hands them
            # to a layer's launches
            sup_f, (w_f,) = ck.stage_fdc_operands(args[0], args[2])
            layer[o] = args
            ms = time_ms(torch, lambda: ck.fused_diffusion_conv_fwd(
                *args, (sup_f, w_f)))
            plain_ms = time_ms(
                torch, lambda: ck.fused_diffusion_conv_plain(*args))
            work = fdc_work(s=s, k=K, o=o, b=BATCH)
            bms, by = bound_ms([work])
            fma_ms = bound_ms([(work[0] + work[2], work[1])])[0]
            out[(FDC, s, o)] = (ms, plain_ms, work)
            flops = work[0] + work[2]
            log(f"time {FDC} M={s * K + 1} D={H} O={o} B={BATCH} float32 "
                f"(staged operands): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}, products at "
                f"the 3xTF32 tensor-core rate; {fma_ms:.4f} ms with every "
                f"product on FMA; {flops / 1e9:.4f} GFLOP, "
                f"{work[1] / 1e6:.2f} MB), {flops / ms / 1e9:.2f} TFLOP/s; "
                f"plan {ck.fdc_plan(s, BATCH, N, H, o, K)}")
        # a layer's staging, once a forward: its supports, gate and
        # candidate weights (the loop's 2 T launches share it)
        sup, w_gate, w_cand = layer[2 * H][0], layer[2 * H][2], layer[H][2]
        stage_ms = time_ms(torch, lambda: ck.stage_fdc_operands(
            sup, w_gate, w_cand))
        out[(FDC, s, "staging")] = stage_ms
        log(f"time operand staging of {FDC} M={s * K + 1} B={BATCH}: "
            f"{stage_ms:.4f} ms a layer a forward (supports, gate and "
            "candidate weights)")
    log("library_ms: none — no single PyTorch call computes a diffusion "
        "convolution (a Chebyshev recurrence over per-clip supports, each "
        "term times its weight block)")

    for mt in mts:
        if mt["n"] != 4096:
            continue
        n, x = mt["n"], mt["x"]
        br = torch.as_tensor(mt["block_rows"], device=dev)
        bc = torch.as_tensor(mt["block_cols"], device=dev)
        ms = time_ms(torch, lambda: sd.sddmm_blocksparse(x, x, br, bc))
        plain_ms = time_ms(torch,
                           lambda: sd.sddmm_blocksparse_plain(x, x, br, bc))
        with full_f32_matmul():
            dense_ms = time_ms(torch, lambda: torch.matmul(x, x.t()))
            try:
                nb = (n + 127) // 128
                occ = torch.zeros((nb, nb), dtype=torch.bool, device=dev)
                occ[br.long(), bc.long()] = True
                mask = occ.repeat_interleave(128, 0).repeat_interleave(
                    128, 1)[:n, :n].float().to_sparse_csr()
                xt = x.t()
                run = lambda: torch.sparse.sampled_addmm(mask, x, xt,
                                                         beta=0.0)
                lib_ms = time_ms(torch, run)
                lib = ("torch.sparse.sampled_addmm on a CSR mask of the "
                       f"occupied blocks' {mask.values().numel()} entries")
            except Exception as e:  # recorded: the yardstick, not the port
                lib_ms = None
                lib = (f"torch.sparse.sampled_addmm raised "
                       f"{type(e).__name__}: {str(e)[:200]}")
        work = sddmm_work(n, D_SIG, mt["block_rows"], mt["block_cols"])
        bms, by = bound_ms([work])
        out[(SDDMM, mt["topology"])] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": lib, "dense_gram_ms": dense_ms, "work": work,
            "blocks": len(mt["block_rows"])}
        log(f"time {SDDMM} N={n} {mt['topology']} D={D_SIG} "
            f"({len(mt['block_rows'])} blocks): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, {lib}: "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, dense x x^T "
            f"{dense_ms:.4f} ms, bound {bms:.4f} ms ({by}; "
            f"{work[2] / 1e9:.2f} GFLOP, {work[1] / 1e6:.2f} MB), "
            f"{work[2] / ms / 1e9:.2f} TFLOP/s")

    rng = np.random.RandomState(3)
    xs = rng.randn(BATCH, T, N, 100).astype(np.float32)
    lens = np.full((BATCH,), T, np.int64)
    adj = adjacency(rng, BATCH)
    for dtype in ("bfloat16", "float32"):
        cfg = flagship_cfg("combined", dtype, True, use_pallas=True)
        pred = Predictor(cfg, build_model(
            cfg, torch.Generator().manual_seed(11)).state_dict())
        run = lambda: pred.predict_proba(xs, lens, adjacency=adj)
        ms = time_ms(torch, run, lead=False)
        out[("serve_pallas", dtype)] = ms
        log(f"time Predictor use_pallas combined {dtype} B={BATCH}: "
            f"{ms:.3f} ms/batch, {BATCH / ms * 1e3:.1f} clips/s (host numpy "
            "in, probabilities out)")
        if dtype == "bfloat16":
            profile_batch(torch, run, f"Predictor use_pallas combined "
                          f"{dtype}", ms)
    adj_batch = train_batch(torch, dev, BATCH, seed=5)
    for dtype in ("bfloat16", "float32"):
        cfg = flagship_cfg("combined", dtype, True, use_pallas=True,
                           **TRAIN_KW)
        batch = dict(adj_batch, supports=compute_supports_torch(
            adj_batch["adjacency"], cfg.filter_type))
        step = TrainStep(cfg, build_model(
            cfg, torch.Generator().manual_seed(11)), STEPS_PER_EPOCH,
            device=dev)
        ms, best, loss = time_steps(torch, lambda: step(batch))
        if not np.isfinite(loss):
            fail(f"use_pallas train step {dtype}: loss {loss}")
        out[("train_pallas", dtype)] = (ms, best)
        log(f"time train step use_pallas combined {dtype} B={BATCH}: "
            f"{ms:.3f} ms/step (median of {REPS}, each synchronised), "
            f"{BATCH / ms * 1e3:.1f} clips/s; {REPS} back to back: "
            f"{best:.3f} ms/step, {BATCH / best * 1e3:.1f} clips/s (best "
            "of 3)")
        if dtype == "float32":
            profile_batch(torch, lambda: step(batch),
                          f"train step use_pallas combined {dtype}", ms)
    return out


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def _cli_run(torch, argv, signals, root, kernels, tag):
    """One ``cli.train.main`` run on the card with every count at 0 before
    it; returns (results, run dir, counts, wall s)."""
    from eeg_gnn_tpu_torch.cli import train as cli

    before = set(os.listdir(os.path.join(root, "save", "train"))) \
        if os.path.isdir(os.path.join(root, "save", "train")) else set()
    reset_counts()
    t0 = time.perf_counter()
    res = cli.main(argv + ["--save_dir", os.path.join(root, "save")],
                   signals=signals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    made = sorted(set(os.listdir(os.path.join(root, "save", "train")))
                  - before)
    if len(made) != 1:
        fail(f"cli {tag}: run directories {made}")
    run_dir = os.path.join(root, "save", "train", made[0])
    n = counts()
    for name in kernels:
        if n[name] < 1:
            fail(f"cli {tag}: {name} was never launched")
    for name in ("args.json", "metrics.jsonl", "best.npz", "last.npz",
                 "results.json"):
        if not os.path.exists(os.path.join(run_dir, name)):
            fail(f"cli {tag}: no {name} in {run_dir}")
    with open(os.path.join(run_dir, "results.json")) as f:
        if json.load(f).keys() != res.keys():
            fail(f"cli {tag}: results.json differs from the returned dict")
    return res, run_dir, n, wall


def phase_cli(torch, card):
    """The training CLI end to end on the card through
    ``eeg_gnn_tpu_torch.cli.train.main``: a synthetic corpus (64 files of
    180 s, 60 s clips) held in memory, then detection (combined graph), SSL
    pre-training (3 layers, curriculum on) and detection fine-tuned from
    the SSL run's best.npz, each 2 epochs at full width in bf16. Checks the
    run files, finite losses, one train/Loss line per optimizer step, each
    run's kernels launched, the transplanted encoder, and Predictor on run
    1's best.npz reproducing its test AUROC. Returns the three paths'
    counts and each run's figures (the fine-tune run traced)."""
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.data.datasets import (
        load_dataset_detection,
        load_dataset_ssl,
    )
    from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus
    from eeg_gnn_tpu_torch.serve import Predictor
    from eeg_gnn_tpu_torch.train import trainer as tr
    from eeg_gnn_tpu_torch.train.metrics import eval_dict

    root = os.path.join("chiprun_out", "cli_smoke")
    shutil.rmtree(root, ignore_errors=True)
    signals = {}
    t0 = time.perf_counter()
    p = make_synthetic_corpus(root, signals=signals, **CLI_CORPUS)
    log(f"cli: corpus of {len(signals)} recordings x "
        f"{CLI_CORPUS['file_seconds']} s in "
        f"{time.perf_counter() - t0:.1f} s (in memory; markers on disk)")
    data = ["--input_dir", p["input_dir"], "--raw_data_dir",
            p["raw_data_dir"], "--marker_dir", p["marker_dir"],
            "--adj_mat_dir", p["adj_mat_dir"]]
    model = ["--do_train", "--graph_type", "combined", "--use_fft",
             "--max_seq_len", str(T), "--rnn_units", str(H),
             "--max_diffusion_step", str(K), "--train_batch_size",
             str(CLI_BATCH), "--test_batch_size", str(BATCH),
             "--num_epochs", str(CLI_EPOCHS), "--dtype", "bfloat16"]
    detect = data + model + ["--task", "detection", "--num_rnn_layers", "2"]
    ssl = data + model + ["--task", "SS pre-training", "--num_rnn_layers",
                          str(SSL_LAYERS), "--output_seq_len", str(T_OUT),
                          "--metric_name", "loss",
                          "--use_curriculum_learning"]
    loader_kw = dict(input_dir=p["input_dir"],
                     raw_data_dir=p["raw_data_dir"],
                     train_batch_size=CLI_BATCH, test_batch_size=BATCH,
                     adj_mat_dir=p["adj_mat_dir"], graph_type="combined",
                     use_fft=True, marker_dir=p["marker_dir"],
                     signals=signals, num_workers=1)
    det_sets = load_dataset_detection(max_seq_len=T, build_loaders=False,
                                      **loader_kw)[1]
    ssl_sets = load_dataset_ssl(input_len=T, output_len=T_OUT,
                                build_loaders=False, **loader_kw)[1]

    runs, paths = {}, {}
    res1, dir1, paths["cli_detect"], wall1 = _cli_run(
        torch, detect, signals, root, CLI_DETECT, "detection")
    runs["detection"] = (res1, dir1, wall1, len(det_sets["train"]))
    res2, dir2, paths["cli_ssl"], wall2 = _cli_run(
        torch, ssl, signals, root, SSL_KERNELS, "SSL")
    runs["SSL"] = (res2, dir2, wall2, len(ssl_sets["train"]))

    # run 3, traced: the encoder the trainer starts from, and device busy
    start = {}
    train = tr.Trainer.train

    def recording_train(self, save_dir):
        start.update({k: v.detach().float().cpu().numpy().copy()
                      for k, v in self.model.state_dict().items()})
        return train(self, save_dir)

    tr.Trainer.train = recording_train
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res3, dir3, paths["cli_finetune"], wall3 = _cli_run(
                torch, detect + ["--fine_tune", "--load_model_path",
                                 os.path.join(dir2, "best.npz"),
                                 "--pretrained_num_rnn_layers",
                                 str(SSL_LAYERS)],
                signals, root, CLI_DETECT, "fine-tune")
    finally:
        tr.Trainer.train = train
    runs["fine-tune"] = (res3, dir3, wall3, len(det_sets["train"]))
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")) / 1e6
    with np.load(os.path.join(dir2, "best.npz")) as pre:
        for i in range(2):
            for k in ("gate_w", "gate_b", "cand_w", "cand_b"):
                if not np.array_equal(start[f"encoder.{i}.{k}"],
                                      pre[f"encoder/{i}/{k}"]):
                    fail(f"cli fine-tune: encoder.{i}.{k} did not start "
                         "from the SSL run's best.npz")
    log("cli fine-tune: encoder layers 0-1 start equal to the SSL run's "
        "best.npz")

    stats = {tag: cli_run_stats(tag, *run, card, traced=tag == "fine-tune")
             for tag, run in runs.items()}
    log(f"cli fine-tune, traced: device busy {busy * 1e3:.3f} ms of the "
        f"run's {wall3 * 1e3:.3f} ms wall ({100 * busy / wall3:.1f}%; "
        f"{card})")
    stats["fine-tune"]["busy_s"] = busy

    # Predictor on run 1's best.npz: the test split's probabilities again
    with open(os.path.join(dir1, "args.json")) as f:
        cfg = ExperimentConfig(**json.load(f)).finalize()
    test_loader = load_dataset_detection(max_seq_len=T,
                                         **loader_kw)[0]["test"]
    batches = list(test_loader)
    pred = Predictor.from_checkpoint(os.path.join(dir1, "best.npz"), cfg)
    probs = pred.predict_proba(
        np.concatenate([b.x for b in batches]),
        np.concatenate([b.seq_lengths for b in batches]),
        supports=np.concatenate([b.supports for b in batches], axis=1))
    y = np.concatenate([b.y for b in batches]).astype(int)
    scores, _, _ = eval_dict((probs > res1["best_thresh"]).astype(int), y,
                             probs, average="binary")
    err = abs(scores["auroc"] - res1["auroc"])
    log(f"cli detection: Predictor on best.npz, {len(y)} test clips: auroc "
        f"{scores['auroc']:.6f} against the run's {res1['auroc']:.6f} "
        f"(|diff| {err:.2e}, bar 1e-6)")
    if not err <= 1e-6:
        fail(f"cli detection: Predictor's test auroc {scores['auroc']} != "
             f"the run's {res1['auroc']}")
    corpus = {"root": root, "signals": signals, "detect": detect,
              "ssl": ssl, "ssl_dir": dir2, "paths": p,
              "n_train": {"detection": len(det_sets["train"]),
                          "SSL": len(ssl_sets["train"])}}
    return paths, stats, corpus


def cli_run_stats(tag, res, run_dir, wall, n_train, card, traced=False,
                  steps=None):
    """One CLI run's checks (one train/Loss line per step, ``steps`` or
    one a batch, finite losses, a test AUROC in [0, 1], for
    classification the weighted F1) and figures from its
    ``metrics.jsonl``: per epoch the wall s, the train loop's s and
    clips, and the loader waits."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["value"] for r in rows if r["tag"] == "train/Loss"]
    steps = steps or CLI_EPOCHS * -(-n_train // CLI_BATCH)
    if len(losses) != steps:
        fail(f"cli {tag}: {len(losses)} train/Loss lines, not {steps}")
    if not (np.all(np.isfinite(losses)) and np.isfinite(res["loss"])):
        fail(f"cli {tag}: losses {losses}, test loss {res['loss']}")
    metric = "F1" if "classification" in tag else "auroc"
    if "SSL" not in tag and not 0.0 <= res.get(metric, -1.0) <= 1.0:
        fail(f"cli {tag}: test {metric} {res.get(metric)}")
    by = {k: [r["value"] for r in rows if r["tag"] == f"time/{k}"]
          for k in ("epoch_s", "train_s", "train_loader_wait_s",
                    "loader_wait_s", "train_clips")}
    log(f"cli {tag}: {run_dir}; test "
        + ", ".join(f"{k} {v:.4f}" for k, v in res.items())
        + f"; {len(losses)} steps, train losses "
        + " ".join(f"{v:.4f}" for v in losses))
    for e, (ep, tr_s, tr_wait, wait, clips) in enumerate(zip(
            by["epoch_s"], by["train_s"], by["train_loader_wait_s"],
            by["loader_wait_s"], by["train_clips"]), 1):
        log(f"cli {tag} epoch {e}: {ep:.3f} s wall ({card}), train loop "
            f"{tr_s:.3f} s for {clips:.0f} clips = "
            f"{clips / tr_s:.1f} clips/s ({tr_wait:.3f} s of it waiting "
            f"on the loader); waiting on the loaders (train and dev) "
            f"{wait:.3f} s = {100 * wait / ep:.1f}% of the epoch")
    log(f"cli {tag}: whole run {wall:.3f} s" + (" (traced)" if traced
                                                 else ""))
    return by | {"wall_s": wall, "n_train": n_train, "losses": losses}


# ---------------------------------------------------------------------------
# the on-device input path: the raw front door, the pipeline, the dataset
# caches (resident and rotating) and the CLI's flags for them
# ---------------------------------------------------------------------------


class _Scalars:
    """A metrics sink that keeps the ``train/Loss`` scalars."""

    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "train/Loss":
            self.losses.append(float(value))


def _quiet_log():
    import logging

    logger = logging.getLogger("chip_smoke.input")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def trace(torch, fn):
    """``fn`` under torch.profiler: (device busy ms, wall ms of the traced
    call and a final synchronise, {kernel or copy: device ms}, profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Activity Buffer")
            and e.self_device_time_total > 0}
    return sum(rows.values()), wall, rows, prof


def host_waits(prof) -> dict:
    """The calls in a trace that make the host wait on the device (the
    runtime's synchronizations, blocking copies) and the device-to-host
    copies, by name and count."""
    return {e.key: e.count for e in prof.key_averages()
            if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaEventSynchronize", "cudaMemcpy")
            or e.key.startswith("Memcpy DtoH")}


def h2d_ms(rows) -> float:
    return sum(v for k, v in rows.items() if k.startswith("Memcpy HtoD"))


def _union(spans) -> list:
    """Sorted (start, end) spans merged where they overlap."""
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def timeline(prof, path) -> dict:
    """From the trace's timeline: the device's busy ms (the union of the
    kernel, copy and memset spans over all streams, so a side-stream copy
    under a kernel counts once), the streams that ran kernels, and every
    host-to-device copy as (start us, end us, bytes, stream, us of it
    during which a kernel ran). The profiler can drop copy records (a
    rotating epoch's six slab copies, each timed by CUDA events, showed
    as 4-6 in its traces), so the copies are those it recorded."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    span = lambda e: (e["ts"], e["ts"] + e["dur"])
    kernels = _union(span(e) for e in events if e.get("cat") == "kernel")
    busy = _union(span(e) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    copies = []
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            lo, hi = span(e)
            args = e.get("args", {})
            copies.append((lo, hi, args.get("bytes"), args.get("stream"),
                           sum(max(0.0, min(hi, k_hi) - max(lo, k_lo))
                               for k_lo, k_hi in kernels)))
    return {"busy_ms": sum(hi - lo for lo, hi in busy) / 1e3,
            "kernel_streams": {e.get("args", {}).get("stream")
                               for e in events if e.get("cat") == "kernel"},
            "copies": sorted(copies)}


def eeg_like(rng: np.random.RandomState, b: int, points: int) -> np.ndarray:
    """(b, N, points) float32 raw clips with structure across channels, as
    scalp EEG has: each channel a seeded mixture of six sources whose
    spectra differ (white noise smoothed over 1..32 samples), plus a
    little noise of its own, scaled to RAW_SCALE. White noise would leave
    the top-3 correlation graph at near ties that float32 rounding
    reorders."""
    out = np.empty((b, N, points), np.float32)
    for i in range(b):
        src = rng.randn(6, points)
        for k in range(6):
            w = 2 ** k
            src[k] = np.convolve(src[k], np.ones(w) / np.sqrt(w), "same")
        mix = rng.gamma(0.5, 1.0, size=(N, 6))
        out[i] = (mix @ src + 0.1 * rng.randn(N, points)) * RAW_SCALE
    return out


def graph_flips(adj_a, adj_b) -> np.ndarray:
    """Clips whose top-3 correlation graphs (B, N, N) differ in their edges
    (near ties that two sides' rounding orders differently)."""
    a, b = np.asarray(adj_a) > 0, np.asarray(adj_b) > 0
    return np.flatnonzero((a != b).reshape(len(a), -1).any(axis=1))


def top3(torch, feats):
    """The pipeline's top-3 correlation graphs of (B, T, N, D) features,
    on the host."""
    from eeg_gnn_tpu_torch.graphs.xcorr import correlation_adjacency_torch

    return correlation_adjacency_torch(feats.float(), 3).cpu().numpy()


def phase_raw_serve(torch, dev, card, adj_path, scaler):
    """``Predictor(pipeline=...).predict_proba_raw`` at B=128 on raw (128,
    19, 12000) EEG-like clips from a seed (``eeg_like``), both graphs and
    dtypes, against
    ``predict_proba`` on the same clips featurized by the numpy oracle
    with host supports (float32 <= 1e-4, bfloat16 <= 2e-2, normalized,
    all 128 clips; an individual-graph clip whose top-3 graph differs
    between the oracle and the card, at most 2, is held against
    ``predict_proba`` fed the supports that the numpy ``compute_supports``
    builds from the card's own adjacency, so only the graph's tie-break
    is left out); each batch launches the encoder's forward kernels. Then the median of 20 batches and one traced
    batch (device busy, H2D ms) each. Returns (the path's counts, rows)."""
    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.graphs.distance import load_distance_adjacency
    from eeg_gnn_tpu_torch.graphs.supports import compute_supports
    from eeg_gnn_tpu_torch.graphs.xcorr import correlation_adjacency
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops.fft_features import (
        featurize_clip,
        featurize_clip_np,
    )
    from eeg_gnn_tpu_torch.serve import Predictor

    raw = eeg_like(np.random.RandomState(21), BATCH, T * 200)
    feats64 = np.stack([featurize_clip_np(c.astype(np.float64), 1, 200, True)
                        for c in raw])
    x_host = ((feats64 - FEAT_MEAN) / FEAT_STD).astype(np.float32)
    dist = np.stack(compute_supports(load_distance_adjacency(adj_path),
                                     "laplacian"))
    host_adj = np.stack([correlation_adjacency(f, top_k=3)
                         for f in feats64])
    host_sup = {
        "combined": np.ascontiguousarray(np.broadcast_to(
            dist[:, None], (1, BATCH, N, N))),
        "individual": np.stack([np.stack(compute_supports(
            a, "dual_random_walk")) for a in host_adj], axis=1).astype(
                np.float32)}
    card_adj = top3(torch, featurize_clip(torch.from_numpy(raw).to(dev), 1))
    flips = graph_flips(host_adj, card_adj)
    if len(flips) > 2:
        fail(f"raw serve: {len(flips)} clips' top-3 graphs differ between "
             "the numpy oracle and the card")
    for i in flips:  # these clips take the card's graph, built on the host
        host_sup["individual"][:, i] = np.stack(compute_supports(
            card_adj[i].astype(np.float64), "dual_random_walk"))
    reset_counts()
    preds, rows = [], []
    for gt in ("combined", "individual"):
        for dtype in ("float32", "bfloat16"):
            cfg = flagship_cfg(gt, dtype, True, use_fft=True)
            pipe = make_device_pipeline(
                graph_type=gt, filter_type=cfg.filter_type, top_k=3,
                use_fft=True, time_step_size=1, scaler=scaler,
                augment=False, adj_mat_dir=adj_path, device=dev)
            pred = Predictor(cfg, build_model(cfg, torch.Generator()
                                              .manual_seed(11)).state_dict(),
                             pipeline=pipe)
            before = counts()
            got = pred.predict_proba_raw(raw)
            rose = {k: v - before[k] for k, v in counts().items() if v -
                    before[k]}
            if rose != SERVE_BATCH[True]:
                fail(f"raw serve {gt} {dtype}: launches {rose}, want "
                     f"{SERVE_BATCH[True]}")
            ref = pred.predict_proba(x_host, supports=host_sup[gt])
            if got.shape != (BATCH,) or not np.all(np.isfinite(got)):
                fail(f"raw serve {gt} {dtype}: probabilities {got.shape}")
            err = float(np.abs(got - ref).max()
                        / max(np.abs(ref).max(), 1e-12))
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            if not err <= tol:
                fail(f"raw serve {gt} {dtype}: predict_proba_raw against "
                     f"the host-featurized predict_proba {err:.3e} > {tol}")
            log(f"raw serve {gt} {dtype} B={BATCH}: predict_proba_raw "
                f"against predict_proba on numpy-oracle features and host "
                f"supports {err:.3e} (bar {tol:.0e}, all {BATCH} clips"
                + (f"; {len(flips)} of them on the card's top-3 graph, "
                   "which differs from the oracle's"
                   if gt == "individual" else "") + f"), launches {rose}")
            preds.append((gt, dtype, pred))
    launched = counts()
    for gt, dtype, pred in preds:
        ms = time_ms(torch, lambda: pred.predict_proba_raw(raw), lead=False)
        busy, wall, trows, _ = trace(torch,
                                     lambda: pred.predict_proba_raw(raw))
        h2d = h2d_ms(trows)
        rows.append((gt, dtype, ms, busy, wall, h2d))
        log(f"time predict_proba_raw {gt} {dtype} B={BATCH} raw ({BATCH}, "
            f"{N}, {T * 200}) f32 ({raw.nbytes / 1e6:.1f} MB, pageable): "
            f"{ms:.3f} ms/batch (median of {REPS}), "
            f"{BATCH / ms * 1e3:.1f} clips/s; traced: device busy "
            f"{busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.1f}%), H2D "
            f"{h2d:.3f} ms; {card}")
        for key, v in sorted(trows.items(), key=lambda kv: -kv[1])[:6]:
            log(f"profile   {v:8.3f} ms  {key[:90]}")
    return launched, rows


def phase_pipeline_parity(torch, dev, adj_path, scaler):
    """The pipeline's pieces on the card against the same functions on the
    CPU, B=128 at full width: ``featurize_clip`` on raw clips; on the same
    (CPU-made) features ``features`` and ``ssl_features``, both graphs,
    augmentation off and on with the card generator's draws fed to both;
    the raw call. float32 <= 1e-4 normalized; individual-graph supports on
    the clips whose top-3 graphs agree (at most 2 differ). Features made
    from raw clips on each side are held as amplitudes, exp(log|FFT|):
    the log of a bin whose amplitude is tiny against its window's samples
    (a zero-mean window's DC) carries the float32 FFT's absolute error
    divided by that amplitude, on both sides alike; the log error is
    printed beside."""
    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.ops.fft_features import featurize_clip

    rng = np.random.RandomState(22)
    raw = torch.from_numpy(eeg_like(rng, BATCH, T * 200))
    raw_y = torch.from_numpy(eeg_like(rng, BATCH, T_OUT * 200))
    fx, fy = featurize_clip(raw, 1), featurize_clip(raw_y, 1)
    card_fx = featurize_clip(raw.to(dev), 1).cpu()
    worst = norm_err(card_fx.exp(), fx.exp())[0]
    log_abs = float((card_fx - fx).abs().max())
    at = int((card_fx - fx).abs().argmax())
    if not worst <= F32_TOL:
        fail(f"featurize_clip card vs CPU, amplitudes {worst:.3e}")
    log(f"pipeline featurize_clip B={BATCH} ({BATCH}, {N}, {T * 200}): card "
        f"vs CPU amplitudes {worst:.3e} (bar {F32_TOL:.0e}); log features "
        f"max |diff| {log_abs:.3e}, at a bin of log amplitude "
        f"{float(fx.flatten()[at]):.3f} (bin {at % 100})")
    amp = lambda x: (x.float() * FEAT_STD + FEAT_MEAN).exp()
    for gt in ("combined", "individual"):
        for augment in (False, True):
            kw = dict(graph_type=gt, top_k=3, use_fft=True, time_step_size=1,
                      filter_type=("laplacian" if gt == "combined"
                                   else "dual_random_walk"),
                      scaler=scaler, augment=augment, adj_mat_dir=adj_path)
            card = make_device_pipeline(device=dev, **kw)
            cpu = make_device_pipeline(device="cpu", **kw)
            draws = card.draw(BATCH, torch.Generator(dev).manual_seed(5))
            host_draws = tuple(d.cpu() for d in draws)
            cases = (
                ("features", card.features(fx.to(dev), None, True, draws),
                 cpu.features(fx, None, True, host_draws), fx.to(dev), fx),
                ("ssl_features", card.ssl_features(
                    fx.to(dev), fy.to(dev), None, True, draws),
                 cpu.ssl_features(fx, fy, None, True, host_draws),
                 fx.to(dev), fx),
                ("raw call", card(raw.to(dev)), cpu(raw),
                 featurize_clip(raw.to(dev), 1), fx))
            errs = []
            for name, got, want, g_feats, w_feats in cases:
                flips = (graph_flips(top3(torch, g_feats),
                                     top3(torch, w_feats))
                         if gt == "individual" else np.array([], int))
                if len(flips) > 2:
                    fail(f"pipeline {name} {gt}: {len(flips)} graphs differ")
                for i, (g, w) in enumerate(zip(got, want)):
                    if g.device.type != dev.type or g.shape != w.shape:
                        fail(f"pipeline {name} {gt}: {g.device} {g.shape}")
                    g = g.cpu()
                    if name == "raw call" and i == 0:
                        g, w = amp(g), amp(w)
                    if g.dim() == 4 and g.shape[0] != BATCH and len(flips):
                        keep = np.setdiff1d(np.arange(BATCH), flips)
                        g, w = g[:, keep], w[:, keep]
                    errs.append(norm_err(g, w)[0])
                    if not errs[-1] <= F32_TOL:
                        fail(f"pipeline {name} {gt} augment={augment}: card "
                             f"vs CPU {errs[-1]:.3e}")
            log(f"pipeline {gt} augment={augment} B={BATCH}: features, "
                f"ssl_features, raw call (x as amplitudes): card vs CPU "
                f"worst {max(errs):.3e} "
                f"(bar {F32_TOL:.0e}); reflected {int(draws[0].sum())} of "
                f"{BATCH}")


def run_cached_epochs(torch, tag, cfg, caches, pipe, scaler, init, n_clips,
                      card, trace_path):
    """Three epochs of ``Trainer``'s cached loop over ``caches['train']``
    (the CLI's ``--hbm_cache`` path): a warm one, a timed one (every count
    at 0 before it), a traced one (device busy as the union of the
    kernel and copy spans, ``timeline``). Returns the figures."""
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train.trainer import Trainer

    model = build_model(cfg)
    model.load_state_dict(init)
    bsz, train = cfg.train_batch_size, caches["train"]
    steps = (sum(-(-train.shard_real_rows(s) // bsz)
                 for s in range(train.num_shards))
             if hasattr(train, "num_shards") else -(-n_clips // bsz))
    sink = _Scalars()
    trainer = Trainer(cfg, {"train": range(steps)}, scaler, _quiet_log(),
                      sink, model, input_pipeline=pipe, device_caches=caches)
    rng = np.random.RandomState(cfg.rand_seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, warm_s, _ = trainer._train_epoch(0, rng)
    reset_counts()
    seen, epoch_s, clips = trainer._train_epoch(seen, rng)
    launched = counts()
    _, wall, rows, prof = trace(
        torch, lambda: trainer._train_epoch(seen, rng))
    peak = torch.cuda.max_memory_allocated()
    if clips != n_clips or len(sink.losses) != 3 * steps \
            or not np.all(np.isfinite(sink.losses)):
        fail(f"cached {tag}: {clips} clips, {len(sink.losses)} losses "
             f"(want {3 * steps}), finite {np.all(np.isfinite(sink.losses))}")
    waits = host_waits(prof)
    tl = timeline(prof, trace_path)
    busy = tl["busy_ms"]
    log(f"cached {tag}: epoch of {clips} clips, {steps} steps at "
        f"B={bsz}: {epoch_s:.3f} s = "
        f"{clips / epoch_s:.1f} clips/s (warm-up epoch {warm_s:.3f} s); "
        f"traced epoch: device busy (kernel and copy spans, their union) "
        f"{busy:.3f} of {wall:.3f} ms "
        f"({100 * busy / wall:.1f}%), host waits and D2H copies {waits} "
        f"(a step makes none: expected only the epoch's one loss copy "
        f"and the trace's final synchronise); "
        f"max_memory_allocated "
        f"{peak / 2 ** 30:.3f} GiB; launches "
        f"{ {k: v for k, v in launched.items() if v} }; {card}")
    for key, v in sorted(rows.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile   {v:8.3f} ms  {key[:90]}")
    return launched, {"epoch_s": epoch_s, "clips": clips, "busy": busy,
                      "wall": wall, "peak": peak, "timeline": tl,
                      "losses": sink.losses[:2 * steps]}


def phase_cached(torch, dev, card, adj_path, scaler, out_dir):
    """The device-resident caches at a size a user holds: INPUT_CLIPS
    seeded detection clips stored bf16 (0.93 GB), one epoch of the cached
    train step at B=128 with fused_steps 1 and 4 (accepted and ignored:
    the same losses); the
    SSL cache (x and y, T_in + T_out = 72 windows); the detection split
    rotating under a 0.5 GiB budget (at least 4 shards; each clip once an
    epoch, at most two slabs live, one copy a shard each epoch, timed by
    CUDA events on the copy stream; from the trace, the copies' stream and
    their overlap with the kernels). All bf16, combined graph, no augmentation: supports are
    the shared (S, N, N) slab. Returns (counts by path, figures)."""
    from eeg_gnn_tpu_torch.data.device_cache import DeviceDatasetCache
    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.data.rotating_cache import RotatingDeviceCache
    from eeg_gnn_tpu_torch.models.registry import build_model

    gen = np.random.default_rng(23)
    feats = gen.standard_normal((INPUT_CLIPS, T, N, 100), dtype=np.float32)
    feats += FEAT_MEAN
    labels = (gen.random(INPUT_CLIPS) < 0.5).astype(np.float32)
    pipe = make_device_pipeline(
        graph_type="combined", filter_type="laplacian", top_k=3,
        use_fft=True, time_step_size=1, scaler=scaler, augment=False,
        adj_mat_dir=adj_path, device=dev)
    paths, stats = {}, {}
    t0 = time.perf_counter()
    cache = DeviceDatasetCache(feats, labels, T, storage_dtype="bfloat16",
                               device=dev)
    torch.cuda.synchronize()
    log(f"cached detection: {INPUT_CLIPS} clips of ({T}, {N}, 100), bf16 "
        f"{cache.nbytes() / 1e9:.3f} GB on the card, built in "
        f"{time.perf_counter() - t0:.3f} s (host f32 in row blocks)")
    kw = dict(use_fft=True, do_train=True, train_batch_size=BATCH,
              **TRAIN_KW)
    init = build_model(flagship_cfg("combined", "bfloat16", True, **kw),
                       torch.Generator().manual_seed(11)).state_dict()
    for fused, path in ((1, "cached_train"), (4, "cached_train_fused")):
        cfg = flagship_cfg("combined", "bfloat16", True, fused_steps=fused,
                           **kw)
        paths[path], stats[path] = run_cached_epochs(
            torch, f"detection fused_steps={fused}", cfg, {"train": cache},
            pipe, scaler, init, INPUT_CLIPS, card,
            os.path.join(out_dir, "cached.json"))
    a, b = (np.asarray(stats[p]["losses"]) for p in ("cached_train",
                                                     "cached_train_fused"))
    diff = float(np.abs(a - b).max() / np.abs(a).max())
    if not diff <= F32_TOL:
        fail(f"cached detection: fused_steps 4 losses differ from 1 by "
             f"{diff:.3e}")
    log(f"cached detection: fused_steps 4 (accepted and ignored) against 1, "
        f"two epochs' losses: {diff:.3e} (bar {F32_TOL:.0e})")

    rot = RotatingDeviceCache(feats, labels, T, storage_dtype="bfloat16",
                              budget_bytes=ROTATING_BUDGET, device=dev)
    del cache
    if rot.num_shards < 4:
        fail(f"rotating: {rot.num_shards} shards under the budget")
    plans, live, copies = [], [], []
    shard_plan, prefetch = rot.shard_plan, rot.prefetch

    def recording_plan(shard, *args):
        perm, valid = shard_plan(shard, *args)
        plans.append((shard, perm, valid))
        return perm, valid

    def counting_prefetch(shard):
        # CUDA events on the copy stream around the prefetch: its copies
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record(rot._stream)
        slab = prefetch(shard)
        end.record(rot._stream)
        live.append(rot.resident())
        copies.append((int(shard), start, end))
        return slab

    rot.shard_plan, rot.prefetch = recording_plan, counting_prefetch
    cfg = flagship_cfg("combined", "bfloat16", True, **kw)
    paths["rotating"], stats["rotating"] = run_cached_epochs(
        torch, f"rotating detection ({rot.num_shards} shards of "
        f"{rot.shard_rows})", cfg, {"train": rot}, pipe, scaler, init,
        INPUT_CLIPS, card, trace_path=os.path.join(out_dir, "rot.json"))
    for e in range(3):
        rows = np.concatenate([
            sid * rot.shard_rows + perm[k * BATCH:k * BATCH + v]
            for sid, perm, valid in plans[e * rot.num_shards:
                                          (e + 1) * rot.num_shards]
            for k, v in enumerate(valid)])
        if not np.array_equal(np.sort(rows), np.arange(INPUT_CLIPS)):
            fail(f"rotating epoch {e + 1}: not every clip once")
    if max(live) > 2:
        fail(f"rotating: {max(live)} slabs live at a prefetch")
    n_sh = rot.num_shards
    torch.cuda.synchronize()
    if len(copies) != 3 * n_sh or any(
            sorted(c[0] for c in copies[e * n_sh:(e + 1) * n_sh])
            != list(range(n_sh)) for e in range(3)):
        fail(f"rotating: prefetches {[c[0] for c in copies]}, want each of "
             f"{n_sh} shards once in each of 3 epochs")
    copy_ms = [s_.elapsed_time(e_) for _, s_, e_ in copies[2 * n_sh:]]
    tl = stats["rotating"].pop("timeline")
    row = int(np.prod(rot._x.shape[1:])) * rot._x.element_size()
    sizes = {rot.shard_real_rows(sid) * row for sid in range(n_sh)}
    seen = [c for c in tl["copies"] if c[2] in sizes]
    if len(seen) > n_sh or any(c[3] in tl["kernel_streams"] for c in seen):
        fail(f"rotating: the trace's slab copies {[c[2:4] for c in seen]}: "
             f"more than {n_sh}, or on a stream that runs kernels "
             f"{tl['kernel_streams']}")
    seen_ms = sum(c[1] - c[0] for c in seen) / 1e3
    over_ms = sum(c[4] for c in seen) / 1e3
    stats["rotating"].update(copy_ms=sum(copy_ms), seen=len(seen),
                             seen_ms=seen_ms, over_ms=over_ms)
    log(f"rotating: {rot.num_shards} shards of {rot.shard_rows} clips "
        f"({rot.shard_rows * rot.clip_bytes / 1e6:.1f} MB each, pinned "
        f"host), each clip once in each of 3 epochs, at most {max(live)} "
        f"slabs live; traced epoch: {n_sh} prefetches, their copies "
        f"{sum(copy_ms):.3f} ms by CUDA events on the copy stream ("
        + ", ".join(f"{v:.3f}" for v in copy_ms) + " ms); the trace "
        f"recorded {len(seen)} of the {n_sh} x copies, on stream(s) "
        f"{sorted({c[3] for c in seen}, key=str)} (kernels on "
        f"{sorted(tl['kernel_streams'], key=str)}), {seen_ms:.3f} ms, "
        f"{over_ms:.3f} ms of it under a kernel "
        f"({100 * over_ms / max(seen_ms, 1e-9):.1f}%); epoch "
        f"{stats['rotating']['epoch_s']:.3f} s against the resident "
        f"{stats['cached_train']['epoch_s']:.3f} s; {card}")
    del rot, feats

    fx = gen.standard_normal((INPUT_CLIPS, T, N, 100), dtype=np.float32)
    fy = gen.standard_normal((INPUT_CLIPS, T_OUT, N, 100), dtype=np.float32)
    fx += FEAT_MEAN
    fy += FEAT_MEAN
    t0 = time.perf_counter()
    cache = DeviceDatasetCache(fx, fy, T, storage_dtype="bfloat16",
                               device=dev)
    torch.cuda.synchronize()
    log(f"cached SSL: {INPUT_CLIPS} pairs of ({T} + {T_OUT}, {N}, 100), "
        f"bf16 {cache.nbytes() / 1e9:.3f} GB on the card, built in "
        f"{time.perf_counter() - t0:.3f} s")
    cfg = ssl_cfg("combined", "bfloat16", use_curriculum_learning=True,
                  use_fft=True, do_train=True, train_batch_size=BATCH)
    init = build_model(cfg, torch.Generator().manual_seed(11)).state_dict()
    paths["cached_ssl"], stats["cached_ssl"] = run_cached_epochs(
        torch, f"SSL L={SSL_LAYERS}", cfg, {"train": cache}, pipe, scaler,
        init, INPUT_CLIPS, card, os.path.join(out_dir, "ssl.json"))
    return paths, stats


def phase_cli_input(torch, card, corpus):
    """``cli.train.main`` with the input path's flags on phase_cli's
    corpus, at its widths, 2 epochs, bf16: detection with --hbm_cache, SSL
    with --hbm_cache, detection with --device_pipeline on the individual
    graph, detection with --hbm_cache --fused_steps 4; each once untraced
    (its counts and figures) and once traced (device busy)."""
    from torch.profiler import ProfilerActivity, profile

    runs = (("cli_hbm_detect", "detection hbm_cache", ["--hbm_cache"],
             CLI_DETECT, "detection"),
            ("cli_hbm_ssl", "SSL hbm_cache", ["--hbm_cache"], SSL_KERNELS,
             "SSL"),
            ("cli_pipeline_detect", "detection device_pipeline individual",
             ["--device_pipeline", "--graph_type", "individual"],
             CLI_DETECT, "detection"),
            ("cli_hbm_fused", "detection hbm_cache fused_steps 4",
             ["--hbm_cache", "--fused_steps", "4"], CLI_DETECT,
             "detection"))
    paths, stats = {}, {}
    for path, tag, flags, kernels, task in runs:
        argv = corpus["detect" if task == "detection" else "ssl"] + flags
        res, run_dir, paths[path], wall = _cli_run(
            torch, argv, corpus["signals"], corpus["root"], kernels, tag)
        stats[tag] = cli_run_stats(tag, res, run_dir, wall,
                                   corpus["n_train"][task], card)
        shutil.rmtree(run_dir)  # its checkpoints: the figures are read
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, run_dir, _, traced = _cli_run(
                torch, argv, corpus["signals"], corpus["root"], kernels,
                tag + " traced")
        shutil.rmtree(run_dir)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("Activity Buffer")) / 1e6
        stats[tag]["busy_s"], stats[tag]["traced_wall_s"] = busy, traced
        log(f"cli {tag}, traced run: device busy {busy * 1e3:.3f} ms of "
            f"its {traced * 1e3:.3f} ms wall ({100 * busy / traced:.1f}%; "
            f"{card})")
    return paths, stats


def phase_input(torch, dev, card, corpus):
    """The on-device input path (``data/device_pipeline.py``,
    ``data/device_cache.py``, ``data/rotating_cache.py``): the raw front
    door, the pipeline's pieces, the caches, the CLI's flags. Returns
    (counts by path, figures)."""
    import pickle

    from eeg_gnn_tpu_torch.data.scaler import StandardScaler

    out_dir = os.path.join("chiprun_out", "input_path")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    adj_path = os.path.join(out_dir, "adj_mx.pkl")
    with open(adj_path, "wb") as f:
        pickle.dump([["c"] * N, {}, adjacency(np.random.RandomState(17),
                                              1)[0]], f)
    scaler = StandardScaler(FEAT_MEAN, FEAT_STD)
    paths, stats = {}, {}
    paths["serve_raw"], stats["serve_raw"] = phase_raw_serve(
        torch, dev, card, adj_path, scaler)
    phase_pipeline_parity(torch, dev, adj_path, scaler)
    cached_paths, stats["cached"] = phase_cached(torch, dev, card, adj_path,
                                                 scaler, out_dir)
    paths.update(cached_paths)
    cli_paths, stats["cli"] = phase_cli_input(torch, card, corpus)
    paths.update(cli_paths)
    return paths, stats


# ---------------------------------------------------------------------------
# the offline input path: EDF ingest, the clip store and its native gather,
# and the detector's train step fed from the store
# ---------------------------------------------------------------------------


def resample_lebesgue(n_in: int, n_out: int) -> float:
    """The inf-norm of ``scipy.signal.resample`` from n_in to n_out points
    as a linear map (its largest row sum of |entries|): the most a bounded
    input error can grow through it. The map commutes with shifts of n_in/g
    input and n_out/g output points (g their gcd), so n_in/g impulse
    responses hold every entry."""
    from scipy.signal import resample

    g = math.gcd(n_in, n_out)
    p, q = n_in // g, n_out // g
    cols = [resample(np.eye(1, n_in, r)[0], n_out) for r in range(p)]
    m = np.arange(n_in // p)
    return max(sum(np.abs(cols[r][(i - q * m) % n_out]).sum()
                   for r in range(p)) for i in range(q))


def write_edf_corpus(corpus, edf_dir, res_dir) -> dict:
    """Phase 10's recordings as EDF at ``INGEST_RATE`` (scipy's FFT
    resampling up from 200 Hz), TUSZ-style labels, ``INGEST_EXTRA``
    seeded channels beside the montage, the channels in a seeded order,
    the annotations copied beside; returns {h5 path the ingest writes:
    (the 200 Hz original, the 250 Hz signal written)}."""
    from scipy.signal import resample

    from eeg_gnn_tpu_torch.constants import FREQUENCY, INCLUDED_CHANNELS
    from eeg_gnn_tpu_torch.data.edf import write_edf

    rng = np.random.RandomState(23)
    labels = [c + "-REF" for c in INCLUDED_CHANNELS] + list(INGEST_EXTRA)
    originals = {}
    for h5 in sorted(corpus["signals"]):
        sig = corpus["signals"][h5]
        stem = os.path.basename(h5)[:-len(".h5")]
        up = resample(sig, sig.shape[1] * INGEST_RATE // FREQUENCY, axis=1)
        full = np.concatenate(
            [up, rng.randn(len(INGEST_EXTRA), up.shape[1]) * RAW_SCALE])
        order = rng.permutation(len(labels))
        write_edf(os.path.join(edf_dir, stem + ".edf"), full[order],
                  [labels[i] for i in order], INGEST_RATE)
        for ext in (".tse_bi", ".tse"):
            shutil.copy(os.path.join(corpus["paths"]["raw_data_dir"],
                                     stem + ext), edf_dir)
        originals[os.path.join(res_dir, stem + ".h5")] = (sig, up)
    return originals


def ingest_gate(ingested, originals, edf_dir, card):
    """The ingested signals against the 200 Hz originals. The bound a
    channel: the resampling round trip's own error on that channel's
    clean signal (200 -> 250 -> 200 Hz, no quantization), plus the EDF's
    int16 rounding (at most half a step q = physical span / 65535, the
    writer's range read back from the header) grown by the 250 -> 200 Hz
    map's inf-norm (``resample_lebesgue``), plus float64 rounding (1e-12
    of the channel's peak)."""
    from scipy.signal import resample

    from eeg_gnn_tpu_torch.constants import INCLUDED_CHANNELS
    from eeg_gnn_tpu_torch.data.edf import read_edf_header

    lam = {}
    worst, worst_err_q, rms_q = 0.0, 0.0, []
    for path, got in ingested.items():
        sig, up = originals[path]
        key = (up.shape[1], sig.shape[1])
        if key not in lam:
            lam[key] = resample_lebesgue(*key)
        h = read_edf_header(os.path.join(
            edf_dir, os.path.basename(path)[:-len(".h5")] + ".edf"))
        stripped = [lab.split("-")[0] for lab in h.labels]
        order = [stripped.index(c) for c in INCLUDED_CHANNELS]
        q = ((h.physical_max - h.physical_min) / 65535.0)[order]
        clean = np.abs(resample(up, sig.shape[1], axis=1) - sig).max(axis=1)
        bound = clean + lam[key] * q / 2 + 1e-12 * np.abs(sig).max(axis=1)
        err = np.abs(got - sig)
        worst = max(worst, float((err.max(axis=1) / bound).max()))
        worst_err_q = max(worst_err_q, float((err.max(axis=1) / q).max()))
        rms_q.append(np.sqrt((err ** 2).mean(axis=1)) / q)
        if got.shape != sig.shape:
            fail(f"ingest: {path} {got.shape}, not {sig.shape}")
    rms_q = np.concatenate(rms_q)
    (key, lam_v), = lam.items()
    log(f"ingest gate: {len(ingested)} recordings x 19 channels against the "
        f"200 Hz originals: worst max|err| / bound {worst:.4f} (gate <= 1; "
        f"bound = the clean round trip's error + {lam_v:.4f} (the "
        f"{key[0]} -> {key[1]} point resampler's inf-norm) x q/2 + 1e-12 "
        f"of the peak); max|err| at most {worst_err_q:.4f} q; rms "
        f"{rms_q.min():.4f}-{rms_q.max():.4f} q (rounding spread over 4/5 "
        f"of the band: sqrt(0.8 / 12) = {math.sqrt(0.8 / 12):.4f} q); "
        f"{card}")
    if not worst <= 1.0:
        fail(f"ingest: an ingested signal is {worst} x its bound from the "
             "original")


def gather_checks(store, ingested, res_dir, card):
    """The train store's gates: the native gather bitwise equal to
    ``gather_plain`` on every batch of one epoch's plan (the loader's),
    a batch bitwise equal to ``raw_clip`` of the ingested signals, the
    out-of-range refusal; then the gather's rate at B=CLI_BATCH and
    BATCH, one thread and the default, as the loader calls it (a fresh
    batch) and into a reused buffer (host clock, median of GATHER_REPS,
    the store's pages warm in the page cache: just written)."""
    from eeg_gnn_tpu_torch.constants import FREQUENCY
    from eeg_gnn_tpu_torch.data import clipstore as cs
    from eeg_gnn_tpu_torch.data.clips import raw_clip

    n = len(store)
    plan = np.arange(n)
    np.random.RandomState(INGEST_SEED).shuffle(plan)
    loader = cs.ClipStoreLoader(store, CLI_BATCH, True, T, seed=INGEST_SEED)
    batches = list(loader)
    for k, batch in enumerate(batches):
        rows = plan[k * CLI_BATCH:(k + 1) * CLI_BATCH]
        if not (np.array_equal(batch.x, store.gather_plain(rows))
                and batch.names == [store.names[i] for i in rows]):
            fail(f"clip store: batch {k} of the epoch's plan differs from "
                 "the plain gather")
    first = batches[0]
    stacked = np.stack([raw_clip(
        ingested[os.path.join(res_dir, name.split(".edf")[0] + ".h5")],
        int(name.split("_")[-1]), T) for name in first.names]).astype(
            np.float32)
    if not np.array_equal(first.x, stacked):
        fail("clip store: a batch differs from raw_clip of the ingested "
             "signals")
    for bad in ([n], [-1], [0, n + 5]):
        try:
            store.gather(bad)
        except IndexError:
            continue
        fail(f"clip store: gather({bad}) of {n} clips did not raise")
    log(f"clip store gates: the native gather bitwise equal to the plain "
        f"one on all {len(batches)} batches of an epoch's plan at "
        f"B={CLI_BATCH}; the first batch bitwise equal to raw_clip of the "
        f"ingested signals; gather([{n}]), ([-1]) and ([0, {n + 5}]) raise")
    clip_bytes = N * T * FREQUENCY * 4
    rng = np.random.RandomState(29)
    rates = {}
    for b in (CLI_BATCH, BATCH):
        out = np.empty((b, N, T * FREQUENCY), np.float32)
        for threads in (1, 0):
            timed = cs.ClipStore(store.path, num_threads=threads)
            idx = [rng.randint(0, n, b) for _ in range(GATHER_REPS + 3)]
            fresh, reuse = [], []
            for i in idx:
                t0 = time.perf_counter()
                timed.gather(i)
                fresh.append(time.perf_counter() - t0)
            for i in idx:
                t0 = time.perf_counter()
                timed.gather(i, out=out)
                reuse.append(time.perf_counter() - t0)
            timed.close()
            ms = [statistics.median(v[3:]) * 1e3 for v in (fresh, reuse)]
            name = "1" if threads else f"default ({min(8, os.cpu_count())})"
            rates[b, threads] = ms
            log(f"gather B={b} threads {name}: a fresh batch (as the loader) "
                f"{ms[0]:.3f} ms = {b / ms[0] * 1e3:.1f} clips/s = "
                f"{b * clip_bytes / ms[0] / 1e6:.2f} GB/s written; into a "
                f"reused buffer {ms[1]:.3f} ms = {b / ms[1] * 1e3:.1f} "
                f"clips/s = {b * clip_bytes / ms[1] / 1e6:.2f} GB/s (host "
                f"clock, median of {GATHER_REPS}; {b * clip_bytes / 1e6:.1f} "
                f"MB a batch; store pages warm; host of {card})")
    return rates


def ingest_run(torch, tag, cfg, loaders, scaler, pipe, save, dev,
               traced=False):
    """``run_experiment`` with every count at 0 before it; each train
    step's launches recorded (``TrainStep.__call__`` wrapped). Returns
    (results, counts, per-step counts, wall s, device busy s or None)."""
    from torch.profiler import ProfilerActivity, profile

    from eeg_gnn_tpu_torch.train import step as step_mod
    from eeg_gnn_tpu_torch.train.trainer import run_experiment
    from eeg_gnn_tpu_torch.utils.logging import MetricsWriter

    os.makedirs(save)
    tbx = MetricsWriter(save)
    per_step = []
    call = step_mod.TrainStep.__call__

    def counted(self, *a, **k):
        before = counts()
        out = call(self, *a, **k)
        after = counts()
        per_step.append({n: after[n] - before[n] for n in after})
        return out

    step_mod.TrainStep.__call__ = counted
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if traced else None
    try:
        if prof is not None:
            prof.__enter__()
        reset_counts()
        t0 = time.perf_counter()
        res = run_experiment(cfg, loaders, scaler, save, _quiet_log(), tbx,
                             device=dev, input_pipeline=pipe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        step_mod.TrainStep.__call__ = call
        tbx.close()
    busy = None if prof is None else sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.key.startswith("Activity Buffer")) / 1e6
    return res, n, per_step, wall, busy


def phase_ingest(torch, dev, card, corpus, input_cli):
    """EDF to the detector's train step through the clip store:
    phase 10's recordings written as EDF (``write_edf_corpus``), ingested
    by ``cli.preprocess.resample_all(signals=...)`` (``ingest_gate``), a
    clip store a split from the detection markers
    (``build_clipstore_from_detection_markers(signals=...)``; the train
    store's gates and rates, ``gather_checks``), step 1 on the store's
    first batch against step 1 on the same clips through the streaming
    ``RawDetectionDataset`` (same weights and generator seed), then
    ``run_experiment`` on ``ClipStoreLoader``s with the CLI's
    ``DevicePipeline`` (``--device_pipeline``; the full-width detector,
    combined graph, bf16, B=40, 2 epochs): each step launching exactly
    ``TRAIN_STEP[True]``, once untraced and once traced, beside the same
    run on the streaming loaders and ``phase_input``'s
    ``--device_pipeline`` run. The phase's files are removed at the end.
    Returns the untraced clip-store run's counts."""
    from eeg_gnn_tpu_torch.cli.preprocess import resample_all
    from eeg_gnn_tpu_torch.cli.train import input_path
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.data import clipstore as cs
    from eeg_gnn_tpu_torch.data.datasets import load_dataset_detection
    from eeg_gnn_tpu_torch.data.loader import collate
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train.step import TrainStep

    t_phase = time.perf_counter()
    root = os.path.join("chiprun_out", "ingest")
    shutil.rmtree(root, ignore_errors=True)
    edf_dir, res_dir = os.path.join(root, "edf"), os.path.join(root, "res")
    os.makedirs(edf_dir)
    p = corpus["paths"]
    stores = {}
    try:
        t0 = time.perf_counter()
        originals = write_edf_corpus(corpus, edf_dir, res_dir)
        write_s = time.perf_counter() - t0
        edfs = [os.path.join(edf_dir, f) for f in os.listdir(edf_dir)
                if f.endswith(".edf")]
        edf_mb = sum(os.path.getsize(f) for f in edfs) / 1e6
        ingested = {}
        t0 = time.perf_counter()
        failed = resample_all(edf_dir, res_dir, signals=ingested)
        ingest_s = time.perf_counter() - t0
        if failed or sorted(ingested) != sorted(originals):
            fail(f"ingest: failed {failed}, {len(ingested)} of "
                 f"{len(originals)} recordings")
        log(f"ingest: {len(edfs)} EDF files ({edf_mb:.1f} MB: "
            f"{N + len(INGEST_EXTRA)} channels at {INGEST_RATE} Hz, "
            f"written in {write_s:.3f} s) resampled to 200 Hz in "
            f"{ingest_s:.3f} s: {ingest_s / len(edfs) * 1e3:.2f} ms a "
            f"file, {edf_mb / ingest_s:.1f} MB/s of EDF (host CPU; host "
            f"of {card})")
        ingest_gate(ingested, originals, edf_dir, card)
        del originals

        t0 = time.perf_counter()
        for split in ("train", "dev", "test"):
            path = os.path.join(root, f"{split}.ecs")
            cs.build_clipstore_from_detection_markers(
                path, res_dir, p["marker_dir"], split, T,
                seed=INGEST_SEED, signals=ingested)
            stores[split] = cs.ClipStore(path)
        log(f"clip stores built in {time.perf_counter() - t0:.3f} s: "
            + ", ".join(f"{s} {len(st)} clips "
                        f"{os.path.getsize(st.path) / 1e6:.1f} MB"
                        for s, st in stores.items()))
        gather_checks(stores["train"], ingested, res_dir, card)

        cfg = ExperimentConfig(
            task="detection", graph_type="combined", use_fft=True,
            max_seq_len=T, num_rnn_layers=2, rnn_units=H,
            max_diffusion_step=K, train_batch_size=CLI_BATCH,
            test_batch_size=BATCH, num_epochs=CLI_EPOCHS, dtype="bfloat16",
            device_pipeline=True, do_train=True, input_dir=res_dir,
            raw_data_dir=edf_dir).finalize()
        stream, sets, scaler = load_dataset_detection(
            input_dir=res_dir, raw_data_dir=edf_dir,
            train_batch_size=CLI_BATCH, test_batch_size=BATCH,
            max_seq_len=T, num_workers=cfg.num_workers,
            adj_mat_dir=p["adj_mat_dir"], graph_type=cfg.graph_type,
            filter_type=cfg.filter_type, use_fft=True, seed=INGEST_SEED,
            marker_dir=p["marker_dir"], raw_mode=True, signals=ingested)
        pipe, _ = input_path(cfg, scaler, adj_mat_dir=p["adj_mat_dir"],
                             marker_dir=p["marker_dir"], signals=ingested,
                             device=dev)
        n_train = len(stores["train"])
        if len(sets["train"]) != n_train:
            fail(f"clip store: {n_train} train clips, the dataset "
                 f"{len(sets['train'])}")

        def loaders():
            return {s: cs.ClipStoreLoader(st, CLI_BATCH if s == "train"
                                          else BATCH, s == "train", T,
                                          seed=INGEST_SEED)
                    for s, st in stores.items()}

        # step 1 on the store's first batch and on the same clips streamed
        first = next(iter(loaders()["train"]))
        by_name = {h5_fn.split(".h5")[0]: i
                   for i, (h5_fn, _) in enumerate(sets["train"].file_tuples)}
        streamed = collate([sets["train"][by_name[nm]] for nm in first.names])
        if not (np.array_equal(first.x, streamed.x)
                and np.array_equal(first.y, streamed.y)):
            fail("ingest: the store's first batch differs from the same "
                 "clips through RawDetectionDataset")
        losses = []
        for batch in (first, streamed):
            step = TrainStep(
                cfg, build_model(cfg, torch.Generator().manual_seed(
                    cfg.rand_seed)),
                steps_per_epoch=-(-n_train // CLI_BATCH), device=dev,
                generator=torch.Generator(device=dev).manual_seed(
                    cfg.rand_seed),
                input_pipeline=pipe)
            losses.append(float(step({"raw": batch.x, "y": batch.y,
                                      "seq_lengths": batch.seq_lengths})))
        diff = abs(losses[0] - losses[1])
        log(f"ingest step 1: the store's first batch {losses[0]!r}, the "
            f"same clips through RawDetectionDataset {losses[1]!r} "
            f"(|diff| {diff:.3e}; {'bitwise' if diff == 0 else 'not bitwise'}"
            f", gate rel 1e-4)")
        if not diff <= 1e-4 * abs(losses[1]):
            fail(f"ingest: step 1 on the store {losses[0]} against the "
                 f"streamed clips {losses[1]}")

        want = {k: TRAIN_STEP[True].get(k, 0) for k in KERNELS}
        steps = CLI_EPOCHS * -(-n_train // CLI_BATCH)
        stats, launched = {}, None
        for tag, traced in (("clip store", False), ("clip store traced",
                                                    True),
                            ("streaming", False)):
            res, n, per_step, wall, busy = ingest_run(
                torch, tag, cfg, stream if tag == "streaming" else loaders(),
                scaler, pipe, os.path.join(root, tag.replace(" ", "_")), dev,
                traced)
            if len(per_step) != steps or any(s != want for s in per_step):
                bad = [s for s in per_step if s != want][:1]
                fail(f"ingest {tag}: {len(per_step)} steps (want {steps}); "
                     f"a step's launches {bad}, not {want}")
            if {k for k, v in n.items() if v} - set(CLI_DETECT):
                fail(f"ingest {tag}: launches {n}")
            stats[tag] = cli_run_stats(
                f"ingest {tag}", res, os.path.join(root, tag.replace(
                    " ", "_")), wall, n_train, card, traced=traced)
            stats[tag]["busy_s"] = busy
            shutil.rmtree(os.path.join(root, tag.replace(" ", "_")))
            if tag == "clip store":
                launched = n
        log(f"ingest: every step of the three runs launched exactly "
            f"{ {k: v for k, v in want.items() if v} }")
        pipeline = input_cli["detection device_pipeline individual"]
        traced = stats["clip store traced"]
        for tag, st in (("clip store", stats["clip store"]),
                        ("streaming (RawDetectionDataset, combined)",
                         stats["streaming"]),
                        ("phase_input --device_pipeline (individual)",
                         pipeline)):
            clips, secs = sum(st["train_clips"]), sum(st["train_s"])
            wait, wall = sum(st["loader_wait_s"]), sum(st["epoch_s"])
            tw = sum(st["train_loader_wait_s"])
            log(f"input path {tag}: epochs "
                + " ".join(f"{e:.3f}" for e in st["epoch_s"])
                + f" s; train loop {clips / secs:.1f} clips/s ({tw:.3f} s "
                f"of its {secs:.3f} s waiting on the loader, "
                f"{100 * tw / secs:.1f}%); loader wait {100 * wait / wall:.1f}"
                f"% of the epochs' {wall:.3f} s; {card}")
        busy, wall = traced["busy_s"], traced["wall_s"]
        log(f"input path clip store, traced run: device busy "
            f"{busy * 1e3:.3f} ms of its {wall * 1e3:.3f} ms wall "
            f"({100 * busy / wall:.1f}%); "
            f"phase_input's --device_pipeline traced run "
            f"{100 * pipeline['busy_s'] / pipeline['traced_wall_s']:.1f}%; "
            f"{card}")
    finally:  # a run's figures are read; its files are not kept
        for st in stores.values():
            st.close()
        shutil.rmtree(root, ignore_errors=True)
    log(f"ingest: {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# seizure-type classification: the train step, Predictor, .pth.tar and the
# CLI (configs/run_dcrnn_classification.sh)
# ---------------------------------------------------------------------------


def cls_cfg(graph_type, dtype, **kw):
    """The 4-class seizure-type DCRNN at the recipe's widths (2 layers x
    64, K=2, D=100, T=60, dropout 0.5)."""
    return flagship_cfg(graph_type, dtype, True, task="classification",
                        num_classes=CLS_CLASSES, dropout=CLS_DROPOUT,
                        use_fft=True, **kw)


def cls_batch(torch, dev, b, seed):
    """A classification batch on the device: seeded lengths over 1..T that
    include 1 and T, the padded tail exactly zero (the host loader pads
    after standardizing), random classes, per-clip adjacency."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=b)
    lens[:2] = (1, T)
    x = rng.randn(b, T, N, 100).astype(np.float32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    y = rng.randint(0, CLS_CLASSES, size=b)
    return {"x": torch.from_numpy(x).to(dev),
            "y": torch.from_numpy(y).to(dev),
            "seq_lengths": torch.from_numpy(lens.astype(np.int64)).to(dev),
            "adjacency": torch.from_numpy(adjacency(rng, b)).to(dev)}


def cls_encoder_grads(torch, cfg, init, batch, seed=41):
    """Gradients of the encoder's weights under the classifier's own
    cotangent: a seeded (B, N, H) slab at each clip's last valid step
    (``last_relevant``), zeros elsewhere in h_seq; the two layers' BPTT
    with no head."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcgru import encoder_apply
    from eeg_gnn_tpu_torch.models.dcrnn import last_relevant
    from eeg_gnn_tpu_torch.models.registry import build_model

    dev = batch["x"].device
    model = build_model(cfg)
    model.load_state_dict(init)
    model.to(dev).train()
    sup = compute_supports_torch(batch["adjacency"], cfg.filter_type)
    _, top = encoder_apply(model.cell_cfgs, [c.params() for c in
                                             model.encoder],
                           sup, batch["x"].transpose(0, 1))
    last = last_relevant(top.transpose(0, 1), batch["seq_lengths"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    cot = torch.randn(tuple(last.shape), generator=gen, device=dev)
    named = list(model.encoder.named_parameters())
    grads = torch.autograd.grad((last.float() * cot).sum(),
                                [p for _, p in named])
    return {f"encoder.{n}": g for (n, _), g in zip(named, grads)}


def cls_logits(torch, cfg, init, batch):
    """The classifier's logits in eval mode (no dropout)."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.registry import build_model

    model = build_model(cfg)
    model.load_state_dict(init)
    model.to(batch["x"].device).eval()
    with torch.no_grad():
        return model(batch["x"], batch["seq_lengths"],
                     compute_supports_torch(batch["adjacency"],
                                            cfg.filter_type)).float()


def phase_cls_train(torch, dev):
    """The classification train step at B=128, T=60, 4 classes, dropout
    0.5, combined (M=3) and individual (M=5), float32 and bfloat16: each
    step launches exactly ``TRAIN_STEP[True]``; step 1 twice on the same
    inputs and dropout draws gives bitwise equal gradients; logits and
    step-1 gradients against the stacked (plain) path from the same
    weights and draws (float32 <= 1e-4), in bfloat16 the logits (<= 2e-2)
    and the encoder's gradients under the classifier's scattered
    cotangent against the float32 stacked encoder (<= 2e-2). Returns the
    path's counts: the steps' launches, not the comparisons'."""
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    batch = cls_batch(torch, dev, BATCH, seed=51)
    reset_counts()
    launched = {k: 0 for k in counts()}
    want = {k: TRAIN_STEP[True].get(k, 0) for k in KERNELS}
    for gt in ("combined", "individual"):
        for dtype in ("float32", "bfloat16"):
            cfg = cls_cfg(gt, dtype, **TRAIN_KW)
            tag = f"classification {gt} {dtype}"
            model = build_model(cfg, torch.Generator().manual_seed(11))
            init = {k: v.clone() for k, v in model.state_dict().items()}
            step = TrainStep(cfg, model, STEPS_PER_EPOCH, device=dev)
            grads, losses = [], []
            for i in range(4):
                if i < 2:  # step 1 twice: the same draws, the same weights
                    step.generator.manual_seed(5)
                before = counts()
                losses.append(float(step.loss_and_grads(batch)))
                if i < 2:
                    grads.append({n: p.grad.clone() for n, p in
                                  step.model.named_parameters()})
                if i > 0:
                    step.update()
                rose = {k: v - before[k] for k, v in counts().items()}
                for k, v in rose.items():
                    launched[k] += v
                if {k: rose[k] for k in KERNELS} != want:
                    fail(f"{tag} step {i}: launches rose by {rose}, want "
                         f"{want}")
            if not np.all(np.isfinite(losses)):
                fail(f"{tag}: losses {losses}")
            for n, g in grads[0].items():
                if not torch.equal(g, grads[1][n]):
                    fail(f"{tag}: step 1 run twice, {n} differs")
            ref_cfg = dataclasses.replace(cfg, recurrence="stacked")
            ref_model = build_model(ref_cfg)
            ref_model.load_state_dict(init)
            ref = TrainStep(ref_cfg, ref_model, STEPS_PER_EPOCH, device=dev)
            ref.generator.manual_seed(5)
            before = counts()
            ref_loss = float(ref.loss_and_grads(batch))
            if counts() != before:
                fail("the stacked classification step launched a kernel")
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            l_err = norm_err(cls_logits(torch, cfg, init, batch),
                             cls_logits(torch, ref_cfg, init, batch))[0]
            if not l_err <= tol:
                fail(f"{tag}: logits vs stacked {l_err:.3e} > {tol:.0e}")
            errs = {n: norm_err(grads[0][n], p.grad)[0]
                    for n, p in ref.model.named_parameters()}
            name, err = max(errs.items(), key=lambda kv: kv[1])
            line = (f"train {tag}: losses "
                    f"{', '.join(f'{v:.6f}' for v in losses[1:])} "
                    f"(stacked {ref_loss:.6f}); logits vs stacked "
                    f"{l_err:.3e} (tol {tol:.0e}); step 1 twice: bitwise "
                    f"equal; step-1 grads vs stacked: worst {name} "
                    f"{err:.3e}")
            if dtype == "float32":
                if not err <= tol or abs(losses[0] - ref_loss) > \
                        tol * abs(ref_loss):
                    fail(f"{tag}: step-1 loss {losses[0]} vs {ref_loss}, "
                         f"gradient {name} {err:.3e} > {tol:.0e}")
                log(line + f" (tol {tol:.0e})")
                continue
            # bfloat16: the encoder's VJP under the scattered cotangent
            got = cls_encoder_grads(torch, cfg, init, batch)
            exact = cls_encoder_grads(torch, dataclasses.replace(
                cfg, recurrence="stacked", dtype="float32"), init, batch)
            v_errs = {n: norm_err(got[n], exact[n])[0] for n in exact}
            v_name, v_err = max(v_errs.items(), key=lambda kv: kv[1])
            if not np.isfinite(v_err) or v_err > BF16_TOL:
                fail(f"{tag}: encoder VJP {v_name} vs float32 stacked "
                     f"{v_err:.3e} > {BF16_TOL:.0e}")
            log(line + f" (not gated); encoder VJP under the last-step "
                f"cotangent vs float32 stacked: worst {v_name} {v_err:.3e} "
                f"(tol {BF16_TOL:.0e})")
    log(f"train classification: launches {launched}")
    return launched


def phase_cls_serve(torch, dev, out_dir):
    """``Predictor`` class probabilities with per-clip ``seq_lengths``
    (B=128 and a padded 37), both graphs and dtypes, against the stacked
    path (float32 atol 1e-4, bfloat16 2e-2); then the classifier exported
    as a reference ``.pth.tar`` and as a ``.npz``: ``from_checkpoint`` of
    each, bitwise equal probabilities. Returns the path's counts."""
    from eeg_gnn_tpu_torch.io import (
        export_classification_state,
        save_torch_checkpoint,
    )
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.serve import Predictor
    from eeg_gnn_tpu_torch.train.checkpoint import save_params

    requests = []
    for n in (BATCH, 37):
        b = cls_batch(torch, "cpu", n, seed=54 + n)
        requests.append((b["x"].numpy(), b["seq_lengths"].numpy(),
                         b["adjacency"].numpy()))
    batches = sum(-(-len(r[0]) // BATCH) for r in requests)
    want = {k: SERVE_BATCH[True].get(k, 0) * batches for k in KERNELS}
    reset_counts()
    for gt in ("combined", "individual"):
        for dtype in ("float32", "bfloat16"):
            cfg = cls_cfg(gt, dtype)
            params = build_model(
                cfg, torch.Generator().manual_seed(12)).state_dict()
            pred = Predictor(cfg, params)
            before = counts()
            probs = [pred.predict_proba(x, lens, adjacency=adj)
                     for x, lens, adj in requests]
            rose = {k: counts()[k] - before[k] for k in KERNELS}
            if rose != want:
                fail(f"serve classification {gt} {dtype}: launches {rose}, "
                     f"want {want}")
            plain = Predictor(dataclasses.replace(cfg, recurrence="stacked"),
                              params)
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            diff = 0.0
            for (x, lens, adj), p in zip(requests, probs):
                if p.shape != (len(x), CLS_CLASSES) or \
                        not np.all(np.isfinite(p)) or \
                        np.abs(p.sum(axis=1) - 1).max() > 1e-5:
                    fail(f"serve classification {gt} {dtype}: "
                         f"probabilities {p.shape}")
                ref = plain.predict_proba(x, lens, adjacency=adj)
                diff = max(diff, float(np.abs(p - ref).max()))
            if not diff <= tol:
                fail(f"serve classification {gt} {dtype}: |kernel - plain| "
                     f"{diff:.3e} > {tol:.0e}")
            log(f"serve classification {gt} {dtype}: "
                f"{sum(len(r[0]) for r in requests)} clips, lengths "
                f"{requests[0][1].min()}..{requests[0][1].max()}, launches "
                f"+{ {k: v for k, v in rose.items() if v} }, max |kernel - "
                f"plain| {diff:.3e} (tol {tol:.0e})")
            if (gt, dtype) == ("combined", "bfloat16"):
                pth = os.path.join(out_dir, "classifier.pth.tar")
                save_torch_checkpoint(pth, export_classification_state(
                    params))
                save_params(os.path.join(out_dir, "classifier"), params)
                x, lens, adj = requests[0]
                got = [Predictor.from_checkpoint(path, cfg).predict_proba(
                    x, lens, adjacency=adj) for path in
                    (pth, os.path.join(out_dir, "classifier.npz"))]
                if not np.array_equal(got[0], got[1]):
                    fail("serve classification: the .pth.tar's "
                         "probabilities differ from the .npz's")
                log(f"serve classification {gt} {dtype}: from_checkpoint "
                    f"of a .pth.tar and of a .npz of the same weights, "
                    f"{len(x)} clips: bitwise equal probabilities")
    launched = counts()
    log(f"serve classification: launches {launched}")
    return launched


def phase_cls_times(torch, dev, card):
    """The classification step's ms and clips/s (median of REPS
    synchronised steps; REPS back to back, best of 3) at B=128, bf16 and
    float32, combined, supports on the device; one traced bf16 step
    (device busy)."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    batch = cls_batch(torch, dev, BATCH, seed=52)
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = cls_cfg("combined", dtype, **TRAIN_KW)
        b = dict(batch, supports=compute_supports_torch(batch["adjacency"],
                                                        cfg.filter_type))
        del b["adjacency"]
        step = TrainStep(cfg, build_model(
            cfg, torch.Generator().manual_seed(11)), STEPS_PER_EPOCH,
            device=dev)
        ms, best, loss = time_steps(torch, lambda: step(b))
        if not np.isfinite(loss):
            fail(f"classification step {dtype}: loss {loss}")
        out[dtype] = (ms, best)
        line = (f"time classification train step combined {dtype} "
                f"B={BATCH}: {ms:.3f} ms/step (median of {REPS}, each "
                f"synchronised), {BATCH / ms * 1e3:.1f} clips/s; {REPS} "
                f"back to back: {best:.3f} ms/step, "
                f"{BATCH / best * 1e3:.1f} clips/s (best of 3)")
        if dtype == "bfloat16":
            busy, wall, rows, _ = trace(torch, lambda: step(b))
            line += (f"; traced: device busy {busy:.3f} of {wall:.3f} ms "
                     f"({100 * busy / wall:.1f}%)")
            out["busy"] = (busy, wall)
        log(line + f"; {card}")
    return out


def phase_cls_cli(torch, card, corpus):
    """``cli.train.main --task classification`` on phase_cli's corpus (its
    seizures: one clip each, 60 s at most, padded), at the recipe's widths,
    2 epochs, bf16, with --num_classes 4 --dropout 0.5 --data_augment
    --use_fft: streaming (combined), --hbm_cache (combined and
    individual), --hbm_cache rotating past --hbm_budget_gb, and
    --fine_tune from a reference .pth.tar of phase_cli's SSL run (its
    best.npz exported through ``save_torch_checkpoint``). Each run
    launches CLI_DETECT's kernels and no other. Returns (counts by path,
    figures)."""
    from eeg_gnn_tpu_torch.data.datasets import load_dataset_classification
    from eeg_gnn_tpu_torch.data.rotating_cache import rotating_geometry
    from eeg_gnn_tpu_torch.io import (
        export_next_time_pred_state,
        load_jax_npz,
        save_torch_checkpoint,
    )

    root, signals = corpus["root"], corpus["signals"]
    argv = [a if a != "detection" else "classification"
            for a in corpus["detect"]] + [
        "--num_classes", str(CLS_CLASSES), "--dropout", str(CLS_DROPOUT),
        "--data_augment", "--metric_name", "F1"]
    i = argv.index("--input_dir")
    sets = load_dataset_classification(
        input_dir=argv[i + 1], raw_data_dir=argv[argv.index(
            "--raw_data_dir") + 1], train_batch_size=CLI_BATCH,
        max_seq_len=T, use_fft=True, marker_dir=argv[argv.index(
            "--marker_dir") + 1], build_loaders=False, signals=signals,
        standardize=False)[1]
    n_train = len(sets["train"])
    lens = [int(sets["train"][j][2]) for j in range(n_train)]
    log(f"cli classification: {n_train} train / {len(sets['dev'])} dev / "
        f"{len(sets['test'])} test seizures, train lengths "
        f"{min(lens)}..{max(lens)} of {T}")
    clip_bytes = T * N * 100 * 2
    shards, rows = rotating_geometry(n_train, clip_bytes,
                                     int(CLS_ROTATING_GB * 2 ** 30))
    rot_steps = sum(-(-min(rows, n_train - s * rows) // CLI_BATCH)
                    for s in range(shards))
    ssl_cfg_path = os.path.join(corpus["ssl_dir"], "args.json")
    from eeg_gnn_tpu_torch.config import ExperimentConfig

    with open(ssl_cfg_path) as f:
        pre_cfg = ExperimentConfig(**json.load(f)).finalize()
    pth = os.path.join(root, "ssl_best.pth.tar")
    save_torch_checkpoint(pth, export_next_time_pred_state(
        load_jax_npz(os.path.join(corpus["ssl_dir"], "best.npz"), pre_cfg),
        SSL_LAYERS))
    runs = (("cli_cls", "classification", []),
            ("cli_cls_hbm", "classification hbm_cache", ["--hbm_cache"]),
            ("cli_cls_hbm_individual", "classification hbm_cache individual",
             ["--hbm_cache", "--graph_type", "individual"]),
            ("cli_cls_rotating", "classification hbm_cache rotating",
             ["--hbm_cache", "--hbm_budget_gb", str(CLS_ROTATING_GB)]),
            ("cli_cls_finetune", "classification fine-tune .pth.tar",
             ["--fine_tune", "--load_model_path", pth,
              "--pretrained_num_rnn_layers", str(SSL_LAYERS)]))
    paths, stats = {}, {}
    for path, tag, flags in runs:
        res, run_dir, paths[path], wall = _cli_run(
            torch, argv + flags, signals, root, CLI_DETECT, tag)
        stray = {k: v for k, v in paths[path].items()
                 if v and k not in CLI_DETECT}
        if stray:
            fail(f"cli {tag}: launched {stray} beside CLI_DETECT")
        steps = CLI_EPOCHS * (rot_steps if "rotating" in tag
                              else -(-n_train // CLI_BATCH))
        stats[tag] = cli_run_stats(tag, res, run_dir, wall, n_train, card,
                                   steps=steps)
        shutil.rmtree(run_dir)
    return paths, stats


def phase_classification(torch, dev, card, corpus):
    """Seizure-type classification on the card: the train step, Predictor
    and its .pth.tar checkpoints, the step's times, the CLI. Returns
    (counts by path, CLI figures)."""
    out_dir = os.path.join("chiprun_out", "classification")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    paths = {"train_cls": phase_cls_train(torch, dev),
             "serve_cls": phase_cls_serve(torch, dev, out_dir)}
    phase_cls_times(torch, dev, card)
    cli_paths, stats = phase_cls_cli(torch, card, corpus)
    paths.update(cli_paths)
    return paths, stats


# ---------------------------------------------------------------------------
# the baselines: LSTM, CNN-LSTM and Dense-CNN (torch built-ins: cuDNN,
# cuBLAS; no hand-written kernel)
# ---------------------------------------------------------------------------


def base_cfg(name):
    from eeg_gnn_tpu_torch.config import ExperimentConfig

    _, task, lr, epochs = next(b for b in BASELINES if b[0] == name)
    cls = task == "classification"
    return ExperimentConfig(
        model_name=name, task=task, max_seq_len=T, use_fft=True,
        rnn_units=H, num_rnn_layers=2, input_dim=100, do_train=True,
        num_classes=CLS_CLASSES if cls else 1,
        metric_name="F1" if cls else "auroc", lr_init=lr, l2_wd=5e-4,
        max_grad_norm=5.0, num_epochs=epochs).finalize()


def base_batch(name, b, seed):
    """A host batch of the family: featurized (b, T, 19, 100) clips and
    binary labels, or the Dense-CNN's flat (b, 6000, 19) clips and 4
    classes; seeded lengths, per-clip adjacency (which the baselines
    ignore)."""
    rng = np.random.RandomState(seed)
    shape = (b, T * 100, N) if name == "densecnn" else (b, T, N, 100)
    x = rng.randn(*shape).astype(np.float32)  # standardized features
    y = (rng.randint(0, CLS_CLASSES, size=b) if name == "densecnn"
         else rng.randint(0, 2, size=b).astype(np.float32))
    lens = rng.randint(1, T + 1, size=b).astype(np.int64)
    lens[0] = T
    return {"x": x, "y": y, "seq_lengths": lens,
            "adjacency": adjacency(rng, b)}


def fwd_flops(torch, model, x, lens) -> float:
    """The multiply-adds x 2 of one forward from the shapes it runs at:
    every Conv2d, Linear and LSTM (its input and hidden products)."""
    from torch import nn

    total, hooks = [0.0], []

    def conv(m, a, out):
        total[0] += 2.0 * out.numel() * m.in_channels * math.prod(
            m.kernel_size)

    def linear(m, a, out):
        total[0] += 2.0 * out.numel() * m.in_features

    def lstm(m, a, out):
        steps = out[0].shape[0] * out[0].shape[1]  # (seq x batch) rows
        h = m.hidden_size
        total[0] += sum(2.0 * steps * 4 * h * (
            (m.input_size if k == 0 else h) + h)
            for k in range(m.num_layers))

    for mod in model.modules():
        kind = {nn.Conv2d: conv, nn.Linear: linear, nn.LSTM: lstm}.get(
            type(mod))
        if kind is not None:
            hooks.append(mod.register_forward_hook(kind))
    training = model.training
    try:
        with torch.no_grad():
            model.eval()(x, lens, None)
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return total[0]


def base_gates(torch, dev, name):
    """Forward gate: eval mode at the serving batch, the card's logits
    against the same weights' on the CPU (<= F32_TOL). Gradient gate: the
    step-1 gradients of ``TrainStep`` (dropout 0) on the card against the
    CPU's (<= GRAD_TOL); the Dense-CNN's in float64 on both sides (its
    max-pools' gradients jump at near ties, which float32 rounding flips:
    its float32 card gradients against the float64 ones are printed
    beside). Returns the worst errors."""
    import copy

    from eeg_gnn_tpu_torch.models import densecnn
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    cfg = base_cfg(name)
    model = build_model(cfg, torch.Generator().manual_seed(21)).eval()
    b = base_batch(name, BASE_SERVE[name], seed=61)
    x, lens = torch.from_numpy(b["x"]), torch.from_numpy(b["seq_lengths"])
    with torch.no_grad():
        want = model(x, lens, None)
        got = copy.deepcopy(model).to(dev)(x.to(dev), lens.to(dev), None)
    fwd, fwd_abs = norm_err(got.cpu(), want)
    if not fwd <= F32_TOL:
        fail(f"baseline {name}: card forward {fwd:.3e} from the CPU's > "
             f"{F32_TOL:.0e}")

    gb = base_batch(name, BASE_GRAD_BATCH[name], seed=62)
    f64 = name == "densecnn"

    def grads(device, dtype):
        m = copy.deepcopy(model).to(dtype)
        step = TrainStep(cfg, m, STEPS_PER_EPOCH, device=device)
        loss = float(step.loss_and_grads(gb))
        return loss, {n: p.grad.detach().double().cpu()
                      for n, p in step.model.named_parameters()
                      if p.grad is not None}

    rate, densecnn.DROPOUT_RATE = densecnn.DROPOUT_RATE, 0.0
    try:
        dtype = torch.float64 if f64 else torch.float32
        loss_c, card = grads(dev, dtype)
        loss_h, host = grads("cpu", dtype)
        f32_card = grads(dev, torch.float32)[1] if f64 else None
    finally:
        densecnn.DROPOUT_RATE = rate
    errs, unreached = {}, 0
    for k, ref in host.items():
        if k == "dense_inception.fc1.bias":  # BatchNorm follows: 0 exactly
            scale = float(host[k[:-4] + "weight"].abs().max())
            if max(float(ref.abs().max()), float(card[k].abs().max())) > \
                    1e-9 * scale:
                fail(f"baseline {name}: fc1.bias gradient is not ~0")
            continue
        errs[k] = float((card[k] - ref).abs().max()
                        / max(float(ref.abs().max()), 1e-30))
    unreached = len(dict(model.named_parameters())) - len(host)
    worst = max(errs, key=errs.get)
    if card.keys() != host.keys() or not errs[worst] <= GRAD_TOL:
        fail(f"baseline {name}: card step-1 gradient {worst} "
             f"{errs[worst]:.3e} from the CPU's > {GRAD_TOL:.0e}")
    line = (f"baseline {name}: forward B={len(x)} card vs CPU {fwd:.3e} "
            f"(max abs {fwd_abs:.3e}, tol {F32_TOL:.0e}); step-1 gradients "
            f"B={len(gb['x'])} {'float64' if f64 else 'float32'} worst "
            f"{errs[worst]:.3e} ({worst}; tol {GRAD_TOL:.0e}), losses "
            f"{loss_c:.6f} / {loss_h:.6f}")
    if unreached:
        line += f"; {unreached} tensors the loss does not reach"
    if f64:
        band = {k: float((f32_card[k] - v).abs().max()
                         / max(float(v.abs().max()), 1e-30))
                for k, v in card.items() if k in errs}
        l2 = {k: float((f32_card[k] - v).norm() / max(float(v.norm()),
                                                      1e-30))
              for k, v in card.items() if k in errs}
        line += (f"; the card's float32 gradients against its float64 "
                 f"ones: worst {max(band.values()):.3e} inf-norm, "
                 f"{max(l2.values()):.3e} L2 (pool-tie flips; no gate)")
    log(line)
    return fwd, errs[worst]


def base_times(torch, dev, card, name, out_dir):
    """The train step at B=40 (median of reps synchronised, best of 3 back
    to back; the Dense-CNN also under cuDNN TF32, torch's default), one
    traced step, achieved FLOP/s; Predictor clips/s at the serving batch;
    ``.pth.tar`` and ``.npz`` (+ ``.state.npz``) of the trained weights
    served bitwise equal. Returns the figures."""
    from eeg_gnn_tpu_torch.io import save_torch_checkpoint
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.serve import Predictor
    from eeg_gnn_tpu_torch.train import TrainStep
    from eeg_gnn_tpu_torch.train.checkpoint import CheckpointSaver

    cfg = base_cfg(name)
    model = build_model(cfg, torch.Generator().manual_seed(22))
    hb = base_batch(name, CLI_BATCH, seed=63)
    b = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()
         if k != "adjacency"}
    step = TrainStep(cfg, model, STEPS_PER_EPOCH, device=dev)
    # one clip's forward (the CNN-LSTM's LSTM rows scale with B as well)
    flops = 3.0 * CLI_BATCH * fwd_flops(torch, step.model, b["x"][:1],
                                        b["seq_lengths"][:1])
    reps = BASE_REPS[name]
    out = {"flops": flops}
    settings = [("float32", False)] + ([("TF32", True)]
                                       if name == "densecnn" else [])
    for tag, tf32 in settings:
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            ms, best, loss = time_steps(torch, lambda: step(b), reps)
            busy, wall, _, _ = trace(torch, lambda: step(b))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        if not np.isfinite(loss):
            fail(f"baseline {name} step {tag}: loss {loss}")
        out[tag] = (ms, best, busy, wall)
        log(f"time baseline {name} train step {tag} B={CLI_BATCH}: {ms:.3f} "
            f"ms/step (median of {reps}, each synchronised), "
            f"{CLI_BATCH / ms * 1e3:.1f} clips/s; {reps} back to back: "
            f"{best:.3f} ms/step, {CLI_BATCH / best * 1e3:.1f} clips/s "
            f"(best of 3); {flops / 1e9:.1f} GFLOP a step (3 x forward), "
            f"{flops / best / 1e9:.1f} TFLOP/s; traced: device busy "
            f"{busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.1f}%); {card}")

    bs = BASE_SERVE[name]
    req = base_batch(name, bs * (8 if name == "densecnn" else 2), seed=64)
    pred = Predictor(cfg, step.model.state_dict(), batch_size=bs, device=dev)
    serve = lambda p: p.predict_proba(req["x"], req["seq_lengths"],
                                      adjacency=req["adjacency"])
    probs = serve(pred)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        serve(pred)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    n = len(req["x"])
    if not (np.all(np.isfinite(probs)) and probs.shape[0] == n):
        fail(f"baseline {name}: probabilities {probs.shape}")
    out["serve"] = (n / wall, wall)
    log(f"time baseline {name} Predictor B={bs}: {n} clips in "
        f"{wall * 1e3:.3f} ms (median of 5, host numpy in and out), "
        f"{n / wall:.1f} clips/s; {card}")

    sd = step.model.state_dict()
    pth = os.path.join(out_dir, f"{name}.pth.tar")
    save_torch_checkpoint(pth, sd)
    run = os.path.join(out_dir, name)
    CheckpointSaver(run, cfg.metric_name, True).save(1, sd, step.optimizer,
                                                     0.5)
    got = [serve(Predictor.from_checkpoint(path, cfg, batch_size=bs,
                                           device=dev))
           for path in (pth, os.path.join(run, "best.npz"))]
    if not (np.array_equal(got[0], got[1]) and np.array_equal(got[0],
                                                              probs)):
        fail(f"baseline {name}: from_checkpoint of the .pth.tar and the "
             ".npz serve other probabilities")
    log(f"baseline {name}: from_checkpoint of a .pth.tar and of a .npz"
        + (" + .state.npz" if name == "densecnn" else "")
        + f" of the trained weights, {n} clips: bitwise equal to the "
        "Predictor's")
    os.remove(pth)  # the Dense-CNN's files (with Adam's) are ~300 MB
    shutil.rmtree(run)
    return out


def phase_baselines(torch, dev, card, corpus):
    """The LSTM, CNN-LSTM and Dense-CNN at the recipes' widths (T=60,
    N=19, D=100; the Dense-CNN on (6000, 19)): gates, step and serving
    times, checkpoints (``base_gates``, ``base_times``), then
    ``cli.train.main`` for 2 epochs each on phase_cli's corpus (LSTM and
    CNN-LSTM detection, the Dense-CNN's 4-class classification on the
    flat-clip dataset). Every hand-written kernel's count stays 0 through
    the phase. Returns the counts."""
    from eeg_gnn_tpu_torch.data.datasets import (
        load_dataset_densecnn_classification,
    )

    out_dir = os.path.join("chiprun_out", "baselines")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    reset_counts()
    times = {}
    for name, _, _, _ in BASELINES:
        base_gates(torch, dev, name)
        times[name] = base_times(torch, dev, card, name, out_dir)

    root, signals = corpus["root"], corpus["signals"]
    flag = lambda k: corpus["detect"][corpus["detect"].index(k) + 1]
    n_dc = len(load_dataset_densecnn_classification(
        input_dir=flag("--input_dir"), raw_data_dir=flag("--raw_data_dir"),
        train_batch_size=CLI_BATCH, max_seq_len=T,
        marker_dir=flag("--marker_dir"), standardize=False,
        build_loaders=False, signals=signals)[1]["train"])
    for name, task, lr, _ in BASELINES:
        argv = [a if a != "detection" else task for a in corpus["detect"]]
        argv += ["--model_name", name, "--lr_init", str(lr),
                 "--data_augment"]
        n_train = corpus["n_train"]["detection"]
        if task == "classification":
            argv += ["--num_classes", str(CLS_CLASSES), "--metric_name",
                     "F1", "--test_batch_size", str(BASE_SERVE[name])]
            n_train = n_dc
        tag = f"baseline {name} {task}"
        res, run_dir, launched, wall = _cli_run(torch, argv, signals, root,
                                                (), tag)
        if any(launched.values()):
            fail(f"cli {tag}: launched {launched}")
        st = cli_run_stats(tag, res, run_dir, wall, n_train, card)
        ms = times[name]["float32"][0]
        clips, secs = sum(st["train_clips"]), sum(st["train_s"])
        wait, ep = sum(st["loader_wait_s"]), sum(st["epoch_s"])
        log(f"cli {tag}: train loop {clips / secs:.1f} clips/s over "
            f"{CLI_EPOCHS} epochs beside its TrainStep's "
            f"{CLI_BATCH / ms * 1e3:.1f} at B={CLI_BATCH} (float32); loader "
            f"wait {100 * wait / ep:.1f}% of the epochs' {ep:.3f} s; {card}")
        shutil.rmtree(run_dir)
    launched = counts()
    if any(launched.values()):
        fail(f"baselines: hand-written kernels launched {launched}")
    log(f"baselines: no hand-written kernel launched in the phase; "
        f"{time.perf_counter() - t0:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# data-parallel scale-out (parallel/): one NCCL rank in this process, then
# two gloo ranks sharing the card, each a process running this script
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scale_start(torch, dtype):
    """(config, initial state_dict) of the flagship detector at bench.py's
    recipe, from seeded weights (the same in every process)."""
    from eeg_gnn_tpu_torch.models.registry import build_model

    cfg = flagship_cfg("combined", dtype, True, **TRAIN_KW)
    model = build_model(cfg, torch.Generator().manual_seed(11))
    return cfg, {k: v.clone() for k, v in model.state_dict().items()}


def scale_step(torch, cfg, init, **kw):
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    model = build_model(cfg)
    model.load_state_dict(init)
    return TrainStep(cfg, model, STEPS_PER_EPOCH, **kw)


def scale_batch(torch, dev, rows=slice(None)):
    """Rows ``rows`` of the global flagship batch (B=128, seed 23) on
    ``dev``: every process draws the whole and keeps its rows."""
    full = train_batch(torch, torch.device("cpu"), BATCH, seed=23)
    return {k: v[rows].to(dev) for k, v in full.items()}


def scale_launches(torch, step, batch, tag):
    """``SCALE_STEPS`` steps of ``step``, each launching exactly
    ``TRAIN_STEP[True]`` and one gradient all-reduce; returns (the
    launches over the steps, the last loss)."""
    from eeg_gnn_tpu_torch.parallel import distributed

    reset_counts()
    distributed.reset_counts()
    for i in range(SCALE_STEPS):
        before = counts()
        loss = float(step(batch))
        rose = {k: counts()[k] - before[k] for k in KERNELS}
        want = {k: TRAIN_STEP[True].get(k, 0) for k in KERNELS}
        if rose != want:
            fail(f"{tag} step {i}: launches rose by {rose}, want {want}")
    calls = distributed.counts()["all_reduce_grads"][0]
    if calls != SCALE_STEPS or not np.isfinite(loss):
        fail(f"{tag}: {calls} gradient all-reduces in {SCALE_STEPS} steps, "
             f"last loss {loss}")
    return counts(), loss


def scale_state(step) -> dict:
    return {k: v.detach().float().cpu().numpy()
            for k, v in step.model.state_dict().items()}


def allreduce_ms(torch, step, mesh, host: bool) -> float:
    """Median ms of the step's gradient all-reduce alone over 20 calls on
    its gradients: CUDA events (NCCL), or the host clock around the call
    and a synchronise (gloo goes through the host). Every rank runs the
    same calls."""
    from eeg_gnn_tpu_torch.parallel import distributed

    grads = [p.grad for p in step.model.parameters()]
    if not host:
        return time_ms(torch, lambda: distributed.all_reduce_grads(grads,
                                                                   mesh))
    times = []
    for _ in range(3 + REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        distributed.all_reduce_grads(grads, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[3:])


def scale_one_rank(torch, dev, card, out_dir):
    """(a): one NCCL rank on the card. The flagship detection step through
    the mesh path (bf16, then f32), 3 steps, against ``TrainStep`` without
    a mesh from the same weights: bitwise equal parameters. Returns (the
    mesh runs' launches, {dtype: final state}, timing figures)."""
    from eeg_gnn_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                           device=dev)
    try:
        mesh = make_mesh("data:-1")
        if mesh.backend != "nccl":
            fail(f"scaleout (a): backend {mesh.backend}, want nccl")
        batch = scale_batch(torch, dev)
        launched, finals, figures = {k: 0 for k in KERNELS}, {}, {}
        for dtype in ("bfloat16", "float32"):
            cfg, init = scale_start(torch, dtype)
            meshed = scale_step(torch, cfg, init, mesh=mesh)
            n, loss = scale_launches(torch, meshed, batch,
                                     f"scaleout (a) {dtype}")
            launched = {k: launched[k] + n[k] for k in KERNELS}
            plain = scale_step(torch, cfg, init, device=dev)
            for _ in range(SCALE_STEPS):
                plain(batch)
            finals[dtype] = scale_state(meshed)
            want = scale_state(plain)
            same = [k for k in want
                    if not np.array_equal(finals[dtype][k], want[k])]
            if same:
                fail(f"scaleout (a) {dtype}: {same} differ from TrainStep "
                     "without a mesh")
            log(f"scaleout (a) one NCCL rank, {dtype}: {SCALE_STEPS} steps "
                f"at B={BATCH}, last loss {loss:.6f}; launches per step "
                f"{TRAIN_STEP[True]}, 1 gradient all-reduce a step; "
                "parameters bitwise equal to TrainStep without a mesh")
            if dtype == "bfloat16":
                ms, best, _ = time_steps(torch, lambda: meshed(batch))
                nbytes = distributed.counts()["all_reduce_grads"][1]
                calls = distributed.counts()["all_reduce_grads"][0]
                ar = allreduce_ms(torch, meshed, mesh, host=False)
                figures = {"step_ms": ms, "best_ms": best,
                           "allreduce_ms": ar,
                           "allreduce_bytes": nbytes // calls}
                log(f"time scaleout one NCCL rank: bf16 step {ms:.3f} ms "
                    f"(back to back {best:.3f}) at B={BATCH}; gradient "
                    f"all-reduce {ar:.4f} ms, {nbytes // calls} B a step "
                    f"(CUDA events, NCCL, one rank); {card}")
        return launched, finals, figures
    finally:
        distributed.shutdown()


def scale_rank(rank: int, port: str, out_dir: str):
    """A rank of (b)-(d), run as ``chip_smoke.py --scaleout-rank RANK
    PORT DIR`` by ``phase_scaleout``: two gloo ranks share card 0. Writes
    its figures and final states under ``out_dir``."""
    import torch

    from eeg_gnn_tpu_torch.cli import train as cli
    from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus
    from eeg_gnn_tpu_torch.parallel import distributed, make_mesh
    from eeg_gnn_tpu_torch.serve import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    distributed.initialize(f"tcp://127.0.0.1:{port}", SCALE_RANKS, rank,
                           local_world_size=SCALE_RANKS, device=dev)
    mesh = make_mesh("data:-1")
    res = {"backend": mesh.backend, "paths": {}}
    batch = scale_batch(torch, dev, mesh.rows(BATCH))
    # (b) the flagship step, f32 then bf16, 64 rows a rank
    for dtype in ("float32", "bfloat16"):
        cfg, init = scale_start(torch, dtype)
        step = scale_step(torch, cfg, init, mesh=mesh)
        n, loss = scale_launches(torch, step, batch,
                                 f"scaleout (b) rank {rank} {dtype}")
        res["paths"][f"scaleout_gloo_{dtype}"] = n
        np.savez(os.path.join(out_dir, f"rank{rank}_{dtype}.npz"),
                 **scale_state(step))
        res[f"loss_{dtype}"] = loss
        if dtype == "bfloat16":
            ms, best, _ = time_steps(torch, lambda: step(batch))
            nbytes, calls = distributed.counts()["all_reduce_grads"][1::-1]
            res["step_ms"], res["best_ms"] = ms, best
            res["allreduce_ms"] = allreduce_ms(torch, step, mesh, host=True)
            res["allreduce_bytes"] = nbytes // calls
    # (c) Predictor(mesh=) at batch 128 on 200 clips (the last chunk
    # padded), f32, against a single Predictor on this rank's card
    cfg, init = scale_start(torch, "float32")
    rng = np.random.RandomState(29)
    x = rng.randn(200, T, N, 100).astype(np.float32)
    adj = adjacency(rng, 200)
    reset_counts()
    probs = Predictor(cfg, init, batch_size=BATCH, mesh=mesh).predict_proba(
        x, adjacency=adj)
    res["paths"]["scaleout_gloo_serve"] = counts()
    single = Predictor(cfg, init, batch_size=BATCH, device=dev).predict_proba(
        x, adjacency=adj)
    res["serve_err"] = float(np.abs(probs - single).max())
    np.save(os.path.join(out_dir, f"rank{rank}_probs.npy"), probs)
    # (d) the CLI, 2 epochs: streaming at the recipe's lr, and --hbm_cache
    # at SCALE_CLI_LR, on phase_cli's corpus (made again here, in memory)
    signals = {}
    root = os.path.join(out_dir, f"corpus{rank}")
    p = make_synthetic_corpus(root, signals=signals, **CLI_CORPUS)
    argv = scale_cli_argv(p)
    for tag, extra in SCALE_CLI.items():
        reset_counts()
        out = cli.main(argv + extra + ["--save_dir",
                                       os.path.join(out_dir, "cli_" + tag)],
                       signals=signals)
        res["paths"][f"scaleout_gloo_cli_{tag}"] = counts()
        res[f"cli_{tag}"] = {k: float(v) for k, v in out.items()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.shutdown()


def scale_cli_argv(p) -> list:
    """phase_cli's detection run on the corpus ``p``."""
    return ["--input_dir", p["input_dir"], "--raw_data_dir",
            p["raw_data_dir"], "--marker_dir", p["marker_dir"],
            "--adj_mat_dir", p["adj_mat_dir"], "--do_train", "--graph_type",
            "combined", "--use_fft", "--max_seq_len", str(T), "--rnn_units",
            str(H), "--max_diffusion_step", str(K), "--train_batch_size",
            str(CLI_BATCH), "--test_batch_size", str(BATCH), "--num_epochs",
            str(CLI_EPOCHS), "--dtype", "bfloat16", "--task", "detection",
            "--num_rnn_layers", "2"]


def phase_scaleout(torch, dev, card, corpus):
    """Data-parallel scale-out (``eeg_gnn_tpu_torch/parallel``): (a) one
    NCCL rank in this process; (b)-(d) two gloo ranks sharing the card,
    each a process of this script (the kernels built above, so no rank
    runs nvcc): (b) the flagship step's global B=128 split 64 a rank, f32
    and bf16, against (a)'s parameters and each rank's launches against
    ``TRAIN_STEP``; (c) ``Predictor(mesh=)`` against a single Predictor;
    (d) the CLI on two ranks against one, on phase_cli's corpus. Returns
    the launches by path."""
    from eeg_gnn_tpu_torch.cli import train as cli

    out_dir = os.path.join(os.path.dirname(corpus["root"]), "scaleout")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    for name in ("NCCL_SOCKET_IFNAME", "GLOO_SOCKET_IFNAME"):
        os.environ.setdefault(name, "lo")  # this host only
    paths = {}
    paths["scaleout_nccl"], finals, one = scale_one_rank(torch, dev, card,
                                                         out_dir)
    # the one-rank runs that (d)'s two ranks are held against
    single = {tag: cli.main(corpus["detect"] + extra + [
        "--save_dir", os.path.join(out_dir, "cli_single_" + tag)],
        signals=corpus["signals"]) for tag, extra in SCALE_CLI.items()}
    port = str(_free_port())
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(SCALE_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--scaleout-rank",
         str(r), port, out_dir], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(SCALE_RANKS)]
    t1 = time.perf_counter()
    try:
        for r, proc in enumerate(procs):
            left = SCALE_TIMEOUT - (time.perf_counter() - t1)
            try:
                proc.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                fail(f"scaleout: rank {r} ran past {SCALE_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            fail(f"scaleout: rank {r} exited {proc.returncode}:\n{tail}")
    ranks = []
    for r in range(SCALE_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if any(rk["backend"] != "gloo" for rk in ranks):
        fail(f"scaleout: backends {[rk['backend'] for rk in ranks]}")
    # (b) both ranks' states bitwise equal; each against (a)'s
    for dtype, tol in (("float32", SCALE_F32_TOL), ("bfloat16", BF16_TOL)):
        states = [dict(np.load(os.path.join(out_dir,
                                            f"rank{r}_{dtype}.npz")))
                  for r in range(SCALE_RANKS)]
        diff = [k for k in states[0]
                if not np.array_equal(states[0][k], states[1][k])]
        if diff:
            fail(f"scaleout (b) {dtype}: ranks differ in {diff}")
        # the normalized inf-norm of the parameter vector; each tensor's
        # beside it (a bias that starts at 0 has moved by ~3 lr, so Adam's
        # lr * g / |g| turns rounding of its near-zero gradients into
        # differences of that size)
        err = norm_err(*(torch.from_numpy(np.concatenate(
            [st[k].ravel() for k in finals[dtype]]))
            for st in (states[0], finals[dtype])))[0]
        errs = {k: norm_err(torch.from_numpy(states[0][k]),
                            torch.from_numpy(v))[0]
                for k, v in finals[dtype].items() if v.size}
        name, worst = max(errs.items(), key=lambda kv: kv[1])
        log(f"scaleout (b) two gloo ranks on one card, {dtype}: "
            f"{SCALE_STEPS} steps at global B={BATCH} ({BATCH // 2} a "
            f"rank), each rank's launches TRAIN_STEP's a step; ranks "
            f"bitwise equal; parameters against (a)'s: {err:.3e} (bar "
            f"{tol:.0e}, normalized inf-norm of the parameters); per "
            f"tensor, worst {name} {worst:.3e} (not gated)")
        if not err <= tol:
            fail(f"scaleout (b) {dtype}: parameters {err} from (a)'s > "
                 f"{tol}")
    # (c) the same probabilities on both ranks, against a single Predictor
    probs = [np.load(os.path.join(out_dir, f"rank{r}_probs.npy"))
             for r in range(SCALE_RANKS)]
    worst = max(rk["serve_err"] for rk in ranks)
    log(f"scaleout (c) Predictor(mesh=) on two ranks, f32, 200 clips at "
        f"batch {BATCH}: ranks equal {np.array_equal(*probs)}, against a "
        f"single Predictor {worst:.3e} (bar 1e-5)")
    if not (np.array_equal(*probs) and worst <= 1e-5):
        fail(f"scaleout (c): ranks equal {np.array_equal(*probs)}, "
             f"error {worst}")
    # (d) the CLI: the ranks' metrics equal, and close to one rank's
    for tag in SCALE_CLI:
        got = [rk[f"cli_{tag}"] for rk in ranks]
        want = single[tag]
        log(f"scaleout (d) cli {tag} on two ranks: "
            + ", ".join(f"{k} {v:.6f}" for k, v in got[0].items())
            + "; one rank: "
            + ", ".join(f"{k} {float(v):.6f}" for k, v in want.items()))
        for k, v in got[0].items():
            if not abs(got[1][k] - v) <= 1e-6 * abs(v):
                fail(f"scaleout (d) {tag}: ranks' {k} {v} / {got[1][k]}")
        if not (abs(got[0]["loss"] - want["loss"])
                <= 2e-3 + 2e-3 * abs(want["loss"])
                and abs(got[0]["acc"] - want["acc"]) <= 1e-6
                and abs(got[0]["auroc"] - want["auroc"]) <= 5e-3):
            fail(f"scaleout (d) {tag}: {got[0]} against one rank's {want}")
    rk = ranks[0]
    log(f"time scaleout two gloo ranks on one card: bf16 step "
        f"{rk['step_ms']:.3f} ms a rank (back to back {rk['best_ms']:.3f}) "
        f"at {BATCH // 2} rows a rank, global B={BATCH}; gradient "
        f"all-reduce {rk['allreduce_ms']:.4f} ms through the host (gloo, "
        f"host clock), {rk['allreduce_bytes']} B a step; one NCCL rank: "
        f"step {one['step_ms']:.3f} ms, all-reduce {one['allreduce_ms']:.4f}"
        f" ms; {card}")
    for r, rk in enumerate(ranks):
        for path, n in rk["paths"].items():
            key = path if r == 0 else f"{path}_rank{r}"
            paths[key] = {k: n.get(k, 0) for k in KERNELS}
    log(f"scaleout: {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# the mesh's graph axis (parallel/edge_partition, parallel/sparse_model):
# one NCCL rank in this process, then two gloo ranks sharing the card, each
# a process running this script
# ---------------------------------------------------------------------------


def ring_graph(torch):
    """The ring SpMM's seeded graph (RING_N nodes, 4 * RING_N edges) and
    features on the host: every process draws the same."""
    from eeg_gnn_tpu_torch.graphs.sparse import SparseGraph

    rng = np.random.RandomState(41)
    e = 4 * RING_N
    g = SparseGraph(
        torch.from_numpy(rng.randint(0, RING_N, e).astype(np.int32)),
        torch.from_numpy(rng.randint(0, RING_N, e).astype(np.int32)),
        torch.from_numpy(rng.randn(e).astype(np.float32)), RING_N)
    return g, torch.from_numpy(rng.randn(RING_N, RING_D).astype(np.float32))


def sparse_start(torch):
    """(model, optimizer): the detector at full width (2 DCGRU layers x 64,
    K=2, D=100) from seeded weights, the same in every process, and
    bench.py's optimizer recipe."""
    from eeg_gnn_tpu_torch.models.dcrnn import DCRNNClassifier, DCRNNConfig
    from eeg_gnn_tpu_torch.train.optim import make_optimizer

    model = DCRNNClassifier(DCRNNConfig(
        input_dim=100, rnn_units=H, num_rnn_layers=2, max_diffusion_step=K,
        num_nodes=N, num_supports=1, num_classes=1, recurrence="stacked"),
        torch.Generator().manual_seed(13))
    return model, make_optimizer(model.parameters(),
                                 steps_per_epoch=STEPS_PER_EPOCH, **TRAIN_KW)


def sparse_inputs(torch, dev):
    """The full-width batch (seed 43): time-major clips (T, B, N, 100) and
    labels on ``dev``, one laplacian support a clip (1, B, N, N) built on
    the host (the same in every process) and put on ``dev``, and the
    block-diagonal graph of the supports over B*N nodes, on the host."""
    from eeg_gnn_tpu_torch.graphs.sparse import from_dense_batch
    from eeg_gnn_tpu_torch.graphs.supports import compute_supports_torch

    rng = np.random.RandomState(43)
    x = torch.from_numpy(rng.randn(T, BATCH, N, 100).astype(np.float32))
    y = torch.from_numpy((rng.rand(BATCH) > 0.5).astype(np.float32))
    sup = compute_supports_torch(torch.from_numpy(adjacency(rng, BATCH)),
                                 "laplacian")
    return x.to(dev), y.to(dev), sup.to(dev), from_dense_batch(sup[0])


def host_ms(torch, fn, reps=REPS, warmup=3) -> float:
    """Median ms of ``fn`` by the host clock around it and a synchronise
    (a gloo exchange goes through the host)."""
    times = []
    for _ in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[warmup:])


def sparse_steps(torch, step, sgraph, x_seq, y):
    """``GRAPH_STEPS`` steps of a ``SparseTrainStep``: (losses, the first
    step's gradients as one numpy vector, each step's ms by the host clock
    around it and a synchronise, the gradients' copy out excluded)."""
    losses, ms = [], []
    for i in range(GRAPH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step.loss_and_grads(sgraph, x_seq, y)))
        t1 = time.perf_counter()
        if i == 0:
            grads = torch.cat([p.grad.reshape(-1) for p in
                               step.model.parameters()]).cpu().numpy()
        t2 = time.perf_counter()
        step.optimizer.step()
        torch.cuda.synchronize()
        ms.append((t1 - t0 + time.perf_counter() - t2) * 1e3)
    return losses, grads, ms


def graph_one_rank(torch, dev, card, out_dir):
    """(a): graph:1 on one NCCL rank in this process. The ring SpMM at
    N=4096 against the dense product; the sparse encoder at full width
    against the dense (stacked) encoder on the same supports; a sparse
    step's gradients against the dense path's; 3 steps (their parameters
    for (b)); every kernel count 0 through all of it. Then, outside the
    counted window, the times (ring, sparse forward and step, the dense
    steps) and ``entry()``'s forward on the card against the CPU. Returns
    (launches on the graph path, launches of the entry's forward,
    figures)."""
    from eeg_gnn_tpu_torch import entry as port_entry
    from eeg_gnn_tpu_torch.models.dcgru import encoder_apply
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.parallel import distributed, make_mesh
    from eeg_gnn_tpu_torch.parallel.edge_partition import (
        edge_partitioned_spmm,
        partition_by_dest,
        place_edge_partitioned,
        shard_edges,
    )
    from eeg_gnn_tpu_torch.parallel.sparse_model import (
        make_sparse_train_step,
        sparse_encoder_apply,
    )
    from eeg_gnn_tpu_torch.train import TrainStep
    from eeg_gnn_tpu_torch.train.losses import bce_with_logits

    distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                           device=dev)
    try:
        mesh = make_mesh("graph:1")
        if mesh.backend != "nccl":
            fail(f"graph axis (a): backend {mesh.backend}, want nccl")
        reset_counts()
        distributed.reset_counts()
        # the ring SpMM against the dense product (TF32 off)
        g, x = ring_graph(torch)
        shard, xb = place_edge_partitioned(mesh, g, x)
        dense = g.to_dense().to(dev)
        with torch.no_grad():
            out = edge_partitioned_spmm(mesh, shard, xb)
            ref = dense @ x.to(dev)
        ring_err = float((out - ref).abs().max())
        log(f"graph axis (a) ring SpMM, one NCCL rank: N={RING_N}, "
            f"D={RING_D}, E={4 * RING_N}, f32: max |ring - dense| "
            f"{ring_err:.3e} (bar rtol and atol {RING_TOL:.0e})")
        if not torch.allclose(out, ref, rtol=RING_TOL, atol=RING_TOL):
            fail(f"graph axis (a): ring SpMM {ring_err} from the dense "
                 "product")
        np.save(os.path.join(out_dir, "ring_one_rank.npy"), out.cpu().numpy())
        # the sparse encoder at full width against the dense one
        x_seq, y, sup, block_diag = sparse_inputs(torch, dev)
        sgraph = shard_edges(partition_by_dest(block_diag, 1), 0, dev)
        model, opt = sparse_start(torch)
        model.to(dev)
        params = [c.params() for c in model.encoder]
        with torch.no_grad():
            got = sparse_encoder_apply(model.cell_cfgs, params, mesh, sgraph,
                                       x_seq)
            want = encoder_apply(model.cell_cfgs, params, sup, x_seq)
        enc_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        log(f"graph axis (a) sparse encoder, B*N={BATCH * N} nodes "
            f"({sgraph.values.numel()} edges), T={T}, 2 layers x {H}, "
            f"K={K}, D=100: max |sparse - dense (stacked)| {enc_err:.3e} "
            f"(bar rtol {ENC_RTOL:.0e}, atol {ENC_ATOL:.0e})")
        if not all(torch.allclose(a, b, rtol=ENC_RTOL, atol=ENC_ATOL)
                   for a, b in zip(got, want)):
            fail(f"graph axis (a): sparse encoder {enc_err} from dense")
        # one sparse step's gradients against the dense path's
        step = make_sparse_train_step(model, opt, mesh)
        step.loss_and_grads(sgraph, x_seq, y)
        sparse_g = {k: p.grad.clone() for k, p in model.named_parameters()}
        model.zero_grad()
        lengths = torch.full((BATCH,), T, dtype=torch.int64, device=dev)
        bce_with_logits(model(x_seq.transpose(0, 1), lengths, sup),
                        y).backward()
        bad, worst = [], 0.0
        for k, p in model.named_parameters():
            worst = max(worst, float((sparse_g[k] - p.grad).abs().max()))
            if not torch.allclose(sparse_g[k], p.grad, rtol=GRAD_RTOL,
                                  atol=GRAD_ATOL):
                bad.append(k)
        log(f"graph axis (a) sparse step gradients against the dense path's:"
            f" max abs diff {worst:.3e} (bar rtol {GRAD_RTOL:.0e}, atol "
            f"{GRAD_ATOL:.0e})")
        if bad:
            fail(f"graph axis (a): gradients {bad} differ from the dense "
                 "path's")
        # GRAPH_STEPS steps from the start, twice: (b)'s reference, and
        # one rank's own spread from run to run
        finals, grads = [], []
        for run in range(2):
            model, opt = sparse_start(torch)
            step = make_sparse_train_step(model, opt, mesh)
            losses, g1, _ = sparse_steps(torch, step, sgraph, x_seq, y)
            finals.append(scale_state(step))
            grads.append(g1)
        np.savez(os.path.join(out_dir, "one_rank.npz"), **finals[0])
        np.save(os.path.join(out_dir, "one_rank_grads.npy"), grads[0])
        launched = counts()
        spread = norm_err(*(torch.from_numpy(np.concatenate(
            [f[k].ravel() for k in finals[0]])) for f in finals))[0]
        g_spread = norm_err(*map(torch.from_numpy, grads))[0]
        log(f"graph axis (a) {GRAPH_STEPS} sparse steps at full width, "
            f"twice: losses {losses}; the two runs' first-step gradients "
            f"{g_spread:.3e} apart, parameters after the steps "
            f"{spread:.3e} (normalized inf-norms; CUDA index_add_ sums "
            f"with atomics); kernel launches on the path {launched}; "
            f"collectives {distributed.counts()}")
        # times, outside the counted window
        figures = {"ring_err": ring_err, "enc_err": enc_err,
                   "grad_err": worst}
        with torch.no_grad():
            figures["ring_ms"] = time_ms(
                torch, lambda: edge_partitioned_spmm(mesh, shard, xb))
            csr, xd = dense.to_sparse_csr(), x.to(dev)
            figures["csr_ms"] = time_ms(torch,
                                        lambda: torch.sparse.mm(csr, xd))
            figures["fwd_ms"] = time_ms(torch, lambda: sparse_encoder_apply(
                model.cell_cfgs, [c.params() for c in model.encoder], mesh,
                sgraph, x_seq), warmup=2, lead=False)
        figures["step_ms"] = time_ms(torch, lambda: step(sgraph, x_seq, y),
                                     warmup=2, lead=False)
        profile_batch(torch, lambda: step(sgraph, x_seq, y),
                      "graph axis sparse step (one NCCL rank)",
                      figures["step_ms"])
        batch = {"x": x_seq.transpose(0, 1).contiguous(), "y": y,
                 "seq_lengths": lengths,
                 "supports": sup}
        for tag, kw in (("stacked", dict(recurrence="stacked")),
                        ("kernels", {})):
            cfg = flagship_cfg("combined", "float32", True, **TRAIN_KW, **kw)
            dstep = TrainStep(cfg, build_model(cfg, torch.Generator()
                                               .manual_seed(13)),
                              STEPS_PER_EPOCH, device=dev)
            figures[f"dense_{tag}_ms"] = time_ms(
                torch, lambda: dstep(batch), warmup=2, lead=False)
        log(f"time graph axis (a) one NCCL rank: ring SpMM N={RING_N} "
            f"D={RING_D} {figures['ring_ms']:.4f} ms (torch.sparse.mm on "
            f"CSR {figures['csr_ms']:.4f}); sparse encoder forward at "
            f"B={BATCH} {figures['fwd_ms']:.3f} ms; sparse step "
            f"{figures['step_ms']:.3f} ms beside the dense step "
            f"{figures['dense_stacked_ms']:.3f} (stacked, the same math) "
            f"and {figures['dense_kernels_ms']:.3f} (the x-in kernels), f32, "
            f"median of {REPS}; {card}")
        # entry(): its forward on the card against the CPU, the same inputs
        fn, (params_c, *args) = port_entry.entry("cpu")
        want = fn(params_c, *args)
        reset_counts()
        fn_d, _ = port_entry.entry(dev)
        got = fn_d({k: v.to(dev) for k, v in params_c.items()},
                   *(a.to(dev) for a in args))
        torch.cuda.synchronize()
        entry_launched = counts()
        err = norm_err(got.cpu(), want)[0]
        log(f"graph axis entry(): forward {tuple(got.shape)} on the card "
            f"against the CPU {err:.3e} (normalized; bar {F32_TOL:.0e})")
        if not err <= F32_TOL:
            fail(f"entry(): card forward {err} from the CPU's")
        return launched, entry_launched, figures
    finally:
        distributed.shutdown()


def graph_rank(rank: int, port: str, out_dir: str):
    """A rank of (b), run as ``chip_smoke.py --graph-rank RANK PORT DIR``
    by ``phase_graph_axis``: two gloo ranks share card 0. Writes its
    figures, ring result and final parameters under ``out_dir``."""
    import torch

    from eeg_gnn_tpu_torch.entry import dryrun_multichip
    from eeg_gnn_tpu_torch.parallel import distributed, make_mesh
    from eeg_gnn_tpu_torch.parallel.edge_partition import (
        edge_partitioned_spmm,
        gather_blocks,
        partition_by_dest,
        place_edge_partitioned,
        shard_edges,
    )
    from eeg_gnn_tpu_torch.parallel.sparse_model import (
        make_sparse_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    distributed.initialize(f"tcp://127.0.0.1:{port}", GRAPH_RANKS, rank,
                           local_world_size=GRAPH_RANKS, device=dev)
    mesh = make_mesh(f"graph:{GRAPH_RANKS}")
    res = {"backend": mesh.backend}
    reset_counts()
    distributed.reset_counts()
    # the ring SpMM at N=4096: this rank's memory across it (its share of
    # the graph and features placed inside the window)
    g, x = ring_graph(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shard, xb = place_edge_partitioned(mesh, g, x)
    with torch.no_grad():
        out = edge_partitioned_spmm(mesh, shard, xb)
    torch.cuda.synchronize()
    es, blk = shard.values.numel(), shard.block
    res.update(peak=torch.cuda.max_memory_allocated() - base, es=es,
               blk=blk, budget=(3 * blk * RING_D * 4 + es * RING_D * 4
                                + es * 12))
    np.save(os.path.join(out_dir, f"rank{rank}_ring.npy"),
            gather_blocks(mesh, out, RING_N).cpu().numpy())
    with torch.no_grad():
        res["ring_ms"] = host_ms(
            torch, lambda: edge_partitioned_spmm(mesh, shard, xb))
    # GRAPH_STEPS sparse steps at full width, each timed
    x_seq, y, _, block_diag = sparse_inputs(torch, dev)
    sgraph = shard_edges(partition_by_dest(block_diag, GRAPH_RANKS),
                         mesh.graph_rank, dev)
    model, opt = sparse_start(torch)
    step = make_sparse_train_step(model, opt, mesh)
    distributed.reset_counts()
    res["losses"], grads, res["step_ms"] = sparse_steps(torch, step, sgraph,
                                                        x_seq, y)
    res["collectives"] = {k: [c / GRAPH_STEPS for c in v]
                          for k, v in distributed.counts().items()}
    np.save(os.path.join(out_dir, f"rank{rank}_grads.npy"), grads)
    np.savez(os.path.join(out_dir, f"rank{rank}_params.npz"),
             **scale_state(step))
    res["paths"] = {"graph_axis_gloo": counts()}
    # the dry run: every sharded path on data:2, then the sparse step on
    # graph:2 (its data-parallel steps launch the detector's kernels)
    reset_counts()
    t0 = time.perf_counter()
    dryrun_multichip(GRAPH_RANKS)
    res["dryrun_s"] = time.perf_counter() - t0
    res["paths"]["dryrun_gloo"] = counts()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.shutdown()


def phase_graph_axis(torch, dev, card):
    """The mesh's graph axis (``parallel/edge_partition``,
    ``parallel/sparse_model``, ``entry``): (a) graph:1 on one NCCL rank
    in this process (:func:`graph_one_rank`); (b) two gloo ranks sharing
    the card, each a process of this script (:func:`graph_rank`; NCCL
    refuses two ranks on one device): the ring SpMM gathered against
    (a)'s, each rank's peak memory across it against the block budget,
    3 sparse steps at full width against (a)'s parameters (the ranks'
    bitwise equal), the ring shifts a step, ``dryrun_multichip(2)``. No
    hand-written kernel launches on the graph path. Returns the launches
    by path."""
    out_dir = os.path.join("chiprun_out", "graph_axis")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    for name in ("NCCL_SOCKET_IFNAME", "GLOO_SOCKET_IFNAME"):
        os.environ.setdefault(name, "lo")  # this host only
    paths = {}
    paths["graph_axis"], paths["entry"], one = graph_one_rank(
        torch, dev, card, out_dir)
    port = str(_free_port())
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(GRAPH_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--graph-rank", str(r),
         port, out_dir], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(GRAPH_RANKS)]
    t1 = time.perf_counter()
    try:
        for r, proc in enumerate(procs):
            left = GRAPH_TIMEOUT - (time.perf_counter() - t1)
            try:
                proc.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                fail(f"graph axis: rank {r} ran past {GRAPH_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            fail(f"graph axis: rank {r} exited {proc.returncode}:\n{tail}")
    ranks = []
    for r in range(GRAPH_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if any(rk["backend"] != "gloo" for rk in ranks):
        fail(f"graph axis: backends {[rk['backend'] for rk in ranks]}")
    # the ring SpMM, gathered, against (a)'s
    ref = np.load(os.path.join(out_dir, "ring_one_rank.npy"))
    for r, rk in enumerate(ranks):
        got = np.load(os.path.join(out_dir, f"rank{r}_ring.npy"))
        err = float(np.abs(got - ref).max())
        log(f"graph axis (b) ring SpMM on two gloo ranks, rank {r}: "
            f"gathered against one rank's {err:.3e} (bar rtol and atol "
            f"{RING_TOL:.0e}); peak memory across it {rk['peak']} B "
            f"(torch.cuda.max_memory_allocated, placement included) "
            f"against the block budget {rk['budget']} B x {MEM_SLACK} "
            f"(3 (N/p, D) f32 blocks: owned out, circulating, received; the "
            f"gathered-edge temporary and the edge shard, {rk['es']} edges)")
        if not np.allclose(got, ref, rtol=RING_TOL, atol=RING_TOL):
            fail(f"graph axis (b) rank {r}: ring SpMM {err} from (a)'s")
        if not rk["peak"] <= MEM_SLACK * rk["budget"]:
            fail(f"graph axis (b) rank {r}: peak {rk['peak']} B over "
                 f"{MEM_SLACK} x the budget {rk['budget']} B")
    # the steps: ranks bitwise equal, and against one rank's
    states = [dict(np.load(os.path.join(out_dir, f"rank{r}_params.npz")))
              for r in range(GRAPH_RANKS)]
    one_rank = dict(np.load(os.path.join(out_dir, "one_rank.npz")))
    diff = [k for k in states[0]
            if not np.array_equal(states[0][k], states[1][k])]
    if diff:
        fail(f"graph axis (b): ranks differ in {diff}")
    err = norm_err(*(torch.from_numpy(np.concatenate(
        [st[k].ravel() for k in one_rank])) for st in (states[0],
                                                      one_rank)))[0]
    worst = {k: float(np.abs(states[0][k] - v).max())
             for k, v in one_rank.items()}
    grad_err = norm_err(*(torch.from_numpy(np.load(os.path.join(
        out_dir, f))) for f in ("rank0_grads.npy", "one_rank_grads.npy")))[0]
    shifts = ranks[0]["collectives"]["ring_shift"]
    log(f"graph axis (b) {GRAPH_STEPS} sparse steps at full width on two "
        f"gloo ranks: ranks bitwise equal; first-step gradients against one "
        f"rank's {grad_err:.3e} (bar {SCALE_F32_TOL:.0e}, normalized "
        f"inf-norm of the gradient vector); parameters after the steps "
        f"{err:.3e} (bar {SCALE_F32_TOL:.0e}, normalized inf-norm of the "
        f"parameters; max abs by tensor {worst}, not gated); losses "
        f"{ranks[0]['losses']}; a step {shifts[0]:.0f} ring shifts, "
        f"{shifts[1]:.0f} B sent a rank; collectives a step "
        f"{ranks[0]['collectives']}")
    if not grad_err <= SCALE_F32_TOL:
        fail(f"graph axis (b): first-step gradients {grad_err} from one "
             "rank's")
    if not err <= SCALE_F32_TOL:
        fail(f"graph axis (b): parameters {err} from one rank's")
    if not shifts[0] > 0:
        fail("graph axis (b): no ring shift on two ranks")
    for path in ("graph_axis", "entry"):
        paths[path] = {k: paths[path].get(k, 0) for k in KERNELS}
    for r, rk in enumerate(ranks):
        for path, n in rk["paths"].items():
            key = path if r == 0 else f"{path}_rank{r}"
            paths[key] = {k: n.get(k, 0) for k in KERNELS}
    for path, n in paths.items():
        if path.startswith("graph_axis") and any(n.values()):
            fail(f"graph axis: kernels launched on {path}: {n}")
    rk = ranks[0]
    log(f"time graph axis (b) two gloo ranks on one card: ring SpMM "
        f"N={RING_N} {rk['ring_ms']:.3f} ms (host clock, median of {REPS}); "
        f"sparse step at full width "
        f"{statistics.median(rk['step_ms']):.1f} ms (host clock, median of "
        f"the {GRAPH_STEPS} gated steps: {rk['step_ms']}); "
        f"dryrun_multichip(2) {rk['dryrun_s']:.1f} s; {card}")
    log(f"graph axis: {time.perf_counter() - t0:.1f} s")
    return paths


def log_input_rates(stats, times, card):
    """The cached loops' clips/s beside the bare TrainStep's at B=128 in
    the same run (phase_times, phase_ssl_times; per-clip supports there,
    the shared slab here)."""
    step_ms, best = times[("train", "combined", "bfloat16", True)]
    ssl_ms, ssl_best = times[("ssl", "bfloat16")]
    for path, st in stats["cached"].items():
        ms, b = (ssl_ms, ssl_best) if path == "cached_ssl" else (step_ms,
                                                                 best)
        log(f"input {path}: {st['clips'] / st['epoch_s']:.1f} clips/s over "
            f"an epoch beside the bare TrainStep's {BATCH / ms * 1e3:.1f} "
            f"(median, synchronised) / {BATCH / b * 1e3:.1f} (back to back) "
            f"at B={BATCH}, bf16; device busy "
            f"{100 * st['busy'] / st['wall']:.1f}% of a traced epoch; {card}")


def log_cli_rates(stats, step_ms, card):
    """The CLI runs' train-loop clips/s beside the bare TrainStep's at the
    same batch (``phase_times``), and the loader's share of each epoch."""
    step_rate = CLI_BATCH / step_ms * 1e3
    for tag, st in stats.items():
        clips, secs = sum(st["train_clips"]), sum(st["train_s"])
        wait, wall = sum(st["loader_wait_s"]), sum(st["epoch_s"])
        log(f"cli {tag}: train loop {clips / secs:.1f} clips/s over "
            f"{CLI_EPOCHS} epochs beside TrainStep's {step_rate:.1f} "
            f"clips/s at B={CLI_BATCH} (detection, bf16, combined); "
            f"loader wait {100 * wait / wall:.1f}% of the epochs' "
            f"{wall:.3f} s; {card}")



def profile_batch(torch, fn, tag, wall_ms):
    """Device time by kernel for one traced call (a Predictor batch or a
    train step; torch.profiler), and the device's busy share of that
    call's wall time (the host clock around the call and a final
    synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: CPU ops repeat their kernels' device
        # time, and the profiler's own buffer requests are no work
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("Activity Buffer")
                and e.self_device_time_total > 0):
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile {tag}: device busy {busy:.3f} ms of the traced call's "
        f"{traced_ms:.3f} ms wall ({100 * busy / traced_ms:.1f}%); "
        f"untraced median {wall_ms:.3f} ms")
    for ms, count, key in rows[:10]:
        log(f"profile   {ms:8.3f} ms  x{count:<4d} {key[:90]}")


def main():
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--scaleout-rank":
        scale_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])  # phase 14
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--graph-rank":
        graph_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])  # phase 15
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = phase_build(torch)
    worst, main_abs = phase_parity(torch, dev)
    log(f"parity: worst normalized error {worst}")
    worst_b, main_abs_b = phase_bwd_parity(torch, dev)
    log(f"parity: worst normalized error {worst_b}")
    main_abs.update(main_abs_b)
    worst_d, main_abs_d = phase_dec_parity(torch, dev)
    log(f"parity: worst normalized error {worst_d}")
    main_abs.update(main_abs_d)
    worst_f, main_abs[FDC] = phase_fdc_parity(torch, dev)
    mts = montages(torch, dev)
    worst_s, main_abs[SDDMM] = phase_sddmm_parity(torch, dev, mts)
    log(f"parity: worst normalized error {{{FDC!r}: {worst_f}, "
        f"{SDDMM!r}: {worst_s}}}")
    served = phase_serve(torch)
    trained = phase_train(torch, dev)
    ssl = phase_ssl(torch, dev)
    paths = {"serve": served, "train": trained, "ssl": ssl,
             "serve_pallas": phase_pallas_serve(torch),
             "train_pallas": phase_pallas_train(torch, dev),
             "ssl_pallas": phase_pallas_ssl(torch, dev),
             "rescore": phase_rescore(torch, mts)}
    cli_paths, cli_stats, corpus = phase_cli(torch, card)
    paths.update(cli_paths)
    input_paths, input_stats = phase_input(torch, dev, card, corpus)
    paths.update(input_paths)
    paths["ingest_clipstore"] = phase_ingest(torch, dev, card, corpus,
                                             input_stats["cli"])
    for path, names in (("serve", (FWD[1],) + XIN_FWD),
                        ("train", (FWD[1], "dcgru_dw_reduce")
                         + XIN_FWD + XIN_BWD),
                        ("ssl", SSL_KERNELS), ("serve_pallas", (FDC,)),
                        ("train_pallas", (FDC,)),
                        ("ssl_pallas", (FDC, DEC[0]) + DEC_BWD),
                        ("rescore", (SDDMM,)),
                        ("cli_detect", CLI_DETECT), ("cli_ssl", SSL_KERNELS),
                        ("cli_finetune", CLI_DETECT),
                        ("serve_raw", XIN_FWD), ("cached_train", CLI_DETECT),
                        ("cached_train_fused", CLI_DETECT),
                        ("rotating", CLI_DETECT), ("cached_ssl", SSL_KERNELS),
                        ("cli_hbm_detect", CLI_DETECT),
                        ("cli_hbm_ssl", SSL_KERNELS),
                        ("cli_pipeline_detect", CLI_DETECT),
                        ("cli_hbm_fused", CLI_DETECT),
                        ("ingest_clipstore", CLI_DETECT)):
        for name in names:
            if paths[path][name] < 1:
                fail(f"{name} was never launched on the {path} path")
    times = phase_times(torch, dev)
    log_cli_rates(cli_stats | input_stats["cli"],
                  times[("train", CLI_BATCH)][0], card)
    times.update(phase_ssl_times(torch, dev))
    log_input_rates(input_stats, times, card)
    times.update(phase_pallas_times(torch, dev, mts))
    cls_paths, cls_stats = phase_classification(torch, dev, card, corpus)
    paths.update(cls_paths)
    for path in cls_paths:
        for name in XIN_FWD if path == "serve_cls" else CLI_DETECT:
            if paths[path][name] < 1:
                fail(f"{name} was never launched on the {path} path")
    log_cli_rates(cls_stats, times[("train", CLI_BATCH)][0], card)
    paths["baselines"] = phase_baselines(torch, dev, card, corpus)
    scale_paths = phase_scaleout(torch, dev, card, corpus)
    paths.update(scale_paths)
    for path in scale_paths:
        for name in XIN_FWD if "serve" in path else CLI_DETECT:
            if paths[path][name] < 1:
                fail(f"{name} was never launched on the {path} path")
    graph_paths = phase_graph_axis(torch, dev, card)
    paths.update(graph_paths)
    for path in graph_paths:  # the graph paths launch none (checked there)
        for name in (XIN_FWD if path == "entry" else CLI_DETECT
                     if path.startswith("dryrun") else ()):
            if paths[path][name] < 1:
                fail(f"{name} was never launched on the {path} path")

    kernels, composites = [], []
    pallas = "eeg_gnn_tpu/ops/pallas_recurrent.py"
    csrc = "eeg_gnn_tpu_torch/csrc/"
    xin_src = [csrc + "dcgru_xin_gemm.cu", csrc + "dcgru_recurrence.cu",
               csrc + "dcgru_recurrence_bwd.cu"]
    for name, replaces, source in (
            (FWD[0], f"{pallas}:730", xin_src[:2]),
            (XIN_FWD[0], f"{pallas}:730", xin_src[0]),
            (XIN_FWD[1], f"{pallas}:730", xin_src[1]),
            (FWD[1], f"{pallas}:240", xin_src[1]),
            (BWD[0], f"{pallas}:782", [xin_src[2], xin_src[0]]),
            (XIN_BWD[0], f"{pallas}:782", xin_src[2]),
            (XIN_BWD[1], f"{pallas}:782", xin_src[0]),
            (XIN_BWD[2], f"{pallas}:782", xin_src[0]),
            (BWD[1], f"{pallas}:283", [xin_src[2], xin_src[0]]),
            # the cross-grid dW accumulation of _bwd_kernel_xin/_bwd_kernel
            ("dcgru_dw_reduce", f"{pallas}:794", xin_src[2])):
        # one batch or step: layer 0 (D=100) then layer 1 (D=64); layer 0
        # runs no dx
        tag = "float32" if name == "dcgru_dw_reduce" else "bfloat16"
        layers = [times[(name, tag, d)] for d in
                  ((64,) if name == XIN_BWD[2] else (100, 64))]
        work = [w for layer in layers for w in
                (layer[2] if isinstance(layer[2], list) else [layer[2]])]
        bms, by = bound_ms(work)
        entry = {
            "name": name, "route": "cuda",
            "source": source if isinstance(source, str) else source[0],
            "replaces": replaces,
            "max_abs_err": main_abs[name],
            "ms": sum(v[0] for v in layers),
            "plain_ms": sum(v[1] for v in layers),
            "bound_ms": bms, "bound_by": by,
            "library_ms": (sum(v[3] for v in layers)
                           if name == "dcgru_dw_reduce" else None),
            "shape": ("2 layers (D=100, 64), T=60, B=128, N=19, H=64, M=3, "
                      + ("f32 split partials (S, W)" if tag == "float32"
                         else "bf16 streams")
                      + ("; layer 0 without dx" if name == BWD[0] else "")
                      + ("; layer 1 only (layer 0 asks for no dx)"
                         if name == XIN_BWD[2] else "")
                      + ("; the hoisted layers (no x), input_fusion=False"
                         if name == BWD[1] else "")),
        }
        if name in (FWD[0], BWD[0], BWD[1]):
            # a wrapper that launches no kernel of its own: its kernels'
            # time as a whole, and the bound of the same function with every
            # product at the non-tensor f32 rate; no launch count
            del entry["route"], entry["source"]
            entry["sources"] = source
            entry["kernels"] = list({FWD[0]: XIN_FWD,
                                     BWD[0]: XIN_BWD + ("dcgru_dw_reduce",),
                                     BWD[1]: HOISTED_BWD}[name])
            entry["bound_f32_ms"] = bound_ms([
                times[(name, tag, d, "f32 bound")] for d in (100, 64)])[0]
            composites.append(entry)
            continue
        entry["launches"] = sum(c[name] for c in paths.values())
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        kernels.append(entry)
        dec_shape = (f"{SSL_LAYERS}-layer decoder, T_out={T_OUT}, "
                     f"B={BATCH}, N=19, H=64, D=100, M=3")
        if name == "dcgru_dw_reduce":
            # the SSL step also sums the decoder's three split partials
            ms, plain_ms, work, lib_ms = times[(name, tag, "dec")]
            dbms, dby = bound_ms(work)
            kernels[-1]["decoder"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": dbms,
                "bound_by": dby, "library_ms": lib_ms,
                "shape": f"{dec_shape}: layer 0, tied cell, dWp partials"}
        if name == XIN_BWD[1]:
            # the hoisted layers' launches at D = 0 (no x), as BWD[1] runs
            # them on the input_fusion=False train path
            layers0 = [times[(DW_D0, tag, d)] for d in (100, 64)]
            dbms, dby = bound_ms([v[2][0] for v in layers0])
            kernels[-1]["hoisted"] = {
                "ms": sum(v[0] for v in layers0),
                "plain_ms": sum(v[1] for v in layers0), "bound_ms": dbms,
                "bound_by": dby, "library_ms": None,
                "max_abs_err": main_abs[DW_D0],
                "shape": "2 hoisted layers at D=0, T=60, B=128, N=19, H=64, "
                         "M=3, bf16 streams"}
            # the SSL decoder's two launches: layer 0 and the tied cell
            ms, plain_ms, work = times[(f"{name} (decoder)", "bfloat16")]
            dbms, dby = bound_ms(work)
            kernels[-1]["decoder"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": dbms,
                "bound_by": dby, "library_ms": None,
                "max_abs_err": main_abs[f"{name} (decoder)"],
                "shape": f"{dec_shape}, bf16 streams: layer 0 (D=100) + "
                         f"the tied cell ({SSL_LAYERS - 1} layers stacked)"}
    dec = "eeg_gnn_tpu/ops/pallas_decoder.py"
    dec_src = "eeg_gnn_tpu_torch/csrc/dcgru_decoder.cu"
    for name, replaces in ((DEC[0], f"{dec}:157"), (DEC[1], f"{dec}:229"),
                           (DEC_BWD[0], f"{dec}:229"),
                           (DEC_BWD[1], f"{dec}:281")):
        ms, plain_ms, work = times[(name, "bfloat16")]
        bms, by = bound_ms(work)
        entry = {
            "name": name, "route": "cuda", "source": dec_src,
            "replaces": replaces,
            "max_abs_err": main_abs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": times.get((name, "library")),
            "shape": (f"{SSL_LAYERS} layers, T_out={T_OUT}, B={BATCH}, "
                      f"N=19, H=64, D=100, M=3, bf16 streams"),
        }
        if name == DEC_BWD[1]:
            # beside library_ms: the kernel and its reduction, as run
            entry["ms_with_reduce"] = times[(name, "with reduce")]
        if name == DEC[1]:
            # a wrapper that launches no kernel of its own
            del entry["route"], entry["source"]
            entry["sources"] = [dec_src, xin_src[0], xin_src[2]]
            entry["kernels"] = list(DEC_BWD + (XIN_BWD[1],
                                               "dcgru_dw_reduce"))
            composites.append(entry)
            continue
        entry["launches"] = sum(c[name] for c in paths.values())
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        kernels.append(entry)
    gate, cand = times[(FDC, 1, 2 * H)], times[(FDC, 1, H)]
    bms, by = bound_ms([gate[2], cand[2]])
    gate5, cand5 = times[(FDC, 2, 2 * H)], times[(FDC, 2, H)]
    bms5, by5 = bound_ms([gate5[2], cand5[2]])
    kernels.append({
        "name": FDC, "route": "cuda",
        "source": "eeg_gnn_tpu_torch/csrc/fused_diffusion_conv.cu",
        "replaces": "eeg_gnn_tpu/ops/pallas_kernels.py:32",
        "launches": sum(c[FDC] for c in paths.values()),
        "launches_by_path": {p: c[FDC] for p, c in paths.items()},
        "max_abs_err": main_abs[FDC],
        "ms": gate[0] + cand[0], "plain_ms": gate[1] + cand[1],
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "staging_ms": times[(FDC, 1, "staging")],
        "shape": (f"one loop step of one layer: gate (O={2 * H}) + candidate "
                  f"(O={H}), B={BATCH}, N=19, D=H={H}, M=3, float32, "
                  "operands staged once a layer a forward (staging_ms)"),
        "individual": {"ms": gate5[0] + cand5[0],
                       "plain_ms": gate5[1] + cand5[1], "bound_ms": bms5,
                       "bound_by": by5,
                       "staging_ms": times[(FDC, 2, "staging")],
                       "shape": "the same at M=5"},
    })
    entry = {}
    for topo in ("banded", "topk"):
        t_ = times[(SDDMM, topo)]
        sbms, sby = bound_ms([t_["work"]])
        entry[topo] = {
            "ms": t_["ms"], "plain_ms": t_["plain_ms"], "bound_ms": sbms,
            "bound_by": sby, "library_ms": t_["library_ms"],
            "library": t_["library"], "dense_gram_ms": t_["dense_gram_ms"],
            "shape": (f"N=4096 {topo}, D={D_SIG}, {t_['blocks']} occupied "
                      "128x128 blocks, float32")}
    kernels.append({
        "name": SDDMM, "route": "cuda",
        "source": "eeg_gnn_tpu_torch/csrc/sddmm.cu",
        "replaces": "eeg_gnn_tpu/ops/sddmm.py:104",
        "launches": sum(c[SDDMM] for c in paths.values()),
        "launches_by_path": {p: c[SDDMM] for p, c in paths.items()},
        "max_abs_err": main_abs[SDDMM], **entry["banded"],
        "topk": entry["topk"],
    })
    log(f"total {time.perf_counter() - t0:.1f} s on {card}")
    log("wrappers " + json.dumps({"wrappers": composites}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
