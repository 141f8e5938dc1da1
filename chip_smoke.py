#!/usr/bin/env python3
"""On-card smoke run of paddle_tpu_torch: ResNet-50 and BERT-base served,
BERT-base and ResNet-50 trained in f32 and in bf16 mixed precision,
BERT-base and Transformer-base trained at bench.py's own settings, a
Transformer-base-wide decoder LM served token by token with continuous
batching, and the image-classification zoo (SmallNet, AlexNet, VGG-19,
GoogLeNet, SE-ResNeXt-50) trained and GoogLeNet served at bench.py's
settings, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from paddle_tpu_torch/csrc/ (bn_apply,
flash_attn_fwd and flash_attn_bwd, one nvcc each, in parallel) and holds
each against its plain PyTorch version on the card (bn_apply and its
backward, which is plain torch, at batch 16 and 128, and in bf16 at 256).
Then it drives eighteen paths, with random weights from a seed, TF32 off
and bf16 GEMMs reducing in f32:

- ResNet-50 (depth 50, 224x224, 1000 classes) served through
  save_inference_model -> create_predictor(Config(dir)) -> Predictor.run,
  batch 1/8/16, with 53 bn_apply launches per request;
- BERT-base (12 layers, d_model 768, 12 heads, d_ff 3072, vocab 30522) at
  S=512 served the same way, its masked-LM logits, batch 1/8, with 12
  flash_attn_fwd launches per request;
- BERT-base at S=512 trained through build_bert_pretrain (masked-LM loss,
  Adam.minimize) -> Executor.run(startup) -> Executor.run(main, feed,
  fetch_list=[loss]), batch 8, 2 warm-up and 10 timed steps on one fixed
  batch, with 12 launches of each backward kernel (flash_attn_bwd_dkv,
  flash_attn_bwd_dq) and 24 of flash_attn_fwd per step;
- ResNet-50 (depth 50, 224x224, 1000 classes, space-to-depth stem) trained
  through build_train_net (softmax cross-entropy, top-1 accuracy,
  Momentum(0.1, 0.9)) -> Executor.run(startup) -> Executor.run(main, feed,
  fetch_list=[avg_loss, acc]), batch 128, 2 warm-up, 10 timed and 18 more
  steps on one fixed batch, with 106 bn_apply launches per step (the 53
  batch_norm ops and the forward each batch_norm_grad re-runs);
- the same two training programs marked for bf16 mixed precision by
  contrib.mixed_precision.enable_bf16, as bench.py marks them: BERT-base
  at batch 8 and ResNet-50 at batch 256, each with the launch counts
  above, every launch bf16, and the loss, every parameter gradient,
  parameter and optimizer state f32.
- BERT-base pretraining as bench.py:504-540 bench_bert runs it:
  build_bert_pretrain at S=128 with its default dropout 0.1 (37 dropout
  ops; the attention on the composed branch, 24 matmul ops and no fused
  one) and Adam(lr 1e-4) -> enable_bf16 -> gradient_merge.enable(2) ->
  Executor.run, batch 64 (2 microbatches of 32), 2 warm-up and 10 timed
  steps on bench.py's feed; this path launches none of the kernels.
- Transformer-base NMT training as bench.py:448-501 bench_transformer
  runs it: build_transformer_train (6+6 layers, d_model 512, 8 heads,
  d_ff 2048, S=256, vocabularies of 32000, Adam on 2·noam_decay(512,
  4000)) at its default dropout 0.1 (1,157 ops: 50 dropout, 36 matmul,
  every attention composed; no kernel launch) -> enable_bf16 ->
  Executor.run, batch 64, 3 warm-up and 10 timed steps on bench.py's
  feed; then the same program at dropout 0 (971 ops, 18
  fused_multihead_attention), with 36 bf16 flash_attn_fwd launches and 18
  of each backward kernel per step, 12 / 6 / 6 of them causal (the
  decoder's self-attention); each step's learning rate against noam's
  closed form, also under gradient_merge.enable(2).
- continuous decode serving as bench.py:761-863 bench_decode_serving
  drives it, at Transformer-base widths (decode-base:
  build_decode_spec with vocab 32000, d_model 512, 8 heads, 6 layers,
  d_ff 2048, 32 slots, a 512-long f32 cache, prompt buckets 64/128/256)
  through export_decode -> DecodingPredictor: 64 requests of 64 new
  tokens one at a time, then as Poisson arrivals at 8 times that request
  rate (transcripts equal), then 3 beam-3 requests beside greedy traffic
  (equal to their solo runs); no kernel launches on this path. The same
  artifact served on the CPU holds the card's prefill and teacher-forced
  step logits (1e-3 of the largest) and greedy transcripts.
- the image-classification rows of bench.py (BENCHES, bench.py:1771-1790)
  as it runs them: build_train_net -> enable_bf16 -> Executor.run, 2
  warm-up and 10 timed steps on one fixed batch, for SmallNet at 32x32
  (batch 256), AlexNet (256), VGG-19 (128; 4 bf16 bn_apply launches a
  step: its two 2-D fc -> batch_norm heads, [128, 4096], and the forward
  each batch_norm_grad re-runs), GoogLeNet (256; 9 inception concats) and
  SE-ResNeXt-50 (128, half of ResNet-50's bench batch; groups=32
  convolutions, squeeze-excitation, 106 bf16 bn_apply launches a step),
  each with its device time a step by bench.py's two-point slope over
  Executor.run_steps; and GoogLeNet inference served in f32 at batch 16
  through Predictor.run (no kernel launches), its device time a batch by
  the slope over Predictor.run_batches.
- ResNet-50 served as bench.py:665-749 resnet50_serving serves it, from
  the first path's saved directory: export_compiled at buckets
  1/8/32/128 -> BatchingPredictor(batch_timeout_ms=5) -> warmup, one
  device copy of the parameters for all buckets; 32 batch-1
  CompiledPredictor.run calls back to back, the capacity from 5
  full-bucket calls, then 256 batch-1 requests arriving as a Poisson
  stream at 80% of it, with 53 f32 bn_apply launches per batch
  dispatched; run_batches at bucket 8 (its slope, and 8 batches equal to
  8 run() calls bit for bit); 32 concurrent submits to a single-bucket
  {32} artifact, each equal to its unbatched run bit for bit; each
  bucket's logits against the CPU's.
- the bf16 ResNet-50 training program above exported by
  export_train_step and trained by CompiledTrainer at batch 64: 3 steps
  equal to 3 Executor.run steps bit for bit (losses and every
  persistable, under torch.backends.cudnn.deterministic), a resume from
  a checkpoint taking step 3 as the first trainer did, 106 bf16 bn_apply
  launches a step.

Each path runs with every kernel's launch count set to 0 just before it
and read just after. The run compares GPU and CPU outputs of each served
model, the loss and gradients of one step of each trained model (f32 and
bf16; each tolerance 4 times the one-ulp noise measured over NOISE_DRAWS
draws on each side; bench_bert's program at batch 2 with k=2, the CPU
given the masks the card drew; bench_transformer's at batch 2, dropout 0.1
in f32 and bf16 with the card's masks given to the CPU, and dropout 0 in
bf16, causal K2 against the CPU's plain attention), and ResNet-50's
backward with card and CPU
fed the card's forward values (f32 and bf16), checks dropout and its
gradient on the card (keep share, Out and dX exact, fresh masks per step
and microbatch), holds one step of each zoo model at batch 2 (bf16, and
f32 for VGG-19 and SE-ResNeXt-50) on the card against the CPU (the CPU
given the card's dropout masks, the backward fed the card's forward
values) and GoogLeNet's served logits, holds run_steps(4) on VGG-19 and
run_batches(8) on GoogLeNet against run() bit for bit (the one phase that
sets torch.backends.cudnn.deterministic), checks and times bn_apply at
the zoo's shapes, times the kernels (CUDA events),
the requests and the steps (host clock), and profiles a few requests and
steps. Every check that fails
raises, so the exit code is 0 only when all phases passed. Without a
card it exits 1 and prints no result.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit from nvidia-smi, and the one before that the
kernels' summary as JSON.
"""
import collections
import json
import math
import os
import platform
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch as fluid
from paddle_tpu_torch import kernels, passes
from paddle_tpu_torch.contrib import gradient_merge, mixed_precision
from paddle_tpu_torch.inference import (BatchingPredictor, CompiledPredictor,
                                        CompiledTrainer, DecodingPredictor,
                                        export_compiled, export_decode,
                                        export_train_step)
from paddle_tpu_torch.models import (alexnet, googlenet, se_resnext, smallnet,
                                     vgg)
from paddle_tpu_torch.models.bert import bert_mlm_logits, build_bert_pretrain
from paddle_tpu_torch.models.resnet import build_train_net, resnet_imagenet
from paddle_tpu_torch.models.transformer import (build_decode_spec,
                                                 build_transformer_train)
from paddle_tpu_torch.ops import bn_apply as bn_mod
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import tensor_ops
from paddle_tpu_torch.core.lowering import TraceError

SEED = 0
BATCHES = (1, 8, 16)
LATENCY_REQUESTS = 20      # timed requests per batch size
THROUGHPUT_REQUESTS = 30   # back-to-back batch-16 requests, one sync
KERNEL_REPS = 50
SPIN_CYCLES = 100_000_000  # ~50 ms at the H100's ~2 GHz SM clock
# H100 SXM peaks (NVIDIA H100 data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12       # f32 on the CUDA cores
TF32_OPS_PER_S = 495e12     # TF32 on the tensor cores
BF16_OPS_PER_S = 989e12
# the K2 kernels' f32 products run in the 3xTF32 split: three TF32
# products for each f32 one, so the least time of an f32 product is its
# operations at a third of the TF32 rate
F32_3XTF32_OPS_PER_S = TF32_OPS_PER_S / 3
L2_BYTES = 50 * 2 ** 20

# the (C, H, W) of ResNet-50's 53 batch_norm outputs at 224x224, with counts
BN_SHAPES = [((256, 14, 14), 11), ((128, 28, 28), 7), ((1024, 14, 14), 7),
             ((64, 56, 56), 6), ((512, 28, 28), 5), ((512, 7, 7), 5),
             ((256, 56, 56), 4), ((2048, 7, 7), 4), ((64, 112, 112), 1),
             ((128, 56, 56), 1), ((256, 28, 28), 1), ((512, 14, 14), 1)]
BN_BATCH = 16
# threads of bn_apply's largest grid (csrc/bn_apply.cu: kMaxBlocks blocks of
# kThreads), each moving one 16-byte vector a pass of its grid-stride loop
BN_GRID_THREADS = (1 << 16) * 256

# BERT-base (models/bert.py defaults) at its published maximum length
BERT = dict(vocab=30522, max_len=512, d_model=768, d_ff=3072, n_head=12,
            n_layer=12)
BERT_BATCHES = (1, 8)
BERT_LATENCY_REQUESTS = 10
BERT_THROUGHPUT_REQUESTS = 10
# (B, H, Sq, Sk, D) of the attentions of bench_transformer's dropout-0
# path: Transformer-base at batch 64, S=256, 8 heads of 64, causal in the
# decoder's self-attention, not causal elsewhere
K2_TRANS_SHAPE = (64, 8, 256, 256, 64)
# (B, H, Sq, Sk, D, causal) of the K2 checks: BERT-base at batch 1 and 8,
# the transformer's dropout-0 path, causal and not, causal square and
# offset (Sq < Sk), a ragged S, and D 32/64/128
K2_CASES = [(1, 12, 512, 512, 64, False), (8, 12, 512, 512, 64, False),
            K2_TRANS_SHAPE + (True,), K2_TRANS_SHAPE + (False,),
            (2, 12, 512, 512, 64, True), (2, 12, 128, 512, 64, True),
            (2, 12, 200, 200, 64, False), (2, 12, 200, 200, 64, True),
            (2, 12, 512, 512, 32, False), (2, 12, 512, 512, 128, False)]
# (B, H, Sq, Sk, D, causal) of the K2 backward checks: BERT-base training at
# batch 8 and 1, the transformer's dropout-0 path, causal and not, causal
# square and offset, a ragged S, and D 32/64/128
K2_BWD_CASES = [(8, 12, 512, 512, 64, False), (1, 12, 512, 512, 64, False),
                K2_TRANS_SHAPE + (True,), K2_TRANS_SHAPE + (False,),
                (2, 12, 512, 512, 64, True), (2, 12, 128, 512, 64, True),
                (2, 12, 300, 300, 64, False), (2, 12, 300, 300, 64, True),
                (2, 12, 512, 512, 32, False), (2, 12, 512, 512, 128, True)]
# (B, H, S, D, causal, dtypes) of the K2 forward timings: BERT-base
# serving at batch 1 and 8, f32 and bf16, and the transformer's dropout-0
# path in bf16, causal and not
K2_TIME_CASES = [(b, BERT['n_head'], BERT['max_len'], 64, False,
                  (torch.float32, torch.bfloat16)) for b in BERT_BATCHES] + [
    K2_TRANS_SHAPE[:3] + K2_TRANS_SHAPE[4:] + (causal, (torch.bfloat16,))
    for causal in (True, False)]
TRAIN_BATCH = 8
# (B, H, S, D, causal, dtypes) of the K2 backward timings: BERT-base
# training at batch 8, f32 and bf16, and the transformer's dropout-0 path in
# bf16, causal and not
K2_BWD_TIME_CASES = [(TRAIN_BATCH, BERT['n_head'], BERT['max_len'], 64,
                      False, (torch.float32, torch.bfloat16))] + [
    K2_TIME_CASES[-1][:4] + (causal, (torch.bfloat16,))
    for causal in (True, False)]
TRAIN_WARMUP_STEPS = 2
TRAIN_STEPS = 10
# ResNet-50 training as bench.py:431 bench_resnet builds it
RESNET_TRAIN = dict(dshape=(3, 224, 224), class_dim=1000, depth=50,
                    imagenet=True, lr=0.1, s2d_stem=True)
RESNET_TRAIN_BATCH = 128
# untimed steps after the timed ones: at lr 0.1 the loss of a random
# ResNet-50 on one fixed batch rises for a few steps before it falls
RESNET_MORE_STEPS = 18
RESNET_GATE_BATCH = 4
# bf16 mixed precision (contrib.mixed_precision.enable_bf16 on the programs
# above): ResNet-50 at bench.py:431's defaults, bf16 at batch 256
RESNET_AMP_BATCH = 256
# bench_resnet's batch with PTPU_BENCH_DTYPE=f32 (bench.py:431-445)
RESNET_F32_BENCH_BATCH = 256
RESNET_F32_BENCH_MORE_STEPS = 8
# one-ulp draws of the GPU-vs-CPU gates' noise, on each side
NOISE_DRAWS = 3
# peak allocated bytes of each training phase's timed steps, by label
PEAKS = {}
# the same phases' peaks (GB) before the Executor freed each value after
# its last reader, as PERF.md records them from earlier runs of this
# script on an NVIDIA H100 80GB HBM3 at 700 W: f32 ResNet-50 at batch 128,
# bf16 at batch 256
PEAK_GB_NOTHING_FREED = {'resnet_training': 38.3,
                         'resnet_training_bf16': 40.88}
# BERT-base pretraining as bench.py:504-540 bench_bert runs it: S=128,
# batch 64, build_bert_pretrain's default dropout 0.1 (the attention
# takes the composed branch), Adam(lr 1e-4), bf16 AMP (enable_bf16) and
# gradient merge over 2 microbatches (gradient_merge.enable(2))
BENCH_BERT = dict(BERT, max_len=128)
BENCH_BATCH = 64
BENCH_K = 2
BENCH_GATE_BATCH = 2
DROPOUT_P = 0.1
# the dropout checks' x: a microbatch's attention weights [32, 12, 128, 128]
DROPOUT_SHAPE = (BENCH_BATCH // BENCH_K, BERT['n_head'], 128, 128)
# Transformer-base NMT training as bench.py:448-501 bench_transformer runs
# it: build_transformer_train at its settings (6+6 layers, d_model 512,
# 8 heads, d_ff 2048, S=256, vocabularies of 32000, Adam on 2·noam(512,
# 4000)), dropout 0.1 (every attention composed) and its ablation dropout 0
# (every attention fused: K2, the 6 decoder self-attentions causal), bf16
# AMP (enable_bf16), batch 64, 3 warm-up and 10 timed steps
TRANS = dict(src_vocab=32000, trg_vocab=32000, max_len=256, d_model=512,
             d_ff=2048, n_head=8, n_layer=6)
TRANS_BATCH = 64
TRANS_WARMUP_STEPS = 3
TRANS_STEPS = 10
TRANS_GATE_BATCH = 2
# microbatches and steps of the learning-rate check under gradient merge
TRANS_LR_K = 2
TRANS_LR_STEPS = 3
# continuous decode serving (decode-base): build_decode_spec at the widths
# bench_transformer trains (Transformer-base, Vaswani et al. 2017, Table 3:
# d_model 512, 8 heads, d_ff 2048, 6 layers, vocabulary 32000) as a
# decoder-only LM, 32 slots over a 512-long f32 cache, prompt buckets 64,
# 128 and 256; traffic as bench.py:761-863 bench_decode_serving offers it
DECODE = dict(vocab=32000, d_model=512, n_head=8, n_layer=6, d_ff=2048,
              max_slots=32, max_cache_len=512, prompt_buckets=(64, 128, 256),
              eos_id=1)
DECODE_REQUESTS = 64
DECODE_MAX_NEW = 64
DECODE_RATE_X = 8          # Poisson load, x the measured sequential rate
DECODE_BEAM = 3            # beam width and number of beam requests
DECODE_GATE_PROMPTS = 4    # greedy transcripts compared GPU vs CPU
DECODE_GATE_NEW = 16
DECODE_TF_STEPS = 16       # teacher-forced steps compared GPU vs CPU
DECODE_PROFILE_STEPS = 20  # full-occupancy steps timed and profiled
# the image-classification rows of bench.py (BENCHES, bench.py:1771-1790) as
# _bench_image_train (:395-429) and bench_smallnet (:1079-1110) run them:
# build_train_net -> enable_bf16 -> Executor.run(startup) -> Executor.run
# on one fixed batch of standard normal images and uniform labels. Each
# path: its model module and build_train_net's arguments, batch, image side,
# classes, training FLOPs an image as bench.py counts them (None where its
# row gives none), the K of bench.py's run_steps device-time slope
# (device_k) and the bn_apply launches a step (each batch_norm op and the
# forward its batch_norm_grad re-runs). SE-ResNeXt-50 (Hu et al. 2018, the
# reference's multi-device parity model) has no bench row: it runs at half
# of ResNet-50's bench batch.
ZOO = {
    'smallnet_cifar_training_bf16': dict(
        module=smallnet, kwargs={}, batch=256, side=32, classes=10,
        flops=None, k=16, bn=0),
    'alexnet_training_bf16': dict(
        module=alexnet, kwargs={}, batch=256, side=224, classes=1000,
        flops=3 * 2 * 0.77e9, k=4, bn=0),
    'vgg19_training_bf16': dict(
        module=vgg, kwargs={'depth': 19}, batch=128, side=224, classes=1000,
        flops=3 * 2 * 19.6e9, k=4, bn=4),
    'googlenet_training_bf16': dict(
        module=googlenet, kwargs={}, batch=256, side=224, classes=1000,
        flops=3 * 2 * googlenet.GOOGLENET_FWD_MACS, k=4, bn=0),
    'se_resnext50_training_bf16': dict(
        module=se_resnext, kwargs={'depth': 50}, batch=128, side=224,
        classes=1000, flops=None, k=4, bn=106),
}
# the GPU-vs-CPU gates of the zoo: batch 2 at full image size, bf16 for
# every path and f32 too for the two that launch bn_apply
ZOO_GATE_BATCH = 2
ZOO_F32_GATES = ('vgg19_training_bf16', 'se_resnext50_training_bf16')
# best of this many calls at each point of bench.py's two-point slope
SLOPE_REPS = 3
# GoogLeNet served as bench.py:593,616-663 bench_googlenet_infer serves it:
# f32, batch 16, 50 back-to-back requests and one sync, and its device time
# a batch by the same slope over Predictor.run_batches at K 8
GOOGLENET_SERVE_BATCH = 16
GOOGLENET_LATENCY_REQUESTS = 20
GOOGLENET_THROUGHPUT_REQUESTS = 50
GOOGLENET_DEVICE_K = 8
# run_steps(4) against 4 run() calls on VGG-19, run_batches(8) against 8
# run() calls on GoogLeNet serving, bit for bit
EXACT_STEPS = 4
EXACT_BATCHES = 8
# artifact serving as bench.py:665-746 _bench_image_serving runs
# resnet50_serving (:749): export_compiled at buckets 1/8/32/128 from a
# RandomState(0) sample of 128 images, BatchingPredictor(batch_timeout_ms=5),
# 5 full-bucket calls for the capacity, then 256 batch-1 requests arriving
# as a Poisson stream (RandomState(1)) at 80% of it
ARTIFACT_BUCKETS = (1, 8, 32, 128)
ARTIFACT_TIMEOUT_MS = 5.0
ARTIFACT_CAPACITY_CALLS = 5
ARTIFACT_REQUESTS = 256
ARTIFACT_RATE_SHARE = 0.8
ARTIFACT_SEQ_REQUESTS = 32     # batch-1 CompiledPredictor.run, back to back
ARTIFACT_PROFILE_REQUESTS = 64  # a second Poisson pass under the profiler
ARTIFACT_EXACT_BUCKET = 32     # 32 concurrent batch-1 submits, bit for bit
ARTIFACT_SLOPE_BUCKET = 8      # run_batches slope and exactness, K = 8
ARTIFACT_CPU_ROWS = 8          # each bucket's first rows against the CPU
# export_train_step -> CompiledTrainer on bench.py:431's ResNet-50 (s2d
# stem, Momentum) in bf16 at batch 64: 3 steps against Executor.run, and a
# resume from a checkpoint after step 2
TRAINER_BATCH = 64
TRAINER_STEPS = 3
# K1 at the zoo's shapes: VGG-19's two fc -> batch_norm heads, 2-D
# [128, 4096] (inner size 1)
VGG_BN_SHAPES = [((4096,), 2)]
# K1 and its backward are held against their plain versions at every batch
# and dtype a ResNet-50 path launches them with: serving at BN_BATCH, the
# batcher's f32 buckets below 128, f32 and AMP training, the compiled
# trainer's bf16 batch and f32 training at bench_resnet's batch; the
# largest BN outputs take the kernel's grid-stride loop through 2 (f32 at
# 128, bf16 at 256) and more passes: (batch, dtypes), one entry a batch
def _bn_checks(*entries):
    merged = {}
    for batch, dtypes in entries:
        have = merged.setdefault(batch, [])
        have += [d for d in dtypes if d not in have]
    return tuple((batch, tuple(dtypes)) for batch, dtypes in merged.items())


BN_CHECKS = _bn_checks(
    *((b, (torch.float32,)) for b in ARTIFACT_BUCKETS[:-1]),
    (BN_BATCH, (torch.float32, torch.bfloat16)),
    (TRAINER_BATCH, (torch.bfloat16,)),
    (RESNET_TRAIN_BATCH, (torch.float32, torch.bfloat16)),
    (RESNET_AMP_BATCH, (torch.bfloat16,)),
    (RESNET_F32_BENCH_BATCH, (torch.float32,)))


def check(cond, msg):
    if not cond:
        raise RuntimeError('check failed: ' + msg)


def card_line():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def host_line():
    """The host CPU (architecture, model where /proc/cpuinfo names it,
    CPUs) and the threads torch uses on it: the CPU side of every
    GPU-vs-CPU gate runs there."""
    fields = {}
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                key, _, value = line.partition(':')
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = (fields.get('model name') or fields.get('Model')
             or fields.get('CPU part') or 'model unknown')
    return '%s %s, %d CPUs, %d torch threads' % (
        platform.machine(), model, os.cpu_count(), torch.get_num_threads())


def _grid_passes(x):
    """Passes of bn_apply's grid-stride loop over x (16-byte vectors)."""
    return math.ceil(x.numel() * x.element_size() // 16 / BN_GRID_THREADS)


def _bn_vs_plain(batch, shapes, dtypes, gen, max_abs):
    """bn_apply vs bn_apply_reference at each (C, ...) of `shapes` with
    `batch` in front, in each of `dtypes`, act None and relu, within 1 ulp
    (one_ulp_bound); the largest |error| by dtype goes into max_abs.
    Returns the most grid-stride passes a case took."""
    passes = 0
    for shape, _ in shapes:
        c = shape[0]
        x32 = torch.randn((batch,) + tuple(shape), device='cuda',
                          generator=gen)
        k = torch.rand(c, device='cuda', generator=gen) + 0.5
        b = torch.randn(c, device='cuda', generator=gen)
        for dtype in dtypes:
            x = x32.to(dtype)
            passes = max(passes, _grid_passes(x))
            for act in (None, 'relu'):
                y = bn_mod.bn_apply(x, k, b, act)
                ref = bn_mod.bn_apply_reference(x, k, b, act)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs()
                bound = bn_mod.one_ulp_bound(x, k, b)
                ulps = float((err / bound.clamp_min(1e-30)).max())
                abs_err = float(err.max())
                max_abs[dtype] = max(max_abs.get(dtype, 0.0), abs_err)
                print('kernel_check shape=%s dtype=%s act=%s '
                      'grid_passes=%d max_abs_err=%r max_err_ulps=%.3f'
                      % (tuple(x.shape), str(dtype)[6:], act,
                         _grid_passes(x), abs_err, ulps))
                check(bool((err <= bound).all()),
                      'bn_apply differs from its plain version by more '
                      'than 1 ulp at %s %s act=%s' % (tuple(x.shape), dtype,
                                                      act))
            del x, y, ref, err, bound
        del x32
    return passes


def phase_kernel_vs_plain():
    """bn_apply vs bn_apply_reference at every ResNet-50 BN shape, at each
    batch and dtype of BN_CHECKS, act None and relu. Tolerance:
    1 ulp (one_ulp_bound). At least one case must take the kernel's
    grid-stride loop through more than one pass."""
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    max_abs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    passes = max(_bn_vs_plain(batch, BN_SHAPES, dtypes, gen, max_abs)
                 for batch, dtypes in BN_CHECKS)
    check(passes > 1, 'no check took bn_apply\'s grid-stride loop through '
          'a second pass')
    return max_abs


def phase_kernel_bwd_vs_plain():
    """BnApplyFunction's dx, dk, db (the kernel's forward, then the plain
    backward ported from pallas_bn.py:68) vs autograd through
    bn_apply_reference, both on the card, at every ResNet-50 BN shape, at
    each batch and dtype of BN_CHECKS, act None and relu.
    Tolerances:
    bn_mod.backward_bounds (dx is one multiply: one rounding of x's dtype;
    dk and db are f32 sums of L = N·H·W terms: L·2^-24 of the sum of
    their magnitudes, plus the rounding of the plain version's gradients
    to x's dtype; with relu, the terms where the masks differ, which may
    happen only where the plain |y| is within the forward's one-ulp
    bound)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 14)
    worst = collections.defaultdict(float)
    max_abs = collections.defaultdict(float)
    shapes = [((batch, c, h, w), dtypes) for batch, dtypes in BN_CHECKS
              for (c, h, w), _ in BN_SHAPES]
    for shape, dtypes in shapes:
        c = shape[1]
        x32 = torch.randn(shape, device='cuda', generator=gen)
        dy32 = torch.randn(shape, device='cuda', generator=gen)
        k = torch.rand(c, device='cuda', generator=gen) + 0.5
        b = torch.randn(c, device='cuda', generator=gen)
        for dtype in dtypes:
            x, dy = x32.to(dtype), dy32.to(dtype)
            for act in (None, 'relu'):
                out = []
                for fn in (bn_mod.bn_apply, bn_mod.bn_apply_reference):
                    leaves = [t.detach().clone().requires_grad_()
                              for t in (x, k, b)]
                    y = fn(*leaves, act)
                    out.append((y.detach(),) + torch.autograd.grad(
                        y, leaves, dy))
                (y, dx, dk, db), (ry, rdx, rdk, rdb) = out
                differ, dx_tol, dk_tol, db_tol = bn_mod.backward_bounds(
                    x, k, b, dy, y, ry, rdk, rdb, act)
                where = '%s %s act=%s' % (shape, dtype, act)
                check(bool((ry.float().abs()[differ] <= bn_mod.one_ulp_bound(
                    x, k, b)[differ]).all()), 'bn_apply relu masks differ '
                      'beyond the forward bound at ' + where)
                ratios = {}
                for name, got, ref, tol in (
                        ('dx', dx, rdx, dx_tol), ('dk', dk, rdk, dk_tol),
                        ('db', db, rdb, db_tol)):
                    err = (got.float() - ref.float()).abs()
                    if name == 'dx':
                        err = err.masked_fill(differ, 0)
                    ratios[name] = float((err / tol.clamp_min(1e-30)).max())
                    worst[name, dtype] = max(worst[name, dtype], ratios[name])
                    max_abs[name, dtype] = max(max_abs[name, dtype],
                                               float(err.max()))
                    check(bool((err <= tol).all()), 'bn_apply %s differs '
                          'from its plain version at %s' % (name, where))
                print('kernel_bwd_check shape=%s dtype=%s act=%s '
                      'grid_passes=%d masks_differ=%d %s' % (
                          shape, str(dtype)[6:], act, _grid_passes(x),
                          int(differ.sum()), ' '.join(
                              '%s_err/tol=%.3g' % kv
                              for kv in ratios.items())))
    worst = {'%s/%s' % (n, str(d)[6:]): r for (n, d), r in worst.items()}
    print('kernel_bwd_check worst err/tol: %s' % json.dumps(worst))
    return {'%s/%s' % (n, str(d)[6:]): e for (n, d), e in max_abs.items()}, \
        worst


def build_and_save(dirname):
    """Full-width ResNet-50, initialized on the card by the startup
    program, with random BN running stats and affine params (so every BN
    apply does real work), saved as an inference model."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data('data', shape=[3, 224, 224], dtype='float32')
        logits = resnet_imagenet(img, class_dim=1000, depth=50,
                                 is_train=False)
    bn_ops = [op for op in main.global_block().ops if op.type == 'batch_norm']
    check(len(bn_ops) == 53, 'ResNet-50 has %d batch_norm ops' % len(bn_ops))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    with fluid.scope_guard(scope):
        exe.run(startup)
        for op in bn_ops:
            for slot, lo, hi in (('Scale', 0.5, 1.5), ('Bias', -0.2, 0.2),
                                 ('Mean', -0.2, 0.2), ('Variance', 0.5, 2.0)):
                name = op.input(slot)[0]
                t = scope.get(name)
                scope.set(name, lo + (hi - lo) * torch.rand(
                    t.shape, device=t.device, generator=gen))
        fluid.io.save_inference_model(dirname, ['data'], [logits], exe, main)
    n_params = sum(int(np.prod(v.shape)) for v in main.list_vars()
                   if v.persistable)
    return len(bn_ops), n_params


WRAPPERS = {'bn_apply': bn_mod.bn_apply,
            'flash_attn_fwd': fa.flash_attn_fwd,
            'flash_attn_bwd_dkv': fa.flash_attn_bwd_dkv,
            'flash_attn_bwd_dq': fa.flash_attn_bwd_dq}


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.launches_by_dtype = dict.fromkeys(fn.launches_by_dtype, 0)
        if hasattr(fn, 'launches_by_causal'):
            fn.launches_by_causal = dict.fromkeys(fn.launches_by_causal, 0)


def read_launches():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def read_launches_by_dtype():
    return {name: dict(fn.launches_by_dtype)
            for name, fn in WRAPPERS.items()}


def read_launches_by_causal():
    """The K2 wrappers' launch counts by their causal flag."""
    return {name: dict(fn.launches_by_causal)
            for name, fn in WRAPPERS.items()
            if hasattr(fn, 'launches_by_causal')}


def phase_serving(dirname, n_bn):
    """Serve requests at batch 1, 8, 16 through the Predictor; every request
    must launch the BN kernel once per batch_norm op, and no other kernel
    of the port."""
    pred = fluid.inference.create_predictor(fluid.inference.Config(dirname))
    check(pred.get_input_names() == ['data'], 'input names')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    images = {bs: torch.randn(bs, 3, 224, 224, device='cuda', generator=gen)
              for bs in BATCHES}
    for bs in BATCHES:   # warm-up: cuDNN picks its algorithms
        pred.warmup([images[bs]])
    torch.cuda.synchronize()

    reset_launches()
    requests = 0
    lat = {}
    for bs in BATCHES:
        times = []
        for _ in range(LATENCY_REQUESTS):
            before = bn_mod.bn_apply.launches
            t0 = time.perf_counter()
            out, = pred.run([images[bs]], return_numpy=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            requests += 1
            check(bn_mod.bn_apply.launches - before == n_bn,
                  'a batch-%d request launched bn_apply %d times, not %d'
                  % (bs, bn_mod.bn_apply.launches - before, n_bn))
        check(tuple(out.shape) == (bs, 1000), 'output shape %s' % (
            tuple(out.shape),))
        check(bool(torch.isfinite(out).all()), 'non-finite logits')
        lat[bs] = times
    t0 = time.perf_counter()
    for _ in range(THROUGHPUT_REQUESTS):
        out, = pred.run([images[16]], return_numpy=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    requests += THROUGHPUT_REQUESTS
    counts = read_launches()
    launches = counts['bn_apply']
    check(launches == n_bn * requests,
          'bn_apply launched %d times over %d requests' % (launches, requests))
    check(counts['flash_attn_fwd'] == counts['flash_attn_bwd_dkv']
          == counts['flash_attn_bwd_dq'] == 0,
          'ResNet-50 launched a flash-attention kernel: %s' % counts)
    print('serving requests=%d bn_apply_launches=%d (%d per request)'
          % (requests, launches, launches // requests))
    for bs in BATCHES:
        print('serving batch=%d p50_ms=%r p90_ms=%r (host clock, %d requests,'
              ' each ending in a sync)' % (
                  bs, float(np.percentile(lat[bs], 50)) * 1e3,
                  float(np.percentile(lat[bs], 90)) * 1e3, len(lat[bs])))
    print('serving batch=16 img_per_s=%r (%d back-to-back requests, one sync)'
          % (16 * THROUGHPUT_REQUESTS / dt, THROUGHPUT_REQUESTS))
    return pred, images, counts


def phase_cpu_agreement(dirname, pred, images):
    """GPU logits vs the port's CPU logits at batch 1, same directory.
    TF32 is off, so both sides are f32; they sum the convolutions in
    different orders through ~50 layers, so the tolerance is 1e-3 of the
    largest logit."""
    cpu = fluid.inference.create_predictor(
        fluid.inference.Config(dirname).disable_gpu())
    want, = cpu.run([images[1].cpu().numpy()])
    got, = pred.run([images[1]])
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print('gpu_vs_cpu batch=1 max_abs_err=%r max_abs_logit=%r rel=%r '
          'tolerance_rel=1e-3' % (err, scale, err / scale))
    check(np.isfinite(got).all() and err <= 1e-3 * scale,
          'GPU and CPU logits differ: %r of %r' % (err, scale))


def _time_ms(fn, inputs, spin_cycles=SPIN_CYCLES):
    """Device ms of one fn call, CUDA events around KERNEL_REPS calls,
    cycling over `inputs` so each call reads x from HBM rather than L2.
    A spin kernel holds the card while the host enqueues the calls, so the
    events time them back to back on the card, not the host's launch rate.
    Where the host outlasts the spin (it was blocked: an implicit sync in
    fn, such as a cudaMalloc), the events would time the host, so the call
    is measured instead as the device's busy time per call under
    torch.profiler (`_busy_ms`), and a line says so."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    spin0, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    t0 = time.perf_counter()
    spin0.record()
    torch.cuda._sleep(spin_cycles)
    start.record()
    for i in range(KERNEL_REPS):
        fn(inputs[i % len(inputs)])
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    spin_ms = spin0.elapsed_time(start)
    if host_ms < spin_ms:
        return start.elapsed_time(end) / KERNEL_REPS
    busy = _busy_ms(fn, inputs)
    print('timing: host enqueue %.2f ms outlasted the spin %.2f ms; the next '
          'time is device busy ms per call under torch.profiler: %r'
          % (host_ms, spin_ms, busy))
    return busy


def _busy_ms(fn, inputs):
    """Device busy ms per fn call: the CUDA kernels' own time under
    torch.profiler over KERNEL_REPS calls (gaps between kernels excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(KERNEL_REPS):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    check(busy_us > 0, 'the profiler saw no device time')
    return busy_us * 1e-3 / KERNEL_REPS


def phase_kernel_times(batch=BN_BATCH, dtype=torch.float32, shapes=BN_SHAPES,
                       what='ResNet-50'):
    """bn_apply, its plain version and torch.addcmul at each (C, ...) BN
    shape of `shapes` (ResNet-50's by default, act None as the model runs
    it; batch 16 f32 as served, batch 256 bf16 as AMP training runs it),
    beside the shape's bound: max(bytes / HBM rate, operations / f32
    rate), x read and y written in `dtype`, k and b read in f32."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 4)
    size = dtype.itemsize
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for shape, count in shapes:
        c = shape[0]
        numel = batch * int(np.prod(shape))
        copies = max(2, math.ceil(2 * L2_BYTES / (numel * size)))
        xs = [torch.randn((batch,) + tuple(shape), device='cuda',
                          generator=gen).to(dtype) for _ in range(copies)]
        k = torch.rand(c, device='cuda', generator=gen) + 0.5
        b = torch.randn(c, device='cuda', generator=gen)
        k4, b4 = (t.to(dtype).view((1, c) + (1,) * (len(shape) - 1))
                  for t in (k, b))
        before = bn_mod.bn_apply.launches
        ms = _time_ms(lambda x: bn_mod.bn_apply(x, k, b), xs)
        check(bn_mod.bn_apply.launches - before == KERNEL_REPS + 2,
              'timing loop did not launch the kernel')
        plain = _time_ms(lambda x: bn_mod.bn_apply_reference(x, k, b), xs)
        lib = _time_ms(lambda x: torch.addcmul(b4, x, k4), xs)
        nbytes = 2 * numel * size + 2 * c * 4
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * numel / F32_OPS_PER_S) * 1e3
        print('kernel_time shape=%s dtype=%s count=%d kernel_ms=%r '
              'bound_ms=%r plain_ms=%r library_ms=%r bound_share=%.3f' % (
                  (batch,) + tuple(shape), str(dtype)[6:], count, ms, bound,
                  plain, lib, bound / ms))
        for key, v in (('ms', ms), ('plain_ms', plain), ('library_ms', lib),
                       ('bound_ms', bound)):
            totals[key] += count * v
        del xs
    print('kernel_time all %d BN applies of one batch-%d %s %s pass: %s'
          % (sum(n for _, n in shapes), batch, str(dtype)[6:], what,
             json.dumps(totals)))
    return totals


def phase_profile(pred, images):
    """Device time by kernel over 3 batch-16 ResNet-50 requests."""
    _profile(lambda: pred.run([images[16]], return_numpy=False),
             'resnet50 batch=16', 'requests')


# kernel-name fragments of cuDNN's convolutions (with their layout
# transposes) and cuBLAS's GEMMs, for the profiles' library share
_LIBRARY_KERNELS = ('cudnn', 'xmma', 'gemm', 'cutlass', 'nvjet', 'wgrad',
                    'dgrad', 'fprop', 'sm80_', 'sm90_')


def _profile(run_once, label, what, calls=3):
    """Device time by kernel over `calls` calls of run_once
    (torch.profiler; only the CUDA kernels' own rows, so no op is counted
    twice), each kernel with the torch ops that launched it. Returns
    {kernel name: device ms} over the calls, or None where the trace holds
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print('profile %s: no device time in the trace (not measured)'
              % label)
        return None
    ops = collections.defaultdict(collections.Counter)
    for e in prof.events():
        for k in e.kernels:
            ops[k.name][e.name] += 1
    busy_s = sum(r[0] for r in rows) * 1e-6
    library = sum(r[0] for r in rows if any(
        t in r[2] for t in _LIBRARY_KERNELS)) * 1e-6
    print('profile %s %d %s (profiler on): wall_ms=%r '
          'device_busy_ms=%r idle_share=%.3f cudnn_cublas_share=%.3f' % (
              label, calls, what, wall * 1e3, busy_s * 1e3,
              max(0.0, 1 - busy_s / wall), library / busy_s))
    for dev_us, count, key in rows[:12]:
        print('profile %s kernel=%r calls=%d device_ms=%r share=%.3f ops=%s'
              % (label, key[:160], count, dev_us * 1e-3,
                 dev_us * 1e-6 / busy_s, dict(ops[key])))
    return {key: dev_us * 1e-3 for dev_us, _, key in rows}


def _qkv(b, h, sq, sk, d, dtype, gen):
    """q, k, v as [B, H, S, D] views of [B, S, H, D] memory: the strides
    the head split hands the kernel."""
    def one(s):
        return torch.randn(b, s, h, d, device='cuda', generator=gen).to(
            dtype).permute(0, 2, 1, 3)
    return one(sq), one(sk), one(sk)


def phase_flash_vs_plain():
    """flash_attn_fwd vs flash_attention_reference at K2_CASES, f32 and
    bf16, scale D**-0.5. Tolerance: fa.tolerance, 1e-5 * max|v| in f32
    (summation order and the 3xTF32 products) and 2**-6 * max|v| in bf16
    (the plain version rounds q*scale and the scores to bf16, the kernel
    does not). A second launch on the same inputs must give the same bits
    (no atomics)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
    max_abs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, h, sq, sk, d, causal in K2_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(b, h, sq, sk, d, dtype, gen)
            out = fa.flash_attn_fwd(q, k, v, causal, d ** -0.5)
            again = fa.flash_attn_fwd(q, k, v, causal, d ** -0.5)
            ref = fa.flash_attention_reference(q, k, v, causal, d ** -0.5)
            torch.cuda.synchronize()
            check(torch.equal(out, again), 'flash_attn_fwd differs between '
                  'two launches at %s causal=%s %s' % ((b, h, sq, sk, d),
                                                       causal, dtype))
            err = float((out.float() - ref.float()).abs().max())
            tol = fa.tolerance(v)
            max_abs[dtype] = max(max_abs[dtype], err)
            print('k2_check shape=%s causal=%s dtype=%s max_abs_err=%r '
                  'tolerance=%r' % ((b, h, sq, sk, d), causal,
                                    str(dtype)[6:], err, tol))
            check(tuple(out.shape) == (b, h, sq, d) and out.dtype == dtype,
                  'flash_attn_fwd output %s %s' % (tuple(out.shape),
                                                   out.dtype))
            check(err <= tol, 'flash_attn_fwd differs from its plain version '
                  'by %r > %r at %s causal=%s %s' % (
                      err, tol, (b, h, sq, sk, d), causal, dtype))
    return max_abs


def build_and_save_bert(dirname):
    """Full-width BERT-base at S=512, initialized on the card by the
    startup program (seeded), its layer_norm scales and shifts set to
    random values, saved as an inference model of the masked-LM logits."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, logits = bert_mlm_logits(**BERT)
    ops = main.global_block().ops
    n_fused = sum(op.type == 'fused_multihead_attention' for op in ops)
    check(n_fused == BERT['n_layer'],
          'BERT-base has %d fused_multihead_attention ops' % n_fused)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    with fluid.scope_guard(scope):
        exe.run(startup)
        for p in main.all_parameters():
            if p.name.startswith('layer_norm_'):
                lo = 0.5 if p.name.endswith('.w_0') else -0.2
                t = scope.get(p.name)
                scope.set(p.name, lo + torch.rand(
                    t.shape, device=t.device, generator=gen))
        fluid.io.save_inference_model(dirname, [f[0] for f in feeds],
                                      [logits], exe, main)
    n_params = sum(int(np.prod(v.shape)) for v in main.list_vars()
                   if v.persistable)
    return len(ops), n_fused, n_params


def _bert_feed(bs, gen):
    s = BERT['max_len']
    return [torch.randint(0, BERT['vocab'], (bs, s), device='cuda',
                          generator=gen),
            torch.randint(0, 2, (bs, s), device='cuda', generator=gen)]


def phase_bert_serving(dirname, n_fused):
    """Serve BERT-base requests at batch 1 and 8 through the Predictor:
    latency of requests that each end in a sync (return_numpy=False, so no
    device-to-host copy of the logits is timed), tokens/s of back-to-back
    batch-8 requests, one numpy return timed on its own. Every request must
    launch flash_attn_fwd once per layer, and bn_apply never."""
    pred = fluid.inference.create_predictor(fluid.inference.Config(dirname))
    check(pred.get_input_names() == ['tok_ids', 'seg_ids'], 'input names')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 7)
    feeds = {bs: _bert_feed(bs, gen) for bs in BERT_BATCHES}
    for bs in BERT_BATCHES:
        pred.warmup(feeds[bs])
    torch.cuda.synchronize()

    reset_launches()
    requests = 0
    lat = {}
    s, vocab = BERT['max_len'], BERT['vocab']
    for bs in BERT_BATCHES:
        times = []
        for _ in range(BERT_LATENCY_REQUESTS):
            before = fa.flash_attn_fwd.launches
            t0 = time.perf_counter()
            out, = pred.run(feeds[bs], return_numpy=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            requests += 1
            check(fa.flash_attn_fwd.launches - before == n_fused,
                  'a batch-%d BERT request launched flash_attn_fwd %d times, '
                  'not %d' % (bs, fa.flash_attn_fwd.launches - before,
                              n_fused))
        check(tuple(out.shape) == (bs * s, vocab), 'logits shape %s' % (
            tuple(out.shape),))
        check(bool(torch.isfinite(out).all()), 'non-finite logits')
        lat[bs] = times
    bs = BERT_BATCHES[-1]
    t0 = time.perf_counter()
    for _ in range(BERT_THROUGHPUT_REQUESTS):
        out, = pred.run(feeds[bs], return_numpy=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    requests += BERT_THROUGHPUT_REQUESTS
    counts = read_launches()
    launches = counts['flash_attn_fwd']
    check(launches == n_fused * requests,
          'flash_attn_fwd launched %d times over %d requests'
          % (launches, requests))
    check(counts['bn_apply'] == counts['flash_attn_bwd_dkv']
          == counts['flash_attn_bwd_dq'] == 0,
          'BERT serving launched bn_apply or a backward kernel: %s' % counts)
    print('bert_serving requests=%d flash_attn_fwd_launches=%d (%d per '
          'request)' % (requests, launches, launches // requests))
    for b in BERT_BATCHES:
        print('bert_serving batch=%d S=%d p50_ms=%r p90_ms=%r (host clock, '
              '%d requests, return_numpy=False, each ending in a sync)' % (
                  b, s, float(np.percentile(lat[b], 50)) * 1e3,
                  float(np.percentile(lat[b], 90)) * 1e3, len(lat[b])))
    print('bert_serving batch=%d tokens_per_s=%r (%d back-to-back requests, '
          'one sync)' % (bs, bs * s * BERT_THROUGHPUT_REQUESTS / dt,
                         BERT_THROUGHPUT_REQUESTS))
    t0 = time.perf_counter()
    host, = pred.run(feeds[bs])
    print('bert_serving batch=%d one request with return_numpy=True '
          '(includes the %.0f MB device-to-host copy of the logits): ms=%r'
          % (bs, host.nbytes / 1e6, (time.perf_counter() - t0) * 1e3))
    return pred, feeds, counts


def phase_bert_cpu_agreement(dirname, pred, feeds):
    """GPU logits vs the port's CPU logits at batch 1, same directory.
    f32 on both sides with TF32 off; the matmuls and the attention sum in
    different orders through 12 layers, so the tolerance is 1e-3 of the
    largest logit, as for ResNet-50."""
    cpu = fluid.inference.create_predictor(
        fluid.inference.Config(dirname).disable_gpu())
    want, = cpu.run([t.cpu().numpy() for t in feeds[1]])
    got, = pred.run(feeds[1])
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print('bert_gpu_vs_cpu batch=1 max_abs_err=%r max_abs_logit=%r rel=%r '
          'tolerance_rel=1e-3' % (err, scale, err / scale))
    check(np.isfinite(got).all() and err <= 1e-3 * scale,
          'BERT GPU and CPU logits differ: %r of %r' % (err, scale))


def _score_pairs(sq, sk, causal):
    """The (query, key) pairs an attention computes: all Sq·Sk, or with
    causal those that the mask keeps (query i sees the keys j <= i + Sk -
    Sq): the least work of a kernel that skips the masked keys."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def phase_flash_times():
    """flash_attn_fwd, its plain version and scaled_dot_product_attention
    at K2_TIME_CASES, beside the bound: max(bytes of q, k, v, o / HBM rate,
    4·B·H·D operations for each (query, key) pair the mask keeps
    (_score_pairs) / the dtype's peak rate: the tensor cores' bf16 rate,
    and for f32 the 3xTF32 rate, a third of TF32's), with the f32
    CUDA-core bound beside it, the kernel's TFLOP/s and its time as a
    ratio to SDPA's (is_causal as the case)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 8)
    rows = {}
    for b, h, s, d, causal, dtypes in K2_TIME_CASES:
        scale = d ** -0.5
        for dtype in dtypes:
            peak = BF16_OPS_PER_S if dtype == torch.bfloat16 \
                else F32_3XTF32_OPS_PER_S
            size = dtype.itemsize
            nbytes = 4 * b * h * s * d * size
            copies = max(2, math.ceil(2 * L2_BYTES / (3 * b * h * s * d
                                                      * size)))
            sets = [_qkv(b, h, s, s, d, dtype, gen) for _ in range(copies)]
            before = fa.flash_attn_fwd.launches
            ms = _time_ms(lambda t: fa.flash_attn_fwd(*t, causal, scale),
                          sets)
            check(fa.flash_attn_fwd.launches - before == KERNEL_REPS + 2,
                  'timing loop did not launch the kernel')
            plain = _time_ms(lambda t: fa.flash_attention_reference(
                *t, causal, scale), sets)
            lib = _time_ms(lambda t: F.scaled_dot_product_attention(
                *t, is_causal=causal, scale=scale), sets)
            ops = 4 * b * h * d * _score_pairs(s, s, causal)
            bound = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
            by = 'operations' if ops / peak > nbytes / HBM_BYTES_PER_S \
                else 'bytes'
            key = (b, h, s, d, causal, str(dtype)[6:])
            rows[key] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=by,
                             tflops=ops / ms * 1e-9, vs_sdpa=ms / lib)
            cuda_core = ''
            if dtype == torch.float32:
                rows[key]['cuda_core_bound_ms'] = max(
                    nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
                cuda_core = ' cuda_core_bound_ms=%r' % (
                    rows[key]['cuda_core_bound_ms'])
            print('k2_time shape=%s causal=%s dtype=%s kernel_ms=%r '
                  'bound_ms=%r (%s) plain_ms=%r sdpa_ms=%r bound_share=%.3f '
                  'tflops=%.2f kernel/sdpa=%.3f%s' % (
                      (b, h, s, s, d), causal, key[-1], ms, bound, by, plain,
                      lib, bound / ms, ops / ms * 1e-9, ms / lib, cuda_core))
            del sets
    return rows


def phase_bert_profile(pred, feeds):
    """Device time by kernel over 3 batch-8 BERT requests."""
    feed = feeds[BERT_BATCHES[-1]]
    _profile(lambda: pred.run(feed, return_numpy=False),
             'bert batch=%d S=%d' % (BERT_BATCHES[-1], BERT['max_len']),
             'requests')


def _bwd_inputs(b, h, sq, sk, d, dtype, gen):
    """q, k, v and dO as [B, H, S, D] views of [B, S, H, D] memory: the
    strides the head split and the head merge's gradient hand the
    kernels."""
    q, k, v = _qkv(b, h, sq, sk, d, dtype, gen)
    do = torch.randn(b, sq, h, d, device='cuda', generator=gen).to(
        dtype).permute(0, 2, 1, 3)
    return q, k, v, do


def phase_flash_bwd_vs_plain():
    """K2-fwd's log-sum-exp, K2-bwd-dkv and K2-bwd-dq vs their plain
    versions at K2_BWD_CASES, f32 and bf16, scale D**-0.5, the kernel's lse
    and di = rowsum(dO·O) fed to both. Tolerance: fa.grad_tolerance for dQ,
    dK and dV (1e-5 of the largest value in f32, 2**-7 in bf16; its
    docstring says why) and 1e-5 of the largest |lse|. A second launch of
    each backward kernel on the same inputs must give the same bits (no
    atomics).
    Then one FlashAttention forward and backward on the card, f32, at the
    batch-1 BERT-base shape, against the same function evaluated in float64
    on the CPU (_attention_f64), within 1e-5 of each tensor's largest value.
    The port's CPU path (FlashAttention on CPU tensors, f32) is printed
    against the same float64 values: its f32 arithmetic is the host's (its
    BLAS and its matmul precision), and tests/test_torch_attention.py holds
    it against the JAX op."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 9)
    max_abs = collections.defaultdict(float)
    for b, h, sq, sk, d, causal in K2_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = _bwd_inputs(b, h, sq, sk, d, dtype, gen)
            scale = d ** -0.5
            out, lse = fa.flash_attn_fwd(q, k, v, causal, scale,
                                         return_lse=True)
            di = (do.float() * out.float()).sum(-1)
            dk, dv = fa.flash_attn_bwd_dkv(q, k, v, do, lse, di, causal,
                                           scale)
            dq = fa.flash_attn_bwd_dq(q, k, v, do, lse, di, causal, scale)
            again = fa.flash_attn_bwd_dkv(q, k, v, do, lse, di, causal,
                                          scale) + (fa.flash_attn_bwd_dq(
                                              q, k, v, do, lse, di, causal,
                                              scale),)
            torch.cuda.synchronize()
            for name, first, second in zip(('dk', 'dv', 'dq'), (dk, dv, dq),
                                           again):
                check(torch.equal(first, second), 'K2 backward %s differs '
                      'between two launches at %s causal=%s %s' % (
                          name, (b, h, sq, sk, d), causal, dtype))
            ref_lse = fa.flash_attention_reference_lse(q, k, causal, scale)
            ref_dk, ref_dv = fa.flash_attn_bwd_dkv_reference(
                q, k, v, do, lse, di, causal, scale)
            ref_dq = fa.flash_attn_bwd_dq_reference(q, k, v, do, lse, di,
                                                    causal, scale)
            line = []
            for name, got, ref, tol in (
                    ('lse', lse, ref_lse,
                     1e-5 * float(ref_lse.abs().max())),
                    ('dq', dq, ref_dq, fa.grad_tolerance(ref_dq)),
                    ('dk', dk, ref_dk, fa.grad_tolerance(ref_dk)),
                    ('dv', dv, ref_dv, fa.grad_tolerance(ref_dv))):
                check(got.shape == ref.shape and got.dtype == ref.dtype,
                      '%s: %s %s, plain %s %s' % (name, tuple(got.shape),
                                                  got.dtype,
                                                  tuple(ref.shape),
                                                  ref.dtype))
                err = float((got.float() - ref.float()).abs().max())
                max_abs[name, dtype] = max(max_abs[name, dtype], err)
                line.append('%s_err=%r tol=%r' % (name, err, tol))
                check(err <= tol, 'K2 backward %s differs from its plain '
                      'version by %r > %r at %s causal=%s %s' % (
                          name, err, tol, (b, h, sq, sk, d), causal, dtype))
            print('k2_bwd_check shape=%s causal=%s dtype=%s %s' % (
                (b, h, sq, sk, d), causal, str(dtype)[6:], ' '.join(line)))

    b, h, s, d = 1, BERT['n_head'], BERT['max_len'], 64
    q, k, v, do = _bwd_inputs(b, h, s, s, d, torch.float32, gen)
    results = []
    for device in ('cuda', 'cpu'):
        leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = fa.FlashAttention.apply(*leaves, False, d ** -0.5)
        out.backward(do.to(device))
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    exact = _attention_f64(q, k, v, do, d ** -0.5)
    for name, got, cpu, want in zip(('out', 'dq', 'dk', 'dv'), *results,
                                    exact):
        err = float((got.double() - want).abs().max())
        cpu_err = float((cpu.double() - want).abs().max())
        scale_ = float(want.abs().max())
        print('k2_autograd_gpu_vs_f64 shape=%s %s max_abs_err=%r max_abs=%r '
              'err/tol=%.3g tolerance_rel=1e-5 cpu_f32_max_abs_err=%r' % (
                  (b, h, s, d), name, err, scale_, err / (1e-5 * scale_),
                  cpu_err))
        check(err <= 1e-5 * scale_, 'FlashAttention %s on the card differs '
              'from its float64 evaluation by %r of %r' % (name, err, scale_))
    return max_abs


def _attention_f64(q, k, v, do, scale):
    """O = softmax(scale·q·kᵀ)·v and its dQ, dK, dV for the output gradient
    dO, in float64 on the CPU: the exact values the f32 paths approximate."""
    q, k, v, do = (t.detach().cpu().double() for t in (q, k, v, do))
    p = torch.softmax(torch.einsum('bhqd,bhkd->bhqk', q, k) * scale, dim=-1)
    out = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * out).sum(-1, keepdim=True))
    ds = ds * scale
    return out, ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def _mark(main, amp):
    """enable_bf16(main) for an AMP path, as bench.py marks its programs."""
    if amp:
        mixed_precision.enable_bf16(main)
    return main


def build_bert_training(amp=False, checkpoints=None):
    """Full-width BERT-base pretraining at S=512: the masked-LM loss and
    Adam(lr 1e-4).minimize, dropout 0, seeded initialization; with amp,
    marked for bf16 by contrib.mixed_precision.enable_bf16; with
    `checkpoints` (True: each layer's output), remat segments
    (passes/recompute.py)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss = build_bert_pretrain(dropout=0.0, lr=1e-4,
                                      checkpoints=checkpoints, **BERT)
    return _mark(main, amp), startup, loss


def _train_feed(bs, gen):
    """One masked-LM batch: random tokens and segments, random labels, 15%
    of the positions weighted."""
    s, vocab = BERT['max_len'], BERT['vocab']
    return {'tok_ids': torch.randint(0, vocab, (bs, s), device='cuda',
                                     generator=gen),
            'seg_ids': torch.randint(0, 2, (bs, s), device='cuda',
                                     generator=gen),
            'mlm_labels': torch.randint(0, vocab, (bs, s), device='cuda',
                                        generator=gen),
            'mlm_weights': (torch.rand(bs, s, device='cuda', generator=gen)
                            < 0.15).float()}


def _precision(amp):
    return 'bf16' if amp else 'f32'


def _check_amp_dtypes(label, main, scope, fetched):
    """The reference's dtypes on the card (paddle_tpu/core/amp.py): the loss
    and every <param>@GRAD fetched from a step are f32, and so is every
    float persistable (parameters, optimizer and BN state) in the scope
    after it."""
    bad = [(n, str(t.dtype)) for n, t in fetched.items()
           if t.dtype != torch.float32]
    for v in main.list_vars():
        t = scope.get(v.name) if v.persistable else None
        if t is not None and t.is_floating_point() \
                and t.dtype != torch.float32:
            bad.append((v.name, str(t.dtype)))
    check(not bad, '%s: tensors that should be f32 are not: %s'
          % (label, bad[:10]))
    print('%s dtypes: loss and %d parameter gradients f32; every float '
          'persistable f32' % (label, len(fetched) - 1))


def _by_dtype_step(before, after):
    return {name: {dt: after[name][dt] - before[name][dt]
                   for dt in after[name]} for name in after}


def phase_bert_training(main, startup, loss, amp=False):
    """Train BERT-base on the card: TRAIN_WARMUP_STEPS, then TRAIN_STEPS
    timed steps (host clock around Executor.run and a sync), all on one
    fixed batch of TRAIN_BATCH. The loss is finite at every step and lower
    at the last than at the first; every timed step launches each backward
    kernel once per layer, flash_attn_fwd twice per layer (the forward op
    and the grad op's recomputed forward) and bn_apply never, every launch
    in the path's dtype (bf16 with amp). With amp, the last warm-up step
    also fetches every parameter gradient for the dtype gate, which also
    reads the state after the warm-up steps."""
    label = 'bert_training' + ('_bf16' if amp else '')
    ops = main.global_block().ops
    n_layer = BERT['n_layer']
    for t in ('fused_multihead_attention', 'fused_multihead_attention_grad'):
        n = sum(op.type == t for op in ops)
        check(n == n_layer, 'the training program has %d %s ops' % (n, t))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 10)
    feed = _train_feed(TRAIN_BATCH, gen)
    grads = [p.name + '@GRAD' for p in main.all_parameters()] if amp else []
    losses = []
    exe.run(startup, scope=scope)
    for i in range(TRAIN_WARMUP_STEPS):
        out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[loss] + (
                          grads if i == TRAIN_WARMUP_STEPS - 1 else []))
        losses.append(float(out[0].reshape(-1)[0]))
    if amp:
        _check_amp_dtypes(label, main, scope, dict(zip([loss.name] + grads,
                                                       out)))
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dtype = 'bfloat16' if amp else 'float32'
    want = {'bn_apply': 0, 'flash_attn_fwd': 2 * n_layer,
            'flash_attn_bwd_dkv': n_layer, 'flash_attn_bwd_dq': n_layer}
    reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        before, before_dt = read_launches(), read_launches_by_dtype()
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = read_launches()
        step = {k: after[k] - before[k] for k in after}
        check(step == want, 'a training step launched %s, not %s'
              % (step, want))
        by_dt = _by_dtype_step(before_dt, read_launches_by_dtype())
        check(all(by_dt[k][dtype] == want[k] for k in want),
              '%s: a step launched %s, not all %s' % (label, by_dt, dtype))
        losses.append(float(out.reshape(-1)[0]))
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), 'non-finite loss: %s'
          % losses)
    check(losses[-1] < losses[0], 'the loss did not fall: %s' % losses)
    tokens = TRAIN_BATCH * BERT['max_len']
    p50 = float(np.percentile(times, 50))
    print('%s batch=%d S=%d %s lr=1e-4 ops=%d losses=%s'
          % (label, TRAIN_BATCH, BERT['max_len'], _precision(amp), len(ops),
             json.dumps([round(x, 5) for x in losses])))
    print('%s launches over %d timed steps: %s (per step: %s; by dtype: %s)'
          % (label, TRAIN_STEPS, json.dumps(counts), json.dumps(want),
             json.dumps(read_launches_by_dtype())))
    print('%s step p50_ms=%r p90_ms=%r tokens_per_s=%r '
          'peak_allocated_gb=%.2f (host clock, %d steps, each ending in a '
          'sync)' % (label, p50 * 1e3, float(np.percentile(times, 90)) * 1e3,
                     tokens / p50, peak / 2 ** 30, TRAIN_STEPS))
    PEAKS[label] = peak
    return exe, scope, feed, counts


def _bert_training_profile(exe, main, loss, scope, feed, amp):
    """Device time by kernel over 3 BERT-base training steps, and K2's
    share (the flash-attention kernels' rows)."""
    per_kernel = _profile(
        lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                        return_numpy=False),
        'bert training %s batch=%d S=%d' % (_precision(amp), TRAIN_BATCH,
                                            BERT['max_len']), 'steps')
    if per_kernel:
        k2 = sum(ms for name, ms in per_kernel.items()
                 if 'flash_fwd_kernel' in name or 'flash_bwd_' in name)
        print('profile bert training %s: K2 device_ms_per_step=%r share=%.3f'
              % (_precision(amp), k2 / 3, k2 / sum(per_kernel.values())))


def phase_training_gpu_vs_cpu(main, startup, loss, amp=False):
    """One training step at full width, batch 1, from one initial state
    (the startup program run on the card, carried to a CPU scope with
    weights.py): the loss and the gradients of word_emb, the first layer's
    Q weight and the last layer_norm's scale, GPU against CPU.

    The tolerance of each is measured in the same run (_gpu_vs_cpu_step):
    the step is taken again on each side from the state moved by one ulp
    (f32, or bf16 with amp) in NOISE_DRAWS draws, and the GPU may differ
    from the CPU by at most 4 times the largest move of the tensor on the
    card plus the largest on the CPU, and never less than 1e-5 of its
    largest value. At random initialization the gradients that reach the
    bottom of the 12 layers (word_emb, the first Q weight) are
    ill-conditioned in f32: a one-ulp perturbation moves them by ~1e-3 to
    ~6e-3 of their largest value (CPU), while the head's layer_norm scale
    moves by ~1e-6. A fixed tolerance would be either too loose for the
    one or too tight for the others."""
    label = 'bert_training%s_gpu_vs_cpu' % ('_bf16' if amp else '')
    names = [loss.name, 'word_emb@GRAD', 'fc_0.w_0@GRAD',
             _last_layer_norm_scale(main) + '@GRAD']
    gen = torch.Generator(device='cuda').manual_seed(SEED + 11)
    worst = _gate_rows(label, 'batch=1', _gpu_vs_cpu_step(
        main, startup, names, _train_feed(1, gen), SEED + 13, amp))
    print('%s batch=1 worst err/tol=%.3f (%s)' % (label, worst[0], worst[1]))


def _last_layer_norm_scale(main):
    """The name of the program's last layer_norm scale."""
    return max((p.name for p in main.all_parameters()
                if p.name.startswith('layer_norm_')
                and p.name.endswith('.w_0')),
               key=lambda n: int(n.split('_')[2].split('.')[0]))


def _gate_rows(label, desc, rows):
    """Print each row of _gpu_vs_cpu_step and fail unless its GPU value is
    finite, of the CPU's shape and within its tolerance. Returns the worst
    (err/tol, name)."""
    worst = (0.0, '')
    for name, g, w, err, top, noise, tol in rows:
        print('%s %s %s shape=%s max_abs_err=%r max_abs=%r rel=%r '
              'one_ulp_noise=%r tolerance=%r' % (
                  label, desc, name, tuple(w.shape), err, top, err / top,
                  noise, tol))
        check(g.shape == w.shape and np.isfinite(g).all() and err <= tol,
              'GPU and CPU %s differ: %r > %r' % (name, err, tol))
        worst = max(worst, (err / tol, name))
    return worst


def _ulp_moved(a, rng, amp):
    """a moved by about one ulp of the path's compute dtype, at random:
    f32 scaled by 1 + 1e-7·N(0, 1); with amp, one bf16 ulp at each
    element's magnitude, up or down (a bf16 value lands on its neighbour,
    an f32 parameter on a value whose bf16 cast does). numpy arrays and
    torch tensors (bf16 ones too) alike; a tensor's draws are made where
    it lies, by a torch generator seeded from rng, so a large one (VGG-19
    has 144M parameters) never goes through numpy."""
    if isinstance(a, torch.Tensor):
        if not a.is_floating_point():
            return a
        gen = torch.Generator(device=a.device).manual_seed(
            int(rng.randint(2 ** 31)))
        x = a.float()
        if amp:
            m, e = torch.frexp(x)
            step = torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(x),
                                                        e - 8))
            sign = torch.randint(0, 2, x.shape, generator=gen,
                                 device=x.device) * 2 - 1
            return (x + sign * step).to(a.dtype)
        noise = torch.randn(x.shape, generator=gen, device=x.device)
        return (x * (1 + 1e-7 * noise)).to(a.dtype)
    if a.dtype.kind != 'f':
        return a
    if amp:
        m, e = np.frexp(a.astype(np.float64))
        step = np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))
        return (a + rng.choice([-1.0, 1.0], a.shape) * step).astype(a.dtype)
    return (a * (1 + 1e-7 * rng.randn(*a.shape))).astype(a.dtype)


def _perturbed(arrays, seed, amp=False, only=None):
    """Every float array or tensor (of the names in `only`, if given) moved
    by one ulp (_ulp_moved)."""
    rng = np.random.RandomState(seed)
    return {n: _ulp_moved(a, rng, amp) if only is None or n in only else a
            for n, a in arrays.items()}


def _gpu_vs_cpu_step(main, startup, names, feed, seed, amp=False,
                     only=None):
    """One training step from one initial state, the startup program run
    on the card and carried to CPU scopes with weights.py, fetching
    `names`: on the card and on the CPU, and on each again from the state
    moved by one ulp (_perturbed, f32 or with amp bf16; only the arrays
    named in `only`, if given) in NOISE_DRAWS draws from `seed`.
    Returns, for each name, (name, GPU value, CPU value, the largest
    |GPU - CPU|, the largest |CPU|, the noise: the largest
    move over the draws on the card plus the largest on the CPU, its
    tolerance: max(1e-5 of the largest |CPU|, 4 times the noise))."""
    gpu_scope = fluid.Scope()
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    cpu = fluid.Executor(fluid.CPUPlace())
    gpu.run(startup, scope=gpu_scope)
    state = fluid.weights.state_to_numpy(main, gpu_scope)
    del gpu_scope
    cpu_feed = {k: t.cpu() for k, t in feed.items()}
    runs = {}
    t0 = time.perf_counter()
    for i in range(NOISE_DRAWS + 1):
        st = state if i == 0 else _perturbed(state, seed + i, amp, only)
        for exe, device, fd in ((gpu, 'cuda', feed), (cpu, 'cpu', cpu_feed)):
            scope = fluid.Scope()
            fluid.weights.params_from_numpy(st, main, scope, device=device)
            runs[device, i] = exe.run(main, feed=fd, fetch_list=names,
                                      scope=scope)
    print('gpu_vs_cpu step %s: %d draws on each side, %.1f s' % (
        _precision(amp), NOISE_DRAWS, time.perf_counter() - t0))
    rows = []
    for j, name in enumerate(names):
        g, w = runs['cuda', 0][j], runs['cpu', 0][j]
        noise = sum(max(float(np.abs(runs[d, i][j] - runs[d, 0][j]).max())
                        for i in range(1, NOISE_DRAWS + 1))
                    for d in ('cuda', 'cpu'))
        err = float(np.abs(g - w).max())
        top = float(np.abs(w).max())
        rows.append((name, g, w, err, top, noise, max(1e-5 * top, 4 * noise)))
    return rows


def _dropout_program(amp, shape=DROPOUT_SHAPE):
    """x -> dropout(p=0.1, upscale_in_train) -> reduce_sum(out·w), with
    append_backward (so the dropout_grad op runs); x and w bf16 with amp.
    Returns (program, Out name, Mask name)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = SEED
    dtype = 'bfloat16' if amp else 'float32'
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data('x', shape=list(shape), dtype=dtype,
                              append_batch_size=False, stop_gradient=False)
        w = fluid.layers.data('w', shape=list(shape), dtype=dtype,
                              append_batch_size=False)
        out = fluid.layers.dropout(x, dropout_prob=DROPOUT_P,
                                   dropout_implementation='upscale_in_train')
        fluid.backward.append_backward(fluid.layers.reduce_sum(out * w))
    main._amp_bf16 = amp
    op = next(o for o in main.global_block().ops if o.type == 'dropout')
    return main, op.output('Out')[0], op.output('Mask')[0]


def _microbatch_masks():
    """The masks a dropout op draws in 2 steps of k=2 gradient merge on
    the card (fc -> dropout -> mean, SGD): [(step, microbatch, keep)]."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data('x', shape=[768], dtype='float32')
        h = fluid.layers.dropout(fluid.layers.fc(x, size=768),
                                 dropout_prob=DROPOUT_P)
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(0.1).minimize(loss)
    gradient_merge.enable(BENCH_K, main)
    drawn = []
    real = tensor_ops.draw_dropout_keep

    def record(ctx, shape, p):
        keep = real(ctx, shape, p)
        if ctx.device.type == 'cuda':
            drawn.append((ctx.interp.step, ctx.interp.micro, keep))
        return keep

    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 21)
    feed = {'x': torch.randn(BENCH_K * 64, 768, device='cuda',
                             generator=gen)}
    tensor_ops.draw_dropout_keep = record
    try:
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        tensor_ops.draw_dropout_keep = real
    return drawn


def phase_dropout_on_card():
    """dropout and dropout_grad on the card, f32 and bf16, at a
    microbatch's attention-weight shape: the keep share within 5σ of its
    binomial mean; Out == X·Mask·scale exactly (scale 1/(1-p) in x's
    dtype); Mask in x's dtype; dX == dOut·Mask·scale exactly, with the
    forward's Mask; a second step draws another mask, as does each
    microbatch of a gradient-merge step."""
    for amp in (False, True):
        dtype = torch.bfloat16 if amp else torch.float32
        main, out, mask = _dropout_program(amp)
        gen = torch.Generator(device='cuda').manual_seed(SEED + 20)
        x = torch.randn(DROPOUT_SHAPE, device='cuda', generator=gen).to(dtype)
        w = torch.randn(DROPOUT_SHAPE, device='cuda', generator=gen).to(dtype)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        o, m, dx = exe.run(main, feed={'x': x, 'w': w},
                           fetch_list=[out, mask, 'x@GRAD'],
                           scope=fluid.Scope(), return_numpy=False)
        check(o.dtype == m.dtype == dx.dtype == dtype,
              'dropout dtypes %s %s %s, not %s' % (o.dtype, m.dtype,
                                                   dx.dtype, dtype))
        n = m.numel()
        kept = int((m != 0).sum())
        sigma = (n * DROPOUT_P * (1 - DROPOUT_P)) ** 0.5
        z = (kept - n * (1 - DROPOUT_P)) / sigma
        check(abs(z) <= 5, 'dropout kept %d of %d: %.2f sigma' % (kept, n, z))
        check(bool(((m == 0) | (m == 1)).all()), 'a Mask value is not 0 or 1')
        scale = torch.tensor(1 / (1 - DROPOUT_P), dtype=dtype).float()
        zero = torch.zeros((), device='cuda')
        check(torch.equal(o, torch.where(m != 0, x.float() * scale,
                                         zero).to(dtype)),
              'dropout Out != X·Mask·scale (%s)' % dtype)
        check(torch.equal(dx, torch.where(
            m != 0, (w.float() * scale).to(dtype).float(), zero).to(dtype)),
            'dropout_grad dX != dOut·Mask·scale (%s)' % dtype)
        m2, = exe.run(main, feed={'x': x, 'w': w}, fetch_list=[mask],
                      scope=fluid.Scope(), return_numpy=False)
        check(not torch.equal(m, m2), 'the second step drew the same mask')
        print('dropout %s shape=%s p=%r kept=%d of %d (%.2f sigma); '
              'Out == X·Mask·scale and dX == dOut·Mask·scale exactly; '
              'step 1 drew another mask' % (
                  _precision(amp), list(DROPOUT_SHAPE), DROPOUT_P, kept, n,
                  z))
    drawn = _microbatch_masks()
    check([(s, i) for s, i, _ in drawn] == [(0, 0), (0, 1), (1, 0), (1, 1)],
          'gradient merge drew %s' % [(s, i) for s, i, _ in drawn])
    keeps = [k for _, _, k in drawn]
    check(all(not torch.equal(keeps[i], keeps[j])
              for i in range(4) for j in range(i)),
          'two microbatches or steps drew the same mask')
    print('dropout under gradient merge k=%d: 2 steps x 2 microbatches drew '
          '4 different masks' % BENCH_K)


def build_bert_bench_training(amp=True, checkpoints=None):
    """bench.py:504-540's BERT-base program: build_bert_pretrain at S=128
    with its defaults (dropout 0.1, Adam lr 1e-4), seeded initialization,
    enable_bf16 (with amp) and gradient_merge.enable(2); `checkpoints` as
    PTPU_BENCH_BERT_REMAT passes it (bench.py:512-521). Returns (main,
    startup, loss, feeds)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, loss = build_bert_pretrain(checkpoints=checkpoints,
                                          **BENCH_BERT)
    gradient_merge.enable(BENCH_K, _mark(main, amp))
    return main, startup, loss, feeds


def _bench_feed(feeds, batch):
    """The feed bench.py:525-537 makes: numpy RandomState(0), the feeds in
    build_bert_pretrain's feed order, ids uniform in [0, vocab)
    (segments in [0, 2)), 15% of the positions weighted; on the card."""
    rng = np.random.RandomState(0)
    out = {}
    for name, shape, dtype in feeds:
        full = (batch,) + tuple(shape)
        if dtype == 'int64':
            hi = 2 if name == 'seg_ids' else BENCH_BERT['vocab']
            arr = rng.randint(0, hi, full).astype(np.int32)
        else:
            arr = (rng.rand(*full) < 0.15).astype(np.float32)
        out[name] = torch.from_numpy(arr).cuda()
    return out


def phase_bert_bench_training(main, startup, loss, feeds):
    """bench_bert's configuration on the card (_bench_training):
    TRAIN_WARMUP_STEPS, then TRAIN_STEPS timed steps on one fixed batch of
    BENCH_BATCH, each a gradient-merge step of 2 microbatches of 32. The
    program holds 37 dropout ops and 24 matmul ops and no fused attention;
    the last loss is below the first; the path launches no kernel of the
    port (the composed attention is cuBLAS and torch)."""
    n_layer = BENCH_BERT['n_layer']
    counts, _ = _bench_training(
        'bert_bench_training', main, startup, loss,
        _bench_feed(feeds, BENCH_BATCH),
        {'dropout': 1 + 3 * n_layer, 'matmul': 2 * n_layer,
         'fused_multihead_attention': 0},
        dict.fromkeys(('flash_attn_fwd', 'flash_attn_bwd_dkv',
                       'flash_attn_bwd_dq'), 0),
        TRAIN_WARMUP_STEPS, TRAIN_STEPS, BENCH_BATCH * BENCH_BERT['max_len'],
        'batch=%d S=%d k=%d bf16 dropout=0.1 lr=1e-4' % (
            BENCH_BATCH, BENCH_BERT['max_len'], BENCH_K))
    return counts


def _bench_training(label, main, startup, loss, feed, want_ops, want_step,
                    warmup, steps, tokens, desc, lr=None, flops=None,
                    want_causal=None):
    """A bench configuration on the card: the op census `want_ops` (counts
    by op type, 'ops' the total where given); startup, `warmup` steps, then
    `steps` timed steps (host clock around Executor.run and a sync) on one
    fixed feed. Each timed step launches exactly `want_step` of each K2
    kernel, all bf16, by causal flag `want_causal` where given, and no
    bn_apply; every loss is finite. With `lr`, the name of a noam schedule's
    rate, each step's fetched rate is its closed form (_check_lr) and every
    parameter moves: noam's warm-up keeps the rate too small for the loss
    to fall in a few steps. Without it, the last loss is below the first.
    Prints the losses, the launches, p50, p90, tokens/s (`tokens` a step),
    MFU where `flops` a token is given, peak allocated memory and a 3-step
    profile, `desc` naming the configuration. Returns the launches over
    the timed steps, in all and by causal flag."""
    ops = collections.Counter(op.type for op in main.global_block().ops)
    got_ops = {t: ops[t] for t in want_ops if t != 'ops'}
    if 'ops' in want_ops:
        got_ops['ops'] = sum(ops.values())
    check(got_ops == want_ops, '%s op counts %s, not %s'
          % (label, got_ops, want_ops))
    fetch = [loss] + ([lr] if lr else [])
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.all_parameters()]
    start = {n: scope.get(n).clone() for n in params} if lr else {}
    losses, rates = [], []

    def step():
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)

    def record(out):
        losses.append(float(out[0].reshape(-1)[0]))
        if lr:
            rates.append(float(out[1].reshape(-1)[0]))

    for _ in range(warmup):
        record(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for _ in range(steps):
        before = read_launches()
        before_dt, before_c = read_launches_by_dtype(), \
            read_launches_by_causal()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        record(out)
        after = read_launches()
        got = {k: after[k] - before[k] for k in want_step}
        check(got == want_step and after['bn_apply'] == 0,
              '%s: a step launched %s, not %s' % (label, after, want_step))
        by_dt = _by_dtype_step(before_dt, read_launches_by_dtype())
        check(all(by_dt[k]['bfloat16'] == want_step[k] for k in want_step),
              '%s: a step launched %s, not all bf16' % (label, by_dt))
        if want_causal is not None:
            by_c = _by_dtype_step(before_c, read_launches_by_causal())
            check(by_c == want_causal, '%s: a step launched %s by causal '
                  'flag, not %s' % (label, by_c, want_causal))
    counts = read_launches()
    by_causal = read_launches_by_causal()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), '%s: non-finite loss: %s'
          % (label, losses))
    moved = ''
    if lr:
        _check_lr(label, rates)
        n = sum(not torch.equal(start[p], scope.get(p)) for p in params)
        check(n == len(params), '%s: %d of %d parameters moved'
              % (label, n, len(params)))
        moved = ' lr=%s (noam, closed form within rtol 1e-6); %d of %d ' \
            'parameters moved' % (json.dumps(['%.6g' % r for r in rates]),
                                  n, len(params))
        del start
    else:
        check(losses[-1] < losses[0], '%s: the loss did not fall: %s'
              % (label, losses))
    p50 = float(np.percentile(times, 50))
    print('%s %s ops=%d op_counts=%s losses=%s%s' % (
        label, desc, sum(ops.values()), json.dumps(got_ops),
        json.dumps([round(x, 5) for x in losses]), moved))
    print('%s launches over %d timed steps: %s (per step: %s; by dtype: %s; '
          'by causal flag: %s)' % (label, steps, json.dumps(counts),
                                   json.dumps(want_step),
                                   json.dumps(read_launches_by_dtype()),
                                   json.dumps(by_causal)))
    mfu = '' if flops is None else ' mfu=%.4f (flops_per_token %d at %g ' \
        'bf16 dense FLOP/s)' % (tokens / p50 * flops / BF16_OPS_PER_S, flops,
                                BF16_OPS_PER_S)
    print('%s step p50_ms=%r p90_ms=%r tokens_per_s=%r%s '
          'peak_allocated_gb=%.2f (host clock, %d steps, each ending in a '
          'sync)' % (label, p50 * 1e3, float(np.percentile(times, 90)) * 1e3,
                     tokens / p50, mfu, peak / 2 ** 30, steps))
    PEAKS[label] = peak
    per_kernel = _profile(
        lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                        return_numpy=False), '%s %s' % (label, desc), 'steps')
    if per_kernel:
        busy = sum(per_kernel.values())
        k2 = sum(ms for name, ms in per_kernel.items()
                 if 'flash_fwd_kernel' in name or 'flash_bwd_' in name)
        print('profile %s: device_busy_ms_per_step=%r K2 device_ms_per_step=%r'
              ' share=%.3f' % (label, busy / 3, k2 / 3, k2 / busy))
    del scope, feed
    torch.cuda.empty_cache()
    return counts, by_causal


def _gpu_vs_cpu_card_masks(label, main, startup, names, feed, seed, amp,
                           n_masks):
    """_gpu_vs_cpu_step with the card's dropout masks, the draws moving the
    parameters only: each dropout op's keep decision in each microbatch,
    drawn on the card in the first run, is given to every later run on the
    card and on the CPU (the two devices' generators give different
    streams). Fails unless `n_masks` were drawn; returns the rows."""
    masks = {}
    real = tensor_ops.draw_dropout_keep

    def card_masks(ctx, shape, p):
        if ctx.device.type == 'meta':
            return real(ctx, shape, p)
        key = (ctx.interp.micro, ctx.op.output('Mask')[0])
        if key not in masks:
            check(ctx.device.type == 'cuda', 'the CPU ran before the card')
            masks[key] = real(ctx, shape, p)
        return masks[key].to(ctx.device)

    tensor_ops.draw_dropout_keep = card_masks
    try:
        rows = _gpu_vs_cpu_step(main, startup, names, feed, seed, amp,
                                {p.name for p in main.all_parameters()})
    finally:
        tensor_ops.draw_dropout_keep = real
    check(len(masks) == n_masks, '%s: %d masks recorded, not %d'
          % (label, len(masks), n_masks))
    return rows


def phase_bench_gpu_vs_cpu(amp):
    """One step of bench_bert's program (k=2, dropout 0.1, f32 or with amp
    bf16) at batch 2, GPU against CPU, from one initial state, with the
    card's masks (_gpu_vs_cpu_card_masks): the loss and the merged
    gradients of word_emb, the first Q weight and the last layer_norm
    scale, each within 4 times the one-ulp noise over NOISE_DRAWS draws on
    each side (_gpu_vs_cpu_step), the draws moving the parameters (the
    Adam state, zeros and constants before the first step, enters no
    fetched value: the update runs after the gradients are merged)."""
    label = 'bert_bench_training%s_gpu_vs_cpu' % ('_bf16' if amp else '')
    main, startup, loss, feeds = build_bert_bench_training(amp)
    names = [loss.name, 'word_emb@GRAD', 'fc_0.w_0@GRAD',
             _last_layer_norm_scale(main) + '@GRAD']
    n_masks = BENCH_K * (1 + 3 * BENCH_BERT['n_layer'])
    rows = _gpu_vs_cpu_card_masks(label, main, startup, names,
                                  _bench_feed(feeds, BENCH_GATE_BATCH),
                                  SEED + 17, amp, n_masks)
    worst = _gate_rows(label, 'batch=%d k=%d' % (BENCH_GATE_BATCH, BENCH_K),
                       rows)
    print('%s worst err/tol=%.3f (%s); %d card masks given to the CPU'
          % (label, worst[0], worst[1], n_masks))


def build_transformer_bench_training(dropout=0.1, amp=True, k=1):
    """bench.py:448-501's Transformer-base program:
    build_transformer_train at its settings with `dropout`, seeded
    initialization, enable_bf16 (with amp) and, with k > 1,
    gradient_merge.enable(k). Returns (main, startup, loss, feeds,
    flops_per_token, the learning-rate var's name)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, loss, flops = build_transformer_train(dropout=dropout,
                                                     **TRANS)
    _mark(main, amp)
    if k > 1:
        gradient_merge.enable(k, main)
    lr = next(op for op in main.global_block().ops
              if op.type == 'adam').input('LearningRate')[0]
    return main, startup, loss, feeds, flops, lr


def _trans_feed(feeds, batch):
    """The feed bench.py:474-483 makes: numpy RandomState(0), the feeds in
    build_transformer_train's order, ids uniform in [1, 31999); on the
    card."""
    rng = np.random.RandomState(0)
    return {name: torch.from_numpy(rng.randint(
        1, 31999, (batch,) + tuple(shape)).astype(np.int32)).cuda()
        for name, shape, _ in feeds}


def _noam_lr(t):
    """build_transformer_train's rate at step t (1, 2, ...):
    2·d_model^-0.5·min(t^-0.5, t·4000^-1.5)."""
    return 2.0 * TRANS['d_model'] ** -0.5 * min(t ** -0.5,
                                                 t * 4000 ** -1.5)


def _check_lr(label, rates, first_step=1):
    """Each fetched rate equals noam's closed form at its step within f32
    rounding (rtol 1e-6)."""
    want = [_noam_lr(first_step + i) for i in range(len(rates))]
    bad = [(i, r, w) for i, (r, w) in enumerate(zip(rates, want))
           if abs(r - w) > 1e-6 * w]
    check(not bad, '%s: the learning rate is not noam\'s: %s' % (label, bad))


def _trans_want(dropout):
    """(op census, K2 launches a step by dtype, K2 launches a step by
    causal flag) of the program at `dropout`: every attention composed at
    0.1 (no launch), fused at 0, where each of the 3·n_layer attentions
    launches the forward twice (the op and its grad's recompute) and each
    backward kernel once, the n_layer decoder self-attentions causal."""
    n = TRANS['n_layer']
    attn = 3 * n
    if dropout:
        return ({'ops': 1157, 'dropout': 2 + attn + 5 * n,
                 'matmul': 2 * attn, 'softmax': attn,
                 'fused_multihead_attention': 0},
                {'flash_attn_fwd': 0, 'flash_attn_bwd_dkv': 0,
                 'flash_attn_bwd_dq': 0}, None)
    return ({'ops': 971, 'dropout': 0, 'matmul': 0, 'softmax': 0,
             'fused_multihead_attention': attn},
            {'flash_attn_fwd': 2 * attn, 'flash_attn_bwd_dkv': attn,
             'flash_attn_bwd_dq': attn},
            {'flash_attn_fwd': {'causal': 2 * n, 'noncausal': 4 * n},
             'flash_attn_bwd_dkv': {'causal': n, 'noncausal': 2 * n},
             'flash_attn_bwd_dq': {'causal': n, 'noncausal': 2 * n}})


def phase_transformer_bench_training(dropout, steps=TRANS_STEPS):
    """bench_transformer's configuration on the card, at `dropout` (0.1,
    bench.py's default, or 0, its ablation), through _bench_training:
    TRANS_WARMUP_STEPS and `steps` timed steps on bench.py's fixed batch of
    TRANS_BATCH; the op census, the K2 launches of each step by dtype and
    causal flag (_trans_want), noam's rate at each step and every parameter
    moved; MFU from the program's own flops_per_token. Returns the
    launches over the timed steps, in all and by causal flag."""
    label = 'transformer_bench_training' + ('' if dropout else '_dropout0')
    t0 = time.perf_counter()
    main, startup, loss, feeds, flops, lr = \
        build_transformer_bench_training(dropout)
    print('model transformer-base bench training S=%d vocab=%d layers=%d+%d '
          'bf16 dropout=%g ops=%d flops_per_token=%d build_s=%.1f' % (
              TRANS['max_len'], TRANS['trg_vocab'], TRANS['n_layer'],
              TRANS['n_layer'], dropout, len(main.global_block().ops), flops,
              time.perf_counter() - t0))
    want_ops, want_step, want_causal = _trans_want(dropout)
    return _bench_training(
        label, main, startup, loss, _trans_feed(feeds, TRANS_BATCH),
        want_ops, want_step, TRANS_WARMUP_STEPS, steps,
        TRANS_BATCH * TRANS['max_len'],
        'batch=%d S=%d bf16 dropout=%g' % (TRANS_BATCH, TRANS['max_len'],
                                           dropout),
        lr=lr, flops=flops, want_causal=want_causal)


def phase_transformer_lr_under_gradient_merge():
    """The learning rate on the card under gradient_merge.enable(2):
    bench_transformer's program (dropout 0.1, bf16) at TRANS_LR_K
    microbatches of 2 sequences, TRANS_LR_STEPS steps: the schedule runs
    once a step, outside the microbatch loop, so the fetched rate is
    noam's at t = 1, 2, 3 and the step counter reads TRANS_LR_STEPS."""
    label = 'transformer_lr_gradient_merge'
    main, startup, loss, feeds, _, lr = build_transformer_bench_training(
        k=TRANS_LR_K)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _trans_feed(feeds, 2 * TRANS_LR_K)
    rates, losses = [], []
    for _ in range(TRANS_LR_STEPS):
        l, r = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope,
                       return_numpy=False)
        losses.append(float(l.reshape(-1)[0]))
        rates.append(float(r.reshape(-1)[0]))
    counter = scope.get('@LR_DECAY_COUNTER@').tolist()
    check(counter == [TRANS_LR_STEPS], '%s: the step counter reads %s '
          'after %d steps' % (label, counter, TRANS_LR_STEPS))
    check(all(math.isfinite(x) for x in losses), '%s: non-finite loss: %s'
          % (label, losses))
    _check_lr(label, rates)
    print('%s k=%d batch=%d bf16: lr=%s (noam at t=1..%d, rtol 1e-6), '
          'step counter %s, losses=%s' % (
              label, TRANS_LR_K, 2 * TRANS_LR_K,
              json.dumps(['%.6g' % r for r in rates]), TRANS_LR_STEPS,
              counter, json.dumps([round(x, 5) for x in losses])))
    del scope
    torch.cuda.empty_cache()


def phase_transformer_gpu_vs_cpu(dropout, amp):
    """One step of bench_transformer's program (dropout 0.1 or 0; f32 or
    with amp bf16) at TRANS_GATE_BATCH, GPU against CPU, from one initial
    state: the loss and the gradients of both embeddings, the first Q
    weight and the last layer_norm scale, each within 4 times the one-ulp
    noise over NOISE_DRAWS draws on each side (_gpu_vs_cpu_step, the draws
    moving the parameters). At dropout 0.1 the masks are the card's
    (_gpu_vs_cpu_card_masks). At dropout 0 the card's attention is K2
    (causal in the decoder's self-attention) and the CPU's its plain
    version."""
    label = 'transformer_bench_training%s%s_gpu_vs_cpu' % (
        '' if dropout else '_dropout0', '_bf16' if amp else '')
    main, startup, loss, feeds, _, _ = build_transformer_bench_training(
        dropout, amp)
    names = [loss.name, 'src_emb@GRAD', 'trg_emb@GRAD', 'fc_0.w_0@GRAD',
             _last_layer_norm_scale(main) + '@GRAD']
    n_masks = _trans_want(dropout)[0]['dropout']
    reset_launches()
    rows = _gpu_vs_cpu_card_masks(label, main, startup, names,
                                  _trans_feed(feeds, TRANS_GATE_BATCH),
                                  SEED + 31, amp, n_masks)
    launched = read_launches()['flash_attn_fwd']
    check((launched > 0) == (dropout == 0), '%s: %d K2 launches'
          % (label, launched))
    worst = _gate_rows(label, 'batch=%d' % TRANS_GATE_BATCH, rows)
    print('%s worst err/tol=%.3f (%s); %d card masks given to the CPU; '
          '%d K2 forward launches on the card' % (
              label, worst[0], worst[1], n_masks, launched))
    torch.cuda.empty_cache()


def build_resnet_training(amp=False):
    """Full-width ResNet-50 training as bench.py:431 builds it: the s2d
    stem, softmax cross-entropy, top-1 accuracy and Momentum(0.1, 0.9),
    seeded initialization; with amp, marked for bf16 by enable_bf16."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, loss, acc = build_train_net(**RESNET_TRAIN)
    return _mark(main, amp), startup, loss, acc


def _resnet_feed(bs, gen):
    return {'data': torch.randn(bs, *RESNET_TRAIN['dshape'], device='cuda',
                                generator=gen),
            'label': torch.randint(0, RESNET_TRAIN['class_dim'], (bs, 1),
                                   device='cuda', generator=gen)}


def phase_resnet_training(main, startup, loss, acc, batch=RESNET_TRAIN_BATCH,
                          amp=False, more_steps=RESNET_MORE_STEPS):
    """Train ResNet-50 on the card: TRAIN_WARMUP_STEPS, then TRAIN_STEPS
    timed steps (host clock around Executor.run and a sync), then
    `more_steps` untimed ones, all on one fixed batch of `batch`,
    fetching the loss and the accuracy. Every step after the warm-up
    launches bn_apply twice per batch_norm op (the op and the forward its
    batch_norm_grad re-runs under autograd), all in the path's dtype (bf16
    with amp), and no flash-attention kernel. The loss is finite at every
    step and lower at the last than at the first. Momentum(0.1, 0.9) makes
    the loss rise for a few steps before it falls, and cuDNN's sums are
    not deterministic, so the path differs from run to run: two f32 runs
    at batch 128 on one NVIDIA H100 80GB HBM3 (700 W) had 6.60 and 6.29 at
    step 12, 5.00 and 5.61 at step 22, from 7.61. With amp, the last
    warm-up step also fetches every parameter gradient for the dtype gate,
    which also reads the state after the warm-up steps."""
    label = 'resnet_training' + ('_bf16' if amp else '') + (
        '' if batch == (RESNET_AMP_BATCH if amp else RESNET_TRAIN_BATCH)
        else '_batch%d' % batch)
    ops = main.global_block().ops
    n_bn = sum(op.type == 'batch_norm' for op in ops)
    n_bn_grad = sum(op.type == 'batch_norm_grad' for op in ops)
    check(n_bn == n_bn_grad == 53, 'the ResNet-50 training program has %d '
          'batch_norm and %d batch_norm_grad ops' % (n_bn, n_bn_grad))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 15)
    feed = _resnet_feed(batch, gen)
    grads = [p.name + '@GRAD' for p in main.all_parameters()] if amp else []
    losses, accs = [], []
    exe.run(startup, scope=scope)

    def step(extra=()):
        return exe.run(main, feed=feed, fetch_list=[loss, acc] + list(extra),
                       scope=scope, return_numpy=False)

    for i in range(TRAIN_WARMUP_STEPS):
        out = step(grads if i == TRAIN_WARMUP_STEPS - 1 else ())
        losses.append(float(out[0].reshape(-1)[0]))
        accs.append(float(out[1].reshape(-1)[0]))
    if amp:
        _check_amp_dtypes(label, main, scope, dict(zip([loss.name] + grads,
                                                       out[:1] + out[2:])))
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dtype = 'bfloat16' if amp else 'float32'
    want = {'bn_apply': 2 * n_bn, 'flash_attn_fwd': 0,
            'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}
    reset_launches()
    times = []
    for i in range(TRAIN_STEPS + more_steps):
        before, before_dt = read_launches(), read_launches_by_dtype()
        t0 = time.perf_counter()
        out = step()
        if i < TRAIN_STEPS:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        after = read_launches()
        launched = {k: after[k] - before[k] for k in after}
        check(launched == want, 'a ResNet-50 training step launched %s, not '
              '%s' % (launched, want))
        by_dt = _by_dtype_step(before_dt, read_launches_by_dtype())
        check(by_dt['bn_apply'][dtype] == want['bn_apply'],
              '%s: a step launched bn_apply %s, not all %s'
              % (label, by_dt['bn_apply'], dtype))
        losses.append(float(out[0].reshape(-1)[0]))
        accs.append(float(out[1].reshape(-1)[0]))
        if i == TRAIN_STEPS - 1:
            counts = read_launches()
            counts_by_dtype = read_launches_by_dtype()
            peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), 'non-finite loss: %s'
          % losses)
    check(losses[-1] < losses[0], 'the loss did not fall: %s' % losses)
    p50 = float(np.percentile(times, 50))
    print('%s batch=%d 224x224 classes=%d s2d_stem %s lr=%r momentum=0.9 '
          'ops=%d losses=%s accuracies=%s' % (
              label, batch, RESNET_TRAIN['class_dim'], _precision(amp),
              RESNET_TRAIN['lr'], len(ops),
              json.dumps([round(x, 5) for x in losses]),
              json.dumps([round(x, 4) for x in accs])))
    print('%s launches over %d timed steps: %s (per step: %s; by dtype: %s; '
          'the same in each of the %d untimed steps)' % (
              label, TRAIN_STEPS, json.dumps(counts), json.dumps(want),
              json.dumps(counts_by_dtype), more_steps))
    print('%s step p50_ms=%r p90_ms=%r img_per_s=%r peak_allocated_gb=%.2f '
          '(host clock, %d steps, each ending in a sync)' % (
              label, p50 * 1e3, float(np.percentile(times, 90)) * 1e3,
              batch / p50, peak / 2 ** 30, TRAIN_STEPS))
    PEAKS[label] = peak
    return exe, scope, feed, counts


def phase_resnet_training_profile(exe, main, loss, acc, scope, feed,
                                  batch=RESNET_TRAIN_BATCH, amp=False):
    """Device time by kernel over 3 ResNet-50 training steps; K1's time a
    step, its share, and its bound a step: the bytes of its 106 launches
    (x read and y written at each of the 53 BN shapes in the path's dtype,
    k and b in f32, twice) at the HBM rate. Returns K1's {'ms',
    'bound_ms'} a step, or None when the trace holds no device time."""
    per_kernel = _profile(
        lambda: exe.run(main, feed=feed, fetch_list=[loss, acc],
                        scope=scope, return_numpy=False),
        'resnet50 training %s batch=%d' % (_precision(amp), batch), 'steps')
    if not per_kernel:
        return None
    k1 = sum(ms for name, ms in per_kernel.items() if 'bn_apply' in name) / 3
    size = 2 if amp else 4
    nbytes = 2 * sum(count * (2 * batch * c * h * w * size + 2 * c * 4)
                     for (c, h, w), count in BN_SHAPES)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print('profile resnet50 training %s: bn_apply device_ms_per_step=%r '
          'share=%.3f bound_ms_per_step=%r (bytes) bound_share=%.3f' % (
              _precision(amp), k1, 3 * k1 / sum(per_kernel.values()), bound,
              bound / k1))
    return {'ms': k1, 'bound_ms': bound}


def phase_resnet_training_gpu_vs_cpu(main, startup, loss, amp=False):
    """One ResNet-50 training step at batch RESNET_GATE_BATCH from one
    initial state (the startup program run on the card, carried to a CPU
    scope with weights.py): the loss and the gradient of every parameter
    (the 53 conv filters, the 53 BN scales and biases, the fc weight and
    bias), GPU against CPU. A Function that lost the kernel's autograd
    history would give zero BN and filter gradients on the card.

    The tolerance of each is measured in the same run, as for BERT
    (_gpu_vs_cpu_step): 4 times the largest move over NOISE_DRAWS one-ulp
    draws of the state on the card plus that on the CPU, and never less
    than 1e-5 of its largest value."""
    label = 'resnet_training%s_gpu_vs_cpu' % ('_bf16' if amp else '')
    names = [loss.name] + [p.name + '@GRAD' for p in main.all_parameters()]
    gen = torch.Generator(device='cuda').manual_seed(SEED + 17)
    rows = _gpu_vs_cpu_step(main, startup, names,
                            _resnet_feed(RESNET_GATE_BATCH, gen), SEED + 16,
                            amp)
    first_conv = next(op.input('Filter')[0] for op in main.global_block().ops
                      if op.type == 'conv2d')
    shown = {loss.name, first_conv + '@GRAD', 'batch_norm_0.w_0@GRAD',
             'batch_norm_0.b_0@GRAD', 'batch_norm_52.w_0@GRAD',
             'batch_norm_52.b_0@GRAD', 'fc_0.w_0@GRAD'}
    worst = (0.0, '')
    failed = []
    for name, g, w, err, top, noise, tol in rows:
        if name in shown:
            print('%s batch=%d %s shape=%s max_abs_err=%r max_abs=%r rel=%r '
                  'one_ulp_noise=%r tolerance=%r' % (
                      label, RESNET_GATE_BATCH, name, tuple(w.shape), err,
                      top, err / top, noise, tol))
        ok = g.shape == w.shape and np.isfinite(g).all() and err <= tol \
            and (top > 0 or name == loss.name)
        if not ok:
            failed.append((name, err, tol, top))
        worst = max(worst, (err / tol, name))
    print('%s batch=%d tensors=%d worst err/tol=%.3f (%s)' % (
        label, RESNET_GATE_BATCH, len(names), worst[0], worst[1]))
    check(not failed, 'GPU and CPU ResNet-50 training step differ (name, '
          'err, tolerance, largest value): %s' % failed[:10])


def _update_program(main):
    """The backward and Momentum ops of `main` (those with an op_role, as
    append_backward and the optimizer mark them) as a program of their
    own, marked for bf16 where `main` is (clone does not carry the mark),
    and what they read that none of them writes and that is not
    persistable: the step's forward values and feeds."""
    persist = {v.name for v in main.list_vars() if v.persistable}
    update = _mark(main.clone(), getattr(main, '_amp_bf16', False))
    ops = [op for op in update.global_block().ops if op.attrs.get('op_role')]
    update.global_block().ops = ops
    written, fed = set(), []
    for op in ops:
        for n in op.input_arg_names():
            if n and n not in written and n not in persist and n not in fed:
                fed.append(n)
        written.update(op.output_arg_names())
    return update, fed


def phase_resnet_backward_gpu_vs_cpu(main, startup, amp=False):
    """The backward and Momentum ops of one ResNet-50 training step at
    batch RESNET_GATE_BATCH, card against CPU, both from one initial state
    and fed the card's forward values of the step (with amp, the bf16 ones
    fed as bf16: the update program declares them so). Fed the same
    values, both take the same relu masks and BN batch statistics, so
    their gradients differ only by the order of their sums: the
    convolutions' gradients, the forward each batch_norm_grad re-runs (K1
    on the card) and the BN gradients' reductions. Every parameter
    gradient is held to max(1e-5 of its largest value, 4 times the noise):
    the largest move over NOISE_DRAWS one-ulp draws of the state and the
    fed values on the card plus that on the CPU, measured here. Prints
    err/|max| of every BN scale and bias gradient."""
    label = 'resnet_backward%s_gpu_vs_cpu' % ('_bf16' if amp else '')
    update, fed_names = _update_program(main)
    grads = [p.name + '@GRAD' for p in main.all_parameters()]
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    gpu.run(startup, scope=scope)
    state = fluid.weights.state_to_numpy(main, scope)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 18)
    fed = dict(zip(fed_names, gpu.run(
        main, feed=_resnet_feed(RESNET_GATE_BATCH, gen),
        fetch_list=fed_names, scope=scope, return_numpy=False)))
    del scope
    block = update.global_block()
    for n, t in fed.items():
        block.var(n).dtype = fluid.convert_dtype(t.dtype)
    n_bf16 = sum(t.dtype == torch.bfloat16 for t in fed.values())
    runs = {}
    dtype = 'bfloat16' if amp else 'float32'
    for place, device in ((fluid.CUDAPlace(0), 'cuda'),
                          (fluid.CPUPlace(), 'cpu')):
        exe = fluid.Executor(place)
        for i in range(NOISE_DRAWS + 1):
            st, fd = state, fed
            if i:
                st = _perturbed(state, SEED + 19 + 2 * i, amp)
                fd = _perturbed(fed, SEED + 20 + 2 * i, amp)
            scope = fluid.Scope()
            fluid.weights.params_from_numpy(st, main, scope, device=device)
            before = read_launches_by_dtype()['bn_apply']
            runs[device, i] = exe.run(
                update, feed={n: t.to(device) for n, t in fd.items()},
                fetch_list=grads, scope=scope)
            if device == 'cuda':
                after = read_launches_by_dtype()['bn_apply']
                step = {k: after[k] - before[k] for k in after}
                check(step[dtype] == 53 and sum(step.values()) == 53,
                      'the backward launched bn_apply %s, not 53 %s'
                      % (step, dtype))
    failed, bn_rel = [], {}
    worst = (0.0, '')
    for j, name in enumerate(grads):
        g, w = runs['cuda', 0][j], runs['cpu', 0][j]
        noise = sum(max(float(np.abs(runs[d, i][j] - runs[d, 0][j]).max())
                        for i in range(1, NOISE_DRAWS + 1))
                    for d in ('cuda', 'cpu'))
        err, top = float(np.abs(g - w).max()), float(np.abs(w).max())
        tol = max(1e-5 * top, 4 * noise)
        if name.startswith('batch_norm_'):
            bn_rel[name[:-5]] = round(err / top, 9) if top > 0 else None
        if not (g.shape == w.shape and np.isfinite(g).all() and top > 0
                and err <= tol):
            failed.append((name, err, tol, top))
        worst = max(worst, (err / tol, name))
    print('%s batch=%d fed the card\'s forward values (%d of %d bf16): '
          'tensors=%d worst err/tol=%.3f (%s)' % (
              label, RESNET_GATE_BATCH, n_bf16, len(fed), len(grads),
              worst[0], worst[1]))
    print('%s BN scale/bias gradients err/|max|: %s'
          % (label, json.dumps(bn_rel)))
    check(not failed, 'GPU and CPU ResNet-50 backward differ (name, err, '
          'tolerance, largest value): %s' % failed[:10])


def phase_flash_bwd_times():
    """K2-bwd-dkv, K2-bwd-dq and their plain versions at K2_BWD_TIME_CASES,
    beside each kernel's bound: max(bytes of q, k, v, dO, lse, di read and
    the gradients written / HBM rate, 8 (dkv) or 6 (dq) · B·H·D operations
    for each (query, key) pair the mask keeps (_score_pairs) / the dtype's
    peak: bf16 on the tensor cores, f32 at the 3xTF32 rate, with the f32
    CUDA-core bound beside it), and each kernel's TFLOP/s. The library's
    yardstick is scaled_dot_product_attention's backward (autograd of it,
    forward and backward, less its forward; is_causal as the case), which
    computes dQ, dK and dV in one call, so the pair dkv + dq is also given
    as a ratio to it."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 12)
    rows = {}
    for b, h, s, d, causal, dtypes in K2_BWD_TIME_CASES:
        scale = d ** -0.5
        numel = b * h * s * d
        for dtype in dtypes:
            peak = BF16_OPS_PER_S if dtype == torch.bfloat16 \
                else F32_3XTF32_OPS_PER_S
            size = dtype.itemsize
            copies = max(2, math.ceil(2 * L2_BYTES / (4 * numel * size)))
            sets = []
            for _ in range(copies):
                q, k, v, do = _bwd_inputs(b, h, s, s, d, dtype, gen)
                out, lse = fa.flash_attn_fwd(q, k, v, causal, scale,
                                             return_lse=True)
                sets.append((q, k, v, do, lse,
                             (do.float() * out.float()).sum(-1)))
            lib_sets = [tuple(t.detach().requires_grad_() for t in st[:3])
                        + (st[3],) for st in sets]
            # autograd and the plain versions enqueue ~1.4 ms a call on the
            # host
            spin = 4 * SPIN_CYCLES
            lib_fwd = _time_ms(lambda t: F.scaled_dot_product_attention(
                *t[:3], is_causal=causal, scale=scale), lib_sets, spin)
            lib_all = _time_ms(lambda t: torch.autograd.grad(
                F.scaled_dot_product_attention(
                    *t[:3], is_causal=causal, scale=scale), t[:3], t[3]),
                lib_sets, spin)
            lib = lib_all - lib_fwd
            case = (b, h, s, d, causal, str(dtype)[6:])
            for name, factor, n_out in (('flash_attn_bwd_dkv', 8, 2),
                                        ('flash_attn_bwd_dq', 6, 1)):
                wrapper = WRAPPERS[name]
                ref = getattr(fa, name + '_reference')
                before = wrapper.launches
                ms = _time_ms(lambda t: wrapper(*t, causal, scale), sets,
                              spin)
                check(wrapper.launches - before == KERNEL_REPS + 2,
                      'timing loop did not launch %s' % name)
                plain = _time_ms(lambda t: ref(*t, causal, scale), sets,
                                 spin)
                ops = factor * b * h * d * _score_pairs(s, s, causal)
                nbytes = (4 + n_out) * numel * size + 2 * b * h * s * 4
                bound = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
                by = 'operations' if ops / peak > nbytes / HBM_BYTES_PER_S \
                    else 'bytes'
                row = rows[(name,) + case] = dict(
                    ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                    bound_by=by, tflops=ops / ms * 1e-9)
                cuda_core = ''
                if dtype == torch.float32:
                    row['cuda_core_bound_ms'] = max(
                        nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
                    cuda_core = ' cuda_core_bound_ms=%r' % (
                        row['cuda_core_bound_ms'])
                print('k2_bwd_time %s shape=%s causal=%s dtype=%s '
                      'kernel_ms=%r bound_ms=%r (%s) plain_ms=%r '
                      'sdpa_bwd_ms=%r (dq, dk and dv together; sdpa fwd+bwd '
                      '%r, fwd %r) bound_share=%.3f tflops=%.2f%s' % (
                          name, (b, h, s, s, d), causal, case[-1], ms, bound,
                          by, plain, lib, lib_all, lib_fwd, bound / ms,
                          ops / ms * 1e-9, cuda_core))
            pair = (rows[('flash_attn_bwd_dkv',) + case]['ms']
                    + rows[('flash_attn_bwd_dq',) + case]['ms'])
            for name in ('flash_attn_bwd_dkv', 'flash_attn_bwd_dq'):
                rows[(name,) + case]['pair_vs_sdpa_bwd'] = pair / lib
            print('k2_bwd_time pair dkv+dq shape=%s causal=%s dtype=%s ms=%r '
                  'sdpa_bwd_ms=%r ratio=%.3f' % ((b, h, s, s, d), causal,
                                                 case[-1], pair, lib,
                                                 pair / lib))
            del sets, lib_sets
    return rows


def _case_tag(case):
    """'BxHxSxD/causal|noncausal/dtype' of a K2 timing row's key."""
    b, h, s, d, causal, dtype = case
    return '%dx%dx%dx%d/%s/%s' % (b, h, s, d, 'causal' if causal
                                  else 'noncausal', dtype)


def _k2_transformer_step_ms(k2_rows, bwd_rows):
    """Each K2 kernel's device ms in a step of the transformer's dropout-0
    path, from its times at the path's shape (bf16, causal and not) and
    its launches a step by causal flag (_trans_want(0))."""
    b, h, s, _, d = K2_TRANS_SHAPE
    want = _trans_want(0.0)[2]
    out = {}
    for name, launches in want.items():
        rows = k2_rows if name == 'flash_attn_fwd' else {
            key[1:]: row for key, row in bwd_rows.items() if key[0] == name}
        out[name] = sum(n * rows[b, h, s, d, flag == 'causal',
                                 'bfloat16']['ms']
                        for flag, n in launches.items())
    print('k2_time transformer_bench_training_dropout0 step (kernel times '
          'at %s bf16 x launches a step by causal flag): %s ms, %r in all'
          % ((b, h, s, s, d), json.dumps(out), sum(out.values())))
    return out


def build_decode_artifact(dirname):
    """decode-base on the card: build_decode_spec(**DECODE) -> startup
    (random weights from the program's seed) -> export_decode(dirname),
    each program after the inference pipeline (a fallback fails).
    Returns (the artifact's signature, the step program's op census, the
    prefill programs' op counts, parameter elements)."""
    with fluid.unique_name.guard():
        spec = build_decode_spec(**DECODE)
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(spec['startup'], scope=scope)
    with warnings.catch_warnings():
        # the inference pipeline's fallback to the raw programs warns
        warnings.simplefilter('error', RuntimeWarning)
        export_decode(spec, dirname, scope=scope)
    with open(os.path.join(dirname, 'decode_signature.json')) as f:
        sig = json.load(f)
    n_params = sum(scope.get(n).numel() for n in sig['params'])
    step_ops = collections.Counter(
        op.type for op in spec['step']['program'].global_block().ops
        if op.type != 'feed')
    prefill_ops = {L: sum(op.type != 'feed' for op in
                          e['program'].global_block().ops)
                   for L, e in sorted(spec['prefill'].items())}
    del scope
    torch.cuda.empty_cache()
    return sig, step_ops, prefill_ops, n_params


def _decode_prompts():
    """bench_decode_serving's prompts: lengths randint(4, the largest
    bucket), ids in [2, vocab), from RandomState(SEED)."""
    rng = np.random.RandomState(SEED)
    return [rng.randint(2, DECODE['vocab'],
                        int(rng.randint(4, max(DECODE['prompt_buckets']))))
            for _ in range(DECODE_REQUESTS)]


def _decode_step_bytes(sig):
    """The least bytes a decode step moves: every weight read once (of the
    embedding and position tables only the max_slots rows a step gathers),
    the whole cache read (the attention's einsums read every row and mask
    after) and one row a slot written per cache var, the logits written."""
    S, V, D = sig['max_slots'], sig['vocab'], DECODE['d_model']
    L, F = DECODE['n_layer'], DECODE['d_ff']
    layer = 4 * D * D + 2 * D * F + F + D + 4 * D   # q k v o, ffn, LN
    weights = (L * layer + D * V + 2 * S * D) * 4
    cache = sig['cache_bytes'] + len(sig['state']) * S * D * 4
    return weights, cache, S * V * 4


def phase_decode_serving(dirname, sig):
    """decode-base served through DecodingPredictor on the card, as
    bench_decode_serving drives it: a sequential arm (generate, one request
    at a time), then a Poisson arm at DECODE_RATE_X times the measured
    sequential request rate, whose transcripts must equal the sequential
    ones; then DECODE_BEAM beam-3 requests beside greedy traffic, whose
    hypotheses and scores must equal their solo runs. No kernel of the
    port launches on this path. Then DECODE_PROFILE_STEPS steps at full
    occupancy, timed on the host clock and profiled. Returns (the
    predictor, the sequential transcripts, the prompts, the launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = DecodingPredictor(dirname)      # CUDAPlace(0) unless asked
    check(pred.place == fluid.CUDAPlace(0), 'decode predictor on %r'
          % (pred.place,))
    pred.warmup()
    print('decode-base load_warmup_s=%.1f' % (time.perf_counter() - t0))
    prompts = _decode_prompts()
    reset_launches()
    t0 = time.perf_counter()
    seq = [pred.generate(p, max_new_tokens=DECODE_MAX_NEW) for p in prompts]
    seq_s = time.perf_counter() - t0
    seq_snap = pred.stats.snapshot()
    pred.stats.reset()
    rate = DECODE_RATE_X * len(prompts) / seq_s
    arrivals = np.cumsum(np.random.RandomState(1).exponential(
        1.0 / rate, len(prompts)))
    streams = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        delay = t0 + arrivals[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        streams.append(pred.submit(p, max_new_tokens=DECODE_MAX_NEW))
    con = [s.result(600) for s in streams]
    wall = time.perf_counter() - t0
    snap = pred.stats.snapshot()
    check(all(1 <= len(t) <= DECODE_MAX_NEW and
              all(0 <= x < DECODE['vocab'] for x in t) for t in seq),
          'decode transcripts out of range')
    diverged = [i for i, (a, b) in enumerate(zip(con, seq)) if a != b]
    check(not diverged, 'continuous decode transcripts differ from the '
          'sequential ones for requests %s' % diverged)
    n_tok = sum(len(t) for t in seq)
    print('decode-base sequential arm: requests=%d tokens=%d wall_s=%r '
          'tokens_per_s=%r steps=%d prefills=%d occupancy=%r '
          'ttft_p50_ms=%r ttft_p99_ms=%r itl_p50_ms=%r itl_p99_ms=%r' % (
              len(prompts), n_tok, seq_s, n_tok / seq_s, seq_snap['steps'],
              seq_snap['prefills'], seq_snap['occupancy'],
              seq_snap['ttft_p50_ms'], seq_snap['ttft_p99_ms'],
              seq_snap['itl_p50_ms'], seq_snap['itl_p99_ms']))
    print('decode-base continuous arm (Poisson, %g x the sequential rate = '
          '%.2f req/s): tokens=%d wall_s=%r tokens_per_s=%r vs_sequential=%r'
          ' steps=%d prefills=%d occupancy=%r ttft_p50_ms=%r ttft_p99_ms=%r '
          'itl_p50_ms=%r itl_p99_ms=%r; transcripts equal the sequential '
          'arm\'s (%d requests)' % (
              DECODE_RATE_X, rate, n_tok, wall, n_tok / wall,
              seq_s / wall, snap['steps'], snap['prefills'],
              snap['occupancy'], snap['ttft_p50_ms'], snap['ttft_p99_ms'],
              snap['itl_p50_ms'], snap['itl_p99_ms'], len(con)))

    beam_prompts = prompts[:DECODE_BEAM]
    solo = [pred.generate(p, max_new_tokens=DECODE_MAX_NEW, beam=DECODE_BEAM)
            for p in beam_prompts]
    greedy_idx = list(range(DECODE_BEAM, DECODE_BEAM + 8))
    pred.stats.reset()
    beams, greedy = [], []
    for i, p in enumerate(beam_prompts):
        beams.append(pred.submit(p, max_new_tokens=DECODE_MAX_NEW,
                                 beam=DECODE_BEAM))
        greedy += [pred.submit(prompts[j], max_new_tokens=DECODE_MAX_NEW)
                   for j in greedy_idx[i::DECODE_BEAM]]
    got = [s.result(600) for s in beams]
    mixed = pred.stats.snapshot()
    for (ids1, sc1), (ids2, sc2) in zip(solo, got):
        check(ids1.shape == (DECODE_BEAM, ids1.shape[1])
              and np.array_equal(ids1, ids2) and np.array_equal(sc1, sc2)
              and list(sc1) == sorted(sc1, reverse=True),
              'beam hypotheses or scores beside greedy traffic differ from '
              'the solo run')
    order = [j for i in range(DECODE_BEAM) for j in greedy_idx[i::DECODE_BEAM]]
    check([s.result(600) for s in greedy] == [seq[j] for j in order],
          'greedy transcripts beside beam requests differ')
    counts = read_launches()
    check(not any(counts.values()), 'the decode path launched %s' % counts)
    print('decode-base beam: %d beam-%d requests beside %d greedy ones, '
          'hypotheses and scores equal their solo runs (best scores %s); '
          'reorders=%d steps=%d occupancy=%r; launches over the decode path '
          '%s' % (DECODE_BEAM, DECODE_BEAM, len(greedy),
                  [round(float(sc[0]), 4) for _, sc in solo],
                  mixed['reorders'], mixed['steps'], mixed['occupancy'],
                  json.dumps(counts)))

    S = DECODE['max_slots']
    rng = np.random.RandomState(2)
    tokens = rng.randint(2, DECODE['vocab'], (S, 1)).astype(np.int64)
    T = DECODE['max_cache_len']
    pos = rng.randint(T // 8, T * 5 // 8, (S, 1)).astype(np.int32)
    times = []
    for _ in range(DECODE_PROFILE_STEPS):
        t0 = time.perf_counter()
        pred._dispatch_step(tokens, pos)   # returns the synced logits
        times.append(time.perf_counter() - t0)
    per_kernel = _profile(lambda: pred._dispatch_step(tokens, pos),
                          'decode-base step, 32 active slots', 'steps',
                          calls=DECODE_PROFILE_STEPS)
    weights, cache, logits = _decode_step_bytes(sig)
    busy = (sum(per_kernel.values()) / DECODE_PROFILE_STEPS
            if per_kernel else None)
    print('decode-base step at %d active slots: host-clock p50_ms=%r '
          'p90_ms=%r (the step program through Executor.run and the [%d, %d]'
          ' logits copy to the host); device_busy_ms_per_step=%r; byte bound '
          '%r ms (%d weight + %d cache + %d logits bytes at %g B/s); '
          'peak_allocated_gb=%.2f' % (
              S, float(np.percentile(times, 50)) * 1e3,
              float(np.percentile(times, 90)) * 1e3, S, DECODE['vocab'],
              busy, (weights + cache + logits) / HBM_BYTES_PER_S * 1e3,
              weights, cache, logits, HBM_BYTES_PER_S,
              torch.cuda.max_memory_allocated() / 2 ** 30))
    return pred, seq, prompts, counts


def _top2_gap(row):
    top = np.sort(np.asarray(row, np.float64))[::-1][:2]
    return float(top[0] - top[1])


def phase_decode_gpu_vs_cpu(dirname, pred, seq, prompts):
    """The decode-base artifact served by the port on the CPU against the
    card: each bucket's prefill logits (one prompt each, slot 0) and
    DECODE_TF_STEPS steps of DECODE_GATE_PROMPTS slots decoding together,
    fed the card's greedy tokens, each dispatch's logits within 1e-3 of
    its largest |logit| (the serving gate); then the CPU's greedy
    transcripts of those prompts against the card's under the margin rule:
    a token is compared where every step up to it has a top-two logit gap
    in the CPU's run above 8 times the largest teacher-forced difference
    (4 times the measured difference, on each side). A prompt with a step
    under that gap is compared up to that step, and the run says so; at
    least 3/4 of the tokens must be compared."""
    t0 = time.perf_counter()
    cpu = DecodingPredictor(dirname, place=fluid.CPUPlace())
    try:
        pred._reset_state()
        cpu._reset_state()
        errs = []

        def both(fn, *args):
            g = getattr(pred, fn)(*args)
            c = getattr(cpu, fn)(*args)
            err, scale = float(np.abs(g - c).max()), float(np.abs(c).max())
            check(np.isfinite(g).all() and err <= 1e-3 * scale,
                  'decode %s GPU and CPU logits differ: %r of %r'
                  % (fn, err, scale))
            errs.append((err, scale))
            return g

        buckets = sorted(DECODE['prompt_buckets'])
        for L in buckets:
            p = next(p for p in prompts
                     if min(b for b in buckets if len(p) <= b) == L)
            padded = np.zeros((1, L), np.int64)
            padded[0, :len(p)] = p
            both('_dispatch_prefill', L, padded, len(p), 0)
        n_pre = len(errs)
        gate = prompts[:DECODE_GATE_PROMPTS]
        last = []
        for s, p in enumerate(gate):
            L = min(b for b in buckets if len(p) <= b)
            padded = np.zeros((1, L), np.int64)
            padded[0, :len(p)] = p
            last.append(int(np.argmax(both('_dispatch_prefill', L, padded,
                                           len(p), s))))
        S = DECODE['max_slots']
        for t in range(DECODE_TF_STEPS):
            tokens = np.zeros((S, 1), np.int64)
            pos = np.zeros((S, 1), np.int32)
            for s, p in enumerate(gate):
                tokens[s, 0] = last[s]
                pos[s, 0] = len(p) + t
            logits = both('_dispatch_step', tokens, pos)
            last = [int(np.argmax(logits[s])) for s in range(len(gate))]
        worst = max(e / sc for e, sc in errs)
        e_tf = max(e for e, _ in errs)
        print('decode-base gpu_vs_cpu: %d prefills (one a bucket %s, then '
              '%d slots) and %d teacher-forced steps, max_abs_err=%r '
              'max_rel_err=%r (prefill per bucket %s) tolerance_rel=1e-3'
              % (len(errs) - DECODE_TF_STEPS, buckets, len(gate),
                 DECODE_TF_STEPS, e_tf, worst,
                 ['%.3g' % (e / sc) for e, sc in errs[:n_pre]]))

        margin_tol = 8 * e_tf
        rec = collections.defaultdict(list)
        first0, adv0 = cpu._first_token, cpu._advance_greedy

        def first(req, logits):
            rec[id(req.stream)].append(_top2_gap(logits))
            return first0(req, logits)

        def adv(req, logits, now):
            rec[id(req.stream)].append(_top2_gap(logits[req.slots[0]]))
            return adv0(req, logits, now)
        cpu._first_token, cpu._advance_greedy = first, adv
        cpu._reset_state()
        n_new = min(DECODE_GATE_NEW, DECODE_MAX_NEW)
        streams = [cpu.submit(p, max_new_tokens=n_new) for p in gate]
        got = [s.result(600) for s in streams]
        compared = total = 0
        for i, (s, toks) in enumerate(zip(streams, got)):
            want = seq[i][:n_new]
            gaps = rec[id(s)]
            k = next((j for j, g in enumerate(gaps) if g <= margin_tol),
                     len(gaps))
            if k < len(gaps):
                print('decode-base gpu_vs_cpu: prompt %d step %d has a '
                      'top-two gap of %r <= %r: compared up to that step'
                      % (i, k, gaps[k], margin_tol))
            check(toks[:k] == want[:k] and
                  (k < len(gaps) or toks == want),
                  'decode greedy transcript %d differs GPU vs CPU: %s vs %s'
                  % (i, toks, want))
            compared += min(k, len(want))
            total += len(want)
        check(compared * 4 >= total * 3, 'only %d of %d tokens compared'
              % (compared, total))
        print('decode-base gpu_vs_cpu greedy: %d prompts, %d of %d tokens '
              'equal, every compared step with a CPU top-two gap above %r '
              '(smallest gap %r); cpu side %.1fs' % (
                  len(gate), compared, total, margin_tol,
                  min(min(g) for g in rec.values()),
                  time.perf_counter() - t0))
    finally:
        cpu.close()


def _phase_seconds(label, t0):
    print('phase %s seconds %.1f' % (label, time.perf_counter() - t0))


def build_zoo_training(name, amp=True):
    """ZOO[name]'s program as bench.py builds it: build_train_net at its
    image side and classes, seeded initialization, marked for bf16 by
    enable_bf16 (with amp)."""
    spec = ZOO[name]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    side = spec['side']
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, loss, acc = spec['module'].build_train_net(
            dshape=(3, side, side), class_dim=spec['classes'],
            **spec['kwargs'])
    return _mark(main, amp), startup, loss, acc


def _zoo_feed(spec, batch, gen):
    """One batch as bench.py:411-416 makes it: standard normal images and
    uniform labels, made on the card."""
    side = spec['side']
    return {'data': torch.randn(batch, 3, side, side, device='cuda',
                                generator=gen),
            'label': torch.randint(0, spec['classes'], (batch, 1),
                                   device='cuda', generator=gen)}


def _slope_ms(run_k, k):
    """bench.py:318-355's device time a unit (a step or a batch): the best
    of SLOPE_REPS calls of run_k(K) and of run_k(K/2), each after one
    untimed call, on the host clock and ending in a sync; (T(K) - T(K/2))
    / (K - K/2). run_k dispatches K units through run_steps (or
    run_batches) on a K-group staged outside the timed region. The port's
    run_steps is a Python loop of run() calls, so the slope is the larger
    of a unit's device time and its host time."""
    def timed(kk):
        run_k(kk)
        torch.cuda.synchronize()
        best = float('inf')
        for _ in range(SLOPE_REPS):
            t0 = time.perf_counter()
            run_k(kk)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best
    k2 = max(1, k // 2)
    tk, tk2 = timed(k), timed(k2)
    return (tk - tk2) / (k - k2) * 1e3


def _grouped_conv_ms(run_once, calls=3):
    """Device ms a call of the kernels that grouped convolutions launch
    (cuDNN's forward, data and filter gradients and their layout
    transposes), under torch.profiler with shapes recorded: the kernels of
    each op whose input shapes hold an input [N, C, H, W] followed by a
    filter [C, C/g, kh, kw] with g > 1 (the forward's (x, w), the
    backward's (input, weight)). None where the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(calls):
            run_once()
        torch.cuda.synchronize()
    grouped = total = 0.0
    for e in prof.events():
        us = sum(k.duration for k in e.kernels)
        total += us
        shapes = [s for s in (e.input_shapes or [])]
        if us and any(
                len(a) == 4 and len(w) == 4 and w[1] > 0 and w[0] == a[1]
                and a[1] % w[1] == 0 and a[1] // w[1] > 1
                for a, w in zip(shapes, shapes[1:])):
            grouped += us
    if not total:
        return None
    return grouped * 1e-3 / calls


def phase_zoo_training(name):
    """ZOO[name] on the card as bench.py runs its row: the op census,
    startup, TRAIN_WARMUP_STEPS, then TRAIN_STEPS timed steps (host clock
    around Executor.run and a sync) on one fixed batch, fetching the loss
    and the accuracy. Each timed step launches bn_apply exactly
    ZOO[name]['bn'] times, all bf16, and no other kernel of the port; every
    loss is finite. Prints p50, p90, img/s, MFU where bench.py gives the
    FLOPs, peak allocated memory, the device ms a step by bench.py's slope
    over run_steps (_slope_ms), and a 3-step profile (with SE-ResNeXt, the
    grouped convolutions' share). Returns the launches over the timed
    steps and a summary."""
    spec = ZOO[name]
    t0 = time.perf_counter()
    main, startup, loss, acc = build_zoo_training(name)
    ops = main.global_block().ops
    census = collections.Counter(op.type for op in ops)
    groups = [op.attrs.get('groups') or 1 for op in ops
              if op.type == 'conv2d']
    grouped = sum(g > 1 for g in groups)
    check(2 * census['batch_norm'] == spec['bn']
          and census['batch_norm_grad'] == census['batch_norm'],
          '%s: %d batch_norm ops' % (name, census['batch_norm']))
    print('model %s build_train_net(%s) %dx%d classes=%d bf16 (enable_bf16) '
          'ops=%d batch_norm=%d concat=%d dropout=%d conv2d=%d grouped=%d '
          'parameters=%d parameter_elements=%d build_s=%.1f' % (
              name, spec['kwargs'], spec['side'], spec['side'],
              spec['classes'], len(ops), census['batch_norm'],
              census['concat'], census['dropout'], census['conv2d'], grouped,
              len(main.all_parameters()),
              sum(int(np.prod(p.shape)) for p in main.all_parameters()),
              time.perf_counter() - t0))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 30)
    batch = spec['batch']
    feed = _zoo_feed(spec, batch, gen)
    losses, accs = [], []

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss, acc], scope=scope,
                       return_numpy=False)

    def record(out):
        losses.append(float(out[0].reshape(-1)[0]))
        accs.append(float(out[1].reshape(-1)[0]))

    for _ in range(TRAIN_WARMUP_STEPS):
        record(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = {'bn_apply': spec['bn'], 'flash_attn_fwd': 0,
            'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}
    reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        before, before_dt = read_launches(), read_launches_by_dtype()
        t1 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        after = read_launches()
        launched = {k: after[k] - before[k] for k in after}
        check(launched == want, '%s: a step launched %s, not %s'
              % (name, launched, want))
        by_dt = _by_dtype_step(before_dt, read_launches_by_dtype())
        check(by_dt['bn_apply']['bfloat16'] == spec['bn'],
              '%s: a step launched bn_apply %s, not all bf16'
              % (name, by_dt['bn_apply']))
        record(out)
    counts = read_launches()
    counts_by_dtype = read_launches_by_dtype()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), '%s: non-finite loss: %s'
          % (name, losses))
    p50 = float(np.percentile(times, 50))
    img_s = batch / p50
    mfu = None if spec['flops'] is None else \
        img_s * spec['flops'] / BF16_OPS_PER_S
    print('%s batch=%d lr=0.01 momentum=0.9 losses=%s accuracies=%s' % (
        name, batch, json.dumps([round(x, 5) for x in losses]),
        json.dumps([round(x, 4) for x in accs])))
    print('%s launches over %d timed steps: %s (per step: %s; by dtype: %s)'
          % (name, TRAIN_STEPS, json.dumps(counts), json.dumps(want),
             json.dumps(counts_by_dtype)))
    print('%s step p50_ms=%r p90_ms=%r img_per_s=%r mfu=%s%s '
          'peak_allocated_gb=%.2f (host clock, %d steps, each ending in a '
          'sync)' % (name, p50 * 1e3, float(np.percentile(times, 90)) * 1e3,
                     img_s, 'null' if mfu is None else '%.4f' % mfu,
                     '' if mfu is None else ' (flops_per_img %g at %g bf16 '
                     'dense FLOP/s)' % (spec['flops'], BF16_OPS_PER_S),
                     peak / 2 ** 30, TRAIN_STEPS))

    def run_k(kk):
        group = {n: t.expand((kk,) + tuple(t.shape)) for n, t in feed.items()}
        exe.run_steps(main, feed=group, fetch_list=[loss], scope=scope,
                      return_numpy=False)
    device_ms = _slope_ms(run_k, spec['k'])
    print('%s run_steps slope: device_ms_per_step=%r (K=%d and %d, best of '
          '%d each; host and device overlap: the larger of the two a step)'
          % (name, device_ms, spec['k'], spec['k'] // 2, SLOPE_REPS))

    def once():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
    per_kernel = _profile(once, '%s batch=%d' % (name, batch), 'steps')
    busy = sum(per_kernel.values()) / 3 if per_kernel else None
    summary = dict(batch=batch, ops=len(ops), p50_ms=p50 * 1e3,
                   img_per_s=img_s, mfu=mfu, peak_gb=peak / 2 ** 30,
                   device_ms_slope=device_ms, device_busy_ms=busy)
    if per_kernel and spec['bn']:
        summary['bn_apply_ms'] = sum(
            ms for k, ms in per_kernel.items() if 'bn_apply' in k) / 3
        print('profile %s: bn_apply device_ms_per_step=%r share=%.3f' % (
            name, summary['bn_apply_ms'], summary['bn_apply_ms'] / busy))
    if grouped:
        g_ms = _grouped_conv_ms(once)
        summary['grouped_conv_ms'] = g_ms
        print('profile %s: grouped convolutions (groups=%d, %d ops) '
              'device_ms_per_step=%s share=%s' % (
                  name, max(groups), grouped,
                  'not measured' if g_ms is None else repr(g_ms),
                  'not measured' if g_ms is None or not busy
                  else '%.3f' % (g_ms / busy)))
    del scope, feed
    torch.cuda.empty_cache()
    _phase_seconds(name, t0)
    return counts, summary


def _forward_program(main):
    """The forward ops of `main` (those without an op_role) as a program
    of their own, marked for bf16 where `main` is."""
    fwd = _mark(main.clone(), getattr(main, '_amp_bf16', False))
    fwd.global_block().ops = [op for op in fwd.global_block().ops
                              if not op.attrs.get('op_role')]
    return fwd


def phase_zoo_gpu_vs_cpu(name, amp):
    """One training step of ZOO[name] at ZOO_GATE_BATCH and full image
    size, card against CPU, from one initial state (run on the card,
    carried to the CPU with weights.py), every dropout op given the mask
    the card drew: the loss of the forward ops, then the gradient of every
    parameter from the backward and Momentum ops fed the card's forward
    values of the step (these are ReLU networks: fed the same values, both
    take the same relu masks; phase_resnet_backward_gpu_vs_cpu's design).
    Each within max(1e-5 of its largest value, 4 times the noise): the
    largest move over NOISE_DRAWS one-ulp draws (f32, or one bf16 ulp with
    amp; _perturbed, on the card) of the parameters (and, for the
    gradients, the fed values) on the card plus that on the CPU. The card launches bn_apply once per
    batch_norm op in the forward and once in the backward, in the path's
    dtype."""
    t0 = time.perf_counter()
    label = '%s_gpu_vs_cpu_%s' % (name[:-len('_bf16')], _precision(amp))
    main, startup, loss, _ = build_zoo_training(name, amp)
    n_bn = ZOO[name]['bn'] // 2
    dtype = 'bfloat16' if amp else 'float32'
    forward = _forward_program(main)
    update, fed_names = _update_program(main)
    params = {p.name for p in main.all_parameters()}
    grads = sorted(n + '@GRAD' for n in params)
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    cpu = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    gpu.run(startup, scope=scope)
    state = {v.name: scope.get(v.name).clone() for v in main.list_vars()
             if v.persistable}
    gen = torch.Generator(device='cuda').manual_seed(SEED + 31)
    feed = _zoo_feed(ZOO[name], ZOO_GATE_BATCH, gen)
    masks = {}
    real = tensor_ops.draw_dropout_keep

    def card_masks(ctx, shape, p):
        if ctx.device.type == 'meta':
            return real(ctx, shape, p)
        key = ctx.op.output('Mask')[0]
        if key not in masks:
            check(ctx.device.type == 'cuda', 'the CPU ran before the card')
            masks[key] = real(ctx, shape, p)
        return masks[key].to(ctx.device)

    def launched(fn):
        before = read_launches_by_dtype()['bn_apply']
        out = fn()
        after = read_launches_by_dtype()['bn_apply']
        got = {k: after[k] - before[k] for k in after}
        check(got[dtype] == n_bn and sum(got.values()) == n_bn,
              '%s: bn_apply launched %s, not %d %s' % (label, got, n_bn,
                                                       dtype))
        return out

    tensor_ops.draw_dropout_keep = card_masks
    try:
        fed = dict(zip(fed_names, gpu.run(main, feed=feed,
                                          fetch_list=fed_names, scope=scope,
                                          return_numpy=False)))
        del scope
        block = update.global_block()
        for n, t in fed.items():
            block.var(n).dtype = fluid.convert_dtype(t.dtype)
        runs = {}
        for exe, device in ((gpu, 'cuda'), (cpu, 'cpu')):
            for i in range(NOISE_DRAWS + 1):
                st, fd = state, fed
                if i:
                    st = _perturbed(state, SEED + 40 + 2 * i, amp, params)
                    fd = _perturbed(fed, SEED + 41 + 2 * i, amp)
                sc = fluid.Scope()
                for n, t in st.items():
                    sc.set(n, t.to(device))

                def fwd():
                    return exe.run(forward, feed={n: t.to(device) for n, t
                                                  in feed.items()},
                                   fetch_list=[loss.name], scope=sc)

                def bwd():
                    return exe.run(update, feed={n: t.to(device) for n, t
                                                 in fd.items()},
                                   fetch_list=grads, scope=sc)
                runs[device, i] = (launched(fwd) if device == 'cuda'
                                   else fwd()) + (
                    launched(bwd) if device == 'cuda' else bwd())
                del sc
    finally:
        tensor_ops.draw_dropout_keep = real
    n_dropout = sum(op.type == 'dropout' for op in forward.global_block().ops)
    check(len(masks) == n_dropout, '%s: %d masks drawn, not %d'
          % (label, len(masks), n_dropout))
    worst, failed = (0.0, ''), []
    first_conv = next(op.input('Filter')[0] for op in forward.global_block().ops
                      if op.type == 'conv2d')
    shown = {loss.name, first_conv + '@GRAD', 'batch_norm_0.w_0@GRAD',
             main.all_parameters()[-1].name + '@GRAD'}
    for j, name_j in enumerate([loss.name] + grads):
        g, w = runs['cuda', 0][j], runs['cpu', 0][j]
        noise = sum(max(float(np.abs(runs[d, i][j] - runs[d, 0][j]).max())
                        for i in range(1, NOISE_DRAWS + 1))
                    for d in ('cuda', 'cpu'))
        err, top = float(np.abs(g - w).max()), float(np.abs(w).max())
        tol = max(1e-5 * top, 4 * noise)
        if name_j in shown:
            print('%s batch=%d %s shape=%s max_abs_err=%r max_abs=%r '
                  'one_ulp_noise=%r tolerance=%r' % (
                      label, ZOO_GATE_BATCH, name_j, tuple(w.shape), err, top,
                      noise, tol))
        if not (g.shape == w.shape and np.isfinite(g).all() and err <= tol
                and (top > 0 or name_j == loss.name)):
            failed.append((name_j, err, tol, top))
        worst = max(worst, (err / tol, name_j))
    print('%s batch=%d: the loss and %d gradients (the backward fed the '
          'card\'s forward values, %d of them bf16; %d card masks given to '
          'the CPU) worst err/tol=%.3f (%s)' % (
              label, ZOO_GATE_BATCH, len(grads),
              sum(t.dtype == torch.bfloat16 for t in fed.values()),
              len(masks), worst[0], worst[1]))
    check(not failed, 'GPU and CPU %s differ (name, err, tolerance, largest '
          'value): %s' % (label, failed[:10]))
    _phase_seconds(label, t0)


def build_googlenet_serving(dirname):
    """GoogLeNet's inference program (is_train=False: dropout scales by
    its keep rate) at 224x224 and 1000 classes, initialized on the card by
    the startup program and saved as an inference model, as
    bench.py:616-634 builds it. Returns its op count."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 32
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data('data', shape=[3, 224, 224], dtype='float32')
        logits = googlenet.googlenet(img, class_dim=1000, is_train=False)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ['data'], [logits], exe, main)
    return len(main.global_block().ops)


def phase_googlenet_serving(dirname):
    """GoogLeNet served at batch GOOGLENET_SERVE_BATCH in f32 through
    create_predictor(Config(dir)) -> Predictor.run, as bench.py's
    googlenet_infer row serves it: GOOGLENET_LATENCY_REQUESTS requests
    each ending in a sync (p50, p90), then GOOGLENET_THROUGHPUT_REQUESTS
    back to back with one sync (img/s); no kernel of the port launches.
    Then the device ms a batch by bench.py's slope over run_batches, a
    3-request profile, and the CPU's logits from the same directory
    against the card's, within 1e-3 of the largest logit."""
    t0 = time.perf_counter()
    pred = fluid.inference.create_predictor(fluid.inference.Config(dirname))
    gen = torch.Generator(device='cuda').manual_seed(SEED + 33)
    x = torch.randn(GOOGLENET_SERVE_BATCH, 3, 224, 224, device='cuda',
                    generator=gen)
    pred.warmup([x])
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(GOOGLENET_LATENCY_REQUESTS):
        t1 = time.perf_counter()
        out, = pred.run([x], return_numpy=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    for _ in range(GOOGLENET_THROUGHPUT_REQUESTS):
        out, = pred.run([x], return_numpy=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_launches()
    check(not any(counts.values()), 'GoogLeNet serving launched %s' % counts)
    img_s = GOOGLENET_SERVE_BATCH * GOOGLENET_THROUGHPUT_REQUESTS / wall
    print('googlenet_serving batch=%d f32 p50_ms=%r p90_ms=%r (host clock, '
          '%d requests, each ending in a sync) img_per_s=%r (%d requests, '
          'one sync) launches=%s' % (
              GOOGLENET_SERVE_BATCH, float(np.percentile(times, 50)) * 1e3,
              float(np.percentile(times, 90)) * 1e3,
              GOOGLENET_LATENCY_REQUESTS, img_s,
              GOOGLENET_THROUGHPUT_REQUESTS, json.dumps(counts)))

    def run_k(kk):
        pred.run_batches([[x]] * kk, return_numpy=False)
    device_ms = _slope_ms(run_k, GOOGLENET_DEVICE_K)
    print('googlenet_serving run_batches slope: device_ms_per_batch=%r '
          'device_img_per_s=%r (K=%d and %d, best of %d each)' % (
              device_ms, GOOGLENET_SERVE_BATCH / device_ms * 1e3,
              GOOGLENET_DEVICE_K, GOOGLENET_DEVICE_K // 2, SLOPE_REPS))
    _profile(lambda: pred.run([x], return_numpy=False),
             'googlenet_serving batch=%d' % GOOGLENET_SERVE_BATCH,
             'requests')
    got = out.cpu().numpy()
    want, = fluid.inference.create_predictor(fluid.inference.Config(
        dirname).disable_gpu()).run([x.cpu()])
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    print('googlenet_serving gpu_vs_cpu batch=%d logits max_abs_err=%r '
          'max_abs=%r rel=%r tolerance=%r' % (
              GOOGLENET_SERVE_BATCH, err, top, err / top, 1e-3 * top))
    check(got.shape == want.shape == (GOOGLENET_SERVE_BATCH, 1000)
          and np.isfinite(got).all() and err <= 1e-3 * top,
          'GPU and CPU GoogLeNet logits differ: %r of %r' % (err, top))
    _phase_seconds('googlenet_serving', t0)
    return pred, counts


def phase_run_steps_exactness(gnet_pred):
    """Executor.run_steps and Predictor.run_batches against run() on the
    card, bit for bit, with torch.backends.cudnn.deterministic set in this
    phase alone (cuDNN's backward algorithms may otherwise sum with
    atomics, and two runs of one step would differ): VGG-19 at its bench
    batch in bf16 (its two dropout ops need the per-step random stream),
    run_steps(EXACT_STEPS, fetch_policy='stack') on EXACT_STEPS distinct
    batches against as many run() calls, each from the same initial
    state on a fresh Executor: the same losses and every parameter and
    velocity after; and GoogLeNet serving's run_batches(EXACT_BATCHES)
    against as many run() calls."""
    t0 = time.perf_counter()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    print('run_steps_exactness: this phase alone sets '
          'torch.backends.cudnn.deterministic = True')
    try:
        name = 'vgg19_training_bf16'
        spec = ZOO[name]
        main, startup, loss, _ = build_zoo_training(name)
        persist = [v.name for v in main.list_vars() if v.persistable]
        scope = fluid.Scope()
        fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
        start = {n: scope.get(n).clone() for n in persist
                 if scope.get(n) is not None}
        del scope
        gen = torch.Generator(device='cuda').manual_seed(SEED + 34)
        feeds = [_zoo_feed(spec, spec['batch'], gen)
                 for _ in range(EXACT_STEPS)]
        runs = []
        for k in (1, EXACT_STEPS):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            scope = fluid.Scope()
            for n, t in start.items():
                scope.set(n, t.clone())
            if k == 1:
                losses = torch.stack([exe.run(
                    main, feed=f, fetch_list=[loss], scope=scope,
                    return_numpy=False)[0] for f in feeds])
            else:
                losses, = exe.run_steps(
                    main, feed={n: torch.stack([f[n] for f in feeds])
                                for n in feeds[0]},
                    fetch_list=[loss], scope=scope, fetch_policy='stack',
                    return_numpy=False)
            runs.append((losses, {n: scope.get(n) for n in start}))
            del scope
        (la, sa), (lb, sb) = runs
        moved = sum(not torch.equal(sa[n], start[n]) for n in start)
        differ = [n for n in start if not torch.equal(sa[n], sb[n])]
        print('run_steps_exactness %s batch=%d: losses run()=%s '
              'run_steps=%s; %d persistables (%d moved), %d differ' % (
                  name, spec['batch'], la.reshape(-1).tolist(),
                  lb.reshape(-1).tolist(), len(start), moved, len(differ)))
        check(torch.equal(la, lb) and not differ and moved > 0,
              'run_steps(%d) differs from %d run() calls: losses %s / %s, '
              'persistables %s' % (EXACT_STEPS, EXACT_STEPS, la.tolist(),
                                   lb.tolist(), differ[:10]))
        del runs, start, sa, sb, feeds
        torch.cuda.empty_cache()
        batches = [[torch.randn(GOOGLENET_SERVE_BATCH, 3, 224, 224,
                                device='cuda', generator=gen)]
                   for _ in range(EXACT_BATCHES)]
        want = [gnet_pred.run(b, return_numpy=False)[0] for b in batches]
        got = gnet_pred.run_batches(batches, return_numpy=False)
        equal = [torch.equal(g[0], w) for g, w in zip(got, want)]
        print('run_steps_exactness googlenet_serving run_batches(%d) == %d '
              'run() calls: %s' % (EXACT_BATCHES, EXACT_BATCHES, equal))
        check(len(got) == EXACT_BATCHES and all(equal),
              'run_batches differs from run(): %s' % equal)
    finally:
        torch.backends.cudnn.deterministic = prev
    _phase_seconds('run_steps_exactness', t0)


def phase_zoo_kernel(se_shapes):
    """bn_apply at the zoo's new shapes: VGG-19's 2-D [128, 4096] (inner
    size 1) and SE-ResNeXt-50's 53 BN outputs at batch 128, in f32 and
    bf16: against its plain version (_bn_vs_plain), then timed with its
    bound, plain version and torch.addcmul (phase_kernel_times). Returns
    {label: totals} and the largest |error| by dtype."""
    t0 = time.perf_counter()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 35)
    max_abs = {}
    out = {}
    for what, shapes, batch in (
            ('vgg19_fc_bn_2d', VGG_BN_SHAPES, ZOO['vgg19_training_bf16'][
                'batch']),
            ('se_resnext50', se_shapes, ZOO['se_resnext50_training_bf16'][
                'batch'])):
        _bn_vs_plain(batch, shapes, (torch.float32, torch.bfloat16), gen,
                     max_abs)
        for dtype in (torch.float32, torch.bfloat16):
            out['%s_batch%d_%s' % (what, batch, str(dtype)[6:])] = \
                phase_kernel_times(batch, dtype, shapes, what)
    _phase_seconds('zoo_kernel', t0)
    return out, max_abs


def _artifact_passes(adir):
    """The inference pipeline's reports that export_compiled recorded in
    the artifact's top signature (empty after a fallback to the raw
    program)."""
    with open(os.path.join(adir, 'signature.json')) as f:
        return json.load(f).get('passes', [])


def _scope_bytes(scope):
    return sum(t.numel() * t.element_size() for t in scope._vars.values()
               if t is not None)


def _poisson(batcher, x1, rate, n):
    """n batch-1 requests submitted at the arrival times of a Poisson
    stream at `rate` req/s (RandomState(1)), as bench.py:720-731 sends
    them; returns the wall seconds until the last one resolved."""
    arrivals = np.cumsum(np.random.RandomState(1).exponential(1.0 / rate,
                                                              n))
    futs = []
    t0 = time.perf_counter()
    for i in range(n):
        delay = t0 + arrivals[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futs.append(batcher.submit([x1]))
    for f in futs:
        f.result(600)
    return time.perf_counter() - t0


def _instrument(batcher):
    """Wrap the batcher's staging and each bucket's run: the batches each
    bucket takes (Counter under 'batches'), and the host seconds of each
    batch's staging and of its program's dispatch (lists under 'stage'
    and 'dispatch'; the dispatch returns before the card has finished)."""
    seen = {'batches': collections.Counter(), 'stage': [], 'dispatch': []}
    stage = batcher._stage

    def staged(batch, rows, bs):
        t0 = time.perf_counter()
        out = stage(batch, rows, bs)
        seen['stage'].append(time.perf_counter() - t0)
        return out
    batcher._stage = staged
    for b, pred in batcher._preds.items():
        def counted(args, _b=b, _call=pred._call_flat):
            seen['batches'][_b] += 1
            t0 = time.perf_counter()
            out = _call(args)
            seen['dispatch'].append(time.perf_counter() - t0)
            return out
        pred._call_flat = counted
    return seen


def phase_resnet_artifact_serving(dirname, n_bn):
    """ResNet-50 (the served directory of phase_serving: 224x224, 1000
    classes, random BN state, f32) as bench.py's resnet50_serving row
    serves it: export_compiled at ARTIFACT_BUCKETS (the program after the
    inference pipeline, which folds the 16 residual relus into their
    elementwise_add; a RuntimeWarning, the pipeline's fallback, fails the
    phase) -> BatchingPredictor -> warmup; the card's allocated bytes
    before and after the batcher loads
    (one copy of the parameters for all buckets: at most 1.1x the
    persistable bytes); ARTIFACT_SEQ_REQUESTS batch-1
    CompiledPredictor.run calls through bucket 1; the capacity from
    ARTIFACT_CAPACITY_CALLS full-bucket batcher.run calls; ARTIFACT_REQUESTS
    Poisson batch-1 requests at ARTIFACT_RATE_SHARE of it (served img/s,
    occupancy, p50/p95/p99, batches per bucket; exactly n_bn f32 bn_apply
    launches per batch dispatched over the capacity and Poisson arms); a
    shorter Poisson pass under the profiler; run_batches at bucket
    ARTIFACT_SLOPE_BUCKET (slope, and 8 batches equal to 8 run() calls
    bit for bit); a single-bucket {ARTIFACT_EXACT_BUCKET} artifact taking
    as many concurrent batch-1 submits, each equal to CompiledPredictor.run
    of that request through the bucket bit for bit; each bucket's
    peak_bytes_est beside the measured peak of one batch; and each
    bucket's first logits against the CPU's within 1e-3 of the largest."""
    t0 = time.perf_counter()
    pred = fluid.inference.create_predictor(fluid.inference.Config(dirname))
    sample = np.random.RandomState(0).randn(
        max(ARTIFACT_BUCKETS), 3, 224, 224).astype(np.float32)
    adir = os.path.join(dirname, 'artifact')
    t1 = time.perf_counter()
    with warnings.catch_warnings():
        # the pipeline's fallback to the raw program warns: fail on it
        warnings.simplefilter('error', RuntimeWarning)
        export_compiled(pred, [sample], adir, batch_sizes=ARTIFACT_BUCKETS)
        export_s = time.perf_counter() - t1
    reports = _artifact_passes(adir)
    names = [r['pass'] for r in reports]
    check(names == passes.pipeline_names(passes.INFERENCE_PIPELINE),
          'resnet export pipeline ran %s' % names)
    fused = reports[names.index('fuse_activation')]['details']['fused']
    with open(os.path.join(adir, '__model__')) as f:
        model_ops = collections.Counter(op['type'] for op in
                                        json.load(f)['blocks'][0]['ops'])
    raw_ops = collections.Counter(op.type for op in
                                  pred._program.global_block().ops)
    print('artifact_serving inference pipeline: ops %d -> %d (relu %d -> '
          '%d; %d activations fused into their producer), reports: %s' % (
              sum(raw_ops.values()), sum(model_ops.values()),
              raw_ops['relu'], model_ops['relu'], fused,
              json.dumps(reports)))
    check(fused == 16 and model_ops['batch_norm'] == n_bn
          and sum(model_ops.values()) == reports[-1]['ops']['after'],
          'the exported ResNet-50 program is not the pipeline\'s: %s'
          % dict(model_ops))
    persist = _scope_bytes(pred._scope)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    batcher = BatchingPredictor(adir, batch_timeout_ms=ARTIFACT_TIMEOUT_MS)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    print('artifact_serving export_s=%r buckets=%s persistable_bytes=%d '
          'allocated_before=%d after_load=%d rise=%d rise_over_persistable'
          '=%.4f (gate <= 1.1)' % (export_s, batcher.buckets, persist, mem0,
                                   mem1, mem1 - mem0,
                                   (mem1 - mem0) / persist))
    check(batcher.buckets == list(ARTIFACT_BUCKETS), 'buckets %s'
          % batcher.buckets)
    check(mem1 - mem0 <= 1.1 * persist,
          'the batcher loaded %d bytes for %d persistable bytes: more than '
          'one copy' % (mem1 - mem0, persist))
    try:
        batcher.warmup()
        x1 = sample[:1]

        seq = CompiledPredictor(os.path.join(adir, 'bucket_00001'))
        for _ in range(2):
            seq.run([x1])
        t1 = time.perf_counter()
        for _ in range(ARTIFACT_SEQ_REQUESTS):
            seq.run([x1])
        seq_img_s = ARTIFACT_SEQ_REQUESTS / (time.perf_counter() - t1)
        del seq
        torch.cuda.synchronize()

        seen = _instrument(batcher)
        reset_launches()
        t1 = time.perf_counter()
        for _ in range(ARTIFACT_CAPACITY_CALLS):
            batcher.run([sample], timeout=600)
        cap_img_s = (max(ARTIFACT_BUCKETS) * ARTIFACT_CAPACITY_CALLS
                     / (time.perf_counter() - t1))
        cap_batches = batcher.stats.snapshot()['batches']
        cap_host = (np.mean(seen['stage']) * 1e3,
                    np.mean(seen['dispatch']) * 1e3)
        batcher.stats.reset()   # report the Poisson run, not calibration
        del seen['stage'][:], seen['dispatch'][:]
        rate = ARTIFACT_RATE_SHARE * cap_img_s
        wall = _poisson(batcher, x1, rate, ARTIFACT_REQUESTS)
        snap = batcher.stats.snapshot()
        counts = read_launches()
        by_dtype = read_launches_by_dtype()['bn_apply']
        dispatched = cap_batches + snap['batches']
        buckets = dict(seen['batches'])
        buckets[max(ARTIFACT_BUCKETS)] -= ARTIFACT_CAPACITY_CALLS
        host = (np.mean(seen['stage']) * 1e3,
                np.mean(seen['dispatch']) * 1e3)
        print('artifact_serving poisson host ms a batch, in order: staging '
              '%s dispatch %s' % (
                  [round(t * 1e3, 2) for t in seen['stage']],
                  [round(t * 1e3, 2) for t in seen['dispatch']]))
        print('artifact_serving sequential batch-1 CompiledPredictor.run '
              'img_per_s=%r (%d requests back to back, each ending in a '
              'sync)' % (seq_img_s, ARTIFACT_SEQ_REQUESTS))
        print('artifact_serving capacity img_per_s=%r (%d batcher.run calls '
              'at bucket %d; a batch: host staging %.2f ms, host dispatch '
              '%.2f ms)' % ((cap_img_s, ARTIFACT_CAPACITY_CALLS,
                             max(ARTIFACT_BUCKETS)) + cap_host))
        print('artifact_serving poisson requests=%d served_img_per_s=%r '
              'offered_req_per_s=%r batches=%d occupancy=%r p50_ms=%r '
              'p95_ms=%r p99_ms=%r shed=%d expired=%d batches_by_bucket=%s '
              'speedup_vs_sequential=%r; a batch: host staging %.2f ms, '
              'host dispatch %.2f ms' % ((
                  ARTIFACT_REQUESTS, ARTIFACT_REQUESTS / wall, rate,
                  snap['batches'], snap['occupancy'], snap['p50_ms'],
                  snap['p95_ms'], snap['p99_ms'], snap['shed'],
                  snap['expired'], json.dumps(buckets),
                  ARTIFACT_REQUESTS / wall / seq_img_s) + host))
        print('artifact_serving launches=%s bn_apply_by_dtype=%s over %d '
              'dispatched batches' % (json.dumps(counts), json.dumps(by_dtype),
                                      dispatched))
        check(snap['requests'] == ARTIFACT_REQUESTS and not snap['shed']
              and not snap['expired'], 'poisson arm: %s' % snap)
        check(sum(seen['batches'].values()) == dispatched,
              'bucket counts %s vs %d batches' % (dict(seen['batches']),
                                                  dispatched))
        check(counts['bn_apply'] == n_bn * dispatched
              and by_dtype.get('float32', 0) == counts['bn_apply'],
              'bn_apply launched %s over %d batches, not %d f32 each'
              % (by_dtype, dispatched, n_bn))
        check(counts['flash_attn_fwd'] == counts['flash_attn_bwd_dkv']
              == counts['flash_attn_bwd_dq'] == 0,
              'artifact serving launched a flash-attention kernel')

        _profile(lambda: _poisson(batcher, x1, rate,
                                  ARTIFACT_PROFILE_REQUESTS),
                 'artifact_serving poisson', 'passes of %d requests'
                 % ARTIFACT_PROFILE_REQUESTS, calls=1)

        # the same bucket's predictor the batcher runs, sharing its model
        b8 = batcher._preds[ARTIFACT_SLOPE_BUCKET]
        gen = np.random.RandomState(2)
        xs = [gen.randn(ARTIFACT_SLOPE_BUCKET, 3, 224, 224).astype(
            np.float32) for _ in range(EXACT_BATCHES)]
        want = [b8.run([x])[0] for x in xs]
        got = b8.run_batches([[x] for x in xs])
        equal = [np.array_equal(g[0], w) for g, w in zip(got, want)]
        print('artifact_serving run_batches(%d) == %d run() calls at bucket '
              '%d: %s' % (EXACT_BATCHES, EXACT_BATCHES,
                          ARTIFACT_SLOPE_BUCKET, equal))
        check(all(equal), 'run_batches differs from run(): %s' % equal)
        device_ms = _slope_ms(lambda kk: b8.run_batches([[xs[0]]] * kk),
                              EXACT_BATCHES)
        print('artifact_serving run_batches slope at bucket %d: '
              'ms_per_batch=%r img_per_s=%r (K=%d and %d, best of %d each) '
              'bulk_stats=%s' % (
                  ARTIFACT_SLOPE_BUCKET, device_ms,
                  ARTIFACT_SLOPE_BUCKET / device_ms * 1e3, EXACT_BATCHES,
                  EXACT_BATCHES // 2, SLOPE_REPS, json.dumps(b8.bulk_stats())))

        # each bucket's static peak_bytes_est (passes/dataflow.py) beside
        # the allocated bytes one batch adds above the loaded model
        for b in ARTIFACT_BUCKETS:
            with open(os.path.join(adir, 'bucket_%05d' % b,
                                   'signature.json')) as f:
                est = json.load(f).get('peak_bytes_est')
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            batcher._preds[b].run([sample[:b]])
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base
            print('artifact_serving bucket=%d peak_bytes_est=%s measured: '
                  'parameters on the card %d + the peak rise of one batch '
                  '%d = %d bytes (the estimate counts the parameters, the '
                  'input and the largest set of live temporaries)'
                  % (b, est, persist, rise, persist + rise))
            check(isinstance(est, int) and est > 0,
                  'bucket %d signature has no peak_bytes_est' % b)
        cpu = CompiledPredictor(
            os.path.join(adir, 'bucket_%05d' % ARTIFACT_CPU_ROWS),
            platform='cpu')
        want, = cpu.run([sample[:ARTIFACT_CPU_ROWS]])
        top = float(np.abs(want).max())
        for b in ARTIFACT_BUCKETS:
            got, = batcher._preds[b].run([sample[:b]])
            rows = min(b, ARTIFACT_CPU_ROWS)
            err = float(np.abs(got[:rows] - want[:rows]).max())
            print('artifact_serving gpu_vs_cpu bucket=%d rows=%d '
                  'max_abs_err=%r max_abs_logit=%r rel=%r tolerance_rel=1e-3'
                  % (b, rows, err, top, err / top))
            check(got.shape == (b, 1000) and np.isfinite(got).all()
                  and err <= 1e-3 * top,
                  'bucket %d logits differ from the CPU: %r of %r'
                  % (b, err, top))
    finally:
        batcher.close()
    del batcher
    torch.cuda.empty_cache()

    edir = os.path.join(dirname, 'artifact_%d' % ARTIFACT_EXACT_BUCKET)
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        export_compiled(pred, [sample[:ARTIFACT_EXACT_BUCKET]], edir,
                        batch_sizes=[ARTIFACT_EXACT_BUCKET])
    del pred
    n = ARTIFACT_EXACT_BUCKET
    reqs = [sample[i:i + 1] for i in range(n)][::-1]  # rows move
    solo = CompiledPredictor(edir)
    want = [solo.run([r])[0] for r in reqs]
    with BatchingPredictor(edir, batch_timeout_ms=2000.0) as exact:
        exact.warmup()
        results = [None] * n
        gate = threading.Barrier(n)

        def client(i):
            gate.wait(timeout=120)
            results[i] = exact.submit([reqs[i]]).result(timeout=600)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        esnap = exact.stats.snapshot()
    equal = sum(np.array_equal(results[i][0], want[i]) for i in range(n))
    print('artifact_serving bit_identity bucket=%d concurrent=%d batches=%d '
          'equal=%d/%d' % (n, n, esnap['batches'], equal, n))
    check(equal == n and esnap['requests'] == n,
          '%d of %d batched requests differ from their unbatched run'
          % (n - equal, n))
    del solo
    torch.cuda.empty_cache()
    _phase_seconds('resnet_artifact_serving', t0)
    return counts


def phase_compiled_trainer():
    """bench.py:431's ResNet-50 training program (s2d stem, Momentum) in
    bf16 (enable_bf16) at batch TRAINER_BATCH, exported by
    export_train_step and trained by CompiledTrainer: TRAINER_STEPS steps
    against as many Executor.run steps from the same state, bit for bit
    (losses and every persistable), with torch.backends.cudnn.deterministic
    set and restored here as phase_run_steps_exactness does; exactly
    2 x 53 bf16 bn_apply launches a step; and a trainer resumed by
    load_state from a checkpoint saved after step 2 takes step 3 as the
    first one did."""
    t0 = time.perf_counter()
    main, startup, loss, acc = build_resnet_training(amp=True)
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 40)
    feed = {n: t.cpu().numpy()
            for n, t in _resnet_feed(TRAINER_BATCH, gen).items()}
    with tempfile.TemporaryDirectory() as d:
        tdir = os.path.join(d, 'train_artifact')
        t1 = time.perf_counter()
        export_train_step(main, feed, [loss, acc], tdir, scope=scope)
        export_s = time.perf_counter() - t1
        start = {n: scope.get(n).clone() for n in
                 (v.name for v in main.list_vars() if v.persistable)
                 if scope.get(n) is not None}
        del scope
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        print('compiled_trainer: this phase sets '
              'torch.backends.cudnn.deterministic = True and restores it')
        try:
            trainer = CompiledTrainer(tdir)
            check(trainer.place == fluid.CUDAPlace(0), 'trainer place')
            reset_launches()
            times, losses = [], []
            for _ in range(TRAINER_STEPS):
                t1 = time.perf_counter()
                losses.append(trainer.step(feed)[0])
                times.append(time.perf_counter() - t1)
            counts = read_launches()
            by_dtype = read_launches_by_dtype()['bn_apply']
            final = trainer.state

            exe = fluid.Executor(fluid.CUDAPlace(0))
            escope = fluid.Scope()
            for n, t in start.items():
                escope.set(n, t.clone())
            want = [exe.run(main, feed=feed, fetch_list=[loss, acc],
                            scope=escope)[0] for _ in range(TRAINER_STEPS)]
            differ = [n for n in final if not np.array_equal(
                final[n], escope.get(n).cpu().numpy())]
            moved = sum(not torch.equal(escope.get(n), start[n])
                        for n in start)
            del escope, exe
            print('compiled_trainer resnet50 s2d bf16 batch=%d export_s=%r '
                  'state_vars=%d losses=%s executor_losses=%s; %d '
                  'persistables (%d moved), %d differ; step_ms=%s '
                  'launches=%s bn_apply_by_dtype=%s' % (
                      TRAINER_BATCH, export_s, len(final),
                      [float(l[0]) for l in losses],
                      [float(w[0]) for w in want], len(final), moved,
                      len(differ), [t * 1e3 for t in times],
                      json.dumps(counts), json.dumps(by_dtype)))
            check(all(np.array_equal(l, w) for l, w in zip(losses, want))
                  and not differ and moved > 0,
                  'CompiledTrainer differs from Executor.run: %s vs %s, %s'
                  % (losses, want, differ[:10]))
            check(counts['bn_apply'] == 2 * 53 * TRAINER_STEPS
                  and by_dtype.get('bfloat16', 0) == counts['bn_apply'],
                  'bn_apply launched %s over %d trainer steps, not 106 bf16 '
                  'a step' % (by_dtype, TRAINER_STEPS))

            first = CompiledTrainer(tdir)
            for _ in range(TRAINER_STEPS - 1):
                first.step(feed)
            ckpt = os.path.join(d, 'ckpt.npz')
            first.save_state(ckpt)
            del first
            resumed = CompiledTrainer(tdir)
            resumed.load_state(ckpt)
            last = resumed.step(feed)[0]
            rstate = resumed.state
            rdiffer = [n for n in final
                       if not np.array_equal(final[n], rstate[n])]
            print('compiled_trainer resume after step %d: step %d loss=%r '
                  '(first trainer %r), %d persistables differ' % (
                      TRAINER_STEPS - 1, TRAINER_STEPS, float(last[0]),
                      float(losses[-1][0]), len(rdiffer)))
            check(np.array_equal(last, losses[-1]) and not rdiffer,
                  'resumed trainer differs: %r vs %r, %s'
                  % (last, losses[-1], rdiffer[:10]))
        finally:
            torch.backends.cudnn.deterministic = prev
    torch.cuda.empty_cache()
    _phase_seconds('compiled_trainer', t0)
    return counts


# -- program passes, freeing, remat -----------------------------------------
def phase_resnet_f32_bench_batch(main, startup, loss, acc):
    """bench_resnet's f32 configuration (PTPU_BENCH_DTYPE=f32,
    bench.py:431-445): ResNet-50 with the s2d stem and Momentum(0.1, 0.9)
    trained in f32 at batch RESNET_F32_BENCH_BATCH, which fits on one card
    only because the Executor frees each value after its last reader:
    phase_resnet_training at that batch (TRAIN_WARMUP_STEPS, TRAIN_STEPS
    timed and RESNET_F32_BENCH_MORE_STEPS untimed steps; loss finite and
    falling; exactly 2 f32 bn_apply launches per batch_norm, 106, a
    step). Returns the launches over the timed steps."""
    t0 = time.perf_counter()
    exe, scope, feed, counts = phase_resnet_training(
        main, startup, loss, acc, batch=RESNET_F32_BENCH_BATCH,
        more_steps=RESNET_F32_BENCH_MORE_STEPS)
    del exe, scope, feed
    torch.cuda.empty_cache()
    _phase_seconds('resnet_training_f32_bench_batch', t0)
    return counts


def phase_memory_summary(r_main, r_loss, r_acc):
    """The ResNet-50 training phases' peak allocated memory beside the
    peaks before freeing (PEAK_GB_NOTHING_FREED) and the static estimate
    of passes/dataflow.py at each batch (peak_memory: the resident
    parameters, feeds and optimizer state plus the largest sum of
    temporaries whose live intervals overlap, every var at its declared
    dtype, so the bf16 rows carry the f32 program's estimate). The
    estimate leaves out what an op allocates inside itself (a generic
    grad's re-run forward and its autograd graph, cuDNN workspaces)."""
    dfa = passes.analyze_program(r_main, feed_names=['data', 'label'],
                                 fetch_names=[r_loss.name, r_acc.name])
    for label, batch in (
            ('resnet_training', RESNET_TRAIN_BATCH),
            ('resnet_training_batch%d' % RESNET_F32_BENCH_BATCH,
             RESNET_F32_BENCH_BATCH),
            ('resnet_training_bf16', RESNET_AMP_BATCH)):
        est = dfa.peak_memory(batch=batch)
        before = PEAK_GB_NOTHING_FREED.get(label)
        print('memory %s batch=%d peak_allocated_gb=%.2f '
              'before_freeing_gb=%s static_estimate_gb=%.2f (resident %.2f '
              '+ temporaries %.2f; peak at op %d %s)' % (
                  label, batch, PEAKS[label] / 2 ** 30,
                  'not measured' if before is None else '%.2f' % before,
                  est.peak_bytes / 2 ** 30, est.resident_bytes / 2 ** 30,
                  est.temps_peak_bytes / 2 ** 30, est.peak_op_index,
                  est.peak_op_type))
        if before is not None:
            check(PEAKS[label] < before * 2 ** 30,
                  '%s: the peak %.2f GB is not below the %.2f GB of a step '
                  'that freed nothing' % (label, PEAKS[label] / 2 ** 30,
                                          before))


def _remat_gate(label, plain, remat, startup, names, feed, seed, amp,
                steps=3):
    """A remat arm against its no-remat arm on the card, from one initial
    state (the startup program's, copied into each arm's scope on the
    card) and one feed: `steps` steps of each, the first fetching
    `names` (the loss, then gradients); each arm's step again from the
    state moved by one ulp (_perturbed: f32, or bf16 with amp) in
    NOISE_DRAWS draws. Each name of the first step is gated as _gate_rows
    gates GPU against CPU: within max(1e-5 of its largest value, 4 times
    the noise, the largest move over the draws of one arm plus the
    other's); the later losses within the first loss's tolerance. An arm
    draws its dropout masks at the steps and microbatches the other does
    (a fresh Executor each), and the remat arm replays them in its
    segments' grads. Prints whether each value is equal bit for bit."""
    t0 = time.perf_counter()
    sc = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=sc)
    state = {v.name: sc.get(v.name) for v in plain.list_vars()
             if v.persistable and sc.get(v.name) is not None}
    del sc

    def scope_of(st):
        scope = fluid.Scope()
        for n, t in st.items():
            scope.set(n, t.clone())
        return scope
    first, losses, noise = {}, {}, {}
    for arm, prog in (('plain', plain), ('remat', remat)):
        scope = scope_of(state)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        outs = [exe.run(prog, feed=feed, scope=scope,
                        fetch_list=names if i == 0 else names[:1])
                for i in range(steps)]
        first[arm] = outs[0]
        losses[arm] = [float(o[0].reshape(-1)[0]) for o in outs]
        del scope, exe
        moves = []
        for i in range(1, NOISE_DRAWS + 1):
            scope = scope_of(_perturbed(state, seed + i, amp))
            out = fluid.Executor(fluid.CUDAPlace(0)).run(
                prog, feed=feed, fetch_list=names, scope=scope)
            moves.append([float(np.abs(a - b).max())
                          for a, b in zip(out, first[arm])])
            del scope
        noise[arm] = [max(m[j] for m in moves) for j in range(len(names))]
        torch.cuda.empty_cache()
    rows = []
    for j, name in enumerate(names):
        g, w = first['remat'][j], first['plain'][j]
        err, top = float(np.abs(g - w).max()), float(np.abs(w).max())
        nz = noise['plain'][j] + noise['remat'][j]
        rows.append((name, g, w, err, top, nz, max(1e-5 * top, 4 * nz)))
        print('%s %s equal_bit_for_bit=%s' % (label, name,
                                              bool(np.array_equal(g, w))))
    worst = _gate_rows(label, 'step=0', rows)
    tol = rows[0][-1]
    diffs = [abs(a - b) for a, b in zip(losses['remat'], losses['plain'])]
    print('%s losses remat=%s no_remat=%s max_abs_diff=%r tolerance=%r '
          'worst err/tol=%.3f (%s); %.1f s' % (
              label, json.dumps(losses['remat']),
              json.dumps(losses['plain']), max(diffs), tol, worst[0],
              worst[1], time.perf_counter() - t0))
    check(all(d <= tol for d in diffs), '%s: remat losses %s differ from '
          'the no-remat ones %s' % (label, losses['remat'], losses['plain']))


def phase_bert_remat_training(main, plain, startup, loss):
    """BERT-base at S=512, batch TRAIN_BATCH, f32, dropout 0 with
    checkpoints=True (a remat segment for the embeddings and each encoder
    layer, n_layer + 1 in all): TRAIN_WARMUP_STEPS, then TRAIN_STEPS timed
    steps on phase_bert_training's batch. K2 runs inside the segments: in
    the forward each segment's attention runs the forward kernel under
    no_grad (no LSE), and each segment's grad replays it under autograd
    (FlashAttention: the forward with the LSE, then the backward pair), so
    a step launches 2·n_layer flash_attn_fwd, n_layer of each backward
    kernel and no bn_apply, all f32, as without remat. The loss is finite
    and falls; the peak allocated memory must be below the no-remat
    phase's. Then _remat_gate against the no-remat program. Returns the
    launches over the timed steps."""
    t0 = time.perf_counter()
    label = 'bert_training_remat'
    n_layer = BERT['n_layer']
    ops = collections.Counter(op.type for op in main.global_block().ops)
    inner = collections.Counter(op.type for b in main.blocks[1:]
                                for op in b.ops)
    check(ops['remat_segment'] == ops['remat_segment_grad'] == n_layer + 1
          and ops['fused_multihead_attention'] == 0
          and inner['fused_multihead_attention'] == n_layer,
          '%s: %d remat segments, %d grads, %d / %d attentions outside / '
          'inside' % (label, ops['remat_segment'], ops['remat_segment_grad'],
                      ops['fused_multihead_attention'],
                      inner['fused_multihead_attention']))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 10)
    feed = _train_feed(TRAIN_BATCH, gen)
    exe.run(startup, scope=scope)
    losses = []
    for _ in range(TRAIN_WARMUP_STEPS):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        losses.append(float(out.reshape(-1)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = {'bn_apply': 0, 'flash_attn_fwd': 2 * n_layer,
            'flash_attn_bwd_dkv': n_layer, 'flash_attn_bwd_dq': n_layer}
    reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        before, before_dt = read_launches(), read_launches_by_dtype()
        t1 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        after = read_launches()
        step = {k: after[k] - before[k] for k in after}
        check(step == want, '%s: a step launched %s, not %s'
              % (label, step, want))
        by_dt = _by_dtype_step(before_dt, read_launches_by_dtype())
        check(all(by_dt[k]['float32'] == want[k] for k in want),
              '%s: a step launched %s, not all f32' % (label, by_dt))
        losses.append(float(out.reshape(-1)[0]))
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    PEAKS[label] = peak
    check(all(math.isfinite(x) for x in losses), '%s: non-finite loss: %s'
          % (label, losses))
    check(losses[-1] < losses[0], '%s: the loss did not fall: %s'
          % (label, losses))
    p50 = float(np.percentile(times, 50))
    print('%s batch=%d S=%d f32 checkpoints=True ops=%d segments=%d '
          'losses=%s' % (label, TRAIN_BATCH, BERT['max_len'],
                         sum(ops.values()), ops['remat_segment'],
                         json.dumps([round(x, 5) for x in losses])))
    print('%s launches over %d timed steps: %s (per step: %s; by dtype: %s)'
          % (label, TRAIN_STEPS, json.dumps(counts), json.dumps(want),
             json.dumps(read_launches_by_dtype())))
    print('%s step p50_ms=%r p90_ms=%r tokens_per_s=%r peak_allocated_gb=%.2f'
          ' no_remat_peak_allocated_gb=%.2f (host clock, %d steps, each '
          'ending in a sync)' % (
              label, p50 * 1e3, float(np.percentile(times, 90)) * 1e3,
              TRAIN_BATCH * BERT['max_len'] / p50, peak / 2 ** 30,
              PEAKS['bert_training'] / 2 ** 30, TRAIN_STEPS))
    check(peak < PEAKS['bert_training'], '%s: the peak %.2f GB is not below '
          'the no-remat %.2f GB' % (label, peak / 2 ** 30,
                                    PEAKS['bert_training'] / 2 ** 30))
    del scope, exe
    torch.cuda.empty_cache()
    _remat_gate(label + '_vs_no_remat', plain, main, startup,
                [loss.name, 'word_emb@GRAD',
                 _last_layer_norm_scale(plain) + '@GRAD'],
                _train_feed(1, torch.Generator(device='cuda').manual_seed(
                    SEED + 11)), SEED + 40, amp=False)
    _phase_seconds(label, t0)
    return counts


def phase_bert_bench_remat(main, plain, startup, loss, feeds):
    """bench_bert's remat arm (PTPU_BENCH_BERT_REMAT, bench.py:455-469,
    512-521): phase_bert_bench_training's configuration with
    checkpoints=True, through _bench_training (the op census: n_layer + 1
    remat segments and their grads, the 37 dropout ops inside them; p50,
    tokens/s, peak, launches: none of the port's kernels), its peak beside
    the no-remat arm's; then _remat_gate against the no-remat program on
    the bench's batch, in bf16. Returns the launches over the timed
    steps."""
    t0 = time.perf_counter()
    n_layer = BENCH_BERT['n_layer']
    inner = collections.Counter(op.type for b in main.blocks[1:]
                                for op in b.ops)
    check(inner['dropout'] == 1 + 3 * n_layer
          and inner['matmul'] == 2 * n_layer,
          'bench remat: segments hold %s' % dict(inner))
    feed = _bench_feed(feeds, BENCH_BATCH)
    counts, _ = _bench_training(
        'bert_bench_training_remat', main, startup, loss, feed,
        {'remat_segment': n_layer + 1, 'remat_segment_grad': n_layer + 1,
         'dropout': 0, 'fused_multihead_attention': 0},
        dict.fromkeys(('flash_attn_fwd', 'flash_attn_bwd_dkv',
                       'flash_attn_bwd_dq'), 0),
        TRAIN_WARMUP_STEPS, TRAIN_STEPS, BENCH_BATCH * BENCH_BERT['max_len'],
        'batch=%d S=%d k=%d bf16 dropout=0.1 lr=1e-4 checkpoints=True' % (
            BENCH_BATCH, BENCH_BERT['max_len'], BENCH_K))
    print('bert_bench_training_remat peak_allocated_gb=%.2f '
          'no_remat_peak_allocated_gb=%.2f' % (
              PEAKS['bert_bench_training_remat'] / 2 ** 30,
              PEAKS['bert_bench_training'] / 2 ** 30))
    _remat_gate('bert_bench_training_remat_vs_no_remat', plain, main,
                startup, [loss.name, 'word_emb@GRAD',
                          _last_layer_norm_scale(plain) + '@GRAD'],
                feed, SEED + 41, amp=True)
    _phase_seconds('bert_bench_training_remat', t0)
    return counts


def phase_googlenet_artifact(dirname, pred):
    """bench.py's googlenet_infer row through an artifact: the GoogLeNet
    directory exported by export_compiled at batch GOOGLENET_SERVE_BATCH,
    its program after the inference pipeline (horizontal_fuse merges each
    inception's sibling 1x1 convolutions into one wider convolution and a
    split), served by CompiledPredictor: GOOGLENET_LATENCY_REQUESTS
    requests each ending in a sync (p50) beside the unoptimized
    Predictor's (both fed the same host array), the logits against the
    Predictor's within 1e-3 of the largest logit, no kernel of the port
    launched. A RuntimeWarning (the
    pipeline's fallback to the raw program) fails the phase."""
    t0 = time.perf_counter()
    adir = os.path.join(dirname, 'artifact')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 34)
    xs = torch.randn(GOOGLENET_SERVE_BATCH, 3, 224, 224, device='cuda',
                     generator=gen).cpu().numpy()
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        export_compiled(pred, [xs], adir)
    reports = _artifact_passes(adir)
    names = [r['pass'] for r in reports]
    check(names == passes.pipeline_names(passes.INFERENCE_PIPELINE),
          'googlenet export pipeline ran %s' % names)
    hf = reports[names.index('horizontal_fuse')]['details']
    fa_ = reports[names.index('fuse_activation')]['details']
    with open(os.path.join(adir, '__model__')) as f:
        ops = collections.Counter(op['type'] for op in
                                  json.load(f)['blocks'][0]['ops'])
    before = collections.Counter(op.type for op in
                                 pred._program.global_block().ops)
    check(hf['groups_fused'] > 0 and ops['split'] == hf['groups_fused'],
          'googlenet horizontal_fuse: %s, artifact ops %s' % (hf, ops))
    art = CompiledPredictor(adir)

    def latency(run):
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(GOOGLENET_LATENCY_REQUESTS):
            t1 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        return float(np.percentile(times, 50)) * 1e3
    reset_launches()
    art_ms = latency(lambda: art.run([xs]))
    counts = read_launches()
    plain_ms = latency(lambda: pred.run([xs]))
    got, = art.run([xs])
    want, = pred.run([xs])
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    print('googlenet_artifact batch=%d f32 ops %d -> %d (conv2d %d -> %d, '
          'split %d, fused activations %d) horizontal_fuse groups_fused=%d '
          'convs_fused=%d skip_reasons=%s' % (
              GOOGLENET_SERVE_BATCH, sum(before.values()), sum(ops.values()),
              before['conv2d'], ops['conv2d'], ops['split'], fa_['fused'],
              hf['groups_fused'], hf['convs_fused'],
              json.dumps(hf['skip_reasons'])))
    print('googlenet_artifact CompiledPredictor p50_ms=%r unoptimized '
          'Predictor p50_ms=%r (host clock, %d requests each, each ending in'
          ' a sync) logits max_abs_err=%r max_abs=%r rel=%r tolerance_rel=1e-3'
          ' launches=%s' % (art_ms, plain_ms, GOOGLENET_LATENCY_REQUESTS, err,
                            top, err / top, json.dumps(counts)))
    check(got.shape == want.shape and np.isfinite(got).all()
          and err <= 1e-3 * top, 'the optimized GoogLeNet artifact differs '
          'from the Predictor: %r of %r' % (err, top))
    check(not any(counts.values()), 'googlenet artifact launched %s'
          % counts)
    del art
    _phase_seconds('googlenet_artifact', t0)
    return counts


def phase_verify_hook():
    """The Executor's verify hook on the card: a program whose op reads a
    var before the op that makes it warns once (RuntimeWarning) over two
    runs, each failing in the interpreter; under PTPU_STRICT_VERIFY=1 the
    run raises ProgramVerifyError before any op runs."""
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data('x', shape=[4])
        b = main.global_block()
        for n in ('later', 'y'):
            b.create_var(name=n, shape=[-1, 4], dtype='float32')
        b.append_op(type='relu', inputs={'X': ['later']},
                    outputs={'Out': ['y']}, infer_shape=False)
        b.append_op(type='relu', inputs={'X': [x.name]},
                    outputs={'Out': ['later']}, infer_shape=False)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = {'x': torch.ones(2, 4, device='cuda')}
    prev = os.environ.pop('PTPU_STRICT_VERIFY', None)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            failed = 0
            for _ in range(2):
                try:
                    exe.run(main, feed=feed, fetch_list=['y'],
                            scope=fluid.Scope())
                except TraceError:
                    failed += 1
        warned = [str(w.message) for w in caught
                  if issubclass(w.category, RuntimeWarning)]
        os.environ['PTPU_STRICT_VERIFY'] = '1'
        try:
            exe.run(main, feed=feed, fetch_list=['y'], scope=fluid.Scope())
            raised = None
        except fluid.ProgramVerifyError as e:
            raised = str(e).splitlines()[1].strip()
    finally:
        os.environ.pop('PTPU_STRICT_VERIFY', None)
        if prev is not None:
            os.environ['PTPU_STRICT_VERIFY'] = prev
    print('verify_hook: %d warning(s) over 2 runs (%d failed in the '
          'interpreter): %s; strict: %s' % (len(warned), failed,
                                            warned[:1], raised))
    check(len(warned) == 1 and 'use-before-def' in warned[0]
          and failed == 2, 'verify hook warned %s' % warned)
    check(raised is not None and 'use-before-def' in raised,
          'PTPU_STRICT_VERIFY=1 did not raise ProgramVerifyError')



def _se_bn_shapes():
    """The (C, H, W) of SE-ResNeXt-50's 53 batch_norm inputs at 224x224,
    with counts, from its program."""
    main = build_zoo_training('se_resnext50_training_bf16')[0]
    block = main.global_block()
    shapes = collections.Counter(
        tuple(block.var(op.input('X')[0]).shape[1:])
        for op in block.ops if op.type == 'batch_norm')
    check(sum(shapes.values()) == 53, 'SE-ResNeXt-50 BN shapes %s' % shapes)
    return sorted(shapes.items(), key=lambda kv: -kv[1])


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # f32 means f32, on the CPU side of the GPU-vs-CPU gates as on the card
    # (where cuDNN would otherwise run f32 convolutions in TF32)
    torch.set_float32_matmul_precision('highest')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 GEMMs sum in f32, as the reference's contraction does
    # (core/amp.py matmul): cuBLAS may otherwise round split-K partial sums
    # to bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print('device %s | torch %s cuda %s | count=%d | TF32 off, bf16 GEMMs '
          'reduce in f32'
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()))
    print('host %s | CPU f32 matmul precision %s' % (
        host_line(), torch.get_float32_matmul_precision()))

    t0 = time.perf_counter()
    report = kernels.build()
    for name, (secs, log) in report.items():
        print('build %s %.1fs\n%s' % (name, secs, log.strip()))
    print('build all kernels %.1fs' % (time.perf_counter() - t0))

    phase_verify_hook()
    max_abs = phase_kernel_vs_plain()
    bn_bwd_abs, bn_bwd_worst = phase_kernel_bwd_vs_plain()
    k2_abs = phase_flash_vs_plain()
    bwd_abs = phase_flash_bwd_vs_plain()
    with tempfile.TemporaryDirectory() as d:
        n_bn, n_params = build_and_save(d)
        print('model resnet50 224x224 classes=1000 f32 batch_norm_ops=%d '
              'persistable_elements=%d' % (n_bn, n_params))
        pred, images, resnet_counts = phase_serving(d, n_bn)
        phase_cpu_agreement(d, pred, images)
        # bench.py's resnet50_serving: the same directory exported and
        # served by the batcher
        artifact_counts = phase_resnet_artifact_serving(d, n_bn)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        n_ops, n_fused, n_params = build_and_save_bert(d)
        print('model bert-base S=%d vocab=%d layers=%d f32 ops=%d '
              'fused_multihead_attention_ops=%d persistable_elements=%d '
              'build_init_save_s=%.1f' % (
                  BERT['max_len'], BERT['vocab'], BERT['n_layer'], n_ops,
                  n_fused, n_params, time.perf_counter() - t0))
        bert_pred, bert_feeds, bert_counts = phase_bert_serving(d, n_fused)
        phase_bert_cpu_agreement(d, bert_pred, bert_feeds)
    t0 = time.perf_counter()
    train_main, train_startup, train_loss = build_bert_training()
    print('model bert-base training S=%d vocab=%d layers=%d f32 ops=%d '
          'persistable_vars=%d build_s=%.1f' % (
              BERT['max_len'], BERT['vocab'], BERT['n_layer'],
              len(train_main.global_block().ops),
              sum(v.persistable for v in train_main.list_vars()),
              time.perf_counter() - t0))
    train_exe, train_scope, train_feed, train_counts = phase_bert_training(
        train_main, train_startup, train_loss)
    _bert_training_profile(train_exe, train_main, train_loss, train_scope,
                           train_feed, False)
    del train_scope, train_feed  # the trained parameters and Adam state
    phase_training_gpu_vs_cpu(train_main, train_startup, train_loss)
    torch.cuda.empty_cache()
    # the same program with checkpoints=True: K2 inside the remat segments
    rm_main, rm_startup, rm_loss = build_bert_training(checkpoints=True)
    remat_counts = phase_bert_remat_training(rm_main, train_main, rm_startup,
                                             rm_loss)
    del rm_main, rm_startup
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r_main, r_startup, r_loss, r_acc = build_resnet_training()
    print('model resnet50 training 224x224 classes=%d s2d_stem f32 ops=%d '
          'parameters=%d persistable_vars=%d build_s=%.1f' % (
              RESNET_TRAIN['class_dim'], len(r_main.global_block().ops),
              len(r_main.all_parameters()),
              sum(v.persistable for v in r_main.list_vars()),
              time.perf_counter() - t0))
    r_exe, r_scope, r_feed, resnet_train_counts = phase_resnet_training(
        r_main, r_startup, r_loss, r_acc)
    k1_training = phase_resnet_training_profile(r_exe, r_main, r_loss,
                                                r_acc, r_scope, r_feed)
    del r_scope, r_feed  # the trained parameters and velocities
    torch.cuda.empty_cache()
    phase_resnet_training_gpu_vs_cpu(r_main, r_startup, r_loss)
    torch.cuda.empty_cache()
    phase_resnet_backward_gpu_vs_cpu(r_main, r_startup)
    torch.cuda.empty_cache()
    # bench_resnet's f32 batch, which fits once dead values are freed
    resnet_b256_counts = phase_resnet_f32_bench_batch(r_main, r_startup,
                                                      r_loss, r_acc)

    # bf16 mixed precision: the same two programs marked by enable_bf16
    t0 = time.perf_counter()
    amp_main, amp_startup, amp_loss = build_bert_training(amp=True)
    print('model bert-base training S=%d bf16 (enable_bf16) ops=%d '
          'build_s=%.1f' % (BERT['max_len'], len(amp_main.global_block().ops),
                            time.perf_counter() - t0))
    amp_exe, amp_scope, amp_feed, bert_amp_counts = phase_bert_training(
        amp_main, amp_startup, amp_loss, amp=True)
    _bert_training_profile(amp_exe, amp_main, amp_loss, amp_scope, amp_feed,
                           True)
    del amp_scope, amp_feed
    phase_training_gpu_vs_cpu(amp_main, amp_startup, amp_loss, amp=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ra_main, ra_startup, ra_loss, ra_acc = build_resnet_training(amp=True)
    print('model resnet50 training 224x224 s2d_stem bf16 (enable_bf16) '
          'ops=%d build_s=%.1f' % (len(ra_main.global_block().ops),
                                   time.perf_counter() - t0))
    ra_exe, ra_scope, ra_feed, resnet_amp_counts = phase_resnet_training(
        ra_main, ra_startup, ra_loss, ra_acc, RESNET_AMP_BATCH, amp=True)
    k1_amp = phase_resnet_training_profile(
        ra_exe, ra_main, ra_loss, ra_acc, ra_scope, ra_feed,
        RESNET_AMP_BATCH, amp=True)
    del ra_scope, ra_feed
    torch.cuda.empty_cache()
    phase_resnet_training_gpu_vs_cpu(ra_main, ra_startup, ra_loss, amp=True)
    torch.cuda.empty_cache()
    phase_resnet_backward_gpu_vs_cpu(ra_main, ra_startup, amp=True)
    torch.cuda.empty_cache()
    phase_memory_summary(r_main, r_loss, r_acc)
    # the same bf16 program trained from an export_train_step artifact
    trainer_counts = phase_compiled_trainer()

    # bench.py's bench_bert: S=128, batch 64, dropout 0.1 (the composed
    # attention), bf16, gradient merge k=2
    phase_dropout_on_card()
    t0 = time.perf_counter()
    bb_main, bb_startup, bb_loss, bb_feeds = build_bert_bench_training()
    print('model bert-base bench training S=%d bf16 k=%d dropout=0.1 ops=%d '
          'build_s=%.1f' % (BENCH_BERT['max_len'], BENCH_K,
                            len(bb_main.global_block().ops),
                            time.perf_counter() - t0))
    bench_counts = phase_bert_bench_training(bb_main, bb_startup, bb_loss,
                                             bb_feeds)
    torch.cuda.empty_cache()
    bbr_main, bbr_startup, bbr_loss, bbr_feeds = build_bert_bench_training(
        checkpoints=True)
    bench_remat_counts = phase_bert_bench_remat(bbr_main, bb_main,
                                                bbr_startup, bbr_loss,
                                                bbr_feeds)
    del bbr_main, bbr_startup
    torch.cuda.empty_cache()
    phase_bench_gpu_vs_cpu(amp=False)
    phase_bench_gpu_vs_cpu(amp=True)
    torch.cuda.empty_cache()

    # bench.py's bench_transformer: 6+6 layers, S=256, batch 64, bf16,
    # dropout 0.1 (the composed attention) and 0 (K2, causal in the
    # decoder's self-attention)
    trans_counts, _ = phase_transformer_bench_training(0.1)
    trans0_counts, trans0_causal = phase_transformer_bench_training(0.0)
    phase_transformer_lr_under_gradient_merge()
    phase_transformer_gpu_vs_cpu(0.1, amp=False)
    phase_transformer_gpu_vs_cpu(0.1, amp=True)
    phase_transformer_gpu_vs_cpu(0.0, amp=True)
    torch.cuda.empty_cache()

    # continuous decode serving at Transformer-base widths (decode-base)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        dsig, d_step_ops, d_prefill_ops, d_params = build_decode_artifact(d)
        check(not {'fused_multihead_attention', 'batch_norm'} & set(
            d_step_ops), 'decode step ops %s' % dict(d_step_ops))
        print('model decode-base (build_decode_spec) vocab=%d d_model=%d '
              'heads=%d layers=%d d_ff=%d slots=%d cache_len=%d buckets=%s '
              'f32 cache_bytes=%d parameter_elements=%d step_ops=%d %s '
              'prefill_ops=%s build_init_export_s=%.1f' % (
                  DECODE['vocab'], DECODE['d_model'], DECODE['n_head'],
                  DECODE['n_layer'], DECODE['d_ff'], DECODE['max_slots'],
                  DECODE['max_cache_len'], list(DECODE['prompt_buckets']),
                  dsig['cache_bytes'], d_params, sum(d_step_ops.values()),
                  json.dumps(dict(d_step_ops)), json.dumps(d_prefill_ops),
                  time.perf_counter() - t0))
        decode_pred, decode_seq, decode_prompts, decode_counts = \
            phase_decode_serving(d, dsig)
        phase_decode_gpu_vs_cpu(d, decode_pred, decode_seq, decode_prompts)
        decode_pred.close()
    del decode_pred
    torch.cuda.empty_cache()

    # the image-classification zoo at bench.py's settings: SmallNet,
    # AlexNet, VGG-19, GoogLeNet and SE-ResNeXt-50 trained in bf16, the
    # GPU-vs-CPU gates, GoogLeNet served, run_steps and run_batches held
    # against run() bit for bit, and K1 at the zoo's shapes
    zoo_counts, zoo_summary = {}, {}
    for name in ZOO:
        zoo_counts[name], zoo_summary[name] = phase_zoo_training(name)
    for name in ZOO:
        phase_zoo_gpu_vs_cpu(name, amp=True)
        if name in ZOO_F32_GATES:
            phase_zoo_gpu_vs_cpu(name, amp=False)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        n_ops = build_googlenet_serving(d)
        print('model googlenet inference 224x224 classes=1000 f32 ops=%d '
              'build_init_save_s=%.1f' % (n_ops, time.perf_counter() - t0))
        gnet_pred, gnet_counts = phase_googlenet_serving(d)
        gnet_art_counts = phase_googlenet_artifact(d, gnet_pred)
        phase_run_steps_exactness(gnet_pred)
    del gnet_pred
    torch.cuda.empty_cache()
    zoo_k1, zoo_k1_abs = phase_zoo_kernel(_se_bn_shapes())

    totals = phase_kernel_times()
    totals_amp = phase_kernel_times(RESNET_AMP_BATCH, torch.bfloat16)
    k2_rows = phase_flash_times()
    bwd_rows = phase_flash_bwd_times()
    phase_profile(pred, images)
    phase_bert_profile(bert_pred, bert_feeds)

    paths = {'resnet50_serving': resnet_counts, 'bert_serving': bert_counts,
             'bert_training': train_counts,
             'resnet50_training': resnet_train_counts,
             'bert_training_bf16': bert_amp_counts,
             'resnet50_training_bf16': resnet_amp_counts,
             'bert_bench_training': bench_counts,
             'transformer_bench_training': trans_counts,
             'transformer_bench_training_dropout0': trans0_counts,
             'decode_serving': decode_counts,
             'googlenet_serving': gnet_counts,
             'resnet50_artifact_serving': artifact_counts,
             'resnet50_compiled_trainer_bf16': trainer_counts,
             'resnet50_training_f32_batch%d' % RESNET_F32_BENCH_BATCH:
                 resnet_b256_counts,
             'bert_training_remat': remat_counts,
             'bert_bench_training_remat': bench_remat_counts,
             'googlenet_artifact_serving': gnet_art_counts}
    paths.update(zoo_counts)

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    fwd_case = K2_TIME_CASES[len(BERT_BATCHES) - 1][:5]
    bwd_case = K2_BWD_TIME_CASES[0][:5]
    k2 = k2_rows[fwd_case + ('float32',)]
    k2_trans = _k2_transformer_step_ms(k2_rows, bwd_rows)
    bwd_entries = []
    for name, replaces, grads in (
            ('flash_attn_bwd_dkv',
             'jax/experimental/pallas/ops/tpu/flash_attention.py:941',
             ('dk', 'dv')),
            ('flash_attn_bwd_dq',
             'jax/experimental/pallas/ops/tpu/flash_attention.py:1287',
             ('dq',))):
        row = bwd_rows[(name,) + bwd_case + ('float32',)]
        bwd_entries.append({
            'name': name, 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/flash_attn_bwd.cu',
            'replaces': replaces,
            'launches': train_counts[name],
            'launches_by_path': by_path(name),
            'launches_by_causal_transformer_dropout0': trans0_causal[name],
            'max_abs_err': max(bwd_abs[g, torch.float32] for g in grads),
            'max_abs_err_bf16': max(bwd_abs[g, torch.bfloat16]
                                    for g in grads),
            'shape': list(bwd_case[:4]),
            'ms': row['ms'], 'plain_ms': row['plain_ms'],
            'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
            'library_ms': row['library_ms'], 'tflops': row['tflops'],
            'cuda_core_bound_ms': row['cuda_core_bound_ms'],
            'pair_vs_sdpa_bwd': row['pair_vs_sdpa_bwd'],
            'library_call': 'scaled_dot_product_attention backward '
                            '(dq, dk and dv together)',
            'transformer_dropout0_step_ms': k2_trans[name],
            'by_case': {_case_tag(key[1:]): row
                        for key, row in bwd_rows.items()
                        if key[0] == name}})
    print('total seconds %.1f' % (time.perf_counter() - t_start))
    print(json.dumps({'kernels': [{
        'name': 'bn_apply', 'route': 'cuda',
        'source': 'paddle_tpu_torch/csrc/bn_apply.cu',
        'replaces': 'paddle_tpu/ops/pallas_bn.py:40',
        'launches': resnet_counts['bn_apply'],
        'launches_by_path': by_path('bn_apply'),
        'max_abs_err': max_abs[torch.float32],
        'max_abs_err_bf16': max_abs[torch.bfloat16],
        'backward': 'plain torch (pallas_bn.py:68 is plain JAX)',
        'max_abs_err_backward': bn_bwd_abs,
        'backward_err_over_tolerance': bn_bwd_worst,
        'resnet50_training_step': dict(
            k1_training or {},
            launches=resnet_train_counts['bn_apply'] // TRAIN_STEPS),
        'resnet50_training_bf16_step': dict(
            k1_amp or {}, batch=RESNET_AMP_BATCH,
            launches=resnet_amp_counts['bn_apply'] // TRAIN_STEPS),
        'bf16_batch%d' % RESNET_AMP_BATCH: totals_amp,
        'max_abs_err_zoo_shapes': {str(dt)[6:]: err
                                   for dt, err in zoo_k1_abs.items()},
        'zoo_shapes': zoo_k1,
        'zoo_training_steps': {
            name: {k: zoo_summary[name].get(k) for k in (
                'batch', 'bn_apply_ms', 'device_busy_ms')}
            for name in ZOO if ZOO[name]['bn']},
        'ms': totals['ms'], 'plain_ms': totals['plain_ms'],
        'bound_ms': totals['bound_ms'], 'bound_by': 'bytes',
        'library_ms': totals['library_ms']}, {
        'name': 'flash_attn_fwd', 'route': 'cuda',
        'source': 'paddle_tpu_torch/csrc/flash_attn_fwd.cu',
        'replaces': 'jax/experimental/pallas/ops/tpu/flash_attention.py:589',
        'launches': bert_counts['flash_attn_fwd'],
        'launches_by_path': by_path('flash_attn_fwd'),
        'launches_by_causal_transformer_dropout0':
            trans0_causal['flash_attn_fwd'],
        'max_abs_err': k2_abs[torch.float32],
        'max_abs_err_bf16': k2_abs[torch.bfloat16],
        'max_abs_err_lse': bwd_abs['lse', torch.float32],
        'shape': list(fwd_case[:4]),
        'ms': k2['ms'], 'plain_ms': k2['plain_ms'],
        'bound_ms': k2['bound_ms'], 'bound_by': k2['bound_by'],
        'library_ms': k2['library_ms'], 'tflops': k2['tflops'],
        'vs_sdpa': k2['vs_sdpa'],
        'cuda_core_bound_ms': k2['cuda_core_bound_ms'],
        'transformer_dropout0_step_ms': k2_trans['flash_attn_fwd'],
        'by_case': {_case_tag(key): row for key, row in k2_rows.items()}}]
        + bwd_entries}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
