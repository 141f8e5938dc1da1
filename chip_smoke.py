#!/usr/bin/env python3
"""On-card smoke run of paddle_tpu_torch: ResNet-50 served on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from paddle_tpu_torch/csrc/, holds each
against its plain PyTorch version on the card, serves a full-width ResNet-50
(depth 50, 224x224, 1000 classes, f32, random weights from a seed) through
save_inference_model -> create_predictor(Config(dir)) -> Predictor.run, and
times the kernels and the requests with CUDA events and the host clock.
Every check that fails raises, so the exit code is 0 only when all phases
passed. Without a card it exits 1 and prints no result.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit from nvidia-smi, and the one before that the
kernels' summary as JSON.
"""
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import kernels
from paddle_tpu_torch.models.resnet import resnet_imagenet
from paddle_tpu_torch.ops import bn_apply as bn_mod

SEED = 0
BATCHES = (1, 8, 16)
LATENCY_REQUESTS = 20      # timed requests per batch size
THROUGHPUT_REQUESTS = 30   # back-to-back batch-16 requests, one sync
KERNEL_REPS = 50
SPIN_CYCLES = 100_000_000  # ~50 ms at the H100's ~2 GHz SM clock
# H100 SXM peaks (NVIDIA H100 data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

# the (C, H, W) of ResNet-50's 53 batch_norm outputs at 224x224, with counts
BN_SHAPES = [((256, 14, 14), 11), ((128, 28, 28), 7), ((1024, 14, 14), 7),
             ((64, 56, 56), 6), ((512, 28, 28), 5), ((512, 7, 7), 5),
             ((256, 56, 56), 4), ((2048, 7, 7), 4), ((64, 112, 112), 1),
             ((128, 56, 56), 1), ((256, 28, 28), 1), ((512, 14, 14), 1)]
BN_BATCH = 16


def check(cond, msg):
    if not cond:
        raise RuntimeError('check failed: ' + msg)


def card_line():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def phase_kernel_vs_plain():
    """bn_apply vs bn_apply_reference at every ResNet-50 BN shape, batch 16,
    f32 and bf16, act None and relu. Tolerance: 1 ulp (one_ulp_bound)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    max_abs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (c, h, w), _ in BN_SHAPES:
        x32 = torch.randn(BN_BATCH, c, h, w, device='cuda', generator=gen)
        k = torch.rand(c, device='cuda', generator=gen) + 0.5
        b = torch.randn(c, device='cuda', generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for act in (None, 'relu'):
                y = bn_mod.bn_apply(x, k, b, act)
                ref = bn_mod.bn_apply_reference(x, k, b, act)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs()
                bound = bn_mod.one_ulp_bound(x, k, b)
                ulps = float((err / bound.clamp_min(1e-30)).max())
                abs_err = float(err.max())
                max_abs[dtype] = max(max_abs[dtype], abs_err)
                print('kernel_check shape=%s dtype=%s act=%s max_abs_err=%r '
                      'max_err_ulps=%.3f' % ((BN_BATCH, c, h, w),
                                             str(dtype)[6:], act, abs_err,
                                             ulps))
                check(bool((err <= bound).all()),
                      'bn_apply differs from its plain version by more than '
                      '1 ulp at %s %s act=%s' % ((BN_BATCH, c, h, w), dtype,
                                                 act))
    return max_abs


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


def phase_serving(dirname, n_bn):
    """Serve requests at batch 1, 8, 16 through the Predictor; every request
    must launch the BN kernel once per batch_norm op."""
    pred = fluid.inference.create_predictor(fluid.inference.Config(dirname))
    check(pred.get_input_names() == ['data'], 'input names')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    images = {bs: torch.randn(bs, 3, 224, 224, device='cuda', generator=gen)
              for bs in BATCHES}
    for bs in BATCHES:   # warm-up: cuDNN picks its algorithms
        pred.warmup([images[bs]])
    torch.cuda.synchronize()

    bn_mod.bn_apply.launches = 0
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
    launches = bn_mod.bn_apply.launches
    check(launches == n_bn * requests,
          'bn_apply launched %d times over %d requests' % (launches, requests))
    print('serving requests=%d bn_apply_launches=%d (%d per request)'
          % (requests, launches, launches // requests))
    for bs in BATCHES:
        print('serving batch=%d p50_ms=%r p90_ms=%r (host clock, %d requests,'
              ' each ending in a sync)' % (
                  bs, float(np.percentile(lat[bs], 50)) * 1e3,
                  float(np.percentile(lat[bs], 90)) * 1e3, len(lat[bs])))
    print('serving batch=16 img_per_s=%r (%d back-to-back requests, one sync)'
          % (16 * THROUGHPUT_REQUESTS / dt, THROUGHPUT_REQUESTS))
    return pred, images, launches


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


def _time_ms(fn, inputs):
    """Device ms of one fn call, CUDA events around KERNEL_REPS calls,
    cycling over `inputs` so each call reads x from HBM rather than L2.
    A spin kernel holds the card while the host enqueues the calls, so the
    events time them back to back on the card, not the host's launch rate;
    the run fails if the host took longer than the spin."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    spin0, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    t0 = time.perf_counter()
    spin0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(KERNEL_REPS):
        fn(inputs[i % len(inputs)])
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    spin_ms = spin0.elapsed_time(start)
    check(host_ms < spin_ms, 'host enqueue (%.2f ms) outlasted the spin '
          '(%.2f ms): the events would time the host' % (host_ms, spin_ms))
    return start.elapsed_time(end) / KERNEL_REPS


def phase_kernel_times():
    """bn_apply, its plain version and torch.addcmul at each ResNet-50 BN
    shape (batch 16, f32, act None as the model runs it), beside the
    shape's bound: max(bytes / HBM rate, operations / f32 rate)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 4)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for (c, h, w), count in BN_SHAPES:
        numel = BN_BATCH * c * h * w
        copies = max(2, math.ceil(2 * L2_BYTES / (numel * 4)))
        xs = [torch.randn(BN_BATCH, c, h, w, device='cuda', generator=gen)
              for _ in range(copies)]
        k = torch.rand(c, device='cuda', generator=gen) + 0.5
        b = torch.randn(c, device='cuda', generator=gen)
        k4, b4 = k.view(1, c, 1, 1), b.view(1, c, 1, 1)
        before = bn_mod.bn_apply.launches
        ms = _time_ms(lambda x: bn_mod.bn_apply(x, k, b), xs)
        check(bn_mod.bn_apply.launches - before == KERNEL_REPS + 2,
              'timing loop did not launch the kernel')
        plain = _time_ms(lambda x: bn_mod.bn_apply_reference(x, k, b), xs)
        lib = _time_ms(lambda x: torch.addcmul(b4, x, k4), xs)
        nbytes = 2 * numel * 4 + 2 * c * 4
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * numel / F32_OPS_PER_S) * 1e3
        print('kernel_time shape=%s count=%d kernel_ms=%r bound_ms=%r '
              'plain_ms=%r library_ms=%r bound_share=%.3f' % (
                  (BN_BATCH, c, h, w), count, ms, bound, plain, lib,
                  bound / ms))
        for key, v in (('ms', ms), ('plain_ms', plain), ('library_ms', lib),
                       ('bound_ms', bound)):
            totals[key] += count * v
        del xs
    print('kernel_time all 53 BN applies of one batch-16 request: %s'
          % json.dumps(totals))
    return totals


def phase_profile(pred, images):
    """Device time by kernel over 3 batch-16 requests (torch.profiler; only
    the CUDA kernels' own rows, so no op is counted twice)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            pred.run([images[16]], return_numpy=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print('profile: no device time in the trace (not measured)')
        return
    busy_s = sum(r[0] for r in rows) * 1e-6
    print('profile 3 requests batch=16 (profiler on): wall_ms=%r '
          'device_busy_ms=%r idle_share=%.3f' % (
              wall * 1e3, busy_s * 1e3, max(0.0, 1 - busy_s / wall)))
    for dev_us, count, key in rows[:12]:
        print('profile kernel=%r calls=%d device_ms=%r share=%.3f' % (
            key[:90], count, dev_us * 1e-3, dev_us * 1e-6 / busy_s))


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # f32 means f32: cuDNN would otherwise run f32 convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print('device %s | torch %s cuda %s | count=%d | TF32 off'
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()))

    t0 = time.perf_counter()
    report = kernels.build()
    for name, (secs, log) in report.items():
        print('build %s %.1fs\n%s' % (name, secs, log.strip()))
    print('build all kernels %.1fs' % (time.perf_counter() - t0))

    max_abs = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory() as d:
        n_bn, n_params = build_and_save(d)
        print('model resnet50 224x224 classes=1000 f32 batch_norm_ops=%d '
              'persistable_elements=%d' % (n_bn, n_params))
        pred, images, launches = phase_serving(d, n_bn)
        phase_cpu_agreement(d, pred, images)
    totals = phase_kernel_times()
    phase_profile(pred, images)

    print('total seconds %.1f' % (time.perf_counter() - t_start))
    print(json.dumps({'kernels': [{
        'name': 'bn_apply', 'route': 'cuda',
        'source': 'paddle_tpu_torch/csrc/bn_apply.cu',
        'replaces': 'paddle_tpu/ops/pallas_bn.py:40',
        'launches': launches,
        'max_abs_err': max_abs[torch.float32],
        'max_abs_err_bf16': max_abs[torch.bfloat16],
        'ms': totals['ms'], 'plain_ms': totals['plain_ms'],
        'bound_ms': totals['bound_ms'], 'bound_by': 'bytes',
        'library_ms': totals['library_ms']}]}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
