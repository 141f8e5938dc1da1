#!/usr/bin/env python3
"""ResNet-50 served through paddle_tpu_torch's Predictor, two checkouts of
the repository timed in turns on one NVIDIA GPU.

    python3 scripts/torch_resnet_serving_ab.py BASE_DIR CHANGE_DIR [--rounds N]

Each run imports paddle_tpu_torch from one checkout, in a fresh process of
its own (this script with --one DIR), in the order base, change, change,
base, repeated N times (default 1), so that a card or a host that drifts
during the call weighs on both alike. A run builds the checkout's bn_apply
kernel, then full-width ResNet-50 (depth 50, 224x224, 1000 classes, f32,
TF32 off) with random weights and BN statistics from a seed, saves it as an
inference model and serves it through create_predictor(Config(dir)).run.
It prints one JSON line: for batch 1, 8 and 16 the p50 and p90 of
REQUESTS requests that each end in a sync (host clock), and the img/s of
THROUGHPUT_ROUNDS rounds of THROUGHPUT_REQUESTS back-to-back batch-16
requests with one sync each (the median round). Then the script prints
the card's name and power limit and, per checkout, the median of each
number over its runs.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCHES = (1, 8, 16)
REQUESTS = 30
THROUGHPUT_REQUESTS = 30
THROUGHPUT_ROUNDS = 5


def one(root):
    """One run against the checkout at `root`; prints its JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    pkg = os.path.dirname(os.path.abspath(fluid.__file__))
    assert pkg.startswith(os.path.abspath(root)), pkg
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build(('bn_apply',))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data('data', shape=[3, 224, 224], dtype='float32')
        logits = resnet_imagenet(img, class_dim=1000, depth=50,
                                 is_train=False)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    with tempfile.TemporaryDirectory() as d:
        with fluid.scope_guard(scope):
            exe.run(startup)
            for op in main.global_block().ops:
                if op.type != 'batch_norm':
                    continue
                for slot, lo, hi in (('Scale', 0.5, 1.5), ('Bias', -0.2, 0.2),
                                     ('Mean', -0.2, 0.2),
                                     ('Variance', 0.5, 2.0)):
                    name = op.input(slot)[0]
                    t = scope.get(name)
                    scope.set(name, lo + (hi - lo) * torch.rand(
                        t.shape, device=t.device, generator=gen))
            fluid.io.save_inference_model(d, ['data'], [logits], exe, main)
        pred = fluid.inference.create_predictor(fluid.inference.Config(d))
    images = {bs: torch.randn(bs, 3, 224, 224, device='cuda', generator=gen)
              for bs in BATCHES}
    for bs in BATCHES:
        pred.warmup([images[bs]])
    torch.cuda.synchronize()
    out = {'root': root}
    for bs in BATCHES:
        times = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            pred.run([images[bs]], return_numpy=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out['b%d_p50_ms' % bs] = float(np.percentile(times, 50)) * 1e3
        out['b%d_p90_ms' % bs] = float(np.percentile(times, 90)) * 1e3
    rates = []
    for _ in range(THROUGHPUT_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(THROUGHPUT_REQUESTS):
            pred.run([images[16]], return_numpy=False)
        torch.cuda.synchronize()
        rates.append(16 * THROUGHPUT_REQUESTS / (time.perf_counter() - t0))
    out['b16_img_per_s'] = float(np.median(rates))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('base', nargs='?')
    ap.add_argument('change', nargs='?')
    ap.add_argument('--rounds', type=int, default=1)
    ap.add_argument('--one', help='run once against this checkout')
    args = ap.parse_args()
    if args.one:
        one(args.one)
        return 0
    if not (args.base and args.change):
        ap.error('give BASE_DIR and CHANGE_DIR')
    runs = {args.base: [], args.change: []}
    order = [args.base, args.change, args.change, args.base] * args.rounds
    for root in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', root], capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            sys.stderr.write(r.stdout + r.stderr)
            return r.returncode
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[root].append(json.loads(line))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    import numpy as np
    for root, rows in runs.items():
        print(json.dumps({'root': root, 'runs': len(rows), 'median': {
            k: float(np.median([r[k] for r in rows]))
            for k in rows[0] if k != 'root'}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
