#!/usr/bin/env python3
"""Train chip_smoke.py's f32 ResNet-50 at bench_resnet's batch (256, the
s2d stem, Momentum(0.1, 0.9), one fixed batch) from one initial state
several times, with cuDNN's default algorithms and then with
torch.backends.cudnn.deterministic and deterministic algorithms, and
print each run's loss at every step and whether the runs of one mode
agree bit for bit: does the spread of the trajectory
(phase_resnet_f32_bench_batch's "loss falls" check) come from cuDNN's
nondeterministic sums?

    python3 scripts/resnet_f32_trajectories.py [RUNS_PER_MODE]

Each run takes the phase's 20 steps (TRAIN_WARMUP_STEPS, TRAIN_STEPS and
RESNET_F32_BENCH_MORE_STEPS). It prints the card's name and power limit
first; about a minute on an H100 after the kernels' build.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def trajectory(cs, fluid, main, startup, loss, feed, steps):
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)[0].reshape(-1)[0])
            for _ in range(steps)]


def main(runs):
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('resnet_f32_trajectories: this run needs an NVIDIA GPU',
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    import paddle_tpu_torch as fluid
    torch.set_float32_matmul_precision('highest')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    cs.kernels.build()
    main_prog, startup, loss, _ = cs.build_resnet_training()
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED + 15)
    feed = cs._resnet_feed(cs.RESNET_F32_BENCH_BATCH, gen)
    steps = (cs.TRAIN_WARMUP_STEPS + cs.TRAIN_STEPS
             + cs.RESNET_F32_BENCH_MORE_STEPS)
    for mode in ('default', 'deterministic'):
        det = mode == 'deterministic'
        torch.backends.cudnn.deterministic = det
        torch.use_deterministic_algorithms(det, warn_only=True)
        losses = []
        for i in range(runs):
            t0 = time.perf_counter()
            losses.append(trajectory(cs, fluid, main_prog, startup, loss,
                                     feed, steps))
            print('%s run %d (%.1f s): losses %s falls=%s' % (
                mode, i, time.perf_counter() - t0,
                json.dumps([round(x, 5) for x in losses[-1]]),
                losses[-1][-1] < losses[-1][0]))
        same = all(x == losses[0] for x in losses[1:])
        first = next((s for s in range(steps)
                      if len({x[s] for x in losses}) > 1), None)
        print('%s: %d runs equal bit for bit: %s; first step that differs: '
              '%s; last losses %s' % (mode, runs, same, first,
                                      [x[-1] for x in losses]))
    return 0


if __name__ == '__main__':
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
