#!/usr/bin/env python3
"""Run chip_smoke.py's bench_transformer training phase
(phase_transformer_bench_training at dropout 0.1, 5 timed steps) of one or
more checkouts in turns, in one process on one card, to tell a change to
the phase's harness from the host's drift between calls.

    python3 scripts/bench_phase_ab.py PARENT_ROOT . . PARENT_ROOT

Each argument is the root of a checkout of this repository; its
chip_smoke.py is loaded as a module of its own, in the order given, while
paddle_tpu_torch comes from the checkout that holds this script, so only
the harness differs. Each run prints the phase's own lines (step p50 and
p90, tokens/s, MFU, the 3-step profile), then its wall time; then the
card's name and power limit.
"""
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DROPOUT = 0.1
STEPS = 5


def load(root, i):
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_%d' % i, os.path.join(root, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(roots):
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('bench_phase_ab: this run needs an NVIDIA GPU', file=sys.stderr)
        return 1
    torch.set_float32_matmul_precision('highest')
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mods = [load(os.path.abspath(r), i) for i, r in enumerate(roots)]
    for root, mod in zip(roots, mods):
        t0 = time.perf_counter()
        print('=== %s' % root, flush=True)
        mod.phase_transformer_bench_training(DROPOUT, steps=STEPS)
        print('=== %s done in %.1f s' % (root, time.perf_counter() - t0),
              flush=True)
    print(mods[0].card_line())
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:] or ['.']))
