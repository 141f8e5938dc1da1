#!/usr/bin/env python3
"""Time the flash-attention backward kernels (flash_attn_bwd_dkv and
flash_attn_bwd_dq of paddle_tpu_torch) of one or more checkouts on one
card, in turns, at BERT-base's training shape [8, 12, 512, 64], scale
1/8, non-causal, f32 and bf16.

    python3 scripts/k2_bwd_ab.py PARENT_ROOT . . PARENT_ROOT

Each argument is the root of a checkout of this repository. Each is timed
in a process of its own, which imports paddle_tpu_torch from that root and
builds its kernels there (<root>/paddle_tpu_torch/_build), in the order
given: two versions are compared on one card within one call, in turns
(parent, change, change, parent). Device time per launch: CUDA events
around 50 launches while a spin kernel holds the card, each launch on its
own copy of the inputs (more than twice the 50 MB L2 in all). Prints one
JSON line per run, then the card's name and power limit, then a JSON
summary: each root's best time per kernel and dtype.
"""
import json
import os
import subprocess
import sys

SHAPE = (8, 12, 512, 64)
REPS = 50
SPIN_CYCLES = 200_000_000
L2_BYTES = 50 * 2 ** 20

_WORKER = r'''
import json, math, os, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from paddle_tpu_torch import kernels
from paddle_tpu_torch.ops import flash_attention as fa
if os.path.dirname(kernels.__file__) != os.path.join(root,
                                                      'paddle_tpu_torch'):
    raise RuntimeError('imported %s, not the root given' % kernels.__file__)
b, h, s, d = SHAPE
scale = d ** -0.5
t0 = time.perf_counter()
kernels.build(('flash_attn_fwd', 'flash_attn_bwd'))
build_s = time.perf_counter() - t0
gen = torch.Generator(device='cuda').manual_seed(0)
out = {'root': root, 'build_s': build_s}
for dtype in (torch.float32, torch.bfloat16):
    def one():
        return torch.randn(b, s, h, d, device='cuda', generator=gen).to(
            dtype).permute(0, 2, 1, 3)
    copies = max(2, math.ceil(2 * L2_BYTES / (4 * b * h * s * d
                                              * dtype.itemsize)))
    sets = []
    for _ in range(copies):
        q, k, v, do = one(), one(), one(), one()
        o, lse = fa.flash_attn_fwd(q, k, v, False, scale, return_lse=True)
        sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
    for name in ('flash_attn_bwd_dkv', 'flash_attn_bwd_dq'):
        fn = getattr(fa, name)
        for t in sets[:2]:
            fn(*t, False, scale)
        torch.cuda.synchronize()
        spin0, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        t0 = time.perf_counter()
        spin0.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for i in range(REPS):
            fn(*sets[i % len(sets)], False, scale)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms >= spin0.elapsed_time(start):
            raise RuntimeError('the host enqueue outlasted the spin kernel')
        out['%s/%s' % (name, str(dtype)[6:])] = start.elapsed_time(end) / REPS
    del sets
print(json.dumps(out))
'''


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    code = ('SHAPE, REPS, SPIN_CYCLES, L2_BYTES = %r, %r, %r, %r\n'
            % (SHAPE, REPS, SPIN_CYCLES, L2_BYTES)) + _WORKER
    best = {}
    for root in roots:
        root = os.path.abspath(root)
        r = subprocess.run([sys.executable, '-c', code, root],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return r.returncode
        line = r.stdout.strip().splitlines()[-1]
        print(line)
        row = json.loads(line)
        mine = best.setdefault(root, {})
        for key, ms in row.items():
            if key.startswith('flash_attn_bwd'):
                mine[key] = min(mine.get(key, ms), ms)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    print(json.dumps({'shape': SHAPE, 'best_ms': best}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
