#!/usr/bin/env python3
"""Time the flash-attention kernels of paddle_tpu_torch (flash_attn_fwd,
flash_attn_bwd_dkv and flash_attn_bwd_dq) of one or more checkouts on one
card, in turns, scale 1/8, non-causal, f32 and bf16: the forward at
BERT-base's serving shapes [1, 12, 512, 64] and [8, 12, 512, 64], the
backward kernels at its training shape [8, 12, 512, 64].

    python3 scripts/k2_ab.py PARENT_ROOT . . PARENT_ROOT

Each argument is the root of a checkout of this repository. Each is timed
in a process of its own, which imports paddle_tpu_torch from that root and
builds its kernels there (<root>/paddle_tpu_torch/_build), in the order
given: two versions are compared on one card within one call, in turns
(parent, change, change, parent). Device time per launch: CUDA events
around 50 launches while a spin kernel holds the card, each launch on its
own copy of the inputs (more than twice the 50 MB L2 in all). Before it
is timed, each forward is held against its plain version at its shape
(fa.tolerance). Prints one JSON line per run, with each kernel's registers
and spilled bytes from the build's ptxas report where that run built it,
then the card's name and power limit, then a JSON summary: each root's
best time per kernel, shape and dtype.
"""
import json
import os
import subprocess
import sys

FWD_SHAPES = ((1, 12, 512, 64), (8, 12, 512, 64))
BWD_SHAPE = (8, 12, 512, 64)
REPS = 50
SPIN_CYCLES = 200_000_000
L2_BYTES = 50 * 2 ** 20

_WORKER = r'''
import json, math, os, re, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from paddle_tpu_torch import kernels
from paddle_tpu_torch.ops import flash_attention as fa
if os.path.dirname(kernels.__file__) != os.path.join(root,
                                                      'paddle_tpu_torch'):
    raise RuntimeError('imported %s, not the root given' % kernels.__file__)
t0 = time.perf_counter()
report = kernels.build(('flash_attn_fwd', 'flash_attn_bwd'))
build_s = time.perf_counter() - t0
gen = torch.Generator(device='cuda').manual_seed(0)
out = {'root': root, 'build_s': build_s}
# ptxas: "Compiling entry function '<mangled>'", then its spills and
# registers; the mangled name carries the kernel, the dtype and D (the
# flash-attention kernels' template arguments)
entry = re.compile(
    r"entry function '.*?\d(flash_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d+)E")
for _, log in report.values():
    name = None
    for line in log.splitlines():
        m = entry.search(line)
        if m:
            name = '%s/%s/D%s' % (m.group(1), 'float32' if m.group(2) == 'f'
                                  else 'bfloat16', m.group(3))
            out['ptxas/' + name] = {}
        elif name and 'spill stores' in line:
            out['ptxas/' + name]['spill_bytes'] = int(
                line.split('bytes spill stores')[0].split(',')[-1])
        elif name and 'registers' in line:
            out['ptxas/' + name]['registers'] = int(
                line.split('Used ')[1].split(' registers')[0])


def one(shape, dtype):
    b, h, s, d = shape
    return torch.randn(b, s, h, d, device='cuda', generator=gen).to(
        dtype).permute(0, 2, 1, 3)


def copies(shape, n_tensors, dtype):
    return max(2, math.ceil(2 * L2_BYTES / (n_tensors * math.prod(shape)
                                            * dtype.itemsize)))


def time_ms(fn, sets):
    for t in sets[:2]:
        fn(*t)
    torch.cuda.synchronize()
    spin0, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    t0 = time.perf_counter()
    spin0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(REPS):
        fn(*sets[i % len(sets)])
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if host_ms >= spin0.elapsed_time(start):
        raise RuntimeError('the host enqueue outlasted the spin kernel')
    return start.elapsed_time(end) / REPS


for dtype in (torch.float32, torch.bfloat16):
    dt = str(dtype)[6:]
    for shape in FWD_SHAPES:
        sets = [tuple(one(shape, dtype) for _ in range(3))
                for _ in range(copies(shape, 3, dtype))]
        got = fa.flash_attn_fwd(*sets[0], False, shape[3] ** -0.5)
        err = float((got.float() - fa.flash_attention_reference(
            *sets[0], False, shape[3] ** -0.5).float()).abs().max())
        if not err <= fa.tolerance(sets[0][2]):
            raise RuntimeError('flash_attn_fwd %s %s: error %r > %r' % (
                shape, dt, err, fa.tolerance(sets[0][2])))
        out['flash_attn_fwd/%s/%s' % ('x'.join(map(str, shape)), dt)] = \
            time_ms(lambda q, k, v: fa.flash_attn_fwd(q, k, v, False,
                                                      shape[3] ** -0.5), sets)
        del sets
    scale = BWD_SHAPE[3] ** -0.5
    sets = []
    for _ in range(copies(BWD_SHAPE, 4, dtype)):
        q, k, v, do = (one(BWD_SHAPE, dtype) for _ in range(4))
        o, lse = fa.flash_attn_fwd(q, k, v, False, scale, return_lse=True)
        sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
    for name in ('flash_attn_bwd_dkv', 'flash_attn_bwd_dq'):
        fn = getattr(fa, name)
        out['%s/%s/%s' % (name, 'x'.join(map(str, BWD_SHAPE)), dt)] = \
            time_ms(lambda *t: fn(*t, False, scale), sets)
    del sets
print(json.dumps(out))
'''


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    code = ('FWD_SHAPES, BWD_SHAPE, REPS, SPIN_CYCLES, L2_BYTES = '
            '%r, %r, %r, %r, %r\n' % (FWD_SHAPES, BWD_SHAPE, REPS,
                                      SPIN_CYCLES, L2_BYTES)) + _WORKER
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
            if key.startswith('flash_attn_'):
                mine[key] = min(mine.get(key, ms), ms)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    print(json.dumps({'best_ms': best}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
