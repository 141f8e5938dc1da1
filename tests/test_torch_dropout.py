"""The port's dropout op and its random draws on the CPU, where the two
packages' generators give different streams and so nothing is compared
with paddle_tpu (tests/test_torch_composed_attention_ops.py holds the
cases that do not depend on the draw; tests/test_torch_bert_dropout.py
injects paddle_tpu's masks into a whole BERT).

- At p=0.1 the share of kept elements lies within 5σ of its binomial
  mean; Out == X·Mask·scale exactly (scale 1/(1-p) in x's dtype, bf16
  under AMP); Mask has x's dtype.
- The op's generator is seeded by (random_seed, the Executor's step of the
  program, the microbatch index, the op's uid): two runs of one program
  draw different masks, two Executors with the same seed draw the same
  ones, and gradient merge's microbatches 0 and 1 draw different ones.
- dropout_grad reads the forward's Mask: dX == dOut·Mask·scale bit for
  bit, in f32 and in bf16.
- At step 0 outside gradient merge an op's seed is what it was before
  the step and the microbatch entered it: the startup program of a
  2-layer BERT draws, bit for bit, the state it drew then (its sha256
  digest, recorded with that code).
"""
import hashlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import bert as ptt_bert
from paddle_tpu_torch.ops import tensor_ops

P = 0.1
SHAPE = (64, 128, 32)  # 262,144 draws


def _dropout_program(p=P, impl='upscale_in_train', seed=0, amp=False,
                     shape=SHAPE):
    """x -> dropout -> reduce_sum(out·w): the loss, with append_backward,
    so the program holds the dropout_grad op; x is a data var (bf16 with
    amp) that takes a gradient."""
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = seed
    dtype = 'bfloat16' if amp else 'float32'
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data('x', shape=list(shape), dtype=dtype,
                            append_batch_size=False, stop_gradient=False)
        w = ptt.layers.data('w', shape=list(shape), dtype=dtype,
                            append_batch_size=False)
        out = ptt.layers.dropout(x, dropout_prob=p,
                                 dropout_implementation=impl)
        loss = ptt.layers.reduce_sum(out * w)
        ptt.backward.append_backward(loss)
    main._amp_bf16 = amp
    op = next(o for o in main.global_block().ops if o.type == 'dropout')
    return main, op.output('Out')[0], op.output('Mask')[0]


def _feed(shape=SHAPE, dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    return {'x': torch.randn(shape, generator=g).to(dtype),
            'w': torch.randn(shape, generator=g).to(dtype)}


def _run(exe, main, fetch, feed):
    return exe.run(main, feed=feed, fetch_list=fetch, scope=ptt.Scope(),
                   return_numpy=False)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_keep_share_scale_and_mask_dtype(dtype):
    amp = dtype == torch.bfloat16
    main, out, mask = _dropout_program(amp=amp)
    feed = _feed(dtype=dtype)
    o, m = _run(ptt.Executor(ptt.CPUPlace()), main, [out, mask], feed)
    assert o.dtype == m.dtype == dtype
    n = m.numel()
    kept = int((m != 0).sum())
    assert set(torch.unique(m.float()).tolist()) <= {0.0, 1.0}
    sigma = (n * P * (1 - P)) ** 0.5
    assert abs(kept - n * (1 - P)) <= 5 * sigma, (kept, n)
    # x·scale with scale rounded to x's dtype, products exact in f32
    x = feed['x'].float()
    scale = torch.tensor(1 / (1 - P), dtype=dtype).float()
    want = torch.where(m != 0, x * scale, torch.zeros_like(x)).to(dtype)
    assert torch.equal(o, want)


def test_masks_fresh_per_step_and_same_per_seed():
    main, out, mask = _dropout_program(shape=(32, 64), seed=5)
    feed = _feed((32, 64))
    exe = ptt.Executor(ptt.CPUPlace())
    m0, = _run(exe, main, [mask], feed)
    m1, = _run(exe, main, [mask], feed)
    assert not torch.equal(m0, m1)
    other = ptt.Executor(ptt.CPUPlace())
    assert torch.equal(_run(other, main, [mask], feed)[0], m0)
    assert torch.equal(_run(other, main, [mask], feed)[0], m1)
    # a clone is a program of its own: its steps count from 0
    assert torch.equal(_run(exe, main.clone(), [mask], feed)[0], m0)
    # another random_seed draws other masks
    main.random_seed = 6
    assert not torch.equal(_run(ptt.Executor(ptt.CPUPlace()), main, [mask],
                                feed)[0], m0)


def test_microbatches_draw_different_masks(monkeypatch):
    """Under gradient merge microbatch i draws with index i: the two
    microbatches' masks differ from each other and from the step's mask
    outside gradient merge; the next step draws others again."""
    drawn = []
    real = tensor_ops.draw_dropout_keep

    def record(ctx, shape, p):
        keep = real(ctx, shape, p)
        drawn.append((ctx.interp.step, ctx.interp.micro, keep))
        return keep

    monkeypatch.setattr(tensor_ops, 'draw_dropout_keep', record)
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = 5
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data('x', shape=[64], dtype='float32')
        h = ptt.layers.dropout(ptt.layers.fc(x, size=64), dropout_prob=P)
        loss = ptt.layers.mean(h)
        ptt.optimizer.SGD(0.1).minimize(loss)
    feed = {'x': _feed((4, 64))['x']}
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    drawn.clear()
    ptt.Executor(ptt.CPUPlace()).run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)
    (_, micro, whole), = drawn
    assert micro is None
    drawn.clear()
    ptt.contrib.gradient_merge.enable(2, main)
    exe = ptt.Executor(ptt.CPUPlace())
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert [(s, m) for s, m, _ in drawn] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    keeps = [k for _, _, k in drawn]
    assert all(k.shape == (2, 64) for k in keeps)
    for i in range(4):
        assert not torch.equal(keeps[i], whole[:2])
        for j in range(i):
            assert not torch.equal(keeps[i], keeps[j]), (i, j)


@pytest.mark.parametrize('impl', ['upscale_in_train', 'downgrade_in_infer'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_dropout_grad_is_dout_mask_scale_bit_for_bit(dtype, impl):
    """dX = dOut·Mask·scale exactly, with the Mask the forward drew (the
    grad op draws nothing): dOut is w here, the cotangent of reduce_sum's
    product, cast to Out's dtype."""
    amp = dtype == torch.bfloat16
    main, out, mask = _dropout_program(impl=impl, amp=amp)
    feed = _feed(dtype=dtype)
    drawn = []
    real = tensor_ops.draw_dropout_keep

    def record(ctx, shape, p):
        drawn.append(ctx.op.type)
        return real(ctx, shape, p)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tensor_ops, 'draw_dropout_keep', record)
        m, dx = _run(ptt.Executor(ptt.CPUPlace()), main, [mask, 'x@GRAD'],
                     feed)
    assert drawn == ['dropout']
    assert dx.dtype == dtype
    scale = 1 / (1 - P) if impl == 'upscale_in_train' else 1.0
    g = feed['w'].to(dtype).float()
    s = torch.tensor(scale, dtype=dtype).float()
    want = torch.where(m != 0, (g * s).to(dtype).float(),
                       torch.zeros_like(g)).to(dtype)
    assert torch.equal(dx, want)
    assert int((dx != 0).sum()) <= int((m != 0).sum())


def test_is_test_dropout_draws_nothing():
    main, out, mask = _dropout_program(impl='downgrade_in_infer')
    test_prog = main.clone(for_test=True)
    feed = _feed()
    o, m = _run(ptt.Executor(ptt.CPUPlace()), test_prog, [out, mask], feed)
    assert torch.equal(m, torch.ones_like(m))
    assert torch.equal(o, feed['x'] * (1 - P))


# sha256 over (name, bytes) of every persistable, sorted by name, after
# the startup program of build_bert_pretrain(vocab=97, max_len=128,
# d_model=64, d_ff=128, n_head=4, n_layer=2, dropout=0.0) ran on the CPU,
# with the programs' random_seed 0 and 7; recorded with the op seeds
# `root·0x9E3779B1 + op uid` that every draw used before the step and the
# microbatch entered them, the root the random_seed, and for 0 the fixed
# root 1234567 that a seed-0 program draws from under FLAGS_deterministic
# (the default), as the reference's does (core/config.py)
STARTUP_DIGESTS = {
    0: '3bb214a7b9a6bd94260791671d12d8704e0a5699f20950b4b78e5d3f68cadab9',
    7: '09f5f61fdf98563a9b55e0b1228d4eb81e61f7a899f431c7f243fe20ac0164a8',
}


@pytest.mark.parametrize('seed', sorted(STARTUP_DIGESTS))
def test_startup_parameters_bit_identical_to_before_the_step_seed(seed):
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = seed
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        ptt_bert.build_bert_pretrain(vocab=97, max_len=128, d_model=64,
                                     d_ff=128, n_head=4, n_layer=2,
                                     dropout=0.0)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    state = ptt.weights.state_to_numpy(main, scope)
    h = hashlib.sha256()
    for n in sorted(state):
        h.update(n.encode())
        h.update(np.ascontiguousarray(state[n]).tobytes())
    assert h.hexdigest() == STARTUP_DIGESTS[seed]
