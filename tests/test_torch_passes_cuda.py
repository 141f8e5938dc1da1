"""Program passes, freeing and remat on a card.

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_passes_cuda.py

Without a card the tests skip. On CUDAPlace(0):
- a ResNet block fused by the inference pipeline (its residual relu
  folded into the elementwise_add) gives the unfused block's output bit
  for bit, through the same bn_apply launches;
- freeing each value after its last reader lowers
  torch.cuda.max_memory_allocated of a training step below that of the
  same step run with nothing freed;
- a remat_segment replays its dropout draws bit for bit: the first remat
  step's loss equals the no-remat step's, and its gradients (the
  segments' grads re-run each segment under autograd, drawing the masks
  again) equal the no-remat gradients within 1e-5 of each tensor's
  largest value (autograd sums a value's gradients from several readers
  in its own order); a mask drawn anew would move them by far more. The
  second step's loss agrees within rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.models import bert as ptt_bert
from paddle_tpu_torch.models import resnet as ptt_resnet
from paddle_tpu_torch.ops import bn_apply as bn_mod


def _card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: these tests run on a card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return ptt.CUDAPlace(0)


def _resnet_block():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data('img', shape=[64, 56, 56])
        y = ptt_resnet.bottleneck_block(x, 16, 1, is_train=False)
    return main.clone(for_test=True), startup, y.name


@pytest.mark.cuda
def test_fused_resnet_block_is_bit_identical():
    place = _card()
    main, startup, out = _resnet_block()
    fused, reports = ptt.passes.apply_inference_pipeline(
        main, fetch_names=[out])
    assert reports[-1].details['fused'] == 1
    scope = ptt.Scope()
    exe = ptt.Executor(place)
    exe.run(startup, scope=scope)
    x = np.random.RandomState(0).randn(8, 64, 56, 56).astype(np.float32)
    got = []
    for prog in (main, fused):
        before = bn_mod.bn_apply.launches
        got.append(exe.run(prog, feed={'img': x}, fetch_list=[out],
                           scope=scope)[0])
        assert bn_mod.bn_apply.launches - before == 3  # identity shortcut
    assert np.array_equal(got[0], got[1])


def _feed(batch, s, vocab, seed=0):
    rng = np.random.RandomState(seed)
    return {'tok_ids': rng.randint(0, vocab, (batch, s)).astype(np.int64),
            'seg_ids': rng.randint(0, 2, (batch, s)).astype(np.int64),
            'mlm_labels': rng.randint(0, vocab, (batch, s)).astype(np.int64),
            'mlm_weights': (rng.rand(batch, s) < 0.15).astype(np.float32)}


CFG = dict(vocab=1000, max_len=128, d_model=256, d_ff=1024, n_head=4,
           n_layer=4)


def _bert(checkpoints=None, dropout=0.1):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, loss = ptt_bert.build_bert_pretrain(
            dropout=dropout, checkpoints=checkpoints, **CFG)
    return main, startup, loss


@pytest.mark.cuda
def test_freeing_lowers_the_peak_of_a_training_step():
    place = _card()
    main, startup, loss = _bert()
    persist = {v.name for v in main.list_vars() if v.persistable}
    scope = ptt.Scope()
    exe = ptt.Executor(place)
    exe.run(startup, scope=scope)
    feed = _feed(16, CFG['max_len'], CFG['vocab'])
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)  # warm
    state = {n: scope.get(n).clone() for n in persist
             if scope.get(n) is not None}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    freed, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    peak_freed = torch.cuda.max_memory_allocated() - base
    env = dict(state)
    env.update({n: torch.as_tensor(v, device='cuda')
                for n, v in feed.items()})
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        interp = lowering.Interpreter(main, torch.device('cuda'), env, 1)
        interp.run_block(main.global_block())
    torch.cuda.synchronize()
    peak_all = torch.cuda.max_memory_allocated() - base
    del interp, env
    print('step peak above the state: %.1f MB freed, %.1f MB nothing freed'
          % (peak_freed / 2 ** 20, peak_all / 2 ** 20))
    assert peak_freed < 0.8 * peak_all, (peak_freed, peak_all)


@pytest.mark.cuda
def test_remat_segment_replays_dropout_bit_for_bit():
    place = _card()
    fetch = None
    out = []
    for cp in (None, True):
        main, startup, loss = _bert(cp)
        fetch = [loss.name, 'word_emb@GRAD', 'fc_0.w_0@GRAD']
        scope = ptt.Scope()
        exe = ptt.Executor(place)
        exe.run(startup, scope=scope)
        out.append([exe.run(main, feed=_feed(8, CFG['max_len'],
                                             CFG['vocab'], i),
                            fetch_list=fetch, scope=scope)
                    for i in range(2)])
    (plain, remat), (plain1, remat1) = zip(*out)
    # the first step: the same forward and the same masks, so the same
    # loss; the gradients summed over several readers in autograd's order
    assert np.array_equal(plain[0], remat[0])
    for n, a, b in zip(fetch[1:], plain[1:], remat[1:]):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-5 * np.abs(a).max(), err_msg=n)
    # the second step's loss, after one Adam update from those gradients
    # (Adam divides each by its own running scale, so a rounding-noise
    # gradient element may step differently: the loss is the gate there)
    np.testing.assert_allclose(remat1[0], plain1[0], rtol=1e-6)
