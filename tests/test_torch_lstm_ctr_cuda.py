"""The stacked-LSTM and CTR rows' card routes: cudnn_lstm through cuDNN
(torch._VF.lstm) against its plain version on the card, and a sparse
DeepFM step whose untouched table rows keep their bits.

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_lstm_ctr_cuda.py

Without a card the tests skip. TF32 is off, so both LSTM routes compute
in f32; they sum their products in other orders, and the outputs and
gradients agree within 1e-4 of each tensor's largest value (the
tolerance chip_smoke.py's lstm_route_vs_plain states).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.lowering import Interpreter, OpCtx
from paddle_tpu_torch.core.selected_rows import SelectedRowsVal
from paddle_tpu_torch.models.deepfm import build_deepfm_train
from paddle_tpu_torch.ops import rnn_ops

REL = 1e-4


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: these tests run the cuDNN route on a '
                    'card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _operands(device, s=24, b=8, d=32, h=48, n=2):
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=0.3):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device).requires_grad_()
    flat = [r(s, b, d), r(n, b, h), r(n, b, h), r(d, 4 * h)]
    flat += [r(h, 4 * h) for _ in range(n - 1)]
    flat += [r(h, 4 * h) for _ in range(n)] + [r(4 * h) for _ in range(n)]
    cots = [torch.randn(s, b, h, generator=gen).to(device),
            torch.randn(n, b, h, generator=gen).to(device),
            torch.randn(n, b, h, generator=gen).to(device)]
    keep = [(torch.rand(s, b, h, generator=gen) < 0.75).to(device)]
    return flat, cots, keep, n


def _run(route, flat, cots, keeps, n):
    outs = route(flat[0], flat[1], flat[2], flat[3:3 + n],
                 flat[3 + n:3 + 2 * n], flat[3 + 2 * n:], n, 1, keeps, 0.25)
    return [o.detach() for o in outs] + list(
        torch.autograd.grad(list(outs), flat, cots))


@pytest.mark.cuda
@pytest.mark.parametrize('dropout', [False, True])
def test_cudnn_route_matches_plain(card, dropout):
    flat, cots, keep, n = _operands(card)
    keeps = keep if dropout else None
    rnn_ops.reset_calls()
    got = _run(rnn_ops.lstm_cudnn, flat, cots, keeps, n)
    assert rnn_ops.cudnn_lstm_calls() == (n if dropout else 1)
    want = _run(rnn_ops.lstm_plain, flat, cots, keeps, n)
    for j, (g, w) in enumerate(zip(got, want)):
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= REL * top, j


@pytest.mark.cuda
def test_op_takes_cudnn_on_the_card(card):
    """The cudnn_lstm op's lowering picks cuDNN for a CUDA input, and
    refuses a carry in another dtype than the step computes in."""
    flat, _, _, n = _operands(card)
    ins = {'Input': [flat[0].detach()], 'InitH': [flat[1].detach()],
           'InitC': [flat[2].detach()],
           'WeightX': [t.detach() for t in flat[3:3 + n]],
           'WeightH': [t.detach() for t in flat[3 + n:3 + 2 * n]],
           'Bias': [t.detach() for t in flat[3 + 2 * n:]]}
    main = ptt.Program()
    op = ptt.Operator(main.global_block(), 'cudnn_lstm',
                      attrs={'num_layers': n, 'dropout_prob': 0.0})
    ctx = OpCtx(Interpreter(main, card, {}), op, main.global_block())
    rnn_ops.reset_calls()
    with torch.no_grad():
        out = registry.get('cudnn_lstm').lower(ctx, ins)
    assert rnn_ops.cudnn_lstm_calls() == 1
    assert out['Out'][0].is_cuda and out['Out'][0].dtype == torch.float32
    ins['InitH'] = [ins['InitH'][0].bfloat16()]
    with pytest.raises(TypeError, match='carry'):
        registry.get('cudnn_lstm').lower(ctx, ins)


@pytest.mark.cuda
def test_sparse_deepfm_step_keeps_untouched_rows(card):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        build_deepfm_train(num_fields=4, vocab=1000, embed_dim=4,
                           dnn_dims=(16, 16))
    exe = ptt.Executor(ptt.CUDAPlace(0))
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {'field_ids': rng.randint(0, 1000, (64, 4)).astype(np.int64),
            'dense_x': rng.randn(64, 13).astype(np.float32),
            'click': (rng.rand(64, 1) < 0.5).astype(np.float32)}
    names = [n for n in scope._vars if n.startswith(('fm_v', 'fm_w1'))
             and 'pow' not in n]
    assert len(names) == 6, names
    before = {n: scope.get(n).clone() for n in names}
    g, = exe.run(main, feed=feed, fetch_list=['fm_v@GRAD'], scope=scope,
                 return_numpy=False)
    assert isinstance(g, SelectedRowsVal) and g.values.is_cuda
    touched = np.zeros(1000, bool)
    touched[feed['field_ids'].ravel()] = True
    for n in names:
        a, b = before[n].cpu().numpy(), scope.get(n).cpu().numpy()
        assert scope.get(n).is_cuda
        np.testing.assert_array_equal(a[~touched], b[~touched], err_msg=n)
        assert (a[touched] != b[touched]).reshape(
            int(touched.sum()), -1).any(1).all(), n
