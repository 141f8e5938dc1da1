"""The CRNN slice's LoD ops on a card against the same ops on the CPU: the
GRU and LSTM loops (ops/rnn_ops.py), warpctc's CTC recursion and the
greedy decoder, ctc_align and edit_distance (ops/decode_ops.py), and
im2sequence (ops/sequence_ops.py), each on LoD inputs of unequal lengths
(the padded, masked route) and of one length (CRNN's: reshapes, no mask).

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_crnn_cuda.py

Without a card the tests skip. Tolerance: f32 with TF32 off on both sides,
the same arithmetic in other orders: within max(1e-5 of each tensor's
largest value, 4 times the one-ulp noise: the largest move of the tensor
on the CPU over NOISE_DRAWS runs from the float inputs moved by one f32
ulp at each element's magnitude), since 22 steps of a random recurrence
grow a last-bit difference; integer outputs and edit distances exactly;
a bf16 input (AMP's GRU) within 2 bf16 ulps of the largest value, the
carry's dtype exact.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.lod import LoDArray


class _Ctx(object):
    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: these tests run the ops on a card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _lod(lens):
    return [[0] + list(np.cumsum(lens))]


def _run(op, attrs, ins, outs, device, diff=(), cot_seed=0):
    """The op's lowering on `device`: its outputs and the gradients of
    sum(out * cotangent) for the `diff` inputs, as CPU tensors."""
    leaves, args = {}, {}
    for slot, (a, lens) in ins.items():
        t = torch.from_numpy(a).to(device)
        if slot in diff:
            t.requires_grad_()
            leaves[slot] = t
        args[slot] = [LoDArray(t, _lod(lens)) if lens else t]
    with torch.enable_grad():
        res = registry.get(op).lower(_Ctx(**attrs), args)
        vals = [res[s][0] for s in outs]
        data = [v.data if isinstance(v, LoDArray) else v for v in vals]
        grads = []
        if diff:
            rng = np.random.RandomState(cot_seed)
            cots = [torch.from_numpy(rng.randn(*d.shape).astype(np.float32))
                    .to(device=device, dtype=d.dtype) for d in data]
            grads = torch.autograd.grad(data, [leaves[s] for s in diff],
                                        cots)
    lods = [v.lod if isinstance(v, LoDArray) else None for v in vals]
    return ([d.detach().cpu() for d in data], lods,
            [g.cpu() for g in grads])


NOISE_DRAWS = 2


def _ulp_moved(ins, seed):
    """Every float input moved by one f32 ulp at each element's magnitude,
    up or down at random."""
    rng = np.random.RandomState(seed)
    out = {}
    for slot, (a, lens) in sorted(ins.items()):
        if a.dtype.kind == 'f':
            m, e = np.frexp(a.astype(np.float64))
            step = np.where(m == 0, 0.0, np.ldexp(1.0, e - 24))
            a = (a + rng.choice([-1.0, 1.0], a.shape) * step).astype(a.dtype)
        out[slot] = (a, lens)
    return out


def _same(card, op, attrs, ins, outs, diff=(), tol=1e-5, draws=NOISE_DRAWS):
    cpu = torch.device('cpu')
    got = _run(op, attrs, ins, outs, card, diff)
    want = _run(op, attrs, ins, outs, cpu, diff)
    moved = [_run(op, attrs, _ulp_moved(ins, 50 + d), outs, cpu, diff)
             for d in range(draws)]
    assert got[1] == want[1]
    for i, (g, w) in enumerate(zip(got[0] + got[2], want[0] + want[2])):
        assert g.dtype == w.dtype and g.shape == w.shape
        if not w.is_floating_point():
            assert torch.equal(g, w)
            continue
        noise = max([float(((m[0] + m[2])[i].float() - w.float()).abs().max())
                     for m in moved] or [0.0])
        top = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= max(tol * max(top, 1e-6), 4 * noise), (i, err, noise)


def _rnn_ins(seed, lens, gates, d, bias_width):
    rng = np.random.RandomState(seed)
    t = int(sum(lens))
    return {'Input': (rng.randn(t, gates * d).astype(np.float32), lens),
            'Weight': (rng.randn(d, gates * d).astype(np.float32) * 0.5,
                       None),
            'Bias': (rng.randn(1, bias_width).astype(np.float32) * 0.1,
                     None)}


@pytest.mark.cuda
@pytest.mark.parametrize('lens', [[5, 1, 9, 3], [22] * 4])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('origin', [False, True])
def test_gru_card_equals_cpu(card, lens, reverse, origin):
    d = 96
    _same(card, 'gru', {'is_reverse': reverse, 'origin_mode': origin},
          _rnn_ins(1, lens, 3, d, 3 * d),
          ['Hidden', 'BatchGate', 'BatchResetHiddenPrev'],
          diff=('Input', 'Weight', 'Bias'))


@pytest.mark.cuda
def test_gru_bf16_input_keeps_a_bf16_carry_on_the_card(card):
    d = 96
    ins = _rnn_ins(2, [22] * 4, 3, d, 3 * d)
    x, lens = ins['Input']
    ins['Input'] = (torch.from_numpy(x).bfloat16().float().numpy(), lens)
    outs = {}
    for dev in (card, torch.device('cpu')):
        args = {s: [LoDArray(torch.from_numpy(a).to(dev), _lod(l)) if l
                    else torch.from_numpy(a).to(dev)]
                for s, (a, l) in ins.items()}
        args['Input'][0] = args['Input'][0].with_lod_of(
            args['Input'][0].data.bfloat16())
        res = registry.get('gru').lower(_Ctx(), args)
        outs[dev.type] = {s: res[s][0].data.cpu() for s in
                          ('Hidden', 'BatchGate')}
    assert outs['cuda']['Hidden'].dtype == torch.bfloat16
    assert outs['cuda']['BatchGate'].dtype == torch.float32
    for s, w in outs['cpu'].items():
        g = outs['cuda'][s]
        assert g.dtype == w.dtype
        top = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= \
            2 * 2.0 ** -8 * top


@pytest.mark.cuda
@pytest.mark.parametrize('peep', [True, False])
def test_lstm_card_equals_cpu(card, peep):
    d = 32
    _same(card, 'lstm', {'use_peepholes': peep, 'is_reverse': peep},
          _rnn_ins(3, [4, 1, 7], 4, d, (7 if peep else 4) * d),
          ['Hidden', 'Cell', 'BatchGate'], diff=('Input', 'Weight', 'Bias'))


def _ctc_ins(seed, lg_lens, lb_lens, k, blank):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, k - 1, int(sum(lb_lens)))
    labels = np.where(labels >= blank, labels + 1, labels)
    return {'Logits': (rng.randn(sum(lg_lens), k).astype(np.float32) * 2,
                       lg_lens),
            'Label': (labels.reshape(-1, 1).astype(np.int32), lb_lens)}


@pytest.mark.cuda
@pytest.mark.parametrize('blank,norm', [(0, False), (95, True)])
def test_warpctc_card_equals_cpu(card, blank, norm):
    rng = np.random.RandomState(4)
    lb_lens = list(rng.randint(3, 12, 64))
    _same(card, 'warpctc', {'blank': blank, 'norm_by_times': norm},
          _ctc_ins(5, [22] * 64, lb_lens, 96, blank), ['Loss'],
          diff=('Logits',))
    blank = min(blank, 7)
    _same(card, 'warpctc', {'blank': blank, 'norm_by_times': norm},
          _ctc_ins(6, [9, 4, 13], [3, 1, 5], 8, blank), ['Loss'],
          diff=('Logits',))


@pytest.mark.cuda
def test_decoder_align_and_edit_distance_card_equal_cpu(card):
    rng = np.random.RandomState(7)
    x = rng.randn(64 * 22, 96).astype(np.float32)
    x[1] = x[0]
    _same(card, 'ctc_greedy_decoder', {'blank': 95},
          {'Input': (x, [22] * 64)}, ['Output'], draws=0)
    toks = rng.randint(0, 4, (30, 1)).astype(np.int64)
    _same(card, 'ctc_align', {'blank': 0}, {'Input': (toks, [7, 13, 10])},
          ['Output'], draws=0)
    hyps = rng.randint(-1, 5, (64 * 22, 1)).astype(np.int64)
    lens = list(rng.randint(3, 12, 64))
    refs = rng.randint(0, 5, (int(sum(lens)), 1)).astype(np.int64)
    for normalized, ignored in ((True, ()), (False, (2,))):
        _same(card, 'edit_distance', {'normalized': normalized,
                                      'ignored_tokens': ignored},
              {'Hyps': (hyps, [22] * 64), 'Refs': (refs, lens)},
              ['Out', 'SequenceNum'], tol=0.0, draws=0)


@pytest.mark.cuda
def test_im2sequence_card_equals_cpu(card):
    x = np.random.RandomState(8).randn(64, 96, 2, 22).astype(np.float32)
    _same(card, 'im2sequence', {'kernels': [2, 1], 'strides': [1, 1],
                                'paddings': [0, 0, 0, 0]},
          {'X': (x, None)}, ['Out'], diff=('X',), tol=0.0, draws=0)
