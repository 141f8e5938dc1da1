"""Recurrent ops: `lstm` and `gru` over LoD sequences, and cudnn_lstm, the
stacked dense LSTM (ref: operators/lstm_op.cc, gru_op.cc,
cudnn_lstm_op.cc:1; the port's copy of paddle_tpu/ops/rnn_ops.py: the
pad, unpad and reverse helpers :40-80, `_lstm` :82, `_gru` :155,
`_cudnn_lstm` :211 with lod='none', and `_fused_layer_stack`, :287).

lstm and gru (lod='aware'): the LoD rows padded to [N, L, ...] from the
host offsets, one Python loop over time of the reference's step, the
carry masked where a sequence has ended, and the outputs unpadded back
to LoD rows; `is_reverse` reverses each sequence's rows before and after.
The gathers' index tensors are built on the host from the offsets and
cached on the device, and where every sequence has the length L (as
im2sequence makes them) padding and unpadding are reshapes and the mask
is skipped: nothing reads the card to learn the offsets. The carry keeps
its initial dtype and each product runs in the dtype numpy's promotion
gives its operands (under bf16 AMP a bf16 carry against f32 weights
computes in f32 and rounds the carry each step), as jnp's `@` and
`.astype(h_prev.dtype)` do (rnn_ops.py:132-137, :192). The reference's
GRU candidate is act(x_c + (r ⊙ h_prev)·W_c + b_c); cuDNN's GRU and
torch.nn.GRU compute r ⊙ (h·W_hn + b_hn), another function, so the same
loop of torch ops runs on the card as on the CPU.

cudnn_lstm:

Four gates packed {i, f, c, o}, no peepholes, separate weights for each
(layer, direction): WeightX [in, 4H], WeightH [H, 4H], Bias [4H]:

    i, f, o = sigmoid(x·Wx + h·Wh + b);  c~ = tanh(...)
    c_t = f·c_{t-1} + i·c~;  h_t = o·tanh(c_t)

Dropout falls between stacked layers only (never across time steps,
never after the last layer), scaled up by 1/(1-p) in training; its keep
masks are drawn once a run from the op's generator (draw_lstm_keep), so
the generic grad's recomputed forward draws the same ones.

Two routes, chosen by where the input lies:
- the plain version (the CPU's, and the yardstick): a loop over time of
  the reference's step, the input GEMM hoisted out of the loop, the
  carry (h, c) kept in its initial dtype as the reference keeps it under
  bf16 AMP (rnn_ops.py:246, :325), the products in the dtype numpy's
  promotion gives the operands, as jnp's `@` gives it;
- cuDNN on a CUDA input (`torch._VF.lstm`, cudnn_lstm_calls counts
  them): the weights transposed to [4H, in] and [4H, H], copied into
  one buffer in cuDNN's layout each call (_flat_params), the reference's
  bias as b_ih and a zero b_hh.
  torch's gate order i, f, g, o is the reference's. cuDNN wants one
  dtype for the input, weights and states: every operand goes in the
  dtype the reference computes in, which it must share with the carry
  (else the reference rounds the carry each step, which cuDNN cannot;
  that raises). Without dropout one call runs every layer; with dropout
  one call runs each layer and the port's mask falls between them.
  Training (an autograd-enabled call, the generic grad) passes
  train=True, which cuDNN's backward needs.

The reference's op is plain JAX (lax.scan), not a Pallas kernel: cuDNN is
the library call behind it on the card, as cuBLAS is behind `mul`.
"""
from __future__ import annotations

import torch

from ..core import registry as _registry
from ..core.lod import (LoDArray, pad_from_lod, reverse_lod_rows,
                        unpad_to_lod, unwrap)
from ..core.registry import register


def cudnn_lstm_calls():
    """The cuDNN LSTM calls made since the last reset_calls()."""
    return _CALLS[0]


def reset_calls():
    _CALLS[0] = 0


_CALLS = [0]


def draw_lstm_keep(ctx, shape, p, n):
    """The n keep masks (bool, `shape`) of the dropouts between the n + 1
    layers: u < 1 - p, u uniform in [0, 1), drawn in order from the op's
    generator on its device. All kept on the meta device (shape
    inference)."""
    if ctx.device.type == 'meta':
        return [torch.ones(shape, dtype=torch.bool, device=ctx.device)] * n
    g = ctx.rng()
    return [torch.rand(tuple(shape), generator=g, device=ctx.device)
            < 1.0 - p for _ in range(n)]


def _mm(a, b):
    """a @ b in the dtype numpy's promotion gives the pair, as jnp's `@`
    computes a bf16 operand against an f32 one."""
    if a.dtype != b.dtype:
        common = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(common), b.to(common)
    return torch.matmul(a, b)


def _dropped(cur, keep, p):
    """where(keep, cur / (1 - p), 0) in cur's dtype; the divisor a 0-d
    tensor (ATen would apply a Python-scalar divisor of a CUDA tensor as a
    reciprocal multiply)."""
    div = torch.tensor(1.0 - p, dtype=cur.dtype, device=cur.device)
    return torch.where(keep, cur / div, torch.zeros_like(cur))


def _cell(gates, c_prev):
    g_i, g_f, g_c, g_o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(g_f) * c_prev + torch.sigmoid(g_i) * torch.tanh(g_c)
    return torch.sigmoid(g_o) * torch.tanh(c), c


def _run_dir(xseq, w_x, w_h, b, h_init, c_init, reverse):
    """One (layer, direction) of the plain version: the hoisted input GEMM,
    then the step over time (back to front with `reverse`, each output at
    its own time position). Returns (outputs [S, B, H], last h, last c)."""
    xp = _mm(xseq, w_x) + b
    h, c = h_init, c_init
    outs = [None] * xp.shape[0]
    steps = range(xp.shape[0])
    for t in (reversed(steps) if reverse else steps):
        h_new, c_new = _cell(xp[t] + _mm(h, w_h), c)
        outs[t] = h_new
        h, c = h_new.to(h_init.dtype), c_new.to(c_init.dtype)
    return torch.stack(outs), h, c


def lstm_plain(x, h0, c0, wx, wh, bias, nlayers, ndir, keeps, p,
               fuse_layers=False):
    """The plain version: the reference's per-layer scans, or with
    fuse_layers (one direction, several layers) its one loop over time
    carrying every layer's (h, c). `keeps`: the nlayers - 1 keep masks,
    or None without dropout. Returns (Out, LastH, LastC)."""
    if fuse_layers and ndir == 1 and nlayers > 1:
        return _fused_layer_stack(x, h0, c0, wx, wh, bias, nlayers, keeps, p)
    cur = x
    last_h, last_c = [], []
    for layer in range(nlayers):
        outs = []
        for d in range(ndir):
            i = layer * ndir + d
            hs, h_t, c_t = _run_dir(cur, wx[i], wh[i], bias[i], h0[i], c0[i],
                                    reverse=(d == 1))
            outs.append(hs)
            last_h.append(h_t)
            last_c.append(c_t)
        cur = torch.cat(outs, dim=-1) if ndir > 1 else outs[0]
        if keeps is not None and layer < nlayers - 1:
            cur = _dropped(cur, keeps[layer], p)
    return cur, torch.stack(last_h), torch.stack(last_c)


def _fused_layer_stack(x, h0, c0, wx, wh, bias, nlayers, keeps, p):
    """fuse_layers=True (paddle_tpu/ops/rnn_ops.py:287): one loop over time
    whose carry is every layer's (h, c); layer 0 keeps the hoisted input
    GEMM, the layers above project the layer below's fresh h_t inside the
    step. The masks are those of the per-layer path, so both modes drop
    the same elements. Out is the top layer's h in its carry dtype."""
    xp0 = _mm(x, wx[0]) + bias[0]
    hs = [h0[i] for i in range(nlayers)]
    cs = [c0[i] for i in range(nlayers)]
    out = []
    for t in range(x.shape[0]):
        cur = None
        for layer in range(nlayers):
            if layer == 0:
                gates = xp0[t] + _mm(hs[0], wh[0])
            else:
                gates = (_mm(cur, wx[layer]) + bias[layer]
                         + _mm(hs[layer], wh[layer]))
            h_t, c_t = _cell(gates, cs[layer])
            hs[layer] = h_t.to(h0.dtype)
            cs[layer] = c_t.to(c0.dtype)
            cur = hs[layer]
            if keeps is not None and layer < nlayers - 1:
                cur = _dropped(cur, keeps[layer][t], p)
        out.append(hs[-1])
    return torch.stack(out), torch.stack(hs), torch.stack(cs)


def _flat_params(ws):
    """ws copied into one new contiguous buffer, returned as views of it
    in cuDNN's order. _VF.lstm refuses the transposed weights as they are
    (non-contiguous views), and weights that are views of one buffer in
    its layout are taken without the compaction copy cuDNN makes of
    scattered ones: one copy a call either way."""
    buf = torch.cat([w.reshape(-1) for w in ws])
    views = torch.split(buf, [w.numel() for w in ws])
    return [v.view(w.shape) for v, w in zip(views, ws)]


def lstm_cudnn(x, h0, c0, wx, wh, bias, nlayers, ndir, keeps, p):
    """The cuDNN route (torch._VF.lstm) for operands of one dtype (the
    reference's compute dtype, the carry's too). Without dropout, one call
    for every layer; with it (`keeps`), one call a layer and the port's
    mask in between. Returns (Out, LastH, LastC)."""
    train = torch.is_grad_enabled()

    def params(layers):
        ws = []
        for layer in layers:
            for d in range(ndir):
                i = layer * ndir + d
                ws += [wx[i].t(), wh[i].t(), bias[i],
                       torch.zeros_like(bias[i])]
        return _flat_params(ws)

    if keeps is None:
        _CALLS[0] += 1
        return torch._VF.lstm(x, (h0, c0), params(range(nlayers)), True,
                              nlayers, 0.0, train, ndir == 2, False)
    cur, last_h, last_c = x, [], []
    for layer in range(nlayers):
        s = slice(layer * ndir, (layer + 1) * ndir)
        _CALLS[0] += 1
        cur, h, c = torch._VF.lstm(cur, (h0[s], c0[s]), params([layer]),
                                   True, 1, 0.0, train, ndir == 2, False)
        last_h.append(h)
        last_c.append(c)
        if layer < nlayers - 1:
            cur = _dropped(cur, keeps[layer], p)
    return cur, torch.cat(last_h), torch.cat(last_c)


@register('cudnn_lstm')
def _cudnn_lstm(ctx, ins):
    """Input [S, B, Din] (sequence-major, dense), InitH/InitC [L·ndir, B, H]
    -> Out [S, B, H·ndir], LastH, LastC [L·ndir, B, H]. cuDNN on a CUDA
    input, the plain version elsewhere (the module docstring)."""
    x = ins['Input'][0]
    h0, c0 = ins['InitH'][0], ins['InitC'][0]
    wx, wh, bias = ins['WeightX'], ins['WeightH'], ins['Bias']
    nlayers = int(ctx.attr('num_layers', 1))
    ndir = 2 if ctx.attr('is_bidirec', False) else 1
    p = float(ctx.attr('dropout_prob', 0.0))
    keeps = None
    if p > 0.0 and not ctx.is_test and nlayers > 1:
        h = wh[0].shape[0]
        keeps = draw_lstm_keep(ctx, (x.shape[0], x.shape[1], h * ndir), p,
                               nlayers - 1)
    if x.device.type == 'cuda':
        dtype = x.dtype
        for t in list(wx) + list(wh) + list(bias) + [h0, c0]:
            dtype = torch.promote_types(dtype, t.dtype)
        if h0.dtype != dtype or c0.dtype != dtype:
            raise TypeError(
                "cudnn_lstm on the card: the carry (%s, %s) must be in the "
                "dtype the step computes in (%s), which cuDNN keeps for "
                "input, weights and states alike" % (h0.dtype, c0.dtype,
                                                      dtype))
        out, last_h, last_c = lstm_cudnn(
            x.to(dtype), h0, c0, [w.to(dtype) for w in wx],
            [w.to(dtype) for w in wh], [b.to(dtype) for b in bias],
            nlayers, ndir, keeps, p)
    else:
        out, last_h, last_c = lstm_plain(
            x, h0, c0, wx, wh, bias, nlayers, ndir, keeps, p,
            fuse_layers=bool(ctx.attr('fuse_layers', False)))
    return {'Out': [out], 'LastH': [last_h], 'LastC': [last_c]}


def _require_lod(x, op_name):
    if not (isinstance(x, LoDArray) and x.lod):
        raise TypeError(
            "%s requires a LoD (variable-length) input: feed it as a "
            "LoDTensor (fluid.create_lod_tensor) or declare it with "
            "lod_level=1; got a dense tensor" % op_name)
    return x


_ACT = {'sigmoid': torch.sigmoid, 'tanh': torch.tanh, 'relu': torch.relu,
        'identity': lambda x: x}


def _opt(ins, slot):
    v = ins.get(slot)
    return unwrap(v[0]) if v and v[0] is not None else None


def _masked(m_t, new, prev):
    """The carry after a step: `new` where the sequence goes on, `prev`
    where it has ended, in prev's dtype."""
    if m_t is not None:
        new = torch.where(m_t[:, None], new, prev)
    return new if new.dtype == prev.dtype else new.to(prev.dtype)


def _time_major(x, off, reverse, widths):
    """LoD rows -> (for each column block of `widths`, its L time steps
    [N, width] as views, one unbind a block, so that autograd gathers the
    steps' gradients once; the masks of the L steps, [N] each, or None)."""
    if reverse:
        x = reverse_lod_rows(x, off)
    xp, mask = pad_from_lod(x, off)
    xs = xp.transpose(0, 1)
    blocks = [b.unbind(0) for b in xs.split(list(widths), dim=2)]
    return blocks, None if mask is None else mask.t().unbind(0)


def _back_to_lod(steps, off, reverse):
    """Per-step [N, ...] outputs, or their stack [N, L, ...] -> LoD rows
    (reversed back with `reverse`)."""
    y = torch.stack(steps, dim=1) if isinstance(steps, list) else steps
    y = unpad_to_lod(y, off)
    return reverse_lod_rows(y, off) if reverse else y


@register('lstm', lod='aware')
def _lstm(ctx, ins):
    """Input [T, 4D] LoD rows of gate pre-activations {c, i, f, o}, Weight
    [D, 4D], Bias [1, 4D] or, with peepholes, [1, 7D] = {b_c, b_i, b_f,
    b_o, W_ic, W_fc, W_oc}."""
    x = _require_lod(ins['Input'][0], 'dynamic_lstm')
    w = unwrap(ins['Weight'][0])
    bias = unwrap(ins['Bias'][0]).reshape(-1)
    peep = ctx.attr('use_peepholes', True)
    reverse = ctx.attr('is_reverse', False)
    act_gate = _ACT[ctx.attr('gate_activation', 'sigmoid')]
    act_cell = _ACT[ctx.attr('cell_activation', 'tanh')]
    act_cand = _ACT[ctx.attr('candidate_activation', 'tanh')]
    off = x.lod[0]
    d = w.shape[0]
    (xs,), ms = _time_major(x.data, off, reverse, [4 * d])
    n = xs[0].shape[0]
    b = bias[:4 * d]
    if peep:
        w_ic, w_fc, w_oc = (bias[4 * d:5 * d], bias[5 * d:6 * d],
                            bias[6 * d:7 * d])
    h = _opt(ins, 'H0')
    c = _opt(ins, 'C0')
    zeros = torch.zeros((n, d), dtype=xs[0].dtype, device=xs[0].device)
    h = zeros if h is None else h
    c = zeros if c is None else c
    hs, cs, gs = [], [], []
    for t in range(len(xs)):
        gates = xs[t] + _mm(h, w) + b
        g_c, g_i, g_f, g_o = torch.chunk(gates, 4, dim=1)
        cand = act_cand(g_c)
        if peep:
            i = act_gate(g_i + c * w_ic)
            f = act_gate(g_f + c * w_fc)
        else:
            i, f = act_gate(g_i), act_gate(g_f)
        c_new = cand * i + c * f
        o = act_gate(g_o + c_new * w_oc) if peep else act_gate(g_o)
        h_new = o * act_cell(c_new)
        m_t = None if ms is None else ms[t]
        h, c = _masked(m_t, h_new, h), _masked(m_t, c_new, c)
        hs.append(h)
        cs.append(c)
        gs.append(torch.cat([cand, i, f, o], dim=1))
    lod = x.lod
    cell = LoDArray(_back_to_lod(cs, off, reverse), lod)
    return {'Hidden': [LoDArray(_back_to_lod(hs, off, reverse), lod)],
            'Cell': [cell],
            'BatchGate': [LoDArray(_back_to_lod(gs, off, reverse), lod)],
            'BatchCellPreAct': [cell]}


@register('gru', lod='aware')
def _gru(ctx, ins):
    """Input [T, 3D] LoD rows of pre-activations {u, r, c}, Weight [D, 3D]
    ([:, :2D] the gates', [:, 2D:] the candidate's), Bias [1, 3D]:
    u, r = act_gate(x_ur + h·W_ur + b_ur); c = act(x_c + (r ⊙ h)·W_c + b_c);
    h' = (1 - u) ⊙ h + u ⊙ c, or u ⊙ h + (1 - u) ⊙ c with origin_mode. The
    sums run in another order than the reference's (the bias first, the
    products fused into addmm, h' as a lerp): the same values to a few
    ulps, in about half the kernel launches a step."""
    x = _require_lod(ins['Input'][0], 'dynamic_gru')
    w = unwrap(ins['Weight'][0])
    d = w.shape[0]
    bias = _opt(ins, 'Bias')
    bias = (torch.zeros(3 * d, dtype=w.dtype, device=w.device)
            if bias is None else bias.reshape(-1))
    reverse = ctx.attr('is_reverse', False)
    act_gate = _ACT[ctx.attr('gate_activation', 'sigmoid')]
    act_node = _ACT[ctx.attr('activation', 'tanh')]
    origin_mode = ctx.attr('origin_mode', False)
    off = x.lod[0]
    h = _opt(ins, 'H0')
    if h is None:
        h = torch.zeros((len(off) - 1, d), dtype=x.data.dtype,
                        device=x.data.device)
    # the bias goes onto every row once, and each step's products go onto
    # the rows in one addmm, in the dtype the reference's step computes in
    xb = x.data + bias
    common = torch.promote_types(torch.promote_types(xb.dtype, w.dtype),
                                 h.dtype)
    (x_ur, x_c), ms = _time_major(xb.to(common), off, reverse, [2 * d, d])
    w_g, w_c = w.to(common).split([2 * d, d], dim=1)
    us, rs, cs, rhs, hs = [], [], [], [], []
    for t in range(len(x_ur)):
        hc = h if h.dtype == common else h.to(common)
        u, r = act_gate(torch.addmm(x_ur[t], hc, w_g)).chunk(2, dim=1)
        rh = r * hc
        c = act_node(torch.addmm(x_c[t], rh, w_c))
        # (1 - u)·h + u·c, or u·h + (1 - u)·c in origin_mode
        h_new = torch.lerp(c, hc, u) if origin_mode else \
            torch.lerp(hc, c, u)
        h = _masked(None if ms is None else ms[t], h_new, h)
        for out, v in ((us, u), (rs, r), (cs, c), (rhs, rh), (hs, h)):
            out.append(v)
    lod = x.lod
    gates = torch.cat([torch.stack(v, dim=1) for v in (us, rs, cs)], dim=2)
    hidden = LoDArray(_back_to_lod(hs, off, reverse), lod)
    return {'Hidden': [hidden],
            'BatchGate': [LoDArray(_back_to_lod(gates, off, reverse), lod)],
            'BatchResetHiddenPrev': [LoDArray(_back_to_lod(rhs, off, reverse),
                                              lod)],
            'BatchHidden': [hidden]}


# build-time shapes of the LoD ops' outputs (rnn_ops.py:396-419): the
# lowerings need LoD values, which the meta device cannot give them
def _set_out(op, block, slot, shape, dtype=None):
    for n in op.outputs.get(slot, []):
        v = block._find_var_recursive(n)
        if v is not None:
            v.shape = tuple(shape)
            if dtype is not None:
                v.dtype = dtype


def _weight_width(op, block):
    w = block._find_var_recursive(op.inputs['Weight'][0])
    return None if w is None or w.shape is None else w.shape[0]


def _lstm_infer(op, block):
    d = _weight_width(op, block)
    if d is not None:
        for slot, width in (('Hidden', d), ('Cell', d), ('BatchGate', 4 * d),
                            ('BatchCellPreAct', d)):
            _set_out(op, block, slot, (-1, width))


def _gru_infer(op, block):
    d = _weight_width(op, block)
    if d is not None:
        for slot, width in (('Hidden', d), ('BatchGate', 3 * d),
                            ('BatchResetHiddenPrev', d), ('BatchHidden', d)):
            _set_out(op, block, slot, (-1, width))


_registry.get('lstm').infer_shape = _lstm_infer
_registry.get('gru').infer_shape = _gru_infer
