"""Sequence (LoD) and recurrent layers (ref: python/paddle/fluid/layers/nn.py
lstm, dynamic_lstm, dynamic_gru, im2sequence; the port's copy of
paddle_tpu/layers/sequence.py's `im2sequence` :208, `dynamic_lstm` :243,
`dynamic_gru` :295 and the dense `lstm` :371). The other sequence layers
wait for their ops (ROADMAP.md queue 1 item 8)."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1, fuse_layers=False):
    """Stacked dense LSTM over [seq, batch, dim] (the cudnn_lstm op,
    ops/rnn_ops.py): num_layers four-gate LSTM layers, no peepholes,
    optionally bidirectional, dropout between stacked layers only.

    init_h/init_c: [num_layers*ndir, batch, hidden_size]. Returns
    (rnn_out, last_h, last_c) with rnn_out [seq, batch, hidden*ndir] and
    last_h/last_c [num_layers*ndir, batch, hidden_size]. max_len is kept
    as an attr for API parity. Weights are separate parameters for each
    (layer, direction): [in, 4H], [H, 4H] and a [4H] bias.
    fuse_layers=True runs one loop over time carrying every layer's (h, c)
    in the plain version; the same math and the same dropout masks."""
    helper = LayerHelper('cudnn_lstm', name=name)
    dtype = input.dtype
    ndir = 2 if is_bidirec else 1
    input_size = input.shape[-1]
    wx, wh, bias = [], [], []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden_size * ndir
        for _ in range(ndir):
            wx.append(helper.create_parameter(
                attr=None, shape=[in_sz, 4 * hidden_size], dtype=dtype,
                default_initializer=default_initializer))
            wh.append(helper.create_parameter(
                attr=None, shape=[hidden_size, 4 * hidden_size],
                dtype=dtype, default_initializer=default_initializer))
            bias.append(helper.create_parameter(
                attr=None, shape=[4 * hidden_size], dtype=dtype,
                is_bias=True))
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='cudnn_lstm',
        inputs={'Input': [input], 'InitH': [init_h], 'InitC': [init_c],
                'WeightX': wx, 'WeightH': wh, 'Bias': bias},
        outputs={'Out': [out], 'LastH': [last_h], 'LastC': [last_c]},
        attrs={'hidden_size': hidden_size, 'num_layers': num_layers,
               'is_bidirec': is_bidirec, 'dropout_prob': dropout_prob,
               'is_test': is_test, 'max_len': max_len,
               'seed': 0 if seed is None or seed < 0 else int(seed),
               'fuse_layers': bool(fuse_layers)})
    return out, last_h, last_c


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    """Each image's patches as one sequence: [N, C, H, W] -> LoD rows
    [N*oh*ow, C*kh*kw], one sequence of oh*ow rows an image."""
    helper = LayerHelper('im2sequence', name=name)

    def _pair(v, n):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n
    out = helper.create_variable_for_type_inference(input.dtype)
    out.lod_level = 1
    padding = _pair(padding, 4) if isinstance(padding, (list, tuple)) and \
        len(padding) == 4 else _pair(padding, 2) * 2
    helper.append_op(type='im2sequence', inputs={'X': input},
                     outputs={'Out': out},
                     attrs={'kernels': _pair(filter_size, 2),
                            'strides': _pair(stride, 2),
                            'paddings': padding})
    return out


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation='sigmoid', cell_activation='tanh',
                 candidate_activation='tanh', dtype='float32', name=None):
    """LSTM over LoD sequences (the lstm op): input [T, 4*size/4] rows of
    gate pre-activations {c, i, f, o}; returns (hidden, cell), LoD rows."""
    helper = LayerHelper('lstm', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    size = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 4 * size], dtype=dtype)
    bias_size = [1, 7 * size] if use_peepholes else [1, 4 * size]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    hidden.lod_level = input.lod_level
    cell = helper.create_variable_for_type_inference(dtype)
    cell.lod_level = input.lod_level
    batch_gate = helper.create_variable_for_type_inference(dtype, True)
    batch_cell_pre_act = helper.create_variable_for_type_inference(dtype, True)
    inputs = {'Input': input, 'Weight': weight, 'Bias': bias}
    if h_0 is not None:
        inputs['H0'] = h_0
    if c_0 is not None:
        inputs['C0'] = c_0
    helper.append_op(
        type='lstm', inputs=inputs,
        outputs={'Hidden': hidden, 'Cell': cell, 'BatchGate': batch_gate,
                 'BatchCellPreAct': batch_cell_pre_act},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation})
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation='sigmoid',
                candidate_activation='tanh', h_0=None, origin_mode=False):
    """GRU over LoD sequences (the gru op): input [T, 3*size] rows of
    pre-activations {u, r, c}; returns hidden, LoD rows [T, size]."""
    helper = LayerHelper('gru', param_attr=param_attr, bias_attr=bias_attr)
    dtype = input.dtype
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[1, 3 * size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    hidden.lod_level = input.lod_level
    batch_gate = helper.create_variable_for_type_inference(dtype, True)
    batch_reset = helper.create_variable_for_type_inference(dtype, True)
    batch_hidden = helper.create_variable_for_type_inference(dtype, True)
    inputs = {'Input': input, 'Weight': weight, 'Bias': bias}
    if h_0 is not None:
        inputs['H0'] = h_0
    helper.append_op(
        type='gru', inputs=inputs,
        outputs={'Hidden': hidden, 'BatchGate': batch_gate,
                 'BatchResetHiddenPrev': batch_reset,
                 'BatchHidden': batch_hidden},
        attrs={'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'activation': candidate_activation,
               'origin_mode': origin_mode})
    return hidden
