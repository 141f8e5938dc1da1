"""Recurrent layers (ref: python/paddle/fluid/layers/nn.py lstm; the port's
copy of what the dense path of paddle_tpu/layers/sequence.py needs: `lstm`,
:371). The LoD sequence layers come with the port's LoD tensors."""
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
