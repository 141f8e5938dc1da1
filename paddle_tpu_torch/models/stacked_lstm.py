"""Stacked-LSTM text classification (ref benchmark/README.md:100-119: IMDB,
dict 30000, sequences padded to 100, "2 lstm layer + fc", hidden 256,
batch 64; ref benchmark/fluid/models/stacked_dynamic_lstm.py:1), built on
the port's layers.

The port's copy of models/stacked_lstm.py: the same program, op for op
(layers.lstm, the cudnn_lstm op, over a sequence-major [S, B, E]
tensor; cuDNN on the card, ops/rnn_ops.py), and the same
flops_per_batch."""
import paddle_tpu_torch as fluid


def build_stacked_lstm_train(batch, vocab=30000, emb_dim=256, hidden=256,
                             num_layers=2, seq_len=100, num_classes=2,
                             lr=1e-3, fuse_layers=False):
    """Returns (ids_var, label_var, loss, flops_per_batch). Static batch:
    the recurrent init states are program constants shaped [L, B, H].

    `fuse_layers` selects layers.lstm's one loop over time for every
    layer (the same math)."""
    ids = fluid.layers.data('ids', shape=[batch, seq_len], dtype='int64',
                            append_batch_size=False)
    label = fluid.layers.data('label', shape=[batch, 1], dtype='int64',
                              append_batch_size=False)
    emb = fluid.layers.embedding(input=ids, size=[vocab, emb_dim])
    x = fluid.layers.transpose(emb, perm=[1, 0, 2])        # [S, B, E]
    zeros = fluid.layers.fill_constant(
        shape=[num_layers, batch, hidden], dtype='float32', value=0.0)
    out, _, _ = fluid.layers.lstm(x, zeros, zeros, max_len=seq_len,
                                  hidden_size=hidden, num_layers=num_layers,
                                  fuse_layers=fuse_layers)
    pooled = fluid.layers.reduce_mean(out, dim=0)          # [B, H]
    logits = fluid.layers.fc(pooled, size=num_classes)
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits=logits, label=label))
    fluid.optimizer.Adam(learning_rate=lr).minimize(loss)

    # train FLOPs/batch: 3x forward; per layer fwd = S*B * 2*4H*(in + H)
    fwd = 0
    for layer in range(num_layers):
        in_sz = emb_dim if layer == 0 else hidden
        fwd += seq_len * batch * 2 * 4 * hidden * (in_sz + hidden)
    fwd += seq_len * batch * 2 * emb_dim          # mean-pool + fc are noise
    flops_per_batch = 3 * fwd
    return ids, label, loss, flops_per_batch
