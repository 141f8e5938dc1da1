"""The BERT serving slice as a whole: the masked-LM logits of the BERT
encoder through save_inference_model and Predictor, the port held against
paddle_tpu on the CPU.

paddle_tpu builds models.bert.build_bert_pretrain with dropout 0 (so its
attention is one fused_multihead_attention op per layer), initializes it,
sets its layer_norm parameters to random values, and saves the program
pruned to the `Logits` input of softmax_with_cross_entropy. The port's
Predictor loads that same directory; the port's own models.bert, given the
JAX parameters through weights.params_from_numpy, is compared too. Logits
agree at rtol 1e-5 with an absolute floor of 1e-5 of the largest logit:
f32 on both sides, the matmuls summed in different orders.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from models import bert as jax_bert

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import bert as ptt_bert

CFG = dict(vocab=97, max_len=128, d_model=64, d_ff=128, n_head=2, n_layer=2)
FEEDS = ['tok_ids', 'seg_ids']
OP_TYPES = {'range', 'reshape2', 'lookup_table', 'elementwise_add',
            'layer_norm', 'mul', 'transpose2', 'fused_multihead_attention',
            'relu'}


def _feed(batch, seed):
    rng = np.random.RandomState(seed)
    s = CFG['max_len']
    return [rng.randint(0, CFG['vocab'], (batch, s)).astype(np.int64),
            rng.randint(0, 2, (batch, s)).astype(np.int64)]


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _port_program():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        feeds, logits = ptt_bert.bert_mlm_logits(**CFG)
    assert [f[0] for f in feeds] == FEEDS
    return main, startup, logits


@pytest.fixture(scope='module')
def jax_saved(tmp_path_factory):
    """(dir, {persistable name: numpy array}) saved by paddle_tpu."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        jax_bert.build_bert_pretrain(dropout=0.0, **CFG)
    sce, = [op for op in main.global_block().ops
            if op.type == 'softmax_with_cross_entropy']
    logits = sce.input('Logits')[0]
    scope = fluid.Scope()
    rng = np.random.RandomState(0)
    d = str(tmp_path_factory.mktemp('bert'))
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        for p in main.all_parameters():
            if p.name.startswith('layer_norm_'):
                lo = 0.5 if p.name.endswith('.w_0') else -0.2
                scope.var(p.name).get_tensor().set(
                    rng.uniform(lo, lo + 1.0, p.shape).astype(np.float32))
        fluid.io.save_inference_model(d, FEEDS, [logits],
                                      fluid.Executor(fluid.CPUPlace()), main)
    params = {v.name: np.asarray(scope.find_var(v.name).get_tensor())
              for v in main.list_vars() if v.persistable}
    return d, params


def _ops(dirname):
    with open(os.path.join(dirname, '__model__')) as f:
        return json.load(f)['blocks'][0]['ops']


def test_pruned_program_ops(jax_saved):
    ops = _ops(jax_saved[0])
    assert {op['type'] for op in ops} == OP_TYPES
    fused = [op for op in ops if op['type'] == 'fused_multihead_attention']
    assert len(fused) == CFG['n_layer']
    assert all(not op['attrs']['causal'] for op in fused)
    # 22 ops per encoder layer, 17 around them
    assert len(ops) == 22 * CFG['n_layer'] + 17


def test_port_predictor_loads_jax_saved_dir(jax_saved):
    d, _ = jax_saved
    feed = _feed(2, seed=1)
    want, = jax_create_predictor(JaxConfig(d).disable_gpu()).run(feed)
    pred = ptt.inference.create_predictor(
        ptt.inference.Config(d).disable_gpu())
    assert pred.get_input_names() == FEEDS
    got, = pred.run(feed)
    assert got.shape == (2 * CFG['max_len'], CFG['vocab'])
    _close(got, want)


def test_port_built_program_with_jax_params(jax_saved):
    d, params = jax_saved
    feed = _feed(3, seed=2)
    want, = jax_create_predictor(JaxConfig(d).disable_gpu()).run(feed)
    main, _, logits = _port_program()
    names = {v.name for v in main.list_vars() if v.persistable}
    assert {'word_emb', 'sent_emb', 'pos_emb', 'fc_0.w_0',
            'layer_norm_0.w_0'} <= names <= set(params)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy({n: params[n] for n in names}, main, scope)
    got, = ptt.Executor(ptt.CPUPlace()).run(
        main, feed=dict(zip(FEEDS, feed)), fetch_list=[logits], scope=scope)
    _close(got, want)


def test_port_saves_the_program_jax_saves(jax_saved, tmp_path):
    """The port's models.bert, pruned and saved by the port, is the program
    paddle_tpu saved: the same ops, attrs and var shapes; and the JAX
    Predictor serves the port's directory."""
    d, params = jax_saved
    main, startup, logits = _port_program()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe.run(startup)
        ptt.io.save_inference_model(str(tmp_path), FEEDS, [logits], exe, main)

    def key(op):
        attrs = {k: v for k, v in op['attrs'].items() if k != '_op_uid'}
        return op['type'], op['inputs'], op['outputs'], attrs
    port_ops, jax_ops = _ops(str(tmp_path)), _ops(d)
    assert [key(op) for op in port_ops] == [key(op) for op in jax_ops]

    def var_decls(dirname):
        with open(os.path.join(dirname, '__model__')) as f:
            return {v['name']: (v['shape'], v['dtype'])
                    for v in json.load(f)['blocks'][0]['vars']}
    used = {n for op in port_ops
            for names in list(op['inputs'].values())
            + list(op['outputs'].values()) for n in names}
    pv, jv = var_decls(str(tmp_path)), var_decls(d)
    assert {n: pv[n] for n in used} == {n: jv[n] for n in used}

    feed = _feed(1, seed=3)
    want, = exe.run(main, feed=dict(zip(FEEDS, feed)), fetch_list=[logits],
                    scope=scope)
    jgot, = jax_create_predictor(JaxConfig(str(tmp_path)).disable_gpu()).run(
        feed)
    _close(np.asarray(jgot), want)
