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

What the module's tests take from paddle_tpu (the saved directory, the
parameters, the JAX Predictor's logits) is computed once, by this file run
as a script in a fresh interpreter: a test file that ran earlier in the
same pytest worker can leave jax's caches or config, or paddle_tpu's
compile cache, in a state that breaks a later JAX run there ("Expected
args to execute_sharded_on_local_devices to have 8 shards").
"""
import json
import os
import subprocess
import sys

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


def _save_port_bert(dirname):
    """The port builds models.bert's logits program (seed 3), initializes
    it, saves it as an inference model in dirname, and returns its
    Executor's logits on _feed(1, seed=3)."""
    main, startup, logits = _port_program()
    main.random_seed = startup.random_seed = 3
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe.run(startup)
        ptt.io.save_inference_model(dirname, FEEDS, [logits], exe, main)
    want, = exe.run(main, feed=dict(zip(FEEDS, _feed(1, seed=3))),
                    fetch_list=[logits], scope=scope)
    return want


def _jax_reference(root):
    """paddle_tpu's side of the module's tests, written under root: the
    directory it saves (dir/), its persistables (params.npz), its
    Predictor's logits on _feed(2, seed=1) and _feed(3, seed=2) from that
    directory (logits.npz), and its Predictor's logits on _feed(1, seed=3)
    from the directory the port saves with _save_port_bert (port.npy)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        jax_bert.build_bert_pretrain(dropout=0.0, **CFG)
    sce, = [op for op in main.global_block().ops
            if op.type == 'softmax_with_cross_entropy']
    logits = sce.input('Logits')[0]
    scope = fluid.Scope()
    rng = np.random.RandomState(0)
    d = os.path.join(root, 'dir')
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
    np.savez(os.path.join(root, 'params.npz'), **params)
    served = {}
    for batch, seed in ((2, 1), (3, 2)):
        out, = jax_create_predictor(JaxConfig(d).disable_gpu()).run(
            _feed(batch, seed))
        served['batch%d' % batch] = np.asarray(out)
    np.savez(os.path.join(root, 'logits.npz'), **served)
    port_dir = os.path.join(root, 'port')
    _save_port_bert(port_dir)
    out, = jax_create_predictor(JaxConfig(port_dir).disable_gpu()).run(
        _feed(1, seed=3))
    np.save(os.path.join(root, 'port.npy'), np.asarray(out))


@pytest.fixture(scope='module')
def jax_saved(tmp_path_factory):
    """(dir, {persistable name: numpy array}, {'batch2', 'batch3': the JAX
    Predictor's logits}, the JAX Predictor's logits from the port's saved
    directory), computed by _jax_reference in a fresh interpreter (this
    file run as a script, with the environment the tests run in)."""
    root = str(tmp_path_factory.mktemp('bert'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'params.npz')) as f:
        params = dict(f)
    with np.load(os.path.join(root, 'logits.npz')) as f:
        served = dict(f)
    return (os.path.join(root, 'dir'), params, served,
            np.load(os.path.join(root, 'port.npy')))


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
    d, _, served, _ = jax_saved
    feed = _feed(2, seed=1)
    want = served['batch2']
    pred = ptt.inference.create_predictor(
        ptt.inference.Config(d).disable_gpu())
    assert pred.get_input_names() == FEEDS
    got, = pred.run(feed)
    assert got.shape == (2 * CFG['max_len'], CFG['vocab'])
    _close(got, want)


def test_port_built_program_with_jax_params(jax_saved):
    _, params, served, _ = jax_saved
    feed = _feed(3, seed=2)
    want = served['batch3']
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
    Predictor serves the port's directory (the JAX side, on the directory
    _save_port_bert writes, comes from the fresh interpreter of the
    jax_saved fixture)."""
    d, _, _, jgot = jax_saved
    want = _save_port_bert(str(tmp_path))

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

    _close(np.asarray(jgot), want)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])

