"""The BERT training slice as a whole, the port held against paddle_tpu on
the CPU: models.bert.build_bert_pretrain(dropout=0.0) at 2 layers,
d_model 64, 4 heads, S=128 and a vocab of 97, built by both packages under
a fresh unique_name.guard().

The programs must have the same ops in the same order and the same
persistable names. paddle_tpu initializes its program; weights.py carries
the whole persistable state (parameters, Adam moments and beta powers, the
learning rate) into the port, and both take Adam steps on the same feeds.
Tolerances (f32 on both sides, the same arithmetic summed in other
orders):
- per-step losses: rtol 1e-5;
- gradients fetched as `<param>@GRAD`: 1e-5 of each tensor's largest
  value;
- parameters after the steps: 1e-2 of the most that Adam can move an
  element in those steps (steps · lr), i.e. the updates agree to 1%. Adam
  divides each gradient by its own running scale, so a gradient element
  that is rounding noise in both packages can take a different step; the
  largest relative gap seen here was under 5e-6 of a tensor's largest
  value.

What the tests take from paddle_tpu (its program, its state before, during
and after the steps, its losses and gradients) is computed once, by this
file run as a script in a fresh interpreter: a test file that ran earlier
in the same pytest worker can leave jax's caches or config, or paddle_tpu's
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
from models import bert as jax_bert

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import bert as ptt_bert

CFG = dict(vocab=97, max_len=128, d_model=64, d_ff=128, n_head=4, n_layer=2,
           dropout=0.0)
LR = 1e-4
STEPS = 4
GRADS = ['word_emb@GRAD', 'pos_emb@GRAD', 'fc_0.w_0@GRAD',
         'layer_norm_0.w_0@GRAD', 'fc_11.b_0@GRAD']


def _feed(seed, batch=2):
    rng = np.random.RandomState(seed)
    s, v = CFG['max_len'], CFG['vocab']
    return {'tok_ids': rng.randint(0, v, (batch, s)).astype(np.int64),
            'seg_ids': rng.randint(0, 2, (batch, s)).astype(np.int64),
            'mlm_labels': rng.randint(0, v, (batch, s)).astype(np.int64),
            'mlm_weights': (rng.rand(batch, s) < 0.15).astype(np.float32)}


def _build(pkg, builder):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        feeds, loss = builder.build_bert_pretrain(lr=LR, **CFG)
    return main, startup, feeds, loss


def _jax_state(main, scope):
    return {v.name: np.array(scope.find_var(v.name).get_tensor())
            for v in main.list_vars() if v.persistable}


def _jax_reference(root):
    """paddle_tpu's side of the tests, written under root: its program's
    ops (type, inputs, outputs) and feeds (program.json); its initial
    state, and per step the loss and GRADS after it, then its final state
    (run.npz); and the state after two steps taken by a program built anew
    from that initial state (mid.npz)."""
    main, startup, feeds, loss = _build(fluid, jax_bert)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    arrays = {}
    with fluid.scope_guard(scope):
        exe.run(startup)
        state = _jax_state(main, scope)
        for i in range(STEPS):
            out = exe.run(main, feed=_feed(i), fetch_list=[loss] + GRADS)
            for j, o in enumerate(out):
                arrays['step%d/%d' % (i, j)] = np.asarray(o)
        final = _jax_state(main, scope)
    arrays.update({'state/' + n: a for n, a in state.items()})
    arrays.update({'final/' + n: a for n, a in final.items()})
    np.savez(os.path.join(root, 'run.npz'), **arrays)
    with open(os.path.join(root, 'program.json'), 'w') as f:
        json.dump({'ops': [(op.type, op.inputs, op.outputs)
                           for op in main.global_block().ops],
                   'feeds': feeds}, f)

    main, startup, _, loss = _build(fluid, jax_bert)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        for name, arr in state.items():
            scope.var(name).get_tensor().set(arr)
        for i in range(2):
            exe.run(main, feed=_feed(i), fetch_list=[loss])
        np.savez(os.path.join(root, 'mid.npz'), **_jax_state(main, scope))


def _json_round_trip(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """paddle_tpu's program (ops and feeds), its initial state, and per
    step: the loss and GRADS after it; then its final state, and its state
    after two steps from the initial one. Computed by _jax_reference in a
    fresh interpreter (this file run as a script, with the environment the
    tests run in)."""
    root = str(tmp_path_factory.mktemp('jax_reference'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(os.path.join(root, 'program.json')) as f:
        program = json.load(f)
    with np.load(os.path.join(root, 'run.npz')) as f:
        arrays = dict(f)
    with np.load(os.path.join(root, 'mid.npz')) as f:
        mid = dict(f)
    steps = [[arrays['step%d/%d' % (i, j)] for j in range(1 + len(GRADS))]
             for i in range(STEPS)]
    part = {key: {n.split('/', 1)[1]: a for n, a in arrays.items()
                  if n.startswith(key + '/')} for key in ('state', 'final')}
    return dict(ops=program['ops'], feeds=program['feeds'],
                state=part['state'], steps=steps, final=part['final'],
                mid=mid)


def test_same_program_in_both_packages(jax_run):
    main, _, feeds, loss = _build(ptt, ptt_bert)
    jops = jax_run['ops']
    assert [op.type for op in main.global_block().ops] == \
        [t for t, _, _ in jops]
    for a, (t, ins, outs) in zip(main.global_block().ops, jops):
        # compared as JSON, the form paddle_tpu's side arrives in
        assert _json_round_trip([a.inputs, a.outputs]) == [ins, outs], t
    assert sorted(v.name for v in main.list_vars() if v.persistable) == \
        sorted(jax_run['state'])
    assert _json_round_trip(feeds) == jax_run['feeds']
    assert loss.shape == (1,)
    types = {op.type for op in main.global_block().ops}
    assert {'fused_multihead_attention_grad', 'lookup_table_grad', 'adam',
            'softmax_with_cross_entropy_grad', 'sum'} <= types
    assert sum(op.type == 'fused_multihead_attention_grad'
               for op in main.global_block().ops) == CFG['n_layer']


def _port_steps(state, first_step, n_steps):
    main, _, _, loss = _build(ptt, ptt_bert)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(state, main, scope)
    exe = ptt.Executor(ptt.CPUPlace())
    steps = [exe.run(main, feed=_feed(i), fetch_list=[loss] + GRADS,
                     scope=scope)
             for i in range(first_step, first_step + n_steps)]
    return steps, ptt.weights.state_to_numpy(main, scope)


def _params_close(got, want, n_steps):
    assert sorted(got) == sorted(want)
    atol = 1e-2 * n_steps * LR
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_training_steps_match_jax(jax_run):
    steps, final = _port_steps(jax_run['state'], 0, STEPS)
    losses = [float(s[0][0]) for s in steps]
    want = [float(s[0][0]) for s in jax_run['steps']]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[-1] < losses[0]
    # the gradients of step 1, taken from the same initial state
    for name, got, w in zip(GRADS, steps[0][1:], jax_run['steps'][0][1:]):
        assert got.shape == w.shape, name
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    _params_close(final, jax_run['final'], STEPS)
    # Adam's own state moved too: beta powers after STEPS updates
    np.testing.assert_allclose(final['word_emb_beta1_pow_acc_0'],
                               [0.9 ** (STEPS + 1)], rtol=1e-6)


def test_state_taken_mid_training_continues_in_the_port(jax_run):
    """paddle_tpu trains two steps; its whole state (moments, beta powers,
    learning rate included) goes to the port, which takes the last two."""
    mid = jax_run['mid']
    assert float(mid['fc_0.w_0_beta2_pow_acc_0'][0]) == \
        pytest.approx(0.999 ** 3)
    steps, final = _port_steps(mid, 2, STEPS - 2)
    np.testing.assert_allclose([float(s[0][0]) for s in steps],
                               [float(s[0][0]) for s in
                                jax_run['steps'][2:]], rtol=1e-5)
    _params_close(final, jax_run['final'], STEPS)


def test_unported_options_raise():
    """dropout > 0 builds, with the reference's op list: a dropout op after
    the embeddings' layer norm, on every attention's weights and on every
    residual branch (1 + 3·n_layer), and the attention on the composed
    branch (two matmuls a layer, no fused op). checkpoints=True (remat,
    once unported) builds a remat segment for the embeddings and one for
    each layer (tests/test_torch_recompute.py holds it against the
    reference)."""
    with ptt.program_guard(ptt.Program(), ptt.Program()), \
            ptt.unique_name.guard():
        ptt_bert.build_bert_pretrain(**dict(CFG, dropout=0.1))
        port_ops = [op.type for op in
                    ptt.default_main_program().global_block().ops]
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.unique_name.guard():
        jax_bert.build_bert_pretrain(**dict(CFG, dropout=0.1))
        jax_ops = [op.type for op in
                   fluid.default_main_program().global_block().ops]
    assert port_ops == jax_ops
    n_layer = CFG['n_layer']
    assert port_ops.count('dropout') == 1 + 3 * n_layer
    assert port_ops.count('matmul') == 2 * n_layer
    assert 'fused_multihead_attention' not in port_ops
    with ptt.program_guard(ptt.Program(), ptt.Program()), \
            ptt.unique_name.guard():
        ptt_bert.build_bert_pretrain(checkpoints=True, **CFG)
        ops = [op.type for op in
               ptt.default_main_program().global_block().ops]
    assert ops.count('remat_segment') == ops.count(
        'remat_segment_grad') == n_layer + 1


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
