"""The serving slice as a whole: ResNet through save_inference_model and
Predictor, the port held against paddle_tpu on the CPU.

paddle_tpu builds, initializes and saves the model; its batch_norm
statistics and affine parameters are first set to random values so that
every BN apply does real work. The port's Predictor loads that same
directory, and its logits match the JAX Predictor's at rtol 1e-4, with an
absolute floor of 1e-4 of the largest logit (the two frameworks sum the
convolutions in different orders, through ~50 layers).

What the module's tests take from paddle_tpu (the saved directories, the
parameters, the JAX Predictor's and Executor's logits) is computed once,
by this file run as a script in a fresh interpreter: a test file that ran
earlier in the same pytest worker can leave jax's caches or config, or
paddle_tpu's compile cache, in a state that breaks a later JAX run there
("Expected args to execute_sharded_on_local_devices to have 8 shards").
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from models import resnet as jax_resnet

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import resnet as ptt_resnet

MODELS = {
    # name: (depth, class_dim, image side); resnet_imagenet for depth >= 50
    'resnet20_cifar': (20, 10, 32),
    'resnet50_32px': (50, 10, 32),
}


def _build(pkg, resnet, name):
    depth, class_dim, side = MODELS[name]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data('data', shape=[3, side, side], dtype='float32')
        if depth >= 50:
            out = resnet.resnet_imagenet(img, class_dim, depth=depth,
                                         is_train=False)
        else:
            out = resnet.resnet_cifar10(img, class_dim, depth=depth,
                                        is_train=False)
    return main, startup, out


def _randomize_bn(program, scope, seed):
    """Random running stats and affine params for every batch_norm."""
    rng = np.random.RandomState(seed)
    for op in program.global_block().ops:
        if op.type != 'batch_norm':
            continue
        c = program.global_block().var(op.input('Scale')[0]).shape[0]
        for slot, (lo, hi) in (('Scale', (0.5, 1.5)), ('Bias', (-0.2, 0.2)),
                               ('Mean', (-0.2, 0.2)),
                               ('Variance', (0.5, 2.0))):
            scope.var(op.input(slot)[0]).get_tensor().set(
                rng.uniform(lo, hi, c).astype(np.float32))


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _image(batch, side, seed=0):
    return np.random.RandomState(seed).randn(batch, 3, side, side).astype(
        np.float32)


def _save_port_resnet20(dirname):
    """The port initializes ResNet-20 (seed 3, random BN state), saves it
    as an inference model in dirname, and returns its Executor's logits on
    _image(2, 32, seed=2)."""
    main, startup, logits = _build(ptt, ptt_resnet, 'resnet20_cifar')
    main.random_seed = startup.random_seed = 3
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe.run(startup)
        _randomize_bn(main, scope, seed=5)
        want, = exe.run(main, feed={'data': _image(2, 32, seed=2)},
                        fetch_list=[logits])
        ptt.io.save_inference_model(dirname, ['data'], [logits], exe, main)
    return want


def _jax_reference(root):
    """paddle_tpu's side of the module's tests, written under root/<model>:
    the saved inference directory (dir/), the persistables (params.npz),
    the JAX Predictor's logits on _image(2, side) and the JAX Executor's
    logits on _image(3, side, seed=1) from a program built anew with those
    parameters set (logits.npz); and under root/round_trip: the JAX
    Predictor's logits on _image(2, 32, seed=2) from the directory the port
    saves with _save_port_resnet20 (logits.npy), and the directory
    paddle_tpu saves for the same model (jax/)."""
    for i, name in enumerate(sorted(MODELS)):
        side = MODELS[name][2]
        d = os.path.join(root, name, 'dir')
        main, startup, logits = _build(fluid, jax_resnet, name)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            _randomize_bn(main, scope, seed=i)
            fluid.io.save_inference_model(d, ['data'], [logits], exe, main)
        params = {v.name: np.asarray(scope.find_var(v.name).get_tensor())
                  for v in main.list_vars() if v.persistable}
        predicted, = jax_create_predictor(JaxConfig(d).disable_gpu()).run(
            [_image(2, side)])
        jmain, _, jlogits = _build(fluid, jax_resnet, name)
        jscope = fluid.Scope()
        with fluid.scope_guard(jscope):
            for n, arr in params.items():
                jscope.var(n).get_tensor().set(arr)
            executed, = fluid.Executor(fluid.CPUPlace()).run(
                jmain, feed={'data': _image(3, side, seed=1)},
                fetch_list=[jlogits])
        np.savez(os.path.join(root, name, 'params.npz'), **params)
        np.savez(os.path.join(root, name, 'logits.npz'),
                 predicted=np.asarray(predicted),
                 executed=np.asarray(executed))
    rt = os.path.join(root, 'round_trip')
    _save_port_resnet20(os.path.join(rt, 'port'))
    jgot, = jax_create_predictor(
        JaxConfig(os.path.join(rt, 'port')).disable_gpu()).run(
            [_image(2, 32, seed=2)])
    np.save(os.path.join(rt, 'logits.npy'), np.asarray(jgot))
    jmain, jstartup, jlogits = _build(fluid, jax_resnet, 'resnet20_cifar')
    with fluid.scope_guard(fluid.Scope()):
        jexe = fluid.Executor(fluid.CPUPlace())
        jexe.run(jstartup)
        fluid.io.save_inference_model(os.path.join(rt, 'jax'), ['data'],
                                      [jlogits], jexe, jmain)


@pytest.fixture(scope='module')
def jax_saved(tmp_path_factory):
    """{model name: (dir, persistables, logits)} from paddle_tpu, and
    'round_trip': (the JAX Predictor's logits from the port's saved
    ResNet-20, the directory paddle_tpu saves for it), computed by
    _jax_reference in a fresh interpreter (this file run as a script, with
    the environment the tests run in)."""
    root = str(tmp_path_factory.mktemp('jax_reference'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = {}
    for name in MODELS:
        with np.load(os.path.join(root, name, 'params.npz')) as f:
            params = dict(f)
        with np.load(os.path.join(root, name, 'logits.npz')) as f:
            logits = dict(f)
        out[name] = (os.path.join(root, name, 'dir'), params, logits)
    rt = os.path.join(root, 'round_trip')
    out['round_trip'] = (np.load(os.path.join(rt, 'logits.npy')),
                         os.path.join(rt, 'jax'))
    return out


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_port_predictor_loads_jax_saved_dir(jax_saved, name):
    d, _, jax_logits = jax_saved[name]
    x = _image(2, MODELS[name][2])
    want = jax_logits['predicted']
    pred = ptt.inference.create_predictor(
        ptt.inference.Config(d).disable_gpu())
    assert pred.get_input_names() == ['data']
    got, = pred.run([x])
    _close(got, want)
    twin, = pred.clone().run({'data': x})
    np.testing.assert_array_equal(twin, got)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_params_from_numpy_into_port_built_program(jax_saved, name):
    _, params, jax_logits = jax_saved[name]
    x = _image(3, MODELS[name][2], seed=1)
    # paddle_tpu's Executor on a program built anew with these parameters
    want = jax_logits['executed']

    main, _, logits = _build(ptt, ptt_resnet, name)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(params, main, scope)
    got, = ptt.Executor(ptt.CPUPlace()).run(main, feed={'data': x},
                                            fetch_list=[logits], scope=scope)
    _close(got, want)


def test_params_from_numpy_checks_names_and_shapes(jax_saved):
    _, params, _ = jax_saved['resnet20_cifar']
    main, _, _ = _build(ptt, ptt_resnet, 'resnet20_cifar')
    extra = dict(params, stray=np.zeros(1, np.float32))
    with pytest.raises(KeyError, match='stray'):
        ptt.weights.params_from_numpy(extra, main, ptt.Scope())
    missing = dict(params)
    missing.pop('fc_0.b_0')
    with pytest.raises(KeyError, match='fc_0.b_0'):
        ptt.weights.params_from_numpy(missing, main, ptt.Scope())
    bad = dict(params, **{'fc_0.b_0': np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match='fc_0.b_0'):
        ptt.weights.params_from_numpy(bad, main, ptt.Scope())


def test_port_saved_dir_round_trip(jax_saved, tmp_path):
    """The port initializes and saves ResNet-20; its own Predictor and the
    JAX Predictor both load the directory, and the program file is the one
    paddle_tpu writes for the same model. The JAX side (its Predictor on
    the directory _save_port_resnet20 writes, and its own saved directory)
    comes from the fresh interpreter of the jax_saved fixture."""
    x = _image(2, 32, seed=2)
    want = _save_port_resnet20(str(tmp_path / 'port'))
    got, = ptt.inference.create_predictor(
        ptt.inference.Config(str(tmp_path / 'port')).disable_gpu()).run([x])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    jgot, jax_dir = jax_saved['round_trip']
    _close(np.asarray(jgot), want)

    def model(dirname):
        with open(os.path.join(dirname, '__model__')) as f:
            d = json.load(f)
        d['random_seed'] = 0
        return d
    assert model(str(tmp_path / 'port')) == model(jax_dir)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
