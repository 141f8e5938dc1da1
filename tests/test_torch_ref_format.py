"""The reference's formats on the port: the protobuf `__model__` with
SerializeToStream params (inference/ref_format.py, the codec in
inference/proto.py) and the single-file params format of io.save_vars
(`filename=`, `params_filename=`), held against the JAX package.

The port initializes ResNet-20 (random BN state) and saves it. The JAX
side (in a fresh interpreter, this file run as a script) loads it, saves
it again in the reference's format, per-file and combined, and in its
own format with single-file params, and serves each directory the port
wrote; the port's Predictor serves each JAX directory,
the format detected from the first byte. Logits agree within
test_torch_resnet_serving.py's tolerance, and a single params file the
port writes from the same values is the JAX package's byte for byte.
"""
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (Config, create_predictor,
                                        load_reference_inference_model,
                                        load_reference_persistables,
                                        save_reference_inference_model)
from paddle_tpu_torch.inference import proto, ref_format

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tests'))
from test_torch_resnet_serving import (_build, _close,  # noqa: E402
                                       _image, _randomize_bn)

NAME = 'resnet20_cifar'
# the JAX side's directories, and what each holds
JAX_DIRS = {'ref': None, 'ref_combined': '__params__',
            'single': '__params__'}


def _save_port(root):
    """The port's ResNet-20 (seed 3, random BN state) saved under root in
    the reference's format (port_ref) and with single-file params
    (port_single); returns its Executor's logits on _image(2, 32)."""
    from paddle_tpu_torch.models import resnet as ptt_resnet
    main, startup, logits = _build(ptt, ptt_resnet, NAME)
    main.random_seed = startup.random_seed = 3
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe.run(startup)
        _randomize_bn(main, scope, seed=5)
        want, = exe.run(main, feed={'data': _image(2, 32)},
                        fetch_list=[logits])
        ptt.io.save_inference_model(os.path.join(root, 'port_single'),
                                    ['data'], [logits], exe, main,
                                    params_filename='__params__')
    save_reference_inference_model(os.path.join(root, 'port_ref'),
                                   ['data'], [logits], exe,
                                   main_program=main, scope=scope)
    return want


def _jax_reference(root):
    """paddle_tpu's side under root: the port's ResNet-20 loaded from
    port_single and saved again as JAX_DIRS says, its Predictor's logits
    on _image(2, 32) (logits.npy), and its Predictor's logits from the
    port's directories (port_<kind>.npy)."""
    import paddle_tpu as fluid
    from paddle_tpu.inference import Config as JaxConfig
    from paddle_tpu.inference import create_predictor as jax_predictor
    from paddle_tpu.inference import \
        save_reference_inference_model as jax_save_ref
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        main, _, fetches = fluid.io.load_inference_model(
            os.path.join(root, 'port_single'), exe,
            params_filename='__params__')
        logits = fetches[0]
        jax_save_ref(os.path.join(root, 'ref'), ['data'], [logits], exe,
                     main_program=main)
        jax_save_ref(os.path.join(root, 'ref_combined'), ['data'],
                     [logits], exe, main_program=main,
                     params_filename='__params__')
        fluid.io.save_inference_model(os.path.join(root, 'single'),
                                      ['data'], [logits], exe, main,
                                      params_filename='__params__')
    got, = jax_predictor(JaxConfig(os.path.join(root, 'single'),
                                   params_file='__params__').disable_gpu()
                         ).run([_image(2, 32)])
    np.save(os.path.join(root, 'logits.npy'), np.asarray(got))
    for kind, pfile in (('ref', None), ('single', '__params__')):
        got, = jax_predictor(JaxConfig(
            os.path.join(root, 'port_' + kind),
            params_file=pfile).disable_gpu()).run([_image(2, 32)])
        np.save(os.path.join(root, 'port_%s.npy' % kind), np.asarray(got))


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    """The port's directories and logits, then the JAX side's."""
    root = str(tmp_path_factory.mktemp('ref_format'))
    want = _save_port(root)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return root, want


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


def test_codec_round_trip():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data(name='x', shape=[4], dtype='float32')
        y = ptt.layers.cast(ptt.layers.fc(x, 3, act='relu'), 'int32')
    buf = ref_format.program_to_desc_bytes(main)
    back = ref_format.program_from_desc_bytes(buf)
    ops, ops2 = main.global_block().ops, back.global_block().ops
    assert [op.type for op in ops] == [op.type for op in ops2]
    for a, b in zip(ops, ops2):
        assert a.inputs == b.inputs and a.outputs == b.outputs
        for k, v in a.attrs.items():
            if k.startswith('_'):
                continue  # internal bookkeeping attrs do not serialize
            if k in ('dtype', 'out_dtype', 'in_dtype'):
                # the reference stores a dtype attr as its VarType enum
                assert ptt.convert_dtype(b.attrs[k]) == \
                    ptt.convert_dtype(v), k
            elif isinstance(v, float):
                assert b.attrs[k] == pytest.approx(v, rel=1e-7), k
            else:
                assert b.attrs[k] == v, k
    for name, v in main.global_block().vars.items():
        v2 = back.global_block().vars[name]
        assert (v2.dtype, list(v2.shape), v2.persistable) == \
            (v.dtype, list(v.shape), v.persistable)
    assert back.global_block().vars[y.name].dtype == 'int32'

    # field-level wire primitives: negative ints and longs survive
    wr = proto.Writer()
    wr.message(4, proto.encode_attr('axes', [-1, 2]))
    wr.message(4, proto.encode_attr('big', 1 << 40))
    got = [proto.parse_attr(v)[::2] for _, _, v in
           proto.parse_fields(wr.tobytes())]
    assert got == [('axes', [-1, 2]), ('big', 1 << 40)]


def test_tensor_stream_round_trip_and_lod_refusal(tmp_path):
    for arr in (np.random.RandomState(1).randn(6, 3).astype(np.float32),
                np.arange(10, dtype=np.int64).reshape(5, 2)):
        for with_lod in (True, False):
            f = io.BytesIO()
            ref_format.write_tensor_stream(f, arr, with_lod=with_lod)
            f.seek(0)
            back, lod = ref_format.read_tensor_stream(f, has_lod=with_lod)
            np.testing.assert_array_equal(back, arr)
            assert back.dtype == arr.dtype and lod == []
    with pytest.raises(NotImplementedError, match='item 8'):
        ref_format.write_tensor_stream(io.BytesIO(), np.zeros(3),
                                       lod=[[0, 1, 3]])
    # a stored LoD (written by hand: u32 0, u64 1 level, u64 nbytes and
    # the offsets, then the tensor) reads, and refuses to load
    lod = np.array([0, 2, 3], np.uint64)
    raw = io.BytesIO()
    raw.write(struct.pack('<IQQ', 0, 1, lod.nbytes) + lod.tobytes())
    ref_format.write_tensor_stream(raw, np.ones((3, 2), np.float32),
                                   with_lod=False)
    path = tmp_path / 'w'
    path.write_bytes(raw.getvalue())
    _, got = ref_format.load_reference_var(str(path))
    np.testing.assert_array_equal(got[0], [0, 2, 3])
    main = ptt.Program()
    main.global_block().create_var(name='w', shape=[3, 2],
                                   persistable=True)
    with pytest.raises(NotImplementedError, match='item 8'):
        load_reference_persistables(str(tmp_path), main, ptt.Scope())


@pytest.mark.parametrize('kind', sorted(JAX_DIRS))
def test_port_predictor_serves_jax_saved_dirs(dirs, kind):
    root, _ = dirs
    d = os.path.join(root, kind)
    if kind.startswith('ref'):
        with open(os.path.join(d, '__model__'), 'rb') as f:
            assert f.read(1) != b'{'  # protobuf, detected automatically
    pred = create_predictor(Config(d, params_file=JAX_DIRS[kind])
                            .disable_gpu())
    assert pred.get_input_names() == ['data']
    got, = pred.run([_image(2, 32)])
    _close(got, np.load(os.path.join(root, 'logits.npy')))


@pytest.mark.parametrize('kind', ['ref', 'single'])
def test_jax_predictor_serves_port_saved_dirs(dirs, kind):
    root, want = dirs
    _close(np.load(os.path.join(root, 'port_%s.npy' % kind)), want)
    pfile = '__params__' if kind == 'single' else None
    got, = create_predictor(Config(os.path.join(root, 'port_' + kind),
                                   params_file=pfile).disable_gpu()).run(
        [_image(2, 32)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_single_params_file_is_the_jax_packages_bytes(dirs, tmp_path):
    root, _ = dirs
    jax_dir = os.path.join(root, 'single')
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        prog, feeds, fetches = ptt.io.load_inference_model(
            jax_dir, exe, params_filename='__params__')
        ptt.io.save_inference_model(str(tmp_path / 'again'), feeds, fetches,
                                    exe, prog, params_filename='__params__')
        ptt.io.save_persistables(exe, str(tmp_path / 'persist'), prog,
                                 filename='all')
        fresh = ptt.Scope()
        with ptt.scope_guard(fresh):
            ptt.io.load_persistables(exe, str(tmp_path / 'persist'), prog,
                                     filename='all')
    with open(os.path.join(jax_dir, '__params__'), 'rb') as f:
        jax_bytes = f.read()
    with open(str(tmp_path / 'again' / '__params__'), 'rb') as f:
        assert f.read() == jax_bytes
    names = [v.name for v in prog.list_vars() if v.persistable]
    assert names and all(
        np.array_equal(fresh.get(n).numpy(), scope.get(n).numpy())
        for n in names)
    # the reference's combined format too: the port re-saves the values
    # it loaded from the JAX package's combined file byte for byte
    ref_dir = os.path.join(root, 'ref_combined')
    rscope = ptt.Scope()
    prog, feeds, fetches = load_reference_inference_model(
        ref_dir, exe, params_filename='__params__', scope=rscope)
    assert feeds == ['data']
    save_reference_inference_model(str(tmp_path / 'ref_again'), feeds,
                                   fetches, exe, main_program=prog,
                                   params_filename='__params__',
                                   scope=rscope)
    for name in ('__params__', '__model__'):
        with open(os.path.join(ref_dir, name), 'rb') as f, \
                open(str(tmp_path / 'ref_again' / name), 'rb') as g:
            assert g.read() == f.read(), name


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
