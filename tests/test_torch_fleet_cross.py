"""The port's serving fleet held against the JAX package's, on the CPU.

tests/test_fleet.py's `dense_art` classifier (fc 32 relu, fc 4 softmax,
seed 7, one bucket of 8 rows) and `decode_art` decode spec (vocab 61,
d_model 8, 2 heads, 1 layer, d_ff 16, 4 slots, cache 40, bucket 4) are
built in both packages, the JAX initial state carried to the port with
weights.params_from_numpy. The same requests go through the JAX package's
FleetRouter and the port's, 2 replicas each:

- the dense outputs agree within DENSE_RTOL with a floor of DENSE_RTOL of
  the largest output, the tolerance at which the port's serving tests
  hold the two packages' served outputs (tests/test_torch_export_serve.py,
  tests/test_torch_resnet_serving.py);
- the greedy transcripts are equal, under the margin rule of the decode
  gates: every step of the JAX package's in-process transcript of each
  prompt has a top-two logit gap above 2·DECODE_TOL of its largest
  |logit|, DECODE_TOL (1e-5) being the logit error at which
  tests/test_torch_decode_cross.py holds the two packages' decode
  programs. A smaller gap fails the test: the comparison is never
  shortened;
- status() and fleet_snapshot() have the same keys, per replica too.

And a port replica spawned from this process, which has imported jax and
paddle_tpu, holds neither in its sys.modules.

The JAX side runs once, in a fresh interpreter (tests/_fleet_reference.py
run as a script, with PTPU_ARTIFACT_AOT=0 and export(precompile=False)),
and so do its replicas (the JAX package's file-path fleet_worker.py).
tests/test_torch_fleet.py takes its dense model's initial state from the
same script (`params` mode), so that its int8 rollout serves the
reference's model.
"""
import json
import os
import sys
import warnings

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (FleetRouter, export_compiled,
                                        export_decode)
from paddle_tpu_torch.models.transformer import build_decode_spec

from _fleet_reference import (DECODE, DECODE_TOL, DENSE_RTOL, MAX_NEW,
                              N_DENSE, _calibration, _keys, _prompts, _x,
                              port_dense_model, run_jax_side)


@pytest.fixture(scope='module', autouse=True)
def _one_thread_replicas():
    """Replicas spawned by this module run on one torch thread."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('OMP_NUM_THREADS', '1')
        mp.setenv('PTPU_PLATFORM', 'cpu')
        yield


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


@pytest.fixture(scope='module')
def sides(tmp_path_factory):
    """The JAX fleets' results, and the port's fleets' on the same
    models and requests."""
    root = str(tmp_path_factory.mktemp('fleet_cross'))
    run_jax_side(root, 'fleet')
    with open(os.path.join(root, 'fleet.json')) as f:
        jax = json.load(f)
    with np.load(os.path.join(root, 'dense_out.npz')) as z:
        jax['dense'] = [z['r%d' % i] for i in range(N_DENSE)]
    with np.load(os.path.join(root, 'dense_params.npz')) as z:
        dense_params = dict(z)
    with np.load(os.path.join(root, 'decode_params.npz')) as z:
        decode_params = dict(z)

    pred = port_dense_model(dense_params, os.path.join(root, 'port_model'))
    dense = os.path.join(root, 'port_dense')
    export_compiled(pred, _calibration()[0], dense, batch_sizes=[8])
    with ptt.unique_name.guard():
        spec = build_decode_spec(**DECODE)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(decode_params, spec['startup'], scope)
    decode = os.path.join(root, 'port_decode')
    export_decode(spec, decode, scope=scope)

    port = {}
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with FleetRouter(dense, replicas=2, platform='cpu') as router:
            port['dense'] = [f.result(300)[0] for f in [
                router.submit({'img': _x(i)}) for i in range(N_DENSE)]]
            port['dense_keys'] = _keys(router.status(),
                                       router.fleet_snapshot())
            port['hello'] = [dict(r.hello) for r in
                             router._replicas.values()]
        with FleetRouter(decode, replicas=2, platform='cpu') as router:
            futs = [router.submit(p, max_new_tokens=MAX_NEW)
                    for p in _prompts()]
            port['fleet'] = [f.result(300) for f in futs]
            port['decode_keys'] = _keys(router.status(),
                                        router.fleet_snapshot())
    return jax, port


def test_dense_fleet_outputs_match_reference(sides):
    jax, port = sides
    assert len(port['dense']) == len(jax['dense']) == N_DENSE
    for got, want in zip(port['dense'], jax['dense']):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=DENSE_RTOL,
                                   atol=DENSE_RTOL * np.abs(want).max())


def test_decode_fleet_transcripts_under_margin_rule(sides):
    jax, port = sides
    for i, rec in enumerate(jax['inproc']):
        small = [(t, m) for t, (m, s) in enumerate(zip(rec['margins'],
                                                        rec['scales']))
                 if m <= 2 * DECODE_TOL * s]
        assert not small, ('prompt %d: reference top-two gaps at or below '
                           '2*DECODE_TOL at (step, gap) %s' % (i, small))
    # the JAX fleet's transcripts are its in-process predictor's
    assert jax['fleet'] == [rec['tokens'] for rec in jax['inproc']]
    assert port['fleet'] == jax['fleet']


@pytest.mark.parametrize('kind', ['dense_keys', 'decode_keys'])
def test_status_and_snapshot_keys_match_reference(sides, kind):
    jax, port = sides
    assert port[kind] == jax[kind]


def test_port_replica_loads_no_jax(sides):
    """This process holds jax and paddle_tpu; the port's replicas, spawned
    from it, hold neither (each checks its own sys.modules)."""
    assert 'jax' in sys.modules and 'paddle_tpu' in sys.modules
    _, port = sides
    assert len(port['hello']) == 2
    for hello in port['hello']:
        assert hello['framework_free'] is True
        assert hello['compiles'] == 0

