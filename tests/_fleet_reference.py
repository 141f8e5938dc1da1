"""The JAX package's side of the port's fleet tests, and what both
sides build: tests/test_fleet.py's `dense_art` classifier and `decode_art`
decode spec, the requests, and the JAX fleets' results.

Run as a script in a fresh interpreter (run_jax_side), with
PTPU_ARTIFACT_AOT=0 and export(precompile=False):

    python tests/_fleet_reference.py OUT_DIR params|fleet

`params` writes the classifier's initial state (dense_params.npz) and
the top-1 parity of its int8 tier over the calibration rows
(reference.json); `fleet` also serves both models through the JAX package's FleetRouter,
2 replicas each, and writes what tests/test_torch_fleet_cross.py compares.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import Config, create_predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8
SEED = 7
DECODE = dict(vocab=61, d_model=8, n_head=2, n_layer=1, d_ff=16,
              max_slots=4, max_cache_len=40, prompt_buckets=(4,), eos_id=1)
DENSE_RTOL = 1e-4
DECODE_TOL = 1e-5
N_DENSE = 10
N_PROMPTS = 12
MAX_NEW = 12


def _x(seed, rows=8):
    return np.random.RandomState(100 + seed).randn(
        rows, DIM).astype(np.float32)


def _prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(2, DECODE['vocab'], rng.randint(2, 5))
            for _ in range(N_PROMPTS)]


def _calibration():
    rng = np.random.RandomState(3)
    return [[rng.randn(8, DIM).astype(np.float32)] for _ in range(4)]


def _dense_program(fluid):
    """The classifier in either package: (main, startup, out)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name='img', shape=[DIM], dtype='float32')
        h = fluid.layers.fc(img, 32, act='relu')
        out = fluid.layers.fc(h, 4, act='softmax')
    return main, startup, out


def _keys(status, snap):
    return {'status': sorted(status),
            'snapshot': sorted(snap),
            'replica': sorted({k for s in snap['replicas'].values()
                               for k in s})}


def _gaps(row):
    top = np.sort(np.asarray(row, np.float64).ravel())[::-1][:2]
    return float(top[0] - top[1])


def _jax_side(root, mode):
    """Writes dense_params.npz; with mode 'fleet' also decode_params.npz
    and fleet.json: the JAX fleets' dense outputs and transcripts, the
    in-process transcripts with each step's top-two gap and largest
    |logit|, and the keys of status() and fleet_snapshot()."""
    import paddle_tpu as fluid
    from paddle_tpu.inference import CompiledPredictor as JaxCompiled
    from paddle_tpu.inference import Config as JaxConfig
    from paddle_tpu.inference import DecodingPredictor as JaxDecoder
    from paddle_tpu.inference import FleetRouter as JaxRouter
    from paddle_tpu.inference import create_predictor as jax_predictor
    from paddle_tpu.inference import export_compiled as jax_export
    from paddle_tpu.inference import export_decode as jax_export_decode
    from paddle_tpu.inference.fleet import top1_agreement as fleet_top1
    from models.transformer import build_decode_spec as jax_build

    def persistables(scope, program):
        return {v.name: np.asarray(scope.find_var(v.name).get_tensor())
                for v in program.list_vars() if v.persistable}

    scope = fluid.core.Scope()
    with fluid.scope_guard(scope), fluid.unique_name.guard():
        main, startup, out = _dense_program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        np.savez(os.path.join(root, 'dense_params.npz'),
                 **persistables(scope, startup))
        model_dir = os.path.join(root, 'jax_model')
        fluid.io.save_inference_model(model_dir, ['img'], [out], exe, main)
        dense = os.path.join(root, 'jax_dense')
        calib = _calibration()
        jax_export(jax_predictor(JaxConfig(model_dir)), calib[0], dense,
                   batch_sizes=[8], precompile=False, quantize='int8',
                   calibration=calib)
    # the rollout's parity measure, the int8 tier against the default one
    # over the calibration rows, as the reference's serving gives it
    tiers = [JaxCompiled(dense, tier=t) for t in (None, 'int8')]
    with open(os.path.join(root, 'reference.json'), 'w') as f:
        json.dump({'int8_top1_parity': float(np.mean([
            fleet_top1(tiers[1].run(c), tiers[0].run(c)) for c in calib]))},
            f)
    if mode == 'params':
        return
    scope = fluid.core.Scope()
    with fluid.scope_guard(scope), fluid.unique_name.guard():
        spec = jax_build(**DECODE)
        fluid.Executor(fluid.CPUPlace()).run(spec['startup'])
        np.savez(os.path.join(root, 'decode_params.npz'),
                 **persistables(scope, spec['startup']))
        decode = os.path.join(root, 'jax_decode')
        jax_export_decode(spec, decode, scope=scope, precompile=False)

    res = {'inproc': []}
    with JaxDecoder(decode, platform='cpu') as pred:
        seen = []
        orig_pre, orig_step = pred._dispatch_prefill, pred._dispatch_step

        def pre(*a):
            seen.append(np.asarray(orig_pre(*a))[None])
            return seen[-1][0]

        def step(*a):
            seen.append(np.asarray(orig_step(*a)))
            return seen[-1]
        pred._dispatch_prefill, pred._dispatch_step = pre, step
        for p in _prompts():
            del seen[:]
            toks = pred.generate(p, max_new_tokens=MAX_NEW)
            # a lone request decodes in slot 0
            res['inproc'].append({
                'tokens': [int(t) for t in toks],
                'margins': [_gaps(a[0]) for a in seen],
                'scales': [float(np.abs(a[0]).max()) for a in seen]})
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with JaxRouter(dense, replicas=2, platform='cpu') as router:
            outs = [f.result(300) for f in [router.submit({'img': _x(i)})
                                            for i in range(N_DENSE)]]
            np.savez(os.path.join(root, 'dense_out.npz'),
                     **{'r%d' % i: o[0] for i, o in enumerate(outs)})
            res['dense_keys'] = _keys(router.status(),
                                      router.fleet_snapshot())
        with JaxRouter(decode, replicas=2, platform='cpu') as router:
            futs = [router.submit(p, max_new_tokens=MAX_NEW)
                    for p in _prompts()]
            res['fleet'] = [[int(t) for t in f.result(300)] for f in futs]
            res['decode_keys'] = _keys(router.status(),
                                       router.fleet_snapshot())
    with open(os.path.join(root, 'fleet.json'), 'w') as f:
        json.dump(res, f)


def run_jax_side(root, mode):
    """This file as a script in a fresh interpreter, writing under root."""
    env = dict(os.environ, PTPU_ARTIFACT_AOT='0', PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root,
                        mode], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]


def port_dense_model(params, model_dir):
    """The classifier in the port with the JAX initial state, saved as an
    inference model; returns the port's in-process Predictor on it."""
    with ptt.unique_name.guard():
        main, startup, out = _dense_program(ptt)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(params, startup, scope)
    with ptt.scope_guard(scope):
        ptt.io.save_inference_model(model_dir, ['img'], [out],
                                    ptt.Executor(ptt.CPUPlace()), main)
    return create_predictor(Config(model_dir).disable_gpu())



if __name__ == '__main__':
    _jax_side(sys.argv[1], sys.argv[2])
