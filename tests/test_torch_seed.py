"""A program with random_seed 0 draws as the reference's does.

paddle_tpu seeds such a program's per-step key from the fixed root
1234567 when FLAGS_deterministic is on (its default) and from a root
drawn from the process's entropy when it is off
(paddle_tpu/executor.py:331-337, core/config.py:71). The port's OpCtx.rng
takes its root from config.step_seed by the same rule. So, in each
package: the startup draws of a seed-0 program (an fc layer's Xavier
weights) are the same in two fresh interpreters with FLAGS_deterministic
unset and differ between two with FLAGS_deterministic=0; a program with a
random_seed of its own draws the same under either setting. (The two
packages' generators differ, so their draws are not compared with each
other.)

Each draw runs in a fresh interpreter: this file run as a script, which
prints the sha256 of the startup's state.
"""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _draw(pkg_name, seed):
    """sha256 of the state a seed-`seed` startup program draws in
    `pkg_name` (paddle_tpu or paddle_tpu_torch), in this process."""
    if pkg_name == 'paddle_tpu':
        import paddle_tpu as pkg
    else:
        import paddle_tpu_torch as pkg
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('x', shape=[32], dtype='float32')
        pkg.layers.fc(pkg.layers.fc(x, size=64), size=8)
    scope = pkg.Scope()
    if pkg_name == 'paddle_tpu':
        with pkg.scope_guard(scope):
            pkg.Executor(pkg.CPUPlace()).run(startup)
        state = {v.name: np.asarray(scope.find_var(v.name).get_tensor())
                 for v in main.list_vars() if v.persistable}
    else:
        pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
        state = pkg.weights.state_to_numpy(main, scope)
    h = hashlib.sha256()
    for n in sorted(state):
        h.update(n.encode())
        h.update(np.ascontiguousarray(state[n], np.float32).tobytes())
    return h.hexdigest()


def _digests(runs):
    """{(pkg, seed, flag, i): digest}, each run a fresh interpreter, all
    started together; flag None leaves FLAGS_deterministic unset."""
    procs = {}
    for key in runs:
        pkg, seed, flag, _ = key
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get('PYTHONPATH')) if p))
        env.pop('FLAGS_deterministic', None)
        if flag is not None:
            env['FLAGS_deterministic'] = flag
        procs[key] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), pkg, str(seed)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, (key, stderr[-4000:])
        out[key] = stdout.split()[-1]
    return out


@pytest.mark.parametrize('pkg', ['paddle_tpu', 'paddle_tpu_torch'])
def test_seed_zero_follows_flags_deterministic(pkg):
    d = _digests([(pkg, seed, flag, i)
                  for seed, flag in ((0, None), (0, '0'), (5, None),
                                     (5, '0'))
                  for i in range(2)])
    # deterministic by default: the same draws in two processes
    assert d[pkg, 0, None, 0] == d[pkg, 0, None, 1]
    # FLAGS_deterministic=0: each process its own entropy root
    assert d[pkg, 0, '0', 0] != d[pkg, 0, '0', 1]
    assert d[pkg, 0, None, 0] not in (d[pkg, 0, '0', 0], d[pkg, 0, '0', 1])
    # a seed of the program's own is not touched by the flag
    assert len({d[pkg, 5, flag, i] for flag in (None, '0')
                for i in range(2)}) == 1
    assert d[pkg, 5, None, 0] != d[pkg, 0, None, 0]


if __name__ == '__main__':
    print(_draw(sys.argv[1], int(sys.argv[2])))
