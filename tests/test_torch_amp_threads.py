"""bf16 AMP state is per thread on the port (core/amp.py).

The Executor reads the switch at every op of every run, and a serving
thread may run f32 inference while another thread trains in bf16: a thread
inside `amp.scope(True)` must leave every other thread's `amp.enabled()`
False for the whole of its steps.
"""
import threading

import numpy as np

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import amp


def _f32_program():
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 3
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data(name='x', shape=[64], dtype='float32')
        out = ptt.layers.fc(ptt.layers.fc(x, 64, act='relu'), 8)
    return main, startup, out


def test_amp_scope_of_one_thread_leaves_another_f32():
    main, startup, out = _f32_program()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    x = np.random.RandomState(0).randn(16, 64).astype(np.float32)
    want, = exe.run(main, feed={'x': x}, fetch_list=[out], scope=scope)

    go, inside, release = (threading.Event(), threading.Event(),
                           threading.Event())
    seen = []

    def bf16_thread():
        go.wait(60)
        with amp.scope(True):
            seen.append(amp.enabled())
            inside.set()
            release.wait(60)
            seen.append(amp.enabled())

    t = threading.Thread(target=bf16_thread)
    t.start()
    states = []
    real_matmul = amp.matmul

    def spy(x, y, **kw):
        # the other thread enters its bf16 scope in the middle of this
        # thread's step, at its first product
        if not go.is_set():
            go.set()
            assert inside.wait(60)
        states.append(amp.enabled())
        return real_matmul(x, y, **kw)

    amp.matmul = spy
    try:
        got = [exe.run(main, feed={'x': x}, fetch_list=[out],
                       scope=scope)[0] for _ in range(2)]
    finally:
        amp.matmul = real_matmul
        release.set()
        t.join()
    assert seen == [True, True]
    assert states and not any(states)
    for g in got:
        np.testing.assert_array_equal(g, want)
    assert amp.enabled() is False
