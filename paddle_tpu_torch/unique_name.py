"""Unique name generator (ref: python/paddle/fluid/unique_name.py).

The same generator as paddle_tpu.unique_name: a model built under a fresh
`guard()` in both packages gets the same variable names
(`conv2d_0.w_0`, `batch_norm_0.b_0`, ...), which is what lets
`weights.params_from_numpy` carry parameters across by name."""
from __future__ import annotations

import contextlib


class UniqueNameGenerator(object):
    def __init__(self, prefix=''):
        self.ids = {}
        self.prefix = prefix

    def __call__(self, key):
        tmp = self.ids.setdefault(key, 0)
        self.ids[key] = tmp + 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
