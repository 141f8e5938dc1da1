"""FLAGS-style config, the port's copy of the one flag of
paddle_tpu/core/config.py that its slices read so far.

deterministic (FLAGS_deterministic, default '1'): a program whose
random_seed is 0 draws its random numbers from the fixed root 1234567,
the same in every process; with FLAGS_deterministic=0 from a root drawn
from the process's entropy once (OpCtx.rng, as paddle_tpu/executor.py:
331-337 `_step_seed` and :108-127 `_process_entropy` seed the reference's
per-step key).
"""
from __future__ import annotations

import os

FLAGS = {
    'deterministic': os.environ.get('FLAGS_deterministic', '1') == '1',
}

# the root of a seed-0 program's draws under FLAGS_deterministic
DETERMINISTIC_SEED = 1234567

_entropy_seed = None


def get_flag(name, default=None):
    return FLAGS.get(name, default)


def process_entropy():
    """A seed root drawn from the process's entropy at its first call and
    kept for the life of the process (never 0)."""
    global _entropy_seed
    if _entropy_seed is None:
        _entropy_seed = int.from_bytes(os.urandom(4), 'little') or 1
    return _entropy_seed


def step_seed(program):
    """The seed root of `program`'s draws: its random_seed, or for 0
    DETERMINISTIC_SEED when FLAGS deterministic is on (the default) and
    the process's entropy root when it is off."""
    seed = int(program.random_seed or 0)
    if not seed:
        seed = (DETERMINISTIC_SEED if get_flag('deterministic')
                else process_entropy())
    return seed
