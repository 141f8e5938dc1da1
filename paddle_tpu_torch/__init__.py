"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Fluid API as paddle_tpu (Program/Block/Operator built by
`layers.*`, trained through `optimizer.*.minimize` and an Executor, served
by `inference.Predictor`), run eagerly with torch on an NVIDIA GPU. It imports torch and numpy, never jax
and nothing of paddle_tpu, which stays in the repository as the reference.

    import paddle_tpu_torch as fluid
    x = fluid.layers.data('x', shape=[3, 224, 224])
    y = fluid.layers.fc(x, size=10)
    exe = fluid.Executor()                 # CUDAPlace(0) by default
    exe.run(fluid.default_startup_program())
    out, = exe.run(feed={'x': xs}, fetch_list=[y])

bf16 mixed-precision training: `fluid.contrib.mixed_precision.enable_bf16(
main)` (or `decorate(optimizer)` before `minimize`), then Executor.run as
usual. Program passes and the dataflow analysis: `fluid.passes`; the
Executor lints each program (PTPU_STRICT_VERIFY=1 raises) and frees each
value after its last reader.
"""
from . import ops as _ops  # registers all op lowerings  # noqa: F401

from .framework import (Program, Block, Operator, Variable, Parameter,  # noqa
                        default_main_program, default_startup_program,
                        program_guard, switch_main_program,
                        switch_startup_program, convert_dtype,
                        CPUPlace, CUDAPlace)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .executor import Executor  # noqa: F401
from . import core, initializer, inference, io, layers, unique_name  # noqa
from . import backward, clip, contrib, optimizer, regularizer  # noqa: F401
from . import weights  # noqa: F401
from . import passes  # noqa: F401
from .passes import ProgramVerifyError  # noqa: F401
from .transpiler import (memory_optimize, release_memory,  # noqa: F401
                         InferenceTranspiler)
from .param_attr import ParamAttr  # noqa: F401
from .lod_tensor import (LoDTensor, create_lod_tensor,  # noqa: F401
                         create_random_int_lodtensor)
from .initializer import Constant, Uniform, Normal, Xavier, MSRA  # noqa
