"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under csrc/ with a plain C interface.
At first use it is compiled with nvcc for Hopper (sm_90a) into a shared
library under _build/ and loaded with ctypes. The library's file name
carries a digest of the source, of every shared header (csrc/*.cuh) and of
the flags, so an edited source or header builds anew. Nothing here runs at import: a machine without nvcc or a card imports
the package and takes the plain PyTorch paths on CPU tensors.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')

SOURCES = ('bn_apply', 'flash_attn_fwd', 'flash_attn_bwd')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded = {}


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels are built from csrc/ at first "
                           "use on a machine with the CUDA toolkit")
    return path


def lib_path(name):
    """The library kernel `name` builds into: its digest covers the source,
    every header under csrc/ (any source may include any of them) and the
    flags."""
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC, '*.cuh')))
    for path in [os.path.join(CSRC, name + '.cu')] + headers:
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + f.read())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name,
                                                    digest.hexdigest()[:16]))


def build(names=SOURCES):
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns {name: (seconds, ptxas
    report)}; raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = '%s.tmp.%d' % (out, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC, name + '.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    report, failed = {}, []
    for name, (p, t0, tmp, out) in procs.items():
        log, _ = p.communicate()
        report[name] = (time.perf_counter() - t0, log)
        if p.returncode != 0:
            failed.append('%s (exit %d):\n%s' % (name, p.returncode, log))
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name):
    """The ctypes handle of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build((name,))
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
