"""paddle_tpu_torch and chip_smoke.py import neither jax nor paddle_tpu.

The port runs on a machine without jax, and it keeps its own copies of
what it needs from the JAX package, even of modules that are pure numpy.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'paddle_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'paddle_tpu', 'models')


def _port_sources():
    out = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith('.py')]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def _forbidden(module):
    return module.split('.')[0] in FORBIDDEN


@pytest.mark.parametrize('relpath', _port_sources())
def test_source_imports_no_jax_package(relpath):
    with open(os.path.join(ROOT, relpath)) as f:
        tree = ast.parse(f.read(), relpath)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ''):
                bad.append(node.module)
    assert not bad, '%s imports %s' % (relpath, bad)


ZOO = ('smallnet', 'alexnet', 'vgg', 'googlenet', 'se_resnext')


@pytest.mark.parametrize('model', ZOO)
def test_zoo_model_is_audited_and_builds_on_the_port(model):
    """Each image-zoo model module is the port's own copy: it is among the
    audited sources, and its layers come from paddle_tpu_torch, as
    `import paddle_tpu_torch as fluid` (never the top-level models/ or
    paddle_tpu)."""
    relpath = os.path.join('paddle_tpu_torch', 'models', model + '.py')
    assert relpath in _port_sources()
    with open(os.path.join(ROOT, relpath)) as f:
        tree = ast.parse(f.read(), relpath)
    imports = [(a.name, a.asname) for node in ast.walk(tree)
               if isinstance(node, ast.Import) for a in node.names]
    assert ('paddle_tpu_torch', 'fluid') in imports, imports


_BLOCKED_IMPORT = r'''
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'):
            raise ImportError('blocked import: ' + name)
        return None

sys.meta_path.insert(0, Block())
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, 'paddle_tpu_torch.'):
    importlib.import_module(m.name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))
assert not leaked, leaked
print('imported', len([m for m in sys.modules
                       if m.startswith('paddle_tpu_torch')]))
'''


def test_package_and_chip_smoke_import_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, '-c', _BLOCKED_IMPORT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert 'imported' in r.stdout


SERVING_MODULES = ('inference.serve', 'inference.batching',
                   'inference.export', 'inference.proto',
                   'inference.ref_format')

_ONE_MODULE = r'''
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'):
            raise ImportError('blocked import: ' + name)
        return None

sys.meta_path.insert(0, Block())
mod = importlib.import_module(sys.argv[1])
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))
assert not leaked, leaked
print('imported', mod.__name__)
'''


@pytest.fixture(scope='module')
def serving_imports():
    """Each serving module imported first in a fresh interpreter, the
    interpreters started together: {module: CompletedProcess-like
    (returncode, stdout, stderr)}."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {m: subprocess.Popen(
        [sys.executable, '-c', _ONE_MODULE, 'paddle_tpu_torch.' + m],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for m in SERVING_MODULES}
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[m] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize('module', SERVING_MODULES)
def test_serving_module_imports_alone_with_jax_blocked(serving_imports,
                                                       module):
    """Each artifact-serving module, imported first in a fresh
    interpreter, loads neither jax nor paddle_tpu."""
    name = 'paddle_tpu_torch.' + module
    assert os.path.join(*name.split('.')) + '.py' in _port_sources()
    rc, stdout, stderr = serving_imports[module]
    assert rc == 0, stderr
    assert 'imported ' + name in stdout


PASS_MODULES = ('passes', 'passes.base', 'passes.verifier', 'passes.dce',
                'passes.const_fold', 'passes.fuse_act', 'passes.dataflow',
                'passes.horizontal_fuse', 'passes.recompute', 'transpiler')

_PASS_IMPORTS = r'''
import importlib, json, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'):
            raise ImportError('blocked import: ' + name)
        return None

sys.meta_path.insert(0, Block())
out = {}
for m in sys.argv[1:]:
    try:
        importlib.import_module('paddle_tpu_torch.' + m)
        out[m] = sorted(n for n in sys.modules
                        if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))
    except Exception as e:  # noqa: BLE001
        out[m] = repr(e)
print(json.dumps(out))
'''


@pytest.fixture(scope='module')
def pass_imports():
    """The pass modules imported one after another, in PASS_MODULES' order
    (the package first), in one fresh interpreter with jax and paddle_tpu
    blocked: {module: [leaked modules] or the import error}."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, '-c', _PASS_IMPORTS] +
                       list(PASS_MODULES), cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('module', PASS_MODULES)
def test_pass_module_imports_with_jax_blocked(pass_imports, module):
    """Each module of the program passes and transpiler.py imports with
    jax and paddle_tpu blocked and leaves neither loaded, and is among the
    audited sources (the reference's passes evaluate with jax; the port's
    use its registry on meta and CPU tensors)."""
    name = 'paddle_tpu_torch.' + module
    path = os.path.join(*name.split('.'))
    assert (path + '.py' in _port_sources()
            or os.path.join(path, '__init__.py') in _port_sources())
    assert pass_imports[module] == [], pass_imports[module]
