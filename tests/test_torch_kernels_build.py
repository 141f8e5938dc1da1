"""paddle_tpu_torch.kernels names each kernel's library by a digest of what
builds it, so a stale library in _build/ never survives an edit: the
source, every shared header under csrc/ and the flags. Runs on the CPU (no
nvcc needed: only the path is computed)."""
import os

import pytest

from paddle_tpu_torch import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, 'CSRC', str(tmp_path))
    (tmp_path / 'k.cu').write_text('#include "frag.cuh"\n')
    (tmp_path / 'frag.cuh').write_text('// v1\n')
    return tmp_path


@pytest.mark.parametrize('edit', ['source', 'header', 'new_header', 'flags'])
def test_lib_path_changes_with_what_builds_the_kernel(csrc, monkeypatch,
                                                      edit):
    before = kernels.lib_path('k')
    assert kernels.lib_path('k') == before  # the same inputs, the same path
    if edit == 'source':
        (csrc / 'k.cu').write_text('#include "frag.cuh"\n// edited\n')
    elif edit == 'header':
        (csrc / 'frag.cuh').write_text('// v2\n')
    elif edit == 'new_header':
        (csrc / 'more.cuh').write_text('// v1\n')
    else:
        monkeypatch.setattr(kernels, 'NVCC_FLAGS',
                            kernels.NVCC_FLAGS + ('-lineinfo',))
    after = kernels.lib_path('k')
    assert after != before
    assert os.path.dirname(after) == kernels.BUILD_DIR
    assert os.path.basename(after).startswith('libk-')


def test_every_header_of_the_port_enters_the_digest():
    names = sorted(f for f in os.listdir(kernels.CSRC) if f.endswith('.cuh'))
    assert 'mma_frag.cuh' in names
    for name in kernels.SOURCES:
        with open(os.path.join(kernels.CSRC, name + '.cu')) as f:
            included = [line.split('"')[1] for line in f
                        if line.startswith('#include "')]
        assert set(included) <= set(names), (name, included)
