"""The port's CPU tests on one torch intra-op thread: several threads burn
many times the CPU time on their small ops, and a test run shares its CPUs
among its workers. A test file takes the fixture with

    from _torch_threads import one_thread  # noqa: F401 (autouse)
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
