"""The thread rule of the port's tests: torch runs on one thread in every
``test_torch_*`` module, and in every process such a test starts.

The suite runs in several worker processes side by side (pytest-xdist), and
the port's tests are made of many small tensor operations. With torch's
default pool of a thread a core in each worker, the workers' threads fight
over the cores, and a test that takes half a second alone takes minutes.
The JAX package's test modules keep their own settings; the repository's
root conftest.py configures them.
"""

import pytest

# torch's threads in a port test and in the processes it starts
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def _one_thread(request):
    """Pin torch to THREADS threads for a test_torch_* module, and give the
    old count back after it."""
    if not request.module.__name__.rpartition(".")[2].startswith(
            "test_torch_"):
        yield
        return
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def one_thread_children(monkeypatch):
    """The processes the test starts run torch on THREADS threads: they
    inherit OMP_NUM_THREADS."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(THREADS))
