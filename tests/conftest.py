import pytest

try:
    import torch
except ImportError:  # the JAX package's tests run without the port
    torch = None


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread for every test: the tests run beside other test
    processes, where the port's plain passes' many small parallel ops wait
    on threads the other processes hold (a 25-wide hash of 40,000 windows
    takes 0.04 s on one thread and 0.7 s on eight beside them)."""
    if torch is None:
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
