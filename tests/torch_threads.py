"""One torch thread per test, for the port's test files that render frames
(``pytestmark = pytest.mark.usefixtures("one_torch_thread")`` beside
``from torch_threads import one_torch_thread``).

The port's plain frames run torch's elementwise ops on every pixel, which
torch splits across its OpenMP threads; when several test workers share a
CPU, those threads oversubscribe its cores (measured on
tests/test_torch_judged.py: 1,282 s under six workers on 8 cores against
~130 s alone, 182 s with one thread). One thread per test keeps each file
near its own time."""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
