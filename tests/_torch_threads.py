"""``one_torch_thread``, an autouse fixture that the port's test files import:
one torch intra-op thread for each test. On the CPU the port runs its kernels'
plain versions, thousands of small ops (the plain K8 and K9 sum each layer in
the kernels' order), and the host-built kernels beside them; the test workers
share the machine's cores, and several OpenMP threads a worker then wait on one
another far longer than the ops take (a host-built K5 test took 207 s with
torch's default threads on an 8-core x86-64 host loaded to 58, 2 s with one)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
