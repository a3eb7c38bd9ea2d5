"""One torch CPU thread per test module, for the port's test files.

The tier-1 command runs six pytest workers at once (``-n 6``). With torch's
default of one intra-op thread per core in each worker, the workers'
OpenMP threads oversubscribe the cores and spin between parallel regions,
which slows every worker, the JAX ones included, about twofold. A port test
file imports ``one_torch_thread``, an autouse module fixture that runs the
module on one torch thread and restores the count after it. The port's
CPU results do not depend on the count: tests compare against JAX within
tolerances or, where they compare bit for bit, in exact integer sums or
two runs under the same count.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
