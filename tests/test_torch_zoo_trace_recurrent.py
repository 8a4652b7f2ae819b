"""The model-wide tracer on RecurrentGemma-9B (RG-LRU with local
attention) and xLSTM-1.3B against the JAX package's, live, held as
``tests/test_torch_zoo_trace.py`` holds the other archs of the zoo: the
sLSTM's step loop (one ``bhd,hde->bhe`` site a step), the mLSTM's chunk
loop and its one-step recurrent loop in decode (``scan[i]`` frames), the
recurrent and xLSTM blocks' bare products (sites through
``models.matmul`` with no backend), the local attention's einsums."""
import pytest
import torch

from test_torch_zoo_trace import check_arch_trace


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_zoo_trace_sites_equal_jax(arch):
    check_arch_trace(arch)
