"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where no NVIDIA GPU is
present; run this tier on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer counters must be bitwise equal. This file imports no JAX: the
GPU machine need not have it.
"""
import pytest
import torch

from repro_torch import design as D
from repro_torch.core import bic, systolic
from repro_torch.kernels.power_counters import CounterSpec, edge_counters
from repro_torch.kernels.power_counters import kernel as k1
from repro_torch.kernels.power_counters.ref import fused_counters_ref

pytestmark = pytest.mark.cuda

FULL = CounterSpec(bic_variants=tuple(bic.NAMED_SEGMENTS.values()),
                   zvg=True, hist=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels run only on "
                    "the card")
    return torch.device("cuda")


def _words(shape, seed=0, zf=0.6):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 16, shape, generator=g, dtype=torch.int32)
    r = torch.rand(shape, generator=g)
    x[r < zf] = 0
    x[(r >= zf) & (r < zf + 0.03)] = 0x8000
    x[(r >= zf + 0.03) & (r < zf + 0.05)] = 0x7FC0
    return x


def _assert_same(x, spec, words=None):
    kc, kr = k1.fused_counters_cuda(x if words is None else words, spec)
    pc, pr = fused_counters_ref(x, spec)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc), [spec.rows[i] for i in range(spec.n_rows)
                                 if not torch.equal(kc[..., i, :],
                                                    pc[..., i, :])]
    assert torch.equal(kr, pr)


@pytest.mark.parametrize("T,L", [(1, 1), (7, 33), (257, 129), (4609, 40),
                                 (147, 12544)])
def test_kernel_matches_plain(cuda, T, L):
    x = _words((T, L), seed=T + L).to(cuda)
    _assert_same(x, FULL)
    _assert_same(x, FULL, words=x.to(torch.int16).view(torch.uint16))


def test_kernel_batched_and_31_segments(cuda):
    _assert_same(_words((6, 130, 70), seed=3).to(cuda), FULL)
    singles = tuple((1 << b,) for b in range(15))
    pairs = tuple(((1 << b) | (1 << ((b + 3) % 16)),) for b in range(16))
    spec = CounterSpec(bic_variants=singles + pairs, zvg=True, hist=True)
    assert len(spec.unique_segments) == 31
    _assert_same(_words((300, 45), seed=4).to(cuda), spec)


def test_auto_backend_launches_the_kernel(cuda):
    x = _words((64, 48), seed=5).to(cuda)
    before = k1.fused_counters_cuda.launches
    out = edge_counters(x, FULL)
    assert k1.fused_counters_cuda.launches == before + 1
    ref = edge_counters(x, FULL, backend="ref")
    assert k1.fused_counters_cuda.launches == before + 1
    for k in out:
        assert torch.equal(out[k], ref[k]), k


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = _words((16, 8)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_counters_cuda(x.t(), FULL)
    with pytest.raises(TypeError, match="uint16 or int32"):
        k1.fused_counters_cuda(x.to(torch.int64), FULL)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.fused_counters_cuda(x.cpu(), FULL)
    with pytest.raises(ValueError, match=r"\[T, L\]"):
        k1.fused_counters_cuda(x[0], FULL)


def test_edge_streams_hand_the_kernel_uint16_words(cuda):
    g = torch.Generator().manual_seed(7)
    A = torch.relu(torch.randn(75, 300, generator=g))
    W = torch.randn(300, 40, generator=g) * 0.05
    for got, want in zip(systolic.edge_streams(A.to(cuda), W.to(cuda)),
                         systolic.edge_streams(A, W)):
        assert got.dtype == torch.uint16 and got.is_contiguous()
        assert torch.equal(got.to(torch.int32).cpu(), want)


def test_design_report_on_the_card_equals_plain(cuda):
    g = torch.Generator().manual_seed(6)
    A = torch.relu(torch.randn(75, 300, generator=g))
    W = torch.randn(300, 40, generator=g) * 0.05
    kw = dict(west_bic=tuple(bic.NAMED_SEGMENTS.values()),
              north_bic=tuple(bic.NAMED_SEGMENTS.values()),
              west_zvg=True, north_zvg=True)
    got = systolic.sa_design_report(A.to(cuda), W.to(cuda), **kw)
    want = systolic.sa_design_report(A, W, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    designs = tuple(D.named_designs().values())
    ev_gpu = D.evaluate_batched(A.reshape(3, 25, 300).to(cuda),
                                W.reshape(3, 100, 40)[:, :, :1]
                                .repeat(1, 3, 1).to(cuda), designs)
    ev_cpu = D.evaluate_batched(A.reshape(3, 25, 300),
                                W.reshape(3, 100, 40)[:, :, :1]
                                .repeat(1, 3, 1), designs)
    for name in ev_cpu:
        for c, v in ev_cpu[name]["energy"].items():
            assert float(ev_gpu[name]["energy"][c]) == float(v), (name, c)
