"""K8, the grouped gated expert product, against its plain version on the
card. Every test here is marked ``cuda`` and skips where no NVIDIA GPU is
present; run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_expert_kernel.py

The cases: DeepSeek-V2-Lite's decode step (128 tokens top-6 over 64
experts: gate and up at K = 2048, N = 1408, down at K = 1408, N = 2048),
experts with no rows, a segment of more than one row tile (150 rows: three
tiles), a row count that is no multiple of the tile, and gated rows (all
+0.0 words, written +0.0 bit for bit whatever the weights hold). The
ungated product holds to K2's wide-route rule (``WIDE_TOL``: the output's
one rounding and the order of the float32 sums, against the float32
product of each segment); the gated one (SiLU(gate) * up, five bfloat16
roundings after the two products) to ``GLU_TOL`` against the plain
version. Then the dropless MoE layer at DeepSeek-V2-Lite's widths with K8
against the same layer on the plain route. This file imports no JAX.
"""
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.expert_matmul import kernel as k8
from repro_torch.kernels.expert_matmul.ref import expert_matmul_ref
from repro_torch.kernels.zvg_matmul.cases import WIDE_TOL
from repro_torch.models import layers as L

pytestmark = pytest.mark.cuda

#: the gated product's tolerance against the plain version (its reasons
#: beside it in the wrapper)
GLU_TOL = k8.GLU_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels run only on "
                    "the card")
    return torch.device("cuda")


def _case(counts, K, N, seed, device, zero_rows=()):
    g = torch.Generator(device=device).manual_seed(seed)
    E = len(counts)
    P = sum(counts)
    x = torch.randn(P, K, generator=g, device=device).to(torch.bfloat16)
    for r in zero_rows:
        if r < P:
            x[r] = 0
    w = (torch.randn(E, K, N, generator=g, device=device)
         * K ** -0.5).to(torch.bfloat16)
    w_up = (torch.randn(E, K, N, generator=g, device=device)
            * K ** -0.5).to(torch.bfloat16)
    offsets = torch.tensor([0] + list(counts), device=device).cumsum(0).to(
        torch.int32)
    return x, w, w_up, offsets


def _decode_counts(seed, tokens=128, k=6, E=64):
    g = torch.Generator().manual_seed(seed)
    picks = torch.rand(tokens, E, generator=g).argsort(-1)[:, :k]
    return torch.bincount(picks.reshape(-1), minlength=E).tolist()


CASES = {
    "decode": (lambda: _decode_counts(1), 2048, 1408),
    "decode_down": (lambda: _decode_counts(2), 1408, 2048),
    "empty_and_long": (lambda: [0, 150, 0, 3, 64, 0, 65, 1], 128, 72),
    "ragged": (lambda: [5, 0, 17, 0, 0, 40], 192, 8),
}


def _segment_f32(x, w, offsets):
    """The float32 product of each segment and ``|x| @ |w|`` beside it."""
    out = torch.zeros(x.shape[0], w.shape[2], device=x.device)
    mag = torch.zeros_like(out)
    b = offsets.tolist()
    for e in range(w.shape[0]):
        xe = x[b[e]:b[e + 1]].float()
        out[b[e]:b[e + 1]] = xe @ w[e].float()
        mag[b[e]:b[e + 1]] = xe.abs() @ w[e].float().abs()
    return out, mag


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("gated", [False, True])
def test_k8_matches_the_plain_route(cuda, name, gated):
    counts_of, K, N = CASES[name]
    counts = counts_of()
    x, w, w_up, offsets = _case(counts, K, N, 11, cuda,
                                zero_rows=(0, 7, 150, 200))
    up = w_up if gated else None
    before = launch_counts()["k8"]
    got = k8.expert_matmul_cuda(x, w, offsets, max(counts), up)
    torch.cuda.synchronize()
    assert launch_counts()["k8"] == before + 1
    plain = expert_matmul_ref(x, w, offsets, up, act=L.silu)
    live = (x.view(torch.int16) != 0).any(-1)
    for out in (got, plain):
        assert (out[~live].view(torch.int16) == 0).all()
    if gated:
        err = (got.float() - plain.float()).abs()
        bound = (GLU_TOL[0] * plain.float().abs()
                 + GLU_TOL[1] * plain.float().abs().max())
        assert (err <= bound).all(), float((err - bound).max())
    else:
        f32, mag = _segment_f32(x, w, offsets)
        bound = WIDE_TOL[0] * f32.abs() + WIDE_TOL[1] * mag + 2.0 ** -126
        for out in (got, plain):
            excess = ((out.float() - f32).abs() - bound)[live]
            assert float(excess.max()) <= 0


def test_k8_rows_do_not_depend_on_their_tile_mates(cuda):
    """A segment's rows alone and among others give the same bits: no K
    split, sums in k order inside one block."""
    x, w, w_up, offsets = _case([40, 30], 256, 64, 12, cuda)
    full = k8.expert_matmul_cuda(x, w, offsets, 40, w_up)
    alone = torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda)
    for r in (0, 39, 45):
        one = k8.expert_matmul_cuda(x[r:r + 1].contiguous(), w,
                                    alone if r < 40 else
                                    torch.tensor([0, 0, 1],
                                                 dtype=torch.int32,
                                                 device=cuda), 1, w_up)
        assert torch.equal(one[0], full[r])


def test_k8_refuses_what_it_does_not_take(cuda):
    """The wrapper, and the entry point's ``auto`` on card tensors, raise
    for operands K8 does not take: no silent plain route on the card."""
    from repro_torch.kernels.expert_matmul import expert_matmul

    x, w, w_up, offsets = _case([3, 2], 96, 64, 13, cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        k8.expert_matmul_cuda(x, w, offsets, 3)
    assert not k8.expert_route(x.float(), w.float())
    x, w, w_up, offsets = _case([3, 2], 128, 64, 13, cuda)
    with pytest.raises(ValueError, match="contiguous bfloat16"):
        expert_matmul(x.float(), w.float(), offsets, 3, backend="auto")
    with pytest.raises(ValueError, match="SiLU only"):
        expert_matmul(x, w, offsets, 3, w_up=w_up, act=L.gelu,
                      backend="auto")


def test_dropless_layer_on_k8_at_deepseek_widths(cuda):
    from repro_torch.configs import deepseek_v2_lite as DS
    from repro_torch.models import moe as M

    cfg = DS.CONFIG
    gen = torch.Generator(device=cuda).manual_seed(14)
    with torch.no_grad():
        p = M.make_moe(cfg.d_model, cfg.moe, gen)
        p = {k: (v if k == "router" else
                 {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(torch.bfloat16))
             for k, v in p.items()}
        x = torch.randn(1, 128, cfg.d_model, generator=gen,
                        device=cuda).to(torch.bfloat16)
        before = launch_counts()["k8"]
        got, _ = M.apply_moe(p, x, cfg.moe, backend="auto")
        assert launch_counts()["k8"] == before + 2
        want, _ = M.apply_moe(p, x, cfg.moe, backend="ref")
    err = (got.float() - want.float()).abs().max()
    assert float(err) <= 2e-2 * float(want.float().abs().max())
