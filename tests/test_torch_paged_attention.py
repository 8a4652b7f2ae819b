"""The port's paged attention pieces against the JAX package, on the CPU,
on the same numpy-made inputs:

* the plain version of K4 (``kernels.zvg_matmul.ref.
  fused_paged_attention_ref``: the page gather, then the dense decode
  attention) against the JAX Pallas kernel ``fused_paged_attention`` in
  interpret mode, as ``tests/test_zvg_matmul_kernels.py`` runs it, with
  ``rep`` 1 and 2 and softcap 0 and 5, in float32 and bfloat16; the page
  tables hold a dead row (all trash, length 1), two rows sharing pages, a
  length of 1, a ragged length and a full table;
* ``_page_targets`` (integers, exact), ``kernels.zvg_matmul.ref.
  gather_pages`` (a gather, bit for bit) and ``paged_chunk_attention``
  (with right-padding positions).

Tolerances, relative to the output's largest magnitude: the gather and
the page targets are exact; the attention is not bitwise in float32,
because the two frameworks' CPU einsums sum in other orders (a few
float32 units, measured 4e-7 absolute), so float32 is held within 2e-6;
bfloat16 rounds the scores and the probabilities in both at the same
places and is held within one bfloat16 unit, 2**-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.zvg_matmul.fused import fused_paged_attention as jfused
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch.kernels.zvg_matmul import fused_paged_attention, kernel, ref
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

B, MP, PS, KV, HD = 4, 4, 8, 2, 16
P = 1 + B * MP
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -8}


def _case(rep: int, seed: int):
    """q, pools, tables and lengths as numpy: row 0 at length 1, row 1
    sharing row 0's first two pages at the full table, row 2 ragged, row
    3 dead (all-trash table, length 1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, KV * rep, HD)).astype(np.float32)
    kp = rng.standard_normal((P, PS, KV, HD)).astype(np.float32)
    vp = rng.standard_normal((P, PS, KV, HD)).astype(np.float32)
    pages = rng.permutation(np.arange(1, P))[:B * MP].reshape(B, MP)
    pages = pages.astype(np.int32)
    pages[1, :2] = pages[0, :2]
    pages[3] = 0
    lengths = np.array([1, MP * PS, 2 * PS + 3, 1], np.int32)
    return q, kp, vp, pages, lengths


def _assert_close(got: torch.Tensor, want, dtype: str, what: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), f"{what}: {err}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rep,softcap", [(1, 0.0), (2, 5.0)])
def test_plain_paged_attention_matches_jax_kernel(dtype, rep, softcap):
    jdt, tdt = DTYPES[dtype]
    q, kp, vp, pages, lengths = _case(rep, seed=rep)

    def attend(qq, kc, vc, ln):
        return JA.decode_attention(qq, kc, vc, ln, softcap=softcap)

    want = jfused(jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                  jnp.asarray(vp, jdt), jnp.asarray(pages),
                  jnp.asarray(lengths), attend)
    t = lambda a: torch.from_numpy(a).to(tdt)   # noqa: E731
    got = ref.fused_paged_attention_ref(
        t(q), t(kp), t(vp), torch.from_numpy(pages),
        torch.from_numpy(lengths), A.decode_attention, softcap=softcap)
    assert got.dtype == tdt and got.shape == q.shape
    _assert_close(got, want, dtype, f"rep {rep} softcap {softcap}")
    # the entry point takes the plain version for CPU tensors
    auto = fused_paged_attention(t(q), t(kp), t(vp), torch.from_numpy(pages),
                                 torch.from_numpy(lengths),
                                 A.decode_attention, softcap=softcap)
    assert torch.equal(auto, got)


def test_page_targets_and_gather_match_jax():
    _, kp, _, pages, _ = _case(1, seed=5)
    positions = np.array([[0, 7, 8, -1], [31, 32, 40, 5],
                          [-1, -1, 3, 16], [0, 0, 0, 0]], np.int32)
    jpg, joff = JT._page_targets(jnp.asarray(pages), jnp.asarray(positions),
                                 PS)
    pg, off = T._page_targets(torch.from_numpy(pages),
                              torch.from_numpy(positions).long(), PS)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jpg))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    assert (pg.numpy()[positions < 0] == 0).all()        # pads -> trash
    assert (pg.numpy()[positions >= MP * PS] == 0).all()
    got = ref.gather_pages(torch.from_numpy(kp), torch.from_numpy(pages))
    want = JT._gather_pages(jnp.asarray(kp), jnp.asarray(pages))
    assert got.shape == (B, MP * PS, KV, HD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_chunk_attention_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(9)
    C, rep = 8, 2
    q = rng.standard_normal((B, C, KV * rep, HD)).astype(np.float32)
    kc = rng.standard_normal((B, MP * PS, KV, HD)).astype(np.float32)
    vc = rng.standard_normal((B, MP * PS, KV, HD)).astype(np.float32)
    pos = np.stack([np.arange(s, s + C) for s in (0, 9, 24, 3)])
    pos[3, 5:] = -1                                   # right padding
    pos = pos.astype(np.int32)
    want = JA.paged_chunk_attention(
        jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
        jnp.asarray(pos), softcap=5.0)
    t = lambda a: torch.from_numpy(a).to(tdt)   # noqa: E731
    got = A.paged_chunk_attention(t(q), t(kc), t(vc),
                                  torch.from_numpy(pos).long(), softcap=5.0)
    _assert_close(got, want, dtype, "paged_chunk_attention")


def test_paged_attention_checks_its_operands():
    q, kp, vp, pages, lengths = (torch.from_numpy(a)
                                 for a in _case(2, seed=3))
    with pytest.raises(TypeError, match="share a dtype"):
        ref.fused_paged_attention_ref(q.bfloat16(), kp, vp, pages, lengths,
                                      A.decode_attention)
    with pytest.raises(ValueError, match="kv dividing h"):
        ref.fused_paged_attention_ref(q[:, :, :3], kp, vp, pages, lengths,
                                      A.decode_attention)
    with pytest.raises(ValueError, match="lengths"):
        ref.fused_paged_attention_ref(q, kp, vp, pages, lengths[:2],
                                      A.decode_attention)
    # the kernel never runs on CPU tensors, and nothing falls back
    before = kernel.fused_paged_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_paged_attention(q, kp, vp, pages, lengths, A.decode_attention,
                              backend="cuda")
    assert kernel.fused_paged_attention_cuda.launches == before


@pytest.mark.parametrize("seed", range(8))
def test_bf16_ulp_check_catches_the_planted_fault_in_every_case(seed):
    """The per-element bfloat16 check of K4 (``cases.bf16_ulp_error``,
    against the float32 plain version of the same bfloat16 inputs) on
    every ``PAGED_CASES`` case of one of the 8 seeds ``chip_smoke.py``
    runs: a result computed in float32 and rounded once passes (at most
    one half here), and the planted fault -- each row's last position
    cut off, rounded the same way -- fails, in every case, where the
    relative limit of 2e-2 lets some through."""
    from repro_torch.kernels.zvg_matmul.cases import (PAGED_CASES,
                                                      bf16_ulp_error,
                                                      paged_case)

    for i, (*shape, cap) in enumerate(PAGED_CASES):
        q, kp, vp, pages, lengths = paged_case(
            *shape, torch.bfloat16, seed=1000 * seed + i, device="cpu")
        f32 = [t.float() for t in (q, kp, vp)]
        want = ref.fused_paged_attention_ref(*f32, pages, lengths,
                                             A.decode_attention, softcap=cap)
        assert bf16_ulp_error(want.to(torch.bfloat16), want) <= 0.5
        assert (lengths > 1).any()
        cut = ref.fused_paged_attention_ref(
            *f32, pages, lengths - (lengths > 1).int(), A.decode_attention,
            softcap=cap).to(torch.bfloat16)
        assert bf16_ulp_error(cut, want) > 1, (i, shape)
