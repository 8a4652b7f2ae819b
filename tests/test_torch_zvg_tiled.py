"""The port's tile-gated matmul (K7, ``zvg_matmul``) in its plain version
against the JAX package: ``zvg_matmul_pallas`` in interpret mode (its
default, as ``tests/test_kernels.py`` runs it) and ``zvg_matmul_ref``, on
the same numpy operands.

The gated map is held bitwise; the product within the stated tolerance of
``repro_torch.kernels.zvg_matmul.cases.TILED_TOL`` (relative to the
largest magnitude, NaN in the same places), over the case list the card
checks use: the shapes, block sweep, planted zero blocks and all-zero
cases of ``test_kernels.py``, a tile of -0.0 (gated: the gate tests
values) and a zero tile with one NaN (live).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.zvg_matmul.kernel import zvg_matmul_pallas
from repro.kernels.zvg_matmul.ref import zvg_matmul_ref as j_zvg_matmul_ref
from repro_torch.kernels import zvg_matmul
from repro_torch.kernels.zvg_matmul.cases import (TILED_CASES, TILED_TOL,
                                                  tiled_case, tiled_error)
from repro_torch.kernels.zvg_matmul.kernel import zvg_matmul_cuda
from repro_torch.kernels.zvg_matmul.ref import row_is_live, zvg_matmul_ref

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), _JNP[t.dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", TILED_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-b{c[3]}.{c[4]}.{c[5]}"
                              f"-{c[7] or c[6]}" for c in TILED_CASES])
def test_plain_matches_the_jax_kernel(case, dtype):
    M, K, N, bm, bn, bk, zf, plant = case
    a, b = tiled_case(M, K, N, zf, plant, dtype, seed=M + K, device="cpu")
    out, gated = zvg_matmul(a, b, bm, bn, bk)
    assert out.dtype == torch.float32 and gated.dtype == torch.int32
    assert tuple(gated.shape) == (-(-M // bm), -(-K // bk))
    j_out, j_gated = zvg_matmul_pallas(_jax(a), _jax(b), block_m=bm,
                                       block_n=bn, block_k=bk)
    r_out, r_gated = j_zvg_matmul_ref(_jax(a), _jax(b), block_m=bm,
                                      block_k=bk)
    np.testing.assert_array_equal(gated.numpy(), np.asarray(j_gated))
    np.testing.assert_array_equal(gated.numpy(), np.asarray(r_gated))
    for want in (j_out, r_out):
        err = tiled_error(out, torch.from_numpy(np.array(want)))
        assert err <= TILED_TOL[dtype], err
    if plant == "zero_blocks":
        assert int(gated.sum()) == 2
    if plant == "all_zero":
        assert bool((gated == 1).all()) and float(out.abs().max()) == 0.0


def test_the_gate_tests_values_not_bits():
    """-0.0 is zero and gated (K2's row test on bits keeps it live); a
    NaN makes its tile live and reaches the product."""
    a = torch.zeros(128, 256)
    a[:, :128] = -0.0
    a[3, 200] = float("nan")
    b = torch.ones(256, 8)
    out, gated = zvg_matmul(a, b)
    assert gated.tolist() == [[1, 0]]
    assert bool(row_is_live(a)[0])              # the bit test: -0.0 is live
    assert torch.isnan(out[3]).all() and float(out[4:].abs().max()) == 0.0


def test_ref_backend_and_default_agree_on_the_cpu():
    a, b = tiled_case(130, 257, 70, 0.5, None, torch.bfloat16, seed=0,
                      device="cpu")
    got, g = zvg_matmul(a, b, backend="ref")
    want, wg = zvg_matmul_ref(a, b)
    assert torch.equal(got, want) and torch.equal(g, wg)


def test_entries_raise_on_what_they_do_not_take():
    a = torch.randn(16, 32)
    b = torch.randn(32, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        zvg_matmul_cuda(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        zvg_matmul(a, b, backend="cuda")
    assert zvg_matmul_cuda.launches == 0
    with pytest.raises(TypeError, match="share a dtype"):
        zvg_matmul(a, b.to(torch.bfloat16))
    with pytest.raises(TypeError, match="share a dtype"):
        zvg_matmul(a.half(), b.half())
    with pytest.raises(ValueError, match=r"\[M, K\] x \[K, N\]"):
        zvg_matmul(a, b[:5])
    with pytest.raises(ValueError, match="positive"):
        zvg_matmul(a, b, block_k=0)
