"""The port's stream kernels' plain versions against the JAX package:
the transition counter (K5, ``count_transitions``) and the
single-segment BIC encoder (K6, ``bic_encode``), on the same numpy words.

The JAX side is the Pallas kernel run in interpret mode (its default, as
``tests/test_kernels.py`` runs it) and the package's pure-jnp reference.
Every result is an integer or a bit, so all are held bitwise, over the
shapes, masks, ``init`` and T-block boundaries of ``test_kernels.py``.
On the CPU the entry points run the plain versions; the kernels
themselves are held to them on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bits as j_bits
from repro.kernels.bic_encode.kernel import bic_encode_pallas
from repro.kernels.bic_encode.ref import bic_encode_ref as j_bic_encode_ref
from repro.kernels.transitions.kernel import transitions_pallas
from repro.kernels.transitions.ref import transitions_ref as j_transitions_ref
from repro_torch.core import bic, bits
from repro_torch.kernels import bic_encode, count_transitions
from repro_torch.kernels.bic_encode.kernel import bic_encode_cuda
from repro_torch.kernels.transitions.kernel import transitions_cuda

MANT = int(j_bits.MANT_MASK)


def _u16(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 16, size=shape,
                                                dtype=np.uint16)


def _t(x, dtype=torch.int32):
    return torch.from_numpy(x.astype(np.int32)).to(dtype)


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.to(torch.int32).numpy(),
                                  np.asarray(want).astype(np.int32))


# ---------------------------------------------------------------- K5
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (256, 128), (300, 130),
                                   (1000, 17), (33, 257)])
def test_transitions_shapes(shape):
    x = _u16(shape, seed=shape[0] * 7 + shape[1])
    got = count_transitions(_t(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (shape[1],)
    _same(got, transitions_pallas(jnp.asarray(x)))
    _same(got, j_transitions_ref(jnp.asarray(x)))
    # the same words as uint16
    assert torch.equal(count_transitions(_t(x, torch.uint16)), got)


@pytest.mark.parametrize("mask", [0xFFFF, 0x007F, 0x7F80, 0x8000])
def test_transitions_masks(mask):
    x = _u16((129, 64), seed=mask)
    got = count_transitions(_t(x), mask=mask)
    _same(got, transitions_pallas(jnp.asarray(x), mask=mask))
    _same(got, j_transitions_ref(jnp.asarray(x), mask=mask))


@pytest.mark.parametrize("bt,bl", [(64, 128), (256, 128), (128, 256)])
def test_transitions_block_boundaries(bt, bl):
    """Blocks of the TPU kernel cut T and L apart; the port counts across
    every cut the same."""
    x = _u16((500, 200), seed=bt + bl)
    _same(count_transitions(_t(x)),
          transitions_pallas(jnp.asarray(x), block_t=bt, block_l=bl))


def test_transitions_with_init():
    x = _u16((64, 32), seed=1)
    init = _u16((32,), seed=2)
    got = count_transitions(_t(x), init=_t(init))
    _same(got, transitions_pallas(jnp.asarray(x), init=jnp.asarray(init)))
    _same(got, j_transitions_ref(jnp.asarray(x), init=jnp.asarray(init)))
    assert torch.equal(count_transitions(_t(x, torch.uint16),
                                         init=_t(init, torch.uint16)), got)


def test_transitions_bf16_weights():
    w = (np.random.default_rng(3).standard_normal((384, 96)) * 0.03
         ).astype(np.float32)
    words = bits.to_bits(torch.from_numpy(w).to(torch.bfloat16))
    jw = j_bits.to_bits(jnp.asarray(w, jnp.bfloat16))
    _same(words, jw)
    _same(count_transitions(words), transitions_pallas(jw))


def test_transitions_mask_keeps_its_low_16_bits():
    """``mask & 0xFFFF``, as ``jnp.uint16(mask)`` wraps it."""
    x = _t(_u16((50, 9), seed=4))
    assert torch.equal(count_transitions(x, mask=0x3007F),
                       count_transitions(x, mask=0x007F))


# ---------------------------------------------------------------- K6
@pytest.mark.parametrize("shape", [(1, 1), (9, 5), (256, 128), (257, 129),
                                   (1000, 33)])
@pytest.mark.parametrize("mask", [MANT, 0xFFFF])
def test_bic_encode_shapes(shape, mask):
    x = _u16(shape, seed=shape[0] + mask)
    tx, inv = bic_encode(_t(x), mask)
    assert tx.dtype == torch.int32 and inv.dtype == torch.bool
    jt, ji = bic_encode_pallas(jnp.asarray(x), mask)
    _same(tx, jt)
    _same(inv, ji)
    rt, ri = j_bic_encode_ref(jnp.asarray(x), mask)
    _same(tx, rt)
    _same(inv, ri)


@pytest.mark.parametrize("bt", [32, 128, 512])
def test_bic_encode_block_boundary_carry(bt):
    """The TPU kernel carries the invert state across T blocks; the port's
    walk must agree across every such boundary."""
    x = _u16((3 * bt + 7, 8), seed=bt)
    tx, inv = bic_encode(_t(x), MANT)
    jt, ji = bic_encode_pallas(jnp.asarray(x), MANT, block_t=bt)
    _same(tx, jt)
    _same(inv, ji)


def test_bic_encode_real_weight_stream_keeps_uint16():
    w = (np.random.default_rng(5).standard_normal((512, 64)) * 0.02
         ).astype(np.float32)
    words = bits.to_bits(torch.from_numpy(w))
    u = words.to(torch.uint16)
    tx, inv = bic_encode(u)                           # default: MANT_MASK
    assert tx.dtype == torch.uint16
    jt, ji = bic_encode_pallas(j_bits.to_bits(jnp.asarray(w, jnp.bfloat16)),
                               MANT)
    _same(tx, jt)
    _same(inv, ji)


@pytest.mark.parametrize("mask", [MANT, 0xFFFF, 0x7F80])
def test_bic_encode_decodes_back(mask):
    x = _u16((300, 16), seed=mask + 1)
    tx, inv = bic_encode(_t(x), mask)
    dec = bic.bic_decode(tx, inv[:, None, :], (mask,))
    _same(dec, x)
    # and the serial encoder's transitions count the same bus
    prev = torch.cat([torch.zeros_like(tx[:1]), tx[:-1]])
    data = bits.hamming(tx, prev).sum(dim=0, dtype=torch.int32)
    inv_t = (inv ^ torch.cat([torch.zeros_like(inv[:1]), inv[:-1]])
             ).sum(dim=0, dtype=torch.int32)
    assert torch.equal(data + inv_t, bic.bic_transitions(_t(x), (mask,)))


@pytest.mark.parametrize("mask", [0, 0x10000, -1])
@pytest.mark.parametrize("backend", ["ref", "cuda", None])
def test_bic_encode_rejects_bad_masks(mask, backend):
    with pytest.raises(ValueError, match="16-bit word"):
        bic_encode(_t(_u16((4, 2), seed=0)), mask, backend=backend)


# ---------------------------------------------------- wrappers, entries
def test_wrappers_raise_off_the_card_and_never_fall_back():
    x = _t(_u16((8, 4), seed=6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        transitions_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bic_encode_cuda(x, MANT)
    with pytest.raises(ValueError, match="CUDA tensor"):
        count_transitions(x, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        bic_encode(x, backend="cuda")
    assert transitions_cuda.launches == 0 and bic_encode_cuda.launches == 0


def test_entries_reject_words_they_do_not_take():
    x = _t(_u16((8, 4), seed=7))
    with pytest.raises(TypeError, match="uint16 or int32"):
        count_transitions(x.to(torch.float32))
    with pytest.raises(ValueError, match=r"\[T, L\]"):
        count_transitions(x[None])
    with pytest.raises(ValueError, match="init must be"):
        count_transitions(x, init=x[0, :3])
    with pytest.raises(TypeError, match="uint16 or int32"):
        bic_encode(x.to(torch.int64))
    with pytest.raises(ValueError, match=r"\[T, L\]"):
        bic_encode(x[:0])
    with pytest.raises(ValueError, match="unknown counter backend"):
        count_transitions(x, backend="pallas")


def test_kernels_package_exports_the_jax_names():
    import repro.kernels as j_kernels
    import repro_torch.kernels as t_kernels
    public = {n for n in dir(j_kernels) if not n.startswith("_")
              and not isinstance(getattr(j_kernels, n), type(j_kernels))}
    assert public == {"bic_encode", "count_transitions", "zvg_matmul",
                      "edge_counters", "CounterSpec"}
    for n in public:
        assert callable(getattr(t_kernels, n)), n
