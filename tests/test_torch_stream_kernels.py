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
from repro_torch.kernels.bic_encode.kernel import bic_encode_cuda, bic_plan
from repro_torch.kernels.power_counters.cases import (PLAN_EDGES,
                                                     chunk_coverage)
from repro_torch.kernels.transitions.cases import (TRANSITION_PLAN_EDGES,
                                                   TRANSITION_SHAPES,
                                                   transition_coverage)
from repro_torch.kernels.transitions.kernel import (split_transitions,
                                                    transitions_cuda,
                                                    transitions_plan)

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


#: K6's main-path shapes ``(T, L)``: ResNet50's weight streams (stem
#: 147 x 64, s1 3x3 576 x 64, s3 1x1 1024 x 256, s4 3x3 4608 x 512, the
#: fc 2048 x 1000), the quickstart's 512 x 128, and edges
BIC_PLAN_SHAPES = [(147, 64), (576, 64), (1024, 256), (4608, 512),
                   (2048, 1000), (512, 128), (1, 1), (33, 33), (4609, 20)]


@pytest.mark.parametrize("T,L", BIC_PLAN_SHAPES, ids=str)
def test_bic_plan_covers_every_cycle_of_every_lane_once(T, L):
    """K6's grid: every cycle of every lane lies in exactly one chunk, the
    clusters stay within 16 and the grid within CUDA's x dimension."""
    plan = bic_plan(T, L)
    assert plan.split in (1, 2, 4, 8) and 1 <= plan.cluster <= 16
    assert plan.chunks * plan.chunk >= T
    assert 1 <= plan.blocks <= 2 ** 31 - 1
    assert (chunk_coverage(plan, 1, T, L) == 1).all()


def test_bic_plan_at_the_weight_streams():
    """The plan pinned at ResNet50's largest weight stream (128 chunks of
    36 in clusters of 16), its stem's (32 chunks of 5, clusters of 4) and
    the quickstart's (128 chunks of 4)."""
    want = {(4608, 512): ("cluster", 36, 8, 16, 256),
            (147, 64): ("cluster", 5, 8, 4, 8),
            (512, 128): ("cluster", 4, 8, 16, 64)}
    for (T, L), (route, chunk, split, cluster, blocks) in want.items():
        p = bic_plan(T, L)
        assert (p.route, p.chunk, p.split, p.cluster, p.blocks) == (
            route, chunk, split, cluster, blocks), (T, L)
    assert bic_plan(7, 5000).route == "one pass"
    with pytest.raises(ValueError, match="T, L >= 1"):
        bic_plan(0, 3)


#: K5's main-path shapes ``(T, L)``: ResNet50's stem, stage-1 3x3,
#: largest and fc weight streams (uint16), and the quickstart's words
K5_PLAN_SHAPES = [(147, 64), (576, 64), (4608, 512), (2048, 1000)]


@pytest.mark.parametrize("word_bytes", [2, 4])
@pytest.mark.parametrize(
    "T,L", sorted({*K5_PLAN_SHAPES, (512, 128), *TRANSITION_SHAPES,
                   *TRANSITION_PLAN_EDGES}), ids=str)
def test_transitions_plan_covers_every_cycle_of_every_lane_once(T, L,
                                                                word_bytes):
    """K5's grid: every cycle of every lane is counted by exactly one
    thread, the cluster stays within the portable 8 blocks, a thread's
    chunk within the C entry's int range, and a tile within the block's
    64 lanes."""
    for aligned in (True, False):
        plan = transitions_plan(T, L, word_bytes, aligned)
        assert 1 <= plan.cluster <= 8 and plan.cycles >= 1
        assert plan.lanes <= 64 and 256 % plan.tx == 0
        assert plan.cluster * plan.rows * plan.cycles < 2 ** 31
        assert (transition_coverage(plan, T, L) == 1).all()


@pytest.mark.parametrize("word_bytes", [2, 4])
def test_transitions_vector_route_only_where_16_bytes_align(word_bytes):
    """The 16-byte route needs L a multiple of the vector (8 uint16 or 4
    int32 words) and an aligned base; anything else takes the scalar
    route, chosen by shape and address, not after a failure."""
    vec = 16 // word_bytes
    for L in range(1, 70):
        plan = transitions_plan(100, L, word_bytes)
        assert plan.route == ("vector" if L % vec == 0 else "scalar")
        assert plan.vec == (vec if L % vec == 0 else 1)
        assert transitions_plan(100, L, word_bytes, False).route == "scalar"
    for T, L in K5_PLAN_SHAPES:     # every ResNet50 weight stream aligns
        assert transitions_plan(T, L, 2).route == "vector"


def test_transitions_plan_at_the_main_path_shapes():
    """The plan pinned where the main paths run K5: one batch of loads a
    thread everywhere, a cluster only where no tile width covers T in one
    block (the largest stream, 4608 x 512: tiles of 16 lanes, 128 rows a
    block, clusters of 5), the widest tile that does otherwise (the stem's
    64 lanes, the fc's 8)."""
    want = {(147, 64, 2): ("vector", 8, 5, 1, 1),
            (576, 64, 2): ("vector", 2, 5, 1, 4),
            (4608, 512, 2): ("vector", 2, 8, 5, 32),
            (2048, 1000, 2): ("vector", 1, 8, 1, 125),
            (512, 128, 4): ("vector", 4, 8, 1, 8),
            (1, 1, 4): ("scalar", 1, 1, 1, 1),
            (33, 257, 2): ("scalar", 32, 5, 1, 9)}
    for (T, L, wb), (route, tx, cycles, cluster, tiles) in want.items():
        p = transitions_plan(T, L, wb)
        assert (p.route, p.tx, p.cycles, p.cluster, p.tiles) == (
            route, tx, cycles, cluster, tiles), (T, L, wb)
        assert p.batches == 1
    with pytest.raises(ValueError, match="T, L >= 1"):
        transitions_plan(0, 3, 2)
    with pytest.raises(ValueError, match="2 or 4 bytes"):
        transitions_plan(3, 3, 8)


def test_transitions_plan_lengthens_chunks_not_the_cluster():
    """Past what a cluster of 8 covers in one batch, the chunks grow: the
    stream of 65535 * 64 + 1 cycles (beyond the most chunks the earlier
    kernel's grid took) is 8 blocks of 256 rows, 2048 cycles a thread;
    forced clusters keep their size, up to 16, and forced widths must be
    the route's."""
    T = 65535 * 64 + 1
    p = transitions_plan(T, 1, 4)
    assert (p.cluster, p.rows, p.cycles) == (8, 256, 2048)
    assert p.cluster * p.rows * p.cycles >= T
    for cl in (1, 2, 3, 16):
        assert split_transitions(1000, 72, 2, cl).cluster == cl
    with pytest.raises(ValueError, match="1 to 16 blocks"):
        split_transitions(1000, 72, 2, 17)
    assert split_transitions(1000, 72, 2, 1, tx=1).tiles == 9
    with pytest.raises(ValueError, match="lane vectors"):
        split_transitions(1000, 70, 2, 1, tx=4)


@pytest.mark.parametrize("T", PLAN_EDGES)
def test_bic_encode_plain_matches_jax_at_the_plan_edges(T):
    """The plain encoder, which the card kernel is held to, against the
    JAX reference (and the Pallas kernel in interpret mode up to 65
    cycles) at the stream lengths on either side of the plan's chunks."""
    x = _u16((T, 33), seed=T + 11)
    tx, inv = bic_encode(_t(x), MANT)
    rt, ri = j_bic_encode_ref(jnp.asarray(x), MANT)
    _same(tx, rt)
    _same(inv, ri)
    if T <= 65:
        jt, ji = bic_encode_pallas(jnp.asarray(x), MANT, block_t=32)
        _same(tx, jt)
        _same(inv, ji)


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
