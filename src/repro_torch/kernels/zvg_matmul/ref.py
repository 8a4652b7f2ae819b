"""Plain PyTorch versions of the decode-path kernels and of the
tile-gated matmul.

:func:`gated_row_matmul_ref` is ``torch.matmul`` with the row gate;
:func:`fused_matmul_counters_ref` is that product plus the plain counter
pass (:func:`repro_torch.kernels.power_counters.ref.fused_counters_ref`)
over the same west and north word streams the kernel walks;
:func:`fused_paged_attention_ref` gathers a dense view of each row's
pages and runs the caller's dense decode attention on it. The CPU runs
them;
:func:`zvg_matmul_ref` is the float32 product plus the gated-tile map
from tile maxima. The CPU runs them, the ``"ref"`` backend runs them on
any device, and the card-side checks hold the kernels against them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bits import to_bits
from repro_torch.kernels.power_counters.ref import fused_counters_ref
from repro_torch.kernels.power_counters.spec import CounterSpec

#: operand dtypes the fused decode kernel (K3) and the tile-gated matmul
#: take
DTYPES = (torch.float32, torch.bfloat16)
#: operand dtypes the gated row matmul (K2) takes, in any pair
GEMM_DTYPES = DTYPES + (torch.int8,)

_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.int8: torch.int8}


def check_operands(x: torch.Tensor, w: torch.Tensor,
                   dtypes=DTYPES) -> torch.dtype:
    """Raise on operands the decode kernels do not take (dtypes outside
    ``dtypes``); returns the product's dtype, ``jnp.result_type``'s:
    int8 with int8 gives int8, int8 with a float that float, bfloat16
    with float32 float32."""
    if x.dtype not in dtypes or w.dtype not in dtypes:
        extra = ", or int8" if torch.int8 in dtypes else ""
        raise TypeError(f"operands must be float32 or bfloat16{extra}, got "
                        f"{x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"operands must be [M, K] x [K, N], got "
                         f"{tuple(x.shape)} x {tuple(w.shape)}")
    return torch.promote_types(x.dtype, w.dtype)


def row_is_live(x: torch.Tensor) -> torch.Tensor:
    """``[M]`` bool: the row holds a word whose bits are not all zero, so
    -0.0 and subnormal rows are live and only all-+0.0 rows are gated (for
    int8 rows the same as the value test)."""
    return (x.view(_INT_VIEW[x.dtype]) != 0).any(dim=-1)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of int8 operands in int8, as XLA computes it: the sums
    exact in int32 (wrapping as the kernel's do) and the result wrapped
    to int8, i.e. mod 256. Broadcast products summed over pieces of K,
    since ``torch.matmul`` takes no int8 on the card."""
    (M, K), N = x.shape, w.shape[1]
    acc = torch.zeros((M, N), dtype=torch.int32, device=x.device)
    step = max(1, (1 << 22) // max(1, M * N))
    for k0 in range(0, K, step):
        xs = x[:, k0:k0 + step].to(torch.int32)
        ws = w[k0:k0 + step].to(torch.int32)
        acc += (xs[:, :, None] * ws[None]).sum(1, dtype=torch.int32)
    return acc.to(torch.int8)


def gated_row_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ZVG-gated ``x [M, K] @ w [K, N]``: a live row is ``torch.matmul``'s
    (:func:`int8_matmul`'s for two int8 operands), a gated row is zero,
    which is also that row's ungated product for finite weights."""
    out_dtype = check_operands(x, w, GEMM_DTYPES)
    if out_dtype == torch.int8:
        out = int8_matmul(x, w)
    else:
        out = torch.matmul(x.to(out_dtype), w.to(out_dtype))
    return torch.where(row_is_live(x)[:, None], out, out.new_zeros(()))


def pad_lanes(words: torch.Tensor, lanes: int) -> torch.Tensor:
    """``[T, L]`` words widened to ``lanes`` lanes with zero words."""
    extra = lanes - words.shape[-1]
    if extra <= 0:
        return words
    return torch.cat([words, words.new_zeros(words.shape[:-1] + (extra,))],
                     dim=-1)


def fused_matmul_counters_ref(a: torch.Tensor, w: torch.Tensor,
                              west_spec: CounterSpec,
                              north_spec: CounterSpec, lanes_w: int,
                              cols: int):
    """Gated product of ``a [B, K]`` and ``w [K, N]`` plus the decode
    streams' counters: per row ``b``, the west stream ``[K, lanes_w]``
    with the row's bfloat16 words in lane 0 and zero words elsewhere;
    once, the north stream of ``w``'s words padded with zero-word lanes to
    a multiple of ``cols``. Returns ``(product [B, N], west_counts
    int32[B, n_rows_w, lanes_w], west_rowzeros int32[B, K], north_counts
    int32[n_rows_n, Np], north_rowzeros int32[K])``. Float operands
    only."""
    check_operands(a, w)
    product = gated_row_matmul_ref(a, w)
    B, K = a.shape
    lanes_n = -(-w.shape[1] // cols) * cols
    x_w = torch.zeros((B, K, lanes_w), dtype=torch.int32, device=a.device)
    x_w[:, :, 0] = to_bits(a)
    wc, wz = fused_counters_ref(x_w, west_spec)
    nc, nz = fused_counters_ref(pad_lanes(to_bits(w), lanes_n), north_spec)
    return product, wc, wz, nc, nz


#: pool and query dtypes the paged attention kernel takes
ATTN_DTYPES = (torch.float32, torch.bfloat16)


def check_paged_operands(q, k_pool, v_pool, pages, lengths) -> None:
    """Raise on operands the paged decode attention does not take: ``q
    [B, 1, h, hd]``, pools ``[P, ps, kv, hd]`` of q's dtype with ``kv``
    dividing ``h``, ``pages [B, MP]`` and ``lengths [B]`` of integers."""
    if q.dtype not in ATTN_DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and the pools must share a dtype of "
                        f"{ATTN_DTYPES}, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if (q.dim() != 4 or q.shape[1] != 1 or k_pool.dim() != 4
            or v_pool.shape != k_pool.shape
            or k_pool.shape[3] != q.shape[3]
            or q.shape[2] % k_pool.shape[2]):
        raise ValueError(f"expected q [B, 1, h, hd] and pools [P, ps, kv, "
                         f"hd] with kv dividing h, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if (pages.dim() != 2 or pages.shape[0] != q.shape[0]
            or lengths.shape != (q.shape[0],)
            or pages.dtype.is_floating_point
            or lengths.dtype.is_floating_point):
        raise ValueError(f"expected integer pages [B, MP] and lengths [B] "
                         f"for B = {q.shape[0]}, got {tuple(pages.shape)} "
                         f"{pages.dtype}, {tuple(lengths.shape)} "
                         f"{lengths.dtype}")


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Dense per-row logical view of a page pool: ``pool [P, ps, ...]``
    and page tables ``pages [B, MP]`` give ``[B, MP * ps, ...]``. Table
    entries not yet allocated point at the trash page 0; what they hold
    sits at positions past the row's writes, which every caller masks."""
    b, mp = pages.shape
    view = pool[pages]                                  # [B, MP, ps, ...]
    return view.reshape((b, mp * pool.shape[1]) + pool.shape[2:])


def fused_paged_attention_ref(q, k_pool, v_pool, pages, lengths, attend, *,
                              scale=None, softcap: float = 0.0):
    """Decode attention through page tables: ``q [B, 1, h, hd]`` against
    the pools ``[P, ps, kv, hd]``, row ``b`` over the pages ``pages[b]``
    up to ``lengths[b]`` positions. The gather, then ``attend(q, k_cache,
    v_cache, lengths, scale=, softcap=)``, the model's dense decode
    attention (:func:`repro_torch.models.attention.decode_attention`:
    float32 scores, probabilities cast to q's dtype before they meet V),
    which the kernel computes in one pass."""
    check_paged_operands(q, k_pool, v_pool, pages, lengths)
    return attend(q, gather_pages(k_pool, pages), gather_pages(v_pool, pages),
                  lengths, scale=scale, softcap=softcap)


def check_tiled_operands(a: torch.Tensor, b: torch.Tensor, block_m: int,
                         block_k: int) -> None:
    """Raise on operands the tile-gated matmul does not take: ``a [M, K]``
    and ``b [K, N]`` of one dtype of :data:`DTYPES`, M, K, N >= 1, and
    positive block sizes."""
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"operands must share a dtype of {DTYPES}, got "
                        f"{a.dtype} and {b.dtype}")
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or min(a.shape + b.shape) < 1):
        raise ValueError(f"operands must be [M, K] x [K, N] with M, K, N "
                         f">= 1, got {tuple(a.shape)} x {tuple(b.shape)}")
    if min(block_m, block_k) < 1:
        raise ValueError(f"block sizes must be positive, got {block_m}, "
                         f"{block_k}")


def zvg_matmul_ref(a: torch.Tensor, b: torch.Tensor, block_m: int = 128,
                   block_k: int = 128):
    """Zero-gated tiled matmul, plainly: ``(a @ b as float32 [M, N],
    gated int32[ceil(M / block_m), ceil(K / block_k)])``, the map 1 where
    the ``[block_m, block_k]`` tile of ``a`` (zero-padded) holds only
    zeros. The map tests values from tile maxima, as the JAX package's
    ``abs(tile).max() == 0``: -0.0 is zero and a NaN makes its tile live.
    Zero tiles add exact zeros, so the product is the dense float32
    product; on the card it is full float32 as long as the caller lets no
    TF32 into ``torch.matmul`` (``torch.backends.cuda.matmul.allow_tf32``
    False, ``torch.get_float32_matmul_precision()`` "highest", the
    defaults)."""
    check_tiled_operands(a, b, block_m, block_k)
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    M, K = a.shape
    am = F.pad(a.abs().to(torch.float32),
               (0, (-K) % block_k, 0, (-M) % block_m))
    Mb, Kb = am.shape[0] // block_m, am.shape[1] // block_k
    tile_max = am.reshape(Mb, block_m, Kb, block_k).amax(dim=(1, 3))
    return out, (tile_max == 0).to(torch.int32)
