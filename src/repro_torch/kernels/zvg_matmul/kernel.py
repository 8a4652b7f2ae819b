"""Wrappers of the Hopper decode-path kernels (``csrc/zvg_matmul.cu``,
``csrc/paged_attention.cu``) and of the tile-gated matmul
(``csrc/zvg_tiled_matmul.cu``).

``gated_row_matmul_cuda`` replaces the TPU kernel
``repro/kernels/zvg_matmul/fused.py::gated_row_matmul``,
``fused_matmul_counters_cuda`` replaces ``fused_matmul_counters`` and
``fused_paged_attention_cuda`` replaces ``fused_paged_attention`` and
``zvg_matmul_cuda`` replaces
``repro/kernels/zvg_matmul/kernel.py::zvg_matmul_pallas``; each source's
header says how, and what bounds each. The libraries are built
with ``nvcc`` at first use and called through ``ctypes`` on PyTorch's
current stream. The wrappers raise on tensors the kernels do not take and
never fall back to the plain versions.

The grids are planned here, in plain Python that the CPU tests reach:
:func:`decode_plan` splits K2's K (and K3's product's) across blocks
where its column tiles are too few to fill the card, :func:`wide_route`
sends K2's bfloat16 calls to its tensor-core route and
:func:`wide_plan` tiles and splits them, K3's counter walk
takes :func:`repro_torch.kernels.power_counters.kernel.chunk_plan`'s
chunks, :func:`paged_plan` splits K4's positions by the table width,
:func:`tiled_plan` picks K7's output tile, k stage and split where its
output tiles number fewer than the SMs, and :func:`tma_operands`
zero-pads K7's bfloat16 operands to row strides the tensor memory
accelerator can describe.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.power_counters.kernel import chunk_plan, spec_args
from repro_torch.kernels.power_counters.spec import CounterSpec

from .ref import (GEMM_DTYPES, check_operands, check_paged_operands,
                  check_tiled_operands)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SPEC = [_I, _P, _I, _P, _I, _I]      # spec_args


@functools.cache
def _functions():
    lib = _build.load("zvg_matmul")
    gemm = lib.zm_gated_row_matmul
    gemm.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P]
    fused = lib.zm_fused_matmul_counters
    fused.argtypes = ([_P, _I, _P, _I, _P, _I, _I, _I, _I,
                       _P, _P, _I, _I] + _SPEC
                      + [_P, _P, _I, _I] + _SPEC + [_I, _I, _I, _P])
    wide = lib.zm_gated_row_matmul_wide
    wide.argtypes = [_P, _P, _P] + [_I] * 8 + [_P]
    for fn in (gemm, fused, wide):
        fn.restype = ctypes.c_int
    return gemm, fused, wide


@functools.cache
def _attention():
    fn = _build.load("paged_attention").pa_paged_decode_attention
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, ctypes.c_float, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tiled():
    fn = _build.load("zvg_tiled_matmul").zt_zvg_tiled_matmul
    fn.argtypes = [_P, _P, _P] + [_I] * 12 + [_P, _P, _I, _P]
    fn.restype = ctypes.c_int
    return fn


#: streaming multiprocessors of an H100 SXM, which the plans fill
SMS = 132


@dataclass(frozen=True)
class DecodePlan:
    """K2's grid: ``tiles`` column tiles of ``cols`` columns (32 lanes of
    one 16-byte weight load each), each taken by a cluster of ``splits``
    blocks walking ``k_per_split`` k rows apiece (split ``s`` from row
    ``s * k_per_split``); ``reason`` says why the grid holds fewer blocks
    than the card has SMs, where it does."""
    cols: int
    tiles: int
    k_per_split: int
    splits: int
    blocks: int
    reason: str | None


#: K2's plan: blocks wanted (one an SM), the fewest k rows a split walks
#: (8 a warp), the most splits (a cluster's blocks) and the most k rows a
#: block stages x for at once
DECODE_BLOCKS = SMS
DECODE_MIN_K = 64
DECODE_MAX_SPLITS = 16
DECODE_MAX_K = 2048


@functools.lru_cache(maxsize=None)
def decode_plan(K: int, N: int, w_itemsize: int) -> DecodePlan:
    """Split K2's K across a cluster of blocks where its ``ceil(N / cols)``
    column tiles number fewer than :data:`DECODE_BLOCKS`: as many splits
    as fill that, up to :data:`DECODE_MAX_SPLITS`, each a multiple of 8
    rows, at least :data:`DECODE_MIN_K` and, where the splits allow, at
    most :data:`DECODE_MAX_K` long. Any K plans: a split longer than that
    (K above ``DECODE_MAX_SPLITS * DECODE_MAX_K``) stages x in pieces of
    :data:`DECODE_MAX_K` inside its block."""
    cols = 32 * (16 // w_itemsize)
    tiles = -(-N // cols)
    want = 1 if tiles >= DECODE_BLOCKS else -(-DECODE_BLOCKS // tiles)
    splits = min(want, max(1, K // DECODE_MIN_K), DECODE_MAX_SPLITS)
    splits = min(max(splits, -(-K // DECODE_MAX_K)), DECODE_MAX_SPLITS)
    kps = -(-(-(-K // splits)) // 8) * 8
    splits = -(-K // kps)
    if splits == 1:
        kps = K
    blocks = tiles * splits
    reason = None
    if blocks < SMS:
        reason = (f"{tiles} column tiles of {cols}, and K = {K} gives at "
                  f"most {splits} splits (a cluster holds "
                  f"{DECODE_MAX_SPLITS}, each of {DECODE_MIN_K} rows or "
                  f"more)")
    return DecodePlan(cols, tiles, kps, splits, blocks, reason)


@dataclass(frozen=True)
class WidePlan:
    """K2's wide route (bfloat16 on the tensor cores): output tiles of
    ``tile_m`` x ``tile_n``, ``tiles`` of them, and K in stages of
    :data:`WIDE_STAGE` cut into ``splits`` runs of ``k_per_split`` (split
    ``s`` from ``s * k_per_split``), a cluster a tile. Unsplit, ``workers``
    blocks walk the tiles (each tile ``t`` to block ``t % workers``);
    split, one block a tile and split. ``reason`` says why the grid holds
    fewer blocks than the card has SMs, where it does."""
    tile_m: int
    tile_n: int
    tiles: int
    k_per_split: int
    splits: int
    workers: int
    blocks: int
    reason: str | None


#: K2's wide route: the fewest rows that take it (the crossover with the
#: stream route, measured on an H100 over MiniCPM3-4B's decode products
#: at 1 to 128 rows: the wide route took less device time at every one;
#: PERF.md's K2 row), the k of a shared-memory stage and the most splits
#: (a cluster's blocks)
WIDE_MIN_ROWS = 1
WIDE_STAGE = 64
WIDE_MAX_SPLITS = 16


def wide_route(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether K2 runs ``x [M, K] @ w [K, N]`` on its wide route: both
    bfloat16, at least :data:`WIDE_MIN_ROWS` rows, and rows the tensor
    memory accelerator can describe (K and N multiples of 8, both bases
    16-byte aligned). Every other call takes ``stream_kernel``'s route."""
    return (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and x.shape[0] >= WIDE_MIN_ROWS and x.shape[1] % 8 == 0
            and w.shape[1] % 8 == 0 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def wide_plan(M: int, K: int, N: int) -> WidePlan:
    """The wide route's grid: 64-row tiles up to 64 rows, else 128 (one or
    two consumer warpgroups); 128-column tiles where they number at least
    an eighth of the :data:`SMS` (so that 8 splits or fewer fill the card,
    and half as many blocks read x again), else 64. Where the output tiles
    number fewer than the SMs, K splits into the largest power of two of
    runs (at most :data:`WIDE_MAX_SPLITS`, a cluster) that keeps every
    block on an SM of its own, rounded to whole stages: a second wave would
    double the time, and clusters of 3 or 6 blocks packed onto an H100's
    SMs in two waves where 2, 4 or 8 did not (PERF.md's K2 row). Where the
    tiles number more than the SMs, one block an SM walks them."""
    tile_m = 64 if M <= 64 else 128
    m_tiles = -(-M // tile_m)
    tile_n = 128 if m_tiles * -(-N // 128) * 8 >= SMS else 64
    tiles = m_tiles * -(-N // tile_n)
    stages = -(-K // WIDE_STAGE)
    splits = 1
    while (2 * splits <= min(WIDE_MAX_SPLITS, stages)
           and 2 * splits * tiles <= SMS):
        splits *= 2
    per = -(-stages // splits)
    splits = -(-stages // per)
    workers = min(tiles, SMS) if splits == 1 else tiles
    blocks = workers * splits
    reason = None
    if blocks < SMS:
        reason = (f"{tiles} output tiles of {tile_m} x {tile_n}, and K = {K} "
                  f"holds {stages} stages of {WIDE_STAGE}: {splits} splits "
                  f"of {per} (a power of two at most {WIDE_MAX_SPLITS}, a "
                  f"cluster; twice as many would pass the {SMS} SMs)")
    return WidePlan(tile_m, tile_n, tiles, per * WIDE_STAGE, splits, workers,
                    blocks, reason)


@dataclass(frozen=True)
class PagedPlan:
    """K4's grid: a table of ``MP * PS`` positions cut into ``chunks``
    chunks of ``positions`` (chunk ``c`` from position ``c *
    positions``), taken by a cluster of ``cluster`` blocks per (row, KV
    head), block ``q`` walking chunks ``q, q + cluster, ...``;
    ``blocks`` in all for ``B`` rows of ``KV`` heads."""
    positions: int
    chunks: int
    cluster: int
    blocks: int


#: K4's plan: the most positions a chunk (a block's shared-memory stage)
#: and the most blocks of a cluster (the portable 8)
PAGED_CHUNK = 64
PAGED_MAX_CLUSTER = 8


@functools.lru_cache(maxsize=None)
def paged_plan(MP: int, PS: int, B: int, KV: int) -> PagedPlan:
    """Split K4's positions across blocks by the table width ``MP * PS``
    (known on the host; the lengths live on the card and are never read
    here): chunks of whole pages, as many as fit :data:`PAGED_CHUNK`
    positions (a chunk of :data:`PAGED_CHUNK` positions of one page where
    a page is longer), and one block a chunk up to a cluster of
    :data:`PAGED_MAX_CLUSTER`, each block walking every ``cluster``-th
    chunk beyond that."""
    S = PS * max(1, PAGED_CHUNK // PS) if PS <= PAGED_CHUNK else PAGED_CHUNK
    chunks = -(-(MP * PS) // S)
    cluster = min(chunks, PAGED_MAX_CLUSTER)
    return PagedPlan(S, chunks, cluster, B * KV * cluster)


@dataclass(frozen=True)
class TiledPlan:
    """K7's grid (bfloat16 route): output tiles of ``tile_m`` x
    ``tile_n``, k stages of ``k_stage``, and K cut into ``splits`` runs
    of ``k_per_split`` (split ``s`` from ``s * k_per_split``), which is
    ``tiles_per_split`` whole ``bk`` tiles where ``bk`` is a multiple of
    the stage; ``reason`` says why the grid holds fewer blocks than the
    card has SMs, where it does."""
    tile_m: int
    tile_n: int
    k_stage: int
    tiles_per_split: int
    k_per_split: int
    splits: int
    blocks: int
    reason: str | None


#: K7's most splits of K: the blocks of a cluster
TILED_MAX_SPLITS = 16


@functools.lru_cache(maxsize=None)
def tiled_plan(M: int, K: int, N: int, bm: int, bk: int) -> TiledPlan:
    """K7's tiles and split: 128 x 128 output tiles where they are enough
    to give every one of the :data:`SMS` a block (128 rows only where
    ``bm`` allows), else 64 rows or columns, which make more tiles. The
    k stage is the largest of 64, 32 and 16 that divides ``bk`` (64 where
    none does), so that on blocks that are multiples of the tiles a
    skipped stage lies in one gated tile; other blocks skip a stage only
    where every tile it touches is gated. Where the output tiles number
    fewer than the SMs, K splits into runs of whole ``bk`` tiles (rounded
    up to whole stages), enough runs to give every SM a block where K
    holds enough tiles, and at most :data:`TILED_MAX_SPLITS` (the blocks
    of a cluster, which sum the splits)."""
    tile_m = 128 if bm % 128 == 0 and -(-M // 128) * -(-N // 128) >= SMS \
        else 64
    tile_n = 128 if N > 64 and -(-M // tile_m) * -(-N // 128) >= SMS \
        else 64
    k_stage = next((ks for ks in (64, 32, 16) if bk % ks == 0), 64)
    out_tiles = -(-M // tile_m) * -(-N // tile_n)
    kb = -(-K // bk)
    tps = kb
    if out_tiles < SMS:
        tps = max(1, kb // -(-SMS // out_tiles), -(-kb // TILED_MAX_SPLITS))
    kps = -(-(tps * bk) // k_stage) * k_stage
    splits = -(-K // kps)
    blocks = out_tiles * splits
    reason = None
    if blocks < SMS:
        reason = (f"{out_tiles} output tiles of {tile_m} x {tile_n}, and K "
                  f"= {K} holds {kb} tiles of {bk}, split at most "
                  f"{TILED_MAX_SPLITS} ways (a cluster)")
    return TiledPlan(tile_m, tile_n, k_stage, tps, kps, splits, blocks,
                     reason)


def tma_operands(a: torch.Tensor, b: torch.Tensor):
    """``a [M, K]`` and ``b [K, N]`` as the tensor memory accelerator can
    read them: row strides a multiple of 16 bytes and 16-byte aligned
    bases. Where K or N is not a multiple of 8 (bfloat16), a copy is
    zero-padded up to one; zeros change neither the product nor the
    gated map. Returns ``(a_padded [M, Kp], b_padded [Kp, Np])``, the
    operands themselves where they already are."""
    (M, K), N = a.shape, b.shape[1]
    kp, np_ = -(-K // 8) * 8, -(-N // 8) * 8
    if kp != K:
        a = F.pad(a, (0, kp - K))
    elif a.data_ptr() % 16:
        a = a.clone()
    if kp != K or np_ != N:
        b = F.pad(b, (0, np_ - N, 0, kp - K))
    elif b.data_ptr() % 16:
        b = b.clone()
    return a, b


#: what the C entries return for arguments their kernels do not take
_CUDA_ERROR_INVALID_VALUE = 1


def _check_on_card(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got one on "
                             f"{t.device}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: operands on {tensors[0].device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def gated_row_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ZVG-gated ``x [M, K] @ w [K, N]`` on the card (float32, bfloat16
    or int8 operands, any K); matches :func:`.ref.gated_row_matmul_ref`:
    gated rows bit for bit, live rows up to the order of the float32 sums
    (int8 with int8 exactly). One launch a call: bfloat16 pairs that
    :func:`wide_route` takes run on the tensor cores (:func:`wide_plan`),
    the rest on ``stream_kernel``'s SIMT route (:func:`decode_plan`)."""
    out_dtype = check_operands(x, w, GEMM_DTYPES)
    _check_on_card("gated_row_matmul_cuda", x, w)
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    gemm, _, wide = _functions()
    route = wide_route(x, w)
    if route:   # the entry makes x's device current where it is not
        plan = wide_plan(M, K, N)
        err = wide(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
                   plan.tile_m, plan.tile_n, plan.k_per_split, plan.workers,
                   x.device.index, _stream(x.device))
    else:
        plan = decode_plan(K, N, w.element_size())
        with torch.cuda.device(x.device):
            err = gemm(x.data_ptr(), _DTYPE_CODE[x.dtype], w.data_ptr(),
                       _DTYPE_CODE[w.dtype], out.data_ptr(),
                       _DTYPE_CODE[out_dtype], M, K, N, plan.k_per_split,
                       _stream(x.device))
    if err:
        raise RuntimeError(f"gated_row_matmul kernel launch failed: CUDA "
                           f"error {err}")
    gated_row_matmul_cuda.launches += 1
    gated_row_matmul_cuda.wide_launches += route
    return out


def fused_matmul_counters_cuda(a: torch.Tensor, w: torch.Tensor,
                               west_spec: CounterSpec,
                               north_spec: CounterSpec, lanes_w: int,
                               cols: int):
    """K2's product of ``a [B, K]`` and ``w [K, N]`` (on
    :func:`decode_plan`'s split) and the counters of the decode streams
    (walked in :func:`chunk_plan`'s chunks), one call launching both;
    outputs as :func:`.ref.fused_matmul_counters_ref`, the counters bit
    for bit. The launch counter counts the call once."""
    out_dtype = check_operands(a, w)
    _check_on_card("fused_matmul_counters_cuda", a, w)
    (B, K), N = a.shape, w.shape[1]
    if min(B, K, N, lanes_w, cols) < 1 or B > 65535:
        raise ValueError(f"unsupported decode shapes {tuple(a.shape)} x "
                         f"{tuple(w.shape)}, lanes {lanes_w}, cols {cols}")
    lanes_n = -(-N // cols) * cols
    dev = a.device
    product = torch.empty((B, N), dtype=out_dtype, device=dev)
    wc = torch.empty((B, west_spec.n_rows, lanes_w), dtype=torch.int32,
                     device=dev)
    nc = torch.empty((north_spec.n_rows, lanes_n), dtype=torch.int32,
                     device=dev)
    # both rowzeros, which the walk sums into, zeroed by one fill
    zeros = torch.zeros(((B + 1) * K,), dtype=torch.int32, device=dev)
    wz, nz = zeros[:B * K].view(B, K), zeros[B * K:]
    split = decode_plan(K, N, w.element_size())
    walk = chunk_plan(K)
    _, fused, _ = _functions()
    with torch.cuda.device(dev):
        err = fused(a.data_ptr(), _DTYPE_CODE[a.dtype], w.data_ptr(),
                    _DTYPE_CODE[w.dtype], product.data_ptr(),
                    _DTYPE_CODE[out_dtype], B, K, N,
                    wc.data_ptr(), wz.data_ptr(), west_spec.n_rows, lanes_w,
                    *spec_args(west_spec),
                    nc.data_ptr(), nz.data_ptr(), north_spec.n_rows, lanes_n,
                    *spec_args(north_spec), split.k_per_split,
                    walk.chunk, walk.cluster, _stream(dev))
    if err:
        raise RuntimeError(f"fused_matmul_counters kernel launch failed: "
                           f"CUDA error {err}")
    fused_matmul_counters_cuda.launches += 1
    return product, wc, wz, nc, nz


def fused_paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, pages: torch.Tensor,
                               lengths: torch.Tensor, *, scale=None,
                               softcap: float = 0.0) -> torch.Tensor:
    """Decode attention of ``q [B, 1, h, hd]`` through the page tables
    ``pages [B, MP]`` into the pools ``[P, ps, kv, hd]``, up to
    ``lengths [B]`` positions a row, on the card, split across blocks by
    :func:`paged_plan` (no host read of ``lengths``); matches
    :func:`.ref.fused_paged_attention_ref` within
    :data:`.cases.ATTN_TOL` (float32 softmax and P.V throughout)."""
    check_paged_operands(q, k_pool, v_pool, pages, lengths)
    pages = pages.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    _check_on_card("fused_paged_attention_cuda", q, k_pool, v_pool, pages,
                   lengths)
    B, _, H, HD = q.shape
    _, PS, KV, _ = k_pool.shape
    if (H // KV > 8 or HD % 8 or not 8 <= HD <= 128 or B > 65535
            or any(t.data_ptr() % 16 for t in (q, k_pool, v_pool))):
        raise ValueError(f"unsupported paged attention shapes: q "
                         f"{tuple(q.shape)}, pools {tuple(k_pool.shape)} "
                         f"(hd a multiple of 8 up to 128, h / kv up to 8, "
                         f"16-byte aligned)")
    out = torch.empty_like(q)
    scale = HD ** -0.5 if scale is None else scale
    MP = pages.shape[1]
    plan = paged_plan(MP, PS, B, KV)
    with torch.cuda.device(q.device):
        err = _attention()(q.data_ptr(), k_pool.data_ptr(),
                           v_pool.data_ptr(), out.data_ptr(),
                           _DTYPE_CODE[q.dtype], pages.data_ptr(),
                           lengths.data_ptr(), B, H, KV, HD, PS, MP,
                           plan.positions, plan.chunks, plan.cluster,
                           float(scale), float(softcap), _stream(q.device))
    if err:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    fused_paged_attention_cuda.launches += 1
    return out


def zvg_matmul_cuda(a: torch.Tensor, b: torch.Tensor, block_m: int = 128,
                    block_n: int = 128, block_k: int = 128):
    """Zero-gated ``a [M, K] @ b [K, N]`` on the card (both float32 or
    both bfloat16): ``(out float32[M, N], gated int32[ceil(M / block_m),
    ceil(K / block_k)])``, skipping every gated tile. The map equals
    :func:`.ref.zvg_matmul_ref`'s bit for bit, the product lies within
    :data:`.cases.TILED_TOL` of its. ``block_n`` is accepted only for the
    JAX package's signature: the kernel tiles N its own way
    (:func:`tiled_plan`), which changes no result. bfloat16 operands run
    on ``wgmma`` from TMA-fed tiles (padded by :func:`tma_operands` where
    needed), float32 ones on the SIMT route. Raises on operands or blocks
    the kernel does not take; any ``block_m`` and ``block_k`` of 1 or
    more are taken, as the JAX package takes them."""
    check_tiled_operands(a, b, block_m, block_k)
    _check_on_card("zvg_matmul_cuda", a, b)
    (M, K), N = a.shape, b.shape[1]
    dev = a.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    gated = torch.empty((-(-M // block_m), -(-K // block_k)),
                        dtype=torch.int32, device=dev)
    ap, bp, tile_m, tile_n, ks, kps = a, b, 64, 64, 64, K
    if a.dtype == torch.bfloat16:
        plan = tiled_plan(M, K, N, block_m, block_k)
        ap, bp = tma_operands(a, b)
        tile_m, tile_n = plan.tile_m, plan.tile_n
        ks, kps = plan.k_stage, plan.k_per_split
    err = _tiled()(a.data_ptr(), ap.data_ptr(), bp.data_ptr(),
                   _DTYPE_CODE[a.dtype], M, K, ap.shape[1], N, bp.shape[1],
                   block_m, block_k, tile_m, tile_n, ks, kps, out.data_ptr(),
                   gated.data_ptr(), dev.index, _stream(dev))
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"zvg_matmul_cuda does not take blocks ({block_m}, "
                         f"{block_k}) for a {M}x{K}x{N} product (more than "
                         f"65535 row blocks)")
    if err:
        raise RuntimeError(f"zvg tiled matmul kernel launch failed: CUDA "
                           f"error {err}")
    zvg_matmul_cuda.launches += 1
    return out, gated


#: kernel launches so far; set them to 0 before a run to count that run's
#: (K2's ``launches`` counts every call, ``wide_launches`` those that took
#: the wide route)
gated_row_matmul_cuda.launches = 0
gated_row_matmul_cuda.wide_launches = 0
fused_matmul_counters_cuda.launches = 0
fused_paged_attention_cuda.launches = 0
zvg_matmul_cuda.launches = 0
