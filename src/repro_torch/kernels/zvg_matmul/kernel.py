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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.power_counters.kernel import spec_args
from repro_torch.kernels.power_counters.spec import CounterSpec

from .ref import check_operands, check_paged_operands, check_tiled_operands

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SPEC = [_I, _P, _I, _P, _I, _I]      # spec_args


@functools.cache
def _functions():
    lib = _build.load("zvg_matmul")
    gemm = lib.zm_gated_row_matmul
    gemm.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P]
    fused = lib.zm_fused_matmul_counters
    fused.argtypes = ([_P, _I, _P, _I, _P, _I, _I, _I, _I,
                       _P, _P, _I, _I] + _SPEC
                      + [_P, _P, _I, _I] + _SPEC + [_P])
    for fn in (gemm, fused):
        fn.restype = ctypes.c_int
    return gemm, fused


@functools.cache
def _attention():
    fn = _build.load("paged_attention").pa_paged_decode_attention
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tiled():
    fn = _build.load("zvg_tiled_matmul").zt_zvg_tiled_matmul
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


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
    return torch.cuda.current_stream(device).cuda_stream


def gated_row_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ZVG-gated ``x [M, K] @ w [K, N]`` on the card (float32 or
    bfloat16 operands); matches :func:`.ref.gated_row_matmul_ref`: gated
    rows bit for bit, live rows up to the order of the float32 sums."""
    out_dtype = check_operands(x, w)
    _check_on_card("gated_row_matmul_cuda", x, w)
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    gemm, _ = _functions()
    with torch.cuda.device(x.device):
        err = gemm(x.data_ptr(), _DTYPE_CODE[x.dtype], w.data_ptr(),
                   _DTYPE_CODE[w.dtype], out.data_ptr(),
                   _DTYPE_CODE[out_dtype], M, K, N, _stream(x.device))
    if err:
        raise RuntimeError(f"gated_row_matmul kernel launch failed: CUDA "
                           f"error {err}")
    gated_row_matmul_cuda.launches += 1
    return out


def fused_matmul_counters_cuda(a: torch.Tensor, w: torch.Tensor,
                               west_spec: CounterSpec,
                               north_spec: CounterSpec, lanes_w: int,
                               cols: int):
    """K2's product of ``a [B, K]`` and ``w [K, N]`` and the counters of
    the decode streams, in one launch; outputs as
    :func:`.ref.fused_matmul_counters_ref`, the counters bit for bit."""
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
    wz = torch.zeros((B, K), dtype=torch.int32, device=dev)
    nc = torch.empty((north_spec.n_rows, lanes_n), dtype=torch.int32,
                     device=dev)
    nz = torch.zeros((K,), dtype=torch.int32, device=dev)
    _, fused = _functions()
    with torch.cuda.device(dev):
        err = fused(a.data_ptr(), _DTYPE_CODE[a.dtype], w.data_ptr(),
                    _DTYPE_CODE[w.dtype], product.data_ptr(),
                    _DTYPE_CODE[out_dtype], B, K, N,
                    wc.data_ptr(), wz.data_ptr(), west_spec.n_rows, lanes_w,
                    *spec_args(west_spec),
                    nc.data_ptr(), nz.data_ptr(), north_spec.n_rows, lanes_n,
                    *spec_args(north_spec), _stream(dev))
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
    ``lengths [B]`` positions a row, on the card; matches
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
    with torch.cuda.device(q.device):
        err = _attention()(q.data_ptr(), k_pool.data_ptr(),
                           v_pool.data_ptr(), out.data_ptr(),
                           _DTYPE_CODE[q.dtype], pages.data_ptr(),
                           lengths.data_ptr(), B, H, KV, HD, PS,
                           pages.shape[1], float(scale), float(softcap),
                           _stream(q.device))
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
    JAX package's signature: the kernel tiles N its own way, which changes
    no result. Raises on operands or blocks the kernel does not take (the
    block rule is ``zt_zvg_tiled_matmul``'s, in ``zvg_tiled_matmul.cu``)."""
    check_tiled_operands(a, b, block_m, block_k)
    _check_on_card("zvg_matmul_cuda", a, b)
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    gated = torch.empty((-(-M // block_m), -(-K // block_k)),
                        dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = _tiled()(a.data_ptr(), b.data_ptr(), _DTYPE_CODE[a.dtype], M,
                       K, N, block_m, block_k, out.data_ptr(),
                       gated.data_ptr(), _stream(a.device))
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"zvg_matmul_cuda does not take blocks ({block_m}, "
                         f"{block_k}) for a {M}x{K}x{N} product: block_m "
                         f"must be a multiple of the kernel's row tile and "
                         f"block_k of its k step (zvg_tiled_matmul.cu)")
    if err:
        raise RuntimeError(f"zvg tiled matmul kernel launch failed: CUDA "
                           f"error {err}")
    zvg_matmul_cuda.launches += 1
    return out, gated


#: kernel launches so far; set them to 0 before a run to count that run's
gated_row_matmul_cuda.launches = 0
fused_matmul_counters_cuda.launches = 0
fused_paged_attention_cuda.launches = 0
zvg_matmul_cuda.launches = 0
