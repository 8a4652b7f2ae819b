"""Wrapper of K8, the grouped gated expert product on Hopper
(``csrc/expert_matmul.cu``): built with ``nvcc`` at first use and called
through ``ctypes`` on PyTorch's current stream. It raises on operands the
kernel does not take (:func:`expert_route` says which it takes), and
where autograd would record (the kernel has no backward), and never falls
back to the plain version.

The grid is planned from what the host knows: the segments' offsets stay
on the card, so the grid holds, for each column tile of 64 and each
expert, as many row tiles of :data:`TILE_M` as the most rows an
expert can hold (the tokens of the call: a token picks an expert once),
and a block whose row tile lies past its expert's segment ends at once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .ref import check_operands

_P, _I = ctypes.c_void_p, ctypes.c_int

#: K8's output tile's rows (of one expert's segment; 64 columns) and the k
#: of a shared-memory stage; a stage never crosses into the next expert's
#: weights, so K is a whole number of stages
TILE_M = 64
STAGE_K = 64

#: the gated product against the plain version: |kernel - plain| <=
#: GLU_TOL[0] * |plain| + GLU_TOL[1] * max |plain|. Gate and up each lie
#: within a bfloat16 unit of the float32 sums in both (their sums in
#: another order), SiLU(g) * u moves by about as much again, and the
#: kernel's exp may part from PyTorch's by a float32 ulp before its
#: rounding: four bfloat16 units of the value (2**-6), and a floor of 0.1%
#: of the largest value where the products cancel to near zero. The
#: ungated product holds to K2's wide-route rule (``zvg_matmul.cases.
#: WIDE_TOL``) against the float32 product of each segment.
GLU_TOL = (2.0 ** -6, 1e-3)


@functools.cache
def _function():
    fn = _build.load("expert_matmul").em_expert_matmul
    fn.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def expert_route(x: torch.Tensor, w: torch.Tensor,
                 w_up: torch.Tensor | None = None) -> bool:
    """Whether K8 takes ``x [P, K]`` by ``w [E, K, N]`` (and ``w_up``):
    all bfloat16 and contiguous on the card, K a whole number of
    :data:`STAGE_K` stages, N a multiple of 8 and every base 16-byte
    aligned (rows the tensor memory accelerator can describe)."""
    ops = (x, w) if w_up is None else (x, w, w_up)
    return (all(t.dtype == torch.bfloat16 and t.is_cuda
                and t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in ops)
            and x.shape[1] % STAGE_K == 0 and w.shape[2] % 8 == 0)


def expert_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                       offsets: torch.Tensor, rows_max: int,
                       w_up: torch.Tensor | None = None) -> torch.Tensor:
    """K8: ``[P, N]`` bfloat16, as :func:`.ref.expert_matmul_ref` (with
    ``w_up``, SiLU the gate's activation) up to the order of the float32
    sums: gated rows +0.0 bit for bit. ``rows_max`` bounds every segment
    (the tokens of the call). One launch a call."""
    check_operands(x, w, offsets, w_up)
    ops = (x, w) if w_up is None else (x, w, w_up)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise RuntimeError("K8 has no backward: its output would carry no "
                           "gradient to the experts' weights; run the "
                           "plain route (backend 'ref') under autograd")
    if not expert_route(x, w, w_up):
        raise ValueError(f"K8 takes contiguous bfloat16 operands on the "
                         f"card, K a multiple of {STAGE_K} and N of 8; got "
                         f"x {tuple(x.shape)} {x.dtype} on {x.device}, w "
                         f"{tuple(w.shape)} {w.dtype}")
    (P, K), (E, _, N) = x.shape, w.shape
    offsets = offsets.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty((P, N), dtype=torch.bfloat16, device=x.device)
    if P == 0:
        return out
    row_tiles = max(1, -(-rows_max // TILE_M))   # the grid's z, an expert
    err = _function()(x.data_ptr(), w.data_ptr(),
                      0 if w_up is None else w_up.data_ptr(),
                      offsets.data_ptr(), out.data_ptr(), P, K, N, E,
                      row_tiles, TILE_M, x.device.index,
                      torch._C._cuda_getCurrentRawStream(x.device.index))
    if err:
        raise RuntimeError(f"expert_matmul kernel launch failed: CUDA "
                           f"error {err}")
    expert_matmul_cuda.launches += 1
    return out


#: kernel launches so far; set it to 0 before a run to count that run's
expert_matmul_cuda.launches = 0
