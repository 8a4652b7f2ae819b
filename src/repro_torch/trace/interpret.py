"""Find every matmul a callable runs, with its operands, as it runs.

:func:`trace_fn` runs ``fn(*args)`` once and hands every matmul it
executes to ``emit`` as a :class:`MatmulSite`: operands in the ``[B, M,
K] x [B, K, N]`` form a systolic array streams, named by where in the
model they ran. The JAX package finds the same sites by walking the
function's jaxpr (``repro.trace.interpret``); the port intercepts at run
time, in two ways:

* **Seams.** The port's own matmul entry points -- ``models.matmul.
  matmul`` (whose decode route is a ctypes kernel no dispatcher sees),
  the attention einsums (:func:`einsum`) and the CNN's convolution and fc
  -- emit their sites themselves, with the operands in the element order
  ``dot_general`` gives them in the JAX package. Inside a seam nothing
  else is counted, so no matmul is counted twice.
* **The catch-all.** Anywhere else, a ``TorchDispatchMode`` over
  ``aten.mm/addmm/bmm/convolution`` emits the site of each call, so
  an arbitrary function (``lambda x: x @ w``) traces too.

Site names are ``<frames>/dot#<k>``: the frames are the trace's name, the
scopes the models open where the JAX models open a ``named_scope``
(:func:`scope`), the layer group of a scanned stack (``scan[i]``) and an
einsum's spec, as the JAX tracer names them; ``k`` counts the sites under
one prefix in one trace. The names are stable across calls (decode steps),
which is what lets :mod:`.capture` accumulate per site.

With no trace running, every hook here is a no-op that touches no tensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass
class MatmulSite:
    """One matmul in systolic-array streaming form: ``lhs [B, M, K]``,
    ``rhs [B, K, N]`` (B independent problems: batched products and
    grouped convolutions)."""
    name: str
    kind: str            # "dot_general" | "conv" | "dwconv"
    lhs: torch.Tensor
    rhs: torch.Tensor

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return (self.lhs.shape[0], self.lhs.shape[1], self.lhs.shape[2],
                self.rhs.shape[2])

    @property
    def macs(self) -> float:
        b, m, k, n = self.shape
        return float(b) * m * k * n


class _Scope:
    """Hierarchical site naming: a stack of frames (the trace's name, model
    scopes, scan iterations, einsum specs) and an occurrence counter per
    prefix."""

    def __init__(self):
        self.frames: list[str] = []
        self.counts: dict[str, int] = {}

    def push(self, frame: str):
        self.frames.append(frame)

    def pop(self):
        self.frames.pop()

    def site_name(self) -> str:
        prefix = "/".join(self.frames) if self.frames else "<top>"
        k = self.counts.get(prefix, 0)
        self.counts[prefix] = k + 1
        return f"{prefix}/dot#{k}"


# ------------------------------------------------------------- operands
def dot_operands_3d(lhs: torch.Tensor, rhs: torch.Tensor, dimension_numbers
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """General ``dot_general`` operands as ``[B, M, K] x [B, K, N]``:
    ``dimension_numbers = ((lhs_contract, rhs_contract), (lhs_batch,
    rhs_batch))``. Batch dims pair up and flatten into B, contracting dims
    into K in the same order on both sides; the free dims keep their
    order."""
    (lc, rc), (lb, rb) = dimension_numbers
    lo = [d for d in range(lhs.dim()) if d not in lc and d not in lb]
    ro = [d for d in range(rhs.dim()) if d not in rc and d not in rb]
    A = lhs.permute(*lb, *lo, *lc)
    W = rhs.permute(*rb, *rc, *ro)
    b = math.prod(lhs.shape[d] for d in lb)
    m = math.prod(lhs.shape[d] for d in lo)
    k = math.prod(lhs.shape[d] for d in lc)
    n = math.prod(rhs.shape[d] for d in ro)
    return A.reshape(b, m, k), W.reshape(b, k, n)


def einsum_operands_3d(spec: str, x: torch.Tensor, y: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``[B, M, K] x [B, K, N]`` operands of the ``dot_general`` that
    ``jnp.einsum(spec, x, y)`` binds, in its element order. For two
    operands the JAX package's einsum takes ``y`` as its left side, drops
    unit dims whose counterpart is not a unit dim, and makes batch dims of
    the names both sides share (in output order) and contracting dims of
    the names only the inputs hold (sorted); it binds ``dot_general(x, y)``
    when that already gives the output's order, else ``dot_general(y,
    x)``. Takes the einsums the port's models run: two operands, no name
    repeated within one, none summed on one side only."""
    ins, out = spec.replace(" ", "").split("->")
    xn, yn = ins.split(",")
    if len(set(xn)) != len(xn) or len(set(yn)) != len(yn) or any(
            c not in out and c not in (yn if c in xn else xn)
            for c in xn + yn):
        raise NotImplementedError(f"einsum {spec!r}: only two operands "
                                  f"without repeated or one-sided summed "
                                  f"names are traced")
    lhs, lhs_n = _drop_unit(y, yn, x, xn)       # JAX's lhs is y
    rhs, rhs_n = _drop_unit(x, xn, y, yn)
    contracted = sorted(c for c in set(lhs_n) | set(rhs_n) if c not in out)
    if any(c not in lhs_n or c not in rhs_n for c in contracted):
        raise NotImplementedError(f"einsum {spec!r}: a contracted unit dim "
                                  f"against a longer one is not traced")
    batch = [c for c in out if c in lhs_n and c in rhs_n]
    rem_l = [c for c in lhs_n if c not in batch and c not in contracted]
    rem_r = [c for c in rhs_n if c not in batch and c not in contracted]
    if "".join(batch + rem_r + rem_l) == out:
        first, f_n, second, s_n = rhs, rhs_n, lhs, lhs_n
    else:
        first, f_n, second, s_n = lhs, lhs_n, rhs, rhs_n
    dims = (([f_n.index(c) for c in contracted],
             [s_n.index(c) for c in contracted]),
            ([f_n.index(c) for c in batch], [s_n.index(c) for c in batch]))
    return dot_operands_3d(first, second, dims)


def _drop_unit(t: torch.Tensor, names: str, other: torch.Tensor,
               other_names: str) -> tuple[torch.Tensor, str]:
    """``t`` without the unit dims whose name the other operand holds at a
    size other than 1 (JAX's ``filter_singleton_dims``)."""
    keep = [i for i, c in enumerate(names)
            if t.shape[i] != 1 or c not in other_names
            or other.shape[other_names.index(c)] == 1]
    drop = [i for i in range(t.dim()) if i not in keep]
    for i in reversed(drop):
        t = t.squeeze(i)
    return t, "".join(names[i] for i in keep)


def conv_operands_3d(x: torch.Tensor, w: torch.Tensor, stride, padding,
                     dilation, groups: int):
    """A convolution ``x [N, C, *spatial]`` with ``w [O, C/groups,
    *kernel]`` (PyTorch's layouts), zero-padded by ``padding`` on both
    sides of each spatial dim, as its im2col matmul operands ``(A [G, M,
    Kg], W [G, Kg, Ng], kind)``. M runs over (image, *output position); K
    is ordered (*kernel offset, channel), the order of an HWIO kernel's
    ``w.reshape(-1, cout)`` and of the JAX package's
    ``conv_operands_3d``. Grouped convolutions become ``groups`` batched
    problems, ``"dwconv"`` where a group holds one input channel."""
    nsp = x.dim() - 2
    stride, padding, dilation = (
        [int(v)] * nsp if isinstance(v, int) else [int(e) for e in v]
        for v in (stride, padding, dilation))
    ksp = list(w.shape[2:])
    if any(padding):
        pads = [p for d in reversed(range(nsp)) for p in (padding[d],) * 2]
        x = torch.nn.functional.pad(x, pads)
    out_sp = [(x.shape[2 + d] - dilation[d] * (ksp[d] - 1) - 1)
              // stride[d] + 1 for d in range(nsp)]
    taps = []
    for off in itertools.product(*map(range, ksp)):   # last dim fastest
        idx = [slice(None), slice(None)] + [
            slice(off[d] * dilation[d],
                  off[d] * dilation[d] + stride[d] * (out_sp[d] - 1) + 1,
                  stride[d]) for d in range(nsp)]
        taps.append(x[tuple(idx)])                 # [N, C, *out]
    n, c = x.shape[:2]
    kk = len(taps)
    p = torch.stack(taps, dim=2)                   # [N, C, kk, *out]
    p = p.permute(0, *range(3, 3 + nsp), 2, 1)     # [N, *out, kk, C]
    m = n * math.prod(out_sp)
    cout, cin_g = w.shape[:2]
    wc = w.permute(*range(2, 2 + nsp), 1, 0)       # [*kernel, I, O]
    if groups == 1:
        return (p.reshape(1, m, kk * c), wc.reshape(1, kk * cin_g, cout),
                "conv")
    cout_g = cout // groups
    A = p.reshape(m, kk, groups, cin_g).permute(2, 0, 1, 3).reshape(
        groups, m, kk * cin_g)
    W = wc.reshape(kk * cin_g, groups, cout_g).permute(1, 0, 2)
    return A, W, "dwconv" if cin_g == 1 else "conv"


# --------------------------------------------------------------- tracer
class _Tracer:
    def __init__(self, emit: Callable[[MatmulSite], None],
                 include_conv: bool):
        self.emit = emit
        self.include_conv = include_conv
        self.scope = _Scope()
        self.skipped: list[str] = []
        self.quiet = 0          # > 0 inside a seam or while recording

    def site(self, kind: str, A: torch.Tensor, W: torch.Tensor):
        name = self.scope.site_name()
        self.quiet += 1
        try:
            self.emit(MatmulSite(name, kind, A, W))
        finally:
            self.quiet -= 1


#: the trace running now, if any
_ACTIVE: _Tracer | None = None
_NULL = contextlib.nullcontext()


def active() -> bool:
    """Whether a trace is running (and a seam should emit its site)."""
    return _ACTIVE is not None


@contextlib.contextmanager
def _frame(name: str):
    _ACTIVE.scope.push(name)
    try:
        yield
    finally:
        _ACTIVE.scope.pop()


def scope(name: str):
    """A naming frame (``with scope("attn"): ...``), the port's
    ``named_scope``; a shared no-op context with no trace running."""
    return _NULL if _ACTIVE is None else _frame(name)


@contextlib.contextmanager
def _quiet():
    _ACTIVE.quiet += 1
    try:
        yield
    finally:
        _ACTIVE.quiet -= 1


def seam():
    """Inside it the catch-all counts nothing: the seam has emitted its
    own site (a no-op with no trace running)."""
    return _NULL if _ACTIVE is None else _quiet()


def emit_matmul(x: torch.Tensor, w: torch.Tensor) -> None:
    """The site of ``x [..., K] @ w [K, N]``: ``[1, prod(...), K] x [1, K,
    N]``, as ``jnp.matmul`` binds it."""
    if _ACTIVE is not None and _ACTIVE.quiet == 0:
        _ACTIVE.site("dot_general", x.reshape(1, -1, x.shape[-1]), w[None])


def emit_conv(x: torch.Tensor, w: torch.Tensor, stride, padding, dilation,
              groups: int) -> None:
    """The site of a convolution (see :func:`conv_operands_3d`); nothing
    when the trace leaves convolutions out."""
    if (_ACTIVE is not None and _ACTIVE.quiet == 0
            and _ACTIVE.include_conv):
        A, W, kind = conv_operands_3d(x, w, stride, padding, dilation,
                                      groups)
        _ACTIVE.site(kind, A, W)


def einsum(spec: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, x, y)``; under a trace, a frame named by the
    spec (as ``jnp.einsum``'s named call) holding the site of the
    ``dot_general`` the JAX package would bind."""
    if _ACTIVE is None or _ACTIVE.quiet:
        return torch.einsum(spec, x, y)
    with _frame(spec):
        A, W = einsum_operands_3d(spec, x, y)
        _ACTIVE.site("dot_general", A, W)
        with _quiet():
            return torch.einsum(spec, x, y)


class _CatchAll(TorchDispatchMode):
    """Emits the site of every matmul or convolution no seam claimed."""

    def __init__(self, tracer: _Tracer):
        super().__init__()
        self.tracer = tracer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tr = self.tracer
        if not tr.quiet:
            op = func.overloadpacket
            aten = torch.ops.aten
            if op in (aten.mm, aten.bmm, aten.addmm):
                a, b = args[1:3] if op is aten.addmm else args[:2]
                if op is aten.bmm:
                    tr.site("dot_general", a, b)
                else:
                    tr.site("dot_general", a[None], b[None])
            elif op is aten.convolution and tr.include_conv:
                x, w, _, stride, padding, dilation, transposed, _, g = args
                if transposed:
                    tr.skipped.append(tr.scope.site_name())
                else:
                    A, W, kind = conv_operands_3d(x, w, stride, padding,
                                                  dilation, g)
                    tr.site(kind, A, W)
        return func(*args, **kwargs)


def trace_fn(fn: Callable, *args, emit: Callable[[MatmulSite], None],
             include_conv: bool = True, name: str = ""):
    """Run ``fn(*args)`` once, handing every matmul and convolution it
    executes to ``emit`` as a :class:`MatmulSite` with its live operands.
    The function computes what it computes untraced. Returns ``(outputs,
    skipped_site_names)``: the sites that have no single-array streaming
    form (transposed convolutions)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("trace_fn does not nest")
    tracer = _Tracer(emit, include_conv)
    if name:
        tracer.scope.push(name)
    _ACTIVE = tracer
    try:
        with _CatchAll(tracer):
            out = fn(*args)
    finally:
        _ACTIVE = None
    return out, tracer.skipped
