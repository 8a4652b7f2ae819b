"""ResNet50 and MobileNetV1 in PyTorch, instrumented for SA streaming analysis.

The paper evaluates data streaming on the matrix multiplications of CNN
inference (convolutions lowered via im2col). These are the full
architectures (exact layer shape tables) with He-initialized weights
drawn from numpy, exactly as the JAX package draws them. The forward
records, for every conv/fc layer, the (A, W) operand pair of the lowered
matmul:

  A = im2col(input activations)   [M, K]   (M = N*H_out*W_out)
  W = reshaped kernel             [K, N_out]

Layouts follow the JAX package: images and activations NHWC, conv
weights HWIO. Convolutions pad as XLA's ``"SAME"`` does, which is
asymmetric (the extra row/column goes after), so the padding is applied
by hand, with ``-inf`` for the max pool. The forward runs in full float32:
on the card TF32 is switched off for cuDNN convolutions and matmuls while
it runs, since TF32 would change the activations and with them the bus
words.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bits
from repro_torch.runtime import spans
from repro_torch.trace import interpret


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    kind: str          # "conv" | "dwconv" | "fc"
    kernel: int = 1
    stride: int = 1
    cin: int = 0
    cout: int = 0
    relu: bool = True  # ReLU after BN (determines input zeros of NEXT layer)


def resnet50_specs() -> list[ConvSpec]:
    """The 53 convs + fc of ResNet50 (He et al., CVPR'16), in order."""
    specs = [ConvSpec("stem", "conv", 7, 2, 3, 64)]
    stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
              (3, 512, 2048, 2)]
    cin = 64
    for si, (blocks, mid, out, stride) in enumerate(stages):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            p = f"s{si+1}b{bi+1}"
            specs.append(ConvSpec(f"{p}.c1", "conv", 1, 1, cin, mid))
            specs.append(ConvSpec(f"{p}.c2", "conv", 3, s, mid, mid))
            specs.append(ConvSpec(f"{p}.c3", "conv", 1, 1, mid, out,
                                  relu=False))
            if bi == 0:
                specs.append(ConvSpec(f"{p}.sc", "conv", 1, s, cin, out,
                                      relu=False))
            cin = out
    specs.append(ConvSpec("fc", "fc", cin=2048, cout=1000, relu=False))
    return specs


def mobilenet_specs() -> list[ConvSpec]:
    """MobileNetV1 (Howard et al. 2017): stem + 13 dw/pw pairs + fc."""
    specs = [ConvSpec("stem", "conv", 3, 2, 3, 32)]
    for i, (cin, cout, s) in enumerate(_MOBILENET_PLAN):
        specs.append(ConvSpec(f"dw{i+1}", "dwconv", 3, s, cin, cin))
        specs.append(ConvSpec(f"pw{i+1}", "conv", 1, 1, cin, cout))
    specs.append(ConvSpec("fc", "fc", cin=1024, cout=1000, relu=False))
    return specs


_MOBILENET_PLAN = ([(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
                    (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5
                   + [(512, 1024, 2), (1024, 1024, 1)])

NETS: dict[str, Callable[[], list[ConvSpec]]] = {
    "resnet50": resnet50_specs,
    "mobilenet": mobilenet_specs,
}


class Params(NamedTuple):
    """A network's parameters: ``weights[name]`` (HWIO convs, ``[K, N]``
    fc) and ``bn[name] = (gamma, beta)``, float32 tensors on one device."""
    weights: dict[str, torch.Tensor]
    bn: dict[str, tuple[torch.Tensor, torch.Tensor]]


def _draw_weights(specs: list[ConvSpec], seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    ws = {}
    for s in specs:
        if s.kind == "conv":
            fan_in = s.kernel * s.kernel * s.cin
            w = rng.standard_normal(
                (s.kernel, s.kernel, s.cin, s.cout)) * np.sqrt(2.0 / fan_in)
        elif s.kind == "dwconv":
            fan_in = s.kernel * s.kernel
            w = rng.standard_normal(
                (s.kernel, s.kernel, 1, s.cin)) * np.sqrt(2.0 / fan_in)
        else:  # fc
            w = rng.standard_normal((s.cin, s.cout)) * np.sqrt(2.0 / s.cin)
        ws[s.name] = w.astype(np.float32)
    return ws


def _draw_bn(specs: list[ConvSpec], seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    bn = {}
    for s in specs:
        c = s.cout if s.kind != "dwconv" else s.cin
        layer_shift = rng.standard_normal() * 0.45 - 0.25   # per-layer offset
        bn[s.name] = (np.exp(rng.standard_normal(c) * 0.15).astype(np.float32),
                      (rng.standard_normal(c) * 0.4
                       + layer_shift).astype(np.float32))
    return bn


def init_weights(specs: list[ConvSpec], seed: int = 0,
                 device: str | torch.device = "cpu"
                 ) -> dict[str, torch.Tensor]:
    """He-normal weights, HWIO layout for convs, [K, N] for fc: the same
    numpy draws as the JAX package's ``init_weights``."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in _draw_weights(specs, seed).items()}


def init_bn(specs: list[ConvSpec], seed: int = 0,
            device: str | torch.device = "cpu") -> dict:
    """Per-channel BN affine ``(gamma, beta)``: beta ~ N(-0.25, 0.5)-ish
    per-layer shifts and gamma ~ LogNormal(0, 0.15), which spread the
    per-layer ReLU zero fractions as trained networks do (the same numpy
    draws as the JAX package's ``init_bn``)."""
    return {k: (torch.from_numpy(g).to(device), torch.from_numpy(b).to(device))
            for k, (g, b) in _draw_bn(specs, seed).items()}


def params_from_numpy(ws: dict, bn: dict,
                      device: str | torch.device = "cpu") -> Params:
    """The port's parameters from numpy arrays laid out as the JAX
    package's ``init_weights`` / ``init_bn`` dicts (e.g. its weights
    carried across as ``np.asarray``)."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return Params({k: t(v) for k, v in ws.items()},
                  {k: (t(g), t(b)) for k, (g, b) in bn.items()})


def init_params(net: str, seed: int = 0,
                device: str | torch.device = "cpu") -> Params:
    specs = NETS[net]()
    return Params(init_weights(specs, seed, device),
                  init_bn(specs, seed, device))


@contextlib.contextmanager
def _full_f32():
    """Run float32 convolutions and matmuls in full float32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_hw(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """SAME-pad the H and W dims of an NHWC tensor."""
    (pt, pb), (pl, pr) = (_same_pads(x.shape[1], k, s),
                          _same_pads(x.shape[2], k, s))
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def _bn_relu(x, gamma, beta, relu=True):
    """Batch-statistics normalization (population variance) + affine +
    optional ReLU."""
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, correction=0)
    x = (x - mu) / torch.sqrt(var + 1e-5) * gamma + beta
    return torch.relu(x) if relu else x


def _conv(x, w, stride, groups=1):
    """NHWC x HWIO convolution with SAME padding; under the model-wide
    tracer a seam emitting its im2col site (the padding is applied first,
    so the site's patches are the SAME-padded ones)."""
    k = w.shape[0]
    xc = _pad_hw(x, k, stride).permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    interpret.emit_conv(xc, wc, stride, 0, 1, groups)
    with interpret.seam():
        y = F.conv2d(xc, wc, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _max_pool(x, k, s):
    xc = _pad_hw(x, k, s, value=float("-inf")).permute(0, 3, 1, 2)
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


def _im2col(x, kernel, stride):
    """Patches of NHWC ``x`` as the [M, K] matmul operand, K ordered
    (kh, kw, c) to match the HWIO weight reshape."""
    with spans.span("cnn.im2col"):
        n, h, w, c = x.shape
        if kernel == 1:
            return x[:, ::stride, ::stride, :].reshape(-1, c)
        xp = _pad_hw(x, kernel, stride)
        ho, wo = -(-h // stride), -(-w // stride)
        taps = [xp[:, i:i + stride * (ho - 1) + 1:stride,
                   j:j + stride * (wo - 1) + 1:stride, :]
                for i in range(kernel) for j in range(kernel)]
        return torch.stack(taps, dim=3).reshape(n * ho * wo,
                                                kernel * kernel * c)


@dataclasses.dataclass
class LayerTrace:
    """One lowered matmul: exactly what the SA streams."""
    name: str
    kind: str
    A: torch.Tensor     # [M, K] bf16 input operand (West edge)
    W: torch.Tensor     # [K, N] bf16 weight operand (North edge)
    macs: float


class _Tracer:
    """Runs layers while (optionally) recording the lowered operands."""

    def __init__(self, params: Params, record: bool = True):
        self.ws = params.weights
        self.bn = params.bn
        self.record = record
        self.traces: list[LayerTrace] = []

    def _record(self, name, kind, A, W):
        with spans.span("cnn.record"):
            self.traces.append(LayerTrace(
                name=name, kind=kind,
                A=bits.to_bf16(A), W=bits.to_bf16(W),
                macs=float(A.shape[0]) * A.shape[1] * W.shape[1]))

    def conv(self, name, x, kernel, stride, relu=True):
        w = self.ws[name]
        if self.record:
            self._record(name, "conv", _im2col(x, kernel, stride),
                         w.reshape(-1, w.shape[-1]))
        with spans.span("cnn.conv"):
            y = _conv(x, w, stride)
            g, b = self.bn[name]
            return _bn_relu(y, g, b, relu)

    def dwconv(self, name, x, kernel, stride, relu=True):
        w = self.ws[name]
        c = w.shape[3]
        if self.record:
            self._record(name, "dwconv", _im2col(x, kernel, stride),
                         w.reshape(kernel * kernel, c))
        with spans.span("cnn.conv"):
            y = _conv(x, w, stride, groups=c)
            g, b = self.bn[name]
            return _bn_relu(y, g, b, relu)

    def fc(self, name, x):
        w = self.ws[name]
        if self.record:
            self._record(name, "fc", x, w)
        interpret.emit_matmul(x, w)
        with interpret.seam(), spans.span("cnn.conv"):
            return x @ w


def _forward_resnet50(tr: _Tracer, x: torch.Tensor) -> torch.Tensor:
    x = tr.conv("stem", x, 7, 2)
    x = _max_pool(x, 3, 2)
    stages = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]
    for si, (blocks, mid, stride) in enumerate(stages):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            p = f"s{si+1}b{bi+1}"
            inp = x
            y = tr.conv(f"{p}.c1", inp, 1, 1)
            y = tr.conv(f"{p}.c2", y, 3, s)
            y = tr.conv(f"{p}.c3", y, 1, 1, relu=False)
            if bi == 0:  # projection shortcut reads the BLOCK INPUT
                sc = tr.conv(f"{p}.sc", inp, 1, s, relu=False)
            else:
                sc = inp
            x = torch.relu(y + sc)
    x = x.mean(dim=(1, 2))
    return tr.fc("fc", x)


def _forward_mobilenet(tr: _Tracer, x: torch.Tensor) -> torch.Tensor:
    x = tr.conv("stem", x, 3, 2)
    for i, (_, _, s) in enumerate(_MOBILENET_PLAN):
        x = tr.dwconv(f"dw{i+1}", x, 3, s)
        x = tr.conv(f"pw{i+1}", x, 1, 1)
    x = x.mean(dim=(1, 2))
    return tr.fc("fc", x)


_FORWARDS = {"resnet50": _forward_resnet50, "mobilenet": _forward_mobilenet}


def _params(net: str, images: torch.Tensor, seed: int,
            params: Params | None) -> Params:
    return params if params is not None else init_params(
        net, seed, images.device)


def make_forward(net: str, seed: int = 0, params: Params | None = None):
    """Plain ``images -> logits`` forward (no operand recording), with
    parameters from ``seed`` or given as ``params``."""
    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), _full_f32():
            return _FORWARDS[net](
                _Tracer(_params(net, images, seed, params), record=False),
                images)
    return forward


def forward_with_traces(net: str, images: torch.Tensor, seed: int = 0,
                        params: Params | None = None) -> list[LayerTrace]:
    """Run inference, capturing the (A, W) matmul operands of every layer.

    Args:
      net: "resnet50" | "mobilenet".
      images: ``f32[N, H, W, 3]`` (standardized), on the device to run on.
      seed: parameter seed (ignored when ``params`` is given).
      params: parameters, e.g. from :func:`params_from_numpy`.
    """
    tr = _Tracer(_params(net, images, seed, params))
    with torch.no_grad(), _full_f32(), spans.span("cnn.capture"):
        _FORWARDS[net](tr, images)
    if [t.name for t in tr.traces] != [s.name for s in NETS[net]()]:
        raise RuntimeError(f"{net} forward recorded the wrong layers")
    return tr.traces


def synthetic_images(n: int = 2, res: int = 224, seed: int = 7,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """Smooth synthetic 'natural' images, NHWC: bilinearly upsampled
    low-frequency noise + fine texture, standardized -- the JAX package's
    numpy draws, upsampled with half-pixel centres as ``jax.image.resize``
    does (computed on the CPU, then moved to ``device``)."""
    rng = np.random.default_rng(seed)
    lo = rng.standard_normal((n, res // 8, res // 8, 3)).astype(np.float32)
    img = F.interpolate(torch.from_numpy(lo).permute(0, 3, 1, 2),
                        size=(res, res), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    img = img + 0.15 * torch.from_numpy(
        rng.standard_normal((n, res, res, 3)).astype(np.float32))
    img = (img - img.mean()) / (img.std(correction=0) + 1e-6)
    return img.contiguous().to(device)
