"""Plain ResNet50 forward in float32 that captures what the systolic array
streams: for every conv and the fc, ``A = im2col(input)`` and ``W`` the
reshaped kernel, both rounded to bfloat16.

Written from ResNet50 (He et al., CVPR 2016) as ``repro_torch.apps.cnn.
nets`` states it: NHWC activations, HWIO kernels, XLA's ``SAME`` padding
(the extra row and column after), batch-statistics BN (population
variance, eps 1e-5) with an affine and ReLU, bottleneck blocks whose
first block projects the block input, global mean pooling and the fc.
The layer table is a frozen copy of ``nets.resnet50_specs``. Each
convolution is computed here as its im2col matmul in float32, with TF32
off unless ``tf32`` (the control) turns it on, not by cuDNN's
convolution: so the reference's operands come by another route than the
program's.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Spec:
    name: str
    kind: str            # "conv" | "fc"
    kernel: int = 1
    stride: int = 1
    cin: int = 0
    cout: int = 0
    relu: bool = True


STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
          (3, 512, 2048, 2))


def specs() -> list[Spec]:
    """The 53 convs and the fc, in the forward's order."""
    out = [Spec("stem", "conv", 7, 2, 3, 64)]
    cin = 64
    for si, (blocks, mid, width, stride) in enumerate(STAGES):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            p = f"s{si + 1}b{bi + 1}"
            out.append(Spec(f"{p}.c1", "conv", 1, 1, cin, mid))
            out.append(Spec(f"{p}.c2", "conv", 3, s, mid, mid))
            out.append(Spec(f"{p}.c3", "conv", 1, 1, mid, width, False))
            if bi == 0:
                out.append(Spec(f"{p}.sc", "conv", 1, s, cin, width, False))
            cin = width
    out.append(Spec("fc", "fc", cin=2048, cout=1000, relu=False))
    return out


def site_shapes(batch: int, res: int) -> list[tuple[str, int, int, int]]:
    """``(name, M, K, N)`` of every matmul site at ``batch`` images of
    ``res`` px: the shapes the byte, FLOP and MAC counts are taken from."""
    out = []
    hw = res
    by = {s.name: s for s in specs()}

    def conv(name, h):
        s = by[name]
        ho = -(-h // s.stride)
        out.append((name, batch * ho * ho, s.kernel * s.kernel * s.cin,
                    s.cout))
        return ho

    hw = conv("stem", hw)
    hw = -(-hw // 2)                                  # the max pool
    for si, (blocks, _, _, _) in enumerate(STAGES):
        for bi in range(blocks):
            p = f"s{si + 1}b{bi + 1}"
            h1 = conv(f"{p}.c1", hw)
            h2 = conv(f"{p}.c2", h1)
            conv(f"{p}.c3", h2)
            if bi == 0:
                conv(f"{p}.sc", hw)
            hw = h2
    out.append(("fc", batch, 2048, 1000))
    return out


def _same(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad(x, k, s, value=0.0):
    (pt, pb), (pl, pr) = _same(x.shape[1], k, s), _same(x.shape[2], k, s)
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def im2col(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``[N*Ho*Wo, k*k*C]`` patches of NHWC ``x``, K ordered (kh, kw, c)."""
    n, h, w, c = x.shape
    if k == 1:
        return x[:, ::s, ::s, :].reshape(-1, c)
    xp = _pad(x, k, s)
    ho, wo = -(-h // s), -(-w // s)
    taps = [xp[:, i:i + s * (ho - 1) + 1:s, j:j + s * (wo - 1) + 1:s, :]
            for i in range(k) for j in range(k)]
    return torch.stack(taps, dim=3).reshape(n * ho * wo, k * k * c)


def _bn(y, g, b, relu):
    mu = y.mean(dim=(0, 1, 2), keepdim=True)
    var = ((y - mu) ** 2).mean(dim=(0, 1, 2), keepdim=True)
    y = (y - mu) / torch.sqrt(var + 1e-5) * g + b
    return torch.relu(y) if relu else y


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def sites(weights: dict, bn: dict, images: torch.Tensor, tf32: bool = False):
    """Yield ``(name, A bf16 [M, K], W bf16 [K, N])`` site by site, in the
    forward's order, while the forward runs."""
    by = {s.name: s for s in specs()}

    def conv(name, x):
        s = by[name]
        A = im2col(x, s.kernel, s.stride)
        W = weights[name].reshape(-1, s.cout)
        n, h, w, _ = x.shape
        ho, wo = -(-h // s.stride), -(-w // s.stride)
        captured = (name, A.to(torch.bfloat16), W.to(torch.bfloat16))
        y = (A @ W).reshape(n, ho, wo, s.cout)
        del A
        g, b = bn[name]
        return captured, _bn(y, g, b, s.relu)

    with torch.no_grad(), _tf32(tf32):
        site, x = conv("stem", images)
        yield site
        x = F.max_pool2d(_pad(x, 3, 2, float("-inf")).permute(0, 3, 1, 2),
                         3, 2).permute(0, 2, 3, 1)
        for si, (blocks, _, _, _) in enumerate(STAGES):
            for bi in range(blocks):
                p = f"s{si + 1}b{bi + 1}"
                inp = x
                site, y = conv(f"{p}.c1", inp)
                yield site
                site, y = conv(f"{p}.c2", y)
                yield site
                site, y = conv(f"{p}.c3", y)
                yield site
                if bi == 0:
                    site, sc = conv(f"{p}.sc", inp)
                    yield site
                else:
                    sc = inp
                x = torch.relu(y + sc)
                del y, sc, inp
        x = x.mean(dim=(1, 2))
        yield ("fc", x.to(torch.bfloat16), weights["fc"].to(torch.bfloat16))
