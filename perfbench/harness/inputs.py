"""Inputs and weights made on the device from ``--seed``, in a few large
calls: the same seed gives the same tensors. The program and the plain
reference are handed the same ones.

The images are a device-side rewrite of ``repro_torch.apps.cnn.nets.
synthetic_images`` (bilinearly upsampled low-frequency noise plus fine
texture, standardized over the batch); the CNN weights follow
``nets.init_weights`` / ``init_bn`` (He-normal HWIO kernels, BN affine
``gamma ~ exp(0.15 N)``, ``beta ~ 0.4 N`` plus a per-layer shift).
Frozen here as of this benchmark's first version. A language model's
weights are particular to its architecture and are drawn by its
reference module (``init_params``) on a generator of this file.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def generator(seed: int, device: str, stream: int) -> torch.Generator:
    """A generator for one named use of a seed (``stream`` keeps the
    weights', the images' and the traffic's draws apart)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def images(n: int, res: int, gen: torch.Generator) -> torch.Tensor:
    """``f32[n, res, res, 3]`` synthetic natural images on ``gen``'s
    device."""
    dev = gen.device
    lo = torch.randn((n, 3, res // 8, res // 8), generator=gen, device=dev)
    img = F.interpolate(lo, size=(res, res), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    img = img + 0.15 * torch.randn((n, res, res, 3), generator=gen,
                                   device=dev)
    img = (img - img.mean()) / (img.std(correction=0) + 1e-6)
    return img.contiguous()


def cnn_params(specs, gen: torch.Generator):
    """A CNN's weights ``{name: HWIO or [K, N]}`` and BN affine ``{name:
    (gamma, beta)}`` for its layer table ``specs`` (convs and the fc),
    float32, from two draws."""
    dev = gen.device
    shapes = {}
    for s in specs:
        shapes[s.name] = ((s.kernel, s.kernel, s.cin, s.cout)
                          if s.kind == "conv" else (s.cin, s.cout))
    total = sum(math.prod(v) for v in shapes.values())
    flat = torch.randn(total, generator=gen, device=dev)
    weights, off = {}, 0
    for s in specs:
        n = math.prod(shapes[s.name])
        fan_in = s.kernel * s.kernel * s.cin if s.kind == "conv" else s.cin
        weights[s.name] = (flat[off:off + n].view(shapes[s.name])
                           * math.sqrt(2.0 / fan_in))
        off += n
    chans = [s.cout for s in specs]
    bn_flat = torch.randn(2 * sum(chans) + len(specs), generator=gen,
                          device=dev)
    shifts = bn_flat[:len(specs)] * 0.45 - 0.25
    bn, off = {}, len(specs)
    for i, (s, c) in enumerate(zip(specs, chans)):
        gamma = torch.exp(bn_flat[off:off + c] * 0.15)
        beta = bn_flat[off + c:off + 2 * c] * 0.4 + shifts[i]
        bn[s.name] = (gamma, beta)
        off += 2 * c
    return weights, bn
