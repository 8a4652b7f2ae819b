"""Plain PyTorch version of the stream-transition counter (K5), and the
checks both versions apply to their arguments."""
from __future__ import annotations

import torch

from repro_torch.core.activity import stream_transitions

#: word dtypes the stream kernels take (int32 words hold 0..65535), and
#: the bytes of each
WORD_BYTES = {torch.uint16: 2, torch.int32: 4}


def check_words(x: torch.Tensor, init: torch.Tensor | None = None) -> None:
    """Raise on a stream the kernels do not take: words ``[T, L]`` of a
    dtype of :data:`WORD_BYTES` with T, L >= 1, and ``init`` (if given) words
    ``[L]`` on the same device."""
    if x.dtype not in WORD_BYTES:
        raise TypeError(f"words must be uint16 or int32, got {x.dtype}")
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"words must be [T, L] with T, L >= 1, got "
                         f"{tuple(x.shape)}")
    if init is not None:
        if init.dtype not in WORD_BYTES:
            raise TypeError(f"init must be uint16 or int32 words, got "
                            f"{init.dtype}")
        if tuple(init.shape) != (x.shape[1],) or init.device != x.device:
            raise ValueError(f"init must be [{x.shape[1]}] words on "
                             f"{x.device}, got {tuple(init.shape)} on "
                             f"{init.device}")


def transitions_ref(x: torch.Tensor, mask: int = 0xFFFF,
                    init: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane bit-transition counts ``int32[L]`` of words ``[T, L]``
    under ``mask`` (its low 16 bits), the ``init -> x[0]`` edge counted
    (``init`` defaults to zeros)."""
    check_words(x, init)
    return stream_transitions(x, int(mask) & 0xFFFF, init)
