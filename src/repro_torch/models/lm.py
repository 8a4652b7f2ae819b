"""Language-model wrapper: weights, embeddings, the output head, and the
step builders the serving engine runs (slot prefill, paged chunk
prefill, embedding for the power accountant, decode).

Two weight trees: ``params``, the float32 masters (:func:`init_model`,
or :func:`repro_torch.models.convert.params_from_jax`), which the power
accountant streams as the JAX package does; and the compute weights of
:func:`compute_weights`, cast once to the config's compute dtype, which
the steps run on. The JAX package casts ``p.astype(x.dtype)`` on every
call; a cast once gives the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.trace import interpret

from . import layers as L
from . import matmul as mm
from . import transformer as T
from .config import ArchConfig


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ----------------------------------------------------------------- params
def init_model(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random float32 masters drawn from ``gen``, on its device:
    ``{"embed": [V, D], "layers": [block, ...], "final_norm": {"scale"}}``
    plus ``"unembed": [D, V]`` when the embeddings are not tied."""
    p = {"embed": L.normal_init((cfg.vocab, cfg.d_model), 1.0, gen),
         "layers": [T.make_block(cfg, spec, gen)
                    for spec in cfg.block_specs],
         "final_norm": {"scale": L.scale_param(cfg.d_model, gen)}}
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_param(cfg.d_model, cfg.vocab, gen)
    return p


def compute_weights(params: dict, cfg: ArchConfig) -> dict:
    """The weights the steps run on: matmul weights, biases and the
    embedding in the compute dtype (norm scales and an MoE's router stay
    float32, as the JAX package reads them), plus ``"head"``, the output
    projection ``[D, V]`` made contiguous (the tied ``embed.T`` or
    ``unembed``)."""
    dt = compute_dtype(cfg)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v if k == "router" else v.to(dt))
                for k, v in tree.items()}

    layers = [{"norm1": p["norm1"], "norm2": p["norm2"],
               "mixer": cast(p["mixer"]), "ffn": cast(p["ffn"])}
              for p in params["layers"]]
    embed = params["embed"].to(dt)
    head = embed.T if cfg.tie_embeddings else params["unembed"].to(dt)
    return {"embed": embed, "layers": layers,
            "final_norm": params["final_norm"], "head": head.contiguous()}


# ------------------------------------------------------------------ embed
def embed_inputs(embed: torch.Tensor, cfg: ArchConfig, tokens: torch.Tensor,
                 positions: torch.Tensor | None = None):
    """``(x [B, S, D], positions [B, S])`` from ``tokens [B, S]``, in the
    dtype of the ``embed`` table given."""
    b, s = tokens.shape
    x = embed[tokens]
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    return x * L.weak(cfg.emb_mult, x.dtype), positions


def logits_fn(weights: dict, cfg: ArchConfig, h: torch.Tensor,
              backend: str | None = None) -> torch.Tensor:
    """``h [..., D] -> float32 logits [..., V]``, the head's matmul
    through :func:`.matmul.matmul`."""
    with interpret.scope("lm_head"):
        out = mm.matmul(h, weights["head"], backend)
    out = out.float() * cfg.logit_mult
    if cfg.logit_softcap > 0:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    return out


def apply_model(weights: dict, cfg: ArchConfig, tokens, positions=None, *,
                states=None, prefill=False, cache_len=0, pages=None,
                backend=None):
    """Forward to the final hidden states: ``(h [B, S, D], states,
    aux)``, ``aux`` the MoE layers' load-balancing losses summed (a
    float32 zero for a dense model), as the JAX package's
    ``apply_model`` returns them. Serving and tracing ignore ``aux``."""
    with interpret.scope("embed"):
        x, positions = embed_inputs(weights["embed"], cfg, tokens, positions)
    x, states, aux = T.apply_stack(
        weights["layers"], x, cfg, positions=positions, states=states,
        prefill=prefill, cache_len=cache_len, pages=pages, backend=backend)
    return L.rms_norm(x, weights["final_norm"]["scale"]), states, aux


# ----------------------------------------------------------- step builders
def make_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype: torch.dtype, device) -> list:
    """Zeroed per-layer ``(k_cache, v_cache)`` decode states, each
    ``[batch, cache_len, Hkv, D]``. The paged engine's page pools are the
    same call with ``batch = num_pages`` and ``cache_len = page_size``:
    ``[P, ps, Hkv, D]`` per layer."""
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in cfg.block_specs]


def make_slot_prefill_step(cfg: ArchConfig, cache_len: int):
    """``(weights, tokens [1, S], length) -> (logits [1, V] at position
    length-1, states)`` for a right-padded prompt of bucket length ``S >=
    length``. Right padding is exact by causality: position ``p`` never
    reads positions ``> p``, and every padded cache row is overwritten by
    a decode write before a later step's mask admits it."""
    def slot_prefill_step(weights, tokens, length: int):
        h, states, _ = apply_model(weights, cfg, tokens, prefill=True,
                                   cache_len=cache_len)
        return logits_fn(weights, cfg, h[:, max(length - 1, 0)]), states

    return slot_prefill_step


def make_chunk_prefill_step(cfg: ArchConfig):
    """``(weights, pools, tokens [1, C], positions [1, C], pages [1, MP],
    length, start) -> logits [1, V]``: one chunk of a paged prefill at
    the absolute positions ``start..`` (given on the host too, so no step
    reads the device back). The chunk's K/V go into the row's pages (in
    place) and its attention reads the paged history -- earlier chunks
    and shared prefix pages. Right padding in the last chunk has position
    -1: its writes go to the trash page and its queries are fully masked.
    The logits are taken at the absolute position ``length - 1`` and mean
    something only on the chunk that holds it (the last). Matmuls take
    the plain path, as prefill's do."""
    def chunk_prefill_step(weights, states, tokens, positions, pages,
                           length: int, start: int):
        h, _, _ = apply_model(weights, cfg, tokens, positions,
                              states=states, pages=pages)
        idx = min(max(length - 1 - start, 0), h.shape[1] - 1)
        return logits_fn(weights, cfg, h[:, idx])

    return chunk_prefill_step


def make_embed_step(cfg: ArchConfig):
    """``(embed_bf16, tokens [B, S]) -> x [B, S, D]``: the operand the
    power accountant streams is the embedded input in bfloat16, whatever
    the compute dtype (the JAX package's ``embed_inputs`` default)."""
    def embed_step(embed_bf16, tokens):
        return embed_inputs(embed_bf16, cfg, tokens)[0]

    return embed_step


def make_decode_step(cfg: ArchConfig, backend: str | None = "auto"):
    """``(weights, states, tokens [B, 1], positions [B, 1], pages=None)
    -> logits [B, V]``, the states updated in place. Every projection, MLP
    and lm-head matmul goes through ``backend`` (K2 on the card); with the
    page tables ``pages [B, MP]`` the states are page pools and the
    attention is the paged decode attention (K4 on the card)."""
    mm.check_backend(backend)

    def decode_step(weights, states, tokens, positions, pages=None):
        h, _, _ = apply_model(weights, cfg, tokens, positions,
                              states=states, pages=pages, backend=backend)
        return logits_fn(weights, cfg, h[:, -1], backend)

    return decode_step


def pick_monitor_weights(params: dict, cfg: ArchConfig
                         ) -> list[tuple[str, torch.Tensor]]:
    """The weights the power accountant streams against: the first block
    of the repeated pattern (or the first block, with no pattern
    groups), its ``wq`` and its MLP ``up`` projection -- the JAX
    package's one selection rule (``layer0/wq``, ``layer0/ffn_up``)."""
    blk = params["layers"][len(cfg.head) if cfg.n_groups else 0]
    out = [("layer0/wq", blk["mixer"]["wq"])]
    if "up" in blk.get("ffn", {}):
        out.append(("layer0/ffn_up", blk["ffn"]["up"]))
    return out
