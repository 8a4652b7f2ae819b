"""Language-model wrapper: weights, embeddings, the output heads, the
step builders the serving engine and the tracer run (prefill, slot
prefill, paged chunk prefill, embedding for the power accountant,
decode), and training's loss, train step and power monitor.

Input modalities, as the JAX package's (``cfg.inputs`` names the key of
a batch dict that holds each, :func:`model_input`):

* ``tokens`` -- ``[B, S]`` token ids;
* ``embeds`` -- ``[B, S, D]`` precomputed patch embeddings (Qwen2-VL's
  backbone; the vision frontend is a stub) with M-RoPE positions ``[3,
  B, S]``;
* ``codes`` -- ``[B, K, S]`` EnCodec codes (MusicGen's backbone): the K
  codebook embeddings are summed, and K output heads ``[K, D, V]``
  predict each stream's next code (logits ``[..., K, V]``).

Two weight trees: ``params``, the float32 masters (:func:`init_model`,
or :func:`repro_torch.models.convert.params_from_jax`), which the power
accountant streams as the JAX package does; and the compute weights of
:func:`compute_weights`, cast once to the config's compute dtype, which
the steps run on. The JAX package casts ``p.astype(x.dtype)`` on every
call; a cast once gives the same bits. Training differentiates through
the casts back to the masters, where the number of casts matters: the
tied embedding's lookup and head are two casts, as in the JAX package,
so their cotangents add in float32 (:func:`loss_fn`).
"""
from __future__ import annotations

import torch

from repro_torch.core import monitor as pm_monitor
from repro_torch.core import systolic
from repro_torch.runtime import spans, spmd
from repro_torch.trace import interpret
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from . import layers as L
from . import matmul as mm
from . import transformer as T
from . import xlstm as X
from .config import ArchConfig


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


#: leaves the JAX package reads as float32 from their float32 masters:
#: the MoE router, the RG-LRU's Lambda and the sLSTM's recurrent matrix
#: (norm scales and biases too: every sub-tree named ``*norm*``)
_F32_LEAVES = frozenset({"router", "lambda", "r"})


# ----------------------------------------------------------------- params
def init_model(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random float32 masters drawn from ``gen``, on its device:
    ``{"embed", "layers": [block, ...], "final_norm"}`` plus ``"unembed":
    [D, V]`` for untied token LMs, or ``"heads": [K, D, V]`` for codes.
    ``embed`` is ``[V, D]`` (tokens), ``[K, V, D]`` (codes), or absent
    (embeds)."""
    p = {}
    if cfg.inputs == "tokens":
        p["embed"] = L.normal_init((cfg.vocab, cfg.d_model), 1.0, gen)
    elif cfg.inputs == "codes":
        p["embed"] = L.normal_init((cfg.codebooks, cfg.vocab, cfg.d_model),
                                   1.0, gen)
    p["layers"] = [T.make_block(cfg, spec, gen) for spec in cfg.block_specs]
    p["final_norm"] = L.make_norm(cfg.norm, cfg.d_model, gen)
    if cfg.inputs == "codes":
        p["heads"] = L.normal_init((cfg.codebooks, cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5, gen)
    elif not cfg.tie_embeddings:
        p["unembed"] = L.dense_param(cfg.d_model, cfg.vocab, gen)
    return p


# ---------------------------------------------------------- logical axes
def _norm_axes(kind: str) -> dict:
    return {"scale": (None,)} if kind == "rms" else {"scale": (None,),
                                                      "bias": (None,)}


def _mlp_axes(gated: bool = True) -> dict:
    p = {"up": ("embed", "ff")}
    if gated:
        p["gate"] = ("embed", "ff")
    p["down"] = ("ff", "embed")
    return p


def _mixer_axes(cfg: ArchConfig, mixer: str) -> dict:
    conv = {"w": (None, "ff"), "b": ("ff",)}
    if mixer in ("attn", "local"):
        p = {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
             "wv": ("embed", "heads"), "wo": ("heads", "embed")}
        if cfg.qkv_bias:
            p.update(bq=("heads",), bk=("heads",), bv=("heads",))
        return p
    if mixer == "mla":
        p = {"w_dkv": ("embed", None), "kv_norm": _norm_axes("rms"),
             "w_kr": ("embed", None), "w_uk": (None, "heads", None),
             "w_uv": (None, "heads", None), "wo": ("heads", "embed")}
        if cfg.mla.q_lora_rank:
            p.update(w_dq=("embed", None), q_norm=_norm_axes("rms"),
                     w_uq=(None, "heads", None))
        else:
            p["wq"] = ("embed", "heads", None)
        return p
    if mixer == "rglru":
        return {"in_x": ("embed", "ff"), "in_gate": ("embed", "ff"),
                "conv": conv,
                "rglru": {"w_a": ("ff", None), "b_a": (None,),
                          "w_x": ("ff", None), "b_x": (None,),
                          "lambda": (None,)},
                "out": ("ff", "embed")}
    if mixer == "mlstm":
        return {"up": ("embed", "ff"), "up_gate": ("embed", "ff"),
                "conv": conv, "wq": ("ff", None), "wk": ("ff", None),
                "wv": (None, "heads_ff"), "wi": ("ff", None),
                "wf": ("ff", None), "bi": (None,), "bf": (None,),
                "skip_scale": (None,), "norm": _norm_axes("rms"),
                "down": ("ff", "embed")}
    if mixer == "slstm":
        return {"conv": conv, "w": ("embed", "ff"),
                "r": ("heads", None, None), "b": (None,),
                "norm": _norm_axes("rms"), "up": ("embed", "ff"),
                "down": ("ff", "embed")}
    raise ValueError(mixer)


def _block_axes(cfg: ArchConfig, spec: str) -> dict:
    mixer, ffn = T.parse_spec(spec)
    p = {"norm1": _norm_axes(cfg.norm), "mixer": _mixer_axes(cfg, mixer)}
    if ffn == "moe":
        p["norm2"] = _norm_axes(cfg.norm)
        p["ffn"] = {"router": ("embed", None),
                    "w_gate": ("expert", "embed", "ff"),
                    "w_up": ("expert", "embed", "ff"),
                    "w_down": ("expert", "ff", "embed")}
        if cfg.moe.num_shared:
            p["ffn"]["shared"] = _mlp_axes()
    elif ffn != "none":
        p["norm2"] = _norm_axes(cfg.norm)
        p["ffn"] = _mlp_axes(cfg.mlp_gated)
    return p


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every leaf of :func:`init_model`'s tree, a
    tuple per leaf in the same dict layout: the axes the JAX package's
    ``Param`` s carry (``"embed"``, ``"vocab"``, ``"heads"``, ``"ff"``,
    ``"heads_ff"``, ``"expert"``, or ``None``), which
    :mod:`repro_torch.runtime.sharding` resolves against a mesh. The JAX
    package's scanned groups carry a leading ``"layers"`` axis, never
    sharded; the port's unstacked layers have none. The AdamW moments
    follow the same tree."""
    p = {}
    if cfg.inputs == "tokens":
        p["embed"] = ("vocab", "embed")
    elif cfg.inputs == "codes":
        p["embed"] = (None, "vocab", "embed")
    p["layers"] = [_block_axes(cfg, spec) for spec in cfg.block_specs]
    p["final_norm"] = _norm_axes(cfg.norm)
    if cfg.inputs == "codes":
        p["heads"] = (None, "embed", "vocab")
    elif not cfg.tie_embeddings:
        p["unembed"] = ("embed", "vocab")
    return p


def weight_axes(cfg: ArchConfig, head: bool = True) -> dict:
    """:func:`param_axes` laid out as :func:`compute_weights`' tree:
    ``"head"`` the output projection (``embed.T``, ``unembed`` or the
    codes heads), no ``"unembed"``/``"heads"``."""
    ax = param_axes(cfg)
    out = {"layers": ax["layers"], "final_norm": ax["final_norm"]}
    if "embed" in ax:
        out["embed"] = ax["embed"]
    if head:
        out["head"] = (ax["heads"] if cfg.inputs == "codes"
                       else ax["embed"][::-1] if cfg.tie_embeddings
                       else ax["unembed"])
    return out


def compute_weights(params: dict, cfg: ArchConfig, head: bool = True
                    ) -> dict:
    """The weights the steps run on: every leaf in the compute dtype but
    norm scales and biases (every ``norm`` sub-tree) and the leaves of
    :data:`_F32_LEAVES`, which stay float32 as the JAX package reads
    them; plus ``"head"``, the output projection made contiguous (the
    tied ``embed.T``, ``unembed``, or the codes heads ``[K, D, V]``).
    The casts are differentiable: :func:`loss_fn` runs on these weights
    without the head (``head=False``) and casts the head once a use, as
    the JAX package does."""
    dt = compute_dtype(cfg)

    def cast(tree):
        return {k: (v if "norm" in k or k in _F32_LEAVES
                    else cast(v) if isinstance(v, dict) else v.to(dt))
                for k, v in tree.items()}

    out = {"layers": [cast(p) for p in params["layers"]],
           "final_norm": params["final_norm"]}
    if "embed" in params:
        out["embed"] = params["embed"].to(dt)
    if not head:
        return out
    if cfg.inputs == "codes":
        head = params["heads"].to(dt)
    else:
        head = (out["embed"].T if cfg.tie_embeddings
                else params["unembed"].to(dt))
    out["head"] = head.contiguous()
    return out


# ------------------------------------------------------------------ embed
def model_input(cfg: ArchConfig, batch: dict):
    """``(input, positions)`` of a batch dict laid out as the JAX
    package's (``{"tokens"}``, ``{"embeds", "positions"}`` or
    ``{"codes"}``, positions optional but for embeds)."""
    return batch[cfg.inputs], batch.get("positions")


def embed_inputs(embed: torch.Tensor | None, cfg: ArchConfig,
                 inputs: torch.Tensor, positions: torch.Tensor | None = None,
                 dtype: torch.dtype | None = None):
    """``(x [B, S, D], positions)`` from the model input (see the module
    doc), in the dtype of the ``embed`` table given (``dtype`` for
    embeds, which have none). Codes sum their K codebook embeddings in
    float32 and round once, as XLA sums bf16 on the CPU, then add the
    sinusoidal positions rounded to that dtype."""
    b, s = inputs.shape[0], inputs.shape[-1 if cfg.inputs == "codes" else 1]
    if positions is None:
        positions = torch.arange(s, device=inputs.device).expand(b, s)
    if cfg.inputs == "embeds":
        x = inputs.to(dtype)
    elif cfg.inputs == "codes":
        x = torch.stack([embed[i][inputs[:, i]]
                         for i in range(inputs.shape[1])], dim=1)
        x = x.float().sum(dim=1).to(embed.dtype)          # [B, S, D]
        if cfg.pos == "sinusoidal":
            x = x + L.sinusoidal_positions(positions,
                                           cfg.d_model).to(x.dtype)
    elif spmd.is_dist(embed):
        x = spmd.embedding(embed, inputs)
    else:
        x = embed[inputs]
    return x * L.weak(cfg.emb_mult, x.dtype), positions


def logits_fn(weights: dict, cfg: ArchConfig, h: torch.Tensor,
              backend: str | None = None) -> torch.Tensor:
    """``h [..., D] -> float32 logits [..., V]`` (``[..., K, V]`` for
    codes): the token head's matmul through :func:`.matmul.matmul`, the
    codes heads' einsum plain (as the JAX package's never takes the gated
    kernel)."""
    with interpret.scope("lm_head"), spans.span("model.head"):
        if cfg.inputs == "codes":
            out = interpret.einsum("...d,kdv->...kv", h, weights["head"])
        else:
            out = mm.matmul(h, weights["head"], backend)
    out = out.float() * cfg.logit_mult
    if cfg.logit_softcap > 0:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    return out


def _id(a):
    return a


def apply_model(weights: dict, cfg: ArchConfig, inputs, positions=None, *,
                states=None, prefill=False, cache_len=0, pages=None,
                backend=None, expert_backend=None, constrain=_id):
    """Forward to the final hidden states: ``(h [B, S, D], states,
    aux)``, ``aux`` the MoE layers' load-balancing losses summed (a
    float32 zero for a dense model), as the JAX package's
    ``apply_model`` returns them. ``inputs`` is the model input (see the
    module doc). Serving and tracing ignore ``aux``. ``expert_backend``
    reaches a dropless MoE's routed products (None: ``backend``; see
    :mod:`repro_torch.models.moe`). ``constrain`` (a
    passthrough by default; :func:`repro_torch.runtime.sharding.
    make_constrain` on a mesh) pins the residual stream where the JAX
    package pins it."""
    with interpret.scope("embed"), spans.span("model.embed"):
        x, positions = embed_inputs(weights.get("embed"), cfg, inputs,
                                    positions, compute_dtype(cfg))
    x = constrain(x)
    x, states, aux = T.apply_stack(
        weights["layers"], x, cfg, positions=positions, states=states,
        prefill=prefill, cache_len=cache_len, pages=pages, backend=backend,
        expert_backend=expert_backend, constrain=constrain)
    with spans.span("model.norm"):
        x = L.apply_norm(cfg.norm, weights["final_norm"], x)
    return x, states, aux


# ----------------------------------------------------------- step builders
def make_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype: torch.dtype, device) -> list:
    """Zeroed per-layer decode states, as the JAX package's
    ``make_decode_state`` builds them: ``(k_cache, v_cache)`` ``[batch,
    cache_len, Hkv, D]`` (``attn``); the ring ``(k, v [batch, window, Hkv,
    D], slots [batch, window] of -1)`` (``local``); the latent cache
    ``(ckv [batch, cache_len, r], kr [batch, cache_len, dr])`` (``mla``);
    ``(conv_buf, h)`` (``rglru``), ``(conv_buf, (C, n, m))`` (``mlstm``)
    and ``(conv_buf, (c, n, h, m))`` (``slstm``), the conv buffers in
    ``dtype`` and the recurrent states float32. The paged engine's page
    pools are the same call with ``batch = num_pages`` and ``cache_len =
    page_size``: ``[P, ps, Hkv, D]`` per layer."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    f32 = torch.float32

    def block_state(spec: str):
        mixer = T.parse_spec(spec)[0]
        kv, hd = cfg.n_kv_heads, cfg.hd
        if mixer == "attn":
            return (zeros(batch, cache_len, kv, hd),
                    zeros(batch, cache_len, kv, hd))
        if mixer == "local":
            w = cfg.window
            return (zeros(batch, w, kv, hd), zeros(batch, w, kv, hd),
                    torch.full((batch, w), -1, dtype=torch.int32,
                               device=device))
        if mixer == "mla":
            return (zeros(batch, cache_len, cfg.mla.kv_lora_rank),
                    zeros(batch, cache_len, cfg.mla.qk_rope_head_dim))
        if mixer == "rglru":
            w = cfg.rglru.lru_width or cfg.d_model
            return (zeros(batch, cfg.rglru.conv_width - 1, w),
                    zeros(batch, w, dt=f32))
        x = cfg.xlstm
        if mixer == "mlstm":
            di = int(cfg.d_model * x.mlstm_proj_factor)
            dh = di // x.heads
            return (zeros(batch, x.conv_width - 1, di),
                    (zeros(batch, x.heads, dh, dh, dt=f32),
                     zeros(batch, x.heads, dh, dt=f32),
                     zeros(batch, x.heads, dt=f32)))
        if mixer == "slstm":
            dh = cfg.d_model // x.heads
            return (zeros(batch, x.conv_width - 1, cfg.d_model),
                    X.slstm_state_init(batch, x.heads, dh, device))
        raise ValueError(mixer)

    return [block_state(spec) for spec in cfg.block_specs]


def make_prefill_step(cfg: ArchConfig, cache_len: int, constrain=_id):
    """``(weights, inputs, positions=None) -> (logits at the last
    position, states)``: a prefill at the input's own length."""
    def prefill_step(weights, inputs, positions=None):
        h, states, _ = apply_model(weights, cfg, inputs, positions,
                                   prefill=True, cache_len=cache_len,
                                   constrain=constrain)
        return logits_fn(weights, cfg, h[:, -1]), states

    return prefill_step


def make_slot_prefill_step(cfg: ArchConfig, cache_len: int,
                           constrain=_id, expert_backend: str | None = None):
    """``(weights, inputs [1, S...], length) -> (logits at position
    length-1, states)`` for a prompt right-padded to a bucket length ``S
    >= length``. Right padding is exact by causality for attention and
    MLA: position ``p`` never reads positions ``> p``, and every padded
    cache row is overwritten by a decode write before a later step's mask
    admits it. Recurrent mixers carry state through pad tokens and a
    ``local`` ring can evict real ones: the engine prefills those archs at
    the prompt's exact length. Matmuls take the plain path, and a
    dropless MoE's routed products ``expert_backend`` (the engine's kernel
    backend: K8 on the card)."""
    def slot_prefill_step(weights, inputs, length: int):
        h, states, _ = apply_model(weights, cfg, inputs, prefill=True,
                                   cache_len=cache_len,
                                   expert_backend=expert_backend,
                                   constrain=constrain)
        return logits_fn(weights, cfg, h[:, max(length - 1, 0)]), states

    return slot_prefill_step


def make_chunk_prefill_step(cfg: ArchConfig, constrain=_id,
                            expert_backend: str | None = None):
    """``(weights, pools, tokens [1, C], positions [1, C], pages [1, MP],
    length, start) -> logits [1, V]``: one chunk of a paged prefill at
    the absolute positions ``start..`` (given on the host too, so no step
    reads the device back). The chunk's K/V go into the row's pages (in
    place) and its attention reads the paged history -- earlier chunks
    and shared prefix pages. Right padding in the last chunk has position
    -1: its writes go to the trash page and its queries are fully masked.
    The logits are taken at the absolute position ``length - 1`` and mean
    something only on the chunk that holds it (the last). Matmuls take
    the plain path, as prefill's do, and a dropless MoE's routed products
    ``expert_backend``."""
    def chunk_prefill_step(weights, states, tokens, positions, pages,
                           length: int, start: int):
        h, _, _ = apply_model(weights, cfg, tokens, positions,
                              states=states, pages=pages,
                              expert_backend=expert_backend,
                              constrain=constrain)
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


def make_decode_step(cfg: ArchConfig, backend: str | None = "auto",
                     constrain=_id):
    """``(weights, states, inputs [B, 1...], positions, pages=None) ->
    logits [B, V]`` (``[B, K, V]`` for codes), the states updated in
    place. The projections, MLPs and token head the JAX package runs
    through its backend go through ``backend`` (K2 on the card); with the
    page tables ``pages [B, MP]`` the states are page pools and the
    attention is the paged decode attention (K4 on the card)."""
    mm.check_backend(backend)

    def decode_step(weights, states, inputs, positions, pages=None):
        h, _, _ = apply_model(weights, cfg, inputs, positions,
                              states=states, pages=pages, backend=backend,
                              constrain=constrain)
        return logits_fn(weights, cfg, h[:, -1], backend)

    return decode_step


#: the mixer weights the power accountant may stream, in the JAX
#: package's order of preference
MONITOR_WEIGHTS = ("wq", "in_x", "up", "w_dkv")


def pick_monitor_weights(params: dict, cfg: ArchConfig
                         ) -> list[tuple[str, torch.Tensor]]:
    """The weights the power accountant streams against -- the JAX
    package's one selection rule: the first block of the repeated pattern
    (or of the unrolled head or tail when there are no pattern groups),
    the first of :data:`MONITOR_WEIGHTS` its mixer has (a 3-D weight
    flattened to ``[K, rest]``) as ``layer0/<name>``, then its FFN's
    ``up`` projection as ``layer0/ffn_up`` when it has one. A config's
    ``monitor_block`` (0 or more) names the block instead."""
    i = (cfg.monitor_block if cfg.monitor_block >= 0
         else len(cfg.head) if cfg.n_groups else 0)
    blk = params["layers"][i]
    out = []
    for name in MONITOR_WEIGHTS:
        if name in blk["mixer"]:
            w = blk["mixer"][name]
            out.append((f"layer0/{name}", w.reshape(w.shape[0], -1)))
            break
    if "up" in blk.get("ffn", {}):
        out.append(("layer0/ffn_up", blk["ffn"]["up"]))
    return out


# -------------------------------------------------------------------- loss
def _head_weights(params: dict, cfg: ArchConfig, dtype: torch.dtype
                  ) -> torch.Tensor:
    """The output projection cast from its float32 master: one cast a
    use, as the JAX package's ``_head_weights``. A tied head is its own
    cast of ``embed``, apart from the lookup's, so the two cotangents
    meet in float32."""
    if cfg.inputs == "codes":
        return params["heads"].to(dtype)
    if cfg.tie_embeddings:
        return params["embed"].to(dtype).T
    return params["unembed"].to(dtype)


def _chunked_ce(params: dict, cfg: ArchConfig, h: torch.Tensor,
                targets: torch.Tensor, mask: torch.Tensor,
                chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy over ``h [B, S, D]`` in chunks of
    ``min(chunk, S)`` positions (the last zero-padded), so no ``[B, S,
    V]`` logits live at once: ``targets [B, S]`` (``[B, K, S]`` for
    codes, whose per-position CE is the mean over the K codebooks),
    ``mask [B, S]`` float32. The head is cast in each chunk, the
    log-sum-exp taken in float32, and the label logit gathered (no ``[..,
    V]`` one-hot)."""
    b, s, _ = h.shape
    c = min(chunk, s)
    nb = -(-s // c)
    pad = nb * c - s
    if pad:
        h = spmd.pad(h, (0, 0, 0, pad))
        mask = spmd.pad(mask, (0, pad))
        targets = spmd.pad(targets, (0, pad))
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(nb):
        hc = h[:, i * c:(i + 1) * c]
        tc = targets[..., i * c:(i + 1) * c]
        mc = mask[:, i * c:(i + 1) * c]
        lg = logits_fn({"head": _head_weights(params, cfg, hc.dtype)}, cfg,
                       hc)                         # [B,c,V] or [B,c,K,V]
        lse = torch.logsumexp(lg, dim=-1)
        if cfg.inputs == "codes":
            tc = tc.movedim(1, -1)                 # [B, c, K]
        # on a mesh the gather reads the whole vocab: DTensor's masked
        # vocab-shard gather does not reduce this shape
        lab = spmd.unshard_dims(lg, (lg.ndim - 1,)).gather(
            -1, tc[..., None].long())[..., 0]
        ce = lse - lab
        if cfg.inputs == "codes":
            ce = ce.sum(-1) / torch.tensor(float(cfg.codebooks),
                                           device=h.device)
        tot = tot + (ce * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, chunk: int = 512,
            constrain=_id):
    """Next-token loss of the float32 masters ``params`` on a JAX-style
    batch (:func:`model_input`; targets from ``tokens``, ``labels`` for
    embeds, or ``codes``, shifted by one; an optional ``mask [B, S]``,
    ones by default): ``(loss, {"loss", "ce", "aux"})`` with ``loss = ce
    + 0.01 * aux``, every value a float32 0-d tensor that carries the
    graph back to ``params``."""
    inputs, positions = model_input(cfg, batch)
    h, _, aux = apply_model(compute_weights(params, cfg, head=False), cfg,
                            inputs, positions, constrain=constrain)
    tokens = batch["labels" if cfg.inputs == "embeds" else cfg.inputs]
    rows = tokens[:, 0] if cfg.inputs == "codes" else tokens
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(rows.shape, device=h.device)
    # on a mesh the head reads whole sequences: gather a sequence-parallel
    # stream once here, before the shift and the chunks slice it
    h = spmd.unshard_dims(h, tuple(range(1, h.ndim)))
    ce = _chunked_ce(params, cfg, h[:, :-1], tokens[..., 1:],
                     mask[:, 1:].float(), chunk)
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------- training
def _split(a: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``n`` along the batch axis: axis 0, or axis 1
    for leading-component leaves such as M-RoPE's ``[3, B, S]``
    positions (the JAX package's rule)."""
    ax = 0 if a.shape[0] % n == 0 else 1
    m = a.shape[ax] // n
    return a.narrow(ax, i * m, m)


def make_train_step(cfg: ArchConfig, optimizer, grad_accum: int = 1,
                    monitor: bool = False, chunk: int = 512, constrain=_id):
    """``(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: gradients of :func:`loss_fn` against the float32 masters
    by ``torch.autograd`` (summed over ``grad_accum`` micro-batches in
    order and divided by their count), ``grad_norm`` over the unclipped
    gradients, the optimiser's update added to the masters (new
    tensors: the arguments are left as they are), and with ``monitor``
    the power metrics of :func:`_monitor_metrics` on the updated
    params. Metrics are float32 0-d tensors on the params' device."""
    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, leaves), cfg,
                                    batch, chunk, constrain)
            grads = torch.autograd.grad(loss, leaves)
        return (tree_unflatten(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(params, opt_state, batch, step):
        device = tree_leaves(params)[0].device
        if grad_accum > 1:
            grads, metrics = None, None
            for i in range(grad_accum):
                g, m = grads_of(params, {k: _split(v, grad_accum, i)
                                         for k, v in batch.items()})
                grads = g if grads is None else tree_map(torch.add, grads, g)
                metrics = (m if metrics is None
                           else tree_map(torch.add, metrics, m))
            n = torch.tensor(float(grad_accum), device=device)
            grads = tree_map(lambda g: g / n, grads)
            metrics = tree_map(lambda m: m / n, metrics)
        else:
            grads, metrics = grads_of(params, batch)
        with torch.no_grad():
            step = torch.as_tensor(step, dtype=torch.int32, device=device)
            updates, opt_state = optimizer.update(grads, opt_state, params,
                                                  step)
            params = tree_map(torch.add, params, updates)
            metrics["grad_norm"] = torch.sqrt(sum(
                torch.sum(torch.square(g.float()))
                for g in tree_leaves(grads)))
        if monitor:
            metrics.update(_monitor_metrics(params, cfg, batch))
        return params, opt_state, metrics

    return train_step


def _monitor_metrics(params: dict, cfg: ArchConfig, batch: dict,
                     backend: str | None = None) -> dict:
    """The paper's PowerMonitor on the training step, as the JAX
    package's: the first 256 embedded rows (bfloat16, as the JAX
    ``embed_inputs`` defaults) against ``w[:, :256]`` of the first
    monitored weight (:func:`pick_monitor_weights`, its float32
    master), streamed through the 128 x 128 MXU-geometry array; keyed
    ``power/<metric>``, the sample sizes left out. ``backend`` picks the
    counter pass (K1 on the card by default)."""
    with torch.no_grad():
        inputs, positions = model_input(cfg, batch)
        embed = params.get("embed")
        x, _ = embed_inputs(None if embed is None else embed.to(
            torch.bfloat16), cfg, inputs, positions, torch.bfloat16)
        # on a mesh the streamed operands are gathered (the counters see
        # the single-device operands, bit for bit)
        x2 = spmd.local(x.reshape(-1, x.shape[-1])[:256])
        w = spmd.local(pick_monitor_weights(params, cfg)[0][1][:, :256])
        mcfg = pm_monitor.MonitorConfig(geometry=systolic.MXU_SA,
                                        backend=backend)
        m = pm_monitor.monitor_matmul(x2, w, mcfg)
    return {f"power/{k}": v for k, v in m.items()
            if k not in pm_monitor.SIZE_KEYS}
