"""Plain float32 forward of DeepSeek-V2-Lite's decoder: the reference of
what the served model computes.

Written from the published model (``deepseek-ai/DeepSeek-V2-Lite``'s
``config.json`` and its modelling code; arXiv:2405.04434): the token
embedding; per layer a pre-norm (RMS, eps 1e-6) Multi-head Latent
Attention without a query latent -- per-head queries of ``qk_nope_head_dim
+ qk_rope_head_dim`` straight from the hidden state, the shared
``kv_lora_rank`` latent (RMS-normed) expanded to per-head keys and values,
a rotary key of ``qk_rope_head_dim`` shared by every head -- with YaRN
RoPE (the inverse frequencies blended between the plain ones and those
over ``factor`` by the linear ramp between the correction dims of
``beta_fast`` and ``beta_slow`` at ``original_max_position_embeddings``;
cos and sin times ``mscale(factor, mscale) / mscale(factor,
mscale_all_dim)``) and the causal softmax scaled by ``(qk_nope_head_dim +
qk_rope_head_dim) ** -0.5`` times ``mscale(factor, mscale_all_dim) ** 2``;
then a pre-norm feed-forward: a gated SiLU MLP of ``intermediate_size`` in
the first ``first_k_dense_replace`` layers, a mixture of experts in the
rest -- the float32 softmax router over ``n_routed_experts``, each token's
``num_experts_per_tok`` largest (greedy; ``norm_topk_prob`` false, the
gates times ``routed_scaling_factor``), each expert's gated SiLU MLP of
``moe_intermediate_size`` computed over the tokens routed to it, with no
capacity, its outputs weighted by the gates and added to their tokens,
and the ``n_shared_experts`` shared experts as one gated MLP of
``n_shared_experts * moe_intermediate_size`` added to every token;
residual adds unscaled; a final RMS norm and the untied head. Departures
from the published model, which the port shares: the rotary part's halves
rotated where the published code de-interleaves its pairs first (a fixed
permutation of the rotary projections' columns), and the query and the
rotary key as separate projections of the hidden state (the published
``kv_a_proj_with_mqa`` holds the latent and the rotary key in one matrix).

Every product runs in float32 with TF32 off, each layer's bfloat16
weights widened as it runs. ``lowp="fp8"`` is the control: both operands
of every product (the router's too) rounded to float8 e4m3 (per-tensor
scale), the next precision below the served bfloat16.

This file is also where the serving harness finds everything else that
is particular to this architecture (the configuration's ``reference``
key names it): the port's architecture as plain keywords
(:func:`port_arch`), the weights drawn from the seed (:func:`init_params`),
the products of a decode step that run through the gated row matmul
(:func:`decode_products`), the parameters a token's forward multiplies
(:func:`matmul_params`), the accountant's monitored weights
(:func:`accountant_sites`) and its embedding scale (:func:`embed_scale`);
and for the expert kernel's readers, its launches a forward
(:func:`expert_launches`) and the bytes and FLOPs of a forward's routed
products (:func:`expert_step`). None of it imports the port.
"""
from __future__ import annotations

import contextlib
import math

import torch

F8_MAX = 448.0


# ------------------------------------------------------- the architecture
def _n_dense(cfg: dict) -> int:
    return int(cfg["first_k_dense_replace"])


def _n_moe(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - _n_dense(cfg)


def port_arch(cfg: dict) -> dict:
    """The port's ``ArchConfig`` of this configuration, as plain keywords
    (nested groups as dicts): what the serving driver builds the engine
    from. The dense first layers are the unrolled head, the MoE layers the
    repeated pattern; the power accountant streams layer 0, the block
    ``accountant.py`` streams."""
    rs = cfg["rope_scaling"]
    return dict(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head=("mla+mlp",) * _n_dense(cfg), pattern=("mla+moe",),
        mla=dict(kv_lora_rank=cfg["kv_lora_rank"],
                 q_lora_rank=cfg["q_lora_rank"] or 0,
                 qk_nope_head_dim=cfg["qk_nope_head_dim"],
                 qk_rope_head_dim=cfg["qk_rope_head_dim"],
                 v_head_dim=cfg["v_head_dim"]),
        moe=dict(num_experts=cfg["n_routed_experts"],
                 top_k=cfg["num_experts_per_tok"],
                 expert_ff=cfg["moe_intermediate_size"],
                 num_shared=cfg["n_shared_experts"],
                 shared_ff=(cfg["n_shared_experts"]
                            * cfg["moe_intermediate_size"]),
                 dropless=True),
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        rope_scaling=dict(
            factor=float(rs["factor"]),
            original_max_position_embeddings=int(
                rs["original_max_position_embeddings"]),
            beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
            mscale=float(rs["mscale"]),
            mscale_all_dim=float(rs["mscale_all_dim"])),
        monitor_block=0)


def _draw(shape, std, gen, dtype=torch.bfloat16):
    """Normal draws of ``shape`` times ``std``, one generator call a
    leading index where the tensor holds 2**31 elements or more."""
    out = torch.empty(shape, device=gen.device, dtype=dtype)
    parts = [out] if out.numel() < 2 ** 31 else list(out)
    for t in parts:
        t.normal_(generator=gen)
    return out.mul_(std)


def init_params(cfg: dict, gen: torch.Generator) -> dict:
    """The weights from the seed on ``gen``'s device, in the layout of
    ``repro_torch.models.lm.init_model`` (a dense MLA block, then MLA +
    MoE blocks; the untied head ``unembed [D, V]``) and its scales, every
    matrix bfloat16 (the served dtype) but the router, float32 as the
    port reads it, and every norm scale float32 ones: one draw per kind of
    weight across all layers (experts ``[layers, E, D, F]``), each layer a
    view of it. The embedding's scale is the configuration's
    ``init.embed_std``. The program and this reference are handed the same
    tensors."""
    dev = gen.device
    L, D, H = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["num_attention_heads"]
    V, F_ = cfg["vocab_size"], cfg["intermediate_size"]
    r = cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    nd, nm = _n_dense(cfg), _n_moe(cfg)
    E, Fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    Fs = cfg["n_shared_experts"] * Fe

    attn = {"wq": ((D, H, dn + dr), D ** -0.5),
            "w_dkv": ((D, r), D ** -0.5), "w_kr": ((D, dr), D ** -0.5),
            "w_uk": ((r, H, dn), r ** -0.5), "w_uv": ((r, H, dv), r ** -0.5),
            "wo": ((H * dv, D), (H * dv) ** -0.5)}
    mixer = {k: _draw((L,) + shape, std, gen)
             for k, (shape, std) in attn.items()}
    dense = {k: _draw((nd,) + shape, std, gen) for k, (shape, std) in {
        "up": ((D, F_), D ** -0.5), "gate": ((D, F_), D ** -0.5),
        "down": ((F_, D), F_ ** -0.5)}.items()}
    moe = {"router": _draw((nm, D, E), D ** -0.5, gen, torch.float32),
           "w_gate": _draw((nm, E, D, Fe), D ** -0.5, gen),
           "w_up": _draw((nm, E, D, Fe), D ** -0.5, gen),
           "w_down": _draw((nm, E, Fe, D), Fe ** -0.5, gen)}
    shared = {k: _draw((nm,) + shape, std, gen) for k, (shape, std) in {
        "up": ((D, Fs), D ** -0.5), "gate": ((D, Fs), D ** -0.5),
        "down": ((Fs, D), Fs ** -0.5)}.items()}

    def ones(n):
        return torch.ones(n, device=dev)

    layers = []
    for i in range(L):
        mx = {k: mixer[k][i] for k in attn}
        mx["kv_norm"] = {"scale": ones(r)}
        if i < nd:
            ffn = {k: dense[k][i] for k in dense}
        else:
            ffn = {k: moe[k][i - nd] for k in moe}
            ffn["shared"] = {k: shared[k][i - nd] for k in shared}
        layers.append({"norm1": {"scale": ones(D)}, "mixer": mx,
                       "norm2": {"scale": ones(D)}, "ffn": ffn})
    embed_std = float(cfg.get("init", {}).get("embed_std", 1.0))
    return {"embed": _draw((V, D), embed_std, gen), "layers": layers,
            "final_norm": {"scale": ones(D)},
            "unembed": _draw((D, V), D ** -0.5, gen)}


def decode_products(cfg: dict) -> list[tuple[int, int]]:
    """``(K, N)`` of every product the decode step runs through the gated
    row matmul (K2), in launch order: per layer the latent and rotary key
    projections and the output projection (the query projection is an
    einsum), then the dense MLP's up, gate and down, or the shared
    experts' (the router's product and the routed experts' are not K2's);
    then the head."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    attn = [(D, cfg["kv_lora_rank"]), (D, cfg["qk_rope_head_dim"]),
            (H * cfg["v_head_dim"], D)]
    Fs = cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    out = []
    for i in range(cfg["num_hidden_layers"]):
        F_ = cfg["intermediate_size"] if i < _n_dense(cfg) else Fs
        out += attn + [(D, F_), (D, F_), (F_, D)]
    return out + [(D, cfg["vocab_size"])]


def matmul_params(cfg: dict) -> float:
    """Parameters of every product of a token's forward (its active
    parameters): the layers' projections (the per-head latent expansions
    included), the dense MLP or the router, the ``num_experts_per_tok``
    routed experts a token takes and the shared experts, and the head."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    r = cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    attn = (D * H * (dn + dr) + D * r + D * dr + r * H * dn + r * H * dv
            + H * dv * D)
    Fe = cfg["moe_intermediate_size"]
    moe = (D * cfg["n_routed_experts"]
           + 3 * D * Fe * (cfg["num_experts_per_tok"]
                           + cfg["n_shared_experts"]))
    return float(attn * cfg["num_hidden_layers"]
                 + 3 * D * cfg["intermediate_size"] * _n_dense(cfg)
                 + moe * _n_moe(cfg) + D * cfg["vocab_size"])


def expert_launches(cfg: dict) -> int:
    """K8's launches a forward: two a MoE layer (gate and up, then
    down)."""
    return 2 * _n_moe(cfg)


def expert_step(cfg: dict, tokens: int, touched: int | None = None
                ) -> tuple[float, float]:
    """``(bytes, flops)`` of the routed experts' products over the MoE
    layers for ``tokens`` tokens (K8's two launches a layer): each touched
    expert's three bfloat16 weights read once (``touched`` experts a
    layer, all of them by default), the routed rows in and out of both
    launches, and ``2 x tokens x num_experts_per_tok x 3 x D x F``
    FLOPs."""
    D, Fe = cfg["hidden_size"], cfg["moe_intermediate_size"]
    E = cfg["n_routed_experts"]
    pairs = tokens * cfg["num_experts_per_tok"]
    touched = E if touched is None else touched
    nbytes = 2.0 * (3 * touched * D * Fe + 2 * pairs * (D + Fe))
    return nbytes * _n_moe(cfg), 2.0 * pairs * 3 * D * Fe * _n_moe(cfg)


def accountant_sites(cfg: dict) -> list[tuple[int, int]]:
    """``(K, N)`` of the accountant's monitored weights: the first block's
    query projection ``wq`` (``[D, H (dn + dr)]``) and its MLP's ``up``."""
    D = cfg["hidden_size"]
    return [(D, cfg["num_attention_heads"] * (cfg["qk_nope_head_dim"]
                                              + cfg["qk_rope_head_dim"])),
            (D, cfg["intermediate_size"])]


def embed_scale(cfg: dict) -> float:
    """What the embedded rows are multiplied by: nothing."""
    return 1.0


# ------------------------------------------------------------ the forward
def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp_min(1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Mat:
    """Products in float32, or with both operands in float8 (control)."""

    def __init__(self, lowp: str | None):
        if lowp not in (None, "fp8"):
            raise ValueError(f"unknown precision {lowp!r}")
        self.q = _fp8 if lowp == "fp8" else (lambda t: t)

    def w(self, t: torch.Tensor) -> torch.Tensor:
        return self.q(t.to(torch.float32))

    def mm(self, x, w):
        return self.q(x) @ w

    def ein(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def _rms(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * scale.float()


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim: int, base: float, rs: dict,
                  device=None) -> torch.Tensor:
    """YaRN's inverse frequencies ``[dim // 2]``, as the published
    ``DeepseekV2YarnRotaryEmbedding`` computes them."""
    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    pows = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) / dim)
    extra, inter = 1.0 / pows, 1.0 / (rs["factor"] * pows)
    mask = 1.0 - torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                           device=device) - low)
                             / (high - low), 0, 1)
    return inter * (1 - mask) + extra * mask


def _rope(x, pos, base, rs):
    d = x.shape[-1]
    ang = pos[:, None].float() * yarn_inv_freq(d, base, rs, x.device)
    m = (yarn_mscale(rs["factor"], rs["mscale"])
         / yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
    cos = (torch.cos(ang) * m)[:, None, :]
    sin = (torch.sin(ang) * m)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _mlp(m: _Mat, h, f):
    g = m.mm(h, m.w(f["gate"]))
    return m.mm(torch.nn.functional.silu(g) * m.mm(h, m.w(f["up"])),
                m.w(f["down"]))


def _moe(m: _Mat, h, f, cfg):
    """The routed experts over the tokens routed to each (no capacity),
    weighted by the softmax gates, plus the shared experts."""
    probs = torch.softmax(m.mm(h, m.w(f["router"])), dim=-1)
    gates, idx = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    gates = gates * float(cfg["routed_scaling_factor"])
    out = torch.zeros_like(h)
    for e in range(f["w_gate"].shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        g = m.mm(x, m.w(f["w_gate"][e]))
        y = m.mm(torch.nn.functional.silu(g) * m.mm(x, m.w(f["w_up"][e])),
                 m.w(f["w_down"][e]))
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out + _mlp(m, h, f["shared"])


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: list[int], at: list[int],
           lowp: str | None = None, block: int = 1024) -> torch.Tensor:
    """float32 logits ``[len(at), V]`` at positions ``at`` of the causal
    forward over ``tokens`` (one sequence, positions from 0)."""
    m = _Mat(lowp)
    dev = params["embed"].device
    H = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    base, rs = float(cfg["rope_theta"]), cfg["rope_scaling"]
    ms = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    scale = (dn + dr) ** -0.5 * ms * ms
    toks = torch.tensor(tokens, device=dev)
    S = toks.shape[0]
    pos = torch.arange(S, device=dev)
    with _no_tf32():
        x = params["embed"][toks].float()
        causal = pos[None, :] <= pos[:, None]               # [S(q), S(k)]
        for i, lp in enumerate(params["layers"]):
            p = lp["mixer"]
            h = _rms(x, lp["norm1"]["scale"])
            q = m.ein("sd,dhe->she", h, m.w(p["wq"]))
            q_nope, q_rope = q[..., :dn], _rope(q[..., dn:], pos, base, rs)
            ckv = _rms(m.mm(h, m.w(p["w_dkv"])), p["kv_norm"]["scale"])
            kr = _rope(m.mm(h, m.w(p["w_kr"]))[:, None, :], pos, base, rs)
            k_nope = m.ein("sr,rhe->she", ckv, m.w(p["w_uk"]))
            v = m.ein("sr,rhe->she", ckv, m.w(p["w_uv"]))
            out = torch.empty((S, H, dv), device=dev)
            for lo in range(0, S, block):       # query blocks bound memory
                hi = min(S, lo + block)
                sc = (m.ein("qhe,khe->hqk", q_nope[lo:hi], k_nope)
                      + m.ein("qhe,ke->hqk", q_rope[lo:hi], kr[:, 0]))
                sc = (sc * scale).masked_fill(~causal[lo:hi][None],
                                              float("-inf"))
                out[lo:hi] = m.ein("hqk,khe->qhe", torch.softmax(sc, -1), v)
            x = x + m.mm(out.reshape(S, H * dv), m.w(p["wo"]))
            h = _rms(x, lp["norm2"]["scale"])
            f = lp["ffn"]
            x = x + (_mlp(m, h, f) if i < _n_dense(cfg)
                     else _moe(m, h, f, cfg))
        h = _rms(x[torch.tensor(at, device=dev)],
                 params["final_norm"]["scale"])
        return m.mm(h, m.w(params["unembed"]))
