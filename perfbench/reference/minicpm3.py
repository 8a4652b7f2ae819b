"""Plain float32 forward of MiniCPM3's decoder: the reference of what the
served model computes.

Written from the architecture as the port's configuration states it
(``src/repro_torch/configs/minicpm3_4b.py``; the published
``openbmb/MiniCPM3-4B``): the token embedding scaled by ``scale_emb``;
per layer a pre-norm (RMS, eps 1e-6) Multi-head Latent Attention --
queries through the ``q_lora_rank`` latent and its RMS norm, the shared
``kv_lora_rank`` latent (RMS-normed) expanded to per-head keys and
values, a rotary part of ``qk_rope_head_dim`` shared by every head
(RoPE with theta ``rope_theta``, halves rotated), causal softmax scaled
by the query head size -- and a pre-norm gated SiLU MLP, each residual
branch scaled by ``scale_depth / sqrt(num_hidden_layers)``; a final RMS
norm and the tied embedding as the head. Departures from the published
model, which the port shares: no long-context RoPE scaling and no
``dim_model_base`` division of the head's input (the port states neither).

Every product runs in float32 with TF32 off, each layer's bfloat16
weights widened as it runs. ``lowp="fp8"`` is the control: both operands
of every product rounded to float8 e4m3 (per-tensor scale), the next
precision below the served bfloat16.

This file is also where the serving harness finds everything else that
is particular to this architecture (the configuration's ``reference``
key names it), so the driver, the cost functions and the metric readers
stay generic: the port's architecture as plain keywords
(:func:`port_arch`), the weights drawn from the seed (:func:`init_params`),
the products of a decode step (:func:`decode_products`), the parameters
a token's forward multiplies (:func:`matmul_params`), the accountant's
monitored weights (:func:`accountant_sites`) and its embedding scale
(:func:`embed_scale`). None of it imports the port.
"""
from __future__ import annotations

import contextlib
import math

import torch

F8_MAX = 448.0


# ------------------------------------------------------- the architecture
def port_arch(cfg: dict) -> dict:
    """The port's ``ArchConfig`` of this configuration, as plain keywords
    (nested groups as dicts): what the serving driver builds the engine
    from."""
    L = cfg["num_hidden_layers"]
    return dict(
        name=cfg["name"], family="dense", n_layers=L,
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        pattern=("mla+mlp",),
        mla=dict(kv_lora_rank=cfg["kv_lora_rank"],
                 q_lora_rank=cfg["q_lora_rank"],
                 qk_nope_head_dim=cfg["qk_nope_head_dim"],
                 qk_rope_head_dim=cfg["qk_rope_head_dim"],
                 v_head_dim=cfg["v_head_dim"]),
        tie_embeddings=cfg["tie_word_embeddings"],
        emb_mult=float(cfg["scale_emb"]),
        resid_mult=cfg["scale_depth"] / L ** 0.5,
        rope_theta=float(cfg["rope_theta"]))


def init_params(cfg: dict, gen: torch.Generator) -> dict:
    """The weights from the seed on ``gen``'s device, in the layout of
    ``repro_torch.models.lm.init_model`` (an MLA decoder with gated MLPs)
    and its scales, every matrix bfloat16 (the served dtype) and every
    norm scale float32 ones: one draw per kind of weight across all
    layers, each layer a view of it. The embedding's scale is the
    configuration's ``init.embed_std``. The program and this reference
    are handed the same tensors."""
    dev, bf = gen.device, torch.bfloat16
    L, D, H = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["num_attention_heads"]
    F_, V = cfg["intermediate_size"], cfg["vocab_size"]
    r, rq = cfg["kv_lora_rank"], cfg["q_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])

    def draw(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=bf).mul_(std)

    kinds = {
        "w_dq": ((D, rq), D ** -0.5), "w_uq": ((rq, H, dn + dr), rq ** -0.5),
        "w_dkv": ((D, r), D ** -0.5), "w_kr": ((D, dr), D ** -0.5),
        "w_uk": ((r, H, dn), r ** -0.5), "w_uv": ((r, H, dv), r ** -0.5),
        "wo": ((H * dv, D), (H * dv) ** -0.5),
        "up": ((D, F_), D ** -0.5), "gate": ((D, F_), D ** -0.5),
        "down": ((F_, D), F_ ** -0.5)}
    stacked = {k: draw((L,) + shape, std) for k, (shape, std) in kinds.items()}

    def ones(n):
        return torch.ones(n, device=dev)

    layers = []
    for i in range(L):
        mixer = {k: stacked[k][i] for k in
                 ("w_dq", "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo")}
        mixer["q_norm"] = {"scale": ones(rq)}
        mixer["kv_norm"] = {"scale": ones(r)}
        layers.append({"norm1": {"scale": ones(D)}, "mixer": mixer,
                       "norm2": {"scale": ones(D)},
                       "ffn": {k: stacked[k][i]
                               for k in ("up", "gate", "down")}})
    embed_std = float(cfg.get("init", {}).get("embed_std", 1.0))
    return {"embed": draw((V, D), embed_std), "layers": layers,
            "final_norm": {"scale": ones(D)}}


def decode_products(cfg: dict) -> list[tuple[int, int]]:
    """``(K, N)`` of every product the decode step runs through the gated
    row matmul (K2): per layer the query down-projection, the latent and
    rotary key projections, the output projection and the MLP's three;
    then the head."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    F_ = cfg["intermediate_size"]
    per = [(D, cfg["q_lora_rank"]), (D, cfg["kv_lora_rank"]),
           (D, cfg["qk_rope_head_dim"]), (H * cfg["v_head_dim"], D),
           (D, F_), (D, F_), (F_, D)]
    return per * cfg["num_hidden_layers"] + [(D, cfg["vocab_size"])]


def matmul_params(cfg: dict) -> float:
    """Parameters of every product of a token's forward: the layers'
    projections (the per-head latent expansions included) and the head."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    r, rq = cfg["kv_lora_rank"], cfg["q_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    F_ = cfg["intermediate_size"]
    layer = (D * rq + rq * H * (dn + dr) + D * r + D * dr + r * H * dn
             + r * H * dv + H * dv * D + 3 * D * F_)
    return float(layer * cfg["num_hidden_layers"]
                 + D * cfg["vocab_size"])


def accountant_sites(cfg: dict) -> list[tuple[int, int]]:
    """``(K, N)`` of the accountant's monitored weights: the first
    block's latent down-projection ``w_dkv`` and its MLP ``up``."""
    D = cfg["hidden_size"]
    return [(D, cfg["kv_lora_rank"]), (D, cfg["intermediate_size"])]


def embed_scale(cfg: dict) -> float:
    """What the embedded rows are multiplied by (``scale_emb``)."""
    return float(cfg["scale_emb"])


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


def _rope(x, pos, theta):
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos[:, None].float() * inv                       # [S, d/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


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
    L, H = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    resid = cfg["scale_depth"] / math.sqrt(L)
    theta = float(cfg["rope_theta"])
    toks = torch.tensor(tokens, device=dev)
    S = toks.shape[0]
    pos = torch.arange(S, device=dev)
    with _no_tf32():
        x = params["embed"][toks].float() * float(cfg["scale_emb"])
        causal = pos[None, :] <= pos[:, None]               # [S(q), S(k)]
        for lp in params["layers"]:
            p = lp["mixer"]
            h = _rms(x, lp["norm1"]["scale"])
            cq = _rms(m.mm(h, m.w(p["w_dq"])), p["q_norm"]["scale"])
            q = m.ein("sr,rhe->she", cq, m.w(p["w_uq"]))
            q_nope, q_rope = q[..., :dn], _rope(q[..., dn:], pos, theta)
            ckv = _rms(m.mm(h, m.w(p["w_dkv"])), p["kv_norm"]["scale"])
            kr = _rope(m.mm(h, m.w(p["w_kr"]))[:, None, :], pos, theta)
            k_nope = m.ein("sr,rhe->she", ckv, m.w(p["w_uk"]))
            v = m.ein("sr,rhe->she", ckv, m.w(p["w_uv"]))
            out = torch.empty((S, H, dv), device=dev)
            for lo in range(0, S, block):       # query blocks bound memory
                hi = min(S, lo + block)
                sc = (m.ein("qhe,khe->hqk", q_nope[lo:hi], k_nope)
                      + m.ein("qhe,ke->hqk", q_rope[lo:hi], kr[:, 0]))
                sc = sc * (dn + dr) ** -0.5
                sc = sc.masked_fill(~causal[lo:hi][None], float("-inf"))
                out[lo:hi] = m.ein("hqk,khe->qhe", torch.softmax(sc, -1), v)
            x = x + resid * m.mm(out.reshape(S, H * dv), m.w(p["wo"]))
            f = lp["ffn"]
            h = _rms(x, lp["norm2"]["scale"])
            g = m.mm(h, m.w(f["gate"]))
            y = m.mm(torch.nn.functional.silu(g) * m.mm(h, m.w(f["up"])),
                     m.w(f["down"]))
            x = x + resid * y
        h = _rms(x[torch.tensor(at, device=dev)], params["final_norm"]["scale"])
        return m.mm(h, m.w(params["embed"]).T)
