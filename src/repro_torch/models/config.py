"""Architecture configuration schema (the port's copy of the JAX
package's ``ArchConfig``, field for field).

Block specs are ``"<mixer>[+<ffn>]"`` strings:

* mixers: ``attn`` | ``local`` | ``mla`` | ``rglru`` | ``mlstm`` |
  ``slstm``;
* ffns: ``mlp`` | ``moe`` | ``none`` (no ``+<ffn>``).

RoPE scaling (``rope_scaling``, a :class:`RopeScaling`; YaRN, as
DeepSeek-V2 publishes it) and the accountant's monitored block
(``monitor_block``) are the port's own fields: the JAX package has
neither, and their defaults leave every configuration as it is there.

A mixer that needs a sub-config (``mla``: :class:`MLAConfig`,
``rglru``: :class:`RGLRUConfig`, ``mlstm``/``slstm``:
:class:`XLSTMConfig`, ``moe``: :class:`MoEConfig`) raises without it;
an unknown mixer or FFN raises ``ValueError`` naming the spec, as the
JAX package's ``make_mixer`` does.
"""
from __future__ import annotations

import dataclasses

from .attention import MLAConfig
from .moe import MoEConfig
from .recurrent import RGLRUConfig
from .xlstm import XLSTMConfig

MIXERS = ("attn", "local", "mla", "rglru", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")
#: the sub-config each mixer or FFN needs
_NEEDS = {"mla": ("mla", "MLAConfig"), "rglru": ("rglru", "RGLRUConfig"),
          "mlstm": ("xlstm", "XLSTMConfig"),
          "slstm": ("xlstm", "XLSTMConfig"), "moe": ("moe", "MoEConfig")}


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN RoPE scaling (arXiv:2309.00071) under the keys of a published
    ``rope_scaling`` (``type: "yarn"``): the rotary frequencies blended
    between ``base ** (-2i / d)`` and that over ``factor`` by the linear
    ramp between the correction dims of ``beta_fast`` and ``beta_slow`` at
    ``original_max_position_embeddings`` positions, cos and sin scaled by
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``, and MLA's
    softmax scale multiplied by ``mscale(factor, mscale_all_dim) ** 2``
    (:func:`repro_torch.models.layers.yarn_inv_freq`)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    type: str = "yarn"

    def __post_init__(self):
        if self.type != "yarn":
            raise ValueError(f"rope_scaling type {self.type!r}: only "
                             f"'yarn' is modelled")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    pattern: tuple[str, ...] = ("attn+mlp",)
    head: tuple[str, ...] = ()     # unrolled leading blocks
    tail: tuple[str, ...] = ()     # unrolled remainder blocks
    norm: str = "rms"              # rms | ln
    act: str = "silu"              # silu | gelu | relu
    qkv_bias: bool = False
    pos: str = "rope"              # rope | mrope | sinusoidal
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None    # None: plain RoPE
    mrope_sections: tuple[int, ...] = ()
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    logit_mult: float = 1.0
    attn_softcap: float = 0.0
    mlp_gated: bool = True
    emb_mult: float = 1.0
    resid_mult: float = 1.0
    attn_scale: float = 0.0        # 0 => 1/sqrt(head_dim)
    window: int = 0                # sliding window for "local" blocks
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    rglru: RGLRUConfig | None = None
    xlstm: XLSTMConfig | None = None
    inputs: str = "tokens"         # tokens | embeds | codes
    codebooks: int = 0
    max_seq: int = 524288
    subquadratic: bool = False
    # execution knobs (not architecture); the port has no scan and no
    # remat, so it reads neither scan_layers nor remat
    remat: bool = True
    scan_layers: bool = True
    attn_block_k: int = 1024
    compute_dtype: str = "bfloat16"
    # the block whose weights the power accountant streams; -1: the JAX
    # package's rule (lm.pick_monitor_weights)
    monitor_block: int = -1

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return ((self.n_layers - len(self.tail) - len(self.head))
                // len(self.pattern))

    @property
    def block_specs(self) -> tuple[str, ...]:
        """Every layer's block spec in execution order: the head, the
        pattern repeated ``n_groups`` times, the tail."""
        return self.head + self.pattern * self.n_groups + self.tail

    def __post_init__(self):
        body = self.n_layers - len(self.tail) - len(self.head)
        if body % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: {self.n_layers} layers - {len(self.head)} "
                f"head - {len(self.tail)} tail not divisible by group "
                f"{len(self.pattern)}")
        for spec in dict.fromkeys(self.block_specs):
            mixer, _, ffn = spec.partition("+")
            if mixer not in MIXERS or (ffn or "none") not in FFNS:
                raise ValueError(f"{self.name}: unknown block {spec!r} "
                                 f"(mixers {MIXERS}, ffns {FFNS})")
            for part in (mixer, ffn):
                field, cls = _NEEDS.get(part, (None, None))
                if field and getattr(self, field) is None:
                    raise ValueError(f"{self.name}: {part} blocks need "
                                     f"a {cls} ({field}=)")

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


#: the port's own fields, which the JAX package's ArchConfig (and, under
#: ``moe``, its MoEConfig) lacks; their defaults are the JAX package's
#: behaviour
PORT_FIELDS = ("rope_scaling", "monitor_block")
PORT_MOE_FIELDS = ("dropless",)


def jax_fields(cfg: ArchConfig) -> dict:
    """``dataclasses.asdict(cfg)`` without the port's own fields: what the
    JAX package's config of the same name holds, field for field."""
    d = dataclasses.asdict(cfg)
    for k in PORT_FIELDS:
        d.pop(k)
    if d["moe"] is not None:
        for k in PORT_MOE_FIELDS:
            d["moe"].pop(k)
    return d


def jax_form(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with the port's own fields at their defaults: the model the
    JAX package runs under the same fields (plain RoPE, capacity routing,
    the JAX rule's monitored block)."""
    moe = cfg.moe and dataclasses.replace(cfg.moe, dropless=False)
    return cfg.with_(rope_scaling=None, monitor_block=-1, moe=moe)
