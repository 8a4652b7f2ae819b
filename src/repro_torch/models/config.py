"""Architecture configuration schema (the port's copy of the JAX
package's ``ArchConfig``, field for field).

Block specs are ``"<mixer>[+<ffn>]"`` strings. The port runs token LMs
of attention blocks with RMS norm and RoPE: dense (``"attn+mlp"``) and
MoE (``"attn+moe"``, with a :class:`MoEConfig`), with no MLA, RG-LRU or
xLSTM sub-config. Any other architecture raises at construction (the
rest of the LM zoo is ROADMAP queue 1 step 3).
"""
from __future__ import annotations

import dataclasses

from .moe import MoEConfig

#: the block specs this port runs
SUPPORTED_BLOCKS = ("attn+mlp", "attn+moe")


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
    mla: object | None = None
    rglru: object | None = None
    xlstm: object | None = None
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
        other = sorted({s for s in (*self.pattern, *self.head, *self.tail)
                        if s not in SUPPORTED_BLOCKS})
        subs = [f for f in ("mla", "rglru", "xlstm")
                if getattr(self, f) is not None]
        if (other or subs or self.norm != "rms" or self.pos != "rope"
                or self.inputs != "tokens"):
            raise NotImplementedError(
                f"{self.name}: the port runs token LMs of attn+mlp and "
                f"attn+moe blocks with RMS norm and RoPE only (blocks "
                f"{other or 'ok'}, "
                f"sub-configs {subs or 'none'}, norm {self.norm!r}, pos "
                f"{self.pos!r}, inputs {self.inputs!r}); the rest of the "
                f"LM zoo is ROADMAP queue 1 step 3")
        if self.moe is None and any(s.endswith("+moe")
                                    for s in self.block_specs):
            raise ValueError(f"{self.name}: moe blocks need a MoEConfig")

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
