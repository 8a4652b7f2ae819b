"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) (the
port's copy of the JAX package's ``repro.models.xlstm``).

mLSTM (Beck et al. 2024): per-head matrix memory ``C [dk, dv]`` with
exponential input gates and sigmoid forget gates, stabilized in log
space:

    m_t = max(f~_t + m_{t-1}, i~_t)                 (stabilizer)
    C_t = exp(f~_t + m_{t-1} - m_t) C_{t-1} + exp(i~_t - m_t) k_t v_t^T
    n_t = exp(f~_t + m_{t-1} - m_t) n_{t-1} + exp(i~_t - m_t) k_t
    h_t = C_t^T q_t / max(|n_t^T q_t|, exp(-m_t))

Two executions, as in the JAX package: ``recurrent`` (the exact per-step
loop; decode runs it one step at a time) and ``chunkwise`` (a loop over
chunks carrying ``(C, n, m)``, each chunk's inter- and intra-chunk terms
as dense einsums; prefill runs it). sLSTM: a scalar-memory LSTM with
exponential gating and a normalizer, a per-head dense recurrence, one
step at a time.

Each loop iteration is a ``scan[i]`` frame of the tracer, as the JAX
tracer unrolls ``lax.scan``; every einsum goes through
:func:`repro_torch.trace.interpret.einsum` and every projection through
:func:`repro_torch.models.matmul.matmul` with no backend (the JAX
package's bare ``@``: traced, never the gated kernel). The sLSTM's
recurrent matrix ``r`` is read as float32 from its float32 master. The
gates' ``log_sigmoid`` and ``exp`` run in float32 and part from the JAX
package's by an ulp in some values: states are held at a tolerance.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.trace import interpret

from . import layers as L
from . import matmul as mm
from .recurrent import apply_conv1d as _causal_conv
from .recurrent import make_conv1d as _make_causal_conv


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    heads: int = 4
    chunk: int = 128
    mlstm_proj_factor: float = 2.0   # up-projection of the mLSTM block
    slstm_proj_factor: float = 4.0 / 3.0
    conv_width: int = 4


# ------------------------------------------------------------------ mLSTM
def make_mlstm(d: int, cfg: XLSTMConfig, gen: torch.Generator) -> dict:
    """mLSTM block: up-projection, (q, k, v, gates), memory,
    down-projection."""
    di = int(d * cfg.mlstm_proj_factor)
    return {"up": L.dense_param(d, di, gen),
            "up_gate": L.dense_param(d, di, gen),
            "conv": _make_causal_conv(di, cfg.conv_width, gen),
            "wq": L.dense_param(di, di, gen),
            "wk": L.dense_param(di, di, gen),
            "wv": L.dense_param(di, di, gen),
            "wi": L.dense_param(di, cfg.heads, gen),
            "wf": L.dense_param(di, cfg.heads, gen),
            "bi": L.bias_param(cfg.heads, gen),
            "bf": torch.linspace(3.0, 6.0, cfg.heads, device=gen.device),
            "skip_scale": L.scale_param(di, gen),
            "norm": L.make_norm("rms", di, gen),
            "down": L.dense_param(di, d, gen)}


def mlstm_qkvif(p: dict, c: torch.Tensor, u: torch.Tensor, heads: int):
    """Per-head ``q, k, v`` ``[B, S, H, dh]`` and float32 gate
    pre-activations ``[B, S, H]`` from the conv stream ``c`` and the
    up-stream ``u``, in the JAX package's product order."""
    b, s, di = u.shape
    dh = di // heads
    q = mm.matmul(c, p["wq"]).reshape(b, s, heads, dh)
    k = mm.matmul(c, p["wk"]).reshape(b, s, heads, dh)
    k = k * L.weak(dh ** -0.5, k.dtype)
    v = mm.matmul(u, p["wv"]).reshape(b, s, heads, dh)
    i_pre = (mm.matmul(c, p["wi"]) + p["bi"]).float()
    f_pre = (mm.matmul(c, p["wf"]) + p["bf"]).float()
    return q, k, v, i_pre, f_pre


def mlstm_memory_recurrent(q, k, v, i_pre, f_pre, state=None):
    """The exact per-step mLSTM memory. ``q/k/v [B, S, H, D]``, gates
    ``[B, S, H]``; ``state`` the carried ``(C, n, m)`` (zeros and ``m =
    -inf`` when ``None``). Returns ``(h [B, S, H, D], (C, n, m))``."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        C = q.new_zeros((b, h, dk, dv), dtype=torch.float32)
        n = q.new_zeros((b, h, dk), dtype=torch.float32)
        m = torch.full((b, h), -torch.inf, device=q.device)
    else:
        C, n, m = state
    hs = []
    for t in range(s):
        with interpret.scope(f"scan[{t}]"):
            logf = L.log_sigmoid(f_pre[:, t])               # [B, H]
            m_new = torch.maximum(logf + m, i_pre[:, t])
            decay = torch.exp(logf + m - m_new)[..., None, None]
            inp = torch.exp(i_pre[:, t] - m_new)[..., None, None]
            kf, vf, qf = k[:, t].float(), v[:, t].float(), q[:, t].float()
            C = decay * C + inp * kf[..., :, None] * vf[..., None, :]
            n = decay[..., 0] * n + inp[..., 0] * kf
            num = interpret.einsum("bhkv,bhk->bhv", C, qf)
            den = torch.abs(interpret.einsum("bhk,bhk->bh", n, qf))
            hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
            m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


def mlstm_memory_chunkwise(q, k, v, i_pre, f_pre, chunk: int = 128):
    """The chunkwise-parallel mLSTM (prefill's form), shapes as
    :func:`mlstm_memory_recurrent`; starts from zero memory and ``m =
    0``. A sequence that is not a multiple of ``chunk`` is padded with
    forget gates of 20 (decay ~1) and input gates of -1e30 (no input)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        def padf(x, value=0.0):
            return torch.cat([x, x.new_full((b, pad) + x.shape[2:], value)],
                             dim=1)
        q, k, v = padf(q), padf(k), padf(v)
        f_pre = padf(f_pre, 20.0)
        i_pre = padf(i_pre, -1e30)

    def rsh(x):   # [B, S, ...] -> [nc, B, chunk, ...]
        return x.reshape((b, nc, chunk) + x.shape[2:]).transpose(0, 1)

    qc, kc, vc, ic, fc = map(rsh, (q, k, v, i_pre, f_pre))
    logf = L.log_sigmoid(fc)                            # [nc, B, L, H]
    csum = torch.cumsum(logf, dim=2)                    # within each chunk
    C = q.new_zeros((b, h, dk, dv), dtype=torch.float32)
    n = q.new_zeros((b, h, dk), dtype=torch.float32)
    m = q.new_zeros((b, h), dtype=torch.float32)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    hs = []
    for c in range(nc):
        with interpret.scope(f"scan[{c}]"):
            ii, bseq = ic[c], csum[c]                   # [B, L, H]
            total = bseq[:, -1]                         # [B, H]
            a_intra = ii - bseq
            m_intra = torch.cummax(a_intra, dim=1).values
            m_t = torch.maximum(bseq + m[:, None], bseq + m_intra)
            m_new = torch.maximum(total + m, a_intra.amax(dim=1) + total)
            qf, kf, vf = qc[c].float(), kc[c].float(), vc[c].float()
            # inter-chunk: the queries against the carried memory
            inter = torch.exp(bseq + m[:, None] - m_t)  # [B, L, H]
            num_inter = interpret.einsum("blhk,bhkv->blhv", qf,
                                         C) * inter[..., None]
            den_inter = interpret.einsum("blhk,bhk->blh", qf, n) * inter
            # intra-chunk: masked attention with decay weights
            logw = (bseq[:, :, None] - bseq[:, None, :]
                    + ii[:, None, :, :] - m_t[:, :, None])  # [B, L, L, H]
            w = torch.where(mask[None, :, :, None], torch.exp(logw), 0.0)
            scores = interpret.einsum("blhk,bthk->blth", qf, kf)
            sw = scores * w
            num = num_inter + interpret.einsum("blth,bthv->blhv", sw, vf)
            den = den_inter + sw.sum(dim=2)
            hs.append(num / torch.maximum(torch.abs(den),
                                          torch.exp(-m_t))[..., None])
            # the carry at the chunk's end
            dec_tail = torch.exp(total[:, None] - bseq + ii
                                 - m_new[:, None])      # [B, L, H]
            carry = torch.exp(total + m - m_new)
            kd = kf * dec_tail[..., None]
            C = (carry[..., None, None] * C
                 + interpret.einsum("blhk,blhv->bhkv", kd, vf))
            n = carry[..., None] * n + kd.sum(dim=1)
            m = m_new
    out = torch.stack(hs, dim=1).reshape(b, nc * chunk, h, dv)
    return out[:, :s].to(q.dtype), (C, n, m)


def apply_mlstm(p: dict, x: torch.Tensor, cfg: XLSTMConfig):
    """The mLSTM block over ``x [B, S, D]`` (chunkwise). Returns ``(out,
    (C, n, m), u)``: ``u`` is the up-stream, whose tail is the conv
    buffer after a prefill."""
    u = mm.matmul(x, p["up"])
    gate = L.silu(mm.matmul(x, p["up_gate"]))
    c = L.silu(_causal_conv(p["conv"], u))
    q, k, v, i_pre, f_pre = mlstm_qkvif(p, c, u, cfg.heads)
    h, state = mlstm_memory_chunkwise(q, k, v, i_pre, f_pre, cfg.chunk)
    return _mlstm_out(p, x, h, u, gate), state, u


def _mlstm_out(p, x, h, u, gate):
    b, s, heads, dh = h.shape
    hflat = L.rms_norm(h.reshape(b, s, heads * dh), p["norm"]["scale"])
    hflat = hflat + p["skip_scale"] * u
    return mm.matmul(hflat * gate, p["down"])


def mlstm_decode(p: dict, x: torch.Tensor, cfg: XLSTMConfig, conv_buf,
                 mem):
    """One mLSTM decode step (``x [B, 1, D]``) with its conv buffer
    ``[B, W-1, di]`` and memory ``(C, n, m)``: ``(out, mem, conv_buf)``."""
    u = mm.matmul(x, p["up"])                            # [B, 1, di]
    gate = L.silu(mm.matmul(x, p["up_gate"]))
    window = torch.cat([conv_buf, u], dim=1)             # [B, W, di]
    c_t = L.silu(interpret.einsum("bwd,wd->bd", window, p["conv"]["w"])
                 + p["conv"]["b"])[:, None]
    q, k, v, i_pre, f_pre = mlstm_qkvif(p, c_t, u, cfg.heads)
    h, mem = mlstm_memory_recurrent(q, k, v, i_pre, f_pre, mem)
    return _mlstm_out(p, x, h, u, gate), mem, window[:, 1:]


# ------------------------------------------------------------------ sLSTM
def make_slstm(d: int, cfg: XLSTMConfig, gen: torch.Generator) -> dict:
    h = cfg.heads
    dh = d // h
    return {"conv": _make_causal_conv(d, cfg.conv_width, gen),
            "w": L.normal_init((d, 4 * d), d ** -0.5, gen),
            "r": L.normal_init((h, dh, 4 * dh), dh ** -0.5, gen),
            "b": torch.zeros(4 * d, device=gen.device),
            "norm": L.make_norm("rms", d, gen),
            "up": L.dense_param(d, 2 * int(d * cfg.slstm_proj_factor), gen),
            "down": L.dense_param(int(d * cfg.slstm_proj_factor), d, gen)}


def slstm_state_init(b: int, heads: int, dh: int, device):
    """``(c, n, h, m)``, each ``[B, H, dh]`` float32: zeros, ``n`` ones."""
    z = torch.zeros((b, heads, dh), device=device)
    return z, torch.ones_like(z), z.clone(), z.clone()


def _slstm_step(pre_t, cell, rmat, heads: int):
    """One sLSTM cell step from the float32 pre-activations ``[B, 4, H,
    dh]``."""
    c, n, h, m = cell
    b, dh = h.shape[0], h.shape[-1]
    rec = interpret.einsum("bhd,hde->bhe", h, rmat).reshape(b, heads, 4, dh)
    z = pre_t.float() + rec.transpose(1, 2)
    zi, zf, zz, zo = z[:, 0], z[:, 1], z[:, 2], z[:, 3]
    m_new = torch.maximum(zf + m, zi)                   # exponential gating
    i = torch.exp(zi - m_new)
    f = torch.exp(zf + m - m_new)
    c_new = f * c + i * torch.tanh(zz)
    n_new = f * n + i
    h_new = L.sigmoid(zo) * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, h_new, m_new


def _slstm_ffn(p, y, x):
    """Norm, then the GeGLU feed-forward of the sLSTM block."""
    y = L.rms_norm(y, p["norm"]["scale"])
    u, v = mm.matmul(y, p["up"]).chunk(2, dim=-1)
    return mm.matmul(L.gelu(u) * v, p["down"])


def apply_slstm(p: dict, x: torch.Tensor, cfg: XLSTMConfig):
    """The sLSTM block over ``x [B, S, D]``: the sequential cell, then
    the GeGLU feed-forward. Returns ``(y, (c, n, h, m))``."""
    b, s, d = x.shape
    nh = cfg.heads
    dh = d // nh
    xc = L.silu(_causal_conv(p["conv"], x))
    pre = (mm.matmul(xc, p["w"]) + p["b"]).reshape(b, s, 4, nh, dh)
    cell = slstm_state_init(b, nh, dh, x.device)
    hs = []
    for t in range(s):
        with interpret.scope(f"scan[{t}]"):
            cell = _slstm_step(pre[:, t], cell, p["r"], nh)
        hs.append(cell[2])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return _slstm_ffn(p, y, x), cell


def slstm_decode(p: dict, x: torch.Tensor, cfg: XLSTMConfig, conv_buf,
                 cell):
    """One sLSTM decode step (``x [B, 1, D]``) with its conv buffer and
    cell ``(c, n, h, m)``: ``(y, cell, conv_buf)``."""
    window = torch.cat([conv_buf, x], dim=1)
    xc = L.silu(interpret.einsum("bwd,wd->bd", window, p["conv"]["w"])
                + p["conv"]["b"])
    b, _, d = x.shape
    nh = cfg.heads
    pre = (mm.matmul(xc, p["w"]) + p["b"]).reshape(b, 4, nh, d // nh)
    cell = _slstm_step(pre, cell, p["r"], nh)
    y = cell[2].reshape(b, 1, d).to(x.dtype)
    return _slstm_ffn(p, y, x), cell, window[:, 1:]
