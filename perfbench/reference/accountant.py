"""The serving power accountant's per-request energies, worked out again
from a request's tokens and the benchmark's weights.

What the port's accountant (``src/repro_torch/serve/power.py`` with
``core/monitor.py``, the default monitor: the paper pair on the 16x16
array) states, frozen here as of this benchmark's first version: each
monitored weight -- the first block's first of ``wq``, ``in_x``, ``up``,
``w_dkv`` its mixer has, then its FFN ``up`` -- is streamed against the
request's own embedded rows (the bfloat16 embedding times ``scale_emb``):

* at admission, the prompt rows it computes (``[start, len)``; a prefix
  reuser pays only for its suffix), sub-sampled to a power of two of at
  most 256 rows, the depth to 1024 and the weight's columns to 256 by
  evenly strided takes, priced, and scaled back by the sampled fraction;
* at each decode step, the row of the token fed, alone in lane 0 of a
  16-lane west stream, against the same sub-sampled weight, scaled back
  likewise.

A request's energy per design and component is the sum over its sites,
prefill first. ``dtype`` prices in another precision (the control).
"""
from __future__ import annotations

import torch

from . import sa

MAX_ROWS, MAX_COLS, MAX_DEPTH = 256, 256, 1024
MONITOR_WEIGHTS = ("wq", "in_x", "up", "w_dkv")


def monitored(params: dict) -> list[tuple[str, torch.Tensor]]:
    blk = params["layers"][0]
    out = []
    for name in MONITOR_WEIGHTS:
        if name in blk["mixer"]:
            w = blk["mixer"][name]
            out.append((f"layer0/{name}", w.reshape(w.shape[0], -1)))
            break
    if "up" in blk.get("ffn", {}):
        out.append(("layer0/ffn_up", blk["ffn"]["up"]))
    return out


def _index(n: int, cap: int) -> torch.Tensor:
    step = torch.tensor(n / cap, dtype=torch.float32)
    return torch.floor(torch.arange(cap, dtype=torch.float32) * step).long()


def _take(x: torch.Tensor, cap: int, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    if n <= cap:
        return x
    return x.index_select(axis, _index(n, cap).to(x.device))


def _flat(ev: dict) -> dict:
    out = {}
    for name, r in ev.items():
        for comp, v in r["energy"].items():
            out[f"e/{name}/{comp}"] = v
    return out


def _priced(A, W, designs, m, dt):
    a_w, b_w = sa.edge_streams(A, W)
    rep, = sa.report(a_w, b_w, A.shape[0], A.shape[1], W.shape[1], m, (dt,))
    return {k: float(v) for k, v in _flat(sa.evaluate(rep, designs)).items()}


def _decode_priced(rows, W2, designs, m, dt) -> list[dict]:
    """Decode rows ``[S, K]``, each priced as its own step: its words in
    lane 0 of a 16-lane west stream (one counter pass for all of them),
    against the weight's north stream."""
    S, K = rows.shape
    a = torch.zeros((S, K, sa.ROWS), dtype=torch.int32, device=rows.device)
    a[..., 0] = sa.words(rows)
    b = sa.pad_to(sa.words(W2), sa.COLS, -1).contiguous()
    rep, = sa.report(a, b, 1, K, W2.shape[1], m, (dt,))
    flat = _flat(sa.evaluate(rep, designs))
    per = {k: torch.broadcast_to(torch.as_tensor(v), (S,)).tolist()
           for k, v in flat.items()}
    return [{k: v[t] for k, v in per.items()} for t in range(S)]


def request_energy(params: dict, scale_emb: float, prompt: list[int],
                   generated: list[int], decode_steps: int, start: int = 0,
                   dtype=torch.float32) -> dict:
    """``{design: {component: fJ}}`` of one retired request."""
    designs = sa.PAPER_PAIR
    m = sa.menu(designs)
    emb = params["embed"]
    dev = emb.device

    def embed(toks):
        x = emb[torch.tensor(toks, device=dev)]
        return (x.float() * scale_emb).to(torch.bfloat16)

    sites = monitored(params)
    total: dict[str, float] = {}
    x = embed(prompt)[start:]
    mrows = x.shape[0]
    ms = 1 << (min(mrows, MAX_ROWS).bit_length() - 1)
    for _, w in sites:
        A = _take(_take(x, ms, 0), MAX_DEPTH, 1)
        W2 = _take(_take(w, MAX_DEPTH, 0), MAX_COLS, 1)
        factor = ((mrows / ms) * (w.shape[0] / min(w.shape[0], MAX_DEPTH))
                  * (w.shape[1] / min(w.shape[1], MAX_COLS)))
        for k, v in _priced(A, W2, designs, m, dtype).items():
            total[k] = total.get(k, 0.0) + v * factor
    fed = embed(generated[:decode_steps])
    for _, w in sites:
        W2 = _take(_take(w, MAX_DEPTH, 0), MAX_COLS, 1)
        factor = ((w.shape[0] / min(w.shape[0], MAX_DEPTH))
                  * (w.shape[1] / min(w.shape[1], MAX_COLS)))
        site: dict[str, float] = {}
        if decode_steps:
            for step in _decode_priced(_take(fed, MAX_DEPTH, 1), W2,
                                       designs, m, dtype):
                for k, v in step.items():
                    site[k] = site.get(k, 0.0) + v * factor
        for k, v in site.items():
            total[k] = total.get(k, 0.0) + v
    out: dict[str, dict[str, float]] = {}
    for key, v in total.items():
        _, name, comp = key.split("/", 2)
        out.setdefault(name, {})[comp] = v
    return out
