"""The trainer, the port of the JAX package's
``repro.launch.train``.

It wires together the config registry, AdamW (with gradient
accumulation and compression), the deterministic data pipeline, atomic
checkpoints with resume, preemption handling, straggler timing, and the
paper's PowerMonitor as a metric stream (``--power-monitor``: every
step; ``--power-trace-every N``: the whole forward through the
model-wide tracer every N steps). Both take their counters from the
power-counter kernel (K1) on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --smoke --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ck

It runs on the card unless ``--device cpu`` is given. Given a mesh
(``train(tc, mesh)``, a ``DeviceMesh`` of
:func:`repro_torch.launch.mesh.make_host_mesh`) or ``--model-parallel``
above 1 (which builds ``make_host_mesh(model=...)``, starting a process
group of one process where none exists), the parameters and the AdamW
state are distributed by the training rules (FSDP over the data axes, TP
over "model"; :mod:`repro_torch.runtime.sharding`), each batch over the
data axes, and the residual stream is constrained by ``make_constrain``.
Without either, no process group is started and nothing is distributed.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import numpy as np
import torch

from repro_torch.apps import check_device
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import fault
from repro_torch.runtime import sharding as rsh
from repro_torch.runtime import spmd

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    arch: str = "qwen1.5-0.5b"
    smoke: bool = False
    steps: int = 100
    seq: int = 256
    batch: int = 8
    lr: float = 3e-4
    warmup: int = 20
    grad_accum: int = 1
    compress_grads: bool = False
    ckpt_dir: str = ""
    ckpt_every: int = 25
    model_parallel: int = 1
    power_monitor: bool = False
    # full-model power tracing (repro_torch.trace): every N steps, trace
    # the forward pass and log network-level BIC+ZVG savings; 0 = off.
    # Traces are analysis, not training work: keep the interval large.
    power_trace_every: int = 0
    power_trace_dir: str = ""
    seed: int = 0
    device: str = "cuda"


def build(tc: TrainConfig, mesh=None):
    """``(cfg, optimizer, train_step)`` of a run; on a mesh the step
    constrains the residual stream (``make_constrain``) and runs with
    plain tensors meeting DTensors as replicated ones."""
    cfg = get_config(tc.arch, smoke=tc.smoke)
    opt = AdamW(lr=cosine_schedule(tc.lr, tc.warmup, tc.steps),
                compress=tc.compress_grads)
    step_fn = lm.make_train_step(
        cfg, opt, grad_accum=tc.grad_accum, monitor=tc.power_monitor,
        constrain=rsh.make_constrain(mesh) if mesh is not None else lm._id)
    if mesh is not None:
        inner = step_fn

        def step_fn(*args):
            with spmd.on_mesh(mesh):
                return inner(*args)
    return cfg, opt, step_fn


def init_state(cfg, opt: AdamW, device, seed: int, mesh=None):
    """Float32 masters drawn from ``seed`` on ``device``, and the
    optimiser's zero state; on a mesh both distributed by
    :func:`state_shardings`."""
    params = lm.init_model(cfg, torch.Generator(device).manual_seed(seed))
    opt_state = opt.init(params)
    if mesh is None:
        return params, opt_state
    pshard, oshard = state_shardings(cfg, mesh, params, opt_state)
    return rsh.device_put(params, pshard), rsh.device_put(opt_state, oshard)


def state_shardings(cfg, mesh, params, opt_state):
    """``(param shardings, AdamW-state shardings)`` by the training
    rules: FSDP over the data axes, TP over "model"."""
    axes = lm.param_axes(cfg)
    return (rsh.param_shardings(mesh, params, axes),
            rsh.opt_state_shardings(mesh, params, opt_state, axes))


def batch_to(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: integer leaves int64,
    float leaves float32."""
    return {k: torch.from_numpy(np.ascontiguousarray(
                v, np.int64 if np.issubdtype(v.dtype, np.integer)
                else np.float32)).to(device)
            for k, v in batch.items()}


def _power_trace(tc: TrainConfig, cfg, params, batch, step: int,
                 capture=None) -> dict:
    """Trace the whole forward and the output head through the SA power
    model (the paper's network-level method, applied to the training
    workload as it runs), log the aggregate, and write the report's
    JSON under ``power_trace_dir`` when set. ``capture`` is the capture
    to fill (a new one of the default config)."""
    from repro_torch.trace import trace_model

    def forward(w, x, pos):
        return lm.logits_fn(w, cfg, lm.apply_model(w, cfg, x, pos)[0])

    with torch.no_grad():
        # a trace is an analysis pass: on a mesh it reads gathered weights
        rep = trace_model(forward, lm.compute_weights(rsh.gather(params),
                                                      cfg),
                          *lm.model_input(cfg, batch),
                          name=f"{cfg.name}@{step}", capture=capture)
    agg = rep.summary()
    log.info(
        "power-trace step %d: %d matmul sites, zero %.1f%%, "
        "streaming saving %.1f%%, total saving %.1f%% (share %.1f%%)",
        step, agg["n_sites"], agg["mean_zero_fraction"] * 100,
        agg["streaming_saving"] * 100, agg["total_saving"] * 100,
        agg["streaming_share"] * 100)
    if tc.power_trace_dir:
        os.makedirs(tc.power_trace_dir, exist_ok=True)
        rep.to_json(os.path.join(tc.power_trace_dir,
                                 f"trace_step{step:06d}.json"))
    return agg


def train(tc: TrainConfig, mesh=None) -> dict:
    """Run ``tc``: resume from the latest checkpoint of ``ckpt_dir`` if
    there is one, then train to ``steps``. Returns the final loss, the
    history (each step's loss, ``grad_norm``, the other metrics and its
    wall time), the power traces, the straggler steps and the median
    step time. With ``mesh`` (or ``tc.model_parallel > 1``) the run is
    distributed (see the module doc); every rank of the mesh runs it."""
    device = check_device(tc.device, "the trainer")
    if mesh is None and tc.model_parallel > 1:
        mesh = make_host_mesh(model=tc.model_parallel, device=tc.device)
    cfg, opt, step_fn = build(tc, mesh)
    params, opt_state = init_state(cfg, opt, device, tc.seed, mesh)

    ckpt = Checkpointer(tc.ckpt_dir) if tc.ckpt_dir else None
    start_step = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            params, opt_state = ckpt.restore(
                latest, (params, opt_state),
                None if mesh is None
                else state_shardings(cfg, mesh, params, opt_state))
            start_step = latest + 1
            log.info("resumed from checkpoint step %d", latest)

    data = make_source(cfg, DataConfig(seq_len=tc.seq,
                                       global_batch=tc.batch,
                                       seed=tc.seed))
    timer = fault.StepTimer(device=device)
    metrics_hist = []
    power_traces = []

    with fault.Preemption() as preempt:
        for step in range(start_step, tc.steps):
            timer.start()
            batch = batch_to(data.batch(step), device)
            if mesh is not None:
                batch = rsh.device_put(batch,
                                       rsh.batch_shardings(mesh, batch))
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            rec = {k: float(spmd.local(v)) for k, v in metrics.items()}
            dt = timer.stop(step)
            metrics_hist.append({"step": step, **rec, "dt": dt})
            if step % 10 == 0 or step == tc.steps - 1:
                log.info("step %5d loss %.4f (%.0f ms)", step, rec["loss"],
                         dt * 1e3)
            if tc.power_trace_every and step % tc.power_trace_every == 0:
                agg = _power_trace(tc, cfg, params, batch, step)
                power_traces.append({"step": step, **agg})
            if ckpt is not None and (step % tc.ckpt_every == 0
                                     or step == tc.steps - 1
                                     or preempt.requested):
                ckpt.save(step, (params, opt_state))
            if preempt.requested:
                log.warning("exiting at step %d on preemption", step)
                break
        if ckpt is not None:
            ckpt.wait()

    return {"final_loss": metrics_hist[-1]["loss"] if metrics_hist
            else float("nan"),
            "history": metrics_hist,
            "power_traces": power_traces,
            "stragglers": timer.straggler_steps,
            "median_step_time": timer.median}


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    for f in dataclasses.fields(TrainConfig):
        flag = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            ap.add_argument(flag, action="store_true")
        else:
            ap.add_argument(flag, type=type(f.default), default=f.default)
    args = ap.parse_args(argv)
    tc = TrainConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(TrainConfig)})
    out = train(tc)
    log.info("done: final loss %.4f, median step %.0f ms, %d stragglers",
             out["final_loss"], out["median_step_time"] * 1e3,
             len(out["stragglers"]))


if __name__ == "__main__":
    main()
