"""Training loop with checkpoint/restart and step-time telemetry.

Port of ``repro.train.loop``. Restart semantics match the paper's
no-warning preemption model: the loop can be killed at ANY point; on
relaunch it restores the newest *valid* checkpoint (manifest-committed)
and replays the data stream from the saved step — no coordination, no
partial state.

Checkpoints are written in the reference's layout (``{"params", "opt":
{"step", "mu", "nu"}}``, the parameter and moment trees stacked as the
reference stacks them, ``weights.to_jax_params``), so either package's
loop resumes from the other's. The saves fall on the reference's steps,
its double save included: every ``checkpoint_every`` steps and once more
at ``total_steps``, also when that is a multiple of ``checkpoint_every``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch import nn

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainstep import make_train_step, to_device, trainable
from repro_torch.weights import from_jax_params, to_jax_params


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    keep_checkpoints: int = 3
    accum_steps: int = 1
    ce_chunk: int = 512


@dataclass
class StepRecord:
    step: int
    loss: float
    seconds: float
    lr: float
    grad_norm: float


def checkpoint_tree(params, opt_state, cfg, device="cpu") -> dict:
    """The loop's state in the reference's layout, on ``device`` (the
    host; ``"meta"`` for the restore template's shapes)."""
    return {"params": to_jax_params(params, cfg, device),
            "opt": {"step": opt_state["step"].detach().to(device),
                    "mu": to_jax_params(opt_state["mu"], cfg, device),
                    "nu": to_jax_params(opt_state["nu"], cfg, device)}}


def _load_checkpoint(tree: dict, params, opt_state, cfg) -> None:
    """Copy a restored reference-layout tree into the live parameters and
    optimizer state, in place."""
    dev = opt_state["step"].device
    new_p = from_jax_params(tree["params"], cfg, dev)
    moments = {k: from_jax_params(tree["opt"][k], cfg, dev,
                                  dtype=torch.float32) for k in ("mu", "nu")}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(new_p[n])
            opt_state["mu"][n].copy_(moments["mu"][n])
            opt_state["nu"][n].copy_(moments["nu"][n])
        opt_state["step"].copy_(tree["opt"]["step"])


def train(model: nn.Module, data_iter_fn: Callable[[int], Iterator],
          opt_cfg: opt_lib.OptimizerConfig, loop_cfg: LoopConfig,
          checkpoint_dir: Optional[str] = None,
          params: Optional[Dict[str, torch.Tensor]] = None,
          log_fn: Callable = print) -> Dict:
    """Train ``model`` in place. data_iter_fn(start_step) -> iterator of
    host batches (``data.batches``). ``params``, a state dict, replaces
    the model's weights first (they are otherwise its own). Returns
    {"params": the model's parameters by name, "opt": the AdamW state,
    "records": one ``StepRecord`` per step run}."""
    cfg = model.cfg
    named = trainable(model)
    if params is not None:
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(params[n])
    opt_state = opt_lib.init_state(named)
    start_step = 0
    manager = None
    if checkpoint_dir:
        manager = CheckpointManager(checkpoint_dir,
                                    keep=loop_cfg.keep_checkpoints)
        # a template of meta tensors: the shapes and dtypes, no copy
        like = checkpoint_tree(named, opt_state, cfg, "meta")
        tree, start_step = manager.restore_or_init(like)
        if tree is not like:
            _load_checkpoint(tree, named, opt_state, cfg)
        if start_step:
            log_fn(f"[loop] resumed from step {start_step}")

    step_fn = make_train_step(model, opt_cfg,
                              accum_steps=loop_cfg.accum_steps,
                              ce_chunk=loop_cfg.ce_chunk)
    records: List[StepRecord] = []
    data = data_iter_fn(start_step)
    device = opt_state["step"].device

    for step in range(start_step, loop_cfg.total_steps):
        batch = to_device(next(data), device)
        t0 = time.monotonic()
        named, opt_state, metrics = step_fn(named, opt_state, batch)
        # one host read of the three scalars: the step boundary's sync
        loss, lr, gnorm = torch.stack(
            [metrics["loss"].float(), metrics["lr"].float(),
             metrics["grad_norm"].float()]).tolist()
        dt = time.monotonic() - t0
        records.append(StepRecord(step=step + 1, loss=loss, seconds=dt,
                                  lr=lr, grad_norm=gnorm))
        if (step + 1) % loop_cfg.log_every == 0:
            log_fn(f"[loop] step {step + 1} loss {loss:.4f} "
                   f"({dt * 1e3:.0f} ms)")
        if manager and (step + 1) % loop_cfg.checkpoint_every == 0:
            manager.save(step + 1, checkpoint_tree(named, opt_state, cfg))
    if manager:
        manager.save(loop_cfg.total_steps,
                     checkpoint_tree(named, opt_state, cfg))
    return {"params": named, "opt": opt_state, "records": records}
