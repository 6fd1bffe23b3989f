"""AdamW with warmup-cosine schedule and global-norm clipping.

Port of ``repro.train.optimizer``. The state is a plain dict
``{"step", "mu", "nu"}``: ``step`` an int32 scalar tensor, ``mu`` and
``nu`` f32 moments keyed like the parameters (the port's flat names)
whatever the parameter dtype, so it checkpoints in the reference's layout
through ``repro_torch.weights.to_jax_params``. Everything stays on the
parameters' device: the step reads nothing back to the host.

The update follows the reference's arithmetic in its order: the clip
scale from the global norm, the moments, the bias corrections, the
decoupled weight decay on the leaves ``decay`` names (the reference's
``p.ndim >= 2`` on its stacked pytree: ``weights.decay_mask``), then the
cast back to the parameter dtype. Unlike the reference it updates the
parameters and moments in place, under ``torch.no_grad()``. On DTensor
parameters (the sharded path) each moment is placed as its parameter, the
global norm sums every leaf's whole value, and the update, elementwise,
runs on each rank's own shards (``_shards``), as plain tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Collection, Dict, Iterable, Mapping, Tuple

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a scalar tensor): linear warmup to
    ``peak_lr``, then a cosine down to ``min_lr_frac`` of it. f32."""
    step = step.float()
    warm = cfg.peak_lr * step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_state(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero moments in f32, keyed and shaped like ``params``, on their
    device; step 0."""
    device = next(iter(params.values())).device
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa
                     for n, p in params.items()}
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": zeros(), "nu": zeros()}


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a DTensor leaf's
    over its whole value)."""
    def sq(x):
        s = torch.sum(torch.square(x.float()))
        while hasattr(s, "full_tensor"):         # see _local
            s = s.full_tensor()
        return s
    return torch.sqrt(torch.stack([sq(x) for x in leaves]).sum())


def _local(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor of a DTensor's own shard, through every DTensor
    layer: in some runs on the card's torch 2.11 the gradients of a bf16
    model's DTensor parameters came back as DTensors whose local tensor
    is a DTensor again (PERF.md, PR 24; never on the CPU's torch
    2.13)."""
    while hasattr(t, "to_local"):
        t = t.to_local()
    return t


def _shards(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
            nu: torch.Tensor):
    """(p, g, mu, nu) as tensors to update elementwise in place: for a
    DTensor parameter each rank's own shards, the gradient first placed as
    the parameter (it may come back otherwise, e.g. a partial sum), the
    moments placed so since ``init_state``; plain tensors as they are."""
    if not hasattr(p, "to_local"):
        return p, g, mu, nu
    if not mu.placements == nu.placements == p.placements:
        raise ValueError("AdamW's moments are not placed as their "
                         "parameter")
    return (_local(p), _local(g.redistribute(p.device_mesh, p.placements)),
            _local(mu), _local(nu))


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: dict,
                  decay: Collection[str]
                  ) -> Tuple[Mapping[str, torch.Tensor], dict,
                             Dict[str, torch.Tensor]]:
    """One AdamW step on ``params`` from ``grads`` (same keys), in place.
    ``decay`` names the leaves that take weight decay. Returns (params,
    state, metrics {"lr", "grad_norm"}) with the state's step advanced;
    the metrics stay on the device."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    for name, p in params.items():
        p, g, mu, nu = _shards(p, grads[name], state["mu"][name],
                               state["nu"][name])
        g = g.float() * scale
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        pf = p.float()
        if name in decay:
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
