"""train_step factory: chunked cross-entropy, microbatch gradient
accumulation, remat.

Port of ``repro.train.trainstep``. The loss contracts the final hidden
states against the unembedding one sequence chunk at a time, in f32 over
the padded vocab (the padding columns unmasked, as in the reference), so
the (B, chunk, V) logits of one chunk are the largest tensor it makes:
each chunk runs under ``torch.utils.checkpoint``, which keeps only its
inputs for the backward pass (the reference's ``lax.scan``). Remat of the
blocks is the model's (``forward_hidden(train=True)`` with ``cfg.remat``).

Training runs the plain PyTorch path, as the reference trains with
``use_kernels`` off: the port's CUDA kernels are forward-only, so
``make_train_step`` refuses a config with ``use_kernels`` set.

The step runs unchanged on DTensor parameters under a mesh
(``launch.steps.build_train_cell``): the CE logits take the reference's
(batch, seq, vocab) placement, gradients and AdamW's moments take their
parameter's, and the update runs in place on each rank's shards.
Microbatches are the same global rows as without a mesh.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.sharding import remat, shard
from repro_torch.train import optimizer as opt_lib
from repro_torch.weights import decay_mask

Batch = Mapping[str, torch.Tensor]

# the frontend inputs a batch may carry (``models.extra_inputs``): the
# audio family's frames, the VLM's patches
FRONTEND_INPUTS = ("frames", "patches")


def trainable(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The model's parameters by name, each set to require a gradient:
    what the train step updates. The port builds every parameter frozen
    (a serving model never needs a gradient); only a model that trains
    goes through here."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def to_device(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch of numpy arrays (``data.batches``) as tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _chunk_nll(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: (sum of the NLL over labelled positions, their count),
    f32. h (B, c, d) f32, y (B, c) with -100 = ignore, w (d, V) f32."""
    logits = shard(torch.matmul(h, w), "batch", "seq", "vocab")
    mask = y != -100
    safe_y = torch.where(mask, y, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    # over a vocab-sharded logit DTensor the gathered column is a masked
    # partial sum, reduced here with its trailing dim still on (DTensor's
    # mask reduction needs it)
    gold = shard(torch.gather(logits, -1, safe_y[..., None]),
                 "batch", "seq", None)[..., 0]
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum(), mask.float().sum()


def chunked_cross_entropy(hidden: torch.Tensor, embed: nn.Module,
                          labels: torch.Tensor, cfg,
                          chunk: int = 512) -> torch.Tensor:
    """hidden (B,S,d); labels (B,S) with -100 = ignore. Mean NLL, f32.
    ``embed`` holds ``tok`` (V_pad, d), used transposed, and ``unembed``
    (d, V_pad) when the embeddings are untied."""
    del cfg  # the reference takes it for its sharding rules
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    w = (embed.tok.t() if embed.unembed is None else embed.unembed).float()
    hf = hidden.float()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        s, n = remat(_chunk_nll, hf[:, c0:c0 + chunk],
                     labels[:, c0:c0 + chunk], w)
        loss_sum = loss_sum + s
        count = count + n
    return loss_sum / torch.clamp(count, min=1.0)


def make_loss_fn(model: nn.Module, ce_chunk: int = 512) -> Callable:
    """loss_fn(batch) -> (CE + the MoE aux loss, {"ce_loss", "aux_loss"})
    on the model's current parameters. The batch's frontend inputs
    (``FRONTEND_INPUTS``) go to ``forward_hidden`` as its ``extra``."""
    def loss_fn(batch: Batch):
        extra = {k: batch[k] for k in FRONTEND_INPUTS if k in batch}
        hidden, aux = model.forward_hidden(batch["tokens"],
                                           batch.get("lengths"),
                                           extra or None, train=True)
        loss = chunked_cross_entropy(hidden, model.embed, batch["labels"],
                                     model.cfg, chunk=ce_chunk)
        return loss + aux, {"ce_loss": loss, "aux_loss": aux}
    return loss_fn


def _rows(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of a batch leaf: a DTensor's are cut from its whole
    value and placed as the leaf was (a slice of the sharded batch dim
    itself is not what DTensor gives back)."""
    if not hasattr(v, "full_tensor"):
        return v[lo:hi]
    from torch.distributed.tensor import Replicate
    mesh = v.device_mesh
    whole = v.redistribute(mesh, [Replicate()] * mesh.ndim)
    return whole[lo:hi].redistribute(mesh, v.placements)


def make_train_step(model: nn.Module, opt_cfg: opt_lib.OptimizerConfig,
                    accum_steps: int = 1, ce_chunk: int = 512) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` being ``trainable(model)``, updated in place with
    the state. Microbatches split the leading batch dim when accum_steps >
    1: their gradients accumulate in f32, each divided by
    ``accum_steps``, and the loss is their mean; the single path hands
    AdamW the gradients in the parameter dtype (both as the reference
    does). Metrics stay on the device."""
    if model.cfg.use_kernels:
        raise ValueError(
            f"{model.cfg.arch_id}: training runs the plain path "
            f"(use_kernels=False), as the reference does: the port's CUDA "
            f"kernels are forward-only, and a backward pass through them "
            f"would give the weights upstream no gradient")
    loss_fn = make_loss_fn(model, ce_chunk)
    decay = {n for n, d in decay_mask(model.cfg, model.state_dict()).items()
             if d}

    def grads_of(params, batch):
        """(loss, its parts, d loss / d params): a parameter the loss does
        not reach gets zeros, as ``jax.grad`` gives it."""
        for p in params.values():
            p.grad = None
        loss, parts = loss_fn(batch)
        loss.backward()
        return loss.detach(), parts, {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()}

    def update(params, opt_state, grads):
        params, opt_state, om = opt_lib.apply_updates(
            opt_cfg, params, grads, opt_state, decay)
        for p in params.values():
            p.grad = None
        return params, opt_state, om

    def single(params, opt_state, batch):
        loss, parts, grads = grads_of(params, batch)
        params, opt_state, om = update(params, opt_state, grads)
        metrics = {"loss": loss, **{k: v.detach() for k, v in parts.items()},
                   **om}
        return params, opt_state, metrics

    if accum_steps == 1:
        return single

    def accumulated(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        mb = B // accum_steps
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        for i in range(accum_steps):
            micro = {k: _rows(v, i * mb, (i + 1) * mb)
                     for k, v in batch.items()}
            loss, _, grads = grads_of(params, micro)
            with torch.no_grad():       # out of place: see optimizer.py
                for n, g in grads.items():
                    acc[n] = acc[n] + g.float() / accum_steps
            loss_acc = loss_acc + loss / accum_steps
        params, opt_state, om = update(params, opt_state, acc)
        return params, opt_state, {"loss": loss_acc, **om}

    return accumulated


def make_eval_step(model: nn.Module, ce_chunk: int = 512) -> Callable:
    """eval_step(batch) -> {"loss", "ce_loss", "aux_loss"}, without
    gradients."""
    loss_fn = make_loss_fn(model, ce_chunk)

    @torch.no_grad()
    def eval_step(batch: Batch):
        loss, parts = loss_fn(batch)
        return {"loss": loss, **parts}

    return eval_step
