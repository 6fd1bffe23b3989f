"""Token sampling on the device, without a host sync.

Port of ``repro.serving.sampler``. Greedy decoding (temperature 0) matches
the reference token for token: argmax over the f32 logits with padded
vocab rows masked to ``-1e30``, ties to the first index in both
frameworks. Temperature sampling uses the Gumbel-max trick with noise from
an explicit ``torch.Generator``, which draws the same distribution as the
reference's ``jax.random.categorical`` but not the same tokens.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: torch.Tensor, top_k: int = 0, vocab_size: int = 0,
           active: Optional[torch.Tensor] = None,
           fallback: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32. temperature (B,): 0 => greedy.

    ``top_k`` > 0 samples among each row's ``top_k`` largest logits (ties
    with the k-th kept, as the reference keeps them); greedy rows ignore
    it. ``vocab_size`` masks padded vocab rows. Rows where ``active`` is
    False return ``fallback`` (default 0)."""
    lf = logits.float()
    if vocab_size and vocab_size < lf.shape[-1]:
        lf = lf.clone()
        lf[:, vocab_size:] = -1e30
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)
    if top_k:
        kth = torch.sort(lf, dim=-1).values[:, -top_k][:, None]
        lf = torch.where(lf >= kth, lf, -1e30)
    t = torch.clamp(temperature.float(), min=1e-6)[:, None]
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(lf / t + gumbel, dim=-1).to(torch.int32)
    toks = torch.where(temperature > 0.0, sampled, greedy)
    if active is not None:
        fb = torch.zeros_like(toks) if fallback is None \
            else fallback.to(toks.dtype)
        toks = torch.where(active, toks, fb)
    return toks
