"""Shared building blocks: dtypes, norms, embeddings, RoPE, MLPs.

Port of ``repro.models.layers`` as plain functions on tensors. Parameters
keep the reference's layouts (``tok`` (V_pad, d), MLP ``up``/``gate``
(d, f) and ``down`` (f, d)), so a weight carried across from the JAX
package needs no transpose. Rounding follows the reference step by step:
norms compute in f32 and cast back, RoPE casts cos and sin to the
activation dtype before multiplying, and logits are computed in the compute
dtype and then cast to the logit dtype.

The reference's ``shard`` sites are kept (``models.sharding``): embedded
tokens (batch, seq, -), logits (batch, seq, vocab) and the MLP's hidden
(batch, seq, d_ff) and output (batch, seq, -). Without a mesh they
return their input.

The projections, the MLP's GEMMs and the unembedding go through
``linear``: ``torch.matmul``, except inside ``row_invariant_linears(True)``
on this thread (the engine's prefill with ``cfg.use_kernels``:
``Transformer.prefill`` and ``prefill_shared``), where plain tensors go to
``kernels.ops.prefill_linear``, whose rows' bits do not depend on how many
rows share a call. cuBLAS picks its algorithm by shape (a split-K at 128
rows, none at 512), so a shared-prefix tail wave would give other bits
than a cold wave on the card, where the reference's are equal. Decode
(a fixed row count), ``forward`` and training, DTensors and fake tensors
keep ``torch.matmul``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.sharding import shard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r} is not supported by the port "
                         f"(takes {sorted(_DTYPES)})") from None


def pdt(cfg) -> torch.dtype:
    return dt(cfg.param_dtype)


def cdt(cfg) -> torch.dtype:
    return dt(cfg.compute_dtype)


def normal_init(shape, fan_in: int, dtype: torch.dtype,
                generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """The reference's init scheme: standard normal x fan_in^-0.5, drawn in
    f32 and cast (``layers.normal_init``). Draws differ from JAX's."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * fan_in ** -0.5).to(dtype)


# ---------------------------------------------------------------- norms ----
def apply_norm(x: torch.Tensor, scale: torch.Tensor, cfg,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm (or LayerNorm when ``cfg.norm == "layernorm"`` and a bias is
    given), in f32 whatever the compute dtype, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm" and bias is not None:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * scale.float() + bias.float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * scale.float()
    return y.to(x.dtype)


def rms_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Qwen3-style per-head q/k RMSNorm over the head_dim axis."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# -------------------------------------------------------------- linears ----
_ROUTE = threading.local()


@contextlib.contextmanager
def row_invariant_linears(on: bool):
    """Within this scope, on this thread, ``linear`` sends plain CPU and
    CUDA tensors to ``kernels.ops.prefill_linear`` when ``on``, and to
    ``torch.matmul`` when not. The outermost scope decides: an inner one
    (``Transformer.prefill`` opens one from ``cfg.use_kernels``) leaves
    the choice as it found it, so a caller can run a kernel model's
    prefill on ``torch.matmul`` under ``row_invariant_linears(False)``.
    Thread-local: the PCM runtime's worker threads prefill and decode at
    once."""
    prev = getattr(_ROUTE, "on", None)
    if prev is None:
        _ROUTE.on = bool(on)
    try:
        yield
    finally:
        _ROUTE.on = prev


def linear(x: torch.Tensor, w: torch.Tensor,
           w_kmajor: bool = False) -> torch.Tensor:
    """x (..., K) x w (K, N), or x w^T for w (N, K) with ``w_kmajor``
    (the tied unembedding reads ``tok`` (V, d) in place) -> (..., N), in
    the inputs' dtype: the prefill linear inside
    ``row_invariant_linears(True)`` for plain tensors on the CPU or the
    card (a DTensor or a fake tensor is a subclass), else ``torch.matmul``
    (the same bits on the CPU)."""
    if getattr(_ROUTE, "on", None) and type(x) is torch.Tensor \
            and x.device.type in ("cpu", "cuda"):
        return kops.prefill_linear(x, w, w_kmajor=w_kmajor)
    return torch.matmul(x, w.t() if w_kmajor else w)


# ----------------------------------------------------------- embeddings ----
def embed(tok: torch.Tensor, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tok (V_pad, d); tokens (B, S) int -> (B, S, d) in the compute
    dtype. Under a mesh a step that trains reads the table whole (an
    all-gather of a vocab-sharded one): DTensor cannot take a gradient
    back through the masked partial sum of a vocab-sharded lookup."""
    if tok.requires_grad and torch.is_grad_enabled():
        tok = shard(tok, None, None)
    return shard(F.embedding(tokens.long(), tok).to(cdt(cfg)),
                 "batch", "seq", None)


def unembed(tok: torch.Tensor, x: torch.Tensor, cfg,
            w_unembed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tied (``tok.T``) or untied (``w_unembed`` (d, V_pad)) unembedding.
    Logits over the padded vocab, computed in the compute dtype and cast to
    ``cfg.logit_dtype``."""
    c = cdt(cfg)
    if w_unembed is None:
        logits = linear(x.to(c), tok.to(c), w_kmajor=True)
    else:
        logits = linear(x.to(c), w_unembed.to(c))
    logits = logits.to(dt(cfg.logit_dtype))
    return shard(logits, "batch", *(["seq"] * (logits.dim() - 2)), "vocab")


# --------------------------------------------------------------- rope ------
def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) int -> cos, sin of shape (..., dim // 2), f32."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos, sin (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------- MLPs ------
def apply_mlp(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor, cfg,
              gate: Optional[torch.Tensor] = None,
              activation: Optional[str] = None) -> torch.Tensor:
    """SwiGLU (``gate`` given), squared ReLU or GELU MLP in the compute
    dtype; ``up``/``gate`` (d, f), ``down`` (f, d)."""
    act = activation or cfg.activation
    c = cdt(cfg)
    xc = x.to(c)
    h_up = linear(xc, up.to(c))
    if act == "swiglu":
        h = F.silu(linear(xc, gate.to(c))) * h_up
    elif act == "squared_relu":
        r = F.relu(h_up)
        h = r * r
    else:  # gelu, tanh-approximated as jax.nn.gelu's default
        h = F.gelu(h_up, approximate="tanh")
    if h.dim() == 3:
        h = shard(h, "batch", "seq", "d_ff")
    y = linear(h, down.to(c))
    return shard(y, "batch", "seq", None) if y.dim() == 3 else y


# ------------------------------------------------------- frontend stubs ----
def frontend_input(extra, name: str, cfg) -> torch.Tensor:
    """The frontend input ``name`` (``"frames"`` for the audio family,
    ``"patches"`` for the VLM; ``models.registry.extra_inputs`` gives its
    shape) out of ``extra``. Raises, naming the input, where the reference
    fails at its first prefill on a missing one."""
    if extra is None or name not in extra:
        raise ValueError(
            f"{cfg.arch_id}: the {cfg.family} family needs its frontend "
            f"input {name!r} (precomputed embeddings, one row per batch "
            f"row) in extra; got {sorted(extra) if extra else None}")
    return extra[name]
