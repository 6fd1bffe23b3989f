"""Step-function builders for the sharded path and the dry-run.

Port of ``repro.launch.steps``. For a (config, shape suite, mesh) cell
``build_cell`` returns ``(fn, abstract_args, rules)``: ``fn`` is the
train step, the prefill or the one-token decode, and the abstract
arguments are meta tensors (the meta model's parameters, ``init_state``
of them, ``input_specs`` and ``init_cache`` on the meta device), which
allocate nothing. They carry their specs (``Args.specs``), from
``param_specs``, ``cache_specs`` and ``batch_specs``; ``materialize``
makes real arguments of them on a mesh, seeded, each placed by its spec.

``fn`` runs its model under the cell's rules (``sharding.on_mesh``),
places its inputs by the reference's in specs and its outputs by its out
specs, and takes parameters from its first argument (bound to the model
without a copy). Torch has no buffer donation, where the reference
donates the parameters and optimizer state (train) and the cache
(prefill, decode) so that XLA reuses their buffers: here the train step
updates parameters and moments in place and prefill and decode write the
cache in place, which is what donation buys. A cache handed in with
another placement is redistributed into a new one, which ``fn`` returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSuite
from repro_torch.launch import sharding as shp
from repro_torch.models.layers import dt
from repro_torch.models.registry import (abstract_model, extra_inputs,
                                         input_specs)
from repro_torch.models.sharding import on_mesh
from repro_torch.train.optimizer import OptimizerConfig, init_state
from repro_torch.train.trainstep import make_train_step
from repro_torch.weights import init_params


class Args(tuple):
    """A cell's arguments, with the cell's ``cfg`` and ``suite`` and
    ``specs``: the same structure as the arguments, a spec for every
    tensor (None where an argument is None)."""

    def __new__(cls, args, cfg: ModelConfig, suite: ShapeSuite, specs):
        out = super().__new__(cls, args)
        out.cfg, out.suite, out.specs = cfg, suite, specs
        return out

    def like(self, args) -> "Args":
        return Args(args, self.cfg, self.suite, self.specs)


def _place(tree, specs, mesh):
    """Every tensor of ``tree`` placed by its spec (``shp.distribute``)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _place(v, specs[k], mesh) for k, v in tree.items()}
    return shp.distribute(tree, mesh, specs)


def _bind(model: nn.Module, params: Mapping[str, nn.Parameter]) -> None:
    """Make ``params`` the model's parameters, by name, without a copy."""
    for name, p in params.items():
        prefix, _, attr = name.rpartition(".")
        mod = model.get_submodule(prefix)
        if getattr(mod, attr) is not p:
            setattr(mod, attr, p)


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def abstract_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The meta model's parameters by name: shapes and dtypes only."""
    return dict(model.named_parameters())


def _cache_abs(model: nn.Module, cfg: ModelConfig, suite: ShapeSuite):
    return model.init_cache(suite.global_batch, suite.seq_len,
                            dt(cfg.kv_cache_dtype), device="meta")


def build_train_cell(cfg: ModelConfig, suite: ShapeSuite, mesh, rules,
                     accum_steps: int = 1, ce_chunk: int = 512,
                     remat: str = "block",
                     opt_cfg: Optional[OptimizerConfig] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) under the cell's rules; params and moments placed by
    ``param_specs`` and updated in place, the batch by ``batch_specs``,
    the metrics whole on every rank."""
    if cfg.remat == "none" and remat != "none":
        cfg = dataclasses.replace(cfg, remat=remat)
    model = abstract_model(cfg)
    step = make_train_step(model, opt_cfg or OptimizerConfig(),
                           accum_steps=accum_steps,
                           ce_chunk=min(ce_chunk, suite.seq_len))
    p_abs = abstract_params(model)
    opt_abs = init_state(p_abs)
    batch_abs = input_specs(cfg, suite)
    p_spec = shp.param_specs(p_abs, cfg, mesh, rules)
    opt_spec = {"step": (), "mu": p_spec, "nu": p_spec}
    b_spec = shp.batch_specs(batch_abs, rules)

    def fn(params, opt_state, batch):
        with on_mesh(mesh, rules):
            _bind(model, params)
            batch = _place(batch, b_spec, mesh)
            params, opt_state, metrics = step(params, opt_state, batch)
            return params, opt_state, {k: _whole(v)
                                       for k, v in metrics.items()}
    fn.model = model
    return fn, Args((p_abs, opt_abs, batch_abs), cfg, suite,
                    (p_spec, opt_spec, b_spec))


def build_prefill_cell(cfg: ModelConfig, suite: ShapeSuite, mesh, rules):
    """prefill(params, tokens, lengths, cache, extra) -> (logits (B,
    V_pad) placed (batch, -), cache), the cache written in place."""
    model = abstract_model(cfg)
    p_abs = abstract_params(model)
    specs = input_specs(cfg, suite)
    cache_abs = _cache_abs(model, cfg, suite)
    extra_abs = extra_inputs(cfg, suite.global_batch) or None
    b = rules.get("batch")
    p_spec = shp.param_specs(p_abs, cfg, mesh, rules)
    c_spec = shp.cache_specs(cache_abs, cfg, mesh, rules,
                             suite.global_batch, suite.seq_len)
    e_spec = shp.batch_specs(extra_abs, rules) if extra_abs else None

    def fn(params, tokens, lengths, cache, extra=None):
        with on_mesh(mesh, rules), torch.no_grad():
            _bind(model, params)
            cache = _place(cache, c_spec, mesh)
            kw = {"extra": _place(extra, e_spec, mesh)} if extra else {}
            logits = model.prefill(_place(tokens, (b, None), mesh),
                                   _place(lengths, (b,), mesh), cache, **kw)
            return _place(logits, (b, None), mesh), cache
    fn.model = model
    return fn, Args((p_abs, specs["tokens"], specs["lengths"], cache_abs,
                     extra_abs), cfg, suite,
                    (p_spec, (b, None), (b,), c_spec, e_spec))


def build_decode_cell(cfg: ModelConfig, suite: ShapeSuite, mesh, rules):
    """serve_step(params, tokens (B, 1), lengths, cache) -> (logits (B,
    V_pad) placed (batch, -), cache): one new token against a seq_len
    cache, written in place."""
    model = abstract_model(cfg)
    p_abs = abstract_params(model)
    specs = input_specs(cfg, suite)
    cache_abs = _cache_abs(model, cfg, suite)
    b = rules.get("batch")
    p_spec = shp.param_specs(p_abs, cfg, mesh, rules)
    c_spec = shp.cache_specs(cache_abs, cfg, mesh, rules,
                             suite.global_batch, suite.seq_len)

    def fn(params, tokens, lengths, cache):
        with on_mesh(mesh, rules), torch.no_grad():
            _bind(model, params)
            cache = _place(cache, c_spec, mesh)
            logits = model.decode_step(_place(tokens, (b, None), mesh),
                                       _place(lengths, (b,), mesh), cache)
            return _place(logits, (b, None), mesh), cache
    fn.model = model
    return fn, Args((p_abs, specs["tokens"], specs["lengths"], cache_abs),
                    cfg, suite, (p_spec, (b, None), (b,), c_spec))


def build_cell(cfg: ModelConfig, suite: ShapeSuite, mesh,
               rules: Optional[Dict] = None, **kw):
    rules = rules if rules is not None else shp.make_rules(cfg, mesh, suite)
    if suite.kind == "train":
        fn, args = build_train_cell(cfg, suite, mesh, rules, **kw)
    elif suite.kind == "prefill":
        fn, args = build_prefill_cell(cfg, suite, mesh, rules)
    else:
        fn, args = build_decode_cell(cfg, suite, mesh, rules)
    return fn, args, rules


# ------------------------------------------------------------ real inputs --
def materialize(args: Args, mesh, generator: torch.Generator) -> Args:
    """Real arguments for a cell, placed on ``mesh`` by ``args.specs``:
    the port's seeded init for the parameters (``weights.init_params``;
    they require a gradient in a train cell), zero moments and a zero
    cache, token ids drawn below the vocab size (labels equal to the
    tokens), every length the suite's sequence length (one less for a
    decode: its new token takes the cache's last position), frontend
    inputs drawn standard normal. Every rank draws the same values from
    the same ``generator`` (on the mesh's device) and keeps its shards."""
    cfg, suite, specs = args.cfg, args.suite, args.specs
    dev = torch.device(mesh.device_type)
    train = suite.kind == "train"

    def place(val, spec):
        return shp.distribute(val, mesh, spec)

    def draw(t: torch.Tensor, spec):
        if t.dtype in (torch.int32, torch.int64):
            val = torch.randint(0, cfg.vocab_size, tuple(t.shape),
                                generator=generator, device=dev,
                                dtype=t.dtype)
        else:
            val = torch.randn(tuple(t.shape), generator=generator,
                              device=dev).to(t.dtype)
        return place(val, spec)

    state = init_params(cfg, generator, dev)
    params = {n: nn.Parameter(place(state.pop(n), specs[0][n]),
                              requires_grad=train) for n in args[0]}
    if train:
        batch = {k: draw(v, specs[2][k]) for k, v in args[2].items()}
        batch["labels"] = batch["tokens"].clone()
        return args.like((params, init_state(params), batch))
    n = suite.seq_len - (suite.kind == "decode")
    lengths = place(torch.full(tuple(args[2].shape), n, dtype=args[2].dtype,
                               device=dev), specs[2])
    cache = {k: place(torch.zeros(tuple(t.shape), dtype=t.dtype,
                                  device=dev), specs[3][k])
             for k, t in args[3].items()}
    out = (params, draw(args[1], specs[1]), lengths, cache)
    if suite.kind == "prefill":
        out += ({k: draw(v, specs[4][k]) for k, v in args[4].items()}
                if args[4] else None,)
    return args.like(out)


# --------------------------------------------------- analysis variants -----
def probe_config(cfg: ModelConfig, units: int) -> ModelConfig:
    """A pattern-preserving shallow config (for per-layer probes)."""
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        n = units * cfg.shared_attn_every
    elif cfg.cross_attn_every:
        n = units * cfg.cross_attn_every
    elif cfg.family == "ssm" and cfg.ssm.slstm_every:
        n = units * cfg.ssm.slstm_every
    else:
        n = units + cfg.moe.first_dense_layers
    over: Dict[str, Any] = {"n_layers": n}
    if cfg.family == "audio":
        over["n_encoder_layers"] = max(1, units)
    return dataclasses.replace(cfg, **over)


def pattern_unit(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        return cfg.shared_attn_every
    if cfg.cross_attn_every:
        return cfg.cross_attn_every
    if cfg.family == "ssm" and cfg.ssm.slstm_every:
        return cfg.ssm.slstm_every
    return 1
