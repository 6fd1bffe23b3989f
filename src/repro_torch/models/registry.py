"""Model registry: ``ModelConfig`` -> a built model on a device, and the
shapes of a model's inputs.

Port of ``repro.models.registry``: ``build_model`` for every family the
reference builds (dense, MoE with MLA attention, the Mamba2 +
shared-attention hybrid, xLSTM, the audio encoder-decoder and the
cross-attention VLM), and ``extra_inputs``/``input_specs``, the shapes
and dtypes of the frontend stubs' inputs and of a shape suite's model
inputs as meta tensors (the reference's ``ShapeDtypeStruct``s), which
allocate nothing.

``build_model`` and ``build_shell`` refuse a config whose weights exceed
the memory of the device they would go on (Qwen3-MoE's 470 GB in bf16
against one H100's 80 GB), naming the sizes, before allocating anything:
such a model is only planned, on the meta device, by the sharded path.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch

from torch import nn

from repro_torch import device as devices
from repro_torch.configs.shapes import ShapeSuite
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.transformer import Transformer
from repro_torch.models.vision import Vision
from repro_torch.models.xlstm import XLSTM
# the module, not its names: ``repro_torch.weights`` imports
# ``repro_torch.models`` itself, and either may be imported first
from repro_torch import weights


def _meta_model(cfg) -> nn.Module:
    families = {"dense": Transformer, "moe": Transformer, "hybrid": Hybrid,
                "ssm": XLSTM, "audio": EncDec, "vlm": Vision}
    if cfg.family not in families:
        raise ValueError(f"unknown family {cfg.family!r}")
    with torch.device("meta"):
        return families[cfg.family](cfg, "meta")


def abstract_model(cfg) -> nn.Module:
    """``cfg``'s model on the meta device: every parameter's name, shape
    and dtype, nothing allocated (the reference's ``eval_shape`` of
    ``init``; what the step builders plan and place)."""
    return _meta_model(cfg)


def extra_inputs(cfg, batch: int, dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """The frontend stubs' inputs (precomputed embeddings) as meta
    tensors: ``frames`` (batch, encoder_seq_len, d_model) for the audio
    family, ``patches`` (batch, vision_tokens, vision_dim) for the VLM,
    nothing for the others."""
    if cfg.family == "audio":
        return {"frames": torch.empty((batch, cfg.encoder_seq_len,
                                       cfg.d_model), dtype=dtype,
                                      device="meta")}
    if cfg.family == "vlm":
        return {"patches": torch.empty((batch, cfg.vision_tokens,
                                        cfg.vision_dim), dtype=dtype,
                                       device="meta")}
    return {}


def input_specs(cfg, suite: ShapeSuite) -> Dict[str, torch.Tensor]:
    """Meta tensors standing for every model input of a shape suite:
    train {tokens, labels (+frontend)}, prefill {tokens, lengths
    (+frontend)}, decode {tokens (B, 1), lengths} (the cache comes from
    ``init_cache``)."""
    B, S = suite.global_batch, suite.seq_len

    def tok(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")
    if suite.kind == "train":
        return {"tokens": tok(B, S), "labels": tok(B, S),
                **extra_inputs(cfg, B)}
    if suite.kind == "prefill":
        return {"tokens": tok(B, S), "lengths": tok(B),
                **extra_inputs(cfg, B)}
    if suite.kind == "decode":
        return {"tokens": tok(B, 1), "lengths": tok(B)}
    raise ValueError(suite.kind)


def _device_bytes(dev: torch.device) -> int:
    """The memory of ``dev``: the card's, or the host's for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_fits(cfg, model: nn.Module, dev: torch.device) -> None:
    """Refuse, naming the sizes, a config whose weights (those of
    ``model``, its meta-device build) alone exceed the memory of the
    device they would be allocated on."""
    n = sum(p.numel() for p in model.parameters())
    need = sum(p.numel() * p.element_size() for p in model.parameters())
    have = _device_bytes(dev)
    if need > have:
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "this host")
        raise ValueError(
            f"{cfg.arch_id} does not fit one card: its {n / 1e9:.0f} B "
            f"parameters are {need / 1e9:.0f} GB in "
            f"{'bf16' if cfg.param_dtype == 'bfloat16' else cfg.param_dtype}"
            f", more than the {have / 1e9:.0f} GB of {name}: plan it "
            f"sharded on a mesh (launch.steps, on the meta device) instead "
            f"of allocating it")


def build_shell(cfg, *, device: Union[str, torch.device] = "cuda"
                ) -> nn.Module:
    """``cfg``'s model with every parameter an empty tensor on ``device``
    (of the parameter's dtype): the structure without the weights, which
    arrive later by ``InferenceEngine.restore_device_state``. Allocates
    nothing of the model's size."""
    dev = devices.resolve(device)
    shell = _meta_model(cfg)
    check_fits(cfg, shell, dev)
    for mod in shell.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, nn.Parameter(
                torch.empty((0,), dtype=p.dtype, device=dev),
                requires_grad=False))
    return shell


def build_model(cfg, *, device: Union[str, torch.device] = "cuda",
                params: Optional["weights.StateDict"] = None,
                seed: int = 0) -> nn.Module:
    """Build ``cfg``'s model on ``device`` (the card unless ``"cpu"`` is
    asked for; raises when there is no card). Weights are ``params`` (a
    state dict, e.g. from ``repro_torch.weights.from_jax_params``), whose
    tensors become the parameters without a copy when they already have
    the device and dtype; else the port's own init from ``seed``."""
    dev = devices.resolve(device)
    model = _meta_model(cfg)
    check_fits(cfg, model, dev)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = weights.init_params(cfg, gen, dev)
    params = {k: v.to(dev) for k, v in params.items()}
    model.load_state_dict(params, strict=True, assign=True)
    return model
