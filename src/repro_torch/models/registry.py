"""Model registry: ``ModelConfig`` -> a built model on a device.

Port of ``repro.models.registry.build_model`` for the dense family, the
MoE family with MLA attention and the Mamba2 + shared-attention hybrid.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from torch import nn

from repro_torch import device as devices
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.transformer import Transformer
from repro_torch.weights import StateDict, init_params


def _meta_model(cfg) -> nn.Module:
    families = {"dense": Transformer, "moe": Transformer, "hybrid": Hybrid}
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port builds the "
            f"dense, MoE and hybrid families so far")
    with torch.device("meta"):
        return families[cfg.family](cfg, "meta")


def build_shell(cfg, *, device: Union[str, torch.device] = "cuda"
                ) -> nn.Module:
    """``cfg``'s model with every parameter an empty tensor on ``device``
    (of the parameter's dtype): the structure without the weights, which
    arrive later by ``InferenceEngine.restore_device_state``. Allocates
    nothing of the model's size."""
    dev = devices.resolve(device)
    shell = _meta_model(cfg)
    for mod in shell.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, nn.Parameter(
                torch.empty((0,), dtype=p.dtype, device=dev),
                requires_grad=False))
    return shell


def build_model(cfg, *, device: Union[str, torch.device] = "cuda",
                params: Optional[StateDict] = None,
                seed: int = 0) -> nn.Module:
    """Build ``cfg``'s model on ``device`` (the card unless ``"cpu"`` is
    asked for; raises when there is no card). Weights are ``params`` (a
    state dict, e.g. from ``repro_torch.weights.from_jax_params``), whose
    tensors become the parameters without a copy when they already have
    the device and dtype; else the port's own init from ``seed``."""
    dev = devices.resolve(device)
    model = _meta_model(cfg)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, dev)
    params = {k: v.to(dev) for k, v in params.items()}
    model.load_state_dict(params, strict=True, assign=True)
    return model
