"""Weight bridge: a Llama parameter tree held as numpy arrays (the JAX
package's layout — layer-stacked ``[L, ...]`` block leaves, int8 weights
as ``{"q", "s"}`` dicts) becomes the port's ``Llama`` module.

Weights keep the ``[K, N]`` orientation on both sides, so the bridge is a
copy: block leaf ``blocks[name][l]`` becomes ``model.blocks[l].<name>``.
bfloat16 arrays (numpy's extension dtype) are carried bit for bit."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import resolve_device
from .models.llama import Llama, LlamaConfig
from .ops.quant import Int8Weight


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf(v, device):
    if isinstance(v, Mapping):
        return Int8Weight(tensor_from_numpy(v["q"], device),
                          tensor_from_numpy(v["s"], device))
    return torch.nn.Parameter(tensor_from_numpy(v, device),
                              requires_grad=False)


def _layer(v, i: int):
    if isinstance(v, Mapping):
        return {"q": np.asarray(v["q"])[i], "s": np.asarray(v["s"])[i]}
    return np.asarray(v)[i]


def params_from_numpy(tree: Dict, cfg: LlamaConfig, device="cuda") -> Llama:
    """The JAX-layout tree ``tree`` (numpy leaves) as a ``Llama`` on
    ``device``."""
    device = resolve_device(device)
    model = Llama(cfg, device)
    for name in ("embed", "final_norm", "lm_head"):
        delattr(model, name)
        setattr(model, name, _leaf(tree[name], device))
    for i, blk in enumerate(model.blocks):
        for name, v in tree["blocks"].items():
            delattr(blk, name)
            setattr(blk, name, _leaf(_layer(v, i), device))
    return model
