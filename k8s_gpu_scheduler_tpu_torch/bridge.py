"""Weight bridge between a Llama parameter tree held as numpy arrays (the
JAX package's layout — layer-stacked ``[L, ...]`` block leaves, int8
weights as ``{"q", "s"}`` dicts) and the port's ``Llama`` module, both
ways.

Weights keep the ``[K, N]`` orientation on both sides, so the bridge is a
copy: block leaf ``blocks[name][l]`` becomes ``model.blocks[l].<name>``.
bfloat16 arrays (numpy's extension dtype) are carried into the port bit
for bit; ``params_to_numpy`` widens bfloat16 to float32 (exactly), so it
needs no numpy extension dtype."""
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


def _leaf(v, device, trainable: bool):
    if isinstance(v, Mapping):
        return Int8Weight(tensor_from_numpy(v["q"], device),
                          tensor_from_numpy(v["s"], device))
    return torch.nn.Parameter(tensor_from_numpy(v, device),
                              requires_grad=trainable)


def _layer(v, i: int):
    if isinstance(v, Mapping):
        return {"q": np.asarray(v["q"])[i], "s": np.asarray(v["s"])[i]}
    return np.asarray(v)[i]


def params_from_numpy(tree: Dict, cfg: LlamaConfig, device="cuda",
                      trainable: bool = False) -> Llama:
    """The JAX-layout tree ``tree`` (numpy leaves) as a ``Llama`` on
    ``device``; ``trainable`` parameters take gradients."""
    device = resolve_device(device)
    model = Llama(cfg, device)
    for name in ("embed", "final_norm", "lm_head"):
        delattr(model, name)
        setattr(model, name, _leaf(tree[name], device, trainable))
    for i, blk in enumerate(model.blocks):
        for name, v in tree["blocks"].items():
            delattr(blk, name)
            setattr(blk, name, _leaf(_layer(v, i), device, trainable))
    return model


def _to_numpy(v):
    if isinstance(v, Int8Weight):
        return {"q": _to_numpy(v.q), "s": _to_numpy(v.s)}
    t = v.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(model: Llama) -> Dict:
    """The inverse of ``params_from_numpy``: the JAX-layout tree with
    numpy leaves, block leaves stacked ``[L, ...]`` (bfloat16 widened to
    float32)."""
    def stack(leaves):
        if isinstance(leaves[0], dict):
            return {k: np.stack([x[k] for x in leaves]) for k in leaves[0]}
        return np.stack(leaves)

    names = [n for n, _ in model.blocks[0].named_children()] + [
        n for n, _ in model.blocks[0].named_parameters(recurse=False)]
    tree = {name: _to_numpy(getattr(model, name))
            for name in ("embed", "final_norm", "lm_head")}
    tree["blocks"] = {name: stack([_to_numpy(getattr(blk, name))
                                   for blk in model.blocks])
                      for name in names}
    return tree
