"""Weight bridge between parameter trees held as numpy arrays (the JAX
package's layout) and the port's modules: a Llama tree (layer-stacked
``[L, ...]`` block leaves, int8 weights as ``{"q", "s"}`` dicts) and the
port's ``Llama`` both ways, and into the port a BERT tree
(``bert_params_from_numpy``) and a ResNet tree
(``resnet_params_from_numpy``).

Matmul weights keep the ``[K, N]`` orientation on both sides, so for the
Llama and BERT trees the bridge is a copy: block leaf ``blocks[name][l]``
becomes ``model.blocks[l].<name>``. An MoE block's leaves (the f32
``router``, the expert stacks, plain or ``{"q", "s"}``) are carried the
same way. ResNet's HWIO conv weights become OIHW. bfloat16 arrays
(numpy's extension dtype) are carried into the port bit for bit;
``params_to_numpy`` widens bfloat16 to float32 (exactly), so it needs no
numpy extension dtype."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import resolve_device
from .models.bert import Bert, BertConfig
from .models.llama import Llama, LlamaConfig, rank_model
from .models.resnet import ResNet, ResNetConfig
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
                      trainable: bool = False, mesh=None,
                      specs: str = "serving") -> Llama:
    """The JAX-layout tree ``tree`` (numpy leaves) as a ``Llama`` on
    ``device``; ``trainable`` parameters take gradients.

    ``mesh`` (a ``DeviceMesh`` with named dims) keeps only this rank's
    slice of each leaf, cut from the numpy array before the upload, so
    the rank never holds the whole model on ``device``. ``specs`` says
    which slices: ``"serving"``, those ``models.llama.serving_weight_specs``
    cuts (the weights of one rank of a ``ContinuousBatcher(mesh=mesh,
    weight_sharding=True)``; int8 leaves are cut after quantisation: a
    column slice takes its scale columns, a row slice keeps the scale
    whole); ``"training"``, every leaf by ``models.llama.param_specs`` (a
    rank of ``make_train_step(cfg, mesh, ...)`` or of ``generate(mesh=)``;
    an MoE model's router columns and expert stacks over ep), each rank's
    block the same slice of the unsharded tree, an int8 leaf of a tree
    quantized whole (JAX's ``quantize_llama_params``) cut by
    ``models.llama.int8_specs`` (``q`` as the weight, the scale's columns
    with it); ``"pipeline"``, a stage's layers of every
    block leaf and every other leaf whole (a rank of a mesh with a ``pp``
    axis, ``models.pipeline``)."""
    device = resolve_device(device)
    if specs not in ("serving", "training", "pipeline"):
        raise ValueError(f"specs must be 'serving', 'training' or "
                         f"'pipeline', got {specs!r}")
    sizes = None
    if mesh is not None:
        from .models.llama import (
            map_weight_tree, param_specs, serving_weight_specs)
        from .parallel.sharding import mesh_coords, rank_slice

        sizes, index = mesh_coords(mesh)

        def cut(a, spec):
            return rank_slice(np.asarray(a), spec, sizes, index)

        if specs == "training":
            tree = map_weight_tree(tree, param_specs(cfg), cut)
        elif specs == "pipeline":        # the layer stack over pp
            tree = {**tree, "blocks": {k: cut(v, ("pp",))
                                       for k, v in tree["blocks"].items()}}
        else:
            tree = {**tree, "blocks": map_weight_tree(
                tree["blocks"], serving_weight_specs(tree)["blocks"], cut)}
    # The full-size zeros of the module's construction stay on the host
    # when the leaves are slices.
    model = (rank_model(cfg, sizes if specs == "pipeline" else None)
             if mesh is not None else Llama(cfg, device))
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
    # The numpy bridge reads the weights back by design, off every dispatch:
    # graftcheck: ignore[host-sync]
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


def bert_params_from_numpy(tree: Dict, cfg: BertConfig,
                           device="cuda") -> Bert:
    """A JAX-layout BERT tree (numpy leaves) as a ``Bert`` on ``device``
    (frozen parameters, as ``init_params`` makes them)."""
    device = resolve_device(device)
    model = Bert(cfg, device)
    for name in ("tok_embed", "pos_embed", "final_ln_s", "final_ln_b",
                 "cls"):
        delattr(model, name)
        setattr(model, name, _leaf(tree[name], device, False))
    for i, blk in enumerate(model.blocks):
        for name, v in tree["blocks"].items():
            delattr(blk, name)
            setattr(blk, name, _leaf(np.asarray(v)[i], device, False))
    return model


def resnet_params_from_numpy(tree: Dict, cfg: ResNetConfig,
                             device="cuda") -> ResNet:
    """A JAX-layout ResNet tree (numpy leaves; HWIO convs) as a trainable
    ``ResNet`` on ``device``: each conv copied into the port's OIHW
    weight, the stages' zero-size projection placeholders skipped."""
    device = resolve_device(device)
    model = ResNet(cfg, device)

    def conv(dst, w):
        dst.copy_(tensor_from_numpy(w, device).permute(3, 2, 0, 1))

    def bn(dst, src):
        dst.scale.copy_(tensor_from_numpy(src["scale"], device))
        dst.bias.copy_(tensor_from_numpy(src["bias"], device))

    with torch.no_grad():
        conv(model.stem, tree["stem"]["conv"])
        bn(model.stem_bn, tree["stem"])
        for blocks, src_blocks in zip(model.stages, tree["stages"]):
            for blk, src in zip(blocks, src_blocks):
                for i in (1, 2, 3):
                    conv(getattr(blk, f"c{i}"), src[f"c{i}"])
                    bn(getattr(blk, f"b{i}"), src[f"b{i}"])
                if blk.proj is not None:
                    conv(blk.proj, src["proj"])
                    bn(blk.bproj, src["bproj"])
        model.head.copy_(tensor_from_numpy(tree["head"], device))
    return model
