"""The benchmark's weights: drawn on the card from the seed, in the type
they are trained in, one generator per leaf so that any leaf can be drawn
again alone (the training comparison redraws the initial weights). The
port's model is built around these tensors; the reference is given
float32 copies of the same leaves, drawn again from the seed."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cfg: Dict, **over):
    """The port's ``LlamaConfig`` for a configuration file."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    pc = LlamaConfig(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"],
        max_seq=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        dtype=DTYPES[cfg["torch_dtype"]])
    return dataclasses.replace(pc, **over)


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of every weight of a dense decoder, in draw
    order; matrices are [in, out] (x @ w)."""
    D, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // H
    dt = DTYPES[cfg["torch_dtype"]]
    out = [("embed", (V, D), dt)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        out += [(p + "attn_norm", (D,), dt), (p + "wq", (D, H * hd), dt),
                (p + "wk", (D, Hkv * hd), dt), (p + "wv", (D, Hkv * hd), dt),
                (p + "wo", (H * hd, D), dt), (p + "mlp_norm", (D,), dt),
                (p + "w_gate", (D, F), dt), (p + "w_up", (D, F), dt),
                (p + "w_down", (F, D), dt)]
    return out + [("final_norm", (D,), dt), ("lm_head", (D, V), dt)]


def leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 7,
                                       index]).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1)


def draw_leaf(cfg: Dict, seed: int, name: str, device) -> torch.Tensor:
    """One leaf as ``draw`` makes it: norms 1, matrices normal(0, 0.02)."""
    for i, (n, shape, dt) in enumerate(leaves(cfg)):
        if n == name:
            if n.endswith("norm"):
                return torch.ones(shape, dtype=dt, device=device)
            gen = torch.Generator(device=device)
            gen.manual_seed(leaf_seed(seed, i))
            return torch.empty(shape, dtype=dt, device=device).normal_(
                0.0, 0.02, generator=gen)
    raise KeyError(name)


def draw(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {n: draw_leaf(cfg, seed, n, device) for n, _, _ in leaves(cfg)}


def port_model(pcfg, weights: Dict[str, torch.Tensor]):
    """The port's ``Llama`` holding ``weights`` (the same storage)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import Llama

    model = Llama(pcfg, "meta")
    for name, t in weights.items():
        mod, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod) if mod else model, leaf,
                torch.nn.Parameter(t, requires_grad=False))
    return model
