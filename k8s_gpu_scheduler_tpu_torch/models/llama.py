"""Llama-family decoder (port of the JAX package's ``models/llama.py``:
config, forward, the training step on one device and on a mesh, and the
pod's entry point).

``Llama`` is an ``nn.Module`` whose ``blocks`` ``ModuleList`` replaces the
JAX package's layer-stacked pytree and ``lax.scan``; weights keep JAX's
``[K, N]`` orientation (``x @ w``), so an int8 weight's per-output-channel
scale stays ``[1, N]`` and the weight bridge (``bridge.py``) is a copy.
Randomness comes only from the ``torch.Generator`` passed to
``init_params``. Parameters are created frozen (serving builds no autograd
graph); ``make_optimizer`` makes them trainable.

Mixture-of-experts configs (``n_experts > 1``) swap every block's
SwiGLU for ``n_experts`` routed experts (``ops/moe.py``): training routes
with capacity and adds the Switch balance loss, serving routes dropless.

Training: ``loss_fn`` is the JAX package's causal-LM cross entropy,
``make_train_step`` its ``value_and_grad`` + optimizer update (in place
here: the model and the optimizer hold the state), ``jax.checkpoint`` per
block becomes ``torch.utils.checkpoint`` per block, and optax's
``adamw(lr)`` becomes ``torch.optim.AdamW`` with optax's defaults
(``make_optimizer``). ``attn_impl="flash"`` runs the flash kernels K5-K7
(``ops/flash_attention.py``).

Sharded training (``mesh=``, a ``DeviceMesh`` with named dp/fsdp/sp/ep/tp
dims, one process a rank) is rank-local SPMD: each rank holds its block
of every leaf by ``param_specs`` and writes out the collectives GSPMD
inserted for the JAX step (``parallel/collectives.py``). A block
all-gathers its fsdp-sharded weights, runs the column-parallel products
on the rank's heads and ffn columns, attention on its local heads (the
flash kernels at ``sp == 1``; ring or Ulysses attention over ``sp``) and
sums the row-parallel ``wo``/``w_down`` products over tp; an MoE block
runs the rank's E/ep experts (``ops/moe.py``). A ``pp`` axis holds
pipeline stages instead (``rank_layout``; ``models/pipeline.py`` trains
them). The embedding
and the loss are vocab-parallel, so no rank holds the [B, T, vocab]
logits. Gradients are summed over every axis that splits the tokens
(dp, fsdp, sp), so the loss is the mean over the global batch, and
``torch.optim.AdamW`` over the local blocks is the unsharded update. A
mesh of one rank runs the single-device code.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..device import resolve_device
from ..ops.attention import dense_attention, ring_attention, ulysses_attention
from ..ops.flash_attention import flash_attention_diff
from ..ops.layers import apply_rope, rms_norm, rope_freqs, swiglu
from ..ops.moe import moe_ffn, moe_ffn_dropless
from ..ops.quant import Int8Weight, qdot
from ..parallel.collectives import (
    all_gather, all_max_, all_reduce, all_reduce_, copy_to)


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "dense"
    # Serving decode attention: "fused" is the kernel path (K1/K2 on the
    # paged layout, K4 on the contiguous one), the only one the port's
    # engine serves.
    decode_attn: str = "dense"
    remat: bool = True
    # Mixture-of-experts (ops/moe.py): 0 = dense SwiGLU; > 1 routes every
    # block's FFN over n_experts experts, top moe_top_k a token, with the
    # balance loss scaled by moe_aux_coef in loss_fn.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            d_ff=14336, max_seq=8192)

    @staticmethod
    def serve() -> "LlamaConfig":
        """The ``main --serve`` configuration of the JAX package, which
        serves it through the paged engine: pass ``kv_layout="paged"`` (and
        ``prefix_cache=True``) to ``ContinuousBatcher`` explicitly, since its
        default layout is ``"contiguous"`` as in the JAX engine."""
        return LlamaConfig(
            vocab=32000, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
            d_ff=4096, max_seq=2048, remat=False)

    @staticmethod
    def tiny(attn_impl: str = "dense") -> "LlamaConfig":
        """Test scale: full architecture, toy widths."""
        return LlamaConfig(
            vocab=256, d_model=64, n_layers=2, n_heads=8, n_kv_heads=8,
            d_ff=128, max_seq=128, attn_impl=attn_impl, remat=False)

    def flops_per_token(self, seq_len: int = 0) -> float:
        """Train-step FLOPs/token (the MFU numerator): 6 x the matmul
        parameters, plus the causal attention products when ``seq_len`` is
        given — QK^T and PV are each 2·T·d FLOPs/token/layer forward, 3x
        that with backward, halved because the flash kernels skip the
        fully masked half: 6·L·d·T per token. No remat counted."""
        p_block = (
            self.d_model * self.n_heads * self.head_dim  # wq
            + 2 * self.d_model * self.n_kv_heads * self.head_dim  # wk, wv
            + self.n_heads * self.head_dim * self.d_model  # wo
            + 3 * self.d_model * self.d_ff  # gate/up/down
        )
        p_matmul = self.n_layers * p_block + 2 * self.vocab * self.d_model
        attn = 6.0 * self.n_layers * self.d_model * seq_len
        return 6.0 * p_matmul + attn


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder block's weights: pre-norm attention + SwiGLU MLP, or,
    for MoE configs, the f32 ``router [D, E]`` and expert stacks
    ``w_gate``/``w_up [E, D, F]``, ``w_down [E, F, D]``."""

    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        D, H, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.d_ff)
        dt = cfg.dtype

        def z(*shape, dtype=dt):
            return _param(torch.zeros(shape, dtype=dtype, device=device))

        self.attn_norm = _param(torch.ones(D, dtype=dt, device=device))
        self.wq, self.wk, self.wv = z(D, H * hd), z(D, Hkv * hd), z(D, Hkv * hd)
        self.wo = z(H * hd, D)
        self.mlp_norm = _param(torch.ones(D, dtype=dt, device=device))
        if cfg.n_experts > 1:
            E = cfg.n_experts
            # f32: the softmax over experts decides placements.
            self.router = z(D, E, dtype=torch.float32)
            self.w_gate, self.w_up = z(E, D, F), z(E, D, F)
            self.w_down = z(E, F, D)
        else:
            self.w_gate, self.w_up, self.w_down = z(D, F), z(D, F), z(F, D)


class Llama(nn.Module):
    """The decoder's weights (``embed [V, D]``, ``blocks``, ``final_norm``,
    ``lm_head [D, V]``); ``forward(tokens)`` is the causal forward."""

    def __init__(self, cfg: LlamaConfig, device="cuda") -> None:
        super().__init__()
        # "meta": shapes only, for a rank that fills in its own blocks.
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        self.cfg = cfg
        self.embed = _param(torch.zeros(cfg.vocab, cfg.d_model,
                                        dtype=cfg.dtype, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(torch.ones(cfg.d_model, dtype=cfg.dtype,
                                            device=device))
        self.lm_head = _param(torch.zeros(cfg.d_model, cfg.vocab,
                                          dtype=cfg.dtype, device=device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def param_axes(cfg: LlamaConfig) -> Dict:
    """Logical sharding axes for every param leaf, in the JAX package's
    layer-stacked tree layout (the leading 'layers' axis is never
    sharded). MoE configs stack experts on a leading 'expert' axis (→ ep
    mesh axis) and add the router."""
    L = ("layers",)
    if cfg.n_experts > 1:
        mlp = {
            "mlp_norm": L + ("norm",),
            "router": L + ("embed", "expert"),
            "w_gate": L + ("expert", "embed", "mlp"),
            "w_up": L + ("expert", "embed", "mlp"),
            "w_down": L + ("expert", "mlp", "embed"),
        }
    else:
        mlp = {
            "mlp_norm": L + ("norm",),
            "w_gate": L + ("embed", "mlp"),
            "w_up": L + ("embed", "mlp"),
            "w_down": L + ("mlp", "embed"),
        }
    return {
        "embed": ("vocab", "embed"),
        "blocks": {
            "attn_norm": L + ("norm",),
            "wq": L + ("embed", "heads"),
            "wk": L + ("embed", "kv_heads"),
            "wv": L + ("embed", "kv_heads"),
            "wo": L + ("heads", "embed"),
            **mlp,
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def param_specs(cfg: LlamaConfig, rules: Optional[Dict] = None) -> Dict:
    """Specs (tuples of mesh-axis names) of the training tree, in the JAX
    layer-stacked layout: what each rank holds of every leaf in sharded
    training (``init_params(..., mesh=)``, ``bridge.params_from_numpy(...,
    mesh=, specs="training")``, ``make_train_step(cfg, mesh, ...)``)."""
    from ..parallel.sharding import logical_axis_rules, shard_params_spec

    return shard_params_spec(param_axes(cfg),
                             rules or logical_axis_rules({"layers": None}))


def _block_leaves(blk: nn.Module) -> Dict[str, object]:
    """A block's weights by name: tensors, and int8 ``Int8Weight``s."""
    out: Dict[str, object] = dict(blk.named_children())
    out.update(blk.named_parameters(recurse=False))
    return out


def _tree_view(params) -> Dict:
    """``params`` (a ``Llama``, or the JAX-layout tree of numpy leaves)
    as a JAX-layout tree whose block leaves are the first layer's, int8
    weights as ``{"q", "s"}``: the structure the spec walkers read."""
    if not isinstance(params, nn.Module):
        return params

    def leaf(v):
        return {"q": v.q, "s": v.s} if isinstance(v, nn.Module) else v

    return {"embed": params.embed, "final_norm": params.final_norm,
            "lm_head": leaf(params.lm_head),
            "blocks": {k: leaf(v)
                       for k, v in _block_leaves(params.blocks[0]).items()}}


def serving_weight_specs(params, rules: Optional[Dict] = None) -> Dict:
    """Per-leaf specs of a SERVING params tree under Megatron weight
    sharding (``ContinuousBatcher(weight_sharding=True)``), over the JAX
    layer-stacked ``[L, K, N]`` layout: the block projections and MLP
    weights slice per ``parallel.sharding.WEIGHT_SPECS`` — column-parallel
    q/k/v/gate/up on their OUTPUT axis, row-parallel o/down on their
    INPUT axis — and everything else (embed, norms, lm_head) replicates
    (``()``). ``params`` is a ``Llama`` or a JAX-layout tree. Walks the
    actual leaves, so int8 ``{"q","s"}`` leaves slice coherently: ``q``
    follows the weight's spec and the per-output-channel scale ``s``
    slices with a column's N and stays whole for a row slice (it spans
    the full contraction — slicing after quantization keeps every rank's
    dequant exact). Dense-MLP trees only: an MoE tree raises
    ``ValueError``."""
    from ..parallel.sharding import WEIGHT_SPECS, weight_slice_spec

    tree = _tree_view(params)

    def replicated(leaf):
        return {k: () for k in leaf} if isinstance(leaf, dict) else ()

    def block_leaf(name, leaf):
        kind = WEIGHT_SPECS.get(name)
        if kind is None:
            return replicated(leaf)
        spec = weight_slice_spec(kind, rules)
        if isinstance(leaf, dict):                   # int8 {"q","s"}
            return {"q": spec, "s": spec if kind == "column" else ()}
        return spec

    if "router" in tree.get("blocks", {}):
        raise ValueError(
            "serving weight sharding covers dense-MLP trees only "
            "(MoE expert stacks shard over ep, not tp)")
    out = {k: replicated(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: block_leaf(k, v) for k, v in tree["blocks"].items()}
    return out


def sliced_for_serving(model: Llama, sizes: Dict[str, int],
                       index: Dict[str, int]) -> Llama:
    """This rank's serving copy of ``model``: every
    ``serving_weight_specs`` leaf cut to the rank's block
    (``parallel.sharding.rank_slice`` at the mesh's axis ``sizes`` and the
    rank's coordinates ``index``), every replicated leaf shared with
    ``model``. A model whose sliced leaves are already this rank's size
    (``bridge.params_from_numpy(..., mesh=)``) is returned as it is; the
    source is never changed."""
    from ..parallel.sharding import rank_slice

    specs = serving_weight_specs(model)["blocks"]
    cfg = model.cfg
    wq = model.blocks[0].wq
    if tuple((wq.q if isinstance(wq, Int8Weight) else wq).shape) != (
            cfg.d_model, cfg.n_heads * cfg.head_dim):
        return model                           # sliced already

    def cut(t, spec):
        spec = spec[1:]                       # drop the stacked L axis
        if not any(spec):
            return t
        return rank_slice(t, spec, sizes, index).clone()

    out = Llama.__new__(Llama)
    nn.Module.__init__(out)
    out.cfg = cfg
    out.embed, out.final_norm = model.embed, model.final_norm
    out.lm_head = model.lm_head
    blocks = []
    for blk in model.blocks:
        nb = Block.__new__(Block)
        nn.Module.__init__(nb)
        for name, leaf in _block_leaves(blk).items():
            spec = specs[name]
            if isinstance(leaf, Int8Weight):
                leaf = Int8Weight(cut(leaf.q, spec["q"]),
                                  cut(leaf.s, spec["s"]))
            elif any(spec):
                leaf = _param(cut(leaf.detach(), spec))
            setattr(nb, name, leaf)
        blocks.append(nb)
    out.blocks = nn.ModuleList(blocks)
    return out


def int8_specs(spec: tuple) -> Dict[str, tuple]:
    """The specs of an int8 ``{"q","s"}`` leaf whose weight takes ``spec``
    (``param_specs``, over ``[..., K, N]``): ``q`` takes ``spec`` and the
    scale ``s [..., 1, N]`` the same with K's axis dropped, as the serving
    rule does: a column slice takes its scale columns, a row slice keeps
    the scale whole."""
    return {"q": spec, "s": spec[:-2] + (None,) + spec[-1:]}


def map_weight_tree(params, specs, fn):
    """Walk a params tree and its mirror-shaped spec tree together
    (nested dicts with array — or int8 ``{"q","s"}`` — leaves, the shape
    ``serving_weight_specs`` emits): ``fn(leaf, spec)`` at each leaf. An
    int8 leaf under one weight's spec (``param_specs``) walks
    ``int8_specs`` of it."""
    if isinstance(params, Mapping):
        if isinstance(specs, tuple):
            specs = int8_specs(specs)
        return {k: map_weight_tree(params[k], specs[k], fn) for k in params}
    return fn(params, specs)


def sliced_weight_bytes(model: Llama) -> int:
    """Bytes of ``model``'s tensors that ``serving_weight_specs`` slices
    (an int8 leaf's ``q``, and its scale with a column slice); 0 for an
    MoE model, which serves with replicated weights only."""
    if model.cfg.n_experts > 1:
        return 0
    specs = serving_weight_specs(model)["blocks"]
    total = 0
    for blk in model.blocks:
        for name, leaf in _block_leaves(blk).items():
            spec = specs[name]
            pairs = (((leaf.q, spec["q"]), (leaf.s, spec["s"]))
                     if isinstance(leaf, Int8Weight) else ((leaf, spec),))
            total += sum(t.numel() * t.element_size()
                         for t, sp in pairs if any(sp))
    return total


def _mesh_axes(mesh):
    """``parallel.mesh.MeshAxes`` of ``mesh``; None for no mesh or a mesh
    of one rank, which run the single-device code."""
    if mesh is None:
        return None
    from ..parallel.mesh import MeshAxes

    ax = MeshAxes.of(mesh)
    return ax if ax.size() > 1 else None


def leaf_specs(cfg: LlamaConfig) -> Dict[str, tuple]:
    """``param_specs`` by the name of each of ``Llama``'s parameters
    (``blocks.<i>.<leaf>`` takes the stacked spec without its layer
    axis)."""
    specs = param_specs(cfg)
    out = {}
    for name, _ in Llama(cfg, "meta").named_parameters():
        parts = name.split(".")
        out[name] = (specs["blocks"][parts[2]][1:] if parts[0] == "blocks"
                     else specs[parts[0]])
    return out


def _spec_axes(spec: tuple) -> set:
    return {a for dim in spec if dim
            for a in (dim if isinstance(dim, tuple) else (dim,))}


def _set_leaf(model: nn.Module, name: str, value) -> None:
    mod, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(mod) if mod else model, leaf, value)


def rank_model(cfg: LlamaConfig, sizes: Optional[Mapping[str, int]] = None
               ) -> Llama:
    """A ``Llama`` on the meta device with a rank's blocks: all
    ``cfg.n_layers`` of them, or a stage's L/P on a mesh with a ``pp``
    axis (the pipeline layout, ``models/pipeline.py``)."""
    model = Llama(cfg, "meta")
    n = len(model.blocks) // _stages(sizes)
    model.blocks = nn.ModuleList(list(model.blocks)[:n])
    return model


def _stages(sizes: Optional[Mapping[str, int]]) -> int:
    return (sizes or {}).get("pp", 1)


def rank_layout(cfg: LlamaConfig, sizes: Optional[Mapping[str, int]] = None,
                index: Optional[Mapping[str, int]] = None
                ) -> Dict[str, Tuple[str, tuple]]:
    """Where each parameter of a rank's model (``rank_model``, by its name
    there) lies in the whole model: the name of the whole model's
    parameter it is a block of, and the slices of it. On a mesh with a
    ``pp`` axis of P > 1, stage s holds layers [s·L/P, (s+1)·L/P) whole
    (its ``blocks.<i>`` is layer s·L/P + i: the layer stack split over
    pp) and every other leaf whole (the JAX package's
    ``pp_param_shardings``); on any other mesh each leaf's training block
    (``leaf_specs``); with no mesh, every leaf whole. A leaf the mesh
    cannot tile raises ``ValueError`` naming it."""
    from ..parallel.sharding import block_region

    sizes, index = sizes or {}, index or {}
    P = _stages(sizes)
    try:
        first = block_region((cfg.n_layers,), ("pp",), sizes,
                             index)[0].start if P > 1 else 0
    except ValueError as e:
        raise ValueError(f"the layer stack: {e}") from None
    specs = leaf_specs(cfg)
    axes = param_axes(cfg)["blocks"]
    heads = {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads}
    out = {}
    for name, p in rank_model(cfg, sizes).named_parameters():
        parts = name.split(".")
        whole = name
        if parts[0] == "blocks":
            whole = ".".join(["blocks", str(first + int(parts[1]))]
                             + parts[2:])
        spec = (None,) * p.dim() if P > 1 else specs[name]
        # A head is never split: its columns go to one rank.
        logical = axes[parts[2]][1:] if parts[0] == "blocks" else ()
        for unit, ax in zip(logical, spec):
            count = int(np.prod([sizes.get(a, 1) for a in _spec_axes((ax,))]))
            if unit in heads and heads[unit] % count:
                raise ValueError(f"leaf {whole}: its {heads[unit]} {unit} "
                                 f"do not split into {count} ranks")
        try:
            region = block_region(p.shape, spec, sizes, index)
        except ValueError as e:
            raise ValueError(f"leaf {whole}: {e}") from None
        out[name] = (whole, region)
    return out


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device="cuda", mesh=None) -> Llama:
    """Random weights: normal(0, 0.02) matrices (drawn in f32, cast to the
    model dtype; an MoE router stays f32) and unit norms, from
    ``generator`` alone. The draws are made on the CPU, one leaf at a
    time, so a seed gives the same weights on every device.

    ``mesh`` (a mesh of more than one rank): each leaf is drawn whole and
    only the rank's block of it (``rank_layout``: its training block, or
    its stage's layers on a mesh with a ``pp`` axis) is uploaded, so
    every rank holds exactly its slice of the unsharded init and never
    the whole model."""
    device = resolve_device(device)
    ax = _mesh_axes(mesh)
    sizes, index = (ax.sizes, ax.index) if ax is not None else ({}, {})
    mine = {whole: (name, region) for name, (whole, region)
            in rank_layout(cfg, sizes, index).items()}
    model = rank_model(cfg, sizes)
    for whole, p in list(Llama(cfg, "meta").named_parameters()):
        if whole.endswith("norm"):
            w = torch.ones(p.shape, dtype=p.dtype)
        else:
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32) * 0.02
        if whole in mine:
            name, region = mine[whole]
            # A copy: a view would keep the whole leaf alive on the host.
            _set_leaf(model, name, _param(w[region].to(device, p.dtype,
                                                       copy=True)))
    return model


def rank_leaf_shapes(cfg: LlamaConfig, sizes: Mapping[str, int],
                     int8: bool = False
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each of a rank's leaves on a mesh of axis
    ``sizes`` (``rank_layout``): the whole shape with each dim divided by
    the sizes of the axes its spec names, or a stage's layers whole.
    ``int8``: of the rank's ``ops.quant.quantize_llama_params(model,
    mesh=)``, each quantized leaf as ``<name>.q`` (int8) and ``<name>.s``
    (f32, K cut to 1), the names of its buffers."""
    from ..ops.quant import BLOCK_WEIGHTS

    dtypes = dict((n, p.dtype) for n, p in
                  rank_model(cfg, sizes).named_parameters())
    out = {}
    for name, (_, region) in rank_layout(cfg, sizes).items():
        shape = tuple(s.stop - s.start for s in region)
        if int8 and (name == "lm_head"
                     or name.rpartition(".")[2] in BLOCK_WEIGHTS):
            out[name + ".q"] = (shape, torch.int8)
            out[name + ".s"] = (shape[:-2] + (1,) + shape[-1:],
                                torch.float32)
        else:
            out[name] = (shape, dtypes[name])
    return out


def attn_sublayer(cfg: LlamaConfig, x: torch.Tensor, blk: Block,
                  angles: torch.Tensor, attention_fn) -> torch.Tensor:
    B, T, _ = x.shape
    h = rms_norm(x, blk.attn_norm)
    q = qdot(h, blk.wq).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = qdot(h, blk.wk).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = qdot(h, blk.wv).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, angles), apply_rope(k, angles)
    attn = attention_fn(q, k, v)
    return x + qdot(attn.reshape(B, T, cfg.n_heads * cfg.head_dim), blk.wo)


def mlp_sublayer(cfg: LlamaConfig, x: torch.Tensor, blk: Block,
                 dropless: bool = False
                 ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Pre-norm MLP half: dense SwiGLU or routed experts. Returns (x, the
    balance aux: an f32 scalar tensor from the capacity path, else 0.0,
    which costs the serving paths no launch). ``dropless`` routes every
    token to its top-k experts with no capacity (``moe_ffn_dropless``),
    making the output a per-token function: every serving path uses it.
    Training keeps the capacity path."""
    h = rms_norm(x, blk.mlp_norm)
    if cfg.n_experts > 1:
        if dropless:
            return x + moe_ffn_dropless(h, blk.router, blk.w_gate, blk.w_up,
                                        blk.w_down, top_k=cfg.moe_top_k), 0.0
        out, aux = moe_ffn(h, blk.router, blk.w_gate, blk.w_up, blk.w_down,
                           top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor)
        return x + out, aux
    return x + swiglu(h, blk.w_gate, blk.w_up, blk.w_down), 0.0


ATTN_IMPLS = ("dense", "flash", "ring", "ulysses")
# Mesh axes that split the tokens: the batch over (dp, fsdp), the
# sequence over sp (JAX's ``_constrain`` points). A gradient is summed
# over each of them that does not shard its leaf.
BATCH_AXES, TOKEN_AXES = ("dp", "fsdp"), ("dp", "fsdp", "sp")


def forward(model: Llama, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """tokens [B, T] → logits [B, T, vocab] f32 (on a mesh: this rank's
    block of both, ``forward_with_aux``)."""
    logits, _ = forward_with_aux(model, tokens, mesh)
    return logits


def _attention(cfg: LlamaConfig, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, ax=None) -> torch.Tensor:
    """Causal attention by ``cfg.attn_impl`` over this rank's q/k/v (the
    JAX package's dispatch, ``llama.py:225-262``). With the sequence whole
    (no ``sp`` axis): "flash" runs the flash kernels (K5 forward, K6/K7
    backward) on the local batch and heads, every other impl the dense
    reference. Over ``sp``: ring or Ulysses attention, flash falling back
    to the ring as in JAX; dense gathers K/V over ``sp``."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} not in {ATTN_IMPLS}")
    sp = None if ax is None else ax.group("sp")
    if sp is None:
        if cfg.attn_impl == "flash":
            return flash_attention_diff(q, k, v, True)
        return dense_attention(q, k, v, causal=True)
    if cfg.attn_impl == "dense":
        return dense_attention(q, all_gather(k, 1, sp), all_gather(v, 1, sp),
                               causal=True, q_offset=ax.index["sp"]
                               * q.shape[1])
    if cfg.attn_impl == "ulysses":
        return ulysses_attention(q, k, v, sp)
    return ring_attention(q, k, v, sp)


def forward_with_aux(model: Llama, tokens: torch.Tensor, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, T, vocab] f32, the mean over layers of the MoE balance
    aux — 0.0 for dense-MLP configs). With ``cfg.remat`` and autograd
    recording, each block is checkpointed: its activations are recomputed
    in the backward, as ``jax.checkpoint`` does in the JAX package.

    ``mesh`` (more than one rank): ``tokens`` are this rank's block
    [B / (dp·fsdp), T / sp] and the logits its block [.., vocab / tp]."""
    ax = _mesh_axes(mesh)
    if ax is not None:
        return _forward_sharded(model, tokens, ax)
    cfg = model.cfg
    B, T = tokens.shape
    angles = rope_freqs(cfg.head_dim, T, cfg.rope_theta, device=model.device)
    x = model.embed[tokens].to(cfg.dtype)

    def block(x, blk):
        x = attn_sublayer(cfg, x, blk, angles,
                          lambda q, k, v: _attention(cfg, q, k, v))
        return mlp_sublayer(cfg, x, blk)

    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for blk in model.blocks:
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(block, x, blk,
                                                       use_reentrant=False)
        else:
            x, aux = block(x, blk)
        auxes.append(aux)
    x = rms_norm(x, model.final_norm)
    logits = qdot(x, model.lm_head).float()
    if cfg.n_experts > 1:
        return logits, torch.stack(auxes).mean()
    return logits, torch.zeros((), dtype=torch.float32, device=model.device)


def _sharded_block(cfg: LlamaConfig, ax, x: torch.Tensor, blk: Block,
                   angles: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block on this rank: the fsdp blocks of each weight
    gathered at its use, q/k/v/gate/up on the rank's tp columns (local
    heads and ffn columns), ``wo``/``w_down`` on its rows, each followed
    by the sum over tp. ``copy_to`` before the column products sums their
    input gradients over tp in the backward. An MoE block runs its
    rank's experts (``moe_ffn(..., ax=)``). Returns (x, the block's
    balance aux: the global batch's for MoE, else 0)."""
    fsdp, tp = ax.group("fsdp"), ax.group("tp")
    n_tp, hd = ax.size("tp"), cfg.head_dim
    heads, kv_heads = cfg.n_heads // n_tp, cfg.n_kv_heads // n_tp
    B, T, _ = x.shape
    h = copy_to(rms_norm(x, blk.attn_norm), tp)
    q = (h @ all_gather(blk.wq, 0, fsdp)).reshape(B, T, heads, hd)
    k = (h @ all_gather(blk.wk, 0, fsdp)).reshape(B, T, kv_heads, hd)
    v = (h @ all_gather(blk.wv, 0, fsdp)).reshape(B, T, kv_heads, hd)
    q, k = apply_rope(q, angles), apply_rope(k, angles)
    attn = _attention(cfg, q, k, v, ax).reshape(B, T, heads * hd)
    x = x + all_reduce(attn @ all_gather(blk.wo, 1, fsdp), tp)
    if cfg.n_experts > 1:
        out, aux = moe_ffn(
            rms_norm(x, blk.mlp_norm), all_gather(blk.router, 0, fsdp),
            all_gather(blk.w_gate, 1, fsdp), all_gather(blk.w_up, 1, fsdp),
            all_gather(blk.w_down, 2, fsdp), top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, ax=ax)
        return x + out, aux
    h = copy_to(rms_norm(x, blk.mlp_norm), tp)
    return x + all_reduce(swiglu(h, all_gather(blk.w_gate, 0, fsdp),
                                 all_gather(blk.w_up, 0, fsdp),
                                 all_gather(blk.w_down, 1, fsdp)), tp), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def _forward_sharded(model: Llama, tokens: torch.Tensor, ax
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's logits block [B_l, T_l, vocab / tp] f32 from its
    tokens [B_l, T_l], and the mean over layers of the global batch's
    balance aux. The embedding is vocab-parallel: each tp rank looks up
    the tokens in its rows (zero elsewhere) and the sum over tp assembles
    every row."""
    cfg = model.cfg
    _refuse_pipeline(ax)
    fsdp, tp = ax.group("fsdp"), ax.group("tp")
    B, T = tokens.shape
    t0 = ax.index.get("sp", 0) * T
    angles = rope_freqs(cfg.head_dim, t0 + T, cfg.rope_theta,
                        device=model.device)[t0:]
    table = all_gather(model.embed, 1, fsdp)            # [V / tp, D]
    if tp is None:
        x = table[tokens]
    else:
        rows = table.shape[0]
        local = tokens - ax.index["tp"] * rows
        hit = (local >= 0) & (local < rows)
        x = all_reduce(torch.where(hit[..., None],
                                   table[local.clamp(0, rows - 1)], 0), tp)
    x = x.to(cfg.dtype)

    def block(x, blk):
        return _sharded_block(cfg, ax, x, blk, angles)

    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for blk in model.blocks:
        x, aux = (torch.utils.checkpoint.checkpoint(block, x, blk,
                                                    use_reentrant=False)
                  if remat else block(x, blk))
        auxes.append(aux)
    h = copy_to(rms_norm(x, model.final_norm), tp)
    logits = (h @ all_gather(model.lm_head, 0, fsdp)).float()
    return logits, torch.stack(auxes).mean()


def _nll_sharded(logits: torch.Tensor, targets: torch.Tensor, ax
                 ) -> torch.Tensor:
    """logsumexp(logits) - logits[target] per token from this rank's
    vocab block: the max, the sum of exp and the target's logit are each
    combined over tp, so the whole-vocab logits never exist on a rank."""
    tp = ax.group("tp")
    if tp is None:
        return (torch.logsumexp(logits, dim=-1)
                - logits.gather(-1, targets[..., None])[..., 0])
    rows = logits.shape[-1]
    m = all_max_(logits.detach().amax(dim=-1), tp)
    lse = m + torch.log(all_reduce(
        torch.exp(logits - m[..., None]).sum(dim=-1), tp))
    local = targets - ax.index["tp"] * rows
    hit = (local >= 0) & (local < rows)
    tgt = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    return lse - all_reduce(torch.where(hit, tgt, 0.0), tp)


def local_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a global [B, T] batch tensor: the batch split
    over (dp, fsdp), the sequence over sp."""
    from ..parallel.sharding import rank_slice

    ax = _mesh_axes(mesh)
    if ax is None:
        return x
    return rank_slice(x, (BATCH_AXES, "sp"), ax.sizes, ax.index)


def loss_fn(model: Llama, batch: Dict[str, torch.Tensor], mesh=None
            ) -> torch.Tensor:
    """Causal-LM cross entropy; batch = {tokens [B, T], targets [B, T]}:
    the mean of logsumexp(logits) - logits[target], the JAX package's
    form (one reduction and a gather, no [B, T, vocab] log-softmax). MoE
    configs add ``moe_aux_coef`` times the balance aux.

    ``mesh`` (more than one rank): ``batch`` is the global batch, the
    same on every rank; each rank takes its block, and the mean over the
    global batch comes back on every rank. Its gradient on a rank is that
    of the rank's own tokens' share (the sum over the token axes passes
    gradients unchanged): summing the ranks' gradients over those axes
    (``make_train_step``) gives the global one."""
    ax = _mesh_axes(mesh)
    if ax is not None:
        tokens = local_batch(batch["tokens"], mesh)
        targets = local_batch(batch["targets"], mesh).long()
        logits, aux = forward_with_aux(model, tokens, ax)
        loss = _nll_sharded(logits, targets, ax).sum() / batch[
            "tokens"].numel()
        for a in TOKEN_AXES:
            loss = all_reduce(loss, ax.group(a))
        if model.cfg.n_experts > 1:
            # The aux is the global batch's on every rank already.
            loss = loss + model.cfg.moe_aux_coef * aux
        return loss
    logits, aux = forward_with_aux(model, batch["tokens"])
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, batch["targets"][..., None].long())[..., 0]
    loss = (lse - tgt).mean()
    if model.cfg.n_experts > 1:
        loss = loss + model.cfg.moe_aux_coef * aux
    return loss


def make_optimizer(model: Llama, lr: float = 3e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` as ``torch.optim.AdamW`` over every parameter,
    with optax's defaults: betas (0.9, 0.999), eps 1e-8 and weight decay
    1e-4 on every leaf, norms and embedding included (torch's default
    decay is 1e-2). The update is the same: bias-corrected moments and
    decay applied to the old weights. Makes the parameters trainable."""
    model.requires_grad_(True)
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def require_rank_blocks(model: Llama, want: Tuple[int, ...]) -> None:
    """Refuse a model on a mesh that is not a rank's training blocks:
    its first ``wq`` (an int8 weight's ``q``) must be the rank's block of
    it, shaped ``want`` (``rank_leaf_shapes``)."""
    wq = model.blocks[0].wq
    if isinstance(wq, Int8Weight):
        wq = wq.q
    got = tuple(wq.shape) if isinstance(wq, torch.Tensor) else \
        type(wq).__name__
    if got != tuple(want):
        raise ValueError(
            f"the model's wq is {got}, this rank's block of it "
            f"{tuple(want)}: build the model with init_params(..., mesh=) "
            f"or params_from_numpy(..., mesh=, specs='training')")


def _refuse_pipeline(ax) -> None:
    if ax.sizes.get("pp", 1) > 1:
        raise ValueError(
            "a 'pp' mesh axis holds pipeline stages: train them with "
            "models.pipeline.make_pp_train_step (GPipe or 1F1B)")


def make_train_step(cfg: LlamaConfig, mesh: Optional[object],
                    optimizer: torch.optim.Optimizer):
    """The train step: ``step(model, batch) -> loss`` runs the forward and
    backward of ``loss_fn`` and one optimizer update in place (the JAX
    step returned new params and optimizer state; here the model and
    ``optimizer`` hold them). The loss comes back as a detached f32
    scalar on the model's device, unsynchronised.

    ``mesh`` (more than one rank; run the step on every rank, in the same
    order): the model holds the rank's blocks, ``batch`` is the global
    batch; after the backward each gradient is summed over the token axes
    (dp, fsdp, sp) that do not shard its leaf (fsdp's sum is the
    reduce-scatter of the weight gathers), so every rank of an axis that
    replicates a leaf holds the same gradient, and the returned loss is
    the global mean. An MoE leaf is not summed over ep, which splits the
    experts, not the tokens. A ``pp`` axis is refused: its stages train
    through ``models.pipeline.make_pp_train_step``."""
    ax = _mesh_axes(mesh)
    if ax is not None:
        _refuse_pipeline(ax)
        reduce_over = {name: [a for a in TOKEN_AXES
                              if a not in _spec_axes(spec)
                              and ax.group(a) is not None]
                       for name, spec in leaf_specs(cfg).items()}
        wq_block = rank_leaf_shapes(cfg, ax.sizes)["blocks.0.wq"][0]

    def step(model: Llama, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError("the model's config differs from the step's")
        if ax is not None:
            require_rank_blocks(model, wq_block)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, ax)
        loss.backward()
        if ax is not None:
            for name, p in model.named_parameters():
                for a in reduce_over[name]:
                    all_reduce_(p.grad, ax.group(a))
        optimizer.step()
        return loss.detach()

    return step


# -- the pod's entry point -------------------------------------------------
def _router_params(cfg: LlamaConfig) -> int:
    return cfg.n_layers * cfg.d_model * cfg.n_experts \
        if cfg.n_experts > 1 else 0


def n_params(cfg: LlamaConfig) -> int:
    """The decoder's parameter count (``Llama``'s tensors): an MoE block
    holds ``E`` experts' ``3·D·F`` and the router's ``D·E``."""
    D, hd, F = cfg.d_model, cfg.head_dim, cfg.d_ff
    experts = cfg.n_experts if cfg.n_experts > 1 else 1
    block = (D * cfg.n_heads * hd + 2 * D * cfg.n_kv_heads * hd
             + cfg.n_heads * hd * D + experts * 3 * D * F + 2 * D)
    return (cfg.n_layers * block + _router_params(cfg)
            + 2 * cfg.vocab * D + D)


def train_state_bytes(cfg: LlamaConfig,
                      sizes: Optional[Mapping[str, int]] = None) -> int:
    """Bytes of the training state before any activation: the weights,
    their gradients and AdamW's two moments, each in its parameter's
    dtype (the model's; an MoE router's f32). ``sizes`` (a mesh's axis
    sizes): one rank's, from its blocks (``rank_leaf_shapes``)."""
    if sizes is None:
        size = torch.empty((), dtype=cfg.dtype).element_size()
        router = _router_params(cfg)
        return 4 * ((n_params(cfg) - router) * size + router * 4)
    return 4 * sum(int(np.prod(shape)) * torch.empty(
        (), dtype=dt).element_size()
        for shape, dt in rank_leaf_shapes(cfg, sizes).values())


def wave_p99_ms(metrics: Dict[int, Dict[str, float]]) -> float:
    """The p99 of a wave's per-request latencies in ms (the JAX serve
    loop's nearest-rank pick), 0.0 for an empty wave."""
    lats = sorted(m["latency_s"] * 1000 for m in metrics.values())
    return lats[min(len(lats) - 1,
                    round(0.99 * (len(lats) - 1)))] if lats else 0.0


def serve_loop(eng, cfg: LlamaConfig, prompt_len: int, max_new: int, guard,
               snap_dir: Optional[str] = None, publish=None, throttle=None,
               slo: float = 0.0, max_waves: Optional[int] = None, sleep=None) -> int:
    """The ``--serve`` loop of ``main()``: one warmup request of
    ``max_new + 1`` tokens (its latency record discarded), then waves of
    ``4 × n_slots`` random prompts of ``prompt_len`` tokens, each printing
    ``llama serve qps=… decode_tok_s=… prefill_tok=… slo=… p99_ms=…``,
    publishing ``(qps, p99_ms)``, pacing through ``throttle`` and to about
    1 Hz. At a wave boundary where ``guard.requested`` is set the engine
    drains to ``snap_dir`` (when given) and the loop raises
    ``SystemExit(0)``. A wave drains every request it submitted, so that
    snapshot normally holds none in flight, as in JAX. Returns after
    ``max_waves`` waves when that is given (else it never returns)."""
    from .lifecycle import drain_to_checkpoint

    sleep = time.sleep if sleep is None else sleep
    rng = np.random.default_rng(0)

    def prompt_arr():
        return rng.integers(0, cfg.vocab, prompt_len)

    eng.submit(prompt_arr(), max_new=max_new + 1)
    eng.run()                                   # warm every dispatch up
    eng.pop_request_metrics()                   # no warmup latency
    waves = 0
    while True:
        if guard.requested:
            if snap_dir is not None:
                snap = drain_to_checkpoint(eng, snap_dir)
                print(f"llama serve worker=0 drained "
                      f"{snap.n_requests_in_flight} requests to "
                      f"{snap_dir}", flush=True)
            raise SystemExit(0)
        if max_waves is not None and waves >= max_waves:
            return waves
        t0 = time.perf_counter()
        n_req = 4 * eng.n_slots
        for _ in range(n_req):
            eng.submit(prompt_arr(), max_new=max_new)
        done = eng.run()
        dt = time.perf_counter() - t0
        # Tokens actually emitted: with an eos, requests stop early.
        n_tok = sum(len(v) for v in done.values())
        p99 = wave_p99_ms(eng.pop_request_metrics())
        print(f"llama serve qps={n_req / dt:.2f} "
              f"decode_tok_s={n_tok / dt:.1f} "
              f"prefill_tok={n_req * prompt_len} slo={slo} "
              f"p99_ms={p99:.1f}", flush=True)
        waves += 1
        if publish is not None:
            publish(n_req / dt, p99_ms=p99)
        if throttle is not None:
            throttle.pace(dt)
        # About 1 Hz: each publish is a registry read and write.
        sleep(max(0.0, 1.0 - dt))


def train_loop(model: Llama, opt: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], ckpt=None, step_no: int = 0,
               every: int = 100, max_steps: Optional[int] = None, mesh=None,
               throttle=None, publish=None, worker: int = 0) -> list:
    """The training loop of ``main()``: one ``make_train_step`` update a
    step (on ``mesh`` when given: every rank runs the loop), a ``llama
    pretrain worker=<worker> step=… tok/s=… loss=…`` line each,
    ``ckpt.maybe_save(step, (model, opt), every)``, pacing through
    ``throttle`` and ``publish(tok/s)`` when given (the gang publishes
    from rank 0 only). ``step_no`` is the step the state has reached (a
    restored checkpoint's); the loop stops after step ``max_steps`` when
    that is given. Returns the losses of the steps it ran (detached
    device scalars); ``ckpt`` is closed on the way out."""
    step = make_train_step(model.cfg, mesh, opt)
    B, T = batch["tokens"].shape
    losses = []
    try:
        while max_steps is None or step_no < max_steps:
            t0 = time.perf_counter()
            loss = step(model, batch)
            loss_f = float(loss)                 # the step's one host read
            step_dt = time.perf_counter() - t0
            step_no += 1
            losses.append(loss)
            tok_s = B * T / step_dt
            print(f"llama pretrain worker={worker} step={step_no} "
                  f"tok/s={tok_s:.0f} loss={loss_f:.3f}", flush=True)
            if throttle is not None:
                throttle.pace(step_dt)
            if ckpt is not None:
                ckpt.maybe_save(step_no, (model, opt), every=every)
            if publish is not None:
                publish(tok_s)
    finally:
        if ckpt is not None:
            ckpt.close()
    return losses


# main()'s training batch (the JAX entry point's B and T).
TRAIN_BATCH = (8, 2048)


def _gang_rank(local_rank: int, local_size: int, ckpt_dir, ckpt_every: int,
               device, backend: str) -> None:
    """One rank of ``main()``'s gang training: join the world (global rank
    worker id × local size + ``local_rank``), build the dp × tp mesh over
    every rank (``tp = min(4, n)``, as JAX's ``main()``), refuse when the
    rank's training state does not fit its card, and train llama3_8b's
    blocks of this rank (``init_params(..., mesh=)``), resumed from and
    checkpointed to ``ckpt_dir`` by rank."""
    import torch.distributed as dist

    from ..parallel import MeshSpec, distributed_init_from_env, make_mesh
    from ..recommender.collector import make_workload_publisher
    from ..utils.enforcement import apply_env_limits

    dev = _rank_device(device, local_rank)
    throttle = apply_env_limits(device=dev)
    distributed_init_from_env(backend=backend, local_rank=local_rank,
                              local_size=local_size)
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(MeshSpec.for_devices(n, tp=min(4, n)), dev.type)
    from ..parallel.sharding import mesh_coords

    cfg, (B, T) = LlamaConfig.llama3_8b(), TRAIN_BATCH
    need = train_state_bytes(cfg, mesh_coords(mesh)[0])
    if dev.type == "cuda" and need > torch.cuda.get_device_properties(
            dev).total_memory:
        raise SystemExit(
            f"llama pretrain: a rank of this {n}-rank mesh holds {need} "
            f"bytes of llama3_8b's weights, gradients and AdamW moments, "
            f"more than its card's "
            f"{torch.cuda.get_device_properties(dev).total_memory}")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev,
                        mesh=mesh)
    opt = make_optimizer(model, 3e-4)
    tokens = torch.randint(0, cfg.vocab, (B, T),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(dev),
             "targets": torch.roll(tokens, -1, dims=1).to(dev)}
    ckpt, step_no = None, 0
    if ckpt_dir:
        from ..utils.checkpoint import TrainCheckpointer

        ckpt = TrainCheckpointer(ckpt_dir, mesh=mesh)
        step_no, (model, opt) = ckpt.restore_or(lambda: (model, opt))
        if step_no:
            print(f"llama pretrain worker={rank} resumed at step "
                  f"{step_no} from {ckpt_dir}", flush=True)
    publish = make_workload_publisher(n_devices=n) if rank == 0 else None
    train_loop(model, opt, batch, ckpt, step_no, ckpt_every, mesh=mesh,
               throttle=throttle, publish=publish, worker=rank)


def _rank_device(device, local_rank: int) -> torch.device:
    """A local rank's device: card ``local_rank`` (made current), or the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    return dev


def gang_serve_loop(handler, model: Llama, prompt: torch.Tensor,
                    max_new: int, publish=None, throttle=None,
                    slo: float = 0.0, report: bool = True,
                    max_waves: Optional[int] = None, sleep=None) -> int:
    """The ``--serve`` loop of a gang of workers (the JAX ``main()``'s
    multi-process loop): one warm-up call of ``handler`` (a
    ``make_server_step`` on the gang's mesh), then one call a wave, each
    printing ``llama serve qps=… decode_tok_s=… prefill_tok=… slo=…``
    (no p99: a static batch has one latency) where ``report`` (a
    worker's first rank: one line a worker, as JAX's one process a
    worker), publishing the qps through ``publish``, pacing through
    ``throttle`` and to about 1 Hz. Every rank runs it; the handler's
    collectives keep the ranks in step. Returns after ``max_waves`` waves
    when that is given (else it never returns)."""
    sleep = time.sleep if sleep is None else sleep
    b, Tp = prompt.shape

    def call():
        out = handler(model, prompt)
        # The wave's one host read, as the JAX serve loop's:
        # graftcheck: ignore[host-sync]
        out.cpu()                  # the wave's one host read: a sync
        return out

    call()                                      # warm up
    waves = 0
    while max_waves is None or waves < max_waves:
        t0 = time.perf_counter()
        call()
        dt = time.perf_counter() - t0
        if report:
            print(f"llama serve qps={b / dt:.2f} "
                  f"decode_tok_s={b * max_new / dt:.1f} "
                  f"prefill_tok={b * Tp} slo={slo}", flush=True)
        waves += 1
        if publish is not None:
            publish(b / dt)
        if throttle is not None:
            throttle.pace(dt)
        sleep(max(0.0, 1.0 - dt))
    return waves


def _serve_rank(local_rank: int, local_size: int, workers: int,
                cfg: LlamaConfig, opts: Dict[str, object], guard_cls,
                port: int, device, backend: str) -> None:
    """One rank of ``main()``'s ``--serve`` on more than one rank: join
    the world (global rank worker id × local size + ``local_rank``) and
    build the ``tp = min(4, n)`` mesh over every rank, as JAX's
    ``main()``. A gang of workers serves ``make_server_step`` on it
    (``gang_serve_loop``, B = 1, the prompt from one seeded generator,
    the same on every rank; the model is each rank's training blocks).
    One worker with several cards serves the paged engine on the mesh
    (``ContinuousBatcher(mesh=)``, whose tp rank 0 runs ``serve_loop``
    while the others follow; a dp axis makes replicas, each its own
    island), with no snapshot lifecycle, as JAX keeps none off its
    paged layout. Every worker publishes, with ``n_devices`` the world's
    size."""
    import os

    import torch.distributed as dist

    from ..parallel import (
        MeshSpec, distributed_init_from_env, make_mesh, mesh_coords)
    from ..recommender.collector import make_workload_publisher
    from ..utils.enforcement import apply_env_limits
    from .serving import ContinuousBatcher, make_server_step

    dev = _rank_device(device, local_rank)
    throttle = apply_env_limits(device=dev)
    slo = float(os.environ.get("SLO", "0") or 0)
    distributed_init_from_env(backend=backend, local_rank=local_rank,
                              local_size=local_size, coordinator_port=port)
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(MeshSpec.for_devices(n, tp=min(4, n)), dev.type)
    publish = (make_workload_publisher(n_devices=n) if local_rank == 0
               else None)
    Tp, max_new = opts["prompt_len"], opts["max_new"]
    gen = torch.Generator().manual_seed(0)
    if workers > 1:
        model = init_params(cfg, gen, dev, mesh=mesh)
        prompt = torch.randint(0, cfg.vocab, (1, Tp), generator=torch.
                               Generator().manual_seed(1)).to(dev)
        handler = make_server_step(cfg, mesh, max_new, max_len=cfg.max_seq)
        gang_serve_loop(handler, model, prompt, max_new, publish=publish,
                        throttle=throttle, slo=slo,
                        report=local_rank == 0)
        return
    model = init_params(cfg, gen, dev)
    if opts["int8"]:
        from ..ops.quant import quantize_llama_params

        model = quantize_llama_params(model)
    eng = ContinuousBatcher(
        model, cfg, n_slots=8, max_len=cfg.max_seq, chunk=max_new,
        prefill_bucket=max(Tp, 16), eos_id=opts["eos_id"],
        temperature=opts["temperature"], top_k=opts["top_k"],
        kv_layout="paged", mesh=mesh, device=dev)
    del model                       # the engine keeps this rank's slices
    if not eng.is_leader:
        eng.follow()
        return
    print(f"llama serve worker=0 rank={rank} mesh={mesh_coords(mesh)[0]} "
          f"kv_layout=paged", flush=True)
    try:
        serve_loop(eng, cfg, Tp, max_new, guard_cls().install(),
                   publish=publish if rank == 0 else None,
                   throttle=throttle, slo=slo)
    except SystemExit as e:           # a drain request: the followers stop
        if e.code not in (0, None):
            raise
    finally:
        eng.close()


SERVE_HELP = (
    "serve the paged ContinuousBatcher at the JAX serve config (d_model "
    "1024, 8 layers, 16 heads, vocab 32000, bf16) with decode_attn='fused'"
    ": the port decodes through its attention kernels, where the JAX "
    "entry point serves this config with decode_attn='dense'; a gang of "
    "workers serves make_server_step on its mesh instead")


def main(argv=None, *, device="cuda", backend: str = "nccl",
         local_ranks: Optional[int] = None) -> None:
    """The pod's entry point (``python -m
    k8s_gpu_scheduler_tpu_torch.models.llama``), with the JAX entry
    point's flags: ``--serve`` runs the paged engine's serve loop
    (``serve_loop``), resumed from ``<ckpt-dir>/serve_snapshot`` when a
    drained snapshot is there and drained to it on SIGTERM; without it,
    the training branch (``train_loop`` at llama3_8b, B 8, T 2048, AdamW
    3e-4, resumed from ``--ckpt-dir``). The scheduler-injected limits
    (``utils/enforcement.py``) are applied and the recommender publisher
    built before anything is allocated on ``device``.

    A worker runs ``local_ranks`` ranks (default: one for each visible
    card, one on ``"cpu"``), and the world is every rank of each worker
    that ``TPU_WORKER_HOSTNAMES`` names: global rank ``worker id ×
    local_ranks + local rank``, joined through worker 0's address with
    ``backend`` (``parallel.distributed.distributed_init_from_env``). A
    worker of one rank runs it in this process; with more it starts them
    (``parallel.spawn``). Training runs on such a gang
    (``_gang_rank``); a world of one rank cannot hold llama3_8b's step
    and is refused with its state's bytes. ``--serve`` on one rank serves
    the paged engine on its card; on more (``_serve_rank``), a gang of
    workers serves ``make_server_step`` on the ``tp = min(4, n)`` mesh
    and refuses ``--int8``, ``--temperature``, ``--top-k`` and
    ``--eos-id`` with JAX's message before anything is allocated, and one
    worker with several cards serves the paged engine on that mesh."""
    import argparse
    import dataclasses
    import os

    parser = argparse.ArgumentParser(
        prog="python -m k8s_gpu_scheduler_tpu_torch.models.llama")
    parser.add_argument("--serve", action="store_true", help=SERVE_HELP)
    parser.add_argument("--prompt-len", type=int, default=512)
    parser.add_argument("--max-new", type=int, default=64)
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 serving (ops/quant.py)")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--eos-id", type=int, default=None)
    parser.add_argument("--ckpt-dir", default=os.environ.get("TPU_CKPT_DIR"))
    parser.add_argument("--ckpt-every", type=int, default=100)
    args = parser.parse_args(argv)

    from ..parallel import distributed

    dev = resolve_device(device)
    workers = max(1, len(distributed.worker_addresses()))
    if local_ranks is None:
        local_ranks = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = workers * local_ranks
    if args.serve and workers > 1 and (
            args.int8 or args.temperature > 0 or args.top_k > 0
            or args.eos_id is not None):
        # JAX's refusal: the static gang handler is full-precision greedy
        # with a fixed budget.
        raise SystemExit(
            "--int8/--temperature/--top-k/--eos-id need the continuous "
            "batcher, which is single-process only; this gang has "
            f"{n} processes")
    if args.serve and n == 1:
        from ..recommender.collector import make_workload_publisher
        from ..utils.enforcement import apply_env_limits
        from .lifecycle import PreemptionGuard, resume_or_fresh
        from .serving import ContinuousBatcher

        throttle = apply_env_limits(device=dev)
        slo = float(os.environ.get("SLO", "0") or 0)
        publish = make_workload_publisher(n_devices=1)
        cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        if args.int8:
            from ..ops.quant import quantize_llama_params

            model = quantize_llama_params(model)
        Tp, max_new = args.prompt_len, args.max_new

        def mk_engine():
            return ContinuousBatcher(
                model, cfg, n_slots=8, max_len=cfg.max_seq, chunk=max_new,
                prefill_bucket=max(Tp, 16), eos_id=args.eos_id,
                temperature=args.temperature, top_k=args.top_k,
                kv_layout="paged", device=dev)

        snap_dir = (os.path.join(args.ckpt_dir, "serve_snapshot")
                    if args.ckpt_dir else None)
        eng, resumed = resume_or_fresh(mk_engine, snap_dir)
        if resumed:
            print(f"llama serve worker=0 resumed {resumed} "
                  f"in-flight requests from {snap_dir}", flush=True)
        guard = PreemptionGuard().install()
        serve_loop(eng, cfg, Tp, max_new, guard, snap_dir=snap_dir,
                   publish=publish, throttle=throttle, slo=slo)
        return
    if args.serve:
        from . import lifecycle

        opts = dict(prompt_len=args.prompt_len, max_new=args.max_new,
                    int8=args.int8, temperature=args.temperature,
                    top_k=args.top_k, eos_id=args.eos_id)
        # The config and the guard are resolved here and handed to the
        # ranks, which a worker of several cards starts as new processes.
        rank_fn, rank_args = _serve_rank, (
            local_ranks, workers,
            dataclasses.replace(LlamaConfig.serve(), decode_attn="fused"),
            opts, lifecycle.PreemptionGuard, distributed.COORDINATOR_PORT,
            dev.type, backend)
    elif n == 1:
        cfg, (B, T) = LlamaConfig.llama3_8b(), TRAIN_BATCH
        raise SystemExit(
            f"llama pretrain: llama3_8b's weights, gradients and AdamW "
            f"moments take {train_state_bytes(cfg)} bytes before any "
            f"activation, and its B {B}, T {T} step does not fit one card "
            f"(14 of its 32 layers is the deepest that fits an 80 GB H100); "
            f"train it on a gang of workers or of cards (ROADMAP queue 1, "
            f"'Multi-device')")
    else:
        rank_fn, rank_args = _gang_rank, (local_ranks, args.ckpt_dir,
                                          args.ckpt_every, dev.type, backend)
    if local_ranks == 1:
        rank_fn(0, *rank_args)
        return
    from ..parallel import spawn

    spawn(rank_fn, local_ranks, None, args=rank_args[1:],
          timeout=float("inf"))


if __name__ == "__main__":
    main()
