"""Sharding rules: logical axis names → mesh axes → per-rank slices (port
of the JAX package's ``parallel/sharding.py``).

Every parameter declares logical axes ('embed', 'mlp', 'heads',
'vocab'...); one rules table maps logical axes to mesh axes. In JAX a
spec is a ``PartitionSpec`` that GSPMD or ``shard_map`` acts on; here a
spec is a plain tuple of mesh-axis names (``None`` = replicated along that
dim), and ``rank_slice`` takes one rank's block of a tensor by it. The
code that runs on the ranks is rank-local, so nothing stands in for
``shard_map``.

Conventions (standard 1D-tp transformer):
- column-parallel inputs→hidden weights shard the OUTPUT axis on tp
  (q/k/v/gate/up projections, logical axis 'heads'/'mlp');
- row-parallel hidden→outputs shard the INPUT axis on tp (o/down
  projections), followed by a combine (``models/serving.py``);
- fsdp shards the remaining large axis ('embed') of every weight;
- activations: batch on ('dp','fsdp'), sequence on 'sp', heads on 'tp'.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

# logical axis -> mesh axis (None = replicate). The sp axis never shards
# WEIGHTS — it only shards the sequence dimension of activations.
DEFAULT_RULES: Dict[str, object] = {
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "head_dim": None,
    "norm": None,
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    # MoE: the stacked expert dim shards over ep.
    "expert": "ep",
    # Paged serving pool: layer stack and page pool replicated, kv heads
    # on tp, so each rank holds Hkv/tp heads of every page.
    "layers": None,
    "pages": None,
    "page": None,
}

# Logical axes of the paged KV pool [L, n_pages, page_size, Hkv, hd].
KV_POOL_AXES: Tuple[str, ...] = ("layers", "pages", "page", "kv_heads",
                                 "head_dim")

# Megatron-sliced SERVING weights: param-leaf name → slice kind over the
# layer-stacked [L, K, N] matmul view. "column" shards the OUTPUT axis N
# (q/k/v and MLP gate/up — each rank computes its own contiguous head/ffn
# family directly, no combine); "row" shards the INPUT axis K (o and MLP
# down — the rank contracts its 1/tp slice and a per-block combine
# reassembles). Everything not named here (embed, norms, lm_head)
# replicates. The serving engine builds its per-leaf specs from this
# table (models/llama.py serving_weight_specs).
WEIGHT_SPECS: Dict[str, str] = {
    "wq": "column",
    "wk": "column",
    "wv": "column",
    "w_gate": "column",
    "w_up": "column",
    "wo": "row",
    "w_down": "row",
}
# Axis index of the slice inside the stacked [L, K, N] serving layout.
WEIGHT_COLUMN_DIM, WEIGHT_ROW_DIM = 2, 1


def weight_slice_spec(kind: str, rules: Dict[str, object] = None) -> tuple:
    """Spec of one stacked [L, K, N] serving weight for a WEIGHT_SPECS
    kind — the tp mesh axis comes from the same rules-table entry the
    pool derives its kv-heads mapping from."""
    rules = rules or DEFAULT_RULES
    tp = rules["kv_heads"]
    if kind == "column":
        return (None, None, tp)
    if kind == "row":
        return (None, tp, None)
    raise ValueError(f"unknown weight slice kind {kind!r}")


def logical_axis_rules(overrides: Dict[str, object] = None
                       ) -> Dict[str, object]:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


def spec_for(logical_axes: Tuple[str, ...], rules: Dict[str, object]
             ) -> tuple:
    return tuple(rules.get(a) for a in logical_axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def shard_params_spec(param_axes, rules: Dict[str, object] = None):
    """Map a nested dict of logical-axis tuples to one of specs."""
    rules = rules or DEFAULT_RULES
    if _is_axes(param_axes):
        return spec_for(param_axes, rules)
    return {k: shard_params_spec(v, rules) for k, v in param_axes.items()}


def block_region(shape, spec: tuple, sizes: Mapping[str, int],
                 index: Mapping[str, int]) -> tuple:
    """The slices of a rank's block of an array of ``shape`` under
    ``spec``: each dim named by a mesh axis (or a tuple of axes,
    row-major) is cut into that axis's size of equal contiguous blocks
    and the block at the rank's coordinate kept. ``sizes`` and ``index``
    are the mesh's axis sizes and this rank's coordinate on each
    (``mesh_coords``); an axis the mesh lacks counts as size 1. A dim
    the axis size does not divide raises ``ValueError``."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than shape "
                         f"{tuple(shape)}")
    cut = []
    for dim, ax in enumerate(spec):
        names = () if ax is None else (ax if isinstance(ax, tuple)
                                       else (ax,))
        n, i = 1, 0
        for a in names:
            n, i = n * sizes.get(a, 1), i * sizes.get(a, 1) + index.get(a, 0)
        if shape[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(shape)} not divisible by the "
                f"{names} axis size {n}")
        step = shape[dim] // n
        cut.append(slice(i * step, (i + 1) * step))
    return tuple(cut)


def rank_slice(x, spec: tuple, sizes: Mapping[str, int],
               index: Mapping[str, int]):
    """This rank's block of ``x`` (a numpy array or a tensor) under
    ``spec`` (``block_region``)."""
    return x[block_region(x.shape, spec, sizes, index)]


def mesh_coords(mesh) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(axis sizes, this rank's coordinate on each axis) of a
    ``DeviceMesh`` with named dims."""
    names = mesh.mesh_dim_names
    return ({n: int(mesh.size(i)) for i, n in enumerate(names)},
            {n: int(mesh.get_local_rank(n)) for n in names})
