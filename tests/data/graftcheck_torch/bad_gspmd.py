"""Seeded-bad fixture: sharding-audit true positives
(``GRAFTCHECK_TORCH_GSPMD_AUDIT``), the JAX package's ``bad_gspmd.py``
per rank of a tp = 2 world. Each build runs on each rank of the spawned
world of two (it uses no collective: a rank's view is its tensors); none
produces wrong tokens, each costs memory at scale:

- ``bad_cache_layout``: the rank's KV cache is cut on the SEQUENCE dim
  instead of the kv-heads dim (``cache-spec-mismatch``), and a 4 MiB
  buffer whose spec shards it is held whole (``oversized-replicated``);
- ``bad_whole_cache``: the whole cache on every rank — what JAX's
  ``unconstrained-scan-carry`` hunts, caught here by the cache rule and
  ``oversized-replicated``;
- ``bad_replicated_weight_island``: a weight-sharded island whose pool is
  cut right but whose q projection rides whole (``island-weight-spec``).
"""
import torch

from k8s_gpu_scheduler_tpu_torch.analysis.gspmd import (
    GspmdEntry, RankView, Sharded, pool_spec, weight_spec)
from k8s_gpu_scheduler_tpu_torch.models.serving import CACHE_SPEC

SIZES = {"dp": 1, "fsdp": 1, "sp": 1, "ep": 1, "tp": 2}


def _view(rank, tensors, island=False):
    return RankView(SIZES, {**{a: 0 for a in SIZES}, "tp": rank}, tensors,
                    island=island)


def _bad_cache_layout(device, rank, world):
    full = (2, 2, 32, 8, 8)
    cache = torch.zeros((2, 2, 16, 8, 8), dtype=torch.bfloat16,
                        device=device)              # tp on the sequence
    big = torch.zeros((1024, 1024), device=device)  # 4 MiB, whole
    return _view(rank, [
        Sharded("cache", cache, full, CACHE_SPEC, "cache"),
        Sharded("big", big, (1024, 1024), ("tp", None))])


def _bad_whole_cache(device, rank, world):
    full = (2, 4, 256, 8, 64)
    cache = torch.zeros(full, dtype=torch.bfloat16, device=device)  # 2 MiB
    return _view(rank, [Sharded("carried cache", cache, full, CACHE_SPEC,
                                "cache")])


def _bad_replicated_weight_island(device, rank, world):
    pool = torch.zeros((2, 4, 8, 4, 8), dtype=torch.bfloat16, device=device)
    wq = torch.zeros((8, 16), dtype=torch.bfloat16, device=device)  # whole
    return _view(rank, [
        Sharded("k pool", pool, (2, 4, 8, 8, 8), pool_spec(), "pool"),
        Sharded("blocks.0.wq", wq, (8, 16), weight_spec("column"),
                "weight")], island=True)


GRAFTCHECK_TORCH_GSPMD_AUDIT = [
    ("bad_cache_layout", GspmdEntry(_bad_cache_layout, {"cache_spec": True})),
    ("bad_whole_cache", GspmdEntry(_bad_whole_cache)),
    ("bad_replicated_weight_island", GspmdEntry(
        _bad_replicated_weight_island,
        {"pool_spec": True, "weight_specs": True})),
]
