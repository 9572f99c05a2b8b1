"""Seeded-bad fixture: traffic-contract true positives
(``GRAFTCHECK_TORCH_TRAFFIC_AUDIT``), the JAX package's ``bad_traffic.py``
in the port's form. None produces wrong numbers; each burns memory
traffic or residency at scale:

- ``bad_dense_gather`` materializes the slots×prefix-window cross
  product ``[L, M, hb·ps, Hkv, hd]`` out of the page pool (the prefill
  gather class, ``dense-materialization``) under a contract that declares
  no ``hit`` scaling (``traffic-contract``);
- ``bad_pool_copied`` copies the pool out of place and writes the copy —
  two pools live at once (``peak-residency``), the port's form of JAX's
  broken donation;
- ``bad_no_contract`` registers with ``None`` (``traffic-contract``);
- ``bad_replicated_weight`` declares ``weight_sharded`` but reads the
  FULL [d, d] weight (``traffic-contract``, the replicated-weight
  layout whose per-rank bytes do not scale 1/tp).

Geometry values are mutually distinct for every scale symbol, per the
registry convention (``entrypoints.TRAFFIC_GEOMETRY``).
"""
import torch

from k8s_gpu_scheduler_tpu_torch.analysis.traffic import TrafficEntry

L, N_PAGES, PS, HKV, HD = 2, 11, 4, 3, 7
M, HB = 5, 2
HIT = HB * PS                              # 8
D, DFF = 6, 13                             # full-weight dims (d, d_ff)

GEOMETRY = {"n_pages": N_PAGES, "hit": HIT, "M": M,
            "L": L, "Hkv": HKV, "hd": HD, "ps": PS,
            "d": D, "d_ff": DFF}


def _pool(device):
    return torch.zeros((L, N_PAGES, PS, HKV, HD), device=device)


def _dense_gather(device, rank=0, world=1):
    tbl = torch.tensor([[1, 2]] * M, device=device)            # [M, HB]

    def gather(pool, tbl):
        rows = (tbl[:, :, None] * PS
                + torch.arange(PS, device=pool.device)).reshape(M, HIT)
        flat = pool.reshape(L, N_PAGES * PS, HKV, HD)
        return flat[:, rows].sum()        # [L, M, HIT, HKV, HD] per slot

    return gather, (_pool(device), tbl)


def _pool_copied(device, rank=0, world=1):
    def update(pool, row):
        new = pool.clone()                # a second pool, written
        new[:, 1] = row
        return new

    return update, (_pool(device), torch.ones((PS, HKV, HD), device=device))


def _no_contract(device, rank=0, world=1):
    return (lambda pool: pool.sum()), (_pool(device),)


def _replicated_weight(device, rank=0, world=1):
    def step(pool, w):
        x = torch.ones((M, D), device=pool.device)
        return pool.sum() + (x @ w).sum()  # the whole [d, d] weight

    return step, (_pool(device), torch.zeros((D, D), device=device))


GRAFTCHECK_TORCH_TRAFFIC_AUDIT = [
    ("bad_dense_gather", TrafficEntry(
        _dense_gather, GEOMETRY, {"kv_scale": {"tb": 1}, "in_place": (0,)})),
    ("bad_pool_copied", TrafficEntry(
        _pool_copied, GEOMETRY, {"kv_scale": {}, "in_place": (0,)})),
    ("bad_no_contract", TrafficEntry(_no_contract, GEOMETRY, None)),
    ("bad_replicated_weight", TrafficEntry(
        _replicated_weight, GEOMETRY,
        {"kv_scale": {}, "in_place": (0,), "weight_sharded": True})),
]
