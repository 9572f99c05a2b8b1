"""Slice topology math of the port (copy of the JAX package's
``api/topology.py``): accelerator generations, torus coordinates, ICI hop
distance and the partition table ``SLICE_CONFIGS``.

The unit of placement is a *slice*: an axb(xc) block of chips joined by
ICI; the scheduler's locality score for gangs minimizes hops on that
torus. ``TPUGen.peak_bf16_tflops`` and ``TPUGen.hbm_gib`` are the public
figures of the scheduled accelerators (the sharing limits are computed
from ``hbm_gib``); they are not measurements of any card the port runs on."""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from enum import Enum
from typing import Dict, Iterable, List, Sequence, Tuple


class TPUGen(str, Enum):
    V5E = "tpu-v5-lite-podslice"
    V5P = "tpu-v5p-slice"
    V4 = "tpu-v4-podslice"
    V6E = "tpu-v6e-slice"

    @property
    def chips_per_host(self) -> int:
        # v5e/v6e hosts expose a 2x4 board; v4/v5p hosts a 2x2x1 board.
        return {TPUGen.V5E: 8, TPUGen.V6E: 8, TPUGen.V5P: 4, TPUGen.V4: 4}[self]

    @property
    def host_topology(self) -> Tuple[int, ...]:
        return {
            TPUGen.V5E: (2, 4),
            TPUGen.V6E: (2, 4),
            TPUGen.V5P: (2, 2, 1),
            TPUGen.V4: (2, 2, 1),
        }[self]

    @property
    def torus_dims(self) -> int:
        return {TPUGen.V5E: 2, TPUGen.V6E: 2, TPUGen.V5P: 3, TPUGen.V4: 3}[self]

    @property
    def peak_bf16_tflops(self) -> float:
        # Per chip. Public numbers: v4 275, v5e 197, v5p 459, v6e 918.
        return {TPUGen.V4: 275.0, TPUGen.V5E: 197.0, TPUGen.V5P: 459.0, TPUGen.V6E: 918.0}[self]

    @property
    def hbm_gib(self) -> float:
        return {TPUGen.V4: 32.0, TPUGen.V5E: 16.0, TPUGen.V5P: 95.0, TPUGen.V6E: 32.0}[self]


def parse_topology(s: str) -> Tuple[int, ...]:
    """'2x4' → (2, 4); '2x2x2' → (2, 2, 2)."""
    try:
        dims = tuple(int(p) for p in s.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"bad topology string {s!r}") from e
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"bad topology string {s!r}")
    return dims


def format_topology(dims: Sequence[int]) -> str:
    return "x".join(str(d) for d in dims)


def chip_count(dims: Sequence[int]) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def ici_hop_distance(
    a: Sequence[int], b: Sequence[int], dims: Sequence[int], wrap: bool = True
) -> int:
    """Manhattan distance between two chips on the slice torus.

    ``wrap`` models the wraparound links a full pod torus has; sub-slices of a
    pod are meshes (no wrap), which is the conservative default GKE gives a
    partial slice — callers pass wrap=True only for full-pod topologies.
    """
    if len(a) != len(b) or len(a) != len(dims):
        raise ValueError("coordinate rank mismatch")
    total = 0
    for x, y, d in zip(a, b, dims):
        delta = abs(x - y)
        if wrap and d > 2:
            delta = min(delta, d - delta)
        total += delta
    return total


def slice_diameter(dims: Sequence[int], wrap: bool = False) -> int:
    """Worst-case chip-to-chip hop count — the latency term in gang scoring."""
    return sum((d // 2 if wrap and d > 2 else d - 1) for d in dims)


def host_board(dims: Sequence[int], gen: TPUGen) -> Tuple[int, ...]:
    """Chip block owned by one host VM for a slice of shape ``dims``.

    v5e/v6e single-host slices (≤8 chips) live on one 2x4 board; *multi-host*
    v5e slices are carved into 2x2 four-chip VMs (GKE's ct5lp-hightower-4t),
    which is why v5e-16 = 4 hosts and v5e-256 = 64 hosts. v4/v5p hosts always
    own a 2x2x1 block.
    """
    if gen in (TPUGen.V5E, TPUGen.V6E):
        if chip_count(dims) <= 8 and _fits_within(dims, (2, 4)):
            return tuple(dims)  # whole slice on one host's 2x4 board
        return (2, 2)
    # v4/v5p: sub-host partitions ('2x1x1', '1x1x1' — SLICE_CONFIGS) fit on
    # one host's 2x2x1 board; anything larger tiles by whole boards. A shape
    # like 4x1x1 has a 4-long axis no board can hold, so it falls through to
    # whole-board tiling (2 hosts) instead of being accepted as one host.
    if chip_count(dims) <= 4 and _fits_within(dims, gen.host_topology):
        return tuple(dims)
    return gen.host_topology


def _fits_within(dims: Sequence[int], board: Sequence[int]) -> bool:
    return len(dims) == len(board) and all(d <= b for d, b in zip(dims, board))


def host_grid(dims: Sequence[int], gen: TPUGen) -> Tuple[int, ...]:
    """How many hosts along each axis for a slice of shape ``dims``."""
    host = host_board(dims, gen)
    grid = []
    for i, d in enumerate(dims):
        h = host[i] if i < len(host) else 1
        if d % h:
            # Every axis must tile exactly by the host board — '1x16' on v5e
            # (2x2 boards) is not a GKE topology and must be rejected, not
            # rounded up to 8 hosts.
            raise ValueError(f"topology {dims} not host-aligned for {gen.value}")
        grid.append(d // h)
    return tuple(grid)


def hosts_needed(dims: Sequence[int], gen: TPUGen) -> int:
    return chip_count(host_grid(dims, gen))


def host_coordinates(dims: Sequence[int], gen: TPUGen) -> List[Tuple[int, ...]]:
    """Torus coordinates (in host units) of every host in the slice."""
    grid = host_grid(dims, gen)
    return [tuple(c) for c in itertools.product(*(range(g) for g in grid))]


@dataclass(frozen=True)
class SliceTopology:
    """A concrete slice shape on a given TPU generation."""

    gen: TPUGen
    dims: Tuple[int, ...]

    @staticmethod
    def parse(gen: str | TPUGen, topo: str) -> "SliceTopology":
        g = TPUGen(gen) if not isinstance(gen, TPUGen) else gen
        return SliceTopology(g, parse_topology(topo))

    @property
    def chips(self) -> int:
        return chip_count(self.dims)

    @property
    def hosts(self) -> int:
        return hosts_needed(self.dims, self.gen)

    @property
    def is_multi_host(self) -> bool:
        return self.hosts > 1

    @property
    def has_wraparound(self) -> bool:
        # 3D tori (v4/v5p): sub-slices with every axis a multiple of 4 get
        # wrapped rings (GKE grants twisted-torus wrap at cube granularity).
        # 2D tori (v5e/v6e): only the full 16x16 pod has wrapped rings —
        # partial slices are meshes.
        if self.gen.torus_dims == 3:
            return all(d >= 4 and d % 4 == 0 for d in self.dims)
        return all(d >= 16 for d in self.dims)

    def diameter(self) -> int:
        return slice_diameter(self.dims, wrap=self.has_wraparound)

    def __str__(self) -> str:  # pragma: no cover
        return f"{self.gen.value}:{format_topology(self.dims)}"


# --- Dynamic slice partitioning (the MIG-reconfigure analogue) --------------
#
# The reference repartitions an idle A30 among {1,2,4} MIG instances by
# relabeling the node (gpu_plugins.go:357-452). The TPU analogue partitions a
# host's board into equal sub-slices that independent pods can own; the table
# below mirrors configs/partitions (gpu_plugins.go:52-53) per generation.

SLICE_CONFIGS: Dict[TPUGen, List[Tuple[str, int]]] = {
    # (sub-slice topology per pod, pods per host)
    TPUGen.V5E: [("2x4", 1), ("2x2", 2), ("1x2", 4), ("1x1", 8)],
    TPUGen.V6E: [("2x4", 1), ("2x2", 2), ("1x2", 4), ("1x1", 8)],
    TPUGen.V5P: [("2x2x1", 1), ("2x1x1", 2), ("1x1x1", 4)],
    TPUGen.V4: [("2x2x1", 1), ("2x1x1", 2), ("1x1x1", 4)],
}


def partitions_for(gen: TPUGen) -> List[int]:
    """Partition counts available on ``gen`` — analogue of partitions=[4,2,1]."""
    return [p for _, p in SLICE_CONFIGS[gen]]


def config_for_partitions(gen: TPUGen, parts: int) -> str:
    for topo, p in SLICE_CONFIGS[gen]:
        if p == parts:
            return topo
    raise ValueError(f"{gen.value} has no {parts}-way partitioning")
