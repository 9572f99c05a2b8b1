"""Hopper shared-memory and register budgeter — the port's counterpart of
the JAX package's VMEM budgeter.

A CUDA kernel that asks for more dynamic shared memory than a block may
hold is refused at launch (``cudaErrorInvalidValue`` from the
``cudaFuncSetAttribute`` raise, or ``cudaErrorLaunchOutOfResources``) —
on the card, at whatever new (preset, dtype, head dim) first crosses the
line — while the CPU tests, which run the plain versions, never see it.
This pass moves that failure to lint time: it mirrors, in Python, the
bytes each launcher requests (``decode_smem_bytes`` in
``ops/csrc/decode_mma.cu``, ``prefill_smem_bytes`` in
``paged_prefill_mma.cu``, ``fwd_smem_bytes`` in ``flash_forward_mma.cu``,
``dq_smem_bytes``/``dkv_smem_bytes`` in ``flash_backward_mma.cu``,
``prefill_smem_floats`` in ``paged_attention.cu`` and
``fwd/dq/dkv_smem_floats`` in ``flash_attention.cu``; K1's and K4's f32
kernels ask for none) for every kernel instantiation a preset reaches,
and checks it against the H100's limits:

- a block may use at most 232,448 bytes of shared memory (227 KB; above
  48 KB only as dynamic shared memory);
- an SM holds 65,536 registers, at most 255 a thread.

Rules:

``smem-budget`` (error)
    dynamic plus static shared memory over 232,448 bytes, or registers ×
    threads over 65,536: not one block of the kernel fits an SM.
``kernel-shape-unsupported`` (error)
    a preset reaches a kernel with a head dim outside ``KERNEL_HEAD_DIMS``
    (``ops/decode_attention.py``, ``ops/flash_attention.py``), a page size
    no paged kernel takes (a power of two from 8 to 256), or a GQA group
    outside ``KERNEL_GROUPS``: the wrapper would raise at run time, so
    the pass names the shape before any card sees it.

On the CPU only the dynamic bytes are known; static shared memory and
registers come from the build's ``-Xptxas -v`` report
(``ops/_build.ptxas_report()``), which ``audit_smem(report=...)`` takes
on the card. Each ``.cu`` carries an ``extern "C"`` query that returns
the bytes its launcher requests (``lib_query``); ``chip_smoke.py`` phase
21b and a ``gpu`` test hold this mirror equal to it, since only the
card's compiler can evaluate the ``constexpr`` functions themselves.

Fixture hook: ``GRAFTCHECK_TORCH_SMEM_AUDIT`` — a module-level list of
``(name, KernelEntry | Preset)`` pairs (tests/data/graftcheck_torch/
bad_smem.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .findings import Finding

SMEM_BYTES_PER_BLOCK = 232_448      # 227 KB: the H100's per-block limit
SMEM_BYTES_PER_SM = 233_472         # 228 KB of the SM's 256 KB
SMEM_RESERVED_PER_BLOCK = 1_024     # the CUDA runtime's share of a block
REGISTERS_PER_SM = 65_536
MAX_THREADS_PER_SM = 2_048
MAX_BLOCKS_PER_SM = 32
# The kernels' contract (ops/decode_attention.py, ops/flash_attention.py).
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)
THREADS = 128                       # every kernel's block
CSRC = "k8s_gpu_scheduler_tpu_torch/ops/csrc/"


# -- the launchers' byte counts, mirrored -------------------------------------

def _ld_mma(hd: int) -> int:        # mma.cuh ld(): a bf16 row's pad
    return hd + 8


def decode_smem_bytes(kv_int8: bool, hd: int, contiguous: bool) -> int:
    """decode_mma.cu ``decode_smem_bytes<PT, HD, Rows>``: the cp.async
    ring of K/V chunks (64 rows; 2 stages int8, 3 bf16), the int8 rows'
    scales, ContiguousRows' row flags; or the merge's partial rows."""
    stages = 2 if kv_int8 else 3
    ring = 2 * 2 * stages * 64 * _ld_mma(hd)
    ring += 4 * 2 * stages * 64 if kv_int8 else 0
    ring += stages * 64 if contiguous else 0
    merge = 4 * (4 * 16 * (hd + 8) + 4 * 4 * 16)
    return max(ring, merge)


def prefill_mma_smem_bytes(hd: int) -> int:
    """paged_prefill_mma.cu ``prefill_smem_bytes<HD>``: 64 q rows and
    four 64-row K/V chunks of bf16."""
    return 2 * (64 + 4 * 64) * _ld_mma(hd)


def fwd_mma_smem_bytes(hd: int) -> int:
    """flash_forward_mma.cu ``fwd_smem_bytes<HD>``: 128 q rows and four
    K/V steps of fwd_k rows (32 at hd 128, else 64)."""
    fwd_k = 32 if hd == 128 else 64
    return 2 * (128 + 4 * fwd_k) * _ld_mma(hd)


def dq_mma_smem_bytes(hd: int) -> int:
    """flash_backward_mma.cu ``dq_smem_bytes<HD>``."""
    return 2 * (2 * 64 + 4 * 32) * _ld_mma(hd) + 4 * 2 * 64


def dkv_mma_smem_bytes(hd: int) -> int:
    """flash_backward_mma.cu ``dkv_smem_bytes<HD>`` (q steps of 64 rows
    at hd 128, else 32)."""
    dkv_q = 64 if hd == 128 else 32
    return 2 * (2 * 64 + 4 * dkv_q) * _ld_mma(hd) + 4 * 4 * dkv_q


def prefill_f32_smem_bytes(hd: int) -> int:
    """paged_attention.cu ``prefill_smem_floats<HD>`` x 4 (K2's and K3's
    f32 kernels: 32 q rows, 32 k rows)."""
    return 4 * (32 * (hd + 1) + 32 * (hd + 1) + 32 * hd + 32 * 33)


def flash_f32_smem_bytes(kernel: str, hd: int) -> int:
    """flash_attention.cu ``fwd/dq/dkv_smem_floats<HD>`` x 4."""
    ld = hd + 4
    if kernel == "K5":
        floats = (64 + 2 * 32) * ld + 64 * (32 + 8)
    elif kernel == "K6":
        floats = (2 * 64 + 2 * 32) * ld + 64 * (32 + 8)
    else:
        floats = (2 * 32 + 2 * 64) * ld + 2 * 32 * (64 + 8) + 2 * 64
    return 4 * floats


# -- kernel instantiations ----------------------------------------------------

@dataclass(frozen=True)
class KernelEntry:
    """One kernel template instantiation: its source and symbol, the
    template arguments as ptxas's demangled name spells them, the
    dynamic bytes its launcher requests, and the ``.cu`` query that
    returns them (``query``: function name and integer arguments)."""
    kernel: str                     # K1..K7
    source: str                     # file under ops/csrc/
    symbol: str                     # the __global__ function's name
    template: Tuple[str, ...]       # demangled template arguments
    dynamic_bytes: int
    query: Tuple[str, Tuple[int, ...]]
    threads: int = THREADS

    @property
    def label(self) -> str:
        return f"{self.symbol}<{', '.join(self.template)}>"


@dataclass(frozen=True)
class Preset:
    """A model width the repo serves or trains, as the kernels see it."""
    name: str
    n_heads: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 64
    gammas: Tuple[int, ...] = (2, 4)


def presets() -> List[Preset]:
    """Every width the port's entry points and chip_smoke run the kernels
    at: ``LlamaConfig.serve`` (``main --serve``) and
    ``LlamaConfig.llama3_8b``, read from those presets so that a change
    of their heads moves the audit with it, and Mixtral-8x7B's published
    widths (chip_smoke's MoE phases), which no ``LlamaConfig`` preset
    holds. A new preset without an audit row is a conscious choice."""
    from ..models.llama import LlamaConfig

    def of(name: str, cfg) -> Preset:
        return Preset(name, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)

    return [of("serve", LlamaConfig.serve()),
            of("llama3_8b", LlamaConfig.llama3_8b()),
            Preset("mixtral", 32, 8, 128)]


_PT = {"bf16": "__nv_bfloat16", "int8": "signed char", "f32": "float"}


def _kw(tg: int) -> int:
    """decode_mma.cu launch_paged_mma: the warps' key split by the tiles
    of the stack's first 64-row group."""
    return {1: 4, 2: 2}.get((min(tg, 64) + 15) // 16, 1)


def preset_entries(p: Preset) -> Tuple[List[Tuple[KernelEntry, str]],
                                       List[str]]:
    """(entries reached with the path that reaches each, unsupported
    shapes) for one preset: bf16 (bf16 and int8 KV) and f32 (f32 and
    int8 KV); paged rows (K1, K2, K3 at t = 1 + gamma) and contiguous
    rows (K4, with the engine's bitmap and without, as generate runs
    it); training K5–K7."""
    hd, g = p.head_dim, p.n_heads // max(1, p.n_kv_heads)
    bad: List[str] = []
    if hd not in KERNEL_HEAD_DIMS:
        bad.append(f"head_dim {hd} not in {KERNEL_HEAD_DIMS}")
    if p.n_heads % p.n_kv_heads or g not in KERNEL_GROUPS:
        bad.append(f"GQA group {p.n_heads}/{p.n_kv_heads} not in "
                   f"{KERNEL_GROUPS}")
    ps = p.page_size
    if ps < 8 or ps > 256 or ps & (ps - 1):
        bad.append(f"page_size {ps} is not a power of two in [8, 256]")
    if bad:
        return [], bad
    out: List[Tuple[KernelEntry, str]] = []
    h = str(hd)
    for kv in ("bf16", "int8"):
        q8 = int(kv == "int8")
        dyn = decode_smem_bytes(kv == "int8", hd, False)
        out.append((KernelEntry(
            "K1", "decode_mma.cu", "decode_mma_kernel",
            (_PT[kv], h, "PagedRows", str(_kw(g))), dyn,
            ("decode_mma_smem_bytes", (q8, hd, 0))), f"bf16 {kv} paged"))
        for gamma in p.gammas:
            out.append((KernelEntry(
                "K3", "decode_mma.cu", "decode_mma_kernel",
                (_PT[kv], h, "PagedRows", str(_kw((1 + gamma) * g))), dyn,
                ("decode_mma_smem_bytes", (q8, hd, 0))),
                f"bf16 {kv} verify t={1 + gamma}"))
        for how in ("bitmap", "no bitmap"):
            out.append((KernelEntry(
                "K4", "decode_mma.cu", "decode_mma_kernel",
                (_PT[kv], h, "ContiguousRows", "4"),
                decode_smem_bytes(kv == "int8", hd, True),
                ("decode_mma_smem_bytes", (q8, hd, 1))),
                f"bf16 {kv} contiguous, {how}"))
        out.append((KernelEntry(
            "K2", "paged_prefill_mma.cu", "paged_prefill_mma_kernel",
            (_PT[kv], h), prefill_mma_smem_bytes(hd),
            ("paged_prefill_mma_smem_bytes", (q8, hd))),
            f"bf16 {kv} prefix-tail prefill"))
    for kv in ("f32", "int8"):
        q8 = int(kv == "int8")
        out.append((KernelEntry(
            "K1", "paged_attention.cu", "paged_decode_kernel",
            (_PT[kv], h, str(g)), 0,
            ("paged_attention_smem_bytes", (1, q8, hd))), f"f32 {kv} paged"))
        out.append((KernelEntry(
            "K2", "paged_attention.cu", "paged_prefill_kernel",
            (_PT[kv], h), prefill_f32_smem_bytes(hd),
            ("paged_attention_smem_bytes", (2, q8, hd))),
            f"f32 {kv} prefix-tail prefill"))
        out.append((KernelEntry(
            "K3", "paged_attention.cu", "paged_verify_kernel",
            (_PT[kv], h), prefill_f32_smem_bytes(hd),
            ("paged_attention_smem_bytes", (3, q8, hd))),
            f"f32 {kv} verify"))
        out.append((KernelEntry(
            "K4", "flash_decode.cu", "flash_decode_kernel",
            (_PT[kv], h, str(g)), 0,
            ("flash_decode_smem_bytes", (q8, hd))), f"f32 {kv} contiguous"))
    for k, sym, fn, kid in (
            ("K5", "flash_fwd_mma_kernel", fwd_mma_smem_bytes, 5),
            ("K6", "flash_bwd_dq_mma_kernel", dq_mma_smem_bytes, 6),
            ("K7", "flash_bwd_dkv_mma_kernel", dkv_mma_smem_bytes, 7)):
        src = "flash_forward_mma.cu" if k == "K5" else "flash_backward_mma.cu"
        query = ("flash_forward_mma_smem_bytes", (hd,)) if k == "K5" else \
            ("flash_backward_mma_smem_bytes", (kid, hd))
        out.append((KernelEntry(k, src, sym, (h,), fn(hd), query),
                    "bf16 train"))
        out.append((KernelEntry(
            k, "flash_attention.cu", sym.replace("_mma", ""), (h,),
            flash_f32_smem_bytes(k, hd),
            ("flash_attention_smem_bytes", (kid, hd))), "f32 train"))
    return out, bad


def reached_entries(ps: Optional[Sequence[Preset]] = None
                    ) -> Dict[KernelEntry, List[str]]:
    """Every instantiation the presets reach -> ``preset: path`` labels."""
    out: Dict[KernelEntry, List[str]] = {}
    for p in presets() if ps is None else ps:
        entries, _ = preset_entries(p)
        for e, how in entries:
            out.setdefault(e, []).append(f"{p.name}: {how}")
    return out


# -- resources and the rules --------------------------------------------------

@dataclass
class Resources:
    """What a block of one instantiation holds: dynamic and static shared
    memory, registers a thread, spilled bytes (ptxas)."""
    dynamic_bytes: int
    static_bytes: int = 0
    registers: Optional[int] = None
    spill_bytes: int = 0
    threads: int = THREADS
    notes: List[str] = field(default_factory=list)

    def blocks_per_sm(self) -> Dict[str, int]:
        """Resident blocks an SM can hold, by each limit."""
        smem = self.dynamic_bytes + self.static_bytes + SMEM_RESERVED_PER_BLOCK
        by_smem = min(MAX_BLOCKS_PER_SM, SMEM_BYTES_PER_SM // smem)
        by_threads = MAX_THREADS_PER_SM // self.threads
        by_regs = by_threads
        if self.registers:
            per_warp = math.ceil(self.registers * 32 / 256) * 256
            by_regs = (REGISTERS_PER_SM // per_warp) // (self.threads // 32)
        return {"smem": by_smem, "registers": by_regs, "threads": by_threads}


def check_resources(name: str, res: Resources,
                    anchor: str = "") -> List[Finding]:
    anchor = anchor or f"<smem:{name}>"
    out: List[Finding] = []
    total = res.dynamic_bytes + res.static_bytes
    if total > SMEM_BYTES_PER_BLOCK:
        out.append(Finding(
            "smem-budget", anchor, 0,
            f"{name}: {res.dynamic_bytes} dynamic + {res.static_bytes} "
            f"static bytes of shared memory = {total} exceed the H100's "
            f"{SMEM_BYTES_PER_BLOCK} a block — the launch is refused"))
    if res.registers is not None \
            and res.registers * res.threads > REGISTERS_PER_SM:
        out.append(Finding(
            "smem-budget", anchor, 0,
            f"{name}: {res.registers} registers x {res.threads} threads "
            f"exceed an SM's {REGISTERS_PER_SM} — not one block fits"))
    return out


def _ptxas_record(entry: KernelEntry,
                  report: Sequence[dict]) -> Optional[dict]:
    """The ptxas record of ``entry``: its demangled name's symbol and
    template arguments; without demangled names, the most demanding
    record of the symbol (conservative)."""
    candidates = []
    for r in report:
        name = str(r.get("kernel", ""))
        if entry.symbol not in name:
            continue
        i = name.find(entry.symbol + "<")
        if i < 0:
            candidates.append(r)
            continue
        args, depth, cur = [], 0, ""
        for ch in name[i + len(entry.symbol) + 1:]:
            if ch == "<":
                depth += 1
            elif ch == ">":
                if depth == 0:
                    break
                depth -= 1
            if ch == "," and depth == 0:
                args.append(cur.strip())
                cur = ""
            else:
                cur += ch
        args.append(cur.strip())
        if len(args) == len(entry.template) and all(
                a == t or a.endswith("::" + t) or a.rstrip("u") == t
                for a, t in zip(args, entry.template)):
            return r
    if candidates:
        return max(candidates, key=lambda r: (r.get("smem_bytes") or 0,
                                              r.get("registers") or 0))
    return None


def entry_resources(entry: KernelEntry,
                    report: Optional[Sequence[dict]] = None) -> Resources:
    res = Resources(entry.dynamic_bytes, threads=entry.threads)
    if report:
        r = _ptxas_record(entry, report)
        if r is None:
            res.notes.append("no ptxas record")
        else:
            res.static_bytes = int(r.get("smem_bytes") or 0)
            res.registers = r.get("registers")
            res.spill_bytes = int(r.get("spill_stores") or 0) + \
                int(r.get("spill_loads") or 0)
    return res


def audit_preset(p: Preset, report: Optional[Sequence[dict]] = None,
                 anchor: str = "") -> List[Finding]:
    entries, bad = preset_entries(p)
    out = [Finding("kernel-shape-unsupported", anchor or f"<smem:{p.name}>",
                   0, f"preset {p.name}: {why} — the kernel wrappers raise "
                      f"at run time on this shape")
           for why in bad]
    for e, how in entries:
        out.extend(check_resources(f"{p.name} {how}: {e.label}",
                                   entry_resources(e, report), anchor))
    return out


def audit_smem(report: Optional[Sequence[dict]] = None,
               ps: Optional[Iterable[Preset]] = None) -> List[Finding]:
    """Shape support and the budget of every instantiation the presets
    reach; ``report`` (``_build.ptxas_report()``, on the card) adds static
    shared memory and registers."""
    out: List[Finding] = []
    for p in presets() if ps is None else ps:
        out.extend(audit_preset(p, report, anchor=CSRC))
    return out


def lib_query(lib, entry: KernelEntry) -> int:
    """The bytes ``entry``'s launcher requests, from its ``.cu`` query in
    the built library (``ops/_build.load_library()``)."""
    import ctypes

    fn = getattr(lib, entry.query[0])
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * len(entry.query[1])
    return int(fn(*entry.query[1]))
