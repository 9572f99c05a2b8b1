"""Build and bind the CUDA kernels in ``csrc/`` (route (b): ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``).

The build runs at first use — never at import — into ``build/kernels/``
at the repository root (listed in ``.gitignore``), from the repository's
sources only: one ``nvcc -c`` per source, all started together, then one
link into a single library. The library's file name carries a hash of
every source and header and the flags, so an edited file is rebuilt and a
stale library is never loaded. ``nvcc -Xptxas -v`` reports each kernel's
registers, shared memory and spills; the report is kept beside the
library (``ptxas_report()``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "paged_attention.cu", _CSRC / "paged_prefill_mma.cu",
           _CSRC / "decode_mma.cu", _CSRC / "flash_decode.cu",
           _CSRC / "flash_attention.cu", _CSRC / "flash_forward_mma.cu",
           _CSRC / "flash_backward_mma.cu")
HEADERS = (_CSRC / "common.cuh", _CSRC / "mma.cuh",
           _CSRC / "paged_stage.cuh", _CSRC / "cluster_merge.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

_lib: Optional[ctypes.CDLL] = None
_report: str = ""
# Compiles and library loads in this process: the steady-state audit
# (analysis/steady.py) shows no dispatch after warm-up does either.
COUNTS = {"builds": 0, "loads": 0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's guess: $CUDA_HOME, $CUDA_PATH, else /usr/local/cuda.
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit (set CUDA_HOME)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless these sources' library already exists.
    Objects and the library are written in a fresh temporary directory
    and the library is renamed into place, so a concurrent build never
    sees a half-written library."""
    global _report
    so = library_path()
    log = so.with_suffix(".ptxas.txt")
    if so.exists():
        _report = log.read_text() if log.exists() else ""
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    COUNTS["builds"] += 1
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outs = [p.communicate() for p in procs]
        report = "".join(o + e for o, e in outs)
        for cmd, p, (o, e) in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{o}\n{e}")
        lib = str(Path(tmp) / "lib.so")
        link = [nvcc, *ARCH, "-shared", "-o", lib, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        _report = report
        log.write_text(report)
        os.replace(lib, so)
    return so


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    COUNTS["loads"] += 1
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_attention_launch.argtypes = (
        [vp] * 8 + [i] * 9 + [vp])
    lib.paged_decode_attention_launch.restype = i
    lib.paged_prefill_attention_launch.argtypes = (
        [vp] * 10 + [i] * 9 + [vp])
    lib.paged_prefill_attention_launch.restype = i
    lib.paged_verify_attention_launch.argtypes = (
        [vp] * 8 + [i] * 10 + [vp])
    lib.paged_verify_attention_launch.restype = i
    lib.flash_decode_attention_launch.argtypes = (
        [vp] * 7 + [i, vp] + [i] * 8 + [vp])
    lib.flash_decode_attention_launch.restype = i
    lib.flash_forward_launch.argtypes = [vp] * 5 + [i] * 7 + [vp]
    lib.flash_forward_launch.restype = i
    lib.flash_backward_dq_launch.argtypes = [vp] * 8 + [i] * 7 + [vp]
    lib.flash_backward_dq_launch.restype = i
    lib.flash_backward_dkv_launch.argtypes = [vp] * 8 + [i] * 7 + [vp]
    lib.flash_backward_dkv_launch.restype = i
    lib.paged_attention_error_string.argtypes = [i]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    lib.port_first_use_configs.argtypes = []
    lib.port_first_use_configs.restype = i
    _lib = lib
    return lib


def first_use_configs() -> int:
    """First-use configurations the loaded library has run (a kernel's
    shared memory raise, a cluster's fit check: once per instantiation);
    0 while no library is loaded."""
    return 0 if _lib is None else int(_lib.port_first_use_configs())


def error_string(err: int) -> str:
    return load_library().paged_attention_error_string(err).decode()


def ptxas_report() -> List[Dict[str, object]]:
    """Per-kernel resource use from the build's ``-Xptxas -v`` output:
    ``{"kernel", "registers", "smem_bytes", "spill_stores",
    "spill_loads"}``, kernel names demangled where ``c++filt`` exists."""
    out: List[Dict[str, object]] = []
    cur: Optional[Dict[str, object]] = None
    for line in _report.splitlines():
        mt = re.search(r"Compiling entry function '(\S+)'", line)
        if mt:
            cur = {"kernel": mt.group(1), "registers": None,
                   "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        mt = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if mt:
            cur["spill_stores"] = int(mt.group(1))
            cur["spill_loads"] = int(mt.group(2))
        mt = re.search(r"Used (\d+) registers", line)
        if mt:
            cur["registers"] = int(mt.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(
            str(r["kernel"]) for r in out), capture_output=True,
            text=True).stdout.splitlines()
        if len(names) == len(out):
            for r, n in zip(out, names):
                r["kernel"] = n.replace("(anonymous namespace)::", "")
    return out
