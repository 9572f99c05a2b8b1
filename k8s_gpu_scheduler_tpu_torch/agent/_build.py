"""Build the node prober (``csrc/tpuprobe.cpp``) with ``g++``.

The build runs at first use — never at import — into ``build/agent/`` at
the repository root (listed in ``.gitignore``), from the repository's
source only. The binary's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale binary is never run;
it is written in a fresh temporary directory and renamed into place, so
a concurrent build never sees a half-written file. NVML is opened at run
time with ``dlopen`` (``-ldl``), so the build needs no CUDA header or
library. ``build_kvstored`` builds the registry's server
(``native/kvstore/kvstore.cpp``), which the agents publish into, the same
way.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parent / "csrc" / "tpuprobe.cpp"
BUILD_DIR = ROOT / "build" / "agent"
CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra")
LIBS = ("-ldl",)
KVSTORE = ROOT / "native" / "kvstore" / "kvstore.cpp"
KVSTORE_FLAGS = ("-std=c++17", "-O2", "-pthread")


def binary_path(source: Path = SOURCE, flags=CXX_FLAGS, libs=LIBS) -> Path:
    """Where the build of ``source`` with these flags lives (it may not
    exist yet)."""
    h = hashlib.sha256(" ".join(flags + libs).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}"


def build(source: Path = SOURCE, flags=CXX_FLAGS, libs=LIBS) -> Path:
    """Compile ``source`` (the prober by default) unless its binary
    already exists."""
    exe = binary_path(source, flags, libs)
    if exe.exists():
        return exe
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} is built at "
                           "first use and needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / source.stem
        cmd = [cxx, *flags, "-o", str(out), str(source), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(out, exe)
    return exe


def build_kvstored() -> Path:
    """The registry's server, built as the prober is."""
    return build(KVSTORE, KVSTORE_FLAGS, ())
