"""Build the port's compiled code and load it with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``build/kernels/`` at the root of the checkout (listed in .gitignore):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The host preprocessing library ``native/<name>.cpp`` (C++/OpenMP) is built
the same way with g++ into ``build/native/``:

    g++ -O3 -fopenmp -shared -fPIC -o build/native/lib<name>-<hash>.so native/<name>.cpp

(no -march=native: a build tree copied to another host must still load).

Each library name carries a hash of the source, of every header it
includes with ``#include "..."`` (``csrc/hopper.cuh``, and what that
includes), and of the flags, so an edited source or header is rebuilt and a
stale build is never loaded. Nothing here runs at
import time; the CPU tests import this module on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
NATIVE_SRC = PACKAGE / "native"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
KERNEL_SOURCES = ("flash_attention", "flash_attention_bwd", "lane_shift", "graph_cond",
                  "trace_stamp", "pose_gn", "match_taps", "rope", "layer_norm")
NATIVE_SOURCES = ("preprocess",)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # ptxas register/shared-memory report per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host with the CUDA toolkit")


def _sources(src: Path) -> list[Path]:
    """`src` and every file it includes with quotes, transitively, each once
    (paths relative to the including file, as the compilers resolve them)."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0).resolve()
        if path in seen or not path.exists():  # not beside the source: a system header
            continue
        seen.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def _target(name: str) -> tuple[Path, list[str], Path]:
    """(source, compiler command without -o, output library) of `name`."""
    if name in NATIVE_SOURCES:
        src, flags, out_dir = NATIVE_SRC / f"{name}.cpp", GXX_FLAGS, BUILD_ROOT / "native"
        cmd = ["g++", *flags]
    else:
        src, flags, out_dir = CSRC / f"{name}.cu", NVCC_FLAGS, BUILD_DIR
        cmd = ["nvcc", *flags]
    text = b"".join(path.read_bytes() for path in _sources(src))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:12]
    return src, cmd, out_dir / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu or native/<name>.cpp unless an up-to-date
    library exists."""
    src, cmd, out = _target(name)
    if out.exists():
        return out
    if cmd[0] == "nvcc":
        cmd[0] = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed for {src.name}:\n{proc.stdout}\n{proc.stderr}")
    build_logs[name] = proc.stderr.strip()
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, Path]:
    """Build every kernel source and the host library at once, one compiler
    process each."""
    names = KERNEL_SOURCES + NATIVE_SOURCES
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu or native/<name>.cpp, built on
    first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
