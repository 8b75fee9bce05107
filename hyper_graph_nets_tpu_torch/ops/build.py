"""Build the port's CUDA sources (and its one host C source) into shared
libraries, at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into ``_build/<stem>-<hash>.so``, where the hash
covers the source bytes, the bytes of every ``csrc`` header it includes
(``#include "..."``), the flags and any extra defines (a probe build, such
as the backward kernels' phase clock, gets its own library), then loaded
with ``ctypes``.  Nothing is built at import time; a missing ``nvcc`` or a
failed build raises.  :func:`load_host` does the same for a host C source
(``csrc/crc32c.c``) with the system C compiler (``cc``, which ``nvcc`` needs
as its host compiler anyway).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

CC_FLAGS = ("-O3", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # the ranks of a group load the kernels from several threads


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from hyper_graph_nets_tpu_torch/csrc at first use"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name)


def _local_headers(source: str) -> Sequence[str]:
    """Headers beside ``source`` that it includes with quotes, transitively."""
    seen, todo = [], [source]
    while todo:
        with open(todo.pop(), encoding="utf-8") as f:
            names = re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.MULTILINE)
        for name in names:
            path = os.path.join(os.path.dirname(source), name)
            if path not in seen:
                seen.append(path)
                todo.append(path)
    return sorted(seen)


def _flags(defines: Sequence[str]) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(source: str, defines: Sequence[str] = ()) -> str:
    return _library_path(source, _flags(defines))


def _library_path(source: str, flags: Sequence[str]) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [source, *_local_headers(source)]:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(sources: Sequence[str], defines: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together, with ``-D`` for each of ``defines``.
    Returns ``{source: library path}``; the compiler's report (registers,
    shared memory, spills) is kept beside each library as ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {src: library_path(src, defines) for src in sources}
    pending = {}
    for src, lib in paths.items():
        if os.path.isfile(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(defines), "-o", tmp, src]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending[src] = (proc, tmp, lib, cmd)
    failures = []
    for src, (proc, tmp, lib, cmd) in pending.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{out}")
            continue
        with open(lib + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def build_log(source: str, defines: Sequence[str] = ()) -> str:
    """The compiler's report for ``source`` (after :func:`build`)."""
    with open(library_path(source, defines) + ".log") as f:
        return f.read()


def load(source: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``source`` (with ``defines``) if needed and load it (once per
    process)."""
    with _lock:
        lib = build([source], defines)[source]
        if lib not in _loaded:
            _loaded[lib] = ctypes.CDLL(lib)
        return _loaded[lib]


def load_host(source: str) -> ctypes.CDLL:
    """Build the host C ``source`` with ``cc`` if needed and load it (once
    per process).  Raises ``RuntimeError`` when there is no C compiler or the
    build fails."""
    with _lock:
        lib = _library_path(source, CC_FLAGS)
        if not os.path.isfile(lib):
            cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
            if cc is None:
                raise RuntimeError(f"no C compiler (cc, gcc or clang) to build {source}")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            out = subprocess.run(
                [cc, *CC_FLAGS, "-o", tmp, source], capture_output=True, text=True
            )
            if out.returncode != 0:
                raise RuntimeError(f"{cc} failed on {source}:\n{out.stderr}")
            os.replace(tmp, lib)
        if lib not in _loaded:
            _loaded[lib] = ctypes.CDLL(lib)
        return _loaded[lib]
