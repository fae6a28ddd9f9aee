"""Build the native sources under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` becomes ``build/mlx_mcmc_tpu_torch/lib<name>.so``
(beside the package, in a directory that ``.gitignore`` lists), compiled
with ``nvcc`` for ``sm_90a``; each ``csrc/<name>.c`` (host code: the native
R-hat and ESS, ``fastdiag.c``) with the host's ``gcc -O3 -fopenmp``. Both
at first use and again whenever the source is newer. The libraries have a
plain C interface and are loaded with ``ctypes``; nothing includes
PyTorch's or Python's headers, so a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PACKAGE = Path(__file__).resolve().parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "mlx_mcmc_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
GCC_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and Path(c).is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _gcc() -> str:
    gcc = shutil.which("gcc")
    if gcc is None:
        raise RuntimeError("gcc not found: put gcc on PATH")
    return gcc


def library_path(name: str, out_dir=None) -> Path:
    return Path(out_dir or BUILD_DIR) / f"lib{name}.so"


def _source(name: str, src_dir: Path) -> Path:
    """``<src_dir>/<name>.cu``, else ``<src_dir>/<name>.c``."""
    cu = Path(src_dir) / f"{name}.cu"
    return cu if cu.exists() else cu.with_suffix(".c")


def _command(src: Path, tmp: Path, verbose: bool) -> list:
    if src.suffix == ".c":
        return [_gcc(), *GCC_FLAGS, "-o", str(tmp), str(src), "-lm"]
    return [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []), "-o", str(tmp), str(src)]


def _sources(src: Path) -> list:
    """``src`` and the files it includes with ``#include "..."``, recursively."""
    found, todo = [], [Path(src)]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for line in path.read_text().splitlines():
            if line.startswith('#include "'):
                todo.append(path.parent / line.split('"')[1])
    return found


def build(names: Iterable[str], verbose: bool = False, src_dir: Path = CSRC_DIR,
          out_dir=None) -> Dict[str, str]:
    """Compile every stale ``<src_dir>/<name>.cu`` or ``.c`` in ``names``
    (older than it or than a file it includes) into
    ``<out_dir>/lib<name>.so`` (default ``BUILD_DIR``) with one compiler
    each, all started together. Returns ``{name: compiler output}`` for the
    sources it built (with ``verbose``, ptxas's register and shared-memory
    report and its remarks). Raises with the compiler's output if any build
    fails. Each writes a temporary file of its own process and renames it
    into place, so processes that build at once never load a half-written
    library."""
    out_dir = Path(out_dir or BUILD_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _source(name, src_dir), library_path(name, out_dir)
        newest = max(p.stat().st_mtime for p in _sources(src))
        if out.exists() and out.stat().st_mtime >= newest:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(src, tmp, verbose)
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return logs


def load(name: str, path=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.c``, built first if
    needed.
    With ``path``, the library there (a build of a variant of that source)
    takes its place from now on."""
    if path is not None:
        _LOADED[name] = ctypes.CDLL(str(path))
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
