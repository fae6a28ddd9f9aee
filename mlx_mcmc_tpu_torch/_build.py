"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes ``build/mlx_mcmc_tpu_torch/lib<name>.so``
(beside the package, in a directory that ``.gitignore`` lists), compiled for
``sm_90a`` at first use and again whenever its source is newer. The
libraries have a plain C interface and are loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds, not minutes.
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


def library_path(name: str, out_dir: Path = BUILD_DIR) -> Path:
    return Path(out_dir) / f"lib{name}.so"


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
          out_dir: Path = BUILD_DIR) -> Dict[str, str]:
    """Compile every stale ``<src_dir>/<name>.cu`` in ``names`` (older than
    it or than a file it includes) into ``<out_dir>/lib<name>.so`` with one
    ``nvcc`` each, all started together. Returns ``{name: compiler output}``
    for the sources it built (with ``verbose``, ptxas's register and
    shared-memory report and its remarks). Raises with the compiler's output
    if any build fails."""
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = Path(src_dir) / f"{name}.cu", library_path(name, out_dir)
        newest = max(p.stat().st_mtime for p in _sources(src))
        if out.exists() and out.stat().st_mtime >= newest:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(src)]
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
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, path=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
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
