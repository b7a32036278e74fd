"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and
compiles on its own into ``build/repro_torch/lib<name>.so`` at the repo
root (listed in ``.gitignore``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/repro_torch/lib<name>.so csrc/<name>.cu

The library is loaded with ``ctypes``; the Python wrappers pass raw
device pointers (``tensor.data_ptr()``) and PyTorch's current stream.
Nothing here runs at import: the first launch builds (or reuses an
up-to-date build), and :func:`build_all` starts one ``nvcc`` per source
in parallel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return src, BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _command(name: str, out: Path, verbose: bool) -> list[str]:
    src, _ = _paths(name)
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(out), str(src)]
    if verbose:
        cmd.insert(1, "--ptxas-options=-v")
    return cmd


def build_all(names=None, verbose: bool = False) -> dict[str, str]:
    """Compile every stale kernel library, one ``nvcc`` per source, all
    started together. Returns ``{name: compiler output}``; raises with
    the compiler's output when a build fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not (_stale(name) or verbose):
            continue
        _, lib = _paths(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, lib)          # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    the build is missing or older than the source."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
