"""Build the port's CUDA sources and load them with ctypes.

Every ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
with ``nvcc`` for ``sm_90a``, into ``build/repro_torch/lib<name>.so`` at
the root of the checkout; the shared ``csrc/*.cuh`` headers are included
by the sources that need them.  A library is rebuilt when it is missing
or older than its source or any header.  Nothing is built when the
package is imported: the first launch builds what it needs, and
:func:`build` builds several sources at once, one ``nvcc`` process each,
all started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> CUDA source, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
        "kernels cannot be built")


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    inputs = [sources()[name], *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(names: Optional[Iterable[str]] = None, *,
          force: bool = False) -> Dict[str, dict]:
    """Compile the named sources (default: all) in parallel.

    Returns ``{name: {"seconds": s, "log": ptxas_report}}`` for each
    source compiled; raises ``RuntimeError`` with the compiler's output
    if any compile fails.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": out}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
