"""Build and load the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/*.cu`` file has a plain C interface and becomes its own shared
library, compiled with ``nvcc`` for ``sm_90a`` (Hopper) and loaded with
``ctypes``.  No PyTorch headers are included, so a build takes seconds.

Libraries land in ``<repo>/build/repro_torch/<hash>/`` (listed in
``.gitignore``), keyed by a hash of every source and of the compiler flags,
so an edited source rebuilds and an unchanged one loads the cached build.
All sources are compiled in parallel, one ``nvcc`` process each.  Nothing is
built at import time: the first call of a kernel wrapper builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_all", "ptxas_logs", "CSRC", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` not yet built, all ``nvcc``s in parallel.

    Returns ``{"seconds": wall time, "built": [names], "ptxas": {name:
    compiler output}}`` for the sources built by this call; each output is
    also kept beside its library (:func:`ptxas_logs`).  Raises
    ``RuntimeError`` with the compiler's output if any source fails to
    build.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            continue
        lib.with_suffix(".ptxas").write_text(logs[name])
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs), "ptxas": logs}


def ptxas_logs() -> dict[str, str]:
    """``{name: compiler output}`` of every ``csrc/*.cu`` library (ptxas's
    ``-v`` report: registers, spills, C7512), as the build that made it
    kept it; builds what is missing."""
    build_all()
    out_dir = _build_dir()
    logs = {}
    for src in sorted(CSRC.glob("*.cu")):
        log = out_dir / f"lib{src.stem}.ptxas"
        if not log.exists():
            raise RuntimeError(f"{log} is missing: remove {out_dir} and build again")
        logs[src.stem] = log.read_text()
    return logs


def load_library(stem: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds on first use).

    ``argtypes`` maps each C entry to its argument types; they are set once,
    when the library is first loaded.  Every entry returns a ``cudaError_t``
    as ``int``.
    """
    lib = _loaded.get(stem)
    if lib is not None:
        return lib
    path = _build_dir() / f"lib{stem}.so"
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = types
    _loaded[stem] = lib
    return lib
