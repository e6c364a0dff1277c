"""Hand-written CUDA kernels of the port and their build.

Each kernel is one source under ``csrc/`` with a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``; the library's name carries a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt.  Nothing is compiled or loaded when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_fwd_sm90.cu",
           "flash_fwd_f32_sm90.cu", "flash_bwd_sm90.cu",
           "flash_bwd_rows_sm90.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(source: str) -> Path:
    """Where ``source``'s library lands: named by a hash of the source, the
    shared headers and the flags."""
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together.  Returns {source: {"seconds", "ptxas"}}; raises with
    the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    report = {}
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
        report[src] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = library_path(source)
            if not path.exists():
                build_all([source])
            lib = ctypes.CDLL(str(path))
            _LIBS[source] = lib
        return lib
