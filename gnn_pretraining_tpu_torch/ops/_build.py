"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``*.cu`` file in ``gnn_pretraining_tpu_torch/csrc/`` is compiled for
``sm_90a`` (one nvcc per source, all started together: K1 in
``gin_spmm.cu``, K2 in ``ntxent.cu``, K3 in ``spmm_csr.cu``), and the
objects are linked into ``build/torch_kernels/libgnn_kernels.so`` under the
repository root. The library has a plain C interface: each entry returns
``cudaGetLastError()`` after its launch. Nothing is built when a module is
imported; ``library()`` builds at first use when the library is missing or
older than a source.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

from gnn_pretraining_tpu_torch import config

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = config.REPO_ROOT / "build" / "torch_kernels"
LIB_NAME = "libgnn_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError("nvcc not found (set CUDA_HOME); the CUDA "
                                "kernels build only where the toolkit is")
    return found


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build(build_dir: Path = BUILD_DIR) -> Dict[str, object]:
    """Compile and link the library; returns its path, the wall seconds and
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = build_dir / (src.stem + ".o")
        cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:           # wait for every compile before raising
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    lib = build_dir / LIB_NAME
    tmp = build_dir / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *(str(o) for _, o, _ in jobs),
         "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "log": "\n".join(logs)}


def _stale(lib: Path) -> bool:
    if not lib.is_file():
        return True
    built = lib.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    if _lib is None:
        path = BUILD_DIR / LIB_NAME
        if _stale(path):
            build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        for entry in (lib.gin_spmm_fwd, lib.gin_spmm_bwd):
            entry.argtypes = [p, i, p, p, p, p, i, i, i, i, p]
            entry.restype = i
        lib.gin_spmm_workspace.argtypes = [i, i, i, i]
        lib.gin_spmm_workspace.restype = ctypes.c_longlong
        lib.ntxent_fwd.argtypes = [p] * 6 + [i, i, i, p]
        for entry in (lib.ntxent_bwd_rows, lib.ntxent_bwd_cols):
            entry.argtypes = [p] * 7 + [i, i, i, p]
        for entry in (lib.ntxent_fwd, lib.ntxent_bwd_rows, lib.ntxent_bwd_cols):
            entry.restype = i
        lib.csr_spmm.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.csr_spmm.restype = i
        lib.gin_kernels_error_string.argtypes = [i]
        lib.gin_kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = library().gin_kernels_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
