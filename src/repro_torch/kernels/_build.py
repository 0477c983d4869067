"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
their source, and are built at first use: one ``nvcc`` per source, all
started together.  Nothing here runs when the module is imported.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# library name -> (source, {C function: argument kinds}); "p" is a pointer
# or the stream (c_void_p), "i" an int64
SOURCES = {
    "bitonic_sort": ("bitonic_sort.cu", {
        "bitonic_sort_i64": "pip",
        "bitonic_sort_i32": "pip",
        "bitonic_sort_kv_i64": "ppip",
    }),
    "probe_sorted": ("probe_sorted.cu", {
        "probe_sorted_i64": "pipippip",
    }),
    "merge_ranks": ("merge_ranks.cu", {
        "merge_ranks_i64": "pipiippip",
    }),
    "unique_mask": ("unique_mask.cu", {
        "unique_mask_i64": "pipp",
    }),
    "flash_attention": ("flash_attention.cu", {
        "flash_attention_f32": "pppp" + "i" * 9 + "p",
        "flash_attention_bf16": "pppp" + "i" * 9 + "p",
        "flash_attention_f16": "pppp" + "i" * 9 + "p",
    }),
    "flash_attention_tc": ("flash_attention_tc.cu", {
        "flash_attention_tc_bf16": "pppp" + "i" * 9 + "p",
        "flash_attention_tc_f16": "pppp" + "i" * 9 + "p",
    }),
    "ssd_intra": ("ssd_intra.cu", {
        "ssd_intra_f32": "pppppp" + "i" * 6 + "pip",
        "ssd_gram_f32": "pp" + "i" * 4 + "pip",
    }),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_ARG = {"p": ctypes.c_void_p, "i": ctypes.c_int64}
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers
    beside it (``*.cuh``, which a source may include) and the flags."""
    src = CSRC / SOURCES[name][0]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every library that is not built yet, all in parallel.
    Returns the seconds each build took (0 for libraries already there);
    raises with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, (src, _) in SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    secs = {name: 0.0 for name in SOURCES}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name][0]}:\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with
    ``argtypes``/``restype`` declared for every entry point."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = _LIBS[name] = load(path, name)
    return lib


def load(path: Path, name: str) -> ctypes.CDLL:
    """The shared library at ``path`` with ``argtypes``/``restype``
    declared for the entry points of library ``name``."""
    lib = ctypes.CDLL(str(path))
    for fn, kinds in SOURCES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = [_ARG[k] for k in kinds]
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
