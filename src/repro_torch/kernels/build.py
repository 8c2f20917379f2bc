"""Build and load the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, bound with ``ctypes``.

Each source under ``csrc/`` becomes its own ``.so``, compiled for
``sm_90a`` at first use into ``<repo>/build/kernels`` (listed in
``.gitignore``), named by a hash of every source and header plus the flags,
so a changed source is rebuilt and an unchanged one is reused. All sources
compile in parallel, one ``nvcc`` each. Nothing is built when a module is
imported; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

#: Library name -> CUDA source (one nvcc each).
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "paged_prefill": "paged_prefill.cu",
    "paged_decode": "paged_decode.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Library name -> {"seconds": build wall time, "log": nvcc/ptxas output}.
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on a machine with the card")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str, digest: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=None) -> Dict[str, dict]:
    """Compile every library not yet built for the current sources, all in
    parallel; returns :data:`build_info`. Raises with nvcc's output if any
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name, digest)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[name]} (exit {proc.returncode})\n{log}")
            continue
        tmp.replace(out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return build_info


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            digest = _digest()
            if not _target(name, digest).exists():
                build_all([name])
            lib = ctypes.CDLL(str(_target(name, digest)))
            _libs[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``symbol`` of library ``name``, with its argument types
    set (pointers and the stream as ``c_void_p``: ctypes would otherwise
    pass them as 32-bit ints)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(status: int, what: str) -> None:
    if status == -1:
        raise ValueError(f"{what}: shape or dtype not instantiated by the CUDA build")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel that has
    none: its output is written by the kernel, so it would carry no
    ``grad_fn`` and the inputs would silently get no gradient. Grad mode is
    off inside an ``autograd.Function``'s ``forward``, so a Function that
    launches the kernel passes."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} cannot differentiate its CUDA kernel's output; call it "
            "under torch.no_grad(), or use ops.flash_attention, whose "
            "autograd Function runs the backward kernels")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
