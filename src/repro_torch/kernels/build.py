"""Building the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The libraries go into the
build directory (:func:`build_dir`), named by a hash of their sources, so a
changed source is rebuilt and an unchanged one is reused. Nothing is built
when the package is imported: the first launch of a kernel builds it, or
:func:`build_all` builds every kernel at once, one ``nvcc`` per source, all
started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

#: the CUDA sources, shipped as package data
CSRC = Path(__file__).resolve().parents[1] / "csrc"

#: the kernels of ``csrc/`` that build into their own library
KERNELS = ("dot", "axpydot", "gemm", "stencil", "stencil_star",
           "decode_attention", "wkv", "flash_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """Where built kernels (and generated Triton modules) are written:
    ``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch`` under the
    checkout that holds this package."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    root = Path(env) if env else \
        Path(__file__).resolve().parents[3] / "build" / "repro_torch"
    root.mkdir(parents=True, exist_ok=True)
    return root


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc was not found; the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its sources."""
    h = hashlib.sha1()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path):
    return [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Build the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns, per kernel, its library, the
    seconds its build took (0 when it was already built) and ``ptxas``'s
    report of registers and shared memory. Raises when a build fails."""
    jobs, done = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            done[name] = {"library": str(lib), "seconds": 0.0, "ptxas": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        jobs[name] = (lib, tmp, time.perf_counter(), subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, t0, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        tmp.replace(lib)
        done[name] = {"library": str(lib),
                      "seconds": time.perf_counter() - t0,
                      "ptxas": "\n".join(ln for ln in log.splitlines()
                                         if "ptxas info" in ln)}
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n" +
                           "\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


def check(rc: int, what: str):
    """Raise when a C entry point returned a nonzero ``cudaError_t``: a
    refused launch never runs, and ``synchronize`` would not report it."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


#: the ``dtype`` code the C entry points take
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def vector_operands(what: str, *xs):
    """Check the (N,) operands of a reduction kernel: CUDA tensors on one
    device, one dtype the kernel takes, one length, contiguous. Returns
    (N, dtype code, whether every operand allows 16-byte loads)."""
    dev, dt, n = xs[0].device, xs[0].dtype, xs[0].shape
    for x in xs:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{what}: operands must lie on one CUDA device")
        if x.dtype != dt or str(dt) not in DTYPE_CODES:
            raise ValueError(f"{what}: operands must all be float32 or all "
                             f"bfloat16, got {[str(y.dtype) for y in xs]}")
        if x.dim() != 1 or x.shape != n:
            raise ValueError(f"{what}: operands must be (N,) vectors of one "
                             f"length, got {[tuple(y.shape) for y in xs]}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    vec = all(x.data_ptr() % 16 == 0 for x in xs)
    return int(n[0]), DTYPE_CODES[str(dt)], vec


def partial_blocks(device) -> int:
    """Blocks of a first reduction stage: four per SM."""
    import torch
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count
