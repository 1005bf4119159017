"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>.so`` with a
plain C entry point; the ``nvcc`` processes start together.  The
libraries go into ``_build/<digest>/`` beside this file, where the digest
hashes the sources, the flags and the tile shape, so an edited source
rebuilds and an unchanged one is loaded as it is.  Nothing is built at
import: the first kernel launch builds everything (``build_all``).

A C entry point takes raw pointers and the CUDA stream as ``c_void_p``,
launches, and returns ``cudaGetLastError()``; ``check_launch`` raises on
anything but 0.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

#: The spike tile of the forward's occupancy flags, (block_m rows,
#: block_k columns): the dense split kernels' 32-row flag rows and 32-deep
#: slabs.  Passed to nvcc as -DBM/-DBK.
TILE = {"block_m": 32, "block_k": 32}
#: Columns of N a block of the dense split kernels owns
#: (``csrc/dense_split.cuh``); passed to nvcc as -DDENSE_COLS.
DENSE_COLS = 256

SOURCES = ("spike_gemm", "spike_gemm_fused", "spike_conv", "spike_gemm_bwd",
           "lif_step", "penc_compact", "conv_epilogue")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DBM={TILE['block_m']}", f"-DBK={TILE['block_k']}",
              f"-DDENSE_COLS={DENSE_COLS}")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every missing library in parallel; return name -> path.

    nvcc's output (with ``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept in ``<name>.log`` beside each library."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    compiler = None
    jobs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    failed = []
    for name, (proc, tmp) in jobs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, libs[name])       # atomic: readers never see half
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all on first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all()[name]))
    return _libs[name]


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_operand(t: torch.Tensor, name: str, shape: tuple,
                  device: torch.device, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (a CUDA device)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cell_lead(t: torch.Tensor, rank: int, what: str) -> tuple[int, ...]:
    """``()`` for an operand of ``rank`` dims, ``(C,)`` for a slab of C
    cells of it, ``rank + 1`` dims with the cell axis first (the kernels'
    cell axis, ``distributed/cellstack.py``); raises on any other rank."""
    if t.dim() == rank:
        return ()
    if t.dim() == rank + 1:
        return (int(t.shape[0]),)
    raise ValueError(f"{what} takes {rank} dims, or {rank + 1} with a "
                     f"leading cell axis; got {tuple(t.shape)}")


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and on 16 bytes, copied where it is not: a
    kernel's float4 loads take it, and a cell's slice of a slab lies as a
    solo tensor of its shape does (so a reduction over it takes the solo
    call's vectorized path and sums in the solo call's order)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def cuda_device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a tensor on "
                         f"{t.device}")
    return t.device


def tile_grid(m: int, k: int) -> tuple[int, int]:
    """Shape of the occupancy flags of an (m, k) spike matrix."""
    return (-(-m // TILE["block_m"]), -(-k // TILE["block_k"]))


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
