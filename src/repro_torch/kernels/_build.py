"""Build the port's CUDA kernels and load them with ctypes.

The sources in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` at first
use (one ``nvcc -c`` per source, all started together, then one link) into
a single shared library with a plain C interface. The library lands in
``build/repro_torch/`` at the repository root (``REPRO_TORCH_BUILD_DIR``
overrides it), named by a digest of the sources and flags, so a stale build
is never loaded. Nothing but the sources goes into it.

Every C entry point takes raw pointers, sizes and the stream, launches, and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("pack.cu", "fused_compress.cu", "fused_update.cu", "gossip_mix.cu",
           "block_topk.cu", "qsgd.cu", "threefry.cu", "gilbert.cu")
HEADERS = ("pack_tile.cuh", "qsgd_round.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# leaf tables: host arrays of pointers, sizes and f32 scalars
_PP, _PL = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)
_PF, _PI = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "repro_pack_topk": [_PP, _PL, _PL, _PL, _I, _L, _P, _P, _I, _P],
    "repro_delta_pack": [_PP, _PP, _PL, _PL, _PL, _I, _L, _P, _P, _I, _P],
    "repro_unpack_topk": [_PP, _PP, _PP, _PL, _PL, _I, _L, _I, _P],
    "repro_fused_update": [_P, _P, _P, _P, _P, _L, _F, _F, _P],
    "repro_cffl_update": [_P, _P, _P, _P, _L, _F, _P],
    "repro_dsgld_update": [_P, _P, _P, _P, _L, _F, _P],
    "repro_gossip_mix": [_PP, _PP, _PL, _I, _L, _P, _P, _I, _I, _F, _P],
    "repro_topk_select": [_PP, _PP, _PL, _PL, _PI, _PL, _I, _L, _P, _P, _P],
    "repro_unpack_set": [_PP, _PP, _PP, _PL, _PL, _PI, _I, _L, _P],
    "repro_block_topk": [_P, _P, _L, _L, _L, _I, _P],
    "repro_grid_quant": [_PP, _PP, _PP, _PP, _PL, _I, _L, _F, _P],
    "repro_qsgd": [_PP, _PP, _PP, _PP, _PL, _PL, _PF, _I, _F, _P],
    "repro_threefry": [_PP, _PL, _PL, _PP, _PL, _PI, _PL, _PP, _PL, _PF,
                       _I, _P],
    "repro_gilbert_keep": [_PP, _PP, _PP, _PL, _I, _L, _P, _PF, _P],
    # v (and v̄) stored in bfloat16
    "repro_delta_pack_bf16": [_PP, _PP, _PL, _PL, _PL, _I, _L, _P, _P, _I,
                              _P],
    "repro_topk_select_bf16": [_PP, _PP, _PL, _PL, _PI, _PL, _I, _L, _P, _P,
                               _P],
    "repro_fused_update_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _F,
                                _F, _P],
    "repro_cffl_update_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _F, _P],
}

_lib = None
build_log = ""          # ptxas -v report of the build made in this process


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built with "
                       "the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this digest is not built yet; return the .so."""
    global build_log
    out = build_dir() / f"librepro_torch_{_digest()}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for name in SOURCES:
            obj = Path(tmp) / f"{name}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
                   "-o", str(obj)]
            jobs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for name, _, proc in jobs:
            _, err = proc.communicate()
            (failed if proc.returncode else logs).append(f"[{name}]\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *(str(obj) for _, obj, _ in jobs), "-o",
             str(staged)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(staged, out)       # atomic, so concurrent builds agree
    build_log = "\n".join(logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_card(kernel: str, operands, strided: bool = False) -> bool:
    """The dispatch rule of every wrapper, given ``(tensor, dtype)`` pairs:
    True (launch the kernel) for CUDA tensors; False (run the plain version)
    for CPU tensors, and for ``meta`` tensors, where the plain version only
    infers shapes. There is no fallback: a CUDA tensor launches its kernel
    or the wrapper raises. ``strided``: the kernel reads its operands
    through their strides, so they need not be contiguous."""
    dev = operands[0][0].device
    for t, dtype in operands:
        if t.device != dev:
            raise ValueError(f"{kernel}: operands on {dev} and {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: got {t.dtype}, the kernel takes {dtype}")
        if dev.type == "cuda" and not strided and not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
    if dev.type == "cuda":
        return True
    if dev.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{kernel}: no kernel for device {dev}")
