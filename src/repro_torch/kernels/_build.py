"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``repro_torch/csrc/*.cu`` for ``sm_90a`` (all
sources at once, one process each) and links them into one shared
library with a plain C interface, ``<repo>/build/repro_torch/
libkernels.so``, which ``ctypes`` loads. The library is rebuilt when
the hash of the sources and flags changes. Nothing is built when this
module is imported: the build runs when a CUDA tensor first reaches a
kernel, so ``import repro_torch`` works with no ``nvcc``.

Every launcher is ``extern "C"``, takes its stream last and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.

The port runs from a source checkout (``PYTHONPATH=src`` or an editable
install): the sources are read from ``src/repro_torch/csrc`` and the
library is written under the checkout's ``build/``. A wheel ships no
``.cu`` files, and :func:`build` raises there.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIBRARY = BUILD_DIR / "libkernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return path


def sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile and link the library unless a build of the same sources
    exists. The ptxas report (registers, shared memory, spills of every
    kernel) is kept beside it as ``ptxas.log``."""
    if not any(CSRC.glob("*.cu")):
        raise RuntimeError(f"no CUDA sources in {CSRC}: the port builds its "
                           "kernels from a source checkout")
    digest = sources_digest()
    stamp = BUILD_DIR / "libkernels.sha256"
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compile before reporting any failure, so no
        # nvcc outlives the call
        logs = [(src, proc.communicate()[0], proc.returncode)
                for src, _obj, proc in jobs]
        for src, out, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        so = Path(tmp) / LIBRARY.name
        link = subprocess.run(
            [compiler, *ARCH_FLAGS, "-shared", "-o", str(so),
             *(str(obj) for _src, obj, _p in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, LIBRARY)
    (BUILD_DIR / "ptxas.log").write_text(
        "\n".join(f"== {src.name}\n{out}" for src, out, _rc in logs))
    stamp.write_text(digest)
    return LIBRARY


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.rk_error_string.argtypes = [ctypes.c_int]
    lib.rk_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def function(name: str, argtypes: tuple):
    """The C launcher ``name`` with its argument types declared (each
    pointer and the stream as ``c_void_p``)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().rk_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")


def check_cuda(name: str, *tensors) -> torch.device:
    """Raise on what no kernel takes: tensors off the current CUDA
    device, or tensors that want a gradient (the kernels have no
    backward yet). Returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(f"{name}: the kernel has no backward")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for a tensor on {dev}")
    if dev.index != current_device():
        raise ValueError(f"{name}: tensor on {dev}, current device is "
                         f"cuda:{current_device()}")
    return dev


def current_device() -> int:
    """The index of the current CUDA device (torch's raw call, without
    torch.cuda's Python layers)."""
    return torch._C._cuda_getDevice()


def dtype_code(name: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPES:
        raise TypeError(f"{name}: no kernel for {dtype}")
    return DTYPES[dtype]


def check_rows16(name: str, what: str, **tensors) -> None:
    """Raise unless every tensor's rows start 16-byte aligned: the
    pointer and the strides of its leading dims (the kernels copy rows 16
    bytes at a time). Dims of size 1 are never stepped over."""
    for key, t in tensors.items():
        unit = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
                st % unit for st, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(f"{name}: {key} strides {t.stride()}: {what}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def f32(t):
    """An fp32 contiguous copy of a small operand, or the tensor itself
    when it is one already."""
    if t is None or (t.dtype == torch.float32 and t.is_contiguous()):
        return t
    return t.to(torch.float32).contiguous()


def vector(t):
    """A small operand (bias, norm gain) as the kernels read it: fp32 or
    bf16 as stored, unit stride; other dtypes become an fp32 copy."""
    if t is None:
        return t
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.to(torch.float32)
    return t if t.stride(-1) == 1 else t.contiguous()


def raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index``, as a pointer (torch's
    raw call, without a torch.cuda.Stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def stream(device: torch.device) -> int:
    return raw_stream(device.index)
