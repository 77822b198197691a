"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with
``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so csrc/<name>.cu

into ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is. Nothing builds at import time: :func:`load` runs inside
the first launch, and :func:`build` starts one ``nvcc`` per source, all at
once. Every pointer and the stream are passed as ``c_void_p``; each C
entry returns ``cudaGetLastError()`` and :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
HEADERS = ("score_common.cuh", "encode_common.cuh")
SOURCES = ("sliding_scores", "sliding_scores_int", "similarity", "hdc_encode",
           "hdc_encode_perm", "int_expanded")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

#: the C entry points and their ctypes signatures, per library
SIGNATURES: dict[str, dict[str, tuple]] = {
    "sliding_scores": {
        "sliding_scores_f32": (I, [P] * 10 + [I] * 10 + [P]),
        "sliding_scores_f32_smem_bytes": (ctypes.c_size_t, []),
        "sliding_scores_f32_col_tile": (I, []),
        "sliding_scores_f32_windows": (I, []),
        "sliding_scores_f32_occupancy": (I, [I] * 3 + [P] * 4),
    },
    "sliding_scores_int": {
        "sliding_scores_int": (I, [P] * 13 + [I] * 11 + [P]),
        "sliding_scores_int_smem_bytes": (ctypes.c_size_t, []),
        "sliding_scores_int_col_tile": (I, []),
        "sliding_scores_int_occupancy": (I, [I] * 3 + [P] * 4),
    },
    "similarity": {
        "similarity_f32": (I, [P] * 3 + [I] * 4 + [F, P]),
        "similarity_chunk": (I, [I]),
    },
    "hdc_encode": {
        "hdc_encode_f32": (I, [P] * 4 + [I] * 4 + [P]),
        "hdc_encode_occupancy": (I, [I] * 2 + [P] * 4),
    },
    "hdc_encode_perm": {
        "hdc_encode_perm_f32": (I, [P] * 4 + [I] * 5 + [P]),
        "hdc_encode_perm_occupancy": (I, [I] * 2 + [P] * 4),
    },
    "int_expanded": {
        "int_expanded": (I, [P] * 12 + [I] * 9 + [P]),
        "int_expanded_col_tile": (I, []),
        "int_expanded_smem_bytes": (ctypes.c_size_t, [I, I]),
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` not built yet, one ``nvcc`` per
    source, all started together. Returns each fresh build's compiler log
    (register, shared memory and spill counts from ``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    Raises without a CUDA device: the kernels never stand in for the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"the {name} kernel needs a CUDA device")
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LOADED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")


def stream_ptr() -> int:
    """PyTorch's current CUDA stream, for a launch that should queue on it."""
    return torch.cuda.current_stream().cuda_stream
