"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``): no
PyTorch headers, so a build takes seconds.  Libraries land in ``build/kernels``
at the repository root, named by a hash of their sources, so an edited kernel
is rebuilt and an unchanged one is reused; beside each lies the compiler's
output (``.log``: ptxas's registers, shared memory and spills per kernel).
:func:`build` compiles every missing library at once, one ``nvcc`` process per
source; :func:`lib` builds on first use.  Nothing is compiled when a module is
imported.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code, so a refused launch never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("eltwise", "bconv", "automorphism", "ntt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points of each library: name → argtypes (all return int).
SIGNATURES = {
    "eltwise": {
        "efu_launch": [_I] + [_P] * 4 + [_LL] * 4 + [_P, _LL] + [_P] * 3
                      + [_I] * 3 + [_P],
    },
    "bconv": {
        "bconv_launch": [_P] * 8 + [_I] * 6 + [_LL] * 3 + [_P],
        "bconv_ctas_per_sm": [_I, _I, _P],
    },
    "automorphism": {
        "auto_ks_launch": [_P] * 7 + [_I] * 5 + [_P],
        "automorphism_multi_launch": [_P, _P, _P] + [_I] * 7 + [_P],
        "automorphism_rows_launch": [_P, _P, _P, _LL, _I, _I, _P],
        "automorphism_eager_launch": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
        "automorphism_blocks_launch": [_P, _P, _P, _LL, _I, _I, _I, _LL, _I, _P],
    },
    "ntt": {
        "ntt_fwd_launch": [_P] * 9 + [_I] * 6 + [_P],
        "ntt_inv_launch": [_P] * 13 + [_I] * 6 + [_P],
        "ntt_fwd_col_launch": [_P] * 7 + [_LL] * 4 + [_I] * 8 + [_P],
        "ntt_fwd_row_launch": [_P] * 5 + [_LL] * 4 + [_I] * 8 + [_P],
        "ntt_inv_row_launch": [_P] * 7 + [_LL] * 4 + [_I] * 8 + [_P],
        "ntt_inv_col_launch": [_P] * 9 + [_LL] * 4 + [_I] * 8 + [_P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> float:
    """Compile every missing library in parallel; returns the seconds taken.

    Each library is written to a private temporary file and renamed into
    place, so concurrent builders never load a half-written file.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its argtypes bound (built if missing)."""
    out = _libs.get(name)
    if out is None:
        build((name,))
        out = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(out, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        out.repro_cuda_error_string.argtypes = [ctypes.c_int]
        out.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = out
    return out


def check(name: str, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({msg})")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the operands are CUDA tensors (kernel path), False if they are
    CPU tensors (plain path); raises on any other device or on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all be on CUDA or all on the CPU, "
                     f"got devices {sorted(kinds)}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t: torch.Tensor) -> torch.cuda.device:
    """Context that makes ``t``'s card the current CUDA device.  Every
    launcher runs inside it: a kernel launch, a function attribute and an
    occupancy query act on the current device, whatever card holds the
    operands."""
    return torch.cuda.device(t.device)


def require(tensors: dict[str, torch.Tensor], dtype: torch.dtype,
            device: torch.device, contiguous: bool = True) -> None:
    """Validate operands before their pointers reach a kernel."""
    for label, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{label}: on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{label}: dtype {t.dtype}, expected {dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{label}: must be contiguous")
