"""Build the hand-written CUDA kernels (ops/csrc/*.cu) and load them.

nvcc compiles each source in csrc/ to an object for sm_90a (Hopper), all
sources at the same time, and links the objects into one shared library
with a plain C interface, which ctypes loads.  The sources include no
PyTorch header, so a build takes seconds.  The library lands in
<repo>/build/torch_kernels/, named by a hash of the sources and flags, so
an edited kernel is rebuilt and an unchanged one is reused.  Nothing is
built when this module is imported: the first kernel launch calls load().
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of single sources: wave_encode.cu and code_residual.cu take float32
#: decisions that must round as separate multiplies and adds do, so nvcc may
#: fuse none of them
SOURCE_FLAGS = {"wave_encode.cu": ("-fmad=false",),
                "code_residual.cu": ("-fmad=false",)}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or "
                           "CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return BUILD_DIR / f"libavl_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    The compiler's report (registers, shared memory, spills per kernel)
    is kept beside the library as <name>.log."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS,
               *SOURCE_FLAGS.get(src.name, ()), "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report, failed = [], []
    for cmd, obj, proc in jobs:
        out, _ = proc.communicate()
        report.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out[-4000:])
    tmp = BUILD_DIR / f"{tag}.tmp"
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        report.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr[-4000:])
    so.with_suffix(".log").write_text("\n".join(report))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    return so


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    return ctypes.CDLL(str(build()))
