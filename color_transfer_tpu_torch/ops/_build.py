"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded through ctypes. Builds happen at first use, never at
import, into ``color_transfer_tpu_torch/_build/`` (git-ignored), keyed on a
hash of the source, the shared headers (csrc/*.cuh) and the flags, so a
fresh checkout builds what it runs and an unchanged source is not rebuilt.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a (Hopper with its architecture-specific features); -Xptxas -v makes
# nvcc report registers, shared memory and spills of every kernel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path():
    """The nvcc of the CUDA toolkit PyTorch finds ($CUDA_HOME or
    $CUDA_PATH, else nvcc on PATH, else /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError(
            "nvcc not found: install the CUDA toolkit or set CUDA_HOME"
        )
    return str(nvcc)


def build(name):
    """Compile csrc/<name>.cu into _build/ if needed.

    Returns (library path, nvcc's report or None when the library was already
    built). Raises RuntimeError with the compiler output on failure."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, " ".join(cmd) + "\n" + proc.stdout + proc.stderr


@functools.cache
def load(name):
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))
