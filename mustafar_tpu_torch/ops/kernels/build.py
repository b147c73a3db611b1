"""Build and load the port's CUDA kernels: ``nvcc`` into a plain C shared
library, loaded with ``ctypes``.

Nothing is built at import.  The first call of ``load`` compiles
``csrc/<name>.cu`` (which may include the shared ``csrc/*.cuh``) for
``sm_90a`` into ``mustafar_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name that carries the hash of the source and the
flags, so a changed source rebuilds and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) of each library built
# by this process, for the chip smoke run to print.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The hashed library name: the source, the shared headers of
    ``csrc/`` and the flags all go into the hash."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Compile (if the hashed library is missing) and load ``csrc/<name>.cu``."""
    if name in _LIBS:
        return _LIBS[name]
    so = library_path(name)
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{proc.stderr[-4000:]}")
        BUILD_LOGS[name] = proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
