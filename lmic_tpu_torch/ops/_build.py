"""Build the port's native sources into shared libraries on first use.

Each source under `lmic_tpu_torch/csrc/` compiles to its own library in
`lmic_tpu_torch/_build/` (listed in .gitignore), named after a hash of the
source, the shared CUDA headers (`csrc/*.cuh`) for a `.cu` source, and the
command, so an edited source or header never loads a stale library.
The compiler writes to a temporary file that is then `os.replace`d into
place: concurrent processes (pytest-xdist workers, a server and a test)
may each build, and none ever loads a half-written file. A failed build
raises with the compiler's stderr.

The CUDA sources use a plain C interface loaded with ctypes, so `nvcc`
compiles them in seconds without PyTorch's headers or ninja.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_LOCK = threading.Lock()
_loaded = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "lmic_tpu_torch are compiled on the machine with the GPU"
    )


def _command(source: str, out: str):
    src = os.path.join(CSRC, source)
    if source.endswith(".cu"):
        # sm_90a: Hopper with its architecture-specific instructions; no
        # --use_fast_math, so sqrtf/division stay IEEE and results match
        # the plain f32 version to the stated bars
        return [
            _nvcc(), "-O3", "-std=c++17",
            "-gencode", "arch=compute_90a,code=sm_90a",
            "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
            "-o", out, src,
        ]
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", out, src]


def _inputs(source: str):
    """The files `source`'s library is built from: the source and, for a
    CUDA source, every shared header it may include."""
    paths = [os.path.join(CSRC, source)]
    if source.endswith(".cu"):
        paths += sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return paths


def library_path(source: str) -> str:
    """Where `source`'s library lives once built (it may not exist yet)."""
    digest = hashlib.sha256()
    for path in _inputs(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_command(source, "")[1:]).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build(source: str) -> str:
    """Compile `csrc/<source>` unless its library exists; return its path.
    The compiler's output (ptxas register and shared-memory use for .cu
    sources) is kept beside the library as `<lib>.log`."""
    lib = library_path(source)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            _command(source, tmp), capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {source} failed (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        with open(lib + ".log", "w") as f:
            f.write(proc.stderr + proc.stdout)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>`; one handle per process."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _loaded.get(source)
        if lib is None:
            lib = _loaded[source] = ctypes.CDLL(build(source))
    return lib
