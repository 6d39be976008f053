"""Builds the port's shared libraries from the sources in this checkout.

Each library compiles at first use, and again when its source is newer
than the built file, into ``build/kmer_tpu_torch/`` at the repository
root (listed in ``.gitignore``).  A build writes a temporary file and
renames it into place, so processes that build at the same time never
load a half-written library.

* CUDA kernels (``kmer_tpu_torch/csrc/*.cu``): ``nvcc`` for ``sm_90a``
  into a library with a plain C interface, loaded with ctypes.  No
  PyTorch headers are included, so a build takes seconds.  A source
  rebuilds when it or any header of ``csrc/`` (``*.cuh``) is newer than
  its library.
* The host parser (``csrc/host_parse.c``, which includes
  ``native/kmer_native.c`` whole and adds the parsers that break windows
  at non-ACGT runs): ``cc``, into ``libhost_parse.so``.  ``kmer_tpu``'s
  ``native/libkmer_native.so`` is left alone.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kmer_tpu_torch")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NATIVE_SRC = os.path.join(REPO_ROOT, "native", "kmer_native.c")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]  # registers, spills, shared memory per kernel
CC_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def build_library(src: str, name: str, compiler: list[str],
                  deps: tuple[str, ...] = ()) -> str:
    """Compile ``src`` into ``BUILD_DIR/name`` unless a build newer than
    it and its ``deps`` exists; returns the library path.  The compiler's
    messages go to ``BUILD_DIR/name.log``.  A failed build raises."""
    out = os.path.join(BUILD_DIR, name)
    newest = max(os.path.getmtime(f) for f in (src, *deps))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".tmp.so")
    os.close(fd)
    try:
        proc = subprocess.run([*compiler, "-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} from {src} failed "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        with open(f"{out}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def cuda_library(src_name: str) -> str:
    """Build ``csrc/<src_name>`` with nvcc for Hopper (``sm_90a``)."""
    stem = os.path.splitext(src_name)[0]
    headers = tuple(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                    if f.endswith(".cuh"))
    return build_library(os.path.join(CSRC_DIR, src_name), f"lib{stem}.so",
                         [_nvcc(), *NVCC_FLAGS], headers)


class KernelLibrary:
    """A ``csrc/<stem>.cu`` library loaded with ctypes.

    Every exported launch function takes pointers, integers and the
    stream, launches on that stream without synchronising and returns
    ``cudaGetLastError()``; ``<stem>_error_string`` names an error code.
    ``signatures`` maps each launch function to its ctypes argtypes.
    The library builds and loads at the first ``launch``, never at import.
    """

    def __init__(self, stem: str, signatures: dict[str, list]):
        self.stem = stem
        self.signatures = signatures
        self._lib = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(cuda_library(f"{self.stem}.cu"))
            err = getattr(lib, f"{self.stem}_error_string")
            err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = ctypes.c_int, argtypes
            self._lib = lib
        return self._lib

    def launch(self, name: str, *args) -> None:
        """Calls ``name(*args)``; a nonzero CUDA error code raises."""
        lib = self.load()
        err = getattr(lib, name)(*args)
        if err:
            msg = getattr(lib, f"{self.stem}_error_string")(err).decode()
            raise RuntimeError(f"{self.stem} kernel launch failed: {msg} "
                               f"({err})")


def native_library() -> str:
    """Build the host parser library from ``csrc/host_parse.c`` (and the
    ``native/kmer_native.c`` it includes)."""
    return build_library(os.path.join(CSRC_DIR, "host_parse.c"),
                         "libhost_parse.so", ["cc", *CC_FLAGS], (NATIVE_SRC,))
