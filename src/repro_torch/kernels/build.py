"""Build and load one hand-written CUDA source as a shared library.

Each library of the port is one ``.cu`` file with a plain C interface
(it may include headers beside it in its ``csrc/``).  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library the first time a wrapper
needs it, and loaded with ``ctypes``.  The library lands in
``build/<name>/`` at the root of the checkout, named by a hash of every
file in the source's directory and of the flags, so an edited source or
header is rebuilt and an unchanged one is reused.  Nothing is built when
a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


class NvccLibrary:
    """One CUDA source built into ``build/<name>/lib<stem>-<hash>.so``
    (``stem``: the source's file name without ``.cu``).

    ``functions`` maps each exported C function to its ctypes argument
    types; every function returns an ``int`` (a ``cudaError_t``)."""

    def __init__(self, name: str, source: Path,
                 functions: Dict[str, Sequence]):
        self.name = name
        self.source = Path(source)
        self.functions = dict(functions)
        self.build_dir = BUILD_ROOT / name
        self._lock = threading.Lock()
        self._lib = None
        self.report = ""        # the compiler's output of a verbose build

    def digest(self) -> str:
        """Hash of the source's name, every file under its directory
        (headers included) and the flags; needs no compiler."""
        h = hashlib.sha256(self.source.name.encode() + b"\0"
                           + " ".join(NVCC_FLAGS).encode())
        root = self.source.parent
        for path in sorted(p for p in root.rglob("*") if p.is_file()):
            h.update(b"\0" + path.relative_to(root).as_posix().encode()
                     + b"\0" + path.read_bytes())
        return h.hexdigest()[:16]

    def library_path(self) -> Path:
        return self.build_dir / f"lib{self.source.stem}-{self.digest()}.so"

    def build(self, verbose: bool = False) -> Path:
        """Compile the library if these sources have not been built yet;
        returns its path.  ``verbose`` adds ``-Xptxas -v`` and prints the
        compiler's report (registers, shared memory, spills)."""
        lib = self.library_path()
        if lib.exists() and not verbose:
            return lib
        self.build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS,
               *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, str(self.source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            if verbose:
                self.report = proc.stdout + proc.stderr
                print(self.report, end="")
            os.replace(tmp, lib)       # atomic: concurrent builds never tear
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return lib

    def load(self) -> ctypes.CDLL:
        """The loaded library (built first if needed), with each exported
        function's ``argtypes`` and ``restype`` declared."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fname, argtypes in self.functions.items():
                    fn = getattr(lib, fname)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib
