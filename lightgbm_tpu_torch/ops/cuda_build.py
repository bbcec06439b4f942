"""Build and load the port's CUDA kernels.

Each source in csrc/ is compiled by nvcc, at first use, into its own
shared library under build/ (named by a hash of the source, the shared
headers and the flags, so an edit rebuilds), with a plain C interface that
ops/*_cuda.py bind through ctypes.  ``build_all`` starts one nvcc per
source at once and waits for all of them, so a cold start costs the
slowest file, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if Path(cand).is_file():
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built from "
                           f"{CSRC} with the CUDA toolkit (set CUDA_HOME)")
    return found


class KernelLibrary:
    """One csrc/*.cu file, its shared library and its ctypes binding."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: Iterable[str] = ()):
        self.src = CSRC / source
        self.flags = NVCC_FLAGS + list(extra_flags)
        self._bind = bind
        self._cdll: Optional[ctypes.CDLL] = None
        self.log = ""  # nvcc -Xptxas -v output of the last build

    def target(self) -> Path:
        h = hashlib.sha256(self.src.read_bytes())
        for hdr in sorted(self.src.parent.glob("*.cuh")):
            h.update(hdr.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.src.stem}_{h.hexdigest()[:16]}.so"

    def start(self, force: bool = False):
        """Start nvcc unless the library is built; returns the process or
        None."""
        out = self.target()
        if out.is_file() and not force:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *self.flags, "-o", str(tmp), str(self.src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.lgbt_paths = (tmp, out)
        return proc

    def finish(self, proc) -> Path:
        if proc is None:
            return self.target()
        self.log = proc.communicate()[0]
        tmp, out = proc.lgbt_paths
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src.name} "
                               f"({proc.returncode}):\n{self.log}")
        os.replace(tmp, out)
        return out

    def build(self, force: bool = False) -> Path:
        return self.finish(self.start(force))

    def lib(self) -> ctypes.CDLL:
        if self._cdll is None:
            cdll = ctypes.CDLL(str(self.build()))
            cdll.lgbt_error_string.argtypes = [ctypes.c_int]
            cdll.lgbt_error_string.restype = ctypes.c_char_p
            self._bind(cdll)
            self._cdll = cdll
        return self._cdll

    def raise_on(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self.lib().lgbt_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def build_all(libs: Iterable[KernelLibrary], force: bool = False) -> list:
    """Build several libraries at once (one nvcc each, started together)."""
    libs = list(libs)
    procs = [lib.start(force) for lib in libs]
    return [lib.finish(p) for lib, p in zip(libs, procs)]


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# launch tallies of the CUDA graphs being captured (ops/graphs.py)
_tallies: list = []


def count_launch(counts: dict, name: str) -> None:
    """Count one launch of kernel ``name`` in a wrapper's ``counts``.  While
    a CUDA graph is being captured nothing runs: the launch is recorded in
    the graph's tally instead, and ops/graphs.py adds it to ``counts`` at
    every replay, so the counts are kernels launched, not Python calls."""
    if torch.cuda.is_current_stream_capturing():
        if not _tallies:
            raise RuntimeError(f"{name} captured outside ops/graphs.py: its "
                               "launches could not be counted")
        _tallies[-1].append((counts, name))
    else:
        counts[name] += 1
