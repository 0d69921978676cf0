"""Build and load the hand-written CUDA kernels.

Each library is one ``.cu`` source with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library on first use and loaded with
``ctypes``.  Builds land in ``build/repro_torch_kernels/`` at the root of
the checkout, named by a hash of the source, of every header it includes
(``#include "..."``, found beside the source or in ``kernels/csrc/``,
followed recursively) and of the flags, so an edited source or header
rebuilds and an unchanged one is reused.  Nothing is built when the
package is imported: only a launch on a CUDA tensor asks for a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

from repro_torch.core import clock

_KERNELS = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Headers shared by the kernels (``walk_common.cuh``,
#: ``dependent_launch.cuh``).
INCLUDE_DIR = _KERNELS / "csrc"

#: Library name -> its CUDA source, relative to this directory.
SOURCES = {"walk_step": "walk_step/csrc/walk_step.cu",
           "fused_superstep": "fused_superstep/csrc/fused_superstep.cu",
           "embedding_bag": "embedding_bag/csrc/embedding_bag.cu",
           "segment_sum": "segment_sum/csrc/segment_sum.cu"}

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME or "
            "/usr/local/cuda): the CUDA toolkit is needed to build the "
            "kernels")
    return nvcc


def _sources(path: pathlib.Path) -> list[pathlib.Path]:
    """``path`` and every local header it includes, transitively, each
    once.  A quoted include must resolve beside the including file or in
    ``INCLUDE_DIR``, as nvcc resolves it."""
    seen, todo = [], [path]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        for inc in _INCLUDE.findall(f.read_text()):
            for d in (f.parent, INCLUDE_DIR):
                if (d / inc).is_file():
                    todo.append((d / inc).resolve())
                    break
            else:
                raise FileNotFoundError(f"{f}: included header {inc!r} not "
                                        f"found beside it or in {INCLUDE_DIR}")
    return seen


def library_path(name: str) -> pathlib.Path:
    """Where library ``name`` lives once built (keyed by the bytes of its
    source and of every header it includes, and by the flags)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources((_KERNELS / SOURCES[name]).resolve()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the seconds each build took
    (0.0 for one already built).  A failed build raises RuntimeError with
    nvcc's output; ptxas' register report is kept beside the library in a
    ``.log`` file."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", tmp,
               str(_KERNELS / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, clock.now())
    failures = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = clock.now() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc/ptxas output of the build of library ``name``."""
    return library_path(name).with_suffix(".log").read_text()
