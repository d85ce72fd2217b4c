"""Build and load the port's CUDA kernels.

Each ``vts_torch/csrc/<name>.cu`` has a plain C interface.  It is compiled
by hand with ``nvcc`` into ``vts_torch/_build/lib<name>-<hash>.so`` (a
git-ignored directory) the first time a wrapper needs it, and loaded with
``ctypes``.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt.  :func:`build` starts one ``nvcc`` per source, all at once, and
waits for them; ``chip_smoke.py`` calls it to build everything in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("conv3x3", "gather_patches", "scatter_patches")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the GPU")


def library_path(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together.  Returns name → library path;
    the ptxas report of each fresh build is kept beside it as ``.log``."""
    names = list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        out[n].with_suffix(".log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
