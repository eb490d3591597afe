"""Build and load the CUDA kernels of ``dnmf_tpu_torch/csrc``.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles
the sources to objects, and a last ``nvcc`` links them into one shared
library with a plain C interface, loaded with :mod:`ctypes`; no PyTorch
headers are involved, so a build takes seconds.  The library goes into
``dnmf_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags: editing a source rebuilds it, and an unchanged tree
reuses the previous build.  Processes that build at once (the ranks of a
process group) take turns on a file lock, so one of them runs ``nvcc``
and the others load its library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# Entry point -> argument types (pointers and the stream as c_void_p; a
# video's recording stride as c_longlong).
SIGNATURES = {
    "dnmf_c1": [_P] * 5 + [_L] + [_P] * 3 + [_I] * 11 + [_P],
    "dnmf_motion": [_P] * 5 + [_L] + [_P] * 3 + [_I] * 13 + [_P],
    "dnmf_gram": [_P] * 5 + [_L] + [_P] * 6 + [_I] * 14 + [_P],
    "dnmf_gram_rows": [_P] * 12 + [_I] * 10 + [_P],
    "dnmf_refine": [_P] * 12 + [_I] * 12 + [_P],
    "dnmf_phasecorr": [_P] * 13 + [_I] * 11 + [_P],
    "dnmf_warp": [_P] * 7 + [_I] * 14 + [ctypes.c_float, _P],
    "dnmf_table": [_P] * 5 + [_I] * 4 + [_P],
    "dnmf_gram_closed": [_P] * 5 + [_I] * 12 + [_P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Path of the library the current sources build into."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libdnmf_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently; raise on the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile the kernels unless a build of the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not out.exists():  # another process may have built it meanwhile
            _compile(out)
    return out


def _compile(out: Path) -> None:
    cu, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [str(Path(tmp_dir) / f"{src.stem}.o") for src in cu]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(cu, objs)])
        tmp = str(Path(tmp_dir) / out.name)
        _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a loader never sees a partial file


def load():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
