"""Host-side native code of the port: the threaded block reader.

``blockreader.cpp`` is a plain C++17 source with a C interface, built
with ``g++`` at first use into ``dnmf_tpu_torch/_build/`` (under a name
that carries a hash of the source) and bound with :mod:`ctypes`.  It
reads raw float32 recordings on native threads, clamps them to >= 0 and
prefetches the next frame block while the card computes on the current
one.  :func:`load_blockreader` returns ``None`` where no compiler is
found; :func:`dnmf_tpu_torch.data.streaming.open_raw_video` then falls
back to a memmapped source.  Nothing here runs at import time.
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
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "blockreader.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_load_failed = False

_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libblockreader_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the library unless a build of the current source exists;
    None when there is no compiler or it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir) / out.name
        proc = subprocess.run([cxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)  # atomic: concurrent builders see whole files
    return out


def load_blockreader():
    """The loaded block-reader library (built on first use), or None."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _build()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:
            lib = None
        if lib is None:
            _load_failed = True
            return None
        i64 = ctypes.c_int64
        lib.br_open.restype = ctypes.c_void_p
        lib.br_open.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_int]
        lib.br_close.argtypes = [ctypes.c_void_p]
        lib.br_read.restype = ctypes.c_int
        lib.br_read.argtypes = [ctypes.c_void_p, i64, i64, _FLOAT_P]
        lib.br_prefetch.restype = ctypes.c_int
        lib.br_prefetch.argtypes = [ctypes.c_void_p, i64, i64]
        lib.br_wait_range.restype = i64
        lib.br_wait_range.argtypes = [ctypes.c_void_p, i64, i64, _FLOAT_P,
                                      i64]
        _lib = lib
        return lib


def _out(out, n_frames: int, frame_floats: int) -> np.ndarray:
    """A C-contiguous float32 ``[n_frames, frame_floats]`` destination."""
    shape = (n_frames, frame_floats)
    if out is None:
        return np.empty(shape, np.float32)
    if (out.shape != shape or out.dtype != np.float32
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous float32 {shape}")
    return out


class BlockReader:
    """Threaded reader over a raw float32 ``[T, P]`` file.

    ``read`` is a synchronous multithreaded read + clamp; ``prefetch`` /
    ``wait`` overlap the next block's read with device compute (one
    request in flight).  Both write into ``out`` when it is given (a
    pinned staging buffer, say), else into a new array.
    """

    def __init__(self, path: str, num_frames: int, frame_floats: int,
                 num_threads: int = 4):
        lib = load_blockreader()
        if lib is None:
            raise RuntimeError("native block reader unavailable (no C++ "
                               "compiler?)")
        self._lib = lib
        self.num_frames = int(num_frames)
        self.frame_floats = int(frame_floats)
        self._h = lib.br_open(str(path).encode(), self.num_frames,
                              self.frame_floats, int(num_threads))
        if not self._h:
            raise OSError(f"cannot open {path}")

    def read(self, start: int, stop: int, out=None) -> np.ndarray:
        out = _out(out, stop - start, self.frame_floats)
        rc = self._lib.br_read(self._h, start, stop,
                               out.ctypes.data_as(_FLOAT_P))
        if rc != 0:
            raise OSError(f"br_read failed (rc={rc})")
        return out

    def prefetch(self, start: int, stop: int) -> None:
        rc = self._lib.br_prefetch(self._h, start, stop)
        if rc != 0:
            raise OSError(f"br_prefetch failed (rc={rc})")

    def wait(self, start: int, stop: int, out=None) -> np.ndarray:
        out = _out(out, stop - start, self.frame_floats)
        n = out.size
        got = self._lib.br_wait_range(self._h, start, stop,
                                      out.ctypes.data_as(_FLOAT_P), n)
        if got == -2:
            raise ValueError(f"wait({start}, {stop}) does not match the "
                             "in-flight prefetch request")
        if got != n:
            raise OSError(f"br_wait returned {got}, expected {n}")
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.br_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
