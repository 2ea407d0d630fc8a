"""Native (C) host runtime: the lock-free real-time TX mixer.

The audio callback must not touch Python allocation or NumPy dispatch, so
the streaming mix runs in C (``mixer.c``): a lock-free single-producer /
single-consumer chip ring and the RMS/floor/headroom mix law of
``WatermarkEmbedder.process``.  A feeder thread fills the ring
(``stream.NativeStreamEmbedder``).  This is host code; no GPU is involved.

The library is built on first use with the system C compiler
(``cc -O2 -shared -fPIC``) into ``build/echoseal_torch/`` at the repository
root, named by the SHA-256 prefix of ``mixer.c``: a changed source builds
anew.  Importing this module touches no file; ``available()`` is False
where no compiler or source is present, and callers (``tx_app --native``)
then use the Python mixer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from echoseal_torch.ops.build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "mixer.c"
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for the current ``mixer.c`` is built."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"_mixer-{digest}.so"


def _build(so: Path) -> None:
    """Compile to a temporary name, then rename into place, so that a
    concurrent or interrupted build never leaves a partial library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", str(_SRC), "-o", tmp,
                        "-lm"], check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """Load (building if needed) the native mixer library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            # a foreign-architecture binary: rebuild once and retry
            _build(so)
            lib = ctypes.CDLL(str(so))
        lib.mixer_new.restype = ctypes.c_void_p
        lib.mixer_new.argtypes = [ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_size_t]
        lib.mixer_free.argtypes = [ctypes.c_void_p]
        lib.mixer_available.restype = ctypes.c_size_t
        lib.mixer_available.argtypes = [ctypes.c_void_p]
        lib.mixer_space.restype = ctypes.c_size_t
        lib.mixer_space.argtypes = [ctypes.c_void_p]
        lib.mixer_push_chips.restype = ctypes.c_size_t
        lib.mixer_push_chips.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        lib.mixer_process.restype = ctypes.c_size_t
        lib.mixer_process.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        _lib = lib
        return lib


def available() -> bool:
    """True when the mixer library builds (or is built) and loads."""
    try:
        load()
        return True
    except Exception:
        return False


class NativeMixer:
    """SPSC chip-ring mixer: feed chips from one thread, mix in the audio
    callback without touching Python object allocation."""

    def __init__(self, *, target_rel_db: float = -10.0,
                 floor_rel_dbfs: float = -35.0, headroom: float = 0.98,
                 capacity_pow2: int = 18) -> None:
        self._lib = load()
        self._h = self._lib.mixer_new(target_rel_db, floor_rel_dbfs,
                                      headroom, capacity_pow2)
        if not self._h:
            raise MemoryError("mixer_new failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mixer_free(h)
            self._h = None

    @property
    def available_chips(self) -> int:
        return int(self._lib.mixer_available(self._h))

    @property
    def space(self) -> int:
        return int(self._lib.mixer_space(self._h))

    def push_chips(self, chips: np.ndarray) -> int:
        """Append chips to the ring; returns how many fitted."""
        c = np.ascontiguousarray(chips, dtype=np.float32)
        return int(self._lib.mixer_push_chips(
            self._h, c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            c.size))

    def process(self, block: np.ndarray) -> tuple[np.ndarray, int]:
        """Mix one audio block; returns (out, chips consumed).  Fewer chips
        than samples means the ring ran dry: the rest passes through."""
        x = np.ascontiguousarray(block, dtype=np.float32)
        out = np.empty_like(x)
        used = self._lib.mixer_process(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size)
        return out, int(used)
