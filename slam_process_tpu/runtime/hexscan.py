"""ctypes binding + lazy build for the native hex scanner.

The library is compiled with ``-march=native`` from the committed
``hexscan.c`` into ``build/libhexscan-<key>.so``, where the key hashes the
compiler command and the host CPU's feature flags.  A checkout copied to
another machine therefore builds its own library instead of loading one
that may use instructions its CPU lacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).with_name("hexscan.c")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def host_cpu_key() -> str:
    """Hash of the machine, the host CPU's feature flags and the flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    blob = "|".join([platform.machine(), flags, *_CFLAGS])
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def lib_path() -> Path:
    """Where this host's build of the library lives."""
    return _BUILD_DIR / f"libhexscan-{host_cpu_key()}.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _compile() -> Path:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a private name and rename, so a concurrent process never
    # loads a half-written library.
    path = lib_path()
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), *_CFLAGS, str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            raise RuntimeError("hexscan native build previously failed")
        path = lib_path()
        if not path.exists() or (
            _SRC.stat().st_mtime > path.stat().st_mtime
        ):
            try:
                _compile()
            except Exception as e:  # missing toolchain etc.
                _build_failed = True
                raise RuntimeError(f"hexscan build failed: {e}") from e
        lib = ctypes.CDLL(str(path))
        lib.hexscan_tokenize.restype = ctypes.c_size_t
        lib.hexscan_tokenize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def tokenize(data: bytes) -> np.ndarray:
    """Native tokenizer: raw log bytes -> uint8 byte values."""
    lib = _load()
    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    out = np.empty(n // 2 + 1, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    written = lib.hexscan_tokenize(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:written]
