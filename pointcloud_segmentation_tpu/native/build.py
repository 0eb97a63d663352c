"""Lazy build of the native runtime library (g++ -> shared object).

pybind11 is not available, so the native runtime exposes a C ABI consumed
via ctypes.  The library is compiled on first use from
``native/pcs_runtime.cpp`` into the checkout's gitignored ``build/``
directory (or a temp-dir cache when the checkout is read-only).  Its file
name carries a hash of the source, so a library built from other source
text is never loaded; failures fall back to the pure-Python
implementations.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CHECKOUT = os.path.dirname(os.path.dirname(_PKG_DIR))
_SRC_CANDIDATES = (
    os.path.join(_CHECKOUT, "native", "pcs_runtime.cpp"),
    os.path.join(_PKG_DIR, "pcs_runtime.cpp"),
)
_CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _source_path() -> str | None:
    for c in _SRC_CANDIDATES:
        if os.path.exists(c):
            return c
    return None


def library_name(src: str) -> str:
    """``libpcs_runtime-<hash>.so``, keyed by the source bytes and flags."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXXFLAGS).encode())
    return f"libpcs_runtime-{h.hexdigest()[:16]}.so"


def _out_dir() -> str:
    out = os.path.join(_CHECKOUT, "build")
    try:
        os.makedirs(out, exist_ok=True)
    except OSError:
        pass
    if not os.access(out, os.W_OK):
        out = os.path.join(tempfile.gettempdir(), "pcs_native")
        os.makedirs(out, exist_ok=True)
    return out


def library_path(rebuild: bool = False) -> str | None:
    """Path to the built shared library, building it if needed."""
    src = _source_path()
    if src is None:
        return None
    lib = os.path.join(_out_dir(), library_name(src))
    if not rebuild and os.path.exists(lib):
        return lib
    # build under a private name, then rename: concurrent builders (test
    # workers) never load a half-written library
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *_CXXFLAGS, "-o", tmp, src, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return lib
