"""Build the port's host C++ sources (`native/*.cpp`) at first use.

Each source compiles with `g++ -O2 -shared -fPIC` into a shared library
with a plain C interface, which `native/__init__.py` binds with ctypes.
Libraries go into `build/native/` at the root of the checkout, named by a
hash of the source, the compiler and its flags, so an edited source
rebuilds and an unchanged one loads the cached library. A failed build
or load raises; nothing falls back to the Python route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> seconds spent in the compiler (0.0 when loaded from the cache)
BUILD_LOG: Dict[str, float] = {}


def library_path(source: Path) -> Path:
    """Where `source` builds: `BUILD_DIR/lib<stem>_<hash>.so`."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(Path(source).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(source: Path) -> Tuple[Path, float]:
    """(library, seconds in the compiler): `source` compiled unless its
    library is cached. The compiler writes a file of its own process and
    the library appears by one rename, so processes that build at once
    never open a half-written file."""
    out = library_path(source)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [CXX, *CXX_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{CXX} could not build {source}: {e}") from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed ({proc.returncode}) on {source}:"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds


def _build_and_open(name: str) -> ctypes.CDLL:
    out, seconds = build(SRC_DIR / f"{name}.cpp")
    lib = ctypes.CDLL(str(out))
    BUILD_LOG[name] = seconds
    return lib


def load(name: str,
         bind: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """The library of `native/<name>.cpp`, built on first use; `bind`
    declares its functions' argument and result types once, when it is
    first opened."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _build_and_open(name)
            if bind is not None:
                bind(lib)
            _libs[name] = lib
        return lib
