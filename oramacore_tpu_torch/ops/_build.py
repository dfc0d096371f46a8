"""Build the port's CUDA sources (`ops/csrc/*.cu`) at first use.

Each source compiles with nvcc into a shared library with a plain C
interface, which the ops modules load with ctypes: pointers are
`tensor.data_ptr()` and the stream is PyTorch's current CUDA stream,
both passed as `c_void_p`; sizes are `c_int64`. A source that includes
no PyTorch header builds in seconds.

Libraries go into `build/kernels/` at the root of the checkout, named by
a hash of every file under `csrc/` and the compiler flags, so an edited
source rebuilds and an unchanged one loads the cached library. A failed
build raises; nothing falls back. `load_all` runs one nvcc per source,
all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / spills into the build log
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent in nvcc, 0.0 when loaded from the cache; nvcc output)
BUILD_LOG: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: cannot build the CUDA kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.is_file():
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build_and_open(name: str) -> ctypes.CDLL:
    source = CSRC / f"{name}.cu"
    if not source.exists():
        raise FileNotFoundError(source)
    out = BUILD_DIR / f"lib{name}_{_digest()}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source}:\n{log}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    BUILD_LOG[name] = (seconds, log)
    return lib


def load_many(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """The compiled libraries of `csrc/<name>.cu` for each name; missing
    ones are built in parallel, one nvcc process per source."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if n not in _libs]
        if todo:
            with ThreadPoolExecutor(max_workers=len(todo)) as pool:
                for name, lib in zip(todo, pool.map(_build_and_open, todo)):
                    _libs[name] = lib
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The compiled library of `csrc/<name>.cu`, built on first use."""
    return load_many([name])[name]


def load_source(source: Path, tag: str) -> ctypes.CDLL:
    """A library built from a source outside `csrc/` (an earlier version
    of a kernel, which a bench times beside the current one) with the same
    flags, into `build/kernels/lib<tag>_<hash of the source>.so`."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{tag}_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:"
                               f"\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every source under `csrc/`."""
    return load_many(sorted(f.stem for f in CSRC.glob("*.cu")))
