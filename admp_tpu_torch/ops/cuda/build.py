"""Build and load the port's CUDA kernels.

Each source in ``admp_tpu_torch/csrc`` is compiled by ``nvcc`` into a shared
library with a plain C interface, at first use, into
``admp_tpu_torch/_build/`` under a name keyed by a hash of the source, the
headers beside it (``csrc/*.cuh``) and the flags, and loaded with
``ctypes``. Nothing is built when a module is
imported, so the package imports on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source: frames.cu rounds each product and sum on its own, as
# the plain chain's elementwise ops do, so that its forward is that chain's
# bit for bit
SOURCE_FLAGS = {"frames": ("--fmad=false",)}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of admp_tpu_torch are built "
            "with the CUDA toolkit on the machine that has the card"
        )
    return found


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers
                         + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp_path, final_path) or
    None when the library already exists."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=("pairs", "pair_hvp", "pair_third", "spread", "spread_tiled",
                 "frames")) -> dict[str, str]:
    """Compile the named sources concurrently (skipping those already built)
    and return the compiler output of each build that ran (``-Xptxas -v``
    lists every kernel's registers, shared memory and spills). Raises on a
    failed build."""
    jobs = {n: _start_build(n) for n in names}
    logs = {}
    for name, job in jobs.items():
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def check(status: int, what: str):
    """Raise if a C entry point returned a nonzero cudaError_t (or -1 for an
    unsupported template combination)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed (status {status})")
