"""Build the port's CUDA sources into one shared library and load it.

Every ``kernels/**/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), linked into one
``.so`` with a plain C interface, and loaded with ``ctypes``. Each wrapper
binds its entry points as :class:`Entry` objects. Pointers pass as
``c_void_p`` (``tensor.data_ptr()``), the current stream's raw handle last,
and every C entry point returns its ``cudaError_t`` (0 on success), which
:func:`check` turns into an exception.

The build happens at the first kernel launch, never at import (the CPU tests
import every module on a machine with no ``nvcc``), into ``build/`` at the
repository root. The library's file name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads as is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_sms: dict[int, int] = {}


def sources() -> list[Path]:
    """``kernels/csrc/*.cu`` (shared helpers) and ``kernels/<pkg>/csrc/*.cu``."""
    return sorted(KERNELS_DIR.glob("**/csrc/*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    for s in sorted(KERNELS_DIR.glob("**/csrc/*.cuh")):
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels-{_digest(sources())}.so"


def nvcc() -> str:
    """The toolkit's ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build from source at first use")
    return found


def compile_commands(out: Path) -> tuple[list, list]:
    """(one compile command per source, the link command)."""
    exe = nvcc()
    objs, compiles = [], []
    for src in sources():
        obj = out.with_name(f"{out.stem}.{src.stem}.o")
        objs.append(obj)
        compiles.append([exe, *NVCC_FLAGS, "-I", str(KERNELS_DIR / "csrc"),
                         "-c", str(src), "-o", str(obj)])
    link = [exe, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(out)]
    return compiles, link


def build() -> float:
    """Compile and link the library if it is missing; returns the seconds
    spent (0.0 when it was already built)."""
    path = library_path()
    if path.exists():
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.so")
    compiles, link = compile_commands(tmp)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in compiles]
    failed = []
    for cmd, p in zip(compiles, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: a process building alongside sees a whole file
    for obj in tmp.parent.glob(f"{tmp.stem}.*.o"):
        obj.unlink()
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class Entry:
    """A C entry point bound once, at its first launch (the library builds
    then), with its argument types declared (every entry point returns
    ``int``: the ``cudaError_t``, or what its comment in the source says),
    and launched on the current stream of the tensors' card; the device is
    switched only when it is not the current one."""

    __slots__ = ("name", "argtypes", "fn")

    def __init__(self, name: str, argtypes: list):
        self.name, self.argtypes, self.fn = name, argtypes, None

    def launch(self, dev: torch.device, *args) -> int:
        """``fn(*args, stream)``; returns what the entry point returns.
        Refuses any device but a CUDA one (meta tensors, which
        ``dispatch.counting`` routes to the CUDA wrappers, are counted by
        the countable ones and launch nothing)."""
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: launches on a CUDA device, got "
                             f"tensors on {dev}")
        fn = self.fn
        if fn is None:
            fn = getattr(library(), self.name)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self.fn = fn
        stream = torch._C._cuda_getCurrentRawStream
        if dev.index == torch.cuda.current_device():
            return fn(*args, stream(dev.index))
        with torch.cuda.device(dev):
            return fn(*args, stream(dev.index))


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors (read once a device)."""
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n
