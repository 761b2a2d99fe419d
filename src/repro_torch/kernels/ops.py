"""Device selection, kernel build and launch plumbing (the port's ``ops``
layer; the reference's counterpart is ``use_pallas`` in
``repro/kernels/ops.py``).

The port runs on one CUDA device unless the caller asks for the CPU:

  set_device("cuda" | "cpu")   choose where operands live (default cuda)
  device()                     the chosen name
  target()                     the torch.device operands go to; raises
                               RuntimeError when "cuda" is chosen and no
                               card is present (nothing falls back)

Every kernel wrapper dispatches on the device of the tensors it is handed:
a CUDA tensor launches the hand-written kernel (or raises), a CPU tensor
runs the kernel's plain PyTorch version.  The kernels are CUDA C++ for
``sm_90a`` under ``csrc/``, compiled at first use with ``nvcc`` into one
shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``build/repro_torch_kernels/<hash>/`` at the repository
root, keyed by a hash of the sources and flags, so a checkout builds once.
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
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["set_device", "device", "target", "build", "lib", "check",
           "stream", "stream_key", "stream_lock", "count", "BUILD_DIR",
           "NVCC_FLAGS"]

_DEVICE = ["cuda"]


def set_device(name: str) -> None:
    """Select where the port's operands live: ``"cuda"`` (the default)
    or ``"cpu"`` (the kernels' plain versions)."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {name!r}")
    _DEVICE[0] = name


def device() -> str:
    return _DEVICE[0]


def target() -> torch.device:
    """The torch.device kernel operands are placed on."""
    if _DEVICE[0] == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; call repro_torch.set_device('cpu') to run the "
            "kernels' plain versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


# ---------------------------------------------------------------------------
# build: nvcc -> one .so with extern "C" launchers, loaded via ctypes
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LIB: List[Optional[ctypes.CDLL]] = [None]
_LOCK = threading.Lock()
BUILD_SECONDS: List[float] = [0.0]
BUILD_LOG: List[str] = []          # nvcc / ptxas output of the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                       "repro_torch CUDA kernels cannot be built")


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc per source, all started
    together, with ``-Xptxas -v`` so registers and spills land in
    ``BUILD_LOG``) and link them into one shared library.  Returns its
    path; a library already built from the same sources is reused."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    so = out_dir / "librepro_torch_kernels.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I",
                               str(CSRC), "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    errors = []
    BUILD_LOG.clear()
    for s, p in zip(srcs, procs):
        log, _ = p.communicate()
        BUILD_LOG.append(f"{s.name}:\n{log}")
        if p.returncode != 0:
            errors.append(f"{s.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out_dir / f"lib.{tag}.so"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, so)
    for o in objs:
        o.unlink()
    BUILD_SECONDS[0] = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    with _LOCK:
        if _LIB[0] is None:
            cdll = ctypes.CDLL(str(build()))
            cdll.rt_error_string.restype = ctypes.c_char_p
            cdll.rt_error_string.argtypes = [ctypes.c_int]
            _LIB[0] = cdll
        return _LIB[0]


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib().rt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc}: {msg}")


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# threads: every thread launches on PyTorch's one current stream
# ---------------------------------------------------------------------------

def stream_key(dev: torch.device) -> Tuple[int, int]:
    """(device index, current stream handle): the key of the scratch the
    wrappers pool per device and stream."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(dev).cuda_stream


_STREAM_LOCKS: Dict[Tuple[int, int], threading.Lock] = {}
_STATE_LOCK = threading.Lock()


def stream_lock(dev: torch.device) -> threading.Lock:
    """The lock of ``dev``'s current stream.  A C call whose launches hand
    pooled device state from one kernel to the next (A6: the scatter's
    stamped flags, read by its second pass) holds it from taking that
    state through the call, so no other thread's call of the same kind
    lands between its launches.  ctypes releases the GIL during a call,
    so without it two threads' launches interleave on the one stream."""
    key = stream_key(dev)
    lk = _STREAM_LOCKS.get(key)
    if lk is None:
        with _STATE_LOCK:
            lk = _STREAM_LOCKS.setdefault(key, threading.Lock())
    return lk


def count(fn: Any, attr: str = "launches", k: int = 1) -> None:
    """Add ``k`` to a wrapper's counter (``fn.launches`` and the like)
    under one lock, so increments from concurrent threads are not
    lost."""
    with _STATE_LOCK:
        setattr(fn, attr, getattr(fn, attr) + k)
