"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in ``openr_tpu_torch/csrc/*.cu``, each with a plain C
interface. On first use every source is compiled for ``sm_90a`` by its
own ``nvcc`` process, all started together, into a shared library under
``openr_tpu_torch/_build/`` named by the hash of its source and flags
(so an edited source rebuilds and an unchanged one loads at once). The
libraries are bound with ``ctypes``: pointers travel as
``tensor.data_ptr()``, the stream as PyTorch's current stream of the
card that holds the arguments (``ptr`` notes each argument's card, and
``launch`` runs under that card's guard, so a shard on ``cuda:1`` is
ordered with the torch work on its own tensors).

Nothing here runs at import time; a CPU-only process never touches
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("relax", "select", "compact", "incremental", "ucmp", "ksp2",
           "sweep", "te", "legacy", "fabric", "combine")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
# the cards of the pointers taken since the last launch, per thread
_seen = threading.local()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple, object] = {}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "L": ctypes.c_longlong,
           "f": ctypes.c_float}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no library for its current hash,
    one ``nvcc`` each, in parallel. Returns name -> library path. The
    compiler's report (registers, shared memory, spills from
    ``-Xptxas=-v``) lands beside each library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    nvcc = _nvcc()
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(str(p))
        return _libs[name]


def launch(lib: str, fn: str, sig: str, *args) -> None:
    """Call the C entry point ``fn`` of ``csrc/<lib>.cu`` with ``args``
    (``sig``: one letter per argument, ``p`` pointer, ``i`` int, ``L``
    64-bit int, ``f`` float) plus the current CUDA stream of the card
    the pointer arguments lie on, under that card's guard, and raise if
    the launch was refused or the arguments span cards."""
    key = (lib, fn)
    f = _fns.get(key)
    if f is None:
        f = getattr(_lib(lib), fn)
        f.argtypes = [_CTYPES[c] for c in sig] + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[key] = f
    cards = getattr(_seen, "cards", None) or set()
    _seen.cards = set()
    if len(cards) > 1:
        raise ValueError(f"{lib}.{fn}: arguments on cards {sorted(cards)}")
    cur = torch.cuda.current_device()
    dev = cards.pop() if cards else getattr(_seen, "last", cur)
    if dev == cur:
        rc = f(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = f(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch {lib}.{fn} failed: error {rc}")


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a contiguous CUDA tensor; notes its card for
    the next ``launch``."""
    if not t.is_cuda or not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous CUDA tensors")
    card = t.device.index
    cards = getattr(_seen, "cards", None)
    if cards is None:
        cards = _seen.cards = set()
    cards.add(card)
    _seen.last = card
    return t.data_ptr()
