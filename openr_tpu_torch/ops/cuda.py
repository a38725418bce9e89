"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in ``openr_tpu_torch/csrc/*.cu``, each with a plain C
interface. On first use every source is compiled for ``sm_90a`` by its
own ``nvcc`` process, all started together, into a shared library under
``openr_tpu_torch/_build/`` named by the hash of its source, the shared
``csrc/*.cuh`` headers and the flags (so an edited source rebuilds and
an unchanged one loads at once). The libraries are bound with
``ctypes``. ``launch`` takes the tensors themselves, each under a
letter that names its dtype, and in one pass
checks each, reads its pointer and its card, and runs the kernel under
that card's guard on PyTorch's current stream there, so a shard on
``cuda:1`` is ordered with the torch work on its own tensors.

For kernels of a few microseconds the launch path is the host's cost
(``chip_smoke.py`` phase 7 splits it): the checks are one pass over the
tensor arguments, and the card's raw stream is read once from
PyTorch's C bindings.

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
import weakref
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


class _Last(threading.local):
    """The card of this thread's last launch (-1: none yet)."""

    card = -1


_last = _Last()
# the letters of a tensor argument and the dtype each holds
_INT32 = torch.int32
_DTYPES = {"t": _INT32, "T": torch.float32, "b": torch.bool,
           "l": torch.int64}
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple, object] = {}
_CTYPES = {"p": ctypes.c_void_p, "a": ctypes.c_void_p, "i": ctypes.c_int,
           "L": ctypes.c_longlong, "f": ctypes.c_float,
           **{c: ctypes.c_void_p for c in _DTYPES}}


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
    # the shared headers too: an edited header rebuilds every library
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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


def _fn(lib: str, fn: str, sig: str) -> tuple:
    f = getattr(_lib(lib), fn)
    f.argtypes = [_CTYPES[c] for c in sig] + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    # (position, dtype) of each tensor argument; None for a sequence
    _fns[lib, fn, sig] = out = (f, tuple(
        (i, _DTYPES.get(c)) for i, c in enumerate(sig)
        if c == "a" or c in _DTYPES))
    return out


def _bad(lib: str, fn: str, t, dtype) -> ValueError:
    return ValueError(f"{lib}.{fn}: expected a contiguous {dtype} CUDA "
                      f"tensor, got {t.dtype} on {t.device}")


# the packed pointer arrays of the sequences passed under "a", by the ids
# of their tensors: a sequence of the same live tensors at the same
# addresses (a relaxation loop's ping-pong buffers) is checked and packed
# once
_packed: dict = {}
_PACKED_MAX = 256


def _array(lib: str, fn: str, ts) -> tuple:
    """(C array of the pointers, card) of a sequence of int32 tensors."""
    key = tuple(map(id, ts))
    hit = _packed.get(key)
    if hit is not None:
        refs, ptrs, arr, card = hit
        for r, t, p in zip(refs, ts, ptrs):
            if r() is not t or t.data_ptr() != p:
                break
        else:
            return arr, card
    if not ts:
        raise ValueError(f"{lib}.{fn}: an empty sequence of tensors")
    cards = {t.get_device() for t in ts}
    for t in ts:
        if t.get_device() < 0 or t.dtype is not _INT32 \
                or not t.is_contiguous():
            raise _bad(lib, fn, t, _INT32)
    if len(cards) > 1:
        raise ValueError(f"{lib}.{fn}: arguments on cards {sorted(cards)}")
    ptrs = [t.data_ptr() for t in ts]
    arr = (ctypes.c_longlong * len(ts))(*ptrs)
    if len(_packed) >= _PACKED_MAX:
        _packed.clear()
    _packed[key] = ([weakref.ref(t) for t in ts], ptrs, arr, cards.pop())
    return arr, _packed[key][3]


def launch(lib: str, fn: str, sig: str, *args) -> None:
    """Call the C entry point ``fn`` of ``csrc/<lib>.cu`` with ``args``
    plus the current CUDA stream of the card the tensor arguments lie
    on, under that card's guard. ``sig`` has one letter per argument:
    ``t`` / ``T`` / ``b`` / ``l`` a contiguous CUDA tensor of int32 /
    float32 / bool / int64 or None (its pointer, or null), ``a`` a
    sequence of contiguous int32 CUDA tensors (a C array of their
    pointers), ``p`` a raw address, ``i`` int, ``L`` 64-bit int, ``f``
    float. Raises if a
    tensor argument is not as its letter says, if the tensors lie on two
    cards, or if the launch was refused. Without tensor arguments the
    card is this thread's last launch's, else the current one."""
    f, tpos = _fns.get((lib, fn, sig)) or _fn(lib, fn, sig)
    card = -1
    if tpos:
        args = list(args)
        for i, dtype in tpos:
            t = args[i]
            if t is None:
                args[i] = 0
                continue
            if dtype is None:
                args[i], k = _array(lib, fn, t)
            else:
                k = t.get_device()
                if k < 0 or t.dtype is not dtype or not t.is_contiguous():
                    raise _bad(lib, fn, t, dtype)
                args[i] = t.data_ptr()
            if k != card:
                if card >= 0:
                    raise ValueError(f"{lib}.{fn}: arguments on cards "
                                     f"{sorted((card, k))}")
                card = k
    cur = torch._C._cuda_getDevice()
    if card < 0:
        card = cur if _last.card < 0 else _last.card
    _last.card = card
    if card == cur:
        rc = f(*args, torch._C._cuda_getCurrentRawStream(cur))
    else:
        with torch.cuda.device(card):
            rc = f(*args, torch._C._cuda_getCurrentRawStream(card))
    if rc != 0:
        raise RuntimeError(f"CUDA launch {lib}.{fn} failed: error {rc}")
