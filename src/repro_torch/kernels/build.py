"""Build and bind the CUDA kernels of ``kernels/csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/kernels/lib<name>.so`` at the repo root (listed in
``.gitignore``), loaded with ``ctypes``.  Nothing builds at import time:
the first launch of a kernel builds its library, and :func:`build_all`
compiles every source at once with one ``nvcc`` process per source.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside each library as ``<name>.log``.  The sources with a Hopper
(TMA) kernel — ``flash_attention``, ``maxsim_top2``, ``maxsim_topk`` and
``colbert_maxsim`` — also link the CUDA driver library (``-lcuda``,
through the toolkit's stub directory where it has one): their host side
encodes TMA tensor maps with ``cuTensorMapEncodeTiled``, a driver-API
call.  A source is stale when it or any shared header (``*.cuh``) is
newer than its library.

Every C entry launches on the calling thread's current device and
returns ``cudaGetLastError()`` after its launch; the wrappers call it
through :func:`launch`, which makes the tensors' card current around
the call, and :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("maxsim_top2", "maxsim_topk", "colbert_maxsim",
           "flash_attention", "embedding_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DRIVER_API = ("flash_attention", "maxsim_top2", "maxsim_topk",
              "colbert_maxsim")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p, ints as c_int
# (c_longlong where the C side takes a long long), floats as c_float.
SIGNATURES = {
    "maxsim_top2": {"maxsim_top2_launch": [_P, _P, _P, _I, _I, _I, _I,
                                           _P, _P, _P, _P, _P, _P, _P, _P,
                                           _P]},
    "maxsim_topk": {"maxsim_topk_launch": [_P, _P, _P, _I, _I, _I, _I, _I,
                                           _P, _P, _P, _P, _P, _P, _P]},
    "colbert_maxsim": {
        "colbert_maxsim_multi_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _P, _P, _P, _P, _P, _P],
        "colbert_maxsim_rerank_launch": [_P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _P, _P, _P, _P],
        "colbert_maxsim_residual_multi_launch": [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
            _P, _P],
        "colbert_maxsim_residual_rerank_launch": [
            _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
            _P, _P, _P, _P],
        "colbert_maxsim_split_planes": [_P, _I, _I, _I, _P, _P, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _P],
        "flash_attention_sm90_smem": [_I]},
    "embedding_bag": {
        "embedding_bag_launch": [_P, _P, _L, _I, _I, _I, _I, _P, _P]},
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _driver_link(nvcc: str) -> list[str]:
    """``-lcuda``, after ``-L`` for the toolkit's stub libcuda where it has
    one (the library loaded at run time is the driver's own)."""
    root = Path(nvcc).resolve().parents[1]
    stubs = [root / "lib64" / "stubs",
             root / "targets" / "x86_64-linux" / "lib" / "stubs"]
    return [f"-L{p}" for p in stubs if p.is_dir()] + ["-lcuda"]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return out.stat().st_mtime < newest


def build_all(names=SOURCES, *, force: bool = False) -> float:
    """Compile every stale source (all of ``names`` with ``force``), one
    ``nvcc`` process per source, all started together.  Returns the
    wall seconds spent; raises with nvcc's output on a failure."""
    todo = [n for n in names if force or _stale(n)]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu"),
               *(_driver_link(nvcc) if n in DRIVER_API else [])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        (BUILD_DIR / f"{n}.log").write_text(log)
        if p.returncode:
            failed.append(f"--- {n} (nvcc exit {p.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def _kernel_name(mangled: str) -> str:
    """``ns::kernel<arg>`` from an Itanium-mangled nested name, without
    the anonymous namespace."""
    m = re.match(r"_ZN(.*)", mangled)
    if not m:
        return mangled
    rest, parts = m.group(1), []
    while (n := re.match(r"\d+", rest)):
        size, rest = int(n.group()), rest[n.end():]
        ident, rest = rest[:size], rest[size:]
        if not ident.startswith("_GLOBAL__N"):
            parts.append(ident)
    args = re.match(r"I((?:Li\d+E|Lb[01]E|f)+)E", rest)
    if not args:
        return "::".join(parts)
    vals = [n or ("float" if not b else ("false", "true")[int(b)])
            for n, b in re.findall(r"Li(\d+)E|Lb([01])E|f", args.group(1))]
    return "::".join(parts) + f"<{', '.join(vals)}>"


def ptxas_report(name: str) -> str:
    """Each kernel's registers, stack and spills from ``nvcc -Xptxas -v``
    (``<name>.log``), one ``kernel: ...`` clause each."""
    out, entry, frame = [], None, ""
    for line in (BUILD_DIR / f"{name}.log").read_text().splitlines():
        if (m := re.search(r"Compiling entry function '(\S+)'", line)):
            entry, frame = _kernel_name(m.group(1)), ""
        elif "stack frame" in line:
            frame = line.strip()
        elif entry and (m := re.search(r"Used \d+ registers.*", line)):
            out.append(f"{entry}: {m.group(0).strip()}; {frame}")
            entry = None
    return " | ".join(out)


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err:
        msg = getattr(library(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def launch(name: str, entry: str, device, *args) -> None:
    """Call C entry ``entry`` of ``name``'s library with ``args`` (the
    last one ``stream_ptr`` of a tensor on ``device``) with ``device``
    current: the launch, its ``cudaFuncSetAttribute`` and the entry's
    ``sm_count()`` all act on the current device, which must be the
    tensors' card.  Raises on a reported CUDA error."""
    lib = library(name)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args)
    check(name, err)


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` — the kernels index raw pointers."""
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd records and an input requires grad: no kernel
    of the port has a backward (the reference's Pallas kernels have
    none either), so a launch would return an output that carries no
    gradient back, and training would silently stop updating what fed
    it.  The plain path (``backend="reference"``) is differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: an input requires grad, and the kernel has no "
            f"backward; differentiate through the plain path "
            f"(backend='reference') or call it under torch.no_grad()")
