"""Build the CUDA sources in ``csrc/`` into one shared library and load it.

``nvcc`` compiles each ``csrc/*.cu`` into an object (one process per
source, all started together), links them into a shared library with a
plain C interface, and ``ctypes`` loads it.
Nothing includes PyTorch's headers, so a build takes seconds.  The build
happens at first use, never at import, into ``_build/<hash>/`` beside the
package, where the hash covers the sources and the flags; ``.gitignore``
lists that directory.  ``nvcc -Xptxas -v`` output (registers, shared
memory, spills per kernel) is kept beside the library as ``ptxas.txt``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

__all__ = ["library", "ptxas_report", "check", "CSRC", "NVCC_FLAGS"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("histogram.cu", "split_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "udt_histogram": ([_P, _P, _P, _P, _P, _I, _P, _LL, _I, _I, _I, _I, _P], _I),
    "udt_sibling_epilogue": ([_P, _P, _P, _P, _LL, _LL, _P], _I),
    "udt_split_scan": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P], _I),
    "udt_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: pathlib.Path) -> pathlib.Path:
    """Compile every source in parallel, link, and move the library into
    ``out_dir`` atomically (a concurrent builder of the same hash loses
    nothing: both produce the same file)."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = pathlib.Path(tmp)
        procs = []
        for src in SOURCES:
            obj = tmp / (src + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [f"== {src}\n{proc.communicate()[0]}" for src, _, proc in procs]
        for (src, _, proc), log in zip(procs, logs):
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        lib = tmp / "libudt_kernels.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "ptxas.txt").write_text("\n".join(logs))
        os.replace(tmp / "ptxas.txt", out_dir / "ptxas.txt")
        os.replace(lib, out_dir / "libudt_kernels.so")
    return out_dir / "libudt_kernels.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _digest()
            path = out_dir / "libudt_kernels.so"
            if not path.exists():
                path = _compile(out_dir)
            lib = ctypes.CDLL(str(path))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def ptxas_report() -> str:
    """``nvcc -Xptxas -v`` lines of the current build (builds if needed)."""
    library()
    return (BUILD_ROOT / _digest() / "ptxas.txt").read_text()


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code:
        msg = library().udt_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} "
                           f"({msg})")
