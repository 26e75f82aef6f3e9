"""Build and bind the CUDA C++ kernels under ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds, not minutes).  The build happens at first use, from the
package's own sources, into ``build/torch_kernels/`` beside the package
(``SD_TORCH_BUILD_DIR`` overrides it); the file name carries a hash of the
sources, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("conv3x3.cu", "attention.cu", "ffn.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lib = None
build_seconds = None  # wall time of this process's build, None if loaded from disk


def build_dir() -> Path:
    env = os.environ.get("SD_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(ARCH.encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    tmp = out.parent / f"tmp_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", f"-I{CSRC}"]
    objs, procs = [], []
    try:
        for src in _SOURCES:
            obj = tmp / (src + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *flags, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                print(f"--- nvcc {src} ---\n{log}", file=sys.stderr)
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        so = tmp / out.name
        subprocess.run([nvcc, ARCH, "-shared", "-o", str(so), *map(str, objs)], check=True)
        os.replace(so, out)
    finally:
        for p in procs:
            if p[1].poll() is None:
                p[1].kill()
        shutil.rmtree(tmp, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.sdtk_conv3x3_ksplit.argtypes = [I, I, I, I, I]
    lib.sdtk_conv3x3.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.sdtk_attention.argtypes = [P, P, P, P, L, L, L, L, L, L, I, I, I, I, I, I, F, P]
    IP = ctypes.POINTER(ctypes.c_int)
    lib.sdtk_ffn_plan.argtypes = [I, I, IP, IP, IP]
    lib.sdtk_ffn.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P]
    for fn in (lib.sdtk_conv3x3_ksplit, lib.sdtk_conv3x3, lib.sdtk_attention,
               lib.sdtk_ffn_plan, lib.sdtk_ffn):
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The compiled kernel library, building it on first use."""
    global _lib, build_seconds
    if _lib is None:
        out = build_dir() / f"libsdtk_{_digest()}.so"
        if not out.exists():
            t0 = time.perf_counter()
            _compile(out)
            build_seconds = time.perf_counter() - t0
        _lib = _bind(ctypes.CDLL(str(out)))
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_handle(x) -> int:
    import torch

    return torch.cuda.current_stream(x.device).cuda_stream
