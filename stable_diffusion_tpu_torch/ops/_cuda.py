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
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("groupnorm.cu", "conv3x3.cu", "attention.cu", "attention_bwd.cu", "ffn.cu",
            "conv3x3_q.cu", "linear_q.cu", "ffn_q.cu", "linear.cu", "winograd.cu")
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
    lib.sdtk_conv3x3.argtypes = [P] * 6 + [I] * 11 + [P]
    lib.sdtk_attention.argtypes = [P, P, P, P, P, L, L, L, L, L, L, I, I, I, I, I, I, F] + [I] * 5 + [P, P]
    lib.sdtk_attention_bwd_dq.argtypes = [P] * 8 + [L] * 10 + [I] * 4 + [F] + [I] * 3 + [P]
    lib.sdtk_attention_bwd_dkv.argtypes = [P] * 8 + [L] * 8 + [I] * 4 + [F] + [I] * 3 + [P]
    IP = ctypes.POINTER(ctypes.c_int)
    lib.sdtk_gn_plan.argtypes = [I] * 6 + [IP]
    lib.sdtk_gn_stats.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_gn_apply.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_gn_attrs.argtypes = [I, I, IP]
    lib.sdtk_gn_bwd.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_gn_bwd_attrs.argtypes = [I, I, I, IP]
    lib.sdtk_conv3x3_attrs.argtypes = [I, I, I, I, IP]
    lib.sdtk_attention_bwd_attrs.argtypes = [I] * 5 + [IP]
    lib.sdtk_attention_attrs.argtypes = [I] * 5 + [IP]
    lib.sdtk_ffn.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_ffn_attrs.argtypes = [I] * 6 + [IP]
    lib.sdtk_conv3x3_q.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_conv3x3_q_attrs.argtypes = [I] * 4 + [IP]
    lib.sdtk_linear_q.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_linear_q_attrs.argtypes = [I] * 5 + [IP]
    lib.sdtk_q_rows.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_ffn_q.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_ffn_q_attrs.argtypes = [I] * 6 + [IP]
    lib.sdtk_linear.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_linear_attrs.argtypes = [I] * 6 + [IP]
    lib.sdtk_winograd.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sdtk_winograd_attrs.argtypes = [IP]
    for fn in (lib.sdtk_gn_plan, lib.sdtk_gn_stats, lib.sdtk_gn_apply, lib.sdtk_gn_attrs,
               lib.sdtk_gn_bwd, lib.sdtk_gn_bwd_attrs,
               lib.sdtk_conv3x3, lib.sdtk_conv3x3_attrs, lib.sdtk_attention,
               lib.sdtk_attention_bwd_dq, lib.sdtk_attention_bwd_dkv,
               lib.sdtk_attention_bwd_attrs, lib.sdtk_attention_attrs, lib.sdtk_ffn,
               lib.sdtk_ffn_attrs,
               lib.sdtk_conv3x3_q, lib.sdtk_conv3x3_q_attrs, lib.sdtk_linear_q,
               lib.sdtk_linear_q_attrs, lib.sdtk_q_rows,
               lib.sdtk_ffn_q, lib.sdtk_ffn_q_attrs, lib.sdtk_linear,
               lib.sdtk_linear_attrs,
               lib.sdtk_winograd, lib.sdtk_winograd_attrs):
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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (the kernels' planners size their
    grids by it)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_handle(x) -> int:
    """The current CUDA stream of ``x``'s device, as an integer handle."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:  # a PyTorch without the raw accessor
        return torch.cuda.current_stream(x.device).cuda_stream
    return raw(x.get_device())


class _Packed(threading.local):
    """A per-thread argument block for the entries that take their
    arguments packed (one ctypes argument in place of ~18: the launch's host
    cost is what K1's small shapes pay)."""

    def __init__(self):
        self.buf = (ctypes.c_int64 * 32)()


_PACKED = _Packed()


def call_packed(fn, *args) -> int:
    """``fn`` (a C entry taking ``const int64_t*``) on ``args``: pointers
    (None for null) and integers, each one int64."""
    buf = _PACKED.buf
    buf[:len(args)] = [0 if a is None else a for a in args]
    return fn(buf)


@functools.lru_cache(maxsize=None)
def f32_bits(v: float) -> int:
    """The bit pattern of ``v`` as an f32, for a packed argument."""
    return struct.unpack("<i", struct.pack("<f", v))[0]
