"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use into ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``); the library's file name carries a digest of the
sources and flags, so an edited source is never served a stale build.

Nothing here runs at import time: importing the port on a machine
without ``nvcc`` or a card is fine, and only a kernel launch builds.
Builds take a file lock in the build directory, so the ranks of a mesh
that reach their first launch together run ``nvcc`` once between them
(the others wait, then load the finished library).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_vp, _i32, _i64, _u64, _f32 = (ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_ulonglong,
                               ctypes.c_float)
#: C entry points and their argument types (every pointer and the stream
#: are ``c_void_p``; each function returns ``cudaGetLastError()``)
SIGNATURES = {
    # x, out, n, k, device, stream
    "mapsdi_rowhash": [_vp, _vp, _i64, _i32, _i32, _vp],
    # rows, hash, keep, collide, n, k, device, stream
    "mapsdi_hash_neighbor_flags": [_vp, _vp, _vp, _vp, _i64, _i32, _i32,
                                   _vp],
    # data, count, n, k, n_buckets, cap_bucket, shift, n_key, key_lo,
    # key_hi, tile_rows, staged, scratch, scratch_bytes, out, counts,
    # overflow, device, stream
    "mapsdi_radix_partition": [_vp, _vp] + [_i32] * 6 + [_u64, _u64, _i32,
                               _i32, _vp, _i64, _vp, _vp, _vp, _i32, _vp],
    # r, k, v, w, u, s0, y, s_out, work, work_bytes, b, h, t, n, chunk,
    # seg_chunks, dtype, device, stream
    "mapsdi_rwkv6": [_vp] * 9 + [_i64] + [_i32] * 8 + [_vp],
    # xdt, la, b, c, s0, y, s_out, work, work_bytes, b, h, t, p, n, chunk,
    # seg_chunks, dtype, device, stream
    "mapsdi_mamba2_ssd": [_vp] * 8 + [_i64] + [_i32] * 9 + [_vp],
    # q, k, v, o, b, h, kh, sq, sk, d, kv_len, causal, window, scale,
    # block_q, block_k, dtype, device, stream
    "mapsdi_flash_attention": [_vp] * 4 + [_i32] * 9 + [_f32] + [_i32] * 4
                              + [_vp],
}

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when an existing library was loaded)
last_build_seconds = 0.0


def _digest() -> str:
    h = hashlib.sha1(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def compile_command(src: Path, obj: Path, *extra: str) -> List[str]:
    """The ``nvcc`` command that compiles one source into ``obj`` (``extra``
    flags go before the source, e.g. ``-Xptxas -v``)."""
    return [_nvcc(), *ARCH_FLAGS, *CFLAGS, *extra, "-I", str(CSRC), "-c",
            str(src), "-o", str(obj)]


def sources() -> List[Path]:
    """The CUDA sources the library is built from."""
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global last_build_seconds
    lib_path = BUILD_DIR / f"libmapsdi_kernels_{_digest()}.so"
    if lib_path.exists():
        last_build_seconds = 0.0
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if lib_path.exists():              # another process built it
            last_build_seconds = time.perf_counter() - t0
            return lib_path
        _compile(nvcc, lib_path)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def _compile(nvcc: str, lib_path: Path) -> None:
    """Compile every source (one ``nvcc`` each, all started together) and
    link them into ``lib_path``."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = compile_command(src, obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                *map(str, objs)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n"
                               f"{res.stdout}")
        os.replace(tmp_lib, lib_path)   # atomic: readers never see half


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
