"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together (each one's
seconds reported), and linked
into one shared library with a plain C interface, loaded with
``ctypes``.  The build happens at first use, into
``build/repro_torch_kernels/`` at the root of the checkout, and the
library is named after a hash of the sources and flags, so an edit to a
source rebuilds it.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-c")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under CUDA_HOME)")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(src: Path, obj: Path):
    """One nvcc of ``src`` into ``obj``: (return code, output, seconds)."""
    t0 = time.perf_counter()
    p = subprocess.run([_nvcc(), *COMPILE_FLAGS, "-o", str(obj), str(src)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    return p.returncode, p.stdout, time.perf_counter() - t0


def build() -> dict:
    """Compile the kernels if the library for these sources is missing.
    Returns {"path", "seconds", "built", "log", "source_seconds"} (``log``
    holds nvcc's register / shared-memory report when it built;
    ``source_seconds`` each source's nvcc wall seconds, all started
    together, the longest first)."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "built": False, "log": "",
                "source_seconds": {}}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{os.getpid()}.tmp"
    objs = [path.with_name(f"{f.stem}.{tag}.o") for f in cu]
    tmp = path.with_suffix(f".{tag}")
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(cu)) as pool:
            results = list(pool.map(_compile, cu, objs))
        failed = [(f.name, log) for f, (rc, log, _) in zip(cu, results)
                  if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name}:\n{log}" for name, log in failed))
        link = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n"
                               f"{link.stderr}")
        os.replace(tmp, path)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    seconds = sorted(((f.name, s) for f, (_, _, s) in zip(cu, results)),
                     key=lambda x: -x[1])
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "built": True, "log": "".join(log for _, log, _ in results),
            "source_seconds": dict(seconds)}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its entry
    points (every pointer and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(build()["path"])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode_attention_launch.argtypes = (
        [P] * 9 + [I] * 10 + [F, F, I, P])
    lib.paged_decode_attention_launch.restype = I
    lib.paged_packed_attention_launch.argtypes = (
        [P] * 10 + [I] * 10 + [F, F, I, P])
    lib.paged_packed_attention_launch.restype = I
    lib.paged_attention_smem_bytes.argtypes = [I, I, I]
    lib.paged_attention_smem_bytes.restype = ctypes.c_long
    lib.paged_decode_attention_q8_launch.argtypes = (
        [P] * 11 + [I] * 10 + [F, F, I, P])
    lib.paged_decode_attention_q8_launch.restype = I
    lib.paged_packed_attention_q8_launch.argtypes = (
        [P] * 12 + [I] * 10 + [F, F, I, P])
    lib.paged_packed_attention_q8_launch.restype = I
    lib.paged_mixed_attention_launch.argtypes = (
        [P] * 9 + [I] * 11 + [F, F, I, P])
    lib.paged_mixed_attention_launch.restype = I
    lib.paged_mixed_attention_q8_launch.argtypes = (
        [P] * 11 + [I] * 11 + [F, F, I, P])
    lib.paged_mixed_attention_q8_launch.restype = I
    lib.flash_attention_launch.argtypes = [P] * 7 + [I] * 8 + [F, F, I, P]
    lib.flash_attention_launch.restype = I
    lib.flash_attention_bwd_launch.argtypes = ([P] * 12 + [I] * 8
                                               + [F, F] + [I] * 7 + [P, P])
    lib.flash_attention_bwd_launch.restype = I
    lib.flash_attention_bwd_kernel_attrs.argtypes = [
        I, ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_bwd_kernel_attrs.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.quant_matmul_launch.argtypes = [P] * 6 + [I] * 7 + [P]
    lib.quant_matmul_launch.restype = I
    lib.decode_attention_launch.argtypes = [P] * 6 + [I] * 7 + [F, F, I, P]
    lib.decode_attention_launch.restype = I
    lib.mlstm_chunk_launch.argtypes = [P] * 12 + [I] * 7 + [P]
    lib.mlstm_chunk_launch.restype = I
    lib.mlstm_chunk_states_launch.argtypes = [P] * 15 + [I] * 7 + [P]
    lib.mlstm_chunk_states_launch.restype = I
    lib.mlstm_chunk_bwd_launch.argtypes = [P] * 23 + [I] * 11 + [P]
    lib.mlstm_chunk_bwd_launch.restype = I
    lib.mlstm_chunk_bwd_smem_bytes.argtypes = [I, I, I]
    lib.mlstm_chunk_bwd_smem_bytes.restype = ctypes.c_long
    lib.mlstm_chunk_bwd_kernel_attrs.argtypes = [
        I, ctypes.POINTER(ctypes.c_int)]
    lib.mlstm_chunk_bwd_kernel_attrs.restype = ctypes.c_char_p
    lib.mlstm_chunk_smem_bytes.argtypes = [I, I, I, I]
    lib.mlstm_chunk_smem_bytes.restype = ctypes.c_long
    lib.rmsnorm_launch.argtypes = ([P] * 3 + [I, I, ctypes.c_long, I, F]
                                   + [I] * 4 + [P])
    lib.rmsnorm_launch.restype = I
    lib.ragged_matmul_launch.argtypes = [P] * 4 + [I] * 9 + [P]
    lib.ragged_matmul_launch.restype = I
    lib.ragged_matmul_dw_launch.argtypes = [P] * 4 + [I] * 9 + [P]
    lib.ragged_matmul_dw_launch.restype = I
    lib.dense_decode_mma_launch.argtypes = ([P] * 8 + [I] * 9
                                            + [F, F, I, P])
    lib.dense_decode_mma_launch.restype = I
    return lib
