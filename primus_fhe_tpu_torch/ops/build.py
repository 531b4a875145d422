"""Builds the CUDA kernels of ``csrc/`` at first use and binds them with ctypes.

Each source compiles with its own ``nvcc`` for ``sm_90a``, all of them at
once, and one more ``nvcc`` links the objects into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).
The library lands in ``primus_fhe_tpu_torch/build/`` under a name derived
from a hash of the sources and flags, so an edited source never loads a
stale build.  Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("ntt32.cu", "cmux_fused.cu", "cmux_mxu.cu", "ntt_mxu8.cu", "ntt64.cu", "cmux_front.cu",
           "ntt_stages.cu", "ntt_mxu8_split.cu", "cmux_stage2.cu", "ntru_stage.cu",
           "ntt_columns.cu")
HEADERS = ("modarith32.cuh", "modarith64.cuh", "mxu8.cuh", "mxu8_64.cuh", "ntt_passes.cuh",
           "ntt_split.cuh", "ntt_columns.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_int64
# C entry -> argument types (pointers, host constant packs and the stream
# are c_void_p; sizes are c_int; a u64 modulus is c_uint64; a row stride
# in words is c_int64)
_SIGNATURES = {
    "pft_ntt32_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pft_ntt32_inverse": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pft_ntt32_tile": (_I, _I, _I, _I, _P),
    "pft_cmux_step": (_P, _P, _P, _P, _I, _P, _P),
    "pft_cmux_stage2": (_P, _P, _P, _P, _I, _P, _P),
    "pft_cmux_stage2_grid": (_I, _I, _I, _I, _P),
    "pft_cmux_stage2_cols": (_P, _P, _P, _I, _P, _P),
    "pft_ntt_columns": (_I, _I, _I) + (_P,) * 5 + (_I,) * 4 + (_P,),
    "pft_mac_sub": (_P,) * 5,
    "pft_ntru_finish": (_P,) * 5 + (_I, _P, _P),
    "pft_cmux_mxu": (_P,) * 13 + (_I,) * 6 + (_P,),
    "pft_ntru_cmux_mxu": (_P,) * 12 + (_I,) * 4 + (_P,),
    "pft_cmux_mxu_clusters": (_I,) * 7 + (_P,),
    "pft_ntru_digits": (_P, _P, _P, _I64, _P),
    "pft_ntru_stage2": (_P,) * 6 + (_I, _P, _P),
    "pft_ntru_stage2_grid": (_I, _I, _P),
    "pft_mxu8_forward32": (_P,) * 5 + (_I,) * 3 + (_P,),
    "pft_mxu8_forward32_grid": (_I, _I, _I, _P, _P),
    "pft_ntt64_forward": (_P,) * 5 + (_I,) * 4 + (_P,),
    "pft_ntt64_inverse": (_P,) * 5 + (_I,) * 5 + (_P,),
    "pft_ntt64_tile": (_I, _I, _I, _I, _P),
    "pft_ntt64_roundtrip_mul": (_P,) * 8 + (_I,) * 3 + (_P,),
    "pft_ntt64_forward_any": (_P,) * 5 + (_I,) * 3 + (_P,),
    "pft_ntt64_inverse_mul": (_P,) * 6 + (_I,) * 3 + (_P,),
    "pft_ntt_mxu8_forward64": (_P,) * 6 + (_I,) * 4 + (_P,),
    "pft_ntt_mxu8_inverse64": (_P,) * 6 + (_I,) * 4 + (_P,),
    "pft_ntt_mxu8_inverse64_mul": (_P,) * 7 + (_I,) * 4 + (_P,),
    "pft_rotate": (_P, _I64, _P, _P, _I64, _I, _I, _I, _I, _P),
    "pft_rotate_max_log_n": (),
    "pft_cmux_front": (_P,) * 5 + (_I,) * 4 + (_P,),
    "pft_cmux_front_grid": (_I,) * 3 + (_P,),
    "pft_ntt32_stages_forward": (_P,) * 4 + (_I,) * 4 + (_P,),
    "pft_ntt32_stages_inverse": (_P,) * 4 + (_I,) * 3 + (_P,),
    "pft_ntt64_stages_forward": (_P,) * 4 + (_U64,) + (_I,) * 3 + (_P,),
    "pft_ntt64_stages_inverse": (_P,) * 4 + (_U64,) + (_I,) * 3 + (_P,),
    "pft_ntt32_stages_grid": (_I, _I, _I, _I, _P, _P),
    "pft_ntt64_stages_grid": (_I, _U64, _I, _I, _P, _P),
    "pft_ntt_mxu8_split_k1": (_P,) * 5 + (_I,) * 6 + (_P,),
    "pft_ntt_mxu8_split_k2": (_P,) * 5 + (_I,) * 4 + (_P,),
    "pft_ntt_mxu8_split_ki1": (_P,) * 6 + (_I,) * 6 + (_P,),
    "pft_ntt_mxu8_split_ki2": (_P,) * 5 + (_I,) * 4 + (_P,),
}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compiles the library if it is missing; returns (path, seconds, log).

    One ``nvcc -c`` per source, all started together, then one link."""
    so = BUILD_DIR / f"libpft_kernels_{_digest()}.so"
    log_path = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}_{so.stem}"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs, procs = [], []
    for s in SOURCES:
        obj = BUILD_DIR / f"{tag}_{Path(s).stem}.o"
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(CSRC / s)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs, failed = [], []
    for s, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {s}\n{out}")
        if proc.returncode != 0:
            failed.append(s)
    tmp = BUILD_DIR / f"{tag}.so"
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return so, seconds, log


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.pft_error_string.argtypes = [ctypes.c_int]
    lib.pft_error_string.restype = ctypes.c_char_p
    lib.pft_ntt_columns_taken.argtypes = [ctypes.c_int]
    lib.pft_ntt_columns_taken.restype = ctypes.c_uint64
    return lib


def check(err: int, what: str) -> None:
    """Raises if a C entry reported a CUDA error."""
    if err != 0:
        msg = library().pft_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptxas_figures(log: str) -> dict:
    """``{kernel: {"registers", "stack", "spill_stores", "spill_loads"}}``
    (bytes but for the registers) of each entry function in a build log's
    ``ptxas -v`` lines, under its mangled name."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                            r"spill loads", line):
            out[name].update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        elif m := re.search(r"Used (\d+) registers", line):
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def ptr(t) -> int:
    """Device pointer of a tensor, or host pointer of a numpy array."""
    return t.data_ptr() if hasattr(t, "data_ptr") else t.ctypes.data
