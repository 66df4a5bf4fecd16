"""Build and load the hand-written CUDA kernels of ``xicsrt_tpu_torch/csrc``.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, not at import, into ``build/xicsrt_tpu_torch/<hash>/``
beside the package, keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into fused
multiply-adds, so the kernels round like their plain PyTorch twins.

Each ``.cu`` compiles in its own ``nvcc`` process, all started together,
then one link makes the library; ptxas's register and spill report of every
kernel is kept beside it in ``ptxas.log``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "xicsrt_tpu_torch")
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *GENCODE, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    "xrt_bin_images": [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong, _P,
    ],
    "xrt_bin_images_occupancy": [ctypes.c_longlong, ctypes.c_int],
    "xrt_fused_trace": [
        _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, _P, ctypes.c_uint, ctypes.c_uint, _P, _P,
        ctypes.c_int, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P,
    ],
    "xrt_fused_trace_marked": [
        _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, _P, ctypes.c_uint, ctypes.c_uint, _P, _P,
        ctypes.c_int, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, ctypes.c_int, _P,
    ],
    "xrt_fused_trace_flagged": [
        _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, _P, ctypes.c_uint, ctypes.c_uint, _P, _P,
        ctypes.c_int, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, ctypes.c_int, _P,
    ],
    "xrt_fused_trace_occupancy": [ctypes.c_int] * 10 + [_P],
    "xrt_head_floats_of": [ctypes.c_int] * 2,
    "xrt_fused_trace_build": [ctypes.c_int] * 5,
    "xrt_fused_trace_threads": [ctypes.c_int] * 3,
    "xrt_fused_trace_marked_occupancy": [ctypes.c_int] * 10 + [_P],
    "xrt_history_probe": [
        _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, _P, ctypes.c_uint, ctypes.c_uint, _P, _P,
        ctypes.c_int, ctypes.c_longlong, _P, ctypes.c_int, _P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P, _P, _P,
    ],
    "xrt_history_record": [
        _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, _P, ctypes.c_uint, ctypes.c_uint, _P, _P,
        ctypes.c_int, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
    ],
    "xrt_trace_only": [
        _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
        _P, _P, _P, _P, _P, _P, ctypes.c_uint, ctypes.c_uint, _P, _P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P,
    ],
    "xrt_bundle_gather": [_P, _P, ctypes.c_int, ctypes.c_longlong, _P, _P],
    "xrt_fused_grad_fwd": [
        _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, _P, ctypes.c_uint, ctypes.c_uint,
        _P, ctypes.c_int, ctypes.c_int, _P,
    ],
    "xrt_fused_grad_fwd_threads": [ctypes.c_int] * 4,
    "xrt_fused_grad_bwd_threads": [ctypes.c_int],
    "xrt_fused_grad_bwd_layout": [ctypes.c_longlong] + [ctypes.c_int] * 7 + [_P],
    "xrt_fused_grad_bwd": [
        _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, _P, ctypes.c_uint, ctypes.c_uint,
        _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P,
        ctypes.c_longlong, ctypes.c_int, _P,
    ],
    "xrt_elem_rate": [
        ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, _P, _P,
    ],
    "xrt_mma_rate_blocks": [ctypes.c_int],
    "xrt_mma_rate": [
        _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P, _P,
    ],
}

_lock = threading.Lock()
_lib = None


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile the kernels (if not already built) and return the .so path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libxicsrt_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    # Each build compiles and links in a directory of its own, then moves
    # the log and the library into place, so builds started at once by
    # several processes never read one another's half-written objects.
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        cu = [p for p in _sources() if p.endswith(".cu")]
        objs = [os.path.join(work, os.path.basename(p)[:-3] + ".o") for p in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(cu, objs)]
        logs, failed = [], []
        for src, proc in zip(cu, procs):
            out, err = proc.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        with open(os.path.join(work, "ptxas.log"), "w") as f:
            f.write("\n".join(logs))
        tmp = os.path.join(work, "libxicsrt_kernels.so")
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        os.replace(os.path.join(work, "ptxas.log"), os.path.join(out_dir, "ptxas.log"))
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def ptxas_report() -> str:
    """ptxas's register, stack and spill lines of the built kernels, and
    any note of wgmma instructions it had to serialise."""
    path = os.path.join(os.path.dirname(build()), "ptxas.log")
    with open(path) as f:
        return "\n".join(line for line in f.read().splitlines()
                         if "registers" in line or "spill" in line
                         or "Compiling entry" in line or "wgmma" in line
                         or line.startswith("=="))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
