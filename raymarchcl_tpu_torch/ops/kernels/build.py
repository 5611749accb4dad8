"""Build of the port's CUDA kernels at first use, and their ctypes loader.

`nvcc` compiles every source under raymarchcl_tpu_torch/csrc, one process
per `.cu` file, all started together, and links them into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), under build/raymarchcl_tpu_torch/<hash of sources and flags>/ in
the checkout. Nothing is built or imported when this module is imported;
`library()` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "raymarchcl_tpu_torch")
LIB_NAME = "librmcl_torch.so"
LOG_NAME = "nvcc.log"  # the compiler's output (ptxas -v), kept beside the library

# sm_90a (Hopper). --fmad=false: multiply-adds are fused only where the
# sources call fmaf(), the sites where the plain version fuses too. No fast
# math: exp2/pow/exp/sqrt and the divisions stay IEEE-accurate.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

_lib = None
# path, seconds (0.0 when cached), cached, and the compiler log of the
# build this process loaded (read back from LOG_NAME on a cached build)
build_info = {}


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin)")


def build() -> str:
    """Compile the library unless this exact source/flag set is built with
    its log; return its path. Raises RuntimeError with nvcc's output on
    failure."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    path = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, LOG_NAME)
    if os.path.isfile(path) and os.path.isfile(log_path):
        with open(log_path) as f:
            build_info.update(path=path, seconds=0.0, cached=True, log=f.read())
        return path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, cmds = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        objs.append(os.path.join(out_dir, f"{os.path.basename(src)}.{os.getpid()}.o"))
        cmds.append([nvcc, *NVCC_FLAGS, "-c", src, "-o", objs[-1]])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    cmds.append([nvcc, "-shared", "-o", tmp, *objs])
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        procs.append(link)
        logs.append(link.stdout)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    log = "".join(logs)
    with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
        f.write(log)
    os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
    os.replace(tmp, path)
    build_info.update(path=path, seconds=time.perf_counter() - t0, cached=False, log=log)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        for name, args in (
            ("rmcl_tonemap_pack", [vp, vp, ctypes.c_float, i32]),
            ("rmcl_render_passes", [vp, vp, vp, vp, i32, vp, vp, vp, vp, vp]),
            ("rmcl_e1_row_fetch", [vp, vp, vp, i32, i32, i32, i32]),
            ("rmcl_e2_gather", [vp, vp, vp, i32, i32, i32, i32]),
            ("rmcl_e3_probe", [vp, vp, vp, vp, i32, i32, i32, i32]),
            ("rmcl_e4_transpose", [vp, vp, i32, i32, i32]),
            ("rmcl_e5_while", [vp, vp, vp, i32, i32]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = args + [vp]  # ..., cudaStream_t
            fn.restype = i32
        lib.rmcl_error_string.argtypes = [i32]
        lib.rmcl_error_string.restype = ctypes.c_char_p
        lib.rmcl_params_size.argtypes = []
        lib.rmcl_params_size.restype = i32
        from .render_pass import RmclParams

        if lib.rmcl_params_size() != ctypes.sizeof(RmclParams):
            raise RuntimeError(f"struct RmclParams is {lib.rmcl_params_size()} bytes in "
                               f"csrc/rmcl_common.cuh, {ctypes.sizeof(RmclParams)} in its "
                               "ctypes mirror (ops/kernels/render_pass.py)")
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        name = library().rmcl_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({name})")
