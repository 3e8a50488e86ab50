"""Build and load the port's CUDA kernels.

Every `roar_tpu_torch/csrc/*.cu` file is compiled by `nvcc` for `sm_90a`
(one `nvcc` per source, all started together) and the objects are linked
into one shared library with a plain C interface, which is loaded with
`ctypes`.  The build happens at first use, never at import, into
`roar_tpu_torch/build/` under a name that carries a hash of the sources
(the `*.cuh` headers they include too), so an edited source is rebuilt and a
stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
# no --use_fast_math: the Viterbi kernels' decodes are exact by contract
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build_library() -> Path:
    """Compile the sources into `build/libroar_kernels_<hash>.so` unless that
    file exists.  The compiler's output (with `ptxas -v`: registers, shared
    memory and spills per kernel) is kept beside it as `<name>.log`."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libroar_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [str(Path(tmp) / (src.stem + ".o")) for src in sources]
        compiles = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)
        ]
        log = "".join(proc.communicate()[0] for proc in compiles)
        failed = [src.name for src, proc in zip(sources, compiles) if proc.returncode != 0]
        if not failed:
            out = str(Path(tmp) / lib.name)
            link = subprocess.run([nvcc, "-shared", "-o", out, *objects],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["link"]
        lib.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(out, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    lib = ctypes.CDLL(str(build_library()))
    # every flash function ends: B, T, H, D, scale, causal, bf16, stream
    flash_tail = [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fa = lib.roar_flash_attention_fwd
    fa.argtypes = [ctypes.c_void_p] * 6 + flash_tail
    fa.restype = ctypes.c_int
    # q, k, v, seg, lse, delta, dout, then the outputs (dk, dv | dq)
    for name, n_out in (("roar_flash_attention_bwd_dkv", 2), ("roar_flash_attention_bwd_dq", 1)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * (7 + n_out) + flash_tail
        fn.restype = ctypes.c_int
    vf = lib.roar_pyin_viterbi_fwd
    vf.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])  # ..., B, T, N, W, C, log_stay, log_switch, log_init_u
    vf.restype = ctypes.c_int
    vc = lib.roar_pyin_viterbi_max_active_clusters
    vc.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]  # B, N, W, C, out
    vc.restype = ctypes.c_int
    bt = lib.roar_pyin_backtrack
    bt.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bt.restype = ctypes.c_int
    conv_shape = [ctypes.c_int] * 9  # B, Cin, W, Cout, k, stride, pad, G, Wout
    for name in ("roar_grouped_conv_fwd", "roar_grouped_conv_dx"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + conv_shape + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # bf16: in, w, out, workspace (`roar_grouped_conv_bf16_workspace` bytes)
    for name in ("roar_grouped_conv_fwd_bf16", "roar_grouped_conv_dx_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + conv_shape + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.roar_grouped_conv_bf16_workspace.argtypes = [ctypes.c_int] + conv_shape  # dx, ...
    lib.roar_grouped_conv_bf16_workspace.restype = ctypes.c_longlong
    lib.roar_grouped_conv_dw_parts.argtypes = conv_shape
    lib.roar_grouped_conv_dw_parts.restype = ctypes.c_int
    # fp32 dW: x, dy, dw, workspace (parts * dw floats), ..., parts
    lib.roar_grouped_conv_dw.argtypes = ([ctypes.c_void_p] * 4 + conv_shape
                                         + [ctypes.c_int, ctypes.c_void_p])
    lib.roar_grouped_conv_dw.restype = ctypes.c_int
    # bf16 dW: x, dy, dw, workspace (`roar_grouped_conv_dw_bf16_workspace` bytes)
    lib.roar_grouped_conv_dw_bf16.argtypes = [ctypes.c_void_p] * 4 + conv_shape + [ctypes.c_void_p]
    lib.roar_grouped_conv_dw_bf16.restype = ctypes.c_int
    lib.roar_grouped_conv_dw_bf16_workspace.argtypes = conv_shape
    lib.roar_grouped_conv_dw_bf16_workspace.restype = ctypes.c_longlong
    lib.roar_cuda_error_string.argtypes = [ctypes.c_int]
    lib.roar_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.roar_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
