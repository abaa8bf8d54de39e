"""Build and load the port's CUDA kernels.

The sources in ``kernels/csrc/`` are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ``ctypes``.
Each ``.cu`` file compiles in its own ``nvcc`` process, all started
together, and the objects are linked once. The library lives under
``build/magnet_tpu_torch/`` in the checkout, named by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads at once.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "magnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # dtype, x, skip, wx, ws, scale, shift, out, N, H, W, Hs, Ws, Cx, Cs,
    # Cout, upsample, act, stream
    "mt_conv3x3_bnact": [_I] + [_P] * 7 + [_I] * 10 + [_P],
    # dtype, x, w0..w3, b0..b3, out, N, H, W, C0, n_convs, c_out,
    # relu_mask, stream
    "mt_head_chain": [_I] + [_P] * 10 + [_I] * 7 + [_P],
    # dtype, d, ref, src, ms, R, t, valid, K, rays, out, B, V, H, W, C, D,
    # kappa, stream
    "mt_cost_volume_cw": [_I] + [_P] * 10 + [_I] * 6 + [_F, _P],
    # dtype, cv, feat, prev, w0..w3, b1..b3, out, B, H, W, D, stream
    "mt_gnet_update": [_I] + [_P] * 11 + [_I] * 4 + [_P],
    # dtype, n, depth0..3, mask, out0..3, B, H, W, C, k, stream
    "mt_upsample_mask": [_I] * 2 + [_P] * 9 + [_I] * 5 + [_P],
    # dtype, n, grad0..3, depth0..3, mask, gdepth0..3, gmask, B, H, W, C,
    # k, stream
    "mt_upsample_mask_bwd": [_I] * 2 + [_P] * 14 + [_I] * 5 + [_P],
    # dtype, x0, x1, x2, w, scale, shift, res, out, N, H, W, C0, C1, C2,
    # Cout, taps, stride, dil, relu, kblock, stream
    "mt_psm_conv": [_I] + [_P] * 8 + [_I] * 12 + [_P],
    # dtype, raw, skip, br, w0, scale, shift, w1, zero, out, N, H, W, C0,
    # C1, C2, c_out, stream
    "mt_spp_tail": [_I] + [_P] * 9 + [_I] * 7 + [_P],
    # dtype, depth, ref, gbar, R, t, valid, K, rays, out, B, V, H, W, C, D,
    # stream
    "mt_sweep_grad_src": [_I] + [_P] * 9 + [_I] * 6 + [_P],
    # dtype, x, w, out, N, H, W, C, K, pt, pl, stream
    "mt_dw_conv": [_I] + [_P] * 3 + [_I] * 7 + [_P],
    # dtype, x, wpw, s1, wdw, s2, wse1, bse1, wse2, bse2, wpwl, s3, d, pool,
    # separt, ws, counters, out, N, H, W, C, M, R, K, th, tw, kc, stream
    "mt_mbconv_block": [_I] + [_P] * 17 + [_I] * 18 + [_P],
    # dtype, x, w1, s1, t1, w2, s2, t2, out, N, H, W, C, dil, stream
    "mt_res_block": [_I] + [_P] * 8 + [_I] * 5 + [_P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if the library for their hash is missing; return
    its path. The compiler's output (registers, shared memory, spills from
    ``-Xptxas -v``) is kept in ``build.log`` beside it."""
    so = BUILD_DIR / f"libmagnet_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = work / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = work / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so),
             *sorted(str(o) for o in work.glob("*.o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.mt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().mt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
