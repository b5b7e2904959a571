"""Build and load the port's CUDA kernels.

The `.cu` sources under `flash_attention_tpu_torch/csrc/` have a plain C
interface.  On first use each is compiled with `nvcc` for `sm_90a` into an
object file, all of them at once in parallel, and the objects are linked
into one shared library under `build/torch_kernels/`, named by a hash of
the sources and flags so that an edited source is rebuilt, and loaded with
ctypes.  Nothing here runs at import time: the CPU tests import the
package on machines that have neither `nvcc` nor a card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from ..config import BUILD_DIR

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lib: ctypes.CDLL | None = None
# What the last build did: library path, seconds spent in nvcc (0.0 when the
# library was already built), the seconds each source's nvcc took (all
# started together; empty when already built), and the compiler's
# register/spill report (kept beside the library as <library>.ptxas.log, so
# a process that finds the library built reads the report too).
build_info: dict = {}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is installed")
    return found


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return ""


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfa_torch_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path.  Raises with nvcc's output when compilation fails."""
    path = _library_path()
    if os.path.exists(path):
        build_info.update(path=path, seconds=0.0, per_source={}, ptxas=_read(path + ".ptxas.log"))
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        t0 = time.perf_counter()
        objs = [os.path.join(tmpdir, os.path.basename(cu) + ".o") for cu in cus]
        # Output goes to files, not pipes: a compiler blocked on a full pipe
        # would wait for its turn to be read and serialise the build.
        logs = [os.path.join(tmpdir, os.path.basename(cu) + ".log") for cu in cus]
        procs = []
        for cu, obj, log in zip(cus, objs, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu], stdout=f, stderr=f))
        per_source = {}
        while len(per_source) < len(procs):
            for cu, proc in zip(cus, procs):
                if os.path.basename(cu) not in per_source and proc.poll() is not None:
                    per_source[os.path.basename(cu)] = time.perf_counter() - t0
            time.sleep(0.05)
        outs = []
        for log in logs:
            with open(log) as f:
                outs.append(f.read())
        for cu, proc, out in zip(cus, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(cu)} ({proc.returncode}):\n{out}")
        so = os.path.join(tmpdir, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        seconds = time.perf_counter() - t0
        # the log first: whoever finds the library finds its log beside it
        with open(os.path.join(tmpdir, "ptxas.log"), "w") as f:
            f.write("".join(outs))
        os.replace(os.path.join(tmpdir, "ptxas.log"), path + ".ptxas.log")
        os.replace(so, path)  # atomic: a concurrent loader sees all or nothing
    build_info.update(path=path, seconds=seconds, per_source=per_source, ptxas="".join(outs))
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = ctypes.c_float
        lib.fa_flash_fwd.argtypes = [
            p, p, p, p, p, p, p,  # q, k, v, o, lse, q_ids, kv_ids
            i, i, i, i, i, i, i,  # dtype, batch, hq, hkv, lq, lk, head_dim
            ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll,  # q/k/v/o strides
            f, i, i, i, p,  # scale_log2, causal, window, block_q, stream
        ]
        lib.fa_flash_fwd.restype = i
        bwd_tail = [
            i, i, i, i, i, i, i,  # dtype, batch, hq, hkv, lq, lk, head_dim
            ctypes.POINTER(ll),  # 21 strides: q, k, v, dout, dq, dk, dv
            f, f, i, i, p,  # scale, scale_log2, causal, window, stream
        ]
        # q, k, v, dout, lse, di, qs, q_ids, kv_ids, then dk, dv / dq
        lib.fa_flash_bwd_dkv.argtypes = [p] * 11 + bwd_tail
        lib.fa_flash_bwd_dkv.restype = i
        lib.fa_flash_bwd_dq.argtypes = [p] * 10 + bwd_tail
        lib.fa_flash_bwd_dq.restype = i
        lib.fa_flash_bwd_prep.argtypes = [
            p, p, p, p, p, p,  # q, o, dout, dlse, qs, di
            i, i, i, i, i,  # dtype, batch, hq, lq, head_dim
            ctypes.POINTER(ll), f, p,  # 9 strides: q, o, dout; scale_log2, stream
        ]
        lib.fa_flash_bwd_prep.restype = i
        lib.fa_flash_fwd_kv_quant.argtypes = [
            p, p, p, p, p, p, p, p,  # q, k, k_scale, v, v_scale, o, q_ids, kv_ids
            i, i, i, i, i, i, i, i,  # dtype, kv_dtype, batch, hq, hkv, lq, lk, head_dim
            ctypes.POINTER(ll),  # 14 strides: q, k, v, o, scales
            f, i, i, p,  # scale_log2, causal, window, stream
        ]
        lib.fa_flash_fwd_kv_quant.restype = i
        lib.fa_paged_decode.argtypes = [
            p, p, p, p, p, p, p, p,  # q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, out
            p, p,  # workspace, counters
            i, i, i, i, i, i, i, i,  # q_dtype, kv_dtype, batch, hq, hkv, group_tiles, group_rows, head_dim
            i, i, i,  # page_size, pages_per_seq, len_add
            i, i,  # chunk, splits
            ctypes.POINTER(ll), f, p,  # 12 strides, sm_scale, stream
        ]
        lib.fa_paged_decode.restype = i
        lib.fa_fused_decode.argtypes = [
            p, p, p, p, p, p, p, p, p,  # q, k, v, k_scales, v_scales, lengths, out, workspace, counters
            i, i, i, i, i, i, i, i,  # q_dtype, kv_dtype, slots, hq, hkv, group_tiles, group_rows, head_dim
            i, i, i,  # max_len, chunk, splits
            ctypes.POINTER(ll), f, p,  # 12 strides, sm_scale, stream
        ]
        lib.fa_fused_decode.restype = i
        lib.fa_paged_decode_group.argtypes = [
            p, p, p, p, p, p, p, p,  # q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, out
            i, i, i, i, i, i, i, i,  # q_dtype, kv_dtype, batch, hq, hkv, passes, pass_rows, head_dim
            i, i, i,  # page_size, pages_per_seq, len_add
            i, i, i,  # cluster, chunk, walks
            ctypes.POINTER(ll), f, p,  # 12 strides, sm_scale, stream
        ]
        lib.fa_paged_decode_group.restype = i
        lib.fa_fused_decode_group.argtypes = [
            p, p, p, p, p, p, p,  # q, k, v, k_scales, v_scales, lengths, out
            i, i, i, i, i, i, i, i,  # q_dtype, kv_dtype, slots, hq, hkv, passes, pass_rows, head_dim
            i, i, i, i,  # max_len, cluster, chunk, walks
            ctypes.POINTER(ll), f, p,  # 12 strides, sm_scale, stream
        ]
        lib.fa_fused_decode_group.restype = i
        lib.fa_decode_group_resident.argtypes = [i, i, i, i, i, i]  # q_dtype, kv_dtype, head_dim, pass_rows, paged, cluster
        lib.fa_decode_group_resident.restype = i
        # the wide kernels (head dims above 256) take the whole-group kernels' arguments
        lib.fa_paged_decode_wide.argtypes = lib.fa_paged_decode_group.argtypes
        lib.fa_paged_decode_wide.restype = i
        lib.fa_fused_decode_wide.argtypes = lib.fa_fused_decode_group.argtypes
        lib.fa_fused_decode_wide.restype = i
        lib.fa_decode_wide_resident.argtypes = [i, i, i, i, i, i]  # q_dtype, kv_dtype, head_dim, pass_rows, paged, cluster
        lib.fa_decode_wide_resident.restype = i
        # the narrow kernels (head dims 8-32, groups of up to 8) too
        lib.fa_paged_decode_narrow.argtypes = lib.fa_paged_decode_group.argtypes
        lib.fa_paged_decode_narrow.restype = i
        lib.fa_fused_decode_narrow.argtypes = lib.fa_fused_decode_group.argtypes
        lib.fa_fused_decode_narrow.restype = i
        lib.fa_decode_narrow_resident.argtypes = [i, i, i, i, i, i]  # q_dtype, kv_dtype, head_dim, rows, paged, cluster
        lib.fa_decode_narrow_resident.restype = i
        _lib = lib
    return _lib
