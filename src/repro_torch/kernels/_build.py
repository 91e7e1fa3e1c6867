"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  Nothing is built when the
package is imported: ``lib()`` builds at the first kernel launch.  The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

The build directory (``kernels/build``) lies inside the package and is
listed in ``.gitignore``.  Every function of the library returns the
``cudaGetLastError()`` of its launch; the Python wrappers raise when it is
not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# dtype codes of the C interface (csrc/common.cuh: repro::DType); int8 is
# a storage type of the quantized KV pages only
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT8 = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every exported launcher: (argtypes, ...); restype is int
_SIGNATURES = {
    # a, b, c, M, N, K, lda, a_m_contiguous, ldb, b_k_contiguous, dtype,
    # vec_ok, skinny_max_m, stream
    "repro_gemm": [_P, _P, _P, _I, _I, _I, _L, _I, _L, _I, _I, _I, _I, _P],
    # a, b, c, ws (f32 or NULL), M, N, K, lda, a_m_contiguous, ldb,
    # b_k_contiguous, splits, slice_k, stream
    "repro_gemm_tc": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _L, _I, _I, _I,
                      _P],
    # a, b, c, ws (f32 or NULL), M, N, K, lda, a_m_contiguous, ldb,
    # b_k_contiguous, a_vec, b_vec, tile_m, splits, slice_k, stream
    "repro_gemm_f32": [_P] * 4 + [_I] * 3 + [_L, _I, _L] + [_I] * 6 + [_P],
    # x, w, out, rows, D, ldx, eps, dtype, stream
    "repro_rmsnorm": [_P, _P, _P, _I, _I, _L, _F, _I, _P],
    # x, w, out, rows, D, ldx, eps, group, warps, blocks, dtype, stream
    "repro_rmsnorm_vec": [_P, _P, _P, _I, _I, _L, _F, _I, _I, _I, _I, _P],
    # x, w, dy, dx, dw_partial (f32), dw, rows, D, ldx, lddy, eps, dtype,
    # stream
    "repro_rmsnorm_bwd": [_P] * 6 + [_I, _I, _L, _L, _F, _I, _P],
    # as repro_rmsnorm_bwd, with group, warps and rows_per_block before
    # dtype
    "repro_rmsnorm_bwd_vec": [_P] * 6 + [_I, _I, _L, _L, _F] + [_I] * 4
                             + [_P],
    # m, v, out, M, N, ldm, dtype, stream
    "repro_bias_add_rows": [_P, _P, _P, _I, _I, _L, _I, _P],
    # m, v, out, M, N, ldm, rows a thread, threads across vectors (bx) and
    # rows (by), blocks across vectors (gx) and rows (gy), dtype, stream
    "repro_bias_add_rows_vec": [_P, _P, _P, _I, _I, _L] + [_I] * 6 + [_P],
    # x, out, n, slope, dtype, stream
    "repro_relu": [_P, _P, _L, _F, _I, _P],
    # x, out, n, slope, blocks, dtype, stream
    "repro_relu_vec": [_P, _P, _L, _F, _I, _I, _P],
    # x, dy, dx, n, shape (d1, d2, d3), strides of x, dy and dx (4 each),
    # slope, dtype, stream
    "repro_relu_bwd": [_P, _P, _P] + [_L] * 16 + [_F, _I, _P],
    # x, dy, dx, n, slope, blocks, dtype, stream
    "repro_relu_bwd_vec": [_P, _P, _P, _L, _F, _I, _I, _P],
    # x, out, N, C, H, W, x strides (n, c, h, w), KH, KW, stride, pad, OH,
    # OW, o_sn, o_sr, dtype, stream
    "repro_im2col": [_P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I, _I,
                     _I, _I, _L, _L, _I, _P],
    # x, out, N, C, H, W, x strides (n, c, h, w), KH, KW, stride, pad, OH,
    # OW, o_sn, o_sr, rows, threads, vec, dtype, stream: every offset
    # under 2**31
    "repro_im2col_band": [_P, _P] + [_I] * 20 + [_P],
    # x, out, argmax, N, C, H, W, x strides (n, c, h, w), k, stride, pad,
    # OH, OW, dtype, stream
    "repro_maxpool": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I,
                      _I, _I, _I, _I, _P],
    # x, out, argmax, N, C, H, W, x strides (n, c, h; w is 1), k, stride,
    # pad, OH, OW, rows, planes, threads, vec, dtype, stream
    "repro_maxpool_plane": [_P] * 3 + [_I] * 4 + [_L] * 3 + [_I] * 10
                           + [_P],
    # x, w, bias (f32 or NULL), out, N, C, H, W, x strides (n, c, h, w), F,
    # KH, KW, stride, pad, OH, OW, dtype, stream
    "repro_conv2d_direct": [_P] * 4 + [_I] * 4 + [_L] * 4 + [_I] * 8 + [_P],
    # as repro_conv2d_direct, with the tile (fb, toh, tow, cc, ks) and the
    # block's threads before dtype
    "repro_conv2d_direct_reg": [_P] * 4 + [_I] * 4 + [_L] * 4 + [_I] * 14
                               + [_P],
    # cols, out, N, C, H, W, KH, KW, pad, OH, OW, cols strides (n, r, p),
    # dtype, stream
    "repro_col2im": [_P, _P] + [_I] * 9 + [_L] * 3 + [_I, _P],
    # cols, out, N, C, H, W, KH, KW, pad, OH, OW, cols strides (n, r, p),
    # rows, threads, dtype, stream: every offset under 2**31
    "repro_col2im_tile": [_P, _P] + [_I] * 15 + [_P],
    # dy, argmax, out, N, C, H, W, dy strides (n, c, h, w), argmax strides
    # (n, c, h, w), stride, pad, OH, OW, dtype, stream
    "repro_maxpool_bwd": [_P, _P, _P] + [_I] * 4 + [_L] * 8 + [_I] * 5
                         + [_P],
    # dy, argmax, out, N, C, H, W, dy strides (n, c, h; w is 1), argmax
    # strides (n, c, h; w is 1), stride, pad, OH, OW, the block's cols,
    # groups and planes, vec, dtype, stream
    "repro_maxpool_bwd_window": [_P] * 3 + [_I] * 4 + [_L] * 6 + [_I] * 9
                                + [_P],
    # x, labels (NULL: softmax), probs, nll, rows, V, row stride, column
    # stride, dtype, stream
    "repro_softmax_rows": [_P, _P, _P, _P, _I, _I, _L, _L, _I, _P],
    # x, probs, rows, V, row stride, threads a row, rows a block, items a
    # lane, vec, dtype, stream
    "repro_softmax_reg": [_P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _P],
    # x, labels (int64), probs, partials (f32 or NULL), loss (f32 scalar),
    # rows, V, row stride, threads a row, rows a block, items a lane, vec,
    # dtype, stream
    "repro_softmax_xent_reg": [_P] * 5 + [_I, _I, _L] + [_I] * 5 + [_P],
    # probs, labels, g (f32 scalar or NULL), out, rows, V, row stride,
    # column stride, 1/B, dtype, stream
    "repro_softmax_xent_bwd": [_P] * 4 + [_I, _I, _L, _L, _F, _I, _P],
    # probs, labels, g (f32 scalar or NULL), out, rows, V, row stride,
    # threads a row, rows a block, items a lane, vec, 1/B, dtype, stream
    "repro_softmax_xent_bwd_reg": [_P] * 4 + [_I, _I, _L] + [_I] * 4
                                  + [_F, _I, _P],
    # q, k, v, out, pos0, width, block_table, ksc, vsc, B, Hkv, G, C, D,
    # n_keys, page, bt_sb, q_sb, q_sc, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
    # v_sh, o_sb, o_sc, o_sh, sc_sp, sc_sh, window, scale, dtype, kv_dtype,
    # stream
    "repro_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                        _L, _L, _L, _L, _L, _I, _F, _I, _I, _P],
    # q, k, v, out, lse, B, Hkv, G, Sq, Sk, D, q_sb, q_ss, q_sh, k_sb, k_ss,
    # k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, l_sb, l_sh, causal, window,
    # scale, dtype, stream
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                              _L, _L, _I, _I, _F, _I, _P],
    # as repro_flash_attention, without dtype (bf16)
    "repro_flash_attention_tc": [_P] * 5 + [_I] * 6 + [_L] * 14
                                + [_I, _I, _F, _P],
    # q, k, v, ksc, vsc (f32 or NULL), len, block_table (or NULL), out,
    # part_m, part_l, part_acc (f32 or NULL), B, Hkv, G, D, n_keys, page,
    # max_blocks, pages_per_split, n_split, bt_sb, q_sb, q_sh, k_s0, k_ss,
    # k_sh, v_s0, v_ss, v_sh, sc_sp, sc_sh, o_sb, o_sh, window, scale,
    # kv_dtype, stream
    "repro_flash_decode_split": [_P] * 11 + [_I] * 9 + [_L] * 13
                                + [_I, _F, _I, _P],
    # q, k, v, ksc, vsc (f32 or NULL), start, width, block_table (or
    # NULL), out, part_m, part_l, part_acc (f32 or NULL), B, Hkv, G, C, D,
    # n_keys, page, warps, tiles_per_split, n_split, bt_sb, q_sb, q_sc,
    # q_sh, k_s0, k_ss, k_sh, v_s0, v_ss, v_sh, sc_sp, sc_sh, o_sb, o_sc,
    # o_sh, window, scale, kv_dtype, stream
    "repro_flash_chunk_tc": [_P] * 12 + [_I] * 10 + [_L] * 15
                            + [_I, _F, _I, _P],
    # q, k, v, out, do, lse, dd, dq, dk, dv, B, Hkv, G, Sq, Sk, D, q_sb,
    # q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
    # do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, l_sb,
    # l_sh, causal, window, scale, dtype, stream
    "repro_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_L] * 23
                                 + [_I, _I, _F, _I, _P],
    # as repro_flash_attention_bwd, with dk_part and dv_part (f32 (B, Sk,
    # Hq, D) or NULL) after dv and no dtype (bf16)
    "repro_flash_attention_bwd_tc": [_P] * 12 + [_I] * 6 + [_L] * 23
                                    + [_I, _I, _F, _P],
    # x, dt, A, B, C, h0, y, hf, B, S, H, P, N, chunk, x_sb, x_ss, x_sh,
    # dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss, y_sh, dtype,
    # stream
    "repro_ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                       _L, _I, _P],
    # x, dt, A, B, C, h0, y, hf, B, H, P, N, x_sb, x_sh, dt_sb, dt_sh,
    # b_sb, c_sb, y_sb, y_sh, lanes, vecs, rows held, warps, dtype, stream
    "repro_ssd_scan_step": [_P] * 8 + [_I] * 4 + [_L] * 8 + [_I] * 5 + [_P],
    # as repro_ssd_scan, with lanes, vecs and rows a block before dtype
    "repro_ssd_scan_split": [_P] * 8 + [_I] * 6 + [_L] * 13 + [_I] * 4
                            + [_P],
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the Hopper "
            "kernels are built from csrc/*.cu on the machine with the card"
        )
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile and link the library unless this source hash is built.
    ``verbose`` prints ptxas' register/spill report for every kernel."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    tag = f"{os.getpid()}"
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [cc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failed = []
    for src, _, p in procs:
        so, se = p.communicate()
        if verbose and (so or se):
            print(f"[nvcc {src.name}]\n{so}{se}", flush=True)
        if p.returncode != 0:
            failed.append(f"{src.name} (rc {p.returncode}):\n{se}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [cc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def aligned16(*tensors: torch.Tensor, elems: int = 8) -> bool:
    """16-byte aligned bases and the strides of all but the last dim
    multiples of ``elems`` elements (16 bytes at 8 bf16, 4 f32, 16 int8):
    what the kernels' 16-byte copies follow."""
    return all(t.data_ptr() % 16 == 0
               and all(st % elems == 0 for st in t.stride()[:-1])
               for t in tensors)


def check(rc: int, what: str) -> None:
    """Raise on a launcher's non-zero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (CUDA error {rc})")


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of the tensors requires grad: autograd must
    record what is computed from them.  The ops layer then routes an op
    through its autograd Function; a kernel launched on them directly
    would cut the graph, since its output, written through ``ctypes``,
    has no ``grad_fn`` (the Functions launch the kernels inside their
    forward and backward, where grad mode is off)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def guard_grad(what: str, *tensors) -> None:
    """Raise where ``needs_grad`` holds (every wrapper calls it before it
    launches), rather than cut the graph without a word."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: called on a tensor that requires grad with grad mode "
            "on; the kernel would cut the autograd graph — call it through "
            "repro_torch.kernels.ops (whose autograd Function launches it "
            "and its backward) or under torch.no_grad()")
